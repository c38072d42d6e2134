// WaveRNN autoregressive sampling: one persistent cooperative kernel for
// all steps of all fold lanes (replaces the Pallas TPU kernel
// forwardtacotron_tpu/kernels/wavernn_sample.py:_kernel).
//
// Per step and lane, with the compact conditioning [mel | a1 | a2 | a3 | a4]:
//   pre = cond . Wc + bc
//   xt = pre_I + x * w_x
//   h1 = GRU(xt W1_ihᵀ + b1_ih, h1 W1_hhᵀ + b1_hh, h1),   x1 = xt + h1
//   h2 = GRU(x1 W2_xᵀ + pre_G2, h2 W2_hhᵀ + b2_hh, h2),   x2 = x1 + h2
//   f1 = relu(x2 Fc1ᵀ + pre_F1),  f2 = relu(f1 Fc2ᵀ + pre_F2)
//   logits = f2 Fc3ᵀ + b3,  x = sample(logits)
//
// Block j owns U hidden units (and FC fc columns, NCC logit columns) and
// keeps the rows of every loop weight for them in shared memory for the
// kernel's lifetime (~9 MB of bf16 weights spread over the card's SMs).
// The per-step vectors (xt, h1, x1, h2, x2, f1, f2, logits, x) go
// through global memory (L2); each dependent stage ends in a grid barrier
// (7 per step). Reads of them use ld.global.cg, since other SMs wrote
// them. Before each product the block stages its input rows in shared
// memory with independent loads, and the row counts of the full-width
// model (1, 4, 12) get code with exact trip counts.
//
// Sampling is on chip. Random numbers come from Philox4x32-10 keyed by
// the seed, with counter (slot / 4, lane, step, stream): RAW draws
// Gumbel noise per class (stream 0); MOL draws a Gumbel per mixture
// component (stream 1) and one logistic uniform (stream 2). Greedy mode
// uses no random numbers. Ties in an argmax go to the lowest index.
//
// Precision: weights and conditioning in T (float or bf16), activations
// rounded to T before each product, float32 accumulation, float32 state
// and gate math.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 32;
constexpr float kLogScaleMin = -32.23619130191664f;  // log(1e-14)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ uint4 philox(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float uniform24(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

struct Scratch {
  float* part;   // partial sums of a product
  float* stage;  // input rows staged from global memory
  int cap;       // floats in `stage`
};

// stage[b*K + k] = in[b*in_stride + k] for b < nl (rounded to W if ROUND):
// every thread issues independent loads, so the L2 latency is paid
// about once per tile instead of once per k-step of a dependent loop.
template <typename W, typename In, bool ROUND>
__device__ void stage_rows(const In* in, int in_stride, int nl, int K,
                           float* stage) {
  for (int i = threadIdx.x; i < nl * K; i += kThreads) {
    const int b = i / K, k = i % K;
    const float v = ld(in + (size_t)b * in_stride + k);
    stage[i] = ROUND ? round_to<W>(v) : v;
  }
}

// out[b*R + r] = sum_k x[b*x_stride + k] * w[r*K + k] for b < nl, r < R,
// x in shared memory. Warp work item = (lane b, k-slice). RT is R at
// compile time when EXACT, else an upper bound. All threads of the block
// call it.
template <typename W, int RT, bool EXACT>
__device__ void dot_rows(const float* x, int x_stride, int nl, int K,
                         const W* w, int R, float* out, float* part) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int KS = nl >= kWarps ? 1 : kWarps / nl;
  const int kc = (K + KS - 1) / KS;
  for (int item = warp; item < nl * KS; item += kWarps) {
    const int b = item / KS, ks = item % KS;
    const int k0 = ks * kc, k1 = min(K, k0 + kc);
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.0f;
    const float* xb = x + (size_t)b * x_stride;
    for (int k = k0 + lane; k < k1; k += 32) {
      const float v = xb[k];
#pragma unroll
      for (int r = 0; r < RT; ++r)
        if (EXACT || r < R) acc[r] = fmaf(v, to_f(w[r * K + k]), acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (EXACT || r < R) {
        const float sum = warp_sum(acc[r]);
        if (lane == 0) part[item * R + r] = sum;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nl * R; i += kThreads) {
    const int b = i / R, r = i % R;
    float sum = 0.0f;
    for (int ks = 0; ks < KS; ++ks) sum += part[(b * KS + ks) * R + r];
    out[i] = sum;
  }
  __syncthreads();
}

template <typename W>
__device__ void dot_staged(const float* x, int x_stride, int nl, int K,
                           const W* w, int R, float* out, float* part) {
  switch (R) {  // the row counts of the full-width model get exact code
    case 0: return;
    case 1: return dot_rows<W, 1, true>(x, x_stride, nl, K, w, R, out, part);
    case 4: return dot_rows<W, 4, true>(x, x_stride, nl, K, w, R, out, part);
    case 12: return dot_rows<W, 12, true>(x, x_stride, nl, K, w, R, out, part);
    default:
      return dot_rows<W, kMaxRows, false>(x, x_stride, nl, K, w, R, out, part);
  }
}

// out[b*R + r] = sum_k in[b*in_stride + k] * w[r*K + k] for b < L: the
// input rows pass through shared memory in tiles of lanes.
template <typename W, typename In, bool ROUND>
__device__ void rows_dot(const In* in, int in_stride, int L, int K,
                         const W* w, int R, float* out, const Scratch& sc) {
  if (R <= 0) return;
  const int lt = max(1, min(L, sc.cap / K));
  for (int l0 = 0; l0 < L; l0 += lt) {
    const int nl = min(lt, L - l0);
    stage_rows<W, In, ROUND>(in + (size_t)l0 * in_stride, in_stride, nl, K,
                             sc.stage);
    __syncthreads();
    dot_staged(sc.stage, K, nl, K, w, R, out + l0 * R, sc.part);
  }
}

// Copy n_rows rows of length K into shared memory: smem row
// q*unit_rows + u <- global row q*stride + r0 + u (q: gate block).
template <typename T>
__device__ void load_rows(T* dst, const T* src, int K, int n_rows,
                          int unit_rows, int stride, int r0) {
  for (int i = threadIdx.x; i < n_rows * K; i += kThreads) {
    const int row = i / K, k = i % K;
    const int q = row / unit_rows, u = row % unit_rows;
    dst[i] = src[(size_t)(q * stride + r0 + u) * K + k];
  }
}

enum Ptr {
  P_COND, P_W_IC, P_W_X, P_B_I, P_W1_IH, P_W1_HH, P_B1_IH, P_B1_HH,
  P_W2_X, P_W2_A, P_W2_HH, P_B2_IH, P_B2_HH, P_FC1_X, P_FC1_A, P_FC1_B,
  P_FC2_X, P_FC2_A, P_FC2_B, P_FC3, P_FC3_B, P_OUT, P_SCRATCH, P_COUNT
};
enum Int {
  I_STEPS, I_L, I_FEAT, I_D, I_H, I_F, I_NC, I_NR_MIX, I_GREEDY, I_SEED,
  I_U, I_COUNT
};

struct Args {
  const void* p[P_COUNT];
  int n_steps, L, feat, d, H, F, NC, nr_mix, greedy, U, FC, NCC;
  int stage_cap;  // floats of the input staging buffer
  uint2 key;
};

struct Layout {  // shared-memory layout (bytes), same on host and device
  size_t w_ic, w2_a, fc1_a, fc2_a, w1_ih, w1_hh, w2_x, w2_hh, fc1_x, fc2_x,
      fc3, f_gh1, f_gh2, f_pg2, f_pf1, f_pf2, f_tmp, f_part, f_red, f_stage,
      total;
};

struct Bump {
  size_t o = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t at = o;
    o += align16(bytes);
    return at;
  }
};

template <typename T>
__host__ __device__ Layout make_layout(const Args& a) {
  Layout s;
  Bump m;
  const size_t U = a.U, H = a.H, F = a.F, d = a.d, L = a.L;
  const size_t FC = a.FC, NCC = a.NCC;
  s.w_ic = m.take(sizeof(T) * U * (a.feat + d));
  s.w2_a = m.take(sizeof(T) * 3 * U * d);
  s.fc1_a = m.take(sizeof(T) * FC * d);
  s.fc2_a = m.take(sizeof(T) * FC * d);
  s.w1_ih = m.take(sizeof(T) * 3 * U * H);
  s.w1_hh = m.take(sizeof(T) * 3 * U * H);
  s.w2_x = m.take(sizeof(T) * 3 * U * H);
  s.w2_hh = m.take(sizeof(T) * 3 * U * H);
  s.fc1_x = m.take(sizeof(T) * FC * H);
  s.fc2_x = m.take(sizeof(T) * FC * F);
  s.fc3 = m.take(sizeof(T) * NCC * F);
  s.f_gh1 = m.take(sizeof(float) * L * 3 * U);
  s.f_gh2 = m.take(sizeof(float) * L * 3 * U);
  s.f_pg2 = m.take(sizeof(float) * L * 3 * U);
  s.f_pf1 = m.take(sizeof(float) * L * FC);
  s.f_pf2 = m.take(sizeof(float) * L * FC);
  size_t rmax = 3 * U;
  if (FC > rmax) rmax = FC;
  if (NCC > rmax) rmax = NCC;
  s.f_tmp = m.take(sizeof(float) * L * rmax);
  s.f_part = m.take(sizeof(float) * (L > (size_t)kWarps ? L : kWarps) *
                    kMaxRows);
  s.f_red = m.take(sizeof(float) * 2 * kWarps);
  s.f_stage = m.take(sizeof(float) * a.stage_cap);
  s.total = m.o;
  return s;
}

__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

// Block-wide argmax of (v, i); every thread gets the result.
__device__ int block_argmax(float v, int i, float* red) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
    better(v, i, v2, i2);
  }
  int* red_i = reinterpret_cast<int*>(red + kWarps);
  if (lane == 0) { red[warp] = v; red_i[warp] = i; }
  __syncthreads();
  float bv = red[0];
  int bi = red_i[0];
  for (int w = 1; w < kWarps; ++w) better(bv, bi, red[w], red_i[w]);
  __syncthreads();
  return bi;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wavernn_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const Layout lay = make_layout<T>(a);
  extern __shared__ __align__(16) unsigned char smem[];
  T* w_ic = reinterpret_cast<T*>(smem + lay.w_ic);
  T* w2_a = reinterpret_cast<T*>(smem + lay.w2_a);
  T* fc1_a = reinterpret_cast<T*>(smem + lay.fc1_a);
  T* fc2_a = reinterpret_cast<T*>(smem + lay.fc2_a);
  T* w1_ih = reinterpret_cast<T*>(smem + lay.w1_ih);
  T* w1_hh = reinterpret_cast<T*>(smem + lay.w1_hh);
  T* w2_x = reinterpret_cast<T*>(smem + lay.w2_x);
  T* w2_hh = reinterpret_cast<T*>(smem + lay.w2_hh);
  T* fc1_x = reinterpret_cast<T*>(smem + lay.fc1_x);
  T* fc2_x = reinterpret_cast<T*>(smem + lay.fc2_x);
  T* fc3 = reinterpret_cast<T*>(smem + lay.fc3);
  float* gh1 = reinterpret_cast<float*>(smem + lay.f_gh1);
  float* gh2 = reinterpret_cast<float*>(smem + lay.f_gh2);
  float* pg2 = reinterpret_cast<float*>(smem + lay.f_pg2);
  float* pf1 = reinterpret_cast<float*>(smem + lay.f_pf1);
  float* pf2 = reinterpret_cast<float*>(smem + lay.f_pf2);
  float* tmp = reinterpret_cast<float*>(smem + lay.f_tmp);
  float* part = reinterpret_cast<float*>(smem + lay.f_part);
  float* red = reinterpret_cast<float*>(smem + lay.f_red);
  const Scratch sc{part, reinterpret_cast<float*>(smem + lay.f_stage),
                   a.stage_cap};

  const int L = a.L, H = a.H, F = a.F, d = a.d, U = a.U, NC = a.NC;
  const int C = a.feat + 4 * d;
  const int u0 = blockIdx.x * U;
  const int fc0 = blockIdx.x * a.FC, nc0 = blockIdx.x * a.NCC;
  const int fcn = max(0, min(a.FC, F - fc0));
  const int ncn = max(0, min(a.NCC, NC - nc0));
  const int tid = threadIdx.x;

  const T* cond = static_cast<const T*>(a.p[P_COND]);
  const float* w_x = static_cast<const float*>(a.p[P_W_X]);
  const float* b_i = static_cast<const float*>(a.p[P_B_I]);
  const float* b1_ih = static_cast<const float*>(a.p[P_B1_IH]);
  const float* b1_hh = static_cast<const float*>(a.p[P_B1_HH]);
  const float* b2_ih = static_cast<const float*>(a.p[P_B2_IH]);
  const float* b2_hh = static_cast<const float*>(a.p[P_B2_HH]);
  const float* fc1_b = static_cast<const float*>(a.p[P_FC1_B]);
  const float* fc2_b = static_cast<const float*>(a.p[P_FC2_B]);
  const float* fc3_b = static_cast<const float*>(a.p[P_FC3_B]);
  float* out = static_cast<float*>(const_cast<void*>(a.p[P_OUT]));
  float* xs = static_cast<float*>(const_cast<void*>(a.p[P_SCRATCH]));
  float* xt_g = xs + L;
  float* h1_g = xt_g + (size_t)L * H;
  float* x1_g = h1_g + (size_t)L * H;
  float* h2_g = x1_g + (size_t)L * H;
  float* x2_g = h2_g + (size_t)L * H;
  float* f1_g = x2_g + (size_t)L * H;
  float* f2_g = f1_g + (size_t)L * F;
  float* lg_g = f2_g + (size_t)L * F;

  // resident weights: rows of this block's units / columns
  const int fcr = max(fcn, 1), ncr = max(ncn, 1);
  load_rows(w_ic, static_cast<const T*>(a.p[P_W_IC]), a.feat + d, U, U, H,
            u0);
  load_rows(w2_a, static_cast<const T*>(a.p[P_W2_A]), d, 3 * U, U, H, u0);
  load_rows(w1_ih, static_cast<const T*>(a.p[P_W1_IH]), H, 3 * U, U, H, u0);
  load_rows(w1_hh, static_cast<const T*>(a.p[P_W1_HH]), H, 3 * U, U, H, u0);
  load_rows(w2_x, static_cast<const T*>(a.p[P_W2_X]), H, 3 * U, U, H, u0);
  load_rows(w2_hh, static_cast<const T*>(a.p[P_W2_HH]), H, 3 * U, U, H, u0);
  load_rows(fc1_a, static_cast<const T*>(a.p[P_FC1_A]), d, fcn, fcr, F, fc0);
  load_rows(fc2_a, static_cast<const T*>(a.p[P_FC2_A]), d, fcn, fcr, F, fc0);
  load_rows(fc1_x, static_cast<const T*>(a.p[P_FC1_X]), H, fcn, fcr, F, fc0);
  load_rows(fc2_x, static_cast<const T*>(a.p[P_FC2_X]), F, fcn, fcr, F, fc0);
  load_rows(fc3, static_cast<const T*>(a.p[P_FC3]), F, ncn, ncr, NC, nc0);
  __syncthreads();

  for (int t = 0; t < a.n_steps; ++t) {
    const T* cond_t = cond + (size_t)t * L * C;
    // A: conditioning projections, xt, and the hidden products of the
    //    previous states
    const int ct = max(1, min(L, a.stage_cap / C));
    for (int l0 = 0; l0 < L; l0 += ct) {
      const int nl = min(ct, L - l0);
      stage_rows<T, T, false>(cond_t + (size_t)l0 * C, C, nl, C, sc.stage);
      __syncthreads();
      const float* st = sc.stage;
      dot_staged(st, C, nl, a.feat + d, w_ic, U, tmp + l0 * U, part);
      dot_staged(st + a.feat + d, C, nl, d, w2_a, 3 * U, pg2 + l0 * 3 * U,
                 part);
      dot_staged(st + a.feat + 2 * d, C, nl, d, fc1_a, fcn, pf1 + l0 * fcn,
                 part);
      dot_staged(st + a.feat + 3 * d, C, nl, d, fc2_a, fcn, pf2 + l0 * fcn,
                 part);
    }
    for (int i = tid; i < L * U; i += kThreads) {
      const int b = i / U, unit = u0 + i % U;
      xt_g[(size_t)b * H + unit] =
          tmp[i] + b_i[unit] + __ldcg(xs + b) * w_x[unit];
    }
    rows_dot<T, float, true>(h1_g, H, L, H, w1_hh, 3 * U, gh1, sc);
    rows_dot<T, float, true>(h2_g, H, L, H, w2_hh, 3 * U, gh2, sc);
    grid.sync();

    // B: GRU1
    rows_dot<T, float, true>(xt_g, H, L, H, w1_ih, 3 * U, tmp, sc);
    for (int i = tid; i < L * U; i += kThreads) {
      const int b = i / U, u = i % U, unit = u0 + u;
      const float* gi = tmp + b * 3 * U;
      const float* gh = gh1 + b * 3 * U;
      const float r = sigmoid(gi[u] + b1_ih[unit] + gh[u] + b1_hh[unit]);
      const float z = sigmoid(gi[U + u] + b1_ih[H + unit] + gh[U + u] +
                              b1_hh[H + unit]);
      const float n = tanhf(gi[2 * U + u] + b1_ih[2 * H + unit] +
                            r * (gh[2 * U + u] + b1_hh[2 * H + unit]));
      const size_t o = (size_t)b * H + unit;
      const float h = (1.0f - z) * n + z * __ldcg(h1_g + o);
      h1_g[o] = h;
      x1_g[o] = __ldcg(xt_g + o) + h;
    }
    grid.sync();

    // C: GRU2
    rows_dot<T, float, true>(x1_g, H, L, H, w2_x, 3 * U, tmp, sc);
    for (int i = tid; i < L * U; i += kThreads) {
      const int b = i / U, u = i % U, unit = u0 + u;
      const float* gi = tmp + b * 3 * U;
      const float* pg = pg2 + b * 3 * U;
      const float* gh = gh2 + b * 3 * U;
      const float r = sigmoid(gi[u] + pg[u] + b2_ih[unit] + gh[u] +
                              b2_hh[unit]);
      const float z = sigmoid(gi[U + u] + pg[U + u] + b2_ih[H + unit] +
                              gh[U + u] + b2_hh[H + unit]);
      const float n = tanhf(gi[2 * U + u] + pg[2 * U + u] +
                            b2_ih[2 * H + unit] +
                            r * (gh[2 * U + u] + b2_hh[2 * H + unit]));
      const size_t o = (size_t)b * H + unit;
      const float h = (1.0f - z) * n + z * __ldcg(h2_g + o);
      h2_g[o] = h;
      x2_g[o] = __ldcg(x1_g + o) + h;
    }
    grid.sync();

    // D: fc1
    rows_dot<T, float, true>(x2_g, H, L, H, fc1_x, fcn, tmp, sc);
    for (int i = tid; i < L * fcn; i += kThreads) {
      const int b = i / fcn, j = i % fcn;
      f1_g[(size_t)b * F + fc0 + j] =
          fmaxf(tmp[i] + pf1[b * fcn + j] + fc1_b[fc0 + j], 0.0f);
    }
    grid.sync();

    // E: fc2
    rows_dot<T, float, true>(f1_g, F, L, F, fc2_x, fcn, tmp, sc);
    for (int i = tid; i < L * fcn; i += kThreads) {
      const int b = i / fcn, j = i % fcn;
      f2_g[(size_t)b * F + fc0 + j] =
          fmaxf(tmp[i] + pf2[b * fcn + j] + fc2_b[fc0 + j], 0.0f);
    }
    grid.sync();

    // F: fc3 -> logits
    rows_dot<T, float, true>(f2_g, F, L, F, fc3, ncn, tmp, sc);
    for (int i = tid; i < L * ncn; i += kThreads) {
      const int b = i / ncn, j = i % ncn;
      lg_g[(size_t)b * NC + nc0 + j] = tmp[i] + fc3_b[nc0 + j];
    }
    grid.sync();

    // G: sample one lane per block
    for (int b = blockIdx.x; b < L; b += gridDim.x) {
      const float* lg = lg_g + (size_t)b * NC;
      const int n_pick = a.nr_mix > 0 ? a.nr_mix : NC;
      const uint32_t stream = a.nr_mix > 0 ? 1u : 0u;
      float best = __int_as_float(0xff800000);  // -inf
      int best_i = 0x7fffffff;
      for (int j4 = tid; j4 * 4 < n_pick; j4 += kThreads) {
        uint4 bits = make_uint4(0, 0, 0, 0);
        if (!a.greedy)
          bits = philox(make_uint4(j4, b, t, stream), a.key);
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * j4 + e;
          if (j >= n_pick) break;
          float v = __ldcg(lg + j);
          if (!a.greedy) {
            const float u = uniform24(word(bits, e));
            if (a.nr_mix > 0) {
              v -= logf(-logf(fminf(fmaxf(u, 1e-5f), 1.0f - 1e-5f)));
            } else {
              v += -logf(-logf(u + 1e-9f) + 1e-9f);
            }
          }
          better(best, best_i, v, j);
        }
      }
      const int k = block_argmax(best, best_i, red);
      if (tid == 0) {
        float sample;
        if (a.nr_mix > 0) {
          const float mean = __ldcg(lg + k + a.nr_mix);
          if (a.greedy) {
            sample = fminf(fmaxf(mean, -1.0f), 1.0f);
          } else {
            const float log_s =
                fmaxf(__ldcg(lg + k + 2 * a.nr_mix), kLogScaleMin);
            const uint4 bits = philox(make_uint4(0, b, t, 2u), a.key);
            const float u =
                fminf(fmaxf(uniform24(bits.x), 1e-5f), 1.0f - 1e-5f);
            const float x = mean + expf(log_s) * (logf(u) - logf(1.0f - u));
            sample = fminf(fmaxf(x, -1.0f), 1.0f);
          }
        } else {
          sample = 2.0f * (float)k / ((float)NC - 1.0f) - 1.0f;
        }
        xs[b] = sample;
        out[(size_t)t * L + b] = sample;
      }
    }
    grid.sync();
  }
}

template <typename T>
cudaError_t launch(Args a, cudaStream_t stream) {
  auto kernel = wavernn_kernel<T>;
  cudaError_t err;
  int dev = 0, n_sms = 0, per_sm = 0, smem_max = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // the staging buffer takes what shared memory the weights leave free,
  // up to every lane's widest input row
  a.stage_cap = 0;
  const size_t base = make_layout<T>(a).total;
  const int C = a.feat + 4 * a.d;
  const int row = std::max(std::max(a.H, a.F), C);
  const long long room = ((long long)smem_max - (long long)base - 16) / 4;
  if (room < row) return cudaErrorInvalidValue;
  a.stage_cap = (int)std::min(room, (long long)a.L * row);
  const size_t smem = make_layout<T>(a).total;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  const int grid = a.H / a.U;
  if (per_sm * n_sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel((void*)kernel, grid, kThreads, args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs: P_COUNT device pointers in `enum Ptr` order; ints: I_COUNT values
// in `enum Int` order. Returns a cudaError_t (0: launch accepted).
int ftt_wavernn_launch(int bf16, void** ptrs, const long long* ints,
                       void* stream) {
  Args a;
  for (int i = 0; i < P_COUNT; ++i) a.p[i] = ptrs[i];
  a.n_steps = (int)ints[I_STEPS];
  a.L = (int)ints[I_L];
  a.feat = (int)ints[I_FEAT];
  a.d = (int)ints[I_D];
  a.H = (int)ints[I_H];
  a.F = (int)ints[I_F];
  a.NC = (int)ints[I_NC];
  a.nr_mix = (int)ints[I_NR_MIX];
  a.greedy = (int)ints[I_GREEDY];
  a.U = (int)ints[I_U];
  const unsigned long long seed = (unsigned long long)ints[I_SEED];
  a.key = make_uint2((uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32));
  if (a.U <= 0 || a.H % a.U != 0 || 3 * a.U > kMaxRows || a.L <= 0 ||
      a.n_steps <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_blocks = a.H / a.U;
  a.FC = (a.F + n_blocks - 1) / n_blocks;
  a.NCC = (a.NC + n_blocks - 1) / n_blocks;
  if (a.FC > kMaxRows || a.NCC > kMaxRows) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st));
}

const char* ftt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
