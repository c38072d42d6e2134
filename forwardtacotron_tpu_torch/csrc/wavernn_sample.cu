// WaveRNN autoregressive sampling: one persistent cooperative kernel, in
// thread-block clusters, for all steps of all fold lanes (replaces the
// Pallas TPU kernel
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
// What bounds it: every sample depends on the previous one, so a fold is
// a chain of T steps of dependent small products. The operations (2.03 ms
// for 64 lanes x 3850 steps at the bf16 tensor-core peak) are not the
// limit; the chain is: per step, the L2 traffic of the vectors that every
// block needs, the grid barriers between dependent stages, and each
// block's product latency.
//
// Design. Block j owns U hidden units, FC fc columns and NCC logit columns
// and keeps their rows of every loop weight in shared memory for the
// kernel's lifetime (in bf16 zero-padded to whole tensor-core tiles).
// The launcher takes the widest staging tile that fits (each tile costs a
// stage and a product per stage of the step), then the largest U for it
// (fewest blocks: every block stages every lane's input vector for each
// product, so the grid's L2 traffic per step grows with the number of
// blocks). At the full width of config.yaml in bf16 that is 64 blocks of
// U=8 with one tile up to 64 lanes, and 128 blocks of U=4 for the 80-lane
// tile of 72 lanes; float32 takes 128 blocks of U=4 and 32-lane tiles. The
// biases and w_x of a block's rows sit in shared memory too. U=8 at 64
// lanes fits only because x1 = xt + h1 is recomputed rather than kept and
// the lanes' samples share the keys' space.
// - Staging is the largest cost of a step: the vectors come from L2, and
//   the grid's L2 reads (every block reads every lane's vector) run at the
//   L2's rate. So the blocks run in clusters of up to kMaxCluster, the
//   largest that keeps the whole grid resident: each block of a cluster
//   fetches every cs-th row of a tile with one bulk copy (TMA) that
//   multicasts it into the tiles of all the cluster's blocks, and an
//   mbarrier counts the bytes in. L2 then serves each row once per cluster.
//   A cluster barrier before each copy keeps it from overwriting a tile
//   that a block of the cluster still reads (its arrive is relaxed: it
//   publishes nothing). PERF.md has what this saves on an H100.
// - Products are tiles of lanes x the block's rows (padded to 8). In bf16
//   they run on the tensor cores (mma.sync m16n8k16, bf16 in, float32
//   accumulation): ldmatrix reads each resident weight once per step per
//   16-lane tile, never once per lane. A warp takes one 16-lane x 8-row
//   tile over the whole of K in four interleaved accumulators (four
//   independent mma chains, the next four k-steps' fragments loading while
//   the tensor cores take the current ones), sums them in one order in
//   registers and writes its tile: no partial tiles in shared memory, and a
//   lane's result does not depend on the lanes beside it (lane groups equal
//   one launch). float32 keeps CUDA-core FMAs in register tiles of 4 lanes
//   x 8 rows, so one weight read feeds 4 lanes.
// - The vectors between stages (xt, h1, x1, h2, x2, f1, f2) are published
//   to L2 only as the copy rounded to T, which is all any product reads
//   (the plain version rounds them before every product). The owner of a
//   unit keeps the float32 values of xt, h1 and h2 in shared memory for the
//   state update and the residuals. In bf16 this halves the bytes
//   staged.
// - Sampling is fused into the logits stage: each block takes the
//   (Gumbel-perturbed) maximum over its own classes per lane and folds it
//   into one 64-bit key per lane and step with atomicMax: order-preserving
//   float bits high, the complement of the class index low, so ties go to
//   the lowest index and the result does not depend on the atomics' order.
//   Keys live in a ring of three slots; slot t%3 is cleared at step t-1.
//   After the next barrier every block turns the key into the sample (MOL:
//   the picked component's mean and log-scale from the logits its owners
//   wrote). Six grid barriers per step.
//
// Random numbers come from Philox4x32-10 keyed by the seed (an int64 in
// device memory, read once at the kernel's start), with counter
// (slot / 4, lane, step, stream): RAW draws Gumbel noise per class (stream
// 0); MOL draws a Gumbel per mixture component (stream 1) and one logistic
// uniform (stream 2). Greedy mode uses no random numbers.
//
// Precision: weights and conditioning in T (float or bf16), activations
// rounded to T before each product, float32 accumulation, float32 state
// and gate math.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "probe.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 32;     // rows of one matrix a block may own
constexpr int kMaxTile = 128;    // lanes staged at once
constexpr int kKSplit = 4;       // interleaved accumulators of a product
constexpr int kSlots = 3;        // ring of per-step sample keys
constexpr int kMaxCluster = 4;   // blocks sharing one staging multicast
constexpr float kLogScaleMin = -32.23619130191664f;  // log(1e-14)

using bf16 = __nv_bfloat16;

template <typename X>
__host__ __device__ __forceinline__ X mx(X a, X b) { return a > b ? a : b; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ bf16 ld_cg(const bf16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
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

// (value, class) -> a key whose unsigned order is the value's order, then
// the lower class; 0 is below every key
__device__ __forceinline__ unsigned long long make_key(float v, int cls) {
  const uint32_t b = __float_as_uint(v);
  const uint32_t ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)ord << 32) | (uint32_t)(~(uint32_t)cls);
}
__device__ __forceinline__ int key_class(unsigned long long key) {
  return (int)(~(uint32_t)(key & 0xffffffffull));
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int pad16(int k) {
  return (k + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int pad8(int r) { return (r + 7) / 8 * 8; }
// resident rows of a matrix with r live rows: whole 8-row tiles for the
// tensor cores (bf16), none extra for the float32 FMAs
template <typename T>
__host__ __device__ __forceinline__ int rows_of(int r) {
  return sizeof(T) == 2 ? pad8(r) : r;
}
// row stride of a resident matrix or a staged tile: 8 elements past the
// padded K, so that the 8 rows of an ldmatrix fall in distinct banks
__host__ __device__ __forceinline__ int stride_of(int k) {
  return pad16(k) + 8;
}

// ------------------------------------------------------------- products

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// out[l*R + r] = sum_k x[l*SX + k] * w[r*SW + k] for l < nl, r < R, on the
// tensor cores. x: nl lanes (rows up to the next 16 readable), w: rows up
// to the next 8 (zero past R), K a multiple of 16 (zero-padded). Warp item:
// one 16-lane x 8-row tile over the whole of K, k-step kk into accumulator
// kk % kKSplit (independent mma chains); the accumulators are summed in
// order in registers and the tile written straight to out.
__device__ void mma_rows(const bf16* x, int SX, int nl, int K, const bf16* w,
                         int SW, int R, float* out, Probe& probe) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ksteps = K / 16;
  const int n_rt = (R + 7) / 8;
  const int n_items = ((nl + 15) / 16) * n_rt;
  for (int item = warp; item < n_items; item += kWarps) {
    const int mt = item / n_rt, rt = item % n_rt;
    float acc[kKSplit][4];
#pragma unroll
    for (int j = 0; j < kKSplit; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
    const bf16* xa = x + (size_t)(mt * 16 + lane % 16) * SX + (lane / 16) * 8;
    const bf16* wb =
        w + (size_t)(rt * 8 + lane % 8) * SW + ((lane / 8) % 2) * 8;
    // the fragments of the next kKSplit k-steps load while the tensor
    // cores take the current ones
    uint32_t a[2][kKSplit][4], b[2][kKSplit][2];
    auto load = [&](int k0, int buf) {
#pragma unroll
      for (int j = 0; j < kKSplit; ++j)
        if (k0 + j < ksteps) {
          ldsm_x4(a[buf][j], xa + (k0 + j) * 16);
          ldsm_x2(b[buf][j], wb + (k0 + j) * 16);
        }
    };
    auto mma = [&](int k0, int buf) {
#pragma unroll
      for (int j = 0; j < kKSplit; ++j)
        if (k0 + j < ksteps) mma_bf16(acc[j], a[buf][j], b[buf][j]);
    };
    load(0, 0);
    for (int k0 = 0; k0 < ksteps; k0 += 2 * kKSplit) {  // constant buffers
      if (k0 + kKSplit < ksteps) load(k0 + kKSplit, 1);
      mma(k0, 0);
      if (k0 + kKSplit < ksteps) {
        if (k0 + 2 * kKSplit < ksteps) load(k0 + 2 * kKSplit, 0);
        mma(k0 + kKSplit, 1);
      }
    }
    const int l = mt * 16 + lane / 4, r = rt * 8 + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKSplit; ++j) sum += acc[j][i];
      const int li = l + (i / 2) * 8, ri = r + i % 2;
      if (li < nl && ri < R) out[li * R + ri] = sum;
    }
  }
  probe.mark(1);
  __syncthreads();
  probe.mark(5);
}

// float32 version: warp item (4 lanes, 8 rows) over the whole of K, the
// warp's threads striding k; one weight read feeds 4 lanes.
__device__ void fma_rows(const float* x, int SX, int nl, int K,
                         const float* w, int SW, int R, float* out,
                         Probe& probe) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_lg = (nl + 3) / 4, n_rg = (R + 7) / 8;
  for (int item = warp; item < n_lg * n_rg; item += kWarps) {
    const int l0 = (item / n_rg) * 4, r0 = (item % n_rg) * 8;
    float acc[4][8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[j][r] = 0.0f;
    for (int k = lane; k < K; k += 32) {
      float xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = x[(size_t)(l0 + j) * SX + k];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float wv = r0 + r < R ? w[(size_t)(r0 + r) * SW + k] : 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j][r] = fmaf(xv[j], wv, acc[j][r]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float v = warp_sum(acc[j][r]);
        if (lane == 0 && l0 + j < nl && r0 + r < R)
          out[(size_t)(l0 + j) * R + r0 + r] = v;
      }
  }
  probe.mark(1);
  __syncthreads();
  probe.mark(5);
}

__device__ __forceinline__ void product(const bf16* x, int SX, int nl, int K,
                                        const bf16* w, int SW, int R,
                                        float* out, Probe& probe) {
  mma_rows(x, SX, nl, K, w, SW, R, out, probe);
}
__device__ __forceinline__ void product(const float* x, int SX, int nl, int K,
                                        const float* w, int SW, int R,
                                        float* out, Probe& probe) {
  fma_rows(x, SX, nl, K, w, SW, R, out, probe);
}

// ------------------------------------------------------------- staging

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// every copy a stage() of this block issued has landed, for every thread
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// dst[l*SD + d0 + k] = src[l*SS + s0 + k] for l < nl, k < K, and 0 for
// K <= k < pad16(K); complete after staged(). Asynchronous 16-byte copies
// through L2 (other SMs wrote src) where the shapes allow, all in flight
// at once.
template <typename T>
__device__ void stage(const T* src, int SS, int s0, int nl, int K, T* dst,
                      int SD, int d0) {
  constexpr int VEC = 16 / sizeof(T);
  const int KP = pad16(K);
  if (K % VEC == 0 && SS % VEC == 0 && s0 % VEC == 0 && SD % VEC == 0 &&
      d0 % VEC == 0) {
    const int nc = KP / VEC;
    for (int i = threadIdx.x; i < nl * nc; i += kThreads) {
      const int l = i / nc, c = i % nc;
      T* to = dst + (size_t)l * SD + d0 + c * VEC;
      if (c * VEC < K)
        cp_async16(to, src + (size_t)l * SS + s0 + c * VEC);
      else
        *reinterpret_cast<uint4*>(to) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = threadIdx.x; i < nl * KP; i += kThreads) {
      const int l = i / KP, k = i % KP;
      dst[(size_t)l * SD + d0 + k] =
          k < K ? ld_cg(src + (size_t)l * SS + s0 + k) : from_f<T>(0.0f);
    }
  }
}

// Resident rows: dst row q*unit_rows + u <- src row q*stride + r0 + u (q:
// gate block) for rows < n_rows; zero up to n_pad rows and in the padding
// of each row.
template <typename T>
__device__ void load_rows(T* dst, const T* src, int K, int n_rows, int n_pad,
                          int unit_rows, int stride, int r0) {
  const int SW = stride_of(K);
  for (int i = threadIdx.x; i < n_pad * SW; i += kThreads) {
    const int row = i / SW, k = i % SW;
    T v = from_f<T>(0.0f);
    if (row < n_rows && k < K) {
      const int q = row / unit_rows, u = row % unit_rows;
      v = src[(size_t)(q * stride + r0 + u) * K + k];
    }
    dst[i] = v;
  }
}

// ----------------------------------------------------------- arguments

enum Ptr {
  P_COND, P_W_IC, P_W_X, P_B_I, P_W1_IH, P_W1_HH, P_B1_IH, P_B1_HH,
  P_W2_X, P_W2_A, P_W2_HH, P_B2_IH, P_B2_HH, P_FC1_X, P_FC1_A, P_FC1_B,
  P_FC2_X, P_FC2_A, P_FC2_B, P_FC3, P_FC3_B, P_OUT, P_SCRATCH, P_SEED,
  P_COUNT
};
enum Int {
  I_STEPS, I_L, I_FEAT, I_D, I_H, I_F, I_NC, I_NR_MIX, I_GREEDY, I_COUNT
};

struct Args {
  const void* p[P_COUNT];
  int n_steps, L, feat, d, H, F, NC, nr_mix, greedy;
  int U, FC, NCC;  // units, fc columns and classes per block
  int tile;        // lanes staged at once
  int cs;          // blocks of a cluster (their staging tiles multicast)
};

// the staged conditioning row: its four segments, each padded to 16
struct CondLayout {
  int o1, o2, o3, width;
};
__host__ __device__ __forceinline__ CondLayout cond_layout(int feat, int d) {
  CondLayout c;
  c.o1 = pad16(feat + d);
  c.o2 = c.o1 + pad16(d);
  c.o3 = c.o2 + pad16(d);
  c.width = c.o3 + pad16(d);
  return c;
}

struct Layout {  // shared-memory layout (bytes), same on host and device
  size_t w_ic, w2_a, fc1_a, fc2_a, w1_ih, w1_hh, w2_x, w2_hh, fc1_x, fc2_x,
      fc3, f_gh1, f_gh2, f_pg2, f_pf1, f_pf2, f_xt, f_h1, f_h2, f_tmp, k_lane,
      f_bias, bar, stage, total;
  int s_stage;  // row stride of the staging tile (elements)
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
  const int U = a.U, FC = a.FC, NCC = a.NCC, R3 = 3 * a.U;
  const size_t L = a.L;
  const CondLayout cl = cond_layout(a.feat, a.d);
  s.w_ic = m.take(sizeof(T) * rows_of<T>(U) * stride_of(a.feat + a.d));
  s.w2_a = m.take(sizeof(T) * rows_of<T>(R3) * stride_of(a.d));
  s.fc1_a = m.take(sizeof(T) * rows_of<T>(FC) * stride_of(a.d));
  s.fc2_a = m.take(sizeof(T) * rows_of<T>(FC) * stride_of(a.d));
  s.w1_ih = m.take(sizeof(T) * rows_of<T>(R3) * stride_of(a.H));
  s.w1_hh = m.take(sizeof(T) * rows_of<T>(R3) * stride_of(a.H));
  s.w2_x = m.take(sizeof(T) * rows_of<T>(R3) * stride_of(a.H));
  s.w2_hh = m.take(sizeof(T) * rows_of<T>(R3) * stride_of(a.H));
  s.fc1_x = m.take(sizeof(T) * rows_of<T>(FC) * stride_of(a.H));
  s.fc2_x = m.take(sizeof(T) * rows_of<T>(FC) * stride_of(a.F));
  s.fc3 = m.take(sizeof(T) * rows_of<T>(NCC) * stride_of(a.F));
  s.f_gh1 = m.take(sizeof(float) * L * R3);
  s.f_gh2 = m.take(sizeof(float) * L * R3);
  s.f_pg2 = m.take(sizeof(float) * L * R3);
  s.f_pf1 = m.take(sizeof(float) * L * FC);
  s.f_pf2 = m.take(sizeof(float) * L * FC);
  s.f_xt = m.take(sizeof(float) * L * U);
  s.f_h1 = m.take(sizeof(float) * L * U);
  s.f_h2 = m.take(sizeof(float) * L * U);
  s.f_tmp = m.take(sizeof(float) * L * mx(mx(R3, FC), NCC));
  // the lanes' keys of stage F, and (in their first half) the lanes'
  // samples from the start of a step to stage A: lifetimes apart
  s.k_lane = m.take(sizeof(unsigned long long) * L);
  s.f_bias = m.take(sizeof(float) * (4 * R3 + 2 * U + 2 * FC + NCC));
  s.bar = m.take(sizeof(uint64_t));  // the staging tile's mbarrier
  s.s_stage = mx(mx(stride_of(a.H), stride_of(a.F)), cl.width + 8);
  s.stage = m.take(sizeof(T) * (size_t)a.tile * s.s_stage);
  s.total = m.o;
  return s;
}

// global scratch (bytes, zeroed by the caller): keys (kSlots, L) uint64 |
// logits (L, NC) float32 | xt h1 x1 h2 x2 (L, H) and f1 f2 (L, F) in T;
// mirrored by kernels/wavernn_sample.py:scratch_bytes
struct Scratch {
  unsigned long long* keys;
  float* logits;
  void* vecs;
};
__host__ __device__ __forceinline__ Scratch carve(void* base, int L, int NC) {
  unsigned char* p = static_cast<unsigned char*>(base);
  Scratch s;
  s.keys = reinterpret_cast<unsigned long long*>(p);
  const size_t o1 = align16(sizeof(unsigned long long) * kSlots * L);
  s.logits = reinterpret_cast<float*>(p + o1);
  s.vecs = p + o1 + align16(sizeof(float) * (size_t)L * NC);
  return s;
}

// -------------------------------------------------------------- kernel

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
  // float32 values of the block's own units
  // (x1 = xt + h1 is recomputed where needed, bit for bit)
  float* xt_o = reinterpret_cast<float*>(smem + lay.f_xt);
  float* h1_o = reinterpret_cast<float*>(smem + lay.f_h1);
  float* h2_o = reinterpret_cast<float*>(smem + lay.f_h2);
  float* tmp = reinterpret_cast<float*>(smem + lay.f_tmp);
  unsigned long long* k_lane =
      reinterpret_cast<unsigned long long*>(smem + lay.k_lane);
  float* x_s = reinterpret_cast<float*>(smem + lay.k_lane);
  T* stg = reinterpret_cast<T*>(smem + lay.stage);
  const int SG = lay.s_stage;
  // the block's biases and w_x, read every step: kept in shared memory
  float* bias = reinterpret_cast<float*>(smem + lay.f_bias);

  const int L = a.L, H = a.H, F = a.F, d = a.d, U = a.U, NC = a.NC;
  const int C = a.feat + 4 * d, R3 = 3 * U;
  const CondLayout cl = cond_layout(a.feat, d);
  const int u0 = blockIdx.x * U;
  const int fc0 = blockIdx.x * a.FC, nc0 = blockIdx.x * a.NCC;
  const int fcn = max(0, min(a.FC, F - fc0));
  const int ncn = max(0, min(a.NCC, NC - nc0));
  const int tid = threadIdx.x;
  const bool mol = a.nr_mix > 0;

  const T* cond = static_cast<const T*>(a.p[P_COND]);
  // the Philox key: the int64 seed, read from device memory once (not a
  // launch parameter, so a replay of a captured graph takes the seed that
  // its input buffer holds at that time)
  const unsigned long long seed =
      *static_cast<const unsigned long long*>(a.p[P_SEED]);
  const uint2 key =
      make_uint2((uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32));
  // bias layout: b1_ih b1_hh b2_ih b2_hh (3U each, row q*U+u), b_i w_x
  // (U), fc1_b fc2_b (FC), fc3_b (NCC): local index -> global
  float* b1_ih = bias;
  float* b1_hh = b1_ih + R3;
  float* b2_ih = b1_hh + R3;
  float* b2_hh = b2_ih + R3;
  float* b_i = b2_hh + R3;
  float* w_x = b_i + U;
  float* fc1_b = w_x + U;
  float* fc2_b = fc1_b + a.FC;
  float* fc3_b = fc2_b + a.FC;
  float* out = static_cast<float*>(const_cast<void*>(a.p[P_OUT]));
  const Scratch g = carve(const_cast<void*>(a.p[P_SCRATCH]), L, NC);
  T* xt_g = static_cast<T*>(g.vecs);  // published copies, rounded to T
  T* h1_g = xt_g + (size_t)L * H;
  T* x1_g = h1_g + (size_t)L * H;
  T* h2_g = x1_g + (size_t)L * H;
  T* x2_g = h2_g + (size_t)L * H;
  T* f1_g = x2_g + (size_t)L * H;
  T* f2_g = f1_g + (size_t)L * F;

  // resident weights: rows of this block's units / columns
  const int fcr = max(fcn, 1), ncr = max(ncn, 1);
  load_rows(w_ic, static_cast<const T*>(a.p[P_W_IC]), a.feat + d, U, rows_of<T>(U),
            U, H, u0);
  load_rows(w2_a, static_cast<const T*>(a.p[P_W2_A]), d, R3, rows_of<T>(R3), U, H,
            u0);
  load_rows(w1_ih, static_cast<const T*>(a.p[P_W1_IH]), H, R3, rows_of<T>(R3), U,
            H, u0);
  load_rows(w1_hh, static_cast<const T*>(a.p[P_W1_HH]), H, R3, rows_of<T>(R3), U,
            H, u0);
  load_rows(w2_x, static_cast<const T*>(a.p[P_W2_X]), H, R3, rows_of<T>(R3), U, H,
            u0);
  load_rows(w2_hh, static_cast<const T*>(a.p[P_W2_HH]), H, R3, rows_of<T>(R3), U,
            H, u0);
  load_rows(fc1_a, static_cast<const T*>(a.p[P_FC1_A]), d, fcn, rows_of<T>(a.FC),
            fcr, F, fc0);
  load_rows(fc2_a, static_cast<const T*>(a.p[P_FC2_A]), d, fcn, rows_of<T>(a.FC),
            fcr, F, fc0);
  load_rows(fc1_x, static_cast<const T*>(a.p[P_FC1_X]), H, fcn, rows_of<T>(a.FC),
            fcr, F, fc0);
  load_rows(fc2_x, static_cast<const T*>(a.p[P_FC2_X]), F, fcn, rows_of<T>(a.FC),
            fcr, F, fc0);
  load_rows(fc3, static_cast<const T*>(a.p[P_FC3]), F, ncn, rows_of<T>(a.NCC), ncr,
            NC, nc0);
  for (int i = tid; i < R3; i += kThreads) {
    const int row = (i / U) * H + u0 + i % U;
    b1_ih[i] = static_cast<const float*>(a.p[P_B1_IH])[row];
    b1_hh[i] = static_cast<const float*>(a.p[P_B1_HH])[row];
    b2_ih[i] = static_cast<const float*>(a.p[P_B2_IH])[row];
    b2_hh[i] = static_cast<const float*>(a.p[P_B2_HH])[row];
  }
  for (int i = tid; i < U; i += kThreads) {
    b_i[i] = static_cast<const float*>(a.p[P_B_I])[u0 + i];
    w_x[i] = static_cast<const float*>(a.p[P_W_X])[u0 + i];
  }
  for (int i = tid; i < fcn; i += kThreads) {
    fc1_b[i] = static_cast<const float*>(a.p[P_FC1_B])[fc0 + i];
    fc2_b[i] = static_cast<const float*>(a.p[P_FC2_B])[fc0 + i];
  }
  for (int i = tid; i < ncn; i += kThreads)
    fc3_b[i] = static_cast<const float*>(a.p[P_FC3_B])[nc0 + i];
  // staged rows past a tile's lanes are read by the products and their
  // results dropped: keep them finite
  for (int i = tid; i < a.tile * SG; i += kThreads) stg[i] = from_f<T>(0.0f);
  for (int i = tid; i < L * U; i += kThreads) {
    h1_o[i] = 0.0f;
    h2_o[i] = 0.0f;
  }
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);
  if (tid == 0) mbar_init(bar);
  fence_proxy_async();  // the zeroed tile before the copies into it
  __syncthreads();
  // Every use of the staging tile, in every block of a cluster alike:
  // cluster_wait() (no block of the cluster still reads its tile), stage,
  // products, cluster_arrive_relaxed(). A block alone (cs = 1) needs none
  // of it: its products end at a block barrier. This arrive pairs with the
  // first wait: every block of the cluster has its barrier ready and its
  // tile zeroed.
  const bool clustered = a.cs > 1;
  if (clustered) cluster_arrive();
  uint32_t phase = 0;  // of the mbarrier

  // probe phases: 0 stage, 1 product, 2 gate update, 3 barrier, 4 sample,
  // 5 product wait (for the other warps' tiles)
  Probe probe;
  // the staging tile <- rows of in (K elements, stride SI): multicast
  // within the cluster where the rows are whole 16-element chunks, else
  // each block stages them all
  auto stage_rows = [&](const T* in, int SI, int nl, int K) {
    if (clustered) cluster_wait();
    if (K % 16 == 0 && SI % 16 == 0) {
      stage_multicast<T>(in, SI, nl, K, stg, SG, bar, a.cs);
      mbar_wait(bar, phase);
      phase ^= 1;
    } else {
      stage<T>(in, SI, 0, nl, K, stg, SG, 0);
      staged();
    }
    probe.mark(0);
  };
  // y[l*R + r] = in[l*SI + :K] . w[r] for every lane, in tiles of lanes
  auto rows_dot = [&](const T* in, int SI, int K, const T* w, int R,
                      float* y) {
    for (int l0 = 0; l0 < L; l0 += a.tile) {
      const int nl = min(a.tile, L - l0);
      stage_rows(in + (size_t)l0 * SI, SI, nl, K);
      if (R > 0)
        product(stg, SG, nl, pad16(K), w, stride_of(K), R, y + l0 * R, probe);
      else
        __syncthreads();  // the tile's next copy waits for every thread
      if (clustered) cluster_arrive_relaxed();
    }
  };
  // the conditioning row is staged whole where its segments are whole
  // 16-element chunks (the tile's layout is then the row's own)
  const bool cond_whole = (a.feat + d) % 16 == 0 && d % 16 == 0;

  for (int t = 0; t <= a.n_steps; ++t) {
    // the previous step's samples, from its keys
    if (t > 0) {
      const int tp = t - 1;
      const unsigned long long* keys = g.keys + (size_t)(tp % kSlots) * L;
      for (int l = tid; l < L; l += kThreads) {
        const int k = key_class(__ldcg(keys + l));
        float sample;
        if (mol) {
          const float* lg = g.logits + (size_t)l * NC;
          const float mean = __ldcg(lg + k + a.nr_mix);
          if (a.greedy) {
            sample = fminf(fmaxf(mean, -1.0f), 1.0f);
          } else {
            const float log_s =
                fmaxf(__ldcg(lg + k + 2 * a.nr_mix), kLogScaleMin);
            const uint4 bits = philox(make_uint4(0, l, tp, 2u), key);
            const float u =
                fminf(fmaxf(uniform24(bits.x), 1e-5f), 1.0f - 1e-5f);
            const float x = mean + expf(log_s) * (logf(u) - logf(1.0f - u));
            sample = fminf(fmaxf(x, -1.0f), 1.0f);
          }
        } else {
          sample = 2.0f * (float)k / ((float)NC - 1.0f) - 1.0f;
        }
        x_s[l] = sample;
        if (blockIdx.x == 0) {
          out[(size_t)tp * L + l] = sample;
          // slot (t+1)%3 was last read at step t-1, before this step's
          // barriers: clear it for step t+1
          g.keys[(size_t)((t + 1) % kSlots) * L + l] = 0ull;
        }
      }
    } else {
      for (int l = tid; l < L; l += kThreads) x_s[l] = 0.0f;
    }
    if (t == a.n_steps) break;
    __syncthreads();
    probe.mark(4);

    // A: conditioning projections, xt, and the hidden products of the
    //    previous states
    const T* cond_t = cond + (size_t)t * L * C;
    for (int l0 = 0; l0 < L; l0 += a.tile) {
      const int nl = min(a.tile, L - l0);
      const T* src = cond_t + (size_t)l0 * C;
      if (cond_whole) {
        stage_rows(src, C, nl, C);
      } else {
        if (clustered) cluster_wait();
        stage<T>(src, C, 0, nl, a.feat + d, stg, SG, 0);
        stage<T>(src, C, a.feat + d, nl, d, stg, SG, cl.o1);
        stage<T>(src, C, a.feat + 2 * d, nl, d, stg, SG, cl.o2);
        stage<T>(src, C, a.feat + 3 * d, nl, d, stg, SG, cl.o3);
        staged();
        probe.mark(0);
      }
      product(stg, SG, nl, pad16(a.feat + d), w_ic, stride_of(a.feat + d), U,
              tmp + l0 * U, probe);
      product(stg + cl.o1, SG, nl, pad16(d), w2_a, stride_of(d), R3,
              pg2 + l0 * R3, probe);
      if (fcn > 0) {
        product(stg + cl.o2, SG, nl, pad16(d), fc1_a, stride_of(d), fcn,
                pf1 + l0 * fcn, probe);
        product(stg + cl.o3, SG, nl, pad16(d), fc2_a, stride_of(d), fcn,
                pf2 + l0 * fcn, probe);
      }
      if (clustered) cluster_arrive_relaxed();
    }
    for (int i = tid; i < L * U; i += kThreads) {
      const int l = i / U, u = i % U;
      const float xt = tmp[i] + b_i[u] + x_s[l] * w_x[u];
      xt_o[i] = xt;
      xt_g[(size_t)l * H + u0 + u] = from_f<T>(xt);
    }
    probe.mark(2);
    rows_dot(h1_g, H, H, w1_hh, R3, gh1);
    rows_dot(h2_g, H, H, w2_hh, R3, gh2);
    grid.sync();
    probe.mark(3);

    // B: GRU1
    rows_dot(xt_g, H, H, w1_ih, R3, tmp);
    for (int i = tid; i < L * U; i += kThreads) {
      const int l = i / U, u = i % U, unit = u0 + u;
      const float* gi = tmp + l * R3;
      const float* gh = gh1 + l * R3;
      const float r = sigmoid(gi[u] + b1_ih[u] + gh[u] + b1_hh[u]);
      const float z = sigmoid(gi[U + u] + b1_ih[U + u] + gh[U + u] +
                              b1_hh[U + u]);
      const float n = tanhf(gi[2 * U + u] + b1_ih[2 * U + u] +
                            r * (gh[2 * U + u] + b1_hh[2 * U + u]));
      const float h = (1.0f - z) * n + z * h1_o[i];
      h1_o[i] = h;
      h1_g[(size_t)l * H + unit] = from_f<T>(h);
      x1_g[(size_t)l * H + unit] = from_f<T>(xt_o[i] + h);
    }
    probe.mark(2);
    grid.sync();
    probe.mark(3);

    // C: GRU2
    rows_dot(x1_g, H, H, w2_x, R3, tmp);
    for (int i = tid; i < L * U; i += kThreads) {
      const int l = i / U, u = i % U, unit = u0 + u;
      const float* gi = tmp + l * R3;
      const float* pg = pg2 + l * R3;
      const float* gh = gh2 + l * R3;
      const float r = sigmoid(gi[u] + pg[u] + b2_ih[u] + gh[u] + b2_hh[u]);
      const float z = sigmoid(gi[U + u] + pg[U + u] + b2_ih[U + u] +
                              gh[U + u] + b2_hh[U + u]);
      const float n = tanhf(gi[2 * U + u] + pg[2 * U + u] + b2_ih[2 * U + u] +
                            r * (gh[2 * U + u] + b2_hh[2 * U + u]));
      const float h = (1.0f - z) * n + z * h2_o[i];
      h2_o[i] = h;
      h2_g[(size_t)l * H + unit] = from_f<T>(h);
      x2_g[(size_t)l * H + unit] = from_f<T>(xt_o[i] + h1_o[i] + h);
    }
    probe.mark(2);
    grid.sync();
    probe.mark(3);

    // D: fc1
    rows_dot(x2_g, H, H, fc1_x, fcn, tmp);
    for (int i = tid; i < L * fcn; i += kThreads) {
      const int l = i / fcn, j = i % fcn;
      f1_g[(size_t)l * F + fc0 + j] = from_f<T>(
          fmaxf(tmp[i] + pf1[l * fcn + j] + fc1_b[j], 0.0f));
    }
    probe.mark(2);
    grid.sync();
    probe.mark(3);

    // E: fc2
    rows_dot(f1_g, F, F, fc2_x, fcn, tmp);
    for (int i = tid; i < L * fcn; i += kThreads) {
      const int l = i / fcn, j = i % fcn;
      f2_g[(size_t)l * F + fc0 + j] = from_f<T>(
          fmaxf(tmp[i] + pf2[l * fcn + j] + fc2_b[j], 0.0f));
    }
    probe.mark(2);
    grid.sync();
    probe.mark(3);

    // F: logits of the block's classes, folded into this step's keys
    rows_dot(f2_g, F, F, fc3, ncn, tmp);
    for (int l = tid; l < L; l += kThreads) k_lane[l] = 0ull;
    __syncthreads();
    const int n_pick = mol ? a.nr_mix : NC;
    const uint32_t stream = mol ? 1u : 0u;
    for (int i = tid; i < L * ncn; i += kThreads) {
      const int l = i / ncn, j = nc0 + i % ncn;
      const float lg = tmp[i] + fc3_b[j - nc0];
      if (mol) g.logits[(size_t)l * NC + j] = lg;
      if (j >= n_pick) continue;
      float v = lg;
      if (!a.greedy) {
        const uint4 bits = philox(make_uint4(j / 4, l, t, stream), key);
        const float u = uniform24(word(bits, j % 4));
        if (mol)
          v -= logf(-logf(fminf(fmaxf(u, 1e-5f), 1.0f - 1e-5f)));
        else
          v += -logf(-logf(u + 1e-9f) + 1e-9f);
      }
      atomicMax(k_lane + l, make_key(v, j));
    }
    __syncthreads();
    unsigned long long* keys = g.keys + (size_t)(t % kSlots) * L;
    for (int l = tid; l < L; l += kThreads)
      if (k_lane[l] != 0ull) atomicMax(keys + l, k_lane[l]);
    probe.mark(4);
    grid.sync();
    probe.mark(3);
  }
  if (clustered) cluster_wait();  // pairs with the last arrive
  probe.finish();
}

// The widest staging tile (at most kMaxTile lanes, whole 16-lane tiles)
// that fits, and for it the largest U (fewest blocks). Each tile costs a
// stage and a product per stage of the step, so the tile comes first (72
// fold lanes in one 80-lane tile rather than 64 + 16).
template <typename T>
bool pick_layout(Args& a, int n_sms, int smem_max) {
  const int widest = a.L >= kMaxTile ? kMaxTile : (a.L + 15) / 16 * 16;
  for (a.tile = widest; a.tile >= 16; a.tile -= 16) {
    for (int U = kMaxRows / 3; U >= 1; --U) {
      if (a.H % U != 0 || a.H / U > n_sms) continue;
      const int n_blocks = a.H / U;
      a.U = U;
      a.FC = (a.F + n_blocks - 1) / n_blocks;
      a.NCC = (a.NC + n_blocks - 1) / n_blocks;
      if (a.FC > kMaxRows || a.NCC > kMaxRows) continue;
      if (make_layout<T>(a).total <= (size_t)smem_max) return true;
    }
  }
  return false;
}

template <typename T>
cudaError_t launch(Args a, cudaStream_t stream) {
  auto kernel = wavernn_kernel<T>;
  cudaError_t err;
  int dev = 0, n_sms = 0, smem_max = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (!pick_layout<T>(a, n_sms, smem_max)) return cudaErrorInvalidValue;
  const size_t smem = make_layout<T>(a).total;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = a.H / a.U;
  cudaLaunchAttribute attrs[2];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  err = max_resident_cluster(kernel, cfg, attrs, kMaxCluster, grid, &a.cs);
  if (err != cudaSuccess) return err;
  if (a.cs < 1) return cudaErrorCooperativeLaunchTooLarge;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs: P_COUNT device pointers in `enum Ptr` order (the scratch zeroed;
// P_SEED an int64 scalar, the Philox key); ints: I_COUNT values in
// `enum Int` order. Returns a cudaError_t (0:
// launch accepted).
int ftt_wavernn_launch(int use_bf16, void** ptrs, const long long* ints,
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
  if (a.L <= 0 || a.n_steps <= 0 || a.H <= 0 || a.F <= 0 || a.NC <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(use_bf16 ? launch<bf16>(a, st) : launch<float>(a, st));
}

const char* ftt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
