// Training recurrences of the bidirectional GRU/LSTM: the forward with its
// stash and the backward through time, as two persistent cooperative
// kernels (replace the Pallas TPU kernels
// forwardtacotron_tpu/kernels/birnn.py:_kernel_train_fwd, reached through
// _train_fwd_call, and _kernel_train_bwd, reached through _train_bwd_call).
//
// Stream layout as in csrc/birnn.cu: S streams (2 directions x G groups)
// advance together and odd streams walk time-reversed input, so both
// kernels index time by the kernel step t. A stream is inside its sequence
// at step t iff t < len (even) or t >= n_steps - len (odd).
//
// Forward (ftt_birnn_train_fwd): the recurrence of csrc/birnn.cu plus a
// stash of 5H values per stream and step (GRU r, z, n, gh_n, h_prev; LSTM
// i, f, g, o, c_prev), in the compute type. Block j owns U hidden units of
// one stream and keeps their NG*U rows of W_hh in shared memory. At each
// step the block stages its stream's whole h (B x H float32, written by
// every block of the stream at the previous step) from L2 into shared
// memory; each warp then multiplies kBT batch lanes at once against the
// resident rows, so one weight read from shared memory feeds kBT FMAs. The
// thread that updates (b, u) also writes its five stash values. One grid
// barrier per step; h is double-buffered in global memory.
//
// Batch-split forward (ftt_birnn_train_fwd_bs), for short, narrow
// recurrences (the series predictors' BiGRUs: H=64/128, T~192, B=32). The
// cooperative kernel spends 4-5 us a step there on fixed costs: staging h
// from L2, the gate inputs loaded after the product, a grid barrier. But
// batch lanes are independent, and a small stream's whole W_hh fits one
// block (GRU H=128 float32: 192 KB). So block (s, lane) holds W_hh in
// shared memory and walks all steps for its lane with __syncthreads only:
// no cooperative launch, no grid barrier, no L2 round trip for h. Thread
// (g, ks) multiplies kBsRows rows g + r*NR against k-slice ks of h; the
// first chunks of those rows stay in registers for the whole walk (half
// of W_hh at H=128 float32, all of it at H=64), the rest is read from
// shared memory; the KS partial sums of a row go through shared memory
// and one thread per row adds them in a fixed order. The step's gate
// inputs arrive by
// cp.async one step ahead. y and the stash are written in the layout
// above, so the backward takes them unchanged. What bounds it: per step,
// reading the shared-memory part of W_hh and the chain product -> gate
// math -> next product within one SM; the operations (2*B*S*NG*H*H per
// step, 75 ns at H=128) and bytes are far below.
//
// Backward (ftt_birnn_train_bwd): one reversed walk over the steps for
// every stream. The per-step product is transposed relative to the forward
// (dh_prev = dgates @ W_hh), so block j keeps the U COLUMNS of W_hh of its
// units (NG*H x U) in shared memory. At each step it (A) forms the gate
// gradients of its units from the stash, dy and its carried dh (and dc for
// LSTM), writes them to dgi/dgh and, rounded to the compute type, to an
// exchange buffer in global memory, waits at one grid barrier, then (B)
// reduces its stream's whole B x NG*H exchange vector against its columns
// to get its units' dh_prev. dh and dc never leave the block. The exchange
// is double-buffered, so one barrier per step suffices: a block writes
// buffer k&1 at step k only after every block passed the barrier of step
// k-1, that is after every block finished reading buffer k&1 at step k-2.
//
// What bounds them: the bytes are gi + y + stash (forward) and stash + dy +
// dgi (+ dgh) (backward); the operations are 2*T*B*S*NG*H*H each, 1.4 ms
// at the float32 peak for the decoder LSTM (H=512, T=1024, B=32). Neither
// is the limit on this card: the steps form a chain of T grid barriers,
// and each step is a short sequence of dependent phases per block (stage
// h, product, cell update; or gate gradients, barrier, product). Phase B
// of the backward is the expected hot spot (not yet timed apart from the
// rest of the step): every block reads its stream's whole
// B x NG*H exchange vector from L2 at every step (256 KB per block, 32 MB
// over the grid, for the decoder LSTM in float32). Thread block clusters
// with distributed shared memory are the place to cut that exchange.
//
// Precision, as csrc/birnn.cu and the TPU kernels: weights, gate inputs,
// the stash and the gate gradients in T (float or bf16); h is rounded to T
// before the forward product and dgh before the backward product; products
// accumulate in float32; gate math is float32.
//
// Plain C interface (bound with ctypes): each launcher returns a
// cudaError_t; 0 means the launch was accepted.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "probe.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBT = 4;  // batch lanes per warp item of the forward product
constexpr int kBsRows = 4;          // W_hh rows per thread of its product
constexpr int kBsMaxThreads = 512;  // 128 registers a thread, no spills
constexpr int kBsMaxSplits = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
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

__device__ __forceinline__ bool inside(int s, int t, int n_steps, int len) {
  return (s & 1) ? (t >= n_steps - len) : (t < len);
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// forward: batch groups of kBT lanes, and k-splits so that every warp has
// an item when the batch is small
__host__ __device__ __forceinline__ int n_bgroups(int B) {
  return (B + kBT - 1) / kBT;
}
__host__ __device__ __forceinline__ int fwd_splits(int B) {
  return n_bgroups(B) >= kWarps ? 1 : kWarps / n_bgroups(B);
}
// backward: g-splits of the phase-B reduction
__host__ __device__ __forceinline__ int bwd_splits(int B) {
  return B >= kWarps ? 1 : kWarps / B;
}

struct FwdArgs {
  const void* gi;        // (n_steps, B, S, NG*H) T
  const void* w_hh;      // (S, NG*H, H) T
  const float* b_hh;     // (S, NG*H)
  const int* lengths;    // (B)
  float* y;              // (n_steps, B, S, H)
  void* stash;           // (n_steps, B, S, 5, H) T
  float* hbuf;           // (2, S, B, H), zeroed
  int n_steps, B, S, H;
};

struct BwdArgs {
  const void* stash;     // (n_steps, B, S, 5, H) T
  const float* dy;       // (n_steps, B, S, H)
  const void* w_hh;      // (S, NG*H, H) T
  const int* lengths;    // (B)
  void* dgi;             // (n_steps, B, S, NG*H) T
  void* dgh;             // same, GRU only (nullptr for LSTM)
  float* xbuf;           // (2, S, B, NG*H) exchange
  int n_steps, B, S, H;
};

template <typename T, bool LSTM, int U>
__global__ void __launch_bounds__(kThreads) train_fwd_kernel(FwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int R = NG * U;
  const T* __restrict__ gi = static_cast<const T*>(a.gi);
  const T* __restrict__ w_hh = static_cast<const T*>(a.w_hh);
  T* __restrict__ stash = static_cast<T*>(a.stash);
  const int n_steps = a.n_steps, B = a.B, S = a.S, H = a.H;
  const int GH = NG * H;
  const int blocks_per_stream = H / U;
  const int s = blockIdx.x / blocks_per_stream;
  const int u0 = (blockIdx.x % blocks_per_stream) * U;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int NBG = n_bgroups(B);
  const int KS = fwd_splits(B);
  const int kc = (H + KS - 1) / KS;

  extern __shared__ __align__(16) unsigned char smem[];
  T* w_s = reinterpret_cast<T*>(smem);  // row q*U+u: gate q of unit u0+u
  float* h_s = reinterpret_cast<float*>(smem + align16(sizeof(T) * R * H));
  float* part = h_s + (size_t)NBG * kBT * H;  // (NBG*KS, kBT, R)
  float* c_s = part + (size_t)NBG * KS * kBT * R;  // (B, U) LSTM cell

  for (int i = tid; i < R * H; i += kThreads) {
    const int row = i / H, k = i % H;
    const int q = row / U, u = row % U;
    w_s[i] = w_hh[((size_t)s * GH + q * H + u0 + u) * H + k];
  }
  // rows B..NBG*kBT of h_s stay zero: staging writes rows < B only
  for (int i = B * H + tid; i < NBG * kBT * H; i += kThreads) h_s[i] = 0.0f;
  for (int i = tid; i < B * U; i += kThreads) c_s[i] = 0.0f;
  __syncthreads();

  // probe phases: 0 stage h, 1 product, 2 reduce, 3 gate update, 4 barrier
  Probe probe;
  const size_t buf_stride = (size_t)S * B * H;
  for (int t = 0; t < n_steps; ++t) {
    const float* h_prev = a.hbuf + (t & 1) * buf_stride + (size_t)s * B * H;
    float* h_next = a.hbuf + ((t + 1) & 1) * buf_stride + (size_t)s * B * H;
    for (int i = tid; i < B * H; i += kThreads) h_s[i] = __ldcg(h_prev + i);
    __syncthreads();
    probe.mark(0);

    for (int item = warp; item < NBG * KS; item += kWarps) {
      const int bg = item / KS, ks = item % KS;
      const int k0 = ks * kc, k1 = min(H, k0 + kc);
      float acc[kBT][R];
#pragma unroll
      for (int j = 0; j < kBT; ++j)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[j][r] = 0.0f;
      for (int k = k0 + lane; k < k1; k += 32) {
        float hv[kBT];
#pragma unroll
        for (int j = 0; j < kBT; ++j)
          hv[j] = round_to<T>(h_s[(size_t)(bg * kBT + j) * H + k]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float w = to_f(w_s[r * H + k]);
#pragma unroll
          for (int j = 0; j < kBT; ++j) acc[j][r] = fmaf(hv[j], w, acc[j][r]);
        }
      }
      probe.mark(1);
#pragma unroll
      for (int j = 0; j < kBT; ++j)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float v = warp_sum(acc[j][r]);
          if (lane == 0) part[((size_t)item * kBT + j) * R + r] = v;
        }
    }
    __syncthreads();
    probe.mark(2);

    for (int i = tid; i < B * U; i += kThreads) {
      const int b = i / U, u = i % U, unit = u0 + u;
      const int bg = b / kBT, j = b % kBT;
      const T* g_in = gi + (((size_t)t * B + b) * S + s) * GH;
      float gh[NG];
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        float acc = 0.0f;
        for (int ks = 0; ks < KS; ++ks)
          acc += part[((size_t)(bg * KS + ks) * kBT + j) * R + q * U + u];
        gh[q] = acc + a.b_hh[(size_t)s * GH + q * H + unit];
      }
      const float hp = h_s[(size_t)b * H + unit];
      T* st = stash + (((size_t)t * B + b) * S + s) * 5 * H + unit;
      float hn, cn = 0.0f;
      if (LSTM) {
        const float ig = sigmoid(to_f(g_in[unit]) + gh[0]);
        const float fg = sigmoid(to_f(g_in[H + unit]) + gh[1]);
        const float gg = tanhf(to_f(g_in[2 * H + unit]) + gh[2]);
        const float og = sigmoid(to_f(g_in[3 * H + unit]) + gh[3]);
        cn = fg * c_s[i] + ig * gg;
        hn = og * tanhf(cn);
        st[0] = from_f<T>(ig);
        st[H] = from_f<T>(fg);
        st[2 * H] = from_f<T>(gg);
        st[3 * H] = from_f<T>(og);
        st[4 * H] = from_f<T>(c_s[i]);
      } else {
        const float r = sigmoid(to_f(g_in[unit]) + gh[0]);
        const float z = sigmoid(to_f(g_in[H + unit]) + gh[1]);
        const float n = tanhf(to_f(g_in[2 * H + unit]) + r * gh[2]);
        hn = (1.0f - z) * n + z * hp;
        st[0] = from_f<T>(r);
        st[H] = from_f<T>(z);
        st[2 * H] = from_f<T>(n);
        st[3 * H] = from_f<T>(gh[2]);
        st[4 * H] = from_f<T>(hp);
      }
      const bool active = inside(s, t, n_steps, a.lengths[b]);
      if (!active) hn = hp;
      if (LSTM && active) c_s[i] = cn;
      h_next[(size_t)b * H + unit] = hn;
      a.y[(((size_t)t * B + b) * S + s) * H + unit] = hn;
    }
    probe.mark(3);
    grid.sync();
    probe.mark(4);
  }
  probe.finish();
}

// 16 bytes of T as floats: 4 floats or 8 bf16 (element 0 in the low half)
__device__ __forceinline__ void unpack16(const uint4& v, float* f, float) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack16(const uint4& v, float* f,
                                         __nv_bfloat16) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Batch-split forward: block (s, b) holds stream s's whole W_hh and walks
// every step of batch lane b alone; see the note at the top of the file.
template <typename T, bool LSTM>
__global__ void __launch_bounds__(kBsMaxThreads)
    train_fwd_bs_kernel(FwdArgs a, int KS) {
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int VEC = 16 / sizeof(T);
  // chunks of a thread's rows kept in registers (64 registers' worth)
  constexpr int REG = sizeof(T) == 4 ? 4 : 2;
  const T* __restrict__ gi = static_cast<const T*>(a.gi);
  const T* __restrict__ w_hh = static_cast<const T*>(a.w_hh);
  T* __restrict__ stash = static_cast<T*>(a.stash);
  const int n_steps = a.n_steps, B = a.B, S = a.S, H = a.H;
  const int GH = NG * H, NC = H / VEC, NR = GH / kBsRows;
  const int nc = NC / KS;         // chunks of a row per k-slice
  const int s = blockIdx.x / B, b = blockIdx.x % B;
  const int tid = threadIdx.x;

  // the product item of this thread: k-slice ks of gate rows g + r*NR,
  // r < kBsRows; a warp shares ks, so its h reads are broadcasts; each h
  // read feeds kBsRows rows
  const int g = tid % NR, ks = tid / NR;
  const bool prod = tid < NR * KS;

  extern __shared__ __align__(16) unsigned char smem[];
  uint4* w_s = reinterpret_cast<uint4*>(smem);  // NC * GH chunks of W_hh
  float* hq_s = reinterpret_cast<float*>(smem + sizeof(T) * GH * H);
  float* part = hq_s + H;                       // (KS, GH)
  float* gh_s = part + (size_t)KS * GH;         // (GH)
  T* g_s = reinterpret_cast<T*>(gh_s + GH);
  // g_s: (2, GH) gate inputs, double-buffered by step

  // chunk (c, row) = W_hh[s][row][c*VEC, (c+1)*VEC) at c*GH + row: a warp
  // of the product reads 32 consecutive chunks (512 bytes) without bank
  // conflicts
  const T* w_src = w_hh + (size_t)s * GH * H;
  for (int i = tid; i < GH * NC; i += blockDim.x) {
    const int row = i / NC, c = i % NC;
    w_s[(size_t)c * GH + row] =
        *reinterpret_cast<const uint4*>(w_src + (size_t)row * H + c * VEC);
  }
  for (int i = tid; i < H; i += blockDim.x) hq_s[i] = 0.0f;

  // the step's gate inputs of the block's lane, 16 bytes per copy, into
  // buffer t&1 (an empty group past the last step keeps the count)
  auto prefetch = [&](int t) {
    if (t < n_steps) {
      T* dst = g_s + (size_t)(t & 1) * GH;
      const T* src = gi + ((size_t)t * B + b) * S * GH + (size_t)s * GH;
      for (int i = tid; i < GH / VEC; i += blockDim.x)
        cp_async16(dst + i * VEC, src + i * VEC);
    }
    cp_async_commit();
  };
  prefetch(0);

  // the unit this thread updates, and its state, kept in registers
  const int u = tid;
  const bool owner = tid < H;
  const int len = owner ? a.lengths[b] : 0;
  float bh[NG];
#pragma unroll
  for (int q = 0; q < NG; ++q)
    bh[q] = owner ? a.b_hh[(size_t)s * GH + q * H + u] : 0.0f;
  float h = 0.0f, c = 0.0f;
  __syncthreads();
  // the first REG chunks of the thread's rows stay in registers for the
  // whole walk, so shared memory serves only the rest
  const uint4* w_mine = w_s + (size_t)ks * nc * GH + g;  // chunk cc, row r
  auto w_at = [&](int cc, int r) { return w_mine[cc * GH + r * NR]; };
  const float* h_mine = hq_s + ks * nc * VEC;             // this k-slice of h
  uint4 w_reg[REG][kBsRows];
#pragma unroll
  for (int cc = 0; cc < REG; ++cc)
#pragma unroll
    for (int r = 0; r < kBsRows; ++r)
      w_reg[cc][r] = prod && cc < nc ? w_at(cc, r) : make_uint4(0, 0, 0, 0);

  // probe phases: 0 product, 1 wait for the other warps, 2 gate sums,
  // 3 gate math and stash stores, 4 stores of y and h, 5 wait
  Probe probe;
  for (int t = 0; t < n_steps; ++t) {
    prefetch(t + 1);
    if (prod) {
      float acc[kBsRows];
#pragma unroll
      for (int r = 0; r < kBsRows; ++r) acc[r] = 0.0f;
      // acc += chunk cc of the thread's rows (w) times h
      auto fma_chunk = [&](const uint4* w, int cc) {
        float wf[kBsRows][VEC];
#pragma unroll
        for (int r = 0; r < kBsRows; ++r) unpack16(w[r], wf[r], T());
        const float4* hp = reinterpret_cast<const float4*>(h_mine + cc * VEC);
#pragma unroll
        for (int v = 0; v < VEC / 4; ++v) {
          const float4 hv = hp[v];
#pragma unroll
          for (int r = 0; r < kBsRows; ++r) {
            acc[r] = fmaf(hv.x, wf[r][4 * v], acc[r]);
            acc[r] = fmaf(hv.y, wf[r][4 * v + 1], acc[r]);
            acc[r] = fmaf(hv.z, wf[r][4 * v + 2], acc[r]);
            acc[r] = fmaf(hv.w, wf[r][4 * v + 3], acc[r]);
          }
        }
      };
#pragma unroll
      for (int cc = 0; cc < REG; ++cc)
        if (cc < nc) fma_chunk(w_reg[cc], cc);
#pragma unroll 2
      for (int cc = REG; cc < nc; ++cc) {
        uint4 w[kBsRows];
#pragma unroll
        for (int r = 0; r < kBsRows; ++r) w[r] = w_at(cc, r);
        fma_chunk(w, cc);
      }
#pragma unroll
      for (int r = 0; r < kBsRows; ++r)
        part[(size_t)ks * GH + g + r * NR] = acc[r];
    }
    probe.mark(0);
    cp_async_wait_one();  // this step's gate inputs have landed
    __syncthreads();
    probe.mark(1);
    // the KS slices of every row summed in order, one row per thread
    for (int i = tid; i < GH; i += blockDim.x) {
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < kBsMaxSplits; ++k)
        if (k < KS) sum += part[(size_t)k * GH + i];
      gh_s[i] = sum;
    }
    __syncthreads();

    if (owner) {
      const T* g_in = g_s + (size_t)(t & 1) * GH + u;
      float gh[NG];
#pragma unroll
      for (int q = 0; q < NG; ++q) gh[q] = gh_s[q * H + u] + bh[q];
      probe.mark(2);
      const size_t row = ((size_t)t * B + b) * S + s;
      T* st = stash + row * 5 * H + u;
      const bool active = inside(s, t, n_steps, len);
      float hn, cn = 0.0f;
      if (LSTM) {
        const float ig = sigmoid(to_f(g_in[0]) + gh[0]);
        const float fg = sigmoid(to_f(g_in[H]) + gh[1]);
        const float gg = tanhf(to_f(g_in[2 * H]) + gh[2]);
        const float og = sigmoid(to_f(g_in[3 * H]) + gh[3]);
        cn = fg * c + ig * gg;
        hn = og * tanhf(cn);
        st[0] = from_f<T>(ig);
        st[H] = from_f<T>(fg);
        st[2 * H] = from_f<T>(gg);
        st[3 * H] = from_f<T>(og);
        st[4 * H] = from_f<T>(c);
      } else {
        const float r = sigmoid(to_f(g_in[0]) + gh[0]);
        const float z = sigmoid(to_f(g_in[H]) + gh[1]);
        const float n = tanhf(to_f(g_in[2 * H]) + r * gh[2]);
        hn = (1.0f - z) * n + z * h;
        st[0] = from_f<T>(r);
        st[H] = from_f<T>(z);
        st[2 * H] = from_f<T>(n);
        st[3 * H] = from_f<T>(gh[2]);
        st[4 * H] = from_f<T>(h);
      }
      if (active) {
        h = hn;
        if (LSTM) c = cn;
      }
      probe.mark(3);
      a.y[row * H + u] = h;
      hq_s[u] = round_to<T>(h);
      probe.mark(4);
    }
    __syncthreads();
    probe.mark(5);
  }
  probe.finish();
}

template <typename T, bool LSTM, int U>
__global__ void __launch_bounds__(kThreads) train_bwd_kernel(BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  constexpr int NG = LSTM ? 4 : 3;
  const T* __restrict__ stash = static_cast<const T*>(a.stash);
  const T* __restrict__ w_hh = static_cast<const T*>(a.w_hh);
  T* __restrict__ dgi = static_cast<T*>(a.dgi);
  T* __restrict__ dgh = static_cast<T*>(a.dgh);
  const int n_steps = a.n_steps, B = a.B, S = a.S, H = a.H;
  const int GH = NG * H;
  const int blocks_per_stream = H / U;
  const int s = blockIdx.x / blocks_per_stream;
  const int u0 = (blockIdx.x % blocks_per_stream) * U;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int GS = bwd_splits(B);
  const int gc = (GH + GS - 1) / GS;

  extern __shared__ __align__(16) unsigned char smem[];
  T* wc_s = reinterpret_cast<T*>(smem);  // (U, GH): column u0+u of W_hh
  float* part = reinterpret_cast<float*>(smem + align16(sizeof(T) * U * GH));
  float* dh_s = part + (size_t)B * GS * U;  // (B, U) carried dh
  float* base_s = dh_s + B * U;             // (B, U) dh_prev minus product
  float* dc_s = base_s + B * U;             // (B, U) carried dc (LSTM)

  for (int i = tid; i < U * GH; i += kThreads) {
    const int u = i / GH, g = i % GH;
    wc_s[i] = w_hh[((size_t)s * GH + g) * H + u0 + u];
  }
  for (int i = tid; i < B * U; i += kThreads) {
    dh_s[i] = 0.0f;
    dc_s[i] = 0.0f;
  }
  __syncthreads();

  const size_t xbuf_stride = (size_t)S * B * GH;
  for (int k = 0; k < n_steps; ++k) {
    const int t = n_steps - 1 - k;
    float* x = a.xbuf + (k & 1) * xbuf_stride + (size_t)s * B * GH;

    // (A) gate gradients of the block's units
    for (int i = tid; i < B * U; i += kThreads) {
      const int b = i / U, u = i % U, unit = u0 + u;
      const size_t row = ((size_t)t * B + b) * S + s;
      const bool active = inside(s, t, n_steps, a.lengths[b]);
      const float dh = dh_s[i] + a.dy[row * H + unit];
      const T* st = stash + row * 5 * H + unit;
      T* d_in = dgi + row * GH + unit;
      float* xo = x + (size_t)b * GH + unit;
      if (LSTM) {
        const float ig = to_f(st[0]), fg = to_f(st[H]), gg = to_f(st[2 * H]);
        const float og = to_f(st[3 * H]), cp = to_f(st[4 * H]);
        const float tc = tanhf(fg * cp + ig * gg);
        const float dct = dh * og * (1.0f - tc * tc) + dc_s[i];
        float d[4] = {dct * gg * ig * (1.0f - ig),
                      dct * cp * fg * (1.0f - fg),
                      dct * ig * (1.0f - gg * gg),
                      dh * tc * og * (1.0f - og)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (!active) d[q] = 0.0f;
          d_in[q * H] = from_f<T>(d[q]);
          xo[q * H] = round_to<T>(d[q]);
        }
        if (active) dc_s[i] = dct * fg;
        base_s[i] = active ? 0.0f : dh;
      } else {
        const float r = to_f(st[0]), z = to_f(st[H]), n = to_f(st[2 * H]);
        const float ghn = to_f(st[3 * H]), hp = to_f(st[4 * H]);
        const float dpre_n = dh * (1.0f - z) * (1.0f - n * n);
        const float dpre_r = dpre_n * ghn * r * (1.0f - r);
        const float dpre_z = dh * (hp - n) * z * (1.0f - z);
        float di[3] = {dpre_r, dpre_z, dpre_n};
        float dg[3] = {dpre_r, dpre_z, dpre_n * r};
        T* d_h = dgh + row * GH + unit;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          if (!active) di[q] = dg[q] = 0.0f;
          d_in[q * H] = from_f<T>(di[q]);
          d_h[q * H] = from_f<T>(dg[q]);
          xo[q * H] = round_to<T>(dg[q]);
        }
        base_s[i] = active ? dh * z : dh;
      }
    }
    grid.sync();

    // (B) dh_prev of the block's units: its stream's whole exchange vector
    // against the resident columns (the L2-bound hot spot, see above)
    for (int item = warp; item < B * GS; item += kWarps) {
      const int b = item / GS, gs = item % GS;
      const int g0 = gs * gc, g1 = min(GH, g0 + gc);
      const float* xb = x + (size_t)b * GH;
      float acc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) acc[u] = 0.0f;
#pragma unroll 4
      for (int g = g0 + lane; g < g1; g += 32) {
        const float xv = __ldcg(xb + g);
#pragma unroll
        for (int u = 0; u < U; ++u)
          acc[u] = fmaf(xv, to_f(wc_s[u * GH + g]), acc[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float v = warp_sum(acc[u]);
        if (lane == 0) part[(size_t)item * U + u] = v;
      }
    }
    __syncthreads();
    for (int i = tid; i < B * U; i += kThreads) {
      const int b = i / U, u = i % U;
      float prod = 0.0f;
      for (int gs = 0; gs < GS; ++gs) prod += part[((size_t)b * GS + gs) * U + u];
      dh_s[i] = base_s[i] + prod;
    }
    __syncthreads();
  }
}

template <typename Kernel>
cudaError_t cooperative_launch(Kernel kernel, void* args, int grid,
                               size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm * n_sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  void* kargs[] = {args};
  err = cudaLaunchCooperativeKernel((void*)kernel, grid, kThreads, kargs,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool LSTM, int U>
cudaError_t launch_fwd(FwdArgs a, cudaStream_t stream) {
  constexpr int NG = LSTM ? 4 : 3;
  const size_t smem =
      align16(sizeof(T) * NG * U * a.H) +
      sizeof(float) * ((size_t)n_bgroups(a.B) * kBT * a.H +
                       (size_t)n_bgroups(a.B) * fwd_splits(a.B) * kBT * NG * U +
                       (size_t)a.B * U);
  return cooperative_launch(train_fwd_kernel<T, LSTM, U>, &a,
                            a.S * (a.H / U), smem, stream);
}

// threads and shared memory of the batch-split path; mirrored by
// kernels/birnn_train.py:_bs_size
__host__ __forceinline__ int bs_threads(int NG, int H, int KS) {
  const int n = std::max(NG * H / kBsRows * KS, H);
  return (n + 31) / 32 * 32;
}
__host__ __forceinline__ size_t bs_smem(int NG, int H, int KS, size_t item) {
  return item * NG * H * H +
         sizeof(float) * ((size_t)H + (size_t)(KS + 1) * NG * H) +
         item * 2 * NG * H;
}

template <typename T, bool LSTM>
cudaError_t launch_fwd_bs(FwdArgs a, int KS, cudaStream_t stream) {
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int VEC = 16 / sizeof(T);
  if (KS <= 0 || KS > kBsMaxSplits || a.H % VEC != 0 ||
      (a.H / VEC) % KS != 0)
    return cudaErrorInvalidValue;
  const int threads = bs_threads(NG, a.H, KS);
  if (threads > kBsMaxThreads) return cudaErrorInvalidValue;
  const size_t smem = bs_smem(NG, a.H, KS, sizeof(T));
  auto kernel = train_fwd_bs_kernel<T, LSTM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = a.S * a.B;
  kernel<<<grid, threads, smem, stream>>>(a, KS);
  return cudaGetLastError();
}

template <typename T, bool LSTM, int U>
cudaError_t launch_bwd(BwdArgs a, cudaStream_t stream) {
  constexpr int NG = LSTM ? 4 : 3;
  const size_t smem = align16(sizeof(T) * U * NG * a.H) +
                      sizeof(float) * ((size_t)a.B * bwd_splits(a.B) * U +
                                       3 * (size_t)a.B * U);
  return cooperative_launch(train_bwd_kernel<T, LSTM, U>, &a,
                            a.S * (a.H / U), smem, stream);
}

template <typename T, bool LSTM>
cudaError_t fwd_u(int U, const FwdArgs& a, cudaStream_t st) {
  switch (U) {
    case 1: return launch_fwd<T, LSTM, 1>(a, st);
    case 2: return launch_fwd<T, LSTM, 2>(a, st);
    case 4: return launch_fwd<T, LSTM, 4>(a, st);
    case 8: return launch_fwd<T, LSTM, 8>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool LSTM>
cudaError_t bwd_u(int U, const BwdArgs& a, cudaStream_t st) {
  switch (U) {
    case 1: return launch_bwd<T, LSTM, 1>(a, st);
    case 2: return launch_bwd<T, LSTM, 2>(a, st);
    case 4: return launch_bwd<T, LSTM, 4>(a, st);
    case 8: return launch_bwd<T, LSTM, 8>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int lstm, int n_steps, int B, int S, int H, int U) {
  return U <= 0 || H % U != 0 || B <= 0 || S <= 0 || n_steps <= 0 ||
         (lstm != 0 && lstm != 1);
}

}  // namespace

extern "C" {

int ftt_birnn_train_fwd(int lstm, int bf16, const void* gi, const void* w_hh,
                        const float* b_hh, const int* lengths, float* y,
                        void* stash, float* hbuf, int n_steps, int B, int S,
                        int H, int U, void* stream) {
  if (bad_shape(lstm, n_steps, B, S, H, U)) return (int)cudaErrorInvalidValue;
  const FwdArgs a{gi, w_hh, b_hh, lengths, y, stash, hbuf, n_steps, B, S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = lstm ? fwd_u<__nv_bfloat16, true>(U, a, st)
               : fwd_u<__nv_bfloat16, false>(U, a, st);
  else
    err = lstm ? fwd_u<float, true>(U, a, st) : fwd_u<float, false>(U, a, st);
  return (int)err;
}

// Batch-split forward (no hbuf): KS k-splits of the product.
int ftt_birnn_train_fwd_bs(int lstm, int bf16, const void* gi,
                           const void* w_hh, const float* b_hh,
                           const int* lengths, float* y, void* stash,
                           int n_steps, int B, int S, int H, int KS,
                           void* stream) {
  if (bad_shape(lstm, n_steps, B, S, H, 1)) return (int)cudaErrorInvalidValue;
  const FwdArgs a{gi, w_hh, b_hh, lengths, y, stash, nullptr,
                  n_steps, B, S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = lstm ? launch_fwd_bs<__nv_bfloat16, true>(a, KS, st)
               : launch_fwd_bs<__nv_bfloat16, false>(a, KS, st);
  else
    err = lstm ? launch_fwd_bs<float, true>(a, KS, st)
               : launch_fwd_bs<float, false>(a, KS, st);
  return (int)err;
}

int ftt_birnn_train_bwd(int lstm, int bf16, const void* stash,
                        const float* dy, const void* w_hh, const int* lengths,
                        void* dgi, void* dgh, float* xbuf, int n_steps, int B,
                        int S, int H, int U, void* stream) {
  if (bad_shape(lstm, n_steps, B, S, H, U) || (!lstm && dgh == nullptr))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{stash, dy, w_hh, lengths, dgi, dgh, xbuf, n_steps, B, S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = lstm ? bwd_u<__nv_bfloat16, true>(U, a, st)
               : bwd_u<__nv_bfloat16, false>(U, a, st);
  else
    err = lstm ? bwd_u<float, true>(U, a, st) : bwd_u<float, false>(U, a, st);
  return (int)err;
}

const char* ftt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
