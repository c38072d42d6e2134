// Bidirectional GRU/LSTM recurrence of inference (kernel #1). Replaces the
// Pallas TPU kernel forwardtacotron_tpu/kernels/birnn.py:_kernel, reached
// through _pallas_birnn (:128) -> pl.pallas_call (:139).
//
// S streams (2 directions x G groups) advance together; odd streams walk
// time-reversed input, so every stream uses step index t. A stream is
// inside its sequence at step t iff t < len (even) or t >= n_steps - len
// (odd); outside it h and c hold.
//
// What bounds it: the chain of n_steps dependent steps. A step is a
// (B, H) x (H, NG*H) product per stream, then the gate math; at batch 1
// the bytes (gi, W_hh, y: 5 us at the decoder) and the operations are far
// below what the chain of T steps costs, each step a fixed sequence of
// product, exchange of h and barrier. Each path cuts that fixed cost.
//
// Stream-local path (ftt_birnn_sl_launch), for every shape where a stream's
// W_hh fits C blocks (C up to 16, chosen by kernels/birnn.py:
// inference_plan): one cluster of C blocks per (stream, batch lane),
// launched with no cooperative grid and no grid barrier, since streams and
// lanes are independent; where the card holds fewer clusters at once than
// there are, they run in waves. The cluster's
// blocks split the stream's NG*H rows of W_hh by units: block r owns units
// [r*U, (r+1)*U), U = H/C, and keeps its NG*U rows resident for the whole
// walk, the first chunks of each thread's rows in registers and the rest
// in shared memory (the product layout of csrc/birnn_step.cuh, shared with
// kernel #2's batch-split forward). Per step:
//   product: thread (g, ks) multiplies its rows against k-slice ks of the
//     rounded h in its own shared memory, partial sums to shared memory;
//   row sums: one thread a row adds its KS partials in order;
//   gate math: U owner threads form their units' new state from the NG
//     row sums and the gate inputs that cp.async brought during the
//     previous step, store y without waiting, and store h, rounded to T,
//     into the block's h vector for the next step (double-buffered by step
//     parity);
//   exchange: the block's threads push those U values, 16 bytes a store,
//     into the same place in every peer's shared memory
//     (st.shared::cluster); at C=1 there is nothing to push;
//   barrier: one cluster barrier (arrive.release / wait.acquire), or
//     __syncthreads at C=1. It also orders the buffers: a block pushes into
//     buffer (k+1)&1 at step k only after every block of its cluster passed
//     the barrier of step k-1, that is finished reading that buffer.
// The product runs on the CUDA cores (FmaProduct). A tensor-core product
// (csrc/birnn_sl_mma.cu, built by the probe only) measured slower at every
// serving shape (PERF.md, PR 5).
// A cluster barrier before the walk makes every block's h vector zero
// before a peer may push into it; the barrier of the last step comes after
// the last remote store, so no block exits while a peer can still store
// into it. Only the steps inside the lane's sequence are walked (they are
// contiguous); y outside them is the held state, written at the end.
//
// Cooperative path (ftt_birnn_launch), for a stream whose W_hh fits no
// cluster of the stream-local layout (U not a whole number of 16-byte
// chunks, or a share too large for 16 blocks); the stream-local path, in
// waves where needed, measured faster at every shape of the serving path
// and of evaluate() (PERF.md, PR 5). One persistent cooperative kernel for
// the whole sequence.
// Block j owns U hidden units of one stream and keeps their NG*U rows of
// W_hh in shared memory; the LSTM cell state of its units
// stays in shared memory too. h goes through global memory (L2),
// double-buffered, with one grid barrier per step: at step t every block
// reads buffer t&1 and writes buffer (t+1)&1, and the barrier after step
// t-1 guarantees that no block still reads the buffer being written.
// Reads of h use ld.global.cg (L2, not the non-coherent L1), since other
// SMs wrote it.
//
// Precision, on both paths: weights and input gates in T (float or bf16);
// the hidden state is float32 and is rounded to T before the product;
// products accumulate in float32; gate math is float32.
//
// Plain C interface (bound with ctypes): each launcher returns a
// cudaError_t; 0 means the launch was accepted.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "birnn_step.cuh"
#include "cluster.cuh"
#include "probe.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 32;

constexpr int kSlRows = 4;          // W_hh rows per thread of its product
constexpr int kSlMaxThreads = 512;  // 128 registers a thread
constexpr int kSlMaxSplits = 16;    // k-slices of the product
constexpr int kSlMaxCluster = 16;   // above 8: a non-portable cluster size

__host__ __device__ __forceinline__ int k_splits(int B) {
  return B >= kWarps ? 1 : kWarps / B;
}

// ------------------------------------------------------- cooperative path

// UT > 0: U (units per block) known at compile time, so the row loops
// below have exact trip counts; UT == 0: U at run time.
template <typename T, bool LSTM, int UT>
__global__ void __launch_bounds__(kThreads)
birnn_kernel(const T* __restrict__ gi,         // (n_steps, B, S, NG*H)
             const T* __restrict__ w_hh,       // (S, NG*H, H)
             const float* __restrict__ b_hh,   // (S, NG*H)
             const int* __restrict__ lengths,  // (B)
             float* __restrict__ y,            // (n_steps, B, S, H)
             float* hbuf,                      // (2, S, B, H), zeroed
             int n_steps, int B, int S, int H, int U) {
  cg::grid_group grid = cg::this_grid();
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int RT = UT > 0 ? NG * UT : kMaxRows;
  if (UT > 0) U = UT;
  const int GH = NG * H;
  const int R = NG * U;
  const int blocks_per_stream = H / U;
  const int s = blockIdx.x / blocks_per_stream;
  const int u0 = (blockIdx.x % blocks_per_stream) * U;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int KS = k_splits(B);
  const int kc = (H + KS - 1) / KS;

  extern __shared__ __align__(16) unsigned char smem[];
  T* w_s = reinterpret_cast<T*>(smem);  // row q*U+u: gate q of unit u0+u
  float* part = reinterpret_cast<float*>(smem + align16(sizeof(T) * R * H));
  float* c_s = part + B * KS * R;       // (B, U) LSTM cell state

  for (int i = tid; i < R * H; i += kThreads) {
    const int row = i / H, k = i % H;
    const int q = row / U, u = row % U;
    w_s[i] = w_hh[((size_t)s * GH + q * H + u0 + u) * H + k];
  }
  for (int i = tid; i < B * U; i += kThreads) c_s[i] = 0.0f;
  __syncthreads();

  // probe phases: 0 product, 1 gate math and stores, 2 grid barrier
  Probe probe;
  const size_t buf_stride = (size_t)S * B * H;
  for (int t = 0; t < n_steps; ++t) {
    const float* h_prev = hbuf + (t & 1) * buf_stride + (size_t)s * B * H;
    float* h_next = hbuf + ((t + 1) & 1) * buf_stride + (size_t)s * B * H;

    // partial products: work item (lane b, k-slice ks) per warp
    for (int item = warp; item < B * KS; item += kWarps) {
      const int b = item / KS, ks = item % KS;
      const int k0 = ks * kc, k1 = min(H, k0 + kc);
      float acc[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = 0.0f;
      for (int k = k0 + lane; k < k1; k += 32) {
        const float hv = round_to<T>(__ldcg(h_prev + (size_t)b * H + k));
#pragma unroll
        for (int r = 0; r < RT; ++r)
          if (UT > 0 || r < R)
            acc[r] = fmaf(hv, to_f(w_s[r * H + k]), acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (UT > 0 || r < R) {
          const float v = warp_sum(acc[r]);
          if (lane == 0) part[item * R + r] = v;
        }
      }
    }
    __syncthreads();
    probe.mark(0);

    // cell update of the block's units
    for (int i = tid; i < B * U; i += kThreads) {
      const int b = i / U, u = i % U, unit = u0 + u;
      const T* g_in = gi + (((size_t)t * B + b) * S + s) * GH;
      float gh[NG];
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        float acc = 0.0f;
        for (int ks = 0; ks < KS; ++ks)
          acc += part[(b * KS + ks) * R + q * U + u];
        gh[q] = acc + b_hh[(size_t)s * GH + q * H + unit];
      }
      const float hp = __ldcg(h_prev + (size_t)b * H + unit);
      float cn;
      float hn = cell_step<T, LSTM, false>(g_in + unit, H, gh, hp, c_s[i],
                                           cn, nullptr, 0);
      const bool active = inside(s, t, n_steps, lengths[b]);
      if (!active) hn = hp;
      if (LSTM && active) c_s[i] = cn;
      h_next[(size_t)b * H + unit] = hn;
      y[(((size_t)t * B + b) * S + s) * H + unit] = hn;
    }
    probe.mark(1);
    grid.sync();
    probe.mark(2);
  }
  probe.finish();
}

template <typename T, bool LSTM>
cudaError_t launch(const void* gi, const void* w_hh, const float* b_hh,
                   const int* lengths, float* y, float* hbuf, int n_steps,
                   int B, int S, int H, int U, cudaStream_t stream) {
  auto kernel = U == 4   ? birnn_kernel<T, LSTM, 4>
                : U == 8 ? birnn_kernel<T, LSTM, 8>
                         : birnn_kernel<T, LSTM, 0>;
  const int NG = LSTM ? 4 : 3;
  const int R = NG * U;
  const size_t smem = align16(sizeof(T) * R * H) +
                      sizeof(float) * ((size_t)B * k_splits(B) * R + B * U);
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
  const int grid = S * (H / U);
  if (per_sm * n_sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  const T* gi_t = static_cast<const T*>(gi);
  const T* w_t = static_cast<const T*>(w_hh);
  void* args[] = {(void*)&gi_t, (void*)&w_t, (void*)&b_hh, (void*)&lengths,
                  (void*)&y, (void*)&hbuf, (void*)&n_steps, (void*)&B,
                  (void*)&S, (void*)&H, (void*)&U};
  err = cudaLaunchCooperativeKernel((void*)kernel, grid, kThreads, args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ------------------------------------------------------ stream-local path

struct SlArgs {
  const void* gi;        // (n_steps, B, S, NG*H) T
  const void* w_hh;      // (S, NG*H, H) T
  const float* b_hh;     // (S, NG*H)
  const int* lengths;    // (B)
  float* y;              // (n_steps, B, S, H)
  int n_steps, B, S, H;
  int C;                 // blocks of a cluster: one cluster per (s, b)
  int KS;                // k-slices of the product
};

// Threads and shared-memory bytes of a stream-local block, 0 threads where
// the shape is not one the kernel takes; mirrored by
// kernels/birnn.py:_sl_size. Thread (g, ks) holds rows g + r*NR (r <
// kSlRows) over k-slice ks, the first sl_reg_chunks(item) 16-byte chunks
// of each row in registers. Shared memory: the W_hh share outside
// registers, the KS partial sums of every row, h rounded to T (two
// buffers), and two steps of the block's gate inputs. In float32, 4 chunks
// a row make the kernel spill 20-24 bytes at the 128 registers a thread
// that 512 threads leave; 3 chunks (still spilling) and 2 (no spill, 104
// registers) measured 2-8% slower (PERF.md, PR 5), so the spill stays.
__host__ __device__ constexpr int sl_reg_chunks(size_t item) {
  return item == 4 ? 4 : 2;
}

__host__ __forceinline__ void sl_size(int NG, int H, int C, int KS,
                                      size_t item, int* threads,
                                      size_t* smem) {
  const int vec = (int)(16 / item);
  *threads = 0;
  *smem = 0;
  if (C < 1 || C > kSlMaxCluster || (C & (C - 1)) || H % C != 0 ||
      KS < 1 || KS > kSlMaxSplits)
    return;
  const int U = H / C, R = NG * U;
  const int NC = H / vec;
  if (U % vec != 0 || NC % KS != 0) return;
  const int nc = NC / KS;
  const int n = std::max(R / kSlRows * KS, U);
  if (n > kSlMaxThreads) return;
  *threads = (n + 31) / 32 * 32;
  *smem = (size_t)16 * R * KS * (nc - std::min(sl_reg_chunks(item), nc)) +
          sizeof(float) * ((size_t)KS * R + 2 * (size_t)H) + item * 2 * R;
}

// The block's product on the CUDA cores: thread (g, ks) multiplies rows
// g + r*NR against k-slice ks of h (csrc/birnn_step.cuh's layout; the
// chunks outside registers at w_s[(ks*ns + cc - REG)*R + row]).
template <typename T>
struct FmaProduct {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int REG = sl_reg_chunks(sizeof(T));
  int R, NR, nc, ns, g, ks;
  bool on;
  size_t w_bytes;  // of shared memory
  const uint4* w_mine;
  uint4 w_reg[REG][kSlRows];

  // w_row(row): the block's row `row` of W_hh in global memory
  template <typename WRow>
  __device__ __forceinline__ void load(uint4* w_s, WRow w_row, int R_, int H,
                                       int KS) {
    auto w = [&](int row, int chunk) {
      return *reinterpret_cast<const uint4*>(w_row(row) + chunk * VEC);
    };
    R = R_;
    NR = R / kSlRows;
    nc = H / VEC / KS;
    ns = nc - min(REG, nc);
    g = threadIdx.x % NR;
    ks = threadIdx.x / NR;
    on = threadIdx.x < NR * KS;
    w_bytes = (size_t)16 * R * KS * ns;
    for (int i = threadIdx.x; i < R * KS * ns; i += blockDim.x) {
      const int row = i % R, j = i / R;
      w_s[i] = w(row, (j / ns) * nc + REG + j % ns);
    }
#pragma unroll
    for (int cc = 0; cc < REG; ++cc)
#pragma unroll
      for (int r = 0; r < kSlRows; ++r)
        w_reg[cc][r] = on && cc < nc ? w(g + r * NR, ks * nc + cc)
                                     : make_uint4(0, 0, 0, 0);
    w_mine = w_s + (size_t)ks * ns * R + g;
  }

  // part[ks*R + row]: k-slice ks's share of every row . h
  __device__ __forceinline__ void run(const float* h, float* part) {
    if (!on) return;
    const uint4* wm = w_mine;
    const int stride = R, nr = NR;
    auto w_at = [&](int cc, int r) {
      return wm[(size_t)(cc - REG) * stride + r * nr];
    };
    float acc[kSlRows];
    rows_product<T>(acc, w_reg, w_at, h + ks * nc * VEC, nc);
#pragma unroll
    for (int r = 0; r < kSlRows; ++r) part[ks * R + g + r * NR] = acc[r];
  }
};

// P: the block's product (FmaProduct<T>; csrc/birnn_sl_mma.cu builds the
// kernel with another for the probe)
template <typename T, bool LSTM, typename P>
__global__ void __launch_bounds__(kSlMaxThreads) birnn_sl_kernel(SlArgs a) {
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int VEC = 16 / sizeof(T);
  const T* __restrict__ gi = static_cast<const T*>(a.gi);
  const int n_steps = a.n_steps, B = a.B, S = a.S, H = a.H, C = a.C,
            KS = a.KS;
  const int GH = NG * H, U = H / C, R = NG * U;
  const int cl = blockIdx.x / C;         // the cluster's (stream, lane)
  const int rank = C > 1 ? (int)cluster_rank() : 0;
  const int s = cl / B, b = cl % B;
  const int u0 = rank * U;
  const int tid = threadIdx.x;

  // local row q*U + u of W_hh is gate q of unit u0 + u
  const T* w_src = static_cast<const T*>(a.w_hh) + (size_t)s * GH * H;
  extern __shared__ __align__(16) unsigned char smem[];
  P product;
  product.load(reinterpret_cast<uint4*>(smem), [&](int row) {
    return w_src + (size_t)((row / U) * H + u0 + row % U) * H;
  }, R, H, KS);
  float* part = reinterpret_cast<float*>(smem + product.w_bytes);  // (KS, R)
  float* hq = part + (size_t)KS * R;            // (2, H) h rounded to T
  T* g_s = reinterpret_cast<T*>(hq + 2 * H);    // (2, R) gate inputs
  for (int i = tid; i < H; i += blockDim.x) hq[i] = 0.0f;

  // the steps inside the lane's sequence: [t0, t1)
  const int len = min(max(a.lengths[b], 0), n_steps);
  const int t0 = (s & 1) ? n_steps - len : 0;
  const int t1 = (s & 1) ? n_steps : len;

  // the gate inputs of the block's rows at local step k, 16 bytes a copy,
  // into buffer k&1 (an empty group past the last step keeps the count)
  const int cpg = U / VEC;  // copies per gate
  auto prefetch = [&](int k) {
    if (t0 + k < t1) {
      T* dst = g_s + (size_t)(k & 1) * R;
      const T* src = gi + (((size_t)(t0 + k) * B + b) * S + s) * GH + u0;
      for (int i = tid; i < NG * cpg; i += blockDim.x) {
        const int q = i / cpg, j = i % cpg;
        cp_async16(dst + q * U + j * VEC, src + (size_t)q * H + j * VEC);
      }
    }
    cp_async_commit();
  };
  prefetch(0);

  // the unit this thread updates, and its state, kept in registers
  const int u = tid;
  const bool owner = tid < U;
  float bh[NG];
#pragma unroll
  for (int q = 0; q < NG; ++q)
    bh[q] = owner ? a.b_hh[(size_t)s * GH + q * H + u0 + u] : 0.0f;
  float h = 0.0f, c = 0.0f;
  float* y = a.y + ((size_t)b * S + s) * H + u0 + u;  // + t*B*S*H
  const size_t y_step = (size_t)B * S * H;
  // every block's weights and zero h are in place before any push
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  // probe phases: 0 product, 1 row sums (with the waits before and after),
  // 2 gate math, 3 exchange (stores of y, pushes of h), 4 barrier
  Probe probe;
  for (int k = 0; t0 + k < t1; ++k) {
    const int p = k & 1;
    prefetch(k + 1);
    product.run(hq + p * H, part);
    probe.mark(0);
    cp_async_wait_one();  // this step's gate inputs have landed
    __syncthreads();
    // the KS slices of every row summed in order into slice 0, one row a
    // thread, so that an owner reads NG sums, not NG*KS partials
    for (int i = tid; i < R; i += blockDim.x) {
      float sum = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kSlMaxSplits; ++kk)
        if (kk < KS) sum += part[kk * R + i];
      part[i] = sum;
    }
    __syncthreads();
    probe.mark(1);
    float* h_next = hq + (p ^ 1) * H;
    if (owner) {
      float gh[NG];
#pragma unroll
      for (int q = 0; q < NG; ++q) gh[q] = part[q * U + u] + bh[q];
      float cn;
      h = cell_step<T, LSTM, false>(g_s + p * R + u, U, gh, h, c, cn,
                                    nullptr, 0);
      c = cn;
      probe.mark(2);
      y[(size_t)(t0 + k) * y_step] = h;
      h_next[u0 + u] = round_to<T>(h);
    }
    if (C > 1) {
      // the block's U new values, 16 bytes a store, into every peer
      __syncthreads();
      const int n4 = U / 4;
      for (int i = tid; i < (C - 1) * n4; i += blockDim.x) {
        const int peer = (rank + 1 + i / n4) % C, j = u0 + 4 * (i % n4);
        st_cluster(map_rank(h_next + j, peer),
                   *reinterpret_cast<const float4*>(h_next + j));
      }
      probe.mark(3);
      cluster_arrive();
      cluster_wait();
    } else {
      probe.mark(3);
      __syncthreads();
    }
    probe.mark(4);
  }
  // outside the sequence the state holds: zero before a reversed stream's
  // first step, the last h after a forward stream's last
  if (owner) {
    for (int t = 0; t < t0; ++t) y[(size_t)t * y_step] = 0.0f;
    for (int t = t1; t < n_steps; ++t) y[(size_t)t * y_step] = h;
  }
  probe.finish();
}

// A stream-local variant: compute type, cell, the block's product
template <typename T_, bool LSTM_, typename P_ = FmaProduct<T_>>
struct SlVariant {
  using T = T_;
  using P = P_;
  static constexpr bool LSTM = LSTM_;
};

// f(SlVariant<...>{}) for the variant of the flags
template <typename F>
cudaError_t with_variant(int lstm, int bf16, F f) {
  using bf = __nv_bfloat16;
  if (!bf16)
    return lstm ? f(SlVariant<float, true>{}) : f(SlVariant<float, false>{});
  return lstm ? f(SlVariant<bf, true>{}) : f(SlVariant<bf, false>{});
}

// The stream-local launch configuration of `a` with blocks of `threads`
// threads and `smem` bytes: grid S*B*C, clusters of C; *resident, unless
// null, gets the number of such clusters the card holds at once.
template <typename V>
cudaError_t sl_config(const SlArgs& a, int threads, size_t smem,
                      cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                      int* resident) {
  auto kernel = birnn_sl_kernel<typename V::T, V::LSTM, typename V::P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (a.C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = {};
  cfg.gridDim = dim3(a.S * a.B * a.C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (resident == nullptr) return cudaSuccess;
  return cudaOccupancyMaxActiveClusters(resident, kernel, &cfg);
}

// Launches the S*B clusters, in waves where the card holds fewer at once
// (the clusters are independent); refuses a shape of which the card holds
// no cluster at all. The runtime's count of resident clusters is asked
// once per device and block shape: the query costs host time enough to
// show at every launch.
template <typename V>
cudaError_t launch_sl(const SlArgs& a, int threads, size_t smem,
                      cudaStream_t stream) {
  static std::mutex mutex;
  static std::map<std::tuple<int, int, int, int>, int> resident_of;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int resident = 0;
  {
    std::lock_guard<std::mutex> lock(mutex);
    const auto key = std::make_tuple(dev, a.H, a.C, a.KS);
    const auto hit = resident_of.find(key);
    if (hit == resident_of.end()) {
      err = sl_config<V>(a, threads, smem, cfg, attr, &resident);
      if (err != cudaSuccess) return err;
      resident_of[key] = resident;
    } else {
      resident = hit->second;
      err = sl_config<V>(a, threads, smem, cfg, attr, nullptr);
      if (err != cudaSuccess) return err;
    }
  }
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (a.C == 1) cfg.numAttrs = 0;  // a plain launch: no cluster barrier
  cfg.stream = stream;
  err = cudaLaunchKernelEx(
      &cfg, birnn_sl_kernel<typename V::T, V::LSTM, typename V::P>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool bad_shape(int lstm, int n_steps, int B, int S) {
  return B <= 0 || S <= 0 || n_steps <= 0 || (lstm != 0 && lstm != 1);
}

}  // namespace

extern "C" {

int ftt_birnn_launch(int lstm, int bf16, const void* gi, const void* w_hh,
                     const float* b_hh, const int* lengths, float* y,
                     float* hbuf, int n_steps, int B, int S, int H, int U,
                     void* stream) {
  if (U <= 0 || H % U != 0 || (lstm ? 4 : 3) * U > kMaxRows ||
      bad_shape(lstm, n_steps, B, S))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = lstm ? launch<__nv_bfloat16, true>(gi, w_hh, b_hh, lengths, y, hbuf,
                                             n_steps, B, S, H, U, st)
               : launch<__nv_bfloat16, false>(gi, w_hh, b_hh, lengths, y,
                                              hbuf, n_steps, B, S, H, U, st);
  } else {
    err = lstm ? launch<float, true>(gi, w_hh, b_hh, lengths, y, hbuf,
                                     n_steps, B, S, H, U, st)
               : launch<float, false>(gi, w_hh, b_hh, lengths, y, hbuf,
                                      n_steps, B, S, H, U, st);
  }
  return (int)err;
}

// Stream-local path: one cluster of C blocks per (stream, lane), KS
// k-slices of the product.
int ftt_birnn_sl_launch(int lstm, int bf16, const void* gi, const void* w_hh,
                        const float* b_hh, const int* lengths, float* y,
                        int n_steps, int B, int S, int H, int C, int KS,
                        void* stream) {
  if (bad_shape(lstm, n_steps, B, S)) return (int)cudaErrorInvalidValue;
  int threads;
  size_t smem;
  sl_size(lstm ? 4 : 3, H, C, KS, bf16 ? 2 : 4, &threads, &smem);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const SlArgs a{gi, w_hh, b_hh, lengths, y, n_steps, B, S, H, C, KS};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_variant(lstm, bf16, [&](auto v) {
    return launch_sl<decltype(v)>(a, threads, smem, st);
  });
}

// Threads and shared-memory bytes of a stream-local block as the launcher
// computes them (threads 0: a shape the kernel does not take), and how
// many clusters of C such blocks the card holds at once (resident; -1 where
// the shape is not taken, 0 where a block needs more shared memory than
// the card gives one). kernels/birnn.py mirrors the size formula.
int ftt_birnn_sl_size(int lstm, int bf16, int H, int C, int KS,
                      int* threads, long long* smem, int* resident) {
  size_t bytes;
  sl_size(lstm ? 4 : 3, H, C, KS, bf16 ? 2 : 4, threads, &bytes);
  *smem = (long long)bytes;
  *resident = -1;
  if (*threads == 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  *resident = 0;
  if (bytes > (size_t)optin) return 0;  // no block of it fits an SM
  const SlArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, 1, H,
                 C, KS};
  return (int)with_variant(lstm, bf16, [&](auto v) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    return sl_config<decltype(v)>(a, *threads, bytes, cfg, attr, resident);
  });
}

const char* ftt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
