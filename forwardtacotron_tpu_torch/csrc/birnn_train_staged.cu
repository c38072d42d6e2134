// Kernel #3's cooperative backward as first designed for Hopper, kept to
// be timed against the one that csrc/birnn_train.cu ships: the gate
// gradients of a stream are exchanged whole through L2 and staged into
// every block's shared memory by bulk copies (TMA) multicast within
// thread-block clusters. Nothing in the package calls it;
// tools/torch_kernel_probe.py (--only train_bwd) builds it as a library of
// its own and times it, by phase with --phases, beside the shipped path
// on the same inputs, after checking it against that path's results.
//
// Block j owns U units of a stream and keeps the U columns of W_hh for its
// units in registers (thread i: rows 16 bytes at a time, i and i + 256).
// Per step it (A) forms the gate gradients of its units from the stash and
// dy (loaded during the previous step, before its grid barrier), writes
// dgi/dgh and, in T, the exchange rows (B x NG*H) of the lanes inside
// their sequence; one grid barrier; then (B) the stream's exchange arrives
// in shared memory in chunks of kStgLanes lanes, one bulk copy per row
// against an mbarrier, in up to kStgMaxBufs buffers so that the product of
// one chunk overlaps the copies of the next. The blocks run in clusters of
// up to kStgMaxCluster blocks of one stream, the largest of which the
// whole grid is resident, and each row is multicast to every block of its
// cluster (csrc/cluster.cuh), so L2 serves it once per cluster; masked
// lanes are neither copied nor multiplied. A thread multiplies its rows of
// every lane of a chunk against its columns in float32 on the CUDA cores,
// a warp's sums are spread over its lanes by xor shuffles, and
// kStgLanes*U threads add the warps' sums in a fixed order. The exchange
// is double-buffered by step, so one grid barrier per step suffices.
// What it measured on the card, against the shipped design: PERF.md.

#include "birnn_train.cu"
#include "cluster.cuh"

namespace {

constexpr int kStgLanes = 8;       // batch lanes of a staged chunk
constexpr int kStgMaxBufs = 4;     // staging buffers
constexpr int kStgMaxCluster = 4;  // blocks sharing one multicast copy

// groups of 16 bytes of W_hh rows a thread keeps in registers (8 rows of
// float, 8 of bf16: NG*H <= 2048)
template <typename T>
__host__ __device__ constexpr int stg_groups() {
  return sizeof(T) == 4 ? 2 : 1;
}

// one bulk copy from global memory into this block's shared memory, the
// barrier counting its bytes
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Sums v[0..N) of every thread of the warp over the warp and leaves the
// totals spread over its lanes: at each halving a lane keeps one half of
// its values and adds its partner's copy of that half, so a lane ends with
// max(N/32, 1) totals, those of outputs base.. (lanes that share an output
// when N < 32 hold the same total). The order of the sums is fixed.
template <int N, int OFF>
__device__ __forceinline__ void scatter_sum(float* v, int lane, int& base) {
  if constexpr (N > 1) {
    constexpr int half = N / 2;
    const bool up = lane & OFF;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    if (up) base += half;
    if constexpr (OFF > 1) scatter_sum<half, OFF / 2>(v, lane, base);
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
    if constexpr (OFF > 1) scatter_sum<1, OFF / 2>(v, lane, base);
  }
}

// xbuf: (2, S, B, NG*H) in T, the exchange rows by step parity
template <typename T, bool LSTM, int U>
__global__ void __launch_bounds__(kThreads, 1)
    staged_bwd_kernel(BwdArgs a, void* xbuf, int n_bufs, int cs) {
  cg::grid_group grid = cg::this_grid();
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int MG = stg_groups<T>();
  constexpr int V = kStgLanes * U;  // dh_prev values of a chunk
  const T* __restrict__ stash = static_cast<const T*>(a.stash);
  const T* __restrict__ w_hh = static_cast<const T*>(a.w_hh);
  T* __restrict__ dgi = static_cast<T*>(a.dgi);
  T* __restrict__ dgh = static_cast<T*>(a.dgh);
  const int n_steps = a.n_steps, B = a.B, S = a.S, H = a.H;
  const int GH = NG * H;
  const int s = blockIdx.x / (H / U);
  const int u0 = (blockIdx.x % (H / U)) * U;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_chunks = (B + kStgLanes - 1) / kStgLanes;
  const int n_items = B * U;
  const uint32_t row_bytes = GH * sizeof(T);
  const uint32_t rank = cs > 1 ? cluster_rank() : 0;

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // one per buffer
  T* stg = reinterpret_cast<T*>(smem + sizeof(uint64_t) * kStgMaxBufs);
  // stg: (n_bufs, kStgLanes, GH) staged exchange rows
  float* part =
      reinterpret_cast<float*>(stg + (size_t)n_bufs * kStgLanes * GH);
  // part: (2, kWarps, V) the warps' sums of a chunk, by chunk parity
  float* dh_s = part + 2 * kWarps * V;  // (B, U) carried dh
  float* base_s = dh_s + n_items;       // (B, U) dh_prev minus product
  float* dc_s = base_s + n_items;       // (B, U) carried dc (LSTM)
  int* len_s = reinterpret_cast<int*>(dc_s + n_items);

  // the block's W_hh columns at rows g = (tid + m*kThreads)*VEC + v
  float w_reg[MG][VEC][U];
#pragma unroll
  for (int m = 0; m < MG; ++m)
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int g = (tid + m * kThreads) * VEC + v;
#pragma unroll
      for (int u = 0; u < U; ++u)
        w_reg[m][v][u] =
            g < GH ? to_f(w_hh[((size_t)s * GH + g) * H + u0 + u]) : 0.0f;
    }
  for (int i = tid; i < n_items; i += kThreads) dh_s[i] = dc_s[i] = 0.0f;
  for (int i = tid; i < B; i += kThreads) len_s[i] = a.lengths[i];
  if (tid == 0)
    for (int p = 0; p < n_bufs; ++p) mbar_init(bars + p);
  __syncthreads();
  if (cs > 1) {  // every barrier of the cluster is ready before a copy
    cluster_arrive();
    cluster_wait();
  }

  // phase A's inputs of the next step, loaded before the grid barrier
  T pst[kAItems][5];
  float pdy[kAItems];
  auto load_a = [&](int k) {
    if (k >= n_steps) return;
    const int t = n_steps - 1 - k;
#pragma unroll
    for (int j = 0; j < kAItems; ++j) {
      const int i = tid + j * kThreads;
      if (i >= n_items) continue;
      const size_t row = ((size_t)t * B + i / U) * S + s;
      const int unit = u0 + i % U;
#pragma unroll
      for (int q = 0; q < 5; ++q) pst[j][q] = stash[row * 5 * H + q * H + unit];
      pdy[j] = a.dy[row * H + unit];
    }
  };
  load_a(0);

  uint32_t parity = 0;  // of each buffer's mbarrier
  // probe phases: 0 gate gradients (A), 1 grid barrier, 2 wait for the
  // staged chunk, 3 product and warp sums, 4 combine, 5 cluster barrier
  // and the next copy
  Probe probe;
  const size_t xstride = (size_t)S * B * GH;
  for (int k = 0; k < n_steps; ++k) {
    const int t = n_steps - 1 - k;
    T* x = static_cast<T*>(xbuf) + (k & 1) * xstride + (size_t)s * B * GH;

    // (A) gate gradients of the block's units; the exchange rows of the
    // lanes inside their sequence
    auto item = [&](int i, const float* sv, float dyv) {
      const int b = i / U, unit = u0 + i % U;
      const bool active = inside(s, t, n_steps, len_s[b]);
      float di[NG], dg[NG];
      base_s[i] = gate_grads<LSTM>(sv, dh_s[i] + dyv, dc_s[i], active, di, dg);
      const size_t row = ((size_t)t * B + b) * S + s;
      store_grads<T, LSTM>(dgi, dgh, row * GH + unit, H, di, dg);
      if (active)
#pragma unroll
        for (int q = 0; q < NG; ++q)
          x[(size_t)b * GH + q * H + unit] = from_f<T>(dg[q]);
    };
#pragma unroll
    for (int j = 0; j < kAItems; ++j) {
      const int i = tid + j * kThreads;
      if (i >= n_items) continue;
      float sv[5];
#pragma unroll
      for (int q = 0; q < 5; ++q) sv[q] = to_f(pst[j][q]);
      item(i, sv, pdy[j]);
    }
    for (int i = tid + kAItems * kThreads; i < n_items; i += kThreads) {
      const size_t row = ((size_t)t * B + i / U) * S + s;
      const int unit = u0 + i % U;
      float sv[5];
#pragma unroll
      for (int q = 0; q < 5; ++q)
        sv[q] = to_f(stash[row * 5 * H + q * H + unit]);
      item(i, sv, a.dy[row * H + unit]);
    }
    load_a(k + 1);
    probe.mark(0);
    grid.sync();
    probe.mark(1);

    // (B) dh_prev of the block's units, chunk by chunk of kStgLanes lanes
    auto live_of = [&](int ch) {  // lanes of chunk ch inside their sequence
      uint32_t live = 0;
#pragma unroll
      for (int j = 0; j < kStgLanes; ++j) {
        const int b = ch * kStgLanes + j;
        if (b < B && inside(s, t, n_steps, len_s[b])) live |= 1u << j;
      }
      return live;
    };
    // the live rows of chunk ch into buffer ch % n_bufs: the cluster's
    // blocks take turns, each row one bulk copy to every block
    auto issue = [&](int ch) {
      const int p = ch % n_bufs;
      const uint32_t live = live_of(ch);
      if (tid == 0) mbar_expect_tx(bars + p, __popc(live) * row_bytes);
      if (warp == 0 && lane < kStgLanes && (live >> lane & 1) &&
          (uint32_t)(__popc(live & ((1u << lane) - 1)) % cs) == rank) {
        fence_proxy_async();  // the rows other blocks stored before the
                              // grid barrier, seen by the copy
        T* dst = stg + ((size_t)p * kStgLanes + lane) * GH;
        const T* src = x + (size_t)(ch * kStgLanes + lane) * GH;
        if (cs > 1)
          bulk_multicast(dst, src, row_bytes, bars + p,
                         (uint16_t)((1u << cs) - 1));
        else
          bulk_copy(dst, src, row_bytes, bars + p);
      }
    };
    for (int ch = 0; ch < n_bufs && ch < n_chunks; ++ch) issue(ch);
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int p = ch % n_bufs;
      const uint32_t live = live_of(ch);
      mbar_wait(bars + p, parity >> p & 1);
      parity ^= 1u << p;
      probe.mark(2);
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.0f;
      const T* xs = stg + (size_t)p * kStgLanes * GH;
#pragma unroll
      for (int j = 0; j < kStgLanes; ++j) {
        if (!(live >> j & 1)) continue;
#pragma unroll
        for (int m = 0; m < MG; ++m) {
          const int grp = tid + m * kThreads;
          if (grp * VEC >= GH) continue;
          float xf[VEC];
          unpack16(*reinterpret_cast<const uint4*>(xs + (size_t)j * GH +
                                                   grp * VEC),
                   xf, T());
#pragma unroll
          for (int v = 0; v < VEC; ++v)
#pragma unroll
            for (int u = 0; u < U; ++u)
              acc[j * U + u] = fmaf(xf[v], w_reg[m][v][u], acc[j * U + u]);
        }
      }
      const bool reuse = ch + n_bufs < n_chunks;
      if (reuse && cs > 1) cluster_arrive_relaxed();  // done reading p
      int first = 0;
      scatter_sum<V, 16>(acc, lane, first);
      float* pw = part + ((size_t)(ch & 1) * kWarps + warp) * V;
      if (V >= 32) {
#pragma unroll
        for (int r = 0; r < (V >= 32 ? V / 32 : 1); ++r) pw[first + r] = acc[r];
      } else if (lane % (32 / V) == 0) {
        pw[first] = acc[0];
      }
      probe.mark(3);
      __syncthreads();
      if (tid < V) {  // the warps' sums in order; output tid = lane l, unit u
        const int b = ch * kStgLanes + tid / U;
        if (b < B) {
          float sum = 0.0f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            sum += part[((size_t)(ch & 1) * kWarps + w) * V + tid];
          const int i = b * U + tid % U;
          dh_s[i] = base_s[i] + sum;
        }
      }
      probe.mark(4);
      if (reuse) {
        if (cs > 1) cluster_wait();  // no block of the cluster reads p now
        issue(ch + n_bufs);
      }
      probe.mark(5);
    }
    __syncthreads();  // dh_s and base_s before the next step's phase A
  }
  if (cs > 1) {  // no copy into this block is in flight when it exits
    cluster_arrive();
    cluster_wait();
  }
  probe.finish();
}

// shared memory besides the staging buffers: the mbarriers, the warps'
// sums, dh, base and dc of the block's units and the lanes' lengths
__host__ __forceinline__ size_t staged_fixed(int B, int U) {
  return sizeof(uint64_t) * kStgMaxBufs +
         sizeof(float) *
             (2 * (size_t)kWarps * kStgLanes * U + 3 * (size_t)B * U) +
         sizeof(int) * (size_t)B;
}

// As many staging buffers as the chunks need and the shared memory holds,
// and the largest cluster (of one stream's blocks) of which the whole grid
// is resident. Fills cfg (grid, block, shared memory, cluster attribute).
template <typename T, bool LSTM, int U>
cudaError_t staged_layout(const BwdArgs& a, cudaLaunchConfig_t& cfg,
                          cudaLaunchAttribute* attrs, int* n_bufs, int* cs) {
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int VEC = 16 / sizeof(T);
  const int GH = NG * a.H;
  if (GH % VEC != 0 || GH > stg_groups<T>() * VEC * kThreads)
    return cudaErrorInvalidValue;
  auto kernel = staged_bwd_kernel<T, LSTM, U>;
  cudaError_t err;
  int dev = 0, smem_max = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t chunk = sizeof(T) * kStgLanes * GH;
  const size_t fixed = staged_fixed(a.B, U);
  if (fixed + chunk > (size_t)smem_max) return cudaErrorInvalidValue;
  const int n_chunks = (a.B + kStgLanes - 1) / kStgLanes;
  *n_bufs = std::min(
      {n_chunks, kStgMaxBufs, (int)(((size_t)smem_max - fixed) / chunk)});
  const size_t smem = fixed + *n_bufs * chunk;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cfg = {};
  cfg.gridDim = dim3(a.S * (a.H / U));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  err = max_resident_cluster(kernel, cfg, attrs, kStgMaxCluster, a.H / U,
                             cs);
  if (err != cudaSuccess) return err;
  return *cs < 1 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

// layout: null to launch, else out[0] buffers and out[1] cluster size
template <typename T, bool LSTM, int U>
cudaError_t staged_launch(BwdArgs a, void* xbuf, cudaStream_t stream,
                          int* layout) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  int n_bufs = 0, cs = 0;
  cudaError_t err = staged_layout<T, LSTM, U>(a, cfg, attrs, &n_bufs, &cs);
  if (layout != nullptr) {
    layout[0] = n_bufs;
    layout[1] = cs;
  }
  if (err != cudaSuccess || layout != nullptr) return err;
  cfg.stream = stream;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, staged_bwd_kernel<T, LSTM, U>, a, xbuf,
                           n_bufs, cs);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool LSTM>
cudaError_t staged_u(int U, const BwdArgs& a, void* xbuf, cudaStream_t st,
                     int* layout) {
  switch (U) {
    case 1: return staged_launch<T, LSTM, 1>(a, xbuf, st, layout);
    case 2: return staged_launch<T, LSTM, 2>(a, xbuf, st, layout);
    case 4: return staged_launch<T, LSTM, 4>(a, xbuf, st, layout);
    case 8: return staged_launch<T, LSTM, 8>(a, xbuf, st, layout);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The backward with a staged exchange, arguments as ftt_birnn_train_bwd's
// but xbuf (2, S, B, NG*H) in the compute type. With layout non-null it
// launches nothing and writes the staging buffers and cluster size the
// launch would take (layout[0], layout[1]).
int ftt_birnn_train_bwd_staged(int lstm, int bf16, const void* stash,
                               const float* dy, const void* w_hh,
                               const int* lengths, void* dgi, void* dgh,
                               void* xbuf, int n_steps, int B, int S, int H,
                               int U, int* layout, void* stream) {
  if (bad_shape(lstm, n_steps, B, S, H, U) || (!lstm && dgh == nullptr))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{stash, dy, w_hh, lengths, dgi, dgh, nullptr,
                  n_steps, B, S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = lstm ? staged_u<__nv_bfloat16, true>(U, a, xbuf, st, layout)
               : staged_u<__nv_bfloat16, false>(U, a, xbuf, st, layout);
  else
    err = lstm ? staged_u<float, true>(U, a, xbuf, st, layout)
               : staged_u<float, false>(U, a, xbuf, st, layout);
  return (int)err;
}

}  // extern "C"
