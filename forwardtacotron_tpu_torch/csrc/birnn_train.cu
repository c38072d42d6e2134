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
// Forward: the recurrence of csrc/birnn.cu plus a stash of 5H values per
// stream and step (GRU r, z, n, gh_n, h_prev; LSTM i, f, g, o, c_prev), in
// the compute type. Three paths, chosen by
// kernels/birnn_train.py:train_forward_plan; all write the same y and
// stash, so the backward takes any of them.
//
// Cluster forward (ftt_birnn_train_fwd_cl), for the wide recurrences (the
// decoder LSTM in bf16, and in float32 at grad_accum's micro-batches; the
// CBHG GRUs; WaveRNN's GRU): one thread-block cluster of C blocks per
// (stream, group of BG = 8 or 16 batch lanes),
// launched with cluster dimensions and no cooperative grid; clusters are
// independent, so where the card holds fewer at once they run in waves.
// Block `rank` owns units [rank*U, (rank+1)*U), U = H/C, and keeps their
// R = NG*U rows of W_hh resident for the whole walk (registers, then
// shared memory). Per step:
//   product: the block's rows against the group's h, rounded to T and held
//     in its own shared memory (rows = lanes). bf16 runs on the tensor
//     cores: mma.sync.m16n8k16 with W_hh's rows as A (16 rows a tile, the
//     first kClTcReg tiles of a warp in registers, the rest in shared
//     memory in the mma's lane order), the lanes as N (one or two n-tiles,
//     B fragments by ldmatrix), float32 sums. float32 runs on the CUDA
//     cores (TF32 stays off): thread (g, ks) multiplies 2 rows against
//     k-slice ks of every lane, each 16-byte read of h feeding 8 FMAs, the
//     first 4 (8 where the rest would not fit) 16-byte chunks of its rows
//     in registers. A float32 product on the tensor cores as three TF32
//     products (3xTF32) holds float32's accuracy but spills and measured
//     slower at every shape; it is built only for the probe
//     (csrc/birnn_train_tf32.cu). Warps of different k-slices write
//     partial sums; no shuffles;
//   gate math: one owner thread a (lane, unit) adds its NG rows' KS
//     partials in order, takes the gate inputs that cp.async brought one
//     step ahead, writes y and the five stash values without waiting, and
//     keeps h (float32) and the LSTM c in registers;
//   exchange: the block's BG x U new values, rounded to T, go 16 bytes a
//     store into every peer's h buffer (st.shared::cluster), double-
//     buffered by step parity; one cluster barrier (arrive.release /
//     wait.acquire), which also orders the buffers as in csrc/birnn.cu.
// Lanes past B in the last group are masked at every step and write
// nothing. What it removes from the cooperative path (the probe's trace in
// PERF.md): staging h from L2, the gate inputs' loads after the
// product, the shuffle reduction and the grid barrier, ~80% of a step.
// What bounds it: per step, the product (bf16: shared-memory reads of A
// and h; float32: the FMAs of a block, 0.1-0.5M) and ~2 us of gate math,
// pushes and the cluster barrier; the bytes and operations of the whole
// launch are 10-100x below.
//
// Cooperative forward (ftt_birnn_train_fwd), where neither of the others
// fits or the clusters would run in more than one wave (the decoder LSTM
// in float32 at batch 32: its W_hh share needs clusters of 16 and 8 lanes,
// two waves of the 7 clusters of 16 an H100 holds, a tie). Block j owns U
// hidden units of one stream and keeps their NG*U rows of W_hh in shared memory. At each
// step the block stages its stream's whole h (B x H float32, written by
// every block of the stream at the previous step) from L2 into shared
// memory; each warp then multiplies kBT batch lanes at once against the
// resident rows, so one weight read from shared memory feeds kBT FMAs. The
// thread that updates (b, u) also writes its five stash values. One grid
// barrier per step; h is double-buffered in global memory. What bounds it:
// not the bytes (gi + y + stash) nor the operations (2*T*B*S*NG*H*H, 1.4
// ms at the float32 peak for the decoder LSTM, H=512, T=1024, B=32) but
// the chain of T grid barriers, each step a short sequence of dependent
// phases per block (stage h, product, cell update).
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
// step, 75 ns at H=128) and bytes are far below. Its product and cell
// update are csrc/birnn_step.cuh's, shared with kernel #1's stream-local
// path (csrc/birnn.cu); the batch-split forward took the same time before
// and after the move (PERF.md, PR 5).
//
// Backward: one reversed walk over the steps for every stream. The
// per-step product is transposed relative to the forward (dh_prev =
// dgh . W_hh, dgh the stream's NG*H hidden-gate gradients), and the bytes
// (stash + dy + dgi (+ dgh)) and operations (2*T*B*S*NG*H*H) are far below
// what a step costs: the chain of dependent steps is the limit, so each
// path cuts the fixed cost of a step. Two paths, chosen by
// kernels/birnn_train.py:train_backward_plan.
//
// Batch-split backward (ftt_birnn_train_bwd_bs), wherever a stream's whole
// W_hh fits one block (the series predictors' BiGRUs, H=64/128): lanes are
// independent, so block (s, lane) holds W_hh (NG*H x H, row-major) in
// shared memory and walks every step of its lane with __syncthreads only:
// no grid barrier and no exchange. Per step the H owner threads form the
// lane's gate gradients from the stash row and dy (both brought by
// cp.async one step ahead) and the dh/dc they carry in registers, write
// dgi/dgh and put dgh, rounded to T, in shared memory; then thread
// (c, gs) multiplies row slice gs of dgh against column chunk c of W_hh
// (16 bytes of neighbouring columns: a warp reads neighbouring chunks of a
// row), the first kBsBwdReg rows of its slice held in registers for the
// whole walk; each owner adds its column's GS slice sums in a fixed order.
// Steps where the lane is masked skip the product (dh passes through).
// What bounds it: per step, the gate math, the shared-memory reads of the
// part of W_hh outside registers and three block barriers on one SM.
//
// Cooperative backward (ftt_birnn_train_bwd), for the rest (decoder LSTM,
// CBHG GRUs): block j owns U units of a stream. The product is split by
// gate rows rather than by units: the block keeps the NG*U rows of W_hh
// of its units' gates (all H columns; thread i holds columns i, i + 256
// and i + 512, as far as H <= 768 reaches) in registers, and per step it
// (A) forms the gate gradients of its units from the stash and dy (loaded
//     during the previous step) and the dh/dc it carries in shared memory,
//     writes dgi/dgh, and keeps dgh, rounded to T, in shared memory;
// (B1) multiplies them with its rows: P_j[b][k] = sum over its rows r of
//     dgh[b][r] W_hh[r][k], the block's share of every unit's dh_prev,
//     written to global memory (for every lane, without a branch per lane:
//     a masked lane's dgh is zero);
// then one grid barrier, and
// (B2) sums, for its own units, the partials of the stream's H/U blocks in
//     block order: 16-byte loads where U allows, the blocks split into runs
//     so that every thread has loads in flight, the runs added in order.
// So a step exchanges B x H partial sums per block instead of the B x NG*H
// gate gradients that every block needed when each kept its units' W_hh
// columns (4x fewer bytes for LSTM, 3x for GRU: 8 MB a step at the decoder
// in float32, not 32 MB), and the product needs no reduction across
// threads. The partials are double-buffered by step, so one grid barrier
// per step suffices: a block writes buffer k&1 at step k only after every
// block passed the barrier of step k-1, that is after every block finished
// reading buffer k&1 at step k-2. The design measured before this one,
// each block staging the stream's whole gate-gradient vector by bulk
// copies (TMA) multicast within clusters and multiplying it with its
// columns, is kept as csrc/birnn_train_staged.cu, which
// tools/torch_kernel_probe.py times beside this kernel (PERF.md has both).
// What bounds it: the chain, per step, of the product (B*NG*H*U FMAs a block on the
// CUDA cores, the training path keeping TF32 off: at the decoder half of
// the step, at about half the FMA rate), the grid barrier, and the L2
// round trip of the partials after it.
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
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "birnn_step.cuh"
#include "cluster.cuh"
#include "probe.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBT = 4;  // batch lanes per warp item of the forward product
constexpr int kBsRows = 4;          // W_hh rows per thread of its product
constexpr int kBsMaxThreads = 512;  // 128 registers a thread, no spills
constexpr int kBsMaxSplits = 8;
constexpr int kBsBwdReg = 8;         // W_hh rows a thread keeps in registers
constexpr int kBsBwdMaxSplits = 32;  // row slices of the backward's product
constexpr int kLanes = 8;      // lanes of a partial product's register tile
constexpr int kCoopMaxCols = 3;  // W_hh columns a thread owns (H <= 768)
constexpr int kSumBatch = 16;  // partial-sum loads a thread has in flight
constexpr int kAItems = 2;     // phase-A items a thread loads a step ahead
constexpr int kClMaxThreads = 512;  // cluster forward: 128 registers a thread
constexpr int kClMaxCluster = 16;   // above 8: a non-portable cluster size
constexpr int kClMaxSplits = 16;    // k-slices of its product
constexpr int kClTcReg = 8;    // A tiles a warp keeps in registers (bf16)
constexpr int kClFmaRows = 2;  // W_hh rows a thread multiplies (float32)
// 16-byte chunks of a row in a thread's registers (float32): 4 where the
// rest fits shared memory (no spills), else 8 (spills 12-28 bytes)
constexpr int kClFmaRegLo = 4;
constexpr int kClFmaRegHi = 8;

// forward: batch groups of kBT lanes, and k-splits so that every warp has
// an item when the batch is small
__host__ __device__ __forceinline__ int n_bgroups(int B) {
  return (B + kBT - 1) / kBT;
}
__host__ __device__ __forceinline__ int fwd_splits(int B) {
  return n_bgroups(B) >= kWarps ? 1 : kWarps / n_bgroups(B);
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
  float* xbuf;           // (2, S, H/U, B, H) partials (cooperative)
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
      rows_product<T>(acc, w_reg, w_at, h_mine, nc);
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
      float cn;
      const float hn =
          cell_step<T, LSTM, true>(g_in, H, gh, h, c, cn, st, H);
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

// ---------------------------------------------------- cluster forward

// Cluster forward: one cluster of C blocks per (stream, group of BG batch
// lanes); block `rank` owns units [rank*U, (rank+1)*U) and keeps their R =
// NG*U rows of W_hh resident; see the note at the top of the file.
struct ClArgs {
  const void* gi;        // (n_steps, B, S, NG*H) T
  const void* w_hh;      // (S, NG*H, H) T
  const float* b_hh;     // (S, NG*H)
  const int* lengths;    // (B)
  float* y;              // (n_steps, B, S, H)
  void* stash;           // (n_steps, B, S, 5, H) T
  int n_steps, B, S, H;
  int C;                 // blocks of a cluster
  int KS;                // k-slices of the product
};

// What the product of a cluster block takes: its threads and the bytes of
// W_hh it keeps in shared memory (threads 0: a shape it does not take).
struct ClProductSize {
  int threads;
  size_t w_bytes;
};

// Where the parts of a cluster block's shared memory lie, and its threads
// (0: a shape the kernel does not take), for product P (ClMmaProduct or
// ClFmaProduct, whose size() gives its part); mirrored by
// kernels/birnn_train.py:_cl_size. W_hh's share of P first, then h rounded
// to T for the group's lanes (two buffers, rows of H + 16 bytes), the KS
// partial sums of every (lane, row) (rows padded by 4), and two steps of
// the block's gate inputs. Every owner thread holds one (lane, unit).
struct ClLayout {
  int threads;
  size_t w_bytes, h_off, part_off, g_off, smem;
};

template <typename P>
__host__ __device__ __forceinline__ ClLayout cl_layout(int NG, int H, int C,
                                                       int KS) {
  constexpr size_t item = P::ITEM;
  constexpr int BG = P::BG;
  ClLayout l{0, 0, 0, 0, 0, 0};
  const int vec = (int)(16 / item);
  if (C < 2 || C > kClMaxCluster || (C & (C - 1)) || H % C != 0 || KS < 1 ||
      KS > kClMaxSplits || (KS & (KS - 1)))
    return l;
  const int U = H / C, R = NG * U;
  if (U % vec != 0) return l;
  const ClProductSize p = P::size(R, H, KS);
  if (p.threads == 0) return l;
  const int n = p.threads > U * BG ? p.threads : U * BG;
  if (n > kClMaxThreads) return l;
  l.threads = (n + 31) / 32 * 32;
  l.w_bytes = p.w_bytes;
  l.h_off = l.w_bytes;
  l.part_off = l.h_off + align16(item * 2 * BG * (H + vec));
  l.g_off = l.part_off + sizeof(float) * (size_t)KS * BG * (R + 4);
  l.smem = l.g_off + item * 2 * NG * BG * U;
  return l;
}

__device__ __forceinline__ void cl_ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p))
      : "memory");
}
__device__ __forceinline__ void cl_ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"((uint32_t)__cvta_generic_to_shared(p))
               : "memory");
}
__device__ __forceinline__ void cl_mma(float (&d)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The product on the tensor cores (bf16): W_hh's rows are the A operand,
// the group's lanes the N side (BG = 8 or 16: one or two n-tiles),
// mma.m16n8k16 with products exact in float32 and the sum float32, in two
// chains (even and odd k-tiles) added at the end. Warp (mt, ks) multiplies
// m-tile mt (16 rows) against k-tiles [ks*nt, (ks+1)*nt) for every lane of
// the group. A fragments in the mma's lane order, as csrc/birnn_sl_mma.cu
// holds them (512 bytes a tile, the first REG = kClTcReg tiles of a warp
// in registers, the rest in shared memory); B fragments by ldmatrix from
// the rounded h, whose rows are the lanes. (A float32 specialisation on
// the tensor cores as 3xTF32 lives in csrc/birnn_train_tf32.cu.)
template <typename T, int BG_, int REG>
struct ClMmaProduct {
  static_assert(sizeof(T) == 2, "the shipped tensor-core product is bf16");
  static_assert(BG_ == 8 || BG_ == 16, "one or two n-tiles of 8 lanes");
  static constexpr size_t ITEM = sizeof(T);
  static constexpr int BG = BG_;
  static constexpr int NB = BG / 8;
  static constexpr int KT = 16;               // k of a tile
  static constexpr int VEC = 16 / sizeof(T);  // elements of an ldmatrix row
  int nt, ns, mt, ks, lane;
  bool on;
  const uint4* w_mine;
  uint4 a_reg[REG];

  // warps of 16 rows x KS k-slices; each warp's k-tiles past REG in shared
  // memory
  __host__ __device__ static ClProductSize size(int R, int H, int KS) {
    if (R % 16 != 0 || H % KT != 0 || (H / KT) % KS != 0) return {0, 0};
    const int nt = H / KT / KS;
    return {32 * (R / 16) * KS,
            (size_t)512 * (R / 16) * KS * (nt - (nt < REG ? nt : REG))};
  }

  // w_row(row): the block's row `row` of W_hh in global memory
  template <typename WRow>
  __device__ __forceinline__ void load(uint4* w_s, WRow w_row, int R, int H,
                                       int KS) {
    // the 32-bit word at (row, k): the bf16 pair (k, k+1)
    auto w = [&](int row, int k) {
      return *reinterpret_cast<const uint32_t*>(w_row(row) + k);
    };
    nt = H / KT / KS;
    ns = nt - min(REG, nt);
    const int warp = threadIdx.x / 32, RT = R / 16;
    lane = threadIdx.x % 32;
    mt = warp / KS;
    ks = warp % KS;
    on = warp < RT * KS;
    auto frag = [&](int tile_r, int kt, int l) {
      const int r0 = tile_r * 16 + l / 4;
      const int k = kt * KT + (l % 4) * 2;
      return make_uint4(w(r0, k), w(r0 + 8, k), w(r0, k + KT / 2),
                        w(r0 + 8, k + KT / 2));
    };
    for (int i = threadIdx.x; i < RT * KS * ns * 32; i += blockDim.x) {
      const int wp = i / 32 / ns, j = (i / 32) % ns;
      w_s[i] = frag(wp / KS, (wp % KS) * nt + REG + j, i % 32);
    }
#pragma unroll
    for (int j = 0; j < REG; ++j)
      a_reg[j] = on && j < nt ? frag(mt, ks * nt + j, lane)
                              : make_uint4(0, 0, 0, 0);
    w_mine = w_s + (size_t)threadIdx.x / 32 * ns * 32 + lane;
  }

  // part[(ks*BG + b)*RP + row]: k-slice ks's share of row . h[b]; h: the
  // group's rounded h, rows HS elements apart
  __device__ __forceinline__ void run(const T* h, int HS, float* part,
                                      int RP) {
    if (!on) return;
    float d[2][NB][4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[c][n][e] = 0.0f;
    // ldmatrix rows (16 bytes): lanes 8m..8m+7 give the rows of matrix m,
    // (n-tile, half of the k-tile) = (m / 2, m % 2) for x4, (0, m % 2) for
    // x2
    const int m = lane / 8;
    const T* hl = h + (size_t)((NB == 2 ? m / 2 : 0) * 8 + lane % 8) * HS +
                  ks * nt * KT + (m % 2) * VEC;
    auto tile = [&](int c, const uint4& a, int j) {
      uint32_t bf[4];
      if (NB == 2)
        cl_ldsm_x4(bf, hl + j * KT);
      else
        cl_ldsm_x2(bf, hl + j * KT);
#pragma unroll
      for (int n = 0; n < NB; ++n) cl_mma(d[c][n], a, bf[2 * n], bf[2 * n + 1]);
    };
#pragma unroll
    for (int j = 0; j < REG; ++j)
      if (j < nt) tile(j & 1, a_reg[j], j);
    int j = REG;
    for (; j + 1 < nt; j += 2) {
      const uint4 a0 = w_mine[(j - REG) * 32];
      const uint4 a1 = w_mine[(j + 1 - REG) * 32];
      tile(0, a0, j);
      tile(1, a1, j + 1);
    }
    if (j < nt) tile(0, w_mine[(j - REG) * 32], j);
    const int row = mt * 16 + lane / 4;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* p = part + (size_t)(ks * BG + n * 8 + (lane % 4) * 2 + e) * RP;
        p[row] = d[0][n][e] + d[1][n][e];
        p[row + 8] = d[0][n][2 + e] + d[1][n][2 + e];
      }
  }
};

// The float32 product on the CUDA cores (TF32 stays off on the training
// path): thread (g, ks) multiplies rows g + r*NR against k-slice ks of every
// lane's h, four columns at a time; a warp shares ks where NR allows, so
// its h reads are broadcasts, and each 16-byte read of h feeds kClFmaRows
// rows.
template <int BG_, int REG>
struct ClFmaProduct {
  static_assert(BG_ == 8, "groups of 8 lanes");
  static constexpr size_t ITEM = 4;
  static constexpr int BG = BG_;
  static constexpr int ROWS = kClFmaRows;
  int R, NR, nc, ns, g, ks;
  bool on;
  const uint4* w_mine;
  uint4 w_reg[REG][ROWS];

  // threads of ROWS rows x KS k-slices; each row's chunks past REG in
  // shared memory
  __host__ __device__ static ClProductSize size(int R, int H, int KS) {
    if (R % ROWS != 0 || (H / 4) % KS != 0) return {0, 0};
    const int nc = H / 4 / KS;
    return {R / ROWS * KS, (size_t)16 * R * KS * (nc - (nc < REG ? nc : REG))};
  }

  template <typename WRow>
  __device__ __forceinline__ void load(uint4* w_s, WRow w_row, int R_, int H,
                                       int KS) {
    auto w = [&](int row, int chunk) {
      return *reinterpret_cast<const uint4*>(w_row(row) + chunk * 4);
    };
    R = R_;
    NR = R / ROWS;
    nc = H / 4 / KS;
    ns = nc - min(REG, nc);
    g = threadIdx.x % NR;
    ks = threadIdx.x / NR;
    on = threadIdx.x < NR * KS;
    // chunk cc >= REG of row `row` in slice ks at w_s[(ks*ns + cc - REG)*R
    // + row]: a warp reads consecutive chunks
    for (int i = threadIdx.x; i < R * KS * ns; i += blockDim.x) {
      const int row = i % R, jj = i / R;
      w_s[i] = w(row, (jj / ns) * nc + REG + jj % ns);
    }
#pragma unroll
    for (int cc = 0; cc < REG; ++cc)
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        w_reg[cc][r] = on && cc < nc ? w(g + r * NR, ks * nc + cc)
                                     : make_uint4(0, 0, 0, 0);
    w_mine = w_s + (size_t)ks * ns * R + g;
  }

  __device__ __forceinline__ void run(const float* h, int HS, float* part,
                                      int RP) {
    if (!on) return;
    float acc[ROWS][BG];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int b = 0; b < BG; ++b) acc[r][b] = 0.0f;
    const float* hk = h + ks * nc * 4;
    auto fma_chunk = [&](const uint4(&w)[ROWS], int cc) {
#pragma unroll
      for (int b = 0; b < BG; ++b) {
        const float4 hv = *reinterpret_cast<const float4*>(hk + b * HS + cc * 4);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          acc[r][b] = fmaf(hv.x, __uint_as_float(w[r].x), acc[r][b]);
          acc[r][b] = fmaf(hv.y, __uint_as_float(w[r].y), acc[r][b]);
          acc[r][b] = fmaf(hv.z, __uint_as_float(w[r].z), acc[r][b]);
          acc[r][b] = fmaf(hv.w, __uint_as_float(w[r].w), acc[r][b]);
        }
      }
    };
#pragma unroll
    for (int cc = 0; cc < REG; ++cc)
      if (cc < nc) fma_chunk(w_reg[cc], cc);
    for (int cc = REG; cc < nc; ++cc) {
      uint4 w[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) w[r] = w_mine[(size_t)(cc - REG) * R + r * NR];
      fma_chunk(w, cc);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int b = 0; b < BG; ++b)
        part[(size_t)(ks * BG + b) * RP + g + r * NR] = acc[r][b];
  }
};

template <typename T, int BG, int REG, bool TC>
using ClProduct = typename std::conditional<TC, ClMmaProduct<T, BG, REG>,
                                            ClFmaProduct<BG, REG>>::type;

// TC: the product on the tensor cores (bf16; float32 as 3xTF32 in
// csrc/birnn_train_tf32.cu), else on the CUDA cores (float32); REG: A
// tiles, or 16-byte chunks of a row, a thread keeps in registers
template <typename T, bool LSTM, int BG, int REG, bool TC>
__global__ void __launch_bounds__(kClMaxThreads) train_fwd_cl_kernel(ClArgs a) {
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int VEC = 16 / sizeof(T);
  const T* __restrict__ gi = static_cast<const T*>(a.gi);
  T* __restrict__ stash = static_cast<T*>(a.stash);
  const int n_steps = a.n_steps, B = a.B, S = a.S, H = a.H, C = a.C,
            KS = a.KS;
  const int GH = NG * H, U = H / C, R = NG * U, RP = R + 4, HS = H + VEC;
  const int G = (B + BG - 1) / BG;   // lane groups of a stream
  const int cl = blockIdx.x / C;     // the cluster's (stream, group)
  const int s = cl / G, b0 = (cl % G) * BG;
  const int rank = (int)cluster_rank();
  const int u0 = rank * U;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  using Product = ClProduct<T, BG, REG, TC>;
  const ClLayout L = cl_layout<Product>(NG, H, C, KS);
  // local row q*U + u of W_hh is gate q of unit u0 + u
  const T* w_src = static_cast<const T*>(a.w_hh) + (size_t)s * GH * H;
  Product product;
  product.load(reinterpret_cast<uint4*>(smem), [&](int row) {
    return w_src + (size_t)((row / U) * H + u0 + row % U) * H;
  }, R, H, KS);
  T* hq = reinterpret_cast<T*>(smem + L.h_off);               // (2, BG, HS)
  float* part = reinterpret_cast<float*>(smem + L.part_off);  // (KS, BG, RP)
  T* g_s = reinterpret_cast<T*>(smem + L.g_off);              // (2, NG, BG, U)
  for (int i = tid; i < 2 * BG * HS; i += blockDim.x) hq[i] = from_f<T>(0.0f);
  for (int i = tid; i < 2 * NG * BG * U; i += blockDim.x)
    g_s[i] = from_f<T>(0.0f);
  __syncthreads();  // the zero gate inputs of padded lanes before the copies

  // the gate inputs of the group's live lanes at step t, 16 bytes a copy,
  // into buffer t&1 (an empty group past the last step keeps the count)
  const int cpg = U / VEC;  // copies per (gate, lane)
  auto prefetch = [&](int t) {
    if (t < n_steps) {
      T* dst = g_s + (size_t)(t & 1) * NG * BG * U;
      for (int i = tid; i < NG * BG * cpg; i += blockDim.x) {
        const int q = i / (BG * cpg), bl = i / cpg % BG, j = i % cpg;
        if (b0 + bl < B)
          cp_async16(dst + (q * BG + bl) * U + j * VEC,
                     gi + (((size_t)t * B + b0 + bl) * S + s) * GH + q * H +
                         u0 + j * VEC);
      }
    }
    cp_async_commit();
  };
  prefetch(0);

  // the (lane, unit) this thread updates, and its state, in registers
  const int u = tid % U, bl = tid / U, b = b0 + bl;
  const bool owner = tid < U * BG;
  const bool live = owner && b < B;
  const int len = live ? a.lengths[b] : 0;
  float bh[NG];
#pragma unroll
  for (int q = 0; q < NG; ++q)
    bh[q] = owner ? a.b_hh[(size_t)s * GH + q * H + u0 + u] : 0.0f;
  float h = 0.0f, c = 0.0f;
  // every block's h is zero before a peer may push into it
  cluster_arrive();
  cluster_wait();

  // probe phases: 0 product, 1 wait for the gate inputs and the product,
  // 2 gate math and stores, 3 pushes of h, 4 cluster barrier
  Probe probe;
  const int n16 = cpg;  // 16-byte pieces of a lane's U values
  for (int t = 0; t < n_steps; ++t) {
    const int p = t & 1;
    prefetch(t + 1);
    product.run(hq + (size_t)p * BG * HS, HS, part, RP);
    probe.mark(0);
    cp_async_wait_one();  // this step's gate inputs have landed
    __syncthreads();
    probe.mark(1);
    T* h_next = hq + (size_t)(p ^ 1) * BG * HS;
    if (owner) {
      float gh[NG];
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        float sum = 0.0f;
        for (int k = 0; k < KS; ++k)
          sum += part[(size_t)(k * BG + bl) * RP + q * U + u];
        gh[q] = sum + bh[q];
      }
      if (live) {
        const size_t row = ((size_t)t * B + b) * S + s;
        float cn;
        const float hn = cell_step<T, LSTM, true>(
            g_s + ((size_t)p * NG * BG + bl) * U + u, BG * U, gh, h, c, cn,
            stash + row * 5 * H + u0 + u, H);
        if (inside(s, t, n_steps, len)) {
          h = hn;
          if (LSTM) c = cn;
        }
        a.y[row * H + u0 + u] = h;
      }
      h_next[(size_t)bl * HS + u0 + u] = from_f<T>(h);
    }
    probe.mark(2);
    if (t + 1 == n_steps) break;  // no peer reads the last h
    __syncthreads();
    // the block's BG x U new values, 16 bytes a store, into every peer
    for (int i = tid; i < (C - 1) * BG * n16; i += blockDim.x) {
      const int peer = (rank + 1 + i / (BG * n16)) % C, j = i % (BG * n16);
      T* src = h_next + (size_t)(j / n16) * HS + u0 + (j % n16) * VEC;
      st_cluster(map_rank(src, peer), *reinterpret_cast<const float4*>(src));
    }
    probe.mark(3);
    cluster_arrive();
    cluster_wait();
    probe.mark(4);
  }
  probe.finish();
}

// ---------------------------------------------------------------- backward

// Gate gradients of one unit of one lane at one step. st: its five stash
// values (LSTM i, f, g, o, c_prev; GRU r, z, n, gh_n, h_prev); dh: the
// carried gradient plus dy; dc: the carried cell gradient (LSTM), updated.
// Fills di (input gates) and dg (hidden gates), both zero at an inactive
// step, and returns the part of dh_prev outside the product dg . W_hh.
template <bool LSTM>
__device__ __forceinline__ float gate_grads(const float* st, float dh,
                                            float& dc, bool active,
                                            float* di, float* dg) {
  if constexpr (LSTM) {
    const float ig = st[0], fg = st[1], gg = st[2], og = st[3], cp = st[4];
    const float tc = tanhf(fg * cp + ig * gg);
    const float dct = dh * og * (1.0f - tc * tc) + dc;
    di[0] = dct * gg * ig * (1.0f - ig);
    di[1] = dct * cp * fg * (1.0f - fg);
    di[2] = dct * ig * (1.0f - gg * gg);
    di[3] = dh * tc * og * (1.0f - og);
#pragma unroll
    for (int q = 0; q < 4; ++q) dg[q] = di[q] = active ? di[q] : 0.0f;
    if (active) dc = dct * fg;
    return active ? 0.0f : dh;
  } else {
    const float r = st[0], z = st[1], n = st[2], ghn = st[3], hp = st[4];
    const float dpre_n = dh * (1.0f - z) * (1.0f - n * n);
    const float dpre_r = dpre_n * ghn * r * (1.0f - r);
    const float dpre_z = dh * (hp - n) * z * (1.0f - z);
    di[0] = dg[0] = active ? dpre_r : 0.0f;
    di[1] = dg[1] = active ? dpre_z : 0.0f;
    di[2] = active ? dpre_n : 0.0f;
    dg[2] = active ? dpre_n * r : 0.0f;
    return active ? dh * z : dh;
  }
}

// Writes one unit's gate gradients of one (step, lane, stream) row.
template <typename T, bool LSTM>
__device__ __forceinline__ void store_grads(T* dgi, T* dgh, size_t at, int H,
                                            const float* di,
                                            const float* dg) {
  constexpr int NG = LSTM ? 4 : 3;
#pragma unroll
  for (int q = 0; q < NG; ++q) dgi[at + q * H] = from_f<T>(di[q]);
  if constexpr (!LSTM)
#pragma unroll
    for (int q = 0; q < NG; ++q) dgh[at + q * H] = from_f<T>(dg[q]);
}

// Batch-split backward: block (s, b) holds stream s's whole W_hh and walks
// every reversed step of batch lane b alone; see the note at the top.
template <typename T, bool LSTM>
__global__ void __launch_bounds__(kBsMaxThreads)
    train_bwd_bs_kernel(BwdArgs a, int GS) {
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int VEC = 16 / sizeof(T);
  const T* __restrict__ stash = static_cast<const T*>(a.stash);
  const T* __restrict__ w_hh = static_cast<const T*>(a.w_hh);
  T* __restrict__ dgi = static_cast<T*>(a.dgi);
  T* __restrict__ dgh = static_cast<T*>(a.dgh);
  const int n_steps = a.n_steps, B = a.B, S = a.S, H = a.H;
  const int GH = NG * H, NC = H / VEC, rows = GH / GS;
  const int s = blockIdx.x / B, b = blockIdx.x % B;
  const int tid = threadIdx.x;

  // the product item of this thread: chunk c (VEC columns) of dh_prev over
  // the rows gs*rows.. of W_hh; a warp's threads read neighbouring chunks
  // of a row, and its dgh reads are broadcasts
  const int c = tid % NC, gs = tid / NC;
  const bool prod = tid < NC * GS;

  extern __shared__ __align__(16) unsigned char smem[];
  uint4* w_s = reinterpret_cast<uint4*>(smem);  // chunk (g, c) at g*NC + c
  float* x_s = reinterpret_cast<float*>(smem + sizeof(T) * GH * H);  // dgh
  float* part = x_s + GH;                 // (GS, H)
  float* dy_s = part + (size_t)GS * H;    // (2, H) dy, double-buffered
  T* st_s = reinterpret_cast<T*>(dy_s + 2 * H);  // (2, 5H) stash rows

  // W_hh of the stream, row-major as in global memory
  const uint4* w_src =
      reinterpret_cast<const uint4*>(w_hh + (size_t)s * GH * H);
  for (int i = tid; i < GH * NC; i += blockDim.x) w_s[i] = w_src[i];

  // the stash row and dy of reversed step k into buffer k&1, 16 bytes per
  // copy (an empty group past the last step keeps the count)
  auto prefetch = [&](int k) {
    if (k < n_steps) {
      const size_t row = ((size_t)(n_steps - 1 - k) * B + b) * S + s;
      T* st_dst = st_s + (size_t)(k & 1) * 5 * H;
      for (int i = tid; i < 5 * H / VEC; i += blockDim.x)
        cp_async16(st_dst + i * VEC, stash + row * 5 * H + i * VEC);
      float* dy_dst = dy_s + (k & 1) * H;
      for (int i = tid; i < H / 4; i += blockDim.x)
        cp_async16(dy_dst + 4 * i, a.dy + row * H + 4 * i);
    }
    cp_async_commit();
  };
  prefetch(0);

  // the unit this thread owns, and its carried dh and dc, in registers
  const int u = tid;
  const bool owner = tid < H;
  const int len = a.lengths[b];
  float dh = 0.0f, dc = 0.0f;
  __syncthreads();
  // the first rows of the thread's slice stay in registers for the walk
  const uint4* w_mine = w_s + (size_t)gs * rows * NC + c;  // row j at j*NC
  uint4 w_reg[kBsBwdReg];
#pragma unroll
  for (int j = 0; j < kBsBwdReg; ++j)
    w_reg[j] = prod && j < rows ? w_mine[j * NC] : make_uint4(0, 0, 0, 0);

  // probe phases: 0 wait for the step's inputs, 1 gate gradients,
  // 2 product, 3 sums of the slices
  Probe probe;
  for (int k = 0; k < n_steps; ++k) {
    const int t = n_steps - 1 - k;
    prefetch(k + 1);
    cp_async_wait_one();  // this step's stash row and dy have landed
    __syncthreads();
    probe.mark(0);
    const bool active = inside(s, t, n_steps, len);  // the whole block's
    float base = 0.0f;
    if (owner) {
      const T* st = st_s + (size_t)(k & 1) * 5 * H + u;
      float sv[5];
#pragma unroll
      for (int q = 0; q < 5; ++q) sv[q] = to_f(st[q * H]);
      dh += dy_s[(k & 1) * H + u];
      float di[NG], dg[NG];
      base = gate_grads<LSTM>(sv, dh, dc, active, di, dg);
      store_grads<T, LSTM>(dgi, dgh, (((size_t)t * B + b) * S + s) * GH + u,
                           H, di, dg);
#pragma unroll
      for (int q = 0; q < NG; ++q) x_s[q * H + u] = round_to<T>(dg[q]);
    }
    __syncthreads();
    probe.mark(1);
    if (!active) {  // dgh is zero: dh passes through
      if (owner) dh = base;
      continue;
    }
    if (prod) {
      float acc[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
      const float* xg = x_s + gs * rows;
      auto fma_row = [&](const uint4& w, float xv) {
        float wf[VEC];
        unpack16(w, wf, T());
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = fmaf(xv, wf[v], acc[v]);
      };
#pragma unroll
      for (int j = 0; j < kBsBwdReg; ++j)
        if (j < rows) fma_row(w_reg[j], xg[j]);
#pragma unroll 4
      for (int j = kBsBwdReg; j < rows; ++j) fma_row(w_mine[j * NC], xg[j]);
      float4* out = reinterpret_cast<float4*>(part + (size_t)gs * H + c * VEC);
#pragma unroll
      for (int v = 0; v < VEC / 4; ++v)
        out[v] = make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2],
                             acc[4 * v + 3]);
    }
    __syncthreads();
    probe.mark(2);
    if (owner) {  // the slices of the unit's column summed in order
      float sum = 0.0f;
      for (int j = 0; j < GS; ++j) sum += part[(size_t)j * H + u];
      dh = base + sum;
    }
    probe.mark(3);
  }
  probe.finish();
}

// float4 or float arithmetic for the sums of B2
template <int N> struct VecOf { using type = float; };
template <> struct VecOf<4> { using type = float4; };
template <int N>
__device__ __forceinline__ typename VecOf<N>::type vzero();
template <>
__device__ __forceinline__ float vzero<1>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 vzero<4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
template <int N>
__device__ __forceinline__ typename VecOf<N>::type vload(const float* p);
template <>
__device__ __forceinline__ float vload<1>(const float* p) { return __ldcg(p); }
template <>
__device__ __forceinline__ float4 vload<4>(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ void vstore(float* p, float v) { *p = v; }
__device__ __forceinline__ void vstore(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// B2 of the cooperative backward: the runs its n_vec items split the
// stream's nb blocks into, so that every thread has one (a power of two
// dividing nb), and the floats of the runs' sums
__host__ __device__ __forceinline__ int coop_splits(int n_vec, int nb) {
  int splits = 1;
  while (n_vec * splits * 2 <= kThreads && nb % (splits * 2) == 0)
    splits *= 2;
  return splits;
}
__host__ __device__ __forceinline__ int coop_red(int B, int U) {
  return B * U > 4 * kThreads ? B * U : 4 * kThreads;
}

// Cooperative backward: block j owns U units of a stream and the NG*U rows
// of W_hh of their gates (in registers); each step its gate gradients,
// their product with those rows (partial sums of the stream's whole
// dh_prev), one grid barrier, then the sum of every block's partials for
// its units; see the note at the top. KC: columns a thread owns, H/256
// rounded up.
template <typename T, bool LSTM, int U, int KC>
__global__ void __launch_bounds__(kThreads, 1)
    train_bwd_kernel(BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int R = NG * U;              // gate rows of the block
  constexpr int RP = (R + 3) / 4 * 4;    // padded to whole float4
  const T* __restrict__ stash = static_cast<const T*>(a.stash);
  const T* __restrict__ w_hh = static_cast<const T*>(a.w_hh);
  T* __restrict__ dgi = static_cast<T*>(a.dgi);
  T* __restrict__ dgh = static_cast<T*>(a.dgh);
  const int n_steps = a.n_steps, B = a.B, S = a.S, H = a.H;
  const int GH = NG * H;
  const int nb = H / U;  // blocks of a stream
  const int s = blockIdx.x / nb, j = blockIdx.x % nb, u0 = j * U;
  const int tid = threadIdx.x;
  const int n_items = B * U;

  extern __shared__ __align__(16) float smem_f[];
  float* dg_s = smem_f;                      // (B, RP) dgh rounded to T
  float* dh_s = dg_s + (size_t)B * RP;       // (B, U) carried dh
  float* base_s = dh_s + n_items;            // (B, U) dh_prev minus product
  float* dc_s = base_s + n_items;            // (B, U) carried dc (LSTM)
  float* red_s = dc_s + n_items;             // the runs' sums of B2
  int* len_s = reinterpret_cast<int*>(red_s + coop_red(B, U));

  // B2's items: a lane's VU consecutive units; runs of the stream's blocks
  constexpr int VU = U >= 4 ? 4 : 1;
  using Vec = typename VecOf<VU>::type;
  const int n_vec = B * U / VU;
  const int splits = coop_splits(n_vec, nb);
  const int per = nb / splits;

  // row r = q*U + u of the block (gate q of unit u0+u), at columns
  // k = tid + c*kThreads
  float w_reg[RP][KC];
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const int k = tid + c * kThreads;
      w_reg[r][c] =
          r < R && k < H
              ? to_f(w_hh[((size_t)s * GH + (r / U) * H + u0 + r % U) * H + k])
              : 0.0f;
    }
  for (int i = tid; i < B * RP; i += kThreads) dg_s[i] = 0.0f;
  for (int i = tid; i < n_items; i += kThreads) dh_s[i] = dc_s[i] = 0.0f;
  for (int i = tid; i < B; i += kThreads) len_s[i] = a.lengths[i];
  __syncthreads();

  // phase A's inputs of the next step, loaded during the previous step's
  // sums (after its grid barrier, which would otherwise wait for them)
  T pst[kAItems][5];
  float pdy[kAItems];
  auto load_a = [&](int k) {
    if (k >= n_steps) return;
    const int t = n_steps - 1 - k;
#pragma unroll
    for (int jj = 0; jj < kAItems; ++jj) {
      const int i = tid + jj * kThreads;
      if (i >= n_items) continue;
      const size_t row = ((size_t)t * B + i / U) * S + s;
      const int unit = u0 + i % U;
#pragma unroll
      for (int q = 0; q < 5; ++q) pst[jj][q] = stash[row * 5 * H + q * H + unit];
      pdy[jj] = a.dy[row * H + unit];
    }
  };
  load_a(0);

  // probe phases: 0 gate gradients (A), 1 partial products, 2 grid
  // barrier, 3 sums of the partials
  Probe probe;
  const size_t pstride = (size_t)S * nb * B * H;
  for (int k = 0; k < n_steps; ++k) {
    const int t = n_steps - 1 - k;
    auto active = [&](int b) { return inside(s, t, n_steps, len_s[b]); };

    // (A) gate gradients of the block's units
    auto item = [&](int i, const float* sv, float dyv) {
      const int b = i / U, u = i % U;
      float di[NG], dg[NG];
      base_s[i] =
          gate_grads<LSTM>(sv, dh_s[i] + dyv, dc_s[i], active(b), di, dg);
      store_grads<T, LSTM>(dgi, dgh, (((size_t)t * B + b) * S + s) * GH + u0 + u,
                           H, di, dg);
#pragma unroll
      for (int q = 0; q < NG; ++q) dg_s[b * RP + q * U + u] = round_to<T>(dg[q]);
    };
#pragma unroll
    for (int jj = 0; jj < kAItems; ++jj) {
      const int i = tid + jj * kThreads;
      if (i >= n_items) continue;
      float sv[5];
#pragma unroll
      for (int q = 0; q < 5; ++q) sv[q] = to_f(pst[jj][q]);
      item(i, sv, pdy[jj]);
    }
    for (int i = tid + kAItems * kThreads; i < n_items; i += kThreads) {
      const size_t row = ((size_t)t * B + i / U) * S + s;
      float sv[5];
#pragma unroll
      for (int q = 0; q < 5; ++q)
        sv[q] = to_f(stash[row * 5 * H + q * H + u0 + i % U]);
      item(i, sv, a.dy[row * H + u0 + i % U]);
    }
    __syncthreads();
    probe.mark(0);

    // (B1) this block's part of dh_prev for every live lane:
    // P[b][k] = sum over its rows r of dgh[b][r] * W_hh[r][k]
    float* P = a.xbuf + (k & 1) * pstride + ((size_t)s * nb + j) * B * H;
    // (every lane: a masked lane's dgh is zero, and a branch per lane
    // would keep its loads from overlapping the other lanes' products)
    for (int b0 = 0; b0 < B; b0 += kLanes) {
      float acc[kLanes][KC];
#pragma unroll
      for (int l = 0; l < kLanes; ++l)
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[l][c] = 0.0f;
#pragma unroll
      for (int r4 = 0; r4 < RP / 4; ++r4) {
        float4 d[kLanes];
#pragma unroll
        for (int l = 0; l < kLanes; ++l)
          d[l] = b0 + l < B
                     ? reinterpret_cast<const float4*>(dg_s + (b0 + l) * RP)[r4]
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int l = 0; l < kLanes; ++l)
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            acc[l][c] = fmaf(d[l].x, w_reg[4 * r4][c], acc[l][c]);
            acc[l][c] = fmaf(d[l].y, w_reg[4 * r4 + 1][c], acc[l][c]);
            acc[l][c] = fmaf(d[l].z, w_reg[4 * r4 + 2][c], acc[l][c]);
            acc[l][c] = fmaf(d[l].w, w_reg[4 * r4 + 3][c], acc[l][c]);
          }
      }
#pragma unroll
      for (int l = 0; l < kLanes; ++l)
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int kk = tid + c * kThreads;
          if (b0 + l < B && kk < H) P[(size_t)(b0 + l) * H + kk] = acc[l][c];
        }
    }
    probe.mark(1);
    grid.sync();
    probe.mark(2);
    load_a(k + 1);

    // (B2) dh_prev of the block's units: every block's partials summed in
    // block order, VU units a load, the blocks split into `splits` runs
    // that threads sum apart and that are then added in order; a masked
    // lane's dh passes through
    const float* Pall = a.xbuf + (k & 1) * pstride + (size_t)s * nb * B * H;
    for (int i = tid; i < n_vec * splits; i += kThreads) {
      const int sp = i / n_vec, it = i % n_vec;
      const int b = it / (U / VU), u = it % (U / VU) * VU;
      Vec sum = vzero<VU>();
      if (active(b)) {
        const float* p = Pall + ((size_t)sp * per * B + b) * H + u0 + u;
        for (int i0 = 0; i0 < per; i0 += kSumBatch) {
          Vec v[kSumBatch];
#pragma unroll
          for (int q = 0; q < kSumBatch; ++q)
            v[q] = i0 + q < per ? vload<VU>(p + (size_t)(i0 + q) * B * H)
                                : vzero<VU>();
#pragma unroll
          for (int q = 0; q < kSumBatch; ++q) sum = vadd(sum, v[q]);
        }
      }
      vstore(red_s + (size_t)i * VU, sum);
    }
    __syncthreads();
    for (int i = tid; i < n_items; i += kThreads) {
      const int it = i / VU;  // i = b*U + u: item b*(U/VU) + u/VU
      float sum = 0.0f;
      for (int sp = 0; sp < splits; ++sp)
        sum += red_s[((size_t)sp * n_vec + it) * VU + i % VU];
      dh_s[i] = base_s[i] + sum;
    }
    __syncthreads();
    probe.mark(3);
  }
  probe.finish();
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

// A cluster-forward variant: compute type, cell, lanes of a group, A tiles
// or chunks of a row in registers, the product on the tensor cores or not
template <typename T_, bool LSTM_, int BG_, int REG_, bool TC_>
struct ClVariant {
  using T = T_;
  static constexpr bool LSTM = LSTM_;
  static constexpr int BG = BG_;
  static constexpr int REG = REG_;
  static constexpr bool TC = TC_;
  using Product = ClProduct<T, BG, REG, TC>;
};

// f(ClVariant<...>{}) for the flags, lanes of a group, register share and
// product: bf16 on the tensor cores in groups of 8 or 16 lanes, float32 on
// the CUDA cores in groups of 8 (float32 on the tensor cores, 3xTF32, is
// built only by csrc/birnn_train_tf32.cu, for the probe)
template <typename F>
cudaError_t with_cl_variant(int lstm, int bf16, int BG, int REG, int TC,
                            F f) {
  using bf = __nv_bfloat16;
  constexpr int tc = kClTcReg, r0 = kClFmaRegLo, r1 = kClFmaRegHi;
  auto cell = [&](auto v_lstm, auto v_gru) {
    return lstm ? f(v_lstm) : f(v_gru);
  };
  if (bf16 && TC && REG == tc) {
    if (BG == 8)
      return cell(ClVariant<bf, true, 8, tc, true>{},
                  ClVariant<bf, false, 8, tc, true>{});
    if (BG == 16)
      return cell(ClVariant<bf, true, 16, tc, true>{},
                  ClVariant<bf, false, 16, tc, true>{});
  }
  if (!bf16 && !TC && BG == 8) {
    if (REG == r0)
      return cell(ClVariant<float, true, 8, r0, false>{},
                  ClVariant<float, false, 8, r0, false>{});
    if (REG == r1)
      return cell(ClVariant<float, true, 8, r1, false>{},
                  ClVariant<float, false, 8, r1, false>{});
  }
  return cudaErrorInvalidValue;
}

// The cluster forward's launch configuration: grid S * ceil(B/BG) * C,
// clusters of C, the block of `l`; *resident, unless null, gets the number
// of such clusters the card holds at once.
template <typename V>
cudaError_t cl_config(const ClArgs& a, const ClLayout& l,
                      cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                      int* resident) {
  auto kernel =
      train_fwd_cl_kernel<typename V::T, V::LSTM, V::BG, V::REG, V::TC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  if (err != cudaSuccess) return err;
  if (a.C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = {};
  cfg.gridDim = dim3(a.S * ((a.B + V::BG - 1) / V::BG) * a.C);
  cfg.blockDim = dim3(l.threads);
  cfg.dynamicSmemBytes = l.smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (resident == nullptr) return cudaSuccess;
  return cudaOccupancyMaxActiveClusters(resident, kernel, &cfg);
}

// Launches every (stream, group) cluster; where the card holds fewer at
// once they run in waves (they are independent). Refuses a shape of which
// the card holds no cluster. The card's count of resident clusters is
// asked once per device and block shape (the query costs host time).
template <typename V>
cudaError_t launch_fwd_cl(const ClArgs& a, cudaStream_t stream) {
  constexpr int NG = V::LSTM ? 4 : 3;
  const ClLayout l = cl_layout<typename V::Product>(NG, a.H, a.C, a.KS);
  if (l.threads == 0) return cudaErrorInvalidValue;
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
      if ((err = cl_config<V>(a, l, cfg, attr, &resident)) != cudaSuccess)
        return err;
      resident_of[key] = resident;
    } else {
      resident = hit->second;
      if ((err = cl_config<V>(a, l, cfg, attr, nullptr)) != cudaSuccess)
        return err;
    }
  }
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(
      &cfg, train_fwd_cl_kernel<typename V::T, V::LSTM, V::BG, V::REG, V::TC>,
      a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// threads and shared memory of the batch-split backward; mirrored by
// kernels/birnn_train.py:_bs_bwd_size
__host__ __forceinline__ int bs_bwd_threads(int H, int GS, size_t item) {
  const int n = std::max((int)(H * item / 16) * GS, H);
  return (n + 31) / 32 * 32;
}
__host__ __forceinline__ size_t bs_bwd_smem(int NG, int H, int GS,
                                            size_t item) {
  return item * NG * H * H +
         sizeof(float) * ((size_t)NG * H + (size_t)GS * H + 2 * (size_t)H) +
         item * 2 * 5 * H;
}

template <typename T, bool LSTM>
cudaError_t launch_bwd_bs(BwdArgs a, int GS, cudaStream_t stream) {
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int VEC = 16 / sizeof(T);
  if (GS <= 0 || GS > kBsBwdMaxSplits || (NG * a.H) % GS != 0 ||
      a.H % VEC != 0)
    return cudaErrorInvalidValue;
  const int threads = bs_bwd_threads(a.H, GS, sizeof(T));
  if (threads > kBsMaxThreads) return cudaErrorInvalidValue;
  const size_t smem = bs_bwd_smem(NG, a.H, GS, sizeof(T));
  auto kernel = train_bwd_bs_kernel<T, LSTM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.S * a.B, threads, smem, stream>>>(a, GS);
  return cudaGetLastError();
}

template <typename T, bool LSTM, int U, int KC>
cudaError_t launch_bwd(BwdArgs a, cudaStream_t stream) {
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int RP = (NG * U + 3) / 4 * 4;
  const size_t smem =
      sizeof(float) * ((size_t)a.B * RP + 3 * (size_t)a.B * U +
                       coop_red(a.B, U)) +
      sizeof(int) * (size_t)a.B;
  return cooperative_launch(train_bwd_kernel<T, LSTM, U, KC>, &a,
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

// U units a block; KC = ceil(H / 256) W_hh columns a thread, up to
// kCoopMaxCols (where H > 256, S*H/U <= the SMs needs U >= 4)
template <typename T, bool LSTM>
cudaError_t bwd_u(int U, const BwdArgs& a, cudaStream_t st) {
  if (a.H > kCoopMaxCols * kThreads) return cudaErrorInvalidValue;
  if (a.H > 2 * kThreads) {
    switch (U) {
      case 4: return launch_bwd<T, LSTM, 4, 3>(a, st);
      case 8: return launch_bwd<T, LSTM, 8, 3>(a, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (a.H > kThreads) {
    switch (U) {
      case 4: return launch_bwd<T, LSTM, 4, 2>(a, st);
      case 8: return launch_bwd<T, LSTM, 8, 2>(a, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (U) {
    case 1: return launch_bwd<T, LSTM, 1, 1>(a, st);
    case 2: return launch_bwd<T, LSTM, 2, 1>(a, st);
    case 4: return launch_bwd<T, LSTM, 4, 1>(a, st);
    case 8: return launch_bwd<T, LSTM, 8, 1>(a, st);
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

// Cluster forward (no hbuf): one cluster of C blocks per (stream, group of
// BG lanes), KS k-slices of the product, on the tensor cores (TC 1, bf16,
// REG = kClTcReg A tiles in registers) or the CUDA cores (TC 0, float32,
// REG = 4 or 8 16-byte chunks of a row in registers).
int ftt_birnn_train_fwd_cl(int lstm, int bf16, const void* gi,
                           const void* w_hh, const float* b_hh,
                           const int* lengths, float* y, void* stash,
                           int n_steps, int B, int S, int H, int C, int BG,
                           int KS, int REG, int TC, void* stream) {
  if (bad_shape(lstm, n_steps, B, S, H, C)) return (int)cudaErrorInvalidValue;
  const ClArgs a{gi, w_hh, b_hh, lengths, y, stash, n_steps, B, S, H, C, KS};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_cl_variant(lstm, bf16, BG, REG, TC, [&](auto v) {
    return launch_fwd_cl<decltype(v)>(a, st);
  });
}

// Threads and shared-memory bytes of a cluster-forward block as the
// launcher computes them (threads 0: a shape the kernel does not take), and
// how many clusters of C such blocks the card holds at once (resident; -1
// where the shape is not taken, 0 where a block needs more shared memory
// than the card gives one). kernels/birnn_train.py mirrors the size formula.
int ftt_birnn_train_cl_size(int lstm, int bf16, int H, int C, int BG, int KS,
                            int REG, int TC, int* threads, long long* smem,
                            int* resident) {
  *threads = 0;
  *smem = 0;
  *resident = -1;
  ClLayout l{0, 0, 0, 0, 0, 0};
  // a (type, lanes, register share, product) the kernel is not built for
  // takes no shape
  if (with_cl_variant(lstm, bf16, BG, REG, TC, [&](auto v) {
        l = cl_layout<typename decltype(v)::Product>(lstm ? 4 : 3, H, C, KS);
        return cudaSuccess;
      }) != cudaSuccess ||
      l.threads == 0)
    return 0;
  *threads = l.threads;
  *smem = (long long)l.smem;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  *resident = 0;
  if (l.smem > (size_t)optin) return 0;  // no block of it fits an SM
  const ClArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 1, BG, 1, H, C, KS};
  return (int)with_cl_variant(lstm, bf16, BG, REG, TC, [&](auto v) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    return cl_config<decltype(v)>(a, l, cfg, attr, resident);
  });
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

// Batch-split backward (no exchange buffer): GS row slices of the product.
int ftt_birnn_train_bwd_bs(int lstm, int bf16, const void* stash,
                           const float* dy, const void* w_hh,
                           const int* lengths, void* dgi, void* dgh,
                           int n_steps, int B, int S, int H, int GS,
                           void* stream) {
  if (bad_shape(lstm, n_steps, B, S, H, 1) || (!lstm && dgh == nullptr))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{stash, dy, w_hh, lengths, dgi, dgh, nullptr,
                  n_steps, B, S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = lstm ? launch_bwd_bs<__nv_bfloat16, true>(a, GS, st)
               : launch_bwd_bs<__nv_bfloat16, false>(a, GS, st);
  else
    err = lstm ? launch_bwd_bs<float, true>(a, GS, st)
               : launch_bwd_bs<float, false>(a, GS, st);
  return (int)err;
}

// Threads and shared-memory bytes of a batch-split block, forward (bwd 0,
// `splits` k-splits) or backward (bwd 1, `splits` row slices), as the
// launchers compute them; kernels/birnn_train.py mirrors both formulas.
int ftt_birnn_train_bs_size(int bwd, int lstm, int bf16, int H, int splits,
                            int* threads, long long* smem) {
  const int NG = lstm ? 4 : 3;
  const size_t item = bf16 ? 2 : 4;
  *threads = bwd ? bs_bwd_threads(H, splits, item)
                 : bs_threads(NG, H, splits);
  *smem = (long long)(bwd ? bs_bwd_smem(NG, H, splits, item)
                          : bs_smem(NG, H, splits, item));
  return 0;
}

const char* ftt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
