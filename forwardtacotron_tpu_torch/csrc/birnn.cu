// Bidirectional GRU/LSTM recurrence: one persistent cooperative kernel
// for the whole sequence (replaces the Pallas TPU kernel
// forwardtacotron_tpu/kernels/birnn.py:_kernel).
//
// S streams (2 directions x G groups) advance together; odd streams walk
// time-reversed input, so every stream uses step index t. Block j owns U
// hidden units of one stream and keeps their NG*U rows of W_hh in shared
// memory for the kernel's lifetime; the LSTM cell state of its units
// stays in shared memory too. The hidden state h goes through global
// memory (L2), double-buffered, with one grid barrier per step: at step
// t every block reads buffer t&1 and writes buffer (t+1)&1, and the
// barrier after step t-1 guarantees that no block still reads the
// buffer being written. Reads of h use ld.global.cg (L2, not the
// non-coherent L1), since other SMs wrote it.
//
// Precision: weights and input gates in T (float or bf16); the hidden
// state is float32 and is rounded to T before the product; products
// accumulate in float32; gate math is float32.
//
// Plain C interface (bound with ctypes): ftt_birnn_launch returns a
// cudaError_t; 0 means the launch was accepted.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

__host__ __device__ __forceinline__ int k_splits(int B) {
  return B >= kWarps ? 1 : kWarps / B;
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

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
  const bool reversed = (s & 1) != 0;
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
      float hn, cn = 0.0f;
      if (LSTM) {
        const float ig = sigmoid(to_f(g_in[unit]) + gh[0]);
        const float fg = sigmoid(to_f(g_in[H + unit]) + gh[1]);
        const float gg = tanhf(to_f(g_in[2 * H + unit]) + gh[2]);
        const float og = sigmoid(to_f(g_in[3 * H + unit]) + gh[3]);
        cn = fg * c_s[i] + ig * gg;
        hn = og * tanhf(cn);
      } else {
        const float r = sigmoid(to_f(g_in[unit]) + gh[0]);
        const float z = sigmoid(to_f(g_in[H + unit]) + gh[1]);
        const float n = tanhf(to_f(g_in[2 * H + unit]) + r * gh[2]);
        hn = (1.0f - z) * n + z * hp;
      }
      const int len = lengths[b];
      const bool active = reversed ? (t >= n_steps - len) : (t < len);
      if (!active) hn = hp;
      if (LSTM && active) c_s[i] = cn;
      h_next[(size_t)b * H + unit] = hn;
      y[(((size_t)t * B + b) * S + s) * H + unit] = hn;
    }
    grid.sync();
  }
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

}  // namespace

extern "C" {

int ftt_birnn_launch(int lstm, int bf16, const void* gi, const void* w_hh,
                     const float* b_hh, const int* lengths, float* y,
                     float* hbuf, int n_steps, int B, int S, int H, int U,
                     void* stream) {
  if (U <= 0 || H % U != 0 || (lstm ? 4 : 3) * U > kMaxRows || B <= 0 ||
      n_steps <= 0)
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

const char* ftt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
