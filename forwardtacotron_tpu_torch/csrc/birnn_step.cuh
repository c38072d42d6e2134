// Step code of the BiRNN kernels that keep a stream's W_hh resident in one
// block, or split by units over one cluster, and walk every step with block
// or cluster barriers only: kernel #2's batch-split forward
// (csrc/birnn_train.cu, with the stash) and kernel #1's stream-local path
// (csrc/birnn.cu, without it). Also the element helpers that every BiRNN
// kernel uses.
//
// The product's layout, as both kernels hold it: W_hh is cut into 16-byte
// chunks of VEC = 16 / sizeof(T) neighbouring columns. Thread (g, ks)
// multiplies the ROWS rows g + r*NR of its block against k-slice ks of h
// (nc chunks); the first REG chunks of its rows sit in registers for the
// whole walk, the rest in shared memory at a place the caller's `w_at(cc,
// r)` gives, laid out so that a warp reads consecutive chunks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// v rounded to T and back: where the plain version rounds h before a
// product (ops/rnn.py, `round_to` there too)
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

// is stream s inside its sequence at kernel step t? Even streams run
// forward, odd ones over the time-reversed input.
__host__ __device__ __forceinline__ bool inside(int s, int t, int n_steps,
                                                int len) {
  return (s & 1) ? (t >= n_steps - len) : (t < len);
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
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

// acc[r] = row r of the thread's rows . its k-slice of h (h: that slice,
// float32, already rounded to T), over nc chunks: cc < REG from w_reg,
// the rest from w_at(cc, r). Sums run over the chunks in order, four
// columns at a time.
template <typename T, int ROWS, int REG, typename WAt>
__device__ __forceinline__ void rows_product(float (&acc)[ROWS],
                                             uint4 (&w_reg)[REG][ROWS],
                                             WAt w_at, const float* h,
                                             int nc) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
  auto fma_chunk = [&](const uint4* w, int cc) {
    float wf[ROWS][VEC];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) unpack16(w[r], wf[r], T());
    const float4* hp = reinterpret_cast<const float4*>(h + cc * VEC);
#pragma unroll
    for (int v = 0; v < VEC / 4; ++v) {
      const float4 hv = hp[v];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
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
    uint4 w[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) w[r] = w_at(cc, r);
    fma_chunk(w, cc);
  }
}

// One step of one unit's cell, in float32: g_in points at the unit's
// input gate of gate 0, gates g_stride apart; gh holds its NG hidden gates
// (W_hh h + b_hh); h and c are its state before the step. Returns the new
// h and sets cn to the new c (LSTM). With STASH, also stores the five
// values the backward needs at st, st_stride apart (GRU r, z, n, gh_n,
// h_prev; LSTM i, f, g, o, c_prev). The caller applies the step's mask.
template <typename T, bool LSTM, bool STASH>
__device__ __forceinline__ float cell_step(const T* g_in, int g_stride,
                                           const float* gh, float h, float c,
                                           float& cn, T* st, int st_stride) {
  if constexpr (LSTM) {
    const float ig = sigmoid(to_f(g_in[0]) + gh[0]);
    const float fg = sigmoid(to_f(g_in[g_stride]) + gh[1]);
    const float gg = tanhf(to_f(g_in[2 * g_stride]) + gh[2]);
    const float og = sigmoid(to_f(g_in[3 * g_stride]) + gh[3]);
    cn = fg * c + ig * gg;
    if constexpr (STASH) {
      st[0] = from_f<T>(ig);
      st[st_stride] = from_f<T>(fg);
      st[2 * st_stride] = from_f<T>(gg);
      st[3 * st_stride] = from_f<T>(og);
      st[4 * st_stride] = from_f<T>(c);
    }
    return og * tanhf(cn);
  } else {
    const float r = sigmoid(to_f(g_in[0]) + gh[0]);
    const float z = sigmoid(to_f(g_in[g_stride]) + gh[1]);
    const float n = tanhf(to_f(g_in[2 * g_stride]) + r * gh[2]);
    cn = 0.0f;
    if constexpr (STASH) {
      st[0] = from_f<T>(r);
      st[st_stride] = from_f<T>(z);
      st[2 * st_stride] = from_f<T>(n);
      st[3 * st_stride] = from_f<T>(gh[2]);
      st[4 * st_stride] = from_f<T>(h);
    }
    return (1.0f - z) * n + z * h;
  }
}

}  // namespace
