// Kernel #1's stream-local path with its product on the tensor cores, kept
// to be timed against the one that csrc/birnn.cu ships (the product on the
// CUDA cores). Nothing in the package calls it;
// tools/torch_kernel_probe.py (--only birnn) builds it as a library of its
// own and times it, by phase with --phases, beside the shipped variants on
// the same inputs, after checking it against the planned path's results.
//
// The product (MmaProduct): warp (rt, ks) multiplies the 16 rows of tile rt
// of the block's share of W_hh against k-tiles [ks*nt, (ks+1)*nt) of h with
// mma.sync m16n8k16, W_hh the A operand and h every column of B (so every
// column of the result is the product; lanes 4g keep rows g and g+8). bf16
// only. Everything else is the shipped kernel's step. What it measured on
// the card, against the shipped product: PERF.md.

#include "birnn.cu"

namespace {

constexpr int kTcReg = 8;  // A tiles a warp keeps in registers (32 registers)

// Threads and shared-memory bytes of a block with the tensor-core product,
// 0 threads where the shape is not one it takes: warps (16-row tiles x
// KS k-slices) of 32 threads, the 16x16 tiles past a warp's first kTcReg in
// shared memory (512 bytes each), then sl_size's partial sums, h buffers
// and gate inputs.
void sl_mma_size(int NG, int H, int C, int KS, int* threads, size_t* smem) {
  *threads = 0;
  *smem = 0;
  if (C < 1 || C > kSlMaxCluster || (C & (C - 1)) || H % C != 0 ||
      KS < 1 || KS > kSlMaxSplits)
    return;
  const int U = H / C, R = NG * U;
  if (U % 8 != 0 || R % 16 != 0 || H % 16 != 0 || (H / 16) % KS != 0)
    return;
  const int warps = R / 16 * KS, nt = H / 16 / KS;
  const int n = std::max(32 * warps, U);
  if (n > kSlMaxThreads) return;
  *threads = (n + 31) / 32 * 32;
  *smem = (size_t)512 * warps * (nt - std::min(kTcReg, nt)) +
          sizeof(float) * ((size_t)KS * R + 2 * (size_t)H) + 2 * 2 * R;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint4& a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// A fragments are held in the mma's lane order: the first kTcReg tiles in
// registers, the rest in shared memory at w_s[(warp*ns + j - kTcReg)*32 +
// lane], 512 contiguous bytes a tile. Products of bf16 are exact in float32
// and accumulate in float32, in two chains (even and odd k-tiles).
struct MmaProduct {
  int R, nt, ns, rt, ks, lane;
  bool on;
  size_t w_bytes;  // of shared memory
  const uint4* w_mine;
  uint4 a_reg[kTcReg];

  // w_row(row): the block's row `row` of W_hh in global memory
  template <typename WRow>
  __device__ __forceinline__ void load(uint4* w_s, WRow w_row, int R_, int H,
                                       int KS) {
    auto w = [&](int row, int k) {  // the bf16 pair (k, k+1) of a row
      return *reinterpret_cast<const uint32_t*>(w_row(row) + k);
    };
    R = R_;
    nt = H / 16 / KS;
    ns = nt - min(kTcReg, nt);
    const int warp = threadIdx.x / 32, RT = R / 16;
    lane = threadIdx.x % 32;
    rt = warp / KS;
    ks = warp % KS;
    on = warp < RT * KS;
    w_bytes = (size_t)512 * RT * KS * ns;
    auto frag = [&](int tile_r, int kt, int l) {
      const int r0 = tile_r * 16 + l / 4, k = kt * 16 + 2 * (l % 4);
      return make_uint4(w(r0, k), w(r0 + 8, k), w(r0, k + 8),
                        w(r0 + 8, k + 8));
    };
    for (int i = threadIdx.x; i < RT * KS * ns * 32; i += blockDim.x) {
      const int wp = i / 32 / ns, j = (i / 32) % ns;
      w_s[i] = frag(wp / KS, (wp % KS) * nt + kTcReg + j, i % 32);
    }
#pragma unroll
    for (int j = 0; j < kTcReg; ++j)
      a_reg[j] = on && j < nt ? frag(rt, ks * nt + j, lane)
                              : make_uint4(0, 0, 0, 0);
    w_mine = w_s + (size_t)warp * ns * 32 + lane;
  }

  // part[ks*R + row]: k-slice ks's share of every row . h
  __device__ __forceinline__ void run(const float* h, float* part) {
    if (!on) return;
    float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* hk = h + ks * nt * 16 + 2 * (lane % 4);
    auto tile = [&](float(&d)[4], const uint4& a, int j) {
      const float2 lo = *reinterpret_cast<const float2*>(hk + j * 16);
      const float2 hi = *reinterpret_cast<const float2*>(hk + j * 16 + 8);
      mma_16816(d, a, pack_bf16(lo.x, lo.y), pack_bf16(hi.x, hi.y));
    };
#pragma unroll
    for (int j = 0; j < kTcReg; ++j)
      if (j < nt) tile((j & 1) ? d1 : d0, a_reg[j], j);
    int j = kTcReg;
    for (; j + 1 < nt; j += 2) {
      tile(d0, w_mine[(j - kTcReg) * 32], j);
      tile(d1, w_mine[(j + 1 - kTcReg) * 32], j + 1);
    }
    if (j < nt) tile(d0, w_mine[(j - kTcReg) * 32], j);
    if (lane % 4 == 0) {
      part[ks * R + rt * 16 + lane / 4] = d0[0] + d1[0];
      part[ks * R + rt * 16 + lane / 4 + 8] = d0[2] + d1[2];
    }
  }
};

}  // namespace

extern "C" {

// The stream-local path in bf16 with the tensor-core product, in clusters
// of C, with the most k-slices (a power of two) whose block fits the card.
// With layout non-null it launches nothing and sets layout to {k-slices,
// threads, shared-memory bytes, resident clusters}; KS 0 where no block
// fits.
int ftt_birnn_sl_mma_launch(int lstm, const void* gi, const void* w_hh,
                            const float* b_hh, const int* lengths, float* y,
                            int n_steps, int B, int S, int H, int C,
                            long long* layout, void* stream) {
  if (bad_shape(lstm, n_steps, B, S)) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  int KS = 0, threads = 0;
  size_t smem = 0;
  for (int ks = 1; ks <= kSlMaxSplits; ks *= 2) {
    int n;
    size_t bytes;
    sl_mma_size(lstm ? 4 : 3, H, C, ks, &n, &bytes);
    if (n > 0 && bytes <= (size_t)optin) {
      KS = ks;
      threads = n;
      smem = bytes;
    }
  }
  const SlArgs a{gi, w_hh, b_hh, lengths, y, n_steps, B, S, H, C, KS};
  using bf = __nv_bfloat16;
  auto run = [&](auto v) -> cudaError_t {
    using V = decltype(v);
    if (layout != nullptr) {
      int resident = 0;
      if (KS > 0) {
        cudaLaunchConfig_t cfg;
        cudaLaunchAttribute attr[1];
        const cudaError_t e =
            sl_config<V>(a, threads, smem, cfg, attr, &resident);
        if (e != cudaSuccess) return e;
      }
      const long long out[4] = {KS, threads, (long long)smem, resident};
      std::copy(out, out + 4, layout);
      return cudaSuccess;
    }
    if (KS == 0) return cudaErrorInvalidValue;
    return launch_sl<V>(a, threads, smem, static_cast<cudaStream_t>(stream));
  };
  return (int)(lstm ? run(SlVariant<bf, true, MmaProduct>{})
                    : run(SlVariant<bf, false, MmaProduct>{}));
}

}  // extern "C"
