// Kernel #2's cluster forward in float32 with its product on the tensor
// cores as three TF32 products (3xTF32), kept to be timed against the one
// that csrc/birnn_train.cu ships (the product on the CUDA cores). Nothing
// in the package calls it; tools/torch_kernel_probe.py (--only train)
// builds it as a library of its own and times it, by phase with --phases,
// beside the shipped shapes on the same inputs, with its largest
// difference from the cooperative path.
//
// The product is ClMmaProduct<float> below, a specialisation of
// csrc/birnn_train.cu's bf16 tensor-core product: mma.m16n8k8 over TF32,
// W_hh's rows and h each split into a TF32 term and a TF32 rest, and
// three of the four products summed; it holds float32's accuracy. What it
// measured on the card against the shipped product (it lost at every
// training shape: its split values spill at the 128 registers a thread of
// 512 threads leaves): PERF.md.

#include "birnn_train.cu"

namespace {

// A tiles a warp keeps in registers: 8, or 16 where the rest would not fit
// shared memory
constexpr int kClTf32RegLo = 8;
constexpr int kClTf32RegHi = 16;

__device__ __forceinline__ void cl_mma_tf32(float (&d)[4], const uint32_t* a,
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v = big + small, both TF32 (big holds v's top 11 bits of mantissa,
// small the next 11): big*big' + big*small' + small*big' misses only
// small*small', 2^-22 of the product
__device__ __forceinline__ void cl_split(uint32_t v, uint32_t& big,
                                         uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(__uint_as_float(v)));
  const float rest = __uint_as_float(v) - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// The float32 product on the tensor cores: as the bf16 one (W_hh's rows
// as A, 16 rows a tile, the lanes as N, A fragments in the mma's lane
// order, 512 bytes a tile), with k-tiles of 8 columns, each float read
// whole by ldmatrix as two halves, and a third accumulator chain for the
// two small products.
template <int BG_, int REG>
struct ClMmaProduct<float, BG_, REG> {
  static_assert(BG_ == 8 || BG_ == 16, "one or two n-tiles of 8 lanes");
  static_assert(REG == kClTf32RegLo || REG == kClTf32RegHi, "A tiles");
  static constexpr size_t ITEM = 4;
  static constexpr int BG = BG_;
  static constexpr int NB = BG / 8;
  static constexpr int KT = 8;    // k of a tile
  int nt, ns, mt, ks, lane;
  bool on;
  const uint4* w_mine;
  uint4 a_reg[REG];

  __host__ __device__ static ClProductSize size(int R, int H, int KS) {
    if (R % 16 != 0 || H % KT != 0 || (H / KT) % KS != 0) return {0, 0};
    const int nt = H / KT / KS;
    return {32 * (R / 16) * KS,
            (size_t)512 * (R / 16) * KS * (nt - (nt < REG ? nt : REG))};
  }

  template <typename WRow>
  __device__ __forceinline__ void load(uint4* w_s, WRow w_row, int R, int H,
                                       int KS) {
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
      const int k = kt * KT + l % 4;
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

  __device__ __forceinline__ void run(const float* h, int HS, float* part,
                                      int RP) {
    if (!on) return;
    float d[3][NB][4];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[c][n][e] = 0.0f;
    // a float32 row of 4 is read as 8 halves, so each lane gets its float
    // whole
    const int m = lane / 8;
    const float* hl = h + (size_t)((NB == 2 ? m / 2 : 0) * 8 + lane % 8) * HS +
                      ks * nt * KT + (m % 2) * 4;
    auto tile = [&](int c, const uint4& a, int j) {
      uint32_t bf[4];
      if (NB == 2)
        cl_ldsm_x4(bf, hl + j * KT);
      else
        cl_ldsm_x2(bf, hl + j * KT);
      const uint32_t av[4] = {a.x, a.y, a.z, a.w};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) cl_split(av[e], ab[e], as[e]);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        cl_split(bf[2 * n], bb0, bs0);
        cl_split(bf[2 * n + 1], bb1, bs1);
        cl_mma_tf32(d[2][n], as, bb0, bb1);
        cl_mma_tf32(d[2][n], ab, bs0, bs1);
        cl_mma_tf32(d[c][n], ab, bb0, bb1);
      }
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
        p[row] = d[0][n][e] + d[1][n][e] + d[2][n][e];
        p[row + 8] = d[0][n][2 + e] + d[1][n][2 + e] + d[2][n][2 + e];
      }
  }
};

// f(ClVariant<float, ...>{}) for the flags, lanes of a group (8 or 16) and
// A tiles in registers (8 or 16)
template <typename F>
cudaError_t with_tf32_variant(int lstm, int BG, int REG, F f) {
  constexpr int t0 = kClTf32RegLo, t1 = kClTf32RegHi;
  auto cell = [&](auto v_lstm, auto v_gru) {
    return lstm ? f(v_lstm) : f(v_gru);
  };
  if (BG == 8 && REG == t0)
    return cell(ClVariant<float, true, 8, t0, true>{},
                ClVariant<float, false, 8, t0, true>{});
  if (BG == 8 && REG == t1)
    return cell(ClVariant<float, true, 8, t1, true>{},
                ClVariant<float, false, 8, t1, true>{});
  if (BG == 16 && REG == t0)
    return cell(ClVariant<float, true, 16, t0, true>{},
                ClVariant<float, false, 16, t0, true>{});
  if (BG == 16 && REG == t1)
    return cell(ClVariant<float, true, 16, t1, true>{},
                ClVariant<float, false, 16, t1, true>{});
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The cluster forward in float32 on the tensor cores: one cluster of C
// blocks per (stream, group of BG lanes), KS k-slices, REG A tiles of each
// warp in registers. With resident non-null it launches nothing and sets
// *resident to the clusters of such blocks the card holds at once.
int ftt_birnn_train_fwd_cl_tf32(int lstm, const void* gi, const void* w_hh,
                                const float* b_hh, const int* lengths,
                                float* y, void* stash, int n_steps, int B,
                                int S, int H, int C, int BG, int KS, int REG,
                                int* resident, void* stream) {
  if (bad_shape(lstm, n_steps, B, S, H, C)) return (int)cudaErrorInvalidValue;
  const ClArgs a{gi, w_hh, b_hh, lengths, y, stash, n_steps, B, S, H, C, KS};
  return (int)with_tf32_variant(lstm, BG, REG, [&](auto v) -> cudaError_t {
    using V = decltype(v);
    if (resident == nullptr)
      return launch_fwd_cl<V>(a, static_cast<cudaStream_t>(stream));
    const ClLayout l = cl_layout<typename V::Product>(lstm ? 4 : 3, H, C, KS);
    if (l.threads == 0) return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    return cl_config<V>(a, l, cfg, attr, resident);
  });
}

}  // extern "C"
