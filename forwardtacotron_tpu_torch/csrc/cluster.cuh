// Thread-block clusters on Hopper: cluster barriers, mbarriers and bulk
// copies (TMA) multicast into every block of a cluster, and the launch-side
// choice of a cluster size of which a whole cooperative grid is resident.
// Used by the WaveRNN sampler (csrc/wavernn_sample.cu), which stages each
// tile by multicast within clusters, and by the BiRNN's stream-local path
// (csrc/birnn.cu), which pushes h into its peers' shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// all threads of every block of the cluster; arrive publishes this
// thread's earlier shared-memory accesses, wait sees the others'
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
// an arrive that publishes nothing: this block is done reading its tile
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of the same shared-memory location in block `rank` of the
// cluster, for st_cluster
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}
// a 16-byte store into a block of the cluster (its own or a peer's); the
// next cluster_arrive() publishes it
__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// wait for the barrier's phase `parity` to complete; a copy that never
// lands ends the kernel with a trap after ~10 s rather than hanging it
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}
// order this thread's earlier generic-proxy accesses (and those it has
// acquired from other threads) before its later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
// one bulk copy from global memory into the same shared-memory offset of
// every block of `mask`, each block's barrier counting its bytes
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src,
                                               uint32_t bytes, uint64_t* bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// The staging tile of a cluster of cs blocks: rows l < nl of src (K
// elements each, whole 16-byte chunks, K a multiple of 16) into dst rows of
// stride SD. Each block issues the rows l = rank (mod cs), one bulk copy a
// row, delivered to every block of the cluster, so L2 serves each row once
// per cluster instead of once per block. Called by every thread between
// cluster_wait() (no block still reads its tile) and the products; done
// when mbar_wait(bar, phase) returns.
template <typename T>
__device__ void stage_multicast(const T* src, int SS, int nl, int K, T* dst,
                                int SD, uint64_t* bar, int cs) {
  const uint32_t bytes = K * sizeof(T);
  if (threadIdx.x == 0) mbar_expect_tx(bar, nl * bytes);
  if (threadIdx.x < 32) {
    fence_proxy_async();  // the vectors other blocks stored before the
                          // grid barrier, seen by the copies
    for (int l = cluster_rank() + cs * threadIdx.x; l < nl; l += cs * 32)
      bulk_multicast(dst + (size_t)l * SD, src + (size_t)l * SS, bytes, bar,
                     (uint16_t)((1u << cs) - 1));
  }
}

// The largest cluster of at most max_cs blocks, a power of two dividing
// `divisor`, with which the whole grid of cfg is resident at once (a
// cooperative launch needs every block resident): *cs, or 0 where none
// is. Leaves attrs[0] set to that cluster dimension and cfg.attrs pointing
// at attrs with numAttrs = 1.
template <typename Kernel>
cudaError_t max_resident_cluster(Kernel kernel, cudaLaunchConfig_t& cfg,
                                 cudaLaunchAttribute* attrs, int max_cs,
                                 int divisor, int* cs) {
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  for (*cs = max_cs; *cs >= 1; *cs /= 2) {
    if (divisor % *cs != 0) continue;
    attrs[0].val.clusterDim.x = *cs;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    int clusters = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters * *cs >= (int)cfg.gridDim.x) break;
  }
  return cudaSuccess;
}
