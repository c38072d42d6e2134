// Per-phase timers of the probe build (nvcc -DFTT_PROBE; the normal build
// compiles every call below to nothing).
//
// Thread 0 of block 0 keeps a Probe. probe.mark(p) adds the SM cycles
// since its previous mark to phase p; probe.finish() adds the totals, and
// the run's %globaltimer span and clock64 span, to device counters that
// ftt_probe_read() copies out and resets. The host scales cycles to ns by
// span_ns / span_cycles, so the coarse %globaltimer only has to be right
// over a whole run. What a phase holds is what thread 0 of block 0 spent
// in it, waits at block and grid barriers included.
#pragma once

#include <cuda_runtime.h>

constexpr int kProbePhases = 8;

#ifdef FTT_PROBE

__device__ unsigned long long ftt_probe_counts[kProbePhases + 2];

struct Probe {
  bool on;
  long long last, c0;
  unsigned long long ns0;
  unsigned long long acc[kProbePhases];
  __device__ Probe() : on(blockIdx.x == 0 && threadIdx.x == 0) {
    for (int i = 0; i < kProbePhases; ++i) acc[i] = 0;
    last = c0 = clock64();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
  }
  __device__ __forceinline__ void mark(int phase) {
    if (!on) return;
    const long long now = clock64();
    acc[phase] += (unsigned long long)(now - last);
    last = now;
  }
  __device__ void finish() {
    if (!on) return;
    unsigned long long ns1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
    const long long c1 = clock64();
    for (int i = 0; i < kProbePhases; ++i) ftt_probe_counts[i] += acc[i];
    ftt_probe_counts[kProbePhases] += ns1 - ns0;
    ftt_probe_counts[kProbePhases + 1] += (unsigned long long)(c1 - c0);
  }
};

// out: kProbePhases cycle totals, then the ns and cycles of the runs.
extern "C" int ftt_probe_read(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyFromSymbol(out, ftt_probe_counts,
                             sizeof(unsigned long long) * (kProbePhases + 2));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kProbePhases + 2] = {};
  return (int)cudaMemcpyToSymbol(ftt_probe_counts, zero, sizeof(zero));
}

#else

struct Probe {
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void finish() {}
};

#endif
