// Optional timing of one launch for the device profiler
// (obs/devprof.py), passed to the launcher as its last argument (nullptr:
// no timing, and the kernel skips it with one branch) and to the kernel
// by value: the kernel's own clock. Each block reads the global
// nanosecond timer (%globaltimer, 32 ns ticks on an H100) when it starts
// and when it ends; dev holds the earliest start, the latest end and the
// blocks done, (~0, 0, 0) between launches; the last block to finish
// resets dev and writes the span's two ends to host (pinned memory,
// zeroed by the caller before the launch), the end last. The host reads
// a nonzero end as "this launch is done with its words". This is the
// kernel's time as a profiler trace shows it, less the blocks' launch
// and retirement (under 1 us).

#pragma once

#include <cuda_runtime.h>

struct PkTiming {
    unsigned long long* dev;
    unsigned long long* host;
};

static inline PkTiming pk_clock(const PkTiming* t) {
    if (t != nullptr) return *t;
    PkTiming c = {nullptr, nullptr};
    return c;
}

__device__ __forceinline__ unsigned long long pk_now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// First statement of a timed kernel.
__device__ __forceinline__ void pk_clock_start(const PkTiming& c) {
    if (c.dev != nullptr && threadIdx.x == 0) atomicMin(c.dev, pk_now());
}

// Last statement of a timed kernel: every thread of the block reaches it.
__device__ __forceinline__ void pk_clock_stop(const PkTiming& c) {
    if (c.dev == nullptr) return;
    __syncthreads();
    if (threadIdx.x != 0) return;
    atomicMax(c.dev + 1, pk_now());
    __threadfence();
    const unsigned long long blocks =
        (unsigned long long)gridDim.x * gridDim.y * gridDim.z;
    if (atomicAdd(c.dev + 2, 1ull) == blocks - 1) {
        __threadfence();
        const unsigned long long start = atomicExch(c.dev, ~0ull);
        const unsigned long long end = atomicExch(c.dev + 1, 0ull);
        atomicExch(c.dev + 2, 0ull);
        volatile unsigned long long* h = c.host;
        h[0] = start;
        __threadfence_system();
        h[1] = end;
        __threadfence_system();
    }
}
