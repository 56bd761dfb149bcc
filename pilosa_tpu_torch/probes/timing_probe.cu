// Kernels of probes/timing_probe.py: what a CUDA event pair and a
// kernel's own clock read of a launch on the card.

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned long long now_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// One thread records the first `n` changes of %globaltimer (its ticks).
__global__ void ticks(unsigned long long* out, int n) {
    unsigned long long prev = now_ns();
    int k = 0;
    for (int i = 0; i < 4000000 && k < n; ++i) {
        const unsigned long long t = now_ns();
        if (t != prev) {
            out[k++] = t - prev;
            prev = t;
        }
    }
}

__global__ void empty() {}

// Every block spins `cycles` SM clocks; thread 0 of each block takes the
// earliest start and the latest end on %globaltimer, as
// csrc/launch_timing.cuh does.
__global__ void clocked_spin(unsigned long long* clk, long long cycles) {
    if (threadIdx.x == 0) atomicMin(clk, now_ns());
    const long long t0 = clock64();
    while (clock64() - t0 < cycles) {
    }
    __syncthreads();
    if (threadIdx.x == 0) atomicMax(clk + 1, now_ns());
}

extern "C" {

int tp_ticks(unsigned long long* out, int n, void* stream) {
    ticks<<<1, 1, 0, (cudaStream_t)stream>>>(out, n);
    return (int)cudaGetLastError();
}

int tp_empty(void* stream) {
    empty<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

int tp_spin(unsigned long long* clk, long long cycles, int blocks,
            void* stream) {
    clocked_spin<<<blocks, 128, 0, (cudaStream_t)stream>>>(clk, cycles);
    return (int)cudaGetLastError();
}

}  // extern "C"
