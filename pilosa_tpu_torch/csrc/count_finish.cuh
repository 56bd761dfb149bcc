// The one-pass finish of a count kernel, shared by tape_count.cu and
// scatter_merge.cu: a block sum, then one 64-bit atomic per block that
// adds the block's sum and a ticket to a per-stream accumulator; the
// block that draws the last ticket writes the total and zeroes the
// accumulator for the next launch on the stream. No zeroed output, no
// fence and no second read, so a count is one device operation.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

template <int THREADS>
__device__ __forceinline__ int block_sum(int v) {
    __shared__ int warp_sums[THREADS / 32];
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();  // an earlier call may still read warp_sums
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    v = lane < THREADS / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// acc: one 64-bit word, zero between launches. Each block adds its sum
// and a ticket of 1 << 40 in one atomic; the block that draws the last
// ticket holds the grand total in the returned word plus its own sum,
// writes it and zeroes acc for the next launch on the stream. Kernels on
// one stream run in order, so every count kernel of a stream may share
// acc.
template <int THREADS>
__device__ __forceinline__ void finish(int local,
                                       unsigned long long* __restrict__ acc,
                                       int* __restrict__ out) {
    const int s = block_sum<THREADS>(local);
    if (threadIdx.x == 0) {
        constexpr unsigned long long TICKET = 1ull << 40;
        const unsigned long long old =
            atomicAdd(acc, TICKET | (unsigned long long)(unsigned)s);
        if ((old >> 40) == gridDim.x - 1u) {
            *out = (int)((old & (TICKET - 1)) + (unsigned)s);
            *acc = 0;
        }
    }
}

// Streaming multiprocessors of the current device (cached).
static int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (n <= 0) n = 132;
    }
    return n;
}
