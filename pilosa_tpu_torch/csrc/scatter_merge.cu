// scatter_merge: OR unique (word address, mask) updates into a flat of
// words IN PLACE and count the bits that were newly set.
//
// Replaces pilosa_tpu/ops/scatter.py:91 _merge_count_kernel and :111
// _scatter_merge_pallas. The TPU version built a dense update plane
// U = 0.at[addr].set(masks) over a 32,768-word chunk of rows, then
// streamed merged = P | U and count = sum(popcount(U & ~P)) through VMEM
// tiles, one chunk per round trip. Here the wrapper (ops/scatter.py)
// stages only the tiles of T words that a bulk import touches, packed
// into one flat, with the addresses rebased to it; one launch takes the
// whole import (or one chunk of tens of MiB). The addresses of a launch
// are unique (sort_updates collapses duplicates), so each update reads
// P[addr], writes P[addr] | mask and adds __popc(mask & ~old): the same
// function without materializing U and without touching words no update
// names. An address outside [0, n) is dropped, as XLA's scatter drops
// out-of-bounds updates.
//
// Bound on the H100: bytes, 16 per update (its address and mask read,
// its word read and written), e.g. 2 MB for a config-1 batch of ~129K
// updates: under a microsecond of traffic. The launch and the round trip
// to memory set the time, so the design cuts everything else:
//
// - 16-byte loads of the sorted addresses and masks (int4 / uint4, four
//   updates a thread) when both arrays share an offset modulo 16 bytes,
//   with a scalar head (0-3 updates) and tail; 32-bit loads otherwise.
//   Sorted addresses put neighbouring threads on neighbouring words.
// - One pass with no zeroed output (count_finish.cuh): the caller's
//   output is uninitialised memory, and the stream's accumulator is the
//   one tape_count uses, so a call is one device operation.

#include <cstdint>
#include <cuda_runtime.h>

#include "count_finish.cuh"
#include "launch_timing.cuh"

#define THREADS 128

__device__ __forceinline__ int merge_one(uint32_t* __restrict__ flat,
                                         long long n, int ad, uint32_t mk) {
    if (ad < 0 || ad >= n) return 0;
    const uint32_t old = flat[ad];
    flat[ad] = old | mk;
    return __popc(mk & ~old);
}

// VEC: updates [head, head + 4 n_vec) as n_vec int4 / uint4, the updates
// before and after them (at most 3 each) one per thread of block 0. Not
// VEC: every update on its own 32-bit loads.
template <bool VEC>
__global__ void __launch_bounds__(THREADS) scatter_merge_kernel(
        uint32_t* __restrict__ flat, long long n, const int* __restrict__ addr,
        const uint32_t* __restrict__ masks, int head, long long n_vec,
        long long m, unsigned long long* __restrict__ acc,
        int* __restrict__ out, const PkTiming clk) {
    pk_clock_start(clk);
    int local = 0;
    const long long stride = (long long)gridDim.x * THREADS;
    const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (VEC) {
        const int4* a4 = reinterpret_cast<const int4*>(addr + head);
        const uint4* m4 = reinterpret_cast<const uint4*>(masks + head);
        for (long long v = tid; v < n_vec; v += stride) {
            const int4 a = __ldg(a4 + v);
            const uint4 k = __ldg(m4 + v);
            local += merge_one(flat, n, a.x, k.x) + merge_one(flat, n, a.y, k.y)
                   + merge_one(flat, n, a.z, k.z) + merge_one(flat, n, a.w, k.w);
        }
        const long long edge = m - 4 * n_vec;  // head + tail updates
        if (blockIdx.x == 0 && threadIdx.x < edge) {
            const long long u = (int)threadIdx.x < head
                ? threadIdx.x : threadIdx.x + 4 * n_vec;
            local += merge_one(flat, n, __ldg(addr + u), __ldg(masks + u));
        }
    } else {
        for (long long u = tid; u < m; u += stride)
            local += merge_one(flat, n, __ldg(addr + u), __ldg(masks + u));
    }
    finish<THREADS>(local, acc, out);
    pk_clock_stop(clk);
}

// Blocks for `elems` elements at one per thread a pass: at most eight
// per SM (1024 threads), at least one.
static unsigned grid_for(long long elems) {
    long long blocks = (elems + THREADS - 1) / THREADS;
    const long long cap = 8LL * sm_count();
    if (blocks > cap) blocks = cap;
    return blocks < 1 ? 1u : (unsigned)blocks;
}

extern "C" {

// flat: [n] words, updated in place; addr/masks: [m] unique updates;
// out: one int32 on the device, written, never read; acc: one 64-bit word
// on the device, zero (each launch leaves it so). Launches on `stream` of
// `device` and returns cudaGetLastError(). timing: the device profiler's
// (launch_timing.cuh) or nullptr.
int pk_scatter_merge(uint32_t* flat, long long n, const int* addr,
                     const uint32_t* masks, long long m, int* out,
                     void* acc_ptr, int device, void* stream,
                     const PkTiming* timing) {
    unsigned long long* acc = static_cast<unsigned long long*>(acc_ptr);
    int cur = device;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    cudaStream_t s = (cudaStream_t)stream;
    const uintptr_t off = (uintptr_t)addr & 15u;
    const int head = (int)(((16 - off) & 15u) / 4);
    const PkTiming clk = pk_clock(timing);
    if (off % 4 == 0 && ((uintptr_t)masks & 15u) == off && m >= head + 4) {
        const long long n_vec = (m - head) / 4;
        scatter_merge_kernel<true><<<grid_for(n_vec), THREADS, 0, s>>>(
            flat, n, addr, masks, head, n_vec, m, acc, out, clk);
    } else {
        scatter_merge_kernel<false><<<grid_for(m), THREADS, 0, s>>>(
            flat, n, addr, masks, 0, 0, m, acc, out, clk);
    }
    const int rc = (int)cudaGetLastError();
    if (cur != device) cudaSetDevice(cur);
    return rc;
}

}  // extern "C"
