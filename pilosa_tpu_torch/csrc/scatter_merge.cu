// scatter_merge: OR unique (word address, mask) updates into a flat
// plane chunk IN PLACE and count the bits that were newly set.
//
// Replaces pilosa_tpu/ops/scatter.py:91 _merge_count_kernel and :111
// _scatter_merge_pallas. The TPU version built a dense update plane
// U = 0.at[addr].set(masks), then streamed merged = P | U and
// count = sum(popcount(U & ~P)) through VMEM tiles. The addresses of one
// chunk are unique (ops/scatter.py sort_updates collapses duplicates), so
// here one thread per address reads P[addr], writes P[addr] | mask and
// adds __popc(mask & ~old) to a block partial: the same function without
// materializing U and without touching the words no update names. The
// chunk is updated in place; the host copies it back.
//
// Bound on the H100: bytes — each update reads an address and a mask and
// reads and writes one word (16 B); a 32,768-word chunk with a few
// thousand updates is far below a microsecond of traffic, so the launch
// dominates. Design: grid-stride loop over updates, warp-shuffle and
// shared-memory block reduction, one atomicAdd per block into an int32
// the wrapper zeroed. An address outside [0, n) is dropped, as XLA's
// scatter drops out-of-bounds updates.

#include <cstdint>
#include <cuda_runtime.h>

__global__ void scatter_merge_kernel(uint32_t* __restrict__ flat, long long n,
                                     const int* __restrict__ addr,
                                     const uint32_t* __restrict__ masks,
                                     long long m, int* __restrict__ count) {
    int local = 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         u < m; u += stride) {
        const int ad = addr[u];
        if (ad < 0 || ad >= n) continue;
        const uint32_t mk = masks[u];
        const uint32_t old = flat[ad];
        flat[ad] = old | mk;
        local += __popc(mk & ~old);
    }
    for (int off = 16; off > 0; off >>= 1)
        local += __shfl_down_sync(0xffffffffu, local, off);
    __shared__ int warp_sums[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = local;
    __syncthreads();
    if (warp == 0) {
        const int n_warps = blockDim.x >> 5;
        int s = lane < n_warps ? warp_sums[lane] : 0;
        for (int off = 16; off > 0; off >>= 1)
            s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0 && s != 0) atomicAdd(count, s);
    }
}

extern "C" {

// flat: [n] words, updated in place; addr/masks: [m] unique updates;
// count: one int32 zeroed by the caller. Returns cudaGetLastError().
int pk_scatter_merge(uint32_t* flat, long long n, const int* addr,
                     const uint32_t* masks, long long m, int* count,
                     void* stream) {
    const int threads = 256;
    long long blocks = (m + threads - 1) / threads;
    if (blocks > 4096) blocks = 4096;
    if (blocks < 1) blocks = 1;
    scatter_merge_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(flat, n, addr, masks, m,
                                                   count);
    return (int)cudaGetLastError();
}

}  // extern "C"
