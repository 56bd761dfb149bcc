// ctile_count: per-row popcounts of a compressed block, in one launch.
//
// Replaces pilosa_tpu/ops/ctiles.py:291 _ctile_count_body and :301
// _ctile_counts_pallas, with the XLA steps around them fused in: the
// filter mask (:342 _mask_payload) before the popcount, the per-row
// scatter-add (:348 _scatter_counts, mode="drop") after it, and the
// constant tiles' counts (:355 _const_counts_unfiltered, :362
// _const_counts_filtered) beside it. For a block of `rows` rows:
//
//     out[row[p]] += popcount(payload[p, :] & filt[tile[p], :])   p < P
//     out[r]      += popcount(const[r, j] & filt[j, :])  (const[r, j] != 0)
//
// Without a filter the payload counts alone, and a constant word c
// counts popcount(c) * T. Payload entries whose row is outside [0, rows)
// -- the padded entries point at row `rows` -- or, under a filter, whose
// tile is outside [0, n_tiles), are dropped. On the TPU the kernel wrote
// one count per payload entry, broadcast across the 128 lanes of an
// (8, 128) output block for Mosaic's layout, and XLA did the rest in
// separate passes; on the H100 every step in PyTorch would be another
// launch (about a dozen per block with the SWAR popcounts), and the host's
// launch rate, not the card, set the time. So one launch does it all.
//
// Bound on the H100: bytes. Each payload entry reads T words (and T of
// filter) once with one __popc per word; the constants are R x NT words,
// read once; a non-zero constant under a filter reads its filter tile.
// At the main path's sizes (a few hundred entries of 512 words and a
// 256 x 384 constant table per block) that is ~1-2 MB, well under the
// launch latency.
//
// Design: one warp per work item, grid-stride. Items [0, P) are payload
// entries: the warp reads the entry's tile with 16-byte loads (neighbouring
// lanes on neighbouring addresses), ANDs the filter tile read the same
// way, sums __popc per lane, reduces with __shfl_xor_sync and adds the
// total with one atomicAdd into the zeroed output. Items past P each take
// 32 consecutive constants (one coalesced load); zero constants, most of
// them, cost nothing more; the lanes holding non-zero ones add popc * T
// unfiltered, or, under a filter, the warp walks them one by one
// (__ballot_sync) and counts each against its filter tile like a payload
// entry. Integer atomics make the result exact in any order. Any T is
// taken: a scalar loop runs when T is not a multiple of 4 or a pointer is
// not 16-byte aligned; T = 8 leaves most lanes of a payload warp idle.

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ int popc4(uint4 v) {
    return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// popcount(src[0..t) & mask[0..t)) over the warp, src/mask 16-byte
// aligned when VEC; mask may be a constant word instead (c != 0 => src is
// the filter tile and c the word). Every lane returns its partial sum.
template <bool VEC>
__device__ __forceinline__ int tile_and_count(const uint32_t* src,
                                              const uint32_t* mask,
                                              uint32_t c, int t, int lane) {
    int s = 0;
    if (VEC) {
        const uint4* s4 = reinterpret_cast<const uint4*>(src);
        const uint4* m4 = reinterpret_cast<const uint4*>(mask);
        for (int i = lane; i < (t >> 2); i += 32) {
            uint4 v = __ldg(s4 + i);
            if (m4 != nullptr) {
                const uint4 m = __ldg(m4 + i);
                v.x &= m.x; v.y &= m.y; v.z &= m.z; v.w &= m.w;
            } else {
                v.x &= c; v.y &= c; v.z &= c; v.w &= c;
            }
            s += popc4(v);
        }
    } else {
        for (int i = lane; i < t; i += 32)
            s += __popc(__ldg(src + i) & (mask != nullptr ? __ldg(mask + i) : c));
    }
    return s;
}

__device__ __forceinline__ int warp_sum(int s) {
    for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
    return s;
}

template <bool VEC, bool FILTERED>
__global__ void ctile_count_kernel(const uint32_t* __restrict__ payload,
                                   const int* __restrict__ prow,
                                   const int* __restrict__ ptile,
                                   const uint32_t* __restrict__ filt,
                                   const uint32_t* __restrict__ konst,
                                   long long n_entries, int t, int n_tiles,
                                   int rows, int* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const long long n_const = (long long)rows * n_tiles;
    const long long items = n_entries + (n_const + 31) / 32;
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    for (long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
         w < items; w += warps) {
        if (w < n_entries) {  // a payload entry; every branch warp-uniform
            const int row = __ldg(prow + w);
            if (row < 0 || row >= rows) continue;
            const uint32_t* f = nullptr;
            if (FILTERED) {
                const int tile = __ldg(ptile + w);
                if (tile < 0 || tile >= n_tiles) continue;
                f = filt + (long long)tile * t;
            }
            const int s = warp_sum(tile_and_count<VEC>(
                payload + w * (long long)t, f, 0xffffffffu, t, lane));
            if (lane == 0 && s != 0) atomicAdd(out + row, s);
            continue;
        }
        // 32 constants of the row-major [rows, n_tiles] table
        const long long e = (w - n_entries) * 32 + lane;
        const uint32_t c = e < n_const ? __ldg(konst + e) : 0u;
        if (!FILTERED) {
            if (c != 0) atomicAdd(out + e / n_tiles, __popc(c) * t);
            continue;
        }
        unsigned live = __ballot_sync(0xffffffffu, c != 0);
        while (live != 0) {
            const int k = __ffs(live) - 1;
            live &= live - 1;
            const long long ek = (w - n_entries) * 32 + k;
            const uint32_t ck = __shfl_sync(0xffffffffu, c, k);
            const int s = warp_sum(tile_and_count<VEC>(
                filt + (ek % n_tiles) * t, nullptr, ck, t, lane));
            if (lane == 0 && s != 0) atomicAdd(out + ek / n_tiles, s);
        }
    }
}

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

template <bool VEC, bool FILTERED>
static void launch(const uint32_t* payload, const int* prow, const int* ptile,
                   const uint32_t* filt, const uint32_t* konst,
                   long long n_entries, int t, int n_tiles, int rows, int* out,
                   cudaStream_t stream) {
    const int threads = 256;  // 8 warps, one work item each per step
    const long long n_const = (long long)rows * n_tiles;
    const long long items = n_entries + (n_const + 31) / 32;
    long long blocks = (items * 32 + threads - 1) / threads;
    const long long cap = 16LL * sm_count();
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    ctile_count_kernel<VEC, FILTERED><<<(unsigned)blocks, threads, 0, stream>>>(
        payload, prow, ptile, filt, konst, n_entries, t, n_tiles, rows, out);
}

extern "C" {

// payload int32[P, T] (bit patterns), prow/ptile int32[P], filt
// int32[n_tiles, T] or nullptr, konst int32[rows, n_tiles], out
// int32[rows] zeroed by the caller. Returns cudaGetLastError() after
// the launch.
int pk_ctile_count(const void* payload, const int* prow, const int* ptile,
                   const void* filt, const void* konst, int n_entries, int t,
                   int n_tiles, int rows, int* out, void* stream) {
    const uint32_t* pl = static_cast<const uint32_t*>(payload);
    const uint32_t* fl = static_cast<const uint32_t*>(filt);
    const uint32_t* kl = static_cast<const uint32_t*>(konst);
    const bool vec = (t % 4 == 0)
        && ((uintptr_t)pl % 16 == 0)
        && (fl == nullptr || (uintptr_t)fl % 16 == 0);
    cudaStream_t s = (cudaStream_t)stream;
    if (fl != nullptr) {
        if (vec) launch<true, true>(pl, prow, ptile, fl, kl, n_entries, t, n_tiles, rows, out, s);
        else launch<false, true>(pl, prow, ptile, fl, kl, n_entries, t, n_tiles, rows, out, s);
    } else {
        if (vec) launch<true, false>(pl, prow, ptile, fl, kl, n_entries, t, n_tiles, rows, out, s);
        else launch<false, false>(pl, prow, ptile, fl, kl, n_entries, t, n_tiles, rows, out, s);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
