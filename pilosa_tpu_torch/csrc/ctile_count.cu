// ctile_count: per-row popcounts of up to CT_MAX_BLOCKS compressed blocks
// of one stack, in one launch.
//
// Replaces pilosa_tpu/ops/ctiles.py:291 _ctile_count_body and :301
// _ctile_counts_pallas, with the XLA steps around them fused in: the
// filter mask (:342 _mask_payload) before the popcount, the per-row
// scatter-add (:348 _scatter_counts, mode="drop") after it, and the
// constant tiles' counts (:355 _const_counts_unfiltered, :362
// _const_counts_filtered) beside it. For each block, with `rows` rows
// written at out[out_off ...]:
//
//     out[row[p]] += popcount(payload[p, :] & filt[tile[p], :])   p < n_payload
//     out[r]      += popcount(c & filt[j, :])       (r, j, c) in the non-zero list
//
// Without a filter the payload counts alone, and a constant word c
// counts popcount(c) * T. Payload entries whose row is outside [0, rows),
// or, under a filter, whose tile is outside [0, n_tiles), are dropped.
// On the TPU the kernel wrote one count per payload entry, broadcast
// across the 128 lanes of an (8, 128) output block for Mosaic's layout,
// and XLA did the rest in separate passes, block by block.
//
// Bound on the H100: bytes. Each payload entry reads T words of payload
// and, under a filter, T words of its filter tile, with one __popc per
// word; each non-zero constant under a filter reads its filter tile. At
// the main path's sizes (2,789 entries of 512 words over the 10 blocks of
// a 2,406-row stack) that is about 6 MB, ~2 us at 3.35 TB/s, so the
// launch and the round trips to memory set the time. The design:
//
// - One launch for a stack's blocks: the wrapper passes each block's
//   pointers, sizes and output offset by value (CtBatch), and every warp
//   finds its block from the work items' running totals.
// - Only real entries get work: a block is passed its n_payload, not its
//   padded capacity.
// - One round trip before the data: a warp takes one entry and issues
//   its payload vectors, whose addresses need no index, beside the load
//   of the entry's row and tile; then the filter vectors. For T = 512 (ops/ctiles.TILE_WORDS) an unrolled instance
//   keeps a lane's 4 payload and 4 filter vectors in flight; other T
//   multiples of 4 loop over 16-byte loads, and a scalar loop takes the
//   rest and misaligned pointers.
// - Constants: zero constants cost nothing. The wrapper passes the list
//   of non-zero ones (row, tile, word), built with the block on the host;
//   under a filter each is a warp's work item like a payload entry,
//   without one 32 lanes of a warp take one each.
// - A warp sums its entry's count across its lanes and adds it to the
//   row with one atomicAdd; integer atomics make the result exact in any
//   order.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_timing.cuh"

#define CT_MAX_BLOCKS 16
#define CT_THREADS 256
#define FULL 0xffffffffu

struct CtBlock {
    const uint32_t* payload;  // [>= n_payload, t]
    const int* prow;          // [>= n_payload]
    const int* ptile;         // [>= n_payload]
    const int* nz;            // [3, n_nz]: rows, tiles, words
    long long n_payload;
    long long n_nz;
    int rows;
    int out_off;
};

struct CtBatch {
    CtBlock blk[CT_MAX_BLOCKS];
    long long item_end[CT_MAX_BLOCKS];  // work items through block b
    const uint32_t* filt;  // [n_tiles, t] or nullptr
    int n_blocks;
    int t;
    int n_tiles;
};

__device__ __forceinline__ int popc4(uint4 v) {
    return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ uint4 and4(uint4 v, uint4 m) {
    return make_uint4(v.x & m.x, v.y & m.y, v.z & m.z, v.w & m.w);
}

__device__ __forceinline__ int warp_sum(int s) {
    for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(FULL, s, off);
    return s;
}

// Adds a warp's count for `row` (warp-uniform).
__device__ __forceinline__ void flush(int acc, int row, int* o, int lane) {
    const int s = warp_sum(acc);
    if (lane == 0 && s != 0) atomicAdd(o + row, s);
}

// A lane's part of popcount(x & f) over a tile of t words, where x is the
// tile at `src` or, when src is nullptr, the constant word c; f is the
// filter tile or nullptr (all ones). MODE 2: t == 512, 16-byte aligned;
// 1: t % 4 == 0, 16-byte aligned; 0: anything.
template <int MODE>
__device__ __forceinline__ int tile_count(const uint32_t* src, uint32_t c,
                                          const uint32_t* f, int t,
                                          int lane) {
    int s = 0;
    if (MODE == 2) {
        uint4 v[4], m[4];
        const uint4* s4 = reinterpret_cast<const uint4*>(src);
        const uint4* f4 = reinterpret_cast<const uint4*>(f);
#pragma unroll
        for (int i = 0; i < 4; ++i)
            v[i] = src != nullptr ? __ldg(s4 + lane + 32 * i)
                                  : make_uint4(c, c, c, c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
            m[i] = f != nullptr ? __ldg(f4 + lane + 32 * i)
                                : make_uint4(FULL, FULL, FULL, FULL);
#pragma unroll
        for (int i = 0; i < 4; ++i) s += popc4(and4(v[i], m[i]));
    } else if (MODE == 1) {
        const uint4* s4 = reinterpret_cast<const uint4*>(src);
        const uint4* f4 = reinterpret_cast<const uint4*>(f);
        for (int i = lane; i < (t >> 2); i += 32) {
            const uint4 v = src != nullptr ? __ldg(s4 + i) : make_uint4(c, c, c, c);
            const uint4 m = f != nullptr ? __ldg(f4 + i)
                                         : make_uint4(FULL, FULL, FULL, FULL);
            s += popc4(and4(v, m));
        }
    } else {
        for (int i = lane; i < t; i += 32)
            s += __popc((src != nullptr ? __ldg(src + i) : c)
                        & (f != nullptr ? __ldg(f + i) : FULL));
    }
    return s;
}

// Payload entry e.
template <int MODE, bool FILTERED>
__device__ __forceinline__ void payload_item(const CtBatch& b,
                                             const CtBlock& B, long long e,
                                             int* o, int lane) {
    const uint32_t* src = B.payload + e * (long long)b.t;
    uint4 v[4];
    if (MODE == 2) {
        // the payload's vectors first: their addresses need no index, so
        // they fly beside the index loads
        const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = __ldg(s4 + lane + 32 * i);
    }
    const int row = __ldg(B.prow + e);
    const int tile = FILTERED ? __ldg(B.ptile + e) : 0;
    if (row < 0 || row >= B.rows) return;
    if (FILTERED && (tile < 0 || tile >= b.n_tiles)) return;
    int acc = 0;
    if (MODE == 2) {
        if (FILTERED) {
            const uint4* f4 = reinterpret_cast<const uint4*>(
                b.filt + (long long)tile * 512);
#pragma unroll
            for (int i = 0; i < 4; ++i)
                v[i] = and4(v[i], __ldg(f4 + lane + 32 * i));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc += popc4(v[i]);
    } else {
        acc = tile_count<MODE>(
            src, 0u, FILTERED ? b.filt + (long long)tile * b.t : nullptr,
            b.t, lane);
    }
    flush(acc, row, o, lane);
}

// Non-zero constant e, counted against its filter tile.
template <int MODE>
__device__ __forceinline__ void const_item_filtered(const CtBatch& b,
                                                    const CtBlock& B,
                                                    long long e, int* o,
                                                    int lane) {
    const int row = __ldg(B.nz + e);
    const int tile = __ldg(B.nz + B.n_nz + e);
    const uint32_t c = (uint32_t)__ldg(B.nz + 2 * B.n_nz + e);
    if (row < 0 || row >= B.rows || tile < 0 || tile >= b.n_tiles) return;
    flush(tile_count<MODE>(nullptr, c, b.filt + (long long)tile * b.t, b.t,
                           lane), row, o, lane);
}

// 32 non-zero constants from e0, one per lane: popcount(c) * T.
__device__ __forceinline__ void const_item_plain(const CtBatch& b,
                                                 const CtBlock& B,
                                                 long long e0, int* o,
                                                 int lane) {
    const long long e = e0 + lane;
    if (e >= B.n_nz) return;
    const int row = __ldg(B.nz + e);
    const uint32_t c = (uint32_t)__ldg(B.nz + 2 * B.n_nz + e);
    if (row >= 0 && row < B.rows && c != 0)
        atomicAdd(o + row, __popc(c) * b.t);
}

template <int MODE, bool FILTERED>
__global__ void __launch_bounds__(CT_THREADS) ctile_count_kernel(
        const __grid_constant__ CtBatch b, int* __restrict__ out,
        const PkTiming clk) {
    pk_clock_start(clk);
    const int lane = threadIdx.x & 31;
    const long long n_warps = (long long)gridDim.x * (CT_THREADS / 32);
    const long long total = b.item_end[b.n_blocks - 1];
    for (long long it = ((long long)blockIdx.x * CT_THREADS + threadIdx.x) >> 5;
         it < total; it += n_warps) {
        int k = 0;  // the item's block; every branch below is warp-uniform
        while (it >= b.item_end[k]) ++k;
        const CtBlock& B = b.blk[k];
        const long long local = it - (k > 0 ? b.item_end[k - 1] : 0);
        int* o = out + B.out_off;
        if (local < B.n_payload)
            payload_item<MODE, FILTERED>(b, B, local, o, lane);
        else if (FILTERED)
            const_item_filtered<MODE>(b, B, local - B.n_payload, o, lane);
        else
            const_item_plain(b, B, (local - B.n_payload) * 32, o, lane);
    }
    pk_clock_stop(clk);
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

template <int MODE, bool FILTERED>
static void launch(const CtBatch& b, unsigned blocks, int* out,
                   cudaStream_t s, const PkTiming& clk) {
    ctile_count_kernel<MODE, FILTERED><<<blocks, CT_THREADS, 0, s>>>(b, out,
                                                                    clk);
}

extern "C" {

// blocks: n_blocks x 8 int64 on the host, per block the device pointers
// payload, prow, ptile and nz, then n_payload, n_nz, rows and out_off.
// filt: int32[n_tiles, t] on the device or nullptr. out: int32 on the
// device, zeroed by the caller, out_off + rows long for every block.
// Launches on `stream` of `device` and returns cudaGetLastError().
// timing: the device profiler's (launch_timing.cuh) or nullptr.
int pk_ctile_count(const long long* blocks, int n_blocks, const void* filt,
                   int t, int n_tiles, int* out, int device, void* stream,
                   const PkTiming* timing) {
    if (n_blocks < 1 || n_blocks > CT_MAX_BLOCKS || t < 1)
        return (int)cudaErrorInvalidValue;
    int cur = device;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    const bool filtered = filt != nullptr;
    CtBatch b;
    b.filt = static_cast<const uint32_t*>(filt);
    b.n_blocks = n_blocks;
    b.t = t;
    b.n_tiles = n_tiles;
    bool aligned = t % 4 == 0 && (uintptr_t)filt % 16 == 0;
    for (int k = 0; k < n_blocks; ++k) {
        const long long* d = blocks + 8 * k;
        CtBlock& B = b.blk[k];
        B.payload = reinterpret_cast<const uint32_t*>(d[0]);
        B.prow = reinterpret_cast<const int*>(d[1]);
        B.ptile = reinterpret_cast<const int*>(d[2]);
        B.nz = reinterpret_cast<const int*>(d[3]);
        B.n_payload = d[4];
        B.n_nz = d[5];
        B.rows = (int)d[6];
        B.out_off = (int)d[7];
        aligned = aligned && (uintptr_t)B.payload % 16 == 0;
    }
    // a warp item: one payload entry, one filtered non-zero constant, or
    // 32 unfiltered ones
    long long items = 0;
    for (int k = 0; k < n_blocks; ++k) {
        const CtBlock& B = b.blk[k];
        items += B.n_payload + (filtered ? B.n_nz : (B.n_nz + 31) / 32);
        b.item_end[k] = items;
    }
    for (int k = n_blocks; k < CT_MAX_BLOCKS; ++k) b.item_end[k] = items;
    long long grid = (items + CT_THREADS / 32 - 1) / (CT_THREADS / 32);
    const long long cap = 8LL * sm_count();
    if (grid > cap) grid = cap;
    if (grid < 1) grid = 1;
    const int mode = !aligned ? 0 : t == 512 ? 2 : 1;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned g = (unsigned)grid;
    const PkTiming clk = pk_clock(timing);
    if (filtered) {
        if (mode == 2) launch<2, true>(b, g, out, s, clk);
        else if (mode == 1) launch<1, true>(b, g, out, s, clk);
        else launch<0, true>(b, g, out, s, clk);
    } else {
        if (mode == 2) launch<2, false>(b, g, out, s, clk);
        else if (mode == 1) launch<1, false>(b, g, out, s, clk);
        else launch<0, false>(b, g, out, s, clk);
    }
    const int rc = (int)cudaGetLastError();
    if (cur != device) cudaSetDevice(cur);
    return rc;
}

}  // extern "C"
