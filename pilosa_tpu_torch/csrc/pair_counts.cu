// pair_counts: C[i, j] = popcount(A_i & B_j) over the word axis, exact
// int32.
//
// Replaces pilosa_tpu/ops/groupby.py:98 _pallas_kernel, :116
// _pair_counts_traced and :153 _pair_counts_pallas: GroupBy's pair
// counts, TopN's per-row counts with A = the filter (or all-ones) plane
// (pilosa_tpu/ops/topk.py:39), BSI Sum's sign classes against the
// magnitude planes and GroupBy's Sum aggregates. The TPU kernel expanded
// every word into 32 int8 lanes for the MXU; here the tensor cores take
// the packed words as they are: mma.sync.m16n8k256 .b1 .and.popc does
// 16 x 8 x 256 bit pairs (AND, then popcount) per instruction.
//
// Bound on the H100: the bytes, at every shape the port runs. At the
// GroupBy shape (8 x 256 x 196,608 words) 207.6 MB take 0.0620 ms at
// 3.35 TB/s, while 2 operations per bit pair at the 1,979 TOP/s int8 rate
// take 0.0130 ms; on the SIMT cores the same work is held to __popc at
// 16 a clock per SM (0.0963 ms). TopN (1 x 256 x 196,608) and BSI Sum
// (2 x 20 x 327,680) are bytes-bound the more.
//
// Design. M = 16 rows of B, N = 8 rows of A, K = 256 bits (8 words). Lane
// (g, q) of a warp loads words [k + 8q, +8) of B rows g and g + 8 and of
// A row g with 16-byte loads (four lanes read one 128-byte line of a row)
// and issues four mmas; the contraction axis only has to be permuted the
// same way on both operands, so the words go from the loads straight into
// the fragments. A block of 8 warps owns 8 x NG rows of A (NG = 1-8,
// rows past r1 load as 0), 16 x MG rows of B and a slice of the word axis
// (blocks numbered on grid x alone, so r1 and r2 are not bounded by
// gridDim.y); partial counts meet in shared memory, then one atomicAdd
// per output per block into the int32 output the wrapper zeroed: integer
// adds, exact in any order, and a count is at most 32 x w (the wrapper
// refuses w >= 2^26). The wrapper (ops/groupby.py _plan) swaps A and B
// when A is the wider side (out strides si, sj) and picks the tile and
// the number of slices from the shapes.
//
// Chosen by measurement (pilosa_tpu_torch/probes/pair_counts_probe.py,
// PERF.md): at the GroupBy shape this loop beat bits expanded to int8 for
// mma.sync s8, a SIMT AND + __popc loop and a SIMT carry-save count; at
// the TopN and Sum shapes it matched or beat a SIMT kernel that keeps
// the counts of 1-2 A rows x 8-16 B rows in registers.
//
// 16-byte loads need 16-byte aligned rows (w % 4 == 0 and an aligned
// base); views such as planes[OFFSET:] at odd w take the VEC = 1
// instantiation, which reads the same words with guarded scalar loads.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_timing.cuh"

#define PC_THREADS 256
#define PC_WARPS (PC_THREADS / 32)

// Words [k, k + 4) of a row, 0 past hi: one 16-byte load (VEC 4: the row
// and k are 16-byte aligned and hi % 4 == 0) or four guarded scalar loads.
template <int VEC>
__device__ __forceinline__ uint4 load4(const uint32_t* row, long long k,
                                       long long hi) {
    if (VEC == 4)
        return k < hi ? __ldg(reinterpret_cast<const uint4*>(row + k))
                      : make_uint4(0u, 0u, 0u, 0u);
    uint4 v;
    v.x = k < hi ? __ldg(row + k) : 0u;
    v.y = k + 1 < hi ? __ldg(row + k + 1) : 0u;
    v.z = k + 2 < hi ? __ldg(row + k + 2) : 0u;
    v.w = k + 3 < hi ? __ldg(row + k + 3) : 0u;
    return v;
}

// The block's tile: rows [i0, i0 + ta) of A, [j0, j0 + tb) of B, words
// [lo, hi). blockIdx.x = (A tile * n_jt + B tile) * slices + slice.
struct Tile {
    int i0, j0;
    long long lo, hi;
};

__device__ __forceinline__ Tile tile_of(int ta, int tb, int n_jt,
                                        long long slice, int slices,
                                        long long w) {
    long long bid = blockIdx.x;
    const int s = (int)(bid % slices);
    bid /= slices;
    Tile t;
    t.j0 = (int)(bid % n_jt) * tb;
    t.i0 = (int)(bid / n_jt) * ta;
    t.lo = (long long)s * slice;
    t.hi = t.lo + slice < w ? t.lo + slice : w;
    return t;
}

// One atomicAdd per non-zero output of the block; red[i * tb + j].
__device__ __forceinline__ void flush(const int* red, int ta, int tb,
                                      const Tile& t, int r1, int r2,
                                      long long si, long long sj, int* out) {
    __syncthreads();
    for (int e = threadIdx.x; e < ta * tb; e += PC_THREADS) {
        const int i = e / tb, j = e % tb;
        const int v = red[e];
        if (v != 0 && t.i0 + i < r1 && t.j0 + j < r2)
            atomicAdd(out + (long long)(t.i0 + i) * si +
                          (long long)(t.j0 + j) * sj, v);
    }
}

__device__ __forceinline__ void mma_b1(int* c, uint4 hi_row, uint4 lo_row,
                                       uint32_t b0, uint32_t b1, bool zw) {
    // zw: words .z/.w of the fragments, else .x/.y
    const uint32_t a0 = zw ? hi_row.z : hi_row.x;
    const uint32_t a1 = zw ? lo_row.z : lo_row.x;
    const uint32_t a2 = zw ? hi_row.w : hi_row.y;
    const uint32_t a3 = zw ? lo_row.w : lo_row.y;
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// MG groups of 16 B rows x NG groups of 8 A rows per block. Fragments of
// m16n8k256 .b1 (PTX ISA): a0/a2 row g, a1/a3 row g + 8, a0/a1 on the
// first 128 bits of K and a2/a3 on the second; b0/b1 likewise for column
// g; c0/c1 at (g, 2q), (g, 2q + 1), c2/c3 at (g + 8, ...), with lane =
// 4g + q. Lane q's K-slots of a mma's first and second 128 bits hold words
// k + 8q + 2p and + 1 (p = the mma's index, 0-3) of every row, on both
// operands.
template <int MG, int NG, int VEC>
__global__ void __launch_bounds__(PC_THREADS)
pc_b1(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
      int r1, int r2, long long w, long long slice, int slices, int n_jt,
      long long si, long long sj, int* __restrict__ out, const PkTiming clk) {
    pk_clock_start(clk);
    constexpr int TA = 8 * NG, TB = 16 * MG;
    __shared__ int red[TA * TB];
    for (int e = threadIdx.x; e < TA * TB; e += PC_THREADS) red[e] = 0;
    __syncthreads();
    const Tile t = tile_of(TA, TB, n_jt, slice, slices, w);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, q = lane & 3;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    int acc[MG][NG][4];
#pragma unroll
    for (int m = 0; m < MG; ++m)
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;
    // mma.sync needs the whole warp: the loop bound is the warp's chunk,
    // and words of a lane past hi load as 0
#pragma unroll 2
    for (long long kc = t.lo + 32 * warp; kc < t.hi; kc += 32 * PC_WARPS) {
        const long long k = kc + 8 * q;
        uint4 a0[NG], a1[NG], h0[MG], h1[MG], l0[MG], l1[MG];
#pragma unroll
        for (int n = 0; n < NG; ++n) {
            const int i = t.i0 + 8 * n + g;
            const uint32_t* row = a + (long long)i * w;
            a0[n] = i < r1 ? load4<VEC>(row, k, t.hi) : zero;
            a1[n] = i < r1 ? load4<VEC>(row, k + 4, t.hi) : zero;
        }
#pragma unroll
        for (int m = 0; m < MG; ++m) {
            const int jh = t.j0 + 16 * m + g, jl = jh + 8;
            const uint32_t* rh = b + (long long)jh * w;
            const uint32_t* rl = b + (long long)jl * w;
            h0[m] = jh < r2 ? load4<VEC>(rh, k, t.hi) : zero;
            h1[m] = jh < r2 ? load4<VEC>(rh, k + 4, t.hi) : zero;
            l0[m] = jl < r2 ? load4<VEC>(rl, k, t.hi) : zero;
            l1[m] = jl < r2 ? load4<VEC>(rl, k + 4, t.hi) : zero;
        }
#pragma unroll
        for (int m = 0; m < MG; ++m)
#pragma unroll
            for (int n = 0; n < NG; ++n) {
                mma_b1(acc[m][n], h0[m], l0[m], a0[n].x, a0[n].y, false);
                mma_b1(acc[m][n], h0[m], l0[m], a0[n].z, a0[n].w, true);
                mma_b1(acc[m][n], h1[m], l1[m], a1[n].x, a1[n].y, false);
                mma_b1(acc[m][n], h1[m], l1[m], a1[n].z, a1[n].w, true);
            }
    }
    // acc[m][n][e] counts A row 8n + 2q + (e & 1) against B row
    // 16m + g + 8 (e >> 1) of the tile
#pragma unroll
    for (int m = 0; m < MG; ++m)
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (acc[m][n][e] != 0)
                    atomicAdd(&red[(8 * n + 2 * q + (e & 1)) * TB + 16 * m +
                                   g + 8 * (e >> 1)],
                              acc[m][n][e]);
    flush(red, TA, TB, t, r1, r2, si, sj, out);
    pk_clock_stop(clk);
}

// Grid of a (ta x tb) tiling of [r1, r2] with slices of `slice` words;
// 0 when it does not fit grid x.
static unsigned grid_x(int r1, int r2, long long w, int ta, int tb,
                       long long slice, int* slices, int* n_jt) {
    if (r1 <= 0 || r2 <= 0 || w <= 0 || slice <= 0) return 0;
    const long long s = (w + slice - 1) / slice;
    const long long jt = (r2 + tb - 1) / tb;
    const long long blocks = (long long)((r1 + ta - 1) / ta) * jt * s;
    if (blocks > 0x7fffffffLL) return 0;
    *slices = (int)s;
    *n_jt = (int)jt;
    return (unsigned)blocks;
}

typedef void (*pc_kernel_t)(const uint32_t*, const uint32_t*, int, int,
                            long long, long long, int, int, long long,
                            long long, int*, PkTiming);

template <int MG, int NG>
static pc_kernel_t b1_inst(int vec) {
    return vec == 4 ? pc_b1<MG, NG, 4> : pc_b1<MG, NG, 1>;
}

template <int MG>
static pc_kernel_t b1_pick(int ng, int vec) {
    switch (ng) {
    case 1: return b1_inst<MG, 1>(vec);
    case 2: return b1_inst<MG, 2>(vec);
    case 3: return b1_inst<MG, 3>(vec);
    case 4: return b1_inst<MG, 4>(vec);
    case 5: return b1_inst<MG, 5>(vec);
    case 6: return b1_inst<MG, 6>(vec);
    case 7: return b1_inst<MG, 7>(vec);
    case 8: return b1_inst<MG, 8>(vec);
    default: return nullptr;
    }
}

extern "C" {

// a [r1, w], b [r2, w] row-major words; C[i, j] goes to out[i * si +
// j * sj], int32, zeroed by the caller; ta (8, 16, ..., 64) rows of a x tb
// (16 or 32) rows of b and `slice` words per block; vec 4 (16-byte loads)
// or 1. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a tile or grid it has no kernel for. timing:
// the device profiler's (launch_timing.cuh) or nullptr.
int pk_pair_counts(const uint32_t* a, const uint32_t* b, int r1, int r2,
                   long long w, int ta, int tb, int vec, long long slice,
                   long long si, long long sj, int* out, void* stream,
                   const PkTiming* timing) {
    const int ng = ta / 8;
    pc_kernel_t k = ta % 8 != 0 ? nullptr
                  : tb == 16 ? b1_pick<1>(ng, vec)
                  : tb == 32 ? b1_pick<2>(ng, vec) : nullptr;
    int slices = 0, n_jt = 0;
    const unsigned blocks = grid_x(r1, r2, w, ta, tb, slice, &slices, &n_jt);
    if (k == nullptr || blocks == 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    k<<<blocks, PC_THREADS, 0, s>>>(
        a, b, r1, r2, w, slice, slices, n_jt, si, sj, out, pk_clock(timing));
    return (int)cudaGetLastError();
}

}  // extern "C"
