// Probe for the pair_counts redesign: three inner loops for
// C[i, j] = popcount(A_i & B_j) at the GroupBy shape (8 A rows against a
// wide B), each fed straight from device memory with 16-byte loads.
//
//   b1_wide   (a) mma.sync m16n8k256 .b1 .and.popc on packed words:
//             M = 16 B rows, N = the 8 A rows, K = 8 words per mma.
//   s8_wide   (b) bits expanded to int8 in registers (a nibble times
//             0x00204081, masked to 0x01010101), mma.sync m16n8k32 s8:
//             one word of every row per mma.
//   simt_wide (c) SIMT: AND + __popc per word, or (CSA) a carry-save
//             count of 8 words with LOP3 (xor3 / majority) and 5 __popc
//             in place of 8.
//   simt_tile (d) for 1-2 A rows (TopN, BSI Sum): each thread walks its
//             own 4-word positions with one 16-byte load per row and
//             keeps TA x TB counts in registers; a warp sums them by
//             transposition (31 shuffles per 32 counts), warps meet in
//             shared memory, one atomicAdd per output per block.
//
// Not part of the port's build: pair_counts_probe.py compiles it alone.
// Shapes it takes: w a multiple of 256 words, 16-byte aligned rows.

#include <cstdint>
#include <cuda_runtime.h>

#define WARPS 8

__device__ __forceinline__ uint32_t xor3(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}

__device__ __forceinline__ uint32_t maj3(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm("lop3.b32 %0, %1, %2, %3, 0xE8;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}

// popcount of 8 words through a carry-save tree: 8 LOP3, 5 __popc
__device__ __forceinline__ int popc8_csa(const uint32_t* x) {
    const uint32_t s1 = xor3(x[0], x[1], x[2]), c1 = maj3(x[0], x[1], x[2]);
    const uint32_t s2 = xor3(x[3], x[4], x[5]), c2 = maj3(x[3], x[4], x[5]);
    const uint32_t s3 = xor3(s1, s2, x[6]), c3 = maj3(s1, s2, x[6]);
    const uint32_t s4 = xor3(c1, c2, c3), c4 = maj3(c1, c2, c3);
    return __popc(s3) + __popc(x[7]) + 2 * (__popc(s4) + 2 * __popc(c4));
}

__device__ __forceinline__ uint4 ld4(const uint32_t* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void words8(uint32_t* x, uint4 lo, uint4 hi) {
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

// block: the slice [blockIdx.x * slice, +slice) of the word axis; B tile
// blockIdx.y, A tile blockIdx.z. Partial counts meet in shared memory,
// then one atomicAdd per output per block.
template <int NA, int NB>
__device__ __forceinline__ void flush(int (*red)[NB], int i0, int j0, int r1,
                                      int r2, int* out) {
    __syncthreads();
    for (int e = threadIdx.x; e < NA * NB; e += blockDim.x) {
        const int i = e / NB, j = e % NB;
        const int v = red[i][j];
        if (v != 0 && i0 + i < r1 && j0 + j < r2)
            atomicAdd(out + (long long)(i0 + i) * r2 + j0 + j, v);
    }
}

template <int NA, int NB>
__device__ __forceinline__ void zero_red(int (*red)[NB]) {
    for (int e = threadIdx.x; e < NA * NB; e += blockDim.x)
        red[e / NB][e % NB] = 0;
    __syncthreads();
}

// (c) lane (r, q): words [k + 8q, +8) of B rows j0 + 8g + r, g < NGB
template <int TA, int NGB, bool CSA>
__global__ void __launch_bounds__(32 * WARPS)
simt_wide(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
          int r1, int r2, long long w, long long slice, int* __restrict__ out) {
    __shared__ int red[TA][8 * NGB];
    zero_red<TA, 8 * NGB>(red);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int r = lane >> 2, q = lane & 3;
    const int i0 = blockIdx.z * TA, j0 = blockIdx.y * 8 * NGB;
    const long long lo = blockIdx.x * slice;
    long long hi = lo + slice;
    if (hi > w) hi = w;
    int acc[TA][NGB];
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int g = 0; g < NGB; ++g) acc[i][g] = 0;
    for (long long k = lo + warp * 32 + 8 * q; k < hi; k += WARPS * 32) {
        uint32_t av[TA][8];
#pragma unroll
        for (int i = 0; i < TA; ++i) {
            if (i0 + i < r1) {
                const uint32_t* p = a + (long long)(i0 + i) * w + k;
                words8(av[i], ld4(p), ld4(p + 4));
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) av[i][e] = 0;
            }
        }
#pragma unroll
        for (int g = 0; g < NGB; ++g) {
            const int j = j0 + 8 * g + r;
            uint32_t bv[8];
            if (j < r2) {
                const uint32_t* p = b + (long long)j * w + k;
                words8(bv, ld4(p), ld4(p + 4));
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) bv[e] = 0;
            }
#pragma unroll
            for (int i = 0; i < TA; ++i) {
                uint32_t x[8];
#pragma unroll
                for (int e = 0; e < 8; ++e) x[e] = av[i][e] & bv[e];
                if (CSA) {
                    acc[i][g] += popc8_csa(x);
                } else {
#pragma unroll
                    for (int e = 0; e < 8; ++e) acc[i][g] += __popc(x[e]);
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int g = 0; g < NGB; ++g) {
            int v = acc[i][g];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (q == 0 && v != 0) atomicAdd(&red[i][8 * g + r], v);
        }
    flush<TA, 8 * NGB>(red, i0, j0, r1, r2, out);
}

__device__ __forceinline__ void mma_b1(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// C fragment of m16n8: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// with rows = B rows and columns = A rows.
template <int MG>
__device__ __forceinline__ void mma_out(int (*acc)[4], int (*red)[16 * MG],
                                        int g, int t) {
#pragma unroll
    for (int m = 0; m < MG; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (acc[m][e] != 0)
                atomicAdd(&red[2 * t + (e & 1)][16 * m + g + 8 * (e >> 1)],
                          acc[m][e]);
}

// (a) lane (g, t): words [k + 4t, +4) of B rows j0 + 16m + g and + 8, and
// of A row i0 + g; two mmas per 16 words.
template <int MG>
__global__ void __launch_bounds__(32 * WARPS)
b1_wide(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
        int r1, int r2, long long w, long long slice, int* __restrict__ out) {
    __shared__ int red[8][16 * MG];
    zero_red<8, 16 * MG>(red);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int i0 = blockIdx.z * 8, j0 = blockIdx.y * 16 * MG;
    const long long lo = blockIdx.x * slice;
    long long hi = lo + slice;
    if (hi > w) hi = w;
    int acc[MG][4];
#pragma unroll
    for (int m = 0; m < MG; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][e] = 0;
    const uint4 z = make_uint4(0, 0, 0, 0);
    for (long long k = lo + warp * 16 + 4 * t; k < hi; k += WARPS * 16) {
        const uint4 av = (i0 + g < r1) ? ld4(a + (long long)(i0 + g) * w + k)
                                       : z;
#pragma unroll
        for (int m = 0; m < MG; ++m) {
            const int jh = j0 + 16 * m + g, jl = jh + 8;
            const uint4 bh = jh < r2 ? ld4(b + (long long)jh * w + k) : z;
            const uint4 bl = jl < r2 ? ld4(b + (long long)jl * w + k) : z;
            mma_b1(acc[m], bh.x, bl.x, bh.y, bl.y, av.x, av.y);
            mma_b1(acc[m], bh.z, bl.z, bh.w, bl.w, av.z, av.w);
        }
    }
    mma_out<MG>(acc, red, g, t);
    flush<8, 16 * MG>(red, i0, j0, r1, r2, out);
}

// nibble n (4 bits) -> four bytes of 0/1, bit i in byte i
__device__ __forceinline__ uint32_t expand4(uint32_t n) {
    return (n * 0x00204081u) & 0x01010101u;
}

// (b) lane (g, t): words [k, +8) of its rows (the four t lanes share the
// address); k-slot 4t + i of a0/b0 is bit 8t + i of the word, 16 + 4t + i
// of a2/b1 is bit 8t + 4 + i: one mma per word.
template <int MG>
__global__ void __launch_bounds__(32 * WARPS)
s8_wide(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
        int r1, int r2, long long w, long long slice, int* __restrict__ out) {
    __shared__ int red[8][16 * MG];
    zero_red<8, 16 * MG>(red);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int i0 = blockIdx.z * 8, j0 = blockIdx.y * 16 * MG;
    const long long lo = blockIdx.x * slice;
    long long hi = lo + slice;
    if (hi > w) hi = w;
    int acc[MG][4];
#pragma unroll
    for (int m = 0; m < MG; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][e] = 0;
    const int sh = 8 * t;
    for (long long k = lo + warp * 8; k < hi; k += WARPS * 8) {
        uint32_t av[8];
        if (i0 + g < r1) {
            const uint32_t* p = a + (long long)(i0 + g) * w + k;
            words8(av, ld4(p), ld4(p + 4));
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) av[e] = 0;
        }
        uint32_t bx0[8], bx1[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            bx0[e] = expand4((av[e] >> sh) & 0xFu);
            bx1[e] = expand4((av[e] >> (sh + 4)) & 0xFu);
        }
#pragma unroll
        for (int m = 0; m < MG; ++m) {
            const int jh = j0 + 16 * m + g, jl = jh + 8;
            uint32_t hv[8], lv[8];
            if (jh < r2) {
                const uint32_t* p = b + (long long)jh * w + k;
                words8(hv, ld4(p), ld4(p + 4));
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) hv[e] = 0;
            }
            if (jl < r2) {
                const uint32_t* p = b + (long long)jl * w + k;
                words8(lv, ld4(p), ld4(p + 4));
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) lv[e] = 0;
            }
#pragma unroll
            for (int e = 0; e < 8; ++e)
                mma_s8(acc[m], expand4((hv[e] >> sh) & 0xFu),
                       expand4((lv[e] >> sh) & 0xFu),
                       expand4((hv[e] >> (sh + 4)) & 0xFu),
                       expand4((lv[e] >> (sh + 4)) & 0xFu), bx0[e], bx1[e]);
        }
    }
    mma_out<MG>(acc, red, g, t);
    flush<8, 16 * MG>(red, i0, j0, r1, r2, out);
}

__device__ __forceinline__ int popc4(uint4 x, uint4 y) {
    return __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
           __popc(x.w & y.w);
}

// One halving step of a warp's transposed sum: lanes with bit S set keep
// the upper half of v[0, 2S), the others the lower, and add the half
// their partner gives away.
template <int S>
__device__ __forceinline__ void halve(int* v, int lane) {
    const bool up = (lane & S) != 0;
#pragma unroll
    for (int k = 0; k < S; ++k) {
        const int give = up ? v[k] : v[k + S];
        const int keep = up ? v[k + S] : v[k];
        v[k] = keep + __shfl_xor_sync(0xffffffffu, give, S);
    }
}

// (d) block: A rows [blockIdx.z * TA, +TA) x B rows [blockIdx.y * TB,
// +TB) x words [blockIdx.x * slice, +slice)
template <int TA, int TB>
__global__ void __launch_bounds__(32 * WARPS)
simt_tile(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
          int r1, int r2, long long w, long long slice, int* __restrict__ out) {
    constexpr int NV = (TA * TB + 31) / 32 * 32;
    __shared__ int red[NV];
    for (int e = threadIdx.x; e < NV; e += 32 * WARPS) red[e] = 0;
    __syncthreads();
    const int i0 = blockIdx.z * TA, j0 = blockIdx.y * TB;
    const long long lo = blockIdx.x * slice;
    const long long hi = lo + slice < w ? lo + slice : w;
    const uint4 z = make_uint4(0, 0, 0, 0);
    int acc[NV];
#pragma unroll
    for (int e = 0; e < NV; ++e) acc[e] = 0;
    for (long long k = lo + 4 * threadIdx.x; k < hi; k += 4 * 32 * WARPS) {
        uint4 av[TA], bv[TB];
#pragma unroll
        for (int i = 0; i < TA; ++i)
            av[i] = i0 + i < r1 ? ld4(a + (long long)(i0 + i) * w + k) : z;
#pragma unroll
        for (int j = 0; j < TB; ++j)
            bv[j] = j0 + j < r2 ? ld4(b + (long long)(j0 + j) * w + k) : z;
#pragma unroll
        for (int i = 0; i < TA; ++i)
#pragma unroll
            for (int j = 0; j < TB; ++j) acc[i * TB + j] += popc4(av[i], bv[j]);
    }
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int c = 0; c < NV; c += 32) {
        int* v = acc + c;
        halve<16>(v, lane);
        halve<8>(v, lane);
        halve<4>(v, lane);
        halve<2>(v, lane);
        halve<1>(v, lane);
        if (v[0] != 0) atomicAdd(&red[c + lane], v[0]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < TA * TB; e += 32 * WARPS) {
        const int i = e / TB, j = e % TB;
        if (red[e] != 0 && i0 + i < r1 && j0 + j < r2)
            atomicAdd(out + (long long)(i0 + i) * r2 + j0 + j, red[e]);
    }
}

static dim3 grid_of(int r1, int r2, long long w, long long slice, int ta,
                    int tb) {
    return dim3((unsigned)((w + slice - 1) / slice),
                (unsigned)((r2 + tb - 1) / tb), (unsigned)((r1 + ta - 1) / ta));
}

extern "C" {

// variant: 0 simt popc, 1 simt csa, 2 b1 mma, 3 s8 mma. slice: words per
// block, a multiple of 256.
int probe_launch(int variant, const uint32_t* a, const uint32_t* b, int r1,
                 int r2, long long w, long long slice, int* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const dim3 blk(32 * WARPS);
    switch (variant) {
    case 0:
        simt_wide<8, 4, false><<<grid_of(r1, r2, w, slice, 8, 32), blk, 0, s>>>(
            a, b, r1, r2, w, slice, out);
        break;
    case 1:
        simt_wide<8, 4, true><<<grid_of(r1, r2, w, slice, 8, 32), blk, 0, s>>>(
            a, b, r1, r2, w, slice, out);
        break;
    case 2:
        b1_wide<2><<<grid_of(r1, r2, w, slice, 8, 32), blk, 0, s>>>(
            a, b, r1, r2, w, slice, out);
        break;
    case 3:
        s8_wide<2><<<grid_of(r1, r2, w, slice, 8, 32), blk, 0, s>>>(
            a, b, r1, r2, w, slice, out);
        break;
    default:
        return -1;
    }
    return (int)cudaGetLastError();
}

// (d) at ta x tb in {1, 2} x {8, 16}; slice: words per block, a multiple
// of 4.
int probe_tile(int ta, int tb, const uint32_t* a, const uint32_t* b, int r1,
               int r2, long long w, long long slice, int* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const dim3 grid = grid_of(r1, r2, w, slice, ta, tb), blk(32 * WARPS);
    if (ta == 1 && tb == 8)
        simt_tile<1, 8><<<grid, blk, 0, s>>>(a, b, r1, r2, w, slice, out);
    else if (ta == 1 && tb == 16)
        simt_tile<1, 16><<<grid, blk, 0, s>>>(a, b, r1, r2, w, slice, out);
    else if (ta == 2 && tb == 8)
        simt_tile<2, 8><<<grid, blk, 0, s>>>(a, b, r1, r2, w, slice, out);
    else if (ta == 2 && tb == 16)
        simt_tile<2, 16><<<grid, blk, 0, s>>>(a, b, r1, r2, w, slice, out);
    else
        return -1;
    return (int)cudaGetLastError();
}

}  // extern "C"
