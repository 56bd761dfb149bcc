// bsi_compare: signed bit-sliced compare of a BSI plane stack against one
// constant (EQ/NE/LT/LE/GT/GE) or two (BETWEEN), EXISTS-masked.
//
// Replaces pilosa_tpu/ops/bsi.py:138 _compare_pallas_body and :197
// _compare_pallas, the Range-leaf circuit of every Row(v <op> c). The stack
// is [2 + depth, w] row-major words: row 0 exists, row 1 sign, rows 2.. the
// magnitude bits LSB-first. For each word the circuit walks the magnitude
// planes MSB->LSB, keeping lt/eq/gt for both sign classes (and both
// BETWEEN sides), then selects by the constant's sign and the op. The
// TPU's 512-word block pad and 8-row sublane pad were Mosaic artifacts:
// this kernel takes any w >= 1 and depth 1..64 and reads nothing past w.
//
// Bound on the H100: bytes. It reads (2 + depth) * w * 4 bytes once and
// writes w * 4 bytes; the bitwise work is about 6 logic ops per plane per
// word and side, well under the 64 32-bit logic results per clock per SM
// the card retires. Design: one thread owns one word (grid-stride loop);
// consecutive threads read consecutive words of one plane row, so every
// load coalesces, and the lt/eq/gt registers never leave the thread. The
// predicate constants come by value in BsiDesc (the bits as one uint64 per
// side, plus overflow and neg flags), so there is no per-query
// host-to-device copy, and every branch on a constant bit is uniform
// across the grid: no warp diverges.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_timing.cuh"

enum { PK_EQ = 0, PK_NE = 1, PK_LT = 2, PK_LE = 3, PK_GT = 4, PK_GE = 5,
       PK_BETWEEN = 6 };

struct BsiSide {
    unsigned long long bits;  // |c| LSB-first, the low `depth` bits
    int overflow;             // |c| >= 2^depth
    int neg;                  // c < 0
};

struct BsiDesc {
    const uint32_t* planes;  // [2 + depth, w]
    uint32_t* out;           // [w]
    long long w;
    int depth;  // 1..64
    int op;
    BsiSide side[2];  // side[1] is read only by BETWEEN
};

// lt/eq/gt of the stored values against one signed constant, per word.
struct Partition {
    uint32_t plt, peq, pgt;  // positive class, by magnitude
    uint32_t nlt, neq, ngt;  // negative class, by magnitude
};

__device__ __forceinline__ void mag_step(Partition& p, uint32_t pk, bool bit) {
    if (bit) {
        p.plt |= p.peq & ~pk;
        p.peq &= pk;
        p.nlt |= p.neq & ~pk;
        p.neq &= pk;
    } else {
        p.pgt |= p.peq & pk;
        p.peq &= ~pk;
        p.ngt |= p.neq & pk;
        p.neq &= ~pk;
    }
}

// Signed (lt, eq, gt) from the per-class magnitude walk (bsi.py:165-172).
__device__ __forceinline__ void signed_partition(
        const Partition& p, const BsiSide& s, uint32_t pos_rows,
        uint32_t neg_rows, uint32_t& lt, uint32_t& eq, uint32_t& gt) {
    uint32_t plt = p.plt, peq = p.peq, pgt = p.pgt;
    uint32_t nlt = p.nlt, neq = p.neq, ngt = p.ngt;
    if (s.overflow) {  // every candidate's magnitude is below |c|
        plt = pos_rows; peq = 0u; pgt = 0u;
        nlt = neg_rows; neq = 0u; ngt = 0u;
    }
    if (s.neg) {
        lt = ngt;
        eq = neq;
        gt = pos_rows | nlt;
    } else {
        lt = neg_rows | plt;
        eq = peq;
        gt = pgt;
    }
}

template <bool BETWEEN>
__global__ void bsi_compare_kernel(const BsiDesc d, const PkTiming clk) {
    pk_clock_start(clk);
    const long long w = d.w;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const unsigned long long b0 = d.side[0].bits;
    const unsigned long long b1 = d.side[1].bits;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < w; i += stride) {
        const uint32_t exists = __ldg(d.planes + i);
        const uint32_t sign = __ldg(d.planes + w + i);
        const uint32_t neg_rows = exists & sign;
        const uint32_t pos_rows = exists & ~sign;
        Partition p0 = {0u, pos_rows, 0u, 0u, neg_rows, 0u};
        Partition p1 = p0;
        const uint32_t* mag = d.planes + 2 * w + i;
        for (int k = d.depth - 1; k >= 0; --k) {
            const uint32_t pk = __ldg(mag + (long long)k * w);
            mag_step(p0, pk, (b0 >> k) & 1ull);
            if (BETWEEN) mag_step(p1, pk, (b1 >> k) & 1ull);
        }
        uint32_t lt, eq, gt, out;
        signed_partition(p0, d.side[0], pos_rows, neg_rows, lt, eq, gt);
        if (BETWEEN) {
            uint32_t lt2, eq2, gt2;
            signed_partition(p1, d.side[1], pos_rows, neg_rows, lt2, eq2,
                             gt2);
            out = (gt | eq) & (lt2 | eq2);
        } else {
            switch (d.op) {
                case PK_EQ: out = eq; break;
                case PK_NE: out = exists & ~eq; break;
                case PK_LT: out = lt; break;
                case PK_LE: out = lt | eq; break;
                case PK_GT: out = gt; break;
                default: out = gt | eq; break;  // PK_GE
            }
        }
        d.out[i] = out;
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

extern "C" {

// Every word of desc->out is written. Returns cudaGetLastError() after the
// launch; an op outside PK_EQ..PK_BETWEEN is cudaErrorInvalidValue.
// timing: the device profiler's (launch_timing.cuh) or nullptr.
int pk_bsi_compare(const BsiDesc* desc, void* stream,
                   const PkTiming* timing) {
    if (desc->op < PK_EQ || desc->op > PK_BETWEEN || desc->depth < 1 ||
        desc->depth > 64 || desc->w < 1)
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    long long blocks = (desc->w + threads - 1) / threads;
    const long long cap = 16LL * sm_count();
    if (blocks > cap) blocks = cap;
    cudaStream_t s = (cudaStream_t)stream;
    const PkTiming clk = pk_clock(timing);
    if (desc->op == PK_BETWEEN) {
        bsi_compare_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(*desc,
                                                                      clk);
    } else {
        bsi_compare_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(*desc,
                                                                       clk);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
