// pair_counts: C[i, j] = popcount(A_i & B_j) over the word axis, exact
// int32.
//
// Replaces pilosa_tpu/ops/groupby.py:98 _pallas_kernel, :116
// _pair_counts_traced and :153 _pair_counts_pallas: GroupBy's pair
// counts, and TopN's per-row counts with A = the filter (or all-ones)
// plane (pilosa_tpu/ops/topk.py:39). The TPU kernel expanded every word
// into 32 int8 lanes to reach the MXU; here AND + __popc on the SIMT
// cores does the same arithmetic on packed words, and the TPU's 512x256
// tiling and 128-row cap (groupby.py:41-43) do not apply.
//
// Bound on the H100: at the GroupBy shape (8 x 196,608 words against a
// 256-row block) it is the __popc rate — 8 x 256 x 196,608 popcounts at
// 16 a clock per SM (NVIDIA's arithmetic instruction throughput table for
// compute capability 9.0); for TopN (one A row) it is the bytes of B.
// Design: a block owns TA rows of A x 128 rows of B (one B row per thread,
// TA int32 accumulators in registers) and a slice of the word axis. Each step
// stages 32 words of every row in shared memory with coalesced 128-byte
// loads (B padded to 33 words a row, so neither the stores nor the
// per-thread reads conflict on banks); A's words are broadcast reads. The
// output tile alone would fill a handful of the 132 SMs, so the word axis
// is split across blocks (grid z) and the partial counts are combined
// with atomicAdd into an int32 output the wrapper zeroed: integer adds,
// so the result stays exact whatever the order.

#include <cstdint>
#include <cuda_runtime.h>

#define PK_TB 128  // B rows per block == threads per block
#define PK_KW 32   // words per shared-memory stage

template <int TA>
__global__ void __launch_bounds__(PK_TB)
pair_counts_kernel(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b, int r1, int r2,
                   long long w, long long w_per_split,
                   int* __restrict__ out) {
    __shared__ uint32_t sa[TA][PK_KW];
    __shared__ uint32_t sb[PK_TB][PK_KW + 1];
    const int j0 = blockIdx.x * PK_TB;
    const int i0 = blockIdx.y * TA;
    const long long wlo = (long long)blockIdx.z * w_per_split;
    long long whi = wlo + w_per_split;
    if (whi > w) whi = w;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = PK_TB / 32;

    int acc[TA];
#pragma unroll
    for (int i = 0; i < TA; ++i) acc[i] = 0;

    for (long long k0 = wlo; k0 < whi; k0 += PK_KW) {
        const long long k = k0 + lane;
        const bool in_w = k < whi;
        for (int r = warp; r < PK_TB; r += n_warps) {
            const int jr = j0 + r;
            sb[r][lane] = (in_w && jr < r2) ? __ldg(b + (long long)jr * w + k)
                                            : 0u;
        }
        for (int r = warp; r < TA; r += n_warps) {
            const int ir = i0 + r;
            sa[r][lane] = (in_w && ir < r1) ? __ldg(a + (long long)ir * w + k)
                                            : 0u;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < PK_KW; ++kk) {
            const uint32_t bw = sb[threadIdx.x][kk];
#pragma unroll
            for (int i = 0; i < TA; ++i) acc[i] += __popc(sa[i][kk] & bw);
        }
        __syncthreads();
    }

    const int j = j0 + threadIdx.x;
    if (j < r2) {
#pragma unroll
        for (int i = 0; i < TA; ++i) {
            if (i0 + i < r1 && acc[i] != 0)
                atomicAdd(out + (long long)(i0 + i) * r2 + j, acc[i]);
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

extern "C" {

// a: [r1, w], b: [r2, w] row-major words; out: [r1, r2] int32 zeroed by
// the caller. Returns cudaGetLastError() after the launch.
int pk_pair_counts(const uint32_t* a, const uint32_t* b, int r1, int r2,
                   long long w, int* out, void* stream) {
    const int ta = (r1 == 1) ? 1 : 8;
    const long long gx = (r2 + PK_TB - 1) / PK_TB;
    const long long gy = (r1 + ta - 1) / ta;
    // split the word axis until there are about 4 blocks per SM
    const long long target = 4LL * sm_count();
    long long splits = (target + gx * gy - 1) / (gx * gy);
    const long long stages = (w + PK_KW - 1) / PK_KW;
    if (splits > stages) splits = stages;
    if (splits < 1) splits = 1;
    long long per = (w + splits - 1) / splits;
    per = (per + PK_KW - 1) / PK_KW * PK_KW;
    splits = (w + per - 1) / per;
    dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)splits);
    cudaStream_t s = (cudaStream_t)stream;
    if (ta == 1) {
        pair_counts_kernel<1><<<grid, PK_TB, 0, s>>>(a, b, r1, r2, w, per,
                                                     out);
    } else {
        pair_counts_kernel<8><<<grid, PK_TB, 0, s>>>(a, b, r1, r2, w, per,
                                                     out);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
