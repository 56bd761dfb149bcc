// tape_count: popcount of an op tape's result plane in one pass.
//
// Replaces pilosa_tpu/ops/bitmap.py:209 _popcount_sum_kernel and :224
// plane_count_pallas_traced, the count terminal selected by
// pilosa_tpu/parallel/mesh.py:315-327 compile_tape_count. On the TPU, XLA
// fused the tape's AND/OR/XOR/ANDNOT ops and the shard mask into the
// Pallas popcount pass; PyTorch eager would make one pass through device
// memory per op. This kernel takes the whole tape as data instead: up to
// 32 leaf pointers plus the (op, i, j) list, passed by value in a small
// struct, so one launch reads each leaf word once, evaluates the tape in
// registers, masks, popcounts with __popc and reduces.
//
// Bound on the H100: bytes. It reads (leaves + mask) x n_words x 4 B and
// does a few integer ops per word; at the main path's widths (2-4 leaves
// of 196,608 words) the bytes take about a microsecond at 3.35 TB/s, so
// the launch itself dominates. Design: a grid-stride loop over words
// (coalesced 4-byte loads, one word per thread per step), a warp-shuffle
// and shared-memory block reduction, and one atomicAdd per block into an
// int32 the wrapper zeroed.

#include <cstdint>
#include <cuda_runtime.h>

#define PK_MAX_LEAVES 32
#define PK_MAX_OPS 64

enum { PK_AND = 0, PK_OR = 1, PK_XOR = 2, PK_ANDNOT = 3 };

struct TapeDesc {
    const uint32_t* leaves[PK_MAX_LEAVES];
    const uint32_t* mask;  // nullptr: unmasked
    int n_leaves;
    int n_ops;  // >= 1; the last register is the result
    uint8_t op[PK_MAX_OPS];
    uint8_t a[PK_MAX_OPS];
    uint8_t b[PK_MAX_OPS];
};

__device__ __forceinline__ uint32_t tape_word(const TapeDesc& t, long long w) {
    uint32_t regs[PK_MAX_LEAVES + PK_MAX_OPS];
    for (int i = 0; i < t.n_leaves; ++i) regs[i] = __ldg(t.leaves[i] + w);
    for (int k = 0; k < t.n_ops; ++k) {
        const uint32_t x = regs[t.a[k]];
        const uint32_t y = regs[t.b[k]];
        uint32_t r;
        switch (t.op[k]) {
            case PK_AND: r = x & y; break;
            case PK_OR: r = x | y; break;
            case PK_XOR: r = x ^ y; break;
            default: r = x & ~y; break;
        }
        regs[t.n_leaves + k] = r;
    }
    uint32_t out = regs[t.n_leaves + t.n_ops - 1];
    if (t.mask != nullptr) out &= __ldg(t.mask + w);
    return out;
}

__global__ void tape_count_kernel(const TapeDesc t, long long n_words,
                                  int* __restrict__ out) {
    int local = 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         w < n_words; w += stride) {
        local += __popc(tape_word(t, w));
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
        if (lane == 0 && s != 0) atomicAdd(out, s);
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

// out: one int32 on the device, zeroed by the caller. Returns
// cudaGetLastError() after the launch.
int pk_tape_count(const TapeDesc* desc, long long n_words, int* out,
                  void* stream) {
    const int threads = 256;
    long long blocks = (n_words + threads - 1) / threads;
    const long long cap = 8LL * sm_count();
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    tape_count_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        *desc, n_words, out);
    return (int)cudaGetLastError();
}

const char* pk_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
