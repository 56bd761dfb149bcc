// Kernels of the launch probe (launch_probe.py): an empty kernel, and a
// trivial count over two planes, popcount(a & b), that reads 2 x n words
// with 16-byte loads. The count takes its threads per block and its
// vectors in flight per thread as template arguments, and finishes in one
// of three ways: FINISH 0, one atomicAdd per block into an output the
// caller zeroed; 1, each block writes its partial sum and the last block
// to take a ticket (after a fence) sums the partials, writes the result
// and resets the ticket; 2, each block adds its sum and a ticket to one
// 64-bit word in one atomic, and the block that draws the last ticket
// writes the total from the returned word and zeroes it. The _padded
// kernels also take a 480-byte parameter they never read, the size of
// tape_count's general-path descriptor, to show what passing it costs.

#include <cstdint>
#include <cuda_runtime.h>

__global__ void probe_empty() {}

__device__ __forceinline__ int popc4(uint4 v) {
    return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

template <int THREADS>
__device__ __forceinline__ int block_sum(int v) {
    __shared__ int warp_sums[THREADS / 32];
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();  // warp_sums may still be read by an earlier call
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    v = lane < THREADS / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;  // every thread holds the block's sum
}

template <int THREADS, int V, int FINISH>
__device__ __forceinline__ void read_body(
        const uint4* __restrict__ a, const uint4* __restrict__ b,
        long long n_vec, int* __restrict__ partials,
        unsigned* __restrict__ ticket, unsigned long long* __restrict__ acc,
        int* __restrict__ out) {
    const long long stride = (long long)gridDim.x * THREADS;
    int local = 0;
    for (long long base = (long long)blockIdx.x * THREADS + threadIdx.x;
         base < n_vec; base += V * stride) {
        uint4 x[V], y[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
            const long long v = base + i * stride;
            x[i] = v < n_vec ? __ldg(a + v) : make_uint4(0, 0, 0, 0);
            y[i] = v < n_vec ? __ldg(b + v) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int i = 0; i < V; ++i) {
            x[i].x &= y[i].x; x[i].y &= y[i].y;
            x[i].z &= y[i].z; x[i].w &= y[i].w;
            local += popc4(x[i]);
        }
    }
    const int s = block_sum<THREADS>(local);
    if (FINISH == 0) {
        if (threadIdx.x == 0 && s != 0) atomicAdd(out, s);
        return;
    }
    if (FINISH == 2) {
        if (threadIdx.x == 0) {
            const unsigned long long old =
                atomicAdd(acc, (1ull << 40) | (unsigned long long)(unsigned)s);
            if ((old >> 40) == gridDim.x - 1u) {
                *out = (int)((old & ((1ull << 40) - 1)) + (unsigned)s);
                *acc = 0;
            }
        }
        return;
    }
    __shared__ bool last;
    if (threadIdx.x == 0) {
        partials[blockIdx.x] = s;
        __threadfence();
        last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    int v = 0;
    for (int i = threadIdx.x; i < (int)gridDim.x; i += THREADS)
        v += __ldcg(partials + i);
    v = block_sum<THREADS>(v);
    if (threadIdx.x == 0) {
        *out = v;
        *ticket = 0;
    }
}

template <int THREADS, int V, int FINISH>
__global__ void __launch_bounds__(THREADS) probe_read(
        const uint4* __restrict__ a, const uint4* __restrict__ b,
        long long n_vec, int* __restrict__ partials,
        unsigned* __restrict__ ticket, unsigned long long* __restrict__ acc,
        int* __restrict__ out) {
    read_body<THREADS, V, FINISH>(a, b, n_vec, partials, ticket, acc, out);
}

struct Pad {
    unsigned long long w[60];
};

__global__ void probe_empty_padded(const __grid_constant__ Pad) {}

__global__ void __launch_bounds__(128) probe_read_padded(
        const __grid_constant__ Pad, const uint4* __restrict__ a,
        const uint4* __restrict__ b, long long n_vec,
        unsigned long long* __restrict__ acc, int* __restrict__ out) {
    read_body<128, 2, 2>(a, b, n_vec, nullptr, nullptr, acc, out);
}

// scratch: the 64-bit word of FINISH 2, then the ticket and partials of
// FINISH 1
template <int THREADS, int V, int FINISH>
static void launch_read(const void* a, const void* b, long long n_vec,
                        int blocks, int* scratch, int* out, cudaStream_t s) {
    probe_read<THREADS, V, FINISH><<<blocks, THREADS, 0, s>>>(
        static_cast<const uint4*>(a), static_cast<const uint4*>(b), n_vec,
        scratch + 3, reinterpret_cast<unsigned*>(scratch + 2),
        reinterpret_cast<unsigned long long*>(scratch), out);
}

template <int THREADS, int FINISH>
static int by_v(int v, const void* a, const void* b, long long n_vec,
                int blocks, int* scratch, int* out, cudaStream_t s) {
    switch (v) {
        case 1: launch_read<THREADS, 1, FINISH>(a, b, n_vec, blocks, scratch, out, s); return 0;
        case 2: launch_read<THREADS, 2, FINISH>(a, b, n_vec, blocks, scratch, out, s); return 0;
        case 4: launch_read<THREADS, 4, FINISH>(a, b, n_vec, blocks, scratch, out, s); return 0;
        default: return -1;
    }
}

template <int THREADS>
static int by_finish(int finish, int v, const void* a, const void* b,
                     long long n_vec, int blocks, int* scratch, int* out,
                     cudaStream_t s) {
    switch (finish) {
        case 0: return by_v<THREADS, 0>(v, a, b, n_vec, blocks, scratch, out, s);
        case 1: return by_v<THREADS, 1>(v, a, b, n_vec, blocks, scratch, out, s);
        case 2: return by_v<THREADS, 2>(v, a, b, n_vec, blocks, scratch, out, s);
        default: return -1;
    }
}

extern "C" {

int probe_empty_launch(int blocks, int threads, void* stream) {
    probe_empty<<<blocks, threads, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

int probe_empty_padded_launch(int blocks, int threads, void* stream) {
    probe_empty_padded<<<blocks, threads, 0, (cudaStream_t)stream>>>(Pad{});
    return (int)cudaGetLastError();
}

// The count at 128 threads x 2 vectors, packed finish, with the pad;
// scratch as for probe_read_launch.
int probe_read_padded_launch(const void* a, const void* b, long long n_vec,
                             int blocks, int* scratch, int* out,
                             void* stream) {
    probe_read_padded<<<blocks, 128, 0, (cudaStream_t)stream>>>(
        Pad{}, static_cast<const uint4*>(a), static_cast<const uint4*>(b),
        n_vec, reinterpret_cast<unsigned long long*>(scratch), out);
    return (int)cudaGetLastError();
}

// scratch: int32[3 + blocks], 8-byte aligned, its first three words zero
// before the first launch (each one-pass launch leaves them so); out:
// int32[1], zeroed by the caller when finish is 0.
int probe_read_launch(int threads, int v, int finish, const void* a,
                      const void* b, long long n_vec, int blocks,
                      int* scratch, int* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int rc;
    if (threads == 128)
        rc = by_finish<128>(finish, v, a, b, n_vec, blocks, scratch, out, s);
    else if (threads == 256)
        rc = by_finish<256>(finish, v, a, b, n_vec, blocks, scratch, out, s);
    else
        rc = -1;
    if (rc != 0) return 1;  // cudaErrorInvalidValue
    return (int)cudaGetLastError();
}

}  // extern "C"
