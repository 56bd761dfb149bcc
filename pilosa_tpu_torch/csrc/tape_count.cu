// tape_count: popcount of an op tape's result plane in one pass.
//
// Replaces pilosa_tpu/ops/bitmap.py:209 _popcount_sum_kernel and :224
// plane_count_pallas_traced, the count terminal selected by
// pilosa_tpu/parallel/mesh.py:315-327 compile_tape_count. On the TPU, XLA
// fused the tape's AND/OR/XOR/ANDNOT ops and the shard mask into the
// Pallas popcount pass; PyTorch eager would make one pass through device
// memory per op. This kernel takes the whole tape as data instead: up to
// 32 leaf pointers plus the (op, i, j) list, passed by value (480 bytes,
// which cost no device time in probes/launch_probe.py), so one launch
// reads each leaf word once, evaluates the tape, masks, popcounts and
// reduces.
//
// Bound on the H100: bytes. It reads (leaves + mask) x n_words x 4 B and
// does a few integer ops per word. At the main path's widths (1-4 leaves
// of 196,608-327,680 words) the bytes take 0.2-2 us at 3.35 TB/s, so the
// launch, the round trip to memory and the reduction across blocks set
// the time. The design cuts each of them:
//
// - A grid of about one wave over every SM (the launcher sizes it from
//   the SM count), two elements of every leaf in flight per thread.
// - A one-op tape (a Count of two rows, every count of the BSI walks:
//   every tape the main paths issue) takes a path of its own. The
//   launcher passes it the op's operands as its leaves, so it loads them,
//   applies the op and counts in registers with 16-byte loads (uint4):
//   no op loop, no register file and no local memory. Longer tapes (up to 32 leaves and 64 ops) take
//   the general path, one 32-bit word at a time with the registers in
//   local memory.
// - 16-byte loads need every leaf and the mask at the same offset modulo
//   16 bytes: the launcher peels a scalar head (0-3 words) to reach the
//   boundary and a scalar tail (0-3 words) past the last vector. Leaves
//   at different offsets (row views of a 2-D stack at odd widths) take
//   the same one-op path on 32-bit words.
// - One pass across blocks with no zeroed output (count_finish.cuh):
//   each block adds its sum and a ticket to one 64-bit word in one
//   atomic, and the block that draws the last ticket writes the total and
//   zeroes the word for the next launch on the stream. The caller's
//   output is uninitialised memory, so a count is one device operation.

#include <cstdint>
#include <cuda_runtime.h>

#include "count_finish.cuh"
#include "launch_timing.cuh"

#define PK_MAX_LEAVES 32
#define PK_MAX_OPS 64
#define THREADS 128

enum { PK_AND = 0, PK_OR = 1, PK_XOR = 2, PK_ANDNOT = 3 };

// The op list, encoded once per tape by the wrapper.
struct TapeOps {
    int n_leaves;
    int n_ops;  // >= 1; the last register is the result
    uint8_t op[PK_MAX_OPS];
    uint8_t a[PK_MAX_OPS];
    uint8_t b[PK_MAX_OPS];
};

// What a kernel is passed by value.
struct TapeDesc {
    const uint32_t* leaves[PK_MAX_LEAVES];
    const uint32_t* mask;  // nullptr: unmasked
    int n_leaves, n_ops;
    int last_op, last_a, last_b;  // the last op, at fixed offsets
    uint8_t op[PK_MAX_OPS], a[PK_MAX_OPS], b[PK_MAX_OPS];
};

// -- uint32 / uint4 elements ---------------------------------------------------

__device__ __forceinline__ uint32_t v_zero(uint32_t) { return 0u; }
__device__ __forceinline__ uint32_t v_ones(uint32_t) { return ~0u; }
__device__ __forceinline__ uint4 v_zero(uint4) { return make_uint4(0, 0, 0, 0); }
__device__ __forceinline__ uint4 v_ones(uint4) {
    return make_uint4(~0u, ~0u, ~0u, ~0u);
}

__device__ __forceinline__ uint32_t v_apply(int op, uint32_t x, uint32_t y) {
    return op == PK_AND ? x & y : op == PK_OR ? x | y
         : op == PK_XOR ? x ^ y : x & ~y;
}

// An op as the masks of its three minterms, x & y, x & ~y and ~x & y:
// AND keeps the first, OR all three, XOR the last two, ANDNOT the second.
struct OpMasks {
    uint32_t xy, x_ny, nx_y;
};

__device__ __forceinline__ OpMasks op_masks(int op) {
    return {0u - (uint32_t)(op == PK_AND || op == PK_OR),
            0u - (uint32_t)(op != PK_AND),
            0u - (uint32_t)(op == PK_OR || op == PK_XOR)};
}

__device__ __forceinline__ uint32_t apply(const OpMasks& o, uint32_t x,
                                          uint32_t y) {
    return (x & y & o.xy) | (x & ~y & o.x_ny) | (~x & y & o.nx_y);
}

__device__ __forceinline__ uint4 apply(const OpMasks& o, uint4 x, uint4 y) {
    return make_uint4(apply(o, x.x, y.x), apply(o, x.y, y.y),
                      apply(o, x.z, y.z), apply(o, x.w, y.w));
}

__device__ __forceinline__ int v_popc(uint32_t x) { return __popc(x); }
__device__ __forceinline__ int v_popc(uint4 x) {
    return __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
}

__device__ __forceinline__ uint32_t v_and(uint32_t x, uint32_t y) {
    return x & y;
}
__device__ __forceinline__ uint4 v_and(uint4 x, uint4 y) {
    return make_uint4(x.x & y.x, x.y & y.y, x.z & y.z, x.w & y.w);
}

// popcount(op(x, y) & mask) of a one-op tape over E elements (of type V)
// of every operand, the operands seen as arrays of V from word `base`; an
// element that is not live counts 0. The launcher passes the op's
// operands as leaves 0 and 1, or as leaf 0 alone when they are one leaf,
// so nothing is selected and there is no op loop.
template <typename V, int E>
__device__ __forceinline__ int count_one_op(const TapeDesc& t,
                                            long long base,
                                            const long long (&e)[E],
                                            const bool (&live)[E]) {
    V x[E], y[E], m[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
        x[j] = y[j] = m[j] = v_zero(V());
        if (live[j]) {
            x[j] = __ldg(reinterpret_cast<const V*>(t.leaves[0] + base)
                         + e[j]);
            if (t.n_leaves > 1)
                y[j] = __ldg(reinterpret_cast<const V*>(t.leaves[1] + base)
                             + e[j]);
            m[j] = t.mask != nullptr
                ? __ldg(reinterpret_cast<const V*>(t.mask + base) + e[j])
                : v_ones(V());
        }
    }
    const OpMasks o = op_masks(t.last_op);
    int s = 0;
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const V r = apply(o, x[j], t.n_leaves > 1 ? y[j] : x[j]);
        s += v_popc(v_and(r, m[j]));
    }
    return s;
}

// -- the one-op path ----------------------------------------------------------

// popcount of the masked one-op tape over elements [0, n) of type V from
// word `base`, two elements per thread in flight, grid-stride.
template <typename V>
__device__ __forceinline__ int one_op_range(const TapeDesc& t, long long base,
                                            long long n) {
    const long long stride = (long long)gridDim.x * THREADS;
    int local = 0;
    for (long long e0 = (long long)blockIdx.x * THREADS + threadIdx.x; e0 < n;
         e0 += 2 * stride) {
        const long long e[2] = {e0, e0 + stride};
        const bool live[2] = {true, e0 + stride < n};
        local += count_one_op<V, 2>(t, base, e, live);
    }
    return local;
}

// VEC: words [head, head + 4 n_vec) as n_vec uint4, the words before and
// after them (at most 3 each) one per thread of block 0. Not VEC: every
// word as a uint32.
template <bool VEC>
__global__ void __launch_bounds__(THREADS) tape_one_op_kernel(
        const __grid_constant__ TapeDesc t, int head, long long n_vec,
        long long n_words, unsigned long long* __restrict__ acc,
        int* __restrict__ out, const PkTiming clk) {
    pk_clock_start(clk);
    int local;
    if (VEC) {
        local = one_op_range<uint4>(t, head, n_vec);
        const long long edge = n_words - 4 * n_vec;  // head + tail words
        if (blockIdx.x == 0 && threadIdx.x < edge) {
            const long long e[1] = {(int)threadIdx.x < head
                                    ? threadIdx.x : threadIdx.x + 4 * n_vec};
            const bool live[1] = {true};
            local += count_one_op<uint32_t, 1>(t, 0, e, live);
        }
    } else {
        local = one_op_range<uint32_t>(t, 0, n_words);
    }
    finish<THREADS>(local, acc, out);
    pk_clock_stop(clk);
}

// -- the general path ----------------------------------------------------------

__device__ __forceinline__ uint32_t tape_word(const TapeDesc& t, long long w) {
    uint32_t regs[PK_MAX_LEAVES + PK_MAX_OPS];
    for (int i = 0; i < t.n_leaves; ++i) regs[i] = __ldg(t.leaves[i] + w);
    for (int k = 0; k < t.n_ops; ++k)
        regs[t.n_leaves + k] = v_apply(t.op[k], regs[t.a[k]], regs[t.b[k]]);
    uint32_t out = regs[t.n_leaves + t.n_ops - 1];
    if (t.mask != nullptr) out &= __ldg(t.mask + w);
    return out;
}

__global__ void __launch_bounds__(THREADS) tape_general_kernel(
        const __grid_constant__ TapeDesc t, long long n_words,
        unsigned long long* __restrict__ acc, int* __restrict__ out,
        const PkTiming clk) {
    pk_clock_start(clk);
    int local = 0;
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long w = (long long)blockIdx.x * THREADS + threadIdx.x;
         w < n_words; w += stride)
        local += __popc(tape_word(t, w));
    finish<THREADS>(local, acc, out);
    pk_clock_stop(clk);
}

// Blocks for `elems` elements at two per thread: at most four per SM
// (512 threads), at least one.
static unsigned grid_for(long long elems) {
    long long blocks = (elems + 2 * THREADS - 1) / (2 * THREADS);
    const long long cap = 4LL * sm_count();
    if (blocks > cap) blocks = cap;
    return blocks < 1 ? 1u : (unsigned)blocks;
}

// The descriptor of `ops` over n leaf pointers and the mask.
static TapeDesc describe(const TapeOps& ops, const void* const* leaves,
                         int n, const void* mask) {
    TapeDesc t;
    for (int i = 0; i < PK_MAX_LEAVES; ++i)
        t.leaves[i] = i < n ? static_cast<const uint32_t*>(leaves[i])
                            : nullptr;
    t.mask = static_cast<const uint32_t*>(mask);
    t.n_leaves = n;
    t.n_ops = ops.n_ops;
    t.last_op = ops.op[ops.n_ops - 1];
    t.last_a = ops.a[ops.n_ops - 1];
    t.last_b = ops.b[ops.n_ops - 1];
    for (int k = 0; k < PK_MAX_OPS; ++k) {
        t.op[k] = ops.op[k];
        t.a[k] = ops.a[k];
        t.b[k] = ops.b[k];
    }
    return t;
}

extern "C" {

// ops: the encoded tape; leaves: ops->n_leaves device pointers; mask:
// a device pointer or nullptr. A one-op tape takes the one-op path, any
// other the general path. out: one int32 on the device, written, never
// read; acc: one 64-bit word on the device, zero (each launch leaves it
// so). Launches on `stream` of `device` and returns cudaGetLastError().
// timing: the device profiler's (launch_timing.cuh) or nullptr.
int pk_tape_count(const TapeOps* ops, const void* const* leaves,
                  const void* mask, long long n_words, int* out,
                  void* acc_ptr, int device, void* stream,
                  const PkTiming* timing) {
    unsigned long long* acc = static_cast<unsigned long long*>(acc_ptr);
    int cur = device;
    cudaGetDevice(&cur);
    if (cur != device) cudaSetDevice(device);
    cudaStream_t s = (cudaStream_t)stream;
    const PkTiming clk = pk_clock(timing);
    if (ops->n_ops == 1) {
        // passed its operands (one leaf when a == b)
        const int a = ops->a[0], b = ops->b[0];
        const void* ab[2] = {leaves[a], leaves[b]};
        const TapeDesc t = describe(*ops, ab, a == b ? 1 : 2, mask);
        // one offset modulo 16 bytes for every operand -> 16-byte body
        const uintptr_t off = (uintptr_t)t.leaves[0] & 15u;
        bool same = off % 4 == 0;
        for (int i = 1; i < t.n_leaves; ++i)
            same = same && ((uintptr_t)t.leaves[i] & 15u) == off;
        if (mask != nullptr) same = same && ((uintptr_t)mask & 15u) == off;
        const int head = (int)(((16 - off) & 15u) / 4);
        if (same && n_words >= head + 4) {
            const long long n_vec = (n_words - head) / 4;
            tape_one_op_kernel<true><<<grid_for(n_vec), THREADS, 0, s>>>(
                t, head, n_vec, n_words, acc, out, clk);
        } else {
            tape_one_op_kernel<false><<<grid_for(n_words), THREADS, 0, s>>>(
                t, 0, 0, n_words, acc, out, clk);
        }
    } else {
        const TapeDesc t = describe(*ops, leaves, ops->n_leaves, mask);
        tape_general_kernel<<<grid_for(n_words), THREADS, 0, s>>>(
            t, n_words, acc, out, clk);
    }
    const int rc = (int)cudaGetLastError();
    if (cur != device) cudaSetDevice(cur);
    return rc;
}

const char* pk_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
