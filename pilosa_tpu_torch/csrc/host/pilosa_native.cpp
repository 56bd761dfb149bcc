// Host-side bitmap kernels for the pilosa_tpu_torch runtime (a copy of
// native/pilosa_native.cpp, so the port builds from its own sources).
//
// The device compute path is PyTorch plus the CUDA kernels under csrc/;
// this is the NATIVE half of the runtime around it — the host operations
// that sit between the wire and the device and that the reference
// implements in compiled Go's hot loops (roaring container
// scatter/gather, roaring/roaring.go:2380 ImportRoaringBits; popcount
// loops :711). numpy's ufunc.at scatter is an order of magnitude slower
// than this; pilosa_tpu_torch/native.py loads this via ctypes and falls
// back to numpy when the host toolchain is absent.
//
// ABI: plain C, uint32 little-endian word planes (the same layout the
// device kernels consume; shardwidth.py).

#include <cstdint>
#include <cstddef>

extern "C" {

// Set bit `cols[i]` in the plane for every i. Duplicates are fine.
void scatter_bits(uint32_t *plane, const int64_t *cols, size_t n) {
    for (size_t i = 0; i < n; i++) {
        const uint64_t c = static_cast<uint64_t>(cols[i]);
        plane[c >> 5] |= (1u << (c & 31u));
    }
}

// out[i] = bit `cols[i]` of the plane (0/1): the changed-bit gather of
// bulk imports (fragment.go:1498 bulkImport's changed accounting).
void gather_bits(const uint32_t *plane, const int64_t *cols, uint8_t *out,
                 size_t n) {
    for (size_t i = 0; i < n; i++) {
        const uint64_t c = static_cast<uint64_t>(cols[i]);
        out[i] = (plane[c >> 5] >> (c & 31u)) & 1u;
    }
}

// Count bits not yet set, then set them: one fused pass over the bulk
// import's columns (gather+scatter without the intermediate array).
int64_t scatter_new_bits(uint32_t *plane, const int64_t *cols, size_t n) {
    int64_t changed = 0;
    for (size_t i = 0; i < n; i++) {
        const uint64_t c = static_cast<uint64_t>(cols[i]);
        const uint32_t mask = 1u << (c & 31u);
        uint32_t *w = plane + (c >> 5);
        changed += (*w & mask) == 0;
        *w |= mask;
    }
    return changed;
}

// Total popcount of a word plane (roaring/roaring.go:711 loops).
int64_t popcount_words(const uint32_t *plane, size_t n_words) {
    int64_t total = 0;
    for (size_t i = 0; i < n_words; i++) {
        total += __builtin_popcount(plane[i]);
    }
    return total;
}

// AND two planes and popcount the result without materializing it
// (IntersectionCount, roaring/roaring.go:711).
int64_t and_popcount(const uint32_t *a, const uint32_t *b, size_t n_words) {
    int64_t total = 0;
    for (size_t i = 0; i < n_words; i++) {
        total += __builtin_popcount(a[i] & b[i]);
    }
    return total;
}

// Positions of set bits, appended to out; returns the count. Caller
// sizes out via popcount_words (roaring Slice / result materialization).
int64_t plane_to_bits(const uint32_t *plane, size_t n_words, uint64_t *out) {
    int64_t k = 0;
    for (size_t i = 0; i < n_words; i++) {
        uint32_t w = plane[i];
        while (w) {
            const int b = __builtin_ctz(w);
            out[k++] = (static_cast<uint64_t>(i) << 5) | b;
            w &= w - 1;
        }
    }
    return k;
}

}  // extern "C"
