// The one-level tile body of the polyphase streamed single levels of
// streamed.cu (B7/B9), and the halos of the two-level bodies (HALO2, IH2,
// IH1) that fused2l.cuh and the volume kernels share.
//
// The body is split into a load and a compute step, so that a kernel that
// streams strips through two buffers loads strip i+1 with cp.async while it
// lifts strip i: the loads are cp.async copies of one element (4 or 8
// bytes) into shared memory that the caller commits and waits for.
//
// Tiles start at even global rows and columns (see lifting.cuh).  Reads go
// through whole-point mirror indices, which equal the reference's signal
// mirror fills forward and its channel-domain border rules inverse
// (row-low bands whole-point at the head and repeat at the tail, row-high
// bands the reverse: streamed.py _fix_strip).
#pragma once

#include <cuda_pipeline.h>

#include "lifting.cuh"

namespace tiles {

constexpr int HALO = 4;    // one level: signal halo of 4 lifting steps
constexpr int HALO2 = 12;  // two levels forward: halo on both axes (signal samples)
constexpr int IH2 = 8;     // two levels inverse: level-2 halo (LL1 samples)
constexpr int IH1 = 4;     // two levels inverse: level-1 halo (signal samples)

template <typename T>
__device__ __forceinline__ void copy_elem(T* dst, const T* src) {
    __pipeline_memcpy_async(dst, src, sizeof(T));
}

// Address of the interleaved coefficient sample at (in-range) global
// position (y, x) of a level of width w (see band_at in lifting.cuh).
template <typename T>
__device__ __forceinline__ const T* band_ptr(const T* ll, const T* hl, const T* lh,
                                             const T* hh, int y, int x, int w) {
    const int cw = (w + 1) >> 1, fw = w >> 1;
    const int r = y >> 1, c = x >> 1;
    if (y & 1) return (x & 1) ? hh + r * fw + c : lh + r * cw + c;
    return (x & 1) ? hl + r * fw + c : ll + r * cw + c;
}

// ------------------------------------------------------------ one level

// A one-level tile: ty x tx samples (both even) with a halo of HALO on
// both axes, (ty + 8) x (tx + 8) elements.
__host__ __device__ __forceinline__ int lvl1_elems(int ty, int tx) {
    return (ty + 2 * HALO) * (tx + 2 * HALO);
}

// Forward load of the tile of an h x w image at (y0, x0) through mirror
// reads.  EXT > 0: x carries a caller extension of EXT rows above and
// below the image (h + 2*EXT rows), read straight with no row mirror, and
// rows past it read as 0 (they reach only outputs past the image).  EXT is
// 8 for the streamed single level (B7).
template <int EXT, typename T>
__device__ void fwd1_load(const T* x, T* s, int h, int w, int y0, int x0, int ty,
                          int tx) {
    const int EX = tx + 2 * HALO, n = (ty + 2 * HALO) * EX;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int r = i / EX, c = i % EX;
        const int cx = mirror_idx(x0 - HALO + c, w);
        if constexpr (EXT > 0) {
            // signal row y0 - HALO + r is row y0 - HALO + r + EXT of x
            const int q = y0 - HALO + EXT + r;
            if (q < h + 2 * EXT)
                copy_elem(s + i, x + (size_t)q * w + cx);
            else
                s[i] = T(0);
        } else {
            copy_elem(s + i, x + (size_t)mirror_idx(y0 - HALO + r, h) * w + cx);
        }
    }
}

// Lift a loaded forward tile: rows, columns, scale -> its ty x tx samples
// into the four bands.  Ends with a barrier, so the caller may reuse ``s``.
template <typename T>
__device__ void fwd1_compute(T* s, T* ll, T* hl, T* lh, T* hh, int h, int w, int y0,
                             int x0, int ty, int tx, const LiftParams& P) {
    const int EY = ty + 2 * HALO, EX = tx + 2 * HALO;
    lift_tile(s, EY, EX, EX, P, true);
    lift_tile(s, EY, EX, EX, P, false);
    scale_tile(s, EY, EX, EX, P);
    for (int i = threadIdx.x; i < ty * tx; i += blockDim.x) {
        const int gy = y0 + i / tx, gx = x0 + i % tx;
        if (gy < h && gx < w)
            band_put(ll, hl, lh, hh, gy, gx, w, s[(HALO + i / tx) * EX + HALO + i % tx]);
    }
    __syncthreads();
}

// Inverse load: the interleaved coefficient tile read through the mirror.
// EXT > 0: every band carries EXT caller channel rows above and below, so
// the extended interleaved image has h + 4*EXT rows and signal row p is
// its row p + 2*EXT; rows past it read as 0.
template <int EXT, typename T>
__device__ void inv1_load(const T* ll, const T* hl, const T* lh, const T* hh, T* s,
                          int h, int w, int y0, int x0, int ty, int tx) {
    const int EX = tx + 2 * HALO, n = (ty + 2 * HALO) * EX;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int r = i / EX, c = i % EX;
        const int cx = mirror_idx(x0 - HALO + c, w);
        if constexpr (EXT > 0) {
            const int q = y0 - HALO + 2 * EXT + r;
            if (q < h + 4 * EXT)
                copy_elem(s + i, band_ptr(ll, hl, lh, hh, q, cx, w));
            else
                s[i] = T(0);
        } else {
            copy_elem(s + i, band_ptr(ll, hl, lh, hh, mirror_idx(y0 - HALO + r, h),
                                             cx, w));
        }
    }
}

// Scale, inverse columns, rows -> the tile's ty x tx outputs.  Ends with a
// barrier.
template <typename T>
__device__ void inv1_compute(T* s, T* out, int h, int w, int y0, int x0, int ty, int tx,
                             const LiftParams& P) {
    const int EY = ty + 2 * HALO, EX = tx + 2 * HALO;
    scale_tile(s, EY, EX, EX, P);
    lift_tile(s, EY, EX, EX, P, false);
    lift_tile(s, EY, EX, EX, P, true);
    for (int i = threadIdx.x; i < ty * tx; i += blockDim.x) {
        const int gy = y0 + i / tx, gx = x0 + i % tx;
        if (gy < h && gx < w)
            out[(size_t)gy * w + gx] = s[(HALO + i / tx) * EX + HALO + i % tx];
    }
    __syncthreads();
}

}  // namespace tiles
