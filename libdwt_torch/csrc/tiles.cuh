// Tile bodies of the polyphase streamed strips of streamed.cu: one level
// (B7/B9) and two levels per pass (B8/B10).
//
// Each body is split into a load and a compute step, so that a kernel that
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
constexpr int HALO2 = 12;  // two levels forward: column halo (signal samples)
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

// ------------------------------------------------------------ two levels

// Forward tile of ty x tx signal samples (ty, tx % 4 == 0) with a halo of
// hy rows (>= 12) and HALO2 columns: (ty + 2hy) x (tx + 2*HALO2) elements.
// The LL1 tile (halo 4) takes (ty/2 + 8) x (tx/2 + 8) more.
__host__ __device__ __forceinline__ int fwd2_elems(int ty, int tx, int hy) {
    return (ty + 2 * hy) * (tx + 2 * HALO2);
}
__host__ __device__ __forceinline__ int fwd2_ll1_elems(int ty, int tx) {
    return (ty / 2 + 8) * (tx / 2 + 8);
}

template <typename T>
__device__ void fwd2_load(const T* x, T* s1, int h, int w, int y0, int x0, int ty,
                          int tx, int hy) {
    const int EX = tx + 2 * HALO2, n = (ty + 2 * hy) * EX;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int r = i / EX, c = i % EX;
        copy_elem(s1 + i, x + (size_t)mirror_idx(y0 - hy + r, h) * w
                                     + mirror_idx(x0 - HALO2 + c, w));
    }
}

// The polyphase 2-D lift of a whole window (rows x cols, row stride cols),
// in place: forward rows, columns, scale; inverse scale, columns, rows.
template <typename T>
__device__ void lift_fwd(T* s, int rows, int cols, const LiftParams& P) {
    lift_tile(s, rows, cols, cols, P, true);
    lift_tile(s, rows, cols, cols, P, false);
    scale_tile(s, rows, cols, cols, P);
}
template <typename T>
__device__ void lift_inv(T* s, int rows, int cols, const LiftParams& P) {
    scale_tile(s, rows, cols, cols, P);
    lift_tile(s, rows, cols, cols, P, false);
    lift_tile(s, rows, cols, cols, P, true);
}

// Lift a loaded forward tile -> HL1/LH1/HH1 of its core -> LL1 with halo 4
// -> rewrite the LL1 halo past the bottom/right image edge whole-point
// (the signal-domain mirror induces a HALF-point mirror on LL1 there; the
// oracle extends LL1 whole-point around its own last sample; the top/left
// need no fix: streamed.py:485-490) -> lift LL1 -> the four level-2 bands.
// ll2 may be a scratch buffer.  Ends with a barrier.
template <typename T>
__device__ void fwd2_compute(T* s1, T* s2, T* ll2, T* hl2, T* lh2, T* hh2, T* hl1,
                             T* lh1, T* hh1, int h, int w, int y0, int x0, int ty,
                             int tx, int hy, const LiftParams& P) {
    const int EY = ty + 2 * hy, EX = tx + 2 * HALO2;
    const int QY = ty / 2, QX = tx / 2;
    const int E1Y = QY + 8, E1X = QX + 8;
    lift_fwd(s1, EY, EX, P);

    for (int i = threadIdx.x; i < ty * tx; i += blockDim.x) {
        const int gy = y0 + i / tx, gx = x0 + i % tx;
        if (gy < h && gx < w && ((gy | gx) & 1))
            band_put<T>(nullptr, hl1, lh1, hh1, gy, gx, w,
                        s1[(hy + i / tx) * EX + HALO2 + i % tx]);
    }
    // LL1 positions [y0/2 - 4, y0/2 + QY + 4) x [x0/2 - 4, x0/2 + QX + 4)
    for (int i = threadIdx.x; i < E1Y * E1X; i += blockDim.x) {
        const int r = i / E1X, c = i % E1X;
        s2[i] = s1[(hy - 8 + 2 * r) * EX + HALO2 - 8 + 2 * c];
    }
    __syncthreads();

    const int N = h / 2, M = w / 2;
    const int by = y0 / 2 - 4, bx = x0 / 2 - 4;
    for (int i = threadIdx.x; i < E1Y * E1X; i += blockDim.x) {
        const int r = i / E1X, c = i % E1X;
        if (by + r >= N) {
            const int src = max(2 * N - 2 - (by + r) - by, 0);
            s2[i] = s2[src * E1X + c];
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < E1Y * E1X; i += blockDim.x) {
        const int r = i / E1X, c = i % E1X;
        if (bx + c >= M) {
            const int src = max(2 * M - 2 - (bx + c) - bx, 0);
            s2[i] = s2[r * E1X + src];
        }
    }
    __syncthreads();

    lift_fwd(s2, E1Y, E1X, P);
    for (int i = threadIdx.x; i < QY * QX; i += blockDim.x) {
        const int gy = y0 / 2 + i / QX, gx = x0 / 2 + i % QX;
        if (gy < N && gx < M)
            band_put<T>(ll2, hl2, lh2, hh2, gy, gx, M,
                        s2[(4 + i / QX) * E1X + 4 + i % QX]);
    }
    __syncthreads();
}

// Inverse tile of ty x tx output samples: the level-2 coefficients in the
// LL1 domain with halo IH2, (ty/2 + 16) x (tx/2 + 16), then the level-1
// tile with halo IH1, (ty + 8) x (tx + 8).
__host__ __device__ __forceinline__ int inv2_l2_elems(int ty, int tx) {
    return (ty / 2 + 2 * IH2) * (tx / 2 + 2 * IH2);
}
__host__ __device__ __forceinline__ int inv2_l1_elems(int ty, int tx) {
    return (ty + 2 * IH1) * (tx + 2 * IH1);
}

// Load the level-2 tile and the level-1 detail samples (the odd positions
// of the level-1 tile; its even/even positions come from level 2).  ll2
// may be a scratch buffer.
template <typename T>
__device__ void inv2_load(const T* ll2, const T* hl2, const T* lh2, const T* hh2,
                          const T* hl1, const T* lh1, const T* hh1, T* s2, T* s1,
                          int h, int w, int y0, int x0, int ty, int tx) {
    const int N = h / 2, M = w / 2;
    const int E2X = tx / 2 + 2 * IH2, n2 = (ty / 2 + 2 * IH2) * E2X;
    const int by = y0 / 2 - IH2, bx = x0 / 2 - IH2;
    for (int i = threadIdx.x; i < n2; i += blockDim.x) {
        const int r = i / E2X, c = i % E2X;
        copy_elem(s2 + i, band_ptr(ll2, hl2, lh2, hh2, mirror_idx(by + r, N),
                                          mirror_idx(bx + c, M), M));
    }
    const int EX = tx + 2 * IH1, n1 = (ty + 2 * IH1) * EX;
    for (int i = threadIdx.x; i < n1; i += blockDim.x) {
        const int py = y0 - IH1 + i / EX, px = x0 - IH1 + i % EX;
        if ((py | px) & 1)
            copy_elem(s1 + i, band_ptr<T>(nullptr, hl1, lh1, hh1, mirror_idx(py, h),
                                                 mirror_idx(px, w), w));
    }
}

// Level 2: lift (scale, inverse columns, rows) -> LL1 with halo 2;
// rewrite the LL1 rows/columns past the bottom/right edge with the level-1
// channel rule s[N+m] = s[N-1-m] (streamed.py:770-775) -> interleave into
// the level-1 tile -> lift -> write.  Ends with a barrier.
template <typename T>
__device__ void inv2_compute(T* s2, T* s1, T* out, int h, int w, int y0, int x0, int ty,
                             int tx, const LiftParams& P) {
    const int E2Y = ty / 2 + 2 * IH2, E2X = tx / 2 + 2 * IH2;
    const int EY = ty + 2 * IH1, EX = tx + 2 * IH1;
    const int N = h / 2, M = w / 2;
    const int by = y0 / 2 - IH2, bx = x0 / 2 - IH2;
    lift_inv(s2, E2Y, E2X, P);

    for (int i = threadIdx.x; i < E2Y * E2X; i += blockDim.x) {
        const int r = i / E2X, c = i % E2X;
        if (by + r >= N) {
            const int src = max(2 * N - 1 - (by + r) - by, 0);
            s2[i] = s2[src * E2X + c];
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < E2Y * E2X; i += blockDim.x) {
        const int r = i / E2X, c = i % E2X;
        if (bx + c >= M) {
            const int src = max(2 * M - 1 - (bx + c) - bx, 0);
            s2[i] = s2[r * E2X + src];
        }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < EY * EX; i += blockDim.x) {
        const int py = y0 - IH1 + i / EX, px = x0 - IH1 + i % EX;
        if (((py | px) & 1) == 0) s1[i] = s2[((py >> 1) - by) * E2X + (px >> 1) - bx];
    }
    __syncthreads();
    lift_inv(s1, EY, EX, P);
    for (int i = threadIdx.x; i < ty * tx; i += blockDim.x) {
        const int gy = y0 + i / tx, gx = x0 + i % tx;
        if (gy < h && gx < w)
            out[(size_t)gy * w + gx] = s1[(IH1 + i / tx) * EX + IH1 + i % tx];
    }
    __syncthreads();
}

}  // namespace tiles
