// The two-level 2-D window bodies on the line walks of lines.cuh, shared by
// fused2l.cu (B2/B5: one tile a block) and streamed.cu (B8/B10 and the
// strip phase of B11/B12: strips walked down a column band by a persistent
// block, the next strip's window in flight while this one lifts).  fused2l.cu's header says what
// each step does and why.
//
// A window holds the ty x tx samples of one tile or strip (both multiples
// of 4) with its halos, starting at even global rows and columns.
// Forward (namespace fwd2): the signal with halo HALO2 = 12 on both axes,
// (ty + 24) x (tx + 24), then LL1 with halo 4, (ty/2 + 8) x (tx/2 + 8).
// Inverse (namespace inv2): the level-2 bands in the LL1 domain with halo
// IH2 = 8, (ty/2 + 16) x (tx/2 + 16), then the level-1 window with halo
// IH1 = 4, (ty + 8) x (tx + 8).  Every line of a window is walked by one
// thread, so no window is wider or taller than the block (256).
#pragma once

#include <cuda_pipeline.h>

#include "lines.cuh"
#include "tiles.cuh"

namespace fwd2 {

using lines::put;
using lines::scaled;
using tiles::HALO2;

// Copy the EY x EX window at (y0 - HALO2, x0 - HALO2) into s (row stride
// RS) with cp.async, every row in flight at once: each thread keeps one
// chunk of V = 16 / sizeof(T) columns and walks the rows.  A chunk inside
// the image is one 16-byte copy for float64 and two 8-byte copies for the
// 4-byte types (RS is 2 mod 4, so their rows are 8-byte aligned) when
// ``vec``, else V copies through column indices mirrored once; rows are
// mirrored once per row, only in windows that cross an edge.
template <typename T>
__device__ __forceinline__ void load(const T* __restrict__ x, T* s, int RS, int h, int w,
                                     int y0, int x0, int EY, int EX, bool vec) {
    constexpr int V = 16 / sizeof(T);
    const int cpr = EX / V, groups = blockDim.x / cpr;  // EX % 4 == 0
    if ((int)threadIdx.x >= groups * cpr) return;
    const int m = threadIdx.x % cpr, gx = x0 - HALO2 + m * V;
    const bool in_x = vec && gx >= 0 && gx + V <= w;
    int cx[V];
#pragma unroll
    for (int u = 0; u < V; ++u) cx[u] = mirror_idx(gx + u, w);
    const bool in_y = y0 - HALO2 >= 0 && y0 - HALO2 + EY <= h;
    for (int r = threadIdx.x / cpr; r < EY; r += groups) {
        const int gy = in_y ? y0 - HALO2 + r : mirror_idx(y0 - HALO2 + r, h);
        const T* row = x + (size_t)gy * w;
        T* dst = s + r * RS + m * V;
        if (in_x) {
#pragma unroll
            for (int u = 0; u < V; u += 2)
                __pipeline_memcpy_async(dst + u, row + gx + u, 2 * sizeof(T));
        } else {
#pragma unroll
            for (int u = 0; u < V; ++u) __pipeline_memcpy_async(dst + u, row + cx[u], sizeof(T));
        }
    }
}

// The core of a lifted window (row stride RS, core from row and column
// ``core``) -> NB bands of rows x cols samples: the last NB of (LL, HL,
// LH, HH) = k 0..3 in ``bands`` (band b is k = b + 4 - NB).  Band k's row i
// is window row core + 2i + (k >> 1), columns core + (k & 1) + 2j; to band
// row gr0 + i (< rows_out) from column gc0 (< cols_out), times scale
// factor k.  Each thread keeps one chunk of V band columns and walks the
// (row, band) pairs.
template <int NB, typename T>
__device__ __forceinline__ void store_bands(const T* s, int RS, int core,
                                            T* const (&bands)[NB], int rows, int cols,
                                            int gr0, int gc0, int rows_out, int cols_out,
                                            const LiftParams& P) {
    constexpr int V = 16 / sizeof(T);
    bool vec = cols_out % V == 0 && cols % V == 0;
#pragma unroll
    for (int b = 0; b < NB; ++b) vec = vec && lines::aligned16(bands[b]);
    const int cps = (cols + V - 1) / V, groups = blockDim.x / cps;
    if ((int)threadIdx.x >= groups * cps) return;
    const int c = threadIdx.x % cps, gc = gc0 + c * V;
    const int n = min(min(V, cols - c * V), cols_out - gc);
    if (n <= 0) return;
#pragma unroll 4
    for (int q = threadIdx.x / cps; q < NB * rows; q += groups) {
        const int i = q / NB, b = q - NB * i, k = b + 4 - NB;
        if (gr0 + i >= rows_out) break;
        T* band = bands[0];
#pragma unroll
        for (int j = 1; j < NB; ++j) band = b == j ? bands[j] : band;
        const T* src = s + (core + 2 * i + (k >> 1)) * RS + core + (k & 1) + 2 * c * V;
        put(band + (size_t)(gr0 + i) * cols_out + gc, src, n, vec, P, k);
    }
}

// LL1 with halo 4 (E1Y x E1X samples, row stride RS1) from the lifted
// level-1 window (row stride RS), times the LL scale, with the whole-point
// re-mirror past the bottom/right edge in the source index: the values
// that the plain version (ops/fused.py dwt2_2level_tiles) copies and then
// rewrites.
template <typename T>
__device__ __forceinline__ void ll1_window(const T* s1, int RS, T* s2, int RS1, int h,
                                           int w, int y0, int x0, int E1Y, int E1X,
                                           const LiftParams& P) {
    const int N = h / 2, M = w / 2, by = y0 / 2 - 4, bx = x0 / 2 - 4;
    const int groups = blockDim.x / E1X;
    if ((int)threadIdx.x >= groups * E1X) return;
    const int c = threadIdx.x % E1X;
    const int cc = bx + c >= M ? max(2 * M - 2 - (bx + c) - bx, 0) : c;
    // LL1 (r, c) is window sample (HALO2 - 8 + 2r, HALO2 - 8 + 2c)
    const T* src = s1 + (HALO2 - 8) * (RS + 1) + 2 * cc;
#pragma unroll 4
    for (int r = threadIdx.x / E1X; r < E1Y; r += groups) {
        const int rr = by + r >= N ? max(2 * N - 2 - (by + r) - by, 0) : r;
        s2[r * RS1 + c] = scaled(src[2 * rr * RS], P, 0);
    }
}

}  // namespace fwd2

namespace inv2 {

using tiles::IH1;
using tiles::IH2;

// cp.async the samples (r, c) of an EY x EX window, r = r0, r0 + 2, ...
// and c = c0, c0 + cs, ... (cs 1 or 2), into s (row stride RS).  The
// window starts at (oy, ox) (both even) of an interleaved level nr x nc
// whose rows of parity r0 hold band ``even`` at even columns and ``odd`` at
// odd ones (band rows bw wide).  Each thread keeps one window column,
// mirrored once, and walks the rows, mirrored once per row and only when
// ``in_y`` is false.  The whole-point mirror keeps parity (p -> -p, p ->
// 2(n-1) - p), so a mirrored sample stays in its band.
template <typename T>
__device__ __forceinline__ void load_rows(T* s, int RS, int EY, int EX, int r0, int c0,
                                          int cs, const T* even, const T* odd, int bw,
                                          int oy, int ox, int nr, int nc, bool in_y) {
    const int ncol = (EX - c0 + cs - 1) / cs, groups = blockDim.x / ncol;
    if ((int)threadIdx.x >= groups * ncol) return;
    const int c = c0 + cs * (threadIdx.x % ncol);
    const T* band = ((c & 1) ? odd : even) + (mirror_idx(ox + c, nc) >> 1);
    for (int r = r0 + 2 * (threadIdx.x / ncol); r < EY; r += 2 * groups) {
        const int gr = in_y ? oy + r : mirror_idx(oy + r, nr);
        __pipeline_memcpy_async(s + r * RS + c, band + (size_t)(gr >> 1) * bw, sizeof(T));
    }
}

// The level-2 bands of an h x w frame's window at (y0, x0) into s2 (E2Y x
// E2X, row stride RS2): level 2 in the LL1 domain (N x M), window from
// (y0/2 - IH2, x0/2 - IH2).  ll2 may be a scratch buffer.
template <typename T>
__device__ __forceinline__ void load_level2(const T* ll2, const T* hl2, const T* lh2,
                                            const T* hh2, T* s2, int RS2, int E2Y, int E2X,
                                            int h, int w, int y0, int x0) {
    const int N = h / 2, M = w / 2;
    const int by = y0 / 2 - IH2, bx = x0 / 2 - IH2;
    const bool in2 = by >= 0 && by + E2Y <= N;
    load_rows(s2, RS2, E2Y, E2X, 0, 0, 1, ll2, hl2, M / 2, by, bx, N, M, in2);
    load_rows(s2, RS2, E2Y, E2X, 1, 0, 1, lh2, hh2, M / 2, by, bx, N, M, in2);
}

// The level-1 details of the same window into s1 (E1Y x E1X, row stride
// RS1), window from (y0 - IH1, x0 - IH1): LH1/HH1 at the odd rows, HL1 at
// the odd columns of the even rows.
template <typename T>
__device__ __forceinline__ void load_level1(const T* hl1, const T* lh1, const T* hh1, T* s1,
                                            int RS1, int E1Y, int E1X, int h, int w, int y0,
                                            int x0) {
    const int M = w / 2, py = y0 - IH1, px = x0 - IH1;
    const bool in1 = py >= 0 && py + E1Y <= h;
    load_rows(s1, RS1, E1Y, E1X, 1, 0, 1, lh1, hh1, M, py, px, h, w, in1);
    load_rows<T>(s1, RS1, E1Y, E1X, 0, 1, 2, nullptr, hl1, M, py, px, h, w, in1);
}

// LL1 from the lifted level-2 window (row stride RS2) into the even/even
// samples of the level-1 window (row stride RS1, n1y x n1x samples of each
// parity), with the level-1 channel rule s[N+m] = s[N-1-m] past the
// bottom/right edge in the source index: the values that the plain version
// (ops/fused.py idwt2_2level_tiles) rewrites in two passes and then
// interleaves.  Level-1 sample (2i, 2j) is
// LL1 (y0/2 - IH1/2 + i, x0/2 - IH1/2 + j), level-2 sample (c + i, c + j)
// with c = IH2 - IH1/2.
template <typename T>
__device__ __forceinline__ void ll1_window(const T* s2, int RS2, T* s1, int RS1, int h,
                                           int w, int y0, int x0, int n1y, int n1x) {
    constexpr int C = IH2 - IH1 / 2;
    const int N = h / 2, M = w / 2, by = y0 / 2 - IH2, bx = x0 / 2 - IH2;
    const int groups = blockDim.x / n1x;
    if ((int)threadIdx.x >= groups * n1x) return;
    const int j = threadIdx.x % n1x, c = C + j;
    const T* src = s2 + (bx + c >= M ? max(2 * M - 1 - (bx + c) - bx, 0) : c);
    T* dst = s1 + 2 * j;
#pragma unroll 4
    for (int i = threadIdx.x / n1x; i < n1y; i += groups) {
        const int r = C + i;
        const int rr = by + r >= N ? max(2 * N - 1 - (by + r) - by, 0) : r;
        dst[2 * i * RS1] = src[rr * RS2];
    }
}

// The ty x tx core of the lifted level-1 window (from row and column IH1,
// row stride RS1) -> out from (y0, x0), cut at h x w.  Each thread keeps
// one chunk of V = 16 / sizeof(T) columns and walks the rows: one 16-byte
// store a chunk (out 16-byte aligned, checked by the launchers; w % 4 == 0
// and x0 % 4 == 0 keep every chunk whole or wholly outside).
template <typename T>
__device__ __forceinline__ void store(const T* s1, int RS1, T* out, int h, int w, int y0,
                                      int x0, int ty, int tx) {
    constexpr int V = 16 / sizeof(T);
    using PT = typename lines::Pair<T>::type;
    using VT = typename lines::Vec16<T>::type;
    const int cpr = tx / V, groups = blockDim.x / cpr;  // tx % 4 == 0
    if ((int)threadIdx.x >= groups * cpr) return;
    const int c = threadIdx.x % cpr, gx = x0 + c * V;
    const int rows = min(ty, h - y0);
    if (gx >= w) return;
    const T* src = s1 + IH1 * RS1 + IH1 + c * V;  // even: Pair-aligned
#pragma unroll 4
    for (int r = threadIdx.x / cpr; r < rows; r += groups) {
        T* dst = out + (size_t)(y0 + r) * w + gx;
        const T* sr = src + r * RS1;
        VT v;
#pragma unroll
        for (int u = 0; u < V / 2; ++u)
            reinterpret_cast<PT*>(&v)[u] = reinterpret_cast<const PT*>(sr)[u];
        *reinterpret_cast<VT*>(dst) = v;
    }
}

}  // namespace inv2
