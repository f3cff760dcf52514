// The one-level 2-D tile body on the line walks of lines.cuh, shared by
// level.cu (B1/B4: one tile a block), deep.cu (B3/B6: every tile of every
// deep level in one cooperative launch) and streamed.cu (B7/B9, the single
// streamed levels: one strip a block).
//
// A tile is a ny x nx block of band samples (2 ny x 2 nx image samples):
// square in B1/B3/B4/B6 (``tile`` a side), the ty x tx strip in B7/B9.
// Its window is (2 ny + 8) x (2 nx + 8) with a halo of HALO = 4 on both
// axes (enough for four lifting steps), starting at even global rows and
// columns, so window parity is global parity.  Forward: fwd_load copies the
// image window in, the caller lifts it (lines::lift_fwd: rows, then
// columns) and fwd_store writes each band's samples times their scale.
// Inverse: inv_load copies the interleaved coefficient window in from the
// four bands, the caller lifts it (lines::lift_inv: scaled columns, then
// rows) and inv_store writes the output.  Borders are whole-point mirror
// reads: they equal the plain versions' signal mirror forward and their
// channel rules inverse, and give odd sizes their ceil/floor bands.
//
// EXT (0, 4 or 8) is boundary_rows='extended': the caller supplies EXT rows
// above and below the image (forward: the input has h + 2 EXT rows) or EXT
// channel rows above and below every band (inverse: the interleaved input
// has h + 4 EXT rows), read straight with no row mirror; columns still
// mirror.  B1/B4 take 4 rows (fused.py's contract), B7/B9 8 (TOP,
// streamed.py's).  Rows past the extension read as 0: they reach only
// outputs past the image, which are not stored.
#pragma once

#include <cuda_pipeline.h>

#include "lines.cuh"

namespace onelevel {

constexpr int HALO = 4;

// One level: its image (forward: the input; inverse: the output), h x w
// without any extension, and its four bands LL, HL, LH, HH (forward:
// outputs; inverse: inputs), ceil(h/2) or floor(h/2) rows (plus 2 EXT
// when extended) and ceil(w/2) or floor(w/2) columns; square tiles of
// ``tile`` band samples a side (B1/B3/B4/B6; B7/B9 pass their strip to the
// loads and stores and leave it 0).
template <typename T>
struct Level {
    T* img;
    T* band[4];
    int h, w, tile;
};

// Band k (0..3: LL, HL, LH, HH) of L, selected without indexing.
template <typename T>
__device__ __forceinline__ T* band_of(const Level<T>& L, int k) {
    T* b = L.band[0];
#pragma unroll
    for (int j = 1; j < 4; ++j) b = k == j ? L.band[j] : b;
    return b;
}

// Copy the EY x EX window at (y0 - HALO, x0 - HALO) of L's image into s
// (row stride RS) with cp.async, every row in flight at once: each thread
// keeps two columns, mirrored once, and walks the rows, mirrored once per
// row and only in tiles whose window crosses an edge (EXT: read straight
// from the extension, zeros past it).  Two columns inside the image are
// one copy when ``vec`` (the image's rows are pair-aligned).
template <int EXT, typename T>
__device__ __forceinline__ void fwd_load(const Level<T>& L, T* s, int RS, int EY, int EX,
                                         int y0, int x0, bool vec) {
    const int cpr = EX / 2, groups = blockDim.x / cpr;
    if ((int)threadIdx.x >= groups * cpr) return;
    const int m = threadIdx.x % cpr, gx = x0 - HALO + 2 * m;
    const bool in_x = vec && gx >= 0 && gx + 2 <= L.w;
    const int c0 = mirror_idx(gx, L.w), c1 = mirror_idx(gx + 1, L.w);
    // window row r is row py + r of the input (h + 2 EXT rows)
    const int py = y0 - HALO + EXT;
    const bool in_y = py >= 0 && py + EY <= L.h + 2 * EXT;
    for (int r = threadIdx.x / cpr; r < EY; r += groups) {
        if constexpr (EXT > 0) {
            if (!in_y && py + r >= L.h + 2 * EXT) {
                s[r * RS + 2 * m] = T(0);
                s[r * RS + 2 * m + 1] = T(0);
                continue;
            }
        }
        const T* row =
            L.img + (size_t)(in_y || EXT > 0 ? py + r : mirror_idx(py + r, L.h)) * L.w;
        T* dst = s + r * RS + 2 * m;
        if (in_x) {
            __pipeline_memcpy_async(dst, row + gx, 2 * sizeof(T));
        } else {
            __pipeline_memcpy_async(dst, row + c0, sizeof(T));
            __pipeline_memcpy_async(dst + 1, row + c1, sizeof(T));
        }
    }
}

// The lifted window's core -> the tile's ny x nx samples of each band, each
// times its scale factor.  Band k's row i is window row HALO + 2i + (k >> 1),
// columns HALO + (k & 1) + 2j.  Each thread keeps one chunk of V = 16 /
// sizeof(T) band columns and walks the (row, band) pairs; rows and columns
// past a band's ceil/floor size are not stored.
template <typename T>
__device__ __forceinline__ void fwd_store(const T* s, int RS, const Level<T>& L, int y0,
                                          int x0, int ny, int nx, const LiftParams& P) {
    constexpr int V = 16 / sizeof(T);
    const int ch = (L.h + 1) >> 1, fh = L.h >> 1;
    const int cw = (L.w + 1) >> 1, fw = L.w >> 1;
    const int cps = (nx + V - 1) / V, groups = blockDim.x / cps;
    if ((int)threadIdx.x >= groups * cps) return;
    const int c = threadIdx.x % cps, j = x0 / 2 + c * V, m = min(V, nx - c * V);
    const T* src = s + HALO * RS + HALO + 2 * c * V;
    for (int q = threadIdx.x / cps; q < 4 * ny; q += groups) {
        const int i = q >> 2, k = q & 3, gi = y0 / 2 + i;
        if (gi >= ch) break;
        const int cols = (k & 1) ? fw : cw, n = min(m, cols - j);
        if (n <= 0 || ((k >> 1) && gi >= fh)) continue;
        T* dst = band_of(L, k) + (size_t)gi * cols + j;
        lines::put(dst, src + (2 * i + (k >> 1)) * RS + (k & 1), n, lines::aligned16(dst), P,
                   k);
    }
}

// The EY x EX interleaved window at (y0 - HALO, x0 - HALO) of L's output
// from its four bands, element by element with cp.async: each thread keeps
// one window column, mirrored once, and walks the rows (mirrored only in
// tiles that cross an edge; EXT: read straight from the extension, zeros
// past it).  Even rows hold LL | HL, odd rows LH | HH, at even | odd
// columns; the mirror keeps parity.
template <int EXT, typename T>
__device__ __forceinline__ void inv_load(const Level<T>& L, T* s, int RS, int EY, int EX,
                                         int y0, int x0) {
    const int groups = blockDim.x / EX;
    if ((int)threadIdx.x >= groups * EX) return;
    const int c = threadIdx.x % EX, gx = mirror_idx(x0 - HALO + c, L.w), odd = gx & 1;
    const int bw = odd ? L.w >> 1 : (L.w + 1) >> 1;
    const T* ev = band_of(L, odd) + (gx >> 1);
    const T* od = band_of(L, 2 | odd) + (gx >> 1);
    // window row r is row py + r of the interleaved input (h + 4 EXT rows)
    const int py = y0 - HALO + 2 * EXT;
    const bool in_y = py >= 0 && py + EY <= L.h + 4 * EXT;
    for (int r = threadIdx.x / EX; r < EY; r += groups) {
        if constexpr (EXT > 0) {
            if (!in_y && py + r >= L.h + 4 * EXT) {
                s[r * RS + c] = T(0);
                continue;
            }
        }
        const int gy = in_y || EXT > 0 ? py + r : mirror_idx(py + r, L.h);
        __pipeline_memcpy_async(s + r * RS + c, ((gy & 1) ? od : ev) + (size_t)(gy >> 1) * bw,
                                sizeof(T));
    }
}

// The lifted window's SY x SX core -> the output from (y0, x0), cut at h x w.
// Each thread keeps one chunk of V = 16 / sizeof(T) columns and walks the
// rows: one 16-byte store a chunk where it is whole and aligned.
template <typename T>
__device__ __forceinline__ void inv_store(const T* s, int RS, const Level<T>& L, int y0,
                                          int x0, int SY, int SX) {
    constexpr int V = 16 / sizeof(T);
    using PT = typename lines::Pair<T>::type;
    using VT = typename lines::Vec16<T>::type;
    const int cpr = (SX + V - 1) / V, groups = blockDim.x / cpr;
    if ((int)threadIdx.x >= groups * cpr) return;
    const int c = threadIdx.x % cpr, gx = x0 + c * V;
    const int n = min(min(V, SX - c * V), L.w - gx), rows = min(SY, L.h - y0);
    if (n <= 0) return;
    const T* src = s + HALO * RS + HALO + c * V;  // even offset: Pair-aligned
    for (int r = threadIdx.x / cpr; r < rows; r += groups) {
        T* dst = L.img + (size_t)(y0 + r) * L.w + gx;
        const T* sr = src + r * RS;
        if (n == V && lines::aligned16(dst)) {
            VT v;
#pragma unroll
            for (int u = 0; u < V / 2; ++u)
                reinterpret_cast<PT*>(&v)[u] = reinterpret_cast<const PT*>(sr)[u];
            *reinterpret_cast<VT*>(dst) = v;
        } else {
            for (int u = 0; u < n; ++u) dst[u] = sr[u];
        }
    }
}

}  // namespace onelevel
