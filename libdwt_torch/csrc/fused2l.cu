// Two-level fused 2-D DWT tile kernels for Hopper (sm_90a).
//
// dwt_fwd2_*  replaces libdwt_tpu/ops/fused.py fused_dwt2_2level (:784,
//             body _2lvl_kernel :700; TPU kernel id B2).
// dwt_inv2_*  replaces libdwt_tpu/ops/fused.py fused_idwt2_2level (:1173,
//             body _inv2_kernel :1115; TPU kernel id B5).
//
// Bound on an H100: bytes.  Each pixel is read once and each coefficient
// written once (2144x4096 f32: 35.1 MB each way, ~21 us at 3.35 TB/s);
// the lifting arithmetic is ~25 flops per pixel, far below the 67 TFLOP/s
// f32 rate.  The design keeps both levels in shared memory so the level-1
// LL never goes to device memory (the point of the TPU kernel), and takes
// 2-D tiles with a halo on both axes: the TPU's full-width strips relied
// on a lane axis that needed no halo, and a 4096-wide f32 row is 16 KB of
// the 227 KB a block may hold.
//
// Forward tile (T x T signal samples, T % 4 == 0, halo 12 = HALO2 on both
// axes): load with whole-point mirror reads -> lift rows, columns, scale ->
// write HL1/LH1/HH1 -> LL1 with halo 4 -> rewrite the LL1 halo past the
// bottom/right image edge whole-point (the signal-domain mirror induces a
// HALF-point mirror on LL1 there; the oracle extends LL1 whole-point
// around its own last sample; the top/left need no fix) -> lift LL1 ->
// write the four level-2 bands.
//
// Inverse tile (T x T output samples): level-2 coefficients in the LL1
// domain with halo 8 (IH2) -> scale, inverse columns, rows -> LL1 with
// halo 2; rewrite the LL1 rows/columns past the bottom/right edge with the
// level-1 channel rule s[N+m] = s[N-1-m] (half-point) -> interleave with
// the level-1 bands mirrored whole-point (halo 4 = IH1) -> scale, inverse
// columns, rows -> write.
// Axis order: forward rows then columns, inverse columns then rows, for
// floats and ints alike (the integer order the oracle needs bit-exactly).
//
// Each kernel has its own body (namespaces fwd2 and inv2, on the line
// walks of namespace lines, lines.cuh): the same operations as tiles.cuh
// fwd2_* and inv2_* (lift_one's arithmetic, the axis order and the
// scale, the LL1 re-mirror or channel rule, even tile starts and
// whole-point mirror reads), so their outputs equal the plain versions bit for bit.  What
// held the shared bodies back (B2 0.37 ms and B5 0.34 ms at 2144x4096 f32
// on an H100, 16-18x the bound), and what these do about it (PERF.md has
// the measurements of each step):
//   * lift_tile's column steps put neighbouring threads two rows apart
//     (2 x 88 words for B2 at T=64, 2 x 48 and 2 x 72 for B5): 16- and
//     32-way bank conflicts.  Not here: a column's lanes are neighbouring
//     columns.
//   * Every update paid divisions for its index, a runtime step index into
//     the weights, and a barrier per step; lift_one's wl == wr test and
//     one-sided cases branched per update.  The phases ran latency-bound
//     with few threads busy.  Here each line (a row or a column) is walked
//     once by one thread with all the steps pipelined in registers (see
//     lines::walk), cut into segments of at least MIN_SEG pairs so that
//     more threads walk at once (176 and 216 in the level-1 windows of B2
//     and B5 at T=64); symmetric steps (the launcher checks on the host)
//     update with t + w * (l + r) and no branch; one barrier pair per pass
//     instead of one barrier per step.  A window's row stride is 2 mod 4,
//     so lanes walking 32 rows read distinct banks.
//   * Loads by cp.async with every row in flight: each thread keeps one
//     chunk of window columns (B2) or one window column (B5) and walks the
//     rows; column indices are mirrored once per thread, rows once per row
//     and only in tiles that cross an edge.  No per-element division or
//     modulo.  B2 copies 16 bytes a chunk inside the image where x is
//     aligned; B5 copies element by element, since its interleaved window
//     takes each band at every second column, but a warp's copies of
//     neighbouring columns read two bands 64 contiguous bytes each, whole
//     sectors.  B5's level-1 details are in flight while level 2 lifts.
//   * The scale: B2 applies it as each value is stored (the same multiply,
//     after the columns); B5 as each value is first read, by its column
//     walk (the same multiply, before any step).  B2's LL1 re-mirror and
//     B5's channel rule and interleave are folded into the source index of
//     the LL1 copy.  Band rows (B2) and output rows (B5) are written 16
//     bytes at a time where the widths and the tile keep the runs aligned.
//   * The default tile (64) is a compile-time constant; other tiles run the
//     same body with the tile read at run time.
// float64 (f64) doubles the shared memory: 75 KB forward and 62 KB inverse
// at the default 64x64 tile.
#include <cstdint>
#include <type_traits>

#include "lines.cuh"
#include "tiles.cuh"

namespace {

constexpr int HALO2 = tiles::HALO2;
constexpr int IH2 = tiles::IH2;
constexpr int IH1 = tiles::IH1;
constexpr int THREADS = 256;

namespace fwd2 {

using lines::put;
using lines::scaled;
using lines::Vec16;

// Copy the E x E window at (y0 - HALO2, x0 - HALO2) into s (row stride
// RS) with cp.async, every row in flight at once: each thread keeps one
// chunk of V = 16 / sizeof(T) columns and walks the rows.  A chunk inside
// the image is one 16-byte copy for float64 and two 8-byte copies for the
// 4-byte types (RS is 2 mod 4, so their rows are 8-byte aligned) when
// ``vec``, else V copies through column indices mirrored once; rows are
// mirrored once per row, only in tiles whose window crosses an edge.
template <typename T>
__device__ __forceinline__ void load(const T* __restrict__ x, T* s, int RS, int h, int w,
                                     int y0, int x0, int E, bool vec) {
    constexpr int V = 16 / sizeof(T);
    const int cpr = E / V, groups = blockDim.x / cpr;  // E % 4 == 0
    if ((int)threadIdx.x >= groups * cpr) return;
    const int m = threadIdx.x % cpr, gx = x0 - HALO2 + m * V;
    const bool in_x = vec && gx >= 0 && gx + V <= w;
    int cx[V];
#pragma unroll
    for (int u = 0; u < V; ++u) cx[u] = mirror_idx(gx + u, w);
    const bool in_y = y0 - HALO2 >= 0 && y0 - HALO2 + E <= h;
    for (int r = threadIdx.x / cpr; r < E; r += groups) {
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
// ``core``) -> NB band rows: the last NB of (LL, HL, LH, HH) = k 0..3 in
// ``bands`` (band b is k = b + 4 - NB).  Band k's row i is window row core
// + 2i + (k >> 1), columns core + (k & 1) + 2j; seg samples to band row gr0
// + i (< rows_out) from column gc0 (< cols_out), times scale factor k.
// Each thread keeps one chunk of V band columns and walks the (row, band)
// pairs.
template <int NB, typename T>
__device__ __forceinline__ void store_bands(const T* s, int RS, int core,
                                            T* const (&bands)[NB], int seg, int gr0,
                                            int gc0, int rows_out, int cols_out,
                                            const LiftParams& P) {
    constexpr int V = 16 / sizeof(T);
    bool vec = cols_out % V == 0 && seg % V == 0;
#pragma unroll
    for (int b = 0; b < NB; ++b) vec = vec && lines::aligned16(bands[b]);
    const int cps = (seg + V - 1) / V, groups = blockDim.x / cps;
    if ((int)threadIdx.x >= groups * cps) return;
    const int c = threadIdx.x % cps, gc = gc0 + c * V;
    const int n = min(min(V, seg - c * V), cols_out - gc);
    if (n <= 0) return;
#pragma unroll 4
    for (int q = threadIdx.x / cps; q < NB * seg; q += groups) {
        const int i = q / NB, b = q - NB * i, k = b + 4 - NB;
        if (gr0 + i >= rows_out) break;
        T* band = bands[0];
#pragma unroll
        for (int j = 1; j < NB; ++j) band = b == j ? bands[j] : band;
        const T* src = s + (core + 2 * i + (k >> 1)) * RS + core + (k & 1) + 2 * c * V;
        put(band + (size_t)(gr0 + i) * cols_out + gc, src, n, vec, P, k);
    }
}

// LL1 with halo 4 (E1 x E1 samples, row stride RS1) from the lifted
// level-1 window (row stride RS), times the LL scale, with the whole-point
// re-mirror past the bottom/right edge in the source index: the values
// tiles::fwd2_lifted copies and then rewrites.
template <typename T>
__device__ __forceinline__ void ll1_window(const T* s1, int RS, T* s2, int RS1, int h,
                                           int w, int y0, int x0, int E1,
                                           const LiftParams& P) {
    const int N = h / 2, M = w / 2, by = y0 / 2 - 4, bx = x0 / 2 - 4;
    const int groups = blockDim.x / E1;
    if ((int)threadIdx.x >= groups * E1) return;
    const int c = threadIdx.x % E1;
    const int cc = bx + c >= M ? max(2 * M - 2 - (bx + c) - bx, 0) : c;
    // LL1 (r, c) is window sample (HALO2 - 8 + 2r, HALO2 - 8 + 2c)
    const T* src = s1 + (HALO2 - 8) * (RS + 1) + 2 * cc;
#pragma unroll 4
    for (int r = threadIdx.x / E1; r < E1; r += groups) {
        const int rr = by + r >= N ? max(2 * N - 2 - (by + r) - by, 0) : r;
        s2[r * RS1 + c] = scaled(src[2 * rr * RS], P, 0);
    }
}

}  // namespace fwd2

namespace inv2 {

// cp.async the samples (r, c) of an E x E window, r = r0, r0 + 2, ... and
// c = c0, c0 + cs, ... (cs 1 or 2), into s (row stride RS).  The window
// starts at (oy, ox) (both even) of an interleaved level nr x nc whose rows
// of parity r0 hold band ``even`` at even columns and ``odd`` at odd ones
// (band rows bw wide).  Each thread keeps one window column, mirrored once,
// and walks the rows, mirrored once per row and only when ``in_y`` is
// false.  The whole-point mirror keeps parity (p -> -p, p -> 2(n-1) - p),
// so a mirrored sample stays in its band.
template <typename T>
__device__ __forceinline__ void load_rows(T* s, int RS, int E, int r0, int c0, int cs,
                                          const T* even, const T* odd, int bw, int oy,
                                          int ox, int nr, int nc, bool in_y) {
    const int ncol = (E - c0 + cs - 1) / cs, groups = blockDim.x / ncol;
    if ((int)threadIdx.x >= groups * ncol) return;
    const int c = c0 + cs * (threadIdx.x % ncol);
    const T* band = ((c & 1) ? odd : even) + (mirror_idx(ox + c, nc) >> 1);
    for (int r = r0 + 2 * (threadIdx.x / ncol); r < E; r += 2 * groups) {
        const int gr = in_y ? oy + r : mirror_idx(oy + r, nr);
        __pipeline_memcpy_async(s + r * RS + c, band + (size_t)(gr >> 1) * bw, sizeof(T));
    }
}

// LL1 from the lifted level-2 window (row stride RS2) into the even/even
// samples of the level-1 window (row stride RS1, n1 samples of each parity
// a side), with the level-1 channel rule s[N+m] = s[N-1-m] past the
// bottom/right edge in the source index: the values tiles::inv2_lifted
// rewrites in two passes and then interleaves.  Level-1 sample (2i, 2j) is
// LL1 (y0/2 - IH1/2 + i, x0/2 - IH1/2 + j), level-2 sample (c + i, c + j)
// with c = IH2 - IH1/2.
template <typename T>
__device__ __forceinline__ void ll1_window(const T* s2, int RS2, T* s1, int RS1, int h,
                                           int w, int y0, int x0, int n1) {
    constexpr int C = IH2 - IH1 / 2;
    const int N = h / 2, M = w / 2, by = y0 / 2 - IH2, bx = x0 / 2 - IH2;
    const int groups = blockDim.x / n1;
    if ((int)threadIdx.x >= groups * n1) return;
    const int j = threadIdx.x % n1, c = C + j;
    const T* src = s2 + (bx + c >= M ? max(2 * M - 1 - (bx + c) - bx, 0) : c);
    T* dst = s1 + 2 * j;
#pragma unroll 4
    for (int i = threadIdx.x / n1; i < n1; i += groups) {
        const int r = C + i;
        const int rr = by + r >= N ? max(2 * N - 1 - (by + r) - by, 0) : r;
        dst[2 * i * RS1] = src[rr * RS2];
    }
}

// The tile x tile core of the lifted level-1 window (from row and column
// IH1, row stride RS1) -> out from (y0, x0), cut at h x w.  Each thread
// keeps one chunk of V = 16 / sizeof(T) columns and walks the rows: one
// 16-byte store a chunk (out 16-byte aligned, checked by launch_inv2;
// w % 4 == 0 and x0 % 4 == 0 keep every chunk whole or wholly outside).
template <typename T>
__device__ __forceinline__ void store(const T* s1, int RS1, T* out, int h, int w, int y0,
                                      int x0, int tile) {
    constexpr int V = 16 / sizeof(T);
    using PT = typename lines::Pair<T>::type;
    using VT = typename lines::Vec16<T>::type;
    const int cpr = tile / V, groups = blockDim.x / cpr;  // tile % 4 == 0
    if ((int)threadIdx.x >= groups * cpr) return;
    const int c = threadIdx.x % cpr, gx = x0 + c * V;
    const int rows = min(tile, h - y0);
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

// TILE: the tile edge at compile time, or 0 to take ``tile``.  NST: the
// lifting steps (1, 2 or 4, alternating d, s from d); SYM: all symmetric.
template <typename T, int TILE, int NST, bool SYM>
__global__ void fwd2_kernel(const T* __restrict__ x, T* ll2, T* hl2, T* lh2, T* hh2,
                            T* hl1, T* lh1, T* hh1, int h, int w, int tile_arg,
                            LiftParams P) {
    extern __shared__ __align__(16) unsigned char fwd2_smem[];
    const int tile = TILE ? TILE : tile_arg;
    const int E = tile + 2 * HALO2, E1 = tile / 2 + 8;
    const int RS = lines::stride(E), RS1 = lines::stride(E1);
    T* s1 = reinterpret_cast<T*>(fwd2_smem);
    T* s2 = s1 + E * RS;  // E % 4 == 0, RS even: 16-byte aligned
    const int y0 = blockIdx.y * tile, x0 = blockIdx.x * tile;
    fwd2::load(x, s1, RS, h, w, y0, x0, E, lines::aligned16(x) && w % 4 == 0);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    lines::lift_fwd<NST, SYM>(s1, E, RS, P);
    T* const b1[3] = {hl1, lh1, hh1};
    fwd2::store_bands(s1, RS, HALO2, b1, tile / 2, y0 / 2, x0 / 2, h / 2, w / 2, P);
    fwd2::ll1_window(s1, RS, s2, RS1, h, w, y0, x0, E1, P);
    __syncthreads();
    lines::lift_fwd<NST, SYM>(s2, E1, RS1, P);
    T* const b2[4] = {ll2, hl2, lh2, hh2};
    fwd2::store_bands(s2, RS1, 4, b2, tile / 4, y0 / 4, x0 / 4, h / 4, w / 4, P);
}

// TILE, SYM as for fwd2_kernel; NST: the lifting steps (2 or 4,
// alternating s, d from s; or 1, a d step).
template <typename T, int TILE, int NST, bool SYM>
__global__ void inv2_kernel(const T* __restrict__ ll2, const T* __restrict__ hl2,
                            const T* __restrict__ lh2, const T* __restrict__ hh2,
                            const T* __restrict__ hl1, const T* __restrict__ lh1,
                            const T* __restrict__ hh1, T* out, int h, int w, int tile_arg,
                            LiftParams P) {
    extern __shared__ __align__(16) unsigned char inv2_smem[];
    const int tile = TILE ? TILE : tile_arg;
    const int E2 = tile / 2 + 2 * IH2, E1 = tile + 2 * IH1;
    const int RS2 = lines::stride(E2), RS1 = lines::stride(E1);
    T* s2 = reinterpret_cast<T*>(inv2_smem);
    T* s1 = s2 + E2 * RS2;  // E2 and RS2 even: 16-byte aligned
    const int y0 = blockIdx.y * tile, x0 = blockIdx.x * tile;
    const int N = h / 2, M = w / 2;
    // level 2 in the LL1 domain (N x M), window from (y0/2 - IH2, x0/2 - IH2)
    const int by = y0 / 2 - IH2, bx = x0 / 2 - IH2;
    const bool in2 = by >= 0 && by + E2 <= N;
    inv2::load_rows(s2, RS2, E2, 0, 0, 1, ll2, hl2, M / 2, by, bx, N, M, in2);
    inv2::load_rows(s2, RS2, E2, 1, 0, 1, lh2, hh2, M / 2, by, bx, N, M, in2);
    __pipeline_commit();
    // level-1 details (h x w), window from (y0 - IH1, x0 - IH1): LH1/HH1 at
    // the odd rows, HL1 at the odd columns of the even rows; in flight while
    // level 2 lifts
    const int py = y0 - IH1, px = x0 - IH1;
    const bool in1 = py >= 0 && py + E1 <= h;
    inv2::load_rows(s1, RS1, E1, 1, 0, 1, lh1, hh1, M, py, px, h, w, in1);
    inv2::load_rows<T>(s1, RS1, E1, 0, 1, 2, nullptr, hl1, M, py, px, h, w, in1);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    lines::lift_inv<NST, SYM>(s2, E2, RS2, P);
    inv2::ll1_window(s2, RS2, s1, RS1, h, w, y0, x0, E1 / 2);
    __pipeline_wait_prior(0);
    __syncthreads();
    lines::lift_inv<NST, SYM>(s1, E1, RS1, P);
    inv2::store(s1, RS1, out, h, w, y0, x0, tile);
}

// Launch ``kernel`` on the tiles of an h x w frame with ``smem`` bytes.
template <typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, size_t smem, int h, int w, int tile, cudaStream_t stream,
                 Args... args) {
    if (smem > 48 * 1024)
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    dim3 grid((w + tile - 1) / tile, (h + tile - 1) / tile);
    kernel<<<grid, THREADS, smem, stream>>>(args...);
    return (int)cudaGetLastError();
}

// The walk takes 1, 2 or 4 steps alternating d, s from d: every wavelet
// the fused kernels accept.
template <typename T>
int launch_fwd2(const T* x, T* ll2, T* hl2, T* lh2, T* hh2, T* hl1, T* lh1,
                T* hh1, int h, int w, int tile, const LiftParams* P,
                cudaStream_t stream) {
    if (tile + 2 * HALO2 > THREADS) return (int)cudaErrorInvalidValue;  // a line a thread
    for (int s = 0; s < P->n; ++s)
        if (P->is_d[s] != (s % 2 == 0)) return (int)cudaErrorInvalidValue;
    const int E = tile + 2 * HALO2, E1 = tile / 2 + 8;
    const size_t smem =
        sizeof(T) * (size_t)(E * lines::stride(E) + E1 * lines::stride(E1));
    return dispatch<T>(tile, P, [&](auto tc, auto nst, auto sym) {
        return launch_tiles(fwd2_kernel<T, decltype(tc)::value, decltype(nst)::value,
                                        decltype(sym)::value>, smem, h, w, tile, stream, x,
                            ll2, hl2, lh2, hh2, hl1, lh1, hh1, h, w, tile, *P);
    });
}

// The inverse's steps (already reversed and negated) alternate s, d from
// s (2 or 4 of them), or are one d step: every wavelet the fused kernels
// accept.  ``out`` must be 16-byte aligned (the stores are 16 bytes wide).
template <typename T>
int launch_inv2(const T* ll2, const T* hl2, const T* lh2, const T* hh2,
                const T* hl1, const T* lh1, const T* hh1, T* out, int h, int w,
                int tile, const LiftParams* P, cudaStream_t stream) {
    if (tile + 2 * IH1 > THREADS) return (int)cudaErrorInvalidValue;  // a line a thread
    if (reinterpret_cast<uintptr_t>(out) % 16) return (int)cudaErrorInvalidValue;
    for (int s = 0; s < P->n; ++s)
        if (P->is_d[s] != (P->n == 1 || s % 2 == 1)) return (int)cudaErrorInvalidValue;
    const int E2 = tile / 2 + 2 * IH2, E1 = tile + 2 * IH1;
    const size_t smem =
        sizeof(T) * (size_t)(E2 * lines::stride(E2) + E1 * lines::stride(E1));
    return dispatch<T>(tile, P, [&](auto tc, auto nst, auto sym) {
        return launch_tiles(inv2_kernel<T, decltype(tc)::value, decltype(nst)::value,
                                        decltype(sym)::value>, smem, h, w, tile, stream,
                            ll2, hl2, lh2, hh2, hl1, lh1, hh1, out, h, w, tile, *P);
    });
}

}  // namespace

#define LIBDWT_FUSED2(SUF, T)                                                     \
    extern "C" int dwt_fwd2_##SUF(const T* x, T* ll2, T* hl2, T* lh2, T* hh2,      \
                                  T* hl1, T* lh1, T* hh1, int h, int w, int tile, \
                                  const LiftParams* P, void* stream) {            \
        return launch_fwd2<T>(x, ll2, hl2, lh2, hh2, hl1, lh1, hh1, h, w, tile,   \
                              P, (cudaStream_t)stream);                           \
    }                                                                             \
    extern "C" int dwt_inv2_##SUF(const T* ll2, const T* hl2, const T* lh2,        \
                                  const T* hh2, const T* hl1, const T* lh1,       \
                                  const T* hh1, T* out, int h, int w, int tile,   \
                                  const LiftParams* P, void* stream) {            \
        return launch_inv2<T>(ll2, hl2, lh2, hh2, hl1, lh1, hh1, out, h, w, tile, \
                              P, (cudaStream_t)stream);                           \
    }

LIBDWT_FUSED2(f32, float)
LIBDWT_FUSED2(i32, int)
LIBDWT_FUSED2(f64, double)
