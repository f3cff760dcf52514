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
// Each kernel has its own body (namespaces fwd2 and inv2 of fused2l.cuh,
// which B11/B12 in streamed.cu run too, on the line walks of namespace
// lines, lines.cuh): the same operations as the first port's shared
// two-level tiles (lift_one's arithmetic, the axis order and the
// scale, the LL1 re-mirror or channel rule, even tile starts and
// whole-point mirror reads), so their outputs equal the plain versions bit for bit.  What
// held the shared bodies back (B2 0.37 ms and B5 0.34 ms at 2144x4096 f32
// on an H100, 16-18x the bound), and what these do about it (PERF.md has
// the measurements of each step):
//   * Their column steps put neighbouring threads two rows apart
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

#include "fused2l.cuh"
#include "lines.cuh"
#include "tiles.cuh"

namespace {

constexpr int HALO2 = tiles::HALO2;
constexpr int IH2 = tiles::IH2;
constexpr int IH1 = tiles::IH1;
constexpr int THREADS = 256;

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
    fwd2::load(x, s1, RS, h, w, y0, x0, E, E, lines::aligned16(x) && w % 4 == 0);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    lines::lift_fwd<NST, SYM>(s1, E, RS, P);
    T* const b1[3] = {hl1, lh1, hh1};
    fwd2::store_bands(s1, RS, HALO2, b1, tile / 2, tile / 2, y0 / 2, x0 / 2, h / 2, w / 2, P);
    fwd2::ll1_window(s1, RS, s2, RS1, h, w, y0, x0, E1, E1, P);
    __syncthreads();
    lines::lift_fwd<NST, SYM>(s2, E1, RS1, P);
    T* const b2[4] = {ll2, hl2, lh2, hh2};
    fwd2::store_bands(s2, RS1, 4, b2, tile / 4, tile / 4, y0 / 4, x0 / 4, h / 4, w / 4, P);
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
    inv2::load_level2(ll2, hl2, lh2, hh2, s2, RS2, E2, E2, h, w, y0, x0);
    __pipeline_commit();
    // the level-1 details, in flight while level 2 lifts
    inv2::load_level1(hl1, lh1, hh1, s1, RS1, E1, E1, h, w, y0, x0);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    lines::lift_inv<NST, SYM>(s2, E2, RS2, P);
    inv2::ll1_window(s2, RS2, s1, RS1, h, w, y0, x0, E1 / 2, E1 / 2);
    __pipeline_wait_prior(0);
    __syncthreads();
    lines::lift_inv<NST, SYM>(s1, E1, RS1, P);
    inv2::store(s1, RS1, out, h, w, y0, x0, tile, tile);
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
