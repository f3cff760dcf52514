// One-level 2-D DWT tile kernels for Hopper (sm_90a), any h, w >= 1:
// the single fused level.
//   dwt_fwd1_*  replaces libdwt_tpu/ops/fused.py fused_dwt2_level (:548,
//               bodies _fwd_kernel_pf :510 and _fwd_kernel :492; TPU
//               kernel id B1);
//   dwt_inv1_*  replaces fused_idwt2_level (:984, body _inv_kernel :948;
//               B4).
//
// Bound on an H100: bytes.  On a 2144x4096 f32 frame the level moves
// 70.3 MB (21 us at 3.35 TB/s); the (2t + 8)^2 window re-reads 1.27x the
// core at t = 32, and those re-reads hit L2.
//
// Each block takes one tile of ``tile`` band samples a side (2176 tiles
// at t = 32 on that frame, 16x the card's SMs, so many blocks share an SM
// and one block's loads overlap another's lifting; no grid sync).  The
// body is onelevel.cuh's, shared with the deep tails (deep.cu):
//   * Forward: the (2t + 8)-square window copied in with cp.async, every
//     row in flight, two columns a thread mirrored once, rows mirrored
//     only in tiles that cross an edge; lines::lift_fwd (rows, then
//     columns: one thread walks each line, or a segment of it, with every
//     lifting step pipelined in registers; a row stride of 2 mod 4, so
//     the column walks are conflict-free); each band's samples stored
//     times their scale, 16 bytes where a run is whole and aligned.
//   * Inverse: the interleaved window read element by element from the
//     four bands through the whole-point mirror (it keeps parity, so a
//     mirrored sample stays in its band: the channel rules, ceil/floor
//     widths for odd sizes); lines::lift_inv (the scale on the column
//     walk's first read, the columns, then the rows); the output stored 16
//     bytes at a time where whole and aligned.
//   * ``ext_rows`` (EXT = 4) is boundary_rows='extended': the caller
//     supplies 4 rows above and below the image (forward: x has h + 8
//     rows) or 4 channel rows above and below every band (inverse), read
//     straight with no row mirror; columns still mirror.  Rows past the
//     extension read as 0; they reach only outputs past the image, which
//     are not stored.
// The arithmetic is lift_one's in the plain order (forward rows, columns,
// scale; inverse scale, columns, rows), so every output equals the plain
// versions (ops/fused.py dwt2_level_plain, idwt2_level_plain) bit for bit
// in float32, float64 and int32.  The window takes 21 KB of shared memory
// at t = 32 in float32, 42 KB in float64.
#include <cstdint>

#include "lines.cuh"
#include "onelevel.cuh"

namespace {

using onelevel::HALO;
using onelevel::Level;
constexpr int THREADS = 256;

// One forward tile a block: load, lift (rows, columns), store with the
// scale.  NST: the lifting steps (1, 2 or 4, alternating d, s from d);
// SYM: all symmetric; EXT: 0 or the extension's rows.
template <typename T, int NST, bool SYM, int EXT>
__global__ void __launch_bounds__(THREADS) fwd1_kernel(Level<T> L, bool vec, LiftParams P) {
    extern __shared__ __align__(16) unsigned char level_smem[];
    T* s = reinterpret_cast<T*>(level_smem);
    const int S = 2 * L.tile, E = S + 2 * HALO, RS = lines::stride(E);
    const int y0 = blockIdx.y * S, x0 = blockIdx.x * S;
    onelevel::fwd_load<EXT>(L, s, RS, E, E, y0, x0, vec);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    lines::lift_fwd<NST, SYM>(s, E, RS, P);
    onelevel::fwd_store(s, RS, L, y0, x0, L.tile, L.tile, P);
}

// One inverse tile a block: load from the bands, lift (scaled columns,
// rows), store.  NST: the steps (2 or 4, alternating s, d from s; or 1, a
// d step).
template <typename T, int NST, bool SYM, int EXT>
__global__ void __launch_bounds__(THREADS) inv1_kernel(Level<T> L, LiftParams P) {
    extern __shared__ __align__(16) unsigned char level_smem[];
    T* s = reinterpret_cast<T*>(level_smem);
    const int S = 2 * L.tile, E = S + 2 * HALO, RS = lines::stride(E);
    const int y0 = blockIdx.y * S, x0 = blockIdx.x * S;
    onelevel::inv_load<EXT>(L, s, RS, E, E, y0, x0);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    lines::lift_inv<NST, SYM>(s, E, RS, P);
    onelevel::inv_store(s, RS, L, y0, x0, S, S);
}

// ------------------------------------------------------------ host side

// Launch ``kernel`` with ``args`` over the tiles of an h x w level (one
// block each), with its window's shared memory; a window wider than the
// block's threads (2 tile + 8 > 256: a line a thread) is refused.
template <typename K, typename... A>
int launch_tiles(K kernel, int h, int w, int tile, size_t item, cudaStream_t stream,
                 A... args) {
    const int S = 2 * tile, E = S + 2 * HALO;
    if (tile < 1 || E > THREADS) return (int)cudaErrorInvalidValue;
    const size_t smem = item * (size_t)E * lines::stride(E);
    if (smem > 48 * 1024) {
        const int err = (int)cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err) return err;
    }
    const dim3 grid((w + S - 1) / S, (h + S - 1) / S);
    kernel<<<grid, THREADS, smem, stream>>>(args...);
    return (int)cudaGetLastError();
}

// The forward's steps alternate d, s from d (1, 2 or 4 of them): every
// wavelet the fused kernels accept.
template <typename T, int EXT>
int launch_fwd1(const T* x, T* ll, T* hl, T* lh, T* hh, int h, int w, int tile,
                const LiftParams* P, cudaStream_t stream) {
    for (int s = 0; s < P->n; ++s)
        if (P->is_d[s] != (s % 2 == 0)) return (int)cudaErrorInvalidValue;
    const Level<T> L{const_cast<T*>(x), {ll, hl, lh, hh}, h, w, tile};
    const bool vec = w % 2 == 0 && reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0;
    return dispatch<T>(0, P, [&](auto, auto nst, auto sym) {
        return launch_tiles(fwd1_kernel<T, decltype(nst)::value, decltype(sym)::value, EXT>,
                            h, w, tile, sizeof(T), stream, L, vec, *P);
    });
}

// The inverse's steps (already reversed and negated) alternate s, d from
// s (2 or 4 of them), or are one d step.
template <typename T, int EXT>
int launch_inv1(const T* ll, const T* hl, const T* lh, const T* hh, T* out, int h, int w,
                int tile, const LiftParams* P, cudaStream_t stream) {
    for (int s = 0; s < P->n; ++s)
        if (P->is_d[s] != (P->n == 1 || s % 2 == 1)) return (int)cudaErrorInvalidValue;
    const Level<T> L{out,
                     {const_cast<T*>(ll), const_cast<T*>(hl), const_cast<T*>(lh),
                      const_cast<T*>(hh)},
                     h, w, tile};
    return dispatch<T>(0, P, [&](auto, auto nst, auto sym) {
        return launch_tiles(inv1_kernel<T, decltype(nst)::value, decltype(sym)::value, EXT>,
                            h, w, tile, sizeof(T), stream, L, *P);
    });
}

}  // namespace

// h, w: the image's size (without the extension when ext_rows is set);
// tile: band samples a side (2 * tile + 8 <= 256).
#define LIBDWT_LEVEL(SUF, T)                                                               \
    extern "C" int dwt_fwd1_##SUF(const T* x, T* ll, T* hl, T* lh, T* hh, int h, int w,    \
                                  int tile, int ext_rows, const LiftParams* P,             \
                                  void* stream) {                                          \
        const auto st = (cudaStream_t)stream;                                              \
        return ext_rows ? launch_fwd1<T, HALO>(x, ll, hl, lh, hh, h, w, tile, P, st)       \
                        : launch_fwd1<T, 0>(x, ll, hl, lh, hh, h, w, tile, P, st);         \
    }                                                                                      \
    extern "C" int dwt_inv1_##SUF(const T* ll, const T* hl, const T* lh, const T* hh,      \
                                  T* out, int h, int w, int tile, int ext_rows,            \
                                  const LiftParams* P, void* stream) {                     \
        const auto st = (cudaStream_t)stream;                                              \
        return ext_rows ? launch_inv1<T, HALO>(ll, hl, lh, hh, out, h, w, tile, P, st)     \
                        : launch_inv1<T, 0>(ll, hl, lh, hh, out, h, w, tile, P, st);       \
    }

LIBDWT_LEVEL(f32, float)
LIBDWT_LEVEL(i32, int)
LIBDWT_LEVEL(f64, double)
