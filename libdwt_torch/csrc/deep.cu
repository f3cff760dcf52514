// Deep pyramid tails of the fused 2-D path for Hopper (sm_90a): every
// level of a call in ONE cooperative launch, as the TPU kernels do.
//
// dwt_deep_fwd_*  replaces libdwt_tpu/ops/fused.py fused_deep_wavedec2
//                 (:1381, body _deep_kernel :1353; TPU kernel id B3).
// dwt_deep_inv_*  replaces fused_deep_waverec2 (:1486, body
//                 _deep_inv_kernel :1466; TPU kernel id B6).
//
// Bound on an H100: neither bytes nor operations.  The main path's deep
// tail (536x1024 f32 in, three levels) reads and writes 5.8 MB in all,
// ~1.7 us at 3.35 TB/s, and that data stays in the 50 MB L2 (B2 has just
// written it).  Each level has only 40-144 tiles for 132 SMs, so a level
// lasts as long as one tile's life: load, lift, store.  One launch per
// level took ~31 us a level.  The design cuts the tile's life and the
// launches:
//   * One cooperative launch for all levels: a grid-stride loop over each
//     level's tiles, then a grid-wide barrier (deep.cuh's level loop, which
//     B11/B12 in streamed.cu run too); each level's LL (forward)
//     or reconstruction (inverse) goes to a device buffer that the next
//     level reads from L2.  The grid is the most tiles of any level,
//     capped by the blocks that fit on the card at once.
//   * The host picks each level's tile: the first level takes ``tile``,
//     a smaller level halves it (down to MIN_TILE) while it has fewer
//     tiles than the card has SMs.  The plain versions are tile-invariant
//     (every output depends only on its own neighbourhood, read at global
//     positions), so any tile gives their bits.
//   * A tile is onelevel.cuh's body (shared with B1/B4, level.cu): a
//     (2t + 8)-square window with halo 4 on both axes, lifted by
//     lines.cuh's walks: one thread per line (or segment) with every step
//     pipelined in registers, one barrier pair per pass, a row stride of
//     2 mod 4 so the column walks are conflict-free.
//   * Forward loads: cp.async with every row in flight, two columns a
//     thread mirrored once, rows mirrored only in tiles that cross an edge
//     (no per-element division).  Inverse loads: the interleaved window
//     read element by element from the four bands through the whole-point
//     mirror, which keeps parity, so a mirrored sample stays in its band
//     (onelevel.cuh inv_load's rule; ceil/floor widths for odd sizes).
//   * The forward's scale is applied as each band value is stored, the
//     inverse's as the column walk first reads a sample (the same
//     multiply as a separate pass, so the same bits).  Stores are 16 bytes
//     where a run of the row is whole and aligned, else element by element.
// The arithmetic is lift_one's in the plain order, so every output equals
// the plain versions (ops/fused.py fused_deep_*_plain) bit for bit in
// float32, float64 and int32.  float64 doubles the shared memory (42 KB at
// the default tile 32).
#include <algorithm>

#include "deep.cuh"

namespace {

using deep::Deep;
using deep::THREADS;

// The levels of ``deep.cuh`` alone.  NST: the lifting steps (forward: 1, 2
// or 4, alternating d, s from d; inverse: 2 or 4, alternating s, d from s,
// or 1, a d step); SYM: all symmetric.
template <typename T, int NST, bool SYM>
__global__ void __launch_bounds__(THREADS) deep_fwd_kernel(Deep<T> d, LiftParams P) {
    extern __shared__ __align__(16) unsigned char deep_smem[];
    deep::fwd_levels<NST, SYM>(d, P, reinterpret_cast<T*>(deep_smem));
}

template <typename T, int NST, bool SYM>
__global__ void __launch_bounds__(THREADS) deep_inv_kernel(Deep<T> d, LiftParams P) {
    extern __shared__ __align__(16) unsigned char deep_smem[];
    deep::inv_levels<NST, SYM>(d, P, reinterpret_cast<T*>(deep_smem));
}

// ------------------------------------------------------------ host side

// One cooperative launch of ``kernel`` over d: as many blocks as the
// level with the most tiles has, capped by the blocks the card holds at
// once.  info[0..1] <- grid, resident blocks.
template <typename K, typename T>
int launch_coop(K kernel, Deep<T> d, LiftParams P, size_t smem, int most, int sms,
                int* info, cudaStream_t stream) {
    int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem);
    int per_sm = 0;
    if (err || (err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                         THREADS, smem)))
        return err;
    info[1] = per_sm * sms;
    if (info[1] < 1) return (int)cudaErrorInvalidConfiguration;
    info[0] = std::min(most, info[1]);
    void* args[] = {(void*)&d, (void*)&P};
    err = (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(info[0]), dim3(THREADS),
                                           args, smem, stream);
    return err ? err : (int)cudaGetLastError();
}

// The forward's steps alternate d, s from d (1, 2 or 4 of them): every
// wavelet the fused kernels accept.
template <typename T>
int launch_deep_fwd(void* const* ptrs, int n, int h, int w, int tile, int* info,
                    const LiftParams* P, cudaStream_t stream) {
    for (int s = 0; s < P->n; ++s)
        if (P->is_d[s] != (s % 2 == 0)) return (int)cudaErrorInvalidValue;
    if (n < 1) return (int)cudaErrorInvalidValue;
    Deep<T> d;
    size_t smem = 0;
    int most = 0, sms = 0;
    const int err = deep::plan(d, ptrs, n, h, w, tile, false, &smem, &most, &sms);
    if (err) return err;
    return dispatch<T>(0, P, [&](auto, auto nst, auto sym) {
        return launch_coop(deep_fwd_kernel<T, decltype(nst)::value, decltype(sym)::value>, d,
                           *P, smem, most, sms, info, stream);
    });
}

// The inverse's steps (already reversed and negated) alternate s, d from
// s (2 or 4 of them), or are one d step.
template <typename T>
int launch_deep_inv(void* const* ptrs, int n, int h, int w, int tile, int* info,
                    const LiftParams* P, cudaStream_t stream) {
    for (int s = 0; s < P->n; ++s)
        if (P->is_d[s] != (P->n == 1 || s % 2 == 1)) return (int)cudaErrorInvalidValue;
    if (n < 1) return (int)cudaErrorInvalidValue;
    Deep<T> d;
    size_t smem = 0;
    int most = 0, sms = 0;
    const int err = deep::plan(d, ptrs, n, h, w, tile, true, &smem, &most, &sms);
    if (err) return err;
    return dispatch<T>(0, P, [&](auto, auto nst, auto sym) {
        return launch_coop(deep_inv_kernel<T, decltype(nst)::value, decltype(sym)::value>, d,
                           *P, smem, most, sms, info, stream);
    });
}

}  // namespace

// ptrs: a host array of 4n + 1 device pointers.  Forward: the image, then
// per level (fine first) hl, lh, hh, ll (each ll the next level's image;
// the last one the coarsest LL); h x w the image's size.  Inverse: the
// coarsest LL, then per level (coarse first) hl, lh, hh and the
// reconstruction (each the next level's LL; the last one the output);
// h x w the output's size.  tile: the finest level's tile (band samples a
// side, 2 * tile + 8 <= 256).  info[0..1] <- grid, resident blocks.
#define LIBDWT_DEEP(SUF, T)                                                            \
    extern "C" int dwt_deep_fwd_##SUF(void* const* ptrs, int n, int h, int w, int tile, \
                                      int* info, const LiftParams* P, void* stream) {  \
        return launch_deep_fwd<T>(ptrs, n, h, w, tile, info, P, (cudaStream_t)stream);  \
    }                                                                                  \
    extern "C" int dwt_deep_inv_##SUF(void* const* ptrs, int n, int h, int w, int tile, \
                                      int* info, const LiftParams* P, void* stream) {  \
        return launch_deep_inv<T>(ptrs, n, h, w, tile, info, P, (cudaStream_t)stream);  \
    }

LIBDWT_DEEP(f32, float)
LIBDWT_DEEP(i32, int)
LIBDWT_DEEP(f64, double)
