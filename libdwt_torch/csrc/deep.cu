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
//     level's tiles, then a grid-wide barrier; each level's LL (forward)
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
//     (tiles.cuh band_ptr's rule; ceil/floor widths for odd sizes).
//   * The forward's scale is applied as each band value is stored, the
//     inverse's as the column walk first reads a sample (the same
//     multiply as a separate pass, so the same bits).  Stores are 16 bytes
//     where a run of the row is whole and aligned, else element by element.
// The arithmetic is lift_one's in the plain order, so every output equals
// the plain versions (ops/fused.py fused_deep_*_plain) bit for bit in
// float32, float64 and int32.  float64 doubles the shared memory (42 KB at
// the default tile 32).
#include <algorithm>

#include <cooperative_groups.h>

#include "lines.cuh"
#include "onelevel.cuh"

namespace cg = cooperative_groups;

namespace {

using onelevel::HALO;
using onelevel::Level;
constexpr int THREADS = 256;
constexpr int MAX_DEEP = 16;
constexpr int MIN_TILE = 8;

template <typename T>
struct Deep {
    int n;
    Level<T> lv[MAX_DEEP];
};

// Forward, levels fine to coarse: each tile of a level loaded, lifted
// (rows, columns) and stored into the four bands; the level's LL is the
// next level's image.  NST: the lifting steps (1, 2 or 4, alternating d,
// s from d); SYM: all symmetric.
template <typename T, int NST, bool SYM>
__global__ void __launch_bounds__(THREADS) deep_fwd_kernel(Deep<T> d, LiftParams P) {
    extern __shared__ __align__(16) unsigned char deep_smem[];
    T* s = reinterpret_cast<T*>(deep_smem);
    cg::grid_group grid = cg::this_grid();
    for (int k = 0; k < d.n; ++k) {
        const Level<T> L = d.lv[k];
        const int S = 2 * L.tile, E = S + 2 * HALO, RS = lines::stride(E);
        const int nx = (L.w + S - 1) / S, ntiles = nx * ((L.h + S - 1) / S);
        const bool vec = L.w % 2 == 0
            && reinterpret_cast<uintptr_t>(L.img) % (2 * sizeof(T)) == 0;
        for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
            const int y0 = t / nx * S, x0 = t % nx * S;
            onelevel::fwd_load<0>(L, s, RS, E, y0, x0, vec);
            __pipeline_commit();
            __pipeline_wait_prior(0);
            __syncthreads();
            lines::lift_fwd<NST, SYM>(s, E, RS, P);
            onelevel::fwd_store(s, RS, L, y0, x0, P);
            __syncthreads();
        }
        if (k + 1 < d.n) grid.sync();
    }
}

// Inverse, levels coarse to fine: each tile of a level's output loaded
// from its bands, lifted (scaled columns, rows) and stored; the output is
// the next level's LL.  NST: the steps (2 or 4, alternating s, d from s;
// or 1, a d step).
template <typename T, int NST, bool SYM>
__global__ void __launch_bounds__(THREADS) deep_inv_kernel(Deep<T> d, LiftParams P) {
    extern __shared__ __align__(16) unsigned char deep_smem[];
    T* s = reinterpret_cast<T*>(deep_smem);
    cg::grid_group grid = cg::this_grid();
    for (int k = 0; k < d.n; ++k) {
        const Level<T> L = d.lv[k];
        const int S = 2 * L.tile, E = S + 2 * HALO, RS = lines::stride(E);
        const int nx = (L.w + S - 1) / S, ntiles = nx * ((L.h + S - 1) / S);
        for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
            const int y0 = t / nx * S, x0 = t % nx * S;
            onelevel::inv_load<0>(L, s, RS, E, y0, x0);
            __pipeline_commit();
            __pipeline_wait_prior(0);
            __syncthreads();
            lines::lift_inv<NST, SYM>(s, E, RS, P);
            onelevel::inv_store(s, RS, L, y0, x0);
            __syncthreads();
        }
        if (k + 1 < d.n) grid.sync();
    }
}

// ------------------------------------------------------------ host side

int tiles_of(int h, int w, int tile) {
    return ((h + 2 * tile - 1) / (2 * tile)) * ((w + 2 * tile - 1) / (2 * tile));
}

// The tile of an h x w level: ``tile``, halved while the level has fewer
// tiles than the card has SMs and the half is at least MIN_TILE.
int level_tile(int h, int w, int tile, int sms) {
    while (tile % 2 == 0 && tile / 2 >= MIN_TILE && tiles_of(h, w, tile) < sms) tile /= 2;
    return tile;
}

// Fill d's levels from ptrs (4n + 1 pointers: level k's image or LL is
// ptrs[4k]; its other three bands ptrs[4k + 1 .. 4k + 3]; ptrs[4k + 4] is
// what it makes: the forward's LL, the inverse's output) and their sizes,
// fine to coarse from h x w (forward) or coarse to fine up to h x w
// (inverse); the shared memory of the largest window and the most tiles.
template <typename T>
int plan(Deep<T>& d, void* const* ptrs, int n, int h, int w, int tile, bool inverse,
         size_t* smem, int* most, int* sms) {
    if (n < 1 || n > MAX_DEEP || tile < 1 || 2 * tile + 2 * HALO > THREADS)
        return (int)cudaErrorInvalidValue;  // a line a thread
    int dev = 0, err = (int)cudaGetDevice(&dev);
    if (err || (err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)))
        return err;
    T* const* p = reinterpret_cast<T* const*>(ptrs);
    int hs[MAX_DEEP], ws[MAX_DEEP];
    for (int k = 0; k < n; ++k) {
        hs[k] = h;
        ws[k] = w;
        h = (h + 1) / 2;
        w = (w + 1) / 2;
    }
    d.n = n;
    *smem = 0;
    *most = 0;
    for (int k = 0; k < n; ++k) {
        Level<T>& L = d.lv[k];
        L.h = hs[inverse ? n - 1 - k : k];
        L.w = ws[inverse ? n - 1 - k : k];
        L.tile = level_tile(L.h, L.w, tile, *sms);
        if (inverse) {
            L.img = p[4 * k + 4];
            L.band[0] = p[4 * k];
        } else {
            L.img = p[4 * k];
            L.band[0] = p[4 * k + 4];
        }
        for (int b = 1; b < 4; ++b) L.band[b] = p[4 * k + b];
        const int E = 2 * L.tile + 2 * HALO;
        *smem = std::max(*smem, sizeof(T) * (size_t)(E * lines::stride(E)));
        *most = std::max(*most, tiles_of(L.h, L.w, L.tile));
    }
    return 0;
}

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
    Deep<T> d;
    size_t smem = 0;
    int most = 0, sms = 0;
    const int err = plan(d, ptrs, n, h, w, tile, false, &smem, &most, &sms);
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
    Deep<T> d;
    size_t smem = 0;
    int most = 0, sms = 0;
    const int err = plan(d, ptrs, n, h, w, tile, true, &smem, &most, &sms);
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
