// The deep levels of a 2-D pyramid in one cooperative launch, shared by
// deep.cu (B3/B6: the whole launch) and streamed.cu (B11/B12: after or
// before their strips, across a grid sync).  deep.cu's header says what
// each step does and why.
//
// Each level is a grid-stride loop over its tiles of onelevel.cuh's body
// (load, lines.cuh's lift, store), with a grid-wide barrier between levels;
// each level's LL (forward) or reconstruction (inverse) goes to a device
// buffer that the next level reads from L2.  The host picks each level's
// tile (level_tile) and fills the levels (plan).
#pragma once

#include <algorithm>

#include <cooperative_groups.h>

#include "lines.cuh"
#include "onelevel.cuh"

namespace deep {

using onelevel::HALO;
using onelevel::Level;
constexpr int THREADS = 256;  // a block of every kernel that runs the levels
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
// s from d); SYM: all symmetric.  s: the block's shared memory.
template <int NST, bool SYM, typename T>
__device__ __forceinline__ void fwd_levels(const Deep<T>& d, const LiftParams& P, T* s) {
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    for (int k = 0; k < d.n; ++k) {
        const Level<T> L = d.lv[k];
        const int S = 2 * L.tile, E = S + 2 * HALO, RS = lines::stride(E);
        const int nx = (L.w + S - 1) / S, ntiles = nx * ((L.h + S - 1) / S);
        const bool vec = L.w % 2 == 0
            && reinterpret_cast<uintptr_t>(L.img) % (2 * sizeof(T)) == 0;
        for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
            const int y0 = t / nx * S, x0 = t % nx * S;
            onelevel::fwd_load<0>(L, s, RS, E, E, y0, x0, vec);
            __pipeline_commit();
            __pipeline_wait_prior(0);
            __syncthreads();
            lines::lift_fwd<NST, SYM>(s, E, RS, P);
            onelevel::fwd_store(s, RS, L, y0, x0, L.tile, L.tile, P);
            __syncthreads();
        }
        if (k + 1 < d.n) grid.sync();
    }
}

// Inverse, levels coarse to fine: each tile of a level's output loaded
// from its bands, lifted (scaled columns, rows) and stored; the output is
// the next level's LL.  NST: the steps (2 or 4, alternating s, d from s;
// or 1, a d step).
template <int NST, bool SYM, typename T>
__device__ __forceinline__ void inv_levels(const Deep<T>& d, const LiftParams& P, T* s) {
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    for (int k = 0; k < d.n; ++k) {
        const Level<T> L = d.lv[k];
        const int S = 2 * L.tile, E = S + 2 * HALO, RS = lines::stride(E);
        const int nx = (L.w + S - 1) / S, ntiles = nx * ((L.h + S - 1) / S);
        for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
            const int y0 = t / nx * S, x0 = t % nx * S;
            onelevel::inv_load<0>(L, s, RS, E, E, y0, x0);
            __pipeline_commit();
            __pipeline_wait_prior(0);
            __syncthreads();
            lines::lift_inv<NST, SYM>(s, E, RS, P);
            onelevel::inv_store(s, RS, L, y0, x0, S, S);
            __syncthreads();
        }
        if (k + 1 < d.n) grid.sync();
    }
}

// ------------------------------------------------------------ host side

inline int tiles_of(int h, int w, int tile) {
    return ((h + 2 * tile - 1) / (2 * tile)) * ((w + 2 * tile - 1) / (2 * tile));
}

// The tile of an h x w level: ``tile``, halved while the level has fewer
// tiles than the card has SMs and the half is at least MIN_TILE.
inline int level_tile(int h, int w, int tile, int sms) {
    while (tile % 2 == 0 && tile / 2 >= MIN_TILE && tiles_of(h, w, tile) < sms) tile /= 2;
    return tile;
}

// Fill d's n levels (0..MAX_DEEP) from ptrs (4n + 1 pointers: level k's
// image or LL is ptrs[4k]; its other three bands ptrs[4k + 1 .. 4k + 3];
// ptrs[4k + 4] is what it makes: the forward's LL, the inverse's output)
// and their sizes, fine to coarse from h x w (forward) or coarse to fine
// up to h x w (inverse); the shared memory of the largest window, the most
// tiles of any level and the card's SMs.
template <typename T>
int plan(Deep<T>& d, void* const* ptrs, int n, int h, int w, int tile, bool inverse,
         size_t* smem, int* most, int* sms) {
    if (n < 0 || n > MAX_DEEP || tile < 1 || 2 * tile + 2 * HALO > THREADS)
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

}  // namespace deep
