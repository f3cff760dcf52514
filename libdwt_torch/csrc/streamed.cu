// Streamed 2-D DWT kernels for Hopper (sm_90a): the single levels one strip
// a block; the two-level strips and the pyramids a persistent block walking
// strips down a column band, the next strip's load in flight while the
// current one lifts.
//
// dwt_sfwd1_*      replaces libdwt_tpu/ops/streamed.py streamed_dwt2_level
//                  (:257, kernel :300; TPU kernel id B7): one level.
// dwt_sinv1_*      replaces streamed_idwt2_level (:535, kernel :579; B9).
// dwt_sfwd2_*      replaces streamed_dwt2_2level (:369, kernel :423; B8).
// dwt_sinv2_*      replaces streamed_idwt2_2level (:651, kernel :715; B10).
// dwt_sdeep_fwd_*  replaces streamed_wavedec2_deep (:924, kernel :998; B11):
//                  the whole forward pyramid in one launch.
// dwt_sdeep_inv_*  replaces streamed_waverec2_deep (:1154, kernel :1277;
//                  B12): the whole inverse pyramid in one launch.
//
// Bound on an H100: bytes.  Each pixel is read once and each coefficient
// written once (2144x4096 f32: 35.1 MB each way, ~21 us at 3.35 TB/s); the
// lifting is ~16 flops per pixel over both levels, far below 67 TFLOP/s.
//
// B7-B12.  The TPU kernels stream full-width strips because its lane axis
// needs no halo; a 4096-wide f32 strip with its halo does not fit a block's
// 227 KB.  Here the frame is cut into column bands of tx samples and strips
// of ty rows.  B8/B10/B11/B12 cut each band into segments of strips, and
// one work item is a (band, segment): a persistent block walks down its
// item strip by strip.  B7/B9 take one strip a block.
//
// The two levels B8/B10 (sstrip_fwd_lines, sstrip_inv_lines) run the strip
// phase of B11/B12 below and nothing else: fused2l.cuh's B2/B5 bodies on
// one buffer a block, in an ordinary launch, so that the compiler sizes
// the registers for the strip walk alone (B11/B12's cooperative kernels
// carry deep.cuh's level loop too).  Their halos are B2/B5's (HALO2 = 12
// on both axes forward; IH2 = 8 and IH1 = 4 inverse), so B8 equals B2 and
// B10 equals B5 bit for bit, and both equal their plain versions in
// ops/streamed.py, which do not depend on the strip.  The first port ran
// them on tiles.cuh's two-level tile with lift_tile and two buffers a
// block: 0.5044 / 0.4420 ms on an H100 at 2144x4096 f32, 21-24x the bound.
//
// The single levels B7/B9 (sfwd1_lines, sinv1_lines) run onelevel.cuh's
// one-level body, B1/B4's, on each strip: one block a strip of ty x tx
// samples and its (ty + 8) x (tx + 8) window (a halo of 4 on both axes),
// many blocks an SM (6 at 40 registers and 21 KB, float32), no walk and no
// grid sync, the shared memory sized by sizeof(T); the default 64x64 strip
// is a compile-time constant, as B8/B10's is (a strip taken at run time
// cost B7/B9 5% of their device time at 64x64: the window's rows and
// columns are then two sizes to divide by).  A persistent walk of each
// column band with the next strip's window in flight (two buffers, as the
// first port had) lost to this launch by 1.3-1.4x on an H100 (PERF.md).
// Forward: the window copied in with cp.async, every row in
// flight, two columns a thread mirrored once, rows mirrored only in strips
// that cross an edge; lines::lift_fwd (one thread a row, then a column,
// every lifting step pipelined in registers, a row stride of 2 mod 4); each
// band's samples stored times their scale, 16 bytes where a run is whole
// and aligned.  Inverse: the interleaved window read element by element
// from the four bands through the whole-point mirror, which for equal band
// shapes is exactly _fix_strip's channel rules; lines::lift_inv (the scale
// on the column walk's first read, the columns, then the rows); the output
// stored 16 bytes at a time where whole and aligned.  Under
// boundary_rows='extended' (EXT = TOP = 8) the input carries 8 rows
// (forward) or channel rows (inverse) above and below, read straight;
// rows past them read as 0.  A strip side over 248 (a window line over the
// block's 256 threads) is refused.  The default 64x64 strip is B1/B4's tile
// 32, the same 72x72 window, so B7 equals B1 and B9 equals B4 bit for bit
// on any frame, and both equal their plain versions (ops/streamed.py),
// which do not depend on the strip.
// The first port walked each column band through two buffers on
// tiles.cuh's lift_tile: 0.2371-0.2396 / 0.2428-0.2452 ms of device time
// at 2144x4096 f32 on an H100 80GB HBM3 at 700 W, 11-12x the bound.  A
// 2144x4096 f32 level moves 70.3 MB (21 us at 3.35 TB/s).
//
// B11/B12, the one-launch pyramids (dwt_sdeep_*: sdeep_fwd_lines and
// sdeep_inv_lines).  Bound: bytes, 70.3 MB at 2144x4096 f32 J=5 (21 us at
// 3.35 TB/s; the deep levels' 5.8 MB stays in the 50 MB L2).  Their first
// port ran the two-level strips on tiles.cuh's lift_tile and the deep levels on
// tiles::fwd1_tile/inv1_tile: 0.6531 / 0.5971 ms on an H100 (31x / 28x the
// bound), in lift_tile's 16- to 32-way column bank conflicts, per-update
// index arithmetic, a barrier a step, idle threads, and ~48 us a deep
// level.  Now one cooperative launch of two phases, a grid sync between:
//   * The strips walk the (band, segment) items, each window lifted
//     by fused2l.cuh's B2/B5 body: cp.async loads with every row in flight
//     and rows mirrored only in strips that cross an edge, one thread a
//     line with every step in registers (lines.cuh, rows x columns), the
//     scale folded into a store or a read, the LL1 re-mirror or channel
//     rule folded into a source index.  Halos as B2/B5's: HALO2 = 12 on
//     both axes forward (the plain versions are tile-invariant, so the
//     reference's 16-row TOP2 is not needed for the values); IH2 = 8 and
//     IH1 = 4 inverse.  A strip is ty x tx, any multiples of 4 whose
//     windows' lines fit the block (ty, tx <= 232 forward, 248 inverse).
//   * One buffer a block.  The forward loads strip i+1's window into it
//     as soon as strip i's level 1 has left it, while strip i's LL1 lifts;
//     the inverse commits a strip's level 2, then its level-1 details,
//     waited for only after level 2 lifts.  A second buffer, to load the
//     whole next strip while this one lifts, bought nothing measurable
//     (B11 / B12 0.1340 / 0.1237 ms with two, 0.1348 / 0.1258 with one, on
//     an H100 80GB HBM3 at 700 W, both at the 2 blocks an SM that the
//     registers allow) and would not fit float64 at 128x128 in 227 KB.
//   * The deep levels are deep.cuh's level loop, B3/B6's: a grid-stride
//     loop over each level's tiles of onelevel.cuh's body, a grid sync
//     between levels, each level's tile picked on the host by its rule.
//     B11 writes LL2 to a scratch buffer for them; B12's last level
//     rebuilds LL2 into one, which its strips read through the mirror
//     (the whole-point head and repeat tail channel rules of
//     streamed.py:1303-1319).
//   * The grid is the most items or tiles of either phase, capped by the
//     blocks resident at once (the occupancy query at the larger phase's
//     shared memory).  A launch with no deep level runs the strips alone.
// The arithmetic is the plain order's (__fadd_rn/__fmul_rn, integer steps
// for int32), so B11/B12 equal their plain versions, and B2 then B3 (B6
// then B5), bit for bit in float32, float64 and int32.
//
// The banded-matmul body (B13, banded.cuh) in B8/B10/B11/B12 with
// body='mxu' (dwt_*_mxu_f32, float32 only: sdeep_fwd_mxu and
// sdeep_inv_mxu) runs on B11/B12's scaffold with banded.cuh's passes in
// place of the line walks: the same persistent one-buffer strip walk (the
// forward loads the next strip while its LL1 lifts), the windows of the
// plain versions (forward TOP2 = 16 rows and HALO2 = 12 columns, LL1 halo
// 4; inverse IH2 = 8, IH1 = 4) on row strides of 8 mod 16 words,
// fused2l.cuh's loads, stores and LL1 windows (no scale: the matrices hold
// it), and deep.cuh's level loop behind the grid sync: the deep levels stay
// polyphase, as in the reference (streamed.py:1167-1169).  A launch with
// no deep level is B8/B10-mxu.  The matrices' fragments stay in global
// memory (a few KB, read through the read-only cache).  The first port's
// design (two buffers, the data's bf16 parts in shared memory, the
// fragments reloaded a tile) held one block an SM at 177 / 145 KB.
// Scratch buffers are never read before the grid sync that follows their
// writes, and no pointer is __restrict__, so no read can see a stale line.
//
// The float64 (f64) instantiations double every buffer: at the default
// 64x64 strip the two-level windows (B8/B10, B11/B12's strips) take 77 KB
// forward and 62 KB inverse, B7/B9's window 42 KB.  Shared memory and the grids are sized with
// sizeof(T), so the occupancy calculator sees the real footprint.
#include <algorithm>

#include <cooperative_groups.h>

#include "banded.cuh"
#include "deep.cuh"
#include "fused2l.cuh"
#include "lines.cuh"
#include "tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int TOP = 8;     // the single levels' extended contract (rows)
constexpr int TOP2 = 16;   // the banded forward strips' row halo

// Column bands of tx samples, each cut into nseg segments of sps strips of
// ty rows; item = seg * nbands + band.
struct Strips {
    int h, w, ty, tx, nbands, nstrips, sps, nseg;
    __host__ __device__ int items() const { return nbands * nseg; }
};

template <typename T>
struct FwdBands {
    T *ll2, *hl2, *lh2, *hh2, *hl1, *lh1, *hh1;
};

template <typename T>
struct InvBands {
    const T *ll2, *hl2, *lh2, *hh2, *hl1, *lh1, *hh1;
    T* out;
};

// B11's strips on fused2l.cuh's two-level body (the B2 window with halo
// HALO2 on both axes): each (band, segment) item walked down strip by
// strip, strip i+1's window loading into the one buffer as soon as strip
// i's level 1 has left it, while strip i's LL1 lifts.  ST: the strip's
// edge at compile time (64, the default strip), or 0 to take g's ty x tx;
// NST, SYM as for dispatch.
template <int ST, int NST, bool SYM, typename T>
__device__ __forceinline__ void fwd2_line_strips(const T* x, const FwdBands<T>& b,
                                                 const Strips& g, const LiftParams& P,
                                                 T* smem) {
    using tiles::HALO2;
    const int ty = ST ? ST : g.ty, tx = ST ? ST : g.tx;
    const int EY = ty + 2 * HALO2, EX = tx + 2 * HALO2, E1Y = ty / 2 + 8, E1X = tx / 2 + 8;
    const int RS = lines::stride(EX), RS1 = lines::stride(E1X);
    T* const s1 = smem;
    T* const s2 = s1 + EY * RS;  // EY % 4 == 0, RS even: 16-byte aligned
    const bool vec = lines::aligned16(x) && g.w % 4 == 0;
    T* const b1[3] = {b.hl1, b.lh1, b.hh1};
    T* const b2[4] = {b.ll2, b.hl2, b.lh2, b.hh2};
    for (int item = blockIdx.x; item < g.items(); item += gridDim.x) {
        const int x0 = (item % g.nbands) * tx;
        const int first = (item / g.nbands) * g.sps;
        const int last = min(g.nstrips, first + g.sps);
        fwd2::load(x, s1, RS, g.h, g.w, first * ty, x0, EY, EX, vec);
        __pipeline_commit();
        for (int i = first; i < last; ++i) {
            const int y0 = i * ty;
            __pipeline_wait_prior(0);
            __syncthreads();
            lines::lift_fwd<NST, SYM>(s1, EY, EX, RS, P);
            fwd2::store_bands(s1, RS, HALO2, b1, ty / 2, tx / 2, y0 / 2, x0 / 2, g.h / 2,
                              g.w / 2, P);
            fwd2::ll1_window(s1, RS, s2, RS1, g.h, g.w, y0, x0, E1Y, E1X, P);
            __syncthreads();
            if (i + 1 < last) {
                fwd2::load(x, s1, RS, g.h, g.w, y0 + ty, x0, EY, EX, vec);
                __pipeline_commit();
            }
            lines::lift_fwd<NST, SYM>(s2, E1Y, E1X, RS1, P);
            fwd2::store_bands(s2, RS1, 4, b2, ty / 4, tx / 4, y0 / 4, x0 / 4, g.h / 4, g.w / 4,
                              P);
        }
    }
}

// B12's strips on fused2l.cuh's two-level body: one stage, the level-2
// window and the level-1 window after it.  A strip's two copy groups
// (level 2, then the level-1 details) go in once the strip before is
// stored; the level-1 details are waited for only after level 2 lifts.
// ST, NST, SYM as for fwd2_line_strips.
template <int ST, int NST, bool SYM, typename T>
__device__ __forceinline__ void inv2_line_strips(const InvBands<T>& b, const Strips& g,
                                                 const LiftParams& P, T* smem) {
    using tiles::IH1;
    using tiles::IH2;
    const int ty = ST ? ST : g.ty, tx = ST ? ST : g.tx;
    const int E2Y = ty / 2 + 2 * IH2, E2X = tx / 2 + 2 * IH2;
    const int E1Y = ty + 2 * IH1, E1X = tx + 2 * IH1;
    const int RS2 = lines::stride(E2X), RS1 = lines::stride(E1X);
    T* const s2 = smem;
    T* const s1 = s2 + E2Y * RS2;  // E2Y and RS2 even: 16-byte aligned
    auto load = [&](int y0, int x0) {
        inv2::load_level2(b.ll2, b.hl2, b.lh2, b.hh2, s2, RS2, E2Y, E2X, g.h, g.w, y0, x0);
        __pipeline_commit();
        inv2::load_level1(b.hl1, b.lh1, b.hh1, s1, RS1, E1Y, E1X, g.h, g.w, y0, x0);
        __pipeline_commit();
    };
    for (int item = blockIdx.x; item < g.items(); item += gridDim.x) {
        const int x0 = (item % g.nbands) * tx;
        const int first = (item / g.nbands) * g.sps;
        const int last = min(g.nstrips, first + g.sps);
        load(first * ty, x0);
        for (int i = first; i < last; ++i) {
            const int y0 = i * ty;
            __pipeline_wait_prior(1);  // strip i's level 2
            __syncthreads();
            lines::lift_inv<NST, SYM>(s2, E2Y, E2X, RS2, P);
            inv2::ll1_window(s2, RS2, s1, RS1, g.h, g.w, y0, x0, E1Y / 2, E1X / 2);
            __pipeline_wait_prior(0);  // its level-1 details
            __syncthreads();
            lines::lift_inv<NST, SYM>(s1, E1Y, E1X, RS1, P);
            inv2::store(s1, RS1, b.out, g.h, g.w, y0, x0, ty, tx);
            __syncthreads();  // the stage is free for the next copies
            if (i + 1 < last) load(y0 + ty, x0);
        }
    }
}

// Lifting parameters with no scale, for the banded strips' stores (the
// matrices hold the scale).
__constant__ LiftParams NO_SCALE;

// B8/B11's strips with the banded body (float32): each (band, segment)
// item walked down strip by strip, as fwd2_line_strips walks it.  The
// window of strip i starts at (y0 - TOP2, x0 - HALO2), which is
// fwd2::load's window of y0 - (TOP2 - HALO2); its core and LL1 window are
// fwd2's of the window from row TOP2 - HALO2 on.
__device__ __forceinline__ void fwd2_mxu_strips(const float* x, const FwdBands<float>& b,
                                                const Strips& g, const banded::MxuMats& M,
                                                float* smem) {
    using tiles::HALO2;
    constexpr int DY = TOP2 - HALO2;
    const int ty = g.ty, tx = g.tx;
    const int EY = ty + 2 * TOP2, EX = tx + 2 * HALO2, E1Y = ty / 2 + 8, E1X = tx / 2 + 8;
    const int RS = banded::stride(EX), RS1 = banded::stride(E1X);
    float* const s1 = smem;
    float* const s2 = s1 + EY * RS;  // RS % 8 == 0: 32-byte aligned
    const bool vec = lines::aligned16(x) && g.w % 4 == 0;
    float* const b1[3] = {b.hl1, b.lh1, b.hh1};
    float* const b2[4] = {b.ll2, b.hl2, b.lh2, b.hh2};
    for (int item = blockIdx.x; item < g.items(); item += gridDim.x) {
        const int x0 = (item % g.nbands) * tx;
        const int first = (item / g.nbands) * g.sps;
        const int last = min(g.nstrips, first + g.sps);
        fwd2::load(x, s1, RS, g.h, g.w, first * ty - DY, x0, EY, EX, vec);
        __pipeline_commit();
        for (int i = first; i < last; ++i) {
            const int y0 = i * ty;
            __pipeline_wait_prior(0);
            __syncthreads();
            banded::lift_fwd(s1, RS, EY, EX, M.m[0], M.m[1], M.frags);
            fwd2::store_bands(s1 + DY * RS, RS, HALO2, b1, ty / 2, tx / 2, y0 / 2, x0 / 2,
                              g.h / 2, g.w / 2, NO_SCALE);
            fwd2::ll1_window(s1 + DY * RS, RS, s2, RS1, g.h, g.w, y0, x0, E1Y, E1X, NO_SCALE);
            __syncthreads();
            if (i + 1 < last) {
                fwd2::load(x, s1, RS, g.h, g.w, y0 + ty - DY, x0, EY, EX, vec);
                __pipeline_commit();
            }
            banded::lift_fwd(s2, RS1, E1Y, E1X, M.m[2], M.m[3], M.frags);
            fwd2::store_bands(s2, RS1, 4, b2, ty / 4, tx / 4, y0 / 4, x0 / 4, g.h / 4, g.w / 4,
                              NO_SCALE);
        }
    }
}

// B10/B12's strips with the banded body: one stage, the level-2 window and
// the level-1 window after it, walked as inv2_line_strips walks them.
__device__ __forceinline__ void inv2_mxu_strips(const InvBands<float>& b, const Strips& g,
                                                const banded::MxuMats& M, float* smem) {
    using tiles::IH1;
    using tiles::IH2;
    const int ty = g.ty, tx = g.tx;
    const int E2Y = ty / 2 + 2 * IH2, E2X = tx / 2 + 2 * IH2;
    const int E1Y = ty + 2 * IH1, E1X = tx + 2 * IH1;
    const int RS2 = banded::stride(E2X), RS1 = banded::stride(E1X);
    float* const s2 = smem;
    float* const s1 = s2 + E2Y * RS2;
    auto load = [&](int y0, int x0) {
        inv2::load_level2(b.ll2, b.hl2, b.lh2, b.hh2, s2, RS2, E2Y, E2X, g.h, g.w, y0, x0);
        __pipeline_commit();
        inv2::load_level1(b.hl1, b.lh1, b.hh1, s1, RS1, E1Y, E1X, g.h, g.w, y0, x0);
        __pipeline_commit();
    };
    for (int item = blockIdx.x; item < g.items(); item += gridDim.x) {
        const int x0 = (item % g.nbands) * tx;
        const int first = (item / g.nbands) * g.sps;
        const int last = min(g.nstrips, first + g.sps);
        load(first * ty, x0);
        for (int i = first; i < last; ++i) {
            const int y0 = i * ty;
            __pipeline_wait_prior(1);  // strip i's level 2
            __syncthreads();
            banded::lift_inv(s2, RS2, E2Y, E2X, M.m[0], M.m[1], M.frags);
            inv2::ll1_window(s2, RS2, s1, RS1, g.h, g.w, y0, x0, E1Y / 2, E1X / 2);
            __pipeline_wait_prior(0);  // its level-1 details
            __syncthreads();
            banded::lift_inv(s1, RS1, E1Y, E1X, M.m[2], M.m[3], M.frags);
            inv2::store(s1, RS1, b.out, g.h, g.w, y0, x0, ty, tx);
            __syncthreads();  // the stage is free for the next copies
            if (i + 1 < last) load(y0 + ty, x0);
        }
    }
}

// The single levels (B7, B9): one ty x tx strip a block on onelevel.cuh's
// body.  ST: a square strip's side at compile time (the default 64), or 0
// to take ty and tx; NST: the lifting steps (forward: 1, 2 or 4,
// alternating d, s from d; inverse: 2 or 4, alternating s, d from s, or 1,
// a d step); SYM: all symmetric; EXT: 0 or TOP, the extension's rows.
template <typename T, int ST, int NST, bool SYM, int EXT>
__global__ void __launch_bounds__(THREADS)
sfwd1_lines(onelevel::Level<T> L, int ty_arg, int tx_arg, bool vec, LiftParams P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s = reinterpret_cast<T*>(smem_raw);
    const int ty = ST ? ST : ty_arg, tx = ST ? ST : tx_arg;
    const int EY = ty + 2 * onelevel::HALO, EX = tx + 2 * onelevel::HALO;
    const int RS = lines::stride(EX), y0 = blockIdx.y * ty, x0 = blockIdx.x * tx;
    onelevel::fwd_load<EXT>(L, s, RS, EY, EX, y0, x0, vec);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    lines::lift_fwd<NST, SYM>(s, EY, EX, RS, P);
    onelevel::fwd_store(s, RS, L, y0, x0, ty / 2, tx / 2, P);
}

template <typename T, int ST, int NST, bool SYM, int EXT>
__global__ void __launch_bounds__(THREADS)
sinv1_lines(onelevel::Level<T> L, int ty_arg, int tx_arg, LiftParams P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s = reinterpret_cast<T*>(smem_raw);
    const int ty = ST ? ST : ty_arg, tx = ST ? ST : tx_arg;
    const int EY = ty + 2 * onelevel::HALO, EX = tx + 2 * onelevel::HALO;
    const int RS = lines::stride(EX), y0 = blockIdx.y * ty, x0 = blockIdx.x * tx;
    onelevel::inv_load<EXT>(L, s, RS, EY, EX, y0, x0);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    lines::lift_inv<NST, SYM>(s, EY, EX, RS, P);
    onelevel::inv_store(s, RS, L, y0, x0, ty, tx);
}

// B11 and B12 on the line walks: the strips above and deep.cuh's levels in
// one cooperative launch, a grid sync between the phases.  d.n == 0 runs
// the strips alone.
template <typename T, int ST, int NST, bool SYM>
__global__ void __launch_bounds__(THREADS)
sdeep_fwd_lines(Strips g, const T* x, FwdBands<T> b, deep::Deep<T> d, LiftParams P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s = reinterpret_cast<T*>(smem_raw);
    fwd2_line_strips<ST, NST, SYM>(x, b, g, P, s);
    if (d.n == 0) return;
    cg::this_grid().sync();
    deep::fwd_levels<NST, SYM>(d, P, s);
}

template <typename T, int ST, int NST, bool SYM>
__global__ void __launch_bounds__(THREADS)
sdeep_inv_lines(Strips g, InvBands<T> b, deep::Deep<T> d, LiftParams P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s = reinterpret_cast<T*>(smem_raw);
    if (d.n > 0) {
        deep::inv_levels<NST, SYM>(d, P, s);
        cg::this_grid().sync();
    }
    inv2_line_strips<ST, NST, SYM>(b, g, P, s);
}

// B8 and B10 on the line walks: B11/B12's strip phase alone, in an
// ordinary launch (no deep level, no grid sync).  Compiled for
// STRIP_FWD_BLOCKS / STRIP_INV_BLOCKS blocks an SM (64 / 80 registers):
// the fastest floors that tools/strip_blocks.py timed at the default
// 64x64 float32 strip, where the windows (38 KB forward, 30 KB inverse)
// would let 5 / 7 blocks share an SM.  Left to itself the compiler gives
// the walks 148 / 101 registers, one / two blocks an SM; higher floors
// spill more than they gain.
constexpr int STRIP_FWD_BLOCKS = 4;
constexpr int STRIP_INV_BLOCKS = 3;
template <typename T, int ST, int NST, bool SYM>
__global__ void __launch_bounds__(THREADS, STRIP_FWD_BLOCKS)
sstrip_fwd_lines(Strips g, const T* x, FwdBands<T> b, LiftParams P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    fwd2_line_strips<ST, NST, SYM>(x, b, g, P, reinterpret_cast<T*>(smem_raw));
}

template <typename T, int ST, int NST, bool SYM>
__global__ void __launch_bounds__(THREADS, STRIP_INV_BLOCKS)
sstrip_inv_lines(Strips g, InvBands<T> b, LiftParams P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    inv2_line_strips<ST, NST, SYM>(b, g, P, reinterpret_cast<T*>(smem_raw));
}

// B11 and B12 with the banded body (float32): its strips, and deep.cuh's
// polyphase levels across a grid sync.  d.n == 0 runs the strips alone
// (B8/B10 with the banded body).  Compiled for MXU_BLOCKS blocks an SM:
// the compiler's own choice has run from 122 to 188 registers as the
// passes changed, and above 128 only one block fits an SM (their windows
// take 74 / 62 KB of shared memory at the 96x96 strip).
constexpr int MXU_BLOCKS = 2;
template <int NST, bool SYM>
__global__ void __launch_bounds__(THREADS, MXU_BLOCKS)
sdeep_fwd_mxu(Strips g, const float* x, FwdBands<float> b, deep::Deep<float> d,
              banded::MxuMats M, LiftParams P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* s = reinterpret_cast<float*>(smem_raw);
    fwd2_mxu_strips(x, b, g, M, s);
    if (d.n > 0) {
        cg::this_grid().sync();
        deep::fwd_levels<NST, SYM>(d, P, s);
    }
}

template <int NST, bool SYM>
__global__ void __launch_bounds__(THREADS, MXU_BLOCKS)
sdeep_inv_mxu(Strips g, InvBands<float> b, deep::Deep<float> d, banded::MxuMats M,
              LiftParams P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* s = reinterpret_cast<float*>(smem_raw);
    if (d.n > 0) {
        deep::inv_levels<NST, SYM>(d, P, s);
        cg::this_grid().sync();
    }
    inv2_mxu_strips(b, g, M, s);
}

// ------------------------------------------------------------ host side

// Set the kernel's shared memory, then the blocks that can be resident at
// once over the card, and the strip plan: as many segments per band as fill
// the resident blocks (at least one, at most one strip each).
template <typename K>
int plan(K kernel, size_t smem, int h, int w, int ty, int tx, Strips* g,
         int* resident) {
    int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
    int per_sm = 0, dev = 0, sms = 0;
    if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                  THREADS, smem)))
        return err;
    if ((err = (int)cudaGetDevice(&dev))) return err;
    if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
        return err;
    *resident = per_sm * sms;
    if (*resident < 1) return (int)cudaErrorInvalidConfiguration;
    g->h = h;
    g->w = w;
    g->ty = ty;
    g->tx = tx;
    g->nbands = (w + tx - 1) / tx;
    g->nstrips = (h + ty - 1) / ty;
    const int nseg = max(1, min(g->nstrips, *resident / g->nbands));
    g->sps = (g->nstrips + nseg - 1) / nseg;
    g->nseg = (g->nstrips + g->sps - 1) / g->sps;
    return 0;
}

// B7 or B9: ``kernel`` with ``args`` over the ty x tx strips of an h x w
// level, one block each, with its window's shared memory; or, where
// ``info`` is set, no launch but info[0..3] <- the kernel's registers,
// blocks an SM, grid and shared memory (bytes).  A strip must be even and
// its window's lines must fit the block (ty, tx <= 248).
template <typename T, typename K, typename... Args>
int launch_level(K kernel, int h, int w, int ty, int tx, int* info, cudaStream_t stream,
                 Args... args) {
    const int H = onelevel::HALO;
    if (ty < 2 || tx < 2 || ty % 2 || tx % 2 || std::max(ty, tx) + 2 * H > THREADS)
        return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(T) * (size_t)(ty + 2 * H) * lines::stride(tx + 2 * H);
    int err = 0;
    if (smem > 48 * 1024
        && (err = (int)cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
        return err;
    const dim3 grid((w + tx - 1) / tx, (h + ty - 1) / ty);
    if (info) {
        cudaFuncAttributes a;
        if ((err = (int)cudaFuncGetAttributes(&a, kernel))) return err;
        if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], kernel,
                                                                      THREADS, smem)))
            return err;
        info[0] = a.numRegs;
        info[2] = (int)(grid.x * grid.y);
        info[3] = (int)smem;
        return 0;
    }
    kernel<<<grid, THREADS, smem, stream>>>(args...);
    return (int)cudaGetLastError();
}

// B7: the steps alternate d, s from d (1, 2 or 4 of them); ext: 0 or TOP.
template <typename T>
int launch_sfwd1(const T* x, T* ll, T* hl, T* lh, T* hh, int h, int w, int ty, int tx,
                 int ext, int* info, const LiftParams* P, cudaStream_t stream) {
    for (int s = 0; s < P->n; ++s)
        if (P->is_d[s] != (s % 2 == 0)) return (int)cudaErrorInvalidValue;
    if (ext != 0 && ext != TOP) return (int)cudaErrorInvalidValue;
    const onelevel::Level<T> L{const_cast<T*>(x), {ll, hl, lh, hh}, h, w, 0};
    const bool vec = w % 2 == 0 && reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0;
    return dispatch<T>(ty == tx ? ty : 0, P, [&](auto st, auto nst, auto sym) {
        constexpr int Q = decltype(st)::value, N = decltype(nst)::value;
        constexpr bool S = decltype(sym)::value;
        return ext ? launch_level<T>(sfwd1_lines<T, Q, N, S, TOP>, h, w, ty, tx, info,
                                     stream, L, ty, tx, vec, *P)
                   : launch_level<T>(sfwd1_lines<T, Q, N, S, 0>, h, w, ty, tx, info, stream,
                                     L, ty, tx, vec, *P);
    });
}

// B9: the steps (already reversed and negated) alternate s, d from s (2 or
// 4 of them), or are one d step; ext: 0 or TOP.
template <typename T>
int launch_sinv1(const T* ll, const T* hl, const T* lh, const T* hh, T* out, int h, int w,
                 int ty, int tx, int ext, int* info, const LiftParams* P,
                 cudaStream_t stream) {
    for (int s = 0; s < P->n; ++s)
        if (P->is_d[s] != (P->n == 1 || s % 2 == 1)) return (int)cudaErrorInvalidValue;
    if (ext != 0 && ext != TOP) return (int)cudaErrorInvalidValue;
    const onelevel::Level<T> L{out,
                               {const_cast<T*>(ll), const_cast<T*>(hl), const_cast<T*>(lh),
                                const_cast<T*>(hh)},
                               h, w, 0};
    return dispatch<T>(ty == tx ? ty : 0, P, [&](auto st, auto nst, auto sym) {
        constexpr int Q = decltype(st)::value, N = decltype(nst)::value;
        constexpr bool S = decltype(sym)::value;
        return ext ? launch_level<T>(sinv1_lines<T, Q, N, S, TOP>, h, w, ty, tx, info,
                                     stream, L, ty, tx, *P)
                   : launch_level<T>(sinv1_lines<T, Q, N, S, 0>, h, w, ty, tx, info, stream,
                                     L, ty, tx, *P);
    });
}

// The shared memory of the strips on the line walks (B8/B10, and B11/B12
// where the deep levels' window is not larger): the forward's signal
// window, then its LL1 window; the inverse's stage.
template <typename T>
size_t lines_fwd_smem(int ty, int tx) {
    const int EY = ty + 2 * tiles::HALO2, EX = tx + 2 * tiles::HALO2;
    return sizeof(T) * ((size_t)EY * lines::stride(EX)
                        + (size_t)(ty / 2 + 8) * lines::stride(tx / 2 + 8));
}
template <typename T>
size_t lines_inv_smem(int ty, int tx) {
    const int E2Y = ty / 2 + 2 * tiles::IH2, E2X = tx / 2 + 2 * tiles::IH2;
    const int E1Y = ty + 2 * tiles::IH1, E1X = tx + 2 * tiles::IH1;
    return sizeof(T) * ((size_t)E2Y * lines::stride(E2X) + (size_t)E1Y * lines::stride(E1X));
}

// B8 or B10 on the line walks: ``kernel``'s strips planned at its own
// occupancy, then one ordinary launch with ``args`` after its Strips; or,
// where ``info`` is set, no launch but info[0..3] <- the kernel's
// registers, blocks an SM, grid and shared memory (bytes).
template <typename K, typename... Args>
int launch_strips(K kernel, size_t smem, int h, int w, int ty, int tx, int* info,
                  cudaStream_t stream, Args... args) {
    Strips g;
    int resident = 0;
    int err = plan(kernel, smem, h, w, ty, tx, &g, &resident);
    if (err) return err;
    if (info) {
        cudaFuncAttributes a;
        if ((err = (int)cudaFuncGetAttributes(&a, kernel))) return err;
        if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], kernel,
                                                                      THREADS, smem)))
            return err;
        info[0] = a.numRegs;
        info[2] = g.items();
        info[3] = (int)smem;
        return 0;
    }
    kernel<<<g.items(), THREADS, smem, stream>>>(g, args...);
    return (int)cudaGetLastError();
}

// B8 on the line walks: the steps alternate d, s from d (1, 2 or 4 of
// them); a window line a thread (ty, tx <= 232).  info as for
// launch_strips.
template <typename T>
int launch_sstrip_fwd(const T* x, FwdBands<T> b, int h, int w, int ty, int tx, int* info,
                      const LiftParams* P, cudaStream_t stream) {
    for (int s = 0; s < P->n; ++s)
        if (P->is_d[s] != (s % 2 == 0)) return (int)cudaErrorInvalidValue;
    if (std::max(ty, tx) + 2 * tiles::HALO2 > THREADS) return (int)cudaErrorInvalidValue;
    return dispatch<T>(ty == tx ? ty : 0, P, [&](auto st, auto nst, auto sym) {
        return launch_strips(sstrip_fwd_lines<T, decltype(st)::value, decltype(nst)::value,
                                              decltype(sym)::value>,
                             lines_fwd_smem<T>(ty, tx), h, w, ty, tx, info, stream, x, b, *P);
    });
}

// B10 on the line walks: the steps (already reversed and negated)
// alternate s, d from s (2 or 4 of them), or are one d step; ty, tx <=
// 248; ``out`` 16-byte aligned (16-byte stores).  info as for
// launch_strips.
template <typename T>
int launch_sstrip_inv(InvBands<T> b, int h, int w, int ty, int tx, int* info,
                      const LiftParams* P, cudaStream_t stream) {
    for (int s = 0; s < P->n; ++s)
        if (P->is_d[s] != (P->n == 1 || s % 2 == 1)) return (int)cudaErrorInvalidValue;
    if (std::max(ty, tx) + 2 * tiles::IH1 > THREADS
        || reinterpret_cast<uintptr_t>(b.out) % 16)
        return (int)cudaErrorInvalidValue;
    return dispatch<T>(ty == tx ? ty : 0, P, [&](auto st, auto nst, auto sym) {
        return launch_strips(sstrip_inv_lines<T, decltype(st)::value, decltype(nst)::value,
                                              decltype(sym)::value>,
                             lines_inv_smem<T>(ty, tx), h, w, ty, tx, info, stream, b, *P);
    });
}

// One cooperative launch of B11 or B12 on the line walks: ``args`` point to
// the kernel's arguments after its Strips (planned here) and before its
// lifting parameters; the grid is the most items or tiles of either phase,
// capped by the co-resident blocks.  info[0..1] <- grid, resident blocks.
template <typename K, typename... Args>
int launch_lines(K kernel, size_t smem, int h, int w, int ty, int tx, int most, int* info,
                 const LiftParams* P, cudaStream_t stream, Args*... args) {
    Strips g;
    int resident = 0;
    int err = plan(kernel, smem, h, w, ty, tx, &g, &resident);
    if (err) return err;
    info[0] = std::min(std::max(g.items(), most), resident);
    info[1] = resident;
    LiftParams Pv = *P;
    void* a[] = {(void*)&g, (void*)args..., (void*)&Pv};
    err = (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(info[0]), dim3(THREADS),
                                           a, smem, stream);
    return err ? err : (int)cudaGetLastError();
}

// B11 on the line walks.  ptrs: ll2 scratch, hl2, lh2, hh2, hl1, lh1, hh1,
// then per deep level (fine first) hl, lh, hh, ll; n >= 0; info[0..1] <-
// grid, resident blocks.  The steps alternate d, s from d (1, 2 or 4 of
// them); a window line a thread.
template <typename T>
int launch_sdeep_fwd_lines(const T* x, void* const* ptrs, int n, int h, int w, int ty,
                           int tx, int tile, int* info, const LiftParams* P,
                           cudaStream_t stream) {
    for (int s = 0; s < P->n; ++s)
        if (P->is_d[s] != (s % 2 == 0)) return (int)cudaErrorInvalidValue;
    if (n < 0 || n > deep::MAX_DEEP || std::max(ty, tx) + 2 * tiles::HALO2 > THREADS)
        return (int)cudaErrorInvalidValue;
    T* const* p = reinterpret_cast<T* const*>(ptrs);
    FwdBands<T> b{p[0], p[1], p[2], p[3], p[4], p[5], p[6]};
    // deep.cuh's layout: LL2, then each level's hl, lh, hh, ll
    void* dp[4 * deep::MAX_DEEP + 1] = {ptrs[0]};
    std::copy(ptrs + 7, ptrs + 7 + 4 * n, dp + 1);
    deep::Deep<T> d;
    size_t dsmem = 0;
    int most = 0, sms = 0;
    const int err = deep::plan(d, dp, n, h / 4, w / 4, tile, false, &dsmem, &most, &sms);
    if (err) return err;
    const size_t smem = std::max(lines_fwd_smem<T>(ty, tx), dsmem);
    return dispatch<T>(ty == tx ? ty : 0, P, [&](auto st, auto nst, auto sym) {
        return launch_lines(sdeep_fwd_lines<T, decltype(st)::value, decltype(nst)::value,
                                            decltype(sym)::value>,
                            smem, h, w, ty, tx, most, info, P, stream, &x, &b, &d);
    });
}

// B12 on the line walks.  ptrs: LL_J, then per deep level (coarse first)
// hl, lh, hh, reconstruction (the last one is the LL2 scratch), then hl2,
// lh2, hh2, hl1, lh1, hh1; n >= 0.  The steps (already reversed and
// negated) alternate s, d from s (2 or 4 of them), or are one d step;
// ``out`` 16-byte aligned (16-byte stores).
template <typename T>
int launch_sdeep_inv_lines(T* out, void* const* ptrs, int n, int h, int w, int ty, int tx,
                           int tile, int* info, const LiftParams* P, cudaStream_t stream) {
    for (int s = 0; s < P->n; ++s)
        if (P->is_d[s] != (P->n == 1 || s % 2 == 1)) return (int)cudaErrorInvalidValue;
    if (n < 0 || n > deep::MAX_DEEP || std::max(ty, tx) + 2 * tiles::IH1 > THREADS
        || reinterpret_cast<uintptr_t>(out) % 16)
        return (int)cudaErrorInvalidValue;
    T* const* p = reinterpret_cast<T* const*>(ptrs);
    T* const* s = p + 1 + 4 * n;
    InvBands<T> b{p[4 * n], s[0], s[1], s[2], s[3], s[4], s[5], out};
    deep::Deep<T> d;
    size_t dsmem = 0;
    int most = 0, sms = 0;
    const int err = deep::plan(d, ptrs, n, h / 4, w / 4, tile, true, &dsmem, &most, &sms);
    if (err) return err;
    const size_t smem = std::max(lines_inv_smem<T>(ty, tx), dsmem);
    return dispatch<T>(ty == tx ? ty : 0, P, [&](auto st, auto nst, auto sym) {
        return launch_lines(sdeep_inv_lines<T, decltype(st)::value, decltype(nst)::value,
                                            decltype(sym)::value>,
                            smem, h, w, ty, tx, most, info, P, stream, &b, &d);
    });
}

// The shared memory of the banded strips: the forward's signal window and
// LL1 window, the inverse's stage, on banded::stride's rows.
size_t mxu_fwd_smem(int ty, int tx) {
    return sizeof(float)
           * ((size_t)(ty + 2 * TOP2) * banded::stride(tx + 2 * tiles::HALO2)
              + (size_t)(ty / 2 + 8) * banded::stride(tx / 2 + 8));
}
size_t mxu_inv_smem(int ty, int tx) {
    return sizeof(float)
           * ((size_t)(ty / 2 + 2 * tiles::IH2) * banded::stride(tx / 2 + 2 * tiles::IH2)
              + (size_t)(ty + 2 * tiles::IH1) * banded::stride(tx + 2 * tiles::IH1));
}

// B11 (n >= 1) or B8 (n == 0) with the banded body; ptrs as for
// launch_sdeep_fwd_lines.  Every window fits a pass (<= 256 samples).
int launch_sdeep_fwd_mxu(const float* x, void* const* ptrs, int n, int h, int w, int ty,
                         int tx, int tile, int* info, const LiftParams* P,
                         const banded::MxuMats* M, cudaStream_t stream) {
    for (int s = 0; s < P->n; ++s)
        if (P->is_d[s] != (s % 2 == 0)) return (int)cudaErrorInvalidValue;
    if (n < 0 || n > deep::MAX_DEEP || ty + 2 * TOP2 > banded::NT * banded::MAX_TILES
        || tx + 2 * tiles::HALO2 > banded::NT * banded::MAX_TILES)
        return (int)cudaErrorInvalidValue;
    float* const* p = reinterpret_cast<float* const*>(ptrs);
    FwdBands<float> b{p[0], p[1], p[2], p[3], p[4], p[5], p[6]};
    void* dp[4 * deep::MAX_DEEP + 1] = {ptrs[0]};
    std::copy(ptrs + 7, ptrs + 7 + 4 * n, dp + 1);
    deep::Deep<float> d;
    size_t dsmem = 0;
    int most = 0, sms = 0;
    const int err = deep::plan(d, dp, n, h / 4, w / 4, tile, false, &dsmem, &most, &sms);
    if (err) return err;
    const size_t smem = std::max(mxu_fwd_smem(ty, tx), dsmem);
    return dispatch<float>(0, P, [&](auto, auto nst, auto sym) {
        return launch_lines(sdeep_fwd_mxu<decltype(nst)::value, decltype(sym)::value>, smem, h,
                            w, ty, tx, most, info, P, stream, &x, &b, &d, M);
    });
}

// B12 (n >= 1) or B10 (n == 0) with the banded body; ptrs as for
// launch_sdeep_inv_lines.
int launch_sdeep_inv_mxu(float* out, void* const* ptrs, int n, int h, int w, int ty, int tx,
                         int tile, int* info, const LiftParams* P, const banded::MxuMats* M,
                         cudaStream_t stream) {
    for (int s = 0; s < P->n; ++s)
        if (P->is_d[s] != (P->n == 1 || s % 2 == 1)) return (int)cudaErrorInvalidValue;
    if (n < 0 || n > deep::MAX_DEEP || std::max(ty, tx) + 2 * tiles::IH1 > THREADS
        || reinterpret_cast<uintptr_t>(out) % 16)
        return (int)cudaErrorInvalidValue;
    float* const* p = reinterpret_cast<float* const*>(ptrs);
    float* const* s = p + 1 + 4 * n;
    InvBands<float> b{p[4 * n], s[0], s[1], s[2], s[3], s[4], s[5], out};
    deep::Deep<float> d;
    size_t dsmem = 0;
    int most = 0, sms = 0;
    const int err = deep::plan(d, ptrs, n, h / 4, w / 4, tile, true, &dsmem, &most, &sms);
    if (err) return err;
    const size_t smem = std::max(mxu_inv_smem(ty, tx), dsmem);
    return dispatch<float>(0, P, [&](auto, auto nst, auto sym) {
        return launch_lines(sdeep_inv_mxu<decltype(nst)::value, decltype(sym)::value>, smem, h,
                            w, ty, tx, most, info, P, stream, &b, &d, M);
    });
}

}  // namespace

// h, w: the frame's size (divisible by 4; even for the single levels, and
// without the extension when ext_rows is set); ty, tx: the strip rows and
// band columns (divisible by 4); tile: the deep levels' per-level tile;
// ext_rows: 0, or TOP for boundary_rows='extended'.  dwt_s1info_* and
// dwt_s2info_*: what a launch of B7 / B8 (inverse 0) or B9 / B10 (1) with
// these arguments runs, out[0..3] <- its kernel's registers, blocks an SM,
// grid and shared memory (bytes).
#define LIBDWT_STREAMED(SUF, T)                                                    \
    extern "C" int dwt_sfwd1_##SUF(const T* x, T* ll, T* hl, T* lh, T* hh, int h,   \
                                   int w, int ty, int tx, int ext_rows,            \
                                   const LiftParams* P, void* stream) {            \
        return launch_sfwd1<T>(x, ll, hl, lh, hh, h, w, ty, tx, ext_rows, nullptr, \
                               P, (cudaStream_t)stream);                           \
    }                                                                              \
    extern "C" int dwt_sinv1_##SUF(const T* ll, const T* hl, const T* lh,           \
                                   const T* hh, T* out, int h, int w, int ty,      \
                                   int tx, int ext_rows, const LiftParams* P,      \
                                   void* stream) {                                 \
        return launch_sinv1<T>(ll, hl, lh, hh, out, h, w, ty, tx, ext_rows,        \
                               nullptr, P, (cudaStream_t)stream);                  \
    }                                                                              \
    extern "C" int dwt_s1info_##SUF(int inverse, int h, int w, int ty, int tx,     \
                                    int ext_rows, const LiftParams* P, int* out) { \
        if (inverse)                                                               \
            return launch_sinv1<T>(nullptr, nullptr, nullptr, nullptr, nullptr, h, \
                                   w, ty, tx, ext_rows, out, P, nullptr);          \
        return launch_sfwd1<T>(nullptr, nullptr, nullptr, nullptr, nullptr, h, w,  \
                               ty, tx, ext_rows, out, P, nullptr);                 \
    }                                                                              \
    extern "C" int dwt_sfwd2_##SUF(const T* x, T* ll2, T* hl2, T* lh2, T* hh2,      \
                                   T* hl1, T* lh1, T* hh1, int h, int w, int ty,   \
                                   int tx, const LiftParams* P, void* stream) {    \
        return launch_sstrip_fwd<T>(x, FwdBands<T>{ll2, hl2, lh2, hh2, hl1, lh1, hh1}, \
                                    h, w, ty, tx, nullptr, P, (cudaStream_t)stream); \
    }                                                                              \
    extern "C" int dwt_sinv2_##SUF(const T* ll2, const T* hl2, const T* lh2,        \
                                   const T* hh2, const T* hl1, const T* lh1,       \
                                   const T* hh1, T* out, int h, int w, int ty,     \
                                   int tx, const LiftParams* P, void* stream) {    \
        return launch_sstrip_inv<T>(InvBands<T>{ll2, hl2, lh2, hh2, hl1, lh1, hh1, out}, \
                                    h, w, ty, tx, nullptr, P, (cudaStream_t)stream); \
    }                                                                              \
    extern "C" int dwt_s2info_##SUF(int inverse, int h, int w, int ty, int tx,     \
                                    const LiftParams* P, int* out) {               \
        if (inverse)                                                               \
            return launch_sstrip_inv<T>(InvBands<T>{}, h, w, ty, tx, out, P, nullptr); \
        return launch_sstrip_fwd<T>(nullptr, FwdBands<T>{}, h, w, ty, tx, out, P,  \
                                    nullptr);                                      \
    }                                                                              \
    extern "C" int dwt_sdeep_fwd_##SUF(const T* x, void* const* ptrs, int n, int h, \
                                       int w, int ty, int tx, int tile, int* info, \
                                       const LiftParams* P, void* stream) {        \
        return launch_sdeep_fwd_lines<T>(x, ptrs, n, h, w, ty, tx, tile, info, P,  \
                                         (cudaStream_t)stream);                    \
    }                                                                              \
    extern "C" int dwt_sdeep_inv_##SUF(T* out, void* const* ptrs, int n, int h,     \
                                       int w, int ty, int tx, int tile, int* info, \
                                       const LiftParams* P, void* stream) {        \
        return launch_sdeep_inv_lines<T>(out, ptrs, n, h, w, ty, tx, tile, info,   \
                                         P, (cudaStream_t)stream);                 \
    }

LIBDWT_STREAMED(f32, float)
LIBDWT_STREAMED(i32, int)
LIBDWT_STREAMED(f64, double)

// The banded body (B13), float32 only: the same arguments, then the
// matrices (ops/banded.py kernel_mats).  B8/B10 are B11/B12's kernels with
// no deep level.
extern "C" int dwt_sfwd2_mxu_f32(const float* x, float* ll2, float* hl2, float* lh2,
                                 float* hh2, float* hl1, float* lh1, float* hh1, int h,
                                 int w, int ty, int tx, const LiftParams* P,
                                 const banded::MxuMats* M, void* stream) {
    void* ptrs[7] = {ll2, hl2, lh2, hh2, hl1, lh1, hh1};
    int info[2];
    return launch_sdeep_fwd_mxu(x, ptrs, 0, h, w, ty, tx, deep::MIN_TILE, info, P, M,
                                (cudaStream_t)stream);
}
extern "C" int dwt_sinv2_mxu_f32(const float* ll2, const float* hl2, const float* lh2,
                                 const float* hh2, const float* hl1, const float* lh1,
                                 const float* hh1, float* out, int h, int w, int ty, int tx,
                                 const LiftParams* P, const banded::MxuMats* M,
                                 void* stream) {
    const void* ptrs[7] = {ll2, hl2, lh2, hh2, hl1, lh1, hh1};
    int info[2];
    return launch_sdeep_inv_mxu(out, const_cast<void* const*>(ptrs), 0, h, w, ty, tx,
                                deep::MIN_TILE, info, P, M, (cudaStream_t)stream);
}
extern "C" int dwt_sdeep_fwd_mxu_f32(const float* x, void* const* ptrs, int n, int h,
                                     int w, int ty, int tx, int tile, int* info,
                                     const LiftParams* P, const banded::MxuMats* M,
                                     void* stream) {
    return launch_sdeep_fwd_mxu(x, ptrs, n, h, w, ty, tx, tile, info, P, M,
                                (cudaStream_t)stream);
}
extern "C" int dwt_sdeep_inv_mxu_f32(float* out, void* const* ptrs, int n, int h, int w,
                                     int ty, int tx, int tile, int* info,
                                     const LiftParams* P, const banded::MxuMats* M,
                                     void* stream) {
    return launch_sdeep_inv_mxu(out, ptrs, n, h, w, ty, tx, tile, info, P, M,
                                (cudaStream_t)stream);
}
