// Streamed 2-D DWT kernels for Hopper (sm_90a): strips through two shared-
// memory buffers, the next strip's load in flight while the current one
// lifts.
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
// Design.  The TPU kernels stream full-width strips because its lane axis
// needs no halo; a 4096-wide f32 strip with its halo does not fit twice in
// the 227 KB a block may hold.  Here the frame is cut into column bands of
// tx samples, each band into segments of strips of ty rows, and one work
// item is a (band, segment).  A persistent block walks down its item strip
// by strip: before it lifts strip i it issues the cp.async loads of strip
// i+1's halo'd window into the other buffer (one copy per element,
// so the border mirror is just the source index), and it waits for strip
// i+1 only after strip i's outputs are written.  Halos: forward TOP2 = 16
// rows (streamed.py:400) and HALO2 = 12 columns; inverse 8 LL1 samples at
// level 2 and 4 signal samples at level 1, on both axes.  The tile
// arithmetic is fused2l.cu's (tiles.cuh), so a strip's values are bit for
// bit those of the plain versions in ops/streamed.py.
//
// The single levels B7/B9 walk the same (band, segment) items with
// tiles.cuh's one-level body (fwd1_*/inv1_*): a halo of 4 on both
// axes, so a 64x64 strip is a 72x72 window and the two buffers take 41 KB.
// The inverse reads the interleaved coefficients through the mirror, which
// for equal band shapes is exactly _fix_strip's channel rules.  Under
// boundary_rows='extended' the input carries TOP = 8 rows (forward) or
// channel rows (inverse) above and below, read straight.  A 2144x4096 f32
// level moves 70.3 MB (21 us at 3.35 TB/s).
//
// The one-launch pyramids are cooperative kernels (all blocks resident,
// cooperative_groups grid syncs).  B11: the strip phase of B8 writes levels
// 1-2 and LL2 into a scratch buffer that sits in the 50 MB L2; after a grid
// sync each deep level runs tiles.cuh's one-level tile (fwd1_tile) over
// tiles in a grid-stride loop, with a grid sync between levels.  B12: the
// deep inverse levels (inv1_tile) reconstruct LL2 into a scratch buffer, a
// grid sync, then B10's strip phase reads LL2 from it (through the mirror,
// which gives the whole-point head and repeat tail channel rules of
// streamed.py:1303-1319).  The grid is the number of blocks that can be
// resident at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor after
// the shared-memory attribute is set), at most the largest phase's items.
// Scratch buffers are never read before the grid sync that follows their
// writes, and no pointer is __restrict__, so no read can see a stale line.
//
// The banded-matmul body (B13, banded.cuh) replaces the polyphase lift of
// the strip phases of B8/B10/B11/B12 in their MXU = true instantiations
// (dwt_*_mxu_f32, float32 only): the matrices ride in the kernel's shared
// memory after the float windows and the body's three data parts, copied
// there once per block before its first strip.  The deep levels of B11/B12
// stay polyphase, as in the reference (streamed.py:1167-1169).  At the
// default 64x64 strip a forward block then holds 177 KB and an inverse
// block 145 KB, one block per SM.
//
// The float64 (f64) instantiations double every buffer: at the default
// 64x64 strip a two-level forward block holds 148 KB and an inverse one
// 120 KB (one block per SM, no tile halved); shared memory and the
// cooperative grids are sized with sizeof(T), so the occupancy calculator
// sees the real footprint.
#include <algorithm>

#include <cooperative_groups.h>

#include "banded.cuh"
#include "tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int TOP = 8;     // the single levels' extended contract (rows)
constexpr int TOP2 = 16;   // forward strip row halo
constexpr int MAX_DEEP = 16;

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

// One deep level.  Forward: (h, w) is the input LL's size, ll the input,
// hl/lh/hh/out the outputs.  Inverse: (h, w) is the output size, ll the
// coarser LL, hl/lh/hh the bands, out the reconstruction.
template <typename T>
struct Level {
    int h, w;
    const T* ll;
    T *hl, *lh, *hh, *out;
};

template <typename T>
struct Deep {
    int n;
    Level<T> lv[MAX_DEEP];
};

// Shared memory of the two-level strips: the float windows (``*_base``:
// two buffers, and the forward's LL1 tile), and with the banded body the
// elements of one of its data parts (``*_parts``: the larger window).
template <typename T>
__host__ __device__ size_t fwd_base(int ty, int tx) {
    return sizeof(T) * (size_t)(2 * tiles::fwd2_elems(ty, tx, TOP2)
                                + tiles::fwd2_ll1_elems(ty, tx));
}
__host__ __device__ inline int fwd_parts(int ty, int tx) {
    const int a = banded::part_elems(ty + 2 * TOP2, tx + 2 * tiles::HALO2);
    const int b = banded::part_elems(ty / 2 + 8, tx / 2 + 8);
    return a > b ? a : b;
}
template <typename T>
__host__ __device__ size_t inv_base(int ty, int tx) {
    return sizeof(T) * 2 * (size_t)(tiles::inv2_l2_elems(ty, tx)
                                    + tiles::inv2_l1_elems(ty, tx));
}
__host__ __device__ inline int inv_parts(int ty, int tx) {
    const int a = banded::part_elems(ty / 2 + 2 * tiles::IH2, tx / 2 + 2 * tiles::IH2);
    const int b = banded::part_elems(ty + 2 * tiles::IH1, tx + 2 * tiles::IH1);
    return a > b ? a : b;
}

// The strips of the two forward levels.  MXU: the banded body (float32),
// which first copies its matrices into shared memory.
template <typename T, bool MXU>
__device__ void fwd2_strips(const T* x, const FwdBands<T>& b, const Strips& g,
                            const LiftParams& P, const banded::MxuMats& M,
                            unsigned char* raw) {
    T* smem = reinterpret_cast<T*>(raw);
    const int buf = tiles::fwd2_elems(g.ty, g.tx, TOP2);
    T* sb[2] = {smem, smem + buf};
    T* s2 = smem + 2 * buf;
    const banded::MxuLift lift =
        banded::make_lift(M, raw, fwd_base<T>(g.ty, g.tx), fwd_parts(g.ty, g.tx));
    if constexpr (MXU) banded::load_mats(M, lift.mats);
    for (int item = blockIdx.x; item < g.items(); item += gridDim.x) {
        const int x0 = (item % g.nbands) * g.tx;
        const int first = (item / g.nbands) * g.sps;
        const int last = min(g.nstrips, first + g.sps);
        tiles::fwd2_load<true>(x, sb[0], g.h, g.w, first * g.ty, x0, g.ty, g.tx, TOP2);
        __pipeline_commit();
        for (int i = first; i < last; ++i) {
            const int k = (i - first) & 1;
            if (i + 1 < last)
                tiles::fwd2_load<true>(x, sb[k ^ 1], g.h, g.w, (i + 1) * g.ty, x0, g.ty,
                                       g.tx, TOP2);
            __pipeline_commit();  // possibly empty: keeps wait_prior(1) exact
            __pipeline_wait_prior(1);
            __syncthreads();
            if constexpr (MXU)
                banded::fwd2_compute_mxu(sb[k], s2, b.ll2, b.hl2, b.lh2, b.hh2, b.hl1,
                                         b.lh1, b.hh1, g.h, g.w, i * g.ty, x0, g.ty, g.tx,
                                         TOP2, lift);
            else
                tiles::fwd2_compute(sb[k], s2, b.ll2, b.hl2, b.lh2, b.hh2, b.hl1, b.lh1,
                                    b.hh1, g.h, g.w, i * g.ty, x0, g.ty, g.tx, TOP2, P);
        }
    }
}

template <typename T, bool MXU>
__device__ void inv2_strips(const InvBands<T>& b, const Strips& g, const LiftParams& P,
                            const banded::MxuMats& M, unsigned char* raw) {
    T* smem = reinterpret_cast<T*>(raw);
    const int n2 = tiles::inv2_l2_elems(g.ty, g.tx);
    const int stage = n2 + tiles::inv2_l1_elems(g.ty, g.tx);
    T* sb[2] = {smem, smem + stage};
    const banded::MxuLift lift =
        banded::make_lift(M, raw, inv_base<T>(g.ty, g.tx), inv_parts(g.ty, g.tx));
    if constexpr (MXU) banded::load_mats(M, lift.mats);
    for (int item = blockIdx.x; item < g.items(); item += gridDim.x) {
        const int x0 = (item % g.nbands) * g.tx;
        const int first = (item / g.nbands) * g.sps;
        const int last = min(g.nstrips, first + g.sps);
        tiles::inv2_load<true>(b.ll2, b.hl2, b.lh2, b.hh2, b.hl1, b.lh1, b.hh1, sb[0],
                               sb[0] + n2, g.h, g.w, first * g.ty, x0, g.ty, g.tx);
        __pipeline_commit();
        for (int i = first; i < last; ++i) {
            const int k = (i - first) & 1;
            if (i + 1 < last)
                tiles::inv2_load<true>(b.ll2, b.hl2, b.lh2, b.hh2, b.hl1, b.lh1, b.hh1,
                                       sb[k ^ 1], sb[k ^ 1] + n2, g.h, g.w,
                                       (i + 1) * g.ty, x0, g.ty, g.tx);
            __pipeline_commit();
            __pipeline_wait_prior(1);
            __syncthreads();
            if constexpr (MXU)
                banded::inv2_compute_mxu(sb[k], sb[k] + n2, b.out, g.h, g.w, i * g.ty, x0,
                                         g.ty, g.tx, lift);
            else
                tiles::inv2_compute(sb[k], sb[k] + n2, b.out, g.h, g.w, i * g.ty, x0, g.ty,
                                    g.tx, P);
        }
    }
}

// One deep level over tiles of 2*tile samples, grid-stride.
template <typename T, bool INV>
__device__ void deep_level(const Level<T>& L, int tile, const LiftParams& P, T* s) {
    const int S = 2 * tile;
    const int nx = (L.w + S - 1) / S, n = nx * ((L.h + S - 1) / S);
    for (int item = blockIdx.x; item < n; item += gridDim.x) {
        const int y0 = (item / nx) * S, x0 = (item % nx) * S;
        if constexpr (INV)
            tiles::inv1_tile<0>(L.ll, L.hl, L.lh, L.hh, L.out, L.h, L.w, y0, x0, S, S, P,
                                s);
        else
            tiles::fwd1_tile<0>(L.ll, L.out, L.hl, L.lh, L.hh, L.h, L.w, y0, x0, S, S, P,
                                s);
    }
}

// The single levels (B7, B9): strips of ty x tx samples with a halo of 4 on
// both axes, walked down each item's column band like fwd2_strips.
template <int EXT, typename T>
__device__ void fwd1_strips(const T* x, T* ll, T* hl, T* lh, T* hh, const Strips& g,
                            const LiftParams& P, T* smem) {
    T* sb[2] = {smem, smem + tiles::lvl1_elems(g.ty, g.tx)};
    for (int item = blockIdx.x; item < g.items(); item += gridDim.x) {
        const int x0 = (item % g.nbands) * g.tx;
        const int first = (item / g.nbands) * g.sps;
        const int last = min(g.nstrips, first + g.sps);
        tiles::fwd1_load<EXT, true>(x, sb[0], g.h, g.w, first * g.ty, x0, g.ty, g.tx);
        __pipeline_commit();
        for (int i = first; i < last; ++i) {
            const int k = (i - first) & 1;
            if (i + 1 < last)
                tiles::fwd1_load<EXT, true>(x, sb[k ^ 1], g.h, g.w, (i + 1) * g.ty, x0,
                                            g.ty, g.tx);
            __pipeline_commit();
            __pipeline_wait_prior(1);
            __syncthreads();
            tiles::fwd1_compute(sb[k], ll, hl, lh, hh, g.h, g.w, i * g.ty, x0, g.ty, g.tx,
                                P);
        }
    }
}

template <int EXT, typename T>
__device__ void inv1_strips(const T* ll, const T* hl, const T* lh, const T* hh, T* out,
                            const Strips& g, const LiftParams& P, T* smem) {
    T* sb[2] = {smem, smem + tiles::lvl1_elems(g.ty, g.tx)};
    for (int item = blockIdx.x; item < g.items(); item += gridDim.x) {
        const int x0 = (item % g.nbands) * g.tx;
        const int first = (item / g.nbands) * g.sps;
        const int last = min(g.nstrips, first + g.sps);
        tiles::inv1_load<EXT, true>(ll, hl, lh, hh, sb[0], g.h, g.w, first * g.ty, x0,
                                    g.ty, g.tx);
        __pipeline_commit();
        for (int i = first; i < last; ++i) {
            const int k = (i - first) & 1;
            if (i + 1 < last)
                tiles::inv1_load<EXT, true>(ll, hl, lh, hh, sb[k ^ 1], g.h, g.w,
                                            (i + 1) * g.ty, x0, g.ty, g.tx);
            __pipeline_commit();
            __pipeline_wait_prior(1);
            __syncthreads();
            tiles::inv1_compute(sb[k], out, g.h, g.w, i * g.ty, x0, g.ty, g.tx, P);
        }
    }
}

template <typename T, bool MXU>
__global__ void __launch_bounds__(THREADS)
sfwd2_kernel(const T* x, FwdBands<T> b, Strips g, LiftParams P, banded::MxuMats M) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    fwd2_strips<T, MXU>(x, b, g, P, M, smem_raw);
}

template <typename T, bool MXU>
__global__ void __launch_bounds__(THREADS)
sinv2_kernel(InvBands<T> b, Strips g, LiftParams P, banded::MxuMats M) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    inv2_strips<T, MXU>(b, g, P, M, smem_raw);
}

template <int EXT, typename T>
__global__ void __launch_bounds__(THREADS)
sfwd1_kernel(const T* x, T* ll, T* hl, T* lh, T* hh, Strips g, LiftParams P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    fwd1_strips<EXT>(x, ll, hl, lh, hh, g, P, reinterpret_cast<T*>(smem_raw));
}

template <int EXT, typename T>
__global__ void __launch_bounds__(THREADS)
sinv1_kernel(const T* ll, const T* hl, const T* lh, const T* hh, T* out, Strips g,
             LiftParams P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    inv1_strips<EXT>(ll, hl, lh, hh, out, g, P, reinterpret_cast<T*>(smem_raw));
}

template <typename T, bool MXU>
__global__ void __launch_bounds__(THREADS)
sdeep_fwd_kernel(const T* x, FwdBands<T> b, Strips g, Deep<T> d, int tile,
                 LiftParams P, banded::MxuMats M) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s = reinterpret_cast<T*>(smem_raw);
    cg::grid_group grid = cg::this_grid();
    fwd2_strips<T, MXU>(x, b, g, P, M, smem_raw);
    for (int k = 0; k < d.n; ++k) {
        grid.sync();
        deep_level<T, false>(d.lv[k], tile, P, s);
    }
}

template <typename T, bool MXU>
__global__ void __launch_bounds__(THREADS)
sdeep_inv_kernel(InvBands<T> b, Strips g, Deep<T> d, int tile, LiftParams P,
                 banded::MxuMats M) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s = reinterpret_cast<T*>(smem_raw);
    cg::grid_group grid = cg::this_grid();
    for (int k = 0; k < d.n; ++k) {
        deep_level<T, true>(d.lv[k], tile, P, s);
        grid.sync();
    }
    inv2_strips<T, MXU>(b, g, P, M, smem_raw);
}

// ------------------------------------------------------------ host side

template <typename T, bool MXU>
size_t fwd_smem(int ty, int tx, const banded::MxuMats& M) {
    const size_t base = fwd_base<T>(ty, tx);
    return MXU ? banded::smem_bytes(base, fwd_parts(ty, tx), M.elems) : base;
}

template <typename T, bool MXU>
size_t inv_smem(int ty, int tx, const banded::MxuMats& M) {
    const size_t base = inv_base<T>(ty, tx);
    return MXU ? banded::smem_bytes(base, inv_parts(ty, tx), M.elems) : base;
}

template <typename T>
size_t deep_smem(int tile) {
    const size_t e = 2 * tile + 2 * tiles::HALO;
    return sizeof(T) * e * e;
}

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

// LL sizes from LL2 (h/4 x w/4) down, one more per deep level.
void deep_sizes(int h, int w, int n, int* hs, int* ws) {
    hs[0] = h / 4;
    ws[0] = w / 4;
    for (int k = 0; k < n; ++k) {
        hs[k + 1] = (hs[k] + 1) / 2;
        ws[k + 1] = (ws[k] + 1) / 2;
    }
}

template <typename T>
int grid_for(const Strips& g, const Deep<T>& d, int tile, int resident) {
    int most = g.items();
    const int S = 2 * tile;
    for (int k = 0; k < d.n; ++k)
        most = max(most, ((d.lv[k].h + S - 1) / S) * ((d.lv[k].w + S - 1) / S));
    return min(most, resident);
}

// The polyphase instantiations take no matrices.
const banded::MxuMats NO_MATS{};

template <typename T, bool MXU>
int launch_sfwd2(const T* x, FwdBands<T> b, int h, int w, int ty, int tx,
                 const LiftParams* P, const banded::MxuMats* M, cudaStream_t stream) {
    const size_t smem = fwd_smem<T, MXU>(ty, tx, *M);
    Strips g;
    int resident = 0;
    const int err = plan(sfwd2_kernel<T, MXU>, smem, h, w, ty, tx, &g, &resident);
    if (err) return err;
    sfwd2_kernel<T, MXU><<<g.items(), THREADS, smem, stream>>>(x, b, g, *P, *M);
    return (int)cudaGetLastError();
}

template <typename T, bool MXU>
int launch_sinv2(InvBands<T> b, int h, int w, int ty, int tx, const LiftParams* P,
                 const banded::MxuMats* M, cudaStream_t stream) {
    const size_t smem = inv_smem<T, MXU>(ty, tx, *M);
    Strips g;
    int resident = 0;
    const int err = plan(sinv2_kernel<T, MXU>, smem, h, w, ty, tx, &g, &resident);
    if (err) return err;
    sinv2_kernel<T, MXU><<<g.items(), THREADS, smem, stream>>>(b, g, *P, *M);
    return (int)cudaGetLastError();
}

template <int EXT, typename T>
int launch_sfwd1(const T* x, T* ll, T* hl, T* lh, T* hh, int h, int w, int ty, int tx,
                 const LiftParams* P, cudaStream_t stream) {
    const size_t smem = sizeof(T) * 2 * (size_t)tiles::lvl1_elems(ty, tx);
    Strips g;
    int resident = 0;
    const int err = plan(sfwd1_kernel<EXT, T>, smem, h, w, ty, tx, &g, &resident);
    if (err) return err;
    sfwd1_kernel<EXT, T><<<g.items(), THREADS, smem, stream>>>(x, ll, hl, lh, hh, g, *P);
    return (int)cudaGetLastError();
}

template <int EXT, typename T>
int launch_sinv1(const T* ll, const T* hl, const T* lh, const T* hh, T* out, int h,
                 int w, int ty, int tx, const LiftParams* P, cudaStream_t stream) {
    const size_t smem = sizeof(T) * 2 * (size_t)tiles::lvl1_elems(ty, tx);
    Strips g;
    int resident = 0;
    const int err = plan(sinv1_kernel<EXT, T>, smem, h, w, ty, tx, &g, &resident);
    if (err) return err;
    sinv1_kernel<EXT, T><<<g.items(), THREADS, smem, stream>>>(ll, hl, lh, hh, out, g, *P);
    return (int)cudaGetLastError();
}

// ptrs: ll2 scratch, hl2, lh2, hh2, hl1, lh1, hh1, then per deep level
// (fine first) hl, lh, hh, ll.  info[0..1] <- grid, resident blocks.
template <typename T, bool MXU>
int launch_sdeep_fwd(const T* x, void* const* ptrs, int n, int h, int w, int ty,
                     int tx, int tile, int* info, const LiftParams* P,
                     const banded::MxuMats* M, cudaStream_t stream) {
    if (n < 1 || n > MAX_DEEP) return (int)cudaErrorInvalidValue;
    T* const* p = reinterpret_cast<T* const*>(ptrs);
    FwdBands<T> b{p[0], p[1], p[2], p[3], p[4], p[5], p[6]};
    int hs[MAX_DEEP + 1], ws[MAX_DEEP + 1];
    deep_sizes(h, w, n, hs, ws);
    Deep<T> d;
    d.n = n;
    for (int k = 0; k < n; ++k) {
        T* const* q = p + 7 + 4 * k;
        d.lv[k] = Level<T>{hs[k], ws[k], k ? p[7 + 4 * k - 1] : p[0], q[0], q[1], q[2],
                           q[3]};
    }
    const size_t smem = std::max(fwd_smem<T, MXU>(ty, tx, *M), deep_smem<T>(tile));
    Strips g;
    int resident = 0;
    int err = plan(sdeep_fwd_kernel<T, MXU>, smem, h, w, ty, tx, &g, &resident);
    if (err) return err;
    info[0] = grid_for(g, d, tile, resident);
    info[1] = resident;
    LiftParams Pv = *P;
    banded::MxuMats Mv = *M;
    void* args[] = {(void*)&x, (void*)&b,    (void*)&g,  (void*)&d,
                    (void*)&tile, (void*)&Pv, (void*)&Mv};
    err = (int)cudaLaunchCooperativeKernel((const void*)sdeep_fwd_kernel<T, MXU>,
                                           dim3(info[0]), dim3(THREADS), args, smem,
                                           stream);
    return err ? err : (int)cudaGetLastError();
}

// ptrs: LL_J, then per deep level (coarse first) hl, lh, hh, reconstruction
// (the last one is the LL2 scratch), then hl2, lh2, hh2, hl1, lh1, hh1.
template <typename T, bool MXU>
int launch_sdeep_inv(T* out, void* const* ptrs, int n, int h, int w, int ty, int tx,
                     int tile, int* info, const LiftParams* P, const banded::MxuMats* M,
                     cudaStream_t stream) {
    if (n < 1 || n > MAX_DEEP) return (int)cudaErrorInvalidValue;
    T* const* p = reinterpret_cast<T* const*>(ptrs);
    int hs[MAX_DEEP + 1], ws[MAX_DEEP + 1];
    deep_sizes(h, w, n, hs, ws);
    Deep<T> d;
    d.n = n;
    for (int k = 0; k < n; ++k) {
        T* const* q = p + 1 + 4 * k;
        d.lv[k] = Level<T>{hs[n - 1 - k], ws[n - 1 - k], k ? p[4 * k] : p[0], q[0], q[1],
                           q[2], q[3]};
    }
    T* const* s = p + 1 + 4 * n;
    InvBands<T> b{p[4 * n], s[0], s[1], s[2], s[3], s[4], s[5], out};
    const size_t smem = std::max(inv_smem<T, MXU>(ty, tx, *M), deep_smem<T>(tile));
    Strips g;
    int resident = 0;
    int err = plan(sdeep_inv_kernel<T, MXU>, smem, h, w, ty, tx, &g, &resident);
    if (err) return err;
    info[0] = grid_for(g, d, tile, resident);
    info[1] = resident;
    LiftParams Pv = *P;
    banded::MxuMats Mv = *M;
    void* args[] = {(void*)&b, (void*)&g, (void*)&d, (void*)&tile, (void*)&Pv, (void*)&Mv};
    err = (int)cudaLaunchCooperativeKernel((const void*)sdeep_inv_kernel<T, MXU>,
                                           dim3(info[0]), dim3(THREADS), args, smem,
                                           stream);
    return err ? err : (int)cudaGetLastError();
}

}  // namespace

// h, w: the frame's size (divisible by 4; even for the single levels, and
// without the extension when ext_rows is set); ty, tx: the strip rows and
// band columns (divisible by 4); tile: the deep levels' per-level tile;
// ext_rows: 0, or TOP for boundary_rows='extended'.
#define LIBDWT_STREAMED(SUF, T)                                                    \
    extern "C" int dwt_sfwd1_##SUF(const T* x, T* ll, T* hl, T* lh, T* hh, int h,   \
                                   int w, int ty, int tx, int ext_rows,            \
                                   const LiftParams* P, void* stream) {            \
        if (ext_rows != 0 && ext_rows != TOP) return (int)cudaErrorInvalidValue;   \
        return ext_rows                                                            \
            ? launch_sfwd1<TOP, T>(x, ll, hl, lh, hh, h, w, ty, tx, P,             \
                                   (cudaStream_t)stream)                           \
            : launch_sfwd1<0, T>(x, ll, hl, lh, hh, h, w, ty, tx, P,               \
                                 (cudaStream_t)stream);                            \
    }                                                                              \
    extern "C" int dwt_sinv1_##SUF(const T* ll, const T* hl, const T* lh,           \
                                   const T* hh, T* out, int h, int w, int ty,      \
                                   int tx, int ext_rows, const LiftParams* P,      \
                                   void* stream) {                                 \
        if (ext_rows != 0 && ext_rows != TOP) return (int)cudaErrorInvalidValue;   \
        return ext_rows                                                            \
            ? launch_sinv1<TOP, T>(ll, hl, lh, hh, out, h, w, ty, tx, P,           \
                                   (cudaStream_t)stream)                           \
            : launch_sinv1<0, T>(ll, hl, lh, hh, out, h, w, ty, tx, P,             \
                                 (cudaStream_t)stream);                            \
    }                                                                              \
    extern "C" int dwt_sfwd2_##SUF(const T* x, T* ll2, T* hl2, T* lh2, T* hh2,      \
                                   T* hl1, T* lh1, T* hh1, int h, int w, int ty,   \
                                   int tx, const LiftParams* P, void* stream) {    \
        return launch_sfwd2<T, false>(x, FwdBands<T>{ll2, hl2, lh2, hh2, hl1, lh1, \
                                                     hh1},                         \
                                      h, w, ty, tx, P, &NO_MATS,                   \
                                      (cudaStream_t)stream);                       \
    }                                                                              \
    extern "C" int dwt_sinv2_##SUF(const T* ll2, const T* hl2, const T* lh2,        \
                                   const T* hh2, const T* hl1, const T* lh1,       \
                                   const T* hh1, T* out, int h, int w, int ty,     \
                                   int tx, const LiftParams* P, void* stream) {    \
        return launch_sinv2<T, false>(                                             \
            InvBands<T>{ll2, hl2, lh2, hh2, hl1, lh1, hh1, out}, h, w, ty, tx, P,  \
            &NO_MATS, (cudaStream_t)stream);                                       \
    }                                                                              \
    extern "C" int dwt_sdeep_fwd_##SUF(const T* x, void* const* ptrs, int n, int h, \
                                       int w, int ty, int tx, int tile, int* info, \
                                       const LiftParams* P, void* stream) {        \
        return launch_sdeep_fwd<T, false>(x, ptrs, n, h, w, ty, tx, tile, info, P, \
                                          &NO_MATS, (cudaStream_t)stream);         \
    }                                                                              \
    extern "C" int dwt_sdeep_inv_##SUF(T* out, void* const* ptrs, int n, int h,     \
                                       int w, int ty, int tx, int tile, int* info, \
                                       const LiftParams* P, void* stream) {        \
        return launch_sdeep_inv<T, false>(out, ptrs, n, h, w, ty, tx, tile, info,  \
                                          P, &NO_MATS, (cudaStream_t)stream);      \
    }

LIBDWT_STREAMED(f32, float)
LIBDWT_STREAMED(i32, int)
LIBDWT_STREAMED(f64, double)

// The banded body (B13), float32 only: the same arguments, then the
// matrices (ops/banded.py kernel_mats).
extern "C" int dwt_sfwd2_mxu_f32(const float* x, float* ll2, float* hl2, float* lh2,
                                 float* hh2, float* hl1, float* lh1, float* hh1, int h,
                                 int w, int ty, int tx, const LiftParams* P,
                                 const banded::MxuMats* M, void* stream) {
    return launch_sfwd2<float, true>(x, FwdBands<float>{ll2, hl2, lh2, hh2, hl1, lh1, hh1},
                                     h, w, ty, tx, P, M, (cudaStream_t)stream);
}
extern "C" int dwt_sinv2_mxu_f32(const float* ll2, const float* hl2, const float* lh2,
                                 const float* hh2, const float* hl1, const float* lh1,
                                 const float* hh1, float* out, int h, int w, int ty, int tx,
                                 const LiftParams* P, const banded::MxuMats* M,
                                 void* stream) {
    return launch_sinv2<float, true>(
        InvBands<float>{ll2, hl2, lh2, hh2, hl1, lh1, hh1, out}, h, w, ty, tx, P, M,
        (cudaStream_t)stream);
}
extern "C" int dwt_sdeep_fwd_mxu_f32(const float* x, void* const* ptrs, int n, int h,
                                     int w, int ty, int tx, int tile, int* info,
                                     const LiftParams* P, const banded::MxuMats* M,
                                     void* stream) {
    return launch_sdeep_fwd<float, true>(x, ptrs, n, h, w, ty, tx, tile, info, P, M,
                                         (cudaStream_t)stream);
}
extern "C" int dwt_sdeep_inv_mxu_f32(float* out, void* const* ptrs, int n, int h, int w,
                                     int ty, int tx, int tile, int* info,
                                     const LiftParams* P, const banded::MxuMats* M,
                                     void* stream) {
    return launch_sdeep_inv<float, true>(out, ptrs, n, h, w, ty, tx, tile, info, P, M,
                                         (cudaStream_t)stream);
}
