// One-level 3-D DWT kernels for Hopper (sm_90a), even dims.
//
//   dwt3_fwd_*  libdwt_tpu/ops/fused3d.py fused_dwt3_level (:352, body
//               _3d_kernel :274; TPU kernel id B14) -> 8 bands LLL..HHH;
//   dwt3_inv_*  fused_idwt3_level (:512, body _3d_inv_kernel :450; B15).
//
// Bound on an H100: bytes.  A 64x512x512 f32 level moves 134.2 MB (40 us
// at 3.35 TB/s), its second level 16.8 MB; the lifting is 21 flops per
// voxel, far below 67 TFLOP/s.
//
// Design.  The TPU kernel tiles the volume over (z, y) with whole x rows in
// VMEM, fed by BlockSpec: the hardware pipelines whole blocks.  Here a
// block owns a column of ty x tx samples and walks it down z, two plane
// pairs a step, the z lift in registers under line walks of each plane:
// volwalk.cuh's column walk, shared with B16/B17 (streamed3d.cu).
//
// B14 is fed as BlockSpec fed the TPU's kernel, by whole boxes of the 3-D
// tensor (cp.async.bulk.tensor on a tensor map built on the host): one
// elected thread issues a step's boxes on its ring slot's mbarrier, one box
// a plane, (ty + 8) rows of RS samples (the window's tx + 8 columns
// over-fetched to RS, 4 mod 8 words, the row stride the x walks read at),
// at (x0 - 4, y0 - 4, z).  B15 runs B17's inverse walk as it is, fed by
// 16-byte cp.async chunks into planes split into x halves: band boxes (one
// a band and plane pair, into a window a band) measure slower than these
// chunks on the H100 (PERF.md section 6).
//
// A box's first sample must be 16-byte aligned in its row (else the copy
// faults as an illegal instruction): x0 - 4 is, for tx a multiple of 16
// bytes.  A plane's z is mirrored where its box is issued (the warm-up
// pairs at the volume's ends; the neighbouring segment's planes at a cut).
// Boxes that start at negative y or x or run past the volume's ends bring
// zeros there, counted in the barrier's bytes like the rest; the samples
// that the outputs read, up to the halo past each end, are then set to
// their whole-point mirror from inside the window (halo 4 and dims > 4 put
// it there) before the first pass reads them.  A volume or tile that no
// tensor map serves (a row not a multiple of 16 bytes, a misaligned box
// start, a window plane not a multiple of 128 bytes) takes B16's row feed:
// a branch chosen at launch from the geometry, reported through ``feed``.
#include <cuda.h>

#include "volwalk.cuh"

namespace {

using tiles::Bands8;
using volwalk::FWD_BLOCKS;
using volwalk::FWD_THREADS;
using volwalk::Geo;
using volwalk::HALO;
using volwalk::INV_BLOCKS;
using volwalk::INV_THREADS;
using volwalk::RING;
using volwalk::Seg;
using volwalk::STEP;
using volwalk::bar_expect;
using volwalk::bar_wait;
using volwalk::fence_async;
using volwalk::mirror_near;
using volwalk::smem_u32;

// One tensor box of ``map`` at (x, y, z) (innermost first) into dst, 128-
// byte aligned, its bytes counted off ``bar``.
__device__ __forceinline__ void box_copy(void* dst, const CUtensorMap* map, int x, int y, int z,
                                         uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void init_bars(uint64_t* bars) {
    if (threadIdx.x == 0)
        for (int i = 0; i < RING; ++i) volwalk::bar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    __syncthreads();
}

// The rows (or columns) [0, a) and [b, e) of a window line of n samples
// whose first is signal g0, on an axis of N: those before the volume and up
// to a halo past it, the ones the outputs read.
struct Edges {
    int a, b, e;
    __device__ __forceinline__ Edges(int g0, int N, int n) {
        a = max(0, min(n, -g0));
        b = max(a, min(n, N - g0));
        e = min(n, b + HALO);
    }
    __device__ __forceinline__ int count() const { return a + e - b; }
    // the k-th of them
    __device__ __forceinline__ int at(int k) const { return k < a ? k : b + k - a; }
};

// Set the edge samples of ``planes`` window planes (plane i at s + i pls,
// rows rs apart; position (r, c) is signal (gy0 + r, gx0 + c)) to their
// whole-point mirrors, which lie in the same plane at in-volume positions:
// the rows outside y (every column up to the last that matters), then the
// columns outside x (every row up to the last that matters); a corner is
// set twice to the same value.
template <typename T>
__device__ __forceinline__ void fix_edges(T* s, int planes, int pls, int rs, int gy0, int Y,
                                          int rows, int gx0, int X, int cols) {
    const Edges er(gy0, Y, rows), ec(gx0, X, cols);
    const int nr = er.count(), nc = ec.count();
    if (nr == 0 && nc == 0) return;
    const int na = nr * ec.e, n = na + er.e * nc;
    for (int i = threadIdx.x; i < planes * n; i += blockDim.x) {
        const int pl = i / n, j = i - pl * n;
        int r, c;
        if (j < na) {
            const int k = j / ec.e;
            r = er.at(k), c = j - k * ec.e;
        } else {
            const int k = (j - na) / nc;
            r = k, c = ec.at(j - na - k * nc);
        }
        const int rr = mirror_near(gy0 + r, Y) - gy0, cc = mirror_near(gx0 + c, X) - gx0;
        T* const p = s + pl * pls;
        p[r * rs + c] = p[rr * rs + cc];
    }
}

// ------------------------------------------------------------ forward

// B14's tensor-box feed: step st's planes as one box each, on the slot's
// barrier (after the ring); then the window's edges through the mirror.
template <typename T>
struct BoxFeed {
    const CUtensorMap* map;
    const Geo& g;
    uint64_t* const bars;
    // bit i: slot i's phase
    unsigned ph = 0;

    // ring: RING slots of SL samples, the barriers after them
    __device__ __forceinline__ BoxFeed(const CUtensorMap* map_, const Geo& g_, T* ring, int SL)
        : map(map_), g(g_), bars(reinterpret_cast<uint64_t*>(ring + RING * SL)) {
        init_bars(bars);
    }
    __device__ __forceinline__ void issue(const Seg& sg, int st, int steps, T* s, int sl) {
        if (threadIdx.x != 0 || st >= steps) return;
        const int planes = 2 * min(STEP, sg.n - STEP * st), z0 = 2 * (sg.k0 + STEP * st);
        const int PL = g.EY * g.RS;
        bar_expect(bars + sl, planes * PL * (unsigned)sizeof(T));
        for (int pl = 0; pl < planes; ++pl)
            box_copy(s + pl * PL, map, sg.x0 - HALO, sg.y0 - HALO, mirror_near(z0 + pl, g.Z),
                     bars + sl);
    }
    __device__ __forceinline__ void wait(const Seg& sg, int st, int sl, T* s) {
        fence_async();  // the z step of st - 1 before the boxes into its slot
        bar_wait(bars + sl, (ph >> sl) & 1);
        ph ^= 1u << sl;
        fix_edges(s, 2 * min(STEP, sg.n - STEP * st), g.EY * g.RS, g.RS, sg.y0 - HALO, g.Y,
                  g.EY, sg.x0 - HALO, g.X, g.EX);
        __syncthreads();
    }
    __device__ __forceinline__ void done() {
        fence_async();
        __syncthreads();
    }
};

template <typename T, int NST, bool SYM, bool BOXES>
__global__ void __launch_bounds__(FWD_THREADS, FWD_BLOCKS)
fwd3_kernel(const __grid_constant__ CUtensorMap map, const T* __restrict__ x, Bands8<T> out,
            Geo g, LiftParams P) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    T* const ring = reinterpret_cast<T*>(smem_raw);
    if constexpr (BOXES) {
        if (smem_u32(ring) & 127) __trap();  // a box lands 128-byte aligned
        volwalk::fwd_walk<T, NST, SYM, BoxFeed<T>>(&map, out, g, P, ring);
    } else {
        volwalk::fwd_walk<T, NST, SYM, volwalk::RowFeed<T>>(x, out, g, P, ring);
    }
}

// ------------------------------------------------------------ inverse

// B17's inverse walk (volwalk.cuh), fed by its chunk copies.
template <typename T, int NST, bool SYM>
__global__ void __launch_bounds__(INV_THREADS, INV_BLOCKS)
inv3_kernel(Bands8<const T> in, T* __restrict__ out, Geo g, LiftParams P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    volwalk::inv_walk<T, NST, SYM>(in, out, g, P, smem_raw);
}

// ------------------------------------------------------------ launch

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (no -lcuda at build time).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

int encode_tiled(EncodeTiled* fn) {
    static EncodeTiled cached = nullptr;
    if (!cached) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        const int err = (int)cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                              12000, cudaEnableDefault, &q);
        if (err) return err;
        if (q != cudaDriverEntryPointSuccess || !p) return (int)cudaErrorSymbolNotFound;
        cached = reinterpret_cast<EncodeTiled>(p);
    }
    *fn = cached;
    return 0;
}

template <typename T>
CUtensorMapDataType map_type() {
    if constexpr (std::is_same<T, float>::value) return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    else if constexpr (std::is_same<T, double>::value) return CU_TENSOR_MAP_DATA_TYPE_FLOAT64;
    else return CU_TENSOR_MAP_DATA_TYPE_INT32;
}

// The tensor map of an (n2, n1, n0) volume at p, read in boxes of b0 x b1
// x 1 samples, zeros outside it.  An encoding error returns minus its
// CUresult.
template <typename T>
int encode3(CUtensorMap* map, const void* p, int n0, int n1, int n2, int b0, int b1) {
    EncodeTiled fn;
    const int err = encode_tiled(&fn);
    if (err) return err;
    const cuuint64_t dims[3] = {(cuuint64_t)n0, (cuuint64_t)n1, (cuuint64_t)n2};
    const cuuint64_t strides[2] = {(cuuint64_t)n0 * sizeof(T), (cuuint64_t)n0 * n1 * sizeof(T)};
    const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1}, one[3] = {1, 1, 1};
    const CUresult r = fn(map, map_type<T>(), 3, const_cast<void*>(p), dims, strides, box, one,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : -(int)r;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Whether tensor maps serve B14's input: rows of 16-byte multiples, box
// starts x0 - 4 16-byte aligned, a window plane of 128-byte multiples (the
// rule of ops/fused3d.py's feed_of).
template <typename T>
bool fwd_boxes(const Geo& g, bool aligned) {
    constexpr int V = 16 / (int)sizeof(T);
    return aligned && g.X % V == 0 && g.tx % V == 0 && (g.EY * g.RS * sizeof(T)) % 128 == 0;
}

template <typename T>
int launch_fwd3(const T* x, Bands8<T> out, int Z, int Y, int X, int tz, int ty, int tx,
                const LiftParams* P, cudaStream_t stream, int* feed) {
    Geo g;
    size_t smem = 0;
    int err = volwalk::geometry<T>(false, Z, Y, X, tz, ty, tx, &g, &smem);
    if (err) return err;
    const bool boxes = fwd_boxes<T>(g, aligned16(x));
    *feed = boxes;
    CUtensorMap map{};
    if (boxes && (err = encode3<T>(&map, x, X, Y, Z, g.RS, g.EY))) return err;
    return volwalk::dispatch3<T>(P, [&](auto nst, auto sym) {
        constexpr int NST = decltype(nst)::value;
        constexpr bool SYM = decltype(sym)::value;
        auto kernel = boxes ? fwd3_kernel<T, NST, SYM, true> : fwd3_kernel<T, NST, SYM, false>;
        const int e = volwalk::plan(kernel, FWD_THREADS, &g, smem);
        if (e) return e;
        kernel<<<g.items(), FWD_THREADS, smem, stream>>>(map, x, out, g, *P);
        return (int)cudaGetLastError();
    });
}

template <typename T>
int launch_inv3(Bands8<const T> in, T* out, int Z, int Y, int X, int tz, int ty, int tx,
                const LiftParams* P, cudaStream_t stream) {
    Geo g;
    size_t smem = 0;
    int err = volwalk::geometry<T>(true, Z, Y, X, tz, ty, tx, &g, &smem);
    if (err) return err;
    return volwalk::dispatch3<T>(P, [&](auto nst, auto sym) {
        auto kernel = inv3_kernel<T, decltype(nst)::value, decltype(sym)::value>;
        const int e = volwalk::plan(kernel, INV_THREADS, &g, smem);
        if (e) return e;
        kernel<<<g.items(), INV_THREADS, smem, stream>>>(in, out, g, *P);
        return (int)cudaGetLastError();
    });
}

// What a launch on a (Z, Y, X) volume at 16-byte aligned addresses with
// ``tile`` and P runs: volwalk::query's registers, blocks an SM, shared
// memory and threads, then out[4] its feed (1: tensor boxes; B15 has only
// copies).
template <typename T>
int finfo(int inverse, int Z, int Y, int X, int tz, int ty, int tx, const LiftParams* P,
          int* out) {
    Geo g;
    size_t smem = 0;
    int err = volwalk::geometry<T>(inverse != 0, Z, Y, X, tz, ty, tx, &g, &smem);
    if (err) return err;
    const bool boxes = !inverse && fwd_boxes<T>(g, true);
    out[4] = boxes;
    return volwalk::dispatch3<T>(P, [&](auto nst, auto sym) {
        constexpr int NST = decltype(nst)::value;
        constexpr bool SYM = decltype(sym)::value;
        if (inverse) return volwalk::query(inv3_kernel<T, NST, SYM>, INV_THREADS, smem, out);
        return volwalk::query(boxes ? fwd3_kernel<T, NST, SYM, true>
                                    : fwd3_kernel<T, NST, SYM, false>,
                              FWD_THREADS, smem, out);
    });
}

}  // namespace

// bands: a host array of the 8 band pointers, LLL..HHH; (Z, Y, X): the
// volume's size (even); (tz, ty, tx): the segment step in planes and the
// column's core (even); feed <- 1 where the forward read through tensor
// boxes, 0 through copies.
#define LIBDWT_VOLUME(SUF, T)                                                      \
    extern "C" int dwt3_fwd_##SUF(const T* x, void* const* bands, int Z, int Y,     \
                                  int X, int tz, int ty, int tx, int* feed,        \
                                  const LiftParams* P, void* stream) {             \
        Bands8<T> out;                                                             \
        for (int i = 0; i < 8; ++i) out.b[i] = static_cast<T*>(bands[i]);          \
        return launch_fwd3<T>(x, out, Z, Y, X, tz, ty, tx, P, (cudaStream_t)stream, \
                              feed);                                               \
    }                                                                              \
    extern "C" int dwt3_inv_##SUF(void* const* bands, T* out, int Z, int Y, int X,  \
                                  int tz, int ty, int tx, const LiftParams* P,     \
                                  void* stream) {                                  \
        Bands8<const T> in;                                                        \
        for (int i = 0; i < 8; ++i) in.b[i] = static_cast<const T*>(bands[i]);     \
        return launch_inv3<T>(in, out, Z, Y, X, tz, ty, tx, P, (cudaStream_t)stream); \
    }                                                                              \
    extern "C" int dwt3_finfo_##SUF(int inverse, int Z, int Y, int X, int tz, int ty, \
                                    int tx, const LiftParams* P, int* out) {       \
        return finfo<T>(inverse, Z, Y, X, tz, ty, tx, P, out);                     \
    }

LIBDWT_VOLUME(f32, float)
LIBDWT_VOLUME(i32, int)
LIBDWT_VOLUME(f64, double)
