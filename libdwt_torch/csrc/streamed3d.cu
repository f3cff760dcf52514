// Streamed one-level 3-D DWT kernels for Hopper (sm_90a), even dims.
//
//   dwt3_sfwd_*  replaces libdwt_tpu/ops/streamed3d.py streamed_dwt3_level
//                (:115, kernel :147; TPU kernel id B16) -> 8 bands;
//   dwt3_sinv_*  replaces streamed_idwt3_level (:249, kernel :288; B17).
//
// Bound on an H100: bytes.  A 64x512x512 f32 level moves 134.2 MB (40 us
// at 3.35 TB/s), its second level 16.8 MB; the lifting is 21 flops per
// voxel, far below 67 TFLOP/s.
//
// Design.  The TPU kernels stream (z, y) tiles of whole x rows through two
// VMEM slots.  Here a block owns a column of ty x tx samples and walks it
// down z, the z lift in registers under line walks of each plane: the
// column walk of volwalk.cuh, shared with B14/B15 (fused3d.cu).  A step's
// planes, (ty + 8) x (tx + 8) each, come into the ring by its manual feeds:
// the forward's (RowFeed) as one bulk copy (TMA, counted off an mbarrier a
// slot) a window row, the inverse's as 16-byte cp.async chunks into planes
// split into x halves; samples past x's edges come one at a
// time through the mirror, and a tile or volume that leaves the rows
// unaligned takes chunks of 8 bytes or elements.
//
// The tile (tz, ty, tx) is the caller's; ops/streamed3d.py holds the
// defaults and the footprint rules of volwalk::geometry.  What holds each
// kernel now (the loads, then the passes' latency at 4 and 2 blocks an SM)
// is in PERF.md section 6.
#include "volwalk.cuh"

namespace {

using tiles::Bands8;
using volwalk::FWD_BLOCKS;
using volwalk::FWD_THREADS;
using volwalk::Geo;
using volwalk::INV_BLOCKS;
using volwalk::INV_THREADS;

template <typename T, int NST, bool SYM>
__global__ void __launch_bounds__(FWD_THREADS, FWD_BLOCKS)
sfwd3_kernel(const T* __restrict__ x, Bands8<T> out, Geo g, LiftParams P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    volwalk::fwd_walk<T, NST, SYM, volwalk::RowFeed<T>>(x, out, g, P,
                                                        reinterpret_cast<T*>(smem_raw));
}

template <typename T, int NST, bool SYM>
__global__ void __launch_bounds__(INV_THREADS, INV_BLOCKS)
sinv3_kernel(Bands8<const T> in, T* __restrict__ out, Geo g, LiftParams P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    volwalk::inv_walk<T, NST, SYM>(in, out, g, P, smem_raw);
}

template <typename T>
int launch_sfwd3(const T* x, Bands8<T> out, int Z, int Y, int X, int tz, int ty, int tx,
                 const LiftParams* P, cudaStream_t stream) {
    Geo g;
    size_t smem = 0;
    int err = volwalk::geometry<T>(false, Z, Y, X, tz, ty, tx, &g, &smem);
    if (err) return err;
    return volwalk::dispatch3<T>(P, [&](auto nst, auto sym) {
        auto kernel = sfwd3_kernel<T, decltype(nst)::value, decltype(sym)::value>;
        const int e = volwalk::plan(kernel, FWD_THREADS, &g, smem);
        if (e) return e;
        kernel<<<g.items(), FWD_THREADS, smem, stream>>>(x, out, g, *P);
        return (int)cudaGetLastError();
    });
}

template <typename T>
int launch_sinv3(Bands8<const T> in, T* out, int Z, int Y, int X, int tz, int ty, int tx,
                 const LiftParams* P, cudaStream_t stream) {
    Geo g;
    size_t smem = 0;
    int err = volwalk::geometry<T>(true, Z, Y, X, tz, ty, tx, &g, &smem);
    if (err) return err;
    return volwalk::dispatch3<T>(P, [&](auto nst, auto sym) {
        auto kernel = sinv3_kernel<T, decltype(nst)::value, decltype(sym)::value>;
        const int e = volwalk::plan(kernel, INV_THREADS, &g, smem);
        if (e) return e;
        kernel<<<g.items(), INV_THREADS, smem, stream>>>(in, out, g, *P);
        return (int)cudaGetLastError();
    });
}

// What a launch on ``tile`` with P runs: volwalk::query's registers,
// blocks an SM, shared memory and threads.
template <typename T>
int sinfo(int inverse, int tz, int ty, int tx, const LiftParams* P, int* out) {
    Geo g;
    size_t smem = 0;
    int err = volwalk::geometry<T>(inverse != 0, 0, 0, 0, tz, ty, tx, &g, &smem);
    if (err) return err;
    return volwalk::dispatch3<T>(P, [&](auto nst, auto sym) {
        constexpr int NST = decltype(nst)::value;
        constexpr bool SYM = decltype(sym)::value;
        if (inverse) return volwalk::query(sinv3_kernel<T, NST, SYM>, INV_THREADS, smem, out);
        return volwalk::query(sfwd3_kernel<T, NST, SYM>, FWD_THREADS, smem, out);
    });
}

}  // namespace

// bands: a host array of the 8 band pointers, LLL..HHH; (Z, Y, X): the
// volume's size (even); (tz, ty, tx): the segment step in planes and the
// column's core (even).
#define LIBDWT_SVOLUME(SUF, T)                                                     \
    extern "C" int dwt3_sfwd_##SUF(const T* x, void* const* bands, int Z, int Y,    \
                                   int X, int tz, int ty, int tx,                  \
                                   const LiftParams* P, void* stream) {            \
        Bands8<T> out;                                                             \
        for (int i = 0; i < 8; ++i) out.b[i] = static_cast<T*>(bands[i]);          \
        return launch_sfwd3<T>(x, out, Z, Y, X, tz, ty, tx, P, (cudaStream_t)stream); \
    }                                                                              \
    extern "C" int dwt3_sinv_##SUF(void* const* bands, T* out, int Z, int Y, int X, \
                                   int tz, int ty, int tx, const LiftParams* P,    \
                                   void* stream) {                                 \
        Bands8<const T> in;                                                        \
        for (int i = 0; i < 8; ++i) in.b[i] = static_cast<const T*>(bands[i]);     \
        return launch_sinv3<T>(in, out, Z, Y, X, tz, ty, tx, P, (cudaStream_t)stream); \
    }                                                                              \
    extern "C" int dwt3_sinfo_##SUF(int inverse, int tz, int ty, int tx,           \
                                    const LiftParams* P, int* out) {               \
        return sinfo<T>(inverse, tz, ty, tx, P, out);                              \
    }

LIBDWT_SVOLUME(f32, float)
LIBDWT_SVOLUME(i32, int)
LIBDWT_SVOLUME(f64, double)
