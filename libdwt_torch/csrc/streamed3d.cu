// Streamed one-level 3-D DWT kernels for Hopper (sm_90a), even dims: 3-D
// tiles through two shared-memory buffers, the next tile's load in flight
// while the current one lifts.
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
// VMEM slots.  Here the volume is cut into columns of ty x tx samples (y,
// x), each column into segments of tz-slab tiles, and one work item is a
// (column, segment).  A persistent block walks its item down z: before it
// lifts tile i it issues the cp.async loads of tile i+1's halo'd window
// (one 4-byte copy per element through the mirror index, so the border
// rules need no fix-up pass) into the other buffer, and it waits for tile
// i+1 only after tile i's outputs are written.  The tile body is B14/B15's
// (tiles3.cuh), with a halo of 4 on every axis, so a tile's values are bit
// for bit those of the fused kernels and of the plain versions.  As many
// segments per column as fill the co-resident blocks; neighbouring items
// take neighbouring x columns.  No grid sync is needed, so the launch is an
// ordinary one.  The tile (tz, ty, tx) is the caller's; ops/streamed3d.py
// holds the default and its shared memory.
#include <algorithm>

#include "tiles3.cuh"

namespace {

constexpr int THREADS = 512;

using tiles::Bands8;

// Columns of ty x tx samples (nx along x, ny along y), each cut into nseg
// segments of sps tiles of tz slabs; item = seg * (nx * ny) + column.
struct Tiles3 {
    int Z, Y, X, tz, ty, tx, nx, ny, nz, sps, nseg;
    __host__ __device__ int items() const { return nx * ny * nseg; }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
sfwd3_kernel(const T* x, Bands8<T> out, Tiles3 g, LiftParams P) {
    extern __shared__ unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);
    T* sb[2] = {smem, smem + tiles::tile3_elems(g.tz, g.ty, g.tx)};
    const int cols = g.nx * g.ny;
    for (int item = blockIdx.x; item < g.items(); item += gridDim.x) {
        const int col = item % cols;
        const int x0 = (col % g.nx) * g.tx, y0 = (col / g.nx) * g.ty;
        const int first = (item / cols) * g.sps;
        const int last = min(g.nz, first + g.sps);
        tiles::fwd3_load<true>(x, sb[0], g.Z, g.Y, g.X, first * g.tz, y0, x0, g.tz, g.ty,
                               g.tx);
        __pipeline_commit();
        for (int i = first; i < last; ++i) {
            const int k = (i - first) & 1;
            if (i + 1 < last)
                tiles::fwd3_load<true>(x, sb[k ^ 1], g.Z, g.Y, g.X, (i + 1) * g.tz, y0, x0,
                                       g.tz, g.ty, g.tx);
            __pipeline_commit();  // possibly empty: keeps wait_prior(1) exact
            __pipeline_wait_prior(1);
            __syncthreads();
            tiles::fwd3_compute(sb[k], out, g.Z, g.Y, g.X, i * g.tz, y0, x0, g.tz, g.ty,
                                g.tx, P);
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sinv3_kernel(Bands8<const T> in, T* out, Tiles3 g, LiftParams P) {
    extern __shared__ unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);
    T* sb[2] = {smem, smem + tiles::tile3_elems(g.tz, g.ty, g.tx)};
    const int cols = g.nx * g.ny;
    for (int item = blockIdx.x; item < g.items(); item += gridDim.x) {
        const int col = item % cols;
        const int x0 = (col % g.nx) * g.tx, y0 = (col / g.nx) * g.ty;
        const int first = (item / cols) * g.sps;
        const int last = min(g.nz, first + g.sps);
        tiles::inv3_load<true>(in, sb[0], g.Z, g.Y, g.X, first * g.tz, y0, x0, g.tz, g.ty,
                               g.tx, P);
        __pipeline_commit();
        for (int i = first; i < last; ++i) {
            const int k = (i - first) & 1;
            if (i + 1 < last)
                tiles::inv3_load<true>(in, sb[k ^ 1], g.Z, g.Y, g.X, (i + 1) * g.tz, y0,
                                       x0, g.tz, g.ty, g.tx, P);
            __pipeline_commit();
            __pipeline_wait_prior(1);
            __syncthreads();
            tiles::inv3_compute<true>(sb[k], out, g.Z, g.Y, g.X, i * g.tz, y0, x0, g.tz,
                                      g.ty, g.tx, P);
        }
    }
}

// Set the kernel's shared memory (two tile buffers), then the blocks that
// can be resident at once over the card, and the tile plan: as many
// segments per column as fill the resident blocks (at least one, at most
// one tile each).
template <typename T, typename K>
int plan3(K kernel, int Z, int Y, int X, int tz, int ty, int tx, Tiles3* g,
          size_t* smem) {
    *smem = sizeof(T) * 2 * (size_t)tiles::tile3_elems(tz, ty, tx);
    int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (err) return err;
    int per_sm = 0, dev = 0, sms = 0;
    if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                  THREADS, *smem)))
        return err;
    if ((err = (int)cudaGetDevice(&dev))) return err;
    if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
        return err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    *g = Tiles3{Z, Y, X, tz, ty, tx, (X + tx - 1) / tx, (Y + ty - 1) / ty,
                (Z + tz - 1) / tz, 0, 0};
    const int nseg = std::max(1, std::min(g->nz, per_sm * sms / (g->nx * g->ny)));
    g->sps = (g->nz + nseg - 1) / nseg;
    g->nseg = (g->nz + g->sps - 1) / g->sps;
    return 0;
}

template <typename T>
int launch_sfwd3(const T* x, Bands8<T> out, int Z, int Y, int X, int tz, int ty, int tx,
                 const LiftParams* P, cudaStream_t stream) {
    Tiles3 g;
    size_t smem = 0;
    const int err = plan3<T>(sfwd3_kernel<T>, Z, Y, X, tz, ty, tx, &g, &smem);
    if (err) return err;
    sfwd3_kernel<T><<<g.items(), THREADS, smem, stream>>>(x, out, g, *P);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_sinv3(Bands8<const T> in, T* out, int Z, int Y, int X, int tz, int ty, int tx,
                 const LiftParams* P, cudaStream_t stream) {
    Tiles3 g;
    size_t smem = 0;
    const int err = plan3<T>(sinv3_kernel<T>, Z, Y, X, tz, ty, tx, &g, &smem);
    if (err) return err;
    sinv3_kernel<T><<<g.items(), THREADS, smem, stream>>>(in, out, g, *P);
    return (int)cudaGetLastError();
}

}  // namespace

// bands: a host array of the 8 band pointers, LLL..HHH; (Z, Y, X): the
// volume's size (even); (tz, ty, tx): the core tile (even).
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
    }

LIBDWT_SVOLUME(f32, float)
LIBDWT_SVOLUME(i32, int)
