// One-level 3-D DWT tile kernels for Hopper (sm_90a), even dims.
//
//   dwt3_fwd_*  libdwt_tpu/ops/fused3d.py fused_dwt3_level (:352, body
//               _3d_kernel :274; TPU kernel id B14) -> 8 bands LLL..HHH;
//   dwt3_inv_*  fused_idwt3_level (:512, body _3d_inv_kernel :450; B15).
//
// The TPU kernel tiles the volume over (z, y) with whole x rows in VMEM;
// here a block takes a 3-D tile of tz x ty x tx core samples with a halo
// of 4 on every axis, in shared memory.  Tile starts are even on all
// three axes, so local parity is global parity.
//
// The tile body (loads through the mirror, the lifting passes, the band
// writes) is in tiles3.cuh, shared with the streamed volume kernels of
// streamed3d.cu; here each block loads its tile and lifts it at once.
//
// Bound on an H100: bytes.  A 64x512x512 f32 level moves 134.2 MB (40 us
// at 3.35 TB/s).  The default 16x16x32 core has a 24x24x40 tile (92 KB of
// shared memory, two blocks per SM), so each block reads 2.8x its core;
// the re-read mostly hits L2.  Like the 2-D tile kernels this first
// version does one thread loop per lifting step with a barrier between
// steps, so instruction issue, not memory, is expected to hold it.
#include "tiles3.cuh"

namespace {

constexpr int THREADS = 512;

using tiles::Bands8;

template <typename T>
__global__ void __launch_bounds__(THREADS)
fwd3_kernel(const T* __restrict__ x, Bands8<T> out, int Z, int Y, int X,
            int tz, int ty, int tx, LiftParams P) {
    extern __shared__ unsigned char smem_raw[];
    T* s = reinterpret_cast<T*>(smem_raw);
    const int z0 = blockIdx.z * tz, y0 = blockIdx.y * ty, x0 = blockIdx.x * tx;
    tiles::fwd3_load<false>(x, s, Z, Y, X, z0, y0, x0, tz, ty, tx);
    __syncthreads();
    tiles::fwd3_compute(s, out, Z, Y, X, z0, y0, x0, tz, ty, tx, P);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
inv3_kernel(Bands8<const T> in, T* out, int Z, int Y, int X, int tz, int ty,
            int tx, LiftParams P) {
    extern __shared__ unsigned char smem_raw[];
    T* s = reinterpret_cast<T*>(smem_raw);
    const int z0 = blockIdx.z * tz, y0 = blockIdx.y * ty, x0 = blockIdx.x * tx;
    tiles::inv3_load<false>(in, s, Z, Y, X, z0, y0, x0, tz, ty, tx, P);
    __syncthreads();
    tiles::inv3_compute<false>(s, out, Z, Y, X, z0, y0, x0, tz, ty, tx, P);
}

template <typename K>
size_t tile3_smem(K kernel, int tz, int ty, int tx, size_t item) {
    const size_t smem = item * (size_t)tiles::tile3_elems(tz, ty, tx);
    if (smem > 48 * 1024)
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    return smem;
}

dim3 grid3(int Z, int Y, int X, int tz, int ty, int tx) {
    return dim3((X + tx - 1) / tx, (Y + ty - 1) / ty, (Z + tz - 1) / tz);
}

}  // namespace

// bands: a host array of the 8 band pointers, LLL..HHH.
#define LIBDWT_VOLUME(SUF, T)                                                      \
    extern "C" int dwt3_fwd_##SUF(const T* x, void* const* bands, int Z, int Y,     \
                                  int X, int tz, int ty, int tx,                   \
                                  const LiftParams* P, void* stream) {             \
        Bands8<T> out;                                                             \
        for (int i = 0; i < 8; ++i) out.b[i] = static_cast<T*>(bands[i]);          \
        const size_t smem = tile3_smem(fwd3_kernel<T>, tz, ty, tx, sizeof(T));     \
        fwd3_kernel<T><<<grid3(Z, Y, X, tz, ty, tx), THREADS, smem,                \
                         (cudaStream_t)stream>>>(x, out, Z, Y, X, tz, ty, tx, *P); \
        return (int)cudaGetLastError();                                            \
    }                                                                              \
    extern "C" int dwt3_inv_##SUF(void* const* bands, T* out, int Z, int Y, int X,  \
                                  int tz, int ty, int tx, const LiftParams* P,     \
                                  void* stream) {                                  \
        Bands8<const T> in;                                                        \
        for (int i = 0; i < 8; ++i) in.b[i] = static_cast<const T*>(bands[i]);     \
        const size_t smem = tile3_smem(inv3_kernel<T>, tz, ty, tx, sizeof(T));     \
        inv3_kernel<T><<<grid3(Z, Y, X, tz, ty, tx), THREADS, smem,                \
                         (cudaStream_t)stream>>>(in, out, Z, Y, X, tz, ty, tx, *P); \
        return (int)cudaGetLastError();                                            \
    }

LIBDWT_VOLUME(f32, float)
LIBDWT_VOLUME(i32, int)
