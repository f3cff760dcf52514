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
// Forward: the (tz+8) x (ty+8) x (tx+8) tile is read at whole-point
// mirrored positions (for even dims these equal the reference's mirror
// fills, fused3d.py:15-18), lifted along x, then y, then z, and each core
// voxel is scaled by its per-axis parity factors and written to the band
// of its parity.  Inverse: the interleaved coefficient volume is read from
// the 8 bands at mirrored positions (for even dims exactly the channel
// rules of fused3d.py:19-22), scaled by the inverse factors, lifted along
// z, y, then x, and the core is written out.
//
// Bound on an H100: bytes.  A 64x512x512 f32 level moves 134.2 MB (40 us
// at 3.35 TB/s).  The default 16x16x32 core has a 24x24x40 tile (92 KB of
// shared memory, two blocks per SM), so each block reads 2.8x its core;
// the re-read mostly hits L2.  Like the 2-D tile kernels this first
// version does one thread loop per lifting step with a barrier between
// steps, so instruction issue, not memory, is expected to hold it.
#include "lifting.cuh"

namespace {

constexpr int HALO = 4;
constexpr int THREADS = 512;

// The 8 bands in (z, y, x) name order: band (bz << 2) | (by << 1) | bx.
template <typename T>
struct Bands8 {
    T* b[8];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
fwd3_kernel(const T* __restrict__ x, Bands8<T> out, int Z, int Y, int X,
            int tz, int ty, int tx, LiftParams P) {
    extern __shared__ unsigned char smem_raw[];
    T* s = reinterpret_cast<T*>(smem_raw);
    const int ez = tz + 2 * HALO, ey = ty + 2 * HALO, ex = tx + 2 * HALO;
    const int z0 = blockIdx.z * tz, y0 = blockIdx.y * ty, x0 = blockIdx.x * tx;
    for (int i = threadIdx.x; i < ez * ey * ex; i += blockDim.x) {
        const int c = i % ex, r = (i / ex) % ey, k = i / (ex * ey);
        s[i] = x[((size_t)mirror_idx(z0 - HALO + k, Z) * Y + mirror_idx(y0 - HALO + r, Y))
                     * X + mirror_idx(x0 - HALO + c, X)];
    }
    __syncthreads();
    lift_lines(s, ex, ez * ey, 1, 1, ex, P);            // x
    lift_lines(s, ey, ez * ex, ex, ex, ey * ex, P);     // y
    lift_lines(s, ez, ey * ex, ey * ex, ey * ex, 0, P); // z
    const int hy = Y / 2, hx = X / 2;
    for (int i = threadIdx.x; i < tz * ty * tx; i += blockDim.x) {
        const int c = i % tx, r = (i / tx) % ty, k = i / (tx * ty);
        const int gz = z0 + k, gy = y0 + r, gx = x0 + c;
        if (gz < Z && gy < Y && gx < X) {
            const T v = s[((k + HALO) * ey + r + HALO) * ex + c + HALO];
            out.b[((gz & 1) << 2) | ((gy & 1) << 1) | (gx & 1)]
                 [((size_t)(gz >> 1) * hy + (gy >> 1)) * hx + (gx >> 1)] =
                scale3(v, k, r, c, P);
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
inv3_kernel(Bands8<const T> in, T* out, int Z, int Y, int X, int tz, int ty,
            int tx, LiftParams P) {
    extern __shared__ unsigned char smem_raw[];
    T* s = reinterpret_cast<T*>(smem_raw);
    const int ez = tz + 2 * HALO, ey = ty + 2 * HALO, ex = tx + 2 * HALO;
    const int z0 = blockIdx.z * tz, y0 = blockIdx.y * ty, x0 = blockIdx.x * tx;
    const int hy = Y / 2, hx = X / 2;
    for (int i = threadIdx.x; i < ez * ey * ex; i += blockDim.x) {
        const int c = i % ex, r = (i / ex) % ey, k = i / (ex * ey);
        const int gz = mirror_idx(z0 - HALO + k, Z);
        const int gy = mirror_idx(y0 - HALO + r, Y);
        const int gx = mirror_idx(x0 - HALO + c, X);
        const T v = in.b[((gz & 1) << 2) | ((gy & 1) << 1) | (gx & 1)]
                        [((size_t)(gz >> 1) * hy + (gy >> 1)) * hx + (gx >> 1)];
        s[i] = scale3(v, k, r, c, P);
    }
    __syncthreads();
    lift_lines(s, ez, ey * ex, ey * ex, ey * ex, 0, P); // z
    lift_lines(s, ey, ez * ex, ex, ex, ey * ex, P);     // y
    lift_lines(s, ex, ez * ey, 1, 1, ex, P);            // x
    for (int i = threadIdx.x; i < tz * ty * tx; i += blockDim.x) {
        const int c = i % tx, r = (i / tx) % ty, k = i / (tx * ty);
        const int gz = z0 + k, gy = y0 + r, gx = x0 + c;
        if (gz < Z && gy < Y && gx < X)
            out[((size_t)gz * Y + gy) * X + gx] =
                s[((k + HALO) * ey + r + HALO) * ex + c + HALO];
    }
}

template <typename K>
size_t tile3_smem(K kernel, int tz, int ty, int tx, size_t item) {
    const size_t smem = item * (size_t)(tz + 2 * HALO) * (ty + 2 * HALO) * (tx + 2 * HALO);
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
