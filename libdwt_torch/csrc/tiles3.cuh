// The 3-D tile body shared by the fused (fused3d.cu) and streamed
// (streamed3d.cu) volume kernels.
//
// A tile is tz x ty x tx core samples of the interleaved volume with a
// halo of HALO3 = 4 on every axis, (tz+8) x (ty+8) x (tx+8) elements, at
// even starts, so local parity is global parity.  As in tiles.cuh each
// body is a load (a plain copy, or a one-element cp.async the caller
// commits and waits for) and a compute step.
//
// Forward: the tile is read at whole-point mirrored positions (for even
// dims these equal the reference's mirror fills, fused3d.py:15-18), lifted
// along x, then y, then z, and each core voxel is scaled by its per-axis
// parity factors and written to the band of its parity.  Inverse: the
// interleaved coefficient volume is read from the 8 bands at mirrored
// positions (for even dims exactly the channel rules of fused3d.py:19-22
// and streamed3d.py:314-330), scaled by the inverse factors, lifted along
// z, y, then x, and the core is written out.
#pragma once

#include "tiles.cuh"

namespace tiles {

constexpr int HALO3 = 4;

// The 8 bands in (z, y, x) name order: band (bz << 2) | (by << 1) | bx.
template <typename T>
struct Bands8 {
    T* b[8];
};

__host__ __device__ __forceinline__ int tile3_elems(int tz, int ty, int tx) {
    return (tz + 2 * HALO3) * (ty + 2 * HALO3) * (tx + 2 * HALO3);
}

template <bool ASYNC, typename T>
__device__ void fwd3_load(const T* x, T* s, int Z, int Y, int X, int z0, int y0, int x0,
                          int tz, int ty, int tx) {
    const int ez = tz + 2 * HALO3, ey = ty + 2 * HALO3, ex = tx + 2 * HALO3;
    for (int i = threadIdx.x; i < ez * ey * ex; i += blockDim.x) {
        const int c = i % ex, r = (i / ex) % ey, k = i / (ex * ey);
        copy_elem<ASYNC>(s + i, x + ((size_t)mirror_idx(z0 - HALO3 + k, Z) * Y
                                     + mirror_idx(y0 - HALO3 + r, Y)) * X
                                    + mirror_idx(x0 - HALO3 + c, X));
    }
}

// Lift x, y, z; scale and write the core into the bands.  Ends with a
// barrier, so the caller may reuse ``s``.
template <typename T>
__device__ void fwd3_compute(T* s, const Bands8<T>& out, int Z, int Y, int X, int z0,
                             int y0, int x0, int tz, int ty, int tx, const LiftParams& P) {
    const int ez = tz + 2 * HALO3, ey = ty + 2 * HALO3, ex = tx + 2 * HALO3;
    lift_lines(s, ex, ez * ey, 1, 1, ex, P);            // x
    lift_lines(s, ey, ez * ex, ex, ex, ey * ex, P);     // y
    lift_lines(s, ez, ey * ex, ey * ex, ey * ex, 0, P); // z
    const int hy = Y / 2, hx = X / 2;
    for (int i = threadIdx.x; i < tz * ty * tx; i += blockDim.x) {
        const int c = i % tx, r = (i / tx) % ty, k = i / (tx * ty);
        const int gz = z0 + k, gy = y0 + r, gx = x0 + c;
        if (gz < Z && gy < Y && gx < X) {
            const T v = s[((k + HALO3) * ey + r + HALO3) * ex + c + HALO3];
            out.b[((gz & 1) << 2) | ((gy & 1) << 1) | (gx & 1)]
                 [((size_t)(gz >> 1) * hy + (gy >> 1)) * hx + (gx >> 1)] =
                scale3(v, k, r, c, P);
        }
    }
    __syncthreads();
}

// The plain load scales each value by its parity factors as it lands
// (B15); a cp.async copy cannot, so its caller scales in inv3_compute.
template <bool ASYNC, typename T>
__device__ void inv3_load(const Bands8<const T>& in, T* s, int Z, int Y, int X, int z0,
                          int y0, int x0, int tz, int ty, int tx, const LiftParams& P) {
    const int ez = tz + 2 * HALO3, ey = ty + 2 * HALO3, ex = tx + 2 * HALO3;
    const int hy = Y / 2, hx = X / 2;
    for (int i = threadIdx.x; i < ez * ey * ex; i += blockDim.x) {
        const int c = i % ex, r = (i / ex) % ey, k = i / (ex * ey);
        const int gz = mirror_idx(z0 - HALO3 + k, Z);
        const int gy = mirror_idx(y0 - HALO3 + r, Y);
        const int gx = mirror_idx(x0 - HALO3 + c, X);
        const T* src = in.b[((gz & 1) << 2) | ((gy & 1) << 1) | (gx & 1)]
                       + ((size_t)(gz >> 1) * hy + (gy >> 1)) * hx + (gx >> 1);
        if constexpr (ASYNC)
            copy_elem<true>(s + i, src);
        else
            s[i] = scale3(*src, k, r, c, P);
    }
}

// Scale by parity (SCALE: after a cp.async load), lift z, y, x, write the
// core.  Ends with a barrier.
template <bool SCALE, typename T>
__device__ void inv3_compute(T* s, T* out, int Z, int Y, int X, int z0, int y0, int x0,
                             int tz, int ty, int tx, const LiftParams& P) {
    const int ez = tz + 2 * HALO3, ey = ty + 2 * HALO3, ex = tx + 2 * HALO3;
    if (SCALE && P.has_scale) {
        for (int i = threadIdx.x; i < ez * ey * ex; i += blockDim.x) {
            const int c = i % ex, r = (i / ex) % ey, k = i / (ex * ey);
            s[i] = scale3(s[i], k, r, c, P);
        }
        __syncthreads();
    }
    lift_lines(s, ez, ey * ex, ey * ex, ey * ex, 0, P); // z
    lift_lines(s, ey, ez * ex, ex, ex, ey * ex, P);     // y
    lift_lines(s, ex, ez * ey, 1, 1, ex, P);            // x
    for (int i = threadIdx.x; i < tz * ty * tx; i += blockDim.x) {
        const int c = i % tx, r = (i / tx) % ty, k = i / (tx * ty);
        const int gz = z0 + k, gy = y0 + r, gx = x0 + c;
        if (gz < Z && gy < Y && gx < X)
            out[((size_t)gz * Y + gy) * X + gx] =
                s[((k + HALO3) * ey + r + HALO3) * ex + c + HALO3];
    }
    __syncthreads();
}

}  // namespace tiles
