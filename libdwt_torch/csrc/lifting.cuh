// Shared-memory tile algebra for the 2-D lifting kernels.
//
// A tile is an interleaved (not polyphase-split) block of the signal or
// of the interleaved coefficient image, held in shared memory with a
// halo on BOTH axes.  Every tile starts at an even global row and column,
// so a local index has the parity of its global index and "odd" always
// means the high (d) channel.
//
// A lifting step updates the positions of one parity from their two
// neighbours of the other parity.  The outermost positions of a tile
// lack a neighbour and are simply not updated: each step lets that
// staleness move one position inward, so after the four steps of CDF 9/7
// the outer four positions of each side are invalid and the halo covers
// exactly them.
//
// Arithmetic matches the plain PyTorch versions in ops/fused.py bit for
// bit: float steps are t + w*(l + r) (or t + (wl*l + wr*r) for one-sided
// steps) with explicit round-to-nearest intrinsics, so nvcc cannot fuse
// them into FMAs (float32 with float weights, float64 with the double
// weights the plain version multiplies by); integer steps run in 32-bit two's-complement wrap
// (multiply-add in uint32) followed by an arithmetic right shift of the
// int32 result, like XLA and torch on int32.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define LIBDWT_MAX_STEPS 4

// Lifting steps of one direction (already reversed and negated for the
// inverse by the caller), plus the four parity-product scale factors
// (even/even, even/odd, odd/even, odd/odd) = (LL, HL, LH, HH), then the
// per-axis low/high factors of the 3-D kernels, then the same weights and
// factors in double for the float64 kernels (each group appended last, so
// the earlier layout does not move).  The same layout is declared on the
// Python side as a ctypes.Structure.
struct LiftParams {
    int n;
    int is_d[LIBDWT_MAX_STEPS];
    float fwl[LIBDWT_MAX_STEPS];
    float fwr[LIBDWT_MAX_STEPS];
    int sign[LIBDWT_MAX_STEPS];
    int iwl[LIBDWT_MAX_STEPS];
    int iwr[LIBDWT_MAX_STEPS];
    int k[LIBDWT_MAX_STEPS];
    int shift[LIBDWT_MAX_STEPS];
    int has_scale;
    float scale[4];
    float scale_lo;
    float scale_hi;
    double dwl[LIBDWT_MAX_STEPS];
    double dwr[LIBDWT_MAX_STEPS];
    double dscale[4];
    double dscale_lo;
    double dscale_hi;
};

// Whole-point symmetric reflection of any integer position into [0, n).
__device__ __forceinline__ int mirror_idx(int p, int n) {
    if (n == 1) return 0;
    const int period = 2 * (n - 1);
    p %= period;
    if (p < 0) p += period;
    return p >= n ? period - p : p;
}

__device__ __forceinline__ float lift_one(float t, float l, float r,
                                          const LiftParams& P, int s) {
    const float wl = P.fwl[s], wr = P.fwr[s];
    float upd;
    if (wl == wr) {
        upd = __fmul_rn(wl, __fadd_rn(l, r));
    } else {
        upd = 0.0f;
        bool have = false;
        if (wl != 0.0f) { upd = __fmul_rn(wl, l); have = true; }
        if (wr != 0.0f) {
            const float term = __fmul_rn(wr, r);
            upd = have ? __fadd_rn(upd, term) : term;
        }
    }
    return __fadd_rn(t, upd);
}

__device__ __forceinline__ double lift_one(double t, double l, double r,
                                           const LiftParams& P, int s) {
    const double wl = P.dwl[s], wr = P.dwr[s];
    double upd;
    if (wl == wr) {
        upd = __dmul_rn(wl, __dadd_rn(l, r));
    } else {
        upd = 0.0;
        bool have = false;
        if (wl != 0.0) { upd = __dmul_rn(wl, l); have = true; }
        if (wr != 0.0) {
            const double term = __dmul_rn(wr, r);
            upd = have ? __dadd_rn(upd, term) : term;
        }
    }
    return __dadd_rn(t, upd);
}

__device__ __forceinline__ int lift_one(int t, int l, int r,
                                        const LiftParams& P, int s) {
    const uint32_t acc = (uint32_t)P.iwl[s] * (uint32_t)l
                       + (uint32_t)P.iwr[s] * (uint32_t)r + (uint32_t)P.k[s];
    const int v = ((int)acc) >> P.shift[s];
    return (int)((uint32_t)t + (uint32_t)P.sign[s] * (uint32_t)v);
}

// Scale factor ``i`` of P (0..3: the parity products; 4, 5: the per-axis
// low and high factors) applied to one value, in the value's type.
__device__ __forceinline__ float scale_one(float t, const LiftParams& P, int i) {
    return __fmul_rn(t, i < 4 ? P.scale[i] : (i == 4 ? P.scale_lo : P.scale_hi));
}
__device__ __forceinline__ double scale_one(double t, const LiftParams& P, int i) {
    return __dmul_rn(t, i < 4 ? P.dscale[i] : (i == 4 ? P.dscale_lo : P.dscale_hi));
}
__device__ __forceinline__ int scale_one(int t, const LiftParams&, int) { return t; }

// All steps of P along one axis of a rows x cols tile (row stride
// ``stride``).  along_rows: lift within each row (the x direction).
template <typename T>
__device__ void lift_tile(T* t, int rows, int cols, int stride,
                          const LiftParams& P, bool along_rows) {
    const int len = along_rows ? cols : rows;
    const int lines = along_rows ? rows : cols;
    for (int s = 0; s < P.n; ++s) {
        const int start = P.is_d[s] ? 1 : 2;
        const int count = (len - start) / 2;  // positions start, start+2, .. <= len-2
        const int total = count * lines;
        for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
            const int line = idx / count;
            const int pos = start + 2 * (idx % count);
            if (along_rows) {
                T* row = t + line * stride;
                row[pos] = lift_one(row[pos], row[pos - 1], row[pos + 1], P, s);
            } else {
                T* c = t + line;
                c[pos * stride] = lift_one(c[pos * stride], c[(pos - 1) * stride],
                                           c[(pos + 1) * stride], P, s);
            }
        }
        __syncthreads();
    }
}

// Multiply every position by its parity's scale factor (floats only).
template <typename T>
__device__ void scale_tile(T* t, int rows, int cols, int stride,
                           const LiftParams& P) {
    if (!P.has_scale) return;
    for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
        const int r = idx / cols, c = idx % cols;
        T& v = t[r * stride + c];
        v = scale_one(v, P, ((r & 1) << 1) | (c & 1));
    }
    __syncthreads();
}

// Read the interleaved coefficient sample at (mirrored, in-range) global
// position (y, x) of an h x w level from its four bands.  Band widths:
// low columns ceil(w/2), high columns floor(w/2).
template <typename T>
__device__ __forceinline__ T band_at(const T* ll, const T* hl, const T* lh,
                                     const T* hh, int y, int x, int w) {
    const int cw = (w + 1) >> 1, fw = w >> 1;
    const int r = y >> 1, c = x >> 1;
    if (y & 1) return (x & 1) ? hh[r * fw + c] : lh[r * cw + c];
    return (x & 1) ? hl[r * fw + c] : ll[r * cw + c];
}

// Write the analysed sample at global (y, x) of an h x w level into its band.
template <typename T>
__device__ __forceinline__ void band_put(T* ll, T* hl, T* lh, T* hh,
                                         int y, int x, int w, T v) {
    const int cw = (w + 1) >> 1, fw = w >> 1;
    const int r = y >> 1, c = x >> 1;
    if (y & 1) {
        if (x & 1) hh[r * fw + c] = v; else lh[r * cw + c] = v;
    } else {
        if (x & 1) hl[r * fw + c] = v; else if (ll) ll[r * cw + c] = v;
    }
}

// All steps of P along ``lines`` lines of ``len`` samples at ``stride``;
// line l starts at (l / inner) * outer + l % inner.  The one helper
// serves the x (stride 1), y and z axes of a 3-D tile.  For stride 1
// neighbouring threads take neighbouring positions of one line, else the
// same position of neighbouring lines, so a warp reads consecutive words.
template <typename T>
__device__ void lift_lines(T* t, int len, int lines, int stride, int inner,
                           int outer, const LiftParams& P) {
    for (int s = 0; s < P.n; ++s) {
        const int start = P.is_d[s] ? 1 : 2;
        const int count = (len - start) / 2;  // positions start, start+2, .. <= len-2
        const int total = count * lines;
        for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
            const int line = stride == 1 ? idx / count : idx % lines;
            const int k = stride == 1 ? idx % count : idx / lines;
            T* base = t + (line / inner) * outer + line % inner;
            const int pos = (start + 2 * k) * stride;
            base[pos] = lift_one(base[pos], base[pos - stride], base[pos + stride], P, s);
        }
        __syncthreads();
    }
}

// A 3-D sample at parities (z, y, x) times its per-axis factors, applied
// z, then y, then x (floats only; the plain version multiplies in the
// same order).
template <typename T>
__device__ __forceinline__ T scale3(T v, int z, int y, int x, const LiftParams& P) {
    if (!P.has_scale) return v;
    v = scale_one(v, P, 4 + (z & 1));
    v = scale_one(v, P, 4 + (y & 1));
    return scale_one(v, P, 4 + (x & 1));
}
