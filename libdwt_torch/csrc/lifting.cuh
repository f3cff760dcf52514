// The lifting arithmetic and tile algebra of the hand-written kernels.
//
// A tile is an interleaved (not polyphase-split) block of the signal or
// of the interleaved coefficient image, held in shared memory with a
// halo on BOTH axes.  Every tile starts at an even global row and column,
// so a local index has the parity of its global index and "odd" always
// means the high (d) channel.
//
// A lifting step updates the positions of one parity from their two
// neighbours of the other parity (lift_one; the walks of lines.cuh and
// zwalk.cuh apply it).  The outermost positions of a tile lack a
// neighbour and are simply not updated: each step lets that
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
