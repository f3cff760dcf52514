// The banded-matmul body (TPU kernel id B13) of the streamed strip kernels,
// on the tensor cores.
//
// Replaces libdwt_tpu/ops/banded.py apply_packed (:389), with
// analysis2d_packed (:624) and synthesis2d_packed (:661) around it: the
// body inside B8/B10/B11/B12's calls with body='mxu' (csrc/streamed.cu
// sdeep_fwd_mxu / sdeep_inv_mxu, float32 only).
//
// Lifting is linear, so one whole 1-D lifting pass over a window (all steps
// and the per-parity scaling) is one banded matrix W.  The strip loads apply
// the whole-point border mirror through the source index, so every window
// holds mirrored data and one matrix per (axis, level, direction, wavelet,
// window length) serves every strip; the edge positions it gets wrong are
// the halo the kernels discard.  Forward: columns, then rows; inverse:
// rows, then columns (the reference's order).
//
// One pass (pass), in place on a float window in shared memory:
//   * A warp owns 16 lines of the window (the mma's M) and walks them 8
//     output positions at a time (its N).  Output position p needs the
//     samples p - 4 .. p + 4 (the band of every wavelet the body takes), so
//     the 8 positions from 8m read the 16 samples from 8m - 4: ONE
//     mma.m16n8k16 K step a tile.  The sample halves [8h - 4, 8h + 4) are
//     loaded and split once each; a tile's A fragment is the half it shares
//     with the tile before and the next one.
//   * Each sample is split exactly into three bf16 parts x = x0 + x1 + x2
//     in registers (x0 = bf16(x), x1 = bf16(x - x0), x2 = x - x0 - x1; both
//     differences are exact in float32), packed as the fragment wants them.
//   * Five products a tile, float32 accumulators: lead = Whi.x0 and rest =
//     Wlo.x0 + Whi.x1 + Wlo.x1 + Whi.x2, where W ~ Whi + Wlo is the
//     reference's bf16 split of the matrix; out = lead + rest.  The three
//     data parts make the pass a continuous function of its input and the
//     separate accumulator keeps the small products out of the leading one's
//     sums, so the kernel stays close to the plain version (ops/banded.py
//     apply_packed_plain, which sums in the same grouping).
//   * Write-back in place: a tile's outputs lie in the two halves its A
//     fragment holds, which every lane has read before the mma that the
//     stores wait for; later tiles read only later halves, and no other
//     warp reads these lines.  So a pass needs no buffer beside the window
//     and no barrier but the one after it.
//   * The matrix fragments (B, 16 K x 8 N, hi and lo) are packed on the
//     host per tile and per lane (ops/banded.py kernel_mats): one 16-byte
//     read-only load a tile.  The K and N orders are free as long as A and B
//     agree: a row pass keeps them in order (lane t reads the sample pairs
//     2t, 2t + 1 as one float2); a column pass gives lane t the samples t
//     and t + 4 of a half, so its four lanes read four consecutive window
//     rows.  The row stride (stride: 8 mod 16 words) puts those rows, and a
//     row pass's four lines, on four different groups of 8 banks: no bank
//     conflicts in either pass.
//
// Bound on an H100: bytes, as for the polyphase body (the strips read each
// pixel once and write each coefficient once: 70.3 MB at 2144x4096 f32,
// 21 us at 3.35 TB/s).  The band needs 5 products x 9 taps x 2 flops per
// sample per pass (about 1.8 Gflop a 2144x4096 two-level pass); the tiles
// issue 1.5 M mma.m16n8k16 forward and 1.2 M inverse (6.2 / 5.0 Gflop) at
// the default 96x96 strip, with their 16-sample windows, the 16-line
// blocks and the halos: some 10 us on the tensor cores.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace banded {

constexpr int NT = 8;          // output positions of a tile (the mma's N)
constexpr int MAX_TILES = 32;  // tiles of one pass (windows of <= 256 samples)

// One pass matrix: its window length, its tiles of NT positions, and the
// first of their fragments (tile m's: frags[(off + m) * 32 + lane]).
struct BandMat {
    int n, ntiles, off;
};

// The four passes of a strip kernel (forward: level-1 columns, level-1
// rows, level-2 columns, level-2 rows; inverse: level-2 rows, level-2
// columns, level-1 rows, level-1 columns) and their fragments on the card:
// per tile and lane (Whi b0, Whi b1, Wlo b0, Wlo b1) of the m16n8k16 B
// fragment.
struct MxuMats {
    const uint4* frags;
    int tiles;
    BandMat m[4];
};

// Row stride of a window n samples wide: the least >= n that is 8 mod 16
// (see the header).
__host__ __device__ __forceinline__ int stride(int n) { return n + ((8 - n) & 15); }

// Two samples as a bf16 pair, the first in the low half (an mma fragment
// register), each rounded to nearest even; and back.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float low(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float high(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// The exact three-part split of a sample pair (ops/banded.py split_data).
__device__ __forceinline__ void split(float a, float b, uint32_t (&x)[3]) {
    x[0] = pack(a, b);
    const float ra = __fsub_rn(a, low(x[0])), rb = __fsub_rn(b, high(x[0]));
    x[1] = pack(ra, rb);
    x[2] = pack(__fsub_rn(ra, low(x[1])), __fsub_rn(rb, high(x[1])));
}

// d += a * b: a 16x16 bf16 A fragment (row major), a 16x8 B fragment
// (column major), float32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One banded pass over the L lines of a window (row stride RS), in place.
// COLS: a column pass (line = window column, sample k = window row k), else
// a row pass.  No barrier: the caller puts one after it.
template <bool COLS>
__device__ __forceinline__ void pass(float* s, int RS, int L, const BandMat& W,
                                     const uint4* frags) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int n = W.n, nt = W.ntiles;
    const int pa = COLS ? t : 2 * t, pb = COLS ? t + 4 : 2 * t + 1;  // a half's samples
    const uint4* fr = frags + W.off * 32 + lane;
    for (int l0 = (threadIdx.x >> 5) * 16; l0 < L; l0 += blockDim.x / 2) {
        const int la = min(l0 + g, L - 1), lb = min(l0 + g + 8, L - 1);  // clamped: reads
        // half h's samples of lines la (v[0], v[1]) and lb (v[2], v[3]),
        // clamped into the window (where the matrix columns are zero)
        auto read = [&](int h, float (&v)[4]) {
            const int p = 8 * h - 4;
            if constexpr (COLS) {
                const float* ra = s + min(max(p + pa, 0), n - 1) * RS;
                const float* rb = s + min(max(p + pb, 0), n - 1) * RS;
                v[0] = ra[la];
                v[1] = rb[la];
                v[2] = ra[lb];
                v[3] = rb[lb];
            } else {
                const int q = min(max(p + pa, 0), n - 2);
                const float2 u = *reinterpret_cast<const float2*>(s + la * RS + q);
                const float2 w = *reinterpret_cast<const float2*>(s + lb * RS + q);
                v[0] = u.x;
                v[1] = u.y;
                v[2] = w.x;
                v[3] = w.y;
            }
        };
        // parts [line][part] of the tile's lower and upper halves
        uint32_t lo[2][3], hi[2][3];
        float v[4];
        read(0, v);
        split(v[0], v[1], lo[0]);
        split(v[2], v[3], lo[1]);
        read(1, v);
        split(v[0], v[1], hi[0]);
        split(v[2], v[3], hi[1]);
        uint4 f = __ldg(fr);
        for (int m = 0; m < nt; ++m) {
            const bool more = m + 1 < nt;
            uint4 fn;
            if (more) {  // the next tile's upper half and fragments, in flight
                read(m + 2, v);
                fn = __ldg(fr + (m + 1) * 32);
            }
            float lead[4] = {0.0f, 0.0f, 0.0f, 0.0f}, rest[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma(lead, lo[0][0], lo[1][0], hi[0][0], hi[1][0], f.x, f.y);
            mma(rest, lo[0][0], lo[1][0], hi[0][0], hi[1][0], f.z, f.w);
            mma(rest, lo[0][1], lo[1][1], hi[0][1], hi[1][1], f.x, f.y);
            mma(rest, lo[0][1], lo[1][1], hi[0][1], hi[1][1], f.z, f.w);
            mma(rest, lo[0][2], lo[1][2], hi[0][2], hi[1][2], f.x, f.y);
            // outputs (line, position): (l0 + g, qa), (l0 + g, qb), (l0 + g + 8,
            // qa), (l0 + g + 8, qb), the N order as the K order
            const int qa = 8 * m + pa, qb = 8 * m + pb, l1 = l0 + g, l2 = l1 + 8;
            if constexpr (COLS) {
                if (qa < n) {
                    if (l1 < L) s[qa * RS + l1] = __fadd_rn(lead[0], rest[0]);
                    if (l2 < L) s[qa * RS + l2] = __fadd_rn(lead[2], rest[2]);
                }
                if (qb < n) {
                    if (l1 < L) s[qb * RS + l1] = __fadd_rn(lead[1], rest[1]);
                    if (l2 < L) s[qb * RS + l2] = __fadd_rn(lead[3], rest[3]);
                }
            } else if (qa < n) {  // n even: qb < n too
                if (l1 < L)
                    *reinterpret_cast<float2*>(s + l1 * RS + qa) =
                        make_float2(__fadd_rn(lead[0], rest[0]), __fadd_rn(lead[1], rest[1]));
                if (l2 < L)
                    *reinterpret_cast<float2*>(s + l2 * RS + qa) =
                        make_float2(__fadd_rn(lead[2], rest[2]), __fadd_rn(lead[3], rest[3]));
            }
            if (more) {
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    lo[0][k] = hi[0][k];
                    lo[1][k] = hi[1][k];
                }
                split(v[0], v[1], hi[0]);
                split(v[2], v[3], hi[1]);
                f = fn;
            }
        }
    }
}

// The forward 2-D lift of a window of rows x cols samples (row stride RS):
// the column pass (matrix c), then the row pass (r).  Ends with a barrier.
__device__ __forceinline__ void lift_fwd(float* s, int RS, int rows, int cols,
                                         const BandMat& c, const BandMat& r,
                                         const uint4* frags) {
    pass<true>(s, RS, cols, c, frags);
    __syncthreads();
    pass<false>(s, RS, rows, r, frags);
    __syncthreads();
}

// The inverse: the row pass (r), then the column pass (c).
__device__ __forceinline__ void lift_inv(float* s, int RS, int rows, int cols,
                                         const BandMat& r, const BandMat& c,
                                         const uint4* frags) {
    pass<false>(s, RS, rows, r, frags);
    __syncthreads();
    pass<true>(s, RS, cols, c, frags);
    __syncthreads();
}

}  // namespace banded
