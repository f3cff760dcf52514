// The banded-matmul body (TPU kernel id B13) of the streamed strip kernels,
// on the tensor cores.
//
// Replaces libdwt_tpu/ops/banded.py apply_packed (:389), with
// analysis2d_packed (:624) and synthesis2d_packed (:661) around it: the
// body inside B8/B10/B11/B12's calls with body='mxu'.  csrc/streamed.cu
// instantiates it with MXU = true (float32 only).
//
// Lifting is linear, so one whole 1-D lifting pass over a window (all steps
// and the per-parity scaling) is one banded matrix W.  The tile loads apply
// the whole-point border mirror through the source index (tiles.cuh), so
// every window holds mirrored data and one matrix per (axis, level,
// direction, wavelet, window length) serves every tile; the edge positions
// it gets wrong are the halo the kernels discard.  Forward: columns, then
// rows; inverse: rows, then columns (the reference's order).
//
// One pass (banded_pass), in place on a float window in shared memory:
//   1. split each sample exactly into three bf16 parts x = x0 + x1 + x2
//      (x0 = bf16(x), x1 = bf16(x - x0), x2 = x - x0 - x1; both
//      differences are exact in float32) into [line][k] arrays, zero-padded
//      to 16 lines and to 16 k, so no padding is ever garbage (0 x NaN);
//   2. per 16-line x 8-position output tile, over its 16-row block's
//      16-aligned K window, with mma.sync.m16n8k16 (bf16 in, float32
//      accumulators): lead += Whi.x0 and rest += Wlo.x0 + Whi.x1 + Wlo.x1
//      + Whi.x2, where W ~ Whi + Wlo is the reference's bf16 split of the
//      matrix;
//   3. write lead + rest back (positions < n, lines < the window's); the
//      window is rewritten only after every warp has split it.
// The three data parts make the pass a continuous function of its input,
// and the separate accumulator keeps the small products out of the
// leading one's sums (the tensor cores do not round those sums as IEEE
// float32 does), so the kernel stays close to the plain version
// (ops/banded.py apply_packed_plain, which sums in the same grouping); see
// ops/banded.py for why the reference's two data parts do not.
//
// Matrices: 16-row blocks, each reading a K window of kw (<= 48) columns at
// k0 (ops/banded.py banded_blocks); identical blocks share one canvas.  The
// host builds them in float64, splits them and uploads them once per
// (wavelet, direction, strip); a persistent block copies them into shared
// memory once, before its first strip, with each canvas row padded by PAD
// bf16 so a warp's fragment loads spread over the banks.
//
// Bound on an H100: bytes, as for the polyphase body (the strips read each
// pixel once and write each coefficient once: 70.3 MB at 2144x4096 f32,
// 21 us at 3.35 TB/s).  The band itself needs 5 products x 9 taps x 2 flops
// per sample per pass: about 2 Gflop for a 2144x4096 two-level pass, 2 us at
// 989 Tflop/s bf16.  The mmas issue about ten times that (the 48-wide K
// windows, the 16-padding and the halos), still near the byte bound.  This
// first version keeps the body simple (mma.sync, plain shared-memory
// fragment loads, no wgmma or TMA): it is right first.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

#include "tiles.cuh"

namespace banded {

constexpr int BLK = 16;         // output rows per block; K per mma
constexpr int MAX_BLOCKS = 16;  // blocks of one pass matrix (n <= 256)
constexpr int PAD = 8;          // bf16 padding of each shared-memory row

typedef __nv_bfloat16 bf16;

// One pass matrix.  Its canvases sit at ``off`` elements of the matrices'
// shared copy: ncanvas hi canvases of BLK x (kw + PAD), then as many lo.
struct BandMat {
    int n, kw, nblk, ncanvas, off;
    unsigned char canvas[MAX_BLOCKS];
    short k0[MAX_BLOCKS];
};

// The four passes of a strip kernel (forward: level-1 columns, level-1
// rows, level-2 columns, level-2 rows; inverse: level-2 rows, level-2
// columns, level-1 rows, level-1 columns) and their canvases on the card.
struct MxuMats {
    const bf16* data;
    int elems;  // a multiple of 8
    BandMat m[4];
};

__host__ __device__ __forceinline__ int pad16(int n) { return (n + BLK - 1) / BLK * BLK; }

__host__ __device__ __forceinline__ size_t align16(size_t b) {
    return (b + 15) & ~(size_t)15;
}

// Elements of one data part for an ey x ex window: the larger of its column
// pass (ex lines of ey samples) and its row pass.
__host__ __device__ __forceinline__ int part_elems(int ey, int ex) {
    const int a = pad16(ex) * (pad16(ey) + PAD), b = pad16(ey) * (pad16(ex) + PAD);
    return a > b ? a : b;
}

// Shared memory of a strip kernel with the banded body: ``base`` bytes of
// float windows, the three data parts of ``pe`` elements, the matrices.
__host__ __device__ __forceinline__ size_t smem_bytes(size_t base, int pe, int mat_elems) {
    return align16(base) + 3 * align16(sizeof(bf16) * (size_t)pe)
           + sizeof(bf16) * (size_t)mat_elems;
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// d += a * b: a 16x16 bf16 A fragment (row major), a 16x8 B fragment
// (column major), float32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One banded pass over ``lines`` lines of a float window in shared memory,
// in place: sample (line, k) is s[line * ls + k * ks], k < W.n.  ``mats``
// is the matrices' shared copy, ``x`` the three data parts.  Ends with a
// barrier.
__device__ void banded_pass(float* s, int lines, int ls, int ks, const BandMat& W,
                            const bf16* mats, bf16* const* x) {
    const int kp = pad16(W.n), lp = pad16(lines), ld = kp + PAD;
    for (int i = threadIdx.x; i < lp * kp; i += blockDim.x) {
        const int line = i / kp, k = i - line * kp;
        const float v = (line < lines && k < W.n) ? s[line * ls + k * ks] : 0.0f;
        const bf16 p0 = __float2bfloat16_rn(v);
        const float r = __fsub_rn(v, __bfloat162float(p0));
        const bf16 p1 = __float2bfloat16_rn(r);
        x[0][line * ld + k] = p0;
        x[1][line * ld + k] = p1;
        x[2][line * ld + k] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(p1)));
    }
    __syncthreads();

    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int npos = kp / 8, ntiles = (lp / BLK) * npos;
    const int wld = W.kw + PAD, cstride = BLK * wld;
    const bf16* whi = mats + W.off;
    const bf16* wlo = whi + W.ncanvas * cstride;
    for (int tile = threadIdx.x >> 5; tile < ntiles; tile += blockDim.x >> 5) {
        const int lb = tile / npos, pb = tile - lb * npos, blk = pb >> 1;
        // B fragment rows: the tile's 8 output positions of its block's canvas
        const int wrow = W.canvas[blk] * cstride + ((pb & 1) * 8 + g) * wld + 2 * t;
        const int xrow = (lb * BLK + g) * ld + W.k0[blk] + 2 * t;
        // the leading product Whi.x0 and the four small ones (about 2^-8 of
        // it) in two accumulators
        float lead[4] = {0.0f, 0.0f, 0.0f, 0.0f}, rest[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int kk = 0; kk < W.kw; kk += BLK) {
            const uint32_t bh0 = ld_pair(whi + wrow + kk), bh1 = ld_pair(whi + wrow + kk + 8);
            const uint32_t bl0 = ld_pair(wlo + wrow + kk), bl1 = ld_pair(wlo + wrow + kk + 8);
#pragma unroll
            for (int p = 0; p < 3; ++p) {
                const bf16* a = x[p] + xrow + kk;
                const uint32_t af[4] = {ld_pair(a), ld_pair(a + 8 * ld), ld_pair(a + 8),
                                        ld_pair(a + 8 * ld + 8)};
                mma_bf16(p == 0 ? lead : rest, af, bh0, bh1);
                if (p < 2) mma_bf16(rest, af, bl0, bl1);
            }
        }
        const int line = lb * BLK + g, pos = pb * 8 + 2 * t;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int l = line + (q >> 1) * 8, p = pos + (q & 1);
            if (l < lines && p < W.n) s[l * ls + p * ks] = __fadd_rn(lead[q], rest[q]);
        }
    }
    __syncthreads();
}

// Copy the matrices' canvases into shared memory (16-byte copies).  Ends
// with a barrier.
__device__ void load_mats(const MxuMats& M, bf16* dst) {
    const uint4* src = reinterpret_cast<const uint4*>(M.data);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < M.elems / 8; i += blockDim.x) d[i] = src[i];
    __syncthreads();
}

// The banded 2-D lift of a whole window (rows x cols, row stride cols): the
// lifter interface of tiles::PolyLift.
struct MxuLift {
    const MxuMats& M;
    bf16* mats;        // shared copy
    bf16* x[3];        // shared data parts
    __device__ void fwd(float* s, int rows, int cols, int level) const {
        const int i = 2 * (level - 1);
        banded_pass(s, cols, 1, cols, M.m[i], mats, x);      // columns
        banded_pass(s, rows, cols, 1, M.m[i + 1], mats, x);  // rows
    }
    __device__ void inv(float* s, int rows, int cols, int level) const {
        const int i = level == 2 ? 0 : 2;
        banded_pass(s, rows, cols, 1, M.m[i], mats, x);      // rows
        banded_pass(s, cols, 1, cols, M.m[i + 1], mats, x);  // columns
    }
};

// The lifter over a strip kernel's shared memory: ``base`` bytes of float
// windows, then the data parts of ``pe`` elements, then the matrices'
// copy (see smem_bytes).
__device__ __forceinline__ MxuLift make_lift(const MxuMats& M, unsigned char* smem,
                                             size_t base, int pe) {
    unsigned char* p = smem + align16(base);
    const size_t part = align16(sizeof(bf16) * (size_t)pe);
    bf16* mats = reinterpret_cast<bf16*>(p + 3 * part);
    return MxuLift{M, mats, {reinterpret_cast<bf16*>(p), reinterpret_cast<bf16*>(p + part),
                             reinterpret_cast<bf16*>(p + 2 * part)}};
}

// tiles::fwd2_compute / inv2_compute with the banded body.
__device__ __forceinline__ void fwd2_compute_mxu(float* s1, float* s2, float* ll2,
                                                 float* hl2, float* lh2, float* hh2,
                                                 float* hl1, float* lh1, float* hh1, int h,
                                                 int w, int y0, int x0, int ty, int tx,
                                                 int hy, const MxuLift& lift) {
    tiles::fwd2_lifted(s1, s2, ll2, hl2, lh2, hh2, hl1, lh1, hh1, h, w, y0, x0, ty, tx, hy,
                       lift);
}

__device__ __forceinline__ void inv2_compute_mxu(float* s2, float* s1, float* out, int h,
                                                 int w, int y0, int x0, int ty, int tx,
                                                 const MxuLift& lift) {
    tiles::inv2_lifted(s2, s1, out, h, w, y0, x0, ty, tx, lift);
}

}  // namespace banded
