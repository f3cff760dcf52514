// Two-level fused 2-D DWT tile kernels for Hopper (sm_90a).
//
// dwt_fwd2_*  replaces libdwt_tpu/ops/fused.py fused_dwt2_2level (:784,
//             body _2lvl_kernel :700; TPU kernel id B2).
// dwt_inv2_*  replaces libdwt_tpu/ops/fused.py fused_idwt2_2level (:1173,
//             body _inv2_kernel :1115; TPU kernel id B5).
//
// Bound on an H100: bytes.  Each pixel is read once and each coefficient
// written once (2144x4096 f32: 35.1 MB each way, ~21 us at 3.35 TB/s);
// the lifting arithmetic is ~25 flops per pixel, far below the 67 TFLOP/s
// f32 rate.  The design keeps both levels in shared memory so the level-1
// LL never goes to device memory (the point of the TPU kernel), and takes
// 2-D tiles with a halo on both axes: the TPU's full-width strips relied
// on a lane axis that needed no halo, and a 4096-wide f32 row is 16 KB of
// the 227 KB a block may hold.  The halo re-read (88x88 loaded per 64x64
// tile) and one thread-loop per lifting step keep this simple kernel well
// above the bound; see PERF.md for its measured time.
//
// Forward tile (T x T signal samples, T % 4 == 0, halo 12 = HALO2):
//   load with whole-point mirror reads -> lift rows, columns, scale ->
//   write HL1/LH1/HH1 -> LL1 with halo 4 -> rewrite the LL1 halo past the
//   bottom/right image edge whole-point (the signal-domain mirror induces a
//   HALF-point mirror on LL1 there; the oracle extends LL1 whole-point
//   around its own last sample; the top/left need no fix) -> lift LL1 ->
//   write the four level-2 bands.
// Inverse tile (T x T output samples): level-2 coefficients in the LL1
//   domain with halo 8 -> scale, inverse columns, rows -> LL1 with halo 2;
//   rewrite the LL1 rows/columns past the bottom/right edge with the
//   level-1 channel rule s[N+m] = s[N-1-m] -> interleave with the mirrored
//   level-1 bands (halo 4) -> scale, inverse columns, rows -> write.
// Axis order: forward rows then columns, inverse columns then rows, for
// floats and ints alike (the integer order the oracle needs bit-exactly).
// The tile bodies are in tiles.cuh (fwd2_*, inv2_*), shared with the strip
// kernels of streamed.cu.
#include "tiles.cuh"

namespace {

constexpr int HALO2 = tiles::HALO2;

template <typename T>
__global__ void fwd2_kernel(const T* __restrict__ x, T* ll2, T* hl2, T* lh2, T* hh2,
                            T* hl1, T* lh1, T* hh1, int h, int w, int tile,
                            LiftParams P) {
    extern __shared__ unsigned char smem_raw[];
    T* s1 = reinterpret_cast<T*>(smem_raw);
    T* s2 = s1 + tiles::fwd2_elems(tile, tile, HALO2);
    const int y0 = blockIdx.y * tile, x0 = blockIdx.x * tile;
    tiles::fwd2_load<false>(x, s1, h, w, y0, x0, tile, tile, HALO2);
    __syncthreads();
    tiles::fwd2_compute(s1, s2, ll2, hl2, lh2, hh2, hl1, lh1, hh1, h, w, y0, x0,
                        tile, tile, HALO2, P);
}

template <typename T>
__global__ void inv2_kernel(const T* __restrict__ ll2, const T* __restrict__ hl2,
                            const T* __restrict__ lh2, const T* __restrict__ hh2,
                            const T* __restrict__ hl1, const T* __restrict__ lh1,
                            const T* __restrict__ hh1, T* out, int h, int w,
                            int tile, LiftParams P) {
    extern __shared__ unsigned char smem_raw[];
    T* s2 = reinterpret_cast<T*>(smem_raw);
    T* s1 = s2 + tiles::inv2_l2_elems(tile, tile);
    const int y0 = blockIdx.y * tile, x0 = blockIdx.x * tile;
    tiles::inv2_load<false>(ll2, hl2, lh2, hh2, hl1, lh1, hh1, s2, s1, h, w, y0, x0,
                            tile, tile);
    __syncthreads();
    tiles::inv2_compute(s2, s1, out, h, w, y0, x0, tile, tile, P);
}

constexpr int THREADS = 256;

template <typename T>
int launch_fwd2(const T* x, T* ll2, T* hl2, T* lh2, T* hh2, T* hl1, T* lh1,
                T* hh1, int h, int w, int tile, const LiftParams* P,
                cudaStream_t stream) {
    const size_t smem = sizeof(T) * (size_t)(tiles::fwd2_elems(tile, tile, HALO2)
                                             + tiles::fwd2_ll1_elems(tile, tile));
    if (smem > 48 * 1024)
        cudaFuncSetAttribute(fwd2_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    dim3 grid((w + tile - 1) / tile, (h + tile - 1) / tile);
    fwd2_kernel<T><<<grid, THREADS, smem, stream>>>(x, ll2, hl2, lh2, hh2, hl1,
                                                    lh1, hh1, h, w, tile, *P);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_inv2(const T* ll2, const T* hl2, const T* lh2, const T* hh2,
                const T* hl1, const T* lh1, const T* hh1, T* out, int h, int w,
                int tile, const LiftParams* P, cudaStream_t stream) {
    const size_t smem = sizeof(T) * (size_t)(tiles::inv2_l2_elems(tile, tile)
                                             + tiles::inv2_l1_elems(tile, tile));
    if (smem > 48 * 1024)
        cudaFuncSetAttribute(inv2_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    dim3 grid((w + tile - 1) / tile, (h + tile - 1) / tile);
    inv2_kernel<T><<<grid, THREADS, smem, stream>>>(ll2, hl2, lh2, hh2, hl1, lh1,
                                                    hh1, out, h, w, tile, *P);
    return (int)cudaGetLastError();
}

}  // namespace

#define LIBDWT_FUSED2(SUF, T)                                                     \
    extern "C" int dwt_fwd2_##SUF(const T* x, T* ll2, T* hl2, T* lh2, T* hh2,      \
                                  T* hl1, T* lh1, T* hh1, int h, int w, int tile, \
                                  const LiftParams* P, void* stream) {            \
        return launch_fwd2<T>(x, ll2, hl2, lh2, hh2, hl1, lh1, hh1, h, w, tile,   \
                              P, (cudaStream_t)stream);                           \
    }                                                                             \
    extern "C" int dwt_inv2_##SUF(const T* ll2, const T* hl2, const T* lh2,        \
                                  const T* hh2, const T* hl1, const T* lh1,       \
                                  const T* hh1, T* out, int h, int w, int tile,   \
                                  const LiftParams* P, void* stream) {            \
        return launch_inv2<T>(ll2, hl2, lh2, hh2, hl1, lh1, hh1, out, h, w, tile, \
                              P, (cudaStream_t)stream);                           \
    }

LIBDWT_FUSED2(f32, float)
LIBDWT_FUSED2(i32, int)
