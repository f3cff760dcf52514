// One-level 2-D DWT tile kernels for Hopper (sm_90a), any h, w >= 1.
//
// The deep pyramid tail launches them once per level over device-memory
// intermediates (each level's LL is the next level's input):
//   dwt_fwd1_*  per level of libdwt_tpu/ops/fused.py fused_deep_wavedec2
//               (:1381, body _deep_kernel :1353; TPU kernel id B3);
//   dwt_inv1_*  per level of fused_deep_waverec2 (:1486, body
//               _deep_inv_kernel :1466; TPU kernel id B6).
// The same pair is the tile kernel a single fused level (fused_dwt2_level,
// fused_idwt2_level) needs.
//
// Bound on an H100: bytes, but the deep levels are small (536x1024 f32 in,
// ~2.1 MB each way, ~1.3 us at 3.35 TB/s) and stay in the 50 MB L2, so
// launch latency dominates: one launch per level instead of the TPU's one
// VMEM-resident launch for all levels (a ~2.2 MB image does not fit one
// SM's 227 KB).  A single-launch cooperative or cluster design is later
// work.
//
// Forward: a (2T+8)^2 tile of the image read with whole-point mirror
// indices (_mirror_ext2's extension by 4, which also gives odd sizes their
// ceil/floor bands) -> lift rows, columns, scale -> the tile's T x T
// samples of each band.  Inverse: the interleaved coefficient image read
// through the mirror (exactly the channel rules of _pad_ch_static: the
// high channel of an odd length gets its missing ceil-grid sample) ->
// scale, inverse columns, rows -> the tile's 2T x 2T outputs.
#include "lifting.cuh"

namespace {

constexpr int HALO = 4;
constexpr int THREADS = 256;

template <typename T>
__global__ void fwd1_kernel(const T* __restrict__ x, T* ll, T* hl, T* lh, T* hh,
                            int h, int w, int tile, LiftParams P) {
    extern __shared__ unsigned char smem_raw[];
    T* s = reinterpret_cast<T*>(smem_raw);
    const int S = 2 * tile;
    const int E = S + 2 * HALO;
    const int y0 = blockIdx.y * S, x0 = blockIdx.x * S;
    for (int i = threadIdx.x; i < E * E; i += blockDim.x) {
        const int r = i / E, c = i % E;
        s[i] = x[(size_t)mirror_idx(y0 - HALO + r, h) * w
                 + mirror_idx(x0 - HALO + c, w)];
    }
    __syncthreads();
    lift_tile(s, E, E, E, P, true);
    lift_tile(s, E, E, E, P, false);
    scale_tile(s, E, E, E, P);
    for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
        const int gy = y0 + i / S, gx = x0 + i % S;
        if (gy < h && gx < w)
            band_put(ll, hl, lh, hh, gy, gx, w, s[(HALO + i / S) * E + HALO + i % S]);
    }
}

template <typename T>
__global__ void inv1_kernel(const T* __restrict__ ll, const T* __restrict__ hl,
                            const T* __restrict__ lh, const T* __restrict__ hh,
                            T* out, int h, int w, int tile, LiftParams P) {
    extern __shared__ unsigned char smem_raw[];
    T* s = reinterpret_cast<T*>(smem_raw);
    const int S = 2 * tile;
    const int E = S + 2 * HALO;
    const int y0 = blockIdx.y * S, x0 = blockIdx.x * S;
    for (int i = threadIdx.x; i < E * E; i += blockDim.x) {
        const int r = i / E, c = i % E;
        s[i] = band_at(ll, hl, lh, hh, mirror_idx(y0 - HALO + r, h),
                       mirror_idx(x0 - HALO + c, w), w);
    }
    __syncthreads();
    scale_tile(s, E, E, E, P);
    lift_tile(s, E, E, E, P, false);
    lift_tile(s, E, E, E, P, true);
    for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
        const int gy = y0 + i / S, gx = x0 + i % S;
        if (gy < h && gx < w)
            out[(size_t)gy * w + gx] = s[(HALO + i / S) * E + HALO + i % S];
    }
}

template <typename K>
size_t tile_smem(K kernel, int tile, size_t item) {
    const int E = 2 * tile + 2 * HALO;
    const size_t smem = item * (size_t)E * E;
    if (smem > 48 * 1024)
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    return smem;
}

}  // namespace

#define LIBDWT_LEVEL(SUF, T)                                                      \
    extern "C" int dwt_fwd1_##SUF(const T* x, T* ll, T* hl, T* lh, T* hh, int h,   \
                                  int w, int tile, const LiftParams* P,           \
                                  void* stream) {                                 \
        const size_t smem = tile_smem(fwd1_kernel<T>, tile, sizeof(T));           \
        dim3 grid((w + 2 * tile - 1) / (2 * tile), (h + 2 * tile - 1) / (2 * tile)); \
        fwd1_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(            \
            x, ll, hl, lh, hh, h, w, tile, *P);                                   \
        return (int)cudaGetLastError();                                           \
    }                                                                             \
    extern "C" int dwt_inv1_##SUF(const T* ll, const T* hl, const T* lh,           \
                                  const T* hh, T* out, int h, int w, int tile,    \
                                  const LiftParams* P, void* stream) {            \
        const size_t smem = tile_smem(inv1_kernel<T>, tile, sizeof(T));           \
        dim3 grid((w + 2 * tile - 1) / (2 * tile), (h + 2 * tile - 1) / (2 * tile)); \
        inv1_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(            \
            ll, hl, lh, hh, out, h, w, tile, *P);                                 \
        return (int)cudaGetLastError();                                           \
    }

LIBDWT_LEVEL(f32, float)
LIBDWT_LEVEL(i32, int)
