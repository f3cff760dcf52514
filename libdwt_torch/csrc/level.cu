// One-level 2-D DWT tile kernels for Hopper (sm_90a), any h, w >= 1:
// the single fused level.
//   dwt_fwd1_*  replaces libdwt_tpu/ops/fused.py fused_dwt2_level (:548,
//               bodies _fwd_kernel_pf :510 and _fwd_kernel :492; TPU
//               kernel id B1);
//   dwt_inv1_*  replaces fused_idwt2_level (:984, body _inv_kernel :948;
//               B4).
// The deep pyramid tails (B3/B6) run all their levels in one cooperative
// launch of deep.cu instead.
// ``ext_rows`` is B1/B4's boundary_rows='extended': the caller supplies
// HALO = 4 rows above and below the image (forward: x has h + 8 rows) or
// CH = 4 channel rows above and below every band (inverse), and rows are
// read straight from that extension with no row mirror; columns still
// mirror.  Rows past the extension read as 0; they reach only outputs
// past the image, which are not stored.
//
// Bound on an H100: bytes.  On a 2144x4096 f32 frame the level moves
// 70.3 MB (21 us at 3.35 TB/s); the (2T+8)^2 halo re-read (1.56x the core
// at T=32) hits L2, and instruction issue in the lifting passes is what
// holds it.
//
// The tile bodies are in tiles.cuh (fwd1_tile, inv1_tile), shared with the
// deep phases of streamed.cu.  Forward: a (2T+8)^2 tile of the image read
// with whole-point mirror indices (_mirror_ext2's extension by 4, which
// also gives odd sizes their ceil/floor bands) -> lift rows, columns,
// scale -> the tile's T x T samples of each band.  Inverse: the
// interleaved coefficient image read through the mirror (exactly the
// channel rules of _pad_ch_static: the high channel of an odd length gets
// its missing ceil-grid sample) -> scale, inverse columns, rows -> the
// tile's 2T x 2T outputs.  float64 (f64) doubles the tile's shared memory
// (41 KB at T=32).
#include "tiles.cuh"

namespace {

constexpr int HALO = tiles::HALO;
constexpr int THREADS = 256;

template <typename T, bool EXT>
__global__ void fwd1_kernel(const T* __restrict__ x, T* ll, T* hl, T* lh, T* hh,
                            int h, int w, int tile, LiftParams P) {
    extern __shared__ unsigned char smem_raw[];
    const int S = 2 * tile;
    tiles::fwd1_tile<EXT ? HALO : 0>(x, ll, hl, lh, hh, h, w, blockIdx.y * S,
                                     blockIdx.x * S, S, S, P,
                                     reinterpret_cast<T*>(smem_raw));
}

template <typename T, bool EXT>
__global__ void inv1_kernel(const T* __restrict__ ll, const T* __restrict__ hl,
                            const T* __restrict__ lh, const T* __restrict__ hh,
                            T* out, int h, int w, int tile, LiftParams P) {
    extern __shared__ unsigned char smem_raw[];
    const int S = 2 * tile;
    tiles::inv1_tile<EXT ? HALO : 0>(ll, hl, lh, hh, out, h, w, blockIdx.y * S,
                                     blockIdx.x * S, S, S, P,
                                     reinterpret_cast<T*>(smem_raw));
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

template <typename T, bool EXT>
int launch_fwd1(const T* x, T* ll, T* hl, T* lh, T* hh, int h, int w, int tile,
                const LiftParams* P, void* stream) {
    const size_t smem = tile_smem(fwd1_kernel<T, EXT>, tile, sizeof(T));
    dim3 grid((w + 2 * tile - 1) / (2 * tile), (h + 2 * tile - 1) / (2 * tile));
    fwd1_kernel<T, EXT><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        x, ll, hl, lh, hh, h, w, tile, *P);
    return (int)cudaGetLastError();
}

template <typename T, bool EXT>
int launch_inv1(const T* ll, const T* hl, const T* lh, const T* hh, T* out, int h,
                int w, int tile, const LiftParams* P, void* stream) {
    const size_t smem = tile_smem(inv1_kernel<T, EXT>, tile, sizeof(T));
    dim3 grid((w + 2 * tile - 1) / (2 * tile), (h + 2 * tile - 1) / (2 * tile));
    inv1_kernel<T, EXT><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        ll, hl, lh, hh, out, h, w, tile, *P);
    return (int)cudaGetLastError();
}

}  // namespace

// h, w: the image's size (without the extension when ext_rows is set).
#define LIBDWT_LEVEL(SUF, T)                                                      \
    extern "C" int dwt_fwd1_##SUF(const T* x, T* ll, T* hl, T* lh, T* hh, int h,   \
                                  int w, int tile, int ext_rows,                  \
                                  const LiftParams* P, void* stream) {            \
        return ext_rows ? launch_fwd1<T, true>(x, ll, hl, lh, hh, h, w, tile, P, stream)   \
                        : launch_fwd1<T, false>(x, ll, hl, lh, hh, h, w, tile, P, stream); \
    }                                                                             \
    extern "C" int dwt_inv1_##SUF(const T* ll, const T* hl, const T* lh,           \
                                  const T* hh, T* out, int h, int w, int tile,    \
                                  int ext_rows, const LiftParams* P,              \
                                  void* stream) {                                 \
        return ext_rows                                                           \
            ? launch_inv1<T, true>(ll, hl, lh, hh, out, h, w, tile, P, stream)    \
            : launch_inv1<T, false>(ll, hl, lh, hh, out, h, w, tile, P, stream);  \
    }

LIBDWT_LEVEL(f32, float)
LIBDWT_LEVEL(i32, int)
LIBDWT_LEVEL(f64, double)
