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
#include "lifting.cuh"

namespace {

constexpr int HALO2 = 12;  // forward level-1 halo (signal samples)
constexpr int IH2 = 8;     // inverse level-2 halo (LL1 samples)
constexpr int IH1 = 4;     // inverse level-1 halo (signal samples)

template <typename T>
__global__ void fwd2_kernel(const T* __restrict__ x, T* ll2, T* hl2, T* lh2, T* hh2,
                            T* hl1, T* lh1, T* hh1, int h, int w, int tile,
                            LiftParams P) {
    extern __shared__ unsigned char smem_raw[];
    T* s1 = reinterpret_cast<T*>(smem_raw);
    const int E = tile + 2 * HALO2;
    const int TQ = tile / 2;
    const int E1 = TQ + 8;
    T* s2 = s1 + E * E;
    const int y0 = blockIdx.y * tile, x0 = blockIdx.x * tile;

    for (int i = threadIdx.x; i < E * E; i += blockDim.x) {
        const int r = i / E, c = i % E;
        const int gy = mirror_idx(y0 - HALO2 + r, h);
        const int gx = mirror_idx(x0 - HALO2 + c, w);
        s1[i] = x[(size_t)gy * w + gx];
    }
    __syncthreads();
    lift_tile(s1, E, E, E, P, true);
    lift_tile(s1, E, E, E, P, false);
    scale_tile(s1, E, E, E, P);

    // level-1 detail bands of the tile's own T x T samples
    for (int i = threadIdx.x; i < tile * tile; i += blockDim.x) {
        const int gy = y0 + i / tile, gx = x0 + i % tile;
        if (gy < h && gx < w && ((gy | gx) & 1))
            band_put<T>(nullptr, hl1, lh1, hh1, gy, gx, w,
                        s1[(HALO2 + i / tile) * E + HALO2 + i % tile]);
    }
    // LL1 with a halo of 4: LL1 positions [q0 - 4, q0 + TQ + 4)
    for (int i = threadIdx.x; i < E1 * E1; i += blockDim.x) {
        const int r = i / E1, c = i % E1;
        s2[i] = s1[(4 + 2 * r) * E + 4 + 2 * c];
    }
    __syncthreads();

    // whole-point re-mirror of the LL1 halo past the bottom/right edge
    const int N = h / 2, M = w / 2;
    const int by = y0 / 2 - 4, bx = x0 / 2 - 4;
    for (int i = threadIdx.x; i < E1 * E1; i += blockDim.x) {
        const int r = i / E1, c = i % E1;
        if (by + r >= N) {
            const int src = max(2 * N - 2 - (by + r) - by, 0);
            s2[i] = s2[src * E1 + c];
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < E1 * E1; i += blockDim.x) {
        const int r = i / E1, c = i % E1;
        if (bx + c >= M) {
            const int src = max(2 * M - 2 - (bx + c) - bx, 0);
            s2[i] = s2[r * E1 + src];
        }
    }
    __syncthreads();

    lift_tile(s2, E1, E1, E1, P, true);
    lift_tile(s2, E1, E1, E1, P, false);
    scale_tile(s2, E1, E1, E1, P);
    for (int i = threadIdx.x; i < TQ * TQ; i += blockDim.x) {
        const int gy = y0 / 2 + i / TQ, gx = x0 / 2 + i % TQ;
        if (gy < N && gx < M)
            band_put<T>(ll2, hl2, lh2, hh2, gy, gx, M,
                        s2[(4 + i / TQ) * E1 + 4 + i % TQ]);
    }
}

template <typename T>
__global__ void inv2_kernel(const T* __restrict__ ll2, const T* __restrict__ hl2,
                            const T* __restrict__ lh2, const T* __restrict__ hh2,
                            const T* __restrict__ hl1, const T* __restrict__ lh1,
                            const T* __restrict__ hh1, T* out, int h, int w,
                            int tile, LiftParams P) {
    extern __shared__ unsigned char smem_raw[];
    T* s2 = reinterpret_cast<T*>(smem_raw);
    const int TQ = tile / 2;
    const int E2 = TQ + 2 * IH2;
    const int E = tile + 2 * IH1;
    T* s1 = s2 + E2 * E2;
    const int N = h / 2, M = w / 2;
    const int y0 = blockIdx.y * tile, x0 = blockIdx.x * tile;
    const int by = y0 / 2 - IH2, bx = x0 / 2 - IH2;

    // level 2: interleaved coefficients of the LL1 domain, mirrored
    for (int i = threadIdx.x; i < E2 * E2; i += blockDim.x) {
        const int r = i / E2, c = i % E2;
        s2[i] = band_at(ll2, hl2, lh2, hh2, mirror_idx(by + r, N),
                        mirror_idx(bx + c, M), M);
    }
    __syncthreads();
    scale_tile(s2, E2, E2, E2, P);
    lift_tile(s2, E2, E2, E2, P, false);
    lift_tile(s2, E2, E2, E2, P, true);

    // LL1 past the bottom/right edge follows the level-1 channel rule
    // s[N+m] = s[N-1-m]; the synthesis left it whole-point (s[N-1+m])
    for (int i = threadIdx.x; i < E2 * E2; i += blockDim.x) {
        const int r = i / E2, c = i % E2;
        if (by + r >= N) {
            const int src = max(2 * N - 1 - (by + r) - by, 0);
            s2[i] = s2[src * E2 + c];
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < E2 * E2; i += blockDim.x) {
        const int r = i / E2, c = i % E2;
        if (bx + c >= M) {
            const int src = max(2 * M - 1 - (bx + c) - bx, 0);
            s2[i] = s2[r * E2 + src];
        }
    }
    __syncthreads();

    // level 1: LL1 from the tile above, details from the mirrored bands
    for (int i = threadIdx.x; i < E * E; i += blockDim.x) {
        const int r = i / E, c = i % E;
        const int py = y0 - IH1 + r, px = x0 - IH1 + c;
        T v;
        if (((py | px) & 1) == 0) {
            v = s2[((py >> 1) - by) * E2 + (px >> 1) - bx];
        } else {
            v = band_at<T>(nullptr, hl1, lh1, hh1, mirror_idx(py, h),
                           mirror_idx(px, w), w);
        }
        s1[i] = v;
    }
    __syncthreads();
    scale_tile(s1, E, E, E, P);
    lift_tile(s1, E, E, E, P, false);
    lift_tile(s1, E, E, E, P, true);
    for (int i = threadIdx.x; i < tile * tile; i += blockDim.x) {
        const int gy = y0 + i / tile, gx = x0 + i % tile;
        if (gy < h && gx < w)
            out[(size_t)gy * w + gx] = s1[(IH1 + i / tile) * E + IH1 + i % tile];
    }
}

constexpr int THREADS = 256;

template <typename T>
int launch_fwd2(const T* x, T* ll2, T* hl2, T* lh2, T* hh2, T* hl1, T* lh1,
                T* hh1, int h, int w, int tile, const LiftParams* P,
                cudaStream_t stream) {
    const int E = tile + 2 * HALO2, E1 = tile / 2 + 8;
    const size_t smem = sizeof(T) * (size_t)(E * E + E1 * E1);
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
    const int E2 = tile / 2 + 2 * IH2, E = tile + 2 * IH1;
    const size_t smem = sizeof(T) * (size_t)(E * E + E2 * E2);
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
