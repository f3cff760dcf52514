// Row halo of a row-sharded 2-D block for Hopper (sm_90a): the gather of a
// line on one card, and the neighbour push of a line over several cards.
//
// Both replace libdwt_tpu/parallel/remote_halo.py rdma_extend_rows (:46,
// pallas_call :191; TPU kernel id B18) and rdma_extend_channels (:214).
// Each of the n shards of a line along a mesh axis holds an h x w block
// x_i; its output out_i is (h + 2*halo) x w: out_i[halo : halo+h] = x_i, the
// top halo rows come from the previous shard's last rows, the bottom ones
// from the next shard's first rows, and the global borders take the mirror
// rows of the edge mode (t_off, b_off) (remote_halo.py:43): out_0[r] =
// x_0[t_off + halo-1-r], out_{n-1}[halo+h+r] = x_{n-1}[h-1-b_off-r].
//
// halo_gather_rows: a line whose shards all sit on one device.  Their
// inputs and outputs are ordered by the device's stream, so no shard waits
// for another: one ordinary launch, no flags, no fence, no spin.  It takes
// one or two channels (the inverse's 's' and 'd' blocks of a line, each
// with its own pointer table, shape and mirror offsets) in one launch.  One
// index space covers every row of every shard's extended output, cut into
// 16-byte chunks; a thread works out each chunk's source row (its own
// block, a neighbour's, or a mirror row: source_row, which
// remote_halo.py gather_rows states in torch) and copies 16 bytes where
// both rows' chunk starts are 16-byte aligned and the row holds a whole
// chunk, else the chunk's elements one at a time (odd widths, misaligned
// views).  One chunk a thread, one pass: the halo rows are spread over the
// grid like the centre; the level-1 shapes fill the 132 SMs many times over
// (8448 blocks), a small level takes the few blocks its bytes need.  More
// chunks a thread lost at the small levels, where a launch is latency:
// each added about 0.4 us (tools/halo_ablate.py).
//
// Bound on an H100: bytes.  Each input is read once and each output
// written once: for the 2048x4096 f32 level-1 extension over 8 shards at
// halo 4, 33.6 MB in and 34.6 MB out, 68.2 MB, about 0.020 ms at
// 3.35 TB/s; the inverse's two channel blocks at halo 2 as much together.
//
// halo_extend_rows: a line over several cards, one cooperative launch per
// device (remote_halo.py:90-189 without its DMA descriptors).  Each
// shard's first block, for shard i:
//   1. signals "entered" into each neighbour's flags, then waits until
//      each neighbour has entered: a neighbour's output buffer may be
//      memory the caching allocator freed on that neighbour's stream, so
//      nothing is written into it before its kernel runs;
//   2. pushes x_i[h-halo : h] into out_{i+1}[0 : halo] and x_i[0 : halo]
//      into out_{i-1}[halo+h :], fences (system scope, so a peer card sees
//      the rows first) and signals "arrived" into the neighbour's flags;
//   3. on an edge shard fills the mirror rows of its own output;
//   4. copies its part of the centre (below), then waits for its own
//      arrivals before it exits, so that stream order hands the whole
//      extended block to the next lifting op.
// Every block of the shard copies part of x_i into out_i[halo : halo+h].
//
// Flags live in a persistent buffer per line and device (four per shard:
// entered from the previous / next shard, arrived from the previous /
// next) and are never reset: a memset on one stream would race with a
// neighbour's signal.  The host passes a new epoch per call; a signal stores the epoch
// with release semantics and a wait loads with acquire semantics until the
// flag is >= epoch.  Every wait has a spin limit (about 4 s) and traps, so
// a protocol fault fails the launch instead of hanging it.
//
// Launch: the shards of one device go in one cooperative launch (blocks
// that spin must be co-resident; the grid is checked against the occupancy
// calculator), shards on other devices in one launch per device, all
// issued before any wait; peer access is enabled once per neighbouring
// pair (halo_enable_peer).  The copy is typed by element size (4 bytes
// for f32/i32, 8 for f64); any width and any row offset.  The
// pointer table rides in the kernel's parameters (at most MAX_SHARDS).
// The centre copy is spread over all the co-resident blocks; the halo
// pushes and mirror rows (4 x 4096 per neighbour) fall to each shard's
// first block, which the neighbours wait for, so every copy moves 16 bytes
// a thread where the rows allow, unrolled over non-aliasing pointers.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SHARDS = 64;
constexpr unsigned long long SPIN_LIMIT = 1ull << 26;  // x 64 ns sleeps

struct Shard {
    const void* x;
    void* out;
    unsigned* flags;  // entered-from-prev, entered-from-next, arrived-from-prev, -next
};

struct Table {
    Shard s[MAX_SHARDS];
    int mine[MAX_SHARDS];  // the global index of each shard of this launch
};

enum { ENTERED_PREV = 0, ENTERED_NEXT = 1, ARRIVED_PREV = 2, ARRIVED_NEXT = 3 };

__device__ __forceinline__ void signal(unsigned* flag, unsigned epoch) {
    asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(flag), "r"(epoch) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* flag) {
    unsigned v;
    asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory");
    return v;
}

__device__ void wait_for(const unsigned* flag, unsigned epoch) {
    unsigned long long spins = 0;
    while (load_acquire(flag) < epoch) {
        if (++spins > SPIN_LIMIT) __trap();
        __nanosleep(64);
    }
}

// dst[k] = src[k] for k = first, first + step, ... < n.  The pointers do
// not alias, so the loads of an unrolled loop can be in flight together.
template <typename V>
__device__ __forceinline__ void copy_span(V* __restrict__ dst, const V* __restrict__ src,
                                          size_t n, size_t first, size_t step) {
#pragma unroll 4
    for (size_t k = first; k < n; k += step) dst[k] = src[k];
}

// dst[0:n] = src[0:n], element k by thread k % step of the set starting at
// ``first``: 16 bytes a thread where both ends and the size allow, else one
// element.
template <typename T>
__device__ __forceinline__ void copy_elems(T* dst, const T* src, size_t n, size_t first,
                                           size_t step) {
    if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0 && (n * sizeof(T)) % 16 == 0)
        copy_span(reinterpret_cast<uint4*>(dst), reinterpret_cast<const uint4*>(src),
                  n * sizeof(T) / 16, first, step);
    else
        copy_span(dst, src, n, first, step);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
halo_kernel(Table tab, int n, int per_shard, int h, int w, int halo, int t_off,
            int b_off, unsigned epoch) {
    const int i = tab.mine[blockIdx.x / per_shard];
    const int part = blockIdx.x % per_shard;
    const T* x = static_cast<const T*>(tab.s[i].x);
    T* out = static_cast<T*>(tab.s[i].out);
    const size_t hw = (size_t)h * w, hw_halo = (size_t)halo * w;

    if (part == 0) {
        unsigned* my = tab.s[i].flags;
        if (threadIdx.x == 0) {
            if (i > 0) signal(tab.s[i - 1].flags + ENTERED_NEXT, epoch);
            if (i < n - 1) signal(tab.s[i + 1].flags + ENTERED_PREV, epoch);
            if (i > 0) wait_for(my + ENTERED_PREV, epoch);
            if (i < n - 1) wait_for(my + ENTERED_NEXT, epoch);
        }
        __syncthreads();
        if (i < n - 1)  // my last rows -> the next shard's top halo
            copy_elems(static_cast<T*>(tab.s[i + 1].out), x + hw - hw_halo, hw_halo,
                       threadIdx.x, blockDim.x);
        if (i > 0)  // my first rows -> the previous shard's bottom halo
            copy_elems(static_cast<T*>(tab.s[i - 1].out) + hw + hw_halo, x, hw_halo,
                       threadIdx.x, blockDim.x);
        for (int r = 0; r < halo; ++r) {
            if (i == 0)  // top mirror: out row r = x row t_off + halo-1-r
                copy_elems(out + (size_t)r * w, x + (size_t)(t_off + halo - 1 - r) * w, w,
                           threadIdx.x, blockDim.x);
            if (i == n - 1)  // bottom mirror: out row halo+h+r = x row h-1-b_off-r
                copy_elems(out + hw + hw_halo + (size_t)r * w,
                           x + (size_t)(h - 1 - b_off - r) * w, w, threadIdx.x, blockDim.x);
        }
        __threadfence_system();
        __syncthreads();
        if (threadIdx.x == 0) {
            if (i < n - 1) signal(tab.s[i + 1].flags + ARRIVED_PREV, epoch);
            if (i > 0) signal(tab.s[i - 1].flags + ARRIVED_NEXT, epoch);
        }
    }
    // the centre rows, spread over the shard's blocks
    copy_elems(out + hw_halo, x, hw, (size_t)part * blockDim.x + threadIdx.x,
               (size_t)per_shard * blockDim.x);
    // my own halo rows have arrived before the launch ends
    if (part == 0 && threadIdx.x == 0) {
        const unsigned* my = tab.s[i].flags;
        if (i > 0) wait_for(my + ARRIVED_PREV, epoch);
        if (i < n - 1) wait_for(my + ARRIVED_NEXT, epoch);
    }
}

// Co-resident blocks of halo_kernel<T> on the current device, asked once
// per device and element type (the launch is small, so the host's time per
// call matters).
template <typename T>
int resident_blocks(int* resident) {
    constexpr int MAX_DEVICES = 64;
    static int cache[MAX_DEVICES] = {0};
    int dev = 0, err;
    if ((err = (int)cudaGetDevice(&dev))) return err;
    if (dev < MAX_DEVICES && cache[dev]) {
        *resident = cache[dev];
        return 0;
    }
    int per_sm = 0, sms = 0;
    if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, halo_kernel<T>,
                                                                  THREADS, 0)))
        return err;
    if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
        return err;
    *resident = per_sm * sms;
    if (dev < MAX_DEVICES) cache[dev] = *resident;
    return 0;
}

template <typename T>
int launch(const Table& tab, int n, int count, int h, int w, int halo, int t_off,
           int b_off, unsigned epoch, int* info, cudaStream_t stream) {
    int resident = 0;
    int err = resident_blocks<T>(&resident);
    if (err) return err;
    if (count < 1 || count > resident) return (int)cudaErrorInvalidConfiguration;
    // blocks per shard: enough for 64 bytes a thread, at most what fits
    const long long want =
        ((long long)h * w * sizeof(T) + THREADS * 64 - 1) / (THREADS * 64);
    int per_shard = (int)(want < resident / count ? want : resident / count);
    if (per_shard < 1) per_shard = 1;
    info[0] = per_shard * count;
    info[1] = resident;
    Table t = tab;
    void* args[] = {(void*)&t, (void*)&n, (void*)&per_shard, (void*)&h, (void*)&w,
                    (void*)&halo, (void*)&t_off, (void*)&b_off, (void*)&epoch};
    err = (int)cudaLaunchCooperativeKernel((const void*)halo_kernel<T>, dim3(info[0]),
                                           dim3(THREADS), args, 0, stream);
    return err ? err : (int)cudaGetLastError();
}

}  // namespace

// One launch on the current device for the ``count`` shards ``mine`` (global
// indices into the line of ``n``); xs/outs/flags: host arrays of the n
// shards' input, output and flag pointers (flags: 4 per shard, on the
// shard's device).  elem: bytes per element.  info[0..1] <- grid, resident
// blocks.  Returns a cudaError_t.
extern "C" int halo_extend_rows(void* const* xs, void* const* outs, void* const* flags,
                                int n, const int* mine, int count, int h, int w,
                                int halo, int t_off, int b_off, int elem, unsigned epoch,
                                int* info, void* stream) {
    if (n < 1 || n > MAX_SHARDS || count > n || halo < 1 || h < halo + 1 || w < 1 ||
        t_off + halo > h || h - halo - b_off < 0)
        return (int)cudaErrorInvalidValue;
    Table tab{};
    for (int i = 0; i < n; ++i)
        tab.s[i] = Shard{xs[i], outs[i], static_cast<unsigned*>(flags[i])};
    for (int k = 0; k < count; ++k) tab.mine[k] = mine[k];
    cudaStream_t s = (cudaStream_t)stream;
    switch (elem) {
        case 4: return launch<uint32_t>(tab, n, count, h, w, halo, t_off, b_off, epoch, info, s);
        case 8: return launch<uint64_t>(tab, n, count, h, w, halo, t_off, b_off, epoch, info, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// Let ``dev`` write into ``peer``'s memory (once per neighbouring pair; an
// already-enabled pair is not an error).  Leaves ``dev`` current.
extern "C" int halo_enable_peer(int dev, int peer) {
    int err = (int)cudaSetDevice(dev);
    if (err) return err;
    err = (int)cudaDeviceEnablePeerAccess(peer, 0);
    if (err == (int)cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();
        return 0;
    }
    return err;
}

namespace {

constexpr int GATHER_THREADS = 256;
constexpr int MAX_CHANNELS = 2;
// the chunk index: 32 bits (the entry point refuses a launch of 2^32
// chunks, 64 GB of output); 64-bit division cost each small launch 0.3 us
using Index = unsigned;

struct Channel {
    const void* x[MAX_SHARDS];
    void* out[MAX_SHARDS];
    Index chunks;  // n * (h + 2*halo) * cpr: this channel's part of the index space
    int h, w, cpr, t_off, b_off;  // cpr: 16-byte chunks a row
};

struct Gather {
    Channel c[MAX_CHANNELS];
};

// The shard ``s`` and row ``row`` of the line's inputs that shard i's
// output row r copies.
__device__ __forceinline__ void source_row(int i, int r, int n, int h, int halo, int t_off,
                                           int b_off, int& s, int& row) {
    if (r < halo) {  // top halo: the previous shard's last rows, or the mirror
        s = i > 0 ? i - 1 : i;
        row = i > 0 ? h - halo + r : t_off + halo - 1 - r;
    } else if (r < halo + h) {
        s = i;
        row = r - halo;
    } else {  // bottom halo: the next shard's first rows, or the mirror
        const int k = r - halo - h;
        s = i < n - 1 ? i + 1 : i;
        row = i < n - 1 ? k : h - 1 - b_off - k;
    }
}

// One 16-byte chunk a thread: chunk q of the channels' index space.
template <typename T>
__global__ void __launch_bounds__(GATHER_THREADS)
gather_kernel(Gather g, int channels, Index total, int n, int halo) {
    constexpr int PER = 16 / sizeof(T);
    Index q = (Index)blockIdx.x * GATHER_THREADS + threadIdx.x;
    if (q >= total) return;
    const int ch = channels > 1 && q >= g.c[0].chunks;
    if (ch) q -= g.c[0].chunks;
    const int h = g.c[ch].h, w = g.c[ch].w;
    const Index cpr = g.c[ch].cpr, per_shard = (Index)(h + 2 * halo) * cpr;
    const int i = (int)(q / per_shard);
    const Index rem = q - (Index)i * per_shard;
    const int r = (int)(rem / cpr);
    const int e0 = (int)(rem - (Index)r * cpr) * PER;
    int s, row;
    source_row(i, r, n, h, halo, g.c[ch].t_off, g.c[ch].b_off, s, row);
    const T* src = static_cast<const T*>(g.c[ch].x[s]) + (size_t)row * w + e0;
    T* dst = static_cast<T*>(g.c[ch].out[i]) + (size_t)r * w + e0;
    const int len = w - e0 < PER ? w - e0 : PER;
    if (len == PER && (((uintptr_t)src | (uintptr_t)dst) & 15) == 0) {
        *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
    } else {  // a row's tail, or rows off 16-byte alignment
        T v[PER];
#pragma unroll
        for (int e = 0; e < PER; ++e)
            if (e < len) v[e] = src[e];
#pragma unroll
        for (int e = 0; e < PER; ++e)
            if (e < len) dst[e] = v[e];
    }
}

}  // namespace

// One ordinary launch on the current device for ``channels`` (1 or 2) lines
// of ``n`` shards that all sit on it.  xs/outs: host arrays of channels x n
// input and output pointers, channel by channel; geom: host int[4 *
// channels], each channel's h, w, t_off, b_off; elem: bytes per element
// (4 or 8, one for both channels).  *grid <- the launch's blocks.  Returns
// a cudaError_t.
extern "C" int halo_gather_rows(void* const* xs, void* const* outs, int n, int channels,
                                const int* geom, int halo, int elem, int* grid,
                                void* stream) {
    if (n < 1 || n > MAX_SHARDS || channels < 1 || channels > MAX_CHANNELS || halo < 1 ||
        (elem != 4 && elem != 8))
        return (int)cudaErrorInvalidValue;
    Gather g{};
    long long total = 0;
    for (int c = 0; c < channels; ++c) {
        const int h = geom[4 * c], w = geom[4 * c + 1], t_off = geom[4 * c + 2],
                  b_off = geom[4 * c + 3];
        if (h < halo + 1 || w < 1 || t_off < 0 || b_off < 0 || t_off + halo > h ||
            h - halo - b_off < 0)
            return (int)cudaErrorInvalidValue;
        Channel& ch = g.c[c];
        for (int i = 0; i < n; ++i) {
            ch.x[i] = xs[c * n + i];
            ch.out[i] = outs[c * n + i];
        }
        ch.h = h;
        ch.w = w;
        ch.t_off = t_off;
        ch.b_off = b_off;
        ch.cpr = (int)(((long long)w * elem + 15) / 16);
        const long long chunks = (long long)n * (h + 2 * halo) * ch.cpr;
        total += chunks;
        if (total >= (1ll << 32)) return (int)cudaErrorInvalidValue;
        ch.chunks = (Index)chunks;
    }
    *grid = (int)((total + GATHER_THREADS - 1) / GATHER_THREADS);
    cudaStream_t s = (cudaStream_t)stream;
    if (elem == 4)
        gather_kernel<uint32_t><<<*grid, GATHER_THREADS, 0, s>>>(g, channels, (Index)total, n,
                                                                halo);
    else
        gather_kernel<uint64_t><<<*grid, GATHER_THREADS, 0, s>>>(g, channels, (Index)total, n,
                                                                halo);
    return (int)cudaGetLastError();
}
