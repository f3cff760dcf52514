// The column z walk of the one-level volume kernels: B16/B17
// (streamed3d.cu) and B14/B15 (fused3d.cu).
//
// A block owns a column of ty x tx samples (y, x) with a halo of 4 on y and
// x only, and walks it down z in steps of STEP plane pairs.  z is the walk
// axis of lines.cuh's register pipeline (zwalk::Walk): each thread carries
// the z state of the positions it owns from one step to the next, and the
// z halo is read once, as two warm-up pairs at each end of a segment
// (whole-point mirrored planes at the volume's ends, the neighbouring
// segment's planes at a cut).  A step's planes come into a ring of RING
// steps in shared memory while the step before lifts.  The x and y lifts
// walk whole window lines, up to LINES a thread side by side
// (zwalk::walk_lines).  Every lift is lift_one's arithmetic, x, y, z
// forward and z, y, x inverse, so the values are the plain versions' bit
// for bit.
//
// Forward (fwd_walk): per step, lift x on every window row of its planes,
// then y on the core columns; each thread then pushes its chunk of ZX core
// samples (one row) of each pair into its z walks, and the pair that comes
// out final is scaled (z, then y, then x factor) and stored from
// registers, 16 bytes a lane into each of the 4 bands of its row's y
// parity.  Inverse (inv_walk): per step, each thread reads its window
// positions of each pair from the ring, scaled by their parity factors as
// they are read, and pushes them into its z walks; the pairs that come out
// final go to a buffer of STEP plane pairs, lifted along y on every column
// and along x on the core rows, whose core rows are stored 16 bytes a lane.
//
// The forward walk is a template over a feed: the code that puts a step's
// planes, EY rows of stride RS (16-byte aligned rows), into a ring slot and
// says when they have landed.  Its feeds: RowFeed (B16, and B14 where no
// tensor map describes the volume), one bulk copy a window row, and
// fused3d.cu's BoxFeed (B14), one 3-D TMA box a plane.  The inverse walk
// (B17 and B15) has one feed, 16-byte cp.async chunks into planes whose
// rows are split into their x-low and x-high halves, so that a band row
// loads as whole chunks.  A column is cut into
// segments at multiples of tz planes, as many as fill the co-resident
// blocks; one work item is a (column, segment), and neighbouring items take
// neighbouring columns.
#pragma once

#include <algorithm>

#include <cuda_pipeline.h>

#include "tiles3.cuh"
#include "zwalk.cuh"

namespace volwalk {

using tiles::Bands8;
constexpr int HALO = tiles::HALO3;
constexpr int WARM = zwalk::WARM;
constexpr int FWD_THREADS = 128, FWD_BLOCKS = 4;
constexpr int INV_THREADS = 256, INV_BLOCKS = 2;
// plane pairs a step: lifted in x and y together, then walked down z
constexpr int STEP = 2;
// steps in the shared-memory ring: the step that lifts and RING - 1 in flight
constexpr int RING = 2;
// lines of a pass a thread walks side by side, at most
constexpr int LINES = 2;
constexpr size_t SMEM_MAX = 227 * 1024;

template <typename T>
struct Cfg {
    // samples of a 16-byte chunk
    static constexpr int V = 16 / (int)sizeof(T);
    // forward: core samples along x that a thread walks down z (V a band)
    static constexpr int ZX = 2 * V;
    // inverse: window positions that a thread walks down z, at most
    static constexpr int NQ = 32 / (int)sizeof(T);
    // inverse: samples a half-row loads before its first window sample, so
    // that its chunks start 16-byte aligned in the band when tx % 2V == 0
    static constexpr int LEAD = (V - 2 % V) % V;
};

// Columns of ty x tx samples (nx along x, ny along y), each cut into nseg
// segments of sps runs of tz planes; item = seg * (nx * ny) + column.
// The window of a plane is EY x EX (row stride RS); the inverse's input
// planes keep the x-low half of a row at 0 and the x-high half at HO (row
// stride RSI).
struct Geo {
    int Z, Y, X, tz, ty, tx, nx, ny, nz, sps, nseg;
    int EY, EX, RS, HO, RSI;
    __host__ __device__ int items() const { return nx * ny * nseg; }
};

// A column's segment: core pairs [ka, kb), walked from pair k0 = ka - WARM
// over n pairs.
struct Seg {
    int x0, y0, k0, n;
    __device__ Seg(const Geo& g, int item) {
        const int cols = g.nx * g.ny, col = item % cols, seg = item / cols;
        x0 = (col % g.nx) * g.tx;
        y0 = (col / g.nx) * g.ty;
        const int first = seg * g.sps, last = min(g.nz, first + g.sps);
        const int ka = first * g.tz / 2, kb = min(g.Z / 2, last * g.tz / 2);
        k0 = ka - WARM;
        n = kb - ka + 2 * WARM;
    }
};

// The per-axis factor of a low (0) or high (1) sample: 1 where P has no
// scale and for int32.
template <typename T>
__device__ __forceinline__ T axis_factor(const LiftParams& P, int odd) {
    if constexpr (std::is_same<T, float>::value)
        return P.has_scale ? (odd ? P.scale_hi : P.scale_lo) : 1.0f;
    else if constexpr (std::is_same<T, double>::value)
        return P.has_scale ? (odd ? P.dscale_hi : P.dscale_lo) : 1.0;
    else
        return T(1);
}

// v times its z, y, then x factor: the plain versions' order.
template <typename T>
__device__ __forceinline__ T scale_zyx(T v, T fz, T fy, T fx) {
    return lines::mul(lines::mul(lines::mul(v, fz), fy), fx);
}

// mirror_idx in a few operations where one reflection lands in [0, n) (a
// window reaches past the volume by at most its halo, unless the volume is
// narrower than a column).
__device__ __forceinline__ int mirror_near(int p, int n) {
    const int q = p < 0 ? -p : (p >= n ? 2 * n - 2 - p : p);
    return q >= 0 && q < n ? q : mirror_idx(p, n);
}

// A chunk of V samples in flight: one 16-byte copy past L1 (cp.async.cg)
// where its row in shared memory is 16-byte aligned (whole16), else two of
// 8 bytes for the 4-byte types (rows of lines::stride are 8-byte aligned).
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, bool whole16) {
    constexpr int V = Cfg<T>::V;
    if (whole16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                     "l"(src)
                     : "memory");
    } else {
#pragma unroll
        for (int u = 0; u < V; u += 2) __pipeline_memcpy_async(dst + u, src + u, 2 * sizeof(T));
    }
}

// The Hopper bulk copy (TMA without a tensor map) and its mbarrier: a
// contiguous run of 16-byte multiples, 16-byte aligned at both ends, lands
// in shared memory and counts its bytes off the barrier of its slot.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}
// The one arrival of a slot's phase, with the bytes its copies will bring.
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}
// Wait for the phase of the given parity to complete; a phase that never
// completes traps (a launch error) rather than hangs the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
    for (long long i = 0;; ++i) {
        unsigned done;
        asm volatile(
            "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
            "selp.u32 %0, 1, 0, p; }"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
        if (done) return;
        if (i > (1LL << 20)) __trap();
    }
}
// Order this thread's reads and writes of shared memory before the bulk
// copies that later overwrite it (they write through the async proxy).
__device__ __forceinline__ void fence_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Band (zp, yp, xp) of 8, selected from the pointers by constant indices
// (an index computed at run time copies the 8 pointers to local memory).
template <typename B>
__device__ __forceinline__ auto band_of(const B& bands, int zp, int yp, int xp) {
    const auto lo = yp ? (xp ? bands.b[3] : bands.b[2]) : (xp ? bands.b[1] : bands.b[0]);
    const auto hi = yp ? (xp ? bands.b[7] : bands.b[6]) : (xp ? bands.b[5] : bands.b[4]);
    return zp ? hi : lo;
}

// ------------------------------------------------------------ forward

// Step st of a segment (plane pairs STEP st .. STEP st + STEP - 1 of its
// walk, those of its n) of the signal into s: 2 STEP planes of EY rows of
// stride RS, each plane's rows after the one before.  bulk: each row's
// columns inside x in one bulk copy on ``bar`` (those past x's edges
// through the mirror, one element each).  Else each thread keeps chunk
// column lm of V samples and walks rows lr, lr + groups, ... of each
// plane: vec, 8-byte copies; vec16, 16-byte ones where RS keeps the
// window's rows aligned.
template <typename T>
__device__ __forceinline__ void fwd_load(const T* __restrict__ x, T* s, const Geo& g,
                                         const Seg& sg, int st, int lm, int lr, int groups,
                                         bool vec, bool vec16, bool bulk, uint64_t* bar) {
    constexpr int V = Cfg<T>::V;
    const bool in_y = sg.y0 - HALO >= 0 && sg.y0 - HALO + g.EY <= g.Y;
    const int planes = 2 * min(STEP, sg.n - STEP * st);
    const int z0 = 2 * (sg.k0 + STEP * st);
    if (bulk) {
        const int c_lo = max(0, HALO - sg.x0), c_hi = min(g.EX, g.X - sg.x0 + HALO);
        const unsigned bytes = (c_hi - c_lo) * sizeof(T);
        if (threadIdx.x == 0) bar_expect(bar, planes * g.EY * bytes);
        for (int rr = threadIdx.x; rr < planes * g.EY; rr += blockDim.x) {
            const int pl = rr / g.EY, r = rr - pl * g.EY;
            const int gy = in_y ? sg.y0 - HALO + r : mirror_near(sg.y0 - HALO + r, g.Y);
            const T* row = x + ((size_t)mirror_near(z0 + pl, g.Z) * g.Y + gy) * g.X
                           + sg.x0 - HALO;
            T* dst = s + rr * g.RS;
            bulk_copy(dst + c_lo, row + c_lo, bytes, bar);
            for (int c = 0; c < c_lo; ++c)
                __pipeline_memcpy_async(dst + c, row + mirror_near(sg.x0 - HALO + c, g.X)
                                                     - (sg.x0 - HALO), sizeof(T));
            for (int c = c_hi; c < g.EX; ++c)
                __pipeline_memcpy_async(dst + c, row + mirror_near(sg.x0 - HALO + c, g.X)
                                                     - (sg.x0 - HALO), sizeof(T));
        }
        return;
    }
    const int gx = sg.x0 - HALO + lm * V, nc = min(V, g.EX - lm * V);
    const bool in_x = vec && nc == V && gx >= 0 && gx + V <= g.X;
    const bool whole16 = vec16 && g.RS % V == 0 && gx % V == 0;
    for (int pl = 0; pl < planes; ++pl) {
        const int gz = mirror_near(z0 + pl, g.Z);
        for (int r = lr; r < g.EY; r += groups) {
            const int gy = in_y ? sg.y0 - HALO + r : mirror_near(sg.y0 - HALO + r, g.Y);
            const T* row = x + ((size_t)gz * g.Y + gy) * g.X;
            T* dst = s + (pl * g.EY + r) * g.RS + lm * V;
            if (in_x) {
                copy_chunk(dst, row + gx, whole16);
            } else {
                for (int u = 0; u < nc; ++u)
                    __pipeline_memcpy_async(dst + u, row + mirror_near(gx + u, g.X), sizeof(T));
            }
        }
    }
}

// The forward's row feed (B16; B14 where no tensor map describes the
// volume): fwd_load's copies, the bulk ones counted off the barrier of the
// slot (bars: one a slot, after the ring), the rest off cp.async groups.
// A feed's issue() starts step st of a segment into slot sl at s (if the
// segment has that step); its wait() waits for the step in slot sl and
// ends with a block barrier; done() ends a segment.
template <typename T>
struct RowFeed {
    const T* __restrict__ x;
    const Geo& g;
    int lm, lr, groups;
    bool loads, vec_in, vec16, bulk;
    uint64_t* bars;
    // bit i: slot i's phase
    unsigned ph;

    // ring: the ring of RING slots of SL samples, its barriers after it
    __device__ __forceinline__ RowFeed(const T* __restrict__ x_, const Geo& g_, T* ring, int SL)
        : x(x_), g(g_) {
        constexpr int V = Cfg<T>::V;
        const int t = threadIdx.x;
        // its load chunk
        const int cpr = (g.EX + V - 1) / V;
        groups = FWD_THREADS / cpr;
        loads = t < groups * cpr;
        lm = t % cpr, lr = t / cpr;
        vec_in = reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0;
        vec16 = lines::aligned16(x) && g.X % V == 0;
        bulk = vec16 && g.tx % V == 0 && g.RS % V == 0;
        bars = reinterpret_cast<uint64_t*>(ring + RING * SL);
        ph = 0;
        if (t == 0)
            for (int i = 0; i < RING; ++i) bar_init(bars + i);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        __syncthreads();
    }
    __device__ __forceinline__ void issue(const Seg& sg, int st, int steps, T* s, int sl) {
        if ((bulk || loads) && st < steps)
            fwd_load(x, s, g, sg, st, lm, lr, groups, vec_in, vec16, bulk, bars + sl);
        __pipeline_commit();  // possibly empty: keeps wait_prior exact
    }
    __device__ __forceinline__ void wait(const Seg&, int, int sl, T*) {
        fence_async();  // the z step of st - 1 before the copies into its slot
        if (bulk) {
            bar_wait(bars + sl, (ph >> sl) & 1);
            ph ^= 1u << sl;
        }
        __pipeline_wait_prior(RING - 2);
        __syncthreads();
    }
    __device__ __forceinline__ void done() {
        fence_async();
        __syncthreads();
    }
};

// The forward's column walk over its work items, planes from a Feed made
// of ``src`` (B16's input, B14's tensor map): the whole body of B16 and B14.
template <typename T, int NST, bool SYM, typename Feed, typename Src>
__device__ __forceinline__ void fwd_walk(Src src, const Bands8<T>& out, const Geo& g,
                                         const LiftParams& P, T* const ring) {
    constexpr int V = Cfg<T>::V, ZX = Cfg<T>::ZX;
    using Walk = zwalk::Walk<NST, SYM, false, T>;
    using VT = typename lines::Vec16<T>::type;
    using PT = typename lines::Pair<T>::type;
    const lines::Lifter<T, SYM> lift{P};
    const int t = threadIdx.x, PL = g.EY * g.RS, SL = 2 * STEP * PL;
    const int hy = g.Y / 2, hx = g.X / 2;
    // this thread's lines of a step's x pass (window rows of its planes,
    // one after another) and y pass (core columns), as offsets in a slot
    int xo[LINES], yo[LINES], xm = 0, ym = 0;
#pragma unroll
    for (int i = 0; i < LINES; ++i) {
        const int q = t + i * FWD_THREADS, p = q / g.tx;
        xo[i] = q * g.RS;
        yo[i] = p * PL + HALO + q - p * g.tx;
        xm += q < 2 * STEP * g.EY;
        ym += q < 2 * STEP * g.tx;
    }
    // its core chunk: row zr, columns zc .. zc + nv
    const int cpz = (g.tx + ZX - 1) / ZX, zr = t / cpz, zc = (t % cpz) * ZX;
    const int nv = zr < g.ty ? min(ZX, g.tx - zc) : 0;
    const int zoff = (HALO + zr) * g.RS + HALO + zc;
    Feed feed(src, g, ring, SL);
    bool vec_out = hx % V == 0 && g.tx % ZX == 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) vec_out = vec_out && lines::aligned16(out.b[b]);
    const int yp = zr & 1;
    const T fy = axis_factor<T>(P, yp);
    const T f[2] = {axis_factor<T>(P, 0), axis_factor<T>(P, 1)};

    for (int item = blockIdx.x; item < g.items(); item += gridDim.x) {
        const Seg sg(g, item);
        const int steps = (sg.n + STEP - 1) / STEP;
        const int gy = sg.y0 + zr, gx = sg.x0 + zc;
        const int nvx = gy < g.Y ? min(nv, g.X - gx) : 0;
#pragma unroll
        for (int st = 0; st < RING - 1; ++st) feed.issue(sg, st, steps, ring + st * SL, st);
        Walk w[ZX];
        for (int st = 0; st < steps; ++st) {
            const int sl = st % RING;
            T* const s = ring + sl * SL;
            feed.wait(sg, st, sl, s);
            // into the slot of step st - 1, free since its z step
            const int sn = st + RING - 1;
            feed.issue(sg, sn, steps, ring + (sn % RING) * SL, sn % RING);
            {
                lines::RowLine<T> ln[LINES];
#pragma unroll
                for (int i = 0; i < LINES; ++i) ln[i] = {s + xo[i]};
                zwalk::walk_lines<NST, SYM, false, LINES>(ln, xm, g.EX / 2, P);
            }
            __syncthreads();
            {
                lines::ColLine<T> ln[LINES];
#pragma unroll
                for (int i = 0; i < LINES; ++i) ln[i] = {s + yo[i], g.RS};
                zwalk::walk_lines<NST, SYM, false, LINES>(ln, ym, g.EY / 2, P);
            }
            __syncthreads();
            if (nv == 0) continue;
#pragma unroll
            for (int p = 0; p < STEP; ++p) {
                const int j = STEP * st + p;  // the pair of the walk
                if (j >= sg.n) break;
                T ze[ZX], zo[ZX];
#pragma unroll
                for (int u = 0; u < ZX; u += 2) {
                    PT a = {T(0), T(0)}, b = {T(0), T(0)};
                    if (u < nv) {
                        a = *reinterpret_cast<const PT*>(s + 2 * p * PL + zoff + u);
                        b = *reinterpret_cast<const PT*>(s + (2 * p + 1) * PL + zoff + u);
                    }
                    // the even plane's samples (a) and the odd plane's (b) at x = u, u + 1
                    w[u].push(a.x, b.x, lift, ze[u], zo[u]);
                    w[u + 1].push(a.y, b.y, lift, ze[u + 1], zo[u + 1]);
                }
                const int q = j - Walk::D;  // the pair that came out final
                if (q < WARM || q >= sg.n - WARM || nvx <= 0) continue;
                const size_t at = ((size_t)(sg.k0 + q) * hy + (gy >> 1)) * hx + (gx >> 1);
#pragma unroll
                for (int zp = 0; zp < 2; ++zp) {
                    const T* v = zp ? zo : ze;
#pragma unroll
                    for (int xp = 0; xp < 2; ++xp) {
                        T* band = band_of(out, zp, yp, xp) + at;
                        if (vec_out && nvx == ZX) {
                            VT pk;
                            T* e = reinterpret_cast<T*>(&pk);
#pragma unroll
                            for (int i = 0; i < V; ++i)
                                e[i] = scale_zyx(v[2 * i + xp], f[zp], fy, f[xp]);
                            *reinterpret_cast<VT*>(band) = pk;
                        } else {
#pragma unroll
                            for (int i = 0; i < V; ++i)
                                if (2 * i < nvx)
                                    band[i] = scale_zyx(v[2 * i + xp], f[zp], fy, f[xp]);
                        }
                    }
                }
            }
        }
        feed.done();
    }
}

// ------------------------------------------------------------ inverse

// Step st of a segment of the interleaved coefficient volume into s: 2 STEP
// planes of EY rows of stride RSI.  Row r of a plane holds its x-low
// samples from LEAD and its x-high samples from HO + LEAD, each read from
// the band of the row's z and y parity (a pair starts at an even plane,
// and the mirror keeps parity).  Each thread keeps chunk column lm of
// half h.  (Bulk copies of the half-rows, 96 bytes each at the default
// tile, measured slower than these chunks: PERF.md section 6.)
template <typename T>
__device__ __forceinline__ void inv_load(const Bands8<const T>& in, T* s, const Geo& g,
                                         const Seg& sg, int st, int h, int lm, int lr,
                                         int groups, bool vec) {
    constexpr int V = Cfg<T>::V, LEAD = Cfg<T>::LEAD;
    const int hy = g.Y / 2, hx = g.X / 2, EXH = g.EX / 2;
    const bool in_y = sg.y0 - HALO >= 0 && sg.y0 - HALO + g.EY <= g.Y;
    const int planes = 2 * min(STEP, sg.n - STEP * st);
    const int z0 = 2 * (sg.k0 + STEP * st);
    // the chunk's first sample is window half-column i0 (LEAD of them pad)
    const int i0 = lm * V - LEAD, bc = sg.x0 / 2 - HALO / 2 + i0;
    const bool in_x = vec && bc >= 0 && bc + V <= hx;
    for (int pl = 0; pl < planes; ++pl) {
        const int gz = mirror_near(z0 + pl, g.Z);
        for (int r = lr; r < g.EY; r += groups) {
            const int gy = in_y ? sg.y0 - HALO + r : mirror_near(sg.y0 - HALO + r, g.Y);
            const T* row = band_of(in, pl & 1, r & 1, h)
                           + ((size_t)(gz >> 1) * hy + (gy >> 1)) * hx;
            T* dst = s + (pl * g.EY + r) * g.RSI + h * g.HO + lm * V;
            if (in_x) {
                copy_chunk(dst, row + bc, true);
            } else {
                // window half-column i is signal x0 - HALO + 2 i + h
                for (int u = 0; u < V; ++u) {
                    const int i = i0 + u;
                    if (i >= 0 && i < EXH)
                        __pipeline_memcpy_async(
                            dst + u, row + (mirror_near(sg.x0 - HALO + 2 * i + h, g.X) >> 1),
                            sizeof(T));
                }
            }
        }
    }
}

// The inverse's column walk over its work items: the whole body of B17 and
// B15, fed by inv_load's chunks into planes of split x halves, counted off
// cp.async groups.
template <typename T, int NST, bool SYM>
__device__ __forceinline__ void inv_walk(const Bands8<const T>& in, T* __restrict__ out,
                                         const Geo& g, const LiftParams& P,
                                         unsigned char* smem_raw) {
    constexpr int V = Cfg<T>::V, NQ = Cfg<T>::NQ;
    constexpr bool SF = NST > 1;
    using Walk = zwalk::Walk<NST, SYM, SF, T>;
    using VT = typename lines::Vec16<T>::type;
    const lines::Lifter<T, SYM> lift{P};
    const int t = threadIdx.x, PLI = g.EY * g.RSI, PL = g.EY * g.RS, SLI = 2 * STEP * PLI;
    T* const ring = reinterpret_cast<T*>(smem_raw);
    // the STEP plane pairs that come out of z, 2 STEP planes of EY x RS
    T* const ob = ring + RING * SLI;
    // this thread's window positions: column zc, rows zr0 + i zg (i < NQ)
    const int zg = INV_THREADS / g.EX, zc = t % g.EX, zr0 = t / g.EX;
    const bool zact = zr0 < zg;
    const int zin = zr0 * g.RSI + (zc & 1) * g.HO + Cfg<T>::LEAD + (zc >> 1);
    const int zout = zr0 * g.RS + zc;
    const T fx = axis_factor<T>(P, zc & 1);
    const T flo = axis_factor<T>(P, 0), fhi = axis_factor<T>(P, 1);
    // its lines of a step's y pass (every column of the planes, one after
    // another) and x pass (core rows)
    int yo[LINES], xo[LINES], ym = 0, xm = 0;
#pragma unroll
    for (int i = 0; i < LINES; ++i) {
        const int q = t + i * INV_THREADS, py = q / g.EX, px = q / g.ty;
        yo[i] = py * PL + q - py * g.EX;
        xo[i] = px * PL + (HALO + q - px * g.ty) * g.RS;
        ym += q < 2 * STEP * g.EX;
        xm += q < 2 * STEP * g.ty;
    }
    // its load chunk: half lh, chunk column lm, rows lr, lr + lgroups, ...
    const int cph = g.HO / V, lgroups = INV_THREADS / (2 * cph);
    const bool loads = t < lgroups * 2 * cph;
    const int lh = (t % (2 * cph)) >= cph, lm = t % (2 * cph) - (lh ? cph : 0);
    const int lr = t / (2 * cph);
    bool vec_in = g.tx % (2 * V) == 0 && (g.X / 2) % V == 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) vec_in = vec_in && lines::aligned16(in.b[b]);
    // its store chunk: column sm, rows sr, sr + sgroups, ... of the core rows
    // of the planes, one after another
    const int cps = (g.tx + V - 1) / V, sgroups = INV_THREADS / cps;
    const bool stores = t < sgroups * cps;
    const int sm = t % cps, sr = t / cps;
    const bool vec_out = lines::aligned16(out) && g.X % V == 0 && g.tx % V == 0;

    for (int item = blockIdx.x; item < g.items(); item += gridDim.x) {
        const Seg sg(g, item);
        const int steps = (sg.n + STEP - 1) / STEP;
#pragma unroll
        for (int st = 0; st < RING - 1; ++st) {
            if (loads && st < steps)
                inv_load(in, ring + st * SLI, g, sg, st, lh, lm, lr, lgroups, vec_in);
            __pipeline_commit();
        }
        Walk w[NQ];
        for (int st = 0; st < steps; ++st) {
            __pipeline_wait_prior(RING - 2);
            __syncthreads();
            // into the slot of step st - 1, free since its z step
            const int sn = st + RING - 1;
            if (loads && sn < steps)
                inv_load(in, ring + (sn % RING) * SLI, g, sg, sn, lh, lm, lr, lgroups, vec_in);
            __pipeline_commit();  // possibly empty: keeps wait_prior exact
            const T* s = ring + (st % RING) * SLI;
            // output pair q = j - D of walk pair j = STEP st + p goes to pair p of ob
            const int q0 = STEP * st - Walk::D;
            const bool emit = q0 + STEP > WARM && q0 < sg.n - WARM;
            if (zact) {
#pragma unroll
                for (int p = 0; p < STEP; ++p) {
                    if (STEP * st + p >= sg.n) break;
#pragma unroll
                    for (int i = 0; i < NQ; ++i) {
                        const int r = zr0 + i * zg;
                        if (r < g.EY) {
                            const T fy = axis_factor<T>(P, r & 1);
                            const int a = 2 * p * PLI + zin + i * zg * g.RSI;
                            const int b = 2 * p * PL + zout + i * zg * g.RS;
                            T oe, oo;
                            w[i].push(scale_zyx(s[a], flo, fy, fx),
                                      scale_zyx(s[PLI + a], fhi, fy, fx), lift, oe, oo);
                            if (emit) {
                                ob[b] = oe;
                                ob[PL + b] = oo;
                            }
                        }
                    }
                }
            }
            if (!emit) continue;
            __syncthreads();
            {
                lines::ColLine<T> ln[LINES];
#pragma unroll
                for (int i = 0; i < LINES; ++i) ln[i] = {ob + yo[i], g.RS};
                zwalk::walk_lines<NST, SYM, SF, LINES>(ln, ym, g.EY / 2, P);
            }
            __syncthreads();
            {
                lines::RowLine<T> ln[LINES];
#pragma unroll
                for (int i = 0; i < LINES; ++i) ln[i] = {ob + xo[i]};
                zwalk::walk_lines<NST, SYM, SF, LINES>(ln, xm, g.EX / 2, P);
            }
            __syncthreads();
            if (!stores) continue;
            const int gc = sg.x0 + sm * V, nn = min(min(V, g.tx - sm * V), g.X - gc);
            for (int rr = sr; rr < 2 * STEP * g.ty; rr += sgroups) {
                const int pl = rr / g.ty, r = rr - pl * g.ty, gy = sg.y0 + r;
                const int q = q0 + (pl >> 1);
                if (q < WARM || q >= sg.n - WARM || gy >= g.Y || nn <= 0) continue;
                const T* src = ob + pl * PL + (HALO + r) * g.RS + HALO + sm * V;
                T* dst = out + ((size_t)(2 * (sg.k0 + q) + (pl & 1)) * g.Y + gy) * g.X + gc;
                if (vec_out && nn == V) {
                    VT v;
                    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
                    for (int u = 0; u < V; ++u) e[u] = src[u];
                    *reinterpret_cast<VT*>(dst) = v;
                } else {
                    for (int u = 0; u < nn; ++u) dst[u] = src[u];
                }
            }
        }
        __syncthreads();
    }
}

// ------------------------------------------------------------ launch

// Calls go(NST, SYM) for the lifting programs that reach these kernels
// (the wrappers' gate takes symmetric-step wavelets and Haar): floats with
// 1, 2 or 4 symmetric steps (interp53, CDF 5/3, CDF 9/7) or Haar's 2
// one-sided ones; int32 with 2 or 4 steps.  lines.cuh's dispatch would
// also build the float programs of 1 or 4 one-sided steps and int32's 1
// step, which none reaches.
template <typename T, typename Go>
int dispatch3(const LiftParams* P, Go go) {
    if constexpr (std::is_same<T, int>::value) {
        if (P->n == 2) return go(Int<2>{}, std::false_type{});
        if (P->n == 4) return go(Int<4>{}, std::false_type{});
    } else {
        bool sym = true;
        for (int s = 0; s < P->n; ++s)
            sym = sym && P->fwl[s] == P->fwr[s] && P->dwl[s] == P->dwr[s];
        if (sym && P->n == 1) return go(Int<1>{}, std::true_type{});
        if (sym && P->n == 2) return go(Int<2>{}, std::true_type{});
        if (sym && P->n == 4) return go(Int<4>{}, std::true_type{});
        if (!sym && P->n == 2) return go(Int<2>{}, std::false_type{});
    }
    return (int)cudaErrorInvalidValue;
}

// The windows, buffers and footprint of a tile (the rules of
// ops/fused3d.py's _footprint): every line of a pass and every chunk of
// the z walk has a thread, and the ring fits in shared memory.
template <typename T>
int geometry(bool inverse, int Z, int Y, int X, int tz, int ty, int tx, Geo* g,
             size_t* smem) {
    constexpr int V = Cfg<T>::V, ZX = Cfg<T>::ZX, NQ = Cfg<T>::NQ;
    if (tz <= 0 || ty <= 0 || tx <= 0 || ((tz | ty | tx) & 1))
        return (int)cudaErrorInvalidValue;
    Geo G{};
    G.Z = Z, G.Y = Y, G.X = X, G.tz = tz, G.ty = ty, G.tx = tx;
    G.EY = ty + 2 * HALO, G.EX = tx + 2 * HALO;
    // the forward's window rows 16-byte aligned (4 mod 8 words: 2-way bank
    // conflicts in its row walks, where lines::stride has none), the
    // inverse's plane pairs out of z in lines::stride's rows
    G.RS = inverse ? lines::stride(G.EX) : ((G.EX + 3) / 4 * 4) | 4;
    G.HO = (Cfg<T>::LEAD + G.EX / 2 + V - 1) / V * V, G.RSI = 2 * G.HO;
    const size_t planes = 2 * STEP;
    bool fits;
    if (!inverse) {
        fits = planes * G.EY <= LINES * FWD_THREADS && planes * tx <= LINES * FWD_THREADS
               && ty * ((tx + ZX - 1) / ZX) <= FWD_THREADS;
        *smem = sizeof(T) * RING * planes * G.EY * G.RS + 8 * RING;
    } else {
        fits = planes * G.EX <= LINES * INV_THREADS && planes * ty <= LINES * INV_THREADS
               && G.EX <= INV_THREADS
               && (G.EY + INV_THREADS / G.EX - 1) / (INV_THREADS / G.EX) <= NQ;
        *smem = sizeof(T) * (RING * planes * G.EY * G.RSI + planes * G.EY * G.RS);
    }
    if (!fits || *smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    G.nx = (X + tx - 1) / tx, G.ny = (Y + ty - 1) / ty, G.nz = (Z + tz - 1) / tz;
    *g = G;
    return 0;
}

// Set the kernel's shared memory, then the blocks that can be resident at
// once over the card, and the segment plan: as many segments per column as
// fill the resident blocks (at least one a column, at least tz planes each).
template <typename K>
int plan(K kernel, int threads, Geo* g, size_t smem) {
    int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem);
    if (err) return err;
    int per_sm = 0, dev = 0, sms = 0;
    if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                                  smem)))
        return err;
    if ((err = (int)cudaGetDevice(&dev))) return err;
    if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
        return err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int nseg = std::max(1, std::min(g->nz, per_sm * sms / (g->nx * g->ny)));
    g->sps = (g->nz + nseg - 1) / nseg;
    g->nseg = (g->nz + g->sps - 1) / g->sps;
    return 0;
}

// What a launch of ``kernel`` runs: out[0] its registers, out[1] its
// blocks an SM (the occupancy query at its shared memory), out[2] its
// shared memory in bytes, out[3] its threads a block.
template <typename K>
int query(K kernel, int threads, size_t smem, int* out) {
    cudaFuncAttributes a;
    int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
    if (!e) e = (int)cudaFuncGetAttributes(&a, kernel);
    if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, threads, smem);
    out[0] = e ? 0 : a.numRegs;
    out[2] = (int)smem;
    out[3] = threads;
    return e;
}

}  // namespace volwalk
