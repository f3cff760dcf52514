// The lifting core of the hand-written 2-D kernels (fused2l.cu: B2, B5;
// deep.cu: B3, B6; level.cu: B1, B4; streamed.cu: B7-B12): lines of a
// window in shared memory, each walked by one thread with every lifting
// step pipelined in registers, the scale folded into a read or a store,
// and the dispatch of a launcher onto the compile-time step count and
// symmetry.  The walks do lift_one's arithmetic in the plain versions'
// order, so every kernel on them equals its plain version bit for bit.
#pragma once

#include <cstdint>
#include <type_traits>

#include "lifting.cuh"

// Lines of a window in shared memory, walked by one thread each with every
// lifting step pipelined in registers: the lifting core of B1-B12.
namespace lines {

// 16 bytes of T, and one (even, odd) sample pair.
template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<int> { using type = int4; };
template <> struct Vec16<double> { using type = double2; };
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<int> { using type = int2; };
template <> struct Pair<double> { using type = double2; };

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Row stride of a window n samples wide (n even): n or n + 2, whichever is
// 2 mod 4, so that 16 lanes walking 16 rows read 16 distinct bank pairs.
__host__ __device__ __forceinline__ int stride(int n) { return n % 4 ? n : n + 2; }

// A window line of L (even, odd) sample pairs: a row (pairs adjacent) or
// a column (samples RS apart).
template <typename T>
struct RowLine {
    using value_type = T;
    T* p;
    __device__ __forceinline__ void get(int k, T& e, T& o) const {
        const typename Pair<T>::type v = reinterpret_cast<const typename Pair<T>::type*>(p)[k];
        e = v.x;
        o = v.y;
    }
    __device__ __forceinline__ void put(int k, T e, T o) const {
        reinterpret_cast<typename Pair<T>::type*>(p)[k] = {e, o};
    }
};
template <typename T>
struct ColLine {
    using value_type = T;
    T* p;
    int rs;
    __device__ __forceinline__ void get(int k, T& e, T& o) const {
        e = p[2 * k * rs];
        o = p[(2 * k + 1) * rs];
    }
    __device__ __forceinline__ void put(int k, T e, T o) const {
        p[2 * k * rs] = e;
        p[(2 * k + 1) * rs] = o;
    }
};

// The pairs of a walk that belong to the neighbouring segments of its line
// ([f, a) and [b, e), at most two each): read before a barrier, since
// their owners write them back.
template <typename T>
struct Warm {
    T pe[2], po[2], qe[2], qo[2];
    template <typename Line>
    __device__ __forceinline__ void read(const Line& line, int f, int a, int b, int e) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            if (f + i < a) line.get(f + i, pe[i], po[i]);
            if (b + i < e) line.get(b + i, qe[i], qo[i]);
        }
    }
};

// Lifting step J of P on one sample.  SYM: every step has wl == wr, so the
// update is lift_one's t + w * (l + r) with no branch on the weights.
template <typename T, bool SYM>
struct Lifter {
    const LiftParams& P;
    template <int J>
    __device__ __forceinline__ T step(T t, T l, T r) const {
        if constexpr (SYM && std::is_same<T, float>::value)
            return __fadd_rn(t, __fmul_rn(P.fwl[J], __fadd_rn(l, r)));
        else if constexpr (SYM && std::is_same<T, double>::value)
            return __dadd_rn(t, __dmul_rn(P.dwl[J], __dadd_rn(l, r)));
        else
            return lift_one(t, l, r, P, J);
    }
};

// Every lifting step of P along pairs [f, e) of a line, walked once by one
// thread with the steps pipelined in registers: NST (1, 2 or 4) steps
// alternating d, s from d (the forward's), or, SF, alternating s, d from s
// (the inverse's; NST 2 or 4).  Each step updates a sample from the values
// its neighbours have after the step before.  Reading pair k, from d: step
// 2m (d) updates odd 2(k-1-m)+1 and step 2m+1 (s) even 2(k-1-m); from s:
// step 2m (s) updates even 2(k-m) and step 2m+1 (d) odd 2(k-1-m)+1.  Pair
// k - D (D = ceil(NST/2)) is then final and is written back in place if it
// lies in [a, b).  The positions of each step are those of the plain
// versions' pass on [f, e) (ops/fused.py _lift_axis): odd 2q+1 for q <=
// e - 2, even 2q for q >= f + 1.  On a whole line (f = a = 0, e = b = L)
// this is that pass; on a segment, the
// staleness of the cut ends (two pairs for four steps) stays in the
// warm-up pairs.
template <int NST, bool SYM, bool SF = false, typename Line,
          typename T = typename Line::value_type>
__device__ __forceinline__ void walk(const Line& line, int f, int e, int a, int b,
                                     const Warm<T>& wm, const LiftParams& P) {
    static_assert(!SF || NST > 1, "an s-first walk has an s and a d step");
    constexpr int D = (NST + 1) / 2;
    const Lifter<T, SYM> lift{P};
    // e0..e2 = even of pairs k, k-1, k-2; o0..o3 = odd of pairs k .. k-3
    T e0 = T(0), e1 = T(0), e2 = T(0), o0 = T(0), o1 = T(0), o2 = T(0), o3 = T(0);
    // one step of the walk at pair k; ALL: every step and the write-back
    // are known to apply (the steady middle of the walk)
    auto iter = [&](int k, auto all) {
        constexpr bool A = decltype(all)::value;
        if constexpr (SF) {
            if (A || (k >= f + 1 && k <= e - 1)) e0 = lift.template step<0>(e0, o1, o0);
            if (A || (k - 1 >= f && k - 1 <= e - 2)) o1 = lift.template step<1>(o1, e1, e0);
            if constexpr (NST > 2) {
                if (A || (k - 1 >= f + 1 && k - 1 <= e - 1))
                    e1 = lift.template step<2>(e1, o2, o1);
                if (A || (k - 2 >= f && k - 2 <= e - 2)) o2 = lift.template step<3>(o2, e2, e1);
            }
        } else {
            if (A || (k - 1 >= f && k - 1 <= e - 2)) o1 = lift.template step<0>(o1, e1, e0);
            if constexpr (NST > 1)
                if (A || (k - 1 >= f + 1 && k - 1 <= e - 1))
                    e1 = lift.template step<1>(e1, o2, o1);
            if constexpr (NST > 2)
                if (A || (k - 2 >= f && k - 2 <= e - 2)) o2 = lift.template step<2>(o2, e2, e1);
            if constexpr (NST > 3)
                if (A || (k - 2 >= f + 1 && k - 2 <= e - 1))
                    e2 = lift.template step<3>(e2, o3, o2);
        }
        if (A || (k - D >= a && k - D < b)) {
            if constexpr (D == 1) line.put(k - 1, e1, o1);
            else line.put(k - 2, e2, o2);
        }
        o3 = o2;
        o2 = o1;
        o1 = o0;
        e2 = e1;
        e1 = e0;
    };
    auto read = [&](int k) {
        if (k < a) {
            e0 = k == f ? wm.pe[0] : wm.pe[1];
            o0 = k == f ? wm.po[0] : wm.po[1];
        } else if (k >= b) {
            e0 = k == b ? wm.qe[0] : wm.qe[1];
            o0 = k == b ? wm.qo[0] : wm.qo[1];
        } else {
            line.get(k, e0, o0);
        }
    };
    // [f, m): the head, with its checks; [m, b): every step applies and pair
    // k - D is written, the next pair read ahead; [max(m, b), e + D): the tail
    const int m = min(max(f + 3, a + D), e + D);
    for (int k = f; k < m; ++k) {
        if (k < e) read(k);
        iter(k, std::false_type{});
    }
    T ne = T(0), no = T(0);
    if (m < b) line.get(m, ne, no);
    for (int k = m; k < b; ++k) {
        e0 = ne;
        o0 = no;
        if (k + 1 < b) line.get(k + 1, ne, no);
        iter(k, std::true_type{});
    }
    for (int k = max(m, b); k < e + D; ++k) {
        if (k < e) read(k);
        iter(k, std::false_type{});
    }
}

// One lifting pass over the n lines of L pairs of a window: line t % n,
// cut into S segments of at least MIN_SEG pairs so that n * S threads walk
// at once (n <= blockDim.x).
constexpr int MIN_SEG = 12;

template <int NST, bool SYM, bool SF = false, typename Line,
          typename T = typename Line::value_type>
__device__ __forceinline__ void pass(const Line& line, int n, int L, const LiftParams& P) {
    const int S = max(1, min((int)blockDim.x / n, L / MIN_SEG));
    const int seg = threadIdx.x / n;
    const int a = seg * L / S, b = (seg + 1) * L / S;
    const int f = max(a - 2, 0), e = min(b + 2, L);
    Warm<T> wm;
    if (seg < S) wm.read(line, f, a, b, e);
    __syncthreads();
    if (seg < S) walk<NST, SYM, SF>(line, f, e, a, b, wm, P);
    __syncthreads();
}

// Scale factor i of P applied to v, where P has a scale.
template <typename T>
__device__ __forceinline__ T scaled(T v, const LiftParams& P, int i) {
    return P.has_scale ? scale_one(v, P, i) : v;
}

// n (<= V) samples two apart at ``src`` to ``dst``, each times scale
// factor si: one 16-byte store when ``vec`` and n == V.
template <typename T>
__device__ __forceinline__ void put(T* dst, const T* src, int n, bool vec,
                                    const LiftParams& P, int si) {
    constexpr int V = 16 / sizeof(T);
    using VT = typename Vec16<T>::type;
    if (vec && n == V) {
        VT v;
        T* e = reinterpret_cast<T*>(&v);
#pragma unroll
        for (int u = 0; u < V; ++u) e[u] = scaled(src[2 * u], P, si);
        *reinterpret_cast<VT*>(dst) = v;
    } else {
        for (int u = 0; u < n; ++u) dst[u] = scaled(src[2 * u], P, si);
    }
}

// Scale factor i of P (0..3: LL, HL, LH, HH) as a multiplier in T: 1
// where P has no scale, and for the integer types, which have none.
template <typename T>
__device__ __forceinline__ T factor(const LiftParams& P, int i) {
    if constexpr (std::is_same<T, float>::value) return P.has_scale ? P.scale[i] : 1.0f;
    else if constexpr (std::is_same<T, double>::value) return P.has_scale ? P.dscale[i] : 1.0;
    else return T(1);
}
template <typename T>
__device__ __forceinline__ T mul(T v, T s) {
    if constexpr (std::is_same<T, float>::value) return __fmul_rn(v, s);
    else if constexpr (std::is_same<T, double>::value) return __dmul_rn(v, s);
    else return v;
}

// A window column whose samples are multiplied by their parity's scale
// factor as the walk reads them (``se`` at even rows, ``so`` at odd): the
// inverse's scale, one multiply before any lifting step, so the bits are
// those of a separate scale pass.  x * 1 is x, so an unscaled wavelet
// takes factors of 1.
template <typename T>
struct ScaledColLine {
    using value_type = T;
    T* p;
    int rs;
    T se, so;
    __device__ __forceinline__ void get(int k, T& e, T& o) const {
        e = mul(p[2 * k * rs], se);
        o = mul(p[(2 * k + 1) * rs], so);
    }
    __device__ __forceinline__ void put(int k, T e, T o) const {
        p[2 * k * rs] = e;
        p[(2 * k + 1) * rs] = o;
    }
};

// Every lifting step along the rows, then the columns, of a rows x cols
// window (row stride RS; both even and at most blockDim.x).
template <int NST, bool SYM, typename T>
__device__ __forceinline__ void lift_fwd(T* s, int rows, int cols, int RS,
                                         const LiftParams& P) {
    const int r = threadIdx.x % rows, c = threadIdx.x % cols;
    pass<NST, SYM>(RowLine<T>{s + r * RS}, rows, cols / 2, P);
    pass<NST, SYM>(ColLine<T>{s + c, RS}, cols, rows / 2, P);
}
template <int NST, bool SYM, typename T>
__device__ __forceinline__ void lift_fwd(T* s, int n, int RS, const LiftParams& P) {
    lift_fwd<NST, SYM>(s, n, n, RS, P);
}

// Scale, then every lifting step along the columns, then the rows, of a
// rows x cols window (row stride RS): the inverse's steps alternate s, d
// from s, or are one d step.
template <int NST, bool SYM, typename T>
__device__ __forceinline__ void lift_inv(T* s, int rows, int cols, int RS,
                                         const LiftParams& P) {
    constexpr bool SF = NST > 1;
    const int r = threadIdx.x % rows, c = threadIdx.x % cols;
    const ScaledColLine<T> col{s + c, RS, factor<T>(P, c & 1), factor<T>(P, 2 | (c & 1))};
    pass<NST, SYM, SF>(col, cols, rows / 2, P);
    pass<NST, SYM, SF>(RowLine<T>{s + r * RS}, rows, cols / 2, P);
}
template <int NST, bool SYM, typename T>
__device__ __forceinline__ void lift_inv(T* s, int n, int RS, const LiftParams& P) {
    lift_inv<NST, SYM>(s, n, n, RS, P);
}

}  // namespace lines

template <int N>
using Int = std::integral_constant<int, N>;

// Calls go(TILE, NST, SYM), each a std::integral_constant, for ``tile`` and
// the steps of P: TILE 64 (the default tile, at compile time) or 0 (read
// at run time); NST 1, 2 or 4; SYM when every step is symmetric (floats
// only, checked here on the host).
template <typename T, typename Go>
int dispatch(int tile, const LiftParams* P, Go go) {
    bool sym = !std::is_same<T, int>::value;
    for (int s = 0; s < P->n; ++s) sym = sym && P->fwl[s] == P->fwr[s] && P->dwl[s] == P->dwr[s];
    auto with_tile = [&](auto nst, auto sy) {
        if (tile == 64) return go(Int<64>{}, nst, sy);
        return go(Int<0>{}, nst, sy);
    };
    auto with_sym = [&](auto nst) {
        if constexpr (!std::is_same<T, int>::value)
            if (sym) return with_tile(nst, std::true_type{});
        return with_tile(nst, std::false_type{});
    };
    switch (P->n) {
        case 1: return with_sym(Int<1>{});
        case 2: return with_sym(Int<2>{});
        case 4: return with_sym(Int<4>{});
        default: return (int)cudaErrorInvalidValue;
    }
}
