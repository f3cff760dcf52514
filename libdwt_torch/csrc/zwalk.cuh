// Line walks for the streamed volume kernels (streamed3d.cu: B16, B17):
// lines.cuh's register pipeline as a walk that resumes, one (even, odd)
// sample pair per call, so that z can be walked across block barriers
// (each thread keeps the state of the (y, x) positions it owns in
// registers from one plane pair of a column to the next), and a whole-line
// pass over several lines a thread at once, for the x and y lifts.
//
// lines::walk skips the steps of a line's end pairs, whose neighbours lie
// outside it.  Here every step runs on every pair: the ends of a walk are
// warm-up pairs (two a side, the halo of four samples of lines.cuh), whose
// values may be stale or come from the zeros the state starts with, and no
// step that reaches a pair between them reads one.  So the pairs between
// the warm-ups are a whole-window pass's values bit for bit.
#pragma once

#include "lines.cuh"

namespace zwalk {

// Pairs a walk reads past its first and last output pair.
constexpr int WARM = 2;

// The carried state of one position's walk, and its steps: NST (1, 2 or
// 4) steps alternating d, s from d (the forward's) or, SF, s, d from s
// (the inverse's), in lines::walk's order and on its lifter.
template <int NST, bool SYM, bool SF, typename T>
struct Walk {
    static_assert(!SF || NST > 1, "an s-first walk has an s and a d step");
    // pairs between the pair pushed and the pair that comes out final
    static constexpr int D = (NST + 1) / 2;
    // e1, e2 = even of the last two pairs pushed; o1..o3 = odd of the last three
    T e1 = T(0), e2 = T(0), o1 = T(0), o2 = T(0), o3 = T(0);

    // Push pair k (e0, o0); (oe, oo) <- pair k - D, final once k - D is
    // past the first WARM pairs of the walk.
    __device__ __forceinline__ void push(T e0, T o0, const lines::Lifter<T, SYM>& lift,
                                         T& oe, T& oo) {
        if constexpr (SF) {
            e0 = lift.template step<0>(e0, o1, o0);
            o1 = lift.template step<1>(o1, e1, e0);
            if constexpr (NST > 2) {
                e1 = lift.template step<2>(e1, o2, o1);
                o2 = lift.template step<3>(o2, e2, e1);
            }
        } else {
            o1 = lift.template step<0>(o1, e1, e0);
            if constexpr (NST > 1) e1 = lift.template step<1>(e1, o2, o1);
            if constexpr (NST > 2) o2 = lift.template step<2>(o2, e2, e1);
            if constexpr (NST > 3) e2 = lift.template step<3>(e2, o3, o2);
        }
        if constexpr (D == 1) {
            oe = e1;
            oo = o1;
        } else {
            oe = e2;
            oo = o2;
        }
        o3 = o2;
        o2 = o1;
        o1 = o0;
        e2 = e1;
        e1 = e0;
    }
};

// Every lifting step along M lines of L pairs each (lines.cuh's RowLine,
// ColLine), walked whole by this thread side by side: the steps of the M
// lines interleave, so the thread waits for one line's chain of steps, not
// M.  Pairs [WARM, L - WARM) are written back, final; the WARM pairs of
// each end are read and left as they were (nothing downstream of a window
// reads them).
template <int NST, bool SYM, bool SF, int M, typename Line,
          typename T = typename Line::value_type>
__device__ __forceinline__ void walk_m(const Line* ln, int L, const LiftParams& P) {
    using W = Walk<NST, SYM, SF, T>;
    const lines::Lifter<T, SYM> lift{P};
    W w[M];
    T e[M], o[M];
#pragma unroll
    for (int i = 0; i < M; ++i) ln[i].get(0, e[i], o[i]);
    for (int k = 0; k < L; ++k) {
        T ne[M], no[M];
#pragma unroll
        for (int i = 0; i < M; ++i) {
            ne[i] = no[i] = T(0);
            if (k + 1 < L) ln[i].get(k + 1, ne[i], no[i]);
        }
        const int q = k - W::D;
        const bool put = q >= WARM && q < L - WARM;
#pragma unroll
        for (int i = 0; i < M; ++i) {
            T oe, oo;
            w[i].push(e[i], o[i], lift, oe, oo);
            if (put) ln[i].put(q, oe, oo);
            e[i] = ne[i];
            o[i] = no[i];
        }
    }
}

// The first m (<= M) of a thread's lines ln[0..M), walked side by side.
template <int NST, bool SYM, bool SF, int M, typename Line>
__device__ __forceinline__ void walk_lines(const Line* ln, int m, int L, const LiftParams& P) {
    if (m >= M) {
        walk_m<NST, SYM, SF, M>(ln, L, P);
    } else if constexpr (M > 1) {
        walk_lines<NST, SYM, SF, M - 1>(ln, m, L, P);
    }
}

}  // namespace zwalk
