#!/usr/bin/env python3
"""Where a hand-written 2-D kernel spends its time on the GPU: B1, B4 (the
one-level kernels of csrc/level.cu), B2, B5 (the two-level kernels of
csrc/fused2l.cu), B3, B6 (the deep tails of csrc/deep.cu), B7, B9 (the
single streamed levels of csrc/streamed.cu, one strip a block), B8, B10
(the two-level strip kernels of csrc/streamed.cu), B13F, B13I (the
banded tensor-core body B13 in the two-level strips of csrc/streamed.cu,
forward as B8-mxu runs it, inverse as B10-mxu), and the volume kernels B14,
B15 (csrc/fused3d.cu) and B16, B17 (csrc/streamed3d.cu); B18, B18S (the
halo push of csrc/remote_halo.cu at the sharded path's level-1 and level-5
shapes).

    python3 tools/kernel_phases.py B3 [B6 B1 B4 B2 B5 B7 B9 B8 B10 B13F B13I B14 B15 B16 B17
                                      B18 B18S]
                                   [--tile N] [--tile3 TZ,TY,TX] [--reps 200] [--seed 0]

For each kernel named, on the main path's shapes (2144x4096 float32 CDF
9/7: B1, B2 and B7 on the frame, B4 and B9 on its one-level bands, B5 on
its two-level bands, B3 on its 536x1024 LL2 for three levels, B6 on those
three levels' bands; B7/B9 at the square strip ``--tile``, 64 by default):

1. Times the kernel with CUDA events over back-to-back launches made
   straight through ctypes into preallocated outputs, so that the
   wrapper's host cost is left out; checks the outputs against the plain
   version (exact; B13 within 2e-5).
2. Copies the kernel's source into ``build/kernel_phases/<kernel>/``,
   adds a block barrier and a ``clock64()`` stamp after each phase of the
   kernel function (the phases are KERNELS[...]["phases"]: a line of the
   kernel after which each ends), builds it with the port's nvcc flags,
   runs it on the same inputs and checks it again.  Prints each phase's
   mean and median cycles per block (per level for B3/B6, whose phases
   repeat once a level: load, lift, stores, grid sync), a block's
   lifetime, the most blocks resident on an SM at once, and (B1, B3, B4,
   B6, B7, B9, B8, B10, B13) the blocks an SM that the occupancy query
   allows the stamped kernel at its shared memory.
3. B8, B10 (``--tile``: their square strip, 64 by default) and B13
   (``--tile`` is its square strip, by default the tree's): the phases
   repeat once a strip and once a pass, so each block adds up its cycles
   per phase over its whole walk (a barrier before each stamp, so a
   phase's cycles include the wait for the block's slowest warp).  Its
   markers sit in several functions (the strip walk, the pass, the window
   helpers); a kernel whose source changed is found by its first variant
   whose markers are all there, so the same script measures a parent's
   body from its ``git archive`` (run this file from that tree's root).
   Prints the registers of each banded instantiation from the build's
   ``ptxas -v`` log.
4. B14, B15, B16, B17 (``--tile3``: the CUDA tile, by default the tree's)
   on the 64x512x512 float32 volume and its level-1 bands: a block walks
   its column segment down z (csrc/volwalk.cuh), so each phase's cycles are
   added up over the walk as for B13.  The phases are a step's load wait
   (B14: the tensor-box wait and the edge fix-up) and the next step's
   load issue, then its x lift, y lift, and the z step with its stores
   (forward), or its z step, y lift, x lift and stores (inverse).  A
   parent's kernels are found as later variants: B16/B17's walk while it
   lived in streamed3d.cu, and the 3-D tile bodies of tiles3.cuh that the
   walk replaced: a tile's load, the x, y and z lifts, and its stores.
5. B18 (8 blocks of 256x4096 float32, halo 4: the forward's level 1 on the
   sharded 2048x4096 path) and B18S (8 of 16x256, halo 4: its level 5)
   launch ``halo_kernel``, the push protocol of one cooperative launch for
   a line's shards with flags between them, through ``halo_extend_rows``
   with a new epoch each launch.  Each shard's first block stamps its
   phases: the "entered" wait, the pushes and mirror rows, the system
   fence, the "arrived" signal, its part of the centre copy and the
   "arrived" wait (the waits and the signal stamped by thread 0 alone,
   which runs them).  Beside it: the kernel's device time (CUPTI), and an
   empty kernel of the same grid launched cooperatively and ordinarily.

A kernel is data here: its source, kernel function, entry point, phase
markers (each after or before one line of a function), the variable that
counts its rounds, and a function that makes its inputs, outputs, plain
results and launch.  Needs one CUDA card and nvcc; prints the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

H, W, WV, DEEP_LEVELS = 2144, 4096, "cdf97", 3
VOLUME = (64, 512, 512)
MAX_BLOCKS = 1 << 14
#: threads a block of the 2-D kernels here (THREADS in their sources); a
#: spec's "threads" overrides it
THREADS = 256

KERNELS = {
    "B1": {"source": "level.cu", "kernel": "fwd1_kernel", "entry": "dwt_fwd1",
           "tile": 32, "round": None, "instance": "fwd1_kernel<float, 4, true, 0>",
           "phases": (("__pipeline_wait_prior(0);", "load"),
                      ("lines::lift_fwd<NST, SYM>(", "lift"),
                      ("onelevel::fwd_store(", "stores"))},
    "B4": {"source": "level.cu", "kernel": "inv1_kernel", "entry": "dwt_inv1",
           "tile": 32, "round": None, "instance": "inv1_kernel<float, 4, true, 0>",
           "phases": (("__pipeline_wait_prior(0);", "load"),
                      ("lines::lift_inv<NST, SYM>(", "lift"),
                      ("onelevel::inv_store(", "stores"))},
    "B2": {"source": "fused2l.cu", "kernel": "fwd2_kernel", "entry": "dwt_fwd2",
           "tile": 64, "round": None,
           "phases": (("__pipeline_wait_prior(0);", "load"),
                      ("lines::lift_fwd<NST, SYM>(s1", "level-1 lift"),
                      ("fwd2::ll1_window(", "level-1 stores, LL1"),
                      ("lines::lift_fwd<NST, SYM>(s2", "level-2 lift"),
                      ("b2, tile / 4, tile / 4, y0 / 4, x0 / 4, h / 4, w / 4, P);",
                       "level-2 stores"))},
    "B5": {"source": "fused2l.cu", "kernel": "inv2_kernel", "entry": "dwt_inv2",
           "tile": 64, "round": None,
           "phases": (("__pipeline_wait_prior(1);", "level-2 load"),
                      ("lines::lift_inv<NST, SYM>(s2", "level-2 lift"),
                      ("inv2::ll1_window(", "LL1 copy"),
                      ("__pipeline_wait_prior(0);", "level-1 load wait"),
                      ("lines::lift_inv<NST, SYM>(s1", "level-1 lift"),
                      ("inv2::store(", "stores"))},
    "B3": {"source": "deep.cu", "kernel": "deep_fwd_kernel", "entry": "dwt_deep_fwd",
           "body": ("deep.cuh", "fwd_levels"),
           "tile": 32, "round": "k", "instance": "deep_fwd_kernel<float, 4, true>",
           "phases": (("__pipeline_wait_prior(0);", "load"),
                      ("lines::lift_fwd<NST, SYM>(", "lift"),
                      ("fwd_store(s, RS, L, y0, x0, ", "stores"),
                      ("if (k + 1 < d.n) grid.sync();", "grid sync"))},
    "B6": {"source": "deep.cu", "kernel": "deep_inv_kernel", "entry": "dwt_deep_inv",
           "body": ("deep.cuh", "inv_levels"),
           "tile": 32, "round": "k", "instance": "deep_inv_kernel<float, 4, true>",
           "phases": (("__pipeline_wait_prior(0);", "load"),
                      ("lines::lift_inv<NST, SYM>(", "lift"),
                      ("inv_store(s, RS, L, y0, x0", "stores"),
                      ("if (k + 1 < d.n) grid.sync();", "grid sync"))},
}


def _pad16(n):
    return -(-n // 16) * 16


def _a16(b):
    return -(-b // 16) * 16


def _parts_smem(pe, mats):
    """The first banded body's: three bf16 data parts of ``pe`` elements
    and the matrices' shared copy after the float windows."""
    return 3 * _a16(2 * pe) + 2 * mats.elems


def _part_elems(ey, ex):
    return max(_pad16(ex) * (_pad16(ey) + 8), _pad16(ey) * (_pad16(ex) + 8))


def _stride(n):
    """banded::stride: the least row stride >= n that is 8 mod 16."""
    return n + ((8 - n) & 15)


# B13, the banded body (a tuple of variants: a parent's body would be
# another).  Phases end after (or, "before", just before) one line of the
# named functions; a phase's cycles are added up per block.
B13_VARIANTS = {
    "B13F": (
        {"kernel": "sdeep_fwd_mxu", "instance": "sdeep_fwd_mxu<4, true>",
         "registers": ("sdeep_fwd_mxu",),
         "regions": (("streamed.cu", "fwd2_mxu_strips", "__device__ __forceinline__ void"),),
         "phases": (("__pipeline_wait_prior(0);", "level-2 stores, next strip's wait"),
                    ("banded::lift_fwd(s1, RS, EY, EX, M.m[0], M.m[1], M.frags);",
                     "level-1 passes"),
                    ("banded::lift_fwd(s2, RS1, E1Y, E1X, M.m[2], M.m[3], M.frags);",
                     "level-1 stores, LL1, next load", "before"),
                    ("banded::lift_fwd(s2, RS1, E1Y, E1X, M.m[2], M.m[3], M.frags);",
                     "level-2 passes")),
         "smem": lambda ty, tx, mats: 4 * ((ty + 32) * _stride(tx + 24)
                                           + (ty // 2 + 8) * _stride(tx // 2 + 8))},
    ),
    "B13I": (
        {"kernel": "sdeep_inv_mxu", "instance": "sdeep_inv_mxu<4, true>",
         "registers": ("sdeep_inv_mxu",),
         "regions": (("streamed.cu", "inv2_mxu_strips", "__device__ __forceinline__ void"),),
         "phases": (("__pipeline_wait_prior(1);", "stores, next load, wait"),
                    ("banded::lift_inv(s2, RS2, E2Y, E2X, M.m[0], M.m[1], M.frags);",
                     "level-2 passes"),
                    ("__pipeline_wait_prior(0);", "LL1 window, level-1 wait"),
                    ("banded::lift_inv(s1, RS1, E1Y, E1X, M.m[2], M.m[3], M.frags);",
                     "level-1 passes")),
         "smem": lambda ty, tx, mats: 4 * ((ty // 2 + 16) * _stride(tx // 2 + 16)
                                           + (ty + 8) * _stride(tx + 8))},
    ),
}
for _kid, _entry in (("B13F", "dwt_sfwd2_mxu"), ("B13I", "dwt_sinv2_mxu")):
    KERNELS[_kid] = {"source": "streamed.cu", "entry": _entry, "tile": 0, "round": None,
                     "acc": True, "tol": 2e-5, "variants": B13_VARIANTS[_kid]}


def _lines_stride(n):
    """lines::stride: n or n + 2, whichever is 2 mod 4."""
    return n if n % 4 else n + 2


# B8, B10: the strip phase of B11/B12 alone (sstrip_*_lines), a block's
# phases added up over its strip walk as for B13.
KERNELS["B8"] = {
    "source": "streamed.cu", "kernel": "sstrip_fwd_lines", "entry": "dwt_sfwd2", "tile": 64,
    "round": None, "acc": True, "instance": "sstrip_fwd_lines<float, 64, 4, true>",
    "registers": ("sstrip_fwd_linesIfLi64ELi4ELb1E",),
    "regions": (("streamed.cu", "fwd2_line_strips", "template <"),),
    "phases": (("__pipeline_wait_prior(0);", "level-2 stores (strip before), load wait"),
               ("lines::lift_fwd<NST, SYM>(s1, EY, EX, RS, P);", "level-1 lift"),
               ("fwd2::ll1_window(s1, RS, s2, RS1, g.h, g.w, y0, x0, E1Y, E1X, P);",
                "level-1 stores, LL1"),
               ("lines::lift_fwd<NST, SYM>(s2, E1Y, E1X, RS1, P);",
                "next load issue, level-2 lift")),
    "smem": lambda ty, tx, mats: 4 * ((ty + 24) * _lines_stride(tx + 24)
                                      + (ty // 2 + 8) * _lines_stride(tx // 2 + 8))}
KERNELS["B10"] = {
    "source": "streamed.cu", "kernel": "sstrip_inv_lines", "entry": "dwt_sinv2", "tile": 64,
    "round": None, "acc": True, "instance": "sstrip_inv_lines<float, 64, 4, true>",
    "registers": ("sstrip_inv_linesIfLi64ELi4ELb1E",),
    "regions": (("streamed.cu", "inv2_line_strips", "template <"),),
    "phases": (("__pipeline_wait_prior(1);", "next load issue, level-2 wait"),
               ("lines::lift_inv<NST, SYM>(s2, E2Y, E2X, RS2, P);", "level-2 lift"),
               ("inv2::ll1_window(s2, RS2, s1, RS1,", "LL1 window"),
               ("__pipeline_wait_prior(0);", "level-1 wait"),
               ("lines::lift_inv<NST, SYM>(s1, E1Y, E1X, RS1, P);", "level-1 lift"),
               ("inv2::store(s1, RS1, b.out, g.h, g.w, y0, x0, ty, tx);", "stores")),
    "smem": lambda ty, tx, mats: 4 * ((ty // 2 + 16) * _lines_stride(tx // 2 + 16)
                                      + (ty + 8) * _lines_stride(tx + 8))}


# B7, B9: one ty x tx strip a block on onelevel.cuh's body (``tile`` is the
# square strip), one round of phases a block as for B1/B4.
for _kid, _kern, _entry, _lift, _store in (
        ("B7", "sfwd1_lines", "dwt_sfwd1", "lines::lift_fwd<NST, SYM>(", "onelevel::fwd_store("),
        ("B9", "sinv1_lines", "dwt_sinv1", "lines::lift_inv<NST, SYM>(", "onelevel::inv_store(")):
    KERNELS[_kid] = {
        "source": "streamed.cu", "kernel": _kern, "entry": _entry, "tile": 64, "round": None,
        "instance": f"{_kern}<float, 64, 4, true, 0>",
        "phases": (("__pipeline_wait_prior(0);", "load"), (_lift, "lift"), (_store, "stores")),
        "smem": lambda ty, tx, mats: 4 * (ty + 8) * _lines_stride(tx + 8)}


def _tile3_smem(tile):
    """A parent's streamed volume kernel: two tiles of (tz+8)(ty+8)(tx+8)
    float32 samples."""
    return 4 * 2 * (tile[0] + 8) * (tile[1] + 8) * (tile[2] + 8)


def _stream3_smem(inverse):
    def smem(tile):
        from libdwt_torch.ops import streamed3d as S3

        return S3._footprint(tile, 4, inverse)[0]
    return smem


# The column walk of csrc/volwalk.cuh (since the fused and streamed volume
# kernels share it): forward (B14, B16) phases with each feed's wait (B14 on
# boxes: the box wait and the edge fix-up) and next issue, and inverse (B15,
# B17) phases, one feed.
_WALK_FWD = (("volwalk.cuh", "fwd_walk", "template <"),)
_WALK_INV = (("volwalk.cuh", "inv_walk", "template <"),)
_FWAIT = "feed.wait(sg, st, sl, s);"
_FISSUE = "feed.issue(sg, sn, steps, ring + (sn % RING) * SL, sn % RING);"
_XF = "walk_lines<NST, SYM, false, LINES>(ln, xm, g.EX / 2, P);"
_YF = "walk_lines<NST, SYM, false, LINES>(ln, ym, g.EY / 2, P);"
_WAIT = "__pipeline_wait_prior(RING - 2);"
_TOP = "fence_async();  // the z step of st - 1 before the copies into its slot"
_COMMIT = "__pipeline_commit();  // possibly empty: keeps wait_prior exact"
_INV_PHASES = ((_WAIT, "stores (step before)", "before"),
               (_WAIT, "load wait"),
               (_COMMIT, "next load issue"),
               ("if (!emit) continue;", "z step", "before"),
               ("walk_lines<NST, SYM, SF, LINES>(ln, ym, g.EY / 2, P);", "y lift"),
               ("walk_lines<NST, SYM, SF, LINES>(ln, xm, g.EX / 2, P);", "x lift"))


def _fwd_walk_phases(wait):
    return ((_FWAIT, "z step, stores (step before)", "before"), (_FWAIT, wait),
            (_FISSUE, "next load issue"), (_XF, "x lift"), (_YF, "y lift"))


# B16, B17 by variant: the column walk of volwalk.cuh, the same walk in
# streamed3d.cu before it moved to the header, then the 3-D tile body of
# tiles3.cuh that it replaced.
B3D_VARIANTS = {
    "B16": (
        {"kernel": "sfwd3_kernel", "instance": "sfwd3_kernel<float, 4, true>", "threads": 128,
         "registers": ("sfwd3_kernelIfLi4ELb1E",), "regions": _WALK_FWD,
         "phases": _fwd_walk_phases("load wait"), "smem3": _stream3_smem(False)},
        {"kernel": "sfwd3_kernel", "instance": "sfwd3_kernel<float, 4, true>", "threads": 128,
         "registers": ("sfwd3_kernelIfLi4ELb1E",),
         "phases": ((_TOP, "z step, stores (step before)", "before"),
                    (_WAIT, "load wait"),
                    (_COMMIT, "next load issue"),
                    ("walk_lines<NST, SYM, false, LINES>(ln, xm, g.EX / 2, P);", "x lift"),
                    ("walk_lines<NST, SYM, false, LINES>(ln, ym, g.EY / 2, P);", "y lift")),
         "smem3": _stream3_smem(False)},
        {"kernel": "sfwd3_kernel", "instance": "sfwd3_kernel<float>", "threads": 512,
         "registers": ("sfwd3_kernelIfE",), "tol": 3e-5,
         "regions": (("streamed3d.cu", "sfwd3_kernel", "__global__"),
                     ("tiles3.cuh", "fwd3_compute", "template <")),
         "phases": (("__pipeline_wait_prior(1);", "next load issue, wait"),
                    ("lift_lines(s, ex, ez * ey, 1, 1, ex, P);", "x lift"),
                    ("lift_lines(s, ey, ez * ex, ex, ex, ey * ex, P);", "y lift"),
                    ("lift_lines(s, ez, ey * ex, ey * ex, ey * ex, 0, P);", "z lift"),
                    ("<end>fwd3_compute", "scale, stores", "before")),
         "smem3": _tile3_smem},
    ),
    "B17": (
        {"kernel": "sinv3_kernel", "instance": "sinv3_kernel<float, 4, true>", "threads": 256,
         "registers": ("sinv3_kernelIfLi4ELb1E",), "regions": _WALK_INV,
         "phases": _INV_PHASES, "smem3": _stream3_smem(True)},
        {"kernel": "sinv3_kernel", "instance": "sinv3_kernel<float, 4, true>", "threads": 256,
         "registers": ("sinv3_kernelIfLi4ELb1E",), "phases": _INV_PHASES,
         "smem3": _stream3_smem(True)},
        {"kernel": "sinv3_kernel", "instance": "sinv3_kernel<float>", "threads": 512,
         "registers": ("sinv3_kernelIfE",), "tol": 3e-5,
         "regions": (("streamed3d.cu", "sinv3_kernel", "__global__"),
                     ("tiles3.cuh", "inv3_compute", "template <")),
         "phases": (("__pipeline_wait_prior(1);", "next load issue, wait"),
                    ("lift_lines(s, ez, ey * ex, ey * ex, ey * ex, 0, P);", "scale", "before"),
                    ("lift_lines(s, ez, ey * ex, ey * ex, ey * ex, 0, P);", "z lift"),
                    ("lift_lines(s, ey, ez * ex, ex, ex, ey * ex, P);", "y lift"),
                    ("lift_lines(s, ex, ez * ey, 1, 1, ex, P);", "x lift"),
                    ("<end>inv3_compute", "stores", "before")),
         "smem3": _tile3_smem},
    ),
}
# B14, B15 by variant: the column walk (B14 on tensor boxes), then the
# parent's 3-D tile body (tiles3.cuh), one tile a block.
B3D_VARIANTS["B14"] = (
    {"kernel": "fwd3_kernel", "instance": "fwd3_kernel<float, 4, true, true>", "threads": 128,
     "registers": ("fwd3_kernelIfLi4ELb1ELb1E",), "regions": _WALK_FWD,
     "phases": _fwd_walk_phases("box wait, edge fix-up"), "smem3": _stream3_smem(False)},
    {"kernel": "fwd3_kernel", "instance": "fwd3_kernel<float>", "threads": 512,
     "registers": ("fwd3_kernelIfE",), "tol": 3e-5, "acc": False, "round": None,
     "regions": (("fused3d.cu", "fwd3_kernel", "__global__"),
                 ("tiles3.cuh", "fwd3_compute", "template <")),
     "phases": (("tiles::fwd3_load<false>(x, s, Z, Y, X, z0, y0, x0, tz, ty, tx);", "load"),
                ("lift_lines(s, ex, ez * ey, 1, 1, ex, P);", "x lift"),
                ("lift_lines(s, ey, ez * ex, ex, ex, ey * ex, P);", "y lift"),
                ("lift_lines(s, ez, ey * ex, ey * ex, ey * ex, 0, P);", "z lift"),
                ("<end>fwd3_compute", "scale, stores", "before")),
     "smem3": lambda tile: 4 * (tile[0] + 8) * (tile[1] + 8) * (tile[2] + 8)},
)
B3D_VARIANTS["B15"] = (
    {"kernel": "inv3_kernel", "instance": "inv3_kernel<float, 4, true>", "threads": 256,
     "registers": ("inv3_kernelIfLi4ELb1E",), "regions": _WALK_INV,
     "phases": _INV_PHASES, "smem3": _stream3_smem(True)},
    {"kernel": "inv3_kernel", "instance": "inv3_kernel<float>", "threads": 512,
     "registers": ("inv3_kernelIfE",), "tol": 3e-5, "acc": False, "round": None,
     "regions": (("fused3d.cu", "inv3_kernel", "__global__"),
                 ("tiles3.cuh", "inv3_compute", "template <")),
     "phases": (("tiles::inv3_load<false>(in, s, Z, Y, X, z0, y0, x0, tz, ty, tx, P);",
                 "load, scale"),
                ("lift_lines(s, ez, ey * ex, ey * ex, ey * ex, 0, P); // z", "z lift"),
                ("lift_lines(s, ey, ez * ex, ex, ex, ey * ex, P);     // y", "y lift"),
                ("lift_lines(s, ex, ez * ey, 1, 1, ex, P);            // x", "x lift"),
                ("<end>inv3_compute", "stores", "before")),
     "smem3": lambda tile: 4 * (tile[0] + 8) * (tile[1] + 8) * (tile[2] + 8)},
)
for _kid, _src, _entry in (("B16", "streamed3d.cu", "dwt3_sfwd"),
                           ("B17", "streamed3d.cu", "dwt3_sinv"),
                           ("B14", "fused3d.cu", "dwt3_fwd"), ("B15", "fused3d.cu", "dwt3_inv")):
    KERNELS[_kid] = {"source": _src, "entry": _entry, "tile": 0, "round": None,
                     "acc": True, "variants": B3D_VARIANTS[_kid]}


# B18, the halo push (csrc/remote_halo.cu halo_kernel): (shards, rows,
# columns, halo) of a launch; the phases are stamped in every shard's
# first block (the case's ``select``), "t0" phases by thread 0 alone with
# no barrier.
B18_SHAPES = {"B18": (8, 256, 4096, 4), "B18S": (8, 16, 256, 4)}
for _kid in B18_SHAPES:
    KERNELS[_kid] = {
        "source": "remote_halo.cu", "kernel": "halo_kernel", "entry": "halo_extend_rows",
        "suffix": "", "tile": 0, "round": None, "instance": "halo_kernel<uint32_t>",
        "start": "const size_t hw = (size_t)h * w, hw_halo = (size_t)halo * w;",
        "smem": lambda ty, tx, mats: 0,
        "phases": (("if (i < n - 1) wait_for(my + ENTERED_NEXT, epoch);", "entered wait",
                    "t0"),
                   ("__threadfence_system();", "pushes, mirror rows", "before"),
                   ("__threadfence_system();", "system fence"),
                   ("if (i > 0) signal(tab.s[i - 1].flags + ARRIVED_NEXT, epoch);",
                    "arrived signal", "t0"),
                   ("(size_t)per_shard * blockDim.x);", "centre copy"),
                   ("<end>halo_kernel", "arrived wait", "before")),
        "extra": """
__global__ void kp_empty_kernel() {}
extern "C" int kp_empty(int grid, int threads, int coop, void* stream) {
    void* args[1] = {nullptr};
    cudaError_t err = coop ? cudaLaunchCooperativeKernel((const void*)kp_empty_kernel,
                                                         dim3(grid), dim3(threads), args, 0,
                                                         (cudaStream_t)stream)
                           : cudaLaunchKernel((const void*)kp_empty_kernel, dim3(grid),
                                              dim3(threads), args, 0, (cudaStream_t)stream);
    return err ? (int)err : (int)cudaGetLastError();
}
"""}


def window_smem(tile: int) -> int:
    """Shared memory (bytes, float32) of the one-level window of B1, B3,
    B4 and B6 at ``tile``: (2 tile + 8) rows of lines::stride columns."""
    e = 2 * tile + 8
    return 4 * e * (e if e % 4 else e + 2)


def _function(text: str, name: str, kind: str):
    """(start, end) of the function ``name`` in ``text``: from the line of
    its ``kind`` (``__global__`` or ``template <``) to its closing brace at
    the start of a line."""
    k0 = text.rindex(kind, 0, text.index(name + "("))
    k0 = text.rindex("\n", 0, k0) + 1
    return k0, text.index("\n}\n", k0) + 2


def _where(phase):
    """Where a phase's stamp goes: "after" its marker's line, "before" it, or
    "t0" (after it, by thread 0 alone: the line is in thread 0's branch)."""
    return phase[2] if len(phase) > 2 else "after"


def _regions(spec):
    """(file, function, kind) of every function that holds phase markers."""
    if "regions" in spec:
        return spec["regions"]
    if "body" in spec:
        return ((spec["body"][0], spec["body"][1], "template <"),)
    return ((spec["source"], spec["kernel"], "__global__"),)


def _region_lines(texts, region):
    f, name, kind = region
    if f not in texts or name + "(" not in texts[f]:
        return None
    k0, k1 = _function(texts[f], name, kind)
    return texts[f][k0:k1].split("\n")


def _markers_found(spec, texts):
    """Each phase marker once in the spec's functions (``<end>f``: the end
    of function f, one of them), and its kernel in the source."""
    if spec["kernel"] + "(" not in texts.get(spec["source"], ""):
        return False
    regions = {r[1]: _region_lines(texts, r) for r in _regions(spec)}
    if any(v is None for v in regions.values()):
        return False
    for marker, *_ in spec["phases"]:
        if marker.startswith("<end>"):
            if marker[5:] not in regions:
                return False
        elif sum(marker in ln for lines in regions.values() for ln in lines) != 1:
            return False
    return True


def resolve(kid, texts):
    """The spec of ``kid`` for these sources: its own, or (B13) its first
    variant whose kernel and markers the sources hold."""
    spec = KERNELS[kid]
    for variant in spec.get("variants", ({},)):
        merged = {**spec, **variant}
        if _markers_found(merged, texts):
            return merged
    raise SystemExit(f"{kid}: no variant's phase markers are all in the sources; "
                     "update its phases")


def _stamp_region(text, region, spec, stamp):
    """``text`` with ``stamp(i)`` after (or before) the one line of each of
    the phase markers in the region's function."""
    _, name, kind = region
    k0, k1 = _function(text, name, kind)
    lines = text[k0:k1].split("\n")
    close = max(i for i, ln in enumerate(lines) if ln == "}")
    out = []
    for n, ln in enumerate(lines):
        for i, ph in enumerate(spec["phases"]):
            if _where(ph) == "before" and (
                    ph[0] == f"<end>{name}" and n == close
                    or not ph[0].startswith("<end>") and ph[0] in ln):
                out.append(stamp(i, False))
        out.append(ln)
        for i, ph in enumerate(spec["phases"]):
            if _where(ph) in ("after", "t0") and ph[0] in ln:
                out.append(stamp(i, _where(ph) == "t0"))
    return text[:k0] + "\n".join(out) + text[k1:]


def stamped_sources(texts: dict, spec: dict, rounds: int) -> dict:
    """``texts`` ({file: text} of the kernel's source and headers) with a
    barrier and a clock64 stamp after each phase of the spec's functions:
    per block, slot 0 at its start and slot 1 + round * NP + i after phase
    i of a round, or (``acc``) the cycles since the block's last stamp added
    to slot 1 + i; then the globaltimer at the block's start and end, and
    its SM.  Where the spec names an ``instance`` of the kernel,
    ``kp_occupancy`` gives the blocks an SM that
    cudaOccupancyMaxActiveBlocksPerMultiprocessor allows it and
    ``kp_registers`` its registers.  Returns the stamped texts."""
    np_, rnd = len(spec["phases"]), spec["round"] or "0"
    nstamp = 1 + (1 if spec.get("acc") else rounds) * np_
    if spec.get("acc"):
        stamp = lambda i, t0: f"    KP_ACC({i});"  # noqa: E731
    else:
        stamp = lambda i, t0: (  # noqa: E731
            f"    KP_{'T0' if t0 else 'STAMP'}(1 + ({rnd}) * {np_} + {i});")
    out = dict(texts)
    for region in _regions(spec):
        out[region[0]] = _stamp_region(out[region[0]], region, spec, stamp)
    src = out[spec["source"]]
    k0, k1 = _function(src, spec["kernel"], "__global__")
    head, kern, tail = src[:k0], src[k0:k1], src[k1:]
    lines = []
    for ln in kern.split("\n"):
        lines.append(ln)
        if spec.get("start", "extern __shared__") in ln:
            lines.append("    KP_STAMP(0);")
            lines.append(f"    if (threadIdx.x == 0 && KP_ID < KP_MAX) {{"
                         f" kp_slots[KP_ID * KP_SLOTS + {nstamp}] = kp_now();"
                         f" kp_slots[KP_ID * KP_SLOTS + {nstamp + 2}] = kp_smid(); }}")
    lines.insert(len(lines) - 1 - lines[::-1].index("}"),
                 f"    if (threadIdx.x == 0 && KP_ID < KP_MAX)"
                 f" kp_slots[KP_ID * KP_SLOTS + {nstamp + 1}] = kp_now();")
    prelude = f"""
#define KP_MAX {MAX_BLOCKS}
#define KP_SLOTS {nstamp + 3}
#define KP_ID ((int)((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x))
__device__ unsigned long long kp_slots[KP_MAX * KP_SLOTS];
__device__ __forceinline__ unsigned long long kp_now() {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    return t;
}}
__device__ __forceinline__ unsigned kp_smid() {{
    unsigned r;
    asm volatile("mov.u32 %0, %smid;" : "=r"(r));
    return r;
}}
#define KP_STAMP(i)                                                          \\
    do {{                                                                     \\
        __syncthreads();                                                     \\
        if (threadIdx.x == 0 && KP_ID < KP_MAX)                              \\
            kp_slots[KP_ID * KP_SLOTS + (i)] = clock64();                          \\
    }} while (0)
#define KP_T0(i)                                                             \\
    do {{                                                                     \\
        if (threadIdx.x == 0 && KP_ID < KP_MAX)                              \\
            kp_slots[KP_ID * KP_SLOTS + (i)] = clock64();                          \\
    }} while (0)
#define KP_ACC(i)                                                            \\
    do {{                                                                     \\
        __syncthreads();                                                     \\
        if (threadIdx.x == 0 && KP_ID < KP_MAX) {{                            \\
            const unsigned long long t = clock64();                          \\
            kp_slots[KP_ID * KP_SLOTS + 1 + (i)] += t - kp_slots[KP_ID * KP_SLOTS];      \\
            kp_slots[KP_ID * KP_SLOTS] = t;                                        \\
        }}                                                                    \\
    }} while (0)
"""
    getter = """
extern "C" int kp_read(unsigned long long* out, int n) {
    return (int)cudaMemcpyFromSymbol(out, kp_slots, sizeof(unsigned long long) * n);
}
extern "C" int kp_clear(int n) {
    void* p = nullptr;
    int err = (int)cudaGetSymbolAddress(&p, kp_slots);
    return err ? err : (int)cudaMemset(p, 0, sizeof(unsigned long long) * n);
}
"""
    if "instance" in spec:
        getter += f"""
extern "C" int kp_occupancy(int* blocks, int threads, int smem) {{
    int err = (int)cudaFuncSetAttribute({spec["instance"]},
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    return err ? err : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, {spec["instance"]}, threads, (size_t)smem);
}}
extern "C" int kp_registers(int* regs) {{
    cudaFuncAttributes a;
    int err = (int)cudaFuncGetAttributes(&a, {spec["instance"]});
    *regs = a.numRegs;
    return err;
}}
"""
    getter += spec.get("extra", "")
    # the prelude comes first: a stamped header uses its macros
    out[spec["source"]] = prelude + head + "\n".join(lines) + tail + getter
    return out


def make_case(kid, tile, seed):
    """Inputs, outputs (in the plain version's order), plain results, a
    launch through ctypes and the block count of one kernel at the main
    path's shapes."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from libdwt_torch.ops import fused as F

    rng = np.random.default_rng(seed)
    if kid in B18_SHAPES:
        return b18_case(kid, rng)
    x = torch.from_numpy(rng.random((H, W), dtype=np.float32)).cuda()
    P = F._lift_params(F.get_wavelet(WV), False, kid in ("B4", "B5", "B6", "B9"))
    info = (ctypes.c_int * 2)()
    extra = []
    if kid in ("B14", "B15", "B16", "B17"):
        from libdwt_torch.ops import _cuda
        from libdwt_torch.ops import fused3d as F3
        from libdwt_torch.ops import streamed3d as S3
        from libdwt_torch.ops.fused3d import BANDS, _band_ptrs

        if kid in ("B16", "B17"):
            tile = tuple(tile) if tile else S3.STILE3
        else:  # the tree's default (a parent's TILE3 is its 3-D tile)
            tile = tuple(tile) if tile else F3.TILE3
        P = F._lift_params(F.get_wavelet(WV), False, kid in ("B15", "B17"))
        v = torch.from_numpy(rng.random(VOLUME, dtype=np.float32)).cuda()
        bands = F3.dwt3_level_plain(v, WV, tile)
        if kid in ("B14", "B16"):
            ins, outs = [v], [torch.empty_like(bands[n]) for n in BANDS]
            want = [bands[n] for n in BANDS]
            keep = _band_ptrs(outs)
            args = [v.data_ptr(), keep]
        else:
            ins, outs = [bands[n].contiguous() for n in BANDS], [torch.empty_like(v)]
            want = [F3.idwt3_level_plain(bands, WV, tile)]
            keep = _band_ptrs(ins)
            args = [keep, outs[0].data_ptr()]
        args += [*VOLUME, *tile]
        entry = KERNELS[kid]["entry"]
        if len(_cuda._SIGS[entry]) > 10:  # B14/B15 on the walk report their feed
            args.append((ctypes.c_int * 1)())
        blocks = 0  # counted from the stamps
    elif kid in ("B13F", "B13I"):
        from libdwt_torch.ops import banded
        from libdwt_torch.ops import streamed as S

        # the tree's default banded strip (a parent's may predate MXU_STRIP)
        tile = tile or getattr(S, "MXU_STRIP", S.STRIP_TY)
        P = F._lift_params(F.get_wavelet(WV), False, kid == "B13I")
        extra = [ctypes.byref(banded.kernel_mats(WV, kid == "B13I", tile, tile, x.device))]
        ll2, b2, b1 = S.streamed_dwt2_2level_plain(x, WV, tile, tile, body="mxu")
        if kid == "B13F":
            ins = [x]
            outs = [torch.empty((H // 4, W // 4), device="cuda") for _ in range(4)]
            outs += [torch.empty((H // 2, W // 2), device="cuda") for _ in range(3)]
            want = cs.leaves((ll2, b2, b1))
        else:
            ins = [a.contiguous() for a in (ll2, *b2, *b1)]
            outs = [torch.empty((H, W), device="cuda")]
            want = [S.streamed_idwt2_2level_plain(ins[0], tuple(ins[1:4]), tuple(ins[4:]), WV,
                                                  tile, tile, body="mxu")]
        args = [t.data_ptr() for t in ins + outs] + [H, W, tile, tile]
        blocks = 0  # counted from the stamps
    elif kid in ("B1", "B4"):
        bands = [a.contiguous() for a in F.dwt2_level_plain(x, WV, tile)]
        if kid == "B1":
            ins, outs, want = [x], F._carve([tuple(a.shape) for a in bands], x), bands
        else:
            ins = bands
            outs = [torch.empty((H, W), device="cuda")]
            want = [F.idwt2_level_plain(*bands, WV, tile)]
        args = [t.data_ptr() for t in ins + outs] + [H, W, tile, 0]
        blocks = -(-W // (2 * tile)) * -(-H // (2 * tile))
    elif kid in ("B7", "B9"):
        from libdwt_torch.ops import streamed as S

        bands = [a.contiguous() for a in S.streamed_dwt2_level_plain(x, WV, tile, tile)]
        if kid == "B7":
            ins, outs, want = [x], [torch.empty_like(a) for a in bands], bands
        else:
            ins = bands
            outs = [torch.empty((H, W), device="cuda")]
            want = [S.streamed_idwt2_level_plain(*bands, WV, tile, tile)]
        args = [t.data_ptr() for t in ins + outs] + [H, W, tile, tile, 0]
        blocks = -(-W // tile) * -(-H // tile)
    elif kid in ("B8", "B10"):
        from libdwt_torch.ops import streamed as S

        ll2, b2, b1 = S.streamed_dwt2_2level_plain(x, WV, tile, tile)
        P = F._lift_params(F.get_wavelet(WV), False, kid == "B10")
        if kid == "B8":
            ins = [x]
            outs = [torch.empty((H // 4, W // 4), device="cuda") for _ in range(4)]
            outs += [torch.empty((H // 2, W // 2), device="cuda") for _ in range(3)]
            want = cs.leaves((ll2, b2, b1))
        else:
            ins = [a.contiguous() for a in (ll2, *b2, *b1)]
            outs = [torch.empty((H, W), device="cuda")]
            want = [S.streamed_idwt2_2level_plain(ins[0], tuple(ins[1:4]), tuple(ins[4:]), WV,
                                                  tile, tile)]
        args = [t.data_ptr() for t in ins + outs] + [H, W, tile, tile]
        blocks = 0  # counted from the stamps
    elif kid in ("B2", "B5"):
        ll2, b2, b1 = F.fused_dwt2_2level_plain(x, WV)
        if kid == "B2":
            ins = [x]
            outs = [torch.empty((H // 4, W // 4), device="cuda") for _ in range(4)]
            outs += [torch.empty((H // 2, W // 2), device="cuda") for _ in range(3)]
            want = cs.leaves(F.fused_dwt2_2level_plain(x, WV, tile))
        else:
            ins = [a.contiguous() for a in (ll2, *b2, *b1)]
            outs = [torch.empty((H, W), device="cuda")]
            want = [F.fused_idwt2_2level_plain(ins[0], tuple(ins[1:4]), tuple(ins[4:]), WV,
                                               tile)]
        args = [t.data_ptr() for t in ins + outs] + [H, W, tile]
        blocks = -(-W // tile) * -(-H // tile)
    else:
        ll2 = F.fused_dwt2_2level_plain(x, WV)[0].contiguous()
        coeffs = F.fused_deep_wavedec2_plain(ll2, WV, DEEP_LEVELS)
        shapes, ins = [], [ll2]
        if kid == "B3":
            h, w = ll2.shape
            for _ in range(DEEP_LEVELS):
                cy, cx, fy, fx = -(-h // 2), -(-w // 2), h // 2, w // 2
                shapes += [(cy, fx), (fy, cx), (fy, fx), (cy, cx)]  # HL, LH, HH, LL
                h, w = cy, cx
            made = F._carve(shapes, ll2)
            ptrs = ins + made
            outs = [made[-1]] + [a for k in reversed(range(DEEP_LEVELS))
                                 for a in made[4 * k: 4 * k + 3]]
            want = cs.leaves(coeffs)
            h, w = ll2.shape
        else:
            ins = [coeffs[0].contiguous()]
            h, w = ins[0].shape
            for hl, lh, _ in coeffs[1:]:
                h, w = h + lh.shape[0], w + hl.shape[1]
                shapes.append((h, w))
            made = F._carve(shapes, ll2)
            ptrs = list(ins)
            for bands, rec in zip(coeffs[1:], made):
                bands = [b.contiguous() for b in bands]
                ins += bands
                ptrs += bands + [rec]
            outs = [made[-1]]
            want = [F.fused_deep_waverec2_plain(coeffs, WV)]
        arr = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])
        args = [arr, DEEP_LEVELS, h, w, tile, info]
        blocks = None
    stream = torch.cuda.current_stream().cuda_stream

    def launch(fn):
        return fn(*args, ctypes.byref(P), *extra, stream)

    return {"ins": ins, "outs": outs, "want": want, "launch": launch, "P": P, "tile": tile,
            "mats": extra[0]._obj if extra else None,
            "nblocks": lambda: blocks if blocks is not None else info[0],
            "rounds": 1 if blocks is not None else DEEP_LEVELS}


def b18_case(kid, rng):
    """The push kernel B18 on one line of ``B18_SHAPES[kid]`` float32 blocks
    of this card ('signal' edges): its flags in a buffer of this case, a new
    epoch each launch, the grid read back from the launch."""
    import numpy as np
    import torch

    from libdwt_torch.parallel import remote_halo as RH

    n, h, w, halo = B18_SHAPES[kid]
    ins = [torch.from_numpy(rng.random((h, w), dtype=np.float32)).cuda() for _ in range(n)]
    outs = list(torch.empty((n, h + 2 * halo, w), device="cuda").unbind(0))
    flags = torch.zeros(4 * n, dtype=torch.int32, device="cuda")
    P = ctypes.c_void_p
    xs = (P * n)(*[t.data_ptr() for t in ins])
    os_ = (P * n)(*[t.data_ptr() for t in outs])
    fl = (P * n)(*[flags.data_ptr() + 16 * i for i in range(n)])
    mine = (ctypes.c_int * n)(*range(n))
    info, epoch = (ctypes.c_int * 2)(), [0]
    stream = torch.cuda.current_stream().cuda_stream

    def launch(fn):
        epoch[0] += 1
        return fn(xs, os_, fl, n, mine, n, h, w, halo, 1, 1, 4, epoch[0], info, stream)

    def first_blocks(nblk):
        per_shard = nblk // n
        return np.arange(nblk) % per_shard == 0

    return {"ins": ins, "outs": outs, "want": RH.rdma_extend_rows_plain(ins, halo),
            "launch": launch, "tile": (n, h, w, halo), "mats": None, "flags": flags,
            "nblocks": lambda: info[0], "rounds": 1, "select": first_blocks,
            "what": f"{n} x {h}x{w} f32, halo {halo}"}


def read_sources() -> dict:
    """{file: text} of every source and header of the port's csrc."""
    from libdwt_torch.ops import _cuda

    out = {}
    for name in _cuda.SOURCES + _cuda.HEADERS:
        with open(os.path.join(_cuda.CSRC, name)) as f:
            out[name] = f.read()
    return out


def build(kid, spec, rounds, texts, stamp=True):
    """Start nvcc on the stamped copy of the kernel's source (with
    ``stamp=False``, on the source as it is), with every header copied
    beside it (so each include finds the stamped ones); returns (process,
    library path)."""
    from libdwt_torch.ops import _cuda

    bdir = os.path.join(ROOT, "build", "kernel_phases", kid if stamp else f"{kid}_plain")
    os.makedirs(bdir, exist_ok=True)
    stem = os.path.splitext(spec["source"])[0]
    stamped = stamped_sources(texts, spec, rounds) if stamp else texts
    for name in _cuda.HEADERS:
        with open(os.path.join(bdir, name), "w") as f:
            f.write(stamped[name])
    src = os.path.join(bdir, f"{stem}_phases.cu")
    with open(src, "w") as f:
        f.write(stamped[spec["source"]])
    lib = os.path.join(bdir, f"{stem}_phases.so")
    cmd = [_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-o", lib, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def most_resident(start, end, sm):
    """The most blocks resident on each SM at once, from their lifetimes."""
    import numpy as np

    most = []
    for s in np.unique(sm):
        idx = np.where(sm == s)[0]
        events = sorted([(start[i], 1) for i in idx] + [(end[i], -1) for i in idx])
        c = m = 0
        for _, d in events:
            c += d
            m = max(m, c)
        most.append(m)
    return most


def report(kid, spec, case, lib, smi):
    """Run the stamped copy, check it, and print its phases."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from libdwt_torch.ops import _cuda

    phases, np_, rounds = spec["phases"], len(spec["phases"]), case["rounds"]
    acc = spec.get("acc", False)
    nstamp = 1 + (1 if acc else rounds) * np_
    slots = nstamp + 3
    suffix = spec.get("suffix", "f32")
    sym = f"{spec['entry']}_{suffix}" if suffix else spec["entry"]
    pfn = getattr(lib, sym)
    pfn.argtypes = _cuda._SIGS[spec["entry"]]
    pfn.restype = ctypes.c_int
    for o in case["outs"]:
        o.zero_()
    for _ in range(3):
        _cuda.check(lib.kp_clear(MAX_BLOCKS * slots), "kp_clear")
        _cuda.check(case["launch"](pfn), f"stamped {sym}")
    torch.cuda.synchronize()
    if cs.max_abs(case["outs"], case["want"]) > spec.get("tol", 0):
        raise SystemExit(f"the stamped {kid} differs from its plain version")
    buf = (ctypes.c_ulonglong * (MAX_BLOCKS * slots))()
    if lib.kp_read(buf, len(buf)) != 0:
        raise SystemExit("could not read the stamps")
    a = np.frombuffer(buf, dtype=np.uint64).reshape(MAX_BLOCKS, slots).astype(np.int64)
    nblk = case["nblocks"]() or int((a[:, nstamp] > 0).sum())  # blocks 0..grid-1 stamp
    if nblk > MAX_BLOCKS:
        raise SystemExit(f"{nblk} blocks: raise MAX_BLOCKS")
    a = a[:nblk]
    how = "added up over each block's walk" if acc else "a block"
    sel = case["select"](nblk) if "select" in case else np.ones(nblk, dtype=bool)
    which = f"{int(sel.sum())} of {nblk} blocks (each shard's first)" if "select" in case \
        else f"{nblk} blocks"
    print(f"{kid} phases of {which} ({spec['kernel']}), clock64 cycles {how} (a barrier "
          f"before each stamp but thread 0's) [{smi}]:")
    stamps = a[sel, :nstamp]
    if acc:
        tot = stamps[:, 1:].sum()
        for i, (_, name, *_) in enumerate(phases):
            cyc = stamps[:, 1 + i]
            print(f"  {name:34s} mean {cyc.mean():11.0f}  median {np.median(cyc):11.0f}"
                  f"  {100 * cyc.sum() / tot:5.1f}%")
        rounds = 0
    for r in range(rounds):
        for i, (_, name, *_) in enumerate(phases):
            j = 1 + r * np_ + i
            ok = (stamps[:, j] > 0) & (stamps[:, j - 1] > 0)
            cyc = (stamps[:, j] - stamps[:, j - 1])[ok]
            label = f"level {r + 1} {name}" if rounds > 1 else name
            if len(cyc):
                print(f"  {label:22s} mean {cyc.mean():9.0f}  median {np.median(cyc):9.0f}"
                      f"  ({len(cyc)} blocks)")
            else:
                print(f"  {label:22s} no block ran it")
    if not acc:
        total = stamps[:, nstamp - 1] - stamps[:, 0]
        print(f"  {'block, stamp 0 to last':22s} mean {total.mean():9.0f}  median "
              f"{np.median(total):9.0f}")
        span = (a[sel, nstamp + 1] - a[sel, nstamp]).astype(float)
        print(f"  clock64 cycles a globaltimer ns over those blocks: "
              f"{total.sum() / max(span.sum(), 1):.3f}")
    start, end, sm = a[:, nstamp], a[:, nstamp + 1], a[:, nstamp + 2]
    print(f"block lifetime {(end - start).mean():.0f} ns mean (globaltimer); kernel span "
          f"{end.max() - start.min()} ns")
    most = most_resident(start, end, sm)
    print(f"{len(most)} SMs; most blocks resident on an SM at once: {max(most)} "
          f"(mean of the SMs' most {np.mean(most):.2f}); {nblk / len(most):.2f} blocks "
          f"an SM", flush=True)
    if "instance" in spec:
        occ, regs = ctypes.c_int(), ctypes.c_int()
        threads = spec.get("threads", THREADS)
        if "smem3" in spec:
            smem = spec["smem3"](case["tile"])
        elif "smem" in spec:
            smem = spec["smem"](case["tile"], case["tile"], case["mats"])
        else:
            smem = window_smem(case["tile"])
        _cuda.check(lib.kp_occupancy(ctypes.byref(occ), threads, smem), "kp_occupancy")
        _cuda.check(lib.kp_registers(ctypes.byref(regs)), "kp_registers")
        print(f"occupancy query: {occ.value} blocks of {threads} threads an SM at {smem} "
              f"bytes of shared memory (the stamped {spec['instance']}, {regs.value} "
              f"registers)", flush=True)


def b18_times(kid, case, fn, ms, what, reps, smi):
    """B18's event and device times at its shape, and an empty kernel of its
    grid launched cooperatively and ordinarily (built with the stamped
    copy; device time by CUPTI, event time over back-to-back launches)."""
    import chip_smoke as cs

    import torch

    dev = cs.device_ms(lambda: case["launch"](fn), reps=20, only="halo_kernel")
    grid = case["nblocks"]()
    print(f"{kid} ({case['what']}; grid {grid}, one cooperative launch): {ms:.4f} ms a "
          f"launch (CUDA events, {reps} launches through ctypes), device "
          f"{'not measured' if dev is None else f'{dev:.4f} ms'}, {what} [{smi}]", flush=True)
    case["empty_grid"] = grid
    # a device copy of the inputs' bytes: reads them and writes as many
    src = torch.cat([t.reshape(-1) for t in case["ins"]])
    dst = torch.empty_like(src)
    cp = cs.device_ms(lambda: dst.copy_(src), reps=20)
    print(f"{kid} a device copy of the inputs' {src.numel() * 4 / 1e6:.1f} MB: device "
          f"{'not measured' if cp is None else f'{cp:.4f} ms'} [{smi}]", flush=True)


def b18_empty(kid, case, lib, reps, smi):
    """The empty kernel of the stamped library at B18's grid, both launches."""
    import torch

    import chip_smoke as cs
    from libdwt_torch.ops import _cuda

    grid, stream = case["empty_grid"], torch.cuda.current_stream().cuda_stream
    lib.kp_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.kp_empty.restype = ctypes.c_int
    for coop, how in ((1, "cooperative"), (0, "ordinary")):
        _cuda.check(lib.kp_empty(grid, THREADS, coop, stream), f"empty {how} launch")
        run = lambda: lib.kp_empty(grid, THREADS, coop, stream)  # noqa: E731
        ev = cs.time_ms(run, reps, warm=10)
        dev = cs.device_ms(run, reps=20, only="kp_empty")
        print(f"{kid} empty kernel, {how} launch of {grid} blocks of {THREADS} threads: "
              f"{ev:.4f} ms a launch (CUDA events), device "
              f"{'not measured' if dev is None else f'{dev:.4f} ms'} [{smi}]", flush=True)


def ptxas_registers(log: str, patterns) -> list:
    """[(kernel, registers, spill line)] of the ptxas -v log's entry
    functions whose mangled names hold one of ``patterns`` (chip_smoke.py
    has the same; this script keeps its own, since it also runs from a
    parent's tree)."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            if any(p in name for p in patterns):
                regs = int(line.split("Used")[1].split()[0])
                out.append((name, regs, spill))
            name = None
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernels", nargs="*", default=["B3", "B6"], choices=sorted(KERNELS))
    ap.add_argument("--tile", type=int, default=0, help="default: the kernel's own")
    ap.add_argument("--tile3", default="", help="B14-B17: tz,ty,tx (default: the tree's)")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from libdwt_torch.ops import _cuda

    smi = cs.nvidia_smi()
    texts = read_sources()
    cases, builds, specs, plain = {}, {}, {}, {}
    for kid in args.kernels:
        specs[kid] = spec = resolve(kid, texts)
        tile = args.tile or spec["tile"]
        if kid in ("B14", "B15", "B16", "B17"):
            tile = tuple(int(t) for t in args.tile3.split(",")) if args.tile3 else None
        cases[kid] = make_case(kid, tile, args.seed)
        builds[kid] = build(kid, spec, cases[kid]["rounds"], texts)
        if kid in B18_SHAPES:  # its own source only: the others take minutes to build
            plain[kid] = build(kid, spec, 1, texts, stamp=False)
    for kid, case in cases.items():
        spec = specs[kid]
        if kid in B18_SHAPES:
            proc, path = plain[kid]
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"nvcc failed on {spec['source']}:\n{log}")
            fn = getattr(ctypes.CDLL(path), spec["entry"])
            fn.argtypes, fn.restype = _cuda._SIGS[spec["entry"]], ctypes.c_int
        else:
            fn = _cuda.kernel_fn(spec["entry"], spec.get("suffix", "f32"))
        _cuda.check(case["launch"](fn), spec["entry"])
        torch.cuda.synchronize()
        err = cs.max_abs(case["outs"], case["want"])
        tol = spec.get("tol", 0)
        if err > tol:
            raise SystemExit(f"{kid} differs from its plain version: max|diff| {err}")
        ms = cs.time_ms(lambda: case["launch"](fn), args.reps, warm=10)
        what = f"max|diff| {err:.3e} <= {tol:g} from plain" if tol else "== plain"
        if kid in B18_SHAPES:
            b18_times(kid, case, fn, ms, what, args.reps, smi)
        else:
            print(f"{kid} f32 {WV} tile {case['tile']} at the main path's shapes: "
                  f"{ms:.4f} ms a launch (CUDA events, {args.reps} launches through ctypes), "
                  f"{what} [{smi}]", flush=True)
        if "registers" in spec:
            log = _cuda.build_all()[spec["source"]].with_suffix(".log").read_text()
            for name, regs, spill in ptxas_registers(log, spec["registers"]):
                print(f"ptxas {name}: {regs} registers; {spill}", flush=True)
    for kid, (proc, path) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the stamped {kid}:\n{log}")
        lib = ctypes.CDLL(path)
        report(kid, specs[kid], cases[kid], lib, smi)
        if kid in B18_SHAPES:
            b18_empty(kid, cases[kid], lib, args.reps, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
