#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed N] [--reps N]

1. Builds every CUDA kernel of the port from ``libdwt_torch/csrc``.
2. Drives nine paths through the public API, each with the launch
   counts set to 0 just before it and read just after, on data made from
   a numpy seed (CDF 9/7, float32); the riders (6.), the tools (7.) and
   the example programs (9.) are the tenth to the twelfth:
   - the 2-D pyramid: ``api.wavedec2`` / ``waverec2``, J=5,
     ``impl='fused'`` on a 2144x4096 frame (two-level kernels B2/B5,
     deep tails B3/B6: one cooperative launch each for levels 3-5);
   - the single fused levels: ``api.dwt2`` / ``idwt2`` with
     ``impl='fused'`` on the same frame (B1/B4), and ``api.wavedec2`` of
     a 2161x4097 frame, J=5, whose plan is B1, B1, then B3 (three levels,
     one launch);
   - the 3-D volume: ``api.wavedec3`` / ``waverec3``, J=2,
     ``impl='fused'`` on 64x512x512 (B14/B15, twice each);
   - the streamed pyramid: ``api.wavedec2`` / ``waverec2`` with
     ``impl='streamed'`` on the 2144x4096 frame, J=5 (one cooperative
     launch each: B11, B12) and J=2 (B8, B10);
   - the single streamed levels: ``api.dwt2`` / ``idwt2`` with
     ``impl='streamed'`` on the 2144x4096 frame (B7, B9);
   - the streamed volume: ``api.wavedec3`` / ``waverec3`` with
     ``impl='streamed'`` on 64x512x512, J=2 (B16, B17, twice each);
   - the banded-matmul pyramid: ``api.wavedec2`` / ``waverec2`` with
     ``impl='streamed-mxu'`` on the 2144x4096 frame, J=5 (B11, B12 with
     their banded body B13) and J=2 (B8, B10 with B13);
   - the sharded path: ``parallel.sharded_wavedec2`` / ``sharded_waverec2``
     of a 2048x4096 frame, J=5, on a mesh of eight shards of this card
     with ``halo_impl='rdma'`` (the halo kernel B18: a line on one card
     takes one ordinary gather launch, once per forward level and once per
     inverse level for both channels), exactly equal to the
     ``'ppermute'`` exchange; then the same frame with ``kernel='fused'``
     (B1/B4 on every shard and level) and ``kernel='streamed'`` (B7/B9 at
     levels 1-2, B1/B4 below);
   - ``api.wavedec2`` / ``waverec2`` with an explicit ``impl='auto'`` on
     the 2144x4096 frame, J=5, with an empty tune table (the built-in
     thresholds): each level re-dispatches, so level 2 (1072x2048) takes
     B1 and B4 once.  The checks of 'auto' on the CUDA volume and of
     ``Volume.wavedec`` also run with an empty table.
3. Checks each path against the port's separable oracle on the card
   (pyramids <= 5e-4, single levels <= 3e-5, round trips <= 1e-3), the
   reference's bench gates of B1 (int32 CDF 5/3 at 512x512 exact, f32 at
   513x511 <= 3e-5), the extended-rows contracts (4 rows fused, 8
   streamed), int32 CDF 5/3 through every kernel (exactly equal to the
   plain versions and the oracle), that 'auto' on the CUDA volume takes
   the 3-D kernels, and that the cooperative grids of B11/B12 fit the
   card at once (with either body).  The banded pyramid is held to 5e-4
   both ways (the reference's own bound for its banded body).  The
   sharded path is held to the oracle within 1e-4 (its kernel bodies
   5e-4), round trips 1e-3; beside it run the reference's mesh-of-1 gate
   (``bench.py`` g_sharded_mesh1), batched int32 CDF 5/3 on a (2, 4) mesh
   (exact) and ``sharded_wavedec3`` of 64x512x512 J=2 on 4 z shards
   (1e-4).  Every polyphase kernel is run in float64 and equals its plain
   version bit for bit.  A line says whether B18 ran across two cards.
4. Holds each kernel against its plain PyTorch version on the card at
   its path's shapes, the volume kernels at both levels (float32:
   <= 3e-5; B1-B12 and B14-B17 exactly, bit for bit (the
   volume kernels' registers, blocks an SM and shared memory are printed,
   and the feed B14 took on each volume: 3-D tensor boxes or copies; so
   are B8/B10's registers, blocks an SM and grid), B8 and B10 also equal
   to B2 and B5 on the frame, B7 and B9 to B1 and B4 on the frame (their
   registers, blocks an SM and grid printed too), B11 and B12
   equal to B2 then B3 and B6 then B5 on the frame and, launched with no
   deep level, to B2 and B5; B1 also at the odd pyramid's
   2161x4097 and 1081x2049 and the 513x511 gate, B1/B4 with extended
   rows, B3 on the odd pyramid's 541x1025 chain), B1/B4/B7/B9 on every
   input the sharded kernel bodies and the explicit-'auto' pyramid give
   them (caught by wrapping the wrappers during an extra run of those
   paths; exactly), each banded
   instantiation of B8/B10/B11/B12 against its plain version (<= 2e-5:
   the tensor cores sum in another order; B11 and B12 with the banded body
   also equal to B8-mxu then B3 and B6 then B10-mxu on the frame, bit for
   bit, and their registers and blocks an SM are printed), and B18 at the
   sharded path's level-1 shapes in every edge mode and as the inverse's
   channel pair, the gather and the push (exactly; timed at each of the 10 launch shapes of the
   sharded J=5 path, beside each one's byte bound and
   ``torch.index_select`` of the same rows).
5. Times each kernel and its plain version with CUDA events (and the
   kernel's device time with the profiler, which leaves out the host's
   cost of issuing it), beside the card's bound for the same work; B8
   beside B2 and B10 beside B5, B7 beside B1 and B9 beside B4 (device
   time, alternating); B11
   and B12's device time split into the strip phase (a launch with no
   deep level) and the deep levels, beside B2 + B3 and B6 + B5 and the
   two kernels B8 then B3 and B6 then B10, and so
   for their banded instantiations (the strip phase is B8/B10-mxu)
   beside B3 and B6; B3 and
   B6 also beside one launch of B1/B4 per level (the same tile body,
   csrc/onelevel.cuh); the library yardsticks of the forward kernels
   (reflect padding by 4 and a stride-2 conv2d with the level's four 9x9
   analysis filters, chained over B1/B7's one level, B2/B8's two, B3's
   deep three and B11's five; a stride-2 conv3d with the eight 9x9x9
   filters at both of B14/B16's levels; TF32 off, each held to the plain
   version or the oracle) and of the inverse kernels (the four bands
   interleaved by ``pixel_shuffle``, reflect padding by 3 before and 4
   after, a stride-2 conv2d to the four output phases with the 9x9
   polyphase synthesis filters, ``pixel_shuffle`` back; chained over
   B4/B9's one level, B5/B10's two, B6's deep three and B12's five, each
   within 3e-5 of the plain version, the J=5 round trip within 1e-3; a
   stride-2 conv3d to the eight phases at both of B15/B17's levels, 3e-5);
   times and profiles the paths.
6. The riders: the port's plain-torch modules on the card at the
   2144x4096 frame.  ``dwt2_fix``/``idwt2_fix`` in FIX32 (CDF 9/7) and
   FIX16 (CDF 5/3) equal the CPU's bit for bit; ``fdwt2_interleaved`` J=5
   f32 through ``interleaved_to_packed2`` is within 5e-4 of ``fdwt2``, and
   the int32 CDF 5/3 interleaved round trip is exact; ``swt2`` J=3, one
   NSLS level each way and ``eaw_wavedec2``/``eaw_waverec2`` J=2 round trip
   on the frame to 1e-3 (SWT in the interior) and, on a 256x512 crop,
   agree with the CPU port (SWT and EAW 5e-4, NSLS 3e-5); and
   ``features.denoise2(x + noise, 'cdf97', 5, impl='fused')`` launches B2,
   B3, B5 and B6 once each (counts set to 0 just before it) and is within
   1e-3 of ``impl='separable'``.  Each rider's time with CUDA events.
7. The tools: the frame quantized to 8 bits, written as a P5 PGM and a
   FLOAT EXR; ``Image.load_pgm`` on the card == the CPU load bit for bit;
   ``Image.wavedec('cdf97', 5, impl='fused')`` launches B2 and B3 once
   each and ``api.waverec2(impl='fused')`` B5 and B6 (5e-4 from the
   oracle, round trip 1e-3); ``save_pgm`` rewrites the same bytes and
   ``Image.load_exr`` gives the frame back exactly;
   ``Volume.fill_test(64, 512, 512).wavedec('cdf97', 2)`` launches B14
   twice (5e-4); ``selftest(device='cuda')`` is all True with B1 and B4
   once per fused wavelet; ``interop.transform`` of a 2144x4096x3
   channels-last frame both ways (round trip 1e-3; a 256x512 crop == the
   CPU port within 1e-5); ``gabor_ft``/``gabor_wt``/``gabor_st`` at 128
   bins on 16 signals of 65,536 samples (the first held to the CPU port:
   magnitude 1e-4 of its max, phase 1e-3 where the magnitude exceeds 1e-3
   of its max); ``perf.measure_perf_2d`` of the fused pyramid at
   256-4096, ``perf.info()`` and ``python -m libdwt_torch --json``.  Each
   call's time with CUDA events (median of 5 windows of ``--reps`` calls).
8. The measured 'auto' table (before 6.): ``autotune.tune_dispatch`` at
   1024 and 2144x4096 (J=3) and ``tune_dispatch3`` at 64x512x512 with its
   subprocess probes, into a temporary tune file: no candidate failed,
   every probe ok in both directions, each candidate launched its kernels
   on every frame (separable none); ``autotune_dwt2`` of the frame runs
   B1 at its tiles.  Then, with no tune file, the packaged table
   (``libdwt_torch/data/autotune.json``): the default ``api.wavedec2`` /
   ``waverec2`` of the frame at J=5 and ``wavedec3`` / ``waverec3`` of the
   volume at J=2 launch what the same calls with the table's choices
   named as ``impl`` launch, equal them bit for bit, and pass the
   oracle's gates (5e-4, round trip 1e-3); their times by events and
   CUPTI beside the explicit calls' and the same default calls' with an
   empty table (the built-in thresholds).
9. The example programs (last): each of the 34 programs of
   ``examples_torch/`` at its default arguments (files into a temporary
   directory), run in this process on the card and held against the same
   program with ``--device cpu`` (exit code 0, printed lines and files
   within the CPU tests' tolerances, ``examples_torch/_compare.py``); the
   perf programs (``perf_line``, ``perf_sweep``, ``perf_plot``) at their
   defaults on the card alone (a row with positive, finite times for each
   size, for ``perf_plot`` each size x direction x impl that
   ``autotune._pyramid_candidates`` offers, and no failed candidate), then
   against the CPU at their small arguments; ``cores`` launches B1 once
   per fused wavelet, ``denoise`` the packaged table's B3 and B6,
   ``accel_matrix``'s fused cells B3/B6 and streamed cells B11/B12,
   ``similarity``'s and ``perf_sweep``'s 'auto' calls what the table's
   choice named as ``impl`` launches, ``perf_plot``'s candidates their
   impl's kernels on every frame (separable none), the others no kernel
   (counts set to 0 before each program); a ``time example`` line each
   and the phase's wall time.
Then it prints the card's name and power limit, a JSON line of kernels,
and last the contract line.

Exits non-zero, printing no result line, when there is no CUDA device
or any check fails.  Needs one card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

# (memory bytes/s, float32 non-tensor-core FLOP/s, dense bf16 tensor-core
# FLOP/s) by card, from NVIDIA's data sheets; matched against
# torch.cuda.get_device_name in order.
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51.2e12, 756e12),
    ("H100 NVL", 3.9e12, 60.0e12, 835e12),
    ("H200", 4.8e12, 67.0e12, 989e12),
    ("H100", 3.35e12, 67.0e12, 989e12),
)
#: float ops per pixel per level of a 4-step lifting pass on both axes:
#: per axis 4 steps x 3 ops on half the samples, plus one scale multiply.
OPS_PER_PIXEL_LEVEL = 13
#: the same per voxel of a 3-D level: three axes, three scale multiplies.
OPS_PER_VOXEL_LEVEL = 21


def card_peaks(name: str):
    for key, bw, fl, tc in CARD_PEAKS:
        if key in name:
            return bw, fl, tc
    raise SystemExit(f"no peak rates known for card {name!r}")


def band_ops_per_sample(wavelet) -> float:
    """Tensor-core flops the banded body (B13) needs per sample of one 1-D
    pass: 5 bf16 products x 2 flops x the band's taps (an interior row
    pair of the pass matrix, averaged over the two parities)."""
    from libdwt_torch.ops import banded

    m = banded.lift_matrix(64, wavelet)
    return 5 * 2 * float((m[30:32] != 0).sum()) / 2


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def max_abs(a, b) -> float:
    import torch

    if isinstance(a, (list, tuple)):
        return max(max_abs(p, q) for p, q in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def leaves(tree):
    """Leaves of a pyramid, band tuple or band dict (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def time_ms(fn, reps: int, warm: int = 2) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def windows_ms(fn, reps: int, windows: int = 5):
    """Event times per call of ``fn`` over ``windows`` windows of ``reps``
    calls each, sorted (host-paced streams of small ops vary from window to
    window: report the median and the range)."""
    import torch

    torch.cuda.synchronize()
    return sorted(time_ms(fn, reps, warm=0) for _ in range(windows))


def print_windows(label: str, times, reps: int, smi: str) -> None:
    for name, ms in times.items():
        print(f"time {label} {name}: median {ms[len(ms) // 2]:.4f} ms, "
              f"{len(ms)} windows of {reps} calls from {ms[0]:.4f} to {ms[-1]:.4f} ms "
              f"[{smi}]", flush=True)


def device_ms(fn, reps: int = 5, tries: int = 3, only: str | None = None,
              skip: str | None = None):
    """Device time per call of ``fn`` (torch.profiler, CUPTI): the kernels'
    own time without the host's cost of issuing them, which event times
    over back-to-back calls include once a kernel is faster than its
    wrapper.  With ``only``, just the device records whose name holds it
    count (one kernel, without the copies its wrapper makes); with
    ``skip``, the records whose name holds it do not count.  A profiled
    pass whose device records are not a whole number per call has lost
    some (the trace can drop them in a process's first passes) and is said
    so and taken again, up to ``tries`` passes; None if no pass records
    every call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and (
                    only is None or only in e.key) and (skip is None or skip not in e.key):
                us += getattr(e, "self_device_time_total", None) or getattr(
                    e, "self_cuda_time_total", 0)
                n += e.count
        if us > 0 and n % reps == 0:
            return us / 1e3 / reps
        print(f"device time: a profiled pass recorded {n} device records for {reps} "
              f"calls; taken again", flush=True)
    return None


def profile_path(label: str, run, smi: str) -> None:
    """Device time by kernel name and the device's busy share over one run
    of a path (torch.profiler, CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            by_name[e.key] = (us, e.count)
    busy = sum(us for us, _ in by_name.values())
    if not by_name:
        print(f"profile {label}: no device time recorded (not measured)")
        return
    print(f"profile {label} ({smi}): wall {wall_us:.1f} us, "
          f"device busy {busy:.1f} us ({100 * busy / wall_us:.1f}%)")
    for key, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"profile   {us:10.1f} us  x{n:<3d} {key[:90]}")


def volume_feed(label: str, shape3, itemsize: int) -> None:
    """Print the feed of the last B14 launch (a ``shape3`` volume), which
    must be the one ops/fused3d.py's feed_of names (B15 has one feed, B17's
    chunk copies)."""
    from libdwt_torch.ops import fused3d as F3

    got = F3.LAST_FEED["B14"]
    want = F3.feed_of(shape3, F3._default_tile(None, itemsize), itemsize)
    print(f"volume feeds {label}: B14 {got}, B15 copies", flush=True)
    require(got == want, f"{label}: B14 took the feed feed_of names, {want}")


#: the streamed kernels on lines.cuh's walks (B8/B10: fused2l.cuh's bodies
#: in a strip walk; B11/B12: the same and deep.cuh's levels), held to their
#: plain versions bit for bit
EXACT_STREAMED = ("B8", "B10", "B11", "B12")
#: the volume kernels on the column z walk (csrc/volwalk.cuh: a z walk in
#: registers under the line walks of zwalk.cuh and lines.cuh), held to
#: their plain versions bit for bit at both levels
EXACT_VOLUME = ("B14", "B15", "B16", "B17")
#: the single-level kernel wrappers (B1, B4, B7, B9) that the sharded kernel
#: bodies and the explicit-'auto' pyramid call
LEVEL_WRAPPERS = ("fused_dwt2_level", "fused_idwt2_level", "streamed_dwt2_level",
                  "streamed_idwt2_level")


def spy_calls(module, names, run):
    """Runs ``run()`` with ``module.<name>`` wrapped, for each name in
    ``names``, so that the first call at each distinct set of argument
    shapes keeps its bound arguments; returns [(name, arguments)] in call
    order and puts the wrappers back."""
    import inspect

    kept, seen = [], set()
    saved = {n: getattr(module, n) for n in names}

    def spy(name, fn):
        sig = inspect.signature(fn)

        def wrapper(*a, **k):
            bound = sig.bind(*a, **k)
            bound.apply_defaults()
            key = (name, bound.arguments.get("boundary_rows")) + tuple(
                tuple(v.shape) for v in bound.arguments.values() if hasattr(v, "shape"))
            if key not in seen:
                seen.add(key)
                kept.append((name, dict(bound.arguments)))
            return fn(*a, **k)
        return wrapper

    for n, fn in saved.items():
        setattr(module, n, spy(n, fn))
    try:
        run()
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)
    return kept


def strip_phase(a, wavelet, ty: int = 0, tx: int = 0, body: str = "poly"):
    """B11 (``a`` a frame) or B12 (``a`` a two-level pyramid (LL2, level-2
    bands, level-1 bands)) launched with no deep level, straight through its
    C entry point (the wrappers take three levels or more): the strip phase
    alone; ``body='mxu'`` the banded instantiation; the strip ty x tx, or
    the body's default.  Returns (launch,
    outputs, info): B11's seven bands in B2's order, or B12's frame; info
    holds the last launch's (grid, co-resident blocks).  Launches are not
    counted."""
    import ctypes

    import torch

    from libdwt_torch.models.wavelets import get_wavelet
    from libdwt_torch.ops import _cuda
    from libdwt_torch.ops import fused as F
    from libdwt_torch.ops import streamed as S

    ty, tx = S.strip_shape(body, ty, tx)
    inverse = isinstance(a, (list, tuple))
    if inverse:
        ins = [a[0].contiguous()] + [b.contiguous() for t in a[1:] for b in t]
        h, w = 4 * ins[0].shape[0], 4 * ins[0].shape[1]
        out = torch.empty((h, w), dtype=ins[0].dtype, device=ins[0].device)
        ptrs, first, outs = ins, out, out
    else:
        h, w = a.shape
        q = [torch.empty((h // 4, w // 4), dtype=a.dtype, device=a.device) for _ in range(4)]
        b = [torch.empty((h // 2, w // 2), dtype=a.dtype, device=a.device) for _ in range(3)]
        ptrs, first, outs = q + b, a, (q[0], tuple(q[1:]), tuple(b))
    name, extra = "dwt_sdeep_inv" if inverse else "dwt_sdeep_fwd", []
    if body == "mxu":
        from libdwt_torch.ops import banded

        name += "_mxu"
        extra = [ctypes.byref(banded.kernel_mats(wavelet, inverse, ty, tx, first.device))]
    fn = _cuda.kernel_fn(name, F._suffix(first.dtype))
    params = F._lift_params(get_wavelet(wavelet), first.dtype == torch.int32, inverse)
    arr = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])
    info = (ctypes.c_int * 2)()

    def launch():
        _cuda.check(fn(first.data_ptr(), arr, 0, h, w, ty, tx, F.TILE1, info,
                       ctypes.byref(params), *extra, torch.cuda.current_stream().cuda_stream),
                    "strip phase")
    return launch, outs, info


def ptxas_registers(log: str, patterns) -> list:
    """[(kernel, registers, spill line)] of the ``ptxas -v`` log's entry
    functions whose mangled names hold one of ``patterns``."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            if any(p in name for p in patterns):
                out.append((name, int(line.split("Used")[1].split()[0]), spill))
            name = None
    return out


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    print(f"ok  {what}", flush=True)


TUNE_VAR = "LIBDWT_TORCH_TUNE_FILE"


@contextlib.contextmanager
def tune_table(table):
    """Run the block with ``LIBDWT_TORCH_TUNE_FILE`` naming a temporary
    file that holds ``table`` (``{}`` pins 'auto' to its built-in
    thresholds), or with the variable unset for None (the packaged
    table); the table cache is cleared on entry and on exit."""
    from libdwt_torch import autotune as AT

    old = os.environ.pop(TUNE_VAR, None)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            if table is not None:
                os.environ[TUNE_VAR] = os.path.join(tmp, "autotune.json")
                with open(os.environ[TUNE_VAR], "w") as f:
                    json.dump(table, f)
            AT.clear_cache()
            yield
    finally:
        os.environ.pop(TUNE_VAR, None)
        if old is not None:
            os.environ[TUNE_VAR] = old
        AT.clear_cache()


#: the tuner's 2-D sizes in the smoke: a square bucket and the frame's
TUNE_SIZES = (1024, (2144, 4096))
TUNE_TRIALS = 3
#: each candidate's kernels: it must launch one of ``need``, and nothing
#: outside ``allowed`` (the streamed pyramids end on the fused tail)
FUSED_2D = {"B1", "B2", "B3", "B4", "B5", "B6"}
STREAMED_2D = {"B7", "B8", "B9", "B10", "B11", "B12"}
CANDIDATE_KERNELS = {
    "fused": (FUSED_2D, FUSED_2D),
    "streamed": (STREAMED_2D, STREAMED_2D | FUSED_2D),
    "streamed-mxu": ({"B13"}, STREAMED_2D | FUSED_2D | {"B13"}),
}
VOLUME_KERNELS = {("fwd", "fused"): "B14", ("inv", "fused"): "B15",
                  ("fwd", "streamed"): "B16", ("inv", "streamed"): "B17"}


def autotune_phase(x, v, J: int, J3: int, want, want3, reps: int, smi: str) -> None:
    """The measured 'auto' table on the card.  (1) ``tune_dispatch`` at
    1024 and 2144x4096 (J=3) and ``tune_dispatch3`` at the volume, probes
    on, into a temporary tune file: every candidate measured (none
    failed), every probe ok in both directions, each candidate's kernels
    launched on every frame; ``autotune_dwt2`` of the frame (B1 at each
    tile).  (2) The packaged table (the variable unset, no tune file):
    the default ``api.wavedec2``/``waverec2`` of the frame at J and
    ``wavedec3``/``waverec3`` of the volume at J3 launch what the same
    calls with the table's choice named as ``impl`` launch and equal them
    bit for bit, within the reference's gates (5e-4 vs the oracle, 1e-3
    round trip); their event and device times beside the explicit
    calls'."""
    import torch

    from libdwt_torch import api
    from libdwt_torch import autotune as AT
    from libdwt_torch.ops import fused as F

    WV = "cdf97"
    H, W = x.shape
    name = torch.cuda.get_device_name(0)
    bw = AT._nominal_bw_gbps(name)

    # ---- (1) the tuner, each candidate's launches counted
    ran = {}
    saved = {n: getattr(AT, n) for n in
             ("_pyramid_candidates", "_volume_candidates", "_chain_slope_secs")}

    def tagged(cands_fn, dim):
        def cands(*a, **k):
            out = cands_fn(*a, **k)
            direction = a[2] if len(a) > 2 else k.get("direction", "fwd")
            for cand, fn in out:
                fn.cand = (dim, direction, cand)
            return out
        return cands

    def counted(fn, stacks, trials=8):
        torch.cuda.synchronize()
        F.reset_counters()
        res = saved["_chain_slope_secs"](fn, stacks, trials)
        torch.cuda.synchronize()
        frames = sum(len(s) for s in stacks.values()) * (1 + trials)
        shape = "x".join(map(str, next(iter(stacks.values())).shape[1:]))
        ran[(shape,) + fn.cand] = (frames, {k: s.launches for k, s in F.KERNELS.items()
                                            if s.launches})
        return res

    t0 = time.perf_counter()
    AT._pyramid_candidates = tagged(saved["_pyramid_candidates"], "2d")
    AT._volume_candidates = tagged(saved["_volume_candidates"], "3d")
    AT._chain_slope_secs = counted
    try:
        with tune_table({}):
            mine = AT.tune_dispatch(sizes=TUNE_SIZES, wavelet=WV, levels=3,
                                    trials=TUNE_TRIALS)
            mine = AT.tune_dispatch3(tuple(v.shape), wavelet=WV, trials=TUNE_TRIALS)
            F.reset_counters()
            cfg = AT.autotune_dwt2((H, W), WV, trials=TUNE_TRIALS)
            torch.cuda.synchronize()
            b1 = F.KERNELS["B1"].launches
    finally:
        for n, fn in saved.items():
            setattr(AT, n, fn)
    wall = time.perf_counter() - t0
    for key, entry in sorted(mine.items()):
        print(f"tuned {key} ({name}): winner {entry.get('impl')}, secs "
              + ", ".join(f"{c} {t:.4e} ({entry['estimator'][c]})"
                          for c, t in sorted(entry.get("secs", {}).items(), key=lambda kv: kv[1]))
              + (f", dropped {json.dumps(entry['dropped'])}" if entry.get("dropped") else "")
              + (f", probe {json.dumps(entry['probe'])}" if "probe" in entry else "")
              + f" [{smi}]", flush=True)
        require(not entry.get("failed"), f"tuned {key}: no candidate failed "
                f"({json.dumps(entry.get('failed', {}))})")
    findings = AT.validate_table(mine, bw)
    print(f"tuned table: validate_table at {bw:g} GB/s: {findings or 'no findings'}", flush=True)
    for d, suffix in (("fwd", ""), ("inv", ":inv")):
        entry = mine[f"vol:float32:{WV}{suffix}"]
        want_probe = {c: "ok" for c in entry["secs"] if c != "separable"}
        require(entry.get("probe") == want_probe,
                f"tuned vol:{d}: every kernel candidate's probe ran its {d} kernel "
                f"in a fresh process, ok ({json.dumps(entry.get('probe'))})")
    for (shape, dim, d, cand), (frames, got) in sorted(ran.items()):
        print(f"tuned {shape} {d} {cand}: {frames} frames launched {json.dumps(got)}",
              flush=True)
        if cand == "separable":
            require(got == {}, f"tuned {shape} {d} separable launched no kernel")
        elif dim == "3d":
            k = VOLUME_KERNELS[(d, cand)]
            require(got == {k: frames}, f"tuned {shape} {d} {cand} launched {k} on "
                    f"each of its {frames} volumes")
        else:
            need, allowed = CANDIDATE_KERNELS[cand]
            require(set(got) & need and set(got) <= allowed
                    and all(n % frames == 0 for n in got.values()),
                    f"tuned {shape} {d} {cand} launched its kernels on each of its "
                    f"{frames} frames")
    require(len({k[:3] for k in ran}) == 2 * len(TUNE_SIZES) + 2 and
            {k[3] for k in ran} >= {"separable", "fused", "streamed", "streamed-mxu"},
            "the tuner measured every candidate at every size, both directions")
    print(f"autotune_dwt2 {H}x{W}: {json.dumps(cfg)}, B1 launches {b1}", flush=True)
    require(b1 > 0, f"autotune_dwt2 {H}x{W} ran B1 at its tiles")
    print(f"time tuner (tune_dispatch at {TUNE_SIZES}, tune_dispatch3 at "
          f"{tuple(v.shape)} with probes, autotune_dwt2; trials {TUNE_TRIALS}): "
          f"{wall:.1f} s wall [{smi}]", flush=True)

    # ---- (2) the packaged table drives the default path
    with tune_table(None):
        path = AT.tune_file()
        require(not os.path.exists(path), f"no tune file at {path}: 'auto' reads the "
                "packaged table")
        packaged = AT._load_disk().get(name, {})
        require(bool(packaged), f"the packaged table has rows for {name}")
        for d in ("fwd", "inv"):
            print(f"packaged table ({name}): dispatch_choice({H}, {W}, float32, {WV}, {d}) = "
                  f"{AT.dispatch_choice(H, W, torch.float32, WV, d)}, volume_choice(float32, "
                  f"{WV}, {d}) = {AT.volume_choice(torch.float32, WV, d)}", flush=True)
        f32 = torch.float32
        pick = {"2d fwd": api._pick_impl(H, W, WV, None, True, f32, levels=J),
                "2d inv": api._pick_impl(H, W, WV, None, True, f32, levels=J, direction="inv"),
                "3d fwd": api._pick_impl3(tuple(v.shape), WV, None, True, f32, "fwd"),
                "3d inv": api._pick_impl3(tuple(v.shape), WV, None, True, f32, "inv")}
        print("packaged table: 'auto' picks " + json.dumps(pick), flush=True)
        paths = (
            (f"{H}x{W} J={J}", x, want, 5e-4,
             lambda: api.wavedec2(x, WV, J), lambda c: api.waverec2(c, WV),
             lambda: api.wavedec2(x, WV, J, impl=pick["2d fwd"]),
             lambda c: api.waverec2(c, WV, impl=pick["2d inv"])),
            (f"{'x'.join(map(str, v.shape))} J={J3}", v, want3, 5e-4,
             lambda: api.wavedec3(v, WV, J3), lambda c: api.waverec3(c, WV),
             lambda: api.wavedec3(v, WV, J3, impl=pick["3d fwd"]),
             lambda c: api.waverec3(c, WV, impl=pick["3d inv"])),
        )
        for label, a, oracle, tol, dec, rec, dec_x, rec_x in paths:
            def launched(run):
                torch.cuda.synchronize()
                F.reset_counters()
                out = run()
                torch.cuda.synchronize()
                return out, {k: s.launches for k, s in F.KERNELS.items() if s.launches}

            c, l_dec = launched(dec)
            r, l_rec = launched(lambda: rec(c))
            cx, lx_dec = launched(dec_x)
            rx, lx_rec = launched(lambda: rec_x(c))
            print(f"default {label}: forward launches {json.dumps(l_dec)}, inverse "
                  f"{json.dumps(l_rec)}", flush=True)
            require(l_dec == lx_dec and l_rec == lx_rec,
                    f"default {label} launched what the table's impls named explicitly "
                    f"launch ({json.dumps(lx_dec)}, {json.dumps(lx_rec)})")
            require(max_abs(leaves(c), leaves(cx)) == 0 and max_abs(r, rx) == 0,
                    f"default {label} == the explicit impls bit for bit, both ways")
            err = max_abs(leaves(c), leaves(oracle))
            require(err <= tol, f"default {label} vs separable oracle max|diff| {err:.3e} "
                    f"<= {tol:g}")
            err = max_abs(r, a)
            require(err <= 1e-3, f"default {label} round trip max|err| {err:.3e} <= 1e-3")
            times = {"default forward": windows_ms(dec, reps),
                     "explicit forward": windows_ms(dec_x, reps),
                     "default inverse": windows_ms(lambda: rec(c), reps),
                     "explicit inverse": windows_ms(lambda: rec_x(c), reps)}
            with tune_table({}):  # the default before the table: the thresholds
                times["no-table forward"] = windows_ms(dec, reps)
                times["no-table inverse"] = windows_ms(lambda: rec(c), reps)
            print_windows(f"default {label}", times, reps, smi)
            # one direction a measurement: a pass whose trace drops a whole
            # kernel's records is then caught by the whole-number check
            dev_ms = {k: device_ms(fn, tries=6) for k, fn in (
                ("default forward", dec), ("explicit forward", dec_x),
                ("default inverse", lambda: rec(c)), ("explicit inverse", lambda: rec_x(c)))}
            print(f"time default {label} device (CUPTI): " + ", ".join(
                f"{k} {'not measured' if t is None else f'{t:.4f} ms'}"
                for k, t in dev_ms.items()) + f" [{smi}]", flush=True)
            profile_path(f"default {label} (no impl: the packaged table)",
                         lambda: rec(dec()), smi)


#: the CPU crop of the frame on which the riders on the card are held to
#: the port's CPU result (the full frame runs on the card only)
RIDER_CROP = (256, 512)


def riders(x, seed: int, reps: int, smi: str) -> None:
    """The plain-torch modules on the card at the bench frame ``x``: fixed
    point (bit for bit == the CPU), the interleaved layout, SWT, NSLS, EAW
    (== the CPU port on a crop, and round trips on the frame), and
    ``denoise2(impl='fused')``, which runs B2, B3, B5 and B6 once each."""
    import numpy as np
    import torch

    from libdwt_torch.ops import eaw, features, interleaved, nsls, swt
    from libdwt_torch.ops import fused as F
    from libdwt_torch.ops import separable as sep
    from libdwt_torch.utils import fix

    H, W = x.shape
    cpu = x.cpu()
    times = {}

    def timed(name, fn):
        out = fn()
        times[name] = windows_ms(fn, reps)
        return out

    # ---- fixed point: FIX32 CDF 9/7 and FIX16 CDF 5/3, bit for bit == CPU
    for q, wv in ((fix.FIX32, "cdf97"), (fix.FIX16, "cdf53")):
        xq = fix.to_fix(x, q)
        bands = timed(f"dwt2_fix {q.name} {wv}", lambda: fix.dwt2_fix(xq, wv, q))
        back = timed(f"idwt2_fix {q.name} {wv}", lambda: fix.idwt2_fix(*bands, wv, q))
        cq = fix.to_fix(cpu, q)
        cb = fix.dwt2_fix(cq, wv, q)
        ok = (torch.equal(xq.cpu(), cq) and all(torch.equal(a.cpu(), b) for a, b in zip(bands, cb))
              and torch.equal(back.cpu(), fix.idwt2_fix(*cb, wv, q)))
        require(ok and xq.dtype == q.dtype and xq.is_cuda,
                f"riders: dwt2_fix/idwt2_fix {q.name} {wv} {H}x{W} on the card == CPU bit for bit")
        err = float((fix.from_fix(back, q) - x).abs().max())
        print(f"riders: {q.name} {wv} round trip max|err| {err:.3e} (quantized)", flush=True)

    # ---- the interleaved layout: J=5 f32 vs the packed transform, int32 exact
    inter = timed("fdwt2_interleaved J=5 f32",
                  lambda: interleaved.fdwt2_interleaved(x, "cdf97", 5))
    err = max_abs(interleaved.interleaved_to_packed2(inter, 5), sep.fdwt2(x, "cdf97", 5))
    require(err <= 5e-4, f"riders: interleaved J=5 {H}x{W} f32 -> packed vs fdwt2 max|diff| "
            f"{err:.3e} <= 5e-4")
    rec = timed("idwt2_interleaved J=5 f32",
                lambda: interleaved.idwt2_interleaved(inter, "cdf97", 5))
    err = max_abs(rec, x)
    require(err <= 1e-3, f"riders: interleaved J=5 round trip max|err| {err:.3e} <= 1e-3")
    xi = (x * 255).to(torch.int32)
    yi = interleaved.fdwt2_interleaved(xi, "cdf53", 5)
    require(torch.equal(interleaved.idwt2_interleaved(yi, "cdf53", 5), xi)
            and torch.equal(interleaved.interleaved_to_packed2(yi, 5), sep.fdwt2(xi, "cdf53", 5)),
            "riders: int32 CDF 5/3 interleaved J=5 round trip exact, == packed fdwt2")

    # ---- SWT J=3, one NSLS level, EAW J=2: the frame on the card (round
    # trips), a crop on the card vs the CPU port (the tests' bounds)
    sc = timed("swt2 J=3", lambda: swt.swt2(x, "cdf97", 3))
    sr = timed("iswt2 J=3", lambda: swt.iswt2(sc, "cdf97"))
    m = 16 * 8  # the SWT clamps borders and the DWT mirrors: the interior
    err = max_abs(sr[m:-m, m:-m], x[m:-m, m:-m])
    require(err <= 1e-3, f"riders: swt2/iswt2 J=3 {H}x{W} interior round trip max|err| "
            f"{err:.3e} <= 1e-3")
    nb = timed("nsls_dwt2_level", lambda: nsls.nsls_dwt2_level(x, "cdf97"))
    nr = timed("nsls_idwt2_level", lambda: nsls.nsls_idwt2_level(*nb, "cdf97"))
    err = max_abs(nr, x)
    require(err <= 1e-3, f"riders: NSLS level round trip max|err| {err:.3e} <= 1e-3")
    err = max_abs(list(nb), list(sep.dwt2_level(x, "cdf97")))
    require(err <= 3e-5, f"riders: NSLS level vs dwt2_level max|diff| {err:.3e} <= 3e-5")
    ec, ew = timed("eaw_wavedec2 J=2", lambda: eaw.eaw_wavedec2(x, "cdf97", 2))
    er = timed("eaw_waverec2 J=2", lambda: eaw.eaw_waverec2(ec, ew, "cdf97"))
    err = max_abs(er, x)
    require(err <= 1e-3, f"riders: EAW J=2 round trip max|err| {err:.3e} <= 1e-3")

    ch, cw = RIDER_CROP
    crop = x[:ch, :cw].contiguous()
    ccpu = crop.cpu()
    checks = (
        ("swt2 J=3", 5e-4, lambda a: swt.swt2(a, "cdf97", 3)),
        ("nsls_dwt2_level", 3e-5, lambda a: list(nsls.nsls_dwt2_level(a, "cdf97"))),
        ("nsls_idwt2_level", 3e-5,
         lambda a: nsls.nsls_idwt2_level(*sep.dwt2_level(a, "cdf97"), "cdf97")),
        ("eaw_wavedec2 J=2", 5e-4, lambda a: eaw.eaw_wavedec2(a, "cdf97", 2)[0]),
        ("eaw_waverec2 J=2", 5e-4,
         lambda a: eaw.eaw_waverec2(*eaw.eaw_wavedec2(a, "cdf97", 2), "cdf97")),
    )
    for name, tol, fn in checks:
        got, want = leaves(fn(crop)), leaves(fn(ccpu))
        err = max_abs([g.cpu() for g in got], want)
        require(all(g.is_cuda for g in got) and err <= tol,
                f"riders: {name} {ch}x{cw} crop on the card vs the CPU port max|diff| "
                f"{err:.3e} <= {tol:g}")

    # ---- denoise2 on the fused main path: B2, B3, B5, B6 once each
    rng = np.random.default_rng(seed + 1)
    noisy = x + torch.from_numpy(0.1 * rng.standard_normal((H, W), dtype=np.float32)).to(x.device)
    torch.cuda.synchronize()
    F.reset_counters()
    den = features.denoise2(noisy, "cdf97", 5, impl="fused")
    torch.cuda.synchronize()
    got_l = {k: F.KERNELS[k].launches for k in F.KERNELS if F.KERNELS[k].launches}
    print("denoise2 launches: " + json.dumps(got_l), flush=True)
    require(got_l == {"B2": 1, "B3": 1, "B5": 1, "B6": 1},
            "riders: denoise2(impl='fused') launched B2, B3, B5, B6 once each")
    den_sep = features.denoise2(noisy, "cdf97", 5, impl="separable")
    err = max_abs(den, den_sep)
    print(f"riders: denoise2 fused vs separable max|diff| {err:.3e}", flush=True)
    require(bool(torch.isfinite(den).all()) and err <= 1e-3,
            f"riders: denoise2 {H}x{W} J=5 fused vs separable max|diff| {err:.3e} <= 1e-3")
    timed("denoise2 fused", lambda: features.denoise2(noisy, "cdf97", 5, impl="fused"))
    timed("denoise2 separable", lambda: features.denoise2(noisy, "cdf97", 5, impl="separable"))
    print_windows("rider", {f"{k} ({H}x{W})": v for k, v in times.items()}, reps, smi)
    profile_path("denoise2 impl='fused' (wavedec2 + thresholds + waverec2)",
                 lambda: features.denoise2(noisy, "cdf97", 5, impl="fused"), smi)


#: the Gabor planes on the card: 16 seeded signals of 65,536 samples
#: (1 M samples a call) at 128 bins; the CPU port holds the first signal
GABOR_SIGNALS, GABOR_N, GABOR_BINS = 16, 65536, 128
#: the square sizes of the perf sweep of the fused pyramid
PERF_SIZES = (256, 512, 1024, 2048, 4096)


def tools(x, seed: int, reps: int, smi: str, flops: float) -> None:
    """The tools path on the card: ``Image`` through PGM and EXR files and
    the fused pyramid (B2, B3, B5, B6), ``Volume.wavedec`` (B14 twice),
    ``selftest`` (B1/B4 once per fused wavelet), ``interop.transform`` of a
    channels-last frame, the Gabor planes, the perf sweep, ``perf.info`` and
    ``python -m libdwt_torch --json``."""
    import math
    import os
    import tempfile

    import numpy as np
    import torch

    from libdwt_torch import REGISTRY, api, interop
    from libdwt_torch.image import Image, Volume
    from libdwt_torch.ops import fused as F
    from libdwt_torch.ops import gabor
    from libdwt_torch.ops import separable as sep
    from libdwt_torch.selftest import selftest
    from libdwt_torch.utils import io as dio
    from libdwt_torch.utils import perf

    H, W = x.shape
    times = {}

    def timed(name, fn):
        out = fn()
        times[name] = windows_ms(fn, reps)
        return out

    def launches_of(run):
        """Runs ``run`` with the counts set to 0 just before it; returns
        its result and the kernels it launched."""
        torch.cuda.synchronize()
        F.reset_counters()
        out = run()
        torch.cuda.synchronize()
        return out, {k: s.launches for k, s in F.KERNELS.items() if s.launches}

    with tempfile.TemporaryDirectory() as tmp:
        # ---- the image path: the frame quantized to 8 bits, as a P5 PGM and
        # a FLOAT EXR; loaded onto the card; the fused pyramid both ways
        q = np.trunc(x.cpu().numpy().astype(np.float64) * 255.0).astype(np.float32)
        x8 = q / np.float32(255)  # what an 8-bit load gives back
        pgm, pgm2, exr = (os.path.join(tmp, n) for n in ("f.pgm", "g.pgm", "f.exr"))
        dio.save_pgm(pgm, x8, binary=True)
        dio.write_exr(exr, x8)
        img = Image.load_pgm(pgm)
        cpu_img = Image.load_pgm(pgm, device="cpu")
        require(img.data.is_cuda and torch.equal(img.data.cpu(), cpu_img.data)
                and torch.equal(cpu_img.data, torch.from_numpy(x8)),
                f"tools: Image.load_pgm {H}x{W} P5 on the card == the CPU load bit for bit")
        coeffs, fwd_l = launches_of(lambda: img.wavedec("cdf97", 5, impl="fused"))
        rec, inv_l = launches_of(lambda: api.waverec2(coeffs, "cdf97", impl="fused"))
        print(f"tools: Image.wavedec launches {json.dumps(fwd_l)}, api.waverec2 launches "
              f"{json.dumps(inv_l)}", flush=True)
        require(fwd_l == {"B2": 1, "B3": 1} and inv_l == {"B5": 1, "B6": 1},
                "tools: Image.wavedec('cdf97', 5, impl='fused') launched B2 and B3 once each, "
                "api.waverec2 B5 and B6 once each")
        err = max_abs(leaves(coeffs), leaves(sep.wavedec2(img.data, "cdf97", 5)))
        require(err <= 5e-4, f"tools: Image.wavedec vs separable oracle max|diff| {err:.3e} "
                "<= 5e-4")
        err = max_abs(rec, img.data)
        require(err <= 1e-3, f"tools: Image round trip max|err| {err:.3e} <= 1e-3")
        img.save_pgm(pgm2, binary=True)
        with open(pgm, "rb") as f1, open(pgm2, "rb") as f2:
            require(f1.read() == f2.read(),
                    "tools: save_pgm(binary=True) of the loaded image rewrites the same bytes")
        ex = Image.load_exr(exr)
        require(ex.data.is_cuda and torch.equal(ex.data.cpu(), torch.from_numpy(x8)),
                "tools: Image.load_exr == the written frame exactly")
        timed(f"Image.load_pgm P5 {H}x{W}", lambda: Image.load_pgm(pgm).data)
        timed(f"Image.wavedec cdf97 J=5 fused {H}x{W}",
              lambda: img.wavedec("cdf97", 5, impl="fused"))
        timed(f"api.waverec2 cdf97 J=5 fused {H}x{W}",
              lambda: api.waverec2(coeffs, "cdf97", impl="fused"))
        timed(f"Image.save_pgm P5 {H}x{W}", lambda: img.save_pgm(pgm2, binary=True))
        timed(f"Image.save_exr {H}x{W}", lambda: img.save_exr(exr))
        timed(f"Image.load_exr {H}x{W}", lambda: Image.load_exr(exr).data)

    # ---- Volume.wavedec J=2 with 'auto': B14 once a level
    vol = Volume.fill_test(64, 512, 512)
    with tune_table({}):  # the built-in 3-D rule: 'fused' wherever it runs
        vc, vol_l = launches_of(lambda: vol.wavedec("cdf97", 2))
    print(f"tools: Volume.wavedec launches {json.dumps(vol_l)}", flush=True)
    require(vol_l == {"B14": 2}, "tools: Volume.fill_test(64, 512, 512).wavedec('cdf97', 2) "
            "launched B14 twice")
    err = max_abs(leaves(vc), leaves(sep.wavedec3(vol.data, "cdf97", 2)))
    require(err <= 5e-4, f"tools: Volume.wavedec vs separable oracle max|diff| {err:.3e} <= 5e-4")
    timed("Volume.wavedec cdf97 J=2 64x512x512", lambda: vol.wavedec("cdf97", 2))

    # ---- selftest on the card: B1 then B4 for every fused wavelet
    rep, st_l = launches_of(lambda: selftest(device="cuda"))
    print(f"tools: selftest {sum(rep.values())}/{len(rep)} passed, launches "
          f"{json.dumps(st_l)}", flush=True)
    require(all(v is True for v in rep.values()) and rep.keys() == selftest(device="cpu").keys(),
            "tools: selftest(device='cuda') has the CPU's keys, every entry True")
    n_fused = sum(map(F.fused_supported, REGISTRY))
    require(st_l == {"B1": n_fused, "B4": n_fused},
            f"tools: selftest launched B1 and B4 once per fused wavelet ({n_fused})")
    timed("selftest(device='cuda')", lambda: selftest(device="cuda"))

    # ---- interop.transform of a channels-last 3-channel frame, both ways
    rng = np.random.default_rng(seed + 2)
    rgb = torch.from_numpy(rng.random((H, W, 3), dtype=np.float32)).to(x.device)
    fwd = timed(f"interop.transform forward {H}x{W}x3",
                lambda: interop.transform(rgb, interop.DWT_FORWARD))
    back = timed(f"interop.transform inverse {H}x{W}x3",
                 lambda: interop.transform(fwd, interop.DWT_INVERSE))
    err = max_abs(back, rgb)
    require(fwd.is_cuda and fwd.shape == rgb.shape and err <= 1e-3,
            f"tools: interop.transform {H}x{W}x3 channels-last round trip max|err| {err:.3e} "
            "<= 1e-3")
    ch, cw = RIDER_CROP
    crop = rgb[:ch, :cw].contiguous()
    for flags in (interop.DWT_FORWARD, interop.DWT_INVERSE):
        err = max_abs(interop.transform(crop, flags).cpu(), interop.transform(crop.cpu(), flags))
        require(err <= 1e-5, f"tools: interop.transform flags={flags} {ch}x{cw}x3 crop on the "
                f"card vs the CPU port max|diff| {err:.3e} <= 1e-5")

    # ---- the Gabor planes: 16 signals of 65,536 samples at 128 bins
    sigs = torch.from_numpy(rng.standard_normal((GABOR_SIGNALS, GABOR_N)).astype(np.float32)
                            ).to(x.device)
    planes = {
        "gabor_ft sigma=8": (lambda s, out="mag": gabor.gabor_ft(s, GABOR_BINS, 8.0, out),
                             gabor.gaussian_size(8.0, 1.0)),
        "gabor_wt sigma=2 freq=pi/2": (
            lambda s, out="mag": gabor.gabor_wt(s, GABOR_BINS, 2.0, math.pi / 2, out),
            gabor.gaussian_size(2.0, math.pi / 2 / (math.pi / GABOR_BINS))),
        "gabor_st": (lambda s, out="mag": gabor.gabor_st(s, GABOR_BINS, out),
                     gabor.gaussian_size(gabor.s_sigma(0.5 / GABOR_BINS), 1.0)),
    }
    for name, (fn, taps) in planes.items():
        mag = fn(sigs)
        arg = fn(sigs, "arg")
        torch.cuda.synchronize()
        require(tuple(mag.shape) == (GABOR_SIGNALS, GABOR_BINS, GABOR_N)
                and bool(torch.isfinite(mag).all()) and bool(torch.isfinite(arg).all()),
                f"tools: {name} {GABOR_SIGNALS}x{GABOR_N} at {GABOR_BINS} bins: "
                f"finite planes of the expected shape")
        m0, a0 = fn(sigs[0].cpu()).numpy(), fn(sigs[0].cpu(), "arg").numpy()
        peak = float(np.abs(m0).max())
        err = float(np.abs(mag[0].cpu().numpy() - m0).max())
        require(err <= 1e-4 * peak, f"tools: {name} magnitude on the card vs the CPU port "
                f"max|diff| {err:.3e} <= 1e-4 * max ({1e-4 * peak:.3e})")
        keep = m0 > 1e-3 * peak
        wrapped = np.abs(np.angle(np.exp(1j * (arg[0].cpu().numpy().astype(np.float64) - a0))))
        err = float(wrapped[keep].max())
        require(err <= 1e-3, f"tools: {name} phase on the card vs the CPU port (wrapped, where "
                f"magnitude > 1e-3 * max) max|diff| {err:.3e} <= 1e-3")
        del mag, arg
        ms = windows_ms(lambda: fn(sigs), reps)
        times[f"{name} {GABOR_SIGNALS}x{GABOR_N} bins={GABOR_BINS}"] = ms
        # 2 flops a multiply-add: 2*bins output channels (the real and the
        # imaginary bank) of the bank's taps at every sample
        ops = 2.0 * sigs.numel() * 2 * GABOR_BINS * taps
        print(f"time tools {name}: bank {taps} taps, {ops / 1e12:.3f} TFLOP a call, float32 "
              f"bound {ops / flops * 1e3:.4f} ms, median {ms[len(ms) // 2]:.4f} ms "
              f"({ops / (ms[len(ms) // 2] * 1e-3) / 1e12:.2f} TFLOP/s) [{smi}]", flush=True)
    profile_path(f"gabor_st {GABOR_SIGNALS}x{GABOR_N} bins={GABOR_BINS}",
                 lambda: planes["gabor_st"][0](sigs), smi)

    print_windows("tools", times, reps, smi)

    # ---- the perf sweep of the fused pyramid, perf.info and the CLI
    rows = perf.measure_perf_2d(lambda a: api.wavedec2(a, "cdf97", 5, impl="fused"),
                                sizes=PERF_SIZES)
    require([r[0] for r in rows] == list(PERF_SIZES) and all(r[1] > 0 for r in rows),
            "tools: perf.measure_perf_2d of the fused wavedec2 J=5 gave a row a size")
    for n, spp, mps in rows:
        print(f"perf measure_perf_2d wavedec2 cdf97 J=5 fused {n}x{n}: {spp * 1e9:.4f} ns a "
              f"pixel, {mps:.1f} Mpix/s (min of 5 fenced trials) [{smi}]", flush=True)
    inf = perf.info()
    print("perf.info: " + json.dumps(inf), flush=True)
    require(inf["platform"] == "gpu" and inf["device_kind"] == torch.cuda.get_device_name(),
            "tools: perf.info names the card")
    root = os.path.dirname(os.path.abspath(__file__))
    cli = subprocess.run([sys.executable, "-m", "libdwt_torch", "--json"], cwd=root,
                         capture_output=True, text=True, timeout=300)
    print("python -m libdwt_torch --json: " + cli.stdout.strip(), flush=True)
    require(cli.returncode == 0 and json.loads(cli.stdout)["platform"] == "gpu",
            "tools: python -m libdwt_torch --json ran and names the gpu")


#: the output paths of the programs whose defaults write under /tmp: files
#: go to the run's own working directory instead (sizes stay the defaults;
#: load and spectra_blobs write to the working directory already)
EXAMPLE_OUTPUTS = {"displ_vectors": ["--out", "displ_field.mat"],
                   "mra": ["--out", "mra"],
                   "wavelet_func2d": ["--out", "wavelet_func2d.pgm"],
                   "interop_subbands": ["--out", "."],
                   "io_roundtrip": ["--out", "dwtio"],
                   "perf_line": ["--out", "perf_line.tsv"],
                   "perf_plot": ["--out-dir", "perf-plot"],
                   "perf_sweep": ["--out", "perf.tsv"],
                   "spectra_dwt": ["--out-dir", "spectra-dwt"],
                   "spectra_fe": ["--out", "spectra.svm"],
                   "spectra_svm": ["--out", "spectra-svm"],
                   "spectra_swt": ["--out", "fv_swt.svm"],
                   "timefreq": ["--out", "tf"]}
#: the kernels each program launches on the card at its defaults: cores
#: B1 once per fused wavelet; denoise the packaged table's choice at 256
#: (fused both ways: J=4 is B3's deep tail, then B6); accel_matrix at 256,
#: J=3 by (impl, dtype) and call: fused the deep tails B3/B6, streamed the
#: one-launch pyramid B11/B12 (separable and the interleaved layout none)
EXAMPLE_LAUNCHES = {"cores": {"B1": 3}, "denoise": {"B3": 1, "B6": 1}}
ACCEL_LAUNCHES = {
    **{("fused", dt): {"wavedec2": {"B3": 1}, "waverec2": {"B6": 1}}
       for dt in ("float32", "int32")},
    **{("streamed", dt): {"wavedec2": {"B11": 1}, "waverec2": {"B12": 1}}
       for dt in ("float32", "int32")},
}
#: the perf programs: their times are measurements, not results.  They run
#: at their defaults on the card alone, then card against CPU at the small
#: arguments under the time rule
PERF_EXAMPLES = ("perf_line", "perf_sweep", "perf_plot")
#: the lines of their default runs that carry times: (pattern, the number
#: of such lines the defaults print)
PERF_ROWS = {
    "perf_line": (r"^  n=\s*(\d+): +(\S+) ns/sample +(\S+) Msamples/s$", 5),
    "perf_sweep": (r"^ *(\d+)\^2: +(\S+) ns/pixel +(\S+) Mpix/s$", 5),
}
PERF_PLOT_ROW = r"^(fwd|inv) +(\S+) +(\d+)x(\d+) +(\S+) ns/pixel \((slope|upper)\)$"


def _frame_of(n: str, a):
    """(the frame's (h, w), levels) of an api.wavedec2/waverec2 call."""
    if n == "wavedec2":
        from libdwt_torch.utils.subband import resolve_j

        x = a[0]
        level = a[2] if len(a) > 2 else None
        return tuple(x.shape[-2:]), resolve_j(x.shape[-2], x.shape[-1], level)
    c = a[0]
    return ((c[-1][0].shape[-2] + c[-1][1].shape[-2],
             c[-1][0].shape[-1] + c[-1][1].shape[-1]), len(c) - 1)


@contextlib.contextmanager
def pyramid_calls(calls: list):
    """Wrap ``api.wavedec2``/``api.waverec2`` for the block: each call on a
    CUDA tensor appends (function, impl, dtype name, the launches it made,
    the frame's (h, w), levels, wavelet).  A program that imports them by
    name while the block runs gets the wrappers."""
    import torch

    from libdwt_torch import api
    from libdwt_torch.ops import fused as F

    orig = {n: getattr(api, n) for n in ("wavedec2", "waverec2")}

    def wrap(n, fn):
        def call(*a, **kw):
            before = {k: st.launches for k, st in F.KERNELS.items()}
            out = fn(*a, **kw)
            first = a[0] if n == "wavedec2" else a[0][0]
            if isinstance(first, torch.Tensor) and first.is_cuda:
                torch.cuda.synchronize()
                shape, level = _frame_of(n, a)
                calls.append((n, kw.get("impl"), str(first.dtype).replace("torch.", ""),
                              {k: st.launches - before[k] for k, st in F.KERNELS.items()
                               if st.launches != before[k]},
                              shape, level, a[1] if len(a) > 1 else kw.get("wavelet", "cdf97")))
            return out
        return call

    for n, fn in orig.items():
        setattr(api, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(api, n, fn)


@contextlib.contextmanager
def candidate_calls(calls: list):
    """Wrap ``autotune._pyramid_candidates`` for the block: each call of a
    candidate's per-frame function on a CUDA tensor appends (direction,
    impl, the frame's (h, w), the launches it made).  No wait is added:
    the counts are kept on the host where the kernels are launched."""
    from libdwt_torch import autotune as AT
    from libdwt_torch.ops import fused as F

    orig = AT._pyramid_candidates

    def wrapped(wavelet, levels, direction="fwd", shape=None, **kw):
        out = []
        for impl, fn in orig(wavelet, levels, direction, shape=shape, **kw):
            def call(a, fn=fn, impl=impl):
                before = {k: st.launches for k, st in F.KERNELS.items()}
                res = fn(a)
                if a.is_cuda:
                    calls.append((direction, impl, tuple(a.shape[-2:]),
                                  {k: st.launches - before[k] for k, st in F.KERNELS.items()
                                   if st.launches != before[k]}))
                return res
            out.append((impl, call))
        return out

    AT._pyramid_candidates = wrapped
    try:
        yield
    finally:
        AT._pyramid_candidates = orig


def table_launches(n: str, shape, level: int, dtype: str, wavelet) -> tuple:
    """(the impl 'auto' picks for an api.wavedec2/waverec2 call on the card,
    the launches of the same call with that impl named): the inverse's
    input is the separable pyramid of a random frame."""
    import torch

    from libdwt_torch import api
    from libdwt_torch.ops import fused as F
    from libdwt_torch.ops.separable import wavedec2 as sep_wavedec2

    dt = getattr(torch, dtype)
    choice = api._pick_impl(shape[0], shape[1], wavelet, None, True, dt, levels=level,
                            direction="fwd" if n == "wavedec2" else "inv")
    x = torch.rand(shape, device="cuda").to(dt)
    c = sep_wavedec2(x, wavelet, level)
    torch.cuda.synchronize()
    F.reset_counters()
    if n == "wavedec2":
        api.wavedec2(x, wavelet, level, impl=choice)
    else:
        api.waverec2(c, wavelet, impl=choice)
    torch.cuda.synchronize()
    return choice, {k: st.launches for k, st in F.KERNELS.items() if st.launches}


def check_table_calls(name: str, calls: list) -> None:
    """Each 'auto' call of ``name`` launched what the table's choice named
    explicitly launches; checked once per distinct call."""
    groups = {}
    for n, impl, dt, made, shape, level, wavelet in calls:
        if impl is None:
            groups.setdefault((n, shape, level, dt, str(wavelet)), []).append(made)
    for (n, shape, level, dt, wavelet), mades in groups.items():
        choice, want = table_launches(n, shape, level, dt, wavelet)
        print(f"example {name} {n} {shape[0]}x{shape[1]} J={level} {dt}: table "
              f"'{choice}' launches " + json.dumps(mades[0]) + f" ({len(mades)} calls)",
              flush=True)
        require(all(m == want for m in mades),
                f"example {name} {n} {shape[0]}x{shape[1]} J={level}: each call launched "
                f"what '{choice}' named explicitly launches ({json.dumps(want)})")
    require(bool(groups), f"example {name} made its pyramid calls on the card")


def perf_defaults(name: str, tmp: str, smi: str) -> None:
    """A perf program at its defaults on the card alone: exit code 0, a row
    with positive, finite times for each size (perf_plot: each size x
    direction x impl that ``_pyramid_candidates`` offers), no failed
    candidate, and the kernels of each row launched."""
    import math
    import re

    import torch

    from examples_torch import _compare as C
    from libdwt_torch.ops import fused as F

    calls, cands = [], []
    with pyramid_calls(calls), candidate_calls(cands):
        torch.cuda.synchronize()
        F.reset_counters()
        got = C.run(C.path_of(name), EXAMPLE_OUTPUTS[name], os.path.join(tmp, name, "card"))
        torch.cuda.synchronize()
    launches = {k: st.launches for k, st in F.KERNELS.items() if st.launches}
    require(got.code == 0, f"example {name} at its defaults exits 0 on the card "
            f"({got.code}){got.err[-3000:]}")
    print(f"time example {name} (defaults, card alone): {got.seconds:.4f} s [{smi}]",
          flush=True)
    lines = got.out.splitlines()
    if name in PERF_ROWS:
        pattern, count = PERF_ROWS[name]
        rows = [m.groups() for m in map(re.compile(pattern).match, lines) if m]
        print(f"example {name} rows: " + json.dumps(rows), flush=True)
        require(len(rows) == count and all(0 < float(v) < math.inf
                                           for r in rows for v in r[1:]),
                f"example {name}: {count} rows, each with positive, finite times")
    if name == "perf_line":
        require(not launches, "example perf_line launched no kernel (the fdwt1 oracle)")
    elif name == "perf_sweep":
        check_table_calls(name, calls)
    elif name == "perf_plot":
        from libdwt_torch.autotune import _pyramid_candidates

        rows = {}
        for m in map(re.compile(PERF_PLOT_ROW).match, lines):
            if m:
                d, impl, h, w, ns, kind = m.groups()
                rows[(d, impl, int(h), int(w))] = (float(ns), kind)
        want = {(d, impl, n, n) for n in (256, 512, 1024, 2048) for d in ("fwd", "inv")
                for impl, _ in _pyramid_candidates("cdf97", 5, d, shape=(n, n),
                                                   dtype=torch.float32)}
        print("example perf_plot rows (ns/pixel, estimator): " + json.dumps(
            {f"{d} {impl} {h}x{w}": v for (d, impl, h, w), v in sorted(rows.items())}),
            flush=True)
        require(set(rows) == want and all(0 < ns < math.inf for ns, _ in rows.values()),
                f"example perf_plot: a row with a positive, finite time for each of the "
                f"{len(want)} size x direction x impl that _pyramid_candidates offers")
        require("failed" not in got.err, "example perf_plot: no candidate failed"
                + got.err[-2000:])
        per = {}
        for d, impl, shape, made in cands:
            per.setdefault((d, impl, shape), []).append(made)
        for (d, impl, shape), mades in sorted(per.items()):
            print(f"example perf_plot {d} {impl} {shape[0]}x{shape[1]} launches per frame: "
                  f"{json.dumps(mades[0])} ({len(mades)} frames)", flush=True)
            if impl == "separable":
                ok = all(m == {} for m in mades)
            else:
                need, allowed = CANDIDATE_KERNELS[impl]
                ok = (all(m == mades[0] for m in mades) and need & set(mades[0])
                      and set(mades[0]) <= allowed)
            require(bool(ok), f"example perf_plot {d} {impl} {shape[0]}x{shape[1]}: every "
                    f"frame launched the same kernels of its impl (separable none)")
        require({(d, impl, s[0], s[1]) for d, impl, s in per} == want,
                "example perf_plot: every row's candidate ran on the card")


def examples_phase(smi: str) -> None:
    """The 34 programs of ``examples_torch/`` (ROADMAP A.6a, A.6b) at their
    default arguments, run in this process on the card and held against
    the same program with ``--device cpu`` (``examples_torch/_compare.py``:
    exit codes 0, printed lines and files within the CPU tests'
    tolerances), each timed; the perf programs at their defaults on the
    card alone (rows, positive finite times, no failed candidate), then
    card against CPU at their small arguments.  ``cores``, ``denoise`` and
    ``accel_matrix`` launched the kernels of their paths, ``similarity``'s
    and ``perf_sweep``'s 'auto' calls the table's, ``perf_plot`` each
    candidate's, the others none (counts set to 0 just before each card
    run)."""
    import torch

    from examples_torch import _compare as C
    from libdwt_torch.ops import fused as F

    t0 = time.time()
    with tune_table(None), tempfile.TemporaryDirectory() as tmp:
        for name in C.PROGRAMS:
            if name in PERF_EXAMPLES:
                perf_defaults(name, tmp, smi)
                argv = C.SMALL_ARGS[name]
            else:
                argv = EXAMPLE_OUTPUTS.get(name, [])
            calls = []
            with pyramid_calls(calls):
                torch.cuda.synchronize()
                F.reset_counters()  # the CPU run launches nothing
                bad, want, got = C.run_pair(name, argv, "cuda", os.path.join(tmp, name))
                torch.cuda.synchronize()
            launches = {k: st.launches for k, st in F.KERNELS.items() if st.launches}
            require(want.code == 0 and got.code == 0,
                    f"example {name} exits 0 on the card and on the CPU "
                    f"({got.code}, {want.code}){got.err[-2000:]}{want.err[-2000:]}")
            require(not bad, f"example {name} on the card == --device cpu within the CPU "
                    f"tests' tolerances ({len(got.out.splitlines())} lines, "
                    f"{len(os.listdir(os.path.join(tmp, name, 'got')))} files"
                    + (", small arguments" if name in PERF_EXAMPLES else "") + ")"
                    + "".join("\n  " + b for b in bad))
            print(f"time example {name}: {got.seconds:.4f} s (--device cpu "
                  f"{want.seconds:.4f} s)" + (" at the small arguments" if name in PERF_EXAMPLES
                                              else "") + f" [{smi}]", flush=True)
            if name in EXAMPLE_LAUNCHES:
                print(f"example {name} launches: " + json.dumps(launches), flush=True)
                require(launches == EXAMPLE_LAUNCHES[name],
                        f"example {name} launched {json.dumps(EXAMPLE_LAUNCHES[name])}")
            elif name == "accel_matrix":
                cells = {}
                for fn, impl, dt, made, *_ in calls:
                    cells.setdefault((impl, dt), {})[fn] = made
                    print(f"example accel_matrix {impl} {dt} {fn} launches: "
                          + json.dumps(made), flush=True)
                require(all(cells.get(cell) == want_ for cell, want_ in ACCEL_LAUNCHES.items())
                        and all(m == {} for (impl, _), c in cells.items()
                                if impl == "separable" for m in c.values()),
                        "example accel_matrix: each fused and streamed cell launched its "
                        "kernels, the separable cells none")
            elif name == "similarity":
                for side, run in (("card", got), ("cpu", want)):
                    print(f"example similarity table ({side}): "
                          + json.dumps(run.out.splitlines()), flush=True)
                print(f"example {name} launches: " + json.dumps(launches), flush=True)
                check_table_calls(name, calls)
                require(bool(launches), f"example {name}: the table's kernels ran")
            else:  # the perf programs' small arguments are the separable pyramid
                require(not launches, f"example {name} launched no kernel (the oracle, "
                        f"the riders and the tools are plain torch)")
    print(f"time examples phase: {time.time() - t0:.1f} s for {len(C.PROGRAMS)} programs "
          f"on the card and on the CPU [{smi}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    import numpy as np

    from libdwt_torch import api
    from libdwt_torch.ops import _cuda
    from libdwt_torch.ops import fused as F
    from libdwt_torch.ops import fused3d as F3
    from libdwt_torch.ops import separable as sep
    from libdwt_torch.ops import streamed as S
    from libdwt_torch.ops import streamed3d as S3
    from libdwt_torch.utils.testimg import test_image

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    bw, flops, tc_flops = card_peaks(name)
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)

    # ---- 1. build every kernel (one nvcc per source, in parallel)
    t0 = time.time()
    paths = _cuda.build_all()
    print(f"built {sorted(p.name for p in paths.values())} in "
          f"{time.time() - t0:.1f} s", flush=True)
    for p in paths.values():
        log = p.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {p.stem}: {line.strip()}")

    # ---- 2. the main path: 2144x4096 f32 CDF 9/7 J=5, impl='fused'
    H, W, J, WV = 2144, 4096, 5, "cdf97"
    HO, WO = 2161, 4097  # odd frame: its plan holds single fused levels
    VOL, J3 = (64, 512, 512), 2  # bench.py's 3-D config
    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(rng.random((H, W), dtype=np.float32)).to(dev)
    torch.cuda.synchronize()
    F.reset_counters()
    coeffs = api.wavedec2(x, WV, J, impl="fused")
    rec = api.waverec2(coeffs, WV, impl="fused")
    torch.cuda.synchronize()
    launches = {k: F.KERNELS[k].launches for k in ("B2", "B3", "B5", "B6")}
    print("main-path launches: " + json.dumps(launches), flush=True)
    for k, n in launches.items():
        require(n > 0, f"{k} {F.KERNELS[k].name} launched on the main path ({n})")

    # ---- 3. pyramid vs the separable oracle, round trip
    want = sep.wavedec2(x, WV, J)
    require(len(coeffs) == J + 1 and all(
        a.shape == b.shape for a, b in zip(leaves(coeffs), leaves(want))),
        "pyramid has the oracle's structure and shapes")
    require(all(bool(torch.isfinite(a).all()) for a in leaves(coeffs) + [rec]),
            "pyramid and reconstruction are finite")
    err_pyr = max_abs(leaves(coeffs), leaves(want))
    require(err_pyr <= 5e-4, f"pyramid vs separable oracle max|diff| {err_pyr:.3e} <= 5e-4")
    err_rt = max_abs(rec, x)
    require(err_rt <= 1e-3, f"round trip max|err| {err_rt:.3e} <= 1e-3")

    # ---- 4. each kernel vs its plain version at its main-path shapes
    ll2 = F.fused_dwt2_2level(x, WV)[0]  # 536x1024, the deep forward tail's input
    deep_in = [coeffs[0]] + list(coeffs[1:4])  # LL5 + levels 5..3
    ll2_rec = F.fused_deep_waverec2(deep_in, WV)
    b5_in = (ll2_rec, coeffs[4], coeffs[5])
    # B3/B6 move their input once and every band of every level once (5.8 MB
    # with the intermediate LLs, which the function need not move)
    tail_bytes = 4 * (ll2.numel() + sum(a.numel() for a in leaves(coeffs[:4])))
    tail_ops = ll2.numel() * (1 + 1 / 4 + 1 / 16) * OPS_PER_PIXEL_LEVEL
    cases = {
        "B2": (lambda: F.fused_dwt2_2level(x, WV),
               lambda: F.fused_dwt2_2level_plain(x, WV),
               x.numel() * 4 * 2, x.numel() * 1.25 * OPS_PER_PIXEL_LEVEL),
        "B3": (lambda: F.fused_deep_wavedec2(ll2, WV, 3),
               lambda: F.fused_deep_wavedec2_plain(ll2, WV, 3), tail_bytes, tail_ops),
        "B6": (lambda: F.fused_deep_waverec2(deep_in, WV),
               lambda: F.fused_deep_waverec2_plain(deep_in, WV), tail_bytes, tail_ops),
        "B5": (lambda: F.fused_idwt2_2level(*b5_in, WV),
               lambda: F.fused_idwt2_2level_plain(*b5_in, WV),
               x.numel() * 4 * 2, x.numel() * 1.25 * OPS_PER_PIXEL_LEVEL),
    }  # kernel, plain, bytes moved, float operations
    errs = {}
    for k, (kern, plain, _, _) in cases.items():
        errs[k] = max_abs(leaves(kern()), leaves(plain()))
        torch.cuda.synchronize()
        # own bodies on lines.cuh's walks: the plain arithmetic in the plain order
        require(errs[k] == 0, f"{k} kernel == plain bit for bit at main-path shapes")
    require(all(1 <= g <= r for g, r in F.LAST_GRID.values()),
            "B3/B6 cooperative grids fit the card's co-resident blocks "
            + json.dumps(F.LAST_GRID))

    # ---- int32 CDF 5/3 at 512x512 through each kernel: exact
    xi = torch.from_numpy(test_image(512, 512, dtype=np.int32)).to(dev)
    for levels, fwd, fwd_plain, inv, inv_plain, tag in (
            (2, lambda a: list(F.fused_dwt2_2level(a, "cdf53")),
             lambda a: list(F.fused_dwt2_2level_plain(a, "cdf53")),
             lambda c: F.fused_idwt2_2level(c[0], c[1], c[2], "cdf53"),
             lambda c: F.fused_idwt2_2level_plain(c[0], c[1], c[2], "cdf53"),
             "B2/B5"),
            (3, lambda a: F.fused_deep_wavedec2(a, "cdf53", 3),
             lambda a: F.fused_deep_wavedec2_plain(a, "cdf53", 3),
             lambda c: F.fused_deep_waverec2(c, "cdf53"),
             lambda c: F.fused_deep_waverec2_plain(c, "cdf53"),
             "B3/B6")):
        oracle = sep.wavedec2(xi, "cdf53", levels)
        got = fwd(xi)
        require(max_abs(leaves(got), leaves(fwd_plain(xi))) == 0
                and max_abs(leaves(got), leaves(oracle)) == 0,
                f"int32 cdf53 512x512 {tag} forward == plain == oracle")
        back = inv(oracle)
        require(max_abs(back, inv_plain(oracle)) == 0 and max_abs(back, xi) == 0,
                f"int32 cdf53 512x512 {tag} inverse == plain == input")

    # ---- the single-level path: dwt2/idwt2 'fused' at 2144x4096 (B1/B4),
    # then the 2161x4097 J=5 pyramid (B1, B1, then B3 for 3 levels)
    F.reset_counters()
    bands = api.dwt2(x, WV, impl="fused")
    rec1 = api.idwt2(*bands, WV, impl="fused")
    torch.cuda.synchronize()
    level_launches = {k: F.KERNELS[k].launches for k in ("B1", "B4")}
    print("single-level launches: " + json.dumps(level_launches), flush=True)
    require(level_launches == {"B1": 1, "B4": 1},
            "api.dwt2/idwt2 impl='fused' launched B1 and B4 once each")
    err = max_abs(list(bands), list(sep.dwt2_level(x, WV)))
    require(err <= 3e-5, f"dwt2 {H}x{W} vs separable oracle max|diff| {err:.3e} <= 3e-5")
    err = max_abs(rec1, x)
    require(err <= 1e-3, f"dwt2/idwt2 round trip max|err| {err:.3e} <= 1e-3")
    xo = torch.from_numpy(rng.random((HO, WO), dtype=np.float32)).to(dev)
    torch.cuda.synchronize()
    F.reset_counters()
    odd = api.wavedec2(xo, WV, J, impl="fused")
    torch.cuda.synchronize()
    odd_launches = {k: s.launches for k, s in F.KERNELS.items() if s.launches}
    print(f"{HO}x{WO} pyramid launches: " + json.dumps(odd_launches), flush=True)
    require(odd_launches == {"B1": 2, "B3": 1},
            f"{HO}x{WO} J={J} pyramid ran B1, B1, then B3 once for 3 levels")
    err = max_abs(leaves(odd), leaves(sep.wavedec2(xo, WV, J)))
    require(err <= 5e-4, f"{HO}x{WO} pyramid vs separable oracle max|diff| {err:.3e} <= 5e-4")
    launches["B1"] = level_launches["B1"] + odd_launches["B1"]
    launches["B4"] = level_launches["B4"]
    # the odd pyramid's kernels vs their plain versions at its shapes:
    # B1 at 2161x4097 and 1081x2049 (ceil/floor bands), B3 at 541x1025
    odd_l1 = F.fused_dwt2_level(xo, WV)[0]
    odd_l2 = F.fused_dwt2_level(odd_l1, WV)[0]
    for k, arg, kern, plain in (
            ("B1", xo, lambda a: F.fused_dwt2_level(a, WV),
             lambda a: F.dwt2_level_plain(a, WV)),
            ("B1", odd_l1, lambda a: F.fused_dwt2_level(a, WV),
             lambda a: F.dwt2_level_plain(a, WV)),
            ("B3", odd_l2, lambda a: F.fused_deep_wavedec2(a, WV, 3),
             lambda a: F.fused_deep_wavedec2_plain(a, WV, 3))):
        err = max_abs(leaves(kern(arg)), leaves(plain(arg)))
        torch.cuda.synchronize()
        require(err == 0, f"{k} kernel == plain bit for bit at "
                f"{'x'.join(map(str, arg.shape))} ({HO}x{WO} pyramid)")

    # ---- the bench gates of B1, and the extended-rows contract
    xs = torch.from_numpy(rng.standard_normal((513, 511)).astype(np.float32)).to(dev)
    got = api.dwt2(xs, WV, impl="fused")
    err = max_abs(list(got), list(sep.dwt2_level(xs, WV)))
    require(err <= 3e-5, f"f32 513x511 B1 vs separable oracle max|diff| {err:.3e} <= 3e-5")
    err = max_abs(list(got), list(F.dwt2_level_plain(xs, WV)))
    require(err == 0, "f32 513x511 B1 kernel == plain bit for bit")
    got = F.fused_dwt2_level(xi, "cdf53")
    require(max_abs(list(got), list(F.dwt2_level_plain(xi, "cdf53"))) == 0
            and max_abs(list(got), list(sep.dwt2_level(xi, "cdf53"))) == 0,
            "int32 cdf53 512x512 B1 forward == plain == oracle")
    back = F.fused_idwt2_level(*got, "cdf53")
    require(max_abs(back, F.idwt2_level_plain(*got, "cdf53")) == 0 and max_abs(back, xi) == 0,
            "int32 cdf53 512x512 B4 inverse == plain == input")
    xe = torch.from_numpy(rng.standard_normal((512 + 2 * F.HALO, 512)).astype(np.float32)).to(dev)
    got = F.fused_dwt2_level(xe, WV, boundary_rows="extended")
    err = max_abs(list(got), list(F.dwt2_level_plain(xe, WV, ext=True)))
    require(err == 0, "extended rows 512x512 (+4 rows each side) B1 kernel == plain "
            "bit for bit")
    be = [torch.from_numpy(rng.standard_normal((256 + 2 * F.CH, 256)).astype(np.float32)).to(dev)
          for _ in range(4)]
    back = F.fused_idwt2_level(*be, WV, boundary_rows="extended")
    err = max_abs(back, F.idwt2_level_plain(*be, WV, ext=True))
    require(tuple(back.shape) == (512, 512) and err == 0,
            "extended rows 512x512 (+4 channel rows each side) B4 kernel == plain "
            "bit for bit")

    # ---- the 3-D path: wavedec3/waverec3 'fused', 64x512x512 J=2 (B14, B15)
    v = torch.from_numpy(rng.random(VOL, dtype=np.float32)).to(dev)
    torch.cuda.synchronize()
    F.reset_counters()
    c3 = api.wavedec3(v, WV, J3, impl="fused")
    r3 = api.waverec3(c3, WV, impl="fused")
    torch.cuda.synchronize()
    vol_launches = {k: s.launches for k, s in F.KERNELS.items() if s.launches}
    print("3-D path launches: " + json.dumps(vol_launches), flush=True)
    require(vol_launches == {"B14": J3, "B15": J3},
            f"wavedec3/waverec3 J={J3} launched B14 and B15 {J3} times each")
    launches.update(vol_launches)
    want3 = sep.wavedec3(v, WV, J3)
    require(all(bool(torch.isfinite(a).all()) for a in leaves(c3) + [r3]),
            "volume pyramid and reconstruction are finite")
    err = max_abs(leaves(c3), leaves(want3))
    require(err <= 5e-4, f"volume pyramid vs separable oracle max|diff| {err:.3e} <= 5e-4")
    err = max_abs(r3, v)
    require(err <= 1e-3, f"volume round trip max|err| {err:.3e} <= 1e-3")
    with tune_table({}):  # the built-in 3-D rule
        F.reset_counters()
        api.waverec3(api.wavedec3(v, WV, J3), WV)
        torch.cuda.synchronize()
    require((F.KERNELS["B14"].launches, F.KERNELS["B15"].launches) == (J3, J3),
            "'auto' with no table on the CUDA volume takes B14 and B15")
    volume_feed(f"{'x'.join(map(str, VOL))} f32 level {J3}", tuple(s // 2 for s in VOL), 4)
    vi = torch.from_numpy(rng.integers(-255, 256, (32, 64, 64)).astype(np.int32)).to(dev)
    got = F3.fused_dwt3_level(vi, "cdf53")
    require(max_abs(leaves(got), leaves(F3.dwt3_level_plain(vi, "cdf53"))) == 0
            and max_abs(leaves(got), leaves(sep.dwt3_level(vi, "cdf53"))) == 0,
            "int32 cdf53 32x64x64 B14 forward == plain == oracle")
    back = F3.fused_idwt3_level(got, "cdf53")
    require(max_abs(back, F3.idwt3_level_plain(got, "cdf53")) == 0 and max_abs(back, vi) == 0,
            "int32 cdf53 32x64x64 B15 inverse == plain == input")
    volume_feed("32x64x64 int32", (32, 64, 64), 4)

    # ---- the streamed path: wavedec2/waverec2 impl='streamed' at 2144x4096,
    # J=5 (one launch each: B11, B12) and J=2 (B8, B10)
    F.reset_counters()
    sc = api.wavedec2(x, WV, J, impl="streamed")
    srec = api.waverec2(sc, WV, impl="streamed")
    torch.cuda.synchronize()
    deep_launches = {k: s.launches for k, s in F.KERNELS.items() if s.launches}
    print(f"streamed J={J} launches: " + json.dumps(deep_launches)
          + f", cooperative (grid, resident blocks): {json.dumps(S.LAST_GRID)}", flush=True)
    require(deep_launches == {"B11": 1, "B12": 1},
            f"api.wavedec2/waverec2 impl='streamed' J={J} launched B11 and B12 once each")
    require(all(1 <= g <= r for g, r in S.LAST_GRID.values()),
            "B11/B12 cooperative grids fit the card's co-resident blocks")
    require(all(bool(torch.isfinite(a).all()) for a in leaves(sc) + [srec]),
            "streamed pyramid and reconstruction are finite")
    err = max_abs(leaves(sc), leaves(want))
    require(err <= 5e-4, f"streamed pyramid vs separable oracle max|diff| {err:.3e} <= 5e-4")
    err = max_abs(srec, x)
    require(err <= 1e-3, f"streamed round trip max|err| {err:.3e} <= 1e-3")
    F.reset_counters()
    s2c = api.wavedec2(x, WV, 2, impl="streamed")
    s2rec = api.waverec2(s2c, WV, impl="streamed")
    torch.cuda.synchronize()
    pair_launches = {k: s.launches for k, s in F.KERNELS.items() if s.launches}
    print("streamed J=2 launches: " + json.dumps(pair_launches), flush=True)
    require(pair_launches == {"B8": 1, "B10": 1},
            "api.wavedec2/waverec2 impl='streamed' J=2 launched B8 and B10 once each")
    err = max_abs(leaves(s2c), leaves(sep.wavedec2(x, WV, 2)))
    require(err <= 5e-4, f"streamed J=2 pyramid vs separable oracle max|diff| {err:.3e} <= 5e-4")
    err = max_abs(s2rec, x)
    require(err <= 1e-3, f"streamed J=2 round trip max|err| {err:.3e} <= 1e-3")
    launches.update(deep_launches)
    launches.update(pair_launches)
    for levels, fwd, fwd_plain, inv, inv_plain, tag in (
            (2, lambda a: list(S.streamed_dwt2_2level(a, "cdf53")),
             lambda a: list(S.streamed_dwt2_2level_plain(a, "cdf53")),
             lambda c: S.streamed_idwt2_2level(c[0], c[1], c[2], "cdf53"),
             lambda c: S.streamed_idwt2_2level_plain(c[0], c[1], c[2], "cdf53"),
             "B8/B10"),
            (4, lambda a: S.streamed_wavedec2_deep(a, "cdf53", 4),
             lambda a: S.streamed_wavedec2_deep_plain(a, "cdf53", 4),
             lambda c: S.streamed_waverec2_deep(c, "cdf53"),
             lambda c: S.streamed_waverec2_deep_plain(c, "cdf53"),
             "B11/B12")):
        oracle = sep.wavedec2(xi, "cdf53", levels)
        got = fwd(xi)
        require(max_abs(leaves(got), leaves(fwd_plain(xi))) == 0
                and max_abs(leaves(got), leaves(oracle)) == 0,
                f"int32 cdf53 512x512 {tag} forward == plain == oracle")
        back = inv(oracle)
        require(max_abs(back, inv_plain(oracle)) == 0 and max_abs(back, xi) == 0,
                f"int32 cdf53 512x512 {tag} inverse == plain == input")

    # ---- the streamed kernels vs their plain versions at their path's shapes
    pyr_ops = x.numel() * sum(4.0 ** -k for k in range(J)) * OPS_PER_PIXEL_LEVEL
    streamed_cases = {
        "B8": (lambda: S.streamed_dwt2_2level(x, WV),
               lambda: S.streamed_dwt2_2level_plain(x, WV),
               x.numel() * 4 * 2, x.numel() * 1.25 * OPS_PER_PIXEL_LEVEL),
        "B10": (lambda: S.streamed_idwt2_2level(*s2c, WV),
                lambda: S.streamed_idwt2_2level_plain(*s2c, WV),
                x.numel() * 4 * 2, x.numel() * 1.25 * OPS_PER_PIXEL_LEVEL),
        "B11": (lambda: S.streamed_wavedec2_deep(x, WV, J),
                lambda: S.streamed_wavedec2_deep_plain(x, WV, J),
                x.numel() * 4 * 2, pyr_ops),
        "B12": (lambda: S.streamed_waverec2_deep(sc, WV),
                lambda: S.streamed_waverec2_deep_plain(sc, WV),
                x.numel() * 4 * 2, pyr_ops),
    }
    for k, (kern, plain, _, _) in streamed_cases.items():
        errs[k] = max_abs(leaves(kern()), leaves(plain()))
        torch.cuda.synchronize()
        if k in EXACT_STREAMED:
            require(errs[k] == 0, f"{k} kernel == plain bit for bit at its path's shapes")
        else:
            require(errs[k] <= 3e-5, f"{k} kernel vs plain at its path's shapes "
                    f"max|diff| {errs[k]:.3e} <= 3e-5")
    # B11/B12 run B2's strip body and B3's deep levels (B6's levels, B5's
    # body): on the frame they equal those kernels bit for bit, and so does
    # each one's strip phase alone (a launch with no deep level)
    ll2f, b2f, b1f = F.fused_dwt2_2level(x, WV)
    err = max_abs(leaves(streamed_cases["B11"][0]()),
                  leaves(list(F.fused_deep_wavedec2(ll2f, WV, J - 2)) + [b2f, b1f]))
    require(err == 0, f"B11 == B2 then B3 bit for bit on the {H}x{W} J={J} frame")
    rec_f = F.fused_idwt2_2level(F.fused_deep_waverec2(sc[:-2], WV), sc[-2], sc[-1], WV)
    err = max_abs(streamed_cases["B12"][0](), rec_f)
    require(err == 0, f"B12 == B6 then B5 bit for bit on the {H}x{W} J={J} frame")
    strips_fwd, strips_fwd_out, _ = strip_phase(x, WV)
    strips_inv, strips_inv_out, _ = strip_phase(s2c, WV)
    strips_fwd()
    strips_inv()
    torch.cuda.synchronize()
    require(max_abs(leaves(strips_fwd_out), leaves(F.fused_dwt2_2level(x, WV))) == 0
            and max_abs(strips_inv_out, F.fused_idwt2_2level(*s2c, WV)) == 0,
            "B11/B12 with no deep level (the strip phase alone) == B2 / B5 bit for bit")
    # B8/B10 run that strip phase alone, in kernels of their own
    err = max_abs(leaves(streamed_cases["B8"][0]()), leaves(F.fused_dwt2_2level(x, WV)))
    require(err == 0, f"B8 == B2 bit for bit on the {H}x{W} frame")
    err = max_abs(streamed_cases["B10"][0](), F.fused_idwt2_2level(*s2c, WV))
    require(err == 0, f"B10 == B5 bit for bit on the {H}x{W} frame")
    occ = []
    for dt, wv in ((torch.float32, WV), (torch.float64, WV), (torch.int32, "cdf53")):
        for k, inverse in (("B8", False), ("B10", True)):
            i = S.strip_kernel_info(dt, wv, inverse, (H, W))
            occ.append(f"{k} {str(dt)[6:]} {wv}: {i['registers']} registers, "
                       f"{i['blocks_per_sm']} blocks an SM, grid {i['grid']}, "
                       f"{i['smem']} B of shared memory")
    print(f"strip instantiations ({H}x{W}, strip {S.STRIP_TY}x{S.STRIP_TX}): "
          + "; ".join(occ) + f" [{smi}]", flush=True)
    pair_dev = {}
    for kid, fn in (("B8", streamed_cases["B8"][0]), ("B2", lambda: F.fused_dwt2_2level(x, WV)),
                    ("B10", streamed_cases["B10"][0]),
                    ("B5", lambda: F.fused_idwt2_2level(*s2c, WV))) * 2:
        pair_dev.setdefault(kid, []).append(device_ms(fn))
    print(f"time B8 beside B2, B10 beside B5 (device, {H}x{W} f32, two passes each): "
          + ", ".join(f"{k} " + " / ".join("not measured" if t is None else f"{t:.4f} ms"
                                           for t in ts) for k, ts in pair_dev.items())
          + f" [{smi}]", flush=True)
    fmt_dev = "{:.4f}".format
    for k, whole, strips, fused_pair, streamed_pair in (
            ("B11", streamed_cases["B11"][0], strips_fwd,
             lambda: F.fused_deep_wavedec2(F.fused_dwt2_2level(x, WV)[0], WV, J - 2),
             lambda: F.fused_deep_wavedec2(S.streamed_dwt2_2level(x, WV)[0], WV, J - 2)),
            ("B12", streamed_cases["B12"][0], strips_inv,
             lambda: F.fused_idwt2_2level(F.fused_deep_waverec2(sc[:-2], WV), sc[-2], sc[-1],
                                          WV),
             lambda: S.streamed_idwt2_2level(F.fused_deep_waverec2(sc[:-2], WV), sc[-2],
                                             sc[-1], WV))):
        t = {name: device_ms(fn) for name, fn in (("whole", whole), ("strips", strips),
                                                   ("fused", fused_pair),
                                                   ("streamed", streamed_pair))}
        if None in t.values():
            print(f"time {k} device split: not measured [{smi}]", flush=True)
            continue
        print(f"time {k} device split (J={J}, {H}x{W} f32): one launch {fmt_dev(t['whole'])} "
              f"ms = strip phase {fmt_dev(t['strips'])} ms (a launch with no deep level) + "
              f"deep levels {fmt_dev(t['whole'] - t['strips'])} ms; the fused kernels it "
              f"runs ({'B2 + B3' if k == 'B11' else 'B6 + B5'}, two launches) "
              f"{fmt_dev(t['fused'])} ms; the strip kernel and the deep tail as two "
              f"kernels ({'B8 then B3' if k == 'B11' else 'B6 then B10'}) "
              f"{fmt_dev(t['streamed'])} ms [{smi}]", flush=True)

    # ---- the single streamed levels: dwt2/idwt2 'streamed' at 2144x4096 (B7/B9)
    F.reset_counters()
    sbands = api.dwt2(x, WV, impl="streamed")
    srec1 = api.idwt2(*sbands, WV, impl="streamed")
    torch.cuda.synchronize()
    slevel_launches = {k: s.launches for k, s in F.KERNELS.items() if s.launches}
    print("streamed single-level launches: " + json.dumps(slevel_launches), flush=True)
    require(slevel_launches == {"B7": 1, "B9": 1},
            "api.dwt2/idwt2 impl='streamed' launched B7 and B9 once each")
    launches.update(slevel_launches)
    err = max_abs(list(sbands), list(sep.dwt2_level(x, WV)))
    require(err <= 3e-5, f"streamed dwt2 {H}x{W} vs separable oracle max|diff| {err:.3e} <= 3e-5")
    err = max_abs(srec1, x)
    require(err <= 1e-3, f"streamed dwt2/idwt2 round trip max|err| {err:.3e} <= 1e-3")
    got = S.streamed_dwt2_level(xi, "cdf53")
    require(max_abs(list(got), list(S.streamed_dwt2_level_plain(xi, "cdf53"))) == 0
            and max_abs(list(got), list(sep.dwt2_level(xi, "cdf53"))) == 0,
            "int32 cdf53 512x512 B7 forward == plain == oracle")
    back = S.streamed_idwt2_level(*got, "cdf53")
    require(max_abs(back, S.streamed_idwt2_level_plain(*got, "cdf53")) == 0
            and max_abs(back, xi) == 0, "int32 cdf53 512x512 B9 inverse == plain == input")
    xe8 = torch.from_numpy(rng.standard_normal((512 + 2 * S.TOP, 512)).astype(np.float32)).to(dev)
    got = S.streamed_dwt2_level(xe8, WV, boundary_rows="extended")
    err = max_abs(list(got), list(S.streamed_dwt2_level_plain(xe8, WV, ext=S.TOP)))
    require(err == 0, "extended rows 512x512 (+8 rows each side) B7 kernel == plain "
            "bit for bit")
    be8 = [torch.from_numpy(rng.standard_normal((256 + 2 * S.TOP, 256)).astype(np.float32)).to(dev)
           for _ in range(4)]
    back = S.streamed_idwt2_level(*be8, WV, boundary_rows="extended")
    err = max_abs(back, S.streamed_idwt2_level_plain(*be8, WV, ext=S.TOP))
    require(tuple(back.shape) == (512, 512) and err == 0,
            "extended rows 512x512 (+8 channel rows each side) B9 kernel == plain "
            "bit for bit")
    # B7/B9 run B1/B4's body on a strip: on the frame B7 == B1 and B9 == B4
    err = max_abs(list(sbands), list(F.fused_dwt2_level(x, WV)))
    require(err == 0, f"B7 == B1 bit for bit on the {H}x{W} frame")
    err = max_abs(srec1, F.fused_idwt2_level(*sbands, WV))
    require(err == 0, f"B9 == B4 bit for bit on the {H}x{W} frame")
    occ = []
    for dt, wv in ((torch.float32, WV), (torch.float64, WV), (torch.int32, "cdf53")):
        for k, inverse in (("B7", False), ("B9", True)):
            for ext in (0, S.TOP):
                i = S.level_kernel_info(dt, wv, inverse, (H, W), ext=ext)
                occ.append(f"{k} {str(dt)[6:]} {wv}{' extended' if ext else ''}: "
                           f"{i['registers']} registers, {i['blocks_per_sm']} blocks an SM, "
                           f"grid {i['grid']}, {i['smem']} B of shared memory")
    print(f"level instantiations ({H}x{W}, strip {S.STRIP_TY}x{S.STRIP_TX}): "
          + "; ".join(occ) + f" [{smi}]", flush=True)
    level_dev = {}
    for kid, fn in (("B7", lambda: S.streamed_dwt2_level(x, WV)),
                    ("B1", lambda: F.fused_dwt2_level(x, WV)),
                    ("B9", lambda: S.streamed_idwt2_level(*sbands, WV)),
                    ("B4", lambda: F.fused_idwt2_level(*sbands, WV))) * 2:
        level_dev.setdefault(kid, []).append(device_ms(fn))
    print(f"time B7 beside B1, B9 beside B4 (device, {H}x{W} f32, two passes each): "
          + ", ".join(f"{k} " + " / ".join("not measured" if t is None else f"{t:.4f} ms"
                                           for t in ts) for k, ts in level_dev.items())
          + f" [{smi}]", flush=True)

    # ---- the streamed volume: wavedec3/waverec3 'streamed', 64x512x512 J=2
    F.reset_counters()
    sc3 = api.wavedec3(v, WV, J3, impl="streamed")
    sr3 = api.waverec3(sc3, WV, impl="streamed")
    torch.cuda.synchronize()
    svol_launches = {k: s.launches for k, s in F.KERNELS.items() if s.launches}
    print("streamed 3-D path launches: " + json.dumps(svol_launches), flush=True)
    require(svol_launches == {"B16": J3, "B17": J3},
            f"wavedec3/waverec3 impl='streamed' J={J3} launched B16 and B17 {J3} times each")
    launches.update(svol_launches)
    require(all(bool(torch.isfinite(a).all()) for a in leaves(sc3) + [sr3]),
            "streamed volume pyramid and reconstruction are finite")
    err = max_abs(leaves(sc3), leaves(want3))
    require(err <= 5e-4, f"streamed volume pyramid vs separable oracle max|diff| {err:.3e} <= 5e-4")
    err = max_abs(sr3, v)
    require(err <= 1e-3, f"streamed volume round trip max|err| {err:.3e} <= 1e-3")
    got = S3.streamed_dwt3_level(vi, "cdf53")
    require(max_abs(leaves(got), leaves(S3.dwt3_level_streamed_plain(vi, "cdf53"))) == 0
            and max_abs(leaves(got), leaves(sep.dwt3_level(vi, "cdf53"))) == 0,
            "int32 cdf53 32x64x64 B16 forward == plain == oracle")
    back = S3.streamed_idwt3_level(got, "cdf53")
    require(max_abs(back, S3.idwt3_level_streamed_plain(got, "cdf53")) == 0
            and max_abs(back, vi) == 0, "int32 cdf53 32x64x64 B17 inverse == plain == input")

    # ---- the banded-matmul pyramid: wavedec2/waverec2 impl='streamed-mxu' at
    # 2144x4096, J=5 (B11, B12, each running the banded body B13) and J=2
    # (B8, B10, each running B13)
    F.reset_counters()
    mc = api.wavedec2(x, WV, J, impl="streamed-mxu")
    mrec = api.waverec2(mc, WV, impl="streamed-mxu")
    torch.cuda.synchronize()
    mxu_launches = {k: s.launches for k, s in F.KERNELS.items() if s.launches}
    print(f"streamed-mxu J={J} launches: " + json.dumps(mxu_launches)
          + f", cooperative (grid, resident blocks): {json.dumps(S.LAST_GRID)}", flush=True)
    require(mxu_launches == {"B11": 1, "B12": 1, "B13": 2},
            f"api.wavedec2/waverec2 impl='streamed-mxu' J={J} launched B11 and B12 "
            "once each, both with the banded body B13")
    require(all(1 <= g <= r for g, r in S.LAST_GRID.values()),
            "B11/B12 banded-body cooperative grids fit the card's co-resident blocks")
    require(all(bool(torch.isfinite(a).all()) for a in leaves(mc) + [mrec]),
            "streamed-mxu pyramid and reconstruction are finite")
    err = max_abs(leaves(mc), leaves(want))
    require(err <= 5e-4, f"streamed-mxu pyramid vs separable oracle max|diff| {err:.3e} <= 5e-4")
    err = max_abs(mrec, x)
    require(err <= 5e-4, f"streamed-mxu round trip max|err| {err:.3e} <= 5e-4")
    F.reset_counters()
    m2c = api.wavedec2(x, WV, 2, impl="streamed-mxu")
    m2rec = api.waverec2(m2c, WV, impl="streamed-mxu")
    torch.cuda.synchronize()
    mxu2_launches = {k: s.launches for k, s in F.KERNELS.items() if s.launches}
    print("streamed-mxu J=2 launches: " + json.dumps(mxu2_launches), flush=True)
    require(mxu2_launches == {"B8": 1, "B10": 1, "B13": 2},
            "api.wavedec2/waverec2 impl='streamed-mxu' J=2 launched B8 and B10 once "
            "each, both with the banded body B13")
    require(all(bool(torch.isfinite(a).all()) for a in leaves(m2c) + [m2rec]),
            "streamed-mxu J=2 pyramid and reconstruction are finite")
    err = max_abs(leaves(m2c), leaves(sep.wavedec2(x, WV, 2)))
    require(err <= 5e-4, f"streamed-mxu J=2 pyramid vs separable oracle max|diff| {err:.3e} <= 5e-4")
    err = max_abs(m2rec, x)
    require(err <= 5e-4, f"streamed-mxu J=2 round trip max|err| {err:.3e} <= 5e-4")
    launches["B13"] = mxu_launches["B13"] + mxu2_launches["B13"]
    # each banded instantiation vs its plain version at its path's shapes
    band_ops = x.numel() * 2.5 * band_ops_per_sample(WV)  # 2 passes at level 1, 2 at 1/4
    deep_ops = x.numel() * sum(4.0 ** -k for k in range(2, J)) * OPS_PER_PIXEL_LEVEL
    mxu_cases = {  # kernel, plain, bytes, float32 ops, tensor-core ops
        "B8": (lambda: S.streamed_dwt2_2level(x, WV, body="mxu"),
               lambda: S.streamed_dwt2_2level_plain(x, WV, body="mxu"),
               x.numel() * 4 * 2, 0, band_ops),
        "B10": (lambda: S.streamed_idwt2_2level(*m2c, WV, body="mxu"),
                lambda: S.streamed_idwt2_2level_plain(*m2c, WV, body="mxu"),
                x.numel() * 4 * 2, 0, band_ops),
        "B11": (lambda: S.streamed_wavedec2_deep(x, WV, J, body="mxu"),
                lambda: S.streamed_wavedec2_deep_plain(x, WV, J, body="mxu"),
                x.numel() * 4 * 2, deep_ops, band_ops),
        "B12": (lambda: S.streamed_waverec2_deep(mc, WV, body="mxu"),
                lambda: S.streamed_waverec2_deep_plain(mc, WV, body="mxu"),
                x.numel() * 4 * 2, deep_ops, band_ops),
    }
    mxu_errs = {}
    for k, (kern, plain, *_) in mxu_cases.items():
        mxu_errs[k] = max_abs(leaves(kern()), leaves(plain()))
        torch.cuda.synchronize()
        require(mxu_errs[k] <= 2e-5, f"{k} banded body (B13) vs plain at its path's shapes "
                f"max|diff| {mxu_errs[k]:.3e} <= 2e-5")
    errs["B13"] = max(mxu_errs.values())
    # B11/B12 with the banded body run B8/B10's (the same kernel with no
    # deep level) and B3/B6's levels: on the frame they equal B8-mxu then
    # B3, and B6 then B10-mxu, bit for bit
    ll2m, b2m, b1m = S.streamed_dwt2_2level(x, WV, body="mxu")
    err = max_abs(leaves(mxu_cases["B11"][0]()),
                  leaves(list(F.fused_deep_wavedec2(ll2m, WV, J - 2)) + [b2m, b1m]))
    require(err == 0, f"B11-mxu == B8-mxu then B3 bit for bit on the {H}x{W} J={J} frame")
    ll2r = F.fused_deep_waverec2(mc[:-2], WV)
    err = max_abs(mxu_cases["B12"][0](), S.streamed_idwt2_2level(ll2r, mc[-2], mc[-1], WV,
                                                                 body="mxu"))
    require(err == 0, f"B12-mxu == B6 then B10-mxu bit for bit on the {H}x{W} J={J} frame")
    # each banded instantiation's registers (ptxas) and blocks an SM (the
    # co-resident blocks of its launch at its shared memory over the SMs)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log = paths["streamed.cu"].with_suffix(".log").read_text()
    occ = []
    for k, inverse, a in (("B8", False, x), ("B10", True, m2c), ("B11", False, None),
                          ("B12", True, None)):
        if a is None:
            grid, resident = S.LAST_GRID[k]
        else:
            launch, _, info = strip_phase(a, WV, body="mxu")
            launch()
            torch.cuda.synchronize()
            grid, resident = info
        kern = "sdeep_inv_mxu" if inverse else "sdeep_fwd_mxu"
        regs = ptxas_registers(log, (f"{kern}ILi4ELb1E",))
        occ.append(f"{k}-mxu {kern}<4, true> {regs[0][1] if regs else 'not found'} registers "
                   f"({regs[0][2] if regs else ''}), grid {grid}, {resident} co-resident "
                   f"blocks = {resident / sms:g} an SM")
    print("banded instantiations: " + "; ".join(occ) + f" [{smi}]", flush=True)
    for k, whole, strips, deep in (
            ("B11", mxu_cases["B11"][0], lambda: S.streamed_dwt2_2level(x, WV, body="mxu"),
             lambda: F.fused_deep_wavedec2(ll2m, WV, J - 2)),
            ("B12", mxu_cases["B12"][0],
             lambda: S.streamed_idwt2_2level(ll2r, mc[-2], mc[-1], WV, body="mxu"),
             lambda: F.fused_deep_waverec2(mc[:-2], WV))):
        t = {name: device_ms(fn) for name, fn in (("whole", whole), ("strips", strips),
                                                   ("deep", deep))}
        if None in t.values():
            print(f"time {k}-mxu device split: not measured [{smi}]", flush=True)
            continue
        print(f"time {k}-mxu device split (J={J}, {H}x{W} f32): one launch "
              f"{t['whole']:.4f} ms = strip phase {t['strips']:.4f} ms "
              f"({'B8' if k == 'B11' else 'B10'}-mxu: the same kernel with no deep level) + "
              f"deep levels {t['whole'] - t['strips']:.4f} ms; "
              f"{'B3' if k == 'B11' else 'B6'} alone {t['deep']:.4f} ms [{smi}]", flush=True)

    # ---- the slice 2 kernels vs their plain versions at their paths' shapes
    b14_l1 = F3.fused_dwt3_level(v, WV)
    ll3 = b14_l1["LLL"]  # 32x256x256, level 2's input
    b14_l2 = F3.fused_dwt3_level(ll3, WV)
    new_cases = {
        "B1": (lambda: F.fused_dwt2_level(x, WV), lambda: F.dwt2_level_plain(x, WV),
               x.numel() * 4 * 2, x.numel() * OPS_PER_PIXEL_LEVEL),
        "B4": (lambda: F.fused_idwt2_level(*bands, WV),
               lambda: F.idwt2_level_plain(*bands, WV),
               x.numel() * 4 * 2, x.numel() * OPS_PER_PIXEL_LEVEL),
        "B14": (lambda: F3.fused_dwt3_level(v, WV), lambda: F3.dwt3_level_plain(v, WV),
                v.numel() * 4 * 2, v.numel() * OPS_PER_VOXEL_LEVEL),
        "B15": (lambda: F3.fused_idwt3_level(b14_l1, WV),
                lambda: F3.idwt3_level_plain(b14_l1, WV),
                v.numel() * 4 * 2, v.numel() * OPS_PER_VOXEL_LEVEL),
    }
    new_cases.update({
        "B7": (lambda: S.streamed_dwt2_level(x, WV), lambda: S.streamed_dwt2_level_plain(x, WV),
               x.numel() * 4 * 2, x.numel() * OPS_PER_PIXEL_LEVEL),
        "B9": (lambda: S.streamed_idwt2_level(*sbands, WV),
               lambda: S.streamed_idwt2_level_plain(*sbands, WV),
               x.numel() * 4 * 2, x.numel() * OPS_PER_PIXEL_LEVEL),
        "B16": (lambda: S3.streamed_dwt3_level(v, WV),
                lambda: S3.dwt3_level_streamed_plain(v, WV),
                v.numel() * 4 * 2, v.numel() * OPS_PER_VOXEL_LEVEL),
        "B17": (lambda: S3.streamed_idwt3_level(b14_l1, WV),
                lambda: S3.idwt3_level_streamed_plain(b14_l1, WV),
                v.numel() * 4 * 2, v.numel() * OPS_PER_VOXEL_LEVEL),
    })
    level2 = {
        "B14": (lambda: F3.fused_dwt3_level(ll3, WV), lambda: F3.dwt3_level_plain(ll3, WV),
                ll3.numel() * 4 * 2, ll3.numel() * OPS_PER_VOXEL_LEVEL),
        "B15": (lambda: F3.fused_idwt3_level(b14_l2, WV),
                lambda: F3.idwt3_level_plain(b14_l2, WV),
                ll3.numel() * 4 * 2, ll3.numel() * OPS_PER_VOXEL_LEVEL),
        "B16": (lambda: S3.streamed_dwt3_level(ll3, WV),
                lambda: S3.dwt3_level_streamed_plain(ll3, WV),
                ll3.numel() * 4 * 2, ll3.numel() * OPS_PER_VOXEL_LEVEL),
        "B17": (lambda: S3.streamed_idwt3_level(b14_l2, WV),
                lambda: S3.idwt3_level_streamed_plain(b14_l2, WV),
                ll3.numel() * 4 * 2, ll3.numel() * OPS_PER_VOXEL_LEVEL),
    }
    # the single levels (onelevel.cuh's body: B1/B4 one tile a block, B7/B9
    # one strip a block) and the volume kernels: bit for bit
    for k, (kern, plain, _, _) in new_cases.items():
        errs[k] = max_abs(leaves(kern()), leaves(plain()))
        torch.cuda.synchronize()
        require(errs[k] == 0, f"{k} kernel == plain bit for bit at its path's shapes")
    for k, (kern, plain, _, _) in level2.items():
        err = max_abs(leaves(kern()), leaves(plain()))
        torch.cuda.synchronize()
        errs[k] = max(errs[k], err)
        require(err == 0, f"{k} kernel == plain bit for bit at level 2 "
                f"({'x'.join(map(str, ll3.shape))})")
    # the volume kernels' registers, blocks an SM and shared memory, by dtype
    # at their default tiles (B14/B15 also their feed at 64x512x512)
    for k in EXACT_VOLUME:
        for dt in (torch.float32, torch.float64, torch.int32):
            fused = k in ("B14", "B15")
            mod = F3 if fused else S3
            info = mod.kernel_info(dt, WV, inverse=k in ("B15", "B17"))
            tile = mod._default_tile(None, torch.empty((), dtype=dt).element_size())
            feed = f", feed {info['feed']}" if fused else ""
            print(f"volume instantiation {k} {str(dt)[6:]} {WV} tile {tile}: "
                  f"{info['registers']} registers, {info['blocks_per_sm']} blocks of "
                  f"{info['threads']} threads an SM at {info['smem']} bytes of shared memory"
                  f"{feed} [{smi}]", flush=True)

    # ---- the sharded path: 2048x4096 f32 CDF 9/7 J=5 on a mesh of eight
    # shards of this card, halo_impl='rdma' (B18: one gather launch per
    # forward level and one per inverse level for both channels); 2144 =
    # 32*67 does not divide into 8 shards * 2^5, so the frame keeps the
    # width and takes 2048 rows
    from libdwt_torch.parallel import (make_mesh_2d, sharded_wavedec2, sharded_wavedec3,
                                       sharded_waverec2, sharded_waverec3)
    from libdwt_torch.parallel import remote_halo as RH

    HS, NS = 2048, 8
    card0 = torch.device("cuda", 0)
    mesh8 = make_mesh_2d(1, NS, devices=[card0] * NS)
    xsh = torch.from_numpy(rng.random((HS, W), dtype=np.float32)).to(dev)
    torch.cuda.synchronize()
    F.reset_counters()
    RH.LAST_GRID.clear()
    shc = sharded_wavedec2(xsh, WV, J, mesh=mesh8, halo_impl="rdma")
    shr = sharded_waverec2(shc, WV, mesh=mesh8, halo_impl="rdma")
    torch.cuda.synchronize()
    sh_launches = {k: s.launches for k, s in F.KERNELS.items() if s.launches}
    print(f"sharded rdma J={J} launches: " + json.dumps(sh_launches)
          + f", (path, grid, resident blocks): {json.dumps(RH.LAST_GRID)}", flush=True)
    require(sh_launches == {"B18": 2 * J},
            f"sharded_wavedec2/waverec2 halo_impl='rdma' J={J} on {NS} shards launched B18 "
            f"{J} + {J} times (one launch a level, both inverse channels in one)")
    require(all(p == "gather" and g >= 1 for p, g, _ in RH.LAST_GRID.values()),
            "B18 took the gather on this card's lines (one ordinary launch, no cooperative "
            "launch, no flags)")
    launches["B18"] = sh_launches["B18"]
    pp = sharded_wavedec2(xsh, WV, J, mesh=mesh8)
    ppr = sharded_waverec2(pp, WV, mesh=mesh8)
    require(max_abs(leaves(shc), leaves(pp)) == 0 and max_abs(shr, ppr) == 0,
            "sharded 'rdma' pyramid and reconstruction == 'ppermute' exactly")
    require(all(bool(torch.isfinite(a).all()) for a in leaves(shc) + [shr]),
            "sharded pyramid and reconstruction are finite")
    want_sh = sep.wavedec2(xsh, WV, J)
    err = max_abs(leaves(shc), leaves(want_sh))
    require(err <= 1e-4, f"sharded {HS}x{W} pyramid vs separable oracle max|diff| "
            f"{err:.3e} <= 1e-4")
    err = max_abs(shr, xsh)
    require(err <= 1e-3, f"sharded round trip max|err| {err:.3e} <= 1e-3")
    # the per-shard kernel bodies: B1/B4 at every level; B7/B9 where the
    # local block holds >= 2 strips (256 and 128 rows), B1/B4 below
    kern_launches = {}
    for kern, expect in (("fused", {"B1": NS * J, "B4": NS * J}),
                         ("streamed", {"B7": 2 * NS, "B9": 2 * NS, "B1": (J - 2) * NS,
                                       "B4": (J - 2) * NS})):
        F.reset_counters()
        kc = sharded_wavedec2(xsh, WV, J, mesh=mesh8, kernel=kern)
        kr = sharded_waverec2(kc, WV, mesh=mesh8, kernel=kern)
        torch.cuda.synchronize()
        got_l = {k: s.launches for k, s in F.KERNELS.items() if s.launches}
        print(f"sharded kernel='{kern}' J={J} launches: " + json.dumps(got_l), flush=True)
        require(got_l == expect, f"sharded kernel='{kern}' launched {json.dumps(expect)}")
        kern_launches[kern] = got_l
        err = max_abs(leaves(kc), leaves(want_sh))
        require(err <= 5e-4, f"sharded kernel='{kern}' pyramid vs separable oracle "
                f"max|diff| {err:.3e} <= 5e-4")
        err = max_abs(kr, xsh)
        require(err <= 1e-3, f"sharded kernel='{kern}' round trip max|err| {err:.3e} <= 1e-3")
    # the reference's mesh-of-1 gate (bench.py g_sharded_mesh1)
    mesh1 = make_mesh_2d(1, 1, devices=[card0])
    xs1 = torch.from_numpy(np.random.RandomState(5).rand(1024, 1024).astype(np.float32)).to(dev)
    want1 = sep.wavedec2(xs1, WV, 2)
    for kern in ("streamed", "fused"):
        got1 = sharded_wavedec2(xs1, WV, 2, mesh=mesh1, kernel=kern)
        err = max_abs(leaves(got1), leaves(want1))
        require(err <= 5e-4, f"mesh-of-1 kernel='{kern}' 1024x1024 J=2 vs oracle "
                f"max|diff| {err:.3e} <= 5e-4")
        err = max_abs(sharded_waverec2(got1, WV, mesh=mesh1, kernel=kern), xs1)
        require(err <= 1e-3, f"mesh-of-1 kernel='{kern}' round trip max|err| {err:.3e} <= 1e-3")

    def level_vs_plain(label, calls):
        """Each kept call of B1/B4/B7/B9 against its plain version on the
        same arguments, bit for bit; the kernel's error row takes the
        worst."""
        plain = {
            "fused_dwt2_level": ("B1", F.fused_dwt2_level, lambda a, e: F.dwt2_level_plain(
                a["x"], a["wavelet"], a["tile"], e)),
            "fused_idwt2_level": ("B4", F.fused_idwt2_level, lambda a, e: F.idwt2_level_plain(
                a["ll"], a["hl"], a["lh"], a["hh"], a["wavelet"], a["tile"], e)),
            "streamed_dwt2_level": ("B7", S.streamed_dwt2_level,
                                    lambda a, e: S.streamed_dwt2_level_plain(
                                        a["x"], a["wavelet"], a["ty"], a["tx"],
                                        S.TOP if e else 0)),
            "streamed_idwt2_level": ("B9", S.streamed_idwt2_level,
                                     lambda a, e: S.streamed_idwt2_level_plain(
                                         a["ll"], a["hl"], a["lh"], a["hh"], a["wavelet"],
                                         a["ty"], a["tx"], S.TOP if e else 0)),
        }
        require(len(calls) > 0, f"the {label} called the level kernels")
        for name, a in calls:
            k, kern, pl = plain[name]
            ext = a["boundary_rows"] == "extended"
            err = max_abs(leaves(kern(**a)), leaves(pl(a, ext)))
            torch.cuda.synchronize()
            errs[k] = max(errs[k], err)
            shape = "x".join(map(str, a.get("x", a.get("ll")).shape))
            what = f"{'an extended' if ext else 'a'} {shape} input of the {label}"
            require(err == 0, f"{k} kernel == plain bit for bit on {what}")

    # each per-shard kernel vs its plain version on the very blocks the
    # sharded kernel bodies give it: every level's extended block, the
    # fused fallback's below the strip walk, and the mesh-of-1 gate's
    from libdwt_torch.parallel import sharded as SH

    def sharded_bodies():
        for kern in ("fused", "streamed"):
            for m, a, levels in ((mesh8, xsh, J), (mesh1, xs1, 2)):
                sharded_waverec2(sharded_wavedec2(a, WV, levels, mesh=m, kernel=kern), WV,
                                 mesh=m, kernel=kern)
    level_vs_plain("sharded kernel bodies", spy_calls(SH, LEVEL_WRAPPERS, sharded_bodies))
    # batched int32 CDF 5/3 over a (2, 4) mesh: bit-exact
    mesh24 = make_mesh_2d(2, 4, devices=[card0] * 8)
    xb = torch.from_numpy(np.stack([test_image(512, 256, dtype=np.int32),
                                    test_image(512, 256, rand=1, dtype=np.int32)])).to(dev)
    gotb = sharded_wavedec2(xb, "cdf53", 2, mesh=mesh24)
    require(max_abs(leaves(gotb), leaves(sep.wavedec2(xb, "cdf53", 2))) == 0
            and max_abs(sharded_waverec2(gotb, "cdf53", mesh=mesh24), xb) == 0,
            "batched int32 cdf53 2x512x256 J=2 on a (2, 4) mesh == oracle, round trip exact")
    # the sharded volume: 64x512x512 J=2 over 4 z shards
    mesh4 = make_mesh_2d(1, 4, devices=[card0] * 4)
    vsh = sharded_wavedec3(v, WV, J3, mesh=mesh4)
    err = max_abs(leaves(vsh), leaves(want3))
    require(err <= 1e-4, f"sharded_wavedec3 {'x'.join(map(str, VOL))} J={J3} on 4 z shards "
            f"vs oracle max|diff| {err:.3e} <= 1e-4")
    err = max_abs(sharded_waverec3(vsh, WV, mesh=mesh4), v)
    require(err <= 1e-3, f"sharded volume round trip max|err| {err:.3e} <= 1e-3")
    # B18 vs its plain version at the level-1 shapes (8 blocks of 256x4096,
    # halo 4) and the inverse's channel rules
    hb = HS // NS
    b18_blocks = [xsh[i * hb: (i + 1) * hb] for i in range(NS)]
    errs["B18"] = max_abs(RH.rdma_extend_rows(b18_blocks, 4),
                          RH.rdma_extend_rows_plain(b18_blocks, 4))
    for mode in ("s", "d"):
        errs["B18"] = max(errs["B18"], max_abs(RH.rdma_extend_rows(b18_blocks, 2, mode),
                                               RH.rdma_extend_rows_plain(b18_blocks, 2, mode)))
    # the inverse's level-1 channel blocks: 8 x 128x4096 each
    s_blocks, d_blocks = [b[: hb // 2] for b in b18_blocks], [b[hb // 2:] for b in b18_blocks]
    errs["B18"] = max(errs["B18"], max_abs(
        list(RH.rdma_extend_channels(s_blocks, d_blocks, 2)),
        list(RH.rdma_extend_channels_plain(s_blocks, d_blocks, 2))))
    torch.cuda.synchronize()
    require(errs["B18"] == 0, "B18 kernel == plain at the level-1 shapes (8 x 256x4096, "
            "halo 4; channel halos 2, 's' and 'd'; the channel pair in one launch)")
    # the library yardstick: one torch.index_select of the frame's rows by
    # the gather's row map computes B18's function on these row views
    b18_idx = RH.gather_rows(NS, hb, 4, 1, 1).to(dev)
    require(max_abs(list(xsh.index_select(0, b18_idx).view(NS, hb + 8, W).unbind(0)),
                    RH.rdma_extend_rows_plain(b18_blocks, 4)) == 0,
            "torch.index_select of the frame's rows by gather_rows == B18's plain version "
            "at the level-1 shapes")
    # the push, the protocol of a line over several cards, on this card's
    # line: every edge mode at the level-1 shapes, its cooperative grid
    # within the card's co-resident blocks
    RH.LAST_GRID.clear()
    err = 0.0
    for halo, mode in ((4, "signal"), (2, "s"), (2, "d")):
        err = max(err, max_abs(RH._push_cuda(b18_blocks, halo, *RH._EDGE_MODES[mode]),
                               RH.rdma_extend_rows_plain(b18_blocks, halo, mode)))
    torch.cuda.synchronize()
    errs["B18"] = max(errs["B18"], err)
    print(f"B18 push on one card (path, grid, resident blocks): {json.dumps(RH.LAST_GRID)}",
          flush=True)
    require(err == 0, "B18's push == plain at the level-1 shapes on this card (8 x "
            "256x4096, halo 4; channel halos 2, 's' and 'd')")
    require(all(p == "push" and 1 <= g <= r for p, g, r in RH.LAST_GRID.values()),
            "B18's push: one cooperative launch whose grid fits the card's co-resident blocks")
    if torch.cuda.device_count() >= 2 and torch.cuda.can_device_access_peer(0, 1):
        two = [b18_blocks[i].to(torch.device("cuda", i % 2)) for i in range(4)]
        err = max_abs([g.cpu() for g in RH.rdma_extend_rows(two, 4)],
                      [p.cpu() for p in RH.rdma_extend_rows_plain(two, 4)])
        require(err == 0, "multi-card B18: ran on 4 shards over 2 cards, == plain")
    else:
        print(f"multi-card B18: skipped ({torch.cuda.device_count()} card(s) with peer "
              "access; needs 2)", flush=True)
    b18_bytes = sum(b.numel() for b in b18_blocks) * 4 + NS * (hb + 8) * W * 4
    b18_case = {"B18": (lambda: RH.rdma_extend_rows(b18_blocks, 4),
                        lambda: RH.rdma_extend_rows_plain(b18_blocks, 4), b18_bytes, 0)}

    # ---- float64 through every polyphase kernel: bit for bit == plain
    x64 = torch.from_numpy(rng.standard_normal((1024, 1024))).to(dev)
    v64 = torch.from_numpy(rng.standard_normal((32, 128, 128))).to(dev)
    b64 = F.fused_dwt2_level(x64, WV)
    c64 = F.fused_dwt2_2level(x64, WV)
    d64 = F.fused_deep_wavedec2(x64, WV, 3)
    s64 = S.streamed_dwt2_level(x64, WV)
    t64 = S.streamed_dwt2_2level(x64, WV)
    u64 = S.streamed_wavedec2_deep(x64, WV, 4)
    w64 = F3.fused_dwt3_level(v64, WV)
    f64_checks = (
        ("B1", b64, F.dwt2_level_plain(x64, WV)),
        ("B4", F.fused_idwt2_level(*b64, WV), F.idwt2_level_plain(*b64, WV)),
        ("B2", c64, F.fused_dwt2_2level_plain(x64, WV)),
        ("B5", F.fused_idwt2_2level(*c64, WV), F.fused_idwt2_2level_plain(*c64, WV)),
        ("B3", d64, F.fused_deep_wavedec2_plain(x64, WV, 3)),
        ("B6", F.fused_deep_waverec2(d64, WV), F.fused_deep_waverec2_plain(d64, WV)),
        ("B7", s64, S.streamed_dwt2_level_plain(x64, WV)),
        ("B9", S.streamed_idwt2_level(*s64, WV), S.streamed_idwt2_level_plain(*s64, WV)),
        ("B8", t64, S.streamed_dwt2_2level_plain(x64, WV)),
        ("B10", S.streamed_idwt2_2level(*t64, WV), S.streamed_idwt2_2level_plain(*t64, WV)),
        ("B11", u64, S.streamed_wavedec2_deep_plain(x64, WV, 4)),
        ("B12", S.streamed_waverec2_deep(u64, WV), S.streamed_waverec2_deep_plain(u64, WV)),
        ("B14", w64, F3.dwt3_level_plain(v64, WV)),
        ("B15", F3.fused_idwt3_level(w64, WV), F3.idwt3_level_plain(w64, WV)),
        ("B16", S3.streamed_dwt3_level(v64, WV), S3.dwt3_level_streamed_plain(v64, WV)),
        ("B17", S3.streamed_idwt3_level(w64, WV), S3.idwt3_level_streamed_plain(w64, WV)),
    )
    torch.cuda.synchronize()
    volume_feed("32x128x128 f64", tuple(v64.shape), 8)
    for k, got64, plain64 in f64_checks:
        require(all(a.dtype == torch.float64 for a in leaves(got64))
                and max_abs(leaves(got64), leaves(plain64)) == 0,
                f"float64 {k} kernel == plain bit for bit")
    # an explicit 'auto' pyramid with no table (the built-in thresholds)
    # re-dispatches each level: at 2144x4096 J=5 only level 2 (1072x2048)
    # takes the fused level
    with tune_table({}):
        F.reset_counters()
        ac = api.wavedec2(x, WV, J, impl="auto")
        ar = api.waverec2(ac, WV, impl="auto")
        torch.cuda.synchronize()
        auto_launches = {k: s.launches for k, s in F.KERNELS.items() if s.launches}
        print(f"explicit 'auto' J={J} launches: " + json.dumps(auto_launches), flush=True)
        require(auto_launches == {"B1": 1, "B4": 1},
                "explicit impl='auto' wavedec2/waverec2 with no table launched B1 and B4 "
                "once each")
        err = max_abs(leaves(ac), leaves(want))
        require(err <= 5e-4, f"explicit 'auto' pyramid vs oracle max|diff| {err:.3e} <= 5e-4")
        err = max_abs(ar, x)
        require(err <= 1e-3, f"explicit 'auto' round trip max|err| {err:.3e} <= 1e-3")
        level_vs_plain("explicit 'auto' pyramid", spy_calls(
            F, LEVEL_WRAPPERS[:2], lambda: api.waverec2(api.wavedec2(x, WV, J, impl="auto"),
                                                        WV, impl="auto")))


    # ---- times at the paths' shapes
    def timed(k, kern, plain, nbytes, ops, tensor_ops=0, tag=""):
        ms = time_ms(kern, args.reps)
        dev = device_ms(kern)
        plain_ms = time_ms(plain, max(3, args.reps // 4), warm=1)
        bytes_ms = nbytes / bw * 1e3
        ops_ms = (ops / flops + tensor_ops / tc_flops) * 1e3
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        tc = f", {tensor_ops / 1e9:.2f} Gflop on the tensor cores" if tensor_ops else ""
        dev = "not measured" if dev is None else f"{dev:.4f} ms"
        print(f"time {k}{tag}: kernel {ms:.4f} ms (device {dev}), plain {plain_ms:.4f} ms, "
              f"bound {max(bytes_ms, ops_ms):.4f} ms ({bound_by}; "
              f"{nbytes / 1e6:.1f} MB moved{tc}) [{smi}]", flush=True)
        return ms, plain_ms, max(bytes_ms, ops_ms), bound_by

    # ---- B3/B6 per call beside one launch of B1/B4 per level (the same
    # tile body), through B1/B4's wrappers
    def level_route_fwd():
        a = ll2
        for _ in range(3):
            a = F.fused_dwt2_level(a, WV)[0]

    def level_route_inv():
        a = deep_in[0]
        for lvl in deep_in[1:]:
            a = F.fused_idwt2_level(a, *lvl, WV)

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"

    for k, one, per_level in (("B3", cases["B3"][0], level_route_fwd),
                              ("B6", cases["B6"][0], level_route_inv)):
        print(f"time {k} per call (levels 3-5 of {H}x{W} f32): device {fmt(device_ms(one))} "
              f"(one cooperative launch, csrc/deep.cu); one B1/B4 launch per level: "
              f"device {fmt(device_ms(per_level))} [{smi}]", flush=True)

    # ---- the library yardsticks (never on the port's path).  The forward:
    # reflect padding by 4 (whole-point, as the kernels' mirror) and a
    # stride-2 conv2d with the level's four 9x9 analysis filters, chained
    # over the kernel's levels (B1/B7 one, B2/B8 two, B3 the deep three, B11
    # five); a stride-2 conv3d with the eight 9x9x9 filters for B14/B16.
    # The inverse: the whole-point symmetric extension of the signal is one
    # of the interleaved coefficients too (L at even positions, H at odd),
    # so a level is the four bands interleaved by pixel_shuffle (LL, HL,
    # LH, HH at the phases (even, even), (even, odd), (odd, even), (odd,
    # odd) in (y, x)), reflect-padded (3 before, 4 after), a stride-2 conv2d
    # to the four output phases with the 9x9 polyphase synthesis filters,
    # and pixel_shuffle back; chained over B4/B9's one level, B5/B10's two,
    # B6's deep three and B12's five; conv3d to the eight phases for
    # B15/B17.  The filters are outer products of 1-D pairs, read off the
    # oracle's response to unit impulses; TF32 off.
    import torch.nn.functional as nnf

    def analysis_pair():
        n, p = 32, 16
        pair = torch.zeros(2, 9, dtype=torch.float64)  # low, high
        for d in (0, 1):
            imp = torch.zeros(n, dtype=torch.float64)
            imp[p + d] = 1
            for k, band in enumerate(sep.dwt1(imp, WV)):
                for i in range(band.shape[0]):
                    if 0 <= p + d - 2 * i + 4 < 9:
                        pair[k, p + d - 2 * i + 4] = band[i]
        return pair

    def synthesis_pair():
        """Row p: the inverse's output 2a + p = sum_j y[2a + j] s_p[j + 3],
        j = -3..5, over the interleaved bands y (L even, H odd)."""
        n, p = 16, 8
        pair = torch.zeros(2, 9, dtype=torch.float64)  # even, odd output
        for d in (0, 1):  # the impulse in L (y even) or in H (y odd)
            bands = [torch.zeros(n, dtype=torch.float64) for _ in range(2)]
            bands[d][p] = 1
            out = sep.idwt1(*bands, WV)
            for m in range(out.shape[0]):
                if -3 <= 2 * p + d - 2 * (m // 2) <= 5:
                    pair[m % 2, 2 * p + d - 2 * (m // 2) + 3] = out[m]
        return pair

    lo_hi = analysis_pair()
    syn = synthesis_pair()
    # bands in the order of the plain level: LL, HL, LH, HH as (y, x) filters
    conv_w = torch.stack([torch.outer(lo_hi[fy], lo_hi[fx])
                          for fy, fx in ((0, 0), (0, 1), (1, 0), (1, 1))])[:, None]
    conv_w = conv_w.to(dev, torch.float32)
    # the 3-D bands by sorted (z, y, x) name, as leaves() orders them
    conv3_w = torch.stack([
        torch.einsum("i,j,k->ijk", *(lo_hi[int(c == "H")] for c in name))
        for name in sorted(b14_l1)])[:, None].to(dev, torch.float32)

    def conv_level(a):
        return nnf.conv2d(nnf.pad(a[None, None], (4, 4, 4, 4), mode="reflect"), conv_w,
                          stride=2)[0]

    def conv_chain(a, levels):
        out = []
        for _ in range(levels):
            a, *details = conv_level(a)
            out.append(details)
        return [a] + out[::-1]

    def conv3_level(a):
        return nnf.conv3d(nnf.pad(a[None, None], (4,) * 6, mode="reflect"), conv3_w,
                          stride=2)[0]

    # the inverse's output phases in pixel_shuffle's channel order, (y, x)
    # in 2-D and (z, y, x) in 3-D; a 3-D band's name gives its phases
    iconv_w = torch.stack([torch.outer(syn[py], syn[px]) for py in (0, 1)
                           for px in (0, 1)])[:, None].to(dev, torch.float32)
    phases3 = [(pz, py, px) for pz in (0, 1) for py in (0, 1) for px in (0, 1)]
    iconv3_w = torch.stack([torch.einsum("i,j,k->ijk", *(syn[p] for p in ph))
                            for ph in phases3])[:, None].to(dev, torch.float32)

    def iconv_level(ll, hl, lh, hh):
        y = nnf.pixel_shuffle(torch.stack([ll, hl, lh, hh])[None], 2)
        return nnf.pixel_shuffle(nnf.conv2d(nnf.pad(y, (3, 4, 3, 4), mode="reflect"),
                                            iconv_w, stride=2), 2)[0, 0]

    def iconv_chain(c):
        a = c[0]
        for lvl in c[1:]:
            a = iconv_level(a, *lvl)
        return a

    def shuffle3(t):  # (8, d, h, w), channel pz*4 + py*2 + px -> (2d, 2h, 2w)
        d, h, w = t.shape[-3:]
        return t.reshape(2, 2, 2, d, h, w).permute(3, 0, 4, 1, 5, 2).reshape(2 * d, 2 * h,
                                                                              2 * w)

    def iconv3_level(bands3):
        y = shuffle3(torch.stack([bands3["".join("LH"[p] for p in ph)] for ph in phases3]))
        return shuffle3(nnf.conv3d(nnf.pad(y[None, None], (3, 4) * 3, mode="reflect"),
                                   iconv3_w, stride=2)[0])

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib_inputs = [ll2] + [F.fused_deep_wavedec2_plain(ll2, WV, n)[0] for n in (1, 2)]
        for a in lib_inputs + [x]:
            err = max_abs(list(conv_level(a)), list(F.dwt2_level_plain(a, WV)))
            shape = "x".join(map(str, a.shape))
            require(err <= 3e-5, f"pad + conv2d level vs plain at {shape} max|diff| "
                    f"{err:.3e} <= 3e-5")
            print(f"time pad + conv2d level {shape}: {time_ms(lambda: conv_level(a), args.reps):.4f} "
                  f"ms (device {fmt(device_ms(lambda: conv_level(a)))}) [{smi}]", flush=True)
        err = max_abs(leaves(conv_chain(ll2, 3)), leaves(F.fused_deep_wavedec2_plain(ll2, WV, 3)))
        require(err <= 3e-5, f"pad + conv2d levels 3-5 vs B3's plain version max|diff| "
                f"{err:.3e} <= 3e-5")
        err = max_abs(leaves(conv_chain(x, 2)), leaves(F.fused_dwt2_2level_plain(x, WV)))
        require(err <= 3e-5, f"pad + conv2d levels 1-2 vs B2's plain version max|diff| "
                f"{err:.3e} <= 3e-5")
        err = max_abs(leaves(conv_chain(x, J)), leaves(want))  # a pyramid: the pyramid bound
        require(err <= 5e-4, f"pad + conv2d levels 1-{J} vs the oracle's pyramid max|diff| "
                f"{err:.3e} <= 5e-4")
        for a, tag in ((v, "level 1"), (ll3, "level 2")):
            err = max_abs(list(conv3_level(a)), leaves(F3.dwt3_level_plain(a, WV)))
            require(err <= 3e-5, f"pad + conv3d {tag} ({'x'.join(map(str, a.shape))}) vs "
                    f"B14's plain version max|diff| {err:.3e} <= 3e-5")
        for a, plain, tag in ((bands, F.idwt2_level_plain(*bands, WV), "level 1 vs B4's"),
                              (b5_in, F.fused_idwt2_2level_plain(*b5_in, WV),
                               "levels 2-1 vs B5's"),
                              (deep_in, F.fused_deep_waverec2_plain(deep_in, WV),
                               "levels 5-3 vs B6's")):
            got_ = iconv_level(*a) if a is bands else iconv_chain(list(a))
            err = max_abs(got_, plain)
            require(err <= 3e-5, f"pixel_shuffle + pad + conv2d {tag} plain version "
                    f"max|diff| {err:.3e} <= 3e-5")
        err = max_abs(iconv_chain(sc), x)  # the streamed J=5 pyramid: a round trip
        require(err <= 1e-3, f"pixel_shuffle + pad + conv2d levels {J}-1 of the streamed "
                f"pyramid round trip max|err| {err:.3e} <= 1e-3")
        for bands3, tag in ((b14_l1, "level 1"), (b14_l2, "level 2")):
            err = max_abs(iconv3_level(bands3), F3.idwt3_level_plain(bands3, WV))
            require(err <= 3e-5, f"shuffle + pad + conv3d {tag} vs B15's plain version "
                    f"max|diff| {err:.3e} <= 3e-5")
        library = {}
        fwd, inv = "pad + conv", "pixel_shuffle + pad + conv"
        for k, what, fn in (
                ("B1", f"{fwd}, level 1", lambda: conv_level(x)),
                ("B2", f"{fwd}, levels 1-2", lambda: conv_chain(x, 2)),
                ("B3", f"{fwd}, levels 3-5", lambda: conv_chain(ll2, 3)),
                ("B11", f"{fwd}, levels 1-{J}", lambda: conv_chain(x, J)),
                ("B14", f"{fwd}, 3-D level 1", lambda: conv3_level(v)),
                ("B14 level 2", f"{fwd}, 3-D level 2", lambda: conv3_level(ll3)),
                ("B4", f"{inv}, inverse level 1", lambda: iconv_level(*bands)),
                ("B5", f"{inv}, inverse levels 2-1", lambda: iconv_chain(list(b5_in))),
                ("B6", f"{inv}, inverse levels 5-3", lambda: iconv_chain(deep_in)),
                ("B12", f"{inv}, inverse levels {J}-1", lambda: iconv_chain(sc)),
                ("B15", f"{inv}, 3-D inverse level 1", lambda: iconv3_level(b14_l1)),
                ("B15 level 2", f"{inv}, 3-D inverse level 2", lambda: iconv3_level(b14_l2))):
            library[k] = time_ms(fn, args.reps)
            print(f"time library {k} ({what}): {library[k]:.4f} ms (device "
                  f"{fmt(device_ms(fn))}) [{smi}]", flush=True)
        # the same functions as B1, B2, B11, B14, B4, B5, B12 and B15 compute
        library.update(B7=library["B1"], B8=library["B2"], B16=library["B14"],
                       B9=library["B4"], B10=library["B5"], B17=library["B15"])
        library["B18"] = time_ms(lambda: xsh.index_select(0, b18_idx), args.reps)
        print(f"time library B18 (index_select of the frame's rows, {NS} x {hb}x{W} halo 4): "
              f"{library['B18']:.4f} ms (device "
              f"{fmt(device_ms(lambda: xsh.index_select(0, b18_idx)))}) [{smi}]", flush=True)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    rows = []
    all_cases = {**cases, **new_cases, **streamed_cases, **b18_case}
    for k in sorted(all_cases, key=lambda kid: int(kid[1:])):
        ms, plain_ms, bound_ms, bound_by = timed(k, *all_cases[k])
        st = F.KERNELS[k]
        rows.append({
            "name": f"{k} {st.name}", "route": "cuda", "source": st.source,
            "replaces": st.replaces, "launches": launches[k],
            "max_abs_err": errs[k], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library.get(k),
        })
    for k, case in level2.items():
        timed(k, *case, tag=f" level 2 ({'x'.join(map(str, ll3.shape))})")
    # B13: each banded instantiation beside its plain version and bound; the
    # row holds the J=5 pair, B11 + B12 with the banded body
    mxu_t = {k: timed("B13", *case, tag=f" in {k} (body='mxu')")
             for k, case in mxu_cases.items()}
    st = F.KERNELS["B13"]
    rows.append({
        "name": f"B13 {st.name} (in B11 + B12, J={J})", "route": "cuda",
        "source": st.source, "replaces": st.replaces, "launches": launches["B13"],
        "max_abs_err": errs["B13"],
        "ms": mxu_t["B11"][0] + mxu_t["B12"][0],
        "plain_ms": mxu_t["B11"][1] + mxu_t["B12"][1],
        "bound_ms": mxu_t["B11"][2] + mxu_t["B12"][2],
        "bound_by": "bytes" if all(mxu_t[k][3] == "bytes" for k in ("B11", "B12"))
        else "operations",
        "library_ms": library["B11"] + library["B12"],
    })
    rows.sort(key=lambda r: int(r["name"].split()[0][1:]))
    fwd_ms = time_ms(lambda: api.wavedec2(x, WV, J, impl="fused"), args.reps)
    inv_ms = time_ms(lambda: api.waverec2(coeffs, WV, impl="fused"), args.reps)
    sep_ms = time_ms(lambda: sep.wavedec2(x, WV, J), max(3, args.reps // 4), warm=1)
    print(f"time main path: wavedec2 {fwd_ms:.4f} ms, waverec2 {inv_ms:.4f} ms, "
          f"separable wavedec2 {sep_ms:.4f} ms "
          f"({H}x{W} f32 J={J}) [{smi}]", flush=True)
    fwd_ms = time_ms(lambda: api.dwt2(x, WV, impl="fused"), args.reps)
    inv_ms = time_ms(lambda: api.idwt2(*bands, WV, impl="fused"), args.reps)
    odd_ms = time_ms(lambda: api.wavedec2(xo, WV, J, impl="fused"), args.reps)
    fwd_dev = device_ms(lambda: api.dwt2(x, WV, impl="fused"))
    inv_dev = device_ms(lambda: api.idwt2(*bands, WV, impl="fused"))
    print(f"time single-level path: dwt2 {fwd_ms:.4f} ms (device {fmt(fwd_dev)}), idwt2 "
          f"{inv_ms:.4f} ms (device {fmt(inv_dev)}) ({H}x{W} f32), wavedec2 {odd_ms:.4f} ms "
          f"({HO}x{WO} f32 J={J}) [{smi}]", flush=True)
    fwd_ms = time_ms(lambda: api.wavedec2(x, WV, J, impl="streamed"), args.reps)
    inv_ms = time_ms(lambda: api.waverec2(sc, WV, impl="streamed"), args.reps)
    fwd2_ms = time_ms(lambda: api.wavedec2(x, WV, 2, impl="streamed"), args.reps)
    inv2_ms = time_ms(lambda: api.waverec2(s2c, WV, impl="streamed"), args.reps)
    print(f"time streamed path: wavedec2 {fwd_ms:.4f} ms, waverec2 {inv_ms:.4f} ms "
          f"(J={J}); wavedec2 {fwd2_ms:.4f} ms, waverec2 {inv2_ms:.4f} ms (J=2) "
          f"({H}x{W} f32) [{smi}]", flush=True)
    fwd_ms = time_ms(lambda: api.wavedec3(v, WV, J3, impl="fused"), args.reps)
    inv_ms = time_ms(lambda: api.waverec3(c3, WV, impl="fused"), args.reps)
    sep_ms = time_ms(lambda: sep.wavedec3(v, WV, J3), max(3, args.reps // 4), warm=1)
    print(f"time 3-D path: wavedec3 {fwd_ms:.4f} ms, waverec3 {inv_ms:.4f} ms, "
          f"separable wavedec3 {sep_ms:.4f} ms "
          f"({'x'.join(map(str, VOL))} f32 J={J3}) [{smi}]", flush=True)
    fwd_ms = time_ms(lambda: api.dwt2(x, WV, impl="streamed"), args.reps)
    inv_ms = time_ms(lambda: api.idwt2(*sbands, WV, impl="streamed"), args.reps)
    print(f"time streamed single-level path: dwt2 {fwd_ms:.4f} ms, idwt2 {inv_ms:.4f} ms "
          f"({H}x{W} f32) [{smi}]", flush=True)
    fwd_ms = time_ms(lambda: api.wavedec3(v, WV, J3, impl="streamed"), args.reps)
    inv_ms = time_ms(lambda: api.waverec3(sc3, WV, impl="streamed"), args.reps)
    fwd_dev = device_ms(lambda: api.wavedec3(v, WV, J3, impl="streamed"))
    inv_dev = device_ms(lambda: api.waverec3(sc3, WV, impl="streamed"))
    print(f"time streamed 3-D path: wavedec3 {fwd_ms:.4f} ms (device {fmt(fwd_dev)}), "
          f"waverec3 {inv_ms:.4f} ms (device {fmt(inv_dev)}) "
          f"({'x'.join(map(str, VOL))} f32 J={J3}) [{smi}]", flush=True)
    fwd_ms = time_ms(lambda: api.wavedec2(x, WV, J, impl="streamed-mxu"), args.reps)
    inv_ms = time_ms(lambda: api.waverec2(mc, WV, impl="streamed-mxu"), args.reps)
    fwd2_ms = time_ms(lambda: api.wavedec2(x, WV, 2, impl="streamed-mxu"), args.reps)
    inv2_ms = time_ms(lambda: api.waverec2(m2c, WV, impl="streamed-mxu"), args.reps)
    print(f"time streamed-mxu path: wavedec2 {fwd_ms:.4f} ms, waverec2 {inv_ms:.4f} ms "
          f"(J={J}); wavedec2 {fwd2_ms:.4f} ms, waverec2 {inv2_ms:.4f} ms (J=2) "
          f"({H}x{W} f32) [{smi}]", flush=True)

    fwd_ms = time_ms(lambda: sharded_wavedec2(xsh, WV, J, mesh=mesh8, halo_impl="rdma"),
                     args.reps)
    inv_ms = time_ms(lambda: sharded_waverec2(shc, WV, mesh=mesh8, halo_impl="rdma"),
                     args.reps)
    pfwd_ms = time_ms(lambda: sharded_wavedec2(xsh, WV, J, mesh=mesh8), args.reps)
    pinv_ms = time_ms(lambda: sharded_waverec2(pp, WV, mesh=mesh8), args.reps)
    kt = {kern: (time_ms(lambda: sharded_wavedec2(xsh, WV, J, mesh=mesh8, kernel=kern),
                         args.reps),
                 time_ms(lambda: sharded_waverec2(pp, WV, mesh=mesh8, kernel=kern), args.reps))
          for kern in ("fused", "streamed")}
    print(f"time sharded path ({NS} shards of {HS}x{W} f32 J={J} on one card): rdma "
          f"wavedec2 {fwd_ms:.4f} ms, waverec2 {inv_ms:.4f} ms; ppermute wavedec2 "
          f"{pfwd_ms:.4f} ms, waverec2 {pinv_ms:.4f} ms; kernel='fused' wavedec2 "
          f"{kt['fused'][0]:.4f} ms, waverec2 {kt['fused'][1]:.4f} ms; kernel='streamed' "
          f"wavedec2 {kt['streamed'][0]:.4f} ms, waverec2 {kt['streamed'][1]:.4f} ms "
          f"[{smi}]", flush=True)

    # B18 at each launch shape of the sharded rdma path, in launch order: the
    # forward's halo-4 extension of each level's blocks, then per inverse
    # level (coarse first) the 's' and 'd' channel extensions (halo 2) of
    # its stacked bands in one launch; each beside its byte bound (inputs
    # read once, outputs written once) and one torch.index_select a channel
    # of the same rows (contiguous frames, the index built once)
    b18_calls, gather = [], RH._gather_cuda

    def keep_b18(lines, halo, dev_):
        b18_calls.append(([(list(b), t_off, b_off) for b, t_off, b_off in lines], halo, dev_))
        return gather(lines, halo, dev_)

    RH._gather_cuda = keep_b18
    try:
        sharded_waverec2(sharded_wavedec2(xsh, WV, J, mesh=mesh8, halo_impl="rdma"), WV,
                         mesh=mesh8, halo_impl="rdma")
    finally:
        RH._gather_cuda = gather
    torch.cuda.synchronize()
    require(len(b18_calls) == 2 * J, f"the sharded rdma path made {2 * J} B18 launches")
    # the forward's blocks of levels 2-5 are transposed views, which the
    # wrapper copies before the launch: time contiguous copies, and only
    # B18's own kernel.  Levels 2-5 fit in the card's L2 (50 MB), so
    # back-to-back repeats read them warm, as the path does (a level reads
    # what the last one wrote); the byte bound is HBM's, so each shape is
    # also timed cold, the L2
    # filled with other lines by a 256 MB read before each call (a read
    # leaves no dirty lines to write back; only the kernel's own records
    # count).  Cold, the L2 still takes the outputs' writes and writes them
    # back after the kernel ends, so a cold time can fall below the bound
    # where the outputs fit in it (level 1's 34.6 MB); warm, each call pays
    # the last one's write-backs
    evict = torch.zeros(1 << 26, dtype=torch.float32, device=dev)

    def cold():  # a sum of each 4 KB row: one kernel, no cross-block memset
        return evict.view(-1, 1024).sum(1)

    b18_parts, b18_bound = [], 0.0
    b18_sum = dict.fromkeys(("warm", "cold", "lib", "lib_cold"), 0.0)

    def add(key, t):
        b18_sum[key] = None if b18_sum[key] is None or t is None else b18_sum[key] + t

    for i, (lines, halo, dev_) in enumerate(b18_calls):
        lines = [([b.contiguous() for b in blocks], t_off, b_off)
                 for blocks, t_off, b_off in lines]
        frames = [torch.cat(blocks) for blocks, _, _ in lines]
        idxs = [RH.gather_rows(len(blocks), blocks[0].shape[0], halo, t_off,
                               b_off).to(dev_) for blocks, t_off, b_off in lines]
        got = gather(lines, halo, dev_)
        require(max_abs([torch.stack(o).view(-1, o[0].shape[1]) for o in got],
                        [f.index_select(0, ix) for f, ix in zip(frames, idxs)]) == 0,
                f"B18 launch {i + 1} of the sharded path == index_select of its rows")
        nbytes = sum((f.numel() + ix.numel() * f.shape[1]) * f.element_size()
                     for f, ix in zip(frames, idxs))
        bound = nbytes / bw * 1e3

        def gather_once():
            return gather(lines, halo, dev_)

        def select_once():
            return [f.index_select(0, ix) for f, ix in zip(frames, idxs)]

        # the trace drops whole passes here now and then: more tries
        t = device_ms(gather_once, tries=6, only="gather_kernel")
        tc = device_ms(lambda: (cold(), gather_once()), tries=6, only="gather_kernel")
        lib_t = device_ms(select_once, tries=6)
        lib_c = device_ms(lambda: (cold(), select_once()), tries=6, skip="reduce_kernel")
        n_, bh, bw_ = len(lines[0][0]), *lines[0][0][0].shape
        what = (f"forward level {i + 1}" if i < J else
                f"inverse level {J - (i - J)} s+d")
        b18_parts.append(f"{what} {n_} x {bh}x{bw_} halo {halo}: {fmt(t)} warm, {fmt(tc)} "
                         f"cold (bound {bound:.4f} ms; index_select {fmt(lib_t)} warm, "
                         f"{fmt(lib_c)} cold)")
        for key, ms_ in (("warm", t), ("cold", tc), ("lib", lib_t), ("lib_cold", lib_c)):
            add(key, ms_)
        b18_bound += bound
    del evict
    loss = {k: None if b18_sum[k] is None else b18_sum[k] - b18_bound
            for k in ("warm", "cold")}
    print(f"time B18 per launch (device, the sharded {HS}x{W} f32 J={J} rdma path on "
          f"{NS} shards of this card; warm: repeats back to back, the small levels from L2, "
          f"where their HBM byte bounds are not bounds; cold: a 256 MB read before each "
          f"call evicts them): " + "; ".join(b18_parts)
          + f"; sum {fmt(b18_sum['warm'])} warm, {fmt(b18_sum['cold'])} cold, bound "
          f"{b18_bound:.4f} ms, loss {fmt(loss['warm'])} warm, {fmt(loss['cold'])} cold; "
          f"index_select {fmt(b18_sum['lib'])} "
          f"warm, {fmt(b18_sum['lib_cold'])} cold [{smi}]", flush=True)
    profile_path(f"B18 at the level-1 shapes ({NS} x {hb}x{W}, halo 4)",
                 lambda: RH.rdma_extend_rows(b18_blocks, 4), smi)
    profile_path(f"sharded rdma path J={J} (sharded_wavedec2 + sharded_waverec2)",
                 lambda: sharded_waverec2(sharded_wavedec2(xsh, WV, J, mesh=mesh8,
                                                           halo_impl="rdma"),
                                          WV, mesh=mesh8, halo_impl="rdma"),
                 smi)
    profile_path("main path (wavedec2 + waverec2)",
                 lambda: api.waverec2(api.wavedec2(x, WV, J, impl="fused"), WV, impl="fused"),
                 smi)
    profile_path(f"streamed path J={J} (wavedec2 + waverec2)",
                 lambda: api.waverec2(api.wavedec2(x, WV, J, impl="streamed"), WV,
                                      impl="streamed"),
                 smi)
    profile_path("streamed path J=2 (wavedec2 + waverec2)",
                 lambda: api.waverec2(api.wavedec2(x, WV, 2, impl="streamed"), WV,
                                      impl="streamed"),
                 smi)
    profile_path("3-D path (wavedec3 + waverec3)",
                 lambda: api.waverec3(api.wavedec3(v, WV, J3, impl="fused"), WV, impl="fused"),
                 smi)
    profile_path("streamed single-level path (dwt2 + idwt2)",
                 lambda: api.idwt2(*api.dwt2(x, WV, impl="streamed"), WV, impl="streamed"),
                 smi)
    profile_path("streamed 3-D path (wavedec3 + waverec3)",
                 lambda: api.waverec3(api.wavedec3(v, WV, J3, impl="streamed"), WV,
                                      impl="streamed"),
                 smi)
    profile_path(f"streamed-mxu path J={J} (wavedec2 + waverec2)",
                 lambda: api.waverec2(api.wavedec2(x, WV, J, impl="streamed-mxu"), WV,
                                      impl="streamed-mxu"),
                 smi)
    profile_path("streamed-mxu path J=2 (wavedec2 + waverec2)",
                 lambda: api.waverec2(api.wavedec2(x, WV, 2, impl="streamed-mxu"), WV,
                                      impl="streamed-mxu"),
                 smi)

    # ---- the measured 'auto' table: the tuner, then the packaged table
    # driving the default pyramid and volume (after the paths' times, so its
    # profiler sessions come after theirs)
    autotune_phase(x, v, J, J3, want, want3, args.reps, smi)

    # ---- the riders: the plain-torch modules on the card, and denoise2
    # on the fused main path
    riders(x, args.seed, args.reps, smi)

    # ---- the tools: Image/Volume through files and the fused kernels,
    # selftest, interop, Gabor, perf and the CLI
    tools(x, args.seed, args.reps, smi, flops)

    # ---- the example programs (examples_torch/) on the card vs the CPU
    examples_phase(smi)

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
