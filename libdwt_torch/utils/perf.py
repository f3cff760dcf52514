"""Performance measurement harness and system info.

The port of ``libdwt_tpu.utils.perf``, libdwt's perf layer:
  * the dwt_util_perf_* / dwt_util_measure_perf_* protocol: M transforms
    x N trials, keep the minimum, report secs/pixel vs size, TSV output
    for gnuplot (libdwt.c:21391-21517, 22559-22646, :22640 TSV write);
  * the clock abstraction (libdwt.h:1589-1658): here CUDA events on the
    card and ``time.perf_counter`` on the CPU;
  * dwt_util_print_info and host + device introspection
    (libdwt.c:20604-20638), with page-fault counters from the native
    backend (system.c:353).
"""
from __future__ import annotations

import ctypes
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from libdwt_torch.utils import nativelib
from libdwt_torch.utils.device import resolve_device

__all__ = ["measure", "measure_perf_2d", "pin_benchmark_env", "save_tsv",
           "page_faults", "info"]


def _leaves(tree) -> List:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _on_cuda(tree) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in _leaves(tree))


def measure(
    fn: Callable, *args, trials: int = 5, warmup: int = 1, fence: bool = False
) -> float:
    """Min-of-N seconds of ``fn(*args)`` including device time (libdwt's
    min-of-N rule, libdwt.c:21441-21481).

    When the arguments or the warm-up's outputs lie on the card, each
    trial is timed with CUDA events recorded around the call and its
    wait; otherwise with ``time.perf_counter``.  The wait is
    ``torch.cuda.synchronize()``, or with ``fence=True`` a read of the
    first output leaf, which ``fn`` must make a scalar checksum computed
    from its outputs (``.item()`` returns only once the device has
    finished it).
    """
    out = None
    for _ in range(warmup):
        out = fn(*args)
    cuda = _on_cuda(args) or _on_cuda(out)

    def wait(res):
        if fence:
            float(_leaves(res)[0].item())
        elif cuda:
            torch.cuda.synchronize()

    if out is not None:
        wait(out)
    best = float("inf")
    for _ in range(trials):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            wait(fn(*args))
            stop.record()
            stop.synchronize()
            secs = start.elapsed_time(stop) / 1e3
        else:
            t0 = time.perf_counter()
            wait(fn(*args))
            secs = time.perf_counter() - t0
        best = min(best, secs)
    return best


def _fenced(transform: Callable) -> Callable:
    """``transform`` returning (scalar checksum of its outputs, outputs):
    the first element of every output leaf, summed in float32."""
    def fenced(a):
        out = transform(a)
        s = sum(leaf.reshape(-1)[:1].to(torch.float32).sum() for leaf in _leaves(out))
        return s, out
    return fenced


def measure_perf_2d(
    transform: Callable,
    sizes: Sequence[int] = (32, 64, 128, 256, 512, 1024),
    dtype=np.float32,
    trials: int = 5,
    fence: bool = True,
    device=None,
) -> List[Tuple[int, float, float]]:
    """Sweep square sizes; returns [(n, secs_per_pixel, mpix_per_s)].

    The dwt_util_measure_perf_cdf97_2_s analogue (libdwt.c:22559-22646),
    on ``device`` (default: the card).  The data come from
    ``numpy.random.RandomState(0)``, as in the reference.  ``fence=True``
    (the default) wraps the transform with a scalar checksum and forces
    completion by reading it (see :func:`measure`).
    """
    dev = resolve_device(device)
    rows = []
    rng = np.random.RandomState(0)
    for n in sizes:
        data = rng.rand(n, n)
        if np.issubdtype(np.dtype(dtype), np.integer):
            data = data * 255  # an all-zero int image would be trivial
        x = torch.as_tensor(data.astype(dtype), device=dev)
        fn = _fenced(transform) if fence else transform
        secs = measure(fn, x, trials=trials, fence=fence)
        spp = secs / (n * n)
        rows.append((n, spp, 1.0 / spp / 1e6))
    return rows


def measure_perf_1d(
    transform: Callable,
    lengths: Sequence[int] = (256, 1024, 4096, 16384, 65536),
    batch: int = 64,
    dtype=np.float32,
    trials: int = 5,
    fence: bool = True,
    device=None,
) -> List[Tuple[int, float, float]]:
    """Sweep 1-D signal lengths (a ``batch`` of rows per call, the way
    libdwt sweeps M-signal working sets); returns
    [(n, secs_per_sample, msamples_per_s)].

    The dwt_util_measure_perf_cdf97_1_s analogue (libdwt.c:22388)."""
    dev = resolve_device(device)
    rows = []
    rng = np.random.RandomState(0)
    for n in lengths:
        x = torch.as_tensor(rng.rand(batch, n).astype(dtype), device=dev)
        fn = _fenced(transform) if fence else transform
        secs = measure(fn, x, trials=trials, fence=fence)
        sps = secs / (batch * n)
        rows.append((n, sps, 1.0 / sps / 1e6))
    return rows


def save_tsv(path: str, rows: Sequence[Tuple]) -> None:
    """Write sweep rows as TSV (gnuplot input, libdwt's output format at
    libdwt.c:22640-22641)."""
    with open(path, "w") as f:
        for row in rows:
            f.write("\t".join(str(v) for v in row) + "\n")


def page_faults() -> Tuple[int, int]:
    """(minor, major) page faults of this process (system.c:353);
    (0, 0) without the native lib."""
    lib = nativelib.get()
    if lib is None:
        return (0, 0)
    mn = ctypes.c_int64()
    mj = ctypes.c_int64()
    if lib.ldt_page_faults(ctypes.byref(mn), ctypes.byref(mj)) != 0:
        return (0, 0)
    return (mn.value, mj.value)


def info() -> Dict[str, object]:
    """Host + device info dict (dwt_util_print_info analogue): on the card
    ``platform`` is ``'gpu'`` and ``device_kind`` the card's name; without
    CUDA, ``'cpu'``."""
    out: Dict[str, object] = {}
    if torch.cuda.is_available():
        out["platform"] = "gpu"
        out["device_kind"] = torch.cuda.get_device_name()
        out["device_count"] = torch.cuda.device_count()
    else:
        out["platform"] = "cpu"
        out["device_kind"] = "cpu"
        out["device_count"] = 1
    lib = nativelib.get()
    if lib is not None:
        n = ctypes.c_int64()
        l1 = ctypes.c_int64()
        line = ctypes.c_int64()
        if lib.ldt_host_info(ctypes.byref(n), ctypes.byref(l1), ctypes.byref(line)) == 0:
            out["host_cpus"] = n.value
            out["l1_dcache_bytes"] = l1.value
            out["l1_line_bytes"] = line.value
    out["native_backend"] = nativelib.available()
    return out


def pin_benchmark_env(cpu: int = 0, realtime: bool = False) -> bool:
    """Benchmark hygiene: pin affinity (and optionally SCHED_FIFO) like
    libdwt's env_single_threading + realtime scheduler
    (system.c:305-351,475-521).  Returns True if the affinity pin
    succeeded."""
    lib = nativelib.get()
    if lib is None:
        return False
    ok = lib.ldt_set_affinity(cpu) == 0
    if realtime:
        lib.ldt_set_realtime()  # usually needs privileges; best-effort
    return ok
