"""One run of one benchmark cell of libdwt_torch.

A cell is ``<config>.<mix>``: the configuration ``configs/<config>.json``
(the frame and the transform), the traffic mix ``mixes/<mix>.json`` (the
direction and the closed loop), the limits ``limits/<cell>.json`` of the
numbers that decide ``correct``, and the metric readers
``metrics/<metric>.py`` that ``BENCHMARK.json`` names for the cell; each
is found by its name, so a new cell, mix or metric is new files.

The run: a pool of seeded frames made on the device (12-bit samples with
the DC level shift; for decode, their coefficients by the reference),
a warm-up through the window's own call, then the window: a closed loop
that keeps up to ``in_flight`` calls of ``libdwt_torch.api.wavedec2``
(encode) or ``waverec2`` (decode), with no ``impl``, outstanding, waits
on the oldest frame's completion event when the queue is full, and
draws the inputs from the pool in turn.  With tracing, a further
sub-window of ``trace_frames`` frames runs under the profiler.  Then a
sample of the window's outputs, drawn from the seed, is held against the
reference (:mod:`portbench.check`).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import random
import sys
import time
import traceback
from collections import deque
from pathlib import Path
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parent
#: top-level module names that may not be loaded by a run's end
FORBIDDEN = ("jax", "jaxlib", "flax", "libdwt_tpu")
PLATFORM = "gpu"

__all__ = ["Cell", "Window", "Trace", "RunRecord", "load_cell", "run_cell",
           "forbidden_modules"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path


@dataclasses.dataclass
class Window:
    """A closed-loop stretch: frames submitted (all completed), host
    seconds from the first call's start to the last completion, each
    frame's latency and call time (seconds), calls that raised."""
    frames: int
    seconds: float
    latencies: List[float]
    submits: List[float]
    failed: int


@dataclasses.dataclass
class Trace:
    """The profiled sub-window: its window, device records (name, start
    ns, duration ns) and host spans (kind, start ns, end ns)."""
    window: Window
    records: list
    spans: list


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""
    cfg: dict
    mix: dict
    device_name: str
    setup_s: float
    window: Window
    trace: Optional[Trace]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metrics, name: str):
    return [m for m in metrics if name in m.get("workloads", [name])]


def load_cell(workload: str, spec_path: Path, bench_dir: Path = BENCH_DIR) -> Cell:
    spec = _json(spec_path)
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in {spec_path}")
    return Cell(
        name=workload, chips=int(entry["chips"]),
        cfg=_json(bench_dir / "configs" / f"{entry['config']}.json"),
        mix=_json(bench_dir / "mixes" / f"{entry['traffic']}.json"),
        limits=_json(bench_dir / "limits" / f"{workload}.json"),
        end_to_end=_for_cell(spec["end_to_end"], workload),
        per_layer=_for_cell(spec["per_layer"], workload),
        bench_dir=bench_dir,
    )


def read_metric(bench_dir: Path, name: str, record: RunRecord):
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(record)


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ----------------------------------------------------------------- inputs

def _dtype(name: str):
    import torch

    return {"float32": torch.float32, "float64": torch.float64,
            "int32": torch.int32}[name]


def make_pool(cfg, mix, seed: int, device):
    """``pool_frames`` frames of ``components x rows x columns`` samples,
    uniform on 0 .. 2**bits - 1 from ``seed``, DC level shifted, in the
    configuration's dtype; made on ``device`` in one call."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (mix["pool_frames"], cfg["components"], cfg["rows"], cfg["columns"])
    x = torch.randint(0, 1 << cfg["sample_bits"], shape, generator=gen,
                      device=device, dtype=torch.int32)
    x += cfg["dc_level_shift"]
    return x.to(_dtype(cfg["dtype"]))


def decode_inputs(cfg, pool):
    """Each pool frame's pyramid by the reference (float64, then the
    configuration's dtype), one component at a time: the coefficients
    that the decode window reconstructs, the same for every side."""
    import torch

    from portbench.check import reference_output

    out = []
    for frame in pool:
        comps = [reference_output(cfg, "encode", frame, c)
                 for c in range(cfg["components"])]
        bands = [torch.stack([comp[i] for comp in comps]).to(frame.dtype)
                 for i in range(len(comps[0]))]
        del comps
        out.append([bands[0]] + [tuple(bands[i:i + 3]) for i in range(1, len(bands), 3)])
    return out


# ------------------------------------------------------------ the program

class Program:
    """The system under test: the default entry (no ``impl``)."""

    def __init__(self, cfg, direction: str):
        from libdwt_torch import api

        self.api = api
        self.cfg = cfg
        self.encode = direction == "encode"

    def __call__(self, x):
        if self.encode:
            return self.api.wavedec2(x, self.cfg["wavelet"], level=self.cfg["levels"])
        return self.api.waverec2(x, self.cfg["wavelet"])

    def impl_line(self, device) -> str:
        """The impl that 'auto' takes for the window's frames."""
        import torch

        cfg = self.cfg
        try:
            impl = self.api._pick_impl(
                cfg["rows"], cfg["columns"], cfg["wavelet"], None,
                torch.device(device).type == "cuda", _dtype(cfg["dtype"]),
                levels=cfg["levels"], direction="fwd" if self.encode else "inv")
        except (AttributeError, TypeError) as e:
            impl = f"unknown ({e!r})"
        return (f"impl: {'wavedec2' if self.encode else 'waverec2'} with no impl took "
                f"{impl!r} for ({cfg['components']}, {cfg['rows']}, {cfg['columns']}) "
                f"{cfg['dtype']} {cfg['wavelet']} J={cfg['levels']}")


def kernel_counts() -> dict:
    """The program's kernel counters (calls, launches) that are not 0."""
    try:
        from libdwt_torch.ops.fused import KERNELS
    except ImportError:
        return {}
    return {k: (s.calls, s.launches) for k, s in KERNELS.items() if s.calls or s.launches}


def reset_kernel_counts() -> None:
    try:
        from libdwt_torch.ops.fused import reset_counters
    except ImportError:
        return
    reset_counters()


# ------------------------------------------------------------ closed loop

class _HostDone:
    """Completion on the CPU, where each call has finished on return."""

    def record(self):
        pass

    def synchronize(self):
        pass


def _completions(device, n: int):
    import torch

    if torch.device(device).type == "cuda":
        return [torch.cuda.Event() for _ in range(n)]
    return [_HostDone() for _ in range(n)]


class Reservoir:
    """A uniform sample of ``k`` of the window's (input index, output)
    pairs, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(f"portbench-sample-{seed}")
        self.items = []
        self.seen = 0

    def __call__(self, index: int, out) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((index, out))
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = (index, out)


def closed_loop(program, inputs, in_flight: int, device, seconds: float = None,
                frames: int = None, keep=None, spans: list = None,
                errors: list = None) -> Window:
    """Submit ``program(inputs[i % len(inputs)])`` for ``seconds`` (or
    ``frames`` calls), at most ``in_flight`` outstanding; when the queue is
    full, wait on the oldest frame's completion event.  ``keep(index,
    output)`` sees each frame when it completes; ``spans`` collects host
    spans on ``time.time_ns()``; ``errors`` the first traceback."""
    done = _completions(device, in_flight)
    pending = deque()
    latencies, submits = [], []
    failed = n = 0
    clock, now_ns = time.perf_counter, time.time_ns

    def retire():
        t0, ev, index, out = pending.popleft()
        w0 = now_ns()
        ev.synchronize()
        latencies.append(clock() - t0)
        if spans is not None:
            spans.append(("waiting on a frame's completion", w0, now_ns()))
        if keep is not None and out is not None:
            keep(index, out)

    begin = clock()
    deadline = begin + seconds if seconds is not None else math.inf
    while (n < frames) if frames is not None else (clock() < deadline):
        if len(pending) == in_flight:
            retire()
        index = n % len(inputs)
        s0 = now_ns()
        t0 = clock()
        try:
            out = program(inputs[index])
        except Exception:  # a failed call counts against the run; keep going
            failed += 1
            out = None
            if errors is not None and not errors:
                errors.append(traceback.format_exc())
        submits.append(clock() - t0)
        if spans is not None:
            spans.append(("in the program's call", s0, now_ns()))
        ev = done[n % in_flight]
        ev.record()
        pending.append((t0, ev, index, out))
        n += 1
    while pending:
        retire()
    return Window(n, clock() - begin, latencies, submits, failed)


# ------------------------------------------------------------------- run

def _power_line(device_name: str) -> str:
    import subprocess

    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        smi = res.stdout.strip().splitlines()[0] if res.returncode == 0 else "unread"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        smi = "unread"
    return f"device: {device_name}; nvidia-smi name, power.limit: {smi}"


def _trace_window(program, inputs, mix, device) -> Trace:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.tracing import device_records

    spans = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window = closed_loop(program, inputs, mix["in_flight"], device,
                             frames=mix["trace_frames"], spans=spans)
    return Trace(window, device_records(prof), spans)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print):
    """One run; returns the result object (the last line's JSON)."""
    import torch

    from portbench import check, tracing

    cfg, mix = cell.cfg, cell.mix
    direction = mix["direction"]
    on_cuda = torch.device(device).type == "cuda"
    device_name = torch.cuda.get_device_name(device) if on_cuda else "cpu"

    pool = make_pool(cfg, mix, seed, device)
    inputs = list(pool) if direction == "encode" else decode_inputs(cfg, pool)
    if direction != "encode":
        del pool
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    program = Program(cfg, direction)
    log(program.impl_line(device))

    # warm-up: the window's own call, as many outputs alive as the window
    # holds at most (in flight and sampled)
    reset_kernel_counts()
    held = []
    warm = closed_loop(program, inputs, mix["in_flight"], device,
                       frames=mix["in_flight"] + mix["sample_frames"] + 1,
                       keep=lambda i, out: held.append(out))
    del held
    log(f"kernels after warm-up ({warm.frames} frames; calls, launches): {kernel_counts()}")
    if trace and on_cuda:  # the profiler's first pass in a process
        _trace_window(program, inputs, dict(mix, trace_frames=2), device)
    if on_cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    reset_kernel_counts()
    sample = Reservoir(mix["sample_frames"], seed)
    errors = []
    window = closed_loop(program, inputs, mix["in_flight"], device, seconds=seconds,
                         keep=sample, errors=errors)
    log(f"kernels over the window ({window.frames} frames; calls, launches): "
        f"{kernel_counts()}")
    traced = _trace_window(program, inputs, mix, device) if trace and on_cuda else None
    if traced is not None and traced.records and traced.spans:
        log(f"trace: {len(traced.records)} device records over {traced.window.frames} frames "
            f"in {traced.window.seconds:.6f} s; the first record starts "
            f"{(traced.records[0][1] - traced.spans[0][1]) / 1e3:.1f} us after the first "
            f"call's start, the last ends {(traced.spans[-1][2] - sum(traced.records[-1][1:])) / 1e3:.1f} "
            "us before the last wait's end")
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    log(_power_line(device_name))
    log(f"memory_peak_bytes: {peak}")
    if errors:
        print(f"first failed call:\n{errors[0]}", file=sys.stderr)

    # correct: the sample against the reference, once the window is closed
    numbers = {name: 0.0 for name in check.number_names(cfg, direction)}
    compared = len(sample.items)
    for index, out in sample.items:
        try:
            got = check.compare(cfg, direction, inputs[index], out)
        except ValueError as e:
            print(f"output of pool frame {index} not comparable: {e}", file=sys.stderr)
            got = {name: math.inf for name in numbers}
        for name, value in got.items():
            numbers[name] = max(numbers[name], value)
    sample.items.clear()
    checks = {name: {"value": value, "limit": cell.limits[name]["limit"]}
              for name, value in numbers.items()}
    correct = (window.failed == 0 and compared > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    record = RunRecord(cfg, mix, device_name, setup_s, window, traced)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = read_metric(cell.bench_dir, m["name"], record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": PLATFORM, "kind": device_name, "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": window.frames,
              "failed": window.failed, "metrics": metrics, "device": dev}
    if traced is not None:
        busy = tracing.union_ns(traced.records) / 1e9
        dev.update(busy_s=busy, window_s=traced.window.seconds)
        result["breakdown"] = {
            "device_ops": tracing.device_ops(traced.records),
            "idle_gaps": tracing.idle_gaps(traced.records, traced.spans)}
    result["checks"] = checks
    return result
