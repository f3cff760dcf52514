"""Autotuner over kernel strategy and tile size, wired into dispatch.

The port of ``libdwt_tpu.autotune``.  The search space is {separable
oracle, fused, streamed, streamed-mxu} for whole pyramids (and {separable,
fused, streamed} for a volume level), measured ON THE LIVE DEVICE and
cached two ways:

  * in-process, exact-shape cache (this module's _CACHE)
  * an on-disk table per device kind, bucketed by size
    (``~/.cache/libdwt_torch/autotune.json`` or $LIBDWT_TORCH_TUNE_FILE,
    else the packaged ``libdwt_torch/data/autotune.json``), which
    ``api._pick_impl``/``_pick_impl3`` consult on every 'auto' dispatch
    of a CUDA tensor, so production dispatch uses measured crossovers
    once ``tune_dispatch()`` (tools/tune_torch.py) has run on the card.

The device kind is ``torch.cuda.get_device_name()`` ("cpu" off the card).
Table keys name dtypes as numpy does (``"float32"``), so one JSON file
reads the same in both packages.  Candidates are timed as chains of
frames issued back to back with one fence a chain (CUDA events on the
card): the slope between two chain lengths keeps each frame's host cost,
which a caller pays, and cancels the chain's fixed cost.
"""
from __future__ import annotations

import functools
import json
import os
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from libdwt_torch.models.wavelets import get_wavelet
from libdwt_torch.utils.device import resolve_device
from libdwt_torch.utils.perf import _leaves, measure

__all__ = [
    "autotune_dwt2",
    "best_config",
    "clear_cache",
    "tune_dispatch",
    "dispatch_choice",
    "tune_file",
    "validate_table",
]

_CACHE: Dict[Tuple, Dict] = {}
_DISK: Optional[Dict] = None  # lazily loaded {device_kind: {key: entry}}

#: B1's tile edges (band samples a side) that autotune_dwt2 tries; the
#: CUDA kernel takes any tile with 2 * tile + 8 <= 256 (csrc/level.cu).
_TILES = (32, 64, 96)
#: size buckets for the dispatch table (min-edge, power-of-two floors)
_BUCKETS = (128, 256, 512, 1024, 2048, 4096)


def clear_cache() -> None:
    global _DISK
    _CACHE.clear()
    _DISK = None


def tune_file() -> str:
    env = os.environ.get("LIBDWT_TORCH_TUNE_FILE")
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "libdwt_torch", "autotune.json"
    )


@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def _device_kind(device=None) -> str:
    """The table's key for ``device`` (default: the card if there is one):
    the card's name, or ``"cpu"``.  Read on every 'auto' dispatch, so the
    name is looked up once per card."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    return _card_name(torch.cuda.current_device() if dev.index is None else dev.index)


#: nominal HBM bandwidth per card, GB/s (NVIDIA's data sheets), matched
#: against the device kind in order: the plausibility ceiling for measured
#: timings.
_BW_GBPS = (
    ("h100 nvl", 3900.0),
    ("h100 pcie", 2000.0),
    ("h100", 3350.0),  # SXM5, "NVIDIA H100 80GB HBM3"
)


def _nominal_bw_gbps(kind: Optional[str] = None) -> float:
    """Bandwidth of ``kind`` (default: this process's device kind); the
    lowest listed figure for a card not in the list."""
    kind = (_device_kind() if kind is None else kind).lower()
    for key, bw in _BW_GBPS:
        if key in kind:
            return bw
    return min(bw for _, bw in _BW_GBPS)


def _packaged_table() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "autotune.json")


def _load_disk() -> Dict:
    global _DISK
    if _DISK is None:
        for path in (tune_file(), _packaged_table()):
            try:
                with open(path) as f:
                    _DISK = json.load(f)
                break
            except (OSError, ValueError):
                continue
        else:
            _DISK = {}
    return _DISK


def _save_disk(table: Dict) -> None:
    path = tune_file()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)


def _bucket(h: int, w: int) -> Optional[int]:
    edge = min(h, w)
    best = None
    for b in _BUCKETS:
        if edge >= b:
            best = b
    return best


def _dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype (``torch.float32`` ->
    ``"float32"``): the table's spelling."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, _dtype_name(dtype))


def _itemsize(name: str) -> int:
    """Bytes of the dtype a table key names (bfloat16 too); 4 if unknown."""
    try:
        return np.dtype(name).itemsize
    except TypeError:
        dt = getattr(torch, name, None)
        return dt.itemsize if isinstance(dt, torch.dtype) else 4


def _checksummed(tree):
    """Completion witness: the sum of every leaf's first element.  Eager
    PyTorch runs each candidate whole, so unlike XLA nothing can narrow
    a candidate down to the elements the checksum reads; the first
    elements are views, so the witness costs two small launches."""
    firsts = [leaf[(0,) * leaf.ndim].to(torch.float32)
              for leaf in _leaves(tree) if leaf.numel()]
    return torch.stack(firsts).sum(), tree


# ------------------------------------------------------- per-shape tuning


def _cache_key(shape, wavelet, dtype, device) -> Tuple:
    return (tuple(shape), _dtype_name(dtype), str(wavelet), resolve_device(device).type)


def autotune_dwt2(shape, wavelet="cdf97", dtype=torch.float32, trials: int = 5,
                  device=None):
    """Measure candidates for a single-level 2-D transform of ``shape``
    on ``device`` (default: the card) and cache the fastest: the
    separable oracle and B1 at each tile of ``_TILES``.  Returns the
    winning config dict (``{"impl": "fused", "tile": t, "secs": s}`` or
    ``{"impl": "separable", "secs": s}``)."""
    from libdwt_torch.ops.fused import fused_dwt2_level, fused_supported
    from libdwt_torch.ops.separable import dwt2_level

    key = _cache_key(shape, wavelet, dtype, device)
    if key in _CACHE:
        return _CACHE[key]
    h, w = shape
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(h, w)).to(_torch_dtype(dtype)).to(resolve_device(device))
    results = []

    def sep(a):
        return _checksummed(dwt2_level(a, wavelet))

    results.append(({"impl": "separable"}, measure(sep, x, trials=trials, fence=True)))
    if min(h, w) >= 32 and fused_supported(wavelet):
        for tile in _TILES:
            def fused(a, t=tile):
                return _checksummed(fused_dwt2_level(a, wavelet, tile=t))

            results.append(({"impl": "fused", "tile": tile},
                            measure(fused, x, trials=trials, fence=True)))
    best = min(results, key=lambda r: r[1])
    cfg = dict(best[0], secs=best[1])
    _CACHE[key] = cfg
    return cfg


def best_config(shape, wavelet="cdf97", dtype=torch.float32, device=None) -> Optional[Dict]:
    """Cached winner for an exact shape on ``device``, or None if not
    tuned yet."""
    return _CACHE.get(_cache_key(shape, wavelet, dtype, device))


# --------------------------------------------------- dispatch-level tuning


def _pyramid_candidates(wavelet, levels: int, direction: str = "fwd",
                        shape=None, dtype=torch.float32):
    """(name, per-frame fn) candidates for a full wavedec2/waverec2
    pyramid, each what ``api`` runs for that impl.  ``direction='inv'``
    candidates take the same frame input and run the separable forward,
    then the candidate's inverse, so the candidate DIFFERENCE is the
    inverse cost.  The polyphase streamed inverse builds at every size
    here, so 'streamed' is offered wherever the streamed geometry holds."""
    from libdwt_torch.ops.banded import mxu_supported
    from libdwt_torch.ops.fused import fused_supported, fused_wavedec2, fused_waverec2
    from libdwt_torch.ops.separable import wavedec2 as sep_wavedec2
    from libdwt_torch.ops.separable import waverec2 as sep_waverec2
    from libdwt_torch.ops.streamed import (streamed_supported, streamed_wavedec2,
                                           streamed_waverec2)

    streamed_ok = shape is not None and levels >= 2 and streamed_supported(
        shape, wavelet, 256, levels=2
    )
    mxu_ok = mxu_supported(wavelet, _torch_dtype(dtype))
    if direction == "fwd":
        cands = [("separable", lambda a: sep_wavedec2(a, wavelet, levels))]
        if fused_supported(wavelet):
            cands.append(("fused", lambda a: fused_wavedec2(a, wavelet, levels)))
        if streamed_ok:
            cands.append(("streamed", lambda a: streamed_wavedec2(a, wavelet, levels)))
            if mxu_ok:
                cands.append(("streamed-mxu",
                              lambda a: streamed_wavedec2(a, wavelet, levels, body="mxu")))
        return cands
    cands = [("separable",
              lambda a: sep_waverec2(sep_wavedec2(a, wavelet, levels), wavelet))]
    if fused_supported(wavelet):
        cands.append(("fused",
                      lambda a: fused_waverec2(sep_wavedec2(a, wavelet, levels), wavelet)))
    if streamed_ok:
        cands.append(("streamed",
                      lambda a: streamed_waverec2(sep_wavedec2(a, wavelet, levels), wavelet,
                                                  body="poly")))
        if mxu_ok:
            cands.append(("streamed-mxu",
                          lambda a: streamed_waverec2(sep_wavedec2(a, wavelet, levels),
                                                      wavelet, body="mxu")))
    return cands


def _make_stacks(shape, dtype, ka: int, kb: int, device=None) -> Dict:
    """The two chained input stacks on ``device`` (default: the card),
    from a seed-0 ``RandomState`` as in the reference; built once per
    size and shared by every candidate, so all candidates measure the
    same data and the host->device copy is paid once."""
    rng = np.random.RandomState(0)
    dev = resolve_device(device)
    dt = _torch_dtype(dtype)
    return {k: torch.from_numpy(rng.rand(k, *shape)).to(dt).to(dev) for k in (ka, kb)}


def _chain_slope_secs(frame_fn, stacks: Dict, trials: int = 8):
    """Per-frame seconds via the two-length chain slope: each trial issues
    the K frames of a stack back to back, each with its checksum, and
    fences once on their sum (``.item()``); no frame waits for the
    device.  On the card CUDA events around the K frames time a chain, on
    the CPU ``time.perf_counter``.  The slope between the two lengths
    cancels a chain's fixed cost and keeps each frame's host cost.
    ``stacks`` maps chain length -> stacked inputs (:func:`_make_stacks`).

    Returns ``(secs, kind)`` with kind 'slope' (a real per-frame
    measurement) or 'upper' (the long chain's mean, the fallback when the
    frames hid inside the fixed cost: an upper BOUND, fine for same-bucket
    ranking but not comparable across sizes).  The kind is persisted with
    the entry so :func:`validate_table` knows which numbers are
    measurements."""
    ka, kb = sorted(stacks)
    cuda = stacks[kb].is_cuda

    def chain(stack):
        return torch.stack([_checksummed(frame_fn(a))[0] for a in stack]).sum()

    def timed(stack) -> float:
        if not cuda:
            t0 = time.perf_counter()
            float(chain(stack).item())
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        total = chain(stack)
        stop.record()
        float(total.item())
        return start.elapsed_time(stop) / 1e3

    for k in (ka, kb):
        float(chain(stacks[k]).item())
    best = {ka: float("inf"), kb: float("inf")}
    for _ in range(trials):
        for k in (ka, kb):
            best[k] = min(best[k], timed(stacks[k]))
    slope = (best[kb] - best[ka]) / (kb - ka)
    upper = best[kb] / kb
    # a near-zero slope means the frames hid inside the fixed cost (small
    # sizes): the chain average is then the honest (if pessimistic)
    # estimator for ranking
    if 0.05 * upper < slope <= upper:
        return slope, "slope"
    return upper, "upper"


#: an entry's winner must be within this factor of the runner-up; a
#: larger gap between kernels doing the same arithmetic is a timing
#: artifact, not physics.
_PLAUSIBLE_WIN_FACTOR = 8.0
#: implied bandwidth may exceed the device's nominal HBM bandwidth by
#: at most this factor before the measurement is called impossible.
_PLAUSIBLE_BW_FACTOR = 1.3


def _entry_pixels(entry, bucket: int) -> int:
    m = entry.get("measured_at", bucket)
    if isinstance(m, (list, tuple)):
        return int(m[0]) * int(m[1])
    return int(m) * int(m)


def _bytes_per_pixel(direction: str, itemsize: int = 4) -> float:
    """Minimal HBM traffic per pixel for plausibility floors: a forward
    candidate reads + writes every pixel once (2 x itemsize); an 'inv'
    entry times fwd+inv together (4 x itemsize)."""
    return (2.0 if direction == "fwd" else 4.0) * itemsize


def _drop_implausible(rows: Dict, pixels: int, direction: str,
                      bw_gbps: float, kinds: Optional[Dict] = None,
                      itemsize: int = 4) -> Dict:
    """Remove physically impossible candidate timings before picking a
    winner: implied HBM traffic above the device's bandwidth, or a
    'winner' implausibly far ahead of the runner-up (both signatures of
    a failed completion fence).  Returns the surviving rows (never
    empties a single-candidate dict).

    ``kinds`` maps candidate -> estimator kind ('slope'/'upper', see
    :func:`_chain_slope_secs`).  The win-factor rule only compares
    SAME-KIND estimates: a real 'slope' measurement legitimately beats an
    'upper' bound by far more than the factor at small buckets."""
    kinds = kinds or {}
    bytes_pp = _bytes_per_pixel(direction, itemsize)
    floor_secs = pixels * bytes_pp / (bw_gbps * _PLAUSIBLE_BW_FACTOR * 1e9)
    rows = dict(rows)
    for name in [n for n, s in rows.items() if s < floor_secs]:
        if len(rows) == 1:
            break
        print(f"tune: dropping {name}={rows[name]:.3g}s (implies "
              f"> {_PLAUSIBLE_BW_FACTOR:g}x device bandwidth)",
              file=sys.stderr)
        del rows[name]
    while len(rows) >= 2:
        order = sorted(rows, key=rows.get)
        best, second = rows[order[0]], rows[order[1]]
        if best * _PLAUSIBLE_WIN_FACTOR >= second:
            break
        if kinds.get(order[0], "slope") != kinds.get(order[1], "slope"):
            # slope-vs-upper gaps are expected, not artifacts
            break
        print(f"tune: dropping {order[0]}={best:.3g}s "
              f"({second / best:.0f}x ahead of the runner-up — timing "
              "artifact)", file=sys.stderr)
        del rows[order[0]]
    return rows


def validate_table(mine: Dict, bw_gbps: float = 3350.0) -> list:
    """Consistency findings for one device kind's dispatch table (empty
    list = plausible).  Flags (a) entries whose winner implies more than
    ~device bandwidth, (b) winners implausibly far ahead of their
    runner-up, (c) a candidate whose SLOPE-measured per-frame time
    DECREASES as the frame grows between adjacent buckets (more pixels
    cannot take less time): signatures of measurements that would pin
    wrong dispatch winners.  ``bw_gbps`` is the table's card's figure
    (:func:`_nominal_bw_gbps` of its kind).

    'upper'-kind estimates (entry['estimator']) are bounds, not
    measurements: they rank candidates within their own bucket but are
    exempt from the cross-bucket check.  Entries with no estimator map
    are treated as slope-measured."""
    findings = []
    families: Dict[Tuple, Dict[int, Tuple[Dict, Dict]]] = {}
    for key, entry in mine.items():
        parts = key.split(":")
        if not parts[0].isdigit() or "secs" not in entry:
            continue
        bucket = int(parts[0])
        fam = tuple(parts[1:])
        rows = entry["secs"]
        kinds = entry.get("estimator", {})
        winner = min(rows, key=rows.get)
        best = rows[winner]
        pixels = _entry_pixels(entry, bucket)
        itemsize = _itemsize(parts[1]) if len(parts) > 1 else 4
        bytes_pp = _bytes_per_pixel("fwd" if "inv" not in parts else "inv", itemsize)
        implied = pixels * bytes_pp / best / 1e9
        if implied > bw_gbps * _PLAUSIBLE_BW_FACTOR:
            findings.append(
                f"{key}: winner {winner}={best:.3g}s implies "
                f"{implied:.0f} GB/s (> {_PLAUSIBLE_BW_FACTOR:g}x device "
                f"bandwidth {bw_gbps:.0f})")
        if len(rows) >= 2:
            order = sorted(rows, key=rows.get)
            second = rows[order[1]]
            same_kind = (kinds.get(order[0], "slope")
                         == kinds.get(order[1], "slope"))
            if best * _PLAUSIBLE_WIN_FACTOR < second and same_kind:
                findings.append(
                    f"{key}: winner {winner}={best:.3g}s is "
                    f"{second / best:.0f}x ahead of the runner-up "
                    f"({second:.3g}s) — timing artifact")
        families.setdefault(fam, {})[bucket] = (rows, kinds)
    for fam, by_bucket in families.items():
        buckets = sorted(by_bucket)
        for b1, b2 in zip(buckets, buckets[1:]):
            rows1, kinds1 = by_bucket[b1]
            rows2, kinds2 = by_bucket[b2]
            for cand in set(rows1) & set(rows2):
                if (kinds1.get(cand, "slope") != "slope"
                        or kinds2.get(cand, "slope") != "slope"):
                    continue
                s1, s2 = rows1[cand], rows2[cand]
                if s1 > s2 * 1.2:
                    findings.append(
                        f"{':'.join(fam)}: {cand} takes {s1:.3g}s at "
                        f"bucket {b1} but only {s2:.3g}s at the LARGER "
                        f"bucket {b2} — measured in different dispatch windows?")
    return findings


def _measure_rows(candidates, stacks: Dict, trials: int, label: str, unit: str):
    """Chain-slope every candidate: (secs, estimator kinds, failures).  A
    candidate that raises is recorded in the failures, so it counts as
    attempted."""
    rows, kinds, failed = {}, {}, {}
    for name, fn in candidates:
        try:
            rows[name], kinds[name] = _chain_slope_secs(fn, stacks, trials=trials)
        except Exception as e:  # device-dependent: recorded in the entry
            failed[name] = f"{type(e).__name__}: {str(e)[:120]}"
            print(f"{label}:{name} failed: {failed[name]}", file=sys.stderr)
            continue
        print(f"{label}:{name} = {rows[name]:.3e} s/{unit} ({kinds[name]})",
              file=sys.stderr)
    return rows, kinds, failed


def tune_dispatch(
    sizes=(256, 512, 1024, 2048),
    wavelet="cdf97",
    dtype=torch.float32,
    levels: int = 3,
    trials: int = 8,
    save: bool = True,
    device=None,
) -> Dict:
    """Measure the full-pyramid crossover between the separable oracle
    and the kernels at each size bucket on ``device`` (default: the
    card) and persist the winners under its device kind; 'auto' dispatch
    then uses the measured table.

    ``sizes`` entries are square edges (int) or explicit ``(h, w)``
    shapes (tune a bucket at the real frame geometry).  Implausible
    candidate timings are dropped before the winner is picked
    (:func:`_drop_implausible`) and the finished table is checked with
    :func:`validate_table` (findings go to stderr)."""
    dev = resolve_device(device)
    kind = _device_kind(dev)
    wname = get_name(wavelet)
    dt = _dtype_name(dtype)
    table = dict(_load_disk())
    mine = dict(table.get(kind, {}))
    bw = _nominal_bw_gbps(kind)
    for n in sizes:
        shape = (tuple(int(s) for s in n) if isinstance(n, (tuple, list))
                 else (int(n), int(n)))
        # key by the dispatch-time bucket (a size between buckets would
        # otherwise write an entry dispatch_choice can never read)
        b = _bucket(*shape)
        if b is None:
            print(f"tune: size {n} below the smallest bucket; skipped",
                  file=sys.stderr)
            continue
        stacks = _make_stacks(shape, dtype, 8, 32, dev)
        pixels = shape[0] * shape[1]
        for direction in ("fwd", "inv"):
            rows, kinds, failed = _measure_rows(
                _pyramid_candidates(wavelet, levels, direction, shape=shape, dtype=dtype),
                stacks, trials, f"tune: {n}:{direction}", "frame")
            key = f"{b}:{dt}:{wname}" + ("" if direction == "fwd" else ":inv")
            if not rows:
                if failed:
                    # every candidate failed: persist the failures so
                    # completeness checks see the attempt
                    mine[key] = {"failed": failed, "failed_torch": torch.__version__,
                                 "measured_at": list(shape)}
                continue
            kept = _drop_implausible(rows, pixels, direction, bw, kinds=kinds,
                                     itemsize=_itemsize(dt))
            entry = {
                "impl": min(kept, key=kept.get),
                "secs": kept,
                "estimator": {k: kinds[k] for k in kept},
                "measured_at": shape[0] if shape[0] == shape[1] else list(shape),
            }
            dropped = {k: v for k, v in rows.items() if k not in kept}
            if dropped:
                # evidence of the artifact, kept OUT of the ranking data
                entry["dropped"] = dropped
            if failed:
                # a failure is environment-specific: stamp it so an
                # upgrade re-tries the candidate
                entry["failed"] = failed
                entry["failed_torch"] = torch.__version__
            mine[key] = entry
        del stacks
    for finding in validate_table(mine, bw):
        print(f"tune: TABLE WARNING: {finding}", file=sys.stderr)
    table[kind] = mine
    if save:
        _save_disk(table)
    global _DISK
    _DISK = table
    return mine


def _volume_candidates(wavelet, shape3, direction: str = "fwd", itemsize: int = 4):
    """(name, per-volume fn) candidates for a single-level 3-D
    transform; 'inv' runs the separable forward, then the candidate's
    inverse (the shared forward cancels)."""
    from libdwt_torch.ops.fused3d import fused_dwt3_level, fused_idwt3_level
    from libdwt_torch.ops.separable import dwt3_level, idwt3_level
    from libdwt_torch.ops.streamed3d import (streamed3d_supported, streamed_dwt3_level,
                                             streamed_idwt3_level)

    streamed_ok = streamed3d_supported(shape3, wavelet, itemsize=itemsize)
    if direction == "fwd":
        cands = [("separable", lambda v: dwt3_level(v, wavelet)),
                 ("fused", lambda v: fused_dwt3_level(v, wavelet))]
        if streamed_ok:
            cands.append(("streamed", lambda v: streamed_dwt3_level(v, wavelet)))
        return cands
    cands = [
        ("separable", lambda v: idwt3_level(dwt3_level(v, wavelet), wavelet)),
        ("fused", lambda v: fused_idwt3_level(dwt3_level(v, wavelet), wavelet)),
    ]
    if streamed_ok:
        cands.append(("streamed",
                      lambda v: streamed_idwt3_level(dwt3_level(v, wavelet), wavelet)))
    return cands


def tune_dispatch3(
    shape3=(64, 512, 512),
    wavelet="cdf97",
    dtype=torch.float32,
    trials: int = 8,
    save: bool = True,
    probe_timeout_s: float = 600.0,
    device=None,
) -> Dict:
    """Measure the 3-D single-level crossover (separable vs fused vs
    streamed) on ``device`` (default: the card); persisted under a
    'vol:' key and consulted by api._pick_impl3's 'auto'.

    Each entry's kernel candidates (its non-separable rows) then face a
    bounded SUBPROCESS probe in the entry's own direction
    (:func:`probe_volume_compile`: the forward kernel for the forward
    entry, the inverse for ':inv'); a candidate whose fresh process
    fails or outlasts ``probe_timeout_s`` is recorded in the entry's
    'probe' map and demoted at dispatch time (:func:`_entry_impl`).  Set
    ``probe_timeout_s=0`` to skip probing."""
    dev = resolve_device(device)
    kind = _device_kind(dev)
    wname = get_name(wavelet)
    dt = _dtype_name(dtype)
    table = dict(_load_disk())
    mine = dict(table.get(kind, {}))
    stacks = _make_stacks(shape3, dtype, 2, 6, dev)
    for direction in ("fwd", "inv"):
        rows, kinds, failed = _measure_rows(
            _volume_candidates(wavelet, shape3, direction, itemsize=_itemsize(dt)),
            stacks, trials, f"tune3: {direction}", "volume")
        key = f"vol:{dt}:{wname}" + ("" if direction == "fwd" else ":inv")
        if not rows:
            if failed:
                mine[key] = {"failed": failed, "failed_torch": torch.__version__,
                             "measured_at": list(shape3)}
            continue
        entry = {"impl": min(rows, key=rows.get), "secs": rows, "estimator": kinds,
                 "measured_at": list(shape3)}
        if failed:
            entry["failed"] = failed
            entry["failed_torch"] = torch.__version__
        if probe_timeout_s > 0:
            entry["probe"] = {}
            for cand in (c for c in rows if c != "separable"):
                entry["probe"][cand] = probe_volume_compile(
                    shape3, wavelet, dtype, impl=cand, timeout_s=probe_timeout_s,
                    direction=direction)
                print(f"tune3: probe {direction}:{cand}: {entry['probe'][cand]}",
                      file=sys.stderr)
        mine[key] = entry
    del stacks
    table[kind] = mine
    if save:
        _save_disk(table)
    global _DISK
    _DISK = table
    return mine


def _impl_lookup(mine: Dict, base: str, direction: str) -> Optional[str]:
    """Table lookup with the ':inv' direction split (falling back to
    the forward entry for tables written before the split)."""
    entry = None
    if direction == "inv":
        entry = mine.get(base + ":inv")
    if entry is None:
        entry = mine.get(base)
    if entry is None:
        return None
    return _entry_impl(entry)


def _entry_impl(entry: Dict) -> Optional[str]:
    """An entry's dispatch winner, demoted past candidates whose PROBE
    failed.  ``entry['probe']`` maps impl -> 'ok' | 'timeout' |
    'error: ...' (written by :func:`probe_volume_compile`): a winner
    whose bounded subprocess run wedged or died must not be dispatched
    to, so the fastest candidate whose probe is ok (or was never probed)
    wins instead."""
    impl = entry.get("impl")
    probe = entry.get("probe")
    if not probe or probe.get(impl, "ok") == "ok":
        return impl
    secs = entry.get("secs", {})
    ranked = sorted(secs, key=secs.get)
    for cand in ranked:
        if probe.get(cand, "ok") == "ok":
            return cand
    return impl


def volume_choice(dtype, wavelet, direction: str = "fwd") -> Optional[str]:
    """Measured 3-D 'auto' choice for the device kind, or None.
    Respects probe verdicts (see :func:`_entry_impl`)."""
    disk = _load_disk()
    mine = disk.get(_device_kind())
    if not mine:
        return None
    return _impl_lookup(mine, f"vol:{_dtype_name(dtype)}:{get_name(wavelet)}", direction)


#: snippet run in the probe subprocess: build or load the kernels, run ONE
#: volume level through the named kernel in ``direction`` (the inverse on
#: the separable forward's bands), fence on a checksum.  Off the card it
#: runs the kernels' plain versions on the CPU.
_PROBE_SNIPPET = """
import numpy as np
import torch
from libdwt_torch.ops.fused import KERNELS
from libdwt_torch.ops.separable import dwt3_level
if {impl!r} == "streamed":
    from libdwt_torch.ops.streamed3d import streamed_dwt3_level as fwd
    from libdwt_torch.ops.streamed3d import streamed_idwt3_level as inv
else:
    from libdwt_torch.ops.fused3d import fused_dwt3_level as fwd
    from libdwt_torch.ops.fused3d import fused_idwt3_level as inv
dev = "cuda" if torch.cuda.is_available() else "cpu"
v = torch.from_numpy(np.random.RandomState(0).rand({z}, {y}, {x}))
v = v.to(getattr(torch, {dtype!r})).to(dev)
if {direction!r} == "fwd":
    out = fwd(v, {wavelet!r})["LLL"]
else:
    out = inv(dwt3_level(v, {wavelet!r}), {wavelet!r})
if dev == "cuda" and not any(k.launches for k in KERNELS.values()):
    raise SystemExit("no kernel launched")
print("PROBE_OK", float(out.reshape(-1)[0].item()))
"""


def probe_volume_compile(
    shape3=(64, 512, 512),
    wavelet="cdf97",
    dtype=torch.float32,
    impl: str = "streamed",
    timeout_s: float = 600.0,
    direction: str = "fwd",
) -> str:
    """Run the 3-D kernel ``impl`` ONCE in ``direction`` in a fresh
    SUBPROCESS with a hard timeout, so a kernel that cannot be built,
    loaded or run in a new process (or hangs) costs ``timeout_s``, not
    the tune run.  The subprocess gets this process's kernel build
    directory (``LIBDWT_TORCH_BUILD``), so it loads the libraries built
    here.  Returns 'ok', 'timeout' or 'error: ...'."""
    import subprocess

    from libdwt_torch.ops import _cuda

    z, y, x = shape3
    code = _PROBE_SNIPPET.format(
        z=z, y=y, x=x, impl=impl, dtype=_dtype_name(dtype),
        wavelet=get_name(wavelet), direction=direction)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["LIBDWT_TORCH_BUILD"] = str(_cuda.build_dir())
    try:
        res = subprocess.run(
            [sys.executable, "-c", code],
            capture_output=True, text=True, timeout=timeout_s,
            cwd=root, env=env,
        )
    except subprocess.TimeoutExpired:
        return "timeout"
    if res.returncode == 0 and "PROBE_OK" in res.stdout:
        return "ok"
    tail = (res.stderr or res.stdout).strip().splitlines()
    return f"error: rc={res.returncode} {tail[-1][:160] if tail else ''}"


def dispatch_choice(
    h: int, w: int, dtype, wavelet, direction: str = "fwd"
) -> Optional[str]:
    """Measured 'auto' dispatch choice for a shape, or None when the
    device kind has not been tuned (caller falls back to its built-in
    thresholds).  ``direction='inv'`` consults the inverse crossover
    table.  A shape whose own bucket is untuned uses the largest tuned
    bucket below it (the best measured predictor available)."""
    disk = _load_disk()
    mine = disk.get(_device_kind())
    if not mine:
        return None
    b = _bucket(h, w)
    if b is None:
        return None
    name = get_name(wavelet)
    dt = _dtype_name(dtype)
    for bb in [x for x in reversed(_BUCKETS) if x <= b]:
        impl = _impl_lookup(mine, f"{bb}:{dt}:{name}", direction)
        if impl is not None:
            return impl
    return None


def get_name(wavelet) -> str:
    return get_wavelet(wavelet).name
