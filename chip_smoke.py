#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed N] [--reps N]

1. Builds every CUDA kernel of the port from ``libdwt_torch/csrc``.
2. Drives the main path once through the public API:
   ``libdwt_torch.api.wavedec2`` / ``waverec2`` with CDF 9/7, float32,
   J=5, ``impl='fused'`` on a 2144x4096 frame made from a numpy seed,
   and checks from the launch counts that the two-level kernels (B2, B5)
   and the deep tails (B3, B6) ran.
3. Checks the pyramid against the port's separable oracle on the card
   (max |diff| <= 5e-4) and the round trip (max |err| <= 1e-3).
4. Holds each kernel against its plain PyTorch version on the card at
   its main-path shapes (float32: <= 3e-5), and runs int32 CDF 5/3
   through each kernel at 512x512 (exactly equal to the plain versions
   and to the separable oracle).
5. Times each kernel and its plain version with CUDA events, beside the
   card's bound for the same work, and prints the card's name and power
   limit, a JSON line of kernels, and last the contract line.

Exits non-zero, printing no result line, when there is no CUDA device
or any check fails.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# (memory bytes/s, float32 non-tensor-core FLOP/s) by card, from NVIDIA's
# data sheets; matched against torch.cuda.get_device_name in order.
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51.2e12),
    ("H100 NVL", 3.9e12, 60.0e12),
    ("H200", 4.8e12, 67.0e12),
    ("H100", 3.35e12, 67.0e12),
)
#: float ops per pixel per level of a 4-step lifting pass on both axes:
#: per axis 4 steps x 3 ops on half the samples, plus one scale multiply.
OPS_PER_PIXEL_LEVEL = 13


def card_peaks(name: str):
    for key, bw, fl in CARD_PEAKS:
        if key in name:
            return bw, fl
    raise SystemExit(f"no peak rates known for card {name!r}")


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


def profile_main_path(run, smi: str) -> None:
    """Device time by kernel name and the device's busy share over one
    forward + inverse run of the main path (torch.profiler, CUPTI)."""
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
        print("profile main path: no device time recorded (not measured)")
        return
    print(f"profile main path (wavedec2 + waverec2, {smi}): wall {wall_us:.1f} us, "
          f"device busy {busy:.1f} us ({100 * busy / wall_us:.1f}%)")
    for key, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"profile   {us:10.1f} us  x{n:<3d} {key[:90]}")


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    print(f"ok  {what}", flush=True)


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
    from libdwt_torch.ops import separable as sep
    from libdwt_torch.utils.testimg import test_image

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    bw, flops = card_peaks(name)
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
    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(rng.random((H, W), dtype=np.float32)).to(dev)
    torch.cuda.synchronize()
    F.reset_counters()
    coeffs = api.wavedec2(x, WV, J, impl="fused")
    rec = api.waverec2(coeffs, WV, impl="fused")
    torch.cuda.synchronize()
    launches = {k: s.launches for k, s in F.KERNELS.items()}
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
    cases = {
        "B2": (lambda: F.fused_dwt2_2level(x, WV),
               lambda: F.fused_dwt2_2level_plain(x, WV),
               x.numel() * 4 * 2, x.numel() * 1.25),
        "B3": (lambda: F.fused_deep_wavedec2(ll2, WV, 3),
               lambda: F.fused_deep_wavedec2_plain(ll2, WV, 3),
               ll2.numel() * 4 * 2, ll2.numel() * (1 + 1 / 4 + 1 / 16)),
        "B6": (lambda: F.fused_deep_waverec2(deep_in, WV),
               lambda: F.fused_deep_waverec2_plain(deep_in, WV),
               ll2.numel() * 4 * 2, ll2.numel() * (1 + 1 / 4 + 1 / 16)),
        "B5": (lambda: F.fused_idwt2_2level(*b5_in, WV),
               lambda: F.fused_idwt2_2level_plain(*b5_in, WV),
               x.numel() * 4 * 2, x.numel() * 1.25),
    }
    errs = {}
    for k, (kern, plain, _, _) in cases.items():
        errs[k] = max_abs(leaves(kern()), leaves(plain()))
        torch.cuda.synchronize()
        require(errs[k] <= 3e-5, f"{k} kernel vs plain at main-path shapes "
                f"max|diff| {errs[k]:.3e} <= 3e-5")

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

    # ---- 5. times at the main-path shapes
    rows = []
    for k, (kern, plain, nbytes, pix) in cases.items():
        ms = time_ms(kern, args.reps)
        plain_ms = time_ms(plain, max(3, args.reps // 4), warm=1)
        bytes_ms = nbytes / bw * 1e3
        ops_ms = pix * OPS_PER_PIXEL_LEVEL / flops * 1e3
        st = F.KERNELS[k]
        rows.append({
            "name": f"{k} {st.name}", "route": "cuda", "source": st.source,
            "replaces": st.replaces, "launches": launches[k],
            "max_abs_err": errs[k], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        })
        print(f"time {k}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {max(bytes_ms, ops_ms):.4f} ms "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'}; "
              f"{nbytes / 1e6:.1f} MB moved) [{smi}]", flush=True)
    fwd_ms = time_ms(lambda: api.wavedec2(x, WV, J, impl="fused"), args.reps)
    inv_ms = time_ms(lambda: api.waverec2(coeffs, WV, impl="fused"), args.reps)
    sep_ms = time_ms(lambda: sep.wavedec2(x, WV, J), max(3, args.reps // 4), warm=1)
    print(f"time main path: wavedec2 {fwd_ms:.4f} ms, waverec2 {inv_ms:.4f} ms, "
          f"separable wavedec2 {sep_ms:.4f} ms "
          f"({H}x{W} f32 J={J}) [{smi}]", flush=True)

    profile_main_path(lambda: api.waverec2(api.wavedec2(x, WV, J, impl="fused"),
                                           WV, impl="fused"), smi)

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
