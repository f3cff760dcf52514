"""Single-loop core showcase: fast forward cores vs the separable inverse.

The port of ``examples/cores.py`` on ``libdwt_torch``: fill a test image,
run a FAST forward core (the fused single-level kernel B1 on the card,
the non-separable NSLS core, the separable oracle, or the fixed-point
cores), reconstruct with the SEPARABLE oracle, and report pass/fail +
MSE, the reference-twin predicate that every accelerated path must
satisfy.  Optionally dumps source / log-subband / reconstruction PGMs.

    python examples_torch/cores.py [--core all] [--size 512] [--dump] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch.ops.fused import fused_dwt2_level, fused_supported  # noqa: E402
from libdwt_torch.ops.nsls import nsls_dwt2_level  # noqa: E402
from libdwt_torch.ops.separable import dwt2_level, idwt2_level  # noqa: E402
from libdwt_torch.utils import fix  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.io import save_pgm  # noqa: E402
from libdwt_torch.utils.testimg import test_image  # noqa: E402


def _forward(core: str, img, wavelet: str):
    """Fast-core forward -> (ll, hl, lh, hh)."""
    if core == "fused":
        return fused_dwt2_level(img, wavelet)
    if core == "nsls":
        return nsls_dwt2_level(img, wavelet)
    if core == "separable":
        return dwt2_level(img, wavelet)
    raise SystemExit(f"unknown core {core!r}")


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy()


def _mse(a, b):
    d = _host(a).astype(np.float64) - _host(b).astype(np.float64)
    return float(np.mean(d * d))


def run_2d(core: str, wavelet: str, size: int, dump: bool, device) -> float:
    img = torch.as_tensor(test_image(size, size), device=device)
    if dump:
        save_pgm("source.pgm", _host(img))
    bands = _forward(core, img, wavelet)
    if dump:
        # log-magnitude subband mosaic, the image2_save_log_to_pgm look
        top = np.concatenate([_host(bands[0]), _host(bands[1])], 1)
        bot = np.concatenate([_host(bands[2]), _host(bands[3])], 1)
        mosaic = np.log1p(np.abs(np.concatenate([top, bot], 0)))
        save_pgm("subbands.pgm", mosaic / max(mosaic.max(), 1e-9))
    rec = idwt2_level(*bands, wavelet)  # inverse separable, as in main.c
    if dump:
        save_pgm("target.pgm", np.clip(_host(rec), 0.0, 1.0))
    return _mse(img, rec)


def run_fix(qname: str, wavelet: str, size: int, device) -> float:
    """Fixed-point 1-D core round trip (the fix.h Q-format analogue)."""
    q = {"fix32": fix.FIX32, "fix16": fix.FIX16}[qname]
    sig = torch.as_tensor(test_image(1, size)[0], device=device)
    s, d = fix.lift_fwd_fix(fix.to_fix(sig, q), wavelet, q)
    rec = fix.from_fix(fix.lift_inv_fix(s, d, wavelet, q), q)
    return _mse(sig, rec)


def run_fix2d(qname: str, wavelet: str, size: int, device) -> float:
    """Fixed-point 2-D core round trip (cores2f_cdf97_v2x2_i32 / the
    FIX16 5/3 variants)."""
    q = {"fix32": fix.FIX32, "fix16": fix.FIX16}[qname]
    img = torch.as_tensor(test_image(size, size), device=device)
    bands = fix.dwt2_fix(fix.to_fix(img, q), wavelet, q)
    rec = fix.from_fix(fix.idwt2_fix(*bands, wavelet, q), q)
    return _mse(img, rec)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--core",
        default="all",
        choices=["all", "fused", "nsls", "separable", "fix32", "fix16",
                 "fix32-2d", "fix16-2d"],
    )
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--dump", action="store_true", help="write PGM files")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # tolerance ladder: floats reconstruct to FP noise, Q-formats to
    # their quantization step (same pragmatics as the C demo's eps)
    cases = []
    if args.core in ("all", "fused"):
        for wav in ("cdf97", "cdf53", "haar"):
            if fused_supported(wav):
                cases.append(("fused", wav, 1e-9))
    if args.core in ("all", "nsls"):
        cases.append(("nsls", "cdf97", 1e-9))
    if args.core in ("all", "separable"):
        for wav in ("cdf97", "cdf53", "haar", "d4"):
            cases.append(("separable", wav, 1e-9))
    if args.core in ("all", "fix32"):
        cases.append(("fix32", "cdf97", 1e-6))
    if args.core in ("all", "fix32-2d"):
        cases.append(("fix32-2d", "cdf97", 1e-6))
    if args.core in ("all", "fix16"):
        cases.append(("fix16", "cdf53", 1e-2))
    if args.core in ("all", "fix16-2d"):
        cases.append(("fix16-2d", "cdf53", 1e-2))

    failures = 0
    for core, wav, tol in cases:
        if core in ("fix32-2d", "fix16-2d"):
            mse = run_fix2d(core[:-3], wav, min(args.size, 128), dev)
        elif core in ("fix32", "fix16"):
            mse = run_fix(core, wav, args.size, dev)
        else:
            mse = run_2d(core, wav, args.size, args.dump and core == "fused", dev)
        ok = mse <= tol
        failures += not ok
        print(f"{core:10s} {wav:7s} mse={mse:.3e}  {'pass' if ok else 'FAIL'}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
