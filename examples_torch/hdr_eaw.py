"""Edge-avoiding wavelet detail manipulation (HDR-style tone mapping).

The port of ``examples/hdr_eaw.py`` on ``libdwt_torch``: load an HDR
frame (EXR, or a synthetic test image), decompose with WCDF 9/7
(data-dependent weights), compress the approximation range and boost
details, reconstruct with the stored weights, save the result.

    python examples_torch/hdr_eaw.py [--size 128] [--input in.exr] [--output out.exr] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch.ops.eaw import eaw_wavedec2, eaw_waverec2  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.exr import read_exr, write_exr  # noqa: E402
from libdwt_torch.utils.testimg import test_image  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--alpha", type=float, default=0.8)
    ap.add_argument("--detail-boost", type=float, default=1.5)
    ap.add_argument("--base-compress", type=float, default=0.5)
    ap.add_argument("--input", default=None, help="input EXR (HDR) frame")
    ap.add_argument("--output", default=None, help="output EXR path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    if args.input:
        raw, _ = read_exr(args.input)
        # luminance of RGB inputs, like the reference hdr example's
        # log-luminance pipeline
        lum = raw.mean(axis=2) if raw.ndim == 3 else raw
        img = torch.as_tensor(np.log1p(np.maximum(lum, 0.0)).astype(np.float32), device=dev)
    else:
        img = torch.as_tensor(test_image(args.size, args.size).astype(np.float32), device=dev)

    coeffs, weights = eaw_wavedec2(img, "cdf97", args.levels, alpha=args.alpha)
    tone = [coeffs[0] * args.base_compress] + [
        tuple(b * args.detail_boost for b in lvl) for lvl in coeffs[1:]
    ]
    out = eaw_waverec2(tone, weights, "cdf97")

    # sanity: identity manipulation reconstructs exactly
    ident = eaw_waverec2(coeffs, weights, "cdf97")
    err = float((ident - img).abs().max())
    print(f"identity reconstruction err: {err:.2e}")
    # the weighted lifting must invert exactly and the manipulation must
    # stay finite
    assert err <= 1e-3, f"EAW identity reconstruction err {err}"
    assert bool(torch.isfinite(out).all()), "tone-mapped output not finite"
    print(f"tone-mapped range: [{float(out.min()):.1f}, {float(out.max()):.1f}] "
          f"(input [{float(img.min()):.1f}, {float(img.max()):.1f}])")
    if args.output:
        res = out.to(torch.float32).cpu().numpy()
        write_exr(args.output, np.expm1(res) if args.input else res)
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
