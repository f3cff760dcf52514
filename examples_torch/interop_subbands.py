"""Multi-channel subband viewer: transform, inspect, erase, invert.

The port of ``examples/interop_subbands.py`` on ``libdwt_torch`` (the
reference's opencv-subbands/showdwt.cpp): a color image is padded to
powers of two (resizePOT), forward-transformed per channel through the
flags API (dwt::transform) on ``--device``, rendered viewably (wtshow),
its per-level subbands are inspected, the HL subband is erased at EVERY
level, and the inverse shows the vertical-detail loss.  The renderings
are saved as PGM files.

    python examples_torch/interop_subbands.py [--size 200] [--out DIR] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from libdwt_torch import band_rect  # noqa: E402
from libdwt_torch.interop import (  # noqa: E402
    DWT_CDF97,
    DWT_FORWARD,
    DWT_INVERSE,
    resize_pot,
    transform,
    wtshow,
)
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.io import save_pgm  # noqa: E402
from libdwt_torch.utils.testimg import test_image  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=200,
                    help="pre-POT size (resize_pot pads to 256)")
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--out", default="/tmp")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # color test image, channels-last like cv::Mat: three phase-shifted
    # copies of the synthetic test pattern
    base = test_image(args.size, args.size, dtype=np.float32)
    src = np.stack(
        [base, np.roll(base, 7, axis=0), np.roll(base, 13, axis=1)],
        axis=-1,
    )

    big = resize_pot(src, device=dev)
    h, w = big.shape[:2]
    print(f"source {src.shape} -> POT {big.shape}")

    coeffs = transform(big, DWT_FORWARD, DWT_CDF97, args.levels, device=dev)
    view = wtshow(coeffs, device=dev)
    save_pgm(os.path.join(args.out, "transform.pgm"), view.mean(-1))

    # subband access at every level (subband(big, ..., DWT_xx))
    for j in range(1, args.levels + 1):
        for band in ("LL", "HL", "LH", "HH"):
            if band == "LL" and j != args.levels:
                continue
            ry, rx = band_rect(h, w, j, band)
            v = coeffs[ry, rx, :]
            print(f"  {band}{j}: {v.shape[0]}x{v.shape[1]}x{v.shape[2]} "
                  f"energy={float((v ** 2).sum()):.3f}")

    # erase the HL subband at all levels (showdwt.cpp's erase loop)
    erased = coeffs.copy()
    for j in range(1, args.levels + 1):
        ry, rx = band_rect(h, w, j, "HL")
        erased[ry, rx, :] = 0.0

    rec = transform(erased, DWT_INVERSE, DWT_CDF97, args.levels, device=dev)
    save_pgm(os.path.join(args.out, "erased.pgm"),
             np.clip(rec.mean(-1), 0.0, 1.0))

    full = transform(coeffs, DWT_INVERSE, DWT_CDF97, args.levels, device=dev)
    err_full = np.abs(full - big).max()
    err_erased = float(np.sqrt(((rec - big) ** 2).mean()))
    print(f"round trip max|err|={err_full:.2e}; "
          f"HL-erased RMSE={err_erased:.4f}")
    # value contract: the untouched pyramid round-trips; erasing the
    # vertical-detail bands must actually lose signal
    assert err_full <= 1e-3
    assert err_erased > 1e-3


if __name__ == "__main__":
    main()
