"""Plot 2-D wavelet / scaling functions.

The port of ``examples/wavelet_func2d.py`` on ``libdwt_torch``: zero a
packed transform, set a single unit coefficient inside a chosen subband
at a chosen level, inverse-transform, and save the resulting 2-D wavelet
(or, for LL, scaling) function as a normalized PGM image.

    python examples_torch/wavelet_func2d.py [--size 512] [--out f.pgm] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch import band_rect, idwt2  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.io import save_pgm  # noqa: E402
from libdwt_torch.utils.subband import j_limit  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--wavelet", default="cdf53",
                    choices=["cdf53", "cdf97", "interp53"])
    ap.add_argument("--band", default="HL", choices=["LL", "HL", "LH", "HH"])
    ap.add_argument("--level", type=int, default=0,
                    help="0 = max_j - 3 (the reference's choice)")
    ap.add_argument("--out", default="/tmp/wavelet_func2d.pgm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    n = args.size
    max_j = j_limit(n, n)
    j = args.level or max(1, max_j - 3)
    print(f"size=({n},{n}) max_j={max_j} j={j} band={args.band}")

    y = torch.zeros((n, n), dtype=torch.float32, device=dev)
    ry, rx = band_rect(n, n, j, args.band)
    cy = (ry.start + ry.stop) // 2
    cx = (rx.start + rx.stop) // 2
    y[cy, cx] = 1.0

    f = idwt2(y, args.wavelet, None).cpu().numpy()
    lo, hi = float(f.min()), float(f.max())
    print(f"function range [{lo:.4f}, {hi:.4f}]")

    # normalize to [0, 1] around zero for display
    scale = max(abs(lo), abs(hi)) or 1.0
    img = 0.5 + 0.5 * f / scale
    save_pgm(args.out, img.astype(np.float32))
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
