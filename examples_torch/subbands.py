"""Subband addressing demo: transform, inspect, zero one band, invert.

The port of ``examples/subbands.py`` on ``libdwt_torch``.

    python examples_torch/subbands.py [--size 64] [--levels 3] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from libdwt_torch import band_rect, fdwt2, idwt2  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.subband import count_subbands  # noqa: E402
from libdwt_torch.utils.testimg import test_image  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    img = torch.as_tensor(test_image(args.size, args.size), device=dev)
    y = fdwt2(img, "cdf97", args.levels)

    n = count_subbands(args.size, args.size, args.levels)
    print(f"{n} nonempty subbands at J={args.levels}")
    for j in range(1, args.levels + 1):
        for band in ("HL", "LH", "HH"):
            ry, rx = band_rect(args.size, args.size, j, band)
            v = y[ry, rx]
            print(f"  {band}{j}: {v.shape[0]}x{v.shape[1]} "
                  f"energy {float((v**2).sum()):.1f}")

    # zero the finest HH and reconstruct
    ry, rx = band_rect(args.size, args.size, 1, "HH")
    y2 = y.clone()
    y2[ry, rx] = 0.0
    rec = idwt2(y2, "cdf97", args.levels)
    print(f"HH1 removed: max deviation {float((rec - img).abs().max()):.3f}")


if __name__ == "__main__":
    main()
