"""Dump full / horizontal-only / vertical-only CDF 9/7 transforms to
ASCII MAT files for external inspection.

The port of ``examples/cdf97_test.py`` on ``libdwt_torch``: the fully
2-D, rows-only and columns-only transforms of a test image as MAT files,
so other tools can cross-check the coefficients.

    python examples_torch/cdf97_test.py [--size 256] [--outdir DIR] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch import fdwt1, fdwt2  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.io import save_mat  # noqa: E402
from libdwt_torch.utils.testimg import test_image  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--wavelet", default="cdf97")
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    img = torch.as_tensor(test_image(args.size, args.size, dtype=np.float32), device=dev)

    full = fdwt2(img, args.wavelet, args.levels)
    horiz = fdwt1(img, args.wavelet, args.levels, axis=-1)  # rows only
    vert = fdwt1(img, args.wavelet, args.levels, axis=-2)   # columns only

    os.makedirs(args.outdir, exist_ok=True)
    for name, arr in (("full", full), ("horizontal", horiz),
                      ("vertical", vert), ("input", img)):
        path = os.path.join(args.outdir, f"cdf97_{name}.mat")
        save_mat(path, arr.cpu().numpy())
        print(f"wrote {path} shape={tuple(arr.shape)}")


if __name__ == "__main__":
    main()
