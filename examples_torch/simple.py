"""Minimal forward + inverse transform round trip.

The port of ``examples/simple.py`` on ``libdwt_torch`` (simple,
simple-double and simple-int via --dtype): fill a test image, forward
multi-level CDF 9/7, inverse, compare.

    python examples_torch/simple.py [--size 512] [--levels 5] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch import fdwt2, idwt2  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.testimg import EPS, test_image  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--wavelet", default="cdf97")
    ap.add_argument("--dtype", default="f32", choices=["f32", "f64", "i32"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    dtype = {"f32": np.float32, "f64": np.float64, "i32": np.int32}[args.dtype]
    img = torch.as_tensor(test_image(args.size, args.size, dtype=dtype), device=dev)

    coeffs = fdwt2(img, args.wavelet, args.levels)
    rec = idwt2(coeffs, args.wavelet, args.levels)

    err = float((rec.to(torch.float64) - img.to(torch.float64)).abs().max())
    if np.issubdtype(dtype, np.integer):
        ok = err == 0
        print(f"int round trip: max abs err = {err:.0f} -> {'EXACT' if ok else 'FAIL'}")
    else:
        ok = err <= EPS
        print(f"float round trip: max abs err = {err:.2e} (eps {EPS}) -> "
              f"{'OK' if ok else 'FAIL'}")
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
