"""Non-separable lifting (NSLS) vs separable transform comparison.

The port of ``examples/nsls_demo.py`` on ``libdwt_torch``: run the
non-separable 2-D lifting scheme (merged x+y stages with squared
coefficients) next to the classic separable transform, confirm they
agree to float rounding, and round-trip through the NSLS inverse.

    python examples_torch/nsls_demo.py [--size 128] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from libdwt_torch.ops.nsls import nsls_dwt2_level, nsls_idwt2_level  # noqa: E402
from libdwt_torch.ops.separable import dwt2_level  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.testimg import test_image  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--wavelet", default="cdf97", choices=["cdf97", "cdf53"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    img = torch.as_tensor(test_image(args.size, args.size), device=dev)

    nsls = nsls_dwt2_level(img, args.wavelet)
    sep = dwt2_level(img, args.wavelet)
    for name, a, b in zip(("LL", "HL", "LH", "HH"), nsls, sep):
        d = float((a - b).abs().max())
        print(f"{name}: nsls vs separable max|diff| = {d:.2e}")

    rec = nsls_idwt2_level(*nsls, wavelet=args.wavelet)
    err = float((rec - img).abs().max())
    print(f"NSLS round trip max|err| = {err:.2e}")
    assert err < 1e-4


if __name__ == "__main__":
    main()
