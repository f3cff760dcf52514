"""Smallest possible program: full decomposition and back.

The port of ``examples/start.py`` on ``libdwt_torch``: fill the standard
test image, forward CDF 9/7 at full depth (the reference's ``j = -1``),
inverse, done.

    python examples_torch/start.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch import fdwt2, idwt2  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.subband import j_limit  # noqa: E402
from libdwt_torch.utils.testimg import EPS, test_image  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    y = x = 512
    img = torch.as_tensor(test_image(y, x, dtype=np.float32), device=dev)

    j = j_limit(y, x)  # full decomposition (reference j = -1)
    rec = idwt2(fdwt2(img, "cdf97", j), "cdf97", j)

    err = float((rec - img).abs().max())
    print(f"{y}x{x} CDF 9/7 full decomposition (J={j}): "
          f"round-trip max abs err = {err:.2e}")
    raise SystemExit(0 if err <= EPS else 1)


if __name__ == "__main__":
    main()
