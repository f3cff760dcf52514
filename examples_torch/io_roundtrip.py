"""Image file I/O round trip: PGM and ASCII MAT.

The port of ``examples/io_roundtrip.py`` on ``libdwt_torch`` (the
reference's load example's PGM load/save round trip and cdf97-test's MAT
dumps of transform outputs): both packages load the same native codec
library when it is built (``native/``), and fall back to Python codecs
when it is not.

    python examples_torch/io_roundtrip.py [--size 128] [--out DIR] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch import fdwt2  # noqa: E402
from libdwt_torch.utils import io as dio  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.nativelib import available  # noqa: E402
from libdwt_torch.utils.testimg import test_image  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--out", default="/tmp/dwtio")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    img = test_image(args.size, args.size).astype(np.float32)
    img = img / img.max()

    pgm = os.path.join(args.out, "image.pgm")
    dio.save_pgm(pgm, img)
    back = dio.load_pgm(pgm)
    err = np.abs(back - img).max()
    print(f"PGM round trip (native={available()}): max err {err:.5f} "
          f"(quantization bound {0.5/255:.5f})")

    y = fdwt2(torch.as_tensor(img, device=dev), "cdf97", 3).cpu().numpy()
    mat = os.path.join(args.out, "transform.mat")
    dio.save_mat(mat, y)
    back = dio.load_mat(mat)
    print(f"MAT round trip: shape {back.shape}, max err "
          f"{np.abs(back - y).max():.2e} (%f format)")


if __name__ == "__main__":
    main()
