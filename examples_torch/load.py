"""Load an image from a PGM file, transform it, save the results.

The port of ``examples/load.py`` on ``libdwt_torch`` (the reference's
load/simple.c, and load-int via --dtype i32): try to load the named PGM;
on failure fall back to the synthetic test image.  Print the environment
info lines (the dwt_util_log block), run a full forward decomposition on
the card (by default), save the viewable transform and the reconstruction
as PGM, and verify the round trip (exact for the integer CDF 5/3).

    python examples_torch/load.py [image.pgm] [--dtype i32] [--out DIR] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch import __version__, fdwt2, idwt2  # noqa: E402
from libdwt_torch.image import conv_show  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.io import load_pgm, save_pgm  # noqa: E402
from libdwt_torch.utils.subband import j_limit  # noqa: E402
from libdwt_torch.utils.testimg import EPS, test_image  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", default="Lenna.pgm")
    ap.add_argument("--dtype", default="f32", choices=["f32", "i32"])
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    try:
        data = load_pgm(args.path, normalize=args.dtype == "f32")
        print(f"loaded {args.path}")
    except (OSError, ValueError):
        print(f"unable to load {args.path!r}, using the default test image")
        data = test_image(512, 512, dtype=np.float32)
    if args.dtype == "i32":
        scale = 255.0 if data.max() <= 1.0 else 1.0
        data = np.round(data * scale).astype(np.int32)
    img = torch.as_tensor(data, device=dev)

    platform, kind = (("gpu", torch.cuda.get_device_name(dev)) if dev.type == "cuda"
                      else ("cpu", "cpu"))
    y, x = img.shape
    print(f"library version {__version__}")
    print(f"running on {platform}:{kind}")
    print(f"node {os.uname().nodename}")
    print(f"image {y}x{x} pixels, {str(img.dtype).replace('torch.', '')}, "
          f"{img.numel() * img.element_size() // 1024} KiB")

    wavelet = "cdf97" if args.dtype == "f32" else "cdf53"
    j = j_limit(y, x)  # full decomposition (reference j = -1)
    coeffs = fdwt2(img, wavelet, j)
    rec = idwt2(coeffs, wavelet, j)

    os.makedirs(args.out, exist_ok=True)
    save_pgm(os.path.join(args.out, "transform.pgm"), conv_show(coeffs))
    peak = 255 if args.dtype == "i32" else 1.0
    rec_np = rec.cpu().numpy().astype(np.float64)
    save_pgm(os.path.join(args.out, "reconstruction.pgm"), rec_np / peak)

    err = float(np.abs(rec_np - data.astype(np.float64)).max())
    ok = err == 0 if args.dtype == "i32" else err <= EPS
    print(f"{wavelet} J={j} round trip: max abs err = {err:.2e} -> "
          f"{'OK' if ok else 'FAIL'}")
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
