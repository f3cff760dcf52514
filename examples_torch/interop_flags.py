"""Flags-style transform API over numpy / torch multi-channel images.

The port of ``examples/interop_flags.py`` on ``libdwt_torch`` (the
reference's OpenCV binding demos, opencv/main.cpp and opencv-subbands):
pad to a power of two, transform every channel with the
dwt::transform-style flags API, normalize for display (wtshow), pull one
subband as a view, invert and compare.  A numpy input goes to
``--device`` and comes back as numpy; with ``--torch`` the input is a
torch tensor on that device and the results stay tensors there.

    python examples_torch/interop_flags.py [--size 200] [--torch] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch import band_view  # noqa: E402
from libdwt_torch.interop import (  # noqa: E402
    DWT_CDF97,
    DWT_FORWARD,
    DWT_INVERSE,
    resize_pot,
    transform,
    wtshow,
)
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.testimg import test_image  # noqa: E402


def host(a) -> np.ndarray:
    """A numpy copy of a result, from numpy or from a tensor on any device."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=200)  # deliberately non-POT
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--channels", type=int, default=3)
    ap.add_argument("--torch", action="store_true",
                    help="round-trip through torch tensors instead of numpy")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    base = test_image(args.size, args.size, dtype=np.float32)
    img = np.stack([base * (c + 1) / args.channels
                    for c in range(args.channels)], axis=-1)
    if args.torch:
        img = torch.from_numpy(img).to(dev)

    pot = resize_pot(img, device=dev)
    print(f"input {tuple(img.shape)} -> power-of-two {tuple(pot.shape)}")

    coeffs = transform(pot, DWT_FORWARD, wavelet=DWT_CDF97,
                       level=args.levels, device=dev)
    disp = wtshow(coeffs, device=dev)
    disp_np = host(disp)
    print(f"wtshow display range: [{disp_np.min():.3f}, {disp_np.max():.3f}]")

    chan0 = host(coeffs)[..., 0]
    ll = band_view(chan0, args.levels, "LL")
    hh1 = band_view(chan0, 1, "HH")
    print(f"LL{args.levels} {ll.shape} energy={float((ll ** 2).sum()):.1f}  "
          f"HH1 {hh1.shape} energy={float((hh1 ** 2).sum()):.3f}")

    rec = transform(coeffs, DWT_INVERSE, wavelet=DWT_CDF97,
                    level=args.levels, device=dev)
    err = float(np.abs(host(rec) - host(pot)).max())
    print(f"round trip max abs err = {err:.2e}")
    raise SystemExit(0 if err <= 1e-4 else 1)


if __name__ == "__main__":
    main()
