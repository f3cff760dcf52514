"""Wavelet denoising with the universal threshold.

The port of ``examples/denoise.py`` on ``libdwt_torch``: add noise,
threshold detail bands, reconstruct.  On the card ``denoise2`` takes the
dispatching pyramid ('auto': the measured table's kernels); on the CPU
the separable oracle.

    python examples_torch/denoise.py [--size 256] [--levels 4] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch.ops.features import denoise2  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.testimg import test_image  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--sigma", type=float, default=8.0)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--mode", default="soft", choices=["soft", "hard"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    rng = np.random.RandomState(0)
    clean = test_image(args.size, args.size).astype(np.float32)
    noisy = clean + args.sigma * rng.randn(*clean.shape).astype(np.float32)

    den = denoise2(torch.as_tensor(noisy, device=dev), "cdf97", args.levels,
                   mode=args.mode).cpu().numpy()
    mse_in = float(((noisy - clean) ** 2).mean())
    mse_out = float(((den - clean) ** 2).mean())
    print(f"noisy MSE {mse_in:.2f} -> denoised MSE {mse_out:.2f} "
          f"({10*np.log10(mse_in/mse_out):.1f} dB gain)")
    # the pipeline's value contract: thresholding must IMPROVE the MSE
    assert mse_out < mse_in, "denoise did not reduce MSE"


if __name__ == "__main__":
    main()
