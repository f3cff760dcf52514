"""Optical-distortion displacement-field interpolation.

The port of ``examples/displ_vectors.py`` on ``libdwt_torch``: a sparse
regular grid of displacement vectors (dx, dy) is treated as the LL_j
approximation band of a j-level pyramid; j levels of INVERSE transform
with zeroed detail bands upsample the field to the full sensor
resolution (wavelet interpolation).  Optionally only the N largest
wavelet coefficients of the field are kept first.

    python examples_torch/displ_vectors.py [--count 16] [--levels 5] [--keep N] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch import fdwt2, idwt2  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.io import save_mat  # noqa: E402


def synth_field(count: int, seed: int = 0):
    """Synthetic barrel distortion + noise, sampled on a count x count grid."""
    t = np.linspace(-1.0, 1.0, count, dtype=np.float32)
    yy, xx = np.meshgrid(t, t, indexing="ij")
    r2 = xx**2 + yy**2
    k = 12.0  # pixels of distortion at the corners
    dx = k * xx * r2
    dy = k * yy * r2
    rng = np.random.RandomState(seed)
    dx += 0.2 * rng.randn(count, count).astype(np.float32)
    dy += 0.2 * rng.randn(count, count).astype(np.float32)
    return dx.astype(np.float32), dy.astype(np.float32)


def keep_n_largest(y, n: int):
    """Zero all but the n largest-magnitude coefficients (the reference's
    qsort-and-threshold semantics: every coefficient tied with the n-th
    largest magnitude is kept too)."""
    flat = y.abs().reshape(-1)
    if n >= flat.shape[0]:
        return y
    thr = torch.sort(flat).values[-n]
    return torch.where(y.abs() >= thr, y, torch.zeros((), dtype=y.dtype, device=y.device))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--count", type=int, default=16,
                    help="samples per grid edge")
    ap.add_argument("--levels", type=int, default=5,
                    help="levels of inverse transform (upsample factor 2^j)")
    ap.add_argument("--keep", type=int, default=-1,
                    help="keep N largest wavelet coefficients (-1 = all)")
    ap.add_argument("--wavelet", default="cdf97")
    ap.add_argument("--out", default="/tmp/displ_field.mat")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    dx, dy = synth_field(args.count)
    full = args.count << args.levels
    print(f"input grid {args.count}x{args.count} -> output {full}x{full} "
          f"({args.levels} inverse levels)")

    # DC gain of the J-level lowpass chain (depends on the wavelet's
    # scaling convention): embed grid * gain so the interpolated field
    # keeps the input's amplitude at the sample points
    gain = float(fdwt2(torch.ones((full, full), dtype=torch.float32, device=dev),
                       args.wavelet, args.levels)[0, 0])

    fields = []
    for name, grid in (("dx", dx), ("dy", dy)):
        g = torch.as_tensor(grid, device=dev)
        if args.keep >= 0:
            # denoise the coarse field in its own wavelet domain first
            coeffs = fdwt2(g, args.wavelet, None)
            g = idwt2(keep_n_largest(coeffs, args.keep), args.wavelet, None)
        # embed as LL_j of the fine pyramid: packed layout, zero details
        y = torch.zeros((full, full), dtype=torch.float32, device=dev)
        y[: args.count, : args.count] = g * gain
        field = idwt2(y, args.wavelet, args.levels)
        fields.append(field.cpu().numpy())
        print(f"  {name}: range [{float(field.min()):.2f}, {float(field.max()):.2f}] px")

    out = np.stack(fields)  # (2, full, full)
    save_mat(args.out, out.reshape(2 * full, full))
    print(f"saved interpolated field to {args.out}")


if __name__ == "__main__":
    main()
