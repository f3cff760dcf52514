"""Find the strongest blobs/ridges of an S-transform plane.

The port of ``examples/spectra_blobs.py`` on ``libdwt_torch`` (the
reference's spectra-blobs/blobs.c): build a TF plane (the S-transform of a
synthetic multi-component signal, on the card by default, or a MAT file
if one is given), save it as PGM, extract the N strongest ridge points
with matched Gaussian suppression (spectra_st_get_strongest_ridges), save
them as MAT, and score the recovered positions against the known injected
components (spectra_diff_points).

    python examples_torch/spectra_blobs.py [--n 512] [--out DIR] [--device cpu]
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch.image import conv_show  # noqa: E402
from libdwt_torch.ops.gabor import (diff_points, gabor_function, gabor_st,  # noqa: E402
                                    strongest_ridges)
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.io import load_mat, save_mat, save_pgm  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mat", default=None,
                    help="optional MAT file holding a ready TF plane")
    ap.add_argument("--n", type=int, default=512, help="signal length")
    ap.add_argument("--bins", type=int, default=64)
    ap.add_argument("--ridges", type=int, default=8)
    ap.add_argument("--components", type=int, default=4)
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    truth = None
    if args.mat:
        plane = torch.as_tensor(load_mat(args.mat), device=dev)
        print(f"loaded plane {tuple(plane.shape)} from {args.mat}")
    else:
        # synthetic blobs: isolated Gabor components at known (t, f)
        rng = np.random.RandomState(7)
        n, bins = args.n, args.bins
        sig = np.zeros(n, np.float64)
        truth = []
        for k in range(args.components):
            t0 = int((k + 0.5) / args.components * n)
            f = rng.uniform(0.1, 0.4)  # cycles/sample
            sig += np.real(gabor_function(np.arange(n) - t0, n / 32.0, 2 * math.pi * f))
            # plane row for frequency f: gabor_st bin y analyses
            # (y+1)/bins*0.5, stored at row bins-1-y
            truth.append((t0, bins - round(f / 0.5 * bins)))
        plane = gabor_st(torch.as_tensor(sig.astype(np.float32), device=dev), bins)

    points_t = strongest_ridges(plane, args.ridges)
    points = points_t.cpu().numpy()

    os.makedirs(args.out, exist_ok=True)
    save_pgm(os.path.join(args.out, "plane.pgm"), conv_show(plane))
    save_mat(os.path.join(args.out, "points.mat"), points.astype(np.float32))

    print(f"plane {tuple(plane.shape)}; {args.ridges} strongest points (x, y):")
    for px, py in points:
        print(f"  ({int(px):4d}, {int(py):3d})")

    if truth is not None:
        d = diff_points(np.asarray(truth, np.float32), points_t, device=dev).cpu().numpy()
        print("distance from each injected component to nearest found point:")
        print("  " + "  ".join(f"{v:.1f}" for v in d))
        # every injected blob must be found within a coarse TF cell
        ok = bool((d <= max(args.n / args.components / 4, 8)).all())
        raise SystemExit(0 if ok else 1)
    raise SystemExit(0)


if __name__ == "__main__":
    main()
