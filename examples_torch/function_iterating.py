"""Synthesize scaling/wavelet functions by iterating the filter bank.

The port of ``examples/function_iterating.py`` on ``libdwt_torch``: put
a single nonzero coefficient at a deep scale of an otherwise-zero
decomposition and inverse-transform; the reconstruction approximates
the continuous scaling function (coefficient in L) or mother wavelet
(coefficient in H) at that scale.  Writes TSV suitable for gnuplot.

    python examples_torch/function_iterating.py [--size 4096] [--out f.tsv] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch import wavedec1, waverec1  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402


def synthesize(wavelet: str, size: int, depth_from_max: int, band: str,
               energy: float = 100.0, device="cuda"):
    x = torch.zeros(size, dtype=torch.float32, device=device)
    coeffs = wavedec1(x, wavelet)  # full-depth all-zero pyramid
    jj = len(coeffs) - 1 - depth_from_max  # index into [L_J, H_J, .., H_1]
    if band == "L":
        target = 0
    else:
        target = max(1, jj)
    c = list(coeffs)
    c[target] = torch.zeros_like(c[target])
    c[target][c[target].shape[0] // 2] = energy
    return waverec1(c, wavelet).cpu().numpy()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--wavelet", default="cdf97")
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--depth-from-max", type=int, default=3)
    ap.add_argument("--band", default="both", choices=["L", "H", "both"])
    ap.add_argument("--out", default=None, help="TSV path (default stdout)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cols = []
    names = []
    for band in ("L", "H") if args.band == "both" else (args.band,):
        cols.append(synthesize(args.wavelet, args.size, args.depth_from_max, band,
                               device=dev))
        names.append("scaling" if band == "L" else "wavelet")

    lines = ["# x\t" + "\t".join(names)]
    for i in range(args.size):
        lines.append("\t".join([str(i)] + [f"{c[i]:.6f}" for c in cols]))
    text = "\n".join(lines)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.out} ({args.size} samples x {len(cols)} functions)")
    else:
        step = max(1, args.size // 32)
        print("\n".join(lines[::step]))
    for name, c in zip(names, cols):
        support = np.flatnonzero(np.abs(c) > 1e-4)
        print(f"# {name}: support ~[{support.min()}, {support.max()}], "
              f"L2={np.sqrt((c**2).sum()):.3f}")


if __name__ == "__main__":
    main()
