"""1-D multiresolution analysis, dumped as gnuplot-ready TSV.

The port of ``examples/mra.py`` on ``libdwt_torch``: decompose a signal,
write each level's approximation/detail to data files.

    python examples_torch/mra.py [--n 512] [--levels 4] [--out DIR] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch import wavedec1  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.perf import save_tsv  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--wavelet", default="cdf97")
    ap.add_argument("--out", default="/tmp/mra")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    t = np.linspace(0, 1, args.n)
    sig = np.sin(2 * np.pi * 5 * t) + 0.5 * np.sin(2 * np.pi * 40 * t)
    sig[args.n // 2 :] += 0.3

    coeffs = wavedec1(torch.as_tensor(sig.astype(np.float32), device=dev),
                      args.wavelet, args.levels)
    os.makedirs(args.out, exist_ok=True)
    save_tsv(os.path.join(args.out, "approx.tsv"),
             list(enumerate(coeffs[0].cpu().numpy())))
    for j, det in enumerate(coeffs[1:]):
        lvl = args.levels - j
        save_tsv(os.path.join(args.out, f"detail{lvl}.tsv"),
                 list(enumerate(det.cpu().numpy())))
    print(f"wrote approximation + {args.levels} detail bands to {args.out}/")


if __name__ == "__main__":
    main()
