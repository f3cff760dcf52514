"""Synthesize scaling/wavelet functions by inverting a delta.

The port of ``examples/wavelet_func.py`` on ``libdwt_torch``: put a
single 1 in one coefficient position, run the inverse transform, and the
impulse response traces the scaling (L) or wavelet (H) function.

    python examples_torch/wavelet_func.py [--levels 6] [--n 1024] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch import idwt1_packed  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.perf import save_tsv  # noqa: E402
from libdwt_torch.utils.subband import ceil_div_pow2  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--wavelet", default="cdf97")
    ap.add_argument("--levels", type=int, default=6)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--kind", default="scaling", choices=["scaling", "wavelet"])
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    y = torch.zeros(args.n, dtype=torch.float32, device=dev)
    n_low = ceil_div_pow2(args.n, args.levels)
    pos = n_low // 2 if args.kind == "scaling" else n_low + n_low // 2
    y[pos] = 1.0

    func = idwt1_packed(y, args.wavelet, args.levels).cpu().numpy()
    support = np.where(np.abs(func) > 1e-6)[0]
    print(f"{args.wavelet} {args.kind} function: support "
          f"[{support[0]}, {support[-1]}], peak {func.max():.4f}")
    if args.out:
        save_tsv(args.out, list(enumerate(func)))
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
