"""SWT feature pipeline over a matrix of 1-D spectra.

The port of ``examples/spectra_swt.py`` on ``libdwt_torch``: load (or
synthesize) row-wise spectra, shift the base line by the per-row median
(dwt_util_shift21_med_s), center the signals (dwt_util_center21_s), run
the stationary wavelet transform per row, aggregate per-level features,
and export a LIBSVM file.

    python examples_torch/spectra_swt.py [--mat spectra.mat] [--out f.svm] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch.ops import features as F  # noqa: E402
from libdwt_torch.ops.swt import swt1  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.io import load_mat, save_svm  # noqa: E402
from libdwt_torch.utils.vecops import center21, shift21_med  # noqa: E402


def synth_spectra(n_signals: int, length: int, seed: int = 0):
    """Two synthetic classes: narrow emission lines vs broad bumps."""
    rng = np.random.RandomState(seed)
    xs, ys = [], []
    t = np.linspace(0.0, 1.0, length, dtype=np.float32)
    for i in range(n_signals):
        cls = i % 2
        base = 10.0 + rng.rand() * 5.0
        sig = np.full(length, base, np.float32)
        if cls == 0:
            for _ in range(4):
                c, wdt = rng.rand(), 0.004 + 0.004 * rng.rand()
                sig += 8.0 * np.exp(-((t - c) / wdt) ** 2)
        else:
            for _ in range(2):
                c, wdt = rng.rand(), 0.08 + 0.05 * rng.rand()
                sig += 4.0 * np.exp(-((t - c) / wdt) ** 2)
        sig += 0.3 * rng.randn(length).astype(np.float32)
        xs.append(sig)
        ys.append(cls)
    return np.stack(xs), np.asarray(ys, np.int32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mat", default=None,
                    help="ASCII MAT file of spectra (rows = signals)")
    ap.add_argument("--n-signals", type=int, default=32)
    ap.add_argument("--length", type=int, default=256)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--feature", default="med",
                    choices=sorted(k for k in F.FEATURES if k != "wps"))
    ap.add_argument("--out", default="/tmp/fv_swt.svm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    if args.mat:
        spectra = np.asarray(load_mat(args.mat), np.float32)
        classes = np.zeros(spectra.shape[0], np.int32)
    else:
        spectra, classes = synth_spectra(args.n_signals, args.length)
    print(f"{spectra.shape[0]} spectra of {spectra.shape[1]} samples")

    x = torch.as_tensor(spectra, device=dev)
    x = shift21_med(x)   # per-row median base-line shift
    x = center21(x)      # center-of-mass alignment

    # stationary transform: one detail band per level, same length as
    # the input (no decimation), plus the final approximation
    bands = swt1(x, "cdf97", level=args.levels)
    feat_fn = F.FEATURES[args.feature]
    # each band is (n_signals, length); the aggregates reduce 2-D bands,
    # so present each row as its own 1 x length band
    fv = torch.stack([feat_fn(b[:, None, :]) for b in bands], dim=-1)
    print(f"feature vectors: {fv.shape[0]}x{fv.shape[1]} ({args.feature})")

    save_svm(args.out, classes, fv.cpu().numpy())
    print(f"saved LIBSVM file to {args.out}")


if __name__ == "__main__":
    main()
