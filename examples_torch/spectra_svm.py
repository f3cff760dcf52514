"""Spectra classification program: split / grid-search / train / test.

The port of ``examples/spectra_svm.py`` on ``libdwt_torch`` (the
reference's test.sh, which drives svm-grid + svm-train + svm-predict over
fv_*.{train,test}.svm feature files and prints a results table).  The
feature vectors come from the port's rows-only DWT pipeline (on the card
by default); they are split train/test and written as LIBSVM files, a
(log2 C, log2 gamma) grid search with cross-validation picks the RBF
kernel-ridge hyper-parameters, the winner is trained on the full train
split and scored on the held-out test file, and the table is printed.
The kernel ridge and the grid search stay numpy on the host.

    python examples_torch/spectra_svm.py [--n-signals 96] [--out DIR] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch import fdwt1  # noqa: E402
from libdwt_torch.ops import features as F  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.io import load_svm, save_svm  # noqa: E402
from libdwt_torch.utils.subband import ceil_div_pow2  # noqa: E402


def make_spectra(n, length, rng):
    """Two synthetic classes: smooth continuum vs line-rich spectra."""
    labels = np.repeat([1.0, 2.0], n // 2)
    t = np.linspace(0, 1, length)
    sigs = []
    for lab in labels:
        base = np.exp(-((t - rng.rand()) ** 2) * 30)
        if lab == 2:
            base = base + 0.3 * np.sin(2 * np.pi * (20 + 10 * rng.rand()) * t)
        sigs.append(base + 0.05 * rng.randn(length))
    return labels, np.asarray(sigs, np.float32)


def extract_features(x, levels, feature="wps", device=None):
    """Rows-only multi-level DWT -> per-level H-band aggregate
    (fe.c:79-120 -> dwt_util_band_* -> feature vector)."""
    length = x.shape[-1]
    y = fdwt1(torch.as_tensor(x, device=resolve_device(device)), "cdf97", levels)
    fn = F.FEATURES[feature]
    feats = []
    for j in range(1, levels + 1):
        lo = ceil_div_pow2(length, j)
        hi = ceil_div_pow2(length, j - 1)
        band = y[..., lo:hi][:, None, :]
        v = fn(band, j) if feature == "wps" else fn(band)
        feats.append(v.cpu().numpy().reshape(-1))
    return np.stack(feats, axis=1)


def _kernel(a, b, gamma):
    d2 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2 * a @ b.T
    return np.exp(-gamma * d2)


def fit_predict(xtr, ytr, xte, c, gamma):
    """RBF kernel ridge classifier on +-1 targets: alpha =
    (K + I/C)^-1 y.  C plays libsvm's role (large C = weak
    regularization)."""
    K = _kernel(xtr, xtr, gamma)
    alpha = np.linalg.solve(K + np.eye(len(xtr)) / c, np.where(ytr == 2, 1.0, -1.0))
    score = _kernel(xte, xtr, gamma) @ alpha
    return np.where(score > 0, 2.0, 1.0)


def grid_search(x, yl, folds=4):
    """svm-grid analogue: cross-validated accuracy over a
    (log2 C, log2 gamma) grid; returns (C, gamma, rate)."""
    n = len(x)
    idx = np.arange(n)
    best = (-1.0, 1.0, 1.0)
    for lc in range(-2, 9, 2):
        for lg in range(-8, 3, 2):
            c, g = 2.0 ** lc, 2.0 ** lg
            correct = 0
            for f in range(folds):
                te = idx[f::folds]
                tr = np.setdiff1d(idx, te)
                pred = fit_predict(x[tr], yl[tr], x[te], c, g)
                correct += int((pred == yl[te]).sum())
            rate = correct / n
            if rate > best[0]:
                best = (rate, c, g)
    rate, c, g = best
    return c, g, rate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-signals", type=int, default=96)
    ap.add_argument("--length", type=int, default=256)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--features", nargs="+",
                    default=["wps", "var", "stdev"])
    ap.add_argument("--train-frac", type=float, default=0.67)
    ap.add_argument("--out", default="/tmp/spectra-svm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    rng = np.random.RandomState(0)
    labels, sigs = make_spectra(args.n_signals, args.length, rng)

    # split once, shared by every feature file (test.sh's fixed
    # train-test directory)
    perm = rng.permutation(len(labels))
    n_tr = int(len(labels) * args.train_frac)
    tr, te = perm[:n_tr], perm[n_tr:]

    rows = []
    for feat in args.features:
        fv = extract_features(sigs, args.levels, feat, dev)
        ftr = os.path.join(args.out, f"fv_{feat}.train.svm")
        fte = os.path.join(args.out, f"fv_{feat}.test.svm")
        save_svm(ftr, labels[tr], fv[tr])
        save_svm(fte, labels[te], fv[te])

        # reload from the files — the LIBSVM round trip is part of the
        # workflow being exercised
        ytr, xtr = load_svm(ftr)
        yte, xte = load_svm(fte)
        mu, sd = xtr.mean(0), xtr.std(0) + 1e-9
        xtr = (xtr - mu) / sd
        xte = (xte - mu) / sd

        c, g, cv_rate = grid_search(xtr, ytr)
        pred = fit_predict(xtr, ytr, xte, c, g)
        test_rate = float((pred == yte).mean())
        rows.append((feat, fv.shape[1], np.log2(c), np.log2(g),
                     100 * cv_rate, 100 * test_rate))

    bar = "-" * 78
    print(bar)
    print(f"| {'file':<16} | {'coeffs':>6} | {'log2(c)':>7} | "
          f"{'log2(g)':>7} | {'rate [%] (cv)':>13} | {'rate [%] (test)':>15} |")
    print(bar)
    for feat, ncoef, lc, lg, cv, tst in sorted(
            rows, key=lambda r: -r[-1]):
        print(f"| fv_{feat:<13} | {ncoef:>6} | {lc:>7.0f} | {lg:>7.0f} | "
              f"{cv:>13.1f} | {tst:>15.1f} |")
    print(bar)

    # value contract: the pipeline must actually separate the classes
    best_rate = max(r[-1] for r in rows)
    assert best_rate >= 80.0, f"best test rate {best_rate}% — pipeline broken"


if __name__ == "__main__":
    main()
