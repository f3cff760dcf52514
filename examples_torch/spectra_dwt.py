"""Wavelet power spectrum of stellar spectra: load -> median base-line
shift -> rows-only DWT -> export (SVM/MAT/PGM).

The port of ``examples/spectra_dwt.py`` on ``libdwt_torch``: loads a
spectra matrix (one spectrum per row) from an ASCII MAT file (or
synthesizes one), shifts each base-line by its median
(dwt_util_shift21_med_s), runs the rows-only multi-level CDF 9/7
transform, and exports the transformed matrix as LIBSVM, MAT and PGM.

    python examples_torch/spectra_dwt.py [--input spectra.mat] --levels 4 [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default=None,
                    help="ASCII MAT file, one spectrum per row "
                         "(synthesized when omitted)")
    ap.add_argument("--n-signals", type=int, default=32)
    ap.add_argument("--length", type=int, default=256)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--out-dir", default="/tmp/spectra-dwt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import torch

    from libdwt_torch import fdwt1
    from libdwt_torch.utils.device import resolve_device
    from libdwt_torch.utils.io import load_mat, save_mat, save_pgm, save_svm
    from libdwt_torch.utils.vecops import shift21_med

    dev = resolve_device(args.device)
    if args.input:
        spectra = load_mat(args.input).astype(np.float32)
    else:
        rng = np.random.RandomState(0)
        t = np.linspace(0, 1, args.length)
        spectra = np.stack([
            1.0 + 0.5 * np.exp(-((t - rng.rand()) ** 2) * 40)
            + 0.05 * rng.randn(args.length)
            for _ in range(args.n_signals)
        ]).astype(np.float32)
    print(f"loaded {spectra.shape[0]} spectra of length "
          f"{spectra.shape[1]}")

    os.makedirs(args.out_dir, exist_ok=True)
    x = torch.as_tensor(spectra, device=dev)
    x = shift21_med(x)  # base-line to zero by per-row median
    save_pgm(os.path.join(args.out_dir, "spectra.pgm"), x.cpu().numpy())

    # rows-only multi-level forward (dwt_cdf97_2f1_s semantics)
    y = fdwt1(x, "cdf97", args.levels)
    arr = y.cpu().numpy()
    print(f"transformed: {arr.shape}, energy "
          f"{float((arr ** 2).sum()):.4g}")

    labels = np.arange(arr.shape[0], dtype=np.float32) % 2 + 1
    save_svm(os.path.join(args.out_dir, "dwt.svm"), labels, arr)
    save_mat(os.path.join(args.out_dir, "dwt.mat"), arr)
    save_pgm(os.path.join(args.out_dir, "dwt.pgm"), arr)
    print(f"wrote dwt.svm / dwt.mat / dwt.pgm under {args.out_dir}")


if __name__ == "__main__":
    main()
