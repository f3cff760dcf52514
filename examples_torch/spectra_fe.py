"""Feature extraction pipeline: rows-only DWT -> per-subband features -> LIBSVM.

The port of ``examples/spectra_fe.py`` on ``libdwt_torch`` (stellar
spectra classification): each row of the input matrix is a 1-D signal;
rows-only multi-level transform (dwt_cdf97_2f1_s semantics), per-subband
feature aggregation, LIBSVM export.

    python examples_torch/spectra_fe.py [--n-signals 64] [--out f.svm] [--device cpu]
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
from libdwt_torch.utils.io import save_svm  # noqa: E402
from libdwt_torch.utils.subband import ceil_div_pow2  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-signals", type=int, default=64)
    ap.add_argument("--length", type=int, default=256)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--feature", default="wps",
                    choices=sorted(F.FEATURES.keys()))
    ap.add_argument("--out", default="/tmp/spectra.svm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    rng = np.random.RandomState(0)
    # two synthetic "classes": smooth vs oscillatory spectra
    labels = np.repeat([1.0, 2.0], args.n_signals // 2)
    t = np.linspace(0, 1, args.length)
    sigs = []
    for lab in labels:
        base = np.exp(-((t - rng.rand()) ** 2) * 30)
        if lab == 2:
            base = base + 0.3 * np.sin(2 * np.pi * (20 + 10 * rng.rand()) * t)
        sigs.append(base + 0.05 * rng.randn(args.length))
    x = torch.as_tensor(np.asarray(sigs, np.float32), device=dev)

    y = fdwt1(x, "cdf97", args.levels)  # rows-only transform (2f1 analogue)
    fn = F.FEATURES[args.feature]
    feats = []
    for j in range(1, args.levels + 1):
        lo = ceil_div_pow2(args.length, j)
        hi = ceil_div_pow2(args.length, j - 1)
        band = y[..., lo:hi][:, None, :]  # H band of level j, as (n,1,len)
        v = fn(band, j) if args.feature == "wps" else fn(band)
        feats.append(v.cpu().numpy().reshape(-1))
    feats = np.stack(feats, axis=1)

    # value contract: one feature vector per signal, all finite, and
    # the oscillatory class carries more fine-band power than the
    # smooth class (the separation the classifier downstream relies on)
    assert feats.shape == (len(labels), args.levels)
    assert np.isfinite(feats).all()
    if args.feature == "wps":
        fine1 = feats[labels == 1.0, 0].mean()
        fine2 = feats[labels == 2.0, 0].mean()
        assert fine2 > fine1, (
            f"oscillatory class should dominate the fine band "
            f"({fine2} vs {fine1})")

    save_svm(args.out, labels, feats)
    print(f"wrote {len(labels)} x {feats.shape[1]} feature vectors to {args.out}")


if __name__ == "__main__":
    main()
