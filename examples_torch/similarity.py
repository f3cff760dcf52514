"""Image-similarity metrics table (MSE / PSNR / MSSIM / MAE).

The port of ``examples/similarity.py`` on ``libdwt_torch`` (the
reference's similarity/compare.cpp + the cmp-tex.sh scripts): compare an
image against degraded variants (wavelet-thresholded reconstructions at
several compression strengths) and print the metric table, optionally as
a LaTeX tabular.

The pyramid is the dispatching API's (:mod:`libdwt_torch.api`, no
``impl``): on the card it is ``'auto'``, which reads the measured tune
table and runs its kernels; on the CPU it is the separable oracle, the
reference program's transform.  The MSSIM blur is ``conv2d`` with TF32
off, so the card's metric sums what the CPU's does.

    python examples_torch/similarity.py [--size 512] [--levels 4] [--tex] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as nnf  # noqa: E402

from libdwt_torch.api import wavedec2, waverec2  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.testimg import test_image  # noqa: E402


def mse(a, b):
    """compare.cpp mse: mean squared error."""
    return torch.mean((a - b) ** 2)


def psnr(a, b):
    """compare.cpp psnr: 10*log10(1/mse) (unit peak convention)."""
    return 10.0 * torch.log10(1.0 / mse(a / 255.0, b / 255.0))


def _gauss_kernel(size=11, sigma=1.5, device=None):
    r = np.arange(size) - size // 2
    k = np.exp(-(r**2) / (2 * sigma * sigma))
    k /= k.sum()
    return torch.as_tensor(np.outer(k, k), dtype=torch.float32, device=device)


def _blur(img, k):
    pad = k.shape[-1] // 2  # 'SAME' for the odd 11x11 window
    with torch.backends.cudnn.flags(enabled=True,
                                    benchmark=torch.backends.cudnn.benchmark,
                                    deterministic=torch.backends.cudnn.deterministic,
                                    allow_tf32=False):
        return nnf.conv2d(img[None, None], k[None, None], padding=pad)[0, 0]


def mssim(a, b):
    """Mean structural similarity, the OpenCV-tutorial formulation used
    by the reference (compare.cpp getMSSIM; C1/C2 for 8-bit range)."""
    c1, c2 = 6.5025, 58.5225
    k = _gauss_kernel(device=a.device)
    mu1, mu2 = _blur(a, k), _blur(b, k)
    s1 = _blur(a * a, k) - mu1 * mu1
    s2 = _blur(b * b, k) - mu2 * mu2
    s12 = _blur(a * b, k) - mu1 * mu2
    num = (2 * mu1 * mu2 + c1) * (2 * s12 + c2)
    den = (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2)
    return torch.mean(num / den)


def mae(a, b):
    return torch.mean(torch.abs(a - b))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--wavelet", default="cdf97")
    ap.add_argument("--tex", action="store_true", help="LaTeX tabular output")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # 8-bit-range test image, like the reference's PGM inputs
    img = torch.as_tensor(test_image(args.size, args.size, dtype=np.float32), device=dev)
    img = 255.0 * (img - img.min()) / float(img.max() - img.min())

    coeffs = wavedec2(img, args.wavelet, args.levels)

    def degrade(thr):
        shrunk = [coeffs[0]] + [
            tuple(torch.where(torch.abs(b) > thr, b, 0.0) for b in lvl)
            for lvl in coeffs[1:]
        ]
        return waverec2(shrunk, args.wavelet)

    metric_fns = {"MSE": mse, "PSNR[dB]": psnr, "MSSIM": mssim, "MAE": mae}
    rows = []
    for thr in (0.0, 1.0, 5.0, 20.0, 80.0):
        rec = degrade(thr)
        kept = sum(
            int(torch.sum(torch.abs(b) > thr)) for lvl in coeffs[1:] for b in lvl
        )
        total = sum(int(b.numel()) for lvl in coeffs[1:] for b in lvl)
        vals = [float(fn(img, rec)) for fn in metric_fns.values()]
        rows.append((thr, 100.0 * kept / total, vals))

    hdr = ["thr", "kept[%]"] + list(metric_fns)
    if args.tex:
        print(r"\begin{tabular}{l" + "r" * (len(hdr) - 1) + "}")
        print(" & ".join(hdr) + r" \\ \hline")
        for thr, kept, vals in rows:
            cells = [f"{thr:g}", f"{kept:.1f}"] + [f"{v:.4g}" for v in vals]
            print(" & ".join(cells) + r" \\")
        print(r"\end{tabular}")
    else:
        print("\t".join(hdr))
        for thr, kept, vals in rows:
            print("\t".join([f"{thr:g}", f"{kept:.1f}"] + [f"{v:.4g}" for v in vals]))


if __name__ == "__main__":
    main()
