"""Time-frequency analysis of spectra-like signals with ridge tracking.

The port of ``examples/spectra_tf.py`` on ``libdwt_torch``: build a
chirp-like test signal, compute the S-transform and CWT planes (on the
card by default), track the dominant ridge with all three detectors, and
report how many ridge points each finds.

    python examples_torch/spectra_tf.py [--size 512] [--bins 64] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch.ops.gabor import (  # noqa: E402
    detect_ridges1,
    detect_ridges2,
    detect_ridges3,
    gabor_st,
    gabor_wt,
    phase_derivative,
    test_signal,
)
from libdwt_torch.utils.device import resolve_device  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--bins", type=int, default=64)
    ap.add_argument("--signal", type=int, default=0,
                    help="test-signal type (see ops.gabor.test_signal)")
    ap.add_argument("--out", default=None, help="optional MAT dump of planes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    sig = torch.as_tensor(test_signal(args.size, args.signal), device=dev)

    st_mag = gabor_st(sig, args.bins)
    st_arg = gabor_st(sig, args.bins, out="arg")
    wt_mag = gabor_wt(sig, args.bins, sigma=8.0, freq=np.pi / 2)

    r1 = detect_ridges1(st_mag)
    r2 = detect_ridges2(phase_derivative(st_arg))
    r3 = detect_ridges3(st_mag)

    # torch.argmax, like the reference's, takes the first index on a tie
    peak_bin = torch.argmax(st_mag, dim=0).cpu().numpy()
    mid = args.size // 2
    print(f"S-transform plane {tuple(st_mag.shape)}, CWT plane {tuple(wt_mag.shape)}")
    print(f"dominant bin at t={mid}: {int(peak_bin[mid])}/{args.bins}")
    for name, plane in (("ridges1(mag-peak)", r1),
                        ("ridges2(phase)", r2),
                        ("ridges3(2-D peak)", r3)):
        n_pts = int((plane != 0).sum())
        print(f"{name}: {n_pts} ridge points")

    if args.out:
        from libdwt_torch.utils.io import save_mat

        save_mat(args.out, st_mag.cpu().numpy())
        print(f"wrote {args.out}")

    raise SystemExit(0)


if __name__ == "__main__":
    main()
