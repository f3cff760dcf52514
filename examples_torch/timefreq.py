"""Time-frequency analysis: STFT / CWT / S-transform planes + ridges.

The port of ``examples/timefreq.py`` on ``libdwt_torch``: analyse a chirp
test signal with the three transforms (on the card by default) and detect
ridges; dump the planes as PGM.

    python examples_torch/timefreq.py [--size 512] [--out DIR] [--device cpu]
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from libdwt_torch.ops import gabor as G  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.io import save_pgm  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--signal", type=int, default=2, help="test signal type")
    ap.add_argument("--bins", type=int, default=128)
    ap.add_argument("--sigma", type=float, default=8.0)
    ap.add_argument("--out", default="/tmp/tf")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    sig = G.test_signal(args.size, args.signal)

    ft_t = G.gabor_ft(sig, args.bins, args.sigma, device=dev)
    ft = ft_t.cpu().numpy()
    wt = G.gabor_wt(sig, args.bins, args.sigma / 4, math.pi / 2, device=dev).cpu().numpy()
    st = G.gabor_st(sig, args.bins, device=dev).cpu().numpy()

    arg_plane = G.gabor_ft(sig, args.bins, args.sigma, out="arg", device=dev)
    inst = G.phase_derivative(arg_plane)  # noqa: F841 - as in the reference
    ridges = G.detect_ridges1(ft_t, threshold=float(ft.max()) * 0.3).cpu().numpy()

    os.makedirs(args.out, exist_ok=True)
    for name, plane in [("ft", ft), ("wt", wt), ("st", st), ("ridges", ridges)]:
        mx = plane.max() or 1.0
        save_pgm(os.path.join(args.out, f"{name}.pgm"), plane / mx, binary=True)
        print(f"{name}: plane {plane.shape}, peak {mx:.3f} -> {args.out}/{name}.pgm")


if __name__ == "__main__":
    main()
