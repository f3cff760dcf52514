"""Print the h/g (analysis lowpass/highpass) filter coefficients of a
lifting wavelet by transforming unit impulses.

The port of ``examples/filter_coeffs.py`` on ``libdwt_torch``: a forward
transform of the unit vector delta[i] reads out one column of the
analysis polyphase matrix; sweeping the impulse position recovers the
equivalent FIR filters of the lifting factorization.

    python examples_torch/filter_coeffs.py [--wavelet cdf97] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from libdwt_torch import dwt1  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402


def analysis_filters(wavelet: str, size: int = 16, device="cuda"):
    """(h, g): equivalent analysis lowpass/highpass FIR coefficients,
    read from impulse responses at the center of a ``size`` signal
    (large enough that borders do not reach it)."""
    lo_taps = {}
    hi_taps = {}
    center_lo = size // 4  # low channel index fed by the centred impulse
    for pos in range(size):
        x = torch.zeros(size, dtype=torch.float32, device=device)
        x[pos] = 1.0
        lo, hi = (b.cpu() for b in dwt1(x, wavelet))
        # h[k]: contribution of x[2*center_lo - k] to lo[center_lo]
        lo_taps[2 * center_lo - pos] = float(lo[center_lo])
        hi_taps[2 * center_lo + 1 - pos] = float(hi[center_lo])
    trim = lambda d: {k: v for k, v in d.items() if abs(v) > 1e-7}
    return trim(lo_taps), trim(hi_taps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--wavelet", default="cdf97")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    h, g = analysis_filters(args.wavelet, device=dev)
    print(f"# {args.wavelet} analysis filters (tap offset: coefficient)")
    print("h (lowpass):")
    for k in sorted(h):
        print(f"  h[{k:+d}] = {h[k]:+.9f}")
    print("g (highpass):")
    for k in sorted(g):
        print(f"  g[{k:+d}] = {g[k]:+.9f}")
    # sanity: lowpass DC gain equals the scaling normalization
    print(f"sum(h) = {sum(h.values()):.6f}  sum(g) = {sum(g.values()):+.2e}")


if __name__ == "__main__":
    main()
