"""Performance sweep: secs/pixel and Mpix/s vs image size, TSV output.

The port of ``examples/perf_sweep.py`` on ``libdwt_torch`` (the
reference's perf-plot/perf.c: gnuplot-ready output, min-of-N protocol).
The pyramid is the dispatching API's: with no ``--impl`` it is ``'auto'``,
which on the card reads the measured tune table and runs its kernels at
each size; ``--impl fused`` forces the fused kernels.  Times come from
CUDA events on the card; they are measurements of this run, not results.

    python examples_torch/perf_sweep.py [--sizes 64,128,256,512,1024] [--impl fused] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from libdwt_torch.api import wavedec2  # noqa: E402
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.perf import info, measure_perf_2d, save_tsv  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--wavelet", default="cdf97")
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--sizes", default="64,128,256,512,1024")
    ap.add_argument("--impl", default=None, choices=[None, "fused", "separable"])
    ap.add_argument("--out", default="/tmp/perf.tsv")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    print("system:", info())
    sizes = [int(s) for s in args.sizes.split(",")]
    rows = measure_perf_2d(
        lambda x: wavedec2(x, args.wavelet, args.levels, impl=args.impl),
        sizes=sizes, device=dev,
    )
    for n, spp, mpix in rows:
        print(f"  {n:5d}^2: {spp*1e9:8.2f} ns/pixel  {mpix:9.1f} Mpix/s")
    save_tsv(args.out, rows)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
