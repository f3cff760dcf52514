"""1-D transform performance sweep: secs/sample vs signal length.

The port of ``examples/perf_line.py`` on ``libdwt_torch`` (the
reference's perf-plot-line, which runs
dwt_util_measure_perf_cdf97_1_s): batches of rows per dispatch, min-of-N,
TSV output.  The rows-only transform is the separable oracle: on the card
it runs as PyTorch operations (no hand-written kernel), timed with CUDA
events.  The times are measurements of this run, not results: two runs
differ in them.

    python examples_torch/perf_line.py --lengths 256,1024,4096 --levels 4 [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lengths", default="256,1024,4096,16384,65536")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--wavelet", default="cdf97")
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--out", default="/tmp/perf_line.tsv")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from libdwt_torch import fdwt1
    from libdwt_torch.utils.device import resolve_device
    from libdwt_torch.utils.perf import info, measure_perf_1d, save_tsv

    dev = resolve_device(args.device)
    print("system:", info())
    lengths = [int(s) for s in args.lengths.split(",")]
    rows = measure_perf_1d(
        lambda x: fdwt1(x, args.wavelet, args.levels),
        lengths=lengths, batch=args.batch, trials=args.trials, device=dev,
    )
    for n, sps, msps in rows:
        print(f"  n={n:7d}: {sps * 1e9:8.2f} ns/sample "
              f"{msps:9.1f} Msamples/s")
    save_tsv(args.out, rows)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
