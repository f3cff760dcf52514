"""Perf-plot: sweep every kernel strategy over frame sizes, emit
gnuplot-ready data files + plot script (and an SVG when matplotlib is
importable).

The port of ``examples/perf_plot.py`` on ``libdwt_torch`` (the
reference's perf-plot app, which sweeps its accel types over image sizes
and renders secs/pixel curves with gnuplot).  The candidates are the
dispatch strategies of ``autotune._pyramid_candidates``: separable
(PyTorch operations), fused (B2/B3 forward, B5/B6 inverse), streamed
(B11/B12) and streamed-mxu (B11/B12 with the banded body B13).  The
protocol is the tuner's chain slope (fixed costs cancel), timed with CUDA
events on the card, and the inverse rows time the fwd+inv composite
(labelled as such: the forward part is the same separable pyramid for
every candidate, so candidate DIFFERENCES are inverse cost).  The times
are measurements of this run, not results.

    python examples_torch/perf_plot.py --sizes 256,512,1024,2048 --levels 5 \
        --out-dir DIR [--device cpu]

Writes ``dir=<fwd|finv>.impl=<name>.type=float32.txt`` ("pixels
secs_per_pixel" rows), ``plot.txt`` (gnuplot), ``perf.svg``
(matplotlib, if available), and a combined ``sweep.tsv``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GNUPLOT = """# rendered from the committed sweep data: gnuplot plot.txt
set terminal svg enhanced size 640 420
set output "perf.svg"
set xlabel "pixels"
set ylabel "seconds / pixel"
set format x "%.1s%c"
set format y "%.1s%c"
set logscale x
set logscale y
plot \\
{lines}
"""


def _write_outputs(series, args, device):
    """(Re)write the gnuplot data files, plot script and combined TSV
    from the rows measured so far."""
    lines = []
    tsv = ["# dir\timpl\tpixels\tsecs_per_pixel\testimator"]
    for (direction, impl), rows in sorted(series.items()):
        tag = "fwd" if direction == "fwd" else "finv"
        fname = f"dir={tag}.impl={impl}.type=float32.txt"
        with open(os.path.join(args.out_dir, fname), "w") as f:
            f.write(f"# {device}: secs/pixel, {args.wavelet} "
                    f"J={args.levels}"
                    + (" (fwd+inv composite)" if tag == "finv" else "")
                    + "\n")
            for px, spp, kind in rows:
                f.write(f"{px} {spp:.6e} # {kind}\n")
        lines.append(f'\t"{fname}" with linespoints lw 2 '
                     f'title "{impl} ({tag})", \\')
        for px, spp, kind in rows:
            tsv.append(f"{tag}\t{impl}\t{px}\t{spp:.6e}\t{kind}")
    with open(os.path.join(args.out_dir, "plot.txt"), "w") as f:
        f.write(GNUPLOT.format(lines="\n".join(lines).rstrip(", \\")))
    with open(os.path.join(args.out_dir, "sweep.tsv"), "w") as f:
        f.write("\n".join(tsv) + "\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="256,512,1024,2048")
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--wavelet", default="cdf97")
    ap.add_argument("--impls",
                    default="separable,fused,streamed,streamed-mxu")
    ap.add_argument("--dirs", default="fwd,inv")
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--chains", default="8,32")
    ap.add_argument("--out-dir", default="/tmp/perf-plot")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    from libdwt_torch.autotune import (
        _chain_slope_secs, _make_stacks, _pyramid_candidates,
    )
    from libdwt_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    # square edges ("1024") or explicit HxW geometries ("2144x4096")
    sizes = [tuple(int(p) for p in s.split("x")) if "x" in s else int(s)
             for s in args.sizes.split(",")]
    impls = args.impls.split(",")
    dirs = args.dirs.split(",")
    ka, kb = (int(s) for s in args.chains.split(","))
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device: {device}", file=sys.stderr)

    # series[(dir, impl)] = [(pixels, secs_per_pixel, estimator), ...]
    series = {}
    for n in sizes:
        shape = n if isinstance(n, tuple) else (n, n)
        stacks = _make_stacks(shape, torch.float32, ka, kb, device=dev)
        px = shape[0] * shape[1]
        for direction in dirs:
            cands = dict(_pyramid_candidates(
                args.wavelet, args.levels, direction, shape=shape,
                dtype=torch.float32))
            for impl in impls:
                fn = cands.get(impl)
                if fn is None:
                    continue
                try:
                    secs, kind = _chain_slope_secs(
                        fn, stacks, trials=args.trials)
                except Exception as e:  # geometry limits
                    print(f"# {n}:{direction}:{impl} failed: "
                          f"{str(e)[:100]}", file=sys.stderr)
                    continue
                spp = secs / px
                series.setdefault((direction, impl), []).append(
                    (px, spp, kind))
                print(f"{direction:4s} {impl:13s} {shape[0]:5d}x"
                      f"{shape[1]:<5d} {spp * 1e9:8.3f} ns/pixel ({kind})")
                # flush after every row: a wedged compile (or an outer
                # timeout) must not lose the measurements already taken
                _write_outputs(series, args, device)

    _write_outputs(series, args, device)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 4.5))
        for (direction, impl), rows in sorted(series.items()):
            px = [r[0] for r in rows]
            spp = [r[1] for r in rows]
            style = "-" if direction == "fwd" else "--"
            ax.loglog(px, spp, style, marker="o", label=f"{impl} "
                      f"({'fwd' if direction == 'fwd' else 'fwd+inv'})")
        ax.set_xlabel("pixels")
        ax.set_ylabel("seconds / pixel")
        ax.set_title(f"{device}: {args.wavelet} J={args.levels}")
        ax.grid(True, which="both", alpha=0.3)
        ax.legend(fontsize=8)
        fig.tight_layout()
        fig.savefig(os.path.join(args.out_dir, "perf.svg"))
        print(f"# wrote {args.out_dir}/perf.svg", file=sys.stderr)
    except Exception as e:  # matplotlib optional
        print(f"# no matplotlib figure ({e}); use gnuplot plot.txt",
              file=sys.stderr)
    print(f"# wrote {args.out_dir}/sweep.tsv and gnuplot data",
          file=sys.stderr)


if __name__ == "__main__":
    main()
