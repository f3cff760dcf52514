"""Tune the port's 'auto' dispatch table on the card.

Measures the pyramid crossover between the separable oracle and the
hand-written kernels at each size bucket
(``libdwt_torch.autotune.tune_dispatch``) and, with ``--volume``, the 3-D
single-level crossover with its subprocess probes (``tune_dispatch3``),
and persists the winners under the card's name in the table that
``libdwt_torch.api``'s 'auto' consults.  Run once per card:

    python tools/tune_torch.py [--sizes 256,512,1024,2144x4096] \\
        [--volume 64,512,512] [--out FILE | --packaged]

Imports ``libdwt_torch`` only; needs a CUDA device (the kernels are built
from ``libdwt_torch/csrc`` at first use).
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="256,512,1024,2048",
                    help="square edges or HxW shapes, comma-separated")
    ap.add_argument("--wavelet", default="cdf97")
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--out", default=None, help="override tune-file path")
    ap.add_argument("--volume", default=None,
                    help="also tune the 3-D dispatch at Z,Y,X (e.g. 64,512,512)")
    ap.add_argument("--skip-2d", action="store_true",
                    help="skip the 2-D sweep (refresh only the --volume entries)")
    ap.add_argument("--packaged", action="store_true",
                    help="write straight into the packaged table "
                         "(libdwt_torch/data/autotune.json) that fresh "
                         "processes consult when no tune file exists")
    args = ap.parse_args()
    if args.packaged:
        args.out = os.path.join(ROOT, "libdwt_torch", "data", "autotune.json")
    if args.out:
        os.environ["LIBDWT_TORCH_TUNE_FILE"] = args.out

    import torch

    from libdwt_torch import autotune

    if not torch.cuda.is_available():
        sys.exit("tune_torch: no CUDA device; the table is measured on the card")
    # each size is a square edge ("1024") or an explicit HxW geometry
    # ("2144x4096": tunes that bucket at the real frame shape)
    sizes = tuple(
        tuple(int(p) for p in s.split("x")) if "x" in s else int(s)
        for s in args.sizes.split(",")
    )
    kind = torch.cuda.get_device_name()
    print(f"device: {kind}", file=sys.stderr)
    table = {}
    if not args.skip_2d:
        table = autotune.tune_dispatch(sizes=sizes, wavelet=args.wavelet,
                                       levels=args.levels, trials=args.trials)
    if args.volume:
        shape3 = tuple(int(s) for s in args.volume.split(","))
        table = autotune.tune_dispatch3(shape3=shape3, wavelet=args.wavelet,
                                        trials=args.trials)
    findings = autotune.validate_table(table, autotune._nominal_bw_gbps(kind))
    print(json.dumps(table, indent=1, sort_keys=True))
    print(f"validate_table at {autotune._nominal_bw_gbps(kind):g} GB/s: "
          f"{findings or 'no findings'}", file=sys.stderr)
    print(f"saved to {autotune.tune_file()}", file=sys.stderr)


if __name__ == "__main__":
    main()
