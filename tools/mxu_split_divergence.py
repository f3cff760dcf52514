#!/usr/bin/env python3
"""How far two float32 summation orders of the banded body (B13) drift
apart, for the reference's two-part data split and the port's exact
three-part split.

    python3 tools/mxu_split_divergence.py [--size H W] [--seed N]

Runs the plain two-level streamed forward (B8's strips, 64x64) and the
plain two-level inverse with the banded body on a uniform random float32
frame (CDF 9/7), on the CPU, each pass summed two ways: the float32
matrix products of ``ops.banded.apply_packed_plain``, and the same
products summed in float64 and rounded to float32 once (another order, as
the tensor cores' is another order).  Prints one JSON line per data split
with the largest difference between the two orders, forward and inverse,
and the largest difference from the polyphase body.  The kernels are held
to 2e-5 against their plain versions.  The default size is half the bench
frame (1072x2048), which keeps the CPU run to a few seconds and about 2 GB.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, nargs=2, default=(1072, 2048))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    from libdwt_torch.ops import banded, fused

    h, w = args.size
    x = torch.from_numpy(np.random.default_rng(args.seed).random((h, w), dtype=np.float32))

    def two_parts(v):
        hi = v.to(torch.bfloat16).float()
        return hi, (v - hi).to(torch.bfloat16).float()

    def products(parts, pm, axis, acc):
        """The split products of one pass in ``acc``: Whi with every data
        part, Wlo with all but the last (for two parts: Whi.xhi + Whi.xlo
        + Wlo.xhi, the reference's three products)."""
        whi, wlo = (m.to(acc) for m in pm.dense())
        ws = [(whi, p) for p in parts] + [(wlo, p) for p in parts[:-1]]
        out = 0
        for m, p in ws:
            p = p.to(acc)
            out = out + (m @ p if axis == -2 else p @ m.T)
        return out.float()

    def run(split, acc):
        def body(v, pm, axis):
            return products(split(v), pm, axis, acc)
        orig = banded.apply_packed_plain
        banded.apply_packed_plain = body
        try:
            fwd = fused.dwt2_2level_tiles(x, "cdf97", 64, 64, 16,
                                          lambda t: banded.analysis2d_packed(t, "cdf97"))
            inv = fused.idwt2_2level_tiles(*poly, "cdf97", 64, 64,
                                           lambda t: banded.synthesis2d_packed(t, "cdf97"))
        finally:
            banded.apply_packed_plain = orig
        return fwd, inv

    def leaves(t):
        return [z for s in t for z in leaves(s)] if isinstance(t, (list, tuple)) else [t]

    def maxdiff(a, b):
        return max(float((p.double() - q.double()).abs().max())
                   for p, q in zip(leaves(a), leaves(b)))

    poly = fused.dwt2_2level_tiles(x, "cdf97", 64, 64, 16)
    for name, split in (("two parts (reference)", two_parts),
                        ("three parts (port)", lambda v: list(banded.split_data(v)))):
        f32, i32 = run(split, torch.float32)
        f64, i64 = run(split, torch.float64)
        print(json.dumps({
            "split": name, "frame": f"{h}x{w}",
            "forward_orders_max_diff": maxdiff(f32, f64),
            "inverse_orders_max_diff": maxdiff(i32, i64),
            "forward_vs_poly_max_diff": maxdiff(f32, poly),
            "inverse_of_poly_coefficients_max_err": maxdiff(i32, x),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
