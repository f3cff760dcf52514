#!/usr/bin/env python3
"""Time the streamed CUDA kernels of the PyTorch port over several CUDA
strip and tile shapes on one GPU.

    python3 tools/streamed_strip_sweep.py [--reps N] [--mxu | --volume | --fused]

2-D: B7, B9 (one level), B8, B10 (two levels), B11, B12 (J=5, one launch)
on a 2144x4096 float32 frame (CDF 9/7, random data from numpy seed 0), per
strip shape (ty rows x tx band columns).  3-D: B16, B17 on a 64x512x512
float32 volume and its 32x256x256 second level, per tile (tz, ty, tx): the
segment step in planes and the column's core, each tile that fits both
kernels.  Prints one JSON line per shape: each kernel's time in ms (CUDA
events, chip_smoke.time_ms; the volume kernels' device time too), the
cooperative grid of B11/B12 and its co-resident limit, the volume
kernels' blocks an SM, and the largest difference from the default
shape's result (0 expected: the strips and tiles only move the halo).
``--volume``: the 3-D sweep alone.  ``--fused``: the same sweep of the
fused volume kernels B14, B15 (the same column walk, their feeds), with
the feed each took.  ``--mxu``: instead,
B8, B10, B11, B12 with the banded body (B13) on the frame per strip shape:
CUDA-event and device (CUPTI) times, the cooperative grids, and the
largest difference from each kernel's plain version at that shape (<= 2e-5
expected).  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

MXU_SHAPES = [(64, 64), (64, 96), (96, 64), (96, 96), (64, 128), (128, 64), (96, 128),
              (128, 96)]
SHAPES = [(64, 64), (32, 64), (16, 64), (32, 128), (16, 128), (64, 32),
          (32, 32), (128, 64), (64, 128)]
TILES3 = [(8, 32, 32), (4, 32, 32), (16, 32, 32), (32, 32, 32), (8, 16, 32), (8, 16, 64),
          (8, 32, 16), (8, 24, 32), (8, 16, 48), (8, 8, 64), (16, 16, 64)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--mxu", action="store_true", help="the banded body's strips")
    ap.add_argument("--volume", action="store_true", help="the volume kernels alone")
    ap.add_argument("--fused", action="store_true", help="the fused volume kernels B14/B15")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("streamed_strip_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from libdwt_torch.ops import streamed as S
    from libdwt_torch.ops import streamed3d as S3

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((2144, 4096), dtype=np.float32)).cuda()
    if args.mxu:
        return mxu_sweep(x, args.reps)
    if args.volume or args.fused:
        print(C.nvidia_smi())
        return volume_sweep(rng, args.reps, args.fused)
    c1 = S.streamed_dwt2_level(x)
    c2 = S.streamed_dwt2_2level(x)
    c5 = S.streamed_wavedec2_deep(x, "cdf97", 5)
    print(C.nvidia_smi())
    for ty, tx in SHAPES:
        r = {"ty": ty, "tx": tx,
             "B7": C.time_ms(lambda: S.streamed_dwt2_level(x, ty=ty, tx=tx), args.reps),
             "B9": C.time_ms(lambda: S.streamed_idwt2_level(*c1, ty=ty, tx=tx), args.reps),
             "B8": C.time_ms(lambda: S.streamed_dwt2_2level(x, ty=ty, tx=tx), args.reps),
             "B10": C.time_ms(lambda: S.streamed_idwt2_2level(*c2, ty=ty, tx=tx), args.reps),
             "B11": C.time_ms(lambda: S.streamed_wavedec2_deep(x, "cdf97", 5, ty=ty, tx=tx),
                              args.reps)}
        r["grid_B11"] = S.LAST_GRID["B11"]
        r["B12"] = C.time_ms(lambda: S.streamed_waverec2_deep(c5, ty=ty, tx=tx), args.reps)
        r["grid_B12"] = S.LAST_GRID["B12"]
        r["max_abs_vs_default"] = max(
            C.max_abs(C.leaves(S.streamed_wavedec2_deep(x, "cdf97", 5, ty=ty, tx=tx)),
                      C.leaves(c5)),
            C.max_abs(list(S.streamed_dwt2_level(x, ty=ty, tx=tx)), list(c1)))
        print(json.dumps(r), flush=True)
    return volume_sweep(rng, args.reps)


def volume_sweep(rng, reps: int, fused: bool = False) -> int:
    import numpy as np
    import torch

    import chip_smoke as C
    from libdwt_torch.ops import fused3d as F3
    from libdwt_torch.ops import streamed3d as S3

    if fused:
        fwd, inv, names = F3.fused_dwt3_level, F3.fused_idwt3_level, ("B14", "B15")
    else:
        fwd, inv, names = S3.streamed_dwt3_level, S3.streamed_idwt3_level, ("B16", "B17")
    v = torch.from_numpy(rng.random((64, 512, 512), dtype=np.float32)).cuda()
    b1 = fwd(v)
    ll = b1["LLL"]
    b2 = fwd(ll)
    r1 = inv(b1)
    for tile in TILES3:
        try:
            fwd(ll, tile=tile), inv(b2, tile=tile)
        except ValueError:  # a tile too wide for a kernel's threads or memory
            continue
        runs = {names[0]: lambda: fwd(v, tile=tile), names[1]: lambda: inv(b1, tile=tile),
                names[0] + "_level2": lambda: fwd(ll, tile=tile),
                names[1] + "_level2": lambda: inv(b2, tile=tile)}
        r = {"tile": tile}
        for k, fn in runs.items():
            r[k] = C.time_ms(fn, reps)
            r[k + "_device"] = C.device_ms(fn)
        mod = F3 if fused else S3
        infos = [mod.kernel_info(torch.float32, inverse=i, tile=tile) for i in (False, True)]
        r["blocks_per_sm"] = [i["blocks_per_sm"] for i in infos]
        if fused:
            r["feeds"] = [i["feed"] for i in infos]
        r["max_abs_vs_default"] = max(C.max_abs(C.leaves(fwd(v, tile=tile)), C.leaves(b1)),
                                      C.max_abs(inv(b1, tile=tile), r1))
        print(json.dumps(r), flush=True)
    return 0


def mxu_sweep(x, reps: int) -> int:
    import chip_smoke as C
    from libdwt_torch.ops import streamed as S

    c2 = S.streamed_dwt2_2level(x)
    c5 = S.streamed_wavedec2_deep(x, "cdf97", 5)
    print(C.nvidia_smi())
    for ty, tx in MXU_SHAPES:
        cases = {
            "B8": (lambda: S.streamed_dwt2_2level(x, body="mxu", ty=ty, tx=tx),
                   lambda: S.streamed_dwt2_2level_plain(x, "cdf97", ty, tx, body="mxu")),
            "B10": (lambda: S.streamed_idwt2_2level(*c2, body="mxu", ty=ty, tx=tx),
                    lambda: S.streamed_idwt2_2level_plain(*c2, "cdf97", ty, tx, body="mxu")),
            "B11": (lambda: S.streamed_wavedec2_deep(x, "cdf97", 5, body="mxu", ty=ty, tx=tx),
                    lambda: S.streamed_wavedec2_deep_plain(x, "cdf97", 5, ty, tx, body="mxu")),
            "B12": (lambda: S.streamed_waverec2_deep(c5, body="mxu", ty=ty, tx=tx),
                    lambda: S.streamed_waverec2_deep_plain(c5, "cdf97", ty, tx, body="mxu"))}
        r = {"ty": ty, "tx": tx}
        for k, (kern, plain) in cases.items():
            r[k] = C.time_ms(kern, reps)
            r[k + "_device"] = C.device_ms(kern)
            r[k + "_max_abs_vs_plain"] = C.max_abs(C.leaves(kern()), C.leaves(plain()))
        r["grid_B11"], r["grid_B12"] = S.LAST_GRID["B11"], S.LAST_GRID["B12"]
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
