#!/usr/bin/env python3
"""Time the streamed CUDA kernels (B8, B10, B11, B12) of the PyTorch port
over several CUDA strip shapes (ty rows x tx band columns) on one GPU.

    python3 tools/streamed_strip_sweep.py [--reps N]

Runs on a 2144x4096 float32 frame (CDF 9/7, J=5 for B11/B12, random data
from numpy seed 0) and prints one JSON line per shape: each kernel's time
in ms (CUDA events, chip_smoke.time_ms), the cooperative grid and its
co-resident limit, and the largest difference of the one-launch pyramid
from the default shape's (0 expected: the strips only move the halo).
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPES = [(64, 64), (32, 64), (16, 64), (32, 128), (16, 128), (64, 32),
          (32, 32), (128, 64), (64, 128)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("streamed_strip_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from libdwt_torch.ops import streamed as S

    x = torch.from_numpy(np.random.default_rng(0).random((2144, 4096), dtype=np.float32)).cuda()
    c2 = S.streamed_dwt2_2level(x)
    c5 = S.streamed_wavedec2_deep(x, "cdf97", 5)
    print(C.nvidia_smi())
    for ty, tx in SHAPES:
        r = {"ty": ty, "tx": tx,
             "B8": C.time_ms(lambda: S.streamed_dwt2_2level(x, ty=ty, tx=tx), args.reps),
             "B10": C.time_ms(lambda: S.streamed_idwt2_2level(*c2, ty=ty, tx=tx), args.reps),
             "B11": C.time_ms(lambda: S.streamed_wavedec2_deep(x, "cdf97", 5, ty=ty, tx=tx),
                              args.reps)}
        r["grid_B11"] = S.LAST_GRID["B11"]
        r["B12"] = C.time_ms(lambda: S.streamed_waverec2_deep(c5, ty=ty, tx=tx), args.reps)
        r["grid_B12"] = S.LAST_GRID["B12"]
        r["max_abs_vs_default"] = C.max_abs(
            C.leaves(S.streamed_wavedec2_deep(x, "cdf97", 5, ty=ty, tx=tx)), C.leaves(c5))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
