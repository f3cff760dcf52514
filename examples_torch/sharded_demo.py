"""Sharded transform on a device mesh.

The port of ``examples/sharded_demo.py`` on ``libdwt_torch``: row-sharded
2-D MRA with halo exchange, then the same frame block-sharded over a
(rows, cols) mesh (the reference's BLOCKS traversal order).  The port's
mesh is one process and a device may repeat in it: the eight shards here
all live on ``--device`` (``make_mesh_2d(2, 4, devices=[dev] * 8)``),
as the reference's eight virtual CPU devices do.  There is no fallback:
without CUDA and without ``--device cpu`` the program fails.

    python examples_torch/sharded_demo.py [--levels 2] [--width 256] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdwt_torch.parallel import (  # noqa: E402
    make_mesh_2d,
    make_mesh_blocks,
    sharded_wavedec2,
    sharded_waverec2,
)
from libdwt_torch.utils.device import resolve_device  # noqa: E402
from libdwt_torch.utils.testimg import test_image  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    n_space = 4
    n_data = 2
    mesh = make_mesh_2d(n_data, n_space, devices=[dev] * 8)
    h = n_space * (1 << args.levels) * 8
    x = torch.as_tensor(test_image(h, args.width, dtype=np.float32), device=dev)

    def step(a):
        c = sharded_wavedec2(a, "cdf97", args.levels, mesh=mesh)
        return sharded_waverec2(c, "cdf97", mesh=mesh)

    rec = step(x)
    err = float((rec - x).abs().max())
    print(f"mesh {dict(mesh.shape)} image {tuple(x.shape)} "
          f"J={args.levels}: round-trip err {err:.2e}")

    # the same frame over a 2x4 (rows x cols) block mesh
    bmesh = make_mesh_blocks(1, 2, 4, devices=[dev] * 8)
    wb = 4 * (1 << args.levels) * max(8, args.width // (4 * (1 << args.levels)))
    hb = 2 * (1 << args.levels) * 8
    xb = torch.as_tensor(test_image(hb, wb, dtype=np.float32), device=dev)

    def block_step(a):
        c = sharded_wavedec2(a, "cdf97", args.levels, mesh=bmesh,
                             space_axis="rows", col_axis="cols")
        return sharded_waverec2(c, "cdf97", mesh=bmesh,
                                space_axis="rows", col_axis="cols")

    rec = block_step(xb)
    err = float((rec - xb).abs().max())
    print(f"block mesh {dict(bmesh.shape)} image {tuple(xb.shape)} "
          f"J={args.levels}: round-trip err {err:.2e}")


if __name__ == "__main__":
    main()
