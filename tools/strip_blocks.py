#!/usr/bin/env python3
"""Blocks an SM for B8 and B10, the two-level strip kernels of
csrc/streamed.cu (``sstrip_fwd_lines``, ``sstrip_inv_lines``): copies of
``libdwt_torch/csrc`` built with another ``__launch_bounds__`` floor
(``STRIP_FWD_BLOCKS``, ``STRIP_INV_BLOCKS``), or with the strip loops kept
rolled (``#pragma unroll 1``), and timed side by side in one process.

    python3 tools/strip_blocks.py [--reps 200] [--strip 64] [--rolled] [--floors F:I,...]

Each variant (a pair of floors, forward and inverse, from ``--floors``
or the script's list; 1 leaves the registers to the compiler; with
``--rolled`` each pair also with every strip walk of streamed.cu rolled,
which changes B11/B12 and the banded kernels in that copy too) is built
with the port's nvcc flags under ``build/strip_blocks/<variant>/`` (in
parallel).  B8 and B10 then run on a
2144x4096 float32 CDF 9/7 frame at the square strip ``--strip`` through
ctypes, with CUDA events over ``--reps`` launches, and each variant prints
one JSON line: its times, its largest difference from the plain versions
(0: the floor changes no value), and each kernel's registers, spills
(``ptxas -v``), blocks an SM and grid (``dwt_s2info``).  Needs one CUDA
card and nvcc; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

H, W, WV = 2144, 4096, "cdf97"
#: (forward floor, inverse floor) of each variant
VARIANTS = ((1, 1), (3, 4), (4, 5), (5, 6), (6, 7), (7, 8))
#: the strip loop of the two-level walks (line walks and banded), and the
#: same kept rolled
_LOOP = "        for (int i = first; i < last; ++i) {\n            const int y0 = i * ty;\n"
_ROLLED = "#pragma unroll 1\n" + _LOOP


def build(fwd: int, inv: int, rolled: bool):
    """Start nvcc on a copy of streamed.cu with these floors (and the strip
    loops rolled); (process, library)."""
    from libdwt_torch.ops import _cuda

    d = os.path.join(ROOT, "build", "strip_blocks",
                     f"fwd{fwd}_inv{inv}" + ("_rolled" if rolled else ""))
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, d)
    path = os.path.join(d, "streamed.cu")
    with open(path) as fh:
        text = fh.read()
    for name, n in (("STRIP_FWD_BLOCKS", fwd), ("STRIP_INV_BLOCKS", inv)):
        head = f"constexpr int {name} = "
        if text.count(head) != 1:
            raise SystemExit(f"{name} is not defined once in streamed.cu")
        i = text.index(head) + len(head)
        text = text[:i] + str(n) + text[text.index(";", i):]
    if rolled:
        if text.count(_LOOP) != 4:
            raise SystemExit(f"the strip loop is in streamed.cu {text.count(_LOOP)} times, not 4")
        text = text.replace(_LOOP, _ROLLED)
    with open(path, "w") as fh:
        fh.write(text)
    lib = os.path.join(d, "streamed.so")
    cmd = [_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-o", lib, path]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--strip", type=int, default=64)
    ap.add_argument("--rolled", action="store_true",
                    help="also build each pair with the strip loops rolled")
    ap.add_argument("--floors", default="",
                    help="the pairs to build, as F:I,F:I (default: the script's list)")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("strip_blocks: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from libdwt_torch.ops import _cuda
    from libdwt_torch.ops import fused as F
    from libdwt_torch.ops import streamed as S

    smi = cs.nvidia_smi()
    print(smi, flush=True)
    st = args.strip
    pairs = ([tuple(int(n) for n in p.split(":")) for p in args.floors.split(",")]
             if args.floors else VARIANTS)
    builds = {(f, i, r): build(f, i, r) for f, i in pairs
              for r in ((False, True) if args.rolled else (False,))}
    x = torch.from_numpy(np.random.default_rng(0).random((H, W), dtype=np.float32)).cuda()
    ll2, b2, b1 = S.streamed_dwt2_2level_plain(x, WV, st, st)
    fwd_want = cs.leaves((ll2, b2, b1))
    ins = [a.contiguous() for a in (ll2, *b2, *b1)]
    inv_want = S.streamed_idwt2_2level_plain(ins[0], tuple(ins[1:4]), tuple(ins[4:]), WV, st, st)
    fwd_out = [torch.empty((H // 4, W // 4), device="cuda") for _ in range(4)]
    fwd_out += [torch.empty((H // 2, W // 2), device="cuda") for _ in range(3)]
    inv_out = torch.empty((H, W), device="cuda")
    wv = F.get_wavelet(WV)
    cases = {  # entry, pointers, lifting parameters, inverse
        "B8": ("dwt_sfwd2", [x] + fwd_out, F._lift_params(wv, False, False), 0),
        "B10": ("dwt_sinv2", ins + [inv_out], F._lift_params(wv, False, True), 1),
    }
    stream = torch.cuda.current_stream().cuda_stream
    for (fwd, inv, rolled), (proc, path) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on fwd {fwd} inv {inv}:\n{log}")
        lib = ctypes.CDLL(path)
        info_fn = lib.dwt_s2info_f32
        info_fn.argtypes = _cuda._SIGS["dwt_s2info"]
        info_fn.restype = ctypes.c_int
        row = {"fwd_floor": fwd, "inv_floor": inv, "rolled": rolled, "strip": st}
        for k, (entry, ptrs, P, inverse) in cases.items():
            fn = getattr(lib, f"{entry}_f32")
            fn.argtypes = _cuda._SIGS[entry]
            fn.restype = ctypes.c_int
            cargs = [t.data_ptr() for t in ptrs] + [H, W, st, st, ctypes.byref(P), stream]
            _cuda.check(fn(*cargs), f"{entry} fwd {fwd} inv {inv}")
            torch.cuda.synchronize()
            got, want = (fwd_out, fwd_want) if k == "B8" else ([inv_out], [inv_want])
            row[k + "_max_abs_vs_plain"] = cs.max_abs(got, want)
            row[k + "_ms"] = cs.time_ms(lambda: fn(*cargs), args.reps, warm=10)
            out = (ctypes.c_int * 4)()
            _cuda.check(info_fn(inverse, H, W, st, st, ctypes.byref(P), out), "dwt_s2info")
            row.update({f"{k}_{n}": v for n, v in
                        zip(("registers", "blocks_per_sm", "grid", "smem"), out)})
            kern = ("sstrip_inv_lines" if inverse else "sstrip_fwd_lines") + (
                f"IfLi{st}ELi4ELb1E" if st == 64 else "IfLi0ELi4ELb1E")
            regs = cs.ptxas_registers(log, (kern,))
            row[k + "_spills"] = regs[0][2] if regs else None
        print(json.dumps(row), f"[{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
