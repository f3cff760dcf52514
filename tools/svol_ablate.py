#!/usr/bin/env python3
"""What sets the pace of the streamed volume kernels B16/B17
(csrc/streamed3d.cu): copies of ``libdwt_torch/csrc`` with one setting of
the kernels changed, timed side by side in one process.

    python3 tools/svol_ablate.py [--reps 50] [--tile3 TZ,TY,TX]

Variants (each a text edit of the copy; the first eight compute the same
values, the rest are timings of kernels with a part taken out):

- as is: the sources unchanged;
- fwd 5 blocks: the forward compiled for 5 blocks of 128 threads an SM
  (``__launch_bounds__``: 102 registers at most), not 4 (128);
- inv 3 blocks: the inverse for 3 blocks of 256 threads an SM, not 2;
- step N: N plane pairs a step, not 2;
- 8-byte rows: the forward's window rows at lines::stride (2 mod 4 words:
  no bank conflicts in its row walks, copies of 8 bytes) instead of 4
  mod 8 (16-byte copies);
- chunk copies: the forward's windows by cp.async chunks of 16 bytes past
  L1 (the path of the tiles and frames the bulk copies do not take, and
  the inverse's), not one bulk copy (TMA) a row;
- late loads: the next step's loads issued after the y lift (forward) or
  the z step (inverse), not first;
- no x lift, no y lift, no z step: that part of both kernels taken out
  (the barriers of its pass too);
- no next loads: no plane pair loaded past the first RING - 1 of a
  segment.

Each variant's streamed3d.cu is built with the port's nvcc flags under
``build/svol_ablate/<variant>/`` (in parallel); B16 and B17 run on a
64x512x512 float32 CDF 9/7 volume and its 32x256x256 second level
through ctypes, each checked == its plain version, and each variant
prints one JSON line: CUDA-event times over ``--reps`` launches, device
times (CUPTI), and the registers and spills of the float32 CDF 9/7
kernels (``ptxas -v``).  Needs one CUDA card and nvcc; prints the card's
name and power limit.
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

WV = "cdf97"
LEVELS = {"level 1": (64, 512, 512), "level 2": (32, 256, 256)}

_FWD = "FWD_THREADS = 128, FWD_BLOCKS = 4;"
_INV = "INV_THREADS = 256, INV_BLOCKS = 2;"
_STEP = "constexpr int STEP = 2;"
_RS = "G.RS = inverse ? lines::stride(G.EX) : ((G.EX + 3) / 4 * 4) | 4;"
#: the next step's loads, and where the "late loads" variant moves them:
#: after the y lift (forward), after the z step (inverse)
_FLOAD = """            // into the slot of step st - 1, free since its z step
            const int sn = st + RING - 1;
            if ((bulk || loads) && sn < steps)
                fwd_load(x, ring + (sn % RING) * SL, g, sg, sn, lm, lr, groups, vec_in, vec16,
                         bulk, bars + sn % RING);
            __pipeline_commit();  // possibly empty: keeps wait_prior exact
"""
_ILOAD = """            // into the slot of step st - 1, free since its z step
            const int sn = st + RING - 1;
            if (loads && sn < steps)
                inv_load(in, ring + (sn % RING) * SLI, g, sg, sn, lh, lm, lr, lgroups, vec_in);
            __pipeline_commit();  // possibly empty: keeps wait_prior exact
"""
_FZ = "            if (nv == 0) continue;"
_IY = "            if (!emit) continue;"
_XF = "zwalk::walk_lines<NST, SYM, false, LINES>(ln, xm, g.EX / 2, P);"
_YF = "zwalk::walk_lines<NST, SYM, false, LINES>(ln, ym, g.EY / 2, P);"
_XI = "zwalk::walk_lines<NST, SYM, SF, LINES>(ln, xm, g.EX / 2, P);"
_YI = "zwalk::walk_lines<NST, SYM, SF, LINES>(ln, ym, g.EY / 2, P);"
VARIANTS = {
    "as is": [],
    "fwd 5 blocks": [(_FWD, "FWD_THREADS = 128, FWD_BLOCKS = 5;")],
    "inv 3 blocks": [(_INV, "INV_THREADS = 256, INV_BLOCKS = 3;")],
    "step 1": [(_STEP, "constexpr int STEP = 1;")],
    "step 3": [(_STEP, "constexpr int STEP = 3;")],
    "8-byte rows": [(_RS, "G.RS = lines::stride(G.EX);")],
    "chunk copies": [("const bool bulk = vec16 && g.tx % V == 0 && g.RS % V == 0;",
                      "const bool bulk = false;")],
    "late loads": [(_FLOAD, ""), (_FZ, _FLOAD + _FZ), (_ILOAD, ""), (_IY, _ILOAD + _IY)],
    "no x lift": [(_XF, ";"), (_XI, ";")],
    "no y lift": [(_YF, ";"), (_YI, ";")],
    "no z step": [(_FZ, "            continue;"), ("if (zact) {", "if (false) {")],
    "no next loads": [("if ((bulk || loads) && sn < steps)", "if (false)"),
                      ("if (loads && sn < steps)", "if (false)"),
                      ("bar_wait(bars + sl, (ph >> sl) & 1);", ";")],
}
#: the variants that compute the kernels' function
EXACT = ("as is", "fwd 5 blocks", "inv 3 blocks", "step 1", "step 3", "8-byte rows",
         "chunk copies", "late loads")


def build(name: str, edits):
    """Start nvcc on the variant's copy of streamed3d.cu; (process, library)."""
    from libdwt_torch.ops import _cuda

    d = os.path.join(ROOT, "build", "svol_ablate", name.replace(" ", "_"))
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, d)
    path = os.path.join(d, "streamed3d.cu")
    with open(path) as fh:
        text = fh.read()
    for old, new, *count in edits:
        if text.count(old) != (count[0] if count else 1):
            raise SystemExit(f"{name}: {old!r} is in streamed3d.cu {text.count(old)} times")
        text = text.replace(old, new)
    with open(path, "w") as fh:
        fh.write(text)
    lib = os.path.join(d, "streamed3d.so")
    cmd = [_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-o", lib, path]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--tile3", default="", help="tz,ty,tx (default: STILE3)")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("svol_ablate: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from libdwt_torch.ops import _cuda
    from libdwt_torch.ops import fused as F
    from libdwt_torch.ops import streamed3d as S3
    from libdwt_torch.ops.fused3d import BANDS, _band_ptrs

    smi = cs.nvidia_smi()
    print(smi, flush=True)
    tile = tuple(int(t) for t in args.tile3.split(",")) if args.tile3 else S3.STILE3
    builds = {name: build(name, edits) for name, edits in VARIANTS.items()}
    rng = np.random.default_rng(0)
    wv = F.get_wavelet(WV)
    fwd_p, inv_p = F._lift_params(wv, False, False), F._lift_params(wv, False, True)
    stream = torch.cuda.current_stream().cuda_stream
    cases = {}
    for lvl, shape in LEVELS.items():
        v = torch.from_numpy(rng.random(shape, dtype=np.float32)).cuda()
        bands = S3.dwt3_level_streamed_plain(v, WV, tile)
        ins = [bands[n].contiguous() for n in BANDS]
        outs = [torch.empty_like(b) for b in ins]
        rec = torch.empty_like(v)
        fp, ip = _band_ptrs(outs), _band_ptrs(ins)
        # the last item keeps alive what the pointers point to
        cases["B16 " + lvl] = ("dwt3_sfwd", [v.data_ptr(), fp, *shape, *tile], fwd_p,
                               outs, ins, (v, fp))
        cases["B17 " + lvl] = ("dwt3_sinv", [ip, rec.data_ptr(), *shape, *tile], inv_p,
                               [rec], [S3.idwt3_level_streamed_plain(bands, WV, tile)],
                               (ins, ip))
    for name, (proc, path) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(path)
        row = {"variant": name, "tile": tile}
        for k, (entry, cargs, P, got, want, _) in cases.items():
            fn = getattr(lib, f"{entry}_f32")
            fn.argtypes = _cuda._SIGS[entry]
            fn.restype = ctypes.c_int

            def launch():
                _cuda.check(fn(*cargs, ctypes.byref(P), stream), f"{name} {entry}")

            for o in got:
                o.zero_()
            launch()
            torch.cuda.synchronize()
            err = cs.max_abs(got, want)
            row[k + " max|diff|"] = err
            if name in EXACT and err != 0:
                row[k + " differing"] = sum(int((a != b).sum()) for a, b in zip(got, want))
            row[k + " ms"] = cs.time_ms(launch, args.reps, warm=5)
            row[k + " device ms"] = cs.device_ms(launch)
        for kern in ("sfwd3_kernelIfLi4ELb1E", "sinv3_kernelIfLi4ELb1E"):
            regs = cs.ptxas_registers(log, (kern,))
            row[kern[:5] + " registers"] = regs[0][1] if regs else None
            row[kern[:5] + " spills"] = regs[0][2] if regs else None
        print(json.dumps(row), f"[{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
