#!/usr/bin/env python3
"""Where the banded body (B13) spends its time: B8-mxu and B10-mxu (the
banded strip kernels of csrc/streamed.cu with no deep level) built from
copies of ``libdwt_torch/csrc`` with one part of the pass taken out, and
timed side by side in one process.

    python3 tools/mxu_ablate.py [--reps 200] [--sass REGEX]

Variants (each a text edit of the copy; "as is", "3 blocks an SM",
"stores one tile late" and "no deep levels" compute the function, the others are
timings of a body with a part missing):

- as is: the sources unchanged;
- 3 blocks an SM: the kernels compiled for 3 blocks an SM (80
  registers), not 2 (the same values);
- stores one tile late: each tile stored after the next tile's products
  are issued, two tiles a loop step (the same values);
- no deep levels: the kernels without deep.cuh's levels (B8/B10 never run
  them; the registers the kernel is compiled with change);
- no mma: each mma.sync replaced by a few integer and float operations on
  the same registers (loads, splits and stores stay);
- no split: the three bf16 parts of a pair are all its first (one
  conversion a pair instead of three);
- no fragment loads: every tile reads the first tile's fragments;
- no column-pass stores, no row-pass stores: one of the two passes'
  stores taken out;
- stores of lead only: each output is its leading product alone (the
  other four products are issued and never read);
- sums, no stores: each output added into one register a lane (stored
  once, where it is never true) instead of stored: the products are waited
  for, the shared memory is not written;
- no write-back: the passes compute but store nothing.

Each variant's streamed.cu is built with the port's nvcc flags under
``build/mxu_ablate/<variant>/`` (in parallel), B8-mxu and B10-mxu run on
a 2144x4096 float32 CDF 9/7 frame at the default banded strip (MXU_STRIP
square) with CUDA events over
``--reps`` launches through ctypes, and each prints one JSON line: its
times, its largest difference from the plain versions, and the registers
of its forward and inverse kernels (``ptxas -v``).  ``--sass`` writes the
SASS of the "as is" kernels matching REGEX to
``build/mxu_ablate/as_is.sass``.  Needs one CUDA card and nvcc; prints the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

H, W, WV = 2144, 4096, "cdf97"

_MMA_END = '''        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
'''
_FAKE = _MMA_END + '''
__device__ __forceinline__ void fake_mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
    d[0] += __uint_as_float((a0 ^ b0) & 0x3fffffffu);
    d[1] += __uint_as_float((a1 ^ b1) & 0x3fffffffu);
    d[2] += __uint_as_float((a2 ^ b0) & 0x3fffffffu);
    d[3] += __uint_as_float((a3 ^ b1) & 0x3fffffffu);
}
'''

#: the pass's tile loop, and the same with each tile stored one tile late
_LOOP = ("        uint4 f = __ldg(fr);\n"
    "        for (int m = 0; m < nt; ++m) {\n"
    "            const bool more = m + 1 < nt;\n"
    "            uint4 fn;\n"
    "            if (more) {  // the next tile's upper half and fragments, in flight\n"
    "                read(m + 2, v);\n"
    "                fn = __ldg(fr + (m + 1) * 32);\n"
    "            }\n"
    "            float lead[4] = {0.0f, 0.0f, 0.0f, 0.0f}, rest[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n"
    "            mma(lead, lo[0][0], lo[1][0], hi[0][0], hi[1][0], f.x, f.y);\n"
    "            mma(rest, lo[0][0], lo[1][0], hi[0][0], hi[1][0], f.z, f.w);\n"
    "            mma(rest, lo[0][1], lo[1][1], hi[0][1], hi[1][1], f.x, f.y);\n"
    "            mma(rest, lo[0][1], lo[1][1], hi[0][1], hi[1][1], f.z, f.w);\n"
    "            mma(rest, lo[0][2], lo[1][2], hi[0][2], hi[1][2], f.x, f.y);\n"
    "            // outputs (line, position): (l0 + g, qa), (l0 + g, qb), (l0 + g + 8,\n"
    "            // qa), (l0 + g + 8, qb), the N order as the K order\n"
    "            const int qa = 8 * m + pa, qb = 8 * m + pb, l1 = l0 + g, l2 = l1 + 8;\n"
    "            if constexpr (COLS) {\n"
    "                if (qa < n) {\n"
    "                    if (l1 < L) s[qa * RS + l1] = __fadd_rn(lead[0], rest[0]);\n"
    "                    if (l2 < L) s[qa * RS + l2] = __fadd_rn(lead[2], rest[2]);\n"
    "                }\n"
    "                if (qb < n) {\n"
    "                    if (l1 < L) s[qb * RS + l1] = __fadd_rn(lead[1], rest[1]);\n"
    "                    if (l2 < L) s[qb * RS + l2] = __fadd_rn(lead[3], rest[3]);\n"
    "                }\n"
    "            } else if (qa < n) {  // n even: qb < n too\n"
    "                if (l1 < L)\n"
    "                    *reinterpret_cast<float2*>(s + l1 * RS + qa) =\n"
    "                        make_float2(__fadd_rn(lead[0], rest[0]), __fadd_rn(lead[1], rest[1]));\n"
    "                if (l2 < L)\n"
    "                    *reinterpret_cast<float2*>(s + l2 * RS + qa) =\n"
    "                        make_float2(__fadd_rn(lead[2], rest[2]), __fadd_rn(lead[3], rest[3]));\n"
    "            }\n"
    "            if (more) {\n"
    "#pragma unroll\n"
    "                for (int k = 0; k < 3; ++k) {\n"
    "                    lo[0][k] = hi[0][k];\n"
    "                    lo[1][k] = hi[1][k];\n"
    "                }\n"
    "                split(v[0], v[1], hi[0]);\n"
    "                split(v[2], v[3], hi[1]);\n"
    "                f = fn;\n"
    "            }\n"
    "        }\n"
    "    }\n"
    "}\n"
    "")
_LATE = ("        uint4 f = __ldg(fr);\n"
    "        auto store = [&](int m, const float (&lead)[4], const float (&rest)[4]) {\n"
    "            const int qa = 8 * m + pa, qb = 8 * m + pb, l1 = l0 + g, l2 = l1 + 8;\n"
    "            if constexpr (COLS) {\n"
    "                if (qa < n) {\n"
    "                    if (l1 < L) s[qa * RS + l1] = __fadd_rn(lead[0], rest[0]);\n"
    "                    if (l2 < L) s[qa * RS + l2] = __fadd_rn(lead[2], rest[2]);\n"
    "                }\n"
    "                if (qb < n) {\n"
    "                    if (l1 < L) s[qb * RS + l1] = __fadd_rn(lead[1], rest[1]);\n"
    "                    if (l2 < L) s[qb * RS + l2] = __fadd_rn(lead[3], rest[3]);\n"
    "                }\n"
    "            } else if (qa < n) {\n"
    "                if (l1 < L)\n"
    "                    *reinterpret_cast<float2*>(s + l1 * RS + qa) =\n"
    "                        make_float2(__fadd_rn(lead[0], rest[0]), __fadd_rn(lead[1], rest[1]));\n"
    "                if (l2 < L)\n"
    "                    *reinterpret_cast<float2*>(s + l2 * RS + qa) =\n"
    "                        make_float2(__fadd_rn(lead[2], rest[2]), __fadd_rn(lead[3], rest[3]));\n"
    "            }\n"
    "        };\n"
    "        auto step = [&](int m, float (&lead)[4], float (&rest)[4], const float (&pl)[4],\n"
    "                        const float (&pr)[4]) {\n"
    "            const bool more = m + 1 < nt;\n"
    "            uint4 fn;\n"
    "            if (more) {\n"
    "                read(m + 2, v);\n"
    "                fn = __ldg(fr + (m + 1) * 32);\n"
    "            }\n"
    "            for (int k = 0; k < 4; ++k) lead[k] = rest[k] = 0.0f;\n"
    "            mma(lead, lo[0][0], lo[1][0], hi[0][0], hi[1][0], f.x, f.y);\n"
    "            mma(rest, lo[0][0], lo[1][0], hi[0][0], hi[1][0], f.z, f.w);\n"
    "            mma(rest, lo[0][1], lo[1][1], hi[0][1], hi[1][1], f.x, f.y);\n"
    "            mma(rest, lo[0][1], lo[1][1], hi[0][1], hi[1][1], f.z, f.w);\n"
    "            mma(rest, lo[0][2], lo[1][2], hi[0][2], hi[1][2], f.x, f.y);\n"
    "            if (m > 0) store(m - 1, pl, pr);\n"
    "            if (more) {\n"
    "                for (int k = 0; k < 3; ++k) {\n"
    "                    lo[0][k] = hi[0][k];\n"
    "                    lo[1][k] = hi[1][k];\n"
    "                }\n"
    "                split(v[0], v[1], hi[0]);\n"
    "                split(v[2], v[3], hi[1]);\n"
    "                f = fn;\n"
    "            }\n"
    "        };\n"
    "        float la4[4], ra4[4], lb4[4], rb4[4];\n"
    "        for (int m = 0; m < nt; m += 2) {\n"
    "            step(m, la4, ra4, lb4, rb4);\n"
    "            if (m + 1 < nt) step(m + 1, lb4, rb4, la4, ra4);\n"
    "        }\n"
    "        if (nt & 1)\n"
    "            store(nt - 1, la4, ra4);\n"
    "        else\n"
    "            store(nt - 1, lb4, rb4);\n"
    "    }\n"
    "}\n"
    "")

#: variant -> [(file, old text, new text, count)]
VARIANTS = {
    "as is": [],
    "3 blocks an SM": [
        ("streamed.cu", "constexpr int MXU_BLOCKS = 2;", "constexpr int MXU_BLOCKS = 3;", 1)],
    "stores one tile late": [("banded.cuh", _LOOP, _LATE, 1)],
    "no deep levels": [
        ("streamed.cu", "    fwd2_mxu_strips(x, b, g, M, s);\n    if (d.n > 0) {\n        "
         "cg::this_grid().sync();\n        deep::fwd_levels<NST, SYM>(d, P, s);\n    }\n",
         "    fwd2_mxu_strips(x, b, g, M, s);\n", 1),
        ("streamed.cu", "    if (d.n > 0) {\n        deep::inv_levels<NST, SYM>(d, P, s);\n"
         "        cg::this_grid().sync();\n    }\n    inv2_mxu_strips(b, g, M, s);\n",
         "    inv2_mxu_strips(b, g, M, s);\n", 1)],
    "no mma": [
        ("banded.cuh", _MMA_END, _FAKE, 1),
        ("banded.cuh", "            mma(lead, ", "            fake_mma(lead, ", 1),
        ("banded.cuh", "            mma(rest, ", "            fake_mma(rest, ", 4)],
    "no split": [
        ("banded.cuh", "    x[1] = pack(ra, rb);\n    x[2] = pack(__fsub_rn(ra, low(x[1])), "
         "__fsub_rn(rb, high(x[1])));\n", "    x[1] = x[0];\n    x[2] = x[0];\n", 1)],
    "no fragment loads": [
        ("banded.cuh", "fn = __ldg(fr + (m + 1) * 32);", "fn = f;", 1)],
    "no column-pass stores": [
        ("banded.cuh", "                if (qa < n) {", "                if (qa < 0) {", 1),
        ("banded.cuh", "                if (qb < n) {", "                if (qb < 0) {", 1)],
    "no row-pass stores": [
        ("banded.cuh", "} else if (qa < n) {", "} else if (qa < 0) {", 1)],
    "stores of lead only": [
        ("banded.cuh", "__fadd_rn(lead[0], rest[0])", "lead[0]", 2),
        ("banded.cuh", "__fadd_rn(lead[1], rest[1])", "lead[1]", 2),
        ("banded.cuh", "__fadd_rn(lead[2], rest[2])", "lead[2]", 2),
        ("banded.cuh", "__fadd_rn(lead[3], rest[3])", "lead[3]", 2)],
    "sums, no stores": [
        ("banded.cuh", "        const int la = min(l0 + g, L - 1), lb = min(l0 + g + 8, L - 1);",
         "        float sink = 0.0f;\n"
         "        const int la = min(l0 + g, L - 1), lb = min(l0 + g + 8, L - 1);", 1),
        ("banded.cuh", "s[qa * RS + l1] = __fadd_rn(lead[0], rest[0]);",
         "sink += __fadd_rn(lead[0], rest[0]);", 1),
        ("banded.cuh", "s[qa * RS + l2] = __fadd_rn(lead[2], rest[2]);",
         "sink += __fadd_rn(lead[2], rest[2]);", 1),
        ("banded.cuh", "s[qb * RS + l1] = __fadd_rn(lead[1], rest[1]);",
         "sink += __fadd_rn(lead[1], rest[1]);", 1),
        ("banded.cuh", "s[qb * RS + l2] = __fadd_rn(lead[3], rest[3]);",
         "sink += __fadd_rn(lead[3], rest[3]);", 1),
        ("banded.cuh", "*reinterpret_cast<float2*>(s + l1 * RS + qa) =\n"
         "                        make_float2(__fadd_rn(lead[0], rest[0]), __fadd_rn(lead[1], rest[1]));",
         "sink += __fadd_rn(lead[0], rest[0]) + __fadd_rn(lead[1], rest[1]);", 1),
        ("banded.cuh", "*reinterpret_cast<float2*>(s + l2 * RS + qa) =\n"
         "                        make_float2(__fadd_rn(lead[2], rest[2]), __fadd_rn(lead[3], rest[3]));",
         "sink += __fadd_rn(lead[2], rest[2]) + __fadd_rn(lead[3], rest[3]);", 1),
        ("banded.cuh", "                f = fn;\n            }\n        }\n",
         "                f = fn;\n            }\n        }\n        if (sink == 1.5f) s[l0] = sink;\n", 1)],
    "no write-back": [
        ("banded.cuh", "if (qa < n) {", "if (qa < 0) {", 2),
        ("banded.cuh", "if (qb < n) {", "if (qb < 0) {", 1)],
}


def variant_dir(name: str) -> str:
    return os.path.join(ROOT, "build", "mxu_ablate", name.replace(" ", "_"))


def build(name: str, edits):
    """Start nvcc on the variant's copy of streamed.cu; (process, library)."""
    from libdwt_torch.ops import _cuda

    d = variant_dir(name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, d)
    for f, old, new, count in edits:
        path = os.path.join(d, f)
        with open(path) as fh:
            text = fh.read()
        if text.count(old) != count:
            raise SystemExit(f"{name}: {old!r} is in {f} {text.count(old)} times, not {count}")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))
    lib = os.path.join(d, "streamed.so")
    cmd = [_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-o", lib, os.path.join(d, "streamed.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--sass", default="", help="regex of the 'as is' kernels to disassemble")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mxu_ablate: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from libdwt_torch.ops import _cuda, banded
    from libdwt_torch.ops import fused as F
    from libdwt_torch.ops import streamed as S

    smi = cs.nvidia_smi()
    print(smi, flush=True)
    strip = S.MXU_STRIP
    builds = {name: build(name, edits) for name, edits in VARIANTS.items()}
    x = torch.from_numpy(np.random.default_rng(0).random((H, W), dtype=np.float32)).cuda()
    ll2, b2, b1 = S.streamed_dwt2_2level_plain(x, WV, strip, strip, body="mxu")
    fwd_want = cs.leaves((ll2, b2, b1))
    ins = [a.contiguous() for a in (ll2, *b2, *b1)]
    inv_want = S.streamed_idwt2_2level_plain(ins[0], tuple(ins[1:4]), tuple(ins[4:]), WV,
                                             strip, strip, body="mxu")
    fwd_out = [torch.empty((H // 4, W // 4), device="cuda") for _ in range(4)]
    fwd_out += [torch.empty((H // 2, W // 2), device="cuda") for _ in range(3)]
    inv_out = torch.empty((H, W), device="cuda")
    wv = F.get_wavelet(WV)
    cases = {  # entry, pointers, lifting parameters, matrices
        "B8": ("dwt_sfwd2_mxu", [x] + fwd_out, F._lift_params(wv, False, False),
               banded.kernel_mats(WV, False, strip, strip, x.device)),
        "B10": ("dwt_sinv2_mxu", ins + [inv_out], F._lift_params(wv, False, True),
                banded.kernel_mats(WV, True, strip, strip, x.device)),
    }
    stream = torch.cuda.current_stream().cuda_stream
    for name, (proc, path) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(path)
        row = {"variant": name}
        for k, (entry, ptrs, P, M) in cases.items():
            fn = getattr(lib, f"{entry}_f32")
            fn.argtypes = _cuda._SIGS[entry]
            fn.restype = ctypes.c_int
            cargs = [t.data_ptr() for t in ptrs] + [H, W, strip, strip, ctypes.byref(P),
                                                     ctypes.byref(M), stream]
            _cuda.check(fn(*cargs), f"{name} {entry}")
            torch.cuda.synchronize()
            got, want = (fwd_out, fwd_want) if k == "B8" else ([inv_out], [inv_want])
            row[k + "_ms"] = cs.time_ms(lambda: fn(*cargs), args.reps, warm=10)
            row[k + "_max_abs_vs_plain"] = cs.max_abs(got, want)
        for kern in ("sdeep_fwd_mxuILi4ELb1E", "sdeep_inv_mxuILi4ELb1E"):
            regs = cs.ptxas_registers(log, (kern,))
            row[kern[:13] + "_registers"] = regs[0][1] if regs else None
            row[kern[:13] + "_spills"] = regs[0][2] if regs else None
        print(json.dumps(row), f"[{smi}]", flush=True)
        if name == "as is" and args.sass:
            sass = subprocess.run([os.path.join(os.path.dirname(_cuda.find_nvcc()), "cuobjdump"),
                                   "-sass", path], text=True, capture_output=True,
                                  check=True).stdout
            keep, out = False, []
            for line in sass.splitlines():
                if "Function :" in line:
                    keep = re.search(args.sass, line) is not None
                if keep:
                    out.append(line)
            with open(os.path.join(ROOT, "build", "mxu_ablate", "as_is.sass"), "w") as fh:
                fh.write("\n".join(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
