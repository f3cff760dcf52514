#!/usr/bin/env python3
"""Compare the machine code (SASS) of the port's CUDA kernels between two
source trees.

    python3 tools/sass_diff.py OTHER_CSRC [SOURCE ...] [--kernels REGEX]

Builds each named source of ``libdwt_torch/csrc`` (default: fused2l.cu,
deep.cu, level.cu) and of OTHER_CSRC (another tree's csrc directory, for
example a parent commit unpacked with ``git archive``) to a cubin with the
port's nvcc flags, in parallel, under ``build/sass_diff/``; disassembles
both with ``cuobjdump -sass``; and compares them kernel by kernel.
Kernels are matched by their demangled names with the namespaces
``(anonymous namespace)::`` (``<unnamed>::``), ``deep::`` and ``volwalk::`` left out (moving a
type into a header changes the mangled name, not the code).  An instruction is its
text without its address or encoding.  Prints one line per source (kernels
on each side, how many are identical) and the first differing lines of any
kernel that differs; exits 1 if a kernel differs or exists on one side
only.  ``--kernels``: only the kernels whose normalized names match the
regular expression (for example ``sdeep_.*_lines`` in streamed.cu, whose
other kernels a change may mean to alter).  Needs nvcc and cuobjdump (the
CUDA toolkit), no GPU.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
QUALIFIERS = re.compile(r"\(anonymous namespace\)::|<unnamed>::|\b(deep|volwalk)::")


def cubin_flags(nvcc_flags) -> list:
    """The port's flags for device code only: a cubin, no host library."""
    return [f for f in nvcc_flags if f not in ("-shared", "-Xcompiler", "-fPIC")] + ["-cubin"]


def tool(name: str) -> str:
    from libdwt_torch.ops import _cuda

    nvcc = Path(_cuda.find_nvcc())
    cand = nvcc.parent / name
    return str(cand) if cand.exists() else (shutil.which(name) or name)


def kernels(sass: str) -> dict:
    """{normalized demangled name: [instruction text]} of a cuobjdump -sass
    listing."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = []
            continue
        m = INSN.search(line)
        if cur is not None and m:
            out[cur].append(m.group(1))
    names = list(out)
    demangled = subprocess.run([tool("cu++filt")], input="\n".join(names), text=True,
                               capture_output=True, check=True).stdout.splitlines()
    return {QUALIFIERS.sub("", d): out[n] for n, d in zip(names, demangled)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other tree's csrc directory")
    ap.add_argument("sources", nargs="*", default=["fused2l.cu", "deep.cu", "level.cu"])
    ap.add_argument("--kernels", default="", help="regex on the kernels' names")
    args = ap.parse_args()
    from libdwt_torch.ops import _cuda

    nvcc, flags = _cuda.find_nvcc(), cubin_flags(_cuda.NVCC_FLAGS)
    out = ROOT / "build" / "sass_diff"
    procs = []
    for side, csrc in (("this", _cuda.CSRC), ("other", Path(args.other).resolve())):
        os.makedirs(out / side, exist_ok=True)
        for src in args.sources:
            cubin = out / side / (Path(src).stem + ".cubin")
            cmd = [nvcc, *flags, "-I", str(csrc), "-o", str(cubin), str(csrc / src)]
            procs.append((side, src, cubin, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    listing = {}
    for side, src, cubin, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {side} {src}:\n{log}")
        sass = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)], text=True,
                              capture_output=True, check=True).stdout
        listing[side, src] = {k: v for k, v in kernels(sass).items()
                              if re.search(args.kernels, k)}
    bad = 0
    for src in args.sources:
        a, b = listing["this", src], listing["other", src]
        same = [k for k in a if k in b and a[k] == b[k]]
        only = sorted(set(a) ^ set(b))
        differ = [k for k in a if k in b and a[k] != b[k]]
        print(f"sass_diff {src}: {len(a)} kernels here, {len(b)} in {args.other}; "
              f"{len(same)} identical ({sum(len(a[k]) for k in same)} instructions), "
              f"{len(differ)} differ, {len(only)} on one side only", flush=True)
        for k in only:
            print(f"  only {'here' if k in a else 'there'}: {k}")
        for k in differ:
            n = next(i for i, (p, q) in enumerate(zip(a[k] + [""], b[k] + [""])) if p != q)
            print(f"  differs: {k} ({len(a[k])} vs {len(b[k])} instructions; first at {n}: "
                  f"{a[k][n] if n < len(a[k]) else '-'!r} vs "
                  f"{b[k][n] if n < len(b[k]) else '-'!r})")
        bad += len(only) + len(differ)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
