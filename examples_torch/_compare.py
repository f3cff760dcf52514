"""Run an example program in this process and hold two runs of it to each
other: exit codes, printed lines and written files.

Not a program.  ``tests/test_torch_examples*.py`` hold each port against
its reference program in ``examples/`` (both on the CPU), and
``chip_smoke.py`` holds each port on the card against the port on the
CPU, both through :func:`run_pair` and the tolerances of
:data:`TOLERANCES`.

A printed line is split into its words and its numbers.  The words must be
equal; each number is held by the first rule of its program whose pattern
matches the text before it on the line (the line's prefix), else exactly:

* ``("close", tol)``: ``|a - b| <= tol + u``, where ``u`` is the unit of
  the last digit printed (two values within ``tol`` may round apart by
  one unit);
* ``("bound", b)``: a number that only measures float rounding (a round
  trip's max|err|, a difference between two exact transforms): both runs
  must have ``|a| <= b``; they are not compared with each other;
* ``("above", b)``: the same for a PSNR: both runs must be ``>= b`` dB;
* ``("any",)``: not a result (``info``'s count of the runtime's devices).

The tolerances are the reference's own bounds: round trip 1e-3, a pyramid
against the oracle 5e-4, a single level 3e-5, integers and counts exactly,
PGM bytes within one level.
"""
from __future__ import annotations

import contextlib
import io
import os
import re
import runpy
import sys
import time
import traceback
from typing import NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: small arguments for each program: ``tests/test_examples.py``'s ``_CASES``
#: as they are, with the files it routes written to ``out`` in the run's
#: working directory
SMALL_ARGS = {
    "accel_matrix": ["--size", "128", "--levels", "2"],
    "cdf97_test": ["--size", "64", "--levels", "2"],
    "cores": ["--size", "64"],
    "denoise": ["--size", "64", "--levels", "2"],
    "displ_vectors": ["--count", "8", "--levels", "3", "--keep", "40", "--out", "out"],
    "eaw_demo": ["--size", "64", "--levels", "2"],
    "filter_coeffs": [],
    "function_iterating": ["--size", "128", "--out", "out"],
    "hdr_eaw": ["--size", "32", "--levels", "2"],
    "info": [],
    "mra": ["--n", "128", "--levels", "3", "--out", "out"],
    "nsls_demo": ["--size", "64"],
    "simple": ["--size", "64", "--levels", "3"],
    "simple_variants": ["--size", "64", "--levels", "2"],
    "start": [],
    "subbands": ["--size", "64", "--levels", "2"],
    "wavelet_func": ["--levels", "4", "--n", "128"],
    "wavelet_func2d": ["--size", "64", "--out", "out"],
}
#: the 18 programs of the port, by file name without ``.py``
PROGRAMS = tuple(SMALL_ARGS)

ROUND_TRIP, PYRAMID, LEVEL = 1e-3, 5e-4, 3e-5

#: program -> [(pattern matched at the end of a number's prefix, rule)]
TOLERANCES = {
    "accel_matrix": [],
    "cdf97_test": [],
    "cores": [(r"^(fused|nsls|separable) .*mse=$", ("bound", 1e-9))],
    "denoise": [(r"denoised MSE $", ("close", PYRAMID)),
                (r"\($", ("close", PYRAMID))],
    "displ_vectors": [(r"range \[$", ("close", PYRAMID)),
                      (r"range \[\S+, $", ("close", PYRAMID))],
    "eaw_demo": [(r"max abs err = $", ("bound", ROUND_TRIP)),
                 (r"(input|smoothed) $", ("close", PYRAMID))],
    "filter_coeffs": [(r"[hg]\[[-+]\d+\] = $", ("close", LEVEL)),
                      (r"sum\(h\) = $", ("close", LEVEL)),
                      (r"sum\(g\) = $", ("bound", LEVEL))],
    "function_iterating": [(r"^\d+\t(\S+\t)?$", ("close", PYRAMID)),
                           (r"L2=$", ("close", PYRAMID))],
    "hdr_eaw": [(r"reconstruction err: $", ("bound", ROUND_TRIP)),
                (r"range: \[$", ("close", PYRAMID)),
                (r"range: \[\S+, $", ("close", PYRAMID))],
    # the runtime's count of devices: JAX's virtual CPU devices in the
    # reference's tests, one CPU for the port
    "info": [(r"device_count: $", ("any",))],
    "mra": [],
    "nsls_demo": [(r"max\|diff\| = $", ("bound", LEVEL)),
                  (r"round trip max\|err\| = $", ("bound", 1e-4))],
    "simple": [(r"^float round trip: max abs err = $", ("bound", ROUND_TRIP))],
    "simple_variants": [(r"^float32 .*max\|err\|=$", ("bound", ROUND_TRIP)),
                        (r"psnr=$", ("above", 100.0)),
                        (r"^float64 .*max\|err\|=$", ("bound", 1e-9))],
    "start": [(r"max abs err = $", ("bound", ROUND_TRIP))],
    "subbands": [(r"energy $", ("close", PYRAMID)),
                 (r"max deviation $", ("close", ROUND_TRIP))],
    "wavelet_func": [(r"peak $", ("close", PYRAMID))],
    "wavelet_func2d": [(r"range \[$", ("close", PYRAMID)),
                       (r"range \[\S+, $", ("close", PYRAMID))],
}

#: program -> tolerance of the numbers in the files it writes (TSV, MAT, EXR)
FILE_TOLERANCE = {"cdf97_test": PYRAMID, "displ_vectors": PYRAMID,
                  "function_iterating": PYRAMID, "hdr_eaw": PYRAMID, "mra": PYRAMID,
                  "wavelet_func": PYRAMID}

NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|[-+]?inf|nan")


def path_of(name: str, port: bool = True) -> str:
    return os.path.join(ROOT, "examples_torch" if port else "examples", f"{name}.py")


class Run(NamedTuple):
    code: int  # the exit code
    out: str  # what it printed
    err: str  # its stderr, and the traceback of an uncaught exception
    seconds: float


def run(script: str, argv, cwd) -> Run:
    """Run ``script`` as ``__main__`` in this process with ``sys.argv`` =
    [script] + argv and the working directory ``cwd`` (made if missing)."""
    out, errs, err = io.StringIO(), io.StringIO(), ""
    old_argv, old_cwd = sys.argv, os.getcwd()
    sys.argv = [script] + [str(a) for a in argv]
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(errs):
            runpy.run_path(script, run_name="__main__")
        code = 0
    except SystemExit as e:  # a message in place of a code exits 1, as Python's does
        code = 0 if e.code is None else e.code if isinstance(e.code, int) else 1
        err = "" if e.code is None or isinstance(e.code, int) else str(e.code)
    except Exception:  # noqa: BLE001 - a program's failure is its exit code 1
        code, err = 1, traceback.format_exc()
    finally:
        seconds = time.perf_counter() - t0
        sys.argv = old_argv
        os.chdir(old_cwd)
    return Run(code, out.getvalue(), errs.getvalue() + err, seconds)


def _unit(text: str) -> float:
    """The unit of the last digit printed in ``text``."""
    mant, _, exp = text.lower().partition("e")
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** (int(exp or 0) - decimals)


def _rule(name: str, prefix: str):
    for pattern, rule in TOLERANCES[name]:
        if re.search(pattern, prefix):
            return rule
    return ("exact",)


def _number_ok(rule, a: str, b: str) -> bool:
    x, y = float(a), float(b)
    kind = rule[0]
    if kind == "bound":
        return abs(x) <= rule[1] and abs(y) <= rule[1]
    if kind == "any":
        return True
    if kind == "above":
        return x >= rule[1] and y >= rule[1]
    if kind == "close":
        return abs(x - y) <= rule[1] + max(_unit(a), _unit(b))
    return x == y or (np.isnan(x) and np.isnan(y))


def line_differences(name: str, want: str, got: str):
    """What differs between two runs' printed output, line by line (the
    reference's package name stands for the port's)."""
    a, b = want.replace("libdwt_tpu", "libdwt_torch").splitlines(), got.splitlines()
    if len(a) != len(b):
        return [f"{name}: {len(a)} lines != {len(b)} lines"]
    bad = []
    for i, (la, lb) in enumerate(zip(a, b)):
        words_a, words_b = NUMBER.split(la), NUMBER.split(lb)
        nums_a, nums_b = NUMBER.findall(la), NUMBER.findall(lb)
        if words_a != words_b or len(nums_a) != len(nums_b):
            bad.append(f"{name} line {i + 1}: {la!r} != {lb!r}")
            continue
        for k, (x, y) in enumerate(zip(nums_a, nums_b)):
            prefix = "".join(w + n for w, n in zip(words_a[:k], nums_a[:k])) + words_a[k]
            rule = _rule(name, prefix)
            if not _number_ok(rule, x, y):
                bad.append(f"{name} line {i + 1}: {x} vs {y} breaks {rule} in {la!r}")
    return bad


def _files(root: str):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


PGM_TOKEN = re.compile(rb"\s*(#[^\n]*\n\s*)*(\S+)")


def _pgm(path: str):
    """(header tokens, pixel values) of a P2 or P5 PGM."""
    with open(path, "rb") as f:
        data = f.read()
    tokens, pos = [], 0
    while len(tokens) < 4:
        m = PGM_TOKEN.match(data, pos)
        tokens.append(m.group(2))
        pos = m.end()
    if tokens[0] == b"P5":
        dt = np.uint8 if int(tokens[3]) < 256 else np.dtype(">u2")
        return tokens, np.frombuffer(data[pos + 1:], dt).astype(np.int64)
    return tokens, np.array(data[pos:].split(), np.int64)


def _numbers(path: str):
    """The numbers of a file and the unit of the last digit of each (0 for
    an EXR's binary floats)."""
    if path.endswith(".exr"):
        from libdwt_torch.utils.exr import read_exr

        a = np.asarray(read_exr(path)[0], np.float64).reshape(-1)
        return a, np.zeros_like(a)
    with open(path) as f:
        tokens = NUMBER.findall(f.read())
    return (np.array([float(t) for t in tokens]),
            np.array([_unit(t) for t in tokens]))


def file_differences(name: str, want_dir: str, got_dir: str):
    """What differs between the files two runs wrote under their working
    directories: the same names; PGM headers equal and pixels within one
    level; each number of a TSV, MAT or EXR file within the program's
    :data:`FILE_TOLERANCE` plus the unit of its last digit printed
    (exactly where it names none)."""
    fa, fb = _files(want_dir), _files(got_dir)
    if fa != fb:
        return [f"{name}: files {fa} != {fb}"]
    bad = []
    for rel in fa:
        pa, pb = os.path.join(want_dir, rel), os.path.join(got_dir, rel)
        if rel.endswith(".pgm"):
            (ha, va), (hb, vb) = _pgm(pa), _pgm(pb)
            if ha != hb or va.shape != vb.shape or np.abs(va - vb).max(initial=0) > 1:
                bad.append(f"{name}: {rel} differs by more than one level")
            continue
        (va, ua), (vb, ub) = _numbers(pa), _numbers(pb)
        if va.shape != vb.shape:
            bad.append(f"{name}: {rel} holds {vb.size} numbers, {va.size} expected")
            continue
        tol = FILE_TOLERANCE.get(name, 0.0)
        over = np.abs(va - vb) - (tol + np.maximum(ua, ub))
        if va.size and over.max() > 0:
            bad.append(f"{name}: {rel} max|diff| {np.abs(va - vb).max():.3e} "
                       f"breaks {tol} (plus the last digit's unit)")
    return bad


def run_pair(name: str, argv, device: str, workdir, reference: bool = False):
    """Run the port of ``name`` with ``argv`` on ``device`` in
    ``workdir/got``, after the program it is held to in ``workdir/want``:
    the reference program in ``examples/`` (``reference=True``) or the
    port on the CPU; -> (what differs: exit codes, printed lines, the
    files written under the two directories; want, got)."""
    want_dir, got_dir = os.path.join(workdir, "want"), os.path.join(workdir, "got")
    if reference:
        want = run(path_of(name, port=False), argv, want_dir)
    else:
        want = run(path_of(name), list(argv) + ["--device", "cpu"], want_dir)
    got = run(path_of(name), list(argv) + ["--device", device], got_dir)
    if want.code != got.code:
        return [f"{name}: exit code {got.code} != {want.code}\n{got.err}{want.err}"], want, got
    return (line_differences(name, want.out, got.out)
            + file_differences(name, want_dir, got_dir)), want, got
