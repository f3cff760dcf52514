"""Run an example program in this process and hold two runs of it to each
other: exit codes, printed lines and written files.

Not a program.  ``tests/test_torch_examples*.py`` hold each port against
its reference program in ``examples/`` (both on the CPU), and
``chip_smoke.py`` holds each port on the card against the port on the
CPU, both through :func:`run_pair` and the tolerances of
:data:`TOLERANCES`.

A printed line is split into its words and its numbers.  The words must be
equal (a run of blanks, padding whose width follows the numbers', counts
as one); each number is held by the first rule of its program whose pattern
matches the text before it on the line (the line's prefix), else exactly:

* ``("close", tol)``: ``|a - b| <= tol + u``, where ``u`` is the unit of
  the last digit printed (two values within ``tol`` may round apart by
  one unit); ``("close", tol, n)`` for numbers printed with ``n``
  significant digits by ``%g``, which drops trailing zeros;
* ``("bound", b)``: a number that only measures float rounding (a round
  trip's max|err|, a difference between two exact transforms): both runs
  must have ``|a| <= b``; they are not compared with each other;
* ``("above", b)``: the same for a PSNR: both runs must be ``>= b`` dB;
* ``("any",)``: not a result (``info``'s count of the runtime's devices);
* ``("time",)``: a time or a rate measured by the run (the perf
  programs): both runs' numbers must be positive and finite; they are not
  compared with each other;
* ``("energy", d)``: a band's energy (sum of squares) of ``n``
  coefficients that may each differ by ``d``, ``n`` from the band's shape
  printed before it (``32x32x3`` or ``(16, 16)``):
  ``|a - b| <= 2 d sqrt(n max(a, b)) + u``;
* ``("mse", e)``, ``("psnr", e)``: a mean squared error (a PSNR, turned
  back into one) of images whose pixels may differ by ``e``:
  ``|a - b| <= 2 sqrt(max(a, b)) e + e^2``.

Some lines hold a part that is not a result at all, such as the device's
name or the host's node name: :data:`EXCUSED` names it by a pattern whose
group ``x`` is taken out of both lines before they are compared, or whose
group ``d`` is a dict literal of which only the keys are compared.  The
perf programs' text files are compared line by line with the same rules
(:data:`LINE_FILES`); an SVG figure is held only to be present on both
sides or on neither.

The tolerances are the reference's own bounds: round trip 1e-3, a pyramid
against the oracle 5e-4, a single level 3e-5, integers and counts exactly,
PGM bytes within one level.  ``similarity`` scales its image to 0..255, so
its tolerances are those bounds scaled by 255 (:func:`similarity_rules`).
"""
from __future__ import annotations

import ast
import contextlib
import functools
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
    "interop_flags": ["--size", "48", "--levels", "2"],
    "interop_subbands": ["--size", "50", "--levels", "2", "--out", "."],
    "io_roundtrip": ["--size", "32", "--out", "out"],
    "load": ["missing.pgm"],
    "perf_line": ["--lengths", "256,1024", "--batch", "8", "--levels", "2", "--trials", "1",
                  "--out", "perf_line.tsv"],
    "perf_plot": ["--sizes", "64", "--levels", "2", "--impls", "separable", "--dirs", "fwd",
                  "--trials", "1", "--chains", "2,4", "--out-dir", "out"],
    "perf_sweep": ["--sizes", "32", "--levels", "2", "--impl", "separable",
                   "--out", "perf.tsv"],
    "sharded_demo": ["--levels", "1", "--width", "64"],
    "similarity": ["--size", "64", "--levels", "2"],
    "spectra_blobs": ["--n", "256", "--bins", "32", "--components", "3", "--ridges", "6"],
    "spectra_dwt": ["--n-signals", "4", "--length", "128", "--levels", "2",
                    "--out-dir", "out"],
    "spectra_fe": ["--n-signals", "4", "--length", "128", "--levels", "2",
                   "--out", "out"],
    "spectra_svm": ["--n-signals", "32", "--length", "128", "--levels", "3",
                    "--features", "wps", "--out", "out"],
    "spectra_swt": ["--n-signals", "4", "--length", "128", "--levels", "2",
                    "--out", "out"],
    "spectra_tf": ["--size", "128", "--bins", "16"],
    "timefreq": ["--size", "128", "--bins", "16", "--out", "out"],
}
#: the 34 programs of the port, by file name without ``.py``
PROGRAMS = tuple(SMALL_ARGS)

ROUND_TRIP, PYRAMID, LEVEL = 1e-3, 5e-4, 3e-5
#: the perf programs: their times and rates are measurements, not results
TIME = ("time",)
#: the estimator of a chain-slope time ('slope' or 'upper', see
#: ``autotune._chain_slope_secs``) is chosen by the times measured, so it is
#: held to be one of the two names, not equal
ESTIMATOR = r"(?P<x>\bslope|\bupper)\)?$"

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
    "interop_flags": [(r"display range: \[(\S+, )?$", ("close", PYRAMID)),
                      (r"energy=$", ("energy", PYRAMID)),
                      (r"max abs err = $", ("bound", 1e-4))],
    "interop_subbands": [(r"energy=$", ("energy", PYRAMID)),
                         (r"round trip max\|err\|=$", ("bound", ROUND_TRIP)),
                         (r"RMSE=$", ("close", PYRAMID))],
    # the MAT file's %f text keeps 6 decimals: its round trip measures that
    # rounding
    "io_roundtrip": [(r"^MAT round trip: .*max err $", ("bound", LEVEL))],
    # the integer CDF 5/3 round trip is exact; the float one is held to EPS
    "load": [(r"^cdf53 .*max abs err = $", ("exact",)),
             (r"max abs err = $", ("bound", ROUND_TRIP))],
    "perf_line": [(r"^ *n= *\d+: +$", TIME), (r"ns/sample +$", TIME),
                  (r"^\d+\t(\S+\t)?$", TIME)],
    "perf_plot": [(r"^\w+ +\S+ +\d+x\d+ +$", TIME), (r"^\d+ $", TIME),
                  (r"^\w+\t\S+\t\d+\t$", TIME)],
    "perf_sweep": [(r"^ *\d+\^\d+: +$", TIME), (r"ns/pixel +$", TIME),
                   (r"^\d+\t(\S+\t)?$", TIME)],
    "sharded_demo": [(r"round-trip err $", ("bound", ROUND_TRIP))],
    "spectra_blobs": [],
    "spectra_dwt": [(r"energy $", ("energy", PYRAMID))],
    "spectra_fe": [],
    "spectra_svm": [],
    "spectra_swt": [],
    "spectra_tf": [],
    "timefreq": [(r"peak $", ("close", PYRAMID))],
}

#: program -> patterns of a line's parts that are not results: group ``x``
#: is taken out of both lines, group ``d`` (a dict literal) is held by its
#: keys alone.  The device's and the host's names, ``info()``'s values, the
#: estimator of a chain-slope time, the device named in a perf data file.
SYSTEM = r"^system: (?P<d>\{.*\})$"
EXCUSED = {
    "load": [r"^running on (?P<x>.+)$", r"^node (?P<x>.+)$"],
    "perf_line": [SYSTEM],
    "perf_sweep": [SYSTEM],
    "perf_plot": [ESTIMATOR, r"^# (?P<x>.+): secs/pixel, "],
}
#: programs whose text files are compared line by line with their rules
#: (the perf programs' TSV and gnuplot files: columns of times)
LINE_FILES = {"perf_line", "perf_sweep", "perf_plot"}

#: program -> tolerance of the numbers in the files it writes (TSV, MAT,
#: EXR, LIBSVM)
FILE_TOLERANCE = {"cdf97_test": PYRAMID, "displ_vectors": PYRAMID,
                  "function_iterating": PYRAMID, "hdr_eaw": PYRAMID, "mra": PYRAMID,
                  "wavelet_func": PYRAMID, "io_roundtrip": PYRAMID,
                  "spectra_dwt": PYRAMID, "spectra_fe": PYRAMID, "spectra_svm": PYRAMID,
                  "spectra_swt": PYRAMID, "spectra_tf": LEVEL}

#: reference programs that change the interpreter's JAX settings (the
#: compilation cache, the count of virtual devices): run in a process of
#: their own
OWN_PROCESS = {"perf_plot", "sharded_demo"}

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


def run_process(script: str, argv, cwd, timeout: float = 300) -> Run:
    """:func:`run` in a new interpreter (the repo on its path, JAX on the
    CPU), for a reference program that changes its process's settings."""
    import subprocess

    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    os.makedirs(cwd, exist_ok=True)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, script] + [str(a) for a in argv], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=timeout)
    return Run(p.returncode, p.stdout, p.stderr, time.perf_counter() - t0)


def _unit(text: str) -> float:
    """The unit of the last digit printed in ``text``."""
    mant, _, exp = text.lower().partition("e")
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** (int(exp or 0) - decimals)


def similarity_rules(argv, kernels: bool = True) -> list:
    """``similarity``'s rules for the run with ``argv``.  Held against the
    card (``kernels``), they are the reference's bounds scaled by the
    image's 0..255 range: a coefficient of the card's pyramid lies within
    ``ec = 255 * 5e-4`` of the oracle's, a pixel of its reconstruction
    within ``er = 255 * 1e-3``.  So MAE is held within ``er``, MSE and PSNR
    by ``("mse", er)``, MSSIM (which does not scale with the range) within
    1e-3; and ``kept[%]`` at a threshold within the share of the oracle's
    detail coefficients that lie within ``ec`` of it, the ones that can
    cross it (computed here, from the port's oracle on the CPU at the
    run's size, levels and wavelet).  Two runs of the oracle (the port's
    and the reference's, ``kernels=False``) are held to the bounds
    themselves, unscaled."""
    ap = {"--size": 512, "--levels": 4, "--wavelet": "cdf97"}
    argv = [str(a) for a in argv]
    for i, a in enumerate(argv[:-1]):
        if a in ap:
            ap[a] = type(ap[a])(argv[i + 1])
    return _similarity_rules(ap["--size"], ap["--levels"], ap["--wavelet"], kernels)


@functools.lru_cache(maxsize=None)
def _similarity_rules(size: int, levels: int, wavelet: str, kernels: bool) -> list:
    import torch

    from libdwt_torch import wavedec2
    from libdwt_torch.utils.testimg import test_image

    scale = 255.0 if kernels else 1.0
    ec, er = scale * PYRAMID, scale * ROUND_TRIP
    img = torch.as_tensor(test_image(size, size, dtype=np.float32))
    img = 255.0 * (img - img.min()) / float(img.max() - img.min())
    mags = torch.cat([b.abs().reshape(-1) for lvl in wavedec2(img, wavelet, levels)[1:]
                      for b in lvl])
    sep = r"(\t| & )"
    col = lambda k: rf"^([^\t&]+{sep}){{{k}}}$"  # noqa: E731 - the k-th column's prefix
    rules = [(rf"^{thr:g}{sep}$", ("close", 100.0 * float(((mags - thr).abs() <= ec)
                                                            .double().mean())))
             for thr in (0.0, 1.0, 5.0, 20.0, 80.0)]
    return rules + [(col(2), ("mse", er)), (col(3), ("psnr", er)),
                    (col(4), ("close", ROUND_TRIP, 4)), (col(5), ("close", er, 4))]


def _rules(name: str, argv=None, kernels: bool = True) -> list:
    return similarity_rules(argv or [], kernels) if name == "similarity" else TOLERANCES[name]


def _rule(rules, prefix: str):
    for pattern, rule in rules:
        if re.search(pattern, prefix):
            return rule
    return ("exact",)


SHAPE = re.compile(r"\d+(?:x\d+)+|\(\d+(?:, \d+)*\)")


def _number_ok(rule, a: str, b: str, prefix: str = "") -> bool:
    x, y = float(a), float(b)
    kind = rule[0]
    if kind == "energy":
        n = int(np.prod([int(d) for d in re.findall(r"\d+", SHAPE.findall(prefix)[-1])]))
        return abs(x - y) <= 2.0 * rule[1] * (n * max(x, y, 0.0)) ** 0.5 + max(_unit(a),
                                                                              _unit(b))
    if kind == "bound":
        return abs(x) <= rule[1] and abs(y) <= rule[1]
    if kind == "any":
        return True
    if kind == "time":
        return all(0 < v < float("inf") for v in (x, y))
    if kind in ("mse", "psnr"):
        if kind == "psnr":
            x, y = (255.0 ** 2 * 10.0 ** (-v / 10.0) for v in (x, y))
        e = rule[1]
        return abs(x - y) <= 2.0 * max(x, y, 0.0) ** 0.5 * e + e * e
    if kind == "above":
        return x >= rule[1] and y >= rule[1]
    if kind == "close":
        if len(rule) > 2:  # printed with rule[2] significant digits (%g)
            unit = max(10.0 ** (np.floor(np.log10(abs(v))) - rule[2] + 1) if v else 0.0
                       for v in (x, y))
        else:
            unit = max(_unit(a), _unit(b))
        return abs(x - y) <= rule[1] + unit
    return x == y or (np.isnan(x) and np.isnan(y))


def _excuse(name: str, la: str, lb: str):
    """The two lines with the parts :data:`EXCUSED` names taken out (or a
    dict literal replaced by its keys); unchanged where a pattern does
    not match both."""
    for pattern in EXCUSED.get(name, ()):
        ma, mb = re.search(pattern, la), re.search(pattern, lb)
        if not (ma and mb):
            continue
        group = "x" if "x" in ma.groupdict() else "d"
        if group == "x":
            sub_a = sub_b = "<excused>"
        else:
            try:
                sub_a, sub_b = (repr(list(ast.literal_eval(m.group("d"))))
                                for m in (ma, mb))
            except (ValueError, SyntaxError):
                continue
        la = la[:ma.start(group)] + sub_a + la[ma.end(group):]
        lb = lb[:mb.start(group)] + sub_b + lb[mb.end(group):]
    return la, lb


def line_differences(name: str, want: str, got: str, argv=None, kernels: bool = True):
    """What differs between two runs' printed output, line by line (the
    reference's package name stands for the port's); ``argv`` is the
    run's, and ``kernels`` says whether one side may run kernels
    (``similarity`` derives its tolerances from both)."""
    a, b = want.replace("libdwt_tpu", "libdwt_torch").splitlines(), got.splitlines()
    if len(a) != len(b):
        return [f"{name}: {len(a)} lines != {len(b)} lines"]
    rules = _rules(name, argv, kernels)
    bad = []
    for i, (la, lb) in enumerate(zip(a, b)):
        la, lb = _excuse(name, la, lb)
        words_a, words_b = ([re.sub(" +", " ", w) for w in NUMBER.split(x)]
                            for x in (la, lb))
        nums_a, nums_b = NUMBER.findall(la), NUMBER.findall(lb)
        if words_a != words_b or len(nums_a) != len(nums_b):
            bad.append(f"{name} line {i + 1}: {la!r} != {lb!r}")
            continue
        for k, (x, y) in enumerate(zip(nums_a, nums_b)):
            prefix = "".join(w + n for w, n in zip(words_a[:k], nums_a[:k])) + words_a[k]
            rule = _rule(rules, prefix)
            if not _number_ok(rule, x, y, prefix):
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
    (exactly where it names none); the text files of the programs in
    :data:`LINE_FILES` line by line under their rules; SVG figures by
    name alone."""
    fa, fb = _files(want_dir), _files(got_dir)
    if fa != fb:
        return [f"{name}: files {fa} != {fb}"]
    bad = []
    for rel in fa:
        pa, pb = os.path.join(want_dir, rel), os.path.join(got_dir, rel)
        if rel.endswith(".svg"):  # a figure: present on both sides is enough
            continue
        if name in LINE_FILES:
            with open(pa) as fa_, open(pb) as fb_:
                bad += [f"{rel}: {d}" for d in line_differences(name, fa_.read(), fb_.read())]
            continue
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
        want = (run_process if name in OWN_PROCESS else run)(path_of(name, port=False),
                                                              argv, want_dir)
    else:
        want = run(path_of(name), list(argv) + ["--device", "cpu"], want_dir)
    got = run(path_of(name), list(argv) + ["--device", device], got_dir)
    if want.code != got.code:
        return [f"{name}: exit code {got.code} != {want.code}\n{got.err}{want.err}"], want, got
    return (line_differences(name, want.out, got.out, argv, kernels=not reference)
            + file_differences(name, want_dir, got_dir)), want, got
