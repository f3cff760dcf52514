"""The port's interop, perf and sharded example programs
(``examples_torch/``) held against the reference programs (``examples/``)
on the CPU: ``interop_flags``, ``interop_subbands``, ``perf_line``,
``perf_sweep``, ``perf_plot`` and ``sharded_demo``, some with other
options (``interop_flags --torch``, ``perf_sweep --impl fused``,
``interop_subbands`` at its default size), and the rules ``_compare``
adds for them shown refusing what they must refuse.

Each case runs the reference program and its port with ``--device cpu``,
with the arguments of ``tests/test_examples.py``'s ``_CASES`` (every
output path routed into the run's directory).  The reference's
``perf_plot`` and ``sharded_demo`` change their interpreter's JAX settings
(the compilation cache, the count of virtual devices), so they run in a
process of their own (``_compare.OWN_PROCESS``); everything else runs in
this process.  The perf programs' times are held only to be positive and
finite; every other number on their lines and in their files (sizes,
pixel counts) exactly.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples_torch import _compare as C  # noqa: E402

NAMES = ("interop_flags", "interop_subbands", "perf_line", "perf_plot", "perf_sweep",
         "sharded_demo")
EXTRA = [
    ("interop_flags", ["--size", "48", "--levels", "2", "--torch"]),
    ("interop_subbands", ["--out", "."]),  # its default size, 200 -> 256
    ("perf_sweep", ["--sizes", "64,128", "--levels", "2", "--impl", "fused",
                    "--out", "perf.tsv"]),
]


@pytest.mark.parametrize("name", NAMES)
def test_port_matches_the_reference_program(name, tmp_path):
    bad, want, got = C.run_pair(name, C.SMALL_ARGS[name], "cpu", tmp_path, reference=True)
    assert got.code == 0, got.err
    assert got.out and not bad, "\n".join(bad)
    if name.startswith("perf_"):
        assert os.listdir(tmp_path / "got")


@pytest.mark.parametrize("name,argv", EXTRA, ids=[" ".join([n] + a) for n, a in EXTRA])
def test_port_matches_the_reference_program_with_options(name, argv, tmp_path):
    bad, want, got = C.run_pair(name, argv, "cpu", tmp_path, reference=True)
    assert got.code == 0, got.err
    assert got.out and not bad, "\n".join(bad)


SYSTEM_A = "system: {'platform': 'cpu', 'device_kind': 'cpu', 'device_count': 8}"


@pytest.mark.parametrize("name,want,got,ok", [
    # times: positive and finite on both sides, not compared
    ("perf_sweep", "     32^2:    56.73 ns/pixel       17.6 Mpix/s",
     "     32^2:   684.99 ns/pixel        1.5 Mpix/s", True),
    ("perf_sweep", "     32^2:    56.73 ns/pixel       17.6 Mpix/s",
     "     64^2:    56.73 ns/pixel       17.6 Mpix/s", False),  # the size exactly
    ("perf_sweep", "     32^2:    56.73 ns/pixel       17.6 Mpix/s",
     "     32^2:     0.00 ns/pixel        inf Mpix/s", False),
    ("perf_sweep", "     32^2:    56.73 ns/pixel       17.6 Mpix/s",
     "     32^2:      nan ns/pixel       17.6 Mpix/s", False),
    ("perf_line", "  n=    256:   106.11 ns/sample       9.4 Msamples/s",
     "  n=    256:    -1.00 ns/sample       9.4 Msamples/s", False),
    ("perf_line", "256\t1.28e-07\t7.77", "256\t3.1e-08\t32.2", True),  # a TSV row
    ("perf_line", "256\t1.28e-07\t7.77", "1024\t1.28e-07\t7.77", False),
    # the estimator: one of the two names; the impl and direction exactly
    ("perf_plot", "fwd  separable        64x64       2.485 ns/pixel (slope)",
     "fwd  separable        64x64     299.155 ns/pixel (upper)", True),
    ("perf_plot", "fwd  separable        64x64       2.485 ns/pixel (slope)",
     "fwd  separable        64x64       2.485 ns/pixel (guess)", False),
    ("perf_plot", "fwd  separable        64x64       2.485 ns/pixel (slope)",
     "fwd  fused            64x64       2.485 ns/pixel (slope)", False),
    ("perf_plot", "fwd\tseparable\t4096\t2.48e-09\tslope",
     "fwd\tseparable\t4096\t2.99e-07\tupper", True),
    ("perf_plot", "fwd\tseparable\t4096\t2.48e-09\tslope",
     "fwd\tseparable\t4097\t2.48e-09\tslope", False),  # the pixel count exactly
    ("perf_plot", "# cpu: secs/pixel, cdf97 J=2",
     "# NVIDIA H100 80GB HBM3: secs/pixel, cdf97 J=2", True),
    ("perf_plot", "# cpu: secs/pixel, cdf97 J=2", "# cpu: secs/pixel, cdf97 J=3", False),
    # info(): the keys exactly, the values excused
    ("perf_sweep", SYSTEM_A,
     "system: {'platform': 'gpu', 'device_kind': 'NVIDIA H100 80GB HBM3', 'device_count': 1}",
     True),
    ("perf_sweep", SYSTEM_A, "system: {'platform': 'cpu', 'device_kind': 'cpu'}", False),
    # load: the device and the node lines, and only those
    ("load", "running on cpu:cpu", "running on gpu:NVIDIA H100 80GB HBM3", True),
    ("load", "node a", "node b", True),
    ("load", "library version 0.1.0", "library version 0.1.1", False),
    ("load", "cdf53 J=9 round trip: max abs err = 0.00e+00 -> OK",
     "cdf53 J=9 round trip: max abs err = 1.00e+00 -> FAIL", False),
    # a band's energy: each of its n coefficients within 5e-4
    ("interop_subbands", "  LL3: 32x32x3 energy=110182.453",
     "  LL3: 32x32x3 energy=110182.461", True),
    ("interop_subbands", "  LL3: 32x32x3 energy=110182.453",
     "  LL3: 32x32x3 energy=110202.453", False),  # 2 d sqrt(n E) = 18.4
    ("interop_subbands", "  LL3: 32x32x3 energy=110182.453",
     "  LL3: 32x32x1 energy=110182.453", False),
    ("interop_flags", "LL2 (16, 16) energy=63.3  HH1 (32, 32) energy=0.001",
     "LL2 (16, 16) energy=63.4  HH1 (32, 32) energy=0.003", True),
    ("interop_flags", "LL2 (16, 16) energy=63.3  HH1 (32, 32) energy=0.001",
     "LL2 (16, 16) energy=63.3  HH1 (32, 32) energy=0.008", False),
])
def test_the_new_rules_refuse_what_they_must(name, want, got, ok):
    assert (not C.line_differences(name, want, got)) is ok


@pytest.mark.parametrize("got,ok", [
    ("1\t0.3\t0.001905\t75.33\t1\t0.01294", True),
    ("1\t0.4\t0.001905\t75.33\t1\t0.01294", True),  # one unit of the last digit
    ("1\t0.6\t0.001905\t75.33\t1\t0.01294", False),  # more than can cross thr=1
    ("1\t0.3\t0.2\t75.33\t1\t0.01294", True),  # MSE within 2 sqrt(MSE) er + er^2
    ("1\t0.3\t0.5\t75.33\t1\t0.01294", False),
    ("1\t0.3\t0.001905\t56\t1\t0.01294", True),  # the same MSE bound on the PSNR
    ("1\t0.3\t0.001905\t45\t1\t0.01294", False),
    ("1\t0.3\t0.001905\t75.33\t0.9992\t0.01294", True),  # MSSIM within 1e-3
    ("1\t0.3\t0.001905\t75.33\t0.998\t0.01294", False),  # ("1" is 4 digits' 1.000)
    ("1\t0.3\t0.001905\t75.33\t1\t0.26", True),  # MAE within er = 0.255
    ("1\t0.3\t0.001905\t75.33\t1\t0.3", False),
    ("2\t0.3\t0.001905\t75.33\t1\t0.01294", False),  # the threshold exactly
])
def test_similarity_tolerances_are_the_scaled_bounds(got, ok):
    """``similarity``'s rules at its default 512, J=4: kept[%] at thr=1
    within the share of coefficients that lie within 255 * 5e-4 of 1
    (under 0.1 points here, so one printed unit), the metrics within
    255 * 1e-3 per pixel."""
    want = "1\t0.3\t0.001905\t75.33\t1\t0.01294"
    assert (not C.line_differences("similarity", want, got, [])) is ok


@pytest.mark.parametrize("got,ok", [
    ("1\t0.3\t0.001905\t75.33\t1\t0.01294", True),
    ("1\t0.3\t0.001906\t75.33\t1\t0.01294", True),  # 2 sqrt(MSE) 1e-3 + 1e-6
    ("1\t0.3\t0.002\t75.33\t1\t0.01294", False),
    ("1\t0.3\t0.001905\t75.33\t1\t0.0139", True),  # MAE within 1e-3
    ("1\t0.3\t0.001905\t75.33\t1\t0.0145", False),
])
def test_similarity_tolerances_between_two_oracles_are_the_bounds(got, ok):
    """The reference program and the port on the CPU both run the
    separable oracle: their tables are held to the bounds unscaled."""
    want = "1\t0.3\t0.001905\t75.33\t1\t0.01294"
    assert (not C.line_differences("similarity", want, got, [], kernels=False)) is ok
