"""The port's example programs (``examples_torch/``) held against the
reference programs (``examples/``) on the CPU: the twelve transform and
demo programs that ``tests/test_torch_examples.py`` leaves out, some
programs with other options (``accel_matrix`` at its default 256, J=3,
where the streamed cells run; the file options), and the comparison
itself (``_compare``) shown refusing what breaks a tolerance.

Each case runs the reference program and its port with ``--device cpu``
in this process, with the arguments of ``tests/test_examples.py``'s
``_CASES`` (files routed into the run's directory), and holds the exit
codes, the printed lines and every file written, within the tolerances
``examples_torch/_compare.py`` states for each program.
"""
import ast
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples_torch import _compare as C  # noqa: E402

NAMES = ("cdf97_test", "displ_vectors", "eaw_demo", "filter_coeffs", "function_iterating",
         "hdr_eaw", "mra", "nsls_demo", "simple_variants", "subbands", "wavelet_func",
         "wavelet_func2d")
EXTRA = [
    ("accel_matrix", ["--size", "256", "--levels", "3"]),  # its defaults: streamed cells run
    ("hdr_eaw", ["--size", "32", "--levels", "2", "--output", "out.exr"]),
    ("wavelet_func", ["--levels", "4", "--n", "128", "--kind", "wavelet", "--out", "out"]),
    ("function_iterating", ["--size", "256", "--band", "H"]),  # the TSV on stdout
    ("displ_vectors", ["--count", "8", "--levels", "2", "--out", "out"]),
    ("wavelet_func2d", ["--size", "64", "--band", "LL", "--wavelet", "cdf97",
                        "--out", "out"]),
    ("filter_coeffs", ["--wavelet", "cdf53"]),
]


def test_every_program_is_tested():
    """All 34 programs: these twelve, the six of ``test_torch_examples.py``,
    the ten of ``test_torch_examples_analysis.py`` and the six of
    ``test_torch_examples_tools.py``."""
    tested = NAMES + ("accel_matrix", "cores", "denoise", "info", "simple", "start")
    for other in ("test_torch_examples_analysis.py", "test_torch_examples_tools.py"):
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), other)) as f:
            src = f.read()
        start = src.index("NAMES = ") + len("NAMES = ")
        tested += ast.literal_eval(src[start:src.index(")", start) + 1])
    assert sorted(tested) == sorted(C.PROGRAMS) and len(C.PROGRAMS) == 34


@pytest.mark.parametrize("name", NAMES)
def test_port_matches_the_reference_program(name, tmp_path):
    bad, want, got = C.run_pair(name, C.SMALL_ARGS[name], "cpu", tmp_path, reference=True)
    assert got.code == 0, got.err
    assert got.out and not bad, "\n".join(bad)


@pytest.mark.parametrize("name,argv", EXTRA, ids=[" ".join([n] + a) for n, a in EXTRA])
def test_port_matches_the_reference_program_with_options(name, argv, tmp_path):
    bad, want, got = C.run_pair(name, argv, "cpu", tmp_path, reference=True)
    assert got.code == 0, got.err
    assert got.out and not bad, "\n".join(bad)
    if "out" in argv or "out.exr" in argv:
        assert os.listdir(tmp_path / "got")


@pytest.mark.parametrize("name,want,got,ok", [
    ("subbands", "  HL1: 32x32 energy 0.1", "  HL1: 32x32 energy 0.3", False),
    ("subbands", "  HL1: 32x32 energy 0.1", "  HL1: 32x32 energy 0.2", True),  # a unit
    ("subbands", "  HL1: 32x32 energy 0.1", "  HL1: 32x32 energy 0.1", True),
    ("subbands", "  HL1: 32x32 energy 0.1", "  HL1: 32x16 energy 0.1", False),
    ("subbands", "HH1 removed: max deviation 0.014", "HH1 removed: max deviation 0.016",
     True),  # 1e-3 and a unit of the last digit
    ("subbands", "HH1 removed: max deviation 0.014", "HH1 removed: max deviation 0.017",
     False),
    ("start", "round-trip max abs err = 3.70e-06", "round-trip max abs err = 9.00e-04", True),
    ("start", "round-trip max abs err = 3.70e-06", "round-trip max abs err = 1.10e-03", False),
    ("simple_variants", "float32  cdf97  J=2: max|err|=1.3e-06 psnr=129.8 dB",
     "float32  cdf97  J=2: max|err|=1.3e-06 psnr=99.0 dB", False),
    ("accel_matrix", "fused      float32  cdf97  packed       ok",
     "fused      float32  cdf97  packed       FAIL (tolerance)", False),
    ("info", "libdwt_tpu 0.1.0", "libdwt_torch 0.1.0", True),
    ("filter_coeffs", "  h[+0] = +0.852698803", "  h[+0] = +0.852738803", False),
    ("cores", "fix16      cdf53   mse=4.065e-07  pass", "fix16      cdf53   mse=4.066e-07  pass",
     False),
    ("simple", "a\nb", "a", False),
])
def test_line_comparison_refuses_what_breaks_a_tolerance(name, want, got, ok):
    assert (not C.line_differences(name, want, got)) is ok


def test_file_comparison_refuses_what_breaks_a_tolerance(tmp_path):
    """PGM pixels within one level, MAT numbers within cdf97_test's 5e-4
    (and the unit of the last digit printed), the same file names."""
    from libdwt_torch.utils.io import save_mat, save_pgm

    a = np.linspace(0, 0.9, 64, dtype=np.float32).reshape(8, 8)
    for side, levels, shift in (("want", 0, 0.0), ("near", 1, 4e-4), ("far", 2.5, 7e-4)):
        os.makedirs(tmp_path / side)
        save_pgm(str(tmp_path / side / "f.pgm"), a + levels / 255)
        save_mat(str(tmp_path / side / "f.mat"), a + shift)
    want = str(tmp_path / "want")
    assert C.file_differences("cdf97_test", want, str(tmp_path / "near")) == []
    far = C.file_differences("cdf97_test", want, str(tmp_path / "far"))
    assert len(far) == 2 and "f.mat" in far[0] and "f.pgm" in far[1]
    os.remove(tmp_path / "near" / "f.mat")
    assert C.file_differences("cdf97_test", want, str(tmp_path / "near"))
