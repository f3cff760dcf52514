"""The port's example programs (``examples_torch/``) held against the
reference programs (``examples/``) on the CPU: the programs that launch
kernels on the card (``cores``, ``accel_matrix``, ``denoise``) and the
round trips (``start``, ``simple``, ``info``).  The other twelve are in
``tests/test_torch_examples_demos.py``.

Each case runs the reference program and its port with ``--device cpu``
in this process (``examples_torch/_compare.py``: ``runpy`` with
``sys.argv`` patched and stdout captured), with the arguments of
``tests/test_examples.py``'s ``_CASES``, and holds the exit codes, the
printed lines (the same words, each number within the tolerance that
``_compare.TOLERANCES`` states for its program) and every file written
(PGM pixels within one level, numbers within ``FILE_TOLERANCE``).  On the
CPU the port's kernel wrappers run their plain versions.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples_torch import _compare as C  # noqa: E402

NAMES = ("accel_matrix", "cores", "denoise", "info", "simple", "start")
EXTRA = [
    ("cores", ["--size", "64", "--dump"]),  # the three PGMs
    ("denoise", ["--size", "64", "--levels", "2", "--mode", "hard"]),
    ("simple", ["--size", "64", "--levels", "3", "--dtype", "i32", "--wavelet", "cdf53"]),
]


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
    if "--dump" in argv:
        assert sorted(os.listdir(tmp_path / "got")) == ["source.pgm", "subbands.pgm",
                                                        "target.pgm"]
