"""The port's analysis and I/O example programs (``examples_torch/``) held
against the reference programs (``examples/``) on the CPU: the 1-D
spectra pipelines (``spectra_fe``, ``spectra_swt``, ``spectra_dwt``,
``spectra_svm``), the Gabor programs (``timefreq``, ``spectra_tf``,
``spectra_blobs``), ``similarity``, ``io_roundtrip`` and ``load``, and
some of them with other options (``load`` on a real PGM file through the
integer CDF 5/3 path, ``similarity`` as a LaTeX table, ``spectra_tf``'s
MAT dump).

Each case runs the reference program and its port with ``--device cpu``
in this process (``examples_torch/_compare.py``), with the arguments of
``tests/test_examples.py``'s ``_CASES`` (every output path routed into
the run's directory), and holds the exit codes, the printed lines and
every file written within the tolerances ``_compare`` states for each
program: counts, indices and integers exactly.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples_torch import _compare as C  # noqa: E402

NAMES = ("io_roundtrip", "load", "similarity", "spectra_blobs", "spectra_dwt", "spectra_fe",
         "spectra_svm", "spectra_swt", "spectra_tf", "timefreq")
EXTRA = [
    ("similarity", ["--size", "64", "--levels", "2", "--tex"]),
    ("spectra_tf", ["--size", "128", "--bins", "16", "--signal", "2", "--out", "st.mat"]),
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


def test_load_reads_a_real_pgm_through_the_integer_path(tmp_path):
    """``load --dtype i32`` on a PGM file (not its synthetic fallback): the
    same 8-bit image read, transformed by the integer CDF 5/3, written and
    round-tripped exactly by both programs."""
    from libdwt_torch.utils.io import save_pgm

    img = np.random.RandomState(3).rand(48, 40).astype(np.float32)
    for side in ("want", "got"):
        os.makedirs(tmp_path / side)
        save_pgm(str(tmp_path / side / "in.pgm"), img)
    bad, want, got = C.run_pair("load", ["in.pgm", "--dtype", "i32"], "cpu", tmp_path,
                                reference=True)
    assert got.code == 0, got.err
    assert got.out.startswith("loaded in.pgm") and "-> OK" in got.out and not bad, \
        "\n".join(bad)
