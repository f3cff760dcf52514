"""The example programs that launch kernels (``examples_torch/cores.py``,
``accel_matrix.py``, ``denoise.py``, ``similarity.py``) and
``sharded_demo.py`` at their default arguments on the card, and the perf
programs (``perf_sweep.py``, ``perf_plot.py``) at small arguments, each
held against the same program with ``--device cpu`` within the
tolerances of ``examples_torch/_compare.py`` (the perf programs' times
only positive and finite), and the kernels each launched counted.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports torch and the port only (no JAX):

    python -m pytest tests/test_torch_cuda_examples.py -m cuda --noconftest -o addopts= -q
"""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from examples_torch import _compare as C  # noqa: E402
from libdwt_torch import autotune  # noqa: E402
from libdwt_torch.ops import fused as F  # noqa: E402

#: similarity at 512, J=4 under the packaged table: the fused forward once
#: (at 512 the fused pyramid runs every level in B3's one deep launch),
#: the banded streamed inverse (B12 with B13) for each of the five
#: thresholds
SIMILARITY = {"B3": 1, "B12": 5, "B13": 5}
#: at the defaults: cores B1 once per fused wavelet; denoise the packaged
#: table's fused pyramid at 256, J=4 (B3 then B6); accel_matrix at 256,
#: J=3 two fused cells (B3/B6) and two streamed cells (B11/B12);
#: sharded_demo's separable shards none
LAUNCHES = {"cores": {"B1": 3}, "denoise": {"B3": 1, "B6": 1},
            "accel_matrix": {"B3": 2, "B6": 2, "B11": 2, "B12": 2},
            "similarity": SIMILARITY, "sharded_demo": {}}
#: the perf programs at small arguments: (argv, launches).  The separable
#: pyramid launches nothing; at 64 and 128 the fused pyramid is one deep
#: launch (B3 forward, B6 inverse): perf_sweep makes 6 calls a size (a
#: warm-up and 5 trials), perf_plot's chains run (1 + trials) x (2 + 4)
#: frames a candidate, the fused forward, and the separable forward then
#: the fused inverse
PERF_SWEEP_FUSED = {"B3": 12}
PERF_PLOT_FUSED = {"B3": 12, "B6": 12}
PERF = [
    ("perf_sweep", C.SMALL_ARGS["perf_sweep"], {}),
    ("perf_plot", C.SMALL_ARGS["perf_plot"], {}),
    ("perf_sweep", ["--sizes", "64,128", "--levels", "2", "--impl", "fused",
                    "--out", "perf.tsv"], PERF_SWEEP_FUSED),
    ("perf_plot", ["--sizes", "64", "--levels", "2", "--impls", "separable,fused",
                   "--dirs", "fwd,inv", "--trials", "1", "--chains", "2,4", "--out-dir", "out"],
     PERF_PLOT_FUSED),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_example_on_the_card_matches_the_cpu(name, cuda_device, tmp_path, monkeypatch):
    monkeypatch.setenv("LIBDWT_TORCH_TUNE_FILE",
                       os.path.join(ROOT, "libdwt_torch", "data", "autotune.json"))
    autotune.clear_cache()
    torch.cuda.synchronize()
    F.reset_counters()
    bad, want, got = C.run_pair(name, [], "cuda", tmp_path)
    torch.cuda.synchronize()
    autotune.clear_cache()
    assert want.code == 0 and got.code == 0, got.err + want.err
    assert got.out and not bad, "\n".join(bad)
    launches = {k: s.launches for k, s in F.KERNELS.items() if s.launches}
    assert launches == LAUNCHES[name], launches


@pytest.mark.cuda
@pytest.mark.parametrize("name,argv,want", PERF, ids=[" ".join([n] + a) for n, a, _ in PERF])
def test_perf_program_on_the_card_matches_the_cpu(name, argv, want, cuda_device, tmp_path):
    torch.cuda.synchronize()
    F.reset_counters()
    bad, want_run, got = C.run_pair(name, argv, "cuda", tmp_path)
    torch.cuda.synchronize()
    assert want_run.code == 0 and got.code == 0, got.err + want_run.err
    assert got.out and not bad, "\n".join(bad)
    assert "failed" not in got.err, got.err
    launches = {k: s.launches for k, s in F.KERNELS.items() if s.launches}
    assert launches == want, launches
