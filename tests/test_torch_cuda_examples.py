"""The example programs that launch kernels (``examples_torch/cores.py``,
``accel_matrix.py``, ``denoise.py``) at their default arguments on the
card, each held against the same program with ``--device cpu`` within
the tolerances of ``examples_torch/_compare.py``, and the kernels each
launched counted.

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

#: at the defaults: cores B1 once per fused wavelet; denoise the packaged
#: table's fused pyramid at 256, J=4 (B3 then B6); accel_matrix at 256,
#: J=3 two fused cells (B3/B6) and two streamed cells (B11/B12)
LAUNCHES = {"cores": {"B1": 3}, "denoise": {"B3": 1, "B6": 1},
            "accel_matrix": {"B3": 2, "B6": 2, "B11": 2, "B12": 2}}


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
    assert {k: s.launches for k, s in F.KERNELS.items() if s.launches} == LAUNCHES[name]
