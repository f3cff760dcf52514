"""The port's CUDA kernels on the card, each held against its plain version.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports torch, numpy and the port only (no JAX), so it also runs on a
GPU machine that has no JAX installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts= -q

Inputs come from a numpy seed.  float32 is held to 3e-5 (the kernels and
their plain versions round the same way, so they usually agree exactly),
int32 bit-exactly.  The shapes cover several tiles with short last tiles,
odd deep-tail sizes, every wavelet ``fused_supported`` accepts and a tile
whose shared memory exceeds the 48 KB default.
"""
import numpy as np
import pytest
import torch

from libdwt_torch import api
from libdwt_torch.ops import fused as tf
from libdwt_torch.ops import separable as sep


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _leaves(t):
    if isinstance(t, (list, tuple)):
        return [x for s in t for x in _leaves(s)]
    return [t]


def _close(got, want, exact):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype and a.is_cuda
        if exact:
            assert torch.equal(a, b)
        else:
            assert float((a - b).abs().max()) <= 3e-5


def _img(h, w, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        a = rng.integers(-255, 256, (h, w)).astype(np.int32)
    else:
        a = rng.standard_normal((h, w)).astype(np.float32)
    return torch.from_numpy(a).to(device)


TWO_LEVEL = [
    (1056, 544, torch.float32, "cdf97", 64),
    (96, 96, torch.float32, "cdf97", 32),
    (320, 132, torch.float32, "cdf97", 64),
    (256, 384, torch.float32, "cdf97", 128),  # 113 KB of shared memory
    (128, 128, torch.float32, "cdf53", 32),
    (96, 96, torch.float32, "interp53", 32),
    (128, 128, torch.float32, "haar", 64),
    (1056, 544, torch.int32, "cdf53", 64),
    (320, 132, torch.int32, "cdf97", 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,dtype,wavelet,tile", TWO_LEVEL)
def test_b2_b5_kernels_match_plain(cuda_device, h, w, dtype, wavelet, tile):
    x = _img(h, w, dtype, cuda_device)
    exact = dtype == torch.int32
    tf.reset_counters()
    c2 = tf.fused_dwt2_2level(x, wavelet, tile=tile)
    _close(list(c2), list(tf.fused_dwt2_2level_plain(x, wavelet, tile)), exact)
    rec = tf.fused_idwt2_2level(*c2, wavelet, tile=tile)
    _close(rec, tf.fused_idwt2_2level_plain(*c2, wavelet, tile), exact)
    torch.cuda.synchronize()
    assert (tf.KERNELS["B2"].launches, tf.KERNELS["B5"].launches) == (1, 1)
    if exact:
        assert torch.equal(rec, x)
        _close(list(c2), sep.wavedec2(x, wavelet, 2), True)


DEEP = [
    (536, 1024, 3, torch.float32, "cdf97", 32),
    (67, 129, 3, torch.float32, "cdf97", 8),
    (67, 129, 3, torch.float32, "cdf97", 32),
    (131, 97, 4, torch.float32, "cdf53", 16),
    (128, 96, 3, torch.float32, "haar", 16),
    (64, 96, 3, torch.int32, "cdf53", 8),
    (67, 129, 3, torch.int32, "cdf97", 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,levels,dtype,wavelet,tile", DEEP)
def test_b3_b6_kernels_match_plain(cuda_device, h, w, levels, dtype, wavelet, tile):
    x = _img(h, w, dtype, cuda_device, seed=1)
    exact = dtype == torch.int32
    tf.reset_counters()
    d = tf.fused_deep_wavedec2(x, wavelet, levels, tile=tile)
    _close(d, tf.fused_deep_wavedec2_plain(x, wavelet, levels, tile), exact)
    rec = tf.fused_deep_waverec2(d, wavelet, tile=tile)
    _close(rec, tf.fused_deep_waverec2_plain(d, wavelet, tile), exact)
    torch.cuda.synchronize()
    assert (tf.KERNELS["B3"].launches, tf.KERNELS["B6"].launches) == (levels, levels)
    if exact:
        _close(d, sep.wavedec2(x, wavelet, levels), True)
        assert torch.equal(rec, x)


@pytest.mark.cuda
def test_fused_pyramid_on_card_matches_oracle(cuda_device):
    x = _img(1024, 2560, torch.float32, cuda_device, seed=2)
    tf.reset_counters()
    coeffs = api.wavedec2(x, "cdf97", 5, impl="fused")
    rec = api.waverec2(coeffs, "cdf97", impl="fused")
    torch.cuda.synchronize()
    assert {k: s.launches for k, s in tf.KERNELS.items()} == {
        "B2": 1, "B3": 3, "B5": 1, "B6": 3}
    for a, b in zip(_leaves(coeffs), _leaves(sep.wavedec2(x, "cdf97", 5))):
        assert a.shape == b.shape and float((a - b).abs().max()) <= 5e-4
    assert float((rec - x).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_float64_on_card_raises(cuda_device):
    x = torch.zeros(128, 128, dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError, match="float64"):
        tf.fused_dwt2_2level(x)
    with pytest.raises(TypeError, match="float64"):
        tf.fused_deep_wavedec2(x, "cdf97", 2)
