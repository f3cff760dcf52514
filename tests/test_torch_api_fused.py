"""Port vs reference, end to end: the single fused 2-D levels and the fused 3-D
volume path through the public API.

The port runs ``api.dwt2``/``idwt2``/``wavedec2`` and ``api.wavedec3``/
``waverec3`` with ``impl='fused'`` on CPU tensors (each kernel's plain
version); the JAX package runs the same calls, whose Pallas kernels run
in interpret mode off the TPU.  The kernels' call counts show which
kernels each call reached.
"""
import logging

import jax
import numpy as np
import pytest
import torch

import libdwt_tpu.api as japi
import libdwt_tpu.ops.separable as js
from libdwt_torch import api
from libdwt_torch.ops import UnsupportedGeometry
from libdwt_torch.ops import fused as tf
from libdwt_torch.ops import fused3d as t3
from libdwt_torch.ops import separable as ts_sep
from libdwt_torch.utils.log import get_logger


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for s in t for x in _leaves(s)]
    return [t]


def _close(got, want, atol):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _calls():
    return {k: s.calls for k, s in tf.KERNELS.items() if s.calls}


@pytest.fixture(autouse=True)
def _fresh():
    tf.reset_counters()
    yield
    api.set_impl("auto")


# ------------------------------------------------------------------ 2-D


@pytest.mark.parametrize("h,w", [(101, 97), (130, 260)])
def test_dwt2_idwt2_fused_match_reference(h, w):
    x = np.random.default_rng(h).random((h, w), dtype=np.float32)
    got = api.dwt2(torch.from_numpy(x), "cdf97", impl="fused")
    want = japi.dwt2(x, "cdf97", impl="fused")
    _close(got, want, 3e-5)
    rec = api.idwt2(*got, "cdf97", impl="fused")
    _close(rec, japi.idwt2(*want, "cdf97", impl="fused"), 3e-5)
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-4, rtol=0)
    assert _calls() == {"B1": 1, "B4": 1}


def test_wavedec2_odd_frame_runs_single_levels():
    x = np.random.default_rng(3).random((1025, 1031), dtype=np.float32)
    assert tf.fused_wavedec2_plan(1025, 1031, 3, 4, "cdf97") == [("level", 1), ("deep", 2)]
    got = api.wavedec2(torch.from_numpy(x), "cdf97", 3, impl="fused")
    assert _calls() == {"B1": 1, "B3": 1}
    _close(got, japi.wavedec2(x, "cdf97", 3, impl="fused"), 5e-5)
    _close(got, js.wavedec2(x, "cdf97", 3), 5e-4)


def test_batched_dwt2_idwt2_fused_loop_frames():
    x = np.random.default_rng(4).random((2, 3, 40, 36), dtype=np.float32)
    got = api.dwt2(torch.from_numpy(x), "cdf97", impl="fused")
    assert [tuple(b.shape) for b in got] == [(2, 3, 20, 18)] * 4
    assert _calls() == {"B1": 6}
    _close(got, japi.dwt2(x, "cdf97", impl="separable"), 3e-5)
    rec = api.idwt2(*got, "cdf97", impl="fused")
    assert tuple(rec.shape) == x.shape and _calls() == {"B1": 6, "B4": 6}
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-4, rtol=0)


# ------------------------------------------------------------------ 3-D


def test_wavedec3_waverec3_fused_match_reference():
    v = np.random.default_rng(5).random((16, 48, 64), dtype=np.float32)
    got = api.wavedec3(torch.from_numpy(v), "cdf97", 2, impl="fused")
    want = japi.wavedec3(v, "cdf97", 2, impl="fused")
    assert _calls() == {"B14": 2}
    _close(got, want, 3e-5)
    _close(got, js.wavedec3(v, "cdf97", 2), 5e-4)
    rec = api.waverec3(got, "cdf97", impl="fused")
    assert _calls() == {"B14": 2, "B15": 2}
    _close(rec, japi.waverec3(want, "cdf97", impl="fused"), 3e-5)
    np.testing.assert_allclose(rec.numpy(), v, atol=1e-3, rtol=0)


def test_coarser_level_the_kernel_cannot_take_runs_on_the_oracle():
    v = np.random.default_rng(6).random((16, 48, 66), dtype=np.float32)
    got = api.wavedec3(torch.from_numpy(v), "cdf97", 2, impl="fused")
    assert tuple(got[0].shape) == (4, 12, 17) and _calls() == {"B14": 1}
    _close(got, japi.wavedec3(v, "cdf97", 2, impl="fused"), 3e-5)
    rec = api.waverec3(got, "cdf97", impl="fused")
    assert _calls() == {"B14": 1, "B15": 1}
    np.testing.assert_allclose(rec.numpy(), v, atol=1e-3, rtol=0)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


def test_unsupported_geometry_falls_back_with_a_warning(monkeypatch):
    def decline(*a, **k):
        raise UnsupportedGeometry("declined for the test")

    monkeypatch.setattr(t3, "fused_dwt3_level", decline)
    monkeypatch.setattr(t3, "fused_idwt3_level", decline)
    handler = _Records()
    get_logger().addHandler(handler)
    try:
        v = torch.from_numpy(np.random.default_rng(7).random((16, 16, 16), dtype=np.float32))
        got = api.wavedec3(v, "cdf97", 2, impl="fused")
        rec = api.waverec3(got, "cdf97", impl="fused")
    finally:
        get_logger().removeHandler(handler)
    msgs = [r.getMessage() for r in handler.records]
    assert len(msgs) == 4 and all("declined for the test" in m for m in msgs)
    assert all(r.levelno == logging.WARNING for r in handler.records)
    _close(got, js.wavedec3(v.numpy(), "cdf97", 2), 1e-5)
    np.testing.assert_allclose(rec.numpy(), v.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("fn", ["fused_dwt3_level", "fused_idwt3_level"])
def test_other_kernel_errors_propagate(monkeypatch, fn):
    def broken(*a, **k):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(t3, fn, broken)
    v = torch.zeros(16, 16, 16)
    with pytest.raises(RuntimeError, match="kernel failed"):
        api.waverec3(api.wavedec3(v, "cdf97", 1, impl="fused"), "cdf97", impl="fused")


def test_3d_dispatch_rules():
    def pick(shape, wavelet="cdf97", impl=None, on_cuda=True, dtype=torch.float32):
        return api._pick_impl3(shape, wavelet, impl, on_cuda=on_cuda, dtype=dtype)

    assert pick((64, 512, 512)) == "fused"
    assert pick((64, 512, 512), dtype=torch.int32) == "fused"
    assert pick((64, 512, 512), on_cuda=False) == "separable"
    assert pick((64, 512, 512), dtype=torch.float64) == "fused"
    assert pick((64, 512, 512), dtype=torch.int16) == "separable"
    assert pick((64, 512, 512), impl="fused", dtype=torch.float64) == "fused"
    assert pick((63, 512, 512), impl="auto") == "separable"
    assert pick((4, 512, 512)) == "separable"
    assert pick((64, 512, 512), "d4") == "separable"
    with pytest.raises(ValueError, match="even dims > 4"):
        pick((63, 512, 512), impl="fused")
    # 'streamed' (B16/B17) is honoured where the reference's gate holds
    assert pick((64, 512, 512), impl="streamed") == "streamed"
    with pytest.raises(ValueError, match="2..32"):
        pick((63, 512, 512), impl="streamed")
    # an unknown per-call impl is 'auto', as in the reference
    assert pick((64, 512, 512), impl="nope") == pick((64, 512, 512)) == "fused"
    assert pick((64, 512, 512), impl="nope", on_cuda=False) == "separable"
    x = np.random.default_rng(13).random((64, 64), dtype=np.float32)
    _close(api.dwt2(torch.from_numpy(x), "cdf97", impl="nope"),
           japi.dwt2(x, "cdf97", impl="nope"), 1e-5)


def test_3d_explicit_impl_is_honoured_or_raises():
    with pytest.raises(ValueError, match="even dims"):
        api.wavedec3(torch.zeros(15, 16, 16), "cdf97", 1, impl="fused")
    with pytest.raises(ValueError, match="unbatched"):
        api.wavedec3(torch.zeros(2, 16, 16, 16), "cdf97", 1, impl="fused")
    # an unknown per-call impl is 'auto' (the reference's outcome), not an error
    v = np.random.default_rng(14).random((16, 16, 16), dtype=np.float32)
    got = api.wavedec3(torch.from_numpy(v), "cdf97", 1, impl="nope")
    _close(got, japi.wavedec3(v, "cdf97", 1, impl="nope"), 1e-5)
    np.testing.assert_allclose(api.waverec3(got, "cdf97", impl="nope").numpy(), v,
                               atol=1e-4, rtol=0)
    assert _calls() == {}
    api.set_impl("fused")
    with pytest.raises(ValueError, match="unbatched"):
        api.waverec3(api.wavedec3(torch.zeros(2, 16, 16, 16), "cdf97", 1,
                                  impl="separable"), "cdf97")
    with pytest.raises(ValueError, match="even dims"):  # finest level 4x16x16
        api.waverec3([torch.zeros(2, 8, 8)] + [{k: torch.zeros(2, 8, 8)
                                               for k in t3.BANDS if k != "LLL"}], "cdf97")
    # 'auto' on a CPU tensor stays on the oracle
    api.set_impl("auto")
    api.waverec3(api.wavedec3(torch.zeros(16, 16, 16), "cdf97", 2), "cdf97")
    assert _calls() == {}


@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53"])
def test_fused_waverec2_at_small_odd_deep_levels_matches_the_oracle(wavelet):
    """130x258 J=5: the reference's fused inverse raises there (its deep
    kernel reaches a small odd level); the port's deep inverse B6 takes all
    five levels and gives the separable reconstruction."""
    x = np.random.default_rng(15).random((130, 258), dtype=np.float32)
    coeffs, want = jax.jit(lambda a: (lambda c: (c, js.waverec2(c, wavelet)))(
        js.wavedec2(a, wavelet, 5)))(x)
    got = api.waverec2([torch.tensor(np.asarray(coeffs[0]))]
                       + [tuple(torch.tensor(np.asarray(b)) for b in lvl)
                          for lvl in coeffs[1:]], wavelet, impl="fused")
    assert _calls() == {"B6": 1}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), x, atol=1e-3, rtol=0)


@pytest.mark.parametrize("h,w,level", [(48, 50, 3), (33, 47, 1), (176, 198, 5), (64, 64, 3)])
def test_fused_haar_forward_at_odd_sizes_gives_the_oracle(h, w, level):
    """Haar through the fused pyramid gives the reference's fused
    coefficients, borders included, and the oracle's where every level's
    lengths are even; at an odd length the kernels' whole-point mirror
    departs from the oracle's one-sided rule in both packages (an open
    fault).  The fused inverse gives the oracle's inverse of the same
    coefficients at every size."""
    x = np.random.default_rng(h + w).standard_normal((h, w)).astype(np.float32)
    got = api.wavedec2(torch.from_numpy(x), "haar", level, impl="fused")
    _close(got, japi.wavedec2(x, "haar", level, impl="fused"), 1e-6)
    assert "B3" in _calls() or level == 1
    if h % (1 << level) == 0 and w % (1 << level) == 0:
        _close(got, ts_sep.wavedec2(torch.from_numpy(x), "haar", level), 1e-6)
    if level == 1:
        _close(api.dwt2(torch.from_numpy(x), "haar", impl="fused"),
               japi.dwt2(x, "haar", impl="fused"), 1e-6)
    _close([api.waverec2(got, "haar", impl="fused")], [ts_sep.waverec2(got, "haar")], 1e-6)
