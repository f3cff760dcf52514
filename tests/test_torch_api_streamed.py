"""Port vs reference, end to end: the streamed 2-D pyramid through its
drivers and the public API (``impl='streamed'``).

The port runs on CPU tensors (each kernel's plain version); the JAX package
runs the same calls, its Pallas kernels in interpret mode off the TPU.
float32 is held to 3e-5 per output, integers exactly.  The kernels' call
counts show which kernels each call reached.
"""
import numpy as np
import pytest
import torch

import libdwt_tpu.api as japi
import libdwt_tpu.ops.separable as js
import libdwt_tpu.ops.streamed as jst
from libdwt_torch import api
from libdwt_torch.ops import fused as tf
from libdwt_torch.ops import streamed as ts


def _leaves(t):
    if isinstance(t, (list, tuple)):
        return [x for s in t for x in _leaves(s)]
    return [t]


def _close(got, want, atol=3e-5):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _t(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_t(s) for s in tree)
    return torch.from_numpy(np.array(tree))


def _calls():
    return {k: s.calls for k, s in tf.KERNELS.items() if s.calls}


@pytest.fixture(autouse=True)
def _fresh():
    tf.reset_counters()
    yield
    api.set_impl("auto")


@pytest.mark.parametrize("level,fwd,inv", [(4, {"B11": 1}, {"B12": 1}),
                                           (2, {"B8": 1}, {"B10": 1})])
def test_streamed_pyramid_matches_reference(level, fwd, inv):
    x = np.random.default_rng(level).random((256, 320), dtype=np.float32)
    got = api.wavedec2(torch.from_numpy(x), "cdf97", level, impl="streamed")
    assert _calls() == fwd
    want = japi.wavedec2(x, "cdf97", level, impl="streamed")
    _close(got, want)
    _close(got, js.wavedec2(x, "cdf97", level), 5e-5)
    tf.reset_counters()
    rec = api.waverec2(got, "cdf97", impl="streamed")
    assert _calls() == inv
    _close(rec, japi.waverec2(want, "cdf97", impl="streamed"))
    np.testing.assert_allclose(rec.numpy(), x, atol=5e-5, rtol=0)


def test_streamed_pyramid_with_a_fused_tail_matches_reference():
    # J=6 at 256x320: too many levels for the one-launch pair (LL6 is 4x5),
    # so B8 runs levels 1-2 and the fused driver the rest; the inverse's
    # one-launch attempt raises on the LL size and the level loop ends with B10
    x = np.random.default_rng(6).random((256, 320), dtype=np.float32)
    got = api.wavedec2(torch.from_numpy(x), "cdf97", 6, impl="streamed")
    assert _calls() == {"B8": 1}
    want = japi.wavedec2(x, "cdf97", 6, impl="streamed")
    _close(got, want)
    rec = api.waverec2(got, "cdf97", impl="streamed")
    assert _calls()["B10"] == 1 and "B12" not in _calls()
    _close(rec, japi.waverec2(want, "cdf97", impl="streamed"))
    np.testing.assert_allclose(rec.numpy(), x, atol=5e-5, rtol=0)


def test_deep_inverse_short_quarter_tail():
    # 1036 rows, J=3: 3 rows in the last quarter strip, inside the CFIX
    # margin (the reference's tyw_q bump)
    x = np.random.default_rng(11).random((1036, 128), dtype=np.float32)
    c = js.wavedec2(x, "cdf97", 3)
    want = jst.streamed_waverec2(c, "cdf97", interpret=True)
    rec = ts.streamed_waverec2(_t(c), "cdf97")
    assert _calls() == {"B12": 1}
    _close(rec, want)
    np.testing.assert_allclose(rec.numpy(), x, atol=5e-5, rtol=0)


def test_batched_streamed_pyramid_loops_frames():
    x = torch.from_numpy(np.random.default_rng(7).random((2, 256, 320), dtype=np.float32))
    got = api.wavedec2(x, "cdf97", 3, impl="streamed")
    rec = api.waverec2(got, "cdf97", impl="streamed")
    assert _calls() == {"B11": 2, "B12": 2}
    for i in range(2):
        one = ts.streamed_wavedec2(x[i], "cdf97", 3)
        assert all(torch.equal(a[i], b) for a, b in zip(_leaves(got), _leaves(one)))
        assert torch.equal(rec[i], ts.streamed_waverec2(one, "cdf97"))


def test_streamed_dispatch_rules():
    def pick(h, w, impl, levels=2, wavelet="cdf97", on_cuda=True):
        return api._pick_impl(h, w, wavelet, impl, on_cuda, torch.float32, levels)

    assert pick(2144, 4096, "streamed", 5) == "streamed"
    assert pick(2144, 4096, "streamed", 1) == "streamed"
    assert pick(2144, 4096, None) == "separable"  # 'auto' never streams
    assert pick(1024, 1024, "auto") == "fused"
    for bad in ((536, 1024), (2144, 4098), (64, 64)):  # 24-row tail, w % 4, 1 strip
        with pytest.raises(ValueError, match="streamed impl needs"):
            pick(*bad, "streamed")
        with pytest.raises(ValueError):
            japi._pick_impl(*bad, "cdf97", "streamed", np.float32, levels=2)
    with pytest.raises(ValueError, match="streamed impl needs"):
        pick(2144, 4096, "streamed", wavelet="d4")
    with pytest.raises(ValueError, match="streamed impl needs"):
        pick(64, 64, "streamed-mxu")  # the geometry check comes first
    with pytest.raises(NotImplementedError, match="B13"):
        pick(2144, 4096, "streamed-mxu")


def test_single_streamed_levels_not_ported():
    x = torch.zeros(256, 256)
    with pytest.raises(NotImplementedError, match="B7/B9"):
        api.dwt2(x, "cdf97", impl="streamed")
    with pytest.raises(NotImplementedError, match="B7/B9"):
        api.idwt2(x[:128, :128], x[:128, :128], x[:128, :128], x[:128, :128], "cdf97",
                  impl="streamed")
    api.set_impl("streamed")
    with pytest.raises(NotImplementedError, match="B7/B9"):
        api.dwt2(x, "cdf97")
    got = api.wavedec2(x, "cdf97", 2)  # the default reaches the pyramid
    assert _calls() == {"B8": 1} and len(got) == 3


def test_deep_fallback_catches_only_value_errors(monkeypatch):
    x = torch.from_numpy(np.random.default_rng(8).random((256, 320), dtype=np.float32))
    c = ts.streamed_wavedec2(x, "cdf97", 4)

    def declined(*a, **k):
        raise ValueError("declined for the test")

    monkeypatch.setattr(ts, "streamed_waverec2_deep", declined)
    tf.reset_counters()
    rec = api.waverec2(c, "cdf97", impl="streamed")
    assert _calls()["B10"] == 1
    np.testing.assert_allclose(rec.numpy(), x.numpy(), atol=5e-5, rtol=0)

    def broken(*a, **k):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(ts, "streamed_waverec2_deep", broken)
    with pytest.raises(RuntimeError, match="kernel failed"):
        api.waverec2(c, "cdf97", impl="streamed")
