"""Port vs reference, end to end: the streamed 2-D pyramid through
``streamed_wavedec2``/``streamed_waverec2``, and the streamed pyramid,
single levels and volume levels through the public API
(``impl='streamed'``).

The port runs on CPU tensors (each kernel's plain version); the JAX package
runs the same calls, its Pallas kernels in interpret mode off the TPU.
float32 is held to 3e-5 per output, integers exactly.  The kernels' call
counts show which kernels each call reached.
"""
import logging

import numpy as np
import pytest
import torch

import libdwt_tpu.api as japi
import libdwt_tpu.ops.separable as js
import libdwt_tpu.ops.streamed as jst
from libdwt_torch import api
from libdwt_torch.ops import UnsupportedGeometry
from libdwt_torch.ops import fused as tf
from libdwt_torch.ops import streamed as ts
from libdwt_torch.ops import streamed3d as ts3
from libdwt_torch.utils.log import get_logger


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for s in t for x in _leaves(s)]
    return [t]


def _close(got, want, atol=3e-5):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if np.issubdtype(a.dtype, np.integer):
            assert np.array_equal(a, b)
        else:
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
    japi.set_impl("auto")


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
    # then the reference's float32 gate of the banded body, which the
    # pyramids then run (B13 in B8 / B11, and in B12)
    assert pick(2144, 4096, "streamed-mxu") == "streamed-mxu"
    with pytest.raises(ValueError, match="float32 symmetric"):
        api._pick_impl(2144, 4096, "cdf97", "streamed-mxu", True, torch.int32, 2)
    with pytest.raises(ValueError):
        japi._pick_impl(2144, 4096, "cdf97", "streamed-mxu", np.int32, levels=2)
    x = torch.from_numpy(np.random.default_rng(3).random((256, 320), dtype=np.float32))
    for level, kid in ((2, "B8"), (4, "B11")):
        tf.reset_counters()
        got = api.wavedec2(x, "cdf97", level, impl="streamed-mxu")
        assert _calls() == {kid: 1, "B13": 1}
        assert len(got) == level + 1
    tf.reset_counters()
    rec = api.waverec2(got, "cdf97", impl="streamed-mxu")
    assert _calls() == {"B12": 1, "B13": 1}
    np.testing.assert_allclose(rec.numpy(), x.numpy(), atol=5e-4, rtol=0)


def test_single_streamed_levels_not_ported():
    """Formerly the refusal of single streamed levels; they are ported now
    (B7/B9), and explicit and global-default 'streamed' reach them."""
    x = torch.from_numpy(np.random.default_rng(12).random((256, 256), dtype=np.float32))
    b = api.dwt2(x, "cdf97", impl="streamed")
    rec = api.idwt2(*b, "cdf97", impl="streamed")
    assert _calls() == {"B7": 1, "B9": 1}
    np.testing.assert_allclose(rec.numpy(), x.numpy(), atol=5e-5, rtol=0)
    tf.reset_counters()
    api.set_impl("streamed")
    assert all(torch.equal(p, q) for p, q in zip(api.dwt2(x, "cdf97"), b))
    got = api.wavedec2(x, "cdf97", 2)  # the default reaches the pyramid too
    assert _calls() == {"B7": 1, "B8": 1} and len(got) == 3


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


# ------------------------------------------------- single levels and volumes


@pytest.mark.parametrize("dtype,wavelet", [(np.float32, "cdf97"), (np.int32, "cdf53")])
def test_streamed_single_levels_match_reference(dtype, wavelet):
    rng = np.random.default_rng(21)
    x = (rng.integers(-300, 300, (2, 288, 132)) if dtype == np.int32
         else rng.random((2, 288, 132))).astype(dtype)
    got = api.dwt2(torch.from_numpy(x), wavelet, impl="streamed")
    assert _calls() == {"B7": 2}  # a batch runs frame by frame
    want = japi.dwt2(x, wavelet, impl="streamed")
    _close(got, want)
    _close(got, js.dwt2_level(x, wavelet), 3e-5)
    rec = api.idwt2(*got, wavelet, impl="streamed")
    assert _calls() == {"B7": 2, "B9": 2}
    _close(rec, japi.idwt2(*want, wavelet, impl="streamed"))
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_streamed_mxu_default_on_single_levels_matches_reference(dtype):
    """A global 'streamed-mxu' default: float32 single levels run the
    streamed level (the banded body exists only for pyramids), int32 fails
    the reference's float32 gate with ValueError in both packages."""
    rng = np.random.default_rng(22)
    x = (rng.integers(-300, 300, (256, 128)) if dtype == np.int32
         else rng.random((256, 128))).astype(dtype)
    api.set_impl("streamed-mxu")
    japi.set_impl("streamed-mxu")
    if dtype == np.int32:
        for mod, arr in ((api, torch.from_numpy(x)), (japi, x)):
            with pytest.raises(ValueError, match="float32 symmetric"):
                mod.dwt2(arr, "cdf53")
        return
    got = api.dwt2(torch.from_numpy(x), "cdf97")
    want = japi.dwt2(x, "cdf97")
    _close(got, want)
    rec = api.idwt2(*got, "cdf97")
    _close(rec, japi.idwt2(*want, "cdf97"))
    assert _calls() == {"B7": 1, "B9": 1}
    with pytest.raises(ValueError, match="multi-level"):  # explicit: refused
        api.dwt2(torch.from_numpy(x), "cdf97", impl="streamed-mxu")


def test_streamed_volume_matches_reference():
    """J=3 on 16x64x64: levels 1-2 on the streamed kernels, level 3
    (4x16x16, a dim <= HZ) fails the gate and runs the oracle in both
    packages."""
    v = np.random.default_rng(23).random((16, 64, 64), dtype=np.float32)
    got = api.wavedec3(torch.from_numpy(v), "cdf97", 3, impl="streamed")
    assert _calls() == {"B16": 2}
    want = japi.wavedec3(v, "cdf97", 3, impl="streamed")
    _close(got, want)
    _close(got, js.wavedec3(v, "cdf97", 3), 3e-5)
    rec = api.waverec3(got, "cdf97", impl="streamed")
    assert _calls() == {"B16": 2, "B17": 2}
    _close(rec, japi.waverec3(want, "cdf97", impl="streamed"))
    np.testing.assert_allclose(rec.numpy(), v, atol=1e-5, rtol=0)


def test_streamed_volume_int32_and_default_match_reference():
    vi = np.random.default_rng(24).integers(-300, 300, (16, 32, 48)).astype(np.int32)
    api.set_impl("streamed")
    japi.set_impl("streamed")
    got = api.wavedec3(torch.from_numpy(vi), "cdf53", 2)
    want = japi.wavedec3(vi, "cdf53", 2)
    _close(got, want)
    rec = api.waverec3(got, "cdf53")
    assert np.array_equal(rec.numpy(), vi)
    assert _calls() == {"B16": 2, "B17": 2}
    with pytest.raises(ValueError, match="unbatched"):
        api.wavedec3(torch.zeros(2, 16, 32, 48), "cdf53", 1)


def test_streamed_float64_on_the_cpu_matches_reference():
    """float64 has no CUDA kernel, but a CPU tensor runs the plain versions
    on the kernels' tiles, whose shared-memory budget is the kernels'
    (float32/int32) and does not refuse a float64 volume."""
    rng = np.random.default_rng(26)
    x, v = rng.random((256, 128)), rng.random((16, 32, 32))
    got = api.dwt2(torch.from_numpy(x), "cdf97", impl="streamed")
    _close(got, japi.dwt2(x, "cdf97", impl="streamed"), 1e-12)
    c3 = api.wavedec3(torch.from_numpy(v), "cdf97", 2, impl="streamed")
    _close(c3, japi.wavedec3(v, "cdf97", 2, impl="streamed"), 1e-12)
    rec = api.waverec3(c3, "cdf97", impl="streamed")
    assert _calls() == {"B7": 1, "B16": 2, "B17": 2}
    np.testing.assert_allclose(rec.numpy(), v, atol=1e-12, rtol=0)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


def test_streamed_volume_unsupported_geometry_falls_back_with_a_warning(monkeypatch):
    def decline(*a, **k):
        raise UnsupportedGeometry("declined for the test")

    monkeypatch.setattr(ts3, "streamed_dwt3_level", decline)
    monkeypatch.setattr(ts3, "streamed_idwt3_level", decline)
    handler = _Records()
    get_logger().addHandler(handler)
    try:
        v = np.random.default_rng(25).random((16, 32, 32), dtype=np.float32)
        got = api.wavedec3(torch.from_numpy(v), "cdf97", 2, impl="streamed")
        rec = api.waverec3(got, "cdf97", impl="streamed")
    finally:
        get_logger().removeHandler(handler)
    msgs = [r.getMessage() for r in handler.records]
    assert len(msgs) == 4 and all("declined for the test" in m for m in msgs)
    assert all(r.levelno == logging.WARNING for r in handler.records)
    _close(got, js.wavedec3(v, "cdf97", 2), 1e-5)
    np.testing.assert_allclose(rec.numpy(), v, atol=1e-4, rtol=0)

    def broken(*a, **k):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(ts3, "streamed_dwt3_level", broken)
    with pytest.raises(RuntimeError, match="kernel failed"):
        api.wavedec3(torch.from_numpy(v), "cdf97", 1, impl="streamed")
