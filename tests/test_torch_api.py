"""Port vs reference: the 2-D API, the whole slice, devices and interop.

The slice test runs the port's ``api.wavedec2`` / ``waverec2`` with
``impl='fused'`` on the CPU at 1024x2560, J=5, float32 — the bench
config's schedule (B2, then B3 on the 256x640 LL2; B6 for the three
coarse inverse levels, then B5) — and holds it to the JAX separable
pyramid (5e-4) and to the input on the round trip (1e-3).
"""
import functools

import jax
import numpy as np
import pytest
import torch

import libdwt_tpu
import libdwt_tpu.api as japi
import libdwt_tpu.ops.separable as js
import libdwt_torch
from libdwt_torch import api, interop
from libdwt_torch.ops import fused as tf
from libdwt_torch.utils import device as tdev


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


def _jit(fn, *arrays, **static):
    return jax.jit(functools.partial(fn, **static))(*arrays)


@pytest.fixture(autouse=True)
def _default_impl():
    yield
    api.set_impl("auto")


def test_slice_wavedec2_waverec2_fused_1024x2560():
    x = np.random.default_rng(2024).random((1024, 2560), dtype=np.float32)
    tf.reset_counters()
    coeffs = api.wavedec2(torch.from_numpy(x), "cdf97", 5, impl="fused")
    rec = api.waverec2(coeffs, "cdf97", impl="fused")
    assert {k: s.calls for k, s in tf.KERNELS.items() if s.calls} == {
        "B2": 1, "B3": 1, "B5": 1, "B6": 1}
    assert all(s.launches == 0 for s in tf.KERNELS.values())
    want = _jit(js.wavedec2, x, wavelet="cdf97", level=5)
    _close(coeffs, want, 5e-4)
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-3, rtol=0)
    np.testing.assert_allclose(rec.numpy(), np.asarray(_jit(js.waverec2, want, wavelet="cdf97")),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("call", [
    lambda m, x: m.wavedec2(x, "cdf97", 1, impl="fused"),
    lambda m, x: m.wavedec2(x[:, :1030], "cdf97", 3, impl="fused"),
    lambda m, x: m.dwt2(x, "cdf97", impl="fused"),
    lambda m, x: m.idwt2(*(x[:512, :512],) * 4, "cdf97", impl="fused"),
])
def test_fused_geometry_needing_b1_raises(call):
    """Geometries whose fused schedule needs a single fused level (B1 or
    B4): they run on the ported kernels and match the JAX package."""
    x = np.random.default_rng(11).random((1024, 1040), dtype=np.float32)
    tf.reset_counters()
    got = call(api, torch.from_numpy(x))
    assert tf.KERNELS["B1"].calls + tf.KERNELS["B4"].calls == 1
    want = call(_JaxApi("separable"), x)
    _close(got, want, 5e-5)


class _JaxApi:
    """The JAX API with the impl of each call replaced."""

    def __init__(self, impl):
        self.impl = impl

    def __getattr__(self, name):
        fn = getattr(japi, name)
        return lambda *a, **k: fn(*a, **{**k, "impl": self.impl})


def test_auto_never_routes_to_unported_kernels():
    x = torch.zeros(1024, 1024)

    def pick(h, w, wavelet="cdf97", impl=None, on_cuda=True, dtype=torch.float32):
        return api._pick_impl(h, w, wavelet, impl, on_cuda=on_cuda, dtype=dtype)

    assert pick(1024, 1024) == "fused"
    assert pick(1024, 1030, impl="auto") == "fused"
    assert pick(1024, 1030, dtype=torch.int32) == "fused"
    assert pick(2144, 4096) == "separable"
    assert pick(1024, 1024, on_cuda=False) == "separable"
    assert pick(1024, 1024, "d4", "auto") == "separable"
    # float64 has kernels too: 'auto' takes them as for float32
    assert pick(1024, 1030, dtype=torch.float64) == "fused"
    assert pick(1024, 1030, impl="fused", dtype=torch.float64) == "fused"
    assert pick(1024, 1030, dtype=torch.int16) == "separable"
    tf.reset_counters()
    api.dwt2(x, "cdf97")
    assert all(s.calls == 0 for s in tf.KERNELS.values())
    # an explicit 'streamed' is honoured; 'streamed-mxu' passes the
    # reference's float32 gate and runs the banded body (B13)
    assert pick(1024, 1024, impl="streamed") == "streamed"
    assert pick(1024, 1024, impl="streamed-mxu") == "streamed-mxu"
    with pytest.raises(ValueError, match="float32 symmetric"):
        pick(1024, 1024, impl="streamed-mxu", dtype=torch.int32)
    xr = np.random.default_rng(4).random((512, 512), dtype=np.float32)
    tf.reset_counters()
    got = api.wavedec2(torch.from_numpy(xr), "cdf97", 3, impl="streamed-mxu")
    assert {k: s.calls for k, s in tf.KERNELS.items() if s.calls} == {"B11": 1, "B13": 1}
    _close(got, js.wavedec2(xr, "cdf97", 3), 2e-4)


def test_numpy_input_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((64, 64), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.wavedec2(x, "cdf97", 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.pyramid_from_numpy([x])
    got = api.wavedec2(x, "cdf97", 2, device="cpu")
    assert got[0].device.type == "cpu"


def test_tensor_keeps_its_device():
    t = torch.zeros(8, 8)
    assert tdev.as_tensor(t) is t
    assert tdev.as_tensor(np.zeros(3), device="cpu").device.type == "cpu"


def test_impl_setting_and_errors():
    assert api.get_impl() == "auto"
    api.set_impl("separable")
    assert api.get_impl() == "separable"
    with pytest.raises(ValueError):
        api.set_impl("nope")
    # an unknown per-call impl falls through to 'auto', as in the reference
    xn = np.random.default_rng(12).random((64, 64), dtype=np.float32)
    _close(api.wavedec2(torch.from_numpy(xn), "cdf97", 2, impl="nope"),
           japi.wavedec2(xn, "cdf97", 2, impl="nope"), 1e-5)
    with pytest.raises(ValueError, match="multi-level"):
        api.dwt2(torch.zeros(64, 64), impl="streamed-mxu")
    with pytest.raises(ValueError, match="min"):
        api.wavedec2(torch.zeros(16, 16), "cdf97", 2, impl="fused")
    for impl in ("streamed", "streamed-mxu"):  # one 64-row strip: too short
        with pytest.raises(ValueError, match="streamed impl needs"):
            api.wavedec2(torch.zeros(64, 64), "cdf97", 2, impl=impl)
    # the reference's outcomes: one 64-row strip is too short for the
    # streamed level; an 8x8x8 volume is two reference tiles of 4 slabs,
    # so both packages run their streamed volume kernel (B16) on it
    with pytest.raises(ValueError, match="streamed impl needs"):
        api.dwt2(torch.zeros(64, 64), impl="streamed")
    with pytest.raises(ValueError):
        japi.dwt2(np.zeros((64, 64), np.float32), impl="streamed")
    v = np.random.default_rng(3).random((8, 8, 8), dtype=np.float32)
    tf.reset_counters()
    got = api.wavedec3(torch.from_numpy(v), impl="streamed")
    assert tf.KERNELS["B16"].calls == 1
    _close(got, japi.wavedec3(v, impl="streamed"), 3e-5)


@pytest.mark.parametrize("impl", [None, "separable"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_api_separable_matches_reference(impl, dtype):
    rng = np.random.default_rng(5)
    x = (rng.integers(-200, 200, (37, 41)) if dtype == np.int32
         else rng.standard_normal((37, 41))).astype(dtype)
    wv = "cdf53"
    got = api.wavedec2(torch.from_numpy(x), wv, 3, impl=impl)
    want = _jit(japi.wavedec2, x, wavelet=wv, level=3, impl="separable")
    _close(got, want, 1e-5)
    _close(api.waverec2(got, wv, impl=impl), _jit(japi.waverec2, want, wavelet=wv,
                                                  impl="separable"), 1e-5)
    _close(api.dwt2(torch.from_numpy(x), wv, impl=impl),
           _jit(japi.dwt2, x, wavelet=wv, impl="separable"), 1e-5)


@pytest.mark.parametrize("border", ["hole", "zero"])
def test_api_sparse_borders_match_reference(border):
    x = np.random.default_rng(6).standard_normal((24, 20)).astype(np.float32)
    c = _jit(japi.wavedec2, x, wavelet="cdf97", level=2, impl="separable")
    tc = interop.pyramid_from_numpy(
        [np.asarray(c[0])] + [tuple(np.asarray(b) for b in lvl) for lvl in c[1:]], device="cpu")
    _close(api.waverec2(tc, "cdf97", border=border),
           _jit(japi.waverec2, c, wavelet="cdf97", border=border), 1e-5)
    _close(api.idwt2(*[tc[0], *tc[1]], "cdf97", border=border),
           _jit(japi.idwt2, c[0], *c[1], wavelet="cdf97", border=border), 1e-5)


def test_batched_fused_matches_per_frame():
    x = np.random.default_rng(7).random((2, 1024, 1024), dtype=np.float32)
    got = api.wavedec2(torch.from_numpy(x), "cdf97", 3, impl="fused")
    assert tuple(got[0].shape) == (2, 128, 128)
    for i in range(2):
        one = api.wavedec2(torch.from_numpy(x[i]), "cdf97", 3, impl="fused")
        _close([got[0][i]] + [tuple(b[i] for b in lvl) for lvl in got[1:]],
               [a.numpy() for a in one[:1]] + [tuple(b.numpy() for b in lvl) for lvl in one[1:]],
               0)
    rec = api.waverec2(got, "cdf97", impl="fused")
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-3, rtol=0)


def test_3d_api_separable_matches_reference():
    x = np.random.default_rng(8).standard_normal((8, 10, 12)).astype(np.float32)
    got = api.wavedec3(torch.from_numpy(x), "cdf97", 2)
    want = _jit(js.wavedec3, x, wavelet="cdf97", level=2)
    _close(got, want, 1e-5)
    np.testing.assert_allclose(api.waverec3(got, "cdf97").numpy(), x, atol=1e-4, rtol=0)


def test_interop_pyramid_round_trip():
    x = np.random.default_rng(9).random((64, 96), dtype=np.float32)
    jc = _jit(js.wavedec2, x, wavelet="cdf97", level=3)
    tree = [np.asarray(jc[0])] + [tuple(np.asarray(b) for b in lvl) for lvl in jc[1:]]
    tc = interop.pyramid_from_numpy(tree, device="cpu")
    assert isinstance(tc, list) and isinstance(tc[1], tuple)
    np.testing.assert_allclose(api.waverec2(tc, "cdf97").numpy(), x, atol=1e-4, rtol=0)
    back = interop.pyramid_to_numpy(tc)
    for a, b in zip(_leaves(back), _leaves(tree)):
        np.testing.assert_array_equal(a, b)
    d = interop.pyramid_to_numpy(interop.pyramid_from_numpy({"a": [x]}, device="cpu"))
    np.testing.assert_array_equal(d["a"][0], x)


def test_top_level_names_mirror_reference():
    for name in ("wavedec2", "waverec2", "fdwt2", "idwt2", "dwt2_level", "idwt2_level",
                 "wavedec2_fast", "waverec2_fast", "dwt2_level_fast", "idwt2_level_fast",
                 "wavedec3_fast", "waverec3_fast", "set_impl", "get_impl", "band_rect",
                 "resolve_j", "REGISTRY", "fused_dwt2_level", "fused_idwt2_level"):
        assert hasattr(libdwt_tpu, name) and hasattr(libdwt_torch, name), name
