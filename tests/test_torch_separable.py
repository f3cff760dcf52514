"""Port vs reference: the lifting engine and the separable oracle.

The same numpy inputs (made from a seed) go through ``libdwt_tpu`` and
``libdwt_torch`` on the CPU.  Floats agree to 1e-5 (float64 to 1e-12),
int32 bit-exactly.  The port is also held to the compiled C library's
golden vectors the way tests/test_vs_reference.py holds the reference.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdwt_tpu.ops.lifting as jl
import libdwt_tpu.ops.separable as js
import libdwt_torch.ops.lifting as tl
import libdwt_torch.ops.separable as ts

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")
WAVELETS = ["cdf97", "cdf53", "interp53", "haar", "d4"]
INT_WAVELETS = ["cdf97", "cdf53", "haar"]


def _data(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "i":
        return rng.integers(-300, 300, size=shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _tol(dtype):
    return 1e-12 if dtype == np.float64 else 1e-5


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for s in t for x in _leaves(s)]
    return [t]


def _same(got, want, dtype):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if np.dtype(dtype).kind == "i":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=_tol(dtype), rtol=0)


# ------------------------------------------------------------------ lifting


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 8, 17])
@pytest.mark.parametrize("wavelet", WAVELETS)
def test_lift_fwd_inv_float_matches(n, wavelet):
    x = _data((3, n), np.float32, n)
    got = tl.lift_fwd(torch.from_numpy(x), wavelet)
    want = jl.lift_fwd(jnp.asarray(x), wavelet)
    _same(got, want, np.float32)
    for border in ("mirror", "hole", "zero"):
        _same(tl.lift_inv(got[0], got[1], wavelet, border=border),
              jl.lift_inv(want[0], want[1], wavelet, border=border), np.float32)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 8, 17])
@pytest.mark.parametrize("wavelet", INT_WAVELETS)
def test_lift_fwd_inv_int_matches(n, wavelet):
    x = _data((3, n), np.int32, n)
    got = tl.lift_fwd(torch.from_numpy(x), wavelet)
    want = jl.lift_fwd(jnp.asarray(x), wavelet)
    _same(got, want, np.int32)
    for border in ("mirror", "hole", "zero"):
        _same(tl.lift_inv(got[0], got[1], wavelet, border=border),
              jl.lift_inv(want[0], want[1], wavelet, border=border), np.int32)
    np.testing.assert_array_equal(tl.lift_inv(*got, wavelet).numpy(), x)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_lift_axis_split_merge(axis):
    x = _data((6, 7), np.float64)
    s, d = tl.split(torch.from_numpy(x), axis)
    js_, jd = jl.split(jnp.asarray(x), axis)
    _same((s, d), (js_, jd), np.float64)
    _same(tl.merge(s, d, axis), jl.merge(js_, jd, axis), np.float64)
    _same(tl.lift_fwd(torch.from_numpy(x), "cdf97", axis),
          jl.lift_fwd(jnp.asarray(x), "cdf97", axis), np.float64)


def test_lift_errors():
    with pytest.raises(ValueError, match="border"):
        tl.lift_inv(torch.zeros(2), torch.zeros(2), border="nope")
    with pytest.raises(ValueError, match="no reversible integer"):
        tl.lift_fwd(torch.zeros(4, dtype=torch.int32), "interp53")
    with pytest.raises(ValueError, match="signed"):
        tl.lift_fwd(torch.zeros(4, dtype=torch.uint8), "cdf53")


# ---------------------------------------------------------------- separable
#
# The reference runs under jax.jit: one compile per call instead of one
# per eager op and shape keeps these cases to about a second each.


def _jref(fn, *arrays, **static):
    return jax.jit(functools.partial(fn, **static))(*arrays)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_t(v) for v in tree)
    return torch.from_numpy(np.array(tree))


DTYPES = [np.float32, np.float64, np.int32]


@pytest.mark.parametrize("n", [7, 37])
@pytest.mark.parametrize("dtype", DTYPES)
def test_1d_pyramid_matches(n, dtype):
    x = _data((2, n), dtype)
    got = ts.wavedec1(torch.from_numpy(x), "cdf97", None)
    want = _jref(js.wavedec1, x, wavelet="cdf97", level=None)
    _same(got, want, dtype)
    _same(ts.waverec1(got, "cdf97"), _jref(js.waverec1, want, wavelet="cdf97"), dtype)
    packed = _jref(js.fdwt1, x, wavelet="cdf53", level=2)
    _same(ts.fdwt1(torch.from_numpy(x), "cdf53", 2), packed, dtype)
    _same(ts.idwt1_packed(_t(packed), "cdf53", 2),
          _jref(js.idwt1_packed, packed, wavelet="cdf53", level=2), dtype)


CASES_2D = [
    (16, 16, 3, np.float32, "cdf97"), (17, 13, 2, np.float32, "cdf97"),
    (33, 31, None, np.float32, "cdf97"), (33, 31, None, np.float64, "cdf97"),
    (17, 13, 2, np.float64, "cdf53"), (17, 13, 2, np.int32, "cdf97"),
    (33, 31, None, np.int32, "cdf53"), (16, 16, 3, np.int32, "cdf53"),
    (17, 13, 2, np.float32, "haar"), (17, 13, 2, np.int32, "haar"),
    (16, 16, 2, np.float32, "interp53"), (16, 16, 2, np.float32, "d4"),
    (8, 1, 2, np.float32, "cdf97"),
]


@pytest.mark.parametrize("h,w,j,dtype,wavelet", CASES_2D)
def test_2d_pyramid_matches(h, w, j, dtype, wavelet):
    x = _data((h, w), dtype, h * w)
    got = ts.wavedec2(torch.from_numpy(x), wavelet, j)
    want = _jref(js.wavedec2, x, wavelet=wavelet, level=j)
    _same(got, want, dtype)
    _same(ts.waverec2(got, wavelet), _jref(js.waverec2, want, wavelet=wavelet), dtype)
    packed = _jref(js.fdwt2, x, wavelet=wavelet, level=j)
    _same(ts.fdwt2(torch.from_numpy(x), wavelet, j), packed, dtype)
    _same(ts.idwt2(_t(packed), wavelet, j),
          _jref(js.idwt2, packed, wavelet=wavelet, level=j), dtype)


@pytest.mark.parametrize("border", ["hole", "zero"])
def test_2d_sparse_borders_match(border):
    x = _data((20, 18), np.float32)
    c = _jref(js.wavedec2, x, wavelet="cdf97", level=2)
    _same(ts.waverec2(_t(c), "cdf97", border=border),
          _jref(js.waverec2, c, wavelet="cdf97", border=border), np.float32)
    packed = _jref(js.fdwt2, x, wavelet="cdf97", level=2)
    _same(ts.idwt2(_t(packed), "cdf97", 2, border=border),
          _jref(js.idwt2, packed, wavelet="cdf97", level=2, border=border), np.float32)


@pytest.mark.parametrize("shape,j", [((8, 8, 8), 2), ((9, 6, 7), None)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_3d_pyramid_matches(shape, j, dtype):
    x = _data(shape, dtype)
    got = ts.wavedec3(torch.from_numpy(x), "cdf53", j)
    want = _jref(js.wavedec3, x, wavelet="cdf53", level=j)
    _same(got, want, dtype)
    _same(ts.waverec3(got, "cdf53"), _jref(js.waverec3, want, wavelet="cdf53"), dtype)
    packed = _jref(js.fdwt3, x, wavelet="cdf53", level=j)
    _same(ts.fdwt3(torch.from_numpy(x), "cdf53", j), packed, dtype)
    _same(ts.idwt3(_t(packed), "cdf53", j),
          _jref(js.idwt3, packed, wavelet="cdf53", level=j), dtype)


# ---------------------------------------------------- golden (C library)


@pytest.fixture(scope="module")
def g():
    if not os.path.exists(GOLDEN):
        pytest.skip("golden vectors not generated")
    return np.load(GOLDEN)


@pytest.mark.parametrize("n", [2, 3, 5, 8, 17, 37, 100])
@pytest.mark.parametrize("wavelet,prec,tol", [
    ("cdf97", "f32", 2e-5), ("cdf53", "f32", 2e-5), ("interp53", "f32", 2e-5),
    ("cdf97", "f64", 1e-12), ("cdf53", "f64", 1e-12)])
def test_golden_1d_forward(g, n, wavelet, prec, tol):
    key = f"{wavelet}_{prec}_{n}"
    lo, hi = ts.dwt1(torch.from_numpy(g[f"x_{prec}_{n}"][0]), wavelet)
    np.testing.assert_allclose(lo.numpy(), g[f"{key}_L"][0], atol=tol, rtol=0)
    np.testing.assert_allclose(hi.numpy(), g[f"{key}_H"][0], atol=tol, rtol=0)


@pytest.mark.parametrize("n", [2, 3, 5, 8, 17, 37, 100])
@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53"])
def test_golden_1d_int_bitexact(g, n, wavelet):
    lo, hi = ts.dwt1(torch.from_numpy(g[f"x_i32_{n}"][0]), wavelet)
    np.testing.assert_array_equal(lo.numpy(), g[f"{wavelet}_i32_{n}_L"][0])
    np.testing.assert_array_equal(hi.numpy(), g[f"{wavelet}_i32_{n}_H"][0])


@pytest.mark.parametrize("ny,nx,j", [(16, 16, 1), (16, 16, 3), (17, 13, 2), (32, 32, 5),
                                     (33, 31, 4), (64, 48, None)])
@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53"])
def test_golden_2d_forward(g, ny, nx, j, wavelet):
    key = f"{wavelet}_2f_f32_{ny}x{nx}_j{j if j is not None else -1}"
    if key not in g:
        pytest.skip("combo not dumped")
    got = ts.fdwt2(torch.from_numpy(g[f"img_f32_{ny}x{nx}"]), wavelet, j)
    np.testing.assert_allclose(got.numpy(), g[key], atol=5e-4, rtol=0)


@pytest.mark.parametrize("ny,nx,j", [(16, 16, 3), (17, 13, 2), (32, 32, 5)])
@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53"])
def test_golden_2d_int_bitexact(g, ny, nx, j, wavelet):
    got = ts.fdwt2(torch.from_numpy(g[f"img_i32_{ny}x{nx}"]), wavelet, j)
    np.testing.assert_array_equal(got.numpy(), g[f"{wavelet}_2f_i32_{ny}x{nx}_j{j}"])


@pytest.mark.parametrize("ny,nx,j", [(16, 16, 3), (32, 32, 5), (33, 31, 4)])
def test_golden_2d_inverse(g, ny, nx, j):
    got = ts.idwt2(torch.from_numpy(g[f"cdf97_2f_f32_{ny}x{nx}_j{j}"]), "cdf97", j)
    np.testing.assert_allclose(got.numpy(), g[f"cdf97_2i_f32_{ny}x{nx}_j{j}"], atol=5e-4, rtol=0)


@pytest.mark.parametrize("ny,nx,j", [(32, 32, 2), (64, 48, 3)])
@pytest.mark.parametrize("border", ["mirror", "hole", "zero"])
@pytest.mark.parametrize("subset", ["full", "llonly"])
def test_golden_sparse_inverse(g, ny, nx, j, border, subset):
    c = ts.wavedec2(torch.from_numpy(g[f"sparse_src_f32_{ny}x{nx}_j{j}"]), "cdf97", j)
    if subset == "llonly":
        c = [c[0]] + [tuple(torch.zeros_like(b) for b in lvl) for lvl in c[1:]]
    rec = ts.waverec2(c, "cdf97", border=border)
    np.testing.assert_allclose(rec.numpy(), g[f"sparse_{border}_{subset}_f32_{ny}x{nx}_j{j}"],
                               atol=5e-4, rtol=0)
