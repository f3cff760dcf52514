"""Port vs reference: the interleaved layout (``libdwt_torch.ops.interleaved``).

The same seeded numpy inputs go through ``libdwt_tpu.ops.interleaved``
(under ``jax.jit``, one compiled call per case) and the port on the CPU.
Bounds against the reference: int32 exact, float64 1e-10, float32 3e-5
for one level and 5e-4 for two or more.  Against the port's own packed
transform the conversion is exact in every dtype.  The cases follow
tests/test_interleaved.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdwt_tpu.ops.interleaved as ji
import libdwt_torch.ops.interleaved as ti
from libdwt_torch.ops.separable import fdwt2


def _data(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "i":
        return rng.integers(-300, 300, size=shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _close(got, want, tol):
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if tol == 0:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=tol, rtol=0)


# (wavelet, dtype, shape, level, bound)
CASES_2D = [
    ("cdf97", np.float32, (37, 41), 1, 3e-5),
    ("cdf97", np.float32, (64, 48), 3, 5e-4),
    ("cdf53", np.float64, (33, 31), 2, 1e-10),
    ("cdf97", np.float64, (2, 16, 24), 2, 1e-10),
    ("cdf53", np.int32, (32, 32), 2, 0),
    ("cdf53", np.int32, (33, 17), 3, 0),
]


@pytest.mark.parametrize("wavelet,dtype,shape,level,tol", CASES_2D)
def test_fdwt2_idwt2_interleaved_match_reference(wavelet, dtype, shape, level, tol):
    x = _data(shape, dtype, level)

    @jax.jit
    def ref(a):
        y = ji.fdwt2_interleaved(a, wavelet, level)
        p = ji.interleaved_to_packed2(y, level)
        return (y, ji.idwt2_interleaved(y, wavelet, level), p,
                ji.packed_to_interleaved2(p, level))

    want = ref(jnp.asarray(x))
    y = ti.fdwt2_interleaved(torch.from_numpy(x), wavelet, level)
    p = ti.interleaved_to_packed2(y, level)
    got = (y, ti.idwt2_interleaved(y, wavelet, level), p, ti.packed_to_interleaved2(p, level))
    _close(got, want, tol)
    if dtype == np.int32:
        np.testing.assert_array_equal(got[1].numpy(), x)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.int32, 0)])
def test_fdwt1_idwt1_interleaved_match_reference(dtype, tol):
    """n = 15 and 100 at level 1 and the full depth, a batch of rows along
    axis 0 and along the last axis, both wavelets."""
    cases = [(wv, n, lvl) for wv in ("cdf97", "cdf53") for n in (15, 100)
             for lvl in (1, None)]
    xs = [_data((n,), dtype, n) for _, n, _ in cases]
    xb = _data((6, 5), dtype, 1)

    @jax.jit
    def ref(arrays, b):
        out = []
        for (wv, _, lvl), a in zip(cases, arrays):
            y = ji.fdwt1_interleaved(a, wv, lvl)
            out.append((y, ji.idwt1_interleaved(y, wv, lvl)))
        for axis in (0, -1):
            y = ji.fdwt1_interleaved(b, "cdf53", 2, axis=axis)
            out.append((y, ji.idwt1_interleaved(y, "cdf53", 2, axis=axis)))
        return out

    want = ref([jnp.asarray(a) for a in xs], jnp.asarray(xb))
    got = []
    for (wv, _, lvl), a in zip(cases, xs):
        y = ti.fdwt1_interleaved(torch.from_numpy(a), wv, lvl)
        got.append((y, ti.idwt1_interleaved(y, wv, lvl)))
    for axis in (0, -1):
        y = ti.fdwt1_interleaved(torch.from_numpy(xb), "cdf53", 2, axis=axis)
        got.append((y, ti.idwt1_interleaved(y, "cdf53", 2, axis=axis)))
    for g, w, x in zip(got, want, xs + [xb, xb]):
        _close(g, w, tol)
        np.testing.assert_allclose(g[1].numpy(), x, atol=tol, rtol=0)


@pytest.mark.parametrize("shape", [(16, 16), (32, 24), (33, 31), (2, 19, 40)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_interleaved_to_packed_equals_packed_fdwt2(shape, dtype):
    """The interleaved transform and the conversion give the port's packed
    transform exactly (the same lifting arithmetic, only the layout
    differs), and the conversion back is exact."""
    for wavelet in ("cdf97", "cdf53"):
        for level in (1, 2, 3):
            x = torch.from_numpy(_data(shape, dtype, level))
            inter = ti.fdwt2_interleaved(x, wavelet, level)
            packed = ti.interleaved_to_packed2(inter, level)
            assert torch.equal(packed, fdwt2(x, wavelet, level))
            assert torch.equal(ti.packed_to_interleaved2(packed, level), inter)


def test_inputs_are_not_written():
    x = torch.from_numpy(_data((16, 20), np.float32))
    keep = x.clone()
    y = ti.fdwt2_interleaved(x, "cdf97", 2)
    ti.idwt2_interleaved(y, "cdf97", 2)
    p = ti.interleaved_to_packed2(y, 2)
    y_keep, p_keep = y.clone(), p.clone()
    ti.packed_to_interleaved2(p, 2)
    ti.idwt2_interleaved(y, "cdf97", 2)
    ti.fdwt1_interleaved(x, "cdf53", 2)
    assert torch.equal(x, keep) and torch.equal(y, y_keep) and torch.equal(p, p_keep)
    assert ti.fdwt2_interleaved(_data((8, 8), np.float32), device="cpu").device.type == "cpu"
