"""Port vs reference: the vector/image helpers (``libdwt_torch.utils.vecops``).

The same seeded numpy inputs go through ``libdwt_tpu.utils.vecops`` and
the port on the CPU.  Bounds: selections, shifts, crops and centering
exact; the float32 rescales and norms 1e-6 relative (the reductions may
sum in another order).  The cases follow tests/test_vecops.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdwt_tpu.utils.vecops as jv
import libdwt_torch.utils.vecops as tv


def _data(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _same(got, want, rtol=0.0):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        if rtol:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", [(7,), (4, 32), (2, 3, 6)])
def test_elementwise_and_rescales_match_reference(shape):
    x, y = _data(shape), _data(shape, 1)
    tx, ty, jx, jy = torch.from_numpy(x), torch.from_numpy(y), jnp.asarray(x), jnp.asarray(y)
    _same(tv.vec_abs(tx), jv.vec_abs(jx))
    _same(tv.add(tx, ty), jv.add(jx, jy))
    _same(tv.mul(tx, ty), jv.mul(jx, jy))
    _same(tv.shift(tx, 1.5), jv.shift(jx, 1.5))
    _same(tv.find_min_max(tx), jv.find_min_max(jx))
    _same(tv.dot(tx, ty), jv.dot(jx, jy), 1e-6)
    _same(tv.scale(tx, -1.0, 2.0), jv.scale(jx, -1.0, 2.0), 1e-6)
    _same(tv.scale21(tx), jv.scale21(jx), 1e-6)
    _same(tv.shift21_med(tx), jv.shift21_med(jx))
    for p in (0.5, 2.0, float("inf")):
        _same(tv.normalize(tx, p), jv.normalize(jx, p), 1e-6)


def test_constant_rows_and_reference_examples():
    x = torch.tensor([[0.0, 2.0], [10.0, 30.0], [5.0, 5.0]])
    _same(tv.scale21(x, 0, 1), jv.scale21(jnp.asarray(x.numpy()), 0, 1))
    med = tv.shift21_med(torch.tensor([[1.0, 2.0, 5.0], [10.0, 10.0, 10.0]]))
    np.testing.assert_array_equal(med.numpy(), [[-1, 0, 3], [0, 0, 0]])
    np.testing.assert_allclose(tv.normalize(torch.tensor([3.0, 4.0])).numpy(), [0.6, 0.8],
                               atol=1e-6)


@pytest.mark.parametrize("displ", [-9, -2, 0, 1, 3, 9])
def test_displace_matches_reference(displ):
    x = _data((3, 8))
    for axis in (-1, 0):
        _same(tv.displace1(torch.from_numpy(x), displ, axis),
              jv.displace1(jnp.asarray(x), displ, axis))
        _same(tv.displace1_zero(torch.from_numpy(x), displ, axis),
              jv.displace1_zero(jnp.asarray(x), displ, axis))


def test_centering_matches_reference():
    rows = np.zeros((5, 32), np.float32)
    rows[0, 3] = 1.0
    rows[1, 28] = 1.0
    rows[2, 10], rows[2, 11] = 0.5, 2.0
    rows[3] = np.abs(_data((32,), 2))  # rows[4] stays zero: centre n//2
    for r in rows:
        assert tv.get_center1(torch.from_numpy(r)) == jv.get_center1(r)
        for p in (2.0, 10.0):
            _same(tv.center1(torch.from_numpy(r), p=p), jv.center1(r, p=p))
    _same(tv.center21(torch.from_numpy(rows)), jv.center21(rows))
    assert int(torch.argmax(tv.center1(torch.from_numpy(rows[0])))) == 16
    with pytest.raises(ValueError, match="1-D"):
        tv.get_center1(torch.from_numpy(rows))


def test_viewport_crop():
    x = torch.arange(24.0).reshape(4, 6)
    _same(tv.viewport(x, 1, 2, 2, 3), jv.viewport(jnp.asarray(x.numpy()), 1, 2, 2, 3))
    _same(tv.crop21(x, 2, 3), jv.crop21(jnp.asarray(x.numpy()), 2, 3))
    assert tv.vec_abs([1.0, -2.0], device="cpu").device.type == "cpu"
