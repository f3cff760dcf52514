"""Port vs reference: the sharded 3-D transforms (``sharded_wavedec3`` /
``sharded_waverec3``), z sharding and (z, y) block sharding on an eight-shard
CPU mesh, held to the reference's unsharded oracle
(``libdwt_tpu.wavedec3`` on float32 inputs) within 1e-4, round trips within
1e-3, int32 exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdwt_tpu
from libdwt_torch.parallel import (make_mesh_2d, make_mesh_blocks, sharded_wavedec3,
                                   sharded_waverec3)

CPU8 = ["cpu"] * 8
_wavedec3 = jax.jit(libdwt_tpu.wavedec3, static_argnames=("wavelet", "level"))


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
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape and a.numpy().dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b, atol=atol, rtol=0)


def _oracle(v, wavelet, level):
    return _wavedec3(jnp.asarray(v), wavelet=wavelet, level=level)


@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53"])
def test_sharded_3d_matches_oracle(wavelet):
    mesh = make_mesh_2d(1, 4, devices=CPU8)
    z = 4 * 2 * 8  # local z at deepest level = 16 >= HALO
    v = np.random.RandomState(0).randn(z, 24, 20).astype(np.float32)
    got = sharded_wavedec3(torch.from_numpy(v), wavelet, 1, mesh=mesh)
    _close(got, _oracle(v, wavelet, 1), 1e-4)
    rec = sharded_waverec3(got, wavelet, mesh=mesh)
    np.testing.assert_allclose(rec.numpy(), v, atol=1e-3, rtol=0)


def test_sharded_3d_multilevel_batched():
    mesh = make_mesh_2d(2, 4, devices=CPU8)
    v = np.random.RandomState(1).randn(2, 4 * 4 * 8, 16, 16).astype(np.float32)
    got = sharded_wavedec3(torch.from_numpy(v), "cdf97", 2, mesh=mesh)
    _close(got, _oracle(v, "cdf97", 2), 1e-4)
    rec = sharded_waverec3(got, "cdf97", mesh=mesh)
    np.testing.assert_allclose(rec.numpy(), v, atol=1e-3, rtol=0)


@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53"])
def test_blocks3d_forward_matches_oracle(wavelet):
    mesh = make_mesh_blocks(1, 2, 4, devices=CPU8)  # z over 'rows', y over 'cols'
    v = np.random.RandomState(0).randn(2 * 2 * 8, 4 * 2 * 8, 20).astype(np.float32)
    got = sharded_wavedec3(torch.from_numpy(v), wavelet, 1, mesh=mesh,
                           space_axis="rows", col_axis="cols")
    _close(got, _oracle(v, wavelet, 1), 1e-4)


def test_blocks3d_multilevel_roundtrip():
    mesh = make_mesh_blocks(2, 2, 2, devices=CPU8)
    v = np.random.RandomState(1).randn(2, 2 * 4 * 8, 2 * 4 * 8, 16).astype(np.float32)
    kw = dict(mesh=mesh, space_axis="rows", col_axis="cols")
    coeffs = sharded_wavedec3(torch.from_numpy(v), "cdf97", 2, **kw)
    _close(coeffs, _oracle(v, "cdf97", 2), 1e-4)
    rec = sharded_waverec3(coeffs, "cdf97", **kw)
    np.testing.assert_allclose(rec.numpy(), v, atol=1e-3, rtol=0)


def test_blocks3d_int_bitexact():
    mesh = make_mesh_blocks(1, 2, 4, devices=CPU8)
    v = np.random.RandomState(2).randint(-512, 512, (2 * 2 * 8, 4 * 2 * 8, 16), np.int32)
    kw = dict(mesh=mesh, space_axis="rows", col_axis="cols")
    got = sharded_wavedec3(torch.from_numpy(v), "cdf53", 1, **kw)
    _close(got, _oracle(v, "cdf53", 1), 0)
    np.testing.assert_array_equal(sharded_waverec3(got, "cdf53", **kw).numpy(), v)


def test_blocks3d_y_divisibility_enforced():
    mesh = make_mesh_blocks(1, 2, 4, devices=CPU8)
    with pytest.raises(ValueError, match="divisible"):
        sharded_wavedec3(torch.zeros(64, 68, 16), "cdf97", 1, mesh=mesh,
                         space_axis="rows", col_axis="cols")  # 68 % (4*2) != 0


def test_3d_checks_match_reference():
    mesh = make_mesh_2d(1, 4, devices=CPU8)
    with pytest.raises(ValueError, match="divisible"):
        sharded_wavedec3(torch.zeros(60, 16, 16), "cdf97", 1, mesh=mesh)
    with pytest.raises(ValueError, match=">= 4"):
        sharded_wavedec3(torch.zeros(32, 16, 16), "cdf97", 2, mesh=mesh)
    with pytest.raises(ValueError, match="symmetric"):
        sharded_wavedec3(torch.zeros(64, 16, 16), "d4", 1, mesh=mesh)
