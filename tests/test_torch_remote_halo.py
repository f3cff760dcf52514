"""The halo push (B18) and the collective schedule of the sharded transforms.

* B18's plain version (``rdma_extend_rows_plain``, what a CPU mesh runs and
  what the kernel is held to on the card) against a numpy statement of the
  mirror rules (``sharded.py:162-165``), the independent check, and
  against the port's neighbour shift (``_exchange_rows_fwd`` /
  ``_exchange_channels_inv``, which share its ``extend_line``): exactly
  equal for 1, 2, 3 and 8 shards, halos 2, 4 and 8, every edge mode, and
  float32, float64 and int32.
* The ``halo_impl='rdma'`` pyramid exactly equal to ``'ppermute'``.
* ``collective_stats``: the counts the reference pins, with the bytes of the
  reference's own ``collective_stats`` (which only traces the jaxpr).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdwt_tpu
from libdwt_tpu.parallel import comm_stats as jcs
from libdwt_tpu.parallel import sharded as jsh
from libdwt_torch.parallel import (make_mesh_2d, make_mesh_blocks, sharded_wavedec2,
                                   sharded_wavedec3, sharded_waverec2)
from libdwt_torch.parallel import remote_halo as rh
from libdwt_torch.parallel import sharded as tsh
from libdwt_torch.parallel.comm_stats import collective_stats
from libdwt_torch.parallel.mesh import Shards

CPU8 = ["cpu"] * 8

#: np.pad modes of the global borders per edge mode: (top, bottom);
#: 'reflect' is whole-point (x[-m] = x[m]), 'symmetric' repeats the edge
#: sample (s[N+m] = s[N-1-m], d[-m] = d[m-1]).
_PAD = {"signal": ("reflect", "reflect"), "s": ("reflect", "symmetric"),
        "d": ("symmetric", "reflect")}


def _numpy_extend(blocks, halo, mode):
    """Each shard's rows of the global array, extended by the mirror rules."""
    g = np.concatenate(blocks)
    top, bot = _PAD[mode]
    g = np.pad(g, ((halo, 0), (0, 0)), mode=top)
    g = np.pad(g, ((0, halo), (0, 0)), mode=bot)
    h = blocks[0].shape[0]
    return [g[i * h: (i + 1) * h + 2 * halo] for i in range(len(blocks))]


def _blocks(n, h, w, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return [rng.integers(-1000, 1000, (h, w)).astype(np.int32) for _ in range(n)]
    return [rng.standard_normal((h, w)).astype(dtype) for _ in range(n)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
@pytest.mark.parametrize("edge_mode", ["signal", "s", "d"])
def test_plain_halo_matches_exchange_and_numpy(dtype, edge_mode):
    for n in (1, 2, 3, 8):
        for halo in (2, 4, 8):
            for h, w in ((halo + 1, 5), (20, 7)):
                npb = _blocks(n, h, w, dtype, seed=100 * n + 10 * halo + h)
                tb = [torch.from_numpy(b) for b in npb]
                got = rh.rdma_extend_rows(tb, halo, edge_mode)  # CPU blocks: the plain version
                want = _numpy_extend(npb, halo, edge_mode)
                line = Shards.line(tb)
                if edge_mode == "signal":
                    shift = tsh._exchange_rows_fwd(line, "space", halo=halo)
                else:
                    s, d = tsh._exchange_channels_inv(line, line, "space", ch=halo)
                    shift = s if edge_mode == "s" else d
                for g, w_, e in zip(got, want, shift.tolist()):
                    assert g.dtype == e.dtype and tuple(g.shape) == (h + 2 * halo, w)
                    np.testing.assert_array_equal(g.numpy(), w_)
                    assert torch.equal(g, e)


def test_plain_halo_checks():
    with pytest.raises(ValueError, match="exceed halo"):
        rh.rdma_extend_rows([torch.zeros(4, 8)] * 2, 4)
    with pytest.raises(ValueError, match="2-D"):
        rh.rdma_extend_rows([torch.zeros(2, 8, 8)] * 2, 2)
    with pytest.raises(ValueError, match="edge_mode"):
        rh.rdma_extend_rows([torch.zeros(8, 8)] * 2, 2, "x")
    with pytest.raises(ValueError, match="one shape"):
        rh.rdma_extend_rows([torch.zeros(8, 8), torch.zeros(9, 8)], 2)
    for dtype in (torch.int16, torch.uint8):
        with pytest.raises(ValueError, match="4- or 8-byte"):
            rh.rdma_extend_rows([torch.zeros(8, 8, dtype=dtype)] * 2, 2)
    s, d = rh.rdma_extend_channels([torch.arange(12.).reshape(6, 2)] * 2,
                                   [torch.arange(12.).reshape(6, 2)] * 2, ch=2)
    assert s[0][:2, 0].tolist() == [4.0, 2.0] and d[0][:2, 0].tolist() == [2.0, 0.0]


def test_flag_buffers_per_line():
    """Each line (its devices in mesh order) has flag buffers of its own on
    each device, kept across calls: lines over other device tuples are not
    ordered by one stream per device, so they must not share flags."""
    cpu = torch.device("cpu")
    a, b = (cpu,) * 4, (cpu,) * 8
    assert rh._flag_ptr(a, cpu) == rh._flag_ptr(a, cpu)
    assert rh._flag_ptr(a, cpu) != rh._flag_ptr(b, cpu)


@pytest.mark.parametrize("n_space", [8, 4])
def test_rdma_pyramid_equals_ppermute(n_space):
    mesh = make_mesh_2d(1, n_space, devices=CPU8)
    x = torch.from_numpy(np.random.RandomState(3).rand(512, 256).astype(np.float32))
    got = sharded_wavedec2(x, "cdf97", 3, mesh=mesh, halo_impl="rdma")
    pp = sharded_wavedec2(x, "cdf97", 3, mesh=mesh)
    for a, b in zip([got[0]] + [t for lvl in got[1:] for t in lvl],
                    [pp[0]] + [t for lvl in pp[1:] for t in lvl]):
        assert torch.equal(a, b)
    want = libdwt_tpu.wavedec2(jnp.asarray(x.numpy()), "cdf97", 3)
    for a, b in zip([got[0]] + [t for lvl in got[1:] for t in lvl],
                    [want[0]] + [t for lvl in want[1:] for t in lvl]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    rec = sharded_waverec2(got, "cdf97", mesh=mesh, halo_impl="rdma")
    assert torch.equal(rec, sharded_waverec2(got, "cdf97", mesh=mesh))
    np.testing.assert_allclose(rec.numpy(), x.numpy(), atol=1e-4, rtol=0)
    st = collective_stats(lambda a: sharded_wavedec2(a, "cdf97", 3, mesh=mesh,
                                                     halo_impl="rdma"), x)
    assert "ppermute" not in st, st


def _ref_stats(fn, x):
    return jcs.collective_stats(fn, jnp.zeros(tuple(x.shape), jnp.float32))


def test_collective_counts_pinned():
    """One signal-row exchange per forward level (2 ppermutes), stacked
    channel pairs on the inverse (4), two phases on 2-D blocks (4 per
    level), one z exchange per 3-D level; counts and bytes equal to the
    reference's traced schedule."""
    mesh = make_mesh_2d(2, 4, devices=CPU8)
    jmesh = jsh.make_mesh_2d(2, 4)
    x = torch.zeros(512, 512)
    for level in (1, 2, 3):
        st = collective_stats(lambda a: sharded_wavedec2(a, "cdf97", level, mesh=mesh), x)
        assert set(st) == {"ppermute"}, st
        assert st["ppermute"]["count"] == 2 * level, st
        assert st == _ref_stats(lambda a: jsh.sharded_wavedec2(a, "cdf97", level,
                                                               mesh=jmesh), x)
    coeffs = sharded_wavedec2(x, "cdf97", 2, mesh=mesh)
    st = collective_stats(lambda cs: sharded_waverec2(cs, "cdf97", mesh=mesh), coeffs)
    assert st["ppermute"]["count"] == 4 * 2, st
    jc = jax.eval_shape(lambda a: jsh.sharded_wavedec2(a, "cdf97", 2, mesh=jmesh),
                        jnp.zeros((512, 512), jnp.float32))  # traced only, never compiled
    assert st == jcs.collective_stats(lambda cs: jsh.sharded_waverec2(cs, "cdf97", mesh=jmesh),
                                      jc)
    bmesh = make_mesh_blocks(1, 2, 4, devices=CPU8)
    jbmesh = jsh.make_mesh_blocks(1, 2, 4)
    for level in (1, 2):
        st = collective_stats(lambda a: sharded_wavedec2(
            a, "cdf97", level, mesh=bmesh, space_axis="rows", col_axis="cols"), x)
        assert st["ppermute"]["count"] == 4 * level, st
        assert st == _ref_stats(lambda a: jsh.sharded_wavedec2(
            a, "cdf97", level, mesh=jbmesh, space_axis="rows", col_axis="cols"), x)
    v = torch.zeros(64, 64, 64)
    st = collective_stats(lambda a: sharded_wavedec3(
        a, "cdf97", 2, mesh=make_mesh_2d(1, 4, devices=CPU8)), v)
    assert st["ppermute"]["count"] == 2 * 2, st
    assert st == _ref_stats(lambda a: jsh.sharded_wavedec3(
        a, "cdf97", 2, mesh=jsh.make_mesh_2d(1, 4)), v)


def test_batched_exchange_is_amortized():
    """The halo exchange runs once per LEVEL for the whole stacked batch,
    not once per frame; bytes equal to the reference's (the TOP = 8 rows
    of the streamed kernels' exchange, per shard's local batch of 2)."""
    mesh = make_mesh_2d(2, 4, devices=CPU8)
    xb = torch.zeros(4, 1024, 256)
    st = collective_stats(lambda a: sharded_wavedec2(a, "cdf97", 2, mesh=mesh,
                                                     kernel="streamed"), xb)
    assert st["ppermute"]["count"] == 2 * 2, st
    # level 1: (2, 8, 256) f32 slices of the 256-row blocks; level 2: (2, 8, 128)
    assert st["ppermute"]["bytes"] == 2 * (2 * 8 * 256 * 4) + 2 * (2 * 8 * 128 * 4), st
