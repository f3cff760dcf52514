"""The halo push (B18) and the collective schedule of the sharded transforms.

* B18's plain version (``rdma_extend_rows_plain``, what a CPU mesh runs and
  what the kernel is held to on the card) against a numpy statement of the
  mirror rules (``sharded.py:162-165``), the independent check, and
  against the port's neighbour shift (``_exchange_rows_fwd`` /
  ``_exchange_channels_inv``, which share its ``extend_line``): exactly
  equal for 1, 2, 3 and 8 shards, halos 2, 4 and 8, every edge mode, and
  float32, float64 and int32.
* B18's plain versions (``rdma_extend_rows_plain`` and the two-channel
  ``rdma_extend_channels_plain``) against the reference's Pallas kernels
  themselves, ``rdma_extend_rows`` / ``rdma_extend_channels`` in interpret
  mode under ``jax.shard_map`` on the 8-device CPU mesh (a 256x128 float32
  frame, halos 4 and 2, every edge mode): bit for bit.
* The gather's row map (``gather_rows``, the index arithmetic of the CUDA
  gather) applied with ``index_select`` to the stacked blocks, against
  ``extend_line`` for 1, 2, 3 and 8 shards, halos 1-8, every edge mode;
  and which CUDA path a line takes (one gather launch for a line on one
  device, both channels in it; the push per channel over several).
* The ``halo_impl='rdma'`` pyramid exactly equal to ``'ppermute'``.
* ``collective_stats``: the counts the reference pins, with the bytes of the
  reference's own ``collective_stats`` (which only traces the jaxpr).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import libdwt_tpu
from libdwt_tpu.parallel import comm_stats as jcs
from libdwt_tpu.parallel import remote_halo as jrh
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
    with pytest.raises(ValueError, match="one shard count"):
        rh.rdma_extend_channels([torch.zeros(6, 2)] * 2, [torch.zeros(6, 2)] * 3)


#: the reference's interpret-mode cases: a 256x128 float32 frame on the
#: 8-device CPU mesh, 32-row blocks
REF_FRAME, REF_SHARDS = (256, 128), 8


def _ref_line(fn, *frames):
    """``fn`` (the reference's kernel on local blocks) under ``shard_map`` over
    the frames' rows on the 8-device mesh, each result cut back into its
    shards' extended blocks."""
    spec = PartitionSpec("space", None)
    specs = (spec,) * len(frames)
    out = jax.shard_map(fn, mesh=jsh.make_mesh_2d(1, REF_SHARDS), in_specs=specs,
                        out_specs=specs if len(frames) > 1 else spec, check_vma=False)(
        *(jnp.asarray(f) for f in frames))
    outs = out if len(frames) > 1 else (out,)
    return [np.asarray(o).reshape(REF_SHARDS, -1, REF_FRAME[1]) for o in outs]


def _ref_blocks(frame):
    return list(torch.from_numpy(frame).reshape(REF_SHARDS, -1, REF_FRAME[1]).unbind(0))


@pytest.mark.parametrize("halo", [4, 2])
@pytest.mark.parametrize("edge_mode", ["signal", "s", "d"])
def test_plain_halo_matches_reference_kernel(halo, edge_mode):
    x = np.random.default_rng(20 + halo).random(REF_FRAME, dtype=np.float32)
    (want,) = _ref_line(lambda xl: jrh.rdma_extend_rows(
        xl, "space", mesh_axes=("data", "space"), halo=halo, interpret=True,
        edge_mode=edge_mode), x)
    blocks = _ref_blocks(x)
    for got in (rh.rdma_extend_rows_plain(blocks, halo, edge_mode),
                rh.rdma_extend_rows(blocks, halo, edge_mode)):
        assert len(got) == REF_SHARDS
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("ch", [4, 2])
def test_plain_channels_match_reference_kernel(ch):
    rng = np.random.default_rng(30 + ch)
    s, d = (rng.random(REF_FRAME, dtype=np.float32) for _ in range(2))
    want_s, want_d = _ref_line(lambda a, b: jrh.rdma_extend_channels(
        a, b, "space", mesh_axes=("data", "space"), ch=ch, interpret=True), s, d)
    sb, db = _ref_blocks(s), _ref_blocks(d)
    for got_s, got_d in (rh.rdma_extend_channels_plain(sb, db, ch),
                         rh.rdma_extend_channels(sb, db, ch)):
        for got, want in ((got_s, want_s), (got_d, want_d)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("edge_mode", ["signal", "s", "d"])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_gather_row_map_matches_extend_line(n, edge_mode):
    t_off, b_off = rh._EDGE_MODES[edge_mode]
    for halo in range(1, 9):
        for h in (halo + 1, halo + 2, 2 * halo + 5):
            blocks = [torch.from_numpy(b) for b in _blocks(n, h, 3, np.float64, seed=h)]
            idx = rh.gather_rows(n, h, halo, t_off, b_off)
            assert idx.shape == (n * (h + 2 * halo),) and idx.dtype == torch.int64
            assert int(idx.min()) >= 0 and int(idx.max()) < n * h
            got = torch.cat(blocks).index_select(0, idx).reshape(n, h + 2 * halo, 3)
            for g, w in zip(got, rh.extend_line(blocks, halo, t_off, b_off)):
                assert torch.equal(g, w)


def test_cuda_path_by_devices(monkeypatch):
    """A line whose blocks sit on one device is gathered in one launch, both
    channels together; a line over several devices is pushed channel by
    channel; more than 64 shards are refused.  The kernels are stood in for
    (the blocks' first value names their device)."""
    seen = []
    monkeypatch.setattr(rh, "_device", lambda b: torch.device("cuda", int(b[0, 0])))
    monkeypatch.setattr(rh, "_gather_cuda", lambda lines, halo, dev: seen.append(
        ("gather", len(lines), dev.index)) or [[None] for _ in lines])
    monkeypatch.setattr(rh, "_push_cuda", lambda blocks, halo, t, b: seen.append(
        ("push", (t, b))) or [None])
    one, two = [torch.zeros(6, 4)] * 3, [torch.zeros(6, 4), torch.ones(6, 4)]
    rh._extend_cuda([(one, 1, 0), (one, 0, 1)], 2)
    rh._extend_cuda([(one, 1, 1)], 4)
    rh._extend_cuda([(two, 1, 0), (two, 0, 1)], 2)
    rh._extend_cuda([(one, 1, 0), ([b.double() for b in one], 0, 1)], 2)
    assert seen == [("gather", 2, 0), ("gather", 1, 0), ("push", (1, 0)), ("push", (0, 1)),
                    ("gather", 1, 0), ("gather", 1, 0)]
    with pytest.raises(ValueError, match="at most 64"):
        rh._extend_cuda([([torch.zeros(6, 4)] * 65, 1, 1)], 2)


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
