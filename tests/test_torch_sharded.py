"""Port vs reference: the sharded 2-D transforms (``libdwt_torch.parallel``).

The port's sharded functions run on an eight-shard CPU mesh
(``devices=['cpu'] * 8``: the port's mesh lets a device repeat) and are held
to the reference's UNSHARDED oracle (``libdwt_tpu.wavedec2``/``waverec2`` on
float32 inputs), as the reference's own sharded tests are; the reference's
sharded functions compile for minutes and are not called here.  Bounds:
1e-4 against the oracle, 1e-5 for the kernel bodies (their plain versions
on the CPU), 1e-3 for round trips, 0 for int32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdwt_tpu
from libdwt_tpu.utils.testimg import test_image as make_test_image
from libdwt_torch.parallel import (
    make_mesh_2d,
    make_mesh_blocks,
    sharded_dwt2_level,
    sharded_idwt2_level,
    sharded_wavedec2,
    sharded_waverec2,
)

CPU8 = ["cpu"] * 8


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


_wavedec2 = jax.jit(libdwt_tpu.wavedec2, static_argnames=("wavelet", "level"))
_waverec2 = jax.jit(libdwt_tpu.waverec2, static_argnames=("wavelet",))


def _oracle(x, wavelet, level):
    return _wavedec2(jnp.asarray(x), wavelet=wavelet, level=level)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(c):
    """A JAX pyramid as torch tensors."""
    return [_t(np.asarray(c[0]))] + [tuple(_t(np.asarray(b)) for b in lvl) for lvl in c[1:]]


MESHES = [(1, 8), (2, 4), (1, 4), (1, 2)]


@pytest.mark.parametrize("n_data,n_space", MESHES)
@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53", "interp53"])
def test_sharded_forward_matches_oracle(n_data, n_space, wavelet):
    mesh = make_mesh_2d(n_data, n_space, devices=CPU8)
    level = 2
    h = n_space * (1 << level) * 8  # local rows at deepest level = 8 >= HALO
    x = make_test_image(h, 96, dtype=np.float32)
    got = sharded_wavedec2(_t(x), wavelet, level, mesh=mesh)
    _close(got, _oracle(x, wavelet, level), 1e-4)


@pytest.mark.parametrize("n_data,n_space", [(2, 4), (1, 8)])
@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53"])
def test_sharded_roundtrip(n_data, n_space, wavelet):
    mesh = make_mesh_2d(n_data, n_space, devices=CPU8)
    x = _t(make_test_image(n_space * 4 * 8, 64, dtype=np.float32))
    rec = sharded_waverec2(sharded_wavedec2(x, wavelet, 2, mesh=mesh), wavelet, mesh=mesh)
    np.testing.assert_allclose(rec.numpy(), x.numpy(), atol=1e-3, rtol=0)


def test_sharded_inverse_matches_oracle():
    """Sharded inverse applied to oracle coefficients reproduces the image."""
    mesh = make_mesh_2d(2, 4, devices=CPU8)
    x = make_test_image(4 * 8 * 8, 64, dtype=np.float32)
    coeffs = _oracle(x, "cdf97", 3)
    rec = sharded_waverec2(_tree(coeffs), "cdf97", mesh=mesh)
    want = _waverec2(coeffs, wavelet="cdf97")
    np.testing.assert_allclose(rec.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_sharded_batched_int():
    """Batch axis over 'data'; the reversible int path stays bit-exact."""
    mesh = make_mesh_2d(2, 4, devices=CPU8)
    h, w = 4 * 2 * 8, 32
    x = np.stack([make_test_image(h, w, dtype=np.int32),
                  make_test_image(h, w, rand=1, dtype=np.int32)])
    got = sharded_wavedec2(_t(x), "cdf53", 1, mesh=mesh)
    _close(got, _oracle(x, "cdf53", 1), 0)
    rec = sharded_waverec2(got, "cdf53", mesh=mesh)
    np.testing.assert_array_equal(rec.numpy(), x)


def test_sharded_step_runs_end_to_end():
    """The whole sharded forward + inverse step (the reference's jit test:
    the port runs eagerly) on the (1, 8) mesh."""
    mesh = make_mesh_2d(1, 8, devices=CPU8)
    x = _t(make_test_image(8 * 4 * 8, 32, dtype=np.float32))
    c = sharded_wavedec2(x, "cdf97", 2, mesh=mesh)
    rec = sharded_waverec2(c, "cdf97", mesh=mesh)
    np.testing.assert_allclose(rec.numpy(), x.numpy(), atol=1e-3, rtol=0)
    ll, hl, lh, hh = sharded_dwt2_level(x, "cdf97", mesh=mesh)
    _close([ll, (hl, lh, hh)], _oracle(x.numpy(), "cdf97", 1), 1e-4)
    back = sharded_idwt2_level(ll, hl, lh, hh, "cdf97", mesh=mesh)
    np.testing.assert_allclose(back.numpy(), x.numpy(), atol=1e-3, rtol=0)


@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53"])
def test_sharded_fused_matches_oracle(wavelet):
    """Per-shard fused level (B1, extended rows) vs the unsharded oracle."""
    mesh = make_mesh_2d(1, 4, devices=CPU8)
    x = make_test_image(4 * 4 * 16, 96, dtype=np.float32)
    got = sharded_wavedec2(_t(x), wavelet, 2, mesh=mesh, use_fused=True)
    _close(got, _oracle(x, wavelet, 2), 1e-4)


def test_sharded_fused_int_bitexact():
    mesh = make_mesh_2d(1, 4, devices=CPU8)
    x = make_test_image(4 * 2 * 16, 64, dtype=np.int32)
    got = sharded_wavedec2(_t(x), "cdf53", 1, mesh=mesh, use_fused=True)
    _close(got, _oracle(x, "cdf53", 1), 0)


@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53"])
def test_sharded_fused_inverse_matches_oracle(wavelet):
    """Per-shard fused INVERSE (channel-halo exchange + B4 extended rows)
    vs the unsharded round trip."""
    mesh = make_mesh_2d(1, 4, devices=CPU8)
    x = make_test_image(4 * 4 * 16, 96, dtype=np.float32)
    rec = sharded_waverec2(_tree(_oracle(x, wavelet, 2)), wavelet, mesh=mesh, use_fused=True)
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-3, rtol=0)


def test_sharded_fused_inverse_int_bitexact():
    mesh = make_mesh_2d(1, 4, devices=CPU8)
    x = make_test_image(4 * 2 * 16, 64, dtype=np.int32)
    rec = sharded_waverec2(_tree(_oracle(x, "cdf53", 1)), "cdf53", mesh=mesh, use_fused=True)
    np.testing.assert_array_equal(rec.numpy(), x)


def test_sharded_fused_roundtrip_both_ways():
    mesh = make_mesh_2d(2, 4, devices=CPU8)
    x = _t(np.random.RandomState(2).randn(4 * 4 * 16, 128).astype(np.float32))
    c = sharded_wavedec2(x, "cdf97", 2, mesh=mesh, use_fused=True)
    rec = sharded_waverec2(c, "cdf97", mesh=mesh, use_fused=True)
    np.testing.assert_allclose(rec.numpy(), x.numpy(), atol=1e-3, rtol=0)


# ------------------------------------------------ review-regression cases


def test_d4_rejected_at_global_borders():
    mesh = make_mesh_2d(1, 4, devices=CPU8)
    x = make_test_image(64, 32, dtype=np.float32)
    with pytest.raises(ValueError, match="symmetric"):
        sharded_wavedec2(_t(x), "d4", 1, mesh=mesh)
    with pytest.raises(ValueError, match="symmetric"):
        sharded_waverec2(_tree(_oracle(x, "d4", 1)), "d4", mesh=mesh)


def test_haar_sharded_matches_oracle():
    mesh = make_mesh_2d(1, 4, devices=CPU8)
    x = make_test_image(64, 32, dtype=np.float32)
    _close(sharded_wavedec2(_t(x), "haar", 1, mesh=mesh), _oracle(x, "haar", 1), 1e-5)


def test_fused_inverse_minimum_rows_enforced():
    # h=64, n_space=4, level=2 leaves 4 local channel rows at the deepest
    # level: enough for the lifting path (HALO=4), one short of the fused
    # inverse's FCH+1=5
    mesh = make_mesh_2d(1, 4, devices=CPU8)
    x = make_test_image(64, 32, dtype=np.float32)
    with pytest.raises(ValueError, match=">= 5"):
        sharded_wavedec2(_t(x), "cdf97", 2, mesh=mesh, use_fused=True)
    with pytest.raises(ValueError, match=">= 5"):
        sharded_waverec2(_tree(_oracle(x, "cdf97", 2)), "cdf97", mesh=mesh, use_fused=True)
    x2 = make_test_image(128, 32, dtype=np.float32)
    c2 = sharded_wavedec2(_t(x2), "cdf97", 2, mesh=mesh, use_fused=True)
    _close(c2, _oracle(x2, "cdf97", 2), 1e-4)
    r2 = sharded_waverec2(c2, "cdf97", mesh=mesh, use_fused=True)
    np.testing.assert_allclose(r2.numpy(), x2, atol=1e-4)


def test_use_fused_batched_supported():
    """Batched frames under the kernel paths launch one kernel per frame
    inside the shard; the halo exchange runs once per level for the batch."""
    mesh = make_mesh_2d(2, 4, devices=CPU8)
    x = np.random.RandomState(0).rand(2, 128, 32).astype(np.float32)
    got = sharded_wavedec2(_t(x), "cdf97", 1, mesh=mesh, use_fused=True)
    _close(got, _oracle(x, "cdf97", 1), 1e-5)


def test_inverse_validates_pytree():
    mesh = make_mesh_2d(1, 4, devices=CPU8)
    c = _tree(_oracle(make_test_image(128, 32, dtype=np.float32), "cdf97", 2))
    bad = [c[0], c[1], tuple(torch.zeros(16, 16) for _ in range(3))]
    with pytest.raises(ValueError, match="chain"):
        sharded_waverec2(bad, "cdf97", mesh=mesh)


def test_make_mesh_2d_rejects_too_few_devices(monkeypatch):
    with pytest.raises(ValueError, match="devices"):
        make_mesh_2d(2, 8, devices=CPU8)
    mesh = make_mesh_2d(2, 4, devices=CPU8)
    assert mesh.shape == {"data": 2, "space": 4} and mesh.axis_names == ("data", "space")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh_2d(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh_blocks(1, 1, 1)


# ----------------------------------------------------- 2-D block sharding


BLOCK_MESHES = [(1, 2, 4), (2, 2, 2), (1, 4, 2)]


@pytest.mark.parametrize("n_data,n_rows,n_cols", BLOCK_MESHES)
@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53"])
def test_blocks_forward_matches_oracle(n_data, n_rows, n_cols, wavelet):
    mesh = make_mesh_blocks(n_data, n_rows, n_cols, devices=CPU8)
    x = make_test_image(n_rows * 4 * 8, n_cols * 4 * 8, dtype=np.float32)
    got = sharded_wavedec2(_t(x), wavelet, 2, mesh=mesh, space_axis="rows", col_axis="cols")
    _close(got, _oracle(x, wavelet, 2), 1e-4)


@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53"])
def test_blocks_roundtrip(wavelet):
    mesh = make_mesh_blocks(1, 2, 4, devices=CPU8)
    x = _t(make_test_image(2 * 4 * 8, 4 * 4 * 8, dtype=np.float32))
    kw = dict(mesh=mesh, space_axis="rows", col_axis="cols")
    rec = sharded_waverec2(sharded_wavedec2(x, wavelet, 2, **kw), wavelet, **kw)
    np.testing.assert_allclose(rec.numpy(), x.numpy(), atol=1e-3, rtol=0)


def test_blocks_inverse_matches_oracle():
    mesh = make_mesh_blocks(1, 2, 4, devices=CPU8)
    x = make_test_image(2 * 4 * 8, 4 * 4 * 8, dtype=np.float32)
    coeffs = _oracle(x, "cdf97", 2)
    rec = sharded_waverec2(_tree(coeffs), "cdf97", mesh=mesh, space_axis="rows",
                           col_axis="cols")
    np.testing.assert_allclose(rec.numpy(), np.asarray(_waverec2(coeffs, wavelet="cdf97")),
                               atol=1e-4, rtol=0)


def test_blocks_batched_int_bitexact():
    mesh = make_mesh_blocks(2, 2, 2, devices=CPU8)
    h = w = 2 * 2 * 8
    x = np.stack([make_test_image(h, w, dtype=np.int32),
                  make_test_image(h, w, rand=1, dtype=np.int32)])
    kw = dict(mesh=mesh, space_axis="rows", col_axis="cols")
    got = sharded_wavedec2(_t(x), "cdf53", 1, **kw)
    _close(got, _oracle(x, "cdf53", 1), 0)
    np.testing.assert_array_equal(sharded_waverec2(got, "cdf53", **kw).numpy(), x)


def test_blocks_rejects_use_fused():
    mesh = make_mesh_blocks(1, 2, 4, devices=CPU8)
    x = torch.zeros(64, 128)
    with pytest.raises(ValueError, match="row sharding only"):
        sharded_wavedec2(x, "cdf97", 1, mesh=mesh, space_axis="rows", col_axis="cols",
                         use_fused=True)
    coeffs = [torch.zeros(32, 64), (torch.zeros(32, 64),) * 3]
    with pytest.raises(ValueError, match="row sharding only"):
        sharded_waverec2(coeffs, "cdf97", mesh=mesh, space_axis="rows", col_axis="cols",
                         use_fused=True)


def test_blocks_width_divisibility_enforced():
    mesh = make_mesh_blocks(1, 2, 4, devices=CPU8)
    with pytest.raises(ValueError, match="divisible"):
        sharded_wavedec2(torch.zeros(64, 72), "cdf97", 2, mesh=mesh, space_axis="rows",
                         col_axis="cols")


def test_make_mesh_blocks_rejects_too_few_devices():
    with pytest.raises(ValueError, match="devices"):
        make_mesh_blocks(2, 2, 4, devices=CPU8)


@pytest.mark.parametrize("seed", range(4))
def test_blocks_geometry_fuzz(seed):
    """Seeded geometry fuzz over mesh factorization, level count, widths and
    wavelet: the margin arithmetic of the two-phase exchange must match the
    oracle everywhere."""
    rng = np.random.RandomState(100 + seed)
    n_rows, n_cols = [(2, 2), (2, 4), (4, 2), (2, 2)][seed]
    level = int(rng.randint(1, 3))
    wavelet = ["cdf97", "cdf53", "interp53", "cdf97"][seed]
    h = n_rows * (1 << level) * int(rng.randint(4, 9)) * 2
    w = n_cols * (1 << level) * int(rng.randint(4, 9)) * 2
    mesh = make_mesh_blocks(1, n_rows, n_cols, devices=CPU8)
    x = rng.randn(h, w).astype(np.float32)
    kw = dict(mesh=mesh, space_axis="rows", col_axis="cols")
    got = sharded_wavedec2(_t(x), wavelet, level, **kw)
    _close(got, _oracle(x, wavelet, level), 1e-4)
    np.testing.assert_allclose(sharded_waverec2(got, wavelet, **kw).numpy(), x,
                               atol=1e-3, rtol=0)


# ------------------------------------------------ kernel bodies and checks


class TestShardedKernelBodies:
    """kernel='streamed' and kernel='fused' per shard, batched inputs, the
    small-level fallback and the argument checks."""

    def test_streamed_kernel_matches_oracle(self):
        mesh = make_mesh_2d(1, 4, devices=CPU8)
        x = np.random.RandomState(0).rand(1024, 256).astype(np.float32)
        got = sharded_wavedec2(_t(x), "cdf97", 2, mesh=mesh, kernel="streamed")
        _close(got, _oracle(x, "cdf97", 2), 1e-5)
        rec = sharded_waverec2(got, "cdf97", mesh=mesh, kernel="streamed")
        np.testing.assert_allclose(rec.numpy(), x, atol=1e-4, rtol=0)

    @pytest.mark.parametrize("kern", ["fused", "streamed"])
    def test_batched_kernel_matches_oracle(self, kern):
        mesh = make_mesh_2d(2, 4, devices=CPU8)
        xb = np.random.RandomState(1).rand(4, 1024, 256).astype(np.float32)
        got = sharded_wavedec2(_t(xb), "cdf97", 2, mesh=mesh, kernel=kern)
        _close(got, _oracle(xb, "cdf97", 2), 1e-5)
        rec = sharded_waverec2(got, "cdf97", mesh=mesh, kernel=kern)
        np.testing.assert_allclose(rec.numpy(), xb, atol=1e-4, rtol=0)

    def test_small_levels_fall_back_to_fused(self):
        # 512 / 4 shards = 128 local rows: level 1 streams, level 2's 64-row
        # blocks are below the strip walk's range and take the fused level
        from libdwt_torch.ops import fused as tf

        mesh = make_mesh_2d(1, 4, devices=CPU8)
        x = np.random.RandomState(2).rand(512, 256).astype(np.float32)
        tf.reset_counters()
        got = sharded_wavedec2(_t(x), "cdf97", 2, mesh=mesh, kernel="streamed")
        assert (tf.KERNELS["B7"].calls, tf.KERNELS["B1"].calls) == (4, 4)
        _close(got, _oracle(x, "cdf97", 2), 1e-5)

    def test_kernel_arg_validated(self):
        mesh = make_mesh_2d(1, 4, devices=CPU8)
        with pytest.raises(ValueError, match="kernel"):
            sharded_wavedec2(torch.zeros(512, 256), "cdf97", 1, mesh=mesh, kernel="mxu")

    def test_rdma_rejects_unsupported_layouts(self):
        mesh = make_mesh_2d(2, 4, devices=CPU8)
        xb = torch.zeros(2, 256, 128)
        with pytest.raises(ValueError, match="rdma"):
            sharded_wavedec2(xb, "cdf97", 1, mesh=mesh, halo_impl="rdma")
        with pytest.raises(ValueError, match="rdma"):
            sharded_wavedec2(xb[0], "cdf97", 1, mesh=mesh, halo_impl="rdma", kernel="fused")
        with pytest.raises(ValueError, match="halo_impl"):
            sharded_wavedec2(xb[0], "cdf97", 1, mesh=mesh, halo_impl="nope")
        with pytest.raises(ValueError, match="halo_impl"):
            sharded_waverec2([torch.zeros(128, 64), (torch.zeros(128, 64),) * 3], "cdf97",
                             mesh=mesh, halo_impl="nope")
