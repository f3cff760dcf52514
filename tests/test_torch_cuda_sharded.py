"""The sharded transforms and the float64 kernels on the card.

* B18 (csrc/remote_halo.cu): the gather of a line on one card held bit for
  bit against its plain version over shard counts, halos, edge modes and
  dtypes, odd widths, one-column blocks, the smallest blocks and blocks
  whose rows start off 16-byte alignment, always one ordinary launch; the
  channel pair in one launch; 200 calls back to back; a failed launch
  raises; the ``halo_impl='rdma'`` pyramid exactly equal to the
  ``'ppermute'`` one on an eight-shard mesh of one card, with 2 x J
  launches and no cooperative one.  The push, the protocol of a line over
  several cards, on a line of one card over the same shard counts, halos,
  edge modes and dtypes, and 200 pushes back to back; and over two cards,
  which skips without a second card with peer access.
* The float64 instantiations of the polyphase kernels (B1-B12, B14-B17),
  each bit for bit against its plain version on the same CUDA tensors.
* An explicit 'auto' 2-D pyramid whose top level stays separable
  re-dispatches each level, as the reference does: at 2144x4096 J=5 only
  level 2 (1072x2048) takes the fused level.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports torch, numpy and the port only (no JAX):

    python -m pytest tests/test_torch_cuda_sharded.py -m cuda --noconftest -o addopts= -q
"""
import numpy as np
import pytest
import torch

from libdwt_torch import api, autotune
from libdwt_torch.ops import fused as tf
from libdwt_torch.ops import fused3d as t3
from libdwt_torch.ops import separable as sep
from libdwt_torch.ops import streamed as ts
from libdwt_torch.ops import streamed3d as ts3
from libdwt_torch.parallel import make_mesh_2d, sharded_wavedec2, sharded_waverec2
from libdwt_torch.parallel import remote_halo as rh


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.fixture
def no_tune_table(tmp_path, monkeypatch):
    """'auto' with an empty tune table: its built-in thresholds, whatever
    the packaged table measured."""
    path = tmp_path / "autotune.json"
    path.write_text("{}")
    monkeypatch.setenv("LIBDWT_TORCH_TUNE_FILE", str(path))
    autotune.clear_cache()
    yield
    autotune.clear_cache()


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for s in t for x in _leaves(s)]
    return [t]


def _equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


def _blocks(n, h, w, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        return [torch.from_numpy(rng.integers(-1000, 1000, (h, w)).astype(np.int32)).to(device)
                for _ in range(n)]
    return [torch.from_numpy(rng.standard_normal((h, w))).to(dtype).to(device)
            for _ in range(n)]


# ------------------------------------------------------------------ B18


def _misaligned(n, h, w, dtype, device, seed):
    """Contiguous blocks one element past a 16-byte boundary (views of one
    allocation)."""
    flat = torch.cat([b.reshape(-1) for b in _blocks(n, h, w, dtype, device, seed)])
    flat = torch.cat([flat[:1], flat])
    return [flat[1 + i * h * w: 1 + (i + 1) * h * w].view(h, w) for i in range(n)]


def _gathered():
    """Every device's last B18 launch was the gather (no cooperative launch)."""
    return all(p == "gather" and g >= 1 and r == 0 for p, g, r in rh.LAST_GRID.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32])
@pytest.mark.parametrize("edge_mode", ["signal", "s", "d"])
def test_b18_matches_plain(cuda_device, dtype, edge_mode):
    tf.reset_counters()
    rh.LAST_GRID.clear()
    calls = 0
    for n in (1, 2, 3, 8):
        for halo in (1, 2, 4, 8):
            for h, w in ((24, 40), (halo + 1, 4097), (halo + 1, 1), (halo + 3, 64)):
                seed = n * halo + h + w
                for blocks in (_blocks(n, h, w, dtype, cuda_device, seed),
                               _misaligned(n, h, w, dtype, cuda_device, seed)):
                    got = rh.rdma_extend_rows(blocks, halo, edge_mode)
                    calls += 1
                    _equal(got, rh.rdma_extend_rows_plain(blocks, halo, edge_mode))
                    assert all(g.device == b.device for g, b in zip(got, blocks))
    torch.cuda.synchronize()
    assert tf.KERNELS["B18"].launches == calls
    assert list(rh.LAST_GRID) == [str(torch.device("cuda", torch.cuda.current_device()))]
    assert _gathered()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32])
def test_b18_channel_pair_one_launch(cuda_device, dtype):
    """Both channels of an inverse line in one gather launch, each with its
    own mirror rule (and here its own width), == two plain calls."""
    for n, ch, h, w in ((8, 2, 128, 4096), (3, 4, 5, 33), (1, 1, 2, 1)):
        s = _blocks(n, h, w, dtype, cuda_device, seed=n + ch)
        d = _misaligned(n, h, w + 3, dtype, cuda_device, seed=n + ch + 1)
        tf.reset_counters()
        rh.LAST_GRID.clear()
        got_s, got_d = rh.rdma_extend_channels(s, d, ch)
        torch.cuda.synchronize()
        assert tf.KERNELS["B18"].launches == 1 and _gathered()
        _equal(got_s, rh.rdma_extend_rows_plain(s, ch, "s"))
        _equal(got_d, rh.rdma_extend_rows_plain(d, ch, "d"))
        _equal([got_s, got_d], list(rh.rdma_extend_channels_plain(s, d, ch)))


@pytest.mark.cuda
def test_b18_back_to_back_calls(cuda_device):
    blocks = _blocks(8, 64, 256, torch.float32, cuda_device, seed=5)
    want = rh.rdma_extend_rows_plain(blocks, 4)
    tf.reset_counters()
    outs = [rh.rdma_extend_rows(blocks, 4) for _ in range(200)]
    torch.cuda.synchronize()
    assert tf.KERNELS["B18"].launches == 200
    _equal(outs[0], want)
    _equal(outs[-1], want)
    s, d = rh.rdma_extend_channels(blocks, blocks, 2)
    _equal(s, rh.rdma_extend_rows_plain(blocks, 2, "s"))
    _equal(d, rh.rdma_extend_rows_plain(blocks, 2, "d"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32])
@pytest.mark.parametrize("edge_mode", ["signal", "s", "d"])
def test_b18_push_matches_plain(cuda_device, dtype, edge_mode):
    """The push, the protocol of a line over several cards, on a line of one
    card: == plain, one cooperative launch a call whose grid fits the
    card's co-resident blocks."""
    t_off, b_off = rh._EDGE_MODES[edge_mode]
    tf.reset_counters()
    rh.LAST_GRID.clear()
    calls = 0
    for n in (1, 2, 3, 8):
        for halo in (2, 4, 8):
            for h, w in ((24, 40), (halo + 1, 4097)):
                blocks = _blocks(n, h, w, dtype, cuda_device, seed=n * halo + h)
                got = rh._push_cuda(blocks, halo, t_off, b_off)
                calls += 1
                _equal(got, rh.rdma_extend_rows_plain(blocks, halo, edge_mode))
                assert all(g.device == b.device for g, b in zip(got, blocks))
    torch.cuda.synchronize()
    assert tf.KERNELS["B18"].launches == calls
    assert all(p == "push" and 1 <= g <= r for p, g, r in rh.LAST_GRID.values())


@pytest.mark.cuda
def test_b18_push_back_to_back_calls(cuda_device):
    """200 pushes back to back on one line of one card: the epoch advances,
    nothing hangs, the last call is still right."""
    blocks = _blocks(8, 64, 256, torch.float32, cuda_device, seed=5)
    tf.reset_counters()
    outs = [rh._push_cuda(blocks, 4, 1, 1) for _ in range(200)]
    torch.cuda.synchronize()
    assert tf.KERNELS["B18"].launches == 200
    want = rh.rdma_extend_rows_plain(blocks, 4)
    _equal(outs[0], want)
    _equal(outs[-1], want)
    _equal(rh._push_cuda(blocks, 2, 1, 0), rh.rdma_extend_rows_plain(blocks, 2, "s"))
    _equal(rh._push_cuda(blocks, 2, 0, 1), rh.rdma_extend_rows_plain(blocks, 2, "d"))


@pytest.mark.cuda
def test_b18_rejects_bad_lines(cuda_device):
    blocks = _blocks(2, 8, 16, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="exceed halo"):
        rh.rdma_extend_rows(blocks, 8)
    with pytest.raises(ValueError, match="mixes"):
        rh.rdma_extend_rows([blocks[0], blocks[1].cpu()], 4)
    with pytest.raises(ValueError, match="mixes"):
        rh.rdma_extend_channels(blocks, [b.cpu() for b in blocks], 2)
    # a launch the kernel refuses (a mirror window past the block) raises
    with pytest.raises(RuntimeError):
        rh._gather_cuda([(blocks, 6, 0)], 4, blocks[0].device)


@pytest.mark.cuda
def test_rdma_pyramid_equals_ppermute(cuda_device):
    mesh = make_mesh_2d(1, 8, devices=[cuda_device] * 8)
    x = torch.from_numpy(np.random.default_rng(3).random((512, 256), dtype=np.float32))
    x = x.to(cuda_device)
    tf.reset_counters()
    rh.LAST_GRID.clear()
    got = sharded_wavedec2(x, "cdf97", 3, mesh=mesh, halo_impl="rdma")
    rec = sharded_waverec2(got, "cdf97", mesh=mesh, halo_impl="rdma")
    torch.cuda.synchronize()
    # one gather launch a forward level, one for both channels an inverse level
    assert tf.KERNELS["B18"].launches == 3 + 3
    assert _gathered()  # no cooperative launch on a line of one card
    _equal(got, sharded_wavedec2(x, "cdf97", 3, mesh=mesh))
    _equal(rec, sharded_waverec2(got, "cdf97", mesh=mesh))
    for a, b in zip(_leaves(got), _leaves(sep.wavedec2(x, "cdf97", 3))):
        assert float((a - b).abs().max()) <= 1e-4
    assert float((rec - x).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_b18_across_two_cards(cuda_device):
    if torch.cuda.device_count() < 2 or not torch.cuda.can_device_access_peer(0, 1):
        pytest.skip("needs two CUDA devices with peer access")
    devs = [torch.device("cuda", i % 2) for i in range(4)]
    rng = np.random.default_rng(7)
    blocks = [torch.from_numpy(rng.standard_normal((32, 300)).astype(np.float32)).to(d)
              for d in devs]
    tf.reset_counters()
    rh.LAST_GRID.clear()
    for _ in range(20):
        got = rh.rdma_extend_rows(blocks, 4)
    for d in range(2):
        torch.cuda.synchronize(d)
    assert tf.KERNELS["B18"].launches == 20 * 2
    assert all(p == "push" and 1 <= g <= r for p, g, r in rh.LAST_GRID.values())
    _equal(got, rh.rdma_extend_rows_plain(blocks, 4))
    mesh = make_mesh_2d(1, 4, devices=devs)
    x = torch.from_numpy(rng.random((256, 128), dtype=np.float32)).to(devs[0])
    _equal(sharded_wavedec2(x, "cdf97", 2, mesh=mesh, halo_impl="rdma"),
           sharded_wavedec2(x, "cdf97", 2, mesh=mesh))


# --------------------------------------------------------- float64 kernels


def _img64(h, w, device, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((h, w))).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53", "haar"])
def test_float64_2d_kernels_match_plain(cuda_device, wavelet):
    tf.reset_counters()
    x = _img64(513, 511, cuda_device, seed=1)
    b = tf.fused_dwt2_level(x, wavelet)
    _equal(list(b), list(tf.dwt2_level_plain(x, wavelet)))
    _equal(tf.fused_idwt2_level(*b, wavelet), tf.idwt2_level_plain(*b, wavelet))
    x = _img64(1056, 544, cuda_device, seed=2)
    c2 = tf.fused_dwt2_2level(x, wavelet)
    _equal(list(c2), list(tf.fused_dwt2_2level_plain(x, wavelet)))
    _equal(tf.fused_idwt2_2level(*c2, wavelet), tf.fused_idwt2_2level_plain(*c2, wavelet))
    d = tf.fused_deep_wavedec2(x, wavelet, 3)
    _equal(d, tf.fused_deep_wavedec2_plain(x, wavelet, 3))
    _equal(tf.fused_deep_waverec2(d, wavelet), tf.fused_deep_waverec2_plain(d, wavelet))
    xe = _img64(512 + 2 * tf.HALO, 256, cuda_device, seed=3)
    _equal(list(tf.fused_dwt2_level(xe, wavelet, boundary_rows="extended")),
           list(tf.dwt2_level_plain(xe, wavelet, ext=True)))
    xs = _img64(1024, 512, cuda_device, seed=4)
    sb = ts.streamed_dwt2_level(xs, wavelet)
    _equal(list(sb), list(ts.streamed_dwt2_level_plain(xs, wavelet)))
    _equal(ts.streamed_idwt2_level(*sb, wavelet), ts.streamed_idwt2_level_plain(*sb, wavelet))
    s2 = ts.streamed_dwt2_2level(xs, wavelet)
    _equal(list(s2), list(ts.streamed_dwt2_2level_plain(xs, wavelet)))
    _equal(ts.streamed_idwt2_2level(*s2, wavelet), ts.streamed_idwt2_2level_plain(*s2, wavelet))
    sd = ts.streamed_wavedec2_deep(xs, wavelet, 4)
    _equal(sd, ts.streamed_wavedec2_deep_plain(xs, wavelet, 4))
    _equal(ts.streamed_waverec2_deep(sd, wavelet), ts.streamed_waverec2_deep_plain(sd, wavelet))
    torch.cuda.synchronize()
    assert all(tf.KERNELS[k].launches for k in
               ("B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8", "B9", "B10", "B11", "B12"))
    for a, w in zip(_leaves(sd), _leaves(sep.wavedec2(xs, wavelet, 4))):
        assert float((a - w).abs().max()) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 32, 48), (64, 128, 128)])
def test_float64_3d_kernels_match_plain(cuda_device, shape):
    v = torch.from_numpy(np.random.default_rng(6).standard_normal(shape)).to(cuda_device)
    tf.reset_counters()
    b = t3.fused_dwt3_level(v, "cdf97")
    _equal(b, t3.dwt3_level_plain(v, "cdf97"))
    _equal(t3.fused_idwt3_level(b, "cdf97"), t3.idwt3_level_plain(b, "cdf97"))
    sb = ts3.streamed_dwt3_level(v, "cdf97")
    _equal(sb, ts3.dwt3_level_streamed_plain(v, "cdf97"))
    _equal(ts3.streamed_idwt3_level(sb, "cdf97"), ts3.idwt3_level_streamed_plain(sb, "cdf97"))
    torch.cuda.synchronize()
    assert all(tf.KERNELS[k].launches == 1 for k in ("B14", "B15", "B16", "B17"))


# ------------------------------------------------------------ C3 dispatch


@pytest.mark.cuda
def test_explicit_auto_pyramid_redispatches_each_level(cuda_device, no_tune_table):
    x = torch.from_numpy(np.random.default_rng(8).random((2144, 4096), dtype=np.float32))
    x = x.to(cuda_device)
    tf.reset_counters()
    coeffs = api.wavedec2(x, "cdf97", 5, impl="auto")
    torch.cuda.synchronize()
    assert {k: s.launches for k, s in tf.KERNELS.items() if s.launches} == {"B1": 1}
    rec = api.waverec2(coeffs, "cdf97", impl="auto")
    torch.cuda.synchronize()
    assert {k: s.launches for k, s in tf.KERNELS.items() if s.launches} == {"B1": 1, "B4": 1}
    for a, b in zip(_leaves(coeffs), _leaves(sep.wavedec2(x, "cdf97", 5))):
        assert float((a - b).abs().max()) <= 5e-4
    assert float((rec - sep.waverec2(coeffs, "cdf97")).abs().max()) <= 5e-4
    tf.reset_counters()
    api.waverec2(api.wavedec2(x, "cdf97", 5), "cdf97")  # impl=None: locked separable
    assert all(s.launches == 0 for s in tf.KERNELS.values())
