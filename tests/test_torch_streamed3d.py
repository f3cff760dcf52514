"""Port vs reference: the streamed 3-D levels (B16, B17).

The port's wrappers run their plain versions on CPU tensors; the JAX
package's streamed volume kernels run in interpret mode, as its own tests
run them.  The port's tile (tz, ty, tx) is a column of ty x tx samples cut
into segments at multiples of tz planes; its planner and footprint rules
are checked here, the kernels on the card (tests/test_torch_cuda.py).
Inputs come from a numpy seed.  float32 is held to 3e-5 per band (the two
round differently, about 1e-6 apart), integers exactly.  The
reference's ``strip_z``/``strip_y`` are validated by the port, whose CUDA
tile is its own: small tiles here, so every volume spans several tiles
with ragged z, y and x tails.
"""
import itertools

import numpy as np
import pytest
import torch

import libdwt_tpu.ops.separable as js
import libdwt_tpu.ops.streamed3d as jst3
from libdwt_torch.ops import UnsupportedGeometry
from libdwt_torch.ops import fused as tf
from libdwt_torch.ops import fused3d as t3
from libdwt_torch.ops import streamed3d as ts3
from libdwt_tpu.ops import UnsupportedGeometry as JaxUnsupportedGeometry

FTOL = 3e-5


def _close(got, want, atol=FTOL):
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _close(got[k], want[k], atol)
        return
    a, b = got.numpy(), np.asarray(want)
    assert a.shape == b.shape and a.dtype == b.dtype
    if np.issubdtype(a.dtype, np.integer):
        assert np.array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _t(bands):
    return {k: torch.from_numpy(np.array(v)) for k, v in bands.items()}


def _rand(z, y, x, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-512, 512, (z, y, x)).astype(dtype)
    return rng.random((z, y, x), dtype=np.float32)


@pytest.fixture(autouse=True)
def _fresh():
    tf.reset_counters()


# (z, y, x, strip_z, strip_y, port tile): the reference's GEOMS
# (tests/test_streamed3d.py), ragged z/y tails included
GEOMS = [(32, 64, 128, 16, 32, (8, 16, 32)), (30, 72, 128, 16, 32, (8, 16, 48)),
         (32, 70, 128, 16, 32, (16, 16, 16)), (24, 48, 256, 8, 16, (4, 8, 40))]


@pytest.mark.parametrize("z,y,x,sz,sy,tile", GEOMS)
def test_b16_b17_match_reference(z, y, x, sz, sy, tile):
    v = _rand(z, y, x, seed=z + y)
    want = jst3.streamed_dwt3_level(v, "cdf97", strip_z=sz, strip_y=sy, interpret=True)
    got = ts3.streamed_dwt3_level(torch.from_numpy(v), "cdf97", strip_z=sz, strip_y=sy,
                                  tile=tile)
    _close(got, want)
    rec_want = jst3.streamed_idwt3_level(want, "cdf97", strip_z=sz, strip_y=sy,
                                         interpret=True)
    rec = ts3.streamed_idwt3_level(_t(want), "cdf97", strip_z=sz, strip_y=sy, tile=tile)
    _close(rec, rec_want)
    np.testing.assert_allclose(rec.numpy(), v, atol=1e-5, rtol=0)
    assert {k: s.calls for k, s in tf.KERNELS.items() if s.calls} == {"B16": 1, "B17": 1}


# (z, y, x, strip_z, strip_y, port tile, dtype): tiles whose z steps cut a
# column into several segments with a short last one (30 = 7 x 4 + 2
# planes) and whose cross-sections divide neither Y nor X
CUT = [(30, 72, 100, 16, 32, (4, 16, 24), np.float32),
       (30, 72, 100, 16, 32, (4, 24, 40), np.int32)]


@pytest.mark.parametrize("z,y,x,sz,sy,tile,dtype", CUT)
def test_b16_b17_cut_segments_match_reference(z, y, x, sz, sy, tile, dtype):
    """On the card these tiles give each column several z segments (the
    planner at 132 SMs x 4 blocks); the values are the reference's."""
    columns = -(-y // tile[1]) * -(-x // tile[2])
    plan = ts3.plan_segments((z, y, x), tile, 132 * 4)
    assert len(plan) > columns and (plan[-1][3] - plan[-1][2]) % tile[0]
    v = _rand(z, y, x, dtype, seed=z + x)
    want = jst3.streamed_dwt3_level(v, "cdf97", strip_z=sz, strip_y=sy, interpret=True)
    got = ts3.streamed_dwt3_level(torch.from_numpy(v), "cdf97", strip_z=sz, strip_y=sy,
                                  tile=tile)
    _close(got, want)
    rec = ts3.streamed_idwt3_level(_t(want), "cdf97", strip_z=sz, strip_y=sy, tile=tile)
    _close(rec, jst3.streamed_idwt3_level(want, "cdf97", strip_z=sz, strip_y=sy,
                                          interpret=True))
    assert {k: s.calls for k, s in tf.KERNELS.items() if s.calls} == {"B16": 1, "B17": 1}


@pytest.mark.parametrize("wavelet", ["cdf53", "cdf97", "haar"])
def test_b16_b17_int32_match_reference_exactly(wavelet):
    vi = _rand(30, 72, 64, np.int32, seed=4)
    want = jst3.streamed_dwt3_level(vi, wavelet, strip_z=16, strip_y=32, interpret=True)
    got = ts3.streamed_dwt3_level(torch.from_numpy(vi), wavelet, strip_z=16, strip_y=32,
                                  tile=(8, 16, 16))
    _close(got, want)
    _close(got, js.dwt3_level(vi, wavelet))
    rec = ts3.streamed_idwt3_level(_t(want), wavelet, strip_z=16, strip_y=32,
                                   tile=(8, 16, 16))
    assert np.array_equal(rec.numpy(), vi)


def test_poly_approach_and_small_strip_z_match_reference():
    """approach='poly' runs the same kernel; strip_z=2 < HZ is clamped to HZ
    by the reference's tile rule, and both packages stay correct."""
    v = _rand(16, 64, 64, seed=3)
    want = jst3.streamed_dwt3_level(v, "cdf97", strip_z=2, interpret=True, approach="poly")
    got = ts3.streamed_dwt3_level(torch.from_numpy(v), "cdf97", strip_z=2, approach="poly",
                                  tile=(4, 16, 16))
    _close(got, want)
    assert ts3._tiles3(16, 64, 64, 4, 2, 0)[0] == ts3.HZ
    rec = ts3.streamed_idwt3_level(_t(want), "cdf97", strip_z=2, approach="poly",
                                   tile=(4, 16, 16))
    _close(rec, jst3.streamed_idwt3_level(want, "cdf97", strip_z=2, interpret=True,
                                          approach="poly"))
    with pytest.raises(ValueError, match="approach"):
        ts3.streamed_dwt3_level(torch.from_numpy(v), approach="planar")


def test_plain_tiles_match_the_fused_tiles():
    """B16/B17's plain versions are B14/B15's tile algebra: any tile gives
    the same values."""
    v = torch.from_numpy(_rand(20, 34, 30, seed=5))
    a = ts3.dwt3_level_streamed_plain(v, "cdf97", (4, 8, 16))
    b = t3.dwt3_level_plain(v, "cdf97", t3.TILE3)
    assert all(torch.equal(a[k], b[k]) for k in t3.BANDS)
    back = ts3.idwt3_level_streamed_plain(a, "cdf97", (6, 10, 8))
    assert torch.equal(back, t3.idwt3_level_plain(a, "cdf97", t3.TILE3))


# ------------------------------------------------------------ geometry


@pytest.mark.parametrize("shape,tile,slots", [
    ((64, 512, 512), ts3.STILE3, 132 * 4), ((32, 256, 256), ts3.STILE3, 132 * 4),
    ((30, 72, 100), (4, 16, 24), 132 * 4), ((38, 50, 66), (4, 24, 10), 132 * 5),
    ((64, 512, 512), ts3.STILE3, 1), ((6, 6, 6), (8, 32, 32), 528),
    ((34, 18, 40), (6, 8, 16), 7)])
def test_planner_covers_every_plane_once(shape, tile, slots):
    """The Python copy of csrc/streamed3d.cu's planner: at least one
    segment a column, the segments of a column cover its planes once in
    whole plane pairs, and each segment's warm-up pairs (two past each end)
    mirror onto planes of the volume."""
    z, y, x = shape
    items = ts3.plan_segments(shape, tile, slots)
    columns = {(x0, y0) for x0, y0, _, _ in items}
    assert columns == {(i * tile[2], j * tile[1]) for i in range(-(-x // tile[2]))
                       for j in range(-(-y // tile[1]))}
    assert len(items) >= len(columns)
    for col in columns:
        segs = sorted((a, b) for x0, y0, a, b in items if (x0, y0) == col)
        covered = [p for a, b in segs for p in range(a, b)]
        assert covered == list(range(z))
        for a, b in segs:
            assert a < b and a % 2 == 0 and b % 2 == 0 and (a % tile[0] == 0)
            for p in list(range(a - 4, a)) + list(range(b, b + 4)):
                q = -p if p < 0 else (2 * z - 2 - p if p >= z else p)
                assert 0 <= q < z
    if len(columns) > 1:  # neighbouring items take neighbouring columns
        assert items[0][2:] == items[1][2:] and items[0][:2] != items[1][:2]


def test_tile_footprint():
    """The default tiles fit both kernels; the rules of csrc/streamed3d.cu
    geometry() raise ValueError before any launch."""
    for tile, itemsize in ((ts3.STILE3, 4), (ts3.STILE3_F64, 8)):
        for inverse in (False, True):
            smem, fits = ts3._footprint(tile, itemsize, inverse)
            assert fits and smem <= t3._SMEM_MAX
    # a ring of 2 steps of 4 planes of 40 rows (44 apart; the inverse's
    # split rows 48 apart, and 4 planes of the z walk's output, 42 apart);
    # the forward's barriers, 8 bytes a slot
    assert ts3._footprint((8, 32, 32), 4, False) == (4 * 2 * 4 * 40 * 44 + 16, True)
    assert ts3._footprint((8, 32, 32), 4, True) == (4 * (2 * 4 * 40 * 48 + 4 * 40 * 42), True)
    v = torch.zeros((32, 64, 128))
    with pytest.raises(ValueError, match="threads"):
        ts3.streamed_dwt3_level(v, tile=(8, 64, 32))  # 288 window rows a step
    with pytest.raises(ValueError, match="even"):
        ts3.streamed_dwt3_level(v, tile=(8, 32, 30 + 1))


def test_geometry_gate_matches_reference():
    shapes = [(32, 64, 128), (31, 64, 128), (4, 512, 128), (6, 512, 128), (8, 8, 8),
              (64, 512, 512), (32, 256, 256), (16, 128, 128), (64, 1024, 512),
              (512, 512, 512), (64, 4096, 4096), (2, 2, 2), (18, 2048, 100)]
    for shape, sz, sy, itemsize, wv in itertools.product(
            shapes, (0, 2, 16), (0, 32, 24), (2, 4, 8), ("cdf97", "d4")):
        assert ts3.streamed3d_supported(shape, wv, sz, sy, itemsize) == \
            jst3.streamed3d_supported(shape, wv, sz, sy, itemsize), (shape, sz, sy, itemsize)
    for shape in ((64, 512, 512), (32, 256, 256), (64, 1024, 512)):
        assert ts3._tiles3(*shape, 4, 0, 0) == jst3._tiles3(*shape, 4, 0, 0)
    assert ts3._tiles3(64, 512, 512, 4, 0, 0) == (32, 64)  # 16 tiles
    assert ts3._tiles3(32, 256, 256, 4, 0, 0) == (32, 128)  # 2 tiles


def _both_raise(exc_port, exc_ref, port_call, ref_call):
    with pytest.raises(exc_ref):
        ref_call()
    with pytest.raises(exc_port):
        port_call()


@pytest.mark.parametrize("shape,kw", [((31, 64, 128), {}), ((4, 512, 128), {}),
                                      ((16, 16, 16), {"strip_z": 16, "strip_y": 16}),
                                      ((64, 2048, 64), {"strip_z": 4, "strip_y": 16})])
def test_forward_raises_unsupported_geometry_where_reference_does(shape, kw):
    """Odd dims, a dim <= HZ, one tile, more than 32 tiles."""
    v = np.zeros(shape, np.float32)
    _both_raise(UnsupportedGeometry, JaxUnsupportedGeometry,
                lambda: ts3.streamed_dwt3_level(torch.from_numpy(v), **kw),
                lambda: jst3.streamed_dwt3_level(v, interpret=True, **kw))


def test_value_errors_where_reference_raises():
    v = np.zeros((32, 64, 128), np.float32)
    _both_raise(ValueError, ValueError,
                lambda: ts3.streamed_dwt3_level(torch.from_numpy(v), strip_y=24),
                lambda: jst3.streamed_dwt3_level(v, strip_y=24, interpret=True))
    bands = {n: np.zeros((16, 32, 64), np.float32) for n in t3.BANDS}
    bands["LHH"] = np.zeros((8, 32, 64), np.float32)
    _both_raise(ValueError, ValueError,
                lambda: ts3.streamed_idwt3_level(_t(bands)),
                lambda: jst3.streamed_idwt3_level(bands, interpret=True))
    small = {n: np.zeros((2, 32, 64), np.float32) for n in t3.BANDS}  # depth == CZ
    _both_raise(UnsupportedGeometry, JaxUnsupportedGeometry,
                lambda: ts3.streamed_idwt3_level(_t(small)),
                lambda: jst3.streamed_idwt3_level(small, interpret=True))
    with pytest.raises(ValueError, match="shared memory"):
        ts3.streamed_dwt3_level(torch.from_numpy(v), tile=(16, 96, 120))
