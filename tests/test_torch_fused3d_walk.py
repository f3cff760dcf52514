"""B14/B15 on the column z walk: the Python copy of their CUDA geometry
(csrc/volwalk.cuh, csrc/fused3d.cu) and their plain versions at the new
default tile.

The footprint rule, the feed B14 takes on each volume, its tensor map
(box, strides, where a step's boxes land), the z coordinates of its boxes
(mirrored at the volume's ends, the neighbouring segment's planes at a
cut) and the edge fix-up of a window whose boxes brought zeros outside the
volume are checked against the rules they stand for; the plain versions
at TILE3 are held to the JAX Pallas kernels in interpret mode (float32 to
3e-5, int32 exactly).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdwt_tpu.ops.fused3d as j3
from libdwt_torch.ops import fused3d as t3
from libdwt_torch.ops import streamed3d as ts3


def test_default_tiles_and_footprints():
    """TILE3 / TILE3_F64 fit their kernels and are B16/B17's; the
    footprint is the walk's, B14's and B16's forward, B15's and B17's
    inverse."""
    assert t3.TILE3 == ts3.STILE3 and t3.TILE3_F64 == ts3.STILE3_F64
    assert ts3._default_tile(None, 8) == t3.TILE3_F64 and ts3._default_tile(None, 4) == t3.TILE3
    # 2 slots of 4 planes of 40 rows of 44 samples, 2 barriers
    assert t3._footprint((8, 32, 32), 4, False) == (4 * 2 * 4 * 40 * 44 + 16, True)
    # 2 slots of 4 planes of 40 rows of two 24-sample halves (2 of lead,
    # then the window's 20), then 4 planes of 40 rows of 42
    assert t3._footprint((8, 32, 32), 4, True) == (4 * (2 * 4 * 40 * 48 + 4 * 40 * 42), True)
    # float64: halves of 20 samples (no lead), rows of 24
    assert t3._footprint((8, 16, 32), 8, True) == (8 * (2 * 4 * 24 * 40 + 4 * 24 * 42), True)
    for tile, size in ((t3.TILE3, 4), (t3.TILE3_F64, 8)):
        for inverse in (False, True):
            smem, fits = t3._footprint(tile, size, inverse)
            assert fits and smem <= t3._SMEM_MAX
            assert t3._footprint(tile, size, inverse) == ts3._footprint(tile, size, inverse)
    # float64 at the 4-byte default: a forward thread's chunk covers 4 of 32
    assert not t3._footprint((8, 32, 32), 8, False)[1]


@pytest.mark.parametrize("tile,size,inverse,ok", [
    ((8, 32, 32), 4, False, True), ((4, 24, 40), 4, False, True),
    ((16, 16, 64), 4, False, True), ((16, 16, 66), 4, False, False),   # 4 x 66 lines
    ((8, 60, 32), 4, False, False),                                     # 4 x 68 rows
    ((8, 8, 120), 4, True, True), ((8, 8, 122), 4, True, False),       # 4 x 130 lines
    ((2, 2, 2), 8, True, True), ((8, 48, 32), 8, True, False),          # NQ = 4
])
def test_threads_rule(tile, size, inverse, ok):
    assert t3._footprint(tile, size, inverse)[1] is ok
    if ok:
        t3._check_tile(tile, size, inverse)
    else:
        with pytest.raises(ValueError, match="threads"):
            t3._check_tile(tile, size, inverse)


@pytest.mark.parametrize("shape,size,tile,feed", [
    ((64, 512, 512), 4, t3.TILE3, "boxes"),
    ((32, 256, 256), 4, t3.TILE3, "boxes"),
    ((64, 512, 512), 8, t3.TILE3_F64, "boxes"),
    ((6, 6, 6), 4, (2, 2, 2), "copies"),         # rows of 24 bytes
    ((38, 50, 66), 4, (4, 24, 40), "copies"),    # rows of 264 bytes
    ((38, 50, 66), 8, (4, 8, 12), "boxes"),      # 528 a row
    ((64, 64, 68), 4, t3.TILE3, "boxes"),        # 272 a row
    ((32, 64, 64), 4, (4, 10, 16), "copies"),    # an 18 x 28 plane: 2016 bytes
    ((32, 64, 64), 4, (4, 24, 10), "copies"),    # starts x0 - 4 = 6, 16, ...
    ((32, 64, 64), 4, (4, 16, 12), "boxes"),     # starts -4, 8, 20, ...
    ((32, 64, 64), 8, (4, 16, 12), "boxes"),
])
def test_feed_of(shape, size, tile, feed):
    assert t3.feed_of(shape, tile, size) == feed


def test_tensor_map_of_the_main_path():
    m = t3.tensor_map((64, 512, 512), t3.TILE3, 4)
    assert m["dims"] == (512, 512, 64)
    assert m["strides"] == (2048, 2048 * 512)
    # the window's 40 columns over-fetched to the row stride 44 (4 mod 8
    # words), its 40 rows, one plane
    assert m["box"] == (44, 40, 1) and m["box"][0] % 8 == 4
    assert m["boxes"] == 4 and m["bytes"] == 4 * 44 * 40 * 4
    # every box lands 128-byte aligned, one plane after the other
    assert m["dst"] == [0, 1760, 3520, 5280]
    assert all(d * 4 % 128 == 0 for d in m["dst"])
    m64 = t3.tensor_map((64, 512, 512), t3.TILE3_F64, 8)
    assert m64["box"] == (44, 24, 1) and all(d * 8 % 128 == 0 for d in m64["dst"])


def test_box_z_coordinates_at_the_ends_and_at_a_cut():
    """Segments of 16 pair steps cut at plane 32: the first step of a
    column mirrors planes -4..-1 to 4..1; at the cut each segment reads the
    other's planes as they are; the last step mirrors 64..67 to 62..59."""
    shape = (64, 512, 512)
    items = t3.plan_segments(shape, t3.TILE3, 132 * 4)
    cols = 16 * 16
    assert len(items) == 2 * cols
    first, second = items[0], items[cols]
    assert first == (0, 0, 0, 32) and second == (0, 0, 32, 64)
    z = lambda item, st: [c[2] for c in t3.box_coords(shape, item, st)]  # noqa: E731
    assert z(first, 0) == [4, 3, 2, 1]
    assert z(first, 1) == [0, 1, 2, 3]
    assert z(first, 9) == [32, 33, 34, 35]     # past the cut: the next segment's
    assert z(second, 0) == [28, 29, 30, 31]    # before the cut: the last one's
    assert z(second, 9) == [62, 61, 60, 59]
    assert t3.box_coords(shape, second, 10) == []
    # every box of a column starts at (x0 - 4, y0 - 4), 16-byte aligned
    x0, y0 = items[17][:2]
    assert (x0, y0) == (32, 32)
    assert {c[:2] for c in t3.box_coords(shape, items[17], 3)} == {(x0 - 4, y0 - 4)}
    assert (x0 - 4) * 4 % 16 == 0


def test_mirror_is_whole_point():
    n = 7
    ref = np.pad(np.arange(n), 3 * n, mode="reflect")
    assert [t3._mirror(p, n) for p in range(-3 * n, 4 * n)] == list(ref)


def _fixed_window(shape2, y0, x0, ty, tx):
    """A plane's window as B14's box brings it (zeros outside the volume),
    then csrc/fused3d.cu fix_edges: the rows outside y up to the halo past
    the volume (every column up to the last that matters), then the columns
    outside x (every row up to the last that matters), from their mirrors."""
    Y, X = shape2
    ey, ex = ty + 8, tx + 8
    gy, gx = np.arange(y0 - 4, y0 - 4 + ey), np.arange(x0 - 4, x0 - 4 + ex)
    plane = np.arange(Y * X, dtype=np.int64).reshape(Y, X) + 1
    inside = (gy[:, None] >= 0) & (gy[:, None] < Y) & (gx[None] >= 0) & (gx[None] < X)
    win = np.where(inside, plane[np.clip(gy, 0, Y - 1)][:, np.clip(gx, 0, X - 1)], 0)

    def edges(g0, n, m):
        a = max(0, min(m, -g0))
        b = max(a, min(m, n - g0))
        return list(range(a)) + list(range(b, min(m, b + 4))), min(m, b + 4)

    rows, re_ = edges(y0 - 4, Y, ey)
    cols, ce = edges(x0 - 4, X, ex)
    mir = lambda p, n: t3._mirror(p, n)  # noqa: E731
    fixed = win.copy()
    for r in rows:
        for c in range(ce):
            fixed[r, c] = win[mir(y0 - 4 + r, Y) - (y0 - 4), mir(x0 - 4 + c, X) - (x0 - 4)]
    for r in range(re_):
        for c in cols:
            fixed[r, c] = win[mir(y0 - 4 + r, Y) - (y0 - 4), mir(x0 - 4 + c, X) - (x0 - 4)]
    return fixed, plane, re_, ce


@pytest.mark.parametrize("shape2,y0,x0,ty,tx", [
    ((64, 64), 0, 0, 32, 32), ((64, 64), 32, 32, 32, 32), ((70, 66), 64, 48, 16, 16),
    ((6, 8), 0, 0, 2, 2), ((6, 8), 4, 6, 2, 2), ((50, 68), 48, 64, 24, 8),
])
def test_edge_fixup_gives_the_mirrored_window(shape2, y0, x0, ty, tx):
    """After the fix-up every window sample that the outputs read (up to
    the halo past the volume) is the whole-point mirrored sample: halo 4 and
    dims > 4 keep every source inside the window and inside the volume."""
    fixed, plane, re_, ce = _fixed_window(shape2, y0, x0, ty, tx)
    Y, X = shape2
    gy = [t3._mirror(p, Y) for p in range(y0 - 4, y0 - 4 + re_)]
    gx = [t3._mirror(p, X) for p in range(x0 - 4, x0 - 4 + ce)]
    np.testing.assert_array_equal(fixed[:re_, :ce], plane[np.ix_(gy, gx)])


def _rand(shape, dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    if dtype == np.int32:
        return (rng.rand(*shape) * 255).astype(np.int32)
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape,wavelet,dtype", [
    ((16, 40, 72), "cdf97", np.float32), ((24, 32, 40), "cdf53", np.float32),
    ((8, 40, 72), "cdf53", np.int32), ((16, 32, 32), "cdf97", np.int32),
])
def test_plain_at_the_default_tile_matches_pallas(shape, wavelet, dtype):
    x = _rand(shape, dtype, seed=sum(shape))
    want = j3.fused_dwt3_level(jnp.asarray(x), wavelet, strip_z=8, interpret=True)
    got = t3.fused_dwt3_level(torch.from_numpy(x), wavelet)
    exact = dtype == np.int32
    for k in t3.BANDS:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=3e-5, rtol=0)
    rec = t3.fused_idwt3_level({k: torch.from_numpy(np.array(v)) for k, v in want.items()},
                               wavelet)
    want_rec = np.asarray(j3.fused_idwt3_level(want, wavelet, strip_z=8, interpret=True))
    if exact:
        np.testing.assert_array_equal(rec.numpy(), want_rec)
        np.testing.assert_array_equal(rec.numpy(), x)
    else:
        np.testing.assert_allclose(rec.numpy(), want_rec, atol=3e-5, rtol=0)


def test_plain_does_not_depend_on_the_column_tile():
    x = torch.from_numpy(_rand((12, 36, 44), seed=3))
    base = t3.dwt3_level_plain(x, "cdf97", t3.TILE3)
    for tile in (t3.TILE3_F64, (4, 24, 40), (2, 2, 2)):
        got = t3.dwt3_level_plain(x, "cdf97", tile)
        assert all(torch.equal(got[k], base[k]) for k in base)
        assert torch.equal(t3.idwt3_level_plain(got, "cdf97", tile),
                           t3.idwt3_level_plain(base, "cdf97", t3.TILE3))
