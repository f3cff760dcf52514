"""Port vs reference: the streamed 2-D kernels (B8, B10, B11, B12).

The port's wrappers run their plain versions on CPU tensors; the JAX
package's streamed kernels run in interpret mode, as its own tests run
them.  Inputs come from a numpy seed.  float32 is held to 3e-5 per output
(the two round differently, about 1e-6 apart), integers exactly.  The port's
CUDA strips (ty, tx) are varied independently of the reference's
``strip_rows``, which the port only validates: ragged last strips, ragged
last column bands and short quarter tails all occur.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdwt_tpu.ops.separable as js
import libdwt_tpu.ops.streamed as jst
from libdwt_torch.ops import fused as tf
from libdwt_torch.ops import streamed as ts

FTOL = 3e-5


def _leaves(t):
    if isinstance(t, (list, tuple)):
        return [x for s in t for x in _leaves(s)]
    return [t]


def _close(got, want, atol=FTOL):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if np.issubdtype(a.dtype, np.integer):
            assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _t(tree):
    """A JAX pytree as CPU tensors (tuples and lists kept)."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_t(s) for s in tree)
    return torch.from_numpy(np.array(tree))


def _rand(h, w, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-512, 512, (h, w)).astype(dtype)
    return rng.random((h, w), dtype=np.float32)


@pytest.fixture(autouse=True)
def _fresh():
    tf.reset_counters()


# (h, w, strip_rows, ty, tx): the reference's GEOMS (tests/test_streamed.py),
# ragged and short-tail strips included, each with a port strip of its own
GEOMS = [(256, 256, 64, 64, 64), (288, 128, 64, 32, 48), (260, 128, 64, 64, 64),
         (200, 128, 32, 16, 20), (204, 128, 64, 64, 64), (512, 384, 128, 128, 128)]


@pytest.mark.parametrize("h,w,ty_ref,ty,tx", GEOMS)
def test_b8_b10_match_reference(h, w, ty_ref, ty, tx):
    x = _rand(h, w, seed=h + w)
    want = jst.streamed_dwt2_2level(x, "cdf97", strip_rows=ty_ref, interpret=True)
    got = ts.streamed_dwt2_2level(torch.from_numpy(x), "cdf97", strip_rows=ty_ref,
                                  ty=ty, tx=tx)
    _close(got, want)
    rec_want = jst.streamed_idwt2_2level(*want, wavelet="cdf97", strip_rows=ty_ref,
                                         interpret=True, body="poly")
    rec = ts.streamed_idwt2_2level(*_t(want), "cdf97", strip_rows=ty_ref, ty=ty, tx=tx)
    _close(rec, rec_want)
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-5, rtol=0)
    assert {k: s.calls for k, s in tf.KERNELS.items() if s.calls} == {"B8": 1, "B10": 1}


@pytest.mark.parametrize("wavelet", ["cdf53", "haar"])
def test_b8_b10_int32_match_reference_exactly(wavelet):
    xi = _rand(200, 128, np.int32, seed=3)
    want = jst.streamed_dwt2_2level(xi, wavelet, strip_rows=64, interpret=True)
    got = ts.streamed_dwt2_2level(torch.from_numpy(xi), wavelet, strip_rows=64,
                                  ty=32, tx=48)
    _close(got, want)
    rec_want = jst.streamed_idwt2_2level(*want, wavelet=wavelet, strip_rows=64,
                                         interpret=True)
    rec = ts.streamed_idwt2_2level(*_t(want), wavelet, strip_rows=64, ty=32, tx=48)
    _close(rec, rec_want)
    assert np.array_equal(rec.numpy(), xi)


@pytest.mark.parametrize("h,w,level,ty_ref,ty,tx", [(256, 320, 4, 64, 64, 64),
                                                    (512, 384, 5, 128, 32, 48)])
def test_b11_b12_match_reference(h, w, level, ty_ref, ty, tx):
    x = _rand(h, w, seed=h + level)
    want = jst.streamed_wavedec2_deep(x, "cdf97", level, strip_rows=ty_ref,
                                      interpret=True)
    got = ts.streamed_wavedec2_deep(torch.from_numpy(x), "cdf97", level,
                                    strip_rows=ty_ref, ty=ty, tx=tx)
    _close(got, want)
    _close(got, js.wavedec2(x, "cdf97", level), 5e-5)
    rec_want = jst.streamed_waverec2_deep(want, "cdf97", strip_rows=ty_ref,
                                          interpret=True, body="poly")
    rec = ts.streamed_waverec2_deep(_t(want), "cdf97", strip_rows=ty_ref, ty=ty, tx=tx)
    _close(rec, rec_want)
    assert {k: s.calls for k, s in tf.KERNELS.items() if s.calls} == {"B11": 1, "B12": 1}


def test_b11_b12_int32_match_reference_exactly():
    xi = _rand(256, 320, np.int32, seed=4)
    want = jst.streamed_wavedec2_deep(xi, "cdf53", 4, strip_rows=64, interpret=True)
    got = ts.streamed_wavedec2_deep(torch.from_numpy(xi), "cdf53", 4, strip_rows=64,
                                    ty=32, tx=32)
    _close(got, want)
    rec = ts.streamed_waverec2_deep(_t(want), "cdf53", strip_rows=64, ty=32, tx=32)
    _close(rec, jst.streamed_waverec2_deep(want, "cdf53", strip_rows=64,
                                           interpret=True))
    assert np.array_equal(rec.numpy(), xi)


# ------------------------------------------------------------ geometry


def test_geometry_gates_match_reference():
    rows = range(64, 1200, 12)
    for h, sr in itertools.product(rows, (0, 32, 64, 66, 128, 250, 256, 480)):
        assert ts.pick_strip(h, sr or 256) == jst.pick_strip(h, sr or 256)
        assert ts.tail_aligned(h, ts.pick_strip(h, 256)) == jst.tail_aligned(
            h, jst.pick_strip(h, 256))
        for w, wv, levels in itertools.product((128, 130, 2050), ("cdf97", "d4"), (1, 2)):
            assert ts.streamed_supported((h, w), wv, sr, levels) == \
                jst.streamed_supported((h, w), wv, sr, levels), (h, w, wv, sr, levels)
    for h, w in ((256, 320), (1036, 128), (2144, 4096), (3200, 3200), (512, 64)):
        for level, itemsize in itertools.product(range(1, 9), (2, 4, 8)):
            assert ts.streamed_deep_ok((h, w), itemsize, "cdf97", level) == \
                jst.streamed_deep_ok((h, w), itemsize, "cdf97", level), (h, w, level)
    assert ts.streamed_deep_ok((2144, 4096), 4, "cdf97", 5)


def _both_raise(port_call, ref_call):
    with pytest.raises(ValueError):
        ref_call()
    with pytest.raises(ValueError):
        port_call()


@pytest.mark.parametrize("h,w,strip_rows", [(96, 128, 0), (130, 128, 0), (128, 130, 0),
                                            (16384, 128, 0), (72, 128, 0)])
def test_forward_geometry_raises_where_reference_raises(h, w, strip_rows):
    x = np.zeros((h, w), np.float32)
    _both_raise(lambda: ts.streamed_dwt2_2level(torch.from_numpy(x), strip_rows=strip_rows),
                lambda: jst.streamed_dwt2_2level(x, strip_rows=strip_rows, interpret=True))


def test_inverse_geometry_raises_where_reference_raises():
    # 96 rows: cy1 = 48 is not above the 48-row half-resolution window
    c = [np.zeros((24, 32), np.float32)] + [tuple(np.zeros(s, np.float32) for _ in range(3))
                                            for s in ((24, 32), (48, 64))]
    _both_raise(lambda: ts.streamed_idwt2_2level(*_t(c), "cdf97"),
                lambda: jst.streamed_idwt2_2level(*c, wavelet="cdf97", interpret=True))


def test_deep_geometry_raises_where_reference_raises():
    x = np.zeros((256, 320), np.float32)
    for level in (2, 7):  # too few levels, too many for the size
        _both_raise(lambda: ts.streamed_wavedec2_deep(torch.from_numpy(x), "cdf97", level),
                    lambda: jst.streamed_wavedec2_deep(x, "cdf97", level, interpret=True))
    big = np.zeros((3200, 3200), np.float32)  # LL2 past the resident limit
    _both_raise(lambda: ts.streamed_wavedec2_deep(torch.from_numpy(big), "cdf97", 3),
                lambda: jst.streamed_wavedec2_deep(big, "cdf97", 3, interpret=True))
    c = js.wavedec2(x, "cdf97", 6)  # coarsest LL 4x5: too small for its mirrors
    _both_raise(lambda: ts.streamed_waverec2_deep(_t(c), "cdf97"),
                lambda: jst.streamed_waverec2_deep(c, "cdf97", interpret=True))
    with pytest.raises(ValueError, match="unknown kernel body"):
        ts.streamed_dwt2_2level(torch.from_numpy(x), body="copy")


def test_deep_inverse_rejects_bad_pytree():
    x = _rand(256, 320, seed=13)
    c = js.wavedec2(x, "cdf97", 4)
    bad = [c[0], tuple(np.zeros((7, 9), np.float32) for _ in range(3))] + list(c[2:])
    _both_raise(lambda: ts.streamed_waverec2_deep(_t(bad), "cdf97"),
                lambda: jst.streamed_waverec2_deep(bad, "cdf97", interpret=True))
    # the good pytree reconstructs through the driver
    rec = ts.streamed_waverec2(_t(c), "cdf97")
    np.testing.assert_allclose(rec.numpy(), x, atol=5e-5, rtol=0)


def test_mxu_body_not_ported():
    """Formerly the refusal of the banded body; it is ported now (B13): an
    explicit body='mxu' runs it, and 'auto' stays 'poly' in the port where
    the reference takes its banded body at 4K."""
    x = torch.from_numpy(_rand(256, 256, seed=9))
    c = ts.streamed_dwt2_2level(x, body="mxu")
    rec = ts.streamed_idwt2_2level(*c, body="mxu")
    assert {k: s.calls for k, s in tf.KERNELS.items() if s.calls} == {
        "B8": 1, "B10": 1, "B13": 2}
    _close(c, js.wavedec2(x.numpy(), "cdf97", 2), 2e-4)
    np.testing.assert_allclose(rec.numpy(), x.numpy(), atol=2e-4, rtol=0)
    assert ts._resolve_inv_body("auto", "cdf97", torch.float32) == "poly"
    assert ts._resolve_inv_body("mxu", "cdf97", torch.float32) == "mxu"
    # the reference takes its banded body at this size; the port stays poly
    assert jst._resolve_inv_body("auto", "cdf97", jnp.float32, (2144, 4096)) == "mxu"


# (h, w, ty, tx, inverse ty, inverse tx): the strips of the card tests'
# STREAMED list (tests/test_torch_cuda.py), the first case's inverse on
# another strip, and strips with ty != tx both ways
PLAIN_STRIPS = [
    (260, 132, 64, 64, 32, 20),
    (260, 128, 64, 64, 64, 64),
    (204, 132, 32, 48, 32, 48),
    (512, 384, 128, 128, 128, 128),
    (256, 256, 64, 64, 64, 64),
    (200, 100, 16, 20, 16, 20),
    (200, 128, 64, 64, 64, 64),
    (288, 128, 16, 16, 16, 16),
    (260, 256, 32, 48, 48, 32),
]


@pytest.mark.parametrize("dtype,wavelet", [
    (np.float32, "cdf97"), (np.float64, "cdf97"), (np.int32, "cdf53"),
    (np.float32, "haar"), (np.float32, "interp53")])
@pytest.mark.parametrize("h,w,ty,tx,ity,itx", PLAIN_STRIPS)
def test_plain_strips_match_the_fused_tiles(h, w, ty, tx, ity, itx, dtype, wavelet):
    """B8/B10's plain versions and B2/B5's share one tile algebra; any strip,
    with the reference's 16-row TOP2 halo, gives B2/B5's values at their
    64x64 tiles and HALO2 rows bit for bit (the strips only move the halo),
    so the CUDA strips may take B2/B5's halos."""
    rng = np.random.default_rng(h + w + ty + tx)
    if dtype == np.int32:
        x = rng.integers(-512, 512, (h, w)).astype(np.int32)
    else:
        x = rng.random((h, w)).astype(dtype)
    x = torch.from_numpy(x)
    a = ts.streamed_dwt2_2level_plain(x, wavelet, ty, tx)
    b = tf.fused_dwt2_2level_plain(x, wavelet, 64)
    assert all(p.dtype == x.dtype and torch.equal(p, q) for p, q in zip(_leaves(a), _leaves(b)))
    back = ts.streamed_idwt2_2level_plain(*a, wavelet, ity, itx)
    assert torch.equal(back, tf.fused_idwt2_2level_plain(*a, wavelet, 64))


# (h, w, level, ty, tx): the strips of GEOMS and of the card tests'
# STREAMED_DEEP (tests/test_torch_cuda.py), each at level 3 or deeper
CHAIN = sorted({(h, w, 3, ty, tx) for h, w, _, ty, tx in GEOMS}
               | {(256, 320, 4, 64, 64), (512, 384, 5, 32, 32), (1036, 128, 3, 64, 64),
                  (260, 256, 3, 64, 48), (512, 384, 5, 32, 16), (512, 384, 5, 128, 128),
                  (260, 256, 3, 32, 48)})


def _leaves_of(tree):
    return [x for t in tree for x in (_leaves_of(t) if isinstance(t, (list, tuple)) else [t])]


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
@pytest.mark.parametrize("h,w,level,ty,tx", CHAIN)
def test_deep_plain_is_the_fused_chain(h, w, level, ty, tx, dtype):
    """B11 and B12 run B2's strip body then B3's deep levels (B6's levels
    then B5's body) on the card; their plain versions at any strip equal
    the fused plain pyramid bit for bit: B2 then B3 forward, B6 then B5
    inverse."""
    rng = np.random.default_rng(h + w + ty + tx)
    if dtype == np.int32:
        x, wavelet = rng.integers(-512, 512, (h, w)).astype(np.int32), "cdf53"
    else:
        x, wavelet = rng.random((h, w)).astype(dtype), "cdf97"
    x = torch.from_numpy(x)
    got = ts.streamed_wavedec2_deep_plain(x, wavelet, level, ty, tx)
    ll2, b2, b1 = tf.fused_dwt2_2level_plain(x, wavelet)
    want = tf.fused_deep_wavedec2_plain(ll2, wavelet, level - 2) + [b2, b1]
    assert len(_leaves_of(got)) == len(_leaves_of(want))
    assert all(a.dtype == x.dtype and torch.equal(a, b)
               for a, b in zip(_leaves_of(got), _leaves_of(want)))
    rec = ts.streamed_waverec2_deep_plain(got, wavelet, ty, tx)
    ll2 = tf.fused_deep_waverec2_plain(got[:-2], wavelet)
    assert torch.equal(rec, tf.fused_idwt2_2level_plain(ll2, got[-2], got[-1], wavelet))
