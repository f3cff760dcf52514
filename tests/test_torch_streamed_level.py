"""Port vs reference: the single streamed 2-D levels (B7, B9).

The port's wrappers run their plain versions on CPU tensors; the JAX
package's streamed kernels run in interpret mode, as its own tests run
them.  Inputs come from a numpy seed.  float32 is held to 3e-5 per output
(the two round differently, about 1e-6 apart), integers exactly.  The
port's CUDA strips (ty, tx) are varied independently of the reference's
``strip_rows``, which the port only validates: ragged last strips, ragged
last column bands and short tails all occur.
"""
import numpy as np
import pytest
import torch

import libdwt_tpu.ops.separable as js
import libdwt_tpu.ops.streamed as jst
from libdwt_torch.ops import fused as tf
from libdwt_torch.ops import streamed as ts

FTOL = 3e-5


def _close(got, want, atol=FTOL):
    got = list(got) if isinstance(got, (list, tuple)) else [got]
    want = list(want) if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if np.issubdtype(a.dtype, np.integer):
            assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _t(bands):
    return [torch.from_numpy(np.array(b)) for b in bands]


def _rand(h, w, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-512, 512, (h, w)).astype(dtype)
    return rng.random((h, w), dtype=np.float32)


@pytest.fixture(autouse=True)
def _fresh():
    tf.reset_counters()


# (h, w, strip_rows, ty, tx): the reference's GEOMS (tests/test_streamed.py),
# ragged last strips (260, 200, 204 rows) and the short-tail cases included,
# then five of its seeded _FUZZ geometries; each with a port strip of its own
GEOMS = [(256, 256, 64, 64, 64), (288, 128, 64, 32, 48), (260, 128, 64, 64, 64),
         (200, 128, 32, 16, 20), (204, 128, 64, 64, 64), (512, 384, 128, 128, 128),
         (412, 134, 128, 64, 64), (234, 134, 176, 32, 48), (204, 220, 112, 16, 128),
         (154, 118, 96, 64, 32), (130, 220, 64, 32, 64)]


@pytest.mark.parametrize("h,w,ty_ref,ty,tx", GEOMS)
def test_b7_b9_match_reference(h, w, ty_ref, ty, tx):
    x = _rand(h, w, seed=h + w)
    want = jst.streamed_dwt2_level(x, "cdf97", strip_rows=ty_ref, interpret=True)
    got = ts.streamed_dwt2_level(torch.from_numpy(x), "cdf97", strip_rows=ty_ref,
                                 ty=ty, tx=tx)
    _close(got, want)
    rec_want = jst.streamed_idwt2_level(*want, wavelet="cdf97", strip_rows=ty_ref,
                                        interpret=True)
    rec = ts.streamed_idwt2_level(*_t(want), "cdf97", strip_rows=ty_ref, ty=ty, tx=tx)
    _close(rec, rec_want)
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-5, rtol=0)
    assert {k: s.calls for k, s in tf.KERNELS.items() if s.calls} == {"B7": 1, "B9": 1}


@pytest.mark.parametrize("wavelet", ["cdf53", "cdf97", "haar"])
def test_b7_b9_int32_match_reference_exactly(wavelet):
    xi = _rand(200, 128, np.int32, seed=3)
    want = jst.streamed_dwt2_level(xi, wavelet, strip_rows=32, interpret=True)
    got = ts.streamed_dwt2_level(torch.from_numpy(xi), wavelet, strip_rows=32,
                                 ty=32, tx=48)
    _close(got, want)
    _close(got, js.dwt2_level(xi, wavelet))
    rec = ts.streamed_idwt2_level(*_t(want), wavelet, strip_rows=32, ty=32, tx=48)
    _close(rec, jst.streamed_idwt2_level(*want, wavelet=wavelet, strip_rows=32,
                                         interpret=True))
    assert np.array_equal(rec.numpy(), xi)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_extended_rows_match_reference(dtype):
    """The 8-row (TOP) contract: x carries 8 valid rows above and below, and
    every band 8 valid channel rows; no row mirror is applied."""
    h, w = 256, 132
    wv = "cdf53" if dtype == np.int32 else "cdf97"
    xe = _rand(h + 2 * ts.TOP, w, dtype, seed=5)
    want = jst.streamed_dwt2_level(xe, wv, strip_rows=64, interpret=True,
                                   boundary_rows="extended")
    got = ts.streamed_dwt2_level(torch.from_numpy(xe), wv, strip_rows=64,
                                 boundary_rows="extended", ty=32, tx=48)
    _close(got, want)
    assert tuple(got[0].shape) == (h // 2, w // 2)
    be = [_rand(h // 2 + 2 * ts.TOP, w // 2, dtype, seed=6 + i) for i in range(4)]
    rec_want = jst.streamed_idwt2_level(*be, wavelet=wv, strip_rows=64, interpret=True,
                                        boundary_rows="extended")
    rec = ts.streamed_idwt2_level(*[torch.from_numpy(b) for b in be], wv, strip_rows=64,
                                  boundary_rows="extended", ty=16, tx=20)
    assert tuple(rec.shape) == (h, w)
    _close(rec, rec_want)


def test_extended_rows_of_a_real_image_match_the_mirror():
    """An image extended by its own whole-point mirror gives the mirror-mode
    bands; a wrong extension depth is taken silently, as the reference does."""
    x = _rand(256, 128, seed=7)
    ext = np.concatenate([x[8:0:-1], x, x[-2:-10:-1]])
    a = ts.streamed_dwt2_level(torch.from_numpy(ext), "cdf97", boundary_rows="extended")
    b = ts.streamed_dwt2_level(torch.from_numpy(x), "cdf97")
    _close(a, [p.numpy() for p in b], 0)
    short = np.concatenate([x[4:0:-1], x, x[-2:-6:-1]])  # 4 rows: the fused contract
    got = ts.streamed_dwt2_level(torch.from_numpy(short), "cdf97", boundary_rows="extended")
    assert tuple(got[0].shape) == (124, 64)
    want = jst.streamed_dwt2_level(short, "cdf97", interpret=True, boundary_rows="extended")
    _close(got, want)


def _both_raise(port_call, ref_call):
    with pytest.raises(ValueError):
        ref_call()
    with pytest.raises(ValueError):
        port_call()


@pytest.mark.parametrize("h,w,strip_rows", [(127, 128, 32), (128, 127, 32), (72, 128, 0),
                                            (64, 64, 0), (16384, 128, 0)])
def test_forward_geometry_raises_where_reference_raises(h, w, strip_rows):
    x = np.zeros((h, w), np.float32)
    _both_raise(lambda: ts.streamed_dwt2_level(torch.from_numpy(x), strip_rows=strip_rows),
                lambda: jst.streamed_dwt2_level(x, strip_rows=strip_rows, interpret=True))


def test_inverse_geometry_raises_where_reference_raises():
    ll = np.zeros((128, 64), np.float32)
    bad = np.zeros((96, 64), np.float32)
    _both_raise(lambda: ts.streamed_idwt2_level(*_t([ll, bad, ll, ll])),
                lambda: jst.streamed_idwt2_level(ll, bad, ll, ll, interpret=True))
    small = np.zeros((40, 64), np.float32)  # 80 rows: cy = 40 is not above tyw = 48
    _both_raise(lambda: ts.streamed_idwt2_level(*_t([small] * 4)),
                lambda: jst.streamed_idwt2_level(small, small, small, small,
                                                 interpret=True))
    x = np.zeros((256, 128), np.float32)
    _both_raise(lambda: ts.streamed_dwt2_level(torch.from_numpy(x), boundary_rows="top"),
                lambda: jst.streamed_dwt2_level(x, interpret=True, boundary_rows="top"))


def test_ragged_tail_taken_as_the_reference_interpret_mode_takes_it():
    """536 rows at strip_rows=256: a 24-row last strip that the reference's
    compiled path (and the dispatch gate) refuse and its interpret mode
    takes; the port's kernels take it too."""
    assert not ts.streamed_supported((536, 1024), "cdf97", 256, levels=1)
    x = _rand(536, 256, seed=9)
    got = ts.streamed_dwt2_level(torch.from_numpy(x), "cdf97", strip_rows=256)
    _close(got, jst.streamed_dwt2_level(x, "cdf97", strip_rows=256, interpret=True))


def test_plain_strips_match_the_fused_tiles():
    """B7/B9's plain versions and B1/B4's share one tile algebra; any strip
    gives the same values (the strips only move the halo)."""
    x = torch.from_numpy(_rand(260, 132, seed=8))
    a = ts.streamed_dwt2_level_plain(x, "cdf97", 64, 48)
    b = tf.dwt2_level_plain(x, "cdf97", 32)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    back = ts.streamed_idwt2_level_plain(*a, "cdf97", 16, 20)
    assert torch.equal(back, tf.idwt2_level_plain(*a, "cdf97", 32))
