"""Port vs reference: the single fused 2-D levels B1 (fused_dwt2_level) and B4
(fused_idwt2_level).

On the CPU each wrapper runs its kernel's plain PyTorch version (the tile
decomposition of csrc/level.cu dwt_fwd1/dwt_inv1); it is held to the JAX
Pallas kernel run in interpret mode on the same seeded inputs, at the
sizes tests/test_fused.py uses: float32 to 3e-5, int32 bit-exactly.  A
tile of 8 (16 samples) makes several tiles, and short last tiles, out of
these small images.  The CUDA kernels are held against these plain
versions on the card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdwt_tpu.ops.fused as jf
from libdwt_tpu.utils.testimg import test_image as make_image
from libdwt_torch.ops import fused as tf

SIZES = [(32, 32), (64, 48), (100, 100), (101, 97), (130, 260), (33, 517)]
WAVELETS = ["cdf97", "cdf53", "interp53"]


def _close(got, want, exact=False, atol=3e-5):
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("wavelet", WAVELETS)
def test_b1_b4_plain_match_pallas(h, w, wavelet):
    x = make_image(h, w, dtype=np.float32)
    want = jf.fused_dwt2_level(jnp.asarray(x), wavelet, strip_rows=32, interpret=True)
    got = tf.fused_dwt2_level(torch.from_numpy(x), wavelet, tile=8)
    _close(got, want)
    want_rec = jf.fused_idwt2_level(*want, wavelet, strip_rows=32, interpret=True)
    _close(tf.fused_idwt2_level(*_t(want), wavelet, tile=8), want_rec)


@pytest.mark.parametrize("h,w", [(64, 48), (101, 97), (33, 517)])
@pytest.mark.parametrize("wavelet", ["cdf53", "cdf97"])
def test_b1_b4_plain_int_bitexact(h, w, wavelet):
    x = make_image(h, w, dtype=np.int32)
    want = jf.fused_dwt2_level(jnp.asarray(x), wavelet, strip_rows=32, interpret=True)
    got = tf.fused_dwt2_level(torch.from_numpy(x), wavelet, tile=8)
    _close(got, want, exact=True)
    rec = tf.fused_idwt2_level(*got, wavelet, tile=8)
    _close(rec, jf.fused_idwt2_level(*want, wavelet, strip_rows=32, interpret=True),
           exact=True)
    np.testing.assert_array_equal(rec.numpy(), x)


# ------------------------------------------------------- boundary_rows='extended'


@pytest.mark.parametrize("h,w", [(64, 96), (130, 260), (130, 97)])
@pytest.mark.parametrize("dtype,wavelet", [(np.float32, "cdf97"), (np.int32, "cdf53")])
def test_extended_rows_match_pallas(h, w, dtype, wavelet):
    rng = np.random.default_rng(h + w)
    if dtype == np.int32:
        xe = rng.integers(-255, 256, (h + 2 * tf.HALO, w)).astype(dtype)
    else:
        xe = rng.standard_normal((h + 2 * tf.HALO, w)).astype(dtype)
    exact = dtype == np.int32
    want = jf.fused_dwt2_level(jnp.asarray(xe), wavelet, boundary_rows="extended",
                               interpret=True)
    got = tf.fused_dwt2_level(torch.from_numpy(xe), wavelet, boundary_rows="extended",
                              tile=8)
    assert tuple(got[0].shape) == (h // 2, -(-w // 2))
    _close(got, want, exact)
    # every band with CH = 4 channel rows above and below
    cy, cx, fx = h // 2, -(-w // 2), w // 2
    shapes = [(cy, cx), (cy, fx), (cy, cx), (cy, fx)]
    bands = [rng.standard_normal((r + 2 * tf.CH, c)).astype(dtype) for r, c in shapes]
    want_rec = jf.fused_idwt2_level(*map(jnp.asarray, bands), wavelet,
                                    boundary_rows="extended", interpret=True)
    rec = tf.fused_idwt2_level(*_t(bands), wavelet, boundary_rows="extended", tile=8)
    assert tuple(rec.shape) == (h, w)
    _close(rec, want_rec, exact)


@pytest.mark.parametrize("h,w", [(65, 48), (131, 97)])
@pytest.mark.parametrize("dtype,wavelet", [(np.float32, "cdf97"), (np.int32, "cdf53")])
def test_extended_inverse_odd_rows_match_pallas(h, w, dtype, wavelet):
    """The inverse's extended contract on an odd height (ceil rows in LL
    and HL, floor rows in LH and HH, each with CH rows above and below)."""
    rng = np.random.default_rng(h * w)
    cy, fy, cx, fx = -(-h // 2), h // 2, -(-w // 2), w // 2
    shapes = [(cy, cx), (cy, fx), (fy, cx), (fy, fx)]
    if dtype == np.int32:
        bands = [rng.integers(-255, 256, (r + 2 * tf.CH, c)).astype(dtype) for r, c in shapes]
    else:
        bands = [rng.standard_normal((r + 2 * tf.CH, c)).astype(dtype) for r, c in shapes]
    want = jf.fused_idwt2_level(*map(jnp.asarray, bands), wavelet,
                                boundary_rows="extended", interpret=True)
    rec = tf.fused_idwt2_level(*_t(bands), wavelet, boundary_rows="extended", tile=8)
    assert tuple(rec.shape) == (h, w)
    _close(rec, want, dtype == np.int32)


def test_extended_rows_equal_mirror_when_given_the_mirror():
    x = torch.from_numpy(make_image(66, 70, dtype=np.float32))
    h = tf.HALO
    xe = torch.cat([x[1:h + 1].flip(0), x, x[-h - 1:-1].flip(0)])
    _close(tf.fused_dwt2_level(xe, boundary_rows="extended", tile=8),
           [b.numpy() for b in tf.fused_dwt2_level(x, tile=8)], exact=True)


# ------------------------------------------------------------- errors


@pytest.mark.parametrize("call,match", [
    (lambda m: m.fused_dwt2_level(m.zeros(64, 64), "cdf97", strip_rows=24), "multiple of 16"),
    (lambda m: m.fused_dwt2_level(m.zeros(4, 64), "cdf97"), "too small"),
    (lambda m: m.fused_dwt2_level(m.zeros(64, 4), "cdf97"), "too small"),
    (lambda m: m.fused_dwt2_level(m.zeros(73, 64), "cdf97", boundary_rows="extended"),
     "even row count"),
    (lambda m: m.fused_dwt2_level(m.zeros(64, 64), "cdf97", boundary_rows="wrap"),
     "boundary_rows"),
    (lambda m: m.fused_dwt2_level(m.zeros(2, 64, 64), "cdf97"), "2-D"),
    (lambda m: m.fused_dwt2_level(m.zeros(64, 64), "d4"), "asymmetric"),
    (lambda m: m.fused_idwt2_level(*(m.zeros(4, 4),) * 4, "cdf97"), "too small"),
    (lambda m: m.fused_idwt2_level(*(m.zeros(32, 32),) * 4, "cdf97", strip_rows=40),
     "multiple of 16"),
    (lambda m: m.fused_idwt2_level(*(m.zeros(32, 32),) * 4, "cdf97", boundary_rows="x"),
     "boundary_rows"),
])
def test_errors_match_reference(call, match):
    class Port:
        zeros = staticmethod(torch.zeros)
        fused_dwt2_level = staticmethod(tf.fused_dwt2_level)
        fused_idwt2_level = staticmethod(tf.fused_idwt2_level)

    class Ref:
        @staticmethod
        def zeros(*shape):
            return jnp.zeros(shape, jnp.float32)

        @staticmethod
        def fused_dwt2_level(*a, **k):
            return jf.fused_dwt2_level(*a, interpret=True, **k)

        @staticmethod
        def fused_idwt2_level(*a, **k):
            return jf.fused_idwt2_level(*a, interpret=True, **k)

    for m in (Ref, Port):
        with pytest.raises(ValueError, match=match):
            call(m)


def test_inverse_rejects_bands_of_two_levels():
    with pytest.raises(ValueError, match="one level"):
        tf.fused_idwt2_level(torch.zeros(32, 32), torch.zeros(32, 30),
                             torch.zeros(32, 32), torch.zeros(32, 32))
