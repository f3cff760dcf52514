"""Port vs reference: the single fused 2-D levels B1 (fused_dwt2_level) and B4
(fused_idwt2_level).

On the CPU each wrapper runs its kernel's plain PyTorch version (the tile
decomposition of csrc/level.cu dwt_fwd1/dwt_inv1); it is held to the JAX
Pallas kernel run in interpret mode on the same seeded inputs, at the
sizes tests/test_fused.py uses: float32 to 3e-5, int32 bit-exactly.  A
tile of 8 (16 samples) makes several tiles, and short last tiles, out of
these small images.  The CUDA kernels are held against these plain
versions on the card by tests/test_torch_cuda.py, bit for bit; the plain
versions give the same bits at every tile, so the kernel's tile need not
be the plain version's.
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


@pytest.mark.parametrize("h,w,dtype", [(101, 97, np.float32), (64, 48, np.float32),
                                     (101, 97, np.int32), (33, 517, np.int32)])
def test_b1_cpu_outputs_are_separate_bands(h, w, dtype):
    """On the CPU B1 returns four separate bands (writing one leaves the
    others as they were) at the ceil/floor band shapes, with the Pallas
    kernel's values."""
    x = make_image(h, w, dtype=dtype)
    wavelet = "cdf53" if dtype == np.int32 else "cdf97"
    got = tf.fused_dwt2_level(torch.from_numpy(x), wavelet)
    cy, cx, fy, fx = -(-h // 2), -(-w // 2), h // 2, w // 2
    assert [tuple(b.shape) for b in got] == [(cy, cx), (cy, fx), (fy, cx), (fy, fx)]
    assert all(b.device.type == "cpu" and b.dtype == got[0].dtype for b in got)
    want = jf.fused_dwt2_level(jnp.asarray(x), wavelet, strip_rows=32, interpret=True)
    _close(got, want, exact=dtype == np.int32)
    for k in range(4):
        others = [b.clone() for j, b in enumerate(got) if j != k]
        got[k].fill_(7)
        assert _same_bits([b for j, b in enumerate(got) if j != k], others)


def _seeded(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return torch.from_numpy(rng.integers(-255, 256, shape).astype(np.int32))
    return torch.from_numpy(rng.standard_normal(shape).astype(dtype))


def _same_bits(got, base):
    return all(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
               for a, b in zip(got, base))


#: odd and even sizes, mirror and extended rows, each dtype the kernels take
INVARIANT = [
    (64, 96, np.float32, "cdf97", False), (101, 97, np.float32, "cdf97", False),
    (75, 133, np.float64, "cdf97", False), (130, 97, np.int32, "cdf53", False),
    (101, 97, np.int32, "cdf97", False), (96, 72, np.float32, "haar", False),
    (70, 97, np.float32, "interp53", False), (130, 97, np.float32, "cdf97", True),
    (64, 96, np.float64, "cdf53", True), (130, 98, np.int32, "cdf53", True),
]


@pytest.mark.parametrize("h,w,dtype,wavelet,ext", INVARIANT)
def test_b1_plain_is_tile_invariant(h, w, dtype, wavelet, ext):
    """Every output of B1 depends only on its own neighbourhood, read at
    global positions (the extension's zero rows reach only outputs past
    the image), so any tile gives the same bits: the CUDA kernel may take
    any tile and must still equal the plain version exactly."""
    x = _seeded((h + (2 * tf.HALO if ext else 0), w), dtype, h * w)
    base = tf.dwt2_level_plain(x, wavelet, 8, ext)
    for tile in (16, 32, 64):
        assert _same_bits(tf.dwt2_level_plain(x, wavelet, tile, ext), base)


@pytest.mark.parametrize("h,w,dtype,wavelet,ext", INVARIANT + [
    (131, 97, np.float32, "cdf97", True), (65, 48, np.int32, "cdf53", True)])
def test_b4_plain_is_tile_invariant(h, w, dtype, wavelet, ext):
    """The same for B4, on seeded bands (with CH channel rows above and
    below each when extended; the inverse's contract takes odd heights)."""
    cy, cx, fy, fx = -(-h // 2), -(-w // 2), h // 2, w // 2
    e = 2 * tf.CH if ext else 0
    bands = [_seeded((r + e, c), dtype, h * w + i)
             for i, (r, c) in enumerate([(cy, cx), (cy, fx), (fy, cx), (fy, fx)])]
    base = tf.idwt2_level_plain(*bands, wavelet, 8, ext)
    assert tuple(base.shape) == (h, w)
    for tile in (16, 32, 64):
        assert _same_bits([tf.idwt2_level_plain(*bands, wavelet, tile, ext)], [base])


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
