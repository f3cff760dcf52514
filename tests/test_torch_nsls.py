"""Port vs reference: the non-separable lifting level
(``libdwt_torch.ops.nsls``).

The same seeded numpy inputs go through ``libdwt_tpu.ops.nsls`` (under
``jax.jit``, one compiled call per case) and the port on the CPU.
Bounds against the reference: float64 1e-10, float32 3e-5 (single
levels).  Where the reference raises, the port raises the same class.
The cases follow tests/test_nsls.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdwt_tpu.ops.nsls as jn
import libdwt_torch.ops.nsls as tn
from libdwt_torch.ops.separable import dwt2_level, idwt2_level


def _data(shape, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=tol, rtol=0)


# forward: tiny sizes (the mirror pad wider than the image), odd, even,
# batched; inverse: bands above the channel mirror's CH samples
FWD_SHAPES = [(1, 6), (3, 2), (2, 5, 7), (16, 16), (33, 31)]
INV_SHAPES = [(16, 16), (33, 31), (2, 12, 20)]


@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53", "interp53"])
def test_nsls_forward_inverse_match_reference_f64(wavelet):
    xs = [_data(sh, np.float64, i) for i, sh in enumerate(FWD_SHAPES)]
    xi = [_data(sh, np.float64, 7 + i) for i, sh in enumerate(INV_SHAPES)]
    bands = [[b.numpy() for b in dwt2_level(torch.from_numpy(x), wavelet)] for x in xi]

    @jax.jit
    def ref(fwd_in, inv_in):
        return ([jn.nsls_dwt2_level(a, wavelet) for a in fwd_in],
                [jn.nsls_idwt2_level(*b, wavelet) for b in inv_in])

    want_f, want_i = ref([jnp.asarray(x) for x in xs],
                         [[jnp.asarray(b) for b in bs] for bs in bands])
    for x, want in zip(xs, want_f):
        got = tn.nsls_dwt2_level(torch.from_numpy(x), wavelet)
        _close(got, want, 1e-10)
        if min(x.shape[-2:]) >= 16:  # below, the mirror pad wraps around the image
            _close(got, dwt2_level(torch.from_numpy(x), wavelet), 1e-10)
    for x, bs, want in zip(xi, bands, want_i):
        got = tn.nsls_idwt2_level(*(torch.from_numpy(b) for b in bs), wavelet)
        _close([got], [want], 1e-10)
        np.testing.assert_allclose(got.numpy(), x, atol=1e-10, rtol=0)


def test_nsls_level_matches_reference_f32():
    x = _data((2, 64, 48), np.float32)

    @jax.jit
    def ref(a):
        bands = jn.nsls_dwt2_level(a, "cdf97")
        return bands, jn.nsls_idwt2_level(*bands, "cdf97")

    want_b, want_r = ref(jnp.asarray(x))
    got = tn.nsls_dwt2_level(torch.from_numpy(x), "cdf97")
    _close(got, want_b, 3e-5)
    rec = tn.nsls_idwt2_level(*got, "cdf97")
    _close([rec], [want_r], 3e-5)
    assert float((rec - torch.from_numpy(x)).abs().max()) < 1e-3
    want = idwt2_level(*got, "cdf97")
    np.testing.assert_allclose(rec.numpy(), want.numpy(), atol=3e-5, rtol=0)


def test_reflect_index_equals_numpy_reflect_pad():
    """The padding nsls builds from indices is numpy's mode='reflect' at
    every pad width, wider than the length included."""
    for n in range(1, 9):
        for before in range(0, 10):
            for after in range(0, 10, 3):
                idx = tn._mirror_index(torch.arange(-before, n + after), n).numpy()
                want = np.pad(np.arange(n), (before, after), mode="reflect")
                np.testing.assert_array_equal(idx, want)


def test_errors_match_the_reference():
    x = _data((16, 16), np.float64)
    for fwd in (jn.nsls_dwt2_level, tn.nsls_dwt2_level):
        with pytest.raises(ValueError, match="symmetric"):
            fwd(jnp.asarray(x) if fwd is jn.nsls_dwt2_level else torch.from_numpy(x), "d4")
    small = _data((8, 8), np.float32)
    bands = dwt2_level(torch.from_numpy(small), "cdf97")
    with pytest.raises(ValueError, match="bands"):
        jn.nsls_idwt2_level(*(jnp.asarray(b.numpy()) for b in bands), "cdf97")
    with pytest.raises(ValueError, match="bands"):
        tn.nsls_idwt2_level(*bands, "cdf97")
    with pytest.raises(ValueError, match="symmetric"):
        tn.nsls_idwt2_level(*dwt2_level(torch.from_numpy(x), "d4"), "d4")
