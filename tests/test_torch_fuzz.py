"""Seeded fuzzing of the port over shapes, levels, wavelets and dtypes.

Modelled on tests/test_fuzz.py: arbitrary geometries (prime, odd, skewed,
5-200 a side, 1-5 levels, five wavelets) are where the ceil/floor halving
and the border logic hide faults.  At each seeded shape the port's
separable pyramid is held to ``libdwt_tpu``'s (under ``jax.jit``):
float32 within 5e-4, int32 exactly, and the port's reconstruction to the
input (float32 1e-3, int32 exactly); the port's packed and pytree layouts
carry the same coefficients; and the port's fused pyramid (the kernels'
plain versions on the CPU) is held to the port's oracle, including at
shapes where the reference's own fused inverse raises (130x130 J=5), but
for Haar, whose fused forward borders at odd lengths are the reference's
fused ones and not the oracle's (an open fault of both packages).
Where the reference refuses a fused call, the port refuses it with the
same error class.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdwt_tpu.api as japi
import libdwt_tpu.ops.separable as js
from libdwt_torch import api
from libdwt_torch.ops import separable as ts

WAVELETS = ["cdf97", "cdf53", "interp53", "haar", "d4"]
RNG = np.random.RandomState(20261017)
CASES = [(int(RNG.randint(5, 201)), int(RNG.randint(5, 201)), int(RNG.randint(1, 6)))
         for _ in range(19)] + [(130, 130, 5)]


def _leaves(t):
    if isinstance(t, (list, tuple)):
        return [x for s in t for x in _leaves(s)]
    return [t]


def _close(got, want, tol):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if tol == 0:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=tol, rtol=0)


@pytest.mark.parametrize("i,h,w,level", [(i,) + c for i, c in enumerate(CASES)])
def test_fuzz_port_vs_reference(i, h, w, level):
    wavelet = WAVELETS[i % len(WAVELETS)]
    int_ok = wavelet in ("cdf97", "cdf53", "haar")
    dtype = np.int32 if int_ok and i % 2 else np.float32
    rng = np.random.RandomState(h * 211 + w)
    x = (rng.randint(-30000, 30000, (h, w)).astype(np.int32) if dtype == np.int32
         else rng.randn(h, w).astype(np.float32))
    tol = 0 if dtype == np.int32 else 5e-4

    want = jax.jit(lambda a: js.wavedec2(a, wavelet, level))(jnp.asarray(x))
    t = torch.from_numpy(x)
    coeffs = ts.wavedec2(t, wavelet, level)
    rec = ts.waverec2(coeffs, wavelet)
    _close(coeffs, want, tol)
    if dtype == np.int32:
        assert torch.equal(rec, t)
    else:
        assert float((rec - t).abs().max()) <= 1e-3
    # pytree == packed: the same coefficients in the packed layout
    packed = ts.fdwt2(t, wavelet, level)
    ll = coeffs[0]
    assert torch.equal(packed[: ll.shape[0], : ll.shape[1]], ll)
    cy, cx = ll.shape
    for hl, lh, hh in coeffs[1:]:
        assert torch.equal(packed[:cy, cx : cx + hl.shape[1]], hl)
        assert torch.equal(packed[cy : cy + lh.shape[0], :cx], lh)
        assert torch.equal(packed[cy : cy + hh.shape[0], cx : cx + hh.shape[1]], hh)
        cy, cx = cy + lh.shape[0], cx + hl.shape[1]
    assert torch.equal(ts.idwt2(packed, wavelet, level), rec)

    # the fused pyramid, or the same refusal as the reference
    if min(h, w) < 32 or wavelet == "d4":
        with pytest.raises(ValueError):
            japi.wavedec2(x, wavelet, level, impl="fused")
        with pytest.raises(ValueError):
            api.wavedec2(t, wavelet, level, impl="fused")
        return
    fc = api.wavedec2(t, wavelet, level, impl="fused")
    frec = api.waverec2(fc, wavelet, impl="fused")
    if wavelet == "haar":
        # the fused kernels' mirror is not Haar's one-sided border at an odd
        # length, in both packages: hold the port to the reference's fused
        # pyramid, and its fused inverse to the oracle's on those coefficients
        _close(fc, japi.wavedec2(x, wavelet, level, impl="fused"), tol)
        _close([frec], [ts.waverec2(fc, wavelet)], tol)
    else:
        _close(fc, coeffs, tol)
        _close([frec], [rec], tol)
