"""Port vs reference: edge-avoiding wavelets (``libdwt_torch.ops.eaw``).

The same seeded numpy inputs go through ``libdwt_tpu.ops.eaw`` (under
``jax.jit``, one compiled call per case) and the port on the CPU.
Bounds against the reference: float32 3e-5 for the lifting steps and
5e-4 for the two-level ``eaw_wavedec2``/``eaw_waverec2``, float64 1e-10.
The weights w = 1/(|d|^alpha + 1e-5) are unboundedly sensitive where
|d| ~ 0, so they are compared as reciprocals (|d|^alpha + 1e-5), at the
same bounds.  The port is also held to the compiled C library's golden
vectors (``eaw53_*``, ``eaw97_*``, ``eawimg_*``, ``eawx_*``) at
tests/test_vs_reference.py's tolerances: 3e-5 and 5e-5 absolute, and
2e-5 relative on the weights.  The cases follow tests/test_eaw.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdwt_tpu.ops.eaw as je
import libdwt_torch.ops.eaw as te
from libdwt_torch.ops.lifting import lift_fwd

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")


def _data(shape, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(a, b, tol, weights=False):
    a, b = a.numpy(), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if weights:
        a, b = 1.0 / a, 1.0 / b
    np.testing.assert_allclose(a, b, atol=tol, rtol=0)


def test_weights_formula_and_border_patch():
    x = torch.tensor([0.0, 1.0, 3.0, 3.0], dtype=torch.float64)
    w = te.eaw_weights(x, alpha=1.0).numpy()
    np.testing.assert_allclose(w[:3], [1 / (1 + 1e-5), 1 / (2 + 1e-5), 1 / 1e-5], rtol=1e-12)
    assert w[3] == w[2]
    assert te.EPS == je.EPS


@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53"])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 3e-5), (np.float64, 1e-10)])
def test_eaw_lifting_matches_reference(wavelet, dtype, tol):
    """Lengths 1, 2, 8 and 37 along the last axis (alpha 0.8), a batch
    along axis 0 (alpha 1.2), and given weights."""
    xs = [_data((3, n), dtype, n) for n in (1, 2, 8, 37)]
    xb = _data((16, 3), dtype, 5)

    @jax.jit
    def ref(arrays, b):
        out = []
        for a in arrays:
            lo, hi, w = je.eaw_lift_fwd(a, wavelet, 0.8)
            out.append((lo, hi, w, je.eaw_lift_inv(lo, hi, w, wavelet)))
        lo, hi, w = je.eaw_lift_fwd(b, wavelet, 1.2, axis=0)
        out.append((lo, hi, w, je.eaw_lift_inv(lo, hi, w, wavelet, axis=0)))
        lo, hi, _ = je.eaw_lift_fwd(b, wavelet, 1.2, axis=0, weights=w * 2)
        out.append((lo, hi))
        return out

    want = ref([jnp.asarray(a) for a in xs], jnp.asarray(xb))
    for x, (lo, hi, w, rec) in zip(xs, want):
        g = te.eaw_lift_fwd(torch.from_numpy(x), wavelet, 0.8)
        _close(g[0], lo, tol)
        _close(g[1], hi, tol)
        if x.shape[-1] > 1:
            _close(g[2], w, tol, weights=True)
        _close(te.eaw_lift_inv(*g, wavelet), rec, tol)
        np.testing.assert_allclose(rec, x, atol=1e-10 if dtype == np.float64 else 1e-5)
    g = te.eaw_lift_fwd(torch.from_numpy(xb), wavelet, 1.2, axis=0)
    for a, b in zip(g, want[-2][:2]):
        _close(a, b, tol)
    _close(g[2], want[-2][2], tol, weights=True)
    _close(te.eaw_lift_inv(*g, wavelet, axis=0), want[-2][3], tol)
    gw = te.eaw_lift_fwd(torch.from_numpy(xb), wavelet, 1.2, axis=0, weights=g[2] * 2)
    for a, b in zip(gw, want[-1]):
        _close(a, b, tol)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 5e-4), (np.float64, 1e-10)])
def test_eaw_wavedec2_waverec2_match_reference(dtype, tol):
    x = _data((2, 33, 31), dtype)

    @jax.jit
    def ref(a):
        coeffs, wts = je.eaw_wavedec2(a, "cdf97", 2, alpha=0.8)
        return coeffs, wts, je.eaw_waverec2(coeffs, wts, "cdf97")

    coeffs, wts, rec = ref(jnp.asarray(x))
    gc, gw = te.eaw_wavedec2(torch.from_numpy(x), "cdf97", 2, alpha=0.8)
    assert len(gc) == len(coeffs) == 3 and len(gw) == len(wts) == 2
    _close(gc[0], coeffs[0], tol)
    for lvl, want in zip(gc[1:], coeffs[1:]):
        for a, b in zip(lvl, want):
            _close(a, b, tol)
    for lvl, want in zip(gw, wts):  # coarse first in both
        for a, b in zip(lvl, want):
            _close(a, b, tol, weights=True)
    grec = te.eaw_waverec2(gc, gw, "cdf97")
    _close(grec, rec, tol)
    np.testing.assert_allclose(grec.numpy(), x, atol=1e-9 if dtype == np.float64 else 1e-4)


def test_alpha_zero_equals_plain_lifting():
    x = torch.from_numpy(_data((17,), np.float64))
    for wavelet in ("cdf97", "cdf53"):
        lo, hi, _ = te.eaw_lift_fwd(x, wavelet, alpha=0.0)
        want = lift_fwd(x, wavelet)
        np.testing.assert_allclose(lo.numpy(), want[0].numpy(), atol=1e-12)
        np.testing.assert_allclose(hi.numpy(), want[1].numpy(), atol=1e-12)


def test_asymmetric_wavelets_raise_like_the_reference():
    x = _data((32, 32), np.float32)
    for wav in ("d4", "haar"):
        with pytest.raises(ValueError, match="symmetric"):
            je.eaw_wavedec2(jnp.asarray(x), wav, 1)
        with pytest.raises(ValueError, match="symmetric"):
            te.eaw_wavedec2(torch.from_numpy(x), wav, 1)
        with pytest.raises(ValueError, match="symmetric"):
            te.eaw_lift_inv(torch.zeros(4), torch.zeros(4), torch.ones(8), wav)


# ------------------------------------------------------------------ golden


@pytest.fixture(scope="module")
def g():
    if not os.path.exists(GOLDEN):
        pytest.skip("golden vectors not generated")
    return np.load(GOLDEN)


@pytest.mark.parametrize("n", [8, 15, 16, 17, 64, 100])
def test_eaw_forward_matches_golden(g, n):
    """Weighted lifting vs libdwt's dwt_eaw97/53_f_ex_stride_s, alpha=0.8."""
    x = torch.from_numpy(g[f"eawx_f32_{n}"][0])
    for wavelet, key in (("cdf97", f"eaw97_f32_{n}"), ("cdf53", f"eaw53_f32_{n}")):
        lo, hi, w = te.eaw_lift_fwd(x, wavelet, alpha=0.8)
        np.testing.assert_allclose(lo.numpy(), g[f"{key}_L"][0], atol=3e-5, rtol=0)
        np.testing.assert_allclose(hi.numpy(), g[f"{key}_H"][0], atol=3e-5, rtol=0)
        if f"{key}_W" in g:
            # libdwt leaves w[N-1] unset; the port patches it: compare N-1
            np.testing.assert_allclose(w.numpy()[: n - 1], g[f"{key}_W"][0][: n - 1],
                                       rtol=2e-5)


@pytest.mark.parametrize("ny,nx", [(16, 16), (32, 24)])
def test_eaw97_2d_matches_golden(g, ny, nx):
    """The 2-D EAW MRA vs dwt_eaw97_2f_s (packed layout, per-level wH/wV),
    and the inverse with the port's weights vs dwt_eaw97_2i_s."""
    key = f"eaw97_2f_f32_{ny}x{nx}_j2"
    img = torch.from_numpy(g[f"eawimg_f32_{ny}x{nx}"])
    coeffs, wts = te.eaw_wavedec2(img, "cdf97", 2, alpha=0.8)
    cur = coeffs[0].numpy()
    for hl, lh, hh in coeffs[1:]:
        cur = np.concatenate([np.concatenate([cur, hl.numpy()], axis=1),
                              np.concatenate([lh.numpy(), hh.numpy()], axis=1)], axis=0)
    np.testing.assert_allclose(cur, g[key], atol=5e-5, rtol=0)
    for lvl in range(2):
        wh, wv = wts[len(wts) - 1 - lvl]  # coarse first
        np.testing.assert_allclose(1.0 / wh.numpy()[:, :-1], 1.0 / g[f"{key}_wH{lvl}"][:, :-1],
                                   atol=2e-5)
        np.testing.assert_allclose(1.0 / wv.numpy().T[:, :-1],
                                   1.0 / g[f"{key}_wV{lvl}"][:, :-1], atol=2e-5)
    rec = te.eaw_waverec2(coeffs, wts, "cdf97")
    np.testing.assert_allclose(rec.numpy(), g[f"eaw97_2i_f32_{ny}x{nx}_j2"], atol=5e-5, rtol=0)
