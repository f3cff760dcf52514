"""Port vs reference: strided convolution and the stationary transform
(``libdwt_torch.ops.conv``, ``libdwt_torch.ops.swt``).

The same seeded numpy inputs go through ``libdwt_tpu`` (under
``jax.jit``, one compiled call per case) and the port on the CPU.
Bounds against the reference: ``find_max_pos`` exact, float64 1e-10,
float32 3e-5 for ``swt_level`` and 5e-4 for the multi-level ``swt2``.
The port is also held to the compiled C library's golden vectors
(``swt53_*``, ``swt97_*`` from ``swtx_*``) at tests/test_vs_reference.py's
2e-5.  The cases follow tests/test_swt.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdwt_tpu.ops.conv as jc
import libdwt_tpu.ops.swt as js
import libdwt_torch.ops.conv as tc
import libdwt_torch.ops.swt as ts

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")

# libdwt's hardcoded filter banks (swt.c)
REF_TAPS = {
    "cdf97": ([+0.03782846, -0.02384947, -0.11062438, +0.37740287, +0.85269880,
               +0.37740287, -0.11062438, -0.02384947, +0.03782846],
              [+0.06453887, -0.04068942, -0.41809219, +0.78848559, -0.41809219,
               -0.04068942, +0.06453887]),
    "cdf53": ([-0.17677669, +0.35355338, +1.06066012, +0.35355338, -0.17677669],
              [-0.35355338, +0.70710677, -0.35355338]),
}


def _data(shape, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


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
        np.testing.assert_allclose(a, b, atol=tol, rtol=0)


# ------------------------------------------------------------------- conv


def test_convolve1_matches_reference_and_bruteforce():
    """The reference's saturated triple loop, and the reference, for every
    (downsample, upsample) pair, on a batch along axis 0 too."""
    x = _data((23,), np.float64)
    g = _data((5,), np.float64, 1)
    xb = _data((23, 3), np.float64, 2)
    pairs = [(1, 1), (1, 2), (1, 4), (2, 1), (3, 2)]

    @jax.jit
    def ref(a, k, b):
        return ([jc.convolve1(a, k, downsample=dn, upsample=up) for dn, up in pairs]
                + [jc.convolve1(b, k, y_size=9, y_center=2, x_center=5, g_center=1,
                                upsample=2, axis=0)])

    want = ref(jnp.asarray(x), jnp.asarray(g), jnp.asarray(xb))
    got = [tc.convolve1(torch.from_numpy(x), torch.from_numpy(g), downsample=dn, upsample=up)
           for dn, up in pairs]
    got.append(tc.convolve1(torch.from_numpy(xb), g, y_size=9, y_center=2, x_center=5,
                            g_center=1, upsample=2, axis=0))
    _close(got, want, 1e-10)
    n, m = len(x), len(g)
    for (down, up), y in zip(pairs, got):
        brute = np.zeros(n)
        for yi in range(-(n // 2), n - n // 2):
            for gi in range(-(m // 2), m - m // 2):
                xi = np.clip(down * yi - up * gi + n // 2, 0, n - 1)
                brute[yi + n // 2] += x[xi] * g[gi + m // 2]
        np.testing.assert_allclose(y.numpy(), brute, atol=1e-12)


def test_find_max_pos_first_maximum_exact():
    a = np.zeros((3, 5, 7), np.float32)
    a[0, 3, 2] = 9.0
    a[1, 1, 4] = a[1, 2, 0] = a[1, 4, 6] = 5.0  # ties: the first in raster order
    a[2] = _data((5, 7), np.float32)
    want = jax.jit(jc.find_max_pos)(jnp.asarray(a))
    got = tc.find_max_pos(torch.from_numpy(a))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert [int(v[1]) for v in got[1:]] == [1, 4]


# -------------------------------------------------------------------- swt


@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53", "interp53"])
def test_analysis_filters_match_reference(wavelet):
    g, h, gc, hc = ts.analysis_filters(wavelet)
    rg, rh, rgc, rhc = js.analysis_filters(wavelet)
    assert (gc, hc) == (rgc, rhc) and g.dtype == h.dtype == np.float64
    np.testing.assert_allclose(g, rg, atol=1e-15, rtol=0)
    np.testing.assert_allclose(h, rh, atol=1e-15, rtol=0)
    if wavelet in REF_TAPS:
        np.testing.assert_allclose(g, REF_TAPS[wavelet][0], atol=1e-7)
        np.testing.assert_allclose(h, REF_TAPS[wavelet][1], atol=1e-7)
        assert (gc, hc) == (len(g) // 2, len(h) // 2)


@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53"])
def test_swt_level_matches_reference_f32(wavelet):
    """Levels 0-2 along the last axis and along axis -2 of a batch."""
    x = _data((3, 40, 37), np.float32)

    @jax.jit
    def ref(a):
        return [js.swt_level(a, wavelet, level=lvl, axis=ax)
                for lvl in (0, 1, 2) for ax in (-1, -2)]

    want = ref(jnp.asarray(x))
    got = [ts.swt_level(torch.from_numpy(x), wavelet, level=lvl, axis=ax)
           for lvl in (0, 1, 2) for ax in (-1, -2)]
    _close(got, want, 3e-5)


@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53"])
def test_swt1_iswt1_match_reference_f64(wavelet):
    x = _data((2, 256), np.float64)
    xa = _data((64, 3), np.float64, 1)

    @jax.jit
    def ref(a, b):
        out = []
        for level in (1, 3):
            c = js.swt1(a, wavelet, level)
            out.append((c, js.iswt1(c, wavelet)))
        c = js.swt1(b, wavelet, 2, axis=0)
        out.append((c, js.iswt1(c, wavelet, axis=0)))
        return out

    want = ref(jnp.asarray(x), jnp.asarray(xa))
    got = []
    for level in (1, 3):
        c = ts.swt1(torch.from_numpy(x), wavelet, level)
        got.append((c, ts.iswt1(c, wavelet)))
    c = ts.swt1(torch.from_numpy(xa), wavelet, 2, axis=0)
    got.append((c, ts.iswt1(c, wavelet, axis=0)))
    _close(got, want, 1e-10)
    # the interior reconstructs (the SWT clamps borders, the DWT mirrors)
    m = 16 * 8
    np.testing.assert_allclose(got[1][1].numpy()[:, m:-m], x[:, m:-m], atol=1e-9)


@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53"])
def test_swt2_iswt2_match_reference_f32(wavelet):
    x = _data((64, 48), np.float32)

    @jax.jit
    def ref(a):
        c = js.swt2(a, wavelet, 3)
        return c, js.iswt2(c, wavelet)

    want = ref(jnp.asarray(x))
    c = ts.swt2(torch.from_numpy(x), wavelet, 3)
    got = (c, ts.iswt2(c, wavelet))
    _close(got, want, 5e-4)
    assert all(tuple(a.shape) == x.shape for a in _leaves(got))


def test_iswt_rejects_nondivisible_length_like_the_reference():
    x = _data((30,), np.float32)
    with pytest.raises(ValueError, match="divisible"):
        js.iswt1(js.swt1(jnp.asarray(x), "cdf97", 2), "cdf97")
    with pytest.raises(ValueError, match="divisible"):
        ts.iswt1(ts.swt1(torch.from_numpy(x), "cdf97", 2), "cdf97")
    with pytest.raises(ValueError, match="divisible"):
        ts.iswt2(ts.swt2(torch.from_numpy(_data((12, 16), np.float32)), "cdf53", 3), "cdf53")


# ------------------------------------------------------------------ golden


@pytest.fixture(scope="module")
def g():
    if not os.path.exists(GOLDEN):
        pytest.skip("golden vectors not generated")
    return np.load(GOLDEN)


@pytest.mark.parametrize("n", [8, 15, 16, 17, 64, 100])
@pytest.mark.parametrize("wavelet,tag", [("cdf97", "swt97"), ("cdf53", "swt53")])
def test_swt_level_matches_golden(g, n, wavelet, tag):
    """À-trous filtering vs libdwt's swt_cdf97/53_f_ex_stride_s, levels 0-2."""
    x = torch.from_numpy(g[f"swtx_f32_{n}"][0])
    for level in (0, 1, 2):
        key = f"{tag}_f32_{n}_l{level}"
        lo, hi = ts.swt_level(x, wavelet, level=level)
        np.testing.assert_allclose(lo.numpy(), g[f"{key}_L"][0], atol=2e-5, rtol=0)
        np.testing.assert_allclose(hi.numpy(), g[f"{key}_H"][0], atol=2e-5, rtol=0)
