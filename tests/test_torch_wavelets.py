"""Port vs reference: wavelet registry, subband geometry and test images.

``libdwt_torch`` keeps its own copies of these jax-free modules; every
field, size and rectangle must equal ``libdwt_tpu``'s.
"""
import dataclasses

import numpy as np
import pytest
import torch

import libdwt_tpu.models.wavelets as jw
import libdwt_tpu.utils.subband as jsb
import libdwt_tpu.utils.testimg as jti
import libdwt_torch.models.wavelets as tw
import libdwt_torch.utils.subband as tsb
import libdwt_torch.utils.testimg as tti

SIZES = [(1, 1), (2, 3), (5, 7), (16, 16), (17, 13), (33, 31), (64, 48), (2144, 4096)]


@pytest.mark.parametrize("name", sorted(jw.REGISTRY))
def test_registry_entry_matches_field_for_field(name):
    a, b = jw.REGISTRY[name], tw.REGISTRY[name]
    assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.has_int, a.n_steps, a.support) == (b.has_int, b.n_steps, b.support)
    assert [s.is_symmetric for s in a.steps] == [s.is_symmetric for s in b.steps]
    if a.int_steps is not None:
        assert [s.weights for s in a.int_steps] == [s.weights for s in b.int_steps]


def test_registry_names_and_constants():
    assert sorted(jw.REGISTRY) == sorted(tw.REGISTRY)
    for const in ("CDF97_P1", "CDF97_U1", "CDF97_P2", "CDF97_U2", "CDF97_S1",
                  "CDF97_S2", "CDF53_P1", "CDF53_U1", "CDF53_S1", "CDF53_S2"):
        assert getattr(jw, const) == getattr(tw, const)


def test_get_wavelet_resolves_and_rejects():
    assert tw.get_wavelet("CDF97") is tw.CDF97
    assert tw.get_wavelet(tw.HAAR) is tw.HAAR
    with pytest.raises(ValueError, match="unknown wavelet"):
        tw.get_wavelet("nope")


@pytest.mark.parametrize("h,w", SIZES)
def test_subband_geometry_matches(h, w):
    for n in (h, w):
        assert tsb.ceil_div2(n) == jsb.ceil_div2(n)
        assert tsb.floor_div2(n) == jsb.floor_div2(n)
        assert tsb.ceil_log2(n) == jsb.ceil_log2(n)
    for one in (False, True):
        assert tsb.j_limit(w, h, one) == jsb.j_limit(w, h, one)
        for j in (None, -1, 0, 1, 3, 99):
            assert tsb.resolve_j(h, w, j, one) == jsb.resolve_j(h, w, j, one)
    jmax = jsb.j_limit(w, h)
    assert tsb.level_sizes(h, w, jmax) == jsb.level_sizes(h, w, jmax)
    for j in range(0, jmax + 1):
        assert tsb.ceil_div_pow2(h, j) == jsb.ceil_div_pow2(h, j)
        assert tsb.count_subbands(h, w, j) == jsb.count_subbands(h, w, j)
        for band in ("LL", "HL", "LH", "HH"):
            if j == 0 and band != "LL":
                with pytest.raises(ValueError):
                    tsb.band_rect(h, w, j, band)
                continue
            assert tsb.band_rect(h, w, j, band) == jsb.band_rect(h, w, j, band)


def test_band_view_and_errors():
    a = np.arange(17 * 13, dtype=np.float32).reshape(17, 13)
    for band in ("LL", "HL", "LH", "HH"):
        np.testing.assert_array_equal(
            tsb.band_view(torch.from_numpy(a), 2, band).numpy(),
            np.asarray(jsb.band_view(a, 2, band)))
    with pytest.raises(ValueError, match="unknown band"):
        tsb.band_rect(8, 8, 1, "XX")


@pytest.mark.parametrize("n", [0, 1, 5, 8])
def test_zero_padding_matches(n):
    rng = np.random.default_rng(n)
    lo = rng.standard_normal((3, 6)).astype(np.float32)
    hi = rng.standard_normal((3, 6)).astype(np.float32)
    got = tsb.zero_padding_f(torch.from_numpy(lo), torch.from_numpy(hi), n)
    want = jsb.zero_padding_f(lo, hi, n)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tsb.zero_padding_i(torch.from_numpy(lo), n // 2 + 1).numpy(),
        np.asarray(jsb.zero_padding_i(lo, n // 2 + 1)))


@pytest.mark.parametrize("typ", [0, 2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_test_image_matches(typ, dtype):
    np.testing.assert_array_equal(tti.test_image(37, 41, type=typ, dtype=dtype),
                                  jti.test_image(37, 41, type=typ, dtype=dtype))


def test_psnr_and_compare_match():
    a = tti.test_image(32, 32)
    b = a + np.float32(1e-3) * np.arange(32, dtype=np.float32)[None, :]
    assert tti.psnr(a, b) == pytest.approx(jti.psnr(a, b))
    assert tti.psnr(torch.from_numpy(a), torch.from_numpy(b)) == pytest.approx(jti.psnr(a, b))
    assert tti.psnr(a, a) == float("inf")
    assert tti.max_abs_err(a, b) == jti.max_abs_err(a, b)
    assert tti.compare(a, b) == jti.compare(a, b)
    with pytest.raises(ValueError):
        tti.test_image(4, 4, type=1)
