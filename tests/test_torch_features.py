"""Port vs reference: band features, thresholds and ``denoise2``
(``libdwt_torch.ops.features``).

The same seeded numpy inputs go through ``libdwt_tpu.ops.features`` (under
``jax.jit``) and the port on the CPU.  Bounds against the reference:
``band_med`` and ``band_maxidx`` exact; the float64 statistics 1e-10,
relative where a statistic's magnitude runs large (``wps``, the
lp norms); ``denoise2`` in float32 5e-4 in both modes.  The port's
``impl='fused'`` ``denoise2`` (the kernels' plain versions on the CPU)
is held to its own separable result.  The cases follow
tests/test_features.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdwt_tpu.ops.features as jfe
import libdwt_torch.ops.features as tfe
from libdwt_torch.ops import fused as tfu
from libdwt_torch.ops.separable import fdwt2
from libdwt_torch.utils.testimg import test_image as make_test_image


def _data(shape, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


STATS = ["band_wps", "band_mean", "band_var", "band_stdev", "band_skew", "band_kurt",
         "band_maxnorm", "band_norm", "band_med", "band_maxidx"]


@pytest.mark.parametrize("shape", [(16, 24), (2, 7, 9)])
def test_band_statistics_match_reference_f64(shape):
    """Even and odd band sizes, batched; lp norms at p = 0.5, 3 and inf."""
    a = _data(shape, np.float64, sum(shape))

    @jax.jit
    def ref(x):
        out = {k: getattr(jfe, k)(x) for k in STATS}
        out["band_wps2"] = jfe.band_wps(x, 2)
        out["band_moment3"] = jfe.band_moment(x, 3, 0.5)
        out.update({f"lp{p}": jfe.band_lpnorm(x, p) for p in (0.5, 3.0, float("inf"))})
        return out

    want = ref(jnp.asarray(a))
    t = torch.from_numpy(a)
    got = {k: getattr(tfe, k)(t) for k in STATS}
    got["band_wps2"] = tfe.band_wps(t, 2)
    got["band_moment3"] = tfe.band_moment(t, 3, 0.5)
    got.update({f"lp{p}": tfe.band_lpnorm(t, p) for p in (0.5, 3.0, float("inf"))})
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in ("band_med", "band_maxidx"):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=1e-10, rtol=1e-10)


def test_band_med_and_maxidx_conventions():
    """sorted[size//2] (torch.median takes the lower middle for even
    sizes) and the first maximum magnitude on ties."""
    a = torch.tensor([[4.0, 1.0, 3.0, 2.0]], dtype=torch.float32)
    assert float(tfe.band_med(a)) == 3.0 and float(torch.median(a)) == 2.0
    assert float(tfe.band_med(a[:, :3])) == 3.0
    b = torch.tensor([[1.0, -5.0], [5.0, 2.0]])
    assert float(tfe.band_maxidx(b)) == 1.0 and tfe.band_maxidx(b).dtype == torch.float32
    xi = _data((9, 10), np.float32)
    want = jax.jit(lambda x: (jfe.band_med(x), jfe.band_maxidx(x)))(jnp.asarray(xi))
    got = (tfe.band_med(torch.from_numpy(xi)), tfe.band_maxidx(torch.from_numpy(xi)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_features_and_threshold_match_reference_f64():
    """Every FEATURES entry over j = 1..3 of a packed 4-level transform,
    a transform too shallow for any band, and the universal threshold."""
    x = make_test_image(64, 48, dtype=np.float64) + 0.1 * _data((64, 48), np.float64)
    a = fdwt2(torch.from_numpy(x), "cdf97", 4).numpy()
    assert sorted(tfe.FEATURES) == sorted(jfe.FEATURES)

    @jax.jit
    def ref(p):
        return ({k: jfe.features(p, 4, k) for k in jfe.FEATURES},
                jfe.features(p, 1, "mean"), jfe.estimate_threshold(p))

    feats, empty, lam = ref(jnp.asarray(a))
    t = torch.from_numpy(a)
    for k, w in feats.items():
        g = tfe.features(t, 4, k).numpy()
        assert g.shape == np.asarray(w).shape == (9,)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-10, rtol=1e-10)
    assert tuple(tfe.features(t, 1, "mean").shape) == np.asarray(empty).shape == (0,)
    np.testing.assert_allclose(tfe.estimate_threshold(t).numpy(), np.asarray(lam),
                               atol=1e-10, rtol=1e-10)


def test_thresholds_match_reference():
    a = np.array([-3.0, -1.0, 0.5, 1.0, 2.0], np.float32)
    for mode in ("soft", "hard"):
        want = getattr(jfe, f"{mode}_threshold")(jnp.asarray(a), 1.0)
        got = getattr(tfe, f"{mode}_threshold")(torch.from_numpy(a), 1.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tfe.soft_threshold(a, 1.0, device="cpu").numpy(),
                                  [-2.0, 0.0, 0.0, 0.0, 1.0])


@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_denoise2_matches_reference(mode):
    clean = make_test_image(64, 80, dtype=np.float32)
    noisy = clean + 0.2 * _data((64, 80), np.float32, 11)
    want = jax.jit(lambda x: jfe.denoise2(x, "cdf97", 3, mode, impl="separable"))(
        jnp.asarray(noisy))
    got = tfe.denoise2(torch.from_numpy(noisy), "cdf97", 3, mode, impl="separable")
    assert got.dtype == torch.float32 and tuple(got.shape) == noisy.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)
    assert ((got.numpy() - clean) ** 2).mean() < ((noisy - clean) ** 2).mean()


@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_denoise2_fused_equals_separable(mode):
    """impl='fused' runs the pyramid kernels (their plain versions on the
    CPU) and gives the separable result."""
    x = torch.from_numpy(make_test_image(96, 128, dtype=np.float32)
                         + 0.2 * _data((96, 128), np.float32, 3))
    tfu.reset_counters()
    got = tfe.denoise2(x, "cdf97", 4, mode, impl="fused")
    calls = {k: s.calls for k, s in tfu.KERNELS.items() if s.calls}
    assert calls and set(calls) <= {"B1", "B2", "B3", "B4", "B5", "B6"}, calls
    want = tfe.denoise2(x, "cdf97", 4, mode, impl="separable")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-4, rtol=0)
