"""Port vs reference: time-frequency analysis (``libdwt_torch.ops.gabor``).

The same seeded numpy inputs go through ``libdwt_tpu.ops.gabor`` (under
``jax.jit``, one compile per case) and the port on the CPU.  Bounds: the
host-side atoms, window sizes and test signals bit for bit; the TF planes'
magnitude within 1e-5 absolute and their phase within 1e-4 (wrapped),
exact at bin 0, where the imaginary bank is all zero and the phase is 0
or pi by the sign of zero; the ridge detectors and ``strongest_ridges``,
fed the same numpy plane, exactly equal.  The cases follow
tests/test_gabor.py.
"""
import math

import jax
import numpy as np
import pytest
import torch

from libdwt_tpu.ops import gabor as J
from libdwt_torch.ops import gabor as T

MAG_TOL = 1e-5
PHASE_TOL = 1e-4


def _jit(fn, x, *static, **kw):
    return np.asarray(jax.jit(lambda a: fn(a, *static, **kw))(x))


def _wrapped(a, b):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64) - np.asarray(b, np.float64)))))


# ------------------------------------------------------ host-side values


@pytest.mark.parametrize("name,args", [
    ("gabor_atom", (np.linspace(-3, 3, 13), 0.3, 0.7)),
    ("gabor_function", (np.arange(-8, 9), 2.5, 1.1)),
    ("gabor_wavelet", (np.arange(-20, 21), 1.5, 0.8, 2.5)),
    ("gabor_freq", (math.pi, 2.0)),
    ("gabor_scale", (math.pi / 2, math.pi / 4)),
    ("gaussian_limit", (2.0, 1.5)),
    ("gaussian_size", (2.0, 1.0)),
    ("gaussian_size", (1.0, 3.0)),
    ("gaussian_center", (181.02, 1.0)),
    ("s_sigma", (1 / 256,)),
])
def test_host_values_bit_for_bit(name, args):
    got, want = getattr(T, name)(*args), getattr(J, name)(*args)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert type(got) is type(want)


def test_atom_formula_and_window_rule():
    """gabor_atom = sqrt(a/pi) e^{-a t^2} e^{+i w t} (gabor.c:8-21);
    size = ceil(1 + 2*4*sigma*a), center = size//2 (gabor.c:70-93)."""
    v = T.gabor_atom(1.5, alpha=0.3, omega=0.7)
    want = math.sqrt(0.3 / math.pi) * math.exp(-0.3 * 1.5**2) * np.exp(1j * 0.7 * 1.5)
    assert abs(v - want) < 1e-12
    assert T.gaussian_size(2.0, 1.0) == math.ceil(1 + 16.0)
    assert T.gaussian_center(2.0, 1.0) == T.gaussian_size(2.0, 1.0) // 2


@pytest.mark.parametrize("size", [64, 100, 129])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 7, 8])
def test_test_signal_bit_for_bit(size, kind):
    got = T.test_signal(size, kind)
    assert got.dtype == np.float32 and got.shape == (size,)
    np.testing.assert_array_equal(got, J.test_signal(size, kind))


def test_test_signal_sigma_integer_division():
    # C int division for sigma (gabor.c:498): size=100 uses sigma=12
    i = np.arange(100, dtype=np.float64)
    want = np.real(T.gabor_function(i - 50, 100 // 8, 0.5))
    np.testing.assert_array_equal(T.test_signal(100, 7), want.astype(np.float32))
    with pytest.raises(ValueError):
        T.test_signal(64, 5)


# ------------------------------------------------------------- TF planes


def _brute_plane(sig, kernels):
    """Direct cdot1_s loop (gabor.c:105-160) for small cases."""
    n = len(sig)
    plane = np.zeros((len(kernels), n), np.float64)
    for b, (taps, kc) in enumerate(kernels):
        k = len(taps)
        for i in range(n):
            s = 0.0 + 0j
            for t in range(-min(i, kc), min(n - 1 - i, k - 1 - kc) + 1):
                s += sig[i + t] * np.conj(taps[kc + t])
            plane[b, i] = abs(s)
    return plane


def test_tf_plane_matches_bruteforce_and_reference():
    sig = np.random.RandomState(0).randn(40)
    sigma = 2.0
    kernels = []
    for y in range(8):
        size, c = T.gaussian_size(sigma, 1.0), T.gaussian_center(sigma, 1.0)
        kernels.append((T.gabor_wavelet(np.arange(size) - c, sigma, y / 8 * math.pi, 1.0), c))
    got = T.gabor_ft(sig, 8, sigma, device="cpu")
    assert got.dtype == torch.float32  # float64 in, float32 plane out, as the reference
    np.testing.assert_allclose(got.numpy(), _brute_plane(sig, kernels)[::-1, :], atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _jit(J.gabor_ft, sig, 8, sigma), atol=MAG_TOL, rtol=0)


SIGNALS = {
    "randn": lambda: np.random.RandomState(3).randn(128).astype(np.float32),
    "chirp": lambda: T.test_signal(128, 2),
    "two-tone": lambda: T.test_signal(128, 0),
    "batched": lambda: np.random.RandomState(5).randn(3, 64).astype(np.float32),
}
PLANES = {
    "ft": (T.gabor_ft, J.gabor_ft, (16, 4.0)),
    "wt": (T.gabor_wt, J.gabor_wt, (16, 2.0, math.pi / 2)),
    "st": (T.gabor_st, J.gabor_st, (16,)),
}


@pytest.mark.parametrize("signal", sorted(SIGNALS))
@pytest.mark.parametrize("plane", sorted(PLANES))
def test_planes_match_reference(plane, signal):
    """Magnitude and phase of each TF plane against the reference."""
    tf, jf, args = PLANES[plane]
    sig = SIGNALS[signal]()
    mag = tf(sig, *args, device="cpu")
    arg = tf(sig, *args, out="arg", device="cpu")
    want_mag = _jit(jf, sig, *args)
    want_arg = _jit(jf, sig, *args, out="arg")
    assert mag.shape == want_mag.shape == sig.shape[:-1] + (16, sig.shape[-1])
    assert mag.dtype == arg.dtype == torch.float32
    np.testing.assert_allclose(mag.numpy(), want_mag, atol=MAG_TOL, rtol=0)
    assert _wrapped(arg.numpy(), want_arg).max() <= PHASE_TOL
    if plane == "ft":
        # bin 0 (the bottom row) has an all-zero imaginary bank: its phase
        # is +pi where the real response is negative, 0 where positive
        np.testing.assert_array_equal(arg.numpy()[..., -1, :], want_arg[..., -1, :])
        assert set(np.unique(want_arg[..., -1, :])) <= {0.0, np.float32(math.pi)}


def test_gabor_ft_finds_tone():
    n, bins = 256, 64
    sig = np.cos(2 * math.pi * 0.125 * np.arange(n)).astype(np.float32)
    plane = T.gabor_ft(sig, bins, sigma=8.0, device="cpu").numpy()
    np.testing.assert_allclose(plane, _jit(J.gabor_ft, sig, bins, 8.0), atol=MAG_TOL, rtol=0)
    assert abs(int(bins - 1 - np.argmax(plane[:, n // 2])) - 16) <= 1


def test_tf_plane_batched_equals_single():
    sigs = np.random.RandomState(5).randn(3, 64).astype(np.float32)
    batch = T.gabor_ft(sigs, 8, sigma=4.0, device="cpu").numpy()
    assert batch.shape == (3, 8, 64)
    for i in range(3):
        single = T.gabor_ft(sigs[i], 8, sigma=4.0, device="cpu").numpy()
        np.testing.assert_allclose(batch[i], single, atol=1e-6)


def test_planes_stay_on_the_tensor_device_and_dtype():
    sig = torch.from_numpy(T.test_signal(64, 3)).double()
    plane = T.gabor_st(sig, 8)
    assert plane.device.type == "cpu" and plane.dtype == torch.float32
    np.testing.assert_allclose(plane.numpy(), _jit(J.gabor_st, sig.numpy(), 8),
                               atol=MAG_TOL, rtol=0)


# -------------------------------------------------------- phase and ridges


def test_phase_derivative_matches_reference():
    ang = np.array([[0.0, 1.0, 1.0 - 2 * math.pi - 0.5]])
    d = T.phase_derivative(ang, limit=math.pi, device="cpu").numpy()
    assert d[0, 0] == 0 and abs(d[0, 1] - 1.0) < 1e-6 and abs(d[0, 2] + 0.5) < 1e-5
    plane = T.gabor_ft(T.test_signal(128, 2), 16, 4.0, out="arg", device="cpu").numpy()
    for limit in (math.pi, 1.0):
        got = T.phase_derivative(plane, limit, device="cpu").numpy()
        np.testing.assert_allclose(got, _jit(J.phase_derivative, plane, limit), atol=1e-6, rtol=0)


def _mag_planes():
    rng = np.random.RandomState(7)
    st = T.gabor_st(T.test_signal(128, 3), 16, device="cpu").numpy()
    return {"st": st, "rand": rng.rand(3, 16, 20).astype(np.float32),
            "ties": np.round(rng.rand(12, 15) * 4).astype(np.float32)}


@pytest.mark.parametrize("which", ["st", "rand", "ties"])
@pytest.mark.parametrize("threshold", [0.0, 0.05])
def test_ridge_detectors_exactly_equal(which, threshold):
    m = _mag_planes()[which]
    d = T.phase_derivative(m, device="cpu").numpy()
    for tf, jf, x in ((T.detect_ridges1, J.detect_ridges1, m),
                      (T.detect_ridges2, J.detect_ridges2, d),
                      (T.detect_ridges3, J.detect_ridges3, m)):
        got = tf(x, threshold, device="cpu").numpy()
        want = _jit(jf, x, threshold)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=tf.__name__)


def test_detect_ridges_reference_examples():
    r = T.detect_ridges1(np.array([[0.0, 1.0, 5.0, 1.0, 0.0]]), 0.5, device="cpu").numpy()
    assert r[0, 2] > 0 and r[0, 1] == 0 and r[0, 3] == 0
    assert abs(r[0, 2] - 5.0 / (2 * math.pi)) < 1e-6
    r = T.detect_ridges2(np.array([[0.0, -1.0, 1.0, -0.1, 0.0]]), 0.5, device="cpu").numpy()
    assert r[0, 1] > 0 and r[0, 2] == 0 and r[0, 3] == 0
    mag = np.zeros((5, 7), np.float32)
    mag[2, 3] = 2.0
    r = T.detect_ridges3(mag, 0.5, device="cpu").numpy()
    assert r[2, 3] > 0 and r.sum() == r[2, 3]


def test_detect_ridges3_batched_matches_2d():
    m = np.random.RandomState(7).rand(3, 16, 20).astype(np.float32)
    batched = T.detect_ridges3(m, device="cpu").numpy()
    singles = np.stack([T.detect_ridges3(m[i], device="cpu").numpy() for i in range(3)])
    np.testing.assert_array_equal(batched, singles)


# --------------------------------------------------- strongest ridges


def _components(n, bins):
    truth = []
    sig = np.zeros(n, np.float64)
    for k, f in enumerate((0.12, 0.22, 0.32)):
        t0 = (k + 1) * n // 4
        sig += np.real(T.gabor_function(np.arange(n) - t0, n / 32.0, 2 * math.pi * f))
        truth.append((t0, bins - round(f / 0.5 * bins)))
    return sig.astype(np.float32), truth


def test_strongest_ridges_recovers_isolated_components():
    n, bins = 512, 64
    sig, truth = _components(n, bins)
    plane = T.gabor_st(sig, bins, device="cpu").numpy()
    pts = T.strongest_ridges(plane, 8, device="cpu")
    assert pts.shape == (8, 2) and pts.dtype == torch.int32
    np.testing.assert_array_equal(pts.numpy(), np.asarray(
        jax.jit(lambda p: J.strongest_ridges(p, 8))(plane)))
    d = T.diff_points(np.asarray(truth, np.float32), pts, device="cpu").numpy()
    assert (d <= 4.0).all(), (truth, pts.tolist(), d)


@pytest.mark.parametrize("count,threshold", [(4, 0.0), (6, 0.01)])
def test_strongest_ridges_exactly_equal(count, threshold):
    n, bins = 128, 16
    sig = np.real(T.gabor_function(np.arange(n) - 64, 8.0, math.pi / 2)).astype(np.float32)
    for plane in (T.gabor_st(sig, bins, device="cpu").numpy(),
                  np.round(np.random.RandomState(2).rand(bins, n) * 3).astype(np.float32)):
        pts = T.strongest_ridges(plane, count, threshold, device="cpu").numpy()
        want = np.asarray(jax.jit(lambda p: J.strongest_ridges(p, count, threshold))(plane))
        np.testing.assert_array_equal(pts, want)
    assert len({(int(x), int(y)) for x, y in pts}) == count


def test_strongest_ridges_rejects_non_2d():
    with pytest.raises(ValueError):
        T.strongest_ridges(np.zeros((2, 3, 4), np.float32), 1, device="cpu")


def test_diff_points_matches_reference():
    ref = np.array([[0, 0], [10, 0]], np.float32)
    tst = np.array([[3, 4], [10, 1]], np.float32)
    got = T.diff_points(ref, tst, device="cpu").numpy()
    np.testing.assert_allclose(got, [5.0, 1.0], atol=1e-6)
    rng = np.random.RandomState(1)
    a, b = rng.rand(9, 2).astype(np.float32) * 50, rng.rand(5, 2).astype(np.float32) * 50
    np.testing.assert_allclose(T.diff_points(a, b, device="cpu").numpy(),
                               np.asarray(jax.jit(J.diff_points)(a, b)), rtol=1e-6)


def test_numpy_input_goes_to_the_card():
    sig = T.test_signal(32, 0)
    if torch.cuda.is_available():
        assert T.gabor_ft(sig, 4, 2.0).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            T.gabor_ft(sig, 4, 2.0)
