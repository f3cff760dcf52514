"""Port vs reference: the flags API, power-of-two resize and coefficient
display (``libdwt_torch.interop``).

The same seeded numpy inputs go through ``libdwt_tpu.interop`` (under
``jax.jit``, one compile per case) and the port on the CPU.  Bounds:
``resize_pot`` with ``'nearest'`` exactly equal, ``'linear'`` within 1e-6;
``transform`` and ``wtshow`` within 1e-5.  A numpy array comes back as
numpy, a tensor as a tensor on its own device.  The cases follow
tests/test_interop.py.
"""
import jax
import numpy as np
import pytest
import torch

import libdwt_tpu.interop as J
import libdwt_torch.interop as T

TOL = 1e-5


def _data(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_flags_equal_reference():
    for name in ("DWT_FORWARD", "DWT_INVERSE", "DWT_CDF97", "DWT_CDF53"):
        assert getattr(T, name) == getattr(J, name)


@pytest.mark.parametrize("shape", [(5, 7), (37, 41), (100, 3), (2, 9, 6), (20, 30, 3),
                                   (64, 64), (12, 8, 1)])
@pytest.mark.parametrize("interp", ["nearest", "linear"])
def test_resize_pot_matches_reference(shape, interp):
    x = _data(shape, len(shape))
    got = T.resize_pot(x, interp, device="cpu")
    want = np.asarray(jax.jit(lambda a: J.resize_pot(a, interp))(x))
    assert isinstance(got, np.ndarray) and got.shape == want.shape and got.dtype == want.dtype
    if interp == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_resize_pot_shapes_and_noop():
    assert T.resize_pot(_data((200, 200, 3)), device="cpu").shape == (256, 256, 3)
    assert T.resize_pot(_data((100, 60)), device="cpu").shape == (128, 64)
    pot = _data((64, 64))
    np.testing.assert_array_equal(T.resize_pot(pot, device="cpu"), pot)
    t = torch.from_numpy(_data((5, 7)))
    got = T.resize_pot(t)
    assert isinstance(got, torch.Tensor) and got.device == t.device and got.shape == (8, 8)


CASES = [((64, 64, 3), "cdf97", 2), ((64, 48), "cdf53", None), ((3, 32, 40), "cdf97", 3),
         ((37, 41), "cdf97", 2), ((40, 24, 2), "cdf53", 1)]


@pytest.mark.parametrize("shape,wavelet,level", CASES)
def test_transform_matches_reference(shape, wavelet, level):
    x = _data(shape, 1)
    fwd = T.transform(x, T.DWT_FORWARD, wavelet, level, device="cpu")
    want = np.asarray(jax.jit(lambda a: J.transform(a, J.DWT_FORWARD, wavelet, level))(x))
    assert isinstance(fwd, np.ndarray) and fwd.shape == want.shape == x.shape
    np.testing.assert_allclose(fwd, want, atol=TOL, rtol=0)
    inv = T.transform(want, T.DWT_INVERSE, wavelet, level, device="cpu")
    want_inv = np.asarray(jax.jit(lambda a: J.transform(a, J.DWT_INVERSE, wavelet, level))(want))
    np.testing.assert_allclose(inv, want_inv, atol=TOL, rtol=0)
    assert np.abs(inv - x).max() <= 1e-4
    show = T.wtshow(want, device="cpu")
    np.testing.assert_allclose(show, np.asarray(J.wtshow(want)), atol=TOL, rtol=0)
    assert show.min() >= 0.0 and show.max() <= 1.0


def test_tensor_stays_a_tensor_on_its_device():
    img = torch.from_numpy(_data((64, 64), 3))
    coeffs = T.transform(img, T.DWT_FORWARD, level=2)
    assert isinstance(coeffs, torch.Tensor) and coeffs.device == img.device
    np.testing.assert_allclose(coeffs.numpy(), np.asarray(
        jax.jit(lambda a: J.transform(a, J.DWT_FORWARD, level=2))(img.numpy())), atol=TOL, rtol=0)
    rec = T.transform(coeffs, T.DWT_INVERSE, level=2)
    assert isinstance(rec, torch.Tensor) and float((rec - img).abs().max()) <= 1e-4
    disp = T.wtshow(coeffs)
    assert isinstance(disp, torch.Tensor) and disp.dtype == torch.float64
    # the channels-last tensor keeps its layout
    cl = torch.from_numpy(_data((32, 32, 3), 4))
    out = T.transform(cl, level=1)
    assert out.shape == cl.shape and out.is_contiguous()


def test_numpy_input_goes_to_the_card():
    x = _data((16, 16))
    for fn in (lambda: T.transform(x), lambda: T.resize_pot(x[:15]), lambda: T.wtshow(x)):
        if torch.cuda.is_available():
            assert isinstance(fn(), np.ndarray)
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                fn()
