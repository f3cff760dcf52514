"""Port vs reference: the fused 2-D kernels B2, B3, B5, B6 and the fused pyramid functions
(B1/B4 in detail: tests/test_torch_fused_level.py).

On the CPU each wrapper runs its kernel's plain PyTorch version (same tile
and halo decomposition, same LL re-mirror arithmetic as the CUDA kernel);
it is held to the JAX Pallas kernel run in interpret mode on the same
seeded inputs, at the sizes tests/test_fused_ms.py uses: float32 to 3e-5,
int32 bit-exactly.  Tiles smaller than the default make several tiles,
and short last tiles, out of these small images.  The CUDA kernels
themselves are held against these plain versions on the card by
tests/test_torch_cuda.py.
"""
import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdwt_tpu.ops.fused as jf
import libdwt_tpu.ops.separable as js
from libdwt_tpu.utils.testimg import test_image as make_image
from libdwt_torch.ops import _cuda, fused3d, streamed, streamed3d
from libdwt_torch.ops import fused as tf
from libdwt_torch.parallel import remote_halo


def _leaves(t):
    if isinstance(t, (list, tuple)):
        return [x for s in t for x in _leaves(s)]
    return [t]


def _t(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_t(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _close(got, want, exact=False, atol=3e-5):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.detach().cpu().numpy()
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _img(h, w, dtype=np.float32):
    return make_image(h, w, dtype=dtype)


def _sep_dec(x, wavelet, level):
    return jax.jit(functools.partial(js.wavedec2, wavelet=wavelet, level=level))(x)


# ------------------------------------------------------------------- B2


@pytest.mark.parametrize("h,w,wavelet,tile", [
    (128, 128, "cdf97", 32), (320, 128, "cdf97", 32), (96, 96, "cdf97", 64),
    (128, 128, "cdf53", 32), (96, 96, "interp53", 32), (128, 128, "haar", 64),
    (132, 64, "cdf97", 32), (256, 192, "cdf97", 64)])
def test_b2_plain_matches_pallas(h, w, wavelet, tile):
    x = _img(h, w)
    want = jf.fused_dwt2_2level(jnp.asarray(x), wavelet, strip_rows=64, interpret=True)
    got = tf.fused_dwt2_2level(torch.from_numpy(x), wavelet, tile=tile)
    _close(list(got), list(want))


@pytest.mark.parametrize("h,w,wavelet", [(128, 128, "cdf53"), (320, 128, "cdf97"),
                                         (96, 64, "cdf53")])
def test_b2_plain_int_bitexact(h, w, wavelet):
    x = _img(h, w, np.int32)
    want = jf.fused_dwt2_2level(jnp.asarray(x), wavelet, strip_rows=64, interpret=True)
    got = tf.fused_dwt2_2level(torch.from_numpy(x), wavelet, tile=32)
    _close(list(got), list(want), exact=True)


# ------------------------------------------------------------------- B5


@pytest.mark.parametrize("h,w,wavelet,tile", [
    (128, 128, "cdf97", 32), (320, 128, "cdf53", 32), (96, 96, "cdf97", 64),
    (140, 64, "cdf97", 32), (128, 128, "haar", 32)])
def test_b5_plain_matches_pallas(h, w, wavelet, tile):
    c = _sep_dec(_img(h, w), wavelet, 2)
    want = jf.fused_idwt2_2level(c[0], c[1], c[2], wavelet, strip_rows=64, interpret=True)
    tc = _t(c)
    got = tf.fused_idwt2_2level(tc[0], tc[1], tc[2], wavelet, tile=tile)
    _close(got, want)


@pytest.mark.parametrize("h,w,wavelet", [(128, 128, "cdf53"), (320, 128, "cdf97")])
def test_b5_plain_int_bitexact(h, w, wavelet):
    x = _img(h, w, np.int32)
    c = _sep_dec(x, wavelet, 2)
    want = jf.fused_idwt2_2level(c[0], c[1], c[2], wavelet, strip_rows=64, interpret=True)
    tc = _t(c)
    got = tf.fused_idwt2_2level(tc[0], tc[1], tc[2], wavelet, tile=32)
    _close(got, want, exact=True)
    np.testing.assert_array_equal(got.numpy(), x)


# ------------------------------------------------------------------- B3 / B6


@pytest.mark.parametrize("h,w,levels,wavelet,tile", [
    (64, 64, 3, "cdf97", 8), (67, 129, 3, "cdf97", 8), (67, 129, 3, "cdf53", 32),
    (128, 96, 4, "cdf97", 16)])
def test_b3_plain_matches_pallas(h, w, levels, wavelet, tile):
    x = _img(h, w)
    want = jf.fused_deep_wavedec2(jnp.asarray(x), wavelet, levels, interpret=True)
    got = tf.fused_deep_wavedec2(torch.from_numpy(x), wavelet, levels, tile=tile)
    _close(got, want)


@pytest.mark.parametrize("h,w,wavelet", [(64, 96, "cdf53"), (67, 129, "cdf97")])
def test_b3_plain_int_bitexact(h, w, wavelet):
    x = _img(h, w, np.int32)
    want = jf.fused_deep_wavedec2(jnp.asarray(x), wavelet, 3, interpret=True)
    got = tf.fused_deep_wavedec2(torch.from_numpy(x), wavelet, 3, tile=8)
    _close(got, want, exact=True)


@pytest.mark.parametrize("shape,levels,wavelet,tile", [
    ((128, 256), 3, "cdf97", 8), ((67, 128), 2, "cdf53", 8), ((65, 129), 1, "cdf97", 32),
    ((96, 96), 4, "cdf97", 16), ((134, 256), 2, "cdf97", 32)])
def test_b6_plain_matches_pallas(shape, levels, wavelet, tile):
    c = _sep_dec(_img(*shape), wavelet, levels)
    want = jf.fused_deep_waverec2(c, wavelet, interpret=True)
    got = tf.fused_deep_waverec2(_t(c), wavelet, tile=tile)
    _close(got, want)


@pytest.mark.parametrize("h,w,wavelet", [(64, 96, "cdf53"), (67, 129, "cdf97")])
def test_b6_plain_int_bitexact(h, w, wavelet):
    x = _img(h, w, np.int32)
    c = _sep_dec(x, wavelet, 3)
    want = jf.fused_deep_waverec2(c, wavelet, interpret=True)
    got = tf.fused_deep_waverec2(_t(c), wavelet, tile=8)
    _close(got, want, exact=True)
    np.testing.assert_array_equal(got.numpy(), x)


# ------------------------------------------------------------------- wrappers


def test_wrappers_count_calls_not_launches_on_cpu():
    tf.reset_counters()
    x = torch.from_numpy(_img(64, 64))
    c2 = tf.fused_dwt2_2level(x)
    tf.fused_idwt2_2level(*c2)
    d = tf.fused_deep_wavedec2(x, "cdf97", 2)
    tf.fused_deep_waverec2(d)
    tf.fused_idwt2_level(*tf.fused_dwt2_level(x))
    v = torch.from_numpy(np.random.default_rng(0).random((8, 8, 8), dtype=np.float32))
    fused3d.fused_idwt3_level(fused3d.fused_dwt3_level(v))
    streamed3d.streamed_idwt3_level(streamed3d.streamed_dwt3_level(v))
    xs = torch.from_numpy(_img(256, 256))
    streamed.streamed_idwt2_level(*streamed.streamed_dwt2_level(xs, strip_rows=64),
                                  strip_rows=64)
    streamed.streamed_idwt2_2level(*streamed.streamed_dwt2_2level(xs), body="mxu")
    streamed.streamed_waverec2_deep(streamed.streamed_wavedec2_deep(xs, "cdf97", 3))
    remote_halo.rdma_extend_rows([xs[:128], xs[128:]], 4)
    assert {k: (s.calls, s.launches) for k, s in tf.KERNELS.items()} == {
        k: (1, 0) for k in ("B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8", "B9", "B10",
                            "B11", "B12", "B13", "B14", "B15", "B16", "B17", "B18")}
    tf.reset_counters()
    assert all(s.calls == 0 for s in tf.KERNELS.values())


def test_float64_plain_matches_oracle():
    x = np.random.default_rng(3).standard_normal((96, 128))
    got = tf.fused_dwt2_2level(torch.from_numpy(x), "cdf97", tile=32)
    want = _sep_dec(x, "cdf97", 2)
    _close(list(got), want, atol=1e-12)
    rec = tf.fused_idwt2_2level(*got, "cdf97", tile=32)
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-12, rtol=0)


@pytest.mark.parametrize("call,match", [
    (lambda: tf.fused_dwt2_2level(torch.zeros(130, 128)), "divisible by 4"),
    (lambda: tf.fused_dwt2_2level(torch.zeros(16, 128)), "too small"),
    (lambda: tf.fused_dwt2_2level(torch.zeros(128, 128), tile=30), "multiple of 4"),
    (lambda: tf.fused_dwt2_2level(torch.zeros(128, 128), "d4"), "asymmetric"),
    (lambda: tf.fused_idwt2_2level(torch.zeros(32, 32), (torch.zeros(32, 32),) * 3,
                                   (torch.zeros(64, 64),) * 2 + (torch.zeros(64, 60),)),
     "chain"),
    (lambda: tf.fused_deep_wavedec2(torch.zeros(64, 64), "cdf97", 4), "too many levels"),
    (lambda: tf.fused_deep_waverec2([torch.zeros(4, 4)] + [(torch.zeros(4, 4),) * 3]),
     "too small"),
    (lambda: tf.fused_dwt2_2level(torch.zeros(3, 64, 64)), "2-D"),
    (lambda: tf.fused_dwt2_2level(torch.zeros(128, 128), tile=0), "positive"),
    (lambda: tf.fused_deep_wavedec2(torch.zeros(64, 64), "cdf97", 2, tile=0), "positive"),
    (lambda: tf.fused_idwt2_2level(torch.zeros(32, 32), (torch.zeros(32, 32),) * 3,
                                   (torch.zeros(64, 64, dtype=torch.float64),) * 3),
     "one dtype"),
    (lambda: tf.fused_deep_waverec2([torch.zeros(8, 8)] + [(torch.zeros(8, 8),) * 2
                                                           + (torch.zeros(8, 8).int(),)]),
     "one dtype"),
])
def test_wrappers_reject_bad_input(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_single_fused_levels_raise_not_ported():
    """The single fused levels B1/B4 are ported: they run and match the
    Pallas kernels."""
    x = _img(64, 64)
    want = jf.fused_dwt2_level(jnp.asarray(x), "cdf97", interpret=True)
    got = tf.fused_dwt2_level(torch.from_numpy(x))
    _close(list(got), list(want))
    _close(tf.fused_idwt2_level(*got), jf.fused_idwt2_level(*want, interpret=True))


def test_cuda_dtypes():
    assert tf._suffix(torch.float32) == "f32"
    assert tf._suffix(torch.int32) == "i32"
    assert tf._suffix(torch.float64) == "f64"
    assert torch.float64 in tf.KERNEL_DTYPES
    with pytest.raises(TypeError, match="float64"):
        tf._suffix(torch.int16)


@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53", "interp53", "haar"])
@pytest.mark.parametrize("is_int", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
def test_lift_params_struct(wavelet, is_int, inverse):
    w = tf.get_wavelet(wavelet)
    if is_int and w.int_steps is None:
        with pytest.raises(ValueError):
            tf._lift_params(w, is_int, inverse)
        return
    table, scales = tf._step_table(w, is_int, inverse)
    p = tf._lift_params(w, is_int, inverse)
    assert p.n == len(table) <= 4
    for i, st in enumerate(table):
        assert p.is_d[i] == int(st.is_d)
        if is_int:
            assert (p.iwl[i], p.iwr[i], p.sign[i], p.k[i], p.shift[i]) == (
                st.wl, st.wr, st.sign, st.k, st.shift)
        else:
            assert p.fwl[i] == pytest.approx(st.wl) and p.fwr[i] == pytest.approx(st.wr)
            # the float64 kernels multiply by the plain version's own doubles
            assert (p.dwl[i], p.dwr[i]) == (st.wl, st.wr)
    assert p.has_scale == int(scales is not None)
    if scales:
        assert list(p.scale) == pytest.approx(list(scales))
        lo, hi = tf._axis_scales(w, is_int, inverse)
        assert (p.scale_lo, p.scale_hi) == pytest.approx((lo, hi))
        assert list(p.scale) == pytest.approx([lo * lo, lo * hi, hi * lo, hi * hi])
        assert list(p.dscale) == list(scales)
        assert (p.dscale_lo, p.dscale_hi) == (lo, hi)
    # the double fields follow the float layout at C's 8-byte alignment
    end = _cuda.LiftParams.scale_hi.offset + 4
    assert _cuda.LiftParams.dwl.offset == -(-end // 8) * 8 == 160
    assert _cuda.LiftParams.dscale_hi.offset + 8 == ctypes.sizeof(_cuda.LiftParams)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("LIBDWT_TORCH_BUILD", str(tmp_path / "b"))
    monkeypatch.setenv("NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_cuda.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build_all()
    assert _cuda.build_dir() == tmp_path / "b"
    assert set(_cuda.SOURCES) == {"fused2l.cu", "level.cu", "fused3d.cu", "streamed.cu",
                                  "streamed3d.cu", "remote_halo.cu"}
    assert set(_cuda._SOURCE_OF) == set(_cuda._SIGS)
    assert all((_cuda.CSRC / s).exists() for s in _cuda.SOURCES + _cuda.HEADERS)


# ------------------------------------------------------------------- pyramid functions


@pytest.mark.parametrize("h,w,level,plan", [
    (2144, 4096, 5, [("2level", 2), ("deep", 3)]),
    (1024, 2560, 5, [("2level", 2), ("deep", 3)]),
    (1024, 1024, 1, [("level", 1)]),
    (1030, 1024, 3, [("level", 1), ("deep", 2)]),
    (2161, 4097, 5, [("level", 1), ("level", 1), ("deep", 3)]),
    (256, 160, 5, [("deep", 5)]),
    (256, 160, 6, [("separable", 1)] * 6),
    (16, 16, 2, [("separable", 1), ("separable", 1)]),
])
def test_forward_plan_is_the_reference_schedule(h, w, level, plan):
    assert tf.fused_wavedec2_plan(h, w, level, 4, "cdf97") == plan


@pytest.mark.parametrize("level", [1, 2, 3, 5])
def test_fused_wavedec2_small_matches_oracle(level):
    x = _img(256, 160)
    got = tf.fused_wavedec2(torch.from_numpy(x), "cdf97", level)
    _close(got, _sep_dec(x, "cdf97", level), atol=5e-5)


@pytest.mark.parametrize("j", [3, 6, 8])
def test_fused_waverec2_small_roundtrip(j):
    x = np.random.default_rng(j).random((256, 256)).astype(np.float32)
    rec = tf.fused_waverec2(_t(_sep_dec(x, "cdf97", j)), "cdf97")
    np.testing.assert_allclose(rec.numpy(), x, atol=5e-5, rtol=0)


def test_fused_wavedec2_asymmetric_wavelet_is_separable():
    x = np.random.default_rng(2).random((1024, 64)).astype(np.float32)
    _close(tf.fused_wavedec2(torch.from_numpy(x), "d4", 2), _sep_dec(x, "d4", 2), atol=1e-5)
