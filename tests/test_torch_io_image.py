"""Port vs reference: the file codecs, the native library, the dataset
cache and ``Image``/``Volume`` (``libdwt_torch.utils.io``, ``nativelib``,
``cache``, ``libdwt_torch.image``).

The same seeded numpy data go through ``libdwt_tpu`` and the port on the
CPU.  Bounds: PGM/MAT/SVM files written by the two packages byte for byte
identical, on the native path and on the pure-Python fallback; their
loads exactly equal; ``Image``/``Volume`` ``fdwt``/``idwt``/``wavedec``
within 1e-5 of the reference (the reference under ``jax.jit``, one compile
per case); comparisons equal.  The cases follow tests/test_io_image.py.
"""
import os

import jax
import numpy as np
import pytest
import torch

import libdwt_tpu.image as JI
import libdwt_torch.image as TI
from libdwt_tpu.utils import cache as jcache
from libdwt_tpu.utils import io as jio
from libdwt_tpu.utils import nativelib as jnative
from libdwt_tpu.utils.subband import resolve_j as jresolve_j
from libdwt_torch.utils import cache as tcache
from libdwt_torch.utils import io as tio
from libdwt_torch.utils import nativelib as tnative

TOL = 1e-5


@pytest.fixture(params=["native", "python"])
def codec(request, monkeypatch):
    """Both packages on their native codecs, or both on the fallback."""
    if request.param == "native":
        assert tnative.available() and jnative.available()
    else:
        monkeypatch.setattr(tnative, "get", lambda: None)
        monkeypatch.setattr(jnative, "get", lambda: None)
    return request.param


def _bytes(p):
    with open(p, "rb") as f:
        return f.read()


def _both(tmp_path, name, write):
    """Write with each package; return the two paths, after checking the
    files are byte for byte the same."""
    pt, pj = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
    write(tio, pt)
    write(jio, pj)
    assert _bytes(pt) == _bytes(pj)
    return pt, pj


def test_native_library_is_the_references():
    assert tnative.available(), "native backend should build in this env"
    assert tnative._SO_PATH == jnative._SO_PATH
    assert tnative.get()._name == jnative.get()._name
    lib = tnative.get()
    for fn in ("ldt_pgm_probe", "ldt_mat_write", "ldt_host_info"):
        assert getattr(lib, fn).restype is not None and getattr(lib, fn).argtypes


# ---------------------------------------------------------------- codecs


IMGS = {
    "rand": lambda: np.random.RandomState(0).rand(13, 17).astype(np.float32),
    "edges": lambda: np.asarray([[0.9999, 0.5, np.nan, -0.2, 1.5, 1.0]], np.float32),
}


@pytest.mark.parametrize("which", sorted(IMGS))
@pytest.mark.parametrize("maxval,binary", [(255, False), (1000, False), (255, True)])
def test_pgm_bytes_and_loads_equal_reference(codec, which, maxval, binary, tmp_path):
    img = IMGS[which]()
    pt, pj = _both(tmp_path, "a.pgm",
                   lambda m, p: m.save_pgm(p, img, maxval=maxval, binary=binary))
    for normalize in (True, False):
        got = tio.load_pgm(pt, normalize)
        want = jio.load_pgm(pj, normalize)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tio._load_pgm_py(pt, normalize), want)
    back = tio.load_pgm(pt)
    finite = np.isfinite(img) & (img >= 0) & (img <= 1)
    # libdwt's save TRUNCATES (libdwt.c:19794): a full quantization step
    assert np.abs(back - img)[finite].max() <= 1.0 / maxval + 1e-6


def test_pgm_write_truncates_like_reference(codec, tmp_path):
    p = str(tmp_path / "n.pgm")
    tio.save_pgm(p, IMGS["edges"]()[:, :5], maxval=255)
    assert open(p).read().split()[4:] == ["254", "127", "0", "0", "255"]


def test_pgm_accepts_a_cpu_tensor_and_rejects_bad_input(tmp_path):
    img = IMGS["rand"]()
    pt, _ = _both(tmp_path, "t.pgm", lambda m, p: m.save_pgm(
        p, torch.from_numpy(img) if m is tio else img))
    with pytest.raises(ValueError, match="2-D"):
        tio.save_pgm(pt, img[None])
    with pytest.raises(ValueError, match="maxval"):
        tio.save_pgm(pt, img, maxval=1000, binary=True)


def test_pgm_headers_comments_and_16_bit(tmp_path):
    p = str(tmp_path / "d.pgm")
    with open(p, "w") as f:
        f.write("P2\n2 2\n255\n0 10 20 30")  # no trailing newline
    np.testing.assert_array_equal(tio.load_pgm(p, normalize=False).ravel(), [0, 10, 20, 30])
    with open(p, "wb") as f:
        f.write(b"P5\n# a comment\n3 1\n1000\n" + np.array([0, 500, 1000], ">u2").tobytes())
    np.testing.assert_array_equal(tio._load_pgm_py(p, True), jio._load_pgm_py(p, True))
    np.testing.assert_array_equal(tio.load_pgm(p), jio.load_pgm(p))
    with open(p, "wb") as f:
        f.write(b"P5\n2 2\n255")  # header ends at EOF, no pixel bytes
    with pytest.raises(Exception):
        tio.load_pgm(p)
    with open(p, "wb") as f:
        f.write(b"Q5\n")
    with pytest.raises(ValueError, match="not a PGM"):
        tio._load_pgm_py(p, True)


@pytest.mark.parametrize("shape", [(7, 11), (1, 5), (9,)])
def test_mat_bytes_and_loads_equal_reference(codec, shape, tmp_path):
    a = np.random.RandomState(2).randn(*shape).astype(np.float32)
    pt, pj = _both(tmp_path, "m.mat", lambda m, p: m.save_mat(p, a))
    got, want = tio.load_mat(pt), jio.load_mat(pj)
    assert got.shape == want.shape == (a.reshape(-1, shape[-1]).shape)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - a.reshape(got.shape)).max() < 1e-5  # "%f": 6 decimals


def test_mat_format_and_rejects(tmp_path):
    p = str(tmp_path / "m.mat")
    tio.save_mat(p, np.array([[1.5, -2.0], [0.25, 3.0]], np.float32))
    assert open(p).read() == "1.500000,-2.000000\n0.250000,3.000000\n"
    with open(p, "w") as f:
        f.write("1,2\n3,4,5")  # ragged final row
    with pytest.raises(Exception):
        tio.load_mat(p)
    with open(p, "w") as f:
        f.write("1 2\n3 4\n")
    np.testing.assert_array_equal(tio.load_mat(p), jio.load_mat(p))


def test_svm_bytes_and_loads_equal_reference(codec, tmp_path):
    rng = np.random.RandomState(3)
    labels = np.array([1, 2, 1, -1], np.float32)
    feats = np.round(rng.randn(4, 5), 3).astype(np.float32)
    pt, pj = _both(tmp_path, "f.svm", lambda m, p: m.save_svm(p, labels, feats))
    (lt, ft), (lj, fj) = tio.load_svm(pt), jio.load_svm(pj)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(ft, feats, rtol=1e-5)
    with pytest.raises(ValueError, match="features"):
        tio.save_svm(pt, labels[:2], feats)


def test_svm_first_line(tmp_path):
    p = str(tmp_path / "f.svm")
    tio.save_svm(p, np.array([1, 2], np.float32), np.array([[0.5, 1.0], [2.0, 0.0]], np.float32))
    assert open(p).readline().strip() == "1 1:0.5 2:1"


def test_native_host_info():
    import ctypes

    n, l1, line = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    assert tnative.get().ldt_host_info(ctypes.byref(n), ctypes.byref(l1), ctypes.byref(line)) == 0
    assert n.value >= 1


# ----------------------------------------------------------------- cache


def test_dataset_cache_matches_reference_and_each_others_cache(tmp_path):
    rng = np.random.RandomState(4)
    rows = [rng.randn(1, n).astype(np.float32) for n in (5, 7, 3)]
    for name, mod in (("t", tio), ("j", jio)):
        (tmp_path / name).mkdir()
        for i, row in enumerate(rows):
            mod.save_mat(str(tmp_path / name / f"s{i}.dat"), row)
    got = tcache.load_dataset_cached(str(tmp_path / "t"))
    want = jcache.load_dataset_cached(str(tmp_path / "j"))
    assert got.shape == want.shape == (3, 7) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # each package takes the other's cache as it stands
    np.testing.assert_array_equal(jcache.load_dataset_cached(str(tmp_path / "t")), got)
    np.testing.assert_array_equal(tcache.load_dataset_cached(str(tmp_path / "j")), want)
    assert os.path.exists(str(tmp_path / "t" / ".cache.npy.meta"))
    # a changed source invalidates the cache
    tio.save_mat(str(tmp_path / "t" / "s1.dat"), np.full((1, 9), 2.0, np.float32))
    os.utime(str(tmp_path / "t" / "s1.dat"), (1, 1))
    again = tcache.load_dataset_cached(str(tmp_path / "t"))
    assert again.shape == (3, 9) and (np.asarray(again[1]) == 2.0).all()
    with pytest.raises(FileNotFoundError):
        tcache.load_dataset_cached(str(tmp_path / "t"), pattern=".nope")


# ---------------------------------------------------------- Image/Volume


def _jit(fn, *args):
    return jax.jit(fn)(*args)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for s in t for x in _leaves(s)]
    return [t]


@pytest.mark.parametrize("shape,wavelet,level", [((64, 48), "cdf97", 3), ((37, 41), "cdf53", 2),
                                                 ((32, 32), "haar", None)])
def test_image_transforms_match_reference(shape, wavelet, level):
    ti = TI.Image.test_pattern(*shape, device="cpu")
    ji = JI.Image.test_pattern(*shape)
    np.testing.assert_array_equal(ti.data.numpy(), np.asarray(ji.data))
    t = ti.fdwt(wavelet, level)
    jt_data = _jit(lambda a: JI.Image(a).fdwt(wavelet, level).data, ji.data)
    assert t.j == jresolve_j(*shape, level)
    _close(t.data, jt_data)
    back = t.idwt(wavelet)
    _close(back.data, _jit(lambda a: JI.Image(a, t.j).idwt(wavelet).data, jt_data))
    assert back.j == 0 and back.compare(ti, eps=1e-3) and ti.psnr(back) > 60
    want = _jit(lambda a: JI.Image(a).wavedec(wavelet, level), ji.data)
    for impl in (None, "separable", "fused"):
        got = ti.wavedec(wavelet, level, impl=impl)
        assert len(got) == len(want)
        for g, w in zip(_leaves(got), _leaves(want)):
            _close(g, w)


def test_image_subbands_and_comparisons_match_reference():
    ti = TI.Image.test_pattern(32, 32, device="cpu").fdwt("cdf53", 2)
    ji = JI.Image.test_pattern(32, 32).fdwt("cdf53", 2)
    for j, band in ((1, "HH"), (2, "LL"), (2, "HL"), (1, "LH")):
        _close(ti.subband(j, band), ji.subband(j, band))
    assert ti.subband(1, "HH").shape == (16, 16) and ti.shape == (32, 32)
    assert (ti.size_y, ti.size_x) == (32, 32)
    a, b = TI.Image.test_pattern(24, 20, device="cpu"), TI.Image.test_pattern(24, 20, 1, device="cpu")
    ja, jb = JI.Image.test_pattern(24, 20), JI.Image.test_pattern(24, 20, 1)
    assert a.mse(b) == ja.mse(jb) and a.psnr(b) == ja.psnr(jb) and a.psnr(a) == float("inf")
    assert a.psnr(b, peak=255.0) == ja.psnr(jb, peak=255.0)
    for eps in (1e-3, 0.5, 2.0):
        assert a.compare(b, eps) == ja.compare(jb, eps)


def test_image_create_and_default_device():
    img = TI.Image.create(5, 7, device="cpu")
    assert img.shape == (5, 7) and img.data.dtype == torch.float32 and img.j == 0
    assert TI.Image.create(3, 4, torch.int32, device="cpu").data.dtype == torch.int32
    if not torch.cuda.is_available():
        for make in (lambda: TI.Image.create(4, 4), lambda: TI.Image.test_pattern(8, 8),
                     lambda: TI.Volume.fill_test(2, 8, 8)):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()


def test_image_files_round_trip_like_reference(codec, tmp_path):
    ti = TI.Image.test_pattern(19, 23, device="cpu")
    ji = JI.Image.test_pattern(19, 23)
    for name, tsave, jsave, load in (
            ("a.pgm", lambda p: ti.save_pgm(p), lambda p: ji.save_pgm(p), "load_pgm"),
            ("b.pgm", lambda p: ti.save_pgm(p, binary=True),
             lambda p: ji.save_pgm(p, binary=True), "load_pgm"),
            ("c.mat", ti.save_mat, ji.save_mat, "load_mat"),
            ("d.exr", ti.save_exr, ji.save_exr, "load_exr")):
        pt, pj = str(tmp_path / ("t" + name)), str(tmp_path / ("j" + name))
        tsave(pt)
        jsave(pj)
        assert _bytes(pt) == _bytes(pj), name
        got = getattr(TI.Image, load)(pt, device="cpu")
        assert got.data.device.type == "cpu"
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(getattr(JI.Image, load)(pj).data))
    np.testing.assert_array_equal(TI.Image.load_exr(str(tmp_path / "td.exr"), device="cpu")
                                  .data.numpy(), ti.data.numpy())


def test_image_load_exr_channels_first(tmp_path):
    img = np.random.RandomState(6).rand(9, 11, 3).astype(np.float32)
    p = str(tmp_path / "rgb.exr")
    tio.write_exr(p, img)
    got = TI.Image.load_exr(p, device="cpu")
    assert got.shape == (3, 9, 11) and got.data.is_contiguous()
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(JI.Image.load_exr(p).data))


@pytest.mark.parametrize("shape,wavelet,level", [((16, 16, 16), "cdf53", 2),
                                                 ((12, 20, 18), "cdf97", 1)])
def test_volume_transforms_match_reference(shape, wavelet, level):
    tv = TI.Volume.fill_test(*shape, device="cpu")
    jv = JI.Volume.fill_test(*shape)
    np.testing.assert_array_equal(tv.data.numpy(), np.asarray(jv.data))
    t = tv.fdwt(wavelet, level)
    jt = _jit(lambda a: JI.Volume(a).fdwt(wavelet, level).data, jv.data)
    _close(t.data, jt)
    back = t.idwt(wavelet)
    _close(back.data, _jit(lambda a: JI.Volume(a, t.j).idwt(wavelet).data, jt))
    assert back.compare(tv, eps=1e-3) == JI.Volume(np.asarray(back.data)).compare(jv, eps=1e-3)
    assert back.compare(tv, eps=1e-3) and tv.shape == shape
    want = _jit(lambda a: JI.Volume(a).wavedec(wavelet, level), jv.data)
    for impl in (None, "fused"):
        got = tv.wavedec(wavelet, level, impl=impl)
        for g, w in zip(_leaves(got), _leaves(want)):
            _close(g, w)
    assert TI.Volume.create(2, 3, 4, device="cpu").shape == (2, 3, 4)


def test_conv_show_matches_reference():
    t = TI.Image.test_pattern(32, 32, device="cpu").fdwt("cdf97", 2)
    want = TI.conv_show(t.data)
    assert isinstance(want, np.ndarray) and want.dtype == np.float64
    assert want.min() >= 0 and want.max() <= 1
    _close(want, JI.conv_show(t.data.numpy()))
    _close(TI.conv_show(t.data.numpy()), want, 0)
