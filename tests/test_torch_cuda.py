"""The port's CUDA kernels on the card, each held against its plain version
(B1-B6 2-D, B7-B12 streamed 2-D, B13 the banded body in B8/B10/B11/B12,
B14-B17 3-D).

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports torch, numpy and the port only (no JAX), so it also runs on a
GPU machine that has no JAX installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts= -q

Inputs come from a numpy seed.  float32 is held to 3e-5 (the kernels and
their plain versions round the same way, so they usually agree exactly),
int32 bit-exactly, B7-B12 bit for bit in every dtype (and equal to B1
and B4, B2 and B5, B2 then B3, B6 then B5; B7/B9 refuse a strip side over
248), B1 and B4 bit for bit in every dtype (the frames of
their paths and 513x511, mirror and extended rows, tiles 4-96, every fused
wavelet, misaligned inputs, outputs written whole and nothing past them; a
window too wide is refused), B2 and B5 bit for bit in every dtype (main-path frame,
border-only and mixed tiles, a misaligned input, tiles 32-128; B5 refuses
a misaligned output), B3 and B6 bit for bit in every dtype (the main
path's deep tail and the odd 541x1025 chain at 1-4 levels, tiles 4-96,
one cooperative launch a call; a window too wide is refused), the volume levels B14-B17 bit for
bit in every dtype (B14 on both of its feeds); the banded body to 2e-5 (the tensor cores sum in
another order than the plain version's matrix products), and B11/B12 with it
equal to B8/B10 with it and the deep tails B3/B6, bit for bit.  The shapes cover several tiles with short last tiles,
odd deep-tail sizes, every wavelet ``fused_supported`` accepts, the
extended-rows contracts of the single levels (4 rows fused, 8 streamed),
2-D and 3-D tiles whose shared memory exceeds the 48 KB default, streamed
strips with ragged last strips and bands and short tails, and streamed
volume tiles with ragged z, y and x tails.
"""
import ctypes

import numpy as np
import pytest
import torch

from libdwt_torch import api, autotune
from libdwt_torch.ops import fused as tf
from libdwt_torch.ops import fused3d as t3
from libdwt_torch.ops import separable as sep
from libdwt_torch.ops import streamed as ts
from libdwt_torch.ops import streamed3d as ts3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.fixture
def no_tune_table(tmp_path, monkeypatch):
    """'auto' with an empty tune table: its built-in thresholds, whatever
    the packaged table measured."""
    path = tmp_path / "autotune.json"
    path.write_text("{}")
    monkeypatch.setenv("LIBDWT_TORCH_TUNE_FILE", str(path))
    autotune.clear_cache()
    yield
    autotune.clear_cache()


def _leaves(t):
    if isinstance(t, (list, tuple)):
        return [x for s in t for x in _leaves(s)]
    return [t]


def _close(got, want, exact):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype and a.is_cuda
        if exact:
            assert torch.equal(a, b)
        else:
            assert float((a - b).abs().max()) <= 3e-5


def _img(h, w, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        a = rng.integers(-255, 256, (h, w)).astype(np.int32)
    else:
        a = rng.standard_normal((h, w)).astype(np.float32)
    return torch.from_numpy(a).to(device)


TWO_LEVEL = [
    (1056, 544, torch.float32, "cdf97", 64),
    (96, 96, torch.float32, "cdf97", 32),
    (320, 132, torch.float32, "cdf97", 64),
    (256, 384, torch.float32, "cdf97", 128),  # 113 KB of shared memory
    (128, 128, torch.float32, "cdf53", 32),
    (96, 96, torch.float32, "interp53", 32),
    (128, 128, torch.float32, "haar", 64),
    (1056, 544, torch.int32, "cdf53", 64),
    (320, 132, torch.int32, "cdf97", 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53"])
def test_fused_pyramid_at_small_odd_deep_levels_matches_oracle(cuda_device, wavelet):
    """130x258 J=5 through api.wavedec2/waverec2(impl='fused'): every
    forward level is too small for a kernel (separable), and B6 takes all
    five inverse levels in one launch, where the reference's fused inverse
    raises; the result is the oracle's."""
    x = _img(130, 258, torch.float32, cuda_device, 15)
    tf.reset_counters()
    coeffs = api.wavedec2(x, wavelet, 5, impl="fused")
    rec = api.waverec2(coeffs, wavelet, impl="fused")
    torch.cuda.synchronize()
    assert (tf.KERNELS["B3"].launches, tf.KERNELS["B6"].launches) == (0, 1)
    want = sep.wavedec2(x, wavelet, 5)
    assert max(float((a - b).abs().max()) for a, b in zip(_leaves(coeffs), _leaves(want))) <= 5e-4
    assert float((rec - sep.waverec2(want, wavelet)).abs().max()) <= 5e-4
    assert float((rec - x).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,dtype,wavelet,tile", TWO_LEVEL)
def test_b2_b5_kernels_match_plain(cuda_device, h, w, dtype, wavelet, tile):
    x = _img(h, w, dtype, cuda_device)
    exact = dtype == torch.int32
    tf.reset_counters()
    c2 = tf.fused_dwt2_2level(x, wavelet, tile=tile)
    _close(list(c2), list(tf.fused_dwt2_2level_plain(x, wavelet, tile)), exact)
    rec = tf.fused_idwt2_2level(*c2, wavelet, tile=tile)
    _close(rec, tf.fused_idwt2_2level_plain(*c2, wavelet, tile), exact)
    torch.cuda.synchronize()
    assert (tf.KERNELS["B2"].launches, tf.KERNELS["B5"].launches) == (1, 1)
    if exact:
        assert torch.equal(rec, x)
        _close(list(c2), sep.wavedec2(x, wavelet, 2), True)


def _b2_exact(x, wavelet, tile=None):
    """B2 on ``x`` equals its plain version bit for bit, in one launch."""
    kw = {} if tile is None else {"tile": tile}
    tf.reset_counters()
    got = tf.fused_dwt2_2level(x, wavelet, **kw)
    torch.cuda.synchronize()
    assert tf.KERNELS["B2"].launches == 1
    _close(list(got), list(tf.fused_dwt2_2level_plain(x, wavelet, **kw)), True)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [
    (2144, 4096),  # the main path's frame
    (24, 24), (24, 4096),  # every tile a border tile
    (4100, 132), (1056, 548),  # interior and border tiles, ragged last tiles
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32])
def test_b2_equals_plain_bit_for_bit(cuda_device, h, w, dtype):
    _b2_exact(_img(h, w, dtype, cuda_device, seed=3).to(dtype),
              "cdf53" if dtype == torch.int32 else "cdf97")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32])
def test_b2_misaligned_input_takes_the_scalar_loads(cuda_device, dtype):
    """A contiguous view at storage offset 1 is not 16-byte aligned."""
    h, w = 1056, 548
    buf = _img(1, h * w + 1, dtype, cuda_device, seed=4).to(dtype).reshape(-1)
    x = buf[1:1 + h * w].view(h, w)
    assert x.is_contiguous() and x.data_ptr() % 16
    _b2_exact(x, "cdf53" if dtype == torch.int32 else "cdf97")


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [32, 64, 96, 128])
@pytest.mark.parametrize("dtype,wavelet", [
    (dt, wv) for dt in (torch.float32, torch.float64)
    for wv in ("cdf97", "cdf53", "interp53", "haar")
] + [(torch.int32, wv) for wv in ("cdf97", "cdf53", "haar")])
def test_b2_tiles_and_wavelets_equal_plain(cuda_device, tile, dtype, wavelet):
    _b2_exact(_img(1056, 548, dtype, cuda_device, seed=5).to(dtype), wavelet, tile)


def _b5_exact(x, wavelet, tile=None, offset=0):
    """B5 on the two-level separable forward of ``x`` (each band a
    contiguous view at storage offset ``offset``) equals its plain version
    bit for bit, in one launch."""
    kw = {} if tile is None else {"tile": tile}
    c = sep.wavedec2(x, wavelet, 2)
    bands = [c[0], *c[1], *c[2]]
    if offset:
        bands = [torch.cat([b.new_zeros(offset), b.reshape(-1)])[offset:].view(b.shape)
                 for b in bands]
        assert all(b.is_contiguous() and b.data_ptr() % 16 for b in bands)
    ll2, bands2, bands1 = bands[0], tuple(bands[1:4]), tuple(bands[4:])
    tf.reset_counters()
    got = tf.fused_idwt2_2level(ll2, bands2, bands1, wavelet, **kw)
    torch.cuda.synchronize()
    assert tf.KERNELS["B5"].launches == 1
    _close(got, tf.fused_idwt2_2level_plain(ll2, bands2, bands1, wavelet, **kw), True)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [
    (2144, 4096),  # the main path's frame
    (28, 28), (28, 4096),  # every tile a border tile (the wrapper's minimum is 28)
    (4100, 132), (1056, 548),  # interior and border tiles, ragged last tiles
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32])
def test_b5_equals_plain_bit_for_bit(cuda_device, h, w, dtype):
    _b5_exact(_img(h, w, dtype, cuda_device, seed=6).to(dtype),
              "cdf53" if dtype == torch.int32 else "cdf97")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32])
def test_b5_misaligned_input_takes_the_scalar_loads(cuda_device, dtype):
    """Band views at storage offset 1 are not 16-byte aligned."""
    _b5_exact(_img(1056, 548, dtype, cuda_device, seed=7).to(dtype),
              "cdf53" if dtype == torch.int32 else "cdf97", offset=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32])
def test_b5_misaligned_output_is_refused(cuda_device, dtype):
    """B5 stores 16 bytes at a time: its C entry point refuses an output
    that is not 16-byte aligned (cudaErrorInvalidValue, nothing written)
    and takes one that is, at an offset of 16 bytes into the same buffer."""
    from libdwt_torch.ops import _cuda

    h, w, wavelet = 56, 64, "cdf53" if dtype == torch.int32 else "cdf97"
    c = sep.wavedec2(_img(h, w, dtype, cuda_device, seed=9).to(dtype), wavelet, 2)
    bands = [b.contiguous() for b in (c[0], *c[1], *c[2])]
    fn = _cuda.kernel_fn("dwt_inv2", tf._suffix(dtype))
    P = tf._lift_params(tf.get_wavelet(wavelet), dtype == torch.int32, True)
    buf = torch.zeros(h * w + 16, dtype=dtype, device=cuda_device)
    v = 16 // buf.element_size()
    for off, rc in ((1, 1), (v, 0)):  # 1 == cudaErrorInvalidValue
        out = buf[off:off + h * w].view(h, w)
        err = fn(*[t.data_ptr() for t in bands + [out]], h, w, 64, ctypes.byref(P),
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == rc
        if rc:
            assert not buf.any()
    _close(out, tf.fused_idwt2_2level_plain(bands[0], tuple(bands[1:4]),
                                            tuple(bands[4:]), wavelet), True)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [32, 64, 96, 128])
@pytest.mark.parametrize("dtype,wavelet", [
    (dt, wv) for dt in (torch.float32, torch.float64)
    for wv in ("cdf97", "cdf53", "interp53", "haar")
] + [(torch.int32, wv) for wv in ("cdf97", "cdf53", "haar")])
def test_b5_tiles_and_wavelets_equal_plain(cuda_device, tile, dtype, wavelet):
    _b5_exact(_img(1056, 548, dtype, cuda_device, seed=8).to(dtype), wavelet, tile)


DEEP = [
    (536, 1024, 3, torch.float32, "cdf97", 32),
    (67, 129, 3, torch.float32, "cdf97", 8),
    (67, 129, 3, torch.float32, "cdf97", 32),
    (131, 97, 4, torch.float32, "cdf53", 16),
    (128, 96, 3, torch.float32, "haar", 16),
    (64, 96, 3, torch.int32, "cdf53", 8),
    (67, 129, 3, torch.int32, "cdf97", 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,levels,dtype,wavelet,tile", DEEP)
def test_b3_b6_kernels_match_plain(cuda_device, h, w, levels, dtype, wavelet, tile):
    """B3 and B6 each run all their levels in one cooperative launch."""
    x = _img(h, w, dtype, cuda_device, seed=1)
    exact = dtype == torch.int32
    tf.reset_counters()
    d = tf.fused_deep_wavedec2(x, wavelet, levels, tile=tile)
    _close(d, tf.fused_deep_wavedec2_plain(x, wavelet, levels, tile), exact)
    rec = tf.fused_deep_waverec2(d, wavelet, tile=tile)
    _close(rec, tf.fused_deep_waverec2_plain(d, wavelet, tile), exact)
    torch.cuda.synchronize()
    assert (tf.KERNELS["B3"].launches, tf.KERNELS["B6"].launches) == (1, 1)
    if exact:
        _close(d, sep.wavedec2(x, wavelet, levels), True)
        assert torch.equal(rec, x)


def _disjoint(tensors):
    """The tensors' byte spans do not overlap."""
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                   for t in tensors)
    return all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def _b3_b6_exact(x, wavelet, levels, tile=tf.TILE1):
    """B3 and B6 bit for bit equal to their plain versions, one launch each,
    every output a view of its own span, a grid the card holds at once."""
    tf.reset_counters()
    d = tf.fused_deep_wavedec2(x, wavelet, levels, tile=tile)
    rec = tf.fused_deep_waverec2(d, wavelet, tile=tile)
    torch.cuda.synchronize()
    assert (tf.KERNELS["B3"].launches, tf.KERNELS["B6"].launches) == (1, 1)
    assert all(1 <= g <= r for g, r in (tf.LAST_GRID["B3"], tf.LAST_GRID["B6"]))
    assert _disjoint(_leaves(d))
    _close(d, tf.fused_deep_wavedec2_plain(x, wavelet, levels, tile), True)
    _close(rec, tf.fused_deep_waverec2_plain(d, wavelet, tile), True)
    return d, rec


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(536, 1024), (541, 1025)])
@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype,wavelet", [
    (dt, wv) for dt in (torch.float32, torch.float64) for wv in ("cdf97", "cdf53", "haar")
] + [(torch.int32, "cdf53"), (torch.int32, "cdf97")])
def test_b3_b6_equal_plain_bit_for_bit(cuda_device, h, w, levels, dtype, wavelet):
    """The main path's deep tail (536x1024, three levels) and the odd chain
    of the 2161x4097 pyramid (541x1025: ceil/floor bands at every level),
    in every dtype, for the deep tail's wavelets; int32 also equals the
    oracle and comes back exactly."""
    x = _img(h, w, dtype, cuda_device, seed=11).to(dtype)
    d, rec = _b3_b6_exact(x, wavelet, levels)
    if dtype == torch.int32:
        _close(d, sep.wavedec2(x, wavelet, levels), True)
        assert torch.equal(rec, x)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [4, 8, 16, 64, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32])
def test_b3_b6_tiles_equal_plain(cuda_device, tile, dtype):
    """Any first-level tile whose window a block walks (2 * tile + 8 <=
    256) gives the plain version's bits."""
    if dtype == torch.float64 and tile == 96:
        tile = 80  # a 200-wide float64 window is 320 KB, above 227 KB
    _b3_b6_exact(_img(541, 1025, dtype, cuda_device, seed=12).to(dtype),
                 "cdf53" if dtype == torch.int32 else "cdf97", 3, tile)


@pytest.mark.cuda
def test_b3_b6_refuse_a_tile_too_wide(cuda_device):
    """A window wider than the block's 256 threads is refused by the
    launcher, and the wrapper raises: no quiet fallback."""
    x = _img(536, 1024, torch.float32, cuda_device, seed=13)
    d = tf.fused_deep_wavedec2(x, "cdf97", 3)
    tf.reset_counters()
    with pytest.raises(RuntimeError, match="cudaError"):
        tf.fused_deep_wavedec2(x, "cdf97", 3, tile=125)
    with pytest.raises(RuntimeError, match="cudaError"):
        tf.fused_deep_waverec2(d, "cdf97", tile=125)
    assert (tf.KERNELS["B3"].launches, tf.KERNELS["B6"].launches) == (0, 0)


@pytest.mark.cuda
def test_fused_pyramid_on_card_matches_oracle(cuda_device):
    x = _img(1024, 2560, torch.float32, cuda_device, seed=2)
    tf.reset_counters()
    coeffs = api.wavedec2(x, "cdf97", 5, impl="fused")
    rec = api.waverec2(coeffs, "cdf97", impl="fused")
    torch.cuda.synchronize()
    assert {k: s.launches for k, s in tf.KERNELS.items() if s.launches} == {
        "B2": 1, "B3": 1, "B5": 1, "B6": 1}
    for a, b in zip(_leaves(coeffs), _leaves(sep.wavedec2(x, "cdf97", 5))):
        assert a.shape == b.shape and float((a - b).abs().max()) <= 5e-4
    assert float((rec - x).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_float64_on_card_raises(cuda_device):
    """float64 on the card runs B1, B2 and B3, bit for bit equal to their
    plain versions (the name dates from when it raised); a dtype with no
    kernel (int16) still raises TypeError."""
    x = torch.zeros(128, 128, dtype=torch.float64, device=cuda_device)
    tf.reset_counters()
    _close(list(tf.fused_dwt2_2level(x)), list(tf.fused_dwt2_2level_plain(x)), True)
    _close(tf.fused_deep_wavedec2(x, "cdf97", 2), tf.fused_deep_wavedec2_plain(x, "cdf97", 2),
           True)
    _close(list(tf.fused_dwt2_level(x)), list(tf.dwt2_level_plain(x)), True)
    torch.cuda.synchronize()
    assert all(tf.KERNELS[k].launches for k in ("B1", "B2", "B3"))
    with pytest.raises(TypeError, match="int16"):
        tf.fused_dwt2_level(x.to(torch.int16))
    with pytest.raises(TypeError, match="int16"):
        ts.streamed_dwt2_level(torch.zeros(256, 256, dtype=torch.int16, device=cuda_device),
                               strip_rows=64)
    with pytest.raises(TypeError, match="int16"):
        ts3.streamed_dwt3_level(torch.zeros(16, 16, 16, dtype=torch.int16,
                                            device=cuda_device))


LEVEL = [
    (2144, 4096, torch.float32, "cdf97", 32),
    (513, 511, torch.float32, "cdf97", 32),
    (101, 97, torch.float32, "cdf53", 8),
    (33, 517, torch.float32, "interp53", 16),
    (10, 11, torch.float32, "cdf97", 8),
    (131, 67, torch.float32, "haar", 64),  # 74 KB of shared memory
    (512, 512, torch.int32, "cdf53", 32),
    (101, 97, torch.int32, "cdf97", 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,dtype,wavelet,tile", LEVEL)
def test_b1_b4_kernels_match_plain(cuda_device, h, w, dtype, wavelet, tile):
    x = _img(h, w, dtype, cuda_device, seed=3)
    tf.reset_counters()
    b = tf.fused_dwt2_level(x, wavelet, tile=tile)
    _close(list(b), list(tf.dwt2_level_plain(x, wavelet, tile)), True)
    rec = tf.fused_idwt2_level(*b, wavelet, tile=tile)
    _close(rec, tf.idwt2_level_plain(*b, wavelet, tile), True)
    torch.cuda.synchronize()
    assert (tf.KERNELS["B1"].launches, tf.KERNELS["B4"].launches) == (1, 1)
    if dtype == torch.int32:
        _close(list(b), list(sep.dwt2_level(x, wavelet)), True)
        assert torch.equal(rec, x)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,dtype,wavelet", [
    (512, 512, torch.float32, "cdf97"), (130, 97, torch.float32, "cdf53"),
    (130, 97, torch.int32, "cdf53"), (131, 97, torch.float32, "cdf97"),
    (65, 48, torch.int32, "cdf53")])
def test_extended_rows_kernels_match_plain(cuda_device, h, w, dtype, wavelet):
    """The forward contract needs an even height; the inverse takes any."""
    if h % 2 == 0:
        xe = _img(h + 2 * tf.HALO, w, dtype, cuda_device, seed=4)
        b = tf.fused_dwt2_level(xe, wavelet, boundary_rows="extended", tile=16)
        _close(list(b), list(tf.dwt2_level_plain(xe, wavelet, 16, ext=True)), True)
    cy, fy, cx, fx = -(-h // 2), h // 2, -(-w // 2), w // 2
    bands = [_img(r + 2 * tf.CH, c, dtype, cuda_device, seed=5 + i)
             for i, (r, c) in enumerate([(cy, cx), (cy, fx), (fy, cx), (fy, fx)])]
    rec = tf.fused_idwt2_level(*bands, wavelet, boundary_rows="extended", tile=16)
    assert tuple(rec.shape) == (h, w)
    _close(rec, tf.idwt2_level_plain(*bands, wavelet, 16, ext=True), True)


def _rows(ext):
    return "extended" if ext else "mirror"


def _b1_exact(x, wavelet, tile=tf.TILE1, ext=False):
    """B1 on ``x`` equals its plain version bit for bit, in one launch; its
    four bands are disjoint, 16-byte-aligned views."""
    tf.reset_counters()
    b = tf.fused_dwt2_level(x, wavelet, tile=tile, boundary_rows=_rows(ext))
    torch.cuda.synchronize()
    assert tf.KERNELS["B1"].launches == 1
    assert _disjoint(b) and all(t.data_ptr() % 16 == 0 for t in b)
    _close(list(b), list(tf.dwt2_level_plain(x, wavelet, tile, ext)), True)
    return b


def _b4_exact(bands, wavelet, tile=tf.TILE1, ext=False):
    """B4 on ``bands`` equals its plain version bit for bit, in one launch."""
    tf.reset_counters()
    rec = tf.fused_idwt2_level(*bands, wavelet, tile=tile, boundary_rows=_rows(ext))
    torch.cuda.synchronize()
    assert tf.KERNELS["B4"].launches == 1
    _close(rec, tf.idwt2_level_plain(*bands, wavelet, tile, ext), True)
    return rec


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [
    (2144, 4096),  # api.dwt2/idwt2 on the main path's frame
    (2161, 4097), (1081, 2049),  # the odd pyramid's two B1 levels
    (513, 511),  # the reference's odd-size gate
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32])
def test_b1_b4_equal_plain_bit_for_bit(cuda_device, h, w, dtype):
    """The frames of B1's and B4's paths in every dtype; int32 (CDF 5/3)
    also equals the oracle and comes back exactly."""
    wavelet = "cdf53" if dtype == torch.int32 else "cdf97"
    x = _img(h, w, dtype, cuda_device, seed=14).to(dtype)
    b = _b1_exact(x, wavelet)
    rec = _b4_exact(b, wavelet)
    if dtype == torch.int32:
        _close(list(b), list(sep.dwt2_level(x, wavelet)), True)
        assert torch.equal(rec, x)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [4, 8, 16, 32, 64, 96])
@pytest.mark.parametrize("dtype,wavelet", [
    (dt, wv) for dt in (torch.float32, torch.float64)
    for wv in ("cdf97", "cdf53", "interp53", "haar")
] + [(torch.int32, wv) for wv in ("cdf97", "cdf53", "haar")])
def test_b1_b4_tiles_and_wavelets_equal_plain(cuda_device, tile, dtype, wavelet):
    """Any tile whose window a block walks (2 * tile + 8 <= 256) gives the
    plain version's bits, for every wavelet the fused kernels take."""
    if dtype == torch.float64 and tile == 96:
        tile = 80  # a 200-wide float64 window is 320 KB, above 227 KB
    x = _img(541, 1025, dtype, cuda_device, seed=15).to(dtype)
    _b4_exact(_b1_exact(x, wavelet, tile), wavelet, tile)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32])
def test_b1_b4_misaligned_inputs_take_the_scalar_loads(cuda_device, dtype):
    """Contiguous views at storage offset 1 are not 16-byte aligned: B1
    copies its window element by element, B4 reads misaligned bands."""
    h, w, wavelet = 1056, 548, "cdf53" if dtype == torch.int32 else "cdf97"
    buf = _img(1, h * w + 1, dtype, cuda_device, seed=16).to(dtype).reshape(-1)
    x = buf[1:1 + h * w].view(h, w)
    assert x.is_contiguous() and x.data_ptr() % 16
    bands = [torch.cat([b.new_zeros(1), b.reshape(-1)])[1:].view(b.shape)
             for b in _b1_exact(x, wavelet)]
    assert all(b.is_contiguous() and b.data_ptr() % 16 for b in bands)
    _b4_exact(bands, wavelet)


@pytest.mark.cuda
def test_b1_b4_refuse_a_tile_too_wide(cuda_device):
    """A window wider than the block's 256 threads is refused by the
    launcher, and the wrapper raises: no quiet fallback."""
    x = _img(256, 256, torch.float32, cuda_device, seed=17)
    b = tf.fused_dwt2_level(x, "cdf97")
    tf.reset_counters()
    with pytest.raises(RuntimeError, match="cudaError"):
        tf.fused_dwt2_level(x, "cdf97", tile=125)
    with pytest.raises(RuntimeError, match="cudaError"):
        tf.fused_idwt2_level(*b, "cdf97", tile=125)
    assert (tf.KERNELS["B1"].launches, tf.KERNELS["B4"].launches) == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32])
@pytest.mark.parametrize("h,w,ext", [(130, 97, True), (131, 97, False), (2161, 4097, False)])
def test_b1_b4_write_their_outputs_and_nothing_else(cuda_device, monkeypatch, dtype, h, w,
                                                    ext):
    """Every allocation the wrappers make is poisoned (NaN; int32's least
    value) before the launch.  Afterwards no output element holds the
    poison (each equals the plain version), and every element of an
    allocation outside its outputs (the 16-byte gaps between B1's four
    bands) still does: no store runs past its band's ceil/floor size, the
    extension's zero rows included."""
    poison = float("nan") if dtype.is_floating_point else -2 ** 31
    made = []

    def poisoned(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            views = list(out) if isinstance(out, (list, tuple)) else [out]
            whole = torch.empty(0, dtype=dtype, device=views[0].device).set_(
                views[0].untyped_storage())
            whole.fill_(poison)
            made.append((whole, views))
            return out
        return wrapped

    monkeypatch.setattr(tf, "_carve", poisoned(tf._carve))
    monkeypatch.setattr(tf, "_empty", poisoned(tf._empty))
    wavelet = "cdf53" if dtype == torch.int32 else "cdf97"
    x = _img(h + (2 * tf.HALO if ext else 0), w, dtype, cuda_device, seed=18).to(dtype)
    b = _b1_exact(x, wavelet, ext=ext)
    cy, cx, fy, fx = -(-h // 2), -(-w // 2), h // 2, w // 2
    e = 2 * tf.CH if ext else 0
    bands = b if not ext else [
        _img(r + e, c, dtype, cuda_device, seed=19 + i).to(dtype)
        for i, (r, c) in enumerate([(cy, cx), (cy, fx), (fy, cx), (fy, fx)])]
    _b4_exact(bands, wavelet, ext=ext)
    assert len(made) == 2
    gaps = []
    for whole, views in made:
        outside = torch.ones(whole.numel(), dtype=torch.bool, device=whole.device)
        for v in views:
            off = (v.data_ptr() - whole.data_ptr()) // v.element_size()
            outside[off: off + v.numel()] = False
            assert not (v.isnan() if dtype.is_floating_point else v == poison).any()
        gap = whole[outside]
        assert bool((gap.isnan() if dtype.is_floating_point else gap == poison).all())
        gaps.append(gap.numel())
    assert gaps[0] > 0  # these widths leave gaps between B1's bands


def _vol(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        a = rng.integers(-255, 256, shape).astype(np.int32)
    else:
        a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device)


VOLUME = [
    ((64, 128, 128), torch.float32, "cdf97", t3.TILE3),  # 16 columns of 8 segments
    ((32, 64, 64), torch.float32, "cdf97", (16, 16, 64)),
    ((10, 34, 32), torch.float32, "cdf97", (4, 8, 8)),
    ((6, 6, 6), torch.float32, "cdf53", (2, 2, 2)),  # no tensor map: copies
    ((16, 16, 16), torch.float32, "interp53", (16, 16, 16)),
    ((16, 24, 16), torch.float32, "haar", (4, 8, 8)),
    ((8, 24, 48), torch.int32, "cdf53", (4, 8, 16)),
    ((32, 64, 64), torch.int32, "cdf97", t3.TILE3),
    # ragged y and x tails (X % 4 != 0: copies); z segments cut mid-column
    # with a short last segment (30 = 8 + 8 + 8 + 6 planes, 38 = 4 x 9 + 2),
    # cross-sections that divide neither Y nor X
    ((30, 70, 66), torch.float32, "cdf97", (8, 16, 16)),
    ((30, 72, 100), torch.float32, "cdf97", (8, 16, 24)),
    ((38, 50, 66), torch.float32, "cdf97", (4, 24, 40)),
    ((30, 72, 100), torch.float64, "cdf97", (8, 16, 24)),
    ((38, 50, 66), torch.float64, "cdf53", (4, 8, 12)),
    ((30, 72, 100), torch.int32, "cdf97", (8, 16, 24)),
    ((38, 50, 66), torch.int32, "cdf53", (4, 24, 10)),
    # x cores that are not whole 16-byte chunks, on aligned rows: a box
    # would start misaligned at x0 - 4, so copies
    ((32, 64, 64), torch.int32, "cdf53", (4, 24, 10)),
    # B14 on boxes; B15's band rows (X / 2 = 34) not 16-byte multiples
    ((64, 64, 68), torch.float32, "cdf97", t3.TILE3),
    # B14's window planes not 128-byte multiples (ty = 10): copies
    ((32, 64, 64), torch.float32, "cdf97", (4, 10, 16)),
    ((32, 64, 64), torch.float64, "cdf97", t3.TILE3_F64),
    # B15's band rows start mid-chunk (tx / 2 = 6); B14 boxes from x = -4
    ((32, 64, 64), torch.float32, "cdf53", (4, 16, 12)),
]
#: B14's feed in some VOLUME cases, by index
VOLUME_FEEDS = {0: "boxes", 3: "copies", 9: "boxes", 12: "boxes", 15: "copies", 16: "boxes",
                17: "copies", 18: "boxes", 19: "boxes"}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,wavelet,tile", VOLUME)
def test_b14_b15_kernels_match_plain(cuda_device, shape, dtype, wavelet, tile):
    """B14/B15 == their plain versions bit for bit in every dtype, one
    launch a direction."""
    x = _vol(shape, dtype, cuda_device, seed=6).to(dtype)
    tf.reset_counters()
    b = t3.fused_dwt3_level(x, wavelet, tile=tile)
    want = t3.dwt3_level_plain(x, wavelet, tile)
    _close([b[k] for k in t3.BANDS], [want[k] for k in t3.BANDS], True)
    rec = t3.fused_idwt3_level(b, wavelet, tile=tile)
    _close(rec, t3.idwt3_level_plain(b, wavelet, tile), True)
    torch.cuda.synchronize()
    assert (tf.KERNELS["B14"].launches, tf.KERNELS["B15"].launches) == (1, 1)
    if dtype == torch.int32:
        oracle = sep.dwt3_level(x, wavelet)
        _close([b[k] for k in t3.BANDS], [oracle[k] for k in t3.BANDS], True)
        assert torch.equal(rec, x)


@pytest.mark.cuda
def test_b14_b15_feeds(cuda_device):
    """Each VOLUME case takes the feed that fused3d.feed_of names for B14:
    tensor boxes where a tensor map serves the volume and tile, else B16's
    row copies; both feeds occur.  B15 reports B17's chunk copies."""
    seen = set()
    for i, (shape, dtype, wavelet, tile) in enumerate(VOLUME):
        x = _vol(shape, dtype, cuda_device, seed=6).to(dtype)
        t3.fused_dwt3_level(x, wavelet, tile=tile)
        got = t3.LAST_FEED["B14"]
        assert got == t3.feed_of(shape, tile, x.element_size())
        assert got == VOLUME_FEEDS.get(i, got)
        assert t3.kernel_info(dtype, wavelet, False, tile, shape)["feed"] == got
        assert t3.kernel_info(dtype, wavelet, True, tile, shape)["feed"] == "copies"
        seen.add(got)
    assert seen == {"boxes", "copies"}
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_fused_volume_on_card_matches_oracle(cuda_device, no_tune_table):
    v = _vol((64, 128, 128), torch.float32, cuda_device, seed=7)
    tf.reset_counters()
    coeffs = api.wavedec3(v, "cdf97", 2, impl="fused")
    rec = api.waverec3(coeffs, "cdf97", impl="fused")
    torch.cuda.synchronize()
    assert {k: s.launches for k, s in tf.KERNELS.items() if s.launches} == {
        "B14": 2, "B15": 2}
    want = sep.wavedec3(v, "cdf97", 2)
    assert float((coeffs[0] - want[0]).abs().max()) <= 5e-4
    for got_l, want_l in zip(coeffs[1:], want[1:]):
        assert max(float((got_l[k] - want_l[k]).abs().max()) for k in want_l) <= 5e-4
    assert float((rec - v).abs().max()) <= 1e-3
    # 'auto' on a CUDA volume takes the same kernels
    tf.reset_counters()
    api.waverec3(api.wavedec3(v, "cdf97", 2), "cdf97")
    assert (tf.KERNELS["B14"].launches, tf.KERNELS["B15"].launches) == (2, 2)


@pytest.mark.cuda
def test_single_levels_reach_the_kernels_through_the_api(cuda_device, no_tune_table):
    x = _img(1025, 1031, torch.float32, cuda_device, seed=8)
    tf.reset_counters()
    got = api.wavedec2(x, "cdf97", 3, impl="fused")
    b = api.dwt2(x, "cdf97")  # 'auto' on the card: 1024 <= min < 2048
    rec = api.idwt2(*b, "cdf97")
    torch.cuda.synchronize()
    assert {k: s.launches for k, s in tf.KERNELS.items() if s.launches} == {
        "B1": 2, "B3": 1, "B4": 1}
    for a, c in zip(_leaves(got), _leaves(sep.wavedec2(x, "cdf97", 3))):
        assert float((a - c).abs().max()) <= 5e-4
    assert float((rec - x).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_auto_keeps_float64_on_the_oracle(cuda_device, no_tune_table):
    """'auto' on a float64 CUDA tensor takes the kernels (B1/B4, B14/B15),
    as for float32, bit for bit equal to their plain versions (the name
    dates from when 'auto' kept float64 on the separable oracle)."""
    x = _img(1024, 1030, torch.float32, cuda_device, seed=9).double()
    v = _vol((16, 32, 32), torch.float32, cuda_device, seed=10).double()
    tf.reset_counters()
    got2 = api.dwt2(x, "cdf97")
    rec2 = api.idwt2(*got2, "cdf97")
    got3 = api.wavedec3(v, "cdf97", 1)
    rec3 = api.waverec3(got3, "cdf97")
    torch.cuda.synchronize()
    assert {k: s.launches for k, s in tf.KERNELS.items() if s.launches} == {
        "B1": 1, "B4": 1, "B14": 1, "B15": 1}
    _close(list(got2), list(tf.dwt2_level_plain(x, "cdf97")), True)
    _close(rec2, tf.idwt2_level_plain(*got2, "cdf97"), True)
    assert float((rec2 - x).abs().max()) <= 1e-9
    want3 = t3.dwt3_level_plain(v, "cdf97")
    assert torch.equal(got3[0], want3["LLL"])
    assert all(torch.equal(got3[1][k], want3[k]) for k in got3[1])
    assert float((rec3 - v).abs().max()) <= 1e-9


@pytest.mark.cuda
def test_default_follows_the_packaged_table(cuda_device, tmp_path, monkeypatch):
    """With no tune file, 'auto' (impl=None) on the frame and the volume
    runs what the packaged table picks for this card: the launches and the
    bits of the same call with that impl named."""
    monkeypatch.delenv("LIBDWT_TORCH_TUNE_FILE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    autotune.clear_cache()

    def run(fn):
        tf.reset_counters()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: s.launches for k, s in tf.KERNELS.items() if s.launches}

    x = _img(2144, 4096, torch.float32, cuda_device, seed=11)
    v = _vol((64, 512, 512), torch.float32, cuda_device, seed=12)
    f32 = torch.float32
    cases = (
        (lambda i=None: api.wavedec2(x, "cdf97", 5, impl=i),
         lambda c, i=None: api.waverec2(c, "cdf97", impl=i),
         api._pick_impl(2144, 4096, "cdf97", None, True, f32, levels=5),
         api._pick_impl(2144, 4096, "cdf97", None, True, f32, levels=5, direction="inv")),
        (lambda i=None: api.wavedec3(v, "cdf97", 2, impl=i),
         lambda c, i=None: api.waverec3(c, "cdf97", impl=i),
         api._pick_impl3((64, 512, 512), "cdf97", None, True, f32, "fwd"),
         api._pick_impl3((64, 512, 512), "cdf97", None, True, f32, "inv")),
    )
    for dec, rec, fwd, inv in cases:
        c, lc = run(dec)
        cx, lcx = run(lambda: dec(fwd))
        r, lr = run(lambda: rec(c))
        rx, lrx = run(lambda: rec(c, inv))
        assert (lc, lr) == (lcx, lrx)
        flat = [b for lvl in c for b in (lvl.values() if isinstance(lvl, dict) else [lvl])]
        flatx = [b for lvl in cx for b in (lvl.values() if isinstance(lvl, dict) else [lvl])]
        _close(flat, flatx, True)
        _close(r, rx, True)
    autotune.clear_cache()


STREAMED = [
    # (h, w, dtype, wavelet, ty, tx): ragged last strips (260, 204, 200 rows)
    # and bands (132, 100 columns), short quarter tails (remq 1..3)
    (260, 128, torch.float32, "cdf97", 64, 64),
    (204, 132, torch.float32, "cdf97", 32, 48),
    (512, 384, torch.float32, "cdf53", 128, 128),  # 117 KB of shared memory
    (256, 256, torch.float32, "haar", 64, 64),
    (200, 100, torch.float32, "interp53", 16, 20),
    (200, 128, torch.int32, "cdf53", 64, 64),
    (288, 128, torch.int32, "cdf97", 16, 16),
    (260, 128, torch.float64, "cdf97", 64, 64),
    (204, 132, torch.float64, "cdf97", 32, 48),
    # the largest float64 strip: its window and LL1 window take 225 KB
    (512, 384, torch.float64, "cdf97", 128, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,dtype,wavelet,ty,tx", STREAMED)
def test_b8_b10_kernels_match_plain(cuda_device, h, w, dtype, wavelet, ty, tx):
    """B8/B10 run the strip phase of B11/B12 alone: == their plain
    versions bit for bit in every dtype."""
    x = _img(h, w, dtype, cuda_device, seed=11).to(dtype)
    tf.reset_counters()
    c2 = ts.streamed_dwt2_2level(x, wavelet, ty=ty, tx=tx)
    _close(list(c2), list(ts.streamed_dwt2_2level_plain(x, wavelet, ty, tx)), True)
    rec = ts.streamed_idwt2_2level(*c2, wavelet, ty=ty, tx=tx)
    _close(rec, ts.streamed_idwt2_2level_plain(*c2, wavelet, ty, tx), True)
    torch.cuda.synchronize()
    assert (tf.KERNELS["B8"].launches, tf.KERNELS["B10"].launches) == (1, 1)
    if dtype == torch.int32:
        assert torch.equal(rec, x)
        _close(list(c2), sep.wavedec2(x, wavelet, 2), True)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,dtype,wavelet,ty,tx", STREAMED + [
    (2144, 4096, torch.float32, "cdf97", 64, 64)])  # the streamed J=2 path's frame
def test_b8_b10_equal_b2_b5(cuda_device, h, w, dtype, wavelet, ty, tx):
    """B8 runs B2's window body and B10 B5's, with B2/B5's halos, on any
    strip: on the card B8 equals B2 and B10 equals B5 bit for bit."""
    x = _img(h, w, dtype, cuda_device, seed=17).to(dtype)
    c2 = ts.streamed_dwt2_2level(x, wavelet, ty=ty, tx=tx)
    _close(list(c2), list(tf.fused_dwt2_2level(x, wavelet)), True)
    rec = ts.streamed_idwt2_2level(*c2, wavelet, ty=ty, tx=tx)
    _close(rec, tf.fused_idwt2_2level(*c2, wavelet), True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32])
def test_b8_b10_strip_kernels_fit_their_blocks(cuda_device, dtype):
    """dwt_s2info: the registers, blocks an SM and grid of B8/B10's kernels
    at the default strip; the grid is the strip plan of the blocks that fit,
    and a strip whose window lines outgrow the block is refused."""
    wavelet = "cdf53" if dtype == torch.int32 else "cdf97"
    for inverse in (False, True):
        info = ts.strip_kernel_info(dtype, wavelet, inverse)
        assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        nbands, nstrips = 4096 // 64, -(-2144 // 64)
        nseg = max(1, min(nstrips, info["blocks_per_sm"] * sms // nbands))
        sps = -(-nstrips // nseg)
        assert info["grid"] == nbands * -(-nstrips // sps)
    x = _img(256, 256, dtype, cuda_device).to(dtype)
    with pytest.raises(RuntimeError):
        ts.streamed_dwt2_2level(x, wavelet, ty=236, tx=16)


STREAMED_DEEP = [
    (256, 320, 4, torch.float32, "cdf97", 64, 64),
    (512, 384, 5, torch.float32, "cdf97", 32, 32),
    (1036, 128, 3, torch.float32, "cdf97", 64, 64),  # short quarter tail
    (260, 256, 3, torch.float32, "cdf53", 64, 48),
    (256, 320, 4, torch.int32, "cdf53", 64, 64),
    (512, 384, 5, torch.int32, "cdf97", 32, 16),
    (1036, 128, 3, torch.float64, "cdf97", 64, 64),
    (260, 256, 3, torch.float64, "cdf97", 32, 48),
    # the largest float64 strip: its window and LL1 window take 225 KB of a
    # block's 227 KB (two windows would not fit)
    (512, 384, 5, torch.float64, "cdf97", 128, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,level,dtype,wavelet,ty,tx", STREAMED_DEEP)
def test_b11_b12_kernels_match_plain(cuda_device, h, w, level, dtype, wavelet, ty, tx):
    x = _img(h, w, dtype, cuda_device, seed=12).to(dtype)
    tf.reset_counters()
    d = ts.streamed_wavedec2_deep(x, wavelet, level, ty=ty, tx=tx)
    _close(d, ts.streamed_wavedec2_deep_plain(x, wavelet, level, ty, tx), True)
    rec = ts.streamed_waverec2_deep(d, wavelet, ty=ty, tx=tx)
    _close(rec, ts.streamed_waverec2_deep_plain(d, wavelet, ty, tx), True)
    torch.cuda.synchronize()
    assert (tf.KERNELS["B11"].launches, tf.KERNELS["B12"].launches) == (1, 1)
    for kid in ("B11", "B12"):  # the cooperative grid fits the card at once
        grid, resident = ts.LAST_GRID[kid]
        assert 1 <= grid <= resident
    if dtype == torch.int32:
        _close(d, sep.wavedec2(x, wavelet, level), True)
        assert torch.equal(rec, x)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,level,ty,tx,dtype", [
    (2144, 4096, 5, 64, 64, torch.float32), (2144, 4096, 5, 64, 64, torch.int32),
    # float64 LL2 of a 4K frame exceeds the deep tail's resident limit
    (1024, 1024, 4, 64, 64, torch.float64),
    (1036, 128, 3, 32, 48, torch.float32), (1036, 128, 3, 32, 48, torch.float64),
    (1036, 128, 3, 32, 48, torch.int32)])
def test_b11_b12_equal_the_fused_kernels(cuda_device, h, w, level, ty, tx, dtype):
    """B11 runs B2's strip body and B3's deep levels, B12 B6's levels and
    B5's body: on the card, B11's pyramid equals B2 then B3, and B12's
    reconstruction B6 then B5, bit for bit."""
    wavelet = "cdf53" if dtype == torch.int32 else "cdf97"
    x = _img(h, w, dtype, cuda_device, seed=16).to(dtype)
    d = ts.streamed_wavedec2_deep(x, wavelet, level, ty=ty, tx=tx)
    ll2, b2, b1 = tf.fused_dwt2_2level(x, wavelet)
    _close(d, list(tf.fused_deep_wavedec2(ll2, wavelet, level - 2)) + [b2, b1], True)
    rec = ts.streamed_waverec2_deep(d, wavelet, ty=ty, tx=tx)
    ll2 = tf.fused_deep_waverec2(d[:-2], wavelet)
    _close(rec, tf.fused_idwt2_2level(ll2, d[-2], d[-1], wavelet), True)


@pytest.mark.cuda
def test_streamed_pyramid_on_card_matches_oracle(cuda_device):
    x = _img(1024, 2560, torch.float32, cuda_device, seed=13)
    for level, kids in ((5, {"B11": 1, "B12": 1}), (2, {"B8": 1, "B10": 1})):
        tf.reset_counters()
        coeffs = api.wavedec2(x, "cdf97", level, impl="streamed")
        rec = api.waverec2(coeffs, "cdf97", impl="streamed")
        torch.cuda.synchronize()
        assert {k: s.launches for k, s in tf.KERNELS.items() if s.launches} == kids
        for a, b in zip(_leaves(coeffs), _leaves(sep.wavedec2(x, "cdf97", level))):
            assert a.shape == b.shape and float((a - b).abs().max()) <= 5e-4
        assert float((rec - x).abs().max()) <= 1e-3
    # the banded body (B13) runs in the same kernels under 'streamed-mxu'
    for level, kids in ((5, {"B11": 1, "B12": 1, "B13": 2}),
                        (2, {"B8": 1, "B10": 1, "B13": 2})):
        tf.reset_counters()
        coeffs = api.wavedec2(x, "cdf97", level, impl="streamed-mxu")
        rec = api.waverec2(coeffs, "cdf97", impl="streamed-mxu")
        torch.cuda.synchronize()
        assert {k: s.launches for k, s in tf.KERNELS.items() if s.launches} == kids
        for a, b in zip(_leaves(coeffs), _leaves(sep.wavedec2(x, "cdf97", level))):
            assert a.shape == b.shape and float((a - b).abs().max()) <= 5e-4
        assert float((rec - x).abs().max()) <= 5e-4


SINGLE = [
    # (h, w, dtype, wavelet, ty, tx): ragged last strips (260, 204, 200 rows)
    # and bands (132, 100 columns), short tails (204 rows at ty=64: 12)
    (260, 128, torch.float32, "cdf97", 64, 64),
    (204, 132, torch.float32, "cdf97", 64, 48),
    (512, 384, torch.float32, "cdf53", 128, 128),  # 73 KB of shared memory
    (256, 256, torch.float32, "haar", 32, 64),
    (200, 100, torch.float32, "interp53", 16, 20),
    (200, 128, torch.int32, "cdf53", 64, 64),
    (288, 132, torch.int32, "cdf97", 16, 16),
    (256, 256, torch.int32, "haar", 32, 32),
    (204, 132, torch.float64, "cdf97", 64, 48),
    (512, 384, torch.float64, "cdf97", 128, 128),  # 147 KB of shared memory
    # the widest strip side a block takes: a window line of 256 samples
    (512, 512, torch.float32, "cdf97", 248, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,dtype,wavelet,ty,tx", SINGLE)
def test_b7_b9_kernels_match_plain(cuda_device, h, w, dtype, wavelet, ty, tx):
    """B7/B9 run B1/B4's one-level body on a strip: == their plain versions
    bit for bit in every dtype."""
    x = _img(h, w, dtype, cuda_device, seed=14).to(dtype)
    tf.reset_counters()
    b = ts.streamed_dwt2_level(x, wavelet, ty=ty, tx=tx)
    _close(list(b), list(ts.streamed_dwt2_level_plain(x, wavelet, ty, tx)), True)
    rec = ts.streamed_idwt2_level(*b, wavelet, ty=ty, tx=tx)
    _close(rec, ts.streamed_idwt2_level_plain(*b, wavelet, ty, tx), True)
    torch.cuda.synchronize()
    assert (tf.KERNELS["B7"].launches, tf.KERNELS["B9"].launches) == (1, 1)
    if dtype == torch.int32:
        _close(list(b), list(sep.dwt2_level(x, wavelet)), True)
        assert torch.equal(rec, x)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,dtype,ty,tx", [
    (2144, 4096, torch.float32, 64, 64),  # the streamed single-level path's frame
    (260, 132, torch.float32, 32, 48), (260, 132, torch.float64, 64, 64),
    (260, 132, torch.int32, 16, 20)])
def test_b7_b9_equal_b1_b4(cuda_device, h, w, dtype, ty, tx):
    """B7 runs B1's body and B9 B4's, with their halo of 4, on any strip:
    on the card B7 equals B1 and B9 equals B4 bit for bit."""
    wavelet = "cdf53" if dtype == torch.int32 else "cdf97"
    x = _img(h, w, dtype, cuda_device, seed=20).to(dtype)
    b = ts.streamed_dwt2_level(x, wavelet, ty=ty, tx=tx)
    _close(list(b), list(tf.fused_dwt2_level(x, wavelet)), True)
    rec = ts.streamed_idwt2_level(*b, wavelet, ty=ty, tx=tx)
    _close(rec, tf.fused_idwt2_level(*b, wavelet), True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32])
def test_b7_b9_level_kernels_fit_their_blocks(cuda_device, dtype):
    """dwt_s1info: the registers, blocks an SM and grid of B7/B9's kernels
    at the default strip (one block a strip); a strip side over 248, whose
    window lines outgrow the block, is refused both ways."""
    wavelet = "cdf53" if dtype == torch.int32 else "cdf97"
    for inverse in (False, True):
        for ext in (0, ts.TOP):
            info = ts.level_kernel_info(dtype, wavelet, inverse, ext=ext)
            assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
            assert info["grid"] == (4096 // 64) * -(-2144 // 64)
            item = torch.empty((), dtype=dtype).element_size()
            assert info["smem"] == item * 72 * 74
    x = _img(512, 512, dtype, cuda_device).to(dtype)
    with pytest.raises(RuntimeError):
        ts.streamed_dwt2_level(x, wavelet, ty=252, tx=16)
    b = ts.streamed_dwt2_level(x, wavelet)
    with pytest.raises(RuntimeError):
        ts.streamed_idwt2_level(*b, wavelet, ty=16, tx=252)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,dtype,wavelet,ty,tx", [
    (512, 512, torch.float32, "cdf97", 64, 64), (260, 132, torch.float32, "cdf53", 32, 48),
    (260, 132, torch.int32, "cdf53", 64, 64), (204, 128, torch.int32, "cdf97", 16, 20),
    (260, 132, torch.float64, "cdf97", 32, 64)])
def test_streamed_extended_rows_kernels_match_plain(cuda_device, h, w, dtype, wavelet,
                                                    ty, tx):
    """The 8-row (TOP) contract of the single streamed levels, both ways,
    bit for bit in every dtype."""
    xe = _img(h + 2 * ts.TOP, w, dtype, cuda_device, seed=15).to(dtype)
    b = ts.streamed_dwt2_level(xe, wavelet, boundary_rows="extended", ty=ty, tx=tx)
    _close(list(b), list(ts.streamed_dwt2_level_plain(xe, wavelet, ty, tx, ts.TOP)), True)
    assert tuple(b[0].shape) == (h // 2, w // 2)
    bands = [_img(h // 2 + 2 * ts.TOP, w // 2, dtype, cuda_device, seed=16 + i).to(dtype)
             for i in range(4)]
    rec = ts.streamed_idwt2_level(*bands, wavelet, boundary_rows="extended", ty=ty, tx=tx)
    assert tuple(rec.shape) == (h, w)
    _close(rec, ts.streamed_idwt2_level_plain(*bands, wavelet, ty, tx, ts.TOP), True)


SVOLUME = [
    ((64, 128, 128), torch.float32, "cdf97", ts3.STILE3),  # 16 columns of 8 segments
    ((32, 64, 64), torch.float32, "cdf97", (16, 16, 16)),
    ((30, 70, 66), torch.float32, "cdf97", (8, 16, 16)),   # ragged z, y, x tails
    ((10, 34, 32), torch.float32, "cdf53", (4, 8, 8)),
    ((16, 16, 16), torch.float32, "interp53", (16, 16, 16)),
    ((16, 24, 16), torch.float32, "haar", (4, 8, 8)),
    ((30, 70, 66), torch.int32, "cdf53", (8, 16, 16)),
    ((32, 64, 64), torch.int32, "cdf97", ts3.STILE3),
    ((16, 24, 16), torch.int32, "haar", (2, 4, 4)),
    # z segments cut mid-column with a short last segment (30 = 8 + 8 + 8 +
    # 6 planes, 38 = 4 x 9 + 2), cross-sections that divide neither Y nor
    # X, x cores that are not whole 16-byte chunks
    ((30, 72, 100), torch.float32, "cdf97", (8, 16, 24)),
    ((38, 50, 66), torch.float32, "cdf97", (4, 24, 40)),
    ((30, 72, 100), torch.float64, "cdf97", (8, 16, 24)),
    ((38, 50, 66), torch.float64, "cdf53", (4, 8, 12)),
    ((30, 72, 100), torch.int32, "cdf97", (8, 16, 24)),
    ((38, 50, 66), torch.int32, "cdf53", (4, 24, 10)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,wavelet,tile", SVOLUME)
def test_b16_b17_kernels_match_plain(cuda_device, shape, dtype, wavelet, tile):
    """B16/B17 == their plain versions bit for bit in every dtype, one
    launch a direction."""
    x = _vol(shape, dtype, cuda_device, seed=17).to(dtype)
    tf.reset_counters()
    b = ts3.streamed_dwt3_level(x, wavelet, tile=tile)
    want = ts3.dwt3_level_streamed_plain(x, wavelet, tile)
    _close([b[k] for k in t3.BANDS], [want[k] for k in t3.BANDS], True)
    rec = ts3.streamed_idwt3_level(b, wavelet, tile=tile)
    _close(rec, ts3.idwt3_level_streamed_plain(b, wavelet, tile), True)
    torch.cuda.synchronize()
    assert (tf.KERNELS["B16"].launches, tf.KERNELS["B17"].launches) == (1, 1)
    if dtype == torch.int32:
        oracle = sep.dwt3_level(x, wavelet)
        _close([b[k] for k in t3.BANDS], [oracle[k] for k in t3.BANDS], True)
        assert torch.equal(rec, x)


@pytest.mark.cuda
def test_streamed_levels_and_volume_on_card_match_oracle(cuda_device):
    x = _img(1024, 2560, torch.float32, cuda_device, seed=18)
    v = _vol((64, 128, 128), torch.float32, cuda_device, seed=19)
    tf.reset_counters()
    b = api.dwt2(x, "cdf97", impl="streamed")
    rec = api.idwt2(*b, "cdf97", impl="streamed")
    c3 = api.wavedec3(v, "cdf97", 2, impl="streamed")
    r3 = api.waverec3(c3, "cdf97", impl="streamed")
    torch.cuda.synchronize()
    assert {k: s.launches for k, s in tf.KERNELS.items() if s.launches} == {
        "B7": 1, "B9": 1, "B16": 2, "B17": 2}
    assert float(max((p - q).abs().max() for p, q in zip(b, sep.dwt2_level(x, "cdf97")))) <= 3e-5
    assert float((rec - x).abs().max()) <= 1e-3
    want = sep.wavedec3(v, "cdf97", 2)
    assert float((c3[0] - want[0]).abs().max()) <= 5e-4
    for got_l, want_l in zip(c3[1:], want[1:]):
        assert max(float((got_l[k] - want_l[k]).abs().max()) for k in want_l) <= 5e-4
    assert float((r3 - v).abs().max()) <= 1e-3


def _close_mxu(got, want):
    """The banded body against its plain version: finite, within 2e-5."""
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype and a.is_cuda
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 2e-5


MXU_STREAMED = [
    # (h, w, wavelet, ty, tx): ragged last strips (260, 204, 200, 520 rows)
    # and bands (132, 100, 392 columns), short quarter tails; windows whose
    # lengths are not multiples of 8 or 16 (88, 40, 72, 44, ... samples);
    # 96x96, the banded body's default strip, and 128x128, its largest here
    (260, 128, "cdf97", 64, 64),
    (204, 132, "cdf97", 32, 48),
    (512, 384, "cdf53", 64, 96),
    (256, 256, "haar", 64, 64),
    (200, 100, "interp53", 16, 20),
    (288, 128, "cdf97", 16, 16),
    (520, 392, "cdf97", 96, 96),
    (512, 384, "cdf97", 128, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,wavelet,ty,tx", MXU_STREAMED)
def test_b13_in_b8_b10_matches_plain(cuda_device, h, w, wavelet, ty, tx):
    x = _img(h, w, torch.float32, cuda_device, seed=20)
    tf.reset_counters()
    c2 = ts.streamed_dwt2_2level(x, wavelet, body="mxu", ty=ty, tx=tx)
    _close_mxu(list(c2), list(ts.streamed_dwt2_2level_plain(x, wavelet, ty, tx, body="mxu")))
    rec = ts.streamed_idwt2_2level(*c2, wavelet, body="mxu", ty=ty, tx=tx)
    _close_mxu(rec, ts.streamed_idwt2_2level_plain(*c2, wavelet, ty, tx, body="mxu"))
    torch.cuda.synchronize()
    assert {k: s.launches for k, s in tf.KERNELS.items() if s.launches} == {
        "B8": 1, "B10": 1, "B13": 2}
    assert float((rec - x).abs().max()) <= 5e-4


MXU_DEEP = [
    (256, 320, 4, "cdf97", 64, 64),
    (512, 384, 5, "cdf97", 32, 32),
    (1036, 128, 3, "cdf97", 64, 64),  # short quarter tail
    (260, 256, 3, "cdf53", 64, 48),
    (520, 392, 4, "cdf97", 96, 96),  # the default strip, ragged
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,level,wavelet,ty,tx", MXU_DEEP)
def test_b13_in_b11_b12_matches_plain(cuda_device, h, w, level, wavelet, ty, tx):
    x = _img(h, w, torch.float32, cuda_device, seed=21)
    tf.reset_counters()
    d = ts.streamed_wavedec2_deep(x, wavelet, level, body="mxu", ty=ty, tx=tx)
    _close_mxu(d, ts.streamed_wavedec2_deep_plain(x, wavelet, level, ty, tx, body="mxu"))
    rec = ts.streamed_waverec2_deep(d, wavelet, body="mxu", ty=ty, tx=tx)
    _close_mxu(rec, ts.streamed_waverec2_deep_plain(d, wavelet, ty, tx, body="mxu"))
    torch.cuda.synchronize()
    assert {k: s.launches for k, s in tf.KERNELS.items() if s.launches} == {
        "B11": 1, "B12": 1, "B13": 2}
    for kid in ("B11", "B12"):  # the banded body's cooperative grid fits the card
        grid, resident = ts.LAST_GRID[kid]
        assert 1 <= grid <= resident


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,level,wavelet,ty,tx", MXU_DEEP)
def test_b11_b12_mxu_equal_b8_b10_mxu_and_the_deep_tails(cuda_device, h, w, level, wavelet,
                                                          ty, tx):
    """B11 and B12 with the banded body run B8/B10's banded strips (the same
    kernel with no deep level) and B3/B6's deep levels: B11-mxu equals
    B8-mxu then B3, and B12-mxu B6 then B10-mxu, bit for bit."""
    x = _img(h, w, torch.float32, cuda_device, seed=23)
    d = ts.streamed_wavedec2_deep(x, wavelet, level, body="mxu", ty=ty, tx=tx)
    ll2, b2, b1 = ts.streamed_dwt2_2level(x, wavelet, body="mxu", ty=ty, tx=tx)
    _close(d, list(tf.fused_deep_wavedec2(ll2, wavelet, level - 2)) + [b2, b1], True)
    rec = ts.streamed_waverec2_deep(d, wavelet, body="mxu", ty=ty, tx=tx)
    ll2 = tf.fused_deep_waverec2(d[:-2], wavelet)
    _close(rec, ts.streamed_idwt2_2level(ll2, d[-2], d[-1], wavelet, body="mxu", ty=ty, tx=tx),
           True)


@pytest.mark.cuda
def test_b13_refuses_int32_on_the_card(cuda_device):
    xi = _img(256, 320, torch.int32, cuda_device, seed=22)
    tf.reset_counters()
    with pytest.raises(ValueError, match="float32"):
        api.wavedec2(xi, "cdf53", 4, impl="streamed-mxu")
    with pytest.raises(ValueError, match="float32"):
        ts.streamed_dwt2_2level(xi, "cdf53", body="mxu")
    c = ts.streamed_wavedec2_deep(xi, "cdf53", 4)
    with pytest.raises(ValueError, match="float32"):
        api.waverec2(c, "cdf53", impl="streamed-mxu")
    with pytest.raises(ValueError, match="float32"):
        ts.streamed_waverec2_deep(c, "cdf53", body="mxu")
    assert tf.KERNELS["B13"].launches == 0


@pytest.mark.cuda
def test_b2_b3_records_start_after_their_launch_spans(cuda_device):
    """The program's spans and the profiler's device records share one
    clock (``time.time_ns()``): in a short profiled loop of the fused J=5
    pyramid of a 3x2160x4096 frame, every B2/B3 record starts after the
    start of the ``kernel.launch`` span that issued it, matched in order.
    Prints the offsets (µs)."""
    from torch.profiler import ProfilerActivity, profile

    from libdwt_torch.utils import trace

    x = _img(2160, 4096, torch.float32, cuda_device, seed=31).expand(3, -1, -1).contiguous()
    api.wavedec2(x, "cdf97", 5, impl="fused")
    torch.cuda.synchronize()
    with trace.recording() as rec, profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            api.wavedec2(x, "cdf97", 5, impl="fused")
        torch.cuda.synchronize()
    starts = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if "fwd2_kernel" in e.name() or "deep_fwd_kernel" in e.name():
            starts.append(e.start_ns() if hasattr(e, "start_ns") else 1000 * e.start_us())
    launches = sorted(s for name, s, _, _ in rec.spans if name == "kernel.launch")
    starts.sort()
    assert len(starts) == len(launches) == 4 * 3 * 2
    offsets = [(r - s) / 1e3 for r, s in zip(starts, launches)]
    print(f"B2/B3 record start - kernel.launch span start (us): min {min(offsets):.1f}, "
          f"median {sorted(offsets)[len(offsets) // 2]:.1f}, max {max(offsets):.1f}; "
          f"all {[round(o, 1) for o in offsets]}")
    assert min(offsets) >= 0
