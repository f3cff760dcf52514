"""The port's CUDA kernels on the card, each held against its plain version
(B1-B6 2-D, B7-B12 streamed 2-D, B13 the banded body in B8/B10/B11/B12,
B14-B17 3-D).

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports torch, numpy and the port only (no JAX), so it also runs on a
GPU machine that has no JAX installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts= -q

Inputs come from a numpy seed.  float32 is held to 3e-5 (the kernels and
their plain versions round the same way, so they usually agree exactly),
int32 bit-exactly; the banded body to 2e-5 (the tensor cores sum in
another order than the plain version's matrix products).  The shapes cover several tiles with short last tiles,
odd deep-tail sizes, every wavelet ``fused_supported`` accepts, the
extended-rows contracts of the single levels (4 rows fused, 8 streamed),
2-D and 3-D tiles whose shared memory exceeds the 48 KB default, streamed
strips with ragged last strips and bands and short tails, and streamed
volume tiles with ragged z, y and x tails.
"""
import numpy as np
import pytest
import torch

from libdwt_torch import api
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
    x = _img(h, w, dtype, cuda_device, seed=1)
    exact = dtype == torch.int32
    tf.reset_counters()
    d = tf.fused_deep_wavedec2(x, wavelet, levels, tile=tile)
    _close(d, tf.fused_deep_wavedec2_plain(x, wavelet, levels, tile), exact)
    rec = tf.fused_deep_waverec2(d, wavelet, tile=tile)
    _close(rec, tf.fused_deep_waverec2_plain(d, wavelet, tile), exact)
    torch.cuda.synchronize()
    assert (tf.KERNELS["B3"].launches, tf.KERNELS["B6"].launches) == (levels, levels)
    if exact:
        _close(d, sep.wavedec2(x, wavelet, levels), True)
        assert torch.equal(rec, x)


@pytest.mark.cuda
def test_fused_pyramid_on_card_matches_oracle(cuda_device):
    x = _img(1024, 2560, torch.float32, cuda_device, seed=2)
    tf.reset_counters()
    coeffs = api.wavedec2(x, "cdf97", 5, impl="fused")
    rec = api.waverec2(coeffs, "cdf97", impl="fused")
    torch.cuda.synchronize()
    assert {k: s.launches for k, s in tf.KERNELS.items() if s.launches} == {
        "B2": 1, "B3": 3, "B5": 1, "B6": 3}
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
    exact = dtype == torch.int32
    tf.reset_counters()
    b = tf.fused_dwt2_level(x, wavelet, tile=tile)
    _close(list(b), list(tf.dwt2_level_plain(x, wavelet, tile)), exact)
    rec = tf.fused_idwt2_level(*b, wavelet, tile=tile)
    _close(rec, tf.idwt2_level_plain(*b, wavelet, tile), exact)
    torch.cuda.synchronize()
    assert (tf.KERNELS["B1"].launches, tf.KERNELS["B4"].launches) == (1, 1)
    if exact:
        _close(list(b), list(sep.dwt2_level(x, wavelet)), True)
        assert torch.equal(rec, x)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,dtype,wavelet", [
    (512, 512, torch.float32, "cdf97"), (130, 97, torch.float32, "cdf53"),
    (130, 97, torch.int32, "cdf53"), (131, 97, torch.float32, "cdf97"),
    (65, 48, torch.int32, "cdf53")])
def test_extended_rows_kernels_match_plain(cuda_device, h, w, dtype, wavelet):
    """The forward contract needs an even height; the inverse takes any."""
    exact = dtype == torch.int32
    if h % 2 == 0:
        xe = _img(h + 2 * tf.HALO, w, dtype, cuda_device, seed=4)
        b = tf.fused_dwt2_level(xe, wavelet, boundary_rows="extended", tile=16)
        _close(list(b), list(tf.dwt2_level_plain(xe, wavelet, 16, ext=True)), exact)
    cy, fy, cx, fx = -(-h // 2), h // 2, -(-w // 2), w // 2
    bands = [_img(r + 2 * tf.CH, c, dtype, cuda_device, seed=5 + i)
             for i, (r, c) in enumerate([(cy, cx), (cy, fx), (fy, cx), (fy, fx)])]
    rec = tf.fused_idwt2_level(*bands, wavelet, boundary_rows="extended", tile=16)
    assert tuple(rec.shape) == (h, w)
    _close(rec, tf.idwt2_level_plain(*bands, wavelet, 16, ext=True), exact)


def _vol(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        a = rng.integers(-255, 256, shape).astype(np.int32)
    else:
        a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device)


VOLUME = [
    ((64, 128, 128), torch.float32, "cdf97", t3.TILE3),  # 92 KB of shared memory
    ((32, 64, 64), torch.float32, "cdf97", (16, 16, 64)),  # 166 KB
    ((10, 34, 32), torch.float32, "cdf97", (4, 8, 8)),
    ((6, 6, 6), torch.float32, "cdf53", (2, 2, 2)),
    ((16, 16, 16), torch.float32, "interp53", (16, 16, 16)),
    ((16, 24, 16), torch.float32, "haar", (4, 8, 8)),
    ((8, 24, 48), torch.int32, "cdf53", (4, 8, 16)),
    ((32, 64, 64), torch.int32, "cdf97", t3.TILE3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,wavelet,tile", VOLUME)
def test_b14_b15_kernels_match_plain(cuda_device, shape, dtype, wavelet, tile):
    x = _vol(shape, dtype, cuda_device, seed=6)
    exact = dtype == torch.int32
    tf.reset_counters()
    b = t3.fused_dwt3_level(x, wavelet, tile=tile)
    want = t3.dwt3_level_plain(x, wavelet, tile)
    _close([b[k] for k in t3.BANDS], [want[k] for k in t3.BANDS], exact)
    rec = t3.fused_idwt3_level(b, wavelet, tile=tile)
    _close(rec, t3.idwt3_level_plain(b, wavelet, tile), exact)
    torch.cuda.synchronize()
    assert (tf.KERNELS["B14"].launches, tf.KERNELS["B15"].launches) == (1, 1)
    if exact:
        oracle = sep.dwt3_level(x, wavelet)
        _close([b[k] for k in t3.BANDS], [oracle[k] for k in t3.BANDS], True)
        assert torch.equal(rec, x)


@pytest.mark.cuda
def test_fused_volume_on_card_matches_oracle(cuda_device):
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
def test_single_levels_reach_the_kernels_through_the_api(cuda_device):
    x = _img(1025, 1031, torch.float32, cuda_device, seed=8)
    tf.reset_counters()
    got = api.wavedec2(x, "cdf97", 3, impl="fused")
    b = api.dwt2(x, "cdf97")  # 'auto' on the card: 1024 <= min < 2048
    rec = api.idwt2(*b, "cdf97")
    torch.cuda.synchronize()
    assert {k: s.launches for k, s in tf.KERNELS.items() if s.launches} == {
        "B1": 2, "B3": 2, "B4": 1}
    for a, c in zip(_leaves(got), _leaves(sep.wavedec2(x, "cdf97", 3))):
        assert float((a - c).abs().max()) <= 5e-4
    assert float((rec - x).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_auto_keeps_float64_on_the_oracle(cuda_device):
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


STREAMED = [
    # (h, w, dtype, wavelet, ty, tx): ragged last strips (260, 204, 200 rows)
    # and bands (132, 100 columns), short quarter tails (remq 1..3)
    (260, 128, torch.float32, "cdf97", 64, 64),
    (204, 132, torch.float32, "cdf97", 32, 48),
    (512, 384, torch.float32, "cdf53", 128, 128),  # 215 KB of shared memory
    (256, 256, torch.float32, "haar", 64, 64),
    (200, 100, torch.float32, "interp53", 16, 20),
    (200, 128, torch.int32, "cdf53", 64, 64),
    (288, 128, torch.int32, "cdf97", 16, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,dtype,wavelet,ty,tx", STREAMED)
def test_b8_b10_kernels_match_plain(cuda_device, h, w, dtype, wavelet, ty, tx):
    x = _img(h, w, dtype, cuda_device, seed=11)
    exact = dtype == torch.int32
    tf.reset_counters()
    c2 = ts.streamed_dwt2_2level(x, wavelet, ty=ty, tx=tx)
    _close(list(c2), list(ts.streamed_dwt2_2level_plain(x, wavelet, ty, tx)), exact)
    rec = ts.streamed_idwt2_2level(*c2, wavelet, ty=ty, tx=tx)
    _close(rec, ts.streamed_idwt2_2level_plain(*c2, wavelet, ty, tx), exact)
    torch.cuda.synchronize()
    assert (tf.KERNELS["B8"].launches, tf.KERNELS["B10"].launches) == (1, 1)
    if exact:
        assert torch.equal(rec, x)
        _close(list(c2), sep.wavedec2(x, wavelet, 2), True)


STREAMED_DEEP = [
    (256, 320, 4, torch.float32, "cdf97", 64, 64),
    (512, 384, 5, torch.float32, "cdf97", 32, 32),
    (1036, 128, 3, torch.float32, "cdf97", 64, 64),  # short quarter tail
    (260, 256, 3, torch.float32, "cdf53", 64, 48),
    (256, 320, 4, torch.int32, "cdf53", 64, 64),
    (512, 384, 5, torch.int32, "cdf97", 32, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,level,dtype,wavelet,ty,tx", STREAMED_DEEP)
def test_b11_b12_kernels_match_plain(cuda_device, h, w, level, dtype, wavelet, ty, tx):
    x = _img(h, w, dtype, cuda_device, seed=12)
    exact = dtype == torch.int32
    tf.reset_counters()
    d = ts.streamed_wavedec2_deep(x, wavelet, level, ty=ty, tx=tx)
    _close(d, ts.streamed_wavedec2_deep_plain(x, wavelet, level, ty, tx), exact)
    rec = ts.streamed_waverec2_deep(d, wavelet, ty=ty, tx=tx)
    _close(rec, ts.streamed_waverec2_deep_plain(d, wavelet, ty, tx), exact)
    torch.cuda.synchronize()
    assert (tf.KERNELS["B11"].launches, tf.KERNELS["B12"].launches) == (1, 1)
    for kid in ("B11", "B12"):  # the cooperative grid fits the card at once
        grid, resident = ts.LAST_GRID[kid]
        assert 1 <= grid <= resident
    if exact:
        _close(d, sep.wavedec2(x, wavelet, level), True)
        assert torch.equal(rec, x)


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
    (512, 384, torch.float32, "cdf53", 128, 128),  # 148 KB of shared memory
    (256, 256, torch.float32, "haar", 32, 64),
    (200, 100, torch.float32, "interp53", 16, 20),
    (200, 128, torch.int32, "cdf53", 64, 64),
    (288, 132, torch.int32, "cdf97", 16, 16),
    (256, 256, torch.int32, "haar", 32, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,dtype,wavelet,ty,tx", SINGLE)
def test_b7_b9_kernels_match_plain(cuda_device, h, w, dtype, wavelet, ty, tx):
    x = _img(h, w, dtype, cuda_device, seed=14)
    exact = dtype == torch.int32
    tf.reset_counters()
    b = ts.streamed_dwt2_level(x, wavelet, ty=ty, tx=tx)
    _close(list(b), list(ts.streamed_dwt2_level_plain(x, wavelet, ty, tx)), exact)
    rec = ts.streamed_idwt2_level(*b, wavelet, ty=ty, tx=tx)
    _close(rec, ts.streamed_idwt2_level_plain(*b, wavelet, ty, tx), exact)
    torch.cuda.synchronize()
    assert (tf.KERNELS["B7"].launches, tf.KERNELS["B9"].launches) == (1, 1)
    if exact:
        _close(list(b), list(sep.dwt2_level(x, wavelet)), True)
        assert torch.equal(rec, x)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,dtype,wavelet,ty,tx", [
    (512, 512, torch.float32, "cdf97", 64, 64), (260, 132, torch.float32, "cdf53", 32, 48),
    (260, 132, torch.int32, "cdf53", 64, 64), (204, 128, torch.int32, "cdf97", 16, 20)])
def test_streamed_extended_rows_kernels_match_plain(cuda_device, h, w, dtype, wavelet,
                                                    ty, tx):
    """The 8-row (TOP) contract of the single streamed levels, both ways."""
    exact = dtype == torch.int32
    xe = _img(h + 2 * ts.TOP, w, dtype, cuda_device, seed=15)
    b = ts.streamed_dwt2_level(xe, wavelet, boundary_rows="extended", ty=ty, tx=tx)
    _close(list(b), list(ts.streamed_dwt2_level_plain(xe, wavelet, ty, tx, ts.TOP)), exact)
    assert tuple(b[0].shape) == (h // 2, w // 2)
    bands = [_img(h // 2 + 2 * ts.TOP, w // 2, dtype, cuda_device, seed=16 + i)
             for i in range(4)]
    rec = ts.streamed_idwt2_level(*bands, wavelet, boundary_rows="extended", ty=ty, tx=tx)
    assert tuple(rec.shape) == (h, w)
    _close(rec, ts.streamed_idwt2_level_plain(*bands, wavelet, ty, tx, ts.TOP), exact)


SVOLUME = [
    ((64, 128, 128), torch.float32, "cdf97", ts3.STILE3),  # 184 KB of shared memory
    ((32, 64, 64), torch.float32, "cdf97", (16, 16, 16)),  # 108 KB
    ((30, 70, 66), torch.float32, "cdf97", (8, 16, 16)),   # ragged z, y, x tails
    ((10, 34, 32), torch.float32, "cdf53", (4, 8, 8)),
    ((16, 16, 16), torch.float32, "interp53", (16, 16, 16)),
    ((16, 24, 16), torch.float32, "haar", (4, 8, 8)),
    ((30, 70, 66), torch.int32, "cdf53", (8, 16, 16)),
    ((32, 64, 64), torch.int32, "cdf97", ts3.STILE3),
    ((16, 24, 16), torch.int32, "haar", (2, 4, 4)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,wavelet,tile", SVOLUME)
def test_b16_b17_kernels_match_plain(cuda_device, shape, dtype, wavelet, tile):
    x = _vol(shape, dtype, cuda_device, seed=17)
    exact = dtype == torch.int32
    tf.reset_counters()
    b = ts3.streamed_dwt3_level(x, wavelet, tile=tile)
    want = ts3.dwt3_level_streamed_plain(x, wavelet, tile)
    _close([b[k] for k in t3.BANDS], [want[k] for k in t3.BANDS], exact)
    rec = ts3.streamed_idwt3_level(b, wavelet, tile=tile)
    _close(rec, ts3.idwt3_level_streamed_plain(b, wavelet, tile), exact)
    torch.cuda.synchronize()
    assert (tf.KERNELS["B16"].launches, tf.KERNELS["B17"].launches) == (1, 1)
    if exact:
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
    # (h, w, wavelet, ty, tx): ragged last strips (260, 204, 200 rows) and
    # bands (132, 100 columns), short quarter tails; every window is padded
    # to 16 (88, 40, 72, 44, ... samples); 64x96 strips take 224 KB
    (260, 128, "cdf97", 64, 64),
    (204, 132, "cdf97", 32, 48),
    (512, 384, "cdf53", 64, 96),
    (256, 256, "haar", 64, 64),
    (200, 100, "interp53", 16, 20),
    (288, 128, "cdf97", 16, 16),
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
