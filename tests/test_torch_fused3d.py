"""Port vs reference: the fused 3-D levels B14 (fused_dwt3_level) and B15
(fused_idwt3_level).

On the CPU each wrapper runs its kernel's plain PyTorch version (the 3-D
tile decomposition of csrc/fused3d.cu); it is held to the JAX Pallas
kernel run in interpret mode on the same seeded inputs, at the shapes
tests/test_fused3d.py uses: float32 to 3e-5, int32 bit-exactly.  Small
tiles make several tiles, and short last tiles, on every axis.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdwt_tpu.ops.fused3d as j3
from libdwt_torch.ops import UnsupportedGeometry
from libdwt_torch.ops import fused3d as t3
from libdwt_torch.ops import separable as tsep

SHAPES = [(16, 16, 16), (32, 24, 40), (8, 32, 64), (24, 16, 128)]
TILE = (4, 8, 16)


def _rand(shape, dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    if dtype == np.int32:
        return (rng.rand(*shape) * 255).astype(np.int32)
    return rng.randn(*shape).astype(np.float32)


def _close(got, want, exact=False):
    if isinstance(want, dict):
        assert set(got) == set(want)
        pairs = [(got[k], want[k]) for k in sorted(want)]
    else:
        pairs = [(got, want)]
    for a, b in pairs:
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=3e-5, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53"])
def test_b14_b15_plain_match_pallas(shape, wavelet):
    x = _rand(shape, seed=sum(shape))
    want = j3.fused_dwt3_level(jnp.asarray(x), wavelet, strip_z=8, interpret=True)
    got = t3.fused_dwt3_level(torch.from_numpy(x), wavelet, tile=TILE)
    _close(got, want)
    want_rec = j3.fused_idwt3_level(want, wavelet, strip_z=8, interpret=True)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in want.items()}
    _close(t3.fused_idwt3_level(tb, wavelet, tile=TILE), want_rec)


@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 24, 48)])
@pytest.mark.parametrize("wavelet", ["cdf97", "cdf53"])
def test_b14_b15_plain_int_bitexact(shape, wavelet):
    x = _rand(shape, np.int32)
    want = j3.fused_dwt3_level(jnp.asarray(x), wavelet, strip_z=8, interpret=True)
    got = t3.fused_dwt3_level(torch.from_numpy(x), wavelet, tile=TILE)
    _close(got, want, exact=True)
    rec = t3.fused_idwt3_level(got, wavelet, tile=TILE)
    _close(rec, j3.fused_idwt3_level(want, wavelet, strip_z=8, interpret=True), exact=True)
    np.testing.assert_array_equal(rec.numpy(), x)


@pytest.mark.parametrize("tile", [(16, 16, 32), (2, 2, 2), (6, 10, 14)])
def test_plain_is_tile_invariant(tile):
    """Every output depends only on its own neighbourhood, so any tile
    gives the same bits (the kernel and its plain version rely on it)."""
    x = torch.from_numpy(_rand((10, 34, 32), seed=7))
    base = t3.dwt3_level_plain(x, "cdf97", (4, 8, 8))
    got = t3.dwt3_level_plain(x, "cdf97", tile)
    for k in base:
        assert torch.equal(got[k], base[k])
    assert torch.equal(t3.idwt3_level_plain(got, "cdf97", tile),
                       t3.idwt3_level_plain(base, "cdf97", (4, 8, 8)))


def test_poly_approach_gives_the_same_result():
    x = torch.from_numpy(_rand((16, 48, 128), seed=21))
    a = t3.fused_dwt3_level(x, "cdf97")
    b = t3.fused_dwt3_level(x, "cdf97", approach="poly")
    for k in a:
        assert torch.equal(a[k], b[k])
    want = tsep.dwt3_level(x, "cdf97")
    assert max(float((b[k] - want[k]).abs().max()) for k in b) < 3e-6
    rec = t3.fused_idwt3_level(b, "cdf97", approach="poly")
    assert torch.equal(rec, t3.fused_idwt3_level(a, "cdf97"))
    assert float((rec - x).abs().max()) < 3e-6


@pytest.mark.parametrize("shape", [(15, 16, 16), (16, 17, 16), (16, 16, 9), (4, 16, 16),
                                   (16, 2, 16)])
def test_unsupported_geometry_forward(shape):
    x = torch.zeros(shape)
    with pytest.raises(UnsupportedGeometry):
        t3.fused_dwt3_level(x, "cdf97")
    with pytest.raises(j3.UnsupportedGeometry):
        j3.fused_dwt3_level(jnp.zeros(shape, jnp.float32), "cdf97", interpret=True)


def test_unsupported_geometry_inverse():
    small = {k: torch.zeros(2, 8, 8) for k in t3.BANDS}
    with pytest.raises(UnsupportedGeometry, match="too small"):
        t3.fused_idwt3_level(small, "cdf97")
    uneven = {k: torch.zeros(4, 8, 8) for k in t3.BANDS}
    uneven["HHH"] = torch.zeros(4, 8, 7)
    with pytest.raises(ValueError, match="equal band shapes"):
        t3.fused_idwt3_level(uneven, "cdf97")


@pytest.mark.parametrize("call,match", [
    (lambda: t3.fused_dwt3_level(torch.zeros(16, 48, 128), "cdf97", approach="interleave"),
     "approach"),
    (lambda: t3.fused_idwt3_level({k: torch.zeros(8, 8, 8) for k in t3.BANDS}, "cdf97",
                                  approach="planar"), "approach"),
    (lambda: t3.fused_dwt3_level(torch.zeros(16, 16, 16), "cdf97", strip_y=24), "strip_y"),
    (lambda: t3.fused_dwt3_level(torch.zeros(16, 16, 16), "cdf97", tile=(4, 8, 5)), "even"),
    (lambda: t3.fused_dwt3_level(torch.zeros(16, 16, 16, dtype=torch.float64), "cdf97",
                                 tile=(64, 64, 64)), "shared memory"),
    (lambda: t3.fused_dwt3_level(torch.zeros(16, 16, 16), "cdf97", tile=(64, 64, 64)),
     "threads"),
    (lambda: t3.fused_idwt3_level({k: torch.zeros(8, 8, 8) for k in t3.BANDS}, "cdf97",
                                  tile=(8, 8, 256)), "threads"),
    (lambda: t3.fused_dwt3_level(torch.zeros(2, 16, 16, 16), "cdf97"), "3-D"),
    (lambda: t3.fused_dwt3_level(torch.zeros(16, 16, 16), "d4"), "asymmetric"),
])
def test_wrappers_reject_bad_input(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_reference_rejects_unknown_approach_too():
    with pytest.raises(ValueError, match="approach"):
        j3.fused_dwt3_level(jnp.zeros((16, 48, 128), jnp.float32), "cdf97",
                            approach="interleave", interpret=True)
