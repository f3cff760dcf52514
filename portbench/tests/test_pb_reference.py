"""The benchmark's plain reference against the port's separable oracle at
small sizes (the two are independent code; the oracle runs here in the
same dtypes on the CPU)."""
import pytest
import torch

from libdwt_torch.ops import separable
from portbench import check
from portbench.reference import lifting as ref

SHAPES = [(2, 37, 41), (3, 64, 96), (1, 72, 136), (2, 33, 18)]


def _flat(pyr):
    return check.leaves(pyr)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("wavelet,dtype", [("cdf97", torch.float64), ("cdf97", torch.float32),
                                           ("cdf53", torch.int32), ("cdf53", torch.float64),
                                           ("cdf97", torch.int32)])
def test_reference_equals_the_oracle(shape, wavelet, dtype):
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randint(-2048, 2048, shape, generator=g, dtype=torch.int32).to(dtype)
    levels = 3
    mine, theirs = ref.wavedec2(x, wavelet, levels), separable.wavedec2(x, wavelet, levels)
    for a, b in zip(_flat(mine), _flat(theirs), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    back, theirs_back = ref.waverec2(mine, wavelet), separable.waverec2(theirs, wavelet)
    assert torch.equal(back, theirs_back)
    if not dtype.is_floating_point:
        assert torch.equal(back, x)
    else:
        assert float((back.double() - x.double()).abs().max()) < (1e-9 if dtype == torch.float64 else 2e-3)


def test_trunc_rounding_differs_from_floor_on_negative_samples():
    x = torch.tensor([[-3, -1, -4, -1, -5, -9, -2, -6]], dtype=torch.int32)
    lo_f, hi_f = ref.lift_fwd(x, "cdf53")
    lo_t, hi_t = ref.lift_fwd(x, "cdf53", int_round="trunc")
    assert not (torch.equal(lo_f, lo_t) and torch.equal(hi_f, hi_t))
    # floor: d = x_odd - ((x_even_l + x_even_r) >> 1); -1 - (-7 >> 1) = -1 + 4 = 3
    assert int(hi_f[0, 0]) == 3 and int(hi_t[0, 0]) == 2
