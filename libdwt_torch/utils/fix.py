"""Fixed-point Q-format types and lifting arithmetic (port of
``libdwt_tpu.utils.fix``).

  * FIX32 = int32 with 16 fractional bits (one = 1<<16, half = 1<<15);
  * FIX16 = int16 with 9 fractional bits (one = 1<<9);
  * rounding multiplication fix_mul(x, y) = (x*y + half) >> n with a
    wide intermediate (int64 for FIX32, int32 for FIX16).

The same lifting steps as the float engine, with every coefficient
quantized to the Q format and one rounded multiply per symmetric step
and per scaling.  Every result equals the JAX package's bit for bit:
sums wrap in the Q format's own width, the arithmetic shift rounds
toward minus infinity, and the narrowing casts wrap.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from libdwt_torch.models.wavelets import get_wavelet
from libdwt_torch.ops.lifting import _d_neighbors, _inv_scales, _s_neighbors
from libdwt_torch.utils.device import as_tensor, as_tensors

__all__ = [
    "QFormat",
    "FIX32",
    "FIX16",
    "to_fix",
    "from_fix",
    "fix_mul",
    "lift_fwd_fix",
    "lift_inv_fix",
    "dwt2_fix",
    "idwt2_fix",
]


@dataclasses.dataclass(frozen=True)
class QFormat:
    name: str
    dtype: torch.dtype
    n: int  # fractional bits (shift)
    wide: torch.dtype  # wide dtype for products

    @property
    def one(self) -> int:
        return 1 << self.n

    @property
    def half(self) -> int:
        return 1 << (self.n - 1)


FIX32 = QFormat("fix32", torch.int32, 16, torch.int64)
FIX16 = QFormat("fix16", torch.int16, 9, torch.int32)


def to_fix(x, q: QFormat = FIX32, device=None) -> torch.Tensor:
    """Float to Q format, C ``roundf``: round half AWAY FROM ZERO in float32
    (``torch.round`` would round ties to even)."""
    v = as_tensor(x, device).to(torch.float32) * q.one
    return torch.where(v >= 0, torch.floor(v + 0.5), torch.ceil(v - 0.5)).to(q.dtype)


def from_fix(x, q: QFormat = FIX32, device=None) -> torch.Tensor:
    return as_tensor(x, device).to(torch.float32) / q.one


def fix_mul(x, y, q: QFormat = FIX32, device=None) -> torch.Tensor:
    """(x*y + half) >> n with a wide intermediate, cast back to the Q
    format with wrap-around.  Non-tensor operands go to the device of the
    tensor one (else to ``device``)."""
    x, y = (a.to(q.dtype) for a in as_tensors(x, y, device=device))
    wide = x.to(q.wide) * y.to(q.wide) + q.half
    return (wide >> q.n).to(q.dtype)


def _coeff(c: float, q: QFormat, like: torch.Tensor) -> torch.Tensor:
    return to_fix(c, q, device=like.device)


def _update(l, r, st, q: QFormat):
    if st.is_symmetric:
        # one rounded multiply on the SUM (the reference cores' fix32_mul(w, l+r))
        return fix_mul(l + r, _coeff(st.coeff, q, l), q)
    return fix_mul(l, _coeff(st.left, q, l), q) + fix_mul(r, _coeff(st.right, q, r), q)


def lift_fwd_fix(x, wavelet="cdf97", q: QFormat = FIX32, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward lifting on Q-format data along the last axis -> (s, d)."""
    x = as_tensor(x, device)
    wavelet = get_wavelet(wavelet)
    s, d = x[..., 0::2], x[..., 1::2]
    nl, nh = s.shape[-1], d.shape[-1]
    if x.shape[-1] < 2:
        # small-N rule: scale the single sample, empty high
        if wavelet.scale_s is not None and x.shape[-1] == 1:
            s = fix_mul(s, _coeff(wavelet.scale_s, q, s), q)
        return s, d
    for st in wavelet.steps:
        l, r = _d_neighbors(s, nh) if st.target == "d" else _s_neighbors(d, nl)
        if st.target == "d":
            d = d + _update(l, r, st, q)
        else:
            s = s + _update(l, r, st, q)
    if wavelet.scale_s is not None:
        s = fix_mul(s, _coeff(wavelet.scale_s, q, s), q)
        d = fix_mul(d, _coeff(wavelet.scale_d, q, d), q)
    return s, d


def lift_inv_fix(s, d, wavelet="cdf97", q: QFormat = FIX32, device=None) -> torch.Tensor:
    """Approximate inverse of :func:`lift_fwd_fix` (quantization makes the
    round trip close, not bit-exact)."""
    s, d = as_tensor(s, device), as_tensor(d, device)
    wavelet = get_wavelet(wavelet)
    nl, nh = s.shape[-1], d.shape[-1]
    if nl + nh < 2:
        if wavelet.scale_s is not None and nl == 1:
            inv_s, _ = _inv_scales(wavelet)
            s = fix_mul(s, _coeff(inv_s, q, s), q)
        return s
    if wavelet.scale_s is not None:
        inv_s, inv_d = _inv_scales(wavelet)
        s = fix_mul(s, _coeff(inv_s, q, s), q)
        d = fix_mul(d, _coeff(inv_d, q, d), q)
    for st in wavelet.steps[::-1]:
        l, r = _d_neighbors(s, nh) if st.target == "d" else _s_neighbors(d, nl)
        if st.target == "d":
            d = d - _update(l, r, st, q)
        else:
            s = s - _update(l, r, st, q)
    out = s.new_zeros(s.shape[:-1] + (nl + nh,))
    out[..., 0::2] = s
    out[..., 1::2] = d
    return out


def _col_apply(fn, *arrays):
    """Apply a last-axis function along axis -2 (transpose sandwich)."""
    out = fn(*(a.transpose(-1, -2) for a in arrays))
    if isinstance(out, tuple):
        return tuple(o.transpose(-1, -2) for o in out)
    return out.transpose(-1, -2)


def dwt2_fix(x, wavelet="cdf97", q: QFormat = FIX32, device=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-level 2-D fixed-point analysis -> (LL, HL, LH, HH): a row
    pass then a column pass of :func:`lift_fwd_fix`.  ``x`` is Q-format
    data (:func:`to_fix`); the band layout is that of
    :func:`libdwt_torch.ops.separable.dwt2_level`."""
    l, h = lift_fwd_fix(x, wavelet, q, device)
    ll, lh = _col_apply(lambda a: lift_fwd_fix(a, wavelet, q), l)
    hl, hh = _col_apply(lambda a: lift_fwd_fix(a, wavelet, q), h)
    return ll, hl, lh, hh


def idwt2_fix(ll, hl, lh, hh, wavelet="cdf97", q: QFormat = FIX32, device=None
              ) -> torch.Tensor:
    """Single-level 2-D fixed-point synthesis (inverse of :func:`dwt2_fix`,
    approximate as the quantization makes it)."""
    ll, hl, lh, hh = (as_tensor(b, device) for b in (ll, hl, lh, hh))
    l = _col_apply(lambda a, b: lift_inv_fix(a, b, wavelet, q), ll, lh)
    h = _col_apply(lambda a, b: lift_inv_fix(a, b, wavelet, q), hl, hh)
    return lift_inv_fix(l, h, wavelet, q)
