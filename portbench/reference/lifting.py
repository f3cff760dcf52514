"""Plain lifting DWT in PyTorch: the benchmark's reference.

A frozen, independent statement of the transform that the program
computes: the separable lifting scheme, a row pass (along x) then a
column pass (along y) on each level, on the low-pass quadrant of the
level before.  Border: whole-point symmetric extension, written as
clamping the opposite channel's neighbours:

    d[i] uses s[i], s[i+1]         with s[nl] := s[nl-1]  (even N, right edge)
    s[i] uses d[i-1], d[i]         with d[-1] := d[0], d[nh] := d[nh-1]

The low channel gets ceil(N/2) samples, the high channel floor(N/2).

Float wavelets run ``target += coeff * (left + right)`` in the input's
dtype, then scale the channels (float64 here is the truth; a lower
dtype gives the benchmark's control).  Integer wavelets run the
reversible steps ``target += sign * ((wl*left + wr*right + k) >> shift)``
with an arithmetic (floor) shift, as ISO/IEC 15444-1 Annex F states for
the 5/3; ``int_round='trunc'`` divides toward zero instead, the
rounding that breaks the standard's guarantee (the control of an
integer cell).

Constants: CDF 9/7 (Mallat, 3rd ed., p. 370), CDF 5/3 and its reversible
integer form (JPEG 2000 Part 1).  Imports torch only.
"""
from __future__ import annotations

import math

import torch

__all__ = ["WAVELETS", "lift_fwd", "lift_inv", "wavedec2", "waverec2"]

_P1, _U1, _P2, _U2 = 1.58613434342059, -0.0529801185729, -0.8829110755309, 0.4435068520439
_K97 = 1.1496043988602
_K53 = math.sqrt(2.0)

#: name -> float steps (target, coeff), (scale_s, scale_d), integer steps
#: (target, sign, wl, wr, k, shift)
WAVELETS = {
    "cdf97": {
        "steps": (("d", -_P1), ("s", _U1), ("d", -_P2), ("s", _U2)),
        "scale": (_K97, 1.0 / _K97),
        "int_steps": (("d", -1, 203, 203, -(1 << 6), 7),
                      ("s", +1, -217, -217, 1 << 11, 12),
                      ("d", -1, -113, -113, -(1 << 6), 7),
                      ("s", +1, 1817, 1817, 1 << 11, 12)),
    },
    "cdf53": {
        "steps": (("d", -0.5), ("s", 0.25)),
        "scale": (_K53, 1.0 / _K53),
        "int_steps": (("d", -1, 1, 1, 0, 1), ("s", +1, 1, 1, 2, 2)),
    },
}


def _d_neighbours(s, nh: int):
    nl = s.shape[-1]
    left = s[..., :nh]
    if nl > nh:
        right = s[..., 1:nh + 1]
    else:
        right = torch.cat([s[..., 1:], s[..., -1:]], dim=-1)
    return left, right


def _s_neighbours(d, nl: int):
    nh = d.shape[-1]
    left = torch.cat([d[..., :1], d[..., :nl - 1]], dim=-1)
    right = d if nl == nh else torch.cat([d, d[..., -1:]], dim=-1)
    return left, right


def _neighbours(target: str, s, d):
    return (_d_neighbours(s, d.shape[-1]) if target == "d"
            else _s_neighbours(d, s.shape[-1]))


def _int_update(l, r, wl: int, wr: int, k: int, shift: int, int_round: str):
    v = wl * l + wr * r + k
    if int_round == "floor":
        return v >> shift
    if int_round == "trunc":
        return torch.div(v, 1 << shift, rounding_mode="trunc")
    raise ValueError("int_round must be 'floor' or 'trunc'")


def _steps(s, d, wavelet: str, inverse: bool, int_round: str):
    spec = WAVELETS[wavelet]
    if s.dtype.is_floating_point:
        sign = -1.0 if inverse else 1.0
        for target, coeff in (spec["steps"][::-1] if inverse else spec["steps"]):
            l, r = _neighbours(target, s, d)
            upd = (sign * coeff) * (l + r)
            if target == "d":
                d = d + upd
            else:
                s = s + upd
        return s, d
    for target, sign, wl, wr, k, shift in (spec["int_steps"][::-1] if inverse
                                           else spec["int_steps"]):
        l, r = _neighbours(target, s, d)
        v = _int_update(l, r, wl, wr, k, shift, int_round)
        if inverse:
            sign = -sign
        if target == "d":
            d = d + sign * v
        else:
            s = s + sign * v
    return s, d


def lift_fwd(x, wavelet: str, axis: int = -1, int_round: str = "floor"):
    """One forward 1-D level along ``axis`` -> (low, high)."""
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    if n < 2:
        low = x * WAVELETS[wavelet]["scale"][0] if x.dtype.is_floating_point else x
        s, d = low, x[..., :0]
    else:
        s, d = _steps(x[..., 0::2], x[..., 1::2], wavelet, False, int_round)
        if x.dtype.is_floating_point:
            ks, kd = WAVELETS[wavelet]["scale"]
            s, d = s * ks, d * kd
    return torch.movedim(s, -1, axis), torch.movedim(d, -1, axis)


def lift_inv(low, high, wavelet: str, axis: int = -1, int_round: str = "floor"):
    """One inverse 1-D level along ``axis``: (low, high) -> the signal."""
    s = torch.movedim(low, axis, -1)
    d = torch.movedim(high, axis, -1)
    floating = s.dtype.is_floating_point
    ks, kd = WAVELETS[wavelet]["scale"]
    if d.shape[-1] == 0:
        x = s / ks if floating else s
        return torch.movedim(x, -1, axis)
    if floating:
        s, d = s * (1.0 / ks), d * (1.0 / kd)
    s, d = _steps(s, d, wavelet, True, int_round)
    nl, nh = s.shape[-1], d.shape[-1]
    if nl > nh:
        d = torch.cat([d, torch.zeros_like(s[..., :1])], dim=-1)
    x = torch.stack([s, d], dim=-1).reshape(*s.shape[:-1], 2 * nl)[..., :nl + nh]
    return torch.movedim(x, -1, axis)


def wavedec2(x, wavelet: str, levels: int, int_round: str = "floor"):
    """``levels`` 2-D levels over the last two axes ->
    [LL_J, (HL_J, LH_J, HH_J), ..., (HL_1, LH_1, HH_1)]."""
    coeffs = []
    ll = x
    for _ in range(levels):
        lo, hi = lift_fwd(ll, wavelet, -1, int_round)
        ll, lh = lift_fwd(lo, wavelet, -2, int_round)
        hl, hh = lift_fwd(hi, wavelet, -2, int_round)
        coeffs.append((hl, lh, hh))
    return [ll] + coeffs[::-1]


def waverec2(coeffs, wavelet: str, int_round: str = "floor"):
    """Inverse of :func:`wavedec2`."""
    ll = coeffs[0]
    for hl, lh, hh in coeffs[1:]:
        lo = lift_inv(ll, lh, wavelet, -2, int_round)
        hi = lift_inv(hl, hh, wavelet, -2, int_round)
        ll = lift_inv(lo, hi, wavelet, -1, int_round)
    return ll
