"""Vectorized 1-D lifting engine (port of ``libdwt_tpu.ops.lifting``).

Each lifting step is one data-parallel elementwise pass over the whole
(batched) polyphase channel.  Border semantics: whole-point symmetric
extension, expressed as neighbour clamping of the opposite channel:

  d[i] uses s[i], s[i+1]            with s[nl] := s[nl-1]  (even N right edge)
  s[i] uses d[i-1], d[i]            with d[-1] := d[0], d[nh] := d[nh-1]

The low channel gets ceil(N/2) samples, the high channel floor(N/2).
Integer steps are the C-exact ``(wl*l + wr*r + k) >> shift`` with an
arithmetic shift (torch ``>>`` on int32 is arithmetic).
"""
from __future__ import annotations

from typing import Tuple

import torch

from libdwt_torch.models.wavelets import Wavelet, get_wavelet


def _is_int(dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex


# ------------------------------------------------------------------ polyphase


def split(x: torch.Tensor, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split into even (s/low-to-be) and odd (d/high-to-be) channels."""
    x = torch.movedim(x, axis, -1)
    s = x[..., 0::2]
    d = x[..., 1::2]
    return torch.movedim(s, -1, axis), torch.movedim(d, -1, axis)


def merge(s: torch.Tensor, d: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Interleave polyphase channels back into one signal."""
    s = torch.movedim(s, axis, -1)
    d = torch.movedim(d, axis, -1)
    nl, nh = s.shape[-1], d.shape[-1]
    n = nl + nh
    if nl == nh:
        out = torch.stack([s, d], dim=-1).reshape(*s.shape[:-1], n)
    else:  # odd length: one trailing even sample
        pad = torch.zeros_like(s[..., :1])
        out = torch.stack([s, torch.cat([d, pad], dim=-1)], dim=-1)
        out = out.reshape(*s.shape[:-1], 2 * nl)[..., :n]
    return torch.movedim(out, -1, axis)


# ----------------------------------------------------- mirrored neighbourhoods
#
# ``border`` selects what a missing (virtual) neighbour contributes:
#   'mirror' — whole-point symmetric duplication (the default)
#   'hole'   — the virtual neighbour contributes 0 at every step
# The third mode, 'zero' (virtual zero samples that themselves lift), is
# realized in lift_inv by zero-extending the channels and running 'hole'.


def _d_neighbors(s, nh: int, border: str = "mirror"):
    """(left, right) even-channel neighbours of each odd sample."""
    nl = s.shape[-1]
    left = s[..., :nh]
    if nl > nh:  # odd N: every odd sample has a true right neighbour
        right = s[..., 1: nh + 1]
    else:  # even N: the last odd sample's right neighbour is virtual
        edge = torch.zeros_like(s[..., -1:]) if border == "hole" else s[..., -1:]
        right = torch.cat([s[..., 1:], edge], dim=-1)
    return left, right


def _s_neighbors(d, nl: int, border: str = "mirror"):
    """(left, right) odd-channel neighbours of each even sample."""
    nh = d.shape[-1]
    first = torch.zeros_like(d[..., :1]) if border == "hole" else d[..., :1]
    left = torch.cat([first, d[..., : nl - 1]], dim=-1)
    if nl == nh:
        right = d
    else:  # odd N: the last even sample's right neighbour is virtual
        edge = torch.zeros_like(d[..., -1:]) if border == "hole" else d[..., -1:]
        right = torch.cat([d, edge], dim=-1)
    return left, right


def _float_steps(s, d, wavelet: Wavelet, inverse: bool, border: str = "mirror"):
    nl, nh = s.shape[-1], d.shape[-1]
    steps = wavelet.steps[::-1] if inverse else wavelet.steps
    sign = -1.0 if inverse else 1.0
    for step in steps:
        l, r = (_d_neighbors(s, nh, border) if step.target == "d"
                else _s_neighbors(d, nl, border))
        if step.is_symmetric:
            upd = (sign * step.coeff) * (l + r)
        else:
            upd = (sign * step.left) * l + (sign * step.right) * r
        if step.target == "d":
            d = d + upd
        else:
            s = s + upd
    return s, d


def _int_steps(s, d, wavelet: Wavelet, inverse: bool, border: str = "mirror"):
    if wavelet.int_steps is None:
        raise ValueError(f"wavelet {wavelet.name} has no reversible integer path")
    nl, nh = s.shape[-1], d.shape[-1]
    steps = wavelet.int_steps[::-1] if inverse else wavelet.int_steps
    for step in steps:
        sign = -step.sign if inverse else step.sign
        if step.target == "d":
            l, r = _d_neighbors(s, nh, border)
        else:
            l, r = _s_neighbors(d, nl, border)
        wl, wr = step.weights
        v = (wl * l + wr * r + step.k) >> step.shift
        if step.target == "d":
            d = d + sign * v
        else:
            s = s + sign * v
    return s, d


# ------------------------------------------------------------------ public API


def _inv_scales(wavelet: Wavelet):
    """(inv_scale_s, inv_scale_d) with the CDF-convention fallback
    (scale_d == 1/scale_s there); D4 defines explicit values."""
    inv_s = wavelet.inv_scale_s if wavelet.inv_scale_s is not None else wavelet.scale_d
    inv_d = wavelet.inv_scale_d if wavelet.inv_scale_d is not None else wavelet.scale_s
    return inv_s, inv_d


def _check_int_dtype(dtype) -> None:
    if not dtype.is_signed:
        raise ValueError(
            f"reversible integer lifting needs a signed dtype, got {dtype}; "
            "cast to int32 first (negative weights and arithmetic shifts "
            "are invalid for unsigned)"
        )


def lift_fwd(x: torch.Tensor, wavelet="cdf97", axis: int = -1):
    """Forward 1-D lifting DWT along ``axis`` (batched over the rest).

    Returns (low, high) with sizes (ceil(N/2), floor(N/2)).
    """
    wavelet = get_wavelet(wavelet)
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    is_int = _is_int(x.dtype)
    if is_int:
        _check_int_dtype(x.dtype)

    if n == 0:
        s, d = x, x
    elif n == 1:
        # float scales the single sample by s1; int leaves it as is
        if is_int:
            s = x
        else:
            scale = wavelet.scale_s if wavelet.scale_s is not None else 1.0
            s = x * scale
        d = x[..., :0]
    else:
        s, d = split(x, axis=-1)
        if is_int:
            s, d = _int_steps(s, d, wavelet, inverse=False)
        else:
            s, d = _float_steps(s, d, wavelet, inverse=False)
            if wavelet.scale_s is not None:
                s = s * wavelet.scale_s
                d = d * wavelet.scale_d
    return torch.movedim(s, -1, axis), torch.movedim(d, -1, axis)


def lift_inv(low, high, wavelet="cdf97", axis: int = -1, border: str = "mirror"):
    """Inverse of :func:`lift_fwd`.

    ``border`` selects the virtual-sample semantics at the signal ends:
      'mirror' — whole-point symmetric extension
      'hole'   — virtual neighbours contribute 0 at every lifting step
      'zero'   — the signal is zero-extended and the virtual samples
                 themselves lift; realized by extending each channel with
                 len(steps) zeros.
    """
    if border not in ("mirror", "hole", "zero"):
        raise ValueError("border must be 'mirror', 'hole' or 'zero'")
    wavelet = get_wavelet(wavelet)
    s = torch.movedim(low, axis, -1)
    d = torch.movedim(high, axis, -1)
    n = s.shape[-1] + d.shape[-1]
    is_int = _is_int(s.dtype)
    if is_int:
        _check_int_dtype(s.dtype)
        if wavelet.int_steps is None:
            raise ValueError(f"wavelet {wavelet.name} has no reversible integer path")

    if n == 0:
        return torch.movedim(s, -1, axis)
    if n == 1 and border != "zero":
        # every neighbour of the single sample is virtual and contributes
        # nothing, so the inverse is the plain unscaling
        if is_int:
            x = s
        else:
            inv_s, _ = _inv_scales(wavelet)
            x = s * (inv_s if inv_s is not None else 1.0)
        return torch.movedim(x, -1, axis)

    ext = 0
    if border == "zero":
        # edge effects move inward one channel position per step, so
        # len(steps) virtual zeros per side cannot reach real samples
        ext = len(wavelet.int_steps if is_int else wavelet.steps)
        s = torch.nn.functional.pad(s, (ext, ext))
        d = torch.nn.functional.pad(d, (ext, ext))
        border = "hole"

    if is_int:
        s, d = _int_steps(s, d, wavelet, inverse=True, border=border)
    else:
        if wavelet.scale_s is not None:
            inv_s, inv_d = _inv_scales(wavelet)
            s = s * inv_s
            d = d * inv_d
        s, d = _float_steps(s, d, wavelet, inverse=True, border=border)

    x = merge(s, d, axis=-1)
    if ext:
        x = x[..., 2 * ext: 2 * ext + n]
    return torch.movedim(x, -1, axis)
