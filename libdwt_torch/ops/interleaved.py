"""Transforms with the INTERLEAVED subband layout (port of
``libdwt_tpu.ops.interleaved``).

Every coefficient stays at its spatial position: level-j coefficients
live at stride-2^j grid positions, instead of packed L|H halves (libdwt's
dwt-simple layer).  Also the conversions to and from the packed layout.
Each level writes into a clone, never into the caller's tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

from libdwt_torch.ops.lifting import lift_fwd, lift_inv, merge, split
from libdwt_torch.utils.device import as_tensor
from libdwt_torch.utils.subband import ceil_div_pow2, resolve_j

__all__ = [
    "fdwt1_interleaved",
    "idwt1_interleaved",
    "fdwt2_interleaved",
    "idwt2_interleaved",
    "interleaved_to_packed2",
    "packed_to_interleaved2",
]


def _level_fwd(v, wavelet, axis):
    lo, hi = lift_fwd(v, wavelet, axis=axis)
    return merge(lo, hi, axis=axis)


def _level_inv(v, wavelet, axis):
    lo, hi = split(v, axis=axis)
    return lift_inv(lo, hi, wavelet, axis=axis)


def fdwt1_interleaved(x, wavelet="cdf97", level: Optional[int] = None, axis=-1,
                      device=None):
    """Multi-level 1-D forward, interleaved layout: level-j highs at
    positions (2^j)(2k+1), final lows at stride 2^level."""
    y = torch.movedim(as_tensor(x, device), axis, -1).clone()
    n = y.shape[-1]
    for lvl in range(resolve_j(n, n, level)):
        step = 1 << lvl
        y[..., ::step] = _level_fwd(y[..., ::step], wavelet, -1)
    return torch.movedim(y, -1, axis)


def idwt1_interleaved(y, wavelet="cdf97", level: Optional[int] = None, axis=-1,
                      device=None):
    x = torch.movedim(as_tensor(y, device), axis, -1).clone()
    n = x.shape[-1]
    for lvl in range(resolve_j(n, n, level) - 1, -1, -1):
        step = 1 << lvl
        x[..., ::step] = _level_inv(x[..., ::step], wavelet, -1)
    return torch.movedim(x, -1, axis)


def fdwt2_interleaved(x, wavelet="cdf97", level: Optional[int] = None, device=None):
    """Multi-level 2-D forward in the interleaved layout of dwt-simple
    (rows then columns per level, in place)."""
    y = as_tensor(x, device).clone()
    h, w = y.shape[-2], y.shape[-1]
    for lvl in range(resolve_j(h, w, level)):
        step = 1 << lvl
        v = _level_fwd(y[..., ::step, ::step], wavelet, -1)
        y[..., ::step, ::step] = _level_fwd(v, wavelet, -2)
    return y


def idwt2_interleaved(y, wavelet="cdf97", level: Optional[int] = None, device=None):
    x = as_tensor(y, device).clone()
    h, w = x.shape[-2], x.shape[-1]
    for lvl in range(resolve_j(h, w, level) - 1, -1, -1):
        step = 1 << lvl
        v = _level_inv(x[..., ::step, ::step], wavelet, -2)
        x[..., ::step, ::step] = _level_inv(v, wavelet, -1)
    return x


def interleaved_to_packed2(y, level: int, device=None):
    """Convert an interleaved 2-D transform to the packed L|H layout."""
    out = as_tensor(y, device).clone()
    h, w = out.shape[-2], out.shape[-1]
    # after compacting level j, the deeper structure sits contiguously in
    # the top-left region, again "interleaved at stride 1" one level down
    for lvl in range(level):
        hj, wj = ceil_div_pow2(h, lvl), ceil_div_pow2(w, lvl)
        v = torch.cat(split(out[..., :hj, :wj], axis=-1), dim=-1)
        out[..., :hj, :wj] = torch.cat(split(v, axis=-2), dim=-2)
    return out


def packed_to_interleaved2(y, level: int, device=None):
    """Inverse of :func:`interleaved_to_packed2`."""
    out = as_tensor(y, device).clone()
    h, w = out.shape[-2], out.shape[-1]
    for lvl in range(level - 1, -1, -1):
        hj, wj = ceil_div_pow2(h, lvl), ceil_div_pow2(w, lvl)
        v = out[..., :hj, :wj]
        cy, cx = -(-hj // 2), -(-wj // 2)
        v = merge(v[..., :cy, :], v[..., cy:, :], axis=-2)
        out[..., :hj, :wj] = merge(v[..., :, :cx], v[..., :, cx:], axis=-1)
    return out
