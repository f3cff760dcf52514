"""Vector/image manipulation utilities (port of ``libdwt_tpu.utils.vecops``).

libdwt's signal/image math helpers: abs, dot, lp-normalize, add, mul,
min/max, constant shift, min-max rescale, per-row median shift, signal
displacement with clamp/zero fill, p-norm centre of mass and iterative
centering, viewport/crop.  All are torch expressions batched over
leading axes, on the input's device; the per-row "21" variants map
libdwt's per-y loops onto one call.
"""
from __future__ import annotations

from typing import Tuple

import torch

from libdwt_torch.ops.features import band_lpnorm, band_med
from libdwt_torch.utils.device import as_tensor, as_tensors

__all__ = [
    "vec_abs",
    "dot",
    "normalize",
    "add",
    "mul",
    "find_min_max",
    "shift",
    "scale",
    "shift21_med",
    "scale21",
    "displace1",
    "displace1_zero",
    "get_center1",
    "center1",
    "center21",
    "viewport",
    "crop21",
]


def vec_abs(x, device=None):
    """dwt_util_abs_s."""
    return torch.abs(as_tensor(x, device))


def dot(a, b, device=None):
    """dwt_util_dot_s."""
    a, b = as_tensors(a, b, device=device)
    return torch.sum(a * b)


def normalize(x, p: float = 2.0, device=None):
    """Divide by the lp norm (dwt_util_normalize_s; the norm is libdwt's
    sum(|c|^p)^(1/p) over the LAST TWO axes, batched over any leading
    axes)."""
    x = as_tensor(x, device)
    if x.ndim == 1:
        return x / band_lpnorm(x.reshape(1, -1), p)
    return x / band_lpnorm(x, p)[..., None, None]


def add(a, b, device=None):
    """dwt_util_add_s."""
    a, b = as_tensors(a, b, device=device)
    return a + b


def mul(a, b, device=None):
    """dwt_util_mul_s (elementwise)."""
    a, b = as_tensors(a, b, device=device)
    return a * b


def find_min_max(x, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """dwt_util_find_min_max_s."""
    x = as_tensor(x, device)
    return torch.min(x), torch.max(x)


def shift(x, a, device=None):
    """Add a constant (dwt_util_shift_s)."""
    return as_tensor(x, device) + a


def _rescale(x, mn, mx, lo, hi):
    rng = torch.where(mx > mn, mx - mn, torch.ones_like(mx))
    return (x - mn) / rng * (hi - lo) + lo


def scale(x, lo: float = 0.0, hi: float = 1.0, device=None):
    """Min-max rescale into [lo, hi] (dwt_util_scale_s)."""
    x = as_tensor(x, device)
    return _rescale(x, torch.min(x), torch.max(x), lo, hi)


def shift21_med(x, device=None):
    """Per-row subtract the row median (dwt_util_shift21_med_s with
    libdwt's sorted[size//2] median)."""
    x = as_tensor(x, device)
    return x - band_med(x[..., None, :])[..., None]  # rows as (..., 1, n) bands


def scale21(x, lo: float = 0.0, hi: float = 1.0, device=None):
    """Per-row min-max rescale (dwt_util_scale21_s)."""
    x = as_tensor(x, device)
    return _rescale(x, torch.amin(x, dim=-1, keepdim=True),
                    torch.amax(x, dim=-1, keepdim=True), lo, hi)


def displace1(x, displ: int, axis: int = -1, device=None):
    """Shift a signal by ``displ`` with edge-clamped sampling
    (dwt_util_displace1_s): out[i] = x[clamp(i + displ)]."""
    x = torch.movedim(as_tensor(x, device), axis, -1)
    n = x.shape[-1]
    idx = (torch.arange(n, device=x.device) + displ).clamp(0, n - 1)
    return torch.movedim(x[..., idx], -1, axis)


def displace1_zero(x, displ: int, axis: int = -1, device=None):
    """Shift with zero fill (dwt_util_displace1_zero_s)."""
    x = torch.movedim(as_tensor(x, device), axis, -1)
    n = x.shape[-1]
    src = torch.arange(n, device=x.device) + displ
    valid = (src >= 0) & (src < n)
    out = torch.where(valid, x[..., src.clamp(0, n - 1)], torch.zeros_like(x))
    return torch.movedim(out, -1, axis)


def _first_true(m: torch.Tensor) -> int:
    return int(torch.argmax(m.to(torch.uint8)))


def get_center1(x, p: float = 10.0, device=None) -> int:
    """p-norm centre of mass (dwt_util_get_center1_s): midpoint of the
    indices where the cumulative |x|^p crosses half the total from each
    side.  Computed in float64 on the input's device."""
    x = as_tensor(x, device)
    if x.ndim != 1:
        raise ValueError("get_center1 takes a 1-D signal")
    v = torch.abs(x).to(torch.float64) ** p
    total = float(v.sum())
    n = v.shape[0]
    if total == 0:
        return n // 2
    half = total / 2
    ridx = _first_true(torch.cumsum(v, 0) > half) - 1
    lidx = n - 1 - _first_true(torch.cumsum(torch.flip(v, (0,)), 0) > half) + 1
    if ridx < 0 and lidx > n - 1:
        return n // 2
    return (min(lidx, n - 1) + max(ridx, 0)) // 2


def center1(x, max_iters: int = 8, p: float = 10.0, device=None):
    """Iteratively displace a signal so its p-norm centre sits at n/2
    (dwt_util_center1_s)."""
    out = as_tensor(x, device)
    n = out.shape[-1]
    for _ in range(max_iters):
        displ = n // 2 - get_center1(out, p)
        if displ == 0:
            break
        out = displace1_zero(out, -displ)
    return out.clone()


def center21(x, max_iters: int = 8, p: float = 10.0, device=None):
    """Per-row centering (dwt_util_center21_s)."""
    out = as_tensor(x, device).clone()
    for i in range(out.shape[0]):
        out[i] = center1(out[i], max_iters, p)
    return out


def viewport(x, offset_y: int, offset_x: int, size_y: int, size_x: int, device=None):
    """Rect view (dwt_util_viewport)."""
    return as_tensor(x, device)[..., offset_y : offset_y + size_y,
                                offset_x : offset_x + size_x]


def crop21(x, offset_x: int, size_x: int, device=None):
    """Per-row crop (dwt_util_crop21)."""
    return as_tensor(x, device)[..., offset_x : offset_x + size_x]
