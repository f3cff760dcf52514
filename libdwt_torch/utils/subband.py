"""Subband geometry for the packed (halved L|H) coefficient layout.

The port's own copy of the JAX package's geometry helpers.  At each
level the low channel takes ceil(n/2) samples and the high channel
floor(n/2); the packed array places L at offset 0 and H at offset
ceil(n/2) (libdwt src/libdwt.c:20731-20795, dwt_util_subband).

Band naming follows libdwt's ``enum dwt_subbands``:
  LL — low  y, low  x (top-left)
  HL — low  y, high x (top-right)   [highpass along rows/x]
  LH — high y, low  x (bottom-left) [highpass along columns/y]
  HH — high y, high x (bottom-right)
"""
from __future__ import annotations

from typing import Tuple

import torch


def ceil_div2(n: int) -> int:
    return (n + 1) // 2


def floor_div2(n: int) -> int:
    return n // 2


def ceil_div_pow2(n: int, j: int) -> int:
    """ceil(n / 2**j) — the level-j region size."""
    return -(-n // (1 << j))


def ceil_log2(n: int) -> int:
    """Smallest j with 2**j >= n."""
    if n <= 1:
        return 0
    return (n - 1).bit_length()


def j_limit(size_x: int, size_y: int, decompose_one: bool = False) -> int:
    """Maximum decomposition depth."""
    base = max(size_x, size_y) if decompose_one else min(size_x, size_y)
    return ceil_log2(base)


def resolve_j(size_y: int, size_x: int, j_max, decompose_one: bool = False) -> int:
    """Clamp a requested level count: negative or too-large requests
    become j_limit."""
    lim = j_limit(size_x, size_y, decompose_one)
    if j_max is None or j_max < 0 or j_max > lim:
        return lim
    return j_max


def band_rect(size_y: int, size_x: int, j: int, band: str) -> Tuple[slice, slice]:
    """(row_slice, col_slice) of a band at level ``j`` (1-based) in the packed
    layout of an array transformed to depth >= j."""
    if j < 1 and band != "LL":
        raise ValueError(
            f"band {band!r} needs a level >= 1 (detail bands exist only "
            "after at least one decomposition)"
        )
    ll_y, ll_x = size_y, size_x
    h_y, h_x = size_y, size_x
    for _ in range(j):
        h_y, h_x = floor_div2(ll_y), floor_div2(ll_x)
        ll_y, ll_x = ceil_div2(ll_y), ceil_div2(ll_x)
    if band == "LL":
        return slice(0, ll_y), slice(0, ll_x)
    if band == "HL":
        return slice(0, ll_y), slice(ll_x, ll_x + h_x)
    if band == "LH":
        return slice(ll_y, ll_y + h_y), slice(0, ll_x)
    if band == "HH":
        return slice(ll_y, ll_y + h_y), slice(ll_x, ll_x + h_x)
    raise ValueError(f"unknown band {band!r}")


def band_view(a, j: int, band: str):
    """Slice one subband out of a packed 2-D transform array."""
    ry, rx = band_rect(a.shape[-2], a.shape[-1], j, band)
    return a[..., ry, rx]


def level_sizes(size_y: int, size_x: int, j_max: int):
    """Per-level (region_y, region_x) sizes for levels 0..j_max."""
    return [
        (ceil_div_pow2(size_y, j), ceil_div_pow2(size_x, j))
        for j in range(j_max + 1)
    ]


def count_subbands(size_y: int, size_x: int, j_max: int) -> int:
    """Number of nonempty subbands (dwt_util_count_subbands analogue)."""
    count = 0
    for j in range(1, j_max + 1):
        for band in ("HL", "LH", "HH"):
            ry, rx = band_rect(size_y, size_x, j, band)
            if (ry.stop - ry.start) > 0 and (rx.stop - rx.start) > 0:
                count += 1
    ry, rx = band_rect(size_y, size_x, j_max, "LL")
    if (ry.stop - ry.start) > 0 and (rx.stop - rx.start) > 0:
        count += 1
    return count


def zero_padding_f(dst_l, dst_h, n: int, axis: int = -1):
    """Zero the padding tails of L/H channel tensors after a forward
    decomposition of an ``n``-sample signal: L keeps ceil(n/2) valid
    samples, H keeps floor(n/2); everything beyond along ``axis`` is
    set to zero (``dwt_zero_padding_f``)."""

    def tail_zero(a, keep):
        ax = axis if axis >= 0 else a.ndim + axis
        shape = [1] * a.ndim
        shape[ax] = a.shape[ax]
        mask = (torch.arange(a.shape[ax], device=a.device) < keep).reshape(shape)
        return torch.where(mask, a, torch.zeros((), dtype=a.dtype, device=a.device))

    return tail_zero(dst_l, ceil_div2(n)), tail_zero(dst_h, floor_div2(n))


def zero_padding_i(dst_l, n: int, axis: int = -1):
    """Zero the padding tail of a composed L channel after a
    reconstruction step that produced ``n`` valid samples
    (``dwt_zero_padding_i``)."""
    l, _ = zero_padding_f(dst_l, dst_l, 2 * n, axis=axis)
    return l
