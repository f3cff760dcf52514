"""Synthetic test images and comparison predicates.

The port's own copy of libdwt's ``dwt_util_test_image_fill_s`` pattern
and its compare predicates (eps = 1e-3).  Pure numpy: images are made on
the host and handed to the transforms on whatever device they run.
"""
from __future__ import annotations

import numpy as np

#: float round-trip tolerance used throughout libdwt.
EPS = 1.0e-3


def test_image(size_y: int, size_x: int, rand: int = 0, type: int = 0, dtype=np.float32):
    """libdwt's synthetic test pattern (1-based coordinates)."""
    y = np.arange(1, size_y + 1, dtype=np.int64)[:, None]
    x = np.arange(1, size_x + 1, dtype=np.int64)[None, :]
    if type == 0:
        xs = x >> rand
        img = 2.0 * xs * y / (xs * xs + y * y + 1.0)
    elif type == 2:
        i = (x ^ y) & 0xFF
        img = i / 32.0
    elif type == 3:
        v = (((x & 1) << 1) | (y & 1)) + 1
        img = v / 4.0
    else:
        raise ValueError(f"unknown test image type {type}")
    img = np.asarray(img, dtype=np.float64)
    if np.issubdtype(np.dtype(dtype), np.integer):
        # integer variant: the float pattern scaled to an 8-bit-like range
        return np.asarray(img * 255.0, dtype=dtype)
    return np.asarray(img, dtype=dtype)


def _np(a):
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def max_abs_err(a, b) -> float:
    a, b = _np(a), _np(b)
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b)))


def compare(a, b, eps: float = EPS) -> bool:
    """dwt_util_compare_s analogue: max abs error <= eps."""
    return max_abs_err(a, b) <= eps


def psnr(ref, x, peak: float | None = None) -> float:
    ref, x = _np(ref), _np(x)
    mse = float(np.mean((ref - x) ** 2))
    if mse == 0:
        return float("inf")
    if peak is None:
        peak = float(np.max(np.abs(ref)))
    return 10.0 * np.log10(peak * peak / mse)
