"""Stationary (undecimated, à-trous) wavelet transform (port of
``libdwt_tpu.ops.swt``).

Per level the signal is filtered with the analysis filter bank upsampled
by 2^level, with saturated (edge-clamp) borders and no decimation
(libdwt's swt.c).  The analysis filters are read off the wavelet's own
lifting steps, so they agree with the DWT path; for CDF 9/7 and 5/3
they equal the taps libdwt hardcodes.

Also a full multi-level SWT and its inverse: the inverse averages the two
polyphase reconstructions per level, the standard ISWT recursion.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from libdwt_torch.models.wavelets import get_wavelet
from libdwt_torch.ops.conv import convolve1
from libdwt_torch.ops.lifting import lift_fwd, lift_inv
from libdwt_torch.utils.device import as_tensor

__all__ = ["analysis_filters", "swt_level", "swt1", "iswt1", "swt2", "iswt2"]


@functools.lru_cache(maxsize=None)
def _analysis_filters_np(name: str) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """(lowpass g, highpass h, g_center, h_center) derived from lifting,
    on the CPU in float64 whatever the data's device.

    The forward lifting transform of an identity matrix of size N gives
    L[k, i] = weight of x[k] in low output i (likewise H for high); the
    taps are read off around the interior sample i0, away from borders.
    """
    n = 64
    lo, hi = lift_fwd(torch.eye(n, dtype=torch.float64), get_wavelet(name), axis=-1)
    lo, hi = lo.numpy(), hi.numpy()
    i0 = n // 4

    def taps(col, a0):
        # col[k] = weight of x[k]; a0 = undecimated output position.
        # Convolution form y[a] = sum_j g[j] x[a + gc - j], i.e.
        # g[j] = col[a0 + gc - j]: the taps are the reversed column,
        # centre at (len-1) - (a0 - k0).
        k = np.nonzero(np.abs(col) > 1e-12)[0]
        t = col[k[0] : k[-1] + 1]
        return t[::-1].copy(), (len(t) - 1) - (a0 - k[0])

    g, g_center = taps(lo[:, i0], 2 * i0)
    h, h_center = taps(hi[:, i0], 2 * i0 + 1)
    return g, h, g_center, h_center


def analysis_filters(wavelet) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Analysis (lowpass, highpass, lo_center, hi_center) FIR taps as
    float64 numpy arrays (CDF 9/7 and 5/3: centres len//2)."""
    return _analysis_filters_np(get_wavelet(wavelet).name)


def swt_level(x, wavelet="cdf97", level: int = 0, axis: int = -1, device=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level of forward SWT -> (approx, detail), same length as x:
    convolution with the filter bank upsampled by 2^level, saturated
    borders, centres at size//2."""
    x = as_tensor(x, device)
    g, h, gc, hc = analysis_filters(wavelet)
    up = 1 << level
    lo = convolve1(x, torch.as_tensor(g, dtype=x.dtype, device=x.device),
                   g_center=gc, upsample=up, axis=axis)
    hi = convolve1(x, torch.as_tensor(h, dtype=x.dtype, device=x.device),
                   g_center=hc, upsample=up, axis=axis)
    return lo, hi


def swt1(x, wavelet="cdf97", level: int = 1, axis: int = -1, device=None):
    """Multi-level 1-D SWT -> [A_J, D_J, ..., D_1] (all same length)."""
    details = []
    approx = as_tensor(x, device)
    for j in range(level):
        approx, detail = swt_level(approx, wavelet, level=j, axis=axis)
        details.append(detail)
    return [approx] + details[::-1]


def _rec(a, d, wavelet):
    """One ISWT reconstruction along the last axis: the two polyphase
    DWT inverses, averaged."""
    # à-trous grid: approx lives at even positions (s[i] = A[2i]),
    # detail at odd (d[i] = D[2i+1]), as the analysis filters' centres say
    e = lift_inv(a[..., 0::2], d[..., 1::2], wavelet, axis=-1)
    # odd phase: the DWT of x shifted by one sample
    d2 = torch.roll(d, -1, dims=-1)
    o = lift_inv(a[..., 1::2], d2[..., 1::2], wavelet, axis=-1)
    o = torch.roll(o, 1, dims=-1)
    return 0.5 * (e + o)


def _rec_axis(a, d, wavelet, step: int, axis: int):
    """Level reconstruction along ``axis``: each of the ``step``
    interleaved sub-signals on its own."""
    a = torch.movedim(a, axis, -1)
    d = torch.movedim(d, axis, -1)
    out = torch.zeros_like(a)
    for p in range(step):
        out[..., p::step] = _rec(a[..., p::step], d[..., p::step], wavelet)
    return torch.movedim(out, -1, axis)


def iswt1(coeffs, wavelet="cdf97", axis: int = -1, device=None):
    """Inverse multi-level 1-D SWT (shift-averaging recursion).  Needs
    the length divisible by 2^level."""
    coeffs = [as_tensor(c, device) for c in coeffs]
    level = len(coeffs) - 1
    n = coeffs[0].shape[axis]
    if n % (1 << level):
        raise ValueError(
            f"ISWT needs the transformed axis ({n}) divisible by "
            f"2^level ({1 << level})"
        )
    wavelet = get_wavelet(wavelet)
    approx = coeffs[0]
    for jidx, detail in enumerate(coeffs[1:]):
        approx = _rec_axis(approx, detail, wavelet, 1 << (level - 1 - jidx), axis)
    return approx


def swt2(x, wavelet="cdf97", level: int = 1, device=None):
    """Multi-level 2-D SWT -> [A_J, (H_J, V_J, D_J), ..., (H_1, V_1, D_1)]:
    separable à-trous over the last two axes (rows then columns per
    level), all outputs image-sized."""
    bands = []
    approx = as_tensor(x, device)
    for j in range(level):
        lo_x, hi_x = swt_level(approx, wavelet, level=j, axis=-1)
        ll, lh = swt_level(lo_x, wavelet, level=j, axis=-2)
        hl, hh = swt_level(hi_x, wavelet, level=j, axis=-2)
        approx = ll
        bands.append((hl, lh, hh))
    return [approx] + bands[::-1]


def iswt2(coeffs, wavelet="cdf97", device=None):
    """Inverse multi-level 2-D SWT (phase-averaged separable recursion).
    Needs both image dims divisible by 2^level."""
    approx = as_tensor(coeffs[0], device)
    level = len(coeffs) - 1
    if approx.shape[-1] % (1 << level) or approx.shape[-2] % (1 << level):
        raise ValueError(
            f"ISWT needs H, W ({approx.shape[-2]}, {approx.shape[-1]}) divisible "
            f"by 2^level ({1 << level})"
        )
    wavelet = get_wavelet(wavelet)
    for jidx, bands in enumerate(coeffs[1:]):
        hl, lh, hh = (as_tensor(b, device) for b in bands)
        step = 1 << (level - 1 - jidx)
        lo_x = _rec_axis(approx, lh, wavelet, step, -2)
        hi_x = _rec_axis(hl, hh, wavelet, step, -2)
        approx = _rec_axis(lo_x, hi_x, wavelet, step, -1)
    return approx
