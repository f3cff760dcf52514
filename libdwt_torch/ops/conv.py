"""Generic strided convolution and signal utilities (port of
``libdwt_tpu.ops.conv``).

  * ``convolve1``: libdwt's dwt_util_convolve1_s, a centred convolution
    with output downsampling and kernel upsampling factors, whose signal
    accesses saturate at the edges (signal_t's border rule);
  * ``find_max_pos``: dwt_util_find_max_pos_s.

The C loops become one batched gather and an einsum.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from libdwt_torch.utils.device import as_tensor

__all__ = ["convolve1", "find_max_pos"]


def convolve1(
    x,
    g,
    *,
    y_size: Optional[int] = None,
    y_center: Optional[int] = None,
    x_center: Optional[int] = None,
    g_center: Optional[int] = None,
    downsample: int = 1,
    upsample: int = 1,
    axis: int = -1,
    device=None,
) -> torch.Tensor:
    """Centered convolution with saturated borders.

    ``y[i] = sum_j g[j] * x[downsample*i - upsample*j]`` where y, x, g
    indices are taken relative to their centers and x accesses saturate
    at the signal edges.  Centers default to size//2.
    """
    x = torch.movedim(as_tensor(x, device), axis, -1)
    g = as_tensor(g, x.device).to(x.dtype)
    n = x.shape[-1]
    m = g.shape[-1]
    y_size = n if y_size is None else y_size
    y_center = y_size // 2 if y_center is None else y_center
    x_center = n // 2 if x_center is None else x_center
    g_center = m // 2 if g_center is None else g_center

    yi = torch.arange(y_size, device=x.device) - y_center  # relative output index
    gj = torch.arange(m, device=x.device) - g_center  # relative kernel index
    # absolute x index, clamped (saturated border)
    xi = (downsample * yi[:, None] - upsample * gj[None, :] + x_center).clamp(0, n - 1)
    taps = x[..., xi]  # (..., y_size, m)
    y = torch.einsum("...ym,m->...y", taps, g)
    return torch.movedim(y, -1, axis)


def find_max_pos(a, device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(max, y, x) of the first maximum in raster order over the last two
    axes."""
    a = as_tensor(a, device)
    flat = a.reshape(a.shape[:-2] + (-1,))
    idx = torch.argmax(flat, dim=-1)
    w = a.shape[-1]
    return flat.max(dim=-1).values, idx // w, idx % w
