"""Array interop: pyramids from and to numpy, the flags API of
libdwt's OpenCV binding, power-of-two resize and coefficient display.

The pyramids: a DWT has no weights, its state is the coefficient pyramid
(and the wavelet constants of :mod:`libdwt_torch.models.wavelets`).  A
``libdwt_tpu`` ``wavedec2`` pytree, handed over as numpy arrays (or any
array ``numpy.asarray`` accepts), becomes the port's
``[LL, (HL, LH, HH), ...]`` of tensors and back.  Lists stay lists,
tuples stay tuples, dicts (3-D band sets) stay dicts.

The rest ports ``libdwt_tpu.interop``, the analogue of libdwt's OpenCV
C++ binding (``cvdwt.cpp``, ``cvdwt.h``): ``transform``'s flags
(forward/inverse, CDF 5/3 / 9/7) over the packed layout, ``resize_pot``
(resizePOT, cvdwt.cpp:15-44), per-channel split/merge of channels-last
arrays (cvdwt.cpp:303-406) and ``wtshow`` (cvdwt.cpp:46-64).  cv::Mat
becomes a numpy array or a torch tensor: a numpy array goes to
``device`` (default: the card; without CUDA that raises) and its result
comes back as numpy; a tensor is computed on its own device and its
result stays there.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as nnf

from libdwt_torch.image import _show
from libdwt_torch.ops.separable import fdwt2, idwt2
from libdwt_torch.utils.device import resolve_device

__all__ = [
    "DWT_FORWARD",
    "DWT_INVERSE",
    "DWT_CDF97",
    "DWT_CDF53",
    "resize_pot",
    "transform",
    "wtshow",
    "pyramid_from_numpy",
    "pyramid_to_numpy",
]

DWT_FORWARD = 1
DWT_INVERSE = 2
DWT_CDF97 = "cdf97"
DWT_CDF53 = "cdf53"


def _map(tree, fn):
    if isinstance(tree, list):
        return [_map(t, fn) for t in tree]
    if isinstance(tree, tuple):
        return tuple(_map(t, fn) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def pyramid_from_numpy(tree, device=None):
    """Pyramid of arrays -> the same pyramid of tensors on ``device``
    (default: the card; raises without CUDA)."""
    dev = resolve_device(device)
    return _map(tree, lambda a: torch.as_tensor(np.array(a), device=dev))


def pyramid_to_numpy(tree):
    """Pyramid of tensors -> the same pyramid of numpy arrays."""
    return _map(tree, lambda t: t.detach().cpu().numpy())


def _to_torch(a, device=None):
    """(tensor, wrap): a tensor stays on its device and ``wrap`` keeps its
    result there; anything else goes to ``device`` as a tensor and
    ``wrap`` brings the result back as numpy."""
    if isinstance(a, torch.Tensor):
        return a, (lambda t: t)
    x = torch.as_tensor(np.asarray(a), device=resolve_device(device))
    return x, (lambda t: t.detach().cpu().numpy())


def _channels_last(x) -> bool:
    """Heuristic shared by transform/resize_pot: a trailing axis of
    1-4 on a 3-D array whose leading axis is image-sized is a channel
    axis (cv::Mat convention, cvdwt.cpp:303)."""
    return x.ndim == 3 and x.shape[-1] in (1, 2, 3, 4) and x.shape[0] > 4


def resize_pot(img, interp: str = "linear", device=None):
    """Resize the spatial axes up to powers of two (dwt::resizePOT,
    cvdwt.cpp:15-44).  Channels-last (H, W, C) arrays keep their channel
    axis untouched.  ``interp='linear'`` is bilinear with half-pixel
    centres; anything else is nearest with half-pixel centres
    ('nearest-exact', the rule ``jax.image.resize`` applies)."""
    x, wrap = _to_torch(img, device)
    chan_last = _channels_last(x)
    if chan_last:
        x = x.movedim(-1, 0)
    h, w = x.shape[-2], x.shape[-1]
    ph = 1 << (h - 1).bit_length()
    pw = 1 << (w - 1).bit_length()
    if (ph, pw) != (h, w):
        lead = x.shape[:-2]
        flat = x.reshape((-1, 1, h, w))
        if interp == "linear":
            out = nnf.interpolate(flat, size=(ph, pw), mode="bilinear",
                                  align_corners=False)
        else:
            out = nnf.interpolate(flat, size=(ph, pw), mode="nearest-exact")
        x = out.reshape(lead + (ph, pw))
    if chan_last:
        x = x.movedim(0, -1)
    return wrap(x.contiguous())


def transform(img, flags: int = DWT_FORWARD, wavelet: str = DWT_CDF97,
              level: Optional[int] = None, device=None):
    """dwt::transform analogue (cvdwt.cpp:303-406): multi-channel arrays
    (..., H, W) or (H, W, C) channels-last are split, transformed per
    channel with the packed layout (the separable oracle), and merged."""
    x, wrap = _to_torch(img, device)
    chan_last = _channels_last(x)
    if chan_last:
        x = x.movedim(-1, 0).contiguous()
    fn = fdwt2 if flags & DWT_FORWARD else idwt2
    y = fn(x, wavelet, level)
    if chan_last:
        y = y.movedim(0, -1).contiguous()
    return wrap(y)


def wtshow(coeffs, device=None):
    """Viewable [0,1] rendering of a packed transform (dwt::wtshow,
    cvdwt.cpp:46-64), in float64."""
    x, wrap = _to_torch(coeffs, device)
    return wrap(_show(x))
