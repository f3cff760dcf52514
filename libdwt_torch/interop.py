"""The state carried across from the JAX package: coefficient pyramids.

A DWT has no weights: its state is the coefficient pyramid (and the
wavelet constants of :mod:`libdwt_torch.models.wavelets`).  A
``libdwt_tpu`` ``wavedec2`` pytree, handed over as numpy arrays (or any
array ``numpy.asarray`` accepts), becomes the port's
``[LL, (HL, LH, HH), ...]`` of tensors and back.  Lists stay lists,
tuples stay tuples, dicts (3-D band sets) stay dicts.
"""
from __future__ import annotations

import numpy as np
import torch

from libdwt_torch.utils.device import resolve_device

__all__ = ["pyramid_from_numpy", "pyramid_to_numpy"]


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
