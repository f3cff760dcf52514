"""Where the port's entry points run.

A torch tensor stays on its own device.  Anything else (a numpy array,
a list) is converted and placed on ``device``, which defaults to the
card: with no CUDA device that raises instead of computing on the CPU
behind the caller's back.  Callers who want the CPU say
``device="cpu"`` or pass a CPU tensor.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or a CPU "
            "tensor) to run the transform on the CPU"
        )
    return dev


def as_tensors(*xs, device=None):
    """Each of ``xs`` as a tensor (:func:`as_tensor`); a non-tensor goes to
    ``device`` or, if that is None, to the device of the first tensor
    among ``xs``."""
    if device is None:
        device = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return tuple(x if isinstance(x, torch.Tensor) else as_tensor(x, device) for x in xs)


def as_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor: tensors keep their device unless ``device``
    names another one; other inputs go to ``device`` (default cuda)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))
