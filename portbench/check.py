"""The comparison that decides ``correct``.

What the timed path produced for a frame is held against the plain
reference (:mod:`portbench.reference.lifting`) run again from the same
input, one component at a time so that it fits beside the program's
state:

- float encode: ``band_rel_err``, the largest over the frame's bands of
  max|program - reference| / max|reference| in that band (all components
  of the band together), the reference in float64;
- float decode: ``frame_rel_err``, the same over the reconstructed frame;
- integer (either direction): ``mismatches``, the coefficients or
  samples that differ from the reference at all (exact: limit 0).

A control puts the reference itself in the program's place, in a lower
precision (``dtype``) or with the integer rounding that breaks the
reversible transform (``int_round='trunc'``).
"""
from __future__ import annotations

import torch

from portbench.reference import lifting as ref

__all__ = ["leaves", "number_names", "control_of", "reference_output", "compare"]


def leaves(tree):
    """The tensors of a pyramid ([LL, (HL, LH, HH), ...]) or a frame."""
    if isinstance(tree, (list, tuple)):
        return [t for part in tree for t in leaves(part)]
    return [tree]


def number_names(cfg, direction: str):
    if cfg["dtype"].startswith("int"):
        return ("mismatches",)
    return ("band_rel_err",) if direction == "encode" else ("frame_rel_err",)


def control_of(cfg):
    """The control's keywords for :func:`compare`: the reference in
    bfloat16 for float32 (float32 for float64), and for an integer
    configuration the rounding toward zero (its values fit int16, so a
    narrower integer would not fail)."""
    if cfg["dtype"].startswith("int"):
        return {"int_round": "trunc"}
    return {"dtype": torch.float32 if cfg["dtype"] == "float64" else torch.bfloat16}


def reference_output(cfg, direction: str, x, component: int, dtype=None,
                     int_round: str = "floor"):
    """The reference's output for one component of input ``x`` (a frame
    for encode, a pyramid for decode): a list of tensors in the order of
    :func:`leaves`.  Float inputs run in ``dtype`` (default float64)."""
    def prep(t):
        t = t[component]
        if t.dtype.is_floating_point:
            t = t.to(dtype or torch.float64)
        return t

    if direction == "encode":
        return leaves(ref.wavedec2(prep(x), cfg["wavelet"], cfg["levels"], int_round))
    coeffs = [prep(x[0])] + [tuple(prep(b) for b in lvl) for lvl in x[1:]]
    return [ref.waverec2(coeffs, cfg["wavelet"], int_round)]


def compare(cfg, direction: str, x, got, control=None):
    """The numbers of :func:`number_names` for one frame: ``got`` is the
    program's output for input ``x``; with ``control`` (a dict of
    :func:`reference_output` keywords) the control's output stands in for
    it and ``got`` is not read."""
    integer = cfg["dtype"].startswith("int")
    num, den = [], []
    mismatches = 0
    for c in range(cfg["components"]):
        want = reference_output(cfg, direction, x, c)
        if control is None:
            have = [t[c] for t in leaves(got)]
        else:
            have = reference_output(cfg, direction, x, c, **control)
        if len(have) != len(want):
            raise ValueError(f"{len(have)} output tensors, the reference has {len(want)}")
        if not num:
            num, den = [0.0] * len(want), [0.0] * len(want)
        for i, (h, w) in enumerate(zip(have, want)):
            if tuple(h.shape) != tuple(w.shape):
                raise ValueError(f"output {i} has shape {tuple(h.shape)}, "
                                 f"the reference {tuple(w.shape)}")
            if integer:
                mismatches += int((h.to(w.dtype) != w).sum())
            else:
                num[i] = max(num[i], float((h.double() - w).abs().max()))
                den[i] = max(den[i], float(w.abs().max()))
        del want, have
    if integer:
        return {"mismatches": float(mismatches)}
    err = max(n / max(d, 1.0) for n, d in zip(num, den))
    return {number_names(cfg, direction)[0]: err}
