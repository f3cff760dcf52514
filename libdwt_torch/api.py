"""High-level dispatching API (port of ``libdwt_tpu.api``, the 2-D half
plus separable 3-D).

Strategies:
  * ``separable``    — batched torch lifting (the oracle; always valid)
  * ``fused``        — the hand-written CUDA tile kernels of ops/fused
                       (their plain versions for CPU tensors)
  * ``streamed``, ``streamed-mxu`` — not ported yet (ROADMAP rows B7-B13)
  * ``auto``         — built-in thresholds (no tuned table for the GPU yet)

An explicit ``impl`` is honoured or raises.  'auto' picks 'fused' only on
a CUDA tensor with 1024 <= min(h, w) < 2048, as the reference does for an
untuned device, and only where the fused schedule runs ported kernels
alone: until the single fused levels (B1/B4) are ported, a geometry that
needs one goes to 'separable' under 'auto'.

Devices: a torch tensor stays on its own device; anything else goes to
``device`` (default: the card; without CUDA that raises — pass
``device='cpu'`` to compute on the CPU).
"""
from __future__ import annotations

from typing import Optional

import torch

from libdwt_torch.ops import fused as _fused
from libdwt_torch.ops import separable as _sep
from libdwt_torch.utils.device import as_tensor
from libdwt_torch.utils.subband import resolve_j

__all__ = ["set_impl", "get_impl", "dwt2", "idwt2", "wavedec2", "waverec2",
           "wavedec3", "waverec3"]

_IMPLS = ("auto", "fused", "separable", "streamed", "streamed-mxu")
_default_impl = "auto"

#: below this edge length the fused kernels cannot run at all.
_FUSED_MIN_SIZE = 32
#: 'auto' prefers separable below this edge length (small levels are
#: launch-latency-bound).
_AUTO_MIN_SIZE = 1024
#: at/above this edge length an untuned device also defaults to separable
#: (the reference's built-in policy for device kinds without a table).
_AUTO_FUSED_MAX = 2048


def set_impl(impl: str) -> None:
    """Set the global kernel strategy (dwt_util_set_accel analogue)."""
    global _default_impl
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}")
    _default_impl = impl


def get_impl() -> str:
    return _default_impl


def _not_ported(impl: str):
    raise NotImplementedError(
        f"impl={impl!r} is not ported to the GPU yet (ROADMAP.md section B, "
        "rows B7-B13); use impl='fused' or 'separable'"
    )


def _pick_impl(h: int, w: int, wavelet, impl: Optional[str], on_cuda: bool,
               fused_ok: bool = True) -> str:
    """'separable' | 'fused'.  Explicit requests are honoured or raise;
    'auto' uses the built-in thresholds.  ``fused_ok``: the fused
    schedule of this call runs ported kernels only."""
    impl = impl or _default_impl
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}")
    if impl == "separable":
        return impl
    if impl in ("streamed", "streamed-mxu"):
        _not_ported(impl)
    feasible = min(h, w) >= _FUSED_MIN_SIZE and _fused.fused_supported(wavelet)
    if impl == "fused":
        if not feasible:
            raise ValueError(
                f"fused impl needs min(h,w) >= {_FUSED_MIN_SIZE} and a "
                "symmetric-step wavelet"
            )
        return impl
    if not (feasible and on_cuda and fused_ok):
        return "separable"
    return "fused" if _AUTO_MIN_SIZE <= min(h, w) < _AUTO_FUSED_MAX else "separable"


def _frames(x):
    return x.reshape((-1,) + tuple(x.shape[-2:]))


def dwt2(x, wavelet="cdf97", impl: Optional[str] = None, device=None):
    """Single-level 2-D forward transform -> (LL, HL, LH, HH)."""
    x = as_tensor(x, device)
    if impl == "streamed-mxu":
        raise ValueError(
            "impl='streamed-mxu' applies to multi-level transforms only "
            "(wavedec2/waverec2); use impl='streamed' for single levels"
        )
    h, w = x.shape[-2], x.shape[-1]
    # the single fused level is B1, not ported yet: 'auto' never picks it
    if _pick_impl(h, w, wavelet, impl, x.is_cuda, fused_ok=False) == "fused":
        _fused.fused_dwt2_level(x, wavelet)
    return _sep.dwt2_level(x, wavelet)


def idwt2(ll, hl, lh, hh, wavelet="cdf97", impl: Optional[str] = None,
          border: str = "mirror", device=None):
    """Single-level 2-D inverse transform; non-mirror ``border`` modes
    ('hole', 'zero') run on the separable path."""
    ll, hl, lh, hh = (as_tensor(b, device) for b in (ll, hl, lh, hh))
    if border != "mirror":
        return _sep.idwt2_level(ll, hl, lh, hh, wavelet, border=border)
    if impl == "streamed-mxu":
        raise ValueError(
            "impl='streamed-mxu' applies to multi-level transforms only "
            "(wavedec2/waverec2); use impl='streamed' for single levels"
        )
    h, w = ll.shape[-2] + hh.shape[-2], ll.shape[-1] + hh.shape[-1]
    if _pick_impl(h, w, wavelet, impl, ll.is_cuda, fused_ok=False) == "fused":
        _fused.fused_idwt2_level(ll, hl, lh, hh, wavelet)
    return _sep.idwt2_level(ll, hl, lh, hh, wavelet)


def wavedec2(x, wavelet="cdf97", level: Optional[int] = None,
             impl: Optional[str] = None, device=None):
    """Multi-level 2-D MRA -> [LL_J, (HL_J, LH_J, HH_J), ..., (HL_1, LH_1, HH_1)].

    With 'fused' each frame runs :func:`ops.fused.fused_wavedec2`; a
    batch (..., H, W) is looped frame by frame."""
    x = as_tensor(x, device)
    h, w = x.shape[-2], x.shape[-1]
    j = resolve_j(h, w, level)
    plan = _fused.fused_wavedec2_plan(h, w, j, x.element_size(), wavelet)
    fused_ok = all(step != "level" for step, _ in plan)
    choice = _pick_impl(h, w, wavelet, impl, x.is_cuda, fused_ok)
    if choice == "fused":
        if x.ndim == 2:
            return _fused.fused_wavedec2(x, wavelet, j)
        per = [_fused.fused_wavedec2(f, wavelet, j) for f in _frames(x)]
        batch = tuple(x.shape[:-2])

        def stack(*leaves):
            s = torch.stack(leaves)
            return s.reshape(batch + tuple(s.shape[-2:]))

        out = [stack(*[p[0] for p in per])]
        for lvl in range(1, len(per[0])):
            out.append(tuple(stack(*[p[lvl][k] for p in per]) for k in range(3)))
        return out
    # 'separable': lock it for every level (no per-level re-dispatch)
    coeffs = []
    ll = x
    for _ in range(j):
        ll, hl, lh, hh = _sep.dwt2_level(ll, wavelet)
        coeffs.append((hl, lh, hh))
    return [ll] + coeffs[::-1]


def waverec2(coeffs, wavelet="cdf97", impl: Optional[str] = None,
             border: str = "mirror", device=None):
    """Inverse of :func:`wavedec2`; non-mirror ``border`` modes run on
    the separable path."""
    coeffs = [as_tensor(coeffs[0], device)] + [
        tuple(as_tensor(b, device) for b in lvl) for lvl in coeffs[1:]]
    ll = coeffs[0]
    if len(coeffs) > 1 and border == "mirror":
        h = coeffs[-1][0].shape[-2] + coeffs[-1][1].shape[-2]
        w = coeffs[-1][0].shape[-1] + coeffs[-1][1].shape[-1]
        if _pick_impl(h, w, wavelet, impl, ll.is_cuda) == "fused":
            if ll.ndim == 2:
                return _fused.fused_waverec2(coeffs, wavelet)
            batch = tuple(ll.shape[:-2])
            flat = [_frames(coeffs[0])] + [tuple(_frames(b) for b in lvl)
                                           for lvl in coeffs[1:]]
            per = [_fused.fused_waverec2(
                [flat[0][i]] + [tuple(b[i] for b in lvl) for lvl in flat[1:]],
                wavelet) for i in range(flat[0].shape[0])]
            out = torch.stack(per)
            return out.reshape(batch + tuple(out.shape[-2:]))
    for hl, lh, hh in coeffs[1:]:
        ll = _sep.idwt2_level(ll, hl, lh, hh, wavelet, border=border)
    return ll


def _check_impl3(impl: Optional[str]):
    impl = impl or _default_impl
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}")
    if impl in ("fused", "streamed", "streamed-mxu"):
        raise NotImplementedError(
            f"3-D impl={impl!r} is not ported to the GPU yet (ROADMAP.md "
            "section B, rows B14-B17); use impl='separable'"
        )


def wavedec3(x, wavelet="cdf97", level: Optional[int] = None,
             impl: Optional[str] = None, device=None):
    """Multi-level 3-D MRA (separable until B14-B17 are ported)."""
    _check_impl3(impl)
    return _sep.wavedec3(as_tensor(x, device), wavelet, level)


def waverec3(coeffs, wavelet="cdf97", impl: Optional[str] = None, device=None):
    """Inverse of :func:`wavedec3`."""
    _check_impl3(impl)
    low = as_tensor(coeffs[0], device)
    rest = [{k: as_tensor(v, device) for k, v in b.items()} for b in coeffs[1:]]
    return _sep.waverec3([low] + rest, wavelet)
