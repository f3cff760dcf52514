"""High-level dispatching API (port of ``libdwt_tpu.api``).

Strategies:
  * ``separable``    — batched torch lifting (the oracle; always valid)
  * ``fused``        — the hand-written CUDA tile kernels of ops/fused and
                       ops/fused3d (their plain versions for CPU tensors)
  * ``streamed``     — the streamed strip and tile kernels of ops/streamed
                       (single levels, and the ``wavedec2``/``waverec2``
                       pyramid) and ops/streamed3d (``wavedec3``/``waverec3``)
  * ``streamed-mxu`` — the streamed pyramid with the banded-matmul strip
                       body (B13, float32 only): ``wavedec2``/``waverec2``
                       run B8/B10/B11/B12's ``body='mxu'`` instantiations; an
                       explicit 'streamed-mxu' on a single level raises
                       ``ValueError`` (as in the reference), and as the
                       global default it runs the streamed level B7/B9
  * ``auto``         — the measured per-card table (:mod:`libdwt_torch.autotune`,
                       tools/tune_torch.py), else built-in thresholds

An explicit ``impl`` is honoured or raises; a per-call name outside
these is taken as 'auto', as in the reference (``set_impl`` refuses it).
'auto' takes a kernel only on a CUDA tensor of a kernel's dtype (float32,
float64, int32); on a CPU tensor it is 'separable' and reads no table.
In 2-D it asks :func:`autotune.dispatch_choice` for the size bucket and
direction (a streamed winner on a geometry the streamed kernels refuse
runs 'fused'; a 'streamed-mxu' winner where the banded body cannot run
runs 'streamed'); with no table entry it picks 'fused' for 1024 <=
min(h, w) < 2048, as the reference does for an untuned device.  A pyramid
whose top level stays separable under an explicit 'auto' re-dispatches
each level (with impl=None it locks separable for every level).  In 3-D
'auto' asks :func:`autotune.volume_choice` wherever the fused geometry
allows (even dims > 4; a streamed winner the streamed gate refuses runs
'fused'), else, or with no entry, takes 'fused' there.

Devices: a torch tensor stays on its own device; anything else goes to
``device`` (default: the card; without CUDA that raises — pass
``device='cpu'`` to compute on the CPU).

Under a :func:`libdwt_torch.utils.trace.recording`, the 2-D entries record
spans (``api.dwt2``, ``api.idwt2``, ``api.wavedec2``, ``api.waverec2``,
``api.dispatch`` around the choice, ``api.unframe`` around a batch's
stacks) and count each choice under ``dispatch``, keyed (entry,
direction, impl, 'HxW', dtype, wavelet, levels).  The 3-D entries record
nothing.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from libdwt_torch.autotune import dispatch_choice, volume_choice
from libdwt_torch.ops import UnsupportedGeometry
from libdwt_torch.ops import fused as _fused
from libdwt_torch.ops import fused3d as _fused3d
from libdwt_torch.ops import separable as _sep
from libdwt_torch.ops import streamed as _streamed
from libdwt_torch.ops import streamed3d as _streamed3d
from libdwt_torch.utils import trace as _trace
from libdwt_torch.utils.device import as_tensor
from libdwt_torch.utils.log import get_logger
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


def _no_mxu_single_level(impl: Optional[str]) -> None:
    """An explicit 'streamed-mxu' names a pyramid body: single levels
    refuse it, as the reference does."""
    if impl == "streamed-mxu":
        raise ValueError(
            "impl='streamed-mxu' applies to multi-level transforms only "
            "(wavedec2/waverec2); use impl='streamed' for single levels"
        )


def _streamed_ok(h: int, w: int, wavelet, levels: int) -> bool:
    return _streamed.streamed_supported((h, w), wavelet, 256,
                                        levels=2 if levels >= 2 else 1)


def _auto_fused_ok(on_cuda: bool, dtype) -> bool:
    """'auto' may take a kernel: a CUDA tensor of a kernel's dtype."""
    return on_cuda and dtype in _fused.KERNEL_DTYPES


def _pick_impl(h: int, w: int, wavelet, impl: Optional[str], on_cuda: bool,
               dtype, levels: int = 1, direction: str = "fwd") -> str:
    """'separable' | 'fused' | 'streamed' | 'streamed-mxu'.  Explicit
    requests are honoured or raise; 'auto' consults the measured table for
    ``direction`` ('fwd' or 'inv'), then the built-in thresholds, and so
    does a name outside ``_IMPLS``, as in the reference (only
    :func:`set_impl` checks the name)."""
    impl = impl or _default_impl
    if impl == "separable":
        return impl
    if impl in ("streamed", "streamed-mxu"):
        if not _streamed_ok(h, w, wavelet, levels):
            raise ValueError(
                "streamed impl needs even dims (div. by 4 for 2+ levels), "
                "2..32 strips of rows and a symmetric-step wavelet"
            )
        if impl == "streamed-mxu" and not _streamed.mxu_supported(wavelet, dtype):
            raise ValueError("streamed-mxu impl needs a float32 symmetric wavelet")
        return impl
    feasible = min(h, w) >= _FUSED_MIN_SIZE and _fused.fused_supported(wavelet)
    if impl == "fused":
        if not feasible:
            raise ValueError(
                f"fused impl needs min(h,w) >= {_FUSED_MIN_SIZE} and a "
                "symmetric-step wavelet"
            )
        return impl
    if not (feasible and _auto_fused_ok(on_cuda, dtype)):
        return "separable"
    choice = dispatch_choice(h, w, dtype, wavelet, direction)
    if choice in ("streamed", "streamed-mxu") and not _streamed_ok(h, w, wavelet, levels):
        choice = "fused"
    if choice == "streamed-mxu" and not _streamed.mxu_supported(wavelet, dtype):
        # the banded body is float32-only; a winner may reach another dtype
        # through the size-bucket fallback
        choice = "streamed"
    if choice is not None:
        return choice
    return "fused" if _AUTO_MIN_SIZE <= min(h, w) < _AUTO_FUSED_MAX else "separable"


def _dispatch(entry: str, h: int, w: int, wavelet, impl: Optional[str], x,
              levels: int = 1, direction: str = "fwd") -> str:
    """:func:`_pick_impl` for a 2-D entry's tensor ``x``, spanned as
    ``api.dispatch`` and counted under ``dispatch``."""
    with _trace.span("api.dispatch"):
        choice = _pick_impl(h, w, wavelet, impl, x.is_cuda, x.dtype,
                            levels=levels, direction=direction)
    if _trace.enabled():
        _trace.count("dispatch", (entry, direction, choice, f"{h}x{w}",
                                  str(x.dtype).replace("torch.", ""),
                                  getattr(wavelet, "name", wavelet), levels))
    return choice


def _frames(x):
    return x.reshape((-1,) + tuple(x.shape[-2:]))


def _unframe(per, batch):
    """Stack the per-frame results (tensors, or tuples or lists of them, all
    of one structure) leaf by leaf and restore the batch dimensions."""
    with _trace.span("api.unframe"):
        return _stack(per, tuple(batch))


def _stack(per, batch):
    first = per[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([p[k] for p in per], batch) for k in range(len(first)))
    s = torch.stack(per)
    return s.reshape(batch + tuple(s.shape[-2:]))


def dwt2(x, wavelet="cdf97", impl: Optional[str] = None, device=None):
    """Single-level 2-D forward transform -> (LL, HL, LH, HH).  With
    'fused' each frame of a batch (..., H, W) runs B1 in turn, with
    'streamed' B7 (a 'streamed-mxu' global default runs B7 too)."""
    with _trace.span("api.dwt2"):
        x = as_tensor(x, device)
        _no_mxu_single_level(impl)
        h, w = x.shape[-2], x.shape[-1]
        choice = _dispatch("dwt2", h, w, wavelet, impl, x)
        if choice != "separable":
            level_fn = (_fused.fused_dwt2_level if choice == "fused"
                        else _streamed.streamed_dwt2_level)
            if x.ndim == 2:
                return level_fn(x, wavelet)
            return _unframe([level_fn(f, wavelet) for f in _frames(x)], x.shape[:-2])
        return _sep.dwt2_level(x, wavelet)


def idwt2(ll, hl, lh, hh, wavelet="cdf97", impl: Optional[str] = None,
          border: str = "mirror", device=None):
    """Single-level 2-D inverse transform (B4 with 'fused', B9 with
    'streamed'); non-mirror ``border`` modes ('hole', 'zero') run on the
    separable path."""
    with _trace.span("api.idwt2"):
        ll, hl, lh, hh = (as_tensor(b, device) for b in (ll, hl, lh, hh))
        if border != "mirror":
            return _sep.idwt2_level(ll, hl, lh, hh, wavelet, border=border)
        _no_mxu_single_level(impl)
        h, w = ll.shape[-2] + hh.shape[-2], ll.shape[-1] + hh.shape[-1]
        choice = _dispatch("idwt2", h, w, wavelet, impl, ll, direction="inv")
        if choice != "separable":
            level_fn = (_fused.fused_idwt2_level if choice == "fused"
                        else _streamed.streamed_idwt2_level)
            if ll.ndim == 2:
                return level_fn(ll, hl, lh, hh, wavelet)
            fl = [_frames(b) for b in (ll, hl, lh, hh)]
            per = [level_fn(*(b[i] for b in fl), wavelet) for i in range(fl[0].shape[0])]
            return _unframe(per, ll.shape[:-2])
        return _sep.idwt2_level(ll, hl, lh, hh, wavelet)


def wavedec2(x, wavelet="cdf97", level: Optional[int] = None,
             impl: Optional[str] = None, device=None):
    """Multi-level 2-D MRA -> [LL_J, (HL_J, LH_J, HH_J), ..., (HL_1, LH_1, HH_1)].

    With 'fused' each frame runs :func:`ops.fused.fused_wavedec2`, with
    'streamed' :func:`ops.streamed.streamed_wavedec2` (with
    'streamed-mxu' its banded-matmul strip body, B13); a batch (..., H, W)
    is looped frame by frame."""
    with _trace.span("api.wavedec2"):
        x = as_tensor(x, device)
        h, w = x.shape[-2], x.shape[-1]
        j = resolve_j(h, w, level)
        choice = _dispatch("wavedec2", h, w, wavelet, impl, x, levels=j)
        if choice != "separable":
            if choice == "fused":
                dec = _fused.fused_wavedec2
            else:
                dec = functools.partial(_streamed.streamed_wavedec2,
                                        body="mxu" if choice == "streamed-mxu" else "poly")
            if x.ndim == 2:
                return dec(x, wavelet, j)
            return _unframe([dec(f, wavelet, j) for f in _frames(x)], x.shape[:-2])
        # 'separable' at the top level: with impl=None lock it for every level;
        # an explicit impl ('auto', or a name outside _IMPLS) re-dispatches per
        # level through dwt2, as the reference does
        level_impl = impl if impl is not None else "separable"
        coeffs = []
        ll = x
        for _ in range(j):
            ll, hl, lh, hh = dwt2(ll, wavelet, impl=level_impl)
            coeffs.append((hl, lh, hh))
        return [ll] + coeffs[::-1]


def waverec2(coeffs, wavelet="cdf97", impl: Optional[str] = None,
             border: str = "mirror", device=None):
    """Inverse of :func:`wavedec2`; non-mirror ``border`` modes run on
    the separable path."""
    with _trace.span("api.waverec2"):
        coeffs = [as_tensor(coeffs[0], device)] + [
            tuple(as_tensor(b, device) for b in lvl) for lvl in coeffs[1:]]
        ll = coeffs[0]
        if len(coeffs) > 1 and border == "mirror":
            h = coeffs[-1][0].shape[-2] + coeffs[-1][1].shape[-2]
            w = coeffs[-1][0].shape[-1] + coeffs[-1][1].shape[-1]
            choice = _dispatch("waverec2", h, w, wavelet, impl, ll,
                               levels=len(coeffs) - 1, direction="inv")
            if choice != "separable":
                if choice == "fused":
                    rec = _fused.fused_waverec2
                else:
                    rec = functools.partial(
                        _streamed.streamed_waverec2,
                        body="mxu" if choice == "streamed-mxu" else "auto")
                if ll.ndim == 2:
                    return rec(coeffs, wavelet)
                batch = tuple(ll.shape[:-2])
                flat = [_frames(coeffs[0])] + [tuple(_frames(b) for b in lvl)
                                               for lvl in coeffs[1:]]
                per = [rec(
                    [flat[0][i]] + [tuple(b[i] for b in lvl) for lvl in flat[1:]],
                    wavelet) for i in range(flat[0].shape[0])]
                return _unframe(per, batch)
            # 'separable' at the top level: locked for impl=None, else each
            # level re-dispatches through idwt2 (see wavedec2)
            impl = impl if impl is not None else "separable"
        for hl, lh, hh in coeffs[1:]:
            ll = idwt2(ll, hl, lh, hh, wavelet, impl=impl, border=border)
        return ll


def _log_fallback(fn: str, choice: str, err: Exception) -> None:
    get_logger().warning(
        "%s: %s kernel declined the geometry (%s); "
        "falling back to separable", fn, choice, err)


def _resolve_impl3(impl: Optional[str]):
    """The call's impl (the global default if None) and whether it names a
    3-D kernel explicitly; a name outside ``_IMPLS`` is taken as 'auto', as
    in the reference."""
    impl = impl or _default_impl
    return impl, impl in ("fused", "streamed")


def _pick_impl3(shape3, wavelet, impl: Optional[str], on_cuda: bool,
                dtype, direction: str = "fwd") -> str:
    """3-D strategy: 'separable' | 'fused' | 'streamed'.  'fused' needs
    even dims > 4 and a symmetric-step wavelet, 'streamed' the
    reference's gate :func:`ops.streamed3d.streamed3d_supported` (sized
    with the dtype's itemsize), else ValueError; 'auto' on a CUDA tensor
    of a kernel's dtype, wherever the fused geometry allows, takes the
    measured table's choice for ``direction`` (a streamed winner the gate
    refuses runs 'fused'), else 'fused'."""
    impl, _ = _resolve_impl3(impl)
    if impl == "separable":
        return impl
    if impl == "streamed":
        if not _streamed3d.streamed3d_supported(shape3, wavelet,
                                                itemsize=dtype.itemsize):
            raise ValueError(
                "streamed 3-D impl needs even dims, 2..32 (z, y) tiles "
                "and a symmetric-step wavelet"
            )
        return impl
    z, yy, xx = shape3
    ok = (_fused.fused_supported(wavelet) and z % 2 == 0 and yy % 2 == 0
          and xx % 2 == 0 and min(z, yy, xx) > 4)
    if impl == "fused":
        if not ok:
            raise ValueError(
                "fused 3-D impl needs even dims > 4 and a symmetric-step "
                "wavelet"
            )
        return impl
    if not (ok and _auto_fused_ok(on_cuda, dtype)):
        return "separable"
    choice = volume_choice(dtype, wavelet, direction)
    if choice == "streamed" and not _streamed3d.streamed3d_supported(
            shape3, wavelet, itemsize=dtype.itemsize):
        choice = "fused"
    return "fused" if choice is None else choice


def wavedec3(x, wavelet="cdf97", level: Optional[int] = None,
             impl: Optional[str] = None, device=None):
    """Multi-level 3-D MRA -> [LLL_J, bands_J, ..., bands_1] (the pytree of
    ``ops.separable.wavedec3``).

    Each level re-dispatches: the fused (B14) or streamed (B16) volume
    kernel where its geometry allows, the separable oracle otherwise.  An
    explicit impl needs an unbatched (Z, Y, X) volume and is honoured or
    raises at the top level; a kernel's ``UnsupportedGeometry`` falls back
    to the oracle with a logged warning, and every other error
    propagates."""
    x = as_tensor(x, device)
    impl, explicit = _resolve_impl3(impl)
    if explicit and x.ndim != 3:
        raise ValueError(f"{impl} 3-D impl needs an unbatched (Z, Y, X) volume")
    dims = tuple(x.shape[-3:])
    if explicit:
        _pick_impl3(dims, wavelet, impl, x.is_cuda, x.dtype)
    j = resolve_j(min(dims), min(dims), level)
    coeffs = []
    low = x
    for _ in range(j):
        choice = "separable"
        if low.ndim == 3:
            try:
                choice = _pick_impl3(tuple(low.shape), wavelet, impl, low.is_cuda,
                                     low.dtype)
            except ValueError:
                choice = "separable"
        bands = None
        if choice != "separable":
            level_fn = (_fused3d.fused_dwt3_level if choice == "fused"
                        else _streamed3d.streamed_dwt3_level)
            # the kernels' own support checks (UnsupportedGeometry) are
            # the reference's documented fallback; they agree with the
            # gates above, so on today's kernels it is a guard
            try:
                bands = level_fn(low, wavelet)
            except UnsupportedGeometry as e:
                _log_fallback("wavedec3", choice, e)
        if bands is None:
            bands = _sep.dwt3_level(low, wavelet)
        low = bands.pop("LLL")
        coeffs.append(bands)
    return [low] + coeffs[::-1]


def waverec3(coeffs, wavelet="cdf97", impl: Optional[str] = None, device=None):
    """Inverse of :func:`wavedec3`: each level runs the fused (B15) or
    streamed (B17) inverse volume kernel where its geometry allows, the
    oracle otherwise, with the same honour-or-raise (at the finest level)
    and fallback rules."""
    low = as_tensor(coeffs[0], device)
    rest = [{k: as_tensor(v, device) for k, v in b.items()} for b in coeffs[1:]]
    impl, explicit = _resolve_impl3(impl)
    if explicit and low.ndim != 3:
        raise ValueError(f"{impl} 3-D impl needs an unbatched (Z, Y, X) pyramid")
    if explicit and rest:
        sample = next(iter(rest[-1].values()))
        _pick_impl3(tuple(2 * s for s in sample.shape[-3:]), wavelet, impl,
                    sample.is_cuda, sample.dtype, "inv")
    for bands in rest:
        full = dict(bands)
        full["LLL"] = low
        choice = "separable"
        if low.ndim == 3 and all(b.shape == low.shape for b in full.values()):
            try:
                choice = _pick_impl3(tuple(2 * s for s in low.shape), wavelet,
                                     impl, low.is_cuda, low.dtype, "inv")
            except ValueError:
                choice = "separable"
        rec = None
        if choice != "separable":
            level_fn = (_fused3d.fused_idwt3_level if choice == "fused"
                        else _streamed3d.streamed_idwt3_level)
            try:  # see wavedec3
                rec = level_fn(full, wavelet)
            except UnsupportedGeometry as e:
                _log_fallback("waverec3", choice, e)
        if rec is None:
            rec = _sep.idwt3_level(full, wavelet)
        low = rec
    return low
