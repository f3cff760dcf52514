"""Fused 2-D DWT tile kernels and the fused pyramid functions (port of
``libdwt_tpu.ops.fused``).

Every kernel here has two versions behind one wrapper:

* a hand-written CUDA kernel (``libdwt_torch/csrc``, built for sm_90a at
  first use, see :mod:`libdwt_torch.ops._cuda`), launched for a CUDA
  tensor — the wrapper launches it or raises, it never falls back;
* a plain PyTorch version with the same 2-D tile/halo decomposition, the
  same mirror reads and the same LL re-mirror arithmetic, taken only for
  a CPU tensor.  It plays the part of Pallas interpret mode in the tests
  and is what ``chip_smoke.py`` holds each kernel against on the card.

Tiles hold the *interleaved* signal (or interleaved coefficient image)
with a halo on both axes and start at even global indices, so local
parity is global parity.  Borders are whole-point symmetric reads
(:func:`_mirror_index`): for the symmetric-step wavelets that
:func:`fused_supported` accepts this equals the oracle's channel clamps,
forward and inverse, even and odd lengths.  A lifting step leaves the
outermost tile positions stale; the staleness moves one position inward
per step, and the halos are sized so it never reaches a kept output.

Axis order is rows-then-columns forward and columns-then-rows inverse,
for floats and ints alike (the integer transforms stay bit-exact only in
the oracle's order).

Ported kernels (TPU kernel ids of ROADMAP section B):
  B1 fused_dwt2_level      -> csrc/level.cu dwt_fwd1_*
  B4 fused_idwt2_level     -> csrc/level.cu dwt_inv1_*
  B2 fused_dwt2_2level     -> csrc/fused2l.cu dwt_fwd2_*
  B5 fused_idwt2_2level    -> csrc/fused2l.cu dwt_inv2_*
  B3 fused_deep_wavedec2   -> csrc/level.cu dwt_fwd1_*, one launch per level
  B6 fused_deep_waverec2   -> csrc/level.cu dwt_inv1_*, one launch per level
B1/B3 and B4/B6 share one CUDA kernel each and count their launches
apart.  The 3-D kernels B14/B15 are in :mod:`libdwt_torch.ops.fused3d`
and count in the same ``KERNELS`` table.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, NamedTuple, Tuple

import torch

from libdwt_torch.models.wavelets import Wavelet, get_wavelet
from libdwt_torch.ops import _cuda
from libdwt_torch.ops import separable as _sep
from libdwt_torch.ops.lifting import _inv_scales, _is_int

__all__ = [
    "fused_supported", "fused_dwt2_level", "fused_idwt2_level",
    "fused_dwt2_2level", "fused_idwt2_2level", "fused_deep_wavedec2",
    "fused_deep_waverec2", "fused_wavedec2", "fused_waverec2",
    "fused_wavedec2_plan", "KERNELS", "reset_counters", "HALO",
]

#: one-sided halo (signal samples) sufficient for up to 4 lifting steps.
HALO = 4
#: halo of the two-level forward tile: level-2 outputs need +-4 LL1
#: samples (+-8 signal) on top of level 1's +-4.
HALO2 = 12
#: channel-domain halo of the JAX inverse kernels (the deep inverse's
#: channel mirrors need CH + 1 samples per axis).
CH = 4
#: mirror-fill depth of the JAX two-level inverse (its size minimum).
CFIX = 6
#: row halo of the JAX two-level forward windows (its 8 MB window test).
HALOR = 16
#: the JAX deep-pyramid kernels' VMEM-resident image limit; the pyramid functions
#: keep it so the port runs the reference's per-level schedule.
_DEEP_VMEM_LIMIT = int(2.4 * 1024 * 1024)
#: below this edge length the pyramid functions leave a level to the deep tail or
#: the separable oracle (the reference's schedule).
MIN_FUSED = 1024
#: default tile edges: signal samples for the two-level kernels,
#: channel samples (2x signal) for the per-level kernel.
TILE2 = 64
TILE1 = 32


# ------------------------------------------------------------ launch counts


@dataclasses.dataclass
class KernelStat:
    """``calls``: wrapper calls on either device.  ``launches``: CUDA
    kernel launches (counted where the kernel is launched, only there)."""
    kid: str
    name: str
    source: str
    replaces: str
    calls: int = 0
    launches: int = 0


KERNELS = {
    "B1": KernelStat("B1", "fused_dwt2_level", "libdwt_torch/csrc/level.cu",
                     "libdwt_tpu/ops/fused.py:548"),
    "B2": KernelStat("B2", "fused_dwt2_2level", "libdwt_torch/csrc/fused2l.cu",
                     "libdwt_tpu/ops/fused.py:784"),
    "B3": KernelStat("B3", "fused_deep_wavedec2", "libdwt_torch/csrc/level.cu",
                     "libdwt_tpu/ops/fused.py:1381"),
    "B4": KernelStat("B4", "fused_idwt2_level", "libdwt_torch/csrc/level.cu",
                     "libdwt_tpu/ops/fused.py:984"),
    "B5": KernelStat("B5", "fused_idwt2_2level", "libdwt_torch/csrc/fused2l.cu",
                     "libdwt_tpu/ops/fused.py:1173"),
    "B6": KernelStat("B6", "fused_deep_waverec2", "libdwt_torch/csrc/level.cu",
                     "libdwt_tpu/ops/fused.py:1486"),
}


def reset_counters() -> None:
    for k in KERNELS.values():
        k.calls = 0
        k.launches = 0


# ------------------------------------------------------------ support checks


def fused_supported(wavelet) -> bool:
    """The fused kernels use whole-point mirror reads for borders, which
    equal the oracle's channel clamps only for symmetric-step wavelets
    (CDF families) or steps that never cross a block edge (Haar).
    Asymmetric-step wavelets (D4) must use the separable oracle."""
    wavelet = get_wavelet(wavelet)
    return wavelet.name == "haar" or all(st.is_symmetric for st in wavelet.steps)


def _check_fused_supported(wavelet):
    if not fused_supported(wavelet):
        raise ValueError(
            f"wavelet {wavelet.name!r} has asymmetric lifting steps; its "
            "border semantics need the separable path (impl='separable')"
        )
    if wavelet.support > HALO:
        raise ValueError(
            f"wavelet {wavelet.name!r} has lifting support "
            f"{wavelet.support} > {HALO}; the fused kernels' halos are "
            "sized for support <= 4 (use impl='separable')"
        )


# ------------------------------------------------------------ step tables


class _Step(NamedTuple):
    is_d: bool
    wl: float  # float: signed weights; int: integer weights
    wr: float
    sign: int = 1
    k: int = 0
    shift: int = 0


def _axis_scales(wavelet: Wavelet, is_int: bool, inverse: bool):
    """The per-axis (low, high) scale factors of one direction, or None
    (integers and unscaled wavelets)."""
    if is_int or wavelet.scale_s is None:
        return None
    return _inv_scales(wavelet) if inverse else (wavelet.scale_s, wavelet.scale_d)


def _step_table(wavelet: Wavelet, is_int: bool, inverse: bool):
    """Steps in application order (reversed and negated for the inverse)
    and the parity scale factors (LL, HL, LH, HH) or None."""
    if is_int:
        if wavelet.int_steps is None:
            raise ValueError(f"{wavelet.name}: no reversible integer path")
        steps = wavelet.int_steps[::-1] if inverse else wavelet.int_steps
        table = []
        for st in steps:
            wl, wr = st.weights
            table.append(_Step(st.target == "d", wl, wr,
                               -st.sign if inverse else st.sign, st.k, st.shift))
        return table, None
    steps = wavelet.steps[::-1] if inverse else wavelet.steps
    sgn = -1.0 if inverse else 1.0
    table = []
    for st in steps:
        wl, wr = (st.coeff, st.coeff) if st.is_symmetric else (st.left, st.right)
        table.append(_Step(st.target == "d", sgn * wl, sgn * wr))
    axis = _axis_scales(wavelet, False, inverse)
    if axis is None:
        return table, None
    lo, hi = axis
    return table, (lo * lo, lo * hi, hi * lo, hi * hi)


_params_cache: dict = {}


def _lift_params(wavelet: Wavelet, is_int: bool, inverse: bool):
    key = (wavelet, is_int, inverse)
    if key not in _params_cache:
        table, scales = _step_table(wavelet, is_int, inverse)
        p = _cuda.LiftParams()
        p.n = len(table)
        for i, st in enumerate(table):
            p.is_d[i] = int(st.is_d)
            if is_int:
                p.iwl[i], p.iwr[i] = st.wl, st.wr
                p.sign[i], p.k[i], p.shift[i] = st.sign, st.k, st.shift
            else:
                p.fwl[i], p.fwr[i] = st.wl, st.wr
                p.dwl[i], p.dwr[i] = st.wl, st.wr
        p.has_scale = int(scales is not None)
        for i, f in enumerate(scales or ()):
            p.scale[i] = p.dscale[i] = f
        lo, hi = _axis_scales(wavelet, is_int, inverse) or (1.0, 1.0)
        p.scale_lo, p.scale_hi = p.dscale_lo, p.dscale_hi = lo, hi
        _params_cache[key] = p
    return _params_cache[key]


# ------------------------------------------------------------ plain tile algebra


def _mirror_index(p: torch.Tensor, n: int) -> torch.Tensor:
    """Whole-point symmetric reflection of any positions into [0, n)."""
    if n == 1:
        return torch.zeros_like(p)
    period = 2 * (n - 1)
    q = torch.remainder(p, period)
    return torch.where(q >= n, period - q, q)


def _tile_index(n_tiles: int, step: int, ext: int, halo: int, n: int, device):
    """(n_tiles, ext) mirrored global indices of tiles i*step - halo + [0, ext)."""
    p = (torch.arange(n_tiles, device=device)[:, None] * step - halo
         + torch.arange(ext, device=device)[None, :])
    return _mirror_index(p, n)


def _zero_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    """``a`` with zero rows appended up to ``rows`` rows (the kernels read
    0 past a caller's row extension)."""
    if a.shape[0] >= rows:
        return a
    return torch.cat([a, a.new_zeros((rows - a.shape[0],) + tuple(a.shape[1:]))])


def _gather(img: torch.Tensor, ry: torch.Tensor, rx: torch.Tensor) -> torch.Tensor:
    """(ny, nx, E, E) tiles of a 2-D tensor at the given index rows."""
    return img[ry[:, None, :, None], rx[None, :, None, :]]


def _update(l, r, st: _Step, is_int: bool):
    if is_int:
        return st.sign * ((l * st.wl + r * st.wr + st.k) >> st.shift)
    if st.wl == st.wr:
        return (l + r) * st.wl
    upd = l * st.wl if st.wl else None
    if st.wr:
        term = r * st.wr
        upd = term if upd is None else upd + term
    return upd


def _lift_axis(t: torch.Tensor, table, axis: int) -> None:
    """All steps along one axis of the interleaved tiles ``t`` (-1 rows,
    -2 columns, -3 slabs), in place; the outermost positions are not
    updated (see the module docstring)."""
    v = t.movedim(axis, -1)
    n = v.shape[-1]
    is_int = _is_int(t.dtype)
    for st in table:
        start = 1 if st.is_d else 2
        upd = _update(v[..., start - 1: n - 2: 2], v[..., start + 1: n: 2], st, is_int)
        if upd is not None:
            v[..., start: n - 1: 2] += upd


def _scale_parity(t: torch.Tensor, scales) -> None:
    if scales is None:
        return
    for k, (py, px) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        t[..., py::2, px::2] *= scales[k]


def _band(core: torch.Tensor, py: int, px: int, rows: int, cols: int):
    """One parity class of the tiles' cores, assembled and cropped."""
    b = core[..., py::2, px::2]
    ny, nx, a, c = b.shape
    return b.permute(0, 2, 1, 3).reshape(ny * a, nx * c)[:rows, :cols]


def _assemble(core: torch.Tensor, rows: int, cols: int):
    ny, nx, a, c = core.shape
    return core.permute(0, 2, 1, 3).reshape(ny * a, nx * c)[:rows, :cols]


def _interleave(ll, hl, lh, hh, h: int, w: int):
    """The interleaved coefficient image of one level (bands by parity)."""
    y = torch.zeros((h, w), dtype=hl.dtype, device=hl.device)
    if ll is not None:
        y[0::2, 0::2] = ll
    y[0::2, 1::2] = hl
    y[1::2, 0::2] = lh
    y[1::2, 1::2] = hh
    return y


def _remirror(s: torch.Tensor, n: int, bases: torch.Tensor, off: int, axis: int):
    """Rewrite the tile positions at/after global ``n`` from global
    2n - off - p (off=2: whole-point around n-1; off=1: repeat rule),
    clamped into the tile; rows (axis -2) or columns (axis -1)."""
    ext = s.shape[axis]
    loc = torch.arange(ext, device=s.device)[None, :]
    p = bases[:, None] + loc
    src = torch.where(p >= n, (2 * n - off - p - bases[:, None]).clamp(min=0), loc)
    if axis == -2:
        idx = src[:, None, :, None].expand(-1, s.shape[1], -1, s.shape[3])
    else:
        idx = src[None, :, None, :].expand(s.shape[0], -1, s.shape[2], -1)
    return torch.gather(s, axis, idx)


def _ext_rows(n_tiles: int, step: int, ext: int, off: int, device) -> torch.Tensor:
    """(n_tiles, ext) unmirrored row indices i*step + off + [0, ext) into
    a caller-extended image."""
    return (torch.arange(n_tiles, device=device)[:, None] * step + off
            + torch.arange(ext, device=device)[None, :])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ------------------------------------------------------ plain kernel versions


def dwt2_level_tiles(x, wavelet, ty: int, tx: int, ext: int = 0):
    """One forward 2-D level on ty x tx tiles with a halo of HALO on both
    axes (the tile algebra of csrc/tiles.cuh fwd1_*, shared by B1/B3 and
    the streamed B7) -> (LL, HL, LH, HH), any size.  ``ext`` > 0: x
    carries that many caller rows above and below the image
    (boundary_rows='extended'), read with no row mirror; rows past them
    read as 0, as in the kernels."""
    wavelet = get_wavelet(wavelet)
    table, scales = _step_table(wavelet, _is_int(x.dtype), False)
    h, w = x.shape
    h -= 2 * ext
    ny, nx = _cdiv(h, ty), _cdiv(w, tx)
    rx = _tile_index(nx, tx, tx + 2 * HALO, HALO, w, x.device)
    if ext:
        # signal row y0 - HALO + r is row y0 - HALO + ext + r of x
        t = _gather(_zero_rows(x, ny * ty + HALO + ext),
                    _ext_rows(ny, ty, ty + 2 * HALO, ext - HALO, x.device), rx)
    else:
        t = _gather(x, _tile_index(ny, ty, ty + 2 * HALO, HALO, h, x.device), rx)
    _lift_axis(t, table, -1)
    _lift_axis(t, table, -2)
    _scale_parity(t, scales)
    core = t[..., HALO: HALO + ty, HALO: HALO + tx]
    cy, cx, fy, fx = -(-h // 2), -(-w // 2), h // 2, w // 2
    return (_band(core, 0, 0, cy, cx), _band(core, 0, 1, cy, fx),
            _band(core, 1, 0, fy, cx), _band(core, 1, 1, fy, fx))


def dwt2_level_plain(x, wavelet="cdf97", tile: int = TILE1, ext: bool = False):
    """Plain version of the per-level forward tile kernel (csrc/level.cu
    dwt_fwd1): one 2-D level -> (LL, HL, LH, HH), any size.  ``ext``: x
    carries HALO caller rows above and below (boundary_rows='extended'),
    read with no row mirror."""
    return dwt2_level_tiles(x, wavelet, 2 * tile, 2 * tile, HALO if ext else 0)


def idwt2_level_tiles(ll, hl, lh, hh, wavelet, ty: int, tx: int, ext: int = 0):
    """One inverse 2-D level on ty x tx output tiles (the tile algebra of
    csrc/tiles.cuh inv1_*, shared by B4/B6 and the streamed B9).  ``ext``
    > 0: every band carries that many caller channel rows above and below
    (boundary_rows='extended'), read with no row mirror."""
    wavelet = get_wavelet(wavelet)
    table, scales = _step_table(wavelet, _is_int(ll.dtype), True)
    h, w = ll.shape[0] + lh.shape[0], ll.shape[1] + hl.shape[1]
    # the extended bands interleave to h + 4*ext rows: signal row p is
    # channel row (p >> 1) + ext of its band, i.e. row p + 2*ext
    y = _interleave(ll, hl, lh, hh, h, w)
    h -= 4 * ext
    ny, nx = _cdiv(h, ty), _cdiv(w, tx)
    rx = _tile_index(nx, tx, tx + 2 * HALO, HALO, w, y.device)
    if ext:
        t = _gather(_zero_rows(y, ny * ty + HALO + 2 * ext),
                    _ext_rows(ny, ty, ty + 2 * HALO, 2 * ext - HALO, y.device), rx)
    else:
        t = _gather(y, _tile_index(ny, ty, ty + 2 * HALO, HALO, h, y.device), rx)
    _scale_parity(t, scales)
    _lift_axis(t, table, -2)
    _lift_axis(t, table, -1)
    return _assemble(t[..., HALO: HALO + ty, HALO: HALO + tx], h, w)


def idwt2_level_plain(ll, hl, lh, hh, wavelet="cdf97", tile: int = TILE1,
                      ext: bool = False):
    """Plain version of the per-level inverse tile kernel (csrc/level.cu
    dwt_inv1).  ``ext``: every band carries CH caller channel rows above
    and below (boundary_rows='extended'), read with no row mirror."""
    return idwt2_level_tiles(ll, hl, lh, hh, wavelet, 2 * tile, 2 * tile,
                             CH if ext else 0)


def _lift2d(t, table, scales, inverse: bool, lift2d):
    """The 2-D lift of interleaved windows: ``lift2d(t)`` where given (the
    banded body), else the polyphase steps in place (forward rows,
    columns, scale; inverse scale, columns, rows)."""
    if lift2d is not None:
        return lift2d(t)
    if inverse:
        _scale_parity(t, scales)
        _lift_axis(t, table, -2)
        _lift_axis(t, table, -1)
    else:
        _lift_axis(t, table, -1)
        _lift_axis(t, table, -2)
        _scale_parity(t, scales)
    return t


def dwt2_2level_tiles(x, wavelet, ty: int, tx: int, hy: int = HALO2, lift2d=None):
    """Two forward levels on ty x tx tiles with a halo of ``hy`` rows and
    HALO2 columns (the tile algebra of csrc/tiles.cuh fwd2_*, shared by B2
    and the streamed B8/B11).  Returns (LL2, (HL2, LH2, HH2), (HL1, LH1, HH1)).
    ``lift2d``: the 2-D lift of a batch of windows, if not the polyphase
    steps (B13's banded body)."""
    wavelet = get_wavelet(wavelet)
    table, scales = _step_table(wavelet, _is_int(x.dtype), False)
    h, w = x.shape
    qy, qx = ty // 2, tx // 2
    ny, nx = _cdiv(h, ty), _cdiv(w, tx)
    dev = x.device
    t = _gather(x, _tile_index(ny, ty, ty + 2 * hy, hy, h, dev),
                _tile_index(nx, tx, tx + 2 * HALO2, HALO2, w, dev))
    t = _lift2d(t, table, scales, False, lift2d)
    core = t[..., hy: hy + ty, HALO2: HALO2 + tx]
    n, m = h // 2, w // 2
    bands1 = (_band(core, 0, 1, n, m), _band(core, 1, 0, n, m), _band(core, 1, 1, n, m))
    # LL1 with a halo of 4, then the whole-point re-mirror past the
    # bottom/right edge (the signal mirror left it half-point there)
    s2 = t[..., hy - 8: hy - 8 + 2 * (qy + 8): 2, HALO2 - 8: HALO2 - 8 + 2 * (qx + 8): 2]
    s2 = _remirror(s2, n, torch.arange(ny, device=dev) * qy - 4, 2, -2)
    s2 = _remirror(s2, m, torch.arange(nx, device=dev) * qx - 4, 2, -1)
    s2 = _lift2d(s2, table, scales, False, lift2d)
    core2 = s2[..., 4: 4 + qy, 4: 4 + qx]
    q, r = h // 4, w // 4
    return (_band(core2, 0, 0, q, r),
            (_band(core2, 0, 1, q, r), _band(core2, 1, 0, q, r), _band(core2, 1, 1, q, r)),
            bands1)


def fused_dwt2_2level_plain(x, wavelet="cdf97", tile: int = TILE2):
    """Plain version of B2 (csrc/fused2l.cu dwt_fwd2)."""
    return dwt2_2level_tiles(x, wavelet, tile, tile)


def idwt2_2level_tiles(ll2, bands2, bands1, wavelet, ty: int, tx: int, lift2d=None):
    """Two inverse levels on ty x tx output tiles (the tile algebra of
    csrc/tiles.cuh inv2_*, shared by B5 and the streamed B10/B12);
    ``lift2d`` as in :func:`dwt2_2level_tiles`."""
    wavelet = get_wavelet(wavelet)
    table, scales = _step_table(wavelet, _is_int(ll2.dtype), True)
    hl1, lh1, hh1 = bands1
    h, w = hl1.shape[0] + lh1.shape[0], hl1.shape[1] + lh1.shape[1]
    n, m = h // 2, w // 2
    qy, qx = ty // 2, tx // 2
    ny, nx = _cdiv(h, ty), _cdiv(w, tx)
    dev = ll2.device
    # level 2 in the LL1 domain, halo 8
    y2 = _interleave(ll2, *bands2, n, m)
    s2 = _gather(y2, _tile_index(ny, qy, qy + 16, 8, n, dev),
                 _tile_index(nx, qx, qx + 16, 8, m, dev))
    s2 = _lift2d(s2, table, scales, True, lift2d)
    # LL1 past the bottom/right edge: level-1 channel rule s[N+m] = s[N-1-m]
    s2 = _remirror(s2, n, torch.arange(ny, device=dev) * qy - 8, 1, -2)
    s2 = _remirror(s2, m, torch.arange(nx, device=dev) * qx - 8, 1, -1)
    # level 1, halo 4: LL1 from the tiles above, details mirrored
    y1 = _interleave(None, hl1, lh1, hh1, h, w)
    t = _gather(y1, _tile_index(ny, ty, ty + 2 * HALO, HALO, h, dev),
                _tile_index(nx, tx, tx + 2 * HALO, HALO, w, dev))
    t[..., 0::2, 0::2] = s2[..., 6: 6 + ty // 2 + HALO, 6: 6 + tx // 2 + HALO]
    t = _lift2d(t, table, scales, True, lift2d)
    return _assemble(t[..., HALO: HALO + ty, HALO: HALO + tx], h, w)


def fused_idwt2_2level_plain(ll2, bands2, bands1, wavelet="cdf97", tile: int = TILE2):
    """Plain version of B5 (csrc/fused2l.cu dwt_inv2)."""
    return idwt2_2level_tiles(ll2, bands2, bands1, wavelet, tile, tile)


def fused_deep_wavedec2_plain(x, wavelet="cdf97", levels: int = 1, tile: int = TILE1):
    """Plain version of B3: the per-level forward tile kernel per level."""
    coeffs = []
    ll = x
    for _ in range(levels):
        ll, hl, lh, hh = dwt2_level_plain(ll, wavelet, tile)
        coeffs.append((hl, lh, hh))
    return [ll] + coeffs[::-1]


def fused_deep_waverec2_plain(coeffs, wavelet="cdf97", tile: int = TILE1):
    """Plain version of B6: the per-level inverse tile kernel per level."""
    ll = coeffs[0]
    for hl, lh, hh in coeffs[1:]:
        ll = idwt2_level_plain(ll, hl, lh, hh, wavelet, tile)
    return ll


# ------------------------------------------------------------ CUDA launches


#: the dtypes that have a CUDA kernel, and their entry points' suffixes
_SUFFIXES = {torch.float32: "f32", torch.float64: "f64", torch.int32: "i32"}
KERNEL_DTYPES = tuple(_SUFFIXES)


def _suffix(dtype) -> str:
    if dtype not in _SUFFIXES:
        raise TypeError(f"the CUDA kernels take float32, float64 or int32, got {dtype}")
    return _SUFFIXES[dtype]


def _launch(kid: str, fn_name: str, dtype, wavelet, inverse, args, device, extra=()):
    """Launch ``fn_name`` with ``args``, the lifting parameters, ``extra``
    (the banded body's matrices) and the current stream; count it."""
    fn = _cuda.kernel_fn(fn_name, _suffix(dtype))
    params = _lift_params(wavelet, dtype == torch.int32, inverse)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.byref(params), *extra, stream)
    _cuda.check(err, KERNELS[kid].name)
    KERNELS[kid].launches += 1


def _check_inputs(name: str, tile: int, *ts) -> None:
    """The kernels take one dtype on one device, and a positive tile."""
    if tile <= 0:
        raise ValueError(f"{name}: tile must be positive")
    if len({(t.dtype, t.device) for t in ts}) != 1:
        raise ValueError(f"{name}: all inputs need one dtype on one device")


def _empty(shape, like):
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _level_fwd_cuda(kid, x, wavelet, tile, ext=False):
    x = x.contiguous()
    h, w = x.shape
    if ext:
        h -= 2 * HALO
    cy, cx, fy, fx = -(-h // 2), -(-w // 2), h // 2, w // 2
    out = (_empty((cy, cx), x), _empty((cy, fx), x), _empty((fy, cx), x), _empty((fy, fx), x))
    _launch(kid, "dwt_fwd1", x.dtype, wavelet, False,
            _ptrs(x, *out) + [h, w, tile, int(ext)], x.device)
    return out


def _level_inv_cuda(kid, ll, hl, lh, hh, wavelet, tile, ext=False):
    ll, hl, lh, hh = (b.contiguous() for b in (ll, hl, lh, hh))
    h, w = ll.shape[0] + lh.shape[0], ll.shape[1] + hl.shape[1]
    if ext:
        h -= 4 * CH
    out = _empty((h, w), ll)
    _launch(kid, "dwt_inv1", ll.dtype, wavelet, True,
            _ptrs(ll, hl, lh, hh, out) + [h, w, tile, int(ext)], ll.device)
    return out


# ------------------------------------------------------------ kernel wrappers


def _check_boundary_rows(boundary_rows: str) -> bool:
    if boundary_rows not in ("mirror", "extended"):
        raise ValueError("boundary_rows must be 'mirror' or 'extended'")
    return boundary_rows == "extended"


def _check_strip_rows(strip_rows: int) -> None:
    # the reference's contract: reject rather than silently round
    if strip_rows and strip_rows % 16:
        raise ValueError("strip_rows must be a multiple of 16")


def fused_dwt2_level(x, wavelet="cdf97", strip_rows: int = 0,
                     boundary_rows: str = "mirror", tile: int = TILE1):
    """Single-level fused 2-D forward DWT (B1) -> (LL, HL, LH, HH), the
    values of the separable ``dwt2_level`` (floats to rounding, integers
    bit-exactly); any h, w > HALO, odd sizes giving ceil/floor bands.

    ``boundary_rows='extended'``: the caller supplies HALO = 4 valid rows
    above and below the image (x has h + 8 rows, h even), read with no
    row mirror; columns still mirror.  ``strip_rows`` keeps the
    reference's contract (a multiple of 16, else ValueError); the CUDA
    tile is 2-D, ``tile`` x ``tile`` samples of each band."""
    wavelet = get_wavelet(wavelet)
    _check_fused_supported(wavelet)
    if x.ndim != 2:
        raise ValueError("fused_dwt2_level takes one 2-D image; loop batches")
    ext = _check_boundary_rows(boundary_rows)
    h, w = x.shape
    if ext:
        h -= 2 * HALO
        if h % 2:
            raise ValueError("extended mode needs an even row count")
    if min(h, w) <= HALO:
        raise ValueError("image too small for the fused kernel; use the oracle")
    _check_strip_rows(strip_rows)
    _check_inputs("fused_dwt2_level", tile, x)
    KERNELS["B1"].calls += 1
    if not x.is_cuda:
        return dwt2_level_plain(x, wavelet, tile, ext)
    return _level_fwd_cuda("B1", x, wavelet, tile, ext)


def fused_idwt2_level(ll, hl, lh, hh, wavelet="cdf97", strip_rows: int = 0,
                      boundary_rows: str = "mirror", tile: int = TILE1):
    """Single-level fused 2-D inverse DWT (B4), the inverse of
    :func:`fused_dwt2_level`.

    ``boundary_rows='extended'``: the caller supplies CH = 4 valid
    channel rows above and below every band, read with no row mirror;
    columns still mirror."""
    wavelet = get_wavelet(wavelet)
    _check_fused_supported(wavelet)
    ext = _check_boundary_rows(boundary_rows)
    if any(b.ndim != 2 for b in (ll, hl, lh, hh)):
        raise ValueError("fused_idwt2_level takes the four 2-D bands of one "
                         "level; loop batches")
    e = 2 * CH if ext else 0
    cy, cx = ll.shape[0] - e, ll.shape[1]
    fy, fx = hh.shape[0] - e, hh.shape[1]
    h, w = cy + fy, cx + fx
    if min(h, w) < 2 * (CH + 1):  # channel mirror needs CH+1 samples
        raise ValueError("image too small for the fused kernel; use the oracle")
    _check_strip_rows(strip_rows)
    if (tuple(hl.shape) != (cy + e, fx) or tuple(lh.shape) != (fy + e, cx)
            or cy - fy not in (0, 1) or cx - fx not in (0, 1)):
        raise ValueError("band shapes do not form one level")
    _check_inputs("fused_idwt2_level", tile, ll, hl, lh, hh)
    KERNELS["B4"].calls += 1
    if not ll.is_cuda:
        return idwt2_level_plain(ll, hl, lh, hh, wavelet, tile, ext)
    return _level_inv_cuda("B4", ll, hl, lh, hh, wavelet, tile, ext)


def fused_dwt2_2level(x, wavelet="cdf97", tile: int = TILE2):
    """TWO decomposition levels in one pass over the image (B2).

    Returns (LL2, (HL2, LH2, HH2), (HL1, LH1, HH1)).  Requires h % 4 ==
    0, w % 4 == 0 and a symmetric-step wavelet.  CUDA kernel for a CUDA
    tensor, plain version for a CPU tensor."""
    wavelet = get_wavelet(wavelet)
    _check_fused_supported(wavelet)
    if x.ndim != 2:
        raise ValueError("fused_dwt2_2level takes one 2-D image")
    h, w = x.shape
    if h % 4 or w % 4:
        raise ValueError("fused_dwt2_2level needs h, w divisible by 4")
    if min(h, w) < 2 * HALO2:
        raise ValueError("image too small for the 2-level fused kernel")
    if tile % 4:
        raise ValueError("tile must be a positive multiple of 4")
    _check_inputs("fused_dwt2_2level", tile, x)
    KERNELS["B2"].calls += 1
    if not x.is_cuda:
        return fused_dwt2_2level_plain(x, wavelet, tile)
    x = x.contiguous()
    q = [_empty((h // 4, w // 4), x) for _ in range(4)]
    b = [_empty((h // 2, w // 2), x) for _ in range(3)]
    _launch("B2", "dwt_fwd2", x.dtype, wavelet, False,
            _ptrs(x, *q, *b) + [h, w, tile], x.device)
    return q[0], (q[1], q[2], q[3]), (b[0], b[1], b[2])


def fused_idwt2_2level(ll2, bands2, bands1, wavelet="cdf97", tile: int = TILE2):
    """TWO reconstruction levels in one pass (B5), the inverse of
    :func:`fused_dwt2_2level`."""
    wavelet = get_wavelet(wavelet)
    _check_fused_supported(wavelet)
    hl1, lh1, hh1 = bands1
    h, w = hl1.shape[-2] + lh1.shape[-2], hl1.shape[-1] + lh1.shape[-1]
    if h % 4 or w % 4:
        raise ValueError("fused_idwt2_2level needs h, w divisible by 4")
    if min(h, w) < 4 * (CFIX + 1):
        raise ValueError("image too small for the 2-level fused inverse")
    if tile % 4:
        raise ValueError("tile must be a positive multiple of 4")
    shapes2 = [(h // 4, w // 4)] * 4
    shapes1 = [(h // 2, w // 2)] * 3
    ins = [ll2, *bands2, *bands1]
    if [tuple(a.shape) for a in ins] != shapes2 + shapes1:
        raise ValueError("band shapes do not chain into a two-level pyramid")
    _check_inputs("fused_idwt2_2level", tile, *ins)
    KERNELS["B5"].calls += 1
    if not ll2.is_cuda:
        return fused_idwt2_2level_plain(ll2, bands2, bands1, wavelet, tile)
    ins = [a.contiguous() for a in ins]
    out = _empty((h, w), ll2)
    _launch("B5", "dwt_inv2", ll2.dtype, wavelet, True,
            _ptrs(*ins, out) + [h, w, tile], ll2.device)
    return out


def fused_deep_wavedec2(x, wavelet="cdf97", levels: int = 1, tile: int = TILE1):
    """ALL remaining pyramid levels (B3): one launch of the per-level
    tile kernel per level over device-memory intermediates.  Returns the
    wavedec2 pytree."""
    wavelet = get_wavelet(wavelet)
    _check_fused_supported(wavelet)
    if x.ndim != 2:
        raise ValueError("fused_deep_wavedec2 takes one 2-D image")
    if min(x.shape) >> (levels - 1) <= 2 * HALO:
        raise ValueError("too many levels for this size; reduce or use oracle")
    _check_inputs("fused_deep_wavedec2", tile, x)
    KERNELS["B3"].calls += 1
    if not x.is_cuda:
        return fused_deep_wavedec2_plain(x, wavelet, levels, tile)
    _suffix(x.dtype)
    coeffs = []
    ll = x
    for _ in range(levels):
        ll, hl, lh, hh = _level_fwd_cuda("B3", ll, wavelet, tile)
        coeffs.append((hl, lh, hh))
    return [ll] + coeffs[::-1]


def fused_deep_waverec2(coeffs, wavelet="cdf97", tile: int = TILE1):
    """Inverse of :func:`fused_deep_wavedec2` (B6): ``coeffs`` is a
    wavedec2 prefix [LLn, (hl_n, lh_n, hh_n), ..., (hl_1, lh_1, hh_1)];
    returns the image at the finest provided level."""
    wavelet = get_wavelet(wavelet)
    _check_fused_supported(wavelet)
    ll = coeffs[0]
    if ll.ndim != 2:
        raise ValueError("fused_deep_waverec2 takes one 2-D pyramid")
    if len(coeffs) > 1 and min(ll.shape) <= CH:
        raise ValueError(
            f"coarsest LL {tuple(ll.shape)} too small for the deep inverse's "
            f"channel mirrors (needs > {CH} samples per axis)"
        )
    ch, cw = ll.shape
    for (hl, lh, hh) in coeffs[1:]:
        h, w = ch + lh.shape[-2], cw + hl.shape[-1]
        if tuple(hl.shape) != (ch, w // 2) or tuple(lh.shape) != (h // 2, cw) \
                or tuple(hh.shape) != (h // 2, w // 2):
            raise ValueError("band shapes do not chain into a pyramid")
        ch, cw = h, w
    if len(coeffs) == 1:
        return ll
    _check_inputs("fused_deep_waverec2", tile, *[ll] + [b for lvl in coeffs[1:] for b in lvl])
    KERNELS["B6"].calls += 1
    if not ll.is_cuda:
        return fused_deep_waverec2_plain(coeffs, wavelet, tile)
    _suffix(ll.dtype)
    for hl, lh, hh in coeffs[1:]:
        ll = _level_inv_cuda("B6", ll, hl, lh, hh, wavelet, tile)
    return ll


# ------------------------------------------------------------ pyramid schedules


def fused_wavedec2_plan(h: int, w: int, level: int, itemsize: int,
                        wavelet) -> List[Tuple[str, int]]:
    """The forward pyramid's per-level schedule, as (step, levels) pairs
    with step in '2level' (B2), 'level' (B1), 'deep' (B3), 'separable' —
    the reference's choice: two levels per pass on large div-4 frames
    whose 32-row window fits 8 MB, one fused level on other large
    frames, the deep tail once the image is small, the oracle else."""
    sup = fused_supported(wavelet)
    plan = []
    remaining = level
    while remaining > 0:
        if (remaining >= 2 and h % 4 == 0 and w % 4 == 0
                and min(h, w) >= MIN_FUSED and sup
                and (32 + 2 * HALOR) * w * itemsize <= 8 * 1024 * 1024):
            plan.append(("2level", 2))
            h, w, remaining = h // 4, w // 4, remaining - 2
        elif min(h, w) >= MIN_FUSED and sup:
            plan.append(("level", 1))
            h, w, remaining = -(-h // 2), -(-w // 2), remaining - 1
        elif (remaining >= 2 and sup
              and (h + 8) * (w + 8) * itemsize <= _DEEP_VMEM_LIMIT
              and min(h, w) >> (remaining - 1) > 2 * HALO):
            plan.append(("deep", remaining))
            remaining = 0
        else:
            plan.append(("separable", 1))
            h, w, remaining = -(-h // 2), -(-w // 2), remaining - 1
    return plan


def fused_wavedec2(x, wavelet="cdf97", level: int = 1):
    """Multi-level MRA on the fused kernels (schedule:
    :func:`fused_wavedec2_plan`).  Same pytree as wavedec2."""
    if x.ndim != 2:
        raise ValueError("fused_wavedec2 takes one 2-D image; loop batches")
    coeffs = []
    ll = x
    for step, n in fused_wavedec2_plan(x.shape[0], x.shape[1], level,
                                       x.element_size(), wavelet):
        if step == "2level":
            ll, b2, b1 = fused_dwt2_2level(ll, wavelet)
            coeffs += [b1, b2]
        elif step == "level":
            ll, hl, lh, hh = fused_dwt2_level(ll, wavelet)
            coeffs.append((hl, lh, hh))
        elif step == "deep":
            deep = fused_deep_wavedec2(ll, wavelet, n)
            ll = deep[0]
            coeffs.extend(deep[:0:-1])  # fine-first into the accumulator
        else:
            ll, hl, lh, hh = _sep.dwt2_level(ll, wavelet)
            coeffs.append((hl, lh, hh))
    return [ll] + coeffs[::-1]


def fused_waverec2(coeffs, wavelet="cdf97"):
    """Multi-level reconstruction: the deep inverse tail for every small
    coarse level, then the two-level inverse where geometry allows, the
    separable oracle otherwise (the reference's schedule)."""
    ll = coeffs[0]
    rest = list(coeffs[1:])
    if ll.ndim == 2 and fused_supported(wavelet):
        # the deep tail's channel mirrors need CH + 1 samples per axis;
        # reconstruct smaller coarsest levels with the oracle first
        while rest and min(ll.shape[-2], ll.shape[-1]) <= CH:
            hl, lh, hh = rest[0]
            h0, w0 = ll.shape[-2] + lh.shape[-2], ll.shape[-1] + hl.shape[-1]
            if (tuple(hl.shape[-2:]) != (ll.shape[-2], w0 // 2)
                    or tuple(lh.shape[-2:]) != (h0 // 2, ll.shape[-1])
                    or tuple(hh.shape[-2:]) != (h0 // 2, w0 // 2)):
                break
            ll = _sep.idwt2_level(ll, hl, lh, hh, wavelet)
            rest = rest[1:]
        deep = 0
        ch, cw = ll.shape[-2], ll.shape[-1]
        for (hl, lh, hh) in rest:
            h, w = ch + lh.shape[-2], cw + hl.shape[-1]
            if (tuple(hl.shape) != (ch, w // 2) or tuple(lh.shape) != (h // 2, cw)
                    or tuple(hh.shape) != (h // 2, w // 2)
                    or (h + 8) * (w + 8) * ll.element_size() > _DEEP_VMEM_LIMIT):
                break
            deep += 1
            ch, cw = h, w
        if deep:
            ll = fused_deep_waverec2([ll] + rest[:deep], wavelet)
            rest = rest[deep:]

    while rest:
        h2 = rest[0][0].shape[-2] + rest[0][1].shape[-2]
        w2 = rest[0][0].shape[-1] + rest[0][1].shape[-1]
        if (len(rest) >= 2 and ll.ndim == 2 and fused_supported(wavelet)
                and h2 % 2 == 0 and w2 % 2 == 0):
            # peek one level further: the 2-level inverse consumes two
            h1 = rest[1][0].shape[-2] + rest[1][1].shape[-2]
            w1 = rest[1][0].shape[-1] + rest[1][1].shape[-1]
            if (min(h1, w1) >= MIN_FUSED and h1 % 4 == 0 and w1 % 4 == 0
                    and h1 == 2 * h2 and w1 == 2 * w2):
                ll = fused_idwt2_2level(ll, rest[0], rest[1], wavelet)
                rest = rest[2:]
                continue
        ll = _sep.idwt2_level(ll, *rest[0], wavelet)
        rest = rest[1:]
    return ll
