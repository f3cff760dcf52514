"""Fused single-pass 3-D DWT kernels, forward and inverse (port of
``libdwt_tpu.ops.fused3d``).

Each kernel has two versions behind one wrapper, as in
:mod:`libdwt_torch.ops.fused`: a hand-written CUDA kernel
(``csrc/fused3d.cu``) launched for a CUDA tensor, and a plain PyTorch
version with the same 3-D tile/halo decomposition, taken only for a CPU
tensor and held against the kernel on the card.

A tile is tz x ty x tx core samples of the interleaved volume with a
halo of 4 on every axis; tile starts are even, so local parity is global
parity.  All borders are whole-point mirror reads, which for the even
dims the kernels take equal the reference's signal-domain fills
(forward) and channel-domain rules (inverse).  Axis order is x, y, z
forward and z, y, x inverse; a float sample is scaled by its z, then y,
then x parity factor.

Ported kernels (TPU kernel ids of ROADMAP section B):
  B14 fused_dwt3_level   -> csrc/fused3d.cu dwt3_fwd_*
  B15 fused_idwt3_level  -> csrc/fused3d.cu dwt3_inv_*
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from libdwt_torch.models.wavelets import get_wavelet
from libdwt_torch.ops import UnsupportedGeometry
from libdwt_torch.ops.fused import (KERNELS, KernelStat, _axis_scales, _cdiv,
                                    _check_fused_supported, _check_inputs,
                                    _empty, _launch, _lift_axis, _step_table,
                                    _tile_index)
from libdwt_torch.ops.lifting import _is_int

__all__ = ["fused_dwt3_level", "fused_idwt3_level", "dwt3_level_plain",
           "idwt3_level_plain", "BANDS", "TILE3"]

#: the reference's forward z halo (its size minimum: dims > HZ) and
#: inverse channel halo (bands > CZ).
HZ = 4
CZ = 2
#: the port's tile halo on every axis (signal samples).
HALO = 4
#: default core tile (z, y, x): a 24x24x40 f32 tile, 92 KB of shared memory.
TILE3 = (16, 16, 32)
#: shared memory a block may use on Hopper.
_SMEM_MAX = 227 * 1024

BANDS = ("LLL", "LLH", "LHL", "LHH", "HLL", "HLH", "HHL", "HHH")

KERNELS["B14"] = KernelStat("B14", "fused_dwt3_level", "libdwt_torch/csrc/fused3d.cu",
                            "libdwt_tpu/ops/fused3d.py:352")
KERNELS["B15"] = KernelStat("B15", "fused_idwt3_level", "libdwt_torch/csrc/fused3d.cu",
                            "libdwt_tpu/ops/fused3d.py:512")


def _check_approach(approach: str) -> None:
    if approach not in ("interleaved", "poly"):
        raise ValueError(
            f"approach must be 'interleaved' or 'poly', got {approach!r}"
        )


def _check_strip_y(strip_y: int) -> None:
    if strip_y and strip_y % 16:
        raise ValueError("strip_y must be a multiple of 16")


def _check_tile(tile, itemsize: int, buffers: int = 1) -> None:
    """The CUDA tile: three positive even sizes whose ``buffers`` copies
    (two for the streamed kernels) fit in shared memory."""
    if len(tile) != 3 or any(t <= 0 or t % 2 for t in tile):
        raise ValueError("tile must be three positive even sizes (z, y, x)")
    e = [t + 2 * HALO for t in tile]
    if buffers * e[0] * e[1] * e[2] * itemsize > _SMEM_MAX:
        raise ValueError(f"{buffers} buffer(s) of tile {tuple(tile)} need more than "
                         f"{_SMEM_MAX} bytes of shared memory")


# ------------------------------------------------------ plain kernel versions


def _tiles3(vol: torch.Tensor, tile) -> torch.Tensor:
    """(nz, ny, nx, ez, ey, ex) tiles of ``vol`` at whole-point mirrored
    positions, core ``tile`` plus HALO on every side."""
    idx = [_tile_index(_cdiv(n, t), t, t + 2 * HALO, HALO, n, vol.device)
           for n, t in zip(vol.shape, tile)]
    return vol[idx[0][:, None, None, :, None, None],
               idx[1][None, :, None, None, :, None],
               idx[2][None, None, :, None, None, :]]


def _scale3(t: torch.Tensor, scales) -> None:
    """Per-axis parity factors, z, then y, then x, in place."""
    if scales is None:
        return
    lo, hi = scales
    for axis in (-3, -2, -1):
        v = t.movedim(axis, -1)
        v[..., 0::2] *= lo
        v[..., 1::2] *= hi


def _core3(t: torch.Tensor, shape) -> torch.Tensor:
    """The tiles' cores assembled into the (Z, Y, X) volume."""
    nz, ny, nx, ez, ey, ex = t.shape
    c = t[..., HALO: ez - HALO, HALO: ey - HALO, HALO: ex - HALO]
    tz, ty, tx = c.shape[-3:]
    v = c.permute(0, 3, 1, 4, 2, 5).reshape(nz * tz, ny * ty, nx * tx)
    return v[: shape[0], : shape[1], : shape[2]]


def dwt3_level_plain(x, wavelet="cdf97", tile=TILE3) -> Dict[str, torch.Tensor]:
    """Plain version of B14 (csrc/fused3d.cu dwt3_fwd): one 3-D level of
    an even-sized volume -> dict of the 8 bands."""
    wavelet = get_wavelet(wavelet)
    is_int = _is_int(x.dtype)
    table, _ = _step_table(wavelet, is_int, False)
    t = _tiles3(x, tile)
    for axis in (-1, -2, -3):
        _lift_axis(t, table, axis)
    _scale3(t, _axis_scales(wavelet, is_int, False))
    v = _core3(t, x.shape)
    return {name: v[i >> 2::2, (i >> 1) & 1::2, i & 1::2].contiguous()
            for i, name in enumerate(BANDS)}


def idwt3_level_plain(bands: Dict[str, torch.Tensor], wavelet="cdf97",
                      tile=TILE3) -> torch.Tensor:
    """Plain version of B15 (csrc/fused3d.cu dwt3_inv): the volume from
    the 8 equal-shaped bands of one level."""
    wavelet = get_wavelet(wavelet)
    lll = bands["LLL"]
    is_int = _is_int(lll.dtype)
    table, _ = _step_table(wavelet, is_int, True)
    vol = lll.new_empty(tuple(2 * s for s in lll.shape))
    for i, name in enumerate(BANDS):
        vol[i >> 2::2, (i >> 1) & 1::2, i & 1::2] = bands[name]
    t = _tiles3(vol, tile)
    _scale3(t, _axis_scales(wavelet, is_int, True))
    for axis in (-3, -2, -1):
        _lift_axis(t, table, axis)
    return _core3(t, vol.shape)


# ------------------------------------------------------------ kernel wrappers


def _band_ptrs(ts):
    """A host array of the 8 band pointers (the kernels' ``bands``)."""
    return (ctypes.c_void_p * 8)(*[t.data_ptr() for t in ts])


def fused_dwt3_level(x, wavelet="cdf97", strip_z: int = 0, strip_y: int = 0,
                     approach: str = "interleaved", tile=TILE3):
    """Single-level fused 3-D forward DWT (B14) -> dict of 8 subbands keyed
    'LLL'..'HHH' in (z, y, x) order: the values of the separable
    ``dwt3_level`` (floats to rounding, integers bit-exactly).

    Requires even (z, y, x) dims > HZ and a symmetric-step wavelet, else
    raises :class:`UnsupportedGeometry` or ValueError as the reference
    does.  ``approach`` ('interleaved' or 'poly') and ``strip_z``/
    ``strip_y`` keep the reference's signature and checks: the TPU kernel
    had two float engines and a (z, y) strip grid, which were choices of
    its VMEM layout; here both approaches run the one CUDA kernel on 3-D
    tiles of ``tile`` = (tz, ty, tx) core samples.
    """
    wavelet = get_wavelet(wavelet)
    _check_fused_supported(wavelet)
    _check_approach(approach)
    if x.ndim != 3:
        raise ValueError("fused_dwt3_level takes one 3-D volume")
    if any(d % 2 for d in x.shape):
        raise UnsupportedGeometry("fused_dwt3_level needs even dimensions")
    if min(x.shape) <= HZ:
        raise UnsupportedGeometry(
            "volume too small for the fused kernel; use the oracle")
    _check_strip_y(strip_y)
    _check_tile(tile, x.element_size())
    _check_inputs("fused_dwt3_level", min(tile), x)
    KERNELS["B14"].calls += 1
    if not x.is_cuda:
        return dwt3_level_plain(x, wavelet, tile)
    x = x.contiguous()
    z, y, w = x.shape
    out = [_empty((z // 2, y // 2, w // 2), x) for _ in BANDS]
    _launch("B14", "dwt3_fwd", x.dtype, wavelet, False,
            [x.data_ptr(), _band_ptrs(out), z, y, w, *tile], x.device)
    return dict(zip(BANDS, out))


def fused_idwt3_level(bands: Dict[str, torch.Tensor], wavelet="cdf97",
                      strip_z: int = 0, strip_y: int = 0,
                      approach: str = "interleaved", tile=TILE3):
    """Single-level fused 3-D inverse DWT (B15), the inverse of
    :func:`fused_dwt3_level`.  All 8 bands must share one shape (else
    ValueError); bands of <= CZ samples on an axis raise
    :class:`UnsupportedGeometry`."""
    wavelet = get_wavelet(wavelet)
    _check_fused_supported(wavelet)
    _check_approach(approach)
    lll = bands["LLL"]
    if lll.ndim != 3:
        raise ValueError("fused_idwt3_level takes the 3-D bands of one volume")
    cz, cy, cx = lll.shape
    for name in BANDS:
        if tuple(bands[name].shape) != (cz, cy, cx):
            raise ValueError(
                f"fused_idwt3_level needs equal band shapes: LLL="
                f"{(cz, cy, cx)} vs {name}={tuple(bands[name].shape)}"
            )
    if min(cz, cy, cx) <= CZ:
        raise UnsupportedGeometry(
            "volume too small for the fused inverse; use the oracle")
    _check_strip_y(strip_y)
    _check_tile(tile, lll.element_size())
    ins = [bands[n] for n in BANDS]
    _check_inputs("fused_idwt3_level", min(tile), *ins)
    KERNELS["B15"].calls += 1
    if not lll.is_cuda:
        return idwt3_level_plain(bands, wavelet, tile)
    ins = [b.contiguous() for b in ins]
    out = _empty((2 * cz, 2 * cy, 2 * cx), lll)
    _launch("B15", "dwt3_inv", lll.dtype, wavelet, True,
            [_band_ptrs(ins), out.data_ptr(), 2 * cz, 2 * cy, 2 * cx, *tile],
            lll.device)
    return out
