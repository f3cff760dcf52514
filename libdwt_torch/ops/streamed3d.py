"""Streamed one-level 3-D DWT kernels, forward and inverse (port of
``libdwt_tpu.ops.streamed3d``).

The JAX kernels stream (z, y) tiles of whole x rows through two VMEM slots
with explicit async copies.  The CUDA kernels (``csrc/streamed3d.cu``) keep
the semantics and the double buffering, not the TPU tiling: a persistent
block walks a column of ty x tx samples down z in tiles of tz slabs and
loads tile i+1 with cp.async while it lifts tile i, on the tile body of
the fused volume kernels (``csrc/tiles3.cuh``).

The reference's geometry rules are kept exactly (:func:`streamed3d_supported`,
:func:`_tiles3`, :func:`_pick_tiles` with its 8 MB window budget), so the
port accepts and refuses the same volumes with the same error classes;
they do not size the CUDA tile, which is ``tile`` = (tz, ty, tx) core
samples (default :data:`STILE3`).  ``approach`` ('interleaved' or 'poly')
is checked and runs the same kernel, as for B14/B15.

Ported kernels (TPU kernel ids of ROADMAP section B):
  B16 streamed_dwt3_level   -> csrc/streamed3d.cu dwt3_sfwd_*
  B17 streamed_idwt3_level  -> csrc/streamed3d.cu dwt3_sinv_*
Each wrapper launches its kernel for a CUDA tensor (or raises) and runs
its plain version, with the CUDA tile's decomposition, for a CPU tensor.
"""
from __future__ import annotations

from typing import Dict

from libdwt_torch.models.wavelets import get_wavelet
from libdwt_torch.ops import UnsupportedGeometry
from libdwt_torch.ops.fused import (KERNELS, KernelStat, _check_fused_supported,
                                    _check_inputs, _empty, _launch, fused_supported)
from libdwt_torch.ops.fused3d import (BANDS, CZ, HZ, TILE3, _band_ptrs,
                                      _check_approach, _check_tile, dwt3_level_plain,
                                      idwt3_level_plain)

__all__ = ["streamed3d_supported", "streamed_dwt3_level", "streamed_idwt3_level",
           "dwt3_level_streamed_plain", "idwt3_level_streamed_plain", "STILE3",
           "STILE3_F64"]

#: the reference's buffer halos (z and y, signal domain; channel domain).
TZH = 4   # == HZ
TYH = 8
CZH = 2   # == CZ
CYH = 8
#: the reference's unrolled-tile budget.
MAX_TILES = 32
#: the reference's fused 3-D y halo and its soft ceiling for one tile's
#: input window (whole x rows); they decide which volumes are accepted.
_HY = 8
_VMEM_BUDGET_3D = 8 * 1024 * 1024
#: default CUDA core tile (z, y, x): B14's 16x16x32, two 24x24x40 f32
#: buffers, 184 KB of shared memory, one block of 512 threads per SM.
#: 16x16x16 (108 KB, two blocks per SM) times the same at level 1 and 5%
#: slower at level 2; cores of 8 slabs or rows read too much halo (PERF.md).
STILE3 = TILE3
#: the float64 default: x halved, so that its two 24x24x24 buffers of
#: 8-byte samples (216 KB) fit the 227 KB a block may use (two 24x24x40
#: would take 369 KB).
STILE3_F64 = (16, 16, 16)


def _default_tile(tile, itemsize: int):
    """``tile``, or the default core tile for samples of ``itemsize`` bytes."""
    if tile is not None:
        return tile
    return STILE3_F64 if itemsize > 4 else STILE3

KERNELS["B16"] = KernelStat("B16", "streamed_dwt3_level",
                            "libdwt_torch/csrc/streamed3d.cu",
                            "libdwt_tpu/ops/streamed3d.py:115")
KERNELS["B17"] = KernelStat("B17", "streamed_idwt3_level",
                            "libdwt_torch/csrc/streamed3d.cu",
                            "libdwt_tpu/ops/streamed3d.py:249")


# ------------------------------------------------------------ geometry


def _pick_tiles(z, y, x, itemsize, budget=_VMEM_BUDGET_3D):
    """The reference's (tz, ty) with tz even, ty % 16 == 0 and a window of
    whole x rows that fits the budget (its ``fused3d._pick_tiles``)."""
    lane_bytes = x * itemsize

    def window_bytes(tz_, ty_):
        return (tz_ + 2 * HZ) * (ty_ + 2 * _HY) * lane_bytes

    ty = min(((y + 15) // 16) * 16, 256)
    tz = min(z + z % 2, 32)
    while window_bytes(tz, ty) > budget and ty > 16:
        ty = max(16, (ty // 32) * 16)
    while window_bytes(tz, ty) > budget and tz > HZ:
        tz = max(HZ, (tz // 4) * 2)
    if window_bytes(tz, ty) > budget:
        raise UnsupportedGeometry(
            f"cross-section row of {x} lanes too large for a VMEM tile")
    return tz, ty


def _tiles3(z, y, x, itemsize, strip_z, strip_y):
    """The reference's (z, y) tile of whole x rows: the picked tile or the
    caller's, tz clamped to >= HZ, shrunk until there are >= 2 tiles."""
    tz_auto, ty_auto = _pick_tiles(z, y, x, itemsize)
    tz = strip_z or tz_auto
    ty = strip_y or ty_auto
    tz += tz % 2
    tz = max(HZ, min(tz, z + z % 2))
    if ty % 16:
        raise ValueError("strip_y must be a multiple of 16")
    ty = min(ty, ((y + 15) // 16) * 16)
    while -(-z // tz) * -(-y // ty) < 2:
        if not strip_z and tz > HZ:
            tz = max(HZ, (tz // 4) * 2)
        elif not strip_y and ty > 16:
            ty = max(16, (ty // 32) * 16)
        else:
            break
    return tz, ty


def streamed3d_supported(shape3, wavelet, strip_z=0, strip_y=0,
                         itemsize: int = 4) -> bool:
    """Geometry gate: even dims > HZ, a symmetric-step wavelet and 2..32
    reference tiles, sized with the dtype's real itemsize."""
    z, y, x = shape3
    if z % 2 or y % 2 or x % 2 or not fused_supported(wavelet):
        return False
    if min(z, y, x) <= HZ:
        return False
    try:
        tz, ty = _tiles3(z, y, x, itemsize, strip_z, strip_y)
    except ValueError:
        return False
    return 2 <= -(-z // tz) * -(-y // ty) <= MAX_TILES


def _check_reference_tiles(z, y, x, itemsize, strip_z, strip_y) -> None:
    tz, ty = _tiles3(z, y, x, itemsize, strip_z, strip_y)
    if not 2 <= -(-z // tz) * -(-y // ty) <= MAX_TILES:
        raise UnsupportedGeometry("geometry outside the streamed kernel's range")


# ------------------------------------------------------ plain kernel versions


def dwt3_level_streamed_plain(x, wavelet="cdf97", tile=None) -> Dict:
    """Plain version of B16: the CUDA tiles' decomposition (the fused
    tile algebra of B14 on ``tile``, default by the dtype's size)."""
    return dwt3_level_plain(x, wavelet, _default_tile(tile, x.element_size()))


def idwt3_level_streamed_plain(bands: Dict, wavelet="cdf97", tile=None):
    """Plain version of B17."""
    return idwt3_level_plain(bands, wavelet,
                             _default_tile(tile, bands["LLL"].element_size()))


# ------------------------------------------------------------ kernel wrappers


def streamed_dwt3_level(x, wavelet="cdf97", strip_z: int = 0, strip_y: int = 0,
                        approach: str = "interleaved", tile=None):
    """Single-level streamed 3-D forward DWT (B16) -> dict of 8 subbands
    keyed 'LLL'..'HHH', the values of the separable ``dwt3_level``.
    ``tile``: the CUDA core tile (default :data:`STILE3`, for float64
    :data:`STILE3_F64`).

    Raises :class:`UnsupportedGeometry` for odd dims, a dim <= HZ or a
    tile count outside 2..32, and ValueError for ``strip_y`` not a
    multiple of 16, as the reference does."""
    wavelet = get_wavelet(wavelet)
    _check_fused_supported(wavelet)
    _check_approach(approach)
    if x.ndim != 3:
        raise ValueError("streamed_dwt3_level takes one 3-D volume")
    z, y, w = x.shape
    if z % 2 or y % 2 or w % 2:
        raise UnsupportedGeometry("streamed 3-D kernel needs even dims")
    if min(z, y, w) <= HZ:
        raise UnsupportedGeometry("volume too small for the streamed kernel; "
                                  "use the oracle")
    _check_reference_tiles(z, y, w, x.element_size(), strip_z, strip_y)
    tile = _default_tile(tile, x.element_size())
    _check_tile(tile, x.element_size(), buffers=2)
    _check_inputs("streamed_dwt3_level", min(tile), x)
    KERNELS["B16"].calls += 1
    if not x.is_cuda:
        return dwt3_level_streamed_plain(x, wavelet, tile)
    x = x.contiguous()
    out = [_empty((z // 2, y // 2, w // 2), x) for _ in BANDS]
    _launch("B16", "dwt3_sfwd", x.dtype, wavelet, False,
            [x.data_ptr(), _band_ptrs(out), z, y, w, *tile], x.device)
    return dict(zip(BANDS, out))


def streamed_idwt3_level(bands: Dict, wavelet="cdf97", strip_z: int = 0,
                         strip_y: int = 0, approach: str = "interleaved",
                         tile=None):
    """Single-level streamed 3-D inverse (B17), the inverse of
    :func:`streamed_dwt3_level`.  All 8 bands must share one shape (else
    ValueError); bands of <= CZ samples on an axis, or a tile count
    outside 2..32, raise :class:`UnsupportedGeometry`."""
    wavelet = get_wavelet(wavelet)
    _check_fused_supported(wavelet)
    _check_approach(approach)
    lll = bands["LLL"]
    if lll.ndim != 3:
        raise ValueError("streamed_idwt3_level takes the 3-D bands of one volume")
    cz, cy, cx = lll.shape
    for name in BANDS:
        if tuple(bands[name].shape) != (cz, cy, cx):
            raise ValueError(
                f"streamed 3-D inverse needs equal band shapes: LLL="
                f"{(cz, cy, cx)} vs {name}={tuple(bands[name].shape)}")
    if min(cz, cy, cx) <= CZ:
        raise UnsupportedGeometry("volume too small for the streamed inverse; "
                                  "use the oracle")
    _check_reference_tiles(2 * cz, 2 * cy, 2 * cx, lll.element_size(), strip_z, strip_y)
    tile = _default_tile(tile, lll.element_size())
    _check_tile(tile, lll.element_size(), buffers=2)
    ins = [bands[n] for n in BANDS]
    _check_inputs("streamed_idwt3_level", min(tile), *ins)
    KERNELS["B17"].calls += 1
    if not lll.is_cuda:
        return idwt3_level_streamed_plain(bands, wavelet, tile)
    ins = [b.contiguous() for b in ins]
    out = _empty((2 * cz, 2 * cy, 2 * cx), lll)
    _launch("B17", "dwt3_sinv", lll.dtype, wavelet, True,
            [_band_ptrs(ins), out.data_ptr(), 2 * cz, 2 * cy, 2 * cx, *tile],
            lll.device)
    return out
