"""Fused single-pass 3-D DWT kernels, forward and inverse (port of
``libdwt_tpu.ops.fused3d``).

Each kernel has two versions behind one wrapper, as in
:mod:`libdwt_torch.ops.fused`: a hand-written CUDA kernel
(``csrc/fused3d.cu``) launched for a CUDA tensor, and a plain PyTorch
version, taken only for a CPU tensor and held against the kernel on the
card.  The plain version lifts 3-D tiles with a halo of 4 on every axis;
its values do not depend on the tile.  All borders are whole-point mirror
reads, which for the even dims the kernels take equal the reference's
signal-domain fills (forward) and channel-domain rules (inverse).  Axis
order is x, y, z forward and z, y, x inverse; a float sample is scaled by
its z, then y, then x parity factor.

The CUDA kernels run the column z walk of ``csrc/volwalk.cuh`` (shared
with B16/B17 of :mod:`libdwt_torch.ops.streamed3d`): a block owns a
column of ty x tx samples with a halo of 4 on y and x, walks it down z two
plane pairs a step with the z lifting in registers, and the column is cut
into segments at multiples of tz planes (``tile`` = (tz, ty, tx), default
:data:`TILE3`, for float64 :data:`TILE3_F64`).  Where a tensor map serves
the volume and tile, B14's planes arrive as 3-D tensor boxes (TMA, one a
window plane), else through B16's row copies: :func:`feed_of`, the launch's
choice in :data:`LAST_FEED`.  B15 runs B17's inverse walk on its chunk
copies.  This module holds the Python copy of the kernels' geometry
(:func:`_footprint`, :func:`plan_segments`, :func:`tensor_map`,
:func:`box_coords`) and the walk's default tiles, which
:mod:`libdwt_torch.ops.streamed3d` takes too.

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
           "idwt3_level_plain", "BANDS", "TILE3", "TILE3_F64", "LAST_FEED", "feed_of",
           "kernel_info", "plan_segments", "box_coords", "tensor_map"]

#: the reference's forward z halo (its size minimum: dims > HZ) and
#: inverse channel halo (bands > CZ).
HZ = 4
CZ = 2
#: the port's halo on y and x (signal samples; z's is the walk's two
#: warm-up pairs a side).
HALO = 4
#: csrc/volwalk.cuh: threads a block (forward, inverse), plane pairs a
#: step, steps in the ring, lines of a pass a thread walks, core x samples
#: a forward thread walks down z and window positions an inverse thread
#: walks (both for 4-byte samples; half for float64).
FWD_THREADS, INV_THREADS, STEP, RING, LINES, ZX, NQ = 128, 256, 2, 2, 2, 8, 8
#: default CUDA tile (z, y, x) of the column walk (B14-B17): columns of
#: 32 x 32 samples (40 x 40 windows a plane) cut at multiples of 8 planes,
#: among the fastest tiles swept at both levels of 64x512x512 (PERF.md
#: section 6).
TILE3 = (8, 32, 32)
#: the float64 default: a column of 16 x 32, so that a forward thread's
#: four x samples and an inverse thread's four window positions cover it.
TILE3_F64 = (8, 16, 32)
#: shared memory a block may use on Hopper.
_SMEM_MAX = 227 * 1024
#: where a tensor box lands in shared memory: 128-byte aligned.
_BOX_ALIGN = 128

BANDS = ("LLL", "LLH", "LHL", "LHH", "HLL", "HLH", "HHL", "HHH")

#: the feed of the last B14 launch: 'boxes' (3-D tensor boxes) or
#: 'copies'.
LAST_FEED: Dict[str, str] = {}

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


# ------------------------------------------------ the column walk's geometry


def _stride(n: int) -> int:
    """csrc/lines.cuh ``lines::stride``: n or n + 2, whichever is 2 mod 4."""
    return n if n % 4 else n + 2


def _stride16(n: int) -> int:
    """The forward's window rows (csrc/volwalk.cuh ``geometry``): n
    rounded up to 4 mod 8, so that each row starts 16-byte aligned."""
    return (-(-n // 4) * 4) | 4


def _mirror(p: int, n: int) -> int:
    """csrc/lifting.cuh ``mirror_idx``: the whole-point mirror of p in
    [0, n)."""
    period = 2 * n - 2
    p %= period
    return p if p < n else period - p


def _threads_fit(tile, itemsize: int, inverse: bool) -> bool:
    """Whether every pass line and z chunk of the column walk has a thread
    (csrc/volwalk.cuh ``geometry``)."""
    _, ty, tx = tile
    zx, nq = ZX * 4 // itemsize, NQ * 4 // itemsize
    ey, ex, planes = ty + 2 * HALO, tx + 2 * HALO, 2 * STEP
    if not inverse:
        return planes * ey <= LINES * FWD_THREADS and planes * tx <= LINES * FWD_THREADS \
            and ty * _cdiv(tx, zx) <= FWD_THREADS
    return planes * ex <= LINES * INV_THREADS and planes * ty <= LINES * INV_THREADS \
        and ex <= INV_THREADS and _cdiv(ey, INV_THREADS // ex) <= nq


def _footprint(tile, itemsize: int, inverse: bool):
    """(shared memory in bytes, whether every pass line and z chunk has a
    thread) of the column walk on ``tile`` (csrc/volwalk.cuh ``geometry``):
    the forward's ring of window planes and one barrier a slot (8 bytes);
    the inverse's ring of planes split into x halves (each half from LEAD
    samples before its first, rounded up to 16 bytes), then its plane pairs
    out of z."""
    _, ty, tx = tile
    ey, ex, planes = ty + 2 * HALO, tx + 2 * HALO, 2 * STEP
    fits = _threads_fit(tile, itemsize, inverse)
    if not inverse:
        return itemsize * RING * planes * ey * _stride16(ex) + 8 * RING, fits
    v = 16 // itemsize
    lead = (v - 2 % v) % v  # csrc/volwalk.cuh Cfg::LEAD
    rsi = 2 * _cdiv(lead + ex // 2, v) * v
    return itemsize * (RING * planes * ey * rsi + planes * ey * _stride(ex)), fits


def _default_tile(tile, itemsize: int):
    """``tile``, or the default tile for samples of ``itemsize`` bytes."""
    if tile is not None:
        return tile
    return TILE3_F64 if itemsize > 4 else TILE3


def _check_tile(tile, itemsize: int, inverse: bool) -> None:
    """The CUDA tile: three positive even sizes whose column walk fits the
    kernel's shared memory and threads."""
    if len(tile) != 3 or any(t <= 0 or t % 2 for t in tile):
        raise ValueError("tile must be three positive even sizes (z, y, x)")
    smem, fits = _footprint(tile, itemsize, inverse)
    what = "B15" if inverse else "B14"
    if smem > _SMEM_MAX:
        raise ValueError(f"{what} on tile {tuple(tile)} needs {smem} bytes of shared "
                         f"memory, more than {_SMEM_MAX}")
    if not fits:
        raise ValueError(f"tile {tuple(tile)} is too wide for {what}'s threads "
                         "(csrc/volwalk.cuh geometry)")


def feed_of(shape3, tile, itemsize: int) -> str:
    """The feed B14 (csrc/fused3d.cu) takes for a (Z, Y, X) volume at
    16-byte aligned addresses on ``tile``: 'boxes' where a tensor map serves
    it, else 'copies' (B16's row feed).  A box must start 16-byte aligned in
    its row: rows (X) and column starts (x0 - 4, x0 a multiple of tx) of
    16-byte multiples, and window planes of 128-byte multiples."""
    x, (_, ty, tx), v = shape3[2], tile, 16 // itemsize
    plane = (ty + 2 * HALO) * _stride16(tx + 2 * HALO) * itemsize
    return "boxes" if x % v == 0 and tx % v == 0 and plane % _BOX_ALIGN == 0 else "copies"


def tensor_map(shape3, tile, itemsize: int):
    """The tensor map B14 (csrc/fused3d.cu) encodes where :func:`feed_of` is
    'boxes': dims (innermost first), strides in bytes, box, the boxes and
    bytes of a full step, and where they land (samples from the slot's
    start, in issue order)."""
    z, y, x = shape3
    ey, rs = tile[1] + 2 * HALO, _stride16(tile[2] + 2 * HALO)
    dims, box = (x, y, z), (rs, ey, 1)
    dst = [pl * ey * rs for pl in range(2 * STEP)]
    return {"dims": dims, "strides": (dims[0] * itemsize, dims[0] * dims[1] * itemsize),
            "box": box, "boxes": len(dst), "bytes": len(dst) * box[0] * box[1] * itemsize,
            "dst": dst}


def plan_segments(shape3, tile, slots: int):
    """The work items of csrc/volwalk.cuh ``plan`` for ``slots``
    co-resident blocks: [(x0, y0, first plane, end plane)], column-fastest.
    Each column is cut at multiples of tz planes into as many segments as
    fill the slots (at least one a column); a segment also reads the
    two plane pairs past each of its ends (mirrored at the volume's)."""
    z, y, x = shape3
    tz, ty, tx = tile
    nx, ny, nz = _cdiv(x, tx), _cdiv(y, ty), _cdiv(z, tz)
    nseg = max(1, min(nz, slots // (nx * ny)))
    sps = _cdiv(nz, nseg)
    nseg = _cdiv(nz, sps)
    items = []
    for item in range(nx * ny * nseg):
        col, seg = item % (nx * ny), item // (nx * ny)
        first, last = seg * sps, min(nz, seg * sps + sps)
        items.append(((col % nx) * tx, (col // nx) * ty, first * tz,
                      min(z, last * tz)))
    return items


def box_coords(shape3, item, st: int):
    """The (x, y, z) coordinates of the tensor boxes, one a window plane,
    that B14's step ``st`` of work ``item`` = (x0, y0, first plane, end
    plane) of :func:`plan_segments` issues, in issue order: a segment walks
    its core pairs and two warm-up pairs a side, STEP pairs a step, and a
    plane's z is mirrored where its box is issued."""
    z = shape3[0]
    x0, y0, first, end = item
    k0, n = first // 2 - 2, (end - first) // 2 + 4
    pairs = max(0, min(STEP, n - STEP * st))
    z0 = 2 * (k0 + STEP * st)
    return [(x0 - HALO, y0 - HALO, _mirror(z0 + pl, z)) for pl in range(2 * pairs)]


def kernel_info(dtype, wavelet="cdf97", inverse: bool = False, tile=None,
                shape3=(64, 512, 512)) -> Dict:
    """Registers, blocks an SM, shared memory, threads and feed ('copies'
    for B15) of the CUDA kernel that B14 (or, ``inverse``, B15) runs for
    ``dtype`` and ``wavelet`` on ``tile`` for a ``shape3`` volume at aligned
    addresses: the card's own figures, for measurement."""
    from libdwt_torch.ops import _cuda
    from libdwt_torch.ops.fused import _lift_params, _suffix

    wavelet = get_wavelet(wavelet)
    tile = _default_tile(tile, torch.empty((), dtype=dtype).element_size())
    out = (ctypes.c_int * 5)()
    params = _lift_params(wavelet, dtype == torch.int32, inverse)
    _cuda.check(_cuda.kernel_fn("dwt3_finfo", _suffix(dtype))(
        int(inverse), *shape3, *tile, ctypes.byref(params), out), "dwt3_finfo")
    info = dict(zip(("registers", "blocks_per_sm", "smem", "threads"), out))
    info["feed"] = "boxes" if out[4] else "copies"
    return info


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
    an even-sized volume -> dict of the 8 bands, lifted on 3-D tiles of
    ``tile`` core samples with a halo of 4 on every axis (any tile gives
    the same bits)."""
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
                     approach: str = "interleaved", tile=None):
    """Single-level fused 3-D forward DWT (B14) -> dict of 8 subbands keyed
    'LLL'..'HHH' in (z, y, x) order: the values of the separable
    ``dwt3_level`` (floats to rounding, integers bit-exactly).

    Requires even (z, y, x) dims > HZ and a symmetric-step wavelet, else
    raises :class:`UnsupportedGeometry` or ValueError as the reference
    does.  ``approach`` ('interleaved' or 'poly') and ``strip_z``/
    ``strip_y`` keep the reference's signature and checks: the TPU kernel
    had two float engines and a (z, y) strip grid, which were choices of
    its VMEM layout; here both approaches run the one CUDA kernel on
    columns of ``tile`` = (tz, ty, tx): ty x tx samples cut into segments at
    multiples of tz planes (default :data:`TILE3`, for float64
    :data:`TILE3_F64`).
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
    tile = _default_tile(tile, x.element_size())
    _check_tile(tile, x.element_size(), inverse=False)
    _check_inputs("fused_dwt3_level", min(tile), x)
    KERNELS["B14"].calls += 1
    if not x.is_cuda:
        return dwt3_level_plain(x, wavelet, tile)
    x = x.contiguous()
    z, y, w = x.shape
    out = [_empty((z // 2, y // 2, w // 2), x) for _ in BANDS]
    feed = (ctypes.c_int * 1)()
    _launch("B14", "dwt3_fwd", x.dtype, wavelet, False,
            [x.data_ptr(), _band_ptrs(out), z, y, w, *tile, feed], x.device)
    LAST_FEED["B14"] = "boxes" if feed[0] else "copies"
    return dict(zip(BANDS, out))


def fused_idwt3_level(bands: Dict[str, torch.Tensor], wavelet="cdf97",
                      strip_z: int = 0, strip_y: int = 0,
                      approach: str = "interleaved", tile=None):
    """Single-level fused 3-D inverse DWT (B15), the inverse of
    :func:`fused_dwt3_level`, on the same columns.  All 8 bands must share
    one shape (else ValueError); bands of <= CZ samples on an axis raise
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
    tile = _default_tile(tile, lll.element_size())
    _check_tile(tile, lll.element_size(), inverse=True)
    ins = [bands[n] for n in BANDS]
    _check_inputs("fused_idwt3_level", min(tile), *ins)
    KERNELS["B15"].calls += 1
    if not lll.is_cuda:
        return idwt3_level_plain(bands, wavelet, tile)
    ins = [b.contiguous() for b in ins]
    out = _empty((2 * cz, 2 * cy, 2 * cx), lll)
    _launch("B15", "dwt3_inv", lll.dtype, wavelet, True,
            [_band_ptrs(ins), out.data_ptr(), 2 * cz, 2 * cy, 2 * cx, *tile], lll.device)
    return out
