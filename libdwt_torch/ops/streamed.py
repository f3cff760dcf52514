"""Streamed 2-D kernels and the streamed pyramid (port of
``libdwt_tpu.ops.streamed``).

The JAX kernels stream full-width strips of ``strip_rows`` rows through two
VMEM buffers with explicit async copies.  The CUDA kernels
(``csrc/streamed.cu``) keep the semantics, not the TPU tiling: the frame
is cut into column bands of ``tx`` samples and strips of ``ty`` rows.  A
single level takes one strip a block; the two-level kernels and the
pyramids walk a column band down the frame in a persistent block, strip
i+1's load in flight while strip i lifts.  ``strip_rows`` is validated exactly as the
reference validates it (:func:`pick_strip`, the 2..32 strip range, the
window checks), so the port raises ``ValueError`` on the same geometries,
but it does not size the CUDA strip.

Ported kernels (TPU kernel ids of ROADMAP section B):
  B7  streamed_dwt2_level     -> csrc/streamed.cu dwt_sfwd1_* (one strip a
                                 block on B1's body, csrc/onelevel.cuh,
                                 with the 8-row extended contract: == B1
                                 bit for bit; strip sides <= 248)
  B9  streamed_idwt2_level    -> csrc/streamed.cu dwt_sinv1_* (B4's body:
                                 == B4)
  B8  streamed_dwt2_2level    -> csrc/streamed.cu dwt_sfwd2_* (the strip
                                 phase of B11 alone, on B2's line-walk
                                 body: == B2 bit for bit)
  B10 streamed_idwt2_2level   -> csrc/streamed.cu dwt_sinv2_* (B12's strip
                                 phase alone, on B5's body: == B5)
  B11 streamed_wavedec2_deep  -> csrc/streamed.cu dwt_sdeep_fwd_* (one
                                 cooperative launch: strips, then the deep
                                 levels on an L2-resident LL2)
  B12 streamed_waverec2_deep  -> csrc/streamed.cu dwt_sdeep_inv_*
  B13 banded.apply_packed     -> csrc/banded.cuh, the ``body='mxu'`` strip
                                 body of B8/B10/B11/B12 (dwt_*_mxu_f32)
Each wrapper launches its kernel for a CUDA tensor (or raises) and runs
its plain version, with the same strip and tile decomposition, for a CPU
tensor.  ``body='mxu'`` (float32, symmetric-step wavelets) lifts the
strips with the banded-matmul body of :mod:`libdwt_torch.ops.banded`; the
deep levels of B11/B12 stay polyphase, as in the reference.  The
inverse's ``'auto'`` resolves to ``'poly'`` at every size (see
:func:`_resolve_inv_body`).

Under a :func:`libdwt_torch.utils.trace.recording` the wrappers record
spans ``kernel.<id>`` (B7-B12; an 'mxu' body's B13 runs inside its
kernel's), each launch a ``kernel.launch``, and the pyramids
``streamed.wavedec2`` / ``streamed.waverec2``.
"""
from __future__ import annotations

import ctypes

import torch

from libdwt_torch.models.wavelets import get_wavelet
from libdwt_torch.ops import banded
from libdwt_torch.ops.banded import mxu_supported
from libdwt_torch.ops.fused import (CFIX, CH, HALO, HALO2, KERNELS, TILE1,
                                    _DEEP_VMEM_LIMIT, KernelStat,
                                    _check_boundary_rows, _check_fused_supported,
                                    _check_inputs, _empty, _launch, _ptrs,
                                    dwt2_2level_tiles, dwt2_level_tiles,
                                    fused_deep_wavedec2_plain,
                                    fused_deep_waverec2_plain, fused_supported,
                                    fused_wavedec2, fused_waverec2,
                                    idwt2_2level_tiles, idwt2_level_tiles)
from libdwt_torch.utils import trace as _trace

__all__ = [
    "streamed_supported", "streamed_deep_ok", "mxu_supported", "streamed_dwt2_level",
    "streamed_idwt2_level", "streamed_dwt2_2level", "streamed_idwt2_2level",
    "streamed_wavedec2_deep", "streamed_waverec2_deep", "streamed_wavedec2",
    "streamed_waverec2", "pick_strip", "tail_aligned",
]

#: top halo rows of the reference's strip windows (image/band row i*stride
#: sits at window row TOP); also the depth of the single levels'
#: boundary_rows='extended' contract.
TOP = 8
#: the reference's channel-domain mirror depth of the single levels.
CMIR = 4
#: the reference's forward two-level strip halo; also the row halo of the
#: banded body's CUDA forward strips (the polyphase ones take B2's HALO2).
TOP2 = 16
#: the reference's unrolled-strip budget.
MAX_STRIPS = 32
#: the CUDA strips: ty rows of a column band of tx samples (both % 4 == 0).
STRIP_TY = 64
STRIP_TX = 64
#: the banded body's (B13) square strip: its (96 + 32) x (96 + 24) level-1
#: window is 8 blocks of 16 lines each way, one for each warp of a block
#: (the fastest of the strips from 64 to 128 that
#: tools/streamed_strip_sweep.py --mxu times).
MXU_STRIP = 96

KERNELS.update({
    "B7": KernelStat("B7", "streamed_dwt2_level", "libdwt_torch/csrc/streamed.cu",
                     "libdwt_tpu/ops/streamed.py:257"),
    "B9": KernelStat("B9", "streamed_idwt2_level", "libdwt_torch/csrc/streamed.cu",
                     "libdwt_tpu/ops/streamed.py:535"),
    "B8": KernelStat("B8", "streamed_dwt2_2level", "libdwt_torch/csrc/streamed.cu",
                     "libdwt_tpu/ops/streamed.py:369"),
    "B10": KernelStat("B10", "streamed_idwt2_2level", "libdwt_torch/csrc/streamed.cu",
                      "libdwt_tpu/ops/streamed.py:651"),
    "B11": KernelStat("B11", "streamed_wavedec2_deep", "libdwt_torch/csrc/streamed.cu",
                      "libdwt_tpu/ops/streamed.py:924"),
    "B12": KernelStat("B12", "streamed_waverec2_deep", "libdwt_torch/csrc/streamed.cu",
                      "libdwt_tpu/ops/streamed.py:1154"),
    # counts every launch that runs the banded body; the host kernel (B8,
    # B10, B11 or B12) counts the same launch too
    "B13": KernelStat("B13", "banded_apply_packed", "libdwt_torch/csrc/banded.cuh",
                      "libdwt_tpu/ops/banded.py:389"),
})

#: (grid, co-resident blocks) of the last cooperative launch of B11 / B12.
LAST_GRID: dict = {}


# ------------------------------------------------------------ geometry


def pick_strip(h: int, preferred: int = 256) -> int:
    """Strip rows: the preferred size, shrunk so the image still splits
    into >= 2 strips, 32-aligned (the preference is rounded down too)."""
    preferred = max(64, (preferred // 32) * 32)
    ty = min(preferred, ((h // 2) // 32) * 32)
    return max(64, ty)


def strip_shape(body: str = "poly", ty: int = 0, tx: int = 0):
    """The CUDA strip of a two-level streamed kernel: ty x tx where given
    (non-zero), else its body's default: STRIP_TY x STRIP_TX, or
    MXU_STRIP square for the banded body."""
    if body == "mxu":
        return ty or MXU_STRIP, tx or MXU_STRIP
    return ty or STRIP_TY, tx or STRIP_TX


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"streamed kernel geometry: {msg}")


def _strip_geom(i: int, total: int, stride: int, top: int = TOP, origin: int = 0):
    """(want_lo, src_start, length, buf_offset) of strip ``i``'s window
    over a band of ``total`` rows walked ``stride`` rows per strip with a
    ``top``-row halo above and below, as the reference's DMA takes it."""
    want_lo = i * stride - top + origin
    s = max(want_lo, 0)
    e = min(i * stride + stride + top + origin, total)
    return want_lo, s, e - s, s - want_lo


def _tail_fits(i: int, total: int, stride: int, tyw: int, fix: int, top: int = TOP,
               what: str = "tail mirror") -> None:
    """The reference's in-kernel check that strip ``i``'s tail mirror of
    depth ``fix`` stays inside its ``tyw``-row window."""
    if i * stride + stride + fix > total:
        er = (total - 1) - _strip_geom(i, total, stride, top)[0]
        _require(er + fix <= tyw - 1,
                 f"strip {i}: {what} past buffer (er={er}, tyw={tyw})")


def _tail_rem(h: int, ty: int) -> int:
    """Rows of the last strip."""
    return h - (-(-h // ty) - 1) * ty


def tail_aligned(h: int, ty: int) -> bool:
    """The reference's compiled-path gate: the last strip's rem, rem/2 and
    rem/4 row DMA slices must be 8-aligned, so rem % 32 == 0.  CUDA has no
    such constraint; the port keeps the gate so that dispatch refuses the
    same geometries."""
    return _tail_rem(h, ty) % 32 == 0


def streamed_supported(shape, wavelet, strip_rows: int, levels: int = 1) -> bool:
    """Geometry gate: even dims (divisible by 4 for the 2-level pair), 2..32
    strips, a 32-aligned last strip, a symmetric-step wavelet."""
    h, w = shape
    div = 4 if levels == 2 else 2
    if h % div or w % div or not fused_supported(wavelet):
        return False
    ty = pick_strip(h, strip_rows or 256)
    ny = -(-h // ty)
    if not (2 <= ny <= MAX_STRIPS and h > ty + 48 and tail_aligned(h, ty)):
        return False
    # the 2-level inverse also needs its quarter-resolution windows to fit
    return levels == 1 or h // 4 > ty // 4 + 24


def streamed_deep_ok(shape, dtype_itemsize: int, wavelet, level: int,
                     strip_rows: int = 0) -> bool:
    """Gate of :func:`streamed_wavedec2_deep`: the 2-level gate, level >= 3,
    LL2 within the reference's resident-image limit, and enough samples
    for the deep levels."""
    h, w = shape
    if level < 3 or not streamed_supported(shape, wavelet, strip_rows, 2):
        return False
    qh, qw = h // 4, w // 4
    if (qh + 8) * (qw + 8) * dtype_itemsize > _DEEP_VMEM_LIMIT:
        return False
    return min(qh, qw) >> (level - 3) > 2 * HALO


def _check_body(body: str, wavelet, dtype) -> None:
    """The reference's body checks, in its order and with its error class:
    'mxu' needs float32 and a symmetric-step wavelet; anything but 'poly'
    or 'mxu' is unknown."""
    if body == "mxu":
        if not mxu_supported(wavelet, dtype):
            raise ValueError("body='mxu' needs a float32 symmetric wavelet")
    elif body != "poly":
        raise ValueError(f"unknown kernel body {body!r}")


def _resolve_inv_body(body: str, wavelet, dtype) -> str:
    """Inverse body choice.  ``'auto'`` is ``'poly'`` at every size; an
    explicit 'poly' or 'mxu' is checked and kept.  The reference's own rule
    keeps its exact polyphase body wherever it compiles and takes the
    banded body only where its TPU compiler cannot build the polyphase
    synthesis (above 6 Mpix, float32).  CUDA builds the polyphase body at
    every size, so the same rule gives 'poly' here, and the port's streamed
    inverse rounds like poly (about 1e-6) by default.  The banded body
    (B13) runs where a caller names it: ``body='mxu'`` or
    ``impl='streamed-mxu'``."""
    if body == "auto":
        return "poly"
    _check_body(body, wavelet, dtype)
    return body


def _check_tile(ty: int, tx: int) -> None:
    if ty <= 0 or tx <= 0 or ty % 4 or tx % 4:
        raise ValueError("the CUDA strip (ty, tx) must be positive multiples of 4")


def _fwd1_geometry(h: int, strip_rows: int, ext: bool) -> None:
    """The reference's checks of a single forward strip walk (B7); the
    tail mirror exists only without the caller's row extension."""
    ty = pick_strip(h, strip_rows or 256)
    ny = -(-h // ty)
    rem = h - (ny - 1) * ty
    tyw = ty + 2 * TOP + (8 if 0 < rem < TOP else 0)
    if h <= tyw or ny < 2 or ny > MAX_STRIPS:
        raise ValueError("geometry outside the streamed kernel's range")
    if not ext:
        for i in range(ny):
            _tail_fits(i, h, ty, tyw, HALO)


def _inv1_geometry(cy: int, strip_rows: int, ext: bool) -> None:
    """The reference's checks of a single inverse strip walk (B9) over
    bands of ``cy`` channel rows."""
    ty = pick_strip(2 * cy, strip_rows or 256)
    ny = -(-(2 * cy) // ty)
    hy = ty // 2
    tyw = hy + 2 * TOP
    if cy <= tyw or ny < 2 or ny > MAX_STRIPS:
        raise ValueError("geometry outside the streamed kernel's range")
    if not ext:
        for i in range(ny):
            _tail_fits(i, cy, hy, tyw, CMIR)


def _fwd2_geometry(h: int, strip_rows: int) -> None:
    """The reference's checks of a 2-level forward strip walk (B8, B11)."""
    ty = pick_strip(h, strip_rows or 256)
    ny = -(-h // ty)
    rem = h - (ny - 1) * ty
    tyw = ty + 2 * TOP2 + (16 if 0 < rem < TOP2 else 0)
    if h <= tyw or ny < 2 or ny > MAX_STRIPS:
        raise ValueError("geometry outside the streamed kernel's range")
    for i in range(ny):
        want_lo = i * ty - TOP2
        _tail_fits(i, h, ty, tyw, HALO2, TOP2)
        if want_lo + tyw > h:
            _require(h // 2 - 1 - want_lo // 2 + HALO2 // 2 <= tyw // 2 - 1,
                     f"strip {i}: LL tail mirror past buffer")


def _inv2_geometry(h: int, strip_rows: int, deep: bool) -> None:
    """The reference's checks of a 2-level inverse strip walk (B10, B12).
    Every band of one resolution gets the same tail check, and the LL1
    tail check equals the half-resolution bands' one."""
    ty = pick_strip(h, strip_rows or 256)
    ny = -(-h // ty)
    hy, qy = ty // 2, ty // 4
    cy1, cy2 = h // 2, h // 4
    remh, remq = cy1 - (ny - 1) * hy, cy2 - (ny - 1) * qy
    tyw_h = hy + 2 * TOP + (8 if 0 < remh < CFIX else 0)
    tyw_q = qy + 2 * TOP + (8 if 0 < remq < CFIX else 0)
    if ny < 2 or ny > MAX_STRIPS or (not deep and (cy1 <= tyw_h or cy2 <= tyw_q)):
        raise ValueError("geometry outside the streamed kernel's range")
    for i in range(ny):
        _tail_fits(i, cy2, qy, tyw_q, CFIX)
        _tail_fits(i, cy1, hy, tyw_h, CFIX)


# ------------------------------------------------------------ plain versions


def streamed_dwt2_level_plain(x, wavelet="cdf97", ty: int = STRIP_TY,
                              tx: int = STRIP_TX, ext: int = 0):
    """Plain version of B7: the strips of ty x tx samples with a halo of
    HALO on both axes; ``ext`` rows of caller extension (0 or TOP)."""
    return dwt2_level_tiles(x, wavelet, ty, tx, ext)


def streamed_idwt2_level_plain(ll, hl, lh, hh, wavelet="cdf97", ty: int = STRIP_TY,
                               tx: int = STRIP_TX, ext: int = 0):
    """Plain version of B9; ``ext`` channel rows of caller extension."""
    return idwt2_level_tiles(ll, hl, lh, hh, wavelet, ty, tx, ext)


def _window_lift(wavelet, body: str, inverse: bool):
    """The strips' 2-D window lift of a plain version: None (the polyphase
    steps) or the banded body's plain version."""
    if body != "mxu":
        return None
    fn = banded.synthesis2d_packed if inverse else banded.analysis2d_packed
    return lambda t: fn(t, wavelet)


def streamed_dwt2_2level_plain(x, wavelet="cdf97", ty: int = 0, tx: int = 0,
                               body: str = "poly"):
    """Plain version of B8: the strips of ty x tx samples (0: the body's
    default, :func:`strip_shape`) with the reference's TOP2-row and
    HALO2-column halos; ``body='mxu'`` lifts them with the banded body
    (B13).  The polyphase values do not depend on the strip or the row
    halo, so they equal B2's plain version, whose HALO2 rows the CUDA
    strips take."""
    ty, tx = strip_shape(body, ty, tx)
    return dwt2_2level_tiles(x, wavelet, ty, tx, TOP2, _window_lift(wavelet, body, False))


def streamed_idwt2_2level_plain(ll2, bands2, bands1, wavelet="cdf97", ty: int = 0,
                                tx: int = 0, body: str = "poly"):
    """Plain version of B10 (``ty``, ``tx`` and ``body`` as in B8's)."""
    ty, tx = strip_shape(body, ty, tx)
    return idwt2_2level_tiles(ll2, bands2, bands1, wavelet, ty, tx,
                              _window_lift(wavelet, body, True))


def streamed_wavedec2_deep_plain(x, wavelet="cdf97", level: int = 3, ty: int = 0,
                                 tx: int = 0, tile: int = TILE1, body: str = "poly"):
    """Plain version of B11: B8's strips, then the per-level tiles of the
    deep levels on LL2 (polyphase whatever the strips' body)."""
    ll2, b2, b1 = streamed_dwt2_2level_plain(x, wavelet, ty, tx, body)
    return fused_deep_wavedec2_plain(ll2, wavelet, level - 2, tile) + [b2, b1]


def streamed_waverec2_deep_plain(coeffs, wavelet="cdf97", ty: int = 0, tx: int = 0,
                                 tile: int = TILE1, body: str = "poly"):
    """Plain version of B12: the deep inverse levels up to LL2, then B10's
    strips."""
    ll2 = fused_deep_waverec2_plain(list(coeffs[:-2]), wavelet, tile)
    return streamed_idwt2_2level_plain(ll2, coeffs[-2], coeffs[-1], wavelet, ty, tx, body)


# ------------------------------------------------------------ CUDA launches


def _launch_body(kid: str, fn_name: str, dtype, wavelet, inverse, args, device,
                 body: str, ty: int, tx: int) -> None:
    """Launch a two-level strip kernel with its body: 'poly', or 'mxu' (the
    ``_mxu`` entry point with the banded matrices of this wavelet, direction
    and strip; counted under B13 as well as ``kid``)."""
    if body != "mxu":
        _launch(kid, fn_name, dtype, wavelet, inverse, args, device)
        return
    mats = banded.kernel_mats(wavelet, inverse, ty, tx, device)
    _launch(kid, fn_name + "_mxu", dtype, wavelet, inverse, args, device,
            extra=[ctypes.byref(mats)])
    KERNELS["B13"].launches += 1


def _launch_coop(kid: str, fn_name: str, dtype, wavelet, inverse, first, ptrs,
                 args, device, body: str, ty: int, tx: int) -> None:
    """A cooperative launch: ``first`` (the frame in or out), then ``ptrs``
    as a host pointer array; the grid it ran and the co-resident limit
    land in LAST_GRID[kid]."""
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    info = (ctypes.c_int * 2)()
    _launch_body(kid, fn_name, dtype, wavelet, inverse, [first, arr] + args + [info],
                 device, body, ty, tx)
    LAST_GRID[kid] = (info[0], info[1])


def strip_kernel_info(dtype, wavelet="cdf97", inverse: bool = False, shape=(2144, 4096),
                      ty: int = 0, tx: int = 0) -> dict:
    """Registers, blocks an SM, grid and shared memory of the CUDA kernel
    that B8 (or, ``inverse``, B10) runs with the polyphase body for
    ``dtype`` and ``wavelet`` on an h x w ``shape`` with the strip ty x tx
    (0: the default): the card's own figures, for measurement."""
    from libdwt_torch.ops import _cuda
    from libdwt_torch.ops.fused import _lift_params, _suffix

    ty, tx = strip_shape("poly", ty, tx)
    out = (ctypes.c_int * 4)()
    params = _lift_params(get_wavelet(wavelet), dtype == torch.int32, inverse)
    _cuda.check(_cuda.kernel_fn("dwt_s2info", _suffix(dtype))(
        int(inverse), *shape, ty, tx, ctypes.byref(params), out), "dwt_s2info")
    return dict(zip(("registers", "blocks_per_sm", "grid", "smem"), out))


def level_kernel_info(dtype, wavelet="cdf97", inverse: bool = False, shape=(2144, 4096),
                      ty: int = STRIP_TY, tx: int = STRIP_TX, ext: int = 0) -> dict:
    """Registers, blocks an SM, grid and shared memory of the CUDA kernel
    that B7 (or, ``inverse``, B9) runs for ``dtype`` and ``wavelet`` on an
    h x w ``shape`` (without the extension) with the strip ty x tx and
    ``ext`` extension rows (0 or TOP): the card's own figures, for
    measurement."""
    from libdwt_torch.ops import _cuda
    from libdwt_torch.ops.fused import _lift_params, _suffix

    out = (ctypes.c_int * 4)()
    params = _lift_params(get_wavelet(wavelet), dtype == torch.int32, inverse)
    _cuda.check(_cuda.kernel_fn("dwt_s1info", _suffix(dtype))(
        int(inverse), *shape, ty, tx, ext, ctypes.byref(params), out), "dwt_s1info")
    return dict(zip(("registers", "blocks_per_sm", "grid", "smem"), out))


def _count(kids, body: str) -> None:
    """Count a wrapper call on either device (and B13's, for the banded
    body)."""
    for kid in kids + (("B13",) if body == "mxu" else ()):
        KERNELS[kid].calls += 1


def _deep_shapes(cy2: int, cx2: int, n: int):
    """LL shapes below LL2, one per deep level (ceil halving)."""
    out = []
    for _ in range(n):
        cy2, cx2 = -(-cy2 // 2), -(-cx2 // 2)
        out.append((cy2, cx2))
    return out


# ------------------------------------------------------------ kernel wrappers


def streamed_dwt2_level(x, wavelet="cdf97", strip_rows: int = 0,
                        boundary_rows: str = "mirror", ty: int = STRIP_TY,
                        tx: int = STRIP_TX):
    """ONE forward level over streamed strips (B7) -> (LL, HL, LH, HH), the
    values of the separable ``dwt2_level``; even h, w.

    ``boundary_rows='extended'``: the caller supplies TOP = 8 valid rows
    above and below the image (x has h + 16 rows, the sharded callers'
    contract), read with no row mirror; columns still mirror.  ``h`` is
    taken from the shape, so a wrong extension depth is not detected (as
    in the reference).  ``strip_rows`` is validated as the reference
    validates it; the CUDA strip is ``ty`` x ``tx`` (multiples of 4; the
    kernel refuses a side over 248, whose window lines outgrow its block,
    and the wrapper raises ``RuntimeError``)."""
    with _trace.span("kernel.B7"):
        wavelet = get_wavelet(wavelet)
        _check_fused_supported(wavelet)
        if x.ndim != 2:
            raise ValueError("streamed_dwt2_level takes one 2-D image; loop batches")
        ext = _check_boundary_rows(boundary_rows)
        e = TOP if ext else 0
        h, w = x.shape[0] - 2 * e, x.shape[1]
        if h % 2 or w % 2:
            raise ValueError("streamed kernel needs even dims; use the oracle")
        _fwd1_geometry(h, strip_rows, ext)
        _check_tile(ty, tx)
        _check_inputs("streamed_dwt2_level", ty, x)
        KERNELS["B7"].calls += 1
        if not x.is_cuda:
            return streamed_dwt2_level_plain(x, wavelet, ty, tx, e)
        x = x.contiguous()
        out = [_empty((h // 2, w // 2), x) for _ in range(4)]
        _launch("B7", "dwt_sfwd1", x.dtype, wavelet, False,
                _ptrs(x, *out) + [h, w, ty, tx, e], x.device)
        return tuple(out)


def streamed_idwt2_level(ll, hl, lh, hh, wavelet="cdf97", strip_rows: int = 0,
                         boundary_rows: str = "mirror", ty: int = STRIP_TY,
                         tx: int = STRIP_TX):
    """ONE inverse level over streamed strips (B9), the inverse of
    :func:`streamed_dwt2_level`; the four bands must share one shape.

    ``boundary_rows='extended'``: every band carries TOP = 8 valid channel
    rows above and below, read with no row mirror.  The CUDA strip is
    ``ty`` x ``tx`` output samples, as in the forward."""
    with _trace.span("kernel.B9"):
        wavelet = get_wavelet(wavelet)
        _check_fused_supported(wavelet)
        ext = _check_boundary_rows(boundary_rows)
        e = TOP if ext else 0
        if ll.ndim != 2:
            raise ValueError("streamed_idwt2_level takes the four 2-D bands of one "
                             "level; loop batches")
        for name, band in (("hl", hl), ("lh", lh), ("hh", hh)):
            if band.shape != ll.shape:
                raise ValueError(
                    f"streamed inverse needs equal band shapes (even dims): "
                    f"ll={tuple(ll.shape)} vs {name}={tuple(band.shape)}; use the oracle")
        cy, cx = ll.shape[0] - 2 * e, ll.shape[1]
        _inv1_geometry(cy, strip_rows, ext)
        _check_tile(ty, tx)
        _check_inputs("streamed_idwt2_level", ty, ll, hl, lh, hh)
        KERNELS["B9"].calls += 1
        if not ll.is_cuda:
            return streamed_idwt2_level_plain(ll, hl, lh, hh, wavelet, ty, tx, e)
        ins = [b.contiguous() for b in (ll, hl, lh, hh)]
        out = _empty((2 * cy, 2 * cx), ll)
        _launch("B9", "dwt_sinv1", ll.dtype, wavelet, True,
                _ptrs(*ins, out) + [2 * cy, 2 * cx, ty, tx, e], ll.device)
        return out


def streamed_dwt2_2level(x, wavelet="cdf97", strip_rows: int = 0, body: str = "poly",
                         ty: int = 0, tx: int = 0):
    """TWO forward levels in one streamed pass (B8).  Returns (LL2, (HL2,
    LH2, HH2), (HL1, LH1, HH1)); needs h, w divisible by 4.  Ragged last
    strips are taken, as the reference takes them in interpret mode.
    ``body='mxu'``: the strips lift with the banded-matmul body (B13;
    float32, bf16-split, about 1e-5 from the polyphase body).  The CUDA
    strip is ty x tx, or the body's default (:func:`strip_shape`)."""
    with _trace.span("kernel.B8"):
        wavelet = get_wavelet(wavelet)
        _check_fused_supported(wavelet)
        if x.ndim != 2:
            raise ValueError("streamed_dwt2_2level takes one 2-D image")
        h, w = x.shape
        if h % 4 or w % 4:
            raise ValueError("needs h, w divisible by 4")
        _check_body(body, wavelet, x.dtype)
        _fwd2_geometry(h, strip_rows)
        ty, tx = strip_shape(body, ty, tx)
        _check_tile(ty, tx)
        _check_inputs("streamed_dwt2_2level", ty, x)
        _count(("B8",), body)
        if not x.is_cuda:
            return streamed_dwt2_2level_plain(x, wavelet, ty, tx, body)
        x = x.contiguous()
        q = [_empty((h // 4, w // 4), x) for _ in range(4)]
        b = [_empty((h // 2, w // 2), x) for _ in range(3)]
        _launch_body("B8", "dwt_sfwd2", x.dtype, wavelet, False,
                     _ptrs(x, *q, *b) + [h, w, ty, tx], x.device, body, ty, tx)
        return q[0], (q[1], q[2], q[3]), (b[0], b[1], b[2])


def streamed_idwt2_2level(ll2, bands2, bands1, wavelet="cdf97", strip_rows: int = 0,
                          body: str = "auto", ty: int = 0, tx: int = 0):
    """TWO reconstruction levels in one streamed pass (B10), the inverse of
    :func:`streamed_dwt2_2level`."""
    with _trace.span("kernel.B10"):
        wavelet = get_wavelet(wavelet)
        _check_fused_supported(wavelet)
        hl1, lh1, hh1 = bands1
        h, w = hl1.shape[-2] + lh1.shape[-2], hl1.shape[-1] + lh1.shape[-1]
        if h % 4 or w % 4:
            raise ValueError("needs h, w divisible by 4")
        body = _resolve_inv_body(body, wavelet, ll2.dtype)
        ins = [ll2, *bands2, *bands1]
        if [tuple(a.shape) for a in ins] != [(h // 4, w // 4)] * 4 + [(h // 2, w // 2)] * 3:
            raise ValueError("band shapes do not chain into a two-level pyramid")
        _inv2_geometry(h, strip_rows, deep=False)
        ty, tx = strip_shape(body, ty, tx)
        _check_tile(ty, tx)
        _check_inputs("streamed_idwt2_2level", ty, *ins)
        _count(("B10",), body)
        if not ll2.is_cuda:
            return streamed_idwt2_2level_plain(ll2, bands2, bands1, wavelet, ty, tx, body)
        ins = [a.contiguous() for a in ins]
        out = _empty((h, w), ll2)
        _launch_body("B10", "dwt_sinv2", ll2.dtype, wavelet, True,
                     _ptrs(*ins, out) + [h, w, ty, tx], ll2.device, body, ty, tx)
        return out


def streamed_wavedec2_deep(x, wavelet="cdf97", level: int = 3, strip_rows: int = 0,
                           body: str = "poly", ty: int = 0, tx: int = 0, tile: int = TILE1):
    """The ENTIRE pyramid in ONE launch (B11): levels 1-2 stream through
    the strips while LL2 goes to a scratch buffer (in L2), then the
    remaining ``level - 2`` levels run on it after grid-wide syncs.
    Returns the wavedec2 pytree; floats and integers alike."""
    with _trace.span("kernel.B11"):
        wavelet = get_wavelet(wavelet)
        _check_fused_supported(wavelet)
        if x.ndim != 2:
            raise ValueError("streamed_wavedec2_deep takes one 2-D image")
        h, w = x.shape
        if level < 3:
            raise ValueError("use streamed_dwt2_2level for level <= 2")
        if h % 4 or w % 4:
            raise ValueError("needs h, w divisible by 4")
        _check_body(body, wavelet, x.dtype)
        _fwd2_geometry(h, strip_rows)
        cy2, cx2 = h // 4, w // 4
        if (cy2 + 8) * (cx2 + 8) * x.element_size() > _DEEP_VMEM_LIMIT:
            raise ValueError("LL2 too large to hold the deep tail in VMEM")
        n = level - 2
        if min(cy2, cx2) >> (n - 1) <= 2 * HALO:
            raise ValueError("too many levels for this size")
        ty, tx = strip_shape(body, ty, tx)
        _check_tile(ty, tx)
        _check_inputs("streamed_wavedec2_deep", tile, x)
        _count(("B11",), body)
        if not x.is_cuda:
            return streamed_wavedec2_deep_plain(x, wavelet, level, ty, tx, tile, body)
        x = x.contiguous()
        ll2 = _empty((cy2, cx2), x)
        b2 = [_empty((cy2, cx2), x) for _ in range(3)]
        b1 = [_empty((h // 2, w // 2), x) for _ in range(3)]
        deep, ptrs = [], _ptrs(ll2, *b2, *b1)
        ch, cw = cy2, cx2
        for ny_, nx_ in _deep_shapes(cy2, cx2, n):
            lvl = (_empty((ny_, cw // 2), x), _empty((ch // 2, nx_), x),
                   _empty((ch // 2, cw // 2), x), _empty((ny_, nx_), x))
            deep.append(lvl)
            ptrs += _ptrs(*lvl)
            ch, cw = ny_, nx_
        _launch_coop("B11", "dwt_sdeep_fwd", x.dtype, wavelet, False, x.data_ptr(), ptrs,
                     [n, h, w, ty, tx, tile], x.device, body, ty, tx)
        return [deep[-1][3]] + [lvl[:3] for lvl in deep[::-1]] + [tuple(b2), tuple(b1)]


def streamed_waverec2_deep(coeffs, wavelet="cdf97", strip_rows: int = 0,
                           body: str = "auto", ty: int = 0, tx: int = 0, tile: int = TILE1):
    """The ENTIRE reconstruction in ONE launch (B12), the inverse of
    :func:`streamed_wavedec2_deep`: the deep levels rebuild LL2 into a
    scratch buffer, then after a grid-wide sync the level-2+1 strips
    stream out."""
    with _trace.span("kernel.B12"):
        wavelet = get_wavelet(wavelet)
        _check_fused_supported(wavelet)
        levels = len(coeffs) - 1
        if levels < 3:
            raise ValueError("use streamed_idwt2_2level for 2 levels")
        hl1, lh1, hh1 = coeffs[-1]
        hl2, lh2, hh2 = coeffs[-2]
        h, w = hl1.shape[-2] + lh1.shape[-2], hl1.shape[-1] + lh1.shape[-1]
        if h % 4 or w % 4:
            raise ValueError("needs h, w divisible by 4")
        cy1, cx1 = h // 2, w // 2
        cy2, cx2 = h // 4, w // 4
        for name, band, shp in (("hl2", hl2, (cy2, cx2)), ("lh2", lh2, (cy2, cx2)),
                                ("hh2", hh2, (cy2, cx2)), ("hl1", hl1, (cy1, cx1)),
                                ("lh1", lh1, (cy1, cx1)), ("hh1", hh1, (cy1, cx1))):
            if tuple(band.shape) != shp:
                raise ValueError(f"streamed deep inverse: band {name} has shape "
                                 f"{tuple(band.shape)}, expected {shp}")
        if (cy2 + 8) * (cx2 + 8) * hl1.element_size() > _DEEP_VMEM_LIMIT:
            raise ValueError("LL2 too large to hold the deep tail in VMEM")
        n = levels - 2
        sizes = [(cy2, cx2)] + _deep_shapes(cy2, cx2, n)
        ll_shape = sizes[n]
        if tuple(coeffs[0].shape) != ll_shape:
            raise ValueError(f"streamed deep inverse: LL has shape "
                             f"{tuple(coeffs[0].shape)}, expected {ll_shape}")
        if min(ll_shape) <= CH:
            raise ValueError(f"coarsest LL {ll_shape} too small for the deep tail's "
                             f"channel mirrors (needs > {CH} samples per axis)")
        for triple, (th, tw) in zip(coeffs[1:levels - 1], sizes[n - 1::-1]):
            want = ((-(-th // 2), tw // 2), (th // 2, -(-tw // 2)), (th // 2, tw // 2))
            got = tuple(tuple(b.shape) for b in triple)
            if got != want:
                raise ValueError(f"streamed deep inverse: coarse triple shapes {got} do "
                                 f"not match the {th}x{tw} level ({want})")
        body = _resolve_inv_body(body, wavelet, hl1.dtype)
        _inv2_geometry(h, strip_rows, deep=True)
        ty, tx = strip_shape(body, ty, tx)
        _check_tile(ty, tx)
        flat = [coeffs[0]] + [b for lvl in coeffs[1:] for b in lvl]
        _check_inputs("streamed_waverec2_deep", tile, *flat)
        _count(("B12",), body)
        if not hl1.is_cuda:
            return streamed_waverec2_deep_plain(coeffs, wavelet, ty, tx, tile, body)
        flat = [a.contiguous() for a in flat]
        # the deep levels' reconstructions (the last is the LL2 scratch), held
        # until the launch is enqueued: a buffer freed before it could be handed
        # to the next allocation (the banded body's matrices) and overwritten
        scratch = [_empty(sizes[n - 1 - k], hl1) for k in range(n)]
        ptrs = _ptrs(flat[0])
        for k in range(n):  # coarse first: the level's bands, then its output
            ptrs += _ptrs(*flat[1 + 3 * k: 4 + 3 * k], scratch[k])
        out = _empty((h, w), hl1)
        _launch_coop("B12", "dwt_sdeep_inv", hl1.dtype, wavelet, True, out.data_ptr(),
                     ptrs + _ptrs(*flat[-6:]), [n, h, w, ty, tx, tile], hl1.device, body,
                     ty, tx)
        return out


# ------------------------------------------------------------ pyramids


def streamed_wavedec2(x, wavelet="cdf97", level: int = 1, strip_rows: int = 0,
                      body: str = "poly"):
    """Multi-level MRA: the one-launch pyramid (B11) where
    :func:`streamed_deep_ok` allows, else streamed 2-level passes (B8)
    while the geometry allows, then the fused tail of
    :func:`ops.fused.fused_wavedec2`.  Same pytree as wavedec2."""
    with _trace.span("streamed.wavedec2"):
        if x.ndim == 2 and level >= 3 and streamed_deep_ok(
                tuple(x.shape), x.element_size(), wavelet, level, strip_rows):
            return streamed_wavedec2_deep(x, wavelet, level, strip_rows=strip_rows, body=body)
        coeffs = []
        ll = x
        remaining = level
        while remaining >= 2 and ll.ndim == 2 and streamed_supported(
                tuple(ll.shape), wavelet, strip_rows, levels=2):
            ll, b2, b1 = streamed_dwt2_2level(ll, wavelet, strip_rows=strip_rows, body=body)
            coeffs += [b1, b2]
            remaining -= 2
        if remaining:
            rest = fused_wavedec2(ll, wavelet, remaining)
            ll = rest[0]
            coeffs.extend(rest[:0:-1])
        return [ll] + coeffs[::-1]


def streamed_waverec2(coeffs, wavelet="cdf97", strip_rows: int = 0, body: str = "auto"):
    """Inverse of :func:`streamed_wavedec2` (any wavedec2 pytree): the
    one-launch reconstruction (B12) where its geometry allows, else
    streamed 2-level inverses (B10) from the coarse end down, with the
    fused tail for small or odd-geometry levels.  Only the wrapper's own
    ``ValueError`` (geometry, pytree shapes) sends the deep attempt to the
    level loop; a launch error propagates."""
    with _trace.span("streamed.waverec2"):
        if len(coeffs) >= 4 and coeffs[0].ndim == 2:
            try:
                return streamed_waverec2_deep(coeffs, wavelet, strip_rows=strip_rows,
                                              body=body)
            except ValueError:
                pass
        ll = coeffs[0]
        rest = list(coeffs[1:])
        while rest:
            if len(rest) >= 2:
                b2, b1 = rest[0], rest[1]
                h = b1[0].shape[-2] + b1[1].shape[-2]
                w = b1[0].shape[-1] + b1[1].shape[-1]
                if (ll.ndim == 2
                        and streamed_supported((h, w), wavelet, strip_rows, levels=2)
                        and ll.shape == b2[0].shape
                        and all(b.shape == b2[0].shape for b in b2)
                        and all(tuple(b.shape) == (h // 2, w // 2) for b in b1)):
                    ll = streamed_idwt2_2level(ll, b2, b1, wavelet, strip_rows=strip_rows,
                                               body=body)
                    rest = rest[2:]
                    continue
            ll = fused_waverec2([ll, rest[0]], wavelet)
            rest = rest[1:]
        return ll
