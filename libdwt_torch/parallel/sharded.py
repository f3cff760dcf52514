"""Sharded DWT: spatial (row) sharding with halo exchange (port of
``libdwt_tpu.parallel.sharded``).

Frames (and batches of frames) are cut over a device mesh
(:mod:`libdwt_torch.parallel.mesh`) and the column-pass lifting dependency
across a shard boundary is resolved by exchanging a fixed halo of
boundary rows with the neighbouring shards.  The reference runs the level
loop inside ``shard_map`` with ``jax.lax.ppermute``; here one process
holds every shard's local block (:class:`~libdwt_torch.parallel.mesh.Shards`)
and runs the level loop over all of them together, so an exchange is one
collective over a mesh axis: a neighbour shift of the halo slices
(``halo_impl='ppermute'``, counted by :mod:`.comm_stats`) or the halo
push kernel B18 (``halo_impl='rdma'``, :mod:`.remote_halo`).

Key invariant (why a 4-row halo suffices): one CDF 9/7 lifting pass
corrupts at most 2 low + 2 high samples at each end of an extended block;
keeping only the interior of a block extended by HALO = 4 signal rows
reproduces the unsharded result exactly.

Axes convention: images are (..., H, W); the sharded ("space") axis is
rows (-2); a leading batch axis shards over the "data" mesh axis.
``col_axis`` shards W as well (2-D block sharding over a ('data', rows,
cols) mesh): halo exchange then runs in two phases, rows first, then
columns of the row-extended block, so corner samples from diagonal
neighbours arrive without a diagonal exchange.

The reference's ``interpret`` and ``check_vma`` have no counterpart: a
CPU mesh runs each kernel's plain version, a CUDA mesh the kernels.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from libdwt_torch.models.wavelets import get_wavelet
from libdwt_torch.ops.fused import CH as FCH
from libdwt_torch.ops.fused import fused_dwt2_level, fused_idwt2_level, fused_supported
from libdwt_torch.ops.lifting import lift_fwd, lift_inv
from libdwt_torch.ops.streamed import TOP, streamed_dwt2_level, streamed_idwt2_level
from libdwt_torch.ops.streamed import streamed_supported
from libdwt_torch.parallel.comm_stats import record
from libdwt_torch.parallel.mesh import Mesh, Shards, assemble, cuda_devices, split
from libdwt_torch.parallel.remote_halo import (extend_line, rdma_extend_channels,
                                              rdma_extend_rows)

__all__ = [
    "HALO",
    "sharded_wavedec2",
    "sharded_waverec2",
    "sharded_dwt2_level",
    "sharded_idwt2_level",
    "sharded_wavedec3",
    "sharded_waverec3",
    "make_mesh_2d",
    "make_mesh_blocks",
]

#: signal-domain halo rows exchanged per level (enough for CDF 9/7's
#: 4 lifting steps; also correct for shorter wavelets).
HALO = 4
#: channel-domain halo (low/high rows) for the inverse pass.
CH = 2

BANDS3 = ("LLH", "LHL", "LHH", "HLL", "HLH", "HHL", "HHH")


def make_mesh_2d(n_data: int, n_space: int, devices=None) -> Mesh:
    """A ('data', 'space') mesh: batch-parallel x spatial row sharding.
    ``devices``: a list of torch devices, repeats allowed (default: every
    CUDA device; with none this raises)."""
    devices = list(cuda_devices() if devices is None else devices)
    if len(devices) < n_data * n_space:
        raise ValueError(
            f"make_mesh_2d({n_data}, {n_space}) needs {n_data * n_space} "
            f"devices, have {len(devices)}"
        )
    devices = np.asarray(devices[: n_data * n_space], dtype=object)
    return Mesh(devices.reshape(n_data, n_space), axis_names=("data", "space"))


def make_mesh_blocks(n_data: int, n_rows: int, n_cols: int, devices=None) -> Mesh:
    """A ('data', 'rows', 'cols') mesh: batch parallelism x 2-D spatial
    block sharding, for frames too large (or too square) to scale by row
    sharding alone.  ``devices`` as in :func:`make_mesh_2d`."""
    devices = list(cuda_devices() if devices is None else devices)
    need = n_data * n_rows * n_cols
    if len(devices) < need:
        raise ValueError(
            f"make_mesh_blocks({n_data}, {n_rows}, {n_cols}) needs {need} "
            f"devices, have {len(devices)}"
        )
    devices = np.asarray(devices[:need], dtype=object)
    return Mesh(devices.reshape(n_data, n_rows, n_cols),
                axis_names=("data", "rows", "cols"))


def _check_mirror_safe(wavelet):
    """The edge shards fill their halo with the PHYSICAL whole-point
    mirror; that reproduces the lifting's per-step neighbour clamping only
    when every lifting step is symmetric or the clamped neighbour carries
    zero weight (haar's one-sided steps).  d4's asymmetric steps break the
    equivalence, so reject rather than silently differ from the unsharded
    oracle at the global borders."""
    if not (fused_supported(wavelet) or wavelet.name == "haar"):
        raise ValueError(
            f"sharded transforms need symmetric lifting steps (or haar); "
            f"'{wavelet.name}' would differ from the unsharded result at "
            f"the global borders"
        )


# ------------------------------------------------------------- halo helpers


def _extend(x: Shards, axis_name: str, axis: int, halo: int, t_off: int,
            b_off: int) -> Shards:
    """Every block extended by ``halo`` samples on each side of ``axis``
    (:func:`.remote_halo.extend_line` along the mesh line ``axis_name``).
    Two neighbour shifts (down and up), each one ``ppermute`` of one
    shard's ``halo`` slice."""
    op = x.first.narrow(axis, 0, halo)
    for _ in range(2):
        record("ppermute", op.numel() * op.element_size())
    return x.along(axis_name, lambda blocks: extend_line(blocks, halo, t_off, b_off, axis))


def _exchange_fwd(x: Shards, axis_name: str, axis: int = -2,
                  halo: int = HALO) -> Shards:
    """Extend the local blocks by ``halo`` signal samples on each side of
    ``axis``: interior shards receive their neighbours' boundary samples,
    edge shards fill the halo with the whole-point mirror of their own
    samples (x[-m] := x[m]).  ``halo`` defaults to the analysis support
    radius (HALO = 4); the streamed per-shard kernels take an 8-row halo
    (their extended contract, ops.streamed.TOP)."""
    return _extend(x, axis_name, axis, halo, 1, 1)


def _exchange_rows_fwd(x: Shards, axis_name: str, halo: int = HALO) -> Shards:
    """Row-axis (-2) specialization of :func:`_exchange_fwd`."""
    return _exchange_fwd(x, axis_name, axis=-2, halo=halo)


def _exchange_channels_inv(s: Shards, d: Shards, axis_name: str, ch: int = CH,
                           axis: int = -2):
    """Extend the local low/high channel blocks by ``ch`` samples each side
    of ``axis``.  Channel-domain whole-point mirror (from x[-k] = x[k] with
    s[i] = x[2i], d[i] = x[2i+1], global level length even):
      top:    s[-m] = s[m]        d[-m] = d[m-1]
      bottom: s[N+m] = s[N-1-m]   d[N-1+m] = d[N-1-m]
    """
    return (_extend(s, axis_name, axis, ch, 1, 0),
            _extend(d, axis_name, axis, ch, 0, 1))


def _rdma_rows(x: Shards, axis_name: str, halo: int = HALO) -> Shards:
    """:func:`_exchange_rows_fwd` by the halo push kernel (B18), one call
    per mesh line."""
    return x.along(axis_name, lambda blocks: rdma_extend_rows(blocks, halo=halo))


def _rdma_channels(s: Shards, d: Shards, axis_name: str, ch: int = CH):
    """:func:`_exchange_channels_inv` by the halo push kernel (B18)."""
    return s.along(axis_name, lambda sb, db: rdma_extend_channels(sb, db, ch=ch), d)


def _cat(parts, dim: int) -> Shards:
    """Blockwise ``torch.cat`` of the Shards in ``parts``."""
    return parts[0].map(lambda *bs: torch.cat(bs, dim=dim), *parts[1:])


def _col_inv(lo: Shards, hi: Shards, wavelet, axis_name: str) -> Shards:
    """Inverse column-pass lifting on row-sharded channel blocks."""
    lo_ext, hi_ext = _exchange_channels_inv(lo, hi, axis_name)
    keep = 2 * lo.first.shape[-2]
    return lo_ext.map(
        lambda a, b: lift_inv(a, b, wavelet, axis=-2)[..., 2 * CH: 2 * CH + keep, :],
        hi_ext)


# ------------------------------------------------------- local level kernels


def _level_fwd_local(ll: Shards, wavelet, axis_name, ext: Optional[Shards] = None):
    # ONE signal-row halo exchange per level (2 ppermutes, not 4): the
    # row pass is rowwise, so the halo rows' row transforms are computed
    # locally and feed the column pass directly.  ``ext`` lets a caller
    # substitute its own HALO-extended blocks (the halo push kernel).
    if ext is None:
        ext = _exchange_rows_fwd(ll, axis_name)
    off, keep = HALO // 2, ll.first.shape[-2] // 2

    def body(e):
        l, h = lift_fwd(e, wavelet, axis=-1)

        def col(a):
            lo, hi = lift_fwd(a, wavelet, axis=-2)
            return lo[..., off: off + keep, :], hi[..., off: off + keep, :]

        ll2, lh = col(l)
        hl, hh = col(h)
        return ll2, hl, lh, hh

    return ext.map(body)


def _level_fwd_local_blocks(ll: Shards, wavelet, row_axis, col_axis):
    """One forward level on a 2-D-block shard: two-phase halo exchange
    (rows first, then columns OF THE ROW-EXTENDED block, so corner
    samples from diagonal neighbours ride the second phase), then the
    same crop-to-interior lifting as the row-sharded path on both axes."""
    ext = _exchange_fwd(ll, row_axis, axis=-2)
    ext = _exchange_fwd(ext, col_axis, axis=-1)
    off = HALO // 2
    keep_y, keep_x = ll.first.shape[-2] // 2, ll.first.shape[-1] // 2

    def body(e):
        l, h = lift_fwd(e, wavelet, axis=-1)
        l = l[..., off: off + keep_x]
        h = h[..., off: off + keep_x]

        def col(a):
            lo, hi = lift_fwd(a, wavelet, axis=-2)
            return lo[..., off: off + keep_y, :], hi[..., off: off + keep_y, :]

        ll2, lh = col(l)
        hl, hh = col(h)
        return ll2, hl, lh, hh

    return ext.map(body)


def _level_inv_local_blocks(ll, hl, lh, hh, wavelet, row_axis, col_axis):
    """One inverse level on a 2-D-block shard: channel-halo exchange along
    columns first (x-low bands ll/lh vs x-high hl/hh, stacked along rows
    so it is ONE exchange pair), then along rows on the column-extended
    arrays (corners ride the second phase), then the usual inverse
    column+row lifting cropped to the interior."""
    hy = ll.first.shape[-2]
    lo_x, hi_x = _exchange_channels_inv(_cat([ll, lh], -2), _cat([hl, hh], -2),
                                        col_axis, axis=-1)
    # w = local x channels + 2*CH halo
    s = lo_x.map(lambda lo, hi: torch.cat([lo[..., :hy, :], hi[..., :hy, :]], dim=-1), hi_x)
    d = lo_x.map(lambda lo, hi: torch.cat([lo[..., hy:, :], hi[..., hy:, :]], dim=-1), hi_x)
    s_ext, d_ext = _exchange_channels_inv(s, d, row_axis, axis=-2)

    def body(se, de):
        w = se.shape[-1] // 2
        x = lift_inv(se, de, wavelet, axis=-2)[..., 2 * CH: 2 * CH + 2 * hy, :]
        out = lift_inv(x[..., :w], x[..., w:], wavelet, axis=-1)
        keep_x = 2 * (w - 2 * CH)
        return out[..., 2 * CH: 2 * CH + keep_x]

    return s_ext.map(body, d_ext)


def _map_leading(fn, *arrays):
    """Batch loop for the per-shard kernels: maps ``fn`` over the leading
    axes of equally-batched ``arrays`` (one kernel launch per frame); fn
    returns a tensor or a tuple."""
    batch = tuple(arrays[0].shape[:-2])
    flat = [a.reshape((-1,) + tuple(a.shape[-2:])) for a in arrays]
    per = [fn(*(f[i] for f in flat)) for i in range(flat[0].shape[0])]
    if isinstance(per[0], tuple):
        return tuple(torch.stack([p[k] for p in per]).reshape(batch + tuple(per[0][k].shape))
                     for k in range(len(per[0])))
    out = torch.stack(per)
    return out.reshape(batch + tuple(out.shape[-2:]))


def _per_frame(fn):
    """``fn`` on a 2-D block, or frame by frame on a batched one."""
    return lambda *a: fn(*a) if a[0].ndim == 2 else _map_leading(fn, *a)


def _level_fwd_local_fused(ll: Shards, wavelet, axis_name):
    """Fused-kernel variant: exchange the 4-row halo once (batched blocks
    exchange ONCE for the whole batch), then run the single fused level
    (B1, boundary_rows='extended') on each extended local block."""
    ext = _exchange_rows_fwd(ll, axis_name)
    return ext.map(_per_frame(
        lambda e: fused_dwt2_level(e, wavelet, boundary_rows="extended")))


def _streamed_block_ok(h: int, w: int, wavelet) -> bool:
    """Local-block geometry gate for the per-shard streamed kernels (they
    need >= 2 strips); smaller blocks fall back to the fused kernel, which
    handles any even block with > 5 rows."""
    return streamed_supported((h, w), wavelet, 256, levels=1)


def _level_fwd_local_streamed(ll: Shards, wavelet, axis_name):
    """Streamed-kernel variant: the same exchange as the fused variant but
    TOP = 8 rows deep (the streamed level's extended contract), then the
    streamed level (B7) per extended block.  Levels whose local block is
    too small for the strip walk run the fused kernel instead."""
    if not _streamed_block_ok(ll.first.shape[-2], ll.first.shape[-1], wavelet):
        return _level_fwd_local_fused(ll, wavelet, axis_name)
    ext = _exchange_rows_fwd(ll, axis_name, halo=TOP)
    return ext.map(_per_frame(
        lambda e: streamed_dwt2_level(e, wavelet, boundary_rows="extended")))


def _stacked_channels(ll, hl, lh, hh):
    """The band pairs stacked along the local width: (ll|hl, lh|hh), so a
    channel-halo exchange is ONE exchange pair instead of two."""
    return _cat([ll, hl], -1), _cat([lh, hh], -1)


def _level_inv_local_streamed(ll, hl, lh, hh, wavelet, axis_name):
    """Streamed-kernel inverse variant: one stacked channel-halo exchange
    (TOP = 8 deep, once for the whole batch), then the streamed inverse
    level (B9) per extended band set.  Levels whose local block is too
    small for the strip walk run the fused kernel instead (geometry
    checked BEFORE the exchange)."""
    if not _streamed_block_ok(2 * ll.first.shape[-2], 2 * ll.first.shape[-1], wavelet):
        return _level_inv_local_fused(ll, hl, lh, hh, wavelet, axis_name)
    w = ll.first.shape[-1]
    s_ext, d_ext = _exchange_channels_inv(*_stacked_channels(ll, hl, lh, hh), axis_name,
                                          ch=TOP)
    return s_ext.map(_per_frame(
        lambda se, de: streamed_idwt2_level(se[..., :w], se[..., w:], de[..., :w],
                                            de[..., w:], wavelet=wavelet,
                                            boundary_rows="extended")), d_ext)


def _level_inv_local(ll, hl, lh, hh, wavelet, axis_name, exchange=None):
    # ``exchange`` substitutes another halo transport (the halo push
    # kernel of parallel/remote_halo.py)
    w, keep = ll.first.shape[-1], 2 * ll.first.shape[-2]
    s, d = _stacked_channels(ll, hl, lh, hh)
    if exchange is None:
        s_ext, d_ext = _exchange_channels_inv(s, d, axis_name)
    else:
        s_ext, d_ext = exchange(s, d)

    def body(se, de):
        x = lift_inv(se, de, wavelet, axis=-2)[..., 2 * CH: 2 * CH + keep, :]
        return lift_inv(x[..., :w], x[..., w:], wavelet, axis=-1)

    return s_ext.map(body, d_ext)


def _level_inv_local_fused(ll, hl, lh, hh, wavelet, axis_name):
    """Fused-kernel inverse variant: exchange a 4-row channel halo per band
    pair once (once for the whole batch), then run the single fused
    inverse level (B4, boundary_rows='extended') on the extended blocks."""
    w = ll.first.shape[-1]
    s_ext, d_ext = _exchange_channels_inv(*_stacked_channels(ll, hl, lh, hh), axis_name,
                                          ch=FCH)
    return s_ext.map(_per_frame(
        lambda se, de: fused_idwt2_level(se[..., :w], se[..., w:], de[..., :w],
                                         de[..., w:], wavelet,
                                         boundary_rows="extended")), d_ext)


# ------------------------------------------------------------- public entry


def _resolve_kernel(kernel: Optional[str], use_fused: bool) -> Optional[str]:
    """Back-compat: ``use_fused=True`` is ``kernel='fused'``."""
    if kernel is None and use_fused:
        kernel = "fused"
    if kernel not in (None, "fused", "streamed"):
        raise ValueError("kernel must be None, 'fused' or 'streamed'")
    return kernel


def _check_sharded_sizes(h: int, n_space: int, level: int,
                         use_fused: bool = False):
    if h % (n_space * (1 << level)) != 0:
        raise ValueError(
            f"sharded transform needs the sharded extent ({h}) divisible "
            f"by n_shards*2^level ({n_space}*{1 << level})"
        )
    # the fused inverse's channel mirror slices FCH+1 = 5 local rows
    # (ops/fused.CH = 4); the lifting path needs HALO = 4
    min_rows = 5 if use_fused else HALO
    if h // (n_space * (1 << level)) < min_rows:
        raise ValueError(
            f"local rows at the deepest level "
            f"({h // (n_space * (1 << level))}) must be >= {min_rows}; "
            f"reduce level or n_space"
        )


def _tensor(a, mesh: Mesh) -> torch.Tensor:
    """A tensor as given; anything else onto the mesh's first device."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a), device=mesh.devices.flat[0])


def _spec(ndim: int, core: int, data_axis, *axes):
    """The PartitionSpec analogue: the first batch dim over ``data_axis``,
    the ``core`` trailing dims over ``axes`` (None for unsharded)."""
    nbatch = ndim - core
    batch = (data_axis,) + (None,) * (nbatch - 1) if nbatch else ()
    return batch + tuple(axes)


def sharded_wavedec2(
    x,
    wavelet="cdf97",
    level: int = 1,
    *,
    mesh: Mesh,
    space_axis: str = "space",
    data_axis: Optional[str] = "data",
    col_axis: Optional[str] = None,
    use_fused: bool = False,
    kernel: Optional[str] = None,
    halo_impl: str = "ppermute",
):
    """Multi-level 2-D MRA sharded over mesh rows (and batch over data).

    Input (..., H, W) with the leading batch axis sharded over
    ``data_axis`` and H sharded over ``space_axis``.  Returns the pytree of
    :func:`libdwt_torch.wavedec2` -- [LL_J, (HL_J, LH_J, HH_J), ...] --
    assembled on the mesh's first device.

    ``col_axis`` additionally shards W over that mesh axis (2-D block
    sharding over a ('data', rows, cols) mesh, :func:`make_mesh_blocks`).

    ``kernel='fused'`` (alias ``use_fused=True``) runs the per-shard work
    through the single fused level B1 after the halo exchange;
    ``kernel='streamed'`` the streamed level B7 (the fused one where a
    local block is too small for its strips).  Both need row sharding;
    batched inputs launch one kernel per frame inside the shard.

    ``halo_impl='rdma'`` exchanges the halo with the halo push kernel B18
    (parallel/remote_halo.py) instead of the neighbour shift -- 2-D
    inputs, row sharding, the lifting path only.
    """
    wavelet = get_wavelet(wavelet)
    _check_mirror_safe(wavelet)
    kernel = _resolve_kernel(kernel, use_fused)
    x = _tensor(x, mesh)
    n_space = mesh.shape[space_axis]
    if halo_impl not in ("ppermute", "rdma"):
        raise ValueError("halo_impl must be 'ppermute' or 'rdma'")
    if halo_impl == "rdma" and (col_axis is not None or x.ndim != 2
                                or kernel is not None):
        raise ValueError(
            "halo_impl='rdma' supports unbatched 2-D row sharding on "
            "the lifting path (no col_axis/kernel)"
        )
    _check_sharded_sizes(x.shape[-2], n_space, level, kernel is not None)
    if col_axis is not None:
        if kernel is not None:
            raise ValueError(
                "kernel= supports row sharding only (the strip "
                "kernels' lane borders assume true signal edges); "
                "drop col_axis or kernel"
            )
        _check_sharded_sizes(x.shape[-1], mesh.shape[col_axis], level)

    spec = _spec(x.ndim, 2, data_axis, space_axis, col_axis)
    level_fwd_kernel = (_level_fwd_local_fused if kernel == "fused"
                        else _level_fwd_local_streamed)
    coeffs = []
    ll = split(x, mesh, spec)
    for _ in range(level):
        if col_axis is not None:
            ll, hl, lh, hh = _level_fwd_local_blocks(ll, wavelet, space_axis, col_axis)
        elif kernel is not None:
            ll, hl, lh, hh = level_fwd_kernel(ll, wavelet, space_axis)
        elif halo_impl == "rdma":
            ll, hl, lh, hh = _level_fwd_local(ll, wavelet, space_axis,
                                              ext=_rdma_rows(ll, space_axis))
        else:
            ll, hl, lh, hh = _level_fwd_local(ll, wavelet, space_axis)
        coeffs.append((hl, lh, hh))

    def out(s):
        return assemble(s, mesh, spec)

    return [out(ll)] + [tuple(out(b) for b in lvl) for lvl in coeffs[::-1]]


def sharded_waverec2(
    coeffs,
    wavelet="cdf97",
    *,
    mesh: Mesh,
    space_axis: str = "space",
    data_axis: Optional[str] = "data",
    col_axis: Optional[str] = None,
    use_fused: bool = False,
    kernel: Optional[str] = None,
    halo_impl: str = "ppermute",
):
    """Inverse of :func:`sharded_wavedec2` (same sharding convention).

    ``halo_impl='rdma'`` exchanges the channel halos with the halo push
    kernel B18, twice per level (low and high channels) -- 2-D pyramids,
    row sharding, the lifting path only, like the forward.

    ``kernel='fused'`` (alias ``use_fused=True``) runs the per-shard
    inverse through the single fused level B4 after a channel-halo
    exchange; ``kernel='streamed'`` the streamed level B9.  Both need row
    sharding; batched pyramids launch one kernel per frame inside the
    shard.
    """
    wavelet = get_wavelet(wavelet)
    _check_mirror_safe(wavelet)
    kernel = _resolve_kernel(kernel, use_fused)
    level = len(coeffs) - 1
    ll = _tensor(coeffs[0], mesh)
    rest = [tuple(_tensor(b, mesh) for b in lvl) for lvl in coeffs[1:]]
    if halo_impl not in ("ppermute", "rdma"):
        raise ValueError("halo_impl must be 'ppermute' or 'rdma'")
    if halo_impl == "rdma" and (col_axis is not None or ll.ndim != 2
                                or kernel is not None):
        raise ValueError(
            "halo_impl='rdma' supports unbatched 2-D row sharding on "
            "the lifting path (no col_axis/kernel)"
        )
    if col_axis is not None and kernel is not None:
        raise ValueError(
            "kernel= supports row sharding only (the strip kernels' "
            "lane borders assume true signal edges); drop col_axis or "
            "kernel"
        )
    _check_sharded_sizes(ll.shape[-2] << level, mesh.shape[space_axis],
                         level, kernel is not None)
    if col_axis is not None:
        _check_sharded_sizes(ll.shape[-1] << level, mesh.shape[col_axis], level)
    ch = ll.shape[-2]
    for lvl, (hl, lh, hh) in enumerate(rest):
        if not (hl.shape == lh.shape == hh.shape and hl.shape[-2] == ch):
            raise ValueError(
                f"band shapes at level {level - lvl} do not chain: "
                f"LL rows {ch} vs {tuple(hl.shape)}/{tuple(lh.shape)}/{tuple(hh.shape)}"
            )
        ch *= 2
    spec = _spec(ll.ndim, 2, data_axis, space_axis, col_axis)
    level_inv_kernel = (_level_inv_local_fused if kernel == "fused"
                        else _level_inv_local_streamed)

    low = split(ll, mesh, spec)
    for bands in rest:
        hl, lh, hh = (split(b, mesh, spec) for b in bands)
        if col_axis is not None:
            low = _level_inv_local_blocks(low, hl, lh, hh, wavelet, space_axis, col_axis)
        elif kernel is not None:
            low = level_inv_kernel(low, hl, lh, hh, wavelet, space_axis)
        elif halo_impl == "rdma":
            low = _level_inv_local(low, hl, lh, hh, wavelet, space_axis,
                                   exchange=lambda s, d: _rdma_channels(s, d, space_axis))
        else:
            low = _level_inv_local(low, hl, lh, hh, wavelet, space_axis)
    return assemble(low, mesh, spec)


# ------------------------------------------------------------------- 3-D


def _lift_bands_fwd(bands: dict, wavelet, axis: int, crop=None) -> dict:
    """One forward lifting pass over every band (names grow a role prefix
    'L'/'H'), cropping ``crop = (off, keep)`` along ``axis``."""
    new = {}
    for name, arr in bands.items():
        lo, hi = lift_fwd(arr, wavelet, axis=axis)
        if crop is not None:
            lo, hi = (a.narrow(axis, crop[0], crop[1]) for a in (lo, hi))
        new["L" + name] = lo
        new["H" + name] = hi
    return new


def _level3_fwd_local_blocks(low: Shards, wavelet, z_axis, y_axis) -> dict:
    """One forward 3-D level on a (z, y)-block shard: two-phase halo
    exchange (z first, then y of the z-extended block, so corners from
    diagonal neighbours ride the second phase), local x lifting, then y
    and z lifting each cropped to the shard interior."""
    keep_y, keep_z = low.first.shape[-2] // 2, low.first.shape[-3] // 2
    off = HALO // 2
    ext = _exchange_fwd(low, z_axis, axis=-3)
    ext = _exchange_fwd(ext, y_axis, axis=-2)

    def body(e):
        bands = _lift_bands_fwd({"": e}, wavelet, -1)
        bands = _lift_bands_fwd(bands, wavelet, -2, (off, keep_y))
        return _lift_bands_fwd(bands, wavelet, -3, (off, keep_z))

    return ext.map(body)


def _level3_inv_local_blocks(full: dict, wavelet, z_axis, y_axis) -> Shards:
    """One inverse 3-D level on a (z, y)-block shard.

    Band names are (z, y, x) role triples.  The y channel halos are
    exchanged FIRST, on the raw bands (the y channel structure is
    separable, so extending y channels commutes with the z inverse); the z
    exchange then runs on the y-extended arrays so diagonal corners arrive
    without a dedicated exchange.  Each axis costs one stacked exchange
    pair.
    """
    full = dict(full)
    # ---- y channel exchange (pair by the y role, stacked along x)
    names_y = sorted({n[0] + n[2] for n in full})  # (z, x) suffixes
    wloc = full["LLL"].first.shape[-1]
    s_y = _cat([full[zx[0] + "L" + zx[1]] for zx in names_y], -1)
    d_y = _cat([full[zx[0] + "H" + zx[1]] for zx in names_y], -1)
    s_y, d_y = _exchange_channels_inv(s_y, d_y, y_axis, axis=-2)
    for k, zx in enumerate(names_y):
        full[zx[0] + "L" + zx[1]] = s_y.map(lambda a, k=k: a[..., k * wloc: (k + 1) * wloc])
        full[zx[0] + "H" + zx[1]] = d_y.map(lambda a, k=k: a[..., k * wloc: (k + 1) * wloc])

    # ---- z channel exchange + inverse z lifting (pair by the z role)
    names_z = sorted({n[1:] for n in full})  # (y, x) suffixes
    s_z = _cat([full["L" + n] for n in names_z], -1)
    d_z = _cat([full["H" + n] for n in names_z], -1)
    # keep = 2x the PRE-extension z channels: the z halo exists only inside
    # the exchanged copies (the y halo persists on the band arrays)
    keep_z = 2 * full["L" + names_z[0]].first.shape[-3]
    s_z, d_z = _exchange_channels_inv(s_z, d_z, z_axis, axis=-3)

    def body(sz, dz):
        rec = lift_inv(sz, dz, wavelet, axis=-3)[..., 2 * CH: 2 * CH + keep_z, :, :]
        bands = {n: rec[..., k * wloc: (k + 1) * wloc] for k, n in enumerate(names_z)}
        # inverse y lifting on the halo-extended channels (pair by y)
        names_x = sorted({n[1:] for n in bands})  # x suffixes
        s = torch.cat([bands["L" + n] for n in names_x], dim=-1)
        d = torch.cat([bands["H" + n] for n in names_x], dim=-1)
        keep_y = 2 * (s.shape[-2] - 2 * CH)
        rec = lift_inv(s, d, wavelet, axis=-2)[..., 2 * CH: 2 * CH + keep_y, :]
        bands = {n: rec[..., k * wloc: (k + 1) * wloc] for k, n in enumerate(names_x)}
        # inverse x lifting: local
        return lift_inv(bands["L"], bands["H"], wavelet, axis=-1)

    return s_z.map(body, d_z)


def _level3_fwd_local(low: Shards, wavelet, axis_name) -> dict:
    # ONE z-halo exchange per level (2 ppermutes, not 2 per band): the x/y
    # passes are per-z-slice, so the halo slices' transforms are computed
    # locally and feed the z pass directly
    keep_z, off = low.first.shape[-3] // 2, HALO // 2
    ext = _exchange_fwd(low, axis_name, axis=-3)

    def body(e):
        bands = _lift_bands_fwd({"": e}, wavelet, -1)  # x then y: local
        bands = _lift_bands_fwd(bands, wavelet, -2)
        return _lift_bands_fwd(bands, wavelet, -3, (off, keep_z))

    return ext.map(body)


def _level3_inv_local(full: dict, wavelet, axis_name) -> Shards:
    # inverse z pass: stack ALL band pairs along x so the channel halo
    # exchange is ONE exchange pair (not one per band)
    names = sorted({n[1:] for n in full})
    wloc = full["L" + names[0]].first.shape[-1]
    lo_all = _cat([full["L" + n].map(lambda a: a.movedim(-3, -2)) for n in names], -1)
    hi_all = _cat([full["H" + n].map(lambda a: a.movedim(-3, -2)) for n in names], -1)
    rec = _col_inv(lo_all, hi_all, wavelet, axis_name)

    def body(r):
        bands = {n: r[..., k * wloc: (k + 1) * wloc].movedim(-2, -3)
                 for k, n in enumerate(names)}
        for axis in (-2, -1):  # local inverse y then x
            names_ = sorted({n[1:] for n in bands})
            bands = {n: lift_inv(bands["L" + n], bands["H" + n], wavelet, axis=axis)
                     for n in names_}
        return bands[""]

    return rec.map(body)


def sharded_wavedec3(
    x,
    wavelet="cdf97",
    level: int = 1,
    *,
    mesh: Mesh,
    space_axis: str = "space",
    data_axis: Optional[str] = "data",
    col_axis: Optional[str] = None,
):
    """Multi-level 3-D MRA sharded over the z (depth) axis.

    Input (..., Z, Y, X) with Z sharded over ``space_axis`` and the leading
    batch axis over ``data_axis``.  The x/y passes are local; the z-pass
    lifting dependency crosses shard boundaries and is resolved with the
    same 4-sample halo exchange as the 2-D path.  Returns the wavedec3
    pytree: [LLL_J, bands_J, ..., bands_1] with 7-band dicts.

    ``col_axis`` additionally shards Y over that mesh axis ((z, y) block
    sharding for volumes whose depth alone cannot feed the mesh); halo
    exchange then runs in two phases per level, z first then y.
    """
    wavelet = get_wavelet(wavelet)
    _check_mirror_safe(wavelet)
    x = _tensor(x, mesh)
    _check_sharded_sizes(x.shape[-3], mesh.shape[space_axis], level)
    if col_axis is not None:
        _check_sharded_sizes(x.shape[-2], mesh.shape[col_axis], level)
    spec = _spec(x.ndim, 3, data_axis, space_axis, col_axis, None)
    coeffs = []
    low = split(x, mesh, spec)
    for _ in range(level):
        if col_axis is not None:
            bands = _level3_fwd_local_blocks(low, wavelet, space_axis, col_axis)
        else:
            bands = _level3_fwd_local(low, wavelet, space_axis)
        low = bands.pop("LLL")
        coeffs.append(bands)

    def out(s):
        return assemble(s, mesh, spec)

    return [out(low)] + [{k: out(b[k]) for k in BANDS3} for b in coeffs[::-1]]


def sharded_waverec3(
    coeffs,
    wavelet="cdf97",
    *,
    mesh: Mesh,
    space_axis: str = "space",
    data_axis: Optional[str] = "data",
    col_axis: Optional[str] = None,
):
    """Inverse of :func:`sharded_wavedec3` (same sharding convention;
    ``col_axis`` mirrors the forward's (z, y) block sharding)."""
    wavelet = get_wavelet(wavelet)
    _check_mirror_safe(wavelet)
    level = len(coeffs) - 1
    low = _tensor(coeffs[0], mesh)
    _check_sharded_sizes(low.shape[-3] << level, mesh.shape[space_axis], level)
    if col_axis is not None:
        _check_sharded_sizes(low.shape[-2] << level, mesh.shape[col_axis], level)
    spec = _spec(low.ndim, 3, data_axis, space_axis, col_axis, None)
    rec = split(low, mesh, spec)
    for bands in coeffs[1:]:
        full = {k: split(_tensor(bands[k], mesh), mesh, spec) for k in BANDS3}
        full["LLL"] = rec
        if col_axis is not None:
            rec = _level3_inv_local_blocks(full, wavelet, space_axis, col_axis)
        else:
            rec = _level3_inv_local(full, wavelet, space_axis)
    return assemble(rec, mesh, spec)


def sharded_dwt2_level(x, wavelet="cdf97", *, mesh, space_axis="space",
                       data_axis="data", col_axis=None, use_fused=False,
                       kernel=None):
    """Single-level sharded 2-D transform -> (LL, HL, LH, HH)."""
    c = sharded_wavedec2(
        x, wavelet, 1, mesh=mesh, space_axis=space_axis,
        data_axis=data_axis, col_axis=col_axis, use_fused=use_fused,
        kernel=kernel,
    )
    ll, (hl, lh, hh) = c[0], c[1]
    return ll, hl, lh, hh


def sharded_idwt2_level(ll, hl, lh, hh, wavelet="cdf97", *, mesh,
                        space_axis="space", data_axis="data", col_axis=None,
                        use_fused=False, kernel=None):
    """Inverse of :func:`sharded_dwt2_level`."""
    return sharded_waverec2(
        [ll, (hl, lh, hh)],
        wavelet,
        mesh=mesh,
        space_axis=space_axis,
        data_axis=data_axis,
        col_axis=col_axis,
        use_fused=use_fused,
        kernel=kernel,
    )
