"""Kernel-level halo exchange: each shard's output gets its neighbours'
boundary rows without a collective (port of
``libdwt_tpu.parallel.remote_halo``, TPU kernel B18).

The reference issues ``pltpu.make_async_remote_copy`` from inside a Pallas
kernel, one kernel per shard under ``shard_map``, so a later fused kernel
could overlap the halo transfer with its interior compute.  Here one call
takes the whole line of blocks along a mesh axis (the port's mesh is one
process, :mod:`libdwt_torch.parallel.mesh`) and, in the hand-written
kernels of ``csrc/remote_halo.cu`` (B18):

* on a line whose blocks all sit on one CUDA device, gathers: one ordinary
  launch of ``halo_gather_rows`` on the device's current stream, which
  copies every row of every shard's extended output from its source row
  (the map :func:`gather_rows` states); stream order already keeps the
  inputs and outputs in step, so there are no flags, no fence and no
  spin.  ``halo_gather_rows`` is a second C entry point beside
  ``halo_extend_rows`` and takes a channel count:
  :func:`rdma_extend_channels` extends a line's 's' and 'd' blocks in
  one launch, each channel with its own pointer table and mirror offsets;
* on a line over several CUDA devices, pushes: ``halo_extend_rows``, one
  cooperative launch per device for the shards it holds, all issued
  before any wait, the shards synchronising through flags in a
  persistent buffer per line and device with a per-call epoch (one
  launch per device and channel);
* on CPU blocks runs :func:`rdma_extend_rows_plain` (and
  :func:`rdma_extend_channels_plain`), the same semantics in plain torch;
* raises for a line that mixes CPU and CUDA blocks.

On CUDA blocks it launches or raises.

The exchanged semantics are ``sharded._exchange_rows_fwd``'s: shard i's
output is its block with ``halo`` rows on each side, the previous shard's
last rows above, the next shard's first rows below, and the whole-point
mirror of the edge mode at the global borders.  The TPU's 8-row sublane
caveat (remote_halo.py:68-73) does not apply: any width and row offset.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from libdwt_torch.ops import _cuda
from libdwt_torch.ops.fused import KERNELS, KernelStat

__all__ = ["rdma_extend_rows", "rdma_extend_channels", "rdma_extend_rows_plain",
           "rdma_extend_channels_plain", "gather_rows", "LAST_GRID"]

#: edge-shard mirror fills per exchanged quantity: (top_offset,
#: bottom_back_offset) into flip windows -- 'signal' is the whole-point
#: signal mirror (x[-m] = x[m]); 's'/'d' the channel-domain rules of
#: sharded._exchange_channels_inv (low channels mirror whole-point at the
#: head and repeat at the tail, high channels the reverse).
_EDGE_MODES = {"signal": (1, 1), "s": (1, 0), "d": (0, 1)}
#: flags per shard in a flag buffer, and the most shards of one
#: line: ``MAX_SHARDS`` in csrc/remote_halo.cu (the pointer table rides in
#: the kernel's parameters)
_FLAGS_PER_SHARD = 4
_MAX_SHARDS = 64

KERNELS["B18"] = KernelStat("B18", "rdma_extend_rows", "libdwt_torch/csrc/remote_halo.cu",
                            "libdwt_tpu/parallel/remote_halo.py:46")

#: (path, grid, co-resident blocks) of the last launch of B18 on each
#: device: path 'gather' (one ordinary launch for a line on one device; no
#: block waits for another, so 0 co-resident blocks) or 'push' (the
#: cooperative launch of a line over several devices).
LAST_GRID: Dict[str, Tuple[str, int, int]] = {}

#: the flag buffer of each line (keyed by its devices in mesh order) on each
#: of its devices, never freed or reset, and the epoch of the last call; the
#: flags only grow, and a call waits for its own epoch.  Lines on other
#: device tuples have other buffers: their launches are not ordered by one
#: stream per device, so a later call's signals could otherwise meet an
#: earlier call's waits.
_flags: Dict[Tuple[Tuple[torch.device, ...], torch.device], torch.Tensor] = {}
_epoch = [0]
_peers: set = set()


def _check(blocks: Sequence[torch.Tensor], halo: int, edge_mode: str):
    if edge_mode not in _EDGE_MODES:
        raise ValueError(f"edge_mode must be one of {tuple(_EDGE_MODES)}, got {edge_mode!r}")
    if not blocks:
        raise ValueError("rdma_extend_rows needs the blocks of at least one shard")
    x = blocks[0]
    if x.ndim != 2:
        raise ValueError("rdma_extend_rows operates on 2-D local blocks")
    h = x.shape[0]
    if halo < 1:
        raise ValueError(f"halo must be positive, got {halo}")
    if h < halo + 1:
        raise ValueError(f"local block rows ({h}) must exceed halo ({halo})")
    if any(b.shape != x.shape or b.dtype != x.dtype for b in blocks):
        raise ValueError("every shard's block needs one shape and dtype")
    if x.element_size() not in (4, 8):
        raise ValueError(f"the halo kernel copies 4- or 8-byte elements, not {x.dtype}")
    _one_kind(blocks)
    return _EDGE_MODES[edge_mode]


def _one_kind(blocks: Sequence[torch.Tensor]) -> None:
    kinds = {b.device.type for b in blocks}
    if len(kinds) > 1:
        raise ValueError(f"a mesh that mixes devices of kinds {sorted(kinds)} has no "
                         "halo kernel; put every shard on CUDA or every shard on the CPU")


def extend_line(blocks: Sequence[torch.Tensor], halo: int, t_off: int, b_off: int,
                axis: int = 0) -> List[torch.Tensor]:
    """The halo semantics, in plain torch: every block of one mesh line
    extended by ``halo`` samples on each side of ``axis``, the neighbours'
    boundary samples inside the line, the flip of ``x[t_off : t_off+halo]``
    (top) and of ``x[L-halo-b_off : L-b_off]`` (bottom) at the global
    borders; each result on its block's device."""
    n, L = len(blocks), blocks[0].shape[axis]
    out = []
    for i, x in enumerate(blocks):
        top = (blocks[i - 1].narrow(axis, L - halo, halo).to(x.device) if i > 0
               else x.narrow(axis, t_off, halo).flip(axis))
        bot = (blocks[i + 1].narrow(axis, 0, halo).to(x.device) if i < n - 1
               else x.narrow(axis, L - halo - b_off, halo).flip(axis))
        out.append(torch.cat([top, x, bot], dim=axis))
    return out


def rdma_extend_rows_plain(blocks: Sequence[torch.Tensor], halo: int = 4,
                           edge_mode: str = "signal") -> List[torch.Tensor]:
    """Plain version of B18: each block extended by ``halo`` rows per side,
    the neighbours' rows in the interior, the edge mode's mirror at the
    global borders (:func:`extend_line` on the rows)."""
    t_off, b_off = _check(blocks, halo, edge_mode)
    return extend_line(blocks, halo, t_off, b_off)


def rdma_extend_channels_plain(s_blocks: Sequence[torch.Tensor],
                               d_blocks: Sequence[torch.Tensor],
                               ch: int = 2) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Plain version of :func:`rdma_extend_channels`: the 's' blocks with
    the edge mode 's', the 'd' blocks with 'd'."""
    return (rdma_extend_rows_plain(s_blocks, ch, "s"), rdma_extend_rows_plain(d_blocks, ch, "d"))


def gather_rows(n: int, h: int, halo: int, t_off: int, b_off: int) -> torch.Tensor:
    """The gather's row map, the index arithmetic of ``source_row`` in
    csrc/remote_halo.cu: for each row of the line's extended outputs in
    shard order (n * (h + 2*halo) rows), the row of the stacked inputs
    (``shard * h + row``) it copies.  ``torch.cat(blocks).index_select(0,
    gather_rows(...))`` is the line's outputs, stacked."""
    i = torch.arange(n).repeat_interleave(h + 2 * halo)
    r = torch.arange(h + 2 * halo).repeat(n)
    top, bot, k = r < halo, r >= halo + h, r - halo - h
    s = torch.where(top & (i > 0), i - 1, torch.where(bot & (i < n - 1), i + 1, i))
    row = torch.where(top, torch.where(i > 0, h - halo + r, t_off + halo - 1 - r),
                      torch.where(bot, torch.where(i < n - 1, k, h - 1 - b_off - k), r - halo))
    return s * h + row


def _flag_ptr(line: Tuple[torch.device, ...], dev: torch.device) -> int:
    """The address of the flag buffer of ``line`` on ``dev`` (allocated once,
    never freed or reset)."""
    if (line, dev) not in _flags:
        _flags[line, dev] = torch.zeros(_FLAGS_PER_SHARD * _MAX_SHARDS, dtype=torch.int32,
                                        device=dev)
    return _flags[line, dev].data_ptr()


def _enable_peers(devs: Sequence[torch.device]) -> None:
    """Peer access between neighbouring shards on different cards, once per
    pair and direction; raises where the pair has none."""
    for a, b in zip(devs, devs[1:]):
        for src, dst in ((a, b), (b, a)):
            if src == dst or (src, dst) in _peers:
                continue
            if not torch.cuda.can_device_access_peer(src.index, dst.index):
                raise RuntimeError(f"{src} cannot write into {dst} (no peer access); "
                                   "the halo kernel needs neighbouring cards to be peers")
            with torch.cuda.device(src):
                err = _cuda.kernel_fn("halo_enable_peer")(src.index, dst.index)
            _cuda.check(err, f"peer access {src} -> {dst}")
            _peers.add((src, dst))


def _device(b: torch.Tensor) -> torch.device:
    return torch.device("cuda", b.device.index if b.device.index is not None
                        else torch.cuda.current_device())


def _gather_cuda(lines, halo: int, dev: torch.device) -> List[List[torch.Tensor]]:
    """One launch of the gather on ``dev`` for the channels ``lines`` ((blocks,
    t_off, b_off) each, one element size): one output buffer per channel, a
    (h + 2*halo) x w view per shard."""
    n, elem = len(lines[0][0]), lines[0][0][0].element_size()
    keep, outs, geom = [], [], []
    for blocks, t_off, b_off in lines:
        blocks = [b.contiguous() for b in blocks]
        h, w = blocks[0].shape
        buf = torch.empty((n, h + 2 * halo, w), dtype=blocks[0].dtype, device=dev)
        keep.append(blocks)
        outs.append(list(buf.unbind(0)))
        geom += [h, w, t_off, b_off]
    P = ctypes.c_void_p
    xs = (P * (n * len(lines)))(*[b.data_ptr() for blocks in keep for b in blocks])
    os_ = (P * (n * len(lines)))(*[o.data_ptr() for out in outs for o in out])
    grid = ctypes.c_int()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _cuda.kernel_fn("halo_gather_rows")(
            xs, os_, n, len(lines), (ctypes.c_int * len(geom))(*geom), halo, elem,
            ctypes.byref(grid), stream)
    _cuda.check(err, KERNELS["B18"].name)
    KERNELS["B18"].launches += 1
    LAST_GRID[str(dev)] = ("gather", grid.value, 0)
    # the host arrays are read at launch; the contiguous inputs are freed
    # into the stream the launch is on
    return outs


def _push_cuda(blocks, halo: int, t_off: int, b_off: int) -> List[torch.Tensor]:
    """The push protocol over the devices of one line: one cooperative
    launch per device, in mesh order."""
    n = len(blocks)
    h, w = blocks[0].shape
    blocks = [b.contiguous() for b in blocks]
    devs = [_device(b) for b in blocks]
    _enable_peers(devs)
    # one output buffer per device, a (h + 2*halo) x w view per shard
    outs = [None] * n
    mine = {dev: [i for i, d in enumerate(devs) if d == dev] for dev in dict.fromkeys(devs)}
    for dev, idx in mine.items():
        buf = torch.empty((len(idx), h + 2 * halo, w), dtype=blocks[0].dtype, device=dev)
        for i, o in zip(idx, buf.unbind(0)):
            outs[i] = o
    P = ctypes.c_void_p
    xs = (P * n)(*[b.data_ptr() for b in blocks])
    os_ = (P * n)(*[o.data_ptr() for o in outs])
    line = tuple(devs)
    fl = (P * n)(*[_flag_ptr(line, d) + 4 * _FLAGS_PER_SHARD * i for i, d in enumerate(devs)])
    _epoch[0] += 1
    fn = _cuda.kernel_fn("halo_extend_rows")
    for dev, idx in mine.items():  # one launch per device, in mesh order
        info = (ctypes.c_int * 2)()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(xs, os_, fl, n, (ctypes.c_int * len(idx))(*idx), len(idx), h, w,
                     halo, t_off, b_off, blocks[0].element_size(), _epoch[0], info, stream)
        _cuda.check(err, KERNELS["B18"].name)
        KERNELS["B18"].launches += 1
        LAST_GRID[str(dev)] = ("push", info[0], info[1])
    # the host arrays are read at launch; the blocks stay referenced by the
    # caller, the outputs by the result
    return outs


def _extend_cuda(lines, halo: int) -> List[List[torch.Tensor]]:
    """The channels ``lines`` ((blocks, t_off, b_off) each, one mesh line) on
    CUDA: gathered in one launch when every block sits on one device (one
    launch per element size), else pushed channel by channel."""
    if len(lines[0][0]) > _MAX_SHARDS:
        raise ValueError(f"the halo kernel takes at most {_MAX_SHARDS} shards on one "
                         "mesh axis")
    devs = {_device(b) for blocks, _, _ in lines for b in blocks}
    if len(devs) > 1:
        return [_push_cuda(blocks, halo, t_off, b_off) for blocks, t_off, b_off in lines]
    dev = devs.pop()
    if len({blocks[0].element_size() for blocks, _, _ in lines}) == 1:
        return _gather_cuda(lines, halo, dev)
    return [_gather_cuda([line], halo, dev)[0] for line in lines]


def rdma_extend_rows(blocks: Sequence[torch.Tensor], halo: int = 4,
                     edge_mode: str = "signal") -> List[torch.Tensor]:
    """Extend each row-sharded local block of one mesh line by ``halo`` rows
    per side (B18): the neighbour rows in the interior, the edge mode's
    mirror ('signal', or the channel rules 's'/'d') at the global borders.
    ``blocks``: the 2-D blocks of the line in mesh order, each with >=
    halo + 1 rows.

    On CUDA blocks this launches the kernel (one gather launch for a line on
    one device, one push launch per device for a line over several) or
    raises; on CPU blocks it runs :func:`rdma_extend_rows_plain`."""
    t_off, b_off = _check(blocks, halo, edge_mode)
    KERNELS["B18"].calls += 1
    if not blocks[0].is_cuda:
        return rdma_extend_rows_plain(blocks, halo, edge_mode)
    return _extend_cuda([(list(blocks), t_off, b_off)], halo)[0]


def rdma_extend_channels(s_blocks: Sequence[torch.Tensor], d_blocks: Sequence[torch.Tensor],
                         ch: int = 2) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Channel-domain halo exchange for the INVERSE transform: the low
    ('s') and high ('d') channel blocks of one mesh line extended by ``ch``
    rows per side with the channel-domain mirror rules at the global
    borders, ``sharded._exchange_channels_inv``'s semantics.  On CUDA
    blocks of one device, one gather launch for both channels (the
    reference makes two kernels); over several devices, one push launch per
    device and channel; on CPU blocks :func:`rdma_extend_channels_plain`."""
    s_offs, d_offs = _check(s_blocks, ch, "s"), _check(d_blocks, ch, "d")
    if len(s_blocks) != len(d_blocks):
        raise ValueError("the 's' and 'd' lines need one shard count")
    _one_kind([*s_blocks, *d_blocks])
    KERNELS["B18"].calls += 1
    if not s_blocks[0].is_cuda:
        return rdma_extend_channels_plain(s_blocks, d_blocks, ch)
    return tuple(_extend_cuda([(list(s_blocks), *s_offs), (list(d_blocks), *d_offs)], ch))
