"""Kernel-level halo exchange: each shard pushes its boundary rows straight
into its neighbours' output buffers (port of
``libdwt_tpu.parallel.remote_halo``, TPU kernel B18).

The reference issues ``pltpu.make_async_remote_copy`` from inside a Pallas
kernel, one kernel per shard under ``shard_map``, so a later fused kernel
could overlap the halo transfer with its interior compute.  Here one call
takes the whole line of blocks along a mesh axis (the port's mesh is one
process, :mod:`libdwt_torch.parallel.mesh`) and:

* on CUDA blocks launches the hand-written kernel ``csrc/remote_halo.cu``
  (B18): one cooperative launch per device for the shards it holds, all
  issued before any wait, the shards synchronising through flags in a
  persistent buffer per line and device with a per-call epoch; it
  launches or raises;
* on CPU blocks runs :func:`rdma_extend_rows_plain`, the same semantics
  in plain torch;
* raises for a line that mixes CPU and CUDA blocks.

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
           "LAST_GRID"]

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

#: (grid, co-resident blocks) of the last launch of B18 on each device.
LAST_GRID: Dict[str, Tuple[int, int]] = {}

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
    kinds = {b.device.type for b in blocks}
    if len(kinds) > 1:
        raise ValueError(f"a mesh that mixes devices of kinds {sorted(kinds)} has no "
                         "halo kernel; put every shard on CUDA or every shard on the CPU")
    return _EDGE_MODES[edge_mode]


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


def _extend_rows_cuda(blocks, halo: int, t_off: int, b_off: int) -> List[torch.Tensor]:
    n = len(blocks)
    if n > _MAX_SHARDS:
        raise ValueError(f"the halo kernel takes at most {_MAX_SHARDS} shards on one "
                         "mesh axis")
    h, w = blocks[0].shape
    blocks = [b.contiguous() for b in blocks]
    devs = [torch.device("cuda", b.device.index if b.device.index is not None
                         else torch.cuda.current_device()) for b in blocks]
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
        LAST_GRID[str(dev)] = (info[0], info[1])
    # the host arrays are read at launch; the blocks stay referenced by the
    # caller, the outputs by the result
    return outs


def rdma_extend_rows(blocks: Sequence[torch.Tensor], halo: int = 4,
                     edge_mode: str = "signal") -> List[torch.Tensor]:
    """Extend each row-sharded local block of one mesh line by ``halo`` rows
    per side (B18): the neighbour rows arrive by a push into this shard's
    output (interior shards), the global borders take the edge mode's
    mirror ('signal', or the channel rules 's'/'d').  ``blocks``: the 2-D
    blocks of the line in mesh order, each with >= halo + 1 rows.

    On CUDA blocks this launches the kernel (one launch per device) or
    raises; on CPU blocks it runs :func:`rdma_extend_rows_plain`."""
    t_off, b_off = _check(blocks, halo, edge_mode)
    KERNELS["B18"].calls += 1
    if not blocks[0].is_cuda:
        return rdma_extend_rows_plain(blocks, halo, edge_mode)
    return _extend_rows_cuda(list(blocks), halo, t_off, b_off)


def rdma_extend_channels(s_blocks: Sequence[torch.Tensor], d_blocks: Sequence[torch.Tensor],
                         ch: int = 2) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Channel-domain halo exchange for the INVERSE transform: the low
    ('s') and high ('d') channel blocks of one mesh line extended by ``ch``
    rows per side with the channel-domain mirror rules at the global
    borders, ``sharded._exchange_channels_inv``'s semantics.  Two calls of
    :func:`rdma_extend_rows` (two launches per device on CUDA), as the
    reference makes two kernels."""
    return (rdma_extend_rows(s_blocks, halo=ch, edge_mode="s"),
            rdma_extend_rows(d_blocks, halo=ch, edge_mode="d"))
