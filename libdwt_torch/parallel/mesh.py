"""A single-process device mesh and the split/assemble helpers that stand in
for ``jax.sharding.Mesh``, ``PartitionSpec`` and ``shard_map``.

The reference is single-controller: ``sharded_wavedec2`` takes one global
array and a mesh, and ``shard_map`` runs the level loop on every device's
local block.  Here one process holds every local block: :func:`split` cuts
the global tensor by a spec into :class:`Shards` (one block per mesh
position, each on its mesh device), the sharded functions run their level
loop over all blocks together, so one exchange call is one collective over
a mesh axis, and :func:`assemble` joins the result on the mesh's first
device.

Deviations from ``jax.sharding.Mesh``, both deliberate:

* a device may repeat in the mesh, so eight shards can live on one card
  (``['cuda:0'] * 8``) or on the CPU (``['cpu'] * 8``), as the JAX tests
  use eight virtual CPU devices;
* mesh axes that a spec does not name are replicas in ``shard_map``; here
  their blocks are computed once, on the device at coordinate 0 of those
  axes (the replicas would hold the same values).
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "Shards", "split", "assemble", "cuda_devices"]


class Mesh:
    """An ndarray of ``torch.device`` with named axes, like
    ``jax.sharding.Mesh``; ``shape`` maps each axis name to its size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(src[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"mesh of {arr.ndim} dims needs {arr.ndim} axis names, "
                             f"got {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, arr.shape))

    def device_at(self, coords: Dict[str, int]) -> torch.device:
        """The device at ``coords`` (axis name -> index; other axes 0)."""
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]


def cuda_devices():
    """Every CUDA device, the meshes' default; with none this raises, as the
    port's entry points do (pass ``devices=['cpu'] * n`` for the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=['cpu'] * n (or any "
            "list of torch devices, repeats allowed) to build a mesh on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Shards:
    """The local blocks of one sharded value: ``blocks`` is an object
    ndarray with one dim per mesh axis in ``axes`` (the axes the spec
    names, in its order), each entry a tensor on its mesh device."""

    def __init__(self, blocks: np.ndarray, axes: Tuple[str, ...]):
        if blocks.ndim != len(axes):
            raise ValueError("one grid dim per sharded mesh axis")
        self.blocks = blocks
        self.axes = tuple(axes)

    @classmethod
    def line(cls, blocks, axis_name: str = "space") -> "Shards":
        """The blocks of one mesh axis, in order (a 1-D grid)."""
        arr = np.empty(len(blocks), dtype=object)
        for i, b in enumerate(blocks):
            arr[i] = b
        return cls(arr, (axis_name,))

    @property
    def first(self) -> torch.Tensor:
        return self.blocks.flat[0]

    def tolist(self):
        return list(self.blocks.flat)

    def _regrid(self, outs: dict):
        """Shards from {index: result}, or a tuple (dict) of Shards where
        the results are tuples (dicts)."""
        first = next(iter(outs.values()))

        def grid(k=None):
            arr = np.empty(self.blocks.shape, dtype=object)
            for idx, v in outs.items():
                arr[idx] = v if k is None else v[k]
            return Shards(arr, self.axes)

        if isinstance(first, tuple):
            return tuple(grid(k) for k in range(len(first)))
        if isinstance(first, dict):
            return {k: grid(k) for k in first}
        return grid()

    def map(self, fn: Callable, *others: "Shards"):
        """``fn`` on every block (with the blocks of ``others`` at the same
        position): Shards, or a tuple (dict) of Shards where ``fn`` returns
        a tuple (dict)."""
        return self._regrid({idx: fn(self.blocks[idx], *(o.blocks[idx] for o in others))
                             for idx in np.ndindex(self.blocks.shape)})

    def lines(self, axis_name: str):
        """Index tuples of every line of blocks along ``axis_name``: a list
        of lists, each in mesh order."""
        d = self.axes.index(axis_name)
        rest = [s for i, s in enumerate(self.blocks.shape) if i != d]
        out = []
        for r in np.ndindex(*rest):
            out.append([r[:d] + (k,) + r[d:] for k in range(self.blocks.shape[d])])
        return out

    def along(self, axis_name: str, fn: Callable, *others: "Shards"):
        """``fn`` on each line of blocks along ``axis_name``: it takes the
        line's blocks in mesh order (and those of ``others`` on the same
        line) and returns a list, or a tuple of lists, of the line's new
        blocks.  Returns Shards, or a tuple of Shards."""
        outs = {}
        for line in self.lines(axis_name):
            res = fn([self.blocks[i] for i in line],
                     *([o.blocks[i] for i in line] for o in others))
            for pos, i in enumerate(line):
                outs[i] = (tuple(r[pos] for r in res) if isinstance(res, tuple)
                           else res[pos])
        return self._regrid(outs)


def _dims(spec, ndim: int):
    """(dim, mesh axis) of every sharded dim of a spec: one entry per tensor
    dim, an axis name or None (missing trailing entries are None)."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    if len(spec) != ndim:
        raise ValueError(f"spec {spec} has more entries than the {ndim}-D value")
    return [(d, a) for d, a in enumerate(spec) if a is not None]


def split(x: torch.Tensor, mesh: Mesh, spec) -> Shards:
    """Cut the global ``x`` by ``spec`` (an axis name or None per dim, as a
    ``PartitionSpec``) into one contiguous block per mesh position of the
    named axes, each moved to its mesh device."""
    dims = _dims(spec, x.ndim)
    axes = tuple(a for _, a in dims)
    if len(set(axes)) != len(axes):
        raise ValueError(f"spec {tuple(spec)} names a mesh axis twice")
    for d, a in dims:
        if a not in mesh.shape:
            raise ValueError(f"spec names axis {a!r}; the mesh has {mesh.axis_names}")
        if x.shape[d] % mesh.shape[a]:
            raise ValueError(
                f"dim {d} of size {x.shape[d]} does not split into "
                f"{mesh.shape[a]} shards over mesh axis {a!r}")
    grid = np.empty(tuple(mesh.shape[a] for a in axes), dtype=object)
    for idx in np.ndindex(grid.shape):
        sl = [slice(None)] * x.ndim
        for (d, a), i in zip(dims, idx):
            n = x.shape[d] // mesh.shape[a]
            sl[d] = slice(i * n, (i + 1) * n)
        dev = mesh.device_at(dict(zip(axes, idx)))
        grid[idx] = x[tuple(sl)].to(dev).contiguous()
    return Shards(grid, axes)


def assemble(s: Shards, mesh: Mesh, spec) -> torch.Tensor:
    """The global tensor of ``s`` (the inverse of :func:`split` under the
    same ``spec``), on the mesh's first device."""
    dims = _dims(spec, s.first.ndim)
    if tuple(a for _, a in dims) != s.axes:
        raise ValueError(f"spec {tuple(spec)} does not match the shards' axes {s.axes}")
    home = mesh.devices.flat[0]
    grid = np.empty(s.blocks.shape, dtype=object)
    for idx in np.ndindex(grid.shape):
        grid[idx] = s.blocks[idx].to(home)
    # join the last grid dim first, down to one tensor
    for k in range(len(dims) - 1, -1, -1):
        d = dims[k][0]
        shape = grid.shape[:k]
        nxt = np.empty(shape, dtype=object)
        for idx in np.ndindex(shape):
            nxt[idx] = torch.cat([grid[idx + (i,)] for i in range(grid.shape[k])], dim=d)
        grid = nxt
    return grid[()]
