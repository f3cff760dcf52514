"""Collective accounting for the sharded transforms (port of
``libdwt_tpu.parallel.comm_stats``).

The reference walks the jaxpr of a function and counts its communication
primitives with their operand bytes; this makes the halo-exchange schedule
a testable claim (one signal-row exchange per forward level, 2 ppermutes;
stacked channel pairs on the inverse, 4).  The port has no jaxpr, so it
RUNS ``fn`` under a recorder that the exchange helpers of
:mod:`libdwt_torch.parallel.sharded` report to: each neighbour shift they
make over a mesh axis is one ``ppermute`` entry, whose bytes are one
shard's operand (the halo rows a shard sends), as the reference's jaxpr
sees it inside ``shard_map``.  So counts and bytes equal the reference's
for the same call, but the call is executed, not traced.  The kernel halo
(``halo_impl='rdma'``, B18) issues no ``ppermute``, as in the reference.
``jaxpr_collective_stats`` has no counterpart.
"""
from __future__ import annotations

from typing import Callable, Dict, List

__all__ = ["collective_stats", "record"]

#: the recorders of the collective_stats calls running now (innermost last)
_active: List[Dict[str, Dict[str, int]]] = []


def record(prim: str, nbytes: int) -> None:
    """Count one issue of ``prim`` moving ``nbytes`` (one shard's operand)."""
    if _active:
        slot = _active[-1].setdefault(prim, {"count": 0, "bytes": 0})
        slot["count"] += 1
        slot["bytes"] += int(nbytes)


def collective_stats(fn: Callable, *args, **kwargs) -> Dict[str, Dict[str, int]]:
    """Run ``fn(*args, **kwargs)`` and return {primitive: {"count": n,
    "bytes": b}} for the collectives it issued."""
    stats: Dict[str, Dict[str, int]] = {}
    _active.append(stats)
    try:
        fn(*args, **kwargs)
    finally:
        _active.pop()
    return stats
