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
``jaxpr_collective_stats`` has no counterpart.  The counts go through the
port's recorder (:mod:`libdwt_torch.utils.trace`), as the innermost
recorder's ``collective.<primitive>`` counters.
"""
from __future__ import annotations

from typing import Callable, Dict

from libdwt_torch.utils import trace

__all__ = ["collective_stats", "record"]

#: the counters of :mod:`libdwt_torch.utils.trace` that hold collectives
_PREFIX = "collective."


def record(prim: str, nbytes: int) -> None:
    """Count one issue of ``prim`` moving ``nbytes`` (one shard's operand)."""
    trace.count(_PREFIX + prim, "count")
    trace.count(_PREFIX + prim, "bytes", int(nbytes))


def collective_stats(fn: Callable, *args, **kwargs) -> Dict[str, Dict[str, int]]:
    """Run ``fn(*args, **kwargs)`` under a recorder of its own and return
    {primitive: {"count": n, "bytes": b}} for the collectives it issued."""
    with trace.recording() as rec:
        fn(*args, **kwargs)
    return {name[len(_PREFIX):]: dict(slot) for name, slot in rec.counts.items()
            if name.startswith(_PREFIX)}
