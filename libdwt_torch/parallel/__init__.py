"""Sharded transforms on a single-process device mesh: meshes, the sharded
2-D and 3-D transforms, halo exchange (port of ``libdwt_tpu.parallel``)."""

from libdwt_torch.parallel.mesh import Mesh
from libdwt_torch.parallel.sharded import (
    HALO,
    make_mesh_2d,
    make_mesh_blocks,
    sharded_dwt2_level,
    sharded_idwt2_level,
    sharded_wavedec2,
    sharded_wavedec3,
    sharded_waverec2,
    sharded_waverec3,
)

__all__ = [
    "HALO",
    "Mesh",
    "make_mesh_2d",
    "make_mesh_blocks",
    "sharded_dwt2_level",
    "sharded_idwt2_level",
    "sharded_wavedec2",
    "sharded_wavedec3",
    "sharded_waverec2",
    "sharded_waverec3",
]
