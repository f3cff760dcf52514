"""The work of one frame, counted from its shapes: samples, bytes, operations.

The count is the same whatever implements the transform: each input
sample is read once and each output written once, at the dtype's size
(coefficients and samples are equally many).  Operations are what the
lifting needs, summed over the levels at their real (ceil-halved) sizes:

- float CDF 9/7: per axis 4 steps of 3 ops (add, multiply, add) on half
  the samples, and one scale multiply per sample for both axes together:
  13 a sample a level;
- reversible integer CDF 5/3: per axis a predict step of 3 ops (add,
  shift, subtract) and an update step of 4 (add, add the rounding
  offset, shift, add) on half the samples: 7 a sample a level;
- float CDF 5/3 (2 steps of 3, and the scale): 7; integer 9/7-F (4 steps
  of 6: two multiplies, three adds, a shift): 24.
"""
from __future__ import annotations

__all__ = ["OPS_PER_SAMPLE_LEVEL", "ITEMSIZE", "level_shapes", "samples_per_frame",
           "bytes_per_frame", "ops_per_frame"]

#: (wavelet, integer?) -> operations a sample of one 2-D level
OPS_PER_SAMPLE_LEVEL = {
    ("cdf97", False): 13,
    ("cdf53", True): 7,
    ("cdf53", False): 7,
    ("cdf97", True): 24,
}

ITEMSIZE = {"float32": 4, "float64": 8, "int32": 4}


def level_shapes(rows: int, columns: int, levels: int):
    """The (rows, columns) that each level transforms, finest first."""
    shapes = []
    for _ in range(levels):
        shapes.append((rows, columns))
        rows, columns = -(-rows // 2), -(-columns // 2)
    return shapes


def samples_per_frame(cfg) -> int:
    return cfg["components"] * cfg["rows"] * cfg["columns"]


def bytes_per_frame(cfg) -> int:
    """Input read once and output written once (either direction)."""
    return 2 * samples_per_frame(cfg) * ITEMSIZE[cfg["dtype"]]


def ops_per_frame(cfg) -> int:
    integer = cfg["dtype"].startswith("int")
    per = OPS_PER_SAMPLE_LEVEL[(cfg["wavelet"], integer)]
    area = sum(r * c for r, c in level_shapes(cfg["rows"], cfg["columns"], cfg["levels"]))
    return per * cfg["components"] * area
