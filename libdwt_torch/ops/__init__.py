"""Compute ops of the PyTorch port.

- lifting    — batched 1-D polyphase lifting (float/int), the core math
- separable  — N-dim separable MRA (the port's correctness oracle)
- fused      — the 2-D tile kernels (CUDA on the card, plain torch on
               the CPU) and the fused pyramid functions
- fused3d    — the 3-D tile kernels (one fused level, forward and inverse)
- streamed   — the streamed strip kernels (one level, two levels per
               pass, and the whole pyramid in one cooperative launch) and
               the streamed pyramid functions
- streamed3d — the streamed 3-D tile kernels (one level, forward and
               inverse)
"""


class UnsupportedGeometry(ValueError):
    """A kernel's documented support check rejected the call geometry
    (odd dims, too-small image, tile-count range).

    Dispatchers catch exactly this to fall back to the separable oracle;
    any other error from a kernel is a bug and propagates.  Subclasses
    ValueError so explicit-impl callers keep their error contract."""
