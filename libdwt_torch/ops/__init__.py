"""Compute ops of the PyTorch port.

- lifting    — batched 1-D polyphase lifting (float/int), the core math
- separable  — N-dim separable MRA (the port's correctness oracle)
- fused      — the 2-D tile kernels (CUDA on the card, plain torch on
               the CPU) and the fused pyramid functions
- fused3d    — the fused volume levels (one level, forward and inverse, on
               the column walk fed by 3-D tensor boxes)
- streamed   — the streamed strip kernels (one level, two levels per
               pass, and the whole pyramid in one cooperative launch) and
               the streamed pyramid functions
- streamed3d — the streamed volume levels (one level, forward and
               inverse, on the same column walk)
- interleaved — transforms in the interleaved (dwt-simple) layout and the
               conversions to and from the packed one
- conv       — centred strided convolution with saturated borders,
               find_max_pos
- swt        — the stationary (à-trous) transform, 1-D and 2-D, and its
               inverse
- nsls       — the non-separable lifting level, forward and inverse
- eaw        — edge-avoiding (weighted) lifting and its 2-D pyramid
- features   — per-band statistics, feature vectors, thresholds and
               denoise2 (which runs the dispatching pyramid)
- gabor      — time-frequency planes (STFT, complex-Morlet CWT,
               S-transform) as one conv1d, phase derivative, ridges
"""


class UnsupportedGeometry(ValueError):
    """A kernel's documented support check rejected the call geometry
    (odd dims, too-small image, tile-count range).

    Dispatchers catch exactly this to fall back to the separable oracle;
    any other error from a kernel is a bug and propagates.  Subclasses
    ValueError so explicit-impl callers keep their error contract."""
