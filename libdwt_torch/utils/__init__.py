"""Geometry, test images, device helpers, Q-format fixed point (fix), the
vector/image helpers (vecops), the file codecs (io, exr, nativelib), the
dataset cache (cache) and the measurement harness (perf)."""
