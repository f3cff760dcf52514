"""Geometry, test images, device helpers, Q-format fixed point (fix) and
the vector/image helpers (vecops)."""
