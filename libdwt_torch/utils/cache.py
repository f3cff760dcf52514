"""Dataset cache: parse-once binary cache for ASCII matrix datasets.

The port of ``libdwt_tpu.utils.cache``, the analogue of libdwt's spectra
cache (``spectra.c:30-170``): a directory of ASCII MAT files is parsed
once into a binary blob with a metadata sidecar and memory-mapped on
later loads, rebuilt when missing or stale.  Here: one .npy per dataset
(``np.load(mmap_mode='r')``) plus a .meta JSON with source fingerprints
for invalidation.  Host numpy, like the codecs it reads through.
"""
from __future__ import annotations

import json
import os
from typing import List, Sequence, Tuple

import numpy as np

from libdwt_torch.utils.io import load_mat

__all__ = ["load_dataset_cached"]


def _fingerprint(paths: Sequence[str]) -> List[Tuple[str, float, int]]:
    return [
        (os.path.basename(p), os.path.getmtime(p), os.path.getsize(p))
        for p in paths
    ]


def load_dataset_cached(
    directory: str,
    pattern: str = ".dat",
    cache_name: str = ".cache.npy",
) -> np.ndarray:
    """Load all ASCII matrix files in ``directory`` as one (n, dim)
    float32 array, via a rebuilt-if-stale mmap-backed cache."""
    paths = sorted(
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.endswith(pattern)
    )
    if not paths:
        raise FileNotFoundError(f"no '*{pattern}' files in {directory}")
    cache = os.path.join(directory, cache_name)
    meta = cache + ".meta"
    want = _fingerprint(paths)
    if os.path.exists(cache) and os.path.exists(meta):
        try:
            with open(meta) as f:
                have = [tuple(e) for e in json.load(f)]
            if have == [tuple(map(_norm, e)) for e in want]:
                return np.load(cache, mmap_mode="r")
        except Exception:
            pass
    rows = [load_mat(p).reshape(-1) for p in paths]
    dim = max(len(r) for r in rows)
    out = np.zeros((len(rows), dim), np.float32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    np.save(cache, out)
    with open(meta, "w") as f:
        json.dump([list(map(_norm, e)) for e in want], f)
    return np.load(cache, mmap_mode="r")


def _norm(v):
    return round(v, 6) if isinstance(v, float) else v
