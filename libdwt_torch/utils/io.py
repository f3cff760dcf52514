"""File I/O: PGM images, ASCII MAT matrices, LIBSVM feature files, EXR.

The port of ``libdwt_tpu.utils.io``.  These are host codecs: numpy in
(or what ``numpy.asarray`` takes), numpy out;
:class:`libdwt_torch.image.Image` moves data between them and a device.
Format parity with libdwt:
  * PGM P2 save "P2\\n<w> <h>\\n<maxval>\\n" one value/line
    (libdwt.c:19263-19299); P2/P5 load (:19426,19794);
  * ASCII MAT = CSV with ',' delimiters and '\\n' rows, "%f" values
    (libdwt.c:24430-24473, load :24810);
  * LIBSVM "<label> 1:v1 2:v2 ...\\n" (libdwt.c:25361).

Uses the native C++ codecs (native/io.cc) when built, numpy otherwise,
as the reference does.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from libdwt_torch.utils import nativelib

__all__ = [
    "load_pgm",
    "save_pgm",
    "load_mat",
    "save_mat",
    "save_svm",
    "load_svm",
    "read_exr",
    "write_exr",
]


def _as_c_f32(a: np.ndarray):
    return a.ctypes.data_as(nativelib.c_f32_p)


def load_pgm(path: str, normalize: bool = True) -> np.ndarray:
    """Load a PGM (P2 or P5) into float32; normalize to [0,1] by maxval
    like dwt_util_load_from_pgm_s (libdwt.c:19794)."""
    lib = nativelib.get()
    if lib is not None:
        w = ctypes.c_int64()
        h = ctypes.c_int64()
        mx = ctypes.c_int64()
        if lib.ldt_pgm_probe(path.encode(), ctypes.byref(w),
                             ctypes.byref(h), ctypes.byref(mx)) == 0:
            out = np.empty((h.value, w.value), np.float32)
            if lib.ldt_pgm_read(path.encode(), _as_c_f32(out), w.value, h.value) == 0:
                return out / np.float32(mx.value) if normalize else out
    return _load_pgm_py(path, normalize)


def _load_pgm_py(path: str, normalize: bool) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"P"):
        raise ValueError(f"{path}: not a PGM")
    kind = data[1:2]
    # tokenize header (skip comments)
    tokens = []
    pos = 2
    while len(tokens) < 3:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos : pos + 1] != b"\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        tokens.append(int(data[start:pos]))
    w, h, mx = tokens
    if kind == b"2":
        vals = np.array(data[pos:].split(), dtype=np.float32)
        img = vals[: w * h].reshape(h, w)
    elif kind == b"5":
        pos += 1
        if mx < 256:
            img = np.frombuffer(data[pos : pos + w * h], np.uint8).reshape(h, w)
        else:
            img = (
                np.frombuffer(data[pos : pos + 2 * w * h], ">u2")
                .reshape(h, w)
            )
        img = img.astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported PGM kind {kind!r}")
    return img / np.float32(mx) if normalize else img


def save_pgm(path: str, img, maxval: int = 255, binary: bool = False) -> None:
    """Save float data in [0,1] as PGM (P2 ASCII by default, like
    libdwt; P5 binary optional)."""
    a = np.asarray(img, np.float32)
    if a.ndim != 2:
        raise ValueError("save_pgm takes a 2-D image")
    lib = nativelib.get()
    if binary:
        if maxval != 255:
            raise ValueError("binary (P5) output is 8-bit: maxval must be 255")
        # same truncation + NaN->0 semantics as the P2 path, so both
        # encodings of one image quantize identically
        q = np.trunc(a.astype(np.float64) * 255.0)
        q = np.clip(np.nan_to_num(q, nan=0.0), 0, 255).astype(np.uint8)
        if lib is not None:
            q = np.ascontiguousarray(q)
            if lib.ldt_pgm_write_p5(path.encode(),
                                    q.ctypes.data_as(nativelib.c_u8_p),
                                    a.shape[1], a.shape[0]) == 0:
                return
        with open(path, "wb") as f:
            f.write(b"P5\n%d %d\n255\n" % (a.shape[1], a.shape[0]))
            f.write(q.tobytes())
        return
    if lib is not None:
        ac = np.ascontiguousarray(a)
        if lib.ldt_pgm_write_p2(path.encode(), _as_c_f32(ac),
                                a.shape[1], a.shape[0], maxval) == 0:
            return
    # libdwt's semantics (dwt_util_save_to_pgm_s, libdwt.c:19794):
    # TRUNCATE maxval*px (C float->int), NaN -> 0, clamp, matching the
    # native codec exactly
    q = np.trunc(a.astype(np.float64) * maxval)
    q = np.clip(np.nan_to_num(q, nan=0.0), 0, maxval).astype(np.int64)
    with open(path, "w") as f:
        f.write(f"P2\n{a.shape[1]} {a.shape[0]}\n{maxval}\n")
        f.write("\n".join(str(v) for v in q.ravel()))
        f.write("\n")


def load_mat(path: str) -> np.ndarray:
    """Load an ASCII MAT (CSV) file into float32."""
    lib = nativelib.get()
    if lib is not None:
        r = ctypes.c_int64()
        c = ctypes.c_int64()
        if lib.ldt_mat_probe(path.encode(), ctypes.byref(r), ctypes.byref(c)) == 0:
            out = np.empty((r.value, c.value), np.float32)
            if lib.ldt_mat_read(path.encode(), _as_c_f32(out), r.value, c.value) == 0:
                return out
    return np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2)


def save_mat(path: str, a) -> None:
    """Save a 2-D array as ASCII MAT, byte-compatible with
    dwt_util_save_to_mat_s ("%f", ',' delim, '\\n' rows)."""
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    if a.ndim == 1:
        a = a[None, :]
    lib = nativelib.get()
    if lib is not None:
        if lib.ldt_mat_write(path.encode(), _as_c_f32(a), a.shape[0], a.shape[1]) == 0:
            return
    with open(path, "w") as f:
        for row in a:
            f.write(",".join("%f" % v for v in row))
            f.write("\n")


def save_svm(path: str, labels, features) -> None:
    """Save labelled feature vectors in LIBSVM format
    (dwt_util_save_to_svm_s, libdwt.c:25361)."""
    labels = np.ascontiguousarray(np.asarray(labels, np.float32))
    features = np.ascontiguousarray(np.asarray(features, np.float32))
    if features.ndim != 2 or labels.shape[0] != features.shape[0]:
        raise ValueError("features must be (n, dim) with matching labels")
    lib = nativelib.get()
    if lib is not None:
        if lib.ldt_svm_write(path.encode(), _as_c_f32(labels),
                             _as_c_f32(features),
                             features.shape[0], features.shape[1]) == 0:
            return
    with open(path, "w") as f:
        for lab, row in zip(labels, features):
            f.write("%g" % lab)
            for j, v in enumerate(row):
                f.write(" %d:%g" % (j + 1, v))
            f.write("\n")


def load_svm(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a LIBSVM file -> (labels, dense features)."""
    labels = []
    rows = []
    dim = 0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            row = {}
            for tok in parts[1:]:
                k, v = tok.split(":")
                row[int(k)] = float(v)
                dim = max(dim, int(k))
            rows.append(row)
    feats = np.zeros((len(rows), dim), np.float32)
    for i, row in enumerate(rows):
        for k, v in row.items():
            feats[i, k - 1] = v
    return np.asarray(labels, np.float32), feats


from libdwt_torch.utils.exr import read_exr, write_exr  # noqa: E402
