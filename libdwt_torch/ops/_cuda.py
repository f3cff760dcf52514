"""Build and bind the hand-written CUDA kernels (``libdwt_torch/csrc``).

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into
``build/libdwt_torch/`` beside the package (``LIBDWT_TORCH_BUILD``
overrides the directory).  The file name carries a hash of the sources
and flags, so an edit rebuilds; a file lock keeps two processes from
racing.  All sources are compiled in parallel, one ``nvcc`` each.
Libraries load through ``ctypes``; pointers and the stream are passed
as ``c_void_p``.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fused2l.cu", "level.cu")
HEADERS = ("lifting.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_MAX_STEPS = 4


class LiftParams(ctypes.Structure):
    """Mirror of ``struct LiftParams`` in csrc/lifting.cuh."""
    _fields_ = [
        ("n", ctypes.c_int),
        ("is_d", ctypes.c_int * _MAX_STEPS),
        ("fwl", ctypes.c_float * _MAX_STEPS),
        ("fwr", ctypes.c_float * _MAX_STEPS),
        ("sign", ctypes.c_int * _MAX_STEPS),
        ("iwl", ctypes.c_int * _MAX_STEPS),
        ("iwr", ctypes.c_int * _MAX_STEPS),
        ("k", ctypes.c_int * _MAX_STEPS),
        ("shift", ctypes.c_int * _MAX_STEPS),
        ("has_scale", ctypes.c_int),
        ("scale", ctypes.c_float * 4),
    ]


def build_dir() -> Path:
    env = os.environ.get("LIBDWT_TORCH_BUILD")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "libdwt_torch"


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME); the CUDA "
                       "kernels are built from libdwt_torch/csrc at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _lib_path(src: str, digest: str) -> Path:
    return build_dir() / f"{Path(src).stem}-{digest}.so"


def build_all() -> dict:
    """Compile every source not yet built (in parallel) and return
    {source: library path}.  Compiler output (including ``-Xptxas -v``
    register and spill counts) goes to ``<lib>.log``."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    paths = {src: _lib_path(src, digest) for src in SOURCES}
    with open(out / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            todo = [s for s, p in paths.items() if not p.exists()]
            if todo:
                nvcc = find_nvcc()
                procs = []
                for src in todo:
                    tmp = paths[src].with_suffix(f".{os.getpid()}.tmp")
                    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                           str(CSRC / src)]
                    procs.append((src, tmp, subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True)))
                errors = []
                for src, tmp, proc in procs:
                    log, _ = proc.communicate()
                    paths[src].with_suffix(".log").write_text(log)
                    if proc.returncode != 0:
                        errors.append(f"nvcc failed on {src}:\n{log}")
                    else:
                        os.replace(tmp, paths[src])
                if errors:
                    raise RuntimeError("\n".join(errors))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return paths


_P = ctypes.c_void_p
_I = ctypes.c_int
_PP = ctypes.POINTER(LiftParams)
_SIGS = {
    "dwt_fwd2": [_P] * 8 + [_I, _I, _I, _PP, _P],
    "dwt_inv2": [_P] * 8 + [_I, _I, _I, _PP, _P],
    "dwt_fwd1": [_P] * 5 + [_I, _I, _I, _PP, _P],
    "dwt_inv1": [_P] * 5 + [_I, _I, _I, _PP, _P],
}
_SOURCE_OF = {"dwt_fwd2": "fused2l.cu", "dwt_inv2": "fused2l.cu",
              "dwt_fwd1": "level.cu", "dwt_inv1": "level.cu"}
_fns: dict = {}


def kernel_fn(name: str, suffix: str):
    """The C entry point ``<name>_<suffix>`` (suffix 'f32' or 'i32'),
    building and loading the libraries on first use."""
    key = f"{name}_{suffix}"
    if key not in _fns:
        paths = build_all()
        libs = {src: ctypes.CDLL(str(p)) for src, p in paths.items()}
        for base, argtypes in _SIGS.items():
            for suf in ("f32", "i32"):
                fn = getattr(libs[_SOURCE_OF[base]], f"{base}_{suf}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[f"{base}_{suf}"] = fn
    return _fns[key]


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
