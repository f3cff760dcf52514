"""Build and bind the hand-written CUDA kernels (``libdwt_torch/csrc``).

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into
``build/libdwt_torch/`` beside the package (``LIBDWT_TORCH_BUILD``
overrides the directory).  The file name carries a hash of the sources
and flags, so an edit rebuilds; a file lock keeps two processes from
racing.  All sources are compiled in parallel, one ``nvcc`` each.
Libraries load through ``ctypes``; pointers and the stream are passed
as ``c_void_p``.  Nothing here runs at import time.  Each build and each
load is kept as a one-time event of :mod:`libdwt_torch.utils.trace`
(``cuda.build`` with the sources it compiled, ``cuda.load``).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from libdwt_torch.utils import trace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fused2l.cu", "deep.cu", "level.cu", "fused3d.cu", "streamed.cu",
           "streamed3d.cu", "remote_halo.cu")
HEADERS = ("lifting.cuh", "lines.cuh", "onelevel.cuh", "deep.cuh", "fused2l.cuh",
           "tiles.cuh", "tiles3.cuh", "banded.cuh", "zwalk.cuh", "volwalk.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_MAX_STEPS = 4
#: output positions of one tile of the banded body (its mma N) and the most
#: tiles of one pass matrix (windows of <= 256 samples): ``NT`` and
#: ``MAX_TILES`` in csrc/banded.cuh.
MXU_TILE = 8
MXU_MAX_TILES = 32


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
        ("scale_lo", ctypes.c_float),
        ("scale_hi", ctypes.c_float),
        # the float64 kernels' weights and factors, in double
        ("dwl", ctypes.c_double * _MAX_STEPS),
        ("dwr", ctypes.c_double * _MAX_STEPS),
        ("dscale", ctypes.c_double * 4),
        ("dscale_lo", ctypes.c_double),
        ("dscale_hi", ctypes.c_double),
    ]


class BandMat(ctypes.Structure):
    """Mirror of ``struct BandMat`` in csrc/banded.cuh: one banded pass
    matrix (window length, tiles of MXU_TILE positions, and the index of
    its first tile's fragments)."""
    _fields_ = [
        ("n", ctypes.c_int),
        ("ntiles", ctypes.c_int),
        ("off", ctypes.c_int),
    ]


class MxuMats(ctypes.Structure):
    """Mirror of ``struct MxuMats`` in csrc/banded.cuh: the four pass
    matrices of a strip kernel with the banded body and their fragments on
    the card (32 lanes x 8 bf16 a tile)."""
    _fields_ = [
        ("frags", ctypes.c_void_p),
        ("tiles", ctypes.c_int),
        ("m", BandMat * 4),
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
    register and spill counts) goes to ``<lib>.log``.  Kept as the
    one-time event ``cuda.build`` (seconds, ``compiled``: the sources
    compiled, none where every library was built already)."""
    t0 = time.perf_counter()
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
    trace.once("cuda.build", time.perf_counter() - t0, compiled=todo)
    return paths


_P = ctypes.c_void_p
_I = ctypes.c_int
_PP = ctypes.POINTER(LiftParams)
_PM = ctypes.POINTER(MxuMats)
_SIGS = {
    "dwt_fwd2": [_P] * 8 + [_I, _I, _I, _PP, _P],
    "dwt_inv2": [_P] * 8 + [_I, _I, _I, _PP, _P],
    "dwt_fwd1": [_P] * 5 + [_I] * 4 + [_PP, _P],
    # host array of 4n + 1 pointers (image or LL, then per level three bands
    # and what the level makes), levels, h, w, tile, host int[2] <- (grid,
    # resident blocks)
    "dwt_deep_fwd": [_P] + [_I] * 4 + [_P, _PP, _P],
    "dwt_deep_inv": [_P] + [_I] * 4 + [_P, _PP, _P],
    "dwt_inv1": [_P] * 5 + [_I] * 4 + [_PP, _P],
    # input, host array of the 8 band pointers, Z, Y, X, tz, ty, tx, host
    # int <- the feed (1: tensor boxes, 0: copies)
    "dwt3_fwd": [_P, _P] + [_I] * 6 + [_P, _PP, _P],
    # host array of the 8 band pointers, output, Z, Y, X, tz, ty, tx
    "dwt3_inv": [_P, _P] + [_I] * 6 + [_PP, _P],
    # inverse (0/1), Z, Y, X, tz, ty, tx, host int[5] <- (registers, blocks
    # an SM, shared memory, threads, feed) of the fused volume kernel
    "dwt3_finfo": [_I] * 7 + [_PP, _P],
    "dwt3_sfwd": [_P, _P] + [_I] * 6 + [_PP, _P],
    "dwt3_sinv": [_P, _P] + [_I] * 6 + [_PP, _P],
    # inverse (0/1), tz, ty, tx, host int[4] <- (registers, blocks an SM,
    # shared memory, threads) of the streamed volume kernel a launch runs
    "dwt3_sinfo": [_I] * 4 + [_PP, _P],
    # image (or bands) in, bands (or image) out, h, w, strip rows, band
    # columns, extension rows (0 or 8)
    "dwt_sfwd1": [_P] * 5 + [_I] * 5 + [_PP, _P],
    "dwt_sinv1": [_P] * 5 + [_I] * 5 + [_PP, _P],
    # 7 bands + the frame (in or out), h, w, strip rows, band columns
    "dwt_sfwd2": [_P] * 8 + [_I] * 4 + [_PP, _P],
    "dwt_sinv2": [_P] * 8 + [_I] * 4 + [_PP, _P],
    # inverse (0/1), h, w, strip rows, band columns, host int[4] <-
    # (registers, blocks an SM, grid, shared memory) of the B8/B10 kernel a
    # launch runs
    "dwt_s2info": [_I] * 5 + [_PP, _P],
    # the same for B7/B9: inverse (0/1), h, w, strip rows, band columns,
    # extension rows (0 or 8), host int[4] <- (registers, blocks an SM,
    # grid, shared memory)
    "dwt_s1info": [_I] * 6 + [_PP, _P],
    # frame or output, host array of band pointers, deep levels, h, w, ty,
    # tx, tile, host int[2] <- (grid, resident blocks)
    "dwt_sdeep_fwd": [_P, _P] + [_I] * 6 + [_P, _PP, _P],
    "dwt_sdeep_inv": [_P, _P] + [_I] * 6 + [_P, _PP, _P],
    # the banded body (B13) in B8/B10/B11/B12: the same, with the matrices
    # after the lifting parameters; float32 only
    "dwt_sfwd2_mxu": [_P] * 8 + [_I] * 4 + [_PP, _PM, _P],
    "dwt_sinv2_mxu": [_P] * 8 + [_I] * 4 + [_PP, _PM, _P],
    "dwt_sdeep_fwd_mxu": [_P, _P] + [_I] * 6 + [_P, _PP, _PM, _P],
    "dwt_sdeep_inv_mxu": [_P, _P] + [_I] * 6 + [_P, _PP, _PM, _P],
    # the halo push (B18), typed by element size, so one entry point: host
    # arrays of the line's inputs, outputs and flags, n, host int[] of this
    # launch's shards, count, h, w, halo, t_off, b_off, elem, epoch, host
    # int[2] <- (grid, resident blocks), stream
    "halo_extend_rows": [_P, _P, _P, _I, _P] + [_I] * 7 + [ctypes.c_uint, _P, _P],
    "halo_enable_peer": [_I, _I],
    # the halo gather (B18 on one device): host arrays of channels x n
    # input and output pointers, n, channels, host int[4 * channels] (h, w,
    # t_off, b_off each), halo, elem, host int <- grid, stream
    "halo_gather_rows": [_P, _P, _I, _I, _P, _I, _I, _P, _P],
}
_F32_ONLY = ("dwt_sfwd2_mxu", "dwt_sinv2_mxu", "dwt_sdeep_fwd_mxu", "dwt_sdeep_inv_mxu")
_UNTYPED = ("halo_extend_rows", "halo_enable_peer", "halo_gather_rows")
_SOURCE_OF = {"dwt_fwd2": "fused2l.cu", "dwt_inv2": "fused2l.cu",
              "dwt_deep_fwd": "deep.cu", "dwt_deep_inv": "deep.cu",
              "dwt_fwd1": "level.cu", "dwt_inv1": "level.cu",
              "dwt3_fwd": "fused3d.cu", "dwt3_inv": "fused3d.cu", "dwt3_finfo": "fused3d.cu",
              "dwt3_sfwd": "streamed3d.cu", "dwt3_sinv": "streamed3d.cu",
              "dwt3_sinfo": "streamed3d.cu",
              "dwt_sfwd1": "streamed.cu", "dwt_sinv1": "streamed.cu",
              "dwt_sfwd2": "streamed.cu", "dwt_sinv2": "streamed.cu",
              "dwt_s2info": "streamed.cu", "dwt_s1info": "streamed.cu",
              "dwt_sdeep_fwd": "streamed.cu", "dwt_sdeep_inv": "streamed.cu",
              **{base: "streamed.cu" for base in _F32_ONLY},
              **{base: "remote_halo.cu" for base in _UNTYPED}}
_fns: dict = {}


def _suffixes(base: str):
    if base in _UNTYPED:
        return ("",)
    return ("f32",) if base in _F32_ONLY else ("f32", "i32", "f64")


def kernel_fn(name: str, suffix: str = ""):
    """The C entry point ``<name>_<suffix>`` (suffix 'f32', 'f64' or 'i32';
    the banded body's only 'f32'; none for the halo push and gather, which
    are typed by element size), building and loading the libraries on first use."""
    key = f"{name}_{suffix}" if suffix else name
    if key not in _fns:
        paths = build_all()
        t0 = time.perf_counter()
        libs = {src: ctypes.CDLL(str(p)) for src, p in paths.items()}
        for base, argtypes in _SIGS.items():
            for suf in _suffixes(base):
                sym = f"{base}_{suf}" if suf else base
                fn = getattr(libs[_SOURCE_OF[base]], sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[sym] = fn
        trace.once("cuda.load", time.perf_counter() - t0)
    return _fns[key]


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
