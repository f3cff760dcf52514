"""ctypes loader for the native C++ backend (native/libdwt_tpu_native.so).

The port's own copy of ``libdwt_tpu.utils.nativelib``: it loads the same
library, built by ``make -C native`` from ``native/Makefile``, under the
same lock file (``native/.build.lock``), so that the two packages never
rebuild it while the other maps it.  The library supplies the text codecs
(PGM/MAT/SVM) and the host runtime helpers (affinity, realtime
scheduling, page-fault counters) of libdwt's system layer.  Every caller
degrades gracefully when it is absent: :mod:`libdwt_torch.utils.io` and
:mod:`libdwt_torch.utils.perf` have pure-Python fallbacks.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SO_PATH = os.path.join(_HERE, "native", "libdwt_tpu_native.so")

c_i64 = ctypes.c_int64
c_i64_p = ctypes.POINTER(ctypes.c_int64)
c_f32_p = ctypes.POINTER(ctypes.c_float)
c_u8_p = ctypes.POINTER(ctypes.c_uint8)


def _try_build() -> None:
    mk = os.path.join(_HERE, "native", "Makefile")
    if not os.path.exists(mk):
        return
    # serialize concurrent builds (pytest -n N on a clean checkout, both
    # packages): without the lock the linker rewrites the .so while
    # another process maps it
    lock_path = os.path.join(os.path.dirname(mk), ".build.lock")
    try:
        import fcntl

        with open(lock_path, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(_SO_PATH):
                subprocess.run(
                    ["make", "-C", os.path.dirname(mk)],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
    except Exception:
        pass


def get() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None if unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO_PATH):
        _try_build()
    if not os.path.exists(_SO_PATH):
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None

    lib.ldt_pgm_probe.argtypes = [ctypes.c_char_p, c_i64_p, c_i64_p, c_i64_p]
    lib.ldt_pgm_read.argtypes = [ctypes.c_char_p, c_f32_p, c_i64, c_i64]
    lib.ldt_pgm_write_p2.argtypes = [ctypes.c_char_p, c_f32_p, c_i64, c_i64, c_i64]
    lib.ldt_pgm_write_p5.argtypes = [ctypes.c_char_p, c_u8_p, c_i64, c_i64]
    lib.ldt_mat_probe.argtypes = [ctypes.c_char_p, c_i64_p, c_i64_p]
    lib.ldt_mat_read.argtypes = [ctypes.c_char_p, c_f32_p, c_i64, c_i64]
    lib.ldt_mat_write.argtypes = [ctypes.c_char_p, c_f32_p, c_i64, c_i64]
    lib.ldt_svm_write.argtypes = [ctypes.c_char_p, c_f32_p, c_f32_p, c_i64, c_i64]
    lib.ldt_set_affinity.argtypes = [ctypes.c_int]
    lib.ldt_set_realtime.argtypes = []
    lib.ldt_page_faults.argtypes = [c_i64_p, c_i64_p]
    lib.ldt_host_info.argtypes = [c_i64_p, c_i64_p, c_i64_p]
    for fn in (
        "ldt_pgm_probe", "ldt_pgm_read", "ldt_pgm_write_p2", "ldt_pgm_write_p5",
        "ldt_mat_probe", "ldt_mat_read", "ldt_mat_write", "ldt_svm_write",
        "ldt_set_affinity", "ldt_set_realtime", "ldt_page_faults", "ldt_host_info",
    ):
        getattr(lib, fn).restype = ctypes.c_int
    _LIB = lib
    return _LIB


def available() -> bool:
    return get() is not None
