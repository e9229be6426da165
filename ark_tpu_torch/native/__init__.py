"""Native (C++) host kernels of the port, built on demand with g++ and
loaded with ctypes: the port's copy of ``ark_tpu/native``.

``watershed.cpp`` holds the sequential algorithms the host postprocess runs
(the priority-flood watershed, 4-connected component labeling). The library
is compiled once into ``ark_tpu_torch/_build/`` (beside the CUDA kernels'
libraries) and rebuilt when the source is newer than it.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import tempfile

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "watershed.cpp")
_LIB = os.path.join(os.path.dirname(_DIR), "_build", "libnative_watershed.so")

_lib = None


def _stale() -> bool:
    return not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)


def _build():
    """Compile to a temporary path, then publish with an atomic rename, so
    no process loads a half-written library; a file lock serialises the
    g++ runs of concurrent processes."""
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    with open(_LIB + ".lock", "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        if not _stale():          # another process built it while we waited
            return
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_LIB))
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
                            "-o", tmp], check=True, capture_output=True)
            os.replace(tmp, _LIB)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def get_lib() -> ctypes.CDLL:
    """The native library with its functions typed, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        _build()
    lib = ctypes.CDLL(_LIB)
    lib.watershed.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32)]
    lib.watershed.restype = None
    lib.label_components.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.label_components.restype = None
    _lib = lib
    return lib
