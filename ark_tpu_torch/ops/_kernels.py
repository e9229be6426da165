"""Build and bind the port's hand-written CUDA kernels.

The sources in ``ark_tpu_torch/csrc`` expose plain C functions. They are
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``ark_tpu_torch/_build/`` on first use and loaded with ctypes, the pattern of
``ark_tpu.native`` (g++ there). The library's name carries a hash of its
source, so an edited kernel never loads a stale build. Nothing here runs at
import time: a machine without ``nvcc`` imports the package and runs the
plain versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_BMU = os.path.join(_PKG, "csrc", "bmu.cu")
_BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_bmu_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                           "the CUDA kernels cannot be built")
    return path


def _lib_path(src: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(_BUILD_DIR, f"lib{stem}-{digest}.so")


def build_bmu() -> str:
    """Compile the BMU kernel's source into the build directory unless that
    exact source is built already; return the library's path. Concurrent
    builders are serialised with a file lock, and the library is published
    with an atomic rename, so no process loads a half-written file."""
    src = _SRC_BMU
    lib = _lib_path(src)
    if os.path.exists(lib):
        return lib
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, "build.lock"), "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        if os.path.exists(lib):
            return lib
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib


def bmu_lib() -> ctypes.CDLL:
    """The BMU kernel's library, built on first use."""
    global _bmu_lib
    if _bmu_lib is None:
        lib = ctypes.CDLL(build_bmu())
        p = ctypes.c_void_p
        lib.ark_bmu_launch.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_int, p, p, ctypes.c_int, p]
        lib.ark_bmu_launch.restype = ctypes.c_int
        lib.ark_bmu_error_string.argtypes = [ctypes.c_int]
        lib.ark_bmu_error_string.restype = ctypes.c_char_p
        _bmu_lib = lib
    return _bmu_lib
