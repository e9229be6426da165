"""Build and bind the port's hand-written CUDA kernels.

The sources in ``ark_tpu_torch/csrc`` expose plain C functions. Each is
compiled with ``nvcc`` for ``sm_90a`` into a shared library of its own under
``ark_tpu_torch/_build/`` on first use and loaded with ctypes, the pattern of
``ark_tpu_torch.native`` (g++ there). A library's name carries a hash of its
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
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_p = ctypes.c_void_p
_i = ctypes.c_int
# library name -> {C function: (argtypes, restype)}
_SIGNATURES = {
    "bmu": {
        "ark_bmu_launch": ([_p, _p, _p, ctypes.c_longlong, _i, _i, _p, _p, _i, _p],
                           _i),
        "ark_bmu_error_string": ([_i], ctypes.c_char_p),
    },
    "watershed_claim": {
        "ark_claim_round_launch": ([_p, _p, ctypes.c_int32, _i, _i, _i, _p, _p, _p],
                                   _i),
        "ark_claim_round_error_string": ([_i], ctypes.c_char_p),
    },
    "segment_sum": {
        "ark_segment_plan_launch": ([_p, ctypes.c_longlong, _i, _i, _p, _p], _i),
        "ark_segment_sum_launch": ([_p, _p, _i, _p, _i, _i, _i, _i, _p, _p], _i),
        "ark_segment_sum_error_string": ([_i], ctypes.c_char_p),
    },
}
KERNELS = tuple(_SIGNATURES)

_libs: dict = {}


def source(name: str) -> str:
    """Path of kernel `name`'s CUDA source."""
    return os.path.join(_PKG, "csrc", f"{name}.cu")


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


def build(name: str) -> str:
    """Compile kernel `name`'s source into the build directory unless that
    exact source is built already; return the library's path. Processes
    building one source are serialised with a file lock of that source
    (other sources build alongside), and the library is published with an
    atomic rename, so no process loads a half-written file."""
    src = source(name)
    lib = _lib_path(src)
    if os.path.exists(lib):
        return lib
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, f"{name}.lock"), "w") as lock_f:
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


def build_all() -> dict:
    """Build every kernel of the port at once (one nvcc per source, all
    started together); returns {name: library path}."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        return dict(zip(KERNELS, pool.map(build, KERNELS)))


def lib(name: str) -> ctypes.CDLL:
    """Kernel `name`'s library with its C functions typed, built on first
    use."""
    if name not in _libs:
        cdll = ctypes.CDLL(build(name))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = restype
        _libs[name] = cdll
    return _libs[name]


def build_bmu() -> str:
    """The BMU kernel's library path (see `build`)."""
    return build("bmu")


def bmu_lib() -> ctypes.CDLL:
    """The BMU kernel's library, built on first use."""
    return lib("bmu")
