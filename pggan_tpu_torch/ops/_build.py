"""Build the CUDA sources under `pggan_tpu_torch/csrc/` with nvcc and load
them with ctypes — the counterpart of `pggan_tpu/native/build.py`.

The sources have a plain C interface, so one nvcc call produces a shared
library in seconds (no PyTorch headers, no `torch.utils.cpp_extension`).
The library is written to `pggan_tpu_torch/_build/` under a name keyed by a
hash of the sources and flags, so an edited source is rebuilt at its first
use and an unchanged one is loaded as it is. A failed build raises: there is
no fallback on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_c_void_p, _c_int, _c_int64, _c_float = (ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int64, ctypes.c_float)
# name -> (restype, argtypes) of every C entry point in csrc/.
_SIGNATURES = {
    # x, y, rows, cols, dtype, eps, stream
    "pggan_pixel_norm_fwd": (_c_int, [_c_void_p, _c_void_p, _c_int64, _c_int,
                                      _c_int, _c_float, _c_void_p]),
    # x, y, rows, cols, dtype, slope, eps, stream
    "pggan_lrelu_pixel_norm_fwd": (_c_int, [_c_void_p, _c_void_p, _c_int64,
                                            _c_int, _c_int, _c_float, _c_float,
                                            _c_void_p]),
    "pggan_cuda_error_string": (ctypes.c_char_p, [_c_int]),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cuda_home}/bin and on PATH); the "
            "CUDA kernels of pggan_tpu_torch are built from source at first use")
    return found


def library_path() -> str:
    """Path of the shared library for the current sources and flags."""
    digest = hashlib.sha256()
    for src in _sources():
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + b"\0" + f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libpggan_kernels_{digest.hexdigest()[:16]}.so")


def _compile(so_path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"     # concurrent builds never share a file
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        # ptxas -v reports registers, shared memory and spills per kernel.
        with open(so_path[:-3] + ".log", "w") as log:
            log.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernels' library."""
    global _lib
    with _lock:
        if _lib is None:
            so_path = library_path()
            if not os.path.exists(so_path):
                _compile(so_path)
            lib = ctypes.CDLL(so_path)
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def build_log() -> str:
    """What nvcc and ptxas printed for the current library ('' if it was
    built by an earlier process that left no log)."""
    log = library_path()[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()
