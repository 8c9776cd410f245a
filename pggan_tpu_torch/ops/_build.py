"""Build the CUDA sources under `pggan_tpu_torch/csrc/` with nvcc and load
them with ctypes — the counterpart of `pggan_tpu/native/build.py`.

The sources have a plain C interface, so nvcc turns each into a shared
library in seconds (no PyTorch headers, no `torch.utils.cpp_extension`).
Each source is its own library, and all the nvcc processes are started
together, so the build takes as long as the slowest source. A library is
written to `pggan_tpu_torch/_build/` under a name keyed by a hash of its
source and the flags, so an edited source is rebuilt at its first use and
an unchanged one is loaded as it is. A failed build raises: there is no
fallback on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import types
from typing import Dict, List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_BUILD_TIMEOUT_S = 600

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
    # x, y, cols, dtype -> lanes a row, vectors a lane (0, 0: generic branch)
    "pggan_norm_rows_plan": (_c_int, [_c_void_p, _c_void_p, _c_int, _c_int,
                                      ctypes.POINTER(_c_int), ctypes.POINTER(_c_int)]),
    # x, g, dx, rows, cols, dtype, slope, eps, stream
    "pggan_lrelu_pixel_norm_bwd": (_c_int, [_c_void_p, _c_void_p, _c_void_p,
                                            _c_int64, _c_int, _c_int, _c_float,
                                            _c_float, _c_void_p]),
    # x, out, n, f, sg, dtype, eps, stream
    "pggan_minibatch_stddev_stat": (_c_int, [_c_void_p, _c_void_p, _c_int64,
                                             _c_int64, _c_int, _c_int, _c_float,
                                             _c_void_p]),
    # x, b (or null), y, n, cols, x dtype, b dtype, slope, gain, stream
    "pggan_bias_lrelu_gain": (_c_int, [_c_void_p, _c_void_p, _c_void_p, _c_int64,
                                       _c_int, _c_int, _c_int, _c_float, _c_float,
                                       _c_void_p]),
    "pggan_cuda_error_string": (ctypes.c_char_p, [_c_int]),
}

_lock = threading.Lock()
_lib: Optional[types.SimpleNamespace] = None


def _sources() -> List[str]:
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


def _library_path(src: str) -> str:
    digest = hashlib.sha256()
    with open(src, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def library_paths() -> Dict[str, str]:
    """source path -> shared library path, for the current sources and flags."""
    return {src: _library_path(src) for src in _sources()}


def _compile(pending: Dict[str, str]) -> None:
    """Run one nvcc per source, all at once; raise if any failed."""
    if not pending:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src, so_path in pending.items():
        tmp = f"{so_path}.{os.getpid()}.tmp"   # concurrent builds never share a file
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((src, so_path, tmp, cmd, proc))
    failures = []
    for src, so_path, tmp, cmd, proc in jobs:
        try:
            out, err = proc.communicate(timeout=_BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            err += f"\nnvcc timed out after {_BUILD_TIMEOUT_S} s"
        # ptxas -v reports registers, shared memory and spills per kernel.
        with open(so_path[:-3] + ".log", "w") as log:
            log.write(" ".join(cmd) + "\n" + out + err)
        if proc.returncode == 0:
            os.replace(tmp, so_path)
        else:
            failures.append(f"{src}: nvcc failed ({proc.returncode}):\n{err[-4000:]}")
        if os.path.exists(tmp):
            os.unlink(tmp)
    if failures:
        raise RuntimeError("\n".join(failures))


def load_library() -> types.SimpleNamespace:
    """Build (where a source changed) and load the kernels' libraries;
    returns a namespace with every C entry point of `_SIGNATURES`. Once
    loaded, the namespace is returned without taking the lock."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            paths = library_paths()
            _compile({src: so for src, so in paths.items() if not os.path.exists(so)})
            entries = {}
            for so_path in paths.values():
                cdll = ctypes.CDLL(so_path)
                for name, (restype, argtypes) in _SIGNATURES.items():
                    if hasattr(cdll, name):
                        fn = getattr(cdll, name)
                        fn.restype, fn.argtypes = restype, argtypes
                        entries[name] = fn
            missing = sorted(set(_SIGNATURES) - set(entries))
            if missing:
                raise RuntimeError(f"entry points not found in {CSRC_DIR}: {missing}")
            _lib = types.SimpleNamespace(**entries)
        return _lib


def build_log() -> str:
    """What nvcc and ptxas printed for the current libraries ('' for one
    built by an earlier process that left no log)."""
    logs = []
    for so_path in library_paths().values():
        log = so_path[:-3] + ".log"
        if os.path.exists(log):
            with open(log) as f:
                logs.append(f.read())
    return "".join(logs)
