"""Build the native image loader (`loader.cpp`) with g++ at first use and
load it with ctypes — the counterpart of `pggan_tpu/native/build.py`.

The library goes to `pggan_tpu_torch/_build/` (as the CUDA kernels' do,
`ops/_build.py`) under a name keyed by a hash of the source and the flags,
so an edited source is rebuilt and an unchanged one loaded as it is. Each
build writes a PID-unique temporary and publishes it with `os.replace`, so
processes that build at once never share a file.

Two builds, tried in order:
  * with the codecs: the JAX package's flags, `-ljpeg -lpng`; the loader
    decodes files itself and gives the JAX package's bytes;
  * without them (`-DPGGAN_NO_CODECS`), where libjpeg's or libpng's
    headers are missing: PIL decodes and the library resizes and jitters
    the pixels (`NativeImageLoader` says which, and the build prints why).
When neither builds, `get_loader_lib()` returns None and
`native_available()` is False: `ImageFolderDataset(use_native=None)` then
takes the PIL path, and `use_native=True` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "loader.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX = "g++"
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-fopenmp"]
CODEC_LIBS = ["-ljpeg", "-lpng"]
NO_CODECS = ["-DPGGAN_NO_CODECS"]
_BUILD_TIMEOUT_S = 120

_u8p, _f32p, _i32p = (ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
                      ctypes.POINTER(ctypes.c_int))
_c_int, _c_char_p = ctypes.c_int, ctypes.c_char_p
# name -> argtypes of every entry point of loader.cpp (each returns an int).
_SIGNATURES = {
    # path, size, flip, factors[4], order[4], out
    "pggan_load_image": [_c_char_p, _c_int, _c_int, _f32p, _i32p, _u8p],
    # path, size, out
    "pggan_resize_image": [_c_char_p, _c_int, _u8p],
    # img, size, flip, factors[4], order[4], out
    "pggan_augment_image": [_u8p, _c_int, _c_int, _f32p, _i32p, _u8p],
    # path, &w, &h
    "pggan_probe_image": [_c_char_p, _i32p, _i32p],
    # path, out
    "pggan_decode_image": [_c_char_p, _u8p],
    "pggan_has_codecs": [],
    # rgb, w, h, size, out
    "pggan_resize_pixels": [_u8p, _c_int, _c_int, _c_int, _u8p],
    # rgb, w, h, size, flip, factors[4], order[4], out
    "pggan_load_pixels": [_u8p, _c_int, _c_int, _c_int, _c_int, _f32p, _i32p, _u8p],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _args(codecs: bool) -> List[str]:
    return FLAGS + (CODEC_LIBS if codecs else NO_CODECS)


def library_path(codecs: bool = True) -> str:
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(_args(codecs)).encode())
    name = "libloader" if codecs else "libloader_nocodecs"
    return os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")


def build_library(codecs: bool = True) -> ctypes.CDLL:
    """Build (unless built) and load one of the two libraries; raises
    RuntimeError with the compiler's message when it does not build."""
    so_path = library_path(codecs)
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = [CXX, *FLAGS, *([] if codecs else NO_CODECS), SOURCE, "-o", tmp,
               *(CODEC_LIBS if codecs else [])]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True,
                           timeout=_BUILD_TIMEOUT_S)
            os.replace(tmp, so_path)
        except subprocess.CalledProcessError as exc:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{exc.stderr[-2000:]}") from None
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise RuntimeError(f"{' '.join(cmd)} failed: {exc}") from None
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    try:
        lib = ctypes.CDLL(so_path)
    except OSError as exc:          # e.g. built where libjpeg is, loaded where it is not
        raise RuntimeError(f"{so_path} does not load: {exc}") from None
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = _c_int, argtypes
    return lib


def _first_line(error: RuntimeError) -> str:
    lines = [line for line in str(error).splitlines()[1:] if line.strip()]
    return lines[0].strip() if lines else str(error)[-300:]


def get_loader_lib() -> Optional[ctypes.CDLL]:
    """The loader with the codecs, else without them, else None; built
    once a process. Prints why a build failed."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = build_library(codecs=True)
            except RuntimeError as with_codecs:
                try:
                    _lib = build_library(codecs=False)
                    print(f"[pggan_tpu_torch.native] built without libjpeg/libpng "
                          f"({_first_line(with_codecs)}): PIL decodes the files, the "
                          f"loader resizes and jitters them")
                except RuntimeError as without:
                    print(f"[pggan_tpu_torch.native] the loader does not build: "
                          f"{without}")
        return _lib


def native_available() -> bool:
    return get_loader_lib() is not None
