"""Python face of the native C++ image loader — the counterpart of
`pggan_tpu/native/loader.py`."""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
from PIL import Image

from pggan_tpu_torch.data.augment import draw_augment_params
from pggan_tpu_torch.native.build import get_loader_lib

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _ptr(arr: np.ndarray, ctype=ctypes.c_uint8):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativeImageLoader:
    """Decode (libjpeg/libpng), antialiased resize and torchvision-order
    colour jitter in C++, a drop-in for the PIL path of
    `ImageFolderDataset`. ctypes releases the GIL for each call, so the
    pipeline's worker threads run on separate cores.

    `decoder` is 'native' when the library was built with the codecs, else
    'PIL': PIL decodes the file (releasing the GIL while it does) and the
    library resizes and jitters the pixels with the same arithmetic. `lib`
    takes a library from `build.build_library` in place of the process's
    own (`get_loader_lib`)."""

    def __init__(self, resolution: int, *, augment: bool = True,
                 brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.2, hue: float = 0.01,
                 lib: Optional[ctypes.CDLL] = None):
        self.lib = lib if lib is not None else get_loader_lib()
        if self.lib is None:
            raise RuntimeError("native loader unavailable (build failed)")
        self.decoder = "native" if self.lib.pggan_has_codecs() else "PIL"
        self.resolution = int(resolution)
        self.augment = augment
        self.jitter = (brightness, contrast, saturation, hue)

    def _draw_augment(self, rng: Optional[np.random.RandomState]):
        """The draws in the fixed order (flip, 4 factors, shuffle) of
        `data/augment.py`, which the device cache shares."""
        return draw_augment_params(rng, self.jitter, self.augment)

    @staticmethod
    def _pixels(path: str) -> np.ndarray:
        """PIL's decode to C-contiguous uint8 [h, w, 3]."""
        with Image.open(path) as img:
            return np.ascontiguousarray(np.asarray(img.convert("RGB"), dtype=np.uint8))

    def load(self, path: str, rng: Optional[np.random.RandomState] = None
             ) -> np.ndarray:
        """Decode, resize and (with `rng`) flip and jitter, rounding once."""
        size = self.resolution
        out = np.empty((size, size, 3), np.uint8)
        flip, factors, order = self._draw_augment(rng)
        args = (size, flip, _ptr(factors, ctypes.c_float), _ptr(order, ctypes.c_int),
                _ptr(out))
        if self.decoder == "native":
            rc = self.lib.pggan_load_image(path.encode(), *args)
        else:
            rgb = self._pixels(path)
            rc = self.lib.pggan_load_pixels(_ptr(rgb), rgb.shape[1], rgb.shape[0], *args)
        if rc != 0:
            raise IOError(f"native decode failed ({rc}): {path}")
        return out

    def resize(self, path: str) -> np.ndarray:
        """Decode and antialiased resize only: fills the decode cache."""
        size = self.resolution
        out = np.empty((size, size, 3), np.uint8)
        if self.decoder == "native":
            rc = self.lib.pggan_resize_image(path.encode(), size, _ptr(out))
        else:
            rgb = self._pixels(path)
            rc = self.lib.pggan_resize_pixels(_ptr(rgb), rgb.shape[1], rgb.shape[0], size,
                                              _ptr(out))
        if rc != 0:
            raise IOError(f"native decode failed ({rc}): {path}")
        return out

    def augment_cached(self, img: np.ndarray,
                       rng: Optional[np.random.RandomState]) -> np.ndarray:
        """Per-draw flip and jitter over a cached resized uint8 image."""
        size = self.resolution
        if img.shape != (size, size, 3) or img.dtype != np.uint8:
            raise ValueError(f"expected uint8 {(size, size, 3)}, got {img.dtype} {img.shape}")
        img = np.ascontiguousarray(img)
        out = np.empty((size, size, 3), np.uint8)
        flip, factors, order = self._draw_augment(rng)
        rc = self.lib.pggan_augment_image(
            _ptr(img), size, flip, _ptr(factors, ctypes.c_float),
            _ptr(order, ctypes.c_int), _ptr(out))
        if rc != 0:
            raise IOError("native augment failed")
        return out

    def decode(self, path: str) -> np.ndarray:
        """The decode at the source's resolution (tests and benchmarks)."""
        if self.decoder != "native":
            return self._pixels(path)
        w, h = ctypes.c_int(), ctypes.c_int()
        if self.lib.pggan_probe_image(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
            raise IOError(f"native probe failed: {path}")
        out = np.empty((h.value, w.value, 3), np.uint8)
        if self.lib.pggan_decode_image(path.encode(), _ptr(out)) != 0:
            raise IOError(f"native decode failed: {path}")
        return out
