"""The native C++ image loader (`loader.cpp`, built at first use by
`build.py`, called through ctypes by `loader.py`)."""

from pggan_tpu_torch.native.build import get_loader_lib, native_available  # noqa: F401
from pggan_tpu_torch.native.loader import NativeImageLoader  # noqa: F401
