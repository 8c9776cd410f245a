"""Sample images to JPEG files: the denormalisation and the write that
`demo.py:122-132` does (`pggan_tpu/utils/image.py` holds the grid variant)."""

from __future__ import annotations

import numpy as np
import torch


def denorm_to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] floats → uint8 in [0, 255]: clip(x·0.5 + 0.5, 0, 1)·255,
    truncated like numpy's astype. Runs on the images' device, so only
    bytes cross to the host."""
    x = torch.clamp(images.float() * 0.5 + 0.5, 0.0, 1.0)
    return (x * 255.0).to(torch.uint8)


def write_jpeg(path: str, image: np.ndarray) -> None:
    """Write one [H, W, 3] uint8 RGB image with cv2, or PIL where cv2 is
    missing or refuses the write."""
    try:
        import cv2
        if not cv2.imwrite(path, np.ascontiguousarray(image[:, :, ::-1])):
            raise IOError(f"cv2.imwrite returned False for {path}")
    except (ImportError, IOError):
        from PIL import Image
        Image.fromarray(image).save(path, quality=95)
