"""Sample images to JPEG files: the denormalisation and the write that
`demo.py:122-132` does, and the trainer's [real, fake] sample grid
(`pggan_tpu/utils/image.py:32-78`)."""

from __future__ import annotations

import os
from typing import List, Sequence

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


def make_grid_image(list_of_batches: Sequence[np.ndarray], *,
                    max_per_row: int = 8, pad: int = 2) -> np.ndarray:
    """One row per batch, at most `max_per_row` images side by side with
    `pad` pixels around each, as torchvision's make_grid lays them out.
    NHWC float arrays in [-1, 1] in, HWC float in [0, 1] out."""
    rows: List[np.ndarray] = []
    width = None
    for batch in list_of_batches:
        batch = np.asarray(batch)[:max_per_row]
        n, h, w, c = batch.shape
        canvas = np.zeros((h + 2 * pad, n * (w + pad) + pad, c), np.float32)
        for i in range(n):
            x0 = pad + i * (w + pad)
            canvas[pad:pad + h, x0:x0 + w] = batch[i]
        canvas = canvas * 0.5 + 0.5
        if width is None:
            width = canvas.shape[1]
        if canvas.shape[1] < width:
            canvas = np.pad(canvas, ((0, 0), (0, width - canvas.shape[1]), (0, 0)))
        elif canvas.shape[1] > width:
            width = canvas.shape[1]
            rows = [np.pad(r, ((0, 0), (0, width - r.shape[1]), (0, 0))) for r in rows]
        rows.append(canvas)
    return np.clip(np.concatenate(rows, axis=0), 0.0, 1.0)


def save_image(save_root: str, run_id: str, global_step: int, subdir: str,
               list_of_batches: Sequence[np.ndarray]) -> str:
    """Write the grid of `list_of_batches` to
    {save_root}/{run_id}/{subdir}/e{global_step}.jpg; returns the path."""
    dir_path = os.path.join(str(save_root), str(run_id), subdir)
    os.makedirs(dir_path, exist_ok=True)
    grid = (make_grid_image(list_of_batches) * 255.0).astype(np.uint8)
    path = os.path.join(dir_path, f"e{global_step}.jpg")
    write_jpeg(path, grid)
    return path
