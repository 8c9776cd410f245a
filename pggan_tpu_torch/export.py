"""The serving artifact: a trained generator as one `torch.export` program —
the counterpart of `pggan_tpu/export.py`.

`export_generator` captures `z ↦ G(z, alpha)` with `torch.export` and saves
it with `torch.export.save` into one `.pt2` archive: the graph of the
forward and the weights, with the batch dimension symbolic by default, so
one artifact serves any batch size. `load_exported` reads it back, on
another device if asked (an artifact exported on a host without a card
serves on the card), and `sample` turns latents into uint8 images.

What serving needs: torch, and the port's two operator registrations,
`pggan::pixel_norm` and `pggan::lrelu_pixel_norm` (`import
pggan_tpu_torch.ops.kernels`, which this module does), because the G
epilogues stay calls of the hand-written kernels inside the graph (on a
CPU tensor they run the plain versions). No model class and no checkpoint
code is needed. That is unlike the JAX package's StableHLO artifact, which
needs no package code at all. The kernels are ctypes libraries built on
first use (`ops/_build.py`), not C++ torch operators, so the artifact is not
packaged for AOTInductor.
"""

from __future__ import annotations

import copy
import io
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from pggan_tpu_torch.models.generator import Generator, params_from_jax
from pggan_tpu_torch.ops import kernels  # noqa: F401  (registers the pggan:: ops)
from pggan_tpu_torch.utils.image import denorm_to_uint8

Source = Union[str, os.PathLike, bytes]

# Generator settings an export may set; the rest of apply_kwargs goes to
# the forward.
_MODULE_OPTIONS = ("slope", "apply_pixel_norm", "last_activation", "fused_scale")


class _Sampler(nn.Module):
    """z ↦ G(z, alpha) with alpha and the compute dtype fixed."""

    def __init__(self, generator: Generator, alpha: float, compute_dtype: torch.dtype):
        super().__init__()
        self.generator = generator
        self.alpha = float(alpha)
        self.compute_dtype = compute_dtype

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.generator(z, self.alpha, compute_dtype=self.compute_dtype)


def export_generator(params: Union[Dict[str, Any], Generator], *, latent_dim: int,
                     alpha: float = 1.0, batch: Optional[int] = None,
                     path: Optional[str] = None, device="cuda",
                     **apply_kwargs) -> bytes:
    """Export `z ↦ G(z, alpha)` and return the saved `.pt2` bytes (also
    written to `path` when given).

    `params` is the JAX package's arrays dict (a checkpoint's `G` params)
    or a `Generator`. The program takes float32 latents [b, latent_dim] on
    `device`, b symbolic when `batch` is None and pinned otherwise, and
    returns images [b, R, R, 3]. `alpha` is baked in (a served model's fade
    is fixed: pass the checkpoint's alpha). `apply_kwargs`: `slope`,
    `apply_pixel_norm`, `last_activation`, `fused_scale` set the
    generator's own options; `compute_dtype` (a torch dtype) goes to the
    forward."""
    options = {k: apply_kwargs.pop(k) for k in _MODULE_OPTIONS if k in apply_kwargs}
    compute_dtype = apply_kwargs.pop("compute_dtype", torch.float32)
    if apply_kwargs:
        raise TypeError(f"unknown apply_kwargs {sorted(apply_kwargs)}")
    if isinstance(params, Generator):
        generator = copy.deepcopy(params)
        for key, value in options.items():
            setattr(generator, key, value)
    else:
        generator = params_from_jax(params, **options)
    generator = generator.to(device).eval().requires_grad_(False)
    module = _Sampler(generator, alpha, compute_dtype)
    example = torch.zeros((2 if batch is None else int(batch), int(latent_dim)),
                          device=device)
    dynamic = None if batch is not None else ({0: torch.export.Dim("b", min=1)},)
    program = torch.export.export(module, (example,), dynamic_shapes=dynamic)
    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    data = buffer.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def _program_device(program: torch.export.ExportedProgram) -> torch.device:
    """The device of the program's weights."""
    for tensor in program.state_dict.values():
        return tensor.device
    return torch.device("cpu")


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether a and b name one device ('cuda' names the current card)."""
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def load_exported(src: Source, device=None) -> torch.export.ExportedProgram:
    """An artifact (a path or the bytes) → `torch.export.ExportedProgram`;
    call `program.module()(z)` to sample. With `device` other than the one
    it was exported on, the program and its weights are moved there
    (`torch.export.passes.move_to_device_pass`)."""
    if isinstance(src, (bytes, bytearray)):
        program = torch.export.load(io.BytesIO(bytes(src)))
    else:
        program = torch.export.load(os.fspath(src))
    if device is not None and not _same_device(_program_device(program), torch.device(device)):
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, torch.device(device))
    return program


def sample(src: Source, latents, device=None) -> np.ndarray:
    """Load an artifact, run the latents through it on its device (or on
    `device`) and return uint8 images [B, R, R, 3] on the host, denormalised
    ×0.5+0.5 → [0, 255] as the demo writes them."""
    program = load_exported(src, device)
    z = (latents.float() if isinstance(latents, torch.Tensor)
         else torch.from_numpy(np.asarray(latents, np.float32)))
    with torch.no_grad():
        images = program.module()(z.to(_program_device(program)))
    return denorm_to_uint8(images).cpu().numpy()
