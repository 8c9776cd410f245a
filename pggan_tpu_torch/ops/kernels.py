"""Wrappers of the hand-written CUDA kernels, their plain PyTorch versions,
and the launch counters — the counterpart of `pggan_tpu/ops/pallas_kernels.py`.

| wrapper            | CUDA entry point (csrc/norm_kernels.cu) | replaces (Pallas)                     |
|--------------------|-----------------------------------------|---------------------------------------|
| `pixel_norm`       | `pggan_pixel_norm_fwd`                  | `_pixel_norm_kernel` via `pixel_norm` |
| `lrelu_pixel_norm` | `pggan_lrelu_pixel_norm_fwd`            | `_lrelu_pn_fwd_kernel` via            |
|                    |                                         | `lrelu_pixel_norm`                    |

The device decides the path: on a CPU tensor a wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises. It never copies
its input into another layout and never falls back to the plain version.

Layout: the normalised axis is the channel axis. A 2-D input is a contiguous
[B, C] tensor; a 4-D input is a logical NCHW tensor in `torch.channels_last`
memory, whose bytes are the NHWC rows [B·H·W, C] the kernels read.

Forward only: there is no backward kernel yet, so on a CUDA tensor that
requires grad (with grad mode on) the wrappers raise instead of returning a
result autograd cannot differentiate.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pggan_tpu_torch.ops import _build

EPS = 1e-8

# Kernel launches per wrapper since the last `reset_launch_counts()`.
launches = {"pixel_norm": 0, "lrelu_pixel_norm": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _check_rank(x: torch.Tensor) -> None:
    """[B, C] or [B, C, H, W]: the channel axis is dim 1 in both."""
    if x.ndim not in (2, 4):
        raise ValueError(f"expected a 2-D [B, C] or 4-D [B, C, H, W] tensor, "
                         f"got shape {tuple(x.shape)}")


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, tests, and the comparison on the card)
# ---------------------------------------------------------------------------

def pixel_norm_plain(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """x · rsqrt(mean_C(x²) + eps), math in f32, output in x's dtype."""
    _check_rank(x)
    xf = x.float()
    inv = torch.rsqrt(xf.square().mean(dim=1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype)


def lrelu_pixel_norm_plain(x: torch.Tensor, slope: float = 0.2,
                           eps: float = EPS) -> torch.Tensor:
    """pixel_norm(leaky_relu(x, slope)), math in f32, output in x's dtype."""
    _check_rank(x)
    xf = x.float()
    z = torch.where(xf >= 0, xf, xf * slope)
    inv = torch.rsqrt(z.square().mean(dim=1, keepdim=True) + eps)
    return (z * inv).to(x.dtype)


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

def kernel_rows(x: torch.Tensor) -> Tuple[int, int]:
    """Check that the row kernels take `x` as it is; return the (rows, cols)
    of its row-major [M, C] view. Reads only metadata, so it runs on any
    device; raises on dtype, rank, layout or a pending gradient."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    _check_rank(x)
    if x.ndim == 2 and not x.is_contiguous():
        raise ValueError("a 2-D input must be contiguous [B, C]")
    if x.ndim == 4 and not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(
            "a 4-D input must be channels_last-contiguous (NHWC memory); got "
            f"strides {x.stride()} for shape {tuple(x.shape)}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            "the forward kernels have no backward yet: call them under "
            "torch.no_grad() or on a tensor that does not require grad")
    cols = x.shape[1]
    if cols == 0:
        raise ValueError("the channel axis is empty")
    return x.numel() // cols, cols


def _launch(name: str, entry: str, x: torch.Tensor, *scalars: float) -> torch.Tensor:
    rows, cols = kernel_rows(x)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    lib = _build.load_library()
    fmt = torch.channels_last if x.ndim == 4 else torch.contiguous_format
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device, memory_format=fmt)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(x.data_ptr(), y.data_ptr(), rows, cols,
                                  _DTYPE_CODES[x.dtype], *scalars, stream)
    if err != 0:
        msg = lib.pggan_cuda_error_string(err).decode()
        raise RuntimeError(f"{entry} failed to launch: CUDA error {err} ({msg})")
    launches[name] += 1
    return y


def pixel_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Pixel normalisation over the channel axis (`pallas_kernels.pixel_norm`)."""
    if x.device.type == "cpu":
        return pixel_norm_plain(x, eps)
    return _launch("pixel_norm", "pggan_pixel_norm_fwd", x, float(eps))


def lrelu_pixel_norm(x: torch.Tensor, slope: float = 0.2,
                     eps: float = EPS) -> torch.Tensor:
    """pixel_norm(leaky_relu(x)) in one pass (`pallas_kernels.lrelu_pixel_norm`)."""
    if x.device.type == "cpu":
        return lrelu_pixel_norm_plain(x, slope, eps)
    return _launch("lrelu_pixel_norm", "pggan_lrelu_pixel_norm_fwd", x,
                   float(slope), float(eps))
