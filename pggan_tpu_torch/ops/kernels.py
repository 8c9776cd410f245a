"""Wrappers of the hand-written CUDA kernels, their plain PyTorch versions,
their autograd rules and the launch counters — the counterpart of
`pggan_tpu/ops/pallas_kernels.py`.

| wrapper                 | CUDA entry point (csrc/)                    | replaces (Pallas)               |
|-------------------------|---------------------------------------------|---------------------------------|
| `pixel_norm`            | `pggan_pixel_norm_fwd` (norm_kernels.cu)    | `_pixel_norm_kernel`            |
| `lrelu_pixel_norm`      | `pggan_lrelu_pixel_norm_fwd` (norm_kernels) | `_lrelu_pn_fwd_kernel`          |
| `lrelu_pixel_norm_bwd`  | `pggan_lrelu_pixel_norm_bwd` (norm_kernels) | `_lrelu_pn_bwd_kernel`          |
| `minibatch_stddev_stat` | `pggan_minibatch_stddev_stat` (mb_stddev)   | `_mb_stddev_kernel`             |
| `bias_lrelu_gain`       | `pggan_bias_lrelu_gain` (bias_act.cu)       | `_bias_lrelu_kernel`            |

The device decides the path: on a CPU tensor a wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises. It never copies
its input into another layout and never falls back to the plain version.
While `torch.export` traces a program, `pixel_norm` and `lrelu_pixel_norm`
call the registered operators `pggan::pixel_norm` and
`pggan::lrelu_pixel_norm` instead, which run the same forwards when the
exported program runs (`pggan_tpu_torch/export.py`).

Differentiation follows the JAX package. `pixel_norm`,
`minibatch_stddev_stat` and `bias_lrelu_gain` are `custom_jvp`s there, so
their backward here is written in differentiable torch ops
(`pallas_kernels.py:80-90`, `:293-300` and `:133-141`): R1's double
backward, which runs through D's minibatch-stddev, composes.
`lrelu_pixel_norm` is a `custom_vjp` there, first order only (G is
differentiated once), so its backward is the backward kernel, marked
`once_differentiable`. Where autograd will not record the call (x does not
require grad, or grad is disabled, as when sampling), `pixel_norm`,
`lrelu_pixel_norm` and `minibatch_stddev_stat` call their forward without
the `autograd.Function`, whose `apply` costs more host time than a small
launch.

Layout: the normalised axis is the channel axis. A 2-D input is a contiguous
[B, C] tensor; a 4-D input is a logical NCHW tensor in `torch.channels_last`
memory, whose bytes are the NHWC rows [B·H·W, C] the row kernels read. The
minibatch-stddev kernel reads one contiguous row of F = C·H·W values per
sample (a channels_last or contiguous 4-D tensor, or a contiguous 2-D one).
The bias-act kernel reads any tensor whose channel axis (`dim`) is innermost
in memory and whose other axes are dense: a contiguous [B, C] or
channels_last [B, C, H, W] tensor with dim 1, or a contiguous one with dim -1.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from pggan_tpu_torch.ops import _build

EPS = 1e-8
SQRT2 = math.sqrt(2.0)

# Kernel launches per CUDA entry point since the last `reset_launch_counts()`.
launches = {"pixel_norm": 0, "lrelu_pixel_norm": 0, "lrelu_pixel_norm_bwd": 0,
            "minibatch_stddev_stat": 0, "bias_lrelu_gain": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _check_rank(x: torch.Tensor) -> None:
    """[B, C] or [B, C, H, W]: the channel axis is dim 1 in both."""
    if x.ndim not in (2, 4):
        raise ValueError(f"expected a 2-D [B, C] or 4-D [B, C, H, W] tensor, "
                         f"got shape {tuple(x.shape)}")


def _row_format(x: torch.Tensor) -> torch.memory_format:
    return torch.channels_last if x.ndim == 4 else torch.contiguous_format


def subgroup_size(n: int, subgroup: int = 4) -> int:
    """min(n, subgroup), or n when n is not a multiple of it
    (`pggan_tpu/ops/basic.py:143-145`)."""
    sg = min(n, subgroup)
    return n if n % sg != 0 else sg


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


def lrelu_pixel_norm_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                               slope: float = 0.2, eps: float = EPS) -> torch.Tensor:
    """The vector-Jacobian product of `lrelu_pixel_norm` at x with cotangent
    g (`_lrelu_pn_bwd_kernel`, `pallas_kernels.py:186-195`):
    lrelu'(x) · (inv·g − z·inv³·mean_C(z·g)). Math in f32, output in x's
    dtype."""
    _check_rank(x)
    xf, gf = x.float(), g.float()
    z = torch.where(xf >= 0, xf, xf * slope)
    inv = torch.rsqrt(z.square().mean(dim=1, keepdim=True) + eps)
    dz = inv * gf - z * (inv * inv * inv) * (z * gf).mean(dim=1, keepdim=True)
    return torch.where(xf >= 0, dz, dz * slope).to(x.dtype)


def _groups(x: torch.Tensor, sg: int) -> torch.Tensor:
    """x as f32 [groups, sg, F] (F in logical order: any order is the same
    statistic, as long as every sample uses the same one)."""
    n = x.shape[0]
    return x.float().reshape(n // sg, sg, -1)


def minibatch_stddev_stat_plain(x: torch.Tensor, sg: int,
                                eps: float = EPS) -> torch.Tensor:
    """[N, ...] → [N // sg] f32: per group of sg samples, the unbiased
    variance over the group of each feature, sqrt(var + eps), averaged over
    the features (`_mb_stddev_stat_ref`, `pallas_kernels.py:264-269`)."""
    _check_groups(x, sg)
    var = _groups(x, sg).var(dim=1, unbiased=True)
    return torch.sqrt(var + eps).mean(dim=-1)


def along(b: torch.Tensor, ndim: int, dim: int) -> torch.Tensor:
    """The [C] vector b viewed to broadcast along axis `dim` of an ndim-D tensor."""
    shape = [1] * ndim
    shape[dim] = b.shape[0]
    return b.reshape(shape)


def bias_lrelu_gain_plain(x: torch.Tensor, b: Optional[torch.Tensor] = None,
                          slope: float = 0.2, gain: float = SQRT2,
                          dim: int = 1) -> torch.Tensor:
    """leaky_relu(x + b, slope) · gain with b broadcast along `dim`; math in
    f32, one rounding to x's dtype (`_bias_lrelu_kernel`,
    `pallas_kernels.py:97-100`). b None is a zero bias."""
    z = x.float()
    if b is not None:
        z = z + along(b.float(), x.ndim, dim)
    return (torch.where(z >= 0, z, z * slope) * gain).to(x.dtype)


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

def _check_dtype(x: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")


def kernel_rows(x: torch.Tensor) -> Tuple[int, int]:
    """Check that the row kernels take `x` as it is; return the (rows, cols)
    of its row-major [M, C] view. Reads only metadata, so it runs on any
    device; raises on dtype, rank or layout."""
    _check_dtype(x)
    _check_rank(x)
    if x.ndim == 2 and not x.is_contiguous():
        raise ValueError("a 2-D input must be contiguous [B, C]")
    if x.ndim == 4 and not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(
            "a 4-D input must be channels_last-contiguous (NHWC memory); got "
            f"strides {x.stride()} for shape {tuple(x.shape)}")
    cols = x.shape[1]
    if cols == 0:
        raise ValueError("the channel axis is empty")
    return x.numel() // cols, cols


def _check_groups(x: torch.Tensor, sg: int) -> None:
    n = x.shape[0] if x.ndim else 0
    if x.ndim < 2 or n == 0:
        raise ValueError(f"expected [N, ...] samples, got shape {tuple(x.shape)}")
    if sg < 2 or n % sg != 0:
        raise ValueError(f"subgroup size {sg} must be >= 2 and divide N = {n}")


def kernel_samples(x: torch.Tensor, sg: int) -> Tuple[int, int]:
    """Check that the minibatch-stddev kernel takes `x` as it is; return
    (N, F). Each sample must be one contiguous row of F values in the same
    order: a channels_last 4-D tensor (the path's layout, checked first) or
    a contiguous one."""
    _check_dtype(x)
    _check_groups(x, sg)
    if not (x.is_contiguous(memory_format=_row_format(x)) or x.is_contiguous()):
        raise ValueError(
            "the minibatch-stddev input must be contiguous or channels_last; got "
            f"strides {x.stride()} for shape {tuple(x.shape)}")
    n = x.shape[0]
    return n, x.numel() // n


def kernel_channels(x: torch.Tensor, dim: int = 1) -> Tuple[int, int]:
    """Check that the bias-act kernel takes `x` as it is, with its channel
    axis at `dim`; return (elements, channels). The channel axis must be
    innermost in memory and the other axes dense (`x.movedim(dim, -1)` is
    contiguous). Reads only metadata; raises on dtype, rank or layout."""
    _check_dtype(x)
    if x.ndim < 2:
        raise ValueError(f"expected a tensor of 2 or more dims, got shape {tuple(x.shape)}")
    if not x.movedim(dim, -1).is_contiguous():
        raise ValueError(
            f"the channel axis (dim {dim}) must be innermost in memory and the others "
            f"dense (channels_last for a 4-D tensor with dim 1); got strides "
            f"{x.stride()} for shape {tuple(x.shape)}")
    cols = x.shape[dim]
    if cols == 0:
        raise ValueError("the channel axis is empty")
    return x.numel(), cols


def _cuda_or_raise(name: str, x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: no kernel for device {x.device}")


def _call(name: str, entry: str, x: torch.Tensor, *args) -> None:
    """Launch `entry` on the current stream of x's card. The host work is
    kept to a minimum: no lock once the library is loaded, the raw stream
    handle without a `torch.cuda.Stream` object (the CUDA build of torch has
    `_cuda_getCurrentRawStream`; the CPU build does not, and never gets
    here), and a device switch only when x is not on the current device."""
    lib = _build.load_library()
    index = x.get_device()
    raw_stream = torch._C._cuda_getCurrentRawStream
    if index == torch._C._cuda_getDevice():
        err = getattr(lib, entry)(*args, raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = getattr(lib, entry)(*args, raw_stream(index))
    if err != 0:
        msg = lib.pggan_cuda_error_string(err).decode()
        raise RuntimeError(f"{entry} failed to launch: CUDA error {err} ({msg})")
    launches[name] += 1


def _launch_rows(name: str, entry: str, x: torch.Tensor, *scalars: float) -> torch.Tensor:
    rows, cols = kernel_rows(x)
    _cuda_or_raise(name, x)
    # kernel_rows has checked that x is dense in its row layout (a contiguous
    # [B, C] or a channels_last [B, C, H, W]), so y gets x's strides.
    y = torch.empty_like(x)
    _call(name, entry, x, x.data_ptr(), y.data_ptr(), rows, cols,
          _DTYPE_CODES[x.dtype], *scalars)
    return y


def row_kernel_plan(x: torch.Tensor,
                    g: Optional[torch.Tensor] = None) -> Tuple[int, int]:
    """The branch the forward row kernels take for x, or the backward for x
    and its gradient g, each with an output of its own (a fresh allocation,
    16-byte aligned): (lanes a row, 16-byte vectors a lane) for the vector
    branch, (0, 0) for the generic one. The C side decides; this asks it,
    and reads no memory behind the pointers."""
    _, cols = kernel_rows(x)
    lanes, vecs = ctypes.c_int(), ctypes.c_int()
    err = _build.load_library().pggan_norm_rows_plan(
        x.data_ptr(), 0 if g is None else g.data_ptr(), cols, _DTYPE_CODES[x.dtype],
        ctypes.byref(lanes), ctypes.byref(vecs))
    if err != 0:
        raise RuntimeError(f"pggan_norm_rows_plan: CUDA error {err}")
    return lanes.value, vecs.value


def minibatch_stddev_plan(x: torch.Tensor, sg: int) -> int:
    """The branch the minibatch-stddev kernel takes for x: the values one
    load reads, 4 (f32) or 8 (bf16) on the 16-byte vector branch, 1 on the
    generic one. The C side decides; this asks it."""
    _, f = kernel_samples(x, sg)
    per_load = ctypes.c_int()
    err = _build.load_library().pggan_minibatch_stddev_plan(
        x.data_ptr(), f, _DTYPE_CODES[x.dtype], ctypes.byref(per_load))
    if err != 0:
        raise RuntimeError(f"pggan_minibatch_stddev_plan: CUDA error {err}")
    return per_load.value


def _pixel_norm_fwd(x: torch.Tensor, eps: float) -> torch.Tensor:
    if x.is_cpu:
        return pixel_norm_plain(x, eps)
    return _launch_rows("pixel_norm", "pggan_pixel_norm_fwd", x, float(eps))


def _lrelu_pixel_norm_fwd(x: torch.Tensor, slope: float, eps: float) -> torch.Tensor:
    if x.is_cpu:
        return lrelu_pixel_norm_plain(x, slope, eps)
    return _launch_rows("lrelu_pixel_norm", "pggan_lrelu_pixel_norm_fwd", x,
                        float(slope), float(eps))


def lrelu_pixel_norm_bwd(x: torch.Tensor, g: torch.Tensor, slope: float = 0.2,
                         eps: float = EPS) -> torch.Tensor:
    """The backward of `lrelu_pixel_norm` (`_lrelu_pn_bwd_kernel`): dx for
    the saved input x and the output's gradient g. g must have x's shape,
    dtype and layout."""
    if x.is_cpu:
        return lrelu_pixel_norm_bwd_plain(x, g, slope, eps)
    rows, cols = kernel_rows(x)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(
            f"g must match x: got {tuple(g.shape)} {g.dtype} on {g.device} for "
            f"x {tuple(x.shape)} {x.dtype} on {x.device}")
    kernel_rows(g)
    _cuda_or_raise("lrelu_pixel_norm_bwd", x)
    dx = torch.empty_like(x)           # x is dense in its row layout: x's strides
    _call("lrelu_pixel_norm_bwd", "pggan_lrelu_pixel_norm_bwd", x,
          x.data_ptr(), g.data_ptr(), dx.data_ptr(), rows, cols,
          _DTYPE_CODES[x.dtype], float(slope), float(eps))
    return dx


def _minibatch_stddev_stat_fwd(x: torch.Tensor, sg: int, eps: float) -> torch.Tensor:
    if x.is_cpu:
        return minibatch_stddev_stat_plain(x, sg, eps)
    n, f = kernel_samples(x, sg)
    _cuda_or_raise("minibatch_stddev_stat", x)
    out = x.new_empty((n // sg,), dtype=torch.float32)
    _call("minibatch_stddev_stat", "pggan_minibatch_stddev_stat", x,
          x.data_ptr(), out.data_ptr(), n, f, int(sg), _DTYPE_CODES[x.dtype],
          float(eps))
    return out


def _bias_lrelu_gain_fwd(x: torch.Tensor, b: Optional[torch.Tensor], slope: float,
                         gain: float, dim: int) -> torch.Tensor:
    if x.is_cpu:
        return bias_lrelu_gain_plain(x, b, slope, gain, dim)
    n, cols = kernel_channels(x, dim)
    if b is not None and (b.shape != (cols,) or b.dtype not in (torch.float32, x.dtype)
                          or b.device != x.device or not b.is_contiguous()):
        raise ValueError(
            f"b must be a contiguous [{cols}] float32 or {x.dtype} vector on {x.device}; "
            f"got {tuple(b.shape)} {b.dtype} on {b.device}")
    _cuda_or_raise("bias_lrelu_gain", x)
    y = torch.empty_like(x)            # x is dense, so y gets x's strides
    _call("bias_lrelu_gain", "pggan_bias_lrelu_gain", x, x.data_ptr(),
          None if b is None else b.data_ptr(), y.data_ptr(), n, cols,
          _DTYPE_CODES[x.dtype], 0 if b is None else _DTYPE_CODES[b.dtype],
          float(slope), float(gain))
    return y


# ---------------------------------------------------------------------------
# autograd rules
# ---------------------------------------------------------------------------

class _PixelNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, eps):
        ctx.save_for_backward(x)
        ctx.eps = eps
        return _pixel_norm_fwd(x, eps)

    @staticmethod
    def backward(ctx, g):
        # The JVP of `pallas_kernels.py:80-90` (a symmetric operator, so it
        # is its own VJP), in differentiable torch ops.
        (x,) = ctx.saved_tensors
        xf, gf = x.float(), g.float()
        inv = torch.rsqrt(xf.square().mean(dim=1, keepdim=True) + ctx.eps)
        dx = gf * inv - xf * (inv * inv * inv) * (xf * gf).mean(dim=1, keepdim=True)
        return dx.to(x.dtype), None


class _LreluPixelNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slope, eps):
        ctx.save_for_backward(x)
        ctx.slope, ctx.eps = slope, eps
        return _lrelu_pixel_norm_fwd(x, slope, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        # Autograd hands the gradient in y's dtype and, from cuDNN's
        # convolutions, in y's channels_last layout; both calls below are
        # then no-ops.
        g = g.to(x.dtype).contiguous(memory_format=_row_format(x))
        return lrelu_pixel_norm_bwd(x, g, ctx.slope, ctx.eps), None, None


def _minibatch_stddev_vjp(x: torch.Tensor, sg: int, eps: float,
                          g: torch.Tensor) -> torch.Tensor:
    """dx = g[group] · (x − mean) / (F·(sg−1)·std), the VJP of
    `_mb_stddev_stat_ref` (the mean's own derivative cancels: the
    deviations of a group sum to zero). Differentiable, so R1's double
    backward runs through it."""
    y = _groups(x, sg)
    d = y - y.mean(dim=1, keepdim=True)
    std = torch.sqrt(d.square().sum(dim=1, keepdim=True) / (sg - 1) + eps)
    dy = g.float().view(-1, 1, 1) * d / (std * (y.shape[-1] * (sg - 1)))
    return dy.reshape(x.shape).to(x.dtype)


class _MinibatchStddevStat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sg, eps):
        ctx.save_for_backward(x)
        ctx.sg, ctx.eps = sg, eps
        return _minibatch_stddev_stat_fwd(x, sg, eps)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _minibatch_stddev_vjp(x, ctx.sg, ctx.eps, g), None, None


class _BiasLreluGain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, slope, gain, dim):
        ctx.save_for_backward(x, b)
        ctx.slope, ctx.gain, ctx.dim = slope, gain, dim
        return _bias_lrelu_gain_fwd(x, b, slope, gain, dim)

    @staticmethod
    def backward(ctx, g):
        # The transpose of `_bias_lrelu_jvp` (`pallas_kernels.py:133-141`) in
        # differentiable torch ops: the mask is formed in x's dtype, as the
        # JVP forms it, and dx = where(z >= 0, g·gain, g·gain·slope).
        x, b = ctx.saved_tensors
        z = x if b is None else x + along(b, x.ndim, ctx.dim).to(x.dtype)
        gg = g * ctx.gain
        dx = torch.where(z >= 0, gg, gg * ctx.slope)
        db = None
        if b is not None:
            axes = [d for d in range(x.ndim) if d != ctx.dim % x.ndim]
            db = dx.sum(dim=axes, dtype=b.dtype)
        return dx.to(x.dtype), db, None, None, None


# ---------------------------------------------------------------------------
# export-time operators
# ---------------------------------------------------------------------------
# `torch.export` traces with fake tensors, which have no memory for the ctypes
# launch to point at. While a program is exported, the two forward wrappers
# call these registered operators instead; each stays one node of the
# exported graph, and running the graph calls the same forward as the eager
# wrapper: the kernel (counted in `launches`) on a CUDA tensor, the plain
# version on a CPU tensor. Loading an exported program needs them registered,
# that is this module imported. Their fake implementations keep x's strides,
# which are the channels_last strides the row kernels take. The eager calls
# do not go through the dispatcher: it would add host time to every call of
# the host-bound sampling forward.

@torch.library.custom_op("pggan::pixel_norm", mutates_args=())
def pixel_norm_op(x: torch.Tensor, eps: float) -> torch.Tensor:
    return _pixel_norm_fwd(x, eps)


@pixel_norm_op.register_fake
def _(x, eps):
    return torch.empty_like(x)


@torch.library.custom_op("pggan::lrelu_pixel_norm", mutates_args=())
def lrelu_pixel_norm_op(x: torch.Tensor, slope: float, eps: float) -> torch.Tensor:
    return _lrelu_pixel_norm_fwd(x, slope, eps)


@lrelu_pixel_norm_op.register_fake
def _(x, slope, eps):
    return torch.empty_like(x)


def pixel_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Pixel normalisation over the channel axis (`pallas_kernels.pixel_norm`)."""
    if torch.compiler.is_exporting():
        return pixel_norm_op(x, float(eps))
    if torch.is_grad_enabled() and x.requires_grad:     # autograd records the call
        return _PixelNorm.apply(x, float(eps))
    return _pixel_norm_fwd(x, float(eps))


def lrelu_pixel_norm(x: torch.Tensor, slope: float = 0.2,
                     eps: float = EPS) -> torch.Tensor:
    """pixel_norm(leaky_relu(x)) in one pass (`pallas_kernels.lrelu_pixel_norm`)."""
    if torch.compiler.is_exporting():
        return lrelu_pixel_norm_op(x, float(slope), float(eps))
    if torch.is_grad_enabled() and x.requires_grad:     # autograd records the call
        return _LreluPixelNorm.apply(x, float(slope), float(eps))
    return _lrelu_pixel_norm_fwd(x, float(slope), float(eps))


def minibatch_stddev_stat(x: torch.Tensor, sg: int, eps: float = EPS) -> torch.Tensor:
    """The per-group statistic [N // sg], f32
    (`pallas_kernels.minibatch_stddev_stat`; the caller picks sg)."""
    if torch.is_grad_enabled() and x.requires_grad:     # autograd records the call
        return _MinibatchStddevStat.apply(x, int(sg), float(eps))
    return _minibatch_stddev_stat_fwd(x, int(sg), float(eps))


def bias_lrelu_gain(x: torch.Tensor, b: Optional[torch.Tensor] = None,
                    slope: float = 0.2, gain: float = SQRT2,
                    dim: int = 1) -> torch.Tensor:
    """leaky_relu(x + b, slope) · gain, b broadcast along the channel axis
    `dim` (`pallas_kernels.bias_lrelu_gain`); b None is a zero bias.
    Differentiable to any order."""
    return _BiasLreluGain.apply(x, b, float(slope), float(gain), int(dim))
