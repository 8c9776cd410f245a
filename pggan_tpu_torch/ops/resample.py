"""upfirdn2d-family resampling ops — the counterpart of
`pggan_tpu/ops/resample.py`.

4-D activations are logical NCHW tensors in `torch.channels_last` memory;
filters are f32 [fh, fw] tensors (a 1-D filter is applied as its outer
product). upfirdn2d is zero-insertion upsampling, padding (negative pads
crop), an FIR filter and decimation. The device of the input picks the
route, as in `ops.kernels`:
  - a CUDA tensor launches one of the kernels of `csrc/upfirdn2d.cu`
    (counted in `ops.kernels.launches["upfirdn2d"]`), or raises a
    ValueError that names the reason where the call lies outside their
    envelope (`envelope_refusal`: f32 or bf16, channels_last-dense, up 1,
    2 or 4 and down 1 or 2 on each axis, a 2-D filter of at most 8 taps an
    axis or a 1-D one of at most 24). Calls with up 1 or 2 and at most 8
    taps an axis (StyleGAN2's) run the polyphase kernels, whose taps are
    rounded to x's dtype as the composition's are; the others (StyleGAN3's
    long 1-D filters, up 4) keep a 1-D filter's taps in f32. Which kernel
    a call launches is the C side's choice (`csrc/upfirdn2d.cu`); the
    profiler names it;
  - any other tensor runs the composition `upfirdn2d_plain`: the zero
    insertion is a reshape and a pad of the NHWC view, the filter a
    depthwise `F.conv2d` with the stride as the decimation, accumulated in
    f32 as the JAX package's `preferred_element_type` does.
Both sum in f32 and round once to x's dtype.
Every op follows its input's device and is differentiable to any order:
where autograd records, `upfirdn2d` is an `autograd.Function` whose
backward is `upfirdn2d` of the gradient with up and down swapped, the pads
transposed and the filter flipped (NVIDIA's rule in stylegan2-ada-pytorch's
`torch_utils/ops/upfirdn2d.py`), so each order runs the same route. The
gradient of an up-4 call is a down-4 call, which the kernels do not take:
on a CUDA tensor it raises (StyleGAN3's up 4 serves sampling alone).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from pggan_tpu_torch.ops import kernels

_PadT = Union[int, Sequence[int]]
_Pair = Tuple[int, int]
_Pads = Tuple[int, int, int, int]

_MAX_TAPS = 8            # the kernels' taps an axis of a 2-D filter
_MAX_TAPS_1D = 24        # the kernels' taps of a 1-D filter
_UPS, _DOWNS = (1, 2, 4), (1, 2)   # the kernels' up and down factors an axis
_MAX_GRID = 65535        # the kernels' grid: output rows (strips), batch
_MAX_ROW = 2 ** 30       # the kernels' threads a row: at most output columns x channels


def _parse_scaling(s) -> Tuple[int, int]:
    if isinstance(s, int):
        return s, s
    sx, sy = s
    return int(sx), int(sy)


def _parse_padding(p: _PadT) -> Tuple[int, int, int, int]:
    """int, [px, py] or [x0, x1, y0, y1] → (x0, x1, y0, y1)."""
    if isinstance(p, int):
        return p, p, p, p
    p = list(p)
    if len(p) == 2:
        px, py = p
        return px, px, py, py
    x0, x1, y0, y1 = p
    return x0, x1, y0, y1


def _filter_size(f: Optional[torch.Tensor]) -> Tuple[int, int]:
    """(fh, fw) of a filter as upfirdn2d applies it."""
    if f is None:
        return 1, 1
    return (f.shape[0], f.shape[0]) if f.ndim == 1 else (f.shape[0], f.shape[1])


def setup_filter(f, device="cuda", normalize: bool = True, flip_filter: bool = False,
                 gain: float = 1.0, separable: Optional[bool] = None) -> torch.Tensor:
    """An f32 FIR filter on `device` (`resample.py:45-67`): None is [1]; a
    1-D filter of fewer than 8 taps becomes its 2-D outer product unless
    `separable`; normalised to sum 1, optionally flipped, scaled by
    gain^(ndim/2)."""
    if f is None:
        f = 1
    f = torch.as_tensor(f, dtype=torch.float32)
    if f.ndim == 0:
        f = f[None]
    if f.ndim not in (1, 2):
        raise ValueError(f"a filter has 1 or 2 dims, got shape {tuple(f.shape)}")
    if separable is None:
        separable = f.ndim == 1 and f.numel() >= 8
    if f.ndim == 1 and not separable:
        f = torch.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f.flip(list(range(f.ndim)))
    f = f * (gain ** (f.ndim / 2.0))
    return f.to(device)


def _output_size(x: torch.Tensor, fh: int, fw: int, up: _Pair, down: _Pair,
                 pads: _Pads) -> _Pair:
    """(OH, OW) of upfirdn2d: the padded, zero-inserted extent less the
    filter's, over the decimation, plus one."""
    _, _, h, w = x.shape
    x0, x1, y0, y1 = pads
    return ((h * up[1] + y0 + y1 - fh) // down[1] + 1,
            (w * up[0] + x0 + x1 - fw) // down[0] + 1)


def envelope_refusal(x: torch.Tensor, f: Optional[torch.Tensor], up: _Pair, down: _Pair,
                     out_hw: _Pair) -> Optional[str]:
    """Why the upfirdn2d kernels cannot compute this call, or None where
    they can: x f32 or bf16, 4-D and channels_last-dense, not empty; up
    (x, y) 1, 2 or 4 each and down 1 or 2; f None, a contiguous 1-D f32
    filter of at most 24 taps or a 2-D one of at most 8 taps an axis, on
    x's device, that does not require grad; an output (OH, OW) whose rows, batch and row
    length fit the kernels' grid. Reads only metadata, so it answers for a
    tensor on any device."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        return f"x is {x.dtype}, the kernels take float32 or bfloat16"
    if x.ndim != 4 or x.numel() == 0:
        return f"x has shape {tuple(x.shape)}, the kernels take a non-empty 4-D tensor"
    if not x.is_contiguous(memory_format=torch.channels_last):
        return (f"x has strides {x.stride()} for shape {tuple(x.shape)}, the kernels take "
                "channels_last-contiguous (NHWC) memory")
    if any(s not in _UPS for s in up):
        return f"up {up}: the kernels take 1, 2 or 4 on each axis"
    if any(s not in _DOWNS for s in down):
        return f"down {down}: the kernels take 1 or 2 on each axis"
    if f is not None and (f.dtype != torch.float32 or f.ndim not in (1, 2)
                          or f.device != x.device or not f.is_contiguous()):
        return (f"the filter is a {f.ndim}-D {f.dtype} tensor on {f.device}, the kernels take "
                "a contiguous 1-D or 2-D float32 filter on x's device")
    if f is not None and f.requires_grad:
        return "the filter requires grad, and the kernels have no gradient for it"
    fh, fw = _filter_size(f)
    if f is not None and f.ndim == 1 and fh > _MAX_TAPS_1D:
        return f"a 1-D filter of {fh} taps, the kernels take at most {_MAX_TAPS_1D}"
    if f is not None and f.ndim == 2 and max(fh, fw) > _MAX_TAPS:
        return (f"a {fh}x{fw} 2-D filter, the kernels take at most {_MAX_TAPS} taps an axis "
                f"(a 1-D filter up to {_MAX_TAPS_1D})")
    oh, ow = out_hw
    if min(oh, ow) < 1:
        return f"an empty output {oh}x{ow}"
    if max(oh, x.shape[0]) > _MAX_GRID or ow * x.shape[1] > _MAX_ROW:
        return (f"batch {x.shape[0]}, {oh} output rows or {ow}x{x.shape[1]} values a row "
                f"exceed the kernels' grid ({_MAX_GRID} rows and batch, {_MAX_ROW} a row)")
    return None


def _filter_on(f: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    return None if f is None else f.to(device=x.device, dtype=torch.float32)


def upfirdn2d_plain(x: torch.Tensor, f: Optional[torch.Tensor], up=1, down=1,
                    padding: _PadT = 0, flip_filter: bool = False,
                    gain: float = 1.0) -> torch.Tensor:
    """`upfirdn2d` as a composition of torch ops on any device and layout
    (`resample.py:70-116`): the route of every tensor but a CUDA one, and
    the reference the kernel is held to."""
    n, c, h, w = x.shape
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    if f is None:
        f = torch.ones((1, 1), dtype=torch.float32)
    f = _filter_on(f, x)
    if f.ndim == 1:
        f = torch.outer(f, f)
    fh, fw = f.shape

    # Each sample followed by up - 1 zeros: h·up rows and w·up columns.
    rows = x.permute(0, 2, 3, 1)                         # NHWC (a view if channels_last)
    if upx > 1 or upy > 1:
        rows = F.pad(rows.reshape(n, h, 1, w, 1, c), [0, 0, 0, upx - 1, 0, 0, 0, upy - 1])
        rows = rows.reshape(n, h * upy, w * upx, c)
    xs = F.pad(rows.permute(0, 3, 1, 2), [padx0, padx1, pady0, pady1])

    taps = f * gain
    if not flip_filter:
        taps = taps.flip([0, 1])                         # F.conv2d correlates
    weight = taps.to(x.dtype).float()[None, None].expand(c, 1, fh, fw)
    y = F.conv2d(xs.float(), weight, stride=(downy, downx), groups=c)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def _upfirdn2d(x: torch.Tensor, f: Optional[torch.Tensor], up: _Pair, down: _Pair,
               pads: _Pads, flip_filter: bool, gain: float) -> torch.Tensor:
    """One forward by the route x's device selects (the module's docstring)."""
    if not x.is_cuda:
        return upfirdn2d_plain(x, f, up, down, pads, flip_filter, gain)
    out_hw = _output_size(x, *_filter_size(f), up, down, pads)
    why = envelope_refusal(x, f, up, down, out_hw)
    if why is not None:
        raise ValueError(f"upfirdn2d: no kernel for this CUDA call: {why}")
    return kernels.upfirdn2d(x, f, up, down, (pads[0], pads[2]), out_hw, flip_filter, gain)


class _Upfirdn2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, f, up, down, pads, flip_filter, gain):
        ctx.save_for_backward(f)
        ctx.x_hw, ctx.up, ctx.down, ctx.pads = x.shape[2:], up, down, pads
        ctx.flip_filter, ctx.gain = flip_filter, gain
        return _upfirdn2d(x, f, up, down, pads, flip_filter, gain)

    @staticmethod
    def backward(ctx, dy):
        # The transpose of the forward: up and down swapped, the filter
        # flipped, and pads that give back x's extent (NVIDIA's
        # `_upfirdn2d_cuda.backward`). It calls `upfirdn2d`, so it is
        # differentiable in turn.
        (f,) = ctx.saved_tensors
        (ih, iw), (upx, upy), (downx, downy) = ctx.x_hw, ctx.up, ctx.down
        padx0, _, pady0, _ = ctx.pads
        fh, fw = _filter_size(f)
        oh, ow = dy.shape[2:]
        pads = (fw - padx0 - 1, iw * upx - ow * downx + padx0 - upx + 1,
                fh - pady0 - 1, ih * upy - oh * downy + pady0 - upy + 1)
        dx = upfirdn2d(dy.contiguous(memory_format=torch.channels_last), f, up=ctx.down,
                       down=ctx.up, padding=pads, flip_filter=not ctx.flip_filter,
                       gain=ctx.gain)
        return dx, None, None, None, None, None, None


def upfirdn2d(x: torch.Tensor, f: Optional[torch.Tensor], up=1, down=1,
              padding: _PadT = 0, flip_filter: bool = False,
              gain: float = 1.0) -> torch.Tensor:
    """Upsample (zero insertion), pad, FIR-filter, downsample
    (`resample.py:70-116`). `flip_filter=False` applies f as a convolution,
    True as a correlation; `gain` scales the taps. A filter that requires
    grad is differentiated through the composition, on the CPU only."""
    up, down = _parse_scaling(up), _parse_scaling(down)
    pads = tuple(int(p) for p in _parse_padding(padding))
    f, flip_filter, gain = _filter_on(f, x), bool(flip_filter), float(gain)
    if torch.is_grad_enabled() and x.requires_grad and not (f is not None and f.requires_grad):
        return _Upfirdn2d.apply(x, f, up, down, pads, flip_filter, gain)
    return _upfirdn2d(x, f, up, down, pads, flip_filter, gain)


def filter2d(x: torch.Tensor, f: torch.Tensor, padding: _PadT = 0,
             flip_filter: bool = False, gain: float = 1.0) -> torch.Tensor:
    """FIR-filter keeping the resolution (`resample.py:119-132`); the
    leading pad takes the larger half of the filter's extent."""
    fh, fw = _filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)
    return upfirdn2d(x, f, padding=(px0 + fw // 2, px1 + (fw - 1) // 2,
                                    py0 + fh // 2, py1 + (fh - 1) // 2),
                     flip_filter=flip_filter, gain=gain)


def upsample2d(x: torch.Tensor, f: Optional[torch.Tensor] = None, up=2,
               padding: _PadT = 0, flip_filter: bool = False,
               gain: float = 1.0) -> torch.Tensor:
    """Filtered upsample (`resample.py:135-152`), with the up² gain."""
    upx, upy = _parse_scaling(up)
    fh, fw = _filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)
    return upfirdn2d(x, f, up=up,
                     padding=(px0 + (fw + upx - 1) // 2, px1 + (fw - upx) // 2,
                              py0 + (fh + upy - 1) // 2, py1 + (fh - upy) // 2),
                     flip_filter=flip_filter, gain=gain * upx * upy)


def downsample2d(x: torch.Tensor, f: Optional[torch.Tensor] = None, down=2,
                 padding: _PadT = 0, flip_filter: bool = False,
                 gain: float = 1.0) -> torch.Tensor:
    """Filtered downsample (`resample.py:155-172`); without a filter, a
    down×down box average."""
    downx, downy = _parse_scaling(down)
    if f is None:
        f = torch.ones((downy, downx), dtype=torch.float32) / (downx * downy)
    fh, fw = _filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)
    return upfirdn2d(x, f, down=down,
                     padding=(px0 + (fw - downx + 1) // 2, px1 + (fw - downx) // 2,
                              py0 + (fh - downy + 1) // 2, py1 + (fh - downy) // 2),
                     flip_filter=flip_filter, gain=gain)


def _align_corners_coords(out: int, size: int, device):
    """Source positions of `out` samples over `size` with the corners
    aligned: (fraction, lower index, upper index); a size-1 input or output
    takes index 0 (`resample.py:183-190`)."""
    if out == 1 or size == 1:
        zero = torch.zeros((out,), dtype=torch.long, device=device)
        return torch.zeros((out,), device=device), zero, zero
    src = torch.arange(out, dtype=torch.float32, device=device) * ((size - 1) / (out - 1))
    lo = src.floor().long().clamp(0, size - 1)
    hi = (lo + 1).clamp(max=size - 1)
    return src - lo, lo, hi


def bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of [B, C, H, W] with align_corners=True, as two
    separable lerps with f32 weights (`resample.py:175-198`): a bf16 input
    gives an f32 output, as in the JAX package."""
    fy, y0, y1 = _align_corners_coords(out_h, x.shape[2], x.device)
    fx, x0, x1 = _align_corners_coords(out_w, x.shape[3], x.device)
    fy, fx = fy.view(1, 1, -1, 1), fx.view(1, 1, 1, -1)
    x = x[:, :, y0] * (1.0 - fy) + x[:, :, y1] * fy
    x = x[:, :, :, x0] * (1.0 - fx) + x[:, :, :, x1] * fx
    return x.contiguous(memory_format=torch.channels_last)
