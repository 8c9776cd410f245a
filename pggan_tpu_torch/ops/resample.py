"""upfirdn2d-family resampling ops — the counterpart of
`pggan_tpu/ops/resample.py`.

4-D activations are logical NCHW tensors in `torch.channels_last` memory;
filters are f32 [fh, fw] tensors (a 1-D filter is applied as its outer
product). upfirdn2d is zero-insertion upsampling, padding (negative pads
crop), an FIR filter and decimation: the zero insertion is a reshape and a
pad of the NHWC view, the filter a depthwise `F.conv2d` with the stride as
the decimation, accumulated in f32 as the JAX package's
`preferred_element_type` does. Every op follows its input's device and is
differentiable to any order through autograd.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

_PadT = Union[int, Sequence[int]]


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


def upfirdn2d(x: torch.Tensor, f: Optional[torch.Tensor], up=1, down=1,
              padding: _PadT = 0, flip_filter: bool = False,
              gain: float = 1.0) -> torch.Tensor:
    """Upsample (zero insertion), pad, FIR-filter, downsample
    (`resample.py:70-116`). `flip_filter=False` applies f as a convolution,
    True as a correlation; `gain` scales the taps."""
    n, c, h, w = x.shape
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    if f is None:
        f = torch.ones((1, 1), dtype=torch.float32)
    f = f.to(device=x.device, dtype=torch.float32)
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
