"""InceptionV3 feature extractor, the canonical FID backbone — the
counterpart of `pggan_tpu/metrics/inception.py`.

torchvision's `inception_v3` up to the final global average pool (pool3 of
pytorch-fid and the FID paper), 2048 features, with torchvision's module
names (`Conv2d_1a_3x3`, `Mixed_5b.branch1x1`, ...). Every conv is
`BasicConv2d`: a conv without bias, BatchNorm with inference statistics
(eps 1e-3), relu. Activations are `channels_last` and the convolutions go
through cuDNN. Input: NHWC in [-1, 1] at any size, bilinearly resized to
299×299 (half-pixel centres, no antialiasing: `jax.image.resize`'s
"bilinear").

Weights come as the JAX package's npz arrays (`fid_weights`), keyed by its
pytree paths, so one file serves both packages:

    `<module>/w` [kh, kw, I, O]           → `<module>.conv.weight` [O, I, kh, kw]
    `<module>/bn/{scale,bias,mean,var}`   → `<module>.bn.{weight,bias,running_mean,running_var}`

`convert_torchvision_state_dict` makes such a file from a torchvision
state_dict. Without weights the network is initialised from a fixed seed
(He-normal convs, identity BatchNorm) by a `torch.Generator`: the
architecture is exact but the values are not JAX's (its threefry stream
cannot be reproduced without JAX), so such an FID is relative only, and
not comparable with the JAX package's fixed-seed FID. With the same
`fid_weights`, both packages compute the same features.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

FEATURE_DIM = 2048
_BN_EPS = 1e-3
_SIZE = 299


class _Conv(nn.Module):
    """A conv without bias whose weight is left unset (filled afterwards by
    `init_inception_v3` or `fid_weights`; no draw from the global
    generator)."""

    def __init__(self, cin: int, cout: int, kh: int, kw: int, stride: int, padding):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin, kh, kw),
                                               memory_format=torch.channels_last))
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, None, self.stride, self.padding)


class BasicConv2d(nn.Module):
    """conv (no bias) → BatchNorm (inference, eps 1e-3) → relu. `valid`
    convs pad nothing; the others are stride 1 with odd kernels, where
    "SAME" pads k // 2 on each side."""

    def __init__(self, cin: int, cout: int, kh: int, kw: int, *, stride: int = 1,
                 valid: bool = False):
        super().__init__()
        padding = (0, 0) if valid else (kh // 2, kw // 2)
        self.conv = _Conv(cin, cout, kh, kw, stride, padding)
        self.bn = nn.BatchNorm2d(cout, eps=_BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    return F.avg_pool2d(x, 3, 1, 1)         # count_include_pad: divides by 9


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)            # VALID


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, 5)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, 3)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, 3)
        self.branch_pool = BasicConv2d(cin, pool_features, 1, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, 3, stride=2, valid=True)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, 3)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, 3, stride=2, valid=True)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, 1, 7)
        self.branch7x7_3 = BasicConv2d(c7, 192, 7, 1)
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, 7, 1)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, 1, 7)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, 7, 1)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, 1, 7)
        self.branch_pool = BasicConv2d(cin, 192, 1, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for conv in (self.branch7x7dbl_1, self.branch7x7dbl_2, self.branch7x7dbl_3,
                     self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(_avg_pool(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, 3, stride=2, valid=True)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, 1, 7)
        self.branch7x7x3_3 = BasicConv2d(192, 192, 7, 1)
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, 3, stride=2, valid=True)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for conv in (self.branch7x7x3_1, self.branch7x7x3_2, self.branch7x7x3_3,
                     self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, 1, 3)
        self.branch3x3_2b = BasicConv2d(384, 384, 3, 1)
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, 3)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, 1, 3)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, 3, 1)
        self.branch_pool = BasicConv2d(cin, 192, 1, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = self.branch_pool(_avg_pool(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


def jax_array_targets(net: nn.Module) -> Dict[str, tuple]:
    """{npz key: (tensor of `net`, whether the key holds an HWIO conv
    weight)} for every array of the JAX package's InceptionV3 pytree."""
    targets = {}
    for name, module in net.named_modules():
        if isinstance(module, BasicConv2d):
            path = name.replace(".", "/")
            targets[f"{path}/w"] = (module.conv.weight, True)
            bn = module.bn
            for leaf, tensor in (("scale", bn.weight), ("bias", bn.bias),
                                 ("mean", bn.running_mean), ("var", bn.running_var)):
                targets[f"{path}/bn/{leaf}"] = (tensor, False)
    return targets


@torch.no_grad()
def load_jax_arrays(net: nn.Module, arrays: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy the JAX package's npz arrays into `net`, strictly: every key
    of the pytree present, no other key, every shape its template's."""
    targets = jax_array_targets(net)
    missing = sorted(set(targets) - set(arrays))
    unexpected = sorted(set(arrays) - set(targets))
    if missing or unexpected:
        raise KeyError(f"InceptionV3 weights do not match the architecture: missing "
                       f"{missing[:8]}{'...' if len(missing) > 8 else ''}, unexpected "
                       f"{unexpected[:8]}{'...' if len(unexpected) > 8 else ''}")
    for key, (tensor, hwio) in targets.items():
        value = torch.as_tensor(np.asarray(arrays[key], np.float32))
        if hwio:
            value = value.permute(3, 2, 0, 1)
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)}, the architecture "
                             f"has {tuple(tensor.shape)}")
        tensor.copy_(value)
    return net


def init_inception_v3(net: nn.Module, seed: int = 2020) -> Dict[str, np.ndarray]:
    """Fixed-seed arrays for `net` in the JAX npz layout: He-normal conv
    weights (std sqrt(2 / fan_in)), BatchNorm scale 1, bias 0, mean 0, var 1,
    drawn in module order from a CPU `torch.Generator` (the same values on
    every device)."""
    gen = torch.Generator().manual_seed(int(seed))
    arrays = {}
    for key, (tensor, hwio) in jax_array_targets(net).items():
        if hwio:
            cout, cin, kh, kw = tensor.shape
            w = torch.randn((kh, kw, cin, cout), generator=gen)
            arrays[key] = (w * math.sqrt(2.0 / (cin * kh * kw))).numpy()
        else:
            fill = 1.0 if key.endswith(("/scale", "/var")) else 0.0
            arrays[key] = np.full(tuple(tensor.shape), fill, np.float32)
    return arrays


class InceptionV3Features(nn.Module):
    """The FID extractor (same call surface as `RandomConvFeatures`): NHWC
    images in [-1, 1] → pool3 features [B, 2048] f32.

    weights: path to an npz of the JAX package's InceptionV3 arrays (e.g.
    converted torchvision / pytorch-fid weights); None → the fixed-seed
    initialisation of `init_inception_v3` (relative FID only)."""

    feature_dim = FEATURE_DIM

    def __init__(self, weights: Optional[str] = None, seed: int = 2020,
                 resize: bool = True, device="cuda"):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, 3, stride=2, valid=True)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, 3, valid=True)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, 3)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, 3, valid=True)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.resize = bool(resize)
        arrays = (init_inception_v3(self, seed) if weights is None
                  else dict(np.load(weights)))
        load_jax_arrays(self, arrays)
        self.requires_grad_(False)
        self.to(device=device, memory_format=torch.channels_last).eval()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return inception_v3_features(self, images, resize=self.resize)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """[B, C, H, W] → [B, C, size, size], bilinear with half-pixel centres
    and no antialiasing: `jax.image.resize(..., "bilinear", antialias=False)`."""
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=False)


def inception_v3_features(net: InceptionV3Features, images: torch.Tensor, *,
                          resize: bool = True) -> torch.Tensor:
    """NHWC images in [-1, 1] → pool3 features [B, 2048] f32, through
    `net`'s layers on its device; `resize` resizes to 299×299 first."""
    x = images.float().permute(0, 3, 1, 2)          # a channels_last view
    if resize and tuple(x.shape[2:]) != (_SIZE, _SIZE):
        x = resize_bilinear(x, _SIZE)
    x = x.contiguous(memory_format=torch.channels_last)
    x = net.Conv2d_2b_3x3(net.Conv2d_2a_3x3(net.Conv2d_1a_3x3(x)))
    x = _max_pool(x)
    x = net.Conv2d_4a_3x3(net.Conv2d_3b_1x1(x))
    x = _max_pool(x)
    for block in (net.Mixed_5b, net.Mixed_5c, net.Mixed_5d, net.Mixed_6a, net.Mixed_6b,
                  net.Mixed_6c, net.Mixed_6d, net.Mixed_6e, net.Mixed_7a, net.Mixed_7b,
                  net.Mixed_7c):
        x = block(x)
    return x.mean(dim=(2, 3))


def convert_torchvision_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """torchvision `inception_v3` state_dict → npz arrays keyed by the JAX
    package's pytree paths (`inception.py:261-288`). AuxLogits/fc entries
    are dropped (not on the pool3 path). Save with `np.savez(path,
    **arrays)` and pass the path as `fid_weights` to either package."""
    out: Dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        if key.startswith(("AuxLogits", "fc")) or "num_batches_tracked" in key:
            continue
        parts = key.split(".")
        module, leaf = ".".join(parts[:-2]), ".".join(parts[-2:])
        path = module.replace(".", "/")
        arr = np.asarray(value.detach().cpu().numpy() if hasattr(value, "detach")
                         else value)
        if leaf == "conv.weight":          # [O,I,kh,kw] → [kh,kw,I,O]
            out[f"{path}/w"] = arr.transpose(2, 3, 1, 0)
        elif leaf == "bn.weight":
            out[f"{path}/bn/scale"] = arr
        elif leaf == "bn.bias":
            out[f"{path}/bn/bias"] = arr
        elif leaf == "bn.running_mean":
            out[f"{path}/bn/mean"] = arr
        elif leaf == "bn.running_var":
            out[f"{path}/bn/var"] = arr
        else:
            raise KeyError(f"unrecognized state_dict entry {key!r}")
    return out
