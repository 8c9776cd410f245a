"""BiSeNet face parser as an `nn.Module` — the counterpart of
`pggan_tpu/models/faceparser.py` (the reference's `submodel/faceparser.py:
190-207`).

[B, 3, H, W] (H, W multiples of 32) → [B, n_classes, H, W] face-part logits:
a ResNet-18 context path (1/8, 1/16, 1/32 stages), attention refinement on
the 1/16 and 1/32 stages plus a global-average tail, nearest-neighbour
merges, a feature-fusion module with the 1/8 stage, and a head whose logits
are upsampled bilinearly with aligned corners — the only bilinear resize.

The keys are the reference module's (`cp.resnet.*`, `cp.arm{16,32}.*`,
`cp.conv_{avg,head16,head32}.*`, `ffm.*`, `conv_out.*`), including the
training-time deep-supervision heads `conv_out16` / `conv_out32`, which the
forward never calls but real checkpoints carry; so a reference state_dict
loads strictly. The JAX package holds no such heads: `params_from_jax`
leaves them at their initialisation.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pggan_tpu_torch.models.backbones import (BatchNorm, JaxArrays, ResNet, as_tensors,
                                              conv, put_resnet)
from pggan_tpu_torch.ops.resample import bilinear_align_corners


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, gen: torch.Generator):
        super().__init__()
        self.conv = conv(cin, cout, k, gen)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class AttentionRefinement(nn.Module):
    """conv-bn-relu, then a sigmoid channel gate from the pooled map."""

    def __init__(self, cin: int, cout: int, gen: torch.Generator):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout, 3, gen)
        self.conv_atten = conv(cout, cout, 1, gen)
        self.bn_atten = BatchNorm(cout)

    def forward(self, x):
        feat = self.conv(x)
        atten = self.conv_atten(feat.mean(dim=(2, 3), keepdim=True))
        return feat * torch.sigmoid(self.bn_atten(atten))


def _upsample_to(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour upsample by an integer factor to `like`'s size."""
    return F.interpolate(x, size=like.shape[2:], mode="nearest")


class ContextPath(nn.Module):
    def __init__(self, input_dim: int, gen: torch.Generator, seed: int):
        super().__init__()
        self.resnet = ResNet(18, input_dim=input_dim, seed=seed)
        self.arm16 = AttentionRefinement(256, 128, gen)
        self.arm32 = AttentionRefinement(512, 128, gen)
        self.conv_head32 = ConvBNReLU(128, 128, 3, gen)
        self.conv_head16 = ConvBNReLU(128, 128, 3, gen)
        self.conv_avg = ConvBNReLU(512, 128, 1, gen)

    def forward(self, x):
        """(the 1/8 stage, the refined context at 1/8)."""
        feat8, feat16, feat32 = self.resnet(x, return_stages=True)
        avg = self.conv_avg(feat32.mean(dim=(2, 3), keepdim=True))
        f32 = self.arm32(feat32) + avg                    # broadcast = nearest from 1×1
        f32_up = self.conv_head32(_upsample_to(f32, feat16))
        f16 = self.arm16(feat16) + f32_up
        return feat8, self.conv_head16(_upsample_to(f16, feat8))


class FeatureFusion(nn.Module):
    def __init__(self, cin: int, cout: int, gen: torch.Generator):
        super().__init__()
        self.convblk = ConvBNReLU(cin, cout, 1, gen)
        self.conv1 = conv(cout, cout // 4, 1, gen)
        self.conv2 = conv(cout // 4, cout, 1, gen)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = torch.sigmoid(self.conv2(F.relu(self.conv1(feat.mean(dim=(2, 3), keepdim=True)))))
        return feat * atten + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, cin: int, mid: int, n_classes: int, gen: torch.Generator):
        super().__init__()
        self.conv = ConvBNReLU(cin, mid, 3, gen)
        self.conv_out = conv(mid, n_classes, 1, gen)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    def __init__(self, n_classes: int = 19, *, input_dim: int = 3, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed) + 1)
        self.cp = ContextPath(input_dim, gen, seed)
        self.ffm = FeatureFusion(256, 256, gen)
        self.conv_out = BiSeNetOutput(256, 256, n_classes, gen)
        self.conv_out16 = BiSeNetOutput(128, 64, n_classes, gen)
        self.conv_out32 = BiSeNetOutput(128, 64, n_classes, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat8, context = self.cp(x)
        out = self.conv_out(self.ffm(feat8, context))
        return bilinear_align_corners(out, x.shape[2], x.shape[3])


def convert_bisenet_state_dict(sd: Mapping) -> BiSeNet:
    """A reference `BiSeNet(n_classes).state_dict()` loaded strictly."""
    module = BiSeNet(int(np.shape(sd["conv_out.conv_out.weight"])[0]),
                     input_dim=int(np.shape(sd["cp.resnet.conv1.weight"])[1]))
    module.load_state_dict(as_tensors(sd), strict=True)
    return module


def params_from_jax(arrays: Mapping[str, np.ndarray]) -> BiSeNet:
    """A `BiSeNet` with the weights of JAX `init_bisenet` arrays."""
    jx = JaxArrays(arrays)
    put_resnet(jx, 18, key="cp.resnet.", path="resnet/")

    def conv_bn_relu(key, path):
        jx.conv(key + ".conv", path)
        jx.bn(key + ".bn", path + "/bn")

    for arm in ("arm16", "arm32"):
        conv_bn_relu(f"cp.{arm}.conv", f"{arm}/conv")
        jx.conv(f"cp.{arm}.conv_atten", f"{arm}/atten")
        jx.bn(f"cp.{arm}.bn_atten", f"{arm}/atten/bn")
    for name in ("conv_avg", "conv_head16", "conv_head32"):
        conv_bn_relu(f"cp.{name}", name)
    conv_bn_relu("ffm.convblk", "ffm/conv")
    jx.conv("ffm.conv1", "ffm/fc1")
    jx.conv("ffm.conv2", "ffm/fc2")
    conv_bn_relu("conv_out.conv", "head/conv")
    jx.conv("conv_out.conv_out", "head/out")
    module = BiSeNet(int(jx.arrays["head/out/w"].shape[3]),
                     input_dim=int(jx.arrays["resnet/stem/w"].shape[2]))
    heads = [k for k in module.state_dict() if k.startswith(("conv_out16.", "conv_out32."))]
    return jx.load(module, unloaded=heads)
