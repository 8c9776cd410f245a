"""The auxiliary discriminator zoo and its building blocks as `nn.Module`s —
the counterpart of `pggan_tpu/models/zoo.py` (the reference's
`submodel/discriminator.py`, `lib/blocks.py`, `lib/utils.py`):

  * AdaIN, ConvBlock, ResBlock, AdaINResBlock, `interpolate2d`;
  * PatchGAN / N-layer (`discriminator.py:26-129`), multiscale (`:132-172`),
    StarGAN-v2 (`:175-243`) and latent-code MLP (`:7-23`) discriminators.

Inputs are [B, C, H, W]. Module names follow the JAX package's pytree paths
(`layers.0`, `scales.2.head`, `blocks.1.skip`, ...), so
`load_params_from_jax` maps `a/b/w` → `a.b.weight` (HWIO → OIHW, [in, out]
→ [out, in]), `b` → `bias`, a norm's `scale` → `weight`; the
`*_params_from_jax` builders read the structure from the shapes. Every conv
pads symmetrically with the reference's integer padding (k // 2 unless
given). Random initialisation: He-normal weights, zero biases, from a CPU
`torch.Generator` seeded by `seed`.
"""

from __future__ import annotations

import math
from typing import List, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pggan_tpu_torch.models.backbones import conv, linear
from pggan_tpu_torch.ops.basic import downscale2d, leaky_relu

EPS = 1e-5


def _conv(cin, cout, k, gen, *, stride=1, bias=True, padding=None) -> nn.Conv2d:
    return conv(cin, cout, k, gen, stride=stride, padding=padding, bias=bias,
                bias_init="zeros")


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """(x − mean) · rsqrt(biased var + eps) over each sample's H, W."""
    return F.instance_norm(x, eps=eps)


def interpolate2d(x: torch.Tensor, scale_factor: float, method: str = "bilinear"
                  ) -> torch.Tensor:
    """Resize [B, C, H, W] to int(H·s) × int(W·s) with half-pixel centres and
    no antialiasing (`jax.image.resize`: "bilinear", or "nearest")."""
    if scale_factor == 1:
        return x
    size = (int(x.shape[2] * scale_factor), int(x.shape[3] * scale_factor))
    if method == "bilinear":
        return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                             antialias=False)
    if method == "nearest":
        return F.interpolate(x, size=size, mode="nearest-exact")
    raise ValueError(f"Unsupported method: {method}")


def activation(x: torch.Tensor, kind: str, slope: float = 0.2) -> torch.Tensor:
    """`set_activate_layer` (`lib/utils.py:19-33`)."""
    if kind == "relu":
        return F.relu(x)
    if kind == "lrelu":
        return leaky_relu(x, slope)
    if kind == "tanh":
        return torch.tanh(x)
    if kind == "sig":
        return torch.sigmoid(x)
    if kind == "none":
        return x
    raise ValueError(f"Unsupported activation: {kind}")


class Norm(nn.Module):
    """`set_norm_layer` (`lib/utils.py:8-17`): 'bn' (affine, on the batch's
    statistics: the reference zoo trains only), 'in' or 'none'."""

    def __init__(self, kind: str, dim: int):
        super().__init__()
        if kind not in ("bn", "in", "none"):
            raise ValueError(f"Unsupported normalization: {kind}")
        self.kind = kind
        if kind == "bn":
            self.weight = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        if self.kind == "bn":
            return F.batch_norm(x, None, None, self.weight, self.bias, training=True, eps=EPS)
        if self.kind == "in":
            return instance_norm(x)
        return x


class AdaIN(nn.Module):
    """(1 + γ)·InstanceNorm(x) + β with [γ ‖ β] = fc(style)."""

    def __init__(self, style_dim: int, num_features: int, *, seed: int = 0):
        super().__init__()
        self.fc = linear(style_dim, 2 * num_features, torch.Generator().manual_seed(int(seed)))

    def forward(self, x, s):
        gamma, beta = self.fc(s)[:, :, None, None].chunk(2, dim=1)
        return (1.0 + gamma) * instance_norm(x) + beta


class ConvBlock(nn.Module):
    """[bilinear ×stride upsample (`transpose`) →] conv → norm → activation
    (`lib/blocks.py:30-56`)."""

    def __init__(self, input_dim: int, output_dim: int, *, kernel_size: int = 3,
                 stride: int = 2, padding: int = 1, norm_type: str = "bn",
                 activation_type: str = "relu", transpose: bool = False, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        self.conv = _conv(input_dim, output_dim, kernel_size, gen,
                          stride=1 if transpose else stride, padding=padding)
        self.norm = Norm(norm_type, output_dim)
        self.stride, self.transpose, self.activation_type = stride, transpose, activation_type

    def forward(self, x):
        y = self.conv(interpolate2d(x, self.stride) if self.transpose else x)
        return activation(self.norm(y), self.activation_type)


class ResBlock(nn.Module):
    """Pre-norm residual with a 1×1 skip and bias-free convs
    (`lib/blocks.py:58-85`); `scale_factor` resizes after the first conv
    and on the skip."""

    def __init__(self, in_c: int, out_c: int, *, norm: str = "in", activation: str = "lrelu",
                 scale_factor: float = 1, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        self.conv1 = _conv(in_c, out_c, 3, gen, bias=False)
        self.conv2 = _conv(out_c, out_c, 3, gen, bias=False)
        self.conv1x1 = _conv(in_c, out_c, 1, gen, bias=False)
        self.norm1, self.norm2 = Norm(norm, in_c), Norm(norm, out_c)
        self.activation, self.scale_factor = activation, scale_factor

    def forward(self, x):
        h = self.conv1(activation(self.norm1(x), self.activation))
        h = interpolate2d(h, self.scale_factor)
        h = self.conv2(activation(self.norm2(h), self.activation))
        return h + interpolate2d(self.conv1x1(x), self.scale_factor)


class AdaINResBlock(nn.Module):
    """ResBlock with AdaIN in place of the norms (`lib/blocks.py:87-111`)."""

    def __init__(self, in_c: int, out_c: int, *, style_dim: int = 512,
                 activation: str = "lrelu", scale_factor: float = 1, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        self.conv1 = _conv(in_c, out_c, 3, gen, bias=False)
        self.conv2 = _conv(out_c, out_c, 3, gen, bias=False)
        self.conv1x1 = _conv(in_c, out_c, 1, gen, bias=False)
        self.adain1 = AdaIN(style_dim, in_c, seed=seed + 1)
        self.adain2 = AdaIN(style_dim, out_c, seed=seed + 2)
        self.activation, self.scale_factor = activation, scale_factor

    def forward(self, x, style):
        h = self.conv1(activation(self.adain1(x, style), self.activation))
        h = interpolate2d(h, self.scale_factor)
        h = self.conv2(activation(self.adain2(h, style), self.activation))
        return h + interpolate2d(self.conv1x1(x), self.scale_factor)


class PatchDiscriminator(nn.Module):
    """n_layers stride-2 4×4 convs at doubling widths (capped at 512), one
    stride-1 4×4 conv, instance norm after every layer but the first, leaky
    ReLU, and a 4×4 one-channel patch-logit head. `padw` is the torch
    padding: 2 for the N-layer net (ceil((4-1)/2), `discriminator.py:87`),
    1 for the fixed PatchGAN (`:31`)."""

    def __init__(self, input_dim: int = 3, base_width: int = 64, n_layers: int = 3, *,
                 padw: int = 2, slope: float = 0.2, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        layers, cin, cout = [], input_dim, base_width
        for _ in range(n_layers):
            layers.append(_conv(cin, cout, 4, gen, stride=2, padding=padw))
            cin, cout = cout, min(cout * 2, 512)
        layers.append(_conv(cin, cout, 4, gen, padding=padw))
        self.layers = nn.ModuleList(layers)
        self.head = _conv(cout, 1, 4, gen, padding=padw)
        self.slope = slope

    def forward(self, x, *, get_features: bool = False):
        """Patch logits [B, 1, H', W'] (and each layer's output)."""
        feats, y = [], x
        for i, layer in enumerate(self.layers):
            y = layer(y)
            if i > 0:
                y = instance_norm(y)
            y = leaky_relu(y, self.slope)
            feats.append(y)
        out = self.head(y)
        return (out, feats) if get_features else out


def avg_pool3s2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, 2, 1, count_include_pad=False) (`discriminator.py:146`)."""
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)


class MultiscaleDiscriminator(nn.Module):
    """One N-layer net a scale; entry i of the output is `scales[num-1-i]`
    on the input pooled i times (`discriminator.py:163-171`: full resolution
    goes through the last net)."""

    def __init__(self, num_scales: int = 3, input_dim: int = 3, base_width: int = 64,
                 n_layers: int = 6, *, slope: float = 0.2, seed: int = 0):
        super().__init__()
        self.scales = nn.ModuleList(
            PatchDiscriminator(input_dim, base_width, n_layers, slope=slope, seed=seed + s)
            for s in range(num_scales))

    def forward(self, x) -> List[torch.Tensor]:
        outs, y = [], x
        for i in range(len(self.scales)):
            outs.append(self.scales[len(self.scales) - 1 - i](y))
            if i != len(self.scales) - 1:
                y = avg_pool3s2(y)
        return outs


class LatentDiscriminator(nn.Module):
    """MLP over latent codes: Linear + leaky ReLU per hidden width, then
    Linear(·, 1) (the reference's n_mlp = 4 default)."""

    def __init__(self, code_dim: int = 512, hidden: Sequence[int] = (512, 512, 512), *,
                 slope: float = 0.2, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        dims = [code_dim] + list(hidden) + [1]
        self.layers = nn.ModuleList(linear(a, b, gen, gain=2.0)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.slope = slope

    def forward(self, code):
        y = code
        for i, layer in enumerate(self.layers):
            y = layer(y)
            if i < len(self.layers) - 1:
                y = leaky_relu(y, self.slope)
        return y


class _StarGANBlock(nn.Module):
    def __init__(self, cin: int, cout: int, gen: torch.Generator):
        super().__init__()
        self.conv1 = _conv(cin, cin, 3, gen)
        self.conv2 = _conv(cin, cout, 3, gen)
        # the learned shortcut exists only on width changes, bias-free
        # (`discriminator.py:209,219`)
        self.skip = _conv(cin, cout, 1, gen, bias=False) if cin != cout else None

    def forward(self, x, slope):
        skip = downscale2d(x if self.skip is None else self.skip(x))
        h = downscale2d(self.conv1(leaky_relu(x, slope)))
        h = self.conv2(leaky_relu(h, slope))
        return (h + skip) * (1.0 / math.sqrt(2.0))


class StarGANDiscriminator(nn.Module):
    """3×3 stem at width 2¹⁴/img_size, log2(img_size) − 2 residual
    downsampling blocks (widths doubling up to `max_width`), a 4×4 conv
    without padding and a 1×1 conv → [B, num_domains] logits."""

    def __init__(self, img_size: int = 256, input_dim: int = 3, num_domains: int = 1,
                 max_width: int = 512, *, slope: float = 0.2, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        width = 2 ** 14 // img_size
        self.stem = _conv(input_dim, width, 3, gen)
        blocks, cin = [], width
        for _ in range(int(np.log2(img_size)) - 2):
            cout = min(cin * 2, max_width)
            blocks.append(_StarGANBlock(cin, cout, gen))
            cin = cout
        self.blocks = nn.ModuleList(blocks)
        self.head1 = _conv(cin, cin, 4, gen, padding=0)
        self.head2 = _conv(cin, num_domains, 1, gen)
        self.slope = slope

    def forward(self, x):
        y = self.stem(x)
        for block in self.blocks:
            y = block(y, self.slope)
        y = self.head1(leaky_relu(y, self.slope))
        y = self.head2(leaky_relu(y, self.slope))
        return y.reshape(y.shape[0], -1)


# ---------------------------------------------------------------------------
# The JAX package's arrays
# ---------------------------------------------------------------------------

_LEAVES = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias"}


def load_params_from_jax(module: nn.Module, arrays: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy JAX arrays into `module` path for path, strictly."""
    sd = {}
    for path, value in arrays.items():
        *parents, leaf = path.split("/")
        value = np.asarray(value, np.float32)
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 2:
            value = value.T
        sd[".".join(parents + [_LEAVES[leaf]])] = torch.from_numpy(np.array(value))
    module.load_state_dict(sd, strict=True)
    return module


def _count(arrays, prefix: str) -> int:
    return len({k[len(prefix):].split("/")[0] for k in arrays if k.startswith(prefix)})


def patch_params_from_jax(arrays: Mapping[str, np.ndarray], **options) -> PatchDiscriminator:
    """JAX `init_patch_discriminator` arrays → `PatchDiscriminator`
    (`options`: padw, slope)."""
    w = np.shape(arrays["layers/0/w"])
    return load_params_from_jax(PatchDiscriminator(
        int(w[2]), int(w[3]), _count(arrays, "layers/") - 1, **options), arrays)


def multiscale_params_from_jax(arrays: Mapping[str, np.ndarray], **options
                               ) -> MultiscaleDiscriminator:
    w = np.shape(arrays["scales/0/layers/0/w"])
    return load_params_from_jax(MultiscaleDiscriminator(
        _count(arrays, "scales/"), int(w[2]), int(w[3]),
        _count(arrays, "scales/0/layers/") - 1, **options), arrays)


def latent_params_from_jax(arrays: Mapping[str, np.ndarray], **options) -> LatentDiscriminator:
    n = _count(arrays, "layers/")
    dims = [int(np.shape(arrays[f"layers/{i}/w"])[0]) for i in range(n)]
    return load_params_from_jax(LatentDiscriminator(dims[0], dims[1:], **options), arrays)


def stargan_params_from_jax(arrays: Mapping[str, np.ndarray], **options
                            ) -> StarGANDiscriminator:
    stem = np.shape(arrays["stem/w"])
    widths = [int(np.shape(arrays[f"blocks/{i}/conv2/w"])[3])
              for i in range(_count(arrays, "blocks/"))]
    module = StarGANDiscriminator(2 ** 14 // int(stem[3]), int(stem[2]),
                                  int(np.shape(arrays["head2/w"])[3]), max(widths), **options)
    return load_params_from_jax(module, arrays)
