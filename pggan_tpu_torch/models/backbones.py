"""Feature-extraction backbones as `nn.Module`s — the counterpart of
`pggan_tpu/models/backbones.py`.

  * `ResNet`: ResNet-18 (basic blocks [2,2,2,2], BiSeNet's context path,
    `submodel/resnet.py:10-89`) and ResNet-50 (bottleneck [3,4,6,3], the
    Deep3DMM ReconNet backbone, `submodel/deep3dmm.py:398-505`), with
    torchvision's key names (`conv1`, `bn1`, `layer{1..4}.{b}.conv{i}`,
    `.downsample.{0,1}`);
  * `IRSE`: the IR-SE ArcFace embedder (`submodel/arcface.py:89-118`) at 50,
    100 or 152 layers, with the reference's key names (`input_layer.{0,1,2}`,
    `body.{i}.res_layer.{0..5}`, `body.{i}.shortcut_layer.{0,1}`,
    `output_layer.{0,3,4}`).

Inputs are [B, C, H, W]. So a reference `state_dict` loads with
`load_state_dict(sd, strict=True)`; `convert_*_state_dict` builds the module
and does so. `*_params_from_jax` take the JAX package's flat
`{pytree path: array}` dict (`pggan_tpu.utils.checkpoint.tree_to_arrays`)
and return the module with those weights: convolutions HWIO → OIHW,
matrices [in, out] → [out, in], BatchNorm scale/bias/mean/var →
weight/bias/running_mean/running_var.

BatchNorm always runs on its running statistics (`BatchNorm`), as JAX's
`_bn` does, whatever `.train()` says. Every convolution pads k // 2 on each
side, torch-style, and ResNet's stem max-pool pads with -inf, as the JAX
package does explicitly. Random initialisation draws from a CPU
`torch.Generator` seeded by `seed`; the modules are built on the CPU and
follow `.to(device)`.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5

# (width, units) per stage of the IR-SE bodies (`backbones.py:208-212`).
IRSE_STAGES = {
    50: [(64, 3), (128, 4), (256, 14), (512, 3)],
    100: [(64, 3), (128, 13), (256, 30), (512, 3)],
    152: [(64, 3), (128, 8), (256, 36), (512, 3)],
}
RESNET_LAYERS = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3)}
_WIDTHS = (64, 128, 256, 512)


class BatchNorm(nn.Module):
    """BatchNorm on its running statistics only, in every mode (JAX `_bn`,
    `backbones.py:54-56`), over dim 1 of [B, C] or [B, C, H, W]. Its keys are
    nn.BatchNorm1d/2d's, `num_batches_tracked` included, so a reference
    state_dict loads."""

    def __init__(self, channels: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, eps=self.eps)


def conv(cin: int, cout: int, k: int, gen: torch.Generator, *, stride: int = 1,
         padding: Optional[int] = None, bias: bool = False,
         bias_init: str = "uniform") -> nn.Conv2d:
    """An nn.Conv2d (padding k // 2 unless given) with He-normal weights
    drawn from `gen`, and a bias U(±1/√fan_in) (torch's default) or zeros
    (`bias_init="zeros"`). The global generator is not touched."""
    layer = nn.utils.skip_init(nn.Conv2d, cin, cout, k, stride,
                               k // 2 if padding is None else padding, bias=bias)
    fan_in = cin * k * k
    with torch.no_grad():
        layer.weight.copy_(torch.randn(layer.weight.shape, generator=gen)
                           * math.sqrt(2.0 / fan_in))
        if bias and bias_init == "zeros":
            layer.bias.zero_()
        elif bias:
            bound = 1.0 / math.sqrt(fan_in)
            layer.bias.uniform_(-bound, bound, generator=gen)
    return layer


def linear(din: int, dout: int, gen: torch.Generator, *, gain: float = 1.0) -> nn.Linear:
    """An nn.Linear with N(0, gain/din) weights from `gen` and a zero bias."""
    layer = nn.utils.skip_init(nn.Linear, din, dout)
    with torch.no_grad():
        layer.weight.copy_(torch.randn((dout, din), generator=gen) * math.sqrt(gain / din))
        layer.bias.zero_()
    return layer


# ---------------------------------------------------------------------------
# ResNet-18 / ResNet-50 (torchvision key scheme)
# ---------------------------------------------------------------------------

def _downsample(cin: int, cout: int, stride: int, gen) -> nn.Sequential:
    return nn.Sequential(conv(cin, cout, 1, gen, stride=stride), BatchNorm(cout))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, gen: torch.Generator):
        super().__init__()
        self.conv1 = conv(cin, width, 3, gen, stride=stride)
        self.bn1 = BatchNorm(width)
        self.conv2 = conv(width, width, 3, gen)
        self.bn2 = BatchNorm(width)
        self.downsample = (_downsample(cin, width, stride, gen)
                           if stride != 1 or cin != width else None)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class Bottleneck(nn.Module):
    """1×1 → 3×3 (the stride, torchvision's placement) → 1×1 to 4·width."""

    def __init__(self, cin: int, width: int, stride: int, gen: torch.Generator):
        super().__init__()
        out = 4 * width
        self.conv1 = conv(cin, width, 1, gen)
        self.bn1 = BatchNorm(width)
        self.conv2 = conv(width, width, 3, gen, stride=stride)
        self.bn2 = BatchNorm(width)
        self.conv3 = conv(width, out, 1, gen)
        self.bn3 = BatchNorm(out)
        self.downsample = (_downsample(cin, out, stride, gen)
                           if stride != 1 or cin != out else None)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class ResNet(nn.Module):
    """7×7/2 stem + BN + relu + 3×3/2 max-pool (padding 1, -inf) + four
    stages at widths 64/128/256/512, strides (1, 2, 2, 2); `depth` 18 (basic
    blocks) or 50 (bottlenecks, 4× expansion: 2048 channels out)."""

    def __init__(self, depth: int = 18, *, input_dim: int = 3, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        self.depth = depth
        block = Bottleneck if depth == 50 else BasicBlock
        expansion = 4 if depth == 50 else 1
        self.conv1 = conv(input_dim, 64, 7, gen, stride=2)
        self.bn1 = BatchNorm(64)
        cin = 64
        for s, (width, count) in enumerate(zip(_WIDTHS, RESNET_LAYERS[depth])):
            blocks = []
            for b in range(count):
                blocks.append(block(cin, width, 2 if (s > 0 and b == 0) else 1, gen))
                cin = width * expansion
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor, *, return_stages: bool = False):
        """The final map [B, 512·expansion, H/32, W/32], or the (1/8, 1/16,
        1/32) stage outputs the BiSeNet context path reads."""
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, 2, 1)
        feats = []
        for s in range(1, 5):
            y = getattr(self, f"layer{s}")(y)
            feats.append(y)
        return tuple(feats[1:]) if return_stages else y


# ---------------------------------------------------------------------------
# IR-SE (ArcFace) embedder
# ---------------------------------------------------------------------------

class SEModule(nn.Module):
    """Squeeze-excitation: bias-free 1×1 convs on the pooled map."""

    def __init__(self, channels: int, reduction: int, gen: torch.Generator):
        super().__init__()
        self.fc1 = conv(channels, channels // reduction, 1, gen)
        self.fc2 = conv(channels // reduction, channels, 1, gen)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class BottleneckIRSE(nn.Module):
    """One IR-SE unit (`backbones.py:283-306`): res = SE(BN(conv3×3/stride(
    PReLU(conv3×3(BN(x)))))) with the stride on the second conv and no
    trailing activation; shortcut MaxPool2d(1, stride) (a subsample) when
    the width holds, else conv1×1/stride + BN."""

    def __init__(self, cin: int, width: int, stride: int, gen: torch.Generator):
        super().__init__()
        self.shortcut_layer = (nn.MaxPool2d(1, stride) if cin == width else
                               _downsample(cin, width, stride, gen))
        self.res_layer = nn.Sequential(
            BatchNorm(cin), conv(cin, width, 3, gen), nn.PReLU(width, init=0.25),
            conv(width, width, 3, gen, stride=stride), BatchNorm(width),
            SEModule(width, 16, gen))

    def forward(self, x):
        return self.res_layer(x) + self.shortcut_layer(x)


def irse_input_layer(input_dim: int, gen: torch.Generator) -> nn.Sequential:
    """conv3×3/1 + BN + per-channel PReLU (`arcface.py:92-94`, e4e's too)."""
    return nn.Sequential(conv(input_dim, 64, 3, gen), BatchNorm(64), nn.PReLU(64, init=0.25))


def irse_body(num_layers: int, gen: torch.Generator) -> nn.Sequential:
    """The units of every stage, flattened as the reference's `body`; the
    first unit of each stage has stride 2."""
    units, cin = [], 64
    for width, count in IRSE_STAGES[num_layers]:
        for b in range(count):
            units.append(BottleneckIRSE(cin, width, 2 if b == 0 else 1, gen))
            cin = width
    return nn.Sequential(*units)


def irse_trunk(input_layer: nn.Module, body: nn.Sequential, x: torch.Tensor,
               *, taps: bool = False):
    """Stem + body; `taps` also returns each stage's output [c0, c1, c2, c3]
    (body units 2/6/20/23 at 50 layers: the e4e taps, `e4e.py:236-243`)."""
    y = input_layer(x)
    if not taps:
        return body(y)
    stages = IRSE_STAGES[irse_depth(len(body))]
    ends, outs = set(np.cumsum([count for _, count in stages]) - 1), []
    for i, unit in enumerate(body):
        y = unit(y)
        if i in ends:
            outs.append(y)
    return y, outs


def irse_depth(units: int) -> int:
    for depth, stages in IRSE_STAGES.items():
        if sum(count for _, count in stages) == units:
            return depth
    raise ValueError(f"no IR-SE depth has {units} units")


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x · rsqrt(Σx² + 1e-10) over the last axis (not F.normalize's max)."""
    return x * torch.rsqrt(x.square().sum(dim=-1, keepdim=True) + 1e-10)


class IRSE(nn.Module):
    """ArcFace's IR-SE `Backbone(num_layers, drop, 'ir_se')`
    (`arcface.py:89-118`): face crop [B, 3, S, S] → l2-normalised embedding
    [B, embedding_dim]. output_layer: BN2d(512), the reference's Dropout
    (here the identity: inference), NCHW-order flatten, Linear(512·(S/16)²,
    embedding_dim), BN1d."""

    def __init__(self, num_layers: int = 50, *, input_dim: int = 3,
                 embedding_dim: int = 512, input_size: int = 112, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        self.input_layer = irse_input_layer(input_dim, gen)
        self.body = irse_body(num_layers, gen)
        side = input_size // 16
        self.output_layer = nn.Sequential(
            BatchNorm(512), nn.Identity(), nn.Flatten(),
            linear(512 * side * side, embedding_dim, gen), BatchNorm(embedding_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.output_layer(irse_trunk(self.input_layer, self.body, x)))


# ---------------------------------------------------------------------------
# Reference state_dicts and the JAX package's arrays
# ---------------------------------------------------------------------------

def as_tensors(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A state_dict of numpy arrays or tensors as tensors."""
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in sd.items()}


def strip_prefix(sd: Mapping, prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def convert_resnet18_state_dict(sd: Mapping, *, torch_prefix: str = "") -> ResNet:
    """A torchvision-keyed ResNet-18 state_dict (what BiSeNet's
    `Resnet18.init_weight` loads, `submodel/resnet.py:34-40`) → `ResNet(18)`,
    loaded strictly. The classifier `fc.*` is skipped, as the reference's
    own `if 'fc' in k: continue` does."""
    sd = {k: v for k, v in strip_prefix(sd, torch_prefix).items() if not k.startswith("fc.")}
    module = ResNet(18, input_dim=int(np.shape(sd["conv1.weight"])[1]))
    module.load_state_dict(as_tensors(sd), strict=True)
    return module


def convert_resnet50_state_dict(sd: Mapping, *, torch_prefix: str = "") -> ResNet:
    """A torchvision-keyed ResNet-50 state_dict without a classifier (the
    Deep3DMM backbone with use_last_fc=False) → `ResNet(50)`, loaded
    strictly."""
    sd = strip_prefix(sd, torch_prefix)
    module = ResNet(50, input_dim=int(np.shape(sd["conv1.weight"])[1]))
    module.load_state_dict(as_tensors(sd), strict=True)
    return module


def convert_arcface_state_dict(sd: Mapping) -> IRSE:
    """torch `Backbone(num_layers, drop, 'ir_se').state_dict()`
    (`arcface.py:89-118`) → `IRSE`, loaded strictly; the depth, the
    embedding width and the input size are read from the shapes."""
    units = len({k.split(".")[1] for k in sd if k.startswith("body.")})
    head = np.shape(sd["output_layer.3.weight"])
    module = IRSE(irse_depth(units), input_dim=int(np.shape(sd["input_layer.0.weight"])[1]),
                  embedding_dim=int(head[0]),
                  input_size=16 * math.isqrt(int(head[1]) // 512))
    module.load_state_dict(as_tensors(sd), strict=True)
    return module


class JaxArrays:
    """The JAX package's flat arrays gathered into a reference-keyed
    state_dict, in the reference's layouts; `load` checks that every path
    was read and that the module got every key."""

    def __init__(self, arrays: Mapping[str, np.ndarray]):
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self.sd: Dict[str, torch.Tensor] = {}
        self.read = set()

    def take(self, path: str) -> np.ndarray:
        self.read.add(path)
        return self.arrays[path]

    def put(self, key: str, value: np.ndarray) -> None:
        self.sd[key] = torch.from_numpy(np.array(value, np.float32))

    def conv(self, key: str, path: str, *, bias: bool = False) -> None:
        """HWIO → OIHW (`key.weight`), and `key.bias` from `path/b`."""
        self.put(key + ".weight", self.take(path + "/w").transpose(3, 2, 0, 1))
        if bias:
            self.put(key + ".bias", self.take(path + "/b"))

    def matrix(self, key: str, path: str, *, bias: bool = False, as_1x1: bool = False) -> None:
        """[in, out] → [out, in] (nn.Linear), or [out, in, 1, 1] (`as_1x1`)."""
        w = self.take(path + "/w").T
        self.put(key + ".weight", w[:, :, None, None] if as_1x1 else w)
        if bias:
            self.put(key + ".bias", self.take(path + "/b"))

    def bn(self, key: str, path: str) -> None:
        for ours, theirs in (("weight", "scale"), ("bias", "bias"),
                             ("running_mean", "mean"), ("running_var", "var")):
            self.put(f"{key}.{ours}", self.take(f"{path}/{theirs}"))
        self.sd[key + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def load(self, module: nn.Module, unloaded: Iterable[str] = ()) -> nn.Module:
        """Load strictly; `unloaded` names the module's keys that the JAX
        package does not hold (left at their initialisation)."""
        unread = sorted(set(self.arrays) - self.read)
        if unread:
            raise KeyError(f"JAX arrays not used by {type(module).__name__}: {unread[:5]}")
        missing, unexpected = module.load_state_dict(self.sd, strict=False)
        missing = sorted(set(missing) - set(unloaded))
        if missing or unexpected:
            raise KeyError(f"{type(module).__name__} key mismatch: missing={missing[:5]} "
                           f"unexpected={sorted(unexpected)[:5]}")
        return module


def jax_units(arrays: Mapping) -> int:
    """Units (blocks) of a JAX `stages/{s}/{b}` tree."""
    return len({tuple(k.split("/")[1:3]) for k in arrays if k.startswith("stages/")})


def put_resnet(jx: JaxArrays, depth: int, *, key: str = "", path: str = "") -> None:
    """JAX `init_resnet18/50` paths → torchvision keys."""
    jx.conv(key + "conv1", path + "stem")
    jx.bn(key + "bn1", path + "stem/bn")
    convs = 3 if depth == 50 else 2
    for s, count in enumerate(RESNET_LAYERS[depth]):
        for b in range(count):
            k, p = f"{key}layer{s + 1}.{b}", f"{path}stages/{s}/{b}"
            for i in range(1, convs + 1):
                jx.conv(f"{k}.conv{i}", f"{p}/conv{i}")
                jx.bn(f"{k}.bn{i}", f"{p}/bn{i}")
            if f"{p}/down/w" in jx.arrays:
                jx.conv(f"{k}.downsample.0", f"{p}/down")
                jx.bn(f"{k}.downsample.1", f"{p}/down_bn")


def resnet_params_from_jax(arrays: Mapping[str, np.ndarray]) -> ResNet:
    """A `ResNet` (18 or 50, from the stage counts) with the weights of JAX
    `init_resnet18` / `init_resnet50` arrays."""
    depth = {sum(v): k for k, v in RESNET_LAYERS.items()}[jax_units(arrays)]
    jx = JaxArrays(arrays)
    put_resnet(jx, depth)
    return jx.load(ResNet(depth, input_dim=int(jx.arrays["stem/w"].shape[2])))


def put_irse_trunk(jx: JaxArrays, num_layers: int) -> None:
    """JAX `stem` / `stages` (`init_irse_stem`, `init_irse_stages`) → the
    reference's `input_layer` / `body` keys."""
    jx.conv("input_layer.0", "stem")
    jx.bn("input_layer.1", "stem/bn")
    jx.put("input_layer.2.weight", jx.take("stem/prelu"))
    flat = 0
    for s, (_, count) in enumerate(IRSE_STAGES[num_layers]):
        for b in range(count):
            k, p = f"body.{flat}", f"stages/{s}/{b}"
            jx.bn(f"{k}.res_layer.0", f"{p}/bn0")
            jx.conv(f"{k}.res_layer.1", f"{p}/conv1")
            jx.put(f"{k}.res_layer.2.weight", jx.take(f"{p}/prelu"))
            jx.conv(f"{k}.res_layer.3", f"{p}/conv2")
            jx.bn(f"{k}.res_layer.4", f"{p}/bn2")
            jx.matrix(f"{k}.res_layer.5.fc1", f"{p}/se_fc1", as_1x1=True)
            jx.matrix(f"{k}.res_layer.5.fc2", f"{p}/se_fc2", as_1x1=True)
            if f"{p}/down/w" in jx.arrays:
                jx.conv(f"{k}.shortcut_layer.0", f"{p}/down")
                jx.bn(f"{k}.shortcut_layer.1", f"{p}/down_bn")
            flat += 1


def irse_params_from_jax(arrays: Mapping[str, np.ndarray]) -> IRSE:
    """An `IRSE` with the weights of JAX `init_irse` arrays (depth,
    embedding width and input size read from the shapes)."""
    num_layers = irse_depth(jax_units(arrays))
    jx = JaxArrays(arrays)
    put_irse_trunk(jx, num_layers)
    jx.bn("output_layer.0", "head_bn2d")
    jx.matrix("output_layer.3", "head", bias=True)
    jx.bn("output_layer.4", "head_bn1d")
    din, dout = jx.arrays["head/w"].shape
    return jx.load(IRSE(num_layers, input_dim=int(jx.arrays["stem/w"].shape[2]),
                        embedding_dim=int(dout), input_size=16 * math.isqrt(int(din) // 512)))
