"""Equalized-learning-rate convolution and linear layers — the counterpart
of `pggan_tpu/ops/equalized.py`.

Weights are drawn N(0, 1) and He's constant c = sqrt(2 / fan_in) is applied
at run time. Like the JAX package, c scales the weight and the bias rather
than the output — `conv(x, w·c) + b·c`, products in f32 before the cast to
the compute dtype (`equalized.py:100-113`). c is a buffer, never a
parameter, so an optimizer cannot train it.

Parameters use PyTorch's layouts (OIHW convolution weights, [out, in] linear
weights); `to_jax`/`load_jax` convert from and to the JAX package's HWIO and
[in, out] arrays, and `params_to_jax`/`load_params_from_jax` do so for a
whole network keyed by the JAX pytree paths. The convolutions and the matrix
product themselves are cuDNN's and cuBLAS's, as the JAX package leaves them
to XLA.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pggan_tpu_torch.utils.checkpoint import check_key_set

# Network ids of the per-component seeds: the JAX trainer folds 0 into G's
# key and 1 into D's (`trainer.py:89-90`).
NET_G, NET_D = 0, 1


def component_rng(seed: int, net: int, *component: int) -> torch.Generator:
    """A CPU generator for one layer, seeded by (seed, network, component
    ids), so a layer's weights do not depend on when it was built."""
    state = np.random.SeedSequence([int(seed), net, *component]).generate_state(1)
    return torch.Generator().manual_seed(int(state[0]))


def he_constant(fan_in: int, lr_mul: float = 1.0) -> float:
    """He's constant sqrt(2 / fan_in) · lr_mul (`lib/layers.py:18-26`)."""
    return math.sqrt(2.0 / fan_in) * lr_mul


def scaled_weight_bias(weight: torch.Tensor, bias: torch.Tensor,
                       scale: torch.Tensor, dtype: torch.dtype):
    """(w·c, b·c), each product in f32, cast to `dtype`."""
    return ((weight.float() * scale).to(dtype),
            (bias.float() * scale).to(dtype))


def equalized_conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     scale: torch.Tensor, *,
                     compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """SAME-padded stride-1 conv of [B, C, H, W] with an OIHW weight."""
    dt = compute_dtype or x.dtype
    w, b = scaled_weight_bias(weight, bias, scale, dt)
    return F.conv2d(x.to(dt), w, b, padding=weight.shape[-1] // 2)


def equalized_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     scale: torch.Tensor, *,
                     compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[B, in] → [B, out] with an [out, in] weight."""
    dt = compute_dtype or x.dtype
    w, b = scaled_weight_bias(weight, bias, scale, dt)
    return F.linear(x.to(dt), w, b)


class _Equalized(nn.Module):
    """Weight, bias and He-constant buffer, drawn from `generator`.
    Subclasses define `_weight_to_jax` and `_weight_from_jax`."""

    def __init__(self, weight_shape, fan_in: int, *, equalized: bool,
                 init_bias_to_zero: bool, generator: torch.Generator):
        super().__init__()
        w = torch.randn(weight_shape, generator=generator)
        if equalized:
            scale = he_constant(fan_in)
        else:   # He-normal init and no run-time constant (`equalized.py:47-49`)
            w = w * math.sqrt(2.0 / fan_in)
            scale = 1.0
        out_ch = weight_shape[0]
        if init_bias_to_zero:
            b = torch.zeros(out_ch)
        else:
            bound = 1.0 / math.sqrt(fan_in)
            b = torch.empty(out_ch).uniform_(-bound, bound, generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(b)
        self.register_buffer("scale", torch.tensor(scale, dtype=torch.float32))

    def to_jax(self) -> Dict[str, np.ndarray]:
        """{'w', 'b', 'scale'} in the JAX package's layouts (copies)."""
        return {
            "w": self._weight_to_jax(self.weight.detach()).cpu().numpy().copy(),
            "b": self.bias.detach().cpu().numpy().copy(),
            "scale": self.scale.cpu().numpy().copy(),
        }

    def load_jax(self, arrays: Dict[str, np.ndarray], prefix: str) -> None:
        """Copy JAX-layout arrays {prefix}/w, /b, /scale into this layer,
        checking each shape."""
        with torch.no_grad():
            for key, target, conv in (
                    ("w", self.weight, self._weight_from_jax),
                    ("b", self.bias, None),
                    ("scale", self.scale, None)):
                src = torch.tensor(np.asarray(arrays[f"{prefix}/{key}"]))
                if conv is not None:
                    src = conv(src)
                if tuple(src.shape) != tuple(target.shape):
                    raise ValueError(
                        f"shape mismatch for {prefix}/{key}: checkpoint "
                        f"{tuple(src.shape)} vs model {tuple(target.shape)}")
                target.copy_(src)


class EqualizedConv2d(_Equalized):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, *,
                 equalized: bool = True, init_bias_to_zero: bool = True,
                 generator: torch.Generator):
        super().__init__((out_ch, in_ch, kernel, kernel), in_ch * kernel * kernel,
                         equalized=equalized, init_bias_to_zero=init_bias_to_zero,
                         generator=generator)

    @staticmethod
    def _weight_to_jax(w):          # OIHW → HWIO
        return w.permute(2, 3, 1, 0)

    @staticmethod
    def _weight_from_jax(w):        # HWIO → OIHW
        return w.permute(3, 2, 0, 1)

    def forward(self, x: torch.Tensor, *,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return equalized_conv2d(x, self.weight, self.bias, self.scale,
                                compute_dtype=compute_dtype)


class EqualizedLinear(_Equalized):
    def __init__(self, in_dim: int, out_dim: int, *, equalized: bool = True,
                 init_bias_to_zero: bool = True, generator: torch.Generator):
        super().__init__((out_dim, in_dim), in_dim, equalized=equalized,
                         init_bias_to_zero=init_bias_to_zero, generator=generator)

    @staticmethod
    def _weight_to_jax(w):          # [out, in] → [in, out]
        return w.t()

    @staticmethod
    def _weight_from_jax(w):
        return w.t()

    def forward(self, x: torch.Tensor, *,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return equalized_linear(x, self.weight, self.bias, self.scale,
                                compute_dtype=compute_dtype)


def jax_layers(module: nn.Module) -> Dict[str, _Equalized]:
    """JAX pytree path prefix → layer, e.g. 'blocks/0/conv1'."""
    return {name.replace(".", "/"): layer for name, layer in module.named_modules()
            if isinstance(layer, _Equalized)}


def params_to_jax(module: nn.Module) -> Dict[str, np.ndarray]:
    """A network's weights as the JAX package's arrays, keyed by pytree
    path (`format/w`, `blocks/0/conv0/b`, `torgb/1/scale`, ...)."""
    out: Dict[str, np.ndarray] = {}
    for prefix, layer in jax_layers(module).items():
        for key, arr in layer.to_jax().items():
            out[f"{prefix}/{key}"] = arr
    return out


def load_params_from_jax(module: nn.Module, arrays: Dict[str, np.ndarray]) -> nn.Module:
    """Copy the JAX package's arrays into `module`, strictly: the key sets
    must match (KeyError) and every shape must agree (ValueError)."""
    layers = jax_layers(module)
    check_key_set((f"{p}/{k}" for p in layers for k in ("w", "b", "scale")), arrays)
    for prefix, layer in layers.items():
        layer.load_jax(arrays, prefix)
    return module


def adam_state_to_jax(opt: torch.optim.Adam, module: nn.Module) -> Dict[str, np.ndarray]:
    """`opt`'s moments for `module`'s weights as optax's Adam state flattens
    in a checkpoint: '0/count' (int32) and '0/mu/<path>', '0/nu/<path>' in
    the JAX layouts. Weights that have no state yet (never given a
    gradient) and the He constants get zeros, as optax holds for a zero
    gradient."""
    out: Dict[str, np.ndarray] = {}
    count = 0
    for prefix, layer in jax_layers(module).items():
        for key, param, to_jax in (("w", layer.weight, layer._weight_to_jax),
                                   ("b", layer.bias, None), ("scale", None, None)):
            state = opt.state.get(param, {}) if param is not None else {}
            for moment, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                if slot in state:
                    value = state[slot].detach()
                    value = (to_jax(value) if to_jax else value).cpu().numpy().copy()
                else:
                    shape = () if param is None else (
                        to_jax(param) if to_jax else param).shape
                    value = np.zeros(shape, np.float32)
                out[f"0/{moment}/{prefix}/{key}"] = value
            if "step" in state:
                count = max(count, int(state["step"]))
    out["0/count"] = np.asarray(count, np.int32)
    return out


def load_adam_state_from_jax(opt: torch.optim.Adam, module: nn.Module,
                             arrays: Dict[str, np.ndarray]) -> None:
    """Set `opt`'s moments for `module` from optax's flattened Adam state,
    strictly (the key set must be that of `adam_state_to_jax`). A count of
    0 leaves the optimizer fresh."""
    layers = jax_layers(module)
    check_key_set(["0/count"] + [f"0/{m}/{p}/{k}" for m in ("mu", "nu")
                                 for p in layers for k in ("w", "b", "scale")], arrays)
    count = int(arrays["0/count"])
    opt.state.clear()
    if count == 0:
        return
    for prefix, layer in layers.items():
        for key, param, from_jax in (("w", layer.weight, layer._weight_from_jax),
                                     ("b", layer.bias, None)):
            moments = {}
            for moment, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                value = torch.tensor(np.asarray(arrays[f"0/{moment}/{prefix}/{key}"]))
                value = from_jax(value) if from_jax else value
                if tuple(value.shape) != tuple(param.shape):
                    raise ValueError(
                        f"shape mismatch for 0/{moment}/{prefix}/{key}: checkpoint "
                        f"{tuple(value.shape)} vs model {tuple(param.shape)}")
                moments[slot] = value.to(param).contiguous()
            # Adam keeps its step count as an f32 scalar: on the host, or
            # on the weight's device when it is capturable (`train/step.py:
            # make_optimizers`).
            on = param.device if opt.defaults["capturable"] else None
            opt.state[param] = {"step": torch.tensor(float(count), device=on), **moments}
