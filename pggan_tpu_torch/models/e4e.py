"""Encoder4Editing (e4e) as an `nn.Module` — the counterpart of
`pggan_tpu/models/e4e.py` (the reference's `submodel/e4e.py:185-259`).

[B, 3, 256, 256] face → [B, n_styles, style_dim] latents: the IR-SE-50 stem
and body of `models/backbones.py`, tapped at the ends of stages 1-3 (c1 at
1/4, c2 at 1/8, c3 at 1/16: body units 6 / 20 / 23); an FPN whose 1×1
laterals add to the deeper map upsampled bilinearly with aligned corners;
and one GradualStyleBlock a style ([conv3×3/2 + LeakyReLU(0.01)] down to
1×1, then an EqualLinear with its runtime 1/√in scale). Styles 0-2 read c3,
3-6 the c2 fusion, the rest the c1 fusion; style 0 is w0 and every other
slot w0 + its delta, or w0 alone beyond `progressive_stage`.

The keys are the reference module's (`input_layer.*`, `body.*`,
`styles.{i}.convs.{2j}`, `styles.{i}.linear`, `latlayer{1,2}`), so a
reference state_dict loads strictly (`convert_e4e_state_dict`).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pggan_tpu_torch.models.backbones import (JaxArrays, as_tensors, conv,
                                              irse_body, irse_depth, irse_input_layer,
                                              irse_trunk, jax_units, put_irse_trunk)
from pggan_tpu_torch.ops.resample import bilinear_align_corners


class EqualLinear(nn.Module):
    """StyleGAN's EqualLinear at lr_mul 1 (`e4e.py:85-114`): N(0, 1)
    weight [out, in] scaled by 1/√in when it runs, zero bias."""

    def __init__(self, din: int, dout: int, gen: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(torch.randn((dout, din), generator=gen))
        self.bias = nn.Parameter(torch.zeros(dout))
        self.scale = 1.0 / math.sqrt(din)

    def forward(self, x):
        return F.linear(x, self.weight * self.scale, self.bias)


class GradualStyleBlock(nn.Module):
    def __init__(self, cin: int, style_dim: int, spatial: int, gen: torch.Generator):
        super().__init__()
        layers = []
        for i in range(int(math.log2(spatial))):
            layers += [conv(cin if i == 0 else style_dim, style_dim, 3, gen, stride=2,
                            bias=True), nn.LeakyReLU(0.01)]
        self.convs = nn.Sequential(*layers)
        self.linear = EqualLinear(style_dim, style_dim, gen)

    def forward(self, x):
        return self.linear(self.convs(x).flatten(1))


class Encoder4Editing(nn.Module):
    """n_styles = 2·log2(output size) − 2 (18 for a 1024² StyleGAN); the
    style blocks pool from 16², 32² or 64² (`e4e.py:210-216`)."""

    def __init__(self, num_layers: int = 50, *, n_styles: int = 18, style_dim: int = 512,
                 input_dim: int = 3, coarse_ind: int = 3, middle_ind: int = 7,
                 seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        self.input_layer = irse_input_layer(input_dim, gen)
        self.body = irse_body(num_layers, gen)
        self.styles = nn.ModuleList(
            GradualStyleBlock(512, style_dim,
                              16 if i < coarse_ind else (32 if i < middle_ind else 64), gen)
            for i in range(n_styles))
        self.latlayer1 = conv(256, 512, 1, gen, bias=True)
        self.latlayer2 = conv(128, 512, 1, gen, bias=True)

    def forward(self, x: torch.Tensor, *, progressive_stage: Optional[int] = None
                ) -> torch.Tensor:
        """`progressive_stage` None: every delta on (inference)."""
        _, (_, c1, c2, c3) = irse_trunk(self.input_layer, self.body, x, taps=True)
        lat2 = self.latlayer1(c2)
        p2 = bilinear_align_corners(c3, lat2.shape[2], lat2.shape[3]) + lat2
        lat1 = self.latlayer2(c1)
        p1 = bilinear_align_corners(p2, lat1.shape[2], lat1.shape[3]) + lat1
        feature = {4: c3, 5: p2, 6: p1}
        w0 = self.styles[0](c3)
        stage = len(self.styles) if progressive_stage is None else progressive_stage
        latents = [w0]
        for i in range(1, len(self.styles)):
            if i <= stage:
                block = self.styles[i]
                latents.append(w0 + block(feature[len(block.convs) // 2]))
            else:
                latents.append(w0)
        return torch.stack(latents, dim=1)


def _style_depths(n_convs) -> dict:
    """The (coarse_ind, middle_ind) split of the styles' conv counts."""
    return {"coarse_ind": sum(1 for n in n_convs if n == 4),
            "middle_ind": sum(1 for n in n_convs if n in (4, 5))}


def convert_e4e_state_dict(sd: Mapping) -> Encoder4Editing:
    """A reference `Encoder4Editing(50, 'ir_se').state_dict()` loaded
    strictly (depth, styles and their pooling depths read from the keys)."""
    units = len({k.split(".")[1] for k in sd if k.startswith("body.")})
    n_styles = len({k.split(".")[1] for k in sd if k.startswith("styles.")})
    n_convs = [len({k for k in sd if k.startswith(f"styles.{i}.convs.") and
                    k.endswith(".weight")}) for i in range(n_styles)]
    module = Encoder4Editing(irse_depth(units), n_styles=n_styles,
                             style_dim=int(np.shape(sd["styles.0.linear.weight"])[0]),
                             input_dim=int(np.shape(sd["input_layer.0.weight"])[1]),
                             **_style_depths(n_convs))
    module.load_state_dict(as_tensors(sd), strict=True)
    return module


def params_from_jax(arrays: Mapping[str, np.ndarray]) -> Encoder4Editing:
    """An `Encoder4Editing` with the weights of JAX `init_e4e_encoder`
    arrays; each EqualLinear takes its runtime scale from `linear/scale`."""
    num_layers = irse_depth(jax_units(arrays))
    jx = JaxArrays(arrays)
    put_irse_trunk(jx, num_layers)
    for name in ("latlayer1", "latlayer2"):
        jx.conv(name, name, bias=True)
    n_styles = len({k.split("/")[1] for k in jx.arrays if k.startswith("styles/")})
    n_convs, scales = [], []
    for i in range(n_styles):
        n = len({k for k in jx.arrays if k.startswith(f"styles/{i}/convs/")}) // 2
        for j in range(n):
            jx.conv(f"styles.{i}.convs.{2 * j}", f"styles/{i}/convs/{j}", bias=True)
        jx.matrix(f"styles.{i}.linear", f"styles/{i}/linear", bias=True)
        n_convs.append(n)
        scales.append(float(jx.take(f"styles/{i}/linear/scale")))
    module = Encoder4Editing(num_layers, n_styles=n_styles,
                             style_dim=int(jx.arrays["styles/0/linear/w"].shape[1]),
                             input_dim=int(jx.arrays["stem/w"].shape[2]),
                             **_style_depths(n_convs))
    for block, scale in zip(module.styles, scales):
        block.linear.scale = scale
    return jx.load(module)
