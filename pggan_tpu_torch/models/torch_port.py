"""Reference (PyTorch) PGGAN checkpoints → the port's parameters — the
counterpart of `pggan_tpu/models/torch_port.py`, in numpy alone.

The reference saves `{save_root}/{run_id}/ckpt/{G|D}_{step}.pt`: a torch
pickle with the `state_dict` of its module tree and the progressive
schedule's scalars (`pggan/model.py:50-67`). Its key names map onto the
port's `Generator` / `Discriminator` state_dicts:

  Generator state_dict                          → port state_dict
    latent_format_layer.module.{weight,bias}      format.{weight,bias}
    first_block.block.0.module.{weight,bias}      first_conv.{weight,bias}
    blocks.{i}.block.{j}.module.{weight,bias}     blocks.{i}.conv{0,1}.{weight,bias}
    toRGB_blocks.{i}.toRGB.module.{weight,bias}   torgb.{i}.{weight,bias}

  Discriminator state_dict                      → port state_dict
    fromRGB_blocks.{i}.fromRGB.module.*           fromrgb.{i}.*
    blocks.{i}.block.{j}.module.*                 blocks.{i}.conv{0,1}.*
    minibatch_normalization_block.conv.module.*   last_conv.*
    minibatch_normalization_block.linear.module.* last_linear.*
    decision_layer.module.*                       decision.*

Both sides are PyTorch layouts, so no weight is transposed: convolutions
stay OIHW and linear weights [out, in]. The flatten before D's
`last_linear` is NCHW-major in the reference (`lib/blocks.py:263-266`) and
in the port (`models/discriminator.py`), so `last_linear` loads as it is
(the JAX package transposes it to its [in, out] layout). The He constants
are not in a torch state_dict (`lib/layers.py:56` keeps them as plain
floats); each layer's `scale` buffer is recomputed from the weight's shape,
sqrt(2 / prod(shape[1:])) (`lib/layers.py:17-25`), or 1 without equalized
learning rate.

The Sequential index of a block's second conv depends on whether PixelNorm
modules are interleaved (`lib/blocks.py:119-141`: convs at {0, 3} with them,
{0, 2} without), so the convs are found by scanning the key set. A key the
converter does not consume raises.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Mapping, Set

import numpy as np


def _to_numpy(value) -> np.ndarray:
    if hasattr(value, "detach"):        # a torch tensor
        value = value.detach().cpu().numpy()
    return np.asarray(value, dtype=np.float32)


def _he_scale(weight: np.ndarray, equalized_lr: bool) -> np.ndarray:
    if not equalized_lr:
        return np.asarray(1.0, np.float32)
    return np.asarray(math.sqrt(2.0 / int(np.prod(weight.shape[1:]))), np.float32)


def _layer(out: Dict[str, np.ndarray], consumed: Set[str], target: str,
           sd: Mapping[str, Any], prefix: str, equalized_lr: bool) -> None:
    weight = _to_numpy(sd[f"{prefix}.weight"])
    out[f"{target}.weight"] = weight
    out[f"{target}.bias"] = _to_numpy(sd[f"{prefix}.bias"])
    out[f"{target}.scale"] = _he_scale(weight, equalized_lr)
    consumed |= {f"{prefix}.weight", f"{prefix}.bias"}


def _block_conv_prefixes(sd: Mapping[str, Any], index: int) -> List[str]:
    """Conv prefixes of `blocks.{index}` in Sequential order."""
    pattern = re.compile(rf"^blocks\.{index}\.block\.(\d+)\.module\.weight$")
    js = sorted(int(m.group(1)) for k in sd if (m := pattern.match(k)))
    return [f"blocks.{index}.block.{j}.module" for j in js]


def _count(sd: Mapping[str, Any], pattern: str) -> int:
    regex = re.compile(pattern)
    indices = {int(m.group(1)) for k in sd if (m := regex.match(k))}
    if indices and indices != set(range(max(indices) + 1)):
        raise KeyError(f"non-contiguous module indices for {pattern}: {sorted(indices)}")
    return len(indices)


def _blocks(out, consumed, sd, n_blocks: int, equalized_lr: bool, what: str) -> None:
    for i in range(n_blocks):
        prefixes = _block_conv_prefixes(sd, i)
        if len(prefixes) != 2:
            raise KeyError(f"{what} blocks.{i}: expected 2 convs "
                           f"(`lib/blocks.py:119-195`), found {prefixes}")
        for slot, prefix in zip(("conv0", "conv1"), prefixes):
            _layer(out, consumed, f"blocks.{i}.{slot}", sd, prefix, equalized_lr)


def _check_consumed(sd: Mapping[str, Any], consumed: Set[str], what: str) -> None:
    leftover = sorted(set(sd) - consumed)
    if leftover:
        raise KeyError(
            f"unrecognized {what} state_dict keys (not a reference PGGAN checkpoint, "
            f"or an architecture variant this converter does not know): {leftover[:8]}")


def convert_generator_state_dict(sd: Mapping[str, Any], *, equalized_lr: bool = True
                                 ) -> Dict[str, np.ndarray]:
    """The reference `Generator.state_dict()` as the port's `Generator`
    state_dict (f32 numpy arrays); load it with
    `load_state_dict({k: torch.from_numpy(v) ...}, strict=True)` into a
    Generator of the same scale and widths."""
    out: Dict[str, np.ndarray] = {}
    consumed: Set[str] = set()
    _layer(out, consumed, "format", sd, "latent_format_layer.module", equalized_lr)
    first = [k for k in sd if re.match(r"^first_block\.block\.\d+\.module\.weight$", k)]
    if len(first) != 1:
        raise KeyError(f"expected exactly one first_block conv "
                       f"(`lib/blocks.py:119-141`, is_first=True), got {first}")
    _layer(out, consumed, "first_conv", sd, first[0][:-len(".weight")], equalized_lr)
    n_blocks = _count(sd, r"^blocks\.(\d+)\.")
    _blocks(out, consumed, sd, n_blocks, equalized_lr, "generator")
    n_torgb = _count(sd, r"^toRGB_blocks\.(\d+)\.")
    if n_torgb != n_blocks + 1:
        raise KeyError(f"toRGB count {n_torgb} != blocks+1 ({n_blocks + 1}) "
                       f"(`pggan/nets.py:102-119` grows them in lockstep)")
    for i in range(n_torgb):
        _layer(out, consumed, f"torgb.{i}", sd, f"toRGB_blocks.{i}.toRGB.module", equalized_lr)
    _check_consumed(sd, consumed, "generator")
    return out


def convert_discriminator_state_dict(sd: Mapping[str, Any], *, equalized_lr: bool = True
                                     ) -> Dict[str, np.ndarray]:
    """The reference `Discriminator.state_dict()` as the port's
    `Discriminator` state_dict (f32 numpy arrays)."""
    out: Dict[str, np.ndarray] = {}
    consumed: Set[str] = set()
    n_fromrgb = _count(sd, r"^fromRGB_blocks\.(\d+)\.")
    for i in range(n_fromrgb):
        _layer(out, consumed, f"fromrgb.{i}", sd, f"fromRGB_blocks.{i}.fromRGB.module",
               equalized_lr)
    n_blocks = _count(sd, r"^blocks\.(\d+)\.")
    if n_fromrgb != n_blocks + 1:
        raise KeyError(f"fromRGB count {n_fromrgb} != blocks+1 ({n_blocks + 1}) "
                       f"(`pggan/nets.py:227-239`)")
    _blocks(out, consumed, sd, n_blocks, equalized_lr, "discriminator")
    for target, prefix in (("last_conv", "minibatch_normalization_block.conv.module"),
                           ("last_linear", "minibatch_normalization_block.linear.module"),
                           ("decision", "decision_layer.module")):
        _layer(out, consumed, target, sd, prefix, equalized_lr)
    _check_consumed(sd, consumed, "discriminator")
    return out


def reference_schedule_meta(ckpt_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference checkpoint's schedule scalars (`pggan/model.py:54-64`)
    as the `meta['schedule']` dict `ProgressiveSchedule.load_state_dict`
    takes. The reference keeps `alpha_G` and `alpha_D` in lockstep
    (`pggan/model.py:176-194`); G's is taken and a mismatch raises."""
    alpha_g, alpha_d = float(ckpt_dict["alpha_G"]), float(ckpt_dict["alpha_D"])
    if alpha_g != alpha_d:
        raise ValueError(f"reference checkpoint has alpha_G={alpha_g} != alpha_D={alpha_d}; "
                         f"cannot map to the single-alpha schedule")
    return {
        "scale_index": int(ckpt_dict["scale_index"]),
        "alpha": alpha_g,
        "alpha_index": int(ckpt_dict["alpha_index"]),
        "alpha_jump_value": float(ckpt_dict["alpha_jump_value"]),
        "next_scale_jump_step": int(ckpt_dict["next_scale_jump_step"]),
        "next_alpha_jump_step": int(ckpt_dict["next_alpha_jump_step"]),
    }
