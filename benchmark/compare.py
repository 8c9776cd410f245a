"""The numbers the correctness check compares, and the verdict.

Training (each network's leaves, G and D apart):
- `loss_gap`: the largest |program − reference| / max(|reference|, 1) over
  the checked steps' L_D and L_G; `first_loss_gap` the same of the first
  step alone, steady from seed to seed where the later steps carry the
  first updates' round-off;
- `grad_gap`: the first step's gradient as each optimizer got it, by the
  worst leaf: | ‖g_program‖ − ‖g_reference‖ | over the larger of the
  reference's norm of that leaf and of the network's median leaf;
- `change_gap`: the same for the weights' change over the checked steps;
- `grad_median_gap`, `change_median_gap`: the median leaf's gap of each,
  steady from seed to seed where the worst leaf swings;
- `grad_diff`: the first step's gradient, the median leaf's ‖program −
  reference‖ over the same denominator. A gap of norms moves only at
  second order under rounding noise that is independent of the values, so
  it cannot tell one precision from the next; the norm of the difference
  moves at first order. (The weights' change has no such number: Adam's
  first steps move each weight by about ±lr, whose sign flips wherever
  the gradient is near 0, so its difference swings from seed to seed.)
- `batch_mismatch`: bytes of the steps' batches that differ from the
  reference's own draw of them.
A leaf whose reference gradient is under a thousandth of its network's
median leaf's moves by round-off alone and is left out of both gaps.

Sampling: `image_gap`, the largest RMS difference in 8-bit levels between
an image served and the reference's image of the same latents.

A run is correct when every number is at or under its limit and no step or
request failed.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

Norms = Dict[str, Dict[str, float]]      # network -> leaf -> norm
Tensors = Dict[str, Dict[str, torch.Tensor]]
IGNORED_BELOW = 1e-3


def leaf_norms(tensors: Tensors) -> Norms:
    return {net: {k: float(torch.linalg.vector_norm(v.float())) for k, v in leaves.items()}
            for net, leaves in tensors.items()}


def to_host(tensors: Tensors) -> Tensors:
    """f32 copies on the host, where the program's and the reference's meet."""
    return {net: {k: v.detach().float().cpu() for k, v in leaves.items()}
            for net, leaves in tensors.items()}


def changes(after: Tensors, before: Tensors) -> Tensors:
    return {net: {k: v.detach().float().cpu() - before[net][k].detach().float().cpu()
                  for k, v in leaves.items()} for net, leaves in after.items()}


def kept_leaves(ref_grads: Norms) -> Dict[str, List[str]]:
    out = {}
    for net, norms in ref_grads.items():
        median = statistics.median(norms.values())
        out[net] = [k for k, v in norms.items() if v >= IGNORED_BELOW * median]
    return out


def _relative(gap: Dict[str, Dict[str, float]], reference: Norms,
              kept: Dict[str, List[str]]) -> Dict[str, float]:
    """'<net>.<leaf>' → gap[net][leaf] over the larger of the reference's norm
    of the leaf and of its network's median leaf."""
    out = {}
    for net, leaves in kept.items():
        median = statistics.median(reference[net][k] for k in leaves)
        for k in leaves:
            out[f"{net}.{k}"] = gap[net][k] / max(reference[net][k], median)
    return out


def leaf_gaps(program: Norms, reference: Norms, kept: Dict[str, List[str]]) -> Dict[str, float]:
    """| ‖program‖ − ‖reference‖ | of each kept leaf, relative."""
    gap = {net: {k: abs(program[net][k] - reference[net][k]) for k in leaves}
           for net, leaves in kept.items()}
    return _relative(gap, reference, kept)


def diff_gaps(program: Tensors, reference: Tensors, reference_norms: Norms,
              kept: Dict[str, List[str]]) -> Dict[str, float]:
    """‖program − reference‖ of each kept leaf, relative."""
    gap = {net: {k: float(torch.linalg.vector_norm(program[net][k] - reference[net][k]))
                 for k in leaves} for net, leaves in kept.items()}
    return _relative(gap, reference_norms, kept)


def gap_look(program: Norms, reference: Norms, kept: Dict[str, List[str]]) -> dict:
    """What stands behind a worst-leaf gap: the worst leaf, its size, and
    the median leaf's gap of each network."""
    gaps = leaf_gaps(program, reference, kept)
    worst = max(gaps, key=gaps.get)
    net, leaf = worst.split(".", 1)
    return {"worst": worst, "worst_ref_norm": reference[net][leaf],
            **{f"median_gap_{n}": statistics.median(v for k, v in gaps.items()
                                                    if k.startswith(n + "."))
               for n in kept}}


def diff_look(program: Tensors, reference: Tensors, kept: Dict[str, List[str]]) -> dict:
    """The median leaf's difference of each network, and the leaf that
    differs most."""
    diffs = diff_gaps(program, reference, leaf_norms(reference), kept)
    return {"worst": max(diffs, key=diffs.get),
            **{f"median_diff_{n}": statistics.median(v for k, v in diffs.items()
                                                     if k.startswith(n + "."))
               for n in kept}}


def loss_gap(program: List[Dict[str, float]], reference: List[Dict[str, float]]) -> float:
    """The largest gap of L_D and L_G over the steps, relative to the
    reference's loss or to 1 nat, whichever is larger: a BCE near 0 (a
    saturated logit) would make a purely relative gap ill-conditioned."""
    return max(abs(p[k] - r[k]) / max(abs(r[k]), 1.0)
               for p, r in zip(program, reference) for k in ("L_D", "L_G"))


def training_numbers(program: dict, reference: dict) -> Dict[str, float]:
    """`program` and `reference`: {'losses': [...], 'grads': Tensors,
    'change': Tensors}, on the host."""
    out = {"loss_gap": loss_gap(program["losses"], reference["losses"]),
           "first_loss_gap": loss_gap(program["losses"][:1], reference["losses"][:1])}
    ref_norms = {key: leaf_norms(reference[key]) for key in ("grads", "change")}
    kept = kept_leaves(ref_norms["grads"])
    for name, key in (("grad", "grads"), ("change", "change")):
        gaps = leaf_gaps(leaf_norms(program[key]), ref_norms[key], kept)
        out[f"{name}_gap"] = max(gaps.values())
        out[f"{name}_median_gap"] = statistics.median(gaps.values())
    out["grad_diff"] = statistics.median(
        diff_gaps(program["grads"], reference["grads"], ref_norms["grads"], kept).values())
    return out


def image_gap(served: torch.Tensor, reference: torch.Tensor) -> float:
    """uint8 [N, H, W, C] twice → the largest per-image RMS difference."""
    d = served.float() - reference.float()
    return float(d.square().reshape(d.shape[0], -1).mean(dim=1).sqrt().max())


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            failed: int) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {'value', 'limit'}}) over the limits' names; a
    number the run could not read counts as over its limit."""
    checks = {name: {"value": numbers.get(name), "limit": limit}
              for name, limit in limits.items()}
    ok = failed == 0 and all(c["value"] is not None and c["value"] <= c["limit"]
                             for c in checks.values())
    return ok, checks
