"""Faults planted under the timed path, to show that the check catches
them (the CPU tests, and `calibrate.py` on the card at the cell's size).
Each `plant()` patches the program before a run's set-up and returns a
function that undoes the patch.

- `state_unchanged`: Adam's step does nothing, so a train step returns the
  state it was given;
- `half_batch`: the BCE losses take the mean over the first half of the
  batch and leave the rest out;
- `answer_altered`: the last image of every forward of G is its first one.
"""

from __future__ import annotations


def state_unchanged():
    import torch

    inner = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, *args, **kwargs: None

    def undo():
        torch.optim.Adam.step = inner
    return undo


def half_batch():
    from pggan_tpu_torch.losses import gan
    from pggan_tpu_torch.train import step

    inner = gan.bce_with_logits

    def half(logits, target):
        return inner(logits[:max(1, logits.shape[0] // 2)], target)
    gan.bce_with_logits = step.bce_with_logits = half

    def undo():
        gan.bce_with_logits = step.bce_with_logits = inner
    return undo


def answer_altered():
    from pggan_tpu_torch.models.generator import Generator

    inner = Generator.forward

    def forward(self, *args, **kwargs):
        out = inner(self, *args, **kwargs).clone()
        out[-1] = out[0]
        return out
    Generator.forward = forward

    def undo():
        Generator.forward = inner
    return undo


FAULTS = {"train": {"state_unchanged": state_unchanged, "half_batch": half_batch},
          "sample": {"answer_altered": answer_altered}}
