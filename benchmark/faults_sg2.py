"""The fault planted under the timed path of a StyleGAN2 cell, to show that
its check catches it (`calibrate_sg2.py` on the card, the CPU tests):
`answer_altered`, the last image of every forward of the generator is its
first one, as `faults.answer_altered` does to PGGAN's. `plant()` patches the
program before a run's set-up and returns a function that undoes it."""

from __future__ import annotations


def answer_altered():
    from pggan_tpu_torch.models.stylegan2 import StyleGAN2Generator

    inner = StyleGAN2Generator.forward

    def forward(self, *args, **kwargs):
        out = inner(self, *args, **kwargs).clone()
        out[-1] = out[0]
        return out
    StyleGAN2Generator.forward = forward

    def undo():
        StyleGAN2Generator.forward = inner
    return undo


FAULTS = {"answer_altered": answer_altered}
