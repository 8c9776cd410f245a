"""The fault planted under the timed path of a StyleGAN3 cell, to show that
its check catches it (`calibrate_sg3.py` on the card, the CPU tests):
`answer_altered`, the last image of every forward of the generator is its
first one, as `faults_sg2.answer_altered` does to StyleGAN2's. `plant()`
patches the program before a run's set-up and returns a function that
undoes it."""

from __future__ import annotations


def answer_altered():
    from pggan_tpu_torch.models.stylegan3 import StyleGAN3Generator

    inner = StyleGAN3Generator.forward

    def forward(self, *args, **kwargs):
        out = inner(self, *args, **kwargs).clone()
        out[-1] = out[0]
        return out
    StyleGAN3Generator.forward = forward

    def undo():
        StyleGAN3Generator.forward = inner
    return undo


FAULTS = {"answer_altered": answer_altered}
