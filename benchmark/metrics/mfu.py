"""% of the card's dense peak at the configuration's precision that the
window's model FLOPs (flops.py) over its wall make."""

from benchmark import readout


def read(ctx):
    return readout.mfu(ctx)
