"""% of the port's kernels' profiled time that their bytes at the HBM
bandwidth need (kernels/*.py), in the traced stretch."""

from benchmark import readout


def read(ctx):
    return readout.kernel_roofline(ctx)
