"""% of the traced stretch in which no operation ran on the card: 1 − the
union of the kernels' intervals / the stretch's wall (torch.profiler)."""

from benchmark import readout


def read(ctx):
    return readout.idle_share(ctx)
