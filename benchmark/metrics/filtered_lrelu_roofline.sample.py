"""% of the profiled time of StyleGAN3's FIR kernels (kernels/
filtered_lrelu_fir.py: the upfirdn2d kernels of its 28 filtered-leaky-ReLU
stages a forward) that their work needs at the card's peaks: Σ bound /
Σ time in the traced stretch, each input read once and each output written
once at the HBM bandwidth against the separable form's operations at f32's
peak (moves sample_img_per_s)."""

from benchmark import harness, readout
from benchmark.kernels import filtered_lrelu_fir as op


def read(ctx):
    prof = ctx.get("profile")
    if not ctx.get("on_card") or prof is None:
        return None
    seconds = sum(s for name, s in prof.kernel_s.items() if readout._matches(op.NAMES, name))
    bound = 0.0
    for kind in ctx.get("profiled_kinds", []):
        for shape in op.calls(ctx["model"], ctx["batch"], kind):
            flops, nbytes = op.cost(shape, ctx["itemsize"])
            bound += max(flops / harness.PEAK_F32_FLOPS, nbytes / harness.PEAK_HBM_BYTES_S)
    return 100.0 * bound / seconds if seconds > 0.0 and bound > 0.0 else None
