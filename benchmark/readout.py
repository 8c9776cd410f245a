"""Arithmetic the per-layer readers share: the kernels' roofline share,
the share of the peak and the idle share, from a run's readings (`ctx`).
Each returns None where the run read nothing to compute from, never 0."""

from __future__ import annotations

import importlib
import os
import pkgutil
import re
from typing import Optional

from benchmark import harness


def kernel_ops():
    """Every op module under kernels/."""
    path = os.path.join(harness.BENCH_DIR, "kernels")
    return [importlib.import_module(f"benchmark.kernels.{m.name}")
            for m in pkgutil.iter_modules([path])]


def _matches(names, kernel: str) -> bool:
    return any(re.search(rf"(?<![A-Za-z0-9_]){re.escape(n)}(?![A-Za-z0-9_])", kernel)
               for n in names)


def kernel_roofline(ctx: dict) -> Optional[float]:
    """100 × Σ bound time / Σ profiled time over the ops whose kernels ran
    in the profiled stretch. An op's bound over its calls is the larger of
    its operations at the f32 peak and its bytes at the HBM bandwidth, each
    input read once and each output written once."""
    prof = ctx.get("profile")
    if not ctx.get("on_card") or prof is None:
        return None
    bound = measured = 0.0
    for op in kernel_ops():
        seconds = sum(s for name, s in prof.kernel_s.items() if _matches(op.NAMES, name))
        if seconds <= 0.0:
            continue
        for kind in ctx["profiled_kinds"]:
            for shape in op.calls(ctx["model"], ctx["batch"], kind):
                flops, nbytes = op.cost(shape, ctx["itemsize"])
                bound += max(flops / harness.PEAK_F32_FLOPS, nbytes / harness.PEAK_HBM_BYTES_S)
        measured += seconds
    return 100.0 * bound / measured if measured > 0.0 and bound > 0.0 else None


def mfu(ctx: dict) -> Optional[float]:
    """100 × model FLOPs of the window / its wall / the card's dense peak at
    the configuration's precision: bf16's tensor-core peak, or float32's
    with TF32 off."""
    if not ctx.get("on_card") or not ctx.get("flops") or not ctx.get("window_s"):
        return None
    peak = harness.PEAK_BF16_FLOPS if ctx["itemsize"] == 2 else harness.PEAK_F32_FLOPS
    return 100.0 * ctx["flops"] / ctx["window_s"] / peak


def idle_share(ctx: dict) -> Optional[float]:
    prof = ctx.get("profile")
    if not ctx.get("on_card") or prof is None or prof.wall_s <= 0.0:
        return None
    return 100.0 * max(0.0, 1.0 - prof.busy_s / prof.wall_s)
