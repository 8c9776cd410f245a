#!/usr/bin/env python3
"""Where the time of the PyTorch port's train step (or sampling forward, or
filtered_lrelu) goes, on one CUDA card.

    python3 tools/profile_torch_step.py [--dtype bfloat16|float32]
        [--tf32] [--cudnn_benchmark] [--no_r1 | --forward | --filtered_lrelu]
        [--scale 6] [--batch 16] [--config configs.yaml]
        [--steps_per_dispatch 1] [--steps 3] [--top 15]

Builds G and D at `--scale` (default 6, 256×256) with the model of
`--config` (default configs.yaml: full width) from their seeded
initialisation, runs 2 warm-up steps, then profiles `--steps` train steps
at `--batch` (default 16) with `torch.profiler` (CPU and CUDA activities).
`--steps_per_dispatch N` > 1 profiles the step as the trainer's windows run
it on a card: captured in a CUDA graph (`train/graphs.py`) and replayed N
times a profiled step (the warm-up captures it); `--steps` then counts
windows.
Prints the wall time per step, the device's busy time per step (the union
of the kernels' intervals) and idle share, the kernel time summed over
streams, the launches of the port's kernels, the kernels that took the
most time (with their share of the summed kernel time), and the device time
of each of the port's own kernels (`csrc/`) with their share of busy.
`--cudnn_benchmark` lets cuDNN time its algorithms at the first call of each
shape (the warm-up steps) instead of choosing by heuristics. `--forward`
profiles G's sampling forward at batch 16 (no gradient) instead of the step;
`--filtered_lrelu` profiles `ops.filtered_lrelu` at [16, 64, 256, 256] with a
bias, [1,3,3,1] filters, up 2, down 2 and padding 3 (the ops path's largest
call in chip_smoke.py's phase 11).
Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SCALE, ALPHA = 16, 6, 0.5
PORT_KERNELS = ("norm_rows_vec_kernel", "norm_rows_kernel", "lrelu_norm_rows_bwd_vec_kernel",
                "lrelu_norm_rows_bwd_kernel", "mb_stddev_kernel", "bias_lrelu_gain_kernel")


def kernel_events(prof):
    """The device's kernels of a profile (an operator row, aten::..., repeats
    the time of the kernels it launched)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def busy_us(events) -> float:
    """The union of the kernels' intervals, µs: kernels on several streams
    overlap, so their summed time can exceed the window."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    parser.add_argument("--tf32", action="store_true",
                        help="let cuDNN and cuBLAS run f32 in TF32 (PyTorch's default)")
    parser.add_argument("--cudnn_benchmark", action="store_true",
                        help="torch.backends.cudnn.benchmark = True")
    parser.add_argument("--no_r1", action="store_true",
                        help="the step without R1 (the tail of a lazy window)")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--forward", action="store_true",
                      help="G's sampling forward instead of the train step")
    mode.add_argument("--filtered_lrelu", action="store_true",
                      help="ops.filtered_lrelu at [16,64,256,256] instead of the step")
    parser.add_argument("--scale", type=int, default=SCALE)
    parser.add_argument("--batch", type=int, default=BATCH)
    parser.add_argument("--config", default=os.path.join(REPO, "configs.yaml"),
                        help="the YAML whose model keys (depths, latent_dim, ...) to use")
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="> 1: replay the step captured in a CUDA graph this many "
                             "times a profiled step (the trainer's window on a card)")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--top", type=int, default=15)
    ns = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from pggan_tpu_torch.config import Config
    from pggan_tpu_torch.ops import kernels
    from pggan_tpu_torch.train.step import make_train_step
    from pggan_tpu_torch.train.trainer import ProgressiveGANTrainer

    torch.backends.cudnn.allow_tf32 = ns.tf32
    torch.backends.cuda.matmul.allow_tf32 = ns.tf32
    torch.backends.cudnn.benchmark = ns.cudnn_benchmark
    cfg = Config.from_yaml(ns.config)
    cfg.update(compute_dtype=ns.dtype, batch_per_gpu=ns.batch, use_mGPU=False)
    batch_size, res = ns.batch, 4 * 2 ** ns.scale
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16 if ns.dtype == "bfloat16" else torch.float32
    if ns.filtered_lrelu:
        from pggan_tpu_torch import ops
        x = torch.randn((batch_size, 256, 256, 64), generator=gen, device="cuda").to(dt)
        x = x.permute(0, 3, 1, 2)                          # channels_last
        b = torch.randn((64,), generator=gen, device="cuda")
        f = ops.setup_filter([1, 3, 3, 1])

        def run():
            with torch.no_grad():
                ops.filtered_lrelu(x, f, f, b, up=2, down=2, padding=3)
    else:
        trainer = ProgressiveGANTrainer(cfg, device="cuda")
        trainer.schedule.scale_index = ns.scale
        trainer.initialize_models()
        if ns.forward:
            G = trainer.state.G
            z = torch.randn((batch_size, int(cfg.latent_dim)), generator=gen, device="cuda")

            def run():
                with torch.no_grad():
                    G(z, ALPHA, compute_dtype=dt)
        else:
            batch = torch.randint(0, 256, (batch_size, res, res, 3), generator=gen,
                                  device="cuda", dtype=torch.uint8)
            if ns.steps_per_dispatch > 1:
                from pggan_tpu_torch.train.graphs import StepGraphs
                runner = StepGraphs(trainer.state, functools.partial(make_train_step, cfg,
                                                                     ns.scale), "cuda")
                kind = "tail" if ns.no_r1 else "step"

                def run():
                    for _ in range(ns.steps_per_dispatch):
                        runner.run(kind, batch, ALPHA)
            else:
                step = make_train_step(cfg, ns.scale, include_r1=not ns.no_r1)

                def run():
                    step(trainer.state, batch, ALPHA)
    for _ in range(2):
        run()
    torch.cuda.synchronize()

    graphed = ns.steps_per_dispatch > 1 and not (ns.forward or ns.filtered_lrelu)
    n = ns.steps * (ns.steps_per_dispatch if graphed else 1)       # train steps
    replayed = runner.launches_replayed() if graphed else {}
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    kernels.reset_launch_counts()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(ns.steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    launches = {k: v // n for k, v in kernels.launches.items()}
    if graphed:         # the wrappers count calls, which a replay makes none of
        launches = {k: (v - replayed[k]) // n for k, v in runner.launches_replayed().items()}
    events = kernel_events(prof)
    busy_ms = busy_us(events) / 1e3 / n
    summed_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / n
    streams = len({e.thread for e in events})
    by_name = {}
    for e in events:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    rows = [(total / 1e3 / n, count // n, name)
            for name, (total, count) in by_name.items()]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    what = ("sampling forward" if ns.forward else
            "filtered_lrelu [16,64,256,256] up 2 down 2" if ns.filtered_lrelu else
            f"train step {'without R1' if ns.no_r1 else 'with R1'}"
            + (f" x{ns.steps_per_dispatch} graph replays" if ns.steps_per_dispatch > 1 else ""))
    label = (f"{ns.dtype}{' TF32' if ns.tf32 else ''}"
             f"{' cudnn.benchmark' if ns.cudnn_benchmark else ''}")
    print(f"[profile] {what} {res}x{res} batch {batch_size}, {label} ({card}): wall "
          f"{wall_ms:.2f} ms/step under the profiler; device busy {busy_ms:.2f} "
          f"ms/step (idle {100 * max(0.0, 1 - busy_ms / wall_ms):.1f} %); kernel "
          f"time summed {summed_ms:.2f} ms/step on {streams} stream(s); the port's "
          f"kernel launches per step {launches}")
    for ms, count, name in sorted(rows, reverse=True)[:ns.top]:
        print(f"[profile]   {ms:9.3f} ms {100 * ms / summed_ms:5.1f} % x{count:<4d} "
              f"{name[:110]}")
    # The port's own kernels (csrc/), whatever their template arguments.
    ours = {k: [(ms, count) for ms, count, name in rows if f"::{k}<" in name]
            for k in PORT_KERNELS}
    ours_ms = sum(ms for found in ours.values() for ms, _ in found)
    print(f"[profile] the port's kernels {ours_ms:.3f} ms/step "
          f"({100 * ours_ms / busy_ms:.1f} % of busy): " + ", ".join(
              f"{k} {sum(ms for ms, _ in found):.3f} ms x{sum(c for _, c in found)}"
              for k, found in ours.items() if found))
    return 0


if __name__ == "__main__":
    sys.exit(main())
