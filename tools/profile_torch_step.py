#!/usr/bin/env python3
"""Where the time of the PyTorch port's train step (or sampling forward, or
filtered_lrelu) goes, on one CUDA card.

    python3 tools/profile_torch_step.py [--dtype bfloat16|float32]
        [--tf32] [--cudnn_benchmark] [--no_r1 | --forward | --filtered_lrelu]
        [--steps 3] [--top 15]

Builds G and D at scale 6 (256×256) at the full width of configs.yaml from
their seeded initialisation, runs 2 warm-up steps, then profiles `--steps`
train steps at batch 16 with `torch.profiler` (CPU and CUDA activities).
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
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SCALE, ALPHA = 16, 6, 0.5
PORT_KERNELS = ("norm_rows_vec_kernel", "norm_rows_kernel", "lrelu_norm_rows_bwd_vec_kernel",
                "lrelu_norm_rows_bwd_kernel", "mb_stddev_kernel", "bias_lrelu_gain_kernel")


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
    cfg = Config.from_yaml(os.path.join(REPO, "configs.yaml"))
    cfg.update(compute_dtype=ns.dtype, batch_per_gpu=BATCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16 if ns.dtype == "bfloat16" else torch.float32
    if ns.filtered_lrelu:
        from pggan_tpu_torch import ops
        x = torch.randn((BATCH, 256, 256, 64), generator=gen, device="cuda").to(dt)
        x = x.permute(0, 3, 1, 2)                          # channels_last
        b = torch.randn((64,), generator=gen, device="cuda")
        f = ops.setup_filter([1, 3, 3, 1])

        def run():
            with torch.no_grad():
                ops.filtered_lrelu(x, f, f, b, up=2, down=2, padding=3)
    else:
        trainer = ProgressiveGANTrainer(cfg, device="cuda")
        trainer.schedule.scale_index = SCALE
        trainer.initialize_models()
        if ns.forward:
            G = trainer.state.G
            z = torch.randn((BATCH, int(cfg.latent_dim)), generator=gen, device="cuda")

            def run():
                with torch.no_grad():
                    G(z, ALPHA, compute_dtype=dt)
        else:
            step = make_train_step(cfg, SCALE, include_r1=not ns.no_r1)
            batch = torch.randint(0, 256, (BATCH, 256, 256, 3), generator=gen,
                                  device="cuda", dtype=torch.uint8)

            def run():
                step(trainer.state, batch, ALPHA)
    for _ in range(2):
        run()
    torch.cuda.synchronize()

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    kernels.reset_launch_counts()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(ns.steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ns.steps
    launches = {k: v // ns.steps for k, v in kernels.launches.items()}

    def is_kernel(evt):
        # A kernel is the device's own event; an operator row (aten::...)
        # repeats the time of the kernels it launched.
        return (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False))
    events = [e for e in prof.events() if is_kernel(e)]
    # Busy = the union of the kernels' intervals: kernels on several streams
    # overlap, so their summed time can exceed the window.
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    busy_ms = busy_us / 1e3 / ns.steps
    summed_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / ns.steps
    streams = len({e.thread for e in events})
    by_name = {}
    for e in events:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    rows = [(total / 1e3 / ns.steps, count // ns.steps, name)
            for name, (total, count) in by_name.items()]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    what = ("sampling forward" if ns.forward else
            "filtered_lrelu [16,64,256,256] up 2 down 2" if ns.filtered_lrelu else
            f"train step {'without R1' if ns.no_r1 else 'with R1'}")
    label = (f"{ns.dtype}{' TF32' if ns.tf32 else ''}"
             f"{' cudnn.benchmark' if ns.cudnn_benchmark else ''}")
    print(f"[profile] {what} 256x256 batch {BATCH}, {label} ({card}): wall "
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
