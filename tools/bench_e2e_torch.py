#!/usr/bin/env python3
"""The PyTorch port's trainer rate at a fixed scale — data pipeline, host
dispatch and step, the rate a `python -m pggan_tpu_torch.train` run sees —
beside the device time of the steps it runs (the counterpart of
tools/bench_e2e.py, which drives the JAX package):

    python tools/bench_e2e_torch.py --scale 4 --steps_per_dispatch 1
    python tools/bench_e2e_torch.py --scale 4 --steps_per_dispatch 8
    python tools/bench_e2e_torch.py --scale 6 --r1_interval 16 [--eager] [--profile]

Builds the trainer at `--scale` directly (schedule pinned, alpha 1, no
jumps: a steady stretch mid-stage), feeds it synthetic data (`--data_root`
for a folder, `--device_data_cache` for the device cache), and times the
`train_step` / `train_chunk` / `train_window` calls as `fit` issues them in
a stretch with no host action: with `--r1_interval` r > 1 lazy-R1 windows
of r steps, with `--steps_per_dispatch` k > 1 windows of k steps, else
single steps. On a card the windows replay the steps captured in CUDA
graphs (`train/graphs.py`); `--eager` runs their eager steps instead.

Prints one JSON line: the trainer's img/s and ms a step; on a card the
device time of each kind of step the windows run (its CUDA graph replayed
back to back, timed with CUDA events), the steps' own ms a step from those,
and `outside_share`, the share of the trainer's time outside the steps
(1 − steps' ms / trainer's ms); with `--profile`, `idle_share`, the device's
idle share over one more window (`torch.profiler`: 1 − the union of the
kernels' intervals over the wall). The model is `--config`'s (depths,
latent_dim, ...) or, without one, the defaults with the reference's depth
law at `--scale` (full width). `--device cpu` runs the eager steps on the
CPU; its device numbers are null (not measured). Imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch  # noqa: E402

# graph replays timed a kind of step, after as many untimed
DEVICE_REPLAYS = 5


def _config(ns, save_root):
    from pggan_tpu_torch.config import Config, default_depths

    cfg = Config.from_yaml(ns.config) if ns.config else Config(
        {"depths": default_depths(ns.scale)})
    cfg.update({
        "batch_per_gpu": ns.batch, "compute_dtype": ns.compute_dtype,
        "loss_mode": ns.loss_mode, "r1_interval": ns.r1_interval,
        "steps_per_dispatch": ("auto" if ns.steps_per_dispatch == "auto"
                               else int(ns.steps_per_dispatch)),
        "data_backend": "synthetic" if ns.data_root is None else "folder",
        "dataset_root_list": [] if ns.data_root is None else [ns.data_root],
        "synthetic_dataset_size": 256, "use_mGPU": False, "ckpt_id": None,
        "use_validation": False, "fid_cycle": 0,
        # cycles no run reaches: the timed stretch holds no host action
        "loss_cycle": 10**9, "test_cycle": 10**9, "ckpt_cycle": 10**9,
        "save_root": save_root,
    })
    if ns.device_data_cache is not None:
        cfg["device_data_cache"] = (True if ns.device_data_cache == "true"
                                    else ns.device_data_cache)
        cfg["device_cache_mb"] = 512
    return cfg


def _device_ms(trainer, kinds):
    """{kind: ms} of each kind's captured step replayed back to back (CUDA
    events), capturing a kind the run has not (a real step of the run)."""
    runner = trainer._step_graphs()
    alpha = float(trainer.schedule.alpha)
    out = {}
    for kind in kinds:
        if kind not in runner.captured:
            runner.run(kind, next(trainer._pipeline), alpha, r1_scale=trainer._r1_interval)
        graph = runner.captured[kind].graph
        for _ in range(DEVICE_REPLAYS):
            graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(DEVICE_REPLAYS):
            graph.replay()
        end.record()
        end.synchronize()
        out[kind] = start.elapsed_time(end) / DEVICE_REPLAYS
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=120,
                    help="timed steps (rounded up to whole windows)")
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--steps_per_dispatch", default="1")
    ap.add_argument("--r1_interval", type=int, default=1)
    ap.add_argument("--compute_dtype", default="bfloat16")
    ap.add_argument("--loss_mode", default="r1")
    ap.add_argument("--data_root", default=None, help="folder dataset instead of synthetic")
    ap.add_argument("--device_data_cache", default=None,
                    help="'true'|'auto': the device-resident dataset (data/device_cache.py); "
                         "with --data_root")
    ap.add_argument("--config", default=None,
                    help="a YAML whose model keys to use (default: the defaults, full width)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eager", action="store_true",
                    help="run the windows' eager steps on a card instead of graph replays")
    ap.add_argument("--profile", action="store_true",
                    help="also the device's idle share over one window (torch.profiler)")
    ns = ap.parse_args(argv)
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_e2e_torch: no CUDA card; pass --device cpu", file=sys.stderr)
        return 1
    from pggan_tpu_torch.registry import create_model

    with tempfile.TemporaryDirectory(prefix="bench_e2e_torch_") as tmp:
        trainer = create_model(_config(ns, tmp), device=device)
        try:
            result = _bench(trainer, ns, device)
        finally:
            trainer.close()
    print(json.dumps(result))
    return 0


def _bench(trainer, ns, device):
    on_card = device.type == "cuda"
    # pin the schedule mid-stage at the scale: alpha 1, no pending jump; then
    # rebuild the networks, data and step there (the checkpoint-load path)
    sched = trainer.schedule
    sched.scale_index = ns.scale
    sched.alpha = 1.0
    # the scale starts at this step (the data stream from its first batch)
    sched.next_scale_jump_step = (trainer.global_step
                                  + int(trainer.cfg.max_step_at_scale[ns.scale]))
    sched.next_alpha_jump_step = 0
    trainer.initialize_models()
    trainer.set_dataset()
    trainer.set_data_iterator()
    trainer._build_step_fn()
    trainer.use_graphs = on_card and not ns.eager

    lazy = trainer._r1_interval > 1
    k = trainer._r1_interval if lazy else trainer._chunk_size
    block = (trainer.train_window if lazy else
             trainer.train_chunk if k > 1 else lambda _: trainer.train_step())

    def sync():
        loss = float(trainer._last_metrics["L_D"])     # waits for the device
        if loss != loss:
            raise RuntimeError("non-finite loss")

    done, t0 = 0, time.perf_counter()
    while done < max(ns.warmup, 2 * k):     # windows: the capture, then a replay
        block(k)
        done += k
    sync()
    warm_s = time.perf_counter() - t0

    timed = -(-ns.steps // k) * k
    done, t0 = 0, time.perf_counter()
    while done < timed:
        block(k)
        done += k
    sync()
    elapsed = time.perf_counter() - t0
    step_ms = 1e3 * elapsed / done

    kinds = ["lead", "tail"] if lazy else ["step"]
    device_ms = steps_ms = outside = idle = None
    if on_card:
        device_ms = _device_ms(trainer, kinds)
        steps_ms = ((device_ms["lead"] + (k - 1) * device_ms["tail"]) / k if lazy
                    else device_ms["step"])
        outside = 1.0 - steps_ms / step_ms
        if ns.profile:
            idle = _idle_share(block, k, sync)
    res = 2 ** (ns.scale + 2)
    return {
        "metric": f"trainer images/sec, {res}x{res} (data, dispatch and step, "
                  f"{ns.loss_mode}, {ns.compute_dtype})",
        "value": round(done * trainer.batch_size / elapsed, 2),
        "unit": "images/sec",
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "card": _card() if on_card else None,
        "scale": ns.scale, "batch": trainer.batch_size,
        "r1_interval": trainer._r1_interval,
        "steps_per_dispatch": 1 if lazy else k,
        "dispatch": "graphs" if trainer.use_graphs and k > 1 else "eager",
        "steps": done,
        "step_ms": round(step_ms, 3),
        "device_step_ms": device_ms and {n: round(v, 3) for n, v in device_ms.items()},
        "steps_ms": steps_ms and round(steps_ms, 3),
        "outside_share": outside and round(outside, 4),
        "idle_share": idle and round(idle, 4),
        "warmup_s": round(warm_s, 2),
        "device_data_cache": trainer.cfg.device_data_cache,
    }


def _idle_share(block, k, sync) -> float:
    """1 − busy / wall over one window (one step when there are none) under
    torch.profiler; busy is the union of the kernels' intervals."""
    from profile_torch_step import busy_us, kernel_events

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        block(k)
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    return max(0.0, 1.0 - busy_us(kernel_events(prof)) / wall_us)


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


if __name__ == "__main__":
    raise SystemExit(main())
