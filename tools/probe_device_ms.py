#!/usr/bin/env python3
"""Why does chip_smoke.py's phase 10 read the f32 [16,64,64,256]
`lrelu_pixel_norm` backward at a device time above its own call time? A
probe on one CUDA card:

    python3 tools/probe_device_ms.py

At [16,64,64,256] (and [16,256,256,64] beside it), f32, it prints the call
time (eager calls, CUDA events) and chip_smoke's `device_ms` (20 calls
captured in a CUDA graph, replays timed, best of 3 groups) with every group's
time, and `device_ms` of a one-call graph, under three conditions: in a fresh
process; right after chip_smoke's phase 10 step timing (`time_train`: the
full-width R1, no-R1 and wgangp steps in bf16 and f32); and after 5 s idle.
Beside each it samples the card's SM and memory clocks, temperature, power
draw and the active clock-event reasons with nvidia-smi. Then, each after
the same short load (LOAD_STEPS f32 wgangp steps with TF32 on, the last
configuration of the step timing), four ways to time [16,64,64,256]:
`device_ms` twice back to back; `device_ms` after 0.2 s idle; `device_ms`
after `torch.cuda.empty_cache()`; and `device_ms` after WARM_MS of the same
kernel's captured calls. Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import copy
import importlib.util
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(16, 64, 64, 256), (16, 256, 256, 64)]
LOAD_STEPS, WARM_MS = 10, 200.0
QUERY = "clocks.sm,clocks.mem,temperature.gpu,power.draw,clocks_event_reasons.active"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def smi() -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={QUERY}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def group_times(fn, calls: int = 20, replays: int = 5, groups: int = 3):
    """chip_smoke.device_ms's capture and replays, every group's ms a call."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(3):
        graph.replay()
    times = []
    for _ in range(groups):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (replays * calls))
    return times


def measure(smoke, kernels, label, gen):
    for shape in SHAPES:
        x, g = smoke.nhwc(shape, torch.float32, gen), smoke.nhwc(shape, torch.float32, gen)
        kernel = lambda: kernels.lrelu_pixel_norm_bwd(x, g)  # noqa: E731
        before = smi()
        call = smoke.time_ms(kernel, 20)
        dev = smoke.device_ms(kernel, kernels, "lrelu_pixel_norm_bwd")
        groups = group_times(kernel)
        one = smoke.device_ms(kernel, kernels, "lrelu_pixel_norm_bwd", calls=1, replays=100)
        print(f"[probe] {label}: lrelu_pixel_norm_bwd {list(shape)} f32: call {call:.4f} ms; "
              f"device_ms {dev:.4f} ms (groups of a second capture "
              f"{', '.join(f'{t:.4f}' for t in groups)}); one-call graph {one:.4f} ms; "
              f"nvidia-smi before: {before}; after: {smi()}")
        del x, g
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_device_ms: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    smoke = _chip_smoke()
    from pggan_tpu_torch.config import Config
    from pggan_tpu_torch.ops import _build, kernels
    from pggan_tpu_torch.train import step as step_mod

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    card = smoke.card_line()
    print(f"[probe] card: {card}; query {QUERY}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    measure(smoke, kernels, "fresh process", gen)

    cfg = Config.from_yaml(os.path.join(REPO, "configs.yaml"))
    depths = [int(d) for d in cfg.depths]
    args = cfg.to_dict()
    args.update(batch_per_gpu=smoke.BATCH, loss_mode="r1", r1_interval=1)
    step_cfg = Config(args)
    arrays_g = smoke.numpy_generator_arrays(1234, int(cfg.latent_dim), depths, smoke.SCALE)
    arrays_d = smoke.numpy_discriminator_arrays(4321, depths, smoke.SCALE)
    t0 = time.perf_counter()
    smoke.time_train(step_mod, kernels, step_cfg, arrays_g, arrays_d, gen, card)
    print(f"[probe] phase 10's step timing took {time.perf_counter() - t0:.1f} s")
    measure(smoke, kernels, "right after the step timing", gen)
    time.sleep(5.0)
    measure(smoke, kernels, "after 5 s idle", gen)

    load_cfg = copy.deepcopy(step_cfg)
    load_cfg.update(loss_mode="wgangp")
    load_state = smoke.train_state(step_mod, load_cfg, arrays_g, arrays_d)
    load_step = step_mod.make_train_step(load_cfg, smoke.SCALE)
    batch = torch.randint(0, 256, (smoke.BATCH, smoke.RES, smoke.RES, 3), generator=gen,
                          device="cuda", dtype=torch.uint8)

    def load():
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        for _ in range(LOAD_STEPS):
            load_step(load_state, batch, smoke.ALPHA)
        torch.cuda.synchronize()
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    x, g = (smoke.nhwc(SHAPES[0], torch.float32, gen) for _ in range(2))
    kernel = lambda: kernels.lrelu_pixel_norm_bwd(x, g)  # noqa: E731

    def dev():
        return smoke.device_ms(kernel, kernels, "lrelu_pixel_norm_bwd")

    def warm_then_time():
        graph_fn = lambda: group_times(kernel, groups=1)  # noqa: E731
        t0 = time.perf_counter()
        while (time.perf_counter() - t0) * 1e3 < WARM_MS:
            graph_fn()
        return dev()

    trials = [("device_ms twice back to back", lambda: (dev(), dev())),
              ("0.2 s idle, then device_ms", lambda: (time.sleep(0.2), dev())[1]),
              ("empty_cache, then device_ms", lambda: (torch.cuda.empty_cache(), dev())[1]),
              (f"{WARM_MS:.0f} ms of replays, then device_ms", warm_then_time),
              ("device_ms twice back to back (again)", lambda: (dev(), dev()))]
    for label, trial in trials:
        load()
        before = smi()
        result = trial()
        print(f"[probe] after {LOAD_STEPS} f32 TF32-on wgangp steps, {label}: {result} ms; "
              f"nvidia-smi before: {before}; after: {smi()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
