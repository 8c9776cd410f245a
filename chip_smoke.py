#!/usr/bin/env python3
"""Drive the PyTorch port's sampling, training and ops paths once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. the card (nvidia-smi name and power limit, torch's device name);
  2. build the CUDA kernels from pggan_tpu_torch/csrc with nvcc, one
     process per source, all at once (timed);
  3. each forward kernel against its plain PyTorch version on the card, f32
     and bf16, at the sampling path's shapes and at shapes that reach every
     branch of the row kernels (the vector branch at several lane and
     vector counts; the generic branch for rows that are not a multiple of
     16 bytes, rows over the cap, and [B, C] views whose pointer is not
     16-byte aligned), with the branch each input took and the output's
     strides;
  4. the sampling slice at the full width of configs.yaml: write a scale-6
     (256×256) G checkpoint in the JAX package's npz format (numpy-seeded
     weights, alpha 0.5), run `pggan_tpu_torch.demo` for 32 images at batch
     16, check the JPEGs and the kernel launch counts (2 pixel_norm and 13
     lrelu_pixel_norm per forward);
  5. the full-width forward with the kernels against the same forward with
     the plain versions, and a small generator on the card against the CPU;
  6. times on the card: sampling img/s; each kernel's call time (eager
     calls) and device time (calls captured in a CUDA graph and replayed)
     against its plain version, pixel_norm also against F.rms_norm; where
     the host time of a small pixel_norm call goes (checks, allocation,
     launch, glue); the fused upscale+conv against conv(upscale2d(x)); peak
     memory;
  7. the backward kernel of lrelu_pixel_norm and the minibatch-stddev kernel
     against their plain versions, f32 and bf16, at the train path's shapes
     and ragged ones, and the first and second derivatives of the
     minibatch-stddev autograd rule against autograd of its plain version;
  8. the training slice through its entry point: a JAX-format G+D checkpoint
     (params and a fresh Adam state) at scale 6, full width, resumed by
     `pggan_tpu_torch.train.main` for a few r1 steps at batch 16 in bf16 on
     synthetic data, a checkpoint cycle included; checks the loss lines, that
     G and D moved, the checkpoints' JAX key sets and the launches per step
     (4 pixel_norm, 26 lrelu_pixel_norm, 13 backward, 3 minibatch-stddev);
  9. one f32 step (TF32 off) at full width with the kernels against the same
     step with the plain versions, from the same state and latents: losses
     and Adam's first moments (= the gradients, β1 = 0);
 10. times on the card: the R1 step and the step without R1, each in bf16,
     f32 with TF32 off and f32 with TF32 on; peak memory; the train path's
     kernels against their plain versions (call and device time);
 11. the StyleGAN2-ops path (`pggan_tpu_torch.ops`): the bias_lrelu_gain
     kernel against its plain version (f32 and bf16, the epilogue shapes and
     ragged ones, with and without a bias) and its rule's first and second
     derivatives against autograd of the plain version; bias_act and
     filtered_lrelu at the two top blocks' shapes through the ops entry
     points with the launch counts (1 per leaky-ReLU call, none otherwise)
     and kernel path vs plain path; a small case of every ops function on
     the card against the CPU, grid_sample's second derivatives included;
     times of the kernel, its plain version and filtered_lrelu.

The second-to-last lines are a JSON object describing the kernels and the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a CUDA device, and imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import io
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH, SCALE, ALPHA = 16, 6, 0.5
RES = 4 * 2 ** SCALE
DEVICE = "cuda"
# f32: kernel and plain differ only in the order of the channel sum and in
# rsqrtf's last bits. bf16: additionally one bf16 rounding of the output,
# which can land one bf16 ulp (2^-8 relative) apart.
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}
# Whole forward, f32 with TF32 off: kernel-level differences of ~1e-7
# relative, carried through 13 convolutions, on outputs of magnitude ~1-5.
FORWARD_ATOL = 1e-4
# The backward kernel sums two products per row where the plain version
# sums one each, and the result can cancel to ~0: f32 atol 1e-5 on values of
# order 1. bf16 as the forward (one bf16 rounding of the output).
BWD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
           torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}
# Minibatch-stddev: f32 output either way, sums in another order.
MB_TOL = dict(rtol=1e-5, atol=1e-6)
FORWARD_KERNELS = ("pixel_norm", "lrelu_pixel_norm")
TRAIN_STEPS = 4            # steps of the training slice (phase 8)
# One f32 step (TF32 off), kernel path vs plain path (phase 9): bounds on
# the relative loss difference and on the gradient difference relative to
# the largest gradient of each network. Measured on an H100 over two runs:
# losses up to 2.1e-7, gradients up to 4.4e-4 — and the kernel path run
# twice differs by up to 2.1e-7 and 2.6e-4, because cuDNN's backward
# algorithms do not sum in a fixed order. The bounds leave about 4.5x
# (gradients) and 50x (losses) over that.
STEP_LOSS_RTOL, STEP_GRAD_RTOL = 1e-5, 2e-3
# Phase 11: the ragged shapes of phase 3, bias_lrelu_gain's (slope, gain)
# pairs, the filtered_lrelu shapes (the two top blocks of the 256² model at
# batch 16) and bias_act's activations.
RAGGED = [(2, 3, 3, 16), (2, 4, 4, 513), (2, 4, 4, 96)]
# Phase 3 also holds every branch of the forward row kernels: the vector
# branch at each row width (C = 16 and 96 with a lane count under 32 and
# part-filled lanes; 1024 f32 and 2048 bf16 at the cap of 8 vectors a lane;
# C = 4 f32, one vector a row) and the generic one (C = 513, bf16 C = 4, C
# = 2048 f32 over the cap, and MISALIGNED [B, C] views).
BRANCH_SHAPES = RAGGED + [(2, 3, 3, 4), (2, 2, 2, 1024), (2, 2, 2, 2048)]
MISALIGNED = [(BATCH, 512), (BATCH, 64)]
BIAS_PARAMS = ((0.2, math.sqrt(2.0)), (0.1, 1.0))
OPS_SHAPES = [(BATCH, 128, 128, 128), (BATCH, 256, 256, 64)]
ACTIVATIONS = ("linear", "relu", "lrelu", "tanh", "sigmoid", "elu", "selu", "softplus",
               "swish")
# Call times of inputs of at most SMALL_NUMEL elements (host-bound
# launches) are means over SMALL_ITERS calls, not 20.
SMALL_NUMEL, SMALL_ITERS = BATCH * 4 * 4 * 512, 200
# H100 SXM datasheet peaks: HBM bytes/s, f32 FLOP/s off
# the tensor cores.
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, message: str) -> None:
    if not cond:
        raise SmokeFailure(message)


def nhwc(shape, dtype, gen):
    """A random [B, C, H, W] channels_last (or [B, C]) tensor from an NHWC shape."""
    x = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
    return x.permute(0, 3, 1, 2) if x.ndim == 4 else x


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def abba_ms(*fns, iters: int = 20):
    """Times in turns, each function in order and then in reverse order
    (plain, kernel, kernel, plain); the mean of each function's pair."""
    first = [time_ms(fn, iters) for fn in fns]
    second = [time_ms(fn, iters) for fn in reversed(fns)][::-1]
    return [(a + b) / 2 for a, b in zip(first, second)]


def device_ms(fn, kernels=None, name=None, calls: int = 20, replays: int = 5,
              groups: int = 3) -> float:
    """The device time of one call: `calls` calls captured in one CUDA graph
    (after warm-up on a side stream), `replays` replays of it timed with
    CUDA events, so no host work sits between the launches; the best of
    `groups` such timings, after 3 untimed replays (the card may have
    lowered its clock while the host-bound calls before left it idle). A
    wrapper launches on the current stream, which is the capture stream
    while capturing, so its launches are captured. Checks that the launch
    count of `name` moved once per captured call and not during the
    replays, and that the replayed graph wrote what the call computes
    eagerly: the last captured output is set to NaN before the replays, so
    a launch made outside the graph would leave it NaN."""
    want = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = kernels.launches[name] if name else 0
    with torch.cuda.graph(graph):
        for _ in range(calls):
            out = fn()
    if name:
        check(kernels.launches[name] - before == calls,
              f"{name}: {kernels.launches[name] - before} launches in a capture of {calls} calls")
    out.fill_(float("nan"))
    for _ in range(3):
        graph.replay()
    best = float("inf")
    for _ in range(groups):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / (replays * calls))
    if name:
        check(kernels.launches[name] - before == calls, f"{name}: launched during a replay")
    check(torch.equal(out, want), f"{name or 'call'}: the replayed graph's output differs "
                                  f"from the eager call's")
    return best


@contextlib.contextmanager
def plain_epilogues(kernels):
    """Route the generator's pixel_norm / lrelu_pixel_norm to the plain
    PyTorch versions, for comparison and timing only."""
    with mock.patch.object(kernels, "pixel_norm", kernels.pixel_norm_plain), \
            mock.patch.object(kernels, "lrelu_pixel_norm",
                              kernels.lrelu_pixel_norm_plain):
        yield


@contextlib.contextmanager
def plain_kernels(kernels):
    """Route G's and D's kernel calls to the plain PyTorch versions, which
    autograd differentiates itself (no kernel forward or backward)."""
    with plain_epilogues(kernels), mock.patch.object(
            kernels, "minibatch_stddev_stat", kernels.minibatch_stddev_stat_plain):
        yield


def epilogue_shapes(depths, scale, batch):
    """NHWC input of every lrelu_pixel_norm call of one forward, in order."""
    shapes = [(batch, 4, 4, depths[0])]
    for i in range(1, scale + 1):
        shapes += [(batch, 4 * 2 ** i, 4 * 2 ** i, depths[i])] * 2
    return shapes


def numpy_generator_arrays(seed, latent_dim, depths, scale, output_dim=3):
    """G weights in the JAX package's checkpoint layout, drawn with numpy:
    N(0, 1) weights, U(±1/sqrt(fan_in)) biases, He constants."""
    rng = np.random.default_rng(seed)

    def layer(prefix, w_shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return {f"{prefix}/w": rng.standard_normal(w_shape, dtype=np.float32),
                f"{prefix}/b": rng.uniform(-bound, bound, w_shape[-1]).astype(np.float32),
                f"{prefix}/scale": np.asarray(np.sqrt(2.0 / fan_in), np.float32)}

    def conv(prefix, k, cin, cout):
        return layer(prefix, (k, k, cin, cout), k * k * cin)

    d0 = depths[0]
    arrays = layer("format", (latent_dim, 16 * d0), latent_dim)
    arrays.update(conv("first_conv", 3, d0, d0))
    arrays.update(conv("torgb/0", 1, d0, output_dim))
    for i in range(1, scale + 1):
        arrays.update(conv(f"blocks/{i - 1}/conv0", 3, depths[i - 1], depths[i]))
        arrays.update(conv(f"blocks/{i - 1}/conv1", 3, depths[i], depths[i]))
        arrays.update(conv(f"torgb/{i}", 1, depths[i], output_dim))
    return arrays


def numpy_discriminator_arrays(seed, depths, scale, input_dim=3):
    """D weights in the JAX package's checkpoint layout, drawn as
    `numpy_generator_arrays` draws G's."""
    rng = np.random.default_rng(seed)

    def conv(prefix, k, cin, cout):           # k = 0: a linear layer
        fan_in = k * k * cin if k else cin
        bound = 1.0 / np.sqrt(fan_in)
        shape = (k, k, cin, cout) if k else (cin, cout)
        return {f"{prefix}/w": rng.standard_normal(shape, dtype=np.float32),
                f"{prefix}/b": rng.uniform(-bound, bound, cout).astype(np.float32),
                f"{prefix}/scale": np.asarray(np.sqrt(2.0 / fan_in), np.float32)}

    d0 = depths[0]
    arrays = conv("fromrgb/0", 1, input_dim, d0)
    arrays.update(conv("last_conv", 3, d0 + 1, d0))
    arrays.update(conv("last_linear", 0, 16 * d0, d0))
    arrays.update(conv("decision", 0, d0, 1))
    for i in range(1, scale + 1):
        arrays.update(conv(f"fromrgb/{i}", 1, input_dim, depths[i]))
        arrays.update(conv(f"blocks/{i - 1}/conv0", 3, depths[i], depths[i]))
        arrays.update(conv(f"blocks/{i - 1}/conv1", 3, depths[i], depths[i - 1]))
    return arrays


def fresh_adam_arrays(params):
    """optax's Adam state before its first step, flattened as in a JAX
    checkpoint."""
    opt = {"0/count": np.asarray(0, np.int32)}
    for moment in ("mu", "nu"):
        opt.update({f"0/{moment}/{k}": np.zeros_like(v) for k, v in params.items()})
    return opt


def bound_ms(nbytes, flops):
    """The least time the card could take: bytes over HBM bandwidth or f32
    operations over the f32 peak, whichever is larger. Returns (ms, by)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return smi.splitlines()[0]


def misaligned_rows(shape, dtype, gen):
    """A random contiguous [B, C] view that starts one element into its
    storage, so its pointer is not 16-byte aligned."""
    flat = torch.randn(shape[0] * shape[1] + 1, generator=gen, device=DEVICE).to(dtype)
    return flat[1:].view(shape)


def check_kernels(kernels, shapes, gen):
    """Phase 3: every forward kernel against its plain version, f32 and bf16,
    at `shapes` (NHWC or [B, C]) and at MISALIGNED [B, C] views one element
    into their storage; each input's branch as the C side picks it. Checks
    that the widths of configs.yaml take the vector branch and the
    misaligned views, C = 513 and bf16 rows under 16 bytes the generic one.
    Returns {kernel: {dtype: max |diff|}}."""
    max_err = {name: {dt: 0.0 for dt in TOL} for name in FORWARD_KERNELS}
    branches = {}
    cases = [(shape, False) for shape in shapes] + [(s, True) for s in MISALIGNED]
    with torch.no_grad():
        for (shape, shifted), (dt, tol) in itertools.product(cases, TOL.items()):
            x = misaligned_rows(shape, dt, gen) if shifted else nhwc(shape, dt, gen)
            plan = kernels.row_kernel_plan(x)
            label = f"{list(shape)}{' +1' if shifted else ''} {str(dt)[6:]}"
            branches[label] = plan
            row_bytes = shape[-1] * x.element_size()
            if shifted or row_bytes % 16 or row_bytes > 4096:
                check(plan == (0, 0), f"{label}: expected the generic branch, got {plan}")
            elif shape[-1] in (64, 128, 256, 512):
                check(plan != (0, 0), f"{label}: expected the vector branch")
            for name in FORWARD_KERNELS:
                got = getattr(kernels, name)(x)
                want = getattr(kernels, name + "_plain")(x)
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    got, want, **tol, msg=lambda m: f"{name} {label}: {m}")
                check(got.stride() == want.stride(), f"{name} {label}: strides "
                      f"{got.stride()}, plain {want.stride()}")
                err = float((got.float() - want.float()).abs().max())
                max_err[name][dt] = max(max_err[name][dt], err)
    print("[3 kernels] branches (lanes a row, 16-byte vectors a lane; (0, 0) = generic): "
          + ", ".join(f"{k} {v}" for k, v in branches.items()))
    return max_err


def run_demo(demo, kernels, cfg, depths, tmp):
    """Phase 4: a JAX-format checkpoint at full width, sampled through the
    demo's entry point. Returns the kernel launches of that run."""
    from PIL import Image
    from pggan_tpu_torch.utils import checkpoint as ckpt_lib

    arrays = numpy_generator_arrays(1234, int(cfg.latent_dim), depths, SCALE)
    ckpt_lib.save_checkpoint(tmp, "smoke", "G", 0, params=arrays, meta={
        "args": cfg.to_dict(), "schedule": {"scale_index": SCALE, "alpha": ALPHA}})
    out_dir = os.path.join(tmp, "samples")
    n_samples = 2 * BATCH
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = demo.main(["--ckpt_id", "smoke", "--save_root", tmp, "--device", "cuda",
                    "--n_samples", str(n_samples), "--batch_size", str(BATCH),
                    "--output_dir", out_dir])
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check(rc == 0, f"demo returned {rc}")
    forwards = n_samples // BATCH
    want = {"pixel_norm": 2 * forwards, "lrelu_pixel_norm": 13 * forwards,
            "lrelu_pixel_norm_bwd": 0, "minibatch_stddev_stat": 0, "bias_lrelu_gain": 0}
    check(launches == want, f"launches {launches}, expected {want}")
    files = sorted(os.listdir(out_dir))
    check(len(files) == n_samples, f"{len(files)} files written")
    for name in files:
        with Image.open(os.path.join(out_dir, name)) as img:
            check(img.size == (256, 256) and img.mode == "RGB",
                  f"{name}: {img.size} {img.mode}")
    print(f"[4 slice] demo wrote {len(files)} JPEGs of 256x256 from a JAX-format "
          f"scale-{SCALE} checkpoint in {demo_s:.2f} s (checkpoint load, "
          f"{forwards} forwards, JPEG writes); launches {launches} = "
          f"{forwards} forwards x (2, 13)")
    return launches


def check_forward(kernels, generator, z, alpha):
    """Phase 5: kernel path against plain path at full width, and a small
    generator on the card against the same one on the CPU."""
    from pggan_tpu_torch.models.generator import Generator

    with torch.no_grad():
        out_kernel = generator(z, alpha)
        with plain_epilogues(kernels):
            out_plain = generator(z, alpha)
    check(out_kernel.shape == (BATCH, 256, 256, 3), f"shape {out_kernel.shape}")
    check(bool(torch.isfinite(out_kernel).all()), "non-finite output")
    forward_err = float((out_kernel - out_plain).abs().max())
    torch.testing.assert_close(out_kernel, out_plain, rtol=0.0, atol=FORWARD_ATOL)
    print(f"[5 forward] 256x256 batch {BATCH} f32: kernel path vs plain path max "
          f"|diff| {forward_err:.3g} (atol {FORWARD_ATOL}); output range "
          f"[{float(out_kernel.min()):.3f}, {float(out_kernel.max()):.3f}]")

    small = Generator(latent_dim=64, depths=[64, 64, 32, 16], scale=3, seed=7,
                      init_bias_to_zero=False)
    z_small = torch.randn((4, 64), generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        want_cpu = small(z_small, 0.5)
        got_card = small.to("cuda")(z_small.to("cuda"), 0.5).cpu()
    small_err = float((got_card - want_cpu).abs().max())
    torch.testing.assert_close(got_card, want_cpu, rtol=0.0, atol=FORWARD_ATOL)
    print(f"[5 forward] small G (depths [64,64,32,16], 32x32): card vs CPU max "
          f"|diff| {small_err:.3g} (atol {FORWARD_ATOL})")


def time_sampling(kernels, generator, z, alpha, card):
    """Phase 6a: one forward at batch 16, kernel path and plain path."""
    for dt in (torch.float32, torch.bfloat16):
        def kernel_fwd(dt=dt):
            generator(z, alpha, compute_dtype=dt)

        def plain_fwd(dt=dt):
            with plain_epilogues(kernels):
                generator(z, alpha, compute_dtype=dt)
        plain_ms, kernel_ms = abba_ms(plain_fwd, kernel_fwd, iters=10)
        torch.cuda.reset_peak_memory_stats()
        kernel_fwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        print(f"[6 times] sampling 256x256 batch {BATCH} {str(dt)[6:]}: kernel "
              f"path {kernel_ms:.3f} ms/batch = {BATCH / kernel_ms * 1e3:.1f} img/s; "
              f"plain path {plain_ms:.3f} ms = {BATCH / plain_ms * 1e3:.1f} img/s; "
              f"peak memory {peak:.0f} MiB ({card})")
    torch.backends.cudnn.allow_tf32 = True
    tf32_ms = time_ms(lambda: generator(z, alpha), iters=10)
    torch.backends.cudnn.allow_tf32 = False
    print(f"[6 times] sampling f32 with cuDNN TF32 on (PyTorch's default): "
          f"kernel path {tf32_ms:.3f} ms = {BATCH / tf32_ms * 1e3:.1f} img/s ({card})")


def time_kernels(kernels, path_shapes, gen, card):
    """Phase 6b: each kernel against its plain version at pixel_norm's two
    path shapes and the three largest epilogue shapes: the call time (eager
    calls, host work included) and the device time (`device_ms`); pixel_norm
    also against F.rms_norm, the one PyTorch call that computes its
    function, in the same turns. Returns {(kernel, shape, dtype): (call ms,
    device ms, plain ms)} and {(shape, dtype): (F.rms_norm call ms, device
    ms)} at pixel_norm's 4-D shapes."""
    import torch.nn.functional as F

    times, rms = {}, {}
    timed = [("pixel_norm", (BATCH, 512)), ("pixel_norm", (BATCH, 4, 4, 512))] + [
        (name, shape) for name in FORWARD_KERNELS
        for shape in sorted(set(path_shapes), key=np.prod)[-3:]]
    for name, shape in timed:
        for dt in (torch.float32, torch.bfloat16):
            x = nhwc(shape, dt, gen)
            fns = [lambda: getattr(kernels, name + "_plain")(x),
                   lambda: getattr(kernels, name)(x)]
            with_rms = name == "pixel_norm" and len(shape) == 4
            if with_rms:
                # the same NHWC rows as a contiguous [..., C] tensor
                x_rows = x.permute(0, 2, 3, 1)
                fns.append(lambda: F.rms_norm(x_rows, [shape[-1]], eps=1e-8))
            # host-bound calls: more of them, so a hiccup of the host's clock
            # weighs less
            iters = SMALL_ITERS if x.numel() <= SMALL_NUMEL else 20
            plain_ms, kernel_ms, *rms_turns = abba_ms(*fns, iters=iters)
            kernel_dev = device_ms(fns[1], kernels, name)
            gbps = 2 * x.numel() * x.element_size() / (kernel_dev * 1e-3) / 1e9
            times[(name, shape, dt)] = (kernel_ms, kernel_dev, plain_ms)
            line = (f"[6 times] {name} {list(shape)} {str(dt)[6:]}: kernel call "
                    f"{kernel_ms:.4f} ms, device {kernel_dev:.4f} ms ({gbps:.0f} GB/s of "
                    f"one read + one write); plain call {plain_ms:.4f} ms")
            if with_rms:
                rms_call, rms_dev = rms[(shape, dt)] = (rms_turns[0], device_ms(fns[2]))
                err = float((fns[2]().permute(0, 3, 1, 2).float() - fns[1]().float())
                            .abs().max())
                line += (f"; F.rms_norm call {rms_call:.4f} ms, device {rms_dev:.4f} ms "
                         f"(max |diff| to the kernel {err:.3g})")
            print(f"{line} ({card})")
    return times, rms


def host_us(fn, calls: int = 2000, loops: int = 5) -> float:
    """Host time of one call in µs by the host clock: the best of `loops`
    loops of `calls` calls, each loop then waited for on the card. For a
    call whose host work outlasts its kernel, this is the call time without
    the card's timing in the way."""
    best = float("inf")
    for _ in range(loops + 1):                   # the first loop warms up
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return best


def time_launch_path(kernels, gen, card):
    """Phase 6c: where the host time of one pixel_norm call at [16,4,4,512]
    f32 goes (a launch-bound call: its kernel takes ~2 µs), beside
    F.rms_norm's: the whole call, and of it the checks (`kernel_rows`), the
    output's allocation and the launch (ctypes into the C entry point and
    its cudaLaunchKernel); the rest is Python glue. The launch is timed by
    calling the C entry point directly, outside the wrapper, so it is not
    counted."""
    import torch.nn.functional as F
    from pggan_tpu_torch.ops import _build

    x = nhwc((BATCH, 4, 4, 512), torch.float32, gen)
    x_rows, y = x.permute(0, 2, 3, 1), torch.empty_like(x)
    rows, cols = kernels.kernel_rows(x)
    entry = _build.load_library().pggan_pixel_norm_fwd
    stream = torch.cuda.current_stream().cuda_stream
    parts = {"whole call": lambda: kernels.pixel_norm(x),
             "checks": lambda: kernels.kernel_rows(x),
             "allocation": lambda: torch.empty_like(x),
             "launch": lambda: entry(x.data_ptr(), y.data_ptr(), rows, cols, 0, 1e-8,
                                     stream)}
    us = {label: host_us(fn) for label, fn in parts.items()}
    rms_us = host_us(lambda: F.rms_norm(x_rows, [512], eps=1e-8))
    glue = us["whole call"] - us["checks"] - us["allocation"] - us["launch"]
    print(f"[6 host] pixel_norm [16, 4, 4, 512] float32, host µs a call (best of 5 loops of "
          f"2000 calls): {us['whole call']:.2f} = checks {us['checks']:.2f} + allocation "
          f"{us['allocation']:.2f} + launch (ctypes, C entry point, cudaLaunchKernel) "
          f"{us['launch']:.2f} + Python glue {glue:.2f}; F.rms_norm {rms_us:.2f} ({card})")


def time_block_heads(generator, depths, gen, card):
    """Phase 6d: each block's conv0, the dilated form against
    conv(upscale2d(x)). Tolerance f32 1e-3 (TF32 off; sums of up to 4608
    products in another order); bf16 0.25 (the merged taps are rounded to
    bf16 once, the plain form rounds each tap, on outputs up to ~10)."""
    from pggan_tpu_torch.ops.basic import upscale2d
    from pggan_tpu_torch.ops.equalized import equalized_conv2d
    from pggan_tpu_torch.ops.fused_scale import upscale_conv3x3_dilated

    for i in range(1, SCALE + 1):
        res = 4 * 2 ** (i - 1)
        conv0 = generator.blocks[i - 1].conv0
        w, b, s = conv0.weight, conv0.bias, conv0.scale
        for dt in (torch.float32, torch.bfloat16):
            x = nhwc((BATCH, res, res, depths[i - 1]), dt, gen)

            def fused():
                return upscale_conv3x3_dilated(x, w, b, s, compute_dtype=dt)

            def plain():
                return equalized_conv2d(upscale2d(x), w, b, s, compute_dtype=dt)
            err = float((fused().float() - plain().float()).abs().max())
            check(err < (1e-3 if dt == torch.float32 else 0.25),
                  f"fused block {i} {dt}: |diff| {err}")
            plain_ms, fused_ms = abba_ms(plain, fused)
            print(f"[6 times] block {i} conv0 {depths[i - 1]}->{depths[i]} at "
                  f"{res}->{2 * res} {str(dt)[6:]}: dilated {fused_ms:.4f} ms, "
                  f"conv(upscale2d) {plain_ms:.4f} ms (max |diff| {err:.3g}) ({card})")


def check_train_kernels(kernels, path_shapes, gen):
    """Phase 7: the backward kernel and the minibatch-stddev kernel against
    their plain versions, and the minibatch-stddev rule's first and second
    derivatives. Returns {kernel: {dtype: max |diff|}}."""
    max_err = {name: {dt: 0.0 for dt in TOL}
               for name in ("lrelu_pixel_norm_bwd", "minibatch_stddev_stat")}
    bwd_shapes = sorted(set(path_shapes)) + [(2, 3, 3, 16), (2, 4, 4, 513),
                                              (2, 4, 4, 96)]
    mb_shapes = [((BATCH, 4, 4, 512), 4), ((2 * BATCH, 4, 4, 512), 4),
                 ((6, 4, 4, 512), 6), ((2, 4, 4, 512), 2)]
    with torch.no_grad():
        for dt in TOL:
            for shape in bwd_shapes:
                x, g = nhwc(shape, dt, gen), nhwc(shape, dt, gen)
                got = kernels.lrelu_pixel_norm_bwd(x, g)
                want = kernels.lrelu_pixel_norm_bwd_plain(x, g)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, **BWD_TOL[dt], msg=lambda m: (
                    f"lrelu_pixel_norm_bwd {shape} {dt}: {m}"))
                check(got.is_contiguous(memory_format=torch.channels_last),
                      f"lrelu_pixel_norm_bwd {shape}: layout")
                err = float((got.float() - want.float()).abs().max())
                max_err["lrelu_pixel_norm_bwd"][dt] = max(
                    max_err["lrelu_pixel_norm_bwd"][dt], err)
            for shape, sg in mb_shapes:
                x = nhwc(shape, dt, gen)
                got = kernels.minibatch_stddev_stat(x, sg)
                want = kernels.minibatch_stddev_stat_plain(x, sg)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, **MB_TOL, msg=lambda m: (
                    f"minibatch_stddev_stat {shape} sg {sg} {dt}: {m}"))
                err = float((got - want).abs().max())
                max_err["minibatch_stddev_stat"][dt] = max(
                    max_err["minibatch_stddev_stat"][dt], err)
    for name, errs in max_err.items():
        shapes = bwd_shapes if name == "lrelu_pixel_norm_bwd" else mb_shapes
        tol = BWD_TOL if name == "lrelu_pixel_norm_bwd" else {dt: MB_TOL for dt in TOL}
        print(f"[7 kernels] {name}: {len(shapes)} shapes match the plain version; "
              f"max |diff| f32 {errs[torch.float32]:.3g} ({tol[torch.float32]}), "
              f"bf16 {errs[torch.bfloat16]:.3g} ({tol[torch.bfloat16]})")

    # Derivatives: the rule's backward (torch ops) against autograd of the
    # plain version, through R1's pattern grad(create_graph=True) then grad.
    x = nhwc((BATCH, 4, 4, 512), torch.float32, gen).requires_grad_(True)
    w = torch.randn((BATCH // 4,), generator=gen, device=DEVICE)
    v = torch.randn(x.shape, generator=gen, device=DEVICE)
    derivs = []
    for fn in (kernels.minibatch_stddev_stat, kernels.minibatch_stddev_stat_plain):
        (g1,) = torch.autograd.grad((fn(x, 4) * w).sum(), x, create_graph=True)
        check(g1.requires_grad, "the first derivative is not differentiable")
        (g2,) = torch.autograd.grad((g1 * v).sum(), x)
        derivs.append((g1.detach(), g2))
    (k1, k2), (p1, p2) = derivs
    scale1, scale2 = float(p1.abs().max()), float(p2.abs().max())
    err1, err2 = float((k1 - p1).abs().max()), float((k2 - p2).abs().max())
    # Relative to the largest entry: the two differ in summation order and
    # in the formula (the rule drops the mean's term, which is zero).
    check(err1 <= 1e-4 * scale1 and err2 <= 1e-4 * scale2,
          f"minibatch-stddev derivatives: |diff| {err1:.3g} of {scale1:.3g}, "
          f"{err2:.3g} of {scale2:.3g}")
    print(f"[7 kernels] minibatch_stddev_stat derivatives at {[BATCH, 4, 4, 512]} "
          f"f32, rule vs autograd of plain: first max |diff| {err1:.3g} (largest "
          f"entry {scale1:.3g}), second {err2:.3g} (largest {scale2:.3g}); bound "
          f"1e-4 of the largest entry")
    return max_err


def train_checkpoint(ckpt_lib, cfg, depths, tmp):
    """A JAX-format G+D checkpoint at scale 6, full width, numpy-seeded
    weights and a fresh Adam state; the schedule inside scale 6 at alpha
    0.5 with no jump within the run. Returns (args, G arrays, D arrays,
    start step)."""
    arrays_g = numpy_generator_arrays(1234, int(cfg.latent_dim), depths, SCALE)
    arrays_d = numpy_discriminator_arrays(4321, depths, SCALE)
    args = cfg.to_dict()
    args.update(batch_per_gpu=BATCH, loss_cycle=1, ckpt_cycle=2,
                data_backend="synthetic", use_validation=False, fid_cycle=0,
                loss_mode="r1", r1_interval=1, compute_dtype="float32",
                save_root=tmp)
    scale_end = sum(int(n) for n in args["max_step_at_scale"][:SCALE + 1])
    scale_start = scale_end - int(args["max_step_at_scale"][SCALE])
    # alpha reached 0.5 at its 200th of 400 jumps, 100 steps apart
    start = scale_start + int(args["alpha_jump_start"][SCALE]) + 199 * 100 + 50
    schedule = {"scale_index": SCALE, "alpha": ALPHA, "alpha_index": 200,
                "alpha_jump_value": 1.0 / 400, "next_scale_jump_step": scale_end,
                "next_alpha_jump_step": start + 50}
    for name, arrays in (("G", arrays_g), ("D", arrays_d)):
        ckpt_lib.save_checkpoint(tmp, "smoke_init", name, start, params=arrays,
                                 opt=fresh_adam_arrays(arrays),
                                 meta={"args": args, "schedule": schedule})
    return args, arrays_g, arrays_d, start


def run_train(train_mod, kernels, ckpt_lib, cfg, depths, tmp):
    """Phase 8: the training slice through `pggan_tpu_torch.train.main`.
    Returns (launches of the run, args, G arrays, D arrays)."""
    args, arrays_g, arrays_d, start = train_checkpoint(ckpt_lib, cfg, depths, tmp)
    config = os.path.join(tmp, "smoke_train.yaml")
    with open(config, "w") as f:
        json.dump({"save_root": tmp}, f)            # JSON is YAML
    end = start + TRAIN_STEPS
    out = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train_mod.main(["smoke_train", "--config", config, "--ckpt_id",
                             "smoke_init", "--max_step", str(end), "--compute_dtype",
                             "bfloat16", "--device", DEVICE])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    lines = out.getvalue().splitlines()
    for line in lines:
        print(f"[8 train]   {line}")
    check(rc == 0, f"train main returned {rc}")
    losses = [line for line in lines if line.startswith("lossD:")]
    check(len(losses) == TRAIN_STEPS, f"{len(losses)} loss lines")
    for line in losses:
        d, g = line.replace("lossD:", "").split("| lossG:")
        check(np.isfinite(float(d)) and np.isfinite(float(g)), f"loss line {line!r}")
    per_step = {"pixel_norm": 4, "lrelu_pixel_norm": 26, "lrelu_pixel_norm_bwd": 13,
                "minibatch_stddev_stat": 3, "bias_lrelu_gain": 0}
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    check(launches == want, f"launches {launches}, expected {want}")
    ckpt_steps = sorted(int(f.split("_")[1][:-4]) for f in os.listdir(
        ckpt_lib.ckpt_dir(tmp, "smoke_train")) if f.startswith("G_") and "latest" not in f)
    check(ckpt_steps == [start + 2, end], f"checkpoint steps {ckpt_steps}")
    for name, before in (("G", arrays_g), ("D", arrays_d)):
        params, opt, meta = ckpt_lib.load_checkpoint(tmp, "smoke_train", name, end)
        check(set(params) == set(before), f"{name}: params key set")
        check(set(opt) == set(fresh_adam_arrays(before)), f"{name}: opt key set")
        check(int(opt["0/count"]) == TRAIN_STEPS, f"{name}: Adam count {opt['0/count']}")
        moved = sum(not np.array_equal(params[k], before[k]) for k in before
                    if not k.endswith("/scale"))
        check(moved > 0, f"{name} did not move")
        check(meta["args"]["compute_dtype"] == "bfloat16", f"{name}: args")
    print(f"[8 train] pggan_tpu_torch.train.main resumed a JAX-format scale-{SCALE} "
          f"checkpoint at step {start} and ran {TRAIN_STEPS} r1 steps at {RES}x{RES}, "
          f"batch {BATCH}, bf16, in {train_s:.2f} s (checkpoint load, data, steps, "
          f"checkpoints at {ckpt_steps}); G and D moved; launches {launches} = "
          f"{TRAIN_STEPS} steps x {per_step}")
    return launches, args, arrays_g, arrays_d


def train_state(step_mod, cfg, arrays_g, arrays_d):
    from pggan_tpu_torch.models import discriminator, generator
    G = generator.params_from_jax(arrays_g).to(DEVICE)
    D = discriminator.params_from_jax(arrays_d).to(DEVICE)
    return step_mod.init_train_state(cfg, G, D, torch.Generator(device=DEVICE).manual_seed(0))


def compare_step(step_mod, kernels, equalized, cfg, arrays_g, arrays_d, gen):
    """Phase 9: one f32 step (TF32 off) with the kernels and one with the
    plain versions, from the same state, batch and latents."""
    batch = torch.randint(0, 256, (BATCH, RES, RES, 3), generator=gen, device=DEVICE,
                          dtype=torch.uint8)
    z1 = torch.randn((BATCH, int(cfg.latent_dim)), generator=gen, device=DEVICE)
    z2 = torch.randn((BATCH, int(cfg.latent_dim)), generator=gen, device=DEVICE)
    step = step_mod.make_train_step(cfg, SCALE)
    runs = {}
    # the kernel path twice: the spread of cuDNN's own run-to-run differences
    for label, plain in (("kernel", False), ("plain", True), ("kernel again", False)):
        state = train_state(step_mod, cfg, arrays_g, arrays_d)
        with plain_kernels(kernels) if plain else contextlib.nullcontext():
            metrics = step(state, batch, ALPHA, z1=z1, z2=z2)
        runs[label] = ({k: float(v) for k, v in metrics.items()},
                       {n: equalized.adam_state_to_jax(o, net) for n, net, o in
                        (("D", state.D, state.opt_D), ("G", state.G, state.opt_G))})
    print(f"[9 step] f32 TF32 off, {RES}x{RES} batch {BATCH}: kernel path losses "
          f"{ {k: round(v, 6) for k, v in runs['kernel'][0].items()} }")

    def differences(a, b):
        (m_a, mom_a), (m_b, mom_b) = runs[a], runs[b]
        loss = max(abs(m_a[k] - m_b[k]) / max(abs(m_b[k]), 1e-12) for k in m_b)
        grads = {}
        for net in ("D", "G"):
            keys = [k for k in mom_b[net] if k.startswith("0/mu/")]
            largest = max(float(np.abs(mom_b[net][k]).max()) for k in keys)
            diff = max(float(np.abs(mom_a[net][k] - mom_b[net][k]).max()) for k in keys)
            grads[net] = diff / largest
        print(f"[9 step] {a} vs {b}: largest relative loss difference {loss:.3g}; "
              f"gradient (Adam mu, beta1 = 0) max |diff| over the largest |g|: "
              f"D {grads['D']:.3g}, G {grads['G']:.3g}")
        return loss, max(grads.values())
    loss_rel, grad_rel = differences("kernel", "plain")
    differences("kernel again", "kernel")
    check(loss_rel <= STEP_LOSS_RTOL, f"loss difference {loss_rel:.3g}")
    check(grad_rel <= STEP_GRAD_RTOL, f"gradient difference {grad_rel:.3g}")
    print(f"[9 step] bounds: losses rtol {STEP_LOSS_RTOL}, gradients "
          f"{STEP_GRAD_RTOL} of the largest gradient of each network")


def time_train(step_mod, kernels, cfg, arrays_g, arrays_d, gen, card):
    """Phase 10a: step ms, img/s and peak memory of the R1 step and of the
    step without R1, in bf16, f32 with TF32 off and f32 with TF32 on."""
    batch = torch.randint(0, 256, (BATCH, RES, RES, 3), generator=gen, device=DEVICE,
                          dtype=torch.uint8)
    for label, dtype, tf32 in (("bf16", "bfloat16", False),
                               ("f32 TF32 off", "float32", False),
                               ("f32 TF32 on", "float32", True)):
        run_cfg = copy.deepcopy(cfg)
        run_cfg["compute_dtype"] = dtype
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        state = train_state(step_mod, run_cfg, arrays_g, arrays_d)
        for r1 in (True, False):
            step = step_mod.make_train_step(run_cfg, SCALE, include_r1=r1)
            for _ in range(2):
                step(state, batch, ALPHA)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            n = 5
            t0 = time.perf_counter()
            for _ in range(n):
                step(state, batch, ALPHA)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / n * 1e3
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            print(f"[10 times] train step {RES}x{RES} batch {BATCH} {label}, "
                  f"{'R1' if r1 else 'no R1 (lazy-window tail)'}: {ms:.2f} ms = "
                  f"{BATCH / ms * 1e3:.1f} img/s; peak memory {peak:.0f} MiB "
                  f"(host clock over {n} steps after 2 warm-up) ({card})")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def time_train_kernels(kernels, gen, card):
    """Phase 10b: the train path's kernels at their largest path shapes
    against their plain versions (no one PyTorch call computes either):
    call time and device time. Returns {(kernel, dtype): (call ms, device
    ms, plain ms)}."""
    times = {}
    for dt in (torch.float32, torch.bfloat16):
        x, g = nhwc((BATCH, 256, 256, 64), dt, gen), nhwc((BATCH, 256, 256, 64), dt, gen)
        kernel = lambda: kernels.lrelu_pixel_norm_bwd(x, g)  # noqa: E731
        plain_ms, kernel_ms = abba_ms(lambda: kernels.lrelu_pixel_norm_bwd_plain(x, g), kernel)
        kernel_dev = device_ms(kernel, kernels, "lrelu_pixel_norm_bwd")
        times[("lrelu_pixel_norm_bwd", dt)] = (kernel_ms, kernel_dev, plain_ms)
        gbps = 3 * x.numel() * x.element_size() / (kernel_dev * 1e-3) / 1e9
        print(f"[10 times] lrelu_pixel_norm_bwd [16,256,256,64] {str(dt)[6:]}: kernel "
              f"call {kernel_ms:.4f} ms, device {kernel_dev:.4f} ms ({gbps:.0f} GB/s of two "
              f"reads + one write); plain call {plain_ms:.4f} ms ({card})")
        m = nhwc((BATCH, 4, 4, 512), dt, gen)
        kernel = lambda: kernels.minibatch_stddev_stat(m, 4)  # noqa: E731
        plain_ms, kernel_ms = abba_ms(lambda: kernels.minibatch_stddev_stat_plain(m, 4), kernel,
                                      iters=SMALL_ITERS)
        kernel_dev = device_ms(kernel, kernels, "minibatch_stddev_stat")
        times[("minibatch_stddev_stat", dt)] = (kernel_ms, kernel_dev, plain_ms)
        print(f"[10 times] minibatch_stddev_stat [16,4,4,512] sg 4 {str(dt)[6:]}: "
              f"kernel call {kernel_ms:.4f} ms, device {kernel_dev:.4f} ms; plain call "
              f"{plain_ms:.4f} ms ({card})")
    return times


@contextlib.contextmanager
def plain_bias_act(kernels):
    """Route bias_act's leaky ReLU (and so filtered_lrelu's) to the plain
    version of bias_lrelu_gain, for comparison and timing only."""
    with mock.patch.object(kernels, "bias_lrelu_gain", kernels.bias_lrelu_gain_plain):
        yield


def check_bias_act_kernel(kernels, path_shapes, gen):
    """Phase 11a: the bias_lrelu_gain kernel against its plain version, f32
    and bf16, at every conv-epilogue shape, [16, 512] and three ragged
    shapes; an f32 bias, a bias in x's dtype and none; (slope, gain) of
    (0.2, √2) and (0.1, 1). Returns {dtype: max |diff|}."""
    shapes = [(BATCH, 512)] + sorted(set(path_shapes)) + RAGGED
    max_err = {dt: 0.0 for dt in TOL}
    calls = 0
    with torch.no_grad():
        for shape in shapes:
            for dt, tol in TOL.items():
                x = nhwc(shape, dt, gen)
                b32 = torch.randn((shape[-1],), generator=gen, device=DEVICE)
                biases = [b32, None] + ([b32.to(dt)] if dt != torch.float32 else [])
                for b, (slope, gain) in itertools.product(biases, BIAS_PARAMS):
                    got = kernels.bias_lrelu_gain(x, b, slope, gain)
                    want = kernels.bias_lrelu_gain_plain(x, b, slope, gain)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got, want, **tol, msg=lambda m: (
                        f"bias_lrelu_gain {shape} {dt} b {None if b is None else b.dtype} "
                        f"({slope}, {gain}): {m}"))
                    check(got.stride() == x.stride(), f"bias_lrelu_gain {shape}: layout")
                    max_err[dt] = max(max_err[dt], float((got.float() - want.float()).abs().max()))
                    calls += 1
    print(f"[11 ops] bias_lrelu_gain: {calls} calls over {len(shapes)} shapes, f32 and bf16 "
          f"x, f32 / x-dtype / no bias, (slope, gain) in {BIAS_PARAMS}, match the plain "
          f"version; max |diff| f32 {max_err[torch.float32]:.3g} ({TOL[torch.float32]}), "
          f"bf16 {max_err[torch.bfloat16]:.3g} ({TOL[torch.bfloat16]})")

    # Refusals on the card: no copy into another layout, no fallback.
    x = nhwc((2, 4, 4, 8), torch.float32, gen)
    for label, call, error in (
            ("NCHW-contiguous", lambda: kernels.bias_lrelu_gain(x.contiguous()), ValueError),
            ("float16", lambda: kernels.bias_lrelu_gain(x.half()), TypeError),
            ("a bias of the wrong length", lambda: kernels.bias_lrelu_gain(
                x, torch.zeros(4, device=DEVICE)), ValueError)):
        try:
            call()
        except error:
            continue
        raise SmokeFailure(f"bias_lrelu_gain took an input that is {label}")
    print("[11 ops] bias_lrelu_gain raises on an NCHW-contiguous input, float16 and a "
          "wrong bias")
    return max_err


def check_bias_act_rule(kernels, gen):
    """Phase 11b: the first and second derivatives of bias_lrelu_gain's
    autograd rule (kernel forward, torch-ops backward) against autograd of
    its plain version, for L = sum(w·y²), then sum(v·dL/dx) + sum(u·dL/db)."""
    shape = (BATCH, 32, 32, 128)
    x = nhwc(shape, torch.float32, gen).requires_grad_(True)
    b = torch.randn((128,), generator=gen, device=DEVICE).requires_grad_(True)
    w, v = nhwc(shape, torch.float32, gen), nhwc(shape, torch.float32, gen)
    u = torch.randn((128,), generator=gen, device=DEVICE)
    derivs = []
    for fn in (kernels.bias_lrelu_gain, kernels.bias_lrelu_gain_plain):
        g1x, g1b = torch.autograd.grad((fn(x, b).square() * w).sum(), (x, b),
                                       create_graph=True)
        check(g1x.requires_grad and g1b.requires_grad,
              "the first derivative is not differentiable")
        g2x, g2b = torch.autograd.grad((g1x * v).sum() + (g1b * u).sum(), (x, b))
        derivs.append((g1x.detach(), g1b.detach(), g2x, g2b))
    report = []
    for name, k, p in zip(("dx", "db", "d2x", "d2b"), *derivs):
        scale, err = float(p.abs().max()), float((k - p).abs().max())
        # The sums over the 16·32·32 positions run in another order.
        check(err <= 1e-5 * scale, f"bias_lrelu_gain {name}: |diff| {err:.3g} of {scale:.3g}")
        report.append(f"{name} {err:.3g} (largest {scale:.3g})")
    print(f"[11 ops] bias_lrelu_gain derivatives at {list(shape)} f32, rule vs autograd "
          f"of plain, max |diff|: {', '.join(report)}; bound 1e-5 of the largest entry")


def check_ops_on_card(ops):
    """Phase 11d: a small case of every ops-layer function on the card
    against the same call on the CPU (numpy-seeded inputs, f32, TF32 off),
    grid_sample's second derivatives included. Tolerance rtol 1e-5, atol
    1e-5: CUDA's and the CPU's math libraries and sum orders differ."""
    rng = np.random.default_rng(5)

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    x = arr(2, 8, 9, 6).permute(0, 3, 1, 2)               # NHWC bytes, NCHW view
    b, w3, w_down = arr(6), arr(3, 3, 6, 4), arr(2, 2, 6, 4)
    grid = torch.from_numpy(rng.uniform(-1.2, 1.2, (2, 5, 4, 2)).astype(np.float32))
    f4 = {d: ops.setup_filter([1, 3, 3, 1], device=d) for d in ("cpu", DEVICE)}
    f8 = {d: ops.setup_filter(list(range(1, 9)), device=d) for d in ("cpu", DEVICE)}
    cases = [(f"bias_act {act}{' clamp' if clamp else ''}",
              lambda d, act=act, clamp=clamp: ops.bias_act(
                  x.to(d), b.to(d), act=act, clamp=clamp))
             for act in ACTIVATIONS for clamp in (None, 1.5)]
    cases += [
        ("fma", lambda d: ops.basic.fma(x.to(d), x.to(d), b.to(d).view(1, -1, 1, 1))),
        ("setup_filter", lambda d: f8[d]),
        ("upfirdn2d up 2", lambda d: ops.upfirdn2d(x.to(d), f4[d], up=2, padding=(2, 1, 2, 1))),
        ("upfirdn2d down 2, crop", lambda d: ops.upfirdn2d(x.to(d), f8[d], down=2,
                                                           padding=(3, 2, -1, 4))),
        ("filter2d", lambda d: ops.filter2d(x.to(d), f4[d], flip_filter=True)),
        ("upsample2d", lambda d: ops.upsample2d(x.to(d), f4[d])),
        ("downsample2d", lambda d: ops.downsample2d(x.to(d), f4[d])),
        ("bilinear_align_corners", lambda d: ops.resample.bilinear_align_corners(
            x.to(d), 13, 1)),
        ("filtered_lrelu", lambda d: ops.filtered_lrelu(
            x.to(d), f4[d], f4[d], b.to(d), up=2, down=2, padding=3)),
        ("filtered_lrelu clamp", lambda d: ops.filtered_lrelu(
            x.to(d), f4[d], None, b.to(d), up=2, padding=1, clamp=0.5)),
        ("conv2d_resample", lambda d: ops.conv2d_resample(x.to(d), w3.to(d), padding=1,
                                                          flip_weight=False)),
        ("conv2d_resample up 2", lambda d: ops.conv2d_resample(
            x.to(d), w3.to(d), f4[d], up=2, padding=1)),
        ("conv2d_resample down 2", lambda d: ops.conv2d_resample(
            x.to(d), w3.to(d), f4[d], down=2, padding=1)),
        ("conv2d_resample strided", lambda d: ops.conv2d_resample(
            x.to(d), w_down.to(d), down=2)),
        ("grid_sample", lambda d: ops.grid_sample(x.to(d), grid.to(d))),
    ]
    worst = 0.0
    with torch.no_grad():
        for name, fn in cases:
            want, got = fn("cpu"), fn(DEVICE).cpu()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                       msg=lambda m, name=name: f"{name}: {m}")
            worst = max(worst, float((got - want).abs().max()))

    # grid_sample to second order: d/dgrid of sum(y²), then the gradient of
    # the sum of its squares with respect to the image and the grid.
    second = {}
    for d in ("cpu", DEVICE):
        xd = x.to(d).requires_grad_(True)
        gd = grid.to(d).requires_grad_(True)
        (d_grid,) = torch.autograd.grad(ops.grid_sample(xd, gd).square().sum(), gd,
                                        create_graph=True)
        second[d] = [t.cpu() for t in torch.autograd.grad(d_grid.square().sum(), (xd, gd))]
    report = []
    for name, got, want in zip(("image", "grid"), second[DEVICE], second["cpu"]):
        scale, err = float(want.abs().max()), float((got - want).abs().max())
        check(err <= 1e-4 * scale, f"grid_sample second derivative ({name}): |diff| "
              f"{err:.3g} of {scale:.3g}")
        report.append(f"{name} {err:.3g} (largest {scale:.3g})")
    print(f"[11 ops] {len(cases)} ops-layer calls on the card match the CPU; max |diff| "
          f"{worst:.3g} (rtol 1e-5, atol 1e-5); grid_sample second derivatives, card vs "
          f"CPU: {', '.join(report)}; bound 1e-4 of the largest entry")


def run_ops_path(kernels, ops, gen):
    """Phase 11c: the ops path through its entry points, with every launch
    count set to 0 just before and read just after: bias_act's leaky ReLU at
    the top block's shape in bf16 with an f32 bias, bias_act swish (no
    kernel), and filtered_lrelu at the two top blocks' shapes in f32 (up 2,
    down 2, [1,3,3,1] filters, padding 3, a bias). Then the same calls with
    the plain version (not counted). Returns the launches."""
    f = ops.setup_filter([1, 3, 3, 1], device=DEVICE)
    x_act = nhwc(OPS_SHAPES[-1], torch.bfloat16, gen)
    b_act = torch.randn((OPS_SHAPES[-1][-1],), generator=gen, device=DEVICE)
    inputs = [(nhwc(s, torch.float32, gen), torch.randn((s[-1],), generator=gen,
                                                         device=DEVICE)) for s in OPS_SHAPES]

    def drive():
        return ([ops.bias_act(x_act, b_act, act="lrelu"),
                 ops.bias_act(x_act, b_act, act="swish")]
                + [ops.filtered_lrelu(x, f, f, b, up=2, down=2, padding=3) for x, b in inputs])
    with torch.no_grad():
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        outs = drive()
        torch.cuda.synchronize()
        drive_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
        want = dict.fromkeys(launches, 0)
        want["bias_lrelu_gain"] = 1 + len(OPS_SHAPES)
        check(launches == want, f"ops path launches {launches}, expected {want}")
        with plain_bias_act(kernels):
            plain_outs = drive()
    for i, (out, plain) in enumerate(zip(outs, plain_outs)):
        check(out.shape == (x_act if i < 2 else inputs[i - 2][0]).shape, f"out {i} shape")
        check(bool(torch.isfinite(out).all()), f"out {i} is not finite")
        check(out.is_contiguous(memory_format=torch.channels_last), f"out {i} layout")
        torch.testing.assert_close(out, plain, **TOL[out.dtype],
                                   msg=lambda m, i=i: f"ops path out {i}: {m}")
    errs = [float((o.float() - p.float()).abs().max()) for o, p in zip(outs, plain_outs)]
    print(f"[11 ops] ops path in {drive_s:.2f} s: bias_act lrelu and swish at "
          f"{list(OPS_SHAPES[-1])} bf16, filtered_lrelu (up 2, down 2, padding 3, "
          f"[1,3,3,1]) at {[list(s) for s in OPS_SHAPES]} f32: launches {launches}; "
          f"kernel path vs plain path max |diff| {[round(e, 9) for e in errs]}")
    return launches


def time_ops(kernels, ops, gen, card):
    """Phase 11e: the kernel against its plain version at the top block's
    shape, f32 and bf16, and filtered_lrelu with the kernel against it with
    the plain version at both shapes, f32. Returns {(name, dtype or shape):
    (kernel ms, plain ms)}."""
    times = {}
    big = OPS_SHAPES[-1]
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            x = nhwc(big, dt, gen)
            b = torch.randn((big[-1],), generator=gen, device=DEVICE)
            kernel = lambda: kernels.bias_lrelu_gain(x, b)  # noqa: E731
            plain_ms, kernel_ms = abba_ms(lambda: kernels.bias_lrelu_gain_plain(x, b), kernel)
            kernel_dev = device_ms(kernel, kernels, "bias_lrelu_gain")
            times[("bias_lrelu_gain", dt)] = (kernel_ms, kernel_dev, plain_ms)
            gbps = 2 * x.numel() * x.element_size() / (kernel_dev * 1e-3) / 1e9
            print(f"[11 times] bias_lrelu_gain {list(big)} {str(dt)[6:]}: kernel call "
                  f"{kernel_ms:.4f} ms, device {kernel_dev:.4f} ms ({gbps:.0f} GB/s of one "
                  f"read + one write); plain call {plain_ms:.4f} ms ({card})")
        f = ops.setup_filter([1, 3, 3, 1], device=DEVICE)
        for shape in OPS_SHAPES:
            x = nhwc(shape, torch.float32, gen)
            b = torch.randn((shape[-1],), generator=gen, device=DEVICE)

            def run():
                return ops.filtered_lrelu(x, f, f, b, up=2, down=2, padding=3)

            def plain():
                with plain_bias_act(kernels):
                    return run()
            plain_ms, kernel_ms = abba_ms(plain, run, iters=10)
            times[("filtered_lrelu", shape)] = (kernel_ms, plain_ms)
            print(f"[11 times] filtered_lrelu {list(shape)} f32 (up 2, down 2, padding 3): "
                  f"with the kernel {kernel_ms:.3f} ms, with the plain version "
                  f"{plain_ms:.3f} ms ({card})")
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from pggan_tpu_torch import demo
    from pggan_tpu_torch.config import Config
    from pggan_tpu_torch.ops import _build, kernels

    # f32 means f32 here: cuDNN would otherwise run f32 convolutions in TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 card] nvidia-smi: {card}")
    print(f"[1 card] torch: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, cuDNN {torch.backends.cudnn.version()}; "
          f"TF32 off for f32 convolutions and matmuls")

    t0 = time.perf_counter()
    _build.load_library()
    libs = [os.path.relpath(so, REPO) for so in _build.library_paths().values()]
    print(f"[2 build] {', '.join(libs)} ready in {time.perf_counter() - t0:.2f} s "
          f"(one nvcc per source, started together)")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[2 build]   {line.strip()}")

    cfg = Config.from_yaml(os.path.join(REPO, "configs.yaml"))
    depths = [int(d) for d in cfg.depths]
    check(int(cfg.latent_dim) == 512 and depths == [512, 512, 512, 512, 256, 128, 64],
          f"configs.yaml is not the full-width model: {cfg.latent_dim}, {depths}")
    path_shapes = epilogue_shapes(depths, SCALE, BATCH)
    shapes = [(BATCH, 512)] + sorted(set(path_shapes)) + BRANCH_SHAPES
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    max_err = check_kernels(kernels, shapes, gen)
    for name, errs in max_err.items():
        print(f"[3 kernels] {name}: {len(shapes) + len(MISALIGNED)} inputs match the plain "
              f"version; "
              f"max |diff| f32 {errs[torch.float32]:.3g} (rtol 1e-5, atol 1e-6), "
              f"bf16 {errs[torch.bfloat16]:.3g} (rtol 1.6e-2, atol 1e-2)")

    with tempfile.TemporaryDirectory(prefix="pggan_smoke_") as tmp:
        run_demo(demo, kernels, cfg, depths, tmp)
        generator, _, _, alpha = demo.load_generator(tmp, "smoke", device=DEVICE)
    z = torch.randn((BATCH, int(cfg.latent_dim)), generator=gen, device=DEVICE)
    check_forward(kernels, generator, z, alpha)

    print(f"[6 times] card: {card}; call time: CUDA events, mean over 20 eager calls "
          f"({SMALL_ITERS} for inputs of at most {SMALL_NUMEL} elements, 10 for a whole "
          f"forward) after 3 warm-up, in (plain, kernel, kernel, plain) turns; device "
          f"time: 20 calls captured in a CUDA graph, 5 replays")
    with torch.no_grad():
        time_sampling(kernels, generator, z, alpha, card)
        times, rms = time_kernels(kernels, path_shapes, gen, card)
        time_launch_path(kernels, gen, card)
        time_block_heads(generator, depths, gen, card)

    # ---- the training slice ----
    from pggan_tpu_torch import train as train_mod
    from pggan_tpu_torch.ops import equalized
    from pggan_tpu_torch.train import step as step_mod
    from pggan_tpu_torch.utils import checkpoint as ckpt_lib

    max_err.update(check_train_kernels(kernels, path_shapes, gen))
    with tempfile.TemporaryDirectory(prefix="pggan_smoke_train_") as tmp:
        train_launches, args, arrays_g, arrays_d = run_train(
            train_mod, kernels, ckpt_lib, cfg, depths, tmp)
    step_cfg = Config(args)
    step_cfg["compute_dtype"] = "float32"
    compare_step(step_mod, kernels, equalized, step_cfg, arrays_g, arrays_d, gen)
    print(f"[10 times] card: {card}")
    time_train(step_mod, kernels, step_cfg, arrays_g, arrays_d, gen, card)
    train_times = time_train_kernels(kernels, gen, card)

    # ---- the StyleGAN2-ops path ----
    from pggan_tpu_torch import ops

    max_err["bias_lrelu_gain"] = check_bias_act_kernel(kernels, path_shapes, gen)
    check_bias_act_rule(kernels, gen)
    ops_launches = run_ops_path(kernels, ops, gen)
    check_ops_on_card(ops)
    print(f"[11 times] card: {card}")
    ops_times = time_ops(kernels, ops, gen, card)

    # Every kernel of the three paths at its largest f32 shape on them;
    # `launches` is the training run's count (the demo's is checked in
    # phase 4), and bias_lrelu_gain's the ops path's (phase 11). `ms` is the
    # call time, `device_ms` the device time in a CUDA graph. Bounds: each
    # input read once and each output written once at 3.35 TB/s, against a
    # few f32 operations per element at 67 TFLOP/s.
    rows, big = (BATCH, 4, 4, 512), (BATCH, 256, 256, 64)
    n_rows, n_big = int(np.prod(rows)), int(np.prod(big))
    entries = [
        ("pixel_norm", "norm_kernels.cu", ":57", rows,
         times[("pixel_norm", rows, torch.float32)], 2 * n_rows * 4, 3 * n_rows,
         rms[(rows, torch.float32)][0]),
        ("lrelu_pixel_norm", "norm_kernels.cu", ":179", big,
         times[("lrelu_pixel_norm", big, torch.float32)], 2 * n_big * 4, 4 * n_big, None),
        ("lrelu_pixel_norm_bwd", "norm_kernels.cu", ":186", big,
         train_times[("lrelu_pixel_norm_bwd", torch.float32)], 3 * n_big * 4,
         12 * n_big, None),
        ("minibatch_stddev_stat", "mb_stddev.cu", ":252", rows,
         train_times[("minibatch_stddev_stat", torch.float32)],
         n_rows * 4 + BATCH // 4 * 4, 6 * n_rows, None),
        ("bias_lrelu_gain", "bias_act.cu", ":97", big,
         ops_times[("bias_lrelu_gain", torch.float32)], 2 * n_big * 4 + big[-1] * 4,
         4 * n_big, None),
    ]
    path_launches = dict(train_launches, bias_lrelu_gain=ops_launches["bias_lrelu_gain"])
    report = []
    for (name, source, line, shape, (kernel_ms, kernel_dev, plain_ms), nbytes, flops,
         lib_ms) in entries:
        b_ms, b_by = bound_ms(nbytes, flops)
        report.append({"name": name, "route": "cuda",
                       "source": f"pggan_tpu_torch/csrc/{source}",
                       "replaces": f"pggan_tpu/ops/pallas_kernels.py{line}",
                       "launches": path_launches[name],
                       "max_abs_err": max_err[name][torch.float32],
                       "ms": kernel_ms, "device_ms": kernel_dev,
                       "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "library_ms": lib_ms,
                       "shape": list(shape), "dtype": "float32"})
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
