#!/usr/bin/env python3
"""Drive the PyTorch port's sampling path once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. the card (nvidia-smi name and power limit, torch's device name);
  2. build the CUDA kernels from pggan_tpu_torch/csrc with nvcc (timed);
  3. each kernel against its plain PyTorch version on the card, f32 and
     bf16, at the sampling path's shapes and at ragged ones;
  4. the slice at the full width of configs.yaml: write a scale-6 (256×256)
     G checkpoint in the JAX package's npz format (numpy-seeded weights,
     alpha 0.5), run `pggan_tpu_torch.demo` for 32 images at batch 16, check
     the JPEGs and the kernel launch counts (2 pixel_norm and 13
     lrelu_pixel_norm per forward);
  5. the full-width forward with the kernels against the same forward with
     the plain versions, and a small generator on the card against the CPU;
  6. times on the card: sampling img/s, each kernel against its plain
     version, the fused upscale+conv against conv(upscale2d(x)), peak memory.

The second-to-last lines are a JSON object describing the kernels and the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a CUDA device, and imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
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
# f32: kernel and plain differ only in the order of the channel sum and in
# rsqrtf's last bits. bf16: additionally one bf16 rounding of the output,
# which can land one bf16 ulp (2^-8 relative) apart.
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}
# Whole forward, f32 with TF32 off: kernel-level differences of ~1e-7
# relative, carried through 13 convolutions, on outputs of magnitude ~1-5.
FORWARD_ATOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, message: str) -> None:
    if not cond:
        raise SmokeFailure(message)


def nhwc(shape, dtype, gen):
    """A random [B, C, H, W] channels_last (or [B, C]) tensor from an NHWC shape."""
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
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


def abba_ms(plain, kernel, iters: int = 20):
    """Times in turns (plain, kernel, kernel, plain); mean of each pair."""
    p1, k1, k2, p2 = (time_ms(plain, iters), time_ms(kernel, iters),
                      time_ms(kernel, iters), time_ms(plain, iters))
    return (p1 + p2) / 2, (k1 + k2) / 2


@contextlib.contextmanager
def plain_epilogues(kernels):
    """Route the generator's pixel_norm / lrelu_pixel_norm to the plain
    PyTorch versions, for comparison and timing only."""
    with mock.patch.object(kernels, "pixel_norm", kernels.pixel_norm_plain), \
            mock.patch.object(kernels, "lrelu_pixel_norm",
                              kernels.lrelu_pixel_norm_plain):
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


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return smi.splitlines()[0]


def check_kernels(kernels, shapes, gen):
    """Phase 3: every kernel against its plain version, f32 and bf16.
    Returns {kernel: {dtype: max |diff|}}."""
    max_err = {name: {dt: 0.0 for dt in TOL} for name in kernels.launches}
    with torch.no_grad():
        for shape in shapes:
            for dt, tol in TOL.items():
                x = nhwc(shape, dt, gen)
                for name in kernels.launches:
                    got = getattr(kernels, name)(x)
                    want = getattr(kernels, name + "_plain")(x)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(
                        got, want, **tol, msg=lambda m: f"{name} {shape} {dt}: {m}")
                    check(got.ndim == 2 or got.is_contiguous(
                        memory_format=torch.channels_last), f"{name} {shape}: layout")
                    err = float((got.float() - want.float()).abs().max())
                    max_err[name][dt] = max(max_err[name][dt], err)
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
    want = {"pixel_norm": 2 * forwards, "lrelu_pixel_norm": 13 * forwards}
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
    """Phase 6b: each kernel against its plain version at pixel_norm's 4-D
    path shape and the three largest epilogue shapes.
    Returns {(kernel, shape, dtype): (kernel ms, plain ms)}."""
    times = {}
    timed = [("pixel_norm", (BATCH, 4, 4, 512))] + [
        (name, shape) for name in kernels.launches
        for shape in sorted(set(path_shapes), key=np.prod)[-3:]]
    for name, shape in timed:
        for dt in (torch.float32, torch.bfloat16):
            x = nhwc(shape, dt, gen)
            plain_ms, kernel_ms = abba_ms(lambda: getattr(kernels, name + "_plain")(x),
                                          lambda: getattr(kernels, name)(x))
            gbps = 2 * x.numel() * x.element_size() / (kernel_ms * 1e-3) / 1e9
            times[(name, shape, dt)] = (kernel_ms, plain_ms)
            print(f"[6 times] {name} {list(shape)} {str(dt)[6:]}: kernel "
                  f"{kernel_ms:.4f} ms ({gbps:.0f} GB/s of one read + one write), "
                  f"plain {plain_ms:.4f} ms ({card})")
    return times


def time_block_heads(generator, depths, gen, card):
    """Phase 6c: each block's conv0, the dilated form against
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
    print(f"[2 build] {os.path.relpath(_build.library_path(), REPO)} ready in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[2 build]   {line.strip()}")

    cfg = Config.from_yaml(os.path.join(REPO, "configs.yaml"))
    depths = [int(d) for d in cfg.depths]
    check(int(cfg.latent_dim) == 512 and depths == [512, 512, 512, 512, 256, 128, 64],
          f"configs.yaml is not the full-width model: {cfg.latent_dim}, {depths}")
    path_shapes = epilogue_shapes(depths, SCALE, BATCH)
    shapes = [(BATCH, 512)] + sorted(set(path_shapes)) + [
        (2, 3, 3, 16), (2, 4, 4, 513), (2, 4, 4, 96)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = check_kernels(kernels, shapes, gen)
    for name, errs in max_err.items():
        print(f"[3 kernels] {name}: {len(shapes)} shapes match the plain version; "
              f"max |diff| f32 {errs[torch.float32]:.3g} (rtol 1e-5, atol 1e-6), "
              f"bf16 {errs[torch.bfloat16]:.3g} (rtol 1.6e-2, atol 1e-2)")

    with tempfile.TemporaryDirectory(prefix="pggan_smoke_") as tmp:
        launches = run_demo(demo, kernels, cfg, depths, tmp)
        generator, _, _, alpha = demo.load_generator(tmp, "smoke", device="cuda")
    z = torch.randn((BATCH, int(cfg.latent_dim)), generator=gen, device="cuda")
    check_forward(kernels, generator, z, alpha)

    print(f"[6 times] card: {card}; CUDA events, mean over 20 calls (10 for a "
          f"whole forward) after 3 warm-up, in (plain, kernel, kernel, plain) turns")
    with torch.no_grad():
        time_sampling(kernels, generator, z, alpha, card)
        times = time_kernels(kernels, path_shapes, gen, card)
        time_block_heads(generator, depths, gen, card)

    # The kernels on the path, timed at their largest f32 shape on the path
    # (the demo samples in f32).
    main_path = {"pixel_norm": ((BATCH, 4, 4, 512), "pggan_tpu/ops/pallas_kernels.py:57"),
                 "lrelu_pixel_norm": ((BATCH, 256, 256, 64),
                                      "pggan_tpu/ops/pallas_kernels.py:179")}
    report = []
    for name, (shape, replaces) in main_path.items():
        kernel_ms, plain_ms = times[(name, shape, torch.float32)]
        report.append({"name": name, "route": "cuda",
                       "source": "pggan_tpu_torch/csrc/norm_kernels.cu",
                       "replaces": replaces, "launches": launches[name],
                       "max_abs_err": max_err[name][torch.float32],
                       "ms": kernel_ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
