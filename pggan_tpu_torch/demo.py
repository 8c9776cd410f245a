"""Sample images from a trained generator — the counterpart of `demo.py`.

Rebuilds G at the checkpoint's scale, loads a checkpoint in the JAX
package's npz format with a strict key-set check, draws latents, runs the
forward pass, denormalises ×0.5+0.5 → [0, 255] and writes result_{i}.jpg.

    python -m pggan_tpu_torch.demo --ckpt_id my_run [--ckpt_step 30000]
        [--n_samples 16] [--batch_size 16] [--seed 0] [--output_dir DIR]
        [--ema] [--device cuda]

Latents come from a `torch.Generator` seeded with --seed, so the same seed
gives other images than the JAX demo, whose latents come from jax.random.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import torch

from pggan_tpu_torch.config import Config
from pggan_tpu_torch.models.generator import Generator, load_params_from_jax
from pggan_tpu_torch.utils import checkpoint as ckpt_lib
from pggan_tpu_torch.utils.image import denorm_to_uint8, write_jpeg


def load_generator(save_root: str, ckpt_id: str, ckpt_step: Optional[int] = None,
                   *, ema: bool = False, device="cuda"
                   ) -> Tuple[Generator, Config, int, float]:
    """Rebuild G at the checkpointed scale from the checkpoint's own config
    and load its weights strictly (`demo.py:23-50`). `ema=True` loads the
    smoothed weights (`Gema`). Returns (G in eval mode, args, scale, alpha)."""
    name = "Gema" if ema else "G"
    result = ckpt_lib.load_checkpoint(save_root, ckpt_id, name, ckpt_step)
    if result is None:
        raise FileNotFoundError(
            f"no {name} checkpoint for ckpt_id={ckpt_id!r} step={ckpt_step!r} "
            f"under {save_root!r}")
    arrays, _opt, meta = result
    args = Config(meta.get("args", {}))
    scale = int(meta["schedule"]["scale_index"])
    alpha = float(meta["schedule"]["alpha"])
    generator = Generator(
        latent_dim=int(args.latent_dim), depths=args.depths, scale=scale,
        output_dim=int(args.output_dim), equalized_lr=bool(args.equalized_lr),
        init_bias_to_zero=bool(args.init_bias_to_zero),
        slope=float(args.LReLU_slope), apply_pixel_norm=bool(args.apply_pixel_norm),
        last_activation=args.generator_last_activation,
        fused_scale=args.fused_scale, seed=int(args.seed))
    load_params_from_jax(generator, arrays)
    return generator.to(device).eval(), args, scale, alpha


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="pggan_tpu_torch sampler")
    parser.add_argument("--ckpt_id", required=True)
    parser.add_argument("--ckpt_step", type=int, default=None)
    parser.add_argument("--save_root", default="train_result")
    parser.add_argument("--n_samples", type=int, default=16)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--export", default=None, metavar="PATH",
                        help="not ported yet (see ROADMAP.md, queue 1)")
    parser.add_argument("--ema", action="store_true",
                        help="sample from the smoothed generator (Gema checkpoint)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to sample on (default: cuda)")
    ns = parser.parse_args(argv)
    if ns.export:
        raise NotImplementedError(
            "--export (a serving artifact) is not ported to pggan_tpu_torch "
            "yet; it is queued in ROADMAP.md as a torch.export artifact")

    device = torch.device(ns.device)
    generator, args, scale, alpha = load_generator(
        ns.save_root, ns.ckpt_id, ns.ckpt_step, ema=ns.ema, device=device)
    out_dir = ns.output_dir or os.path.join(ns.save_root, ns.ckpt_id, "samples")
    os.makedirs(out_dir, exist_ok=True)

    rng = torch.Generator(device=device).manual_seed(ns.seed)
    written = 0
    with torch.no_grad():
        while written < ns.n_samples:
            n = min(ns.batch_size, ns.n_samples - written)
            z = torch.randn((n, int(args.latent_dim)), generator=rng, device=device)
            images = generator(z, alpha)
            if not bool(torch.isfinite(images).all()):
                raise FloatingPointError(
                    f"non-finite pixels in samples {written}..{written + n - 1}")
            pixels = denorm_to_uint8(images).cpu().numpy()
            for i in range(n):
                write_jpeg(os.path.join(out_dir, f"result_{written + i}.jpg"),
                           pixels[i])
            written += n
    print(f"wrote {written} samples at {generator.resolution}x"
          f"{generator.resolution} (scale {scale}, alpha {alpha}) to {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
