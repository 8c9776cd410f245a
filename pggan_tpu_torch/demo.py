"""Sample images from a trained generator — the counterpart of `demo.py`.

Rebuilds G at the checkpoint's scale, loads a checkpoint in the JAX
package's npz format with a strict key-set check, draws latents, runs the
forward pass, denormalises ×0.5+0.5 → [0, 255] and writes result_{i}.jpg.
A checkpoint whose args name `model_id: stylegan2` is sampled through the
same loop from StyleGAN2's generator (`models/stylegan2.py`), built from the
args' StyleGAN2 keys (`config.STYLEGAN2_DEFAULTS`); one with `model_id:
stylegan3` from StyleGAN3-T's (`models/stylegan3.py`, the args' keys over
`config.STYLEGAN3_DEFAULTS`).

    python -m pggan_tpu_torch.demo --ckpt_id my_run [--ckpt_step 30000]
        [--n_samples 16] [--batch_size 16] [--seed 0] [--output_dir DIR]
        [--ema] [--export PATH] [--device cuda]

`--export PATH` also writes the loaded generator as a `torch.export`
serving artifact (f32, the checkpoint's alpha, any batch size;
`pggan_tpu_torch.export.sample` serves it), then samples as without it.

Latents come from a `torch.Generator` seeded with --seed, so the same seed
gives other images than the JAX demo, whose latents come from jax.random.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import torch

from pggan_tpu_torch.config import Config, stylegan2_args, stylegan3_args
from pggan_tpu_torch.models import stylegan2, stylegan3
from pggan_tpu_torch.models.generator import Generator, load_params_from_jax
from pggan_tpu_torch.utils import checkpoint as ckpt_lib
from pggan_tpu_torch.utils.image import denorm_to_uint8, write_jpeg


def load_generator(save_root: str, ckpt_id: str, ckpt_step: Optional[int] = None,
                   *, ema: bool = False, device="cuda"
                   ) -> Tuple[torch.nn.Module, Config, int, float]:
    """Rebuild G at the checkpointed scale from the checkpoint's own config
    and load its weights strictly (`demo.py:23-50`). `ema=True` loads the
    smoothed weights (`Gema`). Returns (G in eval mode, args, scale, alpha).

    For `model_id: stylegan2` or `stylegan3`, G is StyleGAN2's or
    StyleGAN3-T's generator, the scale that of its resolution (log2
    (resolution) − 2) and ψ = 1 (no truncation) stands in alpha's place:
    every G samples as `G(z, alpha)`."""
    name = "Gema" if ema else "G"
    result = ckpt_lib.load_checkpoint(save_root, ckpt_id, name, ckpt_step)
    if result is None:
        raise FileNotFoundError(
            f"no {name} checkpoint for ckpt_id={ckpt_id!r} step={ckpt_step!r} "
            f"under {save_root!r}")
    arrays, _opt, meta = result
    args = Config(meta.get("args", {}))
    if args.model_id == "stylegan2":
        a = stylegan2_args(args)
        generator = stylegan2.StyleGAN2Generator(
            z_dim=int(a["z_dim"]), w_dim=int(a["w_dim"]),
            mapping_layers=int(a["mapping_layers"]),
            mapping_lr_multiplier=float(a["mapping_lr_multiplier"]),
            resolution=int(a["resolution"]), fmap_base=int(a["fmap_base"]),
            fmap_max=int(a["fmap_max"]), num_fp16_res=int(a["num_fp16_res"]),
            conv_clamp=a["conv_clamp"], img_channels=int(a["output_dim"]))
        stylegan2.load_params(generator, arrays)
        scale = int(a["resolution"]).bit_length() - 3
        return generator.to(device).eval(), args, scale, 1.0
    if args.model_id == "stylegan3":
        a = stylegan3_args(args)
        img_channels = int(a.pop("output_dim"))
        generator = stylegan3.StyleGAN3Generator(**a, img_channels=img_channels)
        stylegan3.load_params(generator, arrays)
        scale = int(a["resolution"]).bit_length() - 3
        return generator.to(device).eval(), args, scale, 1.0
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
                        help="also write a torch.export serving artifact (.pt2) of the "
                             "loaded generator, batch symbolic (pggan_tpu_torch.export)")
    parser.add_argument("--ema", action="store_true",
                        help="sample from the smoothed generator (Gema checkpoint)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to sample on (default: cuda)")
    ns = parser.parse_args(argv)

    device = torch.device(ns.device)
    generator, args, scale, alpha = load_generator(
        ns.save_root, ns.ckpt_id, ns.ckpt_step, ema=ns.ema, device=device)
    out_dir = ns.output_dir or os.path.join(ns.save_root, ns.ckpt_id, "samples")
    os.makedirs(out_dir, exist_ok=True)

    if ns.export:
        if args.model_id in ("stylegan2", "stylegan3"):
            raise SystemExit("--export writes the PGGAN generator's artifact only")
        from pggan_tpu_torch.export import export_generator
        # G carries the checkpoint's slope, pixel norm and last activation
        export_generator(generator, latent_dim=int(args.latent_dim), alpha=alpha,
                         path=ns.export, device=device)
        print(f"wrote serving artifact (scale {scale}, alpha {alpha}) to {ns.export}")

    latent_dim = (generator.z_dim if args.model_id in ("stylegan2", "stylegan3")
                  else int(args.latent_dim))
    rng = torch.Generator(device=device).manual_seed(ns.seed)
    written = 0
    with torch.no_grad():
        while written < ns.n_samples:
            n = min(ns.batch_size, ns.n_samples - written)
            z = torch.randn((n, latent_dim), generator=rng, device=device)
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
