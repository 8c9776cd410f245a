"""Offline generative metrics of a saved checkpoint — the counterpart of
the repo's `tools/eval_metrics.py`:

    python -m pggan_tpu_torch.eval_metrics --ckpt_id RUN [--ckpt_step N]
        [--config YAML] [--save_root train_result] [--num_samples N]
        [--fid_extractor random_conv|inception] [--fid_weights NPZ]
        [--device cuda]

Reads the run's config snapshot (`<save_root>/<ckpt_id>/config_<ckpt_id>.yaml`
unless `--config` names another), restores the checkpoint (a step, or the
`latest` one) through the path `python -m pggan_tpu_torch.train --ckpt_id`
resumes from (`registry.create_model`: schedule, weights, weight average),
and runs the trainer's `compute_generative_metrics`: one extractor pass over
samples of the weight average (else G) and held-out reals at the
checkpoint's scale. Prints one JSON line with the JAX tool's keys. Runs on
the card (`--device cuda`, the default) and exits non-zero when there is
none; `--device cpu` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from pggan_tpu_torch.config import Config
from pggan_tpu_torch.registry import create_model


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="offline FID/KID for a saved checkpoint")
    p.add_argument("--ckpt_id", required=True, help="run id under save_root")
    p.add_argument("--ckpt_step", type=int, default=None,
                   help="checkpoint step (default: the `latest` one)")
    p.add_argument("--config", default=None,
                   help="config yaml (default: the run's snapshot, "
                        "<save_root>/<ckpt_id>/config_<ckpt_id>.yaml)")
    p.add_argument("--save_root", default="train_result")
    p.add_argument("--num_samples", type=int, default=None,
                   help="fake-sample count (default: the config's fid_samples)")
    p.add_argument("--fid_extractor", default=None, choices=["random_conv", "inception"],
                   help="override the run's extractor")
    p.add_argument("--fid_weights", default=None,
                   help="an npz of InceptionV3 weights (metrics/inception.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    ns = parse_args(argv)
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("pggan_tpu_torch.eval_metrics: no CUDA card (torch.cuda.is_available() is "
              "False); pass --device cpu to evaluate on the CPU", file=sys.stderr)
        return 1
    cfg_path = ns.config or os.path.join(ns.save_root, ns.ckpt_id,
                                         f"config_{ns.ckpt_id}.yaml")
    if not os.path.exists(cfg_path):
        print(f"config not found: {cfg_path}", file=sys.stderr)
        return 2
    cfg = Config.from_yaml(cfg_path)
    cfg.save_root = ns.save_root
    cfg.run_id = ns.ckpt_id
    cfg.ckpt_id = ns.ckpt_id
    cfg.ckpt_step = ns.ckpt_step
    cfg.use_wandb = False
    if ns.fid_extractor:
        cfg.fid_extractor = ns.fid_extractor
    if ns.fid_weights:
        cfg.fid_weights = ns.fid_weights

    trainer = create_model(cfg, device=device)
    try:
        metrics = trainer.compute_generative_metrics(ns.num_samples)
        record = {
            "ckpt_id": ns.ckpt_id,
            "step": int(trainer.global_step),
            "scale": int(trainer.schedule.scale_index),
            "resolution": int(trainer.schedule.resolution),
            "alpha": float(trainer.schedule.alpha),
            "extractor": str(cfg.fid_extractor),
            "num_samples": int(ns.num_samples or cfg.fid_samples),
            "ema": trainer.state.G_ema is not None,
        }
        record.update({k: float(v) for k, v in metrics.items()})
        print(json.dumps(record))
    finally:
        trainer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
