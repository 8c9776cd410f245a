"""Training — the counterpart of `pggan_tpu/train/` and the repo's
`train.py`. `main` is the entry point (`train/__main__.py` runs it):

    python -m pggan_tpu_torch.train RUN_ID [--config configs.yaml]
        [--ckpt_id ID] [--ckpt_step N] [--max_step N] [--loss_mode r1|wgangp]
        [--data_backend auto|folder|synthetic] [--compute_dtype float32|bfloat16]
        [--use_wandb] [--device cuda]

Runs on the card (`--device cuda`, the default) and exits non-zero when
there is none; `--device cpu` runs the plain PyTorch versions of the
kernels. The run directory {save_root}/{run_id}/ gets the config snapshot
`config_{run_id}.yaml`, `metrics.jsonl`, the sample grids `imgs/e{step}.jpg`
and the checkpoints `ckpt/` in the JAX package's format; `--ckpt_id`
resumes from one written by either package. SIGTERM or SIGINT checkpoints
and exits 0.

The modules: `step.py` (the train step), `trainer.py` (the loop, the
schedule's jumps, checkpoints), `schedule.py` (the progressive schedule).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from pggan_tpu_torch.config import Config
from pggan_tpu_torch.registry import create_model


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="pggan_tpu_torch trainer")
    parser.add_argument("run_id_pos", nargs="?", default=None,
                        help="run id (positional, as the reference's train.py)")
    parser.add_argument("--run_id", default=None)
    parser.add_argument("--config", default="configs.yaml")
    parser.add_argument("--ckpt_id", default=None)
    parser.add_argument("--ckpt_step", default=None, type=int)
    parser.add_argument("--use_wandb", action="store_true", default=None)
    parser.add_argument("--max_step", type=int, default=None)
    parser.add_argument("--loss_mode", choices=["r1", "wgangp"], default=None)
    parser.add_argument("--data_backend", choices=["auto", "folder", "synthetic"],
                        default=None)
    parser.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                        default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    ns = parse_args(argv)
    cfg = Config.from_yaml(ns.config) if os.path.exists(ns.config) else Config()
    run_id = ns.run_id or ns.run_id_pos
    if run_id is None:
        print("usage: python -m pggan_tpu_torch.train RUN_ID [--flags]", file=sys.stderr)
        return 2
    cfg.run_id = run_id
    for key in ("ckpt_id", "ckpt_step", "use_wandb", "max_step", "loss_mode",
                "data_backend", "compute_dtype"):
        value = getattr(ns, key)
        if value is not None:
            cfg[key] = value
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("pggan_tpu_torch.train: no CUDA card (torch.cuda.is_available() is "
              "False); pass --device cpu to train on the CPU", file=sys.stderr)
        return 1
    cfg.save_yaml()                     # the config snapshot, as train.py:99
    trainer = create_model(cfg, device=device)
    try:
        trainer.fit(run_id, max_step=ns.max_step)
    finally:
        trainer.close()
    return 0
