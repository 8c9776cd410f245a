"""Training — the counterpart of `pggan_tpu/train/` and the repo's
`train.py`. `main` is the entry point (`train/__main__.py` runs it):

    python -m pggan_tpu_torch.train RUN_ID [--config configs.yaml]
        [--ckpt_id ID] [--ckpt_step N] [--max_step N] [--loss_mode r1|wgangp]
        [--data_backend auto|folder|synthetic] [--compute_dtype float32|bfloat16]
        [--steps_per_dispatch auto|N] [--use_mGPU | --no_mGPU] [--use_wandb]
        [--device cuda]

Runs on the card (`--device cuda`, the default) and exits non-zero when
there is none; `--device cpu` runs the plain PyTorch versions of the
kernels. The run directory {save_root}/{run_id}/ gets the config snapshot
`config_{run_id}.yaml`, `metrics.jsonl`, the sample grids `imgs/e{step}.jpg`
and the checkpoints `ckpt/` in the JAX package's format; `--ckpt_id`
resumes from one written by either package. SIGTERM or SIGINT checkpoints
and exits 0.

Several cards (`use_mGPU`, `--use_mGPU`; `parallel/mesh.py`): under
torchrun's environment

    torchrun --nproc_per_node N -m pggan_tpu_torch.train RUN_ID --use_mGPU

each process joins the group (NCCL, `cuda:LOCAL_RANK`; gloo with `--device
cpu`) and trains its share of the global batch. With `use_mGPU` and no such
environment, `main` spawns one rank per visible card on a free loopback
port, as the reference's train.py does. Without `use_mGPU` it is one
process and no group.

`--steps_per_dispatch N` (or the key) runs windows of N steps where no
host action falls, with `r1_interval: 1`; on a card each window replays the
step captured in a CUDA graph. 'auto' is 8 up to 128², else 1; N > 1 with
lazy R1 (`r1_interval` > 1) raises, as the JAX trainer does.

The modules: `step.py` (the train step), `graphs.py` (its CUDA-graph
capture and replay), `trainer.py` (the loop, the windows, the schedule's
jumps, checkpoints), `schedule.py` (the progressive schedule).
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import sys

import torch
import torch.distributed as dist

from pggan_tpu_torch.config import Config
from pggan_tpu_torch.parallel import mesh
from pggan_tpu_torch.registry import create_model


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="pggan_tpu_torch trainer")
    parser.add_argument("run_id_pos", nargs="?", default=None,
                        help="run id (positional, as the reference's train.py)")
    parser.add_argument("--run_id", default=None)
    parser.add_argument("--config", default="configs.yaml")
    parser.add_argument("--ckpt_id", default=None)
    parser.add_argument("--ckpt_step", default=None, type=int)
    parser.add_argument("--use_mGPU", action="store_true", default=None,
                        help="data-parallel over every visible card (torchrun's "
                             "ranks, or one spawned rank per card)")
    parser.add_argument("--no_mGPU", dest="use_mGPU", action="store_false")
    parser.add_argument("--use_wandb", action="store_true", default=None)
    parser.add_argument("--max_step", type=int, default=None)
    parser.add_argument("--loss_mode", choices=["r1", "wgangp"], default=None)
    parser.add_argument("--data_backend", choices=["auto", "folder", "synthetic"],
                        default=None)
    parser.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                        default=None)
    parser.add_argument("--steps_per_dispatch", default=None,
                        help="steps a dispatch in event-free windows (an int, or "
                             "'auto': 8 up to 128x128, else 1); on a card each window "
                             "replays the step captured in a CUDA graph")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda)")
    return parser.parse_args(argv)


def _spawned_rank(local_rank: int, argv, world: int, port: int) -> None:
    """One rank of the spawn route: torchrun's variables, then `main`."""
    os.environ.update(RANK=str(local_rank), LOCAL_RANK=str(local_rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    rc = main(argv)
    if rc:
        raise SystemExit(rc)


def spawn_ranks(argv, device: torch.device) -> int:
    """`use_mGPU` without torchrun: one rank per visible card, spawned, on a
    free loopback port (the reference's `train.py`). SIGTERM and SIGINT are
    passed on to the ranks, which checkpoint and return."""
    if device.type != "cuda":
        print("pggan_tpu_torch.train: --use_mGPU without torchrun spawns one rank per "
              "card; on the CPU start the ranks with torchrun", file=sys.stderr)
        return 2
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    world = torch.cuda.device_count()
    print(f"[pggan_tpu_torch] spawning {world} ranks (one a card) on 127.0.0.1:{port}")
    ranks = torch.multiprocessing.spawn(_spawned_rank, args=(list(argv), world, port),
                                        nprocs=world, join=False)

    def pass_on(signum, frame):
        for proc in ranks.processes:
            if proc.is_alive():
                os.kill(proc.pid, signum)
    previous = {sig: signal.signal(sig, pass_on) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        while not ranks.join():
            pass
    finally:
        for sig, handler in previous.items():
            if handler is not None:     # None: a handler not set from Python
                signal.signal(sig, handler)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ns = parse_args(argv)
    cfg = Config.from_yaml(ns.config) if os.path.exists(ns.config) else Config()
    run_id = ns.run_id or ns.run_id_pos
    if run_id is None:
        print("usage: python -m pggan_tpu_torch.train RUN_ID [--flags]", file=sys.stderr)
        return 2
    cfg.run_id = run_id
    if ns.steps_per_dispatch is not None:
        cfg["steps_per_dispatch"] = ("auto" if ns.steps_per_dispatch == "auto"
                                     else int(ns.steps_per_dispatch))
    for key in ("ckpt_id", "ckpt_step", "use_mGPU", "use_wandb", "max_step", "loss_mode",
                "data_backend", "compute_dtype"):
        value = getattr(ns, key)
        if value is not None:
            cfg[key] = value
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("pggan_tpu_torch.train: no CUDA card (torch.cuda.is_available() is "
              "False); pass --device cpu to train on the CPU", file=sys.stderr)
        return 1
    joined = bool(cfg.use_mGPU) and not dist.is_initialized()   # a group made here
    if joined and not mesh.torchrun_env():
        return spawn_ranks(argv, device)
    if cfg.use_mGPU:
        device = mesh.init_distributed(cfg, device)
        print(f"[pggan_tpu_torch] process group: {dist.get_backend()}, world "
              f"{mesh.world_size()}, rank {mesh.rank()}, device {device}")
    try:
        if mesh.is_master():
            cfg.save_yaml()             # the config snapshot, as train.py:99
        trainer = create_model(cfg, device=device)
        try:
            trainer.fit(run_id, max_step=ns.max_step)
        finally:
            trainer.close()
    finally:
        if joined:
            mesh.shutdown()
    return 0
