"""Rank bodies for tests/test_torch_parallel.py, run in processes that
`pggan_tpu_torch.parallel.dryrun.run_ranks` spawns (a gloo group, torchrun's
variables set). Imports nothing of JAX: the test process hands the JAX
reference over in npz files.
"""

import contextlib
import json
import os
import signal
import traceback

import numpy as np
import torch


def step_rank(rank, world, inputs_path, out_dir):
    """One data-parallel r1 step from the JAX state in `inputs_path` on this
    rank's rows of JAX's batch and latents; writes the state after it, the
    metrics averaged over the ranks and the pooled moments of this rank's
    rows of `stats_values` to `out_dir/rank{rank}.npz`."""
    from pggan_tpu_torch.config import Config
    from pggan_tpu_torch.models import discriminator, generator
    from pggan_tpu_torch.ops.equalized import adam_state_to_jax, params_to_jax
    from pggan_tpu_torch.parallel import mesh
    from pggan_tpu_torch.train import step as port_step
    from pggan_tpu_torch.utils import stats

    with np.load(inputs_path) as data:
        arrays = {k: data[k] for k in data.files}
    cfg = Config(json.loads(str(arrays.pop("cfg"))))
    G = generator.params_from_jax({k[2:]: v for k, v in arrays.items() if k.startswith("G/")})
    D = discriminator.params_from_jax({k[2:]: v for k, v in arrays.items()
                                       if k.startswith("D/")})
    state = port_step.init_train_state(cfg, G, D, torch.Generator())
    rows = slice(rank * len(arrays["img"]) // world, (rank + 1) * len(arrays["img"]) // world)
    step = port_step.make_train_step(cfg, int(arrays["scale"]), grad_sync=mesh.all_reduce_mean_,
                                     rank=rank, world_size=world)
    metrics, _ = step(state, torch.from_numpy(arrays["img"][rows]), float(arrays["alpha"]),
                      **{k: torch.from_numpy(arrays[k][rows]) for k in ("z1", "z2", "eps")})
    keys = sorted(metrics)
    values = torch.stack([metrics[k] for k in keys])
    mesh.all_reduce_mean_([values])
    out = {f"metric/{k}": v.numpy() for k, v in zip(keys, values)}
    for name, net, opt in (("G", G, state.opt_G), ("D", D, state.opt_D)):
        out.update({f"{name}/params/{k}": v for k, v in params_to_jax(net).items()})
        out.update({f"{name}/opt/{k}": v for k, v in adam_state_to_jax(opt, net).items()})
    values = torch.from_numpy(arrays["stats_values"])
    share = values[rank * len(values) // world:(rank + 1) * len(values) // world]
    out["moments"] = stats.all_reduce_moments(share).numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def main_rank(rank, world, argv, log_dir, sigterm_rank=None, sigterm_step=None):
    """`pggan_tpu_torch.train.main(argv)` on this rank, its output in
    `log_dir/rank{rank}.log`. A rank other than 0 refuses every file write
    of the run (the checkpoints, the grid, metrics.jsonl, the config
    snapshot). Rank `sigterm_rank` sends itself SIGTERM during step
    `sigterm_step`. Each rank logs the step its trainer stopped at."""
    from pggan_tpu_torch import train as port_train
    from pggan_tpu_torch.config import Config
    from pggan_tpu_torch.train import trainer as trainer_mod
    from pggan_tpu_torch.utils import logging as log_mod

    Trainer = trainer_mod.ProgressiveGANTrainer
    step_once, close = Trainer.train_step, Trainer.close

    def train_step(self):
        images = step_once(self)
        if rank == sigterm_rank and self.global_step == sigterm_step:
            os.kill(os.getpid(), signal.SIGTERM)
        return images

    def closing(self):
        print(f"rank {rank} stopped at step {self.global_step}")
        close(self)

    def refused(*args, **kwargs):
        raise AssertionError(f"rank {rank} wrote a file of the run")

    Trainer.train_step, Trainer.close = train_step, closing
    if rank:
        trainer_mod.ckpt_lib.save_checkpoint = refused
        trainer_mod.save_image_grid = refused
        log_mod.MetricLogger.__init__ = refused
        Config.save_yaml = refused
    with open(os.path.join(log_dir, f"rank{rank}.log"), "w") as log, \
            contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        try:
            rc = port_train.main(list(argv))
        except Exception:
            traceback.print_exc()
            raise
    if rc:
        raise SystemExit(rc)


def replication_rank(rank, world, out_dir, changed):
    """`utils/debug.py:check_replication_consistency` on a small G built from
    one seed on every rank; with `changed`, rank 1 first moves the last bit
    of one weight (`changed` names it). Writes 'ok' or the error to
    `out_dir/rank{rank}.txt`."""
    from pggan_tpu_torch.models.generator import Generator
    from pggan_tpu_torch.utils.debug import check_replication_consistency

    G = Generator(latent_dim=16, depths=[16, 8], scale=1, seed=7)
    if changed and rank == 1:
        with torch.no_grad():
            weight = dict(G.named_parameters())[changed].view(-1)
            weight[3] = torch.nextafter(weight[3], torch.tensor(float("inf")))
    try:
        check_replication_consistency({"G": G, "G_ema": None})
        result = "ok"
    except AssertionError as exc:
        result = str(exc)
    with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
        f.write(result)
