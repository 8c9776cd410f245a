"""A data-parallel dry run on the CPU — the counterpart of
`__graft_entry__.dryrun_multichip`:

    python -c "from pggan_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(2)"

`dryrun_multichip(n)` spawns n processes joined into a gloo group and runs
one r1 step and one wgangp step of the data-parallel train step on tiny
shapes (scale 1, 8×8, 4 images a rank, each rank its own images), then
checks that every loss is finite and that the ranks' parameters, Adam
moments and G weight averages agree bit for bit. `run_ranks` is the
launcher: a `FileStore` rendezvous (no port), a deadline, and the other
ranks stopped as soon as one fails, so a stalled rendezvous fails instead
of hanging.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import tempfile
import time
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pggan_tpu_torch.parallel import mesh

_POLL_S, _JOIN_S = 0.05, 5.0


def _rank_main(target: Callable, rank: int, world: int, init_method: str,
               args: Sequence) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    try:
        target(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(target: Callable, world: int, args: Sequence = (), *, store: str,
              timeout: float = 120.0) -> None:
    """Run `target(rank, world, *args)` in `world` spawned processes, each a
    rank of a gloo group whose rendezvous is a `FileStore` at the path
    `store` (a file that does not exist yet), with torchrun's `RANK`,
    `LOCAL_RANK` and `WORLD_SIZE` set and one torch thread a rank (as
    torchrun's OMP_NUM_THREADS=1). `target` must be importable by name.
    Raises RuntimeError when a rank fails or `timeout` seconds pass; the
    ranks still running are then terminated."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(target, r, world, f"file://{store}", tuple(args)))
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if time.monotonic() > deadline or any(p.exitcode for p in procs):
                break
            time.sleep(_POLL_S)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
            proc.join(_JOIN_S)
            if proc.is_alive():
                proc.kill()
                proc.join(_JOIN_S)
    codes = [p.exitcode for p in procs]
    if any(code != 0 for code in codes):
        late = time.monotonic() > deadline
        raise RuntimeError(f"{world} ranks of {getattr(target, '__name__', target)}: exit "
                           f"codes {codes}" + (f" (stopped after {timeout:.0f} s)" if late else ""))


def _dryrun_rank(rank: int, world: int) -> None:
    from pggan_tpu_torch.config import Config
    from pggan_tpu_torch.models.discriminator import Discriminator
    from pggan_tpu_torch.models.generator import Generator
    from pggan_tpu_torch.train.step import init_train_state, make_train_step

    scale, batch = 1, 4                 # a grown block: the fade paths are live
    for mode in ("r1", "wgangp"):
        cfg = Config({"depths": [16, 16], "latent_dim": 32, "loss_mode": mode,
                      "g_ema_decay": 0.999})
        G = Generator(latent_dim=32, depths=cfg.depths, scale=scale)
        D = Discriminator(depths=cfg.depths, scale=scale)
        state = init_train_state(cfg, G, D, torch.Generator().manual_seed(0))
        step = make_train_step(cfg, scale, grad_sync=mesh.all_reduce_mean_, rank=rank,
                               world_size=world)
        images = np.random.RandomState(rank).randint(0, 256, (batch, 8, 8, 3), dtype=np.uint8)
        metrics, _ = step(state, torch.from_numpy(images), 0.5)
        bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
        if bad:
            raise AssertionError(f"rank {rank}, {mode}: not finite: {bad}")
        replicated = [t.detach().reshape(-1) for net in (G, D, state.G_ema)
                      for t in net.state_dict().values()]
        replicated += [v.reshape(-1) for opt in (state.opt_G, state.opt_D)
                       for s in opt.state.values() for k, v in s.items() if k != "step"]
        mine = torch.cat(replicated)
        theirs = mine.clone()
        mesh.broadcast_([theirs])
        if mesh.any_rank(not torch.equal(mine, theirs)):
            raise AssertionError(f"{mode}: the ranks' parameters or Adam state differ "
                                 f"after one step")
        if rank == 0:
            print(f"[dryrun] {world} gloo ranks, {mode} step: losses finite, parameters, "
                  f"Adam moments and G average bit for bit equal on every rank")


def dryrun_multichip(n: int, *, timeout: float = 120.0) -> None:
    """One data-parallel step (r1, then wgangp) over n gloo ranks on the
    CPU; raises unless the ranks end bit for bit equal."""
    with tempfile.TemporaryDirectory(prefix="pggan_dryrun_") as tmp:
        run_ranks(_dryrun_rank, int(n), store=os.path.join(tmp, "store"), timeout=timeout)
