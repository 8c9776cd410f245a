"""Data-parallel training across processes — the counterpart of
`pggan_tpu/parallel/mesh.py`.

The JAX package runs one SPMD program over a `data` mesh: the batch is
sharded, parameters and Adam state are replicated, and XLA all-reduces the
gradients, so an N-device step is the step at the global batch. The
reference's own multi-GPU training never synchronised its gradients (its
DDP wrap is unwrapped at once, `lib/model.py:78-79`); the port follows the
JAX package. Here it is one process per card (`torch.distributed`: NCCL on
cards, gloo on the CPU), joined from torchrun's environment (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), every rank
holding the same parameters and Adam state, and the train step averaging
its gradients with `all_reduce_mean_` between `backward` and the optimizer
step (`train/step.py`). `DistributedDataParallel` is not used: the R1
penalty differentiates D with `autograd.grad(create_graph=True)`, which it
does not support, and the lazy-R1 windows change the graph from step to
step.

Host-side agreement (the stop flag, barriers) runs over a gloo group, so it
never waits on the card's stream. Without a process group every function
here acts as the single process it is: rank 0 of 1, and the collectives
return at once.
"""

from __future__ import annotations

import os
from typing import Iterable, List

import torch
import torch.distributed as dist

_TORCHRUN_KEYS = ("RANK", "WORLD_SIZE")
# the gloo group of host-side agreement (None: the default group is gloo)
_host_group = None


def torchrun_env() -> bool:
    """Whether this process was started as one rank of a group (torchrun or
    `torch.multiprocessing.spawn` with the same variables set)."""
    return all(key in os.environ for key in _TORCHRUN_KEYS)


def init_distributed(cfg, device) -> torch.device:
    """Join the process group torchrun's environment describes and return
    this rank's device: NCCL and `cuda:LOCAL_RANK` (made current) on a card,
    gloo on the CPU. There is no fallback from NCCL to gloo on a card. A
    group the caller already initialised is used as it is, provided its
    backend is the one the device needs."""
    global _host_group
    if not cfg.use_mGPU:
        raise ValueError("joining a process group needs use_mGPU (--use_mGPU)")
    device = torch.device(device)
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("use_mGPU on a card needs NCCL, which this torch lacks "
                               "(no gloo fallback on a card)")
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local_rank)
        device, backend = torch.device("cuda", local_rank), "nccl"
    else:
        backend = "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, but a "
                               f"{device.type} rank needs {backend}")
    else:
        if not torchrun_env():
            raise RuntimeError("no process group and no torchrun environment "
                               f"({', '.join(_TORCHRUN_KEYS)}) to join one from")
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    _host_group = dist.new_group(backend="gloo") if backend == "nccl" else None
    return device


def shutdown() -> None:
    """Leave the process group (and its host group)."""
    global _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_master() -> bool:
    return rank() == 0


def global_batch_size(cfg, world_size: int = 1, scale_index: int = 0) -> int:
    """batch_per_gpu × world (`configs.yaml:35`: 16 a card), or the
    `batch_schedule` entry of the scale, which is the global batch
    (`mesh.py:82-93`)."""
    if cfg.batch_schedule:
        sched = {int(k): int(v) for k, v in dict(cfg.batch_schedule).items()}
        if scale_index in sched:
            return sched[scale_index]
    return int(cfg.batch_per_gpu) * int(world_size)


def local_batch_size(cfg, world_size: int = 1, scale_index: int = 0) -> int:
    """This rank's share of the global batch; raises unless it divides."""
    batch = global_batch_size(cfg, world_size, scale_index)
    if batch % int(world_size):
        raise ValueError(f"the global batch {batch} of scale {scale_index} does not divide "
                         f"over {world_size} ranks")
    return batch // int(world_size)


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"one bucket takes one dtype, got {sorted(map(str, dtypes))}")
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_(tensors: List[torch.Tensor], flat: torch.Tensor) -> None:
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [p.view(t.shape) for t, p in zip(tensors, parts)])


def all_reduce_mean_(tensors: Iterable[torch.Tensor]) -> None:
    """Average the tensors over the ranks, in place: one flat bucket, one
    all-reduce (a sum), one division by the world size."""
    tensors = list(tensors)
    if not dist.is_initialized() or not tensors:
        return
    flat = _flat(tensors)
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
    _unflat_(tensors, flat)


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite the tensors with rank `src`'s, in place (one bucket)."""
    tensors = list(tensors)
    if not dist.is_initialized() or not tensors:
        return
    flat = _flat(tensors)
    dist.broadcast(flat, src)
    _unflat_(tensors, flat)


def barrier() -> None:
    """Wait for every rank (over the host group)."""
    if dist.is_initialized():
        dist.barrier(group=_host_group)


def any_rank(flag: bool) -> bool:
    """Whether `flag` holds on any rank: an all-reduce MAX over the host
    group, so every rank takes the same branch after it."""
    if not dist.is_initialized():
        return bool(flag)
    value = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(value, op=dist.ReduceOp.MAX, group=_host_group)
    return bool(value.item())
