"""Debug and profiling helpers — the counterpart of `pggan_tpu/utils/debug.py`
(the reference's `torch_utils/misc.py` surface):

- `assert_shape` (`misc.py:82`) and `nan_to_num` (`misc.py:25`);
- `profiled_function` (`misc.py:100-106`): `torch.profiler.record_function`
  under the function's name;
- `trace_context(logdir)`: a `torch.profiler.profile` whose trace goes to
  `logdir` (a Chrome/TensorBoard trace, `*.pt.trace.json`);
- `copy_matching_leaves` and `print_tree_summary` on state dicts (names in
  `state_dict()`'s dotted form where JAX has pytree paths);
- `check_replication_consistency` (`check_ddp_consistency`, `misc.py:
  180-194`): a bitwise checksum of each tensor, gathered over the ranks of
  the process group, which raises naming the first that differs.
"""

from __future__ import annotations

import functools
import io
from typing import Callable, Dict, Iterator, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Tree = Union[torch.nn.Module, Mapping]

# integer types of each element size, to read a tensor's bits
_BITS = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}


def assert_shape(tensor, ref_shape: Sequence[Optional[int]]) -> None:
    """Raise AssertionError unless `tensor` has `ref_shape`'s rank and
    sizes; None matches any size (`misc.py:82-97`)."""
    if tensor.ndim != len(ref_shape):
        raise AssertionError(f"Wrong number of dimensions: got {tensor.ndim}, "
                             f"expected {len(ref_shape)}")
    for idx, (size, ref_size) in enumerate(zip(tensor.shape, ref_shape)):
        if ref_size is not None and size != ref_size:
            raise AssertionError(f"Wrong size for dimension {idx}: got {size}, "
                                 f"expected {ref_size}")


def nan_to_num(x: torch.Tensor, nan: float = 0.0, posinf: Optional[float] = None,
               neginf: Optional[float] = None) -> torch.Tensor:
    """NaN → `nan`, ±inf → `posinf`/`neginf` (the dtype's largest finite
    values when None), as `jnp.nan_to_num`."""
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def profiled_function(fn: Callable) -> Callable:
    """Wrap `fn` in a profiler range of its name, so its calls show as one
    span in a `torch.profiler` trace."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(fn.__name__):
            return fn(*args, **kwargs)
    return wrapper


def trace_context(logdir: str) -> torch.profiler.profile:
    """`with trace_context(dir): ...` records the host and, on a card, the
    device, and writes the trace into `dir` when the block ends (open it in
    Perfetto or TensorBoard)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))


def _named_tensors(tree: Tree) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of a module's state dict, or of a mapping of names to
    tensors or modules (a module's tensors named `name.key`; None skipped)."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.state_dict().items()
        return
    for name, value in tree.items():
        if isinstance(value, torch.nn.Module):
            for key, tensor in value.state_dict().items():
                yield f"{name}.{key}", tensor
        elif value is not None:
            yield name, value


def copy_matching_leaves(src: Mapping, dst: Mapping, *, require_all: bool = False) -> Dict:
    """dst with every entry whose name src also holds (same shape) replaced
    by src's value in dst's dtype — the functional `copy_params_and_buffers`
    (`misc.py:153-161`). A shape mismatch raises ValueError; with
    `require_all`, a name of dst that src lacks raises KeyError."""
    out = {}
    for key, leaf in dst.items():
        if key in src:
            value = src[key]
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.asarray(value))
            if tuple(value.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch at {key}: {tuple(value.shape)} vs "
                                 f"{tuple(leaf.shape)}")
            out[key] = value.to(dtype=leaf.dtype, device=leaf.device)
        elif require_all:
            raise KeyError(f"missing source leaf for {key}")
        else:
            out[key] = leaf
    return out


def _shapes(out):
    if isinstance(out, torch.Tensor):
        return tuple(out.shape)
    if isinstance(out, (tuple, list)):
        return type(out)(_shapes(o) for o in out)
    if isinstance(out, dict):
        return {k: _shapes(v) for k, v in out.items()}
    return out


def print_tree_summary(params: Tree, apply_fn: Optional[Callable] = None, *inputs,
                       file=None) -> str:
    """The parameter table — `print_module_summary` (`misc.py:196-264`):
    one row per tensor (name, shape, count) and the total; with `apply_fn`
    and inputs, the output shape(s) of `apply_fn(*inputs)` run once without
    gradients. Printed to `file` (stdout) and returned."""
    buf = io.StringIO()
    rows = [(name, str(tuple(t.shape)), int(t.numel())) for name, t in _named_tensors(params)]
    total = sum(n for _, _, n in rows)
    width = max((len(r[0]) for r in rows), default=10)
    print(f"{'leaf':<{width}}  {'shape':<20}  params", file=buf)
    for name, shape, n in rows:
        print(f"{name:<{width}}  {shape:<20}  {n}", file=buf)
    print(f"{'TOTAL':<{width}}  {'':<20}  {total}", file=buf)
    if apply_fn is not None:
        with torch.no_grad():
            out = apply_fn(*inputs)
        print(f"output shape(s): {_shapes(out)}", file=buf)
    text = buf.getvalue()
    print(text, end="", file=file)
    return text


def _checksum(tensor: torch.Tensor) -> torch.Tensor:
    """Two int64 sums of the tensor's bits, the second weighted by position
    (so a permutation shows): equal tensors give equal sums."""
    flat = tensor.detach().contiguous().reshape(-1)
    bits = flat.view(_BITS[flat.element_size()]).to(torch.int64)
    weights = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64) % 65521 + 1
    return torch.stack([bits.sum(), (bits * weights).sum()])


def check_replication_consistency(tree: Tree) -> None:
    """Check that every rank of the process group holds the same tensors,
    bit for bit: each tensor's checksum (`_checksum`) is gathered from every
    rank and compared with rank 0's; raises AssertionError naming the first
    tensor that differs and the rank. Every rank must call it. Without a
    process group there is nothing to compare."""
    if not dist.is_initialized():
        return
    named = list(_named_tensors(tree))
    if not named:
        return
    local = torch.stack([_checksum(t) for _, t in named])
    gathered = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, local)
    for rank, sums in enumerate(gathered[1:], start=1):
        differs = (sums != gathered[0]).any(dim=1).nonzero()
        if len(differs):
            name = named[int(differs[0])][0]
            raise AssertionError(f"replication mismatch at {name}: rank 0 vs {rank}")
