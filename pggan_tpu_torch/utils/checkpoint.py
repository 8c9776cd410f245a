"""Checkpoint files in the JAX package's format — the counterpart of
`pggan_tpu/utils/checkpoint.py`, in numpy alone.

One `.npz` per network under `{save_root}/{run_id}/ckpt/`: `{name}_{step}.npz`
plus a `{name}_latest.npz` alias. Keys are `params/<path>` with slash-joined
pytree paths such as `format/w`, `blocks/0/conv1/b` or `torgb/2/scale`, and
`__meta__` holds a JSON blob (`args`, `schedule`, `global_step`). A
checkpoint written by either package loads in the other.

Optimizer state is written as optax's Adam state flattens: `opt/0/count`
(int32) and `opt/0/mu/<path>`, `opt/0/nu/<path>` for every parameter path,
the He-constant `scale` leaves included. torch's Adam never sees those
buffers, so their moments are written as zeros — what optax holds for them,
since their gradient is zero (`ops/equalized.py:adam_state_to_jax`).

The JAX trainer also writes the `rng` key of its latent stream into
`__meta__`; the port's trainer writes its `torch.Generator` state under
`torch_rng` instead (a generator state is no JAX key, and the JAX loader
reads only `rng`). A resume restores it on the same device type; a JAX
checkpoint's `rng` is ignored, and such a resume draws its latents from a
generator seeded by (seed, global_step).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, Iterable, Optional, Tuple

import numpy as np


def ckpt_dir(save_root: str, run_id: str) -> str:
    return os.path.join(str(save_root), str(run_id), "ckpt")


def check_key_set(expected: Iterable[str], arrays: Dict[str, np.ndarray]) -> None:
    """Strict key-set check (`pggan_tpu/utils/checkpoint.py:63-91`, the
    reference demo's assert): raise KeyError unless the checkpoint holds
    exactly the expected paths."""
    expected = set(expected)
    missing = expected - set(arrays)
    extra = set(arrays) - expected
    if missing or extra:
        raise KeyError(
            f"checkpoint/template key mismatch: missing={sorted(missing)[:5]} "
            f"extra={sorted(extra)[:5]} (strict=True)")


def _atomic_write(path: str, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(save_root: str, run_id: str, name: str, global_step: int,
                    *, params: Dict[str, np.ndarray],
                    opt: Optional[Dict[str, np.ndarray]] = None,
                    meta: Optional[Dict] = None) -> str:
    """Write {name}_{step}.npz and refresh {name}_latest.npz, each atomically.
    `opt` holds optimizer arrays keyed as optax flattens them ('0/count',
    '0/mu/<path>', ...)."""
    directory = ckpt_dir(save_root, run_id)
    os.makedirs(directory, exist_ok=True)
    payload = {f"params/{key}": np.asarray(arr) for key, arr in params.items()}
    payload.update({f"opt/{key}": np.asarray(arr) for key, arr in (opt or {}).items()})
    meta = dict(meta or {})
    meta["global_step"] = int(global_step)
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                        dtype=np.uint8)
    path = os.path.join(directory, f"{name}_{global_step}.npz")
    _atomic_write(path, lambda f: np.savez(f, **payload))

    def copy_to(f_out):
        with open(path, "rb") as f_in:
            shutil.copyfileobj(f_in, f_out)
    _atomic_write(os.path.join(directory, f"{name}_latest.npz"), copy_to)
    return path


def load_checkpoint(save_root: str, ckpt_id: str, name: str,
                    ckpt_step: Optional[int] = None
                    ) -> Optional[Tuple[Dict[str, np.ndarray],
                                        Dict[str, np.ndarray], Dict]]:
    """Returns (param_arrays, opt_arrays, meta), or None if the file is
    absent. `ckpt_step=None` reads the `latest` alias."""
    step_tag = "latest" if ckpt_step is None else str(ckpt_step)
    path = os.path.join(ckpt_dir(save_root, ckpt_id), f"{name}_{step_tag}.npz")
    if not os.path.exists(path):
        return None
    params: Dict[str, np.ndarray] = {}
    opt: Dict[str, np.ndarray] = {}
    meta: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            if key == "__meta__":
                meta = json.loads(data[key].tobytes().decode("utf-8"))
            elif key.startswith("params/"):
                params[key[len("params/"):]] = data[key]
            elif key.startswith("opt/"):
                opt[key[len("opt/"):]] = data[key]
    return params, opt, meta
