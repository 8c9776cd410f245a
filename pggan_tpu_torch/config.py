"""YAML-backed attribute-style configuration — the counterpart of
`pggan_tpu/config.py`, reduced to the keys the port reads.

`Config` is a dict with attribute access. Keys it does not know are kept as
they are, so a checkpoint's `args` (the JAX trainer's whole config) loads
unchanged; the defaults below cover the keys the port reads when a config
omits them, with the JAX package's values.

Like the JAX package's config, it remembers which keys the user set (a
config file value that differs from the default, a constructor argument or
an item or attribute write), as opposed to defaults and `update` merges. A
resumed run keeps those and takes every other key from the checkpoint.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, FrozenSet, Optional

# Same values as `pggan_tpu/config.py:_DEFAULTS` for these keys.
_DEFAULTS: Dict[str, Any] = {
    "use_validation": False,
    "dataset_root_list": [],
    "save_root": "train_result",
    # optimizer
    "lr_G": 1e-4,
    "lr_D": 1e-5,
    "beta1": 0.0,
    "beta2": 0.99,
    "adam_eps": 1e-8,
    # losses: 'r1' = BCE + R1 on reals, 'wgangp' = BCE + GP + drift
    "W_adv": 1.0,
    "W_gp": 10.0,
    "W_drift_D": 0.001,
    "loss_mode": "r1",
    "r1_target": "logits",
    "r1_interval": 1,
    # batch and run length
    "batch_per_gpu": 16,
    "batch_schedule": None,
    "max_step": 2_000_000,
    # log cycles
    "loss_cycle": 10,
    "test_cycle": 1000,
    "ckpt_cycle": 10000,
    "fid_cycle": 0,
    # model
    "latent_dim": 512,
    "input_dim": 3,
    "output_dim": 3,
    "init_bias_to_zero": True,
    "depths": [512, 512, 512, 512, 256, 128, 64],
    "LReLU_slope": 0.2,
    "generator_last_activation": None,
    "apply_pixel_norm": True,
    "apply_minibatch_norm": True,
    "equalized_lr": True,
    "decision_layer_size": 1,
    # 'dilated' | 'auto' | bool | int (fuse when cout <= N); see
    # models/generator.py for how each maps onto the two exact forms.
    "fused_scale": "dilated",
    # progressive schedule
    "max_step_at_scale": [10000, 20000, 40000, 80000, 80000, 80000, 80000, 80000, 80000],
    "alpha_jump_start": [-1, 2000, 4000, 10000, 10000, 10000, 10000, 10000, 10000],
    "alpha_jump_interval": [0, 100, 100, 100, 100, 100, 100, 100, 100],
    "alpha_jump_Ntimes": [0, 100, 200, 400, 400, 400, 400, 400, 400],
    # checkpoint resume
    "ckpt_id": None,
    "ckpt_step": None,
    "seed": 42,
    "compute_dtype": "float32",       # 'float32' | 'bfloat16'
    "data_backend": "auto",           # 'auto' | 'synthetic' ('folder' waits)
    "synthetic_dataset_size": 4096,
    "g_ema_decay": 0.0,
}


class Config(dict):
    """A dict of settings with attribute access, over the defaults."""

    def __init__(self, values: Optional[Dict[str, Any]] = None):
        super().__init__(copy.deepcopy(_DEFAULTS))
        object.__setattr__(self, "_explicit", set())
        for key, value in (values or {}).items():
            self[key] = value

    def __getattr__(self, item: str) -> Any:
        try:
            return self[item]
        except KeyError:
            raise AttributeError(f"Config has no key {item!r}") from None

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, value)
        self._explicit.add(key)

    @staticmethod
    def from_yaml(path: str) -> "Config":
        """Load a YAML file. A value equal to its default does not count as
        set by the user (`pggan_tpu/config.py:214-238`)."""
        import yaml

        with open(path) as stream:
            raw = yaml.safe_load(stream) or {}
        cfg = Config()
        missing = object()
        for key, value in raw.items():
            dict.__setitem__(cfg, key, value)
            if value != _DEFAULTS.get(key, missing):
                cfg._explicit.add(key)
        return cfg

    def explicit_keys(self) -> FrozenSet[str]:
        """Keys the user set, not defaults or `update` merges."""
        return frozenset(self._explicit)

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(dict(self))
