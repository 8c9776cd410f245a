"""YAML-backed attribute-style configuration — the counterpart of
`pggan_tpu/config.py`, reduced to what the sampling path reads.

`Config` is a dict with attribute access. Keys it does not know are kept as
they are, so a checkpoint's `args` (the JAX trainer's whole config) loads
unchanged; the defaults below cover the keys the generator and the demo read
when a config omits them.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

# Same values as `pggan_tpu/config.py:_DEFAULTS` for these keys.
_DEFAULTS: Dict[str, Any] = {
    "latent_dim": 512,
    "depths": [512, 512, 512, 512, 256, 128, 64],
    "output_dim": 3,
    "equalized_lr": True,
    "init_bias_to_zero": True,
    "LReLU_slope": 0.2,
    "apply_pixel_norm": True,
    "generator_last_activation": None,
    # 'dilated' | 'auto' | bool | int (fuse when cout <= N); see
    # models/generator.py for how each maps onto the two exact forms.
    "fused_scale": "dilated",
    "seed": 42,
}


class Config(dict):
    """A dict of settings with attribute access, over the defaults."""

    def __init__(self, values: Optional[Dict[str, Any]] = None):
        super().__init__(copy.deepcopy(_DEFAULTS))
        if values:
            self.update(values)

    def __getattr__(self, item: str) -> Any:
        try:
            return self[item]
        except KeyError:
            raise AttributeError(f"Config has no key {item!r}") from None

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    @staticmethod
    def from_yaml(path: str) -> "Config":
        import yaml

        with open(path) as stream:
            return Config(yaml.safe_load(stream) or {})

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(dict(self))
