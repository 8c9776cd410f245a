"""YAML-backed attribute-style configuration — the counterpart of
`pggan_tpu/config.py`.

`Config` is a dict with attribute access. Keys it does not know are kept as
they are, so a checkpoint's `args` (the JAX trainer's whole config) loads
unchanged. The defaults are the JAX package's table, key for key and value
for value, including the keys only the JAX package reads; so the two
packages agree on which keys a YAML file sets.

Like the JAX package's config, it remembers which keys the user set (a
config file value that differs from the default, a constructor argument or
an item or attribute write), as opposed to defaults and `update` merges. A
resumed run keeps those and takes every other key from the checkpoint.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, FrozenSet, Optional

# Same keys and values as `pggan_tpu/config.py:_DEFAULTS`.
_DEFAULTS: Dict[str, Any] = {
    "model_id": "pggan",
    "use_mGPU": False,
    "use_wandb": False,
    "wandb_alert_thres": 1000,
    "use_validation": False,
    "valid_dataset_root": None,
    "val_batches": 4,
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
    "max_step": 2_000_000,
    # log cycles
    "loss_cycle": 10,
    "test_cycle": 1000,
    "ckpt_cycle": 10000,
    # model
    "latent_dim": 512,
    "input_dim": 3,
    "output_dim": 3,
    "init_bias_to_zero": True,
    "max_depths": 7,
    "depths": [512, 512, 512, 512, 256, 128, 64],
    # progressive schedule
    "max_step_at_scale": [10000, 20000, 40000, 80000, 80000, 80000, 80000, 80000, 80000],
    "alpha": 0.0,
    "alpha_jump_start": [-1, 2000, 4000, 10000, 10000, 10000, 10000, 10000, 10000],
    "alpha_jump_interval": [0, 100, 100, 100, 100, 100, 100, 100, 100],
    "alpha_jump_Ntimes": [0, 100, 200, 400, 400, 400, 400, 400, 400],
    "LReLU_slope": 0.2,
    "generator_last_activation": None,
    "apply_pixel_norm": True,
    "apply_minibatch_norm": True,
    "equalized_lr": True,
    "decision_layer_size": 1,
    # checkpoint resume
    "ckpt_id": None,
    "ckpt_step": None,
    "seed": 42,
    "compute_dtype": "float32",       # 'float32' | 'bfloat16'
    "impl": "xla",                    # JAX package only
    "data_backend": "auto",           # 'auto' | 'folder' | 'synthetic'
    "data_backend_impl": "threads",   # 'threads' | 'grain' (data/grain_pipeline.py)
    "synthetic_dataset_size": 4096,
    "num_data_workers": 8,
    "prefetch_depth": 2,
    # folder data (`data/dataset.py`, the native C++ loader when it builds,
    # else PIL): hflip + color jitter, the resized images decoded once a
    # scale when they fit decode_cache_mb, else the on-disk resized store
    # (`data/resized_store.py`)
    "augment": True,
    "cache_decoded": "auto",          # 'auto' | True | False
    "decode_cache_mb": 8192,
    "resized_store": "auto",          # 'auto' | True | False
    "resized_store_dir": None,        # None → '<save_root>/resized_store'
    # device-resident dataset cache (`data/device_cache.py`): upload the
    # resized-at-scale images to the card once per scale and assemble the
    # batches there — per-step host->device traffic drops from megabytes of
    # pixels to bytes of indices, and the host decodes and jitters nothing in
    # the step loop. 'auto' enables it when the dataset fits
    # `device_cache_mb` and one process feeds one card.
    "device_data_cache": False,       # 'auto' | True | False
    "device_cache_mb": 256,
    # per-scale batch override: {scale_index: batch}; None → batch_per_gpu
    "batch_schedule": None,
    # steps a dispatch in event-free windows: an int >= 1 or 'auto' (8 up to
    # 128², else 1); checked when the trainer builds a scale's step
    # (`train/step.py:resolve_steps_per_dispatch`, as JAX's `step.py:509-523`);
    # on a card a window replays the step captured in a CUDA graph
    "steps_per_dispatch": 1,
    # JAX package only: XLA options, rematerialization and packed top levels
    "donate_buffers": True,
    "compiler_options": None,
    "remat": "auto",
    # 'dilated' | 'auto' | bool | int (fuse when cout <= N); see
    # models/generator.py for how each maps onto the two exact forms.
    "fused_scale": "dilated",
    "hires_pack": "auto",
    # FID / KID every fid_cycle steps (0 = off; `metrics/`)
    "fid_cycle": 0,
    "fid_samples": 512,
    "fid_extractor": "random_conv",
    "fid_weights": None,
    # G weight average (PGGAN paper §A.1); 0.0 = off
    "g_ema_decay": 0.0,
}


# The keys of a StyleGAN2 generator (`model_id: stylegan2`,
# `models/stylegan2.py`), at config-f's values (Karras et al. 2020,
# NVIDIA's stylegan2 `run_training.py` config-f and stylegan2-ada-pytorch's
# `num_fp16_res` 4, `conv_clamp` 256). The JAX package has no such model, so
# they stay out of `_DEFAULTS`; `stylegan2_args` lays a checkpoint's args
# over them.
STYLEGAN2_DEFAULTS: Dict[str, Any] = {
    "z_dim": 512,
    "w_dim": 512,
    "mapping_layers": 8,
    "mapping_lr_multiplier": 0.01,
    "resolution": 1024,
    "fmap_base": 32768,               # channels min(2·fmap_base / res, fmap_max)
    "fmap_max": 512,
    "num_fp16_res": 4,                # highest resolutions in bfloat16
    "conv_clamp": 256,
    "output_dim": 3,
}


def stylegan2_args(values: Dict[str, Any]) -> Dict[str, Any]:
    """STYLEGAN2_DEFAULTS with the keys of `values` that it names laid over."""
    return {key: values.get(key, default) for key, default in STYLEGAN2_DEFAULTS.items()}


# The keys of a StyleGAN3-T generator (`model_id: stylegan3`,
# `models/stylegan3.py`), at `stylegan3-t`'s values at 1024² (Karras et al.
# 2021; NVIDIA's stylegan3 `train.py --cfg=stylegan3-t`: cbase 32768, cmax
# 512, map 2, num_fp16_res 4, conv_clamp 256; `networks_stylegan3.py`'s
# `SynthesisNetwork` and `SynthesisLayer` defaults). Out of `_DEFAULTS` for
# the same reason; `stylegan3_args` lays a checkpoint's args over them.
STYLEGAN3_DEFAULTS: Dict[str, Any] = {
    "z_dim": 512,
    "w_dim": 512,
    "mapping_layers": 2,
    "mapping_lr_multiplier": 0.01,
    "resolution": 1024,
    "channel_base": 32768,            # channels rint(min(channel_base / 2 / cutoff, channel_max))
    "channel_max": 512,
    "num_layers": 14,
    "num_critical": 2,
    "first_cutoff": 2.0,
    "first_stopband": 2 ** 2.1,
    "last_stopband_rel": 2 ** 0.3,
    "margin_size": 10,
    "output_scale": 0.25,
    "num_fp16_res": 4,                # layers at the highest sampling rates in bfloat16
    "conv_clamp": 256,
    "conv_kernel": 3,
    "filter_size": 6,
    "lrelu_upsampling": 2,
    "output_dim": 3,
}


def stylegan3_args(values: Dict[str, Any]) -> Dict[str, Any]:
    """STYLEGAN3_DEFAULTS with the keys of `values` that it names laid over."""
    return {key: values.get(key, default) for key, default in STYLEGAN3_DEFAULTS.items()}


def default_depths(max_scale: int) -> list:
    """The reference's depth law (configs.yaml's depths generalised;
    `pggan_tpu/config.py:180-189`): 512 through scale 3, then halved each
    scale, floored at 16, with at least the reference's 7 entries."""
    return [512 if s <= 3 else max(16, 512 >> (s - 3))
            for s in range(max(max_scale + 1, 7))]


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

    def save_yaml(self) -> str:
        """Write the effective config to {save_root}/{run_id}/config_{run_id}.yaml
        (`pggan_tpu/config.py:314-328`); returns the path."""
        import yaml

        run_dir = os.path.join(str(self.save_root), str(self.run_id))
        os.makedirs(run_dir, exist_ok=True)
        path = os.path.join(run_dir, f"config_{self.run_id}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)
        return path
