"""Model registry — the counterpart of `pggan_tpu/registry.py`: dispatch on
`cfg.model_id` and return the trainer, set up (fresh, or restored from
`cfg.ckpt_id`). A model family registers its trainer class with
`@register_model("id")`; the class is built as `cls(cfg, device=device)`
and `setup()` returns the trainer."""

from __future__ import annotations

from typing import Callable, Dict

MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(model_id: str):
    """A class decorator that puts the class in MODEL_REGISTRY under `model_id`."""
    def wrap(cls):
        MODEL_REGISTRY[model_id] = cls
        return cls
    return wrap


def create_model(cfg, *, device="cuda"):
    """The set-up trainer for `cfg.model_id`. 'pggan' registers itself on
    first use, so importing the registry imports no trainer."""
    model_id = str(cfg.model_id)
    if model_id not in MODEL_REGISTRY:
        if model_id != "pggan":
            raise KeyError(f"unknown model_id {model_id!r}; known: "
                           f"{sorted(set(MODEL_REGISTRY) | {'pggan'})}")
        from pggan_tpu_torch.train.trainer import ProgressiveGANTrainer
        MODEL_REGISTRY["pggan"] = ProgressiveGANTrainer
    return MODEL_REGISTRY[model_id](cfg, device=device).setup()
