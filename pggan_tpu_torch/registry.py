"""Model registry — the counterpart of `pggan_tpu/registry.py`: dispatch on
`cfg.model_id` and return the trainer, set up (fresh, or restored from
`cfg.ckpt_id`)."""

from __future__ import annotations


def create_model(cfg, *, device="cuda"):
    """The set-up trainer for `cfg.model_id`; only 'pggan' is ported."""
    model_id = str(cfg.model_id)
    if model_id != "pggan":
        raise KeyError(f"unknown model_id {model_id!r}; pggan_tpu_torch has: ['pggan']")
    from pggan_tpu_torch.train.trainer import ProgressiveGANTrainer
    return ProgressiveGANTrainer(cfg, device=device).setup()
