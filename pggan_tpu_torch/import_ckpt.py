"""Import a reference (PyTorch) PGGAN checkpoint into a run directory of
this package — the counterpart of `tools/import_torch_ckpt.py`:

    python -m pggan_tpu_torch.import_ckpt --g .../G_latest.pt [--d .../D_latest.pt] \\
        --run_id migrated [--save_root train_result]
    python -m pggan_tpu_torch.demo --ckpt_id migrated               # sample it
    python -m pggan_tpu_torch.train migrated2 --ckpt_id migrated    # keep training it

The reference writes `{G|D}_{step}.pt` as a torch pickle holding its `args`
dict, `global_step`, the schedule scalars, the model's state_dict and the
optimizer's (`lib/checkpoint.py:22-34`), so it is loaded with
`weights_only=False`: import only files you trust. The weights are mapped
by `models/torch_port.py` into the port's `Generator` / `Discriminator` at
the checkpoint's scale (a strict load) and written as the npz checkpoints
of `utils/checkpoint.py`, which both packages read. The reference's `args`
are filtered to this package's config keys; the schedule state (scale,
alpha, jump bookkeeping) is imported, so a resumed run continues the fade
where the reference left off. Adam starts fresh, as the reference resets
it at every scale jump (`pggan/model.py:131-139`). With `g_ema_decay` set,
the weight average `Gema` starts as the imported G (the reference keeps
none). G and D of different steps are refused. Runs on the CPU.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from pggan_tpu_torch.config import Config
from pggan_tpu_torch.models.discriminator import Discriminator
from pggan_tpu_torch.models.generator import Generator
from pggan_tpu_torch.models.torch_port import (convert_discriminator_state_dict,
                                               convert_generator_state_dict,
                                               reference_schedule_meta)
from pggan_tpu_torch.ops.equalized import adam_state_to_jax, params_to_jax
from pggan_tpu_torch.utils import checkpoint as ckpt_lib


def load_reference_checkpoint(path: str) -> dict:
    """A reference `.pt` on the CPU (a pickle: it holds the `args` dict)."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _load(net: torch.nn.Module, arrays) -> torch.nn.Module:
    net.load_state_dict({k: torch.from_numpy(v) for k, v in arrays.items()}, strict=True)
    return net


def _save(cfg: Config, name: str, step: int, net: torch.nn.Module, meta: dict, *,
          with_opt: bool = True) -> str:
    opt = adam_state_to_jax(torch.optim.Adam(net.parameters()), net) if with_opt else None
    return ckpt_lib.save_checkpoint(cfg.save_root, cfg.run_id, name, step,
                                    params=params_to_jax(net), opt=opt, meta=meta)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--g", required=True, help="reference G_*.pt")
    parser.add_argument("--d", help="reference D_*.pt (without it the import can be "
                                    "sampled but not trained)")
    parser.add_argument("--run_id", required=True, help="run id to create under --save_root")
    parser.add_argument("--save_root", default="train_result")
    ns = parser.parse_args(argv)

    g_dict = load_reference_checkpoint(ns.g)
    step = int(g_dict["global_step"])
    schedule = reference_schedule_meta(g_dict)
    scale = schedule["scale_index"]
    cfg = Config()
    cfg.update({k: v for k, v in dict(g_dict["args"]).items() if k in cfg})
    cfg.update(run_id=ns.run_id, save_root=ns.save_root, ckpt_id=None, ckpt_step=None)
    meta = {"args": cfg.to_dict(), "schedule": schedule}
    equalized = bool(cfg.equalized_lr)
    net_kw = dict(depths=cfg.depths, scale=scale, equalized_lr=equalized,
                  init_bias_to_zero=bool(cfg.init_bias_to_zero), seed=int(cfg.seed))

    G = _load(Generator(latent_dim=int(cfg.latent_dim), output_dim=int(cfg.output_dim),
                        **net_kw),
              convert_generator_state_dict(g_dict["model"], equalized_lr=equalized))
    path = _save(cfg, "G", step, G, meta)
    print(f"G: {ns.g} → {path} (scale={scale}, alpha={schedule['alpha']}, step={step})")
    if cfg.g_ema_decay:
        _save(cfg, "Gema", step, G, meta, with_opt=False)
        print("Gema: seeded from the imported G (the reference has no weight average)")

    if not ns.d:
        print("no --d given: the import samples, but training it needs D")
        return 0
    d_dict = load_reference_checkpoint(ns.d)
    if int(d_dict["global_step"]) != step:
        raise SystemExit(f"G step {step} != D step {int(d_dict['global_step'])}: refusing to "
                         f"assemble a checkpoint of two steps")
    D = _load(Discriminator(input_dim=int(cfg.input_dim),
                            decision_layer_size=int(cfg.decision_layer_size),
                            apply_minibatch_norm=bool(cfg.apply_minibatch_norm), **net_kw),
              convert_discriminator_state_dict(d_dict["model"], equalized_lr=equalized))
    path = _save(cfg, "D", step, D, meta)
    print(f"D: {ns.d} → {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
