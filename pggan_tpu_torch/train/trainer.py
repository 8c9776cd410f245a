"""ProgressiveGANTrainer on one card — the counterpart of
`pggan_tpu/train/trainer.py`.

It holds G, D, their Adam optimizers, the optional G weight average, the
progressive schedule and the batch stream. A scale jump grows both
networks, rebuilds the data stream at the new resolution, starts fresh
optimizers (the reference discards Adam's moments at every jump) and
builds the next scale's step. Lazy R1 (`r1_interval > 1`) runs the JAX
trainer's window cadence (`_chunk_window`, `trainer.py:388-426`): a window
of k steps between host actions starts with one step whose penalty is
scaled by k, and its k−1 other steps skip the penalty.

`fit` checkpoints before each `ckpt_cycle` step (the saved state holds
exactly that many updates), prints the loss lines with `imgs_per_sec` every
`loss_cycle` steps, and checkpoints at the end. Checkpoints are the JAX
package's npz files, params and Adam state (`utils/checkpoint.py`), written
synchronously; a JAX checkpoint resumes here and the port's resume in JAX.

Not ported yet (ROADMAP.md queue 1): the sample-image grid of `test_cycle`,
validation and FID/KID (refused when configured), SIGTERM
checkpoint-then-exit, asynchronous checkpoint writes, `MetricLogger`,
multiple cards and `steps_per_dispatch`.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from pggan_tpu_torch.config import Config
from pggan_tpu_torch.data.dataset import BatchIterator, build_dataset, split_dataset
from pggan_tpu_torch.losses.collector import LossCollector
from pggan_tpu_torch.models.discriminator import Discriminator
from pggan_tpu_torch.models.generator import Generator
from pggan_tpu_torch.ops.equalized import (adam_state_to_jax,
                                           load_adam_state_from_jax,
                                           load_params_from_jax, params_to_jax)
from pggan_tpu_torch.train.schedule import ProgressiveSchedule
from pggan_tpu_torch.train.step import TrainState, init_train_state, make_train_step
from pggan_tpu_torch.utils import checkpoint as ckpt_lib

# Seed stream of the latents (the JAX trainer folds 2 into its base key).
_KEY_LATENTS = 2


def _latent_rng(seed: int, global_step: int, device: torch.device) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), _KEY_LATENTS, int(global_step)])
    return torch.Generator(device=device).manual_seed(int(state.generate_state(1)[0]))


class ProgressiveGANTrainer:
    def __init__(self, cfg: Config, *, device="cuda"):
        if cfg.use_validation or cfg.fid_cycle:
            raise NotImplementedError(
                "validation and FID are not ported to pggan_tpu_torch yet "
                "(ROADMAP.md queue 1); set use_validation: false, fid_cycle: 0")
        self.cfg = cfg
        self.device = torch.device(device)
        self.schedule = ProgressiveSchedule.from_config(cfg)
        self.global_step = 0
        self.state: Optional[TrainState] = None
        self.loss_collector: Optional[LossCollector] = None
        self._batches: Optional[BatchIterator] = None
        self._step_fn = None
        self._r1_interval = 1
        self._last_metrics: Dict[str, torch.Tensor] = {}
        self._rate_anchor = None

    # -- construction ---------------------------------------------------------
    def setup(self) -> "ProgressiveGANTrainer":
        if self.cfg.ckpt_id is not None:
            self.load_checkpoint()
        else:
            self.initialize_models()
            self.set_dataset()
            self.set_data_iterator()
        self.set_loss_collector()
        self._build_step_fn()
        return self

    def _net_kwargs(self) -> Dict:
        cfg = self.cfg
        return dict(depths=cfg.depths, scale=self.schedule.scale_index,
                    equalized_lr=bool(cfg.equalized_lr),
                    init_bias_to_zero=bool(cfg.init_bias_to_zero),
                    slope=float(cfg.LReLU_slope), seed=int(cfg.seed))

    def initialize_models(self) -> None:
        """G and D at the schedule's scale, with fresh optimizers."""
        cfg = self.cfg
        G = Generator(latent_dim=int(cfg.latent_dim), output_dim=int(cfg.output_dim),
                      apply_pixel_norm=bool(cfg.apply_pixel_norm),
                      last_activation=cfg.generator_last_activation,
                      fused_scale=cfg.fused_scale, **self._net_kwargs())
        D = Discriminator(input_dim=int(cfg.input_dim),
                          decision_layer_size=int(cfg.decision_layer_size),
                          apply_minibatch_norm=bool(cfg.apply_minibatch_norm),
                          **self._net_kwargs())
        self._fresh_state(G.to(self.device), D.to(self.device),
                          _latent_rng(cfg.seed, self.global_step, self.device))

    def _fresh_state(self, G: Generator, D: Discriminator, rng: torch.Generator,
                     G_ema: Optional[Generator] = None) -> None:
        self.state = init_train_state(self.cfg, G, D, rng, G_ema)
        self._rate_anchor = None        # the batch may change with the scale

    def set_dataset(self) -> None:
        """The dataset at the current resolution and its 70/30 split."""
        self.dataset = build_dataset(self.cfg, self.schedule.scale_index)
        self._train_indices, _ = split_dataset(len(self.dataset), 0.7,
                                               seed=int(self.cfg.seed))

    def set_data_iterator(self) -> None:
        """The batch stream of this scale, fast-forwarded past the batches
        already consumed at it (`trainer.py:221-231`)."""
        sched = self.schedule
        scale_start = (sched.next_scale_jump_step
                       - int(sched.max_step_at_scale[sched.scale_index]))
        self._batches = BatchIterator(
            self.dataset, self.batch_size, indices=self._train_indices,
            seed=int(self.cfg.seed) + sched.scale_index,
            start_batch=max(0, self.global_step - scale_start), device=self.device)

    def set_loss_collector(self) -> None:
        self.loss_collector = LossCollector(
            min(sum(self.cfg.max_step_at_scale), self.cfg.max_step))

    @property
    def batch_size(self) -> int:
        """batch_per_gpu, or the `batch_schedule` entry of this scale."""
        cfg, scale = self.cfg, self.schedule.scale_index
        if cfg.batch_schedule:
            sched = {int(k): int(v) for k, v in dict(cfg.batch_schedule).items()}
            if scale in sched:
                return sched[scale]
        return int(cfg.batch_per_gpu)

    # -- schedule -------------------------------------------------------------
    def check_jump(self, global_step: int) -> Dict[str, bool]:
        jumps = self.schedule.check_jump(global_step)
        if jumps["scale_jumped"]:
            self._grow()
        return jumps

    def _grow(self) -> None:
        """Scale jump: grow both networks (and the average, whose new block
        starts equal to G's), fresh optimizers, new data stream and step."""
        state = self.state
        for net in (state.G, state.D, state.G_ema):
            if net is not None:
                net.grow()
        self._fresh_state(state.G, state.D, state.rng, state.G_ema)
        self.set_dataset()
        self.set_data_iterator()
        self._build_step_fn()

    def _build_step_fn(self) -> None:
        cfg = self.cfg
        self._r1_interval = int(cfg.r1_interval) if str(cfg.loss_mode) == "r1" else 1
        if self._r1_interval > 1:
            # a single step is a window of one: the penalty at weight 1
            self._step_fn = make_train_step(cfg, self.schedule.scale_index,
                                            include_r1=True, r1_scale=1.0)
        else:
            self._step_fn = make_train_step(cfg, self.schedule.scale_index)

    # -- the loop -------------------------------------------------------------
    def train_step(self) -> None:
        """One D+G iteration on the next batch."""
        self._last_metrics = self._step_fn(self.state, next(self._batches),
                                           float(self.schedule.alpha))

    def train_window(self, k: int) -> None:
        """A lazy-R1 window of k steps: the first applies the penalty scaled
        by k, the others none (`step.py:470-498`). The window's metrics are
        its last step's, with the first step's L_D_r1."""
        scale, alpha = self.schedule.scale_index, float(self.schedule.alpha)
        lead = make_train_step(self.cfg, scale, include_r1=True, r1_scale=float(k))
        tail = make_train_step(self.cfg, scale, include_r1=False)
        lead_metrics = lead(self.state, next(self._batches), alpha)
        for _ in range(k - 1):
            self._last_metrics = tail(self.state, next(self._batches), alpha)
        self._last_metrics["L_D_r1"] = lead_metrics["L_D_r1"]

    def _chunk_window(self, step: int, total: int) -> int:
        """The length of the lazy-R1 window that starts at `step`: up to
        r1_interval steps, cut at the first host action (a log, image, FID
        or checkpoint cycle, a scale or alpha jump) or at `total`; 1 when
        R1 is not lazy (`trainer.py:388-426`, without steps_per_dispatch)."""
        if self._r1_interval <= 1:
            return 1
        k = min(self._r1_interval, total - step)
        if k < 1:
            return 1
        cfg = self.cfg
        cycles = [int(cfg.loss_cycle), int(cfg.test_cycle), int(cfg.ckpt_cycle)]
        if cfg.fid_cycle:
            cycles.append(int(cfg.fid_cycle))
        jumps = (self.schedule.next_scale_jump_step, self.schedule.next_alpha_jump_step)
        for u in range(step, step + k):
            if any(c > 0 and u % c == 0 for c in cycles) or u in jumps:
                return max(u - step, 1)
        return k

    def fit(self, run_id: Optional[str] = None, *,
            max_step: Optional[int] = None) -> "ProgressiveGANTrainer":
        """The training loop (`trainer.py:428-527`)."""
        cfg = self.cfg
        if run_id is not None:
            cfg.run_id = run_id
        total = min(sum(cfg.max_step_at_scale), cfg.max_step)
        if max_step is not None:
            total = min(total, max_step)
        start_step = step = self.global_step
        self._rate_anchor = (time.time(), step)
        while step < total:
            # before the step: the saved state holds exactly `step` updates
            if step % cfg.ckpt_cycle == 0 and step != start_step:
                self.save_checkpoint(step)
            self.check_jump(step)
            k = self._chunk_window(step, total)
            if k > 1:
                self.train_window(k)
                step += k
                self.global_step = step
                continue
            self.train_step()
            if step % cfg.loss_cycle == 0:
                self.loss_collector.update(self._last_metrics)
                now = time.time()
                if self._rate_anchor and step > self._rate_anchor[1]:
                    t0, s0 = self._rate_anchor
                    self.loss_collector.loss_dict["imgs_per_sec"] = round(
                        (step - s0) * self.batch_size / (now - t0), 1)
                self._rate_anchor = (now, step)
                self.loss_collector.print_loss(step)
            step += 1
            self.global_step = step
        self.save_checkpoint(step)
        return self

    # -- checkpoints ----------------------------------------------------------
    def save_checkpoint(self, global_step: int) -> None:
        """G and D (params + Adam state) and, with the average on, Gema
        (params), in the JAX package's format."""
        cfg, state = self.cfg, self.state
        meta = {"args": cfg.to_dict(), "schedule": self.schedule.state_dict()}
        for name, net, opt in (("G", state.G, state.opt_G), ("D", state.D, state.opt_D)):
            ckpt_lib.save_checkpoint(cfg.save_root, cfg.run_id, name, global_step,
                                     params=params_to_jax(net),
                                     opt=adam_state_to_jax(opt, net), meta=meta)
        if state.G_ema is not None:
            ckpt_lib.save_checkpoint(cfg.save_root, cfg.run_id, "Gema", global_step,
                                     params=params_to_jax(state.G_ema), meta=meta)

    def load_checkpoint(self) -> None:
        """Restore args and schedule, build both networks at the saved scale,
        then load weights and Adam state strictly (`trainer.py:861-954`)."""
        cfg = self.cfg
        loaded = {}
        for name in ("G", "D"):
            result = ckpt_lib.load_checkpoint(cfg.save_root, cfg.ckpt_id, name,
                                              cfg.ckpt_step)
            if result is None:
                raise FileNotFoundError(
                    f"checkpoint {name} not found for ckpt_id={cfg.ckpt_id!r} "
                    f"step={cfg.ckpt_step!r} under {cfg.save_root!r}")
            loaded[name] = result
        steps = {name: int(loaded[name][2]["global_step"]) for name in loaded}
        if len(set(steps.values())) != 1:
            raise RuntimeError(
                f"checkpoint step mismatch across nets: {steps}; resume from an "
                f"explicit consistent step (--ckpt_step {min(steps.values())})")
        # Run-local keys and the keys the user set survive; every other key
        # comes from the checkpoint's args.
        meta = loaded["G"][2]
        keep = {"run_id", "dataset_root_list", "ckpt_id", "ckpt_step"} | cfg.explicit_keys()
        kept = {k: cfg[k] for k in keep if k in cfg}
        cfg.update(meta.get("args", {}))
        cfg.update(kept)
        self.schedule = ProgressiveSchedule.from_config(cfg)
        self.schedule.load_state_dict(meta["schedule"])
        self.global_step = int(meta["global_step"])

        self.initialize_models()
        self.set_dataset()
        self.set_data_iterator()
        state = self.state
        for name, net, opt in (("G", state.G, state.opt_G), ("D", state.D, state.opt_D)):
            params, opt_arrays, _ = loaded[name]
            load_params_from_jax(net, params)
            load_adam_state_from_jax(opt, net, opt_arrays)
        if state.G_ema is not None:
            ema = ckpt_lib.load_checkpoint(cfg.save_root, cfg.ckpt_id, "Gema",
                                           cfg.ckpt_step)
            if ema is None:         # the average turned on mid-run: start at G
                state.G_ema.load_state_dict(state.G.state_dict())
            elif int(ema[2]["global_step"]) != self.global_step:
                raise RuntimeError(
                    f"Gema checkpoint step {ema[2]['global_step']} != G/D step "
                    f"{self.global_step}")
            else:
                load_params_from_jax(state.G_ema, ema[0])
        print(f"checkpoint {cfg.ckpt_id}@{self.global_step} restored "
              f"(scale={self.schedule.scale_index}, alpha={self.schedule.alpha})")
