"""ProgressiveGANTrainer — the counterpart of `pggan_tpu/train/trainer.py`,
on one card or one rank of a data-parallel group.

It holds G, D, their Adam optimizers, the optional G weight average, the
progressive schedule and the batch stream (`data/pipeline.py`; with
`device_data_cache` on, assembled on the device from the scale's images
uploaded once, `data/device_cache.py`; with `data_backend_impl: grain`,
`data/grain_pipeline.py`). A scale
jump grows both networks, rebuilds the data stream at the new resolution,
starts fresh optimizers (the reference discards Adam's moments at every
jump) and builds the next scale's step. Lazy R1 (`r1_interval > 1`) runs
the JAX trainer's window cadence (`_chunk_window`, `trainer.py:388-426`): a
window of k steps between host actions starts with one step whose penalty
is scaled by k, and its k−1 other steps skip the penalty. Without lazy R1,
`steps_per_dispatch` k > 1 runs windows of exactly k steps where no host
action falls (JAX's all-or-nothing rule; 'auto': 8 up to 128²). On a card
both kinds of window replay the scale's steps captured in CUDA graphs
(`train/graphs.py`, the counterpart of JAX's one-program chunk); on the CPU
they run the eager steps. Single steps (those a host action reads) stay
eager.

`fit` runs the JAX trainer's loop (`trainer.py:428-527`): a checkpoint
before each `ckpt_cycle` step (the saved state holds exactly that many
updates), the loss line and a `metrics.jsonl` line with `imgs_per_sec`
every `loss_cycle` steps, the [real, fake] sample grid every `test_cycle`
steps, and a checkpoint at the end. SIGTERM and SIGINT stop the loop at the
next step boundary with a checkpoint. Checkpoints are the JAX package's npz
files (`utils/checkpoint.py`), written by a background thread from copies
made on the device; they also hold the latent generator's state, so a
resumed run continues the run it resumes bit for bit (with the data
stream's `start_batch`). A JAX checkpoint resumes here and the port's
resume in JAX.

Evaluation (`trainer.py:544-808`): with `use_validation`, every
`test_cycle` steps `validation` runs `val_batches` held-out batches (the
30 % split) and as many fixed-seed latent batches through `eval_losses` in
the run's compute dtype and logs `val_D_real`, `val_D_fake`, `val_L_D`,
`val_L_G` (and the alias `valid_D_real`); every `fid_cycle` steps
`compute_generative_metrics` samples `fid_samples` images from the weight
average (else G) in f32, draws as many un-augmented held-out reals, each at
most once, sends both through one extractor pass (`fid_extractor`:
'random_conv' or 'inception', `fid_weights` an npz of InceptionV3 weights)
and logs `fid`, `kid` and `kid_std`. The evaluation latents are drawn by CPU
`torch.Generator`s seeded from (seed + 999, scale, batch) and (seed + 777,
batch), so they are the same in every process, on every device and after a
resume, but not JAX's (its threefry keys cannot be reproduced without
JAX); the reals' selection is numpy's and equals JAX's index for index.
The fixed-seed extractor weights are not JAX's either: a port FID without
`fid_weights` compares only with the port's own.

Data parallel (`parallel/mesh.py`, `use_mGPU`): when a process group is
joined, each rank trains on its share of the global batch
(`mesh.local_batch_size`) from its shard of the data stream
(`DataPipeline(rank, num_replicas)`), and the step averages the gradients
over the ranks, so the parameters and Adam state stay equal on every rank
(they are broadcast from rank 0 once, at set-up). Only rank 0 writes the
checkpoints, the grids and `metrics.jsonl`, with a barrier after each
checkpoint it waits for; the losses are averaged over the ranks on
loss_cycle steps, and `imgs_per_sec` counts every rank's images. A SIGTERM
or SIGINT on any rank stops every rank at the same step boundary (an
all-reduce MAX of the flag there). Validation and FID run on every rank
(the same inputs and parameters; no collective inside) and rank 0 logs
them. The minibatch-stddev statistic stays per rank, which equals the
global batch's grouping (the JAX mesh's) only when each rank's batch is a
multiple of its group, so another batch raises. The device data cache
needs one rank (`auto` is off, `true` raises), as JAX's multi-process
rule. After each scale's first window, `utils/debug.py:
check_replication_consistency` checks that the ranks' weights are equal
bit for bit, and raises naming the first that is not.
"""

from __future__ import annotations

import base64
import copy
import signal
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from pggan_tpu_torch.config import Config
from pggan_tpu_torch.data.dataset import ImageFolderDataset, build_dataset, split_dataset
from pggan_tpu_torch.data.device_cache import DeviceDataCache, resolve_device_data_cache
from pggan_tpu_torch.data.pipeline import DataPipeline
from pggan_tpu_torch.losses.collector import LossCollector
from pggan_tpu_torch.metrics.fid import (RandomConvFeatures, compute_activations,
                                          frechet_distance)
from pggan_tpu_torch.metrics.inception import InceptionV3Features
from pggan_tpu_torch.metrics.kid import kid_between_features
from pggan_tpu_torch.models.discriminator import Discriminator
from pggan_tpu_torch.models.generator import Generator
from pggan_tpu_torch.ops.equalized import (adam_state_to_jax,
                                           load_adam_state_from_jax,
                                           load_params_from_jax, params_to_jax)
from pggan_tpu_torch.parallel import mesh
from pggan_tpu_torch.train import graphs
from pggan_tpu_torch.train.schedule import ProgressiveSchedule
from pggan_tpu_torch.train.step import (TrainState, eval_losses, init_train_state,
                                        make_train_step, resolve_steps_per_dispatch)
from pggan_tpu_torch.utils import checkpoint as ckpt_lib
from pggan_tpu_torch.utils.debug import check_replication_consistency
from pggan_tpu_torch.utils.image import save_image as save_image_grid
from pggan_tpu_torch.utils.logging import MetricLogger

# Seed stream of the latents (the JAX trainer folds 2 into its base key).
_KEY_LATENTS = 2
# Seed offsets of the evaluation latents (`trainer.py:632-641,762-771`).
_SEED_VALIDATION, _SEED_FID = 999, 777
# The minibatch-stddev group of D (`ops/basic.py:minibatch_stddev`).
_MBSTD_GROUP = 4
# `__meta__` key of the latent generator's state. The JAX loader reads only
# `rng` (a JAX key), so the port writes its state under its own key.
RNG_META_KEY = "torch_rng"

Images = Tuple[torch.Tensor, torch.Tensor]


def _latent_rng(seed: int, global_step: int, device: torch.device) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), _KEY_LATENTS, int(global_step)])
    return torch.Generator(device=device).manual_seed(int(state.generate_state(1)[0]))


def eval_latents(key, shape) -> torch.Tensor:
    """Fixed latents on the CPU from a torch generator seeded by the integer
    tuple `key`: the same values in every process and for every device."""
    state = np.random.SeedSequence([int(k) for k in key])
    gen = torch.Generator().manual_seed(int(state.generate_state(1)[0]))
    return torch.randn(shape, generator=gen)


def generative_scores(f_real: np.ndarray, f_fake: np.ndarray) -> Dict[str, float]:
    """FID and KID (mean, std) of two feature matrices, host float64
    (`trainer.py:801-808`)."""
    mu_r, sig_r = f_real.mean(0), np.cov(f_real, rowvar=False)
    mu_f, sig_f = f_fake.mean(0), np.cov(f_fake, rowvar=False)
    kid, kid_std = kid_between_features(f_real, f_fake)
    return {"fid": frechet_distance(mu_r, sig_r, mu_f, sig_f), "kid": kid,
            "kid_std": kid_std}


class ProgressiveGANTrainer:
    """Create with `pggan_tpu_torch.registry.create_model(cfg)`, or
    directly and then `setup()`."""

    def __init__(self, cfg: Config, *, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        # a joined process group makes this one rank of a data-parallel run
        self.distributed = torch.distributed.is_initialized()
        self.rank, self.world = mesh.rank(), mesh.world_size()
        self.is_master = self.rank == 0
        self.schedule = ProgressiveSchedule.from_config(cfg)
        self.global_step = 0
        self.state: Optional[TrainState] = None
        self.loss_collector: Optional[LossCollector] = None
        self.logger: Optional[MetricLogger] = None
        self.dataset = None
        self._pipeline: Optional[DataPipeline] = None
        self._train_indices = self._valid_indices = None
        self._valid_pipeline: Optional[DataPipeline] = None
        self._eval_ds = None
        self._fid_extractor_cache = None
        self._step_fn = None
        self._r1_interval = 1
        self._chunk_size = 1
        # windows replay captured steps on a card; the eager steps elsewhere
        # (tools/bench_e2e_torch.py turns it off to time the eager windows)
        self.use_graphs = graphs.graphed(self.device)
        self._graphs: Optional[graphs.StepGraphs] = None
        self._replicas_checked = False
        self._last_metrics: Dict[str, torch.Tensor] = {}
        self._rate_anchor = None
        # one writer thread: checkpoints are written in the order they are
        # taken, and a failed write raises at the next save
        self._ckpt_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="pggan-ckpt")
        self._ckpt_future: Optional[Future] = None

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
        if self.distributed:            # replicas start equal, whatever they loaded
            nets = [n for n in (self.state.G, self.state.D, self.state.G_ema) if n is not None]
            mesh.broadcast_([t.data for n in nets for t in n.state_dict().values()])
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
        self._drop_graphs()

    def set_dataset(self) -> None:
        """The dataset at the current resolution and its 70/30 split. The
        validation pipeline and the FID reals' dataset hold the old
        resolution, so they go (`trainer.py:195-202`)."""
        # rank 0 first: it builds any on-disk resized store the others then read
        if not self.is_master:
            mesh.barrier()
        self.dataset = build_dataset(self.cfg, self.schedule.scale_index,
                                     is_master=self.is_master)
        if self.is_master:
            mesh.barrier()
        self._train_indices, self._valid_indices = split_dataset(
            len(self.dataset), 0.7, seed=int(self.cfg.seed))
        if self._valid_pipeline is not None:
            self._valid_pipeline.close()
            self._valid_pipeline = None
        self._eval_ds = None

    def set_data_iterator(self) -> None:
        """The batch stream of this scale, fast-forwarded past the batches
        already consumed at it (`trainer.py:204-258`). `data_backend_impl`
        picks the thread pipeline ('threads') or grain's ('grain'); any
        other value raises. With `device_data_cache` on
        (`data/device_cache.py`), the thread pipeline's batches are
        assembled on the device from the scale's resized images, uploaded
        once; the old scale's cache is freed before the upload. Grain's
        record stream stays a host pipeline, as in the JAX package."""
        impl = str(self.cfg.data_backend_impl)
        if impl not in ("threads", "grain"):
            raise ValueError(f"data_backend_impl {impl!r}: expected 'threads' or 'grain'")
        if self._pipeline is not None:
            self._pipeline.close()
        self._pipeline = None           # drops the old scale's cache with it
        sched = self.schedule
        scale_start = (sched.next_scale_jump_step
                       - int(sched.max_step_at_scale[sched.scale_index]))
        if self.world > 1 and self.cfg.apply_minibatch_norm and \
                self.batch_size % _MBSTD_GROUP:
            raise ValueError(
                f"the per-rank batch {self.batch_size} is not a multiple of the "
                f"minibatch-stddev group ({_MBSTD_GROUP}): the statistic is taken per rank, "
                f"and equals the global batch's grouping (the JAX mesh's) only when each "
                f"rank's batch is a multiple of the group")
        kwargs = dict(indices=self._train_indices,
                      num_workers=int(self.cfg.num_data_workers),
                      prefetch_depth=int(self.cfg.prefetch_depth),
                      seed=int(self.cfg.seed) + sched.scale_index,
                      rank=self.rank, num_replicas=self.world,
                      start_batch=max(0, self.global_step - scale_start), device=self.device)
        if impl == "grain":
            from pggan_tpu_torch.data.grain_pipeline import GrainPipeline
            self._pipeline = GrainPipeline(self.dataset, self.batch_size, **kwargs)
            return
        assemble_fn = None
        if resolve_device_data_cache(self.cfg, self.dataset, num_replicas=self.world):
            cache = DeviceDataCache(self.dataset, self.device)
            assemble_fn = cache.assemble
            print(f"[pggan_tpu_torch] device data cache: {cache.n_images} images, "
                  f"{cache.nbytes / 1e6:.1f} MB on {self.device}")
        self._pipeline = DataPipeline(self.dataset, self.batch_size, assemble_fn=assemble_fn,
                                      **kwargs)

    def set_loss_collector(self) -> None:
        self.loss_collector = LossCollector(
            min(sum(self.cfg.max_step_at_scale), self.cfg.max_step))

    @property
    def batch_size(self) -> int:
        """This rank's batch: batch_per_gpu, or its share of the scale's
        `batch_schedule` entry (the global batch)."""
        return mesh.local_batch_size(self.cfg, self.world, self.schedule.scale_index)

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

    def _make_step(self, **kw):
        """The step of this scale, averaging its gradients over the ranks
        when a process group is joined."""
        if self.distributed:
            kw.update(grad_sync=mesh.all_reduce_mean_, rank=self.rank, world_size=self.world)
        return make_train_step(self.cfg, self.schedule.scale_index, **kw)

    def _build_step_fn(self) -> None:
        """The scale's single step and window length (`trainer.py:303-351`).
        An explicit `steps_per_dispatch` > 1 with lazy R1 raises, as in JAX
        (lazy R1 makes its own windows); 'auto' then defers to them."""
        cfg = self.cfg
        self._r1_interval = int(cfg.r1_interval) if str(cfg.loss_mode) == "r1" else 1
        if self._r1_interval > 1:
            # a single step is a window of one: the penalty at weight 1
            self._step_fn = self._make_step(include_r1=True, r1_scale=1.0)
        else:
            self._step_fn = self._make_step()
        self._chunk_size = resolve_steps_per_dispatch(cfg, self.schedule.scale_index)
        if self._chunk_size > 1 and self._r1_interval > 1:
            if cfg["steps_per_dispatch"] != "auto":
                raise ValueError(
                    "steps_per_dispatch > 1 is incompatible with r1_interval > 1 (lazy R1 "
                    "dispatches its own r1_interval-length windows); use "
                    "steps_per_dispatch: auto or r1_interval: 1")
            self._chunk_size = 1
        self._drop_graphs()

    def _drop_graphs(self) -> None:
        """Forget the captured steps: they hold the addresses of tensors
        that a new state, optimizer or checkpoint replaces."""
        self._graphs = None
        self._replicas_checked = False

    def _step_graphs(self) -> graphs.StepGraphs:
        if self._graphs is None:
            note = (" (in a process group the step's NCCL all-reduce is captured "
                    "with it)" if self.distributed else "")
            self._graphs = graphs.StepGraphs(self.state, self._make_step, self.device,
                                             note=note, verbose=self.is_master)
        return self._graphs

    # -- the loop -------------------------------------------------------------
    def train_step(self) -> Images:
        """One D+G iteration on the next batch; returns (faded real, fake)
        for the sample grid."""
        self._last_metrics, images = self._step_fn(
            self.state, next(self._pipeline), float(self.schedule.alpha))
        return images

    def train_chunk(self, k: int) -> None:
        """A `steps_per_dispatch` window: k steps of the scale's step over the
        next k batches (`trainer.py:360-379`), on a card k replays of its
        captured step. The window's metrics are its last step's."""
        alpha = float(self.schedule.alpha)
        if not self.use_graphs:
            for _ in range(k):
                self._last_metrics, _ = self._step_fn(self.state, next(self._pipeline), alpha)
            return
        runner = self._step_graphs()
        for _ in range(k):
            metrics = runner.run("step", next(self._pipeline), alpha)
        # the next replay rewrites the graph's outputs
        self._last_metrics = {name: v.clone() for name, v in metrics.items()}
        self._check_replicas()

    def train_window(self, k: int) -> None:
        """A lazy-R1 window of k steps: the first applies the penalty scaled
        by k, the others none (`step.py:470-498`); on a card the lead's and
        the tail's captured steps replayed. The window's metrics are its last
        step's, with the first step's L_D_r1."""
        alpha = float(self.schedule.alpha)
        if not self.use_graphs:
            lead = self._make_step(include_r1=True, r1_scale=float(k))
            tail = self._make_step(include_r1=False)
            lead_metrics, _ = lead(self.state, next(self._pipeline), alpha)
            for _ in range(k - 1):
                self._last_metrics, _ = tail(self.state, next(self._pipeline), alpha)
            self._last_metrics["L_D_r1"] = lead_metrics["L_D_r1"]
            return
        runner = self._step_graphs()
        r1 = runner.run("lead", next(self._pipeline), alpha, r1_scale=k)["L_D_r1"].clone()
        for _ in range(k - 1):
            metrics = runner.run("tail", next(self._pipeline), alpha)
        self._last_metrics = {name: v.clone() for name, v in metrics.items()}
        self._last_metrics["L_D_r1"] = r1
        self._check_replicas()

    def _check_replicas(self) -> None:
        """In a process group, once a scale after its first window: the
        ranks' weights equal bit for bit (the claim of the module
        docstring), or raise."""
        if self.distributed and not self._replicas_checked:
            state = self.state
            check_replication_consistency(
                {"G": state.G, "D": state.D, "G_ema": state.G_ema})
            self._replicas_checked = True

    def _chunk_window(self, step: int, total: int) -> int:
        """The length of the window that starts at `step` (`trainer.py:
        388-426`). Lazy R1: up to r1_interval steps, cut at the first host
        action (a log, image, FID or checkpoint cycle, a scale or alpha
        jump) or at `total`. Otherwise `steps_per_dispatch` k when steps
        [step, step + k) hold no host action and end by `total`, else 1
        (all or nothing). So the sample grid and the log lines always come
        from single steps."""
        lazy = self._r1_interval > 1
        if lazy:
            k = min(self._r1_interval, total - step)
        else:
            k = self._chunk_size
            if k < 2 or step + k > total:
                return 1
        if k < 1:
            return 1
        cfg = self.cfg
        cycles = [int(cfg.loss_cycle), int(cfg.test_cycle), int(cfg.ckpt_cycle)]
        if cfg.fid_cycle:
            cycles.append(int(cfg.fid_cycle))
        jumps = (self.schedule.next_scale_jump_step, self.schedule.next_alpha_jump_step)
        for u in range(step, step + k):
            if any(c > 0 and u % c == 0 for c in cycles) or u in jumps:
                return max(u - step, 1) if lazy else 1
        return k

    def fit(self, run_id: Optional[str] = None, *,
            max_step: Optional[int] = None) -> "ProgressiveGANTrainer":
        """The training loop (`trainer.py:428-527`). SIGTERM / SIGINT set a
        flag that the loop reads between steps (and lazy-R1 windows); it
        then checkpoints the state and returns, so `--ckpt_id {run_id}`
        resumes where it stopped. Signal handlers can only be installed on
        the main thread; elsewhere the loop runs without them. In a process
        group the flag is agreed across the ranks at each boundary, so every
        rank stops (and checkpoints) at the same step."""
        cfg = self.cfg
        if run_id is not None:
            cfg.run_id = run_id
        if self.logger is None and self.is_master:
            self.logger = MetricLogger(cfg.save_root, cfg.run_id, model_id=str(cfg.model_id),
                                       use_wandb=bool(cfg.use_wandb))
        total = min(sum(cfg.max_step_at_scale), cfg.max_step)
        if max_step is not None:
            total = min(total, max_step)

        interrupted = []

        def on_signal(signum, frame):
            interrupted.append(signum)

        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, on_signal)
            except ValueError:          # not the main thread
                pass
        start_step = step = self.global_step
        self._rate_anchor = (time.time(), step)
        stop = False
        try:
            while step < total:
                stop = mesh.any_rank(bool(interrupted))
                if stop:
                    break
                # before the step: the saved state holds exactly `step` updates
                if step % cfg.ckpt_cycle == 0 and step != start_step:
                    self.save_checkpoint(step)
                self.check_jump(step)
                k = self._chunk_window(step, total)
                if k > 1:
                    if self._r1_interval > 1:
                        self.train_window(k)
                    else:
                        self.train_chunk(k)
                    step += k
                    self.global_step = step
                    continue
                images = self.train_step()
                if step % cfg.loss_cycle == 0:
                    metrics = self._mean_over_ranks(self._last_metrics)
                    if self.is_master:
                        self._log_losses(step, metrics)
                if step % cfg.test_cycle == 0:
                    if self.is_master:
                        self.save_image(images, step)
                    if cfg.use_validation:
                        self.validation(step)
                if cfg.fid_cycle and step % cfg.fid_cycle == 0 and step:
                    scores = self.compute_generative_metrics()
                    if self.is_master:
                        self.logger.log(step, scores)
                        print(f"step {step}: FID = {scores['fid']:.2f}  "
                              f"KID = {scores['kid']:.5f}")
                step += 1
                self.global_step = step
            self.save_checkpoint(step, wait=True)
            if stop and self.is_master:
                print(f"[pggan_tpu_torch] interrupted at step {step}; state "
                      f"checkpointed — resume with --ckpt_id {cfg.run_id}")
        finally:
            for sig, handler in previous.items():
                if handler is not None:     # None: a handler not set from Python
                    signal.signal(sig, handler)
        return self

    def _mean_over_ranks(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The step's metrics averaged over the ranks (one all-reduce; the
        rank's own without a process group). Every rank must call it."""
        if not self.distributed:
            return metrics
        keys = sorted(metrics)
        values = torch.stack([metrics[k].float() for k in keys])
        mesh.all_reduce_mean_([values])
        return dict(zip(keys, values))

    def _log_losses(self, step: int, metrics: Dict[str, torch.Tensor]) -> None:
        """The loss line and its `metrics.jsonl` record, with the images a
        second of every rank since the last one."""
        self.loss_collector.update(metrics)
        now = time.time()
        if self._rate_anchor and step > self._rate_anchor[1]:
            t0, s0 = self._rate_anchor
            self.loss_collector.loss_dict["imgs_per_sec"] = round(
                (step - s0) * self.batch_size * self.world / (now - t0), 1)
        self._rate_anchor = (now, step)
        self.logger.log(step, self.loss_collector.loss_dict)
        self.loss_collector.print_loss(step)

    # -- io -------------------------------------------------------------------
    def save_image(self, images: Images, step: int) -> str:
        """The [real, fake] grid of the step's first 8 images to
        {save_root}/{run_id}/imgs/e{step}.jpg; only those cross to the host."""
        real, fake = (x[:8].float().cpu().numpy() for x in images)
        return save_image_grid(self.cfg.save_root, self.cfg.run_id, step, "imgs",
                               [real, fake])

    # -- evaluation -----------------------------------------------------------
    def validation(self, step: int) -> None:
        """Held-out evaluation (`trainer.py:544-642`): `val_batches` batches
        of the valid split (a pipeline of its own: 2 workers, prefetch 1,
        seed 7) through D, as many fixed-seed latent batches through G and
        D, in the run's compute dtype; the adversarial losses on those
        logits, averaged, logged as `val_*` (and `valid_D_real`)."""
        if self._valid_indices is None or len(self._valid_indices) == 0:
            return
        cfg, state = self.cfg, self.state
        if self._valid_pipeline is None:
            self._valid_pipeline = DataPipeline(
                self.dataset, self.batch_size, indices=self._valid_indices,
                num_workers=2, prefetch_depth=1, seed=7, device=self.device)
        scale, alpha = self.schedule.scale_index, float(self.schedule.alpha)
        dt = torch.bfloat16 if str(cfg.compute_dtype) == "bfloat16" else torch.float32
        totals = np.zeros(4, np.float64)
        n_batches = max(1, int(cfg.val_batches))
        for b in range(n_batches):
            real = next(self._valid_pipeline)
            z = eval_latents((int(cfg.seed) + _SEED_VALIDATION, scale, b),
                             (real.shape[0], int(cfg.latent_dim))).to(self.device)
            out = eval_losses(state.G, state.D, real, z, alpha, w_adv=float(cfg.W_adv),
                              fade_real=scale > 0, compute_dtype=dt)
            totals += torch.stack(out).double().cpu().numpy()
        totals /= n_batches
        if self.logger is not None:
            self.logger.log(step, {
                "val_D_real": totals[0], "val_D_fake": totals[1],
                "val_L_D": totals[2], "val_L_G": totals[3],
                "valid_D_real": totals[0],              # the legacy name
            })

    def _eval_dataset(self):
        """The un-augmented twin of the training dataset, under the run's
        decode-cache policy (FID reals are not flipped or jittered)."""
        if self._eval_ds is None:
            if isinstance(self.dataset, ImageFolderDataset):
                cfg = self.cfg
                self._eval_ds = ImageFolderDataset(
                    [], self.schedule.scale_index, augment=False, paths=self.dataset.paths,
                    cache_decoded=cfg.cache_decoded, decode_cache_mb=int(cfg.decode_cache_mb))
            else:
                self._eval_ds = self.dataset          # synthetic: no augmentation
        return self._eval_ds

    def _fid_extractor(self):
        """The configured extractor on the run's device, built once a run
        (it does not depend on the resolution): `fid_extractor`
        'random_conv' (256 features) or 'inception' (`fid_weights`)."""
        if self._fid_extractor_cache is None:
            if str(self.cfg.fid_extractor) == "inception":
                self._fid_extractor_cache = InceptionV3Features(
                    weights=self.cfg.fid_weights, device=self.device)
            else:
                self._fid_extractor_cache = RandomConvFeatures(feature_dim=256,
                                                               device=self.device)
        return self._fid_extractor_cache

    def fid_batch_size(self, n: int) -> int:
        return max(8, min(64, self.batch_size, n))

    def fid_reals(self, n: int, batch: int) -> Iterator[np.ndarray]:
        """uint8 batches of up to n distinct un-augmented reals of the valid
        split (the train split when the valid one holds less than a batch),
        drawn as the JAX trainer draws them (`trainer.py:773-797`)."""
        if self._valid_indices is not None and len(self._valid_indices) >= batch:
            indices = self._valid_indices
        else:
            indices = self._train_indices
            print("[pggan_tpu_torch] FID reals: valid split smaller than one batch — "
                  "falling back to train indices")
        eval_ds = self._eval_dataset()
        # each real at most once: duplicates would bias KID's within-real sum
        chosen = (np.asarray(indices) if len(indices) <= n
                  else np.random.RandomState(0).choice(indices, size=n, replace=False))
        for start in range(0, len(chosen), batch):
            yield np.stack([eval_ds.get(int(i), np.random.RandomState(int(i)))
                            for i in chosen[start:start + batch]])

    def fid_fakes(self, n: int, batch: int) -> Iterator[torch.Tensor]:
        """Batches of samples of the weight average (else G) in f32, clipped
        to [-1, 1], on the run's device, until n are drawn. f32 as the JAX
        trainer's sampler (`trainer.py:751-755`), whatever the run's dtype."""
        cfg, state = self.cfg, self.state
        G = state.G_ema if state.G_ema is not None else state.G
        alpha = float(self.schedule.alpha)
        for i in range(-(-n // batch)):
            z = eval_latents((int(cfg.seed) + _SEED_FID, i),
                             (batch, int(cfg.latent_dim))).to(self.device)
            with torch.no_grad():
                fake = G(z, alpha).clamp(-1.0, 1.0)
            yield fake

    def compute_fid(self, num_samples: Optional[int] = None) -> float:
        """FID only — see `compute_generative_metrics` for the full set."""
        return self.compute_generative_metrics(num_samples)["fid"]

    def compute_generative_metrics(self, num_samples: Optional[int] = None
                                   ) -> Dict[str, float]:
        """`fid`, `kid` and `kid_std` between `num_samples` (default
        `fid_samples`) generated images and the held-out reals at the
        current scale, from one pass of each set through the configured
        extractor (`trainer.py:695-808`)."""
        n = int(num_samples or self.cfg.fid_samples)
        batch = self.fid_batch_size(n)
        extractor = self._fid_extractor()
        f_real = compute_activations(self.fid_reals(n, batch), extractor, max_samples=n)
        f_fake = compute_activations(self.fid_fakes(n, batch), extractor, max_samples=n)
        return generative_scores(f_real, f_fake)

    def save_checkpoint(self, global_step: int, *, wait: bool = False) -> None:
        """G and D (params + Adam state) and, with the average on, Gema
        (params), in the JAX package's format, with the latent generator's
        state in `__meta__`. The files are written by the writer thread;
        `wait=True` returns once they are.

        Adam updates the weights and its moments in place, so the writer
        cannot read the live tensors while steps go on: the state is copied
        on the device here, before the next step is enqueued, and on the
        same stream, so the copies hold the state at `global_step`. The
        writer then moves the copies to the host and frees them.

        In a process group only rank 0 writes; with `wait=True` every rank
        returns only once the files are written (a barrier)."""
        if not self.is_master:
            if wait:
                mesh.barrier()
            return
        if self._ckpt_future is not None:
            future, self._ckpt_future = self._ckpt_future, None
            future.result()             # one write at a time; raise its error
        cfg, state = self.cfg, self.state
        rng_state = state.rng.get_state().numpy().tobytes()
        meta = {"args": cfg.to_dict(), "schedule": self.schedule.state_dict(),
                RNG_META_KEY: {"device": state.rng.device.type,
                               "state": base64.b64encode(rng_state).decode("ascii")}}
        # The last step's gradients are not state: dropped, not copied.
        state.opt_G.zero_grad(set_to_none=True)
        state.opt_D.zero_grad(set_to_none=True)
        with torch.no_grad():
            snapshot = copy.deepcopy((state.G, state.opt_G, state.D, state.opt_D,
                                      state.G_ema))
        save_root, run_id = cfg.save_root, cfg.run_id

        def write():
            G, opt_G, D, opt_D, G_ema = snapshot
            for name, net, opt in (("G", G, opt_G), ("D", D, opt_D)):
                ckpt_lib.save_checkpoint(save_root, run_id, name, global_step,
                                         params=params_to_jax(net),
                                         opt=adam_state_to_jax(opt, net), meta=meta)
            if G_ema is not None:
                ckpt_lib.save_checkpoint(save_root, run_id, "Gema", global_step,
                                         params=params_to_jax(G_ema), meta=meta)

        self._ckpt_future = self._ckpt_pool.submit(write)
        if wait:
            future, self._ckpt_future = self._ckpt_future, None
            future.result()
            mesh.barrier()

    def load_checkpoint(self) -> None:
        """Restore args and schedule, build both networks at the saved scale,
        then load weights and Adam state strictly (`trainer.py:861-954`),
        and the latent generator's state where the checkpoint holds one for
        this device type."""
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
        saved = meta.get(RNG_META_KEY)
        if saved is not None and saved["device"] == self.device.type:
            state.rng.set_state(torch.frombuffer(
                bytearray(base64.b64decode(saved["state"])), dtype=torch.uint8))
        else:
            why = ("it holds no torch generator state" if saved is None else
                   f"its generator state is for {saved['device']}, not {self.device.type}")
            if self.is_master:
                print(f"[pggan_tpu_torch] latents reseeded from (seed, step "
                      f"{self.global_step}): {why}")
        self._drop_graphs()             # the optimizers' state tensors are new
        if self.is_master:
            print(f"checkpoint {cfg.ckpt_id}@{self.global_step} restored "
                  f"(scale={self.schedule.scale_index}, alpha={self.schedule.alpha})")

    def close(self) -> None:
        """Wait for a checkpoint still being written, then stop the writer,
        the data pipelines and the metrics file."""
        if self._ckpt_future is not None:
            future, self._ckpt_future = self._ckpt_future, None
            try:
                future.result()
            except Exception as exc:    # fit's own error is already on its way
                print(f"[pggan_tpu_torch] checkpoint write failed: {exc!r}")
        self._ckpt_pool.shutdown(wait=True)
        for pipeline in (self._pipeline, self._valid_pipeline):
            if pipeline is not None:
                pipeline.close()
        self._pipeline = self._valid_pipeline = None
        if self.logger is not None:
            self.logger.close()
            self.logger = None
