"""The port's train step, trainer and entry point against the JAX package.

The whole-step test runs `make_train_step(base_cfg(), 1, ...)` with exactly
the config, state and shapes of tests/test_train_step.py (depths [16,16,8],
latent 32, batch 8 at 8×8, alpha 0.5), so the JAX program is one that
suite already compiles, and feeds the port the latents JAX drew. With
β1 = 0, one Adam step from a fresh state leaves mu equal to the gradient,
so JAX's mu and the port's first moment compare the gradients, R1's double
backward included.

Tolerances (f32 on the CPU; the two frameworks sum in other orders):
losses rtol 1e-5, atol 1e-6 (seen: 1.5e-7 relative); gradients rtol 1e-4,
atol 1e-6 (seen: 2.1e-8 absolute on gradients up to 0.13); updated weights
atol 2·lr, because a near-zero gradient may flip the sign of its first
Adam step (lr·g/(|g| + eps) ≈ ±lr; seen: 1.2e-7).
"""

import functools
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pggan_tpu import Config as JaxConfig
from pggan_tpu.data.dataset import SyntheticDataset as JaxSynthetic
from pggan_tpu.data.pipeline import DataPipeline
from pggan_tpu.losses import gan as jgan
from pggan_tpu.models import init_discriminator_params, init_generator_params
from pggan_tpu.train import make_optimizers, make_train_step
from pggan_tpu.train.schedule import ProgressiveSchedule as JaxSchedule
from pggan_tpu.train.step import init_train_state as jax_init_train_state
from pggan_tpu.train.trainer import ProgressiveGANTrainer as JaxTrainer
from pggan_tpu.utils import checkpoint as jax_ckpt
from pggan_tpu_torch import train as port_train
from pggan_tpu_torch.config import Config
from pggan_tpu_torch.data.dataset import SyntheticDataset
from pggan_tpu_torch.data.pipeline import DataPipeline as PortPipeline
from pggan_tpu_torch.losses import gan
from pggan_tpu_torch.models import discriminator, generator
from pggan_tpu_torch.ops.equalized import adam_state_to_jax, params_to_jax
from pggan_tpu_torch.train import step as port_step
from pggan_tpu_torch.train.schedule import ProgressiveSchedule
from pggan_tpu_torch.train.trainer import ProgressiveGANTrainer
from pggan_tpu_torch.utils import checkpoint as port_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTHS, LATENT, BATCH, RES, ALPHA = [16, 16, 8], 32, 8, 8, 0.5
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


# ---- the JAX reference step (tests/test_train_step.py's setup) -------------

def _jax_cfg():
    return JaxConfig({"depths": DEPTHS, "latent_dim": LATENT, "donate_buffers": False})


@functools.lru_cache(maxsize=None)
def _jax_step_at(scale, over=()):
    """(state before, state after, metrics, img, z1, z2, eps) of one JAX
    step at `scale` (alpha ALPHA at scale 1, 0 at scale 0), the config's
    keys `over` (pairs) set."""
    cfg = JaxConfig({"depths": DEPTHS, "latent_dim": LATENT, "donate_buffers": False,
                     **dict(over)})
    kg, kd, ks = jax.random.split(jax.random.PRNGKey(0), 3)
    params_g = init_generator_params(kg, latent_dim=LATENT, depths=DEPTHS, scale=scale)
    params_d = init_discriminator_params(kd, depths=DEPTHS, scale=scale)
    opt_g, opt_d = make_optimizers(cfg)
    state = jax_init_train_state(ks, params_g, params_d, opt_g, opt_d)
    res = 4 * 2 ** scale
    img = np.random.RandomState(0).randint(0, 256, (BATCH, res, res, 3), dtype=np.uint8)
    new_state, metrics, _ = make_train_step(cfg, scale, opt_g, opt_d)(
        state, jnp.asarray(img), jnp.float32(ALPHA if scale else 0.0))
    _, k_z1, k_z2, k_eps = jax.random.split(state.rng, 4)       # step.py:254
    z1 = np.array(jax.random.normal(k_z1, (BATCH, LATENT), jnp.float32))
    z2 = np.array(jax.random.normal(k_z2, (BATCH, LATENT), jnp.float32))
    eps = np.array(jax.random.uniform(k_eps, (BATCH,), jnp.float32))
    return (state, new_state, {k: float(v) for k, v in metrics.items()}, img, z1, z2,
            eps)


def _jax_step():
    """(state before, state after, metrics, img, z1, z2) of one JAX step
    with exactly tests/test_train_step.py's scale-1 setup."""
    return _jax_step_at(1)[:6]


def _port_state(jax_state, cfg):
    G = generator.params_from_jax(jax_ckpt.tree_to_arrays(jax_state.params_G))
    D = discriminator.params_from_jax(jax_ckpt.tree_to_arrays(jax_state.params_D))
    return port_step.init_train_state(cfg, G, D, torch.Generator())


def _port_cfg(**over):
    return Config({"depths": DEPTHS, "latent_dim": LATENT, **over})


def test_one_step_matches_make_train_step():
    state, new_state, want, img, z1, z2 = _jax_step()
    cfg = _port_cfg()
    port = _port_state(state, cfg)
    got, (real, fake) = port_step.make_train_step(cfg, 1)(
        port, torch.from_numpy(img), ALPHA, z1=torch.from_numpy(z1),
        z2=torch.from_numpy(z2))
    assert set(got) == set(want) == {"L_D", "L_D_real", "L_D_fake", "L_D_r1", "L_G"}
    assert real.shape == fake.shape == (BATCH, RES, RES, 3)
    assert real.dtype == fake.dtype == torch.float32
    assert not real.requires_grad and not fake.requires_grad
    _assert_step_matches(got, want, port, new_state, cfg)


def _assert_step_matches(got, want, port, new_state, cfg):
    """The port's step metrics and state after the step against JAX's: the
    losses, Adam's first moments (the gradients) and the weights."""
    for key in want:
        np.testing.assert_allclose(float(got[key]), want[key], err_msg=key, **LOSS_TOL)
    for net, opt, jax_opt, jax_params, lr in (
            (port.D, port.opt_D, new_state.opt_state_D, new_state.params_D, cfg.lr_D),
            (port.G, port.opt_G, new_state.opt_state_G, new_state.params_G, cfg.lr_G)):
        mine, theirs = adam_state_to_jax(opt, net), jax_ckpt.tree_to_arrays(jax_opt)
        assert set(mine) == set(theirs)
        assert int(mine["0/count"]) == int(theirs["0/count"]) == 1
        for key in theirs:
            if key.startswith("0/mu/"):
                np.testing.assert_allclose(mine[key], theirs[key], err_msg=key,
                                           **GRAD_TOL)
        mine, theirs = params_to_jax(net), jax_ckpt.tree_to_arrays(jax_params)
        for key in theirs:
            np.testing.assert_allclose(mine[key], theirs[key], rtol=0,
                                       atol=2 * lr, err_msg=key)


@pytest.mark.parametrize("over, keys", [
    ((("loss_mode", "wgangp"),), {"L_D_gp", "L_D_eps"}),
    ((("r1_target", "loss"),), {"L_D_r1"})], ids=["wgangp", "r1_target_loss"])
def test_scale0_step_modes_match_make_train_step(over, keys):
    """One whole step of the wgangp recipe (BCE + gradient penalty on
    eps-interpolates, as a sum, + drift, real and fake through one 2B D
    forward) and one r1 step with the penalty on the loss, against JAX
    `make_train_step` at scale 0 (tests/test_train_step.py's
    `base_cfg(...)`, batch 8 at 4×4), fed JAX's z1, z2 and eps."""
    state, new_state, want, img, z1, z2, eps = _jax_step_at(0, over)
    cfg = _port_cfg(**dict(over))
    port = _port_state(state, cfg)
    got, _ = port_step.make_train_step(cfg, 0)(
        port, torch.from_numpy(img), 0.0, z1=torch.from_numpy(z1),
        z2=torch.from_numpy(z2), eps=torch.from_numpy(eps))
    assert set(got) == set(want) == {"L_D", "L_D_real", "L_D_fake", "L_G"} | keys
    assert all(want[k] > 0 for k in keys - {"L_D_eps"})
    _assert_step_matches(got, want, port, new_state, cfg)


def test_eval_losses_match_jax_composition():
    """The validation forward at scale 1, alpha 0.5 (so the reals are
    faded) against the JAX trainer's `_eval` composition
    (`trainer.py:598-625`) of discriminator_apply, generator_apply,
    bce_with_logits and generator_loss on the same params, reals and z."""
    from pggan_tpu.models import discriminator_apply, generator_apply
    from pggan_tpu.ops import basic as jbasic

    state = _jax_step()[0]
    rs = np.random.RandomState(8)
    img = rs.randint(0, 256, (BATCH, RES, RES, 3), dtype=np.uint8)
    z = rs.randn(BATCH, LATENT).astype(np.float32)
    alpha = jnp.float32(ALPHA)
    real = jnp.asarray(img, jnp.float32) / 127.5 - 1.0
    real = jbasic.blend(jbasic.upscale2d(jbasic.downscale2d(real, 2), 2), real, alpha)
    logit_real = discriminator_apply(state.params_D, real, alpha)
    logit_fake = discriminator_apply(state.params_D, generator_apply(
        state.params_G, jnp.asarray(z), alpha), alpha)
    want = [float(jnp.mean(logit_real)), float(jnp.mean(logit_fake)),
            float(jgan.bce_with_logits(logit_real, 1) + jgan.bce_with_logits(logit_fake, 0)),
            float(jgan.generator_loss(logit_fake, 2.0))]
    G = generator.params_from_jax(jax_ckpt.tree_to_arrays(state.params_G))
    D = discriminator.params_from_jax(jax_ckpt.tree_to_arrays(state.params_D))
    args = (G, D, torch.from_numpy(img), torch.from_numpy(z), ALPHA)
    got = port_step.eval_losses(*args, w_adv=2.0, fade_real=True)
    assert all(t.dtype == torch.float32 and t.ndim == 0 and not t.requires_grad for t in got)
    np.testing.assert_allclose([float(t) for t in got], want, **LOSS_TOL)
    unfaded = port_step.eval_losses(*args, w_adv=2.0, fade_real=False)
    assert abs(float(unfaded[0]) - want[0]) > 100 * abs(float(got[0]) - want[0])


def test_jax_checkpoint_resumes_in_the_port(tmp_path, capsys):
    """The JAX state after its step, written by the JAX package, restores
    into the port's trainer: weights, Adam moments and count, schedule; its
    `rng` is a JAX key, so the latents are reseeded, and the run says so."""
    _, new_state, _, _, _, _ = _jax_step()
    cfg = _jax_cfg().to_dict()
    cfg.update(data_backend="synthetic", synthetic_dataset_size=32,
               batch_per_gpu=BATCH)
    schedule = {"scale_index": 1, "alpha": ALPHA, "alpha_index": 50,
                "alpha_jump_value": 0.01, "next_scale_jump_step": 30000,
                "next_alpha_jump_step": 10000}
    meta = {"args": cfg, "schedule": schedule, "rng": [0, 1]}
    for name, params, opt in (("G", new_state.params_G, new_state.opt_state_G),
                              ("D", new_state.params_D, new_state.opt_state_D)):
        jax_ckpt.save_checkpoint(str(tmp_path), "jrun", name, 7, params=params,
                                 opt_state=opt, meta=meta)
    trainer = ProgressiveGANTrainer(
        Config({"ckpt_id": "jrun", "save_root": str(tmp_path)}), device="cpu").setup()
    assert trainer.global_step == 7 and trainer.schedule.state_dict() == schedule
    assert "latents reseeded from (seed, step 7)" in capsys.readouterr().out
    trainer.close()
    for net, opt, jax_params, jax_opt in (
            (trainer.state.G, trainer.state.opt_G, new_state.params_G, new_state.opt_state_G),
            (trainer.state.D, trainer.state.opt_D, new_state.params_D, new_state.opt_state_D)):
        for mine, theirs in ((params_to_jax(net), jax_ckpt.tree_to_arrays(jax_params)),
                             (adam_state_to_jax(opt, net), jax_ckpt.tree_to_arrays(jax_opt))):
            assert set(mine) == set(theirs)
            for key in theirs:
                np.testing.assert_array_equal(mine[key], theirs[key], err_msg=key)


def test_port_checkpoint_restores_into_jax_template(tmp_path):
    """A port checkpoint after real steps (Adam state included) fills the
    JAX package's template state strictly, with `arrays_to_tree`."""
    cfg = Config({"depths": DEPTHS, "latent_dim": LATENT, "batch_per_gpu": 4,
                  "save_root": str(tmp_path), "synthetic_dataset_size": 16,
                  "max_step_at_scale": [2, 100], "loss_cycle": 100, "run_id": "p"})
    trainer = ProgressiveGANTrainer(cfg, device="cpu").setup()
    trainer.fit(max_step=3)                                   # grows to scale 1
    jcfg = _jax_cfg()
    opt_g, opt_d = make_optimizers(jcfg)
    template = jax_init_train_state(
        jax.random.PRNGKey(0),
        init_generator_params(jax.random.PRNGKey(1), latent_dim=LATENT,
                              depths=DEPTHS, scale=1),
        init_discriminator_params(jax.random.PRNGKey(2), depths=DEPTHS, scale=1),
        opt_g, opt_d)
    for name, tree, opt_tree in (("G", template.params_G, template.opt_state_G),
                                 ("D", template.params_D, template.opt_state_D)):
        params, opt, meta = jax_ckpt.load_checkpoint(str(tmp_path), "p", name)
        assert meta["global_step"] == 3 and meta["schedule"]["scale_index"] == 1
        assert "rng" not in meta
        restored = jax_ckpt.arrays_to_tree(tree, params)
        opt_state = jax_ckpt.arrays_to_tree(opt_tree, opt)
        assert int(opt_state[0].count) == 1                 # one step since the jump
        scales = [v for k, v in jax_ckpt.tree_to_arrays(opt_state).items()
                  if k.endswith("/scale")]
        assert scales and all(float(v) == 0.0 for v in scales)
        net = trainer.state.G if name == "G" else trainer.state.D
        for key, value in jax_ckpt.tree_to_arrays(restored).items():
            np.testing.assert_array_equal(value, params_to_jax(net)[key], err_msg=key)


def test_skip_r1_step_fuses_real_and_fake_and_r1_scales():
    """include_r1=False runs one 2B D forward (B % 4 == 0) with the same
    losses as two separate forwards; r1_scale multiplies the penalty."""
    state, _, want, img, z1, z2 = _jax_step()
    cfg = _port_cfg()
    feed = dict(z1=torch.from_numpy(z1), z2=torch.from_numpy(z2))
    plain, _ = port_step.make_train_step(cfg, 1, include_r1=False)(
        _port_state(state, cfg), torch.from_numpy(img), ALPHA, **feed)
    assert float(plain["L_D_r1"]) == 0.0
    for key in ("L_D_real", "L_D_fake", "L_G"):
        np.testing.assert_allclose(float(plain[key]), want[key], err_msg=key, **LOSS_TOL)
    scaled, _ = port_step.make_train_step(cfg, 1, include_r1=True, r1_scale=4.0)(
        _port_state(state, cfg), torch.from_numpy(img), ALPHA, **feed)
    np.testing.assert_allclose(float(scaled["L_D_r1"]), 4 * want["L_D_r1"], rtol=1e-5)


def test_weight_average_and_lazy_windows(tmp_path, monkeypatch):
    """With g_ema_decay d, one step leaves G_ema = d·G_before + (1−d)·G_after
    (`step.py:387-390`); `fit` with lazy R1 runs windows longer than one
    step, writes Gema beside G and D, and a resume restores it."""
    state, _, _, img, z1, z2 = _jax_step()
    cfg = _port_cfg(g_ema_decay=0.75)
    port = _port_state(state, cfg)
    before = params_to_jax(port.G)
    port_step.make_train_step(cfg, 1)(port, torch.from_numpy(img), ALPHA,
                                      z1=torch.from_numpy(z1), z2=torch.from_numpy(z2))
    after, ema = params_to_jax(port.G), params_to_jax(port.G_ema)
    for key in before:
        np.testing.assert_allclose(ema[key], 0.75 * before[key] + 0.25 * after[key],
                                   rtol=1e-6, atol=1e-7, err_msg=key)

    windows = []
    monkeypatch.setattr(ProgressiveGANTrainer, "train_window", functools.partialmethod(
        lambda self, k, orig: (windows.append(k), orig(self, k))[1],
        orig=ProgressiveGANTrainer.train_window))
    keys = dict(depths=DEPTHS, latent_dim=LATENT, batch_per_gpu=4, g_ema_decay=0.9,
                save_root=str(tmp_path), synthetic_dataset_size=16, r1_interval=4,
                loss_cycle=6, max_step_at_scale=[100], run_id="lazy")
    trainer = ProgressiveGANTrainer(Config(keys), device="cpu").setup()
    trainer.fit(max_step=7)          # steps 0 and 6 are loss steps: [0] [1..4] [5] [6]
    assert windows == [4] and trainer.global_step == 7
    saved = port_ckpt.load_checkpoint(str(tmp_path), "lazy", "Gema", 7)[0]
    resumed = ProgressiveGANTrainer(Config(dict(keys, ckpt_id="lazy")), device="cpu").setup()
    for key, value in params_to_jax(resumed.state.G_ema).items():
        np.testing.assert_array_equal(value, saved[key], err_msg=key)


def test_losses_match_jax():
    """BCE, drift, G loss and both penalties on the same toy critic
    d(x) = Σ tanh(x·w) per sample."""
    rs = np.random.RandomState(3)
    real, fake = rs.randn(4, 3, 3, 2).astype(np.float32), rs.randn(4, 3, 3, 2).astype(np.float32)
    w, eps = rs.randn(3, 3, 2).astype(np.float32), rs.rand(4).astype(np.float32)
    logits = rs.randn(4, 1).astype(np.float32) * 3

    def jd(x):
        return jnp.sum(jnp.tanh(x * w), axis=(1, 2, 3))[:, None]

    def td(x):
        return torch.tanh(x * torch.from_numpy(w)).sum(dim=(1, 2, 3))[:, None]
    t = torch.from_numpy
    pairs = [
        (gan.bce_with_logits(t(logits), 1), jgan.bce_with_logits(jnp.asarray(logits), 1)),
        (gan.bce_with_logits(t(logits), 0), jgan.bce_with_logits(jnp.asarray(logits), 0)),
        (gan.drift_loss(t(logits), 0.001), jgan.drift_loss(jnp.asarray(logits), 0.001)),
        (gan.generator_loss(t(logits), 2.0), jgan.generator_loss(jnp.asarray(logits), 2.0)),
        (gan.r1_penalty(td, t(real)), jgan.r1_penalty(jd, jnp.asarray(real))),
        (gan.r1_penalty(td, t(real), target="loss"),
         jgan.r1_penalty(jd, jnp.asarray(real), target="loss")),
        (gan.gradient_penalty(td, t(real), t(fake), t(eps), 10.0),
         jgan.gradient_penalty(jd, jnp.asarray(real), jnp.asarray(fake),
                               jnp.asarray(eps), 10.0)),
    ]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(float(got.detach()), float(want), err_msg=str(i),
                                   **LOSS_TOL)


# ---- trainer pieces that are host logic ------------------------------------

SCHEDULES = [
    dict(max_step_at_scale=[5, 40, 1000], alpha_jump_start=[-1, 3, 10],
         alpha_jump_interval=[0, 4, 7], alpha_jump_Ntimes=[0, 5, 24]),
    dict(max_step_at_scale=[100, 300], alpha_jump_start=[-1, 50],
         alpha_jump_interval=[0, 50], alpha_jump_Ntimes=[0, 4]),
]


@pytest.mark.parametrize("sched", SCHEDULES)
def test_schedule_copy_matches_jax(sched):
    jax_s = JaxSchedule(**sched)
    port_s = ProgressiveSchedule(**sched)
    for step in range(sum(sched["max_step_at_scale"][:-1]) + 60):
        assert port_s.check_jump(step) == jax_s.check_jump(step), step
        assert port_s.state_dict() == jax_s.state_dict(), step


@pytest.mark.parametrize("sched, interval, cycles", [
    (SCHEDULES[0], 4, (10, 1000, 25)), (SCHEDULES[1], 16, (7, 40, 1000)),
    (SCHEDULES[1], 1, (10, 1000, 10000))])
def test_lazy_window_cadence_matches_jax(sched, interval, cycles):
    """The port's window lengths equal JAX `_chunk_window`'s over a whole
    run (lazy R1, every-step R1), walking the schedule as `fit` does."""
    loss_cycle, test_cycle, ckpt_cycle = cycles
    keys = dict(sched, loss_cycle=loss_cycle, test_cycle=test_cycle,
                ckpt_cycle=ckpt_cycle, r1_interval=interval)
    port = ProgressiveGANTrainer(Config(keys), device="cpu")
    port._r1_interval = interval
    fake_jax = types.SimpleNamespace(cfg=JaxConfig(keys), _r1_interval=interval,
                                     _chunk_size=1, _chunk_fn=None,
                                     schedule=JaxSchedule(**sched))
    total = sum(sched["max_step_at_scale"][:-1]) + 30
    step, windows = 0, []
    while step < total:
        port.schedule.check_jump(step)
        fake_jax.schedule.check_jump(step)
        k = port._chunk_window(step, total)
        assert k == JaxTrainer._chunk_window(fake_jax, step, total), step
        windows.append(k)
        step += k
    assert (max(windows) > 1) == (interval > 1)


def test_batch_stream_matches_data_pipeline():
    """Batches of the port's DataPipeline equal the JAX DataPipeline's, one
    rank, the same split and seed, with and without a fast-forward."""
    dataset = SyntheticDataset(20, scale_index=1)
    indices = np.arange(3, 20)
    for start in (0, 5):
        with PortPipeline(dataset, 4, indices=indices, num_workers=3, seed=9,
                          start_batch=start) as port, \
                DataPipeline(JaxSynthetic(20, scale_index=1), 4, indices=indices,
                             num_workers=1, seed=9, start_batch=start) as pipe:
            for _ in range(6):                 # past one epoch (17 // 4 = 4)
                want = next(pipe)
                got = next(port)
                assert got.dtype == torch.uint8 and got.shape == (4, 8, 8, 3)
                np.testing.assert_array_equal(got.numpy(), want)


def _eval_trainer(**over):
    """A port trainer on synthetic data at scale 0 (4×4), batch BATCH, set up
    on the CPU (no step taken)."""
    keys = {"depths": DEPTHS, "latent_dim": LATENT, "batch_per_gpu": BATCH,
            "synthetic_dataset_size": 64, "num_data_workers": 2, "use_validation": True,
            **over}
    return ProgressiveGANTrainer(Config(keys), device="cpu").setup()


def test_validation_stream_matches_jax_pipeline(monkeypatch):
    """Validation reads the JAX trainer's valid stream (`trainer.py:565-571`:
    the 30 % split, DataPipeline seed 7, continued from call to call), and
    each call the same latents, drawn from (seed + 999, scale, batch)."""
    from pggan_tpu.data.dataset import split_dataset as jax_split
    from pggan_tpu_torch.train import trainer as trainer_mod

    calls = []

    def spy(G, D, real, z, alpha, **kw):
        calls.append((real.clone(), z.clone(), kw))
        return tuple(torch.zeros(()) for _ in range(4))
    monkeypatch.setattr(trainer_mod, "eval_losses", spy)
    trainer = _eval_trainer(val_batches=3, seed=5)
    try:
        _, valid = jax_split(64, 0.7, seed=5)
        np.testing.assert_array_equal(trainer._valid_indices, valid)
        trainer.validation(0)
        trainer.validation(2)
    finally:
        trainer.close()
    with DataPipeline(JaxSynthetic(64, scale_index=0), BATCH, indices=valid, num_workers=2,
                      prefetch_depth=1, seed=7) as pipe:
        for real, _, kw in calls:
            np.testing.assert_array_equal(real.numpy(), next(pipe))
            assert kw == {"w_adv": 1.0, "fade_real": False, "compute_dtype": torch.float32}
    for b, (_, z, _) in enumerate(calls):
        want = trainer_mod.eval_latents((5 + 999, 0, b % 3), (BATCH, LATENT))
        assert torch.equal(z, want) and torch.equal(z, calls[b % 3][1])
    assert not torch.equal(calls[0][1], calls[1][1])


@pytest.mark.parametrize("size, n", [(64, 12), (40, 48), (20, 16)],
                         ids=["sampled", "whole_valid_split", "train_fallback"])
def test_fid_reals_match_jax_selection(size, n, monkeypatch, capsys):
    """The FID reals, batch by batch, equal those JAX's
    `compute_generative_metrics` draws (`RandomState(0).choice` without
    replacement, `get(i, RandomState(i))`, the train split when the valid one
    holds less than one batch), run on a stand-in trainer whose extraction
    records the batches."""
    import pggan_tpu.metrics as jax_metrics

    trainer = _eval_trainer(synthetic_dataset_size=size)
    batch = trainer.fid_batch_size(n)
    try:
        got = list(trainer.fid_reals(n, batch))
    finally:
        trainer.close()
    fell_back = "falling back to train indices" in capsys.readouterr().out
    seen = []

    def record(batches, extractor, max_samples=None):
        seen.append([np.asarray(b) for b in batches])
        return np.random.RandomState(len(seen)).randn(min(len(seen[-1]) * batch, n), 4)
    monkeypatch.setattr(jax_metrics, "compute_activations", record)
    res = trainer.schedule.resolution
    stand_in = types.SimpleNamespace(
        cfg=JaxConfig({"latent_dim": LATENT, "fid_samples": n}), local_batch_size=BATCH,
        state=types.SimpleNamespace(params_G_ema=None, params_G=None),
        schedule=types.SimpleNamespace(alpha=0.0), is_master=True,
        _fid_sampler=lambda p, z, a: np.zeros((z.shape[0], res, res, 3), np.float32),
        _fid_sampler_packed=False, _fid_extractor=lambda: None,
        _eval_dataset=lambda: JaxSynthetic(size, scale_index=0),
        _valid_indices=trainer._valid_indices, _train_indices=trainer._train_indices)
    JaxTrainer.compute_generative_metrics(stand_in, n)
    assert fell_back == ("falling back" in capsys.readouterr().out) == (size == 20)
    want = seen[0]
    assert [b.shape for b in got] == [b.shape for b in want]
    assert sum(len(b) for b in got) == min(n, len(trainer._train_indices if size == 20
                                                    else trainer._valid_indices))
    for mine, theirs in zip(got, want):
        assert mine.dtype == np.uint8
        np.testing.assert_array_equal(mine, theirs)


# ---- the entry point ---------------------------------------------------------

def _tiny_config(tmp_path, **over):
    keys = {"latent_dim": 16, "depths": [16, 8], "batch_per_gpu": 4,
            "save_root": str(tmp_path), "synthetic_dataset_size": 16,
            "loss_cycle": 1, "ckpt_cycle": 1, "max_step_at_scale": [1, 10],
            "alpha_jump_start": [-1, 1], "alpha_jump_interval": [0, 1],
            "alpha_jump_Ntimes": [0, 2], **over}
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(keys))
    return str(path)


def test_train_module_runs_on_the_cpu(tmp_path):
    """`python -m pggan_tpu_torch.train` for 2 steps (a scale jump between
    them) with --device cpu: finite losses printed, checkpoints in the JAX
    key layout at the last step."""
    proc = subprocess.run(
        [sys.executable, "-m", "pggan_tpu_torch.train", "tiny", "--config",
         _tiny_config(tmp_path), "--max_step", "2", "--device", "cpu",
         "--compute_dtype", "bfloat16"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    loss_lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("lossD:")]
    assert len(loss_lines) == 2
    for line in loss_lines:
        d, g = line.replace("lossD:", "").split("| lossG:")
        assert np.isfinite(float(d)) and np.isfinite(float(g))
    params, opt, meta = port_ckpt.load_checkpoint(str(tmp_path), "tiny", "D", 2)
    assert meta["schedule"]["scale_index"] == 1 and meta["args"]["compute_dtype"] == "bfloat16"
    assert set(opt) == {"0/count"} | {f"0/{m}/{k}" for m in ("mu", "nu") for k in params}
    assert os.path.exists(tmp_path / "tiny" / "ckpt" / "G_latest.npz")


def test_train_without_a_card_exits_nonzero(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    rc = port_train.main(["tiny", "--config", _tiny_config(tmp_path), "--max_step", "1"])
    assert rc != 0 and "--device cpu" in capsys.readouterr().err
