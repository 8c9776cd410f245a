"""The port's chunked dispatch (`steps_per_dispatch`, lazy-R1 windows)
against the JAX package, on the CPU.

- `resolve_steps_per_dispatch` and the trainers' refusals on the same
  configs through both packages (no JAX program compiled: JAX's
  `_build_step_fn` only wraps its steps in `jax.jit`);
- the window lengths of the port's `_chunk_window` against JAX's over a whole
  schedule, with `steps_per_dispatch: 8` and with lazy R1/16;
- on the CPU a window runs the eager steps: `train_chunk(k)` equals k
  `train_step` calls, and `train.main --steps_per_dispatch` runs JAX's
  windows;
- a step fed alpha and the R1 scale as 0-d tensors equals the step fed the
  floats, bit for bit (what a captured step reads at every replay);
- a capture that fails makes the window raise (no eager fallback on a card);
- a lazy window's lead step (`include_r1=True, r1_scale=3`) and tail step
  (`include_r1=False`) against JAX `make_train_step` at the same options on
  tests/test_train_step.py's tiny config: losses, weights and both Adam
  moments (the two single-step JAX programs this file compiles).

Tolerances (f32 on the CPU, the frameworks sum in other orders): losses
rtol 1e-5, atol 1e-6; Adam's first moment (= the gradient after one step,
β1 = 0) rtol 1e-4, atol 1e-6; its second ((1 − β2)·g²) twice the gradient's
relative bound, atol 3e-9 (0.02·|g|·1e-6 at the largest gradients, ~0.13);
weights atol 2·lr (a near-zero gradient may flip the sign of its first Adam
step).
"""

import contextlib
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pggan_tpu import Config as JaxConfig
from pggan_tpu.models import init_discriminator_params, init_generator_params
from pggan_tpu.train import make_optimizers, make_train_step
from pggan_tpu.train.schedule import ProgressiveSchedule as JaxSchedule
from pggan_tpu.train.step import init_train_state as jax_init_train_state
from pggan_tpu.train.step import resolve_steps_per_dispatch as jax_resolve
from pggan_tpu.train.trainer import ProgressiveGANTrainer as JaxTrainer
from pggan_tpu.utils import checkpoint as jax_ckpt
from pggan_tpu_torch import train as port_train
from pggan_tpu_torch.config import Config
from pggan_tpu_torch.models import discriminator, generator
from pggan_tpu_torch.ops.equalized import adam_state_to_jax, params_to_jax
from pggan_tpu_torch.train import graphs
from pggan_tpu_torch.train import step as port_step
from pggan_tpu_torch.train.trainer import ProgressiveGANTrainer
from pggan_tpu_torch.utils import checkpoint as port_ckpt

DEPTHS, LATENT, BATCH, ALPHA = [16, 16, 8], 32, 8, 0.5
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
MU_TOL = dict(rtol=1e-4, atol=1e-6)
NU_TOL = dict(rtol=2e-4, atol=3e-9)
TINY = dict(depths=[16, 8, 8], latent_dim=16, batch_per_gpu=4, synthetic_dataset_size=16,
            num_data_workers=2)


# ---- the window length rule and the refusals -------------------------------

CASES = ([("auto", 1, s) for s in range(7)] + [(1, 1, 6), (8, 1, 3), (0, 1, 3),
                                               (8, 16, 3), ("auto", 16, 3)])


def _jax_build(keys, scale):
    """JAX's trainer `_build_step_fn` on a stand-in (it wraps its steps in
    `jax.jit` and compiles nothing): its window length, or the error."""
    cfg = JaxConfig(keys)
    opt_g, opt_d = make_optimizers(cfg)
    stand_in = types.SimpleNamespace(cfg=cfg, opt_g=opt_g, opt_d=opt_d,
                                     schedule=types.SimpleNamespace(scale_index=scale))
    JaxTrainer._build_step_fn(stand_in)
    return stand_in._chunk_size


def _port_build(keys, scale):
    trainer = ProgressiveGANTrainer(Config(keys), device="cpu")
    try:
        trainer.schedule.scale_index = scale
        trainer._build_step_fn()
        return trainer._chunk_size
    finally:
        trainer.close()


@pytest.mark.parametrize("spd, interval, scale", CASES,
                         ids=[f"{a}-r1_{b}-scale{c}" for a, b, c in CASES])
def test_steps_per_dispatch_resolves_and_refuses_as_jax(spd, interval, scale):
    """`resolve_steps_per_dispatch` ('auto': 8 up to 128², else 1; below 1
    raises) and the trainer's rule (an explicit N > 1 with lazy R1 raises,
    'auto' defers to the lazy windows): the same value or the same error."""
    keys = {"steps_per_dispatch": spd, "r1_interval": interval, "loss_mode": "r1"}
    outcomes = []
    for resolve, build, make_cfg in ((jax_resolve, _jax_build, JaxConfig),
                                     (port_step.resolve_steps_per_dispatch, _port_build,
                                      Config)):
        try:
            outcomes.append((resolve(make_cfg(keys), scale), build(keys, scale)))
        except ValueError as exc:
            outcomes.append(("ValueError", str(exc)))
    assert outcomes[0] == outcomes[1]
    if spd == "auto" and interval == 1:
        assert outcomes[1] == ((8, 8) if scale <= 5 else (1, 1))


# ---- the windows over a schedule -------------------------------------------

SCHEDULES = [
    dict(max_step_at_scale=[5, 40, 1000], alpha_jump_start=[-1, 3, 10],
         alpha_jump_interval=[0, 4, 7], alpha_jump_Ntimes=[0, 5, 24]),
    dict(max_step_at_scale=[100, 300], alpha_jump_start=[-1, 50],
         alpha_jump_interval=[0, 50], alpha_jump_Ntimes=[0, 4]),
]


@pytest.mark.parametrize("sched, spd, interval, cycles", [
    (SCHEDULES[0], 8, 1, (10, 1000, 25)), (SCHEDULES[1], 8, 1, (9, 45, 1000)),
    (SCHEDULES[1], 8, 1, (100, 1000, 10000)), (SCHEDULES[1], "auto", 16, (7, 40, 1000)),
    (SCHEDULES[0], "auto", 16, (10, 1000, 25))],
    ids=["spd8-a", "spd8-b", "spd8-c", "lazy16-b", "lazy16-a"])
def test_chunk_window_matches_jax(sched, spd, interval, cycles):
    """The port's window lengths equal JAX `Trainer._chunk_window`'s
    (`trainer.py:388-426`) over a whole run, walking the schedule as `fit`
    does: steps_per_dispatch windows all or nothing, lazy ones cut at the
    host actions. The window size comes from each package's rule at the
    scale the run is at."""
    loss_cycle, test_cycle, ckpt_cycle = cycles
    keys = dict(sched, loss_cycle=loss_cycle, test_cycle=test_cycle, ckpt_cycle=ckpt_cycle,
                r1_interval=interval, steps_per_dispatch=spd)
    port = ProgressiveGANTrainer(Config(keys), device="cpu")
    fake_jax = types.SimpleNamespace(cfg=JaxConfig(keys), _r1_interval=interval,
                                     schedule=JaxSchedule(**sched))
    total = sum(sched["max_step_at_scale"][:-1]) + 30
    step, windows = 0, []
    try:
        while step < total:
            jumped = port.schedule.check_jump(step)["scale_jumped"]
            fake_jax.schedule.check_jump(step)
            if jumped or step == 0:
                port._build_step_fn()
                size = jax_resolve(fake_jax.cfg, fake_jax.schedule.scale_index)
                fake_jax._chunk_size = 1 if interval > 1 else size
                fake_jax._chunk_fn = object() if fake_jax._chunk_size > 1 else None
            k = port._chunk_window(step, total)
            assert k == JaxTrainer._chunk_window(fake_jax, step, total), step
            windows.append(k)
            step += k
    finally:
        port.close()
    assert max(windows) > 1
    if interval == 1:
        assert set(windows) <= {1, 8}


# ---- windows on the CPU run the eager steps ---------------------------------

def _trainer(**over):
    return ProgressiveGANTrainer(Config(dict(TINY, **over)), device="cpu").setup()


def _state_arrays(trainer):
    state = trainer.state
    out = {f"G/{k}": v for k, v in params_to_jax(state.G).items()}
    out.update({f"D/{k}": v for k, v in params_to_jax(state.D).items()})
    for name, net, opt in (("optG", state.G, state.opt_G), ("optD", state.D, state.opt_D)):
        out.update({f"{name}/{k}": v for k, v in adam_state_to_jax(opt, net).items()})
    return out


@pytest.mark.parametrize("lazy", [False, True], ids=["steps_per_dispatch", "lazy_window"])
def test_window_on_cpu_equals_single_steps(lazy):
    """`train_chunk(4)` equals 4 `train_step` calls, and `train_window(4)`
    the lead step (R1 ×4) then 3 tail steps, bit for bit in the weights and
    Adam's state, from the same state and data stream; the window's metrics
    are its last step's (with the lead's L_D_r1)."""
    over = dict(r1_interval=4) if lazy else dict(steps_per_dispatch=4)
    window, steps = _trainer(**over), _trainer(**over)
    try:
        assert not window.use_graphs and window._chunk_size == (1 if lazy else 4)
        if lazy:
            window.train_window(4)
            lead = steps._make_step(include_r1=True, r1_scale=4.0)
            tail = steps._make_step(include_r1=False)
            first, _ = lead(steps.state, next(steps._pipeline), float(steps.schedule.alpha))
            for _ in range(3):
                last, _ = tail(steps.state, next(steps._pipeline), float(steps.schedule.alpha))
            last["L_D_r1"] = first["L_D_r1"]
        else:
            window.train_chunk(4)
            for _ in range(4):
                steps.train_step()
            last = steps._last_metrics
        want, got = _state_arrays(steps), _state_arrays(window)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert {k: float(v) for k, v in window._last_metrics.items()} == \
            {k: float(v) for k, v in last.items()}
        assert torch.equal(window.state.rng.get_state(), steps.state.rng.get_state())
    finally:
        window.close()
        steps.close()


def test_train_main_runs_steps_per_dispatch_windows(tmp_path, monkeypatch):
    """`python -m pggan_tpu_torch.train --steps_per_dispatch 4 --device cpu`
    runs windows of 4 where no loss line falls, single steps elsewhere, and
    ends at max_step with its checkpoint."""
    windows = []
    chunk = ProgressiveGANTrainer.train_chunk
    monkeypatch.setattr(ProgressiveGANTrainer, "train_chunk",
                        lambda self, k: (windows.append((self.global_step, k)), chunk(self, k)))
    config = tmp_path / "tiny.yaml"
    config.write_text("".join(f"{k}: {v}\n" for k, v in dict(
        TINY, save_root=str(tmp_path), loss_cycle=5, max_step_at_scale=[100]).items()))
    rc = port_train.main(["spd", "--config", str(config), "--max_step", "12",
                          "--steps_per_dispatch", "4", "--device", "cpu"])
    assert rc == 0
    assert windows == [(1, 4), (6, 4)]                # 0 5 10 11 single
    assert port_ckpt.load_checkpoint(str(tmp_path), "spd", "G", 12) is not None


def test_tensor_alpha_and_r1_scale_equal_the_floats():
    """A step fed alpha and the lead's R1 scale as 0-d f32 tensors equals the
    step fed the floats, bit for bit (weights w_b = f32(alpha) and
    w_a = 1 − w_b in f32 on both routes), at scale 1 where the reals, G and
    D all blend."""
    cfg = Config(dict(TINY, g_ema_decay=0.9))
    alpha = 0.3141
    runs = []
    for as_tensor in (False, True):
        G = generator.Generator(latent_dim=16, depths=[16, 8, 8], scale=1, seed=3)
        D = discriminator.Discriminator(depths=[16, 8, 8], scale=1, seed=3)
        state = port_step.init_train_state(cfg, G, D, torch.Generator().manual_seed(5))
        r1 = torch.tensor(3.0) if as_tensor else 3.0
        a = torch.tensor(alpha) if as_tensor else alpha
        img = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (4, 8, 8, 3),
                                                                dtype=np.uint8))
        metrics, (real, fake) = port_step.make_train_step(
            cfg, 1, include_r1=True, r1_scale=r1)(state, img, a)
        runs.append((metrics, real, fake, state))
    (m_f, real_f, fake_f, s_f), (m_t, real_t, fake_t, s_t) = runs
    assert all(torch.equal(m_f[k], m_t[k]) for k in m_f) and float(m_f["L_D_r1"]) > 0
    assert torch.equal(real_f, real_t) and torch.equal(fake_f, fake_t)
    for net_f, net_t in ((s_f.G, s_t.G), (s_f.D, s_t.D), (s_f.G_ema, s_t.G_ema)):
        for (name, a_f), a_t in zip(net_f.state_dict().items(), net_t.state_dict().values()):
            assert torch.equal(a_f, a_t), name


class _FakeStream:
    def wait_stream(self, other):
        pass


@contextlib.contextmanager
def _failing_capture(*args, **kwargs):
    raise RuntimeError("operation not permitted when stream is capturing")
    yield


def test_failed_capture_raises(monkeypatch):
    """With graphs on, a capture that fails makes `train_chunk` raise (its
    first step ran eagerly as the capture's warm-up); no window runs
    eagerly in its place. The card's stream and graph calls are stood in
    for, so the path runs on the CPU."""
    cuda = graphs.torch.cuda
    monkeypatch.setattr(cuda, "Stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(cuda, "CUDAGraph", lambda: types.SimpleNamespace(
        register_generator_state=lambda gen: None))
    monkeypatch.setattr(cuda, "graph", _failing_capture)
    trainer = _trainer(steps_per_dispatch=4)
    try:
        trainer.use_graphs = True
        with pytest.raises(RuntimeError, match="capturing the step step in a CUDA graph "
                                               "failed; a chunked window does not run eagerly"):
            trainer.train_chunk(4)
    finally:
        trainer.close()


# ---- a lazy window's lead and tail steps against JAX ------------------------

@functools.lru_cache(maxsize=None)
def _jax_lazy_step(include_r1, r1_scale):
    """(state before, state after, metrics, img, z1, z2) of one JAX step at
    scale 1, alpha ALPHA, tests/test_train_step.py's config with
    r1_interval 16, built with `include_r1` and `r1_scale`."""
    cfg = JaxConfig({"depths": DEPTHS, "latent_dim": LATENT, "donate_buffers": False,
                     "r1_interval": 16})
    kg, kd, ks = jax.random.split(jax.random.PRNGKey(0), 3)
    params_g = init_generator_params(kg, latent_dim=LATENT, depths=DEPTHS, scale=1)
    params_d = init_discriminator_params(kd, depths=DEPTHS, scale=1)
    opt_g, opt_d = make_optimizers(cfg)
    state = jax_init_train_state(ks, params_g, params_d, opt_g, opt_d)
    img = np.random.RandomState(0).randint(0, 256, (BATCH, 8, 8, 3), dtype=np.uint8)
    step = make_train_step(cfg, 1, opt_g, opt_d, include_r1=include_r1, r1_scale=r1_scale)
    new_state, metrics, _ = step(state, jnp.asarray(img), jnp.float32(ALPHA))
    _, k_z1, k_z2, _ = jax.random.split(state.rng, 4)          # step.py:254
    z1 = np.array(jax.random.normal(k_z1, (BATCH, LATENT), jnp.float32))
    z2 = np.array(jax.random.normal(k_z2, (BATCH, LATENT), jnp.float32))
    return state, new_state, {k: float(v) for k, v in metrics.items()}, img, z1, z2


@pytest.mark.parametrize("include_r1, r1_scale", [(True, 3.0), (False, None)],
                         ids=["lead_r1x3", "tail"])
def test_lazy_window_step_matches_jax(include_r1, r1_scale):
    """One lead step (the penalty ×3) and one tail step (no penalty), each
    from JAX's initial state with JAX's latents, against JAX
    `make_train_step(include_r1=..., r1_scale=...)`: the losses, and after
    the step the weights and both Adam moments of G and D."""
    state, new_state, want, img, z1, z2 = _jax_lazy_step(include_r1, r1_scale)
    cfg = Config({"depths": DEPTHS, "latent_dim": LATENT, "r1_interval": 16})
    G = generator.params_from_jax(jax_ckpt.tree_to_arrays(state.params_G))
    D = discriminator.params_from_jax(jax_ckpt.tree_to_arrays(state.params_D))
    port = port_step.init_train_state(cfg, G, D, torch.Generator())
    got, _ = port_step.make_train_step(cfg, 1, include_r1=include_r1, r1_scale=r1_scale)(
        port, torch.from_numpy(img), ALPHA, z1=torch.from_numpy(z1), z2=torch.from_numpy(z2))
    assert set(got) == set(want)
    assert (want["L_D_r1"] > 0) == include_r1
    for key in want:
        np.testing.assert_allclose(float(got[key]), want[key], err_msg=key, **LOSS_TOL)
    for net, opt, jax_opt, jax_params, lr in (
            (port.D, port.opt_D, new_state.opt_state_D, new_state.params_D, cfg.lr_D),
            (port.G, port.opt_G, new_state.opt_state_G, new_state.params_G, cfg.lr_G)):
        mine, theirs = adam_state_to_jax(opt, net), jax_ckpt.tree_to_arrays(jax_opt)
        assert set(mine) == set(theirs) and int(mine["0/count"]) == int(theirs["0/count"]) == 1
        for key in theirs:
            tol = MU_TOL if key.startswith("0/mu/") else NU_TOL
            if key != "0/count":
                np.testing.assert_allclose(mine[key], theirs[key], err_msg=key, **tol)
        mine, theirs = params_to_jax(net), jax_ckpt.tree_to_arrays(jax_params)
        for key in theirs:
            np.testing.assert_allclose(mine[key], theirs[key], rtol=0, atol=2 * lr,
                                       err_msg=key)
