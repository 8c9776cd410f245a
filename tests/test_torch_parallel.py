"""Data-parallel training in the port (`pggan_tpu_torch/parallel/`,
`utils/stats.py`, the data-parallel step and trainer, `train.main
--use_mGPU`) against the JAX package's mesh semantics, on the CPU.

The two-rank step reuses tests/test_torch_train.py's JAX program (scale 1,
batch 8 at 8×8, alpha 0.5): each of two gloo ranks takes 4 rows of JAX's
real batch, z1, z2 and eps, averages its gradients with the other's, and
must land where JAX's step at the global batch lands (that file's
tolerances) — and both ranks bit for bit on the same state. The processes
are spawned by `parallel.dryrun.run_ranks` (a FileStore rendezvous in
tmp_path, a deadline of RANK_TIMEOUT seconds); their bodies are in
tests/torch_rank_worker.py, which imports no JAX.
"""

import glob
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import test_torch_train as tt
from pggan_tpu.config import Config as JaxConfig
from pggan_tpu.data.dataset import SyntheticDataset as JaxSynthetic
from pggan_tpu.data.pipeline import DataPipeline as JaxPipeline
from pggan_tpu.models import init_discriminator_params, init_generator_params
from pggan_tpu.parallel import mesh as jax_mesh
from pggan_tpu.train import make_optimizers
from pggan_tpu.train.step import init_train_state as jax_init_train_state
from pggan_tpu.utils import checkpoint as jax_ckpt
from pggan_tpu.utils import stats as jax_stats
from pggan_tpu_torch.config import Config
from pggan_tpu_torch.parallel import dryrun, mesh
from pggan_tpu_torch.train.trainer import ProgressiveGANTrainer
from pggan_tpu_torch.utils import checkpoint as port_ckpt
from pggan_tpu_torch.utils import stats

RANK_TIMEOUT = 120.0
WORLD = 2


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("schedule", [None, {0: 8, 1: 12}], ids=["per_gpu", "schedule"])
def test_batch_sizes_match_jax(n, schedule):
    """global_batch_size on n ranks = JAX's on a mesh of n of the 8 virtual
    devices; local_batch_size = JAX's per-device shard, and raises where
    the global batch does not divide."""
    keys = {"batch_per_gpu": 6, "batch_schedule": schedule}
    cfg, jax_cfg = Config(keys), JaxConfig(keys)
    device_mesh = jax_mesh.create_mesh(devices=jax.devices()[:n])
    for scale in (0, 1, 2):
        want = jax_mesh.global_batch_size(jax_cfg, device_mesh, scale)
        assert mesh.global_batch_size(cfg, n, scale) == want
        if want % n:
            with pytest.raises(ValueError, match="does not divide"):
                mesh.local_batch_size(cfg, n, scale)
        else:
            assert mesh.local_batch_size(cfg, n, scale) == want // n


def test_stats_match_jax():
    """report / report0 / report_moments and the Collector (num, mean, std,
    the baseline at construction, an idle round keeping the last stats)
    against the JAX package's on the same values."""
    rs = np.random.RandomState(3)
    rounds = [{"a": rs.randn(5).astype(np.float32), "b": np.float32(rs.randn())},
              {"a": rs.randn(3, 2).astype(np.float32)}, {}]
    results = []
    for mod, convert in ((jax_stats, jnp.asarray), (stats, torch.from_numpy)):
        mod.reset()
        mod.report("early", convert(np.ones(2, np.float32)))
        collector = mod.Collector("a|b|m")
        seen = []
        for values in rounds:
            for name, value in values.items():
                (mod.report0 if name == "b" else mod.report)(name, convert(np.asarray(value)))
            collector.update()
            seen.append(collector.as_dict())
        moments = np.array([4.0, 2.0, 3.0])
        mod.report_moments("m", moments)
        collector.update()
        seen.append(collector.as_dict())
        mod.reset()
        results.append(seen)
    assert len(results[0]) == len(results[1])
    for want, got in zip(*results):
        assert set(want) == set(got)
        for name in want:
            np.testing.assert_allclose([got[name][k] for k in ("num", "mean", "std")],
                                       [want[name][k] for k in ("num", "mean", "std")],
                                       rtol=1e-6, err_msg=name)


def test_rank_batch_streams_match_jax_pipeline():
    """Each rank's trainer stream (its share of the global batch, its shard
    of the epoch) equals JAX `DataPipeline(rank=r, num_replicas=2)`."""
    cfg = Config({"depths": [8, 8], "latent_dim": 8, "batch_per_gpu": 4,
                  "data_backend": "synthetic", "synthetic_dataset_size": 20,
                  "num_data_workers": 1, "seed": 5})
    for rank in range(WORLD):
        trainer = ProgressiveGANTrainer(cfg, device="cpu")
        trainer.rank, trainer.world = rank, WORLD
        trainer.set_dataset()
        trainer.set_data_iterator()
        try:
            got = [next(trainer._pipeline).numpy() for _ in range(4)]
        finally:
            trainer.close()
        with JaxPipeline(JaxSynthetic(20, scale_index=0), 4, indices=trainer._train_indices,
                         num_workers=1, seed=5, rank=rank, num_replicas=WORLD) as theirs:
            want = [np.asarray(next(theirs)) for _ in range(4)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _jax_step_inputs():
    """The state, batch and latents of `tt._jax_step_at(1)` before its step
    (the same keys and draws), without compiling the step."""
    kg, kd, ks = jax.random.split(jax.random.PRNGKey(0), 3)
    params_g = init_generator_params(kg, latent_dim=tt.LATENT, depths=tt.DEPTHS, scale=1)
    params_d = init_discriminator_params(kd, depths=tt.DEPTHS, scale=1)
    state = jax_init_train_state(ks, params_g, params_d, *make_optimizers(tt._jax_cfg()))
    img = np.random.RandomState(0).randint(0, 256, (tt.BATCH, tt.RES, tt.RES, 3), dtype=np.uint8)
    _, k_z1, k_z2, k_eps = jax.random.split(state.rng, 4)
    z1, z2 = (np.array(jax.random.normal(k, (tt.BATCH, tt.LATENT), jnp.float32))
              for k in (k_z1, k_z2))
    return state, img, z1, z2, np.array(jax.random.uniform(k_eps, (tt.BATCH,), jnp.float32))


def test_two_rank_step_matches_jax_global_batch(tmp_path):
    """The ranks run while this process compiles and runs JAX's step."""
    state, img, z1, z2, eps = _jax_step_inputs()
    rs = np.random.RandomState(9)
    stats_values = rs.randn(10).astype(np.float32)
    inputs = {"cfg": json.dumps({"depths": tt.DEPTHS, "latent_dim": tt.LATENT}),
              "scale": 1, "alpha": tt.ALPHA, "img": img, "z1": z1, "z2": z2, "eps": eps,
              "stats_values": stats_values}
    for name, params in (("G", state.params_G), ("D", state.params_D)):
        inputs.update({f"{name}/{k}": v for k, v in jax_ckpt.tree_to_arrays(params).items()})
    np.savez(tmp_path / "inputs.npz", **inputs)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(dryrun.run_ranks, _worker().step_rank, WORLD,
                            (str(tmp_path / "inputs.npz"), str(tmp_path)),
                            store=str(tmp_path / "store"), timeout=RANK_TIMEOUT)
        before, new_state, want, *jax_inputs = tt._jax_step_at(1)
        ranks.result()
    for mine, theirs in zip((img, z1, z2, eps), jax_inputs):
        np.testing.assert_array_equal(mine, theirs)
    for mine, theirs in ((state.params_G, before.params_G), (state.params_D, before.params_D)):
        for key, value in jax_ckpt.tree_to_arrays(theirs).items():
            np.testing.assert_array_equal(jax_ckpt.tree_to_arrays(mine)[key], value)

    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]
    assert set(ranks[0]) == set(ranks[1])
    for key in ranks[0]:
        np.testing.assert_array_equal(ranks[1][key], ranks[0][key], err_msg=key)
    got = ranks[0]
    for key in want:
        np.testing.assert_allclose(float(got[f"metric/{key}"]), want[key], err_msg=key,
                                   **tt.LOSS_TOL)
    for name, jax_opt, jax_params, lr in (
            ("G", new_state.opt_state_G, new_state.params_G, 1e-4),
            ("D", new_state.opt_state_D, new_state.params_D, 1e-5)):
        theirs = jax_ckpt.tree_to_arrays(jax_opt)
        assert int(got[f"{name}/opt/0/count"]) == int(theirs["0/count"]) == 1
        for key in theirs:
            if key.startswith("0/mu/"):
                np.testing.assert_allclose(got[f"{name}/opt/{key}"], theirs[key],
                                           err_msg=key, **tt.GRAD_TOL)
        for key, value in jax_ckpt.tree_to_arrays(jax_params).items():
            np.testing.assert_allclose(got[f"{name}/params/{key}"], value, rtol=0,
                                       atol=2 * lr, err_msg=key)
    # the pooled moments: JAX's psum_moments over a 2-device pmap
    pooled = jax.pmap(lambda v: jax_stats.psum_moments(v, "i"), axis_name="i")(
        jnp.asarray(stats_values.reshape(WORLD, -1)))[0]
    np.testing.assert_allclose(got["moments"], np.asarray(pooled), rtol=1e-6)


def _worker():
    import torch_rank_worker
    return torch_rank_worker


def _tiny_config(root, **over):
    """Scale 0 (4×4) at 4 images a rank, synthetic data, a loss line every
    step, a grid every 2."""
    keys = {"latent_dim": 16, "depths": [16, 8], "batch_per_gpu": 4, "save_root": str(root),
            "data_backend": "synthetic", "synthetic_dataset_size": 32, "num_data_workers": 1,
            "loss_cycle": 1, "test_cycle": 2, "ckpt_cycle": 100,
            "max_step_at_scale": [100, 100], **over}
    path = root / f"tiny_{len(over)}.yaml"
    path.write_text(yaml.safe_dump(keys))
    return str(path)


def _run(root, run, argv, sigterm=()):
    """Two ranks of train.main (`sigterm`: (rank, step) of a SIGTERM);
    returns their logs ("" where none) and the launcher's error or None."""
    logs = root / f"logs_{run}"
    logs.mkdir()
    error = None
    try:
        dryrun.run_ranks(_worker().main_rank, WORLD, (argv, str(logs), *sigterm),
                         store=str(root / f"store_{run}"), timeout=RANK_TIMEOUT)
    except RuntimeError as exc:
        error = exc
    texts = [(logs / f"rank{r}.log").read_text() if (logs / f"rank{r}.log").exists() else ""
             for r in range(WORLD)]
    return texts, error


def _loss_lines(text):
    return [line for line in text.splitlines() if line.startswith(("steps:", "lossD:"))]


def test_two_rank_main_sigterm_resume_and_group_batch(tmp_path):
    """`train.main --use_mGPU --device cpu` as two gloo ranks under
    torchrun's variables: only rank 0 writes the run directory; a SIGTERM
    to rank 1 stops both ranks at the same step with a checkpoint; the
    resume ends bit for bit where the uninterrupted run ended, with the same
    loss lines; a per-rank batch that is not a multiple of the
    minibatch-stddev group raises."""
    total = 3
    config = _tiny_config(tmp_path)
    base = ["--config", config, "--max_step", str(total), "--device", "cpu", "--use_mGPU"]
    with ThreadPoolExecutor(2) as pool:
        full = pool.submit(_run, tmp_path, "full", ["full"] + base)
        cut = pool.submit(_run, tmp_path, "cut", ["cut"] + base, sigterm=(1, 1))
        (full_logs, full_error), (cut_logs, cut_error) = full.result(), cut.result()
    assert full_error is None and cut_error is None, (full_logs, cut_logs)
    with ThreadPoolExecutor(2) as pool:
        resume = pool.submit(_run, tmp_path, "resume", ["cut", "--ckpt_id", "cut"] + base)
        odd = pool.submit(_run, tmp_path, "odd", ["odd", "--config", _tiny_config(
            tmp_path, batch_per_gpu=2), "--max_step", "1", "--device", "cpu", "--use_mGPU"])
        (resume_logs, resume_error), (odd_logs, odd_error) = resume.result(), odd.result()
    assert resume_error is None, resume_logs

    for r, text in enumerate(full_logs):
        assert f"process group: gloo, world {WORLD}, rank {r}, device cpu" in text
        assert f"rank {r} stopped at step {total}" in text
    # rank 0 alone writes: rank 1 refuses every write and prints no loss line
    run_dir = tmp_path / "full"
    assert sorted(os.listdir(run_dir)) == ["ckpt", "config_full.yaml", "imgs", "metrics.jsonl"]
    assert sorted(os.listdir(run_dir / "imgs")) == ["e0.jpg", "e2.jpg"]
    assert len((run_dir / "metrics.jsonl").read_text().splitlines()) == total
    assert _loss_lines(full_logs[1]) == [] and len(_loss_lines(full_logs[0])) == 2 * total
    # SIGTERM on rank 1 during step 1: both stop at step 2, rank 0 checkpoints there
    for r in range(WORLD):
        assert f"rank {r} stopped at step 2" in cut_logs[r]
    assert "interrupted at step 2" in cut_logs[0]
    assert sorted(os.path.basename(p) for p in glob.glob(
        str(tmp_path / "cut" / "ckpt" / "G_[0-9]*.npz"))) == ["G_2.npz", f"G_{total}.npz"]
    assert _loss_lines(cut_logs[0]) + _loss_lines(resume_logs[0]) == _loss_lines(full_logs[0])
    for name in ("G", "D"):
        want = port_ckpt.load_checkpoint(str(tmp_path), "full", name, total)
        got = port_ckpt.load_checkpoint(str(tmp_path), "cut", name, total)
        for w, g in zip(want[:2], got[:2]):
            assert set(w) == set(g)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=f"{name} {key}")
        assert got[2]["torch_rng"] == want[2]["torch_rng"]
    # per-rank batch 2 with a minibatch-stddev group of 4
    assert odd_error is not None
    for text in odd_logs:
        assert "not a multiple of the minibatch-stddev group" in text


def test_dryrun_multichip():
    dryrun.dryrun_multichip(WORLD, timeout=RANK_TIMEOUT)
