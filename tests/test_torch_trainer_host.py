"""The port's trainer as a user runs it, on the CPU: `python -m
pggan_tpu_torch.train` (in process) on a folder of images, the run
directory it leaves (metrics.jsonl with the JAX trainer's keys, the sample
grids, the config snapshot), SIGTERM mid-run and the exact resume,
asynchronous checkpoints against in-place updates, which config keys count
as set (against the JAX package's Config), the model registry, and the
evaluation hooks (validation, FID and KID in the loop,
`python -m pggan_tpu_torch.eval_metrics`).

Nothing here compiles a JAX program: the JAX side is its config, its
metrics logger and its checkpoint reader.
"""

import contextlib
import glob
import io
import json
import os
import signal
import threading

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from pggan_tpu import Config as JaxConfig
from pggan_tpu.utils import checkpoint as jax_ckpt
from pggan_tpu.utils.logging import MetricLogger as JaxMetricLogger
from pggan_tpu_torch import registry
from pggan_tpu_torch import train as port_train
from pggan_tpu_torch.config import Config
from pggan_tpu_torch.ops.equalized import adam_state_to_jax, params_to_jax
from pggan_tpu_torch.train.trainer import RNG_META_KEY, ProgressiveGANTrainer
from pggan_tpu_torch.utils import checkpoint as port_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOTAL, CUT = 8, 4          # steps of a run; SIGTERM after step CUT
STEP_KEYS = {"L_D", "L_D_real", "L_D_fake", "L_D_r1", "L_G"}    # JAX's r1 step


def _keys(save_root, image_root, **over):
    """A tiny model on folder data: scale 0 (4×4) for 3 steps, then 8×8."""
    return {"latent_dim": 16, "depths": [16, 8], "batch_per_gpu": 4,
            "save_root": str(save_root), "data_backend": "folder",
            "dataset_root_list": [str(image_root)], "num_data_workers": 2,
            "loss_cycle": 2, "test_cycle": 4, "ckpt_cycle": 100,
            "max_step_at_scale": [3, 100], "alpha_jump_start": [-1, 1],
            "alpha_jump_interval": [0, 2], "alpha_jump_Ntimes": [0, 4], **over}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A folder of 12 JPEG/PNG images in two directories, the YAML config
    and an uninterrupted TOTAL-step run "full" through the entry point."""
    root = tmp_path_factory.mktemp("host")
    rs = np.random.RandomState(1)
    for i in range(12):
        sub = root / "images" / ("x" if i % 2 else "y/z")
        os.makedirs(sub, exist_ok=True)
        arr = rs.randint(0, 256, (rs.randint(16, 25), rs.randint(16, 25), 3), dtype=np.uint8)
        Image.fromarray(arr).save(sub / f"{i}.{'jpg' if i % 3 else 'png'}")
    config = root / "tiny.yaml"
    config.write_text(yaml.safe_dump(_keys(root / "runs", root / "images")))
    rc = port_train.main(["full", "--config", str(config), "--max_step", str(TOTAL),
                          "--device", "cpu"])
    assert rc == 0
    return root, str(config)


def test_analyze_run_reads_the_port_run(workdir):
    """`tools/analyze_run.py --json` (a tool without a framework) digests
    the port's run directory as a JAX run's: its loss records with
    imgs_per_sec, per stage of the config snapshot's schedule (the rate of
    a scale's first loss line after a jump is not logged)."""
    import subprocess
    import sys

    root, _ = workdir
    done = subprocess.run([sys.executable, os.path.join(REPO, "tools", "analyze_run.py"),
                           str(root / "runs" / "full"), "--json"],
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    doc = json.loads(done.stdout.splitlines()[-1])
    assert doc["run"] == "full" and doc["last_step"] == 6
    assert [(s["resolution"], s["last_step_seen"]) for s in doc["stages"]] == [(4, 2), (8, 6)]
    assert all(s["median_imgs_per_sec"] > 0 for s in doc["stages"])
    assert doc["fid"] == [] and doc["val"] == []


def _checkpoint(root, run, step):
    """{net: (params, opt, meta)} of a run's checkpoint at `step`."""
    return {name: port_ckpt.load_checkpoint(str(root / "runs"), run, name, step)
            for name in ("G", "D")}


def test_main_writes_the_run_directory(workdir):
    root, config = workdir
    run_dir = root / "runs" / "full"
    lines = [yaml.safe_load(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [line["step"] for line in lines] == list(range(0, TOTAL, 2))
    theirs = JaxMetricLogger(str(root / "jax_log"), "j")
    for line in lines:
        theirs.log(line["step"], {k: v for k, v in line.items() if k not in ("step", "time")})
    theirs.close()
    jax_lines = [yaml.safe_load(line) for line in
                 (root / "jax_log" / "j" / "metrics.jsonl").read_text().splitlines()]
    for i, (line, jax_line) in enumerate(zip(lines, jax_lines)):
        assert set(line) == set(jax_line)
        want = {"step", "time"} | STEP_KEYS | ({"imgs_per_sec"} if i else set())
        assert set(line) == want and all(np.isfinite(v) for v in line.values())
    # the [real, fake] grid: 2 rows of 4 images, 2 px apart and around
    for step, res in ((0, 4), (4, 8)):
        grid = np.asarray(Image.open(run_dir / "imgs" / f"e{step}.jpg"))
        assert grid.shape == (2 * (res + 4), 4 * (res + 2) + 2, 3)
    assert sorted(os.listdir(run_dir / "imgs")) == ["e0.jpg", "e4.jpg"]
    # the config snapshot: the YAML with the run's command-line keys
    snapshot = Config.from_yaml(str(run_dir / "config_full.yaml"))
    want = Config.from_yaml(config)
    want.update(run_id="full", max_step=TOTAL)
    assert dict(snapshot) == dict(want)
    # checkpoints the JAX package reads, with the latent generator's state
    params, opt, meta = jax_ckpt.load_checkpoint(str(root / "runs"), "full", "G", TOTAL)
    assert meta["global_step"] == TOTAL and meta["schedule"]["scale_index"] == 1
    assert "rng" not in meta and meta[RNG_META_KEY]["device"] == "cpu"
    assert set(opt) == {"0/count"} | {f"0/{m}/{k}" for m in ("mu", "nu") for k in params}


def test_sigterm_checkpoints_and_the_resume_is_exact(workdir, monkeypatch, capsys):
    """SIGTERM after step CUT: a checkpoint at CUT + 1, a clean return and
    the previous handler back; the resume for the remaining steps ends bit
    for bit where the uninterrupted run ended (G, D, Adam, the latents'
    generator)."""
    root, config = workdir
    assert threading.current_thread() is threading.main_thread()
    step_once = ProgressiveGANTrainer.train_step

    def train_step(self):
        images = step_once(self)
        if self.global_step == CUT:
            os.kill(os.getpid(), signal.SIGTERM)
        return images
    monkeypatch.setattr(ProgressiveGANTrainer, "train_step", train_step)
    before = signal.getsignal(signal.SIGTERM)
    rc = port_train.main(["cut", "--config", config, "--max_step", str(TOTAL),
                          "--device", "cpu"])
    assert rc == 0 and signal.getsignal(signal.SIGTERM) is before
    assert f"interrupted at step {CUT + 1}" in capsys.readouterr().out
    assert sorted(glob.glob(str(root / "runs" / "cut" / "ckpt" / "G_[0-9]*.npz"))) == [
        str(root / "runs" / "cut" / "ckpt" / f"G_{CUT + 1}.npz")]

    monkeypatch.setattr(ProgressiveGANTrainer, "train_step", step_once)
    rc = port_train.main(["cut", "--config", config, "--ckpt_id", "cut", "--max_step",
                          str(TOTAL), "--device", "cpu"])
    assert rc == 0
    assert f"checkpoint cut@{CUT + 1} restored" in capsys.readouterr().out
    full, resumed = _checkpoint(root, "full", TOTAL), _checkpoint(root, "cut", TOTAL)
    for name in ("G", "D"):
        for want, got in zip(full[name][:2], resumed[name][:2]):
            assert set(want) == set(got)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
        assert resumed[name][2][RNG_META_KEY] == full[name][2][RNG_META_KEY]
        assert resumed[name][2]["schedule"] == full[name][2]["schedule"]


def test_async_checkpoint_holds_the_state_at_its_step(workdir, monkeypatch):
    """The writer is held until two more steps have updated the weights and
    Adam's moments in place; the files still hold the state at the save."""
    root, _ = workdir
    cfg = Config(_keys(root / "async", root / "images", run_id="a"))
    trainer = ProgressiveGANTrainer(cfg, device="cpu").setup()
    try:
        trainer.fit(max_step=2)
        want = {net: (params_to_jax(m), adam_state_to_jax(o, m)) for net, m, o in
                (("G", trainer.state.G, trainer.state.opt_G),
                 ("D", trainer.state.D, trainer.state.opt_D))}
        release, write = threading.Event(), port_ckpt.save_checkpoint

        def held_write(*args, **kwargs):
            assert release.wait(30)
            return write(*args, **kwargs)
        monkeypatch.setattr(port_ckpt, "save_checkpoint", held_write)
        trainer.save_checkpoint(2)
        for _ in range(2):
            trainer.train_step()
        moved = params_to_jax(trainer.state.G)
        release.set()
        trainer.save_checkpoint(4, wait=True)
    finally:
        trainer.close()
    assert any(not np.array_equal(moved[k], want["G"][0][k]) for k in moved)
    for name, (params, opt) in want.items():
        saved_params, saved_opt, meta = port_ckpt.load_checkpoint(
            str(root / "async"), "a", name, 2)
        assert meta["global_step"] == 2
        for mine, theirs in ((saved_params, params), (saved_opt, opt)):
            for key in theirs:
                np.testing.assert_array_equal(mine[key], theirs[key], err_msg=key)


def test_failed_checkpoint_write_raises_at_the_next_save(workdir, monkeypatch):
    root, _ = workdir
    cfg = Config(_keys(root / "fail", root / "images", run_id="f"))
    trainer = ProgressiveGANTrainer(cfg, device="cpu").setup()

    def broken(*args, **kwargs):
        raise OSError("disk full")
    monkeypatch.setattr(port_ckpt, "save_checkpoint", broken)
    try:
        trainer.save_checkpoint(0)
        with pytest.raises(OSError, match="disk full"):
            trainer.save_checkpoint(0)
    finally:
        trainer.close()


CONFIG_FILES = ["configs.yaml"] + sorted(
    os.path.join("configs", f) for f in os.listdir(os.path.join(REPO, "configs"))
    if f.endswith(".yaml"))


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_config_keys_set_by_the_user_match_jax(name, tmp_path):
    """Both packages load the file to the same values and count the same
    keys as set; `save_yaml` writes a snapshot that reloads to them."""
    path = os.path.join(REPO, name)
    ours, theirs = Config.from_yaml(path), JaxConfig.from_yaml(path)
    assert ours.explicit_keys() == theirs.explicit_keys()
    assert dict(ours) == theirs.to_dict()
    ours.update(run_id="snap", save_root=str(tmp_path))
    snapshot = ours.save_yaml()
    assert snapshot == os.path.join(str(tmp_path), "snap", "config_snap.yaml")
    assert dict(Config.from_yaml(snapshot)) == dict(ours)
    assert JaxConfig.from_yaml(snapshot).to_dict() == dict(ours)


def test_registry_dispatches_pggan(tmp_path):
    keys = {"latent_dim": 16, "depths": [16, 8], "batch_per_gpu": 4,
            "save_root": str(tmp_path), "synthetic_dataset_size": 8, "num_data_workers": 1}
    trainer = registry.create_model(Config(keys), device="cpu")
    try:
        assert isinstance(trainer, ProgressiveGANTrainer) and trainer.state is not None
        assert next(trainer._pipeline).shape == (4, 4, 4, 3)
    finally:
        trainer.close()
    with pytest.raises(KeyError, match="stylegan"):
        registry.create_model(Config(dict(keys, model_id="stylegan")), device="cpu")


# ---- validation, FID and KID (the JAX trainer's evaluation hooks) -----------

EVAL_TOTAL, FID_STEP = 8, 7        # the last FID at step 7 = checkpoint 8's state
VAL_KEYS = {"val_D_real", "val_D_fake", "val_L_D", "val_L_G", "valid_D_real"}


def _eval_keys(save_root, **over):
    """A tiny model on synthetic data: scale 0 (4×4) for 4 steps, then 8×8
    with an alpha fade; validation every 2 steps, FID/KID at step 7."""
    return {"latent_dim": 16, "depths": [16, 8], "batch_per_gpu": 8,
            "save_root": str(save_root), "data_backend": "synthetic",
            "synthetic_dataset_size": 64, "num_data_workers": 2, "loss_cycle": 2,
            "test_cycle": 2, "ckpt_cycle": 100, "max_step_at_scale": [4, 100],
            "alpha_jump_start": [-1, 1], "alpha_jump_interval": [0, 1],
            "alpha_jump_Ntimes": [0, 3], "use_validation": True, "val_batches": 2,
            "fid_cycle": FID_STEP, "fid_samples": 16, "g_ema_decay": 0.9, **over}


@pytest.fixture(scope="module")
def eval_run(tmp_path_factory):
    """`python -m pggan_tpu_torch.train` (in process) for EVAL_TOTAL steps
    with validation and FID on, the validation forward's arguments
    recorded. Returns (root, metrics.jsonl records, calls, output)."""
    from pggan_tpu_torch.train import trainer as trainer_mod

    root = tmp_path_factory.mktemp("eval")
    config = root / "eval.yaml"
    config.write_text(yaml.safe_dump(_eval_keys(root)))
    calls, forward = [], trainer_mod.eval_losses

    def recording(G, D, real, z, alpha, **kw):
        calls.append((G.resolution, tuple(real.shape), real.dtype, kw))
        return forward(G, D, real, z, alpha, **kw)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(trainer_mod, "eval_losses", recording)
        rc = port_train.main(["ev", "--config", str(config), "--max_step", str(EVAL_TOTAL),
                              "--device", "cpu", "--compute_dtype", "bfloat16"])
    assert rc == 0
    records = [yaml.safe_load(line) for line in
               (root / "ev" / "metrics.jsonl").read_text().splitlines()]
    return root, records, calls, out.getvalue()


def test_validation_logs_both_sides_across_a_scale_jump(eval_run):
    """`val_*` (and the legacy `valid_D_real`) every test_cycle step, before
    and after the jump at step 4: finite, strictly positive BCE losses (the
    fake side and the losses were evaluated), val_batches forwards each in
    the run's dtype, the reals faded exactly at scale 1."""
    _, records, calls, _ = eval_run
    val = [r for r in records if "val_L_D" in r]
    assert [r["step"] for r in val] == [0, 2, 4, 6]
    for r in val:
        assert set(r) == {"step", "time"} | VAL_KEYS
        assert all(np.isfinite(r[k]) for k in VAL_KEYS)
        assert r["val_L_D"] > 0 and r["val_L_G"] > 0 and r["valid_D_real"] == r["val_D_real"]
    assert len(calls) == 2 * len(val)
    for res, shape, dtype, kw in calls:
        assert shape == (8, res, res, 3) and dtype == torch.uint8
        assert kw == {"w_adv": 1.0, "fade_real": res == 8, "compute_dtype": torch.bfloat16}
    assert {res for res, *_ in calls} == {4, 8}


def test_fid_cycle_logs_fid_and_kid_and_eval_metrics_agrees(eval_run, capsys):
    """`fid`, `kid`, `kid_std` at the fid_cycle step, printed as the JAX
    trainer prints them; `python -m pggan_tpu_torch.eval_metrics` on the
    final checkpoint (the state the step-7 metrics saw) prints one JSON line
    with the JAX tool's keys and the same values (rtol 1e-6: the same f32
    features on the CPU)."""
    from pggan_tpu_torch import eval_metrics

    root, records, _, out = eval_run
    scores = [r for r in records if "fid" in r]
    assert [r["step"] for r in scores] == [FID_STEP]
    assert set(scores[0]) == {"step", "time", "fid", "kid", "kid_std"}
    assert all(np.isfinite(scores[0][k]) for k in ("fid", "kid", "kid_std"))
    assert scores[0]["fid"] >= 0 and f"step {FID_STEP}: FID = " in out
    rc = eval_metrics.main(["--ckpt_id", "ev", "--save_root", str(root), "--ckpt_step",
                            str(EVAL_TOTAL), "--device", "cpu"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"ckpt_id", "step", "scale", "resolution", "alpha", "extractor",
                         "num_samples", "ema", "fid", "kid", "kid_std"}
    assert (line["step"], line["scale"], line["resolution"]) == (EVAL_TOTAL, 1, 8)
    assert line["extractor"] == "random_conv" and line["num_samples"] == 16 and line["ema"]
    for key in ("fid", "kid", "kid_std"):
        np.testing.assert_allclose(line[key], scores[0][key], rtol=1e-6, atol=1e-12,
                                   err_msg=key)


def test_compute_fid_uses_each_real_at_most_once(tmp_path, monkeypatch):
    """With fewer held-out reals (12 of 40) than samples (48), every real
    enters the features once and all 48 fakes do; KID's subsets then
    resample (std > 0). compute_fid gives a finite, non-negative FID."""
    from pggan_tpu_torch.train import trainer as trainer_mod

    sizes, extract = [], trainer_mod.compute_activations

    def spy(batches, extractor, **kw):
        f = extract(batches, extractor, **kw)
        sizes.append(f.shape[0])
        return f
    monkeypatch.setattr(trainer_mod, "compute_activations", spy)
    trainer = ProgressiveGANTrainer(Config(_eval_keys(tmp_path, synthetic_dataset_size=40)),
                                    device="cpu").setup()
    try:
        assert len(trainer._valid_indices) == 12
        scores = trainer.compute_generative_metrics(num_samples=48)
        fid = trainer.compute_fid(num_samples=16)
    finally:
        trainer.close()
    assert sizes == [12, 48, 12, 16]
    assert np.isfinite(scores["kid"]) and scores["kid_std"] > 0
    assert np.isfinite(fid) and fid >= 0


def test_eval_metrics_without_a_card_exits_nonzero(tmp_path, capsys):
    from pggan_tpu_torch import eval_metrics

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    rc = eval_metrics.main(["--ckpt_id", "ev", "--save_root", str(tmp_path)])
    assert rc != 0 and "--device cpu" in capsys.readouterr().err
