"""The port's sampler on checkpoints the JAX package wrote, and the port's
import hygiene."""

import ast
import os
import pathlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import demo as jax_demo
from pggan_tpu.config import Config as JaxConfig
from pggan_tpu.models.generator import init_generator_params
from pggan_tpu.utils import checkpoint as jax_ckpt
from pggan_tpu_torch import demo, export, params_to_jax
from pggan_tpu_torch.utils import checkpoint as port_ckpt

REPO = pathlib.Path(__file__).resolve().parents[1]
ARGS = {"latent_dim": 32, "depths": [32, 32, 16], "seed": 11,
        "init_bias_to_zero": False}
SCALE = 2


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A G checkpoint written by the JAX package's save_checkpoint."""
    root = tmp_path_factory.mktemp("ckpt")
    args = JaxConfig(ARGS).to_dict()
    params = init_generator_params(
        jax.random.fold_in(jax.random.PRNGKey(ARGS["seed"]), 0),
        latent_dim=ARGS["latent_dim"], depths=ARGS["depths"], scale=SCALE,
        init_bias_to_zero=False)
    jax_ckpt.save_checkpoint(str(root), "run", "G", 7, params=params, meta={
        "args": args, "schedule": {"scale_index": SCALE, "alpha": 0.5}})
    return str(root)


def test_demo_samples_jax_checkpoint(jax_run, tmp_path, capsys):
    out = tmp_path / "samples"
    rc = demo.main(["--ckpt_id", "run", "--save_root", jax_run, "--device", "cpu",
                    "--n_samples", "5", "--batch_size", "2",
                    "--output_dir", str(out)])
    assert rc == 0
    files = sorted(os.listdir(out))
    assert files == [f"result_{i}.jpg" for i in range(5)]
    for name in files:
        with Image.open(out / name) as img:
            assert img.size == (16, 16) and img.mode == "RGB"
    assert "wrote 5 samples at 16x16" in capsys.readouterr().out


def test_loaded_params_equal_jax_demo(jax_run):
    port, args, scale, alpha = demo.load_generator(jax_run, "run", 7, device="cpu")
    jax_params, *_ = jax_demo.load_generator(JaxConfig(
        {"ckpt_id": "run", "ckpt_step": 7, "save_root": jax_run}))
    want = jax_ckpt.tree_to_arrays(jax_params)
    got = params_to_jax(port)
    assert (scale, alpha, args.latent_dim) == (SCALE, 0.5, ARGS["latent_dim"])
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_strict_key_check(jax_run, tmp_path):
    arrays, _, meta = port_ckpt.load_checkpoint(jax_run, "run", "G")
    del arrays["blocks/1/conv1/b"]
    port_ckpt.save_checkpoint(str(tmp_path), "bad", "G", 1, params=arrays, meta=meta)
    with pytest.raises(KeyError, match="blocks/1/conv1/b"):
        demo.load_generator(str(tmp_path), "bad", device="cpu")
    with pytest.raises(FileNotFoundError):
        demo.load_generator(str(tmp_path), "absent", device="cpu")


def test_port_checkpoint_loads_in_jax(jax_run, tmp_path):
    arrays, _, meta = port_ckpt.load_checkpoint(jax_run, "run", "G", 7)
    port_ckpt.save_checkpoint(str(tmp_path), "copy", "G", 9, params=arrays, meta=meta)
    back, _, back_meta = jax_ckpt.load_checkpoint(str(tmp_path), "copy", "G")
    assert back_meta["global_step"] == 9 and back_meta["schedule"] == meta["schedule"]
    assert set(back) == set(arrays)
    for key in arrays:
        np.testing.assert_array_equal(back[key], arrays[key])


def test_export_is_not_ported(jax_run, tmp_path, capsys):
    """`--export PATH` (which once raised) writes the serving artifact of
    the loaded G, which `export.sample` reads, and then samples as before."""
    path, out = tmp_path / "g.pt2", tmp_path / "samples"
    rc = demo.main(["--ckpt_id", "run", "--save_root", jax_run, "--device", "cpu",
                    "--n_samples", "2", "--output_dir", str(out), "--export", str(path)])
    assert rc == 0 and sorted(os.listdir(out)) == ["result_0.jpg", "result_1.jpg"]
    assert f"wrote serving artifact (scale {SCALE}, alpha 0.5) to {path}" in capsys.readouterr().out
    z = np.random.RandomState(0).randn(3, ARGS["latent_dim"])
    images = export.sample(str(path), z)
    assert images.dtype == np.uint8 and images.shape == (3, 16, 16, 3)


def test_demo_export_takes_the_checkpoint_settings(jax_run, tmp_path):
    """The artifact is G with the checkpoint's alpha, slope, pixel norm and
    last activation, in f32: it equals the loaded G's forward."""
    arrays, _, meta = port_ckpt.load_checkpoint(jax_run, "run", "G", 7)
    meta["args"].update(LReLU_slope=0.1, generator_last_activation="tanh")
    meta["schedule"]["alpha"] = 0.25
    port_ckpt.save_checkpoint(str(tmp_path), "tanh", "G", 7, params=arrays, meta=meta)
    path = tmp_path / "g.pt2"
    assert demo.main(["--ckpt_id", "tanh", "--save_root", str(tmp_path), "--device", "cpu",
                      "--n_samples", "1", "--export", str(path)]) == 0
    generator, _, _, alpha = demo.load_generator(str(tmp_path), "tanh", device="cpu")
    assert (alpha, generator.slope, generator.last_activation) == (0.25, 0.1, "tanh")
    z = torch.from_numpy(np.random.RandomState(1).randn(2, ARGS["latent_dim"]).astype(np.float32))
    with torch.no_grad():
        want = generator(z, alpha)
        got = export.load_exported(str(path)).module()(z)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """No module of the port, and none of its card-side scripts, imports
    JAX or the JAX package, anywhere in the file (functions included)."""
    files = sorted((REPO / "pggan_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tools" / "profile_torch_step.py",
        REPO / "tools" / "time_row_kernels.py", REPO / "tools" / "bench_serving_torch.py",
        REPO / "tools" / "probe_device_ms.py", REPO / "tests" / "torch_rank_worker.py",
        REPO / "tools" / "bench_e2e_torch.py", REPO / "tools" / "bench_pipeline_torch.py",
        REPO / "tools" / "train_watchdog_torch.py"]
    port = REPO / "pggan_tpu_torch"
    assert {port / "models" / "torch_port.py", port / "import_ckpt.py",
            port / "parallel" / "__init__.py", port / "parallel" / "mesh.py",
            port / "parallel" / "dryrun.py", port / "utils" / "stats.py",
            port / "losses" / "gan.py", port / "native" / "__init__.py",
            port / "native" / "build.py", port / "native" / "loader.py",
            port / "data" / "grain_pipeline.py", port / "train" / "graphs.py",
            port / "utils" / "debug.py", port / "models" / "backbones.py",
            port / "models" / "zoo.py", port / "models" / "face3d.py",
            port / "models" / "e4e.py", port / "models" / "faceparser.py",
            port / "losses" / "perceptual.py"} <= set(files)
    banned = []
    for path in files:
        for module in _imported_modules(path):
            root = module.split(".")[0]
            if root in ("jax", "jaxlib", "pggan_tpu"):
                banned.append(f"{path.relative_to(REPO)}: {module}")
    assert banned == []
