"""Reference-checkpoint import in the port (`pggan_tpu_torch/models/
torch_port.py`, `pggan_tpu_torch/import_ckpt.py`) against the JAX package's
(`pggan_tpu/models/torch_port.py`, `tools/import_torch_ckpt.py`).

The reference state_dicts and the independent torch-functional forward are
`tests/test_torch_port.py`'s. The port maps the reference's keys onto its
own modules without transposing anything, so a converted network written
with `params_to_jax` must equal JAX's converter array for array; the two
import tools must write the same npz checkpoints (keys, arrays, meta); the
imported G must equal JAX `generator_apply` and the reference forward
(f32, 1e-5, as tests/test_torch_generator.py holds the G); and the port's
trainer must resume the import.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import test_torch_port as ref
from pggan_tpu.models import generator_apply, init_generator_params
from pggan_tpu.models import torch_port as jax_port
from pggan_tpu.utils import checkpoint as jax_ckpt
from pggan_tpu_torch import demo
from pggan_tpu_torch import train as port_train
from pggan_tpu_torch import import_ckpt
from pggan_tpu_torch.models import torch_port
from pggan_tpu_torch.models.discriminator import Discriminator
from pggan_tpu_torch.models.generator import Generator
from pggan_tpu_torch.ops.equalized import params_to_jax
from pggan_tpu_torch.utils import checkpoint as port_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# scale 1: a grown block and its fade, and few programs for the JAX tool to compile
SCALE, STEP, ALPHA = 1, 1500, 0.5
FWD_TOL = dict(rtol=1e-5, atol=1e-5)


def _load(net, arrays):
    net.load_state_dict({k: torch.from_numpy(v) for k, v in arrays.items()}, strict=True)
    return net


@pytest.mark.parametrize("scale", [0, 1, 2])
@pytest.mark.parametrize("norm", [True, False], ids=["norm", "no_norm"])
def test_converters_match_jax(scale, norm):
    """G with and without PixelNorm's interleaved indices, D with and
    without the minibatch-stddev channel: the port's state_dict, loaded
    strictly, is JAX's converted arrays in the JAX layouts, and holds the
    reference's tensors untransposed."""
    rng = np.random.default_rng(31 + scale)
    sd_g = ref.make_g_state_dict(rng, scale, apply_pixel_norm=norm)
    sd_d = ref.make_d_state_dict(rng, scale, minibatch_norm=norm)
    G = _load(Generator(latent_dim=ref.LATENT, depths=ref.DEPTHS, scale=scale),
              torch_port.convert_generator_state_dict(sd_g))
    D = _load(Discriminator(depths=ref.DEPTHS, scale=scale, apply_minibatch_norm=norm),
              torch_port.convert_discriminator_state_dict(sd_d))
    for net, want in ((G, jax_port.convert_generator_state_dict(sd_g)),
                      (D, jax_port.convert_discriminator_state_dict(sd_d))):
        got = params_to_jax(net)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype == np.float32, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    j1 = 3 if norm else 2
    if scale:
        torch.testing.assert_close(G.blocks[0].conv1.weight.data,
                                   sd_g[f"blocks.0.block.{j1}.module.weight"], rtol=0, atol=0)
    torch.testing.assert_close(D.last_linear.weight.data,
                               sd_d["minibatch_normalization_block.linear.module.weight"],
                               rtol=0, atol=0)
    # without equalized learning rate every He constant is 1, as in JAX
    plain = torch_port.convert_generator_state_dict(sd_g, equalized_lr=False)
    want = jax_port.convert_generator_state_dict(sd_g, equalized_lr=False)
    assert {k: float(v) for k, v in plain.items() if k.endswith(".scale")} == {
        k.replace("/scale", ".scale").replace("/", "."): float(v)
        for k, v in want.items() if k.endswith("/scale")}


def test_foreign_keys_and_schedule_meta():
    rng = np.random.default_rng(3)
    for convert, sd in ((torch_port.convert_generator_state_dict, ref.make_g_state_dict(rng, 1)),
                        (torch_port.convert_discriminator_state_dict,
                         ref.make_d_state_dict(rng, 1))):
        sd["blocks.0.block.1.running_mean"] = ref._t(rng, 4)
        with pytest.raises(KeyError, match="unrecognized"):
            convert(sd)
    sd = ref.make_g_state_dict(rng, 1)
    del sd["toRGB_blocks.1.toRGB.module.bias"], sd["toRGB_blocks.1.toRGB.module.weight"]
    with pytest.raises(KeyError, match="toRGB count"):
        torch_port.convert_generator_state_dict(sd)
    ckpt = {"alpha_G": 0.25, "alpha_D": 0.25, "alpha_index": 3, "alpha_jump_value": 0.01,
            "next_alpha_jump_step": 1234, "scale_index": 2, "next_scale_jump_step": 7000}
    assert torch_port.reference_schedule_meta(ckpt) == jax_port.reference_schedule_meta(ckpt)
    with pytest.raises(ValueError, match="alpha_G"):
        torch_port.reference_schedule_meta({**ckpt, "alpha_D": 0.5})


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """Reference G/D `.pt` files at scale 2 (with the weight average on),
    imported by `python -m pggan_tpu_torch.import_ckpt` (a child process,
    started first) and by the JAX tool's `main`, each run from its own
    directory with the same relative --save_root, so the configs they
    write into `meta` are the same."""
    root = tmp_path_factory.mktemp("import")
    rng = np.random.default_rng(11)
    sd_g, sd_d = ref.make_g_state_dict(rng, SCALE), ref.make_d_state_dict(rng, SCALE)
    common = {
        "args": {"latent_dim": ref.LATENT, "depths": ref.DEPTHS, "input_dim": 3,
                 "batch_per_gpu": 4, "save_root": "train_result", "run_id": "ref_run",
                 "g_ema_decay": 0.999, "lr_D": 2e-5, "not_a_key": 1},
        "global_step": STEP, "alpha_G": ALPHA, "alpha_D": ALPHA, "alpha_index": 5,
        "alpha_jump_value": 0.01, "next_alpha_jump_step": 2000, "scale_index": SCALE,
        "next_scale_jump_step": 30000,
    }
    g_path, d_path = root / f"G_{STEP}.pt", root / f"D_{STEP}.pt"
    torch.save({**common, "model": sd_g, "optimizer": {}}, g_path)
    torch.save({**common, "model": sd_d, "optimizer": {}}, d_path)
    args = ["--g", str(g_path), "--d", str(d_path), "--run_id", "migrated",
            "--save_root", "runs"]
    for side in ("port", "jax"):
        os.makedirs(root / side)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    child = subprocess.Popen([sys.executable, "-m", "pggan_tpu_torch.import_ckpt", *args],
                             cwd=root / "port", env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    cwd = os.getcwd()
    try:
        spec = importlib.util.spec_from_file_location(
            "import_torch_ckpt", os.path.join(REPO, "tools", "import_torch_ckpt.py"))
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        os.chdir(root / "jax")
        tool.main(args + ["--platform", ""])
        out, _ = child.communicate(timeout=120)
    finally:
        os.chdir(cwd)
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, out
    assert "Gema: seeded from the imported G" in out
    return root, sd_g, g_path, d_path


def test_import_writes_the_jax_tools_checkpoints(imported):
    root, _, _, _ = imported
    port_root, jax_root = str(root / "port" / "runs"), str(root / "jax" / "runs")
    port_dir, jax_dir = (port_ckpt.ckpt_dir(r, "migrated") for r in (port_root, jax_root))
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    for name in ("G", "D", "Gema"):
        with np.load(os.path.join(port_dir, f"{name}_{STEP}.npz")) as got, \
                np.load(os.path.join(jax_dir, f"{name}_{STEP}.npz")) as want:
            assert set(got.files) == set(want.files)
            assert any(k.startswith("opt/") for k in want.files) == (name != "Gema")
            for key in want.files:
                if key == "__meta__":
                    continue
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
        meta = port_ckpt.load_checkpoint(port_root, "migrated", name)[2]
        assert meta == jax_ckpt.load_checkpoint(jax_root, "migrated", name)[2]
        assert meta["args"]["lr_D"] == 2e-5 and "not_a_key" not in meta["args"]
        assert meta["schedule"]["alpha"] == ALPHA and meta["global_step"] == STEP


def test_import_refuses_a_step_mismatch(imported, tmp_path):
    root, _, g_path, d_path = imported
    d_dict = torch.load(d_path, weights_only=False)
    d_dict["global_step"] = STEP + 1
    torch.save(d_dict, tmp_path / "D.pt")
    with pytest.raises(SystemExit, match="refusing"):
        import_ckpt.main(["--g", str(g_path), "--d", str(tmp_path / "D.pt"), "--run_id", "x",
                          "--save_root", str(tmp_path)])


def test_imported_generator_matches_jax_and_reference(imported):
    root, sd_g, _, _ = imported
    G, _, scale, alpha = demo.load_generator(str(root / "port" / "runs"), "migrated",
                                             device="cpu")
    assert (scale, alpha) == (SCALE, ALPHA)
    z = np.random.default_rng(2).standard_normal((2, ref.LATENT)).astype(np.float32)
    with torch.no_grad():
        got = G(torch.from_numpy(z), alpha).numpy()
        golden = ref.torch_generator_forward(sd_g, torch.from_numpy(z), alpha, scale).numpy()
    arrays = jax_ckpt.load_checkpoint(str(root / "jax" / "runs"), "migrated", "G")[0]
    template = init_generator_params(jax.random.PRNGKey(0), latent_dim=ref.LATENT,
                                     depths=ref.DEPTHS, scale=SCALE)
    params = jax_ckpt.arrays_to_tree(template, arrays, strict=True)
    want = np.asarray(generator_apply(params, jnp.asarray(z), jnp.float32(alpha)))
    np.testing.assert_allclose(got, want, **FWD_TOL)
    np.testing.assert_allclose(got, np.transpose(golden, (0, 2, 3, 1)), **FWD_TOL)


def test_trainer_resumes_the_import(imported, tmp_path, capsys):
    """One step of `pggan_tpu_torch.train.main` on the CPU from the import:
    the imported schedule and weights restored, G and D moved, Adam at 1."""
    root, _, _, _ = imported
    save_root = str(root / "port" / "runs")
    config = tmp_path / "resume.yaml"
    config.write_text(yaml.safe_dump({"save_root": save_root, "data_backend": "synthetic",
                                      "synthetic_dataset_size": 16, "loss_cycle": 1,
                                      "num_data_workers": 1}))
    rc = port_train.main(["resumed", "--config", str(config), "--ckpt_id", "migrated",
                          "--max_step", str(STEP + 1), "--device", "cpu"])
    assert rc == 0
    assert f"checkpoint migrated@{STEP} restored (scale={SCALE}, alpha={ALPHA})" in \
        capsys.readouterr().out
    for name in ("G", "D"):
        before = port_ckpt.load_checkpoint(save_root, "migrated", name)[0]
        params, opt, meta = port_ckpt.load_checkpoint(save_root, "resumed", name, STEP + 1)
        assert int(opt["0/count"]) == 1 and meta["schedule"]["scale_index"] == SCALE
        assert any(not np.array_equal(params[k], before[k]) for k in before
                   if not k.endswith("/scale"))
