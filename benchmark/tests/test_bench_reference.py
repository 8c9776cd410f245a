"""The plain reference against the port's plain path at a tiny size on the
CPU, in f32: G's and D's forwards, and whole training steps (every-step R1
and a lazy-R1 window) as a run's check reads them."""

import copy
import json
import os

import pytest
import torch

from benchmark import run, weights
from benchmark.reference import data as ref_data
from benchmark.reference import model as ref

MODEL = {"latent_dim": 16, "depths": [16, 16, 8, 8], "scale": 3, "init_bias_to_zero": True}


def _port_nets(alpha_scale=3):
    from pggan_tpu_torch.models.discriminator import Discriminator
    from pggan_tpu_torch.models.generator import Generator

    G = Generator(latent_dim=16, depths=MODEL["depths"], scale=alpha_scale)
    D = Discriminator(depths=MODEL["depths"], scale=alpha_scale)
    w = weights.make_weights(dict(MODEL, scale=alpha_scale), 5, "cpu")
    weights.load_into(G, w["G"])
    weights.load_into(D, w["D"])
    return G, D, w


@pytest.mark.parametrize("scale", [0, 1, 3])
@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_forwards_equal_the_port(scale, alpha):
    G, D, w = _port_nets(scale)
    z = torch.randn(8, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        img = G(z, alpha)
        want = ref.generator(w["G"], z, alpha, scale, 16)
        # f32 rounding: the fused upscale-conv sums its taps in another order
        torch.testing.assert_close(img, want, atol=1e-4, rtol=1e-4)
        logits = D(img, alpha)
        torch.testing.assert_close(logits, ref.discriminator(w["D"], img, alpha, scale),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("quant, low, high", [("tf32", 1e-5, 1e-2), ("fp8", 1e-3, 0.5)])
def test_fp8_control_moves_the_forward(quant, low, high):
    """Each control's rounding moves G's forward by about its format's
    relative step: TF32's 2^-11, fp8 e4m3's 2^-4."""
    _, _, w = _port_nets(3)
    z = torch.randn(8, 16, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        f32 = ref.generator(w["G"], z, 0.5, 3, 16)
        lower = ref.generator(w["G"], z, 0.5, 3, 16, ref.QUANTS[quant])
    rel = float((lower - f32).norm() / f32.norm())
    assert low < rel < high


def test_the_control_rounding_passes_a_second_derivative():
    """R1's double backward runs through the control's rounding, whose
    derivative is 1: d/dx of d/dx Σ q(x)³ is 6·q(x), its gradient rounded
    once more on the way back (e5m2's step is 2^-2, TF32's 2^-10)."""
    x = torch.randn(64, dtype=torch.float64).requires_grad_(True)
    for quant, step in ((ref.tf32, 2.0 ** -10), (ref.fp8, 2.0 ** -2)):
        (g,) = torch.autograd.grad((quant(x) ** 3).sum(), x, create_graph=True)
        (gg,) = torch.autograd.grad(g.sum(), x)
        torch.testing.assert_close(gg, 6 * quant(x).detach(), rtol=step / 2, atol=0.0)


def test_reference_batches_equal_the_trainers_stream():
    from pggan_tpu_torch.config import Config
    from pggan_tpu_torch.data.dataset import SyntheticDataset, split_dataset
    from pggan_tpu_torch.data.pipeline import DataPipeline

    seed, scale, size, batch = 12345, 2, 40, 8
    cfg = Config({"seed": seed})
    train, _ = split_dataset(size, 0.7, seed=int(cfg.seed))
    with DataPipeline(SyntheticDataset(size, scale), batch, indices=train, num_workers=2,
                      seed=seed + scale) as pipe:
        got = [next(pipe).numpy() for _ in range(5)]
    want = ref_data.train_batches(seed, scale, size, batch, 2, 3)
    for g, w in zip(got[2:], want):
        assert (g == w).all()


@pytest.mark.parametrize("workload", ["tiny16.train_r1", "tiny.train_lazy_r1"])
def test_training_steps_equal_the_port_in_f32(workload, tiny, tmp_path, capsys):
    """The port's plain path in f32 and the reference: the run's numbers are
    at f32 rounding, 1e-7 to 2e-4 (the bf16 cells read 1e-3 to 1e-1)."""
    with open(tiny["spec_path"]) as f:
        spec = copy.deepcopy(json.load(f))
    config = workload.split(".")[0]
    entry = next(c for c in spec["configs"] if c["name"] == config)
    with open(os.path.join(tiny["data_dir"], entry["file"])) as f:
        cfg = json.load(f)
    cfg["model"]["compute_dtype"] = "float32"
    (tmp_path / "f32.json").write_text(json.dumps(cfg))
    entry["file"] = str(tmp_path / "f32.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    rc = run.main(["--workload", workload, "--seed", "3", "--seconds", "0.5"], device="cpu",
                  spec_path=str(tmp_path / "BENCHMARK.json"), data_dir=tiny["data_dir"])
    assert rc == 0
    checks = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["checks"]
    assert checks["batch_mismatch"]["value"] == 0
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert checks[name]["value"] < 1e-3, (name, checks[name])
