"""StyleGAN2's generator in the port (`models/stylegan2.py`, the modulated
convolution of `ops/modulated.py`) against the plain float32 reference
`benchmark/reference/stylegan2.py` (the benchmark's own), on the port's own
seeded weights at a small size (32², channels ≤ 32, a 2-layer mapping, the
two highest resolutions in bf16); the clamped `bias_lrelu_gain` route of `bias_act`; the demo's
StyleGAN2 checkpoint path. No JAX: the reference is torch alone.

Tolerances, each with its reason:
- float32 against float32: the port scales the activations before and
  after one shared-weight convolution, the reference convolves each sample
  with its own scaled weights, so sums of products round in another order:
  1e-5 of the largest value (images, w) and 1e-4 of each leaf's gradient
  norm (a gradient sums over many more terms).
- the bf16 / f32 split against float32: bf16 keeps 8 significant bits, so
  each reduced-precision layer rounds at ~2⁻⁹ relative and the two bf16
  blocks of four convs and two toRGBs compound it: 2 % of the images' RMS
  and 8 % of the largest value. The gradients: the norm of the whole
  difference within 12 % of the whole gradient's norm, and the median
  leaf's within 8 % of its own. A leaf's gradient sums many products of
  opposite sign (demodulation leaves each layer's output blind to its
  weights' scale), so the bf16 rounding of the terms is not averaged away:
  seeds 3 and 4 read 7.5 % and 4.3 % whole, 5.4 % and 3.3 % at the median
  leaf, and up to 27 % on a single scalar noise strength, which is why no
  single leaf is held to a bound.
"""

import math
import os
import statistics

import pytest
import torch
from PIL import Image

from benchmark.reference import stylegan2 as ref
from pggan_tpu_torch import demo
from pggan_tpu_torch.config import Config, STYLEGAN2_DEFAULTS, stylegan2_args
from pggan_tpu_torch.models import stylegan2
from pggan_tpu_torch.ops import basic, kernels, modulated
from pggan_tpu_torch.utils import checkpoint as ckpt_lib

CFG = dict(z_dim=32, w_dim=32, mapping_layers=2, mapping_lr_multiplier=0.01, resolution=32,
           fmap_base=256, fmap_max=32, num_fp16_res=2, conv_clamp=256, img_channels=3)
DTYPES = {"float32": torch.float32, "bf16_split": torch.bfloat16}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _generator(cfg=CFG, seed=3):
    return stylegan2.StyleGAN2Generator(seed=seed, **cfg).eval()


def _latents(n=4, dim=32, seed=0):
    return torch.randn((n, dim), generator=torch.Generator().manual_seed(seed))


def _params(G):
    return {k: v.detach().clone() for k, v in G.state_dict().items()}


def test_the_reference_names_every_weight_of_the_port():
    G = _generator()
    want = dict(ref.param_shapes(CFG))
    got = {k: tuple(v.shape) for k, v in G.state_dict().items()}
    assert got == want
    assert [G.synthesis.__getattr__(f"b{r}").reduced for r in (4, 8, 16, 32)] == [
        False, False, True, True]


@pytest.mark.parametrize("precision", DTYPES)
def test_images_and_w_match_the_reference(precision):
    G = _generator()
    z = _latents()
    p = _params(G)
    with torch.no_grad():
        got = G(z, compute_dtype=DTYPES[precision])
        want = ref.generator(p, z, CFG)
        w_got, w_want = G.mapping(z), ref.mapping(p, z, CFG)
    assert got.shape == (4, 32, 32, 3) and got.dtype == torch.float32
    torch.testing.assert_close(w_got, w_want, rtol=0, atol=1e-5 * float(w_want.abs().max()))
    largest = float(want.abs().max())
    if precision == "float32":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * largest)
    else:
        rms = float(want.square().mean().sqrt())
        assert float((got - want).square().mean().sqrt()) <= 0.02 * rms
        assert float((got - want).abs().max()) <= 0.08 * largest
        assert not torch.equal(got, G(z, compute_dtype=torch.float32).detach())


def test_synthesis_takes_each_layers_w():
    """Distinct ws (as an e4e encoder gives them): block r's convs take
    their own and its toRGB the next, as the reference indexes them."""
    G = _generator()
    ws = torch.randn((2, ref.num_ws(CFG), 32), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = G.synthesis(ws, torch.float32)
        want = ref.synthesis(_params(G), ws, CFG)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("precision", DTYPES)
def test_weight_gradients_match_the_reference(precision):
    """The gradient of a weighted image sum (seeded weights, so that every
    pixel counts differently) with respect to every parameter."""
    G = _generator()
    z = _latents(n=2)
    r = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(9))
    (G(z, compute_dtype=DTYPES[precision]) * r).sum().backward()
    p = {k: v.detach().clone().requires_grad_(v.dtype.is_floating_point)
         for k, v in G.named_parameters()}
    p.update({k: v.detach().clone() for k, v in G.named_buffers()})
    (ref.generator(p, z, CFG) * r).sum().backward()
    gaps, diff2, norm2 = [], 0.0, 0.0
    for name, param in G.named_parameters():
        want = p[name].grad
        assert float(want.norm()) > 0, name
        gaps.append(float((param.grad - want).norm() / want.norm()))
        diff2 += float((param.grad - want).square().sum())
        norm2 += float(want.square().sum())
    if precision == "float32":
        assert max(gaps) <= 1e-4, gaps
    else:
        assert math.sqrt(diff2 / norm2) <= 0.12
        assert statistics.median(gaps) <= 0.08, gaps


@pytest.mark.parametrize("up", [1, 2])
@pytest.mark.parametrize("demodulate", [True, False])
def test_modulated_conv_alone(up, demodulate):
    """One modulated conv with noise, against the reference's per-sample
    form; the upsampling conv convolves (weight flipped) as NVIDIA's
    `flip_weight=False`."""
    g = torch.Generator().manual_seed(11)
    x = torch.randn((3, 6, 5, 5), generator=g).contiguous(memory_format=torch.channels_last)
    w, s = torch.randn((4, 6, 3, 3), generator=g), torch.randn((3, 6), generator=g)
    noise = torch.randn((5 * up, 5 * up), generator=g)
    f = stylegan2.setup_filter(stylegan2.FIR, device="cpu")
    modulated.reset_counts()
    got = modulated.modulated_conv2d(x, w, s, demodulate=demodulate, up=up, padding=1,
                                     resample_filter=f, noise=noise, flip_weight=up == 1)
    want = ref.modulated_conv(x, w, s, demodulate=demodulate, up=up == 2) + noise
    assert modulated.counts["modconv"] == 1
    assert got.shape == (3, 4, 5 * up, 5 * up)
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_the_float32_parts_run_without_tf32(monkeypatch):
    """Every convolution, affine and mapping layer of a forward runs with
    cuDNN's and cuBLAS's TF32 off (PyTorch lets cuDNN compute float32
    convolutions in TF32 by default), and both settings are back as they
    were after it."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []

    def recording(fn, name):
        def call(*args, **kwargs):
            seen.append((name, torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return fn(*args, **kwargs)
        return call
    monkeypatch.setattr(torch.nn.functional, "conv2d",
                        recording(torch.nn.functional.conv2d, "conv2d"))
    monkeypatch.setattr(torch, "addmm", recording(torch.addmm, "addmm"))
    monkeypatch.setattr(stylegan2, "bias_act", recording(stylegan2.bias_act, "bias_act"))
    with torch.no_grad():
        _generator()(_latents(n=2), compute_dtype=torch.float32)
    assert {name for name, *_ in seen} == {"conv2d", "addmm", "bias_act"}
    assert all(flags == [False, False] for _, *flags in seen)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_a_1024_forward_counts_26_modconvs_and_25_kernel_epilogues(monkeypatch):
    """At config-f's layer count (1024², 9 blocks; 1-4 channels so that it
    runs here): 17 conv + 9 toRGB modulated convs, and 8 mapping + 17
    synthesis epilogues on the `bias_lrelu_gain` route, the launches that
    `benchmark/kernels/bias_lrelu_gain.py` counts."""
    cfg = dict(CFG, z_dim=8, w_dim=8, resolution=1024, fmap_base=512, fmap_max=4,
               mapping_layers=8, num_fp16_res=4)
    G = _generator(cfg)
    routed = []
    inner = kernels.bias_lrelu_gain

    def count(x, *args, **kwargs):
        routed.append(tuple(x.shape))
        return inner(x, *args, **kwargs)
    monkeypatch.setattr(kernels, "bias_lrelu_gain", count)
    modulated.reset_counts()
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = G(_latents(n=1, dim=8))
    assert out.shape == (1, 1024, 1024, 3)
    assert modulated.counts["modconv"] == 26
    assert len(routed) == 25 and routed[:8] == [(1, 8)] * 8
    assert routed[8:10] == [(1, 4, 4, 4), (1, 4, 8, 8)]
    assert all(n == 0 for n in kernels.launches.values())        # the CPU runs plain code


# ---------------------------------------------------------------------------
# the clamp of bias_act's leaky ReLU
# ---------------------------------------------------------------------------

def _torch_ops_bias_lrelu_clamp(x, b, clamp, slope=0.2, gain=math.sqrt(2.0)):
    z = x.float() + b.float().view(1, -1, 1, 1)
    return (torch.where(z >= 0, z, z * slope) * gain).clamp(-clamp, clamp).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_act_clamp_forward(dtype):
    g = torch.Generator().manual_seed(21)
    x = (torch.randn((2, 8, 5, 5), generator=g) * 3).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    b = torch.randn(8, generator=g)
    got = basic.bias_act(x, b.to(dtype), act="lrelu", clamp=1.5)
    want = _torch_ops_bias_lrelu_clamp(x, b.to(dtype), 1.5)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert float(got.float().abs().max()) == 1.5
    assert torch.equal(got, want)


def test_bias_act_clamp_gradients():
    """First derivatives (x, b) and the second derivative of the clamped
    route against autograd through torch ops: zero where the clamp bit."""
    g = torch.Generator().manual_seed(22)
    x0 = torch.randn((2, 8, 5, 5), generator=g) * 3
    b0, wgt = torch.randn(8, generator=g), torch.randn((2, 8, 5, 5), generator=g)
    grads = []
    for fn in (lambda x, b: basic.bias_act(x, b, act="lrelu", clamp=1.5),
               lambda x, b: _torch_ops_bias_lrelu_clamp(x, b, 1.5)):
        x = x0.clone().contiguous(memory_format=torch.channels_last).requires_grad_(True)
        b = b0.clone().requires_grad_(True)
        gx, gb = torch.autograd.grad((wgt * fn(x, b).square()).sum(), (x, b), create_graph=True)
        (g2,) = torch.autograd.grad((gx * wgt).sum() + gb.sum(), (x,))
        grads.append((gx.detach(), gb.detach(), g2))
    clipped = (_torch_ops_bias_lrelu_clamp(x0, b0, 1e9).abs() > 1.5)
    assert 0.1 < float(clipped.float().mean()) < 0.9
    assert float(grads[0][0][clipped].abs().max()) == 0.0
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_kernels_clamp_on_the_card(card, dtype):
    """The CUDA kernel with a clamp against its plain version, with and
    without a bias, NaN passed through; one launch a call."""
    g = torch.Generator(device=card).manual_seed(23)
    x = (torch.randn((4, 64, 33, 17), generator=g, device=card) * 300).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    x[0, 0, 0, 0] = float("nan")
    b = torch.randn(64, generator=g, device=card)
    for bias in (None, b, b.to(dtype)):
        kernels.reset_launch_counts()
        got = kernels.bias_lrelu_gain(x, bias, 0.2, math.sqrt(2.0), 1, 256.0)
        want = kernels.bias_lrelu_gain_plain(x, bias, 0.2, math.sqrt(2.0), 1, 256.0)
        assert kernels.launches["bias_lrelu_gain"] == 1
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
        assert bool(torch.isnan(got[0, 0, 0, 0]))
        assert float(got[~torch.isnan(got)].float().abs().max()) == 256.0


# ---------------------------------------------------------------------------
# the normal path: a checkpoint through demo.load_generator and demo.main
# ---------------------------------------------------------------------------

def _save(root, G, **args):
    meta = {"args": Config({"model_id": "stylegan2", **CFG, "output_dim": 3,
                            **args}).to_dict()}
    ckpt_lib.save_checkpoint(str(root), "sg2", "G", 5, params=stylegan2.params_to_arrays(G),
                             meta=meta)


def test_stylegan2_keys_default_to_config_f():
    a = stylegan2_args(Config({"model_id": "stylegan2", "resolution": 256}))
    assert a["resolution"] == 256 and a["fmap_base"] == 32768 and a["num_fp16_res"] == 4
    assert set(a) == set(STYLEGAN2_DEFAULTS)
    widths = [ref.channels(STYLEGAN2_DEFAULTS, r) for r in ref.resolutions(STYLEGAN2_DEFAULTS)]
    assert widths == [512] * 6 + [256, 128, 64] and ref.num_ws(STYLEGAN2_DEFAULTS) == 18


def test_demo_samples_a_stylegan2_checkpoint(tmp_path, capsys):
    G = _generator()
    _save(tmp_path, G)
    loaded, args, scale, psi = demo.load_generator(str(tmp_path), "sg2", device="cpu")
    assert isinstance(loaded, stylegan2.StyleGAN2Generator)
    assert (args.model_id, scale, psi) == ("stylegan2", 3, 1.0)
    z = _latents()
    with torch.no_grad():
        torch.testing.assert_close(loaded(z, psi), G(z), rtol=0, atol=0)
    out = tmp_path / "samples"
    rc = demo.main(["--ckpt_id", "sg2", "--save_root", str(tmp_path), "--device", "cpu",
                    "--n_samples", "3", "--batch_size", "2", "--output_dir", str(out)])
    assert rc == 0
    assert sorted(os.listdir(out)) == [f"result_{i}.jpg" for i in range(3)]
    with Image.open(out / "result_0.jpg") as img:
        assert img.size == (32, 32) and img.mode == "RGB"
    assert "wrote 3 samples at 32x32" in capsys.readouterr().out


def test_demo_refuses_a_stylegan2_checkpoint_with_other_keys(tmp_path):
    arrays = stylegan2.params_to_arrays(_generator())
    del arrays["synthesis/b8/conv0/noise_const"]
    ckpt_lib.save_checkpoint(str(tmp_path), "bad", "G", 1, params=arrays,
                             meta={"args": {"model_id": "stylegan2", **CFG}})
    with pytest.raises(KeyError, match="noise_const"):
        demo.load_generator(str(tmp_path), "bad", device="cpu")

