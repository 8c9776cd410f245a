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

import itertools
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
from pggan_tpu_torch.ops import basic, kernels, modulated, resample
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
    runs here): 17 conv + 9 toRGB modulated convs, and 25 epilogues on the
    bias-act kernel's two wrappers, the launches that
    `benchmark/kernels/bias_lrelu_gain.py` counts: the 8 mapping layers
    through `bias_lrelu_gain`, the 17 synthesis convs through the one-pass
    `modconv_epilogue` (sampling: no autograd)."""
    cfg = dict(CFG, z_dim=8, w_dim=8, resolution=1024, fmap_base=512, fmap_max=4,
               mapping_layers=8, num_fp16_res=4)
    G = _generator(cfg)
    routed = []

    def counting(name):
        inner = getattr(kernels, name)

        def count(x, *args, **kwargs):
            routed.append((name, tuple(x.shape)))
            return inner(x, *args, **kwargs)
        return count
    for name in ("bias_lrelu_gain", "modconv_epilogue"):
        monkeypatch.setattr(kernels, name, counting(name))
    modulated.reset_counts()
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = G(_latents(n=1, dim=8))
    assert out.shape == (1, 1024, 1024, 3)
    assert modulated.counts == {"modconv": 26, "fused_epilogue": 17}
    assert len(routed) == 25 and routed[:8] == [("bias_lrelu_gain", (1, 8))] * 8
    assert {name for name, _ in routed[8:]} == {"modconv_epilogue"}
    assert [shape for _, shape in routed[8:10]] == [(1, 4, 4, 4), (1, 4, 8, 8)]
    assert all(n == 0 for n in kernels.launches.values())        # the CPU runs plain code


def test_a_1024_forward_keeps_its_launches(monkeypatch):
    """The kernels StyleGAN2 launched before StyleGAN3's envelope was added:
    at config-f's layer count (1-4 channels), 26 modulated convs, 17 of them
    one-pass; 25 bias-act launches; 16 upfirdn2d calls, each inside the
    kernels' envelope and inside the polyphase one (up 2 and down 1 on both
    axes, the 4-tap filter's 4x4 outer product): the calls that
    `csrc/upfirdn2d.cu` sends to `upfirdn2d_up2_kernel` (phase 23 of
    chip_smoke.py names them on the card), none beyond it."""
    cfg = dict(CFG, z_dim=8, w_dim=8, resolution=1024, fmap_base=512, fmap_max=4,
               mapping_layers=8, num_fp16_res=4)
    G = _generator(cfg)
    fir, routed = [], []
    route = resample._upfirdn2d

    def record(x, f, up, down, pads, flip, gain):
        fir.append((up, down, tuple(f.shape), resample.envelope_refusal(
            x, f, up, down, resample._output_size(x, *resample._filter_size(f), up, down,
                                                  pads))))
        return route(x, f, up, down, pads, flip, gain)

    def counting(name):
        inner = getattr(kernels, name)

        def count(x, *args, **kwargs):
            routed.append(name)
            return inner(x, *args, **kwargs)
        return count
    monkeypatch.setattr(resample, "_upfirdn2d", record)
    for name in ("bias_lrelu_gain", "modconv_epilogue"):
        monkeypatch.setattr(kernels, name, counting(name))
    modulated.reset_counts()
    with torch.no_grad():
        G(_latents(n=1, dim=8))
    assert modulated.counts == {"modconv": 26, "fused_epilogue": 17}
    assert len(routed) == 25
    assert fir == [((2, 2), (1, 1), (4, 4), None)] * 16


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
# the modulated conv's epilogue in one pass (`kernels.modconv_epilogue`)
# ---------------------------------------------------------------------------

GAIN = math.sqrt(2.0)
# which of d, noise and the bias a call passes
PARTS = list(itertools.product((True, False), repeat=3))
PART_IDS = ["".join(n if on else "-" for n, on in zip("dnb", p)) for p in PARTS]
# config-f's conv outputs: (resolution, channels) of its 9 resolutions
SG2_CONV_OUTPUTS = [(r, 512) for r in (4, 8, 16, 32, 64, 128)] + [(256, 256), (512, 128),
                                                                  (1024, 64)]


def _epilogue_inputs(shape, dtype, gen, device="cpu", exact_products=False):
    """x [B, C, H, W] channels_last, N(0, 300²) so that a clamp of 256
    bites, with one NaN; d [B, C] in [0.5, 1.5), noise [H, W] and the bias
    [C], all three f32. `exact_products`: x on bf16's grid and d on a grid
    of 2⁻¹⁵, so that x·d (8 and 16 significant bits) is exact in f32."""
    batch, c, h, w = shape
    x = torch.randn(shape, generator=gen, device=device) * 300
    d = torch.rand((batch, c), generator=gen, device=device) + 0.5
    if exact_products:
        x, d = x.to(torch.bfloat16).float(), torch.round(d * 2 ** 15) / 2 ** 15
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    x[0, 0, 0, 0] = float("nan")
    noise = torch.randn((h, w), generator=gen, device=device)
    b = torch.randn((c,), generator=gen, device=device)
    return x, d, noise, b


def _composed_epilogue(x, d, noise, b, clamp):
    """The composition `modulated_conv2d` runs under autograd: d and noise
    rounded to x's dtype, `addcmul` (or its one product or sum), then
    `bias_act` with the bias in x's dtype."""
    dt = x.dtype
    if d is not None:
        dd = d.to(dt).reshape(*d.shape, 1, 1)
        x = x * dd if noise is None else torch.addcmul(noise.to(dt), x, dd)
    elif noise is not None:
        x = x + noise.to(dt)
    return basic.bias_act(x, None if b is None else b.to(dt), act="lrelu", clamp=clamp)


@pytest.mark.parametrize("parts", PARTS, ids=PART_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_one_pass_epilogue_equals_the_composition(dtype, parts):
    """`kernels.modconv_epilogue` (the plain version here) against the
    composition it replaces, with each of d, noise and the bias present or
    not, NaN passed through and the clamp biting. float32: bit for bit, on
    inputs whose x·d is exact in f32, since `addcmul` may fuse its multiply
    and add (it does on this CPU) where the one pass rounds each. bf16: the
    composition rounds d, noise, the bias and x·d + noise to bf16, the one
    pass none of them, so they differ by at most one bf16 rounding (2⁻⁸
    relative) of each term, times the gain, and of each output."""
    gen = torch.Generator().manual_seed(31)
    x, d, noise, b = _epilogue_inputs((2, 16, 6, 5), dtype, gen,
                                      exact_products=dtype == torch.float32)
    d, noise, b = (t if on else None for t, on in zip((d, noise, b), parts))
    got = kernels.modconv_epilogue(x, d, noise, b, 0.2, GAIN, 256.0)
    want = _composed_epilogue(x, d, noise, b, 256.0)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert bool(torch.isnan(got[0, 0, 0, 0])) and bool(torch.isnan(want[0, 0, 0, 0]))
    assert float(got[~torch.isnan(got)].float().abs().max()) == 256.0
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
        return
    p = x.float() * (1.0 if d is None else d.reshape(2, 16, 1, 1))
    n = torch.zeros(()) if noise is None else noise
    terms = p.abs() + n.abs() + (p + n).abs() + (0.0 if b is None else b.view(1, -1, 1, 1).abs())
    bound = 2.0 ** -8 * (GAIN * terms + got.float().abs() + want.float().abs())
    ok = ~torch.isnan(p)
    assert bool(((got.float() - want.float()).abs()[ok] <= bound[ok]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_modulated_conv_takes_the_one_pass_only_without_autograd(dtype):
    """conv0's form (2× up, convolving): under `no_grad` the epilogue is the
    one pass, under autograd the composition, and gradients reach the
    styles; the two agree to a few units in the last place of the largest
    value (f32: addcmul's fused multiply-add; bf16: the composition's
    roundings of d, noise, the bias and x·d + noise)."""
    g = torch.Generator().manual_seed(32)
    x = torch.randn((2, 6, 5, 5), generator=g).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    w, s = torch.randn((4, 6, 3, 3), generator=g), torch.randn((2, 6), generator=g)
    kw = dict(up=2, padding=1, resample_filter=stylegan2.setup_filter(stylegan2.FIR, device="cpu"),
              noise=torch.randn((10, 10), generator=g), flip_weight=False, act="lrelu",
              bias=torch.randn(4, generator=g), clamp=256.0)
    modulated.reset_counts()
    with torch.no_grad():
        fused = modulated.modulated_conv2d(x, w, s, **kw)
    assert modulated.counts == {"modconv": 1, "fused_epilogue": 1}
    styles = s.clone().requires_grad_(True)
    composed = modulated.modulated_conv2d(x, w, styles, **kw)
    assert modulated.counts == {"modconv": 2, "fused_epilogue": 1}
    composed.float().square().sum().backward()
    assert float(styles.grad.abs().max()) > 0
    assert fused.dtype == dtype and fused.is_contiguous(memory_format=torch.channels_last)
    largest = float(composed.detach().float().abs().max())
    atol = (2.0 ** -20 if dtype == torch.float32 else 2.0 ** -6) * largest
    torch.testing.assert_close(fused.float(), composed.detach().float(), rtol=0, atol=atol)


def test_the_counter_engages_once_per_conv_layer_without_autograd():
    """`counts["fused_epilogue"]`: the 7 conv layers of the 32² generator
    under `no_grad`, none under autograd (its parameters require grad); the
    float32 images of the two routes agree to a few units in the last place."""
    G = _generator()
    z = _latents(n=2)
    modulated.reset_counts()
    with torch.no_grad():
        fused = G(z, compute_dtype=torch.float32)
    assert modulated.counts == {"modconv": 11, "fused_epilogue": 7}
    modulated.reset_counts()
    composed = G(z, compute_dtype=torch.float32)
    composed.sum().backward()
    assert modulated.counts == {"modconv": 11, "fused_epilogue": 0}
    largest = float(composed.detach().abs().max())
    torch.testing.assert_close(fused, composed.detach(), rtol=0, atol=1e-6 * largest)


def test_the_one_pass_epilogue_is_forward_only():
    x = torch.randn((1, 4, 3, 3)).contiguous(memory_format=torch.channels_last)
    with pytest.raises(RuntimeError, match="no autograd rule"):
        kernels.modconv_epilogue(x.requires_grad_(True), None, None, None)
    with torch.no_grad():
        assert kernels.modconv_epilogue(x, None, None, None).shape == x.shape


class _OnCuda(torch.Tensor):
    """A CPU tensor that reads as a CUDA one, to drive the dispatch here."""

    @property
    def is_cuda(self):
        return True

    @property
    def is_cpu(self):
        return False


EPILOGUE_ROUTES = [   # (id, the call's inputs changed, refusal (type, words) or None)
    ("f32", {}, None),
    ("bf16, bias in x's dtype", dict(x=torch.bfloat16, b=torch.bfloat16), None),
    ("no d, noise or bias", dict(d=None, noise=None, b=None), None),
    ("nchw", dict(x=torch.contiguous_format), (ValueError, "innermost in memory")),
    ("f16", dict(x=torch.float16), (TypeError, "float32 or bfloat16")),
    ("2-D", dict(x=(2, 8)), (ValueError, "4-D")),
    ("d bf16", dict(d=torch.bfloat16), (ValueError, "d must be")),
    ("d [C]", dict(d=(8,)), (ValueError, "d must be")),
    ("noise [H, W+1]", dict(noise=(5, 7)), (ValueError, "noise must be")),
    ("bias [C+1]", dict(b=(9,)), (ValueError, "b must be")),
]


@pytest.mark.parametrize("name, change, refusal", EPILOGUE_ROUTES,
                         ids=[c[0] for c in EPILOGUE_ROUTES])
def test_the_one_pass_epilogue_dispatch_on_a_cuda_tensor(monkeypatch, name, change, refusal):
    """A call on a CUDA tensor (a CPU one that reads as CUDA) launches the
    bias-act kernel with d, noise, the pixels a sample and the clamp, or
    raises outside the kernel's envelope, never running the plain version."""
    x = torch.zeros((2, 8, 5, 6)).contiguous(memory_format=torch.channels_last)
    args = dict(x=x, d=torch.ones((2, 8)), noise=torch.zeros((5, 6)), b=torch.zeros(8))
    for key, how in change.items():
        if how is None or isinstance(how, tuple):
            args[key] = None if how is None else torch.zeros(how)
        elif isinstance(how, torch.memory_format):
            args[key] = args[key].contiguous(memory_format=how)
        else:
            args[key] = args[key].to(how)
    calls = []
    monkeypatch.setattr(kernels, "_call", lambda *a: calls.append(a))
    monkeypatch.setattr(kernels, "bias_lrelu_gain_plain", None)     # never called
    cuda = {k: None if v is None else v.as_subclass(_OnCuda) for k, v in args.items()}
    if refusal is not None:
        with pytest.raises(refusal[0], match=refusal[1]):
            kernels.modconv_epilogue(cuda["x"], cuda["d"], cuda["noise"], cuda["b"], 0.2,
                                     GAIN, 256.0)
        assert not calls
        return
    y = kernels.modconv_epilogue(cuda["x"], cuda["d"], cuda["noise"], cuda["b"], 0.2, GAIN,
                                 256.0)
    assert y.shape == x.shape and y.stride() == args["x"].stride()
    (name_, entry, _, *c_args), = calls
    ptr = [None if args[k] is None else cuda[k].data_ptr() for k in ("b", "d", "noise")]
    x_code = 1 if args["x"].dtype == torch.bfloat16 else 0
    b_code = 1 if args["b"] is not None and args["b"].dtype == torch.bfloat16 else 0
    assert (name_, entry) == ("bias_lrelu_gain", "pggan_bias_lrelu_gain")
    assert c_args == [cuda["x"].data_ptr(), *ptr, y.data_ptr(), 2 * 8 * 30, 8, 30, x_code,
                      b_code, 0.2, GAIN, 256.0]


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_one_pass_epilogue_on_the_card(card, dtype):
    """The bias-act kernel with d and noise against its plain version, bit
    for bit (both round each product and sum on its own), at the conv
    outputs of config-f's 9 resolutions (batch 2, C 512 to 64), at C = 30
    with an odd H × W and on a view 2-4 bytes off alignment (the scalar
    path); each of d, noise and the bias present or null, and a bias in x's
    dtype; NaN passed through, the clamp biting; one launch a call; the path
    each input takes."""
    g = torch.Generator(device=card).manual_seed(24)
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    shapes = [(2, c, r, r) for r, c in SG2_CONV_OUTPUTS] + [(2, 30, 33, 17)]
    for shape in shapes:
        x, d0, noise0, b0 = _epilogue_inputs(shape, dtype, g, card)
        inputs = [(x, vec if shape[1] % vec == 0 else 1)]
        if shape[1] == 64:
            flat = torch.empty(x.numel() + 1, dtype=dtype, device=card)[1:]
            skewed = flat.view(shape[0], *shape[2:], shape[1]).permute(0, 3, 1, 2)
            inputs.append((skewed.copy_(x), 1))
        biases = [b0] + ([b0.to(dtype)] if dtype != torch.float32 else [])
        for (xi, per_load), (with_d, with_noise, with_b), b in itertools.product(
                inputs, PARTS, biases):
            d, noise = (d0 if with_d else None), (noise0 if with_noise else None)
            bias = b if with_b else None
            assert kernels.bias_lrelu_gain_plan(xi, bias, d) == per_load, shape
            kernels.reset_launch_counts()
            got = kernels.modconv_epilogue(xi, d, noise, bias, 0.2, GAIN, 256.0)
            assert kernels.launches["bias_lrelu_gain"] == 1
            want = kernels.bias_lrelu_gain_plain(xi, bias, 0.2, GAIN, 1, 256.0, d=d,
                                                 noise=noise)
            torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
            assert got.stride() == xi.stride() and bool(torch.isnan(got[0, 0, 0, 0]))
            assert float(got[~torch.isnan(got)].float().abs().max()) == 256.0


@pytest.mark.card
def test_a_config_f_forward_on_the_card(card):
    """One config-f forward at 1024² (batch 1, sampling): 25 launches of the
    bias-act kernel (8 mapping, 17 one-pass synthesis epilogues), 16 of
    upfirdn2d, 26 modulated convs, all 17 epilogues on the one pass."""
    G = stylegan2.StyleGAN2Generator(seed=22).to(card).eval().requires_grad_(False)
    z = torch.randn((1, G.z_dim), generator=torch.Generator(device=card).manual_seed(25),
                    device=card)
    with torch.no_grad():
        G(z)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        modulated.reset_counts()
        img = G(z)
        torch.cuda.synchronize()
    assert kernels.launches["bias_lrelu_gain"] == 25 and kernels.launches["upfirdn2d"] == 16
    assert modulated.counts == {"modconv": 26, "fused_epilogue": 17}
    assert img.shape == (1, 1024, 1024, 3) and bool(torch.isfinite(img).all())


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

