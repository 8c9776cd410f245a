"""StyleGAN3-T's generator in the port (`models/stylegan3.py`, the modulated
convolution's StyleGAN3 options in `ops/modulated.py`, the filtered leaky
ReLU of `ops/composite.py`) against the plain float32 reference
`benchmark/reference/stylegan3.py` (the benchmark's own) at a small size
(32², channel_base 1024, channels ≤ 32, all 14 layers, a 2-layer mapping)
on the benchmark's seeded weights (`benchmark/weights_sg3.py`: the
magnitudes from one calibration pass, so each layer's input arrives at unit
RMS); the filter design against scipy's `firwin`; the 1024² schedule; the
routes of one forward's calls at StyleGAN3-T's layer count; the demo's
StyleGAN3 checkpoint path; on the card, the forward's launches and the
`upfirdn2d` kernels against the composition. No JAX: the reference is
torch alone.

Tolerances, each with its reason:
- float32 against float32: the port scales the activations before and
  after one shared-weight convolution and filters the up stage through a
  2-D outer product, the reference convolves each sample with its own
  weights and filters one axis at a time, so sums of products round in
  another order: 1e-5 of the largest value (seeds 1-8 read 1.0-2.9e-6).
- bf16 against float32: at 32² every layer's sampling rate × 2⁴ exceeds the
  resolution, so all 15 layers compute in bf16 (8 significant bits, ~2⁻⁹
  relative a rounding), and each rounds its conv, its epilogue, both FIR
  stages and its activation: 4 % of the images' RMS and 8 % of the largest
  value (seeds 1-8 read 0.7-1.8 % and 1.3-4.4 %).
"""

import math
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from benchmark import weights_sg3
from benchmark.reference import stylegan3 as ref
from pggan_tpu_torch import demo
from pggan_tpu_torch.config import Config, STYLEGAN3_DEFAULTS, stylegan3_args
from pggan_tpu_torch.models import stylegan3
from pggan_tpu_torch.ops import composite, kernels, modulated, resample
from pggan_tpu_torch.utils import checkpoint as ckpt_lib

CFG = dict(z_dim=32, w_dim=32, mapping_layers=2, mapping_lr_multiplier=0.01, resolution=32,
           channel_base=1024, channel_max=32, num_layers=14, num_critical=2, first_cutoff=2.0,
           first_stopband=2 ** 2.1, last_stopband_rel=2 ** 0.3, margin_size=10,
           output_scale=0.25, num_fp16_res=4, conv_clamp=256, conv_kernel=3, filter_size=6,
           lrelu_upsampling=2, img_channels=3)
T_1024 = dict(CFG, z_dim=512, w_dim=512, resolution=1024, channel_base=32768, channel_max=512)


def _generator(cfg=CFG, seed=3):
    return stylegan3.StyleGAN3Generator(seed=seed, **cfg).eval()


def _latents(n=3, dim=32, seed=0):
    return torch.randn((n, dim), generator=torch.Generator().manual_seed(seed))


def _loaded(seed, cfg=CFG):
    G = _generator(cfg)
    params = weights_sg3.make_weights(cfg, seed, "cpu")
    stylegan3.load_params(G, {k.replace(".", "/"): v.numpy() for k, v in params.items()})
    return G, params


def _rms(t):
    return float(t.square().mean().sqrt())


def test_the_reference_names_every_weight_of_the_port():
    own = {k: tuple(v.shape) for k, v in _generator().state_dict().items()}
    assert own == dict(ref.param_shapes(CFG))
    big = _generator(T_1024)
    assert sum(p.numel() for p in big.parameters()) == 22_313_167         # 22.3 M, NVIDIA's count
    assert sum(math.prod(s) for _, s in ref.param_shapes(T_1024)) == 22_313_167 + 2_072


@pytest.mark.parametrize("seed", [1, 7])
@pytest.mark.parametrize("precision", ["float32", "bf16"])
def test_images_match_the_reference(precision, seed):
    G, params = _loaded(seed)
    z = _latents(seed=seed)
    with torch.no_grad():
        want = ref.generator(params, z, CFG)
        got = G(z, compute_dtype=torch.float32 if precision == "float32" else torch.bfloat16)
    assert got.shape == want.shape == (3, 32, 32, 3) and got.dtype == torch.float32
    scale = float(want.abs().max())
    if precision == "float32":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    else:
        assert _rms(got - want) <= 0.04 * _rms(want)
        assert float((got - want).abs().max()) <= 0.08 * scale


def test_each_layer_takes_its_own_w():
    """ws[0] drives the input layer and ws[i + 1] layer i: changing one w
    changes the image, and a forward at ψ = 1 equals the synthesis of the
    mapping's w broadcast."""
    G, _ = _loaded(2)
    w = G.mapping(_latents(n=2))
    ws = w.unsqueeze(1).repeat(1, 16, 1)
    with torch.no_grad():
        base = G.synthesis(ws, torch.float32)
        for i in (0, 7, 15):
            other = ws.clone()
            other[:, i] += 1.0
            assert float((G.synthesis(other, torch.float32) - base).abs().max()) > 1e-3
        torch.testing.assert_close(G(_latents(n=2), compute_dtype=torch.float32),
                                   base.permute(0, 2, 3, 1), rtol=0, atol=0)


def _firwin_cases():
    s = stylegan3.layer_schedule()
    cases = []
    for idx in range(14):
        prev = max(idx - 1, 0)
        cases.append((s["up_taps"][idx], s["cutoffs"][prev], 2 * s["half_widths"][prev],
                      s["tmp_rates"][idx]))
        cases.append((s["down_taps"][idx], s["cutoffs"][idx], 2 * s["half_widths"][idx],
                      s["tmp_rates"][idx]))
    return cases


@pytest.mark.parametrize("numtaps, cutoff, width, fs", _firwin_cases())
def test_the_filters_are_scipys_firwin(numtaps, cutoff, width, fs):
    """Each up and down filter of the 1024² schedule, from the port's numpy
    design and from the reference's torch design, against
    `scipy.signal.firwin(numtaps, cutoff, width=width, fs=fs)`."""
    signal = pytest.importorskip("scipy.signal")
    want = signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs)
    np.testing.assert_allclose(stylegan3.design_lowpass_filter(numtaps, cutoff, width, fs), want,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(ref.lowpass(numtaps, cutoff, width, fs).numpy(), want, rtol=0,
                               atol=1e-7)


def test_the_1024_schedule():
    """StyleGAN3-T at 1024²: channels, sizes, rates, factors, taps and pads
    per layer, and the reference's schedule equal to the port's."""
    s = stylegan3.layer_schedule()
    assert s["channels"] == [512] * 7 + [323, 203, 128, 81, 51, 32, 32, 3]
    assert s["sizes"] == [36, 36, 52, 52, 84, 148, 148, 276, 276, 532, 1044, 1044, 1044, 1024,
                          1024]
    assert s["sampling_rates"] == [16, 16, 32, 32, 64, 128, 128, 256, 256, 512] + [1024] * 5
    assert s["up"] == [2, 2, 4, 2, 4, 4, 2, 4, 2, 4, 4, 2, 2, 2, 1]
    assert s["down"] == [2] * 14 + [1]
    assert s["up_taps"] == [12 * u // 2 if u > 1 else 1 for u in s["up"]]
    assert s["down_taps"] == [12] * 14 + [1]
    pads = {2: (9, 8, 9, 8), 4: (-6, -9, -6, -9)}
    assert s["padding"] == [pads[u] for u in s["up"][:13]] + [(-11, -12, -11, -12), (0, 0, 0, 0)]
    assert s["reduced"] == [False] * 5 + [True] * 10
    assert s["critical"] == [False] * 12 + [True] * 3
    layers = ref.schedule(T_1024)
    assert [layer["channels"] for layer in layers] == s["channels"]
    assert [layer["size"] for layer in layers] == s["sizes"]
    assert [layer["padding"] for layer in layers] == s["padding"]
    assert [layer["reduced"] for layer in layers] == s["reduced"]
    assert [layer["up_taps"] for layer in layers] == s["up_taps"]
    assert [layer["name"] for layer in layers][:2] == ["L0_36_512", "L1_36_512"]
    assert layers[-1]["name"] == "L14_1024_3"


def test_a_1024_forward_routes_every_call_to_a_kernel(monkeypatch):
    """At StyleGAN3-T's 1024² layer count (2 channels so that it runs here;
    the FIR stages recorded and stood in for by zeros of their output's
    size): 15 modulated convs, 14 of them with the one-pass `linear`
    epilogue; 15 filtered leaky ReLUs, each a `stylegan3.filtered_lrelu`
    range; 28 upfirdn2d calls, every one inside the kernels' envelope and in
    the separable kernels' form (a 1-D filter, the same factors on both
    axes: 14 up at ×2 or ×4 through 12 or 24 taps, 14 down at ×2 through
    12; the card test below names the kernels); 31 launches of the bias-act
    kernel's wrappers (2 mapping, 14 epilogues, 15 activations)."""
    G = _generator(dict(T_1024, channel_max=2, z_dim=8, w_dim=8))
    fir, routed = [], []

    def record(x, f, up, down, pads, flip, gain):
        fir.append((tuple(x.shape), None if f is None else f.numel(), up, down, pads,
                    resample.envelope_refusal(x, f, up, down, resample._output_size(
                        x, *resample._filter_size(f), up, down, pads)),
                    f.ndim))
        out_hw = resample._output_size(x, *resample._filter_size(f), up, down, pads)
        return x.new_zeros((x.shape[0], x.shape[1], *out_hw)).contiguous(
            memory_format=torch.channels_last)

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
    composite.reset_counts()
    with torch.no_grad(), torch.profiler.profile() as prof:
        out = G(_latents(n=1, dim=8))
    assert out.shape == (1, 1024, 1024, 3)
    assert modulated.counts == {"modconv": 15, "fused_epilogue": 14}
    assert composite.counts == {"filtered_lrelu": 15}
    names = [e.name for e in prof.events()]
    assert names.count("stylegan3.filtered_lrelu") == 15 and names.count("stylegan3.input") == 1
    assert names.count("stylegan2.modconv") == 15 and names.count("stylegan2.mapping") == 1
    assert len(fir) == 28 and all(call[5] is None for call in fir)
    assert all(c[6] == 1 and c[2][0] == c[2][1] and c[3][0] == c[3][1] for c in fir)
    assert [(c[2][0] > 1, c[3][0]) for c in fir] == [(True, 1), (False, 2)] * 14
    assert [c[2][0] for c in fir[::2]] == [2, 2, 4, 2, 4, 4, 2, 4, 2, 4, 4, 2, 2, 2]
    assert fir[20][:5] == ((1, 2, 534, 534), 24, (4, 4), (1, 1), (-6, -9, -6, -9))
    assert fir[23][:4] == ((1, 2, 2098, 2098), 12, (1, 1), (2, 2))
    assert routed.count("bias_lrelu_gain") == 17 and routed.count("modconv_epilogue") == 14
    assert all(n == 0 for n in kernels.launches.values())        # the CPU runs plain code


def test_modulated_conv_with_stylegan3s_options():
    """Pre-normalised and demodulated, with an input gain and the `linear`
    epilogue: equal to each sample convolved with NVIDIA's per-sample
    weights, + bias; the pre-normalisation leaves the output unchanged (up
    to demodulation's eps), the input gain scales it, and the epilogue runs
    as one pass without autograd."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((3, 6, 7, 7), generator=gen).contiguous(memory_format=torch.channels_last)
    weight, styles = torch.randn((5, 6, 3, 3), generator=gen), torch.randn((3, 6), generator=gen)
    bias, gain = torch.randn(5, generator=gen), torch.tensor(0.7)
    modulated.reset_counts()
    with torch.no_grad():
        got = modulated.modulated_conv2d(x, weight, styles, padding=2, prenormalize=True,
                                         input_gain=gain, act="linear", bias=bias)
        plain = modulated.modulated_conv2d(x, weight, styles, padding=2)
    assert modulated.counts == {"modconv": 2, "fused_epilogue": 1}
    want = torch.cat([ref.modulated_conv(x[b:b + 1], weight, styles[b:b + 1], gain,
                                         demodulate=True, padding=2) for b in range(3)])
    want = want + bias.view(1, -1, 1, 1)
    assert got.shape == (3, 5, 9, 9)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got - bias.view(1, -1, 1, 1), plain * 0.7, rtol=1e-5, atol=1e-5)


def test_filtered_lrelu_counts_and_folds_the_bias_without_an_up_stage():
    """Without an up stage the bias rides in the activation's one pass
    (StyleGAN3's toRGB: slope 1, gain 1, the clamp), equal to adding it
    first; each call counts once."""
    gen = torch.Generator().manual_seed(5)
    x = (torch.randn((2, 3, 4, 4), generator=gen) * 300).contiguous(
        memory_format=torch.channels_last)
    b = torch.randn(3, generator=gen)
    composite.reset_counts()
    got = composite.filtered_lrelu(x, b=b, gain=1.0, slope=1.0, clamp=256.0)
    assert composite.counts == {"filtered_lrelu": 1}
    torch.testing.assert_close(got, (x + b.view(1, -1, 1, 1)).clamp(-256, 256), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the normal path: a checkpoint through demo.load_generator and demo.main
# ---------------------------------------------------------------------------

def test_stylegan3_keys_default_to_stylegan3_t():
    a = stylegan3_args(Config({"model_id": "stylegan3", "resolution": 256}))
    assert a["resolution"] == 256 and a["channel_base"] == 32768 and a["mapping_layers"] == 2
    assert set(a) == set(STYLEGAN3_DEFAULTS)
    keys = dict(STYLEGAN3_DEFAULTS)
    keys["img_channels"] = keys.pop("output_dim")
    assert stylegan3.layer_schedule(**keys)["channels"] == stylegan3.layer_schedule()["channels"]


def test_demo_samples_a_stylegan3_checkpoint(tmp_path, capsys):
    G, _ = _loaded(3)
    args = {k: v for k, v in CFG.items() if k != "img_channels"}
    meta = {"args": Config({"model_id": "stylegan3", **args, "output_dim": 3}).to_dict()}
    ckpt_lib.save_checkpoint(str(tmp_path), "sg3", "G", 5, params=stylegan3.params_to_arrays(G),
                             meta=meta)
    loaded, args, scale, psi = demo.load_generator(str(tmp_path), "sg3", device="cpu")
    assert isinstance(loaded, stylegan3.StyleGAN3Generator)
    assert (args.model_id, scale, psi) == ("stylegan3", 3, 1.0)
    z = _latents()
    with torch.no_grad():
        torch.testing.assert_close(loaded(z, psi), G(z), rtol=0, atol=0)
    out = tmp_path / "samples"
    rc = demo.main(["--ckpt_id", "sg3", "--save_root", str(tmp_path), "--device", "cpu",
                    "--n_samples", "3", "--batch_size", "2", "--output_dir", str(out)])
    assert rc == 0
    assert sorted(os.listdir(out)) == [f"result_{i}.jpg" for i in range(3)]
    with Image.open(out / "result_0.jpg") as img:
        assert img.size == (32, 32) and img.mode == "RGB"
    assert "wrote 3 samples at 32x32" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# on the card (pytest --noconftest -m card tests/test_torch_stylegan3.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_a_stylegan3_t_forward_on_the_card(card):
    """One StyleGAN3-T forward at 1024² (batch 1, sampling): 28 upfirdn2d
    launches, all separable kernels, 31 of the bias-act kernel, 15
    modulated convs (14 one-pass) and 15 filtered leaky ReLUs; a finite
    image."""
    G = stylegan3.StyleGAN3Generator(seed=22).to(card).eval().requires_grad_(False)
    z = torch.randn((1, G.z_dim), generator=torch.Generator(device=card).manual_seed(25),
                    device=card)
    with torch.no_grad():
        G(z)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        modulated.reset_counts()
        composite.reset_counts()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            img = G(z)
            torch.cuda.synchronize()
    fir = [e.name for e in prof.events() if "upfirdn2d" in e.name]
    assert kernels.launches["upfirdn2d"] == 28 and kernels.launches["bias_lrelu_gain"] == 31
    assert sum("upfirdn2d_sep_up_kernel" in n for n in fir) == 14
    assert sum("upfirdn2d_sep_down_kernel" in n for n in fir) == 14 and len(fir) == 28
    assert modulated.counts == {"modconv": 15, "fused_epilogue": 14}
    assert composite.counts == {"filtered_lrelu": 15}
    assert img.shape == (1, 1024, 1024, 3) and bool(torch.isfinite(img).all())


FIR_CASES = [   # (id, taps, up, down, padding, f32 taps, the kernel csrc/upfirdn2d.cu launches)
    ("StyleGAN2's upsample", [[1, 3, 3, 1]] * 4, 2, 1, (2, 1, 2, 1), False,
     "upfirdn2d_up2_kernel"),
    ("down 2, 8 taps 1-D", list(range(1, 9)), 1, 2, (3, 4, 3, 4), False, "upfirdn2d_kernel"),
    ("per axis", [[1, 2, 0], [0, 1, 3]], (2, 1), (1, 2), (-1, 2, 1, -2), False,
     "upfirdn2d_kernel"),
    ("StyleGAN3's up 4", list(range(1, 25)), 4, 1, (-6, -9, -6, -9), True,
     "upfirdn2d_sep_up_kernel"),
    ("StyleGAN3's up 2", list(range(1, 13)), 2, 1, (9, 8, 9, 8), True, "upfirdn2d_sep_up_kernel"),
    ("StyleGAN3's down 2", list(range(1, 13)), 1, 2, (1, -1, 2, -2), True,
     "upfirdn2d_sep_down_kernel"),
    ("up 4 without a filter", None, 4, 1, (0, -1, 0, -1), True, "upfirdn2d_sep_up_kernel"),
    ("up 4, 2-D filter", [[1, 2, 0, 1], [0, 1, 3, 1], [2, 1, 1, 0], [1, 0, 2, 1]], 4, 1,
     (2, 1, 2, 2), False, "upfirdn2d_kernel"),
    ("12 taps, up and down 2", list(range(12, 0, -1)), 2, 2, (3, 4, 2, 5), True,
     "upfirdn2d_kernel"),
    ("up 4 on one axis", list(range(1, 13)), (4, 1), (1, 2), (5, 3, 2, 7), True,
     "upfirdn2d_kernel"),
]


@pytest.mark.card
@pytest.mark.parametrize("name, taps, up, down, padding, f32_taps, kernel", FIR_CASES,
                         ids=[c[0] for c in FIR_CASES])
def test_upfirdn2d_launches_its_kernel_on_the_card(monkeypatch, card, name, taps, up, down,
                                                   padding, f32_taps, kernel):
    """Each call launches the kernel the C side chooses for it, once, and
    matches the composition `upfirdn2d_plain` in float32 at 5 and 6
    channels (one channel a thread, and pairs beyond the polyphase
    envelope): f32 within 1e-5 of the largest value; bf16 within one
    rounding of each value (2⁻⁸ of it) plus 1e-5 of the largest. The
    composition's taps are the kernel's: f32 beyond the polyphase envelope
    for a 1-D filter, else the 2-D taps rounded to x's dtype. The
    composition's f32 convolution runs without TF32 (cuDNN's default would
    round its inputs to 10 bits)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    gen = torch.Generator(device=card).manual_seed(26)
    f = None if taps is None else torch.tensor(taps, dtype=torch.float32, device=card)
    f = None if f is None else f / f.sum()
    kw = dict(up=up, down=down, padding=padding, gain=3.0)
    for c in (5, 6):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn((2, 30, 31, c), generator=gen, device=card).to(dt).permute(0, 3, 1, 2)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                got = resample.upfirdn2d(x, f, **kw)
                torch.cuda.synchronize()
            names = [e.name for e in prof.events() if "upfirdn2d" in e.name]
            assert len(names) == 1 and re.search(rf"(?<!\w){kernel}(?!\w)", names[0]), names
            taps_want, kw_want = f, kw
            if not f32_taps and f is not None:
                full = torch.outer(f, f) if f.ndim == 1 else f
                taps_want, kw_want = (full * kw["gain"]).to(dt).float(), dict(kw, gain=1.0)
            want = resample.upfirdn2d_plain(x.float(), taps_want, **kw_want)
            diff, scale = (got.float() - want).abs(), float(want.abs().max())
            bound = 1e-5 * scale + (2.0 ** -8 * want.abs() if dt == torch.bfloat16 else 0.0)
            assert got.shape == want.shape and bool((diff <= bound).all()), (
                c, dt, float(diff.max()), scale)
