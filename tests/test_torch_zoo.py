"""The port's discriminator zoo and its blocks (`pggan_tpu_torch/models/
zoo.py`) and the LPIPS-style distance (`pggan_tpu_torch/losses/
perceptual.py`) against the JAX package's, on the CPU: numpy-seeded
parameters and inputs through both (NHWC arrays permuted to NCHW), f32,
within 1e-5 of the largest |value| (`close`); the LPIPS input gradient
against jax.grad; the reference LPIPS key surface (`tests/test_submodel_port.py`)
loaded strictly, its distance equal to JAX's converter followed by JAX's
forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_submodel_port as sm
from pggan_tpu.losses import perceptual as jp
from pggan_tpu.models import zoo as jz
from test_torch_backbones import close, jax_apply, nchw, nhwc, numpy_params
from pggan_tpu_torch.losses import perceptual as pp
from pggan_tpu_torch.models import zoo as pz


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("factor", [2, 0.5, 1.5, 0.75])
def test_interpolate2d_matches_jax(factor, method):
    """Half-pixel centres, no antialias, output int(H·s): above and below 1
    and at factors whose sizes do not divide."""
    x = _x(0, 2, 10, 7, 3)
    want = np.asarray(jz.interpolate2d(jnp.asarray(x), factor, method))
    close(nhwc(pz.interpolate2d(nchw(x), factor, method)), want)


def test_instance_norm_and_adain_match_jax():
    """Biased variance, eps 1e-5; AdaIN's [γ ‖ β] split channel-first."""
    x = (3.0 * _x(1, 2, 5, 6, 8) + 1.0).astype(np.float32)
    close(nhwc(pz.instance_norm(nchw(x))), np.asarray(jz._instance_norm(jnp.asarray(x))))
    template, arrays = numpy_params(jz.init_adain, 2, style_dim=16, num_features=8)
    s = _x(3, 2, 16)
    module = pz.load_params_from_jax(pz.AdaIN(16, 8), arrays)
    with torch.no_grad():
        got = nhwc(module(nchw(x), torch.from_numpy(s)))
    close(got, jax_apply(jz.adain_apply, template, arrays, x, s))


CONV_BLOCKS = [  # kernel, stride, padding, norm, activation, transpose
    (3, 2, 1, "bn", "relu", False),
    (4, 2, 1, "in", "lrelu", False),
    (3, 2, 1, "none", "tanh", True),
    (3, 1, 1, "bn", "sig", False),
]


@pytest.mark.parametrize("kernel,stride,padding,norm,act,transpose", CONV_BLOCKS)
def test_conv_block_matches_jax(kernel, stride, padding, norm, act, transpose):
    """'bn' on the batch's statistics, as the JAX package's (the reference
    zoo trains only)."""
    template, arrays = numpy_params(jz.init_conv_block, 4, input_dim=6, output_dim=8,
                                    kernel_size=kernel, norm_type=norm)
    x = _x(5, 3, 9, 8, 6)
    module = pz.load_params_from_jax(pz.ConvBlock(
        6, 8, kernel_size=kernel, stride=stride, padding=padding, norm_type=norm,
        activation_type=act, transpose=transpose), arrays)
    with torch.no_grad():
        got = nhwc(module(nchw(x)))
    close(got, jax_apply(jz.conv_block_apply, template, arrays, x, stride=stride,
                         padding=padding, norm_type=norm, activation_type=act,
                         transpose=transpose))


@pytest.mark.parametrize("norm,scale", [("in", 1), ("bn", 2), ("none", 0.5)])
def test_res_block_matches_jax(norm, scale):
    template, arrays = numpy_params(jz.init_res_block, 6, in_c=6, out_c=4, norm=norm)
    x = _x(7, 2, 8, 8, 6)
    module = pz.load_params_from_jax(pz.ResBlock(6, 4, norm=norm, scale_factor=scale), arrays)
    with torch.no_grad():
        got = nhwc(module(nchw(x)))
    close(got, jax_apply(jz.res_block_apply, template, arrays, x, scale_factor=scale,
                         norm=norm))


@pytest.mark.parametrize("scale", [1, 2])
def test_adain_res_block_matches_jax(scale):
    template, arrays = numpy_params(jz.init_adain_res_block, 8, in_c=6, out_c=4,
                                    style_dim=16)
    x, s = _x(9, 2, 8, 8, 6), _x(10, 2, 16)
    module = pz.load_params_from_jax(pz.AdaINResBlock(6, 4, style_dim=16, scale_factor=scale),
                                     arrays)
    with torch.no_grad():
        got = nhwc(module(nchw(x), torch.from_numpy(s)))
    close(got, jax_apply(jz.adain_res_block_apply, template, arrays, x, s,
                         scale_factor=scale))


@pytest.mark.parametrize("padw", [2, 1])
def test_patch_discriminator_matches_jax(padw):
    """padw 2 (N-layer) and 1 (the fixed PatchGAN); the features too."""
    template, arrays = numpy_params(jz.init_patch_discriminator, 11, base_width=16,
                                    n_layers=3)
    x = _x(12, 2, 32, 32, 3)
    module = pz.patch_params_from_jax(arrays, padw=padw)
    with torch.no_grad():
        out, feats = module(nchw(x), get_features=True)
    want_out, want_feats = jax_apply(jz.patch_discriminator_apply, template, arrays, x,
                                     padw=padw, get_features=True)
    close(nhwc(out), want_out)
    assert len(feats) == len(want_feats) == 4
    for got, want in zip(feats, want_feats):
        close(nhwc(got), want)


@pytest.mark.parametrize("side", [40, 42])
def test_multiscale_discriminator_matches_jax(side):
    """Entry i is `scales[num-1-i]` on the input pooled i times by
    AvgPool2d(3, 2, 1, count_include_pad=False); 40² pools to even sizes
    (20², 10²), 42² to odd ones (21², 11²)."""
    template, arrays = numpy_params(jz.init_multiscale_discriminator, 13, num_scales=3,
                                    base_width=8, n_layers=3)
    x = _x(14, 2, side, side, 3)
    module = pz.multiscale_params_from_jax(arrays)
    with torch.no_grad():
        outs = module(nchw(x))
    want = jax_apply(jz.multiscale_discriminator_apply, template, arrays, x)
    assert len(outs) == len(want) == 3
    for got, w in zip(outs, want):
        close(nhwc(got), w)


def test_latent_discriminator_matches_jax():
    template, arrays = numpy_params(jz.init_latent_discriminator, 15, code_dim=32,
                                    hidden=(64, 16))
    code = _x(16, 5, 32)
    with torch.no_grad():
        got = pz.latent_params_from_jax(arrays)(torch.from_numpy(code)).numpy()
    assert got.shape == (5, 1)
    close(got, jax_apply(jz.latent_discriminator_apply, template, arrays, code))


@pytest.mark.parametrize("img_size,domains", [(32, 2), (16, 1)])
def test_stargan_discriminator_matches_jax(img_size, domains):
    """Learned bias-free shortcuts only on width changes, the 4×4 head
    without padding."""
    template, arrays = numpy_params(jz.init_stargan_discriminator, 17, img_size=img_size,
                                    num_domains=domains, max_width=64)
    x = _x(18, 2, img_size, img_size, 3)
    module = pz.stargan_params_from_jax(arrays)
    assert any(block.skip is None for block in module.blocks)
    with torch.no_grad():
        got = module(nchw(x)).numpy()
    assert got.shape == (2, domains)
    close(got, jax_apply(jz.stargan_discriminator_apply, template, arrays, x))


# ---- LPIPS ----

def _lpips_pair(rs):
    """JAX's PerceptualDistance with numpy weights (non-zero conv biases,
    positive 1×1 weights) and its arrays in the npz key convention."""
    jax_pd = jp.PerceptualDistance()
    arrays = {}
    for i, (c, k, cin) in enumerate(zip(pp.WIDTHS, (11, 5, 3, 3, 3),
                                        (3,) + pp.WIDTHS[:2] + (384, 256))):
        arrays[f"conv{i}_w"] = (rs.randn(k, k, cin, c) * np.sqrt(2.0 / (k * k * cin))
                                ).astype(np.float32)
        arrays[f"conv{i}_b"] = (0.1 * rs.randn(c)).astype(np.float32)
        arrays[f"lin{i}"] = np.abs(rs.randn(c)).astype(np.float32)
    jax_pd.backbone = [{"w": jnp.asarray(arrays[f"conv{i}_w"]),
                        "b": jnp.asarray(arrays[f"conv{i}_b"])} for i in range(5)]
    jax_pd.linear = [jnp.asarray(arrays[f"lin{i}"]) for i in range(5)]
    return jax_pd, arrays


@pytest.mark.parametrize("side", [64, 67])
def test_perceptual_distance_matches_jax(side):
    """AlexNet taps, unpadded max-pools (an odd side floors them), unit
    normalisation with rsqrt(Σ² + 1e-10), 1×1 weights, spatial and batch
    means."""
    jax_pd, arrays = _lpips_pair(np.random.RandomState(19))
    a, b = _x(20, 2, side, side, 3), _x(21, 2, side, side, 3)
    module = pp.params_from_jax(arrays, device="cpu")
    with torch.no_grad():
        got = module(nchw(a), nchw(b))
    assert got.ndim == 0
    close(got.numpy(), np.asarray(jax.jit(jax_pd.__call__)(jnp.asarray(a), jnp.asarray(b))))
    with torch.no_grad():
        default = pp.PerceptualDistance(device="cpu")
        for lin, c in zip(default.lpips_weights, pp.WIDTHS):
            np.testing.assert_allclose(lin.main[1].weight.numpy(), 1.0 / c)


def test_lpips_input_gradient_matches_jax():
    """d LPIPS(a, b) / da, as the reference's LPIPS loss back-propagates."""
    jax_pd, arrays = _lpips_pair(np.random.RandomState(22))
    a, b = _x(23, 2, 64, 64, 3), _x(24, 2, 64, 64, 3)
    want = np.asarray(jax.jit(jax.grad(jax_pd.__call__))(jnp.asarray(a), jnp.asarray(b)))
    module = pp.params_from_jax(arrays, device="cpu")
    at = nchw(a).requires_grad_(True)
    module(at, nchw(b)).backward()
    close(nhwc(at.grad), want)


def _lpips_sd(rs):
    """The reference LPIPS module's keys (`lpips.py:6-23`): torchvision
    AlexNet `features` convs under `alexnet.layers`, bias-free 1×1 convs
    `lpips_weights.{i}.main.1`."""
    sd, cin = {}, 3
    for i, (idx, c, k) in enumerate(zip(pp.CONV_INDEX, pp.WIDTHS, (11, 5, 3, 3, 3))):
        sm._mk(sd, rs, f"alexnet.layers.{idx}.weight", c, cin, k, k)
        sm._mk(sd, rs, f"alexnet.layers.{idx}.bias", c)
        sd[f"lpips_weights.{i}.main.1.weight"] = np.abs(rs.randn(1, c, 1, 1)).astype(np.float32)
        cin = c
    return sd


def test_lpips_reference_state_dict_matches_jax_converter():
    rs = np.random.RandomState(25)
    sd = _lpips_sd(rs)
    module = pp.convert_lpips_state_dict(sd, device="cpu")
    assert set(module.state_dict()) == set(sd)
    a, b = _x(26, 2, 64, 64, 3), _x(27, 2, 64, 64, 3)
    with torch.no_grad():
        got = module(nchw(a), nchw(b)).numpy()
    want = jp.PerceptualDistance.from_torch_state_dict(sd)(jnp.asarray(a), jnp.asarray(b))
    close(got, np.asarray(want))


def test_held_tensors_default_to_the_card():
    """PerceptualDistance and ParametricFaceModel are built on the card
    unless asked otherwise: without one, they raise rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    from pggan_tpu_torch.models.face3d import ParametricFaceModel
    for build in (pp.PerceptualDistance, lambda: ParametricFaceModel(n_vertices=8)):
        with pytest.raises((RuntimeError, AssertionError)):
            build()


def test_lpips_npz_of_the_jax_converter_loads(tmp_path):
    """The one npz both of JAX's loader hooks read (`np.savez(path,
    **convert_lpips_state_dict(sd))`) builds the same network as the
    reference state_dict."""
    sd = _lpips_sd(np.random.RandomState(28))
    path = tmp_path / "lpips.npz"
    np.savez(path, **jp.convert_lpips_state_dict(sd))
    with np.load(path) as arrays:
        module = pp.params_from_jax(arrays, device="cpu")
    reference = pp.convert_lpips_state_dict(sd, device="cpu")
    for key, value in reference.state_dict().items():
        assert torch.equal(module.state_dict()[key], value), key
