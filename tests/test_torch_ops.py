"""pggan_tpu_torch ops against the JAX package's, on the same numpy inputs.

f32 throughout; tolerance rtol=1e-5, atol=1e-5 (summation order of the
convolutions and of the tap-merged kernel differ between XLA and PyTorch).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pggan_tpu.ops import basic as jbasic
from pggan_tpu.ops import equalized as jeq
from pggan_tpu.ops import fused_scale as jfs
from pggan_tpu_torch.models.generator import fuses_upscale
from pggan_tpu_torch.ops import basic, equalized, fused_scale

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)      # channels_last view


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _conv_params(kernel, cin, cout, seed):
    """JAX-layout conv params with a nonzero bias, and their torch layout."""
    w = _rand((kernel, kernel, cin, cout), seed)
    b = _rand((cout,), seed + 1)
    scale = np.float32(equalized.he_constant(cin * kernel * kernel))
    jax_p = {"w": jnp.asarray(w), "b": jnp.asarray(b), "scale": jnp.asarray(scale)}
    torch_p = (torch.from_numpy(w).permute(3, 2, 0, 1), torch.from_numpy(b),
               torch.tensor(scale))
    return jax_p, torch_p


@pytest.mark.parametrize("kernel", [3, 1])
def test_equalized_conv2d(kernel):
    x = _rand((2, 8, 8, 16), seed=1)
    jp, tp = _conv_params(kernel, 16, 24, seed=2)
    want = np.asarray(jeq.equalized_conv2d(jp, jnp.asarray(x)))
    got = _nhwc(equalized.equalized_conv2d(_nchw(x), *tp))
    np.testing.assert_allclose(got, want, **TOL)


def test_equalized_linear():
    x = _rand((4, 32), seed=3)
    w, b = _rand((32, 48), seed=4), _rand((48,), seed=5)
    scale = np.float32(equalized.he_constant(32))
    want = np.asarray(jeq.equalized_linear(
        {"w": jnp.asarray(w), "b": jnp.asarray(b), "scale": jnp.asarray(scale)},
        jnp.asarray(x)))
    got = equalized.equalized_linear(torch.from_numpy(x), torch.from_numpy(w).t(),
                                     torch.from_numpy(b), torch.tensor(scale))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("form", ["dilated", "conv_of_upscale"])
def test_upscale_conv3x3_forms_match_jax_dilated(form):
    """Both torch forms of the block head equal the JAX package's dilated
    conv (and so `conv(upscale2d(x))`, which test_fused_scale pins)."""
    x = _rand((2, 5, 6, 12), seed=6)
    jp, tp = _conv_params(3, 12, 8, seed=7)
    want = np.asarray(jfs.upscale_conv3x3_dilated(jp, jnp.asarray(x)))
    if form == "dilated":
        got = fused_scale.upscale_conv3x3_dilated(_nchw(x), *tp)
    else:
        got = equalized.equalized_conv2d(basic.upscale2d(_nchw(x)), *tp)
    assert got.shape == (2, 8, 10, 12)
    np.testing.assert_allclose(_nhwc(got), want, **TOL)


def test_upscale2d_and_leaky_relu():
    x = _rand((2, 3, 5, 4), seed=8)
    np.testing.assert_array_equal(_nhwc(basic.upscale2d(_nchw(x))),
                                  np.asarray(jbasic.upscale2d(jnp.asarray(x))))
    np.testing.assert_array_equal(_nhwc(basic.leaky_relu(_nchw(x), 0.2)),
                                  np.asarray(jbasic.leaky_relu(jnp.asarray(x), 0.2)))


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0 - 1.0 / 600])
def test_blend(alpha):
    a, b = _rand((2, 4, 4, 3), seed=9), _rand((2, 4, 4, 3), seed=10)
    want = np.asarray(jbasic.blend(jnp.asarray(a), jnp.asarray(b), alpha))
    got = _nhwc(basic.blend(_nchw(a), _nchw(b), alpha))
    np.testing.assert_allclose(got, want, **TOL)


def test_blend_weights_stay_f32_under_bf16():
    """bf16(1 - 1/600) == 1.0; the weights must not be rounded to bf16."""
    a = torch.ones(1, 3, 2, 2, dtype=torch.bfloat16)
    out = basic.blend(a, torch.zeros_like(a), 1.0 - 1.0 / 600)
    assert out.dtype == torch.bfloat16
    assert float(out.float().max()) > 0.0


def test_layer_jax_round_trip_and_shape_check():
    layer = equalized.EqualizedConv2d(
        6, 5, 3, init_bias_to_zero=False, generator=torch.Generator().manual_seed(0))
    arrays = {f"c/{k}": v for k, v in layer.to_jax().items()}
    assert arrays["c/w"].shape == (3, 3, 6, 5) and arrays["c/scale"].shape == ()
    other = equalized.EqualizedConv2d(6, 5, 3, generator=torch.Generator())
    other.load_jax(arrays, "c")
    for key, value in other.to_jax().items():
        np.testing.assert_array_equal(value, arrays[f"c/{key}"])
    arrays["c/w"] = arrays["c/w"][:, :, :4]
    with pytest.raises(ValueError, match="shape mismatch"):
        other.load_jax(arrays, "c")


@pytest.mark.parametrize("fused, cout, want", [
    ("dilated", 512, True), (True, 512, True), (False, 16, False),
    (None, 16, False), ("auto", 64, True), ("auto", 128, False),
    (64, 64, True), (64, 128, False),
])
def test_fused_scale_values_map_onto_two_forms(fused, cout, want):
    assert fuses_upscale(fused, cout) is want


def test_downscale2d():
    x = _rand((2, 8, 6, 5), seed=11)
    want = np.asarray(jbasic.downscale2d(jnp.asarray(x)))
    got = basic.downscale2d(_nchw(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(got), want, **TOL)
    ints = np.random.RandomState(12).randint(0, 256, (1, 4, 4, 3)).astype(np.uint8)
    np.testing.assert_allclose(
        _nhwc(basic.downscale2d(torch.from_numpy(ints).permute(0, 3, 1, 2))),
        np.asarray(jbasic.downscale2d(jnp.asarray(ints))), **TOL)


@pytest.mark.parametrize("n", [8, 6, 1])
def test_minibatch_stddev(n):
    """Subgroups of 4, of N when N % 4 != 0, and the zero channel at N == 1;
    the port's channel is last, as in the JAX package."""
    x = _rand((n, 4, 4, 6), seed=13 + n)
    want = np.asarray(jbasic.minibatch_stddev(jnp.asarray(x)))
    got = basic.minibatch_stddev(_nchw(x))
    assert got.shape == (n, 7, 4, 4)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(got), want, **TOL)
