"""The port's generator against JAX `generator_apply`, on weights that JAX
initialised and latents made with numpy.

f32; tolerance atol=rtol=1e-4 on outputs of magnitude up to about 4 (the
largest difference seen on the CPU is about 1.3e-5): the difference is
summation order in the convolutions, compounded over the blocks. `impl="pallas"` runs the
Pallas kernels in interpret mode, as tests/test_pallas.py does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pggan_tpu.models.generator import generator_apply, init_generator_params
from pggan_tpu.utils.checkpoint import tree_to_arrays
from pggan_tpu_torch.models.generator import (Generator, params_from_jax,
                                              params_to_jax)
from pggan_tpu_torch.ops import kernels

LATENT, DEPTHS, BATCH = 64, [64, 64, 32, 16], 4
TOL = dict(rtol=1e-4, atol=1e-4)
_pallas_call = functools.partial(pl.pallas_call)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(_pallas_call, interpret=True))


@functools.lru_cache(maxsize=None)
def _jax_arrays(scale):
    params = init_generator_params(jax.random.PRNGKey(3), latent_dim=LATENT,
                                   depths=DEPTHS, scale=scale,
                                   init_bias_to_zero=False)
    return params, tree_to_arrays(params)


def _latent(seed=0):
    return np.random.RandomState(seed).randn(BATCH, LATENT).astype(np.float32)


def _jax_forward(scale, impl, fused_scale="dilated"):
    params, _ = _jax_arrays(scale)
    fn = jax.jit(lambda p, z, a: generator_apply(p, z, a, impl=impl,
                                                 fused_scale=fused_scale))
    return lambda z, alpha: np.asarray(fn(params, jnp.asarray(z),
                                          jnp.float32(alpha)))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_matches_generator_apply(impl):
    _, arrays = _jax_arrays(3)
    port = params_from_jax(arrays)
    jax_fwd = _jax_forward(3, impl)
    z = _latent()
    for alpha in (0.5, 1.0):
        with torch.no_grad():
            got = port(torch.from_numpy(z), alpha).numpy()
        want = jax_fwd(z, alpha)
        assert got.shape == want.shape == (BATCH, 32, 32, 3)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("scale, fused_scale", [(0, "dilated"), (2, False)])
def test_matches_generator_apply_other_branches(scale, fused_scale):
    """Scale 0 takes the no-blend branch; fused_scale=False takes
    conv(upscale2d(x)) in both packages."""
    _, arrays = _jax_arrays(scale)
    port = params_from_jax(arrays, fused_scale=fused_scale)
    z = _latent(seed=1)
    with torch.no_grad():
        got = port(torch.from_numpy(z), 0.25).numpy()
    want = _jax_forward(scale, "xla", fused_scale)(z, 0.25)
    np.testing.assert_allclose(got, want, **TOL)


def test_params_round_trip():
    _, arrays = _jax_arrays(3)
    back = params_to_jax(params_from_jax(arrays))
    assert set(back) == set(arrays)
    for key, value in arrays.items():
        assert back[key].dtype == value.dtype, key
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_growth_matches_fresh_init():
    grown = Generator(latent_dim=LATENT, depths=DEPTHS, scale=1, seed=5)
    grown.grow()
    fresh = Generator(latent_dim=LATENT, depths=DEPTHS, scale=2, seed=5)
    a, b = params_to_jax(grown), params_to_jax(fresh)
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    with pytest.raises(ValueError, match="at most"):
        Generator(latent_dim=LATENT, depths=DEPTHS, scale=3).grow()


def test_epilogues_meet_the_kernel_contract(monkeypatch):
    """Every pixel_norm / lrelu_pixel_norm call gets a tensor the CUDA
    kernels take as it is, 2 and 1 + 2·scale times per forward."""
    calls = {"pixel_norm": 0, "lrelu_pixel_norm": 0}

    def checked(name, fn):
        def wrapper(x, *args):
            kernels.kernel_rows(x)
            calls[name] += 1
            return fn(x, *args)
        return wrapper

    for name in calls:
        monkeypatch.setattr(kernels, name, checked(name, getattr(kernels, name)))
    port = Generator(latent_dim=LATENT, depths=DEPTHS, scale=3)
    with torch.no_grad():
        out = port(torch.from_numpy(_latent()), 0.5)
    assert calls == {"pixel_norm": 2, "lrelu_pixel_norm": 7}
    assert out.shape == (BATCH, 32, 32, 3) and out.is_contiguous()


def test_bf16_forward_tracks_f32():
    """bf16 activations: same shape, dtype bf16, finite, and within 0.1 of
    the f32 output (bf16 keeps ~3 significant digits; 7 layers compound)."""
    port = Generator(latent_dim=LATENT, depths=DEPTHS, scale=3, seed=1)
    z = torch.from_numpy(_latent(seed=2))
    with torch.no_grad():
        ref = port(z, 0.5)
        low = port(z, 0.5, compute_dtype=torch.bfloat16)
    assert low.dtype == torch.bfloat16 and low.shape == ref.shape
    assert bool(torch.isfinite(low.float()).all())
    np.testing.assert_allclose(low.float().numpy(), ref.numpy(), atol=0.1)
