"""The port's discriminator against JAX `discriminator_apply`, on weights
that JAX initialised and images made with numpy.

f32; tolerance atol=rtol=1e-4 on logits of magnitude up to about 3: the
difference is summation order in the convolutions and linear layers,
compounded over the blocks. `impl="pallas"` runs the minibatch-stddev
Pallas kernel in interpret mode, as tests/test_pallas.py does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pggan_tpu.models.discriminator import (discriminator_apply,
                                            init_discriminator_params)
from pggan_tpu.utils.checkpoint import tree_to_arrays
from pggan_tpu_torch.models.discriminator import Discriminator, params_from_jax
from pggan_tpu_torch.ops.equalized import params_to_jax

DEPTHS, BATCH = [16, 16, 8], 8
TOL = dict(rtol=1e-4, atol=1e-4)
_pallas_call = functools.partial(pl.pallas_call)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(_pallas_call, interpret=True))


@functools.lru_cache(maxsize=None)
def _jax_params(scale):
    params = init_discriminator_params(jax.random.PRNGKey(4), depths=DEPTHS,
                                       scale=scale, init_bias_to_zero=False)
    return params, tree_to_arrays(params)


def _images(res, seed=0):
    return np.random.RandomState(seed).uniform(
        -1, 1, (BATCH, res, res, 3)).astype(np.float32)


@pytest.mark.parametrize("impl, scale", [("xla", 2), ("pallas", 2), ("xla", 0)])
def test_matches_discriminator_apply(impl, scale):
    params, arrays = _jax_params(scale)
    port = params_from_jax(arrays)
    assert port.scale == scale
    res = 4 * 2 ** scale
    x = _images(res, seed=scale)
    want = np.asarray(jax.jit(lambda p, v: discriminator_apply(
        p, v, jnp.float32(0.3), impl=impl))(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), 0.3).numpy()
    assert got.shape == want.shape == (BATCH, 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_params_round_trip():
    _, arrays = _jax_params(2)
    back = params_to_jax(params_from_jax(arrays))
    assert set(back) == set(arrays)
    for key, value in arrays.items():
        assert back[key].dtype == value.dtype, key
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_port_params_load_into_jax_template():
    """The port's arrays fill the JAX package's pytree of the same scale,
    and JAX's forward on them equals the port's."""
    from pggan_tpu.utils.checkpoint import arrays_to_tree
    port = Discriminator(depths=DEPTHS, scale=1, seed=3, init_bias_to_zero=False)
    template, _ = _jax_params(1)
    params = arrays_to_tree(template, params_to_jax(port))
    x = _images(8, seed=5)
    want = np.asarray(jax.jit(lambda p, v: discriminator_apply(
        p, v, jnp.float32(0.7)))(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), 0.7).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_growth_matches_fresh_init_and_differs_from_g():
    grown = Discriminator(depths=DEPTHS, scale=1, seed=5)
    grown.grow()
    fresh = Discriminator(depths=DEPTHS, scale=2, seed=5)
    a, b = params_to_jax(grown), params_to_jax(fresh)
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert not np.array_equal(a["fromrgb/0/w"],
                              params_to_jax(Discriminator(depths=DEPTHS, seed=6))
                              ["fromrgb/0/w"])
    with pytest.raises(ValueError, match="at most"):
        fresh.grow()


def test_input_is_viewed_without_a_copy_and_stddev_can_be_off():
    """NHWC images reach the first conv as channels_last NCHW, and without
    the minibatch-stddev channel last_conv takes d0 channels."""
    port = Discriminator(depths=DEPTHS, scale=1, apply_minibatch_norm=False)
    assert port.last_conv.weight.shape[1] == DEPTHS[0]
    seen = []
    port.fromrgb[-1].register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    x = torch.from_numpy(_images(8))
    with torch.no_grad():
        out = port(x, 1.0)
    assert out.shape == (BATCH, 1) and bool(torch.isfinite(out).all())
    assert seen[0].data_ptr() == x.data_ptr()
    assert seen[0].is_contiguous(memory_format=torch.channels_last)
