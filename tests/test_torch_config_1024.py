"""`configs/config_1024.yaml` (1024², nine depths, `batch_schedule {7: 32,
8: 16}`) in the port against the JAX package, on the CPU.

The config loads to the same values and the same keys set by the user; the
per-rank batch at scales 6-8 follows the JAX mesh's rule; G and D built at
scale 8 (1024²) at narrow widths, batch 2, match JAX `generator_apply` and
`discriminator_apply` on JAX's weights (f32); and growing G and D from
scale 6 to 8 gives the networks built at scale 8.

Tolerances: D within 1e-5 (the convolutions' summation order). G's output
within 1e-3 absolute on values up to about 4, and all but 1e-5 of the
values within 1e-4: the summation order again, which pixel norm amplifies
at the few pixels whose 8 or 16 channels are all near 0 (the rsqrt of a
small mean square); the largest difference seen was 1.3e-4 at these widths.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pggan_tpu import Config as JaxConfig
from pggan_tpu.models.discriminator import discriminator_apply, init_discriminator_params
from pggan_tpu.models.generator import generator_apply, init_generator_params
from pggan_tpu.parallel.mesh import global_batch_size as jax_global_batch_size
from pggan_tpu.utils.checkpoint import tree_to_arrays
from pggan_tpu_torch.config import Config
from pggan_tpu_torch.models import discriminator as port_d
from pggan_tpu_torch.models import generator as port_g
from pggan_tpu_torch.parallel.mesh import local_batch_size

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "config_1024.yaml")
NARROW = [16, 16, 16, 16, 16, 16, 8, 8, 8]        # nine depths, as the config's
LATENT, BATCH, SCALE = 8, 2, 8


def test_config_1024_loads_as_in_jax():
    ours, theirs = Config.from_yaml(CONFIG), JaxConfig.from_yaml(CONFIG)
    assert ours.explicit_keys() == theirs.explicit_keys()
    assert dict(ours) == theirs.to_dict()
    assert ours.depths == [512, 512, 512, 512, 256, 128, 64, 32, 16]
    assert ours.compute_dtype == "bfloat16" and ours.loss_mode == "r1"
    assert int(ours.r1_interval) == 1 and len(ours.max_step_at_scale) == 9


@pytest.mark.parametrize("world", [1, 2, 4])
def test_local_batch_size_follows_the_jax_rule(world):
    cfg, jax_cfg = Config.from_yaml(CONFIG), JaxConfig.from_yaml(CONFIG)
    for scale in (6, 7, 8):
        want = (jax_global_batch_size(jax_cfg, None, scale) if scale in (7, 8)
                else int(jax_cfg.batch_per_gpu) * world)
        assert local_batch_size(cfg, world, scale) * world == want
    assert [local_batch_size(cfg, 1, s) for s in (6, 7, 8)] == [16, 32, 16]


def test_generator_at_1024_matches_generator_apply():
    params = init_generator_params(jax.random.PRNGKey(3), latent_dim=LATENT, depths=NARROW,
                                   scale=SCALE, init_bias_to_zero=False)
    z = np.random.RandomState(0).randn(BATCH, LATENT).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: generator_apply(p, v, jnp.float32(0.5)))(
        params, jnp.asarray(z)))
    port = port_g.params_from_jax(tree_to_arrays(params))
    assert port.scale == SCALE and port.resolution == 1024
    with torch.no_grad():
        got = port(torch.from_numpy(z), 0.5).numpy()
    assert got.shape == want.shape == (BATCH, 1024, 1024, 3)
    delta = np.abs(got - want)
    assert delta.max() < 1e-3 and np.mean(delta > 1e-4) < 1e-5


def test_discriminator_at_1024_matches_discriminator_apply():
    params = init_discriminator_params(jax.random.PRNGKey(4), depths=NARROW, scale=SCALE,
                                       init_bias_to_zero=False)
    x = np.random.RandomState(1).uniform(-1, 1, (4, 1024, 1024, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: discriminator_apply(p, v, jnp.float32(0.3)))(
        params, jnp.asarray(x)))
    port = port_d.params_from_jax(tree_to_arrays(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x), 0.3).numpy()
    assert got.shape == want.shape == (4, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_growth_from_6_to_8_builds_the_scale_8_networks():
    grown_g = port_g.Generator(latent_dim=LATENT, depths=NARROW, scale=6, seed=5)
    grown_d = port_d.Discriminator(depths=NARROW, scale=6, seed=5)
    for _ in range(2):
        grown_g.grow()
        grown_d.grow()
    built_g = port_g.Generator(latent_dim=LATENT, depths=NARROW, scale=8, seed=5)
    built_d = port_d.Discriminator(depths=NARROW, scale=8, seed=5)
    for grown, built in ((grown_g, built_g), (grown_d, built_d)):
        assert grown.scale == 8
        want = built.state_dict()
        assert list(grown.state_dict()) == list(want)
        for key, value in grown.state_dict().items():
            torch.testing.assert_close(value, want[key], rtol=0, atol=0, msg=key)
    with pytest.raises(ValueError, match="at most 8 blocks"):
        grown_g.grow()
