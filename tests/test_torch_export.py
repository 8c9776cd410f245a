"""The port's serving artifact (`pggan_tpu_torch/export.py`) on the CPU,
against the eager port G and JAX `generator_apply`, with the [16, 16, 8]
generator of tests/test_export.py: one symbolic-batch artifact at batches
1, 3 and 8; a pinned batch; alpha baked in; `sample`'s uint8; a forwarded
`last_activation`; the kernel nodes in the graph; and a fresh process that
loads the artifact with only the operator registrations imported."""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pggan_tpu.models import generator_apply, init_generator_params
from pggan_tpu.utils import checkpoint as jax_ckpt
from pggan_tpu_torch.export import export_generator, load_exported, sample
from pggan_tpu_torch.models.generator import params_from_jax
from pggan_tpu_torch.utils.image import denorm_to_uint8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTHS, LATENT, SCALE = [16, 16, 8], 32, 1


def _z(batch, seed=0):
    return np.random.RandomState(seed).randn(batch, LATENT).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    """The JAX package's G params at scale 1 (8×8), as checkpoint arrays."""
    tree = init_generator_params(jax.random.PRNGKey(0), latent_dim=LATENT, depths=DEPTHS,
                                 scale=SCALE)
    return tree, jax_ckpt.tree_to_arrays(tree)


@pytest.fixture(scope="module")
def artifact(params, tmp_path_factory):
    """One symbolic-batch artifact at alpha 0.7, written to a file, and a
    fresh process started on it (`test_a_fresh_process_serves_it`), which
    runs while the other tests do."""
    path = str(tmp_path_factory.mktemp("export") / "g.pt2")
    data = export_generator(params[1], latent_dim=LATENT, alpha=0.7, path=path, device="cpu")
    with open(path, "rb") as f:
        assert f.read() == data
    child = (
        "import json, sys, torch\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import pggan_tpu_torch.ops.kernels\n"
        f"program = torch.export.load({path!r})\n"
        f"z = torch.tensor({_z(3, 4).tolist()!r})\n"
        "print(json.dumps(program.module()(z).tolist()))\n")
    proc = subprocess.Popen([sys.executable, "-c", child], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield path, proc
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def pinned(params):
    """A batch-4 artifact at alpha 0.1 with a tanh output."""
    return load_exported(export_generator(params[1], latent_dim=LATENT, alpha=0.1, batch=4,
                                          device="cpu", last_activation="tanh")).module()


@functools.partial(jax.jit, static_argnames="last_activation")
def _jax_apply(tree, z, alpha, last_activation=None):
    return generator_apply(tree, z, alpha, last_activation=last_activation)


def _jax(tree, z, alpha, **kwargs):
    return np.asarray(_jax_apply(tree, jnp.asarray(z), jnp.float32(alpha), **kwargs))


def test_symbolic_batch_matches_eager_and_jax(params, artifact):
    tree, arrays = params
    module = load_exported(artifact[0]).module()
    eager = params_from_jax(arrays)
    for batch in (1, 3, 8):
        z = _z(batch, batch)
        with torch.no_grad():
            got = module(torch.from_numpy(z))
            want = eager(torch.from_numpy(z), 0.7)
        assert got.shape == (batch, 8, 8, 3) and got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), _jax(tree, z, 0.7), rtol=1e-5, atol=1e-5)


def test_pinned_batch_rejects_other_batch(pinned):
    assert pinned(torch.zeros(4, LATENT)).shape == (4, 8, 8, 3)
    with pytest.raises(Exception, match=r"(?i)size|shape|dim"):
        pinned(torch.zeros(2, LATENT))


def test_alpha_is_baked(params, artifact, pinned):
    """Each artifact computes G at the alpha it was exported with."""
    tree, arrays = params
    z = _z(4, 9)
    with torch.no_grad():
        at_07 = load_exported(artifact[0]).module()(torch.from_numpy(z))
        at_01 = pinned(torch.from_numpy(z))
        eager = params_from_jax(arrays, last_activation="tanh")
        torch.testing.assert_close(at_01, eager(torch.from_numpy(z), 0.1), rtol=1e-5, atol=1e-5)
        assert not torch.allclose(at_01, eager(torch.from_numpy(z), 0.7))
    np.testing.assert_allclose(at_07.numpy(), _jax(tree, z, 0.7), rtol=1e-5, atol=1e-5)


def test_sample_returns_uint8(params, artifact):
    z = _z(2, 5)
    images = sample(artifact[0], z)
    assert images.dtype == np.uint8 and images.shape == (2, 8, 8, 3)
    with torch.no_grad():
        want = denorm_to_uint8(params_from_jax(params[1])(torch.from_numpy(z), 0.7)).numpy()
    assert np.abs(images.astype(int) - want.astype(int)).max() <= 1


def test_last_activation_is_forwarded(params, pinned):
    z = _z(4, 3)
    want = _jax(params[0], z, 0.1, last_activation="tanh")
    np.testing.assert_allclose(pinned(torch.from_numpy(z)).numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.all(np.abs(want) <= 1.0)


def test_graph_holds_the_kernel_nodes(artifact):
    targets = [str(node.target) for node in load_exported(artifact[0]).graph.nodes
               if node.op == "call_function"]
    assert targets.count("pggan.pixel_norm.default") == 2
    assert targets.count("pggan.lrelu_pixel_norm.default") == 2 * SCALE + 1


def test_a_fresh_process_serves_it(params, artifact):
    """The artifact needs the operator registrations, not the model code:
    the child imports `pggan_tpu_torch.ops.kernels`, loads the program and
    calls it on three latents."""
    out, err = artifact[1].communicate(timeout=300)
    assert artifact[1].returncode == 0, err[-2000:]
    got = np.asarray(json.loads(out.strip().splitlines()[-1]), np.float32)
    with torch.no_grad():
        want = params_from_jax(params[1])(torch.from_numpy(_z(3, 4)), 0.7).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
