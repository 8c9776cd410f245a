"""The port's generative metrics against the JAX package's, on the CPU.

KID and the host Fréchet distance are float64 numpy in both packages (the
port keeps its own copies): rtol 1e-10. The rest is f32 with sums in other
orders: the Newton–Schulz Fréchet distance at D = 64 rtol 1e-4 (30 f32
matmul iterations); `RandomConvFeatures` atol 1e-5 on features of order 1
(seen 9.5e-7), on even sizes (where XLA's "SAME" pads (0, 1)), odd ones and
1×1; the resize atol 1e-5 (seen 1.8e-6); InceptionV3 at 75×75 (the
smallest input that reaches 1×1 after Mixed_7a) 1e-5 of the largest
feature (seen 1.7e-6), from one npz of numpy-random arrays of the JAX
template's shapes that both packages' extractors load.

JAX's `init_inception_v3` is never called (it takes tens of seconds
eagerly on a CPU): the template comes from `jax.eval_shape`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pggan_tpu.metrics import fid as jax_fid
from pggan_tpu.metrics import inception as jax_inception
from pggan_tpu.metrics import kid as jax_kid
from pggan_tpu.utils.checkpoint import _path_str
from pggan_tpu_torch.metrics import fid, inception, kid

F64 = dict(rtol=1e-10, atol=1e-12)


def _features(seed, n, d, shift=0.0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, d) @ rs.randn(d, d) * 0.3 + shift).astype(np.float32)


@pytest.mark.parametrize("n_real, n_fake", [(40, 40), (50, 30)])
def test_kid_matches_jax(n_real, n_fake):
    """Equal sides of at most subset_size: one evaluation, std 0; unequal
    sides: 100 subsets clamped to the smaller side."""
    real, fake = _features(0, n_real, 16), _features(1, n_fake, 16, 0.2)
    np.testing.assert_allclose(kid.polynomial_kernel(real, fake),
                               jax_kid.polynomial_kernel(real, fake), **F64)
    assert kid.mmd2_unbiased(real, fake) == pytest.approx(
        jax_kid.mmd2_unbiased(real, fake), rel=1e-10)
    for subset in (1000, 35):
        got = kid.kid_between_features(real, fake, subset_size=subset)
        want = jax_kid.kid_between_features(real, fake, subset_size=subset)
        np.testing.assert_allclose(got, want, **F64)
        assert (got[1] == 0.0) == (n_real == n_fake <= subset)
    with pytest.raises(ValueError):
        kid.mmd2_unbiased(real[:1], fake)


def test_frechet_distances_match_jax():
    """The host distance on a rank-deficient pair (n < D), float64; the
    device distance at D = 64 in f32."""
    for d, n in ((32, 20), (64, 300)):
        a, b = _features(2, n, d), _features(3, n, d, 0.1)
        stats = (a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False))
        got = fid.frechet_distance(*stats)
        assert got == pytest.approx(jax_fid.frechet_distance(*stats), rel=1e-10)
        if d == 64:
            want = float(jax_fid.frechet_distance_device(*(jnp.asarray(s, jnp.float32)
                                                           for s in stats)))
            dev = fid.frechet_distance_device(*(torch.tensor(s, dtype=torch.float32)
                                                for s in stats))
            assert dev.dtype == torch.float32 and dev.ndim == 0
            np.testing.assert_allclose(float(dev), want, rtol=1e-4)


def _random_conv_pair(feature_dim=64):
    """JAX's RandomConvFeatures and the port's with JAX's weights carried."""
    theirs = jax_fid.RandomConvFeatures(feature_dim=feature_dim)
    mine = fid.RandomConvFeatures(feature_dim=feature_dim, device="cpu")
    with torch.no_grad():
        for w, hwio in zip(mine.weights, theirs.params):
            w.copy_(torch.from_numpy(np.array(hwio).transpose(3, 2, 0, 1)))
    return theirs, mine


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (2, 17, 17, 3), (3, 9, 12, 3), (1, 1, 1, 3)])
def test_random_conv_features_match_jax(shape):
    assert fid.same_pads(16, 3, 2) == (0, 1) and fid.same_pads(17, 3, 2) == (1, 1)
    theirs, mine = _random_conv_pair()
    x = np.random.RandomState(4).uniform(-1, 1, shape).astype(np.float32)
    want = np.asarray(theirs(jnp.asarray(x)))
    got = mine(torch.from_numpy(x))
    assert got.shape == want.shape == (shape[0], 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_compute_activations_and_fid_match_jax():
    """uint8 batches with a ragged last batch and max_samples, through the
    port's streaming extraction and JAX's, then FID and KID of the sets."""
    theirs, mine = _random_conv_pair()
    rs = np.random.RandomState(5)
    real = [rs.randint(0, 256, (b, 12, 12, 3), dtype=np.uint8) for b in (8, 8, 5)]
    fake = [rs.uniform(-1, 1, (8, 12, 12, 3)).astype(np.float32) for _ in range(3)]
    f_real = fid.compute_activations(real, mine)
    np.testing.assert_allclose(f_real, jax_fid.compute_activations(real, theirs),
                               rtol=0, atol=1e-5)
    f_fake = fid.compute_activations(iter(fake), mine, max_samples=20)
    assert f_real.shape == (21, 64) and f_fake.shape == (20, 64) and f_real.dtype == np.float32
    np.testing.assert_allclose(f_fake, jax_fid.compute_activations(fake, theirs,
                                                                   max_samples=20),
                               rtol=0, atol=1e-5)
    got = fid.fid_between_sets(real, fake, mine, max_samples=20)
    want = jax_fid.fid_between_sets(real, fake, theirs, max_samples=20)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    got_kid = kid.kid_between_sets(real, fake, mine, max_samples=20, subset_size=10)
    want_kid = jax_kid.kid_between_sets(real, fake, theirs, max_samples=20, subset_size=10)
    np.testing.assert_allclose(got_kid, want_kid, rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("size_in, size_out", [(8, 19), (32, 75), (20, 7)])
def test_resize_matches_jax_image_resize(size_in, size_out):
    x = np.random.RandomState(6).uniform(-1, 1, (2, size_in, size_in, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, size_out, size_out, 3), "bilinear",
                            antialias=False)
    got = inception.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), size_out)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def inception_npz(tmp_path_factory):
    """numpy-random arrays of the JAX template's shapes (BatchNorm variances
    positive) saved as one `fid_weights` npz, and a batch of 75×75 inputs."""
    template = jax.eval_shape(jax_inception.init_inception_v3, jax.random.PRNGKey(0))
    rs = np.random.RandomState(7)
    arrays = {}
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(template)[0]:
        key, shape = _path_str(keypath), leaf.shape
        if key.endswith("/w"):
            value = rs.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:3]))
        elif key.endswith(("/var", "/scale")):
            value = rs.uniform(0.5, 1.5, shape)
        else:
            value = rs.randn(*shape) * 0.1
        arrays[key] = value.astype(np.float32)
    path = tmp_path_factory.mktemp("inception") / "fid_weights.npz"
    np.savez(path, **arrays)
    x = rs.uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    return template, arrays, str(path), x


def test_inception_matches_jax_from_one_npz(inception_npz, monkeypatch):
    """Both packages' InceptionV3Features load the same npz (JAX's
    strict `arrays_to_tree` onto its template, the port's strict key
    bridge) and give the same pool3 features at 75×75, batch 2."""
    template, arrays, path, x = inception_npz
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), template)
    monkeypatch.setattr(jax_inception, "init_inception_v3", lambda rng: zeros)
    theirs = jax_inception.InceptionV3Features(weights=path, resize=False)
    want = np.asarray(jax.jit(lambda p, im: jax_inception.inception_v3_features(
        p, im, resize=False))(theirs.params, jnp.asarray(x)))
    mine = inception.InceptionV3Features(weights=path, resize=False, device="cpu")
    assert not any(p.requires_grad for p in mine.parameters())
    with torch.inference_mode():
        got = mine(torch.from_numpy(x))
    assert got.shape == want.shape == (2, inception.FEATURE_DIM) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())

    # the bridge is strict: a missing and an unknown key both raise
    broken = dict(arrays)
    broken["Mixed_5b/branch1x1/extra"] = broken.pop("Mixed_5b/branch1x1/w")
    with pytest.raises(KeyError, match="Mixed_5b/branch1x1/w"):
        inception.load_jax_arrays(mine, broken)


def test_inception_fixed_seed_init_and_torchvision_keys(inception_npz):
    """The port's fixed-seed arrays have the JAX template's keys and shapes,
    He-normal convs and identity BatchNorm; the port's state_dict
    (torchvision's module names) converts back to the npz arrays."""
    _, arrays, path, _ = inception_npz
    mine = inception.InceptionV3Features(weights=path, device="cpu")
    init = inception.init_inception_v3(mine, seed=2020)
    assert set(init) == set(arrays)
    for key, value in init.items():
        assert value.shape == arrays[key].shape, key
    w = init["Mixed_7c/branch3x3dbl_1/w"]
    assert abs(w.std() - np.sqrt(2.0 / 2048)) < 0.02 * w.std()
    assert np.all(init["Mixed_7c/branch_pool/bn/var"] == 1.0)
    assert np.all(init["Mixed_7c/branch_pool/bn/mean"] == 0.0)
    converted = inception.convert_torchvision_state_dict(mine.state_dict())
    want = jax_inception.convert_torchvision_state_dict(mine.state_dict())
    assert set(converted) == set(want) == set(arrays)
    for key in arrays:
        np.testing.assert_array_equal(converted[key], want[key], err_msg=key)
        np.testing.assert_array_equal(converted[key], arrays[key], err_msg=key)
