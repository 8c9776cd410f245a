"""The port's loss zoo (`pggan_tpu_torch/losses/gan.py`) against the JAX
package's (`pggan_tpu/losses/gan.py:41-50,113-166`) on numpy-seeded inputs,
f32 on the CPU, rtol 1e-6 (the same f32 formulas; seen within a few ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pggan_tpu.losses import gan as jgan
from pggan_tpu_torch.losses import gan

B = 6
RTOL = dict(rtol=1e-6)


def _inputs(seed):
    rs = np.random.RandomState(seed)
    x = (3.0 * rs.randn(B, 1)).astype(np.float32)
    a, b = rs.randn(B, 3, 4, 4).astype(np.float32), rs.randn(B, 3, 4, 4).astype(np.float32)
    emb_a, emb_b = rs.randn(B, 16).astype(np.float32), rs.randn(B, 16).astype(np.float32)
    emb_b[0] = 0.0                                  # a norm at the clamp
    same = (rs.rand(B) > 0.5).astype(np.float32)
    feats_a = [rs.randn(B, c, s, s).astype(np.float32) for c, s in ((8, 4), (4, 8))]
    feats_b = [rs.randn(B, c, s, s).astype(np.float32) for c, s in ((8, 4), (4, 8))]
    return dict(x=x, a=a, b=b, emb_a=emb_a, emb_b=emb_b, same=same, feats_a=feats_a,
                feats_b=feats_b)


CASES = {
    "softplus_real": lambda m, d: m.softplus_loss(d["x"], True),
    "softplus_fake": lambda m, d: m.softplus_loss(d["x"], False),
    "hinge_positive": lambda m, d: m.hinge_loss(d["x"], True),
    "hinge_negative": lambda m, d: m.hinge_loss(d["x"], False),
    "id": lambda m, d: m.id_loss(d["emb_a"], d["emb_b"]),
    "l1": lambda m, d: m.l1_loss(d["a"], d["b"]),
    "l2": lambda m, d: m.l2_loss(d["a"], d["b"]),
    "l1_same_person": lambda m, d: m.l1_loss_with_same_person(d["a"], d["b"], d["same"], B),
    "l2_same_person": lambda m, d: m.l2_loss_with_same_person(d["a"], d["b"], d["same"], B),
    "attr": lambda m, d: m.attr_loss(d["feats_a"], d["feats_b"], B),
}


def _convert(data, fn):
    return {k: [fn(x) for x in v] if isinstance(v, list) else fn(v) for k, v in data.items()}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_matches_jax(name, seed):
    data = _inputs(seed)
    want = float(CASES[name](jgan, _convert(data, jnp.asarray)))
    got = CASES[name](gan, _convert(data, torch.from_numpy))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, **RTOL)
