"""pggan_tpu_torch kernel wrappers against the JAX package's Pallas kernels.

The CUDA kernels run only on the card (`chip_smoke.py` holds each against
its plain version there). Here each plain version — what the wrapper runs on
a CPU tensor — is held against the Pallas function it replaces, run in
interpret mode as `tests/test_pallas.py` does, on the same numpy inputs.
Tolerance rtol=1e-5, atol=1e-6: both are f32 throughout and differ only in
the order of the channel sum.
"""

import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl

from pggan_tpu.ops import pallas_kernels as pk
from pggan_tpu_torch.ops import kernels

_pallas_call = functools.partial(pl.pallas_call)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(_pallas_call, interpret=True))


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy → NCHW channels_last tensor (a view of the same bytes)."""
    t = torch.from_numpy(a)
    return t.permute(0, 3, 1, 2) if t.ndim == 4 else t


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()


@pytest.mark.parametrize("shape", [(4, 8, 8, 32), (16, 512), (2, 4, 4, 513),
                                   (2, 3, 3, 16)])
def test_pixel_norm_plain_matches_pallas(shape):
    x = _rand(shape, seed=len(shape) + shape[-1])
    want = np.asarray(pk.pixel_norm(jnp.asarray(x), 1e-8))
    got = _to_numpy(kernels.pixel_norm_plain(_to_torch(x), 1e-8))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 8, 8, 32), (16, 512), (2, 4, 4, 96)])
def test_lrelu_pixel_norm_plain_matches_pallas(shape):
    x = _rand(shape, seed=7 + shape[-1])
    want = np.asarray(pk.lrelu_pixel_norm(jnp.asarray(x), 0.2, 1e-8))
    got = _to_numpy(kernels.lrelu_pixel_norm_plain(_to_torch(x), 0.2, 1e-8))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cpu_wrappers_run_plain_and_launch_nothing():
    x = _to_torch(_rand((2, 4, 4, 24), seed=3))
    kernels.reset_launch_counts()
    assert torch.equal(kernels.pixel_norm(x), kernels.pixel_norm_plain(x))
    assert torch.equal(kernels.lrelu_pixel_norm(x, 0.2),
                       kernels.lrelu_pixel_norm_plain(x, 0.2))
    assert kernels.launches == {"pixel_norm": 0, "lrelu_pixel_norm": 0}


def test_plain_keeps_dtype_and_layout():
    x = _to_torch(_rand((2, 4, 4, 24), seed=4)).to(torch.bfloat16)
    y = kernels.lrelu_pixel_norm_plain(x)
    assert y.dtype == torch.bfloat16
    assert y.is_contiguous(memory_format=torch.channels_last)


def test_kernel_rows_accepts_channels_last_and_latent():
    x = _to_torch(_rand((2, 3, 3, 16), seed=5))
    assert kernels.kernel_rows(x) == (18, 16)
    assert kernels.kernel_rows(torch.zeros(16, 512)) == (16, 512)
    assert kernels.kernel_rows(torch.zeros(2, 4, 4, 4, dtype=torch.bfloat16)
                               .to(memory_format=torch.channels_last)) == (32, 4)


@pytest.mark.parametrize("make, error", [
    (lambda: torch.zeros(2, 16, 3, 3), ValueError),                 # NCHW-contiguous
    (lambda: torch.zeros(16, 512)[:, ::2], ValueError),             # strided latent
    (lambda: torch.zeros(2, 3, 16), ValueError),                    # 3-D
    (lambda: torch.zeros(16, 512, dtype=torch.float16), TypeError),
    (lambda: torch.zeros(16, 512, requires_grad=True), RuntimeError),
])
def test_kernel_rows_refuses(make, error):
    """The launch path's checks raise rather than copy or fall back."""
    with pytest.raises(error):
        kernels.kernel_rows(make())


def test_launch_refuses_non_cuda_device():
    x = torch.zeros(16, 512, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kernels.pixel_norm(x)
