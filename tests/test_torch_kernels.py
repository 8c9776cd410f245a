"""pggan_tpu_torch kernel wrappers against the JAX package's Pallas kernels.

The CUDA kernels run only on the card (`chip_smoke.py` holds each against
its plain version there). Here each plain version — what the wrapper runs on
a CPU tensor — and each autograd rule is held against the Pallas function
it replaces, run in interpret mode as `tests/test_pallas.py` does, or
against `jax.grad` of its JAX rule, on the same numpy inputs.
Tolerance rtol=1e-5, atol=1e-6 unless a test says otherwise: both are f32
throughout and differ only in the order of the sums.
"""

import functools

import numpy as np
import pytest
import torch
import jax
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
    assert torch.equal(kernels.bias_lrelu_gain(x, None, 0.2),
                       kernels.bias_lrelu_gain_plain(x, None, 0.2))
    assert set(kernels.launches) == {"pixel_norm", "lrelu_pixel_norm",
                                     "lrelu_pixel_norm_bwd", "minibatch_stddev_stat",
                                     "bias_lrelu_gain", "upfirdn2d"}
    assert all(n == 0 for n in kernels.launches.values())


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
])
def test_kernel_rows_refuses(make, error):
    """The launch path's checks raise rather than copy or fall back."""
    with pytest.raises(error):
        kernels.kernel_rows(make())


def test_launch_refuses_non_cuda_device():
    x = torch.zeros(16, 512, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kernels.pixel_norm(x)


@pytest.mark.parametrize("shape", [(4, 8, 8, 32), (16, 512), (2, 4, 4, 513),
                                   (2, 3, 3, 16), (2, 4, 4, 64), (2, 2, 2, 128),
                                   (1, 2, 2, 256)])
def test_lrelu_pixel_norm_bwd_plain_matches_pallas(shape):
    """The plain backward against `_lrelu_pn_bwd_rule` (the Pallas backward
    kernel, interpret mode) on the same x and cotangent g, at the widths
    whose branch on the card is the vector one (C = 64-512) and ragged ones."""
    x, g = _rand(shape, seed=11 + shape[-1]), _rand(shape, seed=12 + shape[-1])
    (want,) = pk._lrelu_pn_bwd_rule(0.2, 1e-8, jnp.asarray(x), jnp.asarray(g))
    got = kernels.lrelu_pixel_norm_bwd_plain(_to_torch(x), _to_torch(g), 0.2, 1e-8)
    np.testing.assert_allclose(_to_numpy(got), np.asarray(want), rtol=1e-5, atol=1e-6)


def _vjp_of(fn, x: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Gradient through the port's autograd rule (the CPU path)."""
    xt = _to_torch(x.copy()).requires_grad_(True)
    (dx,) = torch.autograd.grad(fn(xt), xt, _to_torch(g))
    return _to_numpy(dx)


def test_lrelu_pixel_norm_grad_matches_jax_rule():
    """The gradient through `kernels.lrelu_pixel_norm` (the autograd rule
    whose backward is the backward kernel on the card) equals jax.vjp of
    the Pallas custom_vjp."""
    x, g = _rand((2, 4, 4, 24), seed=13), _rand((2, 4, 4, 24), seed=14)
    _, vjp = jax.vjp(lambda v: pk.lrelu_pixel_norm(v, 0.2, 1e-8), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    got = _vjp_of(lambda t: kernels.lrelu_pixel_norm(t, 0.2), x, g)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    # an input that requires grad goes through the autograd rule
    y = kernels.lrelu_pixel_norm(_to_torch(x.copy()).requires_grad_(True), 0.2)
    assert type(y.grad_fn).__name__ == "_LreluPixelNormBackward"


def test_pixel_norm_grads_match_jax_jvp():
    """First and second derivatives through `kernels.pixel_norm` against
    jax.grad of the Pallas custom_jvp's rule."""
    x, w = _rand((16, 40), seed=15), _rand((16, 40), seed=16)
    v = _rand((16, 40), seed=17)

    def jax_grad(a):
        return jax.grad(lambda t: jnp.vdot(jnp.asarray(w), pk.pixel_norm(t, 1e-8)))(a)
    want1 = np.asarray(jax_grad(jnp.asarray(x)))
    want2 = np.asarray(jax.grad(lambda a: jnp.vdot(jnp.asarray(v), jax_grad(a)))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    y = kernels.pixel_norm(xt)
    assert type(y.grad_fn).__name__ == "_PixelNormBackward"    # the autograd rule
    (g1,) = torch.autograd.grad((y * torch.from_numpy(w)).sum(), xt, create_graph=True)
    (g2,) = torch.autograd.grad((g1 * torch.from_numpy(v)).sum(), xt)
    np.testing.assert_allclose(g1.detach().numpy(), want1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g2.numpy(), want2, rtol=1e-4, atol=1e-5)


RULES = [("pixel_norm", "_PixelNorm"), ("lrelu_pixel_norm", "_LreluPixelNorm"),
         ("minibatch_stddev_stat", "_MinibatchStddevStat")]


def _extra_args(name):
    """minibatch_stddev_stat's subgroup size; the row kernels take none."""
    return (2,) if name == "minibatch_stddev_stat" else ()


@pytest.mark.parametrize("name, rule", RULES)
@pytest.mark.parametrize("mode", ["input without grad", "under no_grad"])
def test_forward_without_recording_skips_autograd_rule(monkeypatch, name, rule, mode):
    """When autograd will not record the call, the public forward calls the
    kernel wrapper directly: the rule's `apply` is not reached and the
    output has no grad_fn."""
    applied = []
    apply = getattr(kernels, rule).apply
    monkeypatch.setattr(getattr(kernels, rule), "apply",
                        lambda *a: applied.append(a) or apply(*a))
    x = _to_torch(_rand((2, 4, 4, 24), seed=18))
    args = _extra_args(name)
    if mode == "input without grad":
        y = getattr(kernels, name)(x, *args)
    else:
        with torch.no_grad():
            y = getattr(kernels, name)(x.requires_grad_(True), *args)
    assert y.grad_fn is None and not y.requires_grad
    assert not applied
    assert torch.equal(y, getattr(kernels, name + "_plain")(x.detach(), *args))


@pytest.mark.parametrize("name, rule", RULES)
def test_recording_call_goes_through_autograd_rule(monkeypatch, name, rule):
    """When autograd records the call (R1's double backward runs through
    minibatch_stddev_stat's rule), the public forward goes through the
    rule's `apply` once and the output's grad_fn is the rule's backward."""
    applied = []
    apply = getattr(kernels, rule).apply
    monkeypatch.setattr(getattr(kernels, rule), "apply",
                        lambda *a: applied.append(a) or apply(*a))
    x = _to_torch(_rand((2, 4, 4, 24), seed=19)).requires_grad_(True)
    args = _extra_args(name)
    y = getattr(kernels, name)(x, *args)
    assert len(applied) == 1
    assert type(y.grad_fn).__name__ == f"{rule}Backward"
    assert torch.equal(y.detach(), getattr(kernels, name + "_plain")(x.detach(), *args))


@pytest.mark.parametrize("name", ["pixel_norm", "lrelu_pixel_norm", "lrelu_pixel_norm_bwd"])
@pytest.mark.parametrize("shape", [(2, 24, 4, 4), (2, 24, 1, 1), (16, 40)])
def test_launch_output_strides_match_plain(monkeypatch, name, shape):
    """The launch path allocates its output with x's strides, which are the
    plain version's: for a channels_last 4-D input (H·W = 1 included, where
    the strides are ambiguous) and a contiguous [B, C] one. Meta tensors
    reach the allocation without a card; the launch itself is recorded."""
    monkeypatch.setattr(kernels, "_cuda_or_raise", lambda *a: None)
    calls = []
    monkeypatch.setattr(kernels, "_call", lambda *a: calls.append(a[:2]))
    x = torch.zeros(shape, device="meta")
    if x.ndim == 4:
        x = x.to(memory_format=torch.channels_last)
    args = (x, x) if name == "lrelu_pixel_norm_bwd" else (x,)
    got = getattr(kernels, name)(*args)
    want = getattr(kernels, name + "_plain")(*args)
    assert (got.shape, got.stride(), got.dtype) == (want.shape, want.stride(), want.dtype)
    assert calls == [(name, f"pggan_{name}" + ("" if name.endswith("bwd") else "_fwd"))]


MB_CASES = [((16, 4, 4, 32), 4), ((6, 4, 4, 16), 6), ((2, 4, 4, 8), 2),
            ((8, 24), 4)]


@pytest.mark.parametrize("fmt", [torch.channels_last, torch.contiguous_format])
def test_minibatch_stddev_launch_output(monkeypatch, fmt):
    """The launch path takes a channels_last or contiguous [N, C, H, W]
    tensor as [N, F] rows and allocates an f32 [N // sg] output on x's
    device. Meta tensors reach the allocation without a card; the launch
    itself is recorded."""
    monkeypatch.setattr(kernels, "_cuda_or_raise", lambda *a: None)
    calls = []
    monkeypatch.setattr(kernels, "_call", lambda *a: calls.append(a))
    x = torch.zeros(8, 4, 3, 3, device="meta", dtype=torch.bfloat16).to(memory_format=fmt)
    y = kernels.minibatch_stddev_stat(x, 4)
    assert (y.shape, y.dtype, y.device) == ((2,), torch.float32, x.device)
    ((name, entry, _, _, _, n, f, sg, dtype, _),) = calls
    assert (name, entry, n, f, sg, dtype) == ("minibatch_stddev_stat",
                                              "pggan_minibatch_stddev_stat", 8, 36, 4, 1)


@pytest.mark.parametrize("shape, sg", MB_CASES)
def test_minibatch_stddev_stat_plain_matches_pallas(shape, sg):
    x = _rand(shape, seed=20 + shape[0])
    want = np.asarray(pk.minibatch_stddev_stat(jnp.asarray(x), sg, 1e-8))
    got = kernels.minibatch_stddev_stat_plain(_to_torch(x), sg, 1e-8)
    assert got.dtype == torch.float32 and got.shape == (shape[0] // sg,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape, sg", MB_CASES[:3])
def test_minibatch_stddev_stat_derivatives_match_jax(shape, sg):
    """First and second derivatives of the port's autograd rule (its
    backward is torch ops, so R1's double backward composes) against
    jax.grad of the Pallas op's JVP. Second order at rtol 1e-4, atol 1e-5:
    it divides by std twice."""
    x = _rand(shape, seed=30 + shape[0])
    w = _rand((shape[0] // sg,), seed=31)
    v = _rand(shape, seed=32)

    def jax_grad(a):
        return jax.grad(lambda t: jnp.vdot(jnp.asarray(w),
                                           pk.minibatch_stddev_stat(t, sg, 1e-8)))(a)
    want1 = np.asarray(jax_grad(jnp.asarray(x)))
    want2 = np.asarray(jax.grad(lambda a: jnp.sum(jnp.asarray(v) * jax_grad(a)))(
        jnp.asarray(x)))
    xt = _to_torch(x.copy()).requires_grad_(True)
    stat = kernels.minibatch_stddev_stat(xt, sg)
    (g1,) = torch.autograd.grad((stat * torch.from_numpy(w)).sum(), xt, create_graph=True)
    (g2,) = torch.autograd.grad((g1 * _to_torch(v)).sum(), xt)
    np.testing.assert_allclose(_to_numpy(g1.detach()), want1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_to_numpy(g2), want2, rtol=1e-4, atol=1e-5)


def _meta(fmt=torch.channels_last, dtype=torch.float32):
    return torch.zeros(2, 4, 3, 3, device="meta", dtype=dtype).to(memory_format=fmt)


@pytest.mark.parametrize("call, error, match", [
    (lambda: kernels.minibatch_stddev_stat(torch.zeros(6, 8), 4), ValueError, "divide"),
    (lambda: kernels.minibatch_stddev_stat(torch.zeros(4, 8), 1), ValueError, "divide"),
    (lambda: kernels.kernel_samples(torch.zeros(4, 8, 2, 2)[:, ::2], 4), ValueError,
     "contiguous"),
    (lambda: kernels.kernel_samples(torch.zeros(4, 8, dtype=torch.float16), 4),
     TypeError, "float32"),
    (lambda: kernels.minibatch_stddev_stat(torch.zeros(4, 8, device="meta"), 2),
     ValueError, "no kernel"),
    (lambda: kernels.lrelu_pixel_norm_bwd(_meta(), _meta(torch.contiguous_format)),
     ValueError, "channels_last"),
    (lambda: kernels.lrelu_pixel_norm_bwd(_meta(), _meta(dtype=torch.bfloat16)),
     ValueError, "g must match"),
    (lambda: kernels.lrelu_pixel_norm_bwd(_meta(), _meta()), ValueError, "no kernel"),
    (lambda: kernels.bias_lrelu_gain(_meta(torch.contiguous_format)), ValueError,
     "innermost"),
    (lambda: kernels.bias_lrelu_gain(_meta(dtype=torch.float16)), TypeError, "float32"),
    (lambda: kernels.bias_lrelu_gain(_meta(), torch.zeros(3, device="meta")), ValueError,
     "b must be"),
    (lambda: kernels.bias_lrelu_gain(
        _meta(), torch.zeros(4, device="meta", dtype=torch.float16)), ValueError, "b must be"),
    (lambda: kernels.bias_lrelu_gain(_meta(), torch.zeros(4, device="meta")), ValueError,
     "no kernel"),
])
def test_new_kernels_refuse(call, error, match):
    """Wrong group sizes, layouts and dtypes raise, and so does a device
    without a kernel; the backward kernel's gradient must match x (meta
    tensors reach the launch checks without a card)."""
    with pytest.raises(error, match=match):
        call()


BIAS_SHAPES = [(4, 8, 8, 64), (8, 32), (2, 4, 4, 513), (2, 3, 3, 16)]


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", BIAS_SHAPES)
def test_bias_lrelu_gain_plain_matches_pallas(shape, with_bias):
    """The plain version (the CPU path of `bias_lrelu_gain`) against the
    Pallas kernel in interpret mode, with a bias and with b None."""
    x = _rand(shape, seed=40 + shape[-1])
    b = _rand((shape[-1],), seed=41) if with_bias else None
    want = np.asarray(pk.bias_lrelu_gain(jnp.asarray(x), None if b is None else jnp.asarray(b)))
    got = kernels.bias_lrelu_gain(_to_torch(x), None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(_to_numpy(got), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape, dim, want", [
    ((2, 3, 3, 16), 1, (288, 16)), ((8, 32), 1, (256, 32)), ((2, 5, 6), -1, (60, 6))])
def test_kernel_channels_accepts_innermost_channel_axis(shape, dim, want):
    """A channels_last tensor or a [B, C] one with dim 1, a contiguous one
    with dim -1: the bias-act kernel reads each in place."""
    x = _to_torch(np.zeros(shape, np.float32)) if dim == 1 else torch.zeros(shape)
    assert kernels.kernel_channels(x, dim) == want


@pytest.mark.parametrize("with_bias", [True, False])
def test_bias_lrelu_gain_derivatives_match_jax(with_bias):
    """First (x, b) and second derivatives through the port's autograd rule
    (the kernel forward, a torch-ops backward) against jax.grad of the
    Pallas op's custom_jvp (`_bias_lrelu_core`), for
    L = sum(w · y²) and then sum(v · dL/dx) + sum(u · dL/db)."""
    shape = (2, 3, 3, 16)
    x, w, v = (_rand(shape, seed=s) for s in (50, 51, 52))
    b, u = _rand((16,), seed=53), _rand((16,), seed=54)
    if not with_bias:
        b = np.zeros_like(b)

    def jax_loss(xa, ba):
        y = pk._bias_lrelu_core(xa, ba, 0.2, float(np.sqrt(2.0)))
        return jnp.sum(jnp.asarray(w) * y ** 2)

    def jax_second(xa, ba):
        gx, gb = jax.grad(jax_loss, argnums=(0, 1))(xa, ba)
        return jnp.sum(jnp.asarray(v) * gx) + (jnp.sum(jnp.asarray(u) * gb) if with_bias
                                               else 0.0)
    want1 = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
    want2 = jax.grad(jax_second, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))

    xt = _to_torch(x.copy()).requires_grad_(True)
    bt = torch.from_numpy(b.copy()).requires_grad_(True) if with_bias else None
    inputs = (xt, bt) if with_bias else (xt,)
    y = kernels.bias_lrelu_gain(xt, bt)
    g1 = torch.autograd.grad((_to_torch(w) * y.square()).sum(), inputs, create_graph=True)
    second = (_to_torch(v) * g1[0]).sum()
    if with_bias:
        second = second + (torch.from_numpy(u) * g1[1]).sum()
    g2 = torch.autograd.grad(second, inputs)
    np.testing.assert_allclose(_to_numpy(g1[0].detach()), np.asarray(want1[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_to_numpy(g2[0]), np.asarray(want2[0]), rtol=1e-5, atol=1e-6)
    if with_bias:
        # db sums dx over 18 rows: rtol 1e-5, atol 1e-5
        np.testing.assert_allclose(g1[1].detach().numpy(), np.asarray(want1[1]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g2[1].numpy(), np.asarray(want2[1]), rtol=1e-5, atol=1e-5)
