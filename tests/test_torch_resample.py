"""pggan_tpu_torch's StyleGAN2-ops layer against the JAX package's, on the
same numpy inputs: `bias_act`, `fma`, the upfirdn2d family,
`bilinear_align_corners`, `filtered_lrelu`, `conv2d_resample` and
`grid_sample`, with second derivatives where the JAX op has them; and
upfirdn2d's autograd rule against autograd through its composition, its
dispatch on a CUDA tensor (the kernel, or a raise outside the kernel's
envelope), and the envelope, none of which needs a card.

f32 throughout. Tolerance rtol 1e-5, atol 1e-6, except where a sum of
products runs in another order (convolutions, filters, the lerps):
rtol 1e-5, atol 1e-5, and second derivatives, held to 1e-5 of their
largest entry. The port's tensors are NCHW channels_last views of the
NHWC numpy arrays.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from pggan_tpu.ops import basic as jbasic
from pggan_tpu.ops import composite as jcomp
from pggan_tpu.ops import pallas_kernels as pk
from pggan_tpu.ops import resample as jres
from pggan_tpu_torch import ops
from pggan_tpu_torch.ops import basic, composite, resample

TOL = dict(rtol=1e-5, atol=1e-6)
SUM_TOL = dict(rtol=1e-5, atol=1e-5)
_pallas_call = functools.partial(pl.pallas_call)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(_pallas_call, interpret=True))


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _filter(taps, **kw):
    """The same filter from both packages' setup_filter."""
    return (np.asarray(jres.setup_filter(taps, **kw)),
            resample.setup_filter(taps, device="cpu", **kw))


def _close_to_largest(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# bias_act, fma
# ---------------------------------------------------------------------------

ACTS = ["linear", "relu", "lrelu", "tanh", "sigmoid", "elu", "selu", "softplus", "swish"]


@pytest.mark.parametrize("act", ACTS)
def test_bias_act_with_clamp_matches_xla_path(act):
    """Every activation with a bias, its default gain and a clamp against
    `bias_act(impl='xla')`; lrelu takes the kernel's route, whose CPU path is
    the kernel's plain version with the clamp."""
    x, b = _rand((2, 4, 4, 8), seed=1) * 2, _rand((8,), seed=2)
    want = jbasic.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, clamp=1.5)
    got = basic.bias_act(_nchw(x), torch.from_numpy(b), act=act, clamp=1.5)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("act, alpha, gain", [("lrelu", None, None), ("lrelu", 0.1, 1.0),
                                              ("elu", None, 2.0)])
def test_bias_act_without_clamp(act, alpha, gain):
    """Leaky ReLU without a clamp is the kernel's route: its CPU path is the
    kernel's plain version, held against the Pallas kernel; another
    activation against the xla path."""
    x, b = _rand((2, 4, 4, 8), seed=3), _rand((8,), seed=4)
    if act == "lrelu":
        want = pk.bias_lrelu_gain(jnp.asarray(x), jnp.asarray(b),
                                  slope=0.2 if alpha is None else alpha,
                                  gain=np.sqrt(2.0) if gain is None else gain)
    else:
        want = jbasic.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, gain=gain)
    got = basic.bias_act(_nchw(x), torch.from_numpy(b), act=act, alpha=alpha, gain=gain)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ["lrelu", "swish"])
def test_bias_act_on_another_axis(act):
    """A bias along dim 2 of a [2, 3, 5, 4] tensor, the same axis as in the
    JAX package (no layout change between the two)."""
    x, b = _rand((2, 3, 5, 4), seed=5), _rand((5,), seed=6)
    want = jbasic.bias_act(jnp.asarray(x), jnp.asarray(b), dim=2, act=act)
    got = basic.bias_act(torch.from_numpy(x), torch.from_numpy(b), dim=2, act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bias_act_refuses_and_fma():
    with pytest.raises(ValueError, match="unknown activation"):
        basic.bias_act(torch.zeros(2, 3), act="gelu")
    with pytest.raises(ValueError, match="clamp"):
        basic.bias_act(torch.zeros(2, 3), act="relu", clamp=-1.0)
    a, b, c = (_rand((3, 5), seed=s) for s in (7, 8, 9))
    np.testing.assert_allclose(
        basic.fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy(),
        np.asarray(jbasic.fma(*(jnp.asarray(v) for v in (a, b, c)))), **TOL)


# ---------------------------------------------------------------------------
# the upfirdn2d family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("taps, kw", [
    ([1, 3, 3, 1], {}), ([1, 2, 1], {"flip_filter": True, "gain": 4.0}),
    ([1, 2, 3, 4, 4, 3, 2, 1], {}), ([[1, 2], [3, 5]], {"normalize": False}),
    (None, {}), ([1, 2, 1], {"separable": True})])
def test_setup_filter(taps, kw):
    want, got = _filter(taps, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


UPFIRDN_CASES = [
    ([1, 3, 3, 1], dict(up=2, padding=(2, 1, 2, 1))),
    ([1, 2, 1], dict(down=2, padding=1)),
    ([1, 2, 3, 4, 4, 3, 2, 1], dict(padding=3)),            # separable 8 taps
    ([1, 3, 3, 1], dict(up=2, padding=1, flip_filter=True, gain=4.0)),
    ([[1, 2, 0], [0, 1, 3]], dict(up=(2, 1), down=(1, 2), padding=(-1, 2, 1, -2))),
    (None, dict(up=3, padding=(0, -1, 0, -1))),
]


@pytest.mark.parametrize("taps, kw", UPFIRDN_CASES)
def test_upfirdn2d(taps, kw):
    x = _rand((2, 5, 6, 3), seed=10)
    jf, tf = _filter(taps, normalize=taps is not None) if taps is not None else (None, None)
    want = jres.upfirdn2d(jnp.asarray(x), None if jf is None else jnp.asarray(jf), **kw)
    got = resample.upfirdn2d(_nchw(x), tf, **kw)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **SUM_TOL)


@pytest.mark.parametrize("op, taps, kw", [
    ("filter2d", [1, 3, 3, 1], dict(padding=1)),
    ("filter2d", [1, 2, 1], dict(flip_filter=True, gain=2.0)),
    ("upsample2d", [1, 3, 3, 1], {}),
    ("upsample2d", None, dict(padding=(1, 0, 0, 1))),
    ("downsample2d", [1, 3, 3, 1], {}),
    ("downsample2d", None, dict(down=(2, 1))),
])
def test_filter_wrappers(op, taps, kw):
    x = _rand((2, 6, 8, 3), seed=11)
    jf, tf = _filter(taps) if taps is not None else (None, None)
    want = getattr(jres, op)(jnp.asarray(x), None if jf is None else jnp.asarray(jf), **kw)
    got = getattr(resample, op)(_nchw(x), tf, **kw)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **SUM_TOL)


# ---------------------------------------------------------------------------
# upfirdn2d's autograd rule, its dispatch and the kernel's envelope
# ---------------------------------------------------------------------------

FUNCTION_CASES = [    # (id, op, taps, kwargs)
    ("up2 padded", "upfirdn2d", [1, 3, 3, 1], dict(up=2, padding=(2, 1, 2, 1))),
    ("down2 crop 8 taps", "upfirdn2d", list(range(1, 9)), dict(down=2, padding=(3, 2, -1, 4))),
    ("filter2d", "filter2d", [1, 3, 3, 1], dict(padding=1)),
    ("upsample2d conv0", "upsample2d", [1, 3, 3, 1], dict(padding=1)),
]


@pytest.mark.parametrize("name, op, taps, kw", FUNCTION_CASES, ids=[c[0] for c in FUNCTION_CASES])
def test_upfirdn2d_function_derivatives(monkeypatch, name, op, taps, kw):
    """Where autograd records, upfirdn2d is `_Upfirdn2d`: its value, first
    derivative (of sum(y·r)) and second derivative (of sum(g²), g the
    gradient of sum(y²·r)) against autograd through the composition."""
    x = _rand((2, 9, 7, 3), seed=20)
    f = resample.setup_filter(taps, device="cpu")

    def run():
        xt = _nchw(x.copy()).requires_grad_(True)
        y = getattr(resample, op)(xt, f, **kw)
        r = torch.from_numpy(np.random.RandomState(21).rand(*y.shape).astype(np.float32))
        (g1,) = torch.autograd.grad((y * r).sum(), xt, retain_graph=True)
        (g,) = torch.autograd.grad((y.square() * r).sum(), xt, create_graph=True)
        (g2,) = torch.autograd.grad(g.square().sum(), xt)
        return y, g1, g2

    with monkeypatch.context() as m:
        m.setattr(resample, "upfirdn2d", resample.upfirdn2d_plain)
        want = run()
    got = run()
    assert type(got[0].grad_fn).__name__ == "_Upfirdn2dBackward"
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(got[0]), _nhwc(want[0]), **SUM_TOL)
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape
        _close_to_largest(_nhwc(g), _nhwc(w))


def test_upfirdn2d_on_the_cpu_runs_the_composition():
    """A CPU call runs `upfirdn2d_plain` and launches nothing."""
    x = _nchw(_rand((2, 6, 5, 8), seed=22))
    f = resample.setup_filter([1, 3, 3, 1], device="cpu")
    ops.kernels.reset_launch_counts()
    got = resample.upfirdn2d(x, f, up=2, padding=(2, 1, 2, 1))
    assert torch.equal(got, resample.upfirdn2d_plain(x, f, up=2, padding=(2, 1, 2, 1)))
    assert ops.kernels.launches["upfirdn2d"] == 0


class _OnCuda(torch.Tensor):
    """A CPU tensor that reads as a CUDA one, to drive the dispatch here."""

    @property
    def is_cuda(self):
        return True


ROUTE_CASES = [       # (id, x's dtype or layout, taps, kwargs, the refusal's words or None)
    ("up2", None, [1, 3, 3, 1], dict(up=2, padding=(2, 1, 2, 1)), None),
    ("conv0's upsample", None, [1, 3, 3, 1], dict(up=2, padding=(3, 2, 3, 2)), None),
    ("down2 crop 8 taps", None, list(range(1, 9)), dict(down=2, padding=(3, 2, -1, 4)), None),
    ("per axis", None, [[1, 2, 0], [0, 1, 3]],
     dict(up=(2, 1), down=(1, 2), padding=(-1, 2, 1, -2)), None),
    ("no filter", None, None, dict(padding=(0, -1, 1, 0)), None),
    ("up4", None, None, dict(up=4, padding=(0, -1, 0, -1)), None),
    ("9 taps", None, list(range(1, 10)), dict(padding=4), None),
    ("StyleGAN3 up 4, 24 taps", None, list(range(1, 25)), dict(up=4, padding=(-6, -9, -6, -9)),
     None),
    ("StyleGAN3 up 2, 12 taps", None, list(range(1, 13)), dict(up=2, padding=(9, 8, 9, 8)), None),
    ("StyleGAN3 down 2, 12 taps, negative pad", None, list(range(1, 13)),
     dict(down=2, padding=(1, -1, 2, -2)), None),
    ("down4", None, list(range(1, 9)), dict(down=4, padding=(3, 4, 3, 4)),
     "1 or 2 on each axis"),
    ("up8", None, None, dict(up=8), "1, 2 or 4 on each axis"),
    ("25 taps 1-D", None, list(range(1, 26)), dict(padding=12), "at most 24"),
    ("9x9 2-D", None, [[1.0] * 9] * 9, dict(padding=4), "at most 8 taps an axis"),
    ("nchw", torch.contiguous_format, [1, 3, 3, 1], dict(up=2, padding=(2, 1, 2, 1)),
     "channels_last"),
    ("f16", torch.float16, [1, 3, 3, 1], dict(up=2, padding=(2, 1, 2, 1)), "float32 or bfloat16"),
]


@pytest.mark.parametrize("name, form, taps, kw, refusal", ROUTE_CASES,
                         ids=[c[0] for c in ROUTE_CASES])
def test_upfirdn2d_dispatch_on_a_cuda_tensor(monkeypatch, name, form, taps, kw, refusal):
    """A call on a CUDA tensor (a CPU one that reads as CUDA) launches the
    kernel inside the envelope, with the composition's output size and the
    leading pads, and outside it raises the reason, never running the
    composition."""
    x = _nchw(_rand((2, 20, 18, 8), seed=23)).contiguous(memory_format=torch.channels_last)
    if isinstance(form, torch.dtype):
        x = x.to(form)
    elif form is not None:
        x = x.contiguous(memory_format=form)
    f = None if taps is None else resample.setup_filter(taps, device="cpu",
                                                        separable=len(taps) > 4)
    want = resample.upfirdn2d_plain(x, f, **kw)
    calls = []

    def launch(x, f, up, down, pad0, out_hw, flip_filter, gain):
        calls.append((up, down, pad0))
        return want.new_zeros((x.shape[0], x.shape[1], *out_hw))

    def composition(*args, **kwargs):
        raise AssertionError("a CUDA call ran the composition")

    monkeypatch.setattr(ops.kernels, "upfirdn2d", launch)
    monkeypatch.setattr(resample, "upfirdn2d_plain", composition)
    if refusal is not None:
        with pytest.raises(ValueError, match=refusal):
            resample.upfirdn2d(x.as_subclass(_OnCuda), f, **kw)
        assert not calls
        return
    got = resample.upfirdn2d(x.as_subclass(_OnCuda), f, **kw)
    assert got.shape == want.shape and len(calls) == 1
    pads = resample._parse_padding(kw["padding"])
    assert calls[0][2] == (pads[0], pads[2])


def _envelope(x, f=None, up=(2, 2), down=(1, 1)):
    fh, fw = resample._filter_size(f)
    out_hw = resample._output_size(x, fh, fw, up, down, (1, 1, 1, 1))
    return resample.envelope_refusal(x, f, up, down, out_hw)


def _cl(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype).contiguous(memory_format=torch.channels_last)


F4 = resample.setup_filter([1, 3, 3, 1], device="cpu")
ENVELOPE_CASES = [    # (id, x, f, up, down, inside)
    ("f32", _cl(2, 8, 5, 6), F4, (2, 2), (1, 1), True),
    ("bf16", _cl(2, 8, 5, 6, dtype=torch.bfloat16), F4, (2, 2), (1, 1), True),
    ("rgb", _cl(2, 3, 5, 6), F4, (2, 2), (1, 1), True),
    ("f16", _cl(2, 8, 5, 6, dtype=torch.float16), F4, (2, 2), (1, 1), False),
    ("nchw", torch.zeros(2, 8, 5, 6), F4, (2, 2), (1, 1), False),
    ("up3", _cl(2, 8, 5, 6), F4, (3, 3), (1, 1), False),
    ("down (1, 3)", _cl(2, 8, 5, 6), F4, (1, 1), (1, 3), False),
    ("per axis", _cl(2, 8, 5, 6), F4, (2, 1), (1, 2), True),
    ("8 taps 1-D", _cl(2, 8, 9, 9), resample.setup_filter(list(range(1, 9)), device="cpu"),
     (1, 1), (2, 2), True),
    ("9 taps", _cl(2, 8, 9, 9), torch.ones(9, 9), (1, 1), (1, 1), False),
    ("up4", _cl(2, 8, 5, 6), F4, (4, 4), (1, 1), True),
    ("down4", _cl(2, 8, 9, 9), F4, (1, 1), (4, 4), False),
    ("up 4, down 2 per axis", _cl(2, 8, 9, 9), F4, (4, 1), (1, 2), True),
    ("up8", _cl(2, 8, 5, 6), F4, (8, 8), (1, 1), False),
    ("24 taps 1-D", _cl(2, 8, 9, 9), torch.ones(24), (4, 4), (1, 1), True),
    ("25 taps 1-D", _cl(2, 8, 9, 9), torch.ones(25), (4, 4), (1, 1), False),
    ("8x8 2-D, up 4", _cl(2, 8, 9, 9), torch.ones(8, 8), (4, 4), (1, 1), True),
    ("no filter", _cl(2, 8, 5, 6), None, (1, 1), (1, 1), True),
    ("f64 filter", _cl(2, 8, 5, 6), F4.double(), (2, 2), (1, 1), False),
    ("strided filter", _cl(2, 8, 5, 6), torch.ones(4, 8)[:, ::2], (2, 2), (1, 1), False),
    ("filter requires grad", _cl(2, 8, 5, 6), F4.clone().requires_grad_(True), (2, 2), (1, 1),
     False),
    ("empty", _cl(0, 8, 5, 6), F4, (2, 2), (1, 1), False),
    ("batch over the grid", _cl(65536, 1, 1, 1), F4, (2, 2), (1, 1), False),
    ("rows over the grid", _cl(1, 1, 32769, 1), F4, (2, 2), (1, 1), False),
]


@pytest.mark.parametrize("name, x, f, up, down, inside", ENVELOPE_CASES,
                         ids=[c[0] for c in ENVELOPE_CASES])
def test_kernel_envelope(name, x, f, up, down, inside):
    """`envelope_refusal` reads metadata only: it answers for CPU tensors,
    with a reason for each call outside the envelope."""
    refusal = _envelope(x, f, up, down)
    assert (refusal is None) is inside
    assert inside or (isinstance(refusal, str) and refusal)


BEYOND_CASES = [      # (id, taps, normalize, kwargs): up 4, long 1-D filters
    ("StyleGAN3's up 4", list(range(1, 25)), True,
     dict(up=4, padding=(-6, -9, -6, -9), gain=16.0)),
    ("StyleGAN3's up 2", list(range(1, 13)), True, dict(up=2, padding=(9, 8, 9, 8), gain=4.0)),
    ("StyleGAN3's down 2", list(range(1, 13)), True, dict(down=2, padding=(1, -1, 2, -2))),
    ("up 4 without a filter", None, False, dict(up=4, padding=(0, -1, 0, -1))),
    ("up 4, 2-D filter", [[1, 2, 0, 1], [0, 1, 3, 1], [2, 1, 1, 0], [1, 0, 2, 1]], True,
     dict(up=4, padding=(2, 1, 2, 2))),
    ("StyleGAN3's up 4, pads off the cell", list(range(1, 25)), True,
     dict(up=4, padding=(-5, -10, -7, -8), gain=16.0)),
    ("8 taps 1-D, up 4", list(range(1, 9)), True, dict(up=4, padding=(4, 3, 4, 3), gain=16.0)),
    ("12 taps, up and down 2", list(range(12, 0, -1)), True,
     dict(up=2, down=2, padding=(3, 4, 2, 5))),
    ("up 4 on one axis", list(range(1, 13)), True,
     dict(up=(4, 1), down=(1, 2), padding=(5, 3, 2, 7))),
    ("13 taps, flipped", list(range(1, 14)), False, dict(padding=6, flip_filter=True, gain=0.5)),
]


@pytest.mark.parametrize("name, taps, normalize, kw", BEYOND_CASES,
                         ids=[c[0] for c in BEYOND_CASES])
def test_upfirdn2d_beyond_the_polyphase_envelope(name, taps, normalize, kw):
    """The calls that StyleGAN3 added to the kernels' envelope (up 4, 1-D
    filters of 9-24 taps, negative pads): inside it, and on the CPU the
    composition against the JAX package. On the card, tests/
    test_torch_stylegan3.py holds the kernels to the composition."""
    x = _rand((2, 20, 18, 4), seed=24)
    jf, tf = _filter(taps, normalize=normalize, separable=True) if taps else (None, None)
    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    up, down = (resample._parse_scaling(kw.get(k, 1)) for k in ("up", "down"))
    out_hw = resample._output_size(xt, *resample._filter_size(tf), up, down,
                                   resample._parse_padding(kw["padding"]))
    assert resample.envelope_refusal(xt, tf, up, down, out_hw) is None
    want = jres.upfirdn2d(jnp.asarray(x), None if jf is None else jnp.asarray(jf), **kw)
    got = resample.upfirdn2d(xt, tf, **kw)
    assert got.shape == (2, 4, *out_hw)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("in_hw, out_hw", [((3, 5), (7, 4)), ((4, 4), (1, 6)),
                                           ((1, 5), (3, 1))])
def test_bilinear_align_corners(in_hw, out_hw):
    x = _rand((2, *in_hw, 3), seed=12)
    want = jax.jit(jres.bilinear_align_corners, static_argnums=(1, 2))(
        jnp.asarray(x), *out_hw)
    got = resample.bilinear_align_corners(_nchw(x), *out_hw)
    assert got.shape == (2, 3, *out_hw)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **SUM_TOL)


# ---------------------------------------------------------------------------
# composite ops
# ---------------------------------------------------------------------------

FLRELU_CASES = [      # the cases of tests/test_composite_ops.py
    ("identity", None, None, dict(), True),
    ("up2 raw padding", [1, 3, 3, 1], None, dict(up=2), False),
    ("up2 shape-preserving", [1, 3, 3, 1], None, dict(up=2, padding=(2, 1, 2, 1)), False),
    ("bias before up", [1, 2, 1], None, dict(up=2, gain=1.0), True),
    ("up2 down2", [1, 3, 3, 1], [1, 3, 3, 1], dict(up=2, down=2, padding=3), True),
    ("clamp", None, None, dict(clamp=0.5), True),
]


@pytest.mark.parametrize("name, fu, fd, kw, with_bias", FLRELU_CASES,
                         ids=[c[0] for c in FLRELU_CASES])
def test_filtered_lrelu(name, fu, fd, kw, with_bias):
    x, b = _rand((1, 8, 8, 3), seed=13), _rand((3,), seed=14)
    jfu, tfu = _filter(fu) if fu else (None, None)
    jfd, tfd = _filter(fd) if fd else (None, None)
    want = jcomp.filtered_lrelu(
        jnp.asarray(x), None if jfu is None else jnp.asarray(jfu),
        None if jfd is None else jnp.asarray(jfd), jnp.asarray(b) if with_bias else None, **kw)
    got = composite.filtered_lrelu(_nchw(x), tfu, tfd,
                                   torch.from_numpy(b) if with_bias else None, **kw)
    assert got.shape == tuple(want.shape[i] for i in (0, 3, 1, 2))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **SUM_TOL)


def test_filtered_lrelu_grad_of_grad():
    """The second-order case of tests/test_composite_ops.py, by value:
    grad of sum(grad(sum(filtered_lrelu(x)²))²)."""
    x = _rand((1, 4, 4, 2), seed=15)
    jf, tf = _filter([1, 1])

    def jax_fn(v):
        return jnp.sum(jcomp.filtered_lrelu(v, fu=jnp.asarray(jf), up=2) ** 2)
    want = jax.grad(lambda v: jnp.sum(jax.grad(jax_fn)(v) ** 2))(jnp.asarray(x))
    xt = _nchw(x.copy()).requires_grad_(True)
    (g1,) = torch.autograd.grad(composite.filtered_lrelu(xt, fu=tf, up=2).square().sum(),
                                xt, create_graph=True)
    (g2,) = torch.autograd.grad(g1.square().sum(), xt)
    _close_to_largest(_nhwc(g2), want)


@pytest.mark.parametrize("wshape, kw, taps", [
    ((3, 3, 3, 4), dict(padding=1), None),
    ((3, 3, 3, 4), dict(padding=1, flip_weight=False), None),
    ((2, 2, 3, 4), dict(down=2), None),
    ((3, 3, 3, 4), dict(down=2, padding=1), [1, 3, 3, 1]),
    ((3, 3, 3, 2), dict(up=2, padding=1), [1, 3, 3, 1]),
    ((1, 1, 3, 2), dict(up=2), None),
    ((3, 3, 1, 4), dict(padding=1, groups=3), None),
])
def test_conv2d_resample(wshape, kw, taps):
    x, w = _rand((1, 8, 8, 3), seed=16), _rand(wshape, seed=17)
    jf, tf = _filter(taps) if taps else (None, None)
    jw = jnp.asarray(w)
    if kw.get("groups", 1) > 1:
        # JAX's grouped conv wants O divisible by groups: 4 → 3 outputs
        w = w[..., :3]
        jw = jnp.asarray(w)
    want = jcomp.conv2d_resample(jnp.asarray(x), jw, None if jf is None else jnp.asarray(jf),
                                 **kw)
    got = composite.conv2d_resample(_nchw(x), torch.from_numpy(w), tf, **kw)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **SUM_TOL)


def test_grid_sample_and_grad_of_grad():
    """Values at a grid that reaches past the border (zero padding), and the
    second derivative with respect to the grid and the image."""
    x = _rand((2, 5, 6, 2), seed=18)
    grid = np.random.RandomState(19).uniform(-1.2, 1.2, (2, 3, 4, 2)).astype(np.float32)
    want = jax.jit(jcomp.grid_sample)(jnp.asarray(x), jnp.asarray(grid))
    got = composite.grid_sample(_nchw(x), torch.from_numpy(grid))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)

    def jax_fn(v, g):
        return jnp.sum(jcomp.grid_sample(v, g) ** 2)
    want_x, want_g = jax.jit(jax.grad(
        lambda v, g: jnp.sum(jax.grad(jax_fn, argnums=1)(v, g) ** 2), argnums=(0, 1)))(
            jnp.asarray(x), jnp.asarray(grid))
    xt = _nchw(x.copy()).requires_grad_(True)
    gt = torch.from_numpy(grid.copy()).requires_grad_(True)
    (d_grid,) = torch.autograd.grad(composite.grid_sample(xt, gt).square().sum(), gt,
                                    create_graph=True)
    got_x, got_g = torch.autograd.grad(d_grid.square().sum(), (xt, gt))
    _close_to_largest(_nhwc(got_x), want_x)
    _close_to_largest(got_g.numpy(), want_g)


def test_ops_exports_match_jax_package():
    """The port's `ops` exports every name of `pggan_tpu.ops` but the two
    that ROADMAP lists as not to port."""
    import pggan_tpu.ops as jops
    wanted = {n for n in dir(jops) if not n.startswith("_") and callable(getattr(jops, n))
              and getattr(jops, n).__module__.startswith("pggan_tpu.ops")}
    wanted -= {"upscale_conv3x3", "depth_to_space2", "init_conv_params",
               "init_linear_params"}
    assert sorted(n for n in wanted if not hasattr(ops, n)) == []
