"""The port's backbones, face parser, e4e and 3DMM (`pggan_tpu_torch/models/
{backbones,faceparser,e4e,face3d}.py`) against the JAX package's, on the CPU.

The same numpy-seeded parameters (drawn on `jax.eval_shape` templates of the
JAX inits, carried across by the port's `*_params_from_jax`) and inputs go
through JAX's jitted apply and the port's module; NHWC arrays are permuted
to NCHW. The reference key surfaces (`tests/test_submodel_port.py`'s
synthetic state_dicts) load strictly into the port and its forward equals
JAX's `convert_*_state_dict` followed by JAX's apply.

Tolerance: 1e-5 of the largest |value| in f32 (`close`). The residual
branch's last BatchNorm of each unit (`bn2`, `bn3`) holds a scale in [0.1,
0.3], as a trained network's does: with scales near 1 the random IR-SE-50
is chaotic in f32 (at 112² its f32 and float64 forwards differ by 43 % of
the largest value, in either package), so no f32 comparison could be
exact there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_submodel_port as sm
from pggan_tpu.losses import gan as jgan
from pggan_tpu.models import backbones as jb
from pggan_tpu.models import e4e as je
from pggan_tpu.models import face3d as j3
from pggan_tpu.models import faceparser as jf
from pggan_tpu.utils.checkpoint import arrays_to_tree, tree_to_arrays
from pggan_tpu_torch.losses import gan
from pggan_tpu_torch.models import backbones as pb
from pggan_tpu_torch.models import e4e as pe
from pggan_tpu_torch.models import face3d as p3
from pggan_tpu_torch.models import faceparser as pf

RTOL = 1e-5


def close(got, want, rtol=RTOL):
    """max |got − want| ≤ rtol · max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, f"max |diff| {err:.3g} of the largest value (tolerance {rtol})"


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def numpy_params(init, seed, *args, **kwargs):
    """Arrays for JAX `init(key, *args, **kwargs)`'s tree, drawn with numpy by
    path: He-normal conv weights, N(0, 1/in) matrices, biases and BN means
    0.1·N, BN variances U(0.5, 1.5), BN scales U(0.5, 1.5) (U(0.1, 0.3) for
    a unit's `bn2` / `bn3`), PReLU slopes U(0.1, 0.4), EqualLinear scales
    1/√in."""
    template = jax.eval_shape(functools.partial(init, *args, **kwargs),
                              jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)
    zeros = tree_to_arrays(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), template))
    out = {}
    for path, leaf in zeros.items():
        shape, parts = leaf.shape, path.split("/")
        name = parts[-1]
        if name == "w" and len(shape) == 4:
            v = rs.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:3]))
        elif name == "w":
            v = rs.randn(*shape) * np.sqrt(1.0 / shape[0])
        elif name == "var":
            v = 0.5 + rs.rand(*shape)
        elif name == "scale" and len(shape) == 0:
            v = np.asarray(1.0 / np.sqrt(zeros[path[:-len("scale")] + "w"].shape[0]))
        elif name == "scale":
            residual = len(parts) > 2 and parts[-2] in ("bn2", "bn3")
            v = 0.1 + 0.2 * rs.rand(*shape) if residual else 0.5 + rs.rand(*shape)
        elif name == "prelu":
            v = 0.1 + 0.3 * rs.rand(*shape)
        else:                                           # b, bias, mean
            v = 0.1 * rs.randn(*shape)
        out[path] = np.asarray(v, np.float32)
    return template, out


@functools.lru_cache(maxsize=None)
def _jitted(apply, options):
    return jax.jit(functools.partial(apply, **dict(options)))


def jax_apply(apply, template, arrays, *inputs, **options):
    """JAX's `apply` jitted (one compile a function and options per
    process) on the arrays filled into `template`."""
    params = arrays_to_tree(template, arrays, strict=True)
    fn = _jitted(apply, tuple(sorted(options.items())))
    return jax.tree_util.tree_map(np.asarray, fn(params, *(jnp.asarray(x) for x in inputs)))


# ---- ResNet-18 / 50, IR-SE ----

@pytest.mark.parametrize("depth,size", [(18, (64, 64)), (50, (33, 35))])
def test_resnet_matches_jax(depth, size):
    """Odd sizes hold the symmetric padding and the -inf max-pool padding
    (XLA's SAME would shift every stride-2 window)."""
    init, apply = {18: (jb.init_resnet18, jb.resnet18_apply),
                   50: (jb.init_resnet50, jb.resnet50_apply)}[depth]
    template, arrays = numpy_params(init, depth)
    x = np.random.RandomState(1).randn(2, *size, 3).astype(np.float32)
    module = pb.resnet_params_from_jax(arrays)
    assert module.depth == depth
    with torch.no_grad():
        close(nhwc(module(nchw(x))), jax_apply(apply, template, arrays, x))
        if depth == 18:
            want = jax_apply(apply, template, arrays, x, return_stages=True)
            for got, w in zip(module(nchw(x), return_stages=True), want):
                close(nhwc(got), w)


def test_irse_matches_jax():
    """IR-SE-50 with the ArcFace head at input 32: every shortcut kind (the
    stride-2 MaxPool(1, 2) subsample, the identity, conv1×1 + BN), the
    NCHW-order flatten and the rsqrt(Σ² + 1e-10) l2 normalisation."""
    template, arrays = numpy_params(jb.init_irse, 2, num_layers=50, input_size=32)
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    module = pb.irse_params_from_jax(arrays)
    with torch.no_grad():
        got = module(nchw(x))
    close(got.numpy(), jax_apply(jb.irse_apply, template, arrays, x))
    np.testing.assert_allclose(got.norm(dim=1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("num_layers", [50, 100, 152])
def test_irse_depths_load_jax_arrays(num_layers):
    template = jax.eval_shape(functools.partial(jb.init_irse, num_layers=num_layers,
                                                input_size=32), jax.random.PRNGKey(0))
    arrays = tree_to_arrays(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                                   template))
    module = pb.irse_params_from_jax(arrays)
    assert len(module.body) == sum(c for _, c in pb.IRSE_STAGES[num_layers])
    assert sum(p.numel() for p in module.parameters()) == sum(
        v.size for k, v in arrays.items() if not k.endswith(("/mean", "/var")))


def test_batchnorm_keeps_running_statistics_in_train_mode():
    _, arrays = numpy_params(jb.init_resnet18, 4)
    module = pb.resnet_params_from_jax(arrays)
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 3, 32, 32).astype(np.float32))
    with torch.no_grad():
        want = module.eval()(x)
        got = module.train()(x)
    assert torch.equal(got, want)
    assert all(int(b) == 0 for k, b in module.state_dict().items()
               if k.endswith("num_batches_tracked"))


def test_arcface_id_loss_input_gradient_matches_jax():
    """d id_loss(IRSE(x), IRSE(y)) / dx, the reference's cosine ID loss on
    ArcFace embeddings, against jax.grad."""
    template, arrays = numpy_params(jb.init_irse, 6, num_layers=50, input_size=32)
    rs = np.random.RandomState(7)
    x, y = (rs.randn(2, 32, 32, 3).astype(np.float32) for _ in range(2))
    emb_y = jnp.asarray(jax_apply(jb.irse_apply, template, arrays, y))
    grad = jax.jit(jax.grad(lambda p, a: jgan.id_loss(jb.irse_apply(p, a), emb_y), argnums=1))
    want = np.asarray(grad(arrays_to_tree(template, arrays, strict=True), jnp.asarray(x)))
    module = pb.irse_params_from_jax(arrays)
    xt = nchw(x).requires_grad_(True)
    loss = gan.id_loss(module(xt), module(nchw(y)))
    loss.backward()
    close(nhwc(xt.grad), want)


# ---- BiSeNet, e4e, ReconNet + the face model ----

@pytest.mark.parametrize("n_classes,side", [(19, 64), (5, 32)])
def test_bisenet_matches_jax(n_classes, side):
    """Nearest-neighbour merges inside the context path, bilinear with
    aligned corners only on the final logits."""
    template, arrays = numpy_params(jf.init_bisenet, 8, n_classes=n_classes)
    x = np.random.RandomState(9).randn(2, side, side, 3).astype(np.float32)
    with torch.no_grad():
        got = nhwc(pf.params_from_jax(arrays)(nchw(x)))
    assert got.shape == (2, side, side, n_classes)
    close(got, jax_apply(jf.bisenet_apply, template, arrays, x))


# 3 coarse styles (from c3), 4 middle (the c2 fusion), 1 fine (the c1 fusion);
# style_dim 64 keeps the 38 style convs small.
E4E_STYLES, E4E_DIM = 8, 64


@pytest.fixture(scope="module")
def e4e_case():
    template, arrays = numpy_params(je.init_e4e_encoder, 10, n_styles=E4E_STYLES,
                                    style_dim=E4E_DIM)
    x = np.random.RandomState(11).randn(1, 256, 256, 3).astype(np.float32)
    return template, arrays, x, pe.params_from_jax(arrays)


@pytest.mark.parametrize("stage", [None, 0, 4])
def test_e4e_matches_jax(e4e_case, stage):
    """Stage-end taps 1-3, the FPN, EqualLinear's 1/√in and the
    `progressive_stage` gating (w0 repeated beyond the stage)."""
    template, arrays, x, module = e4e_case
    with torch.no_grad():
        got = module(nchw(x), progressive_stage=stage).numpy()
    assert got.shape == (1, E4E_STYLES, E4E_DIM)
    close(got, jax_apply(je.e4e_encoder_apply, template, arrays, x, progressive_stage=stage))
    if stage is not None:
        np.testing.assert_array_equal(got[:, stage + 1:], np.repeat(got[:, :1], E4E_STYLES
                                                                    - stage - 1, axis=1))


def grid_mesh(rows, cols):
    """A triangulated rows × cols grid: vertices with 1 to 6 adjacent
    faces, so point_buf rows carry the padding sentinel."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    a, b, c, d = idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]
    tris = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                           np.stack([b, d, c], -1).reshape(-1, 3)])
    return tris.astype(np.int32)


def test_point_buf_matches_jax():
    tris = grid_mesh(5, 7)
    got = p3.build_point_buf(tris, 35)
    np.testing.assert_array_equal(got, j3.build_point_buf(tris, 35))
    assert (got == len(tris)).any()


def test_reconnet_matches_jax():
    """ResNet-50, the global pool and the seven heads (random here: the
    reference zero-initialises them) in the id | exp | tex | angle | gamma |
    tx, ty | tz order."""
    template, arrays = numpy_params(j3.init_reconnet, 12)
    rs = np.random.RandomState(13)
    for i, d in enumerate(p3.RECONNET_HEADS):
        arrays[f"heads/{i}/w"] = (0.05 * rs.randn(2048, d)).astype(np.float32)
    x = rs.randn(2, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        got = p3.reconnet_params_from_jax(arrays)(nchw(x))
    assert got.shape == (2, 257)
    close(got.numpy(), jax_apply(j3.reconnet_apply, template, arrays, x))
    with torch.no_grad():
        assert not p3.ReconNet()(nchw(x)).any()         # zero heads, as the reference's


@pytest.mark.parametrize("topology", [False, True])
def test_face_model_matches_jax(topology):
    """compute_for_render of 257 coefficients: the Euler rotation order, the
    camera and projection, the landmarks, the normals (the reference's
    gathers with F.normalize's 1e-12 and an inert padding row, or the 1e-8
    fallback without topology) and the nine SH bands with the +0.8 DC
    offset."""
    rs = np.random.RandomState(15)
    coeffs = (0.3 * rs.randn(3, 257)).astype(np.float32)
    bases, n_vertices = None, 128
    if topology:
        rows, cols = 8, 12
        n_vertices = rows * cols
        bases = {"mean_shape": (0.1 * rs.randn(n_vertices * 3)).astype(np.float32),
                 "id_base": (0.01 * rs.randn(n_vertices * 3, 80)).astype(np.float32),
                 "exp_base": (0.01 * rs.randn(n_vertices * 3, 64)).astype(np.float32),
                 "mean_tex": rs.rand(n_vertices * 3).astype(np.float32),
                 "tex_base": (0.01 * rs.randn(n_vertices * 3, 80)).astype(np.float32),
                 "landmark_index": rs.choice(n_vertices, 68, replace=False).astype(np.int32),
                 "face_buf": grid_mesh(rows, cols)}
    want = jax.jit(j3.ParametricFaceModel(n_vertices=n_vertices, bases=bases)
                   .compute_for_render)(jnp.asarray(coeffs))
    model = p3.ParametricFaceModel(n_vertices=n_vertices, bases=bases, device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(coeffs))
    assert set(out) == set(want)
    for key, value in out.items():
        close(value.numpy(), want[key])


# ---- the reference key surfaces ----

def _arcface_sd(rs):
    sd = sm._synthetic_irse_trunk_sd({}, rs)
    sm._mk_bn(sd, rs, "output_layer.0", 512)
    sm._mk(sd, rs, "output_layer.3.weight", 512, 512 * 7 * 7)
    sm._mk(sd, rs, "output_layer.3.bias", 512)
    sm._mk_bn(sd, rs, "output_layer.4", 512)
    return sd


def _resnet18_sd(rs):
    sd = sm._synthetic_torchvision_resnet_sd({}, rs, layers=(2, 2, 2, 2), bottleneck=False)
    sm._mk(sd, rs, "fc.weight", 1000, 512)      # skipped, as the reference's loader does
    sm._mk(sd, rs, "fc.bias", 1000)
    return sd


def _reconnet_sd(rs):
    sd = sm._synthetic_torchvision_resnet_sd({}, rs, layers=(3, 4, 6, 3), bottleneck=True,
                                             prefix="backbone.")
    for i, d in enumerate(p3.RECONNET_HEADS):
        sm._mk(sd, rs, f"final_layers.{i}.weight", d, 2048, 1, 1)
        sm._mk(sd, rs, f"final_layers.{i}.bias", d)
    return sd


def _bisenet_sd(rs):
    sd = sm._synthetic_torchvision_resnet_sd({}, rs, layers=(2, 2, 2, 2), bottleneck=False,
                                             prefix="cp.resnet.")

    def conv_bn_relu(prefix, cin, cout, k):
        sm._mk(sd, rs, prefix + ".conv.weight", cout, cin, k, k)
        sm._mk_bn(sd, rs, prefix + ".bn", cout)

    for arm, cin in (("arm16", 256), ("arm32", 512)):
        conv_bn_relu(f"cp.{arm}.conv", cin, 128, 3)
        sm._mk(sd, rs, f"cp.{arm}.conv_atten.weight", 128, 128, 1, 1)
        sm._mk_bn(sd, rs, f"cp.{arm}.bn_atten", 128)
    conv_bn_relu("cp.conv_avg", 512, 128, 1)
    conv_bn_relu("cp.conv_head16", 128, 128, 3)
    conv_bn_relu("cp.conv_head32", 128, 128, 3)
    conv_bn_relu("ffm.convblk", 256, 256, 1)
    sm._mk(sd, rs, "ffm.conv1.weight", 64, 256, 1, 1)
    sm._mk(sd, rs, "ffm.conv2.weight", 256, 64, 1, 1)
    conv_bn_relu("conv_out.conv", 256, 256, 3)
    sm._mk(sd, rs, "conv_out.conv_out.weight", 19, 256, 1, 1)
    for name in ("conv_out16", "conv_out32"):
        conv_bn_relu(f"{name}.conv", 128, 64, 3)
        sm._mk(sd, rs, f"{name}.conv_out.weight", 19, 64, 1, 1)
    return sd


E4E_SURFACE_STYLES = 4      # 3 coarse, 1 middle


def _e4e_sd(rs, n_styles=E4E_SURFACE_STYLES):
    """Encoder4Editing(50, 'ir_se')'s keys (`e4e.py:185-259`) with n_styles
    style blocks."""
    sd = sm._synthetic_irse_trunk_sd({}, rs)
    for i in range(n_styles):
        for j in range({16: 4, 32: 5, 64: 6}[16 if i < 3 else (32 if i < 7 else 64)]):
            sm._mk(sd, rs, f"styles.{i}.convs.{2 * j}.weight", 512, 512, 3, 3)
            sm._mk(sd, rs, f"styles.{i}.convs.{2 * j}.bias", 512)
        sm._mk(sd, rs, f"styles.{i}.linear.weight", 512, 512)
        sm._mk(sd, rs, f"styles.{i}.linear.bias", 512)
    for name, cin in (("latlayer1", 256), ("latlayer2", 128)):
        sm._mk(sd, rs, f"{name}.weight", 512, cin, 1, 1)
        sm._mk(sd, rs, f"{name}.bias", 512)
    return sd


# name: (synthetic sd, port converter, JAX converter, JAX init, JAX apply, input NHWC)
SURFACES = {
    "arcface": (_arcface_sd, pb.convert_arcface_state_dict, jb.convert_arcface_state_dict,
                functools.partial(jb.init_irse, input_size=112), jb.irse_apply, (1, 112, 112)),
    "resnet18": (_resnet18_sd, pb.convert_resnet18_state_dict,
                 jb.convert_resnet18_state_dict, jb.init_resnet18, jb.resnet18_apply,
                 (2, 64, 64)),
    "bisenet": (_bisenet_sd, pf.convert_bisenet_state_dict, jf.convert_bisenet_state_dict,
                jf.init_bisenet, jf.bisenet_apply, (2, 64, 64)),
    "reconnet": (_reconnet_sd, p3.convert_reconnet_state_dict,
                 j3.convert_reconnet_state_dict, j3.init_reconnet, j3.reconnet_apply,
                 (2, 32, 32)),
    "e4e": (_e4e_sd, pe.convert_e4e_state_dict,
            functools.partial(je.convert_e4e_state_dict, n_styles=E4E_SURFACE_STYLES),
            functools.partial(je.init_e4e_encoder, n_styles=E4E_SURFACE_STYLES),
            je.e4e_encoder_apply, (1, 256, 256)),
}


@pytest.mark.parametrize("name", sorted(SURFACES))
def test_reference_state_dict_loads_and_matches_jax_converter(name):
    make_sd, convert, jax_convert, init, apply, shape = SURFACES[name]
    rs = np.random.RandomState(14)
    sd = make_sd(rs)
    module = convert(sd)
    state = module.state_dict()
    # strict: every reference key is a key of the module, and no other
    assert set(state) == set(sd) - ({"fc.weight", "fc.bias"} if name == "resnet18" else set())
    for key in ("output_layer.3.weight", "cp.arm32.conv_atten.weight",
                "layer2.0.downsample.0.weight", "final_layers.0.weight", "styles.0.linear.weight"):
        if key in state:
            np.testing.assert_array_equal(state[key].numpy(), sd[key])
    template = jax.eval_shape(init, jax.random.PRNGKey(0))
    x = rs.randn(*shape, 3).astype(np.float32)
    with torch.no_grad():
        got = module(nchw(x)).numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    close(got, jax_apply(apply, template, jax_convert(sd), x))


def test_loaders_refuse_keys_they_do_not_hold():
    """A reference state_dict with a key the module lacks, or JAX arrays
    with a path no parameter takes, are refused, not skipped."""
    rs = np.random.RandomState(16)
    sd = _reconnet_sd(rs)
    sd["final_layers.7.weight"] = sd["final_layers.6.weight"]
    with pytest.raises(RuntimeError, match="final_layers.7.weight"):
        p3.convert_reconnet_state_dict(sd)
    _, arrays = numpy_params(jb.init_resnet18, 17)
    arrays["stem/extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="stem/extra"):
        pb.resnet_params_from_jax(arrays)
    del arrays["stem/extra"], arrays["stages/3/1/bn2/var"]
    with pytest.raises(KeyError):
        pb.resnet_params_from_jax(arrays)
