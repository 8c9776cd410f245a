"""The port's coverage of the JAX package, name by name.

Every public top-level `def` and `class` of every module under
`pggan_tpu/` (a name that does not start with `_`) has one entry in
COUNTERPARTS:

  * "same": a `def` or `class` of that name in the port's module of the
    same path (`pggan_tpu/<m>.py` → `pggan_tpu_torch/<m>.py`);
  * a dotted path into `pggan_tpu_torch` (a module's function or class, or
    a class's method or property) that does the same work: the JAX
    package's functional `init_*` / `*_apply` pairs become an `nn.Module`
    and its `forward`;
  * ("not ported", reason): dropped on purpose, as ROADMAP.md's "Not to
    port" lists.

Both packages are read with `ast`, never imported, so this file compiles
no JAX program and builds no model. Whether a counterpart computes the same
thing is what the other tests/test_torch_*.py files check on the CPU.

    python tests/test_torch_coverage.py    # prints the counts
"""

import ast
import functools
import os
from collections import Counter

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "pggan_tpu", "pggan_tpu_torch"
NOT_PORTED = "not ported"

PACKED = ("the packed space-to-depth layout (ops/packed.py, the hires_pack key) was the "
          "TPU's fix for XLA's layout copies at 512-1024²; on the H100 layout copies are "
          "2.6 % of the 1024² bf16 step with R1 and 3.6 % without (PERF.md §5)")
MESH = ("a JAX sharding helper of one program over a device mesh; the port runs one process "
        "a card, where a rank's tensors are its shard and its copy")

COUNTERPARTS = {
    # config.py
    "pggan_tpu.config.default_depths": "same",
    "pggan_tpu.config.Config": "same",
    # export.py
    "pggan_tpu.export.export_generator": "same",
    "pggan_tpu.export.load_exported": "same",
    "pggan_tpu.export.sample": "same",
    # registry.py
    "pggan_tpu.registry.register_model": "same",
    "pggan_tpu.registry.create_model": "same",
    # data/augment.py
    "pggan_tpu.data.augment.draw_augment_params": "same",
    # data/dataset.py
    "pggan_tpu.data.dataset.list_image_paths": "same",
    "pggan_tpu.data.dataset.ImageFolderDataset": "same",
    "pggan_tpu.data.dataset.SyntheticDataset": "same",
    "pggan_tpu.data.dataset.PairedFaceDataset": "same",
    "pggan_tpu.data.dataset.PairedValidDataset": "same",
    "pggan_tpu.data.dataset.split_dataset": "same",
    "pggan_tpu.data.dataset.build_dataset": "same",
    # data/device_cache.py
    "pggan_tpu.data.device_cache.assemble_batch": "same",
    "pggan_tpu.data.device_cache.DeviceDataCache": "same",
    "pggan_tpu.data.device_cache.resolve_device_data_cache": "same",
    # data/grain_pipeline.py
    "pggan_tpu.data.grain_pipeline.GrainPipeline": "same",
    # data/pipeline.py
    "pggan_tpu.data.pipeline.InfiniteSampler": "same",
    "pggan_tpu.data.pipeline.DataPipeline": "same",
    # data/resized_store.py
    "pggan_tpu.data.resized_store.paths_digest": "same",
    "pggan_tpu.data.resized_store.ResizedStore": "same",
    # losses/collector.py
    "pggan_tpu.losses.collector.LossCollector": "same",
    # losses/gan.py
    "pggan_tpu.losses.gan.bce_with_logits": "same",
    "pggan_tpu.losses.gan.softplus_loss": "same",
    "pggan_tpu.losses.gan.hinge_loss": "same",
    "pggan_tpu.losses.gan.r1_penalty": "same",
    "pggan_tpu.losses.gan.gradient_penalty": "same",
    "pggan_tpu.losses.gan.drift_loss": "same",
    "pggan_tpu.losses.gan.generator_loss": "same",
    "pggan_tpu.losses.gan.id_loss": "same",
    "pggan_tpu.losses.gan.l1_loss": "same",
    "pggan_tpu.losses.gan.l2_loss": "same",
    "pggan_tpu.losses.gan.l1_loss_with_same_person": "same",
    "pggan_tpu.losses.gan.l2_loss_with_same_person": "same",
    "pggan_tpu.losses.gan.attr_loss": "same",
    # losses/perceptual.py
    "pggan_tpu.losses.perceptual.PerceptualDistance": "same",
    "pggan_tpu.losses.perceptual.convert_lpips_state_dict": "same",
    # metrics/fid.py
    "pggan_tpu.metrics.fid.frechet_distance": "same",
    "pggan_tpu.metrics.fid.frechet_distance_device": "same",
    "pggan_tpu.metrics.fid.RandomConvFeatures": "same",
    "pggan_tpu.metrics.fid.compute_activations": "same",
    "pggan_tpu.metrics.fid.compute_activation_statistics": "same",
    "pggan_tpu.metrics.fid.fid_between_sets": "same",
    # metrics/inception.py
    "pggan_tpu.metrics.inception.init_inception_v3": "same",
    "pggan_tpu.metrics.inception.inception_v3_features": "same",
    "pggan_tpu.metrics.inception.convert_torchvision_state_dict": "same",
    "pggan_tpu.metrics.inception.InceptionV3Features": "same",
    # metrics/kid.py
    "pggan_tpu.metrics.kid.polynomial_kernel": "same",
    "pggan_tpu.metrics.kid.mmd2_unbiased": "same",
    "pggan_tpu.metrics.kid.kid_between_features": "same",
    "pggan_tpu.metrics.kid.kid_between_sets": "same",
    # models/backbones.py
    "pggan_tpu.models.backbones.init_resnet18": "pggan_tpu_torch.models.backbones.ResNet",
    "pggan_tpu.models.backbones.resnet18_apply": "pggan_tpu_torch.models.backbones.ResNet.forward",
    "pggan_tpu.models.backbones.init_resnet50": "pggan_tpu_torch.models.backbones.ResNet",
    "pggan_tpu.models.backbones.resnet50_apply": "pggan_tpu_torch.models.backbones.ResNet.forward",
    "pggan_tpu.models.backbones.init_irse": "pggan_tpu_torch.models.backbones.IRSE",
    "pggan_tpu.models.backbones.init_irse_stem":
        "pggan_tpu_torch.models.backbones.irse_input_layer",
    "pggan_tpu.models.backbones.init_irse_stages": "pggan_tpu_torch.models.backbones.irse_body",
    "pggan_tpu.models.backbones.irse_block_apply":
        "pggan_tpu_torch.models.backbones.BottleneckIRSE.forward",
    "pggan_tpu.models.backbones.irse_trunk_apply": "pggan_tpu_torch.models.backbones.irse_trunk",
    "pggan_tpu.models.backbones.irse_apply": "pggan_tpu_torch.models.backbones.IRSE.forward",
    "pggan_tpu.models.backbones.convert_irse_trunk_state_dict":
        "pggan_tpu_torch.models.backbones.convert_arcface_state_dict",
    "pggan_tpu.models.backbones.convert_arcface_state_dict": "same",
    "pggan_tpu.models.backbones.convert_resnet18_state_dict": "same",
    "pggan_tpu.models.backbones.convert_resnet50_state_dict": "same",
    # models/discriminator.py
    "pggan_tpu.models.discriminator.init_discriminator_params":
        "pggan_tpu_torch.models.discriminator.Discriminator",
    "pggan_tpu.models.discriminator.grow_discriminator_params":
        "pggan_tpu_torch.models.discriminator.Discriminator.grow",
    "pggan_tpu.models.discriminator.discriminator_apply":
        "pggan_tpu_torch.models.discriminator.Discriminator.forward",
    # models/e4e.py
    "pggan_tpu.models.e4e.init_e4e_encoder": "pggan_tpu_torch.models.e4e.Encoder4Editing",
    "pggan_tpu.models.e4e.e4e_encoder_apply": "pggan_tpu_torch.models.e4e.Encoder4Editing.forward",
    "pggan_tpu.models.e4e.convert_e4e_state_dict": "same",
    # models/face3d.py
    "pggan_tpu.models.face3d.split_coeff": "same",
    "pggan_tpu.models.face3d.build_point_buf": "same",
    "pggan_tpu.models.face3d.ParametricFaceModel": "same",
    "pggan_tpu.models.face3d.init_reconnet": "pggan_tpu_torch.models.face3d.ReconNet",
    "pggan_tpu.models.face3d.reconnet_apply": "pggan_tpu_torch.models.face3d.ReconNet.forward",
    "pggan_tpu.models.face3d.convert_reconnet_state_dict": "same",
    # models/faceparser.py
    "pggan_tpu.models.faceparser.init_bisenet": "pggan_tpu_torch.models.faceparser.BiSeNet",
    "pggan_tpu.models.faceparser.bisenet_apply":
        "pggan_tpu_torch.models.faceparser.BiSeNet.forward",
    "pggan_tpu.models.faceparser.convert_bisenet_state_dict": "same",
    # models/generator.py
    "pggan_tpu.models.generator.init_generator_params":
        "pggan_tpu_torch.models.generator.Generator",
    "pggan_tpu.models.generator.grow_generator_params":
        "pggan_tpu_torch.models.generator.Generator.grow",
    "pggan_tpu.models.generator.generator_apply":
        "pggan_tpu_torch.models.generator.Generator.forward",
    "pggan_tpu.models.generator.generator_output_resolution":
        "pggan_tpu_torch.models.generator.Generator.resolution",
    # models/torch_port.py
    "pggan_tpu.models.torch_port.convert_generator_state_dict": "same",
    "pggan_tpu.models.torch_port.convert_discriminator_state_dict": "same",
    "pggan_tpu.models.torch_port.reference_schedule_meta": "same",
    # models/zoo.py
    "pggan_tpu.models.zoo.interpolate2d": "same",
    "pggan_tpu.models.zoo.init_norm": "pggan_tpu_torch.models.zoo.Norm",
    "pggan_tpu.models.zoo.init_adain": "pggan_tpu_torch.models.zoo.AdaIN",
    "pggan_tpu.models.zoo.adain_apply": "pggan_tpu_torch.models.zoo.AdaIN.forward",
    "pggan_tpu.models.zoo.init_conv_block": "pggan_tpu_torch.models.zoo.ConvBlock",
    "pggan_tpu.models.zoo.conv_block_apply": "pggan_tpu_torch.models.zoo.ConvBlock.forward",
    "pggan_tpu.models.zoo.init_res_block": "pggan_tpu_torch.models.zoo.ResBlock",
    "pggan_tpu.models.zoo.res_block_apply": "pggan_tpu_torch.models.zoo.ResBlock.forward",
    "pggan_tpu.models.zoo.init_adain_res_block": "pggan_tpu_torch.models.zoo.AdaINResBlock",
    "pggan_tpu.models.zoo.adain_res_block_apply":
        "pggan_tpu_torch.models.zoo.AdaINResBlock.forward",
    "pggan_tpu.models.zoo.init_patch_discriminator":
        "pggan_tpu_torch.models.zoo.PatchDiscriminator",
    "pggan_tpu.models.zoo.patch_discriminator_apply":
        "pggan_tpu_torch.models.zoo.PatchDiscriminator.forward",
    "pggan_tpu.models.zoo.init_multiscale_discriminator":
        "pggan_tpu_torch.models.zoo.MultiscaleDiscriminator",
    "pggan_tpu.models.zoo.multiscale_discriminator_apply":
        "pggan_tpu_torch.models.zoo.MultiscaleDiscriminator.forward",
    "pggan_tpu.models.zoo.init_latent_discriminator":
        "pggan_tpu_torch.models.zoo.LatentDiscriminator",
    "pggan_tpu.models.zoo.latent_discriminator_apply":
        "pggan_tpu_torch.models.zoo.LatentDiscriminator.forward",
    "pggan_tpu.models.zoo.init_stargan_discriminator":
        "pggan_tpu_torch.models.zoo.StarGANDiscriminator",
    "pggan_tpu.models.zoo.stargan_discriminator_apply":
        "pggan_tpu_torch.models.zoo.StarGANDiscriminator.forward",
    # native/build.py
    "pggan_tpu.native.build.get_loader_lib": "same",
    "pggan_tpu.native.build.native_available": "same",
    # native/loader.py
    "pggan_tpu.native.loader.NativeImageLoader": "same",
    # ops/basic.py
    "pggan_tpu.ops.basic.leaky_relu": "same",
    "pggan_tpu.ops.basic.blend": "same",
    "pggan_tpu.ops.basic.pixel_norm": "same",
    "pggan_tpu.ops.basic.lrelu_pixel_norm": "same",
    "pggan_tpu.ops.basic.upscale2d": "same",
    "pggan_tpu.ops.basic.downscale2d": "same",
    "pggan_tpu.ops.basic.minibatch_stddev": "same",
    "pggan_tpu.ops.basic.bias_act": "same",
    "pggan_tpu.ops.basic.fma": "same",
    # ops/composite.py
    "pggan_tpu.ops.composite.filtered_lrelu": "same",
    "pggan_tpu.ops.composite.conv2d_resample": "same",
    "pggan_tpu.ops.composite.grid_sample": "same",
    # ops/equalized.py
    "pggan_tpu.ops.equalized.he_constant": "same",
    "pggan_tpu.ops.equalized.init_conv_params": "pggan_tpu_torch.ops.equalized.EqualizedConv2d",
    "pggan_tpu.ops.equalized.init_linear_params": "pggan_tpu_torch.ops.equalized.EqualizedLinear",
    "pggan_tpu.ops.equalized.equalized_conv2d": "same",
    "pggan_tpu.ops.equalized.equalized_linear": "same",
    # ops/fused_scale.py
    "pggan_tpu.ops.fused_scale.depth_to_space2":
        ("not ported", PACKED + ": the depth-to-space step of the sub-pixel and packed forms"),
    "pggan_tpu.ops.fused_scale.upscale_conv3x3_dilated": "same",
    "pggan_tpu.ops.fused_scale.upscale_conv3x3":
        ("not ported", "the sub-pixel (quarter-resolution, 4·C_out groups) form of "
                        "conv3x3(upscale2d(x)); the port's G computes every fused_scale setting "
                        "that took it with upscale_conv3x3_dilated, the same function "
                        "(models/generator.py:fuses_upscale)"),
    "pggan_tpu.ops.fused_scale.upscale_conv3x3_packed":
        ("not ported", PACKED + ": emits the packed layout"),
    # ops/packed.py
    "pggan_tpu.ops.packed.space_to_depth2": ("not ported", PACKED),
    "pggan_tpu.ops.packed.pack_conv3x3_kernel": ("not ported", PACKED),
    "pggan_tpu.ops.packed.pack_conv1x1_kernel": ("not ported", PACKED),
    "pggan_tpu.ops.packed.packed_equalized_conv2d": ("not ported", PACKED),
    "pggan_tpu.ops.packed.downscale2d_packed": ("not ported", PACKED),
    "pggan_tpu.ops.packed.upscale2d_packed": ("not ported", PACKED),
    "pggan_tpu.ops.packed.downscale2d_repack": ("not ported", PACKED),
    "pggan_tpu.ops.packed.pixel_norm_packed": ("not ported", PACKED),
    # ops/pallas_kernels.py
    "pggan_tpu.ops.pallas_kernels.pixel_norm": "pggan_tpu_torch.ops.kernels.pixel_norm",
    "pggan_tpu.ops.pallas_kernels.bias_lrelu_gain": "pggan_tpu_torch.ops.kernels.bias_lrelu_gain",
    "pggan_tpu.ops.pallas_kernels.lrelu_pixel_norm":
        "pggan_tpu_torch.ops.kernels.lrelu_pixel_norm",
    "pggan_tpu.ops.pallas_kernels.minibatch_stddev_stat":
        "pggan_tpu_torch.ops.kernels.minibatch_stddev_stat",
    # ops/resample.py
    "pggan_tpu.ops.resample.setup_filter": "same",
    "pggan_tpu.ops.resample.upfirdn2d": "same",
    "pggan_tpu.ops.resample.filter2d": "same",
    "pggan_tpu.ops.resample.upsample2d": "same",
    "pggan_tpu.ops.resample.downsample2d": "same",
    "pggan_tpu.ops.resample.bilinear_align_corners": "same",
    # parallel/mesh.py
    "pggan_tpu.parallel.mesh.create_mesh": "pggan_tpu_torch.parallel.mesh.init_distributed",
    "pggan_tpu.parallel.mesh.batch_sharding":
        ("not ported", MESH + ": a NamedSharding of the batch axis: a rank's batch is its shard"),
    "pggan_tpu.parallel.mesh.replicated_sharding":
        ("not ported", MESH + ": a replicated NamedSharding: every rank holds its own copy"),
    "pggan_tpu.parallel.mesh.shard_batch": "pggan_tpu_torch.data.pipeline.DataPipeline._to_device",
    "pggan_tpu.parallel.mesh.local_numpy":
        ("not ported", MESH + ": the host view of a process's shards of a global array"),
    "pggan_tpu.parallel.mesh.replicate": "pggan_tpu_torch.parallel.mesh.broadcast_",
    "pggan_tpu.parallel.mesh.global_batch_size": "same",
    # train/schedule.py
    "pggan_tpu.train.schedule.ProgressiveSchedule": "same",
    # train/step.py
    "pggan_tpu.train.step.TrainState": "same",
    "pggan_tpu.train.step.make_optimizers": "same",
    "pggan_tpu.train.step.init_train_state": "same",
    "pggan_tpu.train.step.resolve_hires_pack":
        ("not ported", PACKED + ": how many top levels run packed"),
    "pggan_tpu.train.step.make_train_step": "same",
    "pggan_tpu.train.step.make_chunked_train_step": "pggan_tpu_torch.train.graphs.StepGraphs",
    "pggan_tpu.train.step.resolve_steps_per_dispatch": "same",
    # train/trainer.py
    "pggan_tpu.train.trainer.ProgressiveGANTrainer": "same",
    # utils/checkpoint.py
    "pggan_tpu.utils.checkpoint.tree_to_arrays": "pggan_tpu_torch.ops.equalized.params_to_jax",
    "pggan_tpu.utils.checkpoint.arrays_to_tree":
        "pggan_tpu_torch.ops.equalized.load_params_from_jax",
    "pggan_tpu.utils.checkpoint.ckpt_dir": "same",
    "pggan_tpu.utils.checkpoint.save_checkpoint": "same",
    "pggan_tpu.utils.checkpoint.load_checkpoint": "same",
    # utils/compile_cache.py
    "pggan_tpu.utils.compile_cache.enable_compilation_cache":
        ("not ported", "JAX's persistent compilation cache; the port compiles no XLA program, "
                        "and its CUDA kernels build once a checkout into pggan_tpu_torch/_build"),
    # utils/debug.py
    "pggan_tpu.utils.debug.assert_shape": "same",
    "pggan_tpu.utils.debug.nan_to_num": "same",
    "pggan_tpu.utils.debug.profiled_function": "same",
    "pggan_tpu.utils.debug.check_replication_consistency": "same",
    "pggan_tpu.utils.debug.trace_context": "same",
    "pggan_tpu.utils.debug.copy_matching_leaves": "same",
    "pggan_tpu.utils.debug.print_tree_summary": "same",
    # utils/image.py
    "pggan_tpu.utils.image.unpack_space_to_depth":
        ("not ported", PACKED + ": undoes the packing of a generated batch on the host"),
    "pggan_tpu.utils.image.make_grid_image": "same",
    "pggan_tpu.utils.image.save_image": "same",
    # utils/logging.py
    "pggan_tpu.utils.logging.MetricLogger": "same",
    # utils/stats.py
    "pggan_tpu.utils.stats.report": "same",
    "pggan_tpu.utils.stats.report0": "same",
    "pggan_tpu.utils.stats.psum_moments": "pggan_tpu_torch.utils.stats.all_reduce_moments",
    "pggan_tpu.utils.stats.report_moments": "same",
    "pggan_tpu.utils.stats.Collector": "same",
    "pggan_tpu.utils.stats.reset": "same",
}


@functools.lru_cache(maxsize=None)
def _tree(path):
    with open(path, encoding="utf-8") as f:
        return ast.parse(f.read(), filename=path)


def _members(body):
    """name → node of the defs, classes and assigned names in `body`."""
    out = {}
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out.update((t.id, node) for t in targets if isinstance(t, ast.Name))
    return out


def _module_file(dotted):
    """The file of module `dotted` (a .py file or a package's __init__.py), or None."""
    base = os.path.join(REPO, *dotted.split("."))
    for path in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.isfile(path):
            return path
    return None


def jax_public_names():
    """{"pggan_tpu.<module>.<name>": (JAX file, port file of the same path)}
    for every public top-level def and class under pggan_tpu/."""
    names = {}
    root = os.path.join(REPO, JAX_PKG)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for filename in sorted(f for f in filenames if f.endswith(".py")):
            path = os.path.join(dirpath, filename)
            rel = os.path.relpath(path, REPO)[:-len(".py")].split(os.sep)
            module = ".".join(rel[:-1] if rel[-1] == "__init__" else rel)
            port = os.path.join(REPO, PORT_PKG, os.path.relpath(path, root))
            for node in _tree(path).body:
                if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                        and not node.name.startswith("_")):
                    names[f"{module}.{node.name}"] = (path, port)
    return names


def resolve(dotted):
    """Whether `dotted` names a module of the port, or a def, class or
    assignment in one, or a method or attribute of such a class."""
    parts = dotted.split(".")
    if parts[0] != PORT_PKG:
        return False
    for cut in range(len(parts), 0, -1):
        path = _module_file(".".join(parts[:cut]))
        if path is None:
            continue
        body = _tree(path).body
        for attr in parts[cut:]:
            node = _members(body).get(attr)
            if node is None:
                return False
            body = getattr(node, "body", [])
        return True
    return False


def kind(entry):
    if entry == "same":
        return "same"
    if isinstance(entry, tuple):
        return NOT_PORTED
    return "mapped"


JAX_NAMES = jax_public_names()
MODULES = sorted({name.rsplit(".", 1)[0] for name in COUNTERPARTS})


def test_every_public_jax_name_is_in_the_table():
    missing = sorted(set(JAX_NAMES) - set(COUNTERPARTS))
    assert not missing, f"public names of {JAX_PKG} with no COUNTERPARTS entry: {missing}"


def test_no_entry_names_a_missing_jax_name():
    stale = sorted(set(COUNTERPARTS) - set(JAX_NAMES))
    assert not stale, f"COUNTERPARTS entries that {JAX_PKG} no longer defines: {stale}"


@pytest.mark.parametrize("module", MODULES)
def test_counterparts_resolve(module):
    unresolved = []
    for name, entry in COUNTERPARTS.items():
        if name.rsplit(".", 1)[0] != module or kind(entry) == NOT_PORTED:
            continue
        if entry == "same":
            port = JAX_NAMES[name][1]
            leaf = name.rsplit(".", 1)[1]
            node = _members(_tree(port).body).get(leaf) if os.path.isfile(port) else None
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                unresolved.append(f"{name}: no def or class {leaf} in "
                                  f"{os.path.relpath(port, REPO)}")
        elif not isinstance(entry, str) or not resolve(entry):
            unresolved.append(f"{name} -> {entry!r}")
    assert not unresolved, "\n".join(unresolved)


def test_not_ported_entries_carry_reasons():
    for name, entry in COUNTERPARTS.items():
        if isinstance(entry, tuple):
            assert len(entry) == 2 and entry[0] == NOT_PORTED, (name, entry)
            assert isinstance(entry[1], str) and len(entry[1].split()) >= 5, (name, entry)
        else:
            assert entry == "same" or entry.startswith(PORT_PKG + "."), (name, entry)


def test_pallas_kernels_map_to_the_kernel_wrappers():
    """Each Pallas entry point has its CUDA kernel's wrapper, never "not ported"."""
    pallas = [n for n in COUNTERPARTS if n.startswith(f"{JAX_PKG}.ops.pallas_kernels.")]
    assert pallas
    for name in pallas:
        assert COUNTERPARTS[name] == f"{PORT_PKG}.ops.kernels.{name.rsplit('.', 1)[1]}", name


def test_resolve_rejects_what_the_port_lacks():
    assert resolve(f"{PORT_PKG}.models.generator.Generator.forward")
    assert resolve(f"{PORT_PKG}.registry.MODEL_REGISTRY")
    assert not resolve(f"{PORT_PKG}.models.generator.Generator.apply")
    assert not resolve(f"{PORT_PKG}.models.no_such_module.Generator")
    assert not resolve(f"{JAX_PKG}.models.generator.generator_apply")


if __name__ == "__main__":
    counts = Counter(kind(COUNTERPARTS[name]) for name in JAX_NAMES if name in COUNTERPARTS)
    print(f"{len(JAX_NAMES)} public names in {JAX_PKG}: {counts['same']} same, "
          f"{counts['mapped']} mapped, {counts[NOT_PORTED]} not ported")
