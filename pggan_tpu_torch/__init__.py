"""pggan_tpu_torch — the PyTorch / CUDA port of pggan_tpu for NVIDIA Hopper.

The JAX package `pggan_tpu` is the reference; this package keeps its module
names so each counterpart is easy to find. Ported so far: generator
sampling (`pggan_tpu_torch.demo`), training (`pggan_tpu_torch.train`, the
r1 and wgangp train step, the trainer with lazy R1, folder and synthetic
data through a prefetching pipeline or grain's, the native C++ image loader
(`pggan_tpu_torch.native`), sample grids, metrics, SIGTERM
checkpoints and exact resume, validation and FID/KID, data-parallel
training on several cards with `--use_mGPU`, `pggan_tpu_torch.parallel`),
the import of a reference-trained PyTorch checkpoint
(`pggan_tpu_torch.import_ckpt`), the offline evaluation of a checkpoint
(`pggan_tpu_torch.eval_metrics`, `pggan_tpu_torch.metrics`), the
submodel zoo (`pggan_tpu_torch.models`), the face-swap pair datasets and
StyleGAN2's streaming sampler (`pggan_tpu_torch.data`), the model registry
(`register_model`, `create_model`) and the StyleGAN2-ops layer
(`pggan_tpu_torch.ops`), with hand-written CUDA kernels for `pixel_norm`,
`lrelu_pixel_norm` (forward and backward), `minibatch_stddev_stat` and
`bias_lrelu_gain` (`ops/kernels.py`, `csrc/`).
"""

from pggan_tpu_torch.config import Config  # noqa: F401
from pggan_tpu_torch.models.generator import (  # noqa: F401
    Generator,
    load_params_from_jax,
    params_from_jax,
    params_to_jax,
)
from pggan_tpu_torch.registry import MODEL_REGISTRY, create_model, register_model  # noqa: F401
