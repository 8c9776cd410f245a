"""Kernel wrappers, their plain versions, and the tensor ops — the
counterparts of `pggan_tpu/ops/__init__.py`'s exports that the port has."""

from pggan_tpu_torch.ops.basic import (  # noqa: F401
    bias_act,
    blend,
    downscale2d,
    leaky_relu,
    minibatch_stddev,
    pixel_norm,
    upscale2d,
)
from pggan_tpu_torch.ops.composite import (  # noqa: F401
    conv2d_resample,
    filtered_lrelu,
    grid_sample,
)
from pggan_tpu_torch.ops.equalized import (  # noqa: F401
    equalized_conv2d,
    equalized_linear,
    he_constant,
)
from pggan_tpu_torch.ops.resample import (  # noqa: F401
    downsample2d,
    filter2d,
    setup_filter,
    upfirdn2d,
    upsample2d,
)
