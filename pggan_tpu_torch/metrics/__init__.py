"""Generative metrics — the counterpart of `pggan_tpu/metrics/`: FID with
the random-conv or InceptionV3 extractor (`fid.py`, `inception.py`) and KID
(`kid.py`)."""

from pggan_tpu_torch.metrics.fid import (  # noqa: F401
    frechet_distance,
    frechet_distance_device,
    compute_activations,
    compute_activation_statistics,
    fid_between_sets,
    RandomConvFeatures,
)
from pggan_tpu_torch.metrics.kid import (  # noqa: F401
    kid_between_features,
    kid_between_sets,
    mmd2_unbiased,
    polynomial_kernel,
)
from pggan_tpu_torch.metrics.inception import (  # noqa: F401
    InceptionV3Features,
    convert_torchvision_state_dict,
    inception_v3_features,
    init_inception_v3,
)
