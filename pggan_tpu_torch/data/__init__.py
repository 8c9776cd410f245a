"""The port's data: the names `pggan_tpu/data/__init__.py` exports. Importing
this touches no card and builds nothing: the native loader builds on a
dataset's first use."""

from pggan_tpu_torch.data.dataset import (  # noqa: F401
    ImageFolderDataset,
    SyntheticDataset,
    PairedFaceDataset,
    PairedValidDataset,
    list_image_paths,
    split_dataset,
    build_dataset,
)
from pggan_tpu_torch.data.pipeline import DataPipeline, InfiniteSampler  # noqa: F401
