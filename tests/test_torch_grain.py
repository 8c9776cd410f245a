"""The port's grain pipeline (`pggan_tpu_torch/data/grain_pipeline.py`)
against the JAX package's (`pggan_tpu/data/grain_pipeline.py`), and the
trainer's `data_backend_impl`, on the CPU.

Both pipelines wrap the same `grain.MapDataset` graph over the same folder
dataset (PIL path, so the check is the stream, not the loader): batches
past two epochs equal byte for byte for rank 0 of 1 and rank 1 of 2, with
and without a fast-forward. Nothing here compiles a JAX program.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

pytest.importorskip("grain")

from pggan_tpu.data.dataset import ImageFolderDataset as JaxFolder  # noqa: E402
from pggan_tpu.data.grain_pipeline import GrainPipeline as JaxGrain  # noqa: E402
from pggan_tpu_torch import registry  # noqa: E402
from pggan_tpu_torch.config import Config  # noqa: E402
from pggan_tpu_torch.data.dataset import ImageFolderDataset, split_dataset  # noqa: E402
from pggan_tpu_torch.data.grain_pipeline import GrainPipeline  # noqa: E402
from pggan_tpu_torch.data.pipeline import DataPipeline  # noqa: E402

SCALE = 2                  # 16×16 samples


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    """10 images of 16-24 px, PNG and JPEG."""
    root = tmp_path_factory.mktemp("grain")
    rs = np.random.RandomState(4)
    for i in range(10):
        h, w = rs.randint(16, 25, size=2)
        arr = rs.randint(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(root, f"im{i}.{'png' if i % 2 else 'jpg'}"))
    return str(root)


@pytest.mark.parametrize("rank, replicas", [(0, 1), (1, 2)])
@pytest.mark.parametrize("start", [0, 3])
def test_batches_match_jax(image_root, rank, replicas, start):
    """7 train indices, batch 2: 3 batches an epoch for rank 0 of 1, 1 for
    rank 1 of 2 (the shuffle truncated to 6); 6 batches cross the epochs."""
    ours = ImageFolderDataset([image_root], SCALE, use_native=False)
    theirs = JaxFolder([image_root], SCALE, use_native=False)
    indices, _ = split_dataset(len(ours), 0.7, seed=3)
    kwargs = dict(indices=indices, num_workers=2, prefetch_depth=2, seed=11,
                  rank=rank, num_replicas=replicas, start_batch=start)
    ref = JaxGrain(theirs, 2, **kwargs)
    try:
        with GrainPipeline(ours, 2, **kwargs) as pipe:
            for _ in range(6):
                got, want = next(pipe), next(ref)
                assert got.dtype == torch.uint8 and got.shape == (2, 16, 16, 3)
                assert got.device == torch.device("cpu")
                np.testing.assert_array_equal(got.numpy(), want)
    finally:
        ref.close()


def _keys(tmp_path, image_root, **over):
    return {"latent_dim": 16, "depths": [16, 8], "batch_per_gpu": 4,
            "save_root": str(tmp_path), "data_backend": "folder",
            "dataset_root_list": [image_root], "num_data_workers": 2,
            "device_data_cache": "auto", **over}


def test_trainer_takes_grain_without_the_device_cache(image_root, tmp_path):
    """`data_backend_impl: grain` builds a GrainPipeline with the trainer's
    seed, split and batch, and no device cache even where `auto` would take
    one; two steps run through it."""
    trainer = registry.create_model(
        Config(_keys(tmp_path, image_root, data_backend_impl="grain")), device="cpu")
    try:
        assert isinstance(trainer._pipeline, GrainPipeline)
        batch = next(trainer._pipeline)
        ref = JaxGrain(JaxFolder([image_root], 0), 4, indices=trainer._train_indices,
                       num_workers=1, seed=42)
        try:
            np.testing.assert_array_equal(batch.numpy(), next(ref))
        finally:
            ref.close()
        trainer.train_step()
        trainer.train_step()
    finally:
        trainer.close()
    threads = registry.create_model(Config(_keys(tmp_path, image_root)), device="cpu")
    try:                                # the thread pipeline takes the cache
        assert isinstance(threads._pipeline, DataPipeline)
        assert threads._pipeline.assemble_fn is not None
    finally:
        threads.close()


def test_unknown_data_backend_impl_raises(image_root, tmp_path):
    with pytest.raises(ValueError, match="data_backend_impl 'tf.data'"):
        registry.create_model(
            Config(_keys(tmp_path, image_root, data_backend_impl="tf.data")), device="cpu")
