"""The port's folder data against the JAX package's, on the native C++
loader and on the PIL path: the glob, `ImageFolderDataset.get` with
augmentation on and off, decoded once into RAM or not, the resized store,
`DataPipeline` for rank 0 of 1 and rank 1 of 2 with and without a
fast-forward, and the sample grid.

The JAX package's data modules are numpy, PIL and its C++ loader, so
nothing here compiles a JAX program. Both packages' `ImageFolderDataset`
take the same `use_native` (the two loaders draw differently by design;
tests/test_torch_native.py holds the defaults). Every comparison is exact.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from pggan_tpu.data import dataset as jax_dataset
from pggan_tpu.data.pipeline import DataPipeline as JaxPipeline
from pggan_tpu.utils import image as jax_image
from pggan_tpu_torch.config import Config
from pggan_tpu_torch.data import dataset
from pggan_tpu_torch.data.pipeline import DataPipeline
from pggan_tpu_torch.native import build, native_available
from pggan_tpu_torch.utils import image

SCALE = 2                  # 16×16 samples from 16-24 px sources
LOADERS = ["native", "PIL"]


def _use_native(loader):
    """`use_native` for a loader; the native case skips where the loader
    does not build (tests/test_native.py skips there too)."""
    if loader == "native" and not native_available():
        pytest.skip("native loader build failed")
    return loader == "native"


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    """8 images of 16-24 px, PNG and JPEG, at the root and two levels down."""
    root = tmp_path_factory.mktemp("images")
    rs = np.random.RandomState(0)
    for i, sub in enumerate(["", "a", "a/b", "", "a", "a/b", "c", "c"]):
        os.makedirs(root / sub, exist_ok=True)
        h, w = rs.randint(16, 25, size=2)
        arr = rs.randint(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / sub / f"im{i}.{'png' if i % 2 else 'jpg'}")
    (root / "notes.txt").write_text("not an image")
    return str(root)


def test_list_image_paths_matches_jax(image_root):
    paths = dataset.list_image_paths([image_root])
    assert paths == jax_dataset.list_image_paths([image_root])
    assert len(paths) == 8


@pytest.mark.parametrize("loader", LOADERS)
@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("cache", [True, False])
def test_get_matches_jax(image_root, augment, cache, loader):
    native = _use_native(loader)
    ours = dataset.ImageFolderDataset([image_root], SCALE, augment=augment,
                                      cache_decoded=cache, use_native=native)
    theirs = jax_dataset.ImageFolderDataset([image_root], SCALE, augment=augment,
                                            cache_decoded=cache, use_native=native)
    assert ours.paths == theirs.paths and (ours._cache is not None) == cache
    assert ours.backend == loader
    for i in range(len(ours)):
        for seed in (0, 7, 12345):
            got = ours.get(i, np.random.RandomState(seed))
            want = theirs.get(i, np.random.RandomState(seed))
            assert got.dtype == np.uint8 and got.shape == (16, 16, 3)
            np.testing.assert_array_equal(got, want, err_msg=f"{i} {seed}")


@pytest.mark.parametrize("loader", LOADERS)
def test_resized_store_matches_ram_cache(image_root, tmp_path, loader):
    native = _use_native(loader)
    cached = dataset.ImageFolderDataset([image_root], SCALE, cache_decoded=True,
                                        use_native=native)
    stored = dataset.ImageFolderDataset([image_root], SCALE, resized_store=True,
                                        store_dir=str(tmp_path / "port"), use_native=native)
    theirs = jax_dataset.ImageFolderDataset([image_root], SCALE, resized_store=True,
                                            store_dir=str(tmp_path / "jax"),
                                            use_native=native)
    assert stored._store is not None and stored._cache is None
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for i in range(len(cached)):
        np.testing.assert_array_equal(stored.resized_array(i), cached.resized_array(i))
        got = stored.get(i, np.random.RandomState(i))
        np.testing.assert_array_equal(got, cached.get(i, np.random.RandomState(i)))
        np.testing.assert_array_equal(got, theirs.get(i, np.random.RandomState(i)))


@pytest.mark.parametrize("loader", LOADERS)
@pytest.mark.parametrize("rank, replicas", [(0, 1), (1, 2)])
@pytest.mark.parametrize("start", [0, 3])
def test_pipeline_matches_jax(image_root, rank, replicas, start, loader):
    """Batches past two epochs (6 train indices, batch 2: 3 batches an
    epoch for rank 0 of 1, 1 for rank 1 of 2), the same split, seed and
    fast-forward."""
    native = _use_native(loader)
    ours = dataset.ImageFolderDataset([image_root], SCALE, use_native=native)
    theirs = jax_dataset.ImageFolderDataset([image_root], SCALE, use_native=native)
    indices, _ = dataset.split_dataset(len(ours), 0.7, seed=3)
    kwargs = dict(indices=indices, num_workers=2, prefetch_depth=2, seed=11,
                  rank=rank, num_replicas=replicas, start_batch=start)
    with DataPipeline(ours, 2, **kwargs) as pipe, JaxPipeline(theirs, 2, **kwargs) as ref:
        for _ in range(5):
            got, want = next(pipe), next(ref)
            assert got.dtype == torch.uint8 and got.shape == (2, 16, 16, 3)
            assert got.device == torch.device("cpu")
            np.testing.assert_array_equal(got.numpy(), want)


class _Failing:
    def __len__(self):
        return 6

    def get(self, index, rng):
        if index == 4:
            raise OSError("cannot decode image 4")
        return np.zeros((4, 4, 3), np.uint8)


def test_pipeline_raises_worker_error_and_closes():
    """A loader's exception reaches the consumer; close() stops the
    producer thread."""
    pipe = DataPipeline(_Failing(), 6, num_workers=2, seed=0)
    with pytest.raises(OSError, match="image 4"):
        next(pipe)
    pipe.close()
    assert not pipe._thread.is_alive()
    with DataPipeline(_Failing(), 1, indices=[0, 1], num_workers=1) as pipe:
        assert next(pipe).shape == (1, 4, 4, 3)
    assert not pipe._thread.is_alive()


def test_build_dataset_folder(image_root, tmp_path, monkeypatch):
    cfg = Config({"data_backend": "auto", "dataset_root_list": [image_root],
                  "save_root": str(tmp_path)})
    ds = dataset.build_dataset(cfg, 1)
    assert isinstance(ds, dataset.ImageFolderDataset) and ds.resolution == 8
    assert len(ds) == 8 and ds._cache is not None and ds.augment
    cfg.dataset_root_list = [str(tmp_path / "missing")]
    assert isinstance(dataset.build_dataset(cfg, 1), dataset.SyntheticDataset)
    cfg.data_backend = "folder"
    with pytest.raises(FileNotFoundError):
        dataset.build_dataset(cfg, 1)
    # a loader that does not build: use_native=True raises, None takes PIL
    monkeypatch.setattr(build, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_tried", False)
    with pytest.raises(RuntimeError, match="native loader requested but its build failed"):
        dataset.ImageFolderDataset([image_root], 1, use_native=True)
    assert dataset.ImageFolderDataset([image_root], 1).backend == "PIL"


def test_sample_grid_matches_jax(tmp_path):
    rs = np.random.RandomState(5)
    batches = [rs.uniform(-1.2, 1.2, (n, 6, 6, 3)).astype(np.float32) for n in (3, 10, 5)]
    grid = image.make_grid_image(batches)
    np.testing.assert_array_equal(grid, jax_image.make_grid_image(batches))
    assert grid.shape == (3 * 10, 8 * 8 + 2, 3)
    ours = image.save_image(str(tmp_path), "p", 7, "imgs", batches[:2])
    theirs = jax_image.save_image(str(tmp_path), "j", 7, "imgs", batches[:2])
    assert ours.endswith(os.path.join("p", "imgs", "e7.jpg"))
    np.testing.assert_array_equal(np.asarray(Image.open(ours)), np.asarray(Image.open(theirs)))
