"""The port's device-resident data cache (`pggan_tpu_torch/data/device_cache.py`)
against the JAX package's, on the CPU.

`assemble_batch` on the same numpy-seeded images, indices and parameters:
bit for bit where no hue rotation runs (augmentation off, flips, each of
brightness, contrast and saturation alone, all three with the hue off by
its sentinel), within one step of 255 with the hue on (hue-sector ties
included). The whole cache against JAX's on one folder and one list of
seeds (on the native loader and on the PIL path); against the port's own
PIL path and its native loader, each as far as JAX's cache is from the
same JAX path; the gate; the
pipeline's `assemble_fn` stream; and `python -m pggan_tpu_torch.train` with
the cache against the host pipeline.
"""

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from pggan_tpu.data.augment import draw_augment_params as jax_draw
from pggan_tpu.data.device_cache import DeviceDataCache as JaxCache
from pggan_tpu.data.device_cache import assemble_batch as jax_assemble
from pggan_tpu.data.dataset import ImageFolderDataset as JaxFolder
from pggan_tpu.parallel import create_mesh
from pggan_tpu_torch import train as port_train
from pggan_tpu_torch.config import Config
from pggan_tpu_torch.data.augment import DEFAULT_JITTER, draw_augment_params
from pggan_tpu_torch.data.dataset import ImageFolderDataset, SyntheticDataset
from pggan_tpu_torch.data.device_cache import (DeviceDataCache, assemble_batch,
                                               resolve_device_data_cache)
from pggan_tpu_torch.data.pipeline import DataPipeline
from pggan_tpu_torch.native import native_available
from pggan_tpu_torch.utils import checkpoint as port_ckpt

SCALE = 3                  # 32×32 samples from 32-px sources: no resampling


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """5 PNGs of 32×32, as tests/test_device_cache.py's fixture."""
    root = tmp_path_factory.mktemp("faces")
    rs = np.random.RandomState(7)
    for i in range(5):
        arr = rs.randint(0, 256, (32, 32, 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / f"img{i}.png")
    return str(root)


@pytest.fixture(scope="module")
def jax_assemble_fn():
    return jax.jit(jax_assemble)


def _data(seed=0, n=6, side=16):
    """Random uint8 images with hue-sector ties: r = g on image 0, g = b on
    image 1, gray on image 2."""
    rs = np.random.RandomState(seed)
    data = rs.randint(0, 256, (n, side, side, 3), dtype=np.uint8)
    data[0, ..., 1] = data[0, ..., 0]
    data[1, ..., 2] = data[1, ..., 1]
    data[2, ..., 1:] = data[2, ..., :1]
    return data


def _params(batch, seed=100):
    """Each sample's (flip, factors, order), drawn by the JAX package."""
    flips, factors, orders = zip(*(jax_draw(np.random.RandomState(seed + i))
                                   for i in range(batch)))
    return np.array(flips, np.int32), np.stack(factors), np.stack(orders)


def _both(jax_fn, data, idx, flips, factors, orders):
    want = np.asarray(jax_fn(data, idx, flips, factors, orders))
    got = assemble_batch(*(torch.from_numpy(a) for a in (data, idx, flips, factors, orders)))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    return got.numpy(), want


def test_draw_matches_jax():
    for seed in (0, 5, 99):
        for augment in (True, False):
            ours = draw_augment_params(np.random.RandomState(seed), DEFAULT_JITTER, augment)
            theirs = jax_draw(np.random.RandomState(seed), DEFAULT_JITTER, augment)
            for a, b in zip(ours, theirs):
                np.testing.assert_array_equal(a, b)


# which factors keep their draw; the others take their sentinel
_BIT_EXACT = {"off": (), "flips": (), "brightness": (0,), "contrast": (1,),
              "saturation": (2,), "hue_off": (0, 1, 2)}


@pytest.mark.parametrize("case", list(_BIT_EXACT))
def test_assemble_bit_for_bit_with_jax(jax_assemble_fn, case):
    data = _data()
    idx = np.array([3, 0, 5, 1, 2, 0, 4, 1], np.int32)
    flips, drawn, orders = _params(len(idx))
    factors = np.array([-1.0, -1.0, -1.0, -2.0], np.float32)[None].repeat(len(idx), 0)
    for j in _BIT_EXACT[case]:
        factors[:, j] = drawn[:, j]
    if case == "off":
        flips[:] = 0
        orders = np.arange(4, dtype=np.int32)[None].repeat(len(idx), 0)
    got, want = _both(jax_assemble_fn, data, idx, flips, factors, orders)
    np.testing.assert_array_equal(got, want)
    if case in ("off", "flips"):
        flipped = np.where(flips[:, None, None, None] > 0, data[idx][:, :, ::-1], data[idx])
        np.testing.assert_array_equal(got, flipped)


def test_assemble_jitter_within_one_lsb_of_jax(jax_assemble_fn):
    data = _data(seed=1)
    idx = np.array([0, 1, 2, 3, 4, 5, 0, 1, 2, 3, 4, 5], np.int32)
    flips, factors, orders = _params(len(idx), seed=7)
    got, want = _both(jax_assemble_fn, data, idx, flips, factors, orders)
    delta = np.abs(got.astype(int) - want.astype(int))
    assert delta.max() <= 1 and delta.mean() < 0.01
    assert not np.array_equal(got, data[idx])          # the jitter ran


@pytest.mark.parametrize("native", [True, False])
def test_cache_matches_jax_cache(image_dir, native):
    if native and not native_available():
        pytest.skip("native loader build failed")
    idxs, seeds = [0, 1, 2, 3, 4], [11, 22, 33, 44, 55]
    ours = DeviceDataCache(ImageFolderDataset([image_dir], SCALE, use_native=native), "cpu")
    theirs = JaxCache(JaxFolder([image_dir], SCALE, use_native=native), create_mesh())
    assert (ours.n_images, ours.nbytes) == (theirs.n_images, theirs.nbytes) == (5, 5 * 32 * 32 * 3)
    got = ours.assemble(idxs, seeds)
    want = np.asarray(theirs.assemble(idxs, seeds))
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    delta = np.abs(got.numpy().astype(int) - want.astype(int))
    assert delta.max() <= 1


def test_cache_against_the_pil_path(image_dir):
    """The cache against the port's PIL path: bit for bit without
    augmentation; with it, as far from it as the JAX package's cache is from
    the JAX package's PIL path (the same pixels within one step of 255). The
    PIL path rounds to uint8 between ops and turns the hue through 8-bit
    HSV, so on these noise images both packages differ from it by up to 9
    steps, 1.54 on average. (tests/test_device_cache.py's bounds of 6 and
    1.0 hold its cache against its C++ loader: the next test.)"""
    seeds, idxs = [11, 22, 33, 44, 55], [0, 1, 2, 3, 4]
    ds = ImageFolderDataset([image_dir], SCALE, use_native=False)
    got = DeviceDataCache(ds, "cpu").assemble(idxs, seeds).numpy().astype(int)
    pil = np.stack([ds.get(i, np.random.RandomState(s)) for i, s in zip(idxs, seeds)])
    theirs = JaxFolder([image_dir], SCALE, use_native=False)
    want = np.asarray(JaxCache(theirs, create_mesh()).assemble(idxs, seeds)).astype(int)
    jax_pil = np.stack([theirs.get(i, np.random.RandomState(s)) for i, s in zip(idxs, seeds)])
    np.testing.assert_array_equal(pil, jax_pil)
    delta, jax_delta = np.abs(got - pil), np.abs(want - pil)
    assert np.abs(delta - jax_delta).max() <= 1
    assert abs(delta.max() - jax_delta.max()) <= 1 and abs(delta.mean() - jax_delta.mean()) < 0.01
    plain = ImageFolderDataset([image_dir], SCALE, augment=False, use_native=False)
    cache = DeviceDataCache(plain, "cpu")
    for idxs in ([4, 2], [7, 12]):                     # 7, 12: modulo the 5 images
        got = cache.assemble(idxs, [1, 2]).numpy()
        want = np.stack([plain.get(i, np.random.RandomState(s)) for i, s in zip(idxs, (1, 2))])
        np.testing.assert_array_equal(got, want)


def test_cache_against_the_native_path(image_dir):
    """The cache against the dataset at its default, the native loader
    (jitter in float, rounded once, like the cache's): within
    tests/test_device_cache.py's bounds for the JAX package's pair (6
    steps, 1.0 on average), and as far from it as the JAX package's cache
    is from the JAX package's loader (within one step). Bit for bit without
    augmentation."""
    if not native_available():
        pytest.skip("native loader build failed")
    seeds, idxs = [11, 22, 33, 44, 55], [0, 1, 2, 3, 4]
    ds = ImageFolderDataset([image_dir], SCALE)
    assert ds.backend == "native"
    got = DeviceDataCache(ds, "cpu").assemble(idxs, seeds).numpy().astype(int)
    host = np.stack([ds.get(i, np.random.RandomState(s)) for i, s in zip(idxs, seeds)])
    theirs = JaxFolder([image_dir], SCALE)
    want = np.asarray(JaxCache(theirs, create_mesh()).assemble(idxs, seeds)).astype(int)
    np.testing.assert_array_equal(
        host, np.stack([theirs.get(i, np.random.RandomState(s)) for i, s in zip(idxs, seeds)]))
    delta, jax_delta = np.abs(got - host), np.abs(want - host)
    assert delta.max() <= 6 and delta.mean() < 1.0
    assert np.abs(delta - jax_delta).max() <= 1
    plain = ImageFolderDataset([image_dir], SCALE, augment=False)
    got = DeviceDataCache(plain, "cpu").assemble([4, 2], [1, 2]).numpy()
    np.testing.assert_array_equal(got, np.stack([plain.get(4, None), plain.get(2, None)]))


def test_gate(image_dir):
    ds = ImageFolderDataset([image_dir], SCALE)
    assert resolve_device_data_cache(Config({"device_data_cache": "auto"}), ds)
    assert not resolve_device_data_cache(Config(), ds)                     # default off
    assert not resolve_device_data_cache(
        Config({"device_data_cache": "auto", "device_cache_mb": 0}), ds)
    assert not resolve_device_data_cache(Config({"device_data_cache": "auto"}), ds,
                                         num_replicas=2)
    assert not resolve_device_data_cache(Config({"device_data_cache": "auto"}),
                                         SyntheticDataset(8, 0))
    assert resolve_device_data_cache(Config({"device_data_cache": True}), ds)
    for over, n in (({"device_cache_mb": 0}, 1), ({}, 2)):
        with pytest.raises(ValueError, match="device_data_cache=true requires"):
            resolve_device_data_cache(Config({"device_data_cache": True, **over}), ds,
                                      num_replicas=n)
    with pytest.raises(ValueError, match="ImageFolderDataset"):
        resolve_device_data_cache(Config({"device_data_cache": True}), SyntheticDataset(8, 0))


@pytest.mark.parametrize("start", [0, 3])
def test_pipeline_assemble_fn_keeps_the_stream(image_dir, start):
    """The same (indices, seeds) reach assemble_fn as the workers would
    load, across epochs and a fast-forward; with augmentation off its
    batches equal the host pipeline's bit for bit."""
    ds = ImageFolderDataset([image_dir], SCALE, augment=False)
    kw = dict(num_workers=2, prefetch_depth=2, seed=5, start_batch=start)
    seen = []

    def recording(idxs, seeds):
        seen.append((np.array(idxs), np.array(seeds)))
        return len(seen)
    with DataPipeline(ds, 4, **kw) as reference:
        stream = reference._draws()
        want = [next(stream) for _ in range(start + 4)][start:]
    cache = DeviceDataCache(ds, "cpu")
    with DataPipeline(ds, 4, **kw) as host, \
            DataPipeline(ds, 4, assemble_fn=cache.assemble, **kw) as dev, \
            DataPipeline(ds, 4, assemble_fn=recording, **kw) as rec:
        for i in range(4):
            np.testing.assert_array_equal(next(dev).numpy(), next(host).numpy())
            assert next(rec) == i + 1
    for (idxs, seeds), (want_idxs, want_seeds) in zip(seen, want):
        np.testing.assert_array_equal(idxs, want_idxs)
        np.testing.assert_array_equal(seeds, want_seeds)


def test_pipeline_assemble_error_reaches_the_consumer(image_dir):
    def failing(idxs, seeds):
        raise RuntimeError("assemble failed")
    ds = ImageFolderDataset([image_dir], SCALE)
    with DataPipeline(ds, 2, num_workers=1, assemble_fn=failing) as pipe:
        with pytest.raises(RuntimeError, match="assemble failed"):
            next(pipe)


def test_train_main_with_the_cache_equals_the_host_pipeline(image_dir, tmp_path, capsys):
    """Two steps through the entry point on the CPU, augmentation off: the
    cache run's checkpoint equals the host-pipeline run's bit for bit."""
    keys = {"latent_dim": 16, "depths": [16, 8], "batch_per_gpu": 4,
            "save_root": str(tmp_path), "data_backend": "folder",
            "dataset_root_list": [image_dir], "num_data_workers": 2, "augment": False,
            "loss_cycle": 1, "test_cycle": 100, "ckpt_cycle": 100}
    finals = {}
    for run, over in (("host", {}), ("cache", {"device_data_cache": True})):
        config = tmp_path / f"{run}.yaml"
        config.write_text(yaml.safe_dump(dict(keys, **over)))
        assert port_train.main([run, "--config", str(config), "--max_step", "2",
                                "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert ("device data cache: 5 images, 0.0 MB on cpu" in out) == (run == "cache")
        finals[run] = {name: port_ckpt.load_checkpoint(str(tmp_path), run, name, 2)[0]
                       for name in ("G", "D")}
    for name in ("G", "D"):
        assert set(finals["host"][name]) == set(finals["cache"][name])
        for key, want in finals["host"][name].items():
            np.testing.assert_array_equal(finals["cache"][name][key], want,
                                          err_msg=f"{name} {key}")
