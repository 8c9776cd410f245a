"""The last data pieces of the port against the JAX package's: the face-swap
pair datasets (`PairedFaceDataset`, `PairedValidDataset`) byte for byte,
StyleGAN2's streaming `InfiniteSampler` index for index, the model
registry's `register_model`, and the import surface of
`pggan_tpu_torch.data`.

Both packages' classes are numpy and PIL, so nothing here compiles a JAX
program. Every comparison is exact.
"""

import ast
import inspect
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from pggan_tpu.data import dataset as jax_dataset
from pggan_tpu.data import pipeline as jax_pipeline
from pggan_tpu_torch import data, registry
from pggan_tpu_torch.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_SIZES = (5, 9)                 # two roots of unequal size
VALID_SOURCES, VALID_TARGETS = 4, 3
DRAWS = 64
STREAM = 1000


def _write_images(folder, count, rs):
    """`count` images of 16-32 px, JPEG and PNG, half one level down."""
    for i in range(count):
        sub = os.path.join(folder, "deeper") if i % 2 else folder
        os.makedirs(sub, exist_ok=True)
        h, w = rs.randint(16, 33, size=2)
        arr = rs.randint(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(sub, f"im{i}.{'png' if i % 3 else 'jpg'}"))


@pytest.fixture(scope="module")
def face_roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("faces")
    rs = np.random.RandomState(13)
    roots = []
    for r, count in enumerate(ROOT_SIZES):
        roots.append(str(base / f"identity{r}"))
        _write_images(roots[-1], count, rs)
    return roots


@pytest.fixture(scope="module")
def valid_dir(tmp_path_factory):
    base = tmp_path_factory.mktemp("valid")
    rs = np.random.RandomState(14)
    for side, count in (("source", VALID_SOURCES), ("target", VALID_TARGETS)):
        _write_images(str(base / side), count, rs)
    return str(base)


@pytest.mark.parametrize("resolution", [16, 32])
@pytest.mark.parametrize("same_prob", [0.0, 0.2, 1.0])
def test_paired_face_dataset_matches_jax(face_roots, same_prob, resolution):
    ours = data.PairedFaceDataset(face_roots, same_prob=same_prob, resolution=resolution)
    theirs = jax_dataset.PairedFaceDataset(face_roots, same_prob=same_prob,
                                           resolution=resolution)
    assert ours.per_root == theirs.per_root and ours.paths == theirs.paths
    assert [len(ps) for ps in ours.per_root] == list(ROOT_SIZES)
    n = len(ours)
    sames = []
    for k in range(DRAWS):
        index, seed = (7 * k) % (3 * n), 1000 + k      # indices past the end wrap
        xs, xt, same = ours.get(index, np.random.RandomState(seed))
        want = theirs.get(index, np.random.RandomState(seed))
        for got, ref in ((xs, want[0]), (xt, want[1])):
            assert got.dtype == np.uint8 and got.shape == (resolution, resolution, 3)
            np.testing.assert_array_equal(got, ref, err_msg=f"index {index} seed {seed}")
        assert type(same) is int and same == want[2]
        sames.append(same)
    expected = {0.0: {0}, 1.0: {1}}.get(same_prob, {0, 1})
    assert set(sames) == expected


@pytest.mark.parametrize("resolution", [16, 32])
def test_paired_valid_dataset_matches_jax(valid_dir, resolution):
    ours = data.PairedValidDataset(valid_dir, resolution=resolution)
    theirs = jax_dataset.PairedValidDataset(valid_dir, resolution=resolution)
    assert len(ours) == len(theirs) == min(VALID_SOURCES, VALID_TARGETS)
    assert ours.source_paths == theirs.source_paths == sorted(ours.source_paths)
    assert ours.target_paths == theirs.target_paths
    assert len(ours.source_paths) == VALID_SOURCES
    for i in range(len(ours)):
        got, want = ours.get(i), theirs.get(i)
        assert len(got) == 2
        for a, b in zip(got, want):
            assert a.dtype == np.uint8 and a.shape == (resolution, resolution, 3)
            np.testing.assert_array_equal(a, b)


def test_paired_datasets_refuse_an_empty_folder(tmp_path):
    with pytest.raises(FileNotFoundError):
        data.PairedFaceDataset([str(tmp_path)])
    assert len(data.PairedValidDataset(str(tmp_path))) == 0


def _stream(cls, size, **options):
    return list(itertools.islice(iter(cls(size, **options)), STREAM))


@pytest.mark.parametrize("size", [10, 1])
@pytest.mark.parametrize("window_size", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("shuffle", [True, False])
def test_infinite_sampler_matches_jax(shuffle, window_size, size):
    options = dict(shuffle=shuffle, window_size=window_size, seed=3)
    whole = _stream(data.InfiniteSampler, size, num_replicas=1, **options)
    streams = []
    for rank in range(4):
        kw = dict(options, rank=rank, num_replicas=4)
        got = _stream(data.InfiniteSampler, size, **kw)
        assert got == _stream(jax_pipeline.InfiniteSampler, size, **kw), rank
        assert all(0 <= i < size for i in got)
        if not shuffle:
            assert got == [(rank + 4 * k) % size for k in range(STREAM)]
        streams.append(got)
    # the ranks' streams partition the positions of the one-replica stream
    assert [s[k] for k in range(STREAM // 4) for s in streams] == whole


def test_infinite_sampler_refuses_bad_arguments():
    for size, kw in ((0, {}), (4, dict(rank=2, num_replicas=2)), (4, dict(window_size=1.5)),
                     (4, dict(num_replicas=0))):
        with pytest.raises(ValueError):
            data.InfiniteSampler(size, **kw)


class _Dummy:
    def __init__(self, cfg, *, device):
        self.cfg, self.device, self.ready = cfg, device, False

    def setup(self):
        self.ready = True
        return self


def test_register_model_builds_a_registered_family():
    assert inspect.signature(registry.create_model).parameters["device"].default == "cuda"
    assert registry.register_model("dummy")(_Dummy) is _Dummy
    try:
        trainer = registry.create_model(Config({"model_id": "dummy"}), device="cpu")
        assert isinstance(trainer, _Dummy) and trainer.ready and trainer.device == "cpu"
        with pytest.raises(KeyError, match="'dummy'"):
            registry.create_model(Config({"model_id": "unknown"}), device="cpu")
    finally:
        registry.MODEL_REGISTRY.pop("dummy")


# the names `pggan_tpu/data/__init__.py` exports, read without importing it
DATA_NAMES = tuple(alias.name for node in ast.parse(open(
    os.path.join(REPO, "pggan_tpu", "data", "__init__.py")).read()).body
    if isinstance(node, ast.ImportFrom) for alias in node.names)

IMPORT_CHILD = """
import subprocess, sys
import torch

def refuse(*args, **kwargs):
    raise AssertionError("called at import time")

for name in ("is_available", "init", "current_device", "device_count", "_lazy_init"):
    setattr(torch.cuda, name, refuse)
subprocess.Popen = subprocess.run = refuse
before = set(sys.modules)
from pggan_tpu_torch.data import {names}
new = set(sys.modules) - before
assert "pggan_tpu_torch.native" not in new, sorted(new)
assert not any(m == "jax" or m.startswith(("jax.", "pggan_tpu.")) for m in new), sorted(new)
print("light")
""".format(names=", ".join(DATA_NAMES))


def test_data_package_imports_light():
    """`pggan_tpu_torch.data` exports the JAX package's data names, and
    importing it starts no process, touches no card, loads no native loader
    and imports no JAX: a fresh interpreter whose CUDA calls and subprocess
    starts raise."""
    assert len(DATA_NAMES) == 9
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", IMPORT_CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "light", out.stderr[-3000:]
