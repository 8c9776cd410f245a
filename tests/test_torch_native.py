"""The port's native image loader (`pggan_tpu_torch/native/`) and its folder
data at their defaults against the JAX package's (`pggan_tpu/native/`,
`pggan_tpu/data/dataset.py`), on the CPU.

Both packages build their own copy of loader.cpp with g++, libjpeg and
libpng; the tests skip, as tests/test_native.py does, when the build
fails. The loaders' four calls, the datasets at their defaults (augmented or
not; RAM cache, resized store, uncached) and the device cache's arrays are
compared byte for byte. The library built without the codecs (PIL decodes,
C++ resizes and jitters) is held to the JAX loader byte for byte on the
JAX loader's own decode, and its PIL decode to libjpeg's within the IDCT
difference tests/test_native.py allows. Nothing here compiles a JAX program.
"""

import os

import numpy as np
import pytest
from PIL import Image

from pggan_tpu.data.dataset import ImageFolderDataset as JaxFolder
from pggan_tpu.data.device_cache import DeviceDataCache as JaxCache
from pggan_tpu.native import NativeImageLoader as JaxLoader
from pggan_tpu.native import native_available as jax_native_available
from pggan_tpu.parallel import create_mesh
from pggan_tpu_torch.data.dataset import ImageFolderDataset
from pggan_tpu_torch.data.device_cache import DeviceDataCache
from pggan_tpu_torch.native import NativeImageLoader, build, native_available

SCALE = 3                   # 32×32 samples from 40-76 px sources: a real downscale
SEEDS = (0, 7, 12345)


@pytest.fixture(autouse=True)
def _needs_the_build():
    if not (native_available() and jax_native_available()):
        pytest.skip("native loader build failed (g++, libjpeg or libpng missing)")


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """6 smooth images with noise, JPEG and PNG, 40-76 px on a side."""
    root = tmp_path_factory.mktemp("native")
    rs = np.random.RandomState(3)
    for i in range(6):
        w, h = 40 + 7 * i, 76 - 5 * i
        low = Image.fromarray(rs.randint(0, 256, (6, 8, 3), dtype=np.uint8))
        arr = np.asarray(low.resize((w, h), Image.BILINEAR), np.int16)
        arr = np.clip(arr + rs.randint(-12, 13, arr.shape), 0, 255).astype(np.uint8)
        name = f"im{i}.png" if i % 2 else f"im{i}.jpg"
        Image.fromarray(arr).save(os.path.join(root, name), quality=90)
    return str(root)


def _files(image_dir):
    return sorted(os.path.join(image_dir, f) for f in os.listdir(image_dir))


def test_loader_calls_match_jax(image_dir):
    ours, theirs = NativeImageLoader(32), JaxLoader(32)
    assert ours.decoder == "native"
    for path in _files(image_dir):
        np.testing.assert_array_equal(ours.decode(path), theirs.decode(path))
        resized = ours.resize(path)
        np.testing.assert_array_equal(resized, theirs.resize(path))
        np.testing.assert_array_equal(ours.load(path), theirs.load(path))
        for seed in SEEDS:
            np.testing.assert_array_equal(ours.load(path, np.random.RandomState(seed)),
                                          theirs.load(path, np.random.RandomState(seed)))
            np.testing.assert_array_equal(
                ours.augment_cached(resized, np.random.RandomState(seed)),
                theirs.augment_cached(resized, np.random.RandomState(seed)))


def test_loader_without_codecs_matches_jax(image_dir):
    """PIL's decode, then the C++ resize and jitter: on the JAX loader's own
    decode the library's output equals the JAX loader's byte for byte; PIL's
    decode equals libpng's and is within tests/test_native.py's IDCT bound
    of libjpeg's (equal where both link the same libjpeg-turbo)."""
    lib = build.build_library(codecs=False)
    ours, theirs = NativeImageLoader(32, lib=lib), JaxLoader(32)
    assert ours.decoder == "PIL" and not lib.pggan_has_codecs()
    for path in _files(image_dir):
        decoded, want = ours.decode(path).astype(int), theirs.decode(path).astype(int)
        assert decoded.shape == want.shape
        if path.endswith(".png"):
            np.testing.assert_array_equal(decoded, want)
        else:
            assert np.abs(decoded - want).mean() < 2.0
        rgb = theirs.decode(path)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(NativeImageLoader, "_pixels", staticmethod(lambda _: rgb))
            np.testing.assert_array_equal(ours.resize(path), theirs.resize(path))
            for seed in SEEDS:
                np.testing.assert_array_equal(ours.load(path, np.random.RandomState(seed)),
                                              theirs.load(path, np.random.RandomState(seed)))
    with pytest.raises(IOError):
        ours.load(os.path.join(image_dir, "missing.jpg"))


@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("tier", ["ram", "store", "uncached"])
def test_folder_defaults_match_jax(image_dir, tmp_path, augment, tier):
    """Each package at its defaults (the native loader where it builds):
    the draws equal byte for byte. Before the port had the loader, its
    default was the PIL path, which differs from these draws."""
    kw = dict(augment=augment)
    if tier == "store":
        kw.update(resized_store=True)
    elif tier == "uncached":
        kw.update(cache_decoded=False)
    ours = ImageFolderDataset([image_dir], SCALE, **kw,
                              **({"store_dir": str(tmp_path / "port")} if tier == "store" else {}))
    theirs = JaxFolder([image_dir], SCALE, **kw,
                       **({"store_dir": str(tmp_path / "jax")} if tier == "store" else {}))
    assert ours.backend == "native" and theirs._native is not None
    assert (ours._cache is not None, ours._store is not None) == (tier == "ram", tier == "store")
    for i in range(len(ours)):
        np.testing.assert_array_equal(ours.resized_array(i), theirs.resized_array(i))
        for seed in SEEDS:
            got = ours.get(i, np.random.RandomState(seed))
            assert got.dtype == np.uint8 and got.shape == (32, 32, 3)
            np.testing.assert_array_equal(got, theirs.get(i, np.random.RandomState(seed)),
                                          err_msg=f"{i} {seed}")


def test_cached_draws_within_two_steps_of_uncached(image_dir):
    """The cache rounds to uint8 between the resize and the jitter (at most
    half a step), the uncached draw rounds once. Brightness, contrast and
    saturation each scale that by up to 1.2, so the two differ by at most
    0.5 · 1.2³ < 1 before the final rounding, 2 steps after it (the JAX
    package's docstring says 1; over 1200 draws of this fixture 2 steps
    came up on 0.02 % of the values)."""
    cached = ImageFolderDataset([image_dir], SCALE, cache_decoded=True)
    uncached = ImageFolderDataset([image_dir], SCALE, cache_decoded=False)
    for i in range(len(cached)):
        a = cached.get(i, np.random.RandomState(i)).astype(int)
        b = uncached.get(i, np.random.RandomState(i)).astype(int)
        assert np.abs(a - b).max() <= 2 and np.mean(np.abs(a - b) == 2) < 1e-3


def test_use_native_true_raises_when_the_build_fails(image_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_tried", False)
    with pytest.raises(RuntimeError, match="build failed"):
        ImageFolderDataset([image_dir], SCALE, use_native=True)
    assert ImageFolderDataset([image_dir], SCALE).backend == "PIL"     # None: PIL


@pytest.mark.parametrize("cache", [True, False])
def test_use_native_false_matches_jax_pil(image_dir, cache):
    ours = ImageFolderDataset([image_dir], SCALE, use_native=False, cache_decoded=cache)
    theirs = JaxFolder([image_dir], SCALE, use_native=False, cache_decoded=cache)
    assert ours.backend == "PIL"
    for i in range(len(ours)):
        np.testing.assert_array_equal(ours.get(i, np.random.RandomState(i)),
                                      theirs.get(i, np.random.RandomState(i)))


@pytest.mark.parametrize("cache", [True, False])
def test_cmyk_jpeg_falls_back_to_pil_once(tmp_path, capsys, cache):
    """libjpeg's JCS_RGB output rejects a CMYK JPEG; PIL reads it. Both
    packages take PIL for it, with one message a dataset."""
    rs = np.random.RandomState(5)
    for i in range(2):
        cmyk = rs.randint(0, 256, (48, 40, 4), dtype=np.uint8)
        Image.fromarray(cmyk, "CMYK").save(tmp_path / f"cmyk{i}.jpg")
    ours = ImageFolderDataset([str(tmp_path)], SCALE, cache_decoded=cache)
    theirs = JaxFolder([str(tmp_path)], SCALE, cache_decoded=cache)
    capsys.readouterr()
    for i in range(2):
        np.testing.assert_array_equal(ours.get(i, np.random.RandomState(i)),
                                      theirs.get(i, np.random.RandomState(i)))
    out = capsys.readouterr().out
    assert out.count("[pggan_tpu_torch.data] native decode failed") == 1
    assert out.count("[pggan_tpu.data] native decode failed") == 1


def test_device_cache_over_native_matches_jax(image_dir):
    ours = DeviceDataCache(ImageFolderDataset([image_dir], SCALE), "cpu")
    theirs = JaxCache(JaxFolder([image_dir], SCALE), create_mesh())
    assert (ours.n_images, ours.nbytes) == (theirs.n_images, theirs.nbytes)
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(theirs.data))


def test_default_without_the_codec_builds_against_jax(image_dir, monkeypatch, capsys):
    """Where libjpeg/libpng do not link (the card's machine), the JAX
    package's build returns None and its default is PIL's decode, resize and
    jitter; the port's default is the loader built without the codecs: PIL
    decodes, C++ resizes and jitters. The port keeps that path (PIL alone is
    13-25 % slower through the trainer on the card); its draws stay within
    phase 18's bounds of native against PIL: the resize within 1 step of
    255, the jitter within 2.5 on average and more than 8 apart on at most
    0.1 % of the values."""
    from pggan_tpu.native import build as jax_build

    build_library = build.build_library

    def without_codecs(codecs=True):
        if codecs:
            raise RuntimeError("g++ ... -ljpeg -lpng failed:\n"
                               "fatal error: jpeglib.h: No such file or directory")
        return build_library(codecs=False)
    monkeypatch.setattr(build, "build_library", without_codecs)
    monkeypatch.setattr(jax_build, "_build", lambda: None)
    for module in (build, jax_build):
        monkeypatch.setattr(module, "_lib", None)
        monkeypatch.setattr(module, "_tried", False)
    resize_diff, jitter = 0, []
    for augment in (False, True):
        ours = ImageFolderDataset([image_dir], SCALE, augment=augment)
        theirs = JaxFolder([image_dir], SCALE, augment=augment)
        assert ours.backend == "native" and ours._native.decoder == "PIL"
        assert theirs._native is None
        for i in range(len(ours)):
            for seed in SEEDS:
                diff = np.abs(ours.get(i, np.random.RandomState(seed)).astype(np.int16)
                              - theirs.get(i, np.random.RandomState(seed)))
                if augment:
                    jitter.append(diff.ravel())
                else:
                    resize_diff = max(resize_diff, int(diff.max()))
    assert "built without libjpeg/libpng (fatal error: jpeglib.h" in capsys.readouterr().out
    jitter = np.concatenate(jitter)
    assert resize_diff <= 1
    assert jitter.mean() <= 2.5 and (jitter > 8).mean() <= 1e-3
