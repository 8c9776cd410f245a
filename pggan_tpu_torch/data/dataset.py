"""Training data of the port — the counterpart of `pggan_tpu/data/dataset.py`:

  * `list_image_paths`: the reference's recursive `*.*g` glob;
  * `ImageFolderDataset`: a folder of images, each resized bilinearly to
    the scale's resolution, then flipped and colour-jittered from the
    sample's own `RandomState`, in the JAX package's order of draws; the
    resized images are decoded once a scale into RAM when they fit
    `decode_cache_mb`, else read from the on-disk resized store. The work
    runs in the native C++ loader (`pggan_tpu_torch/native/`) whenever it
    builds, as in the JAX package, else in PIL. Where libjpeg/libpng do
    not link, the two packages' defaults part: the JAX package's build
    fails and it takes PIL for everything, while the port builds the loader
    without the codecs, so PIL decodes and C++ resizes and jitters (the
    same draws as the codec build on the same decode; within 1 step of
    JAX's PIL resize, and jittered within phase 18's bounds of JAX's PIL
    jitter). The port keeps its path there: lazy R1/16 through the trainer
    with PIL alone ran 13-25 % slower on an H100 (PERF.md).
    `use_native=False` gives JAX's PIL path;
  * `SyntheticDataset`: a fixed random image per index, no filesystem;
  * `PairedFaceDataset` / `PairedValidDataset`: the face-swap training and
    validation pairs, PIL only, byte for byte the JAX package's;
  * `split_dataset`: the 70/30 index split; `build_dataset`: the factory.

Images stay uint8 [R, R, 3] on the host; the train step normalises them on
the device. The batches come from `data/pipeline.py:DataPipeline` or
`data/grain_pipeline.py:GrainPipeline`.
"""

from __future__ import annotations

import glob
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageEnhance

_IMG_PATTERN = "*.*g"   # the reference's glob: jpg / jpeg / png


def list_image_paths(dataset_root_list: Sequence[str]) -> List[str]:
    """Every `*.*g` file in each root and in every directory below it
    (`pggan_tpu/data/dataset.py:31-39`)."""
    paths: List[str] = []
    for root in dataset_root_list:
        paths.extend(glob.glob(os.path.join(root, _IMG_PATTERN)))
        for sub_root, dirs, _ in os.walk(root):
            for d in dirs:
                paths.extend(glob.glob(os.path.join(sub_root, d, _IMG_PATTERN)))
    return paths


def _apply_color_jitter(img: Image.Image, rng: np.random.RandomState,
                        brightness: float = 0.2, contrast: float = 0.2,
                        saturation: float = 0.2, hue: float = 0.01) -> Image.Image:
    """torchvision's ColorJitter semantics: each factor drawn from
    U[max(0, 1-v), 1+v] (hue U[-h, h]), applied in a random order."""
    ops = []
    if brightness > 0:
        ops.append(("brightness", rng.uniform(max(0.0, 1 - brightness), 1 + brightness)))
    if contrast > 0:
        ops.append(("contrast", rng.uniform(max(0.0, 1 - contrast), 1 + contrast)))
    if saturation > 0:
        ops.append(("saturation", rng.uniform(max(0.0, 1 - saturation), 1 + saturation)))
    if hue > 0:
        ops.append(("hue", rng.uniform(-hue, hue)))
    rng.shuffle(ops)
    for name, f in ops:
        if name == "brightness":
            img = ImageEnhance.Brightness(img).enhance(f)
        elif name == "contrast":
            img = ImageEnhance.Contrast(img).enhance(f)
        elif name == "saturation":
            img = ImageEnhance.Color(img).enhance(f)
        else:
            hsv = np.array(img.convert("HSV"), dtype=np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(round(f * 255))) % 256
            img = Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
    return img


def _pil_resize(path: str, resolution: int) -> Image.Image:
    """PIL's decode and resize (torchvision's Resize default: bilinear)."""
    return Image.open(path).convert("RGB").resize((resolution, resolution), Image.BILINEAR)


class ImageFolderDataset:
    """A folder of images as augmented uint8 [R, R, 3] samples.

    `use_native` (`pggan_tpu/data/dataset.py:108-118`): None takes the
    native loader when it builds, else PIL; True raises RuntimeError when it
    does not build; False takes PIL. The two differ by design: the native
    loader jitters in float and rounds once, PIL rounds to uint8 between
    ops (loader.cpp's header); each equals the JAX package's same path byte
    for byte.

    Decoding and resizing is the dominant host cost, and the progressive
    schedule revisits every image many times a scale. So when the resized
    images of a scale fit `decode_cache_mb` (`cache_decoded='auto'`), each
    is decoded once a scale and the per-draw flip and jitter run on the
    cached array. The cache quantises to uint8 after the resize, where the
    PIL pipeline does anyway, so a cached PIL draw equals an uncached one;
    a native one is within 1 step of 255 of it. Beyond the budget the
    resized store, a [N, R, R, 3] memmap on disk built once, takes its
    place when `store_dir` is known."""

    def __init__(self, dataset_root_list: Sequence[str], scale_index: int = 0,
                 *, is_master: bool = False, augment: bool = True,
                 paths: Optional[Sequence[str]] = None,
                 use_native: Optional[bool] = None,
                 cache_decoded="auto", decode_cache_mb: int = 8192,
                 resized_store="auto", store_dir: Optional[str] = None):
        self.paths = list(paths) if paths is not None else list_image_paths(dataset_root_list)
        if not self.paths:
            raise FileNotFoundError(f"no images found under {list(dataset_root_list)!r}")
        self.resolution = 2 ** (scale_index + 2)
        self.augment = augment
        self._native = None
        self._warned_fallback = False
        if use_native is not False:
            from pggan_tpu_torch.native import NativeImageLoader, native_available
            if native_available():
                self._native = NativeImageLoader(self.resolution, augment=augment)
            elif use_native:
                raise RuntimeError("native loader requested but its build failed")
        cache_bytes = len(self.paths) * self.resolution ** 2 * 3
        if cache_decoded == "auto" or cache_decoded is None:
            cache = cache_bytes <= int(decode_cache_mb) * (1 << 20)
        else:
            cache = bool(cache_decoded)
        self._store = None
        if resized_store is True:
            if store_dir is None:
                raise ValueError("resized_store=true requires resized_store_dir")
            cache = False
        use_store = (resized_store is True
                     or (resized_store == "auto" and not cache and store_dir is not None))
        self._cache: Optional[dict] = {} if cache else None
        self._cache_lock = threading.Lock()
        if use_store:
            from pggan_tpu_torch.data.resized_store import ResizedStore
            self._store = ResizedStore(store_dir, self.paths, self.resolution,
                                       self._resize_uncached, verbose=is_master)
        if is_master:
            loader = "PIL loader"
            if self._native is not None:
                loader = ("native loader" if self._native.decoder == "native"
                          else "native loader, PIL decode")
            where = f", decode cache {cache_bytes / 1e6:.1f} MB" if cache else ""
            if self._store is not None:
                where = f", resized store {self._store.nbytes / 1e6:.1f} MB on disk"
            print(f"Dataset of {len(self)} images constructed for the training "
                  f"({loader}{where}).")

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def backend(self) -> str:
        """'native' or 'PIL': which path resizes and jitters."""
        return "native" if self._native is not None else "PIL"

    def _resize_uncached(self, path: str) -> np.ndarray:
        """Decode and resize to the training resolution, no augmentation."""
        if self._native is not None:
            try:
                return self._native.resize(path)
            except IOError:
                self._warn_fallback(path)
        return np.asarray(_pil_resize(path, self.resolution), dtype=np.uint8)

    def _warn_fallback(self, path: str) -> None:
        """libjpeg and libpng reject some files PIL reads (CMYK JPEGs, some
        PNGs): those images take the PIL path, with one message a dataset
        (`pggan_tpu/data/dataset.py:189-196`)."""
        if not self._warned_fallback:
            self._warned_fallback = True
            print(f"[pggan_tpu_torch.data] native decode failed for {path!r}; "
                  f"using PIL for such images")

    def _cached(self, path: str) -> np.ndarray:
        arr = self._cache.get(path)
        if arr is None:
            arr = self._resize_uncached(path)
            with self._cache_lock:        # racing first draws both decode;
                arr = self._cache.setdefault(path, arr)     # one wins
        return arr

    def resized_array(self, index: int) -> np.ndarray:
        """The decoded and resized image, not augmented."""
        path = self.paths[index % len(self.paths)]
        if self._cache is not None:
            return self._cached(path)
        if self._store is not None:
            return self._store.read(index)
        return self._resize_uncached(path)

    def get(self, index: int, rng: np.random.RandomState) -> np.ndarray:
        if self._cache is None and self._store is None:
            path = self.paths[index % len(self.paths)]
            if self._native is not None:
                try:
                    return self._native.load(path, rng if self.augment else None)
                except IOError:
                    self._warn_fallback(path)
            img = _pil_resize(path, self.resolution)
        else:
            arr = self.resized_array(index)
            if not self.augment:
                return arr
            if self._native is not None:
                return self._native.augment_cached(arr, rng)
            img = Image.fromarray(arr)
        if self.augment:
            if rng.rand() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            img = _apply_color_jitter(img, rng)
        return np.asarray(img, dtype=np.uint8)


class SyntheticDataset:
    """Deterministic random images: index i is an 8×8 random image seeded
    by i, resized bilinearly to the scale's resolution."""

    def __init__(self, size: int = 4096, scale_index: int = 0):
        self.size = size
        self.resolution = 2 ** (scale_index + 2)

    def __len__(self) -> int:
        return self.size

    def get(self, index: int, rng: np.random.RandomState) -> np.ndarray:
        r = np.random.RandomState(index % self.size)
        base = r.randint(0, 256, (8, 8, 3), dtype=np.uint8)
        return np.asarray(Image.fromarray(base).resize(
            (self.resolution, self.resolution), Image.BILINEAR), dtype=np.uint8)


class PairedFaceDataset:
    """Source/target face pairs for face-swap training, the reference's
    `FaceDatasetTrain` (`pggan_tpu/data/dataset.py:256-302`): `get` returns
    (Xs, Xt, same_person), uint8 [R, R, 3] twice and an int. With
    probability `same_prob` the target is the source drawn again
    (same_person 1); otherwise a root is picked uniformly, then an image in
    it, so roots of different sizes weigh alike (not every path alike).

    Each image is decoded and resized bilinearly by PIL, then flipped and
    colour-jittered, as the JAX package does, and never through the native
    loader: its resize lands within one step of 255 of PIL's and its
    jitter stays in float, while these pairs equal the JAX package's byte
    for byte. A sample draws from `rng` in this order: the source's flip
    and jitter, the `same_prob` test, the root and the image, the target's
    flip and jitter. Host data: a caller puts the pairs on its device."""

    def __init__(self, dataset_root_list: Sequence[str], *,
                 is_master: bool = False, same_prob: float = 0.2,
                 resolution: int = 256):
        self.per_root = [ps for ps in (list_image_paths([r]) for r in dataset_root_list) if ps]
        self.paths = [p for ps in self.per_root for p in ps]
        if not self.paths:
            raise FileNotFoundError(f"no images found under {list(dataset_root_list)!r}")
        self.same_prob = same_prob
        self.resolution = resolution
        if is_master:
            print(f"Dataset of {len(self)} images constructed for the training.")

    def __len__(self) -> int:
        return len(self.paths)

    def _load(self, path: str, rng: np.random.RandomState) -> np.ndarray:
        img = _pil_resize(path, self.resolution)
        if rng.rand() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return np.asarray(_apply_color_jitter(img, rng), dtype=np.uint8)

    def get(self, index: int, rng: np.random.RandomState):
        src_path = self.paths[index % len(self.paths)]
        xs = self._load(src_path, rng)
        if rng.rand() > self.same_prob:
            root = self.per_root[rng.randint(len(self.per_root))]
            return xs, self._load(root[rng.randint(len(root))], rng), 0
        return xs, self._load(src_path, rng), 1


class PairedValidDataset:
    """Fixed source/target validation pairs, the reference's
    `FaceDatasetValid` (`pggan_tpu/data/dataset.py:305-331`): the sorted
    images of `{valid_data_dir}/source` and of `.../target`, as many pairs
    as the shorter list holds, resized by PIL only (no draw)."""

    def __init__(self, valid_data_dir: str, *, is_master: bool = False,
                 resolution: int = 256):
        self.source_paths = sorted(list_image_paths([os.path.join(valid_data_dir, "source")]))
        self.target_paths = sorted(list_image_paths([os.path.join(valid_data_dir, "target")]))
        self.n = min(len(self.source_paths), len(self.target_paths))
        self.resolution = resolution
        if is_master:
            print(f"Dataset of {self.n} images constructed for the validation.")

    def __len__(self) -> int:
        return self.n

    def _load(self, path: str) -> np.ndarray:
        return np.asarray(_pil_resize(path, self.resolution), dtype=np.uint8)

    def get(self, index: int, rng=None):
        return (self._load(self.source_paths[index]),
                self._load(self.target_paths[index]))


def split_dataset(n: int, train_frac: float = 0.7, seed: int = 42
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """70/30 random split of indices (`round` for the train count)."""
    n_train = int(round(n * train_frac))
    perm = np.random.RandomState(seed).permutation(n)
    return perm[:n_train], perm[n_train:]


def build_dataset(cfg, scale_index: int, *, is_master: bool = False):
    """`data_backend`: 'auto' → folder if a root of dataset_root_list
    exists, else synthetic; 'folder' / 'synthetic' force one
    (`pggan_tpu/data/dataset.py:343-368`)."""
    backend = str(cfg.data_backend)
    roots = list(cfg.dataset_root_list or [])
    if backend == "auto":
        backend = "folder" if any(os.path.isdir(r) for r in roots) else "synthetic"
    if backend == "folder":
        store_dir = cfg.resized_store_dir
        if store_dir is None:
            store_dir = os.path.join(str(cfg.save_root), "resized_store")
        return ImageFolderDataset(
            roots, scale_index, is_master=is_master, augment=bool(cfg.augment),
            cache_decoded=cfg.cache_decoded, decode_cache_mb=int(cfg.decode_cache_mb),
            resized_store=cfg.resized_store, store_dir=store_dir)
    if backend == "synthetic":
        return SyntheticDataset(int(cfg.synthetic_dataset_size), scale_index)
    raise ValueError(f"unknown data backend {backend!r}")
