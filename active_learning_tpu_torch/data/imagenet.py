"""ImageNet-scale disk-backed datasets (the JAX package's
``data/imagenet.py``).

* ``ImageFolderDataset``: the reference's torchvision ImageFolder layout,
  a subdirectory a class, JPEGs decoded when gathered.
* ``FileListDataset``: the ImageNet-LT variant, a text file of
  ``relative/path label`` lines.

Host transforms: RandomResizedCrop(224) for the train view,
Resize(256) + CenterCrop(224) for the al/test views; the horizontal flip
and the normalization run on the device (``data/augment.py``).  Crops are
a pure function of ``(seed, epoch, index)``, whatever the gather order or
the threads, exactly as in the JAX package.

Two decode paths with the same transform semantics:
  * native (the default): ``data/native.py`` decodes, crops and resizes a
    whole batch, on the route of the dataset's ``device``: libjpeg on the
    CPU (rows bit-equal to the JAX package's native rows), nvJPEG and
    the crop-resize kernel on the card.  Files the route's decoder cannot
    handle (not a JPEG, a CMYK JPEG, a header that does not parse) go
    through PIL one by one, as in the JAX package.
  * PIL, one image at a time, only when the caller asks for it
    (``use_native=False``).
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..device import resolve_device
from ..registry import DATASETS
from .core import IMAGENET_NORM, Dataset, ViewSpec

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _require_pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "PIL is needed for files the native decoder cannot take and "
            "for use_native=False") from e
    return Image


def random_resized_crop_params(h: int, w: int, rng: np.random.Generator,
                               scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)
                               ) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params semantics: sample area and
    log-uniform aspect ratio, 10 attempts then center-crop fallback."""
    area = h * w
    log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = np.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw
    # Fallback: center crop at the closest valid ratio.
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    top = (h - ch) // 2
    left = (w - cw) // 2
    return top, left, ch, cw


class _DiskImageDataset(Dataset):
    """Decode and transform logic shared by the disk-backed datasets.
    ``device`` picks the native decoder's route (``cuda``, the default,
    raises without a card; ``cpu``)."""

    def __init__(self, paths: List[str], targets: Sequence[int],
                 num_classes: int, view: ViewSpec, train_transform: bool,
                 image_size: int = 224, resize_size: int = 256,
                 limit: Optional[int] = None, seed: int = 0,
                 use_native: bool = True, decode_threads: int = 4,
                 device="cuda"):
        self.paths = paths
        self.targets = np.asarray(targets, dtype=np.int64)
        self.num_classes = num_classes
        self.view = view
        self.train_transform = train_transform
        self.image_size = image_size
        self.resize_size = resize_size
        self._limit = limit
        self._seed = seed
        self._epoch = 0
        self._use_native = use_native
        self.decode_threads = decode_threads
        self.device = resolve_device(device)
        # (height, width, components) per index, filled on first native
        # touch: image files are immutable, so headers are parsed once.
        self._dims_cache: dict = {}
        self.image_shape = (image_size, image_size, 3)
        # Rows the native route handed to PIL (the per-file fallback)
        # since construction: the scoring pass and the fit report it.
        self.fallback_rows = 0
        self._count_lock = threading.Lock()

    def __len__(self) -> int:
        if self._limit is not None:
            return min(self._limit, len(self.paths))
        return len(self.paths)

    def set_epoch(self, epoch: int) -> None:
        """Advance the crop stream: crops are a pure function of
        (seed, epoch, index)."""
        self._epoch = int(epoch)

    def _decode_one(self, path: str, index: int) -> np.ndarray:
        PILImage = _require_pil()
        with open(path, "rb") as fh:
            img = PILImage.open(fh).convert("RGB")
        s = self.image_size
        if self.train_transform:
            rng = np.random.default_rng(
                (self._seed, self._epoch, int(index)))
            top, left, ch, cw = random_resized_crop_params(
                img.height, img.width, rng)
            img = img.resize((s, s), PILImage.BILINEAR,
                             box=(left, top, left + cw, top + ch))
        else:
            # Resize(256) (short side) + CenterCrop(224).
            r = self.resize_size
            if img.width <= img.height:
                new_w, new_h = r, max(1, int(round(img.height * r / img.width)))
            else:
                new_h, new_w = r, max(1, int(round(img.width * r / img.height)))
            img = img.resize((new_w, new_h), PILImage.BILINEAR)
            left = (new_w - s) // 2
            top = (new_h - s) // 2
            img = img.crop((left, top, left + s, top + s))
        return np.asarray(img, dtype=np.uint8)

    def _crop_rect(self, h: int, w: int, index: int
                   ) -> Tuple[int, int, int, int]:
        """(top, left, ch, cw) for one image under the current view."""
        if self.train_transform:
            rng = np.random.default_rng(
                (self._seed, self._epoch, int(index)))
            return random_resized_crop_params(h, w, rng)
        # Resize(short=256) + CenterCrop(224) == a centered crop of
        # 224 * short/256 of the original image, bilinear-resized.
        short = min(h, w)
        box = int(round(self.image_size * short / self.resize_size))
        return (h - box) // 2, (w - box) // 2, box, box

    def _native_dims(self, idxs: np.ndarray) -> np.ndarray:
        """int32 ``[N, 3]`` (h, w, components) through the header cache;
        -1 rows mean the route's decoder cannot parse that file (PIL
        decodes it instead)."""
        from . import native
        missing = [int(i) for i in idxs if int(i) not in self._dims_cache]
        if missing:
            dims = native.jpeg_dims([self.paths[i] for i in missing],
                                    self.decode_threads, self.device)
            for i, row in zip(missing, dims):
                self._dims_cache[i] = tuple(int(v) for v in row)
        return np.asarray([self._dims_cache[int(i)] for i in idxs],
                          dtype=np.int32).reshape(len(idxs), 3)

    def _gather_native(self, idxs: np.ndarray) -> np.ndarray:
        """A batch through the native decoder; files it cannot handle
        (another extension, a CMYK encoding, a parse failure) go through
        PIL one by one, so one odd file never takes the rest of the
        dataset off the native path."""
        from . import native
        paths = [self.paths[int(i)] for i in idxs]
        ok = np.asarray([p.lower().endswith((".jpg", ".jpeg"))
                         for p in paths], dtype=bool).reshape(len(idxs))
        out = np.empty((len(idxs), *self.image_shape), dtype=np.uint8)
        if ok.any():
            dims = self._native_dims(idxs)
            ok &= dims[:, 0] > 0
            sel = np.flatnonzero(ok)
            if len(sel):
                rects = np.asarray(
                    [self._crop_rect(int(dims[i, 0]), int(dims[i, 1]),
                                     int(idxs[i])) for i in sel],
                    dtype=np.int32)
                decoded, failed = native.decode_crop_resize(
                    [paths[i] for i in sel], rects, self.image_size,
                    self.decode_threads, self.device, dims[sel])
                out[sel] = decoded
                ok[sel[failed]] = False
        fallback = np.flatnonzero(~ok)
        for i in fallback:
            out[i] = self._decode_one(paths[i], int(idxs[i]))
        if len(fallback):
            with self._count_lock:
                self.fallback_rows += len(fallback)
        return out

    def gather(self, idxs: np.ndarray) -> np.ndarray:
        idxs = np.asarray(idxs)
        if self._use_native:
            return self._gather_native(idxs)
        out = np.empty((len(idxs), *self.image_shape), dtype=np.uint8)
        for i, idx in enumerate(idxs):
            out[i] = self._decode_one(self.paths[int(idx)], int(idx))
        return out


class ImageFolderDataset(_DiskImageDataset):
    """Class-per-subdirectory layout (torchvision ImageFolder semantics:
    classes are the sorted subdirectory names)."""

    def __init__(self, root: str, view: ViewSpec, train_transform: bool,
                 num_classes: int = 1000, limit: Optional[int] = None,
                 seed: int = 0, device="cuda", **kwargs):
        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise FileNotFoundError(f"No class directories under '{root}'")
        class_to_idx = {c: i for i, c in enumerate(classes)}
        paths, targets = [], []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(_IMG_EXTS):
                    paths.append(os.path.join(cdir, fname))
                    targets.append(class_to_idx[c])
        super().__init__(paths, targets, max(num_classes, len(classes)),
                         view, train_transform, limit=limit, seed=seed,
                         device=device, **kwargs)
        self.classes = classes


class FileListDataset(_DiskImageDataset):
    """``path label`` per line (ImageNet-LT's list files)."""

    def __init__(self, root: str, list_file: str, view: ViewSpec,
                 train_transform: bool, num_classes: int = 1000,
                 limit: Optional[int] = None, seed: int = 0,
                 device="cuda", **kwargs):
        paths, targets = [], []
        with open(list_file) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) >= 2:
                    paths.append(os.path.join(root, parts[0]))
                    targets.append(int(parts[1]))
        super().__init__(paths, targets, num_classes, view, train_transform,
                         limit=limit, seed=seed, device=device, **kwargs)


def get_data_imagenet(data_path: str, debug_mode: bool = False,
                      device="cuda", **_unused):
    """``train/`` and ``val/`` class folders under ``data_path``."""
    limit = 50 if debug_mode else None
    train_view = ViewSpec(IMAGENET_NORM, augment=True, pad=0)  # flip only
    val_view = ViewSpec(IMAGENET_NORM, augment=False)
    traindir = os.path.join(data_path, "train")
    valdir = os.path.join(data_path, "val")
    train_set = ImageFolderDataset(traindir, train_view, True, limit=limit,
                                   device=device)
    al_set = ImageFolderDataset(traindir, val_view, False, limit=limit,
                                device=device)
    test_set = ImageFolderDataset(valdir, val_view, False, limit=limit,
                                  device=device)
    return train_set, test_set, al_set


def get_data_imbalanced_imagenet(data_path: str, debug_mode: bool = False,
                                 list_dir: Optional[str] = None,
                                 device="cuda", **_unused):
    """ImageNet-LT: file-list train/al sets over the train images, an
    ImageFolder val set."""
    limit = 50 if debug_mode else None
    train_view = ViewSpec(IMAGENET_NORM, augment=True, pad=0)
    val_view = ViewSpec(IMAGENET_NORM, augment=False)
    list_dir = list_dir or os.path.join(data_path, "ImageNet_LT")
    train_list = os.path.join(list_dir, "ImageNet_LT_train.txt")
    train_set = FileListDataset(data_path, train_list, train_view, True,
                                limit=limit, device=device)
    al_set = FileListDataset(data_path, train_list, val_view, False,
                             limit=limit, device=device)
    test_set = ImageFolderDataset(os.path.join(data_path, "val"), val_view,
                                  False, limit=limit, device=device)
    return train_set, test_set, al_set


DATASETS.register("imagenet", get_data_imagenet)
DATASETS.register("imbalanced_imagenet", get_data_imbalanced_imagenet)
