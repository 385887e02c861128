"""Datasets, normalization constants and the view spec (copy of the JAX
package's ``data/core.py`` and ``data/synthetic.py::SYNTH_NORM``).

Rows travel as uint8 ``[B, H, W, C]``; normalization and augmentation
happen on the device inside the step (``data/augment.py``), so the host
ships a quarter of the bytes a float32 batch would take.  A "view"
(train vs al) is a flag choosing the device-side transform over the same
storage, not a second copy of the data.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Normalization:
    mean: Tuple[float, ...]
    std: Tuple[float, ...]


CIFAR10_NORM = Normalization((0.4914, 0.4822, 0.4465),
                             (0.2023, 0.1994, 0.2010))
IMAGENET_NORM = Normalization((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
SYNTH_NORM = Normalization((0.5, 0.5, 0.5), (0.25, 0.25, 0.25))


@dataclasses.dataclass(frozen=True)
class ViewSpec:
    """Transform selection for a dataset view.

    augment: random crop (``pad`` pixels of zero padding) + horizontal
      flip, the reference's train transform; the al/test views use
      augment=False (normalize only).
    """

    normalization: Normalization
    augment: bool = False
    pad: int = 4


class Dataset:
    """Base: always indexable by pool index."""

    num_classes: int
    targets: np.ndarray  # int64 [N]
    view: ViewSpec
    image_shape: Tuple[int, int, int]  # H, W, C of a gathered row

    def __len__(self) -> int:
        raise NotImplementedError

    def gather(self, idxs: np.ndarray) -> np.ndarray:
        """uint8 images ``[len(idxs), H, W, C]`` for the given indices."""
        raise NotImplementedError

    def class_counts(self) -> np.ndarray:
        return np.bincount(self.targets[: len(self)],
                           minlength=self.num_classes)


class ArrayDataset(Dataset):
    """In-memory uint8 dataset; ``limit`` truncates it (debug mode)
    without copying."""

    def __init__(self, images: np.ndarray, targets: Sequence[int],
                 num_classes: int, view: ViewSpec,
                 limit: Optional[int] = None):
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError("images must be uint8 [N, H, W, C]")
        self.images = images
        self.targets = np.asarray(targets, dtype=np.int64)
        if len(self.images) != len(self.targets):
            raise ValueError("images and targets differ in length")
        self.num_classes = num_classes
        self.view = view
        self._limit = limit
        self.image_shape = tuple(images.shape[1:])

    def __len__(self) -> int:
        if self._limit is not None:
            return min(self._limit, len(self.images))
        return len(self.images)

    def gather(self, idxs: np.ndarray) -> np.ndarray:
        return self.images[np.asarray(idxs)]

    def with_view(self, view: ViewSpec) -> "ArrayDataset":
        """A second view over the same arrays (zero-copy): how the
        train_set/al_set pair shares storage."""
        return ArrayDataset(self.images, self.targets, self.num_classes,
                            view, limit=self._limit)
