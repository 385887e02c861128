"""Class imbalance by exponential or step subsampling (copy of the JAX
package's ``data/imbalance.py``, the reference's
``custom_imbalanced_cifar10.py:29-61``), as index selection over an
in-memory dataset; the imbalance seed draws the per-class subsample."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..registry import DATASETS
from .core import CIFAR10_NORM, ArrayDataset, ViewSpec


def img_num_per_cls(n_total: int, num_classes: int, imbalance_type: str,
                    imbalance_factor: float) -> List[int]:
    """Rows kept per class: ``exp`` decays from ``n_total / classes`` to
    ``factor`` of it; ``step`` keeps the first half and ``factor`` of
    the second."""
    img_max = n_total / num_classes
    if imbalance_type == "exp":
        return [int(img_max * imbalance_factor ** (c / (num_classes - 1.0)))
                for c in range(num_classes)]
    if imbalance_type == "step":
        return ([int(img_max)] * (num_classes // 2)
                + [int(img_max * imbalance_factor)] * (num_classes // 2))
    raise ValueError("Choose a valid imbalance_type: one of exp or step.")


def imbalanced_indices(targets: np.ndarray, counts: Sequence[int],
                       seed: int) -> np.ndarray:
    """A seeded subsample of each class, classes concatenated in label
    order."""
    rng = np.random.default_rng(seed)
    targets = np.asarray(targets)
    out = []
    for cls, count in enumerate(counts):
        idx = np.flatnonzero(targets == cls)
        rng.shuffle(idx)
        out.append(idx[:count])
    return np.concatenate(out)


def make_imbalanced(dataset: ArrayDataset, imbalance_type: Optional[str],
                    imbalance_factor: float, seed: int) -> ArrayDataset:
    if imbalance_type is None:
        return dataset
    counts = img_num_per_cls(len(dataset.images), dataset.num_classes,
                             imbalance_type, imbalance_factor)
    keep = imbalanced_indices(dataset.targets, counts, seed)
    return ArrayDataset(dataset.images[keep], dataset.targets[keep],
                        dataset.num_classes, dataset.view)


def get_data_imbalanced_cifar10(data_path: str, debug_mode: bool = False,
                                imbalance_args=None, download: bool = False,
                                **_unused):
    """Imbalanced train and al sets over CIFAR-10, with the balanced test
    set (the reference's ``custom_imbalanced_cifar10.py:86-100``)."""
    from .cifar10 import load_cifar10_arrays

    (tr_images, tr_targets), (te_images, te_targets) = load_cifar10_arrays(
        data_path, download=download)
    limit = 50 if debug_mode else None
    train_view = ViewSpec(CIFAR10_NORM, augment=True, pad=4)
    val_view = ViewSpec(CIFAR10_NORM, augment=False)
    imb = imbalance_args
    imbalanced = make_imbalanced(
        ArrayDataset(tr_images, tr_targets, 10, train_view),
        imb.imbalance_type, imb.imbalance_factor, imb.imbalance_seed)
    train_set = ArrayDataset(imbalanced.images, imbalanced.targets, 10,
                             train_view, limit=limit)
    al_set = train_set.with_view(val_view)
    test_set = ArrayDataset(te_images, te_targets, 10, val_view, limit=limit)
    return train_set, test_set, al_set


def get_data_imbalanced_synthetic(data_path=None, debug_mode: bool = False,
                                  imbalance_args=None, n_train: int = 512,
                                  num_classes: int = 10, image_size: int = 32,
                                  seed: int = 1234, **_unused):
    """The synthetic dataset with the imbalance applied to its train set,
    so the imbalance path runs without CIFAR on disk."""
    from .synthetic import get_data_synthetic

    train_set, test_set, _ = get_data_synthetic(
        n_train=n_train, num_classes=num_classes, image_size=image_size,
        seed=seed, debug_mode=False)
    imb = imbalance_args
    limit = 50 if debug_mode else None
    train_set = make_imbalanced(train_set, imb.imbalance_type,
                                imb.imbalance_factor, imb.imbalance_seed)
    train_set = ArrayDataset(train_set.images, train_set.targets,
                             num_classes, train_set.view, limit=limit)
    al_set = train_set.with_view(test_set.view)
    return train_set, test_set, al_set


DATASETS.register("imbalanced_cifar10", get_data_imbalanced_cifar10)
DATASETS.register("imbalanced_synthetic", get_data_imbalanced_synthetic)
