"""Synthetic learnable dataset (copy of the JAX package's
``data/synthetic.py``): per-class coarse colour templates plus noise,
drawn with the same numpy calls in the same order, so one seed gives
byte-equal images in both packages."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..registry import DATASETS
from .core import SYNTH_NORM, ArrayDataset, ViewSpec


def _class_templates(num_classes: int, hw: int, rng: np.random.Generator
                     ) -> np.ndarray:
    # A 4x4 colour grid upsampled to hw: the class survives the train
    # view's random crop and flip.
    coarse = rng.uniform(40, 215, size=(num_classes, 4, 4, 3))
    reps = -(-hw // 4)
    return np.repeat(np.repeat(coarse, reps, axis=1),
                     reps, axis=2)[:, :hw, :hw, :]


def _make_images(n: int, templates: np.ndarray, rng: np.random.Generator,
                 noise_sigma: float = 25.0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    num_classes, hw = templates.shape[0], templates.shape[1]
    targets = rng.integers(0, num_classes, size=n)
    noise = rng.normal(0, noise_sigma, size=(n, hw, hw, 3))
    images = np.clip(templates[targets] + noise, 0, 255).astype(np.uint8)
    return images, targets.astype(np.int64)


def get_data_synthetic(
    data_path: Optional[str] = None,
    n_train: int = 512,
    n_test: int = 128,
    num_classes: int = 10,
    image_size: int = 32,
    seed: int = 1234,
    debug_mode: bool = False,
    **_unused,
):
    """The (train_set, test_set, al_set) triple over shared storage.
    At 224 px and 1000 classes the float64 templates and noise take
    about 1.2 GB of host memory per 1000 rows drawn."""
    rng = np.random.default_rng(seed)
    templates = _class_templates(num_classes, image_size, rng)
    tr_images, tr_targets = _make_images(n_train, templates, rng)
    te_images, te_targets = _make_images(n_test, templates, rng)
    limit = 50 if debug_mode else None

    train_view = ViewSpec(SYNTH_NORM, augment=True, pad=4)
    val_view = ViewSpec(SYNTH_NORM, augment=False)

    train_set = ArrayDataset(tr_images, tr_targets, num_classes, train_view,
                             limit=limit)
    al_set = train_set.with_view(val_view)
    test_set = ArrayDataset(te_images, te_targets, num_classes, val_view,
                            limit=limit)
    return train_set, test_set, al_set


DATASETS.register("synthetic", get_data_synthetic)
