"""Normalization constants and the view spec (copy of the JAX package's
``data/core.py`` and ``data/synthetic.py::SYNTH_NORM``).

Rows travel as uint8 ``[B, H, W, C]``; the normalization happens on the
device inside the scoring step, so the host ships a quarter of the
bytes a float32 batch would take.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


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
    """Transform selection for a dataset view.  Serving uses the eval
    view (augment=False): normalize only; augmentation comes with the
    training slice."""

    normalization: Normalization
    augment: bool = False
