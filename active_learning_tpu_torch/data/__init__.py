"""Data layer: dataset registry + triple factory (the JAX package's
``data/__init__.py``): the synthetic dataset, CIFAR-10, the
class-imbalanced CIFAR-10 and synthetic sets, and the disk-backed
ImageNet and ImageNet-LT sets (their decoder's route follows the
``device`` keyword the driver passes)."""

from ..registry import DATASETS

# Importing a dataset module registers it.
from . import cifar10 as _cifar10  # noqa: F401
from . import imagenet as _imagenet  # noqa: F401
from . import imbalance as _imbalance  # noqa: F401
from . import synthetic as _synthetic  # noqa: F401


def get_data(data_name: str, data_path=None, debug_mode: bool = False,
             **kwargs):
    """``name -> (train_set, test_set, al_set)``."""
    factory = DATASETS.get(data_name)
    return factory(data_path, debug_mode=debug_mode, **kwargs)
