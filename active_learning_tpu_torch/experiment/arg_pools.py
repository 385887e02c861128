"""The arg pools, reduced to what ``serve`` reads from them.

The JAX package's ``experiment/arg_pools.py`` registers per-dataset
training presets; resolving the served model replays the driver's rule
"config echo beats arg pool" for three fields only: the compute dtype,
the BN-statistics dtype and the stem.  Every preset there leaves all
three at their defaults; this table keeps which (pool, dataset) pairs
exist, so an unknown pair still raises KeyError as it does there.  The
rest of each preset (optimizer, schedule, loaders, pretrained paths)
comes with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from ..registry import ARG_POOLS


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    dtype: str = "auto"
    bn_stats_dtype: str = "auto"
    stem: str = "default"


_DEFAULT = TrainConfig()

_POOLS: Dict[str, tuple] = {
    "default": ("cifar10", "imbalanced_cifar10", "imagenet",
                "imbalanced_imagenet"),
    "ssp_finetuning": ("cifar10", "imagenet"),
    "ssp_linear_evaluation": ("imagenet",),
    "ssp_finetuning_imbalanced_cifar10_imb_0_1": ("imbalanced_cifar10",),
    "ssp_finetuning_imbalanced_cifar10_imb_0_01": ("imbalanced_cifar10",),
    "synthetic": ("synthetic",),
}
for _name, _datasets in _POOLS.items():
    ARG_POOLS.register(_name, {d: _DEFAULT for d in _datasets})


def get_train_config(arg_pool: str, dataset: str) -> TrainConfig:
    """Resolve ``(arg_pool, dataset) -> TrainConfig``; KeyError for an
    unknown pool or a dataset the pool has no entry for."""
    pool = ARG_POOLS.get(arg_pool)
    try:
        return pool[dataset]
    except KeyError:
        known = ", ".join(sorted(pool))
        raise KeyError(
            f"arg pool '{arg_pool}' has no entry for dataset '{dataset}' "
            f"(has: {known})") from None
