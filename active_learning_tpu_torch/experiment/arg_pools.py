"""Registered per-dataset training presets ("arg pools"), copied from
the JAX package's ``experiment/arg_pools.py``: each pool is a
``{dataset: TrainConfig}`` mapping registered under the reference's name.

Sources (the reference's arg-pool modules):
  * "default"                — src/arg_pools/default.py:5-46
  * "ssp_finetuning"         — src/arg_pools/ssp_finetuning.py:4-39
  * "ssp_linear_evaluation"  — src/arg_pools/ssp_linear_evaluation.py:4-26
  * "ssp_finetuning_imbalanced_cifar10_imb_0_1"  /  "..._0_01"
  * "synthetic"              — the egress-free synthetic dataset.

The pretrained paths are kept as the JAX package names them, relative
to the directory the run starts in or to ``pretrained_root``
(``get_train_config``); ``utils/pretrained.py`` loads them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

from ..config import (LoaderConfig, OptimizerConfig, PretrainedConfig,
                      SchedulerConfig, TrainConfig)
from ..registry import ARG_POOLS

_CIFAR_TR = LoaderConfig(batch_size=128, num_workers=0)
_CIFAR_TE = LoaderConfig(batch_size=100, num_workers=0)
_IMAGENET_TR = LoaderConfig(batch_size=128, num_workers=12, prefetch=2)
_IMAGENET_TE = LoaderConfig(batch_size=128, num_workers=12, prefetch=2)

_SIMCLR_CIFAR = PretrainedConfig(
    path="pretrained_ckpt/cifar10/simclr.pth.tar",
    required_key=("encoder",), skip_key=("linear",))
_MOCO_IMAGENET = PretrainedConfig(
    path="pretrained_ckpt/imagenet/moco_v2_800ep_pretrain.pth.tar",
    required_key=("encoder_q",), skip_key=("fc",),
    replace_key=(("encoder_q", "encoder"),))


DEFAULT_POOL: Dict[str, TrainConfig] = {
    "cifar10": TrainConfig(
        eval_split=0.01, loader_tr=_CIFAR_TR, loader_te=_CIFAR_TE,
        optimizer=OptimizerConfig("sgd", lr=0.1, weight_decay=5e-4,
                                  momentum=0.9),
        scheduler=SchedulerConfig("cosine", t_max=200)),
    "imbalanced_cifar10": TrainConfig(
        eval_split=0.01, loader_tr=_CIFAR_TR, loader_te=_CIFAR_TE,
        optimizer=OptimizerConfig("sgd", lr=0.1, weight_decay=5e-4,
                                  momentum=0.9),
        scheduler=SchedulerConfig("cosine", t_max=200),
        imbalanced_training=True),
    "imagenet": TrainConfig(
        eval_split=0.01, loader_tr=_IMAGENET_TR, loader_te=_IMAGENET_TE,
        optimizer=OptimizerConfig("sgd", lr=0.1, weight_decay=1e-4,
                                  momentum=0.9),
        scheduler=SchedulerConfig("step", step_size=60, gamma=0.1)),
    "imbalanced_imagenet": TrainConfig(
        eval_split=0.01, loader_tr=_IMAGENET_TR, loader_te=_IMAGENET_TE,
        optimizer=OptimizerConfig("sgd", lr=0.1, weight_decay=1e-4,
                                  momentum=0.9),
        scheduler=SchedulerConfig("step", step_size=60, gamma=0.1),
        imbalanced_training=True),
}

SSP_FINETUNING_POOL: Dict[str, TrainConfig] = {
    "cifar10": TrainConfig(
        eval_split=0.1, loader_tr=_CIFAR_TR, loader_te=_CIFAR_TE,
        optimizer=OptimizerConfig("sgd", lr=0.001, weight_decay=5e-4,
                                  momentum=0.9),
        scheduler=SchedulerConfig("cosine", t_max=200),
        pretrained=_SIMCLR_CIFAR),
    "imagenet": TrainConfig(
        eval_split=0.01, loader_tr=_IMAGENET_TR, loader_te=_IMAGENET_TE,
        optimizer=OptimizerConfig("sgd", lr=0.001, weight_decay=0.0,
                                  momentum=0.9),
        scheduler=SchedulerConfig("step", step_size=10, gamma=0.1),
        pretrained=_MOCO_IMAGENET),
}

SSP_LINEAR_EVALUATION_POOL: Dict[str, TrainConfig] = {
    "imagenet": TrainConfig(
        eval_split=0.01,
        loader_tr=LoaderConfig(batch_size=128, num_workers=8, prefetch=2),
        loader_te=LoaderConfig(batch_size=128, num_workers=8, prefetch=2),
        optimizer=OptimizerConfig("sgd", lr=15.0, weight_decay=1e-4,
                                  momentum=0.9),
        scheduler=SchedulerConfig("step", step_size=20, gamma=0.1),
        pretrained=_MOCO_IMAGENET),
}


def _imb_cifar_pool(ckpt: str) -> Dict[str, TrainConfig]:
    return {
        "imbalanced_cifar10": TrainConfig(
            eval_split=0.1, loader_tr=_CIFAR_TR, loader_te=_CIFAR_TE,
            optimizer=OptimizerConfig("sgd", lr=0.002, weight_decay=0.0,
                                      momentum=0.9),
            scheduler=SchedulerConfig("cosine", t_max=200),
            pretrained=PretrainedConfig(
                path=ckpt, required_key=("encoder",), skip_key=("linear",)),
            imbalanced_training=True),
    }


ARG_POOLS.register("default", DEFAULT_POOL)
ARG_POOLS.register("ssp_finetuning", SSP_FINETUNING_POOL)
ARG_POOLS.register("ssp_linear_evaluation", SSP_LINEAR_EVALUATION_POOL)
ARG_POOLS.register(
    "ssp_finetuning_imbalanced_cifar10_imb_0_1",
    _imb_cifar_pool("pretrained_ckpt/cifar10/simclr_imb_pretrain0_1.tar"))
ARG_POOLS.register(
    "ssp_finetuning_imbalanced_cifar10_imb_0_01",
    _imb_cifar_pool("pretrained_ckpt/cifar10/simclr_imb_pretrain0_01.tar"))
ARG_POOLS.register("synthetic", {
    "synthetic": TrainConfig(
        eval_split=0.1, loader_tr=_CIFAR_TR, loader_te=_CIFAR_TE,
        optimizer=OptimizerConfig("sgd", lr=0.05, weight_decay=5e-4,
                                  momentum=0.9),
        scheduler=SchedulerConfig("cosine", t_max=200)),
})


def get_train_config(arg_pool: str, dataset: str,
                     pretrained_root: Optional[str] = None) -> TrainConfig:
    """Resolve ``(arg_pool, dataset) -> TrainConfig``; KeyError for an
    unknown pool or a dataset the pool has no entry for.  A relative
    pretrained path is rebased onto ``pretrained_root`` when given (the
    reference's fixed ``../pretrained_ckpt`` layout)."""
    pool = ARG_POOLS.get(arg_pool)
    try:
        cfg = pool[dataset]
    except KeyError:
        known = ", ".join(sorted(pool))
        raise KeyError(
            f"arg pool '{arg_pool}' has no entry for dataset '{dataset}' "
            f"(has: {known})") from None
    if (pretrained_root and cfg.pretrained.path
            and not os.path.isabs(cfg.pretrained.path)):
        cfg = dataclasses.replace(cfg, pretrained=dataclasses.replace(
            cfg.pretrained,
            path=os.path.join(pretrained_root, cfg.pretrained.path)))
    return cfg
