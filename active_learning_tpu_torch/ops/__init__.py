"""The port's hand-written kernels: kernel A ``prob_stats`` (CUDA),
kernel B ``bn_act`` (Triton), kernel C ``bn_train`` (CUDA, three device
functions) and kernel D ``fused_sgd`` (CUDA).  Each wrapper counts its
launches; ``kernel_launches`` reads them all, so a run can show which
kernels its path went through."""

from __future__ import annotations

from typing import Dict


def kernel_launches() -> Dict[str, int]:
    from . import bn_act, bn_train, fused_sgd, prob_stats
    return {"prob_stats": prob_stats.launches, "bn_act": bn_act.launches,
            "bn_train_stats": bn_train.stats_launches,
            "bn_train_bwd_reduce": bn_train.reduce_launches,
            "bn_train_dx": bn_train.dx_launches,
            "fused_sgd": fused_sgd.launches}


def reset_kernel_launches() -> None:
    from . import bn_act, bn_train, fused_sgd, prob_stats
    prob_stats.launches = 0
    bn_act.launches = 0
    bn_train.reset_launches()
    fused_sgd.launches = 0
