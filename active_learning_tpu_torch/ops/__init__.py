"""The port's hand-written kernels: kernel A ``prob_stats`` (CUDA),
kernel B ``bn_act`` (CUDA) and its backward, kernel B′
``bn_act_backward`` (CUDA), kernel C ``bn_train`` (CUDA: the
statistics and the backward reduction with their [C] chains, the N-rank
chain, dx), kernel D ``fused_sgd`` (CUDA), kernel E ``kcenter`` (CUDA:
fold + top-q, the batched greedy's pass with its re-check, fold + D²
draw, initial min), kernel F ``boundary_radii`` (CUDA: radii, pair
norms), kernel G ``badge`` (CUDA), kernel H
``balancing`` (CUDA: the balancing pick), kernel I ``stem_conv``
(CUDA: the s2d stem's weight gradient) and kernel J ``int8_sync``
(CUDA: the int8 gradient sync's block absmax, quantize, dequantizing
sum and reduce-scatter re-quantization).  Each wrapper counts its
launches; ``kernel_launches`` reads them all, so a run can
show which kernels its path went through."""

from __future__ import annotations

from typing import Dict


def kernel_launches() -> Dict[str, int]:
    from . import (badge, balancing, bn_act, bn_train, boundary_radii,
                   fused_sgd, int8_sync, kcenter, prob_stats, stem_conv)
    return {"prob_stats": prob_stats.launches, "bn_act": bn_act.launches,
            "bn_act_bwd": bn_act.bwd_launches,
            "bn_train_stats": bn_train.stats_launches,
            "bn_train_bwd_reduce": bn_train.reduce_launches,
            "bn_train_chain": bn_train.chain_launches,
            "bn_train_dx": bn_train.dx_launches,
            "fused_sgd": fused_sgd.launches,
            "kcenter_fold_select": kcenter.select_launches,
            "kcenter_batch_pass": kcenter.batch_launches,
            "kcenter_fold_draw": kcenter.draw_launches,
            "kcenter_min_fold": kcenter.min_fold_launches,
            "boundary_radii": boundary_radii.radii_launches,
            "head_pair_norms": boundary_radii.pair_norms_launches,
            "badge_factors": badge.launches,
            "balancing_pick": balancing.launches,
            "stem_dw": stem_conv.launches,
            "int8_absmax": int8_sync.absmax_launches,
            "int8_quantize": int8_sync.quantize_launches,
            "int8_dequant_sum": int8_sync.dequant_launches,
            "int8_sum_requantize": int8_sync.requantize_launches}


def reset_kernel_launches() -> None:
    from . import (badge, balancing, bn_act, bn_train, boundary_radii,
                   fused_sgd, int8_sync, kcenter, prob_stats, stem_conv)
    prob_stats.launches = 0
    bn_act.launches = 0
    bn_act.bwd_launches = 0
    bn_train.reset_launches()
    fused_sgd.launches = 0
    kcenter.reset_launches()
    boundary_radii.reset_launches()
    badge.launches = 0
    balancing.launches = 0
    balancing.kernel_launches = 0
    stem_conv.launches = 0
    int8_sync.reset_launches()
