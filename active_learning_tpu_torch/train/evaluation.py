"""Evaluation metrics (the JAX package's ``train/evaluation.py``):
per-batch additive counts on the device, summed over batches, divided
once on the host.

Ranks follow ``jax.lax.top_k``: the total order of float32 (so -0 ranks
below +0) and, among equal values, the lower index first.
``torch.topk`` leaves the order of ties unspecified, so it is not used.
With ``key`` the total-order integer of each logit, top-1 is the first
maximum of ``key``, and label ``y`` is in the top k exactly when
``#{j: key_j > key_y} + #{j < y: key_j == key_y} < k``.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

# Calibration bins (the JAX package's telemetry/diagnostics.NUM_CAL_BINS).
NUM_CAL_BINS = 10


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys ordered as float32's total order (-0 < +0): the sign
    bit set flips the other 31 bits."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def batch_metric_counts(logits: torch.Tensor, labels: torch.Tensor,
                        mask: torch.Tensor, num_classes: int,
                        top_k: int = 5) -> Dict[str, torch.Tensor]:
    """Counts for one batch: top-1/top-k corrects, per-class corrects and
    totals, and the calibration bins; padding rows (mask 0) count
    nothing."""
    k = min(top_k, num_classes)
    logits = logits.to(torch.float32)
    labels = labels.to(torch.int64)
    key = total_order_key(logits)
    ky = key.gather(1, labels[:, None])
    cls = torch.arange(logits.shape[1], device=logits.device)
    earlier = cls[None, :] < labels[:, None]
    ahead = ((key > ky) | ((key == ky) & earlier)).sum(dim=1)
    hit_topk = (ahead < k).to(torch.float32)
    top1 = (torch.argmax(key, dim=1) == labels).to(torch.float32)
    maskf = mask.to(torch.float32)
    onehot = torch.nn.functional.one_hot(labels, num_classes).to(
        torch.float32) * maskf[:, None]
    conf = torch.softmax(logits, dim=-1).max(dim=-1).values
    cal_bin = torch.clamp((conf * NUM_CAL_BINS).to(torch.int64), 0,
                          NUM_CAL_BINS - 1)
    cal_onehot = torch.nn.functional.one_hot(cal_bin, NUM_CAL_BINS).to(
        torch.float32) * maskf[:, None]
    return {
        "top_1_correct": torch.sum(top1 * maskf),
        "top_k_correct": torch.sum(hit_topk * maskf),
        "corrects_byclass": torch.sum(onehot * (top1 * maskf)[:, None],
                                      dim=0),
        "count_byclass": torch.sum(onehot, dim=0),
        "count": torch.sum(maskf),
        "cal_count": torch.sum(cal_onehot, dim=0),
        "cal_correct": torch.sum(cal_onehot * (top1 * maskf)[:, None],
                                 dim=0),
        "cal_conf_sum": torch.sum(cal_onehot * conf[:, None], dim=0),
    }


def accumulate_metrics(count_iter: Iterable[Dict[str, torch.Tensor]]
                       ) -> Dict[str, np.ndarray]:
    """Sum per-batch counts on the device (one host fetch at the end) and
    derive the reference's metric keys: accuracy, top_5_accuracy,
    accuracy_byclass, corrects_byclass, count_byclass, count, and the
    calibration bins."""
    totals = None
    for counts in count_iter:
        if totals is None:
            totals = dict(counts)
        else:
            totals = {k: totals[k] + counts[k] for k in totals}
    if totals is None:
        return {
            "accuracy": np.float32(0.0), "top_5_accuracy": np.float32(0.0),
            "accuracy_byclass": np.zeros(0, np.float32),
            "corrects_byclass": np.zeros(0, np.float32),
            "count_byclass": np.zeros(0, np.float32),
            "count": np.float32(0.0),
            "cal_count": np.zeros(NUM_CAL_BINS, np.float32),
            "cal_correct": np.zeros(NUM_CAL_BINS, np.float32),
            "cal_conf_sum": np.zeros(NUM_CAL_BINS, np.float32),
        }
    totals = {k: v.cpu().numpy() for k, v in totals.items()}
    count = max(totals["count"], 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        byclass = totals["corrects_byclass"] / totals["count_byclass"]
    return {
        "accuracy": totals["top_1_correct"] / count,
        "top_5_accuracy": totals["top_k_correct"] / count,
        "accuracy_byclass": byclass,
        "corrects_byclass": totals["corrects_byclass"],
        "count_byclass": totals["count_byclass"],
        "count": count,
        "cal_count": totals["cal_count"],
        "cal_correct": totals["cal_correct"],
        "cal_conf_sum": totals["cal_conf_sum"],
    }
