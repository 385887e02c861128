"""Seeded initial-pool and eval-split index generation (copy of the JAX
package's ``initial_pool.py``): ``random`` and ``random_balance``
generation with the water-filling balanced allocation, numpy draws in
the same order, so the round-0 indices are the reference's bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def balanced_allocation(counts: np.ndarray, total: int) -> np.ndarray:
    """Water-filling: per-class quota summing to ``total``, as balanced
    as the per-class availability allows; the "+1" extras go to the
    largest classes."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(total)
    if total > counts.sum():
        raise ValueError(
            f"requested {total} samples but only {counts.sum()} available")
    order = np.argsort(counts, kind="stable")
    sorted_counts = counts[order]

    lo, hi = 0, int(sorted_counts.max(initial=0))
    while lo < hi:
        mid = (lo + hi) // 2
        if np.minimum(sorted_counts, mid).sum() >= total:
            hi = mid
        else:
            lo = mid + 1
    thres = lo
    quota_sorted = np.minimum(sorted_counts, thres)
    surplus = int(quota_sorted.sum() - total)
    if surplus > 0:
        at_thres = np.flatnonzero(quota_sorted == thres)
        quota_sorted[at_thres[:surplus]] -= 1
    quota = np.empty_like(quota_sorted)
    quota[order] = quota_sorted
    return quota


def generate_idxs(targets: Sequence[int], num_classes: int, size: int,
                  generation_type: str,
                  avoid_idxs: Optional[Sequence[int]] = None,
                  random_seed: Optional[int] = None) -> np.ndarray:
    """``size`` indices, uniform ("random") or class-balanced
    ("random_balance", rounded down to a multiple of ``num_classes``),
    from positions not in ``avoid_idxs``."""
    rng = np.random.default_rng(random_seed)
    targets = np.asarray(targets, dtype=np.int64)
    available = np.arange(len(targets))
    if avoid_idxs is not None and len(avoid_idxs):
        available = np.setdiff1d(available, np.asarray(avoid_idxs))

    if generation_type == "random":
        rng.shuffle(available)
        return available[:size]

    if generation_type == "random_balance":
        if size % num_classes != 0:
            size = size - size % num_classes
        counts = np.bincount(targets[available], minlength=num_classes)
        quota = balanced_allocation(counts, size)
        rng.shuffle(available)
        remaining = quota.copy()
        result = []
        for idx in available:
            if size == 0:
                break
            y = targets[idx]
            if remaining[y] > 0:
                result.append(idx)
                remaining[y] -= 1
                size -= 1
        return np.asarray(result, dtype=np.int64)

    raise ValueError(f"Init pool type '{generation_type}' not implemented")


def generate_eval_idxs(targets: Sequence[int], num_classes: int,
                       ratio: float = 0.1,
                       random_seed: Optional[int] = None) -> np.ndarray:
    """Class-balanced validation split."""
    eval_size = int(len(targets) * ratio)
    return generate_idxs(targets, num_classes, eval_size,
                         generation_type="random_balance",
                         random_seed=random_seed)


def generate_init_lb_idxs(targets: Sequence[int], num_classes: int,
                          eval_idxs: Sequence[int], init_pool_size: int,
                          init_pool_type: str = "random",
                          random_seed: Optional[int] = None) -> np.ndarray:
    """Round-0 labeled pool, avoiding the eval split."""
    return generate_idxs(targets, num_classes, init_pool_size,
                         generation_type=init_pool_type,
                         avoid_idxs=eval_idxs, random_seed=random_seed)
