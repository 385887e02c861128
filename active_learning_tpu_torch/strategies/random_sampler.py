"""Random and class-balanced-random acquisition (the JAX package's
``strategies/random_sampler.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..initial_pool import balanced_allocation
from .base import Strategy, register_strategy


@register_strategy("RandomSampler")
class RandomSampler(Strategy):
    """Uniform random from the unlabeled pool: one permutation of the
    available set, the first ``budget`` taken."""

    def query(self, budget: int) -> Tuple[np.ndarray, int]:
        idxs = self.available_query_idxs(shuffle=True)
        count = int(min(len(idxs), budget))
        self.logger.info(f"Number of queried images: {count}")
        return idxs[:count], count


@register_strategy("BalancedRandomSampler")
class BalancedRandomSampler(Strategy):
    """CHEATING BASELINE: peeks at the true labels of unlabeled examples
    to draw a class-balanced random batch (water-filling quotas, one
    permutation per class in class order)."""

    def query(self, budget: int) -> Tuple[np.ndarray, int]:
        targets = self.al_set.targets
        avail_mask = self.available_query_mask()
        budget = int(min(avail_mask.sum(), budget))
        counts = np.bincount(targets[avail_mask], minlength=self.num_classes)
        quota = balanced_allocation(counts, budget)
        picked = []
        for c in np.flatnonzero(quota):
            class_avail = np.flatnonzero((targets == c) & avail_mask)
            picked.append(self.rng.permutation(class_avail)[: quota[c]])
        labeled_idxs = (np.concatenate(picked) if picked
                        else np.zeros(0, dtype=np.int64))
        self.logger.info(f"Number of queried images: {budget}")
        return labeled_idxs, budget
