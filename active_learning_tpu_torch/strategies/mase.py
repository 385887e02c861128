"""MASE and BASE: decision-boundary-distance acquisition (the JAX
package's ``strategies/mase.py``).

Reference: mase_sampler.py:6-96 (the smallest distance to any one-vs-one
decision boundary of the linear head, in final-embedding space) and
base_sampler.py:6-41 (its class-balanced variant).  The radii come from
one pass of the mase step (kernel F) over the unshuffled available set.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .base import Strategy, register_strategy


@register_strategy("MASESampler")
class MASESampler(Strategy):
    """Examples closest to any decision boundary first
    (mase_sampler.py:20-28)."""

    def compute_margins(self, idxs: np.ndarray):
        """(min_margins, per_class_radii, pred_labels) for ``idxs``
        (mase_sampler.py:30-96)."""
        out = self.collect_scores(idxs, "mase")
        return out["min_margin"], out["radii"], out["pred"]

    def query(self, budget: int) -> Tuple[np.ndarray, int]:
        idxs = self.available_query_idxs(shuffle=False)
        if len(idxs) == 0:
            return idxs, 0
        min_margins, _, _ = self.compute_margins(idxs)
        budget = int(min(len(idxs), budget))
        order = np.argsort(min_margins, kind="stable")[:budget]
        return idxs[order], budget


@register_strategy("BASESampler")
class BASESampler(MASESampler):
    """Class-balanced MASE: a quota of ``budget // num_classes`` per
    predicted class (+1 for the first ``budget % C`` classes), where a
    row's distance for class c is its min margin if it is predicted c,
    else its radius to the c-boundary (base_sampler.py:22-35)."""

    def query(self, budget: int) -> Tuple[np.ndarray, int]:
        idxs = self.available_query_idxs(shuffle=False)
        if len(idxs) == 0:
            return idxs, 0
        min_margins, radii, preds = self.compute_margins(idxs)
        budget = int(min(len(idxs), budget))

        taken = np.zeros(len(idxs), dtype=bool)
        selected = []
        for c in range(self.num_classes):
            quota = budget // self.num_classes + int(
                c < budget % self.num_classes)
            if quota == 0:
                continue
            dist = np.where(preds == c, min_margins, radii[:, c])
            dist = np.where(taken, np.inf, dist)
            picks = np.argsort(dist, kind="stable")[:quota]
            taken[picks] = True
            selected.extend(picks.tolist())
        assert len(selected) == len(set(selected))
        return idxs[np.asarray(selected, dtype=np.int64)], budget
