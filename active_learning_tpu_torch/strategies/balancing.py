"""Class-balancing acquisition for imbalanced pools (the JAX package's
``strategies/balancing.py``; WACV 2020, reference
src/query_strategies/balancing_sampler.py:8-136).

Per selection: if the labeled class distribution is imbalanced relative
to the remaining budget, pick the unlabeled row whose distance to the
rarest class's centroid, over its largest distance to any majority
centroid, is smallest (kernel H, ``ops/balancing.py``); otherwise pick
uniformly at random from the numpy rng, one ``rng.choice`` per pick as
the JAX package draws it.

The pool's embeddings, the eligibility mask and the class centroids go
to the device once, into a ``BalancingState`` (``ops/balancing.py``), at
the first balancing pick (a query that stays random never uploads
them).  After it every pick of either branch is one ``take`` (the row
leaves the eligible set, its class's centroid changes), queued on the
host, and every balancing pick one ``pick``: the queue and the [C]
majority mask in one copy, at most two launches, one read of the index.
The class bookkeeping stays on the host, because the label-peeking
update makes the pick loop serial.  Centroid sums accumulate in float64
and go down as float32, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.balancing import BalancingState
from .base import Strategy, register_strategy


@register_strategy("BalancingSampler")
class BalancingSampler(Strategy):

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._saved_embeddings: Optional[np.ndarray] = None
        # Balancing picks of the last query: each reads one index back.
        self.last_balancing_picks = 0

    def _all_embeddings(self) -> np.ndarray:
        if self.cfg.freeze_feature and self._saved_embeddings is not None:
            return self._saved_embeddings
        all_idxs = np.arange(len(self.al_set), dtype=np.int64)
        emb = self.collect_scores(all_idxs, "embed",
                                  keys=("embedding",))["embedding"]
        if self.cfg.freeze_feature:
            self._saved_embeddings = emb
        return emb

    def query(self, budget: int) -> Tuple[np.ndarray, int]:
        ys = self.al_set.targets[: len(self.al_set)]
        idxs_for_query = self.available_query_mask().copy()
        budget = int(min(idxs_for_query.sum(), budget))
        self.last_balancing_picks = 0
        if budget == 0:
            return np.zeros(0, dtype=np.int64), 0
        embeddings = self._all_embeddings()
        n_classes = self.num_classes
        dev = self.trainer.device
        state = None

        def center_row(c: int) -> np.ndarray:
            return (sums[c] / (counts[c] + 1e-5)).astype(np.float32)

        labeled = self.already_labeled_mask()
        counts = np.bincount(ys[labeled], minlength=n_classes
                             ).astype(np.int64)
        sums = np.zeros((n_classes, embeddings.shape[1]), dtype=np.float64)
        np.add.at(sums, ys[labeled], embeddings[labeled])

        selected = []
        try:
            for query_count in range(budget):
                mean_count = counts.mean()
                maj = counts > mean_count
                minor = ~maj
                avg_maj = counts[maj].sum() / max(maj.sum(), 1)
                avg_minor = counts[minor].sum() / max(minor.sum(), 1)

                remaining = budget - query_count
                if remaining <= minor.sum() * (avg_maj - avg_minor):
                    if state is None:
                        state = BalancingState(
                            torch.from_numpy(np.ascontiguousarray(
                                embeddings, dtype=np.float32)).to(dev),
                            torch.from_numpy(idxs_for_query).to(dev),
                            torch.from_numpy(np.stack(
                                [center_row(i) for i in range(n_classes)]
                            )).to(dev))
                    rarest = int(np.argmin(counts))
                    query_idx = state.pick(maj, rarest, counts[rarest] == 0)
                    self.last_balancing_picks += 1
                else:
                    # Balanced enough: random pick
                    # (balancing_sampler.py:126-128).
                    query_idx = int(self.rng.choice(
                        np.flatnonzero(idxs_for_query)))

                idxs_for_query[query_idx] = False
                c = int(ys[query_idx])
                counts[c] += 1
                sums[c] += embeddings[query_idx]
                if state is not None:
                    state.take(query_idx, c, center_row(c))
                selected.append(query_idx)
        finally:
            if state is not None:
                state.close()

        self.logger.info(f"Number of queried images: {budget}")
        return np.asarray(selected, dtype=np.int64), budget
