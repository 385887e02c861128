"""Class-balancing acquisition for imbalanced pools (the JAX package's
``strategies/balancing.py``; WACV 2020, reference
src/query_strategies/balancing_sampler.py:8-136).

Per selection: if the labeled class distribution is imbalanced relative
to the remaining budget, pick the unlabeled row whose distance to the
rarest class's centroid, over its largest distance to any majority
centroid, is smallest (kernel H, ``ops/balancing.py``); otherwise pick
uniformly at random from the numpy rng, one ``rng.choice`` per pick as
the JAX package draws it.

The pool's embeddings and the eligibility mask go to the device once, at
the first balancing pick (a query that stays random never uploads them).
Each balancing pick then sends one float32 [D] centroid row (after the
first pick's whole [C, D]), the [C] majority mask and two scalars, and
reads back one index: the class bookkeeping stays on the host, because
the label-peeking update makes the pick loop serial.  Centroid sums
accumulate in float64 and go down as float32, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.balancing import balancing_pick
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
        emb_dev = eligible_dev = centers_dev = None

        def center_row(c: int) -> np.ndarray:
            return (sums[c] / (counts[c] + 1e-5)).astype(np.float32)

        labeled = self.already_labeled_mask()
        counts = np.bincount(ys[labeled], minlength=n_classes
                             ).astype(np.int64)
        sums = np.zeros((n_classes, embeddings.shape[1]), dtype=np.float64)
        np.add.at(sums, ys[labeled], embeddings[labeled])

        selected = []
        for query_count in range(budget):
            mean_count = counts.mean()
            maj = counts > mean_count
            minor = ~maj
            avg_maj = counts[maj].sum() / max(maj.sum(), 1)
            avg_minor = counts[minor].sum() / max(minor.sum(), 1)

            remaining = budget - query_count
            if remaining <= minor.sum() * (avg_maj - avg_minor):
                if emb_dev is None:
                    emb_dev = torch.from_numpy(np.ascontiguousarray(
                        embeddings, dtype=np.float32)).to(dev)
                    eligible_dev = torch.from_numpy(idxs_for_query).to(dev)
                if centers_dev is None:
                    centers_dev = torch.from_numpy(np.stack(
                        [center_row(i) for i in range(n_classes)])).to(dev)
                rarest = int(np.argmin(counts))
                query_idx = int(balancing_pick(
                    emb_dev, eligible_dev, centers_dev,
                    torch.from_numpy(maj).to(dev), rarest,
                    counts[rarest] == 0))
                self.last_balancing_picks += 1
            else:
                # Balanced enough: random pick (balancing_sampler.py:126-128).
                query_idx = int(self.rng.choice(
                    np.flatnonzero(idxs_for_query)))

            idxs_for_query[query_idx] = False
            if eligible_dev is not None:
                eligible_dev[query_idx] = False
            c = int(ys[query_idx])
            counts[c] += 1
            sums[c] += embeddings[query_idx]
            if centers_dev is not None:
                centers_dev[c] = torch.from_numpy(center_row(c)).to(dev)
            selected.append(query_idx)

        self.logger.info(f"Number of queried images: {budget}")
        return np.asarray(selected, dtype=np.int64), budget
