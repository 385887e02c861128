"""Softmax-uncertainty acquisition: least confidence and smallest margin
(the JAX package's ``strategies/uncertainty.py``).  Both score the
unshuffled available set in one pass of the prob-stats step (kernel A)
and take the ``budget`` smallest scores, ties to the earlier pool index
(``argsort(kind="stable")``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .base import Strategy, register_strategy


class _ScoreAscendingSampler(Strategy):
    score_key: str = ""

    def query(self, budget: int) -> Tuple[np.ndarray, int]:
        idxs = self.available_query_idxs(shuffle=False)
        if len(idxs) == 0:
            return idxs, 0
        scores = self.collect_scores(idxs,
                                     keys=(self.score_key,))[self.score_key]
        budget = int(min(len(idxs), budget))
        order = np.argsort(scores, kind="stable")[:budget]
        return idxs[order], budget


@register_strategy("ConfidenceSampler")
class ConfidenceSampler(_ScoreAscendingSampler):
    """Smallest top-1 softmax probability first."""

    score_key = "confidence"


@register_strategy("MarginSampler")
class MarginSampler(_ScoreAscendingSampler):
    """Smallest (top-1 − top-2) softmax probability margin first."""

    score_key = "margin"
