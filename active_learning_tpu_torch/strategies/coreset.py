"""Coreset (greedy k-center) and BADGE acquisition, and their
partitioned variants (the JAX package's ``strategies/coreset.py``).

Reference: coreset_sampler.py:8-133 (k-center greedy over final
embeddings, Sener & Savarese arXiv:1708.00489), badge_sampler.py:13-78
(randomized k-center over gradient embeddings, arXiv:1906.03671),
partitioned_coreset_sampler.py:9-84 and partitioned_badge_sampler.py:5-19
(random partitions of the pool, arXiv:2107.14263).

The embedding or gradient-factor pass is one scoring pass
(``collect_scores``: kernel G for BADGE); the selection runs on the
device over the factor matrices (``strategies/kcenter.py``, kernel E),
and the N x N matrix the reference builds never exists.  Left out
(ROADMAP.md): the pipelined round's speculative scoring plans and the
pick-distance diagnostics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .base import Strategy, register_strategy
from .kcenter import kcenter_greedy

Factors = Tuple[np.ndarray, ...]


@register_strategy("CoresetSampler")
class CoresetSampler(Strategy):
    """k-Center greedy: repeatedly pick the unlabeled row farthest from
    the labeled set in final-embedding space (coreset_sampler.py:66-105)."""

    randomize = False
    # With frozen features the embeddings do not change between rounds,
    # so the factors are cached (the reference caches its pairwise matrix,
    # coreset_sampler.py:112-121).  BADGE recomputes every round.
    cache_factors = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._saved_factors: Optional[Factors] = None

    def get_idxs_for_coreset(self, return_sep_idxs: bool = False):
        """The rows the selection runs over: all available and all
        labeled rows (never the eval split), capped by ``subset_labeled``
        and ``subset_unlabeled``; the unlabeled cap inherits the labeled
        cap's unused quota (coreset_sampler.py:21-41)."""
        idxs_for_query = self.available_query_idxs(shuffle=True)
        idxs_labeled = self.already_labeled_idxs(shuffle=True)
        subset_labeled = self.cfg.subset_labeled
        subset_unlabeled = self.cfg.subset_unlabeled

        if subset_labeled is not None:
            cap_lb = min(subset_labeled, len(idxs_labeled))
            idxs_labeled = idxs_labeled[:cap_lb]
        if subset_unlabeled is not None:
            if subset_labeled is not None:
                cap_ul = subset_labeled + subset_unlabeled - cap_lb
            else:
                cap_ul = subset_unlabeled
            cap_ul = min(cap_ul, len(idxs_for_query))
            idxs_for_query = idxs_for_query[:cap_ul]

        idxs_for_coreset = np.sort(np.concatenate(
            [idxs_for_query, idxs_labeled])).astype(np.int64)
        if return_sep_idxs:
            return idxs_for_coreset, idxs_labeled, idxs_for_query
        return idxs_for_coreset

    def get_factors(self, idxs: np.ndarray) -> Factors:
        """The factor matrices of ``idxs``: their final embeddings."""
        out = self.collect_scores(idxs, "embed", keys=("embedding",))
        return (out["embedding"],)

    def _factors_with_cache(self, idxs: np.ndarray) -> Factors:
        # The cache is valid only while idxs is the same every round,
        # which holds when the subset caps are off (then it is every
        # non-eval row).
        subsets_off = (self.cfg.subset_labeled is None
                       and self.cfg.subset_unlabeled is None)
        cacheable = (self.cache_factors and self.cfg.freeze_feature
                     and subsets_off)
        if cacheable and self._saved_factors is not None:
            return self._saved_factors
        factors = self.get_factors(idxs)
        if cacheable:
            self._saved_factors = factors
        return factors

    def _select(self, factors: Factors, labeled_mask: np.ndarray,
                budget: int) -> np.ndarray:
        return kcenter_greedy(factors, labeled_mask, budget,
                              randomize=self.randomize, rng=self.rng,
                              batch_q=self.cfg.kcenter_batch,
                              device=self.trainer.device)

    def query(self, budget: int) -> Tuple[np.ndarray, int]:
        idxs_for_coreset, _, idxs_for_query = self.get_idxs_for_coreset(
            return_sep_idxs=True)
        if len(idxs_for_query) == 0:
            return np.zeros(0, dtype=np.int64), 0
        factors = self._factors_with_cache(idxs_for_coreset)
        labeled_mask = self.already_labeled_mask()[idxs_for_coreset]
        budget = int(min(len(idxs_for_query), budget))
        picks = self._select(factors, labeled_mask, budget)
        selected = idxs_for_coreset[picks]
        assert len(np.unique(selected)) == len(selected), (
            "k-center selected a duplicate index")
        self.logger.info(f"Number of queried images: {len(selected)}")
        return selected, len(selected)


@register_strategy("BADGESampler")
class BADGESampler(CoresetSampler):
    """Randomized k-center (k-means++ D² draws) over gradient embeddings
    (badge_sampler.py:50-78); the factors are (softmax - onehot,
    embedding) and their outer product is never formed."""

    randomize = True
    cache_factors = False

    def get_factors(self, idxs: np.ndarray) -> Factors:
        out = self.collect_scores(idxs, "badge", keys=("grad_a", "grad_e"))
        return (out["grad_a"], out["grad_e"])


@register_strategy("PartitionedCoresetSampler")
class PartitionedCoresetSampler(CoresetSampler):
    """Random-partition k-center: labeled and unlabeled rows are split
    separately into ``partitions`` equal shards, so every shard has the
    same balance, and each shard selects its share of the budget
    (partitioned_coreset_sampler.py:36-84)."""

    def generate_partition_idxs_list(self, input_idxs: np.ndarray):
        idxs = np.array(input_idxs)
        self.rng.shuffle(idxs)
        n, p = len(idxs), self.cfg.partitions
        parts, cum = [], 0
        for i in range(p):
            cur = n // p + int(i < n % p)
            parts.append(idxs[cum:cum + cur])
            cum += cur
        return parts

    def query(self, budget: int) -> Tuple[np.ndarray, int]:
        _, idxs_labeled, idxs_for_query = self.get_idxs_for_coreset(
            return_sep_idxs=True)
        if len(idxs_for_query) == 0:
            return np.zeros(0, dtype=np.int64), 0
        labeled_parts = self.generate_partition_idxs_list(idxs_labeled)
        unlabeled_parts = self.generate_partition_idxs_list(idxs_for_query)

        budget = int(min(len(idxs_for_query), budget))
        p = self.cfg.partitions
        selected = []
        for i in range(p):
            part = np.concatenate(
                [labeled_parts[i], unlabeled_parts[i]]).astype(np.int64)
            cur_budget = budget // p + int(i < budget % p)
            # budget <= the unlabeled total and both splits use the same
            # i < n % p rule, so cur_budget <= len(unlabeled_parts[i]).
            if cur_budget == 0 or len(part) == 0:
                continue
            factors = self.get_factors(part)
            labeled_mask = np.zeros(len(part), dtype=bool)
            labeled_mask[:len(labeled_parts[i])] = True
            picks = self._select(factors, labeled_mask, cur_budget)
            selected.append(part[picks])

        selected = (np.sort(np.concatenate(selected)) if selected
                    else np.zeros(0, dtype=np.int64))
        assert len(np.unique(selected)) == len(selected), (
            "partitioned k-center selected a duplicate index")
        self.logger.info(f"Number of queried images: {len(selected)}")
        return selected, len(selected)


@register_strategy("PartitionedBADGESampler")
class PartitionedBADGESampler(PartitionedCoresetSampler):
    """Partitioned randomized k-center over pooled gradient embeddings
    (partitioned_badge_sampler.py:14-19: pooled to 512 dimensions, then
    the partitioned D² selection)."""

    randomize = True
    cache_factors = False

    def get_factors(self, idxs: np.ndarray) -> Factors:
        out = self.collect_scores(idxs, "badge_pool",
                                  keys=("grad_a", "grad_e"))
        return (out["grad_a"], out["grad_e"])
