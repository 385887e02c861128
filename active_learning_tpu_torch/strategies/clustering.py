"""Margin-clustering acquisition: Ward clusters + round-robin min-margin
(the JAX package's ``strategies/clustering.py``; reference
src/query_strategies/margin_clustering_sampler.py:9-90,
arXiv:2107.14263).

One scoring pass gives the embeddings and softmax margins (the
``embed_margin`` step: kernel A for the margins); the clustering runs on
the host, once.  The JAX package clusters with scikit-learn's
``AgglomerativeClustering(n_clusters)``, which without a connectivity
matrix is ``scipy.cluster.hierarchy.ward`` followed by its own tree cut
(``sklearn/cluster/_agglomerative.py``: ``ward_tree`` and ``_hc_cut``).
The port calls the same scipy function and keeps its own copy of the cut
(``hc_cut``), label numbering included: the round-robin orders clusters
of equal size by id, so the numbering changes the picks.  Ward over N
rows holds a float64 condensed distance matrix, N(N-1)/2 values, as the
reference does.

Cluster-cache semantics as in the JAX package: cluster once on the
first query and carry the assignments forward with the queried rows
removed (the available rows are sorted and shrink by exactly the
queried ones); with ``subset_unlabeled`` the subset is re-drawn and
re-clustered every round.
"""

from __future__ import annotations

from heapq import heappush, heappushpop
from typing import Optional, Tuple

import numpy as np

from .base import Strategy, register_strategy

N_CLUSTERS = 20  # margin_clustering_sampler.py:59


def _hc_get_descendent(node: int, children: np.ndarray,
                       n_leaves: int) -> list:
    """The leaves under ``node``, in the order scikit-learn's
    ``_hierarchical_fast._hc_get_descendent`` lists them."""
    ind = [node]
    if node < n_leaves:
        return ind
    descendent = []
    n_indices = 1
    while n_indices:
        i = ind.pop()
        if i < n_leaves:
            descendent.append(i)
            n_indices -= 1
        else:
            ind.extend(children[i - n_leaves])
            n_indices += 1
    return descendent


def hc_cut(n_clusters: int, children: np.ndarray,
           n_leaves: int) -> np.ndarray:
    """Cut a merge tree into ``n_clusters`` clusters, numbered as
    scikit-learn's ``_hc_cut`` numbers them: split the highest node
    until there are ``n_clusters``, and label the clusters in the order
    of the heap of (negated) node ids that the splits leave."""
    if n_clusters > n_leaves:
        raise ValueError(f"Cannot extract more clusters than samples: "
                         f"{n_clusters} clusters were given for a tree with "
                         f"{n_leaves} leaves.")
    nodes = [-(max(children[-1]) + 1)]
    for _ in range(n_clusters - 1):
        these_children = children[-nodes[0] - n_leaves]
        heappush(nodes, -these_children[0])
        heappushpop(nodes, -these_children[1])
    label = np.zeros(n_leaves, dtype=np.intp)
    for i, node in enumerate(nodes):
        label[_hc_get_descendent(-node, children, n_leaves)] = i
    return label


def ward_labels(x: np.ndarray, n_clusters: int) -> np.ndarray:
    """``AgglomerativeClustering(n_clusters).fit(x).labels_`` (Ward
    linkage, no connectivity) for ``x`` [N, D] with N >= 2."""
    from scipy.cluster import hierarchy

    x = np.asarray(x)
    if x.ndim == 1:
        x = x.reshape(-1, 1)
    children = hierarchy.ward(np.require(x, requirements="W"))[:, :2]
    return hc_cut(n_clusters, children.astype(np.intp), x.shape[0])


@register_strategy("MarginClusteringSampler")
class MarginClusteringSampler(Strategy):

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.cluster_assignment: Optional[np.ndarray] = None

    def get_embeddings_and_margins(self, idxs: np.ndarray):
        out = self.collect_scores(idxs, "embed_margin",
                                  keys=("embedding", "margin"))
        return out["embedding"], out["margin"]

    def query(self, budget: int) -> Tuple[np.ndarray, int]:
        subset = self.cfg.subset_unlabeled
        if subset is None:
            idxs_for_hac = self.available_query_idxs(shuffle=False)
        else:
            idxs_for_hac = np.sort(
                self.available_query_idxs(shuffle=True)[:subset])
        if len(idxs_for_hac) == 0:
            return idxs_for_hac, 0

        if self.cluster_assignment is None or subset is not None:
            embeddings, margins = self.get_embeddings_and_margins(
                idxs_for_hac)
            n_clusters = min(N_CLUSTERS, len(idxs_for_hac))
            assignment = ward_labels(embeddings, n_clusters)
        else:
            # Cached-assignment rounds only need fresh margins.
            margins = self.collect_scores(idxs_for_hac, "prob_stats",
                                          keys=("margin",))["margin"]
            assignment = self.cluster_assignment

        cluster_ids, cluster_count = np.unique(assignment,
                                               return_counts=True)
        # Smallest clusters first; ties by id (:64-66).
        order = sorted(zip(cluster_count.tolist(), cluster_ids.tolist()))
        cluster_ids_sorted = [cid for _, cid in order]

        budget = int(min(len(idxs_for_hac), budget))
        query_idxs = []
        start_cluster = 0
        while len(query_idxs) < budget:
            # Round-robin: one min-margin pick per remaining cluster, small
            # clusters first; a cluster that empties advances the start
            # (:71-87).
            for i in range(start_cluster, len(cluster_ids_sorted)):
                cid = cluster_ids_sorted[i]
                members = np.flatnonzero(assignment == cid)
                pick = members[np.argmin(margins[members])]
                assignment[pick] = -1
                query_idxs.append(int(idxs_for_hac[pick]))
                if len(members) == 1:
                    start_cluster += 1
                if len(query_idxs) >= budget:
                    break

        # Carry forward the still-unqueried rows' assignments (:89).
        self.cluster_assignment = assignment[assignment != -1]
        self.logger.info(f"Number of queried images: {budget}")
        return np.asarray(query_idxs, dtype=np.int64), budget
