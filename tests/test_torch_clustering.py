"""The port's MarginClusteringSampler against the JAX package, on the CPU.

* ``ward_labels`` (scipy's ward plus the port's copy of scikit-learn's
  tree cut) equals ``sklearn.cluster.AgglomerativeClustering(n_clusters)
  .fit(X).labels_`` exactly, label numbering included, on seeded
  Gaussian blobs, ties from duplicate rows, one and all clusters.  The
  test imports scikit-learn; the port does not.
* ``MarginClusteringSampler.query`` picks what the JAX sampler picks on
  the same network weights and pool: over two rounds (the second reuses
  the cached assignment) and with ``subset_unlabeled`` (re-drawn and
  re-clustered every round, the rng consumed alike).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
from sklearn.cluster import AgglomerativeClustering

from active_learning_tpu_torch.strategies import clustering

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_acquisition import _sampler_pair  # noqa: E402


def _blobs(seed, n, d, centers):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(centers, d)) * 4.0
    return (means[rng.integers(0, centers, n)]
            + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("n,d,k,seed", [(60, 8, 20, 0), (150, 32, 20, 1),
                                        (40, 3, 5, 2), (25, 16, 25, 3),
                                        (30, 4, 1, 4), (2, 5, 2, 5)])
def test_ward_labels_equal_sklearn(n, d, k, seed):
    x = _blobs(seed, n, d, 6)
    want = AgglomerativeClustering(n_clusters=k).fit(x).labels_
    np.testing.assert_array_equal(clustering.ward_labels(x, k), want)


def test_ward_labels_equal_sklearn_with_duplicate_rows():
    x = _blobs(6, 50, 6, 4)
    x[10:20] = x[3]
    x[30:33] = x[40]
    want = AgglomerativeClustering(n_clusters=20).fit(x).labels_
    np.testing.assert_array_equal(clustering.ward_labels(x, 20), want)


def test_hc_cut_refuses_more_clusters_than_rows():
    children = np.array([[0, 1], [2, 3]])
    with pytest.raises(ValueError, match="more clusters than samples"):
        clustering.hc_cut(4, children, 3)


@pytest.mark.parametrize("seed", [0, 1])
def test_query_matches_jax_over_two_rounds(seed):
    jstrat, strat = _sampler_pair("MarginClusteringSampler", seed=seed)
    for budget in (10, 7):
        want, wcost = jstrat.query(budget)
        got, cost = strat.query(budget)
        np.testing.assert_array_equal(got, want)
        assert cost == wcost
        np.testing.assert_array_equal(strat.cluster_assignment,
                                      jstrat.cluster_assignment)
        jstrat.update(want, wcost)
        strat.update(got, cost)
    assert strat.rng.bit_generator.state == jstrat.rng.bit_generator.state


def test_subset_reclusters_every_round_as_jax_does():
    jstrat, strat = _sampler_pair("MarginClusteringSampler",
                                  subset_unlabeled=40)
    for budget in (6, 6):
        want, wcost = jstrat.query(budget)
        got, cost = strat.query(budget)
        np.testing.assert_array_equal(got, want)
        assert cost == wcost == budget
        jstrat.update(want, wcost)
        strat.update(got, cost)
    assert strat.rng.bit_generator.state == jstrat.rng.bit_generator.state
