"""The port's balancing pick and BalancingSampler against the JAX package,
on the CPU.

* ``balancing_pick_reference`` (kernel H's plain version) picks what
  JAX ``_balancing_pick`` picks on seeded Gaussian pools, with
  ``rare_empty``, ineligible rows, duplicate rows (ties to the lower
  index), a row on a majority centroid and NaN scores (the first NaN
  wins, as ``jnp.argmin`` rules on the installed JAX).  On the random
  pools the best two scores lie further apart than
  ``score_tolerance`` (the f32 bound two summation orders may differ
  by), which the test asserts, so an equal pick means something.
* ``BalancingSampler.query`` picks what the JAX sampler and a copy of
  the reference's host loop (``_balancing_oracle`` of
  ``tests/test_clustering_balancing.py``) pick, through both branches,
  on the same embeddings, labeled set and rng state; the rng ends in
  the same state.
* ``BalancingState`` on CPU tensors picks what a fresh
  ``balancing_pick_reference`` picks on tensors rebuilt from the same
  takes, over mixed sequences of takes and picks (runs of takes without
  a pick, as the random branch makes them, and a rarest class that
  starts empty), and refuses takes and masks it cannot hold.
* ``freeze_feature`` caches the embeddings.
"""

from __future__ import annotations

import copy
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_learning_tpu.strategies.balancing import \
    _balancing_pick as jax_balancing_pick

from active_learning_tpu_torch.ops import balancing as bal

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_clustering_balancing import _balancing_oracle  # noqa: E402
from test_torch_acquisition import N_CLASSES, _sampler_pair  # noqa: E402


def _pool(seed, n, d, c, n_maj):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    centers = rng.normal(size=(c, d)).astype(np.float32)
    eligible = rng.random(n) > 0.3
    maj = np.zeros(c, dtype=bool)
    maj[rng.choice(c, n_maj, replace=False)] = True
    rarest = int(np.flatnonzero(~maj)[0])
    return emb, eligible, centers, maj, rarest


def _both(emb, eligible, centers, maj, rarest, rare_empty):
    want = int(jax_balancing_pick(
        jnp.asarray(emb), jnp.asarray(eligible), jnp.asarray(centers),
        jnp.asarray(maj), jnp.int32(rarest), jnp.bool_(rare_empty)))
    t = [torch.from_numpy(a) for a in (emb, eligible, centers, maj)]
    got = int(bal.balancing_pick_reference(*t, rarest, rare_empty))
    return got, want, t


def _plain_scores(emb, eligible, centers, maj, rarest, rare_empty):
    e, c = emb.astype(np.float64), centers.astype(np.float64)
    d_rare = ((e - c[rarest]) ** 2).sum(1)
    if rare_empty:
        d_rare = np.ones_like(d_rare)
    d_all = (e ** 2).sum(1)[:, None] + (c ** 2).sum(1)[None] - 2 * e @ c.T
    norm = np.where(maj[None], d_all, -np.inf).max(1)
    return np.where(eligible, d_rare / norm, np.inf)


@pytest.mark.parametrize("n,d,c,n_maj", [(200, 16, 4, 2), (1000, 64, 10, 4),
                                         (513, 33, 40, 17)])
@pytest.mark.parametrize("rare_empty", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_pick_matches_jax(n, d, c, n_maj, rare_empty, seed):
    emb, eligible, centers, maj, rarest = _pool(seed, n, d, c, n_maj)
    got, want, t = _both(emb, eligible, centers, maj, rarest, rare_empty)
    assert got == want
    assert eligible[got]
    scores = _plain_scores(emb, eligible, centers, maj, rarest, rare_empty)
    best, second = np.sort(scores)[:2]
    tol = bal.score_tolerance(t[0], t[2], t[3], rarest, rare_empty).numpy()
    assert second - best > tol[np.argsort(scores)[:2]].sum()


def test_plain_pick_ties_go_to_the_lower_index():
    emb, eligible, centers, maj, rarest = _pool(3, 300, 16, 6, 3)
    eligible[:] = True
    scores = _plain_scores(emb, eligible, centers, maj, rarest, False)
    best = int(np.argmin(scores))
    emb[best + 7] = emb[best]
    emb[max(best - 5, 0):best] = emb[best]  # earlier copies win
    got, want, _ = _both(emb, eligible, centers, maj, rarest, False)
    assert got == want == max(best - 5, 0)
    eligible[max(best - 5, 0):best] = False
    got, want, _ = _both(emb, eligible, centers, maj, rarest, False)
    assert got == want == best


def test_plain_pick_rare_empty_and_a_row_on_a_majority_centroid():
    """With the rarest class empty every numerator is 1, so the pick is
    the row farthest from the majority centroids.  A row sitting on a
    majority centroid (when it is the only majority class) has a norm
    near 0 in the expanded form, possibly below it: the JAX formula's
    score, not a clamped one, is what both follow."""
    emb, eligible, centers, maj, rarest = _pool(4, 400, 12, 5, 1)
    eligible[:] = True
    m = int(np.flatnonzero(maj)[0])
    emb[10] = centers[m]
    for rare_empty in (False, True):
        got, want, _ = _both(emb, eligible, centers, maj, rarest, rare_empty)
        assert got == want


def test_plain_pick_nan_wins_as_in_jnp_argmin():
    assert int(jnp.argmin(jnp.asarray([3.0, np.nan, 1.0, np.nan]))) == 1
    emb, eligible, centers, maj, rarest = _pool(5, 64, 8, 4, 2)
    eligible[:] = True
    emb[9, 0] = np.nan
    emb[30, 3] = np.nan
    got, want, _ = _both(emb, eligible, centers, maj, rarest, False)
    assert got == want == 9
    eligible[9] = False  # an ineligible NaN row scores +inf
    got, want, _ = _both(emb, eligible, centers, maj, rarest, False)
    assert got == want == 30


def test_plain_pick_with_nothing_eligible_is_row_zero():
    emb, eligible, centers, maj, rarest = _pool(6, 32, 8, 4, 2)
    eligible[:] = False
    got, want, _ = _both(emb, eligible, centers, maj, rarest, False)
    assert got == want == 0


def test_wrapper_checks_its_arguments():
    emb, eligible, centers, maj, rarest = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in _pool(7, 16, 4, 3, 1))
    before = bal.launches
    got = bal.balancing_pick(emb, eligible, centers, maj, rarest, False)
    assert got.dtype == torch.int64 and got.ndim == 0
    assert bal.launches == before  # the CPU runs the plain version
    with pytest.raises(ValueError, match="rarest"):
        bal.balancing_pick(emb, eligible, centers, maj, 3, False)
    with pytest.raises(TypeError, match="float32"):
        bal.balancing_pick(emb.double(), eligible, centers, maj, 0, False)
    with pytest.raises(ValueError, match="eligible"):
        bal.balancing_pick(emb, eligible[:-1], centers, maj, 0, False)
    with pytest.raises(ValueError, match="maj"):
        bal.balancing_pick(emb, eligible, centers, maj.int(), 0, False)


# -- BalancingState --------------------------------------------------------------

@pytest.mark.parametrize("n,d,c", [(300, 16, 5), (500, 33, 12),
                                   (257, 8, 40)])
@pytest.mark.parametrize("seed", [0, 1])
def test_state_picks_what_the_plain_version_picks_on_rebuilt_tensors(
        n, d, c, seed):
    """A loop of the sampler's shape on a CPU state: every step takes a
    row (after a pick, the picked row; else a random eligible one, in
    runs), with its class's center moved; every pick is held against
    ``balancing_pick_reference`` on tensors rebuilt from the takes alone.
    Class 0 has no labeled row until its first take (rare_empty)."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    eligible = rng.random(n) > 0.2
    centers = rng.normal(size=(c, d)).astype(np.float32)
    counts = rng.integers(1, 20, size=c)
    counts[0] = 0
    state = bal.BalancingState(torch.from_numpy(emb.copy()),
                               torch.from_numpy(eligible.copy()),
                               torch.from_numpy(centers.copy()))
    picks = 0
    for step in range(60):
        if step % 7 < 4:  # a balancing pick, then its take
            maj = counts > counts.mean()
            rarest = int(np.argmin(counts))
            got = state.pick(maj, rarest, counts[rarest] == 0)
            want = int(bal.balancing_pick_reference(
                torch.from_numpy(emb), torch.from_numpy(eligible),
                torch.from_numpy(centers), torch.from_numpy(maj), rarest,
                bool(counts[rarest] == 0)))
            assert got == want
            row = got
            picks += 1
        else:  # a random pick: a take with no pick
            row = int(rng.choice(np.flatnonzero(eligible)))
        cls = int(rng.integers(c))
        center = rng.normal(size=d).astype(np.float32)
        eligible[row] = False
        centers[cls] = center
        counts[cls] += 1
        state.take(row, cls, center)
    assert picks > 30
    state.pick(counts > counts.mean(), int(np.argmin(counts)), False)
    np.testing.assert_array_equal(state.eligible.numpy(), eligible)
    np.testing.assert_array_equal(state.centers.numpy(), centers)


def test_state_counts_no_launch_on_the_cpu_and_refuses_bad_input():
    emb, eligible, centers, maj, rarest = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in _pool(8, 64, 8, 4, 2))
    before = (bal.launches, bal.kernel_launches)
    state = bal.BalancingState(emb, eligible.clone(), centers.clone())
    state.take(3, 1, np.zeros(8, dtype=np.float32))
    state.pick(maj.numpy(), rarest, False)
    assert (bal.launches, bal.kernel_launches) == before
    with pytest.raises(ValueError, match="out of range"):
        state.take(64, 0, np.zeros(8, dtype=np.float32))
    with pytest.raises(ValueError, match="out of range"):
        state.take(0, 4, np.zeros(8, dtype=np.float32))
    with pytest.raises(ValueError, match="center row"):
        state.take(0, 0, np.zeros(7, dtype=np.float32))
    with pytest.raises(ValueError, match="maj"):
        state.pick(np.zeros(3, dtype=bool), 0, False)
    with pytest.raises(ValueError, match="rarest"):
        state.pick(maj.numpy(), 4, False)
    with pytest.raises(TypeError, match="float32"):
        bal.BalancingState(emb.double(), eligible, centers)


def test_state_on_the_cpu_takes_the_plain_version_after_close():
    """The plain version is chosen by the tensors' device alone: a CPU
    state still picks once closed (there is no pinned block to free)."""
    emb, eligible, centers, maj, rarest = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in _pool(9, 48, 8, 5, 2))
    state = bal.BalancingState(emb, eligible.clone(), centers.clone())
    state.close()
    want = int(bal.balancing_pick_reference(emb, eligible, centers, maj,
                                            rarest, False))
    assert state.pick(maj.numpy(), rarest, False) == want


# -- the sampler ---------------------------------------------------------------

def _embeddings(targets, seed, d=16):
    """Class-structured seeded embeddings: a mean per class plus noise."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(N_CLASSES, d)) * 2.0
    return (means[targets] + rng.normal(size=(len(targets), d))
            ).astype(np.float32)


def _skewed_pair(seed, **cfg_kw):
    """Both samplers over one pool, classes 1..3 with 12 labeled rows
    each and class 0 none, on the same injected embeddings."""
    jstrat, strat = _sampler_pair("BalancingSampler", seed=seed, n_init=0,
                                  **cfg_kw)
    targets = strat.al_set.targets[: len(strat.al_set)]
    avail = strat.available_query_mask()
    skew = np.concatenate([np.flatnonzero((targets == c) & avail)[:12]
                           for c in range(1, N_CLASSES)])
    jstrat.update(skew, len(skew))
    strat.update(skew, len(skew))
    emb = _embeddings(targets, seed)
    jstrat._all_embeddings = lambda: emb
    strat._all_embeddings = lambda: emb
    return jstrat, strat, emb, targets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_query_matches_jax_and_the_reference_loop(seed):
    """Counts [0, 12, 12, 12], budget 16 (the oracle test's setting): the
    threshold starts at 12, so the first picks are random and the
    later ones balancing, for as long as the counts stay skewed."""
    jstrat, strat, emb, targets = _skewed_pair(seed)
    expected = _balancing_oracle(
        emb, targets, strat.available_query_mask(),
        strat.already_labeled_mask(), 16, copy.deepcopy(strat.rng),
        N_CLASSES)
    want, wcost = jstrat.query(16)
    got, cost = strat.query(16)
    assert cost == wcost == 16
    np.testing.assert_array_equal(want, expected)
    np.testing.assert_array_equal(got, expected)
    assert 0 < strat.last_balancing_picks < 16  # both branches
    assert strat.rng.bit_generator.state == jstrat.rng.bit_generator.state
    # A second query from the updated state (counts now near balance).
    jstrat.update(want, wcost)
    strat.update(got, cost)
    want, _ = jstrat.query(10)
    got, _ = strat.query(10)
    np.testing.assert_array_equal(got, want)


def test_freeze_feature_caches_the_embeddings():
    _, strat = _sampler_pair("BalancingSampler", freeze_feature=True)
    calls = {"n": 0}
    orig = strat.collect_scores

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    strat.collect_scores = counting
    got, cost = strat.query(4)
    strat.update(got, cost)
    cached = strat._saved_embeddings
    strat.query(4)
    assert calls["n"] == 1 and strat._saved_embeddings is cached
    assert cached.shape == (len(strat.al_set), strat.model.embed_dim)
    plain = _sampler_pair("BalancingSampler")[1]
    plain.query(4)
    assert plain._saved_embeddings is None
