"""The port's greedy k-center (``strategies/kcenter.py`` on kernel E's
plain versions) against the JAX package's ``kcenter_greedy`` and the
reference loop ``tests/test_kcenter.py::oracle_kcenter``, on the CPU.

Picks are identical in every case: q in {1, 2, 8}, one factor and two,
an empty labeled set (the minimax seed), a budget that takes the whole
pool, pool sizes on both sides of a bucket edge, and the randomized D²
mode over several seeds (the same ``np.random.default_rng`` feeds both
packages; the port draws through ``utils/threefry.py``).  Each pick's
recorded distance (``LAST_PICK_DISTS``) is within 1e-5 relative of the
JAX package's: the same float32 distances summed in another order.
"""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_learning_tpu.strategies import kcenter as jk
from active_learning_tpu.strategies import scoring as jax_scoring

from active_learning_tpu_torch.pool import bucket_size
from active_learning_tpu_torch.strategies import kcenter as pk
from active_learning_tpu_torch.strategies import scoring

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_kcenter import oracle_kcenter  # noqa: E402


def _pool(seed, n, dims, n_labeled):
    rng = np.random.default_rng(seed)
    factors = tuple(rng.normal(size=(n, d)).astype(np.float32)
                    for d in dims)
    labeled = np.zeros(n, dtype=bool)
    labeled[rng.choice(n, n_labeled, replace=False)] = True
    return factors, labeled


def _outer(factors):
    if len(factors) == 1:
        return factors[0]
    a, e = factors
    return np.einsum("nc,nd->ncd", a, e).reshape(len(a), -1)


def _both(factors, labeled, budget, seed, **kw):
    got = pk.kcenter_greedy(factors, labeled, budget,
                            rng=np.random.default_rng(seed), device="cpu",
                            **kw)
    got_d = pk.LAST_PICK_DISTS
    want = jk.kcenter_greedy(factors, labeled, budget,
                             rng=np.random.default_rng(seed), **kw)
    return got, got_d, want, jk.LAST_PICK_DISTS


def _close_dists(got, want):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5)


@pytest.mark.parametrize("q", [1, 2, 8])
@pytest.mark.parametrize("dims", [(6,), (5, 7)], ids=["one", "two"])
def test_deterministic_picks_match_jax_and_oracle(q, dims):
    factors, labeled = _pool(11, 70, dims, 9)
    got, got_d, want, want_d = _both(factors, labeled, 13, 1, batch_q=q)
    np.testing.assert_array_equal(got, oracle_kcenter(_outer(factors),
                                                      labeled, 13))
    np.testing.assert_array_equal(got, want)
    _close_dists(got_d, want_d)


@pytest.mark.parametrize("q", [1, 8])
@pytest.mark.parametrize("dims", [(4,), (3, 5)], ids=["one", "two"])
def test_empty_labeled_takes_the_minimax_seed(q, dims):
    factors, labeled = _pool(12, 40, dims, 0)
    got, got_d, want, want_d = _both(factors, labeled, 9, 2, batch_q=q)
    np.testing.assert_array_equal(got, oracle_kcenter(_outer(factors),
                                                      labeled, 9))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got_d[0]) and not np.isnan(got_d[1:]).any()
    _close_dists(got_d, want_d)


@pytest.mark.parametrize("q", [1, 2, 8])
def test_budget_exhausts_the_pool(q):
    factors, labeled = _pool(14, 20, (3,), 5)
    got, _, want, _ = _both(factors, labeled, 15, 4, batch_q=q)
    assert np.unique(got).size == 15 and not labeled[got].any()
    np.testing.assert_array_equal(got, oracle_kcenter(factors[0], labeled,
                                                      15))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [250, 260])
def test_pool_sizes_on_both_sides_of_a_bucket_edge(n):
    assert bucket_size(250) == 256 and bucket_size(260) == 512
    factors, labeled = _pool(15, n, (8,), 30)
    for q in (1, 8):
        got, got_d, want, want_d = _both(factors, labeled, 20, 5, batch_q=q)
        np.testing.assert_array_equal(got, oracle_kcenter(factors[0],
                                                          labeled, 20))
        np.testing.assert_array_equal(got, want)
        _close_dists(got_d, want_d)
    got, got_d, want, want_d = _both(factors, labeled, 20, 5,
                                     randomize=True)
    np.testing.assert_array_equal(got, want)
    _close_dists(got_d, want_d)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dims,n_labeled", [((6,), 10), ((4, 16), 10),
                                            ((4, 16), 0)],
                         ids=["one", "two", "two-empty"])
def test_randomized_picks_match_jax(seed, dims, n_labeled):
    factors, labeled = _pool(100 + seed, 300, dims, n_labeled)
    got, got_d, want, want_d = _both(factors, labeled, 25, seed,
                                     randomize=True)
    np.testing.assert_array_equal(got, want)
    assert np.unique(got).size == 25 and not labeled[got].any()
    _close_dists(got_d, want_d)


def test_randomized_uniform_fallback_matches_jax():
    """Every unlabeled row duplicates a labeled one: all D² weights are
    0 and the draw falls back to uniform over the selectable rows.
    Small integers keep every product and sum exact, so the distances
    are exactly 0 in both packages."""
    rng = np.random.default_rng(7)
    base = rng.integers(-2, 3, size=(10, 4)).astype(np.float32)
    emb = np.concatenate([base, base, base])
    labeled = np.zeros(30, dtype=bool)
    labeled[:10] = True
    got, got_d, want, want_d = _both((emb,), labeled, 4, 3, randomize=True)
    np.testing.assert_array_equal(got, want)
    assert (got_d == 0).all() and (want_d == 0).all()


def fold_bound(sqn: np.ndarray, depth: int) -> np.ndarray:
    """How far two float32 evaluations of ``sqn_i + sqn_c - 2 g_i.g_c``
    in other summation orders may differ, per row: 2 * depth * eps *
    (sqn_i + max sqn_c), ``depth`` the summed feature count of the
    factors.  It matters where the distance cancels to ~0 (a row against
    itself)."""
    eps = np.finfo(np.float32).eps
    return 2 * depth * eps * (sqn + sqn.max())


def test_min_sq_dist_and_fold_helpers_match_jax():
    factors, labeled = _pool(16, 90, (5, 7), 0)
    labeled_idxs = np.random.default_rng(0).choice(90, 33, replace=False)
    jf = tuple(jnp.asarray(f) for f in factors)
    tf = tuple(torch.from_numpy(f) for f in factors)
    jsqn, tsqn = jk.self_sq_norms(jf), pk.self_sq_norms(tf)
    np.testing.assert_allclose(tsqn.numpy(), np.asarray(jsqn), rtol=1e-6)
    want = np.asarray(jk.min_sq_dist_to(jf, jsqn, labeled_idxs,
                                        chunk_size=7))
    got = pk.min_sq_dist_to(tf, tsqn, labeled_idxs, chunk_size=7)
    bound = fold_bound(np.asarray(jsqn), 12)
    assert (np.abs(got.numpy() - want) <= bound).all()
    np.testing.assert_allclose(pk.dots_to(tf, 3).numpy(),
                               np.asarray(jk.dots_to(jf, 3)), rtol=1e-5,
                               atol=1e-5)
    idx = np.array([1, 4, 9])
    np.testing.assert_allclose(
        pk.dots_between(tf, torch.from_numpy(idx)).numpy(),
        np.asarray(jk.dots_between(jf, jnp.asarray(idx))), rtol=1e-5,
        atol=1e-5)
    start = np.full(90, np.inf, np.float32)
    want = np.asarray(jax_scoring.batched_min_dist_update(
        jf, jsqn, jnp.asarray(start), jnp.asarray(idx)))
    got = scoring.batched_min_dist_update(
        tf, tsqn, torch.from_numpy(start.copy()), torch.from_numpy(idx))
    assert (np.abs(got.numpy() - want) <= bound).all()


@pytest.mark.parametrize("n_in,n_out", [(10, 10), (1000, 16), (512, 51),
                                        (2048, 32), (7, 3)])
def test_adaptive_avg_pool_matrix_is_jax_bit_for_bit(n_in, n_out):
    np.testing.assert_array_equal(pk.adaptive_avg_pool_matrix(n_in, n_out),
                                  jk.adaptive_avg_pool_matrix(n_in, n_out))


def _int_pool(seed, n, dims, n_labeled):
    """Small-integer factors: every product and sum is exact in float32
    whatever its order, so the two packages' distances agree bit for bit
    and ties (equal distances) are common."""
    rng = np.random.default_rng(seed)
    factors = tuple(rng.integers(-3, 4, size=(n, d)).astype(np.float32)
                    for d in dims)
    labeled = rng.choice(n, n_labeled, replace=False)
    return factors, labeled


@pytest.mark.parametrize("n", [250, 260], ids=["below-edge", "above-edge"])
@pytest.mark.parametrize("dims", [(6,), (3, 5)], ids=["one", "two"])
@pytest.mark.parametrize("q", [1, 2, 8])
def test_batched_pass_matches_jax_scan_bit_for_bit(q, dims, n):
    """The batched scan on kernel E's plain ``batch_pass`` (re-check and
    pick count in the scan state, the host reading the count once a
    round) against the JAX package's ``_kcenter_scan_batched`` on the
    same padded pool: picks and distances bit for bit."""
    factors, labeled = _int_pool(40 + q + n, n, dims, 30)
    n_pad = bucket_size(n, floor=pk.POOL_BUCKET_FLOOR)
    padded = [np.pad(f, ((0, n_pad - n), (0, 0))) for f in factors]
    sel = np.zeros(n_pad, np.float32)
    sel[:n] = 1.0
    sel[labeled] = 0.0
    budget = 40
    jf = tuple(jnp.asarray(f) for f in padded)
    jsqn = jk.self_sq_norms(jf)
    want_p, want_d = jk._kcenter_scan_batched(
        jf, jsqn, jk.min_sq_dist_to(jf, jsqn, labeled), jnp.asarray(sel),
        budget=budget, q=q)
    tf = tuple(torch.from_numpy(f) for f in padded)
    tsqn = pk.self_sq_norms(tf)
    got_p, got_d = pk._kcenter_scan_batched(
        tf, tsqn, pk.min_sq_dist_to(tf, tsqn, labeled),
        torch.from_numpy(sel.copy()), budget, q)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_d.numpy().view(np.uint32),
                                  np.asarray(want_d).view(np.uint32))
    assert pk.LAST_SCAN["host_syncs"] <= pk.max_host_syncs(budget, q)


@pytest.mark.parametrize("budget,q", [(13, 8), (120, 8), (120, 2), (1, 8)])
def test_host_syncs_stay_under_the_stated_count(budget, q):
    """The batched scan reads the pick count once a round of passes:
    never more than ``max_host_syncs(budget, q)`` times, fewer times
    than it passes over the pool once a pass accepts several picks, and
    its passes are the ones it needed (each accepts at least one)."""
    factors, labeled = _pool(17, 400, (8,), 20)
    got = pk.kcenter_greedy(factors, labeled, budget, batch_q=q,
                            device="cpu")
    np.testing.assert_array_equal(got, oracle_kcenter(factors[0], labeled,
                                                      budget))
    scan = pk.LAST_SCAN
    passes = scan["pool_passes"] - 1  # less the labeled set's min_fold
    assert scan["host_syncs"] <= pk.max_host_syncs(budget, min(q, budget))
    assert passes <= budget
    if budget >= 4 * q:
        assert scan["host_syncs"] < passes / 2
    assert pk.max_host_syncs(10000, 8) < 100


NONFINITE = {"nan": np.nan, "+inf": np.inf, "-inf": -np.inf}


def _nonfinite_pool(dims, kind, where):
    """A 64-row pool, 9 rows labeled, with feature 2 of the fourth
    unlabeled (or labeled) row of the first factor set to ``kind``."""
    factors, labeled = _pool(1, 64, dims, 9)
    rows = np.flatnonzero(labeled if where == "labeled" else ~labeled)
    factors[0][rows[3], 2] = NONFINITE[kind]
    return factors, labeled, int(rows[3])


@pytest.mark.parametrize("where", ["unlabeled", "labeled"])
@pytest.mark.parametrize("kind", list(NONFINITE))
@pytest.mark.parametrize("mode", ["q1", "q8", "randomized"])
@pytest.mark.parametrize("dims", [(6,), (5, 7)], ids=["one", "two"])
def test_picks_match_jax_on_nonfinite_pools(dims, mode, kind, where):
    """A row holding a NaN or a ±inf feature gets a NaN min distance (a
    NaN feature, or inf - inf in the distance).  The deterministic scan
    picks it first (``jnp.argmax``'s first NaN; an unlabeled row) and then,
    every distance being NaN after a NaN center, the lowest selectable
    rows.  The randomized draw's weights hold a NaN (a non-selectable
    row's too, NaN * 0), so their sum is NaN and every draw is uniform
    over the selectable rows.  Picks equal the JAX package's and the
    recorded distances are NaN at the same picks.

    The batched scan (q = 8) is held to the JAX package's q = 1 scan,
    which its ``_kcenter_scan_batched`` promises to equal pick for pick.
    On a ±inf row its own batched scan does not, on the CPU: x86 gives
    inf - inf a NaN with the sign bit set, and ``lax.top_k`` ranks by
    float32's total order, where that NaN lies below -inf, while
    ``jnp.argmax`` ranks every NaN first.  On a NaN row (a positive NaN)
    the two scans agree, and the port equals both."""
    factors, labeled, row = _nonfinite_pool(dims, kind, where)
    kw = ({"randomize": True} if mode == "randomized"
          else {"batch_q": int(mode[1:])})
    got, got_d, want, want_d = _both(factors, labeled, 10, 3, **kw)
    if mode == "q8":
        want_q8 = want
        want = jk.kcenter_greedy(factors, labeled, 10,
                                 rng=np.random.default_rng(3), batch_q=1)
        want_d = jk.LAST_PICK_DISTS
        if kind == "nan":
            np.testing.assert_array_equal(got, want_q8)
    np.testing.assert_array_equal(got, want)
    _close_dists(got_d, want_d)
    assert np.unique(got).size == 10 and not labeled[got].any()
    if mode != "randomized":
        assert np.isnan(got_d).any()
        if where == "unlabeled":
            assert got[0] == row


@pytest.mark.parametrize("dims", [(6,), (5, 7)], ids=["one", "two"])
def test_fold_propagates_nan_as_jax(dims):
    """The fold's plain version (``fold_reference``, and the port's
    ``batched_min_dist_update`` over it) against the JAX package's
    ``batched_min_dist_update`` on rows holding a NaN, a +inf and a -inf
    feature, with centers among them and a NaN already in min_dist: NaN
    and ±inf at the same rows (``jnp.minimum`` of ``jnp.min`` propagates
    NaN; so do ``torch.minimum`` and ``Tensor.min``), finite rows within
    the fold bound."""
    from active_learning_tpu_torch.ops import kcenter as kc

    factors, _ = _pool(18, 40, dims, 0)
    for r, v in ((3, np.nan), (8, np.inf), (12, -np.inf)):
        factors[0][r, 1] = v
    start = np.abs(np.random.default_rng(2).normal(size=40)).astype(
        np.float32) * 50
    start[20] = np.nan
    start[21] = np.inf
    jf = tuple(jnp.asarray(f) for f in factors)
    tf = tuple(torch.from_numpy(f) for f in factors)
    jsqn, tsqn = jk.self_sq_norms(jf), pk.self_sq_norms(tf)
    bound = fold_bound(np.nan_to_num(np.asarray(jsqn), posinf=0.0),
                       sum(dims))
    for centers in ([1, 5], [3, 9], [8], [12, 30], [3, 8, 12]):
        idx = np.array(centers)
        want = np.asarray(jax_scoring.batched_min_dist_update(
            jf, jsqn, jnp.asarray(start), jnp.asarray(idx)))
        got = torch.from_numpy(start.copy())
        kc.fold_reference(tf, tsqn, got, torch.from_numpy(idx))
        via = scoring.batched_min_dist_update(
            tf, tsqn, torch.from_numpy(start.copy()), torch.from_numpy(idx))
        for g in (got.numpy(), via.numpy()):
            for f in (np.isnan, np.isposinf, np.isneginf):
                np.testing.assert_array_equal(f(g), f(want), str(centers))
            fin = np.isfinite(want)
            assert (np.abs(g[fin] - want[fin]) <= bound[fin]).all()
        assert np.isnan(want[20]) and np.isnan(want[3])
