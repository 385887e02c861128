"""The port's acquisition path against the JAX package, on the CPU: kernel
F's and G's plain versions (``boundary_radii``, ``head_pair_norms``,
BADGE factors), the mase and badge scoring steps on one small SSLResNet
in both packages, and the six geometry samplers' ``query``.

Tolerances, as the JAX package's own tests state them
(``tests/test_samplers.py``): radii within 1e-4 relative of the JAX
function on the same inputs, +inf at the same places; pair norms within
1e-6 relative; the near-duplicate head case within 1e-3 relative of a
float64 oracle.  Through the two networks (the same float32 weights,
each framework's own convolution order, ~1e-6 apart): predictions
equal, radii within 1e-4 relative plus 1e-5 of the batch's largest
finite radius, BADGE factors within 1e-4 relative and 1e-5 absolute.
Sampler picks are identical to the JAX samplers' on the same weights,
pool masks and seed.
"""

from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_learning_tpu.config import ExperimentConfig as JaxExperimentConfig
from active_learning_tpu.config import LoaderConfig as JaxLoaderConfig
from active_learning_tpu.config import TrainConfig as JaxTrainConfig
from active_learning_tpu.data.core import ViewSpec as JaxViewSpec
from active_learning_tpu.data.synthetic import SYNTH_NORM as JAX_SYNTH_NORM
from active_learning_tpu.data.synthetic import \
    get_data_synthetic as jax_get_data
from active_learning_tpu.models import resnet as jax_resnet
from active_learning_tpu.parallel import mesh as mesh_lib
from active_learning_tpu.pool import PoolState as JaxPoolState
from active_learning_tpu.strategies import get_strategy as jax_get_strategy
from active_learning_tpu.strategies import scoring as jax_scoring
from active_learning_tpu.train.trainer import Trainer as JaxTrainer

from active_learning_tpu_torch.config import (ExperimentConfig, LoaderConfig,
                                              TrainConfig)
from active_learning_tpu_torch.data.core import SYNTH_NORM, ViewSpec
from active_learning_tpu_torch.data.synthetic import get_data_synthetic
from active_learning_tpu_torch.models import resnet
from active_learning_tpu_torch.models.weights import load_flax_variables
from active_learning_tpu_torch.ops import badge as badge_ops
from active_learning_tpu_torch.ops import boundary_radii as br
from active_learning_tpu_torch.pool import PoolState
from active_learning_tpu_torch.strategies import get_strategy, scoring
from active_learning_tpu_torch.train.trainer import Trainer

# -- kernel F's plain versions against the JAX functions ----------------------


def _head(seed, b, d, c, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, d)).astype(np.float32),
            (rng.normal(size=(d, c)) * scale).astype(np.float32),
            rng.normal(size=(c,)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,d,c", [(16, 4, 3), (32, 64, 10), (9, 37, 1000)])
def test_boundary_radii_match_jax(b, d, c):
    emb, kernel, bias = _head(b * c, b, d, c)
    want = jax_scoring.boundary_radii(jnp.asarray(emb), jnp.asarray(kernel),
                                      jnp.asarray(bias))
    got = br.boundary_radii(*_t(emb, kernel, bias))
    np.testing.assert_array_equal(got["pred"].numpy(),
                                  np.asarray(want["pred"]))
    wr, gr = np.asarray(want["radii"]), got["radii"].numpy()
    np.testing.assert_array_equal(np.isinf(gr), np.isinf(wr))
    fin = np.isfinite(wr)
    np.testing.assert_allclose(gr[fin], wr[fin], rtol=1e-4)
    np.testing.assert_allclose(got["min_margin"].numpy(), wr.min(axis=1),
                               rtol=1e-4)


def _assert_same_nonfinite(got, want, what):
    """NaN and ±inf at the same entries; finite entries within 1e-4."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want), what)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want), what)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, err_msg=what)


@pytest.mark.parametrize("where", ["embedding", "head"])
def test_boundary_radii_match_jax_on_nonfinite_inputs(where):
    """Embedding rows with a NaN, a +inf, a -inf, and a +inf beside a
    -inf (or a NaN in one head column): pred is the first NaN logit or
    the first of the largest, as jnp.argmax; radii NaN and ±inf where the
    JAX function has them; min_margin NaN where a radius is, as make_mase_step's
    jnp.min."""
    emb, kernel, bias = _head(11, 10, 24, 13)
    if where == "embedding":
        for r, vals in enumerate([(np.nan,), (np.inf,), (-np.inf,),
                                  (np.inf, -np.inf), (np.nan, np.inf)]):
            emb[r, [3, 17][:len(vals)]] = vals
    else:
        kernel[5, 7] = np.nan
    want = jax_scoring.boundary_radii(jnp.asarray(emb), jnp.asarray(kernel),
                                      jnp.asarray(bias))
    wr = np.asarray(want["radii"])
    got = br.boundary_radii(*_t(emb, kernel, bias))
    np.testing.assert_array_equal(got["pred"].numpy(),
                                  np.asarray(want["pred"]))
    _assert_same_nonfinite(got["radii"].numpy(), wr, "radii")
    _assert_same_nonfinite(got["min_margin"].numpy(), np.min(wr, axis=1),
                           "min_margin")
    _assert_same_nonfinite(
        br.head_pair_norms(torch.from_numpy(kernel)).numpy(),
        np.asarray(jax_scoring.head_pair_norms(jnp.asarray(kernel))),
        "pair norms")
    if where == "embedding":
        assert got["pred"][0].item() == 0
        assert torch.isnan(got["min_margin"][0])
    else:
        assert (got["pred"].numpy() == 7).all()


@pytest.mark.parametrize("d,c", [(8, 5), (64, 10), (33, 200)])
def test_head_pair_norms_match_jax(d, c):
    _, kernel, _ = _head(d + c, 1, d, c)
    want = np.asarray(jax_scoring.head_pair_norms(jnp.asarray(kernel)))
    got = br.head_pair_norms(torch.from_numpy(kernel)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (np.diag(got) == 0.0).all()


def test_near_duplicate_head_columns_match_float64_oracle():
    """The case the difference-first numerator and the explicit pair
    norms exist for (``tests/test_samplers.py``, same construction):
    ||w_0 - w_1|| = 1e-3 against ||w|| ~ 80."""
    rng = np.random.default_rng(4)
    d, c = 64, 6
    kernel = rng.normal(size=(d, c)).astype(np.float32) * 10.0
    kernel[:, 1] = kernel[:, 0]
    kernel[0, 1] += 1e-3
    bias = np.zeros(c, dtype=np.float32)
    emb = rng.normal(size=(4, d)).astype(np.float32)
    radii = br.boundary_radii(*_t(emb, kernel, bias))["radii"].numpy()
    k64, e64 = kernel.astype(np.float64), emb.astype(np.float64)
    preds = (e64 @ k64).argmax(axis=1)
    for i in range(4):
        for j in range(c):
            if j == preds[i]:
                assert np.isinf(radii[i, j])
                continue
            dw = k64[:, preds[i]] - k64[:, j]
            expected = (e64[i] @ dw) / np.linalg.norm(dw)
            np.testing.assert_allclose(radii[i, j], expected, rtol=1e-3,
                                       err_msg=f"row {i} class {j}")


def test_boundary_self_check():
    """Moving an embedding by its smallest radius along the unit normal
    of that boundary lands it on the boundary (the reference's runtime
    assert, mase_sampler.py:85-90)."""
    emb, kernel, bias = _head(1, 32, 6, 5)
    out = br.boundary_radii(*_t(emb, kernel, bias))
    radii, preds = out["radii"].numpy(), out["pred"].numpy()
    j_star = np.argmin(radii, axis=1)
    w = kernel.T
    delta_w = w[preds] - w[j_star]
    unit = delta_w / np.linalg.norm(delta_w, axis=1, keepdims=True)
    moved = emb - radii[np.arange(32), j_star][:, None] * unit
    top2 = np.sort(moved @ kernel + bias, axis=1)[:, -2:]
    assert np.abs(top2[:, 1] - top2[:, 0]).mean() < 1e-4


# -- the scoring steps on one network in both packages ------------------------


def _resnet_pair(num_classes, seed=0):
    """A (1, 1)-stage BasicBlock SSLResNet with the CIFAR stem in both
    packages (float32): the JAX model's init with batch statistics
    redrawn from a numpy seed, carried into the port."""
    jmodel = jax_resnet.SSLClassifier(
        stage_sizes=(1, 1), block_cls=jax_resnet.BasicBlock,
        num_classes=num_classes, cifar_stem=True, dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(seed), np.zeros((1, 8, 8, 3), np.float32),
        train=False))
    rng = np.random.default_rng(seed + 1)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.normal(size=v.shape) * 0.2).astype(np.float32)
        if p[-1].key == "mean" else
        rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if p[-1].key == "var" else
        (rng.normal(size=v.shape) * 0.05).astype(np.float32)
        if p[-2].key == "linear" else v, variables)
    model = resnet.SSLClassifier((1, 1), resnet.BasicBlock, num_classes,
                                 cifar_stem=True, dtype=torch.float32)
    model = model.to(memory_format=torch.channels_last)
    load_flax_variables(model, variables)
    model.eval()
    return jmodel, variables, model


def _rows(n, seed=9):
    return np.random.default_rng(seed).integers(0, 256, (n, 8, 8, 3),
                                                dtype=np.uint8)


JAX_VIEW = JaxViewSpec(JAX_SYNTH_NORM, augment=False)
VIEW = ViewSpec(SYNTH_NORM, augment=False)


@pytest.mark.parametrize("num_classes", [10, 1000])
def test_mase_step_matches_jax(num_classes):
    jmodel, variables, model = _resnet_pair(num_classes)
    rows = _rows(12)
    want = jax_scoring.make_mase_step(jmodel, JAX_VIEW)(variables,
                                                        {"image": rows})
    step = scoring.make_mase_step(VIEW)
    got = step(model, {"image": torch.from_numpy(rows)})
    np.testing.assert_array_equal(got["pred"].numpy(),
                                  np.asarray(want["pred"]))
    wr, gr = np.asarray(want["radii"]), got["radii"].numpy()
    np.testing.assert_array_equal(np.isinf(gr), np.isinf(wr))
    fin = np.isfinite(wr)
    atol = 1e-5 * np.abs(wr[fin]).max()
    np.testing.assert_allclose(gr[fin], wr[fin], rtol=1e-4, atol=atol)
    np.testing.assert_allclose(got["min_margin"].numpy(),
                               np.asarray(want["min_margin"]), rtol=1e-4,
                               atol=atol)


def test_mase_step_computes_the_pair_norms_once_per_head(monkeypatch):
    _, _, model = _resnet_pair(10)
    rows = torch.from_numpy(_rows(4))
    calls = []
    real = scoring.head_pair_norms
    monkeypatch.setattr(scoring, "head_pair_norms",
                        lambda k: calls.append(1) or real(k))
    step = scoring.make_mase_step(VIEW)
    first = step(model, {"image": rows})["radii"]
    step(model, {"image": rows})
    assert len(calls) == 1
    # A new head: reset() (which a scoring pass calls first) empties the
    # cache, the norms are recomputed, and the radii equal a fresh step's.
    with torch.no_grad():
        model.linear.weight.mul_(2.0)
    step.reset()
    second = step(model, {"image": rows})["radii"]
    assert len(calls) == 2
    fresh = scoring.make_mase_step(VIEW)(model, {"image": rows})["radii"]
    assert len(calls) == 3
    torch.testing.assert_close(second, fresh, rtol=0, atol=0)
    assert not torch.allclose(second, first)


@pytest.mark.parametrize("pool_512", [False, True])
@pytest.mark.parametrize("num_classes", [10, 1000])
def test_badge_step_matches_jax(num_classes, pool_512):
    jmodel, variables, model = _resnet_pair(num_classes)
    rows = _rows(12)
    want = jax_scoring.make_badge_step(jmodel, JAX_VIEW, pool_512=pool_512)(
        variables, {"image": rows})
    got = scoring.make_badge_step(VIEW, pool_512=pool_512)(
        model, {"image": torch.from_numpy(rows)})
    for k in ("grad_a", "grad_e"):
        assert got[k].shape == tuple(want[k].shape)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("c,d", [(10, 512), (1000, 2048), (3, 40)])
def test_badge_factors_pool_edges_match_jax(c, d):
    """The pooling alone, at the CIFAR (10 x 51 bins, overlapping) and
    ImageNet (16 x 32) edges: the JAX step's arithmetic on the same
    logits and embeddings."""
    rng = np.random.default_rng(c)
    logits = rng.normal(size=(6, c)).astype(np.float32) * 3
    emb = rng.normal(size=(6, d)).astype(np.float32)
    from active_learning_tpu.strategies.kcenter import \
        adaptive_avg_pool_matrix
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    a = probs - np.eye(c, dtype=np.float32)[logits.argmax(1)]
    h = min(16, c)
    want_a = a @ adaptive_avg_pool_matrix(c, h)
    want_e = emb @ adaptive_avg_pool_matrix(d, int(512 / h))
    got = badge_ops.badge_factors(*_t(logits, emb), pool_512=True)
    np.testing.assert_allclose(got["grad_a"].numpy(), want_a, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got["grad_e"].numpy(), want_e, rtol=1e-4,
                               atol=1e-6)
    flat = badge_ops.badge_factors(*_t(logits, emb), pool_512=False)
    np.testing.assert_allclose(flat["grad_a"].numpy(), a, atol=1e-6)


def _nonfinite(x, seed):
    """Row r of ``x`` gets, by r % 8: nothing, a NaN, a +inf, a -inf, a
    +inf and a -inf, a NaN and a +inf, two +inf, or -inf throughout."""
    rng = np.random.default_rng(seed)
    x = x.copy()
    kinds = [(), (np.nan,), (np.inf,), (-np.inf,), (np.inf, -np.inf),
             (np.nan, np.inf), (np.inf, np.inf), None]
    for r in range(x.shape[0]):
        vals = kinds[r % len(kinds)]
        if vals is None:
            x[r] = -np.inf
        elif vals:
            x[r, rng.choice(x.shape[1], len(vals), replace=False)] = vals
    return x


@pytest.mark.parametrize("pool_512", [False, True])
@pytest.mark.parametrize("c,d", [(10, 512), (1000, 2048)])
def test_badge_factors_match_jax_on_nonfinite_inputs(c, d, pool_512):
    """Logit and embedding rows holding NaN, +inf and -inf, against the
    JAX step's arithmetic (``jax.nn.softmax``, ``jnp.argmax``, pooling as
    ``x @ M``): NaN and ±inf in the same entries, the finite ones within
    1e-4.  A NaN or +inf logit makes a row's ``a`` NaN throughout; a -inf
    logit is a probability of 0.  Pooled, a bin is NaN when its row holds
    a NaN or ±inf outside the bin (``x_k * 0``), and +inf when the row's
    only +inf lies inside it; C = 10 and D = 512 give overlapping bins."""
    from active_learning_tpu.strategies.kcenter import \
        adaptive_avg_pool_matrix

    rng = np.random.default_rng(c + d)
    b = 16
    logits = _nonfinite(rng.normal(size=(b, c)).astype(np.float32) * 3,
                        c)
    # The embedding's kinds run one row behind the logits', so that a
    # finite logit row meets each non-finite embedding kind.
    emb = np.roll(_nonfinite(rng.normal(size=(b, d)).astype(np.float32),
                             d), 1, axis=0)
    z = jnp.asarray(logits)
    a = jax.nn.softmax(z, axis=-1) - jax.nn.one_hot(
        jnp.argmax(z, axis=-1), c, dtype=jnp.float32)
    e = jnp.asarray(emb)
    if pool_512:
        h = min(16, c)
        a = a @ jnp.asarray(adaptive_avg_pool_matrix(c, h))
        e = e @ jnp.asarray(adaptive_avg_pool_matrix(d, int(512 / h)))
    got = badge_ops.badge_factors(*_t(logits, emb), pool_512=pool_512)
    for k, want in (("grad_a", np.asarray(a)), ("grad_e", np.asarray(e))):
        assert got[k].shape == want.shape
        _assert_same_nonfinite(got[k].numpy(), want, k)
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[k].numpy()[fin], want[fin],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert np.isnan(np.asarray(a)[1]).all()
    if pool_512:
        ge = got["grad_e"].numpy()
        # Row 2's embedding holds a NaN: every bin NaN.  Row 3's holds
        # one +inf: +inf in the bins that hold it (two where bins
        # overlap), NaN in the rest.
        inf3 = np.isposinf(ge[3])
        assert np.isnan(ge[2]).all() and 1 <= inf3.sum() <= 2
        assert np.isnan(ge[3][~inf3]).all()


def test_badge_factors_class_limit():
    """Kernel G keeps a logits row in 48 KB of shared memory beside its
    256 static bytes: C = MAX_CLASSES is taken (and its plain version
    matches JAX's softmax within the same 1e-6), one more is refused
    before any device is touched."""
    c = badge_ops.MAX_CLASSES
    assert c == (48 * 1024 - 256) // 4
    logits = np.random.default_rng(c).normal(size=(2, c)).astype(
        np.float32) * 3
    emb = np.zeros((2, 8), np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    a = probs - np.eye(c, dtype=np.float32)[logits.argmax(1)]
    got = badge_ops.badge_factors(*_t(logits, emb), pool_512=False)
    np.testing.assert_allclose(got["grad_a"].numpy(), a, atol=1e-6)
    wide = torch.zeros(2, c + 1)
    with pytest.raises(ValueError, match="C <="):
        badge_ops.badge_factors(wide, torch.zeros(2, 8), pool_512=False)


# -- the samplers --------------------------------------------------------------

N_TRAIN, N_CLASSES, INIT, EVAL = 96, 4, 12, 8


def _sampler_pair(name, seed=0, n_init=INIT, image_size=8, **cfg_kw):
    """The same sampler in both packages: the same synthetic pool, eval
    split, labeled set (``n_init`` random rows), network weights and rng
    seed."""
    jmodel, variables, model = _resnet_pair(N_CLASSES, seed=seed)
    jdata = jax_get_data(n_train=N_TRAIN, n_test=8, num_classes=N_CLASSES,
                         image_size=image_size, seed=5)
    data = get_data_synthetic(n_train=N_TRAIN, n_test=8,
                              num_classes=N_CLASSES, image_size=image_size,
                              seed=5)
    np.testing.assert_array_equal(jdata[2].images, data[2].images)
    rng = np.random.default_rng(seed + 100)
    eval_idxs = rng.choice(N_TRAIN, EVAL, replace=False)
    rest = np.setdiff1d(np.arange(N_TRAIN), eval_idxs)
    init = rng.choice(rest, n_init, replace=False)

    jtrainer = JaxTrainer(
        jmodel, JaxTrainConfig(loader_te=JaxLoaderConfig(batch_size=16),
                               resident_scoring_bytes=0),
        mesh_lib.make_mesh(1), N_CLASSES)
    jpool = JaxPoolState.create(N_TRAIN, eval_idxs)
    jcfg = JaxExperimentConfig(dataset="synthetic", strategy=name, **cfg_kw)
    jstrat = jax_get_strategy(name)(
        jdata[0], jdata[2], jdata[1], jmodel, jtrainer, jpool, jcfg,
        jtrainer.cfg, rng=np.random.default_rng(seed))
    jstrat.state = types.SimpleNamespace(variables=variables)
    jstrat.update(init, len(init))

    train_cfg = TrainConfig(loader_te=LoaderConfig(batch_size=16))
    trainer = Trainer(model, train_cfg, N_CLASSES, "cpu")
    pool = PoolState.create(N_TRAIN, eval_idxs)
    cfg = ExperimentConfig(dataset="synthetic", strategy=name, device="cpu",
                           **cfg_kw)
    strat = get_strategy(name)(
        data[0], data[2], data[1], model, trainer, pool, cfg, train_cfg,
        rng=np.random.default_rng(seed))
    strat.update(init, len(init))
    return jstrat, strat


@pytest.mark.parametrize("name", ["MASESampler", "BASESampler",
                                  "CoresetSampler", "BADGESampler"])
@pytest.mark.parametrize("seed", [0, 1])
def test_query_picks_match_jax(name, seed):
    jstrat, strat = _sampler_pair(name, seed=seed)
    for budget in (10, 7):
        want, wcost = jstrat.query(budget)
        got, cost = strat.query(budget)
        np.testing.assert_array_equal(got, want)
        assert cost == wcost
        jstrat.update(want, wcost)
        strat.update(got, cost)


@pytest.mark.parametrize("name", ["PartitionedCoresetSampler",
                                  "PartitionedBADGESampler"])
@pytest.mark.parametrize("seed", [0, 1])
def test_partitioned_query_picks_match_jax(name, seed):
    jstrat, strat = _sampler_pair(name, seed=seed, partitions=3)
    want, wcost = jstrat.query(10)
    got, cost = strat.query(10)
    np.testing.assert_array_equal(got, want)
    assert cost == wcost == 10
    np.testing.assert_array_equal(got, np.sort(got))


@pytest.mark.parametrize("name", ["CoresetSampler", "BADGESampler",
                                  "PartitionedCoresetSampler",
                                  "PartitionedBADGESampler"])
def test_subset_caps_match_jax(name):
    kw = {"subset_labeled": 5, "subset_unlabeled": 30}
    if name.startswith("Partitioned"):
        kw["partitions"] = 2
    jstrat, strat = _sampler_pair(name, **kw)
    full, lab, unlab = strat.get_idxs_for_coreset(return_sep_idxs=True)
    jfull, jlab, junlab = jstrat.get_idxs_for_coreset(return_sep_idxs=True)
    assert len(lab) == 5 and len(unlab) == 30
    np.testing.assert_array_equal(full, jfull)
    want, _ = jstrat.query(6)
    got, cost = strat.query(6)
    assert cost == 6
    np.testing.assert_array_equal(got, want)


def test_frozen_features_cache_the_factors_as_jax_does():
    jstrat, strat = _sampler_pair("CoresetSampler", freeze_feature=True)
    calls = {"n": 0}
    orig = strat.get_factors

    def counting(idxs):
        calls["n"] += 1
        return orig(idxs)

    strat.get_factors = counting
    for _ in range(2):
        want, wcost = jstrat.query(5)
        got, cost = strat.query(5)
        np.testing.assert_array_equal(got, want)
        jstrat.update(want, wcost)
        strat.update(got, cost)
    assert calls["n"] == 1
    assert strat._saved_factors is not None
    plain = _sampler_pair("CoresetSampler")[1]
    plain.query(5)
    assert plain._saved_factors is None


def test_score_batch_size_rule():
    _, strat = _sampler_pair("MASESampler")
    assert strat._score_batch_size() == 16
    strat.train_cfg = dataclasses.replace(strat.train_cfg,
                                          score_batch_size=40)
    assert strat._score_batch_size() == 40
