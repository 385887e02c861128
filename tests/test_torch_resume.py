"""The port's resume paths, on the CPU, against the JAX package.

Fit level (the cases of ``tests/test_fit_resume.py``): ``Trainer.fit``
saves a mid-round fit state every ``current_ckpt_every`` epochs and a
fit that crashed after epoch 4's save resumes from epoch 5 to the
unbroken fit's parameters, BatchNorm buffers, momentum, best epoch,
best accuracy and history, bit for bit.  A torn pair, a state of another
round or model format, a state past early stopping, a missing best
checkpoint, a fresh run over a stale state and a hooked fit behave as in
the JAX package.  Left out: the JAX file's ``device_resident``
parametrization (the port has no device-resident feed).

Across the packages:

* a fit state the JAX package wrote (no ``torch.Generator`` state) is
  discarded with a warning and the round restarts at epoch 1; the port's
  pair carries every key of the JAX pair, and the JAX loader reads it;
* a fit state written on another device type raises;
* a JAX round-0 experiment state resumes in the port: the pool arrays,
  the numpy rng state, ``best_epoch``, the best weights (leaf for leaf)
  and the experiment key come back equal, the JAX ``init_key`` is
  re-seeded with a warning (never read as a port seed), and the port's
  round-1 MarginSampler query picks what the unbroken JAX run's picks;
* the reverse: the JAX package's ``load_experiment`` restores a state
  the port wrote, and its round-1 query equals the port's unbroken one;
* VAAL's aux state: flax-written bytes of a ``VAALState``-shaped tree
  (Adam moments and counts included) restore into the port leaf for
  leaf, and flax restores the port's bytes.

Picks are compared exactly: both packages' margins on these seeds are
further apart than their float32 difference (the tiny networks of
``test_torch_acquisition._sampler_pair``).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from active_learning_tpu.experiment import resume as jax_resume
from active_learning_tpu.train import checkpoint as jax_ckpt

from active_learning_tpu_torch.config import (LoaderConfig, OptimizerConfig,
                                              SchedulerConfig, TrainConfig)
from active_learning_tpu_torch.data.synthetic import get_data_synthetic
from active_learning_tpu_torch.experiment import resume
from active_learning_tpu_torch.models import resnet
from active_learning_tpu_torch.models.weights import to_flax_variables
from active_learning_tpu_torch.pool import PoolState
from active_learning_tpu_torch.train import checkpoint as ckpt_lib
from active_learning_tpu_torch.train.trainer import Trainer
from active_learning_tpu_torch.utils.metrics import NullSink

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_acquisition import _sampler_pair  # noqa: E402

N_EPOCH = 6
CADENCE = 2  # fit state written after epochs 2 and 4
LOGGER = "ActiveLearningTorch"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny networks: one intra-op thread each.  Several test workers,
    each with a thread per core spinning on these small ops, slow one
    another down a hundredfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Boom(Exception):
    pass


def _boom_at(epoch):
    def cb(name, value, step):
        if step == epoch and name.endswith("validation_accuracy"):
            raise Boom()
    return cb


def _train_cfg(every=CADENCE):
    return TrainConfig(
        eval_split=0.1, loader_tr=LoaderConfig(batch_size=16),
        loader_te=LoaderConfig(batch_size=16),
        optimizer=OptimizerConfig(name="sgd", lr=0.05, weight_decay=5e-4,
                                  momentum=0.9),
        scheduler=SchedulerConfig(name="constant"),
        current_ckpt_every=every)


def _trainer(every=CADENCE):
    """A BatchNorm network in training mode (kernel C's plain version),
    from the same seed every time."""
    model = resnet.SSLClassifier((1, 1), resnet.BasicBlock, 4,
                                 cifar_stem=True, dtype=torch.float32)
    model = model.to(memory_format=torch.channels_last)
    resnet.init_weights(model, torch.Generator().manual_seed(0))
    return Trainer(model, _train_cfg(every), 4, "cpu")


def _data():
    train_set, _, al_set = get_data_synthetic(
        n_train=64, n_test=16, num_classes=4, image_size=8, seed=11)
    return train_set, al_set


def _fit(root, tag, metric_cb=None, resume_fit_state=True, every=CADENCE,
         n_epoch=N_EPOCH, trainer=None, batch_hook=None, es_patience=10):
    train_set, al_set = _data()
    trainer = trainer or _trainer(every)
    paths = ckpt_lib.weight_paths(str(root), "t", tag, round_idx=1)
    result = trainer.fit(
        train_set, np.arange(48), al_set, np.arange(48, 64),
        n_epoch=n_epoch, es_patience=es_patience,
        rng=np.random.default_rng(7), round_idx=1, weight_paths=paths,
        metric_cb=metric_cb, batch_hook=batch_hook,
        resume_fit_state=resume_fit_state)
    return result, paths, trainer


def _state(trainer):
    out = {k: v.detach().clone() for k, v in
           trainer.model.state_dict().items()}
    for i, t in enumerate(trainer.optimizer.trace):
        out[f"trace.{i}"] = t.detach().clone()
    return out


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- the fit level ----------------------------------------------------------

def test_resume_matches_uninterrupted_run(tmp_path):
    ref, ref_paths, ref_tr = _fit(tmp_path / "a", "a")
    # A completed round leaves no fit state behind.
    assert ckpt_lib.load_fit_state(ref_paths["fit_state"], 1) is None

    with pytest.raises(Boom):
        _fit(tmp_path / "b", "b", metric_cb=_boom_at(5))
    saved = ckpt_lib.load_fit_state(
        str(tmp_path / "b" / "t_b" / "fit_state_rd_1"), 1)
    assert saved is not None and saved["epoch"] == 4

    resumed, res_paths, res_tr = _fit(tmp_path / "b", "b")
    assert resumed.history[0]["epoch"] == 5
    assert resumed.epochs_run == ref.epochs_run
    assert resumed.best_epoch == ref.best_epoch
    assert resumed.best_perf == ref.best_perf
    assert resumed.history == ref.history[4:]
    _assert_same(_state(res_tr), _state(ref_tr))
    assert ckpt_lib.load_fit_state(res_paths["fit_state"], 1) is None
    # The best checkpoints on disk agree too.
    want = ckpt_lib.load_variables(ref_paths["best_ckpt"])
    got = ckpt_lib.load_variables(res_paths["best_ckpt"])
    for (pa, a), (pb, b) in zip(ckpt_lib.flatten_tree(want),
                                ckpt_lib.flatten_tree(got)):
        assert pa == pb and np.array_equal(a, b), pa


def _tiny_state(path, epoch, round_idx, w):
    ckpt_lib.save_fit_state(
        path, variables={"params": {"w": np.full(2, w)}}, opt_state={},
        step=epoch, epoch=epoch, round_idx=round_idx, best_perf=0.5,
        best_epoch=epoch, es_count=0, key=[0, 1],
        rng=np.random.default_rng(0),
        generator=ckpt_lib.generator_state(torch.Generator()))


def test_torn_fit_state_save_is_rejected(tmp_path):
    fs = str(tmp_path / "fit_state_rd_1")
    _tiny_state(fs, 2, 1, 1.0)
    with open(fs + ".json") as fh:
        old_meta = fh.read()
    _tiny_state(fs, 4, 1, 9.0)
    assert ckpt_lib.load_fit_state(fs, 1)["epoch"] == 4
    # The torn save: epoch-4 trees beside epoch-2 counters.
    with open(fs + ".json", "w") as fh:
        fh.write(old_meta)
    assert ckpt_lib.load_fit_state(fs, 1) is None
    assert json.loads(old_meta)["epoch"] == 2


def test_no_fit_state_saved_past_early_stop(tmp_path, monkeypatch):
    trainer = _trainer(every=1)
    accs = iter([0.9, 0.8, 0.7, 0.6, 0.5, 0.4])
    trainer.evaluate = lambda d, i: {"accuracy": next(accs),
                                     "top_5_accuracy": 1.0}
    saved_counts = []
    orig = ckpt_lib.save_fit_state

    def recording(path, **kw):
        saved_counts.append(kw["es_count"])
        return orig(path, **kw)

    monkeypatch.setattr(ckpt_lib, "save_fit_state", recording)
    result, _, _ = _fit(tmp_path, "es", trainer=trainer, es_patience=1)
    assert result.epochs_run == 3
    assert saved_counts, "a cadence-1 fit never saved a fit state"
    assert all(c <= 1 for c in saved_counts), saved_counts


def test_resume_with_missing_best_ckpt_restarts_best_tracking(tmp_path):
    with pytest.raises(Boom):
        _fit(tmp_path, "e", metric_cb=_boom_at(5))
    fs = str(tmp_path / "t_e" / "fit_state_rd_1")
    with open(fs + ".json") as fh:
        meta = json.load(fh)
    meta["best_perf"], meta["best_epoch"] = 0.99, 4
    with open(fs + ".json", "w") as fh:
        json.dump(meta, fh)
    os.remove(str(tmp_path / "t_e" / "best_rd_1.msgpack"))
    resumed, paths, _ = _fit(tmp_path, "e")
    assert resumed.history[0]["epoch"] == 5
    vals = [r["val_accuracy"] for r in resumed.history]
    assert resumed.best_perf == max(vals)
    assert os.path.exists(paths["best_ckpt"])


def test_fresh_run_discards_stale_fit_state(tmp_path):
    with pytest.raises(Boom):
        _fit(tmp_path, "f", metric_cb=_boom_at(5))
    fs = str(tmp_path / "t_f" / "fit_state_rd_1")
    assert ckpt_lib.load_fit_state(fs, 1) is not None
    ref, _, ref_tr = _fit(tmp_path / "clean", "f")
    fresh, _, fresh_tr = _fit(tmp_path, "f", resume_fit_state=False)
    assert fresh.history[0]["epoch"] == 1
    assert fresh.epochs_run == ref.epochs_run
    _assert_same(_state(fresh_tr), _state(ref_tr))
    assert ckpt_lib.load_fit_state(fs, 1) is None


def test_stale_state_from_other_round_is_ignored(tmp_path):
    fs = str(tmp_path / "fit_state_rd_1")
    _tiny_state(fs, 4, 3, 1.0)
    assert ckpt_lib.load_fit_state(fs, 1) is None
    assert ckpt_lib.load_fit_state(fs, 3) is not None


def test_fit_state_from_other_model_format_is_discarded(tmp_path):
    fs = str(tmp_path / "fit_state_rd_0")
    _tiny_state(fs, 3, 0, 0.0)
    assert ckpt_lib.load_fit_state(fs, 0) is not None
    meta = json.loads(open(fs + ".json").read())
    meta["model_format"] = 1
    open(fs + ".json", "w").write(json.dumps(meta))
    assert ckpt_lib.load_fit_state(fs, 0) is None


def test_hooked_fit_writes_no_fit_state_and_ignores_one(tmp_path):
    """A fit with a batch hook (VAAL's co-training seam) restarts its
    round: its hook's state is outside the fit state."""
    plain, paths, tr = _fit(tmp_path, "h", n_epoch=4, every=1)
    train_set, _ = _data()
    ckpt_lib.save_fit_state(
        paths["fit_state"],
        variables=to_flax_variables(tr.model.state_dict()),
        opt_state=tr.opt_state_tree(), step=9, epoch=3, round_idx=1,
        best_perf=plain.best_perf, best_epoch=plain.best_epoch, es_count=0,
        key=[0, 1], rng=np.random.default_rng(7),
        generator=ckpt_lib.generator_state(torch.Generator()))
    assert ckpt_lib.load_fit_state(paths["fit_state"], 1) is not None
    calls = []
    hooked, _, _ = _fit(tmp_path, "h", n_epoch=2, every=1,
                        batch_hook=lambda epoch, batch: calls.append(epoch))
    assert hooked.epochs_run == 2
    assert min(calls) == 1
    assert len(calls) == 2 * 3
    assert ckpt_lib.load_fit_state(paths["fit_state"], 1) is None


def test_fit_state_keys_and_layout_match_jax(tmp_path):
    """The port's pair has the JAX pair's keys (plus the generator), its
    trees in flax's layout: the JAX loader reads it."""
    with pytest.raises(Boom):
        _fit(tmp_path, "k", metric_cb=_boom_at(3))
    fs = str(tmp_path / "t_k" / "fit_state_rd_1")
    jfs = str(tmp_path / "jax_fit_state")
    jax_ckpt.save_fit_state(
        jfs, variables={"params": {"w": np.ones(2)}},
        opt_state={"trace": {"w": np.ones(2)}}, step=np.int32(4), epoch=2,
        round_idx=1, best_perf=0.5, best_epoch=2, es_count=0,
        key=jax.random.PRNGKey(1), rng=np.random.default_rng(0))
    port_meta = json.loads(open(fs + ".json").read())
    jax_meta = json.loads(open(jfs + ".json").read())
    assert set(port_meta) == set(jax_meta) | {ckpt_lib.GENERATOR_KEY}
    got = jax_ckpt.load_fit_state(fs, 1)
    assert got is not None and got["epoch"] == 2
    assert set(got["variables"]) == {"params", "batch_stats"}
    assert set(got["opt_state"]) == {"trace"}
    assert got["variables"]["params"]["linear"]["kernel"].shape == (128, 4)


def test_jax_written_fit_state_is_discarded_with_a_warning(tmp_path,
                                                           caplog):
    """The JAX package's fit state has no torch.Generator state: the port
    never mis-loads it, and the round restarts at epoch 1."""
    ref, _, ref_tr = _fit(tmp_path / "ref", "j", n_epoch=3)
    paths = ckpt_lib.weight_paths(str(tmp_path), "t", "j", round_idx=1)
    _, _, tr = _fit(tmp_path / "other", "j", n_epoch=2)
    jax_ckpt.save_fit_state(
        paths["fit_state"],
        variables=to_flax_variables(tr.model.state_dict()),
        opt_state=tr.opt_state_tree(), step=np.int32(6), epoch=2,
        round_idx=1, best_perf=0.5, best_epoch=2, es_count=0,
        key=jax.random.PRNGKey(3), rng=np.random.default_rng(0))
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        got, _, got_tr = _fit(tmp_path, "j", n_epoch=3)
    assert any("without the port's torch.Generator state" in r.message
               for r in caplog.records)
    assert got.history[0]["epoch"] == 1
    assert got.history == ref.history
    _assert_same(_state(got_tr), _state(ref_tr))


def test_fit_state_with_another_optimizer_layout_is_discarded(tmp_path,
                                                              caplog):
    """As the JAX package discards an incompatible optimizer layout: the
    round restarts at epoch 1 and nothing of the state is copied."""
    ref, _, ref_tr = _fit(tmp_path / "ref", "o", n_epoch=3)
    with pytest.raises(Boom):
        _fit(tmp_path, "o", metric_cb=_boom_at(3))
    fs = str(tmp_path / "t_o" / "fit_state_rd_1")
    with open(fs + ".msgpack", "rb") as fh:
        trees = ckpt_lib.msgpack_restore(fh.read())
    trees["opt_state"] = {"0": trees["opt_state"]["trace"]}  # optax-like
    with open(fs + ".msgpack", "wb") as fh:
        fh.write(ckpt_lib.msgpack_serialize(trees))
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        got, _, got_tr = _fit(tmp_path, "o", n_epoch=3)
    assert any("does not fit this model or optimizer" in r.message
               for r in caplog.records)
    assert got.history == ref.history
    _assert_same(_state(got_tr), _state(ref_tr))


def test_fit_state_from_another_device_type_raises(tmp_path):
    with pytest.raises(Boom):
        _fit(tmp_path, "d", metric_cb=_boom_at(3))
    fs = str(tmp_path / "t_d" / "fit_state_rd_1")
    meta = json.loads(open(fs + ".json").read())
    meta[ckpt_lib.GENERATOR_KEY]["device_type"] = "cuda"
    open(fs + ".json", "w").write(json.dumps(meta))
    with pytest.raises(RuntimeError, match="cannot continue on cpu"):
        _fit(tmp_path, "d")


# -- across the packages: the round-level state -----------------------------

BUDGET = 12


class _KeyedSink(NullSink):
    experiment_key = "exp-key-1"


def _pair(tmp_path, tag):
    jstrat, strat = _sampler_pair("MarginSampler", ckpt_path=str(tmp_path),
                                  exp_hash=tag, exp_name="x")
    jstrat.sink = _KeyedSink()
    strat.sink = _KeyedSink()
    return jstrat, strat


def _scramble_port(strat):
    resnet.init_weights(strat.model, torch.Generator().manual_seed(9))
    strat.pool = PoolState.create(strat.pool.n_pool, strat.pool.eval_idxs)
    strat.rng = np.random.default_rng(1234)
    strat.best_epoch = 0


def test_jax_round0_state_resumes_in_the_port(tmp_path, caplog):
    jstrat, strat = _pair(tmp_path, "j2p")
    jstrat.best_epoch = 3
    variables = jstrat.state.variables
    jax_ckpt.save_variables(jstrat.weight_paths()["best_ckpt"], variables)
    jax_resume.save_experiment(jstrat, jstrat.cfg)
    saved = jstrat.pool.to_arrays()
    # The unbroken JAX run's round-1 query.
    jstrat.round = 1
    want, wcost = jstrat.query(BUDGET)

    _scramble_port(strat)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        start = resume.load_experiment(strat, strat.cfg)
    assert start == 1
    jkey = np.asarray(jstrat._init_key, dtype=np.uint32)
    assert any("JAX threefry init key" in r.message for r in caplog.records)
    # Never read silently as a port seed.
    assert strat.init_key.tolist() != jkey.tolist()
    for k, v in saved.items():
        np.testing.assert_array_equal(strat.pool.to_arrays()[k], v,
                                      err_msg=k)
    assert strat.rng.bit_generator.state == jstrat.rng.bit_generator.state
    assert strat.best_epoch == 3
    assert resume.saved_experiment_key(strat.cfg) == "exp-key-1"
    got_vars = to_flax_variables(strat.model.state_dict())
    want_leaves = dict(ckpt_lib.flatten_tree(jax.tree.map(np.asarray,
                                                          variables)))
    got_leaves = dict(ckpt_lib.flatten_tree(got_vars))
    assert sorted(got_leaves) == sorted(want_leaves)
    for k, v in want_leaves.items():
        np.testing.assert_array_equal(got_leaves[k], v, err_msg=str(k))
    strat.round = 1
    got, cost = strat.query(BUDGET)
    np.testing.assert_array_equal(got, want)
    assert cost == wcost


def test_port_state_resumes_in_jax(tmp_path):
    jstrat, strat = _pair(tmp_path, "p2j")
    strat.best_epoch = 2
    ckpt_lib.publish_best(strat.weight_paths()["best_ckpt"],
                          to_flax_variables(strat.model.state_dict()),
                          round_idx=0, epoch=2)
    resume.save_experiment(strat, strat.cfg)
    saved = strat.pool.to_arrays()
    # The unbroken port run's round-1 query.
    strat.round = 1
    want, wcost = strat.query(BUDGET)

    jstrat.state = None
    jstrat.pool = type(jstrat.pool).create(jstrat.pool.n_pool,
                                           jstrat.pool.eval_idxs)
    jstrat.rng = np.random.default_rng(4321)
    assert jax_resume.load_experiment(jstrat, jstrat.cfg) == 1
    for k, v in saved.items():
        np.testing.assert_array_equal(jstrat.pool.to_arrays()[k], v,
                                      err_msg=k)
    assert jstrat.rng.bit_generator.state == strat.rng.bit_generator.state
    assert jstrat.best_epoch == 2
    jstrat.round = 1
    got, cost = jstrat.query(BUDGET)
    np.testing.assert_array_equal(got, want)
    assert cost == wcost


def test_port_init_key_is_marked_and_read_back(tmp_path):
    _, strat = _pair(tmp_path, "key")
    strat.init_network_weights()
    strat.init_network_weights()
    key = strat.init_key.copy()
    resume.save_experiment(strat, strat.cfg)
    meta = json.loads(open(os.path.join(resume.state_dir(strat.cfg),
                                        resume.META_FILE)).read())
    assert meta["init_key_kind"] == resume.PORT_INIT_KEY
    strat.set_init_state(1, 0)
    resume.load_experiment(strat, strat.cfg)
    np.testing.assert_array_equal(strat.init_key, key)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_vaal_aux_state_crosses_both_ways(tmp_path):
    """flax's serializer writes a ``VAALState``-shaped tree (the layout
    ``test_torch_vaal`` holds leaf for leaf to the JAX sampler's), Adam
    moments and counts moved off their init; the port restores it leaf
    for leaf, and flax restores the port's bytes into the same tree."""
    from active_learning_tpu_torch.config import (ExperimentConfig,
                                                  VAALConfig)
    from active_learning_tpu_torch.experiment import driver

    data = get_data_synthetic(n_train=64, n_test=8, num_classes=4,
                              image_size=16, seed=5)
    cfg = ExperimentConfig(dataset="synthetic", strategy="VAALSampler",
                           round_budget=8, device="cpu", exp_hash="vaal",
                           vaal=VAALConfig(vae_latent_dim=8),
                           ckpt_path=str(tmp_path), log_dir=str(tmp_path))
    model = resnet.SSLClassifier((1, 1), resnet.BasicBlock, 4,
                                 cifar_stem=True, dtype=torch.float32)
    strat = driver.build_experiment(cfg, sink=NullSink(), data=data,
                                    train_cfg=_train_cfg(), model=model)
    strat.init_network_weights()
    rng = np.random.default_rng(0)

    def moved(path, v):
        v = np.asarray(v)
        if v.dtype.kind == "f":
            return (v + rng.normal(size=v.shape) * 0.01).astype(v.dtype)
        return (v + 7).astype(v.dtype)

    tree = jax.tree_util.tree_map_with_path(moved, strat.vaal.state_tree())
    written = serialization.msgpack_serialize(tree)
    strat.vaal = None
    strat.restore_aux_state(written)
    want = _leaves(tree)
    got = _leaves(strat.vaal.state_tree())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    back = _leaves(serialization.from_state_dict(
        tree, serialization.msgpack_restore(strat.aux_state_bytes())))
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_resume_without_state_is_refused(tmp_path):
    from active_learning_tpu_torch.config import ExperimentConfig
    from active_learning_tpu_torch.experiment import driver

    cfg = ExperimentConfig(dataset="synthetic", strategy="MarginSampler",
                           device="cpu", resume_training=True,
                           exp_hash="none", ckpt_path=str(tmp_path / "c"),
                           log_dir=str(tmp_path / "l"))
    with pytest.raises(FileNotFoundError, match="no saved experiment"):
        driver.run_experiment(cfg, sink=NullSink(),
                              data=types.SimpleNamespace())
