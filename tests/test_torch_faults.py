"""The port's failure model (``active_learning_tpu_torch/faults``) on the
CPU, held to the JAX package's where the two meet: the spec grammar and
the seeded registry, the one RetryPolicy (with CUDA's errors
classified), the round journal, preemption, the degradation ladder, torn
writes, a chaos matrix over the sites the port wires, the round-0 and
round-1 preemption resumes, and one real SIGTERM to a child process.

Chaos runs: a 2-round MarginSampler experiment on tiny synthetic data
with a small BatchNorm network, armed at one site at a time.  Each
either completes or, crashed, resumes fault-free, and its
``experiment_state.npz`` equals the fault-free run's bit for bit; the
fault fired; no gather thread outlives the run; the journal says
``finished``.

Left out, each because the port does not have the JAX detail it pins:
the sites and rungs of the resident pool, the device feeder and the
pipelined round (``h2d_upload``, ``shard_upload``, ``feed_worker``,
``spec_scorer``; their rungs cannot apply here, which the ladder tests
pin instead); the stall watchdog and ``status --strict`` (telemetry);
the N-rank learning probe's degrade inside a run (the port refuses
fault injection on more than one rank, so the probe's site is held by
calling the probe directly).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from active_learning_tpu.faults import journal as jax_journal
from active_learning_tpu.faults import registry as jax_registry

from active_learning_tpu_torch import faults
from active_learning_tpu_torch.config import (ExperimentConfig, LoaderConfig,
                                              OptimizerConfig,
                                              SchedulerConfig, TrainConfig)
from active_learning_tpu_torch.data.synthetic import get_data_synthetic
from active_learning_tpu_torch.experiment import cli, driver
from active_learning_tpu_torch.experiment import resume as resume_lib
from active_learning_tpu_torch.faults import journal as journal_lib
from active_learning_tpu_torch.faults import ladder as ladder_lib
from active_learning_tpu_torch.faults import preempt as preempt_lib
from active_learning_tpu_torch.faults.registry import _SiteState
from active_learning_tpu_torch.models import resnet
from active_learning_tpu_torch.parallel import mesh as mesh_lib
from active_learning_tpu_torch.train import checkpoint as ckpt_lib
from active_learning_tpu_torch.utils.metrics import NullSink

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "active_learning_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny networks: one intra-op thread each.  Several test workers,
    each with a thread per core spinning on these small ops, slow one
    another down a hundredfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.configure(None)
    preempt_lib.reset()
    yield
    faults.configure(None)
    preempt_lib.reset()


# -- spec grammar and registry -----------------------------------------------

def test_full_spec_parses_as_in_jax():
    spec = ("h2d_upload:raise@3,ckpt_write:torn@1,spec_scorer:die@0.5,"
            "dispatch:delay@0.05,feed_worker:oom@2,grad_probe:raise")
    assert faults.parse_spec(spec) == jax_registry.parse_spec(spec)
    assert faults.SITES == jax_registry.SITES
    assert faults.ACTIONS == jax_registry.ACTIONS


@pytest.mark.parametrize("bad,msg", [
    ("nosuch:raise", "unknown site"), ("ckpt_write:explode", "not one of"),
    ("ckpt_write", "expected site:action"), ("ckpt_write:raise@x",
                                             "neither an int"),
    ("ckpt_write:raise@0", "must be in"), ("ckpt_write:raise@1.5",
                                           "must be in"),
    ("ckpt_write:raise,ckpt_write:torn", "twice")])
def test_malformed_specs_fail_fast(bad, msg):
    with pytest.raises(ValueError, match=msg):
        faults.parse_spec(bad)


def _port_sources():
    out = {}
    for path in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True):
        if os.sep + "faults" + os.sep not in path:
            with open(path) as fh:
                out[path] = fh.read()
    return out


def test_every_site_has_a_wired_home_or_a_roadmap_item():
    """A site the port wires is called by name in its code; the others
    are listed with the ROADMAP.md item that brings their subsystem."""
    called = set()
    for text in _port_sources().values():
        called |= set(re.findall(r"faults\.site\(\s*\"(\w+)\"", text))
    awaiting = set(faults.SITES_AWAITING_A_HOME)
    assert awaiting <= set(faults.SITES)
    assert called == set(faults.SITES) - awaiting
    roadmap = open(os.path.join(REPO, "ROADMAP.md")).read()
    for name, item in faults.SITES_AWAITING_A_HOME.items():
        assert item.startswith("item "), name
        assert name in roadmap, name


def test_disarmed_site_is_a_noop_and_cheap():
    faults.site("ckpt_write")
    assert faults.fault_counters() == {}
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        faults.site("dispatch")
    assert time.perf_counter() - t0 < 0.25


def test_nth_hit_fires_exactly_once():
    faults.configure("ckpt_write:raise@2")
    faults.site("ckpt_write")
    with pytest.raises(faults.InjectedFault):
        faults.site("ckpt_write")
    faults.site("ckpt_write")
    assert faults.fault_counters()["ckpt_write"] == {"hits": 3, "fires": 1}


def test_oom_die_and_torn_actions():
    faults.configure("dispatch:oom@1")
    with pytest.raises(faults.InjectedOOM):
        faults.site("dispatch")
    faults.configure("dispatch:die@1")
    with pytest.raises(faults.ThreadDeath):
        try:
            faults.site("dispatch")
        except Exception:  # noqa: BLE001 - must not catch it
            pytest.fail("ThreadDeath was caught as an Exception")
    faults.configure("ckpt_write:torn@1")
    faults.site("ckpt_write")            # the enter point never tears
    with pytest.raises(faults.InjectedFault):
        faults.site("ckpt_write", point="torn")


def test_unarmed_sites_stay_silent_beside_armed_ones():
    faults.configure("ckpt_write:raise")
    faults.site("dispatch")
    assert "dispatch" not in faults.fault_counters()


@pytest.mark.parametrize("seed", [0, 7])
def test_probability_fires_at_the_jax_registrys_hits(seed):
    """The same spec and seed fire at the same hits in both packages."""
    port = _SiteState("dispatch", "raise", 0.3, seed)
    ref = jax_registry._SiteState("dispatch", "raise", 0.3, seed)

    def pattern(st, errors):
        out = []
        for _ in range(200):
            try:
                st.hit("enter")
                out.append(0)
            except errors:
                out.append(1)
        return out

    got = pattern(port, faults.InjectedFault)
    assert got == pattern(ref, jax_registry.InjectedFault)
    assert 0 < sum(got) < 200


# -- retry ---------------------------------------------------------------------

def test_classification_table():
    c = faults.classify_exception
    assert c(faults.InjectedOOM("dispatch")) == faults.OOM
    assert c(torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                    "allocate 2.00 GiB")) == faults.OOM
    assert c(RuntimeError("CUDA out of memory. Tried to allocate")) \
        == faults.OOM
    assert c(RuntimeError("RESOURCE_EXHAUSTED: oom")) == faults.OOM
    assert c(RuntimeError("CUDA error: an illegal memory access was "
                          "encountered")) == faults.FATAL
    assert c(RuntimeError("CUDA error: unspecified launch failure")) \
        == faults.FATAL
    assert c(faults.InjectedFault("ckpt_write")) == faults.TRANSIENT
    assert c(faults.ThreadDeath("dispatch")) == faults.TRANSIENT
    assert c(OSError("disk full")) == faults.TRANSIENT
    assert c(ValueError("bug")) == faults.FATAL


def _policy(**kw):
    return faults.RetryPolicy("t", classify=faults.classify_exception,
                              base_delay_s=0.001, **kw)


def test_transient_retries_then_succeeds():
    calls = []
    before = faults.retry_counters()["total"]

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert _policy(max_attempts=3).call(flaky) == "ok"
    assert len(calls) == 3
    assert faults.retry_counters()["total"] == before + 2
    assert faults.retry_counters()["last_site"] == "t"


@pytest.mark.parametrize("exc", [
    ValueError("bug"), torch.OutOfMemoryError("CUDA out of memory."),
    RuntimeError("CUDA error: an illegal memory access was encountered")])
def test_fatal_and_oom_never_retry(exc):
    calls = []

    def fail():
        calls.append(1)
        raise exc

    with pytest.raises(type(exc)):
        _policy().call(fail)
    assert len(calls) == 1


def test_attempt_and_wall_budgets_reraise_the_last_failure():
    calls = []

    def fail():
        calls.append(1)
        raise OSError(f"attempt {len(calls)}")

    with pytest.raises(OSError, match="attempt 2"):
        _policy(max_attempts=2).call(fail)
    calls.clear()
    with pytest.raises(OSError):
        _policy(max_attempts=100, wall_budget_s=0.0).call(fail)
    assert len(calls) == 1


def test_classify_is_required():
    with pytest.raises(ValueError, match="classify is required"):
        faults.RetryPolicy("t", classify=None)


# -- journal -------------------------------------------------------------------

def test_journal_merge_write_seq_and_residue(tmp_path):
    path = str(tmp_path / faults.JOURNAL_FILE)
    j = faults.RoundJournal(path)
    j.write(round=0, phase="init", status="running")
    j.write(phase="train", degrade=["batch_half"])
    got = faults.read_journal(path)
    assert got["round"] == 0 and got["phase"] == "train"
    assert got["degrade"] == ["batch_half"] and got["seq"] == 2
    j.write(degrade=None)
    assert "degrade" not in faults.read_journal(path)
    # seq continues across instances, and across the packages.
    faults.RoundJournal(path).write(status="finished")
    assert faults.read_journal(path)["seq"] == 4
    jax_journal.RoundJournal(path).write(status="preempted")
    assert faults.read_journal(path)["seq"] == 5
    assert jax_journal.read_journal(path)["status"] == "preempted"
    assert os.listdir(tmp_path) == [faults.JOURNAL_FILE]


def test_journal_disabled_and_unparseable(tmp_path):
    path = str(tmp_path / faults.JOURNAL_FILE)
    assert faults.RoundJournal(path, enabled=False).write(round=1) is None
    assert not os.path.exists(path)
    with open(path, "w") as fh:
        fh.write("{not json")
    assert faults.read_journal(path) is None


# -- preemption ----------------------------------------------------------------

def test_preempt_record_check_reset():
    preempt_lib.check()
    preempt_lib._handler(signal.SIGTERM, None)
    assert preempt_lib.requested() == signal.SIGTERM
    with pytest.raises(preempt_lib.PreemptionRequested) as err:
        preempt_lib.check()
    assert err.value.signum == signal.SIGTERM
    preempt_lib.reset()
    preempt_lib.check()


def test_install_restores_previous_handlers_and_needs_the_main_thread():
    before = signal.getsignal(signal.SIGTERM)
    prev = preempt_lib.install()
    assert signal.getsignal(signal.SIGTERM) is preempt_lib._handler
    preempt_lib.uninstall(prev)
    assert signal.getsignal(signal.SIGTERM) is before
    got = []
    t = threading.Thread(target=lambda: got.append(preempt_lib.install()))
    t.start()
    t.join()
    assert got == [None]


# -- the degradation ladder ----------------------------------------------------

def _tiny_model():
    model = resnet.SSLClassifier((1, 1), resnet.BasicBlock, 4,
                                 cifar_stem=True, dtype=torch.float32)
    return model.to(memory_format=torch.channels_last)


def _train_cfg(workers: int = 2) -> TrainConfig:
    return TrainConfig(
        eval_split=0.1, loader_tr=LoaderConfig(batch_size=16,
                                               num_workers=workers),
        loader_te=LoaderConfig(batch_size=16),
        optimizer=OptimizerConfig(name="sgd", lr=0.05, weight_decay=5e-4,
                                  momentum=0.9),
        scheduler=SchedulerConfig(name="constant"))


@pytest.fixture(scope="module")
def chaos_data():
    return get_data_synthetic(n_train=96, n_test=32, num_classes=4,
                              image_size=8, seed=5)


@pytest.fixture
def ladder(chaos_data, tmp_path):
    cfg = ExperimentConfig(dataset="synthetic", strategy="MarginSampler",
                           round_budget=8, device="cpu", exp_hash="lad",
                           ckpt_path=str(tmp_path), log_dir=str(tmp_path))
    strategy = driver.build_experiment(cfg, sink=NullSink(), data=chaos_data,
                                       train_cfg=_train_cfg(),
                                       model=_tiny_model())
    return ladder_lib.DegradationLadder(strategy)


def test_rungs_order_and_attempts_are_jaxs(ladder):
    from active_learning_tpu.faults import ladder as jax_ladder
    assert ladder_lib.RUNGS == jax_ladder.RUNGS
    assert ladder_lib._SITE_RUNG == jax_ladder._SITE_RUNG
    assert ladder.max_attempts() == len(ladder_lib.RUNGS) + 1


def test_generic_failures_find_no_rung_that_applies(ladder):
    """pipeline_off, pool_replicated and feed_host act on subsystems the
    port does not have: escalation falls through them and ends."""
    assert ladder._candidate_rungs(RuntimeError("x")) == [
        "pipeline_off", "pool_replicated", "feed_host"]
    assert ladder.escalate(RuntimeError("x"), 0) is None
    assert ladder.escalate(faults.InjectedFault("dispatch"), 0) is None
    assert ladder.active == [] and ladder.events == 0


@pytest.mark.parametrize("exc", [
    faults.InjectedOOM("dispatch"),
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 1 GiB")])
def test_oom_halves_the_batch_and_relax_reverts(ladder, exc):
    trainer = ladder.strategy.trainer
    assert ladder.escalate(exc, 0) == "batch_half"
    assert trainer.cfg.loader_tr.batch_size == 8
    # Already applied, and nothing else frees memory here.
    assert ladder.escalate(exc, 0) is None
    assert ladder.relax(1) == ["batch_half"]
    assert trainer.cfg.loader_tr.batch_size == 16


def test_oom_at_the_rank_floor_falls_through(ladder):
    trainer = ladder.strategy.trainer
    trainer.cfg = dataclasses.replace(
        trainer.cfg, loader_tr=dataclasses.replace(trainer.cfg.loader_tr,
                                                   batch_size=1))
    assert ladder.escalate(faults.InjectedOOM("dispatch"), 0) is None


def test_site_provenance_picks_the_jax_rung():
    assert ladder_lib._provenance_rung(
        faults.InjectedFault("feed_worker")) == "feed_host"
    assert ladder_lib._provenance_rung(
        faults.InjectedFault("dispatch")) == "pipeline_off"
    try:
        mesh_lib.padded_batch_size(4, None)
    except Exception as exc:  # noqa: BLE001 - raised inside parallel/mesh
        assert ladder_lib._provenance_rung(exc) == "pool_replicated"


# -- torn writes -----------------------------------------------------------------

def test_torn_publish_leaves_a_readable_pair_after_retry(tmp_path):
    path = str(tmp_path / "best_rd_0.msgpack")
    variables = {"params": {"w": np.ones((2, 2), np.float32)}}
    faults.configure("ckpt_write:torn@1")
    with pytest.raises(faults.InjectedFault):
        ckpt_lib.publish_best(path, variables, round_idx=0, epoch=3)
    assert os.path.exists(path)
    assert ckpt_lib.read_best_tag(path) is None
    ckpt_lib.publish_best(path, variables, round_idx=0, epoch=3)
    assert ckpt_lib.read_best_tag(path) == (0, 3)


def test_torn_save_experiment_reads_as_nothing_to_resume(ladder, tmp_path):
    strategy = ladder.strategy
    cfg = dataclasses.replace(strategy.cfg, ckpt_path=str(tmp_path / "t"),
                              exp_hash="torn")
    faults.configure("ckpt_write:torn@1")
    with pytest.raises(faults.InjectedFault):
        resume_lib.save_experiment(strategy, cfg)
    assert not resume_lib.has_saved_experiment(cfg)
    faults.configure(None)
    resume_lib.save_experiment(strategy, cfg)
    assert resume_lib.has_saved_experiment(cfg)


def test_grad_probe_site_is_a_broken_probe():
    faults.configure("grad_probe:die@1")
    assert driver.run_grad_allreduce_probe(mesh_lib.single_rank("cpu")) \
        == (False, None)


# -- the chaos matrix ------------------------------------------------------------

N_EPOCH = 3


def _e2e_cfg(tag, root, *, resume=False, n_epoch=N_EPOCH, fault_spec=None,
             rounds=2):
    return ExperimentConfig(
        dataset="synthetic", arg_pool="synthetic", strategy="MarginSampler",
        rounds=rounds, round_budget=8, n_epoch=n_epoch,
        early_stop_patience=n_epoch, run_seed=7, exp_hash=tag,
        exp_name="faults", ckpt_path=os.path.join(str(root), "ckpt"),
        log_dir=os.path.join(str(root), "logs"), resume_training=resume,
        fault_spec=fault_spec, device="cpu")


def _run_e2e(cfg, data, sink=None):
    driver.run_experiment(cfg, sink=sink, data=data, train_cfg=_train_cfg(),
                          model=_tiny_model())
    path = glob.glob(os.path.join(cfg.ckpt_path, "*",
                                  "experiment_state.npz"))[0]
    with np.load(path) as st:
        return {k: st[k] for k in st.files}


def _metric_max(log_dir, name):
    best = None
    path = os.path.join(log_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        for line in fh:
            ev = json.loads(line)
            if ev.get("kind") == "metric" and name in ev.get("metrics", {}):
                v = ev["metrics"][name]
                best = v if best is None else max(best, v)
    return best


def _assert_same_state(got, want, what):
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(want[k], got[k]), f"{what}: {k} diverged"


def _journal(cfg):
    return faults.read_journal(os.path.join(cfg.log_dir, faults.JOURNAL_FILE))


@pytest.fixture(scope="module")
def baseline(chaos_data, tmp_path_factory):
    root = tmp_path_factory.mktemp("chaos_base")
    return _run_e2e(_e2e_cfg("base", root), chaos_data)


# (spec, how the recovery shows): "retry" = a RetryPolicy absorbed it;
# "resume" = the run crashed (no rung applies to a non-OOM failure in the
# port) and a fault-free --resume_training carried the round.
CHAOS = [
    ("ckpt_write:raise@2", "retry"),
    ("ckpt_write:torn@1", "retry"),    # publish_best's torn pair
    ("ckpt_write:torn@3", "retry"),
    ("dispatch:raise@5", "resume"),    # a train step in round 1
    ("dispatch:die@4", "resume"),      # ThreadDeath on the main thread
]


@pytest.mark.parametrize("spec,mode", CHAOS, ids=[c[0] for c in CHAOS])
def test_run_completes_or_resumes_bit_identical(spec, mode, chaos_data,
                                                baseline, tmp_path):
    threads_before = set(threading.enumerate())
    tag = spec.replace(":", "_").replace("@", "_")
    cfg = _e2e_cfg(tag, tmp_path)
    site_name = spec.split(":")[0]
    faults.configure(spec, seed=cfg.run_seed)
    try:
        state = _run_e2e(cfg, chaos_data)
        got_mode = "retry"
        assert faults.fault_counters()[site_name]["fires"] >= 1
        assert (_metric_max(cfg.log_dir, "fault_retries_total") or 0) >= 1
    except (Exception, faults.ThreadDeath):
        assert faults.fault_counters()[site_name]["fires"] >= 1
        assert _journal(cfg)["status"] == "crashed"
        faults.configure(None)
        state = _run_e2e(_e2e_cfg(tag, tmp_path, resume=True), chaos_data)
        got_mode = "resume"
    finally:
        faults.configure(None)
    assert got_mode == mode
    _assert_same_state(state, baseline, spec)
    assert _journal(cfg)["status"] == "finished"
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        extra = set(threading.enumerate()) - threads_before
        if not extra:
            break
        time.sleep(0.05)
    assert not extra, f"{spec}: orphaned threads {extra}"


def test_driver_arms_from_config_and_env_then_disarms(chaos_data, tmp_path,
                                                      monkeypatch):
    cfg = _e2e_cfg("armcfg", tmp_path / "a", rounds=1,
                   fault_spec="ckpt_write:raise@2")
    _run_e2e(cfg, chaos_data)
    assert (_metric_max(cfg.log_dir, "fault_retries_total") or 0) >= 1
    assert faults.active_spec() is None
    log = glob.glob(os.path.join(cfg.log_dir, "*.log"))[0]
    assert "fault injection ARMED: ckpt_write:raise@2" in open(log).read()
    monkeypatch.setenv("AL_FAULT_SPEC", "ckpt_write:raise@2")
    cfg2 = _e2e_cfg("armenv", tmp_path / "b", rounds=1)
    _run_e2e(cfg2, chaos_data)
    assert (_metric_max(cfg2.log_dir, "fault_retries_total") or 0) >= 1
    assert faults.active_spec() is None


def test_cli_plumbs_the_recovery_flags():
    cfg = cli.parse(["--dataset", "synthetic", "--arg_pool", "synthetic",
                     "--strategy",
                     "MarginSampler", "--fault_spec", "dispatch:delay@0.01",
                     "--resume_training"])
    assert cfg.fault_spec == "dispatch:delay@0.01"
    assert cfg.resume_training is True


@pytest.mark.parametrize("oom", ["injected", "torch"])
def test_oom_engages_batch_half_and_the_round_completes(chaos_data,
                                                        tmp_path, oom,
                                                        monkeypatch):
    """An allocator failure in a train step costs a round attempt: the
    round rolls back, batch_half halves the batch, the round completes,
    the journal lists the rung, and the next round starts at the full
    batch again."""
    cfg = _e2e_cfg(f"oom_{oom}", tmp_path)
    if oom == "injected":
        cfg.fault_spec = "dispatch:oom@2"
    else:
        from active_learning_tpu_torch.train import trainer as trainer_lib
        real = trainer_lib.Trainer.train_step
        calls = []

        def step(self, batch, *a, **kw):
            calls.append(batch["image"].shape[0])
            if len(calls) == 2:
                raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                             "allocate 20.00 GiB")
            return real(self, batch, *a, **kw)

        monkeypatch.setattr(trainer_lib.Trainer, "train_step", step)
    journals = []
    real_write = journal_lib.RoundJournal.write

    def record(self, **fields):
        journals.append(dict(fields))
        return real_write(self, **fields)

    monkeypatch.setattr(journal_lib.RoundJournal, "write", record)
    _run_e2e(cfg, chaos_data)
    log = open(glob.glob(os.path.join(cfg.log_dir, "*.log"))[0]).read()
    assert "engaging rung 'batch_half'" in log
    assert "reverted ['batch_half'] at the round boundary" in log
    assert any(j.get("degrade") == ["batch_half"] for j in journals)
    assert _journal(cfg)["status"] == "finished"
    assert (_metric_max(cfg.log_dir, "degrade_events") or 0) >= 1
    if oom == "torch":
        # Round 0 at 16, the failed step, the retried round at 8, round
        # 1 back at 16.
        assert calls[0] == 16 and 8 in calls and calls[-1] == 16


# -- preemption and resume ---------------------------------------------------------

class _PreemptAtEpochSink(NullSink):
    """Records a preemption request, as the signal handler does, when
    round ``rd``'s fit reaches ``epoch``."""

    def __init__(self, rd, epoch):
        self.name = f"rd_{rd}_validation_accuracy"
        self.epoch = epoch
        self.fired = False

    def log_metric(self, name, value, step=None):
        if not self.fired and step == self.epoch and name == self.name:
            self.fired = True
            preempt_lib._handler(signal.SIGTERM, None)


@pytest.mark.parametrize("rd", [0, 1])
def test_preemption_resumes_bit_identical(chaos_data, baseline, tmp_path,
                                          rd):
    cfg = _e2e_cfg(f"preempt{rd}", tmp_path)
    sink = _PreemptAtEpochSink(rd=rd, epoch=1)
    with pytest.raises(preempt_lib.PreemptionRequested):
        _run_e2e(cfg, chaos_data, sink=sink)
    assert sink.fired
    jr = _journal(cfg)
    assert jr["status"] == "preempted" and jr["signal"] == signal.SIGTERM
    assert jr["round"] == rd
    saved = glob.glob(os.path.join(cfg.ckpt_path, "*",
                                   "experiment_state.npz"))
    assert bool(saved) == (rd > 0)
    fit_state = os.path.join(cfg.ckpt_path, f"faults_preempt{rd}",
                             f"fit_state_rd_{rd}.json")
    assert json.load(open(fit_state))["epoch"] == 1
    state = _run_e2e(_e2e_cfg(f"preempt{rd}", tmp_path, resume=True),
                     chaos_data)
    _assert_same_state(state, baseline, f"round-{rd} preemption")
    log = "".join(open(p).read() for p in
                  glob.glob(os.path.join(cfg.log_dir, "*.log")))
    assert f"Resuming round {rd} training from epoch 2" in log


def test_resume_refusals(chaos_data, tmp_path):
    """No saved experiment and no preemption journal: refused.  A round-0
    preemption unlocks the resume only for the same experiment, and a
    journal preempted at a later round never does."""
    with pytest.raises(FileNotFoundError, match="no saved experiment"):
        _run_e2e(_e2e_cfg("none", tmp_path / "n", resume=True), chaos_data)
    cfg = _e2e_cfg("ident0", tmp_path)
    with pytest.raises(preempt_lib.PreemptionRequested):
        _run_e2e(cfg, chaos_data, sink=_PreemptAtEpochSink(rd=0, epoch=1))
    wrong = dataclasses.replace(_e2e_cfg("ident0", tmp_path, resume=True),
                                exp_hash="other")
    with pytest.raises(FileNotFoundError, match="no saved experiment"):
        _run_e2e(wrong, chaos_data)
    faults.RoundJournal(os.path.join(cfg.log_dir, faults.JOURNAL_FILE)
                        ).write(exp_name="faults", exp_hash="ident0",
                                round=1, status="preempted")
    with pytest.raises(FileNotFoundError, match="no saved experiment"):
        _run_e2e(_e2e_cfg("ident0", tmp_path, resume=True), chaos_data)


def test_degraded_sync_is_sticky_across_a_resume(chaos_data, tmp_path):
    cfg = _e2e_cfg("sticky", tmp_path, rounds=1)
    _run_e2e(cfg, chaos_data)
    faults.RoundJournal(os.path.join(cfg.log_dir, faults.JOURNAL_FILE)
                        ).write(grad_allreduce="f32_degraded")
    cfg2 = dataclasses.replace(_e2e_cfg("sticky", tmp_path, resume=True,
                                        rounds=2), grad_allreduce="int8")
    _run_e2e(cfg2, chaos_data)
    assert cfg2.grad_allreduce == "f32"
    assert _journal(cfg2)["grad_allreduce"] == "f32_degraded"
    log = "".join(open(p).read() for p in
                  glob.glob(os.path.join(cfg.log_dir, "*.log")))
    assert "keeping f32 for the resumed segment" in log


# -- a real SIGTERM to a child process -----------------------------------------------

_CHILD = r"""
import sys
sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
from test_torch_faults import _e2e_cfg, _run_e2e
from active_learning_tpu_torch.data.synthetic import get_data_synthetic
from active_learning_tpu_torch.faults.preempt import PreemptionRequested

data = get_data_synthetic(n_train=96, n_test=32, num_classes=4,
                          image_size=8, seed=5)
cfg = _e2e_cfg("sigterm", {root!r}, resume={resume}, n_epoch={n_epoch},
               fault_spec={spec!r})
print("CHILD_READY", flush=True)
try:
    _run_e2e(cfg, data)
except PreemptionRequested:
    print("CHILD_PREEMPTED", flush=True)  # the CLI's exit 0
    sys.exit(0)
print("CHILD_FINISHED", flush=True)
"""

SIG_EPOCHS = 6


def _spawn(root, *, resume=False, spec=None):
    code = _CHILD.format(repo=REPO, tests=os.path.join(REPO, "tests"),
                         root=str(root), resume=resume, n_epoch=SIG_EPOCHS,
                         spec=spec)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_sigterm_mid_round_resumes_bit_exact(chaos_data, tmp_path):
    """A child running the experiment on the CPU takes a real SIGTERM in
    round 0's fit (every train step stretched by ``dispatch:delay`` so
    the window is wide), exits 0 with the journal saying preempted; a
    second child resumes; the state equals the unbroken run's."""
    want = _run_e2e(_e2e_cfg("sigbase", tmp_path / "base",
                             n_epoch=SIG_EPOCHS), chaos_data)
    root = tmp_path / "kill"
    cfg = _e2e_cfg("sigterm", root, n_epoch=SIG_EPOCHS)
    proc = _spawn(root, spec="dispatch:delay@0.05")
    try:
        deadline = time.monotonic() + 300
        in_fit = False
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                pytest.fail("child exited before the kill: "
                            + proc.communicate()[1][-2000:])
            jr = _journal(cfg) or {}
            if jr.get("round") == 0 and jr.get("phase") == "init":
                in_fit = True
                break
            time.sleep(0.02)
        assert in_fit, "child never reached round 0's fit"
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err[-2000:]
        assert "CHILD_PREEMPTED" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    jr = _journal(cfg)
    assert jr["status"] == "preempted" and jr["signal"] == signal.SIGTERM
    resumed = _spawn(root, resume=True)
    out, err = resumed.communicate(timeout=300)
    assert resumed.returncode == 0, err[-2000:]
    assert "CHILD_FINISHED" in out
    with np.load(glob.glob(os.path.join(cfg.ckpt_path, "*",
                                        "experiment_state.npz"))[0]) as st:
        state = {k: st[k] for k in st.files}
    _assert_same_state(state, want, "SIGTERM resume")
