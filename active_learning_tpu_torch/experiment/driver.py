"""The experiment driver (the JAX package's ``experiment/driver.py``,
core round loop): build everything from an ``ExperimentConfig`` and run
the active-learning rounds, verb for verb as the reference does:

    for rd in 0..rounds-1:
        query -> update          [skipped at rd 0 unless init_pool_size == 0]
        init_network_weights
        train                    (per-round fit with early stopping)
        load_best_ckpt
        test
        save_experiment

with per-phase wall clocks in the log and the metrics sink, and the log
lines of the JAX package's ``experiment/driver.py``.

On a mesh of N ranks (``parallel/mesh.py``; the CLI's ``--num_devices``
starts them, or the multi-host rendezvous flags join them) every rank
runs this loop on the same seeds: training and scoring are split over
the ranks, selection runs on every rank on the same scores.  Only the
coordinator writes metrics, checkpoints and the experiment state; each
rank logs to its own file.  ``--scale_batch auto`` applies the
large-batch rules, and an int8 gradient sync must first pass the
learning probe (``run_grad_allreduce_probe``): an accuracy delta over
the bound degrades the run to the f32 sync with a warning and a
``grad_allreduce_degraded`` metric; a probe that cannot run ends the
run, but an injected ``grad_probe`` fault is a broken probe and
degrades it.

Crash safety (the JAX package's ``driver.py:623-681``, ``:788-950``,
``:1011-1130``, ``:1172-1185``), on one rank:

  * ``--fault_spec`` / ``$AL_FAULT_SPEC`` arm the fault registry for the
    run (logged "fault injection ARMED"); the run disarms only what it
    armed;
  * SIGTERM/SIGINT are recorded (``faults/preempt.py``) and honoured at
    the trainer's epoch boundaries and the driver's phase boundaries;
    the journal then says ``preempted`` and ``PreemptionRequested``
    propagates (the CLI exits 0);
  * ``--resume_training`` loads the last completed round
    (``experiment/resume.py``) and lets the first fit consume its
    mid-round fit state; with no saved round, a journal that records a
    round-0 preemption of this same experiment replays round 0 from its
    seeds; anything else is refused;
  * the round journal (``round_journal.json`` in ``--log_dir``) records
    the identity, the round, phase and attempt, the labeled set's size
    and CRC, the active rungs and the final status; an f32 gradient sync
    the probe degraded to stays f32 across a resume;
  * each round runs as attempts: a failed attempt rolls the strategy
    back to its round-start snapshot (pool, rng, init state, the model's
    weights and BatchNorm buffers, the sampler's aux state; the
    attempted round's fit state deleted), frees the attempt's device
    memory and asks the degradation ladder (``faults/ladder.py``) for a
    rung; the round save retries transient failures.

Left out, and queued in ROADMAP.md: resume and fault injection on more
than one rank, profiling windows, telemetry, the pipelined round and
streaming.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import os
import uuid
import zlib
from datetime import date
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import faults
from ..config import (ExperimentConfig, LoaderConfig, OptimizerConfig,
                      SchedulerConfig, TrainConfig, config_to_dict)
from ..data import get_data
from ..data.synthetic import get_data_synthetic
from ..device import set_float32_precision
from ..faults import ladder as ladder_lib
from ..faults import preempt as preempt_lib
from ..initial_pool import generate_eval_idxs, generate_init_lb_idxs
from ..models.factory import get_network
from ..ops import kernel_launches
from ..parallel import mesh as mesh_lib
from ..pool import PoolState
from ..strategies import get_strategy
from ..train import checkpoint as ckpt_lib
from ..train.optim import apply_batch_scaling
from ..train.trainer import Trainer
from ..utils.logging import get_logger, setup_logging
from ..utils.metrics import JsonlSink, MetricsSink, NullSink
from ..utils.tracing import phase_timer
from . import arg_pools as arg_pools_lib
from . import resume as resume_lib


# The int8 gradient sync's accuracy-delta bound: the probe model trained
# through the quantized sync must land within this much test accuracy
# of its f32 twin (same seeds, same data) or the run degrades to f32.
INT8_PROBE_MAX_ACC_DELTA = 0.05


class _Probe(torch.nn.Module):
    """The learning probe's model (JAX ``driver.py:166-180``): flatten,
    a 32-wide tanh projection, a linear head."""

    freeze_feature = False

    def __init__(self, in_dim: int, num_classes: int = 4,
                 feat_dim: int = 32):
        super().__init__()
        self.proj = torch.nn.Linear(in_dim, feat_dim)
        self.linear = torch.nn.Linear(feat_dim, num_classes)
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for lin in (self.proj, self.linear):
                fan_in = lin.weight.shape[1]
                lin.weight.copy_(torch.randn(lin.weight.shape,
                                             generator=gen) / fan_in ** 0.5)
                lin.bias.zero_()

    def forward(self, x: torch.Tensor, return_features: bool = False):
        emb = torch.tanh(self.proj(x.reshape(x.shape[0], -1).float()))
        logits = self.linear(emb)
        return (logits, emb) if return_features else logits


def run_grad_allreduce_probe(mesh: mesh_lib.Mesh, mode: str = "int8"
                             ) -> Tuple[bool, float]:
    """The learning probe gating the int8 gradient sync (JAX
    ``driver.py:136-221``): train one tiny model twice over the live
    mesh, through the f32 sync and through the quantized sync as the run
    would build it (``mode`` resolves the same wire form), on the same
    seeds and the deterministic view, and compare test accuracy.  A
    wrong quantized reduction keeps the loss moving while computing the
    wrong numbers; only an accuracy comparison catches it.  Returns
    ``(ok, delta)``.  Only the accuracy decides: a probe that cannot run
    (a kernel that does not build or launch, a collective that fails)
    raises, and the run ends rather than train on another path.  An
    injected ``grad_probe`` fault is a broken probe: ``(False, None)``."""
    try:
        faults.site("grad_probe")
    except (faults.InjectedFault, faults.ThreadDeath) as exc:
        get_logger().warning(f"grad_allreduce probe failed to run: {exc!r}")
        return False, None
    data = get_data_synthetic(n_train=96, n_test=128, num_classes=4,
                              image_size=16, seed=7)
    base_cfg = TrainConfig(
        eval_split=0.1, loader_tr=LoaderConfig(batch_size=16),
        loader_te=LoaderConfig(batch_size=16),
        optimizer=OptimizerConfig(name="sgd", lr=0.3),
        scheduler=SchedulerConfig(name="cosine", t_max=8))

    def fit_acc(ar_mode: str) -> float:
        model = _Probe(16 * 16 * 3).to(mesh.device)
        trainer = Trainer(
            model, dataclasses.replace(base_cfg, grad_allreduce=ar_mode),
            4, mesh=mesh)
        trainer.fit(data[2], np.arange(len(data[2])), data[2],
                    np.array([], dtype=np.int64), n_epoch=8,
                    es_patience=0, rng=np.random.default_rng(1))
        metrics = trainer.evaluate(data[1], np.arange(len(data[1])))
        return float(metrics["accuracy"])

    delta = round(abs(fit_acc("f32") - fit_acc(mode)), 4)
    return delta <= INT8_PROBE_MAX_ACC_DELTA, delta


def build_experiment(cfg: ExperimentConfig,
                     sink: Optional[MetricsSink] = None, data=None,
                     train_cfg: Optional[TrainConfig] = None, model=None,
                     mesh: Optional[mesh_lib.Mesh] = None,
                     skip_init_pool: bool = False):
    """Wire data -> model -> trainer -> pool -> strategy from one config
    and label the initial pool (not with ``skip_init_pool``: a resume
    restores the pool instead).  ``data`` (a (train, test, al) triple),
    ``train_cfg``, ``model`` and ``mesh`` (default: ``make_mesh`` from
    the config) can be injected."""
    if mesh is None:
        mesh = mesh_lib.make_mesh(cfg.num_devices, cfg.device)
    device = mesh.device
    logger = get_logger()
    if train_cfg is None:
        train_cfg = arg_pools_lib.get_train_config(
            cfg.arg_pool, cfg.dataset, pretrained_root=cfg.pretrained_root)
    # --fused_optimizer / --optim_state_dtype / --grad_allreduce beat the
    # arg pool.
    overrides = {k: getattr(cfg, k) for k in ("fused_optimizer",
                                              "optim_state_dtype",
                                              "grad_allreduce")
                 if getattr(cfg, k) is not None}
    if overrides:
        train_cfg = dataclasses.replace(train_cfg, **overrides)
    scale_mode = cfg.scale_batch or "off"
    if scale_mode not in ("auto", "off"):
        raise ValueError(
            f"scale_batch={scale_mode!r} is not one of 'auto'/'off'")
    if scale_mode == "auto":
        train_cfg, scaled = apply_batch_scaling(train_cfg, mesh.world_size)
        if scaled:
            bs = train_cfg.loader_tr.batch_size
            logger.info(
                f"scale_batch=auto: global batch {bs} ({mesh.world_size} "
                f"ranks x {bs // mesh.world_size}), lr "
                f"{train_cfg.optimizer.lr:g}, warmup "
                f"{train_cfg.scheduler.warmup_epochs} epochs (large-batch "
                "scaling rules)")
    # The int8 sync is gated, not just flagged: it engages only on more
    # than one rank AND when the learning probe passes.
    degraded = False
    requested = train_cfg.grad_allreduce or "f32"
    if mesh_lib.resolve_grad_allreduce(requested, mesh) == "int8":
        wire = mesh_lib.resolve_int8_wire(requested, mesh)
        ok, delta = run_grad_allreduce_probe(mesh, requested)
        if not ok:
            logger.warning(
                f"grad_allreduce={requested} ({wire} wire form) FAILED the "
                f"learning probe (accuracy delta "
                f"{delta if delta is not None else 'n/a'} vs bound "
                f"{INT8_PROBE_MAX_ACC_DELTA}); degrading this run to the "
                "f32 gradient sync")
            train_cfg = dataclasses.replace(train_cfg, grad_allreduce="f32")
            degraded = True
        else:
            logger.info(
                f"grad_allreduce={requested}: learning probe passed on the "
                f"{wire} wire form (accuracy delta {delta} <= "
                f"{INT8_PROBE_MAX_ACC_DELTA})")
    if data is None:
        data = get_data(cfg.dataset, data_path=cfg.dataset_dir,
                        debug_mode=cfg.debug_mode,
                        imbalance_args=cfg.imbalance,
                        download=cfg.download_data)
    train_set, test_set, al_set = data
    num_classes = al_set.num_classes
    if model is None:
        # --dtype / --bn_stats_dtype / --stem beat the arg pool's
        # TrainConfig; "auto" is bf16 on the card, float32 on the CPU.
        model = get_network(cfg.dataset, cfg.model,
                            num_classes=num_classes,
                            dtype=cfg.dtype or train_cfg.dtype,
                            stem=cfg.stem or train_cfg.stem,
                            bn_stats_dtype=(cfg.bn_stats_dtype
                                            or train_cfg.bn_stats_dtype),
                            device=device,
                            freeze_feature=cfg.freeze_feature)
    set_float32_precision(model.dtype)
    trainer = Trainer(model, train_cfg, num_classes, mesh=mesh)
    trainer.grad_allreduce_degraded = degraded

    targets = train_set.targets[: len(train_set)]
    init_pool_size = cfg.resolved_init_pool_size()
    eval_idxs = generate_eval_idxs(targets, num_classes,
                                   ratio=train_cfg.eval_split,
                                   random_seed=cfg.eval_split_seed)
    if init_pool_size == 0:
        init_idxs = np.zeros(0, dtype=np.int64)
    else:
        init_idxs = generate_init_lb_idxs(
            targets, num_classes, eval_idxs, init_pool_size,
            init_pool_type=cfg.init_pool_type,
            random_seed=cfg.init_pool_seed)
    pool = PoolState.create(len(al_set), eval_idxs)
    rng = np.random.default_rng(cfg.run_seed)
    strategy = get_strategy(cfg.strategy)(
        train_set, al_set, test_set, model, trainer, pool, cfg, train_cfg,
        sink=sink, rng=rng)
    if not skip_init_pool:
        strategy.update(init_idxs, len(init_idxs))
    return strategy


def run_experiment(cfg: ExperimentConfig,
                   sink: Optional[MetricsSink] = None, data=None,
                   train_cfg: Optional[TrainConfig] = None, model=None,
                   mesh: Optional[mesh_lib.Mesh] = None):
    """Run the experiment on this rank of ``mesh`` (default: the
    config's; with the multi-host fields set, this process joins the
    group first and leaves it at the end); returns the finished
    Strategy."""
    joined = False
    if mesh is None:
        if not (dist.is_available() and dist.is_initialized()):
            joined = mesh_lib.initialize_distributed(
                cfg.coordinator_address, cfg.num_processes, cfg.process_id,
                backend=mesh_lib.default_backend(cfg.device))
        mesh = mesh_lib.make_mesh(cfg.num_devices, cfg.device)
    try:
        return _run(cfg, sink, data, train_cfg, model, mesh)
    finally:
        if joined:
            dist.destroy_process_group()


def _labeled_crc(pool: PoolState) -> int:
    """CRC of the labeled mask: the journal's digest of the labeled set."""
    return int(zlib.crc32(np.ascontiguousarray(pool.labeled).tobytes()))


def _round_snapshot(strategy) -> dict:
    """Everything a round mutates, at its start, so a failed attempt can
    be rolled back and retried bit for bit: the pool, the rng, the init
    state, the best epoch, the model's weights and BatchNorm buffers on
    the host (round r's query scores with round r-1's best weights), and
    the sampler's aux state."""
    return {
        "pool": strategy.pool.to_arrays(),
        "rng_state": copy.deepcopy(strategy.rng.bit_generator.state),
        "init_key": strategy.init_key.copy(),
        "best_epoch": int(strategy.best_epoch),
        "best_perf": float(strategy.best_perf),
        "resume_next_fit": bool(strategy.resume_next_fit),
        "variables": {k: v.detach().to("cpu", copy=True)
                      for k, v in strategy.model.state_dict().items()},
        "aux": strategy.aux_state_bytes(),
    }


def _restore_round_snapshot(strategy, snap: dict, round_idx: int) -> None:
    """Roll the strategy back to ``snap``.  The attempted round's fit
    state is deleted too: it was written under an rng chain this restore
    rewinds.  The weights are copied into the model's own tensors, which
    bumps their versions, so the weight caches follow."""
    cfg = strategy.cfg
    fit_state = ckpt_lib.weight_paths(cfg.ckpt_path, cfg.exp_name,
                                      strategy.exp_hash,
                                      round_idx)["fit_state"]
    ckpt_lib.delete_fit_state(fit_state)
    strategy.pool = PoolState.from_arrays(snap["pool"])
    strategy.rng.bit_generator.state = copy.deepcopy(snap["rng_state"])
    strategy.set_init_state(*(int(v) for v in snap["init_key"]))
    strategy.best_epoch = snap["best_epoch"]
    strategy.best_perf = snap["best_perf"]
    strategy.resume_next_fit = snap["resume_next_fit"]
    strategy.model.load_state_dict(snap["variables"], strict=True)
    if snap["aux"] is not None:
        strategy.restore_aux_state(snap["aux"])


def _release_device_memory(device) -> None:
    """Free what a failed attempt left: its frames and tensors, then the
    allocator's cached blocks, so a retry at half the batch does not
    fail on memory the dead attempt still holds."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _run(cfg, sink, data, train_cfg, model, mesh):
    fault_spec = cfg.fault_spec or os.environ.get("AL_FAULT_SPEC")
    if mesh.world_size > 1 and (cfg.resume_training or fault_spec):
        raise NotImplementedError(
            "--resume_training and fault injection on more than one rank "
            "are not ported yet (ROADMAP.md)")
    # Arm only when a spec is given: a caller that armed the registry
    # itself keeps its arming.  What this run arms, it disarms.
    if fault_spec:
        faults.configure(fault_spec, seed=cfg.run_seed)
    try:
        return _run_armed(cfg, sink, data, train_cfg, model, mesh,
                          fault_spec)
    finally:
        if fault_spec:
            faults.configure(None)


def _run_armed(cfg, sink, data, train_cfg, model, mesh, fault_spec):
    if cfg.exp_hash is None:
        cfg.exp_hash = uuid.uuid4().hex[:9]
        if mesh.world_size > 1:
            # Every rank must agree on the hash: it names the shared
            # checkpoint directory the other ranks read.
            agreed = mesh.broadcast(torch.tensor(
                [int(cfg.exp_hash, 16)], dtype=torch.int64))
            cfg.exp_hash = f"{int(agreed[0]):09x}"
    today = date.today()
    log_filename = f"{cfg.exp_hash}_{today.month:02d}{today.day:02d}.log"
    if mesh.world_size > 1:
        log_filename = log_filename.replace(".log", f"_p{mesh.rank}.log")
    logger = setup_logging(cfg.log_dir, log_filename, mesh.rank)
    if fault_spec:
        logger.warning(f"fault injection ARMED: {fault_spec} "
                       f"(seed {cfg.run_seed}); disarmed at run exit")

    journal_path = os.path.join(cfg.log_dir, faults.JOURNAL_FILE)
    resuming = cfg.resume_training and resume_lib.has_saved_experiment(cfg)
    preempted_round0 = False
    if cfg.resume_training and not resuming:
        # No completed round on disk.  A run preempted during round 0
        # has only its mid-fit state: the journal records it, and round
        # 0 replays from its seeds up to the fit that consumes the state.
        # The identity check matters: the journal belongs to log_dir, not
        # to the experiment.
        prior = faults.read_journal(journal_path)
        if (prior is not None and prior.get("status") == "preempted"
                and prior.get("exp_hash") == cfg.exp_hash
                and prior.get("exp_name") == cfg.exp_name
                and int(prior.get("round", -1)) == 0):
            preempted_round0 = True
        else:
            raise FileNotFoundError(
                f"--resume_training: no saved experiment state for "
                f"exp_name={cfg.exp_name!r} exp_hash={cfg.exp_hash!r} under "
                f"{cfg.ckpt_path!r}; pass the original --exp_hash/--ckpt_path")
    if sink is None:
        key = (resume_lib.saved_experiment_key(cfg) if resuming
               else cfg.exp_hash)
        sink = (JsonlSink(cfg.log_dir, experiment_key=key)
                if mesh.is_coordinator else NullSink())
    journal = faults.RoundJournal(journal_path, enabled=mesh.is_coordinator)
    # A run whose probe degraded the int8 sync to f32 stays on f32 when
    # resumed: a probe that passed now would splice int8 rounds onto f32
    # ones under a journal that still says degraded.
    prior_journal = faults.read_journal(journal_path)
    sticky_degrade = bool(
        (resuming or preempted_round0) and prior_journal
        and prior_journal.get("grad_allreduce") == "f32_degraded")
    if sticky_degrade:
        logger.info(
            "resume: the original run degraded grad_allreduce to f32 "
            "(journaled); keeping f32 for the resumed segment instead "
            "of re-probing")
        cfg.grad_allreduce = "f32"
    journal.write(exp_name=cfg.exp_name, exp_hash=cfg.exp_hash)
    if sticky_degrade:
        journal.write(grad_allreduce="f32_degraded")

    status = "crashed"
    run_retries0 = faults.retry_counters()["total"]
    preempt_lib.reset()
    # Handlers on one rank only: N ranks would have to agree on the
    # boundary at which they stop.
    prev_handlers = (preempt_lib.install(logger) if mesh.world_size == 1
                     else None)
    try:
        strategy = build_experiment(cfg, sink=sink, data=data,
                                    train_cfg=train_cfg, model=model,
                                    mesh=mesh, skip_init_pool=resuming)
        if strategy.trainer.grad_allreduce_degraded:
            journal.write(grad_allreduce="f32_degraded")
            sink.log_metric("degrade_events", 1, step=-1)
            sink.log_metric("grad_allreduce_degraded", 1, step=-1)
        if resuming:
            start_round = resume_lib.load_experiment(strategy, cfg)
            strategy.resume_next_fit = True
        else:
            start_round = 0
            sink.log_parameters(config_to_dict(cfg))
            if preempted_round0:
                logger.info(
                    "resume: journal records a round-0 preemption; "
                    "replaying round 0 and consuming its mid-fit state")
                strategy.resume_next_fit = True
        init_pool_size = cfg.resolved_init_pool_size()
        logger.info(f"Experiment Name: {cfg.exp_name}")
        logger.info(f"Dataset: {cfg.dataset}")
        logger.info(f"Strategy: {cfg.strategy}")
        logger.info(
            f"Budget used before starting: {strategy.pool.num_labeled}")
        logger.info(f"Log file name: {log_filename}")
        logger.info(f"Device: {strategy.trainer.device}")
        logger.info(f"Mesh: {mesh.describe()}, gradient sync "
                    f"{strategy.trainer.grad_sync}"
                    + (f" ({strategy.trainer.grad_sync_form} wire form)"
                       if strategy.trainer.grad_sync_form else ""))

        ladder = ladder_lib.DegradationLadder(strategy, logger=logger,
                                              sink=sink, journal=journal)
        save_retry = faults.RetryPolicy(site="experiment_save",
                                        classify=faults.classify_exception)

        def boundary(rd: int, phase: str) -> None:
            """A driver safe point: journal where the run is, then honour
            a recorded preemption."""
            journal.write(round=rd, phase=phase)
            preempt_lib.check()

        def run_round(rd: int, attempt: int) -> None:
            strategy.round = rd
            journal.write(status="running", round=rd, phase="round_start",
                          attempt=attempt,
                          labeled=strategy.pool.num_labeled,
                          labeled_crc=_labeled_crc(strategy.pool),
                          degrade=list(ladder.active),
                          pipeline_armed=False)
            logger.info(f"Active Learning Round {rd} start.")
            # Round 0 queries only when there is no initial pool.
            al_round_0 = rd == 0 and init_pool_size == 0
            if rd > 0 or al_round_0:
                if al_round_0:
                    strategy.init_network_weights()
                with phase_timer("query_time", rd, sink, logger):
                    labeled_idxs, cur_cost = strategy.query(cfg.round_budget)
                strategy.update(labeled_idxs, cur_cost)
                boundary(rd, "query")
            with phase_timer("init_network_weights_time", rd, sink, logger):
                strategy.init_network_weights()
            boundary(rd, "init")
            with phase_timer("train_time", rd, sink, logger):
                strategy.train()
            boundary(rd, "train")
            with phase_timer("load_best_ckpt_time", rd, sink, logger):
                strategy.load_best_ckpt()
            with phase_timer("test_time", rd, sink, logger):
                strategy.test()
            # No preemption check between test and save: the completed
            # round is persisted first.
            if mesh.is_coordinator:
                save_retry.call(resume_lib.save_experiment, strategy, cfg)
            cfg.resume_training = True  # a crash after this resumes
            journal.write(round=rd, phase="round_end",
                          labeled=strategy.pool.num_labeled,
                          labeled_crc=_labeled_crc(strategy.pool))

        for rd in range(start_round, cfg.rounds):
            preempt_lib.check()
            # Each round starts at full capability.
            ladder.relax(rd)
            snapshot = _round_snapshot(strategy)
            for attempt in range(ladder.max_attempts()):
                failed = False
                try:
                    run_round(rd, attempt)
                    break
                except preempt_lib.PreemptionRequested:
                    raise
                except (Exception, faults.ThreadDeath) as exc:
                    if ladder.escalate(exc, rd) is None:
                        raise
                    _restore_round_snapshot(strategy, snapshot, rd)
                    failed = True
                if failed:
                    # Outside the except block: its traceback is gone.
                    _release_device_memory(strategy.trainer.device)
            sink.log_metric("fault_retries_total",
                            faults.retry_counters()["total"] - run_retries0,
                            step=rd)
            if len(strategy.available_query_idxs(shuffle=False)) == 0:
                logger.info("Finished querying all Images!")
                break
        status = "finished"
        journal.write(status="finished")
    except preempt_lib.PreemptionRequested as exc:
        # Every durable artifact is consistent: the resumed run
        # reproduces the uninterrupted one.
        status = "preempted"
        journal.write(status="preempted", signal=int(exc.signum))
        logger.info(
            "preemption: durable state checkpointed; re-run with "
            "--resume_training to continue bit-identically")
        raise
    finally:
        preempt_lib.uninstall(prev_handlers)
        if status == "crashed":
            journal.write(status="crashed")
        logger.info(f"Kernel launches: {json.dumps(kernel_launches())}")
        sink.close()
    return strategy
