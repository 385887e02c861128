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
run.

Left out, and queued in ROADMAP.md: resuming a saved run, profiling
windows, fault injection and the degradation ladder, the pipelined
round and streaming.
"""

from __future__ import annotations

import dataclasses
import json
import uuid
from datetime import date
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import (ExperimentConfig, LoaderConfig, OptimizerConfig,
                      SchedulerConfig, TrainConfig, config_to_dict)
from ..data import get_data
from ..data.synthetic import get_data_synthetic
from ..device import set_float32_precision
from ..initial_pool import generate_eval_idxs, generate_init_lb_idxs
from ..models.factory import get_network
from ..ops import kernel_launches
from ..parallel import mesh as mesh_lib
from ..pool import PoolState
from ..strategies import get_strategy
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
    raises, and the run ends rather than train on another path."""
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
                     mesh: Optional[mesh_lib.Mesh] = None):
    """Wire data -> model -> trainer -> pool -> strategy from one config
    and label the initial pool.  ``data`` (a (train, test, al) triple),
    ``train_cfg``, ``model`` and ``mesh`` (default: ``make_mesh`` from
    the config) can be injected."""
    if mesh is None:
        mesh = mesh_lib.make_mesh(cfg.num_devices, cfg.device)
    device = mesh.device
    logger = get_logger()
    if train_cfg is None:
        train_cfg = arg_pools_lib.get_train_config(cfg.arg_pool,
                                                   cfg.dataset)
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
                f"learning probe (accuracy delta {delta} vs bound "
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
        data = get_data(cfg.dataset)
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


def _run(cfg, sink, data, train_cfg, model, mesh):
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
    if sink is None:
        sink = (JsonlSink(cfg.log_dir, experiment_key=cfg.exp_hash)
                if mesh.is_coordinator else NullSink())
    strategy = build_experiment(cfg, sink=sink, data=data,
                                train_cfg=train_cfg, model=model, mesh=mesh)
    if strategy.trainer.grad_allreduce_degraded:
        sink.log_metric("grad_allreduce_degraded", 1, step=-1)
    sink.log_parameters(config_to_dict(cfg))
    init_pool_size = cfg.resolved_init_pool_size()
    logger.info(f"Experiment Name: {cfg.exp_name}")
    logger.info(f"Dataset: {cfg.dataset}")
    logger.info(f"Strategy: {cfg.strategy}")
    logger.info(f"Budget used before starting: {strategy.pool.num_labeled}")
    logger.info(f"Log file name: {log_filename}")
    logger.info(f"Device: {strategy.trainer.device}")
    logger.info(f"Mesh: {mesh.describe()}, gradient sync "
                f"{strategy.trainer.grad_sync}"
                + (f" ({strategy.trainer.grad_sync_form} wire form)"
                   if strategy.trainer.grad_sync_form else ""))

    for rd in range(cfg.rounds):
        strategy.round = rd
        logger.info(f"Active Learning Round {rd} start.")
        # Round 0 queries only when there is no initial pool.
        al_round_0 = rd == 0 and init_pool_size == 0
        if rd > 0 or al_round_0:
            if al_round_0:
                strategy.init_network_weights()
            with phase_timer("query_time", rd, sink, logger):
                labeled_idxs, cur_cost = strategy.query(cfg.round_budget)
            strategy.update(labeled_idxs, cur_cost)
        with phase_timer("init_network_weights_time", rd, sink, logger):
            strategy.init_network_weights()
        with phase_timer("train_time", rd, sink, logger):
            strategy.train()
        with phase_timer("load_best_ckpt_time", rd, sink, logger):
            strategy.load_best_ckpt()
        with phase_timer("test_time", rd, sink, logger):
            strategy.test()
        if mesh.is_coordinator:
            resume_lib.save_experiment(strategy, cfg)
        if len(strategy.available_query_idxs(shuffle=False)) == 0:
            logger.info("Finished querying all Images!")
            break
    logger.info(f"Kernel launches: {json.dumps(kernel_launches())}")
    sink.close()
    return strategy
