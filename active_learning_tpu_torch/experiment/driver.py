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

with per-phase wall clocks in the log and the metrics sink, and the JAX
driver's log lines.  Left out, and queued in ROADMAP.md: resuming a
saved run, profiling windows, fault injection and the degradation
ladder, the pipelined round, streaming, multi-host and the int8
gradient probe.
"""

from __future__ import annotations

import dataclasses
import json
import uuid
from datetime import date
from typing import Optional

import numpy as np

from ..config import ExperimentConfig, TrainConfig, config_to_dict
from ..data import get_data
from ..device import resolve_device, set_float32_precision
from ..initial_pool import generate_eval_idxs, generate_init_lb_idxs
from ..models.factory import get_network
from ..ops import kernel_launches
from ..pool import PoolState
from ..strategies import get_strategy
from ..train.trainer import Trainer
from ..utils.logging import setup_logging
from ..utils.metrics import JsonlSink, MetricsSink
from ..utils.tracing import phase_timer
from . import arg_pools as arg_pools_lib
from . import resume as resume_lib


def build_experiment(cfg: ExperimentConfig,
                     sink: Optional[MetricsSink] = None, data=None,
                     train_cfg: Optional[TrainConfig] = None, model=None):
    """Wire data -> model -> trainer -> pool -> strategy from one config
    and label the initial pool.  ``data`` (a (train, test, al) triple),
    ``train_cfg`` and ``model`` can be injected by tests."""
    device = resolve_device(cfg.device)
    if train_cfg is None:
        train_cfg = arg_pools_lib.get_train_config(cfg.arg_pool,
                                                   cfg.dataset)
    # --fused_optimizer / --optim_state_dtype beat the arg pool.
    overrides = {k: getattr(cfg, k) for k in ("fused_optimizer",
                                              "optim_state_dtype")
                 if getattr(cfg, k) is not None}
    if overrides:
        train_cfg = dataclasses.replace(train_cfg, **overrides)
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
    trainer = Trainer(model, train_cfg, num_classes, device)

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
                   train_cfg: Optional[TrainConfig] = None, model=None):
    """Run the experiment; returns the finished Strategy."""
    if cfg.exp_hash is None:
        cfg.exp_hash = uuid.uuid4().hex[:9]
    today = date.today()
    log_filename = f"{cfg.exp_hash}_{today.month:02d}{today.day:02d}.log"
    logger = setup_logging(cfg.log_dir, log_filename)
    if sink is None:
        sink = JsonlSink(cfg.log_dir, experiment_key=cfg.exp_hash)
    strategy = build_experiment(cfg, sink=sink, data=data,
                                train_cfg=train_cfg, model=model)
    sink.log_parameters(config_to_dict(cfg))
    init_pool_size = cfg.resolved_init_pool_size()
    logger.info(f"Experiment Name: {cfg.exp_name}")
    logger.info(f"Dataset: {cfg.dataset}")
    logger.info(f"Strategy: {cfg.strategy}")
    logger.info(f"Budget used before starting: {strategy.pool.num_labeled}")
    logger.info(f"Log file name: {log_filename}")
    logger.info(f"Device: {strategy.trainer.device}")

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
        resume_lib.save_experiment(strategy, cfg)
        if len(strategy.available_query_idxs(shuffle=False)) == 0:
            logger.info("Finished querying all Images!")
            break
    logger.info(f"Kernel launches: {json.dumps(kernel_launches())}")
    sink.close()
    return strategy
