"""The active-learning Strategy engine (the JAX package's
``strategies/base.py``): owns the model, the trainer, the pool state and
the metrics sink of one experiment, and composes them into the
reference's verbs:

    query(budget) -> (labeled_idxs, cost)   [per sampler]
    update(labeled_idxs, cost)
    init_network_weights()
    train()
    load_best_ckpt()
    test()

All randomness of a round flows from one ``np.random.Generator`` drawn
with the JAX package's calls in its order: the constructor takes the
init-weight seed, each fit takes its generator seed and its epoch
permutations, and RandomSampler its shuffles.  So picks and saved state
match the reference's wherever the model's scores do.  The torch weight
init itself differs from flax's.

A resumed experiment (``experiment/resume.py``) restores the pool, the
rng, the init state (``set_init_state``) and the sampler's own state
(``restore_aux_state``); ``resume_next_fit`` lets the next fit, and
only that one, consume a mid-round fit state.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig, TrainConfig
from ..data.cache import device_prefetch, device_put
from ..data.core import Dataset
from ..data.pipeline import (batch_index_lists, gather_batch, ordered_map,
                             padded_batch_layout)
from ..models.resnet import init_weights
from ..models.weights import load_flax_variables
from ..parallel import mesh as mesh_lib
from ..pool import PoolState
from ..registry import STRATEGIES
from ..train import checkpoint as ckpt_lib
from ..train.trainer import Trainer
from ..utils.logging import get_logger
from ..utils.pretrained import apply_pretrained
from ..utils.metrics import MetricsSink, NullSink
from . import scoring


class Strategy:
    """Base class; subclasses implement ``query``."""

    name = "Strategy"

    def __init__(self, train_set: Dataset, al_set: Dataset,
                 test_set: Optional[Dataset], model: torch.nn.Module,
                 trainer: Trainer, pool: PoolState, cfg: ExperimentConfig,
                 train_cfg: TrainConfig, sink: Optional[MetricsSink] = None,
                 rng: Optional[np.random.Generator] = None):
        self.train_set = train_set
        self.al_set = al_set
        self.test_set = test_set
        self.model = model
        self.trainer = trainer
        self.pool = pool
        self.cfg = cfg
        self.train_cfg = train_cfg
        self.sink = sink if sink is not None else NullSink()
        self.rng = (rng if rng is not None
                    else np.random.default_rng(cfg.run_seed))
        self.logger = get_logger()
        self.num_classes = al_set.num_classes
        self.best_epoch = 0
        self.best_perf = 0.0
        self.last_test_acc: Optional[float] = None
        self._score_steps: Dict[str, scoring.Step] = {}
        # The last scoring pass: rows, wall seconds, rows decoded.
        self.last_scoring: Dict[str, float] = {}
        # The per-experiment init seed: the one draw the JAX Strategy
        # makes here for its init key.  Each re-init counts up from it.
        self._init_seed = int(self.rng.integers(2 ** 31))
        self._inits = 0
        # True only for the first train() after a resume (the driver
        # sets it): the one fit allowed to consume a mid-round fit state;
        # other fits discard stale ones.
        self.resume_next_fit = False

    # -- identity --------------------------------------------------------

    @property
    def round(self) -> int:
        return self.pool.round

    @round.setter
    def round(self, value: int) -> None:
        self.pool.round = int(value)

    @property
    def exp_hash(self) -> str:
        return self.cfg.exp_hash or "no_hash"

    @property
    def init_key(self) -> np.ndarray:
        """(seed, re-inits so far): what ``experiment_state.npz`` stores
        as ``init_key``."""
        return np.asarray([self._init_seed, self._inits], dtype=np.uint32)

    def set_init_state(self, seed: int, inits: int) -> None:
        """Continue the init stream from ``(seed, inits)``, as
        ``init_key`` gives them (a resume, a rolled-back round)."""
        self._init_seed = int(seed)
        self._inits = int(inits)

    # -- pool views ------------------------------------------------------

    def available_query_idxs(self, shuffle: bool = True) -> np.ndarray:
        return self.pool.available_query_idxs(shuffle=shuffle, rng=self.rng)

    def available_query_mask(self) -> np.ndarray:
        return self.pool.available_mask()

    def already_labeled_idxs(self, shuffle: bool = False) -> np.ndarray:
        return self.pool.labeled_idxs(shuffle=shuffle, rng=self.rng)

    def already_labeled_mask(self) -> np.ndarray:
        return self.pool.labeled_mask()

    # -- weights ---------------------------------------------------------

    def weight_paths(self) -> Dict[str, str]:
        return ckpt_lib.weight_paths(self.cfg.ckpt_path, self.cfg.exp_name,
                                     self.exp_hash, self.round)

    def init_network_weights(self) -> None:
        """Fresh random weights every round (so the head always resets),
        then the configured pretrained checkpoint overlaid on them
        (``utils/pretrained.apply_pretrained``), as the JAX strategy does
        every round."""
        self._inits += 1
        gen = torch.Generator().manual_seed(
            (self._init_seed << 20) + self._inits)
        init_weights(self.model, gen)
        if self.train_cfg.has_pretrained:
            apply_pretrained(self.model, self.train_cfg.pretrained)
            self.logger.info(f"Initialized network weights from "
                             f"{self.train_cfg.pretrained.path}")
        else:
            self.logger.info("Initialized Network Weights Randomly.")

    def aux_state_bytes(self) -> Optional[bytes]:
        """The sampler's own state to save with the round (flax msgpack
        bytes), or None: only VAAL has one."""
        return None

    def restore_aux_state(self, data: bytes) -> None:
        """Inverse of ``aux_state_bytes``, called on resume."""

    def load_best_ckpt(self) -> None:
        path = self.weight_paths()["best_ckpt"]
        self.logger.info(f"Loading best ckpt so far from: {path}")
        load_flax_variables(self.model, ckpt_lib.load_variables(path))

    # -- the verbs -------------------------------------------------------

    def query(self, budget: int) -> Tuple[np.ndarray, int]:
        raise NotImplementedError

    def update(self, labeled_idxs, cur_cost: float) -> None:
        """Mark queried examples labeled, spend budget, log the audit
        trail."""
        labeled_idxs = np.asarray(labeled_idxs, dtype=np.int64).reshape(-1)
        self.pool.update(labeled_idxs, cur_cost)
        self.sink.log_metric("cumulative_budget", self.pool.cumulative_cost,
                             step=self.round)
        self.logger.info(
            f"Cumulative budget used on round {self.round} = "
            f"{self.pool.cumulative_cost}")
        self.sink.log_asset(f"labeled_idxs_on_rd_{self.round}",
                            ",".join(str(int(e)) for e in labeled_idxs))

    def train(self, batch_hook=None) -> None:
        """Per-round training with validation and early stopping;
        ``batch_hook(epoch, batch)`` runs after each step (VAAL's
        co-step)."""
        labeled = self.already_labeled_idxs()
        self.logger.info(f"Starting training on round {self.round}")

        def metric_cb(name: str, value: float, step: int) -> None:
            self.sink.log_metric(name, value, step=step)

        result = self.trainer.fit(
            self.train_set, labeled, self.al_set, self.pool.eval_idxs,
            n_epoch=self.cfg.n_epoch,
            es_patience=self.cfg.early_stop_patience, rng=self.rng,
            round_idx=self.round, weight_paths=self.weight_paths(),
            metric_cb=metric_cb, batch_hook=batch_hook,
            resume_fit_state=self.resume_next_fit)
        self.resume_next_fit = False
        self.best_epoch = result.best_epoch
        self.best_perf = float(result.best_perf)
        self.logger.info(f"Finished training on round {self.round}")

    def test(self) -> Optional[float]:
        """Test-set evaluation with the reference's metric schema."""
        if self.test_set is None:
            self.logger.info("Skipped testing loop, no testing dataset found.")
            return None
        perf = self.trainer.evaluate(self.test_set,
                                     np.arange(len(self.test_set)))
        acc = float(perf["accuracy"])
        self.last_test_acc = acc
        top5 = float(perf["top_5_accuracy"])
        byclass = np.asarray(perf["accuracy_byclass"])
        order = np.argsort(byclass)
        k = int(min(5, len(byclass)))
        self.logger.info(
            f"Test performance at round {self.round} is {acc * 100:.2f}%")
        self.logger.info(
            f"Best {k} classes: "
            f"{ {int(i): f'{byclass[i] * 100:.2f}' for i in order[-k:]} }")
        self.logger.info(
            f"Worst {k} classes: "
            f"{ {int(i): f'{byclass[i] * 100:.2f}' for i in order[:k]} }")
        self.logger.info(
            f"Test top 5 acc at round {self.round} is {top5 * 100:.2f}%")
        self.sink.log_metrics(
            {"rd_test_accuracy": acc, "rd_test_top5_accuracy": top5},
            step=self.round)
        self.sink.log_metrics(
            {"budget_test_accuracy": acc, "budget_test_top5_accuracy": top5},
            step=self.pool.cumulative_cost)
        self.sink.log_asset(
            f"test_acc_byclass_rd_{self.round}",
            ",".join(f"{e:.2f}" for e in byclass))
        return acc

    # -- scoring ---------------------------------------------------------

    def _score_batch_size(self) -> int:
        """The scoring batch: ``TrainConfig.score_batch_size`` when set,
        else the evaluation batch (one policy for both passes)."""
        explicit = self.train_cfg.score_batch_size
        if explicit:
            return self.trainer.padded_batch_size(int(explicit))
        return self.trainer.eval_batch_size(self.al_set)

    def _get_score_step(self, kind: str) -> scoring.Step:
        """One step per scoring kind, built at first use."""
        if kind not in self._score_steps:
            view = self.al_set.view
            if kind == "prob_stats":
                step = scoring.make_prob_stats_step(view)
            elif kind == "embed":
                step = scoring.make_embed_step(view)
            elif kind == "embed_margin":
                step = scoring.make_embed_step(view, with_probs=True)
            elif kind == "mase":
                step = scoring.make_mase_step(view)
            elif kind == "badge":
                step = scoring.make_badge_step(view)
            elif kind == "badge_pool":
                step = scoring.make_badge_step(view, pool_512=True)
            else:
                raise KeyError(f"unknown scoring kind '{kind}'")
            self._score_steps[kind] = step
        return self._score_steps[kind]

    def collect_scores(self, idxs: np.ndarray, kind: str,
                       keys=None, host_s2d: Optional[bool] = None
                       ) -> Dict[str, np.ndarray]:
        """The ``kind`` step (``prob_stats``, ``embed``, ``embed_margin``,
        ``mase``, ``badge``, ``badge_pool``) over ``al_set[idxs]`` in
        fixed-shape batches of ``_score_batch_size`` rows (the last one
        padded), model in eval mode; host arrays aligned with ``idxs``,
        floating outputs in float32.  The rows leave the host in the
        space-to-depth layout when ``host_s2d`` (default: the model has
        the s2d stem, JAX ``strategies/base.py:497-507``).  On N ranks
        each rank scores its rows of every batch and ``fetch`` gathers
        the outputs, so every rank returns the whole result.  The test
        loader's ``num_workers`` threads gather in order behind the
        device prefetch (JAX ``strategies/scoring.py:520-590``); the
        pass's rows, wall time and, over a decoded-pool cache, the rows
        it had to decode, and over a disk dataset the rows its native
        decoder handed to PIL, land in ``last_scoring`` and the log."""
        if host_s2d is None:
            host_s2d = self.trainer.host_s2d
        self.model.eval()
        step = self._get_score_step(kind)
        reset = getattr(step, "reset", None)
        if reset is not None:
            reset()
        bs = self._score_batch_size()
        mesh = self.trainer.mesh
        rows = self.trainer.local_rows(bs)
        loader = self.train_cfg.loader_te
        idxs = np.asarray(idxs)
        batches = batch_index_lists(idxs, bs)

        def checked_host_batches():
            for b, batch in zip(batches, ordered_map(
                    lambda b: gather_batch(self.al_set, b, bs, s2d=host_s2d,
                                           rows=rows),
                    batches, loader.num_workers, loader.prefetch)):
                # The threads deliver in order, and this rank's rows are
                # exactly its slice of the global layout: scores can never
                # be matched to the wrong pool index.
                want = padded_batch_layout(b, bs)[0]
                if rows is not None:
                    want = want[rows]
                if not np.array_equal(batch["index"],
                                      want.astype(np.int32)):
                    raise AssertionError(
                        "scoring rows misaligned with the global batch "
                        "layout")
                yield {"image": batch["image"]}

        decoded0 = getattr(self.al_set, "decoded_rows", None)
        fallback0 = getattr(self.al_set, "fallback_rows", None)
        t0 = time.perf_counter()
        parts: Dict[str, list] = {}
        # The gather and the copy of batch n+1 overlap batch n's step.
        with contextlib.closing(device_prefetch(
                checked_host_batches(),
                device_put(self.trainer.device))) as feed:
            for b, item in zip(batches, feed):
                out = step(self.model, item.wait())
                for k, v in out.items():
                    if keys is None or k in keys:
                        if v.is_floating_point():
                            v = v.to(torch.float32)
                        if rows is None:
                            v = v[:len(b)]
                        parts.setdefault(k, []).append(v.cpu().numpy())
        wall = time.perf_counter() - t0
        self.last_scoring = {"rows": len(idxs), "wall_s": wall}
        note = ""
        if decoded0 is not None:
            self.last_scoring["decoded_rows"] = (self.al_set.decoded_rows
                                                 - decoded0)
            note = f"; {self.last_scoring['decoded_rows']} rows decoded"
        if fallback0 is not None:
            self.last_scoring["fallback_rows"] = (self.al_set.fallback_rows
                                                  - fallback0)
            note += (f"; {self.last_scoring['fallback_rows']} rows "
                     "through the PIL fallback")
        self.logger.info(
            f"Scoring pass ({kind}): {len(idxs)} rows in {wall:.3f} s "
            f"({len(idxs) / max(wall, 1e-9):.1f} rows/s){note}")
        if rows is None:
            return {k: np.concatenate(v) for k, v in parts.items()}
        out = {}
        for k, v in parts.items():
            # [rank][batch][row] -> [batch][rank][row]: the batch order.
            got = mesh_lib.fetch(np.concatenate(v), mesh)
            got = got.reshape(mesh.world_size, len(batches), -1,
                              *got.shape[1:]).swapaxes(0, 1)
            out[k] = got.reshape(-1, *got.shape[3:])[:len(idxs)]
        return out


def register_strategy(name: str):
    """Register a Strategy subclass under its reference name."""

    def deco(cls):
        STRATEGIES.register(name, cls)
        cls.name = name
        return cls

    return deco
