"""The degradation ladder (the JAX package's ``faults/ladder.py``):
escalate instead of crashing.

A failure that survives the site-level RetryPolicy reaches the driver's
round-attempt loop, which restores the round-start snapshot (pool, rng,
init state, model weights and BatchNorm buffers, so the retried round
is the fault-free one bit for bit) and asks this ladder for a less
ambitious mode.  The JAX package's rungs, in its order, each reverted at
the next round boundary (``relax``):

  1. pipeline_off     the speculative pipelined round -> sequential
  2. pool_replicated  the row-sharded resident pool -> replicated
  3. feed_host        the resident budget -> 0, host-streamed feeds
  4. batch_half       OOM only: halve the train batch (down to one row
                      a rank).  The one rung that is not bit-identical:
                      the batch size changes BatchNorm's statistics.

The port has no pipelined round and no resident pool (ROADMAP.md queue
1, item 5) and no row-sharded pool (item 7) yet, so rungs 1-3 cannot
apply: ``_apply`` returns False for them and escalation falls
through to the next candidate, exactly as the JAX ladder does when a
rung cannot apply.  ``batch_half`` is live.

Rung selection is the JAX package's: an OOM-classified failure tries
batch_half first, then the rungs that free device memory (feed_host,
pipeline_off; never pool_replicated); a failure whose provenance names a
subsystem (an injected fault's site, or the deepest traceback frame in
a mapped module) prefers that subsystem's rung; anything else takes the
next unapplied rung in order.  Every escalation logs, emits
``degrade_events`` through the metrics sink and updates the round
journal's ``degrade`` list.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

from . import retry as retry_lib
from .registry import InjectedFault, ThreadDeath

RUNGS = ("pipeline_off", "pool_replicated", "feed_host", "batch_half")

# Site provenance -> preferred first rung.
_SITE_RUNG = {
    "spec_scorer": "pipeline_off",
    "dispatch": "pipeline_off",
    "shard_upload": "pool_replicated",
    "h2d_upload": "pool_replicated",
    "feed_worker": "feed_host",
}

# Traceback-module provenance for real failures (no injected .site).
_MODULE_RUNG = (
    ("active_learning_tpu_torch/parallel/mesh", "pool_replicated"),
    ("active_learning_tpu_torch/data/pipeline", "feed_host"),
)


def _provenance_rung(exc: BaseException) -> Optional[str]:
    """The rung the failure's origin names: an injected fault carries
    its site; anything else is attributed by the deepest traceback frame
    inside a mapped module."""
    if isinstance(exc, (InjectedFault, ThreadDeath)):
        rung = _SITE_RUNG.get(getattr(exc, "site", ""))
        if rung is not None:
            return rung
    frames = []
    tb = exc.__traceback__
    while tb is not None:
        frames.append(tb.tb_frame.f_code.co_filename)
        tb = tb.tb_next
    for fname in reversed(frames):  # innermost first
        norm = fname.replace(os.sep, "/")
        for frag, rung in _MODULE_RUNG:
            if frag in norm:
                return rung
    return None


class DegradationLadder:
    """The active rungs of one experiment run.  The driver calls
    ``relax`` at each round start and ``escalate`` when a round attempt
    fails."""

    def __init__(self, strategy, logger=None, sink=None, journal=None):
        self.strategy = strategy
        self.logger = logger
        self.sink = sink
        self.journal = journal
        self.active: List[str] = []
        self.events = 0  # escalations this run
        self._saved: Dict[str, Any] = {}

    def max_attempts(self) -> int:
        """Round attempts: one clean try and one per rung."""
        return len(RUNGS) + 1

    def _candidate_rungs(self, exc: BaseException) -> List[str]:
        """Unapplied rungs in preference order for ``exc``."""
        kind = retry_lib.classify_exception(exc)
        if kind == retry_lib.OOM:
            order = ("batch_half", "feed_host", "pipeline_off")
        else:
            preferred = _provenance_rung(exc)
            order = ([preferred] if preferred
                     and preferred != "batch_half" else [])
            order += [r for r in RUNGS
                      if r != "batch_half" and r not in order]
        return [r for r in order if r not in self.active]

    def escalate(self, exc: BaseException, round_idx: int) -> Optional[str]:
        """Apply the next rung for ``exc``; returns its name, or None
        when no rung applies (the caller re-raises).  A candidate that
        cannot apply falls through to the next."""
        rung = None
        for candidate in self._candidate_rungs(exc):
            if self._apply(candidate):
                rung = candidate
                break
        if rung is None:
            return None
        self.active.append(rung)
        self.events += 1
        if self.logger is not None:
            self.logger.warning(
                f"degradation ladder: round {round_idx} failed with "
                f"{type(exc).__name__} ({exc}); engaging rung "
                f"{rung!r} (active: {self.active}) and retrying the "
                "round from its start")
        if self.sink is not None:
            self.sink.log_metric("degrade_events", self.events,
                                 step=round_idx)
        if self.journal is not None:
            self.journal.write(degrade=list(self.active), round=round_idx,
                               status="running")
        return rung

    def _apply(self, rung: str) -> bool:
        if rung == "batch_half":
            return self._halve_batch(self.strategy.trainer) is not None
        # pipeline_off: the pipelined round, ROADMAP.md queue 1 item 5.
        # feed_host: the resident budget, item 5.  pool_replicated: the
        # row-sharded pool, item 7.  None of them exists in the port
        # yet, so the rung cannot apply.
        return False

    def _halve_batch(self, trainer) -> Optional[int]:
        loader = trainer.cfg.loader_tr
        floor = trainer.mesh.world_size
        new_bs = max(floor, loader.batch_size // 2)
        if new_bs == loader.batch_size:
            return None
        self._saved.setdefault("loader_tr", loader)
        trainer.cfg = dataclasses.replace(
            trainer.cfg, loader_tr=dataclasses.replace(loader,
                                                       batch_size=new_bs))
        if self.logger is not None:
            self.logger.warning(
                f"degradation ladder: train batch halved to {new_bs} "
                "(OOM); reverts at the next round boundary")
        return new_bs

    def relax(self, round_idx: Optional[int] = None) -> List[str]:
        """Revert every active rung (at round start: each round retries
        at full capability).  Returns the reverted rung names."""
        if not self.active:
            return []
        trainer = self.strategy.trainer
        reverted = list(self.active)
        if "batch_half" in self.active:
            trainer.cfg = dataclasses.replace(
                trainer.cfg, loader_tr=self._saved["loader_tr"])
        self.active = []
        self._saved = {}
        if self.logger is not None:
            self.logger.info(
                f"degradation ladder: reverted {reverted} at the round "
                "boundary (full capability restored)")
        if self.journal is not None:
            self.journal.write(degrade=[], round=round_idx)
        return reverted
