"""Optimizers and per-epoch LR schedules (the JAX package's
``train/optim.py``).

Two update rules over a list of float32 parameter tensors, each
updating in place:

  * ``FusedSGD`` — every SGD-family optimizer: kernel D
    (``ops/fused_sgd.py``), one launch per step over every leaf.  With
    ``fused_optimizer`` "auto"/"on" its momentum is stored in
    ``optim_state_dtype``; "off" (the JAX package's optax chain
    ``add_decayed_weights -> trace -> scale(-lr) -> apply_updates``)
    keeps it in float32, where kernel D does the chain's operations in
    the chain's order and gives the same bits;
  * ``Adam`` — optax ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, no
    weight decay, as the JAX package registers it), plain PyTorch.

No library optimizer is used.  Schedules step once per epoch:
``lr_at(epoch0)`` with epoch0 the count of completed epochs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..config import OptimizerConfig, SchedulerConfig, TrainConfig
from ..ops.fused_sgd import fused_sgd_update
from ..registry import OPTIMIZERS, SCHEDULERS

Params = List[torch.Tensor]


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(v), device=like.device)


class FusedSGD:
    """SGD + momentum + weight decay through kernel D.  ``trace`` holds
    the momentum buffers (None without momentum), in ``state_dtype``."""

    def __init__(self, momentum: float, weight_decay: float,
                 state_dtype: torch.dtype = torch.float32):
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)
        self.state_dtype = state_dtype
        self.trace: Optional[Params] = None

    def init(self, params: Params) -> None:
        self.trace = ([torch.zeros_like(p, dtype=self.state_dtype)
                       for p in params] if self.momentum else None)

    def reset(self) -> None:
        """Zero the state in place (a new round's fresh optimizer)."""
        for t in self.trace or ():
            t.zero_()

    def step(self, params: Params, grads: Params, lr: float) -> None:
        fused_sgd_update(params, grads, self.trace, lr, self.momentum,
                         self.weight_decay)


class Adam:
    """optax ``scale_by_adam`` followed by ``-lr`` and apply_updates."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, cfg: OptimizerConfig):
        self.trace = None
        self.count = 0
        self.mu: Optional[Params] = None
        self.nu: Optional[Params] = None

    def init(self, params: Params) -> None:
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    def reset(self) -> None:
        self.count = 0
        for t in (self.mu or []) + (self.nu or []):
            t.zero_()

    @torch.no_grad()
    def step(self, params: Params, grads: Params, lr: float) -> None:
        if not params:
            return
        self.count += 1
        like = params[0]
        one_b1, b1 = _f32(1 - self.b1, like), _f32(self.b1, like)
        one_b2, b2 = _f32(1 - self.b2, like), _f32(self.b2, like)
        c1 = _f32(1 - np.float32(self.b1) ** np.float32(self.count), like)
        c2 = _f32(1 - np.float32(self.b2) ** np.float32(self.count), like)
        eps = _f32(self.eps, like)
        neg_lr = _f32(-np.float32(lr), like)
        for p, g, m, v in zip(params, grads, self.mu, self.nu):
            m.copy_(one_b1 * g + b1 * m)
            v.copy_(one_b2 * (g * g) + b2 * v)
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            p.copy_(p + neg_lr * u)


def _sgd(cfg: OptimizerConfig) -> FusedSGD:
    """The optax chain's SGD: kernel D with a float32 trace."""
    return FusedSGD(cfg.momentum, cfg.weight_decay, torch.float32)


OPTIMIZERS.register("sgd", _sgd)
OPTIMIZERS.register("SGD", _sgd)  # reference spelling
OPTIMIZERS.register("adam", Adam)

OPTIM_STATE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def resolve_optim_state_dtype(name: str) -> torch.dtype:
    try:
        return OPTIM_STATE_DTYPES[name]
    except KeyError:
        raise ValueError(f"optim_state_dtype={name!r} is not one of "
                         f"{'/'.join(OPTIM_STATE_DTYPES)}") from None


def make_optimizer(train_cfg: TrainConfig):
    """The trainer's one rule for its update (the JAX package's
    ``make_fused_optimizer`` + ``make_optimizer``): "auto"/"on" with an
    SGD-family optimizer -> ``FusedSGD`` with its state in
    ``optim_state_dtype``; "on" with another optimizer fails fast;
    otherwise the registered rule ("off" with SGD is still kernel D, at
    the optax chain's float32 state)."""
    mode = train_cfg.fused_optimizer or "auto"
    if mode not in ("auto", "on", "off"):
        raise ValueError(
            f"fused_optimizer={mode!r} is not one of 'auto'/'on'/'off'")
    opt = train_cfg.optimizer
    is_sgd = opt.name.lower() == "sgd"
    if mode != "off" and is_sgd:
        return FusedSGD(opt.momentum, opt.weight_decay,
                        resolve_optim_state_dtype(
                            train_cfg.optim_state_dtype or "f32"))
    if mode == "on":
        raise ValueError(f"fused_optimizer=on requires an SGD-family "
                         f"optimizer; got {opt.name!r}")
    return OPTIMIZERS.get(opt.name)(opt)


# -- large-batch scaling ----------------------------------------------------

LARGE_BATCH_WARMUP_EPOCHS = 5


def apply_batch_scaling(train_cfg: TrainConfig, scale: int
                        ) -> Tuple[TrainConfig, bool]:
    """The large-batch ConvNet scaling rules for a global batch grown
    ``scale``x: batch x scale, lr x scale, and the cosine warmup raised
    to a >=5-epoch ramp (clamped below t_max).  Identity at scale <= 1.
    Returns (config, whether anything changed)."""
    scale = int(scale)
    if scale <= 1:
        return train_cfg, False
    opt = dataclasses.replace(train_cfg.optimizer,
                              lr=train_cfg.optimizer.lr * scale)
    sched = train_cfg.scheduler
    if sched.name in ("cosine", "CosineAnnealingLR") and sched.t_max > 1:
        warm = max(sched.warmup_epochs,
                   min(LARGE_BATCH_WARMUP_EPOCHS, sched.t_max - 1))
        sched = dataclasses.replace(sched, warmup_epochs=warm)
    loader = dataclasses.replace(
        train_cfg.loader_tr,
        batch_size=train_cfg.loader_tr.batch_size * scale)
    return dataclasses.replace(train_cfg, loader_tr=loader,
                               optimizer=opt, scheduler=sched), True


# -- schedules --------------------------------------------------------------

def _step_lr(cfg: SchedulerConfig, base_lr: float) -> Callable[[int], float]:
    def lr_at(epoch0: int) -> float:
        return base_lr * cfg.gamma ** (epoch0 // cfg.step_size)
    return lr_at


def _cosine_lr(cfg: SchedulerConfig,
               base_lr: float) -> Callable[[int], float]:
    warm = max(0, cfg.warmup_epochs)
    if warm >= cfg.t_max:
        raise ValueError(
            f"warmup_epochs ({warm}) must be < t_max ({cfg.t_max})")

    def lr_at(epoch0: int) -> float:
        if epoch0 < warm:
            return base_lr * (epoch0 + 1) / warm
        span = max(1, cfg.t_max - warm)
        return base_lr * (1 + math.cos(math.pi * (epoch0 - warm) / span)) / 2

    return lr_at


def _constant_lr(cfg: SchedulerConfig,
                 base_lr: float) -> Callable[[int], float]:
    return lambda epoch0: base_lr


SCHEDULERS.register("step", _step_lr)
SCHEDULERS.register("StepLR", _step_lr)
SCHEDULERS.register("cosine", _cosine_lr)
SCHEDULERS.register("CosineAnnealingLR", _cosine_lr)
SCHEDULERS.register("constant", _constant_lr)


def make_lr_schedule(cfg: SchedulerConfig, base_lr: float
                     ) -> Callable[[int], float]:
    """``lr_at(epoch0)``; epoch 1 trains at ``lr_at(0)``."""
    return SCHEDULERS.get(cfg.name)(cfg, base_lr)
