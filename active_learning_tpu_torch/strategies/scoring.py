"""The scoring steps and acquisition primitives of the JAX package's
``strategies/scoring.py``: ``make_prob_stats_step`` (kernel A),
``make_embed_step``, ``make_badge_step`` (kernel G), ``make_mase_step``
with ``head_pair_norms`` and ``boundary_radii`` (kernel F), and
``batched_min_dist_update`` (kernel E).

Each step is a plain function ``step(model, batch) -> dict`` under
``torch.inference_mode()``: ``batch["image"]`` is uint8 ``[B, H, W, C]``
on the model's device, and every output has the batch as its leading
axis.  The offline samplers and the scoring service share these steps,
which is what makes a served score the offline score at the same batch
shape.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from ..data.augment import apply_view
from ..data.core import ViewSpec
from ..ops import kcenter as kcenter_ops
from ..ops.badge import badge_factors
from ..ops.boundary_radii import boundary_radii, head_pair_norms
from ..ops.prob_stats import prob_stats

__all__ = ["make_prob_stats_step", "make_embed_step", "make_badge_step",
           "make_mase_step", "boundary_radii", "head_pair_norms",
           "batched_min_dist_update"]

Step = Callable[[torch.nn.Module, Dict[str, torch.Tensor]],
                Dict[str, torch.Tensor]]


def make_prob_stats_step(view: ViewSpec) -> Step:
    """Per-example softmax statistics: confidence (ConfidenceSampler's
    score), margin (MarginSampler's), entropy (served by /v1/score) and
    the predicted label — kernel A on the float32 logits."""

    @torch.inference_mode()
    def step(model, batch):
        x = apply_view(batch["image"], view)
        logits = model(x).to(torch.float32)
        return prob_stats(logits.contiguous())

    return step


def make_embed_step(view: ViewSpec, with_probs: bool = False) -> Step:
    """The final embedding (``return_features``), with the softmax
    margin and the logits' argmax when ``with_probs``."""

    @torch.inference_mode()
    def step(model, batch):
        x = apply_view(batch["image"], view)
        logits, embedding = model(x, return_features=True)
        out = {"embedding": embedding}
        if with_probs:
            logits = logits.to(torch.float32).contiguous()
            out["margin"] = prob_stats(logits)["margin"]
            out["pred"] = torch.argmax(logits, dim=-1).to(torch.int32)
        return out

    return step


def make_badge_step(view: ViewSpec, pool_512: bool = False) -> Step:
    """BADGE gradient-embedding factors: ``grad_a = softmax(z) -
    onehot(argmax z)`` (the closed-form gradient of the cross-entropy at
    the predicted label with respect to the logits) and ``grad_e`` the
    embedding, pooled to 512 dimensions with ``pool_512`` (the
    partitioned variant) — kernel G."""

    @torch.inference_mode()
    def step(model, batch):
        x = apply_view(batch["image"], view)
        logits, embedding = model(x, return_features=True)
        return badge_factors(logits.to(torch.float32).contiguous(),
                             embedding, pool_512)

    return step


def make_mase_step(view: ViewSpec) -> Step:
    """Per-class boundary radii, the predicted class and the smallest
    radius (``min_margin``) of each row — kernel F.  The head's pair-norm
    table does not depend on the batch: the first batch after
    ``step.reset()`` computes it and later batches reuse it.  ``reset()``
    is the only invalidation, so a caller that changes the head between
    batches calls it (a scoring pass does, before its first batch)."""
    cache: Dict[str, torch.Tensor] = {}

    @torch.inference_mode()
    def step(model, batch):
        x = apply_view(batch["image"], view)
        _, embedding = model(x, return_features=True)
        weight, bias = model.linear.weight, model.linear.bias
        if "norms" not in cache:
            cache["norms"] = head_pair_norms(weight.T)
        return boundary_radii(embedding, weight.T, bias, cache["norms"])

    step.reset = cache.clear
    return step


def batched_min_dist_update(factors: Sequence[torch.Tensor],
                            sqn: torch.Tensor, min_dist: torch.Tensor,
                            center_idxs: torch.Tensor) -> torch.Tensor:
    """One k-center distance fold, in place: ``min_dist <- min(min_dist,
    min_c ||g - g_c||²)`` over the centers ``center_idxs`` (int64 rows
    of the factor matrices) — kernel E.  Returns ``min_dist``."""
    kcenter_ops.min_fold(factors, sqn, min_dist, center_idxs)
    return min_dist
