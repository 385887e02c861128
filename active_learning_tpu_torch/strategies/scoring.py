"""The scoring steps (``make_prob_stats_step`` and ``make_embed_step`` of
the JAX package's ``strategies/scoring.py``).

Each step is a plain function ``step(model, batch) -> dict`` under
``torch.inference_mode()``: ``batch["image"]`` is uint8 ``[B, H, W, C]``
on the model's device, and every output has the batch as its leading
axis.  The offline samplers and the scoring service share these steps,
which is what makes a served score the offline score at the same batch
shape.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..data.augment import apply_view
from ..data.core import ViewSpec
from ..ops.prob_stats import prob_stats

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
