"""The eval view's input transform (``normalize`` of the JAX package's
``data/augment.py``).  Augmentation belongs to the training slice."""

from __future__ import annotations

import torch

from .core import Normalization, ViewSpec


def normalize(images_u8: torch.Tensor, norm: Normalization) -> torch.Tensor:
    """uint8 ``[B, H, W, C]`` -> float32 ``(x - 255·mean) / (255·std)``,
    the same float32 arithmetic as the JAX package (ToTensor +
    Normalize folded into one affine)."""
    c = images_u8.shape[-1]
    if c != len(norm.mean):
        raise ValueError(f"rows have {c} channels; the normalization has "
                         f"{len(norm.mean)} (the s2d layout is not ported)")
    dev = images_u8.device
    mean = torch.tensor(norm.mean, dtype=torch.float32, device=dev) * 255.0
    std = torch.tensor(norm.std, dtype=torch.float32, device=dev) * 255.0
    return (images_u8.to(torch.float32) - mean) / std


def apply_view(images_u8: torch.Tensor, view: ViewSpec) -> torch.Tensor:
    """The scoring view: normalize only.  A training view (augment=True)
    belongs to the training slice and raises here."""
    if view.augment:
        raise NotImplementedError(
            "augmented views belong to the training slice (ROADMAP.md)")
    return normalize(images_u8, view.normalization)
