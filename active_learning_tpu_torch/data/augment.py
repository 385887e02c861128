"""Device-side input transforms (the JAX package's ``data/augment.py``):
normalization for every view, random crop + horizontal flip for the
train view.

The draw is split from the transform.  ``crop_flip`` takes explicit
per-row crop offsets and a flip mask, so a test can hand the port the
very numbers ``jax.random`` drew and compare the pixels bit for bit;
``random_crop_flip`` draws them from a ``torch.Generator`` (the port's
stand-in for the JAX step's PRNG key: the same distributions, other
numbers).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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


def crop_flip(images: torch.Tensor, offsets: torch.Tensor,
              flip: torch.Tensor, pad: int = 4) -> torch.Tensor:
    """Per-row crop of the zero-padded image back to H x W at
    ``offsets`` (``[B, 2]`` row/column offsets in ``[0, 2·pad]``), then a
    horizontal flip where ``flip`` (``[B]`` bool) is set: torch's
    RandomCrop(padding=pad) + RandomHorizontalFlip on raw uint8 rows, so
    the padding is black before normalization.  ``pad == 0`` is
    flip-only (the offsets are ignored)."""
    b, h, w, _ = images.shape
    if pad > 0:
        padded = F.pad(images, (0, 0, pad, pad, pad, pad))
        dev = images.device
        rows = offsets[:, 0, None] + torch.arange(h, device=dev)
        cols = offsets[:, 1, None] + torch.arange(w, device=dev)
        bi = torch.arange(b, device=dev)[:, None, None]
        images = padded[bi, rows[:, :, None], cols[:, None, :]]
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def random_crop_flip(images: torch.Tensor, generator: torch.Generator,
                     pad: int = 4) -> torch.Tensor:
    """``crop_flip`` with offsets uniform in ``[0, 2·pad]`` and flips
    with probability 1/2, drawn from ``generator`` (on the images'
    device)."""
    b = images.shape[0]
    dev = images.device
    offsets = torch.randint(0, 2 * pad + 1, (b, 2), generator=generator,
                            device=dev)
    flip = torch.rand(b, generator=generator, device=dev) < 0.5
    return crop_flip(images, offsets, flip, pad)


def apply_view(images_u8: torch.Tensor, view: ViewSpec,
               generator: Optional[torch.Generator] = None,
               train: bool = True) -> torch.Tensor:
    """A dataset view's transform on the device: augment=True and
    train=True crop and flip the raw uint8 rows, then normalize;
    otherwise normalize only (the val transform)."""
    x = images_u8
    if view.augment and train:
        if generator is None:
            raise ValueError("augmentation needs a torch.Generator")
        x = random_crop_flip(x, generator, pad=view.pad)
    return normalize(x, view.normalization)
