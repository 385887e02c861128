"""Device-side input transforms (the JAX package's ``data/augment.py``):
normalization for every view, random crop + horizontal flip for the
train view.  Space-to-depth rows (``[B, H/2, W/2, 4C]``, the s2d stem's
host feed) are normalized per pixel and flipped by ``s2d_flip``; their
train view is flip-only (``pad == 0``), as in the JAX package.

The draw is split from the transform.  ``crop_flip`` takes explicit
per-row crop offsets and a flip mask, so a test can hand the port the
very numbers ``jax.random`` drew and compare the pixels bit for bit;
``random_crop_flip`` draws them from a ``torch.Generator`` (the port's
stand-in for the JAX step's PRNG key: the same distributions, other
numbers).  With ``rows``, a rank of N draws for the whole global batch
and keeps its own rows' draws, so N ranks augment as one does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .core import Normalization, ViewSpec

# (rows of the global batch, this rank's slice of them).
Rows = Tuple[int, slice]


def _is_s2d(images: torch.Tensor, norm: Normalization) -> bool:
    c, n = images.shape[-1], len(norm.mean)
    if c not in (n, 4 * n):
        raise ValueError(f"rows have {c} channels; the normalization has "
                         f"{n} (or {4 * n} in the space-to-depth layout)")
    return c == 4 * n


def normalize(images_u8: torch.Tensor, norm: Normalization) -> torch.Tensor:
    """uint8 ``[B, H, W, C]`` -> float32 ``(x - 255·mean) / (255·std)``,
    the same float32 arithmetic as the JAX package (ToTensor +
    Normalize folded into one affine).  Space-to-depth rows (channel
    ``(di·2 + dj)·C + c``) get the same per-pixel affine, the mean and
    std tiled over the 4 blocks."""
    blocks = 4 if _is_s2d(images_u8, norm) else 1
    dev = images_u8.device
    mean = torch.tensor(norm.mean * blocks, dtype=torch.float32,
                        device=dev) * 255.0
    std = torch.tensor(norm.std * blocks, dtype=torch.float32,
                       device=dev) * 255.0
    return (images_u8.to(torch.float32) - mean) / std


def s2d_flip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Per-row horizontal flip of a space-to-depth batch ``[B, H/2, W/2,
    4C]`` where ``flip`` (``[B]`` bool) is set: mirroring the original
    width reverses the blocked columns and swaps the in-block offsets
    ``dj ∈ {0, 1}``, channel ``(di, dj, c) -> (di, 1 − dj, c)``.  Equal to
    space-to-depth of the flipped rows."""
    c4 = images.shape[-1]
    perm = torch.arange(c4, device=images.device).reshape(
        2, 2, c4 // 4).flip(1).reshape(-1)
    flipped = images.flip(2)[..., perm]
    return torch.where(flip[:, None, None, None], flipped, images)


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


def _draw_crop_flip(b: int, generator: torch.Generator, pad: int,
                    dev: torch.device, rows: Optional[Rows] = None):
    """Offsets and flips for ``b`` rows, or with ``rows = (global_b,
    slice)`` for a global batch of ``global_b`` rows cut to the slice."""
    n, keep = (b, slice(None)) if rows is None else rows
    offsets = torch.randint(0, 2 * pad + 1, (n, 2), generator=generator,
                            device=dev)
    flip = torch.rand(n, generator=generator, device=dev) < 0.5
    offsets, flip = offsets[keep], flip[keep]
    if flip.shape[0] != b:
        raise ValueError(f"rows {rows} do not cut {b} rows")
    return offsets, flip


def random_crop_flip(images: torch.Tensor, generator: torch.Generator,
                     pad: int = 4, rows: Optional[Rows] = None
                     ) -> torch.Tensor:
    """``crop_flip`` with offsets uniform in ``[0, 2·pad]`` and flips
    with probability 1/2, drawn from ``generator`` (on the images'
    device)."""
    offsets, flip = _draw_crop_flip(images.shape[0], generator, pad,
                                    images.device, rows)
    return crop_flip(images, offsets, flip, pad)


def apply_view(images_u8: torch.Tensor, view: ViewSpec,
               generator: Optional[torch.Generator] = None,
               train: bool = True, rows: Optional[Rows] = None
               ) -> torch.Tensor:
    """A dataset view's transform on the device: augment=True and
    train=True crop and flip the raw uint8 rows, then normalize;
    otherwise normalize only (the val transform).  Space-to-depth rows
    take the flip-only train view (``view.pad`` must be 0), with the
    draws ``random_crop_flip`` makes: at one generator state the s2d
    rows come out as space-to-depth of the raw rows' result.  ``rows =
    (global_b, slice)``: ``images_u8`` is that slice of a global batch,
    and the draws are the global batch's, cut to it."""
    x = images_u8
    if view.augment and train:
        if generator is None:
            raise ValueError("augmentation needs a torch.Generator")
        if _is_s2d(x, view.normalization):
            if view.pad != 0:
                raise ValueError("space-to-depth rows take the flip-only "
                                 f"train view (pad 0), not pad {view.pad}")
            _, flip = _draw_crop_flip(x.shape[0], generator, 0, x.device,
                                      rows)
            x = s2d_flip(x, flip)
        else:
            x = random_crop_flip(x, generator, pad=view.pad, rows=rows)
    return normalize(x, view.normalization)
