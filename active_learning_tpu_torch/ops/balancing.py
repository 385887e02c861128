"""Kernel H: the balancing pick of ``BalancingSampler`` (ROADMAP K6).

Replaces the JAX package's ``strategies/balancing.py:61-85``
``_balancing_pick``.  The CUDA source is ``csrc/balancing.cu`` (its
header says what bounds it and how it is laid out).  One wrapper,
``balancing_pick``, with its launch counter: the index of the least
score ``d_rare / norm`` over the eligible rows, where

* ``d_rare`` is the squared distance to the rarest class's centroid in
  the difference form, 1 when that class has no labeled row;
* ``norm`` is the largest squared distance to a majority centroid in the
  expanded form ``(a2 + b2) - 2·e·c`` (not clamped at 0);
* ineligible rows score +inf; ties go to the lower index and a NaN wins,
  as ``jnp.argmin`` has it.

On a CPU tensor the wrapper runs the plain version, on a CUDA tensor the
kernel; either way the pick comes back as a 0-d int64 tensor on the
pool's device.  ``rarest`` and ``rare_empty`` are host scalars, passed
to the kernel as arguments.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import full_float32
from . import _build

# Launches since the process started (or since a caller reset it).
launches = 0

F32_EPS = 2.0 ** -23


def _check(emb: torch.Tensor, eligible: torch.Tensor, centers: torch.Tensor,
           maj: torch.Tensor, rarest: int) -> None:
    if emb.ndim != 2 or centers.ndim != 2 or emb.shape[1] != centers.shape[1]:
        raise ValueError(f"emb [N, D] and centers [C, D] expected, got "
                         f"{tuple(emb.shape)} and {tuple(centers.shape)}")
    n, c = emb.shape[0], centers.shape[0]
    if emb.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError("balancing_pick: emb and centers must be float32")
    if eligible.shape != (n,) or eligible.dtype != torch.bool:
        raise ValueError(f"eligible must be a bool [{n}]")
    if maj.shape != (c,) or maj.dtype != torch.bool:
        raise ValueError(f"maj must be a bool [{c}]")
    if not 0 <= rarest < c:
        raise ValueError(f"rarest {rarest} is not a class of {c}")
    if n == 0 or n >= 2 ** 31:
        raise ValueError(f"balancing_pick takes 1 to 2**31 - 1 rows, got {n}")
    for t in (eligible, centers, maj):
        if t.device != emb.device:
            raise ValueError("balancing_pick: every tensor on one device")


def balancing_scores_reference(emb: torch.Tensor, eligible: torch.Tensor,
                               centers: torch.Tensor, maj: torch.Tensor,
                               rarest: int, rare_empty: bool
                               ) -> torch.Tensor:
    """Every row's score: the JAX function's formula in torch, float32
    matrix products in full float32 (TF32 off)."""
    d_rare = ((emb - centers[rarest][None, :]) ** 2).sum(dim=1)
    if rare_empty:
        d_rare = torch.ones_like(d_rare)
    a2 = (emb ** 2).sum(dim=1, keepdim=True)
    b2 = (centers ** 2).sum(dim=1)[None, :]
    with full_float32():
        d_all = a2 + b2 - 2.0 * (emb @ centers.T)
    d_maj = torch.where(maj[None, :], d_all,
                        torch.full_like(d_all, float("-inf")))
    norm = d_maj.max(dim=1).values
    return torch.where(eligible, d_rare / norm,
                       torch.full_like(d_rare, float("inf")))


def balancing_pick_reference(emb: torch.Tensor, eligible: torch.Tensor,
                             centers: torch.Tensor, maj: torch.Tensor,
                             rarest: int, rare_empty: bool) -> torch.Tensor:
    """The plain version: the argmin of ``balancing_scores_reference``
    (torch's argmin, like jnp's, takes the first minimum and lets the
    first NaN win)."""
    return torch.argmin(balancing_scores_reference(
        emb, eligible, centers, maj, rarest, rare_empty))


def score_tolerance(emb: torch.Tensor, centers: torch.Tensor,
                    maj: torch.Tensor, rarest: int,
                    rare_empty: bool) -> torch.Tensor:
    """Per row, how far two float32 evaluations of the score in other
    summation orders may lie apart: |score| (2·D·eps + 2·δ/|norm|) with
    δ = 2·(D + 2)·eps·(a2 + max b2) the expanded norm's error bound (each
    of a2, b2 and the dot product is a D-term sum, off by at most D·eps
    times its terms' magnitude, and |2·e·c| <= a2 + b2).  The numerator
    is a sum of D squares, off by at most D·eps relative.  Float64 on
    the inputs' device; +inf where the norm is 0."""
    e64, c64 = emb.to(torch.float64), centers.to(torch.float64)
    d = emb.shape[1]
    d_rare = ((e64 - c64[rarest][None, :]) ** 2).sum(dim=1)
    if rare_empty:
        d_rare = torch.ones_like(d_rare)
    a2 = (e64 ** 2).sum(dim=1)
    b2 = (c64 ** 2).sum(dim=1)
    d_all = a2[:, None] + b2[None, :] - 2.0 * (e64 @ c64.T)
    norm = torch.where(maj[None, :], d_all,
                       torch.full_like(d_all, float("-inf"))
                       ).max(dim=1).values
    b2max = b2[maj].max() if bool(maj.any()) else b2.new_zeros(())
    delta = 2.0 * (d + 2) * F32_EPS * (a2 + b2max)
    score = (d_rare / norm).abs()
    return score * (2.0 * d * F32_EPS + 2.0 * delta / norm.abs())


def balancing_pick(emb: torch.Tensor, eligible: torch.Tensor,
                   centers: torch.Tensor, maj: torch.Tensor, rarest: int,
                   rare_empty: bool) -> torch.Tensor:
    """The pool row the balancing branch picks (0-d int64 on ``emb``'s
    device): ``emb`` float32 [N, D], ``eligible`` bool [N], ``centers``
    float32 [C, D], ``maj`` bool [C] (the majority classes), ``rarest``
    the rarest class, ``rare_empty`` whether it has no labeled row."""
    global launches
    rarest, rare_empty = int(rarest), bool(rare_empty)
    _check(emb, eligible, centers, maj, rarest)
    if emb.device.type == "cpu":
        return balancing_pick_reference(emb, eligible, centers, maj, rarest,
                                        rare_empty)
    if emb.device.type != "cuda":
        raise ValueError(f"balancing_pick: unsupported device {emb.device}")
    for t in (emb, eligible, centers, maj):
        if not t.is_contiguous():
            raise ValueError("balancing_pick: tensors must be contiguous")
    lib = _lib()
    n, d = emb.shape
    c = centers.shape[0]
    dev = emb.device
    b2 = torch.empty(c, dtype=torch.float32, device=dev)
    maj_idx = torch.empty(c, dtype=torch.int32, device=dev)
    n_maj = torch.empty(1, dtype=torch.int32, device=dev)
    keys = torch.empty(lib.bal_blocks(n, c), dtype=torch.int64, device=dev)
    out = torch.empty((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.bal_pick(
            emb.data_ptr(), n, d, eligible.data_ptr(), centers.data_ptr(), c,
            maj.data_ptr(), rarest, int(rare_empty), b2.data_ptr(),
            maj_idx.data_ptr(), n_maj.data_ptr(), keys.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"balancing_pick kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


_lib_handle = None


def _lib():
    """The C entry points, built and bound at first use."""
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("balancing")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bal_pick.argtypes = [p, i, i, p, p, i, p, i, i, p, p, p, p, p, p]
        lib.bal_blocks.argtypes = [i, i]
        for fn in (lib.bal_pick, lib.bal_blocks):
            fn.restype = ctypes.c_int
        _lib_handle = lib
    return _lib_handle
