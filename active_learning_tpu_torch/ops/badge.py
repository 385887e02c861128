"""Kernel G: BADGE's gradient-embedding factors (ROADMAP K5, BADGE half).

Replaces the JAX package's ``strategies/scoring.py:154-193``
``make_badge_step`` arithmetic after the forward.  The CUDA source is
``csrc/badge.cu`` (CUDA rather than Triton: see its header).
``badge_factors`` launches it on CUDA tensors and runs
``badge_factors_reference``, the plain version, only on CPU tensors.

Output: ``grad_a = softmax(z) - onehot(argmax z)`` ``[B, C]`` and
``grad_e`` the embedding ``[B, D]``, float32; with ``pool_512`` both
adaptive-average pooled, to ``min(16, C)`` and ``512 // min(16, C)``
bins (the reference's ``pool_h = min(POOLING_H, C)`` rule).  The BADGE
embedding is their outer product, never formed.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import full_float32
from . import _build

# Launches since the process started (or since a caller reset it).
launches = 0

# The logits row lives in shared memory: 48 KB less the kernel's 256
# static bytes, in float32 (csrc/badge.cu).
MAX_CLASSES = (48 * 1024 - 256) // 4


def pool_shape(num_classes: int) -> Tuple[int, int]:
    """(bins of the class factor, bins of the embedding factor)."""
    h = min(16, num_classes)
    return h, int(512 / h)


def adaptive_avg_pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] averaging weights with torch adaptive_avg_pool bin
    edges: bin o covers [floor(o*In/Out), ceil((o+1)*In/Out)).  Pooling a
    vector is ``v @ M``; pooling the rank-1 BADGE embedding factor by
    factor is exact."""
    m = np.zeros((n_in, n_out), dtype=np.float32)
    for o in range(n_out):
        start = int(np.floor(o * n_in / n_out))
        end = int(np.ceil((o + 1) * n_in / n_out))
        m[start:end, o] = 1.0 / (end - start)
    return m


def badge_factors_reference(logits: torch.Tensor, embedding: torch.Tensor,
                            pool_512: bool) -> Dict[str, torch.Tensor]:
    """The JAX step's arithmetic in torch, float32: softmax as
    ``exp(z - max) / sum``, the first argmax, and pooling as a product
    with the averaging matrices (TF32 off)."""
    z = logits.to(torch.float32)
    u = torch.exp(z - z.max(dim=-1, keepdim=True).values)
    p = u / u.sum(dim=-1, keepdim=True)
    pred = torch.argmax(z, dim=-1)
    a = p - torch.nn.functional.one_hot(pred, z.shape[-1]).to(torch.float32)
    e = embedding.to(torch.float32)
    if pool_512:
        h, w = pool_shape(z.shape[-1])
        with full_float32():
            a = a @ torch.from_numpy(adaptive_avg_pool_matrix(
                a.shape[1], h)).to(a.device)
            e = e @ torch.from_numpy(adaptive_avg_pool_matrix(
                e.shape[1], w)).to(e.device)
    return {"grad_a": a, "grad_e": e}


def badge_factors(logits: torch.Tensor, embedding: torch.Tensor,
                  pool_512: bool = False) -> Dict[str, torch.Tensor]:
    """BADGE factors of float32 logits ``[B, C]`` and embeddings
    ``[B, D]``: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    global launches
    if logits.ndim != 2 or embedding.ndim != 2 or \
            logits.shape[0] != embedding.shape[0]:
        raise ValueError(f"logits {tuple(logits.shape)} and embedding "
                         f"{tuple(embedding.shape)} must be [B, C], [B, D]")
    if logits.dtype != torch.float32:
        raise TypeError(f"logits must be float32, got {logits.dtype}")
    if not 1 <= logits.shape[1] <= MAX_CLASSES:
        raise ValueError(f"badge_factors needs 1 <= C <= {MAX_CLASSES}")
    if logits.device != embedding.device:
        raise ValueError("logits and embedding on one device")
    if logits.device.type == "cpu":
        return badge_factors_reference(logits, embedding, pool_512)
    if logits.device.type != "cuda":
        raise ValueError(f"badge_factors: unsupported device {logits.device}")
    z = logits.contiguous()
    b, c = z.shape
    d = embedding.shape[1]
    dev = z.device
    if pool_512:
        h, w = pool_shape(c)
        e = embedding.to(torch.float32).contiguous()
        out = {"grad_a": torch.empty(b, h, dtype=torch.float32, device=dev),
               "grad_e": torch.empty(b, w, dtype=torch.float32, device=dev)}
        e_ptr, e_out = e.data_ptr(), out["grad_e"].data_ptr()
    else:
        h = w = 0
        out = {"grad_a": torch.empty(b, c, dtype=torch.float32, device=dev),
               "grad_e": embedding.to(torch.float32)}
        e_ptr = e_out = None
    with torch.cuda.device(dev):
        err = _kernel()(z.data_ptr(), e_ptr, b, c, d, h, w,
                        out["grad_a"].data_ptr(), e_out,
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"badge_factors kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


_fn = None


def _kernel():
    """The C entry point, built and bound at first use."""
    global _fn
    if _fn is None:
        fn = _build.load("badge").badge_factors_f32
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn
