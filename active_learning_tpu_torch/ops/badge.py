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

# The logits row lives in shared memory: 48 KB less 256 bytes kept for
# the kernel's static slots, in float32 (csrc/badge.cu).
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
    tensors.  On the card a call allocates once: unpooled, ``grad_a``
    (``grad_e`` is the embedding itself); pooled, both factors as
    contiguous halves of one buffer."""
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
    if not logits.is_cuda:
        if logits.device.type != "cpu":
            raise ValueError(f"badge_factors: unsupported device "
                             f"{logits.device}")
        return badge_factors_reference(logits, embedding, pool_512)
    logits = logits.contiguous()
    b, c = logits.shape
    d = embedding.shape[1]
    fn = _kernel()
    flags = _VEC_ROWS if c % 4 == 0 and logits.data_ptr() % 16 == 0 else 0
    if pool_512:
        if embedding.dtype != torch.float32 or \
                not embedding.is_contiguous():
            embedding = embedding.to(torch.float32).contiguous()
        # A block holds a logits row (rounded up to 4) or an embedding
        # row in shared memory, whichever is longer (csrc/badge.cu).
        need = 4 * max(-(-c // 4) * 4, d)
        if need > _smem_limit:
            raise ValueError(f"badge_factors: C={c} and D={d} need {need} "
                             f"bytes of shared memory, over the kernel's "
                             f"{_smem_limit}")
        if d % 4 == 0 and embedding.data_ptr() % 16 == 0:
            flags |= _VEC_EMB
        h, w = pool_shape(c)
        buf = torch.empty(b * (h + w), dtype=torch.float32,
                          device=logits.device)
        out = {"grad_a": buf.as_strided((b, h), (h, 1)),
               "grad_e": buf.as_strided((b, w), (w, 1), b * h)}
        args = (logits.data_ptr(), embedding.data_ptr(), b, c, d, h, w,
                flags, buf.data_ptr(), buf.data_ptr() + 4 * b * h)
    else:
        a = torch.empty(b, c, dtype=torch.float32, device=logits.device)
        out = {"grad_a": a, "grad_e": embedding.to(torch.float32)}
        args = (logits.data_ptr(), None, b, c, d, 0, 0, flags, a.data_ptr(),
                None)
    if b == 0:
        return out
    dev = logits.get_device()
    if dev == torch.cuda.current_device():
        err = fn(*args, _stream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, _stream(dev))
    if err != 0:
        raise RuntimeError(f"badge_factors kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


# Launch flags (csrc/badge.cu): 16-byte rows of logits (and of a), of the
# embedding.
_VEC_ROWS, _VEC_EMB = 1, 2

_fn = None
_stream = None
_smem_limit = None


def _kernel():
    """The C entry point, built and bound at first use, with the current
    stream's reader and the kernel's shared-memory limit in bytes."""
    global _fn, _stream, _smem_limit
    if _fn is None:
        lib = _build.load("badge")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.badge_factors_f32
        fn.argtypes = [p, p, i, i, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
        lib.badge_smem_limit.argtypes = []
        lib.badge_smem_limit.restype = ctypes.c_int
        _smem_limit = lib.badge_smem_limit()
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        _stream = raw if raw is not None else (
            lambda d: torch.cuda.current_stream(d).cuda_stream)
        _fn = fn
    return _fn
