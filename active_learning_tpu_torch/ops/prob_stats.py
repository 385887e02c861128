"""Kernel A: softmax statistics of a batch of logits (ROADMAP K3).

Replaces the JAX package's ``strategies/scoring.py::make_prob_stats_step``
softmax pass (scoring.py:109-126).  ``prob_stats`` launches the CUDA
kernel of ``csrc/prob_stats.cu`` on a CUDA tensor and runs
``prob_stats_reference``, the plain version, only on a CPU tensor.  A
call on the card allocates once and makes one ctypes call, so a served
batch is not paced by the host.

Output, per row: ``confidence`` (top-1 probability), ``margin`` (top-1
minus top-2 probability), ``entropy`` (``-sum p log p`` with
``0 log 0 := 0``), all float32, and ``pred`` (int32, the top-1 index;
ties go to the lower index, as ``jax.lax.top_k`` ranks them).  A row
holding a NaN or a +inf has NaN probabilities throughout, as in the
reference: ``pred`` 0, ``confidence`` and ``margin`` NaN.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build

# Launches of the CUDA kernel since the process started (or since a
# caller reset it): a run reads it to show its path went through the
# kernel.
launches = 0

MAX_CLASSES = 12288  # the row lives in 48 KB of shared memory


def prob_stats_reference(logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The JAX step's math in torch, float32: softmax and log-softmax
    from the shifted logits, top-2 over the probabilities with ties to
    the lower index (argmax returns the first maximum), entropy with
    the underflowed probabilities pinned to 0."""
    x = logits.to(torch.float32)
    shifted = x - x.max(dim=-1, keepdim=True).values
    e = torch.exp(shifted)
    s = e.sum(dim=-1, keepdim=True)
    p = e / s
    logp = shifted - torch.log(s)
    pred = torch.argmax(p, dim=-1)
    top1 = p.gather(-1, pred[:, None])[:, 0]
    rest = p.scatter(-1, pred[:, None], float("-inf"))
    top2 = rest.max(dim=-1).values
    entropy = -torch.where(p > 0, p * logp, torch.zeros_like(p)).sum(dim=-1)
    return {"confidence": top1, "margin": top1 - top2, "entropy": entropy,
            "pred": pred.to(torch.int32)}


def _check(logits: torch.Tensor) -> None:
    if logits.ndim != 2:
        raise ValueError(f"logits must be [B, C], got {tuple(logits.shape)}")
    if not 2 <= logits.shape[1] <= MAX_CLASSES:
        raise ValueError(f"prob_stats needs 2 <= C <= {MAX_CLASSES} "
                         f"classes, got {logits.shape[1]}")
    if logits.dtype != torch.float32:
        raise TypeError(f"logits must be float32, got {logits.dtype}")


def prob_stats(logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Softmax statistics of float32 logits ``[B, C]``: the kernel on a
    CUDA tensor (contiguous rows required), the plain version on a CPU
    tensor.  On the card the four outputs are rows of one ``[4, B]``
    allocation, ``pred`` its last row viewed as int32."""
    global launches
    _check(logits)
    if not logits.is_cuda:
        if logits.device.type != "cpu":
            raise ValueError(f"prob_stats: unsupported device "
                             f"{logits.device}")
        return prob_stats_reference(logits)
    if not logits.is_contiguous():
        raise ValueError("prob_stats: logits must be contiguous")
    b = logits.shape[0]
    out = torch.empty(4, b, dtype=torch.float32, device=logits.device)
    conf, margin, entropy, pred = out.unbind(0)
    stats = {"confidence": conf, "margin": margin, "entropy": entropy,
             "pred": pred.view(torch.int32)}
    if b == 0:
        return stats
    fn = _kernel()
    dev = logits.get_device()
    if dev == torch.cuda.current_device():
        err = fn(logits.data_ptr(), b, logits.shape[1], out.data_ptr(),
                 _stream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(logits.data_ptr(), b, logits.shape[1], out.data_ptr(),
                     _stream(dev))
    if err != 0:
        raise RuntimeError(f"prob_stats kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return stats


# The C entry point's argument types (csrc/prob_stats.cu).
_ARGTYPES = {"prob_stats_f32": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_void_p]}

_fn = None
_stream = None


def _kernel():
    """The C entry point, built and bound at first use, with the current
    stream's reader."""
    global _fn, _stream
    if _fn is None:
        fn = _build.load("prob_stats").prob_stats_f32
        fn.argtypes = _ARGTYPES["prob_stats_f32"]
        fn.restype = ctypes.c_int
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        _stream = raw if raw is not None else (
            lambda d: torch.cuda.current_stream(d).cuda_stream)
        _fn = fn
    return _fn
