"""Kernel D: the fused SGD + momentum + weight-decay update (ROADMAP K2),
CUDA C++ in ``csrc/fused_sgd.cu``.

Replaces the JAX package's ``train/optim.py:97-128`` ``fused_sgd_update``.
``fused_sgd_update`` updates every leaf in place (the JAX arrays are
immutable and the train step donates them; here the parameter and
momentum buffers are overwritten, which saves the second copy): one
kernel launch for all leaves on CUDA tensors, ``fused_sgd_reference`` —
the plain version — only on CPU tensors.

The op sequence is ``fused_sgd_update``'s, each product and sum rounded
on its own: ``d = g + wd·p`` (``d = g`` when ``wd == 0``), ``t' = d +
μ·t`` in float32 stored in the state dtype, ``p' = p + (−lr)·t'``; with
no momentum ``p' = p + (−lr)·d``.  Scalars are rounded to float32 first,
as JAX's weakly typed Python scalars are.  Bound: device-memory bytes
(see the note in the source).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

# Launches of the CUDA kernel since the process started (or since a
# caller reset it).
launches = 0

CHUNK = 4096


def _check(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
           traces: Optional[Sequence[torch.Tensor]]) -> None:
    if len(params) != len(grads) or (traces is not None
                                     and len(traces) != len(params)):
        raise ValueError("fused_sgd: params, grads and traces differ in "
                         "length")
    if not params:
        return
    dev = params[0].device
    tdtype = traces[0].dtype if traces else None
    for i, (p, g) in enumerate(zip(params, grads)):
        t = traces[i] if traces is not None else None
        if p.dtype != torch.float32 or g.dtype != torch.float32:
            raise TypeError("fused_sgd: params and grads must be float32")
        if g.shape != p.shape or (t is not None and t.shape != p.shape):
            raise ValueError(f"fused_sgd: leaf {i} shapes differ")
        if not _dense(p):
            raise ValueError(f"fused_sgd: leaf {i} is not dense")
        for v in (p, g) if t is None else (p, g, t):
            if v.device != dev or v.stride() != p.stride():
                raise ValueError("fused_sgd: a leaf's param, grad and trace "
                                 f"must share one dense layout on {dev}")
        if t is not None and t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError("fused_sgd: traces must be float32 or bf16")
        if t is not None and t.dtype != tdtype:
            raise TypeError("fused_sgd: traces must share one dtype")


def _dense(v: torch.Tensor) -> bool:
    """Row-major or channels-last with no gaps: the kernel walks the
    storage as a flat array, which is the same element order for every
    buffer of a leaf when they share strides."""
    return v.is_contiguous() or (
        v.dim() == 4 and v.is_contiguous(memory_format=torch.channels_last))


def _scalars(lr: float, momentum: float, weight_decay: float):
    return (-np.float32(lr), np.float32(momentum), np.float32(weight_decay))


@torch.no_grad()
def fused_sgd_reference(params: Sequence[torch.Tensor],
                        grads: Sequence[torch.Tensor],
                        traces: Optional[Sequence[torch.Tensor]], lr: float,
                        momentum: float, weight_decay: float) -> None:
    """The plain version, in place: every product and sum its own float32
    operation, in the kernel's (and the JAX update's) order."""
    if not params:
        return
    neg_lr, mu, wd = (torch.tensor(v, dtype=torch.float32,
                                   device=params[0].device)
                      for v in _scalars(lr, momentum, weight_decay))
    for i, (p, g) in enumerate(zip(params, grads)):
        d = g + wd * p if weight_decay else g
        if momentum:
            t = traces[i]
            d = d + mu * t.to(torch.float32)
            t.copy_(d.to(t.dtype))
        p.copy_(p + neg_lr * d)


_tables: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor, int]] = {}


def _device_tables(params, grads, traces) -> Tuple[torch.Tensor,
                                                   torch.Tensor, int]:
    """The (leaves, chunks) tables on the device, rebuilt only when a
    buffer moved: the parameters and momentum are updated in place, and
    the caching allocator tends to hand the gradients the same addresses
    step after step."""
    rows = [(p.data_ptr(), g.data_ptr(),
             traces[i].data_ptr() if traces is not None else 0, p.numel())
            for i, (p, g) in enumerate(zip(params, grads))]
    key = (params[0].device, tuple(rows))
    hit = _tables.get(key)
    if hit is not None:
        return hit
    chunks = [(leaf, c) for leaf, (_, _, _, n) in enumerate(rows)
              for c in range(-(-n // CHUNK))]
    dev = params[0].device
    leaves_t = torch.tensor(np.asarray(rows, dtype=np.int64), device=dev)
    chunks_t = torch.tensor(np.asarray(chunks, dtype=np.int32).reshape(-1, 2),
                            device=dev)
    _tables.clear()
    _tables[key] = (leaves_t, chunks_t, len(chunks))
    return _tables[key]


@torch.no_grad()
def fused_sgd_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                     traces: Optional[List[torch.Tensor]], lr: float,
                     momentum: float, weight_decay: float) -> None:
    """One SGD step over every leaf, in place: kernel D (one launch) on
    CUDA tensors, the plain version on CPU tensors.  ``traces`` is None
    exactly when ``momentum`` is 0."""
    global launches
    if (traces is None) != (not momentum):
        raise ValueError("fused_sgd: traces must be given exactly when "
                         "momentum is non-zero")
    _check(params, grads, traces)
    if not params:
        return
    dev = params[0].device
    if dev.type == "cpu":
        fused_sgd_reference(params, grads, traces, lr, momentum,
                            weight_decay)
        return
    if dev.type != "cuda":
        raise ValueError(f"fused_sgd: unsupported device {dev}")
    leaves_t, chunks_t, nchunks = _device_tables(params, grads, traces)
    neg_lr, mu, wd = _scalars(lr, momentum, weight_decay)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            leaves_t.data_ptr(), chunks_t.data_ptr(), nchunks, CHUNK,
            int(traces is not None and traces[0].dtype == torch.bfloat16),
            int(bool(momentum)), int(bool(weight_decay)), float(neg_lr),
            float(mu), float(wd), stream)
    if err != 0:
        raise RuntimeError(f"fused_sgd kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1


_fn = None


def _kernel():
    """The C entry point, built and bound at first use."""
    global _fn
    if _fn is None:
        fn = _build.load("fused_sgd").fused_sgd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_float,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn
