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

The kernel reads a table of leaves (``leaf_split`` cuts each into a
scalar head, a body of 16-byte vectors and a scalar tail), built on the
first call and kept while every buffer stays where it is: a train step
hands the same parameter and momentum tensors and, from the caching
allocator, usually the same gradient addresses, step after step.  On
such a call the wrapper compares the facts the checks read with the
ones they passed, a few whole-list operations instead of a loop over the
leaves (see ``_hit``).
"""

from __future__ import annotations

import ctypes
import operator
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

# Launches of the CUDA kernel since the process started (or since a
# caller reset it).
launches = 0

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


def leaf_split(p_ptr: int, g_ptr: int, t_ptr: int, numel: int,
               t_size: int = 4) -> Tuple[int, int, int]:
    """(head, vectors, tail) of one leaf: ``head`` scalar elements until
    the param, grad and trace (``t_size`` bytes an element; ``t_ptr`` 0
    for none) all reach a 16-byte boundary (8 for a bf16 trace) at the
    same element, then ``vectors`` runs of 4 elements, then ``tail``
    scalar ones.  Buffers that never align together make the whole leaf
    its head."""
    if numel <= 0:
        return 0, 0, 0
    head = (-p_ptr % 16) // 4
    ok = p_ptr % 4 == 0 and (g_ptr + 4 * head) % 16 == 0
    if t_ptr:
        ok = ok and (t_ptr + t_size * head) % (4 * t_size) == 0
    if not ok or head >= numel:
        return numel, 0, 0
    vectors = (numel - head) // 4
    return head, vectors, numel - head - 4 * vectors


_ROW = 8   # csrc kRow: p, g, t, first unit, vectors, head, numel, 0


def leaf_table(rows: Sequence[Tuple[int, int, int, int]],
               t_size: int = 4) -> Tuple[np.ndarray, int]:
    """The kernel's table [L, 8] int64 of (p, g, t, numel) rows and the
    total of its work units (a leaf's vectors, then its head and tail
    elements)."""
    table = np.zeros((len(rows), _ROW), dtype=np.int64)
    units = 0
    for i, (p, g, t, n) in enumerate(rows):
        head, vectors, tail = leaf_split(p, g, t, n, t_size)
        table[i, :7] = (p, g, t, units, vectors, head, n)
        units += vectors + head + tail
    return table, units


class _Plan(NamedTuple):
    """The device table of one set of buffers, and every fact about them
    that ``_check`` read: the table stays right, and the checks stay
    passed, for buffers with the same facts."""
    p_ptrs: Tuple[int, ...]
    g_ptrs: Tuple[int, ...]
    t_ptrs: Optional[Tuple[int, ...]]
    metas: Tuple            # (shape, dtype) of each param
    t_metas: Optional[Tuple]
    strides: Tuple
    device: int
    table: torch.Tensor
    units: int
    trace_bf16: bool


_plan_cache: Optional[_Plan] = None
_ptr = torch.Tensor.data_ptr
_stride = torch.Tensor.stride
_get_device = torch.Tensor.get_device
_meta = operator.attrgetter("shape", "dtype")


def _hit(pl: _Plan, params, grads, traces) -> bool:
    """Whether ``pl`` describes these buffers: params, grads and traces
    at the table's addresses, on its device, with the shapes, dtypes and
    strides ``_check`` passed (the grads are new tensors each step, the
    params and traces the same ones updated in place; either way every
    fact ``_check`` reads is compared, with no per-leaf Python loop)."""
    if len(params) != len(pl.p_ptrs) or len(grads) != len(params):
        return False
    if (traces is None) != (pl.t_ptrs is None):
        return False
    metas, strides = pl.metas, pl.strides
    ts = () if traces is None else traces
    return (tuple(map(_ptr, params)) == pl.p_ptrs
            and tuple(map(_ptr, grads)) == pl.g_ptrs
            and (traces is None or tuple(map(_ptr, traces)) == pl.t_ptrs)
            and tuple(map(_meta, params)) == metas
            and tuple(map(_meta, grads)) == metas
            and (traces is None or tuple(map(_meta, traces)) == pl.t_metas)
            and tuple(map(_stride, params)) == strides
            and tuple(map(_stride, grads)) == strides
            and (traces is None or tuple(map(_stride, traces)) == strides)
            and set(map(_get_device, params)).union(
                map(_get_device, grads), map(_get_device, ts))
            == {pl.device})


def _plan(params, grads, traces) -> _Plan:
    """The device table for these buffers: the cached one when
    ``_hit``, else built after the full checks."""
    global _plan_cache
    pl = _plan_cache
    if pl is not None and _hit(pl, params, grads, traces):
        return pl
    _check(params, grads, traces)
    dev = params[0].device
    if dev.type != "cuda":
        raise ValueError(f"fused_sgd: unsupported device {dev}")
    trace_bf16 = traces is not None and traces[0].dtype == torch.bfloat16
    p_ptrs, g_ptrs = tuple(map(_ptr, params)), tuple(map(_ptr, grads))
    t_ptrs = tuple(map(_ptr, traces)) if traces is not None else None
    rows = [(p, g, t_ptrs[i] if t_ptrs else 0, v.numel())
            for i, (p, g, v) in enumerate(zip(p_ptrs, g_ptrs, params))]
    table, units = leaf_table(rows, 2 if trace_bf16 else 4)
    _plan_cache = _Plan(
        p_ptrs, g_ptrs, t_ptrs, tuple(map(_meta, params)),
        tuple(map(_meta, traces)) if traces is not None else None,
        tuple(map(_stride, params)), dev.index,
        torch.from_numpy(table).to(dev), units, trace_bf16)
    return _plan_cache


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
    if not params:
        _check(params, grads, traces)
        return
    if params[0].device.type == "cpu":
        _check(params, grads, traces)
        fused_sgd_reference(params, grads, traces, lr, momentum,
                            weight_decay)
        return
    pl = _plan(params, grads, traces)
    neg_lr, mu, wd = _scalars(lr, momentum, weight_decay)
    with torch.cuda.device(pl.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            pl.table.data_ptr(), len(pl.p_ptrs), pl.units,
            int(pl.trace_bf16), int(bool(momentum)),
            int(bool(weight_decay)), float(neg_lr), float(mu), float(wd),
            stream)
    if err != 0:
        raise RuntimeError(f"fused_sgd kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    # The kernel wrote through raw pointers: mark the buffers as written,
    # as an in-place torch op would, so caches keyed on ``_version`` (the
    # models' compute-dtype weights and BatchNorm coefficients) see it.
    torch.autograd.graph.increment_version(params)
    if traces is not None:
        torch.autograd.graph.increment_version(traces)


_fn = None


def _kernel():
    """The C entry point, built and bound at first use."""
    global _fn
    if _fn is None:
        fn = _build.load("fused_sgd").fused_sgd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn
