"""Kernel J: the four device steps of the int8 block-scaled gradient
sync (ROADMAP K8), CUDA C++ in ``csrc/int8_sync.cu``.

Replaces the per-device arithmetic of the JAX package's
``parallel/mesh.py:472`` ``int8_allreduce`` and ``:534``
``int8_reduce_scatter``.  The collectives sit between the steps, so
they are four device functions, not one; ``parallel/mesh.py`` strings
them together around ``torch.distributed``:

  * ``block_absmax(x) -> absmax``: the max of ``|x|`` over each block of
    ``BLOCK`` float32 values; a block holding a NaN or an inf comes out
    ``+inf``.  (The cross-rank max that follows is NCCL's or gloo's,
    and neither promises to carry a NaN through a max; ``+inf`` survives
    it, and the JAX rule only asks whether a block is finite.)
  * ``quantize(x, absmax, slot_of_block) -> (q, scale)``: ``scale =
    max(absmax, 1e-30) · float32(1/127)`` and ``q = clip(round(x /
    scale), ±127)`` as int8, an IEEE division and round-half-to-even as
    ``jnp.round`` of a true division gives; a non-finite block writes
    zeros.  The JAX function writes ``/ 127``; its trainer runs it
    jitted, and XLA's algebraic simplifier folds that division into a
    multiply by the float32 reciprocal, so the port multiplies too (and
    so for the reduce-scatter owner's ``scale2``).  Block
    ``b`` lands at slot ``slot_of_block[b]`` (identity when None): the
    reduce-scatter form's send order ``[dest][leaf][blocks]``.
  * ``dequant_sum(q, scale, absmax, slot_of_block) -> out``: for each
    block ``b`` at slot ``s``, ``(Σ_t q[t, s]) · scale[s]`` over the T
    gathered payloads, NaN where ``absmax[b]`` is not finite.  A sum of
    integers of magnitude at most 127·T is exact in float32, so with one
    shared scale this is JAX's ``total * scale`` bit for bit.
  * ``sum_requantize(recv, my_scale) -> (q2, scale2)``: the
    reduce-scatter owner's ``reduced = (Σ_t recv[t]) · my_scale``, then
    its own block absmax, ``scale2`` and int8 re-quantization in one
    pass (a non-finite block: ``scale2 = inf``, zeros).

Each wrapper launches its device function on a CUDA tensor and runs its
plain version (``*_reference``, the same arithmetic in PyTorch) only on
a CPU tensor.  Bound: device-memory bytes (see the source note).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

# Elements per quantization block (the JAX package's mesh.INT8_BLOCK).
BLOCK = 256
# max(absmax, SCALE_FLOOR): an all-zero block gets a finite scale.
SCALE_FLOOR = float(np.float32(1e-30))
QMAX = 127.0
# float32(1/127): the reciprocal XLA folds ``/ 127`` into.
INV_QMAX = np.float32(1.0) / np.float32(QMAX)

# Launches of each device function since the process started (or since
# a caller reset them).  Thread ranks (``parallel.mesh.run_thread_ranks``)
# launch from several threads: the counts move under the lock.
_count_lock = threading.Lock()
absmax_launches = 0
quantize_launches = 0
dequant_launches = 0
requantize_launches = 0

_NAN = float("nan")
_INF = float("inf")


def reset_launches() -> None:
    global absmax_launches, quantize_launches, dequant_launches
    global requantize_launches
    absmax_launches = quantize_launches = dequant_launches = 0
    requantize_launches = 0


# -- plain versions ---------------------------------------------------------

def block_absmax_reference(x: torch.Tensor) -> torch.Tensor:
    a = x.view(-1, BLOCK).abs().amax(dim=1)
    return torch.where(torch.isfinite(a), a, _INF)


def _quantize_blocks(blocks: torch.Tensor, absmax: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(absmax, min=SCALE_FLOOR) * torch.tensor(
        INV_QMAX, device=absmax.device)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -QMAX, QMAX)
    q = torch.where(torch.isfinite(absmax)[:, None], q, 0.0)
    return q.to(torch.int8), scale


def quantize_reference(x: torch.Tensor, absmax: torch.Tensor,
                       slot_of_block: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    q, scale = _quantize_blocks(x.view(-1, BLOCK), absmax)
    if slot_of_block is not None:
        q = torch.empty_like(q).index_copy_(0, slot_of_block.long(), q)
        scale = torch.empty_like(scale).index_copy_(
            0, slot_of_block.long(), scale)
    return q.view(-1), scale


def dequant_sum_reference(q: torch.Tensor, scale: torch.Tensor,
                          absmax: torch.Tensor,
                          slot_of_block: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    total = q.view(q.shape[0], -1, BLOCK).to(torch.float32).sum(0)
    if slot_of_block is not None:
        total = total[slot_of_block.long()]
        scale = scale[slot_of_block.long()]
    out = total * scale[:, None]
    out = torch.where(torch.isfinite(absmax)[:, None], out, _NAN)
    return out.view(-1)


def sum_requantize_reference(recv: torch.Tensor, my_scale: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    reduced = recv.view(recv.shape[0], -1, BLOCK).to(torch.float32).sum(0) \
        * my_scale[:, None]
    q2, scale2 = _quantize_blocks(reduced,
                                  block_absmax_reference(reduced.view(-1)))
    return q2.view(-1), scale2


# -- wrappers ---------------------------------------------------------------

def _check_flat(name: str, x: torch.Tensor, dtype: torch.dtype,
                align: int) -> None:
    if x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor, "
                         f"got {x.dtype}")
    if x.device.type == "cuda":
        if x.data_ptr() % align:
            raise ValueError(f"{name}: the kernel needs {align}-byte "
                             "aligned buffers")
    elif x.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {x.device}")


def _check_blocks(name: str, x: torch.Tensor) -> int:
    if x.numel() % BLOCK:
        raise ValueError(f"{name}: {x.numel()} elements is not a multiple "
                         f"of the {BLOCK}-element block")
    return x.numel() // BLOCK


def _check_map(name: str, slot_of_block: Optional[torch.Tensor], nb: int,
               dev: torch.device) -> None:
    if slot_of_block is None:
        return
    if (slot_of_block.dtype != torch.int32 or slot_of_block.shape != (nb,)
            or slot_of_block.device != dev
            or not slot_of_block.is_contiguous()):
        raise ValueError(f"{name}: slot_of_block must be int32 [{nb}] on "
                         f"{dev}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def block_absmax(x: torch.Tensor) -> torch.Tensor:
    """Per-block max of ``|x|`` over a flat float32 buffer (non-finite
    blocks ``+inf``): kernel J on a CUDA tensor, the plain version on a
    CPU tensor."""
    global absmax_launches
    _check_flat("block_absmax", x, torch.float32, 16)
    nb = _check_blocks("block_absmax", x)
    if x.device.type == "cpu":
        return block_absmax_reference(x)
    out = torch.empty(nb, dtype=torch.float32, device=x.device)
    if nb:
        with torch.cuda.device(x.device):
            _raise_on(_fn("int8_block_absmax")(
                x.data_ptr(), nb, out.data_ptr(), _stream(x.device)),
                "block_absmax")
        with _count_lock:
            absmax_launches += 1
    return out


def quantize(x: torch.Tensor, absmax: torch.Tensor,
             slot_of_block: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 payload and per-slot scales of a flat float32 buffer against
    the shared per-block ``absmax``: kernel J on a CUDA tensor, the
    plain version on a CPU tensor."""
    global quantize_launches
    _check_flat("quantize", x, torch.float32, 16)
    nb = _check_blocks("quantize", x)
    _check_flat("quantize", absmax, torch.float32, 4)
    if absmax.shape != (nb,) or absmax.device != x.device:
        raise ValueError(f"quantize: absmax must be [{nb}] on {x.device}")
    _check_map("quantize", slot_of_block, nb, x.device)
    if x.device.type == "cpu":
        return quantize_reference(x, absmax, slot_of_block)
    q = torch.empty(nb * BLOCK, dtype=torch.int8, device=x.device)
    scale = torch.empty(nb, dtype=torch.float32, device=x.device)
    if nb:
        with torch.cuda.device(x.device):
            _raise_on(_fn("int8_quantize")(
                x.data_ptr(), absmax.data_ptr(),
                slot_of_block.data_ptr() if slot_of_block is not None else 0,
                nb, SCALE_FLOOR, q.data_ptr(), scale.data_ptr(),
                _stream(x.device)), "quantize")
        with _count_lock:
            quantize_launches += 1
    return q, scale


def dequant_sum(q: torch.Tensor, scale: torch.Tensor, absmax: torch.Tensor,
                slot_of_block: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """``[T, slots·BLOCK]`` int8 payloads -> the float32 sum over T of
    each block times its slot's scale, NaN on non-finite blocks: kernel
    J on a CUDA tensor, the plain version on a CPU tensor."""
    global dequant_launches
    if q.dim() != 2:
        raise ValueError("dequant_sum: q must be [T, slots * BLOCK]")
    _check_flat("dequant_sum", q, torch.int8, 8)
    nslots = _check_blocks("dequant_sum", q[0])
    nb = absmax.numel()
    _check_flat("dequant_sum", absmax, torch.float32, 4)
    _check_flat("dequant_sum", scale, torch.float32, 4)
    if scale.shape != (nslots,) or (slot_of_block is None and nb != nslots):
        raise ValueError("dequant_sum: scale must have one value per slot, "
                         "absmax one per block")
    for t in (scale, absmax):
        if t.device != q.device:
            raise ValueError(f"dequant_sum: inputs must be on {q.device}")
    _check_map("dequant_sum", slot_of_block, nb, q.device)
    if q.device.type == "cpu":
        return dequant_sum_reference(q, scale, absmax, slot_of_block)
    out = torch.empty(nb * BLOCK, dtype=torch.float32, device=q.device)
    if nb:
        with torch.cuda.device(q.device):
            _raise_on(_fn("int8_dequant_sum")(
                q.data_ptr(), q.shape[0], q.shape[1],
                slot_of_block.data_ptr() if slot_of_block is not None else 0,
                scale.data_ptr(), absmax.data_ptr(), nb, out.data_ptr(),
                _stream(q.device)), "dequant_sum")
        with _count_lock:
            dequant_launches += 1
    return out


def sum_requantize(recv: torch.Tensor, my_scale: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reduce-scatter owner's step: ``[T, slots·BLOCK]`` received
    payloads summed and scaled by ``my_scale``, then re-quantized
    against their own block absmax: kernel J on a CUDA tensor, the
    plain version on a CPU tensor."""
    global requantize_launches
    if recv.dim() != 2:
        raise ValueError("sum_requantize: recv must be [T, slots * BLOCK]")
    _check_flat("sum_requantize", recv, torch.int8, 8)
    ns = _check_blocks("sum_requantize", recv[0])
    _check_flat("sum_requantize", my_scale, torch.float32, 4)
    if my_scale.shape != (ns,) or my_scale.device != recv.device:
        raise ValueError(f"sum_requantize: my_scale must be [{ns}] on "
                         f"{recv.device}")
    if recv.device.type == "cpu":
        return sum_requantize_reference(recv, my_scale)
    q2 = torch.empty(ns * BLOCK, dtype=torch.int8, device=recv.device)
    scale2 = torch.empty(ns, dtype=torch.float32, device=recv.device)
    if ns:
        with torch.cuda.device(recv.device):
            _raise_on(_fn("int8_sum_requantize")(
                recv.data_ptr(), recv.shape[0], recv.shape[1],
                my_scale.data_ptr(), ns, SCALE_FLOOR, q2.data_ptr(),
                scale2.data_ptr(), _stream(recv.device)), "sum_requantize")
        with _count_lock:
            requantize_launches += 1
    return q2, scale2


_fns = {}

_ptr, _i32, _i64, _f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
_ARGTYPES = {
    "int8_block_absmax": [_ptr, _i64, _ptr, _ptr],
    "int8_quantize": [_ptr, _ptr, _ptr, _i64, _f32, _ptr, _ptr, _ptr],
    "int8_dequant_sum": [_ptr, _i32, _i64, _ptr, _ptr, _ptr, _i64, _ptr,
                         _ptr],
    "int8_sum_requantize": [_ptr, _i32, _i64, _ptr, _i64, _f32, _ptr, _ptr,
                            _ptr],
}


def _fn(name: str):
    """A C entry point of ``csrc/int8_sync.cu``, built and bound at first
    use."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("int8_sync"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn
