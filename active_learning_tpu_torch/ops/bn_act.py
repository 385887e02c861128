"""Kernel B: eval-mode BatchNorm, optional residual add and ReLU in one
pass (the eval half of ROADMAP K1), in CUDA C++ (``csrc/bn_act.cu``).

Replaces the BatchNorm affine of the JAX package's
``models/resnet.py`` (``FusedBatchNorm`` ``x·mul − sub`` at
resnet.py:151-152,190-192, or flax ``nn.BatchNorm``) together with the
residual add and ReLU that follow it (resnet.py:257, :289, and the
stems' ``bn_stem`` + ReLU at :324-325, :346-347), which XLA fused into
the convolutions' epilogues on the TPU.

The per-channel coefficients depend only on the weights, so they are
computed once per channel (``bn_coefficients``, cached by the model)
and the kernel applies ``y = (x − shift)·mul + add`` to every element,
adds the residual, applies ReLU, and rounds to the activation dtype once
at the store.  The two formulas of the JAX package are two sets of
coefficients:

  * fused bf16 statistics (``FusedBatchNorm``): ``mul = (scale ·
    rsqrt(var + eps)).to(dtype)``, ``sub = mean.to(dtype)·mul −
    bias.to(dtype)`` in the activation dtype; shift 0, add −sub;
  * flax ``nn.BatchNorm`` (``bn_stats_dtype`` resolved to None): shift
    = mean, mul = rsqrt(var + eps)·scale, add = bias, in float32.

Bound: device-memory bytes (the source note in ``csrc/bn_act.cu`` says
how the kernel reads them).  The kernel does the plain version's
separately rounded float32 operations in the same order and agrees with
it bit for bit.  The host side is half of the design: a call looks up
its launch plan (``launch_plan``: variant, units, grid) by every fact
the checks read, allocates the output and makes one ctypes call on the
current stream, so a forward's 53 calls are not paced by the host.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _build

# Launches of the kernel since the process started (or since a caller
# reset it).
launches = 0

Coefficients = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_DTYPES = (torch.bfloat16, torch.float32)
_CPU_DTYPES = _DTYPES + (torch.float64,)


def bn_coefficients(scale: torch.Tensor, bias: torch.Tensor,
                    mean: torch.Tensor, var: torch.Tensor, eps: float,
                    dtype: torch.dtype, fused_stats: bool) -> Coefficients:
    """Per-channel ``(shift, mul, add)`` of the JAX package's BatchNorm
    for the activation ``dtype``: ``FusedBatchNorm``'s ``x·mul − sub``
    when ``fused_stats``, else flax's ``(x − mean)·(rsqrt(var +
    eps)·scale) + bias``.  float32 for bf16/f32 activations (float64
    for float64 ones, which only the CPU route takes)."""
    acc = torch.promote_types(dtype, torch.float32)
    if fused_stats:
        mul = (scale * torch.rsqrt(var + eps)).to(dtype)
        sub = mean.to(dtype) * mul - bias.to(dtype)
        return (torch.zeros_like(scale, dtype=acc), mul.to(acc),
                (-sub).to(acc))
    mul = torch.rsqrt(var + eps) * scale
    return mean.to(acc), mul.to(acc), bias.to(acc)


def bn_act_reference(x: torch.Tensor, coeffs: Coefficients,
                     residual: Optional[torch.Tensor] = None,
                     relu: bool = False) -> torch.Tensor:
    """The plain version: the same float32 operations in the same order,
    one rounding to ``x.dtype`` at the end (float64 throughout for a
    float64 ``x``)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    shift, mul, add = (v.view(1, -1, 1, 1) for v in coeffs)
    y = (x.to(acc) - shift) * mul + add
    if residual is not None:
        y = y + residual.to(acc)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _check(x: torch.Tensor, coeffs: Coefficients,
           residual: Optional[torch.Tensor]) -> None:
    if x.ndim != 4:
        raise ValueError(f"bn_act: x must be [B, C, H, W], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (_CPU_DTYPES if x.device.type == "cpu" else _DTYPES):
        raise TypeError(f"bn_act: x must be bf16 or f32 (or f64 on the "
                        f"CPU), got {x.dtype} on {x.device}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("bn_act: x must be contiguous in channels_last")
    c = x.shape[1]
    acc = torch.promote_types(x.dtype, torch.float32)
    for v in coeffs:
        if v.dtype != acc:
            raise TypeError(f"bn_act: coefficients must be {acc} for a "
                            f"{x.dtype} x, got {v.dtype}")
        if (v.shape != (c,) or v.device != x.device
                or not v.is_contiguous()):
            raise ValueError(f"bn_act: coefficients must be contiguous "
                             f"[{c}] on {x.device}")
    if residual is not None:
        if (residual.shape != x.shape or residual.dtype != x.dtype
                or residual.device != x.device
                or not residual.is_contiguous(
                    memory_format=torch.channels_last)):
            raise ValueError("bn_act: residual must match x in shape, "
                             "dtype, device and channels_last layout")


# Threads a block and units a thread of the kernel (csrc/bn_act.cu).
THREADS, UNROLL = 256, 4
# Variant bits of the C interface (csrc/bn_act.cu variant_kernel).
BF16, RES, RELU, VEC = 1, 2, 4, 8


class Plan(NamedTuple):
    """How the kernel walks one tensor: its variant bits, the units it
    holds (16-byte vectors of 8 bf16 or 4 float32 on the vector path,
    elements on the scalar path), the units in one pixel's row of
    channels, the elements a unit holds, and the blocks of the launch
    (``UNROLL`` units a thread, never fewer threads than ``upr``)."""
    variant: int
    units: int
    upr: int
    unit: int
    blocks: int


_plans: Dict[tuple, Plan] = {}


def launch_plan(x: torch.Tensor, coeffs: Coefficients,
                residual: Optional[torch.Tensor] = None, relu: bool = False,
                out: Optional[torch.Tensor] = None) -> Plan:
    """The kernel's plan for these tensors (and the output ``out``, when
    it exists yet): cached by every fact ``_check`` reads (shapes,
    strides, dtypes, devices) and by whether every pointer lies on 16
    bytes, so a cached plan is one whose checks passed for tensors with
    the same facts.  A miss runs the full checks."""
    shift, mul, add = coeffs
    ptrs = x.data_ptr() | shift.data_ptr() | mul.data_ptr() | add.data_ptr()
    if residual is not None:
        ptrs |= residual.data_ptr()
    if out is not None:
        ptrs |= out.data_ptr()
    key = (x.shape, x.stride(), x.dtype, x.get_device(), bool(relu),
           not ptrs & 15,
           shift.shape, shift.stride(), shift.dtype, shift.get_device(),
           mul.shape, mul.stride(), mul.dtype, mul.get_device(),
           add.shape, add.stride(), add.dtype, add.get_device(),
           None if residual is None else (
               residual.shape, residual.stride(), residual.dtype,
               residual.get_device()))
    pl = _plans.get(key)
    if pl is None:
        _check(x, coeffs, residual)
        bf16 = x.dtype == torch.bfloat16
        c = x.shape[1]
        width = 8 if bf16 else 4
        unit = width if not ptrs & 15 and c % width == 0 else 1
        variant = ((BF16 if bf16 else 0) | (RES if residual is not None
                                             else 0)
                   | (RELU if relu else 0) | (VEC if unit > 1 else 0))
        units, upr = x.numel() // unit, c // unit
        blocks = max(-(-units // (THREADS * UNROLL)), -(-upr // THREADS))
        pl = _plans[key] = Plan(variant, units, upr, unit, blocks)
    return pl


def bn_act(x: torch.Tensor, coeffs: Coefficients,
           residual: Optional[torch.Tensor] = None,
           relu: bool = False) -> torch.Tensor:
    """``relu?((x − shift)·mul + add [+ residual])`` rounded once to
    ``x.dtype``: the CUDA kernel on a CUDA tensor (bf16 or f32), the
    plain version on a CPU tensor (float64 too).  ``x`` (and
    ``residual``) must be channels-last."""
    global launches
    if not x.is_cuda:
        _check(x, coeffs, residual)
        if x.device.type != "cpu":
            raise ValueError(f"bn_act: unsupported device {x.device}")
        return bn_act_reference(x, coeffs, residual, relu)
    # x is dense channels-last (the plan's checks): its strides carry over.
    y = torch.empty_like(x)
    pl = launch_plan(x, coeffs, residual, relu, y)
    if pl.units == 0:
        return y
    dev = x.get_device()
    if dev == torch.cuda.current_device():
        err = _launch(x, coeffs, residual, y, pl, dev)
    else:
        with torch.cuda.device(dev):
            err = _launch(x, coeffs, residual, y, pl, dev)
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def _launch(x, coeffs, residual, y, pl: Plan, dev: int) -> int:
    shift, mul, add = coeffs
    return _fn()(x.data_ptr(),
                 residual.data_ptr() if residual is not None else None,
                 y.data_ptr(), shift.data_ptr(), mul.data_ptr(),
                 add.data_ptr(), pl.units, pl.upr, pl.variant, pl.blocks,
                 _stream(dev))


_entry = None
_stream = None


def _fn():
    """The C entry point, built and bound at first use, with the current
    stream's reader."""
    global _entry, _stream
    if _entry is None:
        fn = _build.load("bn_act").bn_act
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_longlong, i, i, i, p]
        fn.restype = ctypes.c_int
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        _stream = raw if raw is not None else (
            lambda d: torch.cuda.current_stream(d).cuda_stream)
        _entry = fn
    return _entry
