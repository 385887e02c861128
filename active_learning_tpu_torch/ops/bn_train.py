"""Kernel C: training-mode BatchNorm (the training half of ROADMAP K1),
CUDA C++ in ``csrc/bn_train.cu``.

Replaces the JAX package's ``ops/backward.py:131-214`` ``fused_bn_train``
(the custom VJP ``FusedBatchNorm`` trains through) and the autodiff of
flax ``nn.BatchNorm`` in training mode.  Three wrappers, each launching
one device function of kernel C on a CUDA tensor and running its plain
version only on a CPU tensor:

  * ``bn_stats(x) -> (mean, mean2)``: per-channel E[x] and E[x²], bf16
    (or f32) reads, f32 square and sums, each sum times 1/n;
  * ``bn_bwd_reduce(gy, x) -> (Σgy, Σgy·x)``;
  * ``bn_dx(gy, x, mul, c2, c1) -> gy·mul + x·c2 + c1``, rounded once.

``bn_train`` puts them behind one ``torch.autograd.Function``.  With a
``group`` of N ranks (the port's ``parallel.mesh.Mesh``: anything with
``world_size`` and an in-place ``all_reduce``), the statistics are the
global batch's, as the JAX model's ``axis_name`` branch
(``models/resnet.py:171-187``) computes them: the forward all-reduces
the ``[2, C]`` (E[x], E[x²]) of kernel C and divides by N (``pmean``),
the backward all-reduces (Σgy, Σgy·x) and counts the rows of every
rank for dx, while ``scale``'s and ``bias``'s gradients stay this rank's
share (the gradient sync sums them).  The
normalize, residual add and ReLU of the forward are kernel B
(``ops/bn_act.py``) with the batch statistics' coefficients; the
per-channel ``[C]`` math (variance clamp, rsqrt, the backward's
coefficient chain) is tensor ops on ``[C]``.

Bound: device-memory bytes (see the source note in ``csrc/bn_train.cu``).
The plain versions accumulate in ``promote(dtype, float32)`` — float64
for a float64 input, which the CPU tests use to hold the formulas to
1e-10 of the JAX package's.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from . import bn_act as bn_act_lib

# Launches of each device function since the process started (or since
# a caller reset them): a run reads them to show its path went through
# the kernel.
stats_launches = 0
reduce_launches = 0
dx_launches = 0

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_LANES = 8
_MAX_BLOCKS = 1024


def reset_launches() -> None:
    global stats_launches, reduce_launches, dx_launches
    stats_launches = reduce_launches = dx_launches = 0


def partition(rows: int) -> Tuple[int, int]:
    """(rows per block, blocks) of the reductions' fixed row partition:
    a function of the row count alone, so the summation order (and the
    result) never depends on the card's SM count or occupancy."""
    per = max(64, -(-rows // _MAX_BLOCKS))
    per = -(-per // _LANES) * _LANES
    return per, max(1, -(-rows // per))


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _check(name: str, *tensors: torch.Tensor) -> None:
    x = tensors[0]
    if x.ndim != 4:
        raise ValueError(f"{name}: x must be [B, C, H, W], got "
                         f"{tuple(x.shape)}")
    for t in tensors:
        if (t.shape != x.shape or t.dtype != x.dtype
                or t.device != x.device
                or not t.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError(f"{name}: inputs must share shape, dtype and "
                             "device, contiguous in channels_last")
    if x.device.type == "cuda":
        if x.dtype not in _KERNEL_DTYPES:
            raise TypeError(f"{name}: the kernel takes bf16 or f32, got "
                            f"{x.dtype}")
    elif x.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {x.device}")


def _rows(x: torch.Tensor) -> int:
    return x.shape[0] * x.shape[2] * x.shape[3]


def _inverse_count(x: torch.Tensor) -> float:
    """1/n, rounded to the accumulation dtype: XLA takes a mean as the
    sum times the reciprocal of the count, and so does the port."""
    n = _rows(x)
    if _acc(x.dtype) == torch.float64:
        return 1.0 / n
    return float(np.float32(1.0) / np.float32(n))


# -- plain versions ---------------------------------------------------------

def channel_sums_reference(a: torch.Tensor, b: torch.Tensor,
                           scale: float = 1.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σa·scale, Σa·b·scale) per channel, in promote(dtype, float32)."""
    acc = _acc(a.dtype)
    a32 = a.to(acc)
    b32 = a32 if b is a else b.to(acc)
    dims = (0, 2, 3)
    return a32.sum(dims) * scale, (a32 * b32).sum(dims) * scale


def bn_dx_reference(gy: torch.Tensor, x: torch.Tensor, mul: torch.Tensor,
                    c2: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    """``gy·mul + x·c2 + c1``: the kernel's separately rounded operations
    in the same order, one rounding to ``x.dtype`` at the end."""
    acc = _acc(x.dtype)
    m, k2, k1 = (v.to(acc).view(1, -1, 1, 1) for v in (mul, c2, c1))
    return (gy.to(acc) * m + x.to(acc) * k2 + k1).to(x.dtype)


# -- wrappers ---------------------------------------------------------------

def _channel_sums(a: torch.Tensor, b: torch.Tensor, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    c = a.shape[1]
    rows = _rows(a)
    per, nblk = partition(rows)
    out = torch.empty(2, c, dtype=torch.float32, device=a.device)
    if rows == 0:
        return out[0].fill_(float("nan")), out[1].fill_(float("nan"))
    partial = torch.empty(nblk, 2, c, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("bn_channel_sums")(
            a.data_ptr(), b.data_ptr(), int(a.dtype == torch.bfloat16),
            rows, c, per, nblk, partial.data_ptr(), float(scale),
            out[0].data_ptr(), out[1].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bn_train channel sums: CUDA error {err}")
    return out[0], out[1]


def bn_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (E[x], E[x²]) of a channels-last ``[B, C, H, W]``
    activation: kernel C on a CUDA tensor, the plain version on a CPU
    tensor."""
    global stats_launches
    _check("bn_stats", x)
    inv = _inverse_count(x)
    if x.device.type == "cpu":
        return channel_sums_reference(x, x, inv)
    out = _channel_sums(x, x, inv)
    stats_launches += 1
    return out


def bn_bwd_reduce(gy: torch.Tensor, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (Σgy, Σgy·x): kernel C on a CUDA tensor, the plain
    version on a CPU tensor."""
    global reduce_launches
    _check("bn_bwd_reduce", gy, x)
    if gy.device.type == "cpu":
        return channel_sums_reference(gy, x)
    out = _channel_sums(gy, x, 1.0)
    reduce_launches += 1
    return out


def bn_dx(gy: torch.Tensor, x: torch.Tensor, mul: torch.Tensor,
          c2: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    """``gy·mul + x·c2 + c1`` with per-channel coefficients, rounded once
    to ``x.dtype``: kernel C on a CUDA tensor, the plain version on a
    CPU tensor."""
    global dx_launches
    _check("bn_dx", gy, x)
    if x.device.type == "cpu":
        return bn_dx_reference(gy, x, mul, c2, c1)
    c = x.shape[1]
    coeffs = [v.to(torch.float32).contiguous() for v in (mul, c2, c1)]
    for v in coeffs:
        if v.shape != (c,) or v.device != x.device:
            raise ValueError(f"bn_dx: coefficients must be [{c}] on "
                             f"{x.device}")
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    rows = _rows(x)
    if rows == 0:
        return dx
    per, nblk = partition(rows)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("bn_dx")(
            gy.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16),
            rows, c, per, nblk, coeffs[0].data_ptr(), coeffs[1].data_ptr(),
            coeffs[2].data_ptr(), dx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bn_dx kernel launch failed: CUDA error {err}")
    dx_launches += 1
    return dx


# -- the autograd Function --------------------------------------------------

def backward_coefficients(s1: torch.Tensor, s2: torch.Tensor,
                          scale: torch.Tensor, mean: torch.Tensor,
                          mean2: torch.Tensor, eps: float, n: float,
                          dtype: torch.dtype, fused_stats: bool):
    """The per-channel chain of ``ops/backward.py:174-203`` from the two
    reductions: returns ``(dscale, dbias, mul, c2, c1)`` with ``dx = gy·mul
    + x·c2 + c1``.  ``mul`` is the forward's multiplier as the forward
    used it: rounded to ``dtype`` for the fused formula, unrounded for
    flax's.  ``dvar`` passes the variance clamp with jax's balanced
    gradient (half at ``mean2 == mean²``)."""
    a_pre = mean2 - mean * mean
    var = torch.clamp(a_pre, min=0.0)
    r = torch.rsqrt(var + eps)
    mulf = scale * r
    mul = mulf.to(dtype).to(mulf.dtype) if fused_stats else mulf
    dmul = s2 - s1 * mean
    dscale = dmul * r
    dvar = dmul * scale * (-0.5) * r * r * r
    da = dvar * torch.where(a_pre > 0, 1.0,
                            torch.where(a_pre == 0, 0.5, 0.0)).to(dvar.dtype)
    dmean = -s1 * mul - 2.0 * mean * da
    c2 = 2.0 * da / n
    c1 = dmean / n
    return dscale, s1, mul, c2, c1


class BatchNormTrain(torch.autograd.Function):
    """Training-mode BatchNorm with batch statistics, optional residual
    add and ReLU: forward ``(y, mean, var)``, backward through kernel C.

    ``mean`` and ``var`` are returned for the running-statistics update
    and carry no gradient: the backward takes their cotangents as zero,
    which is what the model's use of them (an update outside the graph)
    gives.  The ReLU's gradient masks the cotangent where the output is
    not positive (jax.nn.relu's zero gradient at 0); that masked tensor
    is also the residual's gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, relu: bool, eps: float,
                fused_stats: bool, group=None):
        mean, mean2 = bn_stats(x)
        if group is not None and group.world_size > 1:
            stats = group.all_reduce(torch.stack([mean, mean2]))
            mean, mean2 = stats / group.world_size
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        coeffs = bn_act_lib.bn_coefficients(scale, bias, mean, var, eps,
                                            x.dtype, fused_stats)
        y = bn_act_lib.bn_act(x, coeffs, residual, relu)
        ctx.save_for_backward(x, scale, mean, mean2, y if relu else None)
        ctx.relu = relu
        ctx.has_residual = residual is not None
        ctx.eps = eps
        ctx.fused_stats = fused_stats
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, scale, mean, mean2, y = ctx.saved_tensors
        gy = gy.contiguous(memory_format=torch.channels_last)
        if ctx.relu:
            gy = torch.where(y > 0, gy, torch.zeros((), dtype=gy.dtype,
                                                    device=gy.device))
        s1, s2 = bn_bwd_reduce(gy, x)
        n = float(_rows(x))

        def coefficients(a, b, rows):
            return backward_coefficients(a, b, scale.to(a.dtype), mean,
                                         mean2, ctx.eps, rows, x.dtype,
                                         ctx.fused_stats)

        group = ctx.group
        if group is not None and group.world_size > 1:
            # dx reaches every rank's rows through the global statistics:
            # global sums.  The parameters' gradients are this rank's
            # share; the gradient sync adds the others'.
            dscale, dbias = coefficients(s1, s2, n)[:2]
            s1, s2 = group.all_reduce(torch.stack([s1, s2]))
            _, _, mul, c2, c1 = coefficients(s1, s2, n * group.world_size)
        else:
            dscale, dbias, mul, c2, c1 = coefficients(s1, s2, n)
        dx = bn_dx(gy, x, mul, c2, c1)
        gres = gy if ctx.has_residual else None
        return (dx, dscale.to(scale.dtype), dbias.to(scale.dtype), gres,
                None, None, None, None)


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float, fused_stats: bool,
             residual: Optional[torch.Tensor] = None, relu: bool = False,
             group=None):
    """Training-mode BatchNorm of a channels-last activation: returns
    ``(y, mean, var)`` with the biased batch variance ``max(E[x²] −
    E[x]², 0)``.  ``fused_stats`` picks ``FusedBatchNorm``'s formula
    (``x·mul − sub`` with ``mul``, ``sub`` rounded to ``x.dtype``), else
    flax ``nn.BatchNorm``'s (float32 coefficients).  ``group``: the
    ranks whose rows share the statistics (None: this batch alone)."""
    return BatchNormTrain.apply(x, scale, bias, residual, bool(relu),
                                float(eps), bool(fused_stats), group)


_fns = {}


def _fn(name: str):
    """A C entry point of ``csrc/bn_train.cu``, built and bound at first
    use."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("bn_train"), name)
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        if name == "bn_channel_sums":
            fn.argtypes = [ptr, ptr, i32, i64, i32, i32, i32, ptr, f32, ptr,
                           ptr, ptr]
        else:
            fn.argtypes = [ptr, ptr, i32, i64, i32, i32, i32, ptr, ptr, ptr,
                           ptr, ptr]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn
