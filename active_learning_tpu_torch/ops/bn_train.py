"""Kernel C: training-mode BatchNorm (the training half of ROADMAP K1),
CUDA C++ in ``csrc/bn_train.cu``.

Replaces the JAX package's ``ops/backward.py:131-214`` ``fused_bn_train``
(the custom VJP ``FusedBatchNorm`` trains through) and the autodiff of
flax ``nn.BatchNorm`` in training mode.  Each wrapper launches its
device functions on a CUDA tensor and runs its plain version only on a
CPU tensor:

  * ``bn_forward_stats(x, ...)``: per-channel E[x] and E[x²] (bf16 or
    f32 reads, f32 square and sums, each sum times 1/n), then the
    variance ``max(E[x²] − E[x]², 0)``, kernel B's ``(shift, mul, add)``
    and the running-statistics update in place — two launches;
  * ``bn_stats(x)``: the means alone, for N ranks, whose all-reduced
    means go through ``bn_forward_chain`` (one launch);
  * ``bn_backward(gy, x, y, ...)``: (Σgy, Σgy·x) with gy masked where the
    forward's output ``y`` is not positive (its ReLU), then the chain of
    ``backward_coefficients`` — two launches; for N ranks
    ``bn_backward_local`` (this rank's sums and parameter gradients) and,
    after the all-reduce, ``bn_backward_chain`` (one launch);
  * ``bn_dx(gy, x, y, mul, c2, c1)``: ``gy·mul + x·c2 + c1``, rounded
    once, and the masked gy (the residual's gradient) when asked.

``bn_train`` puts them behind one ``torch.autograd.Function``: on one
rank the forward is three launches (the statistics, their last stage
with the ``[C]`` chain, kernel B's normalize) and so is the backward
(the reduction, its last stage with the chain, dx).  With a ``group`` of
N ranks (the port's ``parallel.mesh.Mesh``: anything with
``world_size`` and an in-place ``all_reduce``), the statistics are the
global batch's, as the JAX model's ``axis_name`` branch
(``models/resnet.py:171-187``) computes them: the forward all-reduces
the ``[2, C]`` (E[x], E[x²]) and divides by N (``pmean``), the backward
all-reduces (Σgy, Σgy·x) and counts the rows of every rank for dx, while
``scale``'s and ``bias``'s gradients stay this rank's share (the
gradient sync sums them).  Each all-reduce adds one launch.

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
# the kernel.  stats: the forward statistics (with or without their
# chain); reduce: the backward reduction (with or without its chain);
# chain: the N-rank chain from all-reduced sums; dx: the input gradient.
stats_launches = 0
reduce_launches = 0
chain_launches = 0
dx_launches = 0

MOMENTUM = 0.9  # the running statistics' (flax's default, as the JAX model)

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_VEC = {torch.bfloat16: 8, torch.float32: 4}  # channels a 16-byte access
_LANES = 8
_MAX_BLOCKS = 1024

# Kinds of the reductions' last stage (``csrc/bn_train.cu`` enum Kind).
_MEANS, _FORWARD, _BACKWARD, _BACKWARD_LOCAL, _BACKWARD_MUL = range(5)


def reset_launches() -> None:
    global stats_launches, reduce_launches, chain_launches, dx_launches
    stats_launches = reduce_launches = chain_launches = dx_launches = 0


def partition(rows: int) -> Tuple[int, int]:
    """(rows per block, blocks) of the reductions' fixed row partition:
    a function of the row count alone, so the summation order (and the
    result) never depends on the card's SM count or occupancy."""
    per = max(64, -(-rows // _MAX_BLOCKS))
    per = -(-per // _LANES) * _LANES
    return per, max(1, -(-rows // per))


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _check(name: str, *tensors: Optional[torch.Tensor]) -> None:
    x = tensors[0]
    if x.ndim != 4:
        raise ValueError(f"{name}: x must be [B, C, H, W], got "
                         f"{tuple(x.shape)}")
    for t in tensors:
        if t is None:
            continue
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


def vector_access(x: torch.Tensor) -> bool:
    """Whether the kernels read ``x`` 16 bytes a thread: C a multiple of
    8 in bf16 (4 in f32).  Every BatchNorm of the port's models is; other
    widths take one channel a thread.  A function of the shape and dtype
    alone, so the summation order is too."""
    return x.shape[1] % _VEC[x.dtype] == 0


def _vec(x: torch.Tensor, *others: Optional[torch.Tensor]) -> int:
    if not vector_access(x):
        return 0
    for t in (x,) + others:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("bn_train: the kernel's 16-byte access needs "
                             "16-byte aligned activations")
    return 1


def _f32(v: float) -> float:
    return float(np.float32(v))


_plans: dict = {}


def _plan(x: torch.Tensor) -> Tuple[int, int, int, int, float, float]:
    """(rows, C, rows per block, blocks, 1/rows, float32(1/rows)) of a
    [B, C, H, W] shape, made once per shape: a function of the shape
    alone."""
    key = tuple(x.shape)
    plan = _plans.get(key)
    if plan is None:
        rows = _rows(x)
        per, nblk = partition(rows)
        plan = (rows, x.shape[1], per, nblk, 1.0 / max(rows, 1),
                _f32(np.float32(1.0) / np.float32(max(rows, 1))))
        _plans[key] = plan
    return plan


def _inverse_count(x: torch.Tensor) -> float:
    """1/n, rounded to the accumulation dtype: XLA takes a mean as the
    sum times the reciprocal of the count, and so does the port."""
    plan = _plan(x)
    return plan[4] if x.dtype == torch.float64 else plan[5]


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


def relu_mask_reference(gy: torch.Tensor, y: Optional[torch.Tensor]
                        ) -> torch.Tensor:
    """The cotangent through the ReLU: 0 where the output is not positive
    (jax.nn.relu's zero gradient at 0); ``gy`` itself without one."""
    if y is None:
        return gy
    return torch.where(y > 0, gy, torch.zeros((), dtype=gy.dtype,
                                              device=gy.device))


def running_update_reference(running: Tuple[torch.Tensor, torch.Tensor],
                             mean: torch.Tensor, var: torch.Tensor) -> None:
    """ra <- MOMENTUM·ra + (1 − MOMENTUM)·batch, in place, for the
    running mean and variance."""
    with torch.no_grad():
        for ra, v in zip(running, (mean, var)):
            ra.copy_(MOMENTUM * ra + (1 - MOMENTUM) * v)


def forward_chain_reference(mean: torch.Tensor, mean2: torch.Tensor,
                            scale: torch.Tensor, bias: torch.Tensor,
                            eps: float, dtype: torch.dtype,
                            fused_stats: bool, running=None):
    """The forward's ``[C]`` chain from the batch means: ``(var, (shift,
    mul, add))`` with ``var = max(mean2 − mean², 0)`` and kernel B's
    coefficients (``bn_act.bn_coefficients``); updates ``running`` (the
    running mean and variance) in place when given."""
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    coeffs = bn_act_lib.bn_coefficients(scale, bias, mean, var, eps, dtype,
                                        fused_stats)
    if running is not None:
        running_update_reference(running, mean, var)
    return var, coeffs


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


def backward_reference(gy: torch.Tensor, x: torch.Tensor,
                       y: Optional[torch.Tensor], scale: torch.Tensor,
                       mean: torch.Tensor, mean2: torch.Tensor, eps: float,
                       fused_stats: bool):
    """The masked reduction and the backward chain on one rank's rows:
    ``(dscale, dbias, mul, c2, c1)``."""
    s1, s2 = channel_sums_reference(relu_mask_reference(gy, y), x)
    return backward_coefficients(s1, s2, scale.to(s1.dtype), mean, mean2,
                                 eps, float(_rows(x)), x.dtype, fused_stats)


def bn_dx_reference(gy: torch.Tensor, x: torch.Tensor,
                    y: Optional[torch.Tensor], mul: torch.Tensor,
                    c2: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    """``gy·mul + x·c2 + c1`` with gy masked where ``y`` is not positive:
    the kernel's separately rounded operations in the same order, one
    rounding to ``x.dtype`` at the end."""
    acc = _acc(x.dtype)
    g = relu_mask_reference(gy, y)
    m, k2, k1 = (v.to(acc).view(1, -1, 1, 1) for v in (mul, c2, c1))
    return (g.to(acc) * m + x.to(acc) * k2 + k1).to(x.dtype)


# -- wrappers ---------------------------------------------------------------

class _Chain(ctypes.Structure):
    """``struct Chain`` of ``csrc/bn_train.cu``."""
    _fields_ = [("kind", ctypes.c_int), ("fused", ctypes.c_int),
                ("round_bf16", ctypes.c_int), ("pad", ctypes.c_int),
                ("inv", ctypes.c_float), ("pre", ctypes.c_float),
                ("eps", ctypes.c_float), ("mom", ctypes.c_float),
                ("mom1", ctypes.c_float), ("inv_n", ctypes.c_float),
                ("scale", ctypes.c_void_p), ("bias", ctypes.c_void_p),
                ("mean", ctypes.c_void_p), ("mean2", ctypes.c_void_p),
                ("run_mean", ctypes.c_void_p), ("run_var", ctypes.c_void_p),
                ("out", ctypes.c_void_p * 8)]


def _params(c: int, device, *vs: Optional[torch.Tensor]) -> None:
    for v in vs:
        if v is not None and not (
                v.dtype is torch.float32 and v.dim() == 1
                and v.shape[0] == c and v.device == device
                and v.is_contiguous()):
            raise ValueError(f"bn_train: per-channel tensors must be "
                             f"contiguous float32 [{c}] on {device}")


def _launch(name: str, device, *args) -> int:
    """Call C entry point ``name`` with ``args`` and the current stream of
    ``device``, made the current device for the call when it is not (the
    kernels launch on the current device)."""
    fn = _fn(name)
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


_MOM32 = (_f32(MOMENTUM), _f32(1 - MOMENTUM))


def _chain(kind: int, out: torch.Tensor, dtype: torch.dtype = None,
           fused: bool = False, eps: float = 0.0, inv: float = 1.0,
           pre: float = 1.0, inv_n: float = 1.0, scale=None, bias=None,
           mean=None, mean2=None, running=None) -> _Chain:
    """The last stage's arguments; ``out``: a contiguous [k, C] float32
    tensor whose rows take the outputs."""
    fused = bool(fused)
    # Python scalars as PyTorch's CUDA ops take them: rounded to float32.
    base, row = out.data_ptr(), out.shape[1] * 4
    ch = _Chain(kind, int(fused), int(fused and dtype == torch.bfloat16), 0,
                inv, pre, _f32(eps), *_MOM32, inv_n,
                *(v.data_ptr() if v is not None else None
                  for v in (scale, bias, mean, mean2)),
                *((r.data_ptr() for r in running) if running is not None
                  else (None, None)))
    for i in range(out.shape[0]):
        ch.out[i] = base + i * row
    return ch


def _sums(a: torch.Tensor, b: torch.Tensor, y: Optional[torch.Tensor],
          mode: int, ch: _Chain, out: torch.Tensor) -> None:
    rows, c, per, nblk = _plan(a)[:4]
    if rows == 0:
        out.fill_(float("nan"))
        return
    partial = torch.empty(nblk, 2, c, dtype=torch.float32, device=a.device)
    err = _launch(
        "bn_sums", a.device, a.data_ptr(), b.data_ptr(),
        y.data_ptr() if y is not None else None, mode,
        int(a.dtype == torch.bfloat16), _vec(a, b, y), rows, c, per, nblk,
        partial.data_ptr(), ctypes.byref(ch))
    if err != 0:
        raise RuntimeError(f"bn_train sums kernel launch failed: CUDA "
                           f"error {err}")


def bn_stats(x: torch.Tensor) -> torch.Tensor:
    """Per-channel (E[x], E[x²]) of a channels-last ``[B, C, H, W]``
    activation as the rows of one [2, C] float32 tensor (N ranks
    all-reduce it in place): kernel C on a CUDA tensor, the plain version
    on a CPU tensor."""
    global stats_launches
    _check("bn_stats", x)
    inv = _inverse_count(x)
    if x.device.type == "cpu":
        return torch.stack(channel_sums_reference(x, x, inv))
    out = torch.empty(2, x.shape[1], dtype=torch.float32, device=x.device)
    _sums(x, x, None, 0, _chain(_MEANS, out, inv=inv), out)
    stats_launches += 1
    return out


def bn_forward_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float, fused_stats: bool, running=None):
    """One rank's forward statistics and their chain: ``(mean, mean2,
    var, (shift, mul, add))`` for kernel B, the running statistics
    (``running``: the running mean and variance) updated in place.  Two
    launches on a CUDA tensor; the plain version on a CPU tensor."""
    global stats_launches
    _check("bn_forward_stats", x)
    inv = _inverse_count(x)
    if x.device.type == "cpu":
        mean, mean2 = channel_sums_reference(x, x, inv)
        var, coeffs = forward_chain_reference(mean, mean2, scale, bias, eps,
                                              x.dtype, fused_stats, running)
        return mean, mean2, var, coeffs
    c = x.shape[1]
    _params(c, x.device, scale, bias, *(running or ()))
    out = torch.empty(6, c, dtype=torch.float32, device=x.device)
    _sums(x, x, None, 0, _chain(_FORWARD, out, x.dtype, fused_stats, eps,
                                inv=inv, scale=scale, bias=bias,
                                running=running), out)
    stats_launches += 1
    mean, mean2, var, shift, mul, add = out.unbind(0)
    return mean, mean2, var, (shift, mul, add)


def bn_forward_chain(sums: torch.Tensor, world: int, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float, dtype: torch.dtype,
                     fused_stats: bool, running=None):
    """The forward's chain from ``sums``, the all-reduced [2, C] means of
    ``world`` ranks: the global means ``sums / world``, then as
    ``bn_forward_stats``.  One launch on the card."""
    if sums.device.type == "cpu":
        mean, mean2 = sums / world
        var, coeffs = forward_chain_reference(mean, mean2, scale, bias, eps,
                                              dtype, fused_stats, running)
        return mean, mean2, var, coeffs
    c = sums.shape[1]
    _params(c, sums.device, sums[0], scale, bias, *(running or ()))
    out = torch.empty(6, c, dtype=torch.float32, device=sums.device)
    ch = _chain(_FORWARD, out, dtype, fused_stats, eps,
                pre=_f32(np.float32(1.0) / np.float32(world)), scale=scale,
                bias=bias, running=running)
    _launch_chain(sums, ch)
    mean, mean2, var, shift, mul, add = out.unbind(0)
    return mean, mean2, var, (shift, mul, add)


def _launch_chain(sums: torch.Tensor, ch: _Chain) -> None:
    global chain_launches
    if not sums.is_contiguous():
        raise ValueError("bn_train: the all-reduced sums must be contiguous")
    err = _launch("bn_chain", sums.device, sums.data_ptr(), sums.shape[1],
                  ctypes.byref(ch))
    if err != 0:
        raise RuntimeError(f"bn_train chain kernel launch failed: CUDA "
                           f"error {err}")
    chain_launches += 1


def _backward(gy, x, y, scale, mean, mean2, eps, fused_stats, kind):
    global reduce_launches
    _check("bn_backward", gy, x, y)
    c = x.shape[1]
    _params(c, x.device, scale, mean, mean2)
    out = torch.empty(7, c, dtype=torch.float32, device=x.device)
    inv_n = _plan(x)[5]
    _sums(gy, x, y, 1 if y is None else 2,
          _chain(kind, out, x.dtype, fused_stats, eps, inv_n=inv_n,
                 scale=scale, mean=mean, mean2=mean2), out)
    reduce_launches += 1
    return out


def bn_backward(gy: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor],
                scale: torch.Tensor, mean: torch.Tensor, mean2: torch.Tensor,
                eps: float, fused_stats: bool):
    """One rank's backward reduction (gy masked where ``y``, the ReLU's
    output, is not positive; no mask when ``y`` is None) and its chain:
    ``(dscale, dbias, mul, c2, c1)``.  Two launches on a CUDA tensor."""
    if x.device.type == "cpu":
        _check("bn_backward", gy, x, y)
        return backward_reference(gy, x, y, scale, mean, mean2, eps,
                                  fused_stats)
    out = _backward(gy, x, y, scale, mean, mean2, eps, fused_stats,
                    _BACKWARD)
    return out.unbind(0)[2:]


def bn_backward_local(gy: torch.Tensor, x: torch.Tensor,
                      y: Optional[torch.Tensor], scale: torch.Tensor,
                      mean: torch.Tensor, mean2: torch.Tensor, eps: float,
                      fused_stats: bool):
    """This rank's share for N ranks: ``(sums, dscale, dbias)``, ``sums``
    the [2, C] (Σgy, Σgy·x) to all-reduce in place before
    ``bn_backward_chain``.  Two launches on a CUDA tensor."""
    if x.device.type == "cpu":
        _check("bn_backward", gy, x, y)
        s1, s2 = channel_sums_reference(relu_mask_reference(gy, y), x)
        dscale, dbias = backward_coefficients(
            s1, s2, scale.to(s1.dtype), mean, mean2, eps, float(_rows(x)),
            x.dtype, fused_stats)[:2]
        return torch.stack([s1, s2]), dscale, dbias
    out = _backward(gy, x, y, scale, mean, mean2, eps, fused_stats,
                    _BACKWARD_LOCAL)
    dscale, dbias = out.unbind(0)[2:4]
    return out[0:2], dscale, dbias


def bn_backward_chain(sums: torch.Tensor, n: float, scale: torch.Tensor,
                      mean: torch.Tensor, mean2: torch.Tensor, eps: float,
                      dtype: torch.dtype, fused_stats: bool):
    """``(mul, c2, c1)`` from the all-reduced [2, C] sums over ``n`` rows
    (every rank's).  One launch on the card."""
    if sums.device.type == "cpu":
        return backward_coefficients(sums[0], sums[1], scale.to(sums.dtype),
                                     mean, mean2, eps, n, dtype,
                                     fused_stats)[2:]
    c = sums.shape[1]
    _params(c, sums.device, sums[0], scale, mean, mean2)
    out = torch.empty(7, c, dtype=torch.float32, device=sums.device)
    ch = _chain(_BACKWARD_MUL, out, dtype, fused_stats, eps,
                inv_n=_f32(np.float32(1.0) / np.float32(n)), scale=scale,
                mean=mean, mean2=mean2)
    _launch_chain(sums, ch)
    return out.unbind(0)[4:7]


def bn_dx(gy: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor],
          mul: torch.Tensor, c2: torch.Tensor, c1: torch.Tensor,
          masked_gy: bool = False):
    """``gy·mul + x·c2 + c1`` with per-channel coefficients, gy masked
    where ``y`` is not positive (when given), rounded once to
    ``x.dtype``: kernel C on a CUDA tensor, the plain version on a CPU
    tensor.  With ``masked_gy`` returns ``(dx, masked gy)``, the second
    the residual's gradient (written by the same launch)."""
    global dx_launches
    _check("bn_dx", gy, x, y)
    if x.device.type == "cpu":
        dx = bn_dx_reference(gy, x, y, mul, c2, c1)
        return (dx, relu_mask_reference(gy, y)) if masked_gy else dx
    c = x.shape[1]
    coeffs = (mul, c2, c1)
    _params(c, x.device, *coeffs)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    gres = None
    if masked_gy:
        gres = (torch.empty_like(x, memory_format=torch.channels_last)
                if y is not None else gy)
    rows, _, per, nblk = _plan(x)[:4]
    if rows == 0:
        return (dx, gres) if masked_gy else dx
    err = _launch(
        "bn_dx", x.device, gy.data_ptr(), x.data_ptr(),
        y.data_ptr() if y is not None else None,
        int(x.dtype == torch.bfloat16), _vec(x, gy, y, dx), rows, c, per,
        nblk, coeffs[0].data_ptr(), coeffs[1].data_ptr(),
        coeffs[2].data_ptr(), dx.data_ptr(),
        gres.data_ptr() if masked_gy and y is not None else None)
    if err != 0:
        raise RuntimeError(f"bn_dx kernel launch failed: CUDA error {err}")
    dx_launches += 1
    return (dx, gres) if masked_gy else dx


# -- the autograd Function --------------------------------------------------

class BatchNormTrain(torch.autograd.Function):
    """Training-mode BatchNorm with batch statistics, optional residual
    add and ReLU: forward ``(y, mean, var)``, backward through kernel C.

    ``mean`` and ``var`` are returned for the caller and carry no
    gradient: the backward takes their cotangents as zero, which is what
    the model's use of them (the running statistics, updated here when
    ``running`` is given, outside the graph) gives.  The ReLU's gradient
    masks the cotangent where the output is not positive (jax.nn.relu's
    zero gradient at 0); that masked tensor is also the residual's
    gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, relu: bool, eps: float,
                fused_stats: bool, group=None, running=None):
        if group is not None and group.world_size > 1:
            stats = group.all_reduce(bn_stats(x))
            mean, mean2, var, coeffs = bn_forward_chain(
                stats, group.world_size, scale, bias, eps, x.dtype,
                fused_stats, running)
        else:
            mean, mean2, var, coeffs = bn_forward_stats(
                x, scale, bias, eps, fused_stats, running)
        y = bn_act_lib.bn_act(x, coeffs, residual, relu)
        ctx.save_for_backward(x, scale, mean, mean2, y if relu else None)
        ctx.relu = relu
        ctx.has_residual = residual is not None
        ctx.eps = eps
        ctx.fused_stats = fused_stats
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        # Their cotangents stay None: no zero-filled [C] tensors launched.
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, scale, mean, mean2, y = ctx.saved_tensors
        gy = gy.contiguous(memory_format=torch.channels_last)
        group = ctx.group
        if group is not None and group.world_size > 1:
            # dx reaches every rank's rows through the global statistics:
            # global sums.  The parameters' gradients are this rank's
            # share; the gradient sync adds the others'.
            sums, dscale, dbias = bn_backward_local(
                gy, x, y, scale, mean, mean2, ctx.eps, ctx.fused_stats)
            group.all_reduce(sums)
            mul, c2, c1 = bn_backward_chain(
                sums, float(_rows(x)) * group.world_size, scale, mean,
                mean2, ctx.eps, x.dtype, ctx.fused_stats)
        else:
            dscale, dbias, mul, c2, c1 = bn_backward(
                gy, x, y, scale, mean, mean2, ctx.eps, ctx.fused_stats)
        if ctx.has_residual:
            dx, gres = bn_dx(gy, x, y, mul, c2, c1, masked_gy=True)
        else:
            dx, gres = bn_dx(gy, x, y, mul, c2, c1), None
        return (dx, dscale.to(scale.dtype), dbias.to(scale.dtype), gres,
                None, None, None, None, None)


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float, fused_stats: bool,
             residual: Optional[torch.Tensor] = None, relu: bool = False,
             group=None, running=None):
    """Training-mode BatchNorm of a channels-last activation: returns
    ``(y, mean, var)`` with the biased batch variance ``max(E[x²] −
    E[x]², 0)``.  ``fused_stats`` picks ``FusedBatchNorm``'s formula
    (``x·mul − sub`` with ``mul``, ``sub`` rounded to ``x.dtype``), else
    flax ``nn.BatchNorm``'s (float32 coefficients).  ``group``: the
    ranks whose rows share the statistics (None: this batch alone).
    ``running``: the (mean, var) running statistics, updated in place as
    ``MOMENTUM·ra + (1 − MOMENTUM)·batch`` (None: not updated)."""
    return BatchNormTrain.apply(x, scale, bias, residual, bool(relu),
                                float(eps), bool(fused_stats), group,
                                running)


_fns = {}


def _fn(name: str):
    """A C entry point of ``csrc/bn_train.cu``, built and bound at first
    use."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("bn_train"), name)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        chain = ctypes.POINTER(_Chain)
        fn.argtypes = {
            "bn_sums": [ptr, ptr, ptr, i32, i32, i32, i64, i32, i32, i32,
                        ptr, chain, ptr],
            "bn_chain": [ptr, i32, chain, ptr],
            "bn_dx": [ptr, ptr, ptr, i32, i32, i64, i32, i32, i32, ptr, ptr,
                      ptr, ptr, ptr, ptr]}[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn
