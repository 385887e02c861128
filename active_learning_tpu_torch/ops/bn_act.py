"""Kernel B: eval-mode BatchNorm, optional residual add and ReLU in one
pass (the eval half of ROADMAP K1), in Triton.

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

Bound: device-memory bytes.  Per element it reads x (and the residual)
and writes y — 4 (6) bytes in bf16, 8 (12) in float32 — and does four
flops, far below the card's ridge point.  Design: a 2-D tile of pixels ×
channels over the contiguous NHWC (channels-last) buffer, so each tile
loads its channels' coefficients once and every load and store is
contiguous along the channels; no integer division per element.
Floating-point contraction is turned off at launch, so the kernel does
the plain version's separately rounded float32 operations in the same
order and agrees with it bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Launches of the Triton kernel since the process started (or since a
# caller reset it).
launches = 0

Coefficients = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_DTYPES = (torch.bfloat16, torch.float32)


def bn_coefficients(scale: torch.Tensor, bias: torch.Tensor,
                    mean: torch.Tensor, var: torch.Tensor, eps: float,
                    dtype: torch.dtype, fused_stats: bool) -> Coefficients:
    """Per-channel float32 ``(shift, mul, add)`` of the JAX package's
    eval BatchNorm for the activation ``dtype``: ``FusedBatchNorm``'s
    ``x·mul − sub`` when ``fused_stats``, else flax's
    ``(x − mean)·(rsqrt(var + eps)·scale) + bias``."""
    if fused_stats:
        mul = (scale * torch.rsqrt(var + eps)).to(dtype)
        sub = mean.to(dtype) * mul - bias.to(dtype)
        return (torch.zeros_like(scale, dtype=torch.float32),
                mul.to(torch.float32), (-sub).to(torch.float32))
    mul = torch.rsqrt(var + eps) * scale
    return (mean.to(torch.float32), mul.to(torch.float32),
            bias.to(torch.float32))


def bn_act_reference(x: torch.Tensor, coeffs: Coefficients,
                     residual: Optional[torch.Tensor] = None,
                     relu: bool = False) -> torch.Tensor:
    """The plain version: the same float32 operations in the same order,
    one rounding to ``x.dtype`` at the end."""
    shift, mul, add = (v.view(1, -1, 1, 1) for v in coeffs)
    y = (x.to(torch.float32) - shift) * mul + add
    if residual is not None:
        y = y + residual.to(torch.float32)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _check(x: torch.Tensor, coeffs: Coefficients,
           residual: Optional[torch.Tensor]) -> None:
    if x.ndim != 4:
        raise ValueError(f"bn_act: x must be [B, C, H, W], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"bn_act: x must be bf16 or f32, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("bn_act: x must be contiguous in channels_last")
    c = x.shape[1]
    for v in coeffs:
        if (v.shape != (c,) or v.dtype != torch.float32
                or v.device != x.device or not v.is_contiguous()):
            raise ValueError(f"bn_act: coefficients must be contiguous "
                             f"float32 [{c}] on {x.device}")
    if residual is not None:
        if (residual.shape != x.shape or residual.dtype != x.dtype
                or residual.device != x.device
                or not residual.is_contiguous(
                    memory_format=torch.channels_last)):
            raise ValueError("bn_act: residual must match x in shape, "
                             "dtype, device and channels_last layout")


def bn_act(x: torch.Tensor, coeffs: Coefficients,
           residual: Optional[torch.Tensor] = None,
           relu: bool = False) -> torch.Tensor:
    """``relu?((x − shift)·mul + add [+ residual])`` rounded once to
    ``x.dtype``: the Triton kernel on a CUDA tensor, the plain version
    on a CPU tensor.  ``x`` (and ``residual``) must be channels-last."""
    global launches
    _check(x, coeffs, residual)
    if x.device.type == "cpu":
        return bn_act_reference(x, coeffs, residual, relu)
    if x.device.type != "cuda":
        raise ValueError(f"bn_act: unsupported device {x.device}")
    import triton

    y = torch.empty_like(x, memory_format=torch.channels_last)
    if x.numel() == 0:
        return y
    b, c, h, w = x.shape
    pixels = b * h * w
    block_c = min(triton.next_power_of_2(c), 128)
    block_p = 4096 // block_c
    grid = (triton.cdiv(pixels, block_p), triton.cdiv(c, block_c))
    shift, mul, add = coeffs
    with torch.cuda.device(x.device):
        _kernel()[grid](
            x, residual if residual is not None else x, y, shift, mul, add,
            pixels, c, HAS_RES=residual is not None, RELU=bool(relu),
            BLOCK_P=block_p, BLOCK_C=block_c, num_warps=8,
            enable_fp_fusion=False)
    launches += 1
    return y


_compiled = None


def _kernel():
    """The jitted kernel.  Triton is imported here, not at module import:
    a machine without it still imports this module and runs the plain
    version on CPU tensors.  The kernel body below resolves ``tl`` from
    this module's globals, which this sets once."""
    global _compiled, tl
    if _compiled is None:
        import triton
        import triton.language as tl
        _compiled = triton.jit(_bn_act_kernel)
    return _compiled


def _bn_act_kernel(x_ptr, res_ptr, y_ptr, shift_ptr, mul_ptr, add_ptr,
                   pixels, channels, HAS_RES: tl.constexpr,
                   RELU: tl.constexpr, BLOCK_P: tl.constexpr,
                   BLOCK_C: tl.constexpr):
    p = tl.program_id(0) * BLOCK_P + tl.arange(0, BLOCK_P)
    c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    c_ok = c < channels
    shift = tl.load(shift_ptr + c, mask=c_ok, other=0.0)
    mul = tl.load(mul_ptr + c, mask=c_ok, other=0.0)
    add = tl.load(add_ptr + c, mask=c_ok, other=0.0)
    offs = p.to(tl.int64)[:, None] * channels + c[None, :]
    mask = (p < pixels)[:, None] & c_ok[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    y = (x - shift[None, :]) * mul[None, :] + add[None, :]
    if HAS_RES:
        y = y + tl.load(res_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    if RELU:
        y = tl.maximum(y, 0.0)
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)
