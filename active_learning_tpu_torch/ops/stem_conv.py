"""Kernel I: the s2d stem's weight gradient (ROADMAP K7), CUDA C++ in
``csrc/stem_dw.cu``.

Replaces the JAX package's ``ops/backward.py:65-117`` ``_stem_conv_fn``
(the custom VJP ``S2DStemConv`` trains through), its ``dW`` at
``:104-112``: the contraction over batch and space

    dW[f, c, h, w] = Σ_{b,i,j} x[b, i+h−ph0, j+w−pw0, c] · g[b, i, j, f]

with ``x`` zero outside the image, read in bf16 (or f32) and accumulated
in float32.  ``stem_dw`` launches kernel I on a CUDA tensor and runs the
plain version, ``stem_dw_plain``, only on a CPU tensor.

The public functions take the JAX package's layout: ``x`` is NHWC
``[B, H, W, C]`` and ``g`` is ``[B, Ho, Wo, F]``; ``padding`` is
``((ph0, ph1), (pw0, pw1))`` and ``Ho = H + ph0 + ph1 − kh + 1`` (stride
1).  ``dW`` comes back as ``[F, C, kh, kw]``, the torch parameter's
shape; the kernel writes it with channels-last strides (memory order
``[F, kh, kw, C]``), the layout of the model's channels-last parameter.

Bound: float32 operations on the CUDA cores (see the source note in
``csrc/stem_dw.cu``).  The plain version computes in ``promote(dtype,
float32)`` — float64 for a float64 input, which the CPU tests use to
hold the formula to 1e-10 of the JAX package's.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

# Launches since the process started (or since a caller reset them).
launches = 0

S2D_PADDING = ((2, 1), (2, 1))

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_CHANNELS = 12          # the kernel's input channels: 2x2 blocks of RGB
_TILE = (4, 28)         # output rows x columns per tile (csrc kTI, kTJ)
_MAX_BLOCKS = 512
_MAX_TAPS = 8           # kh, kw <= 8 and F <= 64 keep shared memory < 48 KB
_MAX_FILTERS = 64


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _pads(padding: Sequence[Sequence[int]]) -> Tuple[int, int, int, int]:
    (p0, p1), (q0, q1) = padding
    return int(p0), int(p1), int(q0), int(q1)


def partition(b: int, ho: int, wo: int) -> Tuple[int, int]:
    """(tiles per block, blocks) of the kernel's fixed tile partition: a
    function of the output shape alone, so the summation order (and the
    result) never depends on the card's SM count."""
    ti, tj = _TILE
    tiles = b * -(-ho // ti) * -(-wo // tj)
    per = max(1, -(-tiles // _MAX_BLOCKS))
    return per, max(1, -(-tiles // per))


def chain_length(b: int, ho: int, wo: int) -> int:
    """The longest sequential chain of float32 additions behind one
    output of the kernel: a block's run of tile positions, then the fold
    of the partials."""
    per, nblk = partition(b, ho, wo)
    return per * _TILE[0] * _TILE[1] + nblk


def _check(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int,
           pads: Tuple[int, int, int, int]) -> None:
    if x.ndim != 4 or g.ndim != 4:
        raise ValueError(f"stem_dw: x and g must be NHWC, got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    p0, p1, q0, q1 = pads
    if min(pads) < 0 or kh < 1 or kw < 1:
        raise ValueError(f"stem_dw: bad kernel {kh}x{kw} or pads {pads}")
    b, h, w, _ = x.shape
    want = (b, h + p0 + p1 - kh + 1, w + q0 + q1 - kw + 1)
    if tuple(g.shape[:3]) != want:
        raise ValueError(f"stem_dw: g is {tuple(g.shape)}, the conv's output "
                         f"is {want} x F")
    if g.device != x.device or g.dtype != x.dtype:
        raise ValueError("stem_dw: x and g must share device and dtype")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"stem_dw: unsupported device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"stem_dw: the kernel takes bf16 or f32, got "
                        f"{x.dtype}")
    f = g.shape[3]
    if (x.shape[3] != _CHANNELS or f % 4 or f > _MAX_FILTERS
            or kh > _MAX_TAPS or kw > _MAX_TAPS):
        raise ValueError(
            f"stem_dw: the kernel takes {_CHANNELS} input channels, a "
            f"filter count that is a multiple of 4 up to {_MAX_FILTERS} and "
            f"kernels up to {_MAX_TAPS}x{_MAX_TAPS}; got C={x.shape[3]}, "
            f"F={f}, {kh}x{kw}")


def stem_dw_plain(x: torch.Tensor, g: torch.Tensor, kh: int = 4,
                  kw: int = 4, padding=S2D_PADDING) -> torch.Tensor:
    """The plain version: cast to ``promote(dtype, float32)``, pad, and
    the weight gradient of a stride-1 convolution
    (``torch.nn.grad.conv2d_weight``).  Returns ``[F, C, kh, kw]``."""
    p0, p1, q0, q1 = _pads(padding)
    acc = _acc(x.dtype)
    xp = F.pad(x.to(acc).permute(0, 3, 1, 2), (q0, q1, p0, p1))
    gn = g.to(acc).permute(0, 3, 1, 2)
    return torch.nn.grad.conv2d_weight(
        xp, (g.shape[3], x.shape[3], kh, kw), gn)


def stem_dw(x: torch.Tensor, g: torch.Tensor, kh: int = 4, kw: int = 4,
            padding=S2D_PADDING) -> torch.Tensor:
    """``dW [F, C, kh, kw]`` of the stride-1 conv of ``x`` (NHWC) given
    its output cotangent ``g`` (NHWC): kernel I on a CUDA tensor (float32
    out, channels-last strides), the plain version on a CPU tensor.  A
    ``g`` that is not NHWC-contiguous (the cotangent of a channels-last
    activation can arrive with other strides) is copied to NHWC-
    contiguous first; so is ``x``."""
    global launches
    pads = _pads(padding)
    _check(x, g, kh, kw, pads)
    if x.device.type == "cpu":
        return stem_dw_plain(x, g, kh, kw, padding)
    x = x.contiguous()
    g = g.contiguous()
    b, h, w, c = x.shape
    _, ho, wo, f = g.shape
    dw = torch.empty(f, kh, kw, c, dtype=torch.float32, device=x.device)
    if b * ho * wo == 0:
        return dw.zero_().permute(0, 3, 1, 2)
    per, nblk = partition(b, ho, wo)
    partial = torch.empty(nblk, f * kh * kw * c, dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(x.data_ptr(), g.data_ptr(), int(x.dtype == torch.bfloat16),
                    b, h, w, ho, wo, f, kh, kw, pads[0], pads[2], per, nblk,
                    partial.data_ptr(), dw.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"stem_dw kernel launch failed: CUDA error {err}")
    launches += 1
    return dw.permute(0, 3, 1, 2)


_fns = {}


def _fn():
    """The C entry point of ``csrc/stem_dw.cu``, built and bound at first
    use."""
    fn = _fns.get("stem_dw")
    if fn is None:
        fn = _build.load("stem_dw").stem_dw
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr] + [i32] * 13 + [ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        _fns["stem_dw"] = fn
    return fn
