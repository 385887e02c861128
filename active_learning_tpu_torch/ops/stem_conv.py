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

Bound: device-memory bytes on the bf16 path, which runs on the tensor
cores (``wgmma``); the f32 path stays on the CUDA cores (see the source
note in ``csrc/stem_dw.cu``).  The plain version computes in
``promote(dtype, float32)`` — float64 for a float64 input, which the CPU
tests use to hold the formula to 1e-10 of the JAX package's.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

# Launches since the process started (or since a caller reset them).
launches = 0

S2D_PADDING = ((2, 1), (2, 1))

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_CHANNELS = 12          # the kernel's input channels: 2x2 blocks of RGB
_MAX_TAPS = 8           # kh, kw <= 8
_MAX_FILTERS = 64       # one wgmma N tile; the f32 path's 48 KB of smem
# The f32 path (CUDA cores): tiles of 4 x 28 output positions, at most
# 512 runs.
_F32_TILE = (4, 28)
_F32_MAX_RUNS = 512
# The bf16 path (tensor cores): tiles of 2 output rows x 8·steps columns
# (16-position wgmma steps; the kernel is compiled for these step
# counts), cut into about _TC_RUNS runs, one persistent block each.  132
# is the H100's SM count, but as a constant: the runs, and so the
# summation order, never follow the card the kernel runs on.
_TC_STEPS = (1, 2, 4, 7, 12, 14)
_TC_RUNS = 132
_TC_ROW_TILES = 3       # 64-row tiles of the kh*kw*12 rows per block
_TC_STAGES = 4          # the copy ring's depth (csrc kStages)
_SMEM_LIMIT = 232448    # bytes of shared memory a Hopper block can use
# Units of last place per 16-position wgmma step (csrc note: 16 products
# and the accumulator in one or two aligned groups, each n-addend group
# truncating n-1 and normalizing once).
_TC_UNITS_PER_STEP = 18


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _pads(padding: Sequence[Sequence[int]]) -> Tuple[int, int, int, int]:
    (p0, p1), (q0, q1) = padding
    return int(p0), int(p1), int(q0), int(q1)


class Partition(NamedTuple):
    """The kernel's fixed split of the output positions: tiles of
    ``tile_rows x tile_cols`` positions of one image, in the order
    (image, row tile, column tile); run ``k`` (one block) takes tiles
    ``[k·per, min((k+1)·per, tiles))`` in order."""
    tile_rows: int
    tile_cols: int
    tiles: int
    per: int
    nblk: int


def _r16(v: int) -> int:
    return (v + 15) & ~15


def _tc_smem(tile_cols: int, kh: int, kw: int) -> int:
    """Shared memory of the bf16 path (csrc ``TcSmem``): four g
    tiles (128 bytes a position) and raw x windows (TMA boxes of kh+1
    rows x 256 elements, one pixel more than the window: a box starts on
    an even pixel), two paired windows, the stages' mbarriers and 1 KB to
    align the swizzled g tiles."""
    xj = tile_cols + kw - 1
    boxes = -(-(xj + 1) * _CHANNELS // 256)
    return (1024 + _TC_STAGES * (2 * tile_cols * 128
                                 + boxes * (kh + 1) * 512)
            + 2 * _r16((kh + 1) * xj * _CHANNELS * 4) + 8 * _TC_STAGES)


def partition(b: int, ho: int, wo: int, dtype: torch.dtype = torch.float32,
              kh: int = 4, kw: int = 4) -> Partition:
    """The kernel's tile partition for an input of ``dtype``: a function
    of the shape alone, so the summation order (and the result) never
    depends on the card's SM count."""
    if dtype == torch.bfloat16:
        # The fewest steps that cover a row, else the most that fit.
        tr, runs = 2, _TC_RUNS
        fits = [n for n in _TC_STEPS
                if _tc_smem(8 * n, kh, kw) <= _SMEM_LIMIT]
        cover = [n for n in fits if 8 * n >= wo]
        tc = 8 * (min(cover) if cover else max(fits))
    else:
        (tr, tc), runs = _F32_TILE, _F32_MAX_RUNS
    tiles = b * -(-ho // tr) * -(-wo // tc)
    per = max(1, -(-tiles // runs))
    return Partition(tr, tc, tiles, per, max(1, -(-tiles // per)))


def chain_length(b: int, ho: int, wo: int,
                 dtype: torch.dtype = torch.float32, kh: int = 4,
                 kw: int = 4) -> int:
    """L_k: the units of ``error_unit(dtype)`` per Σ|x||g| behind one
    output of the kernel, |kernel − exact| ≤ L_k·u·Σ|x||g|.  f32 (CUDA
    cores, one round to nearest per addition): a block's run of
    positions, then the fold of the partials.  bf16 (tensor cores): 18
    units per 16-position step of a run (see the source note), then the
    fold."""
    part = partition(b, ho, wo, dtype, kh, kw)
    if dtype == torch.bfloat16:
        steps = part.per * part.tile_cols // 8
        return _TC_UNITS_PER_STEP * steps + part.nblk
    return part.per * part.tile_rows * part.tile_cols + part.nblk


def error_unit(dtype: torch.dtype = torch.float32) -> float:
    """The unit of ``chain_length``: 2⁻²⁴ (float32 round to nearest) on
    the f32 path, 2⁻²³ (a truncated last place) on the tensor cores."""
    return 2.0 ** -23 if dtype == torch.bfloat16 else 2.0 ** -24


# ‖kernel − exact‖ / ‖exact‖ over the whole dW, the checks' second limit.
# The worst case L_k·u·Σ|x||g| is above a typical |dW| at the fit width
# (zero-mean inputs: |dW| ~ Σ|x||g| / √M), so it cannot tell a kernel
# that skips positions from a right one.  Skipping or misreading one
# 16-position step of such inputs moves dW by about √(16/M) of its norm:
# 3.2e-3 at the fit width (M = 1,605,632), more at every smaller shape.
# A right kernel read 1.4e-5 there on an H100 (bf16; chip_smoke.py
# phase 15), 1.6e-6 or less at every other shape; a copy that skipped
# one tile a run (1.8% of the positions) read 0.13 and passed the
# worst-case bounds.
REL_NORM_LIMIT = 1e-4


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
    part = partition(b, ho, wo, x.dtype, kh, kw)
    partial = torch.empty(part.nblk, f * kh * kw * c, dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if x.dtype == torch.bfloat16:
            # TMA's tensor maps take rows of a multiple of 16 bytes (an
            # even width of x) and g's box is one 64-filter swizzle row:
            # x and g are padded with zeros to those, 16-byte aligned.
            xt = _aligned(F.pad(x, (0, 0, 0, w % 2)) if w % 2 else x)
            gt = _aligned(F.pad(g, (0, _MAX_FILTERS - f))
                          if f < _MAX_FILTERS else g)
            mgroups = -(-kh * kw * c // (64 * _TC_ROW_TILES))
            err = _fn("stem_dw_bf16")(
                xt.data_ptr(), gt.data_ptr(), b, h, xt.shape[2], ho, wo,
                gt.shape[3], f, kh, kw, pads[0], pads[2], part.tile_cols,
                part.tiles, part.per, part.nblk, mgroups,
                partial.data_ptr(), dw.data_ptr(), stream)
        else:
            err = _fn("stem_dw_f32")(
                x.data_ptr(), g.data_ptr(), b, h, w, ho, wo, f, kh, kw,
                pads[0], pads[2], part.per, part.nblk, partial.data_ptr(),
                dw.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"stem_dw kernel launch failed: CUDA error {err}")
    launches += 1
    return dw.permute(0, 3, 1, 2)


def _aligned(v: torch.Tensor) -> torch.Tensor:
    """``v`` (contiguous), copied when its data does not start on the 16
    bytes the bf16 path's copies need (a view with a storage offset)."""
    return v if v.data_ptr() % 16 == 0 else v.clone()


_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "stem_dw_f32": [_ptr, _ptr] + [_i32] * 12 + [_ptr, _ptr, _ptr],
    "stem_dw_bf16": [_ptr, _ptr] + [_i32] * 16 + [_ptr, _ptr, _ptr],
}
_fns = {}


def _fn(name: str):
    """A C entry point of ``csrc/stem_dw.cu``, built and bound at first
    use."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("stem_dw"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn
