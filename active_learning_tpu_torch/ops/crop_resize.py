"""The crop + bilinear resize of decoded JPEGs on the card.

Replaces no TPU kernel: it is the pixel half of the JAX package's native
decoder (``native/decode.cpp::crop_resize_bilinear``), which runs on the
host after libjpeg.  On the card nvJPEG decodes each file into one device
buffer (``data/native.py``), and ``crop_resize`` samples every image of a
batch into ``[N, S, S, 3]`` uint8 rows in one launch of the kernel of
``csrc/jpeg_decode.cu``.  ``crop_resize_reference``, the plain version,
runs only on a CPU tensor; it repeats decode.cpp's arithmetic (float32
taps rounded operation by operation, 8-bit fixed-point weights, integer
blends), so on the same decoded pixels it gives the JAX package's native
rows bit for bit.

Inputs: ``src``, the decoded images back to back (uint8, one dimension);
``meta``, int64 ``[N, 8]``, per image its byte offset in ``src``, height,
width, channels (3 for interleaved RGB, 1 for grayscale, replicated into
R, G and B; anything else marks a failed decode, whose row is zeros),
and its crop box ``top, left, height, width``.  ``meta`` lies on the
host, where the wrapper checks every box against ``src`` before the
kernel reads through it; on the card it travels with one copy.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

# Launches of the CUDA kernel since the process started (or since a
# caller reset it).
launches = 0

MAX_IMAGES = 65535  # the grid's second dimension


def taps(offset: int, extent: int, out: int, clamp_max: int):
    """(i0, i1, w1) of ``out`` output coordinates as decode.cpp's
    ``make_taps`` computes them, in float32 one operation at a time."""
    f32 = np.float32
    scale = f32(extent) / f32(out)
    f = ((np.arange(out, dtype=f32) + f32(0.5)) * scale - f32(0.5)
         + f32(offset))
    i0 = np.floor(f).astype(np.int64)
    frac = f - i0.astype(f32)
    w1 = (frac * f32(256.0) + f32(0.5)).astype(np.int64)  # truncates
    return (np.clip(i0, 0, clamp_max), np.clip(i0 + 1, 0, clamp_max), w1)


def crop_resize_reference(src: torch.Tensor, meta: torch.Tensor,
                          out_size: int) -> torch.Tensor:
    """The plain version: one image at a time, with torch integer ops."""
    meta_np = meta.numpy()
    out = torch.zeros(len(meta_np), out_size, out_size, 3,
                      dtype=torch.uint8, device=src.device)
    for n, (off, h, w, c, top, left, ch, cw) in enumerate(meta_np):
        if c not in (1, 3):
            continue
        img = src[off:off + h * w * c].view(h, w, c).to(torch.int32)
        if c == 1:
            img = img.expand(h, w, 3)
        yi0, yi1, wy1 = (torch.from_numpy(t).to(src.device)
                         for t in taps(top, ch, out_size, h - 1))
        xi0, xi1, wx1 = (torch.from_numpy(t).to(src.device)
                         for t in taps(left, cw, out_size, w - 1))
        wx1 = wx1.to(torch.int32)[None, :, None]
        wy1 = wy1.to(torch.int32)[:, None, None]

        def horizontal(rows):
            return (rows[:, xi0] * (256 - wx1) + rows[:, xi1] * wx1) >> 8

        h0, h1 = horizontal(img[yi0]), horizontal(img[yi1])
        out[n] = ((h0 * (256 - wy1) + h1 * wy1 + 128) >> 8).to(torch.uint8)
    return out


def touched_bytes(meta: np.ndarray, out_size: int) -> int:
    """The bytes the function must move: each image's source pixels its
    taps touch (distinct rows x distinct columns x channels), read once,
    its output row written once, and the meta rows."""
    total = meta.nbytes + len(meta) * out_size * out_size * 3
    for off, h, w, c, top, left, ch, cw in meta:
        if c not in (1, 3):
            continue
        ys = np.unique(np.concatenate(taps(top, ch, out_size, h - 1)[:2]))
        xs = np.unique(np.concatenate(taps(left, cw, out_size, w - 1)[:2]))
        total += len(ys) * len(xs) * int(c)
    return int(total)


def _check(src: torch.Tensor, meta: torch.Tensor, out_size: int) -> None:
    if src.dtype != torch.uint8 or src.ndim != 1:
        raise TypeError("src must be a one-dimensional uint8 tensor")
    if meta.dtype != torch.int64 or meta.ndim != 2 or meta.shape[1] != 8:
        raise TypeError(f"meta must be int64 [N, 8], got {meta.dtype} "
                        f"{tuple(meta.shape)}")
    if meta.device.type != "cpu":
        raise ValueError("meta must lie on the host")
    if not 1 <= out_size <= 4096:
        raise ValueError(f"out_size {out_size} is out of range")
    if meta.shape[0] > MAX_IMAGES:
        raise ValueError(f"at most {MAX_IMAGES} images a call")


def _check_boxes(meta: np.ndarray, nbytes: int) -> None:
    """Every image lies inside ``src``; every crop box is non-empty."""
    m = meta[(meta[:, 3] == 1) | (meta[:, 3] == 3)]
    if len(m) and (np.any(m[:, 0] < 0) or np.any(m[:, 1:3] < 1)
                   or np.any(m[:, 0] + m[:, 1] * m[:, 2] * m[:, 3] > nbytes)
                   or np.any(m[:, 6:8] < 1)):
        raise ValueError("crop_resize: an image lies outside src or has "
                         "an empty crop box")


def crop_resize(src: torch.Tensor, meta: torch.Tensor,
                out_size: int) -> torch.Tensor:
    """``[N, out_size, out_size, 3]`` uint8 rows: the kernel for a CUDA
    ``src``, the plain version for a CPU one (``meta`` on the host)."""
    global launches
    _check(src, meta, out_size)
    _check_boxes(meta.numpy(), src.numel())
    if not src.is_cuda:
        if src.device.type != "cpu":
            raise ValueError(f"crop_resize: unsupported device "
                             f"{src.device}")
        return crop_resize_reference(src, meta, out_size)
    if not src.is_contiguous():
        raise ValueError("crop_resize: src must be contiguous")
    n = meta.shape[0]
    out = torch.empty(n, out_size, out_size, 3, dtype=torch.uint8,
                      device=src.device)
    if n == 0:
        return out
    fn = _kernel()
    dev = src.get_device()
    meta_dev = meta.contiguous().to(src.device)
    with torch.cuda.device(dev):
        err = fn(src.data_ptr(), meta_dev.data_ptr(), n, out_size,
                 out.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"crop_resize kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


# The C entry point's argument types (csrc/jpeg_decode.cu).
_ARGTYPES = {"al_crop_resize": [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p]}

_fn = None
_stream = None


def _kernel():
    """The C entry point, built and bound at first use, with the current
    stream's reader."""
    global _fn, _stream
    if _fn is None:
        fn = _build.load("jpeg_decode").al_crop_resize
        fn.argtypes = _ARGTYPES["al_crop_resize"]
        fn.restype = ctypes.c_int
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        _stream = raw if raw is not None else (
            lambda d: torch.cuda.current_stream(d).cuda_stream)
        _fn = fn
    return _fn
