"""The JPEG decoders of the disk-backed datasets (the JAX package's
``data/native.py``), one route per device.

* CPU: ``csrc/decode.cpp``, a copy of the JAX package's
  ``native/decode.cpp`` (libjpeg decode, crop, bilinear resize, a
  std::thread pool), built by ``ops/_build`` with ``g++ ... -ljpeg
  -lpthread`` at first use into ``active_learning_tpu_torch/build/``
  under a name that carries the hash of its source and flags.  Its rows
  equal the JAX package's native rows bit for bit.
* CUDA: nvJPEG decodes each file on the card into one device buffer
  (``csrc/jpeg_decode.cu``), and the crop-resize kernel
  (``ops/crop_resize.py``) samples every row with decode.cpp's
  arithmetic.  nvJPEG's inverse DCT and chroma upsampling are not
  libjpeg's, so these rows differ from the CPU route's by a bounded
  amount (measured on the committed fixture; PERF.md).  The rows come
  back to the host as uint8, so the caches and the feed are the same on
  both routes.

The crop rectangles (the randomness) stay in Python
(``data/imagenet.py``), so augmentation is a pure function of
``(seed, epoch, index)`` on either route.  A failed build or load raises
with the compiler's or loader's message: nothing falls back to PIL for a
whole dataset.  Files a decoder cannot handle (a CMYK JPEG, a file that
does not parse) come back marked, for the caller's per-file fallback.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import _build
from ..ops.crop_resize import crop_resize

_lock = threading.Lock()
_lib = None
_nvjpeg = None
# A side stream a thread: a feed worker's decode, resize and copy back
# wait only on its own work, never on the training step's stream.
_local = threading.local()


def load() -> ctypes.CDLL:
    """The CPU route's library (``csrc/decode.cpp``), built first if
    needed.  Raises when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load("decode")
            lib.al_jpeg_dims.restype = ctypes.c_int
            lib.al_jpeg_dims.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
            lib.al_decode_crop_resize.restype = ctypes.c_int
            lib.al_decode_crop_resize.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
            _lib = lib
        return _lib


# The nvJPEG entry points' argument types (csrc/jpeg_decode.cu).
_ARGTYPES = {
    "al_nvjpeg_dims": [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                       ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
                       ctypes.c_int],
    "al_nvjpeg_decode": [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                         ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
                         ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.POINTER(ctypes.c_int32),
                         ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]}


def load_nvjpeg() -> ctypes.CDLL:
    """The CUDA route's library (``csrc/jpeg_decode.cu``, linked with
    nvJPEG), built with nvcc first if needed.  Raises when it cannot."""
    global _nvjpeg
    with _lock:
        if _nvjpeg is None:
            lib = _build.load("jpeg_decode")
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _nvjpeg = lib
        return _nvjpeg


def _path_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _check_cuda_error(err: int, what: str) -> None:
    if err != 0:
        kind = (f"nvJPEG status {err - 1000}" if err >= 1000
                else f"CUDA error {err}")
        raise RuntimeError(f"{what} failed: {kind}")


def _cuda_index(device) -> int:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"not a CUDA device: {device}")
    return dev.index if dev.index is not None else 0


def jpeg_dims(paths: Sequence[str], n_threads: int = 4,
              device=None) -> np.ndarray:
    """int32 ``[N, 3]``: height, width and components of each file
    from its header; -1 rows for files the route's decoder cannot parse
    (the caller decides the fallback).  ``device`` None or CPU: libjpeg
    (components read as 3: libjpeg emits RGB); CUDA: nvJPEG."""
    out = np.empty((len(paths), 3), dtype=np.int32)
    if not paths:
        return out
    if device is None or torch.device(device).type == "cpu":
        hw = np.empty((len(paths), 2), dtype=np.int32)
        load().al_jpeg_dims(_path_array(paths), len(paths),
                            _ptr(hw, ctypes.c_int32), n_threads)
        out[:, :2] = hw
        out[:, 2] = np.where(hw[:, 0] > 0, 3, -1)
        return out
    err = load_nvjpeg().al_nvjpeg_dims(
        _cuda_index(device), _path_array(paths), len(paths),
        _ptr(out, ctypes.c_int32), n_threads)
    _check_cuda_error(err, "nvJPEG header parse")
    return out


def decode_crop_resize(paths: Sequence[str], rects: np.ndarray,
                       out_size: int, n_threads: int = 4, device=None,
                       dims: Optional[np.ndarray] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode + crop (``rects[i] = top, left, ch, cw``) + bilinear resize
    into a host uint8 ``[N, out_size, out_size, 3]`` batch.  Returns
    ``(batch, failed)``: failed rows (a CMYK JPEG, a file the decoder
    refuses) are zeros, for the caller to decode on its own.  The CUDA
    route needs each file's ``jpeg_dims`` row (``dims``)."""
    rects = np.ascontiguousarray(rects, dtype=np.int32)
    if rects.shape != (len(paths), 4):
        raise ValueError(f"rects must be [{len(paths)}, 4], got "
                         f"{rects.shape}")
    if device is None or torch.device(device).type == "cpu":
        out = np.empty((len(paths), out_size, out_size, 3), dtype=np.uint8)
        failed = np.zeros(len(paths), dtype=np.uint8)
        load().al_decode_crop_resize(
            _path_array(paths), len(paths), _ptr(rects, ctypes.c_int32),
            out_size, _ptr(out, ctypes.c_uint8),
            _ptr(failed, ctypes.c_uint8), n_threads)
        return out, failed.astype(bool)
    return _decode_crop_resize_cuda(paths, rects, out_size, n_threads,
                                    device, dims)


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def nvjpeg_decode(paths: Sequence[str], dims: np.ndarray, n_threads: int,
                  device) -> Tuple[torch.Tensor, np.ndarray]:
    """Each file decoded by nvJPEG into one device buffer, on this
    thread's side stream: ``(buf, meta)``, ``meta`` the crop-resize
    kernel's int64 ``[N, 8]`` with the boxes still zero (channels 0 for a
    file the fallback must take)."""
    if dims is None or dims.shape != (len(paths), 3):
        raise ValueError("nvjpeg_decode needs each file's jpeg_dims row")
    dev = torch.device("cuda", _cuda_index(device))
    n = len(paths)
    hw = dims[:, :2].astype(np.int64)
    if np.any(hw < 1):
        raise ValueError("nvjpeg_decode: a file without dimensions")
    sizes = hw[:, 0] * hw[:, 1] * 3
    meta = np.zeros((n, 8), dtype=np.int64)
    meta[1:, 0] = np.cumsum(sizes)[:-1]
    meta[:, 1:3] = hw
    channels = np.zeros(n, dtype=np.int32)
    failed = np.ones(n, dtype=np.uint8)
    lib = load_nvjpeg()
    stream = _side_stream(dev)
    with torch.cuda.stream(stream):
        # Allocated on the side stream: every use is ordered on it.
        buf = torch.empty(int(sizes.sum()), dtype=torch.uint8, device=dev)
        offsets = np.ascontiguousarray(meta[:, 0])
        err = lib.al_nvjpeg_decode(
            dev.index, _path_array(paths), n, _ptr(offsets, ctypes.c_int64),
            buf.data_ptr(), stream.cuda_stream,
            _ptr(channels, ctypes.c_int32), _ptr(failed, ctypes.c_uint8),
            n_threads)
    _check_cuda_error(err, "nvJPEG decode")
    meta[:, 3] = np.where(failed != 0, 0, channels)
    return buf, meta


def _decode_crop_resize_cuda(paths, rects, out_size, n_threads, device,
                             dims):
    buf, meta = nvjpeg_decode(paths, dims, n_threads, device)
    meta[:, 4:] = rects
    with torch.cuda.stream(_side_stream(buf.device)):
        rows = crop_resize(buf, torch.from_numpy(meta), out_size)
        # The copy back waits on this stream alone.
        out = rows.cpu().numpy()
    return out, meta[:, 3] == 0
