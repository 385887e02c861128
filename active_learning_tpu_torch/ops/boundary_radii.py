"""Kernel F: MASE's boundary radii and the head's pair norms (ROADMAP
K5, radii half).

Replaces the JAX package's ``strategies/scoring.py:196-206``
``head_pair_norms`` and ``:209-267`` ``boundary_radii``, with MASE's
``min_margin`` (``:290``).  The CUDA source is ``csrc/boundary_radii.cu``
(its header gives the arithmetic, the bound and the design).
``boundary_radii`` and ``head_pair_norms`` launch it on CUDA tensors and
run their plain versions, below, only on CPU tensors.  Rows with NaN or
±inf follow the reference: the argmax returns the first NaN, and a NaN
radius makes ``min_margin`` NaN.

Layouts follow the JAX package: ``kernel`` is the flax Dense kernel
``[D, C]`` (torch's ``linear.weight`` transposed), ``bias`` ``[C]``, the
embeddings ``[B, D]``, all float32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ..device import full_float32
from . import _build

# Kernel launches since the process started (or since a caller reset
# them), as the C entries count them: two a radii call, one a table.
radii_launches = 0
pair_norms_launches = 0

# Elements of the [B, block, D] weight-difference tile of the plain
# version (the JAX package's ~128 MB tile).
_TILE_ELEMS = 2 ** 25


F32_EPS = 2.0 ** -23


def reset_launches() -> None:
    global radii_launches, pair_norms_launches
    radii_launches = pair_norms_launches = 0


def radii_tolerance(embedding: torch.Tensor, radii: torch.Tensor
                    ) -> torch.Tensor:
    """How far two float32 evaluations of the radii may differ when they
    sum in other orders: 2 * D * eps * (||e|| + |radius|) per entry (the
    numerator's error is at most D * eps * ||e|| ||w_pred - w_j||, the
    norm's D * eps of itself, and the two evaluations double it).  The
    bound kernel F is held to against its plain version."""
    d = embedding.shape[1]
    norm_e = torch.linalg.vector_norm(embedding.to(torch.float32), dim=1)
    return 2.0 * d * F32_EPS * (norm_e[:, None] + radii.abs())


def logits_tolerance(embedding: torch.Tensor, kernel: torch.Tensor
                     ) -> torch.Tensor:
    """The same bound for the logits, per row: where two evaluations
    predict different classes, their logits must lie this close."""
    d = embedding.shape[1]
    norm_e = torch.linalg.vector_norm(embedding.to(torch.float32), dim=1)
    norm_w = torch.linalg.vector_norm(kernel.to(torch.float32), dim=0).max()
    return 2.0 * d * F32_EPS * norm_e * norm_w


def _rows(kernel: torch.Tensor) -> torch.Tensor:
    """The head's rows ``w [C, D]`` in float32, contiguous."""
    return kernel.T.to(torch.float32).contiguous()


def head_pair_norms_reference(kernel: torch.Tensor) -> torch.Tensor:
    """[C, C] table of ||w_c - w_j|| by explicit row differences, in
    blocks of rows (never the Gram identity)."""
    w = _rows(kernel)
    c, d = w.shape
    block = max(1, min(c, _TILE_ELEMS // max(1, c * d)))
    out = torch.empty(c, c, dtype=torch.float32, device=w.device)
    for r0 in range(0, c, block):
        diff = w[None, :, :] - w[r0:r0 + block, None, :]
        out[r0:r0 + block] = torch.sqrt(torch.sum(diff * diff, dim=-1))
    return out


def boundary_radii_reference(embedding: torch.Tensor, kernel: torch.Tensor,
                             bias: torch.Tensor,
                             pair_norms: Optional[torch.Tensor] = None
                             ) -> Dict[str, torch.Tensor]:
    """The JAX function in torch: logits in float32 (TF32 off), argmax
    with ties to the first index, then the numerator with the weight
    difference formed first, in class blocks, over the pair-norm table.
    Returns ``radii`` [B, C], ``pred`` [B] int32, ``min_margin`` [B]."""
    e = embedding.to(torch.float32)
    w = _rows(kernel)
    b = bias.to(torch.float32)
    with full_float32():
        logits = e @ w.T + b
    preds = torch.argmax(logits, dim=-1)
    if pair_norms is None:
        pair_norms = head_pair_norms_reference(kernel)
    denom = pair_norms[preds]
    c, d = w.shape
    block = min(c, max(1, _TILE_ELEMS // max(1, e.shape[0] * d)))
    w_pred, b_pred = w[preds], b[preds]
    numer = torch.empty(e.shape[0], c, dtype=torch.float32, device=e.device)
    for c0 in range(0, c, block):
        delta = w_pred[:, None, :] - w[None, c0:c0 + block, :]
        numer[:, c0:c0 + block] = (torch.sum(e[:, None, :] * delta, dim=-1)
                                   + b_pred[:, None] - b[None, c0:c0 + block])
    radii = torch.where(denom > 0, numer / torch.clamp(denom, min=1e-30),
                        torch.full_like(numer, float("inf")))
    return {"radii": radii, "pred": preds.to(torch.int32),
            "min_margin": radii.min(dim=-1).values}


def _check(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError("boundary_radii: every tensor on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"boundary_radii: unsupported device {dev}")


def _vec(*tensors: torch.Tensor) -> int:
    """1 when the kernel may copy in 16-byte pieces: every row a multiple
    of 4 floats long and every base address 16-byte aligned."""
    return int(tensors[0].shape[-1] % 4 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def head_pair_norms(kernel: torch.Tensor) -> torch.Tensor:
    """[C, C] of ||w_c - w_j|| for the flax kernel ``[D, C]``; on the card
    symmetric bit for bit."""
    global pair_norms_launches
    _check(kernel)
    if kernel.ndim != 2:
        raise ValueError(f"kernel must be [D, C], got {tuple(kernel.shape)}")
    if kernel.device.type == "cpu":
        return head_pair_norms_reference(kernel)
    w = _rows(kernel)
    c, d = w.shape
    out = torch.empty(c, c, dtype=torch.float32, device=w.device)
    launched = ctypes.c_int(0)
    with torch.cuda.device(w.device):
        err = _lib().br_pair_norms(
            w.data_ptr(), c, d, _vec(w), out.data_ptr(),
            ctypes.byref(launched), torch.cuda.current_stream().cuda_stream)
    pair_norms_launches += launched.value
    if err != 0:
        raise RuntimeError(f"head_pair_norms kernel launch failed: CUDA "
                           f"error {err}")
    return out


def boundary_radii(embedding: torch.Tensor, kernel: torch.Tensor,
                   bias: torch.Tensor,
                   pair_norms: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """Distances from each embedding ``[B, D]`` to every one-vs-one
    boundary of the head (``radii`` [B, C], +inf at the predicted class),
    the predicted class (``pred`` int32) and the smallest radius
    (``min_margin``).  ``pair_norms``: ``head_pair_norms(kernel)``, passed
    in when many batches meet one head.  On the card this is two kernel
    launches; ``radii_launches`` grows by the count the C entry reports."""
    global radii_launches
    _check(embedding, kernel, bias)
    if embedding.ndim != 2 or kernel.ndim != 2 or bias.ndim != 1 or \
            embedding.shape[1] != kernel.shape[0] or \
            kernel.shape[1] != bias.shape[0]:
        raise ValueError(
            f"shapes: embedding {tuple(embedding.shape)}, kernel "
            f"{tuple(kernel.shape)}, bias {tuple(bias.shape)}")
    if embedding.device.type == "cpu":
        return boundary_radii_reference(embedding, kernel, bias, pair_norms)
    if pair_norms is None:
        pair_norms = head_pair_norms(kernel)
    e = embedding.to(torch.float32).contiguous()
    w = _rows(kernel)
    b = bias.to(torch.float32).contiguous()
    norms = pair_norms.to(torch.float32).contiguous()
    bsz, d = e.shape
    c = w.shape[0]
    if norms.shape != (c, c):
        raise ValueError(f"pair_norms must be [{c}, {c}]")
    dev = e.device
    out = {"radii": torch.empty(bsz, c, dtype=torch.float32, device=dev),
           "pred": torch.empty(bsz, dtype=torch.int32, device=dev),
           "min_margin": torch.empty(bsz, dtype=torch.float32, device=dev)}
    if bsz == 0:
        return out
    lib = _lib()
    nbytes = lib.br_scratch_bytes(bsz, c)
    if nbytes < 0:
        raise ValueError(f"boundary_radii: B={bsz}, C={c} is too large")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = lib.br_radii(
            e.data_ptr(), w.data_ptr(), b.data_ptr(), norms.data_ptr(), bsz,
            c, d, _vec(e, w), scratch.data_ptr(), out["pred"].data_ptr(),
            out["radii"].data_ptr(), out["min_margin"].data_ptr(),
            ctypes.byref(launched), torch.cuda.current_stream().cuda_stream)
    radii_launches += launched.value
    if err != 0:
        raise RuntimeError(f"boundary_radii kernel launch failed: CUDA "
                           f"error {err}")
    return out


_p, _i = ctypes.c_void_p, ctypes.c_int
# The C entry points' argument types (csrc/boundary_radii.cu).
_ARGTYPES = {
    "br_scratch_bytes": [_i, _i],
    "br_radii": [_p, _p, _p, _p, _i, _i, _i, _i, _p, _p, _p, _p, _p, _p],
    "br_pair_norms": [_p, _i, _i, _i, _p, _p, _p],
}

_lib_handle = None


def _lib():
    """The C entry points, built and bound at first use."""
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("boundary_radii")
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib_handle = lib
    return _lib_handle
