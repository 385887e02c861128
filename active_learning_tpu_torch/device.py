"""Device resolution: the single-device part of the JAX package's
``parallel/mesh.py::make_mesh``.

Entry points run on the card unless the caller asks for the CPU.  With
no card and no such request they raise: nothing falls back quietly,
because a CPU number reported as the card's would be wrong twice.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

import torch


def resolve_device(spec: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``None``/``"cuda"`` -> ``cuda:0``; ``"cpu"`` -> cpu; any other
    torch device string is taken as given.  A CUDA request without a
    visible card raises RuntimeError."""
    dev = torch.device("cuda:0" if spec in (None, "", "cuda") else spec)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' "
                "(--device cpu) to run the port on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {spec!r}; use cuda or cpu")
    return dev


def set_float32_precision(dtype: torch.dtype) -> None:
    """In float32 mode, keep float32 convolutions and matmuls in full
    float32.  cuDNN runs float32 convolutions in TF32 by default, which
    keeps about three decimal digits and puts the f32 forward about 1e-3
    away from the JAX reference; the parity contract is 1e-4."""
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """Float32 matrix products and convolutions in full float32 for the
    scope (TF32 off), then the previous settings back: the plain
    versions of the kernels are yardsticks, and TF32 would round their
    products to 10 mantissa bits."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
