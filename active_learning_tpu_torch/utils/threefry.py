"""The pieces of JAX's default PRNG that the port draws with, in torch:
``PRNGKey``, ``split``, ``fold_in``, 32-bit ``random_bits``,
``randint``, ``uniform`` and the Gumbel noise of
``jax.random.categorical`` (the k-center D² draw, and VAAL's scoring
crop window).

They follow JAX 0.9.0 with ``jax_default_prng_impl = threefry2x32`` and
``jax_threefry_partitionable = True`` (``jax/_src/prng.py``,
``jax/_src/random.py``), so a pick drawn here from a seed is the JAX
package's pick from the same seed:

* a key is two uint32 words, ``(seed >> 32, seed & 0xffffffff)``;
* ``split(key, n)[i]`` is the Threefry-2x32 hash of the counter pair
  ``(0, i)`` under ``key``, both output words;
* ``fold_in(key, data)`` is the hash of the pair ``(0, data)`` under
  ``key``, both output words (``data`` as a uint32);
* ``random_bits(key, n)[i]`` hashes the 64-bit counter ``i`` as the pair
  ``(i >> 32, i & 0xffffffff)`` and xors the two output words;
* ``randint(key, lo, hi)`` splits ``key`` in two, draws 32 bits from
  each and folds them into ``[lo, hi)`` as ``(hi_bits % span · m +
  lo_bits % span) % span`` with ``m = (2**16 % span)² % span``, every
  product and sum wrapping in uint32 as JAX's do;
* ``uniform`` puts the top 23 bits into the mantissa of a float in
  [1, 2), subtracts 1, scales to ``[minval, maxval)`` and clamps at
  ``minval``;
* ``gumbel`` is ``-log(-log(u))`` with ``u = uniform(tiny, 1)`` (the
  "low" mode, JAX's default), and ``categorical(key, logits)`` is
  ``argmax(gumbel + logits)``, first index on ties.

The words live in int64 tensors (torch has no full uint32 arithmetic),
masked to 32 bits after every add and shift, on whatever device the
caller asks for; the integer bits are exact on any device.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = float(np.finfo(np.float32).tiny)

Key = Tuple[int, int]
Device = Union[str, torch.device, None]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` as its two uint32 words."""
    seed = int(seed)
    return (seed >> 32) & _MASK, seed & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs
    ``(x0, x1)`` (int64 tensors holding uint32 values) under ``key``."""
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _counters(n: int, device: Device) -> Tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _MASK


def split(key: Key, n: int) -> np.ndarray:
    """``jax.random.split(key, n)``: ``[n, 2]`` uint32 key words."""
    hi, lo = _counters(n, None)
    b0, b1 = threefry2x32(key, hi, lo)
    return torch.stack([b0, b1], dim=1).numpy().astype(np.uint32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    b0, b1 = threefry2x32(key, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & _MASK]))
    return int(b0[0]), int(b1[0])


def random_bits(key: Key, n: int, device: Device = None) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)``, as int64 holding the
    uint32 values."""
    hi, lo = _counters(n, device)
    b0, b1 = threefry2x32(key, hi, lo)
    return b0 ^ b1


def randint(key: Key, minval: int, maxval: int) -> int:
    """``jax.random.randint(key, (), minval, maxval)`` for int32 bounds:
    ``minval`` when ``maxval <= minval``."""
    k1, k2 = (tuple(int(w) for w in k) for k in split(key, 2))
    higher = int(random_bits(k1, 1)[0])
    lower = int(random_bits(k2, 1)[0])
    span = (maxval - minval) & _MASK if maxval > minval else 1
    half = 2 ** 16 % span
    multiplier = ((half * half) & _MASK) % span
    offset = (((higher % span) * multiplier) & _MASK) + lower % span
    return int(minval + (offset & _MASK) % span)


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """Uniform float32 in [0, 1) from 32 random bits (the top 23 go
    into the mantissa)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: Key, n: int, minval: float = 0.0, maxval: float = 1.0,
            device: Device = None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``."""
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    u = bits_to_unit(random_bits(key, n, device))
    return torch.maximum(lo, u * (hi - lo) + lo)


def gumbel(key: Key, n: int, device: Device = None) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)``: ``-log(-log(u))``."""
    return -torch.log(-torch.log(uniform(key, n, TINY, 1.0, device)))


def categorical(key: Key, logits: torch.Tensor) -> int:
    """``jax.random.categorical(key, logits)`` over a 1-D ``logits``."""
    g = gumbel(key, logits.shape[0], logits.device)
    return int(torch.argmax(g + logits))
