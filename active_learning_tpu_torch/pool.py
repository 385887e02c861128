"""Shape bucketing (``bucket_size`` of the JAX package's ``pool.py``)."""

from __future__ import annotations


def bucket_size(n: int, floor: int = 256) -> int:
    """Bounded-waste geometric bucket: ``n`` rounded up to a multiple of
    1/8 of its enclosing power of two (never below ``floor``).  The
    serving batcher pads every dispatched batch to one of these, so the
    set of batch shapes the device ever sees is small and known at
    startup (each is warmed once); the 1/8-octave granularity caps the
    padded compute at 25% worst case."""
    n = max(int(n), int(floor))
    gran = max(int(floor), (1 << (n - 1).bit_length()) // 8)
    return -(-n // gran) * gran
