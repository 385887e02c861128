"""Per-phase wall clocks (``phase_timer`` of the JAX package's
``utils/tracing.py``)."""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

from .logging import get_logger


class Span:
    duration_s: float = 0.0


@contextlib.contextmanager
def phase_timer(name: str, round_idx: int, sink=None,
                logger=None) -> Iterator[Span]:
    """Wall-clock a phase, log ``Rd {n} {name} is {s}s`` and emit
    ``rd_{name}`` to the metrics sink, as the JAX driver does."""
    logger = logger or get_logger()
    span = Span()
    t0 = time.perf_counter()
    try:
        yield span
    finally:
        span.duration_s = time.perf_counter() - t0
    logger.info(f"Rd {round_idx} {name} is {span.duration_s:.3f}s")
    if sink is not None:
        sink.log_metric(f"rd_{name}", span.duration_s, step=round_idx)
