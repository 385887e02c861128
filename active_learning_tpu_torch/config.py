"""Typed configs of the port (``ServeConfig`` of the JAX package's
``config.py``)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The online scoring service's knobs (the ``serve`` verb)."""

    host: str = "127.0.0.1"
    # 0 = ephemeral (the bound port is logged and exposed on the server).
    port: int = 8000
    # Rows per dispatched device batch, upper bound.  Served shapes are
    # the bucket ladder serve_buckets(max_batch, bucket_floor), every one
    # warmed at startup.
    max_batch: int = 64
    # Microbatch deadline: a batch closes at max_batch rows or this many
    # ms after its first row, whichever comes first.
    max_latency_ms: float = 5.0
    # Admission bound in ROWS (queued + in flight); beyond it requests
    # get 429 + Retry-After.
    queue_depth: int = 512
    # Floor of the bucket ladder: the smallest padded batch a lone
    # request is served at.
    bucket_floor: int = 8
    # Hot-reload poll cadence for a newer best_rd_{n} checkpoint; 0
    # checks before every batch.
    reload_every_s: float = 5.0
    # Bound on the SIGTERM graceful drain (in-flight completion).
    drain_timeout_s: float = 30.0
