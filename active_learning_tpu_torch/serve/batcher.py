"""Async microbatching with bucket padding and bounded admission.

The batcher (a copy of the JAX package's ``serve/batcher.py``) is the
seam between irregular request arrivals and the executor's fixed-shape
batches.  Three rules govern it:

  * **Coalesce, bounded two ways.**  A batch closes when it holds
    ``max_batch`` rows (full-batch flush — immediate, the deadline is
    NOT awaited) or when ``max_latency_ms`` has elapsed since its first
    row arrived (deadline flush — a lone late-night request never waits
    longer than the deadline).  An entry that would overflow the batch
    is carried into the next one whole; entries are never split here
    (``submit`` already chunks oversized requests), so responses always
    slice contiguously out of one batch.
  * **Every dispatched shape is a bucket.**  Real rows are padded up to
    the enclosing geometric bucket (pool.bucket_size).  The bucket
    ladder is enumerable at startup, so the executor warms every shape
    the request path can ever produce.  Padding rows repeat the batch's
    first real row with mask 0.0; the scoring steps are per-example
    under eval-mode BN, so padded rows cannot perturb real rows.
  * **Admission is bounded.**  ``queue_depth`` caps the ROWS admitted
    but not yet completed (queued + in flight on device); past it,
    ``submit`` raises ``QueueFullError`` and the server answers 429 +
    Retry-After — explicit backpressure instead of unbounded latency.

Single-threaded discipline: all batcher state lives on the event loop
thread.  The executor completes entries from its own thread via each
entry's ``loop.call_soon_threadsafe``; the row-count decrement comes
back the same way.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..pool import bucket_size

# Default floor for the serve bucket ladder: far below the pool-scan
# floor (256) because a serving microbatch's lower bound is ONE row —
# the ladder must reach down to interactive single-image requests
# without padding them 256-wide.
SERVE_BUCKET_FLOOR = 8


class QueueFullError(Exception):
    """Admission refused: queued + in-flight rows would exceed
    ``queue_depth``.  The server maps this to 429 + Retry-After."""


class BatcherClosedError(Exception):
    """submit() after drain began; the server maps this to 503."""


def serve_buckets(max_batch: int, floor: int = SERVE_BUCKET_FLOOR
                  ) -> List[int]:
    """The complete ladder of batch shapes this service will ever
    dispatch: geometric buckets (pool.bucket_size) covering
    1..max_batch.  Sorted ascending; the executor warms every entry at
    startup."""
    max_batch = max(1, int(max_batch))
    floor = max(1, int(floor))
    raw = {bucket_size(n, floor=floor) for n in range(1, max_batch + 1)}
    return sorted(raw)


class _Entry:
    """One contiguous run of rows awaiting results: a whole request, or
    one ≤max_batch chunk of an oversized one."""

    __slots__ = ("images", "n", "future", "want_embed", "offset")

    def __init__(self, images: np.ndarray, future: asyncio.Future,
                 want_embed: bool):
        self.images = images
        self.n = int(images.shape[0])
        self.future = future
        self.want_embed = want_embed
        self.offset = 0  # row offset inside the dispatched batch


class MicroBatcher:
    """Coalesce request entries into bucket-padded microbatches and hand
    them to ``dispatch`` (the executor's thread-safe inbox).

    ``dispatch(host_batch, entries, want_embed)`` receives the padded
    ``{"image", "mask"}`` batch plus the entries (with ``offset`` set)
    whose futures the executor resolves.  ``on_batch`` (optional)
    observes ``(bucket, real_rows)`` per dispatch for the occupancy
    histogram.
    """

    _DRAIN = object()

    def __init__(
        self,
        dispatch: Callable,
        max_batch: int,
        max_latency_ms: float,
        queue_depth: int,
        bucket_floor: int = SERVE_BUCKET_FLOOR,
        on_batch: Optional[Callable] = None,
    ):
        self._dispatch = dispatch
        self.max_batch = int(max_batch)
        self.max_latency_s = float(max_latency_ms) / 1000.0
        self.queue_depth = int(queue_depth)
        self.buckets = serve_buckets(max_batch, floor=bucket_floor)
        self._on_batch = on_batch
        self._inbox: asyncio.Queue = asyncio.Queue()
        self._carry: Optional[_Entry] = None
        # Admitted, not yet completed: the 429 backpressure bound.  Every
        # touch takes the admission lock, so a future resolved off-loop
        # can never silently breach queue_depth.
        self._pending_rows = 0
        self._admission_lock = threading.Lock()
        self._closing = False
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._task = self._loop.create_task(self._run(),
                                            name="al-serve-batcher")

    @property
    def pending_rows(self) -> int:
        with self._admission_lock:
            return self._pending_rows

    # -- admission (event-loop thread) -----------------------------------

    async def submit(self, images: np.ndarray,
                     want_embed: bool = False) -> Dict[str, np.ndarray]:
        """Queue ``images`` (uint8 [n, H, W, C]) and await the per-row
        result dict.  Oversized requests are chunked to ≤max_batch entry
        runs and the chunk results concatenated, so a client batch of
        any size gets one coherent answer."""
        if self._closing:
            raise BatcherClosedError("server is draining")
        n = int(images.shape[0])
        if n == 0:
            raise ValueError("empty request")
        with self._admission_lock:
            pending = self._pending_rows
            if pending + n > self.queue_depth:
                admitted = False
            else:
                # Check-and-increment atomically: two submits racing the
                # bound must not both pass the check and overshoot it.
                self._pending_rows = pending + n
                admitted = True
        if not admitted:
            raise QueueFullError(
                f"{pending} rows pending, request of {n} "
                f"exceeds queue_depth={self.queue_depth}")
        loop = asyncio.get_running_loop()
        entries = []
        for start in range(0, n, self.max_batch):
            chunk = images[start:start + self.max_batch]
            e = _Entry(chunk, loop.create_future(), want_embed)
            # Admission releases PER CHUNK as each future settles (done
            # callbacks fire exactly once, success or failure) — never
            # in bulk when the first chunk of a multi-chunk request
            # fails while its siblings still occupy the inbox/device;
            # a bulk release there would admit new work on top of the
            # orphan rows and breach the queued+in-flight bound.
            e.future.add_done_callback(
                lambda _f, rows=e.n: self._release(rows))
            entries.append(e)
        for e in entries:
            self._inbox.put_nowait(e)
        # gather (not sequential awaits): a failing chunk must not
        # leave later chunks' exceptions unretrieved.
        outs = await asyncio.gather(*(e.future for e in entries))
        if len(outs) == 1:
            return outs[0]
        # Per-row arrays concatenate back into request order; scalar
        # riders (e.g. the served round) take the LAST chunk's value —
        # under a mid-request hot reload that is the newest round any
        # of the rows saw.
        return {k: (outs[-1][k] if np.ndim(outs[0][k]) == 0
                    else np.concatenate([o[k] for o in outs], axis=0))
                for k in outs[0]}

    # -- the coalescing loop ---------------------------------------------

    async def _run(self) -> None:
        draining = False
        while not draining:
            first = self._carry
            self._carry = None
            if first is None:
                got = await self._inbox.get()
                if got is self._DRAIN:
                    break
                first = got
            batch = [first]
            rows = first.n
            deadline = time.monotonic() + self.max_latency_s
            while rows < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break  # deadline flush
                try:
                    got = await asyncio.wait_for(self._inbox.get(), timeout)
                except asyncio.TimeoutError:
                    break  # deadline flush
                if got is self._DRAIN:
                    draining = True
                    break
                if rows + got.n > self.max_batch:
                    self._carry = got  # whole-entry carry; flush now
                    break
                batch.append(got)
                rows += got.n
            self._flush(batch, rows)
        # Drain: flush everything still queued immediately — no deadline
        # waits, no new admissions (submit raises BatcherClosedError).
        leftover = [self._carry] if self._carry is not None else []
        self._carry = None
        while not self._inbox.empty():
            got = self._inbox.get_nowait()
            if got is not self._DRAIN:
                leftover.append(got)
        batch, rows = [], 0
        for e in leftover:
            if rows + e.n > self.max_batch:
                self._flush(batch, rows)
                batch, rows = [], 0
            batch.append(e)
            rows += e.n
        if batch:
            self._flush(batch, rows)

    def _flush(self, batch: List[_Entry], rows: int) -> None:
        if not batch:
            return
        bucket = next((b for b in self.buckets if b >= rows),
                      self.buckets[-1])
        images = (batch[0].images if len(batch) == 1
                  else np.concatenate([e.images for e in batch], axis=0))
        pad = bucket - rows
        mask = np.ones(bucket, dtype=np.float32)
        if pad:
            # Pad rows repeat the first real row, mask 0.0 — the layout
            # of the offline scoring pipeline.
            images = np.concatenate(
                [images, np.repeat(images[:1], pad, axis=0)], axis=0)
            mask[rows:] = 0.0
        off = 0
        for e in batch:
            e.offset = off
            off += e.n
        if self._on_batch is not None:
            self._on_batch(bucket, rows)
        self._dispatch({"image": images, "mask": mask}, list(batch),
                       any(e.want_embed for e in batch))

    # -- completion + drain ----------------------------------------------

    def _release(self, rows: int) -> None:
        """Per-chunk admission release (future done callback, loop
        thread)."""
        with self._admission_lock:
            self._pending_rows -= rows

    async def drain(self, poll_s: float = 0.01,
                    timeout_s: Optional[float] = None) -> None:
        """Stop admitting, flush every queued entry, and wait until all
        admitted rows have completed.  The executor must keep running
        until this returns — it is what resolves the futures."""
        self._closing = True
        self._inbox.put_nowait(self._DRAIN)
        if self._task is not None:
            await self._task
        t0 = time.monotonic()
        while self.pending_rows > 0:
            if timeout_s is not None and time.monotonic() - t0 > timeout_s:
                raise asyncio.TimeoutError(
                    f"drain: {self.pending_rows} rows still pending "
                    f"after {timeout_s}s")
            await asyncio.sleep(poll_s)
