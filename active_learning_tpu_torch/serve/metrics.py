"""Serving-side observability: counters, a latency reservoir, and the
batch-occupancy histogram.

A copy of the JAX package's ``serve/metrics.py`` (without the
Prometheus view, which comes in a later slice).  Request latency is
this subsystem's headline metric, so the reservoir keeps the most
recent window of per-request latencies and serves p50/p99 on demand.
The occupancy histogram
(real rows per dispatched bucket) is the direct readout of how well the
microbatcher is filling the shapes it pays for: a service living at
occupancy 1 in a 64-bucket is latency-bound, one pegged at max_batch is
throughput-bound and a queue-depth candidate.

Thread discipline: the event loop thread and the executor thread both
write; everything is under one lock (counters are tiny, contention is
nil at any realistic qps).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional


def percentile(sorted_vals, q: float) -> Optional[float]:
    """Nearest-rank percentile over an ascending list; None when
    empty."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return float(sorted_vals[idx])


class ServeMetrics:
    def __init__(self, window: int = 8192):
        self._lock = threading.Lock()
        self._latencies = collections.deque(maxlen=window)
        self.requests: Dict[str, int] = collections.defaultdict(int)
        self.responses: Dict[int, int] = collections.defaultdict(int)
        # occupancy[bucket][real_rows] = dispatch count
        self.occupancy: Dict[int, Dict[int, int]] = {}
        self.rows_served = 0
        self.started = time.monotonic()

    def record_request(self, endpoint: str) -> None:
        with self._lock:
            self.requests[endpoint] += 1

    def record_response(self, status: int, latency_s: Optional[float],
                        rows: int = 0) -> None:
        with self._lock:
            self.responses[status] += 1
            self.rows_served += rows
            if latency_s is not None:
                self._latencies.append(latency_s)

    def record_batch(self, bucket: int, rows: int) -> None:
        with self._lock:
            hist = self.occupancy.setdefault(int(bucket), {})
            hist[int(rows)] = hist.get(int(rows), 0) + 1

    def snapshot(self) -> Dict:
        with self._lock:
            lats = sorted(self._latencies)
            uptime = time.monotonic() - self.started
            n_ok = self.responses.get(200, 0)
            return {
                "uptime_s": round(uptime, 1),
                "requests": dict(self.requests),
                "responses": {str(k): v for k, v in self.responses.items()},
                "rows_served": self.rows_served,
                "qps": round(n_ok / uptime, 2) if uptime > 0 else 0.0,
                "latency_ms": {
                    "p50": _ms(percentile(lats, 0.50)),
                    "p99": _ms(percentile(lats, 0.99)),
                    "n": len(lats),
                },
                "batch_occupancy": {
                    str(b): {str(r): c for r, c in sorted(h.items())}
                    for b, h in sorted(self.occupancy.items())
                },
            }


def _ms(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v * 1000.0, 3)
