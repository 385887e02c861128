"""The one retry policy (the JAX package's ``faults/retry.py``):
exponential backoff with jitter, attempt and wall budgets, and an
explicit transient / OOM / fatal classification that every call site
names.

  * TRANSIENT: back off and retry;
  * OOM: never retried at the same shape; re-raised for the degradation
    ladder's ``batch_half`` rung;
  * FATAL: re-raised at once.

Every retry is counted process-wide (``retry_counters``).  The JAX
package also ticks its run telemetry here; that waits for the port's
telemetry (ROADMAP.md queue 1, item 3).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from .registry import InjectedFault, InjectedOOM, ThreadDeath

TRANSIENT = "transient"
OOM = "oom"
FATAL = "fatal"

_COUNTERS_LOCK = threading.Lock()
_RETRIES_TOTAL = 0
_RETRIES_BY_SITE: Dict[str, int] = {}
_LAST_SITE: Optional[str] = None

_CUDA_OOM_PREFIX = "CUDA out of memory"


def _is_cuda_error(exc: BaseException) -> bool:
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    msg = str(exc)
    return isinstance(exc, RuntimeError) and (
        "CUDA error" in msg or "cudaError" in msg
        or msg.startswith("CUDA kernel"))


def classify_exception(exc: BaseException) -> str:
    """The classification the call sites share:

      OOM        allocator exhaustion: ``torch.OutOfMemoryError``, a
                 RuntimeError whose message starts "CUDA out of memory",
                 the injected stand-in, or XLA's RESOURCE_EXHAUSTED
                 marker.  The same shape fails the same way, so the
                 ladder halves the batch instead;
      FATAL      any other CUDA error (an illegal address, a failed
                 launch of a hand-written kernel): it poisons the
                 context, and a retry in this process would hide it;
      TRANSIENT  injected faults, injected thread death and OSError
                 (a full disk, a racing rename);
      FATAL      everything else.
    """
    if isinstance(exc, (InjectedOOM, torch.OutOfMemoryError)):
        return OOM
    msg = str(exc)
    if isinstance(exc, RuntimeError) and msg.startswith(_CUDA_OOM_PREFIX):
        return OOM
    if "RESOURCE_EXHAUSTED" in msg:
        return OOM
    if _is_cuda_error(exc):
        return FATAL
    if isinstance(exc, (InjectedFault, ThreadDeath)):
        return TRANSIENT
    if isinstance(exc, OSError):
        return TRANSIENT
    return FATAL


def _record_retry(site: str) -> None:
    global _RETRIES_TOTAL, _LAST_SITE
    with _COUNTERS_LOCK:
        _RETRIES_TOTAL += 1
        _RETRIES_BY_SITE[site] = _RETRIES_BY_SITE.get(site, 0) + 1
        _LAST_SITE = site


def retry_counters() -> Dict[str, Any]:
    """Process-cumulative retry accounting: {"total", "by_site",
    "last_site"}."""
    with _COUNTERS_LOCK:
        return {"total": _RETRIES_TOTAL,
                "by_site": dict(_RETRIES_BY_SITE),
                "last_site": _LAST_SITE}


class RetryPolicy:
    """Bounded, classified retry around one operation.  ``site`` labels
    the retried operation in the counters (a free-form name, not one of
    ``registry.SITES``); ``classify`` is required."""

    def __init__(self, site: str, classify: Callable[[BaseException], str],
                 max_attempts: int = 3, base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0, wall_budget_s: float = 30.0):
        if classify is None:
            raise ValueError(
                f"RetryPolicy({site!r}): classify is required; every "
                "call site states its transient-vs-fatal rule")
        self.site = site
        self.classify = classify
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.wall_budget_s = float(wall_budget_s)
        self._jitter = random.Random(f"retry:{site}")

    def call(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        """Run ``fn(*args, **kwargs)``; retry TRANSIENT failures with
        exponential backoff and jitter until the attempt or wall budget
        runs out, then re-raise the last failure.  OOM and FATAL re-raise
        at once."""
        t0 = time.monotonic()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except BaseException as exc:  # noqa: BLE001 - classified below
                if self.classify(exc) != TRANSIENT:
                    raise
                if attempt >= self.max_attempts:
                    raise
                if time.monotonic() - t0 >= self.wall_budget_s:
                    raise
                delay = min(self.max_delay_s,
                            self.base_delay_s * (2 ** (attempt - 1)))
                delay *= 0.5 + self._jitter.random()  # [0.5x, 1.5x)
                _record_retry(self.site)
                from ..utils.logging import get_logger
                get_logger().warning(
                    f"retry[{self.site}] attempt {attempt}/"
                    f"{self.max_attempts} failed with "
                    f"{type(exc).__name__}: {exc}; retrying in "
                    f"{delay * 1000:.0f} ms")
                time.sleep(delay)
