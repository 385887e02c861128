"""Driver-side preemption (the JAX package's ``faults/preempt.py``):
SIGTERM/SIGINT become checkpoint-and-exit.

  * The signal handler only records the request and logs once;
  * the trainer checks at each epoch boundary, after publishing a
    pending best checkpoint and saving the mid-round fit state, so the
    resumed fit continues bit for bit, and the driver checks at each
    phase boundary; whichever sees the flag first raises
    ``PreemptionRequested``;
  * the driver writes the round journal (``status="preempted"``) and
    re-raises; the CLI exits 0.  ``--resume_training`` then reproduces
    the uninterrupted run's experiment state bit for bit.

Handlers install only on the main thread (``signal.signal`` requires
it; a caller running ``run_experiment`` on a worker keeps its own
handling), and ``uninstall`` restores the previous ones, so a run never
leaks its disposition into the host process.
"""

from __future__ import annotations

import signal
import threading
from typing import Any, Dict, Optional


class PreemptionRequested(Exception):
    """Raised at a safe point after SIGTERM/SIGINT; carries the signal
    number.  The run's durable state is consistent when this is raised:
    resuming reproduces the uninterrupted run."""

    def __init__(self, signum: int):
        name = {signal.SIGTERM: "SIGTERM",
                signal.SIGINT: "SIGINT"}.get(signum, str(signum))
        super().__init__(f"preemption requested ({name}); state "
                         "checkpointed for --resume_training")
        self.signum = signum


_STATE: Dict[str, Any] = {"signum": None, "logger": None}


def _handler(signum, frame) -> None:  # pragma: no cover - exercised via kill
    first = _STATE["signum"] is None
    _STATE["signum"] = signum
    logger = _STATE.get("logger")
    if first and logger is not None:
        try:
            logger.warning(
                "preemption signal received: checkpointing at the next "
                "epoch/phase boundary, then exiting for --resume_training")
        except Exception:  # noqa: BLE001 - inside a signal handler
            pass


def install(logger=None) -> Optional[Dict[int, Any]]:
    """Install the SIGTERM/SIGINT recorders; returns the previous
    handlers for ``uninstall``, or None when not on the main thread
    (the host process keeps its own handling)."""
    if threading.current_thread() is not threading.main_thread():
        return None
    _STATE["logger"] = logger
    previous = {}
    for signum in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[signum] = signal.signal(signum, _handler)
        except (ValueError, OSError):  # pragma: no cover - exotic hosts
            pass
    return previous


def uninstall(previous: Optional[Dict[int, Any]]) -> None:
    if not previous:
        return
    for signum, handler in previous.items():
        try:
            signal.signal(signum, handler)
        except (ValueError, OSError):  # pragma: no cover
            pass


def reset() -> None:
    """Clear a recorded request (at run start: a flag left by an
    earlier run in this process must not stop the new one)."""
    _STATE["signum"] = None


def requested() -> Optional[int]:
    """The recorded signal number, or None."""
    return _STATE["signum"]


def check() -> None:
    """Raise PreemptionRequested if a signal was recorded: the one
    spelling every safe point uses."""
    signum = _STATE["signum"]
    if signum is not None:
        raise PreemptionRequested(signum)
