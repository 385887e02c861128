"""The atomic round journal (the JAX package's ``faults/journal.py``):
one JSON file recording where the run is.

``round_journal.json`` lives in --log_dir and is rewritten atomically
(tmp + rename) with a monotonic ``seq``, so a reader (a post-mortem
after preemption, the driver's round-0 resume check) always sees a
complete, ordered record: the experiment's identity, the current round,
phase and attempt, the labeled-set size and CRC, the active degradation
rungs, and the terminal status (finished / preempted / crashed).  The
file's layout is the JAX package's, so either package reads the
other's.

A new RoundJournal over an existing file continues its ``seq``: the tag
never restarts within a log directory, across process restarts too.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

JOURNAL_FILE = "round_journal.json"


def read_journal(path: str) -> Optional[Dict[str, Any]]:
    """The journal payload, or None when absent/unparseable (a torn file
    is impossible by construction; missing means the run predates the
    journal or never started)."""
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None


class RoundJournal:
    """Merge-and-rewrite journal writer: a write merges its fields over
    the retained ones, so a ``status="preempted"`` record keeps the
    round and phase of the last regular write.  ``enabled=False`` (ranks
    other than the coordinator) makes every write a no-op.  Never
    raises: a full disk must not take the run down."""

    def __init__(self, path: str, enabled: bool = True):
        self.path = path
        self.enabled = enabled
        self._lock = threading.Lock()
        self._fields: Dict[str, Any] = {}
        prior = read_journal(path) if enabled else None
        self._seq = int(prior.get("seq", 0)) if prior else 0

    def write(self, **fields: Any) -> Optional[Dict[str, Any]]:
        """Merge ``fields`` (None values delete), bump seq, rewrite
        atomically.  Returns the written payload (None when disabled or
        the write failed)."""
        if not self.enabled:
            return None
        with self._lock:
            for k, v in fields.items():
                if v is None:
                    self._fields.pop(k, None)
                else:
                    self._fields[k] = v
            self._seq += 1
            payload = {**self._fields, "seq": self._seq, "ts": time.time()}
        try:
            directory = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(directory, exist_ok=True)
            # One writer (the coordinator), so one tmp name.
            tmp = f"{self.path}.tmp"
            with open(tmp, "w") as fh:
                json.dump(payload, fh)
            os.replace(tmp, self.path)
        except OSError:
            return None
        return payload
