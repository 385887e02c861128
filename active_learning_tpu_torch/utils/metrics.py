"""Experiment-metrics sinks (the JAX package's ``utils/metrics.py``,
JSONL backend): the reference's metric schema — ``cumulative_budget``,
``rd_test_accuracy``, ``budget_test_accuracy``,
``rd_{n}_validation_accuracy``, the per-round phase times, per-class and
queried-index assets — as an append-only ``metrics.jsonl`` with the JAX
package's event records ``{"kind": "params"|"metric"|"asset", "ts",
...}``."""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any, Dict, Optional


class MetricsSink:
    """Abstract sink; ``step`` is a round, an epoch or a budget,
    depending on the metric."""

    def log_parameters(self, params: Dict[str, Any]) -> None:
        raise NotImplementedError

    def log_metrics(self, metrics: Dict[str, float],
                    step: Optional[float] = None) -> None:
        raise NotImplementedError

    def log_metric(self, name: str, value: float,
                   step: Optional[float] = None) -> None:
        self.log_metrics({name: value}, step=step)

    def log_asset(self, name: str, data: str) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullSink(MetricsSink):
    """Discards everything (a Strategy built without a sink)."""

    def log_parameters(self, params):  # noqa: D102
        pass

    def log_metrics(self, metrics, step=None):  # noqa: D102
        pass

    def log_asset(self, name, data):  # noqa: D102
        pass


class JsonlSink(MetricsSink):
    """Append-only JSONL event stream ``directory/metrics.jsonl``; assets
    are also written as files under ``directory/assets/``."""

    def __init__(self, directory: str,
                 experiment_key: Optional[str] = None):
        self.directory = directory
        os.makedirs(os.path.join(directory, "assets"), exist_ok=True)
        self.experiment_key = experiment_key or uuid.uuid4().hex[:9]
        self._fh = open(os.path.join(directory, "metrics.jsonl"), "a")
        self._lock = threading.Lock()

    def _emit(self, event: Dict[str, Any]) -> None:
        event["ts"] = time.time()
        line = json.dumps(event, default=_json_default) + "\n"
        with self._lock:
            self._fh.write(line)
            self._fh.flush()

    def log_parameters(self, params):
        self._emit({"kind": "params", "params": params})

    def log_metrics(self, metrics, step=None):
        self._emit({"kind": "metric", "step": step,
                    "metrics": {k: _to_float(v) for k, v in metrics.items()}})

    def log_asset(self, name, data):
        path = os.path.join(self.directory, "assets", f"{name}.txt")
        with open(path, "w") as fh:
            fh.write(data)
        self._emit({"kind": "asset", "name": name, "path": path})

    def close(self):
        with self._lock:
            self._fh.close()


def _to_float(v: Any) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


def _json_default(o: Any):
    import numpy as np
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, np.generic):
        return o.item()
    return str(o)

