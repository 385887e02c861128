"""Online score drift for the scoring service (``ServeScoreDrift`` of
the JAX package's ``telemetry/diagnostics.py``, with the histogram and
drift math it needs).  Host-pure numpy.

The executor folds each served batch's margins into a live fixed-bin
histogram; a hot reload turns what the previous checkpoint served into
the baseline, and ``/metrics`` reports the live-vs-baseline PSI and JS
divergence.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

# Fixed-bin specs per served score kind: (lo, hi, bins).
SCORE_SPECS: Dict[str, Tuple[float, float, int]] = {
    "margin": (0.0, 1.0, 64),
    "confidence": (0.0, 1.0, 64),
    "entropy": (0.0, 8.0, 64),
}
# Below this many samples on either side, drift is None — not a number.
MIN_DRIFT_N = 16
# PSI zero-bin floor.
PSI_EPS = 1e-4


class ScoreHistogram:
    """A fixed-bin streaming histogram with exact summary accumulators
    (n/sum/sumsq/min/max over the raw values)."""

    def __init__(self, key: str, lo: float, hi: float, bins: int):
        if not hi > lo or bins < 2:
            raise ValueError(f"bad histogram spec ({lo}, {hi}, {bins})")
        self.key = key
        self.lo = float(lo)
        self.hi = float(hi)
        self.bins = int(bins)
        self.counts = np.zeros(self.bins, dtype=np.int64)
        self.n = 0
        self.n_nan = 0
        self.vsum = 0.0
        self.vsumsq = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def spec(self) -> Tuple[str, float, float, int]:
        return (self.key, self.lo, self.hi, self.bins)

    def add(self, values) -> "ScoreHistogram":
        """Fold host values in.  NaNs are dropped (and counted); mass
        outside [lo, hi] clamps into the edge bins."""
        v = np.asarray(values, dtype=np.float64).ravel()
        finite = np.isfinite(v)
        self.n_nan += int(v.size - np.count_nonzero(finite))
        v = v[finite]
        if v.size == 0:
            return self
        self.n += int(v.size)
        self.vsum += float(v.sum())
        self.vsumsq += float(np.square(v).sum())
        self.vmin = min(self.vmin, float(v.min()))
        self.vmax = max(self.vmax, float(v.max()))
        idx = np.floor((v - self.lo) / (self.hi - self.lo) * self.bins)
        idx = np.clip(idx, 0, self.bins - 1).astype(np.int64)
        self.counts += np.bincount(idx, minlength=self.bins
                                   ).astype(np.int64)
        return self

    def fractions(self) -> np.ndarray:
        total = int(self.counts.sum())
        if total == 0:
            return np.zeros(self.bins, dtype=np.float64)
        return self.counts / float(total)

    def to_dict(self) -> Dict[str, Any]:
        return {"key": self.key, "lo": self.lo, "hi": self.hi,
                "bins": self.bins, "transform": "none",
                "counts": self.counts.tolist(), "n": self.n,
                "n_nan": self.n_nan, "sum": self.vsum,
                "sumsq": self.vsumsq,
                "min": None if self.n == 0 else self.vmin,
                "max": None if self.n == 0 else self.vmax}


def histogram_for(key: str) -> ScoreHistogram:
    """An empty histogram with the canonical spec for a score kind."""
    return ScoreHistogram(key, *SCORE_SPECS[key])


def _fractions(a: ScoreHistogram, b: ScoreHistogram
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    if a.spec() != b.spec():
        raise ValueError(
            f"drift between different histogram specs is undefined: "
            f"{a.spec()} vs {b.spec()}")
    if a.n < MIN_DRIFT_N or b.n < MIN_DRIFT_N:
        return None
    return a.fractions(), b.fractions()


def psi(cur: ScoreHistogram, ref: ScoreHistogram) -> Optional[float]:
    """Population Stability Index of ``cur`` against ``ref``, zero bins
    floored at PSI_EPS; None below MIN_DRIFT_N on either side."""
    fracs = _fractions(cur, ref)
    if fracs is None:
        return None
    p = np.maximum(fracs[0], PSI_EPS)
    q = np.maximum(fracs[1], PSI_EPS)
    return float(np.sum((p - q) * np.log(p / q)))


def js_divergence(cur: ScoreHistogram, ref: ScoreHistogram
                  ) -> Optional[float]:
    """Jensen–Shannon divergence in nats (bounded by ln 2)."""
    fracs = _fractions(cur, ref)
    if fracs is None:
        return None
    p, q = fracs
    m = 0.5 * (p + q)

    def _kl(a: np.ndarray) -> float:
        nz = a > 0
        return float(np.sum(a[nz] * np.log(a[nz] / m[nz])))

    return 0.5 * _kl(p) + 0.5 * _kl(q)


class ServeScoreDrift:
    """Live score histogram plus the drift against what the previous
    checkpoint served.  ``observe``/``rebaseline`` run on the executor
    thread, ``snapshot`` on the server thread; all state is under
    ``_lock``."""

    def __init__(self, key: str = "margin"):
        self.key = key
        self._lock = threading.Lock()
        self._live = histogram_for(key)
        self._baseline: Optional[ScoreHistogram] = None
        self._baseline_round: Optional[int] = None

    def observe(self, values) -> None:
        with self._lock:
            self._live.add(values)

    def rebaseline(self, served_round: Optional[int]) -> None:
        """A new checkpoint took over: what the previous one served is
        now the reference distribution."""
        with self._lock:
            if self._live.n > 0:
                self._baseline = self._live
                self._baseline_round = served_round
            self._live = histogram_for(self.key)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            live, base = self._live, self._baseline
            out: Dict[str, Any] = {
                "key": self.key, "live": live.to_dict(),
                "baseline_round": self._baseline_round,
                "psi": None, "js": None,
            }
            if base is not None:
                p = psi(live, base)
                j = js_divergence(live, base)
                out["psi"] = None if p is None else round(p, 6)
                out["js"] = None if j is None else round(j, 6)
        return out
