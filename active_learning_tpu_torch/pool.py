"""Pool bookkeeping (the JAX package's ``pool.py``: ``bucket_size`` and
``PoolState``), host-pure numpy.

All randomness comes from an injected ``np.random.Generator``, drawn with
the same calls as the JAX package, so a run's picks and its saved state
match the reference's bit for bit at the same seeds.  The streaming
extensions of the JAX ``PoolState`` (growing the pool, invalid slots)
are not ported: every slot here holds a real example.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


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


@dataclasses.dataclass
class PoolState:
    """Boolean-mask view of the unlabeled pool: ``labeled`` marks
    labeled examples, ``eval_idxs`` the validation split (never
    queryable), ``recent`` the last update's indices."""

    n_pool: int
    labeled: np.ndarray
    eval_idxs: np.ndarray
    recent: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    cumulative_cost: float = 0.0
    round: int = 0

    @classmethod
    def create(cls, n_pool: int, eval_idxs: Sequence[int]) -> "PoolState":
        return cls(n_pool=int(n_pool), labeled=np.zeros(n_pool, dtype=bool),
                   eval_idxs=np.asarray(eval_idxs, dtype=np.int64))

    def available_mask(self) -> np.ndarray:
        """Queryable examples: unlabeled and not in the eval split."""
        mask = ~self.labeled
        if self.eval_idxs.size:
            mask[self.eval_idxs] = False
        return mask

    def available_query_idxs(self, shuffle: bool = True,
                             rng: Optional[np.random.Generator] = None
                             ) -> np.ndarray:
        idxs = np.flatnonzero(self.available_mask())
        if shuffle:
            if rng is None:
                raise ValueError("shuffle=True requires an explicit rng")
            idxs = rng.permutation(idxs)
        return idxs

    def labeled_idxs(self, shuffle: bool = False,
                     rng: Optional[np.random.Generator] = None
                     ) -> np.ndarray:
        idxs = np.flatnonzero(self.labeled)
        if shuffle:
            if rng is None:
                raise ValueError("shuffle=True requires an explicit rng")
            idxs = rng.permutation(idxs)
        return idxs

    def labeled_mask(self) -> np.ndarray:
        return self.labeled.copy()

    @property
    def num_labeled(self) -> int:
        return int(self.labeled.sum())

    @property
    def num_available(self) -> int:
        return int(self.available_mask().sum())

    def update(self, labeled_idxs: Sequence[int], cost: float) -> None:
        """Mark ``labeled_idxs`` labeled and spend ``cost``; refuses out
        of range, duplicate, already labeled and validation indices."""
        idxs = np.asarray(labeled_idxs, dtype=np.int64).reshape(-1)
        if idxs.size:
            if idxs.min() < 0 or idxs.max() >= self.n_pool:
                raise ValueError(f"indices out of range [0, {self.n_pool})")
            if np.unique(idxs).size != idxs.size:
                raise ValueError("query returned duplicate indices")
            if self.labeled[idxs].any():
                dup = idxs[self.labeled[idxs]][:10]
                raise ValueError(f"examples already labeled: {dup.tolist()}")
            if self.eval_idxs.size and np.isin(idxs, self.eval_idxs).any():
                raise ValueError("query returned validation indices")
            self.labeled[idxs] = True
        self.recent = idxs
        self.cumulative_cost += float(cost)

    def to_arrays(self) -> dict:
        """The ``experiment_state.npz`` arrays, with the JAX package's
        keys (``invalid`` all False: every slot is real here)."""
        return {
            "n_pool": np.asarray(self.n_pool),
            "labeled": self.labeled.copy(),
            "eval_idxs": self.eval_idxs.copy(),
            "recent": self.recent.copy(),
            "cumulative_cost": np.asarray(self.cumulative_cost),
            "round": np.asarray(self.round),
            "invalid": np.zeros(self.n_pool, dtype=bool),
        }

    @classmethod
    def from_arrays(cls, arrs: dict) -> "PoolState":
        """Inverse of ``to_arrays`` (either package's npz).  A pool with
        invalid slots (the JAX package's streaming pools) is refused."""
        n_pool = int(arrs["n_pool"])
        if "invalid" in arrs and np.asarray(arrs["invalid"]).any():
            raise ValueError("the saved pool has invalid (streaming) slots; "
                             "streaming pools are not ported (ROADMAP.md)")
        return cls(
            n_pool=n_pool,
            labeled=np.array(arrs["labeled"], dtype=bool, copy=True),
            eval_idxs=np.array(arrs["eval_idxs"], dtype=np.int64, copy=True),
            recent=np.array(arrs["recent"], dtype=np.int64, copy=True),
            cumulative_cost=float(arrs["cumulative_cost"]),
            round=int(arrs["round"]))
