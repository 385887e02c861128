"""Greedy k-center and its randomized (k-means++ D²) variant: the
single-device half of the JAX package's ``strategies/kcenter.py``, the
sequential core of Coreset and BADGE acquisition.

The pool is a tuple of factor matrices (one, ``X [N, D]``, for Coreset;
two, ``A [N, C]`` and ``E [N, D]``, for BADGE's rank-1 gradient
embeddings, whose dot product is ``(A_i . A_j)(E_i . E_j)``), a length-N
min-distance vector and a selectable mask, all on one device.  The
distance fold, the masked top-q and the D² draw are kernel E
(``ops/kcenter.py``); what surrounds them is the JAX package's logic,
step for step:

* deterministic selection runs batched: the top-q provisional picks,
  an exact in-batch re-check on their ``[q, q]`` distance table, and one
  fold of the accepted picks, all inside kernel E's ``batch_pass``; the
  pick sequence is the q = 1 greedy's.  The pick count stays in device
  memory, so the host reads it once per round of passes, not per pass
  (``max_host_syncs`` bounds the rounds);
* the randomized mode draws one pick per step with the JAX package's
  Threefry keys (``utils/threefry.py``): ``rng.integers(2**31)`` seeds
  the key before any other draw, ``split(key, budget)`` gives one key a
  step, and each step's Gumbel noise covers the padded pool.  Its picks
  stay on the device from step to step: no host sync until the end;
* pools are padded to ``bucket_size(n, 256)`` rows (zero factors, never
  selectable), as the JAX package pads them, since the padded length is
  the Gumbel draw's length;
* distances are squared L2 throughout.

Left out (ROADMAP.md): the row-sharded multi-device backend
(``--pool_sharding``) and the pick-distance diagnostics layer;
``LAST_PICK_DISTS`` still records each pick's distance.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import full_float32, resolve_device
from ..ops import kcenter as kc
# The JAX module's name for the re-check table's products.
from ..ops.kcenter import dots_between  # noqa: F401
# The JAX module's name for BADGE's pooling matrix; it lives with kernel G.
from ..ops.badge import adaptive_avg_pool_matrix  # noqa: F401
from ..pool import bucket_size
from ..utils import threefry

Factors = Tuple[torch.Tensor, ...]

# Each pick's squared distance to (labeled ∪ earlier picks) at pick time,
# float32, aligned with the last kcenter_greedy call's return; NaN marks
# the seed row picked when nothing is labeled.
LAST_PICK_DISTS: Optional[np.ndarray] = None

# What the last kcenter_greedy call cost: pool passes (kernel E launches
# that read the whole factor matrix) and host syncs inside the scan.
LAST_SCAN: Dict[str, int] = {}

# Picks folded per pool pass in the deterministic greedy; the exact
# re-check keeps the sequence equal to q = 1.  ExperimentConfig.
# kcenter_batch overrides it.
DEFAULT_BATCH_Q = 8

# Pools are padded to the enclosing geometric bucket (at least this many
# rows); padded rows are zero factors that are never selectable.
POOL_BUCKET_FLOOR = 256

# Labeled centers per initial-min pass.
MIN_CHUNK = 1024


def self_sq_norms(factors: Factors) -> torch.Tensor:
    """||g_i||² = prod_F (F_i . F_i)  — [N]."""
    out = None
    for f in factors:
        s = torch.sum(f * f, dim=1)
        out = s if out is None else out * s
    return out


def dots_to(factors: Factors, idx: int) -> torch.Tensor:
    """g_. . g_idx  — [N]."""
    out = None
    with full_float32():
        for f in factors:
            d = f @ f[idx]
            out = d if out is None else out * d
    return out


def dots_to_many(factors: Factors, idxs: torch.Tensor) -> torch.Tensor:
    """g_. . g_j for j in idxs  — [N, K]."""
    out = None
    with full_float32():
        for f in factors:
            d = f @ f[idxs].T
            out = d if out is None else out * d
    return out


def min_sq_dist_to(factors: Factors, sqn: torch.Tensor,
                   labeled_idxs: np.ndarray,
                   chunk_size: int = MIN_CHUNK) -> torch.Tensor:
    """min over labeled j of ||g_i - g_j||² for every row i, folding
    ``chunk_size`` labeled centers per pass (kernel E's ``min_fold``)."""
    min_dist = torch.full((sqn.shape[0],), float("inf"),
                          dtype=torch.float32, device=sqn.device)
    labeled = torch.as_tensor(np.asarray(labeled_idxs, dtype=np.int64),
                              device=sqn.device)
    for start in range(0, labeled.numel(), chunk_size):
        kc.min_fold(factors, sqn, min_dist,
                    labeled[start:start + chunk_size])
    return min_dist


def _minimax_row(factors: Factors, sqn: torch.Tensor,
                 block: int = 2048) -> int:
    """argmin_i max_j ||g_i - g_j||²: the reference's deterministic seed
    when nothing is labeled, in column blocks (plain float32 products)."""
    n = sqn.shape[0]
    pad = (-n) % block
    order = torch.arange(n + pad, device=sqn.device) % n
    row_max = torch.full((n,), float("-inf"), device=sqn.device)
    for cols in order.reshape(-1, block):
        d = sqn[:, None] + sqn[cols][None, :] - 2.0 * dots_to_many(factors,
                                                                   cols)
        row_max = torch.maximum(row_max, d.max(dim=1).values)
    return int(torch.argmin(row_max))


def max_host_syncs(budget: int, q: int) -> int:
    """The most host syncs the batched scan can take for ``budget`` picks
    at ``q`` a pass: each round queues ceil(left / q) passes, each of
    which accepts at least one pick, so a round leaves at most left -
    ceil(left / q).  (About 5-10 rounds in practice: a pass accepts most
    of its q.)"""
    left, rounds = budget, 0
    while left > 0:
        left -= -(-left // q)
        rounds += 1
    return rounds


def _kcenter_scan(factors: Factors, sqn: torch.Tensor,
                  min_dist: torch.Tensor, selectable: torch.Tensor,
                  budget: int, randomize: bool, key: threefry.Key
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The q = 1 greedy, one fold + pick per step: the argmax of the
    masked distances, or with ``randomize`` the D² draw under
    ``split(key, budget)[step]``.  Each step folds the previous step's
    pick, read from device memory."""
    dev = sqn.device
    keys = threefry.split(key, budget)
    picks = torch.zeros(budget, dtype=torch.int64, device=dev)
    dists = torch.zeros(budget, dtype=torch.float32, device=dev)
    no_center = torch.zeros(0, dtype=torch.int64, device=dev)
    scratch = kc.Scratch(sqn.shape[0], dev) if dev.type == "cuda" else None
    for i in range(budget):
        center = picks[i - 1:i] if i else no_center
        if randomize:
            kc.fold_draw(factors, sqn, min_dist, selectable, center,
                         (int(keys[i, 0]), int(keys[i, 1])),
                         dists[i:i + 1], picks[i:i + 1], scratch=scratch)
        else:
            kc.fold_select(factors, sqn, min_dist, selectable, center, 1,
                           dists[i:i + 1], picks[i:i + 1], scratch=scratch)
    LAST_SCAN.update(pool_passes=budget, host_syncs=0)
    return picks, dists


def _kcenter_scan_batched(factors: Factors, sqn: torch.Tensor,
                          min_dist: torch.Tensor, selectable: torch.Tensor,
                          budget: int, q: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched deterministic greedy: each pass folds the previous pass's
    accepted picks, ranks the pool's top q and accepts a prefix of them
    after the exact re-check (kernel E's ``batch_pass``, which keeps the
    pick count in device memory).  A pass accepts 1 to q picks, so
    ceil(left / q) more passes are always needed: the host queues that
    many, then reads the count once.  Pick for pick the q = 1 scan."""
    state = kc.BatchState(sqn.shape[0], budget, q, sqn.device)
    known = syncs = 0
    while known < budget:
        for _ in range(-(-(budget - known) // q)):
            kc.batch_pass(factors, sqn, min_dist, selectable, state)
        known = int(state.count[0])  # the round's host sync
        syncs += 1
    LAST_SCAN.update(pool_passes=state.passes, host_syncs=syncs)
    return state.picks[:budget], state.dists[:budget]


def _record_picks(picks: np.ndarray, dists: Optional[torch.Tensor],
                  n_seed: int) -> np.ndarray:
    global LAST_PICK_DISTS
    tail = (np.zeros(0, dtype=np.float32) if dists is None
            else dists.cpu().numpy().astype(np.float32))
    LAST_PICK_DISTS = np.concatenate(
        [np.full(n_seed, np.nan, dtype=np.float32), tail])
    return picks


def _to_f32(f, device: torch.device) -> torch.Tensor:
    if isinstance(f, torch.Tensor):
        return f.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(f, dtype=np.float32)
                            ).to(device)


def kcenter_greedy(factors: Sequence, labeled_mask: np.ndarray, budget: int,
                   randomize: bool = False,
                   rng: Optional[np.random.Generator] = None,
                   batch_q: Optional[int] = None, device=None) -> np.ndarray:
    """Select ``budget`` row indices of the pool by greedy k-center over
    the factorized embeddings (the reference's coreset loop): the
    farthest row from (labeled ∪ picks so far) each step, ``batch_q``
    picks per pool pass; or with ``randomize`` a D² draw per step.
    ``factors`` are numpy arrays or tensors; ``device`` (default: a
    tensor's own device, else the card) is where the selection runs.
    Returns the picks in pick order."""
    labeled_mask = np.asarray(labeled_mask, dtype=bool)
    n = labeled_mask.shape[0]
    budget = int(budget)
    LAST_SCAN.clear()
    if budget <= 0:
        return _record_picks(np.zeros(0, dtype=np.int64), None, 0)
    if rng is None:
        rng = np.random.default_rng()
    key = threefry.prng_key(int(rng.integers(2 ** 31)))
    q = 1 if randomize else int(batch_q or DEFAULT_BATCH_Q)
    if device is None:
        tensors = [f for f in factors if isinstance(f, torch.Tensor)]
        device = tensors[0].device if tensors else None
    device = resolve_device(device)

    factors = tuple(_to_f32(f, device) for f in factors)
    sqn = self_sq_norms(factors)
    labeled_idxs = np.flatnonzero(labeled_mask)
    picks_pre: list = []
    if len(labeled_idxs) == 0:
        # The reference's seed: uniform when randomized, else the minimax
        # row (over the unpadded pool: a zero pad row could win it).
        if randomize:
            seed_idx = int(rng.integers(n))
        else:
            seed_idx = _minimax_row(factors, sqn)
        picks_pre.append(seed_idx)
        labeled_idxs = np.asarray([seed_idx])
        budget -= 1
    if budget <= 0:
        return _record_picks(np.asarray(picks_pre, dtype=np.int64), None,
                             len(picks_pre))
    q = max(1, min(q, budget))

    n_pad = bucket_size(n, floor=POOL_BUCKET_FLOOR)
    pad = n_pad - n
    if pad:
        factors = tuple(F.pad(f, (0, 0, 0, pad)) for f in factors)
        sqn = F.pad(sqn, (0, pad))
    min_dist = min_sq_dist_to(factors, sqn, labeled_idxs)
    selectable = np.zeros(n_pad, dtype=np.float32)
    selectable[:n] = 1.0
    selectable[labeled_idxs] = 0.0
    sel = torch.from_numpy(selectable).to(device)

    if q > 1:
        picks, dists = _kcenter_scan_batched(factors, sqn, min_dist, sel,
                                             budget, q)
    else:
        picks, dists = _kcenter_scan(factors, sqn, min_dist, sel, budget,
                                     bool(randomize), key)
    LAST_SCAN["pool_passes"] += -(-len(labeled_idxs) // MIN_CHUNK)
    picks = picks.cpu().numpy().astype(np.int64)
    return _record_picks(
        np.concatenate([np.asarray(picks_pre, dtype=np.int64), picks]),
        dists, len(picks_pre))
