"""Kernel E: the k-center distance fold, masked top-q, the batched
greedy's re-check and the D² draw (ROADMAP K4).

Replaces the JAX package's k-center device functions: the deleted Pallas
kernel ``ops/kcenter_pallas.py::fused_update_argmax`` and, at HEAD,
``strategies/scoring.py:45-61`` ``batched_min_dist_update``,
``strategies/kcenter.py:165-170`` ``_min_dist_chunk`` and the step bodies
of ``_kcenter_scan`` (:189-227) and ``_kcenter_scan_batched`` (:294-331)
with its re-check (:230-291).  The CUDA source is ``csrc/kcenter.cu``
(its header says what bounds each entry point).  Four wrappers, each
with its launch counter:

* ``fold_select`` — fold up to 8 centers into ``min_dist``, clear their
  ``selectable``, then the top-q of ``where(selectable > 0, min_dist,
  -inf)``, ties to the lower index (q = 1 is the argmax);
* ``batch_pass`` — one pass of the batched greedy on a ``BatchState``:
  fold the previous pass's accepted sequence, take the top q, re-check
  them on their ``[q, q]`` distances and write the accepted picks, their
  distances and the new pick count, all in device memory;
* ``fold_draw`` — fold up to 1 center, then the D² Gumbel-max draw;
* ``min_fold`` — fold any number of centers (the initial min), no reduce.

The pool is a tuple of one or two float32 factor matrices with equal row
counts; ``sqn`` holds each row's squared norm.  Each wrapper runs its
plain version on CPU tensors and the kernel on CUDA tensors; it updates
``min_dist`` and ``selectable`` in place either way.  Centers are int64
row indices on the pool's device, so a scan step's pick can be the next
step's center without the host.

Rows holding NaN or ±inf follow the reference on the kernel and in the
plain versions alike: the fold's min propagates NaN (``jnp.minimum`` of
``jnp.min``), the top-q ranks a NaN first, ties to the lower index
(``jnp.argmax``'s order, so the batched scan stays the q = 1 scan pick for
pick), and a NaN weight anywhere, a non-selectable row's included, makes
the D² draw uniform over the selectable rows (the reference's sum of the
weights is NaN, and ``NaN > 0`` is false).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..device import full_float32
from ..utils import threefry
from . import _build

Factors = Sequence[torch.Tensor]
Key = Tuple[int, int]

MAX_CENTERS = 8  # per fold_select call; fold_draw takes at most 1

# Launches of each entry point since the process started (or since a
# caller reset them).
select_launches = 0
batch_launches = 0
draw_launches = 0
min_fold_launches = 0


def reset_launches() -> None:
    global select_launches, batch_launches, draw_launches, min_fold_launches
    select_launches = batch_launches = draw_launches = min_fold_launches = 0


F32_EPS = 2.0 ** -23


def fold_tolerance(sqn: torch.Tensor, center_sqn_max: float,
                   depth: int) -> torch.Tensor:
    """How far two float32 evaluations of the fold may put a row's
    distance apart when they sum the dot products in other orders:
    2 * depth * eps * (sqn_i + max_c sqn_c), ``depth`` the summed feature
    count of the factors (each dot product's error is at most depth * eps
    times |g_i| |g_c| <= (sqn_i + sqn_c) / 2, and the fold doubles it).
    This is the bound kernel E is held to against its plain version."""
    return 2.0 * depth * F32_EPS * (sqn + center_sqn_max)


# -- plain versions -----------------------------------------------------------

def fold_reference(factors: Factors, sqn: torch.Tensor,
                   min_dist: torch.Tensor, centers: torch.Tensor,
                   selectable: Optional[torch.Tensor] = None) -> None:
    """min_dist <- min(min_dist, min_c ||g - g_c||²) over ``centers``, in
    float32 matrix products (TF32 off), and selectable[centers] <- 0."""
    if centers.numel() == 0:
        return
    with full_float32():
        prod = None
        for f in factors:
            d = f @ f[centers].T
            prod = d if prod is None else prod * d
    d = sqn[:, None] + sqn[centers][None, :] - 2.0 * prod
    torch.minimum(min_dist, d.min(dim=1).values, out=min_dist)
    if selectable is not None:
        selectable[centers] = 0.0


def top_q(values: torch.Tensor, q: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The q largest values, best first, ties to the lower index (the
    order of ``jax.lax.top_k``); a stable descending sort."""
    vals, idx = torch.sort(values, descending=True, stable=True)
    return vals[:q], idx[:q]


def fold_select_reference(factors: Factors, sqn: torch.Tensor,
                          min_dist: torch.Tensor, selectable: torch.Tensor,
                          centers: torch.Tensor, q: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    fold_reference(factors, sqn, min_dist, centers, selectable)
    masked = torch.where(selectable > 0, min_dist,
                         torch.full_like(min_dist, float("-inf")))
    return top_q(masked, q)


def fold_draw_reference(factors: Factors, sqn: torch.Tensor,
                        min_dist: torch.Tensor, selectable: torch.Tensor,
                        centers: torch.Tensor, key: Key
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weight p at the pick, pick): ``jax.random.categorical(key,
    log(weights))`` over the padded pool, with p = clip(min_dist, 0) *
    selectable and the weights p where it sums above 0, else selectable
    (the reference's uniform fallback when every unlabeled distance is
    0, or when a p is NaN)."""
    fold_reference(factors, sqn, min_dist, centers, selectable)
    p = torch.clamp(min_dist, min=0.0) * selectable
    w = torch.where(p.sum() > 0, p, selectable)
    g = threefry.gumbel(key, min_dist.shape[0], min_dist.device)
    idx = torch.argmax(g + torch.log(w))
    return p[idx], idx


def dots_between(factors: Factors, idxs: torch.Tensor) -> torch.Tensor:
    """g_i . g_j for i, j in idxs — [K, K], in float32 products (TF32
    off)."""
    out = None
    with full_float32():
        for f in factors:
            rows = f[idxs]
            d = rows @ rows.T
            out = d if out is None else out * d
    return out


def pair_dists_reference(factors: Factors, sqn: torch.Tensor,
                         rows: torch.Tensor) -> torch.Tensor:
    """[K, K] squared distances between ``rows``: (sqn_i + sqn_j) - 2 g_i .
    g_j, as the JAX package's ``pair_dists`` forms its re-check table."""
    return (sqn[rows][:, None] + sqn[rows][None, :]
            - 2.0 * dots_between(factors, rows))


def recheck_reference(cands: torch.Tensor, vals: torch.Tensor,
                      d_cc: torch.Tensor, limit, sentinel: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact in-batch acceptance over the top-q candidates (``cands``,
    ``vals`` best first, ties to the lower index; ``d_cc`` their [q, q]
    squared distances; at most ``limit`` accepted, an int or a 0-d
    tensor).  Returns (candidate positions in acceptance order [q], how
    many were accepted (a 0-d tensor), each accepted pick's distance at
    acceptance [q], zero past the accepted ones).  A candidate is
    accepted while its updated distance exceeds the q-th candidate's
    strictly: every row outside the batch started at or below that and
    only shrinks, so an accepted candidate is the q = 1 greedy's pick.
    Min, max and compare only: no rounding."""
    q = cands.shape[0]
    dev = vals.device
    thresh = vals[q - 1]
    ninf = torch.full((), float("-inf"), device=dev)
    cur = vals.clone()
    accepted = torch.zeros(q, dtype=torch.bool, device=dev)
    accepted[0] = True
    order = torch.zeros(q, dtype=torch.int64, device=dev)
    dvals = torch.zeros(q, dtype=vals.dtype, device=dev)
    dvals[0] = vals[0]
    n_acc = torch.ones((), dtype=torch.int64, device=dev)
    last = torch.zeros((), dtype=torch.int64, device=dev)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    slot = torch.arange(q, device=dev)
    sentinel_t = torch.full((), sentinel, dtype=cands.dtype, device=dev)
    for _ in range(q - 1):
        cur = torch.minimum(cur, d_cc[:, last])
        avail = torch.where(accepted, ninf, cur)
        m = avail.max()
        # Lowest pool index among the in-batch maxima: the q = 1
        # argmax's tie-break.
        p = torch.argmin(torch.where(avail >= m, cands, sentinel_t))
        # Strictly above the threshold: at equality a row outside the
        # batch could tie and win by index, so stop and re-rank the pool.
        ok = (m > thresh) & ~stop & (n_acc < limit)
        accepted = accepted | ((slot == p) & ok)
        order = torch.where(ok & (slot == n_acc), p, order)
        dvals = torch.where(ok & (slot == n_acc), m, dvals)
        last = torch.where(ok, p, last)
        n_acc = n_acc + ok.to(torch.int64)
        stop = stop | ~ok
    return order, n_acc, dvals


class BatchState:
    """What one batched scan keeps in device memory from pass to pass:
    the accepted sequence of the last pass (``seq``, the next pass's
    centers), the pick count (``count``, int32), the picks and their
    distances (``picks``, ``dists``: [budget + q], the last pass's padded
    writes land in the tail), the last pass's top q (``top_v``,
    ``top_i``) and the kernel's candidate scratch, all allocated once
    per scan.  ``passes`` counts the passes run on it."""

    def __init__(self, n: int, budget: int, q: int, device):
        if not 1 <= q <= MAX_CENTERS:
            raise ValueError(f"q must be in 1..{MAX_CENTERS}, got {q}")
        dev = torch.device(device)
        self.n, self.budget, self.q = n, budget, q
        self.seq = torch.zeros(q, dtype=torch.int64, device=dev)
        self.count = torch.zeros(1, dtype=torch.int32, device=dev)
        self.picks = torch.zeros(budget + q, dtype=torch.int64, device=dev)
        self.dists = torch.zeros(budget + q, dtype=torch.float32, device=dev)
        self.top_v = torch.zeros(q, dtype=torch.float32, device=dev)
        self.top_i = torch.zeros(q, dtype=torch.int64, device=dev)
        self.scratch = Scratch(n, dev) if dev.type == "cuda" else None
        self.passes = 0

    def clone(self) -> "BatchState":
        out = BatchState.__new__(BatchState)
        out.__dict__.update(self.__dict__)
        for k in ("seq", "count", "picks", "dists", "top_v", "top_i"):
            setattr(out, k, getattr(self, k).clone())
        out.scratch = (Scratch(self.n, self.seq.device)
                       if self.scratch is not None else None)
        return out


def batch_pass_reference(factors: Factors, sqn: torch.Tensor,
                         min_dist: torch.Tensor, selectable: torch.Tensor,
                         state: BatchState) -> None:
    """One pass of the batched greedy (the JAX package's
    ``_kcenter_scan_batched`` loop body): unless ``count`` has reached
    the budget, fold the last pass's sequence (none on the first pass),
    take the masked top q, re-check them, and write the padded accepted
    sequence (unaccepted slots repeat the first pick) and its distances
    at ``picks[count:]``, ``dists[count:]``, then advance ``count``.
    Reads ``count`` on the host: the plain version syncs where the
    kernel does not."""
    count = int(state.count[0])
    if count >= state.budget:
        return
    q = state.q
    centers = state.seq if state.passes else state.seq[:0]
    vals, cands = fold_select_reference(factors, sqn, min_dist, selectable,
                                        centers, q)
    order, n_acc, dseq = recheck_reference(
        cands, vals, pair_dists_reference(factors, sqn, cands),
        min(q, state.budget - count), state.n)
    slot = torch.arange(q, device=vals.device)
    seq = torch.where(slot < n_acc, cands[order], cands[order[0]])
    state.seq.copy_(seq)
    state.picks[count:count + q] = seq
    state.dists[count:count + q] = dseq
    state.top_v.copy_(vals)
    state.top_i.copy_(cands)
    state.count += n_acc.to(torch.int32)


# -- the kernel ---------------------------------------------------------------

def _check(factors: Factors, sqn: torch.Tensor, min_dist: torch.Tensor,
           selectable: Optional[torch.Tensor], centers: torch.Tensor,
           max_centers: Optional[int]) -> None:
    if not 1 <= len(factors) <= 2:
        raise ValueError(f"one or two factor matrices, got {len(factors)}")
    n = sqn.shape[0]
    vecs = [sqn, min_dist] + ([selectable] if selectable is not None else [])
    for t in list(factors) + vecs:
        if t.dtype != torch.float32:
            raise TypeError(f"kcenter: float32 tensors only, got {t.dtype}")
        if t.device != sqn.device:
            raise ValueError("kcenter: every tensor on one device")
    for f in factors:
        if f.ndim != 2 or f.shape[0] != n:
            raise ValueError(f"factor {tuple(f.shape)} does not have the "
                             f"pool's {n} rows")
    if any(v.shape != (n,) for v in vecs):
        raise ValueError("sqn, min_dist and selectable must be [N]")
    if centers.dtype != torch.int64 or centers.ndim != 1:
        raise TypeError("centers must be a 1-D int64 tensor")
    if centers.device != sqn.device:
        raise ValueError("centers must lie on the pool's device")
    if max_centers is not None and centers.numel() > max_centers:
        raise ValueError(f"at most {max_centers} centers, got "
                         f"{centers.numel()}")


def _cuda_args(factors: Factors, sqn, min_dist, selectable, centers,
               n_centers: int):
    for t in list(factors) + [sqn, min_dist, centers] + (
            [selectable] if selectable is not None else []):
        if t.device.type != "cuda":
            raise ValueError(f"kcenter: unsupported device {t.device}")
        if not t.is_contiguous():
            raise ValueError("kcenter: tensors must be contiguous")
    f1 = factors[0]
    f2 = factors[1] if len(factors) == 2 else None
    d1, d2 = f1.shape[1], (f2.shape[1] if f2 is not None else 0)
    if selectable is not None:
        lib = _lib()
        need, limit = lib.kc_fold_smem(n_centers, d1, d2), lib.kc_smem_limit()
        if need > limit:
            raise ValueError(f"kcenter: {n_centers} centers of {d1}+{d2} "
                             f"features need {need} bytes of shared memory, "
                             f"over the fold's {limit}")
    return (f1.data_ptr(), d1, f2.data_ptr() if f2 is not None else None,
            d2, sqn.shape[0])


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


class Scratch:
    """The fold's per-block candidates (values, rows, draw weights):
    allocated once per scan and reused by every pass over the pool."""

    def __init__(self, n: int, device):
        blocks = _lib().kc_fold_blocks(n)
        self.n = n
        self.v = torch.empty(blocks * MAX_CENTERS, dtype=torch.float32,
                             device=device)
        self.i = torch.empty(blocks * MAX_CENTERS, dtype=torch.int32,
                             device=device)
        self.p = torch.empty(2 * blocks, dtype=torch.float32, device=device)


def _scratch(scratch: Optional[Scratch], n: int, device) -> Scratch:
    if scratch is None:
        return Scratch(n, device)
    if scratch.n != n or scratch.v.device != device:
        raise ValueError(f"kcenter: scratch for {scratch.n} rows on "
                         f"{scratch.v.device}, pool of {n} on {device}")
    return scratch


def fold_select(factors: Factors, sqn: torch.Tensor, min_dist: torch.Tensor,
                selectable: torch.Tensor, centers: torch.Tensor, q: int,
                out_vals: Optional[torch.Tensor] = None,
                out_idx: Optional[torch.Tensor] = None,
                scratch: Optional[Scratch] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold ``centers`` (at most 8) and return the masked top-q as
    (values float32 [q], rows int64 [q]), written into ``out_vals`` /
    ``out_idx`` when given.  ``scratch``: the kernel's candidate buffers
    (made per call when None)."""
    global select_launches
    _check(factors, sqn, min_dist, selectable, centers, MAX_CENTERS)
    if not 1 <= q <= MAX_CENTERS:
        raise ValueError(f"q must be in 1..{MAX_CENTERS}, got {q}")
    if sqn.device.type == "cpu":
        vals, idx = fold_select_reference(factors, sqn, min_dist, selectable,
                                          centers, q)
        if out_vals is not None:
            out_vals.copy_(vals)
            out_idx.copy_(idx)
            return out_vals, out_idx
        return vals, idx
    ptrs = _cuda_args(factors, sqn, min_dist, selectable, centers,
                      centers.numel())
    dev = sqn.device
    sc = _scratch(scratch, sqn.shape[0], dev)
    if out_vals is None:
        out_vals = torch.empty(q, dtype=torch.float32, device=dev)
        out_idx = torch.empty(q, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _lib().kc_fold_select(
            *ptrs, sqn.data_ptr(), min_dist.data_ptr(), selectable.data_ptr(),
            centers.data_ptr(), centers.numel(), q, sc.v.data_ptr(),
            sc.i.data_ptr(), out_vals.data_ptr(), out_idx.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "kcenter fold_select")
    select_launches += 1
    return out_vals, out_idx


def batch_pass(factors: Factors, sqn: torch.Tensor, min_dist: torch.Tensor,
               selectable: torch.Tensor, state: BatchState) -> None:
    """One pass of the batched greedy on ``state`` (see
    ``batch_pass_reference``): on the card one fold launch and one
    merge launch, reading and writing the sequence and the pick count in
    device memory; no host sync."""
    global batch_launches
    seq = state.seq
    _check(factors, sqn, min_dist, selectable, seq, MAX_CENTERS)
    if state.n != sqn.shape[0]:
        raise ValueError(f"kcenter: a state for {state.n} rows, a pool of "
                         f"{sqn.shape[0]}")
    if sqn.device.type == "cpu":
        batch_pass_reference(factors, sqn, min_dist, selectable, state)
        state.passes += 1
        return
    nc = state.q if state.passes else 0
    ptrs = _cuda_args(factors, sqn, min_dist, selectable, seq, state.q)
    for t in (state.count, state.picks, state.dists, state.top_v,
              state.top_i):
        if t.device != sqn.device:
            raise ValueError("kcenter: the scan state must lie on the "
                             "pool's device")
    sc = _scratch(state.scratch, sqn.shape[0], sqn.device)
    with torch.cuda.device(sqn.device):
        err = _lib().kc_batch_pass(
            *ptrs, sqn.data_ptr(), min_dist.data_ptr(), selectable.data_ptr(),
            seq.data_ptr(), nc, state.q, state.budget,
            state.count.data_ptr(), sc.v.data_ptr(), sc.i.data_ptr(),
            state.picks.data_ptr(), state.dists.data_ptr(),
            state.top_v.data_ptr(), state.top_i.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "kcenter batch_pass")
    state.passes += 1
    batch_launches += 1


def fold_draw(factors: Factors, sqn: torch.Tensor, min_dist: torch.Tensor,
              selectable: torch.Tensor, centers: torch.Tensor, key: Key,
              out_val: torch.Tensor, out_idx: torch.Tensor,
              scratch: Optional[Scratch] = None) -> None:
    """Fold ``centers`` (at most 1), then draw one row with D² weights
    under the Threefry key ``key``: its row into ``out_idx[0]`` (int64),
    its weight p into ``out_val[0]``."""
    global draw_launches
    _check(factors, sqn, min_dist, selectable, centers, 1)
    if sqn.device.type == "cpu":
        val, idx = fold_draw_reference(factors, sqn, min_dist, selectable,
                                       centers, key)
        out_val.copy_(val.reshape(1))
        out_idx.copy_(idx.reshape(1))
        return
    ptrs = _cuda_args(factors, sqn, min_dist, selectable, centers,
                      centers.numel())
    dev = sqn.device
    sc = _scratch(scratch, sqn.shape[0], dev)
    with torch.cuda.device(dev):
        err = _lib().kc_fold_draw(
            *ptrs, sqn.data_ptr(), min_dist.data_ptr(), selectable.data_ptr(),
            centers.data_ptr(), centers.numel(), int(key[0]), int(key[1]),
            sc.v.data_ptr(), sc.i.data_ptr(), sc.p.data_ptr(),
            out_val.data_ptr(), out_idx.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "kcenter fold_draw")
    draw_launches += 1


def min_fold(factors: Factors, sqn: torch.Tensor, min_dist: torch.Tensor,
             centers: torch.Tensor) -> None:
    """Fold every row of ``centers`` into ``min_dist``."""
    global min_fold_launches
    _check(factors, sqn, min_dist, None, centers, None)
    if centers.numel() == 0:
        return
    if sqn.device.type == "cpu":
        fold_reference(factors, sqn, min_dist, centers)
        return
    ptrs = _cuda_args(factors, sqn, min_dist, None, centers, 0)
    with torch.cuda.device(sqn.device):
        err = _lib().kc_min_fold(*ptrs, sqn.data_ptr(), min_dist.data_ptr(),
                                 centers.data_ptr(), centers.numel(),
                                 torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "kcenter min_fold")
    min_fold_launches += 1


def random_bits(key: Key, n: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's own random bits (int64 holding uint32) and Gumbel
    noise for rows 0..n-1 under ``key``: what the draw adds to
    log(weights).  For checking the kernel against ``utils/threefry``."""
    bits = torch.empty(n, dtype=torch.int32, device=device)
    gum = torch.empty(n, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _lib().kc_random_bits(int(key[0]), int(key[1]), n,
                                    bits.data_ptr(), gum.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "kcenter random_bits")
    return bits.to(torch.int64) & 0xFFFFFFFF, gum


_lib_handle = None


def _lib():
    """The C entry points, built and bound at first use."""
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("kcenter")
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.kc_fold_select.argtypes = [p, i, p, i, i, p, p, p, p, i, i, p, p,
                                       p, p, p]
        lib.kc_batch_pass.argtypes = [p, i, p, i, i, p, p, p, p, i, i, i, p,
                                      p, p, p, p, p, p, p]
        lib.kc_fold_smem.argtypes = [i, i, i]
        lib.kc_smem_limit.argtypes = []
        lib.kc_fold_draw.argtypes = [p, i, p, i, i, p, p, p, p, i, u, u, p, p,
                                     p, p, p, p]
        lib.kc_min_fold.argtypes = [p, i, p, i, i, p, p, p, i, p]
        lib.kc_fold_blocks.argtypes = [i]
        lib.kc_random_bits.argtypes = [u, u, i, p, p, p]
        for fn in (lib.kc_fold_select, lib.kc_batch_pass, lib.kc_fold_draw,
                   lib.kc_min_fold, lib.kc_fold_blocks, lib.kc_fold_smem,
                   lib.kc_smem_limit, lib.kc_random_bits):
            fn.restype = ctypes.c_int
        _lib_handle = lib
    return _lib_handle
