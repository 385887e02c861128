"""Kernel H: the balancing pick of ``BalancingSampler`` (ROADMAP K6).

Replaces the JAX package's ``strategies/balancing.py:61-85``
``_balancing_pick``.  The CUDA source is ``csrc/balancing.cu`` (its
header says what bounds it and how it is laid out).  The pick is the
index of the least score ``d_rare / norm`` over the eligible rows,
where

* ``d_rare`` is the squared distance to the rarest class's centroid in
  the difference form, 1 when that class has no labeled row;
* ``norm`` is the largest squared distance to a majority centroid in the
  expanded form ``(a2 + b2) - 2·e·c`` (not clamped at 0);
* ineligible rows score +inf; ties go to the lower index and a NaN wins,
  as ``jnp.argmin`` has it.

Two entry points, one launch counter (``launches``, one a pick) and
the kernels those picks launched (``kernel_launches``, counted by the C
entry where it launches them; at most two a pick):

* ``BalancingState``: the sampler's loop.  It holds the pool, the
  eligibility mask, the class centers and the kernel's workspace on the
  device; ``take`` queues the loop's update on the host, and ``pick``
  sends the queue and the majority mask in one copy of a pinned block,
  launches the update and the fold, and waits once for the row.
* ``balancing_pick``: one pick from tensors through a one-shot state
  (the row as a 0-d int64 tensor on the pool's device).

On CPU tensors both run the plain version with the same semantics; on
CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import full_float32
from . import _build

# Picks the kernel made, and the kernels they launched, since the
# process started (or since a caller reset them).
launches = 0
kernel_launches = 0

F32_EPS = 2.0 ** -23


def _check(emb: torch.Tensor, eligible: torch.Tensor, centers: torch.Tensor,
           maj: torch.Tensor, rarest: int) -> None:
    if emb.ndim != 2 or centers.ndim != 2 or emb.shape[1] != centers.shape[1]:
        raise ValueError(f"emb [N, D] and centers [C, D] expected, got "
                         f"{tuple(emb.shape)} and {tuple(centers.shape)}")
    n, c = emb.shape[0], centers.shape[0]
    if emb.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError("balancing_pick: emb and centers must be float32")
    if eligible.shape != (n,) or eligible.dtype != torch.bool:
        raise ValueError(f"eligible must be a bool [{n}]")
    if maj.shape != (c,) or maj.dtype != torch.bool:
        raise ValueError(f"maj must be a bool [{c}]")
    if not 0 <= rarest < c:
        raise ValueError(f"rarest {rarest} is not a class of {c}")
    if n == 0 or n >= 2 ** 31:
        raise ValueError(f"balancing_pick takes 1 to 2**31 - 1 rows, got {n}")
    for t in (eligible, centers, maj):
        if t.device != emb.device:
            raise ValueError("balancing_pick: every tensor on one device")


def balancing_scores_reference(emb: torch.Tensor, eligible: torch.Tensor,
                               centers: torch.Tensor, maj: torch.Tensor,
                               rarest: int, rare_empty: bool
                               ) -> torch.Tensor:
    """Every row's score: the JAX function's formula in torch, float32
    matrix products in full float32 (TF32 off)."""
    d_rare = ((emb - centers[rarest][None, :]) ** 2).sum(dim=1)
    if rare_empty:
        d_rare = torch.ones_like(d_rare)
    a2 = (emb ** 2).sum(dim=1, keepdim=True)
    b2 = (centers ** 2).sum(dim=1)[None, :]
    with full_float32():
        d_all = a2 + b2 - 2.0 * (emb @ centers.T)
    d_maj = torch.where(maj[None, :], d_all,
                        torch.full_like(d_all, float("-inf")))
    norm = d_maj.max(dim=1).values
    return torch.where(eligible, d_rare / norm,
                       torch.full_like(d_rare, float("inf")))


def balancing_pick_reference(emb: torch.Tensor, eligible: torch.Tensor,
                             centers: torch.Tensor, maj: torch.Tensor,
                             rarest: int, rare_empty: bool) -> torch.Tensor:
    """The plain version: the argmin of ``balancing_scores_reference``
    (torch's argmin, like jnp's, takes the first minimum and lets the
    first NaN win)."""
    return torch.argmin(balancing_scores_reference(
        emb, eligible, centers, maj, rarest, rare_empty))


def score_tolerance(emb: torch.Tensor, centers: torch.Tensor,
                    maj: torch.Tensor, rarest: int,
                    rare_empty: bool) -> torch.Tensor:
    """Per row, how far two float32 evaluations of the score in other
    summation orders may lie apart: |score| (2·D·eps + 2·δ/|norm|) with
    δ = 2·(D + 2)·eps·(a2 + max b2) the expanded norm's error bound (each
    of a2, b2 and the dot product is a D-term sum, off by at most D·eps
    times its terms' magnitude, and |2·e·c| <= a2 + b2).  The numerator
    is a sum of D squares, off by at most D·eps relative.  Float64 on
    the inputs' device; +inf where the norm is 0."""
    e64, c64 = emb.to(torch.float64), centers.to(torch.float64)
    d = emb.shape[1]
    d_rare = ((e64 - c64[rarest][None, :]) ** 2).sum(dim=1)
    if rare_empty:
        d_rare = torch.ones_like(d_rare)
    a2 = (e64 ** 2).sum(dim=1)
    b2 = (c64 ** 2).sum(dim=1)
    d_all = a2[:, None] + b2[None, :] - 2.0 * (e64 @ c64.T)
    norm = torch.where(maj[None, :], d_all,
                       torch.full_like(d_all, float("-inf"))
                       ).max(dim=1).values
    b2max = b2[maj].max() if bool(maj.any()) else b2.new_zeros(())
    delta = 2.0 * (d + 2) * F32_EPS * (a2 + b2max)
    score = (d_rare / norm).abs()
    return score * (2.0 * d * F32_EPS + 2.0 * delta / norm.abs())


def _launch_error(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"balancing pick kernel launch failed: CUDA "
                           f"error {err}")


def _raw_stream(dev: int) -> int:
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(dev)
    return torch.cuda.current_stream(dev).cuda_stream


def balancing_pick(emb: torch.Tensor, eligible: torch.Tensor,
                   centers: torch.Tensor, maj: torch.Tensor, rarest: int,
                   rare_empty: bool) -> torch.Tensor:
    """The pool row the balancing branch picks (0-d int64 on ``emb``'s
    device): ``emb`` float32 [N, D], ``eligible`` bool [N], ``centers``
    float32 [C, D], ``maj`` bool [C] (the majority classes), ``rarest``
    the rarest class, ``rare_empty`` whether it has no labeled row.  On
    the card: one pick of a ``BalancingState`` built for this call (every
    center's b2, the majority list, then the fold)."""
    rarest, rare_empty = int(rarest), bool(rare_empty)
    _check(emb, eligible, centers, maj, rarest)
    if emb.device.type == "cpu":
        return balancing_pick_reference(emb, eligible, centers, maj, rarest,
                                        rare_empty)
    state = BalancingState(emb, eligible, centers)
    try:
        row = state.pick(maj.cpu().numpy(), rarest, rare_empty)
    finally:
        state.close()
    return torch.tensor(row, dtype=torch.int64, device=emb.device)


class _BalState(ctypes.Structure):
    """csrc/balancing.cu ``BalState``, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "emb", "eligible", "centers", "b2", "maj_idx", "n_maj", "keys",
        "ticket", "blk", "host_blk", "out", "host_out", "event")] + [
        (name, ctypes.c_int) for name in ("n", "d", "c", "launched")]


# The pinned block: the result slot, then the per-pick block at _BLK.
_BLK = 64


def _align16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


class BalancingState:
    """The balancing loop's state: the pool ``emb`` float32 [N, D], the
    eligibility mask ``eligible`` bool [N] and the class centers
    ``centers`` float32 [C, D], all on one device; ``eligible`` and
    ``centers`` are updated in place.

    ``take(row, cls, center_row)`` queues one pick of either branch: the
    row leaves the eligible set and class ``cls``'s center becomes
    ``center_row`` (the loop's float64 mean, rounded to float32).
    ``pick(maj, rarest, rare_empty)`` applies the queue and returns the
    row the balancing branch picks (a Python int).

    On the card the state keeps every center's squared norm (small C),
    the majority list, the block keys and a completion ticket in device
    memory, and a pinned block for the per-pick inputs and the result: a
    pick is one copy of that block, the update kernel and the fold (one
    ctypes call) and one wait on an event.  On the CPU ``pick`` is
    ``pick_reference``: the queue applied with torch ops, then the plain
    version."""

    def __init__(self, emb: torch.Tensor, eligible: torch.Tensor,
                 centers: torch.Tensor):
        c = centers.shape[0] if centers.ndim == 2 else 0
        _check(emb, eligible, centers, torch.zeros(
            c, dtype=torch.bool, device=emb.device), 0)
        for t in (emb, eligible, centers):
            if not t.is_contiguous():
                raise ValueError("BalancingState: tensors must be "
                                 "contiguous")
        self.emb, self.eligible, self.centers = emb, eligible, centers
        self.n, self.d = emb.shape
        self.c = c
        self._rows: Dict[int, None] = {}
        self._cls: Dict[int, np.ndarray] = {}
        self._full = True  # every center's b2 still to compute
        self._host = None
        if emb.device.type == "cuda":
            self._init_device()
        elif emb.device.type != "cpu":
            raise ValueError(f"BalancingState: unsupported device "
                             f"{emb.device}")

    def _init_device(self) -> None:
        lib = self._lib = _lib()
        dev, n, c, d = self.emb.device, self.n, self.c, self.d
        self._dev = self.emb.get_device()
        with torch.cuda.device(self._dev):
            self._b2 = torch.empty(c, dtype=torch.float32, device=dev)
            self._maj_idx = torch.empty(c, dtype=torch.int32, device=dev)
            self._n_maj = torch.zeros(1, dtype=torch.int32, device=dev)
            self._keys = torch.empty(lib.bal_key_slots(n),
                                     dtype=torch.int64, device=dev)
            self._ticket = torch.zeros(1, dtype=torch.int32, device=dev)
            # The block: the mask (C bytes), C class ids, N rows, then C
            # center rows, each part on 16 bytes.
            self._off_cls = _align16(c)
            self._off_rows = self._off_cls + 4 * c
            cap = _align16(self._off_rows + 4 * n) + 4 * c * d
            self._blk = torch.empty(cap, dtype=torch.uint8, device=dev)
            host = lib.bal_host_alloc(_BLK + cap)
            if not host:
                raise RuntimeError("BalancingState: pinned host memory "
                                   "refused")
            self._host = host
            dptr = lib.bal_host_device_ptr(host)
            event = self._event = lib.bal_event_create()
            if not dptr or not event:
                self.close()
                raise RuntimeError("BalancingState: no device mapping of "
                                   "the pinned block, or no event")
        buf = (ctypes.c_uint8 * (_BLK + cap)).from_address(host)
        self._u8 = np.frombuffer(buf, dtype=np.uint8)
        self._i32 = self._u8.view(np.int32)
        self._f32 = self._u8.view(np.float32)
        self._st = _BalState(
            self.emb.data_ptr(), self.eligible.data_ptr(),
            self.centers.data_ptr(), self._b2.data_ptr(),
            self._maj_idx.data_ptr(), self._n_maj.data_ptr(),
            self._keys.data_ptr(), self._ticket.data_ptr(),
            self._blk.data_ptr(), host + _BLK, dptr, host, event, n, d, c, 0)

    def take(self, row: int, cls: int, center_row) -> None:
        """Queue one pick: ``row`` leaves the eligible set, class
        ``cls``'s center becomes ``center_row`` (float32 [D])."""
        row, cls = int(row), int(cls)
        if not (0 <= row < self.n and 0 <= cls < self.c):
            raise ValueError(f"take: row {row} of {self.n} or class {cls} "
                             f"of {self.c} out of range")
        v = np.array(center_row, dtype=np.float32)
        if v.shape != (self.d,):
            raise ValueError(f"take: a center row of {self.d} features, "
                             f"got {v.shape}")
        self._rows[row] = None
        self._cls[cls] = v

    def pick(self, maj, rarest: int, rare_empty: bool) -> int:
        """The row the balancing branch picks after the queued takes:
        ``maj`` bool [C] on the host (the majority classes).  A state on
        the card raises once closed."""
        if self.emb.device.type == "cpu":
            return self.pick_reference(maj, rarest, rare_empty)
        if self._host is None:
            raise RuntimeError("BalancingState is closed")
        global launches, kernel_launches
        mask, rarest = self._mask(maj, rarest)
        c, d = self.c, self.d
        u8, i32, f32 = self._u8, self._i32, self._f32
        u8[_BLK:_BLK + c] = mask
        n_cls, n_rows = len(self._cls), len(self._rows)
        off_cls, off_rows = self._off_cls, self._off_rows
        w = (_BLK + off_cls) // 4
        i32[w:w + n_cls] = list(self._cls)
        w = (_BLK + off_rows) // 4
        i32[w:w + n_rows] = list(self._rows)
        off_cv = _align16(off_rows + 4 * n_rows)
        w = (_BLK + off_cv) // 4
        for v in self._cls.values():
            f32[w:w + d] = v
            w += d
        nbytes = off_cv + 4 * n_cls * d if n_cls else off_rows + 4 * n_rows
        args = (nbytes, off_cls, n_cls, off_rows, n_rows, off_cv,
                int(mask.sum()), rarest, rare_empty)
        before = self._st.launched
        if self._dev == torch.cuda.current_device():
            row = self._pick(*args)
        else:
            with torch.cuda.device(self._dev):
                row = self._pick(*args)
        kernel_launches += self._st.launched - before
        if row < 0:
            _launch_error(-row)
        self._rows.clear()
        self._cls.clear()
        self._full = False
        launches += 1
        return row

    def _pick(self, nbytes, off_cls, n_cls, off_rows, n_rows, off_cv,
              m_hi, rarest, rare_empty) -> int:
        return self._lib.bal_state_pick(
            ctypes.byref(self._st), nbytes, off_cls, n_cls, off_rows, n_rows,
            off_cv, int(self._full), m_hi, rarest, int(bool(rare_empty)),
            _raw_stream(self._dev))

    def pick_reference(self, maj, rarest: int, rare_empty: bool) -> int:
        """The plain version on this state: the queued takes applied with
        torch ops on the state's device, then
        ``balancing_pick_reference``.  (On the card the next kernel pick
        recomputes every center's b2.)"""
        mask, rarest = self._mask(maj, rarest)
        mask = torch.from_numpy(mask).to(self.emb.device)
        if self._rows:
            self.eligible[torch.tensor(list(self._rows),
                                       device=self.emb.device)] = False
        for cls, v in self._cls.items():
            self.centers[cls] = torch.from_numpy(v).to(self.emb.device)
        self._rows.clear()
        self._cls.clear()
        self._full = True
        return int(balancing_pick_reference(
            self.emb, self.eligible, self.centers, mask, rarest,
            bool(rare_empty)))

    def _mask(self, maj, rarest) -> Tuple[np.ndarray, int]:
        mask, rarest = np.asarray(maj, dtype=bool), int(rarest)
        if mask.shape != (self.c,):
            raise ValueError(f"maj must be a bool [{self.c}], got "
                             f"{mask.shape}")
        if not 0 <= rarest < self.c:
            raise ValueError(f"rarest {rarest} is not a class of {self.c}")
        return mask, rarest

    def close(self) -> None:
        """Free the pinned block and the event (the device tensors go
        with the object)."""
        host, self._host = getattr(self, "_host", None), None
        if host is not None:
            event, self._event = getattr(self, "_event", None), None
            if event:
                self._lib.bal_event_destroy(event)
            self._u8 = self._i32 = self._f32 = None
            self._lib.bal_host_free(host)

    def __del__(self):
        self.close()


_lib_handle = None


def _lib():
    """The C entry points, built and bound at first use."""
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("balancing")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bal_state_pick.argtypes = [ctypes.POINTER(_BalState), ll, i, i,
                                       i, i, i, i, i, i, i, p]
        lib.bal_state_pick.restype = ll
        lib.bal_key_slots.argtypes = [i]
        lib.bal_key_slots.restype = i
        lib.bal_host_alloc.argtypes = [ll]
        lib.bal_host_alloc.restype = p
        lib.bal_host_device_ptr.argtypes = [p]
        lib.bal_host_device_ptr.restype = p
        lib.bal_host_free.argtypes = [p]
        lib.bal_host_free.restype = i
        lib.bal_event_create.argtypes = []
        lib.bal_event_create.restype = p
        lib.bal_event_destroy.argtypes = [p]
        lib.bal_event_destroy.restype = i
        _lib_handle = lib
    return _lib_handle
