"""Data-parallel ranks and their collectives (the JAX package's
``parallel/mesh.py``).

The JAX package runs one process over a ``jax.sharding.Mesh`` and lets
the partitioner insert the collectives.  The port runs one process per
rank, as the reference does (``mp.spawn`` + a process group), and says
every collective itself:

  * ``Mesh`` holds the rank, the world size, the ``torch.distributed``
    group, the rank's device and the backend.  Its ``all_reduce``,
    ``all_gather``, ``all_to_all``, ``broadcast`` and ``barrier`` are the
    only collectives the port makes; without a group (one rank) they are
    identities, and a group of one still makes the backend's calls.
  * The backend is explicit: ``nccl`` for one rank per card, ``gloo``
    on the CPU.  ``gloo`` with CUDA tensors (N ranks sharing one card,
    the only multi-rank form a one-card machine can run) stages every
    collective through pinned host memory; int8 stays int8 on the wire.
    Nothing switches backend quietly.
  * ``int8_allreduce`` / ``int8_reduce_scatter`` are the JAX package's
    block-scaled int8 gradient sync (``:472``, ``:534``) over a list of
    tensors: the per-rank steps are kernel J (``ops/int8_sync.py``), the
    wire is the mesh's.
  * ``run_thread_ranks`` runs N ranks as threads of one process, each
    with a ``ThreadMesh`` whose collectives meet in memory (a stack, a
    sum, a max, a transpose): the same sync code, held side by side
    without a process group (the tests and ``chip_smoke.py`` hold
    kernel J against its plain version so).
  * The rules (``resolve_grad_allreduce``, ``resolve_int8_wire``,
    ``wire_model_bytes``) are copies that return what the JAX package's
    return.

Not ported (ROADMAP.md): ``DispatchGate`` (the pipelined round) and the
row-sharded pool's ``row_sharding``/``shard_rows``/``owner_rows*``/
``ring_shift`` (``--pool_sharding``).
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops import int8_sync as j

BACKENDS = ("nccl", "gloo")
# Seconds a collective may wait for its peers before it fails.
DEFAULT_TIMEOUT_S = 1800.0


# -- the mesh ---------------------------------------------------------------

@dataclasses.dataclass
class Mesh:
    """One rank's view of the data-parallel group.  ``backend`` is
    "nccl", "gloo", or "none" for a single rank without a group."""

    rank: int = 0
    world_size: int = 1
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    backend: str = "none"
    group: Any = None

    @property
    def is_coordinator(self) -> bool:
        """``:78``: the rank that owns run-level side effects (metrics,
        checkpoints, experiment state), the reference's rank-0 guard."""
        return self.rank == 0

    @property
    def staged(self) -> bool:
        """gloo over CUDA tensors: every collective goes through host
        memory."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def wire_device(self) -> torch.device:
        """Where a collective's tensors must lie for the backend."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def describe(self) -> str:
        how = {"nccl": "NCCL, one rank per card",
               "gloo": ("gloo, host-staged through pinned memory"
                        if self.staged else "gloo on the CPU"),
               "threads": "threads of one process",
               "none": "single rank"}[self.backend]
        return (f"rank {self.rank} of {self.world_size} on {self.device} "
                f"({how})")

    # -- collectives -----------------------------------------------------

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if t.device == self.wire_device:
            return t
        if self.wire_device.type == "cpu":
            host = torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=t.device.type == "cuda")
            return host.copy_(t)
        return t.to(self.wire_device)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In place over the group (``op`` "sum" or "max"); returns
        ``t``."""
        if self.group is None:
            return t
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        w = self._to_wire(t)
        dist.all_reduce(w, op=red, group=self.group)
        if w.data_ptr() != t.data_ptr():
            t.copy_(w)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[world, *t.shape]``: every rank's ``t`` in rank order, on
        ``t``'s device."""
        if self.group is None:
            return t[None]
        w = self._to_wire(t)
        out = torch.empty((self.world_size, *t.shape), dtype=t.dtype,
                          device=w.device)
        dist.all_gather(list(out.unbind(0)), w, group=self.group)
        return out.to(t.device)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s leading axis cut into ``world`` equal chunks, chunk d
        sent to rank d; returns the chunks received, in source-rank
        order, with ``t``'s shape."""
        if self.group is None:
            return t
        if t.shape[0] % self.world_size:
            raise ValueError(f"all_to_all: {t.shape[0]} rows do not split "
                             f"over {self.world_size} ranks")
        w = self._to_wire(t)
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w, group=self.group)
        return out.to(t.device)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """In place from rank ``src``; returns ``t``."""
        if self.group is None:
            return t
        w = self._to_wire(t)
        dist.broadcast(w, src, group=self.group)
        if w.data_ptr() != t.data_ptr():
            t.copy_(w)
        return t

    def barrier(self) -> None:
        if self.group is not None:
            self.all_reduce(torch.zeros(1, device=self.device))


class _Meeting:
    """Where the thread ranks of one process meet for a collective."""

    def __init__(self, world: int, timeout_s: float):
        self.slots: List[Any] = [None] * world
        self.barrier = threading.Barrier(world, timeout=timeout_s)

    def exchange(self, rank: int, t: torch.Tensor,
                 combine: Callable[[List[torch.Tensor]], Any]) -> Any:
        """``combine`` of every rank's ``t`` in rank order, computed by
        each rank while no rank has moved on to change its own."""
        self.slots[rank] = t
        self.barrier.wait()
        try:
            return combine(self.slots)
        finally:
            self.barrier.wait()


@dataclasses.dataclass
class ThreadMesh(Mesh):
    """One of N ranks that are threads of one process
    (``run_thread_ranks``).  The collectives meet in memory: a sum (in
    rank order) or a max of the stacked tensors, a stack, a transpose of
    chunks, a copy.  Tensors stay on their device; kernel launches from
    the threads share the device's default stream, so a rank reads a
    peer's tensor only after the peer's launches that wrote it."""

    meeting: Optional[_Meeting] = None

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        red = {"sum": lambda s: torch.stack(s).sum(0).to(t.dtype),
               "max": lambda s: torch.stack(s).amax(0)}[op]
        t.copy_(self.meeting.exchange(self.rank, t, red))
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return self.meeting.exchange(self.rank, t.contiguous(), torch.stack)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        n, me = self.world_size, self.rank
        if t.shape[0] % n:
            raise ValueError(f"all_to_all: {t.shape[0]} rows do not split "
                             f"over {n} ranks")
        return self.meeting.exchange(
            self.rank, t, lambda s: torch.cat([x.chunk(n)[me] for x in s]))

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        t.copy_(self.meeting.exchange(self.rank, t, lambda s: s[src]))
        return t

    def barrier(self) -> None:
        self.meeting.barrier.wait()


def run_thread_ranks(fn: Callable[[Mesh], Any], world: int, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """``fn(mesh)`` on each of ``world`` thread ranks of this process,
    every rank on ``device``; returns the results in rank order.  A rank
    that raises breaks the others' next collective, and its exception is
    raised here (a collective waiting ``timeout_s`` raises too)."""
    meeting = _Meeting(world, timeout_s)
    dev = resolve_device(device)
    results: List[Any] = [None] * world
    errors: List[Optional[BaseException]] = [None] * world

    def run(rank: int) -> None:
        try:
            results[rank] = fn(ThreadMesh(rank, world, dev, "threads", None,
                                          meeting))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[rank] = e
            meeting.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,), name=f"rank{r}")
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    raised = [e for e in errors if e is not None]
    if raised:
        # The first cause, not a peer's broken barrier.
        raise next((e for e in raised
                    if not isinstance(e, threading.BrokenBarrierError)),
                   raised[0])
    return results


def single_rank(device=None) -> Mesh:
    """The mesh of a run with one rank and no process group."""
    return Mesh(0, 1, resolve_device(device), "none", None)


def default_backend(device) -> str:
    """``nccl`` for cards, ``gloo`` for the CPU."""
    return "gloo" if resolve_device(device).type == "cpu" else "nccl"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = "gloo",
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group (``:35-75``): a no-op returning False for a
    single-process run (no address and no count, or a count of 1);
    otherwise ``init_process_group`` with ``init_method`` the address
    (``host:port`` means ``tcp://host:port``; ``file://...`` is taken as
    given), the world size and this rank.  Returns True."""
    if coordinator_address is None and num_processes is None:
        return False
    if num_processes is not None and num_processes <= 1:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs the coordinator "
                         "address, the number of processes and this "
                         "process's id")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is outside "
                         f"[0, {num_processes})")
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init,
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def visible_devices(device) -> int:
    """What ``num_devices=-1`` means: every visible card, or 1 on the
    CPU."""
    if resolve_device(device).type == "cpu":
        return 1
    return torch.cuda.device_count()


def resolve_num_devices(num_devices: int, device) -> int:
    n = visible_devices(device) if num_devices == -1 else int(num_devices)
    if n < 1:
        raise ValueError(f"num_devices={num_devices} resolves to {n} ranks")
    return n


def make_mesh(num_devices: int = -1, device=None,
              backend: Optional[str] = None) -> Mesh:
    """This rank's mesh (``:212``).  Inside a process group: every rank
    of the group (``num_devices`` must be -1 or the world size: a mesh
    never trims a group), on ``cuda:rank % cards`` under NCCL when
    ``device`` names no card index, on ``device`` as given under gloo.
    Outside a group: one rank; asking for more raises, because N ranks
    are N processes (``launch_ranks``, or the CLI's ``--num_devices``)."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        actual = str(dist.get_backend())
        if backend is not None and backend != actual:
            raise ValueError(f"the process group runs {actual}, not "
                             f"{backend}")
        if num_devices not in (-1, world):
            raise ValueError(f"num_devices={num_devices} would trim a "
                             f"{world}-rank group; start fewer ranks")
        dev = resolve_device(device)
        if actual == "nccl":
            if dev.type != "cuda":
                raise ValueError("nccl needs a CUDA device per rank")
            if device in (None, "", "cuda"):
                dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        return Mesh(rank, world, dev, actual, dist.group.WORLD)
    n = resolve_num_devices(num_devices, device)
    if n != 1:
        raise ValueError(
            f"num_devices={num_devices} asks for {n} ranks in a process "
            "outside any process group: start the ranks with "
            "parallel.mesh.launch_ranks (the CLI's --num_devices does), or "
            "join a group first (initialize_distributed)")
    if backend not in (None, "none"):
        raise ValueError(f"backend {backend!r} needs a process group")
    return single_rank(device)


def process_local_rows(mesh: Mesh, batch_size: int) -> slice:
    """``:168``: this rank's contiguous rows of a ``[batch_size, ...]``
    global batch (the reference's DistributedSampler slice)."""
    if batch_size % mesh.world_size:
        raise ValueError(f"a batch of {batch_size} rows does not split "
                         f"over {mesh.world_size} ranks; pad it first")
    per = batch_size // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def padded_batch_size(batch_size: int, mesh: Mesh) -> int:
    """Round a global batch up to a multiple of the world size; the
    padding rows are masked out of every reduction."""
    n = mesh.world_size
    return -(-int(batch_size) // n) * n


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh
                ) -> Dict[str, torch.Tensor]:
    """``:622``: this rank's rows of a global host batch, on its
    device."""
    rows = process_local_rows(mesh, len(next(iter(batch.values()))))
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(
        mesh.device) for k, v in batch.items()}


def fetch(local, mesh: Mesh) -> np.ndarray:
    """``:660``: every rank's rows, concatenated in rank order, on every
    rank, as numpy.  Ranks may hold different row counts: each is
    padded to the longest for the gather and trimmed after."""
    arr = local.detach().cpu().numpy() if isinstance(local, torch.Tensor) \
        else np.asarray(local)
    if mesh.world_size == 1:
        return arr
    as_u8 = arr.dtype == np.bool_
    t = torch.from_numpy(np.ascontiguousarray(
        arr.view(np.uint8) if as_u8 else arr))
    n = torch.tensor([t.shape[0]], dtype=torch.int64)
    counts = mesh.all_gather(n)[:, 0].tolist()
    pad = max(counts) - t.shape[0]
    if pad:
        t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
    out = mesh.all_gather(t).numpy()
    out = np.concatenate([out[r, :c] for r, c in enumerate(counts)])
    return out.view(np.bool_) if as_u8 else out


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank, world, address, backend, timeout_s, args):
    initialize_distributed(address, world, rank, backend=backend,
                           timeout_s=timeout_s)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def launch_ranks(fn: Callable, world: int, args: Sequence[Any] = (),
                 backend: str = "gloo",
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 join_timeout_s: Optional[float] = None) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes (the
    ``spawn`` start method), each joined to one process group over
    ``localhost`` on a free port; the reference's ``mp.spawn``.  ``fn``
    must be importable by name.  Under ``nccl`` every rank needs its own
    card.  Raises when a rank exits non-zero (the others are stopped) or
    ``join_timeout_s`` passes."""
    import multiprocessing as mp

    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"{world} nccl ranks need {world} cards; "
                         f"{torch.cuda.device_count()} are visible (NCCL "
                         "refuses two ranks on one card; gloo can share "
                         "one, staged through host memory)")
    address = f"localhost:{_free_port()}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, address, backend, timeout_s,
                               tuple(args)), name=f"rank{r}")
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if join_timeout_s is None \
        else time.monotonic() + join_timeout_s
    try:
        while any(p.is_alive() for p in procs):
            bad = [p for p in procs if p.exitcode not in (None, 0)]
            if bad:
                raise RuntimeError(f"{bad[0].name} exited with code "
                                   f"{bad[0].exitcode}")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after "
                                   f"{join_timeout_s} s")
            time.sleep(0.05)
        bad = [p for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"{bad[0].name} exited with code "
                               f"{bad[0].exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()


# -- the gradient-sync rules (``:388-470``) ----------------------------------

GRAD_ALLREDUCE_MODES = ("f32", "int8", "int8_rs", "auto")

# Elements per quantization block: one float32 scale per 256 int8
# payload bytes.
INT8_BLOCK = j.BLOCK

# Above this many ranks the int8 sync takes the reduce-scatter wire form.
INT8_WIRE_CROSSOVER_NDEV = 8

INT8_WIRE_FORMS = ("allgather", "reduce_scatter")


def resolve_grad_allreduce(mode: str, mesh: Mesh) -> str:
    """``int8``/``int8_rs``/``auto`` -> "int8" on more than one rank;
    anything else, and one rank, -> "f32"."""
    if mode not in GRAD_ALLREDUCE_MODES:
        raise ValueError(f"grad_allreduce={mode!r} is not one of "
                         f"{'/'.join(GRAD_ALLREDUCE_MODES)}")
    if mesh.world_size <= 1:
        return "f32"
    if mode in ("int8", "int8_rs", "auto"):
        return "int8"
    return mode


def resolve_int8_wire(mode: str, mesh: Mesh) -> str:
    """``int8_rs`` forces the reduce-scatter form; otherwise it is taken
    above ``INT8_WIRE_CROSSOVER_NDEV`` ranks, the all-gather form at or
    below."""
    if mode == "int8_rs":
        return "reduce_scatter"
    if mesh.world_size > INT8_WIRE_CROSSOVER_NDEV:
        return "reduce_scatter"
    return "allgather"


def wire_model_bytes(form: str, ndev: int, n: int) -> int:
    """Per-rank wire bytes to sync ``n`` float32 gradient elements: the
    f32 ring ~8n, the all-gather form (ndev-1)·(n + scales), the
    reduce-scatter form ~2n."""
    if ndev <= 1:
        return 0
    scale_bytes = 4 * -(-n // INT8_BLOCK)
    if form == "f32":
        return int(2 * 4 * n * (ndev - 1) / ndev)
    if form == "allgather":
        return (ndev - 1) * (n + scale_bytes)
    if form == "reduce_scatter":
        return int(2 * (n + scale_bytes) * (ndev - 1) / ndev)
    raise ValueError(f"unknown wire form {form!r}")


# -- the flat sync buffer -----------------------------------------------------

def _dense_stride(t: torch.Tensor) -> Tuple[int, ...]:
    """The tensor's own strides when it covers its storage densely
    (row-major or channels-last), else row-major ones."""
    if t.is_contiguous() or (
            t.dim() == 4
            and t.is_contiguous(memory_format=torch.channels_last)):
        return tuple(t.stride())
    return tuple(torch.empty(t.shape, device="meta").stride())


class SyncLayout:
    """Where each float leaf of a tensor list lives in one flat float32
    buffer: every leaf starts on a block boundary and is zero-padded to
    a multiple of ``INT8_BLOCK`` (of ``INT8_BLOCK · world`` for the
    reduce-scatter form), so no block spans two leaves and each leaf is blocked as the
    JAX package blocks it.  Elements keep the leaf's storage order, and
    the synced leaves are views of the output buffer with the leaf's
    strides.

    For the reduce-scatter form, leaf ``l``'s ``nb_l`` blocks split into
    ``world`` shards of ``m_l = nb_l / world``; ``slot_of_block`` sends
    block ``k`` of leaf ``l`` to slot ``dest · per_dest + C_l + k mod
    m_l`` with ``dest = k div m_l`` and ``C_l = Σ_{l' < l} m_l'``: the
    all_to_all send buffer ordered ``[dest][leaf][block]``."""

    def __init__(self, signature: Tuple, world: int, form: str):
        if form not in ("f32",) + INT8_WIRE_FORMS:
            raise ValueError(f"unknown sync form {form!r}")
        self.world, self.form = world, form
        block = INT8_BLOCK
        unit = block * world if form == "reduce_scatter" else block
        self.leaves = []   # (index, offset, numel, shape, stride, dtype)
        off = 0
        for i, (shape, stride, dtype, is_float) in enumerate(signature):
            if not is_float:
                continue
            n = int(np.prod(shape, dtype=np.int64))
            self.leaves.append((i, off, n, shape, stride, dtype))
            off += -(-n // unit) * unit
        self.total = off
        self.num_blocks = off // block
        self.per_dest = self.num_blocks // world
        self._slots = None
        self._slots_on: Dict[torch.device, torch.Tensor] = {}
        if form == "reduce_scatter":
            parts, c = [], 0
            for _, off, n, *_ in self.leaves:
                nb = -(-n // unit) * unit // block
                m = nb // world
                k = np.arange(nb, dtype=np.int64)
                parts.append((k // m) * self.per_dest + c + k % m)
                c += m
            self._slots = (np.concatenate(parts) if parts
                           else np.zeros(0, np.int64)).astype(np.int32)

    def slot_of_block(self, device: torch.device) -> Optional[torch.Tensor]:
        if self._slots is None:
            return None
        if device not in self._slots_on:
            self._slots_on[device] = torch.from_numpy(self._slots).to(device)
        return self._slots_on[device]

    def pack(self, tensors: Sequence[torch.Tensor],
             device: torch.device) -> torch.Tensor:
        flat = torch.zeros(self.total, dtype=torch.float32, device=device)
        for i, off, n, shape, stride, _ in self.leaves:
            flat.as_strided(shape, stride, off).copy_(tensors[i])
        return flat

    def unpack(self, flat: torch.Tensor, tensors: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
        """The float leaves as views of ``flat`` (cast back to their
        dtype when it is not float32); other leaves as given."""
        out = list(tensors)
        for i, off, n, shape, stride, dtype in self.leaves:
            v = flat.as_strided(shape, stride, off)
            out[i] = v if dtype == torch.float32 else v.to(dtype)
        return out


def _signature(tensors: Sequence[torch.Tensor]) -> Tuple:
    return tuple((tuple(t.shape), _dense_stride(t), t.dtype,
                  t.is_floating_point()) for t in tensors)


@functools.lru_cache(maxsize=16)
def _layout(signature: Tuple, world: int, form: str) -> SyncLayout:
    return SyncLayout(signature, world, form)


def sync_layout(tensors: Sequence[torch.Tensor], world: int, form: str
                ) -> SyncLayout:
    """The layout of a tensor list, built once per list shape."""
    return _layout(_signature(tensors), int(world), form)


def _sum_other_leaves(tensors, layout, mesh) -> List[torch.Tensor]:
    floats = {i for i, *_ in layout.leaves}
    return [t if i in floats else mesh.all_reduce(t.clone())
            for i, t in enumerate(tensors)]


def allreduce_f32(tensors: Sequence[torch.Tensor], mesh: Mesh
                  ) -> List[torch.Tensor]:
    """The f32 gradient sync: every float leaf packed into one flat
    bucket, one ``all_reduce(SUM)``, the leaves back as views; other
    leaves summed one by one."""
    if mesh.world_size == 1:
        return list(tensors)
    layout = sync_layout(tensors, mesh.world_size, "f32")
    flat = mesh.all_reduce(layout.pack(tensors, mesh.device))
    return layout.unpack(flat, _sum_other_leaves(tensors, layout, mesh))


def int8_sync_flat(flat: torch.Tensor, mesh: Mesh,
                   layout: SyncLayout) -> torch.Tensor:
    """The int8 sync of one packed buffer: kernel J's four steps around
    the mesh's collectives.  Every rank returns the same bytes."""
    absmax = mesh.all_reduce(j.block_absmax(flat), "max")
    slots = layout.slot_of_block(flat.device)
    q, scale = j.quantize(flat, absmax, slots)
    if layout.form == "allgather":
        # int8 on the wire; the sum accumulates after the gather.
        return j.dequant_sum(mesh.all_gather(q), scale, absmax)
    n, per = mesh.world_size, layout.per_dest
    recv = mesh.all_to_all(q).view(n, -1)
    me = slice(mesh.rank * per, (mesh.rank + 1) * per)
    q2, scale2 = j.sum_requantize(recv, scale[me])
    return j.dequant_sum(mesh.all_gather(q2).view(1, -1),
                         mesh.all_gather(scale2).view(-1), absmax, slots)


def _int8_sync(tensors, mesh: Mesh, form: str):
    layout = sync_layout(tensors, mesh.world_size, form)
    out = int8_sync_flat(layout.pack(tensors, mesh.device), mesh, layout)
    return layout.unpack(out, _sum_other_leaves(tensors, layout, mesh))


def int8_allreduce(tensors: Sequence[torch.Tensor], mesh: Mesh
                   ) -> List[torch.Tensor]:
    """``:472``: block-scaled int8 all-reduce, the all-gather wire form.
    Each rank quantizes its gradients against a shared per-block scale
    (the group max of the block absmax over 127), the int8 payloads are
    all-gathered, and every rank sums them exactly and dequantizes: the
    same result on every rank, within ``world · scale / 2`` of the f32
    sum per element.  A non-finite block comes out NaN; non-float
    leaves are summed exactly.  Returns the synced leaves (float ones
    as views of one flat buffer)."""
    return _int8_sync(tensors, mesh, "allgather")


def int8_reduce_scatter(tensors: Sequence[torch.Tensor], mesh: Mesh
                        ) -> List[torch.Tensor]:
    """``:534``: the reduce-scatter wire form.  Quantized as
    ``int8_allreduce``; an all_to_all gives each rank every peer's copy
    of its shard of each leaf's blocks; the owner sums them, re-quantizes
    against its own per-block scale, and an all_gather of the
    re-quantized shards and their scales gives every rank the whole
    result.  Within ``world · scale / 2 + scale2 / 2`` of the f32 sum."""
    return _int8_sync(tensors, mesh, "reduce_scatter")
