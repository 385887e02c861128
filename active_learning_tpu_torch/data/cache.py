"""Decode-once caches for deterministic dataset views, and the device
feeder (the JAX package's ``data/cache.py``, without ``GrowableRowStore``,
which waits for the streaming subsystem: ROADMAP.md queue 1 item 6).

Both caches are exact because the al/val/test views are deterministic:
``gather(i)`` does not depend on the epoch (``data/imagenet.py``).

  * ``CachedEvalRows``: RAM, one round.  Each epoch's validation reads
    the same eval rows; each is decoded once a round instead, up to
    ``max_bytes`` of rows (copies, never views of a gathered batch).
  * ``DecodedPoolCache``: a disk memmap for the life of the experiment.
    Every round scores the whole unlabeled pool and tests the whole test
    set; each row is decoded once for the life of the cache file.  The
    file name carries a fingerprint of the tree and the transform
    (``_signature``, the JAX package's, so either package reads the
    other's file: their CPU routes decode the same rows).  Rows decoded
    by nvJPEG on the card differ from libjpeg's by a bounded amount, so
    their signature is salted with the route: such a file is never read
    as libjpeg's rows.

Both are thread-safe: the feeds gather batches from several threads.  The
memmap tier writes the row bytes durably before the valid flag, so a
crash in between re-decodes and never serves a torn row.

``device_prefetch`` runs a feeder thread that gathers host batches and
``put``s each on the device ahead of its use, ``depth`` batches deep;
``device_put`` is that ``put`` for one device: a pinned staging copy,
then a non-blocking copy on a side CUDA stream that the consumer's
stream waits on.
"""

from __future__ import annotations

import glob
import hashlib
import json
import mmap
import os
import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from .. import faults
from ..utils.logging import get_logger
from .core import Dataset


def _msync_range(arr: np.ndarray, lo_byte: int, hi_byte: int) -> bool:
    """msync only the pages covering bytes [lo_byte, hi_byte) of a
    memmap-backed array; False when the mmap backing cannot be found
    (the caller then flushes the whole mapping)."""
    mm = arr
    while mm is not None and not isinstance(mm, mmap.mmap):
        mm = getattr(mm, "base", None)
    if mm is None:
        return False
    gran = mmap.ALLOCATIONGRANULARITY
    start = lo_byte // gran * gran
    end = min(len(mm), -(-hi_byte // gran) * gran)
    if end > start:
        mm.flush(start, end - start)
    return True


class CachedEvalRows:
    """Wrap a dataset whose active view is deterministic; same gather
    contract, rows served from memory after their first decode.  Only
    sound for augmentation-free views, so callers gate on the view."""

    def __init__(self, dataset: Dataset, max_bytes: int = 4 << 30):
        self.dataset = dataset
        self.view = dataset.view
        self.targets = dataset.targets
        self.num_classes = dataset.num_classes
        # Proxied so that Trainer.eval_batch_size sees the row size.
        self.image_shape = dataset.image_shape
        self._rows: Dict[int, np.ndarray] = {}
        self._bytes = 0
        self._max_bytes = int(max_bytes)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.dataset)

    def gather(self, idxs: np.ndarray) -> np.ndarray:
        idxs = np.asarray(idxs)
        if len(idxs) == 0:
            return self.dataset.gather(idxs)
        with self._lock:
            missing = sorted({int(i) for i in idxs} - self._rows.keys())
        fetched: Dict[int, np.ndarray] = {}
        if missing:
            rows = self.dataset.gather(np.asarray(missing, dtype=np.int64))
            with self._lock:
                for i, row in zip(missing, rows):
                    fetched[i] = row
                    if (i not in self._rows
                            and self._bytes + row.nbytes <= self._max_bytes):
                        self._rows[i] = row.copy()
                        self._bytes += row.nbytes
        out = []
        with self._lock:
            for j in idxs:
                i = int(j)
                row = self._rows.get(i)
                out.append(row if row is not None else fetched[i])
        return np.stack(out)


def _process_index() -> int:
    """This process's rank in a torch.distributed group, else 0: each
    rank of a mesh caches the rows it gathers in its own file."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class DecodedPoolCache:
    """A disk-memmap decode-once cache over a deterministic-view disk
    dataset: uint8 ``[N, H, W, C]`` rows written on first gather, each
    row's valid flag set after its bytes.  The backing file is sparse.
    Build it through ``maybe_wrap_decoded``.  Attributes the cache does
    not have (``paths``, ``targets``, ``image_shape``, ...) are the
    wrapped dataset's.  ``decoded_rows`` counts the rows it had to
    decode."""

    # Basenames of caches live in this process (the al pool and the test
    # set may share a directory): eviction never takes them.
    _IN_USE: set = set()

    def __init__(self, dataset, cache_dir: str,
                 signature: Optional[str] = None):
        self.dataset = dataset
        n = len(dataset)
        shape = (n, *dataset.image_shape)
        os.makedirs(cache_dir, exist_ok=True)
        sig = signature or self._signature(dataset)
        base = os.path.join(cache_dir, f"decoded_{sig}_p{_process_index()}")
        self._data_path = base + ".u8"
        self._valid_path = base + ".valid"
        meta_path = base + ".json"
        fresh = not (os.path.exists(self._data_path)
                     and os.path.exists(self._valid_path)
                     and os.path.exists(meta_path))
        if fresh:
            # Sparse-create both files, the meta file last (its presence
            # marks the pair usable).
            for path, nbytes in ((self._data_path, int(np.prod(shape))),
                                 (self._valid_path, n)):
                with open(path + ".tmp", "wb") as fh:
                    fh.truncate(nbytes)
                os.replace(path + ".tmp", path)
            with open(meta_path + ".tmp", "w") as fh:
                json.dump({"shape": shape, "signature": sig}, fh)
            os.replace(meta_path + ".tmp", meta_path)
        DecodedPoolCache._IN_USE.add(base)
        self._rows = np.memmap(self._data_path, dtype=np.uint8, mode="r+",
                               shape=shape)
        self._valid = np.memmap(self._valid_path, dtype=np.uint8, mode="r+",
                                shape=(n,))
        self.decoded_rows = 0
        self._count_lock = threading.Lock()
        have = int(np.count_nonzero(self._valid))
        get_logger().info(
            f"Decoded-pool cache at {base}.u8: {have}/{n} rows present "
            f"({'resumed' if not fresh else 'new'}, "
            f"{np.prod(shape) / 1e9:.1f} GB full size, sparse)")

    @staticmethod
    def _signature(dataset) -> str:
        h = hashlib.sha1()
        h.update(str(getattr(dataset, "image_size", "")).encode())
        h.update(str(getattr(dataset, "resize_size", "")).encode())
        h.update(str(len(dataset)).encode())
        for p in dataset.paths[: len(dataset)]:
            h.update(p.encode())
            # Size and mtime of each file: images re-encoded in place at
            # the same paths get a fresh cache, not stale pixels.
            try:
                st = os.stat(p)
                h.update(f"|{st.st_size}|{st.st_mtime_ns}".encode())
            except OSError:
                h.update(b"|missing")
        device = getattr(dataset, "device", None)
        if (device is not None and device.type == "cuda"
                and getattr(dataset, "_use_native", False)):
            h.update(b"|nvjpeg")
        return h.hexdigest()[:16]

    def __len__(self) -> int:
        return len(self.dataset)

    @property
    def images(self):
        """The decoded pool as one uint8 array, only once every row is
        decoded; while partial, AttributeError (the wrapped dataset has no
        ``images``), so a half-empty memmap is never taken for a pool."""
        if int(np.count_nonzero(self._valid)) != len(self.dataset):
            raise AttributeError("decoded pool not fully populated")
        return self._rows

    def __getattr__(self, name):
        # Called only for attributes not set on self.
        if name == "dataset":  # unpickling guard: no silent recursion
            raise AttributeError(name)
        return getattr(self.dataset, name)

    def gather(self, idxs: np.ndarray) -> np.ndarray:
        idxs = np.asarray(idxs, dtype=np.int64)
        if len(idxs) == 0:
            return self.dataset.gather(idxs)
        valid = self._valid[idxs] != 0
        if not valid.all():
            missing = np.unique(idxs[~valid])
            rows = self.dataset.gather(missing)
            self._rows[missing] = rows
            # The row bytes durably first, then the flags: without the
            # flush a flag page could reach the disk before its row page,
            # and a crash would leave a valid flag over zeros.
            self._flush_row_range(int(missing[0]), int(missing[-1]) + 1)
            self._valid[missing] = 1
            with self._count_lock:
                self.decoded_rows += len(missing)
        return np.asarray(self._rows[idxs])

    def _flush_row_range(self, lo: int, hi: int) -> None:
        """msync only the pages covering rows [lo, hi)."""
        row_bytes = int(self._rows.strides[0])
        if not _msync_range(self._rows, lo * row_bytes, hi * row_bytes):
            self._rows.flush()

    def flush(self) -> None:
        self._rows.flush()
        self._valid.flush()


class DeviceBatch:
    """A batch ``put`` on the device: its tensors, and the event its
    copy recorded on the side stream (None on the CPU).  ``wait`` makes
    the caller's current stream wait on the copy and marks each tensor
    as used on that stream, so the caching allocator does not hand its
    memory out while the stream may still read it."""

    def __init__(self, tensors: Dict[str, torch.Tensor],
                 event: Optional[torch.cuda.Event] = None):
        self.tensors = tensors
        self.event = event

    def wait(self) -> Dict[str, torch.Tensor]:
        if self.event is not None:
            stream = torch.cuda.current_stream(
                next(iter(self.tensors.values())).device)
            stream.wait_event(self.event)
            for t in self.tensors.values():
                t.record_stream(stream)
        return self.tensors


def device_put(device) -> Callable[[Dict[str, np.ndarray]], DeviceBatch]:
    """The ``put`` of ``device_prefetch`` for one device.  On the CPU,
    ``torch.from_numpy``.  On a card, each array is staged in pinned
    host memory and copied with ``non_blocking=True`` on a side stream;
    an event marks the copy's end.  The pinned buffers come from
    PyTorch's caching host allocator, which records the copy's stream
    on each and reuses a buffer only after its copy has completed."""
    device = torch.device(device)
    if device.type != "cuda":
        def put_cpu(batch):
            return DeviceBatch({k: torch.from_numpy(np.asarray(v))
                                for k, v in batch.items()})
        return put_cpu
    stream = torch.cuda.Stream(device)

    def put(batch):
        with torch.cuda.stream(stream):
            tensors = {k: torch.from_numpy(np.asarray(v)).pin_memory()
                       .to(device, non_blocking=True)
                       for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return DeviceBatch(tensors, event)
    return put


def device_prefetch(batches: Iterable, put: Callable,
                    depth: int = 2) -> Iterator:
    """A feeder thread pulls host batches from ``batches`` and calls
    ``put`` on each, so that the copy of batch n+1 is in flight while
    batch n computes; the items come out in order from a queue bounded
    at ``depth``.  An error in the feeder (its ``feed_worker`` fault site
    included, raise or thread death) re-raises at the consumer's
    ``next()``: it fails the pass, never hangs it.  Closing the generator
    early unblocks and joins the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    DONE, ERROR = object(), object()

    def feed():
        try:
            for batch in batches:
                faults.site("feed_worker")
                item = put(batch)
                while not stop.is_set():
                    try:
                        q.put((None, item), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put((DONE, None))
        except BaseException as e:  # noqa: BLE001 - re-raised at consumer
            q.put((ERROR, e))

    t = threading.Thread(target=feed, name="al-device-prefetch",
                         daemon=True)
    t.start()
    try:
        while True:
            tag, item = q.get()
            if tag is DONE:
                return
            if tag is ERROR:
                raise item
            yield item
    finally:
        stop.set()
        while True:  # drain, so the feeder's put() cannot block the join
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)


def maybe_wrap_decoded(dataset, cache_dir: Optional[str],
                       max_bytes: int):
    """``dataset`` in a DecodedPoolCache when it is a disk-backed
    deterministic view whose whole decoded pool fits ``max_bytes`` (the
    scoring pass touches every row, so a partial cache would thrash);
    otherwise ``dataset`` itself.  A cache that cannot be built (an
    unwritable directory, a full disk) is logged and skipped."""
    if not cache_dir or max_bytes <= 0:
        return dataset
    if not hasattr(dataset, "paths") or getattr(dataset, "train_transform",
                                                False):
        return dataset
    full = len(dataset) * int(np.prod(dataset.image_shape))
    if full > max_bytes:
        get_logger().info(
            f"Decoded-pool cache disabled: full pool is {full / 1e9:.1f} GB "
            f"> budget {max_bytes / 1e9:.1f} GB")
        return dataset
    try:
        sig = DecodedPoolCache._signature(dataset)
        _evict_stale_caches(cache_dir, full, max_bytes, keep_sig=sig)
        return DecodedPoolCache(dataset, cache_dir, signature=sig)
    except OSError as e:
        get_logger().warning(f"Decoded-pool cache unavailable ({e!r}); "
                             "continuing undecached")
        return dataset


def _evict_stale_caches(cache_dir: str, need_bytes: int, max_bytes: int,
                        keep_sig: str) -> None:
    """Before a new cache is built, delete the least recently used old
    cache triples (re-encoded trees, other datasets, dead experiments)
    until what is left plus ``need_bytes`` fits the budget.  Allocated
    (sparse) sizes count; caches of this process and the current
    signature's files are never taken."""
    groups: Dict[str, list] = {}
    for path in glob.glob(os.path.join(cache_dir, "decoded_*")):
        base = path.rsplit(".", 1)[0]
        groups.setdefault(base, []).append(path)
    entries = []
    total = 0
    for base, paths in groups.items():
        if keep_sig in os.path.basename(base) \
                or base in DecodedPoolCache._IN_USE:
            continue
        try:
            stats = [os.stat(p) for p in paths]
        except OSError:
            continue
        alloc = sum(s.st_blocks * 512 for s in stats)
        entries.append((max(s.st_mtime for s in stats), alloc, paths))
        total += alloc
    entries.sort()  # oldest first
    for mtime, alloc, paths in entries:
        if total + need_bytes <= max_bytes:
            break
        for p in paths:
            try:
                os.remove(p)
            except OSError:
                pass
        total -= alloc
        get_logger().info(
            f"Evicted stale decoded cache {paths[0].rsplit('.', 1)[0]} "
            f"({alloc / 1e9:.1f} GB)")
