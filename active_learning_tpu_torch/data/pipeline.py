"""Host-side batching (the JAX package's ``data/pipeline.py``, host feed
only).

Batches are fixed-shape: the last one is padded with copies of its
first row and masked.  Batch order and membership come from explicit
index math on an injected ``np.random.Generator``, so at the same
generator state the port's batches are bit-identical to the JAX
package's.  Every batch carries the pool indices of its rows.  With
``s2d=True`` the rows leave the host in the space-to-depth layout of the
s2d stem (``space_to_depth``), the same bytes re-laid.  With ``rows``
(a slice of the fixed-shape batch) only those rows are gathered: one
rank's share of a global batch.  ``train_feed_batches`` is the
prefetched train feed: the same batches, gathered by worker threads and
put on the device ahead of their step.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, Optional

import numpy as np

from .core import Dataset


def batch_index_lists(idxs: np.ndarray, batch_size: int,
                      shuffle: bool = False,
                      rng: Optional[np.random.Generator] = None,
                      drop_last: bool = False):
    """Split ``idxs`` into per-batch index arrays (one ``permutation``
    draw from ``rng`` when shuffling)."""
    idxs = np.asarray(idxs)
    if shuffle:
        if rng is None:
            raise ValueError("shuffle=True requires an explicit rng")
        idxs = rng.permutation(idxs)
    n = len(idxs)
    if drop_last:
        n = (n // batch_size) * batch_size
    return [idxs[i:i + batch_size] for i in range(0, n, batch_size)]


def padded_batch_layout(batch_idxs: np.ndarray, batch_size: int):
    """(padded index array, validity mask) of one fixed-shape batch:
    padding rows repeat the batch's first example with mask 0."""
    idxs = np.asarray(batch_idxs)
    actual = len(idxs)
    mask = np.ones(batch_size, dtype=np.float32)
    if actual < batch_size:
        idxs = np.concatenate(
            [idxs, np.repeat(idxs[:1], batch_size - actual)], axis=0)
        mask[actual:] = 0.0
    return idxs, mask


def space_to_depth(images: np.ndarray, block: int = 2) -> np.ndarray:
    """Host-side space-to-depth: uint8 ``[B, H, W, C] -> [B, H/b, W/b,
    b·b·C]``, channel index ``(di·b + dj)·C + c``, the layout of
    ``models/resnet.space_to_depth`` and of the folded stem kernel
    (``s2d_stem_kernel``).  The byte count is unchanged."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // block, block, w // block, block, c)
    return np.ascontiguousarray(
        x.transpose(0, 1, 3, 2, 4, 5)).reshape(
            b, h // block, w // block, block * block * c)


def gather_batch(dataset: Dataset, batch_idxs: np.ndarray,
                 batch_size: int, s2d: bool = False,
                 rows: Optional[slice] = None) -> Dict[str, np.ndarray]:
    """One fixed-shape batch: uint8 images (space-to-depth with
    ``s2d``), int32 labels and pool indices, float32 validity mask (0 on
    padding rows); with ``rows``, only that slice of it."""
    idxs, mask = padded_batch_layout(batch_idxs, batch_size)
    if rows is not None:
        idxs, mask = idxs[rows], mask[rows]
    n_real = int(mask.sum())
    images = dataset.gather(idxs[:n_real])
    if n_real < len(idxs):
        pad_img = dataset.gather(idxs[n_real:n_real + 1])
        images = np.concatenate(
            [images, np.repeat(pad_img, len(idxs) - n_real, axis=0)], axis=0)
    labels = dataset.targets[idxs]
    if s2d:
        images = space_to_depth(images)
    return {"image": images, "label": labels.astype(np.int32),
            "index": np.asarray(idxs, dtype=np.int32), "mask": mask}


def ordered_map(fn, items, num_threads: int = 0, prefetch: int = 2):
    """Yield ``fn(item)`` for each item, in order; with ``num_threads >
    0`` worker threads compute ahead (at most ``num_threads + prefetch``
    results in flight), and an error in a worker re-raises here, in
    order."""
    if num_threads <= 0:
        for item in items:
            yield fn(item)
        return

    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    executor = ThreadPoolExecutor(max_workers=num_threads,
                                  thread_name_prefix="al-gather")
    try:
        pending: deque = deque()
        it = iter(items)
        for item in itertools.islice(it, num_threads + max(1, prefetch)):
            pending.append(executor.submit(fn, item))
        while pending:
            result = pending.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                pending.append(executor.submit(fn, nxt))
            yield result
    finally:
        executor.shutdown(wait=False, cancel_futures=True)


def iterate_batches(
    dataset: Dataset,
    idxs: np.ndarray,
    batch_size: int,
    shuffle: bool = False,
    rng: Optional[np.random.Generator] = None,
    drop_last: bool = False,
    prefetch: int = 2,
    num_threads: int = 0,
    s2d: bool = False,
    rows: Optional[slice] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield fixed-shape host batches (space-to-depth with ``s2d``);
    with ``num_threads > 0`` worker threads gather ahead (at most
    ``num_threads + prefetch`` batches in flight) and batches still come
    out in order."""
    batches = batch_index_lists(idxs, batch_size, shuffle=shuffle, rng=rng,
                                drop_last=drop_last)
    yield from ordered_map(
        lambda b: gather_batch(dataset, b, batch_size, s2d, rows), batches,
        num_threads, prefetch)


def train_feed_batches(
    dataset: Dataset,
    idxs: np.ndarray,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    shuffle: bool = True,
    num_workers: int = 0,
    prefetch: int = 2,
    s2d: bool = False,
    rows: Optional[slice] = None,
    put=None,
    depth: int = 2,
):
    """The prefetched host train feed: ``num_workers`` gather/decode
    threads assemble fixed-shape batches in order, and with ``put``
    (``data/cache.device_put``) a feeder thread puts batch n+1 on the
    device while batch n computes, ``depth`` batches deep
    (``data/cache.device_prefetch``).  Batch membership and order are
    exactly ``iterate_batches(shuffle=True)``'s, so the stream is the
    serial loop's bit for bit at the same ``rng`` state: workers and
    prefetch change the wall clock only."""
    batches = iterate_batches(dataset, idxs, batch_size, shuffle=shuffle,
                              rng=rng, num_threads=num_workers,
                              prefetch=prefetch, s2d=s2d, rows=rows)
    if put is None:
        return batches
    from .cache import device_prefetch
    return device_prefetch(batches, put, depth=max(1, depth))


def num_batches(n: int, batch_size: int, drop_last: bool = False) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)
