"""Host-side batching (the JAX package's ``data/pipeline.py``, host feed
only).

Batches are fixed-shape: the last one is padded with copies of its
first row and masked.  Batch order and membership come from explicit
index math on an injected ``np.random.Generator``, so at the same
generator state the port's batches are bit-identical to the JAX
package's.  Every batch carries the pool indices of its rows.
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


def gather_batch(dataset: Dataset, batch_idxs: np.ndarray,
                 batch_size: int) -> Dict[str, np.ndarray]:
    """One fixed-shape batch: uint8 images, int32 labels and pool
    indices, float32 validity mask (0 on padding rows)."""
    idxs, mask = padded_batch_layout(batch_idxs, batch_size)
    n_real = int(mask.sum())
    images = dataset.gather(idxs[:n_real])
    if n_real < len(idxs):
        pad_img = dataset.gather(idxs[n_real:n_real + 1])
        images = np.concatenate(
            [images, np.repeat(pad_img, len(idxs) - n_real, axis=0)], axis=0)
    labels = dataset.targets[idxs]
    return {"image": images, "label": labels.astype(np.int32),
            "index": np.asarray(idxs, dtype=np.int32), "mask": mask}


def iterate_batches(
    dataset: Dataset,
    idxs: np.ndarray,
    batch_size: int,
    shuffle: bool = False,
    rng: Optional[np.random.Generator] = None,
    drop_last: bool = False,
    prefetch: int = 2,
    num_threads: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield fixed-shape host batches; with ``num_threads > 0`` worker
    threads gather ahead (at most ``num_threads + prefetch`` batches in
    flight) and batches still come out in order."""
    batches = batch_index_lists(idxs, batch_size, shuffle=shuffle, rng=rng,
                                drop_last=drop_last)
    if num_threads <= 0:
        for b in batches:
            yield gather_batch(dataset, b, batch_size)
        return

    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    executor = ThreadPoolExecutor(max_workers=num_threads,
                                  thread_name_prefix="al-gather")
    try:
        pending: deque = deque()
        it = iter(batches)
        for b in itertools.islice(it, num_threads + max(1, prefetch)):
            pending.append(executor.submit(gather_batch, dataset, b,
                                           batch_size))
        while pending:
            batch = pending.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                pending.append(executor.submit(gather_batch, dataset, nxt,
                                               batch_size))
            yield batch
    finally:
        executor.shutdown(wait=False, cancel_futures=True)


def num_batches(n: int, batch_size: int, drop_last: bool = False) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)
