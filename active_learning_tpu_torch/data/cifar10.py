"""CIFAR-10 from disk, with a fetch path (copy of the JAX package's
``data/cifar10.py``).

Reads the standard ``cifar-10-batches-py`` pickle layout and, when the
batches are absent and the caller asks for it, fetches, md5-checks and
extracts the canonical ``cifar-10-python.tar.gz`` (``fetch_cifar10``;
``file://`` URLs work).  The digest is checked before anything is
unpacked, and members that are not plain files or directories under the
archive's root are refused.  Without the files and without network
access the loader fails with a message that says what to place where.

The dataset triple is the reference's: the augmenting train view and
the plain al view over one storage, and the test split (debug mode
keeps the first 50 rows of each).
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tarfile
import tempfile
from typing import Optional, Tuple

import numpy as np

from ..registry import DATASETS
from .core import CIFAR10_NORM, ArrayDataset, ViewSpec

_TRAIN_FILES = [f"data_batch_{i}" for i in range(1, 6)]
_TEST_FILES = ["test_batch"]

# The canonical distribution (the source torchvision uses) and the md5
# of cifar-10-python.tar.gz.
CIFAR10_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
CIFAR10_TGZ_MD5 = "c58f30108f718f92721af3b95e74349a"

_DEFAULT = object()  # late-bound to the module constants


def fetch_cifar10(data_path: str, url: Optional[str] = None,
                  expected_md5=_DEFAULT, timeout: float = 60.0) -> str:
    """Download, md5-check and extract the CIFAR-10 python batches under
    ``data_path``; returns the ``cifar-10-batches-py`` directory.  An
    existing extraction is returned as it is."""
    import urllib.request

    url = CIFAR10_URL if url is None else url
    if expected_md5 is _DEFAULT:
        expected_md5 = CIFAR10_TGZ_MD5
    dest_root = os.path.join(data_path, "cifar-10-batches-py")
    if os.path.isfile(os.path.join(dest_root, "data_batch_1")):
        return dest_root
    os.makedirs(data_path, exist_ok=True)
    digest = hashlib.md5()
    with tempfile.NamedTemporaryFile(dir=data_path, suffix=".tar.gz",
                                     delete=False) as tmp:
        try:
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    digest.update(chunk)
                    tmp.write(chunk)
            tmp.flush()
            if expected_md5 and digest.hexdigest() != expected_md5:
                raise RuntimeError(
                    f"CIFAR-10 download from {url} has md5 "
                    f"{digest.hexdigest()}, expected {expected_md5} — "
                    "corrupt or tampered archive; nothing extracted")
            with tarfile.open(tmp.name, "r:gz") as tar:
                for member in tar.getmembers():
                    # The canonical archive holds one top-level directory
                    # of flat files; absolute paths, "..", links and
                    # devices are refused.
                    parts = member.name.split("/")
                    if (member.name.startswith(("/", "..")) or ".." in parts
                            or not (member.isfile() or member.isdir())):
                        raise RuntimeError(
                            f"refusing suspicious archive member "
                            f"'{member.name}'")
                tar.extractall(data_path, filter="data")
        finally:
            os.unlink(tmp.name)
    if not os.path.isfile(os.path.join(dest_root, "data_batch_1")):
        raise FileNotFoundError(
            f"archive from {url} extracted but no "
            f"cifar-10-batches-py/data_batch_1 under {data_path}")
    return dest_root


def _load_batches(root: str, files) -> Tuple[np.ndarray, np.ndarray]:
    images, targets = [], []
    for fname in files:
        with open(os.path.join(root, fname), "rb") as fh:
            entry = pickle.load(fh, encoding="latin1")
        data = entry["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        images.append(np.ascontiguousarray(data))
        targets.extend(entry.get("labels", entry.get("fine_labels")))
    return np.concatenate(images).astype(np.uint8), np.asarray(
        targets, dtype=np.int64)


def find_cifar10_root(data_path: str, download: bool = False) -> str:
    """The directory holding ``data_batch_1``: ``data_path`` itself or
    its ``cifar-10-batches-py``; with ``download``, fetched there when
    neither has it."""
    for cand in (data_path, os.path.join(data_path, "cifar-10-batches-py")):
        if cand and os.path.isfile(os.path.join(cand, "data_batch_1")):
            return cand
    if download:
        try:
            return fetch_cifar10(data_path)
        except OSError as e:  # DNS or socket failure: no network
            raise FileNotFoundError(
                f"CIFAR-10 batches not found under '{data_path}' and the "
                f"download from {CIFAR10_URL} failed ({e!r}). Offline, "
                "place the cifar-10-batches-py directory there yourself.")
    raise FileNotFoundError(
        f"CIFAR-10 python batches not found under '{data_path}'. Expected "
        "'data_batch_1'..'data_batch_5' + 'test_batch' (the "
        "cifar-10-batches-py layout). Pass download=True (CLI: "
        "--download_data) to fetch the canonical archive, or use the "
        "'synthetic' dataset.")


def load_cifar10_arrays(data_path: str, download: bool = False):
    """((train images, train labels), (test images, test labels)):
    uint8 ``[N, 32, 32, 3]`` and int64 ``[N]``."""
    root = find_cifar10_root(data_path, download=download)
    return _load_batches(root, _TRAIN_FILES), _load_batches(root,
                                                            _TEST_FILES)


def get_data_cifar10(data_path: str, debug_mode: bool = False,
                     download: bool = False, **_unused):
    (tr_images, tr_targets), (te_images, te_targets) = load_cifar10_arrays(
        data_path, download=download)
    limit = 50 if debug_mode else None
    train_view = ViewSpec(CIFAR10_NORM, augment=True, pad=4)
    val_view = ViewSpec(CIFAR10_NORM, augment=False)
    train_set = ArrayDataset(tr_images, tr_targets, 10, train_view,
                             limit=limit)
    al_set = train_set.with_view(val_view)
    test_set = ArrayDataset(te_images, te_targets, 10, val_view, limit=limit)
    return train_set, test_set, al_set


DATASETS.register("cifar10", get_data_cifar10)
