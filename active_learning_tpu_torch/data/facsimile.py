"""Format-exact CIFAR-10 facsimile archives (copy of the JAX package's
``data/facsimile.py``).

Writes a ``cifar-10-python.tar.gz`` with the canonical archive's member
names and pickle schema (``data`` as uint8 [N, 3072] row-major RGB
planes, ``labels`` as a list, plus ``batches.meta``), with the images
drawn from the synthetic template dataset.  The fetch path (md5,
member checks, extraction) and the loader do to it what they do to the
real file; only the pixel content differs.  The same seed gives the
same bytes as the JAX package's writer, given the same gzip clock.
"""

from __future__ import annotations

import hashlib
import io
import os
import pickle
import tarfile
from typing import Tuple

import numpy as np

from .synthetic import _class_templates, _make_images

LABEL_NAMES = ["airplane", "automobile", "bird", "cat", "deer",
               "dog", "frog", "horse", "ship", "truck"]


def write_cifar10_facsimile(path: str, n_train: int = 50000,
                            n_test: int = 10000, seed: int = 77,
                            noise_sigma: float = 25.0,
                            contrast: float = 1.0) -> Tuple[str, str]:
    """Write ``cifar-10-python.tar.gz`` at ``path``; returns (path, md5).

    ``n_train`` is split over five ``data_batch_*`` files as in the
    canonical archive (10,000 rows each at full size).  ``contrast``
    scales the class templates toward mid-grey and ``noise_sigma`` sets
    the pixel noise: the task's difficulty."""
    rng = np.random.default_rng(seed)
    templates = _class_templates(10, 32, rng)
    templates = 127.5 + contrast * (templates - 127.5)

    def batch_dict(n):
        images, targets = _make_images(n, templates, rng,
                                       noise_sigma=noise_sigma)
        # HWC uint8 -> the archive's [N, 3072] R, G, B planes a row.
        data = images.transpose(0, 3, 1, 2).reshape(n, -1)
        return {"data": np.ascontiguousarray(data),
                "labels": [int(t) for t in targets]}

    per = -(-n_train // 5)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    members = []
    left = n_train
    for i in range(1, 6):
        n = min(per, left)
        left -= n
        members.append((f"data_batch_{i}", batch_dict(n)))
    members.append(("test_batch", batch_dict(n_test)))
    members.append(("batches.meta",
                    {"label_names": LABEL_NAMES,
                     "num_cases_per_batch": per, "num_vis": 3072}))

    with tarfile.open(path, "w:gz") as tar:
        for name, obj in members:
            blob = pickle.dumps(obj, protocol=2)
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    with open(path, "rb") as fh:
        md5 = hashlib.md5(fh.read()).hexdigest()
    return path, md5
