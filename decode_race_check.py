"""Does the card's JPEG decode give the same rows when many feed threads
decode at once?

    python3 decode_race_check.py [--passes N] [--out PATH]

Runs on one card.  Writes phase 22's JPEG tree (``chip_smoke.
write_jpeg_tree``: 1,000 classes of the committed fixture files) into a
temporary directory, takes 3,000 seeded train rows, and gathers one
epoch's batch stream of the train view (B = 128) with 0 feed workers:
the reference.  Then, for two builds of ``csrc/jpeg_decode.cu``, it
gathers the same stream with 8 feed workers, N passes while matrix
products keep the card busy on a stream of their own and N passes idle,
and counts the rows that differ from the reference:

  * ``built``: the source as it is, where each decode's stream is
    synchronized before its nvJPEG state goes back to the pool;
  * ``no_sync``: the same source without that synchronization, so a
    state is used again as soon as ``nvjpegDecode`` returns, while its
    copies and inverse DCT may still be queued.

Prints one JSON line per build and pass kind, then the card's name and
power limit.  Write them beside any number kept.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

SYNC = "    const cudaError_t done = cudaStreamSynchronize(s);\n"


def no_sync_library(tmp: str) -> ctypes.CDLL:
    """``csrc/jpeg_decode.cu`` without the stream synchronization after
    each decode, built with the port's nvcc flags into ``tmp``."""
    from active_learning_tpu_torch.data import native
    from active_learning_tpu_torch.ops import _build

    with open(_build._source("jpeg_decode")) as fh:
        src = fh.read()
    if src.count(SYNC) != 1:
        raise RuntimeError("the synchronization after each decode is not "
                           "where this script expects it")
    path = os.path.join(tmp, "jpeg_decode_no_sync.cu")
    with open(path, "w") as fh:
        fh.write(src.replace(SYNC, "    const cudaError_t done = "
                                   "cudaSuccess;\n"))
    lib_path = os.path.join(tmp, "libjpeg_decode_no_sync.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, path,
                    *_build.LINK_FLAGS["jpeg_decode"]], check=True,
                   capture_output=True, timeout=600)
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in native._ARGTYPES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def stream_images(train, labeled, workers: int):
    from active_learning_tpu_torch.data.pipeline import train_feed_batches

    return [(b["index"].copy(), b["image"].copy()) for b in
            train_feed_batches(train, labeled, 128,
                               rng=np.random.default_rng(0),
                               num_workers=workers)]


def differing_rows(ref, got) -> int:
    n = 0
    for (ri, rim), (gi, gim) in zip(ref, got):
        if not np.array_equal(ri, gi):
            raise AssertionError("the batch order differs")
        n += int((rim != gim).reshape(len(rim), -1).any(1).sum())
    return n


class BusyCard:
    """Matrix products on a stream of their own until the block ends."""

    def __init__(self, dev):
        self.dev, self.stop = dev, threading.Event()
        self.thread = threading.Thread(target=self._run)

    def _run(self):
        a = torch.randn(4096, 4096, device=self.dev)
        stream = torch.cuda.Stream(self.dev)
        with torch.cuda.stream(stream):
            while not self.stop.is_set():
                for _ in range(20):
                    a = (a @ a).clamp_(-1, 1)
                stream.synchronize()

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--passes", type=int, default=3)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("decode_race_check: no CUDA device is visible", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from active_learning_tpu_torch.data import native

    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="decode_race_")
    results = []
    try:
        libs = {"built": native.load_nvjpeg(),
                "no_sync": no_sync_library(tmp)}
        data = os.path.join(tmp, "imagenet")
        cs.write_jpeg_tree(data)
        train, _, _ = cs._imagenet_sets(data, dev)
        train.set_epoch(3)
        labeled = np.sort(np.random.default_rng(0).choice(
            len(train), 3000, replace=False))
        ref = stream_images(train, labeled, 0)
        for name, lib in libs.items():
            native._nvjpeg = lib
            for busy in (True, False):
                rows, walls = [], []
                for _ in range(args.passes):
                    t0 = time.perf_counter()
                    if busy:
                        with BusyCard(dev):
                            got = stream_images(train, labeled, 8)
                    else:
                        got = stream_images(train, labeled, 8)
                    walls.append(time.perf_counter() - t0)
                    rows.append(differing_rows(ref, got))
                line = {"build": name, "card_busy": busy,
                        "rows": len(labeled), "differing_rows": rows,
                        "wall_s": walls}
                results.append(line)
                print(json.dumps(line), flush=True)
        native._nvjpeg = libs["built"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    smi = cs.card_smi()
    print(smi)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "results": results}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
