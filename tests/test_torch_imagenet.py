"""The port's ImageNet loaders and host feed, on the CPU, against the JAX
package.

Every tree is written here with PIL, seeded (``helpers.build_jpeg_tree``),
with a CMYK JPEG and a PNG beside the baseline JPEGs, so the per-file
fallback runs too.  The port's datasets decode on the CPU route
(``device="cpu"``: the copy of ``native/decode.cpp`` over libjpeg), whose
rows must equal the JAX package's native rows bit for bit; so must the
PIL path's, the crop parameters, the caches' rows and files, and the
train feed's batch stream.  The committed fixture
(``tests/fixtures/imagenet_jpeg``: 20 ImageNet-shaped JPEGs, one of them
grayscale, and ``expected.npz``, the JAX native rows at fixed crop boxes
and the sha256 of each centre-crop row) is checked against the JAX
package here; the card's nvJPEG route is held to it in
``tests/test_torch_kernels.py``.  The last tests run the ImageNet
linear-evaluation job through both CLIs on a tiny tree and compare the
picks and ``experiment_state.npz``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import shlex
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from active_learning_tpu.data import cache as jax_cache
from active_learning_tpu.data import imagenet as jax_imagenet
from active_learning_tpu.data import native as jax_native
from active_learning_tpu.data import pipeline as jax_pipeline
from active_learning_tpu.data.core import IMAGENET_NORM as JAX_NORM
from active_learning_tpu.data.core import ViewSpec as JaxViewSpec

import active_learning_tpu_torch.__main__ as port_main
from active_learning_tpu_torch import faults
from active_learning_tpu_torch.config import (ExperimentConfig, LoaderConfig,
                                              OptimizerConfig,
                                              SchedulerConfig, TrainConfig)
from active_learning_tpu_torch.data import cache, imagenet, native, pipeline
from active_learning_tpu_torch.data.core import IMAGENET_NORM, ViewSpec
from active_learning_tpu_torch.data.synthetic import get_data_synthetic
from active_learning_tpu_torch.experiment import cli, gen_jobs
from active_learning_tpu_torch.experiment.driver import build_experiment
from active_learning_tpu_torch.models import resnet
from active_learning_tpu_torch.ops import _build
from active_learning_tpu_torch.ops import crop_resize as cr
from active_learning_tpu_torch.train import checkpoint as ckpt_lib
from active_learning_tpu_torch.train.trainer import Trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from helpers import build_jpeg_tree  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
FIXTURE = os.path.join(REPO, "tests", "fixtures", "imagenet_jpeg")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small networks: one intra-op thread each, so that the test
    workers do not slow one another down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.configure(None)
    yield
    faults.configure(None)


def add_odd_files(root: str) -> None:
    """A CMYK JPEG (libjpeg cannot emit it as RGB) and a PNG."""
    from PIL import Image
    rng = np.random.default_rng(9)
    cmyk = rng.integers(0, 256, size=(50, 70, 4), dtype=np.uint8)
    Image.frombytes("CMYK", (70, 50), cmyk.tobytes()).save(
        os.path.join(root, "class0", "img_cmyk.jpg"))
    Image.fromarray(rng.integers(0, 256, size=(60, 45, 3),
                                 dtype=np.uint8)).save(
        os.path.join(root, "class1", "img_png.png"))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = build_jpeg_tree(str(tmp_path_factory.mktemp("imgs") / "tree"))
    add_odd_files(root)
    return root


def _views(train: bool):
    return (JaxViewSpec(JAX_NORM, augment=train, pad=0),
            ViewSpec(IMAGENET_NORM, augment=train, pad=0))


def _pair(root, train, seed=0, use_native=True):
    jv, pv = _views(train)
    jax_ds = jax_imagenet.ImageFolderDataset(root, jv, train, num_classes=3,
                                             seed=seed)
    jax_ds._use_native = use_native
    port_ds = imagenet.ImageFolderDataset(root, pv, train, num_classes=3,
                                          seed=seed, device="cpu",
                                          use_native=use_native)
    return jax_ds, port_ds


# -- crops, listings, gather --------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_resized_crop_params_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(1, 1500, 2))
        if rng.uniform() < 0.1:
            w = h * 40 + 1      # no attempt fits: the fallback crop
        key = (seed, int(rng.integers(0, 500)), int(rng.integers(0, 10**6)))
        assert imagenet.random_resized_crop_params(
            h, w, np.random.default_rng(key)) == \
            jax_imagenet.random_resized_crop_params(
                h, w, np.random.default_rng(key))


def test_image_folder_lists_the_tree_as_jax(tree):
    for train in (True, False):
        jax_ds, port_ds = _pair(tree, train)
        assert port_ds.paths == jax_ds.paths
        np.testing.assert_array_equal(port_ds.targets, jax_ds.targets)
        assert port_ds.classes == jax_ds.classes
        assert (len(port_ds), port_ds.num_classes, port_ds.image_shape) == \
            (len(jax_ds), jax_ds.num_classes, jax_ds.image_shape)
    assert any(p.endswith(".png") for p in port_ds.paths)


def test_imbalanced_imagenet_triple_matches_jax(tree, tmp_path):
    """ImageNet-LT: file-list train and al sets over the train images,
    an ImageFolder val set."""
    data = tmp_path / "data"
    os.makedirs(data / "ImageNet_LT")
    os.symlink(tree, data / "train")
    os.symlink(tree, data / "val")
    jax_ds, _ = _pair(tree, False)
    lines = [f"{os.path.relpath(p, data / 'train').replace(os.sep, '/')}"
             for p in jax_ds.paths[::2]]
    with open(data / "ImageNet_LT" / "ImageNet_LT_train.txt", "w") as fh:
        for i, rel in enumerate(lines):
            fh.write(f"train/{rel} {(i * 7) % 3}\n")
        fh.write("malformed-line\n")
    want = jax_imagenet.get_data_imbalanced_imagenet(str(data))
    got = imagenet.get_data_imbalanced_imagenet(str(data), device="cpu")
    for w, g in zip(want, got):
        assert g.paths == w.paths and g.num_classes == w.num_classes
        np.testing.assert_array_equal(g.targets, w.targets)
        assert g.train_transform == w.train_transform
    assert len(got[0]) == len(lines)
    # debug_mode cuts each split to 50 rows, as in the JAX package.
    assert all(g._limit == 50 for g in imagenet.get_data_imbalanced_imagenet(
        str(data), debug_mode=True, device="cpu"))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "pil"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
def test_gather_is_bit_equal_to_jax(tree, train, use_native):
    """Across seeds and epochs, in a shuffled order, the CMYK JPEG and
    the PNG included (the PIL fallback of the native path)."""
    for seed in (0, 3):
        jax_ds, port_ds = _pair(tree, train, seed, use_native)
        order = np.random.default_rng(seed).permutation(len(port_ds))
        for epoch in (0, 2):
            jax_ds.set_epoch(epoch)
            port_ds.set_epoch(epoch)
            np.testing.assert_array_equal(port_ds.gather(order),
                                          jax_ds.gather(order))
    assert port_ds._use_native == use_native


def test_native_decoder_matches_jax_with_its_per_file_fallback(tree):
    _, port_ds = _pair(tree, False)
    paths = port_ds.paths
    want_dims = jax_native.jpeg_dims(paths)
    dims = native.jpeg_dims(paths, device="cpu")
    np.testing.assert_array_equal(dims[:, :2], want_dims)
    png = np.asarray([p.endswith(".png") for p in paths])
    assert (dims[png] == -1).all() and (dims[~png, 2] == 3).all()
    ok = dims[:, 0] > 0
    sel = [p for p, k in zip(paths, ok) if k]
    rng = np.random.default_rng(4)
    rects = np.asarray([(int(rng.integers(0, h // 2)),
                         int(rng.integers(0, w // 2)), h // 2, w // 2)
                        for h, w in want_dims[ok]], dtype=np.int32)
    for size in (224, 17):
        want, want_failed = jax_native.decode_crop_resize(sel, rects, size)
        got, failed = native.decode_crop_resize(sel, rects, size,
                                                device="cpu")
        np.testing.assert_array_equal(failed, want_failed)
        np.testing.assert_array_equal(got, want)
    # The CMYK file parses but does not decode: the caller's fallback.
    cmyk = [i for i, p in enumerate(sel) if p.endswith("img_cmyk.jpg")]
    assert cmyk and failed[cmyk].all() and failed.sum() == 1


def test_a_failed_build_raises_with_the_compilers_message(monkeypatch,
                                                          tmp_path):
    (tmp_path / "decode.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError,
                       match="decode.cpp \\(g\\+\\+ exit 1\\):\n.*error"):
        native.load()
    assert not [f for f in os.listdir(tmp_path / "b") if ".tmp" in f]
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load()


def test_the_cuda_route_raises_without_a_card(tree):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the CUDA route works here")
    _, pv = _views(False)
    with pytest.raises(RuntimeError, match="device cpu"):
        imagenet.ImageFolderDataset(tree, pv, False, num_classes=3)


# -- the committed fixture ----------------------------------------------------

def _fixture():
    with np.load(os.path.join(FIXTURE, "expected.npz")) as f:
        exp = {k: f[k] for k in f.files}
    exp["paths"] = [os.path.join(FIXTURE, str(n)) for n in exp["names"]]
    return exp


def test_fixture_is_the_jax_native_rows():
    exp = _fixture()
    assert 16 <= len(exp["paths"]) <= 24
    total = sum(os.path.getsize(os.path.join(FIXTURE, f))
                for f in os.listdir(FIXTURE))
    assert total <= 2_500_000
    dims = jax_native.jpeg_dims(exp["paths"])
    np.testing.assert_array_equal(dims, exp["dims"])
    assert (np.minimum(dims[:, 0], dims[:, 1]) >= 333).all()
    rows, failed = jax_native.decode_crop_resize(exp["paths"], exp["rects"],
                                                 exp["rows"].shape[1])
    assert not failed.any()
    np.testing.assert_array_equal(rows, exp["rows"])
    val, failed = jax_native.decode_crop_resize(exp["paths"],
                                                exp["val_rects"], 224)
    assert not failed.any()
    assert [hashlib.sha256(r.tobytes()).hexdigest() for r in val] == \
        list(exp["val_sha256"])


def test_cpu_route_gives_the_fixture_rows():
    exp = _fixture()
    dims = native.jpeg_dims(exp["paths"], device="cpu")
    np.testing.assert_array_equal(dims[:, :2], exp["dims"])
    rows, failed = native.decode_crop_resize(
        exp["paths"], exp["rects"], exp["rows"].shape[1], device="cpu")
    assert not failed.any()
    np.testing.assert_array_equal(rows, exp["rows"])
    val, _ = native.decode_crop_resize(exp["paths"], exp["val_rects"], 224,
                                       device="cpu")
    assert [hashlib.sha256(r.tobytes()).hexdigest() for r in val] == \
        list(exp["val_sha256"])


def _pil_decoded(paths):
    """Each file decoded whole by PIL, in the layout the CUDA route's
    decoder leaves in device memory: (src, meta without the boxes)."""
    from PIL import Image
    imgs = []
    for p in paths:
        with Image.open(p) as im:
            imgs.append(np.asarray(im if im.mode == "L"
                                   else im.convert("RGB")))
    src = np.concatenate([i.reshape(-1) for i in imgs])
    meta = np.zeros((len(imgs), 8), dtype=np.int64)
    meta[:, 0] = np.cumsum([0] + [i.size for i in imgs])[:-1]
    meta[:, 1] = [i.shape[0] for i in imgs]
    meta[:, 2] = [i.shape[1] for i in imgs]
    meta[:, 3] = [1 if i.ndim == 2 else 3 for i in imgs]
    return torch.from_numpy(src), meta


def test_crop_resize_plain_version_is_the_jax_native_arithmetic():
    """On the same decoded pixels (PIL's decode is libjpeg's) the plain
    version of the crop-resize kernel gives the JAX package's native
    rows bit for bit, the grayscale fixture (replicated into RGB) too."""
    exp = _fixture()
    src, meta = _pil_decoded(exp["paths"])
    assert meta[-1, 3] == 1
    meta[:, 4:] = exp["rects"]
    got = cr.crop_resize(src, torch.from_numpy(meta), exp["rows"].shape[1])
    np.testing.assert_array_equal(got.numpy(), exp["rows"])
    meta[:, 4:] = exp["val_rects"]
    val = cr.crop_resize(src, torch.from_numpy(meta), 224).numpy()
    assert [hashlib.sha256(r.tobytes()).hexdigest() for r in val] == \
        list(exp["val_sha256"])


def test_crop_resize_plain_version_on_edge_boxes(tree):
    """Upscaling boxes, one-pixel boxes, boxes at the far corner, and
    output sizes 1 and 300: still the JAX native rows bit for bit; a
    failed image's row is zeros; a box outside the image raises."""
    _, port_ds = _pair(tree, False)
    paths = [p for p in port_ds.paths if p.endswith("img0.jpg")][:2]
    src, meta = _pil_decoded(paths)
    for size in (1, 300, 64):
        for pick in range(4):
            rects = []
            for h, w in meta[:, 1:3]:
                rects.append([(0, 0, h, w), (h - 1, w - 1, 1, 1),
                              (h // 3, w // 4, 5, 7),
                              (h - 9, 0, 9, w)][pick])
            rects = np.asarray(rects, dtype=np.int32)
            want, _ = jax_native.decode_crop_resize(paths, rects, size)
            m = meta.copy()
            m[:, 4:] = rects
            got = cr.crop_resize(src, torch.from_numpy(m), size).numpy()
            np.testing.assert_array_equal(got, want)
    m = meta.copy()
    m[:, 4:] = (0, 0, 4, 4)
    m[0, 3] = 0                       # a failed decode
    got = cr.crop_resize(src, torch.from_numpy(m), 8).numpy()
    assert not got[0].any() and got[1].any()
    m[1, 2] += 1                      # the image overruns src
    with pytest.raises(ValueError, match="outside"):
        cr.crop_resize(src, torch.from_numpy(m), 8)


def test_jpeg_decode_bindings_match_the_c_signatures():
    """Every extern "C" function of csrc/jpeg_decode.cu is bound with as
    many ctypes arguments as it takes."""
    import re
    with open(os.path.join(_build.CSRC_DIR, "jpeg_decode.cu")) as fh:
        text = fh.read()
    body = text[text.index('extern "C" {'):]
    counts = {m.group(1): len(m.group(2).split(","))
              for m in re.finditer(r"^int (\w+)\(([^)]*)\)", body, re.M)}
    bound = {**native._ARGTYPES, **cr._ARGTYPES}
    assert set(bound) == set(counts)
    for fn, argtypes in bound.items():
        assert len(argtypes) == counts[fn], fn
    assert _build.LINK_FLAGS["jpeg_decode"] == ("-lnvjpeg",)


# -- the caches ---------------------------------------------------------------

def _counting(ds):
    calls = []
    real = ds.gather

    def gather(idxs):
        calls.append(np.asarray(idxs))
        return real(idxs)

    ds.gather = gather
    return calls


def test_cached_eval_rows_exact_and_decoded_once(tree):
    jax_ds, port_ds = _pair(tree, False)
    want = jax_ds.gather(np.arange(len(jax_ds)))
    calls = _counting(port_ds)
    rows = cache.CachedEvalRows(port_ds)
    assert rows.image_shape == port_ds.image_shape
    for _ in range(3):
        np.testing.assert_array_equal(
            rows.gather(np.asarray([4, 1, 4, 7])), want[[4, 1, 4, 7]])
    assert sorted(np.concatenate(calls).tolist()) == [1, 4, 7]
    assert rows.gather(np.zeros(0, dtype=np.int64)).shape == \
        (0, 224, 224, 3)
    # Over budget the rows are decoded again, and still exact.
    small = cache.CachedEvalRows(port_ds, max_bytes=2 * want[0].nbytes)
    np.testing.assert_array_equal(small.gather(np.arange(5)), want[:5])
    assert small._bytes == 2 * want[0].nbytes
    np.testing.assert_array_equal(small.gather(np.arange(5)), want[:5])


def test_cached_eval_rows_under_concurrent_gathers(tree):
    _, port_ds = _pair(tree, False)
    want = port_ds.gather(np.arange(len(port_ds)))
    rows = cache.CachedEvalRows(port_ds, max_bytes=7 * want[0].nbytes)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(8):
                idx = rng.integers(0, len(want), 5)
                np.testing.assert_array_equal(rows.gather(idx), want[idx])
        except AssertionError as e:
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert rows._bytes <= 7 * want[0].nbytes == rows._max_bytes


def test_decoded_pool_cache_exact_and_decoded_once_across_instances(
        tree, tmp_path):
    jax_ds, port_ds = _pair(tree, False)
    want = jax_ds.gather(np.arange(len(jax_ds)))
    calls = _counting(port_ds)
    cached = cache.maybe_wrap_decoded(port_ds, str(tmp_path), 1 << 30)
    assert isinstance(cached, cache.DecodedPoolCache)
    with pytest.raises(AttributeError):
        cached.images                 # partial: never taken for a pool
    np.testing.assert_array_equal(cached.gather(np.asarray([3, 1, 3])),
                                  want[[3, 1, 3]])
    np.testing.assert_array_equal(cached.gather(np.arange(len(want))), want)
    decoded = np.concatenate(calls)
    assert len(decoded) == len(np.unique(decoded)) == len(want)
    assert cached.decoded_rows == len(want)
    assert isinstance(cached.images, np.ndarray)
    assert cached.paths == port_ds.paths and cached.num_classes == 3
    calls.clear()
    again = cache.maybe_wrap_decoded(port_ds, str(tmp_path), 1 << 30)
    np.testing.assert_array_equal(again.gather(np.arange(len(want))), want)
    assert calls == [] and again.decoded_rows == 0


def test_decoded_pool_cache_never_serves_a_torn_row(tree, tmp_path):
    _, port_ds = _pair(tree, False)
    cached = cache.DecodedPoolCache(port_ds, str(tmp_path))
    want = port_ds.gather(np.asarray([0]))[0]
    cached.gather(np.asarray([0]))
    cached._valid[0] = 0
    cached._rows[0] = 0
    np.testing.assert_array_equal(cached.gather(np.asarray([0]))[0], want)


def test_decoded_pool_cache_eligibility_gates(tree, tmp_path):
    _, val_ds = _pair(tree, False)
    _, train_ds = _pair(tree, True)
    assert cache.maybe_wrap_decoded(train_ds, str(tmp_path), 1 << 30) \
        is train_ds
    assert cache.maybe_wrap_decoded(val_ds, str(tmp_path), 10) is val_ds
    arr_ds = get_data_synthetic(n_train=8, n_test=4)[2]
    assert cache.maybe_wrap_decoded(arr_ds, str(tmp_path), 1 << 30) \
        is arr_ds
    assert cache.maybe_wrap_decoded(val_ds, None, 1 << 30) is val_ds
    assert cache.maybe_wrap_decoded(val_ds, str(tmp_path), 0) is val_ds
    # An unusable directory is logged and skipped.
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert cache.maybe_wrap_decoded(val_ds, str(blocker / "sub"),
                                    1 << 30) is val_ds


def test_stale_caches_are_evicted_oldest_first(tree, tmp_path):
    _, ds = _pair(tree, False)
    full = len(ds) * int(np.prod(ds.image_shape))
    old = time.time() - 1e6
    for name in ("decoded_deadbeef00000000_p0", "decoded_0123456789abcdef_p0"):
        for ext in (".u8", ".valid", ".json"):
            path = str(tmp_path / name) + ext
            with open(path, "wb") as fh:
                fh.write(b"x" * 4096)
            os.utime(path, (old, old))
        old += 10
    cache.DecodedPoolCache._IN_USE.clear()
    cached = cache.maybe_wrap_decoded(ds, str(tmp_path), full + 13000)
    assert isinstance(cached, cache.DecodedPoolCache)
    left = sorted(os.listdir(tmp_path))
    assert not any("deadbeef" in f for f in left)      # the oldest went
    assert any("0123456789abcdef" in f for f in left)  # the newer fits


def test_a_cache_file_is_read_by_either_package(tree, tmp_path):
    """The CPU route's rows are the JAX package's, and so are the file
    name and layout: a cache written by one package serves the other
    with no decode."""
    jax_ds, port_ds = _pair(tree, False)
    n = len(port_ds)
    assert cache.DecodedPoolCache._signature(port_ds) == \
        jax_cache.DecodedPoolCache._signature(jax_ds)
    want = jax_ds.gather(np.arange(n))
    for writer, reader in ((port_ds, jax_ds), (jax_ds, port_ds)):
        root = str(tmp_path / type(writer).__module__.split(".")[0])
        wrap = (cache.maybe_wrap_decoded if writer is port_ds
                else jax_cache.maybe_wrap_decoded)
        wrap(writer, root, 1 << 30).gather(np.arange(n))
        read = (cache.maybe_wrap_decoded if reader is port_ds
                else jax_cache.maybe_wrap_decoded)(reader, root, 1 << 30)
        calls = _counting(reader)
        np.testing.assert_array_equal(read.gather(np.arange(n)), want)
        assert calls == []
        del reader.gather
    # Rows the card's nvJPEG route decoded are another file.
    port_ds.device = torch.device("cuda", 0)
    try:
        assert cache.DecodedPoolCache._signature(port_ds) != \
            jax_cache.DecodedPoolCache._signature(jax_ds)
    finally:
        port_ds.device = torch.device("cpu")


# -- the feed -----------------------------------------------------------------

@pytest.mark.parametrize("workers", [0, 2, 4])
def test_train_feed_stream_matches_jax(tree, workers):
    jax_ds, port_ds = _pair(tree, True, seed=2)
    jax_ds.set_epoch(5)
    port_ds.set_epoch(5)
    idxs = np.arange(3, len(port_ds))
    want = list(jax_pipeline.train_feed_batches(
        jax_ds, idxs, 4, rng=np.random.default_rng(1), num_workers=workers))
    got = list(pipeline.train_feed_batches(
        port_ds, idxs, 4, rng=np.random.default_rng(1),
        num_workers=workers))
    assert len(got) == len(want) == -(-len(idxs) // 4)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # The prefetched leg: the same batches, as tensors.
    put = cache.device_put("cpu")
    for g, item in zip(got, pipeline.train_feed_batches(
            port_ds, idxs, 4, rng=np.random.default_rng(1),
            num_workers=workers, put=put)):
        for k, v in item.wait().items():
            np.testing.assert_array_equal(v.numpy(), g[k])


def test_device_prefetch_raises_at_the_consumer_and_closes(tree):
    def broken():
        yield {"image": np.zeros(1)}
        raise RuntimeError("decode failed")

    gen = cache.device_prefetch(broken(), cache.device_put("cpu"))
    next(gen)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(gen)
    # An abandoned generator joins its feeder thread.
    before = {t for t in threading.enumerate()
              if t.name == "al-device-prefetch"}
    gen = cache.device_prefetch(({"i": np.full(1, i)} for i in range(100)),
                                cache.device_put("cpu"), depth=2)
    assert int(next(gen).wait()["i"][0]) == 0
    gen.close()
    alive = {t for t in threading.enumerate()
             if t.name == "al-device-prefetch"} - before
    assert not any(t.is_alive() for t in alive)


@pytest.mark.parametrize("spec,exc", [("feed_worker:raise@2",
                                       faults.InjectedFault),
                                      ("feed_worker:die@1",
                                       faults.ThreadDeath)])
def test_feed_worker_site_fails_the_pass_without_hanging(spec, exc):
    faults.configure(spec)
    t0 = time.perf_counter()
    with pytest.raises(exc):
        list(cache.device_prefetch(({"i": np.full(1, i)} for i in range(6)),
                                   cache.device_put("cpu")))
    assert time.perf_counter() - t0 < 10
    assert faults.fault_counters()


def _tiny_model(classes=3, filters=16):
    model = resnet.SSLClassifier((1, 1), resnet.BasicBlock, classes,
                                 cifar_stem=False, dtype=torch.float32,
                                 num_filters=filters)
    model = model.to(memory_format=torch.channels_last)
    resnet.init_weights(model, torch.Generator().manual_seed(0))
    return model


def _train_cfg(workers=0, prefetch=2, te_workers=0, **kw):
    return TrainConfig(
        eval_split=0.1,
        loader_tr=LoaderConfig(batch_size=4, num_workers=workers,
                               prefetch=prefetch),
        loader_te=LoaderConfig(batch_size=4, num_workers=te_workers),
        optimizer=OptimizerConfig(name="sgd", lr=0.05, weight_decay=5e-4,
                                  momentum=0.9),
        scheduler=SchedulerConfig(name="constant"), **kw)


def _experiment(tree, tmp_path, train_cfg, strategy="MarginSampler"):
    """A driver-built experiment over the tree; its decoded-pool cache
    under ``tmp_path``, never the user's home."""
    if train_cfg.decoded_cache_dir is None:
        train_cfg = dataclasses.replace(
            train_cfg, decoded_cache_dir=str(tmp_path / "cache"))
    _, train_ds = _pair(tree, True)
    _, al_ds = _pair(tree, False)
    _, test_ds = _pair(tree, False)
    cfg = ExperimentConfig(
        dataset="imagenet", strategy=strategy, rounds=1, round_budget=4,
        init_pool_size=4, n_epoch=1, exp_hash="t", device="cpu",
        log_dir=str(tmp_path / "logs"), ckpt_path=str(tmp_path / "ck"))
    return build_experiment(cfg, data=(train_ds, test_ds, al_ds),
                            train_cfg=train_cfg, model=_tiny_model())


def test_scoring_pass_with_workers_and_prefetch_equals_the_serial_loop(
        tree, tmp_path):
    """collect_scores gathers on the test loader's threads behind the
    device prefetch; its outputs equal a plain serial loop's bit for
    bit, and over the driver's decoded-pool cache the second pass
    decodes nothing."""
    train_cfg = _train_cfg(te_workers=3,
                           decoded_cache_dir=str(tmp_path / "cache"))
    strategy = _experiment(tree, tmp_path, train_cfg)
    assert isinstance(strategy.al_set, cache.DecodedPoolCache)
    assert isinstance(strategy.test_set, cache.DecodedPoolCache)
    assert not isinstance(strategy.train_set, cache.DecodedPoolCache)
    strategy.init_network_weights()
    idxs = np.random.default_rng(3).permutation(len(strategy.al_set))[:11]
    got = strategy.collect_scores(idxs, "embed_margin")
    assert strategy.last_scoring["decoded_rows"] == len(idxs)
    step = strategy._get_score_step("embed_margin")
    parts = {}
    with torch.inference_mode():
        for b in pipeline.batch_index_lists(idxs, 4):
            batch = pipeline.gather_batch(strategy.al_set, b, 4)
            out = step(strategy.model,
                       {"image": torch.from_numpy(batch["image"])})
            for k, v in out.items():
                v = v[:len(b)]
                if v.is_floating_point():
                    v = v.float()
                parts.setdefault(k, []).append(v.numpy())
    for k, v in parts.items():
        np.testing.assert_array_equal(got[k], np.concatenate(v), err_msg=k)
    again = strategy.collect_scores(idxs, "embed_margin")
    assert strategy.last_scoring["decoded_rows"] == 0
    for k in got:
        np.testing.assert_array_equal(again[k], got[k])
    picks, cost = strategy.query(4)
    assert cost == 4 and len(set(picks.tolist())) == 4


def test_rows_that_leave_the_native_decoder_are_counted(tree, tmp_path):
    """The native route counts the rows it hands to PIL (the CMYK JPEG
    and the PNG): in ``gather``, in the scoring pass's ``last_scoring``
    (once, then the decoded-pool cache serves them) and in the fit's
    ``last_feed``.  The PIL path by request counts none."""
    _, ds = _pair(tree, False)
    odd = [i for i, p in enumerate(ds.paths)
           if p.endswith(("img_cmyk.jpg", "img_png.png"))]
    assert len(odd) == 2
    idxs = np.arange(len(ds))
    ds.gather(idxs)
    ds.gather(idxs[odd[0]:odd[0] + 1])
    assert ds.fallback_rows == 3
    _, pil = _pair(tree, False, use_native=False)
    pil.gather(idxs)
    assert pil.fallback_rows == 0
    strategy = _experiment(tree, tmp_path, _train_cfg(te_workers=2))
    strategy.init_network_weights()
    for want in (2, 0):
        strategy.collect_scores(idxs, "embed_margin")
        assert strategy.last_scoring["fallback_rows"] == want
    _, _, trainer, _ = _fit(tree, tmp_path / "fit", _train_cfg(), n_epoch=2)
    assert trainer.last_feed["fallback_rows"] == 2 * sum(
        i < 12 for i in odd)


def test_a_feed_worker_fault_fails_the_query(tree, tmp_path):
    strategy = _experiment(tree, tmp_path, _train_cfg(te_workers=2))
    strategy.init_network_weights()
    faults.configure("feed_worker:raise@2")
    with pytest.raises(faults.InjectedFault):
        strategy.query(4)


def test_train_feed_legs(tree):
    trainer = Trainer(_tiny_model(), _train_cfg(), 3, "cpu")
    assert trainer.resolve_train_feed() == "host_prefetch"
    assert trainer.resolve_train_feed(batch_hook=print) == "host_serial"
    serial = Trainer(_tiny_model(), _train_cfg(prefetch=0), 3, "cpu")
    assert serial.resolve_train_feed() == "host_serial"
    workers = Trainer(_tiny_model(), _train_cfg(prefetch=0, feed_workers=2),
                      3, "cpu")
    assert workers._feed_workers() == 2
    assert workers.resolve_train_feed() == "host_prefetch"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(_tiny_model(), _train_cfg(train_feed="resident"), 3,
                "cpu").resolve_train_feed()
    with pytest.raises(ValueError):
        Trainer(_tiny_model(), _train_cfg(train_feed="disk"), 3,
                "cpu").resolve_train_feed()


class _EpochLog:
    """A train set that records its set_epoch calls."""

    def __init__(self, ds):
        self.ds, self.epochs = ds, []

    def set_epoch(self, epoch):
        self.epochs.append(epoch)
        self.ds.set_epoch(epoch)

    def __getattr__(self, name):
        return getattr(self.ds, name)


def _fit(tree, root, train_cfg, n_epoch=4, metric_cb=None, tag="t"):
    _, train_ds = _pair(tree, True)
    _, al_ds = _pair(tree, False)
    logged = _EpochLog(train_ds)
    trainer = Trainer(_tiny_model(), train_cfg, 3, "cpu")
    paths = ckpt_lib.weight_paths(str(root), "t", tag, round_idx=1)
    result = trainer.fit(logged, np.arange(12), al_ds, np.arange(12, 18),
                         n_epoch=n_epoch, es_patience=10,
                         rng=np.random.default_rng(7), round_idx=1,
                         weight_paths=paths, metric_cb=metric_cb)
    state = {k: v.detach().clone()
             for k, v in trainer.model.state_dict().items()}
    return result, state, trainer, logged.epochs


def test_serial_and_prefetched_fits_are_bit_identical(tree, tmp_path):
    metrics = []
    a, sa, ta, epochs = _fit(tree, tmp_path / "a", _train_cfg(prefetch=0),
                             n_epoch=2)
    b, sb, tb, _ = _fit(tree, tmp_path / "b",
                        _train_cfg(feed_workers=3, cache_eval_bytes=1),
                        n_epoch=2,
                        metric_cb=lambda n, v, s: metrics.append((n, s)))
    assert ta.last_feed["source"] == "host_serial"
    assert tb.last_feed["source"] == "host_prefetch"
    assert a.history == b.history
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    # The crop stream folds the round in: round 1 of 2 epochs.
    assert epochs == [1 * 3 + 1, 1 * 3 + 2]
    assert 0.0 <= tb.last_feed["feed_stall_frac"] <= 1.0
    assert tb.last_feed["host_wait_ms_p50"] >= 0.0
    assert [m for m in metrics if m[0].startswith(("feed", "host"))] == [
        ("feed_stall_frac", 4), ("host_wait_ms_p50", 4),
        ("feed_stall_frac", 5), ("host_wait_ms_p50", 5)]


def test_a_fit_on_a_jpeg_tree_resumes_bit_for_bit(tree, tmp_path):
    """The fit-state resume of tests/test_torch_resume.py on disk-backed
    rows: crops are a function of the epoch, so the resumed fit must
    set the train set's epoch from where it resumes."""
    class Boom(Exception):
        pass

    def boom_at(epoch):
        def cb(name, value, step):
            if step == epoch and name.endswith("validation_accuracy"):
                raise Boom()
        return cb

    cfg = _train_cfg(feed_workers=2, current_ckpt_every=2)
    ref, ref_state, _, _ = _fit(tree, tmp_path / "a", cfg)
    with pytest.raises(Boom):
        _fit(tree, tmp_path / "b", cfg, metric_cb=boom_at(3))
    resumed, state, _, epochs = _fit(tree, tmp_path / "b", cfg)
    assert epochs == [1 * 5 + 3, 1 * 5 + 4]
    assert resumed.history == ref.history[2:]
    for k in ref_state:
        assert torch.equal(state[k], ref_state[k]), k


# -- the CLI ------------------------------------------------------------------

FLAGS = ["--strategy", "RandomSampler", "--rounds", "2", "--round_budget",
         "8", "--init_pool_size", "8", "--n_epoch", "1", "--device", "cpu"]


def test_cli_takes_the_feed_flags_and_refuses_the_resident_feed(capsys):
    cfg = cli.parse(["--dataset", "imagenet", "--train_feed", "host",
                     "--feed_workers", "3", *FLAGS])
    assert (cfg.dataset, cfg.train_feed, cfg.feed_workers) == \
        ("imagenet", "host", 3)
    assert cli.parse(["--dataset", "imbalanced_imagenet", *FLAGS]
                     ).train_feed is None
    for flags in (["--train_feed", "resident"], ["--feed_workers", "-1"]):
        assert port_main.main(["--dataset", "imagenet", *FLAGS, *flags]) == 2
    assert "ROADMAP.md" in capsys.readouterr().err
    assert "--train_feed" not in cli.UNSUPPORTED_FLAGS
    assert "--feed_workers" not in cli.UNSUPPORTED_FLAGS


def test_the_linear_evaluation_commands_parse():
    jobs = [j for j in gen_jobs.all_jobs("/data") if "imagenet" in j]
    assert jobs
    for job in jobs:
        cfg = cli.parse(shlex.split(job)[3:])
        assert cfg.dataset == "imagenet" and cfg.model == "SSLResNet50"
        assert cfg.partitions == 10 and cfg.round_budget == 10000


@pytest.fixture(scope="module")
def cli_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    build_jpeg_tree(str(root / "data" / "train"), n_classes=4,
                    n_per_class=10, seed=1)
    build_jpeg_tree(str(root / "data" / "val"), n_classes=4, n_per_class=1,
                    seed=2)
    add_odd_files(str(root / "data" / "train"))
    ckpt = root / "pre" / "pretrained_ckpt" / "imagenet"
    os.makedirs(ckpt)
    # chip_smoke.py's writer: the same seeded checkpoint on both sides.
    chip_smoke.write_moco_checkpoint(
        str(ckpt / "moco_v2_800ep_pretrain.pth.tar"), 5)
    return root


def _run_clis(root, flags):
    procs = []
    for package, extra in (("active_learning_tpu_torch", ["--device", "cpu"]),
                           ("active_learning_tpu", [])):
        out = root / package / flags[flags.index("--strategy") + 1]
        env = dict(os.environ, OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu",
                   HOME=str(out / "home"))
        env.pop("XLA_FLAGS", None)
        cmd = [sys.executable, "-m", package, *flags, "--log_dir",
               str(out / "logs"), "--ckpt_path", str(out / "ckpt"), *extra]
        procs.append((out, subprocess.Popen(
            cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    outs = []
    for out, proc in procs:
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-3000:]
        outs.append((out, err))
    return outs


def _picks(out, rd):
    text = out / "logs" / "assets" / f"labeled_idxs_on_rd_{rd}.txt"
    return np.array([int(v) for v in text.read_text().split(",")])


@pytest.mark.parametrize("strategy", ["RandomSampler", "CoresetSampler"])
def test_imagenet_linear_evaluation_cli_matches_jax(cli_tree, strategy):
    """The paper's linear-evaluation job (SSLResNet50 from a MoCo-v2
    checkpoint, frozen features) through both CLIs on a 4-class tree of
    48 JPEGs: picks and experiment state bit-equal; the port decoded
    each al/test row once (its decoded-pool cache under $HOME).  The
    k-center picks of CoresetSampler are a function of the frozen
    encoder's embeddings of the decoded rows, so they hold the rows'
    way through the driver, the decoded-pool cache and the scoring
    pass; RandomSampler's picks hold the pool bookkeeping alone."""
    data = cli_tree / "data"
    flags = ["--dataset", "imagenet", "--dataset_dir", str(data),
             "--arg_pool", "ssp_linear_evaluation", "--freeze_feature",
             "--model", "SSLResNet50", "--pretrained_root",
             str(cli_tree / "pre"), "--strategy", strategy,
             "--rounds", "2", "--round_budget", "8", "--init_pool_size",
             "8", "--n_epoch", "1", "--exp_hash", "lin"]
    (port, port_err), (ref, _) = _run_clis(cli_tree, flags)
    assert "Overlaid" in port_err
    for rd in (0, 1):
        np.testing.assert_array_equal(_picks(port, rd), _picks(ref, rd))
    if strategy == "CoresetSampler":
        # The scoring pass decoded every pool row once, the tree's CMYK
        # JPEG and PNG through PIL.
        fallback = re.findall(r"; (\d+) rows decoded; (\d+) rows through "
                              r"the PIL fallback", port_err)
        assert sum(int(d) for d, _ in fallback) == 42
        assert sum(int(f) for _, f in fallback) == 2
    exp = "active_learning_lin"
    got = np.load(port / "ckpt" / exp / "experiment_state.npz")
    want = np.load(ref / "ckpt" / exp / "experiment_state.npz")
    for key in ("n_pool", "labeled", "eval_idxs", "recent",
                "cumulative_cost", "round", "invalid"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert int(got["n_pool"]) == 42
    cached = [f for f in os.listdir(port / "home" / ".cache" /
                                    "al_tpu_decoded") if f.endswith(".u8")]
    assert len(cached) == 2           # the al pool's and the test set's
