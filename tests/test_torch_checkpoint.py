"""The port's flax-msgpack codec and best-checkpoint bus
(``active_learning_tpu_torch/train/checkpoint.py``) against flax itself.

Exact: the port reads flax's bytes into an equal tree, writes the same
bytes flax writes for the same tree, and flax restores the port's bytes
into an equal tree.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import jax
from flax import serialization

from active_learning_tpu.models.resnet import resnet18 as jax_resnet18
from active_learning_tpu.train import checkpoint as jax_ckpt

from active_learning_tpu_torch.train import checkpoint as ckpt


def _tree():
    rng = np.random.default_rng(0)
    return {
        "params": {"conv": {"kernel": rng.standard_normal(
            (3, 3, 3, 8)).astype(np.float32)},
                   "ints": np.arange(300, dtype=np.int32),
                   "empty": np.zeros((0, 4), np.float32),
                   "scalar": np.float32(2.5),
                   "f64": rng.standard_normal(5)},
        "meta": {"round": 3, "neg": -70000, "big": 1 << 40, "lr": 0.1,
                 "name": "x" * 40, "none": None, "flag": True,
                 "blob": b"\x00\x01" * 200},
    }


def _assert_tree_equal(a, b):
    assert isinstance(b, dict) and sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_equal(a[k], b[k])
        elif isinstance(a[k], (np.ndarray, np.generic)):
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k] and type(a[k]) is type(b[k]), k


def test_reads_flax_bytes():
    tree = _tree()
    _assert_tree_equal(tree, ckpt.msgpack_restore(
        serialization.msgpack_serialize(tree)))


def test_writes_flax_bytes():
    tree = _tree()
    data = ckpt.msgpack_serialize(tree)
    assert data == serialization.msgpack_serialize(tree)
    _assert_tree_equal(tree, serialization.msgpack_restore(data))


def test_model_variables_round_trip_through_both(tmp_path):
    """A JAX-written model checkpoint loads in the port; the port's copy
    of it loads in the JAX package, leaf for leaf."""
    model = jax_resnet18(10, cifar_stem=True)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k, x: model.init(k, x, train=False))(
            jax.random.PRNGKey(0), np.zeros((1, 8, 8, 3), np.float32)))
    path = str(tmp_path / "best_rd_0.msgpack")
    jax_ckpt.save_variables(path, variables)
    loaded = ckpt.load_variables(path)
    _assert_tree_equal(variables, loaded)
    path2 = str(tmp_path / "port.msgpack")
    ckpt.save_variables(path2, loaded)
    _assert_tree_equal(variables, jax_ckpt.load_variables(path2))
    with open(path, "rb") as a, open(path2, "rb") as b:
        assert a.read() == b.read()


def test_reads_flax_chunked_leaves(monkeypatch):
    """Leaves above flax's chunk limit are stored as a chunk map; shrink
    the limit so a small array takes that form."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(100, dtype=np.float32).reshape(4, 25),
            "b": np.ones(3, np.float32)}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    _assert_tree_equal(tree, ckpt.msgpack_restore(data))


def test_refuses_what_it_cannot_read():
    with pytest.raises(ValueError, match="ext type"):
        ckpt.unpackb(b"\xd4\x07\x00")
    with pytest.raises(ValueError, match="truncated"):
        ckpt.unpackb(serialization.msgpack_serialize({"a": 1})[:-1])
    with pytest.raises(ValueError, match="trailing"):
        ckpt.unpackb(b"\x01\x02")
    payload = ckpt.packb([[2], "bfloat16", b"\x00" * 4])
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.unpackb(b"\xc7" + bytes([len(payload)]) + b"\x01" + payload)
    with pytest.raises(TypeError):
        ckpt.packb({1: "int key"})


def test_watcher_sees_a_newer_publish(tmp_path):
    d = str(tmp_path)
    w = ckpt.BestCkptWatcher(d)
    assert w.poll() is None
    v0 = {"params": {"linear": {"bias": np.zeros(3, np.float32)}}}
    ckpt.publish_best(os.path.join(d, "best_rd_0.msgpack"), v0,
                      round_idx=0, epoch=1)
    got = w.poll()
    assert got is not None and got[1:] == (0, (0, 1))
    assert w.poll() is None  # nothing newer
    v1 = {"params": {"linear": {"bias": np.ones(3, np.float32)}}}
    ckpt.publish_best(os.path.join(d, "best_rd_0.msgpack"), v1,
                      round_idx=0, epoch=4)
    variables, rd, tag = w.poll()
    assert (rd, tag) == (0, (0, 4))
    assert np.array_equal(variables["params"]["linear"]["bias"],
                          np.ones(3, np.float32))
    ckpt.publish_best(os.path.join(d, "best_rd_1.msgpack"), v0,
                      round_idx=1, epoch=0)
    assert ckpt.latest_best_ckpt(d) == (os.path.join(d, "best_rd_1.msgpack"),
                                        1)
    assert w.poll()[1] == 1
    # The JAX package's own watcher reads the port's publishes.
    assert jax_ckpt.read_best_tag(os.path.join(d, "best_rd_1.msgpack")) \
        == (1, 0)


def test_watcher_waits_out_a_torn_publish(tmp_path, monkeypatch):
    """Weights renamed but the tag not yet: the pairing cannot be proven,
    so the poll reports nothing until the tag lands."""
    d = str(tmp_path)
    path = os.path.join(d, "best_rd_0.msgpack")
    v = {"params": {"linear": {"bias": np.zeros(2, np.float32)}}}
    ckpt.publish_best(path, v, round_idx=0, epoch=0)
    w = ckpt.BestCkptWatcher(d)
    assert w.poll() is not None
    ckpt.save_variables(path, v)
    tags = iter([(0, 3), (0, 2)])  # the tag changes under the load
    monkeypatch.setattr(ckpt, "read_best_tag", lambda _p: next(tags))
    assert w.poll() is None
