"""The port's scoring service on the CPU, over real HTTP, against the JAX
package.

The experiment directory is written by the JAX package itself: a small
SSLResNet18 (CIFAR stem, 10 classes, 16x16 rows) published with its own
``train/checkpoint.publish_best``.  The port serves it with
``--device cpu``.  Contracts:

* served scores equal the JAX ``make_prob_stats_step`` on the same
  variables: ``pred`` exact, confidence/margin/entropy within 1e-5 (the
  same float32 network, convolutions summed in another order);
* served scores are bit-identical to the port's own step at the served
  bucket;
* the 413 / 429 (+ Retry-After) / 503 admission rules, and the bucket
  ladder of ``serve_buckets``;
* the CLI verb starts, answers, and drains on SIGTERM with exit 0.
"""

from __future__ import annotations

import asyncio
import base64
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from active_learning_tpu.data.core import CIFAR10_NORM as JAX_CIFAR10_NORM
from active_learning_tpu.data.core import ViewSpec as JaxViewSpec
from active_learning_tpu.models.factory import get_network as jax_get_network
from active_learning_tpu.serve.batcher import serve_buckets as jax_buckets
from active_learning_tpu.strategies import scoring as jax_scoring
from active_learning_tpu.train import checkpoint as jax_ckpt

from active_learning_tpu_torch import __main__ as port_main
from active_learning_tpu_torch.config import ServeConfig
from active_learning_tpu_torch.device import resolve_device
from active_learning_tpu_torch.serve import cli
from active_learning_tpu_torch.serve.batcher import serve_buckets
from active_learning_tpu_torch.serve.executor import DeviceExecutor
from active_learning_tpu_torch.serve.server import ScoringServer
from active_learning_tpu_torch.strategies.scoring import make_prob_stats_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 16
IMG = (HW, HW, 3)


def _jax_variables(seed: int):
    """Variables of the JAX SSLResNet18 (CIFAR stem): init from a
    PRNGKey, running statistics and head redrawn from a numpy seed so the
    scores are far from uniform."""
    model = jax_get_network("cifar10", "SSLResNet18")
    v = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed), np.zeros((1, HW, HW, 3), np.float32),
        train=False))
    rng = np.random.default_rng(seed)

    def redraw(tree):
        for k, val in tree.items():
            if isinstance(val, dict):
                redraw(val)
            elif k == "mean":
                tree[k] = (rng.standard_normal(val.shape) * 0.2).astype(
                    np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)

    redraw(v["batch_stats"])
    v["params"]["linear"]["kernel"] = (rng.standard_normal(
        v["params"]["linear"]["kernel"].shape) * 0.5).astype(np.float32)
    return model, v


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    exp_dir = str(tmp_path_factory.mktemp("torch_serve") / "exp_abc")
    os.makedirs(exp_dir)
    model, variables = _jax_variables(0)
    jax_ckpt.publish_best(os.path.join(exp_dir, "best_rd_0.msgpack"),
                          variables, round_idx=0, epoch=2)
    with open(os.path.join(exp_dir, "experiment_state.json"), "w") as fh:
        json.dump({"config": {"dataset": "cifar10", "model": "SSLResNet18",
                              "arg_pool": "default"}}, fh)
    return exp_dir, model, variables


class _Stack:
    """Server + executor on a private event-loop thread, with plain
    urllib client helpers."""

    def __init__(self, executor, cfg):
        self.executor = executor
        self.server = ScoringServer(executor, cfg)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(
            target=lambda: (asyncio.set_event_loop(self.loop),
                            self.loop.run_forever()), daemon=True)
        self.thread.start()
        self.call(self.server.start(), timeout=120)
        self.port = self.server.port

    def call(self, coro, timeout=60):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def get(self, path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}{path}", timeout=30) as r:
            return r.status, json.loads(r.read())

    def post(self, path, obj, timeout=60):
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}{path}",
            data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read()), dict(r.headers)
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}"), dict(e.headers)

    def close(self):
        try:
            self.call(self.server.drain(), timeout=60)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=10)


@pytest.fixture(scope="module")
def stack(experiment):
    exp_dir, _, _ = experiment
    args = cli.get_parser().parse_args(
        ["--experiment_dir", exp_dir, "--device", "cpu", "--image_size",
         str(HW)])
    model, view, image_size, _ = cli.resolve_serve_setup(args)
    ex = DeviceExecutor(model, view, torch.device("cpu"),
                        (image_size, image_size, 3), ckpt_dir=exp_dir,
                        reload_every_s=0.0)
    st = _Stack(ex, ServeConfig(port=0, max_batch=8, max_latency_ms=5.0,
                                queue_depth=64, bucket_floor=8))
    yield st
    st.close()


def _rows(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *IMG),
                                                dtype=np.uint8)


def test_served_scores_match_the_jax_step(stack, experiment):
    _, jax_model, variables = experiment
    rows = _rows(5)
    status, resp, _ = stack.post("/v1/score", {"instances": rows.tolist()})
    assert status == 200 and resp["round"] == 0
    step = jax_scoring.make_prob_stats_step(
        jax_model, JaxViewSpec(JAX_CIFAR10_NORM, augment=False))
    ref = {k: np.asarray(v) for k, v in step(variables,
                                             {"image": rows}).items()}
    served = {k: np.asarray([r[k] for r in resp["scores"]])
              for k in ("pred", "confidence", "margin", "entropy")}
    np.testing.assert_array_equal(served["pred"], ref["pred"])
    for k in ("confidence", "margin", "entropy"):
        np.testing.assert_allclose(served[k], ref[k], rtol=0, atol=1e-5)
    # Non-trivial scores: the test would pass vacuously on uniform ones.
    assert served["confidence"].max() > 0.2


def test_served_scores_are_the_ports_step_at_the_bucket(stack):
    rows = _rows(3, seed=1)
    _, resp, _ = stack.post("/v1/score", {"instances": rows.tolist()})
    batch = np.concatenate([rows, np.repeat(rows[:1], 5, axis=0)])  # 8
    direct = make_prob_stats_step(stack.executor.view)(
        stack.executor.model, {"image": torch.from_numpy(batch)})
    for k in ("pred", "confidence", "margin", "entropy"):
        served = np.asarray([r[k] for r in resp["scores"]],
                            dtype=direct[k].numpy().dtype)
        assert np.array_equal(served, direct[k].numpy()[:3]), k


def test_predict_embedding_and_b64(stack):
    rows = _rows(2, seed=2)
    status, resp, _ = stack.post("/v1/predict",
                                 {"instances": rows.tolist()})
    assert status == 200
    assert set(resp["predictions"][0]) == {"pred", "confidence", "margin"}
    status, resp, _ = stack.post("/v1/score", {
        "b64": base64.b64encode(rows.tobytes()).decode(),
        "shape": list(rows.shape), "embedding": True})
    assert status == 200
    assert np.asarray(resp["embedding"]).shape == (2, 512)
    _, resp2, _ = stack.post("/v1/score", {"instances": rows.tolist()})
    assert resp["scores"] == resp2["scores"]


def test_healthz_and_metrics(stack):
    status, h = stack.get("/healthz")
    assert status == 200 and h["ok"] and h["image_shape"] == list(IMG)
    assert h["buckets"] == [8]
    stack.post("/v1/score", {"instances": _rows(1).tolist()})
    status, m = stack.get("/metrics")
    assert status == 200
    # CPU tensors take the plain versions: the kernels never launched.
    assert m["kernels"]["launches"] == {"prob_stats": 0, "bn_act": 0}
    assert m["executor"]["warm_buckets"] == [8]
    assert m["latency_ms"]["n"] >= 1 and m["rows_served"] >= 1
    assert m["score_drift"]["live"]["n"] >= 1
    with pytest.raises(urllib.error.HTTPError) as e:
        stack.get("/metrics?format=prometheus")
    assert e.value.code == 400


def test_bad_requests(stack):
    assert stack.post("/v1/score", {"instances": []})[0] == 400
    assert stack.post("/v1/score", {})[0] == 400
    wrong = np.zeros((1, 4, 4, 3), np.uint8)
    assert stack.post("/v1/score", {"instances": wrong.tolist()})[0] == 400
    assert stack.post("/v1/score",
                      {"b64": "AAAA", "shape": [1, 8.5, 8, 3]})[0] == 400
    assert stack.post("/v1/profile", {"seconds": 1})[0] == 404
    # More rows than queue_depth can never be admitted: 413, not 429.
    status, resp, _ = stack.post("/v1/score",
                                 {"instances": _rows(65).tolist()})
    assert status == 413 and "queue_depth" in resp["error"]


def test_hot_reload_serves_the_new_round(stack, experiment):
    exp_dir, _, variables = experiment
    rows = _rows(2, seed=3)
    _, before, _ = stack.post("/v1/score", {"instances": rows.tolist()})
    v1 = jax.tree.map(np.copy, variables)
    v1["params"]["linear"]["bias"] = v1["params"]["linear"]["bias"] + \
        np.linspace(-3, 3, 10).astype(np.float32)
    path = os.path.join(exp_dir, "best_rd_1.msgpack")
    jax_ckpt.publish_best(path, v1, round_idx=1, epoch=0)
    try:
        _, after, _ = stack.post("/v1/score", {"instances": rows.tolist()})
        assert after["round"] == 1 and before["round"] == 0
        assert after["scores"] != before["scores"]
        assert stack.get("/metrics")[1]["executor"]["reloads"] == 1
    finally:
        os.remove(path)
        os.remove(path + ".tag.json")


class _HoldingExecutor:
    """Stub executor that holds every batch until ``release()``."""

    def __init__(self):
        self.image_shape = IMG
        self.served_round = 0
        self.stats = {}
        self._lock = threading.Lock()
        self.held = []

    def warmup(self, buckets):
        pass

    def start(self):
        pass

    def stop(self):
        pass

    def submit_batch(self, host_batch, entries, want_embed):
        self.held.append(entries)

    def release(self):
        for entries in self.held:
            for e in entries:
                out = {k: np.zeros(e.n, np.float32)
                       for k in ("confidence", "margin", "entropy")}
                out["pred"] = np.zeros(e.n, np.int32)
                out["round"] = 0
                e.future.get_loop().call_soon_threadsafe(
                    e.future.set_result, out)
        self.held = []


def test_admission_429_then_503():
    ex = _HoldingExecutor()
    st = _Stack(ex, ServeConfig(port=0, max_batch=8, max_latency_ms=1.0,
                                queue_depth=8, bucket_floor=8))
    try:
        first = {}
        t = threading.Thread(target=lambda: first.update(
            r=st.post("/v1/score", {"instances": _rows(8).tolist()})))
        t.start()
        deadline = time.monotonic() + 30
        while not ex.held and time.monotonic() < deadline:
            time.sleep(0.01)
        status, resp, headers = st.post("/v1/score",
                                        {"instances": _rows(1).tolist()})
        assert status == 429 and headers.get("Retry-After") == "1"
        st.loop.call_soon_threadsafe(ex.release)
        t.join(30)
        assert not t.is_alive() and first["r"][0] == 200
        st.server._draining = True
        status, resp, _ = st.post("/v1/score",
                                  {"instances": _rows(1).tolist()})
        assert status == 503
    finally:
        st.server._draining = False
        st.close()


@pytest.mark.parametrize("max_batch,floor", [(64, 8), (8, 8), (100, 4),
                                             (1, 8), (300, 16)])
def test_bucket_ladder_matches_jax(max_batch, floor):
    assert serve_buckets(max_batch, floor) == jax_buckets(max_batch, floor)


def test_device_resolution_never_falls_back():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            resolve_device(None)
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_unknown_verb_exits_2(capsys, tmp_path):
    assert port_main.main(["train"]) == 2
    assert "not ported" in capsys.readouterr().err
    # No verb is the experiment command.  Its default dataset, cifar10,
    # is ported, so the flags parse and the run reaches the data layer:
    # no batches under the directory, and no --download_data.
    with pytest.raises(FileNotFoundError, match="download"):
        port_main.main(["--device", "cpu", "--dataset_dir",
                        str(tmp_path / "data"), "--log_dir",
                        str(tmp_path / "logs"), "--ckpt_path",
                        str(tmp_path / "ckpt")])


def test_cli_serves_and_drains_on_sigterm(experiment, tmp_path):
    exp_dir, _, _ = experiment
    proc = subprocess.Popen(
        [sys.executable, "-m", "active_learning_tpu_torch", "serve",
         "--experiment_dir", exp_dir, "--port", "0", "--device", "cpu",
         "--image_size", str(HW), "--max_batch", "8",
         "--log_dir", str(tmp_path)],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        port = None
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
        assert port is not None, "server never logged its port"
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/predict",
            data=json.dumps({"instances": _rows(1).tolist()}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            assert len(json.loads(r.read())["predictions"]) == 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        proc.stderr.close()
