"""The port's data-parallel path on N ranks, on the CPU over gloo, held
against one rank and against the JAX package's multi-device step
(``tests/test_trainer_parallel.py``, ``test_backward.py``'s probe).

Every multi-rank case runs real processes (``test_torch_ranks.py``: a
``file://`` rendezvous under ``tmp_path``, a join timeout and a gloo
timeout).  Tolerances, each with its reason:

* N ranks against one, f32 sync: the JAX tests' own ``rtol 1e-4, atol
  1e-5`` (``test_trainer_parallel.py:69-90``): the global batch's sums
  (BatchNorm statistics, the loss weight, the gradient) are taken in
  another order.  The ranks among themselves: bit-equal.
* The int8 sync: within ``N · scale / 2`` per gradient element of the
  f32 sum (``+ scale2 / 2`` for the reduce-scatter form), ``scale`` the
  block's shared absmax over 127; bit-equal across ranks.
* The port's int8 step against JAX's 2-device int8 step: both are within
  ``N · gmax / 127`` of the f32 gradient (``gmax`` the largest local
  gradient element, which bounds every block's absmax) and block their
  leaves in their own layouts (flax HWIO, torch OIHW), so the new
  parameters agree within ``lr · N · gmax / 127`` plus the f32 step's
  ``1e-5``, the momentum within ``N · gmax / 127 + 1e-5``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from active_learning_tpu.experiment import driver as jax_driver
from active_learning_tpu.parallel import mesh as jax_mesh

from active_learning_tpu_torch.experiment import driver
from active_learning_tpu_torch.models import weights
from active_learning_tpu_torch.parallel import mesh as mesh_lib

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_ranks  # noqa: E402
from test_torch_ranks import run_ranks  # noqa: E402
from test_torch_train import _tiny_pair, _train_cfgs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2
LR = 0.1


def _seeded_state(kind: str, seed: int):
    model = (test_torch_ranks.tiny_resnet(True) if kind == "resnet"
             else test_torch_ranks.probe_model())
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, v in model.state_dict().items():
            if v.is_floating_point():
                v.copy_(torch.randn(v.shape, generator=gen) * 0.2
                        + (1.0 if name.endswith(("scale", "var")) else 0.0))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _batch(seed: int, b: int = 16, real: int = None):
    rng = np.random.default_rng(seed)
    real = b if real is None else real
    images = rng.integers(0, 256, (real, 8, 8, 3), dtype=np.uint8)
    labels = rng.integers(0, 4, real).astype(np.int32)
    mask = np.ones(b, np.float32)
    if real < b:
        # Padding rows repeat the first row, masked (data/pipeline.py).
        images = np.concatenate([images, np.repeat(images[:1], b - real, 0)])
        labels = np.concatenate([labels, np.repeat(labels[:1], b - real)])
        mask[real:] = 0
    return {"image": images, "label": labels, "mask": mask}


def _trace(state, seed):
    gen = torch.Generator().manual_seed(seed)
    model = test_torch_ranks.build_model("resnet", state)
    return [torch.randn(p.shape, generator=gen) * 0.01
            for p in model.parameters()]


@pytest.fixture(scope="module")
def steps_run(tmp_path_factory):
    """One step of the tiny ResNet on N ranks under the f32, int8 and
    int8_rs syncs, from one start: an augmenting view (crop + flip drawn
    for the global batch), momentum carried in."""
    state = _seeded_state("resnet", 0)
    inputs = {"model": "resnet", "state": state, "batch": _batch(1),
              "lr": LR, "modes": ["f32", "int8", "int8_rs"],
              "augment": True, "gen_seed": 5, "trace": _trace(state, 2)}
    return run_ranks("steps", N, tmp_path_factory.mktemp("steps"),
                     inputs), inputs


def _close(a, b, rtol=1e-4, atol=1e-5, what=""):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol,
                               err_msg=what)


def test_n_rank_f32_step_equals_the_one_rank_step(steps_run):
    """Parameters, BatchNorm statistics and momentum after N ranks' step
    equal one rank's on the same global batch (gradient sum == DDP
    allreduce, global-batch BN, global augmentation draws); the loss
    shares sum to the global loss; every rank holds the same bits."""
    outs, inputs = steps_run
    ref = test_torch_ranks.one_step(None, inputs, "f32")
    got = [o["f32"] for o in outs]
    assert got[0]["grad_sync"] == "f32"
    for k, v in ref["state"].items():
        _close(got[0]["state"][k], v, what=k)
        assert torch.equal(got[1]["state"][k], got[0]["state"][k]), k
    for a, b in zip(got[0]["trace"], ref["trace"]):
        _close(a, b)
    assert sum(g["loss"] for g in got) == pytest.approx(ref["loss"],
                                                        rel=1e-5)
    assert got[0]["gnorm"] == pytest.approx(ref["gnorm"], rel=1e-4)
    assert got[0]["gnorm"] == got[1]["gnorm"]


def test_bn_running_stats_are_the_global_batch(steps_run):
    """The running statistics move by the whole global batch's, not one
    rank's rows (SyncBatchNorm): they equal one rank's step over the
    whole batch, and are far from a step over rank 0's rows alone."""
    outs, inputs = steps_run
    ref = test_torch_ranks.one_step(None, inputs, "f32")["state"]
    half = dict(inputs, batch={k: v[:8] for k, v in inputs["batch"].items()},
                augment=False)
    alone = test_torch_ranks.one_step(None, half, "f32")["state"]
    got = outs[0]["f32"]["state"]
    for key in ("encoder.bn_stem.mean", "encoder.bn_stem.var"):
        _close(got[key], ref[key], what=key)
        assert (got[key] - alone[key]).abs().max() > 1e-3, key


def test_padding_rows_do_not_change_the_update(tmp_path):
    """A global batch of 10 real rows padded to 16 (padding weight 0) on
    N ranks gives the update of the 10 real rows on one rank
    (``test_trainer_parallel.py:117``; a BatchNorm-free model, so
    padding cannot reach the statistics)."""
    state = _seeded_state("probe", 3)
    padded = {"model": "probe", "state": state,
              "batch": _batch(4, 16, real=10), "lr": LR, "modes": ["f32"]}
    real = dict(padded, batch={k: v[:10] for k, v in
                               padded["batch"].items()})
    outs = run_ranks("steps", N, tmp_path, padded)
    ref = test_torch_ranks.one_step(None, real, "f32")["state"]
    for k, v in ref.items():
        _close(outs[0]["f32"]["state"][k], v, atol=1e-6, what=k)
        _close(outs[1]["f32"]["state"][k], v, atol=1e-6, what=k)


@pytest.mark.parametrize("mode,form", [("int8", "allgather"),
                                       ("int8_rs", "reduce_scatter")])
def test_int8_step_is_within_bound_and_bit_equal_across_ranks(steps_run,
                                                              mode, form):
    """The synced gradients are the same bits on every rank, and each
    element is within the int8 sync's bound of the f32 all-reduce of the
    same step's local gradients; the ranks end the step with the same
    parameters."""
    outs, _ = steps_run
    got = [o[mode] for o in outs]
    assert got[0]["grad_sync"] == "int8" and got[0]["form"] == form
    for a, b in zip(got[0]["synced"], got[1]["synced"]):
        assert torch.equal(a, b)
    for k, v in got[0]["state"].items():
        assert torch.equal(got[1]["state"][k], v), k
    lay = mesh_lib.sync_layout(got[0]["local"], N, form)
    cpu = torch.device("cpu")
    local = torch.stack([lay.pack(g["local"], cpu) for g in got])
    synced = lay.pack(got[0]["synced"], cpu).view(-1, 256)
    f32 = lay.pack(got[0]["f32"], cpu).view(-1, 256)
    absmax = local.view(N, -1, 256).abs().amax(dim=(0, 2))
    bound = N * (absmax / 127) / 2
    if form == "reduce_scatter":
        bound = bound + synced.abs().amax(1) / 127 * 1.01 / 2
    err = (synced - f32).abs()
    slack = 1e-6 * f32.abs() + 1e-12
    assert (err <= bound[:, None] * (1 + 1e-4) + slack).all(), \
        float((err / (bound[:, None] + 1e-30)).max())


def test_two_rank_int8_step_matches_the_jax_two_device_int8_step(tmp_path):
    """The port's int8 step on 2 gloo ranks against the JAX package's
    int8 step on a 2-device mesh (``shard_map`` + its ``int8_allreduce``,
    BatchNorm through ``axis_name``), from the same carried weights,
    statistics and momentum, on the deterministic view."""
    from active_learning_tpu.data.core import ViewSpec as JaxViewSpec
    from active_learning_tpu.data.synthetic import SYNTH_NORM
    from active_learning_tpu.train.trainer import Trainer as JaxTrainer

    jmodel, variables, model = _tiny_pair(True)
    _, jax_cfg = _train_cfgs()
    jax_cfg = dataclasses.replace(jax_cfg, grad_allreduce="int8")
    rng = np.random.default_rng(7)
    trace = jax.tree.map(
        lambda v: (rng.normal(size=v.shape) * 0.01).astype(np.float32),
        variables["params"])
    batch = _batch(8)
    mesh2 = jax_mesh.make_mesh(2)
    jt = JaxTrainer(jmodel, jax_cfg, mesh2, 4)
    st = jt.init_state(jax.random.PRNGKey(0), batch["image"][:1])
    st = st.replace(params=jax.tree.map(jnp.asarray, variables["params"]),
                    batch_stats=jax.tree.map(jnp.asarray,
                                             variables["batch_stats"]),
                    opt_state={"trace": jax.tree.map(jnp.asarray, trace)})
    jbatch = dict(batch, index=np.arange(16, dtype=np.int32))
    st, loss_ref, _ = jt._train_step(
        st, jax_mesh.shard_batch(jbatch, mesh2), jax.random.PRNGKey(1),
        jnp.float32(LR), jnp.ones(4, jnp.float32),
        view=JaxViewSpec(SYNTH_NORM, augment=False))
    ref = jax.tree.map(np.asarray, {"params": st.params,
                                    "batch_stats": st.batch_stats})
    ref_trace = jax.tree.map(np.asarray, st.opt_state)

    port_trace = weights.from_flax_trace({"trace": trace})
    inputs = {"model": "resnet", "state": model.state_dict(),
              "batch": batch, "lr": LR, "modes": ["int8"],
              "trace": [port_trace[k] for k, _ in model.named_parameters()]}
    outs = run_ranks("steps", N, tmp_path, inputs)
    got = outs[0]["int8"]
    assert got["grad_sync"] == "int8" and got["form"] == "allgather"
    gmax = max(float(g.abs().max()) for o in outs
               for g in o["int8"]["local"])
    dg = N * gmax / 127
    assert sum(o["int8"]["loss"] for o in outs) == pytest.approx(
        float(loss_ref), rel=1e-5)
    model.load_state_dict(got["state"])
    flat = jax.tree_util.tree_leaves_with_path(
        weights.to_flax_variables(model.state_dict()))
    want = dict(jax.tree_util.tree_leaves_with_path(ref))
    for path, a in flat:
        tol = LR * dg + 1e-5 if path[0].key == "params" else 1e-5
        np.testing.assert_allclose(a, want[path], rtol=0, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))
    got_trace = weights.to_flax_trace(dict(zip(
        [k for k, _ in model.named_parameters()], got["trace"])))
    for a, b in zip(jax.tree.leaves(got_trace), jax.tree.leaves(ref_trace)):
        np.testing.assert_allclose(a, b, rtol=0, atol=dg + 1e-5)


def test_eval_counts_and_collect_scores_on_n_ranks_equal_one_rank(tmp_path):
    """``Trainer.evaluate`` (each rank counts its rows, the counts are
    summed) and ``collect_scores`` (each rank scores its rows of every
    batch, ``fetch`` gathers them) on N ranks give one rank's results,
    the same on every rank."""
    inputs = {"root": str(tmp_path / "n2"),
              "state": _seeded_state("resnet", 6)}
    outs = run_ranks("eval_scores", N, tmp_path / "ranks", inputs)
    ref = test_torch_ranks.task_eval_scores(
        mesh_lib.single_rank("cpu"), dict(inputs, root=str(tmp_path)))
    for o in outs:
        for k in ("count", "count_byclass", "corrects_byclass",
                  "cal_count", "cal_correct"):
            np.testing.assert_array_equal(o["eval"][k], ref["eval"][k])
        assert o["eval"]["accuracy"] == ref["eval"]["accuracy"]
        np.testing.assert_allclose(o["eval"]["cal_conf_sum"],
                                   ref["eval"]["cal_conf_sum"], rtol=1e-6)
        for kind, scores in ref["scores"].items():
            assert scores.keys() == o["scores"][kind].keys()
            for k, v in scores.items():
                assert o["scores"][kind][k].shape == v.shape == (37,) + \
                    v.shape[1:]
                if v.dtype.kind in "iub":
                    np.testing.assert_array_equal(o["scores"][kind][k], v)
                else:
                    np.testing.assert_allclose(o["scores"][kind][k], v,
                                               rtol=1e-5, atol=1e-6)
    for kind in ref["scores"]:
        for k in ref["scores"][kind]:
            np.testing.assert_array_equal(outs[0]["scores"][kind][k],
                                          outs[1]["scores"][kind][k])


def test_two_round_experiment_picks_as_one_rank_and_only_rank_0_writes(
        tmp_path):
    """``run_experiment`` over 2 rounds on N ranks labels the rows one
    rank labels, and every file of the run comes from rank 0 except
    rank 1's own log (checkpoints, metrics and experiment state are the
    coordinator's)."""
    outs = run_ranks("experiment", N, tmp_path / "ranks",
                     {"root": str(tmp_path / "n2")})
    ref = test_torch_ranks.task_experiment(mesh_lib.single_rank("cpu"),
                                      {"root": str(tmp_path / "n1")})
    for o in outs:
        np.testing.assert_array_equal(np.sort(o["labeled"]),
                                      np.sort(ref["labeled"]))
    assert len(ref["labeled"]) == 32
    rank1 = [os.path.relpath(p, tmp_path / "n2") for p in outs[1]["written"]]
    assert all(p.startswith(os.path.join("logs", "h0_"))
               and p.endswith("_p1.log") for p in rank1), rank1
    rank0 = {os.path.relpath(p, tmp_path / "n2") for p in outs[0]["written"]}
    one = {os.path.relpath(p, tmp_path / "n1") for p in ref["written"]}
    logs0 = {p for p in rank0 if p.endswith(".log")}
    assert rank0 - logs0 == {p for p in one if not p.endswith(".log")}
    assert os.path.join("ckpt", "t_h0", "experiment_state.npz") in rank0
    with open(tmp_path / "n2" / "logs" / "metrics.jsonl") as fh:
        params = [e for e in map(json.loads, fh) if e["kind"] == "params"]
    assert len(params) == 1


def test_probe_passes_and_a_broken_sync_degrades_the_run_to_f32(tmp_path):
    """On N ranks the learning probe passes both int8 wire forms within
    the JAX package's pinned bound; with a sync that loses the gradients
    the probe fails and the run trains on the f32 sync, with a warning
    and the ``grad_allreduce_degraded`` metric."""
    assert driver.INT8_PROBE_MAX_ACC_DELTA \
        == jax_driver.INT8_PROBE_MAX_ACC_DELTA == 0.05
    outs = run_ranks("probe", N, tmp_path / "ranks",
                     {"root": str(tmp_path / "run"),
                      "cfg": {"grad_allreduce": "int8", "rounds": 1}})
    for o in outs:
        for mode in ("int8", "int8_rs"):
            ok, delta = o[mode]
            assert ok and delta is not None and delta <= 0.05, (mode, delta)
        assert o["broken"]["degraded"] and o["broken"]["grad_sync"] == "f32"
    with open(tmp_path / "run" / "logs" / "metrics.jsonl") as fh:
        events = [json.loads(line) for line in fh]
    assert [e["metrics"]["grad_allreduce_degraded"] for e in events
            if e["kind"] == "metric"
            and "grad_allreduce_degraded" in e["metrics"]] == [1.0]
    log = (tmp_path / "run" / "logs").glob("*_p0.log")
    assert "FAILED the learning probe" in next(log).read_text()


def test_a_failing_kernel_launch_fails_the_run_instead_of_degrading(
        monkeypatch, tmp_path):
    """Only the probe's accuracy may degrade a run.  A kernel J launch
    that fails inside the probe (the error its wrapper raises on a CUDA
    error) ends the run on every rank, N thread ranks here: it is not
    read as a failed probe, and the run never trains on the f32 sync
    in its place."""
    from active_learning_tpu_torch.ops import int8_sync as j

    def failing(x):
        j._raise_on(700, "block_absmax")

    monkeypatch.setattr(j, "block_absmax", failing)
    built = []

    def body(mesh):
        cfg, data = test_torch_ranks.tiny_experiment(
            str(tmp_path), rounds=1, grad_allreduce="int8")
        built.append(driver.build_experiment(
            cfg, data=data, model=test_torch_ranks.tiny_resnet(True),
            mesh=mesh))

    with pytest.raises(RuntimeError, match="block_absmax kernel launch "
                                           "failed: CUDA error 700"):
        mesh_lib.run_thread_ranks(body, N, "cpu", timeout_s=60)
    assert built == []


# -- the command line ---------------------------------------------------------

def _cli(args, root):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    cmd = [sys.executable, "-m", "active_learning_tpu_torch",
           "--dataset", "synthetic", "--arg_pool", "synthetic",
           "--strategy", "MarginSampler", "--rounds", "1",
           "--round_budget", "16", "--n_epoch", "1",
           "--early_stop_patience", "2", "--device", "cpu",
           "--log_dir", str(root / "logs"), "--ckpt_path",
           str(root / "ckpt"), *args]
    # A process group of its own: on a timeout the ranks the CLI
    # spawned go down with it.
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _finish(proc, timeout=120):
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError("the CLI did not finish in time") from None
    assert proc.returncode == 0, out[-4000:]
    return out


def _metric_names(root):
    with open(root / "logs" / "metrics.jsonl") as fh:
        return [k for e in map(json.loads, fh) if e["kind"] == "metric"
                for k in e["metrics"]]


def test_cli_num_devices_2_on_cpu_runs_two_gloo_ranks(tmp_path):
    """``--device cpu --num_devices 2`` starts two gloo ranks; with
    ``--grad_allreduce int8 --scale_batch auto`` the probe passes and the
    batch scales; one metrics file, one log per rank."""
    _finish(_cli(["--num_devices", "2", "--grad_allreduce", "int8",
                  "--scale_batch", "auto", "--exp_hash", "c2"], tmp_path))
    logs = tmp_path / "logs"
    p0 = next(logs.glob("c2_*_p0.log")).read_text()
    assert next(logs.glob("c2_*_p1.log"))
    assert "rank 0 of 2 on cpu (gloo on the CPU)" in p0
    assert "learning probe passed on the allgather wire form" in p0
    assert "scale_batch=auto: global batch 256 (2 ranks x 128)" in p0
    assert "rd_test_accuracy" in _metric_names(tmp_path)


def test_cli_multi_host_flags_join_over_localhost(tmp_path):
    """Two processes started with ``--coordinator_address localhost:P
    --num_processes 2 --process_id {0,1}`` form one run: both exit 0,
    rank 0 writes the metrics and the experiment state."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [_cli(["--coordinator_address", f"localhost:{port}",
                   "--num_processes", "2", "--process_id", str(r),
                   "--exp_hash", "mh"], tmp_path) for r in range(2)]
    try:
        outs = [_finish(p) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    assert "rank 0 of 2" in outs[0]
    assert _metric_names(tmp_path).count("rd_test_accuracy") == 1
    assert (tmp_path / "ckpt" / "active_learning_mh"
            / "experiment_state.npz").exists()
