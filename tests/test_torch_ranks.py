"""Spawned ranks for the port's tests, on the CPU over gloo.  This
module holds no tests: it is the harness ``test_torch_parallel.py`` and
``test_torch_int8_sync.py`` start their ranks with.

``run_ranks(task, world, workdir, inputs)`` saves ``inputs`` under
``workdir``, starts ``world`` processes of this file, each joined to one
gloo group through a ``file://`` rendezvous in ``workdir`` (no TCP port:
parallel test workers cannot collide), runs ``TASKS[task](mesh,
inputs)`` on every rank and returns each rank's result.  Every run has a
join timeout and every collective a gloo timeout, so a hang fails the
test instead of stalling the suite.  This module imports torch and the
port only; the tests hold the results against the JAX package.
"""

from __future__ import annotations

import builtins
import dataclasses
import io
import os
import subprocess
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 120
GLOO_TIMEOUT_S = 60


def run_ranks(task: str, world: int, workdir, inputs: Any = None,
              timeout: float = JOIN_TIMEOUT_S) -> List[Any]:
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(workdir, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), task, str(r),
             str(world), workdir], cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{task}: ranks still running after "
                             f"{timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(workdir, f"rank{r}.log")) as fh:
                tail = fh.read()[-4000:]
            raise AssertionError(f"{task}: rank {r} exited with "
                                 f"{p.returncode}:\n{tail}")
    return [torch.load(os.path.join(workdir, f"out_{r}.pt"),
                       weights_only=False) for r in range(world)]


# -- tasks ------------------------------------------------------------------

def tiny_resnet(fused_stats: bool):
    """The port half of ``test_torch_train._tiny_pair``'s model."""
    from active_learning_tpu_torch.models import resnet
    model = resnet.SSLClassifier((1, 1), resnet.BasicBlock, 4,
                                 cifar_stem=True, dtype=torch.float32,
                                 fused_stats=fused_stats)
    return model.to(memory_format=torch.channels_last)


def probe_model():
    """A BatchNorm-free classifier over 8-px rows: the learning probe's
    model (``experiment/driver.py::_Probe``)."""
    from active_learning_tpu_torch.experiment.driver import _Probe
    return _Probe(8 * 8 * 3)


def build_model(kind: str, state: Dict[str, torch.Tensor], fused=True):
    model = tiny_resnet(fused) if kind == "resnet" else probe_model()
    model.load_state_dict(state)
    return model


def step_cfg(grad_allreduce: str = "f32", batch_size: int = 8):
    from active_learning_tpu_torch.config import (LoaderConfig,
                                                  OptimizerConfig,
                                                  SchedulerConfig,
                                                  TrainConfig)
    return TrainConfig(loader_tr=LoaderConfig(batch_size=batch_size),
                       loader_te=LoaderConfig(batch_size=batch_size),
                       optimizer=OptimizerConfig(name="sgd", lr=0.1,
                                                 weight_decay=5e-4,
                                                 momentum=0.9),
                       scheduler=SchedulerConfig("constant"),
                       grad_allreduce=grad_allreduce)


def one_step(mesh, inputs: Dict, mode: str) -> Dict:
    """One train step of ``inputs``' model and global batch on this rank
    (``mesh`` None: one rank), under the ``mode`` gradient sync; returns
    the new state, the loss share, the norm and the local and synced
    gradients."""
    from active_learning_tpu_torch.data.core import SYNTH_NORM, ViewSpec
    from active_learning_tpu_torch.parallel import mesh as mesh_lib
    from active_learning_tpu_torch.train.trainer import Trainer

    mesh = mesh or mesh_lib.single_rank("cpu")
    model = build_model(inputs["model"], inputs["state"],
                        inputs.get("fused", True))
    tr = Trainer(model, step_cfg(mode, len(inputs["batch"]["label"])), 4,
                 mesh=mesh)
    if inputs.get("trace") is not None:
        for t, v in zip(tr.optimizer.trace, inputs["trace"]):
            t.copy_(v)
    seen = {}
    sync = tr.sync_grads

    def recording(grads):
        seen["local"] = [g.clone() for g in grads]
        out = sync(grads)
        seen["synced"] = [g.clone() for g in out]
        if mesh.world_size > 1:
            seen["f32"] = [g.clone() for g in
                           mesh_lib.allreduce_f32(seen["local"], mesh)]
        return out

    tr.sync_grads = recording
    model.train(tr.train_bn)
    batch = inputs["batch"]
    b = len(batch["label"])
    view = ViewSpec(SYNTH_NORM, augment=inputs.get("augment", False))
    gen = None
    if view.augment:
        gen = torch.Generator().manual_seed(int(inputs["gen_seed"]))
    if mesh.world_size > 1:
        dev = mesh_lib.shard_batch(batch, mesh)
        rows = (b, mesh_lib.process_local_rows(mesh, b))
    else:
        dev, rows = tr.to_device(batch), None
    loss, gnorm = tr.train_step(dev, inputs["lr"], torch.ones(4), view,
                                gen, rows)
    return {"state": {k: v.clone() for k, v in model.state_dict().items()},
            "trace": [t.clone() for t in tr.optimizer.trace],
            "loss": float(loss), "gnorm": float(gnorm),
            "grad_sync": tr.grad_sync, "form": tr.grad_sync_form, **seen}


def task_steps(mesh, inputs):
    return {mode: one_step(mesh, inputs, mode) for mode in inputs["modes"]}


def task_int8_sync(mesh, inputs):
    from active_learning_tpu_torch.parallel import mesh as mesh_lib
    mine = inputs["per_rank"][mesh.rank]
    return {"allgather": mesh_lib.int8_allreduce(mine, mesh),
            "reduce_scatter": mesh_lib.int8_reduce_scatter(mine, mesh),
            "f32": mesh_lib.allreduce_f32(mine, mesh)}


def tiny_experiment(root: str, rounds: int = 2, **overrides):
    """A small MarginSampler experiment: the tiny ResNet over 160 16-px
    synthetic rows, 2 epochs a round, 16 labels a round."""
    from active_learning_tpu_torch.config import ExperimentConfig
    from active_learning_tpu_torch.data.synthetic import get_data_synthetic

    cfg = ExperimentConfig(
        exp_name="t", exp_hash="h0", log_dir=os.path.join(root, "logs"),
        ckpt_path=os.path.join(root, "ckpt"), dataset="synthetic",
        arg_pool="synthetic", strategy="MarginSampler", rounds=rounds,
        round_budget=16, n_epoch=2, early_stop_patience=2, device="cpu")
    cfg = dataclasses.replace(cfg, **overrides)
    data = get_data_synthetic(n_train=160, n_test=48, num_classes=4,
                              image_size=16, seed=3)
    return cfg, data


def task_eval_scores(mesh, inputs):
    from active_learning_tpu_torch.experiment import driver
    cfg, data = tiny_experiment(inputs["root"])
    strategy = driver.build_experiment(
        cfg, data=data, model=build_model("resnet", inputs["state"]),
        train_cfg=step_cfg(batch_size=10), mesh=mesh)
    idxs = np.arange(37)
    return {"eval": strategy.trainer.evaluate(data[1], np.arange(45)),
            "scores": {k: strategy.collect_scores(idxs, k)
                       for k in ("prob_stats", "embed")}}


def task_experiment(mesh, inputs):
    """run_experiment with every file this rank opens for writing or
    renames recorded."""
    from active_learning_tpu_torch.experiment import driver

    written = set()
    real_open, real_replace = builtins.open, os.replace

    def rec_open(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+"):
            written.add(os.path.abspath(str(file)))
        return real_open(file, mode, *a, **k)

    def rec_replace(src, dst, *a, **k):
        written.add(os.path.abspath(str(dst)))
        return real_replace(src, dst, *a, **k)

    cfg, data = tiny_experiment(inputs["root"], **inputs.get("cfg", {}))
    builtins.open = io.open = rec_open
    os.replace = rec_replace
    try:
        strategy = driver.run_experiment(
            cfg, data=data, model=tiny_resnet(True), mesh=mesh)
    finally:
        builtins.open = io.open = real_open
        os.replace = real_replace
    return {"written": sorted(written),
            "labeled": strategy.pool.labeled_idxs(),
            "grad_sync": strategy.trainer.grad_sync,
            "degraded": strategy.trainer.grad_allreduce_degraded}


def task_probe(mesh, inputs):
    from active_learning_tpu_torch.experiment import driver
    from active_learning_tpu_torch.parallel import mesh as mesh_lib

    out = {m: driver.run_grad_allreduce_probe(mesh, m)
           for m in ("int8", "int8_rs")}
    # A sync that loses the gradients: the probe must catch it.
    mesh_lib.int8_allreduce = lambda ts, m: [
        torch.zeros_like(t) for t in ts]
    out["broken"] = task_experiment(mesh, inputs)
    return out


TASKS = {"steps": task_steps, "int8_sync": task_int8_sync,
         "eval_scores": task_eval_scores, "experiment": task_experiment,
         "probe": task_probe}


def main(argv: List[str]) -> None:
    task, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    import torch.distributed as dist

    from active_learning_tpu_torch.parallel import mesh as mesh_lib

    mesh_lib.initialize_distributed(
        "file://" + os.path.join(workdir, "rendezvous"), world, rank,
        backend="gloo", timeout_s=GLOO_TIMEOUT_S)
    try:
        mesh = mesh_lib.make_mesh(-1, "cpu")
        inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                            weights_only=False)
        out = TASKS[task](mesh, inputs)
        torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
