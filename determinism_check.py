"""Does the port's training repeat itself bit for bit in a new process, and
what does cuDNN's deterministic mode cost?

    python3 determinism_check.py [--out PATH]

Runs on one card.  Each turn is a fresh process that trains two of the
port's paths from the same seeds and writes a digest of the result:

  * path a: ``Trainer.fit`` on full-width SSLResNet50 (default/imagenet
    TrainConfig, bf16, BatchNorm in training mode, B = 128, 224x224x3,
    1000 classes), 512 train and 128 validation rows, 3 epochs;
  * phase 20's step: full-width SSLResNet18 (CIFAR stem) fine-tuned from
    a seeded SimCLR-layout checkpoint with BatchNorm in eval mode (the
    imbalanced CIFAR arg pool, B = 128, 32x32x3, 10 classes), 512 train
    and 128 validation rows, 3 epochs.

The digest is a sha256 of every parameter, BatchNorm buffer and momentum
buffer after the fit, and of the fit's history.  Then each turn times 20
train steps of each path on one fixed batch (host clock around the
steps with the device synchronized, and CUDA events).

Turns run in the order default, deterministic, deterministic, default
(``torch.backends.cudnn.deterministic`` False or True, ``benchmark``
False in both, set after the trainer is built), so each mode is held
against itself across two processes and the timing of the two modes is
interleaved.  A last turn runs one step of each path under
``torch.use_deterministic_algorithms(True, warn_only=True)`` and lists
the operations PyTorch warns have no deterministic implementation.

Prints one JSON line per turn and, last, a summary: for each mode and
path whether the two processes agreed, which tensors differed, and the
step times.  Write the card's name and power limit beside any number
kept (the summary carries the ``nvidia-smi`` reading).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))

_TURN = r"""
import hashlib, json, os, sys, tempfile, time, warnings
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import chip_smoke as cs
from active_learning_tpu_torch.data.pipeline import gather_batch
from active_learning_tpu_torch.data.synthetic import get_data_synthetic
from active_learning_tpu_torch.experiment.arg_pools import get_train_config
from active_learning_tpu_torch.models.factory import get_network
from active_learning_tpu_torch.models.resnet import init_weights
from active_learning_tpu_torch.ops import _build
from active_learning_tpu_torch.train.trainer import Trainer
from active_learning_tpu_torch.utils.pretrained import apply_pretrained

MODE = {mode!r}
dev = torch.device("cuda", 0)
_build.build_all()
if MODE == "warn":
    torch.use_deterministic_algorithms(True, warn_only=True)
caught = []


def set_mode():
    torch.backends.cudnn.benchmark = False
    if MODE != "warn":
        torch.backends.cudnn.deterministic = MODE == "deterministic"


def raw(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return np.ascontiguousarray(t.numpy()).tobytes()


def digest(trainer, history):
    per = {{}}
    h = hashlib.sha256()
    for k, v in trainer.model.state_dict().items():
        b = raw(v)
        per[k] = hashlib.sha256(b).hexdigest()[:16]
        h.update(b)
    for i, t in enumerate(getattr(trainer.optimizer, "trace", None) or []):
        b = raw(t)
        per[f"trace.{{i}}"] = hashlib.sha256(b).hexdigest()[:16]
        h.update(b)
    h.update(json.dumps(history, sort_keys=True).encode())
    return h.hexdigest(), per


def run(name, model, cfg, data, ncls, epochs):
    train_set, test_set = data
    trainer = Trainer(model, cfg, ncls, dev)
    set_mode()
    out = {{"path": name, "mode": MODE}}
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        if MODE == "warn":
            bs = cfg.loader_tr.batch_size
            batch = trainer.to_device(gather_batch(train_set, np.arange(bs),
                                                   bs))
            gen = torch.Generator(device=dev).manual_seed(0)
            trainer.model.train(trainer.train_bn)
            trainer.train_step(batch, 0.1, torch.ones(ncls, device=dev),
                               train_set.view, gen)
            torch.cuda.synchronize()
            out["warnings"] = sorted({{str(x.message)[:300] for x in w}})
            return out
        t0 = time.perf_counter()
        res = trainer.fit(train_set, np.arange(len(train_set)), test_set,
                          np.arange(len(test_set)), n_epoch=epochs,
                          es_patience=epochs,
                          rng=np.random.default_rng(cs.SEED))
        torch.cuda.synchronize()
        out["fit_s"] = time.perf_counter() - t0
        out["digest"], out["per_tensor"] = digest(trainer, res.history)
        out["history"] = res.history
    bs = cfg.loader_tr.batch_size
    batch = trainer.to_device(gather_batch(train_set, np.arange(bs), bs))
    weights = torch.ones(ncls, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    trainer.model.train(trainer.train_bn)
    step = lambda: trainer.train_step(batch, 0.1, weights, train_set.view,
                                      gen)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        step()
    torch.cuda.synchronize()
    out["step_ms_host"] = (time.perf_counter() - t0) * 1e3 / 20
    out["step_ms_events"] = cs.cuda_ms(step, reps=20, warmup=2)
    return out


results = []
# Path a.
data = get_data_synthetic(n_train=512, n_test=128, num_classes=1000,
                          image_size=224, seed=cs.SEED)
model = get_network("imagenet", "SSLResNet50", num_classes=1000, device=dev)
init_weights(model, torch.Generator().manual_seed(cs.SEED))
results.append(run("fit_a", model, get_train_config("default", "imagenet"),
                   (data[0], data[1]), 1000, 3))
del model, data
torch.cuda.empty_cache()
# Phase 20's fine-tuning step.
with tempfile.TemporaryDirectory() as pre:
    ckpt = os.path.join(pre, "pretrained_ckpt", "cifar10",
                        "simclr_imb_pretrain0_1.tar")
    os.makedirs(os.path.dirname(ckpt))
    cs.write_simclr_checkpoint(ckpt)
    cfg = get_train_config("ssp_finetuning_imbalanced_cifar10_imb_0_1",
                           "imbalanced_cifar10", pre)
    data = get_data_synthetic(n_train=512, n_test=128, num_classes=10,
                              image_size=32, seed=cs.SEED)
    model = get_network("cifar10", "SSLResNet18", device=dev)
    init_weights(model, torch.Generator().manual_seed(cs.SEED))
    apply_pretrained(model, cfg.pretrained)
    results.append(run("finetune_20", model, cfg, (data[0], data[1]), 10, 3))
print("TURN " + json.dumps(results), flush=True)
"""


def turn(mode: str) -> list:
    env = dict(os.environ)
    if mode == "warn":
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    proc = subprocess.run([sys.executable, "-c", _TURN.format(
        repo=REPO, mode=mode)], capture_output=True, text=True, env=env,
        timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"turn {mode} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")]
    return json.loads(line[-1][5:])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the turns here")
    args = p.parse_args()
    turns = []
    for mode in ("default", "deterministic", "deterministic", "default",
                 "warn"):
        got = turn(mode)
        turns.append(got)
        for r in got:
            print(json.dumps({k: v for k, v in r.items()
                              if k not in ("per_tensor", "history")}),
                  flush=True)
    summary = {}
    for mode in ("default", "deterministic"):
        runs = [t for t in turns if t[0]["mode"] == mode]
        for i, path in enumerate(("fit_a", "finetune_20")):
            a, b = runs[0][i], runs[1][i]
            differ = sorted(k for k in a["per_tensor"]
                            if a["per_tensor"][k] != b["per_tensor"].get(k))
            summary[f"{mode}/{path}"] = {
                "same_bits": a["digest"] == b["digest"],
                "tensors_differing": len(differ),
                "first_differing": differ[:8],
                "history_equal": a["history"] == b["history"],
                "step_ms_host": [a["step_ms_host"], b["step_ms_host"]],
                "step_ms_events": [a["step_ms_events"],
                                   b["step_ms_events"]]}
    summary["warn"] = {r["path"]: r["warnings"] for r in turns[-1]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    summary["card"] = smi
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"turns": turns, "summary": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
