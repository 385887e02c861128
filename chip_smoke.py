"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--detail PATH]

Drives the port's serving and training paths (``active_learning_tpu_torch``)
on the card, through the entry points a user calls, and fails (non-zero
exit) if any phase fails:

1. Build: every CUDA source of the port with nvcc (all at once), and the
   Triton kernel's variants of the main path.
2. Kernels against their plain PyTorch versions, on the card, at the main
   path's shapes: kernel A (``ops/prob_stats``, CUDA) on B in {8, 64} x
   C in {10, 1000} with forced exact top-2 ties, and kernel B
   (``ops/bn_act``, Triton) on every BatchNorm shape of the SSLResNet50
   forward at B=64, in bf16 and f32, with and without residual.  Each is
   timed with CUDA events beside its plain version and its bound.
3. The slice: full-width SSLResNet50 (224x224x3, 1000 classes, bf16) with
   weights drawn from a numpy seed, published with the port's
   ``publish_best`` into a temporary experiment directory, served by the
   port's ``ScoringServer`` on 127.0.0.1 (ephemeral port, max_batch 64,
   every bucket warmed), and asked over real HTTP: /v1/predict with 1
   row, /v1/score with 17 rows, /v1/score with 64 rows and embeddings,
   then 8 more 64-row requests for latency and throughput.  Checks:
   served scores are bit-identical to the port's ``make_prob_stats_step``
   on the same rows at the same bucket; both kernels' launch counters
   rose during the requests (set to 0 just before, read just after); the
   same weights in float32 on the card agree with the port on the CPU in
   float32 (pred equal, confidence within 1e-4).

4. Training kernels against their plain versions, at the shapes of
   both training paths below: kernel B in bf16 at every BatchNorm shape
   of each path's training forward (coefficients from the batch's own
   statistics) and of its evaluation batch; kernel C (``ops/bn_train``,
   CUDA: statistics, backward reduction, dx) at every BatchNorm shape of
   the SSLResNet50 training step at B=128, 224x224, bf16 (f32 on the
   shapes with C >= 1024) and of the CLI's SSLResNet18 (CIFAR stem)
   training step, bf16, with two launches bit-equal; kernel D
   (``ops/fused_sgd``, CUDA) on every leaf of both paths' models with
   their arg pools' lr and weight decay, bit-equal at f32 state, within
   1 bf16 ulp at bf16 state.  Kernels C and D are
   timed beside their plain versions, their bounds and one PyTorch call
   of the same function (``F.batch_norm(training=True)`` forward +
   backward; ``torch.optim.SGD(fused=True).step()``); the port's whole
   BatchNorm forward + backward (kernels C and B, the ReLU mask) is
   timed beside ``F.batch_norm`` with the same residual add and ReLU.
5. The training slice, two paths, launch counters zeroed before each
   and read after: (a) the port's ``Trainer.fit`` with the
   ``default/imagenet`` TrainConfig on full-width SSLResNet50, 1000
   classes, 224x224x3, bf16, B=128: 2 epochs of 4 steps with validation,
   then a timed and profiled window of steps; (b) the experiment CLI as a
   user types it (full-width SSLResNet18, synthetic, MarginSampler, 2
   rounds) in a subprocess on the card, and the same command with
   ``--device cpu``: exit 0, both rounds tested, ``best_rd_0`` served by
   the port's ``serve`` model, round-0 indices equal between the two.
6. One float32 train step of SSLResNet18 (CIFAR stem, B=32) on the card
   against the CPU from the same numpy-seeded weights (TF32 off).

Prints the ``kernels`` JSON line, the card's name and power limit as
nvidia-smi gives them, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when no CUDA device is visible or the port is not importable.
``--detail PATH`` also writes the per-shape checks and timings as JSON.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
SEED = 0
N_TIMED = 50


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = N_TIMED, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 2: kernels against their plain versions --------------------------

def check_prob_stats(dev, detail):
    from active_learning_tpu_torch.ops import prob_stats as ps

    rng = np.random.default_rng(SEED)
    worst = 0.0
    for b in (8, 64):
        for c in (10, 1000):
            x = rng.standard_normal((b, c)).astype(np.float32) * 3.0
            # Every other row: an exact tie for the top-2, between the
            # row's argmax and a LATER index, then an earlier one.
            for r in range(0, b, 2):
                top = int(np.argmax(x[r]))
                other = (top + 1 + r) % c
                x[r, other] = x[r, top]
            logits = torch.from_numpy(x).to(dev)
            got = ps.prob_stats(logits)
            ref = ps.prob_stats_reference(logits)
            torch.cuda.synchronize()
            if not torch.equal(got["pred"], ref["pred"]):
                raise AssertionError(f"prob_stats pred differs at B={b} "
                                     f"C={c}")
            errs = {k: (got[k] - ref[k]).abs().max().item()
                    for k in ("confidence", "margin", "entropy")}
            # confidence/margin: atol 1e-6.  entropy is a sum of C float32
            # terms taken in another order than torch's: atol 1e-6 plus
            # 1e-6 of its value (2 ulp at ln 1000).
            tol_h = 1e-6 + 1e-6 * ref["entropy"].abs()
            if (errs["confidence"] > 1e-6 or errs["margin"] > 1e-6
                    or bool(((got["entropy"] - ref["entropy"]).abs()
                             > tol_h).any())):
                raise AssertionError(f"prob_stats at B={b} C={c}: {errs}")
            ties = got["margin"][0::2]
            if bool((ties != 0).any()):
                raise AssertionError("prob_stats: a tied top-2 gave a "
                                     "non-zero margin")
            worst = max(worst, *errs.values())
            detail.append({"kernel": "prob_stats", "B": b, "C": c, **errs})
    return worst


def bn_calls_of_forward(model, x):
    """(shape, has_residual, relu) of every BatchNorm call of one forward."""
    from active_learning_tpu_torch.models.resnet import BatchNorm

    calls = []

    def hook(_mod, args, kwargs, _out):
        calls.append((tuple(args[0].shape), kwargs.get("residual") is not None,
                      bool(kwargs.get("relu", False))))

    handles = [m.register_forward_hook(hook, with_kwargs=True)
               for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.inference_mode():
        model(x)
    for h in handles:
        h.remove()
    return calls


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    a = v.abs().to(torch.bfloat16)
    nxt = (a.view(torch.int16) + 1).view(torch.bfloat16)
    return nxt.float() - a.float()


def check_bn_act(dev, calls, detail, dtypes=(torch.bfloat16, torch.float32),
                 batch_stats=False, path="serve"):
    """Every distinct BN shape of ``calls``, in each of ``dtypes``, with
    and without residual, against the plain version.  With
    ``batch_stats`` the coefficients come from the input's own batch
    statistics, as in a training forward; otherwise from drawn running
    statistics, as in evaluation.  Tolerance: float32 within 1e-6 of the
    terms' magnitude (|x - shift|·|mul| + |add| + |res|); bf16 within 1
    bf16 ulp of the result plus that."""
    from active_learning_tpu_torch.ops import bn_act as ba
    from active_learning_tpu_torch.ops import bn_train as bt

    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    shapes = sorted({s for s, _, _ in calls})
    for (b, c, h, w) in shapes:
        scale = torch.rand(c, device=dev, generator=gen) + 0.5
        bias = torch.randn(c, device=dev, generator=gen) * 0.1
        mean = torch.randn(c, device=dev, generator=gen) * 0.1
        var = torch.rand(c, device=dev, generator=gen) + 0.5
        x32 = torch.randn(b, c, h, w, device=dev, generator=gen).to(
            memory_format=torch.channels_last)
        r32 = torch.randn(b, c, h, w, device=dev, generator=gen).to(
            memory_format=torch.channels_last)
        for dtype in dtypes:
            x, r = x32.to(dtype), r32.to(dtype)
            if batch_stats:
                inv = float(np.float32(1.0) / np.float32(b * h * w))
                mean, mean2 = bt.channel_sums_reference(x, x, inv)
                var = torch.clamp(mean2 - mean * mean, min=0.0)
            coeffs = ba.bn_coefficients(scale, bias, mean, var, 1e-5, dtype,
                                        fused_stats=dtype == torch.bfloat16)
            shift, mul, add = (v.view(1, -1, 1, 1) for v in coeffs)
            for res, relu in ((None, True), (None, False), (r, True)):
                got = ba.bn_act(x, coeffs, res, relu).float()
                ref = ba.bn_act_reference(x, coeffs, res, relu).float()
                terms = ((x.float() - shift).abs() * mul.abs() + add.abs()
                         + (0 if res is None else res.float().abs()))
                tol = 1e-6 * terms
                if dtype == torch.bfloat16:
                    tol = tol + _bf16_ulp(torch.maximum(got.abs(),
                                                        ref.abs()))
                diff = (got - ref).abs()
                if bool((diff > tol).any()):
                    raise AssertionError(
                        f"bn_act {dtype} {(b, c, h, w)} res={res is not None}"
                        f" relu={relu}: max diff {diff.max().item()}")
                err = diff.max().item()
                worst = max(worst, err)
                detail.append({"kernel": "bn_act", "path": path,
                               "shape": [b, c, h, w], "dtype": str(dtype),
                               "batch_stats": batch_stats,
                               "residual": res is not None,
                               "relu": relu, "max_abs_err": err})
            del x, r
        del x32, r32
        torch.cuda.empty_cache()
    return worst


def time_prob_stats(dev):
    from active_learning_tpu_torch.ops import prob_stats as ps

    b, c = 64, 1000
    logits = torch.randn(b, c, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    ms = cuda_ms(lambda: ps.prob_stats(logits))
    plain = cuda_ms(lambda: ps.prob_stats_reference(logits))
    nbytes = b * c * 4 + b * (3 * 4 + 4)
    # exp, divide, two subtracts, the p·logp product, two sums, compares.
    flops = b * c * 10
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= flops / F32_FLOPS_PER_S else "operations"}


def time_bn_act(dev, calls, detail):
    """Device time of all BatchNorm calls of one B=64 bf16 forward: the
    kernel, the plain version and the bound, summed over the calls."""
    from active_learning_tpu_torch.ops import bn_act as ba

    per = {}
    for key in sorted(set(calls)):
        (b, c, h, w), has_res, relu = key
        x = torch.randn(b, c, h, w, device=dev, dtype=torch.bfloat16).to(
            memory_format=torch.channels_last)
        r = torch.randn_like(x) if has_res else None
        ones, zeros = (torch.ones(c, device=dev), torch.zeros(c, device=dev))
        coeffs = ba.bn_coefficients(ones, zeros, zeros, ones, 1e-5,
                                    torch.bfloat16, True)
        ms = cuda_ms(lambda: ba.bn_act(x, coeffs, r, relu))
        plain = cuda_ms(lambda: ba.bn_act_reference(x, coeffs, r, relu))
        nbytes = x.numel() * 2 * (3 if has_res else 2) + 3 * c * 4
        per[key] = (ms, plain, nbytes)
        detail.append({"kernel": "bn_act", "timed_shape": [b, c, h, w],
                       "residual": has_res, "relu": relu, "ms": ms,
                       "plain_ms": plain,
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                       "calls_per_forward": calls.count(key)})
    tot = [sum(per[k][i] for k in calls) for i in range(3)]
    return {"ms": tot[0], "plain_ms": tot[1],
            "bound_ms": tot[2] / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


# -- phase 3: the slice ------------------------------------------------------

def random_variables(seed: int):
    """Full-width SSLResNet50 variables (flax tree of numpy arrays) drawn
    from a numpy seed: He-normal convolutions, BN statistics near the
    identity, the last BN of each block scaled down so the residual
    stream stays O(1) through 16 blocks."""
    from active_learning_tpu_torch.models.factory import get_network
    from active_learning_tpu_torch.models.weights import to_flax_variables

    shapes = get_network("imagenet", "SSLResNet50", dtype="float32",
                         device="cpu").state_dict()
    rng = np.random.default_rng(seed)
    sd = {}
    for key, v in shapes.items():
        shape = tuple(v.shape)
        leaf = key.rsplit(".", 1)[-1]
        if key == "linear.weight":
            a = rng.standard_normal(shape) * 0.05
        elif leaf == "weight":
            a = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif leaf == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
            if key.endswith("BatchNorm_2.scale"):
                a *= 0.2
        elif leaf == "var":
            a = rng.uniform(0.5, 1.5, shape)
        else:  # BN bias and mean, head bias
            a = 0.1 * rng.standard_normal(shape)
        sd[key] = torch.from_numpy(a.astype(np.float32))
    return to_flax_variables(sd)


def _post(port: int, path: str, payload: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())


def _b64(rows: np.ndarray) -> dict:
    return {"b64": base64.b64encode(rows.tobytes()).decode(),
            "shape": list(rows.shape)}


def run_slice(exp_dir: str):
    from active_learning_tpu_torch import ops
    from active_learning_tpu_torch.config import ServeConfig
    from active_learning_tpu_torch.serve import cli
    from active_learning_tpu_torch.serve.executor import DeviceExecutor
    from active_learning_tpu_torch.serve.server import ScoringServer
    from active_learning_tpu_torch.strategies.scoring import (
        make_embed_step, make_prob_stats_step)
    from active_learning_tpu_torch.train import checkpoint as ckpt_lib

    variables = random_variables(SEED)
    ckpt_lib.publish_best(os.path.join(exp_dir, "best_rd_0.msgpack"),
                          variables, round_idx=0, epoch=0)
    with open(os.path.join(exp_dir, "experiment_state.json"), "w") as fh:
        json.dump({"config": {"dataset": "imagenet", "model": "SSLResNet50",
                              "arg_pool": "default"}}, fh)

    args = cli.get_parser().parse_args(
        ["--experiment_dir", exp_dir, "--port", "0"])
    model, view, image_size, _ = cli.resolve_serve_setup(args)
    if model.dtype != torch.bfloat16 or model.num_classes != 1000:
        raise AssertionError(f"served model is {model.dtype}, "
                             f"{model.num_classes} classes")
    executor = DeviceExecutor(model, view, torch.device("cuda", 0),
                              (image_size, image_size, 3), ckpt_dir=exp_dir)
    cfg = ServeConfig(host="127.0.0.1", port=0)
    server = ScoringServer(executor, cfg)

    loop = asyncio.new_event_loop()
    started = threading.Event()
    stop = None

    async def serve():
        nonlocal stop
        stop = asyncio.Event()
        t0 = time.perf_counter()
        await server.start()
        log(f"server up on port {server.port}: buckets "
            f"{server.batcher.buckets} warmed in "
            f"{time.perf_counter() - t0:.1f} s")
        started.set()
        await stop.wait()
        await server.drain()

    thread = threading.Thread(target=lambda: loop.run_until_complete(serve()),
                              name="smoke-server")
    thread.start()
    if not started.wait(600):
        raise RuntimeError("server did not start")
    try:
        rng = np.random.default_rng(SEED + 1)
        hw = (image_size, image_size, 3)
        rows = {n: rng.integers(0, 256, (n, *hw), dtype=np.uint8)
                for n in (1, 17, 64)}
        load_rows = rng.integers(0, 256, (64, *hw), dtype=np.uint8)

        ops.reset_kernel_launches()
        t_start = time.perf_counter()
        lat = []
        t = time.perf_counter()
        pred1 = _post(server.port, "/v1/predict", _b64(rows[1]))
        lat.append(time.perf_counter() - t)
        t = time.perf_counter()
        score17 = _post(server.port, "/v1/score", _b64(rows[17]))
        lat.append(time.perf_counter() - t)
        t = time.perf_counter()
        score64 = _post(server.port, "/v1/score",
                        dict(_b64(rows[64]), embedding=True))
        lat.append(time.perf_counter() - t)
        n_rows = 1 + 17 + 64
        for _ in range(8):
            t = time.perf_counter()
            _post(server.port, "/v1/score", _b64(load_rows))
            lat.append(time.perf_counter() - t)
            n_rows += 64
        wall = time.perf_counter() - t_start
        launches = ops.kernel_launches()
        metrics = _get(server.port, "/metrics")
    finally:
        loop.call_soon_threadsafe(stop.set)
        thread.join(120)
    if thread.is_alive():
        raise RuntimeError("server did not drain")
    log(f"requests: {len(lat)}, latency p50 {np.median(lat) * 1e3:.2f} ms "
        f"at the client, {metrics['latency_ms']['p50']} ms in the server; "
        f"{n_rows / wall:.1f} rows/s over {wall:.2f} s")
    log(f"/metrics kernels: {metrics['kernels']}")
    if launches["prob_stats"] < 1 or launches["bn_act"] < 1:
        raise AssertionError(f"a kernel never launched on the path: "
                             f"{launches}")

    # Served == the port's own step on the same rows at the same bucket.
    step = make_prob_stats_step(view)
    embed = make_embed_step(view, with_probs=True)
    buckets = server.batcher.buckets
    for n, resp, key in ((1, pred1, "predictions"), (17, score17, "scores"),
                         (64, score64, "scores")):
        bucket = next(b for b in buckets if b >= n)
        batch = np.concatenate([rows[n], np.repeat(rows[n][:1], bucket - n,
                                                   axis=0)])
        dev = {"image": torch.from_numpy(batch).cuda()}
        direct = {k: v.cpu().numpy()[:n] for k, v in step(model, dev).items()}
        for k in ("pred", "confidence", "margin", "entropy"):
            if key == "predictions" and k == "entropy":
                continue
            served = np.asarray([r[k] for r in resp[key]],
                                dtype=direct[k].dtype)
            if not np.array_equal(served, direct[k]):
                raise AssertionError(f"served {k} of the {n}-row request "
                                     "differs from the direct step")
        if n == 64:
            emb = embed(model, dev)["embedding"].cpu().numpy()[:n]
            if not np.array_equal(np.asarray(resp["embedding"],
                                             dtype=np.float32), emb):
                raise AssertionError("served embedding differs")
            if not np.isfinite(emb).all():
                raise AssertionError("non-finite embedding")
    log("served scores are bit-identical to the direct step at each bucket")
    serving = {"client_p50_ms": float(np.median(lat) * 1e3),
               "server_p50_ms": metrics["latency_ms"]["p50"],
               "rows_per_s": n_rows / wall, "requests": len(lat),
               "rows": n_rows}
    return model, variables, view, rows, launches, serving


def profile_step(model, view, rows, steps: int = 5):
    """Where a served batch's device time goes: ``steps`` prob-stats steps
    at B=64 on device-resident rows under torch.profiler, device time
    summed by kernel, and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    from active_learning_tpu_torch.strategies.scoring import (
        make_prob_stats_step)

    step = make_prob_stats_step(view)
    batch = {"image": torch.from_numpy(rows).cuda()}
    for _ in range(3):
        step(model, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(model, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = {"wall_ms_per_step": wall_ms / steps,
           **summarize_profile(prof, steps)}
    out["device_busy_share"] = out["device_ms_per_step"] / (wall_ms / steps)
    log(f"profiled step at B=64: {wall_ms / steps:.2f} ms wall, "
        f"{out['device_ms_per_step']:.2f} ms device busy per step, "
        f"{out['kernel_launches_per_step']:.0f} kernel launches")
    return out


def summarize_profile(prof, steps: int) -> dict:
    """Per step: device time by kernel, host self time (and calls) by
    op, and the kernel launches the host issued."""
    from torch.autograd import DeviceType

    kernels, host_ops, launch_calls = {}, {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + (
                e.self_device_time_total / 1e3 / steps)
        else:
            host_ops[e.key] = (e.self_cpu_time_total / 1e3 / steps,
                               e.count / steps)
            if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                         "cudaLaunchKernelExC", "cuLaunchKernelEx"):
                launch_calls += e.count
    return {"device_ms_per_step": sum(kernels.values()),
            "top_kernels_ms_per_step": sorted(
                kernels.items(), key=lambda kv: -kv[1])[:15],
            "kernel_launches_per_step": launch_calls / steps,
            "top_host_ops_ms_and_calls_per_step": sorted(
                host_ops.items(), key=lambda kv: -kv[1][0])[:15]}


def check_f32_against_cpu(variables, view, rows):
    """The same weights in float32: the card against the CPU."""
    from active_learning_tpu_torch.device import set_float32_precision
    from active_learning_tpu_torch.models.factory import get_network
    from active_learning_tpu_torch.models.weights import load_flax_variables
    from active_learning_tpu_torch.strategies.scoring import (
        make_prob_stats_step)

    set_float32_precision(torch.float32)
    step = make_prob_stats_step(view)
    out = {}
    for device in ("cuda", "cpu"):
        model = get_network("imagenet", "SSLResNet50", dtype="float32",
                            device=device)
        load_flax_variables(model, variables)
        res = step(model, {"image": torch.from_numpy(rows).to(device)})
        out[device] = {k: v.cpu().numpy() for k, v in res.items()}
    if not np.array_equal(out["cuda"]["pred"], out["cpu"]["pred"]):
        raise AssertionError("f32 pred differs between the card and CPU")
    err = float(np.abs(out["cuda"]["confidence"]
                       - out["cpu"]["confidence"]).max())
    if err > 1e-4:
        raise AssertionError(f"f32 confidence differs by {err}")
    log(f"f32 card vs CPU on {len(rows)} rows: pred equal, confidence "
        f"max diff {err:.3g}, confidence {out['cpu']['confidence']}")


# -- phase 4: the training kernels against their plain versions -------------

BF16_BYTES = 2


def path_bn_calls(dev):
    """BatchNorm calls of the two training paths at the batch sizes they
    run, from one forward each with hooks: ``{path: (train_calls,
    eval_calls)}``.  "fit": SSLResNet50 (1000 classes, 224 px) under
    default/imagenet; "cli": SSLResNet18 with the CIFAR stem (the
    synthetic dataset's 10 classes, 32 px) under the synthetic arg pool.
    Training batches are the pool's loader batch (a short batch is
    padded to it); evaluation (validation, test, query) runs at the
    trainer's evaluation batch on the card."""
    from types import SimpleNamespace

    from active_learning_tpu_torch.experiment.arg_pools import \
        get_train_config
    from active_learning_tpu_torch.models.factory import get_network
    from active_learning_tpu_torch.train.trainer import Trainer

    out = {}
    for path, dataset, name, hw, pool in (
            ("fit", "imagenet", "SSLResNet50", 224, "default"),
            ("cli", "synthetic", "SSLResNet18", 32, "synthetic")):
        cfg = get_train_config(pool, dataset)
        model = get_network(dataset, name, device=dev)
        eval_bs = Trainer(model, cfg, model.num_classes, dev).eval_batch_size(
            SimpleNamespace(image_shape=(hw, hw, 3)))
        out[path] = tuple(
            bn_calls_of_forward(model, torch.zeros(bs, hw, hw, 3,
                                                   device=dev))
            for bs in (cfg.loader_tr.batch_size, eval_bs))
        del model
        torch.cuda.empty_cache()
    return out


def _kernel_c_inputs(shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, device=dev, generator=g) * 2 + 1).to(dtype)
    gy = torch.randn(shape, device=dev, generator=g).to(dtype)
    scale = torch.rand(shape[1], device=dev, generator=g) + 0.5
    return (x.contiguous(memory_format=torch.channels_last),
            gy.contiguous(memory_format=torch.channels_last), scale)


def _bf16_ulp_of(v: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return v.abs() * 2.0 ** -23
    return _bf16_ulp(v)


def check_bn_train(dev, calls, detail, path="fit"):
    """Kernel C at every BatchNorm shape of the step.  Tolerances: the
    four per-channel sums are float32 sums of the same terms in another
    order, within 1e-5 of the sum of the terms' magnitudes (per row count
    for the means); dx from the same coefficients is bit-equal (the same
    separately rounded operations); dx end to end (each side from its
    own sums) differs only through the coefficients, so within
    |gy|·|Δmul| + |x|·|Δc2| + |Δc1|, plus 2^-22 of |gy·mul| + |x·c2| +
    |c1| (each side's float32 rounding, which shows where the terms
    cancel), plus one ulp of the activation dtype.  Two launches on the
    same input are bit-equal."""
    from active_learning_tpu_torch.ops import bn_train as bt

    worst = 0.0
    shapes = sorted({s for s, _, _ in calls})
    dims = (0, 2, 3)
    for i, shape in enumerate(shapes):
        dtypes = [torch.bfloat16] + ([torch.float32]
                                     if shape[1] >= 1024 else [])
        for dtype in dtypes:
            x, gy, scale = _kernel_c_inputs(shape, dtype, dev, i)
            n = shape[0] * shape[2] * shape[3]
            inv = float(np.float32(1.0) / np.float32(n))
            mean, mean2 = bt.bn_stats(x)
            s1, s2 = bt.bn_bwd_reduce(gy, x)
            again = bt.bn_stats(x) + bt.bn_bwd_reduce(gy, x)
            rm, rm2 = bt.channel_sums_reference(x, x, inv)
            rs1, rs2 = bt.channel_sums_reference(gy, x)
            xf, gf = x.float(), gy.float()
            errs = {}
            for name, got, ref, mag in (
                    ("mean", mean, rm, xf.abs().sum(dims) * inv),
                    ("mean2", mean2, rm2, (xf * xf).sum(dims) * inv),
                    ("sum_gy", s1, rs1, gf.abs().sum(dims)),
                    ("sum_gy_x", s2, rs2, (gf * xf).abs().sum(dims))):
                diff = (got - ref).abs()
                if bool((diff > 1e-5 * mag + 1e-30).any()):
                    raise AssertionError(f"bn_train {name} {shape} {dtype}:"
                                         f" max diff {diff.max().item()}")
                errs[name] = diff.max().item()
            for a, b in zip(again, (mean, mean2, s1, s2)):
                if not torch.equal(a, b):
                    raise AssertionError(f"bn_train {shape} {dtype}: two "
                                         "launches differ")
            coef_k = bt.backward_coefficients(s1, s2, scale, mean, mean2,
                                              1e-5, float(n), dtype, True)
            coef_p = bt.backward_coefficients(rs1, rs2, scale, rm, rm2,
                                              1e-5, float(n), dtype, True)
            dx_same = bt.bn_dx(gy, x, *coef_p[2:])
            if not torch.equal(dx_same,
                               bt.bn_dx_reference(gy, x, *coef_p[2:])):
                raise AssertionError(f"bn_dx {shape} {dtype}: not bit-equal"
                                     " from the same coefficients")
            dx_k = bt.bn_dx(gy, x, *coef_k[2:]).float()
            dx_p = dx_same.float()
            dm, dc2, dc1 = ((a - b).abs().view(1, -1, 1, 1)
                            for a, b in zip(coef_k[2:], coef_p[2:]))
            m, k2, k1 = (v.view(1, -1, 1, 1) for v in coef_p[2:])
            terms = (gf * m).abs() + (xf * k2).abs() + k1.abs()
            tol = (gf.abs() * dm + xf.abs() * dc2 + dc1
                   + 2.0 ** -22 * terms
                   + _bf16_ulp_of(torch.maximum(dx_k.abs(), dx_p.abs()),
                                  dtype))
            diff = (dx_k - dx_p).abs()
            if bool((diff > tol).any()):
                i = int(torch.argmax(diff - tol))
                worst = [t.reshape(-1)[i].item()
                         for t in (dx_k, dx_p, gf, xf, tol)]
                raise AssertionError(
                    f"bn_train dx {shape} {dtype}: max diff "
                    f"{diff.max().item()}; worst element (dx kernel, dx "
                    f"plain, gy, x, tolerance) {worst}")
            errs["dx"] = diff.max().item()
            worst = max(worst, errs["dx"])
            detail.append({"kernel": "bn_train", "path": path,
                           "shape": list(shape), "dtype": str(dtype), **errs})
            del x, gy, xf, gf, dx_k, dx_p, dx_same, tol, diff
            torch.cuda.empty_cache()
    return worst


def time_bn_train(dev, calls, detail):
    """Over all BatchNorm calls of one bf16 training step: device time of
    kernel C (statistics + backward reduction + dx per call), its plain
    version, its bound, and ``F.batch_norm(training=True)`` forward +
    backward on the same shapes (the library call: the same function
    plus the normalize pass).  Like for like with the library, also the
    port's whole BatchNorm as the model runs it (``bn_train`` forward +
    backward: kernel C, kernel B's normalize with the call's residual
    and ReLU, the ReLU mask and the per-channel math) beside
    ``F.batch_norm`` with the same residual add and ReLU, forward +
    backward."""
    import torch.nn.functional as F

    from active_learning_tpu_torch.ops import bn_train as bt

    per, whole = {}, {}
    for shape in sorted({s for s, _, _ in calls}):
        x, gy, scale = _kernel_c_inputs(shape, torch.bfloat16, dev, 7)
        c = shape[1]
        n = shape[0] * shape[2] * shape[3]
        mul, c2, c1 = (torch.rand(c, device=dev) for _ in range(3))

        def kernel():
            bt.bn_stats(x)
            bt.bn_bwd_reduce(gy, x)
            bt.bn_dx(gy, x, mul, c2, c1)

        def plain():
            bt.channel_sums_reference(x, x, 1.0 / n)
            bt.channel_sums_reference(gy, x)
            bt.bn_dx_reference(gy, x, mul, c2, c1)

        xg = x.detach().requires_grad_(True)
        w = scale.detach().requires_grad_(True)
        b = torch.zeros(c, device=dev, requires_grad=True)
        rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)

        def library(res=None, relu=False):
            y = F.batch_norm(xg, rm, rv, w, b, training=True, momentum=0.1,
                             eps=1e-5)
            if res is not None:
                y = y + res
            if relu:
                y = F.relu(y)
            torch.autograd.grad(y, (xg, w, b) + (
                () if res is None else (res,)), gy)

        def port(res=None, relu=False):
            y, _, _ = bt.bn_train(xg, w, b, 1e-5, True, res, relu)
            torch.autograd.grad(y, (xg, w, b) + (
                () if res is None else (res,)), gy)

        ms = cuda_ms(kernel, reps=20)
        plain_ms = cuda_ms(plain, reps=5)
        lib_ms = cuda_ms(library, reps=20)
        # x read (stats), gy and x read (reduce), gy and x read and dx
        # written (dx): 6 activation-sized passes, plus [C] coefficients.
        nbytes = x.numel() * BF16_BYTES * 6 + 10 * c * 4
        per[shape] = (ms, plain_ms, lib_ms, nbytes)
        detail.append({"kernel": "bn_train", "timed_shape": list(shape),
                       "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                       "calls_per_step": sum(1 for s, _, _ in calls
                                             if s == shape)})
        for has_res, relu in sorted({(r, a) for s, r, a in calls
                                     if s == shape}):
            res = (torch.randn_like(xg).requires_grad_(True) if has_res
                   else None)
            whole[(shape, has_res, relu)] = (
                cuda_ms(lambda: port(res, relu), reps=20),
                cuda_ms(lambda: library(res, relu), reps=20))
            detail.append({"bn_path": "bn_train fwd+bwd",
                           "timed_shape": list(shape), "residual": has_res,
                           "relu": relu,
                           "ms": whole[(shape, has_res, relu)][0],
                           "library_ms": whole[(shape, has_res, relu)][1]})
            del res
        del x, gy, xg
        torch.cuda.empty_cache()
    tot = [sum(per[s][i] for s, _, _ in calls) for i in range(4)]
    path = [sum(whole[k][i] for k in calls) for i in range(2)]
    return {"ms": tot[0], "plain_ms": tot[1], "library_ms": tot[2],
            "bound_ms": tot[3] / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bn_path_ms": path[0], "bn_path_library_ms": path[1]}


def _sgd_leaves(dev, state_dtype, seed, dataset="imagenet",
                model_name="SSLResNet50"):
    from active_learning_tpu_torch.models.factory import get_network

    model = get_network(dataset, model_name, device=dev)
    params = [p.detach().clone() for p in model.parameters()]
    del model
    g = torch.Generator(device=dev).manual_seed(seed)
    grads = [torch.randn(p.shape, device=dev, generator=g).to(
        memory_format=torch.channels_last if p.dim() == 4
        else torch.contiguous_format) for p in params]
    traces = [torch.randn(p.shape, device=dev, generator=g).to(
        dtype=state_dtype, memory_format=torch.channels_last if p.dim() == 4
        else torch.contiguous_format) for p in params]
    return params, grads, traces


# (path, dataset, model, lr, weight decay) of kernel D on each training
# path: the default/imagenet and synthetic arg pools, momentum 0.9.
SGD_PATHS = (("fit", "imagenet", "SSLResNet50", 0.1, 1e-4),
             ("cli", "synthetic", "SSLResNet18", 0.05, 5e-4))


def check_fused_sgd(dev, detail):
    """Kernel D on every leaf of each training path's model with its arg
    pool's lr and weight decay (momentum 0.9): bit-equal to its plain
    version at f32 state; at bf16 state the trace within 1 bf16 ulp and
    the params within 1e-7."""
    from active_learning_tpu_torch.ops import fused_sgd as fs

    out = {}
    for (path, dataset, name, lr, wd), state in itertools.product(
            SGD_PATHS, (torch.float32, torch.bfloat16)):
        params, grads, traces = _sgd_leaves(dev, state, 3, dataset, name)
        ref_p = [p.clone() for p in params]
        ref_t = [t.clone() for t in traces]
        fs.fused_sgd_update(params, grads, traces, lr, 0.9, wd)
        fs.fused_sgd_reference(ref_p, grads, ref_t, lr, 0.9, wd)
        torch.cuda.synchronize()
        p_err = max((a - b).abs().max().item()
                    for a, b in zip(params, ref_p))
        t_err = max((a.float() - b.float()).abs().max().item()
                    for a, b in zip(traces, ref_t))
        if state == torch.float32:
            if not all(torch.equal(a, b) for a, b in
                       zip(params + traces, ref_p + ref_t)):
                raise AssertionError(f"fused_sgd not bit-equal at f32 "
                                     f"state on the {path} path")
        else:
            for a, b in zip(traces, ref_t):
                if bool(((a.float() - b.float()).abs()
                         > _bf16_ulp(b.float())).any()):
                    raise AssertionError("fused_sgd bf16 trace off by more "
                                         "than 1 ulp")
            if p_err > 1e-7:
                raise AssertionError(f"fused_sgd bf16-state params: {p_err}")
        key = f"{path} {state}"
        out[key] = {"param_err": p_err, "trace_err": t_err,
                    "leaves": len(params),
                    "params": sum(p.numel() for p in params)}
        detail.append({"kernel": "fused_sgd", "path": path,
                       "state": str(state), **out[key]})
    return out


def time_fused_sgd(dev):
    """One kernel D step over SSLResNet50's leaves at f32 state, its plain
    version, the bound (read p, g, t; write p, t: 20 B per parameter)
    and ``torch.optim.SGD(momentum=0.9, weight_decay=1e-4,
    fused=True).step()`` on the same tensors."""
    from active_learning_tpu_torch.ops import fused_sgd as fs

    params, grads, traces = _sgd_leaves(dev, torch.float32, 4)
    ms = cuda_ms(lambda: fs.fused_sgd_update(params, grads, traces, 0.1,
                                             0.9, 1e-4))
    plain = cuda_ms(lambda: fs.fused_sgd_reference(params, grads, traces,
                                                   0.1, 0.9, 1e-4), reps=10)
    leaves = [torch.nn.Parameter(p) for p in params]
    for leaf, g in zip(leaves, grads):
        leaf.grad = g
    opt = torch.optim.SGD(leaves, lr=0.1, momentum=0.9, weight_decay=1e-4,
                          fused=True)
    lib = cuda_ms(opt.step)
    nbytes = sum(p.numel() for p in params) * 20
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


# -- phase 5: the training slice ----------------------------------------------

def run_fit_path(dev, steps_profiled: int = 5, model_name="SSLResNet50",
                 data_kw=None, batch_size=None):
    """Path (a): ``Trainer.fit`` on full-width SSLResNet50 (default/imagenet
    TrainConfig: SGD lr 0.1, wd 1e-4, momentum 0.9, step LR, batch 128,
    BN in training mode), bf16, 1000 classes, 224x224 synthetic rows:
    2 epochs x 4 steps with validation on 128 test rows.  Then a timed
    window and a torch.profiler window of train steps."""
    from torch.profiler import ProfilerActivity, profile

    from active_learning_tpu_torch import ops
    from active_learning_tpu_torch.data.synthetic import get_data_synthetic
    from active_learning_tpu_torch.experiment.arg_pools import \
        get_train_config
    from active_learning_tpu_torch.models.factory import get_network
    from active_learning_tpu_torch.models.resnet import init_weights
    from active_learning_tpu_torch.train.trainer import Trainer

    from active_learning_tpu_torch.models.resnet import BatchNorm

    t0 = time.perf_counter()
    data_kw = data_kw or {"image_size": 224, "num_classes": 1000}
    train_set, test_set, _ = get_data_synthetic(**data_kw)
    cfg = get_train_config("default", "imagenet")
    if batch_size:
        cfg = dataclasses.replace(cfg, loader_tr=dataclasses.replace(
            cfg.loader_tr, batch_size=batch_size))
    bs = cfg.loader_tr.batch_size
    ncls = train_set.num_classes
    model = get_network("imagenet", model_name, num_classes=ncls,
                        device=dev)
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    init_weights(model, torch.Generator().manual_seed(SEED))
    trainer = Trainer(model, cfg, ncls, dev)
    if not trainer.train_bn or model.dtype != torch.bfloat16:
        raise AssertionError("the fit path must train bf16 with BN in "
                             "training mode")
    log(f"fit path set-up (data, model): {time.perf_counter() - t0:.1f} s")
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    result = trainer.fit(train_set, np.arange(len(train_set)), test_set,
                         np.arange(len(test_set)), n_epoch=2, es_patience=2,
                         rng=np.random.default_rng(SEED))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = ops.kernel_launches()
    steps = 2 * -(-len(train_set) // bs)
    want = {"bn_train_stats": n_bn * steps,
            "bn_train_bwd_reduce": n_bn * steps,
            "bn_train_dx": n_bn * steps, "fused_sgd": steps}
    if any(launches[k] != v for k, v in want.items()) or \
            launches["bn_act"] < n_bn * steps:
        raise AssertionError(f"fit path launches {launches}, expected "
                             f"{want} and bn_act >= {n_bn * steps}")
    for rec in result.history:
        if not (np.isfinite(rec["train_loss"])
                and np.isfinite(rec["grad_norm"])):
            raise AssertionError(f"non-finite loss or grad norm: {rec}")
    log(f"fit path: {steps} steps + 2 validations in {fit_s:.1f} s; "
        f"history {result.history}; launches {launches}")

    # Steady state: timed steps, then a profiled window.
    from active_learning_tpu_torch.data.pipeline import gather_batch
    batch = trainer.to_device(gather_batch(train_set, np.arange(bs), bs))
    weights = torch.ones(ncls, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model.train()
    for _ in range(2):
        trainer.train_step(batch, 0.1, weights, train_set.view, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps_profiled):
        trainer.train_step(batch, 0.1, weights, train_set.view, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps_profiled
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps_profiled):
            trainer.train_step(batch, 0.1, weights, train_set.view, gen)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / steps_profiled
    model.eval()
    out = {"fit_s": fit_s, "steps": steps, "history": result.history,
           "launches": launches, "step_ms": step_ms,
           "rows_per_s": bs / step_ms * 1e3, "batch": bs,
           "bn_per_step": n_bn, "profiled_wall_ms_per_step": prof_wall,
           **summarize_profile(prof, steps_profiled)}
    busy = out["device_ms_per_step"]
    out["device_busy_share"] = busy / prof_wall
    log(f"train step at B={bs}: {step_ms:.2f} ms ({out['rows_per_s']:.1f} "
        f"rows/s); profiled {prof_wall:.2f} ms wall, {busy:.2f} ms device "
        f"busy ({out['device_busy_share']:.0%})")
    for name, ms in out["top_kernels_ms_per_step"][:8]:
        log(f"  {ms:8.3f} ms  {name[:100]}")
    log(f"host: {out['kernel_launches_per_step']:.0f} kernel launches per "
        "step; top host ops (self ms, calls per step):")
    for name, (ms, n) in out["top_host_ops_ms_and_calls_per_step"][:8]:
        log(f"  {ms:8.3f} ms {n:7.0f}x  {name[:90]}")
    del model, trainer, batch
    torch.cuda.empty_cache()
    return out


_CLI_FLAGS = ["--dataset", "synthetic", "--arg_pool", "synthetic",
              "--model", "SSLResNet18", "--strategy", "MarginSampler",
              "--rounds", "2", "--round_budget", "16", "--n_epoch", "2",
              "--early_stop_patience", "2", "--exp_hash", "smoke"]


def _run_cli(root: str, extra) -> dict:
    repo = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "active_learning_tpu_torch", *_CLI_FLAGS,
           "--log_dir", os.path.join(root, "logs"),
           "--ckpt_path", os.path.join(root, "ckpt"), *extra]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                         timeout=900)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"CLI {' '.join(extra)} exited "
                             f"{res.returncode}:\n{res.stderr[-4000:]}")
    line = [ln for ln in res.stderr.splitlines()
            if "Kernel launches: " in ln][-1]
    launches = json.loads(line.split("Kernel launches: ", 1)[1])
    exp_dir = os.path.join(root, "ckpt", "active_learning_smoke")
    with np.load(os.path.join(exp_dir, "experiment_state.npz")) as st:
        eval_idxs = st["eval_idxs"].copy()
    with open(os.path.join(root, "logs", "assets",
                           "labeled_idxs_on_rd_0.txt")) as fh:
        round0 = np.array([int(v) for v in fh.read().split(",")])
    tested = set()
    with open(os.path.join(root, "logs", "metrics.jsonl")) as fh:
        for ln in fh:
            e = json.loads(ln)
            if e["kind"] == "metric" and "rd_test_accuracy" in e["metrics"]:
                tested.add(e["step"])
    times = [ln for ln in res.stderr.splitlines() if "_time is " in ln]
    return {"wall_s": wall, "launches": launches, "eval_idxs": eval_idxs,
            "round0": round0, "tested": tested, "exp_dir": exp_dir,
            "phase_times": times}


def run_cli_path(tmp: str):
    """Path (b): the experiment CLI in a subprocess on the card, and the
    same command with --device cpu; the child logs its kernel launch
    counts (zero at its start) when it finishes."""
    from active_learning_tpu_torch.models.weights import load_flax_variables
    from active_learning_tpu_torch.serve import cli as serve_cli
    from active_learning_tpu_torch.strategies.scoring import (
        make_prob_stats_step)
    from active_learning_tpu_torch.train import checkpoint as ckpt_lib

    card = _run_cli(os.path.join(tmp, "card"), [])
    cpu = _run_cli(os.path.join(tmp, "cpu"), ["--device", "cpu"])
    log(f"CLI on the card: {card['wall_s']:.1f} s, launches "
        f"{card['launches']}; phases {card['phase_times']}")
    log(f"CLI with --device cpu: {cpu['wall_s']:.1f} s")
    for k in ("prob_stats", "bn_act", "bn_train_stats",
              "bn_train_bwd_reduce", "bn_train_dx", "fused_sgd"):
        if card["launches"][k] < 1:
            raise AssertionError(f"CLI path never launched {k}: "
                                 f"{card['launches']}")
    if any(cpu["launches"].values()):
        raise AssertionError(f"the CPU run launched a kernel: "
                             f"{cpu['launches']}")
    for run in (card, cpu):
        if run["tested"] != {0, 1}:
            raise AssertionError(f"rounds tested: {run['tested']}")
    if not (np.array_equal(card["eval_idxs"], cpu["eval_idxs"])
            and np.array_equal(card["round0"], cpu["round0"])):
        raise AssertionError("round-0 indices differ between card and CPU")
    args = serve_cli.get_parser().parse_args(
        ["--experiment_dir", card["exp_dir"], "--port", "0"])
    model, view, image_size, _ = serve_cli.resolve_serve_setup(args)
    load_flax_variables(model, ckpt_lib.load_variables(
        os.path.join(card["exp_dir"], "best_rd_0.msgpack")))
    rows = np.random.default_rng(SEED).integers(
        0, 256, (8, image_size, image_size, 3), dtype=np.uint8)
    scores = make_prob_stats_step(view)(
        model, {"image": torch.from_numpy(rows).cuda()})
    if not all(bool(torch.isfinite(v.float()).all())
               for v in scores.values()):
        raise AssertionError("scores from best_rd_0 not finite")
    log("CLI path: both rounds tested on card and CPU, round-0 indices "
        "equal, best_rd_0 loads into the serve model and scores")
    return {"card_wall_s": card["wall_s"], "cpu_wall_s": cpu["wall_s"],
            "launches": card["launches"],
            "phase_times": card["phase_times"]}


def check_train_step_f32_against_cpu(devices=("cuda", "cpu")):
    """One float32 train step of SSLResNet18 (CIFAR stem, B=32, 10
    classes, non-augmenting view) from the same numpy-seeded weights on
    the card (TF32 off) and on the CPU.  The loss within 1e-4 relative;
    the update (new minus old parameters, over all leaves) within 1e-3 of
    its norm: the same float32 network with every convolution and sum in
    another order on each side."""
    from active_learning_tpu_torch.config import TrainConfig
    from active_learning_tpu_torch.data.core import SYNTH_NORM, ViewSpec
    from active_learning_tpu_torch.device import set_float32_precision
    from active_learning_tpu_torch.models.factory import get_network
    from active_learning_tpu_torch.models.resnet import init_weights
    from active_learning_tpu_torch.train.trainer import Trainer

    set_float32_precision(torch.float32)
    rng = np.random.default_rng(SEED + 2)
    batch = {"image": rng.integers(0, 256, (32, 32, 32, 3), dtype=np.uint8),
             "label": rng.integers(0, 10, 32).astype(np.int32),
             "mask": np.ones(32, np.float32)}
    view = ViewSpec(SYNTH_NORM, augment=False)
    out = []
    for device in devices:
        model = get_network("cifar10", "SSLResNet18", dtype="float32",
                            device=device)
        init_weights(model, torch.Generator().manual_seed(SEED))
        before = [p.detach().cpu().clone() for p in model.parameters()]
        trainer = Trainer(model, TrainConfig(), 10, device)
        model.train()
        loss, gnorm = trainer.train_step(
            trainer.to_device(batch), 0.1, torch.ones(10, device=device),
            view, None)
        delta = torch.cat([(p.detach().cpu() - b).reshape(-1) for p, b in
                           zip(model.parameters(), before)])
        out.append((float(loss), float(gnorm), delta))
    (lc, gc, dc), (lp, gp, dp) = out
    rel = abs(lc - lp) / abs(lp)
    upd = (dc - dp).norm().item() / dp.norm().item()
    if rel > 1e-4 or upd > 1e-3:
        raise AssertionError(f"f32 train step card vs CPU: loss rel {rel}, "
                             f"update rel {upd}")
    log(f"f32 train step card vs CPU: loss {lc:.6f} vs {lp:.6f} (rel "
        f"{rel:.2e}), grad norm {gc:.6f} vs {gp:.6f}, update rel {upd:.2e}")
    return {"loss_rel": rel, "update_rel": upd, "grad_norm": [gc, gp]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--detail", default=None,
                        help="also write per-shape checks and timings here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from active_learning_tpu_torch.models.factory import get_network
    from active_learning_tpu_torch.ops import _build
    from active_learning_tpu_torch.ops import bn_act as ba

    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # 1. Build.
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"nvcc build of {sorted(secs)}: {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        log(f"--- nvcc {name}.cu ---\n{text.strip()}")
    model = get_network("imagenet", "SSLResNet50", device=dev)
    x = torch.zeros(64, 224, 224, 3, device=dev)
    t0 = time.perf_counter()
    calls = bn_calls_of_forward(model, x)
    torch.cuda.synchronize()
    log(f"Triton build + first bf16 forward: {time.perf_counter() - t0:.1f} s"
        f" ({len(calls)} BatchNorm calls per forward, bn_act launches "
        f"{ba.launches})")
    del model, x

    # 2. Kernels against their plain versions.
    detail = []
    err_a = check_prob_stats(dev, detail)
    err_b = check_bn_act(dev, calls, detail)
    log(f"kernel checks passed: prob_stats max err {err_a:.3g}, bn_act max "
        f"err {err_b:.3g}")
    times_a = time_prob_stats(dev)
    times_b = time_bn_act(dev, calls, detail)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bn_paths = path_bn_calls(dev)
    train_calls = bn_paths["fit"][0]
    for path, (p_train, p_eval) in bn_paths.items():
        err_b = max(err_b,
                    check_bn_act(dev, p_train, detail, (torch.bfloat16,),
                                 batch_stats=True, path=f"{path} train"),
                    check_bn_act(dev, p_eval, detail, (torch.bfloat16,),
                                 path=f"{path} eval"))
    err_c = max(check_bn_train(dev, train_calls, detail),
                check_bn_train(dev, bn_paths["cli"][0], detail, path="cli"))
    log(f"kernels B and C checked at the training paths' shapes: bn_act "
        f"max err {err_b:.3g}, bn_train dx max err {err_c:.3g} "
        f"({time.perf_counter() - t0:.1f} s)")
    times_c = time_bn_train(dev, train_calls, detail)
    sgd = check_fused_sgd(dev, detail)
    err_d = max(max(v["param_err"], v["trace_err"]) for v in sgd.values())
    times_d = time_fused_sgd(dev)
    torch.cuda.empty_cache()
    log(f"training kernel checks passed in {time.perf_counter() - t0:.1f} "
        f"s: bn_train dx max err {err_c:.3g} over "
        f"{len(set(s for s, _, _ in train_calls))} shapes "
        f"({len(train_calls)} BatchNorm calls per step), fused_sgd {sgd}")

    # 3. The slice.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_exp_") as exp_dir:
        model, variables, view, rows, launches, serving = run_slice(exp_dir)
    if args.detail:
        serving["step_profile"] = profile_step(model, view, rows[64])
    del model
    check_f32_against_cpu(variables, view, rows[17][:4])

    # 5. The training slice.
    fit = run_fit_path(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        cli_run = run_cli_path(tmp)
    f32_step = check_train_step_f32_against_cpu()
    paths = {"serve": launches, "fit": fit["launches"],
             "cli": cli_run["launches"]}

    def count(*names):
        by = {p: sum(v[n] for n in names) for p, v in paths.items()}
        return {"launches": sum(by.values()), "launches_by_path": by}

    c_names = ("bn_train_stats", "bn_train_bwd_reduce", "bn_train_dx")
    kernels = [
        {"name": "prob_stats", "route": "cuda",
         "source": "active_learning_tpu_torch/csrc/prob_stats.cu",
         "replaces": "active_learning_tpu/strategies/scoring.py:109",
         **count("prob_stats"), "max_abs_err": err_a,
         **times_a, "library_ms": None},
        {"name": "bn_act", "route": "triton",
         "source": "active_learning_tpu_torch/ops/bn_act.py",
         "replaces": "active_learning_tpu/models/resnet.py:190",
         **count("bn_act"), "max_abs_err": err_b,
         **times_b, "library_ms": None},
        {"name": "bn_train", "route": "cuda",
         "source": "active_learning_tpu_torch/csrc/bn_train.cu",
         "replaces": "active_learning_tpu/ops/backward.py:131",
         **count(*c_names), "max_abs_err": err_c,
         "launches_by_function": {n: sum(v[n] for v in paths.values())
                                  for n in c_names},
         **times_c},
        {"name": "fused_sgd", "route": "cuda",
         "source": "active_learning_tpu_torch/csrc/fused_sgd.cu",
         "replaces": "active_learning_tpu/train/optim.py:97",
         **count("fused_sgd"), "max_abs_err": err_d, **times_d},
    ]
    if args.detail:
        os.makedirs(os.path.dirname(os.path.abspath(args.detail)),
                    exist_ok=True)
        with open(args.detail, "w") as fh:
            json.dump({"kernels": kernels, "serving": serving,
                       "training": {"fit": fit, "cli": cli_run,
                                    "f32_step": f32_step},
                       "checks": detail}, fh, indent=1, default=str)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
