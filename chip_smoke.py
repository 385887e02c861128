"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--detail PATH]

Drives the port's serving path (``active_learning_tpu_torch``) once on the
card, through the entry points a user calls, and fails (non-zero exit) if
any phase fails:

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


def check_bn_act(dev, calls, detail):
    """Every distinct BN shape of the forward, in bf16 and f32, with and
    without residual, against the plain version.  Tolerance: float32
    within 1e-6 of the terms' magnitude (|x - shift|·|mul| + |add| +
    |res|); bf16 within 1 bf16 ulp of the result plus that."""
    from active_learning_tpu_torch.ops import bn_act as ba

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
        for dtype in (torch.bfloat16, torch.float32):
            x, r = x32.to(dtype), r32.to(dtype)
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
                detail.append({"kernel": "bn_act", "shape": [b, c, h, w],
                               "dtype": str(dtype), "residual": res is not None,
                               "relu": relu, "max_abs_err": err})
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
    from active_learning_tpu_torch.config import ServeConfig
    from active_learning_tpu_torch.ops import bn_act as ba
    from active_learning_tpu_torch.ops import prob_stats as ps
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

        ps.launches = 0
        ba.launches = 0
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
        launches = {"prob_stats": ps.launches, "bn_act": ba.launches}
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
    from torch.autograd import DeviceType
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
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + (
                e.self_device_time_total / 1e3 / steps)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    log(f"profiled step at B=64: {wall_ms / steps:.2f} ms wall, "
        f"{busy:.2f} ms device busy per step")
    return {"wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy,
            "device_busy_share": busy / (wall_ms / steps),
            "top_kernels_ms_per_step": top}


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

    # 3. The slice.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_exp_") as exp_dir:
        model, variables, view, rows, launches, serving = run_slice(exp_dir)
    if args.detail:
        serving["step_profile"] = profile_step(model, view, rows[64])
    del model
    check_f32_against_cpu(variables, view, rows[17][:4])

    kernels = [
        {"name": "prob_stats", "route": "cuda",
         "source": "active_learning_tpu_torch/csrc/prob_stats.cu",
         "replaces": "active_learning_tpu/strategies/scoring.py:109",
         "launches": launches["prob_stats"], "max_abs_err": err_a,
         **times_a, "library_ms": None},
        {"name": "bn_act", "route": "triton",
         "source": "active_learning_tpu_torch/ops/bn_act.py",
         "replaces": "active_learning_tpu/models/resnet.py:190",
         "launches": launches["bn_act"], "max_abs_err": err_b,
         **times_b, "library_ms": None},
    ]
    if args.detail:
        os.makedirs(os.path.dirname(os.path.abspath(args.detail)),
                    exist_ok=True)
        with open(args.detail, "w") as fh:
            json.dump({"kernels": kernels, "serving": serving,
                       "checks": detail}, fh, indent=1)
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
