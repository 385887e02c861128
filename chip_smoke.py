"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--detail PATH]

Drives the port's serving, training and acquisition paths, the s2d
stem through all three, data-parallel training on two ranks, the
CIFAR-10 fine-tuning sweep and crash-safe rounds
(``active_learning_tpu_torch``), on the card,
through the entry points a user calls, and fails (non-zero exit) if any
phase fails:

1. Build: every CUDA source of the port with nvcc (all at once).
2. Kernels against their plain PyTorch versions, on the card, at the main
   path's shapes: kernel A (``ops/prob_stats``, CUDA) on B in {1, 8, 64,
   256} x C in {10, 1000, 4097} (32, 256 and 256 threads a row), rows with
   forced exact top-2 ties and rows with NaN, +inf and -inf (pred equal,
   NaN and inf where the plain version has them), and kernel B
   (``ops/bn_act``, CUDA) on every BatchNorm shape of the SSLResNet50
   forward at B=64, in bf16 and f32, with and without residual.  Each is
   timed with CUDA events beside its plain version and its bound, by the
   profiler's kernel events (kernel A at B = 64 and 256, C = 1000; kernel
   B over a forward's 53 calls) and its host time a call.
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
   CUDA: statistics and the masked backward reduction, each with its
   per-channel chain, the N-rank chains, dx with the residual's
   gradient) at every BatchNorm call (shape, residual, ReLU) of the
   SSLResNet50 training step at B=128, 224x224, bf16 (f32 on the shapes
   with C >= 1024) and of the CLI's SSLResNet18 (CIFAR stem) training
   step, bf16: sums within their tolerance, the chains within
   BN_CHAIN_ULPS (0) of PyTorch's ops from the same sums, dx bit-equal,
   two launches bit-equal; kernel D
   (``ops/fused_sgd``, CUDA) on every leaf of both paths' models with
   their arg pools' lr and weight decay and on odd leaves (views at
   storage offsets 0-3 of 1, 3, 4, 4097 and 40,000 elements, some grads
   never aligned with their params), bit-equal at f32 state, within
   1 bf16 ulp at bf16 state.  Kernel C is timed beside its plain
   version (CUDA events, and its device time by the profiler), its
   bound and ``F.batch_norm(training=True)`` forward + backward, and the
   host time of a training BatchNorm split into kernel B's wrapper,
   kernel C's wrappers and the rest; the
   port's whole BatchNorm forward + backward (kernels C and B) beside
   ``F.batch_norm`` with the same residual add and ReLU, and the
   kernels one BatchNorm launches forward and backward (at most 3
   each, or the run fails).  Kernel D's device time (torch.profiler kernel events)
   and host time per call (``perf_counter``) beside
   ``torch.optim.SGD(fused=True).step()``'s, its bound and its plain
   version; the CUDA-event mean over a loop of calls is kept beside
   them as ``event_loop_ms`` (the host's pace where the host is slower).
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
7. The geometry samplers' kernels against their plain versions at the
   main path's shapes: kernel E (``ops/kcenter``, CUDA: fold + top-q,
   the batched pass with its re-check, whose accepted picks must equal
   the q = 1 kernel scan's bit for bit, fold + D² draw, initial min) on
   one factor [13,000, 2048] and the
   pooled BADGE factors [13,000, 16] + [13,000, 32] (a partition of the
   ImageNet sweep) and on [131,072, 2048] (its whole pool, bucketed),
   with the Threefry bits bit-equal, each pool also with 8 unlabeled
   rows holding NaN, +inf, -inf and +inf beside -inf (``nonfinite_rows``;
   NaN and ±inf where the plain versions have them, a NaN ranked first,
   the draw uniform once a weight is NaN, the batched picks still the
   q = 1 scan's bit for bit); kernel F (``ops/boundary_radii``,
   CUDA) on [256, 2048] embeddings against a [1000, 2048] head, and on
   ragged shapes (7, 10, 33), (300, 1001, 2050), (1, 3, 5) and the full
   width with embedding rows holding NaN, +inf and -inf (pred equal, NaN
   and inf where the plain version has them), the pair-norm table equal
   to its transpose bit for bit, 2 kernels a radii call and 1 a table by
   the C entry's count and by the profiler; kernel
   G (``ops/badge``, CUDA) on [256, 1000] logits and [256, 2048]
   embeddings, pooled and not, on finite rows and on rows holding NaN,
   +inf and -inf (and at C = 10, D = 512, whose bins overlap), timed
   pooled and unpooled by CUDA events, the profiler's device time and
   the host time a call.  Each timed beside its plain version,
   its bound and, for E, the ``torch.matmul`` + ``torch.topk`` form
   (for F, ``torch.addmm`` of the logits as a labelled reference, its
   device time by the profiler and its bound in FP32 issue slots beside
   the FLOP bound).
8. Each of MASE, BASE, PartitionedCoreset (2 partitions) and
   PartitionedBADGE (2 partitions, pooled) ``query``s full-width
   SSLResNet50 (1000 classes, bf16, seeded) over 2,048 synthetic
   224x224 rows, launch counters zeroed before each and read after;
   the mase and badge steps in float32 on the card against the CPU.
9. ``kcenter_greedy`` at the sweep's pool size: seeded [130,000, 2048]
   float32 factors, 50,000 labeled, budget 10,000 — unpartitioned
   (q = 8), 10 partitions of 13,000 rows (1,000 picks each), and the
   partitions randomized over pooled BADGE factors; wall time, pool
   passes and host syncs of each (at most ``max_host_syncs``), peak
   device memory, the batched picks and distances held bit for bit to
   the q = 1 kernel scan's (the whole unpartitioned run, partition 0),
   and the picks held against the plain version (the whole
   unpartitioned run, partition 0 of the others).
10. The CLI on the card with BASESampler, PartitionedCoresetSampler and
    PartitionedBADGESampler (--partitions 2; SSLResNet18, synthetic, 2
    rounds).
11. Kernel H (``ops/balancing``, CUDA: the balancing pick) against its
    plain version at 20,431 x 512 and 50,000 x 512 with 10 classes and
    130,000 x 2048 with 1000 (the majority mask of an exp-0.1 skewed
    count vector), with and without an empty rarest class, and the edge
    cases (ties to the lower index, ineligible rows, a row on a majority
    centroid).  Picks equal, or the two scores within the stated f32
    bound (printed).  Timed beside its plain version, its bound and the
    library form (addmm + amax + argmin): a ``BalancingState`` pick (+
    take) by CUDA events, the profiler and the host clock, with the
    kernels a pick launched (the C entry's count, held against the
    profiler's).
12. BalancingSampler at the imbalanced CIFAR sweep's width: full-width
    SSLResNet18 (CIFAR stem, 10 classes, seeded), a 20,431-row 32-px
    pool, 1,000 labeled rows in exp-0.1 proportions, budget 1,000; the
    query through kernel H's ``BalancingState``, then again with the
    plain version on the state, and in lockstep (kernel H's pick and
    the plain version's on the same state at every balancing pick).
    Wall time and the pick loop's share, balancing vs random picks, the
    runs of consecutive balancing picks, H's picks and launches (at most
    2 a pick), host syncs, peak memory.
13. VAAL at the ImageNet sweep's width: full-width SSLResNet50 (224 px,
    default/imagenet, B=128, from scratch) with the VAE at crop 64, z =
    64: ``Trainer.fit`` with the co-step hook over 512 labeled rows (2
    epochs), co-step and classifier step times, launches of A-D, kernels
    B and C held on every VAE shape they took; a query of 200 over the
    rest of a 2,600-row pool; one float32 co-step and the score step on
    the card against the CPU.
14. BalancingSampler, MarginClusteringSampler and VAALSampler through
    the CLI on the card (2 rounds) and with --device cpu (round-0
    indices equal); first kernels H, B and C held on the inputs the
    CLI's training and queries give them in this process.
15. Kernel I (``ops/stem_conv``, CUDA: the s2d stem's weight gradient;
    bf16 on the tensor cores, f32 on the CUDA cores) against its plain
    version (float32, TF32 off) and float64 truth at B=128 x 112x112
    (the fit width), B=8 (g NHWC-strided) and the edge shapes 1x2x2,
    3x4x6, 2x7x5, each in bf16 and f32: within
    2·max(L_k·u_k, R·2⁻²⁴)·Σ|x||g| of the plain version (L_k units of
    u_k the kernel's chain, 2⁻²³ on the tensor cores; R the plain sum's)
    and 1.01·L_k·u_k·Σ|x||g| of the truth, two launches bit-equal.
    Timed beside its plain version, its bound and the library wgrad
    (``aten.convolution_backward``), with both ratios printed.
16. The s2d stem: (1) full-width SSLResNet50 logits, default stem
    against s2d stem on ``fold_stem`` weights, f32 and bf16, within 4x
    the default network's own error against float64 (the CPU); (2)
    ``run_experiment`` with ``stem="s2d"`` (SSLResNet50, 1000 classes,
    MarginSampler, 2 rounds, default/imagenet, 1,024 seeded 224-px rows):
    kernel I once per train step, the folded stem saved and echoed; (3)
    the serve verb's server on that experiment, three 64-row requests,
    scores bit-equal to the offline step over host-s2d rows; (4) a timed
    B=128 train step, s2d against the default stem: host clock, CUDA
    events and each step's profiled device time side by side, and the
    stem alone;
    (5) one float32 s2d train step on the card against the CPU.
17. Kernel J (``ops/int8_sync``, CUDA: block absmax, quantize,
    dequantizing sum, reduce-scatter re-quantization) against its plain
    version at N = 2, 4, 8 thread ranks of one process, each running the
    trainer's ``int8_allreduce`` / ``int8_reduce_scatter`` over a mesh
    whose collectives meet in memory, both wire forms, over SSLResNet50's 161 gradient leaves and edge leaves of
    1, 255, 257 and 256·N + 3 elements, a NaN on one rank and an inf on
    another: bit for bit, both blocks NaN on every rank (the scales a
    multiply by float32(1/127), as the JAX trainer's compile folds
    them).  Each function
    timed at N = 2 beside its plain version (the torch composite: no
    single PyTorch call computes them) and its bytes bound.
18. Two ranks in two processes sharing cuda:0 over gloo, every collective
    staged through pinned host memory (NCCL refuses two ranks on one
    card): each calls ``run_experiment`` with its mesh (SSLResNet50, 1000
    classes, 224 px, bf16, ``default/imagenet``, global batch 128,
    MarginSampler, one round: a query of 512, then 2 epochs of 4 steps)
    under the f32, int8 and int8_rs gradient syncs.  The learning probe's
    delta, the launch counters of kernels A-D and J (zeroed just before
    each run, read just after), the step time per sync and the host time
    inside its collectives (the median and range of the steps after the
    first, which pays first-use costs), the first synced
    gradients bit-equal on both ranks, and the int8 sync's largest error
    over its bound (``N·scale/2``, ``+scale2/2`` for int8_rs) against the
    f32 all-reduce of the same step: at most 1.
19. One NCCL rank on the card (``init_process_group("nccl",
    world_size=1)``): the mesh's all_reduce, all_gather, all_to_all (int8
    payloads) and broadcast through NCCL, and ``int8_allreduce`` /
    ``int8_reduce_scatter`` called at N = 1 equal to their plain
    versions.
20. The paper's imbalanced CIFAR-10 fine-tuning sweep: a full-size
    facsimile of ``cifar-10-python.tar.gz`` (50,000 + 10,000 rows)
    written and fetched through ``fetch_cifar10`` (file://, md5), and a
    seeded SimCLR-layout ResNet-18 checkpoint; the loaded encoder equal
    to the checkpoint; kernel B′ (``ops/bn_act.bn_act_backward``, CUDA:
    the eval-mode BatchNorm backward) against its plain version at every
    BatchNorm call of SSLResNet18 at B = 128, in bf16 and f32 (dx and
    d_residual bit for bit, the sums and d scale / d bias within their
    stated bounds), and timed beside its plain version, its bytes bound
    and ``aten.native_batch_norm_backward(train=False)``; the first
    imbalanced-CIFAR BASESampler job of the port's ``gen_jobs`` (SSLResNet18,
    20,431 imbalanced rows, budget and initial pool 1,000, B = 128) through
    ``python -m active_learning_tpu_torch``, cut to 2 epochs and 2
    rounds: exit 0, the checkpoint overlaid each round, both rounds
    tested, validation every epoch, kernels B, B′, D and F launched and
    C not (BatchNorm in eval mode throughout); the first fine-tuning
    step in float32 on the card against the CPU; and the cache repair:
    after every validation of a 2-epoch fit (fine-tuning, and from
    scratch with BatchNorm in training mode) the cached evaluation
    equals a freshly loaded model's, count for count.
21. Resume and faults on the card, on phase 20's rows: (1) path a's
    ``Trainer.fit`` (SSLResNet50, B = 128, 224 px, bf16, BatchNorm in
    training mode, 512 + 128 rows, the fit state every 2 epochs, 6
    epochs) unbroken, interrupted in the process after epoch 4's save,
    and resumed: parameters, BatchNorm buffers, momentum, best epoch and
    accuracy and the history from epoch 5 bit-equal to the unbroken
    fit's, kernels B, C and D launched in the resumed fit, the fit
    state's save timed and sized; (2) phase 20's CIFAR job cut to 2
    rounds of 4 epochs through the CLI, unbroken, SIGTERM'd in round 1's
    fit (exit 0, journal ``preempted``) and resumed with
    ``--resume_training``: ``experiment_state.npz`` and
    ``best_rd_1.msgpack`` bit-equal, B, B′ and D launched in the resumed
    process; (3) phase 5's CLI with ``--fault_spec ckpt_write:torn@1``:
    the torn publish retried, ``experiment_state.npz`` equal to phase
    5's; (4) a child capped by ``set_per_process_memory_fraction``
    between its measured B = 64 and B = 128 SSLResNet50 step peaks runs
    2 rounds: a real ``torch.OutOfMemoryError`` engages ``batch_half``
    in each round, the next round starts at B = 128 again, both rounds
    tested.

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
import signal
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
H100_SMS, F32_LANES_PER_SM = 132, 128
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

# Row kinds of the non-finite checks: the values placed at seeded columns
# of a standard-normal row ("all -inf" fills the row).
NONFINITE_KINDS = {"finite": (), "nan": (np.nan,), "+inf": (np.inf,),
                   "-inf": (-np.inf,), "+inf -inf": (np.inf, -np.inf),
                   "nan +inf": (np.nan, np.inf), "+inf +inf": (np.inf, np.inf),
                   "all -inf": None}


def nonfinite_rows(x: np.ndarray, kinds, seed: int) -> np.ndarray:
    """``x`` with row r made of kind ``kinds[(r + 1) % len(kinds)]`` (so
    one row is enough for a NaN)."""
    rng = np.random.default_rng(seed)
    x = x.copy()
    for r in range(x.shape[0]):
        vals = NONFINITE_KINDS[kinds[(r + 1) % len(kinds)]]
        if vals is None:
            x[r] = -np.inf
        elif vals:
            x[r, rng.choice(x.shape[1], size=len(vals), replace=False)] = vals
    return x


def same_special(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaN, +inf and -inf at the same entries."""
    return (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.isposinf(got), torch.isposinf(want))
            and torch.equal(torch.isneginf(got), torch.isneginf(want)))


def _finite_err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| where want is finite, 0 elsewhere."""
    fin = torch.isfinite(want)
    return (got - want).abs().where(fin, torch.zeros_like(want))


def _equal_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN at the same entries."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan],
                                                            b[~nan])


def _finite_max(t: torch.Tensor) -> float:
    """The largest finite entry of ``t`` (0 when there is none)."""
    fin = t[torch.isfinite(t)]
    return float(fin.max()) if fin.numel() else 0.0


def check_prob_stats(dev, detail):
    """Kernel A against its plain version at B in {1, 8, 64, 256} x C in
    {10, 1000, 4097} (a 32- and a 256-thread block a row): rows with forced
    exact top-2 ties, and rows with NaN, +inf and -inf.  pred equal, NaN
    and ±inf where the plain version has them, and the finite values
    within the stated tolerances."""
    from active_learning_tpu_torch.ops import prob_stats as ps

    rng = np.random.default_rng(SEED)
    worst = 0.0
    for b in (1, 8, 64, 256):
        for c in (10, 1000, 4097):
            x = rng.standard_normal((b, c)).astype(np.float32) * 3.0
            tied = x.copy()
            # Every other row: an exact tie for the top-2, between the
            # row's argmax and a LATER index, then an earlier one.
            for r in range(0, b, 2):
                top = int(np.argmax(tied[r]))
                tied[r, (top + 1 + r) % c] = tied[r, top]
            for rows, arr in (("tied", tied),
                              ("nonfinite", nonfinite_rows(
                                  x, list(NONFINITE_KINDS), b + c))):
                logits = torch.from_numpy(arr).to(dev)
                got = ps.prob_stats(logits)
                ref = ps.prob_stats_reference(logits)
                torch.cuda.synchronize()
                where = f"B={b} C={c} {rows}"
                if not torch.equal(got["pred"], ref["pred"]):
                    raise AssertionError(f"prob_stats pred differs at "
                                         f"{where}")
                for k in ("confidence", "margin", "entropy"):
                    if not same_special(got[k], ref[k]):
                        raise AssertionError(f"prob_stats {k}: NaN or inf "
                                             f"differs at {where}")
                errs = {k: _finite_err(got[k], ref[k]).max().item()
                        for k in ("confidence", "margin", "entropy")}
                # confidence/margin: atol 1e-6.  entropy is a sum of C
                # float32 terms taken in another order than torch's: atol
                # 1e-6 plus 1e-6 of its value (2 ulp at ln 1000).
                tol_h = 1e-6 + 1e-6 * ref["entropy"].abs()
                if (errs["confidence"] > 1e-6 or errs["margin"] > 1e-6
                        or bool((_finite_err(got["entropy"], ref["entropy"])
                                 > tol_h).any())):
                    raise AssertionError(f"prob_stats at {where}: {errs}")
                if rows == "tied" and bool((got["margin"][0::2] != 0).any()):
                    raise AssertionError("prob_stats: a tied top-2 gave a "
                                         "non-zero margin")
                worst = max(worst, *errs.values())
                detail.append({"kernel": "prob_stats", "B": b, "C": c,
                               "rows": rows, **errs})
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
    """Kernel A at C = 1000 and B = 64 (the serve cap) and 256 (phase 8's
    scoring batch): CUDA events over back-to-back calls (the host's pace
    where the host is slower), the device time (the profiler's kernel
    events, whole sessions only), the host time a call, the plain version
    and the bytes bound.  The top-level figures are B = 64's."""
    from active_learning_tpu_torch.ops import prob_stats as ps

    by_batch = {}
    for b in (64, 256):
        c = 1000
        logits = torch.randn(b, c, device=dev, generator=torch.Generator(
            device=dev).manual_seed(1))
        nbytes = b * c * 4 + b * 4 * 4
        # exp twice, divide, subtracts, the p·logp product, sums, compares.
        flops = b * c * 10
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        before = ps.launches
        dev_ms = profiled_device_ms(lambda: ps.prob_stats(logits),
                                    t_b * 1e3)[0]
        if ps.launches == before:
            raise AssertionError("kernel A was not launched while profiled")
        by_batch[b] = {
            "ms": cuda_ms(lambda: ps.prob_stats(logits)),
            "device_ms": dev_ms,
            "host_us": host_us(lambda: ps.prob_stats(logits)),
            "plain_ms": cuda_ms(lambda: ps.prob_stats_reference(logits)),
            "bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}
        r = by_batch[b]
        log(f"kernel A at B={b} C={c}: CUDA events {r['ms']:.4f} ms, device "
            f"{dev_ms * 1e3:.2f} us (profiler), host {r['host_us']:.2f} us a "
            f"call; plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms'] * 1e3:.4f} us")
    return {**by_batch[64], "by_batch": by_batch}


def time_bn_act(dev, calls, detail):
    """All BatchNorm calls of one B=64 bf16 forward: the kernel's
    CUDA-event time (the host's pace where the host is slower), its
    device time (the profiler's kernel events over a run of the 53
    calls, whole sessions only), the host time a call (``perf_counter``
    around the run of 53 calls, not waited for, over 53), the plain
    version and the bound, summed over the calls."""
    from active_learning_tpu_torch.ops import bn_act as ba

    per, inputs = {}, {}
    for key in sorted(set(calls)):
        (b, c, h, w), has_res, relu = key
        x = torch.randn(b, c, h, w, device=dev, dtype=torch.bfloat16).to(
            memory_format=torch.channels_last)
        r = torch.randn_like(x) if has_res else None
        ones, zeros = (torch.ones(c, device=dev), torch.zeros(c, device=dev))
        coeffs = ba.bn_coefficients(ones, zeros, zeros, ones, 1e-5,
                                    torch.bfloat16, True)
        inputs[key] = (x, coeffs, r, relu)
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
    bound_ms = tot[2] / HBM_BYTES_PER_S * 1e3

    def forward_calls():
        for key in calls:
            x, coeffs, r, relu = inputs[key]
            ba.bn_act(x, coeffs, r, relu)

    before = ba.launches
    # Floor: half the bound (the small shapes' inputs stay in L2 across
    # the loop; a reading under half is lost events).
    dev_ms = profiled_device_ms(forward_calls, 0.5 * bound_ms)[0]
    if ba.launches == before:
        raise AssertionError("kernel B was not launched while profiled")
    host = host_us(forward_calls) / len(calls)
    log(f"kernel B over a B=64 forward's {len(calls)} calls: CUDA events "
        f"{tot[0]:.4f} ms, device {dev_ms:.4f} ms (profiler), bound "
        f"{bound_ms:.4f} ms; host {host:.2f} us a call; plain "
        f"{tot[1]:.3f} ms")
    return {"ms": tot[0], "device_ms": dev_ms, "host_us": host,
            "plain_ms": tot[1], "bound_ms": bound_ms, "bound_by": "bytes"}


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
            # Kernel B's variants (residual, ReLU) are separate kernels.
            "bn_act_ms_per_step": sum(v for k, v in kernels.items()
                                      if "bn_act_kernel" in k),
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


# Kernel C's chains on the card against their plain versions (PyTorch ops
# on the card) from the same sums: 0 ulp (separately rounded float32 ops
# in the plain order, rsqrtf as PyTorch's CUDA rsqrt, a division by a
# Python number as a multiply by its float32 reciprocal).
BN_CHAIN_ULPS = 0


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ia = a.detach().contiguous().view(torch.int32).long()
    ib = b.detach().contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max()) if a.numel() else 0


def _hold_bn_chain(got, want, what):
    worst = max(_ulps(a, b) for a, b in zip(got, want))
    if worst > BN_CHAIN_ULPS:
        raise AssertionError(f"bn_train {what}: the chain is {worst} ulp "
                             f"from the plain version's (bound "
                             f"{BN_CHAIN_ULPS})")
    return worst


def check_bn_train(dev, calls, detail, path="fit"):
    """Kernel C at every BatchNorm call (shape, residual, ReLU) of the
    step, fused formula (and flax's in f32 at C >= 1024).  Tolerances: the
    four per-channel sums are float32 sums of the same terms in another
    order, within 1e-5 of the sum of the terms' magnitudes (per row count
    for the means); the forward chain (variance, kernel B's coefficients,
    running statistics) and the backward chain from the same sums within
    BN_CHAIN_ULPS; dx and the masked gy from the same coefficients
    bit-equal (the same separately rounded operations); dx end to end
    (each side from its own sums) differs only through the coefficients,
    so within |gy|·|Δmul| + |x|·|Δc2| + |Δc1|, plus 2^-22 of |gy·mul| +
    |x·c2| + |c1| (each side's float32 rounding, which shows where the
    terms cancel), plus one ulp of the activation dtype.  Two launches
    on the same input are bit-equal."""
    from active_learning_tpu_torch.ops import bn_train as bt

    worst = 0.0
    variants = sorted(set(calls))
    dims = (0, 2, 3)
    for i, (shape, has_res, relu) in enumerate(variants):
        dtypes = [torch.bfloat16] + ([torch.float32]
                                     if shape[1] >= 1024 else [])
        for dtype in dtypes:
            fused = dtype == torch.bfloat16
            x, gy, scale = _kernel_c_inputs(shape, dtype, dev, i)
            y = (torch.relu(x.float() * 0.7 - 0.2).to(dtype).contiguous(
                memory_format=torch.channels_last) if relu else None)
            bias = torch.randn(shape[1], device=dev) * 0.1
            n = shape[0] * shape[2] * shape[3]
            inv = float(np.float32(1.0) / np.float32(n))
            running = (torch.randn(shape[1], device=dev),
                       torch.rand(shape[1], device=dev) + 0.5)
            ra = tuple(r.clone() for r in running)
            mean, mean2, var, coeffs = bt.bn_forward_stats(
                x, scale, bias, 1e-5, fused, running)
            sums, dscale_l, dbias_l = bt.bn_backward_local(
                gy, x, y, scale, mean, mean2, 1e-5, fused)
            full = bt.bn_backward(gy, x, y, scale, mean, mean2, 1e-5, fused)
            again = bt.bn_forward_stats(x, scale, bias, 1e-5, fused)[:3] + \
                bt.bn_backward(gy, x, y, scale, mean, mean2, 1e-5, fused)
            rm, rm2 = bt.channel_sums_reference(x, x, inv)
            gm = bt.relu_mask_reference(gy, y)
            rs1, rs2 = bt.channel_sums_reference(gm, x)
            xf, gf = x.float(), gm.float()
            errs = {}
            for name, got, ref, mag in (
                    ("mean", mean, rm, xf.abs().sum(dims) * inv),
                    ("mean2", mean2, rm2, (xf * xf).sum(dims) * inv),
                    ("sum_gy", sums[0], rs1, gf.abs().sum(dims)),
                    ("sum_gy_x", sums[1], rs2, (gf * xf).abs().sum(dims))):
                diff = (got - ref).abs()
                if bool((diff > 1e-5 * mag + 1e-30).any()):
                    raise AssertionError(f"bn_train {name} {shape} {dtype}:"
                                         f" max diff {diff.max().item()}")
                errs[name] = diff.max().item()
            for a, b in zip(again, (mean, mean2, var) + tuple(full)):
                if not torch.equal(a, b):
                    raise AssertionError(f"bn_train {shape} {dtype}: two "
                                         "launches differ")
            p_var, p_coeffs = bt.forward_chain_reference(
                mean, mean2, scale, bias, 1e-5, dtype, fused, ra)
            p_full = bt.backward_coefficients(sums[0], sums[1], scale, mean,
                                              mean2, 1e-5, float(n), dtype,
                                              fused)
            chain_mul = bt.bn_backward_chain(sums, float(n), scale, mean,
                                             mean2, 1e-5, dtype, fused)
            errs["chain_ulps"] = max(
                _hold_bn_chain((var, *coeffs, *running),
                               (p_var, *p_coeffs, *ra),
                               f"forward {shape} {dtype}"),
                _hold_bn_chain(full, p_full, f"backward {shape} {dtype}"),
                _hold_bn_chain((dscale_l, dbias_l, *chain_mul), p_full,
                               f"N-rank backward {shape} {dtype}"))
            dx_same, gres = bt.bn_dx(gy, x, y, *p_full[2:], True)
            if not (torch.equal(dx_same,
                                bt.bn_dx_reference(gy, x, y, *p_full[2:]))
                    and torch.equal(gres, gm)):
                raise AssertionError(f"bn_dx {shape} {dtype}: not bit-equal"
                                     " from the same coefficients")
            p_coef = bt.backward_reference(gy, x, y, scale, rm, rm2, 1e-5,
                                           fused)
            dx_k = bt.bn_dx(gy, x, y, *full[2:]).float()
            dx_p = bt.bn_dx_reference(gy, x, y, *p_coef[2:]).float()
            dm, dc2, dc1 = ((a - b).abs().view(1, -1, 1, 1)
                            for a, b in zip(full[2:], p_coef[2:]))
            m, k2, k1 = (v.view(1, -1, 1, 1) for v in p_coef[2:])
            terms = (gf * m).abs() + (xf * k2).abs() + k1.abs()
            tol = (gf.abs() * dm + xf.abs() * dc2 + dc1
                   + 2.0 ** -22 * terms
                   + _bf16_ulp_of(torch.maximum(dx_k.abs(), dx_p.abs()),
                                  dtype))
            diff = (dx_k - dx_p).abs()
            if bool((diff > tol).any()):
                j = int(torch.argmax(diff - tol))
                w = [t.reshape(-1)[j].item()
                     for t in (dx_k, dx_p, gf, xf, tol)]
                raise AssertionError(
                    f"bn_train dx {shape} {dtype}: max diff "
                    f"{diff.max().item()}; worst element (dx kernel, dx "
                    f"plain, gy, x, tolerance) {w}")
            errs["dx"] = diff.max().item()
            worst = max(worst, errs["dx"])
            detail.append({"kernel": "bn_train", "path": path,
                           "shape": list(shape), "residual": has_res,
                           "relu": relu, "dtype": str(dtype), **errs})
            del x, gy, y, xf, gf, dx_k, dx_p, dx_same, gres, tol, diff
            torch.cuda.empty_cache()
    return worst


def bn_train_bytes(shape, has_res, relu, elem=BF16_BYTES):
    """The bytes kernel C must move for one BatchNorm of a train step:
    the statistics read x; the masked reduction reads gy, x and (with a
    ReLU) y; dx reads gy, x and y and writes dx and, with a residual
    behind the ReLU, the masked gy; plus the [C] vectors (scale, bias,
    running statistics read and written, the chains' outputs)."""
    c = shape[1]
    act = shape[0] * shape[1] * shape[2] * shape[3] * elem
    passes = 1 + (2 + relu) + (3 + relu + (has_res and relu))
    return act * passes + 24 * c * 4


def _launches_per_call(fn, reps: int = 4):
    """Kernels one call of ``fn`` ran on the card, by the profiler's
    count over ``reps`` calls (a complete reading: ``_complete_events``)."""
    events, _ = _complete_events(fn, reps)
    return sum(c for c, _ in events.values()) // reps


def time_bn_train(dev, calls, detail):
    """Over all BatchNorm calls of one bf16 training step, each with its
    residual and ReLU: device time of kernel C (forward statistics with
    their chain, backward reduction with its chain, dx; CUDA events), its
    plain version, its restated bound (``bn_train_bytes``), and
    ``F.batch_norm(training=True)`` forward + backward on the same shapes
    (the library call: the same function plus the normalize pass).  Like
    for like with the library, also the port's whole BatchNorm as the
    model runs it (``bn_train`` forward + backward: kernel C and kernel
    B's normalize with the call's residual and ReLU) beside
    ``F.batch_norm`` with the same residual add and ReLU, forward +
    backward; and the kernels one forward and one backward of it
    launch."""
    import torch.nn.functional as F

    from active_learning_tpu_torch.ops import bn_train as bt

    per, whole, launches = {}, {}, {}
    for key in sorted(set(calls)):
        shape, has_res, relu = key
        x, gy, scale = _kernel_c_inputs(shape, torch.bfloat16, dev, 7)
        c = shape[1]
        y = (torch.relu(x.float() - 1.0).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last) if relu else None)
        bias = torch.zeros(c, device=dev)
        running = (torch.zeros(c, device=dev), torch.ones(c, device=dev))
        mean, mean2, _, _ = bt.bn_forward_stats(x, scale, bias, 1e-5, True)
        inv = float(np.float32(1.0) / np.float32(x.numel() // c))

        def kernel():
            bt.bn_forward_stats(x, scale, bias, 1e-5, True, running)
            _, _, mul, c2, c1 = bt.bn_backward(gy, x, y, scale, mean, mean2,
                                               1e-5, True)
            bt.bn_dx(gy, x, y, mul, c2, c1, has_res)

        def plain():
            m, m2 = bt.channel_sums_reference(x, x, inv)
            bt.forward_chain_reference(m, m2, scale, bias, 1e-5,
                                       torch.bfloat16, True, running)
            _, _, mul, c2, c1 = bt.backward_reference(gy, x, y, scale, mean,
                                                      mean2, 1e-5, True)
            bt.bn_dx_reference(gy, x, y, mul, c2, c1)
            if has_res:
                bt.relu_mask_reference(gy, y)

        xg = x.detach().requires_grad_(True)
        w = scale.detach().requires_grad_(True)
        b = torch.zeros(c, device=dev, requires_grad=True)
        rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
        res = (torch.randn_like(xg).requires_grad_(True) if has_res
               else None)
        wrt = (xg, w, b) + (() if res is None else (res,))

        def library(res=res, relu=relu):
            y_ = F.batch_norm(xg, rm, rv, w, b, training=True, momentum=0.1,
                              eps=1e-5)
            if res is not None:
                y_ = y_ + res
            if relu:
                y_ = F.relu(y_)
            torch.autograd.grad(y_, wrt, gy)

        def port_fwd():
            return bt.bn_train(xg, w, b, 1e-5, True, res, relu, None,
                               running)[0]

        def port():
            torch.autograd.grad(port_fwd(), wrt, gy)

        ms = cuda_ms(kernel, reps=20)
        # The kernels' own device time: at the small shapes the event
        # loop runs at the wrappers' host pace.  No floor: a call's
        # inputs under 50 MB stay in L2 across the loop.
        dev_ms = profiled_device_ms(kernel, 0.0, reps=10)[0]
        plain_ms = cuda_ms(plain, reps=5)
        lib_ms = cuda_ms(library, reps=20)
        nbytes = bn_train_bytes(shape, has_res, relu)
        with torch.no_grad():
            n_fwd = _launches_per_call(port_fwd)
        n_all = _launches_per_call(port)
        launches[key] = (n_fwd, n_all - n_fwd)
        per[key] = (ms, plain_ms, lib_ms, nbytes, dev_ms)
        whole[key] = (cuda_ms(port, reps=20), cuda_ms(library, reps=20))
        detail.append({"kernel": "bn_train", "timed_shape": list(shape),
                       "residual": has_res, "relu": relu,
                       "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                       "library_ms": lib_ms,
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                       "launches_forward": n_fwd,
                       "launches_backward": n_all - n_fwd,
                       "bn_path_ms": whole[key][0],
                       "bn_path_library_ms": whole[key][1],
                       "calls_per_step": calls.count(key)})
        del x, gy, y, xg, res
        torch.cuda.empty_cache()
    tot = [sum(per[k][i] for k in calls) for i in range(5)]
    path = [sum(whole[k][i] for k in calls) for i in range(2)]
    fwd = max(v[0] for v in launches.values())
    bwd = max(v[1] for v in launches.values())
    if fwd > 3 or bwd > 3:
        raise AssertionError(f"a BatchNorm launched {fwd} kernels forward "
                             f"and {bwd} backward (at most 3 each): "
                             f"{launches}")
    log(f"kernel C per B=128 step ({len(calls)} calls): {tot[0]:.3f} ms "
        f"(device {tot[4]:.3f} ms by the profiler; plain {tot[1]:.3f}, "
        f"F.batch_norm fwd+bwd {tot[2]:.3f}, bound "
        f"{tot[3] / HBM_BYTES_PER_S * 1e3:.3f}); the whole BatchNorm "
        f"{path[0]:.3f} ms against F.batch_norm + residual + ReLU "
        f"{path[1]:.3f}; launches per BatchNorm: forward <= {fwd}, "
        f"backward <= {bwd}")
    return {"ms": tot[0], "plain_ms": tot[1], "library_ms": tot[2],
            "bound_ms": tot[3] / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "device_ms": tot[4], "bn_path_ms": path[0],
            "bn_path_library_ms": path[1],
            "launches_per_bn_forward": fwd, "launches_per_bn_backward": bwd}


def bn_host_split(dev, calls):
    """Host time of a training BatchNorm forward + backward
    (``perf_counter``, the card not waited for), by part: kernel B's
    wrapper, kernel C's three wrappers, and the rest (autograd, the
    Function, allocations); means over the calls of one B=128 step.
    Taken after ``time_bn_train``'s profiled readings: in one run the
    profiler sessions right after such host loops lost most events."""
    from active_learning_tpu_torch.ops import bn_act as ba
    from active_learning_tpu_torch.ops import bn_train as bt

    split = {}
    for key in sorted(set(calls)):
        shape, has_res, relu = key
        x, gy, scale = _kernel_c_inputs(shape, torch.bfloat16, dev, 7)
        c = shape[1]
        y = (torch.relu(x.float() - 1.0).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last) if relu else None)
        bias = torch.zeros(c, device=dev)
        running = (torch.zeros(c, device=dev), torch.ones(c, device=dev))
        mean, mean2, _, coeffs = bt.bn_forward_stats(x, scale, bias, 1e-5,
                                                     True)
        res = torch.randn_like(x) if has_res else None

        def wrappers():
            bt.bn_forward_stats(x, scale, bias, 1e-5, True, running)
            _, _, mul, c2, c1 = bt.bn_backward(gy, x, y, scale, mean, mean2,
                                               1e-5, True)
            bt.bn_dx(gy, x, y, mul, c2, c1, has_res)

        xg = x.detach().requires_grad_(True)
        w = scale.detach().requires_grad_(True)
        b = torch.zeros(c, device=dev, requires_grad=True)
        rg = res.requires_grad_(True) if has_res else None
        wrt = (xg, w, b) + (() if rg is None else (rg,))

        def whole():
            out = bt.bn_train(xg, w, b, 1e-5, True, rg, relu, None,
                              running)[0]
            torch.autograd.grad(out, wrt, gy)

        split[key] = (host_us(whole), host_us(wrappers),
                      host_us(lambda: ba.bn_act(x, coeffs, res, relu)))
        del x, gy, y, xg, res, rg
        torch.cuda.empty_cache()
    host = [sum(split[k][i] for k in calls) / len(calls) for i in range(3)]
    out = {"whole_us": host[0], "bn_act_us": host[2],
           "bn_train_wrappers_us": host[1],
           "rest_us": host[0] - host[1] - host[2]}
    log(f"host time a training BatchNorm (forward + backward, mean of "
        f"{len(calls)} calls): {host[0]:.1f} us, of it kernel B's wrapper "
        f"{host[2]:.1f}, kernel C's wrappers {host[1]:.1f}, the rest "
        f"{out['rest_us']:.1f}")
    return out


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


def _odd_sgd_leaves(dev, state_dtype, seed):
    """Leaves of 1, 3, 4, 4097 and 40,000 elements as views at storage
    offsets 0-3 (the kernel's head, vectors and tail); the grads of two
    of them at another offset than their params (never aligned
    together: all scalar)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    sizes, offs = (1, 3, 4, 4097, 40000, 4097), (1, 2, 3, 1, 0, 2)
    grad_shift = (0, 1, 0, 0, 0, 1)

    def views(dtype, shifts):
        return [torch.randn(n + 8, device=dev, generator=gen).to(dtype)[
            (o + k) % 4:][:n] for n, o, k in zip(sizes, offs, shifts)]

    zero = (0,) * len(sizes)
    return (views(torch.float32, zero), views(torch.float32, grad_shift),
            views(state_dtype, zero))


def check_fused_sgd(dev, detail):
    """Kernel D on every leaf of each training path's model with its arg
    pool's lr and weight decay (momentum 0.9), and on odd leaves (views
    at storage offsets 0-3 of 1 to 40,000 elements): bit-equal to its
    plain version at f32 state; at bf16 state the trace within 1 bf16
    ulp and the params within 1e-7."""
    from active_learning_tpu_torch.ops import fused_sgd as fs

    out = {}
    cases = [(path, dataset, name, lr, wd) for path, dataset, name, lr, wd
             in SGD_PATHS] + [("odd", None, None, 0.1, 1e-4)]
    for (path, dataset, name, lr, wd), state in itertools.product(
            cases, (torch.float32, torch.bfloat16)):
        if path == "odd":
            params, grads, traces = _odd_sgd_leaves(dev, state, 5)
        else:
            params, grads, traces = _sgd_leaves(dev, state, 3, dataset,
                                                name)
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
                                     f"state on the {path} leaves")
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


def _kernel_events(fn, reps: int):
    """torch.profiler's kernel events over ``reps`` calls of ``fn``:
    {kernel name: (count, device µs in all)}.  The profiler's schedule
    records one call first and discards it (a session's first launches
    can go unrecorded: on the card, the first session of a process once
    recorded none of one call's events), and each step waits for the
    card, so every recorded kernel ran in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=reps,
                                   repeat=1)) as prof:
        for _ in range(reps + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return {e.key: (e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def _complete_events(fn, reps: int):
    """The profiler's events over ``reps`` calls of ``fn`` from a session
    known complete, and the sessions discarded.  A session counts only
    when every kernel's (and copy's) count is a multiple of ``reps`` and
    equals the counts of the session before it: the profiler loses a
    session's events now and then (on the card, a profile of one call
    has recorded none or some of its kernels, after a long profiled
    window one session lost one kernel of 20 calls, and the sessions
    right after host-time loops have lost most kernels at first), so a
    reading is taken again, up to eight sessions; then this fails.  A
    session that recorded nothing lost all of its events and is not
    compared: late in a long run (phase 20, after phase 19's process
    group) every other session came back empty, and the ones between
    were whole and equal."""
    seen, prev = [], None
    for _ in range(8):
        events = _kernel_events(fn, reps)
        counts = {k: c for k, (c, _) in events.items()}
        if (events and counts == prev
                and all(c % reps == 0 for c in counts.values())):
            return events, max(len(seen) - 1, 0)
        seen.append(counts)
        if events:
            prev = counts
    raise AssertionError(f"the profiler lost kernel events in every "
                             f"session ({reps} calls each): {seen}")


def profiled_device_ms(fn, floor_ms: float, reps: int = 20,
                       warmup: int = 3):
    """Device time per call of ``fn`` from torch.profiler's kernel
    events (the sum over every kernel and copy the calls ran), that time
    by name, and the number of sessions discarded; only a complete
    reading counts (``_complete_events``).  It also fails when the time
    is under ``floor_ms``, the work's bytes bound: lost events or skipped
    work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events, lost = _complete_events(fn, reps)
    by_name = {k: us / 1e3 / reps for k, (_, us) in events.items()}
    ms = sum(by_name.values())
    if ms < floor_ms:
        raise AssertionError(f"device time {ms:.4f} ms a call is under the "
                             f"bytes bound {floor_ms:.4f} ms")
    return ms, by_name, lost


def host_us(fn, reps: int = 50, warmup: int = 3):
    """Median host time of one call of ``fn`` (``time.perf_counter``
    around the call, the device not waited for), in microseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(ts)) * 1e6


def time_fused_sgd(dev):
    """One kernel D step over SSLResNet50's leaves at f32 state and
    ``torch.optim.SGD(momentum=0.9, weight_decay=1e-4,
    fused=True).step()`` on the same tensors: each one's device time
    from the profiler's kernel events and its host time per call
    (``perf_counter``), side by side; the CUDA-event mean over a loop of
    calls (``event_loop_ms``: the host's pace when the host is the
    slower), the plain version, and the bound (read p, g, t; write p, t:
    20 B per parameter)."""
    from active_learning_tpu_torch.ops import fused_sgd as fs

    params, grads, traces = _sgd_leaves(dev, torch.float32, 4)
    nbytes = sum(p.numel() for p in params) * 20
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3

    def step():
        fs.fused_sgd_update(params, grads, traces, 0.1, 0.9, 1e-4)

    before = fs.launches
    ms, by_name, lost = profiled_device_ms(step, bound_ms)
    if fs.launches == before:
        raise AssertionError("kernel D was not launched while timed")
    host = host_us(step)
    loop = cuda_ms(step)
    plain = cuda_ms(lambda: fs.fused_sgd_reference(params, grads, traces,
                                                   0.1, 0.9, 1e-4), reps=10)
    leaves = [torch.nn.Parameter(p) for p in params]
    for leaf, g in zip(leaves, grads):
        leaf.grad = g
    opt = torch.optim.SGD(leaves, lr=0.1, momentum=0.9, weight_decay=1e-4,
                          fused=True)
    lib, lib_names, lib_lost = profiled_device_ms(opt.step, bound_ms)
    lib_host = host_us(opt.step)
    lib_loop = cuda_ms(opt.step)
    out = {"ms": ms, "host_us": host, "event_loop_ms": loop,
           "plain_ms": plain, "library_ms": lib, "library_host_us": lib_host,
           "library_event_loop_ms": lib_loop, "bound_ms": bound_ms,
           "bound_by": "bytes",
           "profiler_sessions_discarded": lost + lib_lost}
    out["over_bound"] = out["ms"] / out["bound_ms"]
    out["over_library"] = out["ms"] / out["library_ms"]
    log(f"kernel D over SSLResNet50's {len(params)} leaves at f32 state: "
        f"device {ms:.4f} ms (profiler) = {out['over_bound']:.2f}x its "
        f"bound {out['bound_ms']:.4f}, {out['over_library']:.2f}x "
        f"SGD(fused=True)'s device {lib:.4f} ms; host {host:.1f} us a call "
        f"(SGD(fused=True) {lib_host:.1f} us); CUDA-event loop {loop:.4f} "
        f"ms (SGD {lib_loop:.4f}); plain {plain:.3f} ms; "
        f"{lost + lib_lost} profiler sessions discarded; kernels "
        f"{sorted(by_name)} against {sorted(lib_names)}")
    return out


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
            "bn_train_bwd_reduce": n_bn * steps, "bn_train_chain": 0,
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
        f"busy ({out['device_busy_share']:.0%}); kernel B "
        f"{out['bn_act_ms_per_step']:.3f} ms of it")
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
        state = {k: st[k].copy() for k in st.files}
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
            "phase_times": times, "state": state, "stderr": res.stderr}


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
            "phase_times": card["phase_times"], "state": card["state"]}


def check_train_step_f32_against_cpu(devices=("cuda", "cpu"),
                                     stem="default", num_classes=10,
                                     hw=32, b=32, pretrained=None):
    """One float32 train step of SSLResNet18 (CIFAR stem, B=32, 10
    classes, non-augmenting view) from the same numpy-seeded weights on
    the card (TF32 off) and on the CPU.  The loss within 1e-4 relative;
    the update (new minus old parameters, over all leaves) within 1e-3 of
    its norm: the same float32 network with every convolution and sum in
    another order on each side.  With ``stem="s2d"`` (and a class count
    other than 10) the ImageNet-layout model with the s2d stem, fed
    space-to-depth rows, whose stem gradient is kernel I on the card.
    With ``pretrained`` (a SimCLR-layout checkpoint's path) the encoder
    is the checkpoint's and the step is a fine-tuning step: BatchNorm in
    eval mode, gradients through kernel B′ on the card."""
    from active_learning_tpu_torch.data.pipeline import space_to_depth
    from active_learning_tpu_torch.config import PretrainedConfig
    from active_learning_tpu_torch.config import TrainConfig
    from active_learning_tpu_torch.ops import bn_act as ba
    from active_learning_tpu_torch.utils.pretrained import apply_pretrained
    from active_learning_tpu_torch.data.core import SYNTH_NORM, ViewSpec
    from active_learning_tpu_torch.device import set_float32_precision
    from active_learning_tpu_torch.models.factory import get_network
    from active_learning_tpu_torch.models.resnet import init_weights
    from active_learning_tpu_torch.train.trainer import Trainer

    set_float32_precision(torch.float32)
    rng = np.random.default_rng(SEED + 2)
    images = rng.integers(0, 256, (b, hw, hw, 3), dtype=np.uint8)
    batch = {"image": space_to_depth(images) if stem == "s2d" else images,
             "label": rng.integers(0, num_classes, b).astype(np.int32),
             "mask": np.ones(b, np.float32)}
    view = ViewSpec(SYNTH_NORM, augment=False)
    cfg = TrainConfig() if pretrained is None else TrainConfig(
        pretrained=PretrainedConfig(path=pretrained,
                                    required_key=("encoder",),
                                    skip_key=("linear",)))
    out = []
    for device in devices:
        model = get_network("imagenet", "SSLResNet18",
                            num_classes=num_classes, dtype="float32",
                            stem=stem, device=device)
        init_weights(model, torch.Generator().manual_seed(SEED))
        if pretrained is not None:
            apply_pretrained(model, cfg.pretrained)
        before = [p.detach().cpu().clone() for p in model.parameters()]
        trainer = Trainer(model, cfg, num_classes, device)
        model.train(trainer.train_bn)
        bwd = ba.bwd_launches
        loss, gnorm = trainer.train_step(
            trainer.to_device(batch), 0.1,
            torch.ones(num_classes, device=device), view, None)
        if pretrained is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize()
            if trainer.train_bn or ba.bwd_launches - bwd != 20:
                raise AssertionError(
                    f"the fine-tuning step launched kernel B' "
                    f"{ba.bwd_launches - bwd} times (20 BatchNorms)")
        delta = torch.cat([(p.detach().cpu() - b).reshape(-1) for p, b in
                           zip(model.parameters(), before)])
        out.append((float(loss), float(gnorm), delta))
    (lc, gc, dc), (lp, gp, dp) = out
    rel = abs(lc - lp) / abs(lp)
    upd = (dc - dp).norm().item() / dp.norm().item()
    if rel > 1e-4 or upd > 1e-3:
        raise AssertionError(f"f32 train step card vs CPU: loss rel {rel}, "
                             f"update rel {upd}")
    log(f"f32 {'fine-tuning' if pretrained else 'train'} step ({stem} "
        f"stem) card vs CPU: loss {lc:.6f} vs "
        f"{lp:.6f} (rel {rel:.2e}), grad norm {gc:.6f} vs {gp:.6f}, update "
        f"rel {upd:.2e}")
    return {"loss_rel": rel, "update_rel": upd, "grad_norm": [gc, gp]}


# -- phase 7: the geometry samplers' kernels against their plain versions ----

def _bound(nbytes: float, flops: float) -> dict:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return {"bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def _kc_pool(dev, n, dims, seed, n_labeled):
    """Seeded factors on the card, their squared norms, the min distance
    to ``n_labeled`` random rows (plain version) and the selectable mask."""
    from active_learning_tpu_torch.ops import kcenter as kc

    g = torch.Generator(device=dev).manual_seed(seed)
    factors = tuple(torch.randn(n, d, device=dev, generator=g)
                    for d in dims)
    sqn = None
    for f in factors:
        sq = (f * f).sum(dim=1)
        sqn = sq if sqn is None else sqn * sq
    perm = torch.randperm(n, device=dev, generator=g)
    labeled, rest = perm[:n_labeled], perm[n_labeled:]
    min_dist = torch.full((n,), float("inf"), device=dev)
    for i in range(0, n_labeled, 1024):
        kc.fold_reference(factors, sqn, min_dist, labeled[i:i + 1024])
    sel = torch.ones(n, device=dev)
    sel[labeled] = 0.0
    return factors, sqn, min_dist, sel, labeled, rest


def _check_fold_select(factors, sqn, md0, sel0, centers, q, where, detail,
                       path="select"):
    """Kernel E's fold + top-q against its plain version: min_dist within
    kc.fold_tolerance (NaN and ±inf at the same rows), selectable equal,
    the kernel's top-q exactly the top-q of its own min_dist (a NaN
    first), and where a pick differs from the plain one, the two rows'
    plain distances finite and within twice the tolerance (the gap is
    printed).  Returns the max abs error of min_dist."""
    from active_learning_tpu_torch.ops import kcenter as kc

    depth = sum(f.shape[1] for f in factors)
    c_max = _finite_max(sqn[centers]) if centers.numel() else 0.0
    tol = kc.fold_tolerance(sqn, c_max, depth)
    md_k, sel_k, md_p, sel_p = md0.clone(), sel0.clone(), md0.clone(), \
        sel0.clone()
    vk, ik = kc.fold_select(factors, sqn, md_k, sel_k, centers, q)
    vp, ip = kc.fold_select_reference(factors, sqn, md_p, sel_p, centers, q)
    torch.cuda.synchronize()
    err = _finite_err(md_k, md_p)
    if not torch.equal(sel_k, sel_p) or not same_special(md_k, md_p) or \
            bool((err > tol).any()):
        raise AssertionError(f"kcenter fold at {where}: max err "
                             f"{err.max().item()} against tolerance "
                             f"{tol.max().item()}, NaN/inf equal "
                             f"{same_special(md_k, md_p)}")
    own_v, own_i = kc.top_q(torch.where(
        sel_k > 0, md_k, torch.full_like(md_k, float("-inf"))), q)
    if not (_equal_nan(vk, own_v) and torch.equal(ik, own_i)):
        raise AssertionError(f"kcenter top-{q} at {where} is not the top-q "
                             "of the kernel's own distances")
    differ = (ik != ip).nonzero()[:, 0].tolist()
    if any(not bool(torch.isfinite(vp[r])) for r in differ):
        raise AssertionError(f"kcenter top-{q} at {where}: a NaN or inf "
                             f"rank differs (kernel {ik.tolist()}, plain "
                             f"{ip.tolist()})")
    for r in differ:
        gap = abs(float(md_p[ik[r]]) - float(vp[r]))
        log(f"kcenter top-{q} at {where}: rank {r} kernel row {int(ik[r])} "
            f"plain row {int(ip[r])}, distance gap {gap:.3g} (bound "
            f"{2 * tol.max().item():.3g})")
        if gap > 2 * tol.max().item():
            raise AssertionError("kcenter pick differs beyond the bound")
    detail.append({"kernel": "kcenter_fold_select", "path": path,
                   "where": where, "q": q,
                   "max_abs_err": err.max().item(),
                   "tolerance_max": tol.max().item(),
                   "picks_differ": len(differ)})
    return err.max().item()


def _check_min_fold(factors, sqn, centers, where, detail, path="select"):
    from active_learning_tpu_torch.ops import kcenter as kc

    n = sqn.shape[0]
    md_k = torch.full((n,), float("inf"), device=sqn.device)
    md_p = md_k.clone()
    kc.min_fold(factors, sqn, md_k, centers)
    kc.fold_reference(factors, sqn, md_p, centers)
    torch.cuda.synchronize()
    tol = kc.fold_tolerance(sqn, _finite_max(sqn[centers]),
                            sum(f.shape[1] for f in factors))
    err = _finite_err(md_k, md_p)
    if not same_special(md_k, md_p) or bool((err > tol).any()):
        raise AssertionError(f"kcenter min_fold at {where}: max err "
                             f"{err.max().item()}, NaN/inf equal "
                             f"{same_special(md_k, md_p)}")
    detail.append({"kernel": "kcenter_min_fold", "path": path, "where": where,
                   "centers": centers.numel(),
                   "max_abs_err": err.max().item(),
                   "tolerance_max": tol.max().item()})
    return err.max().item()


def _check_batch_pass(factors, sqn, md0, sel0, state0, where, detail,
                      path="select"):
    """One pass of kernel E's batched greedy from (``md0``, ``sel0``,
    ``state0``) against its plain version: min_dist within
    kc.fold_tolerance, selectable equal; the kernel's top q exactly the
    top q of its own min_dist; its accepted picks and their distances
    bit-equal to the q = 1 kernel scan's from the same state (the
    re-check's [q, q] distances are the fold's own numbers; NaN at the
    same picks); and where a pick differs from the plain pass's, the two
    rows' distances finite and within twice the tolerance.  Returns the
    max abs error of min_dist."""
    from active_learning_tpu_torch.ops import kcenter as kc

    dev = sqn.device
    centers = state0.seq if state0.passes else state0.seq[:0]
    nc = centers.numel()
    depth = sum(f.shape[1] for f in factors)
    c_max = _finite_max(sqn[centers]) if centers.numel() else 0.0
    tol = kc.fold_tolerance(sqn, c_max, depth)
    md_k, sel_k, st_k = md0.clone(), sel0.clone(), state0.clone()
    md_p, sel_p, st_p = md0.clone(), sel0.clone(), state0.clone()
    kc.batch_pass(factors, sqn, md_k, sel_k, st_k)
    kc.batch_pass_reference(factors, sqn, md_p, sel_p, st_p)
    torch.cuda.synchronize()
    err = _finite_err(md_k, md_p)
    if not torch.equal(sel_k, sel_p) or not same_special(md_k, md_p) or \
            bool((err > tol).any()):
        raise AssertionError(f"kcenter batch pass at {where}: max err "
                             f"{err.max().item()} against tolerance "
                             f"{tol.max().item()}, NaN/inf equal "
                             f"{same_special(md_k, md_p)}")
    q = state0.q
    own_v, own_i = kc.top_q(torch.where(
        sel_k > 0, md_k, torch.full_like(md_k, float("-inf"))), q)
    if not (_equal_nan(st_k.top_v, own_v) and torch.equal(st_k.top_i,
                                                          own_i)):
        raise AssertionError(f"kcenter batch pass at {where}: the top {q} "
                             "is not the top q of the kernel's own distances")
    c0 = int(state0.count[0])
    n_acc = int(st_k.count[0]) - c0
    md_1, sel_1 = md0.clone(), sel0.clone()
    v1 = torch.zeros(1, device=dev)
    i1 = torch.zeros(1, dtype=torch.int64, device=dev)
    for step in range(n_acc):
        kc.fold_select(factors, sqn, md_1, sel_1, centers, 1, v1, i1)
        d_b = st_k.dists[c0 + step:c0 + step + 1]
        nan = bool(torch.isnan(v1))
        same = nan == bool(torch.isnan(d_b)) and (nan or torch.equal(
            v1.view(torch.int32), d_b.view(torch.int32)))
        if int(i1) != int(st_k.picks[c0 + step]) or not same:
            raise AssertionError(
                f"kcenter batch pass at {where}: accepted pick {step} is row "
                f"{int(st_k.picks[c0 + step])} at "
                f"{float(st_k.dists[c0 + step])}, the q = 1 scan's row "
                f"{int(i1)} at {float(v1)}")
        centers = i1.clone()
    got = st_k.picks[c0:c0 + n_acc].tolist()
    want = st_p.picks[c0:c0 + int(st_p.count[0]) - c0].tolist()
    differ = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                  None)
    if differ is not None:
        gap = abs(float(md_p[got[differ]]) - float(md_p[want[differ]]))
        if gap != gap:
            raise AssertionError(f"kcenter batch pass at {where}: pick "
                                 f"{differ} differs at a NaN distance")
        log(f"kcenter batch pass at {where}: pick {differ} kernel row "
            f"{got[differ]}, plain row {want[differ]}, distance gap "
            f"{gap:.3g} (bound {2 * tol.max().item():.3g})")
        if gap > 2 * tol.max().item():
            raise AssertionError("kcenter batch pick differs beyond the "
                                 "bound")
    detail.append({"kernel": "kcenter_batch_pass", "path": path,
                   "where": where, "q": q, "nc": nc,
                   "accepted": n_acc, "plain_accepted": len(want),
                   "max_abs_err": err.max().item(),
                   "tolerance_max": tol.max().item(),
                   "first_difference": differ})
    return err.max().item()


def _kc_pass_bound(n, dims, q, blocks):
    """The least time of one batched pass: the factor rows, sqn, min_dist
    (read and written) and selectable read once, the blocks' candidates
    written and read, and the merge's reads of the q candidate rows;
    2 q flops an element."""
    d = sum(dims)
    nbytes = n * (d + 4) * 4.0 + 2 * blocks * q * 8.0 + q * d * 4.0
    return _bound(nbytes, 2.0 * q * n * d)


def _check_fold_draw(factors, sqn, md0, sel0, steps, seed, where, detail,
                     path="select"):
    """Kernel E's D² draw: Threefry bits bit-equal to utils/threefry,
    Gumbel noise within one ulp of max(1, |g|), the same rows drawn over
    ``steps`` steps, their weights within the fold tolerance."""
    from active_learning_tpu_torch.ops import kcenter as kc
    from active_learning_tpu_torch.utils import threefry

    dev, n = sqn.device, sqn.shape[0]
    keys = threefry.split(threefry.prng_key(seed), steps)
    key0 = (int(keys[0, 0]), int(keys[0, 1]))
    bits, gum = kc.random_bits(key0, n, dev)
    if not torch.equal(bits, threefry.random_bits(key0, n, dev)):
        raise AssertionError(f"kcenter Threefry bits differ at {where}")
    g_ref = threefry.gumbel(key0, n, dev)
    g_err = (gum - g_ref).abs()
    if bool((g_err > torch.clamp(g_ref.abs(), min=1.0) * 2.0 ** -23).any()):
        raise AssertionError(f"kcenter Gumbel noise at {where}: max err "
                             f"{g_err.max().item()}")
    md_k, sel_k, md_p, sel_p = md0.clone(), sel0.clone(), md0.clone(), \
        sel0.clone()
    picks = torch.zeros(steps, dtype=torch.int64, device=dev)
    vals = torch.zeros(steps, device=dev)
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    tol = _finite_max(kc.fold_tolerance(sqn, _finite_max(sqn),
                                        sum(f.shape[1] for f in factors)))
    err = 0.0
    for i in range(steps):
        key = (int(keys[i, 0]), int(keys[i, 1]))
        kc.fold_draw(factors, sqn, md_k, sel_k, picks[i - 1:i] if i else none,
                     key, vals[i:i + 1], picks[i:i + 1])
        prev = picks[i - 1:i].clone() if i else none
        vp, ip = kc.fold_draw_reference(factors, sqn, md_p, sel_p, prev, key)
        if int(ip) != int(picks[i]) or \
                bool(torch.isnan(vp)) != bool(torch.isnan(vals[i])):
            raise AssertionError(f"kcenter draw at {where}, step {i}: kernel "
                                 f"row {int(picks[i])} weight "
                                 f"{float(vals[i])}, plain row {int(ip)} "
                                 f"weight {float(vp)}")
        if bool(torch.isfinite(vp)):
            err = max(err, abs(float(vp) - float(vals[i])))
    if err > tol:
        raise AssertionError(f"kcenter draw weights at {where}: err {err}")
    detail.append({"kernel": "kcenter_fold_draw", "path": path, "where": where,
                   "steps": steps, "gumbel_max_err": g_err.max().item(),
                   "weight_max_err": err})
    return max(err, g_err.max().item())


# The kinds of the non-finite pool rows (``nonfinite_rows``).
KC_NONFINITE_KINDS = ["nan", "+inf", "-inf", "+inf -inf"]


def _kc_nonfinite(factors, labeled, rest, seed):
    """The pool with 8 unlabeled rows, ``rest[8:16]``, of the first
    factor made NaN, +inf, -inf and +inf beside -inf
    (``nonfinite_rows``), its squared norms and the plain min distance to
    the labeled rows.  Those rows' distances come out NaN (a NaN
    feature, or inf - inf); a NaN row among the centers makes every
    distance NaN."""
    from active_learning_tpu_torch.ops import kcenter as kc

    rows = rest[8:16]
    f0 = factors[0].clone()
    f0[rows] = torch.from_numpy(nonfinite_rows(
        f0[rows].cpu().numpy(), KC_NONFINITE_KINDS, seed)).to(f0.device)
    factors = (f0,) + tuple(factors[1:])
    sqn = None
    for f in factors:
        sq = (f * f).sum(dim=1)
        sqn = sq if sqn is None else sqn * sq
    min_dist = torch.full_like(sqn, float("inf"))
    for i in range(0, labeled.numel(), 1024):
        kc.fold_reference(factors, sqn, min_dist, labeled[i:i + 1024])
    return factors, sqn, min_dist, rows


def check_kcenter(dev, detail):
    """Kernel E at the main path's shapes: one factor [13,000, 2048] (a
    partition of the ImageNet sweep, 5,000 labeled), the pooled BADGE
    factors [13,000, 16] + [13,000, 32], and the unpartitioned pool
    [131,072, 2048] (130,000 rows bucketed, 50,000 labeled) for the
    fold; each also with 8 unlabeled rows made NaN, +inf, -inf and +inf
    beside -inf (``_kc_nonfinite``), where all four entry points must put
    NaN and ±inf where the plain versions do, rank a NaN first and draw
    uniformly.  Then timings at 131,072 x 2048, q = 8."""
    from active_learning_tpu_torch.ops import kcenter as kc

    def hold(factors, sqn, md0, sel0, labeled, rest, where, bad=None):
        err = 0.0
        for q in (1, 8):
            err = max(err, _check_fold_select(factors, sqn, md0, sel0,
                                              rest[:q], q, where, detail))
        if bad is not None:  # a +inf row among the centers
            err = max(err, _check_fold_select(
                factors, sqn, md0, sel0, bad[:1], 8, where + " inf center",
                detail))
        state = kc.BatchState(sqn.shape[0], 10000, 8, dev)
        err = max(err, _check_batch_pass(factors, sqn, md0, sel0, state,
                                         where + " pass 1", detail))
        md1, sel1 = md0.clone(), sel0.clone()
        kc.batch_pass(factors, sqn, md1, sel1, state)
        err = max(err, _check_batch_pass(factors, sqn, md1, sel1, state,
                                         where + " pass 2", detail))
        del md1, sel1, state
        err = max(err, _check_min_fold(factors, sqn, labeled[:1024], where,
                                       detail))
        if bad is not None:
            err = max(err, _check_min_fold(
                factors, sqn, torch.cat([labeled[:120], bad]),
                where + " non-finite centers", detail))
        if sqn.shape[0] == 13000:
            err = max(err, _check_fold_draw(factors, sqn, md0, sel0, 20,
                                            sqn.shape[0], where, detail))
        return err

    err = 0.0
    for n, dims, n_lab in ((13000, (2048,), 5000), (13000, (16, 32), 5000),
                           (131072, (2048,), 50000)):
        where = f"N={n} D={'+'.join(map(str, dims))}"
        factors, sqn, md0, sel0, labeled, rest = _kc_pool(dev, n, dims, n,
                                                          n_lab)
        err = max(err, hold(factors, sqn, md0, sel0, labeled, rest, where))
        factors, sqn, md0, bad = _kc_nonfinite(factors, labeled, rest, n)
        err = max(err, hold(factors, sqn, md0, sel0, labeled, rest,
                            where + " non-finite rows", bad))
        del factors, sqn, md0, sel0
        torch.cuda.empty_cache()
    log(f"kernel E checks passed (finite and non-finite pools): max abs "
        f"err {err:.3g}")

    # Timings at the unpartitioned sweep's pool.
    n, d, q = 131072, 2048, 8
    factors, sqn, md, sel, labeled, rest = _kc_pool(dev, n, (d,), 7, 50000)
    centers = rest[:q].clone()
    state = kc.BatchState(n, 10000, q, dev)
    kc.batch_pass(factors, sqn, md, sel, state)  # passes fold q centers now
    ms = cuda_ms(lambda: kc.batch_pass(factors, sqn, md, sel, state),
                 reps=20)
    plain = cuda_ms(lambda: kc.batch_pass_reference(factors, sqn, md, sel,
                                                    state), reps=5)
    if int(state.count[0]) >= state.budget:
        raise AssertionError("kcenter timing: the state ran out of budget")
    x = factors[0]
    ninf = torch.full_like(md, float("-inf"))

    def library():
        d_ = sqn[:, None] + sqn[centers][None, :] - 2.0 * (x @ x[centers].T)
        torch.minimum(md, d_.min(dim=1).values, out=md)
        return torch.topk(torch.where(sel > 0, md, ninf), q)

    from active_learning_tpu_torch.device import full_float32
    with full_float32():
        lib = cuda_ms(library, reps=20)
    times = {"ms": ms, "plain_ms": plain, "library_ms": lib,
             **_kc_pass_bound(n, (d,), q, state.scratch.p.numel() // 2)}
    chunk = labeled[:1024].clone()
    mf_ms = cuda_ms(lambda: kc.min_fold(factors, sqn, md, chunk), reps=5)
    mf_bound = _bound(n * (d + 2) * 4.0, 2.0 * 1024 * n * d)
    extra = {
        "fold_select_q8_ms": cuda_ms(lambda: kc.fold_select(
            factors, sqn, md, sel, centers, q), reps=20),
        "min_fold_1024_ms": mf_ms,
        "min_fold_1024_plain_ms": cuda_ms(lambda: kc.fold_reference(
            factors, sqn, md, chunk), reps=5),
        "min_fold_1024_bound": mf_bound,
        "min_fold_1024_peak_share": mf_bound["bound_ms"] / mf_ms}
    del factors, sqn, md, sel, x, state
    torch.cuda.empty_cache()
    a_f, sqn, md, sel, _, _ = _kc_pool(dev, 13000, (16, 32), 8, 5000)
    out_v = torch.zeros(1, device=dev)
    out_i = torch.zeros(1, dtype=torch.int64, device=dev)
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    extra["draw_13000_pooled_ms"] = cuda_ms(lambda: kc.fold_draw(
        a_f, sqn, md, sel, none, (1, 2), out_v, out_i), reps=20)
    extra["draw_13000_pooled_plain_ms"] = cuda_ms(
        lambda: kc.fold_draw_reference(a_f, sqn, md, sel, none, (1, 2)),
        reps=20)
    del a_f, sqn, md, sel
    torch.cuda.empty_cache()
    detail.append({"kernel": "kcenter", "timings": {**times, **extra}})
    log(f"kernel E's batched pass at N={n} D={d} q={q}: {ms:.4f} ms (plain "
        f"{plain:.3f}, library {lib:.4f}, bound {times['bound_ms']:.4f} by "
        f"{times['bound_by']}); {extra}")
    return err, times


def _check_radii(emb, kernel, bias, where, detail, path):
    """Kernel F against its plain version on these inputs: pair norms
    within 2 D eps of themselves and the kernel's table equal to its
    transpose bit for bit; on rows whose embedding holds a NaN or ±inf,
    pred equal and NaN and ±inf in the radii and min_margin where the
    plain version has them; on the others predictions equal or their
    logits within br.logits_tolerance, radii within br.radii_tolerance,
    +inf at the same entries.  Returns (max abs err, the kernel's pair
    norms)."""
    from active_learning_tpu_torch.ops import boundary_radii as br

    emb, kernel, bias = (t.to(torch.float32) for t in (emb, kernel, bias))
    d = emb.shape[1]
    norms_k = br.head_pair_norms(kernel)
    norms_p = br.head_pair_norms_reference(kernel)
    got = br.boundary_radii(emb, kernel, bias, norms_p)
    ref = br.boundary_radii_reference(emb, kernel, bias, norms_p)
    torch.cuda.synchronize()
    n_err = (norms_k - norms_p).abs()
    if bool((n_err > 2 * d * 2.0 ** -23 * norms_p + 1e-30).any()):
        raise AssertionError(f"head_pair_norms: max err {n_err.max()}")
    if not torch.equal(norms_k, norms_k.T):
        raise AssertionError(f"head_pair_norms at {path} {where}: the table "
                             "is not symmetric bit for bit")
    bad = ~torch.isfinite(emb).all(dim=1)
    if not (torch.equal(got["pred"][bad], ref["pred"][bad])
            and same_special(got["radii"][bad], ref["radii"][bad])
            and same_special(got["min_margin"][bad],
                             ref["min_margin"][bad])):
        raise AssertionError(f"boundary_radii at {path} {where}: a row with "
                             "NaN or inf differs from the plain version")
    same = (got["pred"] == ref["pred"]) & ~bad
    differ = (got["pred"] != ref["pred"]) & ~bad
    if bool(differ.any()):
        from active_learning_tpu_torch.device import full_float32
        with full_float32():
            logits = emb @ kernel + bias
        rows = differ.nonzero()[:, 0]
        gap = (logits[rows, got["pred"][rows].long()]
               - logits[rows, ref["pred"][rows].long()]).abs()
        log(f"boundary_radii: {len(rows)} predictions differ, logit gaps "
            f"{gap.tolist()}")
        if bool((gap > br.logits_tolerance(emb, kernel)[rows]).any()):
            raise AssertionError("boundary_radii predictions differ beyond "
                                 "the bound")
    rk, rp = got["radii"][same], ref["radii"][same]
    fin = torch.isfinite(rp)
    tol = br.radii_tolerance(emb[same], rp.where(fin, torch.zeros_like(rp)))
    r_err = _finite_err(rk, rp)
    if not torch.equal(torch.isinf(rk), torch.isinf(rp)) or \
            bool((r_err > tol).any()):
        raise AssertionError(f"boundary_radii: max err {r_err.max()}")
    mm_err = (got["min_margin"][same] - ref["min_margin"][same]).abs()
    if bool((mm_err > tol.max(dim=1).values).any()):
        raise AssertionError("boundary_radii min_margin differs")
    err = max(r_err.max().item() if r_err.numel() else 0.0,
              n_err.max().item())
    detail.append({"kernel": "boundary_radii", "path": path, "where": where,
                   "max_abs_err": err, "preds_differ": int(differ.sum()),
                   "nonfinite_rows": int(bad.sum())})
    return err, norms_k


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    return float(out) * 1e6


def _issue_bound(nbytes: float, lane_instr: float, clock_hz: float,
                 flops: float) -> dict:
    """The bound of float32 work on the CUDA cores counted in issue slots:
    ``lane_instr`` lane instructions over 132 SMs x 128 lanes at the SM
    clock (an FSUB cannot fuse into an FMA), or the bytes, the larger;
    the FLOP bound (``flops`` over 67 TFLOP/s) beside it, labelled."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = lane_instr / (H100_SMS * F32_LANES_PER_SM * clock_hz)
    return {"bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "flop_bound_ms": max(t_b, flops / F32_FLOPS_PER_S) * 1e3}


# Shapes of the ragged and non-finite checks of phase 7: (B, C, D).
RADII_EDGE_SHAPES = ((7, 10, 33), (300, 1001, 2050), (1, 3, 5),
                     (256, 1000, 2048))


def check_boundary_radii(dev, detail):
    """Kernel F at MASE's full-width shapes: [256, 2048] embeddings
    against a [1000, 2048] head (the head's rows contiguous, as the
    model's ``linear.weight`` gives them); the pair norms of that head;
    ragged shapes and embedding rows with NaN, +inf and -inf; the kernels
    a call launches by the C entry's count and by the profiler."""
    from active_learning_tpu_torch.ops import boundary_radii as br

    b, c, d = 256, 1000, 2048
    g = torch.Generator(device=dev).manual_seed(3)
    emb = torch.randn(b, d, device=dev, generator=g)
    kernel = (torch.randn(c, d, device=dev, generator=g) * 0.05).T
    bias = torch.randn(c, device=dev, generator=g) * 0.1
    err, norms_k = _check_radii(emb, kernel, bias, f"B={b} C={c} D={d}",
                                detail, "query")
    for i, (eb, ec, ed) in enumerate(RADII_EDGE_SHAPES):
        ge = torch.Generator(device=dev).manual_seed(10 + i)
        e = torch.from_numpy(nonfinite_rows(
            torch.randn(eb, ed, device=dev, generator=ge).cpu().numpy(),
            ["finite", "nan", "+inf", "-inf", "+inf -inf"], i)).to(dev)
        k = torch.randn(ed, ec, device=dev, generator=ge) * 0.05
        err = max(err, _check_radii(
            e, k, torch.randn(ec, device=dev, generator=ge) * 0.1,
            f"B={eb} C={ec} D={ed}", detail, "phase7 nonfinite")[0])

    def radii():
        br.boundary_radii(emb, kernel, bias, norms_k)

    def pair_norms():
        br.head_pair_norms(kernel)

    # The kernels a call by the C entry's count, held against the
    # profiler's kernel events of the same calls (as phase 11 holds
    # kernel H's), and the device time, both from a session that holds
    # every call's events: this fails when every session lost some.
    launched, reps = {}, 20
    for name, fn, counter, want in (
            ("radii", radii, "radii_launches", 2),
            ("pair_norms", pair_norms, "pair_norms_launches", 1)):
        calls = [0]

        def counted_fn(fn=fn):
            calls[0] += 1
            fn()

        before = getattr(br, counter)
        dev_ms, profiled = _device_ms_a_call(counted_fn, reps, want)
        c_entry = (getattr(br, counter) - before) / calls[0]
        whole = [k for n, k in profiled if n == reps * want]
        if (dev_ms is None or c_entry != want
                or any(k > c_entry * reps for _, k in profiled)
                or any(k != c_entry * reps for k in whole)):
            raise AssertionError(f"kernel F {name}: {c_entry} kernels a call "
                                 f"by the C entry; the profiler's sessions "
                                 f"(events, kernel events) over {reps} calls: "
                                 f"{profiled}")
        launched[name] = {"c_entry": c_entry, "profiler": whole[0] / reps,
                          "device_ms": dev_ms}
    ms = cuda_ms(radii)
    plain = cuda_ms(lambda: br.boundary_radii_reference(emb, kernel, bias,
                                                        norms_k), reps=5)
    from active_learning_tpu_torch.device import full_float32
    with full_float32():
        lib = cuda_ms(lambda: torch.addmm(bias, emb, kernel))
    norms_ms = cuda_ms(pair_norms, reps=10)
    norms_plain = cuda_ms(lambda: br.head_pair_norms_reference(kernel),
                          reps=3)
    clock = sm_clock_hz()
    times = {"ms": ms, "device_ms": launched["radii"]["device_ms"],
             "plain_ms": plain, "library_ms": lib,
             "library_call": "torch.addmm(bias, e, W) (the logits only: "
                             "no call forms the weight difference first; "
                             "a labelled reference)",
             # Issue slots: B*C*D FFMA (logits), then an FSUB and an FFMA
             # a term (radii); the FLOP bound counts 2 + 3 flops a term.
             **_issue_bound(4.0 * (b * d + c * d + 2 * c + 2 * b * c + 2 * b),
                            3.0 * b * c * d, clock, 5.0 * b * c * d),
             "sm_clock_mhz": clock / 1e6,
             "kernels_a_call": launched,
             "pair_norms_ms": norms_ms,
             "pair_norms_device_ms": launched["pair_norms"]["device_ms"],
             "pair_norms_plain_ms": norms_plain,
             # The upper triangle's C*C/2 pairs, an FSUB and an FFMA a
             # feature; the FLOP bound is the whole table's 3 C*C*D.
             "pair_norms_bound": _issue_bound(4.0 * (c * d + c * c),
                                              1.0 * c * c * d, clock,
                                              3.0 * c * c * d)}
    detail.append({"kernel": "boundary_radii", "timings": times})
    log(f"kernel F checks passed (max err {err:.3g}): {ms:.4f} ms, device "
        f"{times['device_ms']} ms (plain {plain:.3f}, addmm {lib:.4f}, "
        f"bound {times['bound_ms']:.4f} by {times['bound_by']}, FLOP bound "
        f"{times['flop_bound_ms']:.4f}); pair norms {norms_ms:.4f} ms, "
        f"device {times['pair_norms_device_ms']} (bound "
        f"{times['pair_norms_bound']['bound_ms']:.4f}); kernels a call "
        f"{launched}")
    return err, times


def _check_badge(logits, emb, where, detail, path):
    """Kernel G against its plain version on these inputs, pooled and
    unpooled: NaN and ±inf at the same entries, the finite ones within
    1e-6 + 1e-5 |ref|.  Returns the max abs err."""
    from active_learning_tpu_torch.ops import badge as bg

    err = 0.0
    for pool in (False, True):
        got = bg.badge_factors(logits, emb, pool)
        ref = bg.badge_factors_reference(logits, emb, pool)
        torch.cuda.synchronize()
        for k in ("grad_a", "grad_e"):
            if got[k].shape != ref[k].shape or not same_special(got[k],
                                                                ref[k]):
                raise AssertionError(f"badge {k} pool={pool} at {path} "
                                     f"{where}: shape or NaN/inf differ")
            e = _finite_err(got[k], ref[k])
            if bool((e > 1e-6 + 1e-5 * ref[k].abs()).any()):
                raise AssertionError(f"badge {k} pool={pool} at {path} "
                                     f"{where}: max err {e.max().item()}")
            err = max(err, e.max().item())
        detail.append({"kernel": "badge", "path": path, "where": where,
                       "pool_512": pool, "shapes": [list(got[k].shape)
                                                    for k in got],
                       "nonfinite": int((~torch.isfinite(
                           ref["grad_e"])).sum()),
                       "max_abs_err": err})
    return err


def check_badge(dev, detail):
    """Kernel G at BADGE's full-width shapes: [256, 1000] logits and
    [256, 2048] embeddings, with and without the 512-d pooling, on
    finite rows and on rows holding NaN, +inf and -inf
    (``nonfinite_rows``, logits and embeddings a kind apart), and at the
    CIFAR width (C = 10, D = 512: overlapping bins) on such rows.  Timed
    pooled and unpooled: CUDA events over back-to-back calls, the device
    time (the profiler's kernel events, ``_device_ms_a_call``: a session
    that holds every call's kernel) and the host time a call, beside the
    plain version and the bytes bound."""
    from active_learning_tpu_torch.ops import badge as bg

    b, c, d = 256, 1000, 2048
    g = torch.Generator(device=dev).manual_seed(4)
    logits = torch.randn(b, c, device=dev, generator=g) * 3.0
    emb = torch.randn(b, d, device=dev, generator=g)
    err = _check_badge(logits, emb, f"B={b} C={c} D={d}", detail, "query")
    kinds = list(NONFINITE_KINDS)
    for bb, cc, dd in ((b, c, d), (64, 10, 512)):
        x = np.random.default_rng(cc).standard_normal((bb, cc + dd)) \
            .astype(np.float32)
        nl = torch.from_numpy(nonfinite_rows(x[:, :cc] * 3.0, kinds, cc))
        ne = torch.from_numpy(nonfinite_rows(x[:, cc:], kinds[1:] + kinds[:1],
                                             dd))
        err = max(err, _check_badge(nl.to(dev), ne.to(dev),
                                    f"B={bb} C={cc} D={dd} non-finite rows",
                                    detail, "query"))
    before = bg.launches
    times = {}
    for pool, key in ((True, ""), (False, "unpooled_")):
        fn = (lambda p=pool: bg.badge_factors(logits, emb, p))
        bound = (_bound(4.0 * (b * c + b * d + b * (16 + 32)),
                        b * (6.0 * c + 2.0 * d)) if pool
                 else _bound(4.0 * 2 * b * c, 6.0 * b * c))
        times[key + "ms"] = cuda_ms(fn)
        # As kernel F's in this phase: a whole first run of the calls is
        # recorded and discarded (on an H100, strict sessions here have
        # lost the first 3 of 20 kernels in every session).
        dev_ms, profiled = _device_ms_a_call(fn, 20, 1)
        if dev_ms is None or dev_ms < bound["bound_ms"]:
            raise AssertionError(f"kernel G pool={pool}: device time "
                                 f"{dev_ms} ms a call against the bytes "
                                 f"bound {bound['bound_ms']} ms; the "
                                 f"profiler's sessions (events, kernel "
                                 f"events) over 20 calls: {profiled}")
        times[key + "device_ms"] = dev_ms
        times[key + "host_us"] = host_us(fn)
        times[key + "plain_ms"] = cuda_ms(
            lambda p=pool: bg.badge_factors_reference(logits, emb, p))
        if pool:
            times.update(bound)
        else:
            times["unpooled_bound"] = bound
    if bg.launches == before:
        raise AssertionError("kernel G was not launched while timed")
    times["library_ms"] = None
    detail.append({"kernel": "badge", "timings": times})
    log(f"kernel G checks passed (max err {err:.3g}): pooled "
        f"{times['ms']:.4f} ms, device {times['device_ms'] * 1e3:.2f} us, "
        f"host {times['host_us']:.2f} us (plain {times['plain_ms']:.4f}, "
        f"bound {times['bound_ms']:.5f}); unpooled {times['unpooled_ms']:.4f}"
        f" ms, device {times['unpooled_device_ms'] * 1e3:.2f} us, host "
        f"{times['unpooled_host_us']:.2f} us")
    return err, times


# -- phase 8: full-width scoring through the strategies -----------------------

QUERY_SAMPLERS = (("MASESampler", {}), ("BASESampler", {}),
                  ("PartitionedCoresetSampler", {"partitions": 2}),
                  ("PartitionedBADGESampler", {"partitions": 2}))
QUERY_KERNELS = {
    "MASESampler": ("boundary_radii", "head_pair_norms", "bn_act"),
    "BASESampler": ("boundary_radii", "head_pair_norms", "bn_act"),
    "PartitionedCoresetSampler": ("kcenter_batch_pass", "kcenter_min_fold",
                                  "bn_act"),
    "PartitionedBADGESampler": ("badge_factors", "kcenter_fold_draw",
                                "kcenter_min_fold", "bn_act")}


def run_query_path(dev, n_rows: int = 2048, budget: int = 200):
    """Each geometry sampler's ``query`` on full-width SSLResNet50 (1000
    classes, bf16, seeded weights) over a synthetic pool of ``n_rows``
    224x224 rows, the default/imagenet arg pool's scoring batch, the
    launch counters zeroed before each query and read after.  Kernels
    E, F and G record their inputs meanwhile (the first call of each
    shape: a device copy each); returns (results, recorded inputs)."""
    from active_learning_tpu_torch import ops
    from active_learning_tpu_torch.config import ExperimentConfig
    from active_learning_tpu_torch.data.synthetic import get_data_synthetic
    from active_learning_tpu_torch.experiment import driver
    from active_learning_tpu_torch.experiment.arg_pools import \
        get_train_config
    from active_learning_tpu_torch.models.factory import get_network
    from active_learning_tpu_torch.models.weights import load_flax_variables

    t0 = time.perf_counter()
    data = get_data_synthetic(n_train=n_rows, n_test=8, image_size=224,
                              num_classes=1000, seed=SEED)
    model = get_network("imagenet", "SSLResNet50", device=dev)
    load_flax_variables(model, random_variables(SEED))
    train_cfg = get_train_config("default", "imagenet")
    log(f"query path set-up (pool of {n_rows} rows, model): "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    with recording_kernel_inputs() as calls:
        for name, kw in QUERY_SAMPLERS:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_q_") as tmp:
                cfg = ExperimentConfig(dataset="synthetic", strategy=name,
                                       round_budget=budget, device=dev.type,
                                       ckpt_path=tmp, log_dir=tmp, **kw)
                strat = driver.build_experiment(
                    cfg, data=data, train_cfg=train_cfg, model=model)
                avail = strat.available_query_mask()
                labeled = strat.already_labeled_mask()
                torch.cuda.synchronize()
                ops.reset_kernel_launches()
                t0 = time.perf_counter()
                picks, cost = strat.query(budget)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = ops.kernel_launches()
            picks = np.asarray(picks)
            if not (cost == budget == len(picks) == np.unique(picks).size
                    and avail[picks].all() and not labeled[picks].any()):
                raise AssertionError(
                    f"{name} query: {cost} picks, distinct "
                    f"{np.unique(picks).size}, all available "
                    f"{bool(avail[picks].all())}")
            missing = [k for k in QUERY_KERNELS[name] if launches[k] < 1]
            if missing:
                raise AssertionError(f"{name} query never launched "
                                     f"{missing}: {launches}")
            nz = {k: v for k, v in launches.items() if v}
            log(f"{name} query: {budget} picks over {int(avail.sum())} rows "
                f"in {wall:.2f} s; launches {nz}")
            out[name] = {"wall_s": wall, "launches": launches,
                         "scored_rows": int(avail.sum())}
    del model, data
    torch.cuda.empty_cache()
    return out, calls


def check_geometry_f32_against_cpu(view, rows):
    """The mase and pooled-badge steps of full-width SSLResNet50 in
    float32 on the card (TF32 off) and on the CPU, same seeded weights
    and rows: predictions equal, finite radii within 1e-3 of each row's
    largest, BADGE factors within 1e-3 of each factor's largest value
    (the whole network in another order on each side)."""
    from active_learning_tpu_torch.device import set_float32_precision
    from active_learning_tpu_torch.models.factory import get_network
    from active_learning_tpu_torch.models.weights import load_flax_variables
    from active_learning_tpu_torch.strategies import scoring

    set_float32_precision(torch.float32)
    variables = random_variables(SEED)
    outs = []
    for device in ("cuda", "cpu"):
        model = get_network("imagenet", "SSLResNet50", dtype="float32",
                            device=device)
        load_flax_variables(model, variables)
        model.eval()
        batch = {"image": torch.from_numpy(rows).to(device)}
        mase = scoring.make_mase_step(view)(model, batch)
        badge = scoring.make_badge_step(view, pool_512=True)(model, batch)
        outs.append({k: v.cpu() for k, v in {**mase, **badge}.items()})
    card, cpu = outs
    if not torch.equal(card["pred"], cpu["pred"]):
        raise AssertionError("f32 mase predictions differ card vs CPU")
    fin = torch.isfinite(cpu["radii"])
    scale = cpu["radii"].where(fin, torch.zeros(())).abs().max(dim=1).values
    r_err = (card["radii"] - cpu["radii"]).abs().where(fin, torch.zeros(()))
    if not torch.equal(fin, torch.isfinite(card["radii"])) or \
            bool((r_err > 1e-3 * scale[:, None]).any()):
        raise AssertionError(f"f32 radii card vs CPU: {r_err.max()}")
    errs = {}
    for k in ("grad_a", "grad_e"):
        e = (card[k] - cpu[k]).abs().max().item()
        errs[k] = e
        if e > 1e-3 * cpu[k].abs().max().item():
            raise AssertionError(f"f32 {k} card vs CPU: {e}")
    log(f"f32 mase/badge steps card vs CPU: preds equal, radii max err "
        f"{r_err.max().item():.3g}, {errs}")
    return {"radii_max_err": r_err.max().item(), **errs}


# -- phase 9: selection at the sweep's pool size ------------------------------

def _plain_kcenter():
    """Within the context, kcenter_greedy runs kernel E's plain versions
    on the card (the comparison run; no kernel E launch)."""
    import contextlib

    from active_learning_tpu_torch.ops import kcenter as kc

    def fold_select(factors, sqn, min_dist, selectable, centers, q,
                    out_vals=None, out_idx=None, scratch=None):
        vals, idx = kc.fold_select_reference(factors, sqn, min_dist,
                                             selectable, centers, q)
        if out_vals is None:
            return vals, idx
        out_vals.copy_(vals)
        out_idx.copy_(idx)
        return out_vals, out_idx

    def batch_pass(factors, sqn, min_dist, selectable, state):
        kc.batch_pass_reference(factors, sqn, min_dist, selectable, state)
        state.passes += 1

    def fold_draw(factors, sqn, min_dist, selectable, centers, key, out_val,
                  out_idx, scratch=None):
        val, idx = kc.fold_draw_reference(factors, sqn, min_dist, selectable,
                                          centers, key)
        out_val.copy_(val.reshape(1))
        out_idx.copy_(idx.reshape(1))

    @contextlib.contextmanager
    def swapped():
        names = ("fold_select", "batch_pass", "fold_draw", "min_fold")
        saved = [getattr(kc, k) for k in names]
        for k, fn in zip(names, (fold_select, batch_pass, fold_draw,
                                 kc.fold_reference)):
            setattr(kc, k, fn)
        try:
            yield
        finally:
            for k, fn in zip(names, saved):
                setattr(kc, k, fn)

    return swapped()


def _hold_picks(factors, labeled_mask, got, want, where):
    """Kernel picks against plain picks.  At the first difference, the
    step, both rows and the gap between their float64 distances to the
    labeled rows and earlier picks are printed; it fails unless the gap
    is within twice kc.fold_tolerance.  Returns the differing step or
    None."""
    from active_learning_tpu_torch.ops import kcenter as kc

    if np.array_equal(got, want):
        return None
    s = int(np.flatnonzero(got != want)[0])
    centers = np.concatenate([np.flatnonzero(labeled_mask), got[:s]])
    f64 = [f.double() for f in factors]
    c_idx = torch.as_tensor(centers, device=factors[0].device)
    rows = torch.as_tensor([int(got[s]), int(want[s])],
                           device=factors[0].device)
    dots, sq_r, sq_c = None, None, None
    for f in f64:
        dd = f[rows] @ f[c_idx].T
        dots = dd if dots is None else dots * dd
        r2, c2 = (f[rows] ** 2).sum(1), (f[c_idx] ** 2).sum(1)
        sq_r = r2 if sq_r is None else sq_r * r2
        sq_c = c2 if sq_c is None else sq_c * c2
    dist = (sq_r[:, None] + sq_c[None, :] - 2 * dots).min(dim=1).values
    gap = abs(float(dist[0] - dist[1]))
    sqn = sq_r.float()
    bound = 2 * kc.fold_tolerance(sqn, float(sq_c.max()),
                                  sum(f.shape[1] for f in factors)).max()
    log(f"{where}: picks differ first at step {s}: kernel row {int(got[s])}"
        f", plain row {int(want[s])}, distance gap {gap:.4g} (bound "
        f"{float(bound):.4g})")
    if gap > float(bound):
        raise AssertionError(f"{where}: a pick differs beyond the bound")
    return s


def run_selection_path(dev, n=130000, d=2048, n_lab=50000, budget=10000,
                       parts=10):
    """kcenter_greedy at the ImageNet sweep's scale (gen_jobs.py: 50,000
    labeled + 80,000 unlabeled rows, budget 10,000): seeded [130,000,
    2048] float32 factors on the card, (a) unpartitioned with q = 8,
    (b) 10 partitions of 13,000 rows with 1,000 picks each, (c) the same
    partitions randomized over pooled BADGE factors [., 16] + [., 32].
    The launch counters are zeroed before the kernel runs and read after;
    the plain version then re-runs (a) whole and partition 0 of (b) and
    (c) for the pick comparison."""
    from active_learning_tpu_torch import ops
    from active_learning_tpu_torch.strategies import kcenter as skc

    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    x = torch.randn(n, d, device=dev, generator=g)
    a = torch.randn(n, 16, device=dev, generator=g)
    e = torch.randn(n, 32, device=dev, generator=g)
    rng = np.random.default_rng(SEED)
    labeled = np.zeros(n, dtype=bool)
    labeled[rng.choice(n, n_lab, replace=False)] = True
    order = rng.permutation(n)
    lab_rows, unl_rows = order[labeled[order]], order[~labeled[order]]
    part_rows = [np.concatenate([lab_rows[i::parts], unl_rows[i::parts]])
                 for i in range(parts)]
    torch.cuda.synchronize()

    def run(mode, plain=False, only=None):
        picks, scans = [], []
        t0 = time.perf_counter()
        if mode == "unpartitioned":
            p = skc.kcenter_greedy((x,), labeled, budget, batch_q=8,
                                   rng=np.random.default_rng(SEED))
            picks.append(p)
            scans.append(dict(skc.LAST_SCAN))
        else:
            for i, rows in enumerate(part_rows):
                if only is not None and i != only:
                    continue
                idx = torch.as_tensor(rows, device=dev)
                fac = (x[idx],) if mode == "partitioned" else (a[idx],
                                                                e[idx])
                p = skc.kcenter_greedy(
                    fac, labeled[rows], budget // parts, batch_q=8,
                    randomize=mode == "randomized",
                    rng=np.random.default_rng(SEED + i))
                picks.append(p)
                scans.append(dict(skc.LAST_SCAN))
        torch.cuda.synchronize()
        return picks, scans, time.perf_counter() - t0

    out, launches = {}, {}
    for mode in ("unpartitioned", "partitioned", "randomized"):
        ops.reset_kernel_launches()
        picks, scans, wall = run(mode)
        launches[mode] = ops.kernel_launches()
        for p, rows in zip(picks, [None] if mode == "unpartitioned"
                           else part_rows):
            lab = labeled if rows is None else labeled[rows]
            want = budget if rows is None else budget // parts
            if len(p) != want or np.unique(p).size != want or lab[p].any():
                raise AssertionError(f"selection {mode}: invalid picks")
        out[mode] = {"wall_s": wall,
                     "pool_passes": sum(s["pool_passes"] for s in scans),
                     "host_syncs": sum(s["host_syncs"] for s in scans),
                     "picks": int(sum(len(p) for p in picks))}
        log(f"selection {mode}: {out[mode]['picks']} picks in {wall:.2f} s, "
            f"{out[mode]['pool_passes']} pool passes, "
            f"{out[mode]['host_syncs']} host syncs; launches "
            f"{ {k: v for k, v in launches[mode].items() if v} }")
        if mode != "randomized":
            # The batched scan against the q = 1 kernel scan: the same
            # picks and distances bit for bit (outside the counted run).
            b = budget if mode == "unpartitioned" else budget // parts
            bound = skc.max_host_syncs(b, 8)
            if any(sc["host_syncs"] > bound for sc in scans):
                raise AssertionError(f"selection {mode}: host syncs "
                                     f"{[sc['host_syncs'] for sc in scans]}"
                                     f" over the bound {bound}")
            dists_b = skc.LAST_PICK_DISTS if mode == "unpartitioned" \
                else None
            t0 = time.perf_counter()
            if mode == "unpartitioned":
                p1 = skc.kcenter_greedy((x,), labeled, budget, batch_q=1,
                                        rng=np.random.default_rng(SEED))
            else:
                rows = part_rows[0]
                idx = torch.as_tensor(rows, device=dev)
                skc.kcenter_greedy((x[idx],), labeled[rows], b, batch_q=8,
                                   rng=np.random.default_rng(SEED))
                dists_b = skc.LAST_PICK_DISTS
                p1 = skc.kcenter_greedy((x[idx],), labeled[rows], b,
                                        batch_q=1,
                                        rng=np.random.default_rng(SEED))
            q1_wall = time.perf_counter() - t0
            same = (np.array_equal(p1, picks[0]) and np.array_equal(
                skc.LAST_PICK_DISTS.view(np.uint32),
                dists_b.view(np.uint32)))
            if not same:
                s0 = int(np.flatnonzero(p1 != picks[0])[0]) \
                    if not np.array_equal(p1, picks[0]) else None
                raise AssertionError(f"selection {mode}: the batched picks "
                                     f"are not the q = 1 scan's (first "
                                     f"difference at {s0})")
            out[mode]["q1_scan_equal"] = True
            out[mode]["q1_scan_wall_s"] = q1_wall
            log(f"selection {mode}: the q = 1 kernel scan "
                f"({'whole run' if mode == 'unpartitioned' else 'partition 0'}"
                f", {q1_wall:.2f} s) picks the same rows at the same "
                f"distances, bit for bit")
        with _plain_kcenter():
            plain, _, plain_wall = run(mode, only=0)
        out[mode]["plain_wall_s_held"] = plain_wall
        if mode == "unpartitioned":
            out[mode]["first_difference"] = _hold_picks(
                (x,), labeled, picks[0], plain[0], "selection unpartitioned")
        else:
            rows = part_rows[0]
            idx = torch.as_tensor(rows, device=dev)
            fac = (x[idx],) if mode == "partitioned" else (a[idx], e[idx])
            if mode == "randomized" and not np.array_equal(picks[0],
                                                           plain[0]):
                s = int(np.flatnonzero(picks[0] != plain[0])[0])
                raise AssertionError(f"randomized selection, partition 0, "
                                     f"step {s}: kernel row "
                                     f"{picks[0][s]}, plain {plain[0][s]}")
            out[mode]["first_difference"] = _hold_picks(
                fac, labeled[rows], picks[0], plain[0],
                f"selection {mode} partition 0")
        log(f"selection {mode}: plain version on the card held "
            f"({'whole run' if mode == 'unpartitioned' else 'partition 0'}) "
            f"in {plain_wall:.2f} s, first difference "
            f"{out[mode]['first_difference']}")
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    log(f"selection peak device memory: "
        f"{out['peak_device_bytes'] / 2 ** 30:.2f} GiB")
    del x, a, e
    torch.cuda.empty_cache()
    return out, launches


# -- phase 10: the geometry samplers through the CLI on the card --------------

CLI_GEOMETRY = (("BASESampler", []),
                ("PartitionedCoresetSampler", ["--partitions", "2"]),
                ("PartitionedBADGESampler", ["--partitions", "2"]))


def _sig(args):
    """The shapes (and the ints and bools) of a kernel call's arguments."""
    def one(x, top):
        if isinstance(x, torch.Tensor):
            return tuple(x.shape)
        if hasattr(x, "passes"):  # kernel E's BatchState: first pass or not
            return ("state", x.q, min(x.passes, 1))
        if isinstance(x, (tuple, list)):
            return tuple(one(v, False) for v in x)
        return x if top and isinstance(x, (bool, int)) else None
    return tuple(one(a, True) for a in args)


def _copy(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_copy(v) for v in x)
    if hasattr(x, "clone"):  # a tensor, or kernel E's BatchState
        return x.clone()
    return x


def recording_kernel_inputs(targets=None, keep=None):
    """Within the context, the kernel entry points ``targets`` ((module,
    name) pairs; by default kernels E, F and G's as the strategies call
    them) keep a copy of their inputs, taken before the call (E updates
    min_dist and selectable in place; kernel H's ``BalancingState.pick``,
    name "pick", records (emb, eligible, centers, maj, rarest,
    rare_empty) just after it), for the first call of each distinct
    argument shape that ``keep(name, args)`` accepts (all by default);
    launches are counted as always.  Yields {entry point: [args, ...]}."""
    import contextlib

    from active_learning_tpu_torch.ops import kcenter as kc
    from active_learning_tpu_torch.strategies import scoring

    if targets is None:
        targets = [(kc, n) for n in ("fold_select", "batch_pass",
                                     "fold_draw", "min_fold")] + \
            [(scoring, n) for n in ("badge_factors", "boundary_radii",
                                    "head_pair_norms")]
    calls = {n: [] for _, n in targets}
    seen = set()

    def wrap(name, fn):
        if name == "pick":
            return recorded_pick(fn)

        def recorded(*args, **kwargs):
            key = (name, _sig(args))
            if key not in seen and (keep is None or keep(name, args)):
                seen.add(key)
                calls[name].append(_copy(args))
            return fn(*args, **kwargs)
        return recorded

    def recorded_pick(fn):
        """Kernel H's ``BalancingState.pick``: its inputs as the kernel
        saw them, the state's tensors just after the pick (the update
        kernel applied the queued takes; the fold changes nothing)."""
        def recorded(state, maj, rarest, rare_empty):
            row = fn(state, maj, rarest, rare_empty)
            key = ("pick", (tuple(state.emb.shape), tuple(
                state.centers.shape), int(rarest), bool(rare_empty)))
            if key not in seen:
                args = (state.emb, state.eligible, state.centers,
                        torch.from_numpy(np.asarray(maj, dtype=bool)).to(
                            state.emb.device), int(rarest),
                        bool(rare_empty))
                if keep is None or keep("pick", args):
                    seen.add(key)
                    calls["pick"].append(_copy(args))
            return row
        return recorded

    @contextlib.contextmanager
    def swapped():
        saved = [(m, n, getattr(m, n)) for m, n in targets]
        for m, n, fn in saved:
            setattr(m, n, wrap(n, fn))
        try:
            yield calls
        finally:
            for m, n, fn in saved:
                setattr(m, n, fn)

    return swapped()


def check_recorded_inputs(calls, detail, path):
    """Kernels E, F and G against their plain versions on the inputs a
    path gave them (recording_kernel_inputs): E's fold + top-q with the
    recorded centers and q, its batched pass from the recorded state
    (``_check_batch_pass``), its min fold over the recorded centers and
    its D² draw over up to 20 steps from the recorded state; F on the
    recorded embeddings and head; G pooled and unpooled on the recorded
    logits and embeddings.  Fails if a kernel of the three got no call.
    Returns the max abs err of each."""
    err = {"E": 0.0, "F": 0.0, "G": 0.0}
    for args in calls["fold_select"]:
        factors, sqn, md, sel, centers, q = args[:6]
        where = (f"N={sqn.shape[0]} D="
                 f"{'+'.join(str(f.shape[1]) for f in factors)} "
                 f"centers={centers.numel()}")
        err["E"] = max(err["E"], _check_fold_select(
            factors, sqn, md, sel, centers, q, where, detail, path))
    for factors, sqn, md, sel, state in calls["batch_pass"]:
        where = (f"N={sqn.shape[0]} D="
                 f"{'+'.join(str(f.shape[1]) for f in factors)} "
                 f"pass {state.passes + 1}")
        err["E"] = max(err["E"], _check_batch_pass(
            factors, sqn, md, sel, state, where, detail, path))
    for factors, sqn, _, centers in calls["min_fold"]:
        where = (f"N={sqn.shape[0]} D="
                 f"{'+'.join(str(f.shape[1]) for f in factors)} "
                 f"centers={centers.numel()}")
        err["E"] = max(err["E"], _check_min_fold(factors, sqn, centers,
                                                 where, detail, path))
    for factors, sqn, md, sel, *_ in calls["fold_draw"][:1]:
        where = (f"N={sqn.shape[0]} D="
                 f"{'+'.join(str(f.shape[1]) for f in factors)}")
        steps = min(20, int((sel > 0).sum()))
        if steps < 1:
            raise AssertionError(f"path {path}: a D² draw over a pool with "
                                 "nothing selectable")
        err["E"] = max(err["E"], _check_fold_draw(
            factors, sqn, md, sel, steps, sqn.shape[0], where, detail, path))
    for emb, kernel, bias, _ in calls["boundary_radii"]:
        where = f"B={emb.shape[0]} C={kernel.shape[1]} D={emb.shape[1]}"
        err["F"] = max(err["F"], _check_radii(emb, kernel, bias, where,
                                              detail, path)[0])
    for logits, emb, _ in calls["badge_factors"]:
        where = f"B={logits.shape[0]} C={logits.shape[1]} D={emb.shape[1]}"
        err["G"] = max(err["G"], _check_badge(logits, emb, where, detail,
                                              path))
    shapes = {n: [_sig(a) for a in v] for n, v in calls.items() if v}
    for kernel, names in (("E", ("fold_select", "batch_pass", "min_fold")),
                          ("F", ("boundary_radii",)),
                          ("G", ("badge_factors",))):
        if not any(calls[n] for n in names):
            raise AssertionError(f"path {path}: no call of kernel {kernel} "
                                 f"was recorded ({shapes})")
    n_shapes = sum(len(v) for v in calls.values())
    log(f"kernels E, F, G held at the {path} path's {n_shapes} recorded "
        f"input shapes: max errs {err}")
    return err


def record_cli_geometry_inputs(dev):
    """The inputs kernels E, F and G take on the cli_geometry path: each
    CLI_GEOMETRY strategy built in this process from the same flags
    (SSLResNet18 with the synthetic set's 10 classes at 32 px, its arg
    pool's scoring batch, the CLI's pool and partitions), its round-1
    query run once with the entry points recording."""
    from active_learning_tpu_torch.experiment import cli, driver

    calls = None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rec_") as tmp:
        with recording_kernel_inputs() as calls:
            for name, extra in CLI_GEOMETRY:
                cfg = cli.parse([*_CLI_FLAGS, "--log_dir", tmp,
                                 "--ckpt_path", tmp, "--strategy", name,
                                 *extra])
                strat = driver.build_experiment(cfg)
                strat.round = 1
                strat.query(cfg.round_budget)
                del strat
    torch.cuda.synchronize()
    return calls


def run_cli_geometry(tmp: str):
    out, total = {}, {}
    for name, extra in CLI_GEOMETRY:
        run = _run_cli(os.path.join(tmp, name), ["--strategy", name, *extra])
        if run["tested"] != {0, 1}:
            raise AssertionError(f"CLI {name}: rounds tested {run['tested']}")
        missing = [k for k in QUERY_KERNELS[name] if run["launches"][k] < 1]
        if missing:
            raise AssertionError(f"CLI {name} never launched {missing}")
        log(f"CLI {name} on the card: {run['wall_s']:.1f} s, launches "
            f"{ {k: v for k, v in run['launches'].items() if v} }")
        out[name] = {"wall_s": run["wall_s"], "launches": run["launches"],
                     "phase_times": run["phase_times"]}
        for k, v in run["launches"].items():
            total[k] = total.get(k, 0) + v
    return out, total


# -- phase 11: kernel H against its plain version -----------------------------

BAL_SHAPES = ((20431, 512, 10), (50000, 512, 10), (130000, 2048, 1000))


def _bal_inputs(dev, n, d, c, seed):
    """Seeded pool rows and centroids on the card, 70% of the rows
    eligible, and the majority mask of an exp-0.1 skewed count vector
    (the imbalanced sweep's profile, ``data/imbalance.py``): classes
    above the mean count are the majority, the last class the rarest."""
    g = torch.Generator(device=dev).manual_seed(seed)
    emb = torch.randn(n, d, device=dev, generator=g)
    centers = torch.randn(c, d, device=dev, generator=g) * 0.5
    eligible = torch.rand(n, device=dev, generator=g) > 0.3
    counts = np.round(5000 * 0.1 ** (np.arange(c) / max(c - 1, 1)))
    maj = torch.from_numpy(counts > counts.mean()).to(dev)
    return emb, eligible, centers, maj, int(np.argmin(counts))


def _hold_pick(args, rare_empty, where, detail, path):
    """Kernel H's pick against its plain version's on the same inputs:
    equal, or the two rows' plain scores within ``score_tolerance`` of
    each other (printed).  Returns the score gap (0 when equal)."""
    from active_learning_tpu_torch.ops import balancing as ob

    got = int(ob.balancing_pick(*args, rare_empty))
    want = int(ob.balancing_pick_reference(*args, rare_empty))
    gap = tol = 0.0
    if got != want:
        emb, eligible, centers, maj, rarest = args
        scores = ob.balancing_scores_reference(*args, rare_empty)
        bound = ob.score_tolerance(emb, centers, maj, rarest, rare_empty)
        gap = float((scores[got] - scores[want]).abs())
        tol = float(bound[got] + bound[want])
        log(f"kernel H at {where}: pick {got} != plain {want}, scores "
            f"{float(scores[got])!r} vs {float(scores[want])!r}, gap "
            f"{gap:.3g} within the f32 bound {tol:.3g}: {gap <= tol}")
        if not (bool(eligible[got]) and gap <= tol):
            raise AssertionError(f"kernel H at {where}: pick {got}, plain "
                                 f"{want}, gap {gap} > bound {tol}")
    detail.append({"kernel": "balancing", "path": path, "where": where,
                   "pick": got, "plain_pick": want, "score_gap": gap,
                   "bound": tol})
    return gap


def _time_state_picks(args, reps):
    """A ``BalancingState`` on these inputs, as the sampler's loop runs
    it (a pick, then a take of its row): the CUDA-event time of a pick
    (the block's copy, the two kernels and the wait for the row), its
    host time (``perf_counter``), its device time (the profiler's events:
    copy, update and fold), and the kernels a pick launched by the C
    entry's count, held against the profiler's kernel events: never more
    than the count (the profiler can lose events, not make them), equal
    in a session that holds every call's events, and at most 2."""
    from active_learning_tpu_torch.ops import balancing as ob

    emb, eligible, centers, maj, rarest = args
    majn = maj.cpu().numpy()
    rows = centers.cpu().numpy()
    state = ob.BalancingState(emb, eligible.clone(), centers.clone())
    step = {"i": 0}

    def pick_and_take():
        i = step["i"] = step["i"] + 1
        row = state.pick(majn, rarest, False)
        state.take(row, i % rows.shape[0], rows[i % rows.shape[0]])

    ms = cuda_ms(pick_and_take, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        pick_and_take()
    host = (time.perf_counter() - t0) / reps * 1e6
    picks0, kernels0 = ob.launches, ob.kernel_launches
    device, profiled = _device_ms_a_call(pick_and_take, reps, 3)
    counted = (ob.kernel_launches - kernels0) / (ob.launches - picks0)
    state.close()
    whole = [k for n, k in profiled if n == reps * 3]
    if (counted > 2 or any(k > counted * reps for _, k in profiled)
            or any(k != counted * reps for k in whole)):
        raise AssertionError(f"kernel H: {counted} kernels a pick by the C "
                             f"entry's count; the profiler's sessions "
                             f"(events, kernel events) over {reps} picks: "
                             f"{profiled}")
    return {"ms": ms, "host_us": host, "device_ms": device,
            "kernels_per_pick": counted,
            "profiled_kernels_per_pick": whole[0] / reps if whole else None}


def _device_ms_a_call(fn, reps, per_call):
    """Device time of one call of ``fn`` (kernels and copies) from a
    profile of ``reps`` calls, counted only from a session that holds
    ``per_call`` events a call; up to eight sessions.  Also each
    session's (events, kernel events).  The profiler's schedule records
    a first run of ``reps`` calls and discards it: in an unscheduled
    profile of kernel H's picks at the CIFAR widths every session of a
    run has lacked the same 11 events (4 copies and 7 kernels, the
    first three and a half picks' worth).  The time is None (not
    measured, logged, and listed in the kernels line's
    ``failed_measurements``) when every session lost events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    seen = []
    for _ in range(8):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        n = sum(e.count for e in events)
        seen.append((n, sum(e.count for e in events
                            if not e.key.startswith(("Memcpy", "Memset")))))
        if n == reps * per_call:
            ms = sum(e.self_device_time_total for e in events) / 1e3 / reps
            return ms, seen
    log(f"device time not measured: the profiler lost events in every "
        f"session ((events, kernel events) {seen}, {reps * per_call} events "
        f"expected)")
    return None, seen


def check_balancing(dev, detail):
    """Kernel H at the three phase-11 shapes and the edge cases, timed
    beside its plain version, its bound and the library form (addmm +
    amax + argmin, TF32 off).  Returns (max score gap, times at the
    imbalanced CIFAR shape, times by shape)."""
    from active_learning_tpu_torch.device import full_float32
    from active_learning_tpu_torch.ops import balancing as ob

    worst, by_shape = 0.0, {}
    for i, (n, d, c) in enumerate(BAL_SHAPES):
        args = _bal_inputs(dev, n, d, c, SEED + i)
        where = f"N={n} D={d} C={c}"
        for rare_empty in (False, True):
            worst = max(worst, _hold_pick(args, rare_empty,
                                          f"{where} rare_empty={rare_empty}",
                                          detail, "phase11"))
        emb, eligible, centers, maj, rarest = args

        def library():
            with full_float32():
                cm = centers[maj]
                d_rare = ((emb - centers[rarest]) ** 2).sum(dim=1)
                d_maj = torch.addmm((cm * cm).sum(dim=1), emb, cm.T,
                                    alpha=-2.0)
                norm = torch.amax(d_maj, dim=1) + (emb * emb).sum(dim=1)
                return torch.argmin(torch.where(
                    eligible, d_rare / norm, torch.full_like(norm,
                                                             float("inf"))))

        reps = 10 if n * c > 10 ** 7 else N_TIMED
        n_maj = int(maj.sum())
        times = {**_time_state_picks(args, reps),
                 "plain_ms": cuda_ms(
                     lambda: ob.balancing_pick_reference(*args, False), reps),
                 "library_ms": cuda_ms(library, reps),
                 **_bound(n * d * 4 + n + c * d * 4 + c + 8,
                          2.0 * n * d * (n_maj + 1)),
                 "majority_classes": n_maj}
        by_shape[where] = times
        log(f"kernel H at {where} ({n_maj} majority classes): a "
            f"BalancingState pick (+ take) {times['ms']:.4f} ms by CUDA "
            f"events, the wait for the row included (device "
            f"{times['device_ms']} ms by the profiler: copy, update and "
            f"fold; host {times['host_us']:.1f} us; "
            f"{times['kernels_per_pick']} kernels a pick, "
            f"{times['profiled_kernels_per_pick']} by the profiler); plain "
            f"{times['plain_ms']:.4f}, library {times['library_ms']:.4f}, "
            f"bound {times['bound_ms']:.4f} by {times['bound_by']}")
        if i == 0:
            # Edge cases at the imbalanced CIFAR width.
            emb, eligible, centers, maj, rarest = (
                a.clone() if isinstance(a, torch.Tensor) else a for a in args)
            args = (emb, eligible, centers, maj, rarest)
            best = int(ob.balancing_pick(*args, False))
            lo = max(best - 5, 0)
            emb[lo:best] = emb[best]  # duplicates: the lowest index wins
            eligible[lo:best + 1] = True
            if int(ob.balancing_pick(*args, False)) != lo:
                raise AssertionError("kernel H: a tie did not go to the "
                                     "lower index")
            worst = max(worst, _hold_pick(args, False, f"{where} ties",
                                          detail, "phase11"))
            eligible[lo:best + 1] = False  # ineligible rows never win
            if int(ob.balancing_pick(*args, False)) in range(lo, best + 1):
                raise AssertionError("kernel H picked an ineligible row")
            worst = max(worst, _hold_pick(args, False,
                                          f"{where} ineligible", detail,
                                          "phase11"))
            eligible[:] = True
            emb[7] = centers[int(maj.nonzero()[0, 0])]
            for rare_empty in (False, True):
                worst = max(worst, _hold_pick(
                    args, rare_empty,
                    f"{where} row on a majority centroid, rare_empty="
                    f"{rare_empty}", detail, "phase11"))
        del args, emb, eligible, centers
        torch.cuda.empty_cache()
    log(f"kernel H checks passed: max score gap {worst:.3g}")
    main = dict(by_shape[f"N={BAL_SHAPES[0][0]} D={BAL_SHAPES[0][1]} "
                         f"C={BAL_SHAPES[0][2]}"])
    return worst, main, by_shape


# -- phase 12: BalancingSampler at the imbalanced CIFAR sweep's width ---------

def _h_targets():
    from active_learning_tpu_torch.ops import balancing as ob
    return [(ob.BalancingState, "pick")]


def _bc_targets():
    from active_learning_tpu_torch.ops import bn_act as ba
    from active_learning_tpu_torch.ops import bn_train as bt
    return [(bt, "bn_forward_stats"), (bt, "bn_backward"), (bt, "bn_dx"),
            (ba, "bn_act")]


def check_recorded_h(calls, detail, path):
    """Kernel H against its plain version on the inputs a path gave it."""
    if not calls["pick"]:
        raise AssertionError(f"path {path}: no call of kernel H recorded")
    worst = 0.0
    for emb, eligible, centers, maj, rarest, rare_empty in calls["pick"]:
        where = (f"{path} N={emb.shape[0]} D={emb.shape[1]} "
                 f"C={centers.shape[0]}")
        worst = max(worst, _hold_pick((emb, eligible, centers, maj, rarest),
                                      rare_empty, where, detail, path))
    log(f"kernel H held at the {path} path's "
        f"{len(calls['pick'])} recorded inputs: max score gap "
        f"{worst:.3g}")
    return worst


def check_recorded_bn(calls, detail, path):
    """Kernels B and C against their plain versions on the inputs a path
    gave them: the statistics and backward sums within 1e-5 of the sum
    of the terms' magnitudes (as ``check_bn_train``), the chains from the
    same sums within BN_CHAIN_ULPS, dx and the masked gy bit-equal from
    the same coefficients, kernel B within 1e-6 of its terms (plus one
    bf16 ulp in bf16, as ``check_bn_act``).  Returns (B err, C err)."""
    from active_learning_tpu_torch.ops import bn_act as ba
    from active_learning_tpu_torch.ops import bn_train as bt

    for name in ("bn_forward_stats", "bn_backward", "bn_dx", "bn_act"):
        if not calls[name]:
            raise AssertionError(f"path {path}: no call of {name} recorded")
    dims = (0, 2, 3)
    err_b = err_c = 0.0
    for x, scale, bias, eps, fused, running, *_ in calls["bn_forward_stats"]:
        n = x.shape[0] * x.shape[2] * x.shape[3]
        inv = float(np.float32(1.0) / np.float32(n))
        ra = tuple(r.clone() for r in running) if running else None
        mean, mean2, var, coeffs = bt.bn_forward_stats(
            x, scale, bias, eps, fused, running)
        xf = x.float()
        for got, ref, mag in zip((mean, mean2),
                                 bt.channel_sums_reference(x, x, inv),
                                 (xf.abs().sum(dims) * inv,
                                  (xf * xf).sum(dims) * inv)):
            diff = (got - ref).abs()
            if bool((diff > 1e-5 * mag + 1e-30).any()):
                raise AssertionError(f"{path} bn_forward_stats "
                                     f"{tuple(x.shape)}: "
                                     f"{diff.max().item()}")
            err_c = max(err_c, diff.max().item())
        p_var, p_coeffs = bt.forward_chain_reference(
            mean, mean2, scale, bias, eps, x.dtype, fused, ra)
        _hold_bn_chain((var, *coeffs) + (tuple(running) if ra else ()),
                       (p_var, *p_coeffs) + (ra or ()),
                       f"{path} forward {tuple(x.shape)}")
    for gy, x, y, scale, mean, mean2, eps, fused in calls["bn_backward"]:
        n = x.shape[0] * x.shape[2] * x.shape[3]
        sums = bt.bn_backward_local(gy, x, y, scale, mean, mean2, eps,
                                    fused)[0]
        full = bt.bn_backward(gy, x, y, scale, mean, mean2, eps, fused)
        gm = bt.relu_mask_reference(gy, y)
        gf, xf = gm.float(), x.float()
        for got, ref, mag in zip(sums, bt.channel_sums_reference(gm, x),
                                 (gf.abs().sum(dims),
                                  (gf * xf).abs().sum(dims))):
            diff = (got - ref).abs()
            if bool((diff > 1e-5 * mag + 1e-30).any()):
                raise AssertionError(f"{path} bn_backward "
                                     f"{tuple(x.shape)}: {diff.max()}")
            err_c = max(err_c, diff.max().item())
        _hold_bn_chain(full, bt.backward_coefficients(
            sums[0], sums[1], scale, mean, mean2, eps, float(n), x.dtype,
            fused), f"{path} backward {tuple(x.shape)}")
    for gy, x, y, mul, c2, c1, *masked in calls["bn_dx"]:
        got = bt.bn_dx(gy, x, y, mul, c2, c1, True)
        if not (torch.equal(got[0], bt.bn_dx_reference(gy, x, y, mul, c2,
                                                        c1))
                and torch.equal(got[1], bt.relu_mask_reference(gy, y))):
            raise AssertionError(f"{path} bn_dx {tuple(x.shape)}: "
                                 "not bit-equal")
    for x, coeffs, res, relu in calls["bn_act"]:
        got = ba.bn_act(x, coeffs, res, relu).float()
        ref = ba.bn_act_reference(x, coeffs, res, relu).float()
        shift, mul, add = (v.view(1, -1, 1, 1) for v in coeffs)
        tol = 1e-6 * ((x.float() - shift).abs() * mul.abs() + add.abs()
                      + (0 if res is None else res.float().abs()))
        if x.dtype == torch.bfloat16:
            tol = tol + _bf16_ulp(torch.maximum(got.abs(), ref.abs()))
        diff = (got - ref).abs()
        if bool((diff > tol).any()):
            raise AssertionError(f"{path} bn_act {tuple(x.shape)} "
                                 f"{x.dtype}: {diff.max().item()}")
        err_b = max(err_b, diff.max().item())
    shapes = sorted({(tuple(a[0].shape), str(a[0].dtype))
                     for v in calls.values() for a in v
                     if isinstance(a[0], torch.Tensor) and a[0].ndim == 4})
    detail.append({"kernel": "bn_act+bn_train", "path": path,
                   "shapes": [list(s) for s in shapes],
                   "bn_act_err": err_b, "bn_train_err": err_c})
    log(f"kernels B and C held at the {path} path's recorded inputs "
        f"({len(shapes)} shapes: {shapes}): bn_act max err {err_b:.3g}, "
        f"bn_train sums max err {err_c:.3g}, chains within "
        f"{BN_CHAIN_ULPS} ulp, dx bit-equal")
    return err_b, err_c


def run_balancing_path(dev, n_pool=20431, n_lab=1000, budget=1000):
    """BalancingSampler.query at the imbalanced CIFAR sweep's width:
    full-width SSLResNet18 (CIFAR stem, 10 classes, bf16, seeded), a
    synthetic 32-px pool of ``n_pool`` rows, ``n_lab`` labeled rows with
    the exp-0.1 class proportions, budget ``budget``.  Run once through
    kernel H's ``BalancingState`` (counters zeroed before, read after;
    H's inputs recorded), then twice more from the same state: with the
    plain version on the state (``pick_reference``), and in lockstep
    (kernel H's pick taken, the plain version's on the same state's
    tensors beside it, at every balancing pick).  Every lockstep
    disagreement must be a float32 near-tie within ``score_tolerance``;
    the plain run's picks are reported equal, or where they part.  The
    pick loop's time (the query's wall less its scoring pass), the
    launches a pick (at most 2) and the lengths of the runs of
    consecutive balancing picks are reported."""
    from active_learning_tpu_torch import ops
    from active_learning_tpu_torch.config import ExperimentConfig
    from active_learning_tpu_torch.data.synthetic import get_data_synthetic
    from active_learning_tpu_torch.experiment import driver
    from active_learning_tpu_torch.experiment.arg_pools import \
        get_train_config
    from active_learning_tpu_torch.models.factory import get_network
    from active_learning_tpu_torch.models.resnet import init_weights
    from active_learning_tpu_torch.ops import balancing as ob
    from active_learning_tpu_torch.strategies import balancing as sb

    t0 = time.perf_counter()
    data = get_data_synthetic(n_train=n_pool, n_test=8, image_size=32,
                              num_classes=10, seed=SEED)
    model = get_network("cifar10", "SSLResNet18", device=dev)
    init_weights(model, torch.Generator().manual_seed(SEED))
    train_cfg = get_train_config("default", "cifar10")
    targets = data[0].targets
    props = 0.1 ** (np.arange(10) / 9)
    counts = np.floor(props / props.sum() * n_lab).astype(int)
    counts[0] += n_lab - counts.sum()
    log(f"balancing path set-up: {time.perf_counter() - t0:.1f} s; labeled "
        f"counts {counts.tolist()}")

    def strategy(tmp):
        cfg = ExperimentConfig(dataset="synthetic",
                               strategy="BalancingSampler",
                               round_budget=budget, init_pool_size=0,
                               device=dev.type, ckpt_path=tmp, log_dir=tmp)
        strat = driver.build_experiment(cfg, data=data, train_cfg=train_cfg,
                                        model=model)
        rng = np.random.default_rng(SEED + 1)
        avail = strat.available_query_mask()
        lab = np.concatenate([
            rng.choice(np.flatnonzero((targets == c) & avail), k,
                       replace=False) for c, k in enumerate(counts)])
        strat.update(lab, len(lab))
        return strat

    embs, steps, mismatches, runs_of = {}, [], [], []

    class PlainState(ob.BalancingState):
        """The plain version on the same state, at every pick."""

        def pick(self, maj, rarest, rare_empty):
            return self.pick_reference(maj, rarest, rare_empty)

    class LockstepState(ob.BalancingState):
        """Kernel H's pick, with the plain version's on the state's
        tensors as the kernel saw them beside it; a disagreement is
        recorded with both plain scores.  Also counts the runs of
        consecutive balancing picks (a take with no pick before it is a
        random pick)."""
        run = 0
        after_pick = False

        def pick(self, maj, rarest, rare_empty):
            got = super().pick(maj, rarest, rare_empty)
            self.run += 1
            self.after_pick = True
            args = (self.emb, self.eligible, self.centers,
                    torch.from_numpy(np.asarray(maj, dtype=bool)).to(dev),
                    int(rarest), bool(rare_empty))
            want = int(ob.balancing_pick_reference(*args))
            steps.append(got == want)
            if got != want:
                emb, eligible, centers, majt, _, _ = args
                scores = ob.balancing_scores_reference(*args)
                bound = ob.score_tolerance(emb, centers, majt, int(rarest),
                                           bool(rare_empty))
                # The two rows' scores in float64: which one is the exact
                # argmin.
                rows = torch.tensor([got, want], device=emb.device)
                exact = ob.balancing_scores_reference(
                    emb[rows].double(), eligible[rows], centers.double(),
                    majt, int(rarest), bool(rare_empty))
                mismatches.append({
                    "balancing_pick": len(steps), "pick": got,
                    "plain_pick": want, "score": float(scores[got]),
                    "plain_score": float(scores[want]),
                    "gap": float((scores[got] - scores[want]).abs()),
                    "bound": float(bound[got] + bound[want]),
                    "float64_scores": [float(v) for v in exact]})
            return got

        def take(self, row, cls, center_row):
            if not self.after_pick and self.run:
                runs_of.append(self.run)
                self.run = 0
            self.after_pick = False
            super().take(row, cls, center_row)

        def close(self):
            if self.run:
                runs_of.append(self.run)
                self.run = 0
            super().close()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_bal_") as tmp:
        strat = strategy(tmp)
        real = strat._all_embeddings

        def scored():
            t = time.perf_counter()
            embs["e"] = real()
            torch.cuda.synchronize()
            embs["scoring_s"] = time.perf_counter() - t
            return embs["e"]

        strat._all_embeddings = scored
        avail = strat.available_query_mask()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_kernel_launches()
        real_pick, pick_s = ob.BalancingState.pick, [0.0]

        def timed_pick(state, *args):
            t = time.perf_counter()
            row = real_pick(state, *args)
            pick_s[0] += time.perf_counter() - t
            return row

        ob.BalancingState.pick = timed_pick
        try:
            with recording_kernel_inputs(_h_targets()) as calls:
                t0 = time.perf_counter()
                picks, cost = strat.query(budget)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            ob.BalancingState.pick = real_pick
        launches = ops.kernel_launches()
        device_launches = ob.kernel_launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_bal = strat.last_balancing_picks
        batches = -(-n_pool // strat._score_batch_size())
        runs = {}
        for name, cls in (("plain", PlainState), ("lockstep", LockstepState)):
            again = strategy(tmp)
            again._all_embeddings = lambda: embs["e"]
            sb.BalancingState = cls
            try:
                t0 = time.perf_counter()
                runs[name] = np.asarray(again.query(budget)[0])
                torch.cuda.synchronize()
                runs[name + "_wall"] = time.perf_counter() - t0
            finally:
                sb.BalancingState = ob.BalancingState
            del again
    picks = np.asarray(picks)
    if not (cost == budget == np.unique(picks).size and avail[picks].all()):
        raise AssertionError(f"balancing query: {cost} picks, "
                             f"{np.unique(picks).size} distinct")
    on_card = dev.type == "cuda"  # a CPU rehearsal launches nothing
    if (launches["balancing_pick"] != (n_bal if on_card else 0) or n_bal < 1
            or device_launches > 2 * launches["balancing_pick"]):
        raise AssertionError(f"balancing query: {n_bal} balancing picks, "
                             f"kernel H picks {launches['balancing_pick']} "
                             f"with {device_launches} launches (at most 2 "
                             f"a pick)")
    for m in mismatches:
        log(f"balancing query: at balancing pick {m['balancing_pick']} "
            f"kernel H picks row {m['pick']} (plain score {m['score']!r}), "
            f"the plain version row {m['plain_pick']} (score "
            f"{m['plain_score']!r}): gap {m['gap']:.3g} within the f32 "
            f"bound {m['bound']:.3g}: {m['gap'] <= m['bound']}; in float64 "
            f"{m['float64_scores']}")
        if m["gap"] > m["bound"]:
            raise AssertionError(f"balancing query: kernel H disagrees with "
                                 f"the plain version beyond the bound: {m}")
    # The lockstep run takes kernel H's picks: it must retrace the main
    # run, and every disagreement with the plain version on the same
    # state must be a float32 near-tie.
    if not np.array_equal(runs["lockstep"], picks) or len(steps) != n_bal:
        raise AssertionError("balancing query: the lockstep run did not "
                             "retrace the main run")
    plain_equal = bool(np.array_equal(runs["plain"], picks))
    first = None if plain_equal else int(
        np.flatnonzero(runs["plain"] != picks)[0])
    log(f"balancing query: kernel H against the plain version on the same "
        f"state at all {n_bal} balancing picks: {len(mismatches)} "
        f"disagreements (each a near-tie within the bound); the plain "
        f"version's own run ({runs['plain_wall']:.2f} s) "
        + (f"picks the same {budget} rows" if plain_equal else
           f"follows the same picks up to pick {first}, then its own "
           "trajectory"))
    picked = np.bincount(targets[picks], minlength=10)
    loop_s = wall - embs["scoring_s"]
    out = {"wall_s": wall, "pick_loop_s": loop_s, "in_pick_s": pick_s[0],
           "plain_wall_s": runs["plain_wall"],
           "plain_picks_equal": plain_equal, "plain_first_difference": first,
           "lockstep_disagreements": mismatches, "budget": budget,
           "balancing_picks": n_bal, "random_picks": budget - n_bal,
           "host_syncs": n_bal + batches, "scoring_batches": batches,
           "scoring_s": embs["scoring_s"], "device_launches": device_launches,
           "balancing_runs": runs_of,
           "peak_gib": peak, "launches": launches,
           "picked_per_class": picked.tolist()}
    log(f"balancing query: {budget} picks over {int(avail.sum())} rows in "
        f"{wall:.2f} s (scoring pass {embs['scoring_s']:.2f} s, pick loop "
        f"{loop_s:.3f} s, {pick_s[0]:.3f} s of it inside the "
        f"{n_bal} BalancingState.pick calls, the wait for the row "
        f"included; {n_bal} balancing, {budget - n_bal} random; "
        f"kernel H picks {launches['balancing_pick']} with "
        f"{device_launches} launches; host syncs {n_bal} picks + "
        f"{batches} scoring batches; peak {peak:.2f} GiB); picked per class "
        f"{picked.tolist()}; runs of consecutive balancing picks "
        f"({len(runs_of)}): {runs_of}")
    del model, data, strat
    torch.cuda.empty_cache()
    return out, calls


# -- phase 13: VAAL at the ImageNet sweep's width ------------------------------

def run_vaal_path(dev, n_pool=2600, n_lab=512, budget=200,
                  model_name="SSLResNet50", image_size=224):
    """VAALSampler on full-width SSLResNet50 (1000 classes, 224 px, bf16,
    from scratch, default/imagenet, B=128) with the VAE at crop 64, z =
    64: ``Trainer.fit`` with the co-step hook over ``n_lab`` labeled rows
    (2 epochs), each co-step and classifier step timed (synchronized),
    kernels B and C recording their float32 (VAE) inputs; then a query
    of ``budget`` over the rest of an ``n_pool``-row pool, both under
    the CLI's float32 settings.  Counters are zeroed before each and
    read after."""
    from active_learning_tpu_torch import ops
    from active_learning_tpu_torch.config import ExperimentConfig
    from active_learning_tpu_torch.data.synthetic import get_data_synthetic
    from active_learning_tpu_torch.experiment import driver
    from active_learning_tpu_torch.experiment.arg_pools import \
        get_train_config
    from active_learning_tpu_torch.models.factory import get_network

    t0 = time.perf_counter()
    data = get_data_synthetic(n_train=n_pool, n_test=8,
                              image_size=image_size, num_classes=1000,
                              seed=SEED)
    model = get_network("imagenet", model_name, device=dev)
    train_cfg = get_train_config("default", "imagenet")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vaal_")
    cfg = ExperimentConfig(dataset="synthetic", strategy="VAALSampler",
                           round_budget=budget, init_pool_size=n_lab,
                           n_epoch=2, early_stop_patience=0,
                           device=dev.type, ckpt_path=tmp, log_dir=tmp)
    strat = driver.build_experiment(cfg, data=data, train_cfg=train_cfg,
                                    model=model)
    strat.init_network_weights()
    log(f"VAAL path set-up (pool of {n_pool} rows, models): "
        f"{time.perf_counter() - t0:.1f} s; crop {strat.crop}, z "
        f"{strat.z_dim}, scoring window {strat.score_window}")
    co_ms, cls_ms = [], []

    def timed(fn, into):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t) * 1e3)
            return out
        return run

    strat.co_step = timed(strat.co_step, co_ms)
    strat.trainer.train_step = timed(strat.trainer.train_step, cls_ms)
    # The CLI runs a bf16 classifier under PyTorch's default float32
    # settings (cuDNN convolutions in TF32, matmuls not), so the VAE's
    # float32 convolutions do too; phase 3's float32 check turned TF32
    # off for this process, so the phase restores the defaults.
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    with recording_kernel_inputs(
            _bc_targets(),
            keep=lambda name, args: args[0].dtype == torch.float32) as calls:
        t0 = time.perf_counter()
        strat.train()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    fit_launches = ops.kernel_launches()
    del strat.co_step, strat.trainer.train_step
    need = ("bn_train_stats", "bn_train_bwd_reduce", "bn_train_dx", "bn_act",
            "fused_sgd")
    on_card = dev.type == "cuda"  # a CPU rehearsal launches nothing
    if any(fit_launches[k] < on_card for k in need) or len(co_ms) < 1:
        raise AssertionError(f"VAAL fit: launches {fit_launches}, "
                             f"{len(co_ms)} co-steps")
    vae_loss, d_loss = strat.last_losses
    if not (np.isfinite(vae_loss) and np.isfinite(d_loss)):
        raise AssertionError(f"VAAL losses {strat.last_losses}")
    avail = strat.available_query_mask()
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    picks, cost = strat.query(budget)
    torch.cuda.synchronize()
    q_wall = time.perf_counter() - t0
    q_launches = ops.kernel_launches()
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved
    picks = np.asarray(picks)
    if not (cost == budget == np.unique(picks).size and avail[picks].all()
            and q_launches["bn_act"] >= on_card):
        raise AssertionError(f"VAAL query: {cost} picks, launches "
                             f"{q_launches}")
    out = {"fit_s": fit_s, "co_steps": len(co_ms),
           "co_step_ms": co_ms, "classifier_step_ms": cls_ms,
           "co_step_ms_median": float(np.median(co_ms)),
           "classifier_step_ms_median": float(np.median(cls_ms)),
           "losses": [vae_loss, d_loss], "fit_launches": fit_launches,
           "query_wall_s": q_wall, "scored_rows": int(avail.sum()),
           "query_launches": q_launches}
    abcd = ("prob_stats", "bn_act", "bn_train_stats", "bn_train_bwd_reduce",
            "bn_train_dx", "fused_sgd")
    log(f"VAAL fit: {len(cls_ms)} classifier steps + {len(co_ms)} co-steps "
        f"in {fit_s:.1f} s; step medians: co-step "
        f"{out['co_step_ms_median']:.1f} ms, classifier "
        f"{out['classifier_step_ms_median']:.1f} ms; last losses "
        f"{[round(v, 4) for v in strat.last_losses]}; launches A-D "
        f"{ {k: fit_launches[k] for k in abcd} }")
    log(f"VAAL query: {budget} picks over {int(avail.sum())} rows in "
        f"{q_wall:.2f} s; launches "
        f"{ {k: v for k, v in q_launches.items() if v} }")
    rows = data[2].gather(np.arange(32))
    view, window = strat.al_set.view, strat.score_window
    del strat, model, data
    torch.cuda.empty_cache()
    return out, calls, (rows, view, window)


def check_vaal_f32_against_cpu(rows, view, window, b=8,
                               devices=("cuda", "cpu")):
    """One co-step (crop 64, z 64, B = ``b`` with two padding rows) and
    the score step in float32 on the card (TF32 off) and on the CPU from
    the same seeded weights and inputs.  Losses within 1e-3 relative
    (float32 convolutions in another order, and the first Adam step's
    undetermined signs, which move the discriminator step's forwards);
    then, on the card's updated weights loaded into both, d_score within
    1e-5 and the 16 lowest picks equal where neighbours are further
    apart than 2e-5 (``rows``: uint8 224-px rows)."""
    from active_learning_tpu_torch.data.augment import apply_view
    from active_learning_tpu_torch.device import set_float32_precision
    from active_learning_tpu_torch.models.vaal import crop_window
    from active_learning_tpu_torch.strategies import vaal as sv

    set_float32_precision(torch.float32)
    z, crop = 64, 64
    ref = sv.VAALModels(z, crop, "cpu")
    ref.reinit(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    x_l, x_u = (torch.from_numpy(rng.normal(size=(b, crop, crop, 3)).astype(
        np.float32)) for _ in range(2))
    m_l = torch.ones(b)
    m_l[-2:] = 0.0
    m_u = torch.ones(b)
    eps = [torch.from_numpy(rng.normal(size=(b, z)).astype(np.float32))
           for _ in range(4)]
    models, losses = [], []
    for device in devices:
        m = sv.VAALModels(z, crop, device)
        m.vae.load_state_dict(ref.vae.state_dict())
        m.disc.load_state_dict(ref.disc.state_dict())
        losses.append([float(v) for v in sv.vaal_step(
            m, x_l.to(device), x_u.to(device), m_l.to(device),
            m_u.to(device), [e.to(device) for e in eps], 5e-5, 1e-3, 10.0)])
        models.append(m)
    for a, c in zip(*losses):
        if abs(a - c) > 1e-3 * abs(c):
            raise AssertionError(f"VAAL f32 losses card {losses[0]} vs CPU "
                                 f"{losses[1]}")
    models[1].vae.load_state_dict(models[0].vae.state_dict())
    models[1].disc.load_state_dict(models[0].disc.state_dict())
    scores = []
    for device, m in zip(devices, models):
        x = crop_window(apply_view(torch.from_numpy(rows).to(device), view,
                                   train=False), crop, *window)
        m.vae.eval()
        with torch.no_grad():
            scores.append(m.disc(m.vae(x)[2]).reshape(-1).cpu().numpy())
    err = float(np.abs(scores[0] - scores[1]).max())
    k = min(16, len(rows) - 1)
    order_c = np.argsort(scores[0], kind="stable")[:k]
    order_p = np.argsort(scores[1], kind="stable")[:k]
    apart = np.diff(np.sort(scores[1])[:k + 1]) > 2e-5
    clear = apart.copy()  # apart from the next one
    clear[1:] &= apart[:-1]  # and from the one before
    if err > 1e-5 or not np.array_equal(order_c[clear], order_p[clear]):
        raise AssertionError(f"VAAL f32 d_score card vs CPU: max err {err}, "
                             f"picks {order_c} vs {order_p}")
    log(f"VAAL f32 co-step card vs CPU: losses {losses[0]} vs {losses[1]}; "
        f"d_score max err {err:.3g} over {len(rows)} rows, lowest-{k} picks "
        f"equal ({int(clear.sum())} clear of ties)")
    return {"losses_card": losses[0], "losses_cpu": losses[1],
            "d_score_max_err": err}


# -- phase 14: the last samplers through the CLI ------------------------------

CLI_SAMPLERS = {
    "BalancingSampler": ("balancing_pick", "bn_act", "bn_train_dx",
                         "fused_sgd"),
    "MarginClusteringSampler": ("prob_stats", "bn_act", "bn_train_dx",
                                "fused_sgd"),
    "VAALSampler": ("bn_act", "bn_train_stats", "bn_train_bwd_reduce",
                    "bn_train_dx", "fused_sgd")}


def record_cli_sampler_inputs():
    """The inputs kernels H, B and C take on the cli_samplers path: each
    sampler built in this process from the CLI's flags (SSLResNet18,
    synthetic, 32 px), VAAL trained for its round 0 (the VAE's and the
    classifier's BatchNorms), then each round-1 query run once."""
    from active_learning_tpu_torch.experiment import cli, driver

    with tempfile.TemporaryDirectory(prefix="chip_smoke_rec_") as tmp:
        with recording_kernel_inputs(_h_targets() + _bc_targets()) as calls:
            for name in CLI_SAMPLERS:
                cfg = cli.parse([*_CLI_FLAGS, "--log_dir", tmp,
                                 "--ckpt_path", tmp, "--strategy", name])
                strat = driver.build_experiment(cfg)
                if name == "VAALSampler":
                    strat.init_network_weights()
                    strat.train()
                strat.round = 1
                strat.query(cfg.round_budget)
                del strat
    torch.cuda.synchronize()
    return calls


def run_cli_samplers(tmp: str):
    """The three samplers through the CLI on the card (2 rounds), and
    with ``--device cpu`` for round 0 (one round, one epoch: round 0's
    indices are drawn before any training): round-0 indices equal."""
    out, total = {}, {}
    for name, need in CLI_SAMPLERS.items():
        run = _run_cli(os.path.join(tmp, name), ["--strategy", name])
        cpu = _run_cli(os.path.join(tmp, name + "_cpu"),
                       ["--strategy", name, "--device", "cpu", "--rounds",
                        "1", "--n_epoch", "1"])
        if run["tested"] != {0, 1}:
            raise AssertionError(f"CLI {name}: rounds tested {run['tested']}")
        if not (np.array_equal(run["round0"], cpu["round0"])
                and np.array_equal(run["eval_idxs"], cpu["eval_idxs"])):
            raise AssertionError(f"CLI {name}: round-0 indices differ "
                                 "between card and CPU")
        missing = [k for k in need if run["launches"][k] < 1]
        if missing or any(cpu["launches"].values()):
            raise AssertionError(f"CLI {name}: never launched {missing} on "
                                 f"the card, or launched on the CPU "
                                 f"{cpu['launches']}")
        aux = os.path.exists(os.path.join(run["exp_dir"],
                                          "aux_state.msgpack"))
        if aux != (name == "VAALSampler"):
            raise AssertionError(f"CLI {name}: aux_state.msgpack {aux}")
        log(f"CLI {name} on the card: {run['wall_s']:.1f} s, launches "
            f"{ {k: v for k, v in run['launches'].items() if v} }; with "
            f"--device cpu (round 0) {cpu['wall_s']:.1f} s, round-0 indices "
            "equal")
        out[name] = {"wall_s": run["wall_s"], "cpu_wall_s": cpu["wall_s"],
                     "launches": run["launches"],
                     "phase_times": run["phase_times"]}
        for k, v in run["launches"].items():
            total[k] = total.get(k, 0) + v
    return out, total


# -- phase 15: kernel I against its plain version -----------------------------

BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
F32_EPS = 2.0 ** -24           # float32 unit roundoff
# (B, H, W, dtype, g NHWC-contiguous): the fit path's width, a float32
# batch, a bf16 batch whose blocks' runs wrap the copy ring (7 tiles a
# run, 4 stages) while the worst-case bound stays under a tenth of a
# typical |dW|, and edge shapes (one row, non-square, odd) at 4x4 taps,
# pads (2, 1).  Every case also runs with the other input dtype at its
# shape.
STEM_SHAPES = [(128, 112, 112, torch.bfloat16, True),
               (8, 112, 112, torch.float32, False),
               (16, 112, 112, torch.bfloat16, True),
               (1, 2, 2, torch.bfloat16, True),
               (3, 4, 6, torch.bfloat16, False),
               (2, 7, 5, torch.float32, True)]


def _stem_inputs(dev, b, h, w, dtype, contiguous, seed):
    """x [B, H, W, 12] and g [B, H, W, 64] from a seed; with
    ``contiguous=False`` g is the NHWC view of an NCHW tensor, the
    strides a cotangent may arrive with."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h, w, 12, device=dev, generator=gen).to(dtype)
    g = torch.randn(b, 64, h, w, device=dev, generator=gen).to(dtype)
    g = g.permute(0, 2, 3, 1)
    return x, (g.contiguous() if contiguous else g)


def stem_bound(b, h, w, dtype):
    """Least time for kernel I's work: x and g read once, dW written
    once; 2·R·12,288 operations at the input type's peak (bf16 products
    are exact in f32, so tensor cores could do them)."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * h * w * (12 + 64) * elt + 64 * 12 * 16 * 4
    flops = 2.0 * b * h * w * 64 * 12 * 16
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / rate
    return {"bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "f32_core_ms": flops / F32_FLOPS_PER_S * 1e3}


def _pad_s2d_nchw(x_nhwc):
    """The NCHW (channels-last) view of NHWC rows, zero-padded by the
    s2d stem's ((2, 1), (2, 1))."""
    x = torch.nn.functional.pad(x_nhwc.permute(0, 3, 1, 2), (2, 1, 2, 1))
    return x.contiguous(memory_format=torch.channels_last)


def _ratio(d, scale):
    """Largest d / scale, where scale == 0 allows only d == 0."""
    r = torch.where(scale > 0, d / scale.clamp_min(1e-300),
                    torch.where(d > 0, float("inf"), 0.0))
    return float(r.max())


def hold_stem_dw(x, g, where, detail, path="phase15"):
    """Kernel I on (x, g) against its plain version (float32, TF32 off)
    and against float64 truth; two launches bit-equal.  A sum whose
    chain is L units of u is within ``L·u·Σ|x||g|`` of the exact sum per
    output: the kernel's chain is L_k units of ``error_unit`` (bf16, on
    the tensor cores: 2⁻²³, a truncated last place; f32: 2⁻²⁴), the
    plain version's is taken as its whole sum, R float32 additions (its
    library order is not documented).  So ``2·max(L_k·u_k, R·2⁻²⁴)·
    Σ|x||g|`` between the two implementations and ``1.01·L_k·u_k·
    Σ|x||g|`` between the kernel and the float64 truth.  At the fit width
    that worst case is above a typical |dW| of these zero-mean inputs,
    so the kernel is also held to ``‖kernel − truth‖ ≤
    stem_conv.REL_NORM_LIMIT·‖truth‖`` (see there): a kernel that drops
    or misreads any one of its 16-position steps fails that.  Returns the
    largest |kernel − plain|."""
    from active_learning_tpu_torch.device import full_float32
    from active_learning_tpu_torch.ops import stem_conv as sc

    b, h, w, _ = x.shape
    before = sc.launches
    got = sc.stem_dw(x, g)
    again = sc.stem_dw(x, g)
    torch.cuda.synchronize()
    if sc.launches != before + 2:
        raise AssertionError("stem_dw did not count its launches")
    if got.dtype != torch.float32 or got.shape != (64, 12, 4, 4):
        raise AssertionError(f"stem_dw returned {got.dtype} "
                             f"{tuple(got.shape)}")
    if not torch.equal(got, again):
        raise AssertionError(f"kernel I at {where}: two launches differ")
    with full_float32():
        plain = sc.stem_dw_plain(x, g)
    truth = sc.stem_dw_plain(x.double(), g.double())
    mag = sc.stem_dw_plain(x.double().abs(), g.double().abs())
    lk, uk = sc.chain_length(b, h, w, x.dtype), sc.error_unit(x.dtype)
    lp = b * h * w
    big = max(lk * uk, lp * F32_EPS)
    d_plain = (got.double() - plain.double()).abs()
    d_true = (got.double() - truth).abs()
    d_ptrue = (plain.double() - truth).abs()
    r_plain = _ratio(d_plain, 2 * big * mag)
    r_true = _ratio(d_true, 1.01 * lk * uk * mag)
    r_ptrue = _ratio(d_ptrue, 1.01 * lp * F32_EPS * mag)
    rel = float(torch.linalg.vector_norm(got.double() - truth)
                / torch.linalg.vector_norm(truth))
    rel_plain = float(torch.linalg.vector_norm(plain.double() - truth)
                      / torch.linalg.vector_norm(truth))
    rec = {"path": path, "kernel": "stem_dw", "where": where,
           "dtype": str(x.dtype), "g_contiguous": g.is_contiguous(),
           "L_kernel": lk, "unit_kernel": uk, "L_plain": lp,
           "max_abs_err": float(d_plain.max()),
           "max_abs_err_vs_f64": float(d_true.max()),
           "ratio_to_bound": r_plain, "ratio_to_bound_vs_f64": r_true,
           "plain_ratio_vs_f64": r_ptrue, "rel_norm_err_vs_f64": rel,
           "plain_rel_norm_err_vs_f64": rel_plain,
           "rel_norm_limit": sc.REL_NORM_LIMIT, "bit_equal_relaunch": True}
    detail.append(rec)
    log(f"kernel I at {where} ({x.dtype}, g contiguous "
        f"{g.is_contiguous()}): L_k = {lk} units of {uk:.3g} (plain "
        f"{lp} of 2^-24), max |kernel - plain| {rec['max_abs_err']:.3g} = "
        f"{r_plain:.3g} of the bound; vs f64 "
        f"{rec['max_abs_err_vs_f64']:.3g} = {r_true:.3g} of "
        f"1.01·L_k·u_k·Σ|x||g|; ‖kernel - f64‖/‖f64‖ {rel:.3g} (limit "
        f"{sc.REL_NORM_LIMIT:.3g}; plain {rel_plain:.3g}); relaunch "
        "bit-equal")
    if not (r_plain <= 1.0 and r_true <= 1.0 and r_ptrue <= 1.0
            and rel <= sc.REL_NORM_LIMIT):
        raise AssertionError(f"kernel I at {where} outside its bound: {rec}")
    return rec["max_abs_err"]


def check_stem_dw(dev, detail):
    """Kernel I at the phase-15 shapes in both input types, held against
    its plain version, and timed at the fit path's width beside the
    plain version (TF32 off, restored after) and the library wgrad
    (``aten.convolution_backward`` on the pre-padded bf16 input).
    Returns (max |kernel − plain|, times at the fit width)."""
    from active_learning_tpu_torch.device import full_float32
    from active_learning_tpu_torch.ops import stem_conv as sc

    worst, times = 0.0, None
    for i, (b, h, w, dtype, contiguous) in enumerate(STEM_SHAPES):
        for dt in (dtype, torch.float32 if dtype == torch.bfloat16
                   else torch.bfloat16):
            x, g = _stem_inputs(dev, b, h, w, dt, contiguous, SEED + i)
            worst = max(worst, hold_stem_dw(x, g, f"B={b} {h}x{w}",
                                            detail))
            if i == 0 and dt == torch.bfloat16:
                xp = _pad_s2d_nchw(x)
                gy = g.permute(0, 3, 1, 2)
                wt = torch.empty(64, 12, 4, 4, device=dev, dtype=dt).to(
                    memory_format=torch.channels_last)

                def library():
                    return torch.ops.aten.convolution_backward(
                        gy, xp, wt, None, [1, 1], [0, 0], [1, 1], False,
                        [0, 0], 1, [False, True, False])[1]

                def plain():
                    with full_float32():
                        return sc.stem_dw_plain(x, g)

                times = {"ms": cuda_ms(lambda: sc.stem_dw(x, g), 20),
                         "plain_ms": cuda_ms(plain, 20),
                         "library_ms": cuda_ms(library, 20),
                         **stem_bound(b, h, w, dt)}
                times["over_bound"] = times["ms"] / times["bound_ms"]
                times["over_library"] = times["ms"] / times["library_ms"]
                log(f"kernel I at B={b} {h}x{w} bf16: {times['ms']:.4f} ms "
                    f"= {times['over_bound']:.2f}x its bound "
                    f"{times['bound_ms']:.4f} by {times['bound_by']}, "
                    f"{times['over_library']:.2f}x the library wgrad "
                    f"{times['library_ms']:.4f} (plain "
                    f"{times['plain_ms']:.4f}; "
                    f"{times['f32_core_ms']:.3f} ms at the f32 CUDA-core "
                    "rate)")
                del xp, gy, wt
            del x, g
            torch.cuda.empty_cache()
    log(f"kernel I checks passed: max |kernel - plain| {worst:.3g}")
    return worst, times


# -- phase 16: the s2d stem through train, query and serve -------------------

def _logits(model, rows, view):
    from active_learning_tpu_torch.data.augment import apply_view
    with torch.inference_mode():
        x = apply_view(torch.from_numpy(rows).to(next(
            model.parameters()).device), view, train=False)
        return model(x).double().cpu()


def check_s2d_logits(dev, variables, rows, view):
    """16.1: full-width SSLResNet50 logits on the card from one set of
    seeded weights, the default stem against the s2d stem on
    ``fold_stem`` weights, in float32 (TF32 off) and bf16.  Tolerance:
    the two networks compute one function (the fold is exact), so in a
    precision p each errs against the float64 network (the CPU) by about
    e_p = max|y_default(p) − y(f64)|; they may err in other directions,
    and are held to |y_s2d(p) − y_default(p)| ≤ 4·e_p."""
    from active_learning_tpu_torch.device import full_float32
    from active_learning_tpu_torch.models.factory import get_network
    from active_learning_tpu_torch.models.weights import (
        fold_stem, from_flax_variables)

    sd = from_flax_variables(variables)
    ref = get_network("imagenet", "SSLResNet50", dtype=torch.float64,
                      device="cpu")
    ref.load_state_dict(sd)
    with torch.inference_mode():
        from active_learning_tpu_torch.data.augment import apply_view
        emb = ref.encoder(apply_view(torch.from_numpy(rows), view,
                                     train=False).double())
        y64 = torch.nn.functional.linear(emb.double(),
                                         ref.linear.weight.double(),
                                         ref.linear.bias.double())
    del ref
    out = {}
    for dtype in ("float32", "bfloat16"):
        ys = {}
        for stem in ("default", "s2d"):
            model = get_network("imagenet", "SSLResNet50", dtype=dtype,
                                stem=stem, device=dev)
            model.load_state_dict(fold_stem(sd) if stem == "s2d" else sd)
            with full_float32():
                ys[stem] = _logits(model, rows, view)
            del model
        e = float((ys["default"] - y64).abs().max())
        e_s2d = float((ys["s2d"] - y64).abs().max())
        d = float((ys["s2d"] - ys["default"]).abs().max())
        out[dtype] = {"max_diff": d, "tolerance": 4 * e,
                      "default_err_vs_f64": e, "s2d_err_vs_f64": e_s2d,
                      "logit_scale": float(y64.abs().max())}
        log(f"s2d vs default stem logits, {dtype}: max diff {d:.3g}, "
            f"tolerance 4·e = {4 * e:.3g} (default's error vs f64 {e:.3g}, "
            f"s2d's {e_s2d:.3g}; logits up to "
            f"{out[dtype]['logit_scale']:.3g})")
        if not (np.isfinite(d) and d <= 4 * e):
            raise AssertionError(f"s2d logits differ from the default "
                                 f"stem's in {dtype}: {out[dtype]}")
    torch.cuda.empty_cache()
    return out


def _facsimile_224(n_train, n_test, num_classes=1000, seed=SEED, hw=224):
    """Seeded 224-px rows with the ImageNet view contract (as
    ``tests/test_learn_smoke_224.py``'s facsimile: IMAGENET_NORM, a
    flip-only train view)."""
    from active_learning_tpu_torch.data.core import (IMAGENET_NORM,
                                                     ArrayDataset, ViewSpec)
    from active_learning_tpu_torch.data.synthetic import (_class_templates,
                                                          _make_images)

    rng = np.random.default_rng(seed)
    templates = _class_templates(num_classes, hw, rng)
    tr, tr_t = _make_images(n_train, templates, rng, noise_sigma=12.0)
    te, te_t = _make_images(n_test, templates, rng, noise_sigma=12.0)
    del templates
    train = ArrayDataset(tr, tr_t, num_classes,
                         ViewSpec(IMAGENET_NORM, augment=True, pad=0))
    test = ArrayDataset(te, te_t, num_classes, ViewSpec(IMAGENET_NORM))
    return train, test, train.with_view(ViewSpec(IMAGENET_NORM))


def run_s2d_experiment(root: str, n_train: int = 1024,
                       num_classes: int = 1000, hw: int = 224,
                       device: str = "cuda"):
    """16.2: ``run_experiment`` on the card with the s2d stem:
    SSLResNet50, 1000 classes, MarginSampler, 2 rounds of 256, the
    ``default/imagenet`` TrainConfig (bf16, BN in training mode, B=128),
    2 epochs a round, over seeded 224-px rows.  Launch counters zeroed
    just before, read just after; kernel I must launch once per train
    step."""
    from active_learning_tpu_torch import ops
    from active_learning_tpu_torch.config import ExperimentConfig
    from active_learning_tpu_torch.experiment import driver
    from active_learning_tpu_torch.train import checkpoint as ckpt_lib
    from active_learning_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    data = _facsimile_224(n_train, 128, num_classes, hw=hw)
    log(f"s2d experiment data: {n_train} + 128 rows in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = ExperimentConfig(
        dataset="imagenet", model="SSLResNet50", stem="s2d",
        strategy="MarginSampler", rounds=2, round_budget=256, n_epoch=2,
        early_stop_patience=2, exp_hash="s2d_smoke", device=device,
        log_dir=os.path.join(root, "logs"),
        ckpt_path=os.path.join(root, "ckpt"))
    steps = {"n": 0, "shapes": set()}
    train_step = Trainer.train_step

    def counting(self, batch, *args, **kw):
        steps["n"] += 1
        steps["shapes"].add(tuple(batch["image"].shape))
        return train_step(self, batch, *args, **kw)

    Trainer.train_step = counting
    try:
        ops.reset_kernel_launches()
        t0 = time.perf_counter()
        strategy = driver.run_experiment(cfg, data=data)
        torch.cuda.synchronize(strategy.trainer.device)
        wall = time.perf_counter() - t0
        launches = ops.kernel_launches()
    finally:
        Trainer.train_step = train_step
    model = strategy.model
    exp_dir = os.path.join(root, "ckpt", "active_learning_s2d_smoke")
    best = ckpt_lib.load_variables(os.path.join(exp_dir, "best_rd_1.msgpack"))
    kshape = best["params"]["encoder"]["conv_stem"]["kernel"].shape
    with open(os.path.join(exp_dir, "experiment_state.json")) as fh:
        echo = json.load(fh)["config"]
    phase_times = {}
    with open(os.path.join(root, "logs", "metrics.jsonl")) as fh:
        for ln in fh:
            e = json.loads(ln)
            if e["kind"] == "metric":
                for k, v in e["metrics"].items():
                    if k.endswith("_time") or k == "rd_test_accuracy":
                        phase_times[f"{k}@{e['step']}"] = v
    log(f"s2d experiment on the card: {wall:.1f} s, {steps['n']} train "
        f"steps on rows {sorted(steps['shapes'])}, launches {launches}; "
        f"phases {phase_times}")
    if model.stem != "s2d" or (device == "cuda"
                               and model.dtype != torch.bfloat16):
        raise AssertionError(f"the experiment's model is {model.stem}, "
                             f"{model.dtype}")
    if tuple(kshape) != (4, 4, 12, 64) or echo.get("stem") != "s2d":
        raise AssertionError(f"saved stem kernel {kshape}, echo stem "
                             f"{echo.get('stem')}")
    if steps["shapes"] != {(128, hw // 2, hw // 2, 12)}:
        raise AssertionError(f"train batches {steps['shapes']}")
    if launches["stem_dw"] != steps["n"] or steps["n"] < 1:
        raise AssertionError(f"kernel I launched {launches['stem_dw']} "
                             f"times over {steps['n']} train steps")
    for k in ("prob_stats", "bn_act", "bn_train_stats", "bn_train_dx",
              "fused_sgd"):
        if launches[k] < 1:
            raise AssertionError(f"the s2d experiment never launched {k}")
    if int(strategy.pool.labeled.sum()) != 512:
        raise AssertionError("the s2d experiment did not label 512 rows")
    del strategy, model, data
    torch.cuda.empty_cache()
    return {"wall_s": wall, "train_steps": steps["n"], "launches": launches,
            "phase_times": phase_times, "exp_dir": exp_dir}


def run_s2d_serve(exp_dir: str, extra=()):
    """16.3: the ``serve`` verb's server (``serve/cli.build_server``, what
    ``python -m active_learning_tpu_torch serve`` runs) on the s2d
    experiment, in this process: three 64-row /v1/score requests; the
    served scores bit-equal to the offline prob-stats step over
    host-s2d rows at the same bucket."""
    from active_learning_tpu_torch import ops
    from active_learning_tpu_torch.data.pipeline import space_to_depth
    from active_learning_tpu_torch.serve import cli
    from active_learning_tpu_torch.strategies.scoring import (
        make_prob_stats_step)

    args = cli.get_parser().parse_args(
        ["--experiment_dir", exp_dir, "--port", "0", "--max_batch", "64",
         *extra])
    server = cli.build_server(args)
    ex = server.executor
    if ex.model.stem != "s2d" or not ex.host_s2d:
        raise AssertionError("serve did not resolve the s2d stem")
    loop = asyncio.new_event_loop()
    started = threading.Event()
    stop = None

    async def serve():
        nonlocal stop
        stop = asyncio.Event()
        await server.start()
        started.set()
        await stop.wait()
        await server.drain()

    thread = threading.Thread(target=lambda: loop.run_until_complete(serve()),
                              name="smoke-s2d-server")
    thread.start()
    if not started.wait(600):
        raise RuntimeError("the s2d server did not start")
    rng = np.random.default_rng(SEED + 16)
    reqs = [rng.integers(0, 256, (64, *ex.image_shape), dtype=np.uint8)
            for _ in range(3)]
    try:
        ops.reset_kernel_launches()
        lat, resps = [], []
        for rows in reqs:
            t = time.perf_counter()
            resps.append(_post(server.port, "/v1/score", _b64(rows)))
            lat.append(time.perf_counter() - t)
        launches = ops.kernel_launches()
    finally:
        loop.call_soon_threadsafe(stop.set)
        thread.join(120)
    if thread.is_alive():
        raise RuntimeError("the s2d server did not drain")
    step = make_prob_stats_step(ex.view)
    for rows, resp in zip(reqs, resps):
        dev = {"image": torch.from_numpy(space_to_depth(rows)).to(
            ex.device)}
        direct = {k: v.cpu().numpy() for k, v in step(ex.model, dev).items()}
        for k in ("pred", "confidence", "margin", "entropy"):
            served = np.asarray([r[k] for r in resp["scores"]],
                                dtype=direct[k].dtype)
            if not np.array_equal(served, direct[k]):
                raise AssertionError(f"served {k} of the s2d model differs "
                                     "from the offline step")
    if launches["prob_stats"] < 3 or launches["bn_act"] < 1 or \
            launches["stem_dw"] != 0:
        raise AssertionError(f"s2d serve launches {launches}")
    log(f"s2d serve: 3 x 64 rows, client latency "
        f"{[round(v * 1e3, 2) for v in lat]} ms, served round "
        f"{ex.served_round}; scores bit-equal to the offline step over "
        f"host-s2d rows; launches {launches}")
    return {"client_ms": [v * 1e3 for v in lat], "launches": launches}


def time_s2d_step(dev, reps: int = 10):
    """16.4: one B=128 train step of full-width SSLResNet50 (1000
    classes, bf16, default/imagenet), s2d stem against the default stem
    on the same rows, in turns (default, s2d, s2d, default), on the host
    clock and with CUDA events; and the stem alone (forward and weight
    gradient) both ways.  No claim: a record."""
    from active_learning_tpu_torch.data.core import IMAGENET_NORM, ViewSpec
    from active_learning_tpu_torch.data.pipeline import space_to_depth
    from active_learning_tpu_torch.experiment.arg_pools import \
        get_train_config
    from active_learning_tpu_torch.models.factory import get_network
    from active_learning_tpu_torch.models.resnet import (S2DStemConv,
                                                         init_weights)
    from active_learning_tpu_torch.train.trainer import Trainer

    cfg = get_train_config("default", "imagenet")
    view = ViewSpec(IMAGENET_NORM, augment=True, pad=0)
    rng = np.random.default_rng(SEED + 4)
    rows = rng.integers(0, 256, (128, 224, 224, 3), dtype=np.uint8)
    labels = rng.integers(0, 1000, 128).astype(np.int32)
    runs = {}
    for stem in ("default", "s2d"):
        model = get_network("imagenet", "SSLResNet50", stem=stem, device=dev)
        init_weights(model, torch.Generator().manual_seed(SEED))
        trainer = Trainer(model, cfg, 1000, dev)
        model.train()
        batch = trainer.to_device({
            "image": space_to_depth(rows) if stem == "s2d" else rows,
            "label": labels, "mask": np.ones(128, np.float32)})
        gen = torch.Generator(device=dev).manual_seed(SEED)
        w = torch.ones(1000, device=dev)
        for _ in range(3):
            trainer.train_step(batch, 0.1, w, view, gen)
        runs[stem] = (trainer, batch, gen, w)
    torch.cuda.synchronize()
    host = {"default": [], "s2d": []}
    device = {"default": [], "s2d": []}
    for stem in ("default", "s2d", "s2d", "default"):
        trainer, batch, gen, w = runs[stem]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            trainer.train_step(batch, 0.1, w, view, gen)
        end.record()
        torch.cuda.synchronize()
        host[stem].append((time.perf_counter() - t0) * 1e3 / reps)
        device[stem].append(start.elapsed_time(end) / reps)
    from torch.profiler import ProfilerActivity, profile

    busy = {}
    for stem in ("default", "s2d"):
        trainer, batch, gen, w = runs[stem]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                trainer.train_step(batch, 0.1, w, view, gen)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 3
        summary = summarize_profile(prof, 3)
        busy[stem] = {"wall_ms": wall,
                      "device_ms": summary["device_ms_per_step"],
                      "device_busy_share":
                          summary["device_ms_per_step"] / wall,
                      "launches_per_step":
                          summary["kernel_launches_per_step"],
                      "top_kernels_ms": summary[
                          "top_kernels_ms_per_step"][:6]}
    del runs
    torch.cuda.empty_cache()

    # The stem alone: conv forward + weight gradient at the fit width.
    g = torch.Generator(device=dev).manual_seed(SEED)
    x7 = torch.randn(128, 3, 224, 224, device=dev, generator=g).to(
        dtype=torch.bfloat16, memory_format=torch.channels_last)
    w7 = torch.randn(64, 3, 7, 7, device=dev, generator=g,
                     requires_grad=True)
    x4 = torch.randn(128, 12, 112, 112, device=dev, generator=g).to(
        dtype=torch.bfloat16, memory_format=torch.channels_last)
    w4 = torch.randn(64, 12, 4, 4, device=dev, generator=g,
                     requires_grad=True)
    gy = torch.randn(128, 64, 112, 112, device=dev, generator=g).to(
        dtype=torch.bfloat16, memory_format=torch.channels_last)

    def stem7():
        y = torch.nn.functional.conv2d(
            x7, w7.to(dtype=torch.bfloat16,
                      memory_format=torch.channels_last), stride=2,
            padding=3)
        return torch.autograd.grad(y, [w7], gy)

    def stem4():
        return torch.autograd.grad(S2DStemConv.apply(x4, w4, torch.bfloat16),
                                   [w4], gy)

    stem_ms = {"default": cuda_ms(stem7, 20), "s2d": cuda_ms(stem4, 20)}
    del x7, x4, gy
    torch.cuda.empty_cache()
    out = {"host_ms": host, "event_ms": device, "stem_fwd_dw_ms": stem_ms,
           "profiled": busy, "reps": reps}
    log(f"B=128 train step, host clock ms (default, s2d, s2d, default "
        f"turns): default {host['default']}, s2d {host['s2d']}; CUDA "
        f"events: default {device['default']}, s2d {device['s2d']}; the "
        f"stem alone (forward + dW): default {stem_ms['default']:.3f} ms, "
        f"s2d {stem_ms['s2d']:.3f} ms")
    out["s2d_minus_default_device_ms"] = (busy["s2d"]["device_ms"]
                                          - busy["default"]["device_ms"])
    log(f"B=128 train step device time (profiler): s2d stem "
        f"{busy['s2d']['device_ms']:.3f} ms, default stem "
        f"{busy['default']['device_ms']:.3f} ms "
        f"({out['s2d_minus_default_device_ms']:+.3f} ms)")
    for stem, b in busy.items():
        log(f"  profiled {stem} step: {b['wall_ms']:.2f} ms wall, "
            f"{b['device_ms']:.2f} ms device busy "
            f"({b['device_busy_share']:.0%}), "
            f"{b['launches_per_step']:.0f} launches; top kernels "
            f"{[(n[:60], round(ms, 3)) for n, ms in b['top_kernels_ms']]}")
    return out


# -- phase 17: kernel J against its plain version -----------------------------

INT8_NS = (2, 4, 8)
INT8_FORMS = ("allgather", "reduce_scatter")


def _int8_ranks(dev, shapes, n, seed):
    """n ranks' gradient leaves from a seed, magnitudes 1e-3 to 10; a NaN
    on rank 0 (leaf 1) and an inf on rank n-1 (leaf 2)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    per = [[torch.randn(s, device=dev, generator=g) * 10.0 ** (i % 5 - 3)
            for i, s in enumerate(shapes)] for _ in range(n)]
    per[0][1].view(-1)[7] = float("nan")
    per[n - 1][2].view(-1)[-1] = float("inf")
    return per


def _int8_bounds(n_el, nb, t):
    """Bytes each device function must move for ``n_el`` elements in
    ``nb`` blocks with ``t`` payloads: each input read once, each output
    written once."""
    return {"block_absmax": _bound(4 * n_el + 4 * nb, 0),
            "quantize": _bound(4 * n_el + 4 * nb + n_el + 4 * nb, 0),
            "dequant_sum": _bound(t * n_el + 8 * nb + 4 * n_el, 0)}


def check_int8_sync(dev, detail):
    """Kernel J's four device functions against their plain versions at
    N = 2, 4, 8 thread ranks of one process, each running the sync the
    trainer runs (``int8_allreduce`` / ``int8_reduce_scatter`` over a
    ``ThreadMesh``, whose collectives meet in memory), both wire forms,
    over SSLResNet50's 161 gradient leaves and edge leaves of 1, 255,
    257 and 256·N + 3 elements: bit for bit on every rank, the NaN's and
    the inf's blocks NaN everywhere.  Then each function timed at N = 2
    on the packed SSLResNet50 buffer beside its plain version (the torch
    composite abs/amax/div/round/clamp/to(int8): no single PyTorch call
    computes any of them) and its bytes bound."""
    from active_learning_tpu_torch.models.factory import get_network
    from active_learning_tpu_torch.ops import int8_sync as j
    from active_learning_tpu_torch.parallel import mesh as pm

    model = get_network("imagenet", "SSLResNet50", device=dev)
    shapes = [tuple(p.shape) for p in model.parameters()]
    del model
    err, t0 = 0.0, time.perf_counter()
    for n in INT8_NS:
        leaves = shapes + [(1,), (255,), (257,), (256 * n + 3,)]
        per = _int8_ranks(dev, leaves, n, seed=n)
        host = [[t.cpu() for t in ts] for ts in per]
        for form in INT8_FORMS:
            fn = (pm.int8_allreduce if form == "allgather"
                  else pm.int8_reduce_scatter)
            got = pm.run_thread_ranks(
                lambda m, fn=fn: fn(per[m.rank], m), n, dev, timeout_s=300)
            want = pm.run_thread_ranks(
                lambda m, fn=fn: fn(host[m.rank], m), n, "cpu",
                timeout_s=600)
            torch.cuda.synchronize()
            bad = 0
            for r in range(n):
                for a, b in zip(got[r], want[r]):
                    a = a.cpu()
                    if not torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)):
                        bad += 1
                        err = max(err, float(torch.nan_to_num(
                            (a - b).abs(), nan=float("inf")).max()))
                if not (torch.isnan(got[r][1]).all()
                        and torch.isnan(got[r][2]).all()):
                    raise AssertionError(f"kernel J at N={n} {form}: a "
                                         "non-finite block came out finite")
            detail.append({"kernel": "int8_sync", "n": n, "form": form,
                           "leaves": len(leaves), "leaves_differing": bad})
            if bad:
                raise AssertionError(f"kernel J at N={n} {form}: {bad} "
                                     "leaves differ from the plain version")
            del got, want
        del per, host
        torch.cuda.empty_cache()
    log(f"kernel J bit-equal to its plain version at N = {INT8_NS}, both "
        f"wire forms, {len(shapes)} + 4 leaves "
        f"({time.perf_counter() - t0:.1f} s)")

    # Times at N = 2 on the packed SSLResNet50 gradients.
    g = torch.Generator(device=dev).manual_seed(1)
    grads = [torch.randn(s, device=dev, generator=g) * 1e-3 for s in shapes]
    ms, plain, bounds = {}, {}, {}
    for form in INT8_FORMS:
        lay = pm.sync_layout(grads, 2, form)
        flat = lay.pack(grads, dev)
        slots = lay.slot_of_block(dev)
        nb = lay.num_blocks
        absmax = j.block_absmax(flat)
        q, scale = j.quantize(flat, absmax, slots)
        key = "" if form == "allgather" else "rs_"
        ms[key + "block_absmax"] = cuda_ms(lambda: j.block_absmax(flat))
        plain[key + "block_absmax"] = cuda_ms(
            lambda: j.block_absmax_reference(flat), reps=10)
        ms[key + "quantize"] = cuda_ms(lambda: j.quantize(flat, absmax,
                                                          slots))
        plain[key + "quantize"] = cuda_ms(
            lambda: j.quantize_reference(flat, absmax, slots), reps=10)
        b = _int8_bounds(lay.total, nb, 2)
        bounds[key + "block_absmax"] = b["block_absmax"]["bound_ms"]
        bounds[key + "quantize"] = b["quantize"]["bound_ms"] + (
            4 * nb / HBM_BYTES_PER_S * 1e3 if slots is not None else 0)
        if form == "allgather":
            two = torch.stack([q, q])
            ms["dequant_sum"] = cuda_ms(lambda: j.dequant_sum(two, scale,
                                                              absmax))
            plain["dequant_sum"] = cuda_ms(
                lambda: j.dequant_sum_reference(two, scale, absmax), reps=10)
            bounds["dequant_sum"] = b["dequant_sum"]["bound_ms"]
            del two
        else:
            per = lay.per_dest
            recv = q.view(2, -1).contiguous()
            my = scale[:per].contiguous()
            ms["rs_sum_requantize"] = cuda_ms(
                lambda: j.sum_requantize(recv, my))
            plain["rs_sum_requantize"] = cuda_ms(
                lambda: j.sum_requantize_reference(recv, my), reps=10)
            shard = per * 256
            bounds["rs_sum_requantize"] = _bound(
                2 * shard + 4 * per + shard + 4 * per, 0)["bound_ms"]
            q2, s2 = j.sum_requantize(recv, my)
            g2 = torch.cat([q2, q2]).view(1, -1)
            s2 = torch.cat([s2, s2])
            ms["rs_dequant"] = cuda_ms(
                lambda: j.dequant_sum(g2, s2, absmax, slots))
            plain["rs_dequant"] = cuda_ms(
                lambda: j.dequant_sum_reference(g2, s2, absmax, slots),
                reps=10)
            bounds["rs_dequant"] = _bound(
                lay.total + 12 * nb + 4 * lay.total, 0)["bound_ms"]
            del recv, q2, g2
        del flat, q, scale, absmax
    del grads
    torch.cuda.empty_cache()
    ag = ("block_absmax", "quantize", "dequant_sum")
    times = {"ms": sum(ms[k] for k in ag),
             "plain_ms": sum(plain[k] for k in ag),
             "bound_ms": sum(bounds[k] for k in ag), "bound_by": "bytes",
             "library_ms": None, "ms_by_function": ms,
             "plain_ms_by_function": plain,
             "bound_ms_by_function": bounds,
             "timed": "one all-gather sync at N=2 over SSLResNet50's "
                      f"{sum(int(np.prod(s)) for s in shapes):,} gradient "
                      "elements (collective excluded); plain = the torch "
                      "composite on the card"}
    log(f"kernel J times (ms, N=2): {json.dumps(ms)}; plain "
        f"{json.dumps(plain)}; bounds {json.dumps(bounds)}")
    return err, times


# -- phase 18: N ranks on the one card -----------------------------------------

DP_MODES = ("f32", "int8", "int8_rs")
# Rows labeled by the one round's query: 4 steps of 128 an epoch.
DP_BUDGET = 512


def _hold_sync(trainer, grads, synced):
    """The step's synced gradients against the f32 all-reduce of the same
    local gradients, and across the ranks (all-gathered, compared bit for
    bit).  Plain torch ops and the f32 sync only: no kernel J launch."""
    from active_learning_tpu_torch.parallel import mesh as pm

    mesh = trainer.mesh
    cpu = torch.device("cpu")
    flat = torch.cat([t.reshape(-1) for t in synced])
    every = mesh.all_gather(flat.to(cpu))
    equal = all(torch.equal(every[0].view(torch.int32),
                            every[r].view(torch.int32))
                for r in range(1, mesh.world_size))
    out = {"bit_equal_across_ranks": equal, "err_over_bound": None}
    if trainer.grad_sync != "int8":
        return out
    form = trainer.grad_sync_form
    lay = pm.sync_layout(grads, mesh.world_size, form)
    f32 = lay.pack(pm.allreduce_f32(grads, mesh), mesh.device).view(-1, 256)
    got = lay.pack(synced, mesh.device).view(-1, 256)
    absmax = mesh.all_reduce(
        lay.pack(grads, mesh.device).view(-1, 256).abs().amax(1), "max")
    bound = mesh.world_size * absmax / 127 / 2
    if form == "reduce_scatter":
        bound = bound + got.abs().amax(1) / 127 * 1.01 / 2
    # 1e-4 of the bound and 1e-6 of the value for the float32 roundings
    # of the scale, the division and the products.
    ratio = (got - f32).abs() / (bound[:, None] * (1 + 1e-4)
                                 + 1e-6 * f32.abs() + 1e-30)
    out["err_over_bound"] = float(ratio.max())
    out["max_abs_err"] = float((got - f32).abs().max())
    return out


def _dp_rank(rank, world, root, n_train, n_test, device="cuda:0",
             model_name="SSLResNet50", num_classes=1000, hw=224):
    """Phase 18, one rank (a spawned process): ``run_experiment`` with this
    rank's mesh under each gradient sync, recording the probe, the step
    times, the launch counters and the first SSLResNet50 sync's checks;
    writes ``dp_rank{rank}.json`` under ``root``."""
    from active_learning_tpu_torch import ops
    from active_learning_tpu_torch.config import ExperimentConfig
    from active_learning_tpu_torch.experiment import driver
    from active_learning_tpu_torch.parallel import mesh as pm
    from active_learning_tpu_torch.train.trainer import Trainer

    mesh = pm.make_mesh(-1, device, backend="gloo")
    data = _facsimile_224(n_train, n_test, num_classes, hw=hw)

    def sync_device():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    # Host time inside the mesh's collectives during a timed step, the
    # device synchronized first: a staged collective's wait for the
    # kernels before it is not counted as the collective's.
    coll = {"on": False, "s": 0.0, "n": 0, "hold_s": 0.0}

    def timing(fn):
        def wrapped(self, *a, **k):
            if not coll["on"]:
                return fn(self, *a, **k)
            sync_device()
            t0 = time.perf_counter()
            out = fn(self, *a, **k)
            coll["s"] += time.perf_counter() - t0
            coll["n"] += 1
            return out
        return wrapped

    for name in ("all_reduce", "all_gather", "all_to_all"):
        setattr(pm.Mesh, name, timing(getattr(pm.Mesh, name)))

    results = {"mesh": mesh.describe()}
    probe, step, sync = (driver.run_grad_allreduce_probe,
                         Trainer.train_step, Trainer.sync_grads)
    for mode in DP_MODES:
        rec = {"probe": None, "step_s": [], "coll_s": [], "coll_n": [],
               "sync": None}

        def probing(m, requested, rec=rec):
            rec["probe"] = probe(m, requested)
            return rec["probe"]

        def timed(self, *a, rec=rec, **k):
            main = len(self.params) > 10        # not the probe's model
            sync_device()
            coll.update(on=main, s=0.0, n=0, hold_s=0.0)
            t0 = time.perf_counter()
            out = step(self, *a, **k)
            sync_device()
            coll["on"] = False
            if main:
                rec["step_s"].append(time.perf_counter() - t0
                                     - coll["hold_s"])
                rec["coll_s"].append(coll["s"])
                rec["coll_n"].append(coll["n"])
            return out

        def checked(self, grads, rec=rec):
            out = sync(self, grads)
            if rec["sync"] is None and len(grads) > 10:
                # The checks' own collectives and time stay out of the
                # step's figures.
                on, coll["on"] = coll["on"], False
                t0 = time.perf_counter()
                rec["sync"] = _hold_sync(self, grads, out)
                rec["grad_elements"] = sum(g.numel() for g in grads)
                coll["hold_s"] = time.perf_counter() - t0
                coll["on"] = on
            return out

        cfg = ExperimentConfig(
            dataset="imagenet", model=model_name,
            strategy="MarginSampler", rounds=1, init_pool_size=0,
            round_budget=DP_BUDGET, n_epoch=2, early_stop_patience=2,
            exp_hash=f"dp_{mode}", device=device, grad_allreduce=mode,
            log_dir=os.path.join(root, "logs"),
            ckpt_path=os.path.join(root, "ckpt"))
        driver.run_grad_allreduce_probe = probing
        Trainer.train_step, Trainer.sync_grads = timed, checked
        try:
            ops.reset_kernel_launches()
            t0 = time.perf_counter()
            strategy = driver.run_experiment(cfg, data=data, mesh=mesh)
            sync_device()
            rec["wall_s"] = time.perf_counter() - t0
            rec["launches"] = ops.kernel_launches()
        finally:
            driver.run_grad_allreduce_probe = probe
            Trainer.train_step, Trainer.sync_grads = step, sync
        rec.update(grad_sync=strategy.trainer.grad_sync,
                   form=strategy.trainer.grad_sync_form,
                   labeled=int(strategy.pool.labeled.sum()),
                   test_acc=strategy.last_test_acc,
                   dtype=str(strategy.model.dtype))
        results[mode] = rec
        del strategy
        torch.cuda.empty_cache()
    with open(os.path.join(root, f"dp_rank{rank}.json"), "w") as fh:
        json.dump(results, fh, default=str)


def run_dp_experiment(root: str, n_train: int = 1024, n_test: int = 128,
                      device: str = "cuda:0", model_name="SSLResNet50",
                      num_classes: int = 1000, hw: int = 224):
    """18: two ranks in two processes, both on cuda:0, joined over gloo
    with every collective staged through pinned host memory (NCCL
    refuses two ranks on one card; this is the only form a one-card
    machine can run the N-rank path in).  Each rank calls
    ``run_experiment`` with its mesh: SSLResNet50, 1000 classes, 224 px,
    bf16, ``default/imagenet`` (global batch 128, 64 a rank),
    MarginSampler, one round (a query of 512 first, then 2 epochs of 4
    steps), under the f32, int8 and int8_rs syncs; each step's time and
    the host time inside its collectives, summed up over the steps after
    the first (which pays first-use costs) as a median and a range.  Checks: the probe passes,
    kernel J launches under int8 and int8_rs (never under f32), kernels
    A-D under all three, the first SSLResNet50 sync is bit-equal on both
    ranks and within the int8 bound of the f32 all-reduce."""
    from active_learning_tpu_torch.parallel import mesh as pm

    log(f"phase 18: 2 ranks sharing {device} over gloo, every collective "
        "host-staged through pinned memory (NCCL refuses two ranks on one "
        "card)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pm.launch_ranks(_dp_rank, 2, (root, n_train, n_test, device,
                                  model_name, num_classes, hw),
                    backend="gloo", join_timeout_s=900)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(root, f"dp_rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    j_names = ("int8_absmax", "int8_quantize", "int8_dequant_sum",
               "int8_sum_requantize")
    out = {"wall_s": wall, "mesh": [r["mesh"] for r in ranks], "modes": {}}
    launches = None
    for mode in DP_MODES:
        recs = [r[mode] for r in ranks]
        lsum = {k: sum(rc["launches"][k] for rc in recs)
                for k in recs[0]["launches"]}
        launches = lsum if launches is None else {
            k: launches[k] + v for k, v in lsum.items()}
        steps = recs[0]["step_s"]
        warm = 1e3 * np.asarray(steps[1:])
        form = {"f32": "f32", "int8": "allgather",
                "int8_rs": "reduce_scatter"}[mode]
        m = {"launches": lsum, "probe": recs[0]["probe"],
             "step_ms": [1e3 * s for s in steps],
             "step_ms_median": float(np.median(warm)),
             "step_ms_range": [float(warm.min()), float(warm.max())],
             "collective_ms_median": 1e3 * float(np.median(
                 recs[0]["coll_s"][1:])),
             "collectives_per_step": int(np.median(recs[0]["coll_n"])),
             "wire_model_bytes": pm.wire_model_bytes(
                 form, 2, recs[0]["grad_elements"]),
             "sync": [rc["sync"] for rc in recs],
             "grad_sync": recs[0]["grad_sync"], "form": recs[0]["form"],
             "wall_s": recs[0]["wall_s"], "test_acc": recs[0]["test_acc"]}
        out["modes"][mode] = m
        j_count = sum(lsum[k] for k in j_names)
        a_d = ("prob_stats", "bn_act", "bn_train_stats",
               "bn_train_bwd_reduce", "bn_train_chain", "bn_train_dx",
               "fused_sgd")
        log(f"dp {mode}: sync {m['grad_sync']} {m['form'] or ''}, probe "
            f"{m['probe']}, {len(steps)} train steps, median of the "
            f"last {len(warm)} {m['step_ms_median']:.1f} ms (range "
            f"{m['step_ms_range']}; all {m['step_ms']}), of it "
            f"{m['collective_ms_median']:.1f} ms in "
            f"{m['collectives_per_step']} collectives (wire model "
            f"{m['wire_model_bytes']:,} B a rank), kernel J "
            f"launches {j_count} {json.dumps({k: lsum[k] for k in j_names})}"
            f", A-D {json.dumps({k: lsum[k] for k in a_d})}, first sync "
            f"{m['sync']}, wall {m['wall_s']:.1f} s, test acc "
            f"{m['test_acc']}")
        want = "torch.bfloat16" if device.startswith("cuda") \
            else "torch.float32"
        if len(steps) != 8 or any(rc["labeled"] != DP_BUDGET
                                  or rc["dtype"] != want for rc in recs):
            raise AssertionError(f"dp {mode}: {recs}")
        if not all(s["bit_equal_across_ranks"] for s in m["sync"]):
            raise AssertionError(f"dp {mode}: synced gradients differ "
                                 "across ranks")
        for k in a_d:
            if lsum[k] < 1:
                raise AssertionError(f"dp {mode} never launched {k}")
        if mode == "f32":
            if j_count or m["grad_sync"] != "f32":
                raise AssertionError(f"dp f32 launched kernel J {j_count}")
            continue
        ok, delta = m["probe"]
        if not ok or m["grad_sync"] != "int8":
            raise AssertionError(f"dp {mode}: the probe failed ({delta})")
        need = j_names[:3] + (("int8_sum_requantize",)
                              if mode == "int8_rs" else ())
        if any(lsum[k] < 1 for k in need):
            raise AssertionError(f"dp {mode}: kernel J did not launch")
        worst = max(s["err_over_bound"] for s in m["sync"])
        if not worst <= 1.0:
            raise AssertionError(f"dp {mode}: int8 error {worst} of its "
                                 "bound")
    out["launches"] = launches
    log(f"phase 18 done in {wall:.1f} s")
    return out


# -- phase 19: one NCCL rank on the card ---------------------------------------

def check_nccl_world1(dev):
    """19: ``init_process_group("nccl", world_size=1)``; the mesh's
    all_reduce (sum, max), all_gather and all_to_all with int8 payloads
    and broadcast run through NCCL; ``int8_allreduce`` and
    ``int8_reduce_scatter`` called directly at N = 1 equal their plain
    versions."""
    import torch.distributed as dist

    from active_learning_tpu_torch.parallel import mesh as pm

    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{pm._free_port()}", world_size=1, rank=0)
    try:
        mesh = pm.make_mesh(-1, "cuda")
        q = (torch.arange(4096, device=dev) % 255 - 127).to(torch.int8)
        x = torch.randn(10000, device=dev)
        checks = {
            "all_gather_int8": torch.equal(mesh.all_gather(q)[0], q),
            "all_to_all_int8": torch.equal(mesh.all_to_all(q.clone()), q),
            "all_reduce_sum": torch.equal(mesh.all_reduce(x.clone()), x),
            "all_reduce_max": torch.equal(mesh.all_reduce(x.clone(), "max"),
                                          x),
            "broadcast": torch.equal(mesh.broadcast(q.clone()), q)}
        leaves = [torch.randn(s, device=dev) * 1e-2
                  for s in ((64, 3, 7, 7), (64,), (257,), (2048, 1000))]
        for form, fn in (("allgather", pm.int8_allreduce),
                         ("reduce_scatter", pm.int8_reduce_scatter)):
            got = fn(leaves, mesh)
            want = fn([t.cpu() for t in leaves], pm.single_rank("cpu"))
            checks[f"int8_{form}_n1"] = all(
                torch.equal(a.cpu(), b) for a, b in zip(got, want))
        torch.cuda.synchronize()
        desc = mesh.describe()
    finally:
        dist.destroy_process_group()
    log(f"phase 19: {desc}: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"NCCL world-1 checks failed: {checks}")
    return {"mesh": desc, "checks": checks}


# -- phase 20: the CIFAR-10 fine-tuning sweep ---------------------------------

CIFAR_ROWS = (50000, 10000)   # the canonical archive's train and test rows
IMB_TRAIN_ROWS = 20431        # exp, factor 0.1 of 50,000


def simclr_keys():
    """(torchvision key, port key) of a SimCLR CIFAR ResNet-18 checkpoint
    (``encoder.*`` as torchvision names it, and the ``linear.*`` head its
    arg pool skips), written out here rather than from the port's
    mapping; None where the port has no tensor."""
    leaves = (("weight", "scale"), ("bias", "bias"),
              ("running_mean", "mean"), ("running_var", "var"))

    def bn(t, p):
        return [(f"{t}.{a}", f"{p}.{b}") for a, b in leaves] + [
            (f"{t}.num_batches_tracked", None)]

    pairs = [("encoder.conv1.weight", "encoder.conv_stem.weight")]
    pairs += bn("encoder.bn1", "encoder.bn_stem")
    for i in range(4):
        for j in range(2):
            t = f"encoder.layer{i + 1}.{j}"
            p = f"encoder.stage{i + 1}_block{j}"
            pairs += [(f"{t}.conv1.weight", f"{p}.Conv_0.weight")]
            pairs += bn(f"{t}.bn1", f"{p}.BatchNorm_0")
            pairs += [(f"{t}.conv2.weight", f"{p}.Conv_1.weight")]
            pairs += bn(f"{t}.bn2", f"{p}.BatchNorm_1")
            if i > 0 and j == 0:
                pairs += [(f"{t}.downsample.0.weight",
                           f"{p}.downsample_conv.weight")]
                pairs += bn(f"{t}.downsample.1", f"{p}.downsample_bn")
    return pairs + [("linear.weight", None), ("linear.bias", None)]


def write_simclr_checkpoint(path: str, seed: int = SEED) -> dict:
    """A SimCLR-layout CIFAR ResNet-18 state dict from a numpy seed,
    saved with ``torch.save``: He-normal convolutions, BatchNorm scales
    and running variances near 1, biases and running means near 0.
    Returns {port key: tensor} of what the overlay must load."""
    from active_learning_tpu_torch.models.factory import get_network

    shapes = {k: tuple(v.shape) for k, v in get_network(
        "cifar10", "SSLResNet18", device="cpu").state_dict().items()}
    shapes.update({"linear.weight": (10, 512), "linear.bias": (10,)})
    rng = np.random.default_rng(seed)
    state, want = {}, {}
    for tkey, pkey in simclr_keys():
        leaf = tkey.rsplit(".", 1)[1]
        if leaf == "num_batches_tracked":
            state[tkey] = torch.tensor(1000)
            continue
        shape = shapes[pkey or tkey]
        if len(shape) == 4:
            v = rng.normal(0, np.sqrt(2.0 / (shape[0] * shape[2]
                                             * shape[3])), shape)
        elif len(shape) == 2:
            v = rng.normal(0, 0.05, shape)
        elif leaf in ("weight", "running_var"):
            v = rng.uniform(0.8, 1.2, shape)
        else:
            v = rng.normal(0, 0.05, shape)
        state[tkey] = torch.from_numpy(v.astype(np.float32))
        if pkey is not None:
            want[pkey] = state[tkey]
    torch.save(state, path)
    return want


def _bn_backward_terms(g, x, y, shift):
    dz = (g if y is None else torch.where(y > 0, g, torch.zeros_like(g))
          ).float()
    return dz, dz * (x.float() - shift.view(1, -1, 1, 1))


def _param_grads(coeff_fn, d_mul, d_add):
    """d scale and d bias from the sums, by autograd's chain through
    ``bn_coefficients`` (what the model runs)."""
    scale, bias, (_, mul, add) = coeff_fn()
    return torch.autograd.grad((mul, add), (scale, bias), (d_mul, d_add))


def hold_bn_act_backward(g, x, y, params, fused, residual, where, detail,
                         path):
    """Kernel B′ against its plain version on one input: dx and
    d_residual bit for bit; the sums Σdz and Σdz·(x − shift) within
    1e-5 of the sum of their terms' magnitudes of the plain version's
    (as kernel C's sums are held) and within ``backward_chain_length``
    units of 2⁻²⁴ of it of the float64 sum of the same float32 terms;
    d scale and d bias, through autograd's chain from each side's sums,
    within that bound carried by the chain's partial derivatives (r·(tol
    of Σdz·(x − shift) + |mean|·tol of Σdz) and tol of Σdz) plus 3 units
    of the type the chain rounds the sums to (bf16 in the fused bf16
    formula, float32 otherwise) of |Σdz·(x − shift)| + |mean·Σdz|.  Two
    launches bit-equal.  Returns the largest ratio to a bound and the
    largest absolute difference of the sums (dx and d_residual have
    none)."""
    from active_learning_tpu_torch.ops import bn_act as ba

    scale, bias, mean, var = params
    dtype = x.dtype

    def coeff_fn():
        s_, b_ = (t.detach().clone().requires_grad_(True)
                  for t in (scale, bias))
        return s_, b_, ba.bn_coefficients(s_, b_, mean, var, 1e-5, dtype,
                                          fused)

    _, _, (shift, mul, _) = coeff_fn()
    shift, mul = shift.detach(), mul.detach()
    got = ba.bn_act_backward(g, x, y, shift, mul, residual)
    again = ba.bn_act_backward(g, x, y, shift, mul, residual)
    ref = ba.bn_act_backward_reference(g, x, y, shift, mul, residual)
    torch.cuda.synchronize()
    if not torch.equal(got[0].view(torch.int16 if dtype == torch.bfloat16
                                   else torch.int32),
                       ref[0].view(torch.int16 if dtype == torch.bfloat16
                                   else torch.int32)):
        raise AssertionError(f"bn_act_backward dx {where}: not bit-equal")
    if residual and not torch.equal(got[1], ref[1]):
        raise AssertionError(f"bn_act_backward d_residual {where}")
    for a, b in zip(got, again):
        if a is not None and not torch.equal(a, b):
            raise AssertionError(f"bn_act_backward {where}: two launches "
                                 "differ")
    b_, c, h, w = x.shape
    chain = ba.backward_chain_length(b_ * h * w, c, dtype)
    worst, tols, max_abs = 0.0, [], 0.0
    for k, t in zip((3, 2), _bn_backward_terms(g, x, y, shift)):
        mag = t.abs().sum((0, 2, 3))
        tol = 1e-5 * mag
        max_abs = max(max_abs, (got[k] - ref[k]).abs().max().item())
        ratio = ((got[k] - ref[k]).abs() / (tol + 1e-30)).max().item()
        truth = ((got[k].double() - t.double().sum((0, 2, 3))).abs()
                 / (chain * 2.0 ** -24 * mag.double() + 1e-30)).max().item()
        if ratio > 1.0 or truth > 1.0:
            raise AssertionError(f"bn_act_backward sums {where}: "
                                 f"{ratio:.3g} of 1e-5, {truth:.3g} of the "
                                 f"chain bound ({chain})")
        worst = max(worst, ratio, truth)
        tols.append(tol)
    dsc, dbi = _param_grads(coeff_fn, got[2], got[3])
    rsc, rbi = _param_grads(coeff_fn, ref[2], ref[3])
    r = torch.rsqrt(var + 1e-5)
    m = mean.abs() if fused else 0.0
    unit = 2.0 ** -8 if fused and dtype == torch.bfloat16 else 2.0 ** -24
    vals = ref[2].abs() + m * ref[3].abs()
    b_scale = r * (tols[1] + m * tols[0] + 3 * unit * vals) + 1e-30
    b_bias = tols[0] + 3 * unit * ref[3].abs() + 1e-30
    ratio = max(((dsc - rsc).abs() / b_scale).max().item(),
                ((dbi - rbi).abs() / b_bias).max().item())
    if ratio > 1.0:
        raise AssertionError(f"bn_act_backward d scale / d bias {where}: "
                             f"{ratio:.3g} of the bound")
    worst = max(worst, ratio)
    detail.append({"kernel": "bn_act_backward", "path": path,
                   "shape": list(x.shape), "dtype": str(dtype),
                   "residual": residual, "relu": y is not None,
                   "chain_length": chain, "worst_ratio": worst,
                   "max_abs_err": max_abs})
    return worst, max_abs


def check_bn_act_backward(dev, calls, detail, path="cifar_finetune"):
    """Kernel B′ at every BatchNorm call (shape, residual, ReLU) of the
    path's forward, in bf16 (the fused formula, as the model runs it)
    and f32 (flax's): ``hold_bn_act_backward``."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    worst = max_abs = 0.0
    for shape, has_res, relu in sorted(set(calls)):
        c = shape[1]
        params = (torch.rand(c, device=dev, generator=gen) + 0.5,
                  torch.randn(c, device=dev, generator=gen) * 0.1,
                  torch.randn(c, device=dev, generator=gen) * 0.1,
                  torch.rand(c, device=dev, generator=gen) + 0.5)
        x32 = torch.randn(shape, device=dev, generator=gen) * 2 + 0.5
        g32 = torch.randn(shape, device=dev, generator=gen)
        y32 = torch.relu(torch.randn(shape, device=dev, generator=gen))
        for dtype, fused in ((torch.bfloat16, True), (torch.float32, False)):
            x, g, y = (t.to(dtype).contiguous(
                memory_format=torch.channels_last) for t in (x32, g32, y32))
            ratio, err = hold_bn_act_backward(
                g, x, y if relu else None, params, fused, has_res,
                f"{shape} {dtype} res={has_res} relu={relu}", detail, path)
            worst, max_abs = max(worst, ratio), max(max_abs, err)
        del x32, g32, y32
    torch.cuda.empty_cache()
    return worst, max_abs


def bn_eval_bwd_bytes(shape, has_res, relu, elem=BF16_BYTES):
    """The bytes kernel B′ must move for one BatchNorm: read g, x and
    (with a ReLU) y, write dx and (with a residual behind the ReLU) the
    residual's gradient; read shift and mul, write the two [C] sums."""
    act = shape[0] * shape[1] * shape[2] * shape[3] * elem
    return act * (3 + relu + (has_res and relu)) + 4 * shape[1] * 4


def time_bn_act_backward(dev, calls, detail):
    """Over the 20 BatchNorm calls of one bf16 SSLResNet18 fine-tuning
    step at B = 128 (CIFAR rows), each with its residual and ReLU: kernel
    B′'s time (CUDA events), its device time (profiler), its host time a
    call, its plain version, its bytes bound, and the library reference
    ``aten.native_batch_norm_backward(train=False)`` on the masked
    gradient (it leaves out the mask and the residual's gradient, and
    runs PyTorch's own eval formula)."""
    from active_learning_tpu_torch.ops import bn_act as ba

    per = {}
    for key in sorted(set(calls)):
        shape, has_res, relu = key
        x, g, _ = _kernel_c_inputs(shape, torch.bfloat16, dev, 9)
        c = shape[1]
        y = (torch.relu(x.float() - 1.0).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last) if relu else None)
        scale = torch.rand(c, device=dev) + 0.5
        rm, rv = torch.randn(c, device=dev) * 0.1, torch.rand(c, device=dev)
        shift, mul, _ = ba.bn_coefficients(scale, torch.zeros_like(scale),
                                           rm, rv + 0.5, 1e-5,
                                           torch.bfloat16, True)
        gm = g if y is None else torch.where(y > 0, g, torch.zeros_like(g))

        def kernel():
            ba.bn_act_backward(g, x, y, shift, mul, has_res)

        def plain():
            ba.bn_act_backward_reference(g, x, y, shift, mul, has_res)

        invstd = torch.rsqrt(rv + 0.5 + 1e-5)

        def library():
            # The CUDA op asserts saved statistics even in eval mode.
            torch.ops.aten.native_batch_norm_backward(
                gm, x, scale, rm, rv + 0.5, rm, invstd, False, 1e-5,
                [True, True, True])

        nbytes = bn_eval_bwd_bytes(shape, has_res, relu)
        kernel()
        torch.cuda.synchronize()
        # One whole profiler session gives the device time and the
        # kernels a call.
        events, _ = _complete_events(kernel, 10)
        per[key] = {"ms": cuda_ms(kernel, reps=20),
                    "device_ms": sum(us for _, us in events.values())
                    / 1e3 / 10,
                    "kernels_a_call": sum(c for c, _ in events.values())
                    // 10,
                    "host_us": host_us(kernel, reps=50),
                    "plain_ms": cuda_ms(plain, reps=5),
                    "library_ms": cuda_ms(library, reps=20),
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        detail.append({"kernel": "bn_act_backward", "timed_shape":
                       list(shape), "residual": has_res, "relu": relu,
                       "calls_per_step": calls.count(key), **per[key]})
        del x, g, y, gm
        torch.cuda.empty_cache()
    tot = {k: sum(per[c][k] for c in calls)
           for k in ("ms", "device_ms", "plain_ms", "library_ms",
                     "bound_ms")}
    host = float(np.mean([per[c]["host_us"] for c in calls]))
    kernels = max(v["kernels_a_call"] for v in per.values())
    log(f"kernel B' per B=128 fine-tuning step ({len(calls)} calls): "
        f"{tot['ms']:.4f} ms (device {tot['device_ms']:.4f} ms by the "
        f"profiler, host {host:.2f} us a call, {kernels} kernels a call); "
        f"plain {tot['plain_ms']:.4f}, native_batch_norm_backward "
        f"{tot['library_ms']:.4f}, bound {tot['bound_ms']:.4f}")
    return {**tot, "bound_by": "bytes", "host_us_a_call": host,
            "kernels_a_call": kernels}


def check_cache_repair(dev, data, runs, n_labeled=1000, epochs=2):
    """The caches the models keep of their weights (a Conv's
    compute-dtype weight, a BatchNorm's eval coefficients) must follow
    kernels D's and C's in-place writes.  For each ``runs`` entry (name
    -> TrainConfig), ``Trainer.fit`` of a seeded SSLResNet18 for
    ``epochs`` epochs on ``n_labeled`` rows of ``data`` (a 10-class
    triple) with validation: a configured checkpoint fine-tunes with
    BatchNorm in eval mode (D writes the weights), none trains from
    scratch with BatchNorm in training mode (D, and C the running
    statistics).  At every validation and after the fit, the cached
    model's logits on the first validation batch and its
    ``Trainer.evaluate`` counts must equal those of a model freshly
    loaded with ``trainer.variables()``.  Returns each run's validation
    accuracies, cached and fresh."""
    from active_learning_tpu_torch.data.augment import apply_view
    from active_learning_tpu_torch.initial_pool import generate_eval_idxs
    from active_learning_tpu_torch.models.factory import get_network
    from active_learning_tpu_torch.models.resnet import init_weights
    from active_learning_tpu_torch.train.trainer import Trainer

    train_set, _, al_set = data
    targets = train_set.targets[:len(train_set)]
    eval_idxs = generate_eval_idxs(targets, 10, ratio=0.1, random_seed=99)
    rest = np.setdiff1d(np.arange(len(train_set)), eval_idxs)
    labeled = np.random.default_rng(SEED).choice(rest, n_labeled,
                                                 replace=False)
    probe = torch.from_numpy(al_set.gather(eval_idxs[:256])).to(dev)
    out = {}
    for name, cfg in runs.items():
        model = get_network("cifar10", "SSLResNet18", device=dev)
        init_weights(model, torch.Generator().manual_seed(SEED))
        if cfg.has_pretrained:
            from active_learning_tpu_torch.utils.pretrained import \
                apply_pretrained
            apply_pretrained(model, cfg.pretrained)
        trainer = Trainer(model, cfg, 10, dev)
        readings = []
        cached_eval = trainer.evaluate

        def evaluate(dataset, idxs, trainer=trainer, cfg=cfg, name=name,
                     cached_eval=cached_eval, readings=readings):
            got = cached_eval(dataset, idxs)
            fresh = get_network("cifar10", "SSLResNet18", device=dev)
            fresh.load_state_dict(trainer.variables())
            want = Trainer(fresh, cfg, 10, dev).evaluate(dataset, idxs)
            readings.append((float(got["accuracy"]),
                             float(want["accuracy"])))
            with torch.inference_mode():
                x = apply_view(probe, al_set.view, train=False)
                same = torch.equal(trainer.model.eval()(x), fresh.eval()(x))
            trainer.model.train(trainer.train_bn)
            differ = [k for k in want if not np.array_equal(
                np.asarray(got[k]), np.asarray(want[k]))]
            if differ or not same:
                raise AssertionError(
                    f"{name} fit, evaluation {len(readings)}: the cached "
                    f"model's logits equal a freshly loaded model's: "
                    f"{same}; counts that differ: {differ}; validation "
                    f"accuracy (cached, fresh) so far: {readings}")
            return got

        trainer.evaluate = evaluate
        trainer.fit(train_set, labeled, al_set, eval_idxs, n_epoch=epochs,
                    es_patience=50, rng=np.random.default_rng(SEED))
        evaluate(al_set, eval_idxs)
        out[name] = {"train_bn": trainer.train_bn,
                     "val_accuracy_cached_fresh": readings}
    log(f"cache repair: validation accuracy (cached, fresh) by epoch and "
        f"after the fit: {out}")
    return out


def run_cifar_finetune(root: str, dev, rows=CIFAR_ROWS, cli_extra=()):
    """Phase 20: the first imbalanced-CIFAR BASESampler job of the port's
    ``gen_jobs`` through ``python -m active_learning_tpu_torch`` on the
    card, cut to 2 epochs and 2 rounds, on a full-size facsimile archive
    (50,000 + 10,000 rows, fetched through ``fetch_cifar10`` with its md5)
    and a seeded SimCLR-layout checkpoint under ``--pretrained_root``."""
    from active_learning_tpu_torch.data import get_data
    from active_learning_tpu_torch.data.cifar10 import fetch_cifar10
    from active_learning_tpu_torch.data.facsimile import \
        write_cifar10_facsimile
    from active_learning_tpu_torch.experiment import gen_jobs
    from active_learning_tpu_torch.experiment.arg_pools import \
        get_train_config
    from active_learning_tpu_torch.experiment.cli import parse
    from active_learning_tpu_torch.models.factory import get_network
    from active_learning_tpu_torch.models.resnet import init_weights
    from active_learning_tpu_torch.utils.pretrained import apply_pretrained

    res = {}
    t0 = time.perf_counter()
    path, md5 = write_cifar10_facsimile(
        os.path.join(root, "arch", "cifar-10-python.tar.gz"),
        n_train=rows[0], n_test=rows[1], seed=SEED)
    res["facsimile_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    data_dir = os.path.join(root, "data")
    fetch_cifar10(data_dir, url=f"file://{path}", expected_md5=md5)
    res["fetch_s"] = time.perf_counter() - t0
    pre = os.path.join(root, "pre")
    ckpt = os.path.join(pre, "pretrained_ckpt", "cifar10",
                        "simclr_imb_pretrain0_1.tar")
    os.makedirs(os.path.dirname(ckpt))
    want = write_simclr_checkpoint(ckpt)

    job = next(a for a in gen_jobs.cifar10_args(data_dir, imbalanced=True)
               if a["strategy"] == "BASESampler")
    job = dict(job, n_epoch=2, rounds=2)
    argv = gen_jobs.run_argv(job) + [
        "--pretrained_root", pre, "--exp_hash", "cifar",
        "--log_dir", os.path.join(root, "logs"),
        "--ckpt_path", os.path.join(root, "ckpt"), *cli_extra]
    cfg = parse(argv)
    res["command"] = " ".join([gen_jobs.CLI] + argv)
    data = get_data(cfg.dataset, data_path=data_dir,
                    imbalance_args=cfg.imbalance)
    n_pool = len(data[0])
    if rows == CIFAR_ROWS and n_pool != IMB_TRAIN_ROWS:
        raise AssertionError(f"the imbalanced train set has {n_pool} rows")

    # The loaded encoder equals the checkpoint.
    train_cfg = get_train_config(cfg.arg_pool, cfg.dataset,
                                 cfg.pretrained_root)
    model = get_network(cfg.dataset, cfg.model, device=dev)
    init_weights(model, torch.Generator().manual_seed(SEED))
    head = model.linear.weight.detach().clone()
    loaded = apply_pretrained(model, train_cfg.pretrained)
    state = model.state_dict()
    bad = [k for k, v in want.items() if not torch.equal(state[k].cpu(), v)]
    if bad or loaded != len(want) or not torch.equal(model.linear.weight,
                                                     head):
        raise AssertionError(f"overlay: {loaded} of {len(want)} loaded, "
                             f"differing {bad[:5]}")
    res["overlaid"] = loaded

    # Kernel B' at every BatchNorm call of the B=128 forward.
    calls = bn_calls_of_forward(model, torch.zeros(128, 32, 32, 3,
                                                   device=dev))
    detail = []
    res["bn_bwd_worst_ratio"], res["bn_bwd_max_abs_err"] = \
        check_bn_act_backward(dev, calls, detail)
    res["bn_bwd_checks"] = len(detail)
    res["bn_bwd_times"] = time_bn_act_backward(dev, calls, detail)
    res["calls"] = calls
    del model
    torch.cuda.empty_cache()

    # The job through the CLI, in its own process (its launch counts
    # start at 0 there and are logged when it finishes).
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "active_learning_tpu_torch",
                          *argv], cwd=os.path.dirname(
                              os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=900)
    res["cli_wall_s"] = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"CIFAR CLI exited {run.returncode}:\n"
                             f"{run.stderr[-4000:]}")
    err = run.stderr
    line = [ln for ln in err.splitlines() if "Kernel launches: " in ln][-1]
    launches = json.loads(line.split("Kernel launches: ", 1)[1])
    res["launches"] = launches
    for k in ("bn_act", "bn_act_bwd", "fused_sgd", "boundary_radii"):
        if launches[k] < 1:
            raise AssertionError(f"CIFAR path never launched {k}: "
                                 f"{launches}")
    c_names = ("bn_train_stats", "bn_train_bwd_reduce", "bn_train_chain",
               "bn_train_dx")
    if any(launches[k] for k in c_names):
        raise AssertionError(f"kernel C ran with BatchNorm in eval mode: "
                             f"{launches}")
    if err.count(f"Overlaid {len(want)} pretrained tensors") != 2:
        raise AssertionError("the checkpoint was not overlaid each round")
    exp_dir = os.path.join(root, "ckpt", f"{cfg.exp_name}_cifar")
    with np.load(os.path.join(exp_dir, "experiment_state.npz")) as st:
        if int(st["n_pool"]) != n_pool:
            raise AssertionError(f"pool of {int(st['n_pool'])} rows")
        res["labeled"] = int(st["labeled"].sum())
        want_labeled = min(2 * job["round_budget"],
                           n_pool - len(st["eval_idxs"]))
    tested, vals = {}, {}
    with open(os.path.join(root, "logs", "metrics.jsonl")) as fh:
        for ln in fh:
            e = json.loads(ln)
            if e["kind"] != "metric":
                continue
            for k, v in e["metrics"].items():
                if k == "rd_test_accuracy":
                    tested[e["step"]] = v
                elif k.endswith("_validation_accuracy"):
                    vals.setdefault(k, []).append(v)
    if set(tested) != {0, 1} or res["labeled"] != want_labeled or any(
            len(v) != 2 for v in vals.values()) or len(vals) != 2:
        raise AssertionError(f"rounds tested {tested}, validation {vals}, "
                             f"labeled {res['labeled']}")
    if not all(np.isfinite(v) for v in tested.values()):
        raise AssertionError(f"test accuracy {tested}")
    res["test_accuracy"] = tested
    res["validation_accuracy"] = vals
    res["phase_times"] = [ln for ln in err.splitlines() if "_time is " in ln]
    log(f"CIFAR fine-tuning CLI on the card: {res['cli_wall_s']:.1f} s, "
        f"launches {launches}; test accuracy {tested}; phases "
        f"{res['phase_times']}")

    # The first fine-tuning step, card against CPU in float32.
    res["f32_step"] = check_train_step_f32_against_cpu(pretrained=ckpt)
    # The caches follow kernels D and C's writes.
    res["cache_repair"] = check_cache_repair(dev, data, {
        "finetune": train_cfg,
        "scratch": get_train_config("default", cfg.dataset)})
    # Phase 21 reuses the archive's rows and the checkpoint.
    res["inputs"] = {"pretrained_root": pre, "job": job}
    return res, detail


# -- phase 21: resume and faults on the card -----------------------------------

class _Interrupt(Exception):
    """Stands in for a crash in the middle of a fit."""


def _same_tensors(got: dict, want: dict, what: str) -> None:
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: keys differ")
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} tensors differ, first "
                             f"{bad[:5]}")


def _fit_state_of(trainer) -> dict:
    out = {k: v.detach().clone() for k, v in
           trainer.model.state_dict().items()}
    for i, t in enumerate(trainer.optimizer.trace or []):
        out[f"trace.{i}"] = t.detach().clone()
    return out


def run_fit_resume(dev, root: str, n_epoch: int = 6, every: int = 2):
    """21.1: ``Trainer.fit`` at path a's width (SSLResNet50, 1000
    classes, 224x224x3, bf16, B = 128, BatchNorm in training mode), 512
    train and 128 validation rows, the fit state every ``every`` epochs:
    unbroken; then interrupted in the process after epoch 4's save;
    then resumed.  The resumed fit's parameters, BatchNorm buffers,
    momentum, best epoch, best accuracy and history from epoch 5 on
    equal the unbroken fit's bit for bit, and kernels B, C and D launch
    in it.  Also times a fit-state save and reads its size."""
    from active_learning_tpu_torch import ops
    from active_learning_tpu_torch.data.synthetic import get_data_synthetic
    from active_learning_tpu_torch.experiment.arg_pools import \
        get_train_config
    from active_learning_tpu_torch.models.factory import get_network
    from active_learning_tpu_torch.models.resnet import init_weights
    from active_learning_tpu_torch.train import checkpoint as ckpt_lib
    from active_learning_tpu_torch.train.trainer import Trainer

    train_set, test_set, _ = get_data_synthetic(
        n_train=512, n_test=128, num_classes=1000, image_size=224,
        seed=SEED)
    cfg = dataclasses.replace(get_train_config("default", "imagenet"),
                              current_ckpt_every=every)
    saves = []
    real_save = ckpt_lib.save_fit_state

    def timed_save(path, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_save(path, **kw)
        saves.append((time.perf_counter() - t0,
                      os.path.getsize(path + ".msgpack")
                      + os.path.getsize(path + ".json")))

    def fit(tag, interrupt_at=None):
        model = get_network("imagenet", "SSLResNet50", num_classes=1000,
                            device=dev)
        init_weights(model, torch.Generator().manual_seed(SEED))
        trainer = Trainer(model, cfg, 1000, dev)
        paths = ckpt_lib.weight_paths(root, "fit", tag, round_idx=0)

        def cb(name, value, step):
            if step == interrupt_at and name.endswith("validation_accuracy"):
                raise _Interrupt()

        t0 = time.perf_counter()
        result = trainer.fit(train_set, np.arange(len(train_set)), test_set,
                             np.arange(len(test_set)), n_epoch=n_epoch,
                             es_patience=n_epoch,
                             rng=np.random.default_rng(SEED), round_idx=0,
                             weight_paths=paths, metric_cb=cb)
        torch.cuda.synchronize()
        return result, trainer, paths, time.perf_counter() - t0

    ckpt_lib.save_fit_state = timed_save
    try:
        ref, ref_tr, _, ref_s = fit("unbroken")
        want = _fit_state_of(ref_tr)
        del ref_tr
        torch.cuda.empty_cache()
        try:
            fit("resumed", interrupt_at=5)
            raise AssertionError("the interrupted fit ran to its end")
        except _Interrupt:
            pass
        torch.cuda.empty_cache()
        paths = ckpt_lib.weight_paths(root, "fit", "resumed", round_idx=0)
        saved = ckpt_lib.load_fit_state(paths["fit_state"], 0)
        if saved is None or saved["epoch"] != 4:
            raise AssertionError("no epoch-4 fit state after the interrupt")
        del saved
        ops.reset_kernel_launches()
        got, got_tr, _, got_s = fit("resumed")
        launches = ops.kernel_launches()
    finally:
        ckpt_lib.save_fit_state = real_save
    _same_tensors(_fit_state_of(got_tr), want, "resumed fit")
    del got_tr, want
    torch.cuda.empty_cache()
    if (got.history[0]["epoch"] != 5 or got.history != ref.history[4:]
            or got.best_epoch != ref.best_epoch
            or got.best_perf != ref.best_perf
            or got.epochs_run != ref.epochs_run):
        raise AssertionError(f"resumed history {got.history} / best "
                             f"{got.best_epoch} {got.best_perf} against "
                             f"{ref.history[4:]} / {ref.best_epoch} "
                             f"{ref.best_perf}")
    for k in ("bn_act", "bn_train_stats", "bn_train_bwd_reduce",
              "bn_train_dx", "fused_sgd"):
        if launches[k] < 1:
            raise AssertionError(f"the resumed fit never launched {k}: "
                                 f"{launches}")
    out = {"unbroken_s": ref_s, "resumed_s": got_s,
           "best_epoch": ref.best_epoch, "launches": launches,
           "fit_state_save_s": [t for t, _ in saves],
           "fit_state_bytes": saves[0][1] if saves else None}
    log(f"21.1 fit resume at path a's width: bit-identical from epoch 5 "
        f"(best epoch {ref.best_epoch}); unbroken {ref_s:.1f} s, resumed "
        f"{got_s:.1f} s; fit-state saves {out['fit_state_save_s']} s of "
        f"{out['fit_state_bytes']} bytes; launches {launches}")
    return out


def _journal(log_dir: str) -> dict:
    try:
        with open(os.path.join(log_dir, "round_journal.json")) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def _cli_launches(stderr: str) -> dict:
    line = [ln for ln in stderr.splitlines() if "Kernel launches: " in ln][-1]
    return json.loads(line.split("Kernel launches: ", 1)[1])


def run_cifar_preempt(root: str, inputs: dict, n_epoch: int = 4,
                      rounds: int = 2):
    """21.2: phase 20's CIFAR job (SSLResNet18 from the seeded SimCLR
    checkpoint, BatchNorm in eval mode, the same 20,431 facsimile rows)
    cut to ``rounds`` rounds of ``n_epoch`` epochs through ``python -m
    active_learning_tpu_torch``: once unbroken; once as a child that
    takes a real SIGTERM in round 1's fit (every train step stretched by
    ``dispatch:delay@0.05`` to widen the window), which must exit 0 with
    the journal saying preempted; once with ``--resume_training``.  The
    resumed run's ``experiment_state.npz`` (every key) and
    ``best_rd_1.msgpack`` equal the unbroken run's bit for bit, and
    kernels B, B′ and D launch in the resumed process."""
    from active_learning_tpu_torch.experiment import gen_jobs

    repo = os.path.dirname(os.path.abspath(__file__))
    job = dict(inputs["job"], n_epoch=n_epoch, rounds=rounds)

    def argv(tag):
        return [sys.executable, "-m", "active_learning_tpu_torch",
                *gen_jobs.run_argv(job), "--pretrained_root",
                inputs["pretrained_root"], "--exp_hash", "resume",
                "--log_dir", os.path.join(root, tag, "logs"),
                "--ckpt_path", os.path.join(root, tag, "ckpt")]

    def finish(proc, what):
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"{what} exited {proc.returncode}:\n"
                                 f"{err[-4000:]}")
        return err

    res = {}
    t0 = time.perf_counter()
    finish(subprocess.Popen(argv("unbroken"), cwd=repo, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE),
           "the unbroken CIFAR run")
    res["unbroken_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    logs = os.path.join(root, "killed", "logs")
    proc = subprocess.Popen(argv("killed") + ["--fault_spec",
                                              "dispatch:delay@0.05"],
                            cwd=repo, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise AssertionError("the CIFAR child ended before the "
                                     "signal:\n" + proc.communicate()[1][-4000:])
            jr = _journal(logs)
            if jr.get("round") == 1 and jr.get("phase") == "init":
                break
            time.sleep(0.02)
        else:
            raise AssertionError("the CIFAR child never reached round 1's "
                                 "fit")
        time.sleep(0.5)  # into the fit
        proc.send_signal(signal.SIGTERM)
        err = finish(proc, "the SIGTERM'd CIFAR run")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    res["killed_s"] = time.perf_counter() - t0
    jr = _journal(logs)
    if jr.get("status") != "preempted" or jr.get("round") != 1 or \
            jr.get("signal") != int(signal.SIGTERM):
        raise AssertionError(f"journal after SIGTERM: {jr}")
    res["preempted_at"] = [ln for ln in err.splitlines()
                           if "Validation performance on round 1" in ln]

    t0 = time.perf_counter()
    err = finish(subprocess.Popen(argv("killed") + ["--resume_training"],
                                  cwd=repo, text=True,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE),
                 "the resumed CIFAR run")
    res["resumed_s"] = time.perf_counter() - t0
    resumed_from = [ln.strip() for ln in err.splitlines()
                    if "Resuming round 1 training from epoch" in ln]
    if not resumed_from:
        raise AssertionError("the resumed run did not consume round 1's "
                             "fit state")
    res["resumed_from"] = resumed_from[0]
    launches = _cli_launches(err)
    res["launches"] = launches
    for k in ("bn_act", "bn_act_bwd", "fused_sgd"):
        if launches[k] < 1:
            raise AssertionError(f"the resumed CIFAR run never launched "
                                 f"{k}: {launches}")
    if _journal(logs).get("status") != "finished":
        raise AssertionError(f"journal after resume: {_journal(logs)}")
    dirs = {tag: os.path.join(root, tag, "ckpt",
                              f"{job['exp_name']}_resume")
            for tag in ("unbroken", "killed")}
    with np.load(os.path.join(dirs["unbroken"], "experiment_state.npz")) as a, \
            np.load(os.path.join(dirs["killed"],
                                 "experiment_state.npz")) as b:
        if sorted(a.files) != sorted(b.files) or any(
                not np.array_equal(a[k], b[k]) for k in a.files):
            raise AssertionError("experiment_state.npz differs after the "
                                 "SIGTERM resume")
        res["labeled"] = int(b["labeled"].sum())
    with open(os.path.join(dirs["unbroken"], "best_rd_1.msgpack"), "rb") as a, \
            open(os.path.join(dirs["killed"], "best_rd_1.msgpack"),
                 "rb") as b:
        if a.read() != b.read():
            raise AssertionError("best_rd_1.msgpack differs after the "
                                 "SIGTERM resume")
    log(f"21.2 CIFAR job SIGTERM'd in round 1 ({res['preempted_at']}), "
        f"resumed ({res['resumed_from']}): experiment_state.npz and "
        f"best_rd_1.msgpack bit-identical; unbroken {res['unbroken_s']:.1f}"
        f" s, killed {res['killed_s']:.1f} s, resumed "
        f"{res['resumed_s']:.1f} s; launches {launches}")
    return res


def run_torn_write(root: str, want: dict):
    """21.3: the synthetic CLI (phase 5's flags: SSLResNet18, BatchNorm
    in training mode) with ``--fault_spec ckpt_write:torn@1``: the torn
    publish is retried and the run completes (or, crashed, resumes
    fault-free) with ``experiment_state.npz`` equal to phase 5's unbroken
    run's."""
    try:
        run = _run_cli(os.path.join(root, "torn"),
                       ["--fault_spec", "ckpt_write:torn@1"])
        mode = "completed"
    except AssertionError:
        run = _run_cli(os.path.join(root, "torn"), ["--resume_training"])
        mode = "resumed"
    if "fault injection ARMED: ckpt_write:torn@1" not in run["stderr"] \
            and mode == "completed":
        raise AssertionError("the torn-write run was not armed")
    if mode == "completed" and "retry[ckpt_write]" not in run["stderr"]:
        raise AssertionError("the torn write never fired a retry")
    state = run["state"]
    if sorted(state) != sorted(want) or any(
            not np.array_equal(state[k], want[k]) for k in want):
        raise AssertionError("experiment_state.npz differs after the torn "
                             "write")
    log(f"21.3 torn write: {mode}, experiment_state.npz equals phase 5's; "
        f"{run['wall_s']:.1f} s")
    return {"mode": mode, "wall_s": run["wall_s"],
            "launches": run["launches"]}


_OOM_CHILD = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import chip_smoke as cs
from active_learning_tpu_torch.config import ExperimentConfig
from active_learning_tpu_torch.data.pipeline import gather_batch
from active_learning_tpu_torch.experiment.arg_pools import get_train_config
from active_learning_tpu_torch.experiment.driver import run_experiment
from active_learning_tpu_torch.models.factory import get_network
from active_learning_tpu_torch.train.trainer import Trainer

dev = torch.device("cuda", 0)
data = cs._facsimile_224({n_train}, 64, num_classes=1000)
cfg = get_train_config("default", "imagenet")
peaks = {{}}
model = get_network("imagenet", "SSLResNet50", num_classes=1000, device=dev)
trainer = Trainer(model, cfg, 1000, dev)
model.train()
weights = torch.ones(1000, device=dev)
gen = torch.Generator(device=dev).manual_seed(0)
for bs in (64, 128):
    batch = trainer.to_device(gather_batch(data[0], np.arange(bs), bs))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(batch, 0.1, weights, data[0].view, gen)
    torch.cuda.synchronize()
    peaks[bs] = (torch.cuda.max_memory_allocated(),
                 torch.cuda.max_memory_reserved())
    del batch
del model, trainer
torch.cuda.empty_cache()
total = torch.cuda.get_device_properties(0).total_memory
limit = (peaks[64][1] + peaks[128][1]) // 2
torch.cuda.set_per_process_memory_fraction(limit / total, 0)
print("OOM_SETUP " + json.dumps({{"peaks": peaks, "limit": limit,
                                  "total": total}}), flush=True)
run_experiment(ExperimentConfig(
    dataset="imagenet", model="SSLResNet50", arg_pool="default",
    strategy="MarginSampler", rounds=2, round_budget={budget},
    n_epoch=1, early_stop_patience=1, exp_hash="oom",
    log_dir={logs!r}, ckpt_path={ckpt!r}), data=data)
print("OOM_DONE", flush=True)
"""


def run_oom_ladder(root: str, n_train: int = 512, budget: int = 256):
    """21.4: a real CUDA OOM reaches ``batch_half``.  A child measures
    the peak device memory of one SSLResNet50 B = 64 and one B = 128
    train step (224 px, bf16, 1000 classes), caps its own process at
    the midpoint of the two (``torch.cuda.set_per_process_memory_fraction``),
    then runs ``run_experiment`` (MarginSampler, 2 rounds of ``budget``
    rows, 1 epoch each): each round's B = 128 step fails with
    ``torch.OutOfMemoryError``, the ladder halves the batch and the
    round completes; the next round starts at B = 128 again."""
    repo = os.path.dirname(os.path.abspath(__file__))
    logs, ckpt = os.path.join(root, "oom", "logs"), os.path.join(root, "oom",
                                                                  "ckpt")
    code = _OOM_CHILD.format(repo=repo, n_train=n_train, budget=budget,
                             logs=logs, ckpt=ckpt)
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if run.returncode != 0 or "OOM_DONE" not in run.stdout:
        raise AssertionError(f"the OOM child exited {run.returncode}:\n"
                             f"{run.stderr[-4000:]}")
    setup = json.loads([ln for ln in run.stdout.splitlines()
                        if ln.startswith("OOM_SETUP ")][0][10:])
    err = run.stderr
    engaged = err.count("engaging rung 'batch_half'")
    halved = err.count("train batch halved to 64")
    reverted = err.count("reverted ['batch_half'] at the round boundary")
    ooms = [ln for ln in err.splitlines() if "OutOfMemoryError" in ln]
    jr = _journal(logs)
    if engaged != 2 or halved != 2 or reverted != 1 or not ooms:
        raise AssertionError(f"batch_half engaged {engaged}, halved to 64 "
                             f"{halved}, reverted {reverted}, OOM lines "
                             f"{len(ooms)}:\n{err[-4000:]}")
    if jr.get("status") != "finished" or jr.get("degrade") != ["batch_half"]:
        raise AssertionError(f"journal after the OOM run: {jr}")
    with open(os.path.join(logs, "metrics.jsonl")) as fh:
        tested = {e["step"] for e in map(json.loads, fh)
                  if e["kind"] == "metric"
                  and "rd_test_accuracy" in e["metrics"]}
    if tested != {0, 1}:
        raise AssertionError(f"rounds tested after the OOM: {tested}")
    out = {"wall_s": wall, "peaks": setup["peaks"], "limit": setup["limit"],
           "total": setup["total"], "launches": _cli_launches(err),
           "oom_line": ooms[0][:300]}
    log(f"21.4 OOM: peaks (allocated, reserved) {setup['peaks']}, cap "
        f"{setup['limit']} of {setup['total']} bytes; batch_half engaged "
        f"in both rounds, reverted between them; {wall:.1f} s")
    return out


def run_resume_faults(root: str, dev, cifar_inputs: dict, cli_state: dict):
    """Phase 21: resume and faults on the card."""
    t0 = time.perf_counter()
    res = {"fit": run_fit_resume(dev, os.path.join(root, "fit"))}
    torch.cuda.empty_cache()
    res["cifar"] = run_cifar_preempt(os.path.join(root, "cifar"),
                                     cifar_inputs)
    res["torn"] = run_torn_write(os.path.join(root, "torn"), cli_state)
    res["oom"] = run_oom_ladder(os.path.join(root, "oom"))
    res["wall_s"] = time.perf_counter() - t0
    log(f"phase 21: {res['wall_s']:.1f} s")
    return res


def _unmeasured(entry: dict, where: str = "") -> list:
    """The time readings of a kernels-line entry that came back None (a
    profiler reading whose every session lost events), by key path; a
    kernel with no library call has ``library_ms`` None by design."""
    out = []
    for key, v in entry.items():
        path = f"{where}{key}"
        if isinstance(v, dict):
            out += _unmeasured(v, f"{path}.")
        elif (v is None and (key == "ms" or key.endswith(("_ms", "_us")))
              and path != "library_ms"):
            out.append(path)
    return out


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
    log(f"first bf16 forward: {time.perf_counter() - t0:.1f} s"
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
    times_b["bn_train_host_split"] = bn_host_split(dev, train_calls)
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
    cli_state = cli_run.pop("state")
    f32_step = check_train_step_f32_against_cpu()

    # 7. The geometry samplers' kernels against their plain versions.
    t0 = time.perf_counter()
    err_e, times_e = check_kcenter(dev, detail)
    err_f, times_f = check_boundary_radii(dev, detail)
    err_g, times_g = check_badge(dev, detail)
    log(f"geometry kernel checks: {time.perf_counter() - t0:.1f} s")

    # 8. Full-width scoring through the strategies, and kernels E, F and
    # G held on the inputs that path gave them.
    query, query_calls = run_query_path(dev)
    held = [check_recorded_inputs(query_calls, detail, "query")]
    del query_calls
    torch.cuda.empty_cache()
    geo_f32 = check_geometry_f32_against_cpu(view, rows[17][:4])

    # 9. Selection at the sweep's pool size.
    selection, sel_launches = run_selection_path(dev)

    # 10. The geometry samplers through the CLI on the card; first kernels
    # E, F and G held on the inputs the CLI's queries give them.
    held.append(check_recorded_inputs(record_cli_geometry_inputs(dev),
                                      detail, "cli_geometry"))
    torch.cuda.empty_cache()
    err_e, err_f, err_g = (max([e, *(h[k] for h in held)]) for e, k in
                           ((err_e, "E"), (err_f, "F"), (err_g, "G")))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_geo_") as tmp:
        cli_geo, cli_geo_launches = run_cli_geometry(tmp)

    # 11. Kernel H against its plain version.
    t0 = time.perf_counter()
    err_h, times_h, times_h_by_shape = check_balancing(dev, detail)
    log(f"kernel H checks: {time.perf_counter() - t0:.1f} s")

    # 12. BalancingSampler at the imbalanced CIFAR sweep's width; H held
    # on the inputs the query gave it.
    balancing, bal_calls = run_balancing_path(dev)
    err_h = max(err_h, check_recorded_h(bal_calls, detail, "balancing"))
    del bal_calls

    # 13. VAAL at the ImageNet sweep's width; B and C held on the VAE's
    # recorded inputs; the float32 co-step and score step card vs CPU.
    vaal, vaal_calls, (vrows, vview, vwindow) = run_vaal_path(dev)
    vb, vc = check_recorded_bn(vaal_calls, detail, "vaal_fit")
    err_b, err_c = max(err_b, vb), max(err_c, vc)
    del vaal_calls
    torch.cuda.empty_cache()
    vaal["f32"] = check_vaal_f32_against_cpu(vrows, vview, vwindow)

    # 14. The three samplers through the CLI; first H, B and C held on
    # the inputs the CLI's training and queries give them.
    rec = record_cli_sampler_inputs()
    err_h = max(err_h, check_recorded_h(rec, detail, "cli_samplers"))
    rb, rc = check_recorded_bn(rec, detail, "cli_samplers")
    err_b, err_c = max(err_b, rb), max(err_c, rc)
    del rec
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_smp_") as tmp:
        cli_smp, cli_smp_launches = run_cli_samplers(tmp)

    # 15. Kernel I against its plain version.
    t0 = time.perf_counter()
    err_i, times_i = check_stem_dw(dev, detail)
    log(f"kernel I checks: {time.perf_counter() - t0:.1f} s")

    # 16. The s2d stem through train, query and serve.
    s2d = {"logits": check_s2d_logits(dev, variables, rows[17][:4], view)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_s2d_") as tmp:
        s2d["experiment"] = run_s2d_experiment(tmp)
        s2d["serve"] = run_s2d_serve(s2d["experiment"]["exp_dir"])
    s2d["step"] = time_s2d_step(dev)
    s2d["f32_step"] = check_train_step_f32_against_cpu(
        stem="s2d", num_classes=16, hw=64, b=16)

    # 17. Kernel J against its plain version.
    t0 = time.perf_counter()
    err_j, times_j = check_int8_sync(dev, detail)
    log(f"kernel J checks: {time.perf_counter() - t0:.1f} s")

    # 18. Two ranks on the one card (gloo, host-staged).
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        dp = run_dp_experiment(tmp)

    # 19. One NCCL rank on the card.
    nccl = check_nccl_world1(dev)

    # 20. The CIFAR-10 fine-tuning sweep: kernel B' held and timed, the
    # imbalanced CIFAR job through the CLI, the cache repair.
    # 21. Resume and faults on the card, on phase 20's rows.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cifar_") as tmp:
        cifar, cifar_detail = run_cifar_finetune(tmp, dev)
        torch.cuda.empty_cache()
        resume = run_resume_faults(os.path.join(tmp, "resume"), dev,
                                   cifar.pop("inputs"), cli_state)
    detail.extend(cifar_detail)

    def total(runs):
        keys = next(iter(runs)).keys()
        return {k: sum(r[k] for r in runs) for k in keys}

    paths = {"serve": launches, "fit": fit["launches"],
             "cli": cli_run["launches"],
             "query": total([q["launches"] for q in query.values()]),
             "select": total(list(sel_launches.values())),
             "cli_geometry": cli_geo_launches,
             "balancing": balancing["launches"],
             "vaal_fit": vaal["fit_launches"],
             "vaal_query": vaal["query_launches"],
             "cli_samplers": cli_smp_launches,
             "s2d_experiment": s2d["experiment"]["launches"],
             "s2d_serve": s2d["serve"]["launches"],
             "dp_experiment": dp["launches"],
             "cifar_finetune": cifar["launches"],
             "resume_fit": resume["fit"]["launches"],
             "resume_cifar": resume["cifar"]["launches"],
             "torn_write": resume["torn"]["launches"],
             "oom_ladder": resume["oom"]["launches"]}

    def count(*names):
        by = {p: sum(v[n] for n in names) for p, v in paths.items()}
        return {"launches": sum(by.values()), "launches_by_path": by}

    c_names = ("bn_train_stats", "bn_train_bwd_reduce", "bn_train_chain",
               "bn_train_dx")
    j_names = ("int8_absmax", "int8_quantize", "int8_dequant_sum",
               "int8_sum_requantize")
    e_names = ("kcenter_fold_select", "kcenter_batch_pass",
               "kcenter_fold_draw", "kcenter_min_fold")
    f_names = ("boundary_radii", "head_pair_norms")
    kernels = [
        {"name": "prob_stats", "route": "cuda",
         "source": "active_learning_tpu_torch/csrc/prob_stats.cu",
         "replaces": "active_learning_tpu/strategies/scoring.py:109",
         **count("prob_stats"), "max_abs_err": err_a,
         **times_a, "library_ms": None},
        {"name": "bn_act", "route": "cuda",
         "source": "active_learning_tpu_torch/csrc/bn_act.cu",
         "replaces": "active_learning_tpu/models/resnet.py:190",
         **count("bn_act"), "max_abs_err": err_b,
         **times_b, "library_ms": None},
        {"name": "bn_act_backward", "route": "cuda",
         "source": "active_learning_tpu_torch/csrc/bn_eval_bwd.cu",
         "replaces": "active_learning_tpu/models/resnet.py:150",
         **count("bn_act_bwd"), "max_abs_err": cifar["bn_bwd_max_abs_err"],
         **cifar["bn_bwd_times"]},
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
        {"name": "kcenter", "route": "cuda",
         "source": "active_learning_tpu_torch/csrc/kcenter.cu",
         "replaces": "active_learning_tpu/strategies/scoring.py:45",
         **count(*e_names), "max_abs_err": err_e,
         "launches_by_function": {n: sum(v[n] for v in paths.values())
                                  for n in e_names},
         **times_e},
        {"name": "boundary_radii", "route": "cuda",
         "source": "active_learning_tpu_torch/csrc/boundary_radii.cu",
         "replaces": "active_learning_tpu/strategies/scoring.py:209",
         **count(*f_names), "max_abs_err": err_f,
         "launches_by_function": {n: sum(v[n] for v in paths.values())
                                  for n in f_names},
         **times_f},
        {"name": "badge", "route": "cuda",
         "source": "active_learning_tpu_torch/csrc/badge.cu",
         "replaces": "active_learning_tpu/strategies/scoring.py:154",
         **count("badge_factors"), "max_abs_err": err_g, **times_g},
        {"name": "balancing", "route": "cuda",
         "source": "active_learning_tpu_torch/csrc/balancing.cu",
         "replaces": "active_learning_tpu/strategies/balancing.py:61",
         **count("balancing_pick"), "max_abs_err": err_h, **times_h,
         "ms_by_shape": times_h_by_shape,
         "launches_per_pick": balancing["device_launches"]
         / max(balancing["launches"]["balancing_pick"], 1)},
        {"name": "stem_dw", "route": "cuda",
         "source": "active_learning_tpu_torch/csrc/stem_dw.cu",
         "replaces": "active_learning_tpu/ops/backward.py:104",
         **count("stem_dw"), "max_abs_err": err_i, **times_i},
        {"name": "int8_sync", "route": "cuda",
         "source": "active_learning_tpu_torch/csrc/int8_sync.cu",
         "replaces": "active_learning_tpu/parallel/mesh.py:472",
         **count(*j_names), "max_abs_err": err_j,
         "launches_by_function": {n: sum(v[n] for v in paths.values())
                                  for n in j_names},
         **times_j},
    ]
    early = [p for p in paths if not p.startswith("s2d_")]
    if any(paths[p]["stem_dw"] for p in early):
        raise AssertionError("kernel I launched on a path without the s2d "
                             "stem")
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"kernel {k['name']} never launched on the "
                                 "main paths")
        failed = _unmeasured(k)
        if failed:
            k["failed_measurements"] = failed
            log(f"kernel {k['name']}: not measured in this run: {failed}")
    if args.detail:
        os.makedirs(os.path.dirname(os.path.abspath(args.detail)),
                    exist_ok=True)
        with open(args.detail, "w") as fh:
            json.dump({"kernels": kernels, "serving": serving,
                       "training": {"fit": fit, "cli": cli_run,
                                    "f32_step": f32_step},
                       "acquisition": {"query": query, "f32": geo_f32,
                                       "selection": selection,
                                       "cli": cli_geo},
                       "samplers": {"balancing": balancing, "vaal": vaal,
                                    "cli": cli_smp},
                       "s2d": s2d, "dp": dp, "nccl": nccl,
                       "cifar_finetune": cifar, "resume_faults": resume,
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
