"""Time the one-rank B=128 train step of two checkouts on one card, in
turns A, B, B, A.

    python3 step_ab.py DIR_A DIR_B [--s2d]
    python3 step_ab.py DIR_A DIR_B --kernels-af
    python3 step_ab.py DIR_A DIR_B --kernels-eg

Each turn is a fresh process that imports the checkout's own
``chip_smoke.py`` and package (from ``DIR``) and runs its path (a),
``run_fit_path``: ``Trainer.fit`` on full-width SSLResNet50, then a
timed window and a profiled window of train steps.  Prints one JSON line
per turn (``step_ms`` on the host clock, the profiled wall and
device-busy ms a step, the device's busy share and the kernel launches a
step) and, last, a summary with each checkout's two turns.  Compare two versions
only within one such run: the card's clocks and power limit differ
between machines.  With ``--s2d`` each turn also runs the checkout's
``time_s2d_step`` (phase 16.4: a B=128 step with the s2d stem and with
the default one, profiled) and reports each stem's device ms a step and
the stem alone (forward + weight gradient).  Every turn also times kernel D
through its wrapper, ``fused_sgd_update`` over SSLResNet50's 161 leaves
at f32 state: the host side (``perf_counter`` around each of 200 calls,
the device not waited for; the median, three times) and the device time
of 20 calls from the profiler's kernel events, before the train step
(after a long profiled window a session has lost events).  Only a
complete reading counts (20 times one call's kernel events; a session
that lost some is taken again, at most three); a turn fails without
one, or when the time is under its bytes bound (20 bytes a parameter).

With ``--kernels-af`` a turn times kernels A and F alone, through the
wrappers both checkouts share (``prob_stats``, ``boundary_radii``,
``head_pair_norms``), at the main paths' shapes: A at B = 64 and 256
and C = 10 and 1000, F's radii at B = 256, C = 1000, D = 2048 (the head's rows
contiguous, as the model gives them) and its pair norms.  For each, by
the checkout's own ``chip_smoke`` helpers: the CUDA-event mean over 50
back-to-back calls (``cuda_ms``), the device time and the kernel events
a call from a complete profiler session of 20 calls
(``profiled_device_ms``, ``_complete_events``), and the median host time
of 200 calls (``host_us``: ``perf_counter``, the device not waited
for).

With ``--kernels-eg`` a turn times kernels E and G alone, the same way
and through the wrappers both checkouts share: E at the selection's
shapes (``batch_pass`` at 131,072 x 2048, q = 8, 50,000 rows labeled;
``min_fold`` of 1,024 labeled centers there; ``fold_draw`` on the pooled
BADGE factors of a 13,000-row partition, [13,000, 16] + [13,000, 32],
and that partition's whole randomized scan of 1,000 picks on the host
clock), and G pooled and unpooled at B = 256, C = 1000, D = 2048.  Each
profiler reading is held to the work's bytes bound as its floor.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_TURN = """
import json, sys, time
sys.path.insert(0, {dir!r})
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule
import chip_smoke as cs
from active_learning_tpu_torch.ops import fused_sgd as fs
# Kernel D first: after a long profiled window a session has lost events.
p, g, t = cs._sgd_leaves(torch.device("cuda"), torch.float32, 4)
def sgd_host_us():
    for _ in range(3):
        fs.fused_sgd_update(p, g, t, 0.1, 0.9, 1e-4)
    torch.cuda.synchronize()
    ts = []
    for _ in range(200):
        t0 = time.perf_counter()
        fs.fused_sgd_update(p, g, t, 0.1, 0.9, 1e-4)
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(ts)) * 1e6
res = {{"sgd_host_us": [sgd_host_us() for _ in range(3)]}}
def events(n):
    # As chip_smoke._kernel_events: one discarded warm-up step (a
    # session's first launches can go unrecorded), the card waited for
    # at every step.
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n,
                                   repeat=1)) as prof:
        for _ in range(n + 1):
            fs.fused_sgd_update(p, g, t, 0.1, 0.9, 1e-4)
            torch.cuda.synchronize()
            prof.step()
    return {{e.key: (e.count, e.self_device_time_total)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA}}
# As chip_smoke.profiled_device_ms: only a complete reading counts.
lost = []
for _ in range(3):
    one, ev = events(1), events(20)
    counts = {{k: c for k, (c, _) in ev.items()}}
    if ev and counts == {{k: 20 * c for k, (c, _) in one.items()}}:
        break
    lost.append((one, counts))
else:
    raise AssertionError(f"kernel D: the profiler lost events in every "
                         f"session: {{lost}}")
res["sgd_profiler_sessions_discarded"] = len(lost)
res["sgd_device_ms"] = sum(us for _, us in ev.values()) / 1e3 / 20
bound_ms = sum(x.numel() for x in p) * 20 / cs.HBM_BYTES_PER_S * 1e3
if res["sgd_device_ms"] < bound_ms:
    raise AssertionError(f"kernel D: {{res['sgd_device_ms']}} ms a call, "
                         f"under its bytes bound {{bound_ms}} ms")
del p, g, t
torch.cuda.empty_cache()
out = cs.run_fit_path(torch.device("cuda"))
res.update({{k: out[k] for k in ("step_ms", "profiled_wall_ms_per_step",
                                 "device_ms_per_step", "device_busy_share",
                                 "kernel_launches_per_step")}})
if {s2d!r}:
    s2d = cs.time_s2d_step(torch.device("cuda"), reps=5)
    for stem in ("default", "s2d"):
        res[stem + "_step_device_ms"] = s2d["profiled"][stem]["device_ms"]
        res[stem + "_stem_fwd_dw_ms"] = s2d["stem_fwd_dw_ms"][stem]
print("TURN " + json.dumps(res))
"""


_KERNEL_TURN = """
import json, sys
sys.path.insert(0, {dir!r})
import torch
import chip_smoke as cs
from active_learning_tpu_torch.ops import boundary_radii as br
from active_learning_tpu_torch.ops import prob_stats as ps
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(3)
emb = torch.randn(256, 2048, device=dev, generator=g)
kernel = (torch.randn(1000, 2048, device=dev, generator=g) * 0.05).T
bias = torch.randn(1000, device=dev, generator=g) * 0.1
norms = br.head_pair_norms(kernel)
logits = {{(b, c): torch.randn(b, c, device=dev, generator=g)
          for b in (64, 256) for c in (10, 1000)}}
fns = {{"radii": lambda: br.boundary_radii(emb, kernel, bias, norms),
        "pair_norms": lambda: br.head_pair_norms(kernel)}}
for (b, c), x in logits.items():
    fns[f"prob_stats_b{{b}}_c{{c}}"] = lambda x=x: ps.prob_stats(x)
res = {{}}
for name, fn in fns.items():
    dev_ms = cs.profiled_device_ms(fn, 0.0)[0]
    events = cs._complete_events(fn, 20)[0]
    res[name] = {{"ms": cs.cuda_ms(fn), "device_ms": dev_ms,
                 "kernels_a_call": sum(n for n, _ in events.values()) / 20,
                 "host_us": cs.host_us(fn, reps=200)}}
print("TURN " + json.dumps(res))
"""


_KERNEL_EG_TURN = """
import json, sys, time
sys.path.insert(0, {dir!r})
import torch
import chip_smoke as cs
from active_learning_tpu_torch.ops import badge as bg
from active_learning_tpu_torch.ops import kcenter as kc
from active_learning_tpu_torch.strategies import kcenter as skc
dev = torch.device("cuda")
hbm = cs.HBM_BYTES_PER_S


def reading(fn, nbytes, reps=20):
    dev_ms = cs.profiled_device_ms(fn, nbytes / hbm * 1e3, reps=reps)[0]
    events = cs._complete_events(fn, reps)[0]
    return {{"ms": cs.cuda_ms(fn, reps=reps), "device_ms": dev_ms,
             "kernels_a_call": sum(n for n, _ in events.values()) / reps,
             "host_us": cs.host_us(fn, reps=100)}}


res = {{}}
n, d, q = 131072, 2048, 8
factors, sqn, md, sel, labeled, rest = cs._kc_pool(dev, n, (d,), 7, 50000)
state = kc.BatchState(n, n, q, dev)
kc.batch_pass(factors, sqn, md, sel, state)  # passes fold q centers now
res["batch_pass"] = reading(
    lambda: kc.batch_pass(factors, sqn, md, sel, state), n * (d + 4) * 4.0)
chunk = labeled[:1024].clone()
res["min_fold_1024"] = reading(
    lambda: kc.min_fold(factors, sqn, md, chunk), n * (d + 2) * 4.0,
    reps=5)
del factors, sqn, md, sel, state
torch.cuda.empty_cache()
n = 13000
a_f, sqn, md, sel, labeled, _ = cs._kc_pool(dev, n, (16, 32), 8, 5000)
out_v = torch.zeros(1, device=dev)
out_i = torch.zeros(1, dtype=torch.int64, device=dev)
none = torch.zeros(0, dtype=torch.int64, device=dev)
res["fold_draw_pooled"] = reading(
    lambda: kc.fold_draw(a_f, sqn, md, sel, none, (1, 2), out_v, out_i),
    n * (48 + 4) * 4.0)
walls = []
for _ in range(3):
    md1, sel1 = md.clone(), sel.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    skc._kcenter_scan(a_f, sqn, md1, sel1, 1000, True, (3, 4))
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
res["draw_scan_1000_s"] = walls
del a_f, sqn, md, sel
torch.cuda.empty_cache()
g = torch.Generator(device=dev).manual_seed(4)
b, c, d = 256, 1000, 2048
logits = torch.randn(b, c, device=dev, generator=g) * 3.0
emb = torch.randn(b, d, device=dev, generator=g)
res["badge_pooled"] = reading(lambda: bg.badge_factors(logits, emb, True),
                              4.0 * (b * c + b * d + b * 48))
res["badge_unpooled"] = reading(
    lambda: bg.badge_factors(logits, emb, False), 4.0 * 2 * b * c)
print("TURN " + json.dumps(res))
"""


def turn(path: str, s2d: bool = False, kernels: str = "") -> dict:
    code = (_KERNEL_TURN.format(dir=path) if kernels == "af"
            else _KERNEL_EG_TURN.format(dir=path) if kernels == "eg"
            else _TURN.format(dir=path, s2d=s2d))
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=path, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{path}: exit {proc.returncode}\n"
                           f"{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")]
    return json.loads(line[-1][5:])


def main(argv) -> int:
    s2d = "--s2d" in argv
    kernels = ("af" if "--kernels-af" in argv
               else "eg" if "--kernels-eg" in argv else "")
    argv = [a for a in argv
            if a not in ("--s2d", "--kernels-af", "--kernels-eg")]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    dirs = {"A": os.path.abspath(argv[0]), "B": os.path.abspath(argv[1])}
    runs = {"A": [], "B": []}
    for label in "ABBA":
        out = turn(dirs[label], s2d, kernels)
        runs[label].append(out)
        print(json.dumps({"turn": label, "dir": dirs[label], **out}),
              flush=True)
    if kernels:
        print(json.dumps({label: {"dir": dirs[label], **{
            name: ({k: [r[name][k] for r in rs] for k in rs[0][name]}
                   if isinstance(rs[0][name], dict)
                   else [r[name] for r in rs])
            for name in rs[0]}} for label, rs in runs.items()}))
        return 0
    print(json.dumps({label: {"dir": dirs[label],
                              "step_ms": [r["step_ms"] for r in rs],
                              **{k: [r[k] for r in rs] for k in rs[0]
                                 if k.endswith("device_ms")
                                 or k in ("device_ms_per_step",
                                          "device_busy_share",
                                          "kernel_launches_per_step",
                                          "profiled_wall_ms_per_step",
                                          "sgd_host_us", "sgd_device_ms")}}
                      for label, rs in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
