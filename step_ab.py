"""Time the one-rank B=128 train step of two checkouts on one card, in
turns A, B, B, A.

    python3 step_ab.py DIR_A DIR_B

Each turn is a fresh process that imports the checkout's own
``chip_smoke.py`` and package (from ``DIR``) and runs its path (a),
``run_fit_path``: ``Trainer.fit`` on full-width SSLResNet50, then a
timed window and a profiled window of train steps.  Prints one JSON line
per turn (``step_ms``, the profiled wall and device-busy ms a step) and,
last, a summary with each checkout's two turns.  Compare two versions
only within one such run: the card's clocks and power limit differ
between machines.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_TURN = """
import json, sys
sys.path.insert(0, {dir!r})
import torch
import chip_smoke as cs
out = cs.run_fit_path(torch.device("cuda"))
print("TURN " + json.dumps({{k: out[k] for k in (
    "step_ms", "profiled_wall_ms_per_step", "device_ms_per_step",
    "device_busy_share")}}))
"""


def turn(path: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _TURN.format(dir=path)],
                          cwd=path, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{path}: exit {proc.returncode}\n"
                           f"{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")]
    return json.loads(line[-1][5:])


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    dirs = {"A": os.path.abspath(argv[0]), "B": os.path.abspath(argv[1])}
    runs = {"A": [], "B": []}
    for label in "ABBA":
        out = turn(dirs[label])
        runs[label].append(out)
        print(json.dumps({"turn": label, "dir": dirs[label], **out}),
              flush=True)
    print(json.dumps({label: {"dir": dirs[label],
                              "step_ms": [r["step_ms"] for r in rs],
                              "device_ms_per_step": [
                                  r["device_ms_per_step"] for r in rs]}
                      for label, rs in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
