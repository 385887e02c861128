"""The port stands alone: no module of ``active_learning_tpu_torch``, and
nothing in ``chip_smoke.py``, imports jax, flax, optax, msgpack,
scikit-learn (the card's machine has none) or the JAX package.

Two checks: every port module imports in a fresh interpreter where those
names are blocked in ``sys.modules``; and an AST scan of every import
statement in the package and in ``chip_smoke.py``.  The modules of the
training, acquisition, last-samplers, s2d, data-parallel and CIFAR
fine-tuning slices are also named one by one.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "active_learning_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "sklearn",
             "active_learning_tpu")


def _port_files():
    out = []
    for root, _dirs, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _module_name(path: str) -> str:
    rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
    return rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def test_every_module_imports_with_jax_blocked():
    modules = [_module_name(p) for p in _port_files()]
    assert len(modules) > 20
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if sys.modules[n] is not None\n"
        f"             and n.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok")


def _imports(path: str):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files()
                         + [os.path.join(REPO, "chip_smoke.py"),
                            os.path.join(REPO, "step_ab.py")],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import_statement(path):
    bad = [name for name in _imports(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


# Every module of the training slice, named so that a module that goes
# missing (or moves out of the package) fails here rather than silently
# leaving both checks above.
TRAINING_SLICE = (
    "__main__", "config", "registry", "pool", "initial_pool",
    "data/__init__", "data/core", "data/synthetic", "data/augment",
    "data/pipeline", "ops/__init__", "ops/bn_train", "ops/fused_sgd",
    "models/resnet", "models/weights", "train/optim", "train/evaluation",
    "train/trainer", "train/checkpoint", "strategies/__init__",
    "strategies/base", "strategies/random_sampler",
    "strategies/uncertainty", "utils/metrics", "utils/tracing",
    "experiment/arg_pools", "experiment/resume", "experiment/driver",
    "experiment/cli")

# The geometry samplers' acquisition path.
ACQUISITION_SLICE = (
    "device", "utils/threefry", "ops/kcenter", "ops/boundary_radii",
    "ops/badge", "strategies/kcenter", "strategies/scoring",
    "strategies/mase", "strategies/coreset")


# The last samplers: Balancing (kernel H), MarginClustering and VAAL.
SAMPLERS_SLICE = (
    "ops/balancing", "strategies/balancing", "strategies/clustering",
    "strategies/vaal", "models/vaal")


# The s2d stem: kernel I's wrapper.
S2D_SLICE = ("ops/stem_conv",)

# Data parallelism: the mesh and kernel J's wrapper.
PARALLEL_SLICE = ("parallel/__init__", "parallel/mesh", "ops/int8_sync")

# The CIFAR-10 fine-tuning sweep: the data, the checkpoint ingestion, the
# job lists (kernel B′ is in ops/bn_act).
CIFAR_SLICE = ("data/facsimile", "data/cifar10", "data/imbalance",
               "utils/pretrained", "experiment/gen_jobs", "ops/bn_act")


@pytest.mark.parametrize("module", TRAINING_SLICE + ACQUISITION_SLICE
                         + SAMPLERS_SLICE + S2D_SLICE + PARALLEL_SLICE
                         + CIFAR_SLICE)
def test_training_slice_module_is_checked(module):
    path = os.path.join(PKG, *module.split("/")) + ".py"
    assert path in _port_files()
    assert not [n for n in _imports(path) if n.split(".")[0] in FORBIDDEN]
