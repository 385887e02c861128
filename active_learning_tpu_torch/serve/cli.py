"""The ``serve`` verb (the JAX package's ``serve/cli.py``).

    python -m active_learning_tpu_torch serve --experiment_dir ./checkpoint/myexp_abc123
    # or, addressing the experiment the way the training CLI does:
    python -m active_learning_tpu_torch serve --ckpt_path ./checkpoint \\
        --exp_name myexp --exp_hash abc123

Everything about the served model is resolved from the experiment
itself: the saved config echo (``experiment_state.json``) names the
dataset and model, the newest ``best_rd_{n}.msgpack`` provides the
weights (flax's msgpack format, read by ``train/checkpoint.py``), and
the checkpoint's own head shape provides num_classes.  While the
experiment keeps training, the executor hot-reloads each new round's
best checkpoint between batches.  A checkpoint the JAX package trained
serves here unchanged.

Runs on the card (``--device cuda``, the default) and raises without
one; ``--device cpu`` runs the plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import asyncio
import datetime as dt
import json
import os
import signal
from typing import List, Optional, Tuple

from ..config import ServeConfig

# Dataset name -> (val normalization, default image size).  The val view
# is THE scoring view; serving with any other transform would break
# served == offline score equality.
_DATASET_VIEWS = {
    "cifar10": ("cifar", 32),
    "imbalanced_cifar10": ("cifar", 32),
    "imagenet": ("imagenet", 224),
    "imbalanced_imagenet": ("imagenet", 224),
    "synthetic": ("synthetic", 32),
}


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m active_learning_tpu_torch serve",
        description="Serve predictions + acquisition scores from an AL "
                    "experiment's best checkpoint")
    p.add_argument("--experiment_dir", type=str, default=None,
                   help="the experiment's checkpoint directory "
                        "({ckpt_path}/{exp_name}_{exp_hash}); holds "
                        "best_rd_*.msgpack + experiment_state.json")
    p.add_argument("--ckpt_path", type=str, default="./checkpoint")
    p.add_argument("--exp_name", type=str, default=None)
    p.add_argument("--exp_hash", type=str, default=None)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 = ephemeral (logged at startup)")
    p.add_argument("--max_batch", type=int, default=64)
    p.add_argument("--max_latency_ms", type=float, default=5.0)
    p.add_argument("--queue_depth", type=int, default=512)
    p.add_argument("--bucket_floor", type=int, default=8)
    p.add_argument("--reload_every_s", type=float, default=5.0)
    p.add_argument("--drain_timeout_s", type=float, default=30.0)
    p.add_argument("--dataset", type=str, default=None,
                   help="override the experiment's saved dataset name")
    p.add_argument("--model", type=str, default=None,
                   help="override the experiment's saved model name")
    p.add_argument("--image_size", type=int, default=None,
                   help="served input H=W (default: by dataset)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--log_dir", type=str, default="./logs",
                   help="serve log file directory (console always on)")
    return p


def resolve_experiment_dir(args) -> str:
    if args.experiment_dir:
        return args.experiment_dir
    if args.exp_name and args.exp_hash:
        return os.path.join(args.ckpt_path,
                            f"{args.exp_name}_{args.exp_hash}")
    raise SystemExit("serve: pass --experiment_dir, or --exp_name + "
                     "--exp_hash (+ --ckpt_path)")


def load_experiment_meta(exp_dir: str) -> dict:
    """The flattened config echo of the experiment's last saved round;
    {} when the experiment has not saved a round yet (weights alone
    still serve)."""
    path = os.path.join(exp_dir, "experiment_state.json")
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return json.load(fh).get("config", {})


def resolve_serve_setup(args) -> Tuple[object, object, int, str]:
    """(model, view, image_size, exp_dir) from the CLI args and the
    experiment's own artifacts.  num_classes comes from the checkpoint's
    head bias; the stem, dtype and BN-statistics choices follow the JAX
    driver's resolution (config echo beats arg pool)."""
    from ..data.core import CIFAR10_NORM, IMAGENET_NORM, SYNTH_NORM, ViewSpec
    from ..device import resolve_device, set_float32_precision
    from ..experiment.arg_pools import get_train_config
    from ..models.factory import get_network, resolve_dtype
    from ..train import checkpoint as ckpt_lib

    device = resolve_device(args.device)
    exp_dir = resolve_experiment_dir(args)
    cfg_echo = load_experiment_meta(exp_dir)
    dataset = args.dataset or cfg_echo.get("dataset") or "cifar10"
    model_name = args.model or cfg_echo.get("model") or "SSLResNet18"
    best_path, _ = ckpt_lib.latest_best_ckpt(exp_dir)
    if best_path is None:
        raise SystemExit(f"serve: no best_rd_*.msgpack under {exp_dir}")
    variables = ckpt_lib.load_variables(best_path)
    num_classes = int(variables["params"]["linear"]["bias"].shape[0])

    try:
        train_cfg = get_train_config(cfg_echo.get("arg_pool", "default"),
                                     dataset)
    except KeyError:
        train_cfg = None

    def resolved(key, default):
        return (cfg_echo.get(key)
                or (getattr(train_cfg, key) if train_cfg else None)
                or default)

    dtype = resolve_dtype(resolved("dtype", "auto"), device)
    set_float32_precision(dtype)
    view_kind, default_size = _DATASET_VIEWS.get(dataset, ("cifar", 32))
    norm = {"cifar": CIFAR10_NORM, "imagenet": IMAGENET_NORM,
            "synthetic": SYNTH_NORM}[view_kind]
    view = ViewSpec(norm, augment=False)
    image_size = int(args.image_size or default_size)
    model = get_network(dataset, model_name, num_classes=num_classes,
                        dtype=dtype, stem=resolved("stem", "default"),
                        bn_stats_dtype=resolved("bn_stats_dtype", "auto"),
                        device=device)
    return model, view, image_size, exp_dir


def build_server(args):
    """The ``ScoringServer`` (not started) that ``main`` runs for the
    parsed ``args``."""
    serve_cfg = ServeConfig(
        host=args.host, port=args.port, max_batch=args.max_batch,
        max_latency_ms=args.max_latency_ms, queue_depth=args.queue_depth,
        bucket_floor=args.bucket_floor, reload_every_s=args.reload_every_s,
        drain_timeout_s=args.drain_timeout_s)
    model, view, image_size, exp_dir = resolve_serve_setup(args)

    from .executor import DeviceExecutor
    from .server import ScoringServer

    # The executor loads the checkpoint itself, so its round stamp
    # describes the file actually served.  Clients send (H, W, 3) rows
    # (an s2d-stem model gets them re-laid on the host).
    executor = DeviceExecutor(
        model, view, next(model.parameters()).device,
        image_shape=(image_size, image_size, 3), ckpt_dir=exp_dir,
        reload_every_s=serve_cfg.reload_every_s)
    return ScoringServer(executor, serve_cfg)


def main(argv: Optional[List[str]] = None) -> int:
    args = get_parser().parse_args(argv)

    from ..utils.logging import setup_logging
    setup_logging(args.log_dir,
                  f"serve_{dt.date.today():%m%d}_{os.getpid()}.log")

    server = build_server(args)
    asyncio.run(_serve_until_signal(server))
    return 0


async def _serve_until_signal(server) -> None:
    """Run until SIGTERM/SIGINT, then drain: stop accepting, complete
    every admitted request, stop the device loop, return (exit 0)."""
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await server.start()
    await stop.wait()
    await server.drain()


if __name__ == "__main__":
    raise SystemExit(main())
