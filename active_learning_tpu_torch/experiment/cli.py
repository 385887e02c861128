"""The experiment command line (the JAX package's ``experiment/cli.py``),
with the JAX CLI's flag names for everything the port carries:

    python -m active_learning_tpu_torch --dataset synthetic \\
        --arg_pool synthetic --strategy MarginSampler --rounds 2 \\
        --round_budget 16 --n_epoch 2 --early_stop_patience 2 \\
        [--device cpu]

``--device`` (the port's own flag) defaults to ``cuda`` and raises
without a card; ``cpu`` runs the kernels' plain versions.  A flag of the
JAX CLI that the port does not carry yet (``--resume_training``,
``--stem s2d``, the resident/stream/int8/fleet knobs, ...) and a dataset
or strategy not ported yet exit with status 2 and a message naming
ROADMAP.md; nothing is silently ignored.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from ..config import ExperimentConfig

# Flags of the JAX CLI this port does not carry yet: name -> takes a value.
UNSUPPORTED_FLAGS = {
    "--project_name": True, "--disable_metrics": False,
    "--metrics_backend": True,
    "--metrics_rotate_bytes": True, "--dataset_dir": True,
    "--pretrained_root": True, "--imbalance_type": True,
    "--imbalance_factor": True, "--imbalance_seed": True,
    "--resume_training": False, "--download_data": False,
    "--debug_mode": False, "--profile_dir": True, "--profile_rounds": True,
    "--disable_telemetry": False, "--heartbeat_every_s": True,
    "--export_trace": False, "--watchdog": False,
    "--stall_deadline_s": True, "--prometheus_file": True,
    "--disable_diagnostics": False, "--watchdog_action": True,
    "--fault_spec": True, "--resident_scoring_bytes": True,
    "--pool_sharding": True, "--pool_backend": True, "--train_feed": True,
    "--feed_workers": True, "--grad_allreduce": True,
    "--scale_batch": True, "--round_pipeline": True,
    "--subset_labeled": True, "--subset_unlabeled": True,
    "--partitions": True, "--kcenter_batch": True,
    "--compilation_cache_dir": True, "--vae_latent_dim": True,
    "--vaal_adversary_param": True, "--adversary_param": True,
    "--lr_vae": True, "--lr_discriminator": True, "--num_devices": True,
    "--coordinator_address": True, "--num_processes": True,
    "--process_id": True,
}

PORTED_DATASETS = ("synthetic",)


class _NotPorted(argparse.Action):
    """Refuses a flag the port does not carry yet (exit status 2)."""

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet (ROADMAP.md)")


class _Stem(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        if values != "default":
            parser.error(f"--stem {values} is not ported yet (ROADMAP.md)")
        setattr(namespace, self.dest, values)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m active_learning_tpu_torch",
        description="Active learning on one NVIDIA card (the PyTorch + "
                    "CUDA port of active_learning_tpu)")
    p.add_argument("--exp_name", type=str, default="active_learning")
    p.add_argument("--exp_hash", type=str, default=None)
    p.add_argument("--log_dir", type=str, default="./logs")
    p.add_argument("--ckpt_path", type=str, default="./checkpoint")
    p.add_argument("--dataset", type=str, default="cifar10",
                   choices=["cifar10", "imbalanced_cifar10", "imagenet",
                            "imbalanced_imagenet", "synthetic"])
    p.add_argument("--arg_pool", type=str, default="default")
    p.add_argument("--strategy", type=str, default="RandomSampler")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--round_budget", type=int, default=5000)
    p.add_argument("--freeze_feature", action="store_true")
    p.add_argument("--init_pool_size", type=int, default=-1,
                   help="-1 => round_budget; 0 => query at round 0")
    p.add_argument("--init_pool_type", type=str, default="random",
                   choices=["random", "random_balance"])
    p.add_argument("--model", type=str, default="SSLResNet18",
                   choices=["SSLResNet18", "SSLResNet50"])
    p.add_argument("--n_epoch", type=int, default=60)
    p.add_argument("--early_stop_patience", type=int, default=30,
                   help="0 disables early stopping")
    p.add_argument("--dtype", type=str, default=None,
                   choices=["auto", "bfloat16", "float32"],
                   help="compute precision (params/BN stay float32)")
    p.add_argument("--bn_stats_dtype", type=str, default=None,
                   choices=["auto", "bfloat16", "float32"])
    p.add_argument("--stem", type=str, default="default", action=_Stem,
                   choices=["default", "s2d"])
    p.add_argument("--fused_optimizer", type=str, default=None,
                   choices=["auto", "on", "off"])
    p.add_argument("--optim_state_dtype", type=str, default=None,
                   choices=["f32", "bf16"])
    p.add_argument("--run_seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    for flag, takes_value in UNSUPPORTED_FLAGS.items():
        p.add_argument(flag, action=_NotPorted, nargs=1 if takes_value else 0,
                       help=argparse.SUPPRESS)
    return p


def args_to_config(args: argparse.Namespace) -> ExperimentConfig:
    return ExperimentConfig(
        exp_name=args.exp_name, exp_hash=args.exp_hash,
        log_dir=args.log_dir, ckpt_path=args.ckpt_path, dataset=args.dataset,
        arg_pool=args.arg_pool, strategy=args.strategy, rounds=args.rounds,
        round_budget=args.round_budget, freeze_feature=args.freeze_feature,
        init_pool_size=args.init_pool_size,
        init_pool_type=args.init_pool_type, model=args.model,
        n_epoch=args.n_epoch, early_stop_patience=args.early_stop_patience,
        dtype=args.dtype, bn_stats_dtype=args.bn_stats_dtype,
        fused_optimizer=args.fused_optimizer,
        optim_state_dtype=args.optim_state_dtype, run_seed=args.run_seed,
        device=args.device)


def parse(argv: List[str]) -> ExperimentConfig:
    """Flags -> config; exits with status 2 on anything the port does
    not carry yet."""
    from .. import strategies  # noqa: F401  (importing registers them)
    from ..registry import STRATEGIES
    from .arg_pools import get_train_config

    parser = get_parser()
    args = parser.parse_args(argv)
    if args.dataset not in PORTED_DATASETS:
        parser.error(f"--dataset {args.dataset} is not ported yet "
                     "(ROADMAP.md); the port carries "
                     f"{', '.join(PORTED_DATASETS)}")
    if args.strategy not in STRATEGIES.names():
        parser.error(f"--strategy {args.strategy} is not ported yet "
                     f"(ROADMAP.md); the port carries "
                     f"{', '.join(STRATEGIES.names())}")
    try:
        get_train_config(args.arg_pool, args.dataset)
    except KeyError as exc:
        parser.error(str(exc.args[0]))
    return args_to_config(args)


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    from .driver import run_experiment

    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        cfg = parse(argv)
    except SystemExit as exc:
        return int(exc.code or 0)
    run_experiment(cfg)
    return 0
