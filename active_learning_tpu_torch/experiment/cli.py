"""The experiment command line (the JAX package's ``experiment/cli.py``),
with the JAX CLI's flag names for everything the port carries:

    python -m active_learning_tpu_torch --dataset synthetic \\
        --arg_pool synthetic --strategy MarginSampler --rounds 2 \\
        --round_budget 16 --n_epoch 2 --early_stop_patience 2 \\
        [--device cpu]

``--device`` (the port's own flag) defaults to ``cuda`` and raises
without a card; ``cpu`` runs the kernels' plain versions.

``--num_devices N`` (default -1: every visible card, 1 on the CPU) with
N > 1 starts N ranks, one process each, joined over localhost: NCCL
with one card per rank on ``cuda``, gloo with ``--device cpu``.
``--coordinator_address host:port --num_processes N --process_id R``
makes this process rank R of N instead (one per host or card; start
each yourself).  ``--grad_allreduce`` and ``--scale_batch`` take the
JAX CLI's values.

The CIFAR-10 sweep's flags are the JAX CLI's: ``--dataset {cifar10,
imbalanced_cifar10}`` read from ``--dataset_dir`` (fetched there with
``--download_data``), ``--imbalance_{type,factor,seed}``, ``--debug_mode``
and ``--pretrained_root``, onto which an arg pool's relative checkpoint
path (``ssp_finetuning``, ``ssp_finetuning_imbalanced_cifar10_imb_*``)
is rebased.

``--resume_training`` continues the saved experiment of ``--exp_name``
/ ``--exp_hash`` under ``--ckpt_path`` (and a run preempted in round 0,
which the round journal in ``--log_dir`` records);
``--fault_spec site:action[@arg]`` arms the fault-injection registry
(``faults/registry.py``; default ``$AL_FAULT_SPEC``), and a malformed
spec exits 2.  A preempted run (SIGTERM or SIGINT) checkpoints at the
next epoch or phase boundary and exits 0.

A flag of the JAX CLI that the port does not carry yet (the
resident/stream/fleet knobs, ``--pool_sharding``, ...) and a dataset or
strategy not ported yet exit with status 2 and a message naming
ROADMAP.md; nothing is silently ignored.
"""

from __future__ import annotations

import argparse
import uuid
from typing import List, Optional

from ..config import ExperimentConfig, ImbalanceConfig, VAALConfig

# Flags of the JAX CLI this port does not carry yet: name -> takes a value.
UNSUPPORTED_FLAGS = {
    "--project_name": True, "--disable_metrics": False,
    "--metrics_backend": True,
    "--metrics_rotate_bytes": True,
    "--profile_dir": True, "--profile_rounds": True,
    "--disable_telemetry": False, "--heartbeat_every_s": True,
    "--export_trace": False, "--watchdog": False,
    "--stall_deadline_s": True, "--prometheus_file": True,
    "--disable_diagnostics": False, "--watchdog_action": True,
    "--resident_scoring_bytes": True,
    "--pool_sharding": True, "--pool_backend": True, "--train_feed": True,
    "--feed_workers": True, "--round_pipeline": True,
    "--compilation_cache_dir": True,
}

PORTED_DATASETS = ("cifar10", "imbalanced_cifar10", "synthetic",
                   "imbalanced_synthetic")


class _NotPorted(argparse.Action):
    """Refuses a flag the port does not carry yet (exit status 2)."""

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet (ROADMAP.md)")


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
    p.add_argument("--dataset_dir", type=str, default=None)
    p.add_argument("--arg_pool", type=str, default="default")
    p.add_argument("--pretrained_root", type=str, default=None,
                   help="rebase an arg pool's relative pretrained-ckpt path")
    p.add_argument("--imbalance_type", type=str, default=None,
                   choices=[None, "exp", "step"])
    p.add_argument("--imbalance_factor", type=float, default=0.1)
    p.add_argument("--imbalance_seed", type=int, default=0)
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
    p.add_argument("--resume_training", action="store_true")
    p.add_argument("--n_epoch", type=int, default=60)
    p.add_argument("--early_stop_patience", type=int, default=30,
                   help="0 disables early stopping")
    p.add_argument("--download_data", action="store_true",
                   help="fetch CIFAR-10 (md5-checked) when absent")
    p.add_argument("--debug_mode", action="store_true")
    p.add_argument("--dtype", type=str, default=None,
                   choices=["auto", "bfloat16", "float32"],
                   help="compute precision (params/BN stay float32)")
    p.add_argument("--bn_stats_dtype", type=str, default=None,
                   choices=["auto", "bfloat16", "float32"])
    p.add_argument("--stem", type=str, default=None,
                   choices=["default", "s2d"],
                   help="ResNet stem: s2d folds the 224px 7x7/s2 stem into "
                        "an exact 4x4/s1 conv over space-to-depth input "
                        "(default: the arg pool's; CIFAR datasets keep "
                        "their stem)")
    p.add_argument("--fused_optimizer", type=str, default=None,
                   choices=["auto", "on", "off"])
    p.add_argument("--optim_state_dtype", type=str, default=None,
                   choices=["f32", "bf16"])
    p.add_argument("--subset_labeled", type=int, default=None)
    p.add_argument("--subset_unlabeled", type=int, default=None)
    p.add_argument("--partitions", type=int, default=1)
    p.add_argument("--kcenter_batch", type=int, default=8,
                   help="picks the greedy k-center folds per pool pass "
                        "(the exact re-check keeps the picks of 1)")
    p.add_argument("--vae_latent_dim", type=int, default=64)
    p.add_argument("--vaal_adversary_param", "--adversary_param",
                   dest="vaal_adversary_param", type=float, default=10.0)
    p.add_argument("--lr_vae", type=float, default=5e-5)
    p.add_argument("--lr_discriminator", type=float, default=1e-3)
    p.add_argument("--grad_allreduce", type=str, default=None,
                   choices=["f32", "int8", "int8_rs", "auto"],
                   help="gradient sync over N ranks: f32 (one all_reduce), "
                        "int8 (block-scaled int8 payload; the "
                        "reduce-scatter form above 8 ranks), int8_rs "
                        "(always reduce-scatter), auto (int8 on more than "
                        "one rank); the int8 modes must pass the learning "
                        "probe or the run degrades to f32")
    p.add_argument("--scale_batch", type=str, default=None,
                   choices=["auto", "off"],
                   help="auto: train batch and lr x ranks, >=5-epoch "
                        "cosine warmup (the arg pool's batch becomes per "
                        "rank)")
    p.add_argument("--run_seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--num_devices", type=int, default=-1,
                   help="ranks, one process each (-1 = every visible "
                        "card; 1 on the CPU)")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of rank 0, to join a multi-process run")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--fault_spec", type=str, default=None,
                   help="deterministic fault injection, e.g. "
                        "'ckpt_write:torn@1,dispatch:delay@0.05' "
                        "(site:action[@arg]); defaults to $AL_FAULT_SPEC; "
                        "unset, every site is a no-op")
    for flag, takes_value in UNSUPPORTED_FLAGS.items():
        p.add_argument(flag, action=_NotPorted, nargs=1 if takes_value else 0,
                       help=argparse.SUPPRESS)
    return p


def args_to_config(args: argparse.Namespace) -> ExperimentConfig:
    return ExperimentConfig(
        exp_name=args.exp_name, exp_hash=args.exp_hash,
        log_dir=args.log_dir, ckpt_path=args.ckpt_path, dataset=args.dataset,
        dataset_dir=args.dataset_dir, arg_pool=args.arg_pool,
        pretrained_root=args.pretrained_root,
        imbalance=ImbalanceConfig(imbalance_type=args.imbalance_type,
                                  imbalance_factor=args.imbalance_factor,
                                  imbalance_seed=args.imbalance_seed),
        download_data=args.download_data, debug_mode=args.debug_mode,
        strategy=args.strategy, rounds=args.rounds,
        round_budget=args.round_budget, freeze_feature=args.freeze_feature,
        init_pool_size=args.init_pool_size,
        init_pool_type=args.init_pool_type, model=args.model,
        resume_training=args.resume_training, n_epoch=args.n_epoch,
        early_stop_patience=args.early_stop_patience,
        dtype=args.dtype, bn_stats_dtype=args.bn_stats_dtype,
        stem=args.stem, fused_optimizer=args.fused_optimizer,
        optim_state_dtype=args.optim_state_dtype,
        subset_labeled=args.subset_labeled,
        subset_unlabeled=args.subset_unlabeled, partitions=args.partitions,
        kcenter_batch=args.kcenter_batch,
        vaal=VAALConfig(vae_latent_dim=args.vae_latent_dim,
                        adversary_param=args.vaal_adversary_param,
                        lr_vae=args.lr_vae,
                        lr_discriminator=args.lr_discriminator),
        grad_allreduce=args.grad_allreduce, scale_batch=args.scale_batch,
        run_seed=args.run_seed, device=args.device,
        num_devices=args.num_devices,
        coordinator_address=args.coordinator_address,
        num_processes=args.num_processes, process_id=args.process_id,
        fault_spec=args.fault_spec)


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
        get_train_config(args.arg_pool, args.dataset, args.pretrained_root)
    except KeyError as exc:
        parser.error(str(exc.args[0]))
    if args.fault_spec:
        from ..faults import parse_spec
        try:
            parse_spec(args.fault_spec)
        except ValueError as exc:
            parser.error(f"--fault_spec: {exc}")
    return args_to_config(args)


def _rank_main(rank: int, world: int, cfg: ExperimentConfig) -> None:
    from ..faults.preempt import PreemptionRequested
    from .driver import run_experiment

    try:
        run_experiment(cfg)
    except PreemptionRequested:
        pass


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    from ..parallel import mesh as mesh_lib
    from .driver import run_experiment

    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        cfg = parse(argv)
    except SystemExit as exc:
        return int(exc.code or 0)
    multi_process = (cfg.coordinator_address is not None
                     or (cfg.num_processes or 1) > 1)
    world = mesh_lib.resolve_num_devices(cfg.num_devices, cfg.device)
    if (world > 1 or multi_process) and (cfg.resume_training
                                         or cfg.fault_spec):
        print("--resume_training and --fault_spec on more than one rank "
              "are not ported yet (ROADMAP.md)", file=sys.stderr)
        return 2
    if world > 1 and not multi_process:
        # Every rank must name the same experiment directory.
        if cfg.exp_hash is None:
            cfg.exp_hash = uuid.uuid4().hex[:9]
        mesh_lib.launch_ranks(_rank_main, world, (cfg,),
                              backend=mesh_lib.default_backend(cfg.device))
        return 0
    from ..faults.preempt import PreemptionRequested
    try:
        run_experiment(cfg)
    except PreemptionRequested:
        # The durable state is checkpointed and consistent: a preemption
        # is a clean exit, and --resume_training continues the run.
        return 0
    return 0
