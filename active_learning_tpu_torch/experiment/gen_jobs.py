"""The paper's experiment sweeps as shell commands for the port's CLI
(the JAX package's ``experiment/gen_jobs.py``, the reference's
``src/gen_jobs.py:3-145``): one pasteable
``python -m active_learning_tpu_torch ...`` line per experiment.

Three sweeps:

  * ImageNet linear evaluation: SSLResNet50, frozen features, 8 rounds x
    10k budget, 30k initial pool, 50k/80k subsets, 10 partitions;
  * ImageNet end-to-end fine-tuning: the same protocol, 60 epochs,
    patience 30;
  * CIFAR-10, balanced or imbalanced (exp, factor 0.1): SSLResNet18 from
    SimCLR weights, 30 rounds x 1k, 200 epochs, patience 50.

Every command runs on the port: the ImageNet ones read a JPEG tree
under ``dataset_dir`` (``data/imagenet.py``), with the MoCo-v2 checkpoint
under ``--pretrained_root``.  The JAX package's second
rendering, ``--format fleet`` (a fleet sweep spec), waits for the port's
fleet controller and exits 2 naming ROADMAP.md.

Run: ``python -m active_learning_tpu_torch.experiment.gen_jobs
[dataset_dir]``.
"""

from __future__ import annotations

import argparse
import sys
from itertools import product
from typing import Any, Dict, List, Optional, Sequence

IMAGENET_STRATEGIES = (
    "RandomSampler", "BalancedRandomSampler", "MASESampler",
    "MarginSampler", "ConfidenceSampler", "BASESampler", "VAALSampler",
    "PartitionedCoresetSampler", "PartitionedBADGESampler")

CIFAR_STRATEGIES = (
    "RandomSampler", "BalancedRandomSampler", "MASESampler",
    "MarginSampler", "ConfidenceSampler", "BASESampler",
    "BalancingSampler", "VAALSampler", "CoresetSampler", "BADGESampler")

CLI = "python -m active_learning_tpu_torch"


def run_argv(args: Dict[str, Any]) -> List[str]:
    """An arg dict as CLI tokens: ``{"strategy": "MarginSampler",
    "freeze_feature": True}`` -> ``["--strategy", "MarginSampler",
    "--freeze_feature"]``.  True is a bare store_true flag; False and
    None are left out (argparse defaults apply); anything else is
    stringified (the JAX package's ``fleet/spec.run_argv``)."""
    argv: List[str] = []
    for key, value in args.items():
        if value is None or value is False:
            continue
        if value is True:
            argv.append(f"--{key}")
        else:
            argv.extend((f"--{key}", str(value)))
    return argv


def _init_pool_type(strategy: str) -> str:
    return ("random_balance" if strategy == "BalancedRandomSampler"
            else "random")


def _render(args: Dict[str, Any]) -> str:
    return " ".join([CLI] + run_argv(args))


def imagenet_args(dataset_dir: str, arg_pool: str,
                  extra: Optional[Dict[str, Any]] = None
                  ) -> List[Dict[str, Any]]:
    """The ImageNet protocol's arg dicts, one per strategy, in the flag
    order of the printed commands."""
    jobs = []
    for strategy in IMAGENET_STRATEGIES:
        jobs.append({
            "dataset_dir": dataset_dir,
            "exp_name": f"{strategy}_arg_{arg_pool}_imagenet_b10000",
            "dataset": "imagenet", "arg_pool": arg_pool,
            "model": "SSLResNet50", "strategy": strategy,
            "rounds": 8, "round_budget": 10000,
            "init_pool_size": 30000,
            "subset_labeled": 50000, "subset_unlabeled": 80000,
            "partitions": 10, **(extra or {}),
            "init_pool_type": _init_pool_type(strategy)})
    return jobs


def linear_evaluation_imagenet_args(dataset_dir: str
                                    ) -> List[Dict[str, Any]]:
    return imagenet_args(dataset_dir, "ssp_linear_evaluation",
                         extra={"freeze_feature": True})


def end_to_end_imagenet_args_pretrained(dataset_dir: str
                                        ) -> List[Dict[str, Any]]:
    return imagenet_args(dataset_dir, "ssp_finetuning",
                         extra={"early_stop_patience": 30, "n_epoch": 60})


def cifar10_args(dataset_dir: str, number_of_runs: int = 1,
                 n_epoch: int = 200, rounds: int = 30,
                 imbalanced: bool = False,
                 round_budgets: Sequence[int] = (1000,)
                 ) -> List[Dict[str, Any]]:
    if imbalanced:
        dataset = "imbalanced_cifar10"
        arg_pool = "ssp_finetuning_imbalanced_cifar10_imb_0_1"
        imb: Dict[str, Any] = {"imbalance_factor": 0.1,
                               "imbalance_type": "exp"}
    else:
        dataset = "cifar10"
        arg_pool = "ssp_finetuning"
        imb = {}
    jobs = []
    for _, strategy, budget in product(range(number_of_runs),
                                       CIFAR_STRATEGIES, round_budgets):
        # --download_data makes every CIFAR job one command on a
        # networked machine (the reference's torchvision download=True).
        jobs.append({
            "dataset_dir": dataset_dir, "download_data": True,
            "exp_name": f"{strategy}_arg_{arg_pool}_{dataset}_b{budget}",
            "dataset": dataset, "arg_pool": arg_pool,
            "n_epoch": n_epoch, "early_stop_patience": 50,
            "model": "SSLResNet18", "strategy": strategy,
            "rounds": rounds, "round_budget": budget,
            "init_pool_size": budget, **imb,
            "init_pool_type": _init_pool_type(strategy)})
    return jobs


def linear_evaluation_imagenet_experiments(dataset_dir: str) -> List[str]:
    return [_render(a) for a in linear_evaluation_imagenet_args(dataset_dir)]


def end_to_end_imagenet_experiments_pretrained(dataset_dir: str
                                               ) -> List[str]:
    return [_render(a)
            for a in end_to_end_imagenet_args_pretrained(dataset_dir)]


def cifar10_experiments(dataset_dir: str, **kwargs: Any) -> List[str]:
    return [_render(a) for a in cifar10_args(dataset_dir, **kwargs)]


def all_jobs(dataset_dir: str = "<YOUR DATASET DIR HERE>") -> List[str]:
    return (linear_evaluation_imagenet_experiments(dataset_dir)
            + end_to_end_imagenet_experiments_pretrained(dataset_dir)
            + cifar10_experiments(dataset_dir)
            + cifar10_experiments(dataset_dir, imbalanced=True))


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m active_learning_tpu_torch.experiment.gen_jobs",
        description="Print the paper's experiment sweeps as shell "
                    "commands for the port's CLI")
    p.add_argument("dataset_dir", nargs="?",
                   default="<YOUR DATASET DIR HERE>")
    p.add_argument("--format", choices=["shell", "fleet"], default="shell",
                   dest="fmt")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    parser = get_parser()
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if args.fmt == "fleet":
        parser.error("--format fleet needs the fleet controller, which is "
                     "not ported yet (ROADMAP.md)")
    for job in all_jobs(args.dataset_dir):
        print(job)


if __name__ == "__main__":
    main()
