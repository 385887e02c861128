"""The port's experiment path against the JAX package, on the CPU: the
MarginSampler query, the command line, and the saved experiment state.

* A MarginSampler ``query`` on carried weights picks what the JAX step's
  margins pick, wherever the margin gap between neighbours in the sorted
  order exceeds 1e-5 (the same float32 network in another summation
  order moves a margin by ~1e-6; closer margins may swap).
* The CLI run (``--device cpu``, synthetic, 2 rounds) exits 0, and its
  round-0 labeled and eval indices are the JAX package's for the same
  flags, bit for bit (both come from numpy draws on the same seeds).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from active_learning_tpu.config import ExperimentConfig as JaxExperimentConfig
from active_learning_tpu.data.core import ViewSpec as JaxViewSpec
from active_learning_tpu.data.synthetic import SYNTH_NORM as JAX_SYNTH_NORM
from active_learning_tpu.strategies import scoring as jax_scoring
from active_learning_tpu.train import checkpoint as jax_ckpt

import active_learning_tpu_torch.__main__ as port_main
from active_learning_tpu_torch.config import (ExperimentConfig, LoaderConfig,
                                              PretrainedConfig, TrainConfig)
from active_learning_tpu_torch.data.synthetic import get_data_synthetic
from active_learning_tpu_torch.experiment import cli, driver
from active_learning_tpu_torch.models import resnet
from active_learning_tpu_torch.models.weights import load_flax_variables
from active_learning_tpu_torch.train import checkpoint as ckpt_lib
from active_learning_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_train import _tiny_pair  # noqa: E402

CLI_FLAGS = ["--dataset", "synthetic", "--arg_pool", "synthetic",
             "--strategy", "MarginSampler", "--rounds", "2",
             "--round_budget", "16", "--n_epoch", "2",
             "--early_stop_patience", "2", "--exp_hash", "cpu0"]


def test_margin_query_matches_jax(tmp_path):
    jmodel, variables, model = _tiny_pair(fused_stats=False, seed=3)
    data = get_data_synthetic(n_train=96, n_test=8, num_classes=4,
                              image_size=8, seed=5)
    cfg = ExperimentConfig(dataset="synthetic", strategy="MarginSampler",
                           round_budget=12, device="cpu",
                           ckpt_path=str(tmp_path), log_dir=str(tmp_path))
    train_cfg = TrainConfig(eval_split=0.1,
                            loader_te=LoaderConfig(batch_size=32))
    strategy = driver.build_experiment(cfg, data=data, train_cfg=train_cfg,
                                       model=model)
    load_flax_variables(model, variables)
    avail = strategy.available_query_idxs(shuffle=False)
    picks, cost = strategy.query(12)
    assert cost == 12

    step = jax_scoring.make_prob_stats_step(
        jmodel, JaxViewSpec(JAX_SYNTH_NORM, augment=False))
    margins = np.concatenate([
        np.asarray(step(variables, {"image": data[2].gather(avail[i:i + 32])}
                        )["margin"]) for i in range(0, len(avail), 32)])
    order = np.argsort(margins, kind="stable")
    ref = avail[order[:12]]
    sm = margins[order]
    gaps = np.diff(sm[:13])
    for i in range(12):
        clear = (i == 0 or gaps[i - 1] > 1e-5) and gaps[i] > 1e-5
        if clear:
            assert picks[i] == ref[i], i
    assert set(picks) == set(ref) or gaps[11] <= 1e-5


def _port_experiment(tmp_path):
    out = tmp_path / "port"
    cmd = [sys.executable, "-m", "active_learning_tpu_torch", *CLI_FLAGS,
           "--device", "cpu", "--log_dir", str(out / "logs"),
           "--ckpt_path", str(out / "ckpt")]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return out


def test_cli_run_on_cpu_matches_jax_round0(tmp_path):
    out = _port_experiment(tmp_path)
    exp_dir = out / "ckpt" / "active_learning_cpu0"
    state = np.load(exp_dir / "experiment_state.npz")
    meta = json.loads((exp_dir / "experiment_state.json").read_text())
    assert meta["round"] == 1 and meta["config"]["device"] == "cpu"
    round0 = np.array([int(v) for v in (
        out / "logs" / "assets" / "labeled_idxs_on_rd_0.txt"
    ).read_text().split(",")])

    # The JAX package, same flags: its driver's round-0 pool.
    from active_learning_tpu.experiment.cli import args_to_config, get_parser
    from active_learning_tpu.experiment.driver import build_experiment
    jcfg = args_to_config(get_parser().parse_args(
        CLI_FLAGS + ["--ckpt_path", str(tmp_path / "jax")]))
    assert isinstance(jcfg, JaxExperimentConfig)
    jstrat = build_experiment(jcfg)
    np.testing.assert_array_equal(np.sort(round0),
                                  np.flatnonzero(jstrat.pool.labeled))
    np.testing.assert_array_equal(state["eval_idxs"], jstrat.pool.eval_idxs)
    assert int(state["labeled"].sum()) == 32
    assert set(state) >= {"n_pool", "labeled", "eval_idxs", "recent",
                          "cumulative_cost", "round", "invalid", "init_key"}

    # Both rounds tested; best checkpoints load in the JAX package.
    tested = {e["step"] for e in map(json.loads, (
        out / "logs" / "metrics.jsonl").read_text().splitlines())
        if e["kind"] == "metric" and "rd_test_accuracy" in e["metrics"]}
    assert tested == {0, 1}
    best = jax_ckpt.load_variables(str(exp_dir / "best_rd_0.msgpack"))
    assert best["params"]["linear"]["kernel"].shape == (512, 10)
    assert ckpt_lib.read_best_tag(str(exp_dir / "best_rd_0.msgpack"))[0] == 0


def test_without_a_card_the_cli_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works here")
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_main.main(CLI_FLAGS + ["--log_dir", str(tmp_path),
                                    "--ckpt_path", str(tmp_path)])


@pytest.mark.parametrize("flags", [
    ["--resume_training"], ["--stem", "s2d"], ["--grad_allreduce", "int8"],
    ["--dataset", "cifar10"], ["--strategy", "CoresetSampler"],
    ["--arg_pool", "ssp_finetuning"]])
def test_flags_not_ported_exit_2_naming_the_roadmap(flags, capsys):
    # argparse keeps the last value of a repeated flag.
    assert port_main.main(CLI_FLAGS + ["--device", "cpu"] + flags) == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err or "has no entry" in err


def test_bn_eval_training_into_the_encoder_raises():
    """Pretrained fine-tuning (eval-mode BN, gradients into the encoder)
    is not ported: the trainer refuses it, and so does the model."""
    model = resnet.SSLClassifier((1, 1), resnet.BasicBlock, 4,
                                 cifar_stem=True)
    cfg = TrainConfig(pretrained=PretrainedConfig(path="moco.pth"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Trainer(model, cfg, 4, "cpu")
    model.eval()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        model(torch.zeros(2, 8, 8, 3))


def test_cli_parses_the_jax_flag_names():
    cfg = cli.parse(CLI_FLAGS + ["--model", "SSLResNet50", "--dtype",
                                 "float32", "--bn_stats_dtype", "bfloat16",
                                 "--fused_optimizer", "off",
                                 "--optim_state_dtype", "bf16",
                                 "--freeze_feature", "--init_pool_size", "8",
                                 "--init_pool_type", "random_balance",
                                 "--run_seed", "3", "--device", "cpu"])
    assert (cfg.model, cfg.dtype, cfg.bn_stats_dtype) == (
        "SSLResNet50", "float32", "bfloat16")
    assert (cfg.fused_optimizer, cfg.optim_state_dtype) == ("off", "bf16")
    assert cfg.freeze_feature and cfg.resolved_init_pool_size() == 8
    assert (cfg.init_pool_type, cfg.run_seed, cfg.device) == (
        "random_balance", 3, "cpu")
    assert (cfg.rounds, cfg.round_budget, cfg.n_epoch,
            cfg.early_stop_patience) == (2, 16, 2, 2)
