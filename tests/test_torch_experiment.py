"""The port's experiment path against the JAX package, on the CPU: the
MarginSampler query, the command line, and the saved experiment state.

* A MarginSampler ``query`` on carried weights picks what the JAX step's
  margins pick, wherever the margin gap between neighbours in the sorted
  order exceeds 1e-5 (the same float32 network in another summation
  order moves a margin by ~1e-6; closer margins may swap).
* The CLI run (``--device cpu``, synthetic, 2 rounds) exits 0, and its
  round-0 labeled and eval indices are the JAX package's for the same
  flags, bit for bit (both come from numpy draws on the same seeds).
* Each geometry sampler (MASE, BASE, Coreset, BADGE and the partitioned
  two), and Balancing, MarginClustering and VAAL, runs the CLI for 2
  rounds on the CPU: exit 0, and the round-1 query labels distinct rows
  outside round 0's and the eval split; VAAL also saves
  ``aux_state.msgpack``.  The VAAL flags carry the JAX CLI's names and
  defaults.
* ``TrainConfig.score_batch_size`` set in an arg pool is the batch the
  scoring pass uses.
* ``--stem s2d`` runs: a 10-class dataset keeps the CIFAR stem, and the
  flag echoes into ``experiment_state.json``.
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
from active_learning_tpu_torch.registry import ARG_POOLS
from active_learning_tpu_torch.strategies import base as strategy_base
from active_learning_tpu_torch.models.weights import load_flax_variables
from active_learning_tpu_torch.train import checkpoint as ckpt_lib
from active_learning_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parity import TorchBasicBlock, TorchSSLNet  # noqa: E402
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
    ["--metrics_backend", "csv"], ["--round_pipeline", "speculative"],
    ["--train_feed", "resident"], ["--pool_backend", "disk"],
    ["--resident_scoring_bytes", "0"], ["--pool_sharding", "row"]])
def test_flags_not_ported_exit_2_naming_the_roadmap(flags, capsys):
    # argparse keeps the last value of a repeated flag.
    assert port_main.main(CLI_FLAGS + ["--device", "cpu"] + flags) == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err or "has no entry" in err


@pytest.mark.parametrize("spec", ["kill@1", "ckpt_write:explode",
                                  "nosuch:raise@1"])
def test_malformed_fault_spec_fails_fast(spec, capsys):
    """As the JAX package's parse_spec does: a spec that would arm
    nothing exits 2 before anything runs."""
    assert port_main.main(CLI_FLAGS + ["--device", "cpu", "--fault_spec",
                                       spec]) == 2
    assert "--fault_spec" in capsys.readouterr().err


def test_recovery_flags_on_more_than_one_rank_exit_2(capsys):
    assert port_main.main(CLI_FLAGS + ["--device", "cpu", "--num_devices",
                                       "2", "--resume_training"]) == 2
    assert "ROADMAP.md" in capsys.readouterr().err


def test_cli_stem_s2d_runs_and_echoes_on_cpu(tmp_path):
    """``--stem s2d`` is carried: on the synthetic dataset (10 classes)
    the model keeps the CIFAR stem, as in the JAX package, and the flag
    echoes into ``experiment_state.json``, where ``serve`` reads it."""
    assert cli.parse(CLI_FLAGS).stem is None
    assert cli.parse(CLI_FLAGS + ["--stem", "s2d"]).stem == "s2d"
    flags = list(CLI_FLAGS)
    flags[flags.index("--rounds") + 1] = "1"
    flags[flags.index("--n_epoch") + 1] = "1"
    cmd = [sys.executable, "-m", "active_learning_tpu_torch", *flags,
           "--stem", "s2d", "--device", "cpu",
           "--log_dir", str(tmp_path / "logs"),
           "--ckpt_path", str(tmp_path / "ckpt")]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    exp_dir = tmp_path / "ckpt" / "active_learning_cpu0"
    meta = json.loads((exp_dir / "experiment_state.json").read_text())
    assert meta["config"]["stem"] == "s2d"
    best = jax_ckpt.load_variables(str(exp_dir / "best_rd_0.msgpack"))
    assert best["params"]["encoder"]["conv_stem"]["kernel"].shape == \
        (3, 3, 3, 64)
    from active_learning_tpu_torch.serve import cli as serve_cli
    model, _, _, _ = serve_cli.resolve_serve_setup(
        serve_cli.get_parser().parse_args(
            ["--experiment_dir", str(exp_dir), "--device", "cpu"]))
    assert model.stem == "default" and model.cifar_stem


def test_bn_eval_training_into_the_encoder_raises(tmp_path):
    """Pretrained fine-tuning is ported, so nothing raises: a configured
    checkpoint loads (the encoder becomes the checkpoint's, the head
    keeps its init) and one fine-tuning step (BN in eval mode,
    gradients into the encoder) runs through kernel B′'s plain version
    and moves the encoder's parameters but not its running
    statistics."""
    from active_learning_tpu_torch.utils.pretrained import apply_pretrained

    model = resnet.SSLClassifier((1, 1), resnet.BasicBlock, 4,
                                 cifar_stem=True)
    model = model.to(memory_format=torch.channels_last)
    # A SimCLR-layout checkpoint (torchvision names, encoder.* and a
    # linear.* to skip) with seeded weights and running statistics.
    gen = torch.Generator().manual_seed(3)
    ckpt = {k: (torch.rand(v.shape, generator=gen) + 0.5
                if k.endswith("running_var") else
                torch.rand(v.shape, generator=gen) - 0.5)
            if v.is_floating_point() else v
            for k, v in TorchSSLNet(TorchBasicBlock, [1, 1],
                                    num_classes=4).state_dict().items()}
    path = str(tmp_path / "simclr.pth.tar")
    torch.save(ckpt, path)
    cfg = TrainConfig(pretrained=PretrainedConfig(
        path=path, required_key=("encoder",), skip_key=("linear",)))
    head = model.linear.weight.detach().clone()
    counters = sum(k.endswith("num_batches_tracked") for k in ckpt)
    assert apply_pretrained(model, cfg.pretrained) == len(ckpt) - 2 - counters
    assert torch.equal(model.encoder.conv_stem.weight, ckpt[
        "encoder.conv1.weight"])
    assert torch.equal(model.linear.weight, head)

    trainer = Trainer(model, cfg, 4, "cpu")
    assert not trainer.train_bn
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.named_buffers()}
    model.train(trainer.train_bn)
    rng = np.random.default_rng(0)
    batch = trainer.to_device({
        "image": rng.integers(0, 256, (8, 8, 8, 3), dtype=np.uint8),
        "label": rng.integers(0, 4, 8).astype(np.int32),
        "mask": np.ones(8, np.float32)})
    from active_learning_tpu_torch.data.core import SYNTH_NORM, ViewSpec
    loss, gnorm = trainer.train_step(batch, 0.1, torch.ones(4),
                                     ViewSpec(SYNTH_NORM), None)
    assert np.isfinite(float(loss)) and float(gnorm) > 0
    for k, v in model.named_parameters():
        assert not torch.equal(v, params[k]), k
    for k, v in model.named_buffers():
        assert torch.equal(v, stats[k]), k


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


def test_cli_carries_the_coreset_flags_with_the_jax_defaults():
    from active_learning_tpu.experiment.cli import get_parser as jax_parser
    cfg = cli.parse(CLI_FLAGS)
    jax_args = jax_parser().parse_args(CLI_FLAGS)
    for name in ("subset_labeled", "subset_unlabeled", "partitions",
                 "kcenter_batch"):
        assert getattr(cfg, name) == getattr(jax_args, name), name
    assert (cfg.subset_labeled, cfg.subset_unlabeled, cfg.partitions,
            cfg.kcenter_batch) == (None, None, 1, 8)
    cfg = cli.parse(CLI_FLAGS + ["--subset_labeled", "5",
                                 "--subset_unlabeled", "40",
                                 "--partitions", "3", "--kcenter_batch", "2"])
    assert (cfg.subset_labeled, cfg.subset_unlabeled, cfg.partitions,
            cfg.kcenter_batch) == (5, 40, 3, 2)


GEOMETRY = [("MASESampler", []), ("BASESampler", []),
            ("CoresetSampler", []), ("BADGESampler", []),
            ("PartitionedCoresetSampler", ["--partitions", "3"]),
            ("PartitionedBADGESampler", ["--partitions", "3"])]


def _two_rounds_on_cpu(tmp_path, strategy, extra):
    flags = [f for f in CLI_FLAGS if f != "MarginSampler"]
    flags[flags.index("--strategy") + 1:flags.index("--strategy") + 1] = [
        strategy]
    flags[flags.index("--n_epoch") + 1] = "1"
    cmd = [sys.executable, "-m", "active_learning_tpu_torch", *flags,
           *extra, "--device", "cpu", "--log_dir", str(tmp_path / "logs"),
           "--ckpt_path", str(tmp_path / "ckpt")]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assets = tmp_path / "logs" / "assets"
    rounds = [np.array([int(v) for v in (
        assets / f"labeled_idxs_on_rd_{r}.txt").read_text().split(",")])
        for r in (0, 1)]
    assert len(rounds[1]) == 16 and np.unique(rounds[1]).size == 16
    assert not np.isin(rounds[1], rounds[0]).any()
    state = np.load(tmp_path / "ckpt" / "active_learning_cpu0"
                    / "experiment_state.npz")
    assert not np.isin(rounds[1], state["eval_idxs"]).any()
    assert int(state["labeled"].sum()) == 32


@pytest.mark.parametrize("strategy,extra", GEOMETRY,
                         ids=[g[0] for g in GEOMETRY])
def test_geometry_sampler_cli_runs_two_rounds_on_cpu(tmp_path, strategy,
                                                     extra):
    _two_rounds_on_cpu(tmp_path, strategy, extra)


@pytest.mark.parametrize("strategy", ["BalancingSampler",
                                      "MarginClusteringSampler",
                                      "VAALSampler"])
def test_last_samplers_cli_run_two_rounds_on_cpu(tmp_path, strategy):
    _two_rounds_on_cpu(tmp_path, strategy, [])
    aux = tmp_path / "ckpt" / "active_learning_cpu0" / "aux_state.msgpack"
    assert aux.exists() == (strategy == "VAALSampler")
    if aux.exists():
        tree = ckpt_lib.msgpack_restore(aux.read_bytes())
        assert sorted(tree) == ["d_opt", "d_params", "vae_opt", "vae_params",
                                "vae_stats"]
        assert tree["vae_params"]["fc_mu"]["kernel"].shape == (1024 * 4, 64)


def test_cli_carries_the_vaal_flags_with_the_jax_defaults():
    from active_learning_tpu.experiment.cli import args_to_config as jax_cfg
    from active_learning_tpu.experiment.cli import get_parser as jax_parser
    for extra in ([], ["--vae_latent_dim", "32", "--adversary_param", "2.5",
                       "--lr_vae", "1e-4", "--lr_discriminator", "2e-3"],
                  ["--vaal_adversary_param", "3"]):
        cfg = cli.parse(CLI_FLAGS + extra)
        want = jax_cfg(jax_parser().parse_args(CLI_FLAGS + extra)).vaal
        for name in ("vae_latent_dim", "adversary_param", "lr_vae",
                     "lr_discriminator"):
            assert getattr(cfg.vaal, name) == getattr(want, name), name
    assert cli.parse(CLI_FLAGS).vaal.vae_latent_dim == 64


def test_score_batch_size_in_an_arg_pool_is_the_scoring_batch(tmp_path,
                                                              monkeypatch):
    """An arg pool's ``score_batch_size`` wins over the evaluation batch
    in ``collect_scores``, as ``Strategy._score_batch_size`` rules in the
    JAX package (it used to be dropped)."""
    name = "synthetic_score_batch_24"
    if name not in ARG_POOLS.names():
        ARG_POOLS.register(name, {"synthetic": TrainConfig(
            eval_split=0.1, loader_te=LoaderConfig(batch_size=32),
            score_batch_size=24)})
    data = get_data_synthetic(n_train=96, n_test=8, num_classes=4,
                              image_size=8, seed=5)
    seen = []
    real = strategy_base.gather_batch
    monkeypatch.setattr(strategy_base, "gather_batch",
                        lambda ds, b, bs, **kw: seen.append(bs)
                        or real(ds, b, bs, **kw))
    for pool, want in ((name, 24), ("synthetic", 100)):
        cfg = ExperimentConfig(dataset="synthetic", arg_pool=pool,
                               strategy="MASESampler", round_budget=8,
                               device="cpu", ckpt_path=str(tmp_path),
                               log_dir=str(tmp_path))
        model = resnet.SSLClassifier((1, 1), resnet.BasicBlock, 4,
                                     cifar_stem=True)
        strategy = driver.build_experiment(cfg, data=data, model=model)
        seen.clear()
        idxs = strategy.available_query_idxs(shuffle=False)
        out = strategy.collect_scores(idxs, "mase")
        assert len(out["min_margin"]) == len(idxs)
        assert seen and set(seen) == {want}, (pool, seen)
