"""The CIFAR-10 fine-tuning slice of the port against the JAX package, on
the CPU: the data, the checkpoint ingestion, the sweep's command lines
and the imbalanced CIFAR command end to end.

* Data.  The facsimile writers give the same archive from one seed, byte
  for byte (the gzip header's clock fixed on both sides); on one archive
  the CIFAR arrays, the per-class counts, the imbalanced indices and the
  ``cifar10``, ``imbalanced_cifar10`` and ``imbalanced_synthetic``
  triples are equal bit for bit, with ``debug_mode`` too.  The fetch
  path extracts through ``file://`` and refuses a bad md5 and a hostile
  member before unpacking anything.
* Ingestion.  The same fabricated checkpoints (a SimCLR CIFAR ResNet-18,
  a MoCo-v2 ResNet-50 in the published file's layout, a 7x7 checkpoint
  into an s2d-stem model) through the JAX ``apply_pretrained`` and the
  port's, from the same variables: equal leaf for leaf, bit for bit;
  the head keeps its init.
* The sweep.  ``gen_jobs.all_jobs()`` is the JAX package's with the CLI
  name swapped; every CIFAR command parses in the port's CLI and every
  ImageNet one exits 2 naming ROADMAP.md.
* The slice.  The port's CLI and the JAX CLI with ``gen_jobs``'
  imbalanced CIFAR flags (RandomSampler, 2 rounds) on a small facsimile
  and a fabricated ``simclr_imb_pretrain0_1.tar`` under
  ``--pretrained_root``: the imbalanced train set, the round-0 pool,
  ``eval_idxs`` and the round-1 picks equal bit for bit; both rounds
  tested; the best checkpoints load in the JAX package.  In process, the
  variables after each package's overlay are equal leaf for leaf.
"""

from __future__ import annotations

import gzip
import io
import json
import os
import shlex
import subprocess
import sys
import tarfile
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from active_learning_tpu.config import ImbalanceConfig as JaxImbalanceConfig
from active_learning_tpu.config import \
    PretrainedConfig as JaxPretrainedConfig
from active_learning_tpu.data import cifar10 as jax_cifar10
from active_learning_tpu.data import facsimile as jax_facsimile
from active_learning_tpu.data import get_data as jax_get_data
from active_learning_tpu.data import imbalance as jax_imbalance
from active_learning_tpu.experiment import gen_jobs as jax_gen_jobs
from active_learning_tpu.models import resnet as jax_resnet
from active_learning_tpu.train import checkpoint as jax_ckpt
from active_learning_tpu.utils import pretrained as jax_pretrained

import active_learning_tpu_torch.__main__ as port_main
from active_learning_tpu_torch.config import ImbalanceConfig, PretrainedConfig
from active_learning_tpu_torch.data import cifar10, facsimile, get_data
from active_learning_tpu_torch.data import imbalance
from active_learning_tpu_torch.experiment import cli, gen_jobs
from active_learning_tpu_torch.models import resnet
from active_learning_tpu_torch.models.weights import (load_flax_variables,
                                                      to_flax_variables)
from active_learning_tpu_torch.utils import pretrained

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parity import (TorchBasicBlock, TorchBottleneck,  # noqa: E402
                               TorchEncoder, TorchSSLNet)

TGZ = "cifar-10-python.tar.gz"


@pytest.fixture
def fixed_gzip_clock(monkeypatch):
    """gzip writes the current time into its header: fix it, so that two
    archives written a second apart can be equal byte for byte."""
    monkeypatch.setattr(gzip, "time", types.SimpleNamespace(
        time=lambda: 1_700_000_000.0))


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """One small facsimile, fetched through file:// by the port."""
    root = tmp_path_factory.mktemp("cifar")
    path, md5 = facsimile.write_cifar10_facsimile(
        str(root / "arch" / TGZ), n_train=1000, n_test=200, seed=5)
    data = str(root / "data")
    cifar10.fetch_cifar10(data, url=f"file://{path}", expected_md5=md5)
    return path, md5, data


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("n_train,n_test,seed", [(300, 70, 5), (1003, 11, 9)])
def test_facsimile_archive_equals_jax_byte_for_byte(tmp_path, n_train,
                                                    n_test, seed,
                                                    fixed_gzip_clock):
    got = facsimile.write_cifar10_facsimile(
        str(tmp_path / "port" / TGZ), n_train=n_train, n_test=n_test,
        seed=seed, noise_sigma=40.0, contrast=0.5)
    want = jax_facsimile.write_cifar10_facsimile(
        str(tmp_path / "jax" / TGZ), n_train=n_train, n_test=n_test,
        seed=seed, noise_sigma=40.0, contrast=0.5)
    assert got[1] == want[1]
    with open(got[0], "rb") as a, open(want[0], "rb") as b:
        assert a.read() == b.read()


def test_cifar10_arrays_match_jax(archive):
    _, _, data = archive
    got = cifar10.load_cifar10_arrays(data)
    want = jax_cifar10.load_cifar10_arrays(data)
    for (gi, gt), (wi, wt) in zip(got, want):
        assert gi.dtype == wi.dtype == np.uint8
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)
    assert got[0][0].shape == (1000, 32, 32, 3)


def _same_triple(got, want):
    for g, w in zip(got, want):
        assert len(g) == len(w)
        assert g.num_classes == w.num_classes
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.targets, w.targets)
        np.testing.assert_array_equal(g.gather(np.arange(len(g))),
                                      w.gather(np.arange(len(w))))
        assert (g.view.augment, g.view.pad) == (w.view.augment, w.view.pad)
        assert (g.view.normalization.mean, g.view.normalization.std) == (
            w.view.normalization.mean, w.view.normalization.std)
    assert got[2].images is got[0].images  # al and train share storage


@pytest.mark.parametrize("debug_mode", [False, True])
def test_cifar10_triple_matches_jax(archive, debug_mode):
    _, _, data = archive
    _same_triple(get_data("cifar10", data_path=data, debug_mode=debug_mode),
                 jax_get_data("cifar10", data_path=data,
                              debug_mode=debug_mode))


@pytest.mark.parametrize("kind,factor,n,classes", [
    ("exp", 0.1, 50000, 10), ("exp", 0.01, 50000, 10), ("exp", 0.1, 1000, 10),
    ("step", 0.1, 50000, 10), ("step", 0.5, 999, 7), ("exp", 0.3, 130, 4)])
def test_img_num_per_cls_matches_jax(kind, factor, n, classes):
    assert imbalance.img_num_per_cls(n, classes, kind, factor) == \
        jax_imbalance.img_num_per_cls(n, classes, kind, factor)
    with pytest.raises(ValueError):
        imbalance.img_num_per_cls(n, classes, "linear", factor)


@pytest.mark.parametrize("seed", [0, 3])
def test_imbalanced_indices_match_jax(seed):
    targets = np.random.default_rng(seed + 10).integers(0, 10, 2000)
    counts = imbalance.img_num_per_cls(2000, 10, "exp", 0.1)
    np.testing.assert_array_equal(
        imbalance.imbalanced_indices(targets, counts, seed),
        jax_imbalance.imbalanced_indices(targets, counts, seed))


@pytest.mark.parametrize("debug_mode", [False, True])
@pytest.mark.parametrize("kind,factor,seed", [("exp", 0.1, 0),
                                              ("step", 0.01, 2)])
def test_imbalanced_cifar10_triple_matches_jax(archive, kind, factor, seed,
                                               debug_mode):
    _, _, data = archive
    got = get_data("imbalanced_cifar10", data_path=data,
                   debug_mode=debug_mode,
                   imbalance_args=ImbalanceConfig(kind, factor, seed))
    want = jax_get_data("imbalanced_cifar10", data_path=data,
                        debug_mode=debug_mode,
                        imbalance_args=JaxImbalanceConfig(kind, factor,
                                                          seed))
    _same_triple(got, want)
    if not debug_mode:
        # A class with fewer rows than its count keeps all of them.
        have = np.bincount(cifar10.load_cifar10_arrays(data)[0][1],
                           minlength=10)
        want_counts = np.minimum(have, imbalance.img_num_per_cls(
            1000, 10, kind, factor))
        np.testing.assert_array_equal(
            np.bincount(got[0].targets, minlength=10), want_counts)


@pytest.mark.parametrize("debug_mode", [False, True])
def test_imbalanced_synthetic_triple_matches_jax(debug_mode):
    args = dict(n_train=400, num_classes=5, image_size=8, seed=3)
    got = get_data("imbalanced_synthetic", debug_mode=debug_mode,
                   imbalance_args=ImbalanceConfig("exp", 0.2, 1), **args)
    want = jax_get_data("imbalanced_synthetic", debug_mode=debug_mode,
                        imbalance_args=JaxImbalanceConfig("exp", 0.2, 1),
                        **args)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.targets, w.targets)


def test_fetch_extracts_through_a_file_url(archive, tmp_path):
    path, md5, _ = archive
    dest = str(tmp_path / "data")
    root = cifar10.fetch_cifar10(dest, url=f"file://{path}",
                                 expected_md5=md5)
    assert root == os.path.join(dest, "cifar-10-batches-py")
    assert sorted(os.listdir(root)) == sorted(
        [f"data_batch_{i}" for i in range(1, 6)]
        + ["test_batch", "batches.meta"])
    # An existing extraction is returned as it is: no second fetch.
    assert cifar10.fetch_cifar10(dest, url="file:///nonexistent") == root
    assert cifar10.find_cifar10_root(dest) == root


def test_fetch_refuses_a_bad_md5_before_unpacking(archive, tmp_path):
    path, _, _ = archive
    dest = str(tmp_path / "data")
    with pytest.raises(RuntimeError, match="md5"):
        cifar10.fetch_cifar10(dest, url=f"file://{path}",
                              expected_md5="0" * 32)
    assert os.listdir(dest) == []


@pytest.mark.parametrize("member", ["../outside", "/abs/outside",
                                    "cifar-10-batches-py/link"])
def test_fetch_refuses_a_hostile_member(tmp_path, member):
    evil = str(tmp_path / "evil.tar.gz")
    with tarfile.open(evil, "w:gz") as tar:
        info = tarfile.TarInfo(member)
        if member.endswith("link"):
            info.type, info.linkname = tarfile.SYMTYPE, "/etc/passwd"
        else:
            info.size = 1
        tar.addfile(info, io.BytesIO(b"x") if info.size else None)
    dest = tmp_path / "d"
    with pytest.raises(RuntimeError, match="suspicious"):
        cifar10.fetch_cifar10(str(dest), url=f"file://{evil}",
                              expected_md5=None)
    assert os.listdir(dest) == []
    assert not (tmp_path / "outside").exists()


def test_get_data_fetches_with_download(archive, tmp_path, monkeypatch):
    path, md5, _ = archive
    monkeypatch.setattr(cifar10, "CIFAR10_URL", f"file://{path}")
    monkeypatch.setattr(cifar10, "CIFAR10_TGZ_MD5", md5)
    train, test, al = get_data("cifar10", data_path=str(tmp_path / "d"),
                               download=True)
    assert (len(train), len(test)) == (1000, 200)
    assert train.view.augment and not al.view.augment
    with pytest.raises(FileNotFoundError, match="download"):
        cifar10.find_cifar10_root(str(tmp_path / "nope"))


# -- ingestion ----------------------------------------------------------------

def _randomize(module: torch.nn.Module, seed: int) -> None:
    """Seeded weights and running statistics (two training-mode passes)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    module.train()
    with torch.no_grad():
        for _ in range(2):
            module(torch.randn(2, 3, 32, 32, generator=g))
    module.eval()


def _jax_variables(model, hw=32):
    x = jnp.zeros((1, hw, hw, 3), jnp.float32)
    return jax.tree.map(np.asarray, dict(model.init(
        jax.random.PRNGKey(0), x, train=False)))


def _overlay_both(jmodel, port_model, cfg_kwargs, path):
    """The JAX ``apply_pretrained`` and the port's from the same
    variables: (JAX result, the port's as a flax tree, the start)."""
    variables = _jax_variables(jmodel)
    want = jax_pretrained.apply_pretrained(
        variables, JaxPretrainedConfig(path=path, **cfg_kwargs))
    port_model = port_model.to(memory_format=torch.channels_last)
    load_flax_variables(port_model, variables)
    pretrained.apply_pretrained(port_model,
                                PretrainedConfig(path=path, **cfg_kwargs))
    return want, to_flax_variables(port_model.state_dict()), variables


def _equal_leaf_for_leaf(got, want):
    fg, fw = flatten_dict(got), flatten_dict(want)
    assert set(fg) == set(fw)
    for k in fw:
        assert fg[k].dtype == np.asarray(fw[k]).dtype, k
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=str(k))


SIMCLR = dict(required_key=("encoder",), skip_key=("linear",))
MOCO = dict(required_key=("encoder_q",), skip_key=("fc",),
            replace_key=(("encoder_q", "encoder"),))


def test_simclr_resnet18_overlay_matches_jax(tmp_path):
    net = TorchSSLNet(TorchBasicBlock, [2, 2, 2, 2])
    _randomize(net, 1)
    path = str(tmp_path / "simclr.pth.tar")
    torch.save(net.state_dict(), path)
    want, got, start = _overlay_both(
        jax_resnet.resnet18(num_classes=10, cifar_stem=True),
        resnet.resnet18(10, cifar_stem=True), SIMCLR, path)
    _equal_leaf_for_leaf(got, want)
    # The head kept its init; the encoder is the checkpoint's.
    for leaf in ("kernel", "bias"):
        np.testing.assert_array_equal(got["params"]["linear"][leaf],
                                      start["params"]["linear"][leaf])
    np.testing.assert_array_equal(
        got["params"]["encoder"]["conv_stem"]["kernel"],
        net.encoder.conv1.weight.detach().numpy().transpose(2, 3, 1, 0))


def _moco_checkpoint(path: str, seed: int) -> dict:
    """MoCo-v2's published layout: ``{"epoch", "arch", "state_dict",
    "optimizer"}`` with ``module.encoder_q.*`` (ResNet-50 with the v2
    MLP head ``fc.0``/``fc.2``), a momentum copy ``module.encoder_k.*``
    and the ``module.queue``/``queue_ptr`` buffers."""
    enc = TorchEncoder(TorchBottleneck, [3, 4, 6, 3], cifar_stem=False)
    _randomize(enc, seed)
    g = torch.Generator().manual_seed(seed + 1)
    sd = {k: v.clone() for k, v in enc.state_dict().items()}
    sd["fc.0.weight"] = torch.randn(2048, 2048, generator=g)
    sd["fc.0.bias"] = torch.randn(2048, generator=g)
    sd["fc.2.weight"] = torch.randn(128, 2048, generator=g)
    sd["fc.2.bias"] = torch.randn(128, generator=g)
    state = {f"module.encoder_q.{k}": v for k, v in sd.items()}
    state.update({f"module.encoder_k.{k}": v * 0.5 for k, v in sd.items()})
    state["module.queue"] = torch.randn(128, 4096, generator=g)
    state["module.queue_ptr"] = torch.zeros(1, dtype=torch.long)
    torch.save({"epoch": 800, "arch": "resnet50", "state_dict": state,
                "optimizer": {"param_groups": []}}, path)
    return state


def test_moco_v2_resnet50_overlay_matches_jax(tmp_path):
    path = str(tmp_path / "moco_v2_800ep_pretrain.pth.tar")
    state = _moco_checkpoint(path, 11)
    survivors = pretrained.surgery(state, **{
        "required_key": MOCO["required_key"], "skip_key": MOCO["skip_key"],
        "replace_map": dict(MOCO["replace_key"])})
    mapped = {k: pretrained.torch_key_to_port(k) for k in survivors}
    assert sum(v is None for v in mapped.values()) == 53  # BN counters
    model = resnet.resnet50(10, cifar_stem=False)
    keys = set(model.state_dict())
    targets = [v for v in mapped.values() if v is not None]
    assert len(set(targets)) == len(targets)
    # Every encoder tensor of the model is covered, nothing else.
    assert set(targets) == {k for k in keys if k.startswith("encoder.")}
    want, got, start = _overlay_both(
        jax_resnet.resnet50(num_classes=10, cifar_stem=False),
        model, MOCO, path)
    _equal_leaf_for_leaf(got, want)
    np.testing.assert_array_equal(got["params"]["linear"]["kernel"],
                                  start["params"]["linear"]["kernel"])


def test_7x7_checkpoint_folds_into_an_s2d_model_as_jax(tmp_path):
    enc = TorchEncoder(TorchBasicBlock, [2, 2, 2, 2], cifar_stem=False)
    _randomize(enc, 4)
    path = str(tmp_path / "imagenet_r18.pth.tar")
    torch.save({"state_dict": {f"module.encoder.{k}": v
                               for k, v in enc.state_dict().items()}}, path)
    want, got, _ = _overlay_both(
        jax_resnet.resnet18(num_classes=10, cifar_stem=False, stem="s2d"),
        resnet.resnet18(10, cifar_stem=False, stem="s2d"),
        dict(required_key=("encoder",)), path)
    assert got["params"]["encoder"]["conv_stem"]["kernel"].shape == \
        (4, 4, 12, 64)
    _equal_leaf_for_leaf(got, want)


def test_overlay_refuses_what_jax_refuses(tmp_path):
    model = resnet.resnet18(10, cifar_stem=True)
    bad_shape = {"encoder.conv1.weight": torch.zeros(64, 3, 7, 7)}
    with pytest.raises(ValueError, match="Shape mismatch"):
        pretrained.overlay_torch_state(model, bad_shape)
    unknown = {"encoder.layer1.0.conv1.bias": torch.zeros(64)}
    with pytest.raises(KeyError):
        pretrained.overlay_torch_state(model, unknown)
    with pytest.raises(KeyError):
        jax_pretrained.torch_key_to_flax("encoder.layer1.0.conv1.bias")
    assert pretrained.overlay_torch_state(model, unknown, strict=False) == 0
    deeper = {"encoder.layer3.2.conv1.weight": torch.zeros(256, 256, 3, 3)}
    with pytest.raises(KeyError, match="absent"):
        pretrained.overlay_torch_state(model, deeper)


# -- the sweep's commands -----------------------------------------------------

def test_gen_jobs_are_the_jax_packages_for_the_port_cli():
    want = [j.replace(jax_gen_jobs.CLI, gen_jobs.CLI, 1)
            for j in jax_gen_jobs.all_jobs("/data")]
    assert gen_jobs.all_jobs("/data") == want
    assert len(want) == 38
    assert gen_jobs.run_argv({"a": 1, "b": True, "c": None, "d": False}) \
        == ["--a", "1", "--b"]


def test_gen_jobs_prints_the_commands_and_refuses_the_fleet_format(capsys):
    gen_jobs.main(["/data"])
    assert capsys.readouterr().out.splitlines() == gen_jobs.all_jobs("/data")
    with pytest.raises(SystemExit) as exc:
        gen_jobs.main(["/data", "--format", "fleet"])
    assert exc.value.code == 2
    assert "ROADMAP.md" in capsys.readouterr().err


def test_every_cifar_command_parses_and_imagenet_exits_2(capsys):
    """Every command of the sweep parses, the ImageNet ones too now that
    their loaders are ported (the name is from when they exited 2); what
    still exits 2 is a flag the port does not carry, such as the
    resident train feed."""
    for job in gen_jobs.all_jobs("/data"):
        argv = shlex.split(job)[3:]
        cfg = cli.parse(argv)
        if cfg.dataset == "imagenet":
            assert cfg.dataset_dir == "/data" and cfg.model == "SSLResNet50"
            assert port_main.main(argv + ["--train_feed", "resident"]) == 2
            assert "ROADMAP.md" in capsys.readouterr().err
            continue
        assert cfg.dataset_dir == "/data" and cfg.download_data
        assert cfg.model == "SSLResNet18" and cfg.n_epoch == 200
        if cfg.dataset == "imbalanced_cifar10":
            assert (cfg.imbalance.imbalance_type,
                    cfg.imbalance.imbalance_factor) == ("exp", 0.1)


# -- the slice ----------------------------------------------------------------

SLICE_FLAGS = [
    "--dataset", "imbalanced_cifar10",
    "--arg_pool", "ssp_finetuning_imbalanced_cifar10_imb_0_1",
    "--imbalance_type", "exp", "--imbalance_factor", "0.1",
    "--strategy", "RandomSampler", "--model", "SSLResNet18",
    "--rounds", "2", "--round_budget", "50", "--init_pool_size", "50",
    "--n_epoch", "2", "--early_stop_patience", "50", "--exp_hash", "imb0"]


@pytest.fixture(scope="module")
def slice_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    path, md5 = facsimile.write_cifar10_facsimile(
        str(root / "arch" / TGZ), n_train=2500, n_test=300, seed=3)
    data = str(root / "data")
    cifar10.fetch_cifar10(data, url=f"file://{path}", expected_md5=md5)
    net = TorchSSLNet(TorchBasicBlock, [2, 2, 2, 2])
    _randomize(net, 2)
    ckpt_dir = root / "pre" / "pretrained_ckpt" / "cifar10"
    os.makedirs(ckpt_dir)
    torch.save(net.state_dict(), str(ckpt_dir / "simclr_imb_pretrain0_1.tar"))
    return root, data, str(root / "pre")


def _cli(package, root, data, pre, extra=()):
    out = root / package
    cmd = [sys.executable, "-m", package, *SLICE_FLAGS, "--dataset_dir",
           data, "--pretrained_root", pre, "--log_dir", str(out / "logs"),
           "--ckpt_path", str(out / "ckpt"), *extra]
    env = dict(os.environ, OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return out, subprocess.Popen(cmd, cwd=REPO, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _picks(out, rd):
    text = (out / "logs" / "assets" / f"labeled_idxs_on_rd_{rd}.txt")
    return np.array([int(v) for v in text.read_text().split(",")])


def test_imbalanced_cifar_cli_matches_jax(slice_inputs):
    root, data, pre = slice_inputs
    runs = [_cli("active_learning_tpu_torch", root, data, pre,
                 ["--device", "cpu"]),
            _cli("active_learning_tpu", root, data, pre)]
    outs = []
    for out, proc in runs:
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-3000:]
        outs.append((out, err))
    (port, port_err), (ref, _) = outs
    assert "Overlaid 100 pretrained tensors" in port_err
    for rd in (0, 1):
        np.testing.assert_array_equal(_picks(port, rd), _picks(ref, rd))
    exp = "active_learning_imb0"
    got = np.load(port / "ckpt" / exp / "experiment_state.npz")
    want = np.load(ref / "ckpt" / exp / "experiment_state.npz")
    for key in ("n_pool", "labeled", "eval_idxs", "recent"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # The imbalanced train set: the pool is its rows, in JAX's order.
    assert int(got["n_pool"]) == sum(imbalance.img_num_per_cls(
        2500, 10, "exp", 0.1))
    tested = {e["step"] for e in map(json.loads, (
        port / "logs" / "metrics.jsonl").read_text().splitlines())
        if e["kind"] == "metric" and "rd_test_accuracy" in e["metrics"]}
    assert tested == {0, 1}
    for rd in (0, 1):
        best = jax_ckpt.load_variables(
            str(port / "ckpt" / exp / f"best_rd_{rd}.msgpack"))
        assert best["params"]["linear"]["kernel"].shape == (512, 10)


def test_overlaid_variables_match_jax_in_process(slice_inputs, tmp_path):
    """Both drivers' ``build_experiment`` from the same flags, then
    ``init_network_weights``: the encoder's variables (parameters and
    running statistics) are the checkpoint's in both, leaf for leaf; the
    head is each package's own random init."""
    from active_learning_tpu.experiment import cli as jax_cli
    from active_learning_tpu.experiment.driver import \
        build_experiment as jax_build
    from active_learning_tpu_torch.experiment.driver import build_experiment

    root, data, pre = slice_inputs
    flags = SLICE_FLAGS + ["--dataset_dir", data, "--pretrained_root", pre,
                           "--log_dir", str(tmp_path), "--ckpt_path",
                           str(tmp_path)]
    port = build_experiment(cli.parse(flags + ["--device", "cpu"]))
    jax_strat = jax_build(jax_cli.args_to_config(
        jax_cli.get_parser().parse_args(flags)))
    port.init_network_weights()
    jax_strat.init_network_weights()
    np.testing.assert_array_equal(port.pool.eval_idxs,
                                  jax_strat.pool.eval_idxs)
    np.testing.assert_array_equal(port.pool.labeled_mask(),
                                  jax_strat.pool.labeled)
    got = flatten_dict(to_flax_variables(port.model.state_dict()))
    want = flatten_dict(jax.tree.map(np.asarray,
                                     dict(jax_strat.state.variables)))
    enc = [k for k in want if "encoder" in k]
    assert len(enc) == 100
    for k in enc:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
