"""The port's VAAL against the JAX package, on the CPU.

Tolerances, each with its reason:

* The VAE and the discriminator on carried flax weights, crop 32 and 64
  (the deconv carry and both NHWC flattens), train and eval mode: every
  output within 2e-5 of its largest magnitude (float32 convolutions in
  another summation order; ~4e-6 seen), updated BatchNorm statistics
  likewise.
* ``fold_in`` and ``randint`` bit-equal to ``jax.random``'s, and the
  scoring window of a 224-px pool at crop 64 equal to JAX
  ``random_crop``'s.
* One co-step with the JAX step's own draws handed to the port (the
  viewed and cropped batches, the four forwards' noise): losses within
  1e-4 relative; the gradients, read from Adam's first moments
  (0.1·g after one step), within 1e-4 of the largest |g| of the model
  (VAE or discriminator), not of each leaf: a float32 ReLU decision on
  an activation within ~1e-5 of 0 can go the other way in another
  summation order and moves a few entries of that layer's input
  gradient by their full size (seed 0: one such flip in ``dec_bn1``
  puts ``dec_deconv1``'s kernel gradient 2e-5 from JAX's, of a largest
  5e-3 on the leaf and 1.6 over the VAE, while JAX's float32 step and
  the port's float64 step agree to 1e-9 there); BatchNorm running
  statistics within 1e-5 of their largest magnitude, from a second
  call at rates 0 (the discriminator step's forwards see the updated
  VAE, and the Adam signs below would move them).
  Adam's first step moves a weight by lr·g / (|g| + 1e-8), about lr·sign(g),
  so where |g| is within 10x the two gradients' largest difference on
  its leaf the sign is not determined by float32 and such a weight is
  only held to [p - lr, p + lr]; every other weight equals the JAX
  step's within 1e-3·lr plus 2 ulp.
* The score step's d_score within 1e-5 and ``query``'s picks equal to
  the JAX sampler's on the same VAAL weights; ``aux_state.msgpack``
  reads back with flax into the JAX sampler's tree, shapes and values.
* The numpy rng after ``train()`` equals the JAX sampler's, at
  ``tests/test_vaal.py``'s size with early stopping off and the
  co-steps stubbed in both (the co-step draws nothing from numpy).
"""

from __future__ import annotations

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from active_learning_tpu.data.augment import apply_view as jax_apply_view
from active_learning_tpu.data.core import ViewSpec as JaxViewSpec
from active_learning_tpu.data.synthetic import SYNTH_NORM as JAX_SYNTH_NORM
from active_learning_tpu.models import vaal as jv
from active_learning_tpu.parallel import mesh as mesh_lib
from active_learning_tpu.strategies import scoring as jax_scoring
from active_learning_tpu.strategies import vaal as jsv

from active_learning_tpu_torch.config import (ExperimentConfig, LoaderConfig,
                                              OptimizerConfig,
                                              SchedulerConfig, TrainConfig)
from active_learning_tpu_torch.data.synthetic import get_data_synthetic
from active_learning_tpu_torch.experiment import resume
from active_learning_tpu_torch.initial_pool import (generate_eval_idxs,
                                                    generate_init_lb_idxs)
from active_learning_tpu_torch.models import resnet
from active_learning_tpu_torch.models import vaal as tv
from active_learning_tpu_torch.models.weights import (adam_to_flax,
                                                      from_flax_vaal,
                                                      to_flax_vaal)
from active_learning_tpu_torch.pool import PoolState
from active_learning_tpu_torch.strategies import vaal as tsv
from active_learning_tpu_torch.train.trainer import Trainer
from active_learning_tpu_torch.utils import threefry

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from helpers import make_strategy  # noqa: E402
from test_torch_acquisition import _sampler_pair  # noqa: E402

Z = 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, scale_tol, what=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=scale_tol * scale, err_msg=what)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _with_stats(variables, seed):
    """Non-trivial running statistics, so eval mode is tested."""
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.normal(size=v.shape) * 0.1).astype(np.float32)
        if p[-1].key == "mean"
        else rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


# -- the models -----------------------------------------------------------------

@pytest.mark.parametrize("crop", [32, 64])
@pytest.mark.parametrize("train", [False, True])
def test_vae_matches_flax(crop, train):
    b = 4
    x = np.random.default_rng(crop).normal(size=(b, crop, crop, 3)).astype(
        np.float32)
    jvae = jv.VAE(z_dim=Z, crop=crop)
    variables = _with_stats(_np(jvae.init(jax.random.PRNGKey(crop), x,
                                          train=False)), crop)
    model = tv.VAE(Z, 3, crop)
    model.load_state_dict(from_flax_vaal(variables), strict=True)
    np.testing.assert_equal(to_flax_vaal(model.state_dict()), variables)
    key = jax.random.PRNGKey(1)
    if train:
        want, mut = jvae.apply(variables, x, key, train=True,
                               mutable=["batch_stats"])
        eps = torch.from_numpy(np.array(jax.random.normal(
            key, (b, Z), jnp.float32)))
        model.train()
        got = model(torch.from_numpy(x), eps)
        stats = to_flax_vaal(model.state_dict())["batch_stats"]
        for k, v in _leaves(mut["batch_stats"]).items():
            _close(_leaves(stats)[k], v, 2e-5, k)
    else:
        want = jvae.apply(variables, x, None, train=False)
        model.eval()
        with torch.no_grad():
            got = model(torch.from_numpy(x))
    for name, g, w in zip(("recon", "z", "mu", "logvar"), got, want):
        assert g.shape == w.shape, name
        _close(g.detach().numpy(), w, 2e-5, name)


def test_discriminator_matches_flax():
    zs = np.random.default_rng(0).normal(size=(6, Z)).astype(np.float32)
    jdisc = jv.Discriminator(z_dim=Z)
    params = _np(jdisc.init(jax.random.PRNGKey(0), zs))
    disc = tv.Discriminator(Z)
    disc.load_state_dict(from_flax_vaal(params), strict=True)
    with torch.no_grad():
        got = disc(torch.from_numpy(zs)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdisc.apply(params, zs)),
                               rtol=0, atol=1e-6)


def test_init_draws_flax_distributions():
    """He-normal over the fan-in for convs and denses, LeCun truncated
    normal over flax's deconv fan-in (kh·kw·in, torch's dim 0)."""
    vae, disc = tv.VAE(64, 3, 64), tv.Discriminator(64)
    tv.init_vaal_weights(vae, disc, torch.Generator().manual_seed(0))
    w = vae.enc_conv1.weight
    np.testing.assert_allclose(w.std().item(), (2 / (128 * 16)) ** 0.5,
                               rtol=0.02)
    d = vae.dec_deconv0.weight  # [1024, 512, 4, 4]
    std = (1 / (1024 * 16)) ** 0.5
    np.testing.assert_allclose(d.std().item(), std, rtol=0.02)
    assert d.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-7
    np.testing.assert_allclose(disc.Dense_1.weight.std().item(),
                               (2 / 512) ** 0.5, rtol=0.05)
    assert vae.fc_mu.bias.abs().max() == 0 and vae.enc_bn0.var.min() == 1


# -- the PRNG pieces --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1])
def test_fold_in_and_randint_bit_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    port_key = threefry.prng_key(seed)
    for data in (0, 1, 2, 12345, 2 ** 32 - 1):
        want = tuple(int(v) for v in np.asarray(jax.random.fold_in(key, data)))
        assert threefry.fold_in(port_key, data) == want
    for lo, hi in ((0, 161), (0, 1), (0, 2), (0, 33), (3, 70000),
                   (-5, 7), (0, 2 ** 31 - 1), (5, 5), (9, 3)):
        assert threefry.randint(port_key, lo, hi) == int(
            jax.random.randint(key, (), lo, hi)), (lo, hi)


def test_scoring_window_is_jax_random_crops():
    x = np.arange(2 * 224 * 200, dtype=np.float32).reshape(2, 224, 200, 1)
    want = np.asarray(jv.random_crop(jnp.asarray(x), 64,
                                     jax.random.PRNGKey(0)))
    key = threefry.prng_key(0)
    window = (threefry.randint(key, 0, 224 - 64 + 1),
              threefry.randint(threefry.fold_in(key, 1), 0, 200 - 64 + 1))
    got = tv.crop_window(torch.from_numpy(x), 64, *window).numpy()
    np.testing.assert_array_equal(got, want)


# -- the co-step --------------------------------------------------------------------

def _jax_sampler_parts(crop):
    view = JaxViewSpec(JAX_SYNTH_NORM, augment=True)
    ns = types.SimpleNamespace(
        vae=jv.VAE(z_dim=Z, nc=3, crop=crop), disc=jv.Discriminator(z_dim=Z),
        _tx_vae=optax.scale_by_adam(), _tx_d=optax.scale_by_adam(),
        adversary_param=10.0, train_set=types.SimpleNamespace(view=view),
        crop=crop, mesh=mesh_lib.make_mesh(1),
        cfg=types.SimpleNamespace(vaal=types.SimpleNamespace(
            vae_latent_dim=Z)))
    return ns, view


def _load_state(models, state):
    """A fresh JAX VAALState (numpy leaves) into the port's VAALModels:
    the weights and statistics; both packages' Adam states start at
    zero (checked)."""
    models.vae.load_state_dict(from_flax_vaal(
        {"params": state.vae_params, "batch_stats": state.vae_stats}))
    models.disc.load_state_dict(from_flax_vaal({"params": state.d_params}))
    for module, adam, opt in ((models.vae, models.vae_opt, state.vae_opt),
                              (models.disc, models.d_opt, state.d_opt)):
        np.testing.assert_equal(adam_to_flax(module, adam), opt._asdict())


def _check_adam_step(module, adam, old, new, new_opt, lr, what):
    """Gradients from the first moments, then the weights (module
    docstring)."""
    got_mu = _leaves(adam_to_flax(module, adam)["mu"])
    want_mu = _leaves(new_opt.mu)
    got_p = _leaves(to_flax_vaal(module.state_dict())["params"])
    old_p, want_p = _leaves(old), _leaves(new)
    scale = max(float(np.abs(v).max()) for v in want_mu.values())
    for k, wm in want_mu.items():
        gm = got_mu[k]
        diff = float(np.abs(gm - wm).max())
        assert diff <= 1e-4 * scale, (what, k, diff, scale)
        robust = np.abs(wm) > 10 * diff
        p0, gp, wp = old_p[k], got_p[k], want_p[k]
        ulp = np.spacing(np.abs(wp).astype(np.float32))
        err = np.abs(gp - wp)
        assert (err[robust] <= 1e-3 * lr + 2 * ulp[robust]).all(), (what, k)
        assert (np.abs(gp - p0) <= lr * (1 + 1e-6) + ulp).all(), (what, k)


@pytest.mark.parametrize("seed", [0])
def test_co_step_matches_jax_with_injected_draws(seed):
    crop, b = 16, 8
    ns, view = _jax_sampler_parts(crop)
    state = jsv.VAALSampler._init_vaal_state(ns, jax.random.PRNGKey(seed))
    state = _np(state)
    step = jsv.VAALSampler._build_vaal_step(ns)
    rng = np.random.default_rng(seed)
    mask = np.ones(b, np.float32)
    mask[-2:] = 0.0  # padding rows: in BN's statistics, not in the losses
    batch_l = {"image": rng.integers(0, 256, (b, crop, crop, 3), np.uint8),
               "mask": mask}
    batch_u = {"image": rng.integers(0, 256, (b, crop, crop, 3), np.uint8),
               "mask": np.ones(b, np.float32)}
    key = jax.random.PRNGKey(100 + seed)
    ks = jax.random.split(key, 7)
    x_l = jv.random_crop(jax_apply_view(jnp.asarray(batch_l["image"]), view,
                                        key=ks[0], train=True), crop, ks[2])
    x_u = jv.random_crop(jax_apply_view(jnp.asarray(batch_u["image"]), view,
                                        key=ks[1], train=True), crop, ks[2])
    eps = [torch.from_numpy(np.array(jax.random.normal(
        ks[3 + i], (b, Z), jnp.float32))) for i in range(4)]

    def both(lr_vae, lr_d):
        models = tsv.VAALModels(Z, crop, "cpu")
        _load_state(models, state)
        new_state, losses = step(jax.tree.map(jnp.asarray, state), batch_l,
                                 batch_u, key, jnp.float32(lr_vae),
                                 jnp.float32(lr_d))
        got = tsv.vaal_step(
            models, torch.from_numpy(np.asarray(x_l)),
            torch.from_numpy(np.asarray(x_u)),
            torch.from_numpy(batch_l["mask"]),
            torch.from_numpy(batch_u["mask"]), eps, lr_vae, lr_d, 10.0)
        for g, w in zip(got, (losses["vae_loss"], losses["d_loss"])):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-4)
        return models, _np(new_state)

    # The arg pools' rates: the gradients and the Adam step.
    lr_vae, lr_d = 5e-5, 1e-3
    models, new_state = both(lr_vae, lr_d)
    _check_adam_step(models.vae, models.vae_opt, state.vae_params,
                     new_state.vae_params, new_state.vae_opt, lr_vae, "vae")
    _check_adam_step(models.disc, models.d_opt, state.d_params,
                     new_state.d_params, new_state.d_opt, lr_d, "disc")
    assert models.vae_opt.count == int(new_state.vae_opt.count) == 1
    # Rates 0 (the step's rates are arguments, no recompile): the weights
    # stay, so the discriminator step's forwards see the same VAE in
    # both and the running statistics after l, u, l, u compare, free of
    # the undetermined signs of the first Adam step.
    models, new_state = both(0.0, 0.0)
    stats = _leaves(to_flax_vaal(models.vae.state_dict())["batch_stats"])
    for k, v in _leaves(new_state.vae_stats).items():
        _close(stats[k], v, 1e-5, k)


# -- the sampler -------------------------------------------------------------------

def _vaal_pair(seed=0, **cfg_kw):
    jstrat, strat = _sampler_pair("VAALSampler", seed=seed, image_size=16,
                                  **cfg_kw)
    jstrat.vaal_state = jstrat._init_vaal_state(jax.random.PRNGKey(seed))
    strat._init_vaal()
    _load_state(strat.vaal, _np(jstrat.vaal_state))
    return jstrat, strat


@pytest.mark.parametrize("seed", [0])
def test_score_step_and_query_match_jax(seed):
    jstrat, strat = _vaal_pair(seed)
    assert strat.crop == jstrat.crop == 16
    idxs = strat.available_query_idxs(shuffle=False)
    variables = {"vae_params": jstrat.vaal_state.vae_params,
                 "vae_stats": jstrat.vaal_state.vae_stats,
                 "d_params": jstrat.vaal_state.d_params}
    want = jax_scoring.collect_pool(jstrat.al_set, idxs, 16,
                                    jstrat._score_step, variables,
                                    jstrat.mesh)["d_score"]
    got = strat.collect_scores(idxs, "vaal", keys=("d_score",))["d_score"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for budget in (10, 7):
        want_idx, wcost = jstrat.query(budget)
        got_idx, cost = strat.query(budget)
        np.testing.assert_array_equal(got_idx, want_idx)
        assert cost == wcost
        jstrat.update(want_idx, wcost)
        strat.update(got_idx, cost)


def test_aux_state_reads_back_into_the_jax_tree(tmp_path):
    jstrat, strat = _vaal_pair(ckpt_path=str(tmp_path))
    directory = resume.save_experiment(strat, strat.cfg)
    aux = os.path.join(directory, resume.AUX_FILE)
    with open(aux, "rb") as fh:
        got = serialization.msgpack_restore(fh.read())
    want = serialization.msgpack_restore(jstrat.aux_state_bytes())
    got_leaves, want_leaves = _leaves(got), _leaves(want)
    assert sorted(got_leaves) == sorted(want_leaves)
    for k, v in want_leaves.items():
        assert got_leaves[k].dtype == v.dtype and got_leaves[k].shape == \
            v.shape, k
        np.testing.assert_array_equal(got_leaves[k], v, err_msg=k)
    # A sampler with no aux state removes a stale file.
    strat.vaal = None
    resume.save_experiment(strat, strat.cfg)
    assert not os.path.exists(aux)


def test_round_reinit_draws_a_fresh_vae():
    _, strat = _vaal_pair()
    before = [p.detach().clone() for p in strat.vaal.vae_params]
    strat.vaal.vae_opt.count = 3
    strat.init_network_weights()
    assert strat.vaal.vae_opt.count == 0
    assert any(not torch.equal(a, b) for a, b in
               zip(before, strat.vaal.vae_params))


def test_numpy_rng_after_train_equals_jax():
    jstrat = make_strategy("VAALSampler", n_train=96, image_size=16,
                           n_epoch=6)
    jstrat.cfg.early_stop_patience = 0
    hooks = {"jax": 0, "port": 0}

    def jax_stub(vs, *args):
        hooks["jax"] += 1
        return vs, {}

    jstrat._vaal_step = jax_stub
    jstrat.train()

    train_set, test_set, al_set = get_data_synthetic(
        n_train=96, n_test=32, num_classes=4, image_size=16, seed=0)
    np.testing.assert_array_equal(al_set.images, jstrat.al_set.images)
    eval_idxs = generate_eval_idxs(train_set.targets, 4, ratio=8 / 96,
                                   random_seed=99)
    init = generate_init_lb_idxs(train_set.targets, 4, eval_idxs, 8,
                                 random_seed=98)
    np.testing.assert_array_equal(eval_idxs, jstrat.pool.eval_idxs)
    train_cfg = TrainConfig(
        eval_split=0.1, loader_tr=LoaderConfig(batch_size=16),
        loader_te=LoaderConfig(batch_size=16),
        optimizer=OptimizerConfig(name="sgd", lr=0.05, weight_decay=0.0,
                                  momentum=0.9),
        scheduler=SchedulerConfig(name="constant"))
    model = resnet.SSLClassifier((1, 1), resnet.BasicBlock, 4,
                                 cifar_stem=True)
    trainer = Trainer(model, train_cfg, 4, "cpu")
    cfg = ExperimentConfig(dataset="synthetic", strategy="VAALSampler",
                           n_epoch=6, early_stop_patience=0, device="cpu",
                           exp_hash="test", ckpt_path=jstrat.cfg.ckpt_path,
                           log_dir=jstrat.cfg.log_dir)
    strat = tsv.VAALSampler(train_set, al_set, test_set, model, trainer,
                            PoolState.create(len(al_set), eval_idxs), cfg,
                            train_cfg, rng=np.random.default_rng(0))
    strat.update(init, len(init))
    strat.init_network_weights()

    def port_stub(*args):
        hooks["port"] += 1
        return torch.zeros(()), torch.zeros(())

    strat.co_step = port_stub
    strat.train()
    assert hooks["port"] == hooks["jax"] == 6
    assert strat.rng.bit_generator.state == jstrat.rng.bit_generator.state
