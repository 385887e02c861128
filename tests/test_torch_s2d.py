"""The port's space-to-depth stem (``--stem s2d``) against the JAX
package, on the CPU.

Inputs are numpy draws handed to both packages; the port runs kernel
I's plain version (CPU tensors).  Tolerances, each with its reason:

* Layout and data movement (``space_to_depth`` on torch and numpy,
  ``s2d_flip`` given JAX's flip mask, the s2d ``normalize`` and
  ``apply_view``, the stem-kernel fold and ``fold_stem``): bit-equal.
* ``stem_dw_plain`` and ``S2DStemConv`` against ``ops/backward.stem_conv``
  through ``jax.grad``: float64 to 1e-10 (every cast a no-op, so only
  accumulated rounding remains); float32 within 1e-6 of ``Σ|x||g|`` per
  output (the same float32 sum in another order); bf16 inputs, whose
  products are exact in float32: within ``2·R·2⁻²⁴·Σ|x||g|``, the bound
  of two float32 sums of R terms in any order.
* A (1, 1)-stage s2d classifier's float32 logits against the JAX model
  on carried weights: 1e-4 absolute plus 1e-4 relative, the tolerance of
  ``test_torch_model.py`` for the default stem.
* The port's s2d stem against its default stem on folded weights: the
  stem convolutions in float64 to 1e-10; float32 logits within 4x the
  default network's own float32 error against float64 (each of the two
  float32 networks errs by about that much, in other directions).
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_learning_tpu.data import augment as jax_augment
from active_learning_tpu.data import pipeline as jax_pipeline
from active_learning_tpu.data.core import IMAGENET_NORM as JAX_IMAGENET_NORM
from active_learning_tpu.data.core import ViewSpec as JaxViewSpec
from active_learning_tpu.models import resnet as jax_resnet
from active_learning_tpu.ops import backward as jax_backward
from active_learning_tpu.serve.cli import get_parser as jax_serve_parser
from active_learning_tpu.serve.cli import \
    resolve_serve_setup as jax_resolve_serve_setup
from active_learning_tpu.train import checkpoint as jax_ckpt

from active_learning_tpu_torch.config import (ExperimentConfig, LoaderConfig,
                                              OptimizerConfig,
                                              SchedulerConfig, TrainConfig)
from active_learning_tpu_torch.data import augment, pipeline
from active_learning_tpu_torch.data.core import (IMAGENET_NORM, ArrayDataset,
                                                 ViewSpec)
from active_learning_tpu_torch.data.synthetic import (_class_templates,
                                                      _make_images)
from active_learning_tpu_torch.experiment import driver
from active_learning_tpu_torch.models import resnet, weights
from active_learning_tpu_torch.models.factory import get_network
from active_learning_tpu_torch.ops import stem_conv
from active_learning_tpu_torch.serve import cli as serve_cli
from active_learning_tpu_torch.serve.executor import DeviceExecutor
from active_learning_tpu_torch.strategies.scoring import make_prob_stats_step
from active_learning_tpu_torch.strategies.vaal import VAALSampler
from active_learning_tpu_torch.train import checkpoint as ckpt_lib

PAD = ((2, 1), (2, 1))
EPS32 = 2.0 ** -24


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _nchw(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the port's channels-last [B, C, H, W] tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


# -- layout and data movement ----------------------------------------------

def test_space_to_depth_bit_equal_jax():
    x = _u8((3, 8, 6, 3), 0)
    want = np.asarray(jax_resnet.space_to_depth(jnp.asarray(x)))
    np.testing.assert_array_equal(pipeline.space_to_depth(x), want)
    np.testing.assert_array_equal(jax_pipeline.space_to_depth(x), want)
    np.testing.assert_array_equal(
        resnet.space_to_depth(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(resnet.space_to_depth(x), want)
    assert resnet.S2D_BLOCK == jax_resnet.S2D_BLOCK == 2


@pytest.mark.parametrize("seed", [0, 1])
def test_s2d_flip_bit_equal_jax_given_its_mask(seed):
    x = pipeline.space_to_depth(_u8((6, 8, 8, 3), seed))
    flip = np.random.default_rng(seed + 10).random(6) < 0.5
    want = np.asarray(jax_augment.s2d_flip(jnp.asarray(x), jnp.asarray(flip)))
    got = augment.s2d_flip(torch.from_numpy(x), torch.from_numpy(flip))
    np.testing.assert_array_equal(got.numpy(), want)
    # It is space-to-depth of the flipped rows.
    raw = _u8((6, 8, 8, 3), seed)
    flipped = np.where(flip[:, None, None, None], raw[:, :, ::-1], raw)
    np.testing.assert_array_equal(got.numpy(),
                                  pipeline.space_to_depth(flipped))


def test_s2d_normalize_and_apply_view_bit_equal_jax():
    x = pipeline.space_to_depth(_u8((4, 8, 8, 3), 2))
    view = ViewSpec(IMAGENET_NORM, augment=True, pad=0)
    jview = JaxViewSpec(JAX_IMAGENET_NORM, augment=True, pad=0)
    xt = torch.from_numpy(x)
    want = np.asarray(jax_augment.normalize(jnp.asarray(x),
                                            JAX_IMAGENET_NORM))
    np.testing.assert_array_equal(augment.normalize(xt, IMAGENET_NORM)
                                  .numpy(), want)
    np.testing.assert_array_equal(
        augment.apply_view(xt, view, train=False).numpy(),
        np.asarray(jax_augment.apply_view(jnp.asarray(x), jview,
                                          train=False)))
    # The train view with JAX's own flip draw.
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_augment.apply_view(jnp.asarray(x), jview, key=key,
                                             train=True))
    flip = np.array(jax.random.bernoulli(jax.random.split(key)[1], 0.5,
                                         (4,)))
    got = augment.normalize(augment.s2d_flip(xt, torch.from_numpy(flip)),
                            IMAGENET_NORM)
    np.testing.assert_array_equal(got.numpy(), want)


def test_apply_view_s2d_is_s2d_of_the_raw_view():
    """At one generator state the s2d train view equals space-to-depth
    of the raw rows' train view; a crop view refuses s2d rows, as the
    JAX package asserts."""
    raw = _u8((8, 8, 8, 3), 3)
    view = ViewSpec(IMAGENET_NORM, augment=True, pad=0)
    a = augment.apply_view(torch.from_numpy(raw), view,
                           torch.Generator().manual_seed(5))
    b = augment.apply_view(torch.from_numpy(pipeline.space_to_depth(raw)),
                           view, torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(b.numpy(),
                                  resnet.space_to_depth(a).numpy())
    with pytest.raises(ValueError, match="flip-only"):
        augment.apply_view(torch.from_numpy(pipeline.space_to_depth(raw)),
                           ViewSpec(IMAGENET_NORM, augment=True, pad=4),
                           torch.Generator())
    with pytest.raises(ValueError, match="channels"):
        augment.normalize(torch.zeros(1, 2, 2, 6, dtype=torch.uint8),
                          IMAGENET_NORM)


def test_host_batches_are_space_to_depth():
    images = _u8((10, 8, 8, 3), 4)
    ds = ArrayDataset(images, np.arange(10) % 3, 3,
                      ViewSpec(IMAGENET_NORM))
    plain = list(pipeline.iterate_batches(ds, np.arange(10), 4))
    s2d = list(pipeline.iterate_batches(ds, np.arange(10), 4, s2d=True,
                                        num_threads=2))
    assert len(plain) == len(s2d) == 3
    for p, s in zip(plain, s2d):
        np.testing.assert_array_equal(s["image"],
                                      jax_pipeline.space_to_depth(p["image"]))
        for k in ("label", "index", "mask"):
            np.testing.assert_array_equal(s[k], p[k])


def test_stem_kernel_fold_bit_equal_jax_and_round_trip():
    k7 = np.random.default_rng(5).normal(size=(7, 7, 3, 64)).astype(
        np.float32)
    want = np.asarray(jax_resnet.s2d_stem_kernel(jnp.asarray(k7)))
    k4 = resnet.s2d_stem_kernel(k7)
    k4t = resnet.s2d_stem_kernel(torch.from_numpy(k7))
    assert k4.shape == (4, 4, 12, 64)
    np.testing.assert_array_equal(k4, want)
    np.testing.assert_array_equal(k4t.numpy(), want)
    np.testing.assert_array_equal(resnet.stem_kernel_from_s2d(k4), k7)
    np.testing.assert_array_equal(resnet.stem_kernel_from_s2d(k4t).numpy(),
                                  np.asarray(jax_resnet.stem_kernel_from_s2d(
                                      jnp.asarray(want))))
    with pytest.raises(ValueError):
        resnet.s2d_stem_kernel(np.zeros((3, 3, 3, 8), np.float32))


def test_fold_stem_is_the_jax_fold_of_carried_weights():
    """``fold_stem`` on a carried default-stem state dict equals the
    carry of the JAX fold (``test_s2d_stem.py``'s
    ``_s2d_variables_from_baseline``), and ``unfold_stem`` undoes it."""
    jmodel = jax_resnet.SSLClassifier(stage_sizes=(1, 1),
                                      block_cls=jax_resnet.BasicBlock,
                                      num_classes=4)
    variables = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), np.zeros((1, 8, 8, 3), np.float32),
        train=False))
    sd = weights.from_flax_variables(variables)
    folded = weights.fold_stem(sd)
    k4 = np.asarray(jax_resnet.s2d_stem_kernel(
        variables["params"]["encoder"]["conv_stem"]["kernel"]))
    assert folded[weights.STEM_KEY].shape == (64, 12, 4, 4)
    np.testing.assert_array_equal(folded[weights.STEM_KEY].numpy(),
                                  k4.transpose(3, 2, 0, 1))
    assert all(folded[k] is v for k, v in sd.items()
               if k != weights.STEM_KEY)
    back = weights.unfold_stem(folded)
    np.testing.assert_array_equal(back[weights.STEM_KEY].numpy(),
                                  sd[weights.STEM_KEY].numpy())
    with pytest.raises(ValueError):
        weights.unfold_stem(sd)
    # The HWIO <-> OIHW carry takes the [4, 4, 12, 64] kernel.
    tree = weights.to_flax_variables(folded)
    np.testing.assert_array_equal(
        tree["params"]["encoder"]["conv_stem"]["kernel"], k4)


# -- the stem conv and its weight gradient (kernel I's plain version) --------

def _jax_grads(x, k, cot, dt):
    def fn(a, b):
        return jax_backward.stem_conv(a, b, dtype=dt, padding=PAD)

    def loss(a, b):
        y = fn(a, b)
        return jnp.sum((y * cot.astype(y.dtype)).astype(jnp.float32))

    return jax.grad(loss, argnums=(0, 1))(x, k)


def _data(seed, b=2, h=10, w=9, f=16, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, w, 12)).astype(dtype),
            rng.normal(size=(4, 4, 12, f)).astype(dtype),
            rng.normal(size=(b, h, w, f)).astype(dtype))


def _magnitude(x, g):
    """Σ|x||g| per output of dW, [F, C, 4, 4], in float64."""
    return stem_conv.stem_dw_plain(torch.from_numpy(np.abs(x)).double(),
                                   torch.from_numpy(np.abs(g)).double())


def _hwio(dw: torch.Tensor) -> np.ndarray:
    return dw.detach().permute(2, 3, 1, 0).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_stem_dw_plain_f64_matches_jax_grad(seed):
    x, k, cot = _data(seed)
    with jax.enable_x64(True):
        gx_ref, gk_ref = _jax_grads(jnp.asarray(x), jnp.asarray(k),
                                    jnp.asarray(cot), jnp.float64)
        gx_ref, gk_ref = np.asarray(gx_ref), np.asarray(gk_ref)
    dw = stem_conv.stem_dw(torch.from_numpy(x), torch.from_numpy(cot))
    assert dw.dtype == torch.float64 and dw.shape == (16, 12, 4, 4)
    np.testing.assert_allclose(_hwio(dw), gk_ref, rtol=1e-10, atol=1e-10)
    # dx through S2DStemConv, which takes the float32 parameter's role.
    xt = _nchw(x).requires_grad_(True)
    wt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_(
        True)
    y = resnet.S2DStemConv.apply(xt, wt, torch.float64)
    gx, gw = torch.autograd.grad(y, (xt, wt), _nchw(cot))
    np.testing.assert_allclose(gx.permute(0, 2, 3, 1).numpy(), gx_ref,
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(_hwio(gw), gk_ref, rtol=1e-10, atol=1e-10)


def test_stem_dw_plain_f32_matches_jax_grad():
    x, k, cot = _data(2, dtype=np.float32)
    _, gk_ref = _jax_grads(jnp.asarray(x), jnp.asarray(k), jnp.asarray(cot),
                           jnp.float32)
    dw = stem_conv.stem_dw(torch.from_numpy(x), torch.from_numpy(cot))
    assert dw.dtype == torch.float32
    err = np.abs(_hwio(dw).astype(np.float64) - np.asarray(gk_ref))
    mag = _hwio(_magnitude(x, cot))
    assert (err <= 1e-6 * mag).all(), float((err / mag).max())


def test_stem_dw_plain_bf16_within_the_f32_summation_bound():
    x, k, cot = _data(3, b=3, h=12, w=12, f=24, dtype=np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    _, gk_ref = _jax_grads(xb, jnp.asarray(k), jnp.asarray(cot),
                           jnp.bfloat16)
    assert gk_ref.dtype == jnp.float32
    xt = torch.from_numpy(x).to(torch.bfloat16)
    gt = torch.from_numpy(cot).to(torch.bfloat16)
    dw = stem_conv.stem_dw(xt, gt)
    assert dw.dtype == torch.float32
    x64, g64 = xt.double().numpy(), gt.double().numpy()
    r = 3 * 12 * 12
    err = np.abs(_hwio(dw).astype(np.float64) - np.asarray(gk_ref))
    bound = 2 * r * EPS32 * _hwio(_magnitude(x64, g64))
    assert (err <= bound).all(), float((err / bound).max())
    # Both sums are of exact products: the float64 truth is within one
    # float32 sum's bound of each.
    truth = _hwio(stem_conv.stem_dw_plain(torch.from_numpy(x64),
                                          torch.from_numpy(g64)))
    assert (np.abs(_hwio(dw) - truth) <= bound / 2).all()


def test_stem_dw_checks_its_arguments():
    x = torch.zeros(2, 6, 6, 12)
    g = torch.zeros(2, 6, 6, 8)
    with pytest.raises(ValueError, match="output"):
        stem_conv.stem_dw(x, torch.zeros(2, 5, 6, 8))
    with pytest.raises(ValueError, match="dtype"):
        stem_conv.stem_dw(x, g.double())
    # Other kernel shapes and pads: the plain version takes them.
    dw = stem_conv.stem_dw(x, torch.zeros(2, 4, 6, 8), kh=3, kw=2,
                           padding=((0, 0), (1, 0)))
    assert dw.shape == (8, 12, 3, 2)
    assert stem_conv.chain_length(128, 112, 112) == 28 * 4 * 28 + 512


# -- kernel I's partition: a function of the shape alone ----------------------

def _no_card(monkeypatch):
    """Make any question to the card raise: a partition that asked would
    fail."""
    def ask(*a, **k):
        raise AssertionError("the partition consulted the card")
    for name in ("get_device_properties", "device_count", "is_available",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, ask)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,ho,wo,kh,kw", [
    (128, 112, 112, 4, 4), (8, 112, 112, 4, 4), (1, 2, 2, 4, 4),
    (3, 4, 6, 4, 4), (2, 7, 5, 4, 4), (2, 9, 130, 4, 4), (3, 9, 17, 8, 8)])
def test_stem_dw_runs_cover_every_position_once(monkeypatch, dtype, b, ho,
                                                wo, kh, kw):
    """The kernel's runs (``partition``: tiles of ``tile_rows x
    tile_cols`` positions, run k the tiles [k·per, (k+1)·per)) cover every
    output position exactly once, and the plan is computed without
    asking the card (so it is the same on any SM count)."""
    _no_card(monkeypatch)
    part = stem_conv.partition(b, ho, wo, dtype, kh, kw)
    assert part == stem_conv.partition(b, ho, wo, dtype, kh, kw)
    count = np.zeros((b, ho, wo), np.int32)
    nr, nc = -(-ho // part.tile_rows), -(-wo // part.tile_cols)
    for k in range(part.nblk):
        run = range(k * part.per, min((k + 1) * part.per, part.tiles))
        assert len(run) > 0
        for t in run:   # the kernel's order: image, row tile, column tile
            img, rem = divmod(t, nr * nc)
            i0, j0 = rem // nc * part.tile_rows, rem % nc * part.tile_cols
            count[img, i0:i0 + part.tile_rows, j0:j0 + part.tile_cols] += 1
    assert (count == 1).all()
    if dtype == torch.bfloat16:
        assert part.tile_rows == 2
        assert part.tile_cols // 8 in stem_conv._TC_STEPS
        assert stem_conv._tc_smem(part.tile_cols, kh, kw) \
            <= stem_conv._SMEM_LIMIT
        assert part.nblk <= stem_conv._TC_RUNS


def test_stem_dw_tensor_core_plan_at_the_fit_width(monkeypatch):
    """At B=128 x 112x112 bf16: 2 x 112 tiles (7,168), 131 runs of 55,
    four stages; L_k = 18 units of 2⁻²³ per 16-position step (55 tiles
    of 14 steps) plus the 131-partial fold.  The f32 path keeps its
    4 x 28 tiles, 512 runs and 2⁻²⁴."""
    _no_card(monkeypatch)
    part = stem_conv.partition(128, 112, 112, torch.bfloat16)
    assert part == stem_conv.Partition(2, 112, 7168, 55, 131)
    assert stem_conv.chain_length(128, 112, 112, torch.bfloat16) \
        == 18 * 55 * 14 + 131
    assert stem_conv.error_unit(torch.bfloat16) == 2.0 ** -23
    assert stem_conv.error_unit(torch.float32) == 2.0 ** -24
    assert stem_conv.partition(128, 112, 112) == stem_conv.Partition(
        4, 28, 14336, 28, 512)
    # 8x8 taps: fewer columns a tile, to fit the four stages.
    wide = stem_conv.partition(2, 64, 200, torch.bfloat16, 8, 8)
    assert wide.tile_cols == 56


@pytest.mark.parametrize("dt", [jnp.float32, jnp.float64])
def test_s2d_stem_conv_matches_jax_module(dt):
    """The port's ``S2DStemConv`` against JAX's ``S2DStemConv`` module:
    forward and both gradients (f32 to 1e-5 of Σ|x||k| scale, f64 to
    1e-10)."""
    np_dt = np.float64 if dt == jnp.float64 else np.float32
    x, k, cot = _data(4, b=2, h=8, w=8, f=8, dtype=np_dt)
    mod = jax_resnet.S2DStemConv(features=8, dtype=dt)

    def run():
        def loss(a, kk):
            y = mod.apply({"params": {"kernel": kk}}, a)
            return jnp.sum(y * cot), y
        (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                           has_aux=True)(jnp.asarray(x),
                                                         jnp.asarray(k))
        return np.asarray(y), np.asarray(grads[0]), np.asarray(grads[1])

    if dt == jnp.float64:
        with jax.enable_x64(True):
            y_ref, gx_ref, gk_ref = run()
        tol = 1e-10
        tdt = torch.float64
    else:
        y_ref, gx_ref, gk_ref = run()
        tol = 1e-5
        tdt = torch.float32
    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    xt.requires_grad_(True)
    wt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_(
        True)
    y = resnet.S2DStemConv.apply(xt, wt, tdt)
    assert y.is_contiguous(memory_format=torch.channels_last)
    gx, gw = torch.autograd.grad(y, (xt, wt), _nchw(cot))
    assert gw.dtype == wt.dtype
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), y_ref,
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(gx.permute(0, 2, 3, 1).numpy(), gx_ref,
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(_hwio(gw), gk_ref, rtol=tol, atol=tol)


def test_bf16_weight_gradient_lands_in_float32_unrounded():
    """The stem's weight is float32 and the Function casts it inside: its
    gradient is the float32 sum of kernel I (here its plain version),
    not one rounded to bf16 on the way back."""
    model = resnet.SSLClassifier((1, 1), resnet.BasicBlock, 4,
                                 dtype=torch.bfloat16, stem="s2d")
    model.train()
    x = torch.from_numpy(pipeline.space_to_depth(
        _u8((4, 16, 16, 3), 6))).float() / 255.0
    loss = model(x).float().square().sum()
    (gw,) = torch.autograd.grad(loss, [model.encoder.conv_stem.weight])
    assert gw.dtype == torch.float32
    assert not torch.equal(gw, gw.to(torch.bfloat16).float())


# -- the model ---------------------------------------------------------------

def _redraw_batch_stats(tree, rng):
    for key, v in tree.items():
        if isinstance(v, dict):
            _redraw_batch_stats(v, rng)
        elif key == "mean":
            tree[key] = (rng.standard_normal(v.shape) * 0.2).astype(
                np.float32)
        elif key == "var":
            tree[key] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)


def test_s2d_classifier_logits_match_jax():
    jmodel = jax_resnet.SSLClassifier(
        stage_sizes=(1, 1), block_cls=jax_resnet.BasicBlock, num_classes=4,
        stem="s2d", dtype=jnp.float32)
    x = np.random.default_rng(0).standard_normal((3, 16, 16, 3)).astype(
        np.float32)
    variables = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(1), x, train=False))
    _redraw_batch_stats(variables["batch_stats"], np.random.default_rng(2))
    assert variables["params"]["encoder"]["conv_stem"]["kernel"].shape == \
        (4, 4, 12, 64)
    model = resnet.SSLClassifier((1, 1), resnet.BasicBlock, 4, stem="s2d")
    model = model.to(memory_format=torch.channels_last)
    weights.load_flax_variables(model, variables)
    ref = np.asarray(jmodel.apply(variables, x, train=False))
    x12 = pipeline.space_to_depth(x)
    ref12 = np.asarray(jmodel.apply(variables, x12, train=False))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
        got12 = model(torch.from_numpy(x12)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got12, ref12, rtol=1e-4, atol=1e-4)
    # Device-side and host-side space-to-depth feed the same bytes.
    np.testing.assert_array_equal(got, got12)


def test_s2d_stem_conv_is_the_default_stem_in_f64():
    base = resnet.resnet18(4, dtype=torch.float64, stage_sizes=(1, 1))
    s2d = resnet.resnet18(4, dtype=torch.float64, stage_sizes=(1, 1),
                          stem="s2d")
    resnet.init_weights(base, torch.Generator().manual_seed(0))
    s2d.load_state_dict(weights.fold_stem(base.state_dict()))
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 32, 32, 3)))
    with torch.inference_mode():
        y7 = base.encoder.conv_stem(x.permute(0, 3, 1, 2))
        y4 = s2d.encoder.conv_stem(
            resnet.space_to_depth(x).permute(0, 3, 1, 2))
    assert y4.shape == y7.shape == (2, 64, 16, 16)
    np.testing.assert_allclose(y4.numpy(), y7.numpy(), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1])
def test_s2d_logits_match_the_default_stem_f32(seed):
    """Folded weights: the s2d and default-stem SSLResNet18 compute one
    function.  Each float32 network errs against the float64 network by
    about e = max|y_default(f32) − y(f64)|; the two differ by at most
    their two errors, held here to 4·e."""
    base = get_network("imagenet", "SSLResNet18", num_classes=12,
                       dtype="float32", device="cpu")
    resnet.init_weights(base, torch.Generator().manual_seed(seed))
    sd = base.state_dict()
    s2d = get_network("imagenet", "SSLResNet18", num_classes=12,
                      dtype="float32", stem="s2d", device="cpu")
    s2d.load_state_dict(weights.fold_stem(sd))
    ref = get_network("imagenet", "SSLResNet18", num_classes=12,
                      dtype=torch.float64, device="cpu")
    ref.load_state_dict(sd)
    x = torch.from_numpy(np.random.default_rng(seed + 7).standard_normal(
        (2, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        y_base, y_s2d = base(x), s2d(x)
        # The float64 encoder hands a float32 embedding to the head (as
        # every encoder does); the head runs in float64 here.
        y_ref = torch.nn.functional.linear(
            ref.encoder(x.double()).double(), ref.linear.weight.double(),
            ref.linear.bias.double())
    e = float((y_base.double() - y_ref).abs().max())
    d = float((y_s2d - y_base).abs().max())
    assert 0 < e < 1e-3
    assert d <= 4 * e, (d, e)


# -- the factory -------------------------------------------------------------

def test_factory_guards():
    m = get_network("imagenet", "SSLResNet50", stem="s2d", device="cpu")
    assert m.stem == "s2d"
    assert m.encoder.conv_stem.weight.shape == (64, 12, 4, 4)
    # The stem choice is global: a 10-class dataset keeps the CIFAR stem.
    m = get_network("cifar10", "SSLResNet18", stem="s2d", device="cpu")
    assert m.stem == "default" and m.cifar_stem
    assert m.encoder.conv_stem.weight.shape == (64, 3, 3, 3)
    assert get_network("imagenet", "SSLResNet18", num_classes=4,
                       stem=None, device="cpu").stem == "default"
    with pytest.raises(ValueError, match="nothing to fold"):
        resnet.resnet50(10, cifar_stem=True, stem="s2d")
    with pytest.raises(ValueError, match="unknown stem"):
        resnet.resnet18(4, stem="s4d")
    # The JAX package resolves the same way.
    from active_learning_tpu.models.factory import get_network as jax_net
    assert jax_net("cifar10", "SSLResNet18", stem="s2d").stem == "default"
    assert jax_net("imagenet", "SSLResNet50", stem="s2d").stem == "s2d"


# -- the experiment, serving, VAAL -------------------------------------------

def _facsimile(n_train=96, n_test=16, num_classes=4, hw=16, seed=11):
    """A seeded 4-class 16-px set with the ImageNet view contract (flip-
    only train view, as ``tests/test_learn_smoke_224.py``'s facsimile)."""
    rng = np.random.default_rng(seed)
    templates = _class_templates(num_classes, hw, rng)
    tr, tr_t = _make_images(n_train, templates, rng, noise_sigma=12.0)
    te, te_t = _make_images(n_test, templates, rng, noise_sigma=12.0)
    train = ArrayDataset(tr, tr_t, num_classes,
                         ViewSpec(IMAGENET_NORM, augment=True, pad=0))
    test = ArrayDataset(te, te_t, num_classes, ViewSpec(IMAGENET_NORM))
    return train, test, train.with_view(ViewSpec(IMAGENET_NORM))


def _tiny_train_cfg():
    return TrainConfig(
        eval_split=0.1, loader_tr=LoaderConfig(batch_size=16),
        loader_te=LoaderConfig(batch_size=16),
        optimizer=OptimizerConfig(name="sgd", lr=0.05, weight_decay=5e-4,
                                  momentum=0.9),
        scheduler=SchedulerConfig(name="constant"))


@pytest.fixture(scope="module")
def s2d_experiment(tmp_path_factory):
    """Two rounds of MarginSampler with the s2d stem on the CPU."""
    root = tmp_path_factory.mktemp("s2d_exp")
    cfg = ExperimentConfig(dataset="imagenet", model="SSLResNet18",
                           stem="s2d", strategy="MarginSampler", rounds=2,
                           round_budget=16, n_epoch=1,
                           early_stop_patience=0, device="cpu",
                           exp_hash="s2d", log_dir=str(root / "logs"),
                           ckpt_path=str(root / "ckpt"))
    strategy = driver.run_experiment(cfg, data=_facsimile(),
                                     train_cfg=_tiny_train_cfg())
    return str(root / "ckpt" / "active_learning_s2d"), strategy


def test_s2d_experiment_saves_the_folded_stem(s2d_experiment):
    exp_dir, strategy = s2d_experiment
    assert strategy.model.stem == "s2d" and strategy.trainer.host_s2d
    best = jax_ckpt.load_variables(os.path.join(exp_dir, "best_rd_1.msgpack"))
    assert best["params"]["encoder"]["conv_stem"]["kernel"].shape == \
        (4, 4, 12, 64)
    with open(os.path.join(exp_dir, "experiment_state.json")) as fh:
        meta = json.load(fh)
    assert meta["round"] == 1 and meta["config"]["stem"] == "s2d"
    assert int(strategy.pool.labeled.sum()) == 32


def test_serve_resolves_the_stem_and_scores_host_s2d_rows(s2d_experiment):
    exp_dir, _ = s2d_experiment
    args = serve_cli.get_parser().parse_args(
        ["--experiment_dir", exp_dir, "--device", "cpu", "--image_size",
         "16"])
    model, view, image_size, _ = serve_cli.resolve_serve_setup(args)
    assert model.stem == "s2d" and image_size == 16
    ex = DeviceExecutor(model, view, torch.device("cpu"), (16, 16, 3),
                        ckpt_dir=exp_dir)
    assert ex.host_s2d and ex.served_round == 1
    ex.warmup([8])
    rows = _u8((8, 16, 16, 3), 9)
    dev, ready = ex._to_device({"image": rows})
    assert ready is None and dev["image"].shape == (8, 8, 8, 12)
    out = ex._steps["prob_stats"](model, dev)
    step = make_prob_stats_step(view)
    ref = step(model, {"image": torch.from_numpy(
        pipeline.space_to_depth(rows))})
    raw = step(model, {"image": torch.from_numpy(rows)})
    for k in ("pred", "confidence", "margin", "entropy"):
        assert torch.equal(out[k], ref[k]), k
        assert torch.equal(out[k], raw[k]), k


def test_stem_resolution_follows_the_config_echo(tmp_path):
    """An experiment trained with --stem s2d saved a folded stem: serve
    builds the s2d model from the config echo, as the JAX package does
    (``tests/test_serve.py::test_stem_resolution_follows_config_echo``)."""
    exp = tmp_path / "exp_s2d"
    exp.mkdir()
    ckpt_lib.save_variables(
        str(exp / "best_rd_0.msgpack"),
        {"params": {"linear": {"bias": np.zeros(7, np.float32)}}})
    (exp / "experiment_state.json").write_text(json.dumps({
        "round": 0,
        "config": {"dataset": "imagenet", "model": "SSLResNet50",
                   "arg_pool": "default", "stem": "s2d"}}))
    model, _, image_size, _ = serve_cli.resolve_serve_setup(
        serve_cli.get_parser().parse_args(
            ["--experiment_dir", str(exp), "--device", "cpu"]))
    jmodel = jax_resolve_serve_setup(
        jax_serve_parser().parse_args(["--experiment_dir", str(exp)]))[0]
    assert model.stem == jmodel.stem == "s2d"
    assert image_size == 224 and model.num_classes == 7
    assert model.encoder.conv_stem.weight.shape == (64, 12, 4, 4)


def test_vaal_with_an_s2d_classifier_feeds_the_vae_raw_rows(tmp_path):
    """VAAL's VAE is 3-channel: the fit's batch hook and VAAL's scoring
    pass get raw rows, while the s2d classifier re-lays them on the
    device and trains through kernel I's plain version."""
    train_set, test_set, al_set = _facsimile(n_train=64)
    cfg = ExperimentConfig(dataset="imagenet", model="SSLResNet18",
                           stem="s2d", strategy="VAALSampler", rounds=1,
                           round_budget=16, n_epoch=1,
                           early_stop_patience=0, device="cpu",
                           exp_hash="vaal_s2d", log_dir=str(tmp_path),
                           ckpt_path=str(tmp_path))
    strat = driver.build_experiment(cfg, data=(train_set, test_set, al_set),
                                    train_cfg=_tiny_train_cfg())
    assert isinstance(strat, VAALSampler) and strat.model.stem == "s2d"
    strat.init_network_weights()
    seen = {"hook": [], "classifier": []}
    co_step, train_step = strat.co_step, strat.trainer.train_step

    def spy_co_step(batch_l, batch_u, *args):
        seen["hook"] += [batch_l["image"].shape, batch_u["image"].shape]
        return co_step(batch_l, batch_u, *args)

    def spy_train_step(batch, *args):
        seen["classifier"].append(batch["image"].shape)
        return train_step(batch, *args)

    strat.co_step = spy_co_step
    strat.trainer.train_step = spy_train_step
    stem_w = strat.model.encoder.conv_stem.weight.detach().clone()
    strat.train()
    assert seen["hook"] and all(s[-1] == 3 for s in seen["hook"])
    assert seen["classifier"] and all(s[-1] == 3
                                      for s in seen["classifier"])
    assert not torch.equal(stem_w, strat.model.encoder.conv_stem.weight)
    picks, cost = strat.query(8)
    assert cost == 8 and len(np.unique(picks)) == 8
    # The classifier's own scoring pass is fed space-to-depth rows.
    shapes = []
    step = strat._get_score_step("prob_stats")
    strat._score_steps["prob_stats"] = lambda model, batch: (
        shapes.append(batch["image"].shape), step(model, batch))[1]
    strat.collect_scores(strat.available_query_idxs(shuffle=False)[:4],
                         "prob_stats")
    assert shapes and shapes[0][1:] == (8, 8, 12)
