"""The port's training slice against the JAX package, on the CPU.

Every input is drawn from a numpy seed and handed to both packages; the
port runs its kernels' plain versions (CPU tensors).  Tolerances, each
with its reason:

* K1-train (``ops/bn_train`` vs ``ops/backward.fused_bn_train``): float64
  to 1e-10 (every cast a no-op, so only accumulated rounding remains);
  float32 to the JAX tests' own 2e-5 relative / 2e-6 absolute (sums in
  another order); bf16 to ``test_backward.py``'s 3e-2/6e-2/6e-2 of each
  gradient's max (bf16 rounding order: JAX rounds the forward after
  each op, the port once).
* K2 (``ops/fused_sgd`` vs ``train/optim.fused_sgd_update``): bit-equal
  at f32 state; within 1 bf16 ulp of the trace at bf16 state.
* ``crop_flip`` given JAX's own draws: bit-equal (pure data movement).
* One full f32 train step (stage_sizes (1, 1), 8x8 rows, B=8): see
  ``test_one_train_step_matches_jax``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from active_learning_tpu import initial_pool as jax_initial_pool
from active_learning_tpu.config import LoaderConfig as JaxLoaderConfig
from active_learning_tpu.config import OptimizerConfig as JaxOptimizerConfig
from active_learning_tpu.config import \
    PretrainedConfig as JaxPretrainedConfig
from active_learning_tpu.config import SchedulerConfig as JaxSchedulerConfig
from active_learning_tpu.config import TrainConfig as JaxTrainConfig
from active_learning_tpu.data import augment as jax_augment
from active_learning_tpu.data import pipeline as jax_pipeline
from active_learning_tpu.data.core import ViewSpec as JaxViewSpec
from active_learning_tpu.data.synthetic import SYNTH_NORM as JAX_SYNTH_NORM
from active_learning_tpu.data.synthetic import \
    get_data_synthetic as jax_get_data_synthetic
from active_learning_tpu.models import resnet as jax_resnet
from active_learning_tpu.ops import backward as jax_backward
from active_learning_tpu.train import evaluation as jax_evaluation
from active_learning_tpu.train import optim as jax_optim
from active_learning_tpu.train import trainer as jax_trainer

from active_learning_tpu_torch import initial_pool
from active_learning_tpu_torch.config import (LoaderConfig, OptimizerConfig,
                                              PretrainedConfig,
                                              SchedulerConfig, TrainConfig)
from active_learning_tpu_torch.data import augment, pipeline
from active_learning_tpu_torch.data.core import SYNTH_NORM, ViewSpec
from active_learning_tpu_torch.data.synthetic import get_data_synthetic
from active_learning_tpu_torch.models import resnet, weights
from active_learning_tpu_torch.ops import bn_train
from active_learning_tpu_torch.ops import fused_sgd
from active_learning_tpu_torch.train import evaluation, optim, trainer


def _nchw(a: np.ndarray, dtype=None) -> torch.Tensor:
    """NHWC numpy -> the port's NCHW view in channels_last memory."""
    t = torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)
    if dtype is not None:
        t = t.to(dtype)
    return t.contiguous(memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).to(torch.float64).numpy()


# -- K1-train: training-mode BatchNorm -------------------------------------

def _bn_data(seed, shape, clamp=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * 2 + 1
    if clamp:
        # Channel 0 constant: mean2 == mean² exactly, var clamps to 0.
        x[..., 0] = 1.5
    scale = rng.normal(size=shape[-1:]) + 1.0
    bias = rng.normal(size=shape[-1:])
    cot = rng.normal(size=shape)
    return x, scale, bias, cot


def _jax_bn(x, scale, bias, cot, dt):
    """JAX forward and (dx, dscale, dbias) of sum(y·cot)."""
    def loss(x_, s_, b_):
        y = jax_backward.fused_bn_train(x_, s_, b_, dtype=dt,
                                        epsilon=1e-5)[0]
        return jnp.sum((y * cot.astype(y.dtype)).astype(
            jnp.promote_types(dt, jnp.float32)))
    y, mean, var = jax_backward.fused_bn_train(x, scale, bias, dtype=dt,
                                               epsilon=1e-5)
    grads = jax.grad(loss, argnums=(0, 1, 2))(x, scale, bias)
    return [np.asarray(v, np.float64) for v in (y, mean, var, *grads)]


def _port_bn(x, scale, bias, cot, dtype, pdtype, fused=True):
    xt = _nchw(x, dtype).requires_grad_(True)
    st = torch.tensor(scale, dtype=pdtype, requires_grad=True)
    bt = torch.tensor(bias, dtype=pdtype, requires_grad=True)
    y, mean, var = bn_train.bn_train(xt, st, bt, 1e-5, fused)
    acc = torch.promote_types(dtype, torch.float32)
    (y.to(acc) * _nchw(cot, dtype).to(acc)).sum().backward()
    return [_nhwc(y), mean.double().numpy(), var.double().numpy(),
            _nhwc(xt.grad), st.grad.double().numpy(),
            bt.grad.double().numpy()]


@pytest.mark.parametrize("clamp", [False, True])
def test_bn_train_f64_identity(clamp):
    """float64: the port's plain forward and its three gradients equal
    the JAX custom VJP's to 1e-10, the variance clamp included."""
    x, scale, bias, cot = _bn_data(3, (3, 5, 5, 8), clamp)
    with jax.enable_x64(True):
        ref = _jax_bn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                      jnp.asarray(cot), jnp.float64)
    got = _port_bn(x, scale, bias, cot, torch.float64, torch.float64)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)


def test_bn_train_f64_flax_formula_matches_flax_autodiff():
    """float64: the flax-formula mode (unrounded multiplier) against
    autodiff of flax ``nn.BatchNorm`` in training mode, to 1e-10."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 5, 5, 6)) + 1.0
    cot = rng.normal(size=x.shape)
    scale = 1.0 + 0.1 * np.arange(6.0)
    bias = 0.1 * np.arange(6.0)
    with jax.enable_x64(True):
        mod = nn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5, dtype=jnp.float64)
        v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))

        def loss(xx, params):
            y, _ = mod.apply({"params": params,
                              "batch_stats": v["batch_stats"]}, xx,
                             mutable=["batch_stats"])
            return jnp.sum(y * cot)

        params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
        y_ref, _ = mod.apply({"params": params,
                              "batch_stats": v["batch_stats"]},
                             jnp.asarray(x), mutable=["batch_stats"])
        gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), params)
        ref = [np.asarray(y_ref), np.asarray(gx), np.asarray(gp["scale"]),
               np.asarray(gp["bias"])]
    got = _port_bn(x, scale, bias, cot, torch.float64, torch.float64,
                   fused=False)
    for a, b in zip([got[0]] + got[3:], ref):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)


def _close_f32(a, b):
    """The JAX tests' 2e-5 relative / 2e-6 absolute, the absolute part
    taken of the tensor's largest magnitude: the port and XLA sum the
    same terms in other orders, so they differ by f32 rounding of sums
    whose terms reach |x|·|gy| ~ 10 (measured 4.3e-6 on dscale of max
    12.8, where the port is the closer of the two to the float64
    value)."""
    assert np.all(np.abs(a - b) <= 2e-5 * np.abs(b)
                  + 2e-6 * np.max(np.abs(b)))


@pytest.mark.parametrize("clamp", [False, True])
def test_bn_train_f32_matches_jax(clamp):
    """float32, the same formulas with sums in another order.  At the
    clamped channel (0 when ``clamp``) ``rsqrt(0 + eps) = 316`` multiplies
    the rounding residue of the cancelling ``Σgy·x − mean·Σgy``: both
    packages land ~1e-3 from the float64 value there, so that channel's
    dx and dscale are held to the float64 value, no further from it
    than twice JAX's own distance (the f64 test pins the clamp's
    algebra to 1e-10)."""
    x, scale, bias, cot = _bn_data(1, (4, 6, 6, 16), clamp)
    f = np.float32
    args = [v.astype(f) for v in (x, scale, bias, cot)]
    ref = _jax_bn(*[jnp.asarray(v) for v in args], jnp.float32)
    got = _port_bn(*args, torch.float32, torch.float32)
    keep = slice(1, None) if clamp else slice(None)
    for a, b in zip(got, ref):
        _close_f32(a[..., keep], b[..., keep])
    if clamp:
        with jax.enable_x64(True):
            exact = _jax_bn(*[jnp.asarray(v.astype(np.float64))
                              for v in args], jnp.float64)
        for i in (3, 4):
            err = np.abs(got[i][..., 0] - exact[i][..., 0]).max()
            ref_err = np.abs(ref[i][..., 0] - exact[i][..., 0]).max()
            assert err <= 2 * ref_err + 1e-6


def _bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


@pytest.mark.parametrize("clamp", [False, True])
def test_bn_train_bf16_matches_jax(clamp):
    """bf16 activations.  The forward: JAX computes ``x·mul − sub`` in
    bf16, rounding ``x·mul`` and the difference, where the port rounds
    once, so they differ by at most one bf16 ulp of ``x·mul``, of
    ``sub`` and of ``y`` (at the clamped channel ``mul`` is 316·scale
    and ``x·mul`` dwarfs ``y``).  The statistics to float32 sum order
    (``_close_f32``), and the gradients to
    ``test_backward.py``'s 3e-2/6e-2/6e-2 of each gradient's max."""
    x, scale, bias, cot = _bn_data(2, (4, 6, 6, 16), clamp)
    f = np.float32
    xb = jnp.asarray(x, f).astype(jnp.bfloat16)
    ref = _jax_bn(xb, jnp.asarray(scale, f), jnp.asarray(bias, f),
                  jnp.asarray(cot, f), jnp.bfloat16)
    xq = np.asarray(xb.astype(jnp.float32))
    got = _port_bn(xq, scale.astype(f), bias.astype(f), cot.astype(f),
                   torch.bfloat16, torch.float32)
    mul = scale / np.sqrt(ref[2] + 1e-5)
    bound = (_bf16_ulp(xq * mul) + _bf16_ulp(ref[1] * mul - bias)
             + _bf16_ulp(ref[0]))
    assert np.all(np.abs(got[0] - ref[0]) <= bound)
    for a, b in zip(got[1:3], ref[1:3]):
        _close_f32(a, b)
    for a, b, tol in zip(got[3:], ref[3:], (3e-2, 6e-2, 6e-2)):
        assert np.max(np.abs(a - b)) <= tol * (np.max(np.abs(b)) + 1e-12)


@pytest.mark.parametrize("fused", [True, False])
def test_bn_running_stats_update_matches_flax(fused):
    """One training-mode forward of the port's BatchNorm module updates
    the running statistics bit-equal to the JAX module's (FusedBatchNorm
    or flax nn.BatchNorm, momentum 0.9, biased variance).  The input is
    small integers, so every batch sum is exact in float32 whatever its
    order and the comparison isolates the update rule."""
    rng = np.random.default_rng(5)
    x = rng.integers(-8, 9, size=(4, 6, 6, 16)).astype(np.float32)
    mean0 = (rng.normal(size=16) * 0.3).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    cls = jax_resnet.FusedBatchNorm if fused else nn.BatchNorm
    mod = cls(use_running_average=False, momentum=0.9, epsilon=1e-5,
              dtype=jnp.float32)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": v["params"],
         "batch_stats": {"mean": jnp.asarray(mean0),
                         "var": jnp.asarray(var0)}}
    _, mut = mod.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    bn = resnet.BatchNorm(16, torch.float32, fused_stats=fused)
    with torch.no_grad():
        bn.mean.copy_(torch.from_numpy(mean0))
        bn.var.copy_(torch.from_numpy(var0))
    bn.train()
    bn(_nchw(x))
    np.testing.assert_array_equal(bn.mean.numpy(),
                                  np.asarray(mut["batch_stats"]["mean"]))
    np.testing.assert_array_equal(bn.var.numpy(),
                                  np.asarray(mut["batch_stats"]["var"]))


def test_bn_train_residual_relu_gradient():
    """With the residual add and ReLU fused, the gradient into x and into
    the residual equal autodiff of ``relu(residual + bn(x))`` written
    with the plain ops (float64, 1e-12): the cotangent is masked where
    the output is not positive, and that masked tensor is the residual's
    gradient."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 3, 4, 5))
    r = rng.normal(size=x.shape)
    scale = rng.normal(size=5) + 1.0
    bias = rng.normal(size=5)
    cot = rng.normal(size=x.shape)

    def run(fused_path):
        xt = _nchw(x).requires_grad_(True)
        rt = _nchw(r).requires_grad_(True)
        st = torch.tensor(scale, requires_grad=True)
        bt = torch.tensor(bias, requires_grad=True)
        if fused_path:
            y, _, _ = bn_train.bn_train(xt, st, bt, 1e-5, False, rt, True)
        else:
            mean = xt.mean((0, 2, 3), keepdim=True)
            var = torch.clamp((xt * xt).mean((0, 2, 3), keepdim=True)
                              - mean * mean, min=0)
            y = (xt - mean) * (torch.rsqrt(var + 1e-5)
                               * st.view(1, -1, 1, 1)) + bt.view(1, -1, 1, 1)
            y = torch.relu(rt + y)
        (y * _nchw(cot)).sum().backward()
        return [t.detach().numpy() for t in (y, xt.grad, rt.grad, st.grad,
                                              bt.grad)]

    for a, b in zip(run(True), run(False)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def _bn_chain_inputs(seed, shape=(4, 16, 6, 6), dtype=torch.float32):
    rng = np.random.default_rng(seed)
    nhwc = shape[:1] + shape[2:] + shape[1:2]
    xa = rng.normal(size=nhwc) * 2 + 1
    xa[..., 0] = 1.5  # a constant channel: the variance clamps to 0
    ya = rng.normal(size=nhwc)
    ya.reshape(-1)[::7] = 0.0  # ReLU outputs exactly 0: masked
    x, y = _nchw(xa, dtype), _nchw(ya, dtype)
    gy = _nchw(rng.normal(size=nhwc), dtype)
    c = shape[1]
    acc = torch.promote_types(dtype, torch.float32)
    scale = torch.tensor(rng.normal(size=c) + 1.0, dtype=acc)
    bias = torch.tensor(rng.normal(size=c), dtype=acc)
    running = (torch.tensor(rng.normal(size=c), dtype=torch.float32),
               torch.tensor(rng.uniform(0.5, 1.5, c), dtype=torch.float32))
    return x, gy, y, scale, bias, running


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().numpy().view(np.uint32)


@pytest.mark.parametrize("world", [1, 2], ids=["one-rank", "two-ranks"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "flax"])
def test_bn_forward_chain_plain_equals_the_composition(fused, world):
    """Kernel C's forward statistics with the ``[C]`` chain folded in
    (one rank: ``bn_forward_stats``; N ranks: ``bn_stats``, the
    all-reduce, ``bn_forward_chain``) against the composition the port
    ran before the chain moved into the kernel: the means, the variance
    clamp, ``bn_coefficients`` and the model's running update, bit for
    bit in f32 on the CPU."""
    x, _, _, scale, bias, running = _bn_chain_inputs(11)
    ra = tuple(r.clone() for r in running)
    inv = float(np.float32(1.0) / np.float32(4 * 6 * 6))
    mean, mean2 = bn_train.channel_sums_reference(x, x, inv)
    if world > 1:
        # The second rank's rows are this rank's, so the sums double.
        mean, mean2 = torch.stack([mean, mean2]) * 2 / world
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    coeffs = bn_train.bn_act_lib.bn_coefficients(scale, bias, mean, var,
                                                 1e-5, x.dtype, fused)
    want_ra = tuple(0.9 * r + (1 - 0.9) * v for r, v in zip(ra, (mean, var)))
    if world == 1:
        got = bn_train.bn_forward_stats(x, scale, bias, 1e-5, fused, running)
    else:
        stats = bn_train.bn_stats(x) * 2  # the all-reduce over two ranks
        got = bn_train.bn_forward_chain(stats, world, scale, bias, 1e-5,
                                        x.dtype, fused, running)
    for a, b in zip(got[:3] + tuple(got[3]) + running,
                    (mean, mean2, var) + tuple(coeffs) + want_ra):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no-relu"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "flax"])
def test_bn_backward_chain_plain_equals_the_composition(fused, relu):
    """Kernel C's backward with the ReLU mask and the ``[C]`` chain
    folded in (``bn_backward``; for N ranks ``bn_backward_local``, the
    all-reduce, ``bn_backward_chain``) and dx with the masked gy written
    beside it, against the composition the port ran before: the mask
    (``torch.where``), the two sums, ``backward_coefficients`` and dx,
    bit for bit in f32 on the CPU."""
    x, gy, y, scale, _, _ = _bn_chain_inputs(12)
    y = y if relu else None
    inv = float(np.float32(1.0) / np.float32(4 * 6 * 6))
    mean, mean2 = bn_train.channel_sums_reference(x, x, inv)
    n = float(4 * 6 * 6)
    gym = torch.where(y > 0, gy, torch.zeros(())) if relu else gy
    s1, s2 = bn_train.channel_sums_reference(gym, x)
    want = bn_train.backward_coefficients(s1, s2, scale, mean, mean2, 1e-5,
                                          n, x.dtype, fused)
    got = bn_train.bn_backward(gy, x, y, scale, mean, mean2, 1e-5, fused)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    want_dx = bn_train.bn_dx_reference(gym, x, None, *want[2:])
    dx, gres = bn_train.bn_dx(gy, x, y, *got[2:], masked_gy=True)
    np.testing.assert_array_equal(_bits(dx), _bits(want_dx))
    np.testing.assert_array_equal(_bits(gres), _bits(gym))
    # Two ranks holding the same rows: global sums double, n doubles.
    sums, dscale, dbias = bn_train.bn_backward_local(gy, x, y, scale, mean,
                                                     mean2, 1e-5, fused)
    for a, b in zip((dscale, dbias), want[:2]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    sums = sums * 2
    want2 = bn_train.backward_coefficients(s1 * 2, s2 * 2, scale, mean,
                                           mean2, 1e-5, 2 * n, x.dtype,
                                           fused)
    for a, b in zip(bn_train.bn_backward_chain(sums, 2 * n, scale, mean,
                                               mean2, 1e-5, x.dtype, fused),
                    want2[2:]):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no-relu"])
@pytest.mark.parametrize("clamp", [False, True])
def test_bn_backward_chain_matches_jax_f64(clamp, relu):
    """float64: the masked reduction and the backward chain
    (``bn_backward``) and dx (``bn_dx``) against the VJP of the JAX
    package's ``_fused_bn_fn`` (through ``jax.nn.relu`` when ``relu``),
    to 1e-10, the clamped channel included."""
    x, scale, bias, cot = _bn_data(8, (3, 5, 5, 8), clamp)
    with jax.enable_x64(True):
        def f(x_, s_, b_):
            y_ = jax_backward.fused_bn_train(x_, s_, b_, dtype=jnp.float64,
                                             epsilon=1e-5)[0]
            return jax.nn.relu(y_) if relu else y_
        _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(scale),
                         jnp.asarray(bias))
        ref = [np.asarray(v) for v in vjp(jnp.asarray(cot))]
    xt, gt = _nchw(x), _nchw(cot)
    st, bt = torch.tensor(scale), torch.tensor(bias)
    mean, mean2, _, coeffs = bn_train.bn_forward_stats(xt, st, bt, 1e-5,
                                                       True)
    y = bn_train.bn_act_lib.bn_act(xt, coeffs, None, True) if relu else None
    dscale, dbias, mul, c2, c1 = bn_train.bn_backward(gt, xt, y, st, mean,
                                                      mean2, 1e-5, True)
    dx = bn_train.bn_dx(gt, xt, y, mul, c2, c1)
    for a, b in zip((_nhwc(dx), dscale.numpy(), dbias.numpy()), ref):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)


def test_every_model_batchnorm_takes_the_vector_access():
    """Kernel C reads 16 bytes a thread when C is a multiple of 8 (bf16)
    or 4 (f32); every BatchNorm of the port's models (both ResNets with
    either stem and head width, VAAL's VAE) has such a width, so the
    one-channel path is only for other callers."""
    from active_learning_tpu_torch.models import vaal

    models = [resnet.resnet18(10, cifar_stem=True),
              resnet.resnet18(1000), resnet.resnet50(1000),
              resnet.resnet50(1000, stem="s2d"), vaal.VAE(64, crop=64)]
    widths = {m.scale.shape[0] for model in models
              for m in model.modules() if isinstance(m, resnet.BatchNorm)}
    assert widths and all(c % 8 == 0 for c in widths), sorted(widths)
    for dtype in (torch.bfloat16, torch.float32):
        for c in widths:
            x = torch.zeros(1, c, 1, 1, dtype=dtype)
            assert bn_train.vector_access(x)


# -- K2: the fused SGD update -----------------------------------------------

def _sgd_tree(seed, state_dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = [(3, 3, 4, 8), (8,), (17,), (5, 7)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
    traces = [rng.normal(size=s).astype(np.float32) for s in shapes]
    return params, grads, traces


@pytest.mark.parametrize("wd", [0.0, 5e-4])
@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_fused_sgd_bit_equal_at_f32_state(wd, momentum):
    params, grads, traces = _sgd_tree(0)
    lr = 0.1
    fused = jax_optim.FusedSGD(momentum, wd, jnp.float32)
    jp = [jnp.asarray(p) for p in params]
    jg = [jnp.asarray(g) for g in grads]
    state = {"trace": [jnp.asarray(t) for t in traces]} if momentum \
        else {"trace": {}}
    new_p, new_s = fused.update(jg, state, jp, jnp.float32(lr))
    tp = [torch.from_numpy(p.copy()) for p in params]
    tt = [torch.from_numpy(t.copy()) for t in traces] if momentum else None
    fused_sgd.fused_sgd_update(tp, [torch.from_numpy(g) for g in grads], tt,
                               lr, momentum, wd)
    for a, b in zip(tp, new_p):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if momentum:
        for a, b in zip(tt, new_s["trace"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fused_sgd_bf16_state_within_one_ulp():
    params, grads, traces = _sgd_tree(1)
    lr, mu, wd = 0.05, 0.9, 5e-4
    tb = [jnp.asarray(t).astype(jnp.bfloat16) for t in traces]
    new_p, new_s = jax_optim.fused_sgd_update(
        [jnp.asarray(g) for g in grads], {"trace": tb},
        [jnp.asarray(p) for p in params], jnp.float32(lr), mu, wd,
        jnp.bfloat16)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tt = [torch.from_numpy(np.asarray(t.astype(jnp.float32))).to(
        torch.bfloat16) for t in tb]
    fused_sgd.fused_sgd_update(tp, [torch.from_numpy(g) for g in grads], tt,
                               lr, mu, wd)
    for a, b in zip(tt, new_s["trace"]):
        ref = np.asarray(b.astype(jnp.float32))
        got = a.float().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert np.all(np.abs(got - ref) <= ulp)
    for a, b in zip(tp, new_p):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-7)


def test_sgd_chain_equals_fused_at_f32_state():
    """``--fused_optimizer off`` is the JAX package's optax chain
    (``add_decayed_weights -> trace -> scale(-lr) -> apply_updates``,
    float32 trace whatever ``optim_state_dtype`` says).  The port runs
    it through kernel D at float32 state and gives the chain's bits, as
    the fused ("on") path does at f32 state."""
    import optax
    params, grads, traces = _sgd_tree(2)
    lr = 0.1
    tx = jax_optim.make_optimizer(JaxOptimizerConfig("sgd", lr, 5e-4, 0.9))
    jp = [jnp.asarray(p) for p in params]
    state = tuple(optax.TraceState(trace=[jnp.asarray(t) for t in traces])
                  if isinstance(s, optax.TraceState) else s
                  for s in tx.init(jp))
    u, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
    ref_p = optax.apply_updates(jp, [-jnp.float32(lr) * v for v in u])
    ref_t = [s for s in state if isinstance(s, optax.TraceState)][0].trace
    cfg = TrainConfig(optimizer=OptimizerConfig("sgd", lr, 5e-4, 0.9))
    for mode, state_dtype in (("off", "bf16"), ("on", "f32")):
        opt = optim.make_optimizer(dataclasses.replace(
            cfg, fused_optimizer=mode, optim_state_dtype=state_dtype))
        assert type(opt) is optim.FusedSGD
        tp = [torch.from_numpy(p.copy()) for p in params]
        opt.init(tp)
        assert opt.trace[0].dtype == torch.float32
        for t, v in zip(opt.trace, traces):
            t.copy_(torch.from_numpy(v))
        opt.step(tp, [torch.from_numpy(g) for g in grads], lr)
        for a, b in zip(tp + opt.trace, list(ref_p) + list(ref_t)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_adam_matches_optax():
    import optax
    params, grads, _ = _sgd_tree(3)
    cfg = TrainConfig(optimizer=OptimizerConfig("adam", 1e-3))
    opt = optim.make_optimizer(cfg)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt.init(tp)
    tx = optax.scale_by_adam()
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    for _ in range(2):
        u, st = tx.update([jnp.asarray(g) for g in grads], st, jp)
        jp = optax.apply_updates(jp, [-jnp.float32(1e-3) * v for v in u])
        opt.step(tp, [torch.from_numpy(g) for g in grads], 1e-3)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


# -- augmentation, metrics, schedules, loss -----------------------------------

def test_crop_flip_matches_jax_given_its_draws():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (6, 10, 12, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax_augment.random_crop_flip(jnp.asarray(images), key,
                                                  pad=4))
    # The draws random_crop_flip made, reproduced with the same calls.
    key_crop, key_flip = jax.random.split(key)
    offsets = np.asarray(jax.random.randint(key_crop, (6, 2), 0, 9))
    flip = np.asarray(jax.random.bernoulli(key_flip, 0.5, (6,)))
    assert flip.any() and not flip.all()
    got = augment.crop_flip(torch.from_numpy(images),
                            torch.from_numpy(offsets).long(),
                            torch.from_numpy(flip), pad=4)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_random_crop_flip_draws_from_the_generator():
    images = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (8, 8, 8, 3), dtype=np.uint8))
    a = augment.random_crop_flip(images, torch.Generator().manual_seed(5))
    b = augment.random_crop_flip(images, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.shape == images.shape
    view = ViewSpec(SYNTH_NORM, augment=True)
    with pytest.raises(ValueError, match="Generator"):
        augment.apply_view(images, view)


def test_batch_metric_counts_matches_jax_with_ties():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(16, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 16).astype(np.int32)
    logits[:6] = np.round(logits[:6])  # many exact ties
    logits[6:9] = 0.5                  # every class tied
    logits[9, :] = logits[9, labels[9]]
    mask = np.ones(16, np.float32)
    mask[-3:] = 0.0
    ref = jax_evaluation.batch_metric_counts(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask), 7)
    got = evaluation.batch_metric_counts(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(mask), 7)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    for k in ("top_1_correct", "top_k_correct", "corrects_byclass",
              "count_byclass", "cal_count"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("sched", [
    SchedulerConfig("step", step_size=3, gamma=0.1),
    SchedulerConfig("cosine", t_max=10),
    SchedulerConfig("cosine", t_max=10, warmup_epochs=3),
    SchedulerConfig("constant")])
def test_lr_schedules_match_jax(sched):
    ref = jax_optim.make_lr_schedule(
        JaxSchedulerConfig(**dataclasses.asdict(sched)), 0.1)
    got = optim.make_lr_schedule(sched, 0.1)
    assert [got(e) for e in range(12)] == [ref(e) for e in range(12)]


def test_batch_scaling_matches_jax():
    cfg = TrainConfig(scheduler=SchedulerConfig("cosine", t_max=20))
    got, changed = optim.apply_batch_scaling(cfg, 4)
    jcfg = JaxTrainConfig(scheduler=JaxSchedulerConfig("cosine", t_max=20))
    ref, _ = jax_optim.apply_batch_scaling(jcfg, 4)
    assert changed
    assert got.loader_tr.batch_size == ref.loader_tr.batch_size
    assert got.optimizer.lr == ref.optimizer.lr
    assert got.scheduler.warmup_epochs == ref.scheduler.warmup_epochs


def _jax_trainer_stub(imbalanced: bool):
    class Stub:
        cfg = JaxTrainConfig(imbalanced_training=imbalanced)
        num_classes = 6
    return Stub()


@pytest.mark.parametrize("imbalanced", [False, True])
def test_class_weights_match_jax(imbalanced):
    labels = np.array([0, 0, 0, 1, 2, 2, 5])
    ref = jax_trainer.Trainer.class_weights(_jax_trainer_stub(imbalanced),
                                            labels)
    tr = trainer.Trainer.__new__(trainer.Trainer)
    tr.cfg = TrainConfig(imbalanced_training=imbalanced)
    tr.num_classes = 6
    np.testing.assert_array_equal(tr.class_weights(labels), ref)


def test_weighted_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(8, 5)) * 3).astype(np.float32)
    labels = rng.integers(0, 5, 8).astype(np.int32)
    w = rng.uniform(0, 1, 8).astype(np.float32)
    w[-2:] = 0.0
    ref = float(jax_trainer.weighted_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w)))
    got = float(trainer.weighted_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(w)))
    assert got == pytest.approx(ref, rel=1e-6)


# -- host pipeline and pools -------------------------------------------------

def test_batches_are_bit_identical_at_the_same_rng_state():
    port = get_data_synthetic(n_train=40, n_test=8, num_classes=4,
                              image_size=8, seed=3)[0]
    ref = jax_get_data_synthetic(n_train=40, n_test=8, num_classes=4,
                                 image_size=8, seed=3)[0]
    np.testing.assert_array_equal(port.images, ref.images)
    np.testing.assert_array_equal(port.targets, ref.targets)
    idxs = np.arange(3, 37)
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(2):  # two epochs: the rng advances identically
        got = list(pipeline.iterate_batches(port, idxs, 8, shuffle=True,
                                            rng=r1, num_threads=2))
        exp = list(jax_pipeline.iterate_batches(ref, idxs, 8, shuffle=True,
                                                rng=r2))
        assert len(got) == len(exp) == 5
        for a, b in zip(got, exp):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert r1.integers(1 << 30) == r2.integers(1 << 30)


@pytest.mark.parametrize("kind", ["random", "random_balance"])
def test_initial_pools_are_bit_identical(kind):
    targets = np.random.default_rng(0).integers(0, 7, 300)
    ev = initial_pool.generate_eval_idxs(targets, 7, 0.1, random_seed=99)
    ev_ref = jax_initial_pool.generate_eval_idxs(targets, 7, 0.1,
                                                 random_seed=99)
    np.testing.assert_array_equal(ev, ev_ref)
    got = initial_pool.generate_init_lb_idxs(targets, 7, ev, 45, kind,
                                             random_seed=98)
    ref = jax_initial_pool.generate_init_lb_idxs(targets, 7, ev_ref, 45,
                                                 kind, random_seed=98)
    np.testing.assert_array_equal(got, ref)


# -- one full train step ------------------------------------------------------

def _tiny_pair(fused_stats: bool, seed: int = 0, freeze: bool = False,
               stem=None):
    """A stage_sizes (1, 1) BasicBlock classifier in both packages
    (float32), with the JAX model's own init and batch statistics
    redrawn from a numpy seed: the CIFAR stem, or with ``stem``
    ("default" or "s2d") the ImageNet stem."""
    jmodel = jax_resnet.SSLClassifier(
        stage_sizes=(1, 1), block_cls=jax_resnet.BasicBlock, num_classes=4,
        cifar_stem=stem is None, stem=stem or "default", dtype=jnp.float32,
        freeze_feature=freeze,
        bn_stats_dtype=jnp.bfloat16 if fused_stats else None)
    x0 = np.zeros((1, 8, 8, 3), np.float32)
    variables = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(seed), x0, train=False))
    rng = np.random.default_rng(seed + 1)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.normal(size=v.shape) * 0.2).astype(np.float32)
        if p[-1].key == "mean" else
        rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if p[-1].key == "var" else v, variables)
    model = resnet.SSLClassifier((1, 1), resnet.BasicBlock, 4,
                                 cifar_stem=stem is None,
                                 dtype=torch.float32,
                                 fused_stats=fused_stats,
                                 freeze_feature=freeze,
                                 stem=stem or "default")
    model = model.to(memory_format=torch.channels_last)
    weights.load_flax_variables(model, variables)
    return jmodel, variables, model


def _train_cfgs():
    opt = dict(name="sgd", lr=0.1, weight_decay=5e-4, momentum=0.9)
    port = TrainConfig(loader_tr=LoaderConfig(batch_size=8),
                       loader_te=LoaderConfig(batch_size=8),
                       optimizer=OptimizerConfig(**opt),
                       scheduler=SchedulerConfig("constant"))
    ref = JaxTrainConfig(loader_tr=JaxLoaderConfig(batch_size=8),
                         loader_te=JaxLoaderConfig(batch_size=8),
                         optimizer=JaxOptimizerConfig(**opt),
                         scheduler=JaxSchedulerConfig("constant"),
                         resident_scoring_bytes=0)
    return port, ref


@pytest.mark.parametrize("fused_stats,freeze,stem,pretrained", [
    pytest.param(True, False, None, False, id="True-False"),
    pytest.param(False, False, None, False, id="False-False"),
    pytest.param(True, True, None, False, id="True-True"),
    pytest.param(True, False, "default", False, id="default-True-False"),
    pytest.param(True, False, "s2d", False, id="s2d-True-False"),
    pytest.param(False, False, "s2d", False, id="s2d-False-False"),
    pytest.param(True, False, None, True, id="finetune-True-False"),
    pytest.param(False, False, None, True, id="finetune-False-False")])
def test_one_train_step_matches_jax(fused_stats, freeze, stem, pretrained):
    """One f32 train step (non-augmenting view, B=8 with 2 padding rows)
    from carried weights, batch statistics and momentum; with
    ``freeze_feature`` BN runs in eval mode and the encoder gets a zero
    gradient (weight decay and momentum still move it); with a
    ``pretrained`` checkpoint configured (``train_bn=False, freeze=False``:
    pretrained fine-tuning) BN runs in eval mode and the encoder trains
    through it (kernel B′'s plain version), in both formulas.  The CIFAR stem,
    or the ImageNet stem (``stem``): the default 7x7/s2 conv, or the s2d
    stem fed space-to-depth rows by both packages, whose weight gradient
    is the JAX package's custom VJP and kernel I's plain version.
    Tolerances:
    the loss to 1e-5 relative; the gradient norm to 1e-4 relative; new
    parameters and trace to 1e-5 absolute (they move by lr·t' ≈ 0.1·|g|,
    and the gradients agree to ~1e-5 of their size: the same network
    with every convolution and reduction summed in another order); new
    batch statistics to 1e-5 absolute (means of ~100 terms)."""
    from active_learning_tpu.parallel import mesh as mesh_lib
    from active_learning_tpu.train.trainer import Trainer as JaxTrainer

    jmodel, variables, model = _tiny_pair(fused_stats, freeze=freeze,
                                          stem=stem)
    port_cfg, jax_cfg = _train_cfgs()
    if pretrained:
        # Only whether a path is configured matters to the trainers: the
        # strategies load the file, and here the weights are carried.
        port_cfg = dataclasses.replace(
            port_cfg, pretrained=PretrainedConfig(path="simclr.pth.tar"))
        jax_cfg = dataclasses.replace(
            jax_cfg, pretrained=JaxPretrainedConfig(path="simclr.pth.tar"))
    rng = np.random.default_rng(7)
    trace = jax.tree.map(
        lambda v: (rng.normal(size=v.shape) * 0.01).astype(np.float32),
        variables["params"])
    images = rng.integers(0, 256, (8, 8, 8, 3), dtype=np.uint8)
    if stem == "s2d":
        images = pipeline.space_to_depth(images)
    labels = rng.integers(0, 4, 8).astype(np.int32)
    mask = np.array([1] * 6 + [0] * 2, np.float32)
    view = JaxViewSpec(JAX_SYNTH_NORM, augment=False)

    jt = JaxTrainer(jmodel, jax_cfg, mesh_lib.make_mesh(1), 4)
    assert jt.train_bn == (not (freeze or pretrained))
    st = jt.init_state(jax.random.PRNGKey(0), images[:1])
    st = st.replace(params=jax.tree.map(jnp.asarray, variables["params"]),
                    batch_stats=jax.tree.map(jnp.asarray,
                                             variables["batch_stats"]),
                    opt_state={"trace": jax.tree.map(jnp.asarray, trace)})
    batch = {"image": images, "label": labels, "mask": mask,
             "index": np.arange(8, dtype=np.int32)}
    st, loss_ref, gnorm_ref = jt._train_step(
        st, batch, jax.random.PRNGKey(1), jnp.float32(0.1),
        jnp.ones(4, jnp.float32), view=view)
    ref = jax.tree.map(np.asarray, {"params": st.params,
                                    "batch_stats": st.batch_stats})
    ref_trace = jax.tree.map(np.asarray, st.opt_state)

    tr = trainer.Trainer(model, port_cfg, 4, "cpu")
    assert tr.train_bn == (not (freeze or pretrained))
    for t, (k, v) in zip(tr.optimizer.trace, model.named_parameters()):
        t.copy_(weights.from_flax_trace({"trace": trace})[k])
    model.train(tr.train_bn)
    loss, gnorm = tr.train_step(
        tr.to_device(batch), 0.1, torch.ones(4),
        ViewSpec(SYNTH_NORM, augment=False), None)
    assert float(loss) == pytest.approx(float(loss_ref), rel=1e-5)
    assert float(gnorm) == pytest.approx(float(gnorm_ref), rel=1e-4)
    got = weights.to_flax_variables(model.state_dict())
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    got_trace = weights.to_flax_trace(
        dict(zip([k for k, _ in model.named_parameters()],
                 tr.optimizer.trace)))
    for a, b in zip(jax.tree.leaves(got_trace), jax.tree.leaves(ref_trace)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("state", [jnp.float32, jnp.bfloat16])
def test_trace_carry_round_trip_is_exact(state):
    """The fused optimizer's trace, f32 or bf16 (ml_dtypes leaves, which
    the port widens to float32 and narrows back), carries both ways."""
    _, variables, model = _tiny_pair(True)
    trace = {"trace": jax.tree.map(
        lambda v: np.asarray(jnp.asarray(v * 0.5).astype(state)),
        variables["params"])}
    port = weights.from_flax_trace(trace)
    want = torch.float32 if state == jnp.float32 else torch.bfloat16
    assert all(t.dtype == want for t in port.values())
    back = weights.to_flax_trace(port)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(trace)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    assert set(port) == {k for k, _ in model.named_parameters()}
