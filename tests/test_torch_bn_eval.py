"""Kernel B′'s plain version (``ops/bn_act.bn_act_backward_reference``)
and the eval-mode BatchNorm Function against ``jax.vjp`` of the JAX
package's eval-mode BatchNorm (``FusedBatchNorm`` or flax
``nn.BatchNorm`` with ``use_running_average``), residual add and
``nn.relu``, on the CPU.

Inputs come from a numpy seed.  Two channels have mean 0 and bias 0 and
rows of x = 0 (and residual 0) there, so the pre-activation is exactly
0 at those elements in both packages: jax.nn.relu's gradient is 0 there
and so is the port's mask.

The backward is held on JAX's own forward output (the ReLU mask is read
from the stored output, and in bf16 the two forwards round the
pre-activation in different places).  Tolerances, each with its reason:

* ``dx`` and ``d_residual``: bit for bit, f32 and bf16 (one product
  ``dz·mul`` rounded once to the activation dtype on both sides; the
  mask copies), given JAX's own ``mul``: XLA:CPU's rsqrt and torch's
  differ by an ulp on some inputs, a difference of the forward's
  coefficients that the end-to-end test bounds.
* ``d scale`` and ``d bias`` in f32: within 2⁻²⁰ of the sum of the
  terms' magnitudes (float32 sums of ~100 terms in another order).
* in bf16: within 2 bf16 units of the sum of the terms' magnitudes
  (JAX rounds the cotangents of ``mul`` and ``sub`` to bf16 before the
  float32 chain, and so does autograd's chain through
  ``bn_coefficients``, but each side rounds a sum taken in another
  order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from active_learning_tpu.models import resnet as jax_resnet

from active_learning_tpu_torch.models import resnet
from active_learning_tpu_torch.ops import bn_act as ba

EPS = 1e-5
SHAPE = (4, 6, 6, 16)  # NHWC


def _nchw(a: np.ndarray, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)
    return t.to(dtype).contiguous(memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).to(torch.float64).numpy()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=SHAPE) * 2 + 0.5).astype(np.float32)
    res = rng.normal(size=SHAPE).astype(np.float32)
    cot = rng.normal(size=SHAPE).astype(np.float32)
    c = SHAPE[-1]
    scale = (rng.uniform(0.5, 1.5, c)).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    mean = rng.normal(size=c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    # Exact zeros of the pre-activation: mean 0, bias 0, x 0 (and the
    # residual 0) in half the rows of channels 0 and 5.
    for ch in (0, 5):
        mean[ch] = bias[ch] = 0.0
        x[::2, ..., ch] = 0.0
        res[::2, ..., ch] = 0.0
    return x, res, cot, scale, bias, mean, var


def _jax_eval_bn(fused, dt, mean, var, residual, relu):
    cls = jax_resnet.FusedBatchNorm if fused else nn.BatchNorm
    mod = cls(use_running_average=True, momentum=0.9, epsilon=EPS, dtype=dt)
    stats = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}

    def f(x, scale, bias, res):
        y = mod.apply({"params": {"scale": scale, "bias": bias},
                       "batch_stats": stats}, x)
        if residual:
            y = res + y
        return nn.relu(y) if relu else y

    return f


CASES = [(False, False), (False, True), (True, True)]
IDS = ["plain", "relu", "residual-relu"]


def _jax_run(seed, fused, dt, residual, relu):
    x, res, cot, scale, bias, mean, var = _inputs(seed)
    f = _jax_eval_bn(fused, dt, mean, var, residual, relu)
    args = (jnp.asarray(x).astype(dt), jnp.asarray(scale),
            jnp.asarray(bias), jnp.asarray(res).astype(dt))
    y, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(cot).astype(dt))
    return (x, res, cot, scale, bias, mean, var), y, grads


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _jax_mul(scale, var, fused, dt) -> torch.Tensor:
    """The forward's ``mul`` as the JAX package computes it, float32."""
    r = jax.lax.rsqrt(jnp.asarray(var) + EPS)
    mul = (jnp.asarray(scale) * r).astype(dt) if fused \
        else r * jnp.asarray(scale)
    return torch.from_numpy(np.asarray(mul.astype(jnp.float32)).copy())


def _port_backward(inputs, y_ref, fused, dtype, residual, relu):
    """The plain version on JAX's forward output, then autograd's chain
    through ``bn_coefficients`` to the parameters."""
    x, res, cot, scale, bias, mean, var = inputs
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    xt = _nchw(np.asarray(jnp.asarray(x).astype(dtype), np.float32), tdt)
    g = _nchw(np.asarray(jnp.asarray(cot).astype(dtype), np.float32), tdt)
    y = _nchw(np.asarray(y_ref, np.float32), tdt) if relu else None
    st = torch.tensor(scale, requires_grad=True)
    bt = torch.tensor(bias, requires_grad=True)
    shift, mul, add = ba.bn_coefficients(st, bt, torch.tensor(mean),
                                         torch.tensor(var), EPS, tdt, fused)
    dx, dres, d_mul, d_add = ba.bn_act_backward(
        g, xt, y, shift.detach(), _jax_mul(scale, var, fused, dtype),
        residual)
    dscale, dbias = torch.autograd.grad((mul, add), (st, bt),
                                        (d_mul, d_add))
    terms = (dx, dres, dscale, dbias)
    # The sums' magnitudes: Σ|dz|·(|x − shift| + 1) bounds both chains'
    # inputs scaled by |∂|; used as the scale of the parameter gradients.
    dz = ba.bn_act_backward_reference(g, xt, y, shift.detach(),
                                      mul.detach(), True)[1].float()
    mag = (dz.abs() * ((xt.float() - shift.detach().view(1, -1, 1, 1))
                       .abs() + 1)).sum((0, 2, 3))
    return terms, mag, torch.rsqrt(torch.tensor(var) + EPS)


@pytest.mark.parametrize("residual,relu", CASES, ids=IDS)
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "flax"])
def test_backward_plain_matches_jax_vjp_f32(fused, residual, relu):
    inputs, y_ref, grads = _jax_run(3, fused, jnp.float32, residual, relu)
    (dx, dres, dscale, dbias), mag, r = _port_backward(
        inputs, y_ref, fused, jnp.float32, residual, relu)
    jdx, jscale, jbias, jres = (np.asarray(v) for v in grads)
    np.testing.assert_array_equal(_bits(_nhwc(dx).astype(np.float32)),
                                  _bits(jdx.astype(np.float32)))
    if residual:
        np.testing.assert_array_equal(
            _bits(_nhwc(dres).astype(np.float32)), _bits(jres))
    tol = 2.0 ** -20 * mag.numpy()
    assert np.all(np.abs(dbias.numpy() - jbias) <= tol)
    assert np.all(np.abs(dscale.numpy() - jscale) <= tol * r.numpy())
    if relu:
        # The exact zeros got jax.nn.relu's zero gradient on both sides.
        zero = np.asarray(y_ref) == 0
        assert zero[::2, ..., 0].all()
        assert np.all(_nhwc(dx)[zero] == 0)


@pytest.mark.parametrize("residual,relu", CASES, ids=IDS)
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "flax"])
def test_backward_plain_matches_jax_vjp_bf16(fused, residual, relu):
    inputs, y_ref, grads = _jax_run(4, fused, jnp.bfloat16, residual,
                                    relu)
    (dx, dres, dscale, dbias), mag, r = _port_backward(
        inputs, y_ref, fused, jnp.bfloat16, residual, relu)
    jdx, jscale, jbias, jres = grads
    want_dx = np.asarray(jnp.asarray(jdx).astype(jnp.float32))
    np.testing.assert_array_equal(_nhwc(dx).astype(np.float32), want_dx)
    if residual:
        np.testing.assert_array_equal(
            _nhwc(dres).astype(np.float32),
            np.asarray(jnp.asarray(jres).astype(jnp.float32)))
    unit = 2.0 ** -7 * mag.numpy()
    assert np.all(np.abs(dbias.numpy() - np.asarray(jbias)) <= 2 * unit)
    assert np.all(np.abs(dscale.numpy() - np.asarray(jscale))
                  <= 2 * unit * r.numpy())


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "flax"])
def test_eval_bn_function_matches_jax_vjp_f32(fused):
    """The model's path end to end: ``BatchNorm`` in eval mode with
    gradients recorded (kernel B forward, kernel B′ backward, the
    coefficients in the graph), residual and ReLU, against jax.vjp of
    the JAX BatchNorm: the forward within 2⁻²⁰ of |x·mul| + |add| + |r|
    (XLA may contract the affine into an FMA, and its rsqrt may differ
    from torch's by an ulp), dx within 2⁻²² of |g·mul| (that ulp of
    ``mul``), d_residual bit for bit, d scale and d bias as the plain
    version's tolerances, with the mask on the port's own forward
    (finite random data: no pre-activation within a rounding of 0 apart
    from the exact zeros)."""
    inputs, y_ref, grads = _jax_run(5, fused, jnp.float32, True, True)
    x, res, cot, scale, bias, mean, var = inputs
    bn = resnet.BatchNorm(SHAPE[-1], torch.float32, fused)
    bn.eval()
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.mean.copy_(torch.from_numpy(mean))
        bn.var.copy_(torch.from_numpy(var))
    xt = _nchw(x, torch.float32).requires_grad_(True)
    rt = _nchw(res, torch.float32).requires_grad_(True)
    before = ba.bwd_launches
    y = bn(xt, residual=rt, relu=True)
    y.backward(_nchw(cot, torch.float32))
    assert ba.bwd_launches == before  # CPU tensors: the plain version
    mul = np.abs(scale / np.sqrt(var + EPS))
    bound = 2.0 ** -20 * (np.abs(x) * mul + np.abs(bias) + np.abs(mean)
                          * mul + np.abs(res))
    assert np.all(np.abs(_nhwc(y) - np.asarray(y_ref)) <= bound)
    jdx, jscale, jbias, jres = (np.asarray(v) for v in grads)
    assert np.all(np.abs(_nhwc(xt.grad) - jdx)
                  <= 2.0 ** -22 * np.abs(cot) * mul)
    np.testing.assert_array_equal(_nhwc(rt.grad).astype(np.float32), jres)
    dz = np.where(np.asarray(y_ref) > 0, cot, 0)
    shift = 0.0 if fused else mean
    mag = (np.abs(dz) * (np.abs(x - shift) + 1)).sum((0, 1, 2))
    r = 1 / np.sqrt(var + EPS)
    assert np.all(np.abs(bn.bias.grad.numpy() - jbias) <= 2.0 ** -20 * mag)
    assert np.all(np.abs(bn.scale.grad.numpy() - jscale)
                  <= 2.0 ** -20 * mag * r)


def test_cached_coefficients_serve_only_gradient_free_forwards():
    """With gradients recorded the coefficients are made in the graph
    that step (no cache); under ``no_grad`` the cached ones serve, and an
    in-place write to ``scale`` makes them anew."""
    bn = resnet.BatchNorm(8, torch.float32, False)
    bn.eval()
    x = torch.randn(2, 8, 3, 3).contiguous(memory_format=torch.channels_last)
    y = bn(x, relu=True)
    assert y.requires_grad and bn._coeffs is None
    with torch.no_grad():
        first = bn.coefficients()
        assert bn.coefficients() is first
        bn.scale.mul_(2.0)
        second = bn.coefficients()
    assert second is not first
    torch.testing.assert_close(second[1], 2 * first[1], rtol=0, atol=0)
