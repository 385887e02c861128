"""The port's kernel modules against the JAX package (CPU, plain versions).

* ``ops.prob_stats``: the plain version against the JAX step's softmax
  statistics (strategies/scoring.py::make_prob_stats_step, run through
  the step itself with a stub model), on random logits with C in
  {10, 1000}, rows with exact ties and rows whose probabilities underflow
  to 0.  ``pred`` exact; confidence and margin within 1e-6 absolute;
  entropy within 1e-6 absolute plus 1e-6 of its value, because it is a
  sum of C float32 terms taken in another order (XLA's and torch's sums
  of 1000 terms differ by up to ~5 ulp at ln 1000, 2.4e-6).
* ``ops.bn_act``: the plain version against JAX's eval-mode
  ``FusedBatchNorm`` (bf16) and flax ``nn.BatchNorm`` (f32), each
  followed by the block's ``relu(residual + y)``.
The kernels themselves are held against these plain versions on the
card by ``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from active_learning_tpu.data.core import ViewSpec as JaxViewSpec
from active_learning_tpu.data.synthetic import SYNTH_NORM
from active_learning_tpu.models.resnet import FusedBatchNorm
from active_learning_tpu.strategies import scoring as jax_scoring

from active_learning_tpu_torch.ops import _build
from active_learning_tpu_torch.ops import bn_act as ba
from active_learning_tpu_torch.ops import prob_stats as ps


# -- prob_stats --------------------------------------------------------------

class _LogitsModel:
    """Stub flax model for the JAX step: ``apply`` returns the logits
    carried in ``variables``, so the step's softmax math runs as is."""

    def apply(self, variables, x, train=False):
        return variables["logits"]


def _jax_prob_stats(logits: np.ndarray):
    step = jax_scoring.make_prob_stats_step(
        _LogitsModel(), JaxViewSpec(SYNTH_NORM, augment=False))
    batch = {"image": np.zeros((logits.shape[0], 1, 1, 3), np.uint8)}
    out = step({"logits": jnp.asarray(logits)}, batch)
    return {k: np.asarray(v) for k, v in out.items()}


def _logits(c: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((24, c)).astype(np.float32) * 2.0
    # Rows 0-7: an exact top-2 tie, with the twin after / before the max.
    for r in range(8):
        top = int(np.argmax(x[r]))
        x[r, (top + 1 + r) % c] = x[r, top]
    # Rows 8-11: all but a few probabilities underflow to exactly 0.
    x[8:12] = -200.0
    x[8:12, :3] = rng.standard_normal((4, 3)).astype(np.float32)
    # Row 12: a constant row (every class tied).
    x[12] = 1.5
    return x


@pytest.mark.parametrize("c", [10, 1000])
def test_prob_stats_reference_matches_jax_step(c):
    x = _logits(c, seed=c)
    ref = _jax_prob_stats(x)
    got = {k: v.numpy() for k, v in
           ps.prob_stats(torch.from_numpy(x)).items()}
    assert got["pred"].dtype == np.int32
    np.testing.assert_array_equal(got["pred"], ref["pred"])
    for k in ("confidence", "margin"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["entropy"], ref["entropy"], rtol=1e-6,
                               atol=1e-6)
    # Underflowed probabilities contribute 0, never NaN.
    assert np.isfinite(got["entropy"]).all()
    # Ties: margin exactly 0, pred the lower index.
    assert (got["margin"][:8] == 0).all()


def test_prob_stats_ties_go_to_the_lower_index():
    """top_k([.2, .4, .4, 0]) ranks index 1 before index 2."""
    p = np.array([[0.2, 0.4, 0.4, 1e-30]], np.float32)
    x = np.log(p)
    _, idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x)), 2)
    assert np.asarray(idx).tolist() == [[1, 2]]
    got = ps.prob_stats(torch.from_numpy(x))
    assert got["pred"].tolist() == [1]
    assert got["margin"].tolist() == [0.0]
    assert _jax_prob_stats(x)["pred"].tolist() == [1]


def test_prob_stats_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        ps.prob_stats(torch.zeros(2, 10, dtype=torch.float64))
    with pytest.raises(ValueError):
        ps.prob_stats(torch.zeros(2, 1))
    with pytest.raises(ValueError):
        ps.prob_stats(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        ps.prob_stats(torch.zeros(2, 10, device="meta"))


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    before = (ps.launches, ba.launches)
    ps.prob_stats(torch.zeros(2, 10))
    x = torch.zeros(1, 4, 2, 2).to(memory_format=torch.channels_last)
    ba.bn_act(x, tuple(torch.zeros(4) for _ in range(3)))
    assert (ps.launches, ba.launches) == before


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_build_names_every_source_with_its_hash():
    assert _build.sources() == ["bn_train", "fused_sgd", "prob_stats"]
    path = _build.library_path("prob_stats")
    assert path.startswith(_build.BUILD_DIR)
    assert path == _build.library_path("prob_stats")


# -- bn_act ------------------------------------------------------------------

def _bn_inputs(c: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5, 3, c)).astype(np.float32)
    res = rng.standard_normal((2, 5, 3, c)).astype(np.float32)
    stats = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
             "bias": (rng.standard_normal(c) * 0.3).astype(np.float32),
             "mean": (rng.standard_normal(c) * 0.3).astype(np.float32),
             "var": rng.uniform(0.3, 2.0, c).astype(np.float32)}
    return x, res, stats


def _jax_bn(x, res, stats, dtype, relu):
    """The JAX package's eval BN (FusedBatchNorm for bf16, flax's
    nn.BatchNorm for f32), then the block's ``relu(residual + y)``."""
    cls = FusedBatchNorm if dtype == jnp.bfloat16 else nn.BatchNorm
    mod = cls(use_running_average=True, momentum=0.9, epsilon=1e-5,
              dtype=dtype)
    variables = {"params": {"scale": stats["scale"], "bias": stats["bias"]},
                 "batch_stats": {"mean": stats["mean"], "var": stats["var"]}}
    xj = jnp.asarray(x).astype(dtype)
    y = mod.apply(variables, xj)
    if res is not None:
        y = jnp.asarray(res).astype(dtype) + y
    if relu:
        y = jax.nn.relu(y)
    return np.asarray(y.astype(jnp.float32))


def _port_bn(x, res, stats, dtype, relu):
    def cl(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2).to(
            dtype=dtype, memory_format=torch.channels_last)

    coeffs = ba.bn_coefficients(
        *(torch.from_numpy(stats[k]) for k in ("scale", "bias", "mean",
                                                "var")),
        1e-5, dtype, fused_stats=dtype == torch.bfloat16)
    y = ba.bn_act(cl(x), coeffs, None if res is None else cl(res), relu)
    assert y.is_contiguous(memory_format=torch.channels_last)
    return y.to(torch.float32).permute(0, 2, 3, 1).numpy()


CASES = [(res, relu) for res in (False, True) for relu in (False, True)]


@pytest.mark.parametrize("residual,relu", CASES)
def test_bn_act_f32_matches_flax_batchnorm(residual, relu):
    """f32: the same operations in the same order as flax's
    ``(x − mean)·(rsqrt(var + eps)·scale) + bias``; 1e-6 relative to the
    terms' magnitude allows XLA's own fusion choices."""
    x, res, stats = _bn_inputs(16, seed=1)
    r = res if residual else None
    ref = _jax_bn(x, r, stats, jnp.float32, relu)
    got = _port_bn(x, r, stats, torch.float32, relu)
    terms = (np.abs(x - stats["mean"]) * np.abs(
        stats["scale"] / np.sqrt(stats["var"] + 1e-5))
        + np.abs(stats["bias"]) + (np.abs(res) if residual else 0))
    assert (np.abs(got - ref) <= 1e-6 * terms).all()


@pytest.mark.parametrize("residual,relu", CASES)
def test_bn_act_bf16_matches_fused_batchnorm(residual, relu):
    """bf16: the JAX package rounds to bf16 after ``x·mul``, after
    ``− sub`` and after ``+ residual``; the port rounds once at the
    store.  Each rounding moves a value by at most half a bf16 ulp of
    its own magnitude (2^-9 relative), so the two agree within 2^-8 of
    |x·mul| + |sub| + |residual| + |y|."""
    x, res, stats = _bn_inputs(32, seed=2)
    r = res if residual else None
    ref = _jax_bn(x, r, stats, jnp.bfloat16, relu)
    got = _port_bn(x, r, stats, torch.bfloat16, relu)
    xb = x.astype(jnp.bfloat16).astype(np.float32)
    mul = np.abs(stats["scale"] / np.sqrt(stats["var"] + 1e-5))
    bound = 2.0 ** -8 * (np.abs(xb) * mul + np.abs(stats["mean"]) * mul
                         + np.abs(stats["bias"])
                         + (np.abs(res) if residual else 0)
                         + np.abs(ref))
    assert (np.abs(got - ref) <= bound).all()


def test_bn_coefficients_follow_the_jax_formulas():
    _, _, s = _bn_inputs(8, seed=3)
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    shift, mul, add = ba.bn_coefficients(t["scale"], t["bias"], t["mean"],
                                         t["var"], 1e-5, torch.bfloat16,
                                         fused_stats=True)
    mul_j = (s["scale"] * jax.lax.rsqrt(s["var"] + 1e-5)).astype(
        jnp.bfloat16)
    sub_j = s["mean"].astype(jnp.bfloat16) * mul_j - s["bias"].astype(
        jnp.bfloat16)
    assert (shift == 0).all()
    np.testing.assert_array_equal(mul.numpy(),
                                  np.asarray(mul_j, np.float32))
    np.testing.assert_array_equal(add.numpy(),
                                  -np.asarray(sub_j, np.float32))
    shift, mul, add = ba.bn_coefficients(t["scale"], t["bias"], t["mean"],
                                         t["var"], 1e-5, torch.float32,
                                         fused_stats=False)
    np.testing.assert_array_equal(shift.numpy(), s["mean"])
    np.testing.assert_array_equal(add.numpy(), s["bias"])
    np.testing.assert_allclose(
        mul.numpy(), s["scale"] / np.sqrt(s["var"] + 1e-5), rtol=1e-6)


def test_bn_act_requires_channels_last():
    coeffs = tuple(torch.zeros(4) for _ in range(3))
    x = torch.zeros(2, 4, 3, 3)  # NCHW-contiguous
    with pytest.raises(ValueError, match="channels_last"):
        ba.bn_act(x, coeffs)
    xcl = x.to(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="residual"):
        ba.bn_act(xcl, coeffs, residual=x)
    with pytest.raises(TypeError):
        ba.bn_act(xcl.to(torch.float64), coeffs)
    with pytest.raises(ValueError, match="coefficients"):
        ba.bn_act(xcl, tuple(torch.zeros(3) for _ in range(3)))
