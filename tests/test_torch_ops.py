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
from active_learning_tpu.train import optim as jax_optim

from active_learning_tpu_torch.ops import _build
from active_learning_tpu_torch.ops import bn_act as ba
from active_learning_tpu_torch.ops import fused_sgd as fs
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


# Row kinds of the non-finite checks: each lists the values placed at
# seeded columns of a standard-normal row ("all -inf" fills the row).
NONFINITE_KINDS = {"finite": (), "nan": (np.nan,), "+inf": (np.inf,),
                   "-inf": (-np.inf,), "+inf -inf": (np.inf, -np.inf),
                   "nan +inf": (np.nan, np.inf), "+inf +inf": (np.inf, np.inf),
                   "all -inf": None}


def _nonfinite_logits(c: int, seed: int) -> np.ndarray:
    """Two rows of each kind of ``NONFINITE_KINDS``."""
    rng = np.random.default_rng(seed)
    kinds = list(NONFINITE_KINDS.values()) * 2
    x = rng.standard_normal((len(kinds), c)).astype(np.float32) * 2.0
    for r, vals in enumerate(kinds):
        if vals is None:
            x[r] = -np.inf
        elif vals:
            x[r, rng.choice(c, size=len(vals), replace=False)] = vals
    return x


@pytest.mark.parametrize("c", [10, 1000, 4097])
def test_prob_stats_reference_matches_jax_on_nonfinite_rows(c):
    """Rows with NaN, +inf and -inf: a NaN or a +inf makes every
    probability NaN (pred 0, confidence and margin NaN, as top_k ranks
    NaN first); a -inf is a probability of exactly 0."""
    x = _nonfinite_logits(c, seed=c + 1)
    ref = _jax_prob_stats(x)
    got = {k: v.numpy() for k, v in
           ps.prob_stats(torch.from_numpy(x)).items()}
    np.testing.assert_array_equal(got["pred"], ref["pred"])
    for k in ("confidence", "margin", "entropy"):
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(ref[k]), k)
    for k in ("confidence", "margin"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["entropy"], ref["entropy"], rtol=1e-6,
                               atol=1e-6)
    poisoned = [r for r, v in enumerate(list(NONFINITE_KINDS.values()) * 2)
                if v is None or np.nan in v or np.inf in v]
    assert (got["pred"][poisoned] == 0).all()
    assert np.isnan(got["confidence"][poisoned]).all()


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
    assert _build.sources() == ["badge", "balancing", "bn_act",
                                "bn_eval_bwd", "bn_train", "boundary_radii",
                                "fused_sgd", "int8_sync", "kcenter",
                                "prob_stats", "stem_dw"]
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


def _replay_walk(x, coeffs, residual, relu, pl, blocks):
    """Kernel B's walk on the CPU: thread g of ``blocks`` x THREADS
    keeps channel unit g % upr while g is below the stride (the threads
    rounded down to a multiple of upr) and takes units g, g + stride,
    ...; each element goes through the kernel's float32 operations with
    its thread's coefficients.  Asserts that every unit is taken once."""
    stride = blocks * ba.THREADS // pl.upr * pl.upr
    assert stride >= pl.upr
    owner = np.full(pl.units, -1)
    chan = np.zeros(pl.units, dtype=np.int64)
    for g in range(min(stride, pl.units)):
        us = np.arange(g, pl.units, stride)
        assert (owner[us] == -1).all()
        owner[us] = g
        chan[us] = g % pl.upr
    assert (owner >= 0).all()
    b, c, h, w = x.shape
    idx = torch.from_numpy((chan[:, None] * pl.unit
                            + np.arange(pl.unit)[None, :]).reshape(-1))
    acc = torch.promote_types(x.dtype, torch.float32)
    flat = x.permute(0, 2, 3, 1).reshape(-1).to(acc)  # the NHWC order
    shift, mul, add = (v[idx] for v in coeffs)
    y = (flat - shift) * mul + add
    if residual is not None:
        y = y + residual.permute(0, 2, 3, 1).reshape(-1).to(acc)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).reshape(b, h, w, c).permute(0, 3, 1, 2)


# (shape, dtype, residual, relu, unit): vector widths, scalar channel
# counts, each flag turned in turn, and repeats that must hit the cache.
PLAN_CASES = [((2, 16, 3, 5), torch.bfloat16, False, True, 8),
              ((2, 16, 3, 5), torch.bfloat16, True, True, 8),
              ((2, 16, 3, 5), torch.float32, True, True, 4),
              ((2, 16, 3, 5), torch.float32, True, False, 4),
              ((1, 3, 4, 4), torch.float32, False, False, 1),
              ((2, 33, 2, 3), torch.bfloat16, True, False, 1),
              ((2, 12, 3, 3), torch.bfloat16, False, True, 1),
              ((2, 12, 3, 3), torch.float32, False, True, 4),
              ((2, 16, 3, 5), torch.bfloat16, False, True, 8)]


def test_bn_act_plan_cache_follows_every_fact():
    """Kernel B's plan cache on CPU tensors, as shapes, dtypes and the
    residual and ReLU flags change in turn: each plan's variant, units
    and width are the tensors' own, a repeated case hits the cache, and
    replaying the kernel's walk with the plan gives the plain result bit
    for bit (as does the wrapper, which runs the plain version here)."""
    rng = np.random.default_rng(11)
    seen = {}
    for shape, dtype, residual, relu, unit in PLAN_CASES:
        b, c, h, w = shape

        def cl(a):
            return torch.from_numpy(a).to(dtype).contiguous(
                memory_format=torch.channels_last)

        x = cl(rng.standard_normal(shape).astype(np.float32))
        r = cl(rng.standard_normal(shape).astype(np.float32)) \
            if residual else None
        coeffs = ba.bn_coefficients(
            torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(c).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(c).astype(np.float32)),
            torch.from_numpy(rng.uniform(0.5, 2, c).astype(np.float32)),
            1e-5, dtype, fused_stats=dtype == torch.bfloat16)
        pl = ba.launch_plan(x, coeffs, r, relu)
        assert pl.unit == unit and pl.upr == c // unit
        assert pl.units == x.numel() // unit
        assert pl.variant == ((ba.BF16 if dtype == torch.bfloat16 else 0)
                              | (ba.RES if residual else 0)
                              | (ba.RELU if relu else 0)
                              | (ba.VEC if unit > 1 else 0))
        key = (shape, dtype, residual, relu)
        if key in seen:
            assert pl is seen[key]
        seen[key] = pl
        ref = ba.bn_act_reference(x, coeffs, r, relu)
        for blocks in (1, 3, 7, pl.blocks):
            assert torch.equal(_replay_walk(x, coeffs, r, relu, pl, blocks),
                               ref)
        assert torch.equal(ba.bn_act(x, coeffs, r, relu), ref)


def test_bn_act_plan_takes_the_scalar_path_off_16_bytes():
    """A channels-last view at a storage offset of one element: every
    channel count a vector width holds, but the pointer is not on 16
    bytes, so the plan is scalar; its walk still gives the plain
    result."""
    c = 16
    base = torch.randn(2 * 3 * 3 * c + 1)
    x = base[1:].view(2, 3, 3, c).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    coeffs = tuple(torch.randn(c) for _ in range(3))
    pl = ba.launch_plan(x, coeffs)
    assert pl.unit == 1 and not pl.variant & ba.VEC
    assert torch.equal(_replay_walk(x, coeffs, None, False, pl, 2),
                       ba.bn_act_reference(x, coeffs))
    aligned = x.clone(memory_format=torch.channels_last)
    assert ba.launch_plan(aligned, coeffs).unit == 4


# -- fused_sgd: the leaf split of kernel D ------------------------------------

_BASE = 1 << 20


@pytest.mark.parametrize("numel", [0, 1, 3, 4, 4097])
@pytest.mark.parametrize("offset", [0, 4, 8, 12])
@pytest.mark.parametrize("t_size", [4, 2])
def test_leaf_split_head_vectors_tail(offset, numel, t_size):
    """Buffers that start ``offset`` bytes past a 16-byte boundary (the
    bf16 trace ``offset / 2``): a head of (16 − offset) mod 16 / 4 scalar
    elements, then 4-element vectors at which p, g and the trace are all
    aligned (16 bytes; 8 for bf16), then a tail of fewer than 4."""
    p, g = _BASE + offset, _BASE + 4096 + offset
    t = _BASE + 8192 + offset * t_size // 4
    head, vectors, tail = fs.leaf_split(p, g, t, numel, t_size)
    assert head + 4 * vectors + tail == numel
    if numel == 0:
        assert (head, vectors, tail) == (0, 0, 0)
        return
    want = (16 - offset) % 16 // 4
    if want >= numel:
        assert (head, vectors, tail) == (numel, 0, 0)
        return
    assert head == want and 0 <= tail < 4
    assert (p + 4 * head) % 16 == 0 and (g + 4 * head) % 16 == 0
    assert (t + t_size * head) % (4 * t_size) == 0
    assert fs.leaf_split(p, g, 0, numel) == (head, vectors, tail)


@pytest.mark.parametrize("g_off,t_off", [(4, 0), (0, 8), (12, 12), (0, 2)])
def test_leaf_split_buffers_that_never_align_go_scalar(g_off, t_off):
    """A grad or trace whose offset differs from the param's (a view at
    an odd storage offset beside an aligned buffer) never reaches a
    16-byte boundary at the same element: the whole leaf is its head."""
    assert fs.leaf_split(_BASE, _BASE + 4096 + g_off, _BASE + 8192 + t_off,
                         4097) == (4097, 0, 0)


def _walk(table, units, grid):
    """Each element each block of a ``grid``-block launch updates, as
    ``csrc/fused_sgd.cu`` walks the table: block k takes units [k·U/G,
    (k+1)·U/G), finds its first leaf by bisection over the first units,
    then a leaf's vectors (4 elements from ``head``) and its head and
    tail elements."""
    seen = [np.zeros(int(n), np.int32) for n in table[:, 6]]
    u0s = table[:, 3]
    for k in range(grid):
        ub, ue = units * k // grid, units * (k + 1) // grid
        if ub >= ue:
            continue
        lo = int(np.searchsorted(u0s, ub, side="right")) - 1
        for leaf in range(lo, len(table)):
            u0, n4, head, numel = (int(v) for v in table[leaf, 3:7])
            if u0 >= ue:
                break
            a, z = max(ub, u0) - u0, min(ue - u0, n4 + numel - 4 * n4)
            for v in range(a, min(z, n4)):
                seen[leaf][head + 4 * v:head + 4 * v + 4] += 1
            for u in range(max(a, n4), z):
                s = u - n4
                seen[leaf][s if s < head else s + 4 * n4] += 1
    return seen


def test_leaf_table_units_cover_every_element_once():
    """Every element of every leaf (aligned, odd offsets, never-aligned,
    empty, 1, 3, 4097 and 40,000 elements) is updated by exactly one
    block, for a grid of 1, 7 or 528 blocks."""
    rows, base = [], _BASE
    for i, (n, off, g_off) in enumerate([
            (4097, 0, 0), (1, 4, 4), (0, 0, 0), (3, 8, 8), (40000, 12, 12),
            (4, 4, 0), (64, 0, 0), (4097, 8, 8), (5, 0, 0)]):
        rows.append((base + off, base + (1 << 24) + g_off, 0, n))
        base += 4 * n + 64
    table, units = fs.leaf_table(rows)
    assert units == sum(r[3] for r in rows) - 3 * sum(
        table[:, 4])
    for grid in (1, 7, 528):
        for leaf, seen in enumerate(_walk(table, units, grid)):
            assert (seen == 1).all(), (grid, leaf)


def _views(n: int, offset: int, values: np.ndarray, dtype=torch.float32):
    """A leaf of ``n`` values as a view at storage offset ``offset``."""
    buf = torch.zeros(n + offset + 3, dtype=dtype)
    v = buf[offset:offset + n]
    v.copy_(torch.from_numpy(values).to(dtype))
    return v


@pytest.mark.parametrize("state", ["f32", "bf16"])
def test_plain_update_on_odd_leaves_matches_jax(state):
    """The update on leaves of 1, 3, 4 and 4097 elements held as views at
    storage offsets 1-3 (what the kernel cuts into head, vectors and
    tail) against JAX's ``fused_sgd_update``: bit-equal at f32 state,
    the trace within one bf16 ulp at bf16 state."""
    rng = np.random.default_rng(3)
    sizes, offs = [1, 3, 4, 4097, 4097], [1, 2, 3, 1, 0]
    ps_ = [rng.normal(size=n).astype(np.float32) for n in sizes]
    gs = [rng.normal(size=n).astype(np.float32) for n in sizes]
    ts = [rng.normal(size=n).astype(np.float32) for n in sizes]
    sdt = jnp.float32 if state == "f32" else jnp.bfloat16
    tdt = torch.float32 if state == "f32" else torch.bfloat16
    jt = [jnp.asarray(t).astype(sdt) for t in ts]
    lr, mu, wd = 0.1, 0.9, 1e-4
    new_p, new_s = jax_optim.fused_sgd_update(
        [jnp.asarray(g) for g in gs], {"trace": jt},
        [jnp.asarray(p) for p in ps_], jnp.float32(lr), mu, wd, sdt)
    tp = [_views(n, o, p) for n, o, p in zip(sizes, offs, ps_)]
    tg = [_views(n, (o + 1) % 4, g) for n, o, g in zip(sizes, offs, gs)]
    tt = [_views(n, o, np.array(t.astype(jnp.float32)), tdt)
          for n, o, t in zip(sizes, offs, jt)]
    fs.fused_sgd_update(tp, tg, tt, lr, mu, wd)
    for a, b in zip(tp, new_p):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tt, new_s["trace"]):
        ref = np.asarray(b.astype(jnp.float32))
        got = a.float().numpy()
        if state == "f32":
            np.testing.assert_array_equal(got, ref)
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30)))
                          - 7)
            assert np.all(np.abs(got - ref) <= ulp)


def _c_param_counts(name: str) -> dict:
    """Parameter count of each ``extern "C"`` function of csrc/<name>.cu."""
    import os
    import re
    with open(os.path.join(_build.CSRC_DIR, f"{name}.cu")) as fh:
        text = fh.read()
    body = text[text.index('extern "C" {'):]
    return {m.group(1): len(m.group(2).split(","))
            for m in re.finditer(r"^int (\w+)\(([^)]*)\)", body, re.M)}


@pytest.mark.parametrize("module,source", [("stem_conv", "stem_dw"),
                                           ("int8_sync", "int8_sync"),
                                           ("prob_stats", "prob_stats"),
                                           ("boundary_radii",
                                            "boundary_radii")])
def test_ctypes_bindings_match_the_c_signatures(module, source):
    """Each bound entry point declares as many ctypes arguments as its C
    function takes (a short list would pass a pointer as garbage)."""
    import importlib
    mod = importlib.import_module(f"active_learning_tpu_torch.ops.{module}")
    counts = _c_param_counts(source)
    assert set(mod._ARGTYPES) == set(counts)
    for fn, argtypes in mod._ARGTYPES.items():
        assert len(argtypes) == counts[fn], fn
