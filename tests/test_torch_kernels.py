"""The port's kernels against their plain versions, on the card.

Marked ``cuda``: they skip with a reason where no card is visible (a
skip is not a pass).  This file imports torch and the port only, so it
runs on a machine without JAX; there, skip the JAX-importing conftest:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from active_learning_tpu_torch.ops import badge as bg
from active_learning_tpu_torch.ops import balancing as bal
from active_learning_tpu_torch.ops import bn_act as ba
from active_learning_tpu_torch.ops import bn_train as bt
from active_learning_tpu_torch.ops import boundary_radii as br
from active_learning_tpu_torch.ops import fused_sgd as fs
from active_learning_tpu_torch.ops import int8_sync as j
from active_learning_tpu_torch.ops import kcenter as kc
from active_learning_tpu_torch.ops import prob_stats as ps
from active_learning_tpu_torch.ops import stem_conv as sc
from active_learning_tpu_torch.parallel import mesh as mesh_lib
from active_learning_tpu_torch.utils import threefry

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel runs only there")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("b,c", [(8, 10), (64, 1000), (3, 33), (5, 513),
                                 (1, 2), (256, 1000),
                                 (4, 2048), (3, 2049),
                                 (2, 4097), (2, ps.MAX_CLASSES)])
def test_prob_stats_kernel_matches_plain(cuda_device, b, c):
    """pred exact (ties included); confidence and margin within 1e-6;
    entropy within 1e-6 plus 1e-6 of its value (a sum of C float32
    terms in another order).  C = 2, 33, 513 and 12,288 take each block
    size's edges (32, 128 and 256 threads a row, the last past the 48 KB
    default of shared memory)."""
    g = torch.Generator(device=cuda_device).manual_seed(b * c)
    x = torch.randn(b, c, device=cuda_device, generator=g) * 3.0
    top = x.argmax(dim=1)
    twin = (top + 1) % c
    x[0::2].scatter_(1, twin[0::2, None], x[0::2].gather(1, top[0::2, None]))
    before = ps.launches
    got = ps.prob_stats(x)
    ref = ps.prob_stats_reference(x)
    torch.cuda.synchronize()
    assert ps.launches == before + 1
    assert torch.equal(got["pred"], ref["pred"])
    assert (got["margin"][0::2] == 0).all()
    for k in ("confidence", "margin"):
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=1e-6)
    torch.testing.assert_close(got["entropy"], ref["entropy"], rtol=1e-6,
                               atol=1e-6)


# Row kinds of the non-finite checks: the values placed at seeded columns
# of a standard-normal row ("all -inf" fills the row).
NONFINITE_KINDS = {"finite": (), "nan": (float("nan"),),
                   "+inf": (float("inf"),), "-inf": (float("-inf"),),
                   "+inf -inf": (float("inf"), float("-inf")),
                   "nan +inf": (float("nan"), float("inf")),
                   "+inf +inf": (float("inf"), float("inf")),
                   "all -inf": None}


def _nonfinite_rows(x: torch.Tensor, kinds, seed: int) -> torch.Tensor:
    """``x`` with row r made of kind ``kinds[(r + 1) % len(kinds)]`` (so
    one row is enough for a NaN)."""
    rng = np.random.default_rng(seed)
    x = x.clone()
    for r in range(x.shape[0]):
        vals = NONFINITE_KINDS[kinds[(r + 1) % len(kinds)]]
        if vals is None:
            x[r] = float("-inf")
        elif vals:
            cols = rng.choice(x.shape[1], size=len(vals), replace=False)
            x[r, torch.from_numpy(cols)] = torch.tensor(vals, device=x.device)
    return x


def _same_special(got: torch.Tensor, want: torch.Tensor) -> bool:
    return (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.isposinf(got), torch.isposinf(want))
            and torch.equal(torch.isneginf(got), torch.isneginf(want)))


@pytest.mark.parametrize("b,c", [(16, 10), (16, 1000), (8, 2048), (8, 4097),
                                 (1, 3)])
def test_prob_stats_kernel_on_nonfinite_rows(cuda_device, b, c):
    """Rows with NaN, +inf and -inf as the plain version (and the JAX
    step) has them: a NaN or a +inf makes every probability NaN, so pred
    is 0 and confidence and margin NaN; -inf is a probability of 0."""
    g = torch.Generator(device=cuda_device).manual_seed(c)
    x = torch.randn(b, c, device=cuda_device, generator=g) * 3.0
    x = _nonfinite_rows(x, list(NONFINITE_KINDS), seed=b + c)
    got = ps.prob_stats(x)
    ref = ps.prob_stats_reference(x)
    torch.cuda.synchronize()
    assert torch.equal(got["pred"], ref["pred"])
    assert bool(((got["pred"] >= 0) & (got["pred"] < c)).all())
    for k in ("confidence", "margin", "entropy"):
        assert _same_special(got[k], ref[k]), k
    for k in ("confidence", "margin"):
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=1e-6,
                                   equal_nan=True)
    torch.testing.assert_close(got["entropy"], ref["entropy"], rtol=1e-6,
                               atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("residual,relu", [(False, False), (False, True),
                                           (True, True)])
def test_bn_act_kernel_matches_plain(cuda_device, dtype, residual, relu):
    """Contraction is off in the kernel, so it does the plain version's
    float32 operations in the same order: bit-equal.  96 channels and
    7x9 pixels leave ragged tiles in both directions."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(4, 96, 7, 9, device=cuda_device, generator=g).to(
        dtype=dtype, memory_format=torch.channels_last)
    r = torch.randn(x.shape, device=cuda_device, generator=g).to(
        dtype=dtype, memory_format=torch.channels_last) if residual else None
    c = x.shape[1]
    coeffs = ba.bn_coefficients(
        torch.rand(c, device=cuda_device, generator=g) + 0.5,
        torch.randn(c, device=cuda_device, generator=g),
        torch.randn(c, device=cuda_device, generator=g),
        torch.rand(c, device=cuda_device, generator=g) + 0.5, 1e-5, dtype,
        fused_stats=dtype == torch.bfloat16)
    before = ba.launches
    got = ba.bn_act(x, coeffs, r, relu)
    ref = ba.bn_act_reference(x, coeffs, r, relu)
    torch.cuda.synchronize()
    assert ba.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, ref)


def test_wrappers_raise_rather_than_fall_back(cuda_device):
    with pytest.raises(ValueError, match="contiguous"):
        ps.prob_stats(torch.zeros(4, 20, device=cuda_device)[:, ::2])
    x = torch.zeros(2, 8, 3, 3, device=cuda_device)  # NCHW-contiguous
    coeffs = tuple(torch.zeros(8, device=cuda_device) for _ in range(3))
    with pytest.raises(ValueError, match="channels_last"):
        ba.bn_act(x, coeffs)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _bn_coeffs(dev, c, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return ba.bn_coefficients(
        torch.rand(c, device=dev, generator=g) + 0.5,
        torch.randn(c, device=dev, generator=g),
        torch.randn(c, device=dev, generator=g),
        torch.rand(c, device=dev, generator=g) + 0.5, 1e-5, dtype,
        fused_stats=dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,offset", [(3, 0), (33, 0), (513, 0), (64, 1)])
def test_bn_act_scalar_path_matches_plain(cuda_device, dtype, c, offset):
    """Channel counts no vector width divides, and a channels-last view
    one element past a 16-byte boundary: the scalar path, bit-equal."""
    g = torch.Generator(device=cuda_device).manual_seed(c)
    numel = 3 * 5 * 7 * c
    base = torch.randn(numel + offset, device=cuda_device,
                       generator=g).to(dtype)
    x = base[offset:].view(3, 5, 7, c).permute(0, 3, 1, 2)
    r = torch.randn(x.shape, device=cuda_device, generator=g).to(
        dtype=dtype, memory_format=torch.channels_last)
    coeffs = _bn_coeffs(cuda_device, c, dtype, c)
    for res, relu in ((None, False), (r, True)):
        assert not ba.launch_plan(x, coeffs, res, relu).variant & ba.VEC
        got = ba.bn_act(x, coeffs, res, relu)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(ba.bn_act_reference(
            x, coeffs, res, relu)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_act_special_values_bit_for_bit(cuda_device, dtype):
    """NaN, ±0 and ±inf through the affine, the residual and the ReLU,
    compared as bits with the plain version (torch.relu on the card):
    the kernel's ReLU keeps a NaN and treats -0 as torch does."""
    c = 16
    vals = torch.tensor([float("nan"), 0.0, -0.0, float("inf"),
                         -float("inf"), 1.5, -1.5, 3e38], device=cuda_device)
    x = vals.repeat(2 * 4 * 4 * c // vals.numel()).view(2, 4, 4, c)
    x = x.permute(0, 3, 1, 2).to(dtype)
    r = x.flip(0).contiguous(memory_format=torch.channels_last)
    ones = torch.ones(c, device=cuda_device)
    zeros = torch.zeros(c, device=cuda_device)
    # add = -0 keeps a -0 through the affine, so the ReLU sees it.
    for coeffs in ((zeros, ones, zeros), (zeros, ones, -zeros),
                   (zeros, -ones, zeros),
                   _bn_coeffs(cuda_device, c, torch.float32, 3)):
        for res, relu in ((None, True), (None, False), (r, True),
                          (r, False)):
            got = ba.bn_act(x, coeffs, res, relu)
            torch.cuda.synchronize()
            assert torch.equal(_bits(got), _bits(ba.bn_act_reference(
                x, coeffs, res, relu)))


def test_bn_act_bf16_rounds_half_to_even(cuda_device):
    """x + 2^-8 for 16 consecutive bf16 values in [1, 2) lies exactly
    halfway between two bf16 values: the store rounds to the one with an
    even last bit, as the plain version's cast does."""
    c = 8
    steps = torch.arange(16, device=cuda_device, dtype=torch.float32)
    xs = 1.0 + steps * 2.0 ** -7

    def nhwc(v):
        return v.view(1, 2, 1, c).permute(0, 3, 1, 2)

    x = nhwc(xs).to(torch.bfloat16)
    coeffs = (torch.zeros(c, device=cuda_device),
              torch.ones(c, device=cuda_device),
              torch.full((c,), 2.0 ** -8, device=cuda_device))
    got = ba.bn_act(x, coeffs)
    ref = ba.bn_act_reference(x, coeffs)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(ref))
    want = nhwc(torch.where(steps % 2 == 1, xs + 2.0 ** -7, xs))
    assert torch.equal(got.float(), want)
    assert bool(((_bits(got) & 1) == 0).all())


def test_bn_act_on_a_side_stream(cuda_device):
    """The launch goes on the current stream: x made on a side stream,
    normalized there, read after that stream alone is waited for."""
    c = 64
    coeffs = _bn_coeffs(cuda_device, c, torch.bfloat16, 5)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        x = torch.randn(8, 56, 56, c, device=cuda_device).permute(
            0, 3, 1, 2).to(torch.bfloat16)
        got = ba.bn_act(x, coeffs, None, True)
    side.synchronize()
    assert torch.equal(got, ba.bn_act_reference(x, coeffs, None, True))


def _cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in float32 units in the last place."""
    ia = a.detach().contiguous().view(torch.int32).long()
    ib = b.detach().contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max()) if a.numel() else 0


# The chains on the card against their plain versions (PyTorch ops on the
# card) from the same sums: 0 ulp.  Every step is one separately rounded
# float32 operation in the plain version's order, the rsqrt is rsqrtf
# (PyTorch's CUDA rsqrt) and a division by a Python number is a multiply
# by its float32 reciprocal (PyTorch's CUDA division by a scalar).
BN_CHAIN_ULPS = 0


def hold_bn_train(x, gy, y, scale, bias, fused):
    """Kernel C's entry points against their plain versions on one input
    (returns the sums' largest error over its bound).  The sums are f32
    sums in another order: within 1e-5 of the sum of the terms'
    magnitudes (per row count for the means).  The chains from the same
    sums: within BN_CHAIN_ULPS.  dx from the same coefficients and the
    masked gy: bit-equal.  Two launches: bit-equal."""
    c, dev = x.shape[1], x.device
    n = x.shape[0] * x.shape[2] * x.shape[3]
    inv = float(np.float32(1.0) / np.float32(n))
    running = (torch.randn(c, device=dev), torch.rand(c, device=dev) + 0.5)
    ra = tuple(r.clone() for r in running)
    before = (bt.stats_launches, bt.reduce_launches, bt.chain_launches,
              bt.dx_launches)
    mean, mean2, var, coeffs = bt.bn_forward_stats(x, scale, bias, 1e-5,
                                                   fused, running)
    sums, dscale_l, dbias_l = bt.bn_backward_local(gy, x, y, scale, mean,
                                                   mean2, 1e-5, fused)
    full = bt.bn_backward(gy, x, y, scale, mean, mean2, 1e-5, fused)
    chain = bt.bn_backward_chain(sums, float(n), scale, mean, mean2, 1e-5,
                                 x.dtype, fused)
    dx, gres = bt.bn_dx(gy, x, y, *full[2:], masked_gy=True)
    torch.cuda.synchronize()
    assert (bt.stats_launches, bt.reduce_launches, bt.chain_launches,
            bt.dx_launches) == (before[0] + 1, before[1] + 2, before[2] + 1,
                                before[3] + 1)
    xf = x.float()
    gm = bt.relu_mask_reference(gy, y).float()
    dims = (0, 2, 3)
    rm, rm2 = bt.channel_sums_reference(x, x, inv)
    rs1, rs2 = bt.channel_sums_reference(bt.relu_mask_reference(gy, y), x)
    worst = 0.0
    for got, ref, mag in ((mean, rm, xf.abs().sum(dims) * inv),
                          (mean2, rm2, (xf * xf).sum(dims) * inv),
                          (sums[0], rs1, gm.abs().sum(dims)),
                          (sums[1], rs2, (gm * xf).abs().sum(dims))):
        ratio = ((got - ref).abs() / (1e-5 * mag + 1e-30)).max().item()
        assert ratio <= 1.0, ratio
        worst = max(worst, ratio)
    p_var, p_coeffs = bt.forward_chain_reference(mean, mean2, scale, bias,
                                                 1e-5, x.dtype, fused, ra)
    for a, b in zip((var, *coeffs, *running), (p_var, *p_coeffs, *ra)):
        assert _ulps(a, b) <= BN_CHAIN_ULPS
    p_full = bt.backward_coefficients(sums[0], sums[1], scale, mean, mean2,
                                      1e-5, float(n), x.dtype, fused)
    for a, b in zip(full, p_full):
        assert _ulps(a, b) <= BN_CHAIN_ULPS
    for a, b in zip((dscale_l, dbias_l) + tuple(chain),
                    p_full[:2] + p_full[2:]):
        assert _ulps(a, b) <= BN_CHAIN_ULPS
    assert torch.equal(dx, bt.bn_dx_reference(gy, x, y, *full[2:]))
    assert torch.equal(gres, bt.relu_mask_reference(gy, y))
    assert dx.is_contiguous(memory_format=torch.channels_last)
    again = bt.bn_forward_stats(x, scale, bias, 1e-5, fused)[:3] + \
        bt.bn_backward(gy, x, y, scale, mean, mean2, 1e-5, fused)
    for a, b in zip(again, (mean, mean2, var) + tuple(full)):
        assert torch.equal(a, b)
    return worst


def _bn_inputs(dev, shape, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = _cl((torch.randn(shape, device=dev, generator=g) * 2 + 1).to(dtype))
    gy = _cl(torch.randn(shape, device=dev, generator=g).to(dtype))
    y = _cl(torch.relu(torch.randn(shape, device=dev, generator=g))
            .to(dtype))
    c = shape[1]
    scale = torch.rand(c, device=dev, generator=g) + 0.5
    bias = torch.randn(c, device=dev, generator=g)
    return x, gy, y, scale, bias


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4, 96, 7, 9), (2, 64, 56, 56),
                                   (3, 33, 5, 5)])
def test_bn_train_kernels_match_plain(cuda_device, dtype, shape):
    """Kernel C's entry points against their plain versions on the same
    inputs (``hold_bn_train``), with the ReLU mask and without, both
    formulas; (3, 33, 5, 5) takes the one-channel access."""
    x, gy, y, scale, bias = _bn_inputs(cuda_device, shape, dtype, sum(shape))
    assert bt.vector_access(x) == (shape[1] != 33)
    hold_bn_train(x, gy, y, scale, bias, True)
    hold_bn_train(x, gy, None, scale, bias, False)


def _resnet50_bn_shapes(dev, b=4):
    from active_learning_tpu_torch.models import resnet
    from active_learning_tpu_torch.models.factory import get_network

    model = get_network("imagenet", "SSLResNet50", device=dev)
    assert model.dtype == torch.bfloat16
    shapes = set()

    def hook(mod, args, kwargs):
        shapes.add(tuple(args[0].shape))

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in model.modules() if isinstance(m, resnet.BatchNorm)]
    with torch.no_grad():
        model(torch.zeros(b, 224, 224, 3, device=dev))
    for h in handles:
        h.remove()
    return sorted(shapes)


def test_bn_train_kernels_at_every_resnet50_shape(cuda_device):
    """Every BatchNorm shape of SSLResNet50 at 224 px (B=4) in bf16 with
    the fused formula and the ReLU mask, and a VAAL VAE shape in f32 with
    flax's: the chains within BN_CHAIN_ULPS of the plain version's from
    the same sums, dx bit-equal from the same coefficients."""
    shapes = _resnet50_bn_shapes(cuda_device)
    assert len(shapes) == 12, shapes
    for i, shape in enumerate(shapes):
        x, gy, y, scale, bias = _bn_inputs(cuda_device, shape,
                                           torch.bfloat16, i)
        hold_bn_train(x, gy, y, scale, bias, True)
    x, gy, y, scale, bias = _bn_inputs(cuda_device, (16, 128, 32, 32),
                                       torch.float32, 99)
    hold_bn_train(x, gy, y, scale, bias, False)


def test_bn_train_function_on_the_card(cuda_device):
    """The autograd Function on the card against the same Function on
    the CPU (float32, flax formula, residual and ReLU): forward and
    gradients within 1e-4 of each tensor's largest magnitude (f32 sums in
    other orders on both sides)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 32, 6, 6, generator=g) * 2 + 1
    r = torch.randn(x.shape, generator=g)
    scale = torch.rand(32, generator=g) + 0.5
    bias = torch.randn(32, generator=g)
    cot = torch.randn(x.shape, generator=g)
    out = []
    for dev in ("cpu", cuda_device):
        xs = _cl(x.to(dev)).requires_grad_(True)
        rs = _cl(r.to(dev)).requires_grad_(True)
        ss = scale.to(dev).clone().requires_grad_(True)
        bs = bias.to(dev).clone().requires_grad_(True)
        y, mean, var = bt.bn_train(xs, ss, bs, 1e-5, False, rs, True)
        (y * _cl(cot.to(dev))).sum().backward()
        out.append([t.detach().cpu() for t in (y, mean, var, xs.grad,
                                               rs.grad, ss.grad, bs.grad)])
    for a, b in zip(*out):
        assert bool(((a - b).abs() <= 1e-4 * b.abs().max()).all())


@pytest.mark.parametrize("state", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("momentum,wd", [(0.9, 1e-4), (0.9, 0.0),
                                         (0.0, 5e-4)])
def test_fused_sgd_kernel_matches_plain(cuda_device, state, momentum, wd):
    """Kernel D against its plain version on the same buffers: bit-equal
    params and trace (both round every product and sum on its own, and
    the bf16 store rounds to nearest even in both); one launch for all
    leaves, including a channels-last one and ragged chunks."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    shapes = [(64, 3, 7, 7), (64,), (4097,), (10, 2048)]
    ps_ = [torch.randn(s, device=cuda_device, generator=g) for s in shapes]
    ps_[0] = _cl(ps_[0])
    gs = [torch.randn_like(p) for p in ps_]
    ts = ([torch.randn_like(p).to(state) for p in ps_] if momentum
          else None)
    ref_p = [p.clone() for p in ps_]
    ref_t = [t.clone() for t in ts] if ts else None
    before = fs.launches
    fs.fused_sgd_update(ps_, gs, ts, 0.1, momentum, wd)
    fs.fused_sgd_reference(ref_p, gs, ref_t, 0.1, momentum, wd)
    torch.cuda.synchronize()
    assert fs.launches == before + 1
    for a, b in zip(ps_, ref_p):
        assert torch.equal(a, b)
    for a, b in zip(ts or [], ref_t or []):
        assert torch.equal(a, b)


@pytest.mark.parametrize("state", [torch.float32, torch.bfloat16])
def test_fused_sgd_kernel_on_odd_leaves(cuda_device, state):
    """Kernel D on leaves of 1, 3, 4, 4097 and 40,000 elements held as
    views at storage offsets 0-3, their grads at other offsets (so some
    leaves split into head, vectors and tail and some never align):
    bit-equal to the plain version at f32 state and with a bf16 trace;
    a second call on the same buffers reuses the table, and a grad of
    another dtype in its place still raises."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    sizes, offs = [1, 3, 4, 4097, 40000, 4097], [1, 2, 3, 1, 0, 2]

    def views(dtype, shifts):
        out = []
        for n, o, shift in zip(sizes, offs, shifts):
            buf = torch.randn(n + 8, device=cuda_device, generator=gen)
            out.append(buf.to(dtype)[(o + shift) % 4:][:n])
        return out

    same, grad_shift = [0] * 6, [0, 1, 0, 0, 0, 1]
    ps_, gs, ts = views(torch.float32, same), \
        views(torch.float32, grad_shift), views(state, same)
    for _ in range(2):
        ref_p = [p.clone() for p in ps_]
        ref_t = [t.clone() for t in ts]
        before = fs.launches
        fs.fused_sgd_update(ps_, gs, ts, 0.1, 0.9, 1e-4)
        fs.fused_sgd_reference(ref_p, gs, ref_t, 0.1, 0.9, 1e-4)
        torch.cuda.synchronize()
        assert fs.launches == before + 1
        for a, b in zip(ps_ + ts, ref_p + ref_t):
            assert torch.equal(a, b)
    with pytest.raises(TypeError):
        fs.fused_sgd_update(ps_, gs[:-1] + [gs[-1].double()], ts, 0.1, 0.9,
                            1e-4)


def test_training_wrappers_raise_rather_than_fall_back(cuda_device):
    x = torch.zeros(2, 8, 3, 3, device=cuda_device)  # NCHW-contiguous
    with pytest.raises(ValueError, match="channels_last"):
        bt.bn_stats(x)
    with pytest.raises(TypeError):
        bt.bn_stats(_cl(x.double()))
    p = torch.zeros(8, device=cuda_device)
    with pytest.raises(TypeError):
        fs.fused_sgd_update([p], [p.double()], [p.clone()], 0.1, 0.9, 0.0)


def test_kernel_writes_mark_the_tensors_they_update(cuda_device):
    """Kernels D and C write a caller's tensors through raw pointers; the
    wrappers bump those tensors' version counters, so the models' caches
    keyed on ``_version`` (a Conv's compute-dtype weight, a BatchNorm's
    eval coefficients) serve the written values under inference_mode,
    not the ones cached before the write."""
    from active_learning_tpu_torch.models import resnet

    torch.manual_seed(0)
    conv = resnet.Conv(16, 32, 3, 1, 1, torch.bfloat16).to(cuda_device)
    bn = resnet.BatchNorm(32, torch.bfloat16, True).to(cuda_device)
    with torch.no_grad():
        bn.mean.normal_()
        bn.var.uniform_(0.5, 1.5)
    with torch.inference_mode():
        conv.compute_weight()
        bn.coefficients()
    params = [conv.weight, bn.scale, bn.bias]
    traces = [torch.randn_like(p) for p in params]
    written = params + traces + [bn.mean, bn.var]
    versions = [t._version for t in written]
    fs.fused_sgd_update(params, [torch.randn_like(p) for p in params],
                        traces, 0.1, 0.9, 1e-4)
    x = _cl(torch.randn(4, 32, 5, 5, device=cuda_device).to(torch.bfloat16))
    bt.bn_forward_stats(x, bn.scale.detach(), bn.bias.detach(), 1e-5, True,
                        (bn.mean, bn.var))
    torch.cuda.synchronize()
    assert all(t._version > v for t, v in zip(written, versions))
    with torch.inference_mode():
        w, coeffs = conv.compute_weight(), bn.coefficients()
    assert torch.equal(w, conv.weight.detach().to(
        torch.bfloat16, memory_format=torch.channels_last))
    fresh = ba.bn_coefficients(bn.scale.detach(), bn.bias.detach(), bn.mean,
                               bn.var, bn.eps, bn.dtype, bn.fused_stats)
    for a, b in zip(coeffs, fresh):
        assert torch.equal(a, b)


# -- kernel B′: the eval-mode BatchNorm backward ------------------------------

def hold_bn_act_backward(g, x, y, shift, mul, residual):
    """Kernel B′ against its plain version on one input (returns the
    sums' largest error over their bound).  dx and d_residual: bit for
    bit.  The sums Σdz and Σdz·(x − shift): within 1e-5 of the sum of
    their terms' magnitudes of the plain version's (float32 sums in
    another order, as kernel C's are held), and within
    ``backward_chain_length``·2⁻²⁴ of it of the float64 sum of the same
    float32 terms.  Two launches: bit-equal."""
    before = ba.bwd_launches
    got = ba.bn_act_backward(g, x, y, shift, mul, residual)
    again = ba.bn_act_backward(g, x, y, shift, mul, residual)
    ref = ba.bn_act_backward_reference(g, x, y, shift, mul, residual)
    torch.cuda.synchronize()
    assert ba.bwd_launches == before + 2
    assert torch.equal(_bits(got[0]), _bits(ref[0]))
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    if residual:
        assert torch.equal(_bits(got[1]), _bits(ref[1]))
    else:
        assert got[1] is None
    for a, b in zip(got, again):
        assert a is None or torch.equal(a, b)
    dz = (g if y is None else torch.where(y > 0, g, torch.zeros_like(g))
          ).float()
    terms = (dz, dz * (x.float() - shift.view(1, -1, 1, 1)))
    b, c, h, w = x.shape
    chain = ba.backward_chain_length(b * h * w, c, x.dtype)
    worst = 0.0
    for k, t in zip((3, 2), terms):
        mag = t.abs().sum((0, 2, 3))
        truth = t.double().sum((0, 2, 3))
        ratio = ((got[k] - ref[k]).abs() / (1e-5 * mag + 1e-30)).max().item()
        assert ratio <= 1.0, ratio
        assert bool(((got[k].double() - truth).abs()
                     <= chain * 2.0 ** -24 * mag.double() + 1e-30).all())
        worst = max(worst, ratio)
    return worst


def _bwd_inputs(dev, shape, dtype, seed):
    g_ = torch.Generator(device=dev).manual_seed(seed)
    x = _cl((torch.randn(shape, device=dev, generator=g_) * 2 + 1).to(dtype))
    g = _cl(torch.randn(shape, device=dev, generator=g_).to(dtype))
    y = _cl(torch.relu(torch.randn(shape, device=dev, generator=g_))
            .to(dtype))
    c = shape[1]
    shift = torch.randn(c, device=dev, generator=g_)
    mul = torch.rand(c, device=dev, generator=g_) + 0.5
    return g, x, y, shift, mul


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4, 96, 7, 9), (128, 64, 32, 32),
                                   (128, 512, 4, 4), (3, 33, 5, 5)])
def test_bn_act_backward_kernel_matches_plain(cuda_device, dtype, shape):
    """Kernel B′ with the ReLU mask and a residual, with the mask alone
    and with neither; (128, 64, 32, 32) and (128, 512, 4, 4) are
    SSLResNet18's first and last BatchNorm shapes at B = 128 on 32-px
    rows, (3, 33, 5, 5) takes the one-channel access."""
    g, x, y, shift, mul = _bwd_inputs(cuda_device, shape, dtype, sum(shape))
    hold_bn_act_backward(g, x, y, shift, mul, True)
    hold_bn_act_backward(g, x, y, shift, mul, False)
    hold_bn_act_backward(g, x, None, shift, mul, False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_act_backward_unaligned_and_special_values(cuda_device, dtype):
    """A channels-last view one element past a 16-byte boundary (the
    scalar path) and a cotangent holding NaN, ±inf and ±0 where the mask
    passes and where it does not: bit for bit with the plain version
    (a NaN cotangent masked by y ≤ 0 gives 0; a NaN or inf passed
    through reaches dx and the sums as in the plain version)."""
    shape = (2, 64, 3, 5)
    g, x, y, shift, mul = _bwd_inputs(cuda_device, shape, dtype, 5)
    g = g.clone()
    g[0, :4, 0, 0] = torch.tensor([float("nan"), float("inf"), -0.0,
                                   -float("inf")], dtype=dtype)
    y = y.clone()
    y[0, 1, 0, 0] = 0
    numel = g.numel()
    base = torch.empty(numel + 1, device=cuda_device, dtype=dtype)
    base[1:].copy_(g.permute(0, 2, 3, 1).reshape(-1))
    g_off = base[1:].view(2, 3, 5, 64).permute(0, 3, 1, 2)
    for gg in (g, g_off):
        got = ba.bn_act_backward(gg, x, y, shift, mul, True)
        ref = ba.bn_act_backward_reference(gg, x, y, shift, mul, True)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(_bits(a), _bits(b)) if a.ndim == 4 else \
                torch.equal(a.isnan(), b.isnan())


def test_bn_eval_function_on_the_card(cuda_device):
    """The model's eval-mode BatchNorm with gradients recorded (kernel B
    forward, kernel B′ backward, the coefficients in the graph) on the
    card against the same module on the CPU (float32, both formulas,
    residual and ReLU): the forward, dx and d_residual within 1e-6 of
    the largest (kernels B and B′ equal their plain versions; the
    coefficients' rsqrt on the card may differ from the CPU's by an
    ulp), d scale and d bias within 1e-4 of the largest (float32 sums in
    another order)."""
    from active_learning_tpu_torch.models import resnet

    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 32, 6, 6, generator=g) * 2 + 1
    r = torch.randn(x.shape, generator=g)
    cot = torch.randn(x.shape, generator=g)
    stats = [torch.rand(32, generator=g) + 0.5, torch.randn(32, generator=g),
             torch.randn(32, generator=g), torch.rand(32, generator=g) + 0.5]
    for fused in (True, False):
        out = []
        for dev in ("cpu", cuda_device):
            bn = resnet.BatchNorm(32, torch.float32, fused).to(dev).eval()
            with torch.no_grad():
                for t, v in zip((bn.scale, bn.bias, bn.mean, bn.var), stats):
                    t.copy_(v)
            xs = _cl(x.to(dev)).requires_grad_(True)
            rs = _cl(r.to(dev)).requires_grad_(True)
            before = ba.bwd_launches
            y = bn(xs, residual=rs, relu=True)
            (y * _cl(cot.to(dev))).sum().backward()
            assert ba.bwd_launches == before + (dev != "cpu")
            out.append([t.detach().cpu() for t in (
                y, xs.grad, rs.grad, bn.scale.grad, bn.bias.grad)])
        for a, b, tol in zip(out[0], out[1], (1e-6, 1e-6, 1e-6, 1e-4,
                                              1e-4)):
            assert bool(((a - b).abs() <= tol * b.abs().max()).all())


def test_bn_act_backward_wrapper_raises_rather_than_falls_back(cuda_device):
    x = torch.zeros(2, 8, 3, 3, device=cuda_device)  # NCHW-contiguous
    c = torch.zeros(8, device=cuda_device)
    with pytest.raises(ValueError, match="channels_last"):
        ba.bn_act_backward(_cl(x), x, None, c, c, False)
    with pytest.raises(TypeError):
        ba.bn_act_backward(_cl(x.double()), _cl(x.double()), None, c, c,
                           False)


# -- kernel E: k-center fold, top-q, D² draw ---------------------------------

def _kc_pool(dev, n, dims, seed, n_labeled=64):
    """Seeded factors, their squared norms, the min distance to the
    first ``n_labeled`` rows (plain version) and the selectable mask."""
    g = torch.Generator(device=dev).manual_seed(seed)
    factors = tuple(torch.randn(n, d, device=dev, generator=g)
                    for d in dims)
    sqn = None
    for f in factors:
        s = (f * f).sum(dim=1)
        sqn = s if sqn is None else sqn * s
    labeled = torch.arange(n_labeled, device=dev)
    min_dist = torch.full((n,), float("inf"), device=dev)
    kc.fold_reference(factors, sqn, min_dist, labeled)
    sel = torch.ones(n, device=dev)
    sel[labeled] = 0.0
    centers = torch.randperm(n - n_labeled, device=dev,
                             generator=g)[:8] + n_labeled
    return factors, sqn, min_dist, sel, centers


KC_SHAPES = [(1000, (37,)), (1000, (5, 7)), (13000, (2048,)),
             (13000, (16, 32)), (131072, (2048,))]


@pytest.mark.parametrize("n,dims", KC_SHAPES)
def test_kcenter_fold_select_matches_plain(cuda_device, n, dims):
    """min_dist within kc.fold_tolerance of the plain version; selectable
    equal; the kernel's top-q is exactly the top-q of its own min_dist
    (the reduce is exact); where a pick differs from the plain one, the
    two rows' plain distances lie within the tolerance."""
    factors, sqn, md0, sel0, centers = _kc_pool(cuda_device, n, dims, n)
    tol = kc.fold_tolerance(sqn, float(sqn[centers].max()), sum(dims))
    for q in (1, 8):
        md_k, sel_k = md0.clone(), sel0.clone()
        md_p, sel_p = md0.clone(), sel0.clone()
        before = kc.select_launches
        vk, ik = kc.fold_select(factors, sqn, md_k, sel_k, centers, q)
        vp, ip = kc.fold_select_reference(factors, sqn, md_p, sel_p,
                                          centers, q)
        torch.cuda.synchronize()
        assert kc.select_launches == before + 1
        assert torch.equal(sel_k, sel_p)
        assert bool(((md_k - md_p).abs() <= tol).all())
        own_v, own_i = kc.top_q(torch.where(sel_k > 0, md_k,
                                            torch.full_like(md_k,
                                                            -float("inf"))),
                                q)
        assert torch.equal(vk, own_v) and torch.equal(ik, own_i)
        gap = (md_p[ik] - vp).abs()
        assert bool((gap <= 2 * tol.max()).all())


@pytest.mark.parametrize("n,dims", KC_SHAPES[:4])
def test_kcenter_min_fold_matches_plain(cuda_device, n, dims):
    factors, sqn, _, _, _ = _kc_pool(cuda_device, n, dims, n + 1)
    centers = torch.arange(0, n, max(1, n // 1024), device=cuda_device)[:1024]
    md_k = torch.full((n,), float("inf"), device=cuda_device)
    md_p = md_k.clone()
    before = kc.min_fold_launches
    kc.min_fold(factors, sqn, md_k, centers)
    kc.fold_reference(factors, sqn, md_p, centers)
    torch.cuda.synchronize()
    assert kc.min_fold_launches == before + 1
    tol = kc.fold_tolerance(sqn, float(sqn[centers].max()), sum(dims))
    assert bool(((md_k - md_p).abs() <= tol).all())


@pytest.mark.parametrize("n,dims", KC_SHAPES[:4])
def test_kcenter_fold_draw_matches_plain(cuda_device, n, dims):
    """The kernel's Threefry bits are the plain version's bit for bit;
    its Gumbel noise within one ulp of max(1, |g|) (logf against torch's
    log); the drawn rows equal over 20 steps, their weights within the
    fold tolerance."""
    factors, sqn, md0, sel0, _ = _kc_pool(cuda_device, n, dims, n + 2)
    keys = threefry.split(threefry.prng_key(n), 20)
    bits, gum = kc.random_bits((int(keys[0, 0]), int(keys[0, 1])), n,
                               cuda_device)
    key0 = (int(keys[0, 0]), int(keys[0, 1]))
    assert torch.equal(bits, threefry.random_bits(key0, n, cuda_device))
    g_ref = threefry.gumbel(key0, n, cuda_device)
    ulp = torch.maximum(torch.ones_like(g_ref), g_ref.abs()) * 2.0 ** -23
    assert bool(((gum - g_ref).abs() <= ulp).all())
    md_k, sel_k, md_p, sel_p = md0.clone(), sel0.clone(), md0.clone(), \
        sel0.clone()
    pk = torch.zeros(20, dtype=torch.int64, device=cuda_device)
    vk = torch.zeros(20, device=cuda_device)
    none = torch.zeros(0, dtype=torch.int64, device=cuda_device)
    before = kc.draw_launches
    for i in range(20):
        key = (int(keys[i, 0]), int(keys[i, 1]))
        kc.fold_draw(factors, sqn, md_k, sel_k, pk[i - 1:i] if i else none,
                     key, vk[i:i + 1], pk[i:i + 1])
        prev = torch.tensor([int(pk[i - 1])], device=cuda_device) if i \
            else none
        vp, ip = kc.fold_draw_reference(factors, sqn, md_p, sel_p, prev, key)
        assert int(ip) == int(pk[i]), i
        tol = kc.fold_tolerance(sqn, float(sqn.max()), sum(dims))
        assert abs(float(vp) - float(vk[i])) <= float(tol.max())
    assert kc.draw_launches == before + 20


@pytest.mark.parametrize("n,dims", [(256, (37,)), (1000, (5, 7)),
                                    (13000, (2048,)), (13000, (16, 32)),
                                    (300, (3, 10))])
def test_kcenter_batch_pass_matches_the_q1_scan(cuda_device, n, dims):
    """The batched scan on the card (kernel E's ``batch_pass``: re-check
    and pick count on the device) against the q = 1 kernel scan: the same
    picks and distances bit for bit (the re-check's [q, q] distances take
    the fold's own arithmetic).  Against the plain batched scan: the same
    picks, or a first difference where the two rows' plain distances lie
    within twice the fold tolerance.  Two runs: bit-equal.  Odd widths
    (d % 4 != 0) take the scalar loads; 256 rows is the smallest pool."""
    from active_learning_tpu_torch.strategies import kcenter as skc

    factors, sqn, md0, sel0, _ = _kc_pool(cuda_device, n, dims, n + 3)
    budget = min(200, n // 4)

    def scan(batched, md, sel, plain=False):
        if not batched:
            return skc._kcenter_scan(factors, sqn, md, sel, budget, False,
                                     (0, 0))
        if not plain:
            return skc._kcenter_scan_batched(factors, sqn, md, sel, budget, 8)
        state = kc.BatchState(n, budget, 8, cuda_device)
        while int(state.count[0]) < budget:
            kc.batch_pass_reference(factors, sqn, md, sel, state)
            state.passes += 1
        return state.picks[:budget], state.dists[:budget]

    before = kc.batch_launches
    md_b, sel_b = md0.clone(), sel0.clone()
    pb, db = scan(True, md_b, sel_b)
    syncs = skc.LAST_SCAN["host_syncs"]
    assert kc.batch_launches - before == skc.LAST_SCAN["pool_passes"]
    assert syncs <= skc.max_host_syncs(budget, 8)
    md_1, sel_1 = md0.clone(), sel0.clone()
    p1, d1 = scan(False, md_1, sel_1)
    assert torch.equal(pb, p1)
    assert torch.equal(db.view(torch.int32), d1.view(torch.int32))
    md_a, sel_a = md0.clone(), sel0.clone()
    pa, da = scan(True, md_a, sel_a)
    assert torch.equal(pa, pb) and torch.equal(da, db)
    assert torch.equal(md_a, md_b) and torch.equal(sel_a, sel_b)
    pp, dp = scan(True, md0.clone(), sel0.clone(), plain=True)
    differ = (pp != pb).nonzero()
    tol = kc.fold_tolerance(sqn, float(sqn.max()), sum(dims)).max()
    if differ.numel():
        s = int(differ[0, 0])
        assert abs(float(dp[s]) - float(db[s])) <= 2 * float(tol)
    else:
        assert bool(((dp - db).abs() <= 2 * tol).all())


def _kc_nonfinite_pool(dev, n, dims, seed, center_kind=None,
                       inf_only=False):
    """A seeded pool (64 labeled rows, the first) whose first factor holds
    a NaN at unlabeled rows 100 and 230, +inf at 101 and -inf at 102, so
    their min distances come out NaN (a NaN feature, or inf - inf); the
    labeled row 5's min distance is set to NaN too.  ``center_kind``: the
    8 centers are rows 200.. (finite), or lead with the NaN row 100 or the
    +inf row 101.  ``inf_only``: only the +inf at row 101, and one
    labeled row (row 0, its feature 1 negative), so row 101's distance to
    it is inf + inf: +inf, not NaN.  Returns the pool's factors, sqn,
    min_dist to the labeled rows (plain version), selectable mask and
    centers."""
    g = torch.Generator(device=dev).manual_seed(seed)
    factors = tuple(torch.randn(n, d, device=dev, generator=g)
                    for d in dims)
    marks = ((100, float("nan")), (230, float("nan")),
             (101, float("inf")), (102, float("-inf")), (0, -1.0))
    for row, v in marks[2:3] + marks[4:] if inf_only else marks[:4]:
        factors[0][row, 1] = v
    sqn = None
    for f in factors:
        sq = (f * f).sum(dim=1)
        sqn = sq if sqn is None else sqn * sq
    labeled = torch.arange(1 if inf_only else 64, device=dev)
    min_dist = torch.full((n,), float("inf"), device=dev)
    kc.fold_reference(factors, sqn, min_dist, labeled)
    if not inf_only:
        min_dist[5] = float("nan")
    sel = torch.ones(n, device=dev)
    sel[labeled] = 0.0
    centers = torch.arange(200, 208, device=dev)
    if center_kind == "nan":
        centers[0] = 100
    elif center_kind == "+inf":
        centers[0] = 101
    return factors, sqn, min_dist, sel, centers


def _same_nan_inf_within(got, want, tol):
    """NaN and ±inf at the same entries, the finite ones within tol."""
    assert _same_special(got, want)
    fin = torch.isfinite(want)
    return bool(((got - want).abs()[fin] <= tol.expand_as(want)[fin]).all())


KC_NONFINITE = [(1000, (37,)), (1000, (5, 7)), (13000, (2048,)),
                (13000, (16, 32))]


@pytest.mark.parametrize("center_kind", [None, "nan", "+inf"])
@pytest.mark.parametrize("n,dims", KC_NONFINITE)
def test_kcenter_fold_select_on_nonfinite_rows(cuda_device, n, dims,
                                               center_kind):
    """The fold keeps NaN where the plain version has it (``min.NaN``:
    jnp.minimum's rule, where fminf dropped it), and the top-q ranks a NaN
    first, ties to the lower row: the NaN rows 100 and 230 lead (the +inf
    row's inf - inf is NaN too); after a NaN center every distance is NaN
    and the lowest selectable rows lead."""
    factors, sqn, md0, sel0, centers = _kc_nonfinite_pool(
        cuda_device, n, dims, n, center_kind)
    c_sqn = sqn[centers]
    tol = kc.fold_tolerance(sqn, float(c_sqn[torch.isfinite(c_sqn)].max()),
                            sum(dims))
    tol = torch.nan_to_num(tol, nan=0.0, posinf=0.0)
    for q in (1, 8):
        md_k, sel_k = md0.clone(), sel0.clone()
        md_p, sel_p = md0.clone(), sel0.clone()
        vk, ik = kc.fold_select(factors, sqn, md_k, sel_k, centers, q)
        vp, ip = kc.fold_select_reference(factors, sqn, md_p, sel_p,
                                          centers, q)
        torch.cuda.synchronize()
        assert torch.equal(sel_k, sel_p)
        assert _same_nan_inf_within(md_k, md_p, tol)
        own_v, own_i = kc.top_q(torch.where(
            sel_k > 0, md_k, torch.full_like(md_k, -float("inf"))), q)
        assert torch.equal(ik, own_i) and _same_special(vk, own_v)
        # The NaN ranks exactly; a finite pick may differ from the plain
        # one only between rows whose plain distances lie within the
        # tolerance.
        assert _same_special(vk, vp) and bool(torch.isnan(vk[0]))
        nan = torch.isnan(vp)
        assert torch.equal(ik[nan], ip[nan])
        gap = (md_p[ik[~nan]] - vp[~nan]).abs()
        assert bool((gap <= 2 * tol.max()).all())


@pytest.mark.parametrize("n,dims", KC_NONFINITE)
def test_kcenter_min_fold_on_nonfinite_rows(cuda_device, n, dims):
    """The tile GEMM's min keeps NaN: centers that hold the NaN, +inf and
    -inf rows make NaN (or ±inf) where the plain version has them."""
    factors, sqn, _, _, _ = _kc_nonfinite_pool(cuda_device, n, dims, n + 1)
    centers = torch.cat([torch.tensor([100, 101, 102, 230],
                                      device=cuda_device),
                         torch.arange(300, 300 + 200, device=cuda_device)])
    for cs in (centers[4:], centers):
        md_k = torch.full((n,), float("inf"), device=cuda_device)
        md_k[7] = float("nan")
        md_p = md_k.clone()
        kc.min_fold(factors, sqn, md_k, cs)
        kc.fold_reference(factors, sqn, md_p, cs)
        torch.cuda.synchronize()
        tol = torch.nan_to_num(kc.fold_tolerance(
            sqn, float(sqn[centers[4:]].max()), sum(dims)), nan=0.0,
            posinf=0.0)
        assert _same_nan_inf_within(md_k, md_p, tol)
        assert bool(torch.isnan(md_k[100]) and torch.isnan(md_k[7]))


@pytest.mark.parametrize("case", ["nan_unlabeled", "nan_labeled_only",
                                  "inf_weights"])
@pytest.mark.parametrize("n,dims", KC_NONFINITE[:2] + KC_NONFINITE[3:])
def test_kcenter_fold_draw_on_nonfinite_rows(cuda_device, n, dims, case):
    """The D² draw copies the reference's ``where(sum(p) > 0, p,
    selectable)``: a NaN weight anywhere (an unlabeled NaN row, or only a
    labeled one: NaN * 0) makes every draw uniform over the selectable
    rows; +inf weights with no NaN draw the first +inf row.  Rows and
    weights (NaN included) as the plain version's over 20 steps."""
    factors, sqn, md0, sel0, _ = _kc_nonfinite_pool(cuda_device, n, dims,
                                                    n + 2)
    if case == "nan_labeled_only":
        for r in (100, 101, 102, 230):
            md0[r] = 1.0
    elif case == "inf_weights":
        md0 = torch.nan_to_num(md0, nan=1.0)
        md0[[40, 300, 301]] = float("inf")
        sel0 = torch.ones_like(sel0)
        sel0[40] = 0.0
        md0[40] = 0.0
    keys = threefry.split(threefry.prng_key(n), 20)
    md_k, sel_k, md_p, sel_p = md0.clone(), sel0.clone(), md0.clone(), \
        sel0.clone()
    pk = torch.zeros(20, dtype=torch.int64, device=cuda_device)
    vk = torch.zeros(20, device=cuda_device)
    vp = torch.zeros(20, device=cuda_device)
    none = torch.zeros(0, dtype=torch.int64, device=cuda_device)
    for i in range(20):
        key = (int(keys[i, 0]), int(keys[i, 1]))
        kc.fold_draw(factors, sqn, md_k, sel_k, pk[i - 1:i] if i else none,
                     key, vk[i:i + 1], pk[i:i + 1])
        prev = torch.tensor([int(pk[i - 1])], device=cuda_device) if i \
            else none
        v, ip = kc.fold_draw_reference(factors, sqn, md_p, sel_p, prev, key)
        vp[i] = v
        assert int(ip) == int(pk[i]), i
    if case == "inf_weights":
        assert int(pk[0]) == 300
    tol = torch.nan_to_num(kc.fold_tolerance(sqn, 0.0, sum(dims)),
                           nan=0.0, posinf=0.0).max()
    assert _same_nan_inf_within(vk, vp, tol + 1e-6 * vp.abs().nan_to_num())


@pytest.mark.parametrize("inf_only", [False, True])
@pytest.mark.parametrize("n,dims", KC_NONFINITE)
def test_kcenter_batch_pass_on_nonfinite_rows(cuda_device, n, dims,
                                              inf_only):
    """The batched scan on a pool with NaN and ±inf rows: picks equal to
    the q = 1 kernel scan's, distances bit-equal (NaN at the same picks),
    and equal to the plain batched scan's.  The NaN rows come first, then,
    every distance NaN after a NaN center, the lowest selectable rows,
    one a pass (the re-check's max.NaN stops at a NaN).  ``inf_only``: the
    +inf row's distance is +inf, so it comes first and its [q, q]
    distances (NaN or +inf) stop the re-check."""
    from active_learning_tpu_torch.strategies import kcenter as skc

    factors, sqn, md0, sel0, _ = _kc_nonfinite_pool(
        cuda_device, n, dims, n + 3, inf_only=inf_only)
    budget = 40
    pb, db = skc._kcenter_scan_batched(factors, sqn, md0.clone(),
                                       sel0.clone(), budget, 8)
    p1, d1 = skc._kcenter_scan(factors, sqn, md0.clone(), sel0.clone(),
                               budget, False, (0, 0))
    torch.cuda.synchronize()
    assert torch.equal(pb, p1)
    assert _same_special(db, d1)
    fin = torch.isfinite(d1)
    assert torch.equal(db[fin].view(torch.int32), d1[fin].view(torch.int32))
    state = kc.BatchState(n, budget, 8, cuda_device)
    md, sel = md0.clone(), sel0.clone()
    while int(state.count[0]) < budget:
        kc.batch_pass_reference(factors, sqn, md, sel, state)
        state.passes += 1
    assert torch.equal(pb, state.picks[:budget])
    assert _same_special(db, state.dists[:budget])
    if inf_only:
        assert int(pb[0]) == 101 and bool(torch.isposinf(db[0]))
    else:
        assert int(pb[0]) == 100 and bool(torch.isnan(db).all())


def test_kcenter_wrappers_raise_rather_than_fall_back(cuda_device):
    f = torch.zeros(10, 4, device=cuda_device)
    v = torch.zeros(10, device=cuda_device)
    with pytest.raises(ValueError, match="at most 8"):
        kc.fold_select((f,), v, v.clone(), v.clone(),
                       torch.arange(9, device=cuda_device), 1)
    with pytest.raises(ValueError, match="contiguous"):
        kc.min_fold((torch.zeros(10, 8, device=cuda_device)[:, ::2],), v,
                    v.clone(), torch.arange(2, device=cuda_device))
    with pytest.raises(ValueError, match="device"):
        kc.batch_pass((f,), v, v.clone(), v.clone(),
                      kc.BatchState(10, 4, 2, "cpu"))
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(10, 8000, device=cuda_device)
        kc.fold_select((big,), v, v.clone(), v.clone(),
                       torch.arange(8, device=cuda_device), 8)


# -- kernel F: boundary radii, pair norms -------------------------------------

_RADII_SHAPES = [(7, 10, 33), (256, 1000, 2048), (300, 1001, 2050),
                 (1, 3, 5)]


@pytest.mark.parametrize("b,c,d", _RADII_SHAPES + [(512, 10, 512)])
def test_boundary_radii_kernel_matches_plain(cuda_device, b, c, d):
    """Predictions equal (or, where they differ, the two logits within
    br.logits_tolerance); radii within br.radii_tolerance where the
    predictions agree, +inf at the same places; pair norms within
    2 * D * eps of their value.  The C entries report 2 kernels a radii
    call and 1 a table.  (300, 1001, 2050) and (1, 3, 5) leave ragged
    tiles and take 4-byte copies."""
    g = torch.Generator(device=cuda_device).manual_seed(b + c + d)
    emb = torch.randn(b, d, device=cuda_device, generator=g)
    kernel = torch.randn(d, c, device=cuda_device, generator=g) * 0.05
    bias = torch.randn(c, device=cuda_device, generator=g) * 0.1
    before = (br.radii_launches, br.pair_norms_launches)
    norms_k = br.head_pair_norms(kernel)
    norms_p = br.head_pair_norms_reference(kernel)
    got = br.boundary_radii(emb, kernel, bias, norms_p)
    ref = br.boundary_radii_reference(emb, kernel, bias, norms_p)
    torch.cuda.synchronize()
    assert (br.radii_launches, br.pair_norms_launches) == (
        before[0] + 2, before[1] + 1)
    assert bool(((norms_k - norms_p).abs()
                 <= 2 * d * 2.0 ** -23 * norms_p + 1e-30).all())
    same = got["pred"] == ref["pred"]
    if not bool(same.all()):
        logits = emb @ kernel + bias
        rows = (~same).nonzero()[:, 0]
        gap = (logits[rows, got["pred"][rows].long()]
               - logits[rows, ref["pred"][rows].long()]).abs()
        assert bool((gap <= br.logits_tolerance(emb, kernel)[rows]).all())
    rk, rp = got["radii"][same], ref["radii"][same]
    assert torch.equal(torch.isinf(rk), torch.isinf(rp))
    fin = torch.isfinite(rp)
    tol = br.radii_tolerance(emb[same], rp.where(fin, torch.zeros_like(rp)))
    assert bool(((rk - rp).abs()[fin] <= tol[fin]).all())
    mm_tol = tol.where(fin, torch.zeros_like(tol)).max(dim=1).values
    assert bool(((got["min_margin"][same] - ref["min_margin"][same]).abs()
                 <= mm_tol).all())


@pytest.mark.parametrize("b,c,d", _RADII_SHAPES)
def test_boundary_radii_kernel_on_nonfinite_rows(cuda_device, b, c, d):
    """Embedding rows with a NaN, a +inf, a -inf, or a +inf beside a
    -inf: pred equal to the plain version's (the first NaN logit, or the
    first +inf), radii and min_margin NaN and ±inf where the plain
    version has them; the finite rows as in the test above."""
    g = torch.Generator(device=cuda_device).manual_seed(b + c + d + 1)
    emb = torch.randn(b, d, device=cuda_device, generator=g)
    kernel = torch.randn(d, c, device=cuda_device, generator=g) * 0.05
    bias = torch.randn(c, device=cuda_device, generator=g) * 0.1
    kinds = ["finite", "nan", "+inf", "-inf", "+inf -inf"]
    emb = _nonfinite_rows(emb, kinds, seed=b * d)
    norms = br.head_pair_norms_reference(kernel)
    got = br.boundary_radii(emb, kernel, bias, norms)
    ref = br.boundary_radii_reference(emb, kernel, bias, norms)
    torch.cuda.synchronize()
    bad = ~torch.isfinite(emb).all(dim=1)
    assert bool(bad[0])
    assert torch.equal(got["pred"][bad], ref["pred"][bad])
    assert _same_special(got["radii"][bad], ref["radii"][bad])
    assert _same_special(got["min_margin"][bad], ref["min_margin"][bad])
    assert bool(torch.isnan(got["min_margin"][0]))
    ok = ~bad & (got["pred"] == ref["pred"])
    rp = ref["radii"][ok]
    rfin = torch.isfinite(rp)
    tol = br.radii_tolerance(emb[ok], rp.where(rfin, torch.zeros_like(rp)))
    assert _same_special(got["radii"][ok], rp)
    assert bool(((got["radii"][ok] - rp).abs()[rfin] <= tol[rfin]).all())


@pytest.mark.parametrize("c,d", [(3, 5), (10, 33), (1000, 2048),
                                 (1001, 2050)])
def test_head_pair_norms_kernel_is_symmetric_bit_for_bit(cuda_device, c, d):
    """The table equals its transpose bit for bit, with 0 on the diagonal:
    ||w_c - w_j|| and ||w_j - w_c|| sum the same squares in one order."""
    g = torch.Generator(device=cuda_device).manual_seed(c + d)
    kernel = torch.randn(d, c, device=cuda_device, generator=g) * 0.05
    norms = br.head_pair_norms(kernel)
    torch.cuda.synchronize()
    assert torch.equal(norms, norms.T)
    assert bool((norms.diagonal() == 0).all())
    ref = br.head_pair_norms_reference(kernel)
    assert bool(((norms - ref).abs() <= 2 * d * 2.0 ** -23 * ref).all())


# -- kernel G: BADGE factors --------------------------------------------------

@pytest.mark.parametrize("pool_512", [False, True])
@pytest.mark.parametrize("b,c,d", [(5, 10, 512), (256, 1000, 2048),
                                   (3, 3, 40), (2, bg.MAX_CLASSES, 512),
                                   (3, 10, 20000)])
def test_badge_kernel_matches_plain(cuda_device, b, c, d, pool_512):
    """softmax - onehot within 1e-6 (a sum of C float32 terms in another
    order); pooled bins within 1e-5 relative and 1e-6 absolute (the
    plain version pools by a matrix product).  D = 20,000 pooled takes
    the opt-in past 48 KB of shared memory."""
    g = torch.Generator(device=cuda_device).manual_seed(b * c)
    logits = torch.randn(b, c, device=cuda_device, generator=g) * 3.0
    emb = torch.randn(b, d, device=cuda_device, generator=g)
    before = bg.launches
    got = bg.badge_factors(logits, emb, pool_512)
    ref = bg.badge_factors_reference(logits, emb, pool_512)
    torch.cuda.synchronize()
    assert bg.launches == before + 1
    for k in ("grad_a", "grad_e"):
        assert got[k].shape == ref[k].shape
        torch.testing.assert_close(got[k], ref[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pool_512", [False, True])
@pytest.mark.parametrize("b,c,d", [(16, 10, 512), (16, 1000, 2048),
                                   (8, 3, 40), (8, 1001, 2050)])
def test_badge_kernel_on_nonfinite_rows(cuda_device, b, c, d, pool_512):
    """Logit and embedding rows with NaN, +inf and -inf: NaN and ±inf in
    the same entries as the plain version (a NaN or +inf logit makes the
    row's a NaN; pooled, a bin is NaN when its row holds a non-finite
    element outside it, as ``x @ M``'s ``x_k * 0`` is; a bin holding the
    row's only +inf stays +inf), the finite entries within 1e-5 relative
    and 1e-6 absolute.  (8, 1001, 2050) takes the scalar loads and
    copies; C = 10, D = 512 overlapping bins."""
    g = torch.Generator(device=cuda_device).manual_seed(b * c + 1)
    logits = torch.randn(b, c, device=cuda_device, generator=g) * 3.0
    emb = torch.randn(b, d, device=cuda_device, generator=g)
    logits = _nonfinite_rows(logits, list(NONFINITE_KINDS), seed=c)
    emb = _nonfinite_rows(emb, list(NONFINITE_KINDS)[1:] + ["finite"],
                          seed=d)
    got = bg.badge_factors(logits, emb, pool_512)
    ref = bg.badge_factors_reference(logits, emb, pool_512)
    torch.cuda.synchronize()
    for k in ("grad_a", "grad_e"):
        assert got[k].shape == ref[k].shape
        assert _same_special(got[k], ref[k]), k
        torch.testing.assert_close(got[k], ref[k], rtol=1e-5, atol=1e-6,
                                   equal_nan=True)
    if pool_512:
        assert bool(torch.isposinf(ref["grad_e"]).any())
        assert bool(torch.isnan(ref["grad_e"]).any())


# -- kernel H: the balancing pick ---------------------------------------------

def _bal_pool(dev, n, d, c, n_maj, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    emb = torch.randn(n, d, device=dev, generator=g)
    centers = torch.randn(c, d, device=dev, generator=g)
    eligible = torch.rand(n, device=dev, generator=g) > 0.3
    maj = torch.zeros(c, dtype=torch.bool, device=dev)
    maj[torch.randperm(c, device=dev, generator=g)[:n_maj]] = True
    rarest = int((~maj).nonzero()[0, 0])
    return emb, eligible, centers, maj, rarest


def _assert_pick_held(args, rare_empty, got=None):
    """The kernel's pick (``got``, else the one-shot entry's) equals the
    plain version's, or the two rows' plain scores lie within
    bal.score_tolerance of each other."""
    if got is None:
        before = bal.launches
        got = int(bal.balancing_pick(*args, rare_empty))
        torch.cuda.synchronize()
        assert bal.launches == before + 1
    want = int(bal.balancing_pick_reference(*args, rare_empty))
    if got != want:
        emb, eligible, centers, maj, rarest = args
        scores = bal.balancing_scores_reference(*args, rare_empty)
        tol = bal.score_tolerance(emb, centers, maj, rarest, rare_empty)
        assert bool(eligible[got])
        gap = float((scores[got] - scores[want]).abs())
        assert gap <= float(tol[got] + tol[want]), (got, want, gap)
    return got, want


@pytest.mark.parametrize("n,d,c,n_maj", [
    (20431, 512, 10, 4), (50000, 512, 10, 3), (1000, 2048, 1000, 400),
    (777, 33, 17, 9), (130, 7, 3, 1), (257, 64, 16, 0),
    (3001, 77, 300, 131), (4999, 258, 1000, 407), (129, 2050, 45, 1),
    (1025, 2048, 31, 0), (2000, 96, 30, 29)])
@pytest.mark.parametrize("rare_empty", [False, True])
def test_balancing_kernel_matches_plain(cuda_device, n, d, c, n_maj,
                                        rare_empty):
    """Both paths (C <= 30 with its rows in shared memory: the warp fold;
    above: the tile GEMM over the compacted majority centers), ragged
    rows, features (D % 4 != 0: the scalar copies) and majority tiles
    (odd counts: a partial last tile), no majority class (every score
    -0)."""
    args = _bal_pool(cuda_device, n, d, c, n_maj, n + c)
    _assert_pick_held(args, rare_empty)


def test_balancing_kernel_edge_cases(cuda_device):
    """Duplicate rows tie to the lower index; ineligible rows never win;
    a row on a majority centroid; a NaN row wins; nothing eligible is
    row 0."""
    emb, eligible, centers, maj, rarest = _bal_pool(cuda_device, 5000, 96,
                                                    12, 5, 7)
    eligible[:] = True
    scores = bal.balancing_scores_reference(emb, eligible, centers, maj,
                                            rarest, False)
    best = int(scores.argmin())
    lo = max(best - 3, 0)
    emb[best + 1:best + 40] = emb[best]
    emb[lo:best] = emb[best]  # earlier copies win
    args = (emb, eligible, centers, maj, rarest)
    got, want = _assert_pick_held(args, False)
    assert got == want == lo
    eligible[lo:best] = False
    got, want = _assert_pick_held(args, False)
    assert got == want == best
    eligible[:] = True
    emb[77] = centers[int(maj.nonzero()[0, 0])]
    _assert_pick_held(args, False)
    _assert_pick_held(args, True)
    emb[4000, 5] = float("nan")
    emb[4100, 0] = float("nan")
    got, want = _assert_pick_held(args, False)
    assert got == want == 4000
    eligible[:] = False
    got, want = _assert_pick_held(args, False)
    assert got == want == 0


def _state_run(dev, n, d, c, picks, seed, hold_every=True):
    """A balancing loop on a state on the card: each step picks (or, one
    step in four, takes a random eligible row as the random branch
    does), then takes the row and moves its class's center.  After each
    pick the state's tensors equal ones rebuilt from the takes alone, and
    the pick is held against the plain version on them."""
    emb, eligible, centers, _, _ = _bal_pool(dev, n, d, c, 1, seed)
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 50, size=c)
    counts[int(rng.integers(c))] = 0
    elig_np = eligible.cpu().numpy().copy()
    cent_np = centers.cpu().numpy().copy()
    state = bal.BalancingState(emb, eligible.clone(), centers.clone())
    before, kbefore = bal.launches, bal.kernel_launches
    n_picks = 0
    for step in range(picks):
        if step % 4 == 3:
            row = int(rng.choice(np.flatnonzero(elig_np)))
        else:
            maj = counts > counts.mean()
            rarest = int(np.argmin(counts))
            row = state.pick(maj, rarest, counts[rarest] == 0)
            n_picks += 1
            assert np.array_equal(state.eligible.cpu().numpy(), elig_np)
            assert torch.equal(state.centers.cpu(),
                               torch.from_numpy(cent_np))
            if hold_every or step == picks - 1:
                _assert_pick_held(
                    (emb, torch.from_numpy(elig_np).to(dev),
                     torch.from_numpy(cent_np).to(dev),
                     torch.from_numpy(maj).to(dev), rarest),
                    bool(counts[rarest] == 0), got=row)
        cls = int(rng.integers(c))
        center = (cent_np[cls] + rng.normal(size=d).astype(np.float32)
                  * 0.1).astype(np.float32)
        elig_np[row] = False
        cent_np[cls] = center
        counts[cls] += 1
        state.take(row, cls, center)
    assert bal.launches - before == n_picks
    assert bal.kernel_launches - kbefore == 2 * n_picks
    assert int(state._ticket.item()) == 0
    state.close()


@pytest.mark.parametrize("n,d,c", [(20431, 512, 10), (3001, 77, 300),
                                   (700, 2048, 1000)])
def test_balancing_state_update_kernel_against_a_rebuilt_state(
        cuda_device, n, d, c):
    """The update kernel applies the queued takes (eligibility, centers,
    every changed b2) as rebuilding the tensors does, on both paths."""
    _state_run(cuda_device, n, d, c, 24, seed=n)


def test_balancing_state_last_block_merge_over_many_picks(cuda_device):
    """300 picks in a row on one state: the fold's last block merges and
    resets the ticket every time (a ticket left behind would make no
    block the last one and the row stale), on both paths."""
    _state_run(cuda_device, 20431, 512, 10, 300, seed=1, hold_every=False)
    _state_run(cuda_device, 2000, 64, 64, 100, seed=2, hold_every=False)


def test_balancing_wrapper_raises_rather_than_falls_back(cuda_device):
    emb, eligible, centers, maj, rarest = _bal_pool(cuda_device, 64, 8, 4,
                                                    2, 0)
    with pytest.raises(ValueError, match="contiguous"):
        bal.balancing_pick(torch.zeros(64, 16, device=cuda_device)[:, ::2],
                           eligible, centers, maj, rarest, False)
    with pytest.raises(ValueError, match="one device"):
        bal.balancing_pick(emb, eligible.cpu(), centers, maj, rarest, False)


def test_balancing_state_on_the_card_raises_once_closed(cuda_device):
    """A closed state on the card raises: a CUDA tensor never takes the
    plain version.  Before that, its pick counts the kernels the C entry
    launched (the update and the fold)."""
    emb, eligible, centers, maj, rarest = _bal_pool(cuda_device, 512, 32, 6,
                                                    2, 3)
    state = bal.BalancingState(emb, eligible.clone(), centers.clone())
    before = bal.kernel_launches
    row = state.pick(maj.cpu().numpy(), rarest, False)
    assert bal.kernel_launches - before == 2 == state._st.launched
    _assert_pick_held((emb, eligible, centers, maj, rarest), False, got=row)
    state.close()
    with pytest.raises(RuntimeError, match="closed"):
        state.pick(maj.cpu().numpy(), rarest, False)
    assert bal.kernel_launches - before == 2


# -- kernel I: the s2d stem's weight gradient --------------------------------

def _stem_inputs(dev, b, h, w, dtype, contiguous, seed, f=64):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h, w, 12, device=dev, generator=g).to(dtype)
    gy = torch.randn(b, f, h, w, device=dev, generator=g).to(dtype)
    gy = gy.permute(0, 2, 3, 1)
    return x, (gy.contiguous() if contiguous else gy)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,contiguous", [
    (128, 112, 112, True), (8, 112, 112, False), (16, 112, 112, True),
    (1, 2, 2, True), (3, 4, 6, False), (2, 7, 5, True)])
def test_stem_dw_kernel_matches_plain(cuda_device, dtype, b, h, w,
                                      contiguous):
    """Kernel I against its plain version (float32, TF32 off) and the
    float64 truth at the fit width, a float32 batch and edge shapes.
    Bound per output: a sum whose chain is L in units of u is within
    L·u·Σ|x||g| of the exact sum; the kernel's chain is L_k units of
    ``error_unit`` (bf16: the tensor cores' truncated last place, 2⁻²³;
    f32: 2⁻²⁴), the plain version's at most R = B·H·W float32 additions.
    So kernel and plain differ by at most 2·max(L_k·u_k, R·2⁻²⁴)·Σ|x||g|,
    and the kernel is within 1.01·L_k·u_k·Σ|x||g| of the truth; and, as
    that worst case is above a typical |dW| at the fit width, within
    ``REL_NORM_LIMIT`` of the truth's norm (a kernel that skips or
    misreads a 16-position step fails that).  B=16 at 112x112: 7 tiles a
    run wrap the 4-stage copy ring.  Two launches are bit-equal."""
    x, g = _stem_inputs(cuda_device, b, h, w, dtype, contiguous, b + h)
    before = sc.launches
    got = sc.stem_dw(x, g)
    again = sc.stem_dw(x, g)
    torch.cuda.synchronize()
    assert sc.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == (64, 12, 4, 4)
    assert torch.equal(got, again)
    with torch.backends.cudnn.flags(allow_tf32=False):
        plain = sc.stem_dw_plain(x, g)
    truth = sc.stem_dw_plain(x.double(), g.double())
    mag = sc.stem_dw_plain(x.double().abs(), g.double().abs())
    lk = sc.chain_length(b, h, w, dtype) * sc.error_unit(dtype)
    big = max(lk, b * h * w * 2.0 ** -24)
    assert ((got.double() - plain.double()).abs() <= 2 * big * mag).all()
    assert ((got.double() - truth).abs() <= 1.01 * lk * mag).all()
    assert (torch.linalg.vector_norm(got.double() - truth)
            <= sc.REL_NORM_LIMIT * torch.linalg.vector_norm(truth))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kh,kw,pads,f", [(3, 3, ((1, 1), (1, 1)), 16),
                                          (8, 8, ((0, 0), (3, 4)), 64),
                                          (2, 5, ((1, 0), (0, 2)), 12)])
def test_stem_dw_kernel_other_taps_and_pads(cuda_device, kh, kw, pads, f,
                                            dtype):
    """Other kernel sizes, pads and filter counts: on the f32 path more
    than 256 (tap, 4-filter) pairs spread over grid.y; on the bf16 path
    more than three 64-row tiles (8x8: 768 rows) spread over grid.y, and
    F = 12 takes the 8-byte g copies."""
    g = torch.Generator(device=cuda_device).manual_seed(kh * kw)
    x = torch.randn(3, 9, 10, 12, device=cuda_device, generator=g).to(dtype)
    ho = 9 + pads[0][0] + pads[0][1] - kh + 1
    wo = 10 + pads[1][0] + pads[1][1] - kw + 1
    gy = torch.randn(3, ho, wo, f, device=cuda_device, generator=g).to(dtype)
    got = sc.stem_dw(x, gy, kh, kw, pads)
    truth = sc.stem_dw_plain(x.double(), gy.double(), kh, kw, pads)
    mag = sc.stem_dw_plain(x.double().abs(), gy.double().abs(), kh, kw, pads)
    lk = sc.chain_length(3, ho, wo, dtype, kh, kw) * sc.error_unit(dtype)
    assert got.shape == (f, 12, kh, kw)
    assert ((got.double() - truth).abs() <= 1.01 * lk * mag).all()
    assert (torch.linalg.vector_norm(got.double() - truth)
            <= sc.REL_NORM_LIMIT * torch.linalg.vector_norm(truth))
    assert torch.equal(got, sc.stem_dw(x, gy, kh, kw, pads))


def test_stem_conv_function_on_the_card(cuda_device):
    """S2DStemConv on the card: the weight gradient is kernel I's, in
    float32, equal to the wrapper's on the same tensors."""
    from active_learning_tpu_torch.models.resnet import S2DStemConv

    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(4, 12, 16, 16, device=cuda_device, generator=g).to(
        dtype=torch.bfloat16, memory_format=torch.channels_last)
    w = torch.randn(64, 12, 4, 4, device=cuda_device, generator=g,
                    requires_grad=True)
    y = S2DStemConv.apply(x, w, torch.bfloat16)
    gy = torch.randn(y.shape, device=cuda_device, generator=g).to(
        dtype=torch.bfloat16, memory_format=torch.channels_last)
    before = sc.launches
    (dw,) = torch.autograd.grad(y, [w], gy)
    assert sc.launches == before + 1
    assert dw.dtype == torch.float32
    assert torch.equal(dw, sc.stem_dw(x.permute(0, 2, 3, 1),
                                      gy.permute(0, 2, 3, 1)))


def test_stem_dw_wrapper_raises_rather_than_falls_back(cuda_device):
    x, g = _stem_inputs(cuda_device, 2, 8, 8, torch.float32, True, 0)
    with pytest.raises(TypeError, match="bf16 or f32"):
        sc.stem_dw(x.half(), g.half())
    with pytest.raises(ValueError, match="12 input channels"):
        sc.stem_dw(torch.zeros(2, 8, 8, 3, device=cuda_device), g)
    with pytest.raises(ValueError, match="share device"):
        sc.stem_dw(x, g.cpu())


# -- kernel J: the int8 gradient sync ------------------------------------------

def _int8_ranks(dev, n, seed):
    """n ranks' leaves: lengths on and off the 256 grid, magnitudes 1e-3
    to 10, a NaN on rank 0 and an inf on rank n-1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = [(64, 3, 7, 7), (64,), (300,), (1,), (255,), (257,),
              (256 * n + 3,), (512, 256)]
    per = [[torch.randn(s, device=dev, generator=g) * 10.0 ** (i % 5 - 3)
            for i, s in enumerate(shapes)] for _ in range(n)]
    per[0][2].view(-1)[7] = float("nan")
    per[n - 1][1].view(-1)[-1] = float("inf")
    return per


@pytest.mark.parametrize("form", ["allgather", "reduce_scatter"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_int8_sync_kernels_match_plain(cuda_device, n, form):
    """The four device functions against their plain versions, n thread
    ranks each running the sync the trainer runs: bit for bit on every
    rank (NaN bits included), the NaN's and the inf's blocks NaN
    everywhere."""
    fn = (mesh_lib.int8_allreduce if form == "allgather"
          else mesh_lib.int8_reduce_scatter)
    per = _int8_ranks(cuda_device, n, n)
    host = [[t.cpu() for t in ts] for ts in per]
    before = j.quantize_launches
    got = mesh_lib.run_thread_ranks(lambda m: fn(per[m.rank], m), n,
                                    cuda_device, timeout_s=120)
    want = mesh_lib.run_thread_ranks(lambda m: fn(host[m.rank], m), n,
                                     "cpu", timeout_s=120)
    torch.cuda.synchronize()
    assert j.quantize_launches == before + n
    for r in range(n):
        for a, b in zip(got[r], want[r]):
            assert torch.equal(a.cpu().view(torch.int32),
                               b.view(torch.int32))
        assert torch.isnan(got[r][2][:256]).all()
        assert torch.isnan(got[r][1]).all()


def test_int8_sync_wrappers_raise_rather_than_fall_back(cuda_device):
    x = torch.zeros(600, device=cuda_device)
    with pytest.raises(ValueError, match="multiple"):
        j.block_absmax(x[:300])
    with pytest.raises(ValueError, match="aligned"):
        j.block_absmax(x[1:257])
    with pytest.raises(ValueError):
        j.quantize(x[:256], torch.zeros(1))            # absmax on the CPU
    q = torch.zeros(2, 512, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):
        j.dequant_sum(q, torch.zeros(2, device=cuda_device),
                      torch.zeros(3, device=cuda_device))
