"""The port's kernels against their plain versions, on the card.

Marked ``cuda``: they skip with a reason where no card is visible (a
skip is not a pass).  This file imports torch and the port only, so it
runs on a machine without JAX; there, skip the JAX-importing conftest:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda -q
"""

from __future__ import annotations

import pytest
import torch

from active_learning_tpu_torch.ops import bn_act as ba
from active_learning_tpu_torch.ops import bn_train as bt
from active_learning_tpu_torch.ops import fused_sgd as fs
from active_learning_tpu_torch.ops import prob_stats as ps

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel runs only there")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("b,c", [(8, 10), (64, 1000), (3, 33), (5, 513)])
def test_prob_stats_kernel_matches_plain(cuda_device, b, c):
    """pred exact (ties included); confidence and margin within 1e-6;
    entropy within 1e-6 plus 1e-6 of its value (a sum of C float32
    terms in another order)."""
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


def _cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4, 96, 7, 9), (2, 64, 56, 56),
                                   (3, 33, 5, 5)])
def test_bn_train_kernels_match_plain(cuda_device, dtype, shape):
    """Kernel C's three functions against their plain versions on the
    same inputs.  The sums are f32 sums in another order: within 1e-5 of
    the sum of magnitudes (per row count for the means).  dx from the
    same coefficients: bit-equal (the same separately rounded float32
    operations).  Two launches: bit-equal (the row partition depends on
    the shape only, and nothing is atomic)."""
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    x = _cl((torch.randn(shape, device=cuda_device, generator=g) * 2 + 1)
            .to(dtype))
    gy = _cl(torch.randn(shape, device=cuda_device, generator=g).to(dtype))
    n = shape[0] * shape[2] * shape[3]
    before = (bt.stats_launches, bt.reduce_launches, bt.dx_launches)
    mean, mean2 = bt.bn_stats(x)
    s1, s2 = bt.bn_bwd_reduce(gy, x)
    c = shape[1]
    mul, c2, c1 = (torch.randn(c, device=cuda_device, generator=g)
                   for _ in range(3))
    dx = bt.bn_dx(gy, x, mul, c2, c1)
    torch.cuda.synchronize()
    assert (bt.stats_launches, bt.reduce_launches, bt.dx_launches) == tuple(
        v + 1 for v in before)
    rm, rm2 = bt.channel_sums_reference(x, x, 1.0 / n)
    rs1, rs2 = bt.channel_sums_reference(gy, x)
    xf, gf = x.float(), gy.float()
    dims = (0, 2, 3)
    for got, ref, mag in ((mean, rm, xf.abs().sum(dims) / n),
                          (mean2, rm2, (xf * xf).sum(dims) / n),
                          (s1, rs1, gf.abs().sum(dims)),
                          (s2, rs2, (gf * xf).abs().sum(dims))):
        assert bool(((got - ref).abs() <= 1e-5 * mag + 1e-30).all())
    assert torch.equal(dx, bt.bn_dx_reference(gy, x, mul, c2, c1))
    assert dx.is_contiguous(memory_format=torch.channels_last)
    again = bt.bn_stats(x) + bt.bn_bwd_reduce(gy, x)
    for a, b in zip(again, (mean, mean2, s1, s2)):
        assert torch.equal(a, b)


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


def test_training_wrappers_raise_rather_than_fall_back(cuda_device):
    x = torch.zeros(2, 8, 3, 3, device=cuda_device)  # NCHW-contiguous
    with pytest.raises(ValueError, match="channels_last"):
        bt.bn_stats(x)
    with pytest.raises(TypeError):
        bt.bn_stats(_cl(x.double()))
    p = torch.zeros(8, device=cuda_device)
    with pytest.raises(TypeError):
        fs.fused_sgd_update([p], [p.double()], [p.clone()], 0.1, 0.9, 0.0)
