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
