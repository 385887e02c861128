"""The port's SSLClassifier against the JAX package's, float32 on the CPU.

Weights come from the JAX model's own ``init(PRNGKey(seed))``, with the
BatchNorm running statistics redrawn from a numpy seed (init leaves them
at mean 0 / var 1, which would hide a wrong BN formula), and go into the
port through ``models/weights.from_flax_variables``.  Inputs are numpy
draws.  Tolerance: logits and embedding within 1e-4 absolute plus 1e-4
relative — the same float32 network, with convolutions summed in another
order by XLA and by PyTorch.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from active_learning_tpu.models.resnet import resnet18 as jax_resnet18
from active_learning_tpu.models.resnet import resnet50 as jax_resnet50

from active_learning_tpu_torch.models import weights
from active_learning_tpu_torch.models.factory import (
    get_network, resolve_bn_stats_dtype, resolve_dtype)
from active_learning_tpu_torch.models.resnet import BatchNorm

CASES = {
    "SSLResNet18-cifar": (jax_resnet18(10, cifar_stem=True), "cifar10",
                          "SSLResNet18", 16),
    "SSLResNet50-default": (jax_resnet50(1000), "imagenet", "SSLResNet50",
                            32),
}


def _redraw_batch_stats(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _redraw_batch_stats(v, rng)
        elif k == "mean":
            tree[k] = (rng.standard_normal(v.shape) * 0.2).astype(np.float32)
        elif k == "var":
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    jax_model, dataset, name, hw = CASES[request.param]
    x = np.random.default_rng(0).standard_normal((2, hw, hw, 3)).astype(
        np.float32)
    variables = jax.jit(lambda k, x: jax_model.init(k, x, train=False))(
        jax.random.PRNGKey(0), x)
    variables = jax.tree.map(np.asarray, variables)
    _redraw_batch_stats(variables["batch_stats"], np.random.default_rng(1))
    model = get_network(dataset, name, dtype="float32", device="cpu")
    weights.load_flax_variables(model, variables)
    return jax_model, variables, model, x


def _close(got, ref):
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_forward_modes_match_jax(pair):
    jax_model, variables, model, x = pair
    fwd = jax.jit(lambda v, x: jax_model.apply(v, x, train=False,
                                                return_features=True))
    ref_logits, ref_emb = fwd(variables, x)
    ref_plain = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(
        variables, x)
    ref_head = jax.jit(lambda v, e: jax_model.apply(v, e, method="head"))(
        variables, ref_emb)
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        logits, emb = model(xt, return_features=True)
        plain = model(xt)
        head = model.head(torch.from_numpy(np.array(ref_emb)))
    assert logits.dtype == emb.dtype == torch.float32
    assert emb.shape == (2, model.embed_dim)
    _close(logits.numpy(), ref_logits)
    _close(emb.numpy(), ref_emb)
    _close(plain.numpy(), ref_plain)
    _close(head.numpy(), ref_head)


def test_weight_carry_round_trip_is_exact(pair):
    _, variables, model, _ = pair
    back = weights.to_flax_variables(weights.from_flax_variables(variables))
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    sd = model.state_dict()
    sd2 = weights.from_flax_variables(weights.to_flax_variables(sd))
    assert sd.keys() == sd2.keys()
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)


def test_every_bn_runs_through_bn_act_with_its_coefficients(pair):
    """The coefficient cache follows a weight load: reloading different
    statistics changes the next forward."""
    _, variables, model, x = pair
    with torch.inference_mode():
        before = model(torch.from_numpy(x))
    v2 = jax.tree.map(np.copy, variables)
    _redraw_batch_stats(v2["batch_stats"], np.random.default_rng(7))
    weights.load_flax_variables(model, v2)
    with torch.inference_mode():
        after = model(torch.from_numpy(x))
    weights.load_flax_variables(model, variables)
    assert not torch.equal(before, after)
    with torch.inference_mode():
        assert torch.equal(model(torch.from_numpy(x)), before)


def test_training_mode_raises():
    """Training mode runs now (kernel C, tests/test_torch_train.py); what
    still raises is training through an eval-mode BatchNorm (pretrained
    fine-tuning), which has no backward yet (ROADMAP.md)."""
    model = get_network("cifar10", "SSLResNet18", device="cpu",
                        num_filters=4)
    model.train()
    assert model(torch.zeros(2, 8, 8, 3)).shape == (2, 10)
    model.eval()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        model(torch.zeros(1, 8, 8, 3))


def test_factory_resolution_follows_the_jax_package():
    assert resolve_dtype("auto", "cpu") == torch.float32
    assert resolve_dtype("auto", "cuda") == torch.bfloat16
    assert resolve_dtype("bf16", "cpu") == torch.bfloat16
    with pytest.raises(ValueError):
        resolve_dtype("fp8", "cpu")
    assert resolve_bn_stats_dtype("auto", torch.bfloat16, "cuda") \
        == torch.bfloat16
    assert resolve_bn_stats_dtype("auto", torch.float32, "cpu") is None
    assert resolve_bn_stats_dtype("float32", torch.bfloat16, "cuda") is None
    # The CIFAR stem follows num_classes == 10, as in the reference.
    m = get_network("imagenet", "SSLResNet18", num_classes=10, device="cpu",
                    num_filters=4)
    assert m.cifar_stem and m.embed_dim == 32
    m = get_network("imagenet", "SSLResNet50", device="cpu", num_filters=4,
                    dtype="bf16")
    assert not m.cifar_stem and m.embed_dim == 128
    assert m.dtype == torch.bfloat16
    assert all(b.fused_stats for b in m.modules() if isinstance(b, BatchNorm))
    # A CIFAR run with the global s2d choice keeps its stem; an ImageNet
    # one gets the s2d stem, as in the reference.
    assert get_network("cifar10", "SSLResNet18", stem="s2d", device="cpu",
                       num_filters=4).cifar_stem
    m = get_network("imagenet", "SSLResNet50", stem="s2d", device="cpu")
    assert m.stem == "s2d" and not m.cifar_stem
    assert m.encoder.conv_stem.weight.shape == (64, 12, 4, 4)
