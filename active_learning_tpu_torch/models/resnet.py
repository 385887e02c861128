"""ResNet-18/50 with the SimCLR CIFAR stem and a split encoder / linear
head (the JAX package's ``models/resnet.py``).

Module and parameter names are flax's (``encoder.conv_stem``,
``encoder.stage1_block0.Conv_0``, ``...BatchNorm_0``,
``downsample_conv``/``downsample_bn``, ``linear``), so the weight carry
(``models/weights.py``) is a renaming of leaves plus two transposes.

Layout and precision, as in the JAX package: the public input is NHWC
``[B, H, W, C]``; inside, activations are channels-last
(``torch.channels_last``, the same bytes as NHWC); ``dtype`` is the
compute precision of the convolutions and activations (bf16 on the
card), while parameters and BN statistics stay float32 and the pooled
embedding and the head are float32.  Every BatchNorm, with the residual
add and ReLU that follow it, is one call of ``ops.bn_act`` (kernel B) in
eval mode, and of ``ops.bn_train`` (kernel C, whose normalize pass is
kernel B) in training mode.  Convolutions, max-pool, the global mean and
the head are stock PyTorch (cuDNN/cuBLAS), as they were XLA's generic
lowering in the JAX package.

Training mode (``model.train()``) uses batch statistics and updates the
running statistics outside the graph, ``ra = 0.9·ra + 0.1·batch`` with
the biased batch variance, as flax does.  Eval-mode BatchNorm has no
backward (kernel B is forward-only), so a forward that needs gradients
through an eval-mode BatchNorm raises: that is pretrained fine-tuning,
still to be ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import bn_act as bn_act_lib
from ..ops import bn_train as bn_train_lib


def _cache_key(tensors: Sequence[torch.Tensor], dtype: torch.dtype) -> Tuple:
    # A weight load copies in place (bumps _version); a device move makes
    # new storage (new data_ptr).  Either invalidates a derived copy.
    return (dtype,) + tuple((t.device, t.data_ptr(), t._version)
                            for t in tensors)


class Conv(nn.Module):
    """Bias-free 2-D convolution with float32 weights computed in
    ``dtype``.  When gradients are recorded the cast is part of the
    graph (the weight's gradient arrives in float32); otherwise the
    ``dtype`` channels-last copy is made once per weight version, not
    once per forward."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        nn.init.kaiming_normal_(self.weight, mode="fan_out",
                                nonlinearity="relu")
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self._cast: Optional[torch.Tensor] = None
        self._cast_key: Optional[Tuple] = None

    def compute_weight(self) -> torch.Tensor:
        if torch.is_grad_enabled() and self.weight.requires_grad:
            return self.weight.to(dtype=self.dtype,
                                  memory_format=torch.channels_last)
        key = _cache_key((self.weight,), self.dtype)
        if key != self._cast_key:
            with torch.no_grad():
                self._cast = self.weight.detach().to(
                    dtype=self.dtype, memory_format=torch.channels_last)
            self._cast_key = key
        return self._cast

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.compute_weight(), stride=self.stride,
                        padding=self.padding)


class BatchNorm(nn.Module):
    """BatchNorm with float32 ``scale``/``bias`` parameters and float32
    running ``mean``/``var``, with an optional residual add and ReLU
    fused in.  Eval mode applies the running statistics through kernel
    B; training mode normalizes with the batch statistics through
    kernel C and updates the running ones.  ``fused_stats`` selects the
    JAX package's ``FusedBatchNorm`` formula (bf16 statistics), else
    flax ``nn.BatchNorm``'s."""

    momentum = 0.9

    def __init__(self, features: int, dtype: torch.dtype,
                 fused_stats: bool, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.dtype = dtype
        self.fused_stats = fused_stats
        self.eps = eps
        self._coeffs: Optional[bn_act_lib.Coefficients] = None
        self._coeffs_key: Optional[Tuple] = None

    def coefficients(self) -> bn_act_lib.Coefficients:
        """Per-channel (shift, mul, add), made once per weight version."""
        key = _cache_key((self.scale, self.bias, self.mean, self.var),
                         self.dtype)
        if key != self._coeffs_key:
            with torch.no_grad():
                self._coeffs = bn_act_lib.bn_coefficients(
                    self.scale.detach(), self.bias.detach(), self.mean,
                    self.var, self.eps, self.dtype, self.fused_stats)
            self._coeffs_key = key
        return self._coeffs

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None,
                relu: bool = False) -> torch.Tensor:
        if self.training:
            y, mean, var = bn_train_lib.bn_train(
                x, self.scale, self.bias, self.eps, self.fused_stats,
                residual, relu)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
            return y
        if torch.is_grad_enabled() and (
                x.requires_grad or self.scale.requires_grad):
            raise NotImplementedError(
                "training through an eval-mode BatchNorm (pretrained "
                "fine-tuning) needs a backward for kernel B, still to be "
                "ported (ROADMAP.md); train BN in training mode, or run "
                "the forward under torch.no_grad()")
        return bn_act_lib.bn_act(x, self.coefficients(), residual, relu)


class BasicBlock(nn.Module):
    """ResNet v1.5 basic block (two 3x3 convs) — resnet18/34."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int,
                 dtype: torch.dtype, fused_stats: bool):
        super().__init__()
        # 3x3 convs use explicit (1, 1) padding, as the JAX package does
        # (resnet.py:242-249): for stride 2 on an even size, XLA's SAME
        # would pad (0, 1) and shift every window by a pixel.
        self.Conv_0 = Conv(cin, filters, 3, stride, 1, dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype, fused_stats)
        self.Conv_1 = Conv(filters, filters, 3, 1, 1, dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype, fused_stats)
        self.has_downsample = stride != 1 or cin != filters
        if self.has_downsample:
            self.downsample_conv = Conv(cin, filters, 1, stride, 0, dtype)
            self.downsample_bn = BatchNorm(filters, dtype, fused_stats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = self.BatchNorm_0(self.Conv_0(x), relu=True)
        y = self.Conv_1(y)
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return self.BatchNorm_1(y, residual=residual, relu=True)


class BottleneckBlock(nn.Module):
    """ResNet v1.5 bottleneck (1x1 -> strided 3x3 -> 1x1 x4) — resnet50."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int,
                 dtype: torch.dtype, fused_stats: bool):
        super().__init__()
        cout = filters * 4
        self.Conv_0 = Conv(cin, filters, 1, 1, 0, dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype, fused_stats)
        self.Conv_1 = Conv(filters, filters, 3, stride, 1, dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype, fused_stats)
        self.Conv_2 = Conv(filters, cout, 1, 1, 0, dtype)
        self.BatchNorm_2 = BatchNorm(cout, dtype, fused_stats)
        self.has_downsample = stride != 1 or cin != cout
        if self.has_downsample:
            self.downsample_conv = Conv(cin, cout, 1, stride, 0, dtype)
            self.downsample_bn = BatchNorm(cout, dtype, fused_stats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = self.BatchNorm_0(self.Conv_0(x), relu=True)
        y = self.BatchNorm_1(self.Conv_1(y), relu=True)
        y = self.Conv_2(y)
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return self.BatchNorm_2(y, residual=residual, relu=True)


class ResNetEncoder(nn.Module):
    """Backbone producing the pooled float32 embedding (fc removed)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_filters: int = 64, cifar_stem: bool = False,
                 dtype: torch.dtype = torch.float32,
                 fused_stats: bool = False):
        super().__init__()
        self.dtype = dtype
        self.cifar_stem = cifar_stem
        if cifar_stem:
            # SimCLR CIFAR stem: 3x3 stride-1 conv, no max pool.
            self.conv_stem = Conv(3, num_filters, 3, 1, 1, dtype)
        else:
            self.conv_stem = Conv(3, num_filters, 7, 2, 3, dtype)
        self.bn_stem = BatchNorm(num_filters, dtype, fused_stats)
        self.block_names = []
        cin = num_filters
        for i, count in enumerate(stage_sizes):
            filters = num_filters * 2 ** i
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                name = f"stage{i + 1}_block{j}"
                self.add_module(name, block_cls(cin, filters, stride, dtype,
                                                fused_stats))
                self.block_names.append(name)
                cin = filters * block_cls.expansion
        self.embed_dim = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: float ``[B, H, W, 3]`` (NHWC, already normalized)."""
        x = x.permute(0, 3, 1, 2).to(dtype=self.dtype,
                                     memory_format=torch.channels_last)
        x = self.bn_stem(self.conv_stem(x), relu=True)
        if not self.cifar_stem:
            # -inf padding, as lax.reduce_window pads a max.
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        # Global mean in the compute dtype (float32 accumulation), then
        # float32 for the head and the acquisition math.
        return x.mean(dim=(2, 3)).to(torch.float32)


class SSLClassifier(nn.Module):
    """Encoder + separate linear head.

    Forward modes, as in the JAX package:
      * ``model(x)``                        -> logits
      * ``model(x, return_features=True)``  -> (logits, embedding)
      * ``model.head(embedding)``           -> logits from an embedding

    ``freeze_feature`` runs the encoder under ``torch.no_grad()``, so
    only the head trains (the JAX model's ``stop_gradient`` on the
    embedding).
    """

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int, cifar_stem: bool = False,
                 dtype: torch.dtype = torch.float32,
                 fused_stats: bool = False, num_filters: int = 64,
                 freeze_feature: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.cifar_stem = cifar_stem
        self.freeze_feature = freeze_feature
        self.dtype = dtype
        self.encoder = ResNetEncoder(stage_sizes, block_cls, num_filters,
                                     cifar_stem, dtype, fused_stats)
        self.linear = nn.Linear(self.encoder.embed_dim, num_classes)
        nn.init.normal_(self.linear.weight, std=1e-3)
        nn.init.zeros_(self.linear.bias)
        self.eval()

    @property
    def embed_dim(self) -> int:
        return self.encoder.embed_dim

    def forward(self, x: torch.Tensor, return_features: bool = False):
        if self.freeze_feature:
            with torch.no_grad():
                embedding = self.encoder(x)
        else:
            embedding = self.encoder(x)
        logits = self.linear(embedding)
        if return_features:
            return logits, embedding
        return logits

    def head(self, embedding: torch.Tensor) -> torch.Tensor:
        return self.linear(embedding)


def resnet18(num_classes: int, cifar_stem: bool = False,
             dtype: torch.dtype = torch.float32, fused_stats: bool = False,
             num_filters: int = 64, freeze_feature: bool = False,
             stage_sizes: Sequence[int] = (2, 2, 2, 2)) -> SSLClassifier:
    return SSLClassifier(stage_sizes, BasicBlock, num_classes, cifar_stem,
                         dtype, fused_stats, num_filters, freeze_feature)


def resnet50(num_classes: int, cifar_stem: bool = False,
             dtype: torch.dtype = torch.float32, fused_stats: bool = False,
             num_filters: int = 64, freeze_feature: bool = False,
             stage_sizes: Sequence[int] = (3, 4, 6, 3)) -> SSLClassifier:
    return SSLClassifier(stage_sizes, BottleneckBlock, num_classes,
                         cifar_stem, dtype, fused_stats, num_filters,
                         freeze_feature)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Fresh random weights in place, with the JAX package's
    initializers: convolutions He-normal over fan-out (``std =
    sqrt(2 / (out·kh·kw))``), the head's weight N(0, 1e-3) and bias 0,
    BatchNorm scale 1, bias 0 and running statistics (0, 1).  Draws come
    from ``generator`` (a CPU generator) in module order, so a seed gives
    the same weights on any device; they are not flax's numbers."""
    for mod in model.modules():
        if isinstance(mod, Conv):
            w = mod.weight
            std = (2.0 / (w.shape[0] * w.shape[2] * w.shape[3])) ** 0.5
            w.copy_(torch.empty(w.shape).normal_(0.0, std,
                                                 generator=generator))
        elif isinstance(mod, BatchNorm):
            mod.scale.fill_(1.0)
            mod.bias.fill_(0.0)
            mod.mean.fill_(0.0)
            mod.var.fill_(1.0)
        elif isinstance(mod, nn.Linear):
            mod.weight.copy_(torch.empty(mod.weight.shape).normal_(
                0.0, 1e-3, generator=generator))
            mod.bias.fill_(0.0)
