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

The space-to-depth stem (``stem="s2d"``, the JAX package's
``resnet.py:27-36, 69-107, 210-229``): the 224-px 7x7/s2 stem conv is
the same convolution as a 4x4/s1 conv over the input re-laid as
112x112x12 (2x2 pixel blocks flattened into channels, in the order
``(di, dj, c)``), with the 7x7 kernel folded by ``s2d_stem_kernel``.  The
encoder takes either layout: 3-channel rows are re-laid on the device,
12-channel rows (the host feed's ``data/pipeline.space_to_depth``) pass
through.  The stem conv trains through ``S2DStemConv``, whose weight
gradient is kernel I (``ops/stem_conv``, float32 accumulation).

Training mode (``model.train()``) uses batch statistics (the global
batch's when ``set_sync_group`` gave the BatchNorms a group of ranks,
as the JAX model's ``clone(axis_name=...)`` does) and updates the
running statistics outside the graph, ``ra = 0.9·ra + 0.1·batch`` with
the biased batch variance, as flax does.  Eval-mode BatchNorm with
gradients recorded (pretrained fine-tuning: the reference keeps
BatchNorm in eval mode under a checkpoint) runs ``ops.bn_act``'s
``BatchNormEval``: kernel B forward, kernel B′ backward, with the
coefficients made in the graph from ``scale`` and ``bias`` that step;
the cached coefficients serve only forwards that record no gradient.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import bn_act as bn_act_lib
from ..ops import bn_train as bn_train_lib
from ..ops import stem_conv as stem_conv_lib

# Space-to-depth block size of the 224-px stem: 2x2 pixel blocks -> 12
# channels.  The channel order within a block is (di, dj, c) row-major;
# ``space_to_depth`` here, ``data/pipeline.space_to_depth`` and
# ``s2d_stem_kernel`` agree on it.
S2D_BLOCK = 2

# The folded 7x7/pad-3 window in s2d coordinates: ((top, bottom),
# (left, right)) zero padding of the 4x4/s1 conv.
S2D_PADDING = stem_conv_lib.S2D_PADDING


def _permute(a, axes):
    return a.permute(*axes) if isinstance(a, torch.Tensor) \
        else a.transpose(axes)


def space_to_depth(x, block: int = S2D_BLOCK):
    """``[B, H, W, C] -> [B, H/b, W/b, b·b·C]`` on a torch tensor or a
    numpy array (pure reshape and transpose); channel index ``(di·b +
    dj)·C + c``."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = _permute(x, (0, 1, 3, 2, 4, 5))
    return x.reshape(b, h // block, w // block, block * block * c)


def s2d_stem_kernel(kernel7):
    """Fold a ``[7, 7, C, F]`` (HWIO) stride-2/pad-3 stem kernel into the
    exact ``[4, 4, 4C, F]`` stride-1 kernel over space-to-depth input, on
    a torch tensor or a numpy array.

    Output (i, j) sums ``W[a, b, c]·X[2i+a−3, 2j+b−3, c]``.  Writing the
    input row as ``u = 2p + di`` gives ``a = 2r + di − 1`` for the s2d tap
    ``r = p − i + 2 ∈ 0..3``: pad the kernel to 8x8 with one leading zero
    row and column, then regroup ``[4, 2, 4, 2]`` into taps and in-block
    offsets.  Pure re-indexing: every product of the 7x7 conv appears
    once (plus 4C·F structural zeros)."""
    kh, kw, c, f = kernel7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"the stem kernel must be 7x7, got {kh}x{kw}")
    if isinstance(kernel7, torch.Tensor):
        padded = kernel7.new_zeros((8, 8, c, f))
    else:
        padded = np.zeros((8, 8, c, f), dtype=kernel7.dtype)
    padded[1:, 1:] = kernel7
    k = padded.reshape(4, 2, 4, 2, c, f)            # [r, di, s, dj, c, f]
    k = _permute(k, (0, 2, 1, 3, 4, 5))             # [r, s, di, dj, c, f]
    return k.reshape(4, 4, 4 * c, f)


def stem_kernel_from_s2d(kernel4):
    """Inverse of ``s2d_stem_kernel``: ``[4, 4, 4C, F] -> [7, 7, C, F]``
    (drops the structural zero row and column)."""
    kh, kw, c4, f = kernel4.shape
    if (kh, kw) != (4, 4) or c4 % 4:
        raise ValueError(f"not an s2d stem kernel: {tuple(kernel4.shape)}")
    c = c4 // 4
    k = kernel4.reshape(4, 4, 2, 2, c, f)           # [r, s, di, dj, c, f]
    k = _permute(k, (0, 2, 1, 3, 4, 5))             # [r, di, s, dj, c, f]
    return k.reshape(8, 8, c, f)[1:, 1:]


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


def _pad_s2d(x: torch.Tensor) -> torch.Tensor:
    (p0, p1), (q0, q1) = S2D_PADDING
    return F.pad(x, (q0, q1, p0, p1)).contiguous(
        memory_format=torch.channels_last)


class S2DStemConv(torch.autograd.Function):
    """The s2d stem's 4x4/s1 conv with the JAX package's hand-written
    backward (``ops/backward.py:65-117``), over a channels-last ``[B, 4C,
    H, W]`` activation already in the compute dtype ``dtype`` and the
    float32 weight.

    Forward: the weight is cast to the compute dtype inside the
    Function, so the cast is not in the autograd graph and the weight's
    gradient is the kernel's float32 sum, not one rounded to bf16 by the
    cast's backward.  ``F.conv2d`` has no asymmetric padding, so the
    input is padded by ``S2D_PADDING`` first (one copy of the 12-channel
    input, 38.5 MB at B=128 in bf16; padding 2 on every side and
    dropping the last output row and column would compute 1.8% more and
    copy the 64-channel output, 205 MB, into the channels-last layout
    kernel C takes).
    Backward: ``dW`` through kernel I (``ops/stem_conv.stem_dw``,
    float32); ``dx`` through ``torch.nn.grad.conv2d_input`` only when
    the input needs it (the stem's input never does in training)."""

    @staticmethod
    def forward(ctx, x, weight, dtype):
        w = weight.detach().to(dtype=dtype,
                               memory_format=torch.channels_last)
        ctx.save_for_backward(x, w)
        ctx.weight_dtype = weight.dtype
        return F.conv2d(_pad_s2d(x), w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        (p0, p1), (q0, q1) = S2D_PADDING
        kh, kw = w.shape[2], w.shape[3]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            b, c, h, wd = x.shape
            dxp = torch.nn.grad.conv2d_input(
                (b, c, h + p0 + p1, wd + q0 + q1), w, gy)
            dx = dxp[:, :, p0:p0 + h, q0:q0 + wd]
        if ctx.needs_input_grad[1]:
            dw = stem_conv_lib.stem_dw(
                x.permute(0, 2, 3, 1), gy.permute(0, 2, 3, 1), kh, kw,
                S2D_PADDING).to(ctx.weight_dtype)
        return dx, dw, None


class S2DStem(Conv):
    """The s2d stem conv: ``[F, 4C, 4, 4]`` float32 weights, padding
    ``S2D_PADDING``.  With gradients recorded it runs ``S2DStemConv``;
    otherwise ``Conv``'s cached ``dtype`` copy of the weight."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__(cin, cout, 4, 1, 0, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and (self.weight.requires_grad
                                        or x.requires_grad):
            return S2DStemConv.apply(x, self.weight, self.dtype)
        return F.conv2d(_pad_s2d(x), self.compute_weight())


class BatchNorm(nn.Module):
    """BatchNorm with float32 ``scale``/``bias`` parameters and float32
    running ``mean``/``var``, with an optional residual add and ReLU
    fused in.  Eval mode applies the running statistics through kernel
    B (differentiable through kernel B′ when gradients are recorded);
    training mode normalizes with the batch statistics through kernel C
    and updates the running ones.  ``fused_stats`` selects the
    JAX package's ``FusedBatchNorm`` formula (bf16 statistics), else
    flax ``nn.BatchNorm``'s."""

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
        # The ranks whose rows share the batch statistics (None: this
        # rank's batch alone); see ``set_sync_group``.
        self.group = None
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
            # Kernel C updates the running statistics in place (momentum
            # bn_train_lib.MOMENTUM, flax's 0.9).
            y, _, _ = bn_train_lib.bn_train(
                x, self.scale, self.bias, self.eps, self.fused_stats,
                residual, relu, self.group, (self.mean, self.var))
            return y
        if torch.is_grad_enabled() and (
                x.requires_grad or self.scale.requires_grad
                or self.bias.requires_grad
                or (residual is not None and residual.requires_grad)):
            # Fine-tuning through eval-mode BN: this step's coefficients,
            # in the graph, so scale and bias get their gradients.
            coeffs = bn_act_lib.bn_coefficients(
                self.scale, self.bias, self.mean, self.var, self.eps,
                self.dtype, self.fused_stats)
            return bn_act_lib.bn_act_train(x, coeffs, residual, relu)
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
                 fused_stats: bool = False, stem: str = "default"):
        super().__init__()
        _check_stem(stem, cifar_stem)
        self.dtype = dtype
        self.cifar_stem = cifar_stem
        self.stem = stem
        if cifar_stem:
            # SimCLR CIFAR stem: 3x3 stride-1 conv, no max pool.
            self.conv_stem = Conv(3, num_filters, 3, 1, 1, dtype)
        elif stem == "s2d":
            self.conv_stem = S2DStem(3 * S2D_BLOCK ** 2, num_filters, dtype)
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
        """``x``: float ``[B, H, W, 3]`` (NHWC, already normalized), or
        ``[B, H/2, W/2, 12]`` space-to-depth rows for the s2d stem."""
        if self.stem == "s2d" and x.shape[-1] == 3:
            x = space_to_depth(x)
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
                 freeze_feature: bool = False, stem: str = "default"):
        super().__init__()
        self.num_classes = num_classes
        self.cifar_stem = cifar_stem
        self.stem = stem
        self.freeze_feature = freeze_feature
        self.dtype = dtype
        self.encoder = ResNetEncoder(stage_sizes, block_cls, num_filters,
                                     cifar_stem, dtype, fused_stats, stem)
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


def _check_stem(stem: str, cifar_stem: bool) -> None:
    if stem not in ("default", "s2d"):
        raise ValueError(f"unknown stem {stem!r}; expected 'default'/'s2d'")
    if stem == "s2d" and cifar_stem:
        raise ValueError("the s2d stem refactors the 7x7/s2 ImageNet stem; "
                         "the CIFAR stem (3x3/s1) has nothing to fold")


def resnet18(num_classes: int, cifar_stem: bool = False,
             dtype: torch.dtype = torch.float32, fused_stats: bool = False,
             num_filters: int = 64, freeze_feature: bool = False,
             stage_sizes: Sequence[int] = (2, 2, 2, 2),
             stem: str = "default") -> SSLClassifier:
    return SSLClassifier(stage_sizes, BasicBlock, num_classes, cifar_stem,
                         dtype, fused_stats, num_filters, freeze_feature,
                         stem)


def resnet50(num_classes: int, cifar_stem: bool = False,
             dtype: torch.dtype = torch.float32, fused_stats: bool = False,
             num_filters: int = 64, freeze_feature: bool = False,
             stage_sizes: Sequence[int] = (3, 4, 6, 3),
             stem: str = "default") -> SSLClassifier:
    return SSLClassifier(stage_sizes, BottleneckBlock, num_classes,
                         cifar_stem, dtype, fused_stats, num_filters,
                         freeze_feature, stem)


def set_sync_group(model: nn.Module, group) -> None:
    """Training-mode statistics over the ranks of ``group`` (a
    ``parallel.mesh.Mesh``; None: each rank's own batch) for every
    BatchNorm of ``model``."""
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.group = group


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
