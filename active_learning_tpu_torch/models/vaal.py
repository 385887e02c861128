"""VAAL's auxiliary models: the VAE and the latent discriminator (the JAX
package's ``models/vaal.py``; reference src/query_strategies/vae.py:18-102
and vaal_discriminator.py:5-31).

Module and parameter names are flax's (``enc_conv0..3``, ``enc_bn0..3``,
``fc_mu``, ``fc_logvar``, ``dec_dense``, ``dec_deconv0..2``,
``dec_bn0..2``, ``dec_out``; ``Dense_0..2``), so the weight carry
(``models/weights.py``) is a renaming of leaves.  The public input is
NHWC float32 ``[B, crop, crop, 3]``, as in the JAX package; inside,
activations are channels-last NCHW, and the two flattens that the flax
model does in NHWC (after the encoder, before the decoder) permute to
NHWC and back, so ``fc_mu``, ``fc_logvar`` and ``dec_dense`` see the
features in flax's order.

Each flax ``ConvTranspose(padding=((2, 2), (2, 2)))`` (no kernel
transpose) is torch's ``conv_transpose2d(stride=2, padding=1)`` with the
kernel flipped in both spatial axes: ``w_torch[ci, co, kh, kw] =
w_flax[3 - kh, 3 - kw, ci, co]``.  BatchNorm is the port's
``models/resnet.BatchNorm`` with flax ``nn.BatchNorm``'s formula in
float32 and the ReLU fused: kernel C in training mode, kernel B in eval
mode.  Everything is float32 (these nets are small next to the
classifier).

``init_vaal_weights`` draws fresh weights from a torch generator with
the JAX package's initializers and flax's fan-ins: He-normal over the
fan-in for the convolutions and dense layers, flax's default (LeCun
truncated normal, fan-in ``kh·kw·in``) for the deconvolutions, whose
torch weight keeps ``in`` in dim 0.  The numbers are not flax's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import BatchNorm

ENC_FEATURES = (128, 256, 512, 1024)
DEC_FEATURES = (512, 256, 128)
CROP_HW = 64  # inputs smaller than this are used whole


class Conv(nn.Module):
    """A convolution with flax's explicit padding, weight OIHW."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 padding: int, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight, self.bias, self.stride, self.padding)
        return y.contiguous(memory_format=torch.channels_last)


class Deconv(nn.Module):
    """A 4x4 stride-2 transposed convolution that doubles the size,
    weight ``[in, out, kh, kw]``, no bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 4, 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x, self.weight, stride=2, padding=1)
        return y.contiguous(memory_format=torch.channels_last)


class VAE(nn.Module):
    """Conv VAE over ``crop x crop`` inputs, ``crop`` divisible by 16."""

    def __init__(self, z_dim: int = 32, nc: int = 3, crop: int = 32):
        super().__init__()
        if crop % 16 != 0:
            raise ValueError(f"crop must be divisible by 16, got {crop}")
        self.z_dim, self.crop = z_dim, crop
        cin = nc
        for i, f in enumerate(ENC_FEATURES):
            setattr(self, f"enc_conv{i}", Conv(cin, f, 4, 2, 1, bias=False))
            setattr(self, f"enc_bn{i}", BatchNorm(f, torch.float32, False))
            cin = f
        self.start = crop // 16
        flat = ENC_FEATURES[-1] * self.start * self.start
        self.fc_mu = nn.Linear(flat, z_dim)
        self.fc_logvar = nn.Linear(flat, z_dim)
        self.dec_start = crop // 8
        self.dec_dense = nn.Linear(z_dim, 1024 * self.dec_start ** 2)
        cin = 1024
        for i, f in enumerate(DEC_FEATURES):
            setattr(self, f"dec_deconv{i}", Deconv(cin, f))
            setattr(self, f"dec_bn{i}", BatchNorm(f, torch.float32, False))
            cin = f
        self.dec_out = Conv(cin, nc, 1, 1, 0, bias=True)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC ``x`` -> (mu, logvar)."""
        x = x.permute(0, 3, 1, 2)
        for i in range(len(ENC_FEATURES)):
            bn = getattr(self, f"enc_bn{i}")
            x = bn(getattr(self, f"enc_conv{i}")(x), relu=True)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's NHWC order
        return self.fc_mu(x), self.fc_logvar(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """-> NHWC reconstruction."""
        s = self.dec_start
        x = self.dec_dense(z).reshape(-1, s, s, 1024).permute(0, 3, 1, 2)
        for i in range(len(DEC_FEATURES)):
            bn = getattr(self, f"dec_bn{i}")
            x = bn(getattr(self, f"dec_deconv{i}")(x), relu=True)
        return self.dec_out(x).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None):
        """-> (recon, z, mu, logvar); ``z = mu + exp(logvar / 2)·eps``,
        or ``mu`` when ``eps`` is None (the scoring pass)."""
        mu, logvar = self.encode(x)
        z = mu if eps is None else mu + torch.exp(0.5 * logvar) * eps
        return self.decode(z), z, mu, logvar


class Discriminator(nn.Module):
    """Latent-space adversary: z -> 512 -> 512 -> 1, sigmoid."""

    def __init__(self, z_dim: int = 32):
        super().__init__()
        self.Dense_0 = nn.Linear(z_dim, 512)
        self.Dense_1 = nn.Linear(512, 512)
        self.Dense_2 = nn.Linear(512, 1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        z = torch.relu(self.Dense_0(z))
        z = torch.relu(self.Dense_1(z))
        return torch.sigmoid(self.Dense_2(z))


def crop_size_for(image_hw: int) -> int:
    """Inputs of 64 px and more are cropped to 64; smaller ones are used
    whole."""
    return CROP_HW if image_hw >= CROP_HW else image_hw


def crop_window(x: torch.Tensor, crop: int, oh: int, ow: int
                ) -> torch.Tensor:
    """The ``crop x crop`` window at row ``oh``, column ``ow`` of every
    NHWC row (the whole image when it is no larger than ``crop``)."""
    h, w = x.shape[1:3]
    if h <= crop and w <= crop:
        return x
    return x[:, oh:oh + crop, ow:ow + crop, :]


def draw_window(h: int, w: int, crop: int,
                generator: torch.Generator) -> Tuple[int, int]:
    """One window's (row, column) offsets, uniform over the valid range,
    drawn from ``generator`` (a CPU generator, so no device sync); (0,
    0) when the image is no larger than ``crop``."""
    if h <= crop and w <= crop:
        return 0, 0
    oh = int(torch.randint(0, h - crop + 1, (), generator=generator))
    ow = int(torch.randint(0, w - crop + 1, (), generator=generator))
    return oh, ow


@torch.no_grad()
def init_vaal_weights(vae: VAE, disc: Discriminator,
                      generator: torch.Generator) -> None:
    """Fresh weights in place: He-normal (fan-in) kernels for the convs
    and dense layers, LeCun truncated normal (fan-in ``kh·kw·in``, cut
    at two of its standard deviations) for the deconvs, zero biases,
    BatchNorm scale 1, bias 0, statistics (0, 1).  Draws come from
    ``generator`` (a CPU generator) in module order."""
    for mod in list(vae.modules()) + list(disc.modules()):
        if isinstance(mod, Deconv):
            w = mod.weight
            std = (1.0 / (w.shape[0] * w.shape[2] * w.shape[3])) ** 0.5
            std /= 0.87962566103423978  # truncation at +-2 keeps this
            w.copy_(nn.init.trunc_normal_(
                torch.empty(w.shape), 0.0, std, -2.0 * std, 2.0 * std,
                generator=generator))
        elif isinstance(mod, (Conv, nn.Linear)):
            w = mod.weight
            fan_in = w[0].numel()
            w.copy_(torch.empty(w.shape).normal_(
                0.0, (2.0 / fan_in) ** 0.5, generator=generator))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.scale.fill_(1.0)
            mod.bias.fill_(0.0)
            mod.mean.fill_(0.0)
            mod.var.fill_(1.0)
