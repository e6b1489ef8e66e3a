"""The PatchGAN discriminator of the GAN loss.

Port of the JAX package's ``models/discriminator.py`` (upstream
``models/discriminator.py``): five 6x6 convolutions with padding 1 and
strides 2, 2, 2, 1, 1, widths 64, 128, 256, 512, 1, biases on the first and
the last only, batch normalisation after the middle three, LeakyReLU 0.2;
``[B, 224, 224, 3]`` NHWC in, ``[B, 20, 20, 1]`` patch logits out.

The batch normalisation is flax's ``nn.BatchNorm`` (momentum 0.9, epsilon
1e-5), not ``torch.nn.BatchNorm2d``: in training it normalises by the
biased batch variance ``E[x^2] - E[x]^2`` and moves the running variance
toward that biased value (``0.9 * old + 0.1 * new``), where torch's moves
it toward the unbiased one.  The running statistics are buffers
(``norm{i}.running_mean`` / ``.running_var``) that a training forward
updates in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

MOMENTUM = 0.9  # flax's: the weight of the old running value
EPS = 1e-5


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of an NCHW tensor: the batch
    statistics in training (``E[x^2] - E[x]^2``, clamped at 0, as flax's
    fast variance), the running ones otherwise."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(MOMENTUM).add_((1.0 - MOMENTUM) * mean)
                self.running_var.mul_(MOMENTUM).add_((1.0 - MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + EPS) * self.weight
        return (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]


class PatchGAN(nn.Module):
    """``forward(x, train)``: ``x`` ``[B, H, W, 3]`` NHWC -> patch logits
    ``[B, H', W', 1]``, computed in the parameters' dtype (f32); ``train``
    normalises by the batch's statistics and updates the running ones, else
    it reads the running ones."""

    def __init__(self, ndf: int = 64):
        super().__init__()

        def conv(cin, cout, stride, bias):
            return nn.Conv2d(cin, cout, 6, stride=stride, padding=1, bias=bias)

        self.conv1 = conv(3, ndf, 2, True)
        self.conv2 = conv(ndf, ndf * 2, 2, False)
        self.conv3 = conv(ndf * 2, ndf * 4, 2, False)
        self.conv4 = conv(ndf * 4, ndf * 8, 1, False)
        self.conv5 = conv(ndf * 8, 1, 1, True)
        self.norm1 = BatchNorm(ndf * 2)
        self.norm2 = BatchNorm(ndf * 4)
        self.norm3 = BatchNorm(ndf * 8)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's default initialisers: convolution kernels from a normal
        truncated at two standard deviations with variance ``1 / fan_in``,
        zero biases, unit scales; running mean 0, running variance 1."""
        with torch.no_grad():
            for conv in (self.conv1, self.conv2, self.conv3, self.conv4, self.conv5):
                fan_in = conv.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if conv.bias is not None:
                    conv.bias.zero_()
            for bn in (self.norm1, self.norm2, self.norm3):
                bn.weight.fill_(1.0)
                bn.bias.zero_()
                bn.running_mean.zero_()
                bn.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2).to(self.conv1.weight.dtype)
        h = F.leaky_relu(self.conv1(h), 0.2)
        h = F.leaky_relu(self.norm1(self.conv2(h), train), 0.2)
        h = F.leaky_relu(self.norm2(self.conv3(h), train), 0.2)
        h = F.leaky_relu(self.norm3(self.conv4(h), train), 0.2)
        return self.conv5(h).permute(0, 2, 3, 1)
