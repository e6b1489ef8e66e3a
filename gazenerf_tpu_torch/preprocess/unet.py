"""The U-Net eye segmenter, the port of the JAX package's
``preprocess/unet.py`` (upstream ``pre_processing/unet.py`` and the blocks
of ``unet_utils.py``): four levels with ``feature_scale=4`` (filters 16, 32,
64, 128, 256), double 3x3 conv + BatchNorm + ReLU blocks, 2x2-stride
transposed-conv upsampling concatenated after the skip, a 19-class 1x1
head.  Inference only (BatchNorm on its running statistics, ``eval()``).

The modules carry upstream's names and layouts, so upstream's state dict
loads with ``load_state_dict``; a JAX variable tree loads through
``utils/transplant.unet_params_from_jax``.
"""

from __future__ import annotations

import torch
from torch import nn


class UNetConv2(nn.Module):
    """conv 3x3 + BatchNorm + ReLU, twice (``conv1``, ``conv2``:
    ``Sequential(Conv2d, BatchNorm2d, ReLU)``)."""

    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(in_size, out_size, 3, 1, 1),
                                   nn.BatchNorm2d(out_size), nn.ReLU())
        self.conv2 = nn.Sequential(nn.Conv2d(out_size, out_size, 3, 1, 1),
                                   nn.BatchNorm2d(out_size), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class UNetUp(nn.Module):
    """2x2-stride transposed conv, the skip concatenated before it, then a
    double conv."""

    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(in_size, out_size, 2, stride=2)
        self.conv = UNetConv2(in_size, out_size)

    def forward(self, skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        up = self.up(x)
        if up.shape[2:] != skip.shape[2:]:  # upstream pads; even inputs never need it
            raise ValueError(f"U-Net input sides must divide by 16: {tuple(up.shape)} "
                             f"against {tuple(skip.shape)}")
        return self.conv(torch.cat([skip, up], dim=1))


class UNet(nn.Module):
    """Upstream's ``unet``, ``[B, 3, H, W]`` -> ``[B, n_classes, H, W]``
    logits."""

    def __init__(self, n_classes: int = 19, feature_scale: int = 4, in_channels: int = 3):
        super().__init__()
        f = [int(c / feature_scale) for c in (64, 128, 256, 512, 1024)]
        self.conv1 = UNetConv2(in_channels, f[0])
        self.conv2 = UNetConv2(f[0], f[1])
        self.conv3 = UNetConv2(f[1], f[2])
        self.conv4 = UNetConv2(f[2], f[3])
        self.maxpool = nn.MaxPool2d(2)
        self.center = UNetConv2(f[3], f[4])
        self.up_concat4 = UNetUp(f[4], f[3])
        self.up_concat3 = UNetUp(f[3], f[2])
        self.up_concat2 = UNetUp(f[2], f[1])
        self.up_concat1 = UNetUp(f[1], f[0])
        self.final = nn.Conv2d(f[0], n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1 = self.conv1(x)
        c2 = self.conv2(self.maxpool(c1))
        c3 = self.conv3(self.maxpool(c2))
        c4 = self.conv4(self.maxpool(c3))
        center = self.center(self.maxpool(c4))
        u4 = self.up_concat4(c4, center)
        u3 = self.up_concat3(c3, u4)
        u2 = self.up_concat2(c2, u3)
        u1 = self.up_concat1(c1, u2)
        return self.final(u1)
