"""The BiSeNet face parser, the port of the JAX package's
``preprocess/bisenet.py`` (upstream ``pre_processing/bisenet.py`` with the
ResNet-18 trunk of ``pre_processing/resnet.py``): a context path (the trunk,
attention-refinement modules on the 1/16 and 1/32 features, a global
average) fused with the 1/8 features by a feature-fusion module, then a
19-class head upsampled to the input's size.  Inference only (BatchNorm on
its running statistics, ``eval()``).

The modules carry upstream's names (``cp.resnet.layer1.0.conv1``,
``cp.arm16.conv_atten``, ``ffm.convblk.conv``, ``conv_out.conv_out``, the
auxiliary heads ``conv_out16`` and ``conv_out32``, which the forward does
not run), so upstream's ``79999_iter.pth`` loads with ``load_state_dict``;
a JAX variable tree loads through ``utils/transplant.bisenet_params_from_jax``.
The context path's upsamples are nearest-neighbour and the logits'
bilinear with ``align_corners=True``, both with the JAX package's index
arithmetic (``ops/image.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gazenerf_tpu_torch.ops.image import resize_bilinear_align_corners, resize_nearest


class ConvBNReLU(nn.Module):
    def __init__(self, in_chan: int, out_chan: int, ks: int = 3, stride: int = 1,
                 padding: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_chan, out_chan, ks, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(out_chan)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    """ResNet-18's basic block; ``downsample`` (1x1 conv + BatchNorm) where
    the width or stride changes."""

    def __init__(self, in_chan: int, out_chan: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_chan, out_chan, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_chan)
        self.conv2 = nn.Conv2d(out_chan, out_chan, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_chan)
        self.downsample = None
        if in_chan != out_chan or stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(in_chan, out_chan, 1, stride, bias=False),
                                            nn.BatchNorm2d(out_chan))

    def forward(self, x):
        residual = F.relu(self.bn1(self.conv1(x)))
        residual = self.bn2(self.conv2(residual))
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(shortcut + residual)


def _layer(in_chan: int, out_chan: int, stride: int) -> nn.Sequential:
    return nn.Sequential(BasicBlock(in_chan, out_chan, stride), BasicBlock(out_chan, out_chan))


class Resnet18(nn.Module):
    """The trunk: ``(feat8, feat16, feat32)`` at 1/8, 1/16, 1/32."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.layer1 = _layer(64, 64, 1)
        self.layer2 = _layer(64, 128, 2)
        self.layer3 = _layer(128, 256, 2)
        self.layer4 = _layer(256, 512, 2)

    def forward(self, x):
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        feat8 = self.layer2(self.layer1(x))
        feat16 = self.layer3(feat8)
        return feat8, feat16, self.layer4(feat16)


class AttentionRefinementModule(nn.Module):
    def __init__(self, in_chan: int, out_chan: int):
        super().__init__()
        self.conv = ConvBNReLU(in_chan, out_chan)
        self.conv_atten = nn.Conv2d(out_chan, out_chan, 1, bias=False)
        self.bn_atten = nn.BatchNorm2d(out_chan)

    def forward(self, x):
        feat = self.conv(x)
        atten = self.bn_atten(self.conv_atten(feat.mean((2, 3), keepdim=True)))
        return feat * torch.sigmoid(atten)


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = Resnet18()
        self.arm16 = AttentionRefinementModule(256, 128)
        self.arm32 = AttentionRefinementModule(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.conv_head16 = ConvBNReLU(128, 128)
        self.conv_avg = ConvBNReLU(512, 128, ks=1, padding=0)

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(feat32.mean((2, 3), keepdim=True))
        f32 = self.arm32(feat32) + avg
        f32_up = self.conv_head32(resize_nearest(f32, feat16.shape[2:]))
        f16 = self.arm16(feat16) + f32_up
        f16_up = self.conv_head16(resize_nearest(f16, feat8.shape[2:]))
        return feat8, f16_up


class FeatureFusionModule(nn.Module):
    def __init__(self, in_chan: int, out_chan: int):
        super().__init__()
        self.convblk = ConvBNReLU(in_chan, out_chan, ks=1, padding=0)
        self.conv1 = nn.Conv2d(out_chan, out_chan // 4, 1, bias=False)
        self.conv2 = nn.Conv2d(out_chan // 4, out_chan, 1, bias=False)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = torch.sigmoid(self.conv2(F.relu(self.conv1(feat.mean((2, 3), keepdim=True)))))
        return feat + feat * atten


class BiSeNetOutput(nn.Module):
    def __init__(self, in_chan: int, mid_chan: int, n_classes: int):
        super().__init__()
        self.conv = ConvBNReLU(in_chan, mid_chan)
        self.conv_out = nn.Conv2d(mid_chan, n_classes, 1, bias=False)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    """``[B, 3, H, W]`` -> ``[B, n_classes, H, W]`` logits of the main head
    (upstream's ``out[0]``, what mask generation reads)."""

    def __init__(self, n_classes: int = 19):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusionModule(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes)
        self.conv_out16 = BiSeNetOutput(128, 64, n_classes)
        self.conv_out32 = BiSeNetOutput(128, 64, n_classes)

    def forward(self, x):
        H, W = x.shape[2:]
        feat8, f16_up = self.cp(x)
        out = self.conv_out(self.ffm(feat8, f16_up))
        return resize_bilinear_align_corners(out, (H, W))
