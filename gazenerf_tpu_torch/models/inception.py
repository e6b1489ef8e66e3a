"""InceptionV3, the FID variant: the feature extractor of exact FID.

The port's counterpart of the JAX package's ``models/inception.py``.
Upstream computes FID with ``piq.FID().compute_feats``, whose extractor is
pytorch-fid's InceptionV3 (the TF-slim weights).  That variant differs from
stock torchvision ``inception_v3`` in two places, both kept here:

* every average pool inside a block leaves the zero padding out of its
  divisor (``count_include_pad=False``, pytorch-fid's ``FIDInceptionA/C/E_1``);
* the last block's pool branch (``Mixed_7c``) is a max pool (pytorch-fid's
  ``FIDInceptionE_2``).

The modules carry torchvision's names (``Mixed_5b.branch5x5_1.conv.weight``),
so a pytorch-fid or torchvision state dict loads strictly once the heads FID
does not read are dropped (:func:`fid_state_dict`).  BatchNorm runs in eval
mode (eps 1e-3).  The convolutions are PyTorch's (cuDNN on the card), as the
JAX package leaves them to XLA: no Pallas kernel is involved.

:func:`make_fid_features_fn` is the pool3 pipeline: the resize to 299x299,
[0, 1] -> [-1, 1], the trunk, the spatial mean.  The resize antialiases, as
the JAX package's ``jax.image.resize(..., "bilinear")`` does by default;
pytorch-fid's does not, and the port follows the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from gazenerf_tpu_torch.models.gaze_nerf import resolve_device

FID_SIZE = 299


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool, the padding left out of the divisor."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """``pool_mode``: ``"avg"`` (``Mixed_7b``, the padding left out) or
    ``"max"`` (``Mixed_7c``)."""

    def __init__(self, cin: int, pool_mode: str):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool_mode == "max":
            pooled = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            pooled = _avg_pool3(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], 1)


class InceptionV3FID(nn.Module):
    """The trunk through ``Mixed_7c``: ``[B, 3, H, W]`` in [-1, 1] -> the
    ``[B, 2048, H', W']`` feature map.  Built in eval mode."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return x


def fid_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A pytorch-fid or torchvision InceptionV3 state dict without the heads
    FID does not read (``fc.*``, ``AuxLogits.*``), for a strict load into
    :class:`InceptionV3FID`."""
    return {k: v for k, v in sd.items() if not k.startswith(("fc.", "AuxLogits."))}


def resize_antialiased(x: torch.Tensor, size: int) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[B, C, size, size]`` bilinear with half-pixel
    centres, antialiased when it shrinks: ``jax.image.resize(...,
    "bilinear")`` with its default ``antialias=True``."""
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=True)


def make_fid_features_fn(state_dict: Mapping[str, torch.Tensor], device=None,
                         resize: bool = True) -> Callable:
    """``feats(imgs [B, H, W, 3] in [0, 1]) -> [B, 2048]`` f32 pool3
    features on ``device`` (the card unless given): the resize to 299
    (:func:`resize_antialiased`; ``resize=False`` takes the images as they
    are), scaled to [-1, 1], the trunk, the spatial mean.  ``state_dict``:
    an upstream InceptionV3's (see :func:`fid_state_dict`)."""
    device = resolve_device(device)
    net = InceptionV3FID()
    net.load_state_dict(fid_state_dict(state_dict), strict=True)
    net.to(device).requires_grad_(False)

    @torch.no_grad()
    def feats(imgs) -> torch.Tensor:
        x = torch.as_tensor(imgs).to(device=device, dtype=torch.float32).permute(0, 3, 1, 2)
        if resize:
            x = resize_antialiased(x, FID_SIZE)
        return net(x * 2.0 - 1.0).mean(dim=(2, 3))

    return feats

