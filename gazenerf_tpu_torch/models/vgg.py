"""The frozen VGG16 feature stack of the perceptual loss.

The torchvision ``vgg16().features`` stack (13 3x3 convolutions, ReLU, four
2x2 max pools), NHWC at the public functions as in the JAX package; upstream
reads the ReLU outputs after convolutions 1, 3, 6 and 9 (torchvision
feature indices 3, 8, 15, 22) for the perceptual loss, and LPIPS after 1,
3, 6, 9 and 12 (``eval/metrics.LPIPS_CAPTURE``).  The parameters keep torchvision's layout
(``convs.{i}.weight`` ``[out, in, 3, 3]``), so a torchvision state dict
loads through :func:`vgg_features_from_torch`.  The gaze estimator
(``GazeVGG``) of the angular loss is not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# torchvision vgg16 features layout: conv indices and channel widths
VGG16_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
VGG16_WIDTHS = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
# a max pool comes right before the convs at these positions
VGG16_POOL_BEFORE = {2, 4, 7, 10}
# perceptual-loss capture points: ReLU outputs of convs 1, 3, 6, 9
PERCEPTUAL_CAPTURE = (1, 3, 6, 9)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class VGG16Features(nn.Module):
    """The VGG16 feature stack up to its last capture point, computing in
    ``dtype``.  ``capture``: positions in the conv list whose ReLU outputs
    the forward returns (the perceptual loss's by default); later
    convolutions are not run.  All 13 convolutions are kept, so a
    torchvision state dict loads whole."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 capture: Sequence[int] = PERCEPTUAL_CAPTURE):
        super().__init__()
        self.dtype = dtype
        self.capture = tuple(capture)
        widths = [3] + VGG16_WIDTHS
        self.convs = nn.ModuleList(
            [nn.Conv2d(widths[i], widths[i + 1], 3, padding=1) for i in range(13)]
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's default initialiser (a normal truncated at two standard
        deviations, variance ``1 / fan_in``), zero bias: random weights for
        tests and smoke runs."""
        with torch.no_grad():
            for conv in self.convs:
                fan_in = conv.weight.shape[1] * 9
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``[B, H, W, 3]`` -> the ReLU outputs of the capture convs, NHWC."""
        caps = []
        h = x.permute(0, 3, 1, 2).to(self.dtype)
        for i in range(max(self.capture, default=-1) + 1):
            if i in VGG16_POOL_BEFORE:
                h = F.max_pool2d(h, 2, 2)
            conv = self.convs[i]
            h = F.relu(F.conv2d(h, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                                padding=1))
            if i in self.capture:
                caps.append(h.permute(0, 2, 3, 1))
        return caps


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 3]`` in [0, 1] -> ImageNet-normalised."""
    mean = torch.as_tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def vgg_features_from_torch(sd: Mapping[str, np.ndarray], prefix: str = "") -> Dict[str, torch.Tensor]:
    """torchvision ``features.N.weight`` / ``.bias`` -> :class:`VGG16Features`'
    ``state_dict``."""
    out = {}
    for i, tidx in enumerate(VGG16_CONV_IDX):
        for kind in ("weight", "bias"):
            v = sd[f"{prefix}features.{tidx}.{kind}"]
            out[f"convs.{i}.{kind}"] = torch.as_tensor(np.asarray(v, np.float32))
    return out
