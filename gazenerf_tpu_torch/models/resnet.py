"""The frozen gaze estimator of the evaluation protocols: a ResNet-50 trunk
and ``Linear(2048, 4)`` giving (gaze, head) pitch-yaw pairs.

The port's counterpart of the JAX package's ``models/resnet.py`` (upstream
``gaze_estimation/xgaze_baseline_resnet.py``, the ETH-XGaze baseline).  The
module carries torchvision's names (``gaze_network.layer1.0.conv1.weight``,
``gaze_fc.0.weight``), so an upstream state dict loads strictly through
:func:`gaze_resnet_from_torch`.  BatchNorm runs in eval mode (running
statistics, eps 1e-5).  Its convolutions are PyTorch's (cuDNN on the card),
as the JAX package leaves them to XLA: no Pallas kernel is involved.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

RESNET50_STAGES = [(64, 3), (128, 4), (256, 6), (512, 3)]


class Bottleneck(nn.Module):
    """torchvision's bottleneck block: 1x1, 3x3 (the stride), 1x1 x4, with a
    projection of the residual in the first block of a stage."""

    def __init__(self, in_ch: int, width: int, stride: int, project: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width, eps=1e-5)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width, eps=1e-5)
        self.conv3 = nn.Conv2d(width, 4 * width, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(4 * width, eps=1e-5)
        self.downsample = (
            nn.Sequential(nn.Conv2d(in_ch, 4 * width, 1, stride=stride, bias=False),
                          nn.BatchNorm2d(4 * width, eps=1e-5))
            if project else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + res)


class ResNet50(nn.Module):
    """The trunk: stem, four stages, global average pool -> ``[B, 2048]``."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = 64
        for si, (width, blocks) in enumerate(RESNET50_STAGES):
            stage = []
            for bi in range(blocks):
                stage.append(Bottleneck(in_ch, width, 2 if si > 0 and bi == 0 else 1, bi == 0))
                in_ch = 4 * width
            setattr(self, f"layer{si + 1}", nn.Sequential(*stage))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for si in range(len(RESNET50_STAGES)):
            x = getattr(self, f"layer{si + 1}")(x)
        return x.mean(dim=(2, 3))


class GazeResNet(nn.Module):
    """ResNet-50 trunk + ``gaze_fc`` (2048 -> 4): ImageNet-normalized
    ``[B, H, W, 3]`` (NHWC, as the JAX package) -> ``(gaze [B, 2], head [B,
    2])`` pitch-yaw.  Built in eval mode."""

    def __init__(self):
        super().__init__()
        self.gaze_network = ResNet50()
        self.gaze_fc = nn.Sequential(nn.Linear(2048, 4))
        self.eval()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self.gaze_fc(self.gaze_network(x.permute(0, 3, 1, 2)))
        return out[:, :2], out[:, 2:]


def gaze_resnet_from_torch(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """An upstream gaze-network state dict (``gaze_network.*``,
    ``gaze_fc.0.*``; a ``module.`` prefix dropped) -> :class:`GazeResNet`'s
    ``state_dict``: every key the module has, the trunk's unused ``fc``
    left out.  Raises ``KeyError`` naming a missing key."""
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    out = {}
    for k, ref in GazeResNet().state_dict().items():
        if k not in sd:
            raise KeyError(f"gaze estimator state dict lacks {k!r}")
        out[k] = torch.as_tensor(np.asarray(sd[k])).to(ref.dtype)
    return out
