"""The frozen VGG16 nets of the loss stack.

* :class:`VGG16Features` — the torchvision ``vgg16().features`` stack (13
  3x3 convolutions, ReLU, 2x2 max pools), NHWC at the public functions as
  in the JAX package; upstream reads the ReLU outputs after convolutions 1,
  3, 6 and 9 (torchvision feature indices 3, 8, 15, 22) for the perceptual
  loss, and LPIPS after 1, 3, 6, 9 and 12 (``eval/metrics.LPIPS_CAPTURE``).
  The parameters keep torchvision's layout (``convs.{i}.weight`` ``[out,
  in, 3, 3]``), so a torchvision state dict loads through
  :func:`vgg_features_from_torch`.
* :class:`GazeVGG` — the ETH-XGaze VGG16 gaze estimator of the angular
  loss: the whole feature stack and its last pool, a mean over H and W,
  FC1 and FC2 (64 each, LeakyReLU 0.2) and FC3 (4, tanh x pi/2); upstream's
  ``gaze_network`` checkpoint loads through :func:`gaze_vgg_from_torch`.
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
    convolutions are not run unless ``final`` asks for the stack's output.
    All 13 convolutions are kept, so a torchvision state dict loads
    whole."""

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

    def forward(self, x: torch.Tensor, final: bool = False):
        """``[B, H, W, 3]`` -> the ReLU outputs of the capture convs, NHWC;
        with ``final`` also the whole stack's output after its last max
        pool, NCHW: ``(captures, pooled)``."""
        caps = []
        h = x.permute(0, 3, 1, 2).to(self.dtype)
        for i in range(len(self.convs) if final else max(self.capture, default=-1) + 1):
            if i in VGG16_POOL_BEFORE:
                h = F.max_pool2d(h, 2, 2)
            conv = self.convs[i]
            h = F.relu(F.conv2d(h, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                                padding=1))
            if i in self.capture:
                caps.append(h.permute(0, 2, 3, 1))
        if final:
            return caps, F.max_pool2d(h, 2, 2)
        return caps


class GazeVGG(nn.Module):
    """The ETH-XGaze VGG16 gaze estimator (frozen, in the angular loss):
    ``[B, 224, 224, 3]`` ImageNet-normalised -> ``(gaze [B, 2], head [B,
    2])`` pitch-yaw pairs.  The convolutions compute in ``dtype``, the
    three dense layers in f32 (as the JAX package's, whose ``Dense`` layers
    promote to their f32 parameters)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = VGG16Features(dtype=dtype, capture=())
        self.FC1 = nn.Linear(512, 64)
        self.FC2 = nn.Linear(64, 64)
        self.FC3 = nn.Linear(64, 4)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's default initialisers (truncated normal, variance ``1 /
        fan_in``, zero bias), as :meth:`VGG16Features.reset_parameters`."""
        self.features.reset_parameters(generator)
        with torch.no_grad():
            for fc in (self.FC1, self.FC2, self.FC3):
                std = math.sqrt(1.0 / fc.weight.shape[1]) / 0.87962566103423978
                nn.init.trunc_normal_(fc.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                fc.bias.zero_()

    def forward(self, x: torch.Tensor):
        _, h = self.features(x, final=True)
        h = h.mean(dim=(2, 3)).to(torch.float32)  # the global average pool
        h = F.leaky_relu(self.FC1(h), 0.2)
        h = F.leaky_relu(self.FC2(h), 0.2)
        h = torch.tanh(self.FC3(h)) * (np.pi * 0.5)
        return h[:, :2], h[:, 2:]


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


def gaze_vgg_from_torch(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Upstream's ``gaze_network`` state dict (``vgg16.N.weight`` /
    ``.bias``, the net keeping only the features, and ``FC1..3.weight`` /
    ``.bias``) -> :class:`GazeVGG`'s ``state_dict``."""
    conv_sd = {f"features.{k.split('.', 1)[1]}": v for k, v in sd.items()
               if k.startswith("vgg16.")}
    out = {f"features.{k}": v for k, v in vgg_features_from_torch(conv_sd).items()}
    for fc in ("FC1", "FC2", "FC3"):
        for kind in ("weight", "bias"):
            out[f"{fc}.{kind}"] = torch.as_tensor(np.asarray(sd[f"{fc}.{kind}"], np.float32))
    return out
