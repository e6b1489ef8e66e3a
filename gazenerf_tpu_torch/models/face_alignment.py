"""PFLD, the 106-point landmark net of the identity pipeline, and its box
crop.

The port's counterpart of the JAX package's ``models/face_alignment.py``
(upstream FaceX-Zoo ``mobilev3_pfld.py`` ``PFLDInference`` and
``FaceAlignModelHandler.py``): a MobileNetV3-style backbone (bottlenecks
with squeeze-excite and h-swish), a three-scale feature concat and a
212-wide landmark regression.  The training-only auxiliary pose net is not
ported, as in the JAX package.  The modules carry upstream's names
(``block3_3.conv.5.fc.0.weight``), so a FaceX-Zoo state dict loads
strictly.  BatchNorm runs in eval mode.

:class:`PFLDAligner` is the handler's crop without OpenCV: the zero border
is a pad, and the resize to 112 is
``preprocess.normalize.resize_linear_u8`` (``cv2.resize``'s uint8
arithmetic).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gazenerf_tpu_torch.models.gaze_nerf import resolve_device
from gazenerf_tpu_torch.preprocess.normalize import resize_linear_u8


class HSwish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * F.relu6(x + 3.0) / 6.0


class HSigmoid(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu6(x + 3.0) / 6.0


class SEModule(nn.Module):
    """Squeeze-excite with an h-sigmoid gate."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channels, channels // reduction, bias=False), nn.ReLU(),
                                nn.Linear(channels // reduction, channels, bias=False), HSigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class MobileBottleneck(nn.Module):
    """pw-expand, dw, (SE), pw-project; the residual where the shapes match.
    The SE sits before the second activation, as in upstream's
    ``Sequential``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, exp: int,
                 se: bool = False, nl: str = "RE"):
        super().__init__()
        act = nn.ReLU if nl == "RE" else HSwish
        self.use_res = stride == 1 and cin == cout
        self.conv = nn.Sequential(
            nn.Conv2d(cin, exp, 1, bias=False), nn.BatchNorm2d(exp), act(),
            nn.Conv2d(exp, exp, kernel, stride, (kernel - 1) // 2, groups=exp, bias=False),
            nn.BatchNorm2d(exp), SEModule(exp) if se else nn.Identity(), act(),
            nn.Conv2d(exp, cout, 1, bias=False), nn.BatchNorm2d(cout),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.use_res else y


# (name, in, out, kernel, stride, expansion, SE, activation) in upstream's order
_BLOCKS = (
    ("conv_bn2", 16, 16, 3, 1, 16, False, "RE"),
    ("conv3_1", 16, 24, 3, 2, 64, False, "RE"),
    ("block3_2", 24, 24, 3, 1, 72, False, "RE"),
    ("block3_3", 24, 40, 5, 2, 72, True, "RE"),
    ("block3_4", 40, 40, 5, 1, 120, True, "RE"),
    ("block3_5", 40, 40, 5, 1, 120, True, "RE"),
    ("conv4_1", 40, 80, 3, 2, 240, False, "RE"),
    ("conv5_1", 80, 80, 3, 1, 200, False, "HS"),
    ("block5_2", 80, 112, 3, 1, 480, True, "HS"),
    ("block5_3", 112, 112, 3, 1, 672, True, "HS"),
    ("block5_4", 112, 160, 3, 1, 672, True, "HS"),
    ("conv6_1", 160, 16, 3, 1, 320, False, "HS"),
)


class PFLD(nn.Module):
    """``[B, 3, 112, 112]`` in [0, 1] -> ``[B, 212]``: 106 (x, y) landmarks
    relative to the crop.  Built in eval mode."""

    def __init__(self, n_landmarks: int = 106):
        super().__init__()
        self.conv_bn1 = nn.Sequential(nn.Conv2d(3, 16, 3, 1, 1, bias=False), nn.BatchNorm2d(16),
                                      HSwish())
        for name, *args in _BLOCKS:
            setattr(self, name, MobileBottleneck(*args))
        self.conv7 = nn.Conv2d(16, 32, 3, 2, 1)
        self.conv8 = nn.Conv2d(32, 128, 7, 1, 0)
        self.fc = nn.Linear(16 + 32 + 128, n_landmarks * 2)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_bn1(x)
        for name, *_ in _BLOCKS:
            x = getattr(self, name)(x)
        x7 = self.conv7(x)
        x8 = self.conv8(x7)
        return self.fc(torch.cat([x.mean(dim=(2, 3)), x7.mean(dim=(2, 3)),
                                  x8.reshape(x8.shape[0], -1)], 1))


class PFLDAligner:
    """The handler's box crop and PFLD: a square of 1.2 times the box's
    longer side around its centre, zero-padded where it leaves the image,
    resized to 112 as ``cv2.resize`` does on uint8, and the landmarks mapped
    back to image coordinates.  ``state_dict``: a FaceX-Zoo PFLD's; without
    one the aligner is not :attr:`available`."""

    img_size = 112

    def __init__(self, state_dict: Optional[Mapping[str, torch.Tensor]] = None, device=None):
        self.net = None
        if state_dict is not None:
            self.device = resolve_device(device)
            self.net = PFLD()
            self.net.load_state_dict(state_dict, strict=True)
            self.net.to(self.device).requires_grad_(False)

    @property
    def available(self) -> bool:
        return self.net is not None

    def crop(self, image, det):
        """``image`` ``[H, W, 3]`` uint8, ``det`` (x1, y1, x2, y2, ...) ->
        (the ``[112, 112, 3]`` uint8 crop on the aligner's device, its
        top-left corner ``xy`` and side ``boxsize`` in the image).  Raises
        ``ValueError`` where the square misses the image."""
        xy = np.array([det[0], det[1]])
        zz = np.array([det[2], det[3]])
        wh = zz - xy + 1
        center = (xy + wh / 2).astype(np.int32)
        boxsize = int(np.max(wh) * 1.2)
        xy = center - boxsize // 2
        x1, y1 = xy
        x2, y2 = xy + boxsize
        h, w = image.shape[:2]
        dx, dy = max(0, -x1), max(0, -y1)
        x1, y1 = max(0, x1), max(0, y1)
        edx, edy = max(0, x2 - w), max(0, y2 - h)
        x2, y2 = min(w, x2), min(h, y2)
        if x2 <= x1 or y2 <= y1:
            raise ValueError(f"the crop of box {np.asarray(det[:4]).tolist()} misses the "
                             f"{h}x{w} image")
        crop = torch.as_tensor(image).to(self.device)[int(y1):int(y2), int(x1):int(x2)]
        if dx > 0 or dy > 0 or edx > 0 or edy > 0:
            crop = F.pad(crop, (0, 0, int(dx), int(edx), int(dy), int(edy)))
        return resize_linear_u8(crop, (self.img_size, self.img_size)), xy, boxsize

    @torch.no_grad()
    def __call__(self, image, det) -> np.ndarray:
        """``image`` ``[H, W, 3]`` uint8, ``det`` a detection -> ``[106, 2]``
        landmarks in image coordinates."""
        if not self.available:
            raise ValueError("PFLDAligner has no weights")
        crop, xy, boxsize = self.crop(image, det)
        inp = (crop.to(torch.float32) / 255.0).permute(2, 0, 1)[None]
        lm = self.net(inp).cpu().numpy().reshape(-1, 2)
        return lm * boxsize + xy
