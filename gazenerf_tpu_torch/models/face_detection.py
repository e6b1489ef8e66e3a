"""RetinaFace, the face detector of the identity pipeline, with its anchor
decoding and NMS.

The port's counterpart of the JAX package's ``models/face_detection.py``
(upstream FaceX-Zoo ``retinaface_def.py`` and ``FaceDetModelHandler.py``):
a MobileNetV1 (x0.25) backbone, a three-level FPN, SSH context modules and
1x1 class, box and landmark heads over anchor grids.  The modules carry
upstream's names (``body.stage1.0.0.weight``, ``fpn.merge1.1.running_mean``,
``ClassHead.0.conv1x1.bias``), so a FaceX-Zoo state dict loads strictly.
BatchNorm runs in eval mode.  The anchors, the box decoding and the greedy
NMS are the handler's, in numpy on the host, as in the JAX package (small
work whose shapes depend on the data); the net runs where its weights lie.
"""

from __future__ import annotations

import math
from itertools import product
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from gazenerf_tpu_torch.models.gaze_nerf import resolve_device

# the detector's configuration (upstream face_detection_1.0/model_meta.json)
DET_CFG = {
    "min_sizes": [[16, 32], [64, 128], [256, 512]],
    "steps": [8, 16, 32],
    "variance": [0.1, 0.2],
    "confidence_threshold": 0.7,
    "nms_threshold": 0.2,
}
# the BGR means the handler subtracts from the image as given
BGR_MEANS = (104.0, 117.0, 123.0)


class ConvBN(nn.Sequential):
    """conv (no bias) + BatchNorm + leaky ReLU of slope ``leaky`` (none with
    ``relu=False``); ``same`` padding."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 leaky: float = 0.0, relu: bool = True):
        layers = [nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, bias=False),
                  nn.BatchNorm2d(cout)]
        if relu:
            layers.append(nn.LeakyReLU(leaky))
        super().__init__(*layers)


class ConvDW(nn.Sequential):
    """Depthwise 3x3 and pointwise 1x1, each with BatchNorm and leaky ReLU
    (slope 0.1)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__(
            nn.Conv2d(cin, cin, 3, stride, 1, groups=cin, bias=False), nn.BatchNorm2d(cin),
            nn.LeakyReLU(0.1),
            nn.Conv2d(cin, cout, 1, bias=False), nn.BatchNorm2d(cout), nn.LeakyReLU(0.1),
        )


class MobileNetV1(nn.Module):
    """The x0.25 backbone; returns its three stages' features (64, 128 and
    256 channels at strides 8, 16 and 32)."""

    def __init__(self):
        super().__init__()
        self.stage1 = nn.Sequential(
            ConvBN(3, 8, 3, 2, leaky=0.1), ConvDW(8, 16), ConvDW(16, 32, 2), ConvDW(32, 32),
            ConvDW(32, 64, 2), ConvDW(64, 64))
        self.stage2 = nn.Sequential(ConvDW(64, 128, 2), *[ConvDW(128, 128) for _ in range(5)])
        self.stage3 = nn.Sequential(ConvDW(128, 256, 2), ConvDW(256, 256))

    def forward(self, x: torch.Tensor):
        s1 = self.stage1(x)
        s2 = self.stage2(s1)
        return s1, s2, self.stage3(s2)


class SSH(nn.Module):
    """The SSH context module: 3x3, 5x5 and 7x7 receptive fields from
    stacked 3x3 convolutions, concatenated, ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        leaky = 0.1 if cout <= 64 else 0.0
        self.conv3X3 = ConvBN(cin, cout // 2, relu=False)
        self.conv5X5_1 = ConvBN(cin, cout // 4, leaky=leaky)
        self.conv5X5_2 = ConvBN(cout // 4, cout // 4, relu=False)
        self.conv7X7_2 = ConvBN(cout // 4, cout // 4, leaky=leaky)
        self.conv7x7_3 = ConvBN(cout // 4, cout // 4, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c5_1 = self.conv5X5_1(x)
        c7 = self.conv7x7_3(self.conv7X7_2(c5_1))
        return torch.relu(torch.cat([self.conv3X3(x), self.conv5X5_2(c5_1), c7], 1))


def up_nearest(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour upsampling of ``[B, C, h, w]`` to ``hw`` by the
    integer indices ``i * h // H`` (the JAX package's gather; a float scale
    can pick another row where the sizes do not divide)."""
    h, w = x.shape[-2:]
    ry = torch.clamp(torch.arange(hw[0], device=x.device) * h // hw[0], max=h - 1)
    rx = torch.clamp(torch.arange(hw[1], device=x.device) * w // hw[1], max=w - 1)
    return x.index_select(2, ry).index_select(3, rx)


class FPN(nn.Module):
    """Three-level FPN with a nearest-neighbour top-down merge."""

    def __init__(self, in_channels: Sequence[int], cout: int):
        super().__init__()
        leaky = 0.1 if cout <= 64 else 0.0
        self.output1 = ConvBN(in_channels[0], cout, 1, leaky=leaky)
        self.output2 = ConvBN(in_channels[1], cout, 1, leaky=leaky)
        self.output3 = ConvBN(in_channels[2], cout, 1, leaky=leaky)
        self.merge1 = ConvBN(cout, cout, leaky=leaky)
        self.merge2 = ConvBN(cout, cout, leaky=leaky)

    def forward(self, feats):
        o1, o2, o3 = self.output1(feats[0]), self.output2(feats[1]), self.output3(feats[2])
        o2 = self.merge2(o2 + up_nearest(o3, o2.shape[-2:]))
        o1 = self.merge1(o1 + up_nearest(o2, o1.shape[-2:]))
        return [o1, o2, o3]


class Head(nn.Module):
    """A 1x1 anchor head: ``[B, C, h, w]`` -> ``[B, h * w * anchors, ch]`` in
    the (row, column, anchor) order of upstream's ``permute(0, 2, 3, 1)``."""

    def __init__(self, cin: int, anchors: int, ch: int):
        super().__init__()
        self.ch = ch
        self.conv1x1 = nn.Conv2d(cin, anchors * ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv1x1(x).permute(0, 2, 3, 1).reshape(x.shape[0], -1, self.ch)


class RetinaFace(nn.Module):
    """Backbone, FPN, SSH and the anchor heads: ``[B, 3, H, W]`` (BGR less
    :data:`BGR_MEANS`) -> ``(boxes [B, N, 4], scores [B, N, 2] softmaxed,
    landmarks [B, N, 10])``.  Built in eval mode."""

    def __init__(self, in_channel: int = 32, out_channel: int = 64, num_anchors: int = 2):
        super().__init__()
        self.body = MobileNetV1()
        self.fpn = FPN([in_channel * 2, in_channel * 4, in_channel * 8], out_channel)
        self.ssh1 = SSH(out_channel, out_channel)
        self.ssh2 = SSH(out_channel, out_channel)
        self.ssh3 = SSH(out_channel, out_channel)
        for name, ch in (("ClassHead", 2), ("BboxHead", 4), ("LandmarkHead", 10)):
            setattr(self, name, nn.ModuleList(
                [Head(out_channel, num_anchors, ch) for _ in range(3)]))
        self.eval()

    def forward(self, x: torch.Tensor):
        fpn = self.fpn(self.body(x))
        feats = [self.ssh1(fpn[0]), self.ssh2(fpn[1]), self.ssh3(fpn[2])]

        def heads(name):
            return torch.cat([h(f) for h, f in zip(getattr(self, name), feats)], 1)

        return heads("BboxHead"), torch.softmax(heads("ClassHead"), -1), heads("LandmarkHead")


def prior_boxes(image_size: Tuple[int, int],
                min_sizes: Sequence[Sequence[int]] = DET_CFG["min_sizes"],
                steps: Sequence[int] = DET_CFG["steps"]) -> np.ndarray:
    """Anchor centres and sizes in normalized coordinates, ``[N, 4]``, in
    the handler's order."""
    anchors: List[float] = []
    fmaps = [(math.ceil(image_size[0] / s), math.ceil(image_size[1] / s)) for s in steps]
    for k, f in enumerate(fmaps):
        for i, j in product(range(f[0]), range(f[1])):
            for ms in min_sizes[k]:
                anchors += [(j + 0.5) * steps[k] / image_size[1],
                            (i + 0.5) * steps[k] / image_size[0],
                            ms / image_size[1], ms / image_size[0]]
    return np.asarray(anchors, np.float32).reshape(-1, 4)


def decode_boxes(loc: np.ndarray, priors: np.ndarray,
                 variances=DET_CFG["variance"]) -> np.ndarray:
    """Undo the SSD offset encoding: ``[N, 4]`` offsets -> (x1, y1, x2, y2)
    in normalized coordinates."""
    xy = priors[:, :2] + loc[:, :2] * variances[0] * priors[:, 2:]
    wh = priors[:, 2:] * np.exp(loc[:, 2:] * variances[1])
    x1y1 = xy - wh / 2
    return np.concatenate([x1y1, x1y1 + wh], axis=1)


def nms(dets: np.ndarray, thresh: float) -> List[int]:
    """Greedy IoU NMS over ``[N, 5]`` (x1, y1, x2, y2, score) rows: the
    indices kept, best first."""
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep: List[int] = []
    while order.size > 0:
        i = int(order[0])
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1 + 1) * np.maximum(0.0, yy2 - yy1 + 1)
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][ovr <= thresh]
    return keep


class RetinaFaceDetector:
    """Preprocess, net, decode, threshold, NMS.  ``img``: ``[H, W, 3]``
    uint8 (a tensor on any device, or an array) in the channel order given
    (upstream's handler takes cv2's BGR).  Returns ``[N, 5]`` f32 (x1, y1,
    x2, y2, score), best first.  ``state_dict``: a FaceX-Zoo RetinaFace's;
    without one the detector is not :attr:`available`."""

    def __init__(self, state_dict: Optional[Mapping[str, torch.Tensor]] = None, device=None,
                 cfg: Dict = DET_CFG):
        self.cfg = cfg
        self.net = None
        if state_dict is not None:
            self.device = resolve_device(device)
            self.net = RetinaFace()
            self.net.load_state_dict(state_dict, strict=True)
            self.net.to(self.device).requires_grad_(False)

    @property
    def available(self) -> bool:
        return self.net is not None

    @torch.no_grad()
    def __call__(self, img) -> np.ndarray:
        if not self.available:
            raise ValueError("RetinaFaceDetector has no weights")
        h, w = img.shape[:2]
        x = torch.as_tensor(img).to(self.device, torch.float32)
        x = x - torch.tensor(BGR_MEANS, device=self.device)
        loc, conf, _ = self.net(x.permute(2, 0, 1)[None])
        loc, scores = loc[0].cpu().numpy(), conf[0, :, 1].cpu().numpy()
        priors = prior_boxes((h, w), self.cfg["min_sizes"], self.cfg["steps"])
        boxes = decode_boxes(loc, priors, self.cfg["variance"])
        boxes = boxes * np.array([w, h, w, h], np.float32)
        inds = scores > self.cfg["confidence_threshold"]
        boxes, scores = boxes[inds], scores[inds]
        order = scores.argsort()[::-1]
        dets = np.hstack([boxes[order], scores[order, None]]).astype(np.float32)
        return dets[nms(dets, self.cfg["nms_threshold"])]
