"""MobileFaceNet and the FaceX-Zoo identity pipeline: detect, align, crop,
embed, compare.

The port's counterpart of the JAX package's ``models/face_recognition.py``
(upstream ``face_recognition/evaluation_similarity.py``, the net
``mobilefacenet_def.py``).  The modules carry upstream's names
(``conv_3.model.0.conv_dw.prelu.weight``), so a FaceX-Zoo state dict loads
strictly.  BatchNorm runs in eval mode.

:class:`IdentitySimilarityPipeline` is RetinaFace, then PFLD, then the
arcface crop, then MobileFaceNet, then the dot product of the unit
embeddings.  A stage without weights falls back as in the JAX package: no
detector or no face, or no aligner, and the image is resized to 112
(``preprocess.normalize.resize_linear_u8``, ``cv2.resize``'s uint8
arithmetic).  The arcface crop warps with ``preprocess.normalize.
warp_affine`` (``cv2.warpAffine``'s arithmetic).  The similarity fit is
numpy float64 on the host.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gazenerf_tpu_torch.models.gaze_nerf import resolve_device
from gazenerf_tpu_torch.models.seeding import seed_frozen_net_
from gazenerf_tpu_torch.ops.image import resize_bilinear
from gazenerf_tpu_torch.preprocess.normalize import resize_linear_u8, warp_affine

EMBED_SIZE = 112


class ConvBlock(nn.Module):
    """conv (no bias) + BatchNorm + per-channel PReLU."""

    def __init__(self, cin: int, cout: int, kernel=(1, 1), stride=(1, 1), padding=(0, 0),
                 groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout)
        self.prelu = nn.PReLU(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.prelu(self.bn(self.conv(x)))


class LinearBlock(nn.Module):
    """conv (no bias) + BatchNorm, no activation."""

    def __init__(self, cin: int, cout: int, kernel=(1, 1), stride=(1, 1), padding=(0, 0),
                 groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class DepthWise(nn.Module):
    """pw-expand to ``groups``, 3x3 depthwise, pw-project; the residual with
    ``residual``."""

    def __init__(self, cin: int, cout: int, groups: int, stride=(2, 2), residual: bool = False):
        super().__init__()
        self.residual = residual
        self.conv = ConvBlock(cin, groups)
        self.conv_dw = ConvBlock(groups, groups, (3, 3), stride, (1, 1), groups=groups)
        self.project = LinearBlock(groups, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.project(self.conv_dw(self.conv(x)))
        return x + y if self.residual else y


class Residual(nn.Module):
    """``num_block`` residual :class:`DepthWise` blocks (upstream's
    ``Residual``, whose ``model`` names the keys)."""

    def __init__(self, c: int, num_block: int, groups: int):
        super().__init__()
        self.model = nn.Sequential(*[DepthWise(c, c, groups, (1, 1), residual=True)
                                     for _ in range(num_block)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class MobileFaceNet(nn.Module):
    """``[B, 3, 112, 112]`` in [-1, 1] -> ``[B, embedding_size]`` unit
    embeddings.  ``conv_6_dw``'s kernel is ``(out_h, out_w)``, the last
    feature map's size (7 x 7 at 112).  Built in eval mode."""

    def __init__(self, embedding_size: int = 512, out_h: int = 7, out_w: int = 7):
        super().__init__()
        self.conv1 = ConvBlock(3, 64, (3, 3), (2, 2), (1, 1))
        self.conv2_dw = ConvBlock(64, 64, (3, 3), (1, 1), (1, 1), groups=64)
        self.conv_23 = DepthWise(64, 64, 128)
        self.conv_3 = Residual(64, 4, 128)
        self.conv_34 = DepthWise(64, 128, 256)
        self.conv_4 = Residual(128, 6, 256)
        self.conv_45 = DepthWise(128, 128, 512)
        self.conv_5 = Residual(128, 2, 256)
        self.conv_6_sep = ConvBlock(128, 512)
        self.conv_6_dw = LinearBlock(512, 512, (out_h, out_w), groups=512)
        self.linear = nn.Linear(512, embedding_size, bias=False)
        self.bn = nn.BatchNorm1d(embedding_size)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for m in (self.conv1, self.conv2_dw, self.conv_23, self.conv_3, self.conv_34,
                  self.conv_4, self.conv_45, self.conv_5, self.conv_6_sep, self.conv_6_dw):
            x = m(x)
        x = self.bn(self.linear(x.reshape(x.shape[0], -1)))
        return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def make_identity_embed_fn(state_dict: Optional[Mapping[str, torch.Tensor]] = None, device=None,
                           generator: Optional[torch.Generator] = None) -> Callable:
    """``embed(img [B, H, W, 3] in [0, 1]) -> [B, 512]`` on ``device`` (the
    card unless given): a bilinear resize to 112, ``(x - 0.5) / 0.5`` (the
    JAX package's scaling; FaceX-Zoo's handler takes ``(x - 127.5) / 128``
    on 0-255), MobileFaceNet.  ``state_dict``: a FaceX-Zoo MobileFaceNet's;
    without one the weights are drawn from ``generator``
    (:func:`~gazenerf_tpu_torch.models.seeding.seed_frozen_net_`)."""
    device = resolve_device(device)
    net = MobileFaceNet()
    if state_dict is not None:
        net.load_state_dict(state_dict, strict=True)
    elif generator is not None:
        seed_frozen_net_(net, generator)
    else:
        raise ValueError("make_identity_embed_fn needs a state_dict or a generator")
    net.to(device).requires_grad_(False)

    @torch.no_grad()
    def embed(img) -> torch.Tensor:
        x = torch.as_tensor(img).to(device=device, dtype=torch.float32)
        x = (resize_bilinear(x, (EMBED_SIZE, EMBED_SIZE)) - 0.5) / 0.5
        return net(x.permute(0, 3, 1, 2))

    return embed


# the 106-point ids of the five arcface points (upstream lms_trans.py
# lms5_2_lms106, 0-based)
LMS5_FROM_106 = (104, 105, 54, 84, 90)

# arcface's 112x112 template (upstream FaceRecImageCropper.py)
ARCFACE_SRC = np.array([[38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
                        [41.5493, 92.3655], [70.7299, 92.2041]], np.float32)


def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The least-squares similarity ``src -> dst`` (Umeyama 1991, what
    upstream takes from ``skimage``'s ``SimilarityTransform``), ``[2, 3]``
    f32, computed in float64."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n, d = src.shape
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / n
    U, S, Vt = np.linalg.svd(cov)
    sgn = np.ones(d)
    if np.linalg.det(cov) < 0:
        sgn[-1] = -1
    R = U @ np.diag(sgn) @ Vt
    var_s = (sc**2).sum() / n
    scale = (S * sgn).sum() / max(var_s, 1e-12)
    M = np.zeros((2, 3))
    M[:, :2] = scale * R
    M[:, 2] = mu_d - scale * R @ mu_s
    return M.astype(np.float32)


def arcface_crop(img, lms106: np.ndarray, out_size: int = 112) -> torch.Tensor:
    """``img`` ``[H, W, 3]`` uint8 warped onto the arcface template from its
    106 landmarks: ``[out_size, out_size, 3]`` uint8 on the image's device
    (``cv2.warpAffine`` with a zero border, as upstream's
    ``crop_image_by_mat``)."""
    lm5 = np.asarray(lms106, np.float32).reshape(-1, 2)[list(LMS5_FROM_106)]
    return warp_affine(torch.as_tensor(img), umeyama_similarity(lm5, ARCFACE_SRC),
                       (out_size, out_size))


class IdentitySimilarityPipeline:
    """``pipeline(img_a, img_b) -> float``: the cosine similarity of two
    ``[H, W, 3]`` uint8 images' embeddings, each through detect, align,
    crop and embed.  ``detector`` / ``aligner``: a
    :class:`~gazenerf_tpu_torch.models.face_detection.RetinaFaceDetector` /
    :class:`~gazenerf_tpu_torch.models.face_alignment.PFLDAligner`, or None.
    The channel order is the caller's (the protocols pass RGB where
    FaceX-Zoo takes BGR, as the JAX package does).  :attr:`last_stages`
    says per image of the last pair what ran: ``"aligned"`` (detected,
    aligned, arcface crop), ``"no_face"`` (the detector found none),
    ``"resized"`` (no detector, or no aligner)."""

    def __init__(self, embed_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 detector=None, aligner=None, device=None,
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        self.embed_fn = make_identity_embed_fn(embed_state_dict, self.device, generator)
        self.detector = detector
        self.aligner = aligner
        self.last_stages: Tuple[str, ...] = ()

    def _prep(self, img) -> Tuple[torch.Tensor, str]:
        """``[H, W, 3]`` uint8 -> (the ``[1, 112, 112, 3]`` f32 crop in [0,
        1], its stage)."""
        img = torch.as_tensor(img).to(self.device)
        crop, stage = None, "resized"
        if self.detector is not None and self.detector.available:
            dets = self.detector(img)
            if not len(dets):
                stage = "no_face"
            elif self.aligner is not None and self.aligner.available:
                crop, stage = arcface_crop(img, self.aligner(img, dets[0])), "aligned"
        if crop is None:
            crop = resize_linear_u8(img, (EMBED_SIZE, EMBED_SIZE))
        return crop.to(torch.float32)[None] / 255.0, stage

    def __call__(self, img_a, img_b) -> float:
        (xa, sa), (xb, sb) = self._prep(img_a), self._prep(img_b)
        self.last_stages = (sa, sb)
        ea, eb = self.embed_fn(xa)[0], self.embed_fn(xb)[0]
        ea = ea / ea.norm().clamp_min(1e-8)
        eb = eb / eb.norm().clamp_min(1e-8)
        return float((ea * eb).sum())
