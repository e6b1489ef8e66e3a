"""Seeded weights for the frozen metric nets (InceptionV3, RetinaFace, PFLD,
MobileFaceNet) where no checkpoint is at hand: tests and smoke runs."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def seed_frozen_net_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every weight of ``net`` from ``generator``, in module order:
    convolution and linear weights N(0, 2 / fan_in), their biases N(0,
    0.1^2); BatchNorm scales and running variances uniform in [0.5, 1.5),
    shifts and running means N(0, 0.1^2); PReLU slopes 0.25 + N(0,
    0.05^2).  Running statistics that are not 0 and 1 keep BatchNorm's
    folding in every check.  Returns ``net``."""
    g = generator
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = (2.0 / m.weight[0].numel()) ** 0.5
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * std)
                if m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
            elif isinstance(m, nn.PReLU):
                m.weight.copy_(0.25 + torch.randn(m.weight.shape, generator=g) * 0.05)
    return net


def seeded_identity_state_dicts(generator: torch.Generator) -> Dict[str, Dict[str, torch.Tensor]]:
    """State dicts in FaceX-Zoo's layouts for the identity pipeline's three
    nets (``"detector"``, ``"aligner"``, ``"embed"``), drawn by
    :func:`seed_frozen_net_` and then set so that every stage runs on any
    image: RetinaFace's class and box heads scaled by 1e-3, the class bias
    +4 for face on the stride-16 level's first anchor (64 pixels) and -4
    elsewhere (scores near 0.98 against the 0.7 threshold; near 0.02
    elsewhere), boxes near their anchors; PFLD's regression scaled by 1e-5
    about a bias that puts the five arcface points where the template has
    them and the rest uniformly in the middle of the crop."""
    from gazenerf_tpu_torch.models.face_alignment import PFLD
    from gazenerf_tpu_torch.models.face_detection import RetinaFace
    from gazenerf_tpu_torch.models.face_recognition import (
        ARCFACE_SRC,
        EMBED_SIZE,
        LMS5_FROM_106,
        MobileFaceNet,
    )

    g = generator
    det = seed_frozen_net_(RetinaFace(), g)
    aligner = seed_frozen_net_(PFLD(), g)
    embed = seed_frozen_net_(MobileFaceNet(), g)
    with torch.no_grad():
        for level, (cls, box) in enumerate(zip(det.ClassHead, det.BboxHead)):
            cls.conv1x1.weight.mul_(1e-3)
            box.conv1x1.weight.mul_(1e-3)
            box.conv1x1.bias.zero_()
            face = torch.full((cls.conv1x1.bias.numel() // 2,), -4.0)
            if level == 1:
                face[0] = 4.0
            cls.conv1x1.bias.copy_(torch.stack([torch.zeros_like(face), face], 1).reshape(-1))
        aligner.fc.weight.mul_(1e-5)
        lms = torch.rand((aligner.fc.out_features // 2, 2), generator=g) * 0.4 + 0.3
        lms[list(LMS5_FROM_106)] = torch.from_numpy(ARCFACE_SRC / EMBED_SIZE)
        aligner.fc.bias.copy_(lms.reshape(-1))
    return {"detector": det.state_dict(), "aligner": aligner.state_dict(),
            "embed": embed.state_dict()}
