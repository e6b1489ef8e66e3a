"""Gaze rotation of the eye feature planes, and the camera offsets' Euler
rotation.

Every function computes in true float32: the caller keeps TF32 off on the
card (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's
default), the counterpart of ``precision="highest"`` in the JAX package.
"""

from __future__ import annotations

import torch


def gaze_rotation_matrices(gaze: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """``[B, 3, 3]`` rotation ``Ry(yaw) @ Rx(pitch)`` from ``[B, 2]``
    (pitch, yaw) gaze."""
    pitch, yaw = gaze[:, 0], gaze[:, 1]
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    zeros = torch.zeros_like(cp)
    ones = torch.ones_like(cp)
    rx = torch.stack(
        [ones, zeros, zeros, zeros, cp, -sp, zeros, sp, cp], dim=-1
    ).reshape(-1, 3, 3)
    ry = torch.stack(
        [cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy], dim=-1
    ).reshape(-1, 3, 3)
    R = torch.bmm(ry, rx)
    return R.transpose(-1, -2) if inverse else R


def rotate_feature_planes(
    featmap: torch.Tensor, gaze: torch.Tensor, inverse: bool = False
) -> torch.Tensor:
    """Rotate an NHWC feature map's channel triplets: each of the ``C/3``
    3-vectors ``v`` maps to ``v @ R`` (row-vector convention)."""
    B, H, W, C = featmap.shape
    if C % 3:
        raise ValueError("featmap channels must be a multiple of 3")
    R = gaze_rotation_matrices(gaze, inverse=inverse)  # [B, 3, 3]
    v = featmap.reshape(B, H * W * (C // 3), 3)
    return torch.bmm(v, R).reshape(B, H, W, C)


def euler_to_rotation(angles: torch.Tensor) -> torch.Tensor:
    """``[B, 3]`` XYZ Euler angles -> ``[B, 3, 3]`` rotations ``Rz @ Ry @ Rx``
    (upstream's batched camera-offset rotation)."""
    sx, sy, sz = (torch.sin(angles[:, i]) for i in range(3))
    cx, cy, cz = (torch.cos(angles[:, i]) for i in range(3))
    zeros = torch.zeros_like(sx)
    ones = torch.ones_like(sx)
    rx = torch.stack([ones, zeros, zeros, zeros, cx, -sx, zeros, sx, cx], dim=-1)
    ry = torch.stack([cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy], dim=-1)
    rz = torch.stack([cz, -sz, zeros, sz, cz, zeros, zeros, zeros, ones], dim=-1)
    rx, ry, rz = (m.reshape(-1, 3, 3) for m in (rx, ry, rz))
    return torch.bmm(torch.bmm(rz, ry), rx)
