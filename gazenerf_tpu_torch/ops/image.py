"""Image ops of the neural renderer.

* :func:`pixel_shuffle2_blur_gm` — ``blur3x3(pixel_shuffle2(x))`` on a
  group-major NHWC input, computed as shifted FMAs of the four phase
  images (the renderer's ``phase_gm`` mode); :func:`pixel_shuffle2_blur`
  the same on upstream's channel order (``phase`` mode);
* :func:`pixel_shuffle2` and :func:`blur3x3` — the two steps on their own
  (the ``naive`` mode);
* :func:`upsample2x_blur_cf` — the rgb skip chain's x2 bilinear upsample
  plus binomial blur on channel-first ``[B, C, H, W]`` tensors;
  :func:`upsample2x_blur` the same on NHWC tensors (``renderer_rgb_cf``
  off);
* :func:`resize_bilinear` — NHWC bilinear resize (the perceptual loss's
  224x224 input).

The blur is the 3x3 binomial ``[1,2,1] x [1,2,1] / 16`` with a reflect
boundary (kornia ``filter2d`` semantics, as upstream).  The phase stencils
and ``blur3x3_cf`` sum their nine taps in at least f32 and return that type,
as the JAX package's do (its taps are numpy scalars, which promote a bf16
input to f32); :func:`blur3x3` and :func:`upsample2x_blur` return the
input's type, rounded once after an f32 sum (the JAX package's depthwise
convolution and resize run in the input's type).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

_TAPS = np.outer([0.25, 0.5, 0.25], [0.25, 0.5, 0.25])  # 3x3 binomial / 16


def pixel_shuffle2_blur_gm(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 4C]`` group-major (channel ``k*C + c`` is phase ``k`` of
    channel ``c``) -> ``[B, 2H, 2W, C]`` blurred pixel shuffle."""
    B, H, W, C4 = x.shape
    if C4 % 4:
        raise ValueError(f"channels {C4} not a multiple of 4")
    C = C4 // 4
    g = [x[..., k * C : (k + 1) * C] for k in range(4)]
    return _phase_shuffle_blur(g, B, H, W, C)


def pixel_shuffle2_blur(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 4C]`` in upstream's shuffle order (channel ``4c + k`` is
    phase ``k`` of channel ``c``) -> ``[B, 2H, 2W, C]`` blurred pixel
    shuffle, summed and returned in f32 (f64 for f64)."""
    B, H, W, C4 = x.shape
    if C4 % 4:
        raise ValueError(f"channels {C4} not a multiple of 4")
    g = [x[..., k::4] for k in range(4)]
    return _phase_shuffle_blur(g, B, H, W, C4 // 4)


def pixel_shuffle2(x: torch.Tensor) -> torch.Tensor:
    """Pixel shuffle by 2 in torch's channel order, NHWC: ``[B, H, W, 4C]``
    -> ``[B, 2H, 2W, C]`` with ``out[2h+i, 2w+j, c] = x[h, w, 4c + 2i + j]``."""
    B, H, W, C4 = x.shape
    if C4 % 4:
        raise ValueError(f"channels {C4} not a multiple of 4")
    x = x.reshape(B, H, W, C4 // 4, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, 2 * H, 2 * W, C4 // 4)


def blur3x3(x: torch.Tensor) -> torch.Tensor:
    """Binomial blur of NHWC ``x`` with a reflect boundary: the nine taps
    summed in f32 (f64 for f64) and rounded once to x's type."""
    return blur3x3_cf(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).to(x.dtype)


def upsample2x_blur(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample then blur, NHWC, in x's type: each axis's exact
    x2 resize (half-pixel centres, edge clamp) summed in f32 and rounded to
    x's type, rows then columns, then :func:`blur3x3`."""
    acc = sum_dtype(x.dtype)
    up = _up2_axis_cf(x.to(acc), 1).to(x.dtype)
    return blur3x3(_up2_axis_cf(up.to(acc), 2).to(x.dtype))


def _edge_pad_hw(t: torch.Tensor) -> torch.Tensor:
    """Replicate one row / column on each side of an NHWC tensor."""
    t = torch.cat([t[:, :1], t, t[:, -1:]], dim=1)
    return torch.cat([t[:, :, :1], t, t[:, :, -1:]], dim=2)


def sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The stencils' summation (and result) type: f32, or f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


def _phase_shuffle_blur(g: List[torch.Tensor], B: int, H: int, W: int, C: int):
    # edge-replicating ONE block of each phase image reproduces the blur's
    # reflect boundary in shuffled space (shuffled row -1 == row 1 == the
    # phase-1 row of block 0)
    gp = [_edge_pad_hw(gi.to(sum_dtype(gi.dtype))) for gi in g]

    def shifted(k, dh, dw):
        return gp[k][:, 1 + dh : 1 + dh + H, 1 + dw : 1 + dw + W]

    # out[2h+i, 2w+j] = sum_{a,b} taps[a,b] * sh[2h+i+a-1, 2w+j+b-1] with
    # sh[m, n] = g[(m%2)*2 + n%2][m//2, n//2]
    phases = []
    for i in range(2):
        row_phase = []
        for j in range(2):
            acc = None
            for a in range(3):
                for b in range(3):
                    m, n = i + a - 1, j + b - 1  # shuffled-space offsets
                    t = float(_TAPS[a, b]) * shifted(
                        (m % 2) * 2 + (n % 2), m // 2, n // 2
                    )
                    acc = t if acc is None else acc + t
            row_phase.append(acc)
        phases.append(row_phase)

    # interleave columns, then rows (C stays minor)
    row0 = torch.stack(phases[0], dim=3).reshape(B, H, 2 * W, C)
    row1 = torch.stack(phases[1], dim=3).reshape(B, H, 2 * W, C)
    return torch.stack([row0, row1], dim=2).reshape(B, 2 * H, 2 * W, C)


def _up2_axis_cf(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact x2 bilinear upsample (half-pixel centres, edge clamp) along one
    axis: ``out[2i] = 0.25 prev + 0.75 cur``, ``out[2i+1] = 0.75 cur + 0.25
    next``."""
    n = x.shape[axis]

    def shift(off):
        idx = torch.clamp(torch.arange(n, device=x.device) + off, 0, n - 1)
        return torch.index_select(x, axis, idx)

    a = 0.25 * shift(-1) + 0.75 * x
    b = 0.75 * x + 0.25 * shift(1)
    out = torch.stack([a, b], dim=axis + 1)
    return out.reshape(x.shape[:axis] + (2 * n,) + x.shape[axis + 1 :])


def blur3x3_cf(x: torch.Tensor) -> torch.Tensor:
    """Binomial blur of ``[B, C, H, W]`` with a reflect boundary, as shifted
    FMAs, summed and returned in f32 (f64 for f64)."""
    B, C, H, W = x.shape
    xp = F.pad(x.to(sum_dtype(x.dtype)), (1, 1, 1, 1), mode="reflect")
    acc = None
    for a in range(3):
        for b in range(3):
            t = float(_TAPS[a, b]) * xp[:, :, a : a + H, b : b + W]
            acc = t if acc is None else acc + t
    return acc


def upsample2x_blur_cf(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample then blur, channel-first ``[B, C, H, W]``."""
    return blur3x3_cf(_up2_axis_cf(_up2_axis_cf(x, 2), 3))


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B, H', W', C]`` bilinear resize with half-pixel
    centres and no antialiasing (``jax.image.resize(..., "bilinear",
    antialias=False)``)."""
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
        align_corners=False, antialias=False,
    )
    return y.permute(0, 2, 3, 1)
