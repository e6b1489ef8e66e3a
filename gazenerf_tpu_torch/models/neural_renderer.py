"""Neural renderer: ``[B, 64, 64, 258]`` feature map -> ``[B, 512, 512, 3]`` RGB.

Upstream ``NeuralRenderer`` / ``PixelShuffleUpsample`` (module names
``feat_upsample_list.{i}.layer_1/2``, ``feat_layers.{i}``,
``feat_2_rgb_list.{i}``, ``bg_featmap``), NHWC, in the configuration the
JAX package runs by default:

* ``phase_gm``: ``layer_2``'s output columns are permuted statically to
  group-major order (``perm[k*F + c] = c*4 + k``; the stored weights keep
  upstream order), so the four pixel-shuffle phases are contiguous slices;
* the channel-tile residual ``x.repeat(1, 4, 1, 1)`` in group-major order is
  the 0/1 matrix ``P`` with ``P[(4c + k) % F, k*F + c] = 1``; ``x @ P`` is
  applied as the tile and transpose it encodes (:func:`tile_gm`: the same
  values, and a gradient summed over the four tiles in f32 and rounded once,
  as JAX's product rounds it, where a gather's gradient is a scatter);
* each ``feat_layer`` is folded in front of the blur-shuffle, per phase
  (exact: channel mixing commutes with the per-channel stencil whose taps
  sum to 1);
* the rgb skip chain runs channel-first (``[B, 3, H, W]``).

``shuffle_mode`` picks how a block runs, as in the JAX package:

* ``"phase_gm"`` (the default): the above in PyTorch ops, the stencil summed
  in f32 (:func:`~gazenerf_tpu_torch.ops.image.pixel_shuffle2_blur_gm`);
* ``"pallas"``: the same, with the stencil as the blur-shuffle kernel (K5,
  its gradient K6: ``kernels/shuffle_blur.py``), in the renderer dtype;
* ``"fused"``: the whole block as the fused upsampler kernel (K7, its
  gradient K8: ``kernels/fused_upsampler.py``), in the renderer dtype;
* ``"phase"``: upstream's channel order (``layer_2`` unpermuted, the
  residual ``x.repeat(1, 4, 1, 1)``), the stencil as phase FMAs in f32
  (:func:`~gazenerf_tpu_torch.ops.image.pixel_shuffle2_blur`);
* ``"naive"``: upstream's order, ``blur3x3(pixel_shuffle2(.))``.

``fold_feat_layer`` (``renderer_fold_feat``) folds each ``feat_layer`` in
front of the stencil in the group-major modes; without it, and in the
``phase`` and ``naive`` modes, ``feat_layer`` runs after the stencil at full
resolution.  ``fused`` always folds.  ``rgb_channel_first``
(``renderer_rgb_cf``) runs the rgb skip chain channel-first; without it the
chain is NHWC, its head a dense layer in the renderer dtype and its
upsample :func:`~gazenerf_tpu_torch.ops.image.upsample2x_blur`.

The parameters are the same ``Conv1x1`` modules in every mode.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gazenerf_tpu_torch.kernels.fused_upsampler import FusedUpsample, residual_index  # noqa: F401 (re-exported)
from gazenerf_tpu_torch.kernels.shuffle_blur import shuffle_blur_gm
from gazenerf_tpu_torch.models.conv1x1 import Conv1x1
from gazenerf_tpu_torch.ops.image import (
    blur3x3,
    pixel_shuffle2,
    pixel_shuffle2_blur,
    pixel_shuffle2_blur_gm,
    upsample2x_blur,
    upsample2x_blur_cf,
)

SHUFFLE_MODES = ("phase_gm", "pallas", "fused", "phase", "naive")
# the modes whose layer_2 emits group-major channels
GM_MODES = ("phase_gm", "pallas", "fused")


def gm_permutation(F_: int) -> np.ndarray:
    """``perm[k*F + c] = c*4 + k``: upstream shuffle order -> group-major."""
    perm = np.empty(4 * F_, np.int64)
    for c in range(F_):
        for k in range(4):
            perm[k * F_ + c] = c * 4 + k
    return perm


def tile_gm(x: torch.Tensor) -> torch.Tensor:
    """``[..., F]`` -> ``[..., 4F]`` with channel ``k*F + c`` equal to
    ``x[..., (4c + k) % F]`` (``x[..., residual_index(F)]``): the four-fold
    channel tile, read as ``[F, 4]`` and transposed to group-major order.  Its
    gradient is the tile's, a sum over the four tiles (in f32 for bf16,
    rounded once)."""
    F_ = x.shape[-1]
    t = x.repeat(*([1] * (x.dim() - 1)), 4).unflatten(-1, (F_, 4))
    return t.transpose(-1, -2).flatten(-2)


class PixelShuffleUpsample(nn.Module):
    """x2 upsample: two 1x1 convs, channel-tile residual, the optional
    folded ``feat_layer``, blur-shuffle."""

    def __init__(
        self, in_feature: int, dtype: torch.dtype = torch.float32, shuffle_mode: str = "phase_gm"
    ):
        super().__init__()
        if shuffle_mode not in SHUFFLE_MODES:
            raise ValueError(f"shuffle_mode {shuffle_mode!r} not in {SHUFFLE_MODES}")
        self.in_feature = in_feature
        self.dtype = dtype
        self.shuffle_mode = shuffle_mode
        self.layer_1 = Conv1x1(in_feature, in_feature * 2)
        self.layer_2 = Conv1x1(in_feature * 2, in_feature * 4)
        self.register_buffer(
            "perm", torch.from_numpy(gm_permutation(in_feature)), persistent=False
        )

    def forward(self, x: torch.Tensor, fold: Optional[Conv1x1] = None) -> torch.Tensor:
        """``[B, H, W, F]`` -> ``[B, 2H, 2W, F']``: F' is what ``fold`` maps F
        to (group-major modes; ``fused`` needs it), else F."""
        dt = self.dtype
        Fi = self.in_feature
        mode = self.shuffle_mode
        if mode in GM_MODES:
            # group-major columns, indexed outside any kernel so that autograd
            # carries their gradient back to the stored order
            k2 = self.layer_2.kernel()[:, self.perm]
            b2 = self.layer_2.bias[self.perm]
        if mode == "fused":
            if fold is None:
                raise ValueError("the fused block takes the folded feat_layer")
            return FusedUpsample.apply(
                x.to(dt), self.layer_1.kernel(), self.layer_1.bias, k2, b2,
                fold.kernel(), fold.bias, dt == torch.bfloat16,
            )
        out = F.leaky_relu(self.layer_1(x, dt), 0.2)
        if mode not in GM_MODES:  # upstream's order: x.repeat(1, 4, 1, 1)
            z = F.leaky_relu(self.layer_2(out, dt), 0.2) + x.repeat(1, 1, 1, 4)
            return pixel_shuffle2_blur(z) if mode == "phase" else blur3x3(pixel_shuffle2(z))
        out2 = F.leaky_relu(out @ k2.to(dt) + b2.to(dt), 0.2)
        z = out2 + tile_gm(x.to(dt))
        if fold is not None:
            B, H, W, _ = z.shape
            z = fold(z.reshape(B, H, W, 4, Fi), dt).reshape(B, H, W, -1)
        if mode == "pallas":
            return shuffle_blur_gm(z)
        return pixel_shuffle2_blur_gm(z)


class NeuralRenderer(nn.Module):
    """Pixel-shuffle upsampling CNN with per-scale RGB skip connections;
    ``n_blocks = log2(img_size / featmap_size)``, widths
    ``max(feat_nc // 2**i, min_feat)``.  Owns the learnable background
    feature map, stored upstream-style ``[1, C, H, W]``."""

    def __init__(
        self,
        bg_type: str = "white",
        feat_nc: int = 258,
        out_dim: int = 3,
        final_actvn: bool = True,
        min_feat: int = 32,
        featmap_size: int = 64,
        img_size: int = 512,
        dtype: torch.dtype = torch.float32,
        shuffle_mode: str = "phase_gm",
        fold_feat_layer: bool = True,
        rgb_channel_first: bool = True,
    ):
        super().__init__()
        self.bg_type = bg_type
        self.final_actvn = final_actvn
        self.dtype = dtype
        self.n_blocks = int(math.log2(img_size) - math.log2(featmap_size))
        widths = [max(feat_nc // (2**i), min_feat) for i in range(self.n_blocks + 1)]
        self.feat_upsample_list = nn.ModuleList(
            [PixelShuffleUpsample(widths[i], dtype, shuffle_mode) for i in range(self.n_blocks)]
        )
        self.feat_layers = nn.ModuleList(
            [Conv1x1(widths[i], widths[i + 1]) for i in range(self.n_blocks)]
        )
        self.feat_2_rgb_list = nn.ModuleList(
            [Conv1x1(widths[i], out_dim) for i in range(self.n_blocks + 1)]
        )
        self.bg_featmap = nn.Parameter(
            torch.empty(1, feat_nc, featmap_size, featmap_size)
        )
        self.set_mode(shuffle_mode, fold_feat_layer, rgb_channel_first)

    def set_mode(self, shuffle_mode: str, fold_feat_layer: bool = True,
                 rgb_channel_first: bool = True) -> None:
        """Run in another mode on the same parameters (every mode holds the
        same tree): ``shuffle_mode``, ``fold_feat_layer`` and
        ``rgb_channel_first`` as the constructor takes them."""
        if shuffle_mode not in SHUFFLE_MODES:
            raise ValueError(f"shuffle_mode {shuffle_mode!r} not in {SHUFFLE_MODES}")
        for block in self.feat_upsample_list:
            block.shuffle_mode = shuffle_mode
        # fused always folds; the upstream-order modes never do
        self.fold = shuffle_mode == "fused" or (fold_feat_layer and shuffle_mode in GM_MODES)
        self.rgb_channel_first = rgb_channel_first

    def reset_parameters(self, generator: torch.Generator) -> None:
        for blk in self.feat_upsample_list:
            blk.layer_1.init_lecun_normal_(generator)
            blk.layer_2.init_lecun_normal_(generator)
        for layer in (*self.feat_layers, *self.feat_2_rgb_list):
            layer.init_lecun_normal_(generator)
        with torch.no_grad():
            self.bg_featmap.fill_(1.0 if self.bg_type == "white" else 0.0)

    def get_bg_featmap(self) -> torch.Tensor:
        """The background feature map, NHWC ``[1, H, W, C]``."""
        return self.bg_featmap.permute(0, 2, 3, 1)

    def _rgb_head(self, idx: int, t: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        layer = self.feat_2_rgb_list[idx]
        if not self.rgb_channel_first:
            return layer(t, dt)
        # channel-first head: straight into [B, 3, H, W]
        rgb = torch.einsum("bhwf,fc->bchw", t.to(dt), layer.kernel().to(dt))
        return rgb + layer.bias.to(dt)[None, :, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, h, w, feat_nc]`` feature map -> ``[B, H, W, 3]`` RGB."""
        up = upsample2x_blur_cf if self.rgb_channel_first else upsample2x_blur
        if self.n_blocks == 0:
            rgb = self._rgb_head(0, x)
        else:
            rgb = up(self._rgb_head(0, x))
            net = x
            for idx in range(self.n_blocks):
                block, layer = self.feat_upsample_list[idx], self.feat_layers[idx]
                if self.fold:
                    hid = block(net, fold=layer)
                else:  # feat_layer at full resolution, after the stencil
                    hid = layer(block(net), self.dtype)
                net = F.leaky_relu(hid, 0.2)
                rgb = rgb + self._rgb_head(idx + 1, net)
                if idx < self.n_blocks - 1:
                    rgb = up(rgb)
        if self.rgb_channel_first:
            rgb = rgb.permute(0, 2, 3, 1)
        return torch.sigmoid(rgb) if self.final_actvn else rgb
