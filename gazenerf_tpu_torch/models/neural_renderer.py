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
  gradient K8: ``kernels/fused_upsampler.py``), in the renderer dtype.

The parameters are the same ``Conv1x1`` modules in every mode.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gazenerf_tpu_torch.kernels.fused_upsampler import FusedUpsample, residual_index  # noqa: F401 (re-exported)
from gazenerf_tpu_torch.kernels.shuffle_blur import shuffle_blur_gm
from gazenerf_tpu_torch.models.conv1x1 import Conv1x1
from gazenerf_tpu_torch.ops.image import pixel_shuffle2_blur_gm, upsample2x_blur_cf

SHUFFLE_MODES = ("phase_gm", "pallas", "fused")


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
    """x2 upsample: two 1x1 convs, channel-tile residual, folded
    ``feat_layer``, blur-shuffle."""

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

    def forward(self, x: torch.Tensor, fold: Conv1x1) -> torch.Tensor:
        """``[B, H, W, F]`` -> ``[B, 2H, 2W, F']`` where ``fold`` maps F -> F'."""
        dt = self.dtype
        Fi = self.in_feature
        # group-major columns, indexed outside any kernel so that autograd
        # carries their gradient back to the stored order
        k2 = self.layer_2.kernel()[:, self.perm]
        b2 = self.layer_2.bias[self.perm]
        if self.shuffle_mode == "fused":
            return FusedUpsample.apply(
                x.to(dt), self.layer_1.kernel(), self.layer_1.bias, k2, b2,
                fold.kernel(), fold.bias, dt == torch.bfloat16,
            )
        out = F.leaky_relu(self.layer_1(x, dt), 0.2)
        out2 = F.leaky_relu(out @ k2.to(dt) + b2.to(dt), 0.2)
        z = out2 + tile_gm(x.to(dt))
        B, H, W, _ = z.shape
        z = fold(z.reshape(B, H, W, 4, Fi), dt).reshape(B, H, W, -1)
        if self.shuffle_mode == "pallas":
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
        # channel-first head: straight into [B, 3, H, W]
        dt = self.dtype
        layer = self.feat_2_rgb_list[idx]
        rgb = torch.einsum("bhwf,fc->bchw", t.to(dt), layer.kernel().to(dt))
        return rgb + layer.bias.to(dt)[None, :, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, h, w, feat_nc]`` feature map -> ``[B, H, W, 3]`` RGB."""
        if self.n_blocks == 0:
            rgb = self._rgb_head(0, x)
        else:
            rgb = upsample2x_blur_cf(self._rgb_head(0, x))
            net = x
            for idx in range(self.n_blocks):
                hid = self.feat_upsample_list[idx](net, fold=self.feat_layers[idx])
                net = F.leaky_relu(hid, 0.2)
                rgb = rgb + self._rgb_head(idx + 1, net)
                if idx < self.n_blocks - 1:
                    rgb = upsample2x_blur_cf(rgb)
        rgb = rgb.permute(0, 2, 3, 1)
        return torch.sigmoid(rgb) if self.final_actvn else rgb
