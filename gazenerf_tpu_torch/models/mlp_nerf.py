"""NeRF field MLP with split conditioning.

Upstream ``MLPforNeRF`` topology and parameter layout (module names
``FeaExt_module_0..7``, ``density_module``, ``RGB_layer_0..2``):

* ``fea_0``: (embedding ++ shape_ext_code) -> H, ReLU;
* ``fea_1..7``: H -> H, ReLU; ``fea_5`` consumes ``cat([embedding, code,
  x])`` (the skip after ``fea_4``);
* ``density``: H -> 1, ReLU;
* ``rgb_0``: H -> H, no activation;
* ``rgb_1``: (rgb_0 ++ appearance code) -> H/2, ReLU;
* ``rgb_2``: H/2 -> res_nfeat (no sigmoid for the 258-channel field).

The code rows of ``fea_0``, ``fea_5`` and ``rgb_1`` are folded into
per-batch bias rows (``cat(e, c) @ W == e @ W[:De] + c @ W[De:]``), so the
per-image codes are never broadcast to every sample.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from gazenerf_tpu_torch.kernels.fused_field import (
    FieldOperands,
    fused_field_render,
    prepare_operands,
    split_params,
)
from gazenerf_tpu_torch.models.conv1x1 import Conv1x1

# (upstream module name, short name used by the kernel's parameter split)
_LAYERS = (
    [(f"FeaExt_module_{i}", f"fea_{i}") for i in range(8)]
    + [
        ("density_module", "density"),
        ("RGB_layer_0", "rgb_0"),
        ("RGB_layer_1", "rgb_1"),
        ("RGB_layer_2", "rgb_2"),
    ]
)


class NeRFFieldMLP(nn.Module):
    """Pointwise radiance / density field."""

    def __init__(
        self,
        embed_dims: int,
        cond_dims: int,
        vd_cond_dims: int,
        hidden: int = 384,
        n_layers: int = 8,
        res_nfeat: int = 258,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.embed_dims = embed_dims
        self.vp_channels = embed_dims + cond_dims
        self.hidden = hidden
        self.n_layers = n_layers
        self.res_nfeat = res_nfeat
        self.dtype = dtype
        skip_at = n_layers // 2
        H = hidden
        for i in range(n_layers):
            cin = self.vp_channels if i == 0 else H
            if i == skip_at + 1:
                cin = self.vp_channels + H
            self.add_module(f"FeaExt_module_{i}", Conv1x1(cin, H))
        self.density_module = Conv1x1(H, 1)
        self.RGB_layer_0 = Conv1x1(H, H)
        self.RGB_layer_1 = Conv1x1(H + vd_cond_dims, H // 2)
        self.RGB_layer_2 = Conv1x1(H // 2, res_nfeat)
        # (parameter key, split blocks, kernel operands); see kernel_operands
        self._operands: Optional[Tuple[tuple, Dict, FieldOperands]] = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name, _ in _LAYERS:
            getattr(self, name).init_xavier_uniform_(generator)

    def flat(self) -> Dict[str, torch.Tensor]:
        """``{short}/kernel`` (``[in, out]`` views) and ``{short}/bias``."""
        out = {}
        for name, short in _LAYERS:
            layer = getattr(self, name)
            out[f"{short}/kernel"] = layer.kernel()
            out[f"{short}/bias"] = layer.bias
        return out

    def kernel_operands(self) -> Tuple[Dict, FieldOperands]:
        """The fused kernel's weight blocks and bf16 operands, built once per
        weight set.  They are rebuilt when a parameter is replaced (``to``)
        or written in place (``load_state_dict``, an optimiser step), which
        its storage pointer and version counter show."""
        key = tuple((t.data_ptr(), t._version) for t in self.parameters())
        if self._operands is None or self._operands[0] != key:
            with torch.no_grad():
                p = split_params(self.flat(), self.embed_dims)
                self._operands = (key, p, prepare_operands(p))
        return self._operands[1], self._operands[2]

    def fused_render(self, embed_vp, shape_cond, appea_cond, zvals, zdists):
        """Field + integration through the fused field kernels (bf16).

        Under autograd the weight blocks are views of the parameters, so the
        backward kernel's gradients reach them; the bf16 operands come from
        the per-weight-set cache either way.

        Returns ``(feat_int [B,R,C], bg_alpha [B,R], depth [B,R], w [B,R,S])``.
        """
        p, ops = self.kernel_operands()
        if torch.is_grad_enabled():
            p = split_params(self.flat(), self.embed_dims)
        return fused_field_render(p, ops, embed_vp, shape_cond, appea_cond, zvals, zdists)

    def forward(
        self,
        embed_vp: torch.Tensor,
        shape_cond: torch.Tensor,
        appea_cond: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Evaluate the field in ``self.dtype``.

        Args:
          embed_vp: ``[B, ..., embed_dims]`` positional encodings.
          shape_cond: ``[B, cond_dims]`` per-image shape ++ gaze code.
          appea_cond: ``[B, vd_cond_dims]`` per-image appearance code.

        Returns ``(features [B, ..., res_nfeat], density [B, ..., 1])``.
        """
        dt = self.dtype
        De, H = self.embed_dims, self.hidden
        skip_at = self.n_layers // 2
        B = embed_vp.shape[0]
        bshape = (B,) + (1,) * (embed_vp.ndim - 2)  # broadcast over rays/samples

        def param(name):
            layer = getattr(self, name)
            return layer.kernel().to(dt), layer.bias.to(dt)

        e = embed_vp.to(dt)
        sc = shape_cond.to(dt)
        ac = appea_cond.to(dt)

        k, b = param("FeaExt_module_0")
        x = e @ k[:De] + (sc @ k[De:]).reshape(bshape + (H,)) + b
        x = torch.relu(x)
        for i in range(1, self.n_layers):
            k, b = param(f"FeaExt_module_{i}")
            if i == skip_at + 1:
                cond = sc @ k[De : self.vp_channels]
                x = (
                    e @ k[:De]
                    + cond.reshape(bshape + (H,))
                    + x @ k[self.vp_channels :]
                    + b
                )
            else:
                x = x @ k + b
            x = torch.relu(x)

        k, b = param("density_module")
        density = torch.relu(x @ k + b)

        k, b = param("RGB_layer_0")
        y = x @ k + b  # no activation
        k, b = param("RGB_layer_1")
        y = y @ k[:H] + (ac @ k[H:]).reshape(bshape + (H // 2,)) + b
        y = torch.relu(y)

        k, b = param("RGB_layer_2")
        feat = y @ k + b
        if self.res_nfeat == 3:
            feat = torch.sigmoid(feat)
        return feat, density
