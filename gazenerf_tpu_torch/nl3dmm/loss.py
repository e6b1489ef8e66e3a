"""The NL-3DMM fitting loss, the port of the JAX package's
``nl3dmm/loss.py`` (upstream ``losses/nl3dmm_loss.py``): the masked
photometric MSE (x10), the weighted 68-landmark error (the nose bridge
28:31 and the last 8 mouth points weigh 20x before normalization), the SH
coefficients' per-band RGB constancy (x0.01), the codes' ``2.5 mean(c^2)``
per group (x0.001) and the skin colour's constancy over the skin-mask
vertices (x0.1).  The photometric mask enters as a multiplicative weight
(the value and gradient of upstream's ``pred[mask]`` mean)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def make_lm_weights() -> np.ndarray:
    """The normalized 68-landmark weights."""
    w = np.ones(68, np.float32)
    w[28:31] = 20.0
    w[-8:] = 20.0
    return w / w.sum()


def photo_loss(pred_img: torch.Tensor, gt_img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The MSE over the masked elements (``mask`` broadcasts over
    ``pred_img``)."""
    m = torch.broadcast_to(mask.to(pred_img.dtype), pred_img.shape)
    return ((pred_img - gt_img) ** 2 * m).sum() / m.sum().clamp_min(1.0)


def lm2d_loss(pred_lms: torch.Tensor, gt_lms: torch.Tensor,
              lm_weight: torch.Tensor) -> torch.Tensor:
    """``sum(w * |p - g|^2) / (B * 68)``."""
    err = ((pred_lms - gt_lms) ** 2).sum(-1)
    return (err * lm_weight[None]).sum() / (pred_lms.shape[0] * pred_lms.shape[1])


def gamma_loss(gamma: torch.Tensor) -> torch.Tensor:
    """Per-band RGB constancy of the SH code ``[B, 27]`` (SH-major, 9 x 3)."""
    g = gamma.reshape(-1, 9, 3)
    return ((g - g.mean(2, keepdim=True)) ** 2).mean()


def skin_loss(vert_colors: torch.Tensor, skinmask: torch.Tensor) -> torch.Tensor:
    """Skin-colour constancy: the lit vertex colours ``[B, V, 3]`` (0..255)
    /255 pulled to their per-channel mean over the skin mask ``[V]``."""
    sm = skinmask.reshape(1, -1, 1).to(vert_colors.dtype)
    valid = sm.sum()
    colors = vert_colors / 255.0
    mean = (colors * sm).sum(1, keepdim=True) / valid
    return (((colors - mean) ** 2) * sm).sum() / (vert_colors.shape[0] * valid)


def regu_code_loss(iden_codes: torch.Tensor, expr_codes: torch.Tensor,
                   text_codes: torch.Tensor) -> torch.Tensor:
    """``2.5 * mean(c^2)`` per code group."""
    return ((iden_codes ** 2).mean() * 2.5 + (expr_codes ** 2).mean() * 2.5
            + (text_codes ** 2).mean() * 2.5)


def regu_cam_offset_loss(delta_euler: torch.Tensor, delta_tvec: torch.Tensor) -> torch.Tensor:
    """The camera offsets' mean squares."""
    return (delta_euler ** 2).mean() + (delta_tvec ** 2).mean()


class NL3DMMLoss:
    """The total fitting loss with its landmark weights and skin mask, on
    ``device``."""

    def __init__(self, skinmask=None, device="cpu"):
        self.lm_weight = torch.as_tensor(make_lm_weights(), device=device)
        self.skinmask = None if skinmask is None else torch.as_tensor(
            np.asarray(torch.as_tensor(skinmask).cpu(), np.float32).reshape(-1), device=device)

    def calc_total_loss(self, batch_vcs, cur_illus, rendered_imgs, gt_imgs, mask_c3d, proj_lm2ds,
                        gt_lm2ds, iden_codes, text_codes, expr_codes,
                        lm_w: float) -> Dict[str, torch.Tensor]:
        """The terms and ``total_loss`` = 10 img + lm_w lm + 0.01 illu +
        0.001 code + 0.1 skin."""
        img_loss = photo_loss(rendered_imgs, gt_imgs, mask_c3d)
        lm_loss = lm2d_loss(proj_lm2ds, gt_lm2ds, self.lm_weight)
        illu_loss = gamma_loss(cur_illus)
        code_loss = regu_code_loss(iden_codes, expr_codes, text_codes)
        sk_loss = (skin_loss(batch_vcs, self.skinmask) if self.skinmask is not None
                   else batch_vcs.new_zeros(()))
        total = (img_loss * 10.0 + lm_loss * lm_w + illu_loss * 0.01 + code_loss * 0.001
                 + sk_loss * 0.1)
        return {"img": img_loss, "lm": lm_loss, "illu_mean_loss": illu_loss, "code_regu": code_loss,
                "skin": sk_loss, "total_loss": total}
