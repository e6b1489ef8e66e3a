"""The GazeNeRF training loss, static-shape.

Port of the JAX package's ``losses/gazenerf_loss.py``: per-region L1 (or
L2) losses, background and non-head constancy, the VGG16 perceptual loss
(in two batched calls, or six with ``vgg_batched=False``), the angular gaze
loss through the frozen gaze estimator, the PatchGAN generator loss with
its warm-up, and the camera and code regularisers.  Every masked mean is
``sum(x * mask) / sum(mask)``, the value and gradient of upstream's boolean
gather.  Images are NHWC in [0, 1]; masks ``[B, H, W, 1]`` floats.

The GAN labels are upstream's, inverted: the discriminator takes real to 0
and fake to 1, and the generator drives fake toward 0.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gazenerf_tpu_torch.config import LossConfig
from gazenerf_tpu_torch.eval.metrics import angular_error_deg, pitchyaw_to_vector
from gazenerf_tpu_torch.models.vgg import normalize_imagenet
from gazenerf_tpu_torch.ops.image import resize_bilinear


def masked_mean(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``err`` over the pixels where ``mask`` is 1 (the mask
    broadcast over channels)."""
    mask3 = torch.broadcast_to(mask, err.shape)
    denom = torch.clamp(mask3.sum(), min=1.0)
    return (err * mask3).sum() / denom


def region_masks(
    head_mask: torch.Tensor,
    left_eye_mask: torch.Tensor,
    right_eye_mask: torch.Tensor,
    full_eye_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Region decomposition into {0, 1} float masks ``[B, H, W, 1]``;
    ``full_eye_mask`` defaults to zeros, as upstream's dataset sets it."""
    if full_eye_mask is None:
        full_eye_mask = torch.zeros_like(head_mask)
    head = (head_mask >= 0.5) & (full_eye_mask < 0.5)
    face = (head_mask >= 0.5) & (left_eye_mask < 0.5) & (right_eye_mask < 0.5)
    eyes = (left_eye_mask >= 0.5) | (right_eye_mask >= 0.5)
    nonhead = head_mask < 0.5
    f = lambda m: m.to(torch.float32)  # noqa: E731
    return {"head": f(head), "face": f(face), "eyes": f(eyes), "nonhead": f(nonhead)}


def gan_bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean binary cross-entropy with logits against a constant label, in
    the stable form ``max(x, 0) - x t + log1p(exp(-|x|))``."""
    return (torch.clamp(logits, min=0.0) - logits * target
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def discriminator_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """The discriminator's loss: fake toward 1, real toward 0 (upstream's
    inverted labels)."""
    return 0.5 * (gan_bce_with_logits(fake_logits, 1.0) + gan_bce_with_logits(real_logits, 0.0))


def generator_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """The generator's loss: fake toward 0."""
    return gan_bce_with_logits(fake_logits, 0.0)


def gan_warmup(cfg: LossConfig, step: int) -> float:
    """The generator term's weight at ``step``: ``clip(step /
    gan_warmup_steps, 0, gan_warmup_cap)``, in f32 as the JAX package
    computes it."""
    warm = np.float32(step) / np.float32(cfg.gan_warmup_steps)
    return float(np.clip(warm, np.float32(0.0), np.float32(cfg.gan_warmup_cap)))


def vgg_perceptual_distance(vgg_capture_fn: Callable, a: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """Sum over the captured VGG16 blocks of the mean L1 distance between
    the features of ``a`` and ``b`` (ImageNet-normalised, 224-resized by
    the caller)."""
    fa, fb = vgg_capture_fn(a), vgg_capture_fn(b)
    return sum((x - y).abs().to(torch.float32).mean() for x, y in zip(fa, fb))


def gaze_angular_distance(gaze_fn: Callable, pred_img: torch.Tensor,
                          gt_img: torch.Tensor) -> torch.Tensor:
    """Mean angular error in degrees between the gaze estimated on the
    prediction and on the target; no gradient flows through the target's
    estimate (inputs normalised and resized by the caller)."""
    gaze_pred, _ = gaze_fn(pred_img)
    with torch.no_grad():
        gaze_gt, _ = gaze_fn(gt_img)
    return angular_error_deg(pitchyaw_to_vector(gaze_gt), pitchyaw_to_vector(gaze_pred)).mean()


def compute_losses(
    cfg: LossConfig,
    pred: Dict,
    gt_rgb: torch.Tensor,
    head_mask: torch.Tensor,
    left_eye_mask: torch.Tensor,
    right_eye_mask: torch.Tensor,
    *,
    bg_value: float = 1.0,
    eye_loss_importance: Optional[float] = None,
    vgg_capture_fn: Optional[Callable[[torch.Tensor], List[torch.Tensor]]] = None,
    gaze_fn: Optional[Callable] = None,
    disc_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    opt_code_dict: Optional[Dict] = None,
    delta_cam: Optional[Dict] = None,
    step: int = 0,
) -> Dict[str, torch.Tensor]:
    """The data and regulariser losses; ``total_loss`` is the training
    target.  ``vgg_capture_fn(x)`` returns the captured VGG16 features of a
    ``[N, 224, 224, 3]`` ImageNet-normalised batch; ``gaze_fn(x)`` the gaze
    estimator's ``(gaze, head)`` of one; ``disc_fn(x)`` the discriminator's
    logits of a ``[N, 224, 224, 3]`` batch in [0, 1].  The angular term is
    scaled by ``angular_scale`` and ``eye_loss_importance`` (the config's
    unless given); the generator term by :func:`gan_warmup` of ``step``."""
    eye_imp = cfg.eye_loss_importance if eye_loss_importance is None else eye_loss_importance
    cd = pred["coarse_dict"] if "coarse_dict" in pred else pred
    res_img = cd["merge_img"]
    res_face = cd["merge_img_face"]
    res_eyes = cd["merge_img_eyes"]
    bg_img = cd["bg_img"]

    masks = region_masks(head_mask, left_eye_mask, right_eye_mask)

    def pix_err(a, b):
        d = a - b
        return d.abs() if cfg.use_l1_loss else d * d

    losses: Dict[str, torch.Tensor] = {}
    losses["bg_loss"] = ((bg_img - bg_value) ** 2).mean()
    losses["head_loss"] = masked_mean(pix_err(res_img, gt_rgb), masks["head"])
    losses["face_loss"] = masked_mean(pix_err(res_face, gt_rgb), masks["face"])
    losses["eyes_loss"] = masked_mean(pix_err(res_eyes, gt_rgb), masks["eyes"])
    losses["nonhead_loss"] = masked_mean((res_img - bg_value) ** 2, masks["nonhead"])

    def prep(img):
        return resize_bilinear(normalize_imagenet(img), (224, 224))

    # the target with the background colour off the head
    gt_head = torch.where(torch.broadcast_to(masks["nonhead"], gt_rgb.shape) > 0,
                          bg_value, gt_rgb)

    if cfg.use_vgg_loss and vgg_capture_fn is not None:

        def keep(m, img):  # img where the mask is set, the background elsewhere
            return torch.where(torch.broadcast_to(m, gt_rgb.shape) > 0, img, bg_value)

        gt_face = keep(masks["face"], gt_rgb)
        gt_eyes = keep(masks["eyes"], gt_rgb)
        if cfg.vgg_batched:
            # two 3B-row calls: the pred rows with gradient, the gt rows without
            B = gt_rgb.shape[0]
            fp = vgg_capture_fn(torch.cat([prep(x) for x in (res_face, res_eyes, res_img)], 0))
            with torch.no_grad():
                fg = vgg_capture_fn(torch.cat([prep(x) for x in (gt_face, gt_eyes, gt_head)], 0))

            def dist(i):
                a = i * B
                return sum(
                    (p[a : a + B] - g[a : a + B]).abs().to(torch.float32).mean()
                    for p, g in zip(fp, fg)
                )

            losses["vgg_face_loss"] = dist(0)
            losses["vgg_eyes_loss"] = dist(1)
            losses["vgg"] = dist(2) * cfg.vgg_importance
        else:  # six calls, one per image
            losses["vgg_face_loss"] = vgg_perceptual_distance(
                vgg_capture_fn, prep(res_face), prep(gt_face))
            losses["vgg_eyes_loss"] = vgg_perceptual_distance(
                vgg_capture_fn, prep(res_eyes), prep(gt_eyes))
            losses["vgg"] = vgg_perceptual_distance(
                vgg_capture_fn, prep(res_img), prep(gt_head)) * cfg.vgg_importance

    if cfg.use_angular_loss and gaze_fn is not None:
        losses["angular"] = (gaze_angular_distance(gaze_fn, prep(res_img), prep(gt_head))
                             * cfg.angular_scale * eye_imp)

    if cfg.use_patch_gan_loss and disc_fn is not None:
        fake_logits = disc_fn(resize_bilinear(res_img, (224, 224)))
        losses["gen_patch_gan_loss"] = generator_loss(fake_logits) * gan_warmup(cfg, step)

    total = sum(losses.values())

    if delta_cam is not None:
        losses["delta_eular"] = (delta_cam["delta_eulur"] ** 2).mean()
        losses["delta_tvec"] = (delta_cam["delta_tvec"] ** 2).mean()
        total = total + cfg.w_cam_delta * (losses["delta_eular"] + losses["delta_tvec"])

    if opt_code_dict is not None:
        losses["iden_code"] = (opt_code_dict["iden"] ** 2).mean()
        losses["expr_code"] = (opt_code_dict["expr"] ** 2).mean()
        losses["appea_code"] = (opt_code_dict["appea"] ** 2).mean()
        bg_code = opt_code_dict.get("bg")
        losses["bg_code"] = (
            (bg_code**2).mean() if bg_code is not None
            else torch.zeros((), device=gt_rgb.device)
        )
        total = total + (
            cfg.w_iden_code * losses["iden_code"]
            + cfg.w_expr_code * losses["expr_code"]
            + cfg.w_appea_code * losses["appea_code"]
            + cfg.w_bg_code * losses["bg_code"]
        )

    losses["total_loss"] = total
    return losses
