"""Logging: stdlib logging to a file and stdout, and optional wandb.

The port's own copy of what the JAX package's ``utils/logging.py`` gives
the training and evaluation CLIs and the trainer (upstream
``utils/logging.py``).  wandb is
optional: absent or not asked for, its calls are no-ops.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Dict, Optional


def configure_logging(log_file: Optional[str] = None, level=logging.INFO) -> None:
    """Log to stdout and, given ``log_file``, to that file too."""
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=handlers,
        force=True,
    )


def maybe_wandb_init(enabled: bool, **kwargs):
    """The initialised ``wandb`` module, or None when not asked for or not
    installed (the run carries on without it)."""
    if not enabled:
        return None
    try:
        import wandb
    except ImportError:
        logging.getLogger(__name__).warning(
            "wandb requested but not installed; continuing without it")
        return None
    wandb.init(project="gazenerf_tpu", **kwargs)
    return wandb


# the loss dict's key -> the upstream wandb scalar name, and the flag of the
# loss config that gates it ("" = always logged)
_LOSS_KEY_TABLE = (
    ("total_loss", "Total Loss Batch", ""),
    ("vgg_face_loss", "VGG Face Loss Batch", "use_vgg_loss"),
    ("vgg", "VGG Loss Batch", "use_vgg_loss"),
    ("gen_patch_gan_loss", "Generator Patch GAN Loss Batch", "use_patch_gan_loss"),
    ("disc_patch_gan_loss", "Discriminator Patch GAN Loss Batch", "use_patch_gan_loss"),
    ("angular", "Angular Loss Batch", "use_angular_loss"),
    ("eyes_loss", "Eye Region Loss Batch", "use_angular_loss"),
    ("head_loss", "Head Loss Batch", ""),
    ("iden_code", "Iden Code Loss Batch", ""),
    ("expr_code", "Expr Code Loss Batch", ""),
    ("appea_code", "Appea Code Loss Batch", ""),
    ("bg_code", "BG Code Loss Batch", ""),
    ("bg_loss", "BG Loss Batch", ""),
    ("face_loss", "Face Loss Batch", ""),
    ("eyes_loss", "Eyes Loss Batch", ""),
    ("nonhead_loss", "Non Head Loss Batch", ""),
    ("delta_eular", "Delta Eular Loss Batch", ""),
    ("delta_tvec", "Delta Tvec Loss Batch", ""),
)


def log_losses(wandb, loss_dict, loss_cfg, epoch: int = 0, prefix: str = "TRAIN ") -> None:
    """The per-loss scalars under the upstream wandb names, gated by the
    loss config's flags, in one ``wandb.log`` (the values may be device
    scalars: this is where they are read)."""
    if wandb is None:
        return
    out = {}
    for key, name, flag in _LOSS_KEY_TABLE:
        if key not in loss_dict or (flag and not getattr(loss_cfg, flag, False)):
            continue
        if name == "Head Loss Batch" and epoch <= -1:
            continue  # upstream logs the head loss from epoch 0 on
        out[prefix + name] = float(loss_dict[key])
    wandb.log(out)


# a protocol result's key -> the upstream wandb scalar name
_EVAL_NAMES = {
    "gaze_angular_deg": "Angular Error",
    "head_angular_deg": "Angular Head Error",
    "ssim": "SSIM",
    "psnr": "PSNR",
    "lpips": "LPIPS",
    "l1": "L1 Distance",
    "fid": "FID",
    "identity_similarity": "Similarity",
}


def log_subject_eval_results(wandb, subject_metrics: Dict[str, float],
                             prefix: str = "Subject ") -> None:
    """One subject's (or a dataset's) protocol metrics under the upstream
    wandb names, in one ``wandb.log``; metrics the result lacks are left
    out."""
    if wandb is None:
        return
    wandb.log({prefix + label: float(subject_metrics[key])
               for key, label in _EVAL_NAMES.items() if key in subject_metrics})
