"""Trainable state: the per-sample offset tables and the per-group Adam.

Port of the JAX package's ``train/state.py``.  The five per-sample latent
offset tables (iden 100 / expr 79 / appea 127 / delta-Euler 3 / delta-Tvec
3 per training image) are dense parameters gathered by sample id, so their
gradients are dense and rows never gathered keep a zero gradient.  The
optimizer is one ``torch.optim.Adam`` with six parameter groups (net x1,
iden x1, expr x0.1, appea x1, euler x0.1, tvec x0.1) and a per-step
``LambdaLR`` reproducing upstream's per-epoch decay; optax's
``scale_by_adam`` (eps 1e-8, bias-corrected) and torch's Adam compute the
same update.  The PatchGAN discriminator has its own Adam at a constant
learning rate with L2 weight decay (:func:`make_disc_optimizer`).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch
from torch import nn

from gazenerf_tpu_torch.config import TrainConfig

OFFSET_WIDTHS = {"iden": (100,), "expr": (79,), "appea": (127,), "euler": (3,), "tvec": (3, 1)}


def make_offsets(train_len: int, device=None) -> nn.ParameterDict:
    """Zero-initialised per-sample offset tables."""
    return nn.ParameterDict({
        k: nn.Parameter(torch.zeros((train_len,) + w, dtype=torch.float32, device=device))
        for k, w in OFFSET_WIDTHS.items()
    })


def _decay(cfg: TrainConfig, steps_per_epoch: int):
    """The per-step factor ``0.1 ** (epoch / step_decay)``, ``epoch = step //
    steps_per_epoch``."""
    spe = max(steps_per_epoch, 1)
    return lambda step: 0.1 ** ((step // spe) / cfg.step_decay)


def lr_schedule(cfg: TrainConfig, steps_per_epoch: int, mult: float):
    """Per-step learning rate ``lr * mult * 0.1 ** (epoch / step_decay)``."""
    decay = _decay(cfg, steps_per_epoch)
    return lambda step: cfg.lr * mult * decay(step)


def make_optimizer(
    cfg: TrainConfig, steps_per_epoch: int, groups: Dict[str, Iterable[torch.Tensor]]
) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam over ``groups`` (``{"net", "iden", "expr", "appea", "euler",
    "tvec"}`` -> parameters), each at ``lr * multiplier``, and the per-step
    decay; call ``scheduler.step()`` after every ``optimizer.step()``."""
    if cfg.optimizer != "adam":
        raise NotImplementedError(f"optimizer={cfg.optimizer!r} is not ported yet")
    mults = {
        "net": 1.0,
        "iden": cfg.lr_mult_iden,
        "expr": cfg.lr_mult_expr,
        "appea": cfg.lr_mult_appea,
        "euler": cfg.lr_mult_euler,
        "tvec": cfg.lr_mult_tvec,
    }
    opt = torch.optim.Adam(
        [{"params": list(groups[k]), "lr": cfg.lr * m, "name": k} for k, m in mults.items()],
        lr=cfg.lr, betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8,
    )
    # each group's lr: lr * multiplier * the decay, i.e. lr_schedule
    sched = torch.optim.lr_scheduler.LambdaLR(opt, _decay(cfg, steps_per_epoch))
    return opt, sched


def make_disc_optimizer(cfg: TrainConfig, params: Iterable[torch.Tensor]) -> torch.optim.Adam:
    """The discriminator's Adam: ``disc_lr_weight_decay`` times the
    parameters added to their gradients before Adam (optax's
    ``add_decayed_weights`` then ``scale_by_adam``: L2, not AdamW), then
    the constant ``lr``, with the network's betas."""
    return torch.optim.Adam(list(params), lr=cfg.lr, betas=(cfg.adam_b1, cfg.adam_b2),
                            eps=1e-8, weight_decay=cfg.disc_lr_weight_decay)
