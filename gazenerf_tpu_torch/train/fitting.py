"""Single-image fitting, prediction and gaze-code optimization.

The port's counterpart of the JAX package's ``train/fitting.py`` (upstream
``trainer/gazenerf_trainer.py``: ``train_single_image``,
``predict_single_image``, ``optimize_gaze_direction``).  The three
factories return closures over a :class:`FitState`, the model and its
per-sample offset tables:

* ``fit(state, batch) -> (fitted state, losses [n_steps])`` runs the
  training step on the network and the offsets together (upstream's
  parameter group holds both), with a fresh per-group Adam per call and no learning-rate decay
  inside a fit, the sample index pinned to 0 and jittered samples.  JAX's
  states are immutable; here a fit trains copies of the state's parameters
  and returns them, so the state it started from is unchanged to the bit
  and every protocol pair re-personalizes from the same base.  The losses
  stay on the device: a fit makes no host read.
* ``predict(state, batch, gaze_override=None) -> merge_img`` renders with
  no gradient and no jitter; ``gaze_override`` (``[2]``) redirects the
  gaze.
* ``optimize(state, batch, gaze_init) -> (best_gaze [2], best_loss,
  steps)`` runs Adam on the 2-vector gaze alone with early stopping: the
  forward takes no jitter but a gradient, which flows through the field
  backward into the conditioning rows and the eye planes' rotation and
  reaches the gaze alone (``torch.autograd.grad``: nothing accumulates in
  the parameters' ``.grad``).  The stop depends on the losses, so each step
  reads one scalar on the host.

With the fused field kernels a fit step launches K1 and K2 twice (once per
field branch), a prediction K1 twice, a gaze step K1 and K2 twice.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict

import numpy as np
import torch
from torch import nn

from gazenerf_tpu_torch.config import Config
from gazenerf_tpu_torch.losses.gazenerf_loss import compute_losses
from gazenerf_tpu_torch.models.gaze_nerf import GazeNeRF
from gazenerf_tpu_torch.ops.rays import pixel_grid
from gazenerf_tpu_torch.train.state import make_optimizer
from gazenerf_tpu_torch.train.trainer import (compose_codes_and_cams, decode_uint8_batch,
                                              make_train_step)

# the gaze optimization's Adam step (upstream and the JAX package)
GAZE_LR = 0.01


@dataclasses.dataclass
class FitState:
    """A model and its per-sample offset tables (``iden``, ``expr``,
    ``appea``, ``euler``, ``tvec``): what the JAX package's ``TrainState``
    is to its fitting loops.  ``seed`` seeds a fit's jitter draws, so two
    fits of one state draw alike."""

    model: GazeNeRF
    offsets: Dict[str, torch.Tensor]
    seed: int = 0

    @classmethod
    def of(cls, trainer) -> "FitState":
        """A trainer's model and offsets, not copied."""
        return cls(trainer.model, dict(trainer.offsets), trainer.cfg.train.seed)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def single_batch(batch, device) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy or tensors) on ``device``, images decoded to
    f32, the sample index pinned to 0 (the fitted offsets' row)."""
    b = decode_uint8_batch({k: torch.as_tensor(v).to(device) for k, v in batch.items()})
    b["sample_idx"] = torch.zeros_like(b["sample_idx"])
    return b


def single_image_loss(cfg: Config, frozen, expr_fix: torch.Tensor, model: GazeNeRF, offsets,
                      batch, gaze: torch.Tensor) -> torch.Tensor:
    """The gaze optimization's total loss of one prepared batch
    (:func:`single_batch`): the codes and cameras with ``offsets`` applied,
    the gaze replaced by ``gaze`` (``[2]``, broadcast over the batch), the
    render without jitter and the loss stack.  The graph is kept for the
    caller's gradient."""
    B = batch["image"].shape[0]
    xy = pixel_grid(cfg.model.featmap_size, device=batch["image"].device)[None].expand(B, -1, -1)
    sc, ac, _, R, T, K, ocd, dcam = compose_codes_and_cams(cfg, batch, offsets, expr_fix)
    gz = gaze.reshape(1, 2).expand(B, 2)
    pred = model(xy, sc, ac, gz, R, T, K, train=False)
    losses = compute_losses(
        cfg.loss, pred, batch["image"], batch["head_mask"][..., None],
        batch["left_eye_mask"][..., None], batch["right_eye_mask"][..., None],
        bg_value=1.0 if cfg.model.bg_type == "white" else 0.0,
        vgg_capture_fn=frozen.vgg_capture_fn(), opt_code_dict=ocd, delta_cam=dcam,
    )
    return losses["total_loss"]


def _expr(expr_fix, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(expr_fix, np.float32), device=device)


def _gaze(state: FitState, gaze) -> torch.Tensor:
    """A ``[2]`` gaze on the state's device, in its offsets' dtype."""
    return torch.as_tensor(gaze, dtype=state.offsets["iden"].dtype,
                           device=state.device).reshape(2)


def make_fit_single_image(cfg: Config, frozen, expr_fix: np.ndarray, n_steps: int):
    """``fit(state, batch, t_rand=None) -> (FitState, losses [n_steps])``:
    ``n_steps`` training steps (:func:`~gazenerf_tpu_torch.train.trainer.make_train_step`)
    on the network and the offsets of ONE image (row 0 of the tables), at
    ``cfg.train.lr`` times each group's multiplier.  The jitter is drawn from
    a generator seeded with ``state.seed``, or given as ``t_rand``
    ``[n_steps, B, R, S + 1]``.  The returned state holds copies; ``state``
    is not changed."""

    def fit(state: FitState, batch, t_rand=None):
        device = state.device
        model = copy.deepcopy(state.model)
        offsets = nn.ParameterDict({k: nn.Parameter(v.detach().clone())
                                    for k, v in state.offsets.items()})
        groups = {"net": list(model.parameters()), **{k: [p] for k, p in offsets.items()}}
        # a fresh optimizer per fit, no decay inside it (the JAX package's
        # steps_per_epoch=10**9)
        opt, sched = make_optimizer(cfg.train, 10**9, groups)
        step = make_train_step(cfg, model, opt, sched, frozen, expr_fix, offsets)
        generator = None if t_rand is not None else torch.Generator(
            device=device).manual_seed(state.seed)
        b = single_batch(batch, device)
        losses = [step(b, generator, None if t_rand is None else t_rand[i])["total_loss"]
                  for i in range(n_steps)]
        opt.zero_grad(set_to_none=True)
        fitted = FitState(model, {k: p.detach().requires_grad_(False) for k, p in offsets.items()},
                          state.seed)
        return fitted, torch.stack(losses) if losses else torch.zeros(0, device=device)

    return fit


def make_predict_single_image(cfg: Config, expr_fix: np.ndarray):
    """``predict(state, batch, gaze_override=None) -> merge_img [B, H, W,
    3]``: the render with the composed codes and cameras, no jitter, no
    gradient; ``gaze_override`` (``[2]``) redirects the gaze."""

    @torch.no_grad()
    def predict(state: FitState, batch, gaze_override=None):
        device = state.device
        b = single_batch(batch, device)
        B = b["image"].shape[0]
        xy = pixel_grid(cfg.model.featmap_size, device=device)[None].expand(B, -1, -1)
        sc, ac, gz, R, T, K, _, _ = compose_codes_and_cams(cfg, b, state.offsets,
                                                           _expr(expr_fix, device))
        if gaze_override is not None:
            gz = _gaze(state, gaze_override).reshape(1, 2).expand(B, 2)
        model = state.model
        fm = model.render_featmaps(xy, sc, ac, gz, R, T, K)["featmaps"]["merge"]
        return model.neural_render(fm)

    return predict


def make_optimize_gaze(cfg: Config, frozen, expr_fix: np.ndarray, max_steps: int = 500,
                       patience: int = 35):
    """``optimize(state, batch, gaze_init) -> (best_gaze [2], best_loss,
    steps)``: Adam(``GAZE_LR``, ``adam_b1``, ``adam_b2``) on the gaze alone from
    ``gaze_init``, no jitter, until ``patience`` steps in a row bring no
    improvement or ``max_steps`` steps ran.  As in the JAX package (and
    upstream), the best gaze is the one after the update taken from the
    point whose loss improved.  ``best_gaze`` and ``best_loss`` stay on the
    device; each step reads its loss on the host."""

    def optimize(state: FitState, batch, gaze_init):
        device = state.device
        b = single_batch(batch, device)
        expr = _expr(expr_fix, device)
        gaze = _gaze(state, gaze_init).clone().requires_grad_(True)
        opt = torch.optim.Adam([gaze], lr=GAZE_LR, betas=(cfg.train.adam_b1, cfg.train.adam_b2),
                               eps=1e-8)
        best_loss, best_loss_host = torch.tensor(float("inf"), device=device), float("inf")
        best_gaze = gaze.detach().clone()
        bad = steps = 0
        while bad <= patience and steps < max_steps:
            loss = single_image_loss(cfg, frozen, expr, state.model, state.offsets, b, gaze)
            (gaze.grad,) = torch.autograd.grad(loss, [gaze])
            opt.step()
            value = loss.item()  # the step's one host read
            if value < best_loss_host:
                best_loss, best_loss_host = loss.detach(), value
                best_gaze = gaze.detach().clone()
                bad = 0
            else:
                bad += 1
            steps += 1
        return best_gaze, best_loss, steps

    return optimize
