"""The GazeNeRF trainer: the training step and the host-side epoch loop.

Port of the JAX package's ``train/trainer.py``.  One step:

* the codes ``base + offset[sample_idx]`` and the perturbed camera
  ``R = dR(euler) @ R_base``, ``T = dR @ T_base + dT``, the intrinsics
  scaled from the image to the feature map and inverted;
* the forward render with stratified jitter (the fused field kernels when
  the fields run in bf16);
* the loss stack, its backward (the field gradient is the fused backward
  kernel), and the per-group Adam step with the per-epoch decay.

Losses stay on the device; :meth:`Trainer.train_epoch` reads them once per
epoch.  Not ported yet: the PatchGAN discriminator update and the angular
loss (``NotImplementedError``), ``steps_per_dispatch > 1`` (the JAX
package's ``lax.scan`` of several steps per dispatch), checkpoints and
logging.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from gazenerf_tpu_torch.config import Config
from gazenerf_tpu_torch.losses.gazenerf_loss import (
    check_ported,
    compute_losses,
    masked_mean,
    region_masks,
)
from gazenerf_tpu_torch.models.gaze_nerf import GazeNeRF, resolve_device
from gazenerf_tpu_torch.models.vgg import VGG16Features, vgg_features_from_torch
from gazenerf_tpu_torch.ops.rays import pixel_grid
from gazenerf_tpu_torch.ops.rotation import euler_to_rotation
from gazenerf_tpu_torch.train.state import make_offsets, make_optimizer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# decoded by name, not by dtype: reference data files also store ids as uint8
_UINT8_IMAGE_KEYS = frozenset(
    k
    for base in ("image", "head_mask", "left_eye_mask", "right_eye_mask")
    for k in (base, "target_" + base)
)


def decode_uint8_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """uint8 image and mask leaves -> f32 / 255; every other leaf as it is."""
    return {
        k: v.to(torch.float32) / 255.0
        if v.dtype == torch.uint8 and k in _UINT8_IMAGE_KEYS else v
        for k, v in batch.items()
    }


def scale_intrinsics(inmat: torch.Tensor, img_size: int, featmap_size: int) -> torch.Tensor:
    """Image intrinsics ``[..., 3, 3]`` -> inverse intrinsics at featmap
    resolution: rows 0-1 scaled by ``featmap / img``, inverted entry-wise
    (zero skew)."""
    t = inmat.clone()
    t[..., :2, :] *= featmap_size / img_size
    inv = torch.zeros_like(t)
    inv[..., 0, 0] = 1.0 / t[..., 0, 0]
    inv[..., 1, 1] = 1.0 / t[..., 1, 1]
    inv[..., 0, 2] = -(t[..., 0, 2] / t[..., 0, 0])
    inv[..., 1, 2] = -(t[..., 1, 2] / t[..., 1, 1])
    inv[..., 2, 2] = 1.0
    return inv


def compose_codes_and_cams(cfg: Config, batch, offsets, expr_fix: torch.Tensor):
    """Codes and cameras of a batch with the per-sample offsets applied.

    Returns ``(shape_code, appea_code, gaze_code, Rmats, Tvecs, inv_inmats,
    opt_code_dict, delta_cam)``."""
    m = cfg.model
    code = batch["code"]
    idx = batch["sample_idx"]
    iden_off = offsets["iden"][idx]
    expr_off = offsets["expr"][idx]
    appea_off = offsets["appea"][idx]
    euler_off = offsets["euler"][idx]
    tvec_off = offsets["tvec"][idx]

    base_iden = code[:, : m.iden_code_dims]
    base_text = code[:, m.shape_code_dims : m.shape_code_dims + m.text_code_dims]
    base_illu = code[:, m.shape_code_dims + m.text_code_dims :]
    # the expression is frozen to the shared fix vector plus its offset
    shape_code = torch.cat([base_iden + iden_off, expr_fix[None] + expr_off], dim=-1)
    appea_code = torch.cat([base_text, base_illu], dim=-1) + appea_off
    gaze_code = batch["pitchyaw"]

    dR = euler_to_rotation(euler_off)
    Rmats = torch.bmm(dR, batch["c2w_Rmat"])
    Tvecs = torch.bmm(dR, batch["c2w_Tvec"][..., None]) + tvec_off
    inv_inmats = scale_intrinsics(batch["inmat"], m.pred_img_size, m.featmap_size)

    opt_code_dict = {"bg": None, "iden": iden_off, "expr": expr_off, "appea": appea_off}
    delta_cam = {"delta_eulur": euler_off, "delta_tvec": tvec_off}
    return shape_code, appea_code, gaze_code, Rmats, Tvecs, inv_inmats, opt_code_dict, delta_cam


def _torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    sd = torch.load(path, map_location="cpu")
    if isinstance(sd, dict):
        sd = sd.get("model_state", sd.get("state_dict", sd))
    return {k.replace("module.", ""): v for k, v in sd.items()}


class FrozenNets:
    """The loss stack's frozen VGG16 (the gaze estimator of the angular
    loss is not ported yet).  ``cfg.loss.vgg_ckpt`` names a torchvision
    state dict; without it the net is random from ``seed``, numerically
    meaningless for a real run (tests and smoke runs only)."""

    def __init__(self, cfg: Config, device=None, seed: int = 0):
        self.vgg: Optional[VGG16Features] = None
        if not cfg.loss.use_vgg_loss:
            return
        self.vgg = VGG16Features(dtype=_DTYPES[cfg.loss.vgg_dtype])
        if cfg.loss.vgg_ckpt:
            sd = vgg_features_from_torch(_torch_state_dict(cfg.loss.vgg_ckpt))
            self.vgg.load_state_dict(sd, strict=True)
        else:
            logging.getLogger(__name__).warning(
                "VGG16 (perceptual loss) has NO checkpoint: random-initialized, "
                "numerically meaningless for a real training run"
            )
            self.vgg.reset_parameters(torch.Generator().manual_seed(seed))
        self.vgg.to(resolve_device(device)).requires_grad_(False).eval()

    def vgg_capture_fn(self) -> Optional[Callable]:
        return self.vgg


def _inputs(cfg: Config, batch, offsets, expr_fix, xy_grid):
    B = batch["image"].shape[0]
    xy = xy_grid[None].expand(B, -1, -1)
    sc, ac, gz, R, T, K, opt_code_dict, delta_cam = compose_codes_and_cams(
        cfg, batch, offsets, expr_fix
    )
    return (xy, sc, ac, gz, R, T, K), opt_code_dict, delta_cam


def make_train_step(
    cfg: Config,
    model: GazeNeRF,
    optimizer: torch.optim.Optimizer,
    scheduler,
    frozen: FrozenNets,
    expr_fix: np.ndarray,
    offsets,
):
    """The training step ``step(batch, generator=None, t_rand=None,
    update=True) -> losses``: ``batch`` holds device tensors; the jitter is
    drawn from ``generator`` or given as ``t_rand``.  With ``update=False``
    it stops after the backward (the gradients are left in ``.grad``).
    The losses are detached device scalars."""
    m = cfg.model
    device = next(model.parameters()).device
    xy_grid = pixel_grid(m.featmap_size, device=device)
    expr = torch.as_tensor(np.asarray(expr_fix, np.float32), device=device)
    bg_value = 1.0 if m.bg_type == "white" else 0.0

    def step(batch, generator=None, t_rand=None, update=True):
        batch = decode_uint8_batch(batch)
        args, opt_code_dict, delta_cam = _inputs(cfg, batch, offsets, expr, xy_grid)
        pred = model(*args, train=True, generator=generator, t_rand=t_rand)
        losses = compute_losses(
            cfg.loss, pred, batch["image"],
            batch["head_mask"][..., None],
            batch["left_eye_mask"][..., None],
            batch["right_eye_mask"][..., None],
            bg_value=bg_value,
            vgg_capture_fn=frozen.vgg_capture_fn(),
            opt_code_dict=opt_code_dict,
            delta_cam=delta_cam,
        )
        optimizer.zero_grad(set_to_none=True)
        losses["total_loss"].backward()
        if update:
            optimizer.step()
            scheduler.step()
        return {k: v.detach() for k, v in losses.items()}

    return step


def make_eval_step(cfg: Config, model: GazeNeRF, expr_fix: np.ndarray, offsets):
    """Forward render (no jitter, no gradient) and per-region L2 metrics:
    ``eval(batch) -> (metrics, coarse_dict)``."""
    m = cfg.model
    device = next(model.parameters()).device
    xy_grid = pixel_grid(m.featmap_size, device=device)
    expr = torch.as_tensor(np.asarray(expr_fix, np.float32), device=device)

    @torch.no_grad()
    def evaluate(batch):
        batch = decode_uint8_batch(batch)
        args, _, _ = _inputs(cfg, batch, offsets, expr, xy_grid)
        pred = model(*args)
        img = pred["coarse_dict"]["merge_img"].to(torch.float32)
        gt = batch["image"]
        mse = ((img - gt) ** 2).mean()
        out = {"mse": mse, "psnr": -10.0 * torch.log10(mse + 1e-10)}
        masks = region_masks(
            batch["head_mask"][..., None],
            batch["left_eye_mask"][..., None],
            batch["right_eye_mask"][..., None],
        )
        err = (img - gt) ** 2
        for name, m_ in masks.items():
            out[f"{name}_mse"] = masked_mean(err, m_)
        return out, pred["coarse_dict"]

    return evaluate


class Trainer:
    """The host-side loop around the training step, over any iterable of numpy
    batch dicts (the JAX loader's format: ``image`` ``[B, H, W, 3]``, the
    three masks ``[B, H, W]``, ``code`` ``[B, 306]``, ``sample_idx``,
    ``pitchyaw``, ``c2w_Rmat``, ``c2w_Tvec``, ``inmat``).  Runs on the CUDA
    card unless ``device`` says otherwise."""

    def __init__(
        self,
        cfg: Config,
        train_len: int,
        steps_per_epoch: int,
        expr_fix: Optional[np.ndarray] = None,
        seed: Optional[int] = None,
        device=None,
    ):
        if cfg.train.steps_per_dispatch > 1:
            raise NotImplementedError(
                "steps_per_dispatch > 1 (several steps per dispatch) is not ported yet"
            )
        check_ported(cfg.loss)
        self.cfg = cfg
        self.device = resolve_device(device)
        seed = cfg.train.seed if seed is None else seed
        self.model = GazeNeRF(cfg.model, device=self.device, seed=seed)
        self.frozen = FrozenNets(cfg, self.device, seed=seed + 1)
        self.offsets = make_offsets(train_len, self.device)
        groups = {"net": list(self.model.parameters()),
                  **{k: [p] for k, p in self.offsets.items()}}
        self.optimizer, self.scheduler = make_optimizer(cfg.train, steps_per_epoch, groups)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.expr_fix = (
            np.zeros(cfg.model.expr_code_dims, np.float32)
            if expr_fix is None else np.asarray(expr_fix, np.float32)
        )
        self.step = 0
        self._step = make_train_step(
            cfg, self.model, self.optimizer, self.scheduler, self.frozen,
            self.expr_fix, self.offsets,
        )
        self.eval_step = make_eval_step(cfg, self.model, self.expr_fix, self.offsets)
        self.history = []

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {
            k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v)))
            .to(self.device, non_blocking=True)
            for k, v in batch.items()
        }

    def train_step(self, batch, t_rand: Optional[torch.Tensor] = None,
                   update: bool = True) -> Dict[str, torch.Tensor]:
        """One step on a numpy (or tensor) batch; the jitter comes from the
        trainer's generator unless ``t_rand`` is given.  Returns the losses
        as device scalars (no host sync)."""
        losses = self._step(self.to_device(batch), generator=self.generator,
                            t_rand=t_rand, update=update)
        if update:
            self.step += 1
        return losses

    def train_epoch(self, batches: Iterable, epoch: int) -> Dict[str, float]:
        """One epoch; the per-step losses stay on the device and are summed
        in one host sync at the end."""
        t0 = time.time()
        parts = []
        for b in batches:
            parts.append(self.train_step(b)["total_loss"])
        total = float(torch.stack(parts).sum()) if parts else 0.0
        n = len(parts)
        summary = {"epoch": epoch, "loss": total / max(n, 1), "batches": n,
                   "seconds": time.time() - t0}
        self.history.append(summary)
        return summary
