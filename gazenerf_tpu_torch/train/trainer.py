"""The GazeNeRF trainer: the training step and the host-side epoch loop.

Port of the JAX package's ``train/trainer.py``.  One step, in the JAX
step's order:

* the codes ``base + offset[sample_idx]`` and the perturbed camera
  ``R = dR(euler) @ R_base``, ``T = dR @ T_base + dT``, the intrinsics
  scaled from the image to the feature map and inverted;
* one forward render with stratified jitter (the fused field kernels when
  the fields run in bf16);
* with ``use_patch_gan_loss``, the PatchGAN update on the detached,
  224-resized merged image against the target filled with 1.0 off the head
  (real first, then fake, both normalised by their batch, so the
  BatchNorm statistics move twice), then the generator term read through
  the updated discriminator with its running statistics;
* the loss stack (VGG16 perceptual, the angular gaze loss through the
  frozen gaze-VGG, the generator term with its warm-up), one backward for
  the network and the offsets (the field gradient is the fused backward
  kernel), and the per-group Adam step with the per-epoch decay.

Losses stay on the device; :meth:`Trainer.train_epoch` reads them once per
epoch (and once per dispatch when it logs to wandb, with the image strip
every ``log_images_every`` dispatches).  On a ``mesh`` (``parallel/``)
each of its processes runs its rows and rays of the step, and the step's
collectives make them compute the single-device step on the global batch
(``parallel/sharding.py``).  With ``steps_per_dispatch = K >
1`` it stacks K loader batches into one copy to the card and runs their K
steps from it, the remainder one batch at a time: the numbers are K = 1's.
With ``is_gradual_loss`` the eye importance is ``eye_loss_importance + 30 *
epoch``.  :meth:`Trainer.eval_epoch` takes per-region metrics with one
read; :meth:`Trainer.fit` trains epochs with checkpoints
(``train/checkpoint.py``).
"""

from __future__ import annotations

import copy
import csv
import logging
import os
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from gazenerf_tpu_torch.config import Config
from gazenerf_tpu_torch.data.h5_dataset import device_prefetch, stack_batches
from gazenerf_tpu_torch.losses.gazenerf_loss import (
    compute_losses,
    discriminator_loss,
    masked_mean,
    region_masks,
)
from gazenerf_tpu_torch.models.discriminator import PatchGAN
from gazenerf_tpu_torch.models.gaze_nerf import GazeNeRF, resolve_device
from gazenerf_tpu_torch.models.vgg import (
    GazeVGG,
    VGG16Features,
    gaze_vgg_from_torch,
    vgg_features_from_torch,
)
from gazenerf_tpu_torch.ops.image import resize_bilinear
from gazenerf_tpu_torch.ops.rays import pixel_grid
from gazenerf_tpu_torch.ops.rotation import euler_to_rotation
from gazenerf_tpu_torch.parallel import sharding
from gazenerf_tpu_torch.train.state import make_disc_optimizer, make_offsets, make_optimizer

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


def torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint's state dict (under ``model_state`` or
    ``state_dict`` where it nests one), its ``module.`` prefixes dropped."""
    sd = torch.load(path, map_location="cpu")
    if isinstance(sd, dict):
        sd = sd.get("model_state", sd.get("state_dict", sd))
    return {k.replace("module.", ""): v for k, v in sd.items()}


def _warn_random(which: str) -> None:
    logging.getLogger(__name__).warning(
        "%s has NO checkpoint: random-initialized, numerically meaningless for a real "
        "training run", which)


class FrozenNets:
    """The loss stack's frozen nets: the perceptual loss's VGG16
    (``use_vgg_loss``) and the angular loss's gaze-VGG
    (``use_angular_loss``).  ``cfg.loss.vgg_ckpt`` names a torchvision
    state dict, ``cfg.loss.gaze_ckpt`` upstream's ``gaze_network`` one
    (under ``model_state``); without one a net is random from ``seed`` (the
    gaze-VGG from ``seed + 1``), numerically meaningless for a real run
    (tests and smoke runs only).  Both run in eval mode without
    gradients of their own."""

    def __init__(self, cfg: Config, device=None, seed: int = 0):
        self.vgg: Optional[VGG16Features] = None
        self.gaze: Optional[GazeVGG] = None
        device = resolve_device(device)
        dtype = _DTYPES[cfg.loss.vgg_dtype]
        if cfg.loss.use_vgg_loss:
            self.vgg = VGG16Features(dtype=dtype)
            if cfg.loss.vgg_ckpt:
                sd = vgg_features_from_torch(torch_state_dict(cfg.loss.vgg_ckpt))
                self.vgg.load_state_dict(sd, strict=True)
            else:
                _warn_random("VGG16 (perceptual loss)")
                self.vgg.reset_parameters(torch.Generator().manual_seed(seed))
            self.vgg.to(device).requires_grad_(False).eval()
        if cfg.loss.use_angular_loss:
            self.gaze = GazeVGG(dtype=dtype)
            if cfg.loss.gaze_ckpt:
                sd = gaze_vgg_from_torch(torch_state_dict(cfg.loss.gaze_ckpt))
                self.gaze.load_state_dict(sd, strict=True)
            else:
                _warn_random("gaze-VGG (angular loss)")
                self.gaze.reset_parameters(torch.Generator().manual_seed(seed + 1))
            self.gaze.to(device).requires_grad_(False).eval()

    def vgg_capture_fn(self) -> Optional[Callable]:
        return self.vgg

    def gaze_fn(self) -> Optional[Callable]:
        return self.gaze


def _inputs(cfg: Config, batch, offsets, expr_fix, xy_grid):
    B = batch["image"].shape[0]
    xy = xy_grid[None].expand(B, -1, -1)
    sc, ac, gz, R, T, K, opt_code_dict, delta_cam = compose_codes_and_cams(
        cfg, batch, offsets, expr_fix
    )
    return (xy, sc, ac, gz, R, T, K), opt_code_dict, delta_cam


def discriminator_step(disc: PatchGAN, disc_optimizer: torch.optim.Optimizer,
                       merge_img: torch.Tensor, gt: torch.Tensor,
                       head_mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """One PatchGAN update: the detached prediction (fake) and the target
    filled with 1.0 off the head (real), both resized to 224, through the
    discriminator in training mode, real first; its loss's backward and its
    Adam step.  Returns the loss, detached.  The discriminator's parameters
    take gradients only here: they are frozen again on the way out, so the
    generator's backward through it leaves them none.  On a ``mesh`` its
    BatchNorm takes the whole batch's statistics and its gradients are
    reduced as the generator's (``parallel/sharding.py``)."""
    fake = resize_bilinear(merge_img.detach(), (224, 224))
    real = resize_bilinear(torch.where(torch.broadcast_to(head_mask < 0.5, gt.shape), 1.0, gt),
                           (224, 224))
    sync = None if mesh is None else (lambda st: sharding.batch_stats(mesh, st))  # noqa: E731
    disc.requires_grad_(True)
    try:
        disc_optimizer.zero_grad(set_to_none=True)
        real_logits = disc(real, train=True, sync=sync)
        d_loss = discriminator_loss(real_logits, disc(fake, train=True, sync=sync))
        if mesh is None:
            d_loss.backward()
        else:
            (d_loss * sharding.loss_scale(mesh)).backward()
            sharding.reduce_gradients(mesh, disc.parameters())
        disc_optimizer.step()
    finally:
        disc.requires_grad_(False)
    return d_loss.detach()


def make_train_step(
    cfg: Config,
    model: GazeNeRF,
    optimizer: torch.optim.Optimizer,
    scheduler,
    frozen: FrozenNets,
    expr_fix: np.ndarray,
    offsets,
    disc: Optional[PatchGAN] = None,
    disc_optimizer: Optional[torch.optim.Optimizer] = None,
    mesh=None,
):
    """The training step ``step(batch, generator=None, t_rand=None,
    update=True, eye_imp=None, step_count=0) -> losses``: ``batch`` holds
    device tensors; the jitter is drawn from ``generator`` or given as
    ``t_rand``; ``eye_imp`` is the eye importance (the config's if None),
    ``step_count`` the step the generator term's warm-up reads.  With
    ``update=False`` it stops after the backward (the network's and the
    offsets' gradients are left in ``.grad``); the discriminator (with
    ``disc``) is updated all the same, as the generator term reads the
    updated one.  The losses are detached device scalars.

    On a ``mesh`` ``batch`` holds the process's rows, ``t_rand`` (if given)
    the global batch's draws, and the step runs the process's rays; the
    losses are the global batch's and the gradients left in ``.grad`` are
    reduced over the processes (``parallel/sharding.py``)."""
    m = cfg.model
    device = next(model.parameters()).device
    xy_grid = pixel_grid(m.featmap_size, device=device)
    denominators = None
    if mesh is not None:
        xy_grid = xy_grid[sharding.ray_slice(mesh, m.num_rays)]
        denominators = lambda sums: sharding.mask_denominators(mesh, sums)  # noqa: E731
    params = [*model.parameters(), *offsets.values()]
    expr = torch.as_tensor(np.asarray(expr_fix, np.float32), device=device)
    bg_value = 1.0 if m.bg_type == "white" else 0.0
    gan = disc is not None and cfg.loss.use_patch_gan_loss

    def step(batch, generator=None, t_rand=None, update=True, eye_imp=None, step_count=0):
        batch = decode_uint8_batch(batch)
        args, opt_code_dict, delta_cam = _inputs(cfg, batch, offsets, expr, xy_grid)
        gt, hm = batch["image"], batch["head_mask"][..., None]
        if mesh is not None and t_rand is not None:
            t_rand = sharding.local_block(mesh, t_rand)
        pred = model(*args, train=True, generator=generator, t_rand=t_rand)
        disc_fn = d_loss = None
        if gan:
            d_loss = discriminator_step(disc, disc_optimizer, pred["coarse_dict"]["merge_img"],
                                        gt, hm, mesh)
            disc_fn = lambda img: disc(img, train=False)  # noqa: E731
        losses = compute_losses(
            cfg.loss, pred, gt, hm,
            batch["left_eye_mask"][..., None],
            batch["right_eye_mask"][..., None],
            bg_value=bg_value,
            eye_loss_importance=eye_imp,
            vgg_capture_fn=frozen.vgg_capture_fn(),
            gaze_fn=frozen.gaze_fn(),
            disc_fn=disc_fn,
            opt_code_dict=opt_code_dict,
            delta_cam=delta_cam,
            step=step_count,
            mask_denominators=denominators,
        )
        if d_loss is not None:
            losses["disc_patch_gan_loss"] = d_loss
        optimizer.zero_grad(set_to_none=True)
        if mesh is None:
            losses["total_loss"].backward()
        else:
            (losses["total_loss"] * sharding.loss_scale(mesh)).backward()
            # the logged losses: the mean over the processes is the global
            # batch's, reduced in the gradients' collective
            dt = losses["total_loss"].dtype
            vec = torch.stack([v.detach().to(dt) for v in losses.values()])
            vec = sharding.reduce_gradients(mesh, params, extra=vec) / mesh.size
            losses = {k: x.to(v.dtype) for (k, v), x in zip(losses.items(), vec.unbind(0))}
        if update:
            optimizer.step()
            scheduler.step()
        return {k: v.detach() for k, v in losses.items()}

    return step


def make_eval_step(cfg: Config, model: GazeNeRF, expr_fix: np.ndarray, offsets, mesh=None):
    """Forward render (no jitter, no gradient) and per-region L2 metrics:
    ``eval(batch) -> (metrics, coarse_dict)``; on a ``mesh``, of the
    process's rows (the model marches its rays and gathers them)."""
    m = cfg.model
    device = next(model.parameters()).device
    xy_grid = pixel_grid(m.featmap_size, device=device)
    if mesh is not None:
        xy_grid = xy_grid[sharding.ray_slice(mesh, m.num_rays)]
    expr = torch.as_tensor(np.asarray(expr_fix, np.float32), device=device)

    @torch.no_grad()
    def evaluate(batch):
        batch = decode_uint8_batch(batch)
        # a sample id past the offset tables takes the last row, as JAX's
        # gather clamps it (a validation set may hold more frames)
        batch["sample_idx"] = batch["sample_idx"].clamp(0, offsets["iden"].shape[0] - 1)
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
    ``pitchyaw``, ``c2w_Rmat``, ``c2w_Tvec``, ``inmat``).  With
    ``use_patch_gan_loss`` it owns the PatchGAN (``disc``, its parameters
    and BatchNorm statistics, random from ``seed + 2``) and its Adam
    (``disc_optimizer``).  Runs on the CUDA card unless ``device`` says
    otherwise.  With a ``mesh`` (``parallel/mesh.make_mesh``) it is one
    process of a multi-process run, on the mesh's device unless ``device``
    is given: its batches hold the process's rows, its state is replicated
    (the offset tables too) and every process's step updates it alike."""

    def __init__(
        self,
        cfg: Config,
        train_len: int,
        steps_per_epoch: int,
        expr_fix: Optional[np.ndarray] = None,
        seed: Optional[int] = None,
        device=None,
        mesh=None,
    ):
        self.cfg = cfg
        self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        seed = cfg.train.seed if seed is None else seed
        self.model = GazeNeRF(cfg.model, device=self.device, seed=seed, mesh=mesh)
        self.frozen = FrozenNets(cfg, self.device, seed=seed + 1)
        self.offsets = make_offsets(train_len, self.device)
        groups = {"net": list(self.model.parameters()),
                  **{k: [p] for k, p in self.offsets.items()}}
        self.optimizer, self.scheduler = make_optimizer(cfg.train, steps_per_epoch, groups)
        self.disc: Optional[PatchGAN] = None
        self.disc_optimizer = None
        if cfg.loss.use_patch_gan_loss:
            self.disc = PatchGAN()
            self.disc.reset_parameters(torch.Generator().manual_seed(seed + 2))
            self.disc.to(self.device).requires_grad_(False)
            self.disc_optimizer = make_disc_optimizer(cfg.train, self.disc.parameters())
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.expr_fix = (
            np.zeros(cfg.model.expr_code_dims, np.float32)
            if expr_fix is None else np.asarray(expr_fix, np.float32)
        )
        self.step = 0
        self._step = make_train_step(
            cfg, self.model, self.optimizer, self.scheduler, self.frozen,
            self.expr_fix, self.offsets, self.disc, self.disc_optimizer, mesh,
        )
        self.eval_step = make_eval_step(cfg, self.model, self.expr_fix, self.offsets, mesh)
        self.history = []

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {
            k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v)))
            .to(self.device, non_blocking=True)
            for k, v in batch.items()
        }

    def eye_importance(self, epoch: int) -> Optional[float]:
        """The eye importance of ``epoch`` with ``is_gradual_loss``
        (``eye_loss_importance + 30 * epoch``, in f32), else None (the
        config's)."""
        if not self.cfg.loss.is_gradual_loss:
            return None
        return float(np.float32(self.cfg.loss.eye_loss_importance + 30.0 * epoch))

    def disc_state(self) -> Optional[Dict]:
        """A copy of the discriminator's parameters, BatchNorm statistics
        and Adam state (None without the GAN): a step updates them, so two
        steps compared from one state restore this between them."""
        if self.disc is None:
            return None
        return copy.deepcopy({"disc": self.disc.state_dict(),
                              "optimizer": self.disc_optimizer.state_dict()})

    def load_disc_state(self, state: Optional[Dict]) -> None:
        """Restore a :meth:`disc_state` copy in place; the copy stays as it
        was (Adam would otherwise update its moments in place)."""
        if state is None:
            return
        self.disc.load_state_dict(state["disc"], strict=True)
        self.disc_optimizer.load_state_dict(copy.deepcopy(state["optimizer"]))

    def train_step(self, batch, t_rand: Optional[torch.Tensor] = None,
                   update: bool = True, eye_imp: Optional[float] = None) -> Dict[str, torch.Tensor]:
        """One step on a numpy (or tensor) batch; the jitter comes from the
        trainer's generator unless ``t_rand`` is given; ``eye_imp`` as
        :meth:`eye_importance` gives it.  Returns the losses as device
        scalars (no host sync).  On a mesh ``batch`` holds the process's
        rows and ``t_rand`` the global batch's draws; the losses are the
        global batch's."""
        losses = self._step(self.to_device(batch), generator=self.generator,
                            t_rand=t_rand, update=update, eye_imp=eye_imp,
                            step_count=self.step)
        if update:
            self.step += 1
        return losses

    def train_dispatch(self, stacked, n: int, eye_imp: Optional[float] = None
                       ) -> List[Dict[str, torch.Tensor]]:
        """``n`` steps over a stacked batch (every leaf with a leading axis
        ``n``, on the card in one copy), one step per slice in order: the
        JAX package's scan of ``n`` steps per dispatch.  Returns each step's
        losses."""
        return [self.train_step({k: v[i] for k, v in stacked.items()}, eye_imp=eye_imp)
                for i in range(n)]

    def train_epoch(self, batches: Iterable, epoch: int, wandb=None,
                    log_images_every: int = 20) -> Dict[str, float]:
        """One epoch over ``batches`` (numpy or pinned batch dicts, copied to
        the card one dispatch ahead by ``data.h5_dataset.device_prefetch``;
        with ``steps_per_dispatch = K > 1`` grouped by ``stack_batches``
        into K-batch dispatches, the remainder one batch at a time).  The
        per-step losses stay on the device and are summed in one host sync
        at the end.  With ``wandb``, per dispatch the mean of its losses
        (``batch_loss``), every ``log_every`` batches the per-loss scalars
        of its last step, every ``log_images_every`` dispatches the image
        strip of an eval render of its last batch, and at the end the
        epoch's mean loss and, with ``is_gradual_loss``, the eye
        importance (the strip not on a mesh that splits the rays: its
        render would wait for processes that do not log).  The summary also
        gives the seconds the loop waited for its batches."""
        from gazenerf_tpu_torch.utils.logging import log_all_images, log_losses

        t0 = time.time()
        parts = []
        wait = 0.0
        n = 0
        K = max(1, self.cfg.train.steps_per_dispatch)
        log_every = max(1, self.cfg.train.log_every // K)
        eye_imp = self.eye_importance(epoch)
        # the image strip's render gathers over the ray group, which the
        # processes without wandb do not join: with rp > 1 it is left out
        solo_render = self.mesh is None or self.mesh.ray_parallel == 1
        groups = stack_batches(batches, K) if K > 1 else ((b, 1) for b in batches)
        dispatches = iter(device_prefetch(groups, self.device))
        while True:
            tw = time.perf_counter()
            item = next(dispatches, None)
            wait += time.perf_counter() - tw
            if item is None:
                break
            b, n_in = item
            if n_in > 1:
                step_losses = self.train_dispatch(b, n_in, eye_imp)
                last_b = {k: v[-1] for k, v in b.items()}
            else:
                step_losses = [self.train_step(b, eye_imp=eye_imp)]
                last_b = b
            batch_loss = torch.stack([x["total_loss"] for x in step_losses])
            parts.append(batch_loss)
            if wandb is not None:
                wandb.log({"batch_loss": float(batch_loss.mean())})
                if (n // K) % log_every == 0:
                    log_losses(wandb, step_losses[-1], self.cfg.loss, epoch=epoch)
                if log_images_every and (n // K) % log_images_every == 0 and solo_render:
                    _, cd = self.eval_step(last_b)
                    log_all_images(wandb, last_b["image"], cd)
            n += n_in
        total = float(torch.cat(parts).sum()) if parts else 0.0  # the epoch's one sync
        if wandb is not None:
            wandb.log({"Total Loss Epoch": total / max(n, 1)})
            if eye_imp is not None:
                wandb.log({"eye loss importance": eye_imp})
        summary = {"epoch": epoch, "loss": total / max(n, 1), "batches": n,
                   "seconds": time.time() - t0, "loader_wait_s": wait}
        self.history.append(summary)
        return summary

    def eval_epoch(self, loader, wandb=None, prefix: str = "VAL ") -> Dict[str, float]:
        """A validation epoch: per-region reconstruction metrics over
        ``loader``, no update (upstream's eval epoch).  The metrics stay on
        the device and are averaged in one host sync."""
        parts: Dict[str, List[torch.Tensor]] = {}
        for b in device_prefetch(loader, self.device):
            out, _ = self.eval_step(b)
            for k, v in out.items():
                parts.setdefault(k, []).append(v)
        if not parts:
            return {}
        means = torch.stack([torch.stack(v).mean() for v in parts.values()]).tolist()  # one sync
        out = dict(zip(parts, means))
        if wandb is not None:
            wandb.log({prefix + k: v for k, v in out.items()})
        return out

    def fit(self, loader, num_epochs: int, checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 1):
        """``num_epochs`` epochs over ``loader``, a checkpoint every
        ``checkpoint_every`` epochs into ``checkpoint_dir``; returns the
        epoch summaries."""
        from gazenerf_tpu_torch.train.checkpoint import save_checkpoint

        for epoch in range(num_epochs):
            self.train_epoch(loader, epoch)
            if checkpoint_dir and (epoch + 1) % checkpoint_every == 0:
                save_checkpoint(checkpoint_dir, self, self.cfg, epoch)
        return self.history

    def save_summary_csv(self, path: str):
        """The epoch summaries as CSV (upstream ``trainer/base.py``)."""
        if not self.history:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(self.history[0]))
            w.writeheader()
            w.writerows(self.history)
