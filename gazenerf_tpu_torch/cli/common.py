"""Shared CLI plumbing: the argument parser's flags, config assembly, the
frozen-net guard, debug switches and the tuned kernel settings.

The port's own copy of the JAX package's ``cli/common.py``: the same flags
and defaults, so the same argv builds the same ``model``, ``loss``,
``train`` and ``data`` sections.  ``--debug_nans`` turns on PyTorch's
anomaly detection, and the kernel settings that ``--pallas_tuning auto``
applies are the port's own choice for the card (:func:`tuned_kernel_overrides`).
"""

from __future__ import annotations

import argparse
import logging

from gazenerf_tpu_torch.config import Config, DataConfig, LossConfig, ModelConfig, TrainConfig


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "1"):
        return True
    if v.lower() in ("no", "false", "f", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--img_dir", type=str, default="", help="per-subject h5 dir")
    p.add_argument("--dataset", type=str, default="eth_xgaze",
                   choices=["eth_xgaze", "mpii_face_gaze", "columbia", "gaze_capture"])
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--step_decay", type=int, default=1000)
    p.add_argument("--num_epochs", type=int, default=2000)
    p.add_argument("--seed", type=int, default=45)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--resume", type=str, default="", help="checkpoint path")
    # the loss stack's defaults: upstream train.py's
    p.add_argument("--use_vgg_loss", type=str2bool, default=True)
    p.add_argument("--use_l1_loss", type=str2bool, default=True)
    p.add_argument("--use_angular_loss", type=str2bool, default=False)
    p.add_argument("--use_patch_gan_loss", type=str2bool, default=False)
    p.add_argument("--is_gradual_loss", type=str2bool, default=False)
    p.add_argument("--eye_loss_importance", type=float, default=10.0)
    p.add_argument("--vgg_importance", type=float, default=1.0)
    p.add_argument("--hier_sampling", type=str2bool, default=False)
    p.add_argument("--include_vd", type=str2bool, default=False)
    # the model's scale (defaults: the reference shape)
    p.add_argument("--featmap_size", type=int, default=64)
    p.add_argument("--pred_img_size", type=int, default=512)
    p.add_argument("--num_sample_coarse", type=int, default=64)
    p.add_argument("--mlp_hidden", type=int, default=384)
    p.add_argument("--use_pallas", type=str2bool, default=True,
                   help="the fused field kernels (with bfloat16 fields)")
    p.add_argument("--vgg_ckpt", type=str, default="",
                   help="torchvision VGG16 checkpoint for the frozen perceptual loss")
    p.add_argument("--gaze_ckpt", type=str, default="",
                   help="gaze-VGG checkpoint for the angular loss")
    p.add_argument("--allow_random_frozen_nets", type=str2bool, default=False,
                   help="let a perceptual or angular loss run against RANDOM frozen nets "
                        "(no --vgg_ckpt / --gaze_ckpt): meaningless for real training, "
                        "tests and smoke runs only")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--renderer_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="train steps per dispatch: K > 1 stacks K loader batches into one "
                        "copy to the card and runs their K steps from it (the numbers of "
                        "K = 1; wandb logs once per dispatch)")
    p.add_argument("--prefetch", type=int, default=4,
                   help="host-side batches buffered ahead of the card")
    p.add_argument("--log", type=str2bool, default=False, help="wandb logging")
    p.add_argument("--debug_nans", type=str2bool, default=False,
                   help="torch.autograd.set_detect_anomaly: the backward raises at the "
                        "operation that produced a NaN")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of the first epoch here")
    p.add_argument("--pallas_tuning", type=str, default="auto", choices=["auto", "off"],
                   help="auto (default): the kernel settings chosen for the run's shape "
                        "(tuned_kernel_overrides); off: the library defaults")


def check_frozen_ckpts(cfg: Config, allow_random: bool = False) -> None:
    """Refuse to train against RANDOM frozen perceptual nets: a run with
    ``use_vgg_loss`` or ``use_angular_loss`` and no checkpoint for the net
    would optimise against random features.  ``allow_random`` (tests and
    smoke runs) turns the refusal into a warning."""
    missing = []
    if cfg.loss.use_vgg_loss and not cfg.loss.vgg_ckpt:
        missing.append("--use_vgg_loss is on but no --vgg_ckpt was given")
    if cfg.loss.use_angular_loss and not cfg.loss.gaze_ckpt:
        missing.append("--use_angular_loss is on but no --gaze_ckpt was given")
    if not missing:
        return
    if allow_random:
        for m in missing:
            logging.getLogger(__name__).warning(
                "%s: the frozen net is RANDOM-initialized, the losses are numerically "
                "meaningless (allowed by --allow_random_frozen_nets)", m)
        return
    raise SystemExit(
        "refusing to run with random frozen perceptual nets:\n  " + "\n  ".join(missing)
        + "\npass the checkpoint(s), turn the loss off, or (tests only) "
          "--allow_random_frozen_nets true")


def apply_debug_flags(args) -> None:
    """``--debug_nans``: PyTorch's anomaly detection (a backward that
    produces a NaN raises where it did)."""
    import torch

    if getattr(args, "debug_nans", False):
        torch.autograd.set_detect_anomaly(True)


def tuned_kernel_overrides(featmap_size: int, num_sample_coarse: int) -> dict:
    """The kernel settings ``--pallas_tuning auto`` applies for a run shape:
    the JAX package's keys, with the port's values.

    * S <= 64 (the reference shape): the backward reads the forward's bf16
      activation stash, with the ``dens_vpu`` density head: JAX's choice,
      kept for the card on the reading of ``chip_smoke.py``'s ``stash``
      training variant against ``phase_gm`` (PERF.md, Findings, PR 9).
    * S > 64: recompute, as in JAX (the stash's bytes grow with S), with
      the fields in checkpointed chunks of 512 rays (``ray_chunk``) when the
      rays split into such chunks, as in JAX.

    ``pallas_bwd_tile_rays`` and ``pallas_vmem_mb`` are the TPU kernels'
    tiling and memory knobs, returned as JAX's; the port's kernels do not
    read them.
    """
    deep = num_sample_coarse > 64
    rays = featmap_size * featmap_size
    over = dict(
        pallas_dens_vpu=True,
        pallas_bwd_tile_rays=16,
        pallas_stash_acts=not deep,
        pallas_vmem_mb=110 if deep else 100,
    )
    if deep and rays > 512 and rays % 512 == 0:
        over["ray_chunk"] = 512
    return over


def config_from_args(args) -> Config:
    featmap_size = getattr(args, "featmap_size", 64)
    num_sample_coarse = getattr(args, "num_sample_coarse", 64)
    tuned = (
        tuned_kernel_overrides(featmap_size, num_sample_coarse)
        if getattr(args, "pallas_tuning", "auto") == "auto"
        else {}
    )
    return Config(
        model=ModelConfig(
            hier_sampling=args.hier_sampling,
            include_vd=args.include_vd,
            compute_dtype=args.compute_dtype,
            renderer_dtype=args.renderer_dtype,
            featmap_size=featmap_size,
            pred_img_size=getattr(args, "pred_img_size", 512),
            num_sample_coarse=num_sample_coarse,
            mlp_hidden=getattr(args, "mlp_hidden", 384),
            use_pallas=getattr(args, "use_pallas", True),
            **tuned,
        ),
        loss=LossConfig(
            eye_loss_importance=args.eye_loss_importance,
            vgg_importance=args.vgg_importance,
            use_vgg_loss=args.use_vgg_loss,
            use_l1_loss=args.use_l1_loss,
            use_angular_loss=args.use_angular_loss,
            use_patch_gan_loss=args.use_patch_gan_loss,
            is_gradual_loss=getattr(args, "is_gradual_loss", False),
            vgg_ckpt=getattr(args, "vgg_ckpt", ""),
            gaze_ckpt=getattr(args, "gaze_ckpt", ""),
        ),
        train=TrainConfig(
            lr=args.lr,
            step_decay=args.step_decay,
            batch_size=args.batch_size,
            num_epochs=args.num_epochs,
            seed=args.seed,
            checkpoint_dir=args.checkpoint_dir,
            steps_per_dispatch=getattr(args, "steps_per_dispatch", 1),
        ),
        data=DataConfig(
            dataset=args.dataset,
            img_dir=args.img_dir,
            num_workers=args.num_workers,
            prefetch=getattr(args, "prefetch", 4),
        ),
    )
