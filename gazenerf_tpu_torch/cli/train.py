"""``python -m gazenerf_tpu_torch.cli.train`` — the training entry point.

The port's counterpart of ``python -m gazenerf_tpu.cli.train`` (upstream
``train.py``), with the JAX CLI's flags: the HDF5 loader over ``--img_dir``
(one ``--subject`` or all), the trainer at the config the flags give (with
``--pallas_tuning auto`` the kernel settings of
``cli/common.tuned_kernel_overrides``), epochs with a checkpoint every
``checkpoint_every`` epochs, an optional validation epoch over
``--val_dir``, ``summary.csv`` and a final samples/s line.  ``--resume
<checkpoint>`` restores the whole training state and carries on from the
epoch after the checkpoint's, up to ``--num_epochs`` in all, so that
``summary.csv`` lists every epoch of the run.  ``--profile_dir`` writes a
``torch.profiler`` trace of the first epoch run.

Runs on the CUDA card (``--device cuda``, the default) unless given
``--device cpu``.  One device only: ``--dp``, ``--rp`` and
``--num_processes`` other than 1 raise ``NotImplementedError`` (ROADMAP
Queue 1 item 7).
"""

from __future__ import annotations

import argparse
import logging
import os
import time

from gazenerf_tpu_torch.cli.common import (
    add_common_args,
    apply_debug_flags,
    check_frozen_ckpts,
    config_from_args,
    str2bool,
)

logger = logging.getLogger(__name__)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train GazeNeRF (PyTorch / CUDA)")
    add_common_args(p)
    p.add_argument("--subject", type=str, default=None,
                   help="restrict to a single subject file")
    p.add_argument("--val_dir", type=str, default="",
                   help="per-subject h5 dir for a per-epoch validation epoch (per-region "
                        "metrics, no update)")
    p.add_argument("--num_val_images", type=int, default=200,
                   help="validation frames per subject")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    # the JAX CLI's multi-device flags: one device only here
    p.add_argument("--dp", type=int, default=1, help="data-parallel axis (the port runs 1)")
    p.add_argument("--rp", type=int, default=1, help="ray-parallel axis (the port runs 1)")
    p.add_argument("--coordinator", type=str, default="")
    p.add_argument("--num_processes", type=int, default=0,
                   help="train processes (the port runs 1)")
    p.add_argument("--process_id", type=int, default=-1)
    p.add_argument("--shard_offsets", type=str2bool, default=True)
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.dp != 1 or args.rp != 1 or args.num_processes > 1:
        raise NotImplementedError(
            f"--dp {args.dp} --rp {args.rp} --num_processes {args.num_processes}: the port "
            f"trains on one device (more devices: ROADMAP Queue 1 item 7)")
    cfg = config_from_args(args)
    check_frozen_ckpts(cfg, args.allow_random_frozen_nets)
    apply_debug_flags(args)

    import torch

    from gazenerf_tpu_torch.data.h5_dataset import BatchLoader, GazeH5Dataset
    from gazenerf_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from gazenerf_tpu_torch.train.trainer import Trainer
    from gazenerf_tpu_torch.utils.logging import configure_logging, maybe_wandb_init

    configure_logging(os.path.join(cfg.train.checkpoint_dir, "train.log"))
    wandb = maybe_wandb_init(args.log, config=cfg.to_json())
    device = torch.device(args.device)

    # uint8 on the wire (the step divides by 255 on the card), pinned for
    # non-blocking copies to the card
    ds = GazeH5Dataset(
        cfg.data.img_dir, subjects=[args.subject] if args.subject else None,
        dataset=cfg.data.dataset, frames_per_subject=cfg.data.frames_per_subject,
        seed=cfg.train.seed, device_decode=True,
    )
    pin = device.type == "cuda"
    loader = BatchLoader(ds, cfg.train.batch_size, num_workers=cfg.data.num_workers,
                         prefetch=cfg.data.prefetch, pin_memory=pin)
    logger.info("dataset: %d samples, %d batches/epoch", len(ds), len(loader))
    val_loader = None
    if args.val_dir:
        val_ds = GazeH5Dataset(args.val_dir, dataset=cfg.data.dataset, split="val",
                               num_val_images=args.num_val_images, shuffle=False,
                               device_decode=True)
        val_loader = BatchLoader(val_ds, cfg.train.batch_size, num_workers=cfg.data.num_workers,
                                 prefetch=cfg.data.prefetch, drop_last=False, pin_memory=pin)
        logger.info("val dataset: %d samples", len(val_ds))

    trainer = Trainer(cfg, train_len=len(ds), steps_per_epoch=len(loader), device=device)
    start_epoch = 0
    if args.resume:
        _, last = load_checkpoint(args.resume, trainer)
        start_epoch = last + 1
        logger.info("resumed from %s (epoch %d)", args.resume, last)

    t0 = time.time()
    total_samples = 0
    for epoch in range(start_epoch, cfg.train.num_epochs):
        prof = None
        if args.profile_dir and epoch == start_epoch:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if pin else [])
            prof = profile(activities=acts)
            prof.__enter__()
        summary = trainer.train_epoch(loader, epoch, wandb=wandb)
        if prof is not None:
            if pin:
                torch.cuda.synchronize(device)
            prof.__exit__(None, None, None)
            os.makedirs(args.profile_dir, exist_ok=True)
            path = os.path.join(args.profile_dir, f"epoch_{epoch}.trace.json")
            prof.export_chrome_trace(path)
            logger.info("profiler trace -> %s", path)
        total_samples += summary["batches"] * cfg.train.batch_size
        logger.info("epoch %d: loss %.5f (%d batches, %.1fs, loader wait %.3fs)", epoch,
                    summary["loss"], summary["batches"], summary["seconds"],
                    summary["loader_wait_s"])
        if wandb is not None:
            wandb.log({"epoch": epoch, "loss": summary["loss"]})
        if val_loader is not None:
            val = trainer.eval_epoch(val_loader, wandb=wandb)
            logger.info("epoch %d val: %s", epoch,
                        " ".join(f"{k}={v:.4f}" for k, v in sorted(val.items())))
        if (epoch + 1) % cfg.train.checkpoint_every == 0:
            path = save_checkpoint(cfg.train.checkpoint_dir, trainer, cfg, epoch)
            logger.info("checkpoint -> %s", path)

    dt = time.time() - t0
    trainer.save_summary_csv(os.path.join(cfg.train.checkpoint_dir, "summary.csv"))
    logger.info("done: %d samples in %.1fs (%.2f samples/s)", total_samples, dt,
                total_samples / max(dt, 1e-9))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
