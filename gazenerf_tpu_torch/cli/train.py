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
``--device cpu``.

More than one device: start ``N = dp x rp`` processes, one per device,
each with the same flags and its own ``--process_id``::

    for i in 0 1 2 3; do
      python -m gazenerf_tpu_torch.cli.train --img_dir DIR --batch_size 4 \
          --coordinator localhost:29500 --num_processes 4 --process_id $i \
          --dp 2 --rp 2 &
    done; wait

Process ``i`` drives ``cuda:<i % device_count>`` over NCCL (``--device
cpu``: gloo), loads its data index's
``batch_size / dp`` rows of every batch and marches its ray index's ``R /
rp`` rays of each image (``parallel/``); ``--dp 0`` takes all remaining
processes.  Process 0 listens on ``--coordinator`` and writes the
checkpoints, ``summary.csv`` and the log file; every process restores
``--resume``.  The validation epoch runs in one process only (with more it
is skipped, with a warning).  Flags that do not fit together raise
``ValueError`` before any process connects.
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
    # more than one device: one process per device (the module docstring)
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel axis: the batch rows over dp processes (0 = all "
                        "remaining); dp x rp = --num_processes")
    p.add_argument("--rp", type=int, default=1,
                   help="ray-parallel axis: each image's rays over rp processes, gathered "
                        "before the featmaps merge")
    p.add_argument("--coordinator", type=str, default="",
                   help="host:port where process 0 listens (with --num_processes > 1)")
    p.add_argument("--num_processes", type=int, default=0,
                   help="training processes, one per device")
    p.add_argument("--process_id", type=int, default=-1, help="this process's rank")
    p.add_argument("--shard_offsets", type=str2bool, default=True,
                   help="the JAX CLI's row-sharding of the offset tables over the data axis; "
                        "the port runs one process per device, where the tables are replicated "
                        "(as JAX's multi-process runs replicate them)")
    return p


def parallel_layout(args, cfg) -> tuple:
    """``(world, dp, rp)`` from the flags, or ``ValueError`` naming the flags
    that do not fit together (before any process connects)."""
    from gazenerf_tpu_torch.models.gaze_nerf import check_ray_shapes
    from gazenerf_tpu_torch.parallel.mesh import mesh_shape

    world = max(args.num_processes, 1)
    if world > 1 and not args.coordinator:
        raise ValueError(f"--num_processes {world} needs --coordinator host:port")
    if world > 1 and not 0 <= args.process_id < world:
        raise ValueError(f"--process_id {args.process_id} is not a rank of --num_processes "
                         f"{world}")
    dp, rp = mesh_shape(world, args.dp, args.rp)
    if cfg.train.batch_size % dp:
        raise ValueError(f"--batch_size {cfg.train.batch_size} is not divisible by --dp {dp}")
    check_ray_shapes(cfg.model, rp)
    return world, dp, rp


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    cfg = config_from_args(args)
    world, dp, rp = parallel_layout(args, cfg)
    check_frozen_ckpts(cfg, args.allow_random_frozen_nets)
    apply_debug_flags(args)

    import torch

    from gazenerf_tpu_torch.config import ParallelConfig
    from gazenerf_tpu_torch.parallel.mesh import init_distributed, make_mesh

    from gazenerf_tpu_torch.data.h5_dataset import BatchLoader, GazeH5Dataset
    from gazenerf_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from gazenerf_tpu_torch.train.trainer import Trainer
    from gazenerf_tpu_torch.utils.logging import configure_logging, maybe_wandb_init

    mesh = None
    device = torch.device(args.device)
    if world > 1:
        init_distributed(args.coordinator, world, args.process_id, device=device)
        mesh = make_mesh(dp, rp, device=device)
        device = mesh.device
        cfg = cfg.replace(parallel=ParallelConfig(data_parallel=dp, ray_parallel=rp,
                                                  shard_offsets=args.shard_offsets))
    lead = mesh is None or mesh.rank == 0
    configure_logging(os.path.join(cfg.train.checkpoint_dir, "train.log") if lead else None)
    wandb = maybe_wandb_init(args.log and lead, config=cfg.to_json())

    # uint8 on the wire (the step divides by 255 on the card), pinned for
    # non-blocking copies to the card
    ds = GazeH5Dataset(
        cfg.data.img_dir, subjects=[args.subject] if args.subject else None,
        dataset=cfg.data.dataset, frames_per_subject=cfg.data.frames_per_subject,
        seed=cfg.train.seed, device_decode=True,
    )
    pin = device.type == "cuda"
    shard = (mesh.data_index, dp) if mesh is not None and dp > 1 else None
    loader = BatchLoader(ds, cfg.train.batch_size, num_workers=cfg.data.num_workers,
                         prefetch=cfg.data.prefetch, pin_memory=pin, process_shard=shard)
    logger.info("dataset: %d samples, %d batches/epoch", len(ds), len(loader))
    val_loader = None
    if args.val_dir and mesh is not None:
        logger.warning("--val_dir is single-process only for now; skipping")
    elif args.val_dir:
        val_ds = GazeH5Dataset(args.val_dir, dataset=cfg.data.dataset, split="val",
                               num_val_images=args.num_val_images, shuffle=False,
                               device_decode=True)
        val_loader = BatchLoader(val_ds, cfg.train.batch_size, num_workers=cfg.data.num_workers,
                                 prefetch=cfg.data.prefetch, drop_last=False, pin_memory=pin)
        logger.info("val dataset: %d samples", len(val_ds))

    if mesh is not None:
        logger.info("mesh: data=%d x ray=%d over %d processes (rank %d on %s)", dp, rp, world,
                    mesh.rank, device)
        if args.shard_offsets:
            logger.info("multi-process run: replicating offset tables")
    trainer = Trainer(cfg, train_len=len(ds), steps_per_epoch=len(loader), device=device,
                      mesh=mesh)
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
            rank = "" if mesh is None else f".rank{mesh.rank}"
            path = os.path.join(args.profile_dir, f"epoch_{epoch}{rank}.trace.json")
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
    if lead:
        trainer.save_summary_csv(os.path.join(cfg.train.checkpoint_dir, "summary.csv"))
    logger.info("done: %d samples in %.1fs (%.2f samples/s)", total_samples, dt,
                total_samples / max(dt, 1e-9))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
