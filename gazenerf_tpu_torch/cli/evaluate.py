"""``python -m gazenerf_tpu_torch.cli.evaluate`` — the demo GIFs per subject.

The port's counterpart of ``python -m gazenerf_tpu.cli.evaluate`` (upstream
``evaluate.py``), with its flags and ``--device``: for each subject key of
the split (``--split``, the val keys by default; one ``--subject``), fit
the network and the offsets on the chosen frame (``--fixed_index``,
``--fit_steps`` steps; ``--fit false`` skips the fit), then render the
three demo GIFs with upstream's names,
``{key}_{fitted|not_fitted}_{both,gaze,head}.gif``: the orbit with the
gaze following its trajectory, the gaze sweep, and the orbit with the gaze
fixed.  ``--resume`` loads a checkpoint of ``cli/train.py``.  Runs on the
CUDA card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os

from gazenerf_tpu_torch.cli.common import add_common_args, check_frozen_ckpts, config_from_args, str2bool

logger = logging.getLogger(__name__)


def add_eval_args(p: argparse.ArgumentParser, default_split: str) -> None:
    p.add_argument("--subject", type=str, default="",
                   help="one subject file; default: every subject of --split "
                        "(train_test_split.json where present)")
    p.add_argument("--split", type=str, default=default_split, choices=["train", "val"],
                   help="the split whose keys to render when no --subject is given")
    p.add_argument("--fixed_index", type=int, default=0,
                   help="the dataset frame to fit and render per subject")
    p.add_argument("--fit", type=str2bool, default=True,
                   help="fit the network and offsets before rendering; false: the "
                        "not_fitted flow")
    p.add_argument("--fit_steps", type=int, default=100)
    p.add_argument("--view_num", type=int, default=45, help="orbit cameras per GIF")
    p.add_argument("--out_dir", type=str, default="logs")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


def process_subject(cfg, trainer, fit, loops, subject: str, args) -> None:
    """Fit one frame of ``subject`` and write its three GIFs."""
    import torch

    from gazenerf_tpu_torch.data.h5_dataset import BatchLoader, GazeH5Dataset
    from gazenerf_tpu_torch.eval.render_loops import save_gif
    from gazenerf_tpu_torch.train.fitting import FitState, single_batch
    from gazenerf_tpu_torch.train.trainer import compose_codes_and_cams

    ds = GazeH5Dataset(cfg.data.img_dir, subjects=[subject], dataset=cfg.data.dataset,
                       shuffle=False, fixed_index=args.fixed_index)
    batch = next(iter(BatchLoader(ds, 1, num_workers=1, drop_last=False)))
    state = FitState.of(trainer)
    fit_name = "not_fitted"
    if args.fit:
        state, losses = fit(state, batch)
        fit_name = "fitted"
        first, last = losses[[0, -1]].tolist()
        logger.info("%s[%d] fit loss: %.4f -> %.4f", subject, args.fixed_index, first, last)
    b = single_batch(batch, trainer.device)
    expr = torch.as_tensor(trainer.expr_fix, device=trainer.device)
    sc, ac, *_ = compose_codes_and_cams(cfg, b, state.offsets, expr)
    key = os.path.splitext(subject)[0]
    for suffix, frames in (
        ("both", loops.render_novel_views(state.model, sc, ac, move_gaze=True)),
        ("gaze", loops.render_gaze_sweep(state.model, sc, ac)),
        ("head", loops.render_novel_views(state.model, sc, ac, move_gaze=False)),
    ):
        save_gif(os.path.join(args.out_dir, f"{key}_{fit_name}_{suffix}.gif"), frames)
    logger.info("GIFs for %s -> %s", key, args.out_dir)


def run(args) -> int:
    cfg = config_from_args(args)
    check_frozen_ckpts(cfg, args.allow_random_frozen_nets)
    logging.basicConfig(level=logging.INFO)
    os.makedirs(args.out_dir, exist_ok=True)

    from gazenerf_tpu_torch.data.h5_dataset import GazeH5Dataset
    from gazenerf_tpu_torch.eval.render_loops import RenderLoops
    from gazenerf_tpu_torch.train.checkpoint import load_checkpoint
    from gazenerf_tpu_torch.train.fitting import make_fit_single_image
    from gazenerf_tpu_torch.train.trainer import Trainer

    if args.subject:
        subjects = [args.subject]
    else:
        probe = GazeH5Dataset(cfg.data.img_dir, dataset=cfg.data.dataset, split=args.split,
                              shuffle=False)
        subjects = probe.subjects
        probe.close()
    logger.info("%d subject(s) from split %r", len(subjects), args.split)

    trainer = Trainer(cfg, train_len=1, steps_per_epoch=1, device=args.device)
    if args.resume:
        load_checkpoint(args.resume, trainer)
    fit = make_fit_single_image(cfg, trainer.frozen, trainer.expr_fix, args.fit_steps)
    loops = RenderLoops(cfg.model, view_num=args.view_num)
    for subject in subjects:
        process_subject(cfg, trainer, fit, loops, subject, args)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Fit subjects and render demo GIFs (PyTorch / CUDA)")
    add_common_args(p)
    add_eval_args(p, default_split="val")
    return run(p.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
