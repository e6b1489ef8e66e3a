"""``python -m gazenerf_tpu_torch.cli.viewer`` — the interactive browser viewer.

The port's counterpart of ``python -m gazenerf_tpu.cli.viewer``, with its
flags and ``--device``: sliders for the gaze and an orbit camera drive a
live render, served as a web page (``viewer/server.py``).  ``--resume``
loads a checkpoint of ``cli/train.py``; with ``--img_dir`` and
``--subject`` the network and the offsets are first fitted to the
subject's first frame (``--fit_steps`` steps; the HDF5 loader needs h5py),
so the view shows that identity; otherwise it renders the checkpoint's or
the seeded random model with zero codes.  Runs on the CUDA card unless
given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging

from gazenerf_tpu_torch.cli.common import add_common_args, config_from_args

logger = logging.getLogger(__name__)


def build_app(args):
    """The :class:`~gazenerf_tpu_torch.viewer.server.ViewerApp` the flags
    ask for: the trainer's (or the checkpoint's) weights, fitted to
    ``--subject`` when one is given with ``--img_dir``."""
    import torch

    from gazenerf_tpu_torch.train.checkpoint import load_checkpoint
    from gazenerf_tpu_torch.train.trainer import Trainer
    from gazenerf_tpu_torch.viewer.server import ViewerApp

    cfg = config_from_args(args)
    trainer = Trainer(cfg, train_len=1, steps_per_epoch=1, device=args.device)
    if args.resume:
        load_checkpoint(args.resume, trainer)
    model, shape_code, appea_code = trainer.model, None, None
    if args.subject and cfg.data.img_dir:
        from gazenerf_tpu_torch.data.h5_dataset import BatchLoader, GazeH5Dataset
        from gazenerf_tpu_torch.train.fitting import (FitState, make_fit_single_image,
                                                      single_batch)
        from gazenerf_tpu_torch.train.trainer import compose_codes_and_cams

        ds = GazeH5Dataset(cfg.data.img_dir, subjects=[args.subject],
                           dataset=cfg.data.dataset, shuffle=False)
        batch = next(iter(BatchLoader(ds, 1, num_workers=1, drop_last=False)))
        fit = make_fit_single_image(cfg, trainer.frozen, trainer.expr_fix, args.fit_steps)
        state, losses = fit(FitState.of(trainer), batch)
        first, last = losses[[0, -1]].tolist()
        logger.info("fit loss: %.4f -> %.4f", first, last)
        b = single_batch(batch, trainer.device)
        expr = torch.as_tensor(trainer.expr_fix, device=trainer.device)
        sc, ac, *_ = compose_codes_and_cams(cfg, b, state.offsets, expr)
        model = state.model
        shape_code, appea_code = sc.detach().cpu().numpy(), ac.detach().cpu().numpy()
    return ViewerApp(cfg.model, state_dict=model.state_dict(), shape_code=shape_code,
                     appea_code=appea_code, device=args.device)


def main(argv=None) -> int:
    from gazenerf_tpu_torch.viewer.server import serve

    p = argparse.ArgumentParser(description="Interactive GazeNeRF web viewer (PyTorch / CUDA)")
    add_common_args(p)
    p.add_argument("--subject", type=str, default="")
    p.add_argument("--fit_steps", type=int, default=100)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8631)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    serve(build_app(args), host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
