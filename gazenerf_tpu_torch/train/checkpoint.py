"""Checkpoints: a trainer's whole state and its config, per epoch.

The JAX package's layout (``train/checkpoint.py``): ``<dir>/epoch_<n>/``
holds ``state`` and ``config.json`` (the serialised :class:`Config` and the
epoch).  Here ``state`` is one ``torch.save`` file: the model's parameters,
the per-sample offset tables, Adam's state, the learning-rate schedule, the
trainer's generator (the jitter's draws), the step, the epoch and the
epoch summaries so far.  Restoring it into a trainer of the same config
continues the run where it stopped, to the bit.

A JAX checkpoint's ``state`` is an orbax directory, which the port cannot
read without JAX: restore it with JAX and copy it over with
``utils/transplant.load_train_state_from_jax``.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch

from gazenerf_tpu_torch.config import Config

_STATE = "state"
_CONFIG_FILE = "config.json"


def save_checkpoint(directory: str, trainer, cfg: Config, epoch: int) -> str:
    """Write ``<directory>/epoch_<epoch + 1>/{state, config.json}``; returns
    the checkpoint's path."""
    path = os.path.abspath(os.path.join(directory, f"epoch_{epoch + 1}"))
    os.makedirs(path, exist_ok=True)
    state = {
        "model": trainer.model.state_dict(),
        "offsets": {k: v.detach() for k, v in trainer.offsets.items()},
        "optimizer": trainer.optimizer.state_dict(),
        "scheduler": trainer.scheduler.state_dict(),
        "generator": trainer.generator.get_state(),
        "step": trainer.step,
        "epoch": epoch,
        "history": list(trainer.history),
    }
    tmp = os.path.join(path, _STATE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, _STATE))  # a reader never sees half a file
    with open(os.path.join(path, _CONFIG_FILE), "w") as f:
        json.dump({"config": json.loads(cfg.to_json()), "epoch": epoch}, f, indent=2)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """The path of the checkpoint of the latest epoch in ``directory``, or
    None."""
    if not os.path.isdir(directory):
        return None
    epochs = []
    for name in os.listdir(directory):
        if name.startswith("epoch_"):
            try:
                epochs.append((int(name.split("_")[1]), name))
            except ValueError:
                continue
    return os.path.join(directory, max(epochs)[1]) if epochs else None


def load_checkpoint(path: str, trainer) -> Tuple[Config, int]:
    """Restore a checkpoint written by :func:`save_checkpoint` into
    ``trainer`` (in place); returns the checkpoint's config and epoch.

    The per-sample offset tables, and Adam's moments of them, are sized by
    the training run's number of samples; where the trainer's tables have
    another leading size (an evaluation trainer of one sample, say) the
    stored size wins, as in the JAX package."""
    with open(os.path.join(path, _CONFIG_FILE)) as f:
        meta = json.load(f)
    cfg = Config.from_json(json.dumps(meta["config"]))
    state_path = os.path.join(path, _STATE)
    if os.path.isdir(state_path):
        raise ValueError(
            f"{state_path} is a JAX (orbax) checkpoint: restore it with the JAX package and "
            f"copy it with gazenerf_tpu_torch.utils.transplant.load_train_state_from_jax")
    state = torch.load(state_path, map_location=trainer.device, weights_only=False)
    trainer.model.load_state_dict(state["model"], strict=True)
    with torch.no_grad():
        for k, v in state["offsets"].items():
            p = trainer.offsets[k]
            if p.shape == v.shape:
                p.copy_(v)
            else:  # the stored size wins; the optimizer keeps the same parameter
                p.data = v.to(p.device, p.dtype).clone()
    trainer.optimizer.load_state_dict(state["optimizer"])
    trainer.scheduler.load_state_dict(state["scheduler"])
    trainer.generator.set_state(state["generator"].cpu())
    trainer.step = state["step"]
    trainer.history = list(state["history"])
    return cfg, state["epoch"]
