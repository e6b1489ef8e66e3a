"""The PyTorch port stands alone: no JAX, nothing of ``gazenerf_tpu``, no
OpenCV, imageio or PIL (the card's machine has none of them), and no silent
fall-back to the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gazenerf_tpu_torch import (
    GazeNeRF,
    Trainer,
    ViewerApp,
    small_test_config,
    small_train_config,
)

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import pkgutil, sys
for absent in ("cv2", "imageio", "PIL"):  # as on the card's machine
    sys.modules[absent] = None
import gazenerf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gazenerf_tpu_torch.__path__, "gazenerf_tpu_torch.")]
for name in names:
    __import__(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "gazenerf_tpu"))
missing = sorted(set(EXPECTED) - set(names))
print(len(names), bad, missing)
"""

# the modules of the slices: the render, the training step, the renderer's
# kernel modes, the dual-branch field path, the training CLI from files, and
# fitting and evaluation with their CLIs and metric nets, and multi-process
# training
EXPECTED = [
    "gazenerf_tpu_torch.cli.common",
    "gazenerf_tpu_torch.cli.evaluate",
    "gazenerf_tpu_torch.cli.evaluate_metrics",
    "gazenerf_tpu_torch.cli.train",
    "gazenerf_tpu_torch.cli.visualize",
    "gazenerf_tpu_torch.data.cameras",
    "gazenerf_tpu_torch.data.face_model",
    "gazenerf_tpu_torch.data.h5_dataset",
    "gazenerf_tpu_torch.data.synthetic",
    "gazenerf_tpu_torch.data.target_indices",
    "gazenerf_tpu_torch.eval.metrics",
    "gazenerf_tpu_torch.eval.protocols",
    "gazenerf_tpu_torch.eval.render_loops",
    "gazenerf_tpu_torch.kernels.checks",
    "gazenerf_tpu_torch.kernels.fused_field",
    "gazenerf_tpu_torch.kernels.fused_field2",
    "gazenerf_tpu_torch.kernels.fused_field2_bwd",
    "gazenerf_tpu_torch.kernels.fused_field_bwd",
    "gazenerf_tpu_torch.kernels.fused_upsampler",
    "gazenerf_tpu_torch.kernels.shuffle_blur",
    "gazenerf_tpu_torch.losses.gazenerf_loss",
    "gazenerf_tpu_torch.models.face_alignment",
    "gazenerf_tpu_torch.models.face_detection",
    "gazenerf_tpu_torch.models.face_recognition",
    "gazenerf_tpu_torch.models.inception",
    "gazenerf_tpu_torch.models.resnet",
    "gazenerf_tpu_torch.models.seeding",
    "gazenerf_tpu_torch.models.vgg",
    "gazenerf_tpu_torch.parallel.dryrun",
    "gazenerf_tpu_torch.parallel.mesh",
    "gazenerf_tpu_torch.parallel.sharding",
    "gazenerf_tpu_torch.preprocess.normalize",
    "gazenerf_tpu_torch.train.checkpoint",
    "gazenerf_tpu_torch.train.fitting",
    "gazenerf_tpu_torch.train.state",
    "gazenerf_tpu_torch.train.trainer",
    "gazenerf_tpu_torch.utils.gif",
    "gazenerf_tpu_torch.utils.logging",
    "gazenerf_tpu_torch.viewer.server",
]


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", f"EXPECTED = {EXPECTED!r}\n" + _IMPORT_ALL], cwd=REPO,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.split(maxsplit=1)
    assert int(out[0]) >= 48  # every submodule was imported
    assert out[1].strip() == "[] []"


_BLOCKED = """
import sys
for blocked in ("jax", "jaxlib", "flax", "gazenerf_tpu"):
    sys.modules[blocked] = None  # importing any of them raises ImportError
from gazenerf_tpu_torch.parallel import dryrun, mesh, sharding
from gazenerf_tpu_torch.cli import train
m = mesh.make_mesh(device="cpu")
print(m.shape, sharding.ray_slice(m, 4096))
"""


def test_parallel_modules_import_with_jax_blocked():
    """The multi-process modules and the training CLI import, and a
    one-process mesh builds, where JAX and the JAX package cannot be
    imported at all."""
    out = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "{'data': 1, 'ray': 1} slice(0, 4096, None)"


@pytest.mark.parametrize("entry", [GazeNeRF, ViewerApp])
def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry(small_test_config())
    assert entry(small_test_config(), device="cpu") is not None


def test_dryrun_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """The multi-process dry run runs on the cards by default: without one
    it raises before any process starts, from the function and from its
    command line.  ``tests/test_torch_parallel.py`` runs it with
    ``device="cpu"``."""
    from gazenerf_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dryrun, "launch", lambda *a, **k: pytest.fail("a process started"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["2"])
    with pytest.raises(ValueError, match="device='cpu'"):
        dryrun.dryrun(2, device="cuda")


def test_trainer_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(small_train_config(), train_len=2, steps_per_epoch=1)
    assert Trainer(small_train_config(), train_len=2, steps_per_epoch=1, device="cpu") is not None
