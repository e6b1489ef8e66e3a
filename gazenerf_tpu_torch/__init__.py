"""gazenerf_tpu_torch — the PyTorch / CUDA port of gazenerf_tpu for one
NVIDIA H100.

Plain tensor code is PyTorch; every Pallas kernel of the JAX package becomes
a hand-written Hopper kernel (``csrc/``, built with ``nvcc`` at first use
and loaded through ``ctypes``) with a plain PyTorch version beside it.  The
package imports neither JAX nor ``gazenerf_tpu``.  Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.

* ``gazenerf_tpu_torch.ops``     — rays, embedding, integration, rotation,
                                   image ops
* ``gazenerf_tpu_torch.kernels`` — the fused field forward and backward
                                   (CUDA) and their plain versions
* ``gazenerf_tpu_torch.models``  — field MLP, neural renderer, GazeNeRF,
                                   the loss stack's VGG16
* ``gazenerf_tpu_torch.losses``  — the training loss
* ``gazenerf_tpu_torch.data``    — the HDF5 loader, synthetic subjects,
                                   cameras
* ``gazenerf_tpu_torch.train``   — offsets, per-group Adam, the trainer,
                                   checkpoints
* ``gazenerf_tpu_torch.parallel`` — multi-process training over
                                   ``torch.distributed``: the mesh, the
                                   batch and ray split, the collectives
* ``gazenerf_tpu_torch.cli``     — the training entry point
* ``gazenerf_tpu_torch.viewer``  — the browser viewer over the no-grad render
* ``gazenerf_tpu_torch.utils``   — weight bridge to and from the JAX package,
                                   PNG codec, logging
"""

__version__ = "0.1.0"

from gazenerf_tpu_torch.config import (
    Config,
    DataConfig,
    LossConfig,
    ModelConfig,
    ParallelConfig,
    TrainConfig,
    small_test_config,
    small_train_config,
)
from gazenerf_tpu_torch.models.gaze_nerf import GazeNeRF
from gazenerf_tpu_torch.train.trainer import Trainer
from gazenerf_tpu_torch.utils.transplant import params_from_jax
from gazenerf_tpu_torch.viewer.server import ViewerApp

__all__ = [
    "Config",
    "DataConfig",
    "LossConfig",
    "ModelConfig",
    "ParallelConfig",
    "TrainConfig",
    "small_test_config",
    "small_train_config",
    "GazeNeRF",
    "Trainer",
    "ViewerApp",
    "params_from_jax",
    "__version__",
]
