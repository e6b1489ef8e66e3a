"""The port's frozen gaze estimator (``models/resnet.GazeResNet``) against
the JAX package's, on one random torchvision-format state dict, at a 64x64
input."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gazenerf_tpu.models.resnet import GazeResNet as JaxGazeResNet
from gazenerf_tpu.models.resnet import gaze_resnet_from_torch as jax_from_torch
from gazenerf_tpu_torch.models.resnet import GazeResNet, gaze_resnet_from_torch
from torch_threads import one_thread  # noqa: F401

# f32 on both sides through 53 convolutions and batch norms: the two
# frameworks' convolutions sum in other orders (readings 1.3e-6 and 2.3e-6
# relative L2, gaze and head)
REL_L2 = 1e-4


@pytest.fixture(scope="module")
def state_dict():
    """A torchvision-format state dict: N(0, 0.05) convolutions, batch
    norms with random scales, shifts and running statistics, a random
    head; with the trunk's unused ``fc`` and a ``module.`` prefix, as
    checkpoints of a wrapped model carry."""
    gen = torch.Generator().manual_seed(0)
    sd = {}
    for k, v in GazeResNet().state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
        elif k.endswith("running_var") or (k.endswith("weight") and v.dim() == 1):
            sd[k] = 0.5 + torch.rand(v.shape, generator=gen)
        else:
            scale = 0.05 if v.dim() > 1 else 0.1
            sd[k] = scale * torch.randn(v.shape, generator=gen)
    sd["gaze_network.fc.weight"] = torch.zeros(1000, 2048)
    sd["gaze_network.fc.bias"] = torch.zeros(1000)
    return {"module." + k: v.numpy() for k, v in sd.items()}


def test_gaze_resnet_matches_jax(state_dict):
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jax_sd = {k.replace("module.", ""): v for k, v in state_dict.items()}
    want = JaxGazeResNet().apply(jax_from_torch(jax_sd), jnp.asarray(x))
    net = GazeResNet()
    net.load_state_dict(gaze_resnet_from_torch(state_dict), strict=True)
    assert not net.training
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (2, 2)
        assert np.linalg.norm(g.numpy() - w) / np.linalg.norm(w) < REL_L2


def test_state_dict_needs_every_key(state_dict):
    sd = dict(state_dict)
    del sd["module.gaze_network.layer3.2.bn2.running_mean"]
    with pytest.raises(KeyError, match="layer3.2.bn2.running_mean"):
        gaze_resnet_from_torch(sd)
