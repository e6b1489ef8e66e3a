"""The port's FID features (``models/inception.py``) against the JAX
package's, on seeded weights in torchvision's layout: the pool3 features
through the whole pipeline, the antialiased resize to 299, the weight
bridge both ways, and FID itself.  One JAX compile at 299 (B=2), shared by
the module's fixture."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gazenerf_tpu.eval import metrics as JM
from gazenerf_tpu.models.inception import inception_from_torch
from gazenerf_tpu.models.inception import make_fid_features_fn as jax_make_fid_features_fn
from gazenerf_tpu_torch.eval import metrics as M
from gazenerf_tpu_torch.models.inception import (
    InceptionV3FID,
    fid_state_dict,
    make_fid_features_fn,
    resize_antialiased,
)
from gazenerf_tpu_torch.models.seeding import seed_frozen_net_
from gazenerf_tpu_torch.ops.image import resize_bilinear
from gazenerf_tpu_torch.utils.transplant import inception_params_from_jax
from torch_threads import one_thread  # noqa: F401

# the JAX package's own bound for its Inception against torch
# (tests/test_metrics_backends.py::test_inception_fid_features_parity)
ATOL, RTOL = 2e-4, 1e-3
# jax.image.resize's antialiased bilinear and PyTorch's at 512 -> 299: f32
# rounding of sums of up to four taps a side (reading 2.9e-6; the plain
# bilinear resize lies 0.48 away)
RESIZE_ATOL = 1e-5


@pytest.fixture(scope="module")
def nets():
    """The seeded state dict, JAX's feature function on it (through
    ``inception_from_torch``) and the port's, on the CPU."""
    sd = seed_frozen_net_(InceptionV3FID(), torch.Generator().manual_seed(1)).state_dict()
    jax_vars = inception_from_torch({k: v.numpy() for k, v in sd.items()})
    return sd, jax_make_fid_features_fn(jax_vars), make_fid_features_fn(sd, device="cpu")


def test_pool3_features_match_jax(nets):
    """64x64 images through both pipelines: resize to 299, [-1, 1], the
    trunk, the spatial mean."""
    _, jax_feats, feats = nets
    imgs = np.random.default_rng(2).random((2, 64, 64, 3), np.float32)
    want = np.asarray(jax_feats(jnp.asarray(imgs)))
    got = feats(imgs)
    assert got.shape == (2, 2048) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_resize_antialiases_as_jax():
    """512 -> 299 on a narrow image: ``jax.image.resize``'s default
    antialiasing, which the renderer's plain bilinear resize lacks."""
    x = np.random.default_rng(3).random((1, 512, 512, 2), np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 2), method="bilinear"))
    got = resize_antialiased(torch.from_numpy(x).permute(0, 3, 1, 2), 299).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_ATOL, rtol=0)
    plain = resize_bilinear(torch.from_numpy(x), (299, 299)).numpy()
    assert np.abs(plain - want).max() > 0.1


def test_weight_bridge_round_trips_exactly(nets):
    """The port's state dict -> JAX's ``inception_from_torch`` ->
    ``inception_params_from_jax`` gives back every entry to the bit; the
    heads FID does not read are dropped before a strict load."""
    sd = nets[0]
    back = inception_params_from_jax(inception_from_torch({k: v.numpy() for k, v in sd.items()}))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    with_heads = dict(sd, **{"fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008),
                             "AuxLogits.fc.weight": torch.zeros(1000, 768)})
    assert set(fid_state_dict(with_heads)) == set(sd)


def _pool(x, lib):
    """Cheap features: the means of a 4 x 4 grid of blocks, ``[B, 48]``."""
    B, H, W, C = x.shape
    return lib.reshape(x.reshape(B, 4, H // 4, 4, W // 4, C).mean(axis=(2, 4)), (B, -1))


def test_fid_matches_jax_given_the_same_features():
    """``eval/metrics.fid`` in both packages on 4 + 4 images, both sets
    through the same features (batches of 3 and 1)."""
    rng = np.random.default_rng(4)
    a = [rng.random((16, 16, 3), np.float32) for _ in range(4)]
    b = [np.clip(x + 0.2 * rng.random(x.shape, np.float32), 0, 1) for x in a]
    want = JM.fid(lambda x: _pool(x, jnp), a, b, batch_size=3)
    got = M.fid(lambda x: _pool(x, torch), a, b, batch_size=3)
    assert got == pytest.approx(want, rel=1e-5)
    assert got > 0 and abs(M.fid(lambda x: _pool(x, torch), a, list(a))) < 1e-6
