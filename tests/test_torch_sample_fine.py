"""The hierarchical sampler (``ops/rays.sample_fine``) against the JAX
package's: the same coarse samples and weights (seeded numpy, some rays
with all-zero weights, where the CDF is flat), evenly spaced draws
(``key=None``) and given uniforms (JAX's own draws for a key)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gazenerf_tpu.ops.rays import sample_coarse as jax_sample_coarse
from gazenerf_tpu.ops.rays import sample_fine as jax_sample_fine
from gazenerf_tpu_torch.ops.rays import sample_coarse, sample_fine
from torch_threads import one_thread  # noqa: F401

B, R, SC, NF = 2, 16, 8, 6
FIELDS = ("pts", "dirs", "zvals", "z_dists")


def _inputs():
    rng = np.random.default_rng(11)
    xy = rng.uniform(0, 8, (B, R, 2)).astype(np.float32)
    Rm = np.diag([1.0, -1.0, -1.0]).astype(np.float32)[None].repeat(B, 0)
    T = np.array([[0.0, 0.0, 12.0]] * B, np.float32)
    K = np.array([[0.03, 0, -0.12], [0, 0.03, -0.12], [0, 0, 1]], np.float32)[None].repeat(B, 0)
    w = rng.uniform(0, 1, (B, R, SC)).astype(np.float32) ** 3
    w[:, :2] = 0.0  # flat CDFs: every draw lands where denom < 1e-5
    return (xy, Rm, T, K), w


@pytest.mark.parametrize("draws", ["even", "uniforms"])
def test_sample_fine_matches_jax(draws):
    """``S_c + num_fine`` samples from the sorted union of coarse and fine
    z-values, as JAX's to f32 noise (1e-5 on z, 1e-4 on points at ~10
    units); the weights' gradient is stopped on both sides."""
    cam, w = _inputs()
    jc = jax_sample_coarse(*map(jnp.asarray, cam), num_samples=SC, world_z1=-1.0, world_z2=1.0)
    tc = sample_coarse(*map(torch.from_numpy, cam), num_samples=SC, world_z1=-1.0, world_z2=1.0)
    key = jax.random.PRNGKey(3) if draws == "uniforms" else None
    want = jax_sample_fine(jnp.asarray(w), jc, NF, key=key)
    u = None
    if key is not None:  # JAX's draws for the key, handed to the port
        u = torch.from_numpy(np.array(jax.random.uniform(key, (B, R, NF + 1), jnp.float32)))
    wt = torch.from_numpy(w).requires_grad_(True)
    got = sample_fine(wt, tc, NF, u=u)
    assert got.zvals.shape == (B, R, SC + NF)
    for name, atol in zip(FIELDS, (1e-4, 1e-6, 1e-5, 1e-5)):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), atol=atol, rtol=0,
                                   err_msg=name)
    assert not got.zvals.requires_grad  # the weights' gradient is stopped
    assert (got.zvals[..., 1:] >= got.zvals[..., :-1]).all()


def test_sample_fine_draws_from_a_generator():
    """In training the draws come from a ``torch.Generator``: the same seed
    gives the same samples, another seed others."""
    cam, w = _inputs()
    tc = sample_coarse(*map(torch.from_numpy, cam), num_samples=SC, world_z1=-1.0, world_z2=1.0)
    wt = torch.from_numpy(w)

    def run(seed):
        return sample_fine(wt, tc, NF, generator=torch.Generator().manual_seed(seed)).zvals

    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))
