"""Rays longer than one kernel tile (S = 128, 192, 256), held on the CPU.

The fused field kernels take rays of S samples with S dividing 64 or a
multiple of 64 up to ``MAX_SAMPLES``: such a ray spans tiles of one CTA (the
forward's 128-point tiles, the backward's 64-point ones).  On the CPU the
wrappers run their plain versions, which these tests hold against the JAX
Pallas kernels in interpret mode at one tiny case (hidden 64, 4 rays); the
CUDA kernels are held against the plain versions on the card
(``tests/test_torch_kernels_cuda.py``).  The backward's chunk plan and the
forward's CTA plan are held here too: every point once, whole rays in every
chunk and CTA, no tile across a batch.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gazenerf_tpu.kernels.fused_field import FieldDims
from gazenerf_tpu.kernels.fused_field import fused_field_render as jax_fused_field_render
from gazenerf_tpu.kernels.fused_field_bwd import pallas_backward
from gazenerf_tpu.models.mlp_nerf import NeRFFieldMLP as JaxField
from gazenerf_tpu_torch.kernels import field_dw
from gazenerf_tpu_torch.kernels import fused_field as ff
from torch_threads import one_thread  # noqa: F401

B, R, DE, H, C = 1, 4, 63, 64, 258
NAMES = ("feat_int", "bg_alpha", "depth", "weights")
INPUTS = ("embed", "sc", "ac", "zvals", "zdists")
GRAD_REL_L2 = 2e-3  # the ROADMAP's gradient tolerance


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module", params=[128, 192, 256])
def case(request):
    """Seeded inputs, weights (random biases) and cotangents at S samples,
    and the JAX Pallas kernels' forward outputs and backward cotangents in
    interpret mode (one grid step of all 4 rays)."""
    S = request.param
    rng = np.random.default_rng(S)
    embed = rng.standard_normal((B, R, S, DE)).astype(np.float32) * 0.5
    sc = rng.standard_normal((B, 181)).astype(np.float32) * 0.1
    ac = rng.standard_normal((B, 127)).astype(np.float32) * 0.1
    zvals = np.sort(rng.standard_normal((B, R, S)).astype(np.float32), -1)
    # short segments: the transmittance stays away from 0 over the long ray
    zdists = np.abs(rng.standard_normal((B, R, S)).astype(np.float32)) * 0.02
    mlp = JaxField(embed_dims=DE, cond_dims=181, vd_cond_dims=127, hidden=H, res_nfeat=C)
    params = jax.jit(mlp.init)(jax.random.PRNGKey(S), *map(jnp.asarray, (embed, sc, ac)))
    params = {
        k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32) if k.endswith("/bias")
        else np.asarray(v)
        for k, v in params["params"].items()
    }
    cot = (rng.standard_normal((B, R, C)).astype(np.float32),
           rng.standard_normal((B, R)).astype(np.float32),
           rng.standard_normal((B, R)).astype(np.float32),
           rng.standard_normal((B, R, S)).astype(np.float32))
    inputs = (embed, sc, ac, zvals, zdists)
    dims = FieldDims(embed=DE, hidden=H, feat=C, samples=S, tile_rays=R, bwd_tile_rays=R,
                     interpret=True)
    jin = tuple(map(jnp.asarray, inputs))
    out = jax_fused_field_render(params, *jin, dims)
    dparams, *dins = pallas_backward(params, *jin, dims, tuple(map(jnp.asarray, cot)))
    want = {k: np.asarray(v) for k, v in dparams.items()}
    want.update(zip(INPUTS, map(np.asarray, dins)))
    return S, params, inputs, cot, [np.asarray(o) for o in out], want


def _port(params, inputs, cot):
    """The port's outputs and the gradients of sum(outputs * cot) through
    ``FusedField`` (the plain versions on CPU tensors)."""
    flat = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in params.items()}
    ins = [torch.from_numpy(np.array(x)).requires_grad_(True) for x in inputs]
    p = ff.split_params(flat, DE)
    with torch.no_grad():
        ops = ff.prepare_operands(p)
    out = ff.fused_field_render(p, ops, *ins)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cot))
    keys = list(flat)
    grads = torch.autograd.grad(loss, [flat[k] for k in keys] + ins)
    got = dict(zip(keys, grads[: len(keys)]))
    got.update(zip(INPUTS, grads[len(keys):]))
    return [o.detach() for o in out], got


def test_deep_forward_and_backward_match_jax_kernel_interpret(case):
    """At S = 128, 192 and 256 the plain forward within the shallow case's
    5e-3 of the Pallas forward (``tests/test_torch_fused_field.py``), and
    every gradient leaf and input cotangent within 2e-3 relative L2 of the
    Pallas backward."""
    S, params, inputs, cot, want_out, want = case
    got_out, got = _port(params, inputs, cot)
    for n, a, b in zip(NAMES, got_out, want_out):
        assert a.shape == b.shape, n
        np.testing.assert_allclose(a.numpy(), b, atol=5e-3, rtol=0, err_msg=f"S={S} {n}")
    bad = {k: _rel_l2(got[k].numpy(), w) for k, w in want.items()
           if _rel_l2(got[k].numpy(), w) >= GRAD_REL_L2}
    assert not bad, (S, bad)
    assert all(np.abs(w).max() > 0 for w in want.values())


@pytest.mark.parametrize("S", [128, 192, 256])
@pytest.mark.parametrize("B_, R_, chunk_tiles", [(2, 4096, field_dw.CHUNK_TILES), (3, 24, 10)])
def test_chunk_plan_takes_whole_rays(S, B_, R_, chunk_tiles):
    """The backward's chunks at S > 64: every 64-point tile once, in order;
    every chunk whole rays (its tiles a multiple of S / 64); no tile across a
    batch, and the chunk's batches, points and rays as they follow."""
    plan = field_dw.plan_chunks(B_, R_, S, chunk_tiles)
    per_ray = S // field_dw.TILE_POINTS
    point = 0
    for c in plan:
        assert c.point0 == point and c.points == field_dw.TILE_POINTS * c.tiles
        assert c.tiles % per_ray == 0 and c.point0 % S == 0
        assert c.ray0 == c.point0 // S and c.rays == c.points // S
        assert c.first_batch == c.point0 // (R_ * S)
        assert c.last_batch == (c.point0 + c.points - 1) // (R_ * S)
        for t in range(c.tile0, c.tile0 + c.tiles):  # no tile across a batch
            first, last = t * 64, t * 64 + 63
            assert first // (R_ * S) == last // (R_ * S)
        point += c.points
    assert point == B_ * R_ * S
    assert max(c.tiles for c in plan) <= max(chunk_tiles, per_ray)


@pytest.mark.parametrize("S, rays, tiles", [(8, 16, 1), (64, 2, 1), (128, 1, 1), (192, 2, 3),
                                            (256, 1, 2)])
def test_forward_cta_plan(S, rays, tiles):
    """A forward CTA takes the fewest whole rays that fill whole 128-point
    tiles: 128 / S rays in one tile when S divides 128; two rays in three
    tiles at S = 192; one ray in two tiles at S = 256."""
    assert ff.cta_rays(S) == rays
    assert rays * S == tiles * ff.TILE_POINTS
    assert ff.cta_rays(S) == ff.TILE_POINTS // math.gcd(S, ff.TILE_POINTS)
    ff.check_shapes(4 * rays, S, 64, 32, 64, 63)


@pytest.mark.parametrize("S, ok", [(8, True), (64, True), (128, True), (192, True), (256, True),
                                   (96, False), (100, False), (320, False), (512, False)])
def test_samples_the_kernels_take(S, ok):
    """S divides 64, or is a multiple of 64 up to MAX_SAMPLES (256); every
    other S raises in the forward's and the backward's checks."""
    assert ff.takes_samples(S) == ok
    if ok:
        field_dw.check_samples(4, S) if S >= 64 else field_dw.check_samples(64 // S, S)
        return
    with pytest.raises(ValueError, match="whole rays"):
        ff.check_shapes(64, S, 64, 32, 64, 63)
    with pytest.raises(ValueError, match="whole rays"):
        field_dw.plan_chunks(1, 64, S)
