"""The sample points encoded inside the port's fused field kernels
(``embed_in_kernel``: ``pallas_fuse_embed``) against the JAX package.

On the CPU the wrappers run their plain versions: the forward encodes the
points as :func:`~gazenerf_tpu_torch.ops.embedding.positional_encoding_matmul`
does, and the backward returns the points' cotangent through the encoding's
backward.  Both are held against JAX's ``_pallas_forward`` and
``pallas_backward`` with ``embed_in_kernel=True`` in interpret mode, at the
size of JAX's own ``test_embed_in_kernel_matches_precomputed`` (B=2, R=32,
S=8, ten octaves), recomputing and reading the stash, through the autograd
``FusedField``; and the scatter-matrix encoding against JAX's.  The CUDA
kernels are held against the plain versions on the card by
``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gazenerf_tpu.kernels.fused_field import FieldDims, _pallas_forward
from gazenerf_tpu.kernels.fused_field_bwd import pallas_backward
from gazenerf_tpu.models.mlp_nerf import NeRFFieldMLP as JaxField
from gazenerf_tpu.ops import embedding as jemb
from gazenerf_tpu_torch.kernels import fused_field as ff
from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb
from gazenerf_tpu_torch.ops import embedding as temb
from torch_threads import one_thread  # noqa: F401

B, R, S, NF, H, C = 2, 32, 8, 10, 64, 258
DE = 3 + 6 * NF
# JAX's own test's tolerance for the points path (outputs and gradients)
TOL = 2e-3
LEAVES = [f"{n}/{k}" for n in ["fea_%d" % i for i in range(8)] + ["density", "rgb_0", "rgb_1", "rgb_2"]
          for k in ("kernel", "bias")]
INPUTS = ("pts", "sc", "ac", "zvals", "zdists")
OUTPUTS = ("feat_int", "bg_alpha", "depth", "weights")
MODES = ("recompute", "stash")


@pytest.fixture(scope="module")
def case():
    """Seeded numpy inputs: N(0, 1) points (arguments up to 2^9 of that),
    codes, z values, segment lengths, the field's weights with random
    biases, and cotangents of the four outputs."""
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((B, R, S, 3)).astype(np.float32)
    sc = rng.standard_normal((B, 181)).astype(np.float32) * 0.1
    ac = rng.standard_normal((B, 127)).astype(np.float32) * 0.1
    zvals = np.sort(rng.standard_normal((B, R, S)).astype(np.float32), -1)
    zdists = np.abs(rng.standard_normal((B, R, S)).astype(np.float32)) * 0.2
    mlp = JaxField(embed_dims=DE, cond_dims=181, vd_cond_dims=127, hidden=H, res_nfeat=C)
    params = jax.jit(mlp.init)(jax.random.PRNGKey(1), jnp.zeros((B, R, S, DE)),
                               jnp.asarray(sc), jnp.asarray(ac))
    params = {
        k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32) if k.endswith("/bias")
        else np.asarray(v)
        for k, v in params["params"].items()
    }
    cot = (rng.standard_normal((B, R, C)).astype(np.float32),
           rng.standard_normal((B, R)).astype(np.float32),
           rng.standard_normal((B, R)).astype(np.float32),
           rng.standard_normal((B, R, S)).astype(np.float32))
    return params, (pts, sc, ac, zvals, zdists), cot


@pytest.fixture(scope="module")
def jax_points(case):
    """Per mode: JAX's outputs and gradients with ``embed_in_kernel=True``
    in interpret mode (its backward recomputing, or reading the stash its
    forward wrote)."""
    params, inputs, cot = case
    x = tuple(map(jnp.asarray, inputs))
    out = {}
    for mode in MODES:
        dims = FieldDims(embed=DE, hidden=H, feat=C, samples=S, tile_rays=8, bwd_tile_rays=8,
                         interpret=True, embed_in_kernel=True, n_freqs=NF,
                         stash_acts=mode == "stash")
        outs, stash = _pallas_forward(params, *x, dims)
        dparams, *dins = pallas_backward(params, *x, dims, tuple(map(jnp.asarray, cot)),
                                         stash if mode == "stash" else ())
        grads = {k: np.asarray(v) for k, v in dparams.items()}
        grads.update(zip(INPUTS, map(np.asarray, dins)))
        out[mode] = [np.asarray(o) for o in outs], grads
    return out


@pytest.fixture(scope="module")
def port_points(case):
    """Per mode: the port's outputs and gradients through ``FusedField``
    given the points (``n_freqs``), recomputing or with the stash."""
    params, inputs, cot = case
    out = {}
    for mode in MODES:
        flat = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in params.items()}
        xs = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in inputs]
        p = ff.split_params(flat, DE)
        with torch.no_grad():
            ops = ff.prepare_operands(p)
        res = ff.fused_field_render(p, ops, *xs, stash_acts=mode == "stash", n_freqs=NF)
        loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(res, cot))
        keys = list(flat)
        g = torch.autograd.grad(loss, [flat[k] for k in keys] + xs)
        out[mode] = [o.detach() for o in res], dict(zip(keys + list(INPUTS), g))
    return out


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("output", OUTPUTS)
def test_points_forward_matches_jax_kernel_interpret(jax_points, port_points, mode, output):
    """The four outputs given the points, at JAX's 2e-3 (absolute and
    relative)."""
    i = OUTPUTS.index(output)
    got, want = port_points[mode][0][i], jax_points[mode][0][i]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("leaf", LEAVES + list(INPUTS))
def test_points_gradients_match_jax_kernel_interpret(jax_points, port_points, mode, leaf):
    """Every gradient leaf given the points, the points' own cotangent
    (``dpts``, f32 ``[B, R, S, 3]``) included, within 2e-3 relative L2 of
    JAX's."""
    got, want = port_points[mode][1][leaf], jax_points[mode][1][leaf]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, leaf
    assert np.abs(want).max() > 0, leaf
    assert _rel_l2(got.numpy(), want) < TOL, leaf


def test_points_path_is_the_embedding_path(case, port_points):
    """Given the points, the plain versions compute what they compute given
    the embedding that :func:`positional_encoding_matmul` makes of them:
    the same outputs and weight gradients to the bit, and the points'
    cotangent the encoding's backward of the embedding's."""
    params, inputs, cot = case
    flat = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in params.items()}
    pts = torch.from_numpy(inputs[0]).requires_grad_(True)
    rest = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in inputs[1:]]
    p = ff.split_params(flat, DE)
    with torch.no_grad():
        ops = ff.prepare_operands(p)
    emb = temb.positional_encoding_matmul(pts, NF)
    res = ff.fused_field_render(p, ops, emb, *rest)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(res, cot))
    keys = list(flat)
    g = dict(zip(keys + list(INPUTS), torch.autograd.grad(loss, [flat[k] for k in keys]
                                                              + [pts] + rest)))
    got_out, got_g = port_points["recompute"]
    for a, b in zip(got_out, res):
        assert torch.equal(a, b.detach())
    for k in keys:
        assert torch.equal(got_g[k], g[k]), k
    torch.testing.assert_close(got_g["pts"], g["pts"], atol=1e-5, rtol=1e-5)


def test_positional_encoding_matmul_matches_jax():
    """The scatter-matrix encoding against JAX's: its argument a product by
    a power of two, exact in both, and sin and cos within one f32 step of
    each other's (the two libraries' functions; 1.2e-7 absolute), the
    port's reference-shaped encoding to the bit, and its backward against
    JAX's autodiff of it within 1e-6 relative L2."""
    rng = np.random.default_rng(0)
    x = (2.0 * rng.standard_normal((4, 7, 3))).astype(np.float32)
    g = rng.standard_normal((4, 7, DE)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jemb.positional_encoding_matmul(v, NF), jnp.asarray(x))
    got = temb.positional_encoding_matmul(torch.from_numpy(x), NF)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1.2e-7, rtol=0)
    assert torch.equal(got, temb.positional_encoding(torch.from_numpy(x), NF))
    dx = temb.positional_encoding_matmul_vjp(torch.from_numpy(x), torch.from_numpy(g), NF)
    assert _rel_l2(dx.numpy(), np.asarray(vjp(jnp.asarray(g))[0])) < 1e-6


def test_points_must_match_the_field_width(case):
    """``FusedField`` given points refuses a field whose embedding width is
    not ``3 + 6 n_freqs``."""
    params, inputs, _ = case
    p = ff.split_params({k: torch.from_numpy(np.array(v)) for k, v in params.items()}, DE)
    ops = ff.prepare_operands(p)
    pts, sc, ac, zvals, zdists = map(torch.from_numpy, inputs)
    with pytest.raises(ValueError, match="embed_in_kernel"):
        ff.fused_field_render(p, ops, pts, sc, ac, zvals, zdists, n_freqs=NF - 1)
