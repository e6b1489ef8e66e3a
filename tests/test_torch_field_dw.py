"""The fused field backward's weight gradients over chunks of points.

The CUDA backwards (K2, K4) compute every weight gradient as a contraction
over chunks of whole 64-point tiles (``kernels/field_dw.py``), chunk after
chunk.  Here, on the CPU: the chunk planner on its edge cases; the plain
version of the chunked contraction against the unchunked ``outer`` of the
plain backward (``fused_field_backward_reference``); and the plain backward
with the chunked contraction, through the port's ``FusedField``, against the
JAX package's ``split_dw`` backward in interpret mode, which computes the
same weight gradients as one large-K contraction each.  The GEMM itself is
held against its plain version on the card by
``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gazenerf_tpu.kernels.fused_field import FieldDims, fused_field_render
from gazenerf_tpu.models.mlp_nerf import NeRFFieldMLP as JaxField
from gazenerf_tpu_torch.kernels import checks
from gazenerf_tpu_torch.kernels import field_dw
from gazenerf_tpu_torch.kernels import fused_field as ff
from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb

B, R, S, DE, H, C = 2, 32, 8, 63, 64, 258
# 8 tiles in chunks of 3: a chunk across the batch boundary (tiles 3-5, the
# boundary after tile 3) and a partial last chunk
CHUNK_TILES = 3
WEIGHT_LEAVES = [f"fea_{i}/kernel" for i in range(8)] + [
    "density/kernel", "rgb_0/kernel", "rgb_1/kernel", "rgb_2/kernel"]


@pytest.mark.parametrize("b, r, s, chunk_tiles, want", [
    # a partial last chunk
    (2, 32, 8, 3, [(0, 3, 0, 0), (3, 3, 0, 1), (6, 2, 1, 1)]),
    # a batch boundary inside a chunk, the chunks of whole rays of 16
    (3, 12, 16, 5, [(0, 5, 0, 1), (5, 4, 1, 2)]),
    # a chunk of one tile
    (2, 4, 16, 1, [(0, 1, 0, 0), (1, 1, 1, 1)]),
    # one chunk for all, shorter than the chunk size
    (2, 64, 8, field_dw.CHUNK_TILES, [(0, 16, 0, 1)]),
])
def test_chunk_plan_edge_cases(b, r, s, chunk_tiles, want):
    """Chunks of whole tiles, in order, covering every point once: the
    tiles, the batches each spans, and the points and rays that follow."""
    plan = field_dw.plan_chunks(b, r, s, chunk_tiles)
    assert [(c.tile0, c.tiles, c.first_batch, c.last_batch) for c in plan] == want
    point = 0
    for c in plan:
        assert c.point0 == point and c.points == 64 * c.tiles
        assert c.ray0 == c.point0 // s and c.rays == c.points // s
        assert c.first_batch == c.point0 // (r * s)
        assert c.last_batch == (c.point0 + c.points - 1) // (r * s)
        point += c.points
    assert point == b * r * s


@pytest.mark.parametrize("b, r, s, chunk_tiles, match", [
    (1, 8, 7, 3, "whole rays"),  # 7 samples do not divide a tile
    (1, 3, 16, 3, "whole rays"),  # 48 points are not whole tiles
    (1, 8, 8, 0, "at least one tile"),
])
def test_chunk_plan_rejects(b, r, s, chunk_tiles, match):
    with pytest.raises(ValueError, match=match):
        field_dw.plan_chunks(b, r, s, chunk_tiles)


def test_chunked_contraction_matches_one_contraction():
    """The chunked contraction in the kernels' order, chunk sums added in
    order, equals x^T bf16(d) over all points at once (the plain backward's
    ``outer``) to f32 summation noise; the CPU wrapper is the plain version,
    adding in place when given outputs."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B * R * S, H)).astype(np.float32)).to(torch.bfloat16)
    d = torch.from_numpy(rng.standard_normal((B * R * S, H // 2)).astype(np.float32))
    db = d.to(torch.bfloat16)
    plan = field_dw.plan_chunks(B, R, S, CHUNK_TILES)
    got = field_dw.chunked_weight_grad_reference(x, db, plan)
    want = x.float().t() @ db.float()
    assert got.dtype == torch.float32 and got.shape == (H, H // 2)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    out = torch.zeros(H, H // 2)
    for c in plan:
        rows = slice(c.point0, c.point0 + c.points)
        field_dw.weight_grad([x[rows]], [db[rows]], [out])
    assert torch.equal(out, got)


def test_chunked_backward_matches_unchunked():
    """The plain backward with its weight gradients summed chunk by chunk
    equals it with one contraction each, every output to f32 summation
    noise (the per-point and bias outputs are the same computation)."""
    args, cot = checks.field_case(64, 8, 32, "cpu")
    plan = field_dw.plan_chunks(B, 32, 8, CHUNK_TILES)
    with torch.no_grad():
        got = ffb.fused_field_backward_reference(*args, *cot, chunks=plan)
        want = ffb.fused_field_backward_reference(*args, *cot)
    for name, a, b in zip(ffb.FieldGrads._fields, got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), name


@pytest.fixture(scope="module")
def split_dw_both():
    """The weight gradients of sum(outputs * cot) from the JAX split_dw
    backward (interpret mode) and from the port's FusedField with the plain
    backward summing chunk by chunk."""
    rng = np.random.default_rng(5)
    embed = rng.standard_normal((B, R, S, DE)).astype(np.float32) * 0.5
    sc = rng.standard_normal((B, 181)).astype(np.float32) * 0.1
    ac = rng.standard_normal((B, 127)).astype(np.float32) * 0.1
    zvals = np.sort(rng.standard_normal((B, R, S)).astype(np.float32), -1)
    zdists = np.abs(rng.standard_normal((B, R, S)).astype(np.float32)) * 0.2
    mlp = JaxField(embed_dims=DE, cond_dims=181, vd_cond_dims=127, hidden=H, res_nfeat=C)
    params = jax.jit(mlp.init)(jax.random.PRNGKey(2), *map(jnp.asarray, (embed, sc, ac)))
    params = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32) if k.endswith("/bias")
              else np.asarray(v) for k, v in params["params"].items()}
    cot = [rng.standard_normal(s).astype(np.float32) for s in ((B, R, C), (B, R), (B, R), (B, R, S))]
    inputs = (embed, sc, ac, zvals, zdists)

    dims = FieldDims(embed=DE, hidden=H, feat=C, samples=S, tile_rays=16, interpret=True,
                     bwd_tile_rays=16, use_pallas_bwd=True, stash_acts=True, split_dw=True)

    def loss(p, *x):
        return sum(jnp.sum(o * c) for o, c in zip(fused_field_render(p, *x, dims), cot))

    g = jax.grad(loss)({k: jnp.asarray(v) for k, v in params.items()}, *map(jnp.asarray, inputs))
    want = {k: np.asarray(v) for k, v in g.items()}

    flat = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in params.items()}
    x = [torch.from_numpy(np.array(a)) for a in inputs]
    p = ff.split_params(flat, DE)
    with torch.no_grad():
        ops = ff.prepare_operands(p)
    plan = field_dw.plan_chunks(B, R, S, CHUNK_TILES)
    plain, calls = ffb.fused_field_backward, []

    def chunked(*a):
        calls.append(1)
        return ffb.fused_field_backward_reference(*a, chunks=plan)

    ffb.fused_field_backward = chunked
    try:
        out = ff.fused_field_render(p, ops, *x)
        total = sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cot))
        keys = list(flat)
        grads = torch.autograd.grad(total, [flat[k] for k in keys])
    finally:
        ffb.fused_field_backward = plain
    assert calls == [1]  # the backward went through the chunked contraction
    return {k: v.numpy() for k, v in zip(keys, grads)}, want


@pytest.mark.parametrize("leaf", WEIGHT_LEAVES)
def test_chunked_weight_grads_match_jax_split_dw(split_dw_both, leaf):
    """The same weight gradients as JAX's split_dw backward: both contract
    bf16 activations with bf16-rounded cotangents in f32; only the order of
    the sums differs (chunk by chunk here, one large-K matmul there).  Per
    leaf within 2e-3 of its largest value, as JAX's own split_dw test."""
    got, want = split_dw_both
    a, b = got[leaf], want[leaf]
    assert a.shape == b.shape, leaf
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a / scale, b / scale, atol=2e-3, err_msg=leaf)
