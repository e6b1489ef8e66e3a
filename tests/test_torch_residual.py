"""The renderer block's channel-tile residual, as the port computes it
(``tile_gm``: a four-fold tile read as ``[F, 4]`` and transposed), against
the column gather it replaces and the JAX package's 0/1 product, and one
``PixelShuffleUpsample`` block with its folded ``feat_layer`` against the
JAX block on the same weights, in ``phase_gm`` and in ``pallas`` (the JAX
Pallas stencil in interpret mode, the port's plain K5/K6 on the CPU).

Inputs come from numpy with a seed.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from gazenerf_tpu.kernels.fused_upsampler import residual_matrix
from gazenerf_tpu.models.neural_renderer import PixelShuffleUpsample as JaxBlock
from gazenerf_tpu_torch.kernels import shuffle_blur as sb
from gazenerf_tpu_torch.kernels.fused_upsampler import residual_index
from gazenerf_tpu_torch.models.conv1x1 import Conv1x1
from gazenerf_tpu_torch.models.neural_renderer import PixelShuffleUpsample, tile_gm

WIDTHS = (258, 129, 64, 32)  # the renderer's block widths at 258 features
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _x(F, dtype, seed=0):
    rng = np.random.default_rng(seed + F)
    return torch.from_numpy(rng.standard_normal((2, 3, 5, F)).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tile_is_the_gather(F, dtype):
    """Channel ``k*F + c`` is ``x[..., (4c + k) % F]``: the same values as
    the gather by ``residual_index``, to the bit."""
    x = _x(F, DTYPES[dtype][1])
    assert torch.equal(tile_gm(x), x[..., torch.from_numpy(residual_index(F))])


@pytest.mark.parametrize("F", WIDTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tile_gradient_is_the_sum_over_tiles(F, dtype):
    """The gradient is the cotangent put back in tile order (``[4, F]`` read
    as ``[F, 4]`` transposed) and summed over the four tiles in f32, rounded
    once to x's type.  In bf16 that is JAX's ``g @ P^T`` to the bit (a
    product of bf16 operands summed in f32 and rounded once); in f32 the
    product sums in another order, within f32 noise."""
    dt = DTYPES[dtype][1]
    x = _x(F, dt).requires_grad_(True)
    g = _x(4 * F, dt, seed=1)
    tile_gm(x).backward(g)
    tiles = g.unflatten(-1, (4, F)).transpose(-1, -2).flatten(-2).unflatten(-1, (4, F))
    want = tiles.float().sum(-2).to(dt)
    assert x.grad.dtype == dt and torch.equal(x.grad, want)
    product = g.float() @ torch.from_numpy(residual_matrix(F)).T
    if dt == torch.bfloat16:
        assert torch.equal(x.grad, product.to(dt))
    else:
        torch.testing.assert_close(x.grad, product, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# one block against the JAX block

BLOCK_WIDTHS = (66, 33)  # an even F with F % 4 = 2, and an odd F (F3 = F // 2)
MODES = ("phase_gm", "pallas")
# f32: the repository's pixel and gradient tolerances (tests/
# test_model_parity.py); the readings were 4.8e-7 and 3.8e-7 at most
F32_ATOL = 2e-4
F32_GRAD_REL_L2 = 2e-3
# bf16 output: one bf16 step (unit in the last place) of the largest value,
# as the fused upsampler is held against JAX (tests/
# test_torch_fused_upsampler.py): the two round at the same points, but
# their bf16 products sum in other orders, so now and then a value of z
# rounds the other way and the stencil's output with it (the readings: one
# step in pallas mode, 0.81 of one in phase_gm; the gradients' distances at
# most 1.19 times JAX's bf16 distance, against the bound's 2)


def _bf16_step(v):
    return 2.0 ** (np.floor(np.log2(v)) - 7)


class _JaxBlockFold(nn.Module):
    F: int
    mode: str
    dtype: object

    @nn.compact
    def __call__(self, x):
        fold = nn.Dense(self.F // 2, dtype=self.dtype, name="fold")
        return JaxBlock(self.F, dtype=self.dtype, shuffle_mode=self.mode, pallas_interpret=True,
                        name="up")(x, fold=fold)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def jax_blocks():
    """Per (F, mode): weights with random biases, an input, an output
    cotangent, and JAX's output and gradients (x and every parameter) in f32
    and bf16, as f32 numpy."""
    out = {}
    for F in BLOCK_WIDTHS:
        rng = np.random.default_rng(F)
        x = rng.standard_normal((2, 4, 4, F)).astype(np.float32)
        g = rng.standard_normal((2, 8, 8, F // 2)).astype(np.float32)
        params = _JaxBlockFold(F, "phase_gm", jnp.float32).init(jax.random.PRNGKey(F), x)
        params = jax.tree_util.tree_map_with_path(
            lambda p, v: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            if str(getattr(p[-1], "key", "")) == "bias" else np.asarray(v), params)
        for mode in MODES:
            for name, (jdt, _) in DTYPES.items():
                m = _JaxBlockFold(F, mode, jdt)
                y, vjp = jax.vjp(m.apply, params, jnp.asarray(x))
                gp, gx = vjp(jnp.asarray(g, y.dtype))
                grads = {"x": gx, "fold.weight": gp["params"]["fold"]["kernel"],
                         "fold.bias": gp["params"]["fold"]["bias"]}
                for layer in ("layer_1", "layer_2"):
                    for k, t in (("weight", "kernel"), ("bias", "bias")):
                        grads[f"{layer}.{k}"] = gp["params"]["up"][layer][t]
                out[F, mode, name] = (np.asarray(y, np.float32),
                                      {k: np.asarray(v, np.float32) for k, v in grads.items()})
        out[F] = (params, x, g)
    return out


def _port(params, F, mode, dtype):
    """The port's block and folded layer on JAX's weights."""
    block = PixelShuffleUpsample(F, dtype, mode)
    fold = Conv1x1(F, F // 2)
    p = params["params"]
    with torch.no_grad():
        for layer in ("layer_1", "layer_2"):
            getattr(block, layer).weight.copy_(
                torch.from_numpy(np.asarray(p["up"][layer]["kernel"]).T[:, :, None, None].copy()))
            getattr(block, layer).bias.copy_(torch.from_numpy(np.asarray(p["up"][layer]["bias"])))
        fold.weight.copy_(torch.from_numpy(np.asarray(p["fold"]["kernel"]).T[:, :, None, None].copy()))
        fold.bias.copy_(torch.from_numpy(np.asarray(p["fold"]["bias"])))
    return block, fold


def _run(jax_blocks, F, mode, dtype):
    """The port's output and gradients, as f32 numpy, in JAX's names and
    layouts (Dense kernels ``[in, out]``)."""
    params, x, g = jax_blocks[F]
    block, fold = _port(params, F, mode, DTYPES[dtype][1])
    xt = torch.from_numpy(x).requires_grad_(True)
    y = block(xt, fold)
    y.backward(torch.from_numpy(g).to(y.dtype))
    grads = {"x": xt.grad}
    for name, mod in (("layer_1", block.layer_1), ("layer_2", block.layer_2), ("fold", fold)):
        grads[f"{name}.weight"] = mod.weight.grad[:, :, 0, 0].t()
        grads[f"{name}.bias"] = mod.bias.grad
    return (y.detach().float().numpy(), {k: v.float().numpy() for k, v in grads.items()})


@pytest.mark.parametrize("F", BLOCK_WIDTHS)
@pytest.mark.parametrize("mode", MODES)
def test_block_f32_matches_jax(jax_blocks, F, mode):
    """f32: the output at 2e-4 and every gradient at relative L2 2e-3; the
    stencil's wrappers take their plain versions for CPU tensors."""
    before = (sb.launch_count_fwd, sb.launch_count_bwd)
    y, grads = _run(jax_blocks, F, mode, "float32")
    assert (sb.launch_count_fwd, sb.launch_count_bwd) == before
    want_y, want = jax_blocks[F, mode, "float32"]
    np.testing.assert_allclose(y, want_y, atol=F32_ATOL, rtol=0)
    for name in want:
        assert _rel_l2(grads[name], want[name]) < F32_GRAD_REL_L2, name


@pytest.mark.parametrize("F", BLOCK_WIDTHS)
@pytest.mark.parametrize("mode", MODES)
def test_block_bf16_matches_jax(jax_blocks, F, mode):
    """bf16: the output within one bf16 step of JAX's largest value; every
    gradient, as the JAX package bounds its own bf16 kernels (tests/
    test_torch_train.py): its distance from JAX's f32 gradient, and from
    JAX's bf16 one, under twice JAX's bf16 distance from its f32 gradient."""
    y, grads = _run(jax_blocks, F, mode, "bfloat16")
    want_y, want = jax_blocks[F, mode, "bfloat16"]
    _, truth = jax_blocks[F, mode, "float32"]
    assert np.abs(y - want_y).max() <= _bf16_step(np.abs(want_y).max())
    for name in want:
        d = _rel_l2(want[name], truth[name])
        assert 0 < d < 0.5, name
        assert _rel_l2(grads[name], truth[name]) < 2 * d, name
        assert _rel_l2(grads[name], want[name]) < 2 * d, name
