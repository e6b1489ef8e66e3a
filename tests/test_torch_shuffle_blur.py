"""The blur-shuffle stencil's plain versions (K5, K6) against the JAX
package's Pallas kernel in interpret mode, and the port's repaired
``phase_gm`` stencils against the JAX ops they copy.

Inputs come from numpy with a seed; JAX runs ``pallas_shuffle_blur_gm(x,
True)`` and its VJP (the custom VJP's backward is ``_stencil_bwd``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gazenerf_tpu.kernels.shuffle_blur import pallas_shuffle_blur_gm
from gazenerf_tpu.ops import image as jax_image
from gazenerf_tpu_torch.kernels import shuffle_blur as sb
from gazenerf_tpu_torch.ops import image as torch_image
from torch_threads import one_thread  # noqa: F401

# JAX's own shapes (tests/test_fused_field.py), the single-tile and the
# non-square one among them, and one at the renderer's odd folded width
SHAPES = [(2, 8, 8, 4), (1, 16, 12, 6), (1, 4, 4, 3), (1, 8, 8, 129)]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (None, jnp.bfloat16, torch.bfloat16)}


def _case(shape, seed=0):
    rng = np.random.default_rng(seed)
    B, H, W, C = shape
    x = rng.standard_normal((B, H, W, 4 * C)).astype(np.float32)
    g = rng.standard_normal((B, 2 * H, 2 * W, C)).astype(np.float32)
    return x, g


@pytest.fixture(scope="module")
def jax_results():
    """Per (shape, dtype): the inputs and JAX's forward and VJP, as f32 numpy."""
    out = {}
    for shape in SHAPES:
        x, g = _case(shape)
        for name, (_, jdt, _) in DTYPES.items():
            xj, gj = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
            y, vjp = jax.vjp(lambda v: pallas_shuffle_blur_gm(v, True), xj)
            (dx,) = vjp(gj)
            assert y.dtype == dx.dtype == jdt
            out[shape, name] = (x, g, np.asarray(y, np.float32), np.asarray(dx, np.float32))
    return out


def _torch(a, name):
    return torch.from_numpy(a).to(DTYPES[name][2])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_forward_matches_pallas_kernel(jax_results, shape, dtype):
    """f32 at JAX's own bound (1e-5); both sum the nine taps in f32 in the
    same order and round once, so they agree exactly in both types (the
    reading was 0.0 for every shape)."""
    x, _, want, _ = jax_results[shape, dtype]
    got = sb.shuffle_blur_reference(_torch(x, dtype))
    assert got.dtype == DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-5, rtol=0)
    assert np.array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_backward_matches_pallas_kernel(jax_results, shape, dtype):
    """K6's plain version against JAX's ``_stencil_bwd`` (through the VJP):
    f32 at JAX's bound, 1e-4 (readings, max |port - JAX| / max |JAX|:
    8.6e-8 to 1.3e-7).  Both sum in f32 and round once, in other orders,
    so in bf16 a sum that lands at a rounding midpoint may round the other
    way: one bf16 step, 2^-8 of the largest value, is the bound (readings
    0.0 at every shape)."""
    x, g, _, want = jax_results[shape, dtype]
    got = sb.shuffle_blur_backward_reference(_torch(g, dtype))
    assert got.dtype == DTYPES[dtype][2] and got.shape == x.shape
    err = np.abs(got.float().numpy() - want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
        assert err < 1e-5
    else:
        assert err <= 2.0**-8 * np.abs(want).max(), err


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_is_the_adjoint(shape):
    """In float64, <K5(x), g> == <x, K6(g)> to rounding, and K6 equals
    autograd through the plain forward (the edge folds included)."""
    x, g = _case(shape, seed=3)
    xt = torch.from_numpy(x).double().requires_grad_(True)
    gt = torch.from_numpy(g).double()
    y = sb.shuffle_blur_reference(xt)
    (auto,) = torch.autograd.grad(y, xt, gt)
    dx = sb.shuffle_blur_backward_reference(gt)
    assert dx.dtype == torch.float64
    torch.testing.assert_close(dx, auto, atol=1e-12, rtol=0)
    lhs, rhs = float((y.detach() * gt).sum()), float((xt.detach() * dx).sum())
    assert abs(lhs - rhs) <= 1e-10 * max(1.0, abs(lhs))


def test_autograd_op_uses_the_backward():
    """``shuffle_blur_gm`` (the renderer's ``pallas`` mode) returns x's dtype
    and its gradient is the plain K6 on the CPU, without a kernel launch."""
    x, g = _case((2, 8, 8, 4))
    before = (sb.launch_count_fwd, sb.launch_count_bwd)
    for dt in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dt).requires_grad_(True)
        y = sb.shuffle_blur_gm(xt)
        assert y.dtype == dt
        (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g).to(dt))
        assert dx.dtype == dt
        torch.testing.assert_close(dx, sb.shuffle_blur_backward_reference(torch.from_numpy(g).to(dt)),
                                   atol=0, rtol=0)
    assert (sb.launch_count_fwd, sb.launch_count_bwd) == before


@pytest.mark.parametrize("fn", [sb.shuffle_blur_forward, sb.shuffle_blur_backward])
def test_wrappers_take_the_plain_version_only_for_cpu_tensors(fn):
    """CPU tensors take the plain version and launch nothing; a tensor on
    any other device than the CPU and CUDA raises, with no fall-back."""
    t = torch.randn(1, 4, 4, 8)
    before = (sb.launch_count_fwd, sb.launch_count_bwd)
    ref = sb.shuffle_blur_reference if fn is sb.shuffle_blur_forward else sb.shuffle_blur_backward_reference
    torch.testing.assert_close(fn(t), ref(t), atol=0, rtol=0)
    assert (sb.launch_count_fwd, sb.launch_count_bwd) == before
    with pytest.raises(ValueError, match="no shuffle-blur"):
        fn(t.to("meta"))


@pytest.mark.parametrize("op", ["pixel_shuffle2_blur_gm", "upsample2x_blur_cf"])
def test_repaired_bf16_stencils_round_as_jax(op):
    """The port's ``phase_gm`` stencils sum bf16 inputs in f32 and return
    f32, as the JAX ops do (numpy-scalar taps promote to f32): the same
    values to the bit.  Before the repair they rounded to bf16 after every
    tap: on a bf16 ``[2, 64, 64, 516]`` input the blur-shuffle read max abs
    1.7e-2 (of 2.03) and relative L2 3.9e-3 against JAX."""
    rng = np.random.default_rng(4)
    shape = (2, 16, 16, 4 * 129) if op == "pixel_shuffle2_blur_gm" else (2, 3, 32, 32)
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(getattr(jax_image, op)(jnp.asarray(x, jnp.bfloat16)))
    got = getattr(torch_image, op)(torch.from_numpy(x).to(torch.bfloat16))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
