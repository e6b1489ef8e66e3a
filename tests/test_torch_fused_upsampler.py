"""The fused upsampler block's plain versions (K7, K8) against the JAX
package's Pallas kernels in interpret mode.

Inputs come from numpy with a seed, as the JAX package's own test makes
them (``tests/test_fused_field.py``); JAX runs ``fused_upsample_block(...,
True, use_bf16)`` and its VJP (the custom VJP's backward is ``_bwd_pallas``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gazenerf_tpu.kernels.fused_upsampler import fused_upsample_block, residual_matrix
from gazenerf_tpu_torch.kernels import fused_upsampler as fu
from torch_threads import one_thread  # noqa: F401

# (B, H, W, F, F3): JAX's three, and the renderer's odd width F = 129
SHAPES = [(1, 8, 8, 12, 6), (2, 16, 8, 8, 4), (1, 4, 4, 8, 4), (1, 8, 8, 129, 64)]
NAMES = ("x", "W1", "b1", "W2g", "b2g", "W3", "b3")
# bf16 (use_bf16=True), plain version vs the Pallas kernel, per output: max
# |port - JAX| over max |JAX|.  Both round at the same points but sum in
# other orders, so now and then a bf16 value rounds the other way, a step of
# 2^-8 of it, and carries on.  The largest readings over the shapes (all at
# F = 129; the narrow shapes read 0 to 3e-7): out 8.1e-6, x 2.1e-3, W1
# 1.1e-4, b1 4.1e-6, W2g 5.8e-5, b2g 2.8e-7, W3 1.8e-7, b3 4.9e-8.  The two
# bf16 outputs are held to one bf16 step of the largest value, the f32 ones
# to about twice their readings, never below 1e-5.
BF16_LIMITS = {"out": 2.0**-8, "x": 2.0**-8, "W1": 3e-4, "b1": 1e-5, "W2g": 1.5e-4, "b2g": 1e-5,
               "W3": 1e-5, "b3": 1e-5}


def _args(shape, seed=0):
    """``tests/test_fused_field.py``'s recipe: x N(0, 1), weights scaled
    normals, W2 already in group-major column order; and an N(0, 1) output
    cotangent."""
    B, H, W, F, F3 = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, F)).astype(np.float32)
    W1 = rng.standard_normal((F, 2 * F)).astype(np.float32) * 0.2
    b1 = rng.standard_normal((2 * F,)).astype(np.float32) * 0.1
    W2 = rng.standard_normal((2 * F, 4 * F)).astype(np.float32) * 0.2
    b2 = rng.standard_normal((4 * F,)).astype(np.float32) * 0.1
    W3 = rng.standard_normal((F, F3)).astype(np.float32) * 0.3
    b3 = rng.standard_normal((F3,)).astype(np.float32) * 0.1
    g = rng.standard_normal((B, 2 * H, 2 * W, F3)).astype(np.float32)
    return (x, W1, b1, W2, b2, W3, b3), g


@pytest.fixture(scope="module")
def jax_results():
    """Per (shape, use_bf16): the inputs, JAX's output and its cotangents of
    x, W1, b1, W2, b2, W3, b3, as f32 numpy.  In bf16 x and the cotangent
    are bf16, as the renderer passes them."""
    out = {}
    for shape in SHAPES:
        (x, W1, b1, W2, b2, W3, b3), g = _args(shape)
        P = jnp.asarray(residual_matrix(shape[3]))
        for use_bf16 in (False, True):
            dt = jnp.bfloat16 if use_bf16 else jnp.float32

            def f(x_, W1_, b1_, W2_, b2_, W3_, b3_):
                return fused_upsample_block(x_, W1_, b1_, W2_, b2_, P, W3_, b3_, True, use_bf16)

            y, vjp = jax.vjp(f, jnp.asarray(x, dt), *map(jnp.asarray, (W1, b1, W2, b2, W3, b3)))
            grads = vjp(jnp.asarray(g, dt))
            assert y.dtype == dt and grads[0].dtype == dt
            out[shape, use_bf16] = (np.asarray(y, np.float32),
                                    [np.asarray(v, np.float32) for v in grads])
    return out


def _torch_args(shape, use_bf16):
    args, g = _args(shape)
    dt = torch.bfloat16 if use_bf16 else torch.float32
    t = [torch.from_numpy(a) for a in args]
    t[0] = t[0].to(dt)
    return t, torch.from_numpy(g).to(dt)


def test_residual_index_is_the_residual_matrix():
    for F in (8, 12, 64, 129, 258):
        P = residual_matrix(F)
        idx = fu.residual_index(F)
        assert (P.sum(0) == 1).all()
        np.testing.assert_array_equal(P.argmax(0), idx)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("use_bf16", [False, True])
def test_plain_forward_matches_pallas_kernel(jax_results, shape, use_bf16):
    """f32 (``use_bf16=False``) at JAX's bound, 1e-4; bf16 at
    ``BF16_LIMITS`` of the largest value."""
    want = jax_results[shape, use_bf16][0]
    args, _ = _torch_args(shape, use_bf16)
    got = fu.fused_upsample_reference(*args, use_bf16=use_bf16)
    assert got.dtype == args[0].dtype and tuple(got.shape) == want.shape
    got = got.float().numpy()
    if use_bf16:
        assert np.abs(got - want).max() <= BF16_LIMITS["out"] * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("use_bf16", [False, True])
def test_plain_backward_matches_pallas_kernel(jax_results, shape, use_bf16):
    """The written-out backward's cotangents of x and the six weights:
    f32 at JAX's bound, 1e-3; bf16 at ``BF16_LIMITS`` of each output's
    largest value.  x's cotangent comes back in x's dtype."""
    want = jax_results[shape, use_bf16][1]
    args, g = _torch_args(shape, use_bf16)
    got = fu.fused_upsample_backward_reference(*args, g, use_bf16=use_bf16)
    assert got.dx.dtype == args[0].dtype
    for name, a, b in zip(NAMES, got, want):
        a = a.float().numpy()
        assert a.shape == b.shape, name
        if use_bf16:
            err = np.abs(a - b).max() / np.abs(b).max()
            assert err <= BF16_LIMITS[name], (name, err)
        else:
            np.testing.assert_allclose(a, b, atol=1e-3, rtol=0, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_autograd_of_plain_forward(shape):
    """Without bf16 rounding points and in float64, the written-out backward
    is autograd through the plain forward, every input to 1e-10."""
    args, g = _torch_args(shape, False)
    args = [a.double().requires_grad_(True) for a in args]
    y = fu.fused_upsample_reference(*args, use_bf16=False)
    auto = torch.autograd.grad(y, args, g.double())
    got = fu.fused_upsample_backward_reference(*[a.detach() for a in args], g.double(),
                                               use_bf16=False)
    for name, a, b in zip(NAMES, got, auto):
        assert a.dtype == torch.float64, name
        torch.testing.assert_close(a, b, atol=1e-10, rtol=1e-10, msg=name)


@pytest.mark.parametrize("use_bf16", [False, True])
def test_autograd_op_gradients_are_the_plain_backward(use_bf16):
    """``FusedUpsample`` on CPU tensors: the plain forward, and the plain
    backward as its gradient, to the bit; no kernel launch."""
    args, g = _torch_args(SHAPES[0], use_bf16)
    args = [a.requires_grad_(True) for a in args]
    before = (fu.launch_count_fwd, fu.launch_count_bwd)
    y = fu.FusedUpsample.apply(*args, use_bf16)
    got = torch.autograd.grad(y, args, g)
    want = fu.fused_upsample_backward_reference(*[a.detach() for a in args], g, use_bf16)
    assert (fu.launch_count_fwd, fu.launch_count_bwd) == before
    torch.testing.assert_close(y, fu.fused_upsample_reference(*args, use_bf16), atol=0, rtol=0)
    for name, a, b in zip(NAMES, got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)


@pytest.mark.parametrize("backward", [False, True])
def test_wrappers_take_the_plain_version_only_for_cpu_tensors(backward):
    """CPU tensors take the plain version and launch nothing; a tensor on
    any other device than the CPU and CUDA raises, with no fall-back."""
    args, g = _torch_args(SHAPES[2], True)
    before = (fu.launch_count_fwd, fu.launch_count_bwd)
    if backward:
        got = fu.fused_upsample_backward(*args, g)
        want = fu.fused_upsample_backward_reference(*args, g)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
    else:
        torch.testing.assert_close(fu.fused_upsample_forward(*args),
                                   fu.fused_upsample_reference(*args), atol=0, rtol=0)
    assert (fu.launch_count_fwd, fu.launch_count_bwd) == before
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no fused upsampler"):
        if backward:
            fu.fused_upsample_backward(*meta, g.to("meta"))
        else:
            fu.fused_upsample_forward(*meta)


# The card's kernel (K8) sums the weight gradients in another order than the
# TPU kernel: chunk by chunk of whole tiles, dW3 over each chunk's [4P, F]
# phase rows.  Chunks of 8 and 24 pixels split the quarter-tile and the odd
# shape (16 and 64 pixels) into two and three, the last one shorter.
CHUNKED = [((1, 4, 4, 8, 4), 8), ((1, 8, 8, 129, 64), 24)]


@pytest.mark.parametrize("shape, chunk", CHUNKED)
def test_chunked_weight_grads_match_pallas_kernel(jax_results, shape, chunk):
    """The plain backward with the weight gradients in K8's chunked order
    against the Pallas kernel at ``BF16_LIMITS``; every other cotangent is
    the unchunked plain backward's, to the bit."""
    want = jax_results[shape, True][1]
    args, g = _torch_args(shape, True)
    got = fu.fused_upsample_backward_reference(*args, g, chunk_pixels=chunk)
    plain = fu.fused_upsample_backward_reference(*args, g)
    for name, a, b, p in zip(NAMES, got, want, plain):
        err = np.abs(a.float().numpy() - b).max() / np.abs(b).max()
        assert err <= BF16_LIMITS[name], (name, err)
        if name not in ("W1", "W2g", "W3"):
            torch.testing.assert_close(a, p, atol=0, rtol=0, msg=name)


@pytest.mark.parametrize("F", [8, 129])
def test_phase_rows_are_the_group_major_columns(F):
    """``z[P, 4F]`` read as ``[4P, F]``: row 4p + k is phase k of pixel p, so
    one contraction over the phase rows is the sum of the four phases'."""
    rng = np.random.default_rng(F)
    P, F3 = 6, 5
    z = torch.from_numpy(rng.standard_normal((P, 4 * F)))
    d = torch.from_numpy(rng.standard_normal((P, 4 * F3)))
    z4, d4 = z.reshape(4 * P, F), d.reshape(4 * P, F3)
    for p in range(P):
        for k in range(4):
            torch.testing.assert_close(z4[4 * p + k], z[p, k * F:(k + 1) * F], atol=0, rtol=0)
    per_phase = sum(z[:, k * F:(k + 1) * F].t() @ d[:, k * F3:(k + 1) * F3] for k in range(4))
    torch.testing.assert_close(z4.t() @ d4, per_phase, atol=1e-12, rtol=0)


@pytest.mark.parametrize("P, F, F3, tile, want", [
    (8192, 258, 129, 64, (128, 1)),      # the first block at B=2: one wave, one chunk
    (32768, 129, 64, 64, (132, 4)),      # the second: chunks of a wave
    (131072, 64, 32, 128, (132, 8)),     # the third
    (60, 72, 36, 64, (1, 1)),            # the ragged case: one partial tile
])
def test_chunk_plan(P, F, F3, tile, want):
    """K8's chunks on a card of 132 SMs: one wave of tiles whatever its
    bytes, else whole waves within ``CHUNK_BYTES``."""
    assert fu.plan_chunks(P, F, F3, tile, 132) == want


def test_group_rows_take_the_most_rows_that_fit():
    """The tile's row groups: the most whose shared memory fits, whose tiles
    still make about one per SM and (for K8) whose wave of tiles keeps a
    chunk within ``CHUNK_BYTES``, else one; raise if none fits."""
    fits = lambda nrg: 1000 * nrg  # noqa: E731
    assert fu.group_rows(fits, 131072, 132) == 4
    assert fu.group_rows(fits, 16384, 132) == 2      # 128 tiles of 128 pixels
    assert fu.group_rows(fits, 4096, 132) == 1
    assert fu.group_rows(lambda nrg: fu.SMEM_LIMIT + 1 if nrg > 1 else 0, 131072, 132) == 1
    # the renderer's last block at B=2: a wave of 256-pixel tiles would
    # outgrow the chunk, one of 128-pixel tiles does not
    assert fu.group_rows(fits, 131072, 132, lambda t: fu.chunk_bytes(64, 32, t)) == 2
    with pytest.raises(ValueError, match="shared memory"):
        fu.group_rows(lambda nrg: fu.SMEM_LIMIT + 1, 131072, 132)


def test_tile_x_pads_with_zeros():
    """The kernels' bf16 x: whole rows of pad32(F), zero past the pixels and
    channels; x itself where nothing is padded."""
    x = torch.randn(1, 2, 3, 5)
    t = fu._tile_x(x, 8)
    assert t.shape == (8, 32) and t.dtype == torch.bfloat16
    torch.testing.assert_close(t[:6, :5], x.reshape(6, 5).to(torch.bfloat16), atol=0, rtol=0)
    assert not t[6:].any() and not t[:, 5:].any()
    x32 = torch.randn(2, 2, 2, 32).to(torch.bfloat16)
    assert fu._tile_x(x32, 8).data_ptr() == x32.data_ptr()


@pytest.mark.parametrize("shape", SHAPES)
def test_f32_autograd_op_matches_pallas_kernel(jax_results, shape):
    """The f32 block (``use_bf16=False``, the f32 renderer's ``fused`` mode)
    through ``FusedUpsample`` on CPU tensors against JAX's
    ``fused_upsample_block`` with ``use_bf16=False`` in interpret mode and
    its VJP: the output at JAX's bound, 1e-4, every cotangent at 1e-3, all
    in f32; no kernel launch."""
    want_y, want_g = jax_results[shape, False]
    args, g = _torch_args(shape, False)
    args = [a.requires_grad_(True) for a in args]
    before = (fu.launch_count_fwd_f32, fu.launch_count_bwd_f32)
    y = fu.FusedUpsample.apply(*args, False)
    got = torch.autograd.grad(y, args, g)
    assert (fu.launch_count_fwd_f32, fu.launch_count_bwd_f32) == before
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=1e-4, rtol=0)
    for name, a, b in zip(NAMES, got, want_g):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), b, atol=1e-3, rtol=0, err_msg=name)


@pytest.mark.parametrize("contract", (False, True))
def test_f32_tile_on_cpu_takes_plain_version(contract):
    """The f32 kernels' tile alone (``f32_product``, ``f32_contract``) on
    CPU tensors: the plain products, ``a @ w`` and ``(a^T b, b.sum(0))``;
    a matrix the tile does not take (not f32, not contiguous, rows that do
    not match) raises."""
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(37, 9, generator=gen)
    if contract:
        b = torch.randn(37, 5, generator=gen)
        dw, db = fu.f32_contract(a, b)
        assert torch.equal(dw, a.t() @ b) and torch.equal(db, b.sum(0))
        bad = [(a.double(), b), (a, b[:-1]), (a, b.t().contiguous().t())]
        fn = fu.f32_contract
    else:
        w = torch.randn(9, 5, generator=gen)
        assert torch.equal(fu.f32_product(a, w), a @ w)
        bad = [(a.double(), w), (a, w[:-1]), (a.t(), w)]
        fn = fu.f32_product
    for args in bad:
        with pytest.raises(ValueError):
            fn(*args)
