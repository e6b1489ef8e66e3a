"""The renderer's kernel modes, ``shuffle_mode="pallas"`` (the blur-shuffle
kernels K5/K6) and ``"fused"`` (the fused upsampler kernels K7/K8), against
the JAX ``NeuralRenderer`` in the same mode with its Pallas kernels in
interpret mode, on the same weights.

The renderer runs two upsample blocks, widths 66 -> 33 -> 16, from an 8x8
feature map to 32x32: the two kinds of width the model's 258 -> 129 -> 64
has (an even F with F % 4 = 2, and an odd F, where the residual's channel
map differs).  On the CPU the port's wrappers run their plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gazenerf_tpu.models.neural_renderer import NeuralRenderer as JaxRenderer
from gazenerf_tpu_torch.kernels import fused_upsampler as fu
from gazenerf_tpu_torch.kernels import shuffle_blur as sb
from gazenerf_tpu_torch.models.neural_renderer import NeuralRenderer
from gazenerf_tpu_torch.utils.transplant import renderer_params_to_torch
from torch_threads import one_thread  # noqa: F401

KW = dict(feat_nc=66, featmap_size=8, img_size=32, min_feat=8)
N_BLOCKS = 2
MODES = ("pallas", "fused")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# bf16 renderer, port vs JAX in the same mode: max abs error of the [0, 1]
# image.  The two round at the same points; where their f32 sums differ in
# the last place a bf16 activation rounds the other way and carries through
# the later blocks.  Readings: pallas 6.8e-4, fused 5.5e-4 (JAX's own
# pallas and fused images lie 6.6e-4 and 8.0e-4 from its phase_gm image);
# held to 1.5e-3, under the JAX package's own bf16 image bound, 3e-2.  In
# f32 the images read 1.2e-7 and the gradients 5.5e-7 relative L2.
BF16_IMAGE_ATOL = 1.5e-3
# f32 renderer: the repository's pixel tolerance and gradient tolerance
# (tests/test_model_parity.py)
F32_IMAGE_ATOL = 2e-4
F32_GRAD_REL_L2 = 2e-3


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def setup():
    """JAX renderer weights (random biases and background), an input
    feature map and a cotangent of the image, from numpy with a seed; JAX's
    image per mode and dtype, and its f32 gradients per mode."""
    rng = np.random.default_rng(2)
    x = (0.5 * rng.standard_normal((2, 8, 8, 66))).astype(np.float32)
    g = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    params = JaxRenderer(shuffle_mode="phase_gm", **KW).init(jax.random.PRNGKey(0), jnp.asarray(x))

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name.endswith("bias") or name == "bg_featmap":
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return np.asarray(leaf)

    params = jax.tree_util.tree_map_with_path(fill, params)
    images, grads = {}, {}
    for mode in MODES:
        for name, (jdt, _) in DTYPES.items():
            m = JaxRenderer(shuffle_mode=mode, pallas_interpret=True, dtype=jdt, **KW)

            def image_and_vjp(p, v, m=m):  # jitted: interpret mode runs ~3x faster
                y, vjp = jax.vjp(m.apply, p, v)
                return y, vjp(jnp.asarray(g))

            if name == "float32":
                y, grads[mode] = jax.jit(image_and_vjp)(params, jnp.asarray(x))
            else:
                y = jax.jit(m.apply)(params, jnp.asarray(x))
            images[mode, name] = np.asarray(y, np.float32)
    return params, x, g, images, grads


def _port(params, mode, dtype):
    r = NeuralRenderer(dtype=dtype, shuffle_mode=mode, **KW)
    sd = renderer_params_to_torch(params["params"], N_BLOCKS)
    r.load_state_dict({k.split(".", 1)[1]: torch.from_numpy(v) for k, v in sd.items()},
                      strict=True)
    return r


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_renderer_mode_matches_jax(setup, mode, dtype):
    """The image, f32 on both sides at 2e-4, bf16 at ``BF16_IMAGE_ATOL``; the
    wrappers take their plain versions for CPU tensors and launch nothing."""
    params, x, _, images, _ = setup
    before = (sb.launch_count_fwd, fu.launch_count_fwd)
    with torch.no_grad():
        got = _port(params, mode, DTYPES[dtype][1])(torch.from_numpy(x))
    assert (sb.launch_count_fwd, fu.launch_count_fwd) == before
    assert got.dtype == torch.float32  # as JAX's: the rgb chain sums in f32
    atol = F32_IMAGE_ATOL if dtype == "float32" else BF16_IMAGE_ATOL
    np.testing.assert_allclose(got.numpy(), images[mode, dtype], atol=atol, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_renderer_mode_gradients_match_jax(setup, mode):
    """f32: the gradients of every renderer parameter (each at relative L2
    2e-3) and of the input feature map, through the kernels' backward (the
    plain K6 / K8 on the CPU) against JAX's custom VJPs in interpret mode."""
    params, x, g, _, grads = setup
    r = _port(params, mode, torch.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    r(xt).backward(torch.from_numpy(g))
    gp, gx = grads[mode]
    want = renderer_params_to_torch(gp["params"], N_BLOCKS)
    got = {f"neural_render.{n}": torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in r.named_parameters()}  # the background map takes none
    assert set(got) == set(want)
    for name in sorted(want):
        if name.endswith("bg_featmap"):
            assert not want[name].any() and not got[name].any()
        else:
            assert _rel_l2(got[name].numpy(), want[name]) < F32_GRAD_REL_L2, name
    assert _rel_l2(xt.grad.numpy(), gx) < F32_GRAD_REL_L2


def test_modes_share_one_parameter_tree(setup):
    """The three modes hold the same parameters, so one state dict loads
    strictly into each (as JAX asserts for its modes)."""
    params = setup[0]
    keys = {mode: set(_port(params, mode, torch.float32).state_dict())
            for mode in ("phase_gm", *MODES)}
    assert keys["phase_gm"] == keys["pallas"] == keys["fused"]
