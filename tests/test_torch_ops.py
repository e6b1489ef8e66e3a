"""The PyTorch port's ops against the JAX package's, in float32.

Same numpy inputs through both; every op is f32 on both sides, so the
tolerances only cover summation order and the last bit of sin / cos / exp
(1e-6 absolute unless a test says otherwise).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gazenerf_tpu.data import cameras as jcam
from gazenerf_tpu.ops import embedding as jemb
from gazenerf_tpu.ops import image as jimg
from gazenerf_tpu.ops import integrate as jint
from gazenerf_tpu.ops import rays as jrays
from gazenerf_tpu.ops import rotation as jrot
from gazenerf_tpu.utils import transplant as jtr
from gazenerf_tpu.viewer.server import lookat_camera as jax_lookat
from gazenerf_tpu_torch.data import cameras as tcam
from gazenerf_tpu_torch.ops import embedding as temb
from gazenerf_tpu_torch.ops import image as timg
from gazenerf_tpu_torch.ops import integrate as tint
from gazenerf_tpu_torch.ops import rays as trays
from gazenerf_tpu_torch.ops import rotation as trot
from gazenerf_tpu_torch.utils import transplant as ttr
from gazenerf_tpu_torch.utils.png import decode_png, encode_png
from gazenerf_tpu_torch.viewer.server import lookat_camera
from torch_threads import one_thread  # noqa: F401

ATOL = 1e-6


def close(got, want, atol=ATOL, rtol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _camera(rng, B):
    """Look-at cameras around the frontal view, featmap 16."""
    cams = [
        lookat_camera(float(az), float(el), float(d), 16)
        for az, el, d in zip(
            rng.uniform(-40, 40, B), rng.uniform(-20, 20, B), rng.uniform(10, 14, B)
        )
    ]
    R, T, K = (np.concatenate(x) for x in zip(*cams))
    xy = np.asarray(jrays.pixel_grid(16))[None].repeat(B, 0)
    return xy, R, T, K


def test_pixel_grid():
    np.testing.assert_array_equal(trays.pixel_grid(7).numpy(), np.asarray(jrays.pixel_grid(7)))


def test_generate_rays(rng):
    xy, R, T, K = _camera(rng, 2)
    want = jrays.generate_rays(*map(jnp.asarray, (xy, R, T, K)))
    got = trays.generate_rays(*map(t, (xy, R, T, K)))
    close(got.origins, want.origins)
    close(got.directions, want.directions)
    close(got.ray_l, want.ray_l, atol=1e-5)


@pytest.mark.parametrize("field", ["pts", "dirs", "zvals", "z_dists"])
def test_sample_coarse(rng, field):
    xy, R, T, K = _camera(rng, 2)
    want = jrays.sample_coarse(*map(jnp.asarray, (xy, R, T, K)), num_samples=8,
                               world_z1=2.5, world_z2=-3.5)
    got = trays.sample_coarse(*map(t, (xy, R, T, K)), num_samples=8,
                              world_z1=2.5, world_z2=-3.5)
    # points lie ~10 units out: 1e-5 covers the f32 rounding there
    close(getattr(got, field), getattr(want, field), atol=1e-5, rtol=1e-5)


def test_stratified_zvals(rng):
    xy, R, T, K = _camera(rng, 1)
    rays_j = jrays.generate_rays(*map(jnp.asarray, (xy, R, T, K)))
    rays_t = trays.generate_rays(*map(t, (xy, R, T, K)))
    close(trays.stratified_zvals(rays_t, 64, 2.5, -3.5),
          jrays.stratified_zvals(rays_j, 64, 2.5, -3.5), atol=1e-5)


@pytest.mark.parametrize("include_input", [True, False])
def test_positional_encoding(rng, include_input):
    x = rng.uniform(-3, 3, (2, 5, 4, 3)).astype(np.float32)
    # sin / cos of arguments up to 2**9 * 3: 1e-5 for the libm difference
    close(temb.positional_encoding(t(x), 10, include_input),
          jemb.positional_encoding(jnp.asarray(x), 10, include_input), atol=1e-5)


def test_exclusive_transmittance(rng):
    alpha = rng.uniform(0, 1, (2, 6, 16)).astype(np.float32)
    close(tint.exclusive_transmittance(t(alpha)),
          jint.exclusive_transmittance(jnp.asarray(alpha)))


@pytest.mark.parametrize("field", ["features", "bg_alpha", "depth", "weights"])
def test_integrate_rays(rng, field):
    feat = rng.standard_normal((2, 6, 16, 9)).astype(np.float32)
    dens = rng.uniform(0, 3, (2, 6, 16)).astype(np.float32)
    dists = rng.uniform(0, 0.3, (2, 6, 16)).astype(np.float32)
    zvals = np.sort(rng.uniform(5, 15, (2, 6, 16)).astype(np.float32), -1)
    want = jint.integrate_rays(*map(jnp.asarray, (feat, dens, dists, zvals)))
    got = tint.integrate_rays(*map(t, (feat, dens, dists, zvals)))
    close(getattr(got, field), getattr(want, field), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("inverse", [False, True])
def test_gaze_rotation(rng, inverse):
    gaze = rng.uniform(-0.8, 0.8, (3, 2)).astype(np.float32)
    close(trot.gaze_rotation_matrices(t(gaze), inverse),
          jrot.gaze_rotation_matrices(jnp.asarray(gaze), inverse))
    fm = rng.standard_normal((3, 4, 5, 12)).astype(np.float32)
    close(trot.rotate_feature_planes(t(fm), t(gaze), inverse),
          jrot.rotate_feature_planes(jnp.asarray(fm), jnp.asarray(gaze), inverse),
          atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 5, 6, 4 * 3), (1, 1, 3, 4 * 5)])
def test_pixel_shuffle2_blur_gm(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    close(timg.pixel_shuffle2_blur_gm(t(x)),
          jimg.pixel_shuffle2_blur_gm(jnp.asarray(x)), atol=1e-5)


def test_pixel_shuffle2_blur_gm_is_blurred_shuffle(rng):
    """Group-major phases equal the upstream shuffle order under the
    renderer's column permutation, and the stencil equals blur(shuffle)."""
    from gazenerf_tpu_torch.models.neural_renderer import gm_permutation

    x = rng.standard_normal((2, 5, 6, 4 * 3)).astype(np.float32)  # torch order c*4+k
    gm = x[..., gm_permutation(3)]
    want = jimg.blur3x3(jimg.pixel_shuffle2(jnp.asarray(x)))
    close(timg.pixel_shuffle2_blur_gm(t(gm)), want, atol=1e-5)


@pytest.mark.parametrize("axis", [2, 3])
def test_up2_axis_cf(rng, axis):
    x = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    close(timg._up2_axis_cf(t(x), axis), jimg._up2_axis_cf(jnp.asarray(x), axis))


def test_blur3x3_cf(rng):
    x = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    close(timg.blur3x3_cf(t(x)), jimg.blur3x3_cf(jnp.asarray(x)), atol=1e-5)


def test_upsample2x_blur_cf(rng):
    x = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    close(timg.upsample2x_blur_cf(t(x)), jimg.upsample2x_blur_cf(jnp.asarray(x)), atol=1e-5)


@pytest.mark.parametrize("featmap_size", [16, 64])
def test_cameras(featmap_size):
    np.testing.assert_array_equal(tcam.base_inv_inmat(featmap_size),
                                  jcam.base_inv_inmat(featmap_size))
    for k, v in tcam.base_camera(featmap_size).items():
        np.testing.assert_array_equal(v, jcam.base_camera(featmap_size)[k])


def test_lookat_camera():
    for args in [(0, 0, 12.0, 64), (30, -10, 9.5, 16)]:
        for got, want in zip(lookat_camera(*args), jax_lookat(*args)):
            np.testing.assert_array_equal(got, want)


def test_transplant_matches_jax(rng):
    """The port's copy of the numpy weight bridge writes the same state
    dict as the JAX package's, and inverts it."""
    n_blocks, widths = 2, [8, 4, 4]
    params = {"neural_render": {"bg_featmap": rng.standard_normal((1, 4, 4, 8))}}
    for i in range(n_blocks):
        F = widths[i]
        params["neural_render"][f"feat_upsample_{i}"] = {
            "layer_1": {"kernel": rng.standard_normal((F, 2 * F)), "bias": rng.standard_normal(2 * F)},
            "layer_2": {"kernel": rng.standard_normal((2 * F, 4 * F)), "bias": rng.standard_normal(4 * F)},
        }
        params["neural_render"][f"feat_layer_{i}"] = {
            "kernel": rng.standard_normal((F, widths[i + 1])), "bias": rng.standard_normal(widths[i + 1])}
    for i in range(n_blocks + 1):
        params["neural_render"][f"feat_2_rgb_{i}"] = {
            "kernel": rng.standard_normal((widths[i], 3)), "bias": rng.standard_normal(3)}
    params["fg_CD_predictor_face"] = {
        f"{n}/{s}": rng.standard_normal((3, 5) if s == "kernel" else (5,))
        for n in ("fea_0", "fea_1", "fea_2", "fea_3", "fea_4", "fea_5", "fea_6",
                  "fea_7", "density", "rgb_0", "rgb_1", "rgb_2")
        for s in ("kernel", "bias")
    }
    got = ttr.gazenerf_params_to_torch({"params": params}, n_blocks)
    want = jtr.gazenerf_params_to_torch({"params": params}, n_blocks)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    back = ttr.gazenerf_params_from_torch(got, n_blocks)["params"]
    np.testing.assert_array_equal(back["neural_render"]["bg_featmap"],
                                  params["neural_render"]["bg_featmap"])
    np.testing.assert_array_equal(back["fg_CD_predictor_face"]["fea_5/kernel"],
                                  params["fg_CD_predictor_face"]["fea_5/kernel"])
    sd = ttr.params_from_jax({"params": params}, n_blocks)
    assert all(v.dtype == torch.float32 for v in sd.values())
    assert tuple(sd["neural_render.feat_layers.0.weight"].shape) == (4, 8, 1, 1)


def test_png_roundtrip(rng):
    img = rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)
    png = encode_png(img)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(decode_png(png), img)
    with pytest.raises(ValueError):
        encode_png(img.astype(np.float32))
    bad = bytearray(png)
    bad[-20] ^= 0xFF  # corrupt the image data
    with pytest.raises(ValueError):
        decode_png(bytes(bad))


def test_gm_permutation_and_residual_index():
    """The residual gather is the JAX renderer's 0/1 matrix P."""
    from gazenerf_tpu_torch.models.neural_renderer import gm_permutation, residual_index

    F = 5
    P = np.zeros((F, 4 * F), np.float32)  # as built in the JAX renderer
    for k in range(4):
        for c in range(F):
            P[(4 * c + k) % F, k * F + c] = 1.0
    x = np.arange(3 * F, dtype=np.float32).reshape(3, F)
    np.testing.assert_array_equal(x[:, residual_index(F)], x @ P)
    perm = gm_permutation(F)
    assert sorted(perm.tolist()) == list(range(4 * F))
    assert all(perm[k * F + c] == c * 4 + k for k in range(4) for c in range(F))
    assert math.isclose(float(P.sum()), 4 * F)
