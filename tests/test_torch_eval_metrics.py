"""The port's evaluation metrics against the JAX package's
(``eval/metrics.py``), on the same numpy images, weights and feature
functions: PSNR, L1, SSIM (also on near-flat images, where a window
rounded to bf16 or TF32 fails), the perceptual distances, LPIPS on
transplanted VGG16 weights, FID and the Frechet distance, identity
similarity and the angular errors."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gazenerf_tpu.eval import metrics as JM
from gazenerf_tpu.models.vgg import VGG16Features as JaxVGG
from gazenerf_tpu_torch.eval import metrics as M
from gazenerf_tpu_torch.models.vgg import PERCEPTUAL_CAPTURE, VGG16Features
from gazenerf_tpu_torch.utils.transplant import vgg_params_from_jax
from torch_threads import one_thread  # noqa: F401

# f32 on both sides; the closed-form metrics agree to f32 rounding
RTOL = 1e-5
# VGG16 features: the two frameworks' f32 convolutions sum in other orders;
# readings up to 8.9e-7 relative L2 for the LPIPS captures and 1.7e-6 for
# LPIPS itself
VGG_RTOL = 1e-4


def _images(seed, n=2, size=64, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return (lo + (hi - lo) * rng.random((n, size, size, 3))).astype(np.float32)


def _near_flat(seed, n=2, size=64):
    """In-range images whose windowed variance is far below SSIM's c2
    (9e-4): a level of 0.8 with noise of 1e-3."""
    rng = np.random.default_rng(seed)
    return (0.8 + 1e-3 * rng.standard_normal((n, size, size, 3))).astype(np.float32)


def _j(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("kind", ["random", "shifted"])
def test_psnr_l1_match_jax(kind):
    a = _images(1)
    b = _images(2) if kind == "random" else np.clip(a + 0.05, 0, 1)
    for jf, tf in ((JM.psnr, M.psnr), (JM.l1, M.l1)):
        np.testing.assert_allclose(tf(_t(a), _t(b)).numpy(), _j(jf(jnp.asarray(a), jnp.asarray(b))),
                                   rtol=RTOL)


def _ssim_bf16_window(a, b):
    """SSIM with the window's products rounded to bf16, as a bf16 (or
    bf16-pass) convolution would: the moments cancel on near-flat images."""
    g = M.gaussian_window().astype(np.float32)

    def filt(x):
        x = x.to(torch.bfloat16)
        k = len(g)
        H, W = x.shape[1] - k + 1, x.shape[2] - k + 1
        rows = sum((float(g[i]) * x[:, i:i + H]).to(torch.bfloat16) for i in range(k))
        return sum((float(g[j]) * rows[:, :, j:j + W]).to(torch.bfloat16)
                   for j in range(k)).to(torch.float32)

    c1, c2 = 0.01**2, 0.03**2
    mu_a, mu_b = filt(a), filt(b)
    sig_a, sig_b, sig_ab = filt(a * a) - mu_a**2, filt(b * b) - mu_b**2, filt(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * sig_ab + c2)) / ((mu_a**2 + mu_b**2 + c1) * (sig_a + sig_b + c2))
    return s.mean(dim=(-3, -2, -1))


@pytest.mark.parametrize("kind", ["random", "similar", "near_flat"])
def test_ssim_matches_jax(kind):
    """SSIM against JAX's (its window at precision HIGHEST): 1e-5 relative
    (readings up to 2.6e-6).  On near-flat, in-range images the windowed
    variances are ~1e-6, so a window rounded to bf16 moves SSIM by far
    more than that (here to 0.979 and 1.033 against 0.998; the JAX package
    read SSIM = 6.3 under TPU bf16 convolutions): the bf16 window is shown
    to fail."""
    if kind == "near_flat":
        a, b = _near_flat(3), _near_flat(4)
    else:
        a = _images(3)
        b = _images(4) if kind == "random" else np.clip(a + 0.02 * _images(5) - 0.01, 0, 1)
    got = M.ssim(_t(a), _t(b)).numpy()
    want = _j(JM.ssim(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    assert np.all(np.abs(got) <= 1.0)
    if kind == "near_flat":
        bad = _ssim_bf16_window(_t(a), _t(b)).numpy()
        assert np.abs(bad - want).max() > 100 * RTOL, (bad, want)


def test_gaussian_window_is_jaxs():
    g = M.gaussian_window()
    np.testing.assert_allclose(np.outer(g, g).astype(np.float32), JM._gaussian_kernel(), rtol=1e-6)


@pytest.fixture(scope="module")
def vgg():
    """One set of VGG16 weights on both sides: JAX's initialiser with
    random biases, carried over by ``vgg_params_from_jax``."""
    net = JaxVGG(capture=M.LPIPS_CAPTURE)
    variables = jax.jit(net.init)(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        if str(getattr(p[-1], "key", "")) == "bias" else np.asarray(v),
        variables["params"])
    return {"params": params}, vgg_params_from_jax({"params": params})


def test_vgg_capture_matches_jax(vgg):
    """The full 13-conv stack with LPIPS's capture points: every captured
    feature map within 1e-4 relative L2 of JAX's; any other capture set
    returns those of its points, in order."""
    jvars, sd = vgg
    x = _images(7)
    want, _ = JaxVGG(capture=M.LPIPS_CAPTURE).apply(jvars, jnp.asarray(x))
    net = VGG16Features(capture=M.LPIPS_CAPTURE)
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = net(_t(x))
    assert len(got) == len(want) == len(M.LPIPS_CAPTURE)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.linalg.norm(g.numpy() - w) / np.linalg.norm(w) < VGG_RTOL
    for capture in (PERCEPTUAL_CAPTURE, (0, 12)):
        sub = VGG16Features(capture=capture)
        sub.load_state_dict(sd, strict=True)
        with torch.no_grad():
            caps = sub(_t(x))
        assert len(caps) == len(capture)
        for i, c in zip(capture, caps):
            if i in M.LPIPS_CAPTURE:
                assert torch.equal(c, got[M.LPIPS_CAPTURE.index(i)])


def test_lpips_matches_jax(vgg):
    """``make_lpips_fn`` on the same VGG weights and linear heads (from a
    piq-style list through ``lpips_lin_from_torch``); the default heads are
    ones on every channel."""
    jvars, sd = vgg
    a, b = _images(8), _images(9)
    rng = np.random.default_rng(10)
    lin = [(0.2 * rng.random((1, c, 1, 1))).astype(np.float32) for c in M.LPIPS_CHANNELS]
    want = _j(JM.make_lpips_fn(jvars, JM.lpips_lin_from_torch(lin))(jnp.asarray(a), jnp.asarray(b)))
    got = M.make_lpips_fn(sd, M.lpips_lin_from_torch(lin))(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=VGG_RTOL)
    ones = [np.ones(c, np.float32) for c in M.LPIPS_CHANNELS]
    np.testing.assert_array_equal(M.make_lpips_fn(sd)(_t(a), _t(b)).numpy(),
                                  M.make_lpips_fn(sd, ones)(_t(a), _t(b)).numpy())


def test_lpips_lin_from_torch_matches_jax():
    rng = np.random.default_rng(11)
    sd = {f"lin{i}.model.1.weight": rng.random((1, c, 1, 1)) for i, c in enumerate(M.LPIPS_CHANNELS)}
    for got, want in zip(M.lpips_lin_from_torch(sd), JM.lpips_lin_from_torch(sd)):
        np.testing.assert_array_equal(got, want)


def test_lpips_like_matches_jax(vgg):
    """The uniform-weight distance over the loss stack's VGG captures."""
    jvars, sd = vgg
    a, b = _images(12), _images(13)
    jnet = JaxVGG(capture=PERCEPTUAL_CAPTURE)
    net = VGG16Features()
    net.load_state_dict(sd, strict=True)
    want = _j(JM.lpips_like(lambda x: jnet.apply(jvars, x)[0], jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = M.lpips_like(net, _t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=VGG_RTOL)


_PROJ = np.random.default_rng(14).standard_normal((6, 5))


def _feats_np(x):
    """A feature function both sides compute alike: per-channel means and
    mean squares through a fixed projection, ``[B, 5]``."""
    return np.concatenate([x.mean((1, 2)), (x * x).mean((1, 2))], -1) @ _PROJ


def test_fid_and_frechet_distance_match_jax():
    set_a = list(_images(15, n=6, size=16))
    set_b = list(_images(16, n=6, size=16, lo=0.2))

    def jfeats(x):
        return jnp.asarray(_feats_np(np.asarray(x)))

    def tfeats(x):
        return torch.from_numpy(_feats_np(x.numpy()))

    want = JM.fid(jfeats, set_a, set_b, batch_size=4)
    got = M.fid(tfeats, [_t(x) for x in set_a], [_t(x) for x in set_b], batch_size=4)
    # JAX holds the features in f32 (no x64), the port keeps them in float64
    assert got == pytest.approx(want, rel=RTOL)
    fa, fb = np.random.default_rng(17).standard_normal((2, 50, 5))
    assert M.frechet_distance(fa, fb + 0.5) == JM.frechet_distance(fa, fb + 0.5)
    assert abs(M.frechet_distance(fa, fa)) < 1e-9


def test_identity_similarity_matches_jax():
    a, b = _images(18), _images(19)
    W = np.random.default_rng(20).standard_normal((3, 8)).astype(np.float32)
    want = JM.identity_similarity(lambda x: x.mean((1, 2)) @ W, jnp.asarray(a), jnp.asarray(b))
    got = M.identity_similarity(lambda x: x.mean((1, 2)) @ torch.from_numpy(W), _t(a), _t(b))
    np.testing.assert_allclose(got.numpy(), _j(want), rtol=RTOL, atol=1e-6)


def test_gaze_and_head_error_match_jax():
    """Angular errors through an estimator that reads pitch-yaw pairs off
    the images' channel means."""
    a, b = _images(21), _images(22)

    def est(x, lib):
        m = x.mean((1, 2))
        return lib.stack([m[:, 0] - 0.5, m[:, 1] - 0.5], 1), lib.stack([m[:, 2] - 0.5, m[:, 0]], 1)

    want = JM.gaze_and_head_error(lambda x: est(x, jnp), jnp.asarray(a), jnp.asarray(b))
    got = M.gaze_and_head_error(lambda x: est(x, torch), _t(a), _t(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _j(w), rtol=1e-4, atol=1e-4)
