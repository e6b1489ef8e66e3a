"""The loss stack's frozen gaze estimator, the PatchGAN discriminator and
the losses they feed, against the JAX package.

The same numpy inputs and weights (carried across by ``utils/transplant``)
go through the JAX package's ``GazeVGG``, ``PatchGAN``, ``compute_losses``
(angular and generator terms, the unbatched VGG path), the discriminator's
loss, its gradient and its Adam, the image strip's helpers, and through
the port's.  The JAX side of each comparison runs once per module.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from gazenerf_tpu.config import LossConfig as JaxLossConfig
from gazenerf_tpu.config import TrainConfig as JaxTrainConfig
from gazenerf_tpu.losses import gazenerf_loss as jax_losses
from gazenerf_tpu.models.discriminator import PatchGAN as JaxPatchGAN
from gazenerf_tpu.models.vgg import GazeVGG as JaxGazeVGG
from gazenerf_tpu.models.vgg import VGG16Features as JaxVGG
from gazenerf_tpu.models.vgg import gaze_vgg_from_torch as jax_gaze_vgg_from_torch
from gazenerf_tpu.ops.image import resize_bilinear as jax_resize
from gazenerf_tpu.train import state as jax_state
from gazenerf_tpu.utils import logging as jax_logging
from gazenerf_tpu_torch import Config, LossConfig, TrainConfig
from gazenerf_tpu_torch.losses import gazenerf_loss as losses_mod
from gazenerf_tpu_torch.models.discriminator import PatchGAN
from gazenerf_tpu_torch.models.vgg import VGG16_CONV_IDX, GazeVGG, VGG16Features
from gazenerf_tpu_torch.train.state import make_disc_optimizer
from gazenerf_tpu_torch.train.trainer import FrozenNets, discriminator_step
from gazenerf_tpu_torch.utils import logging as port_logging
from gazenerf_tpu_torch.utils.transplant import (
    gaze_vgg_params_from_jax,
    patchgan_params_from_jax,
    vgg_params_from_jax,
)
from test_logging import FakeWandb
from test_torch_train import _random_biases, _rel_l2, make_batch
from torch_threads import one_thread  # noqa: F401

B, SIZE = 2, 64
# f32 on both sides through a VGG16 or the PatchGAN: the two frameworks'
# convolutions sum in other orders (relative L2 of a conv stack's output
# ~1e-6, tests/test_torch_train.py); outputs and losses are held to 1e-5
# relative, gradients to the ROADMAP's 2e-3 relative L2.
RTOL = 1e-5
GRAD_REL_L2 = 2e-3


def _np(t):
    return t.detach().numpy()


def jax_gan_variables(seed):
    """JAX ``GazeVGG`` variables and ``PatchGAN`` variables (running
    statistics off their initial values), with random biases, from a numpy
    seed."""
    rng = np.random.default_rng(seed)
    x = jnp.zeros((1, 224, 224, 3))
    gaze_vars = _random_biases(jax.jit(JaxGazeVGG().init)(jax.random.PRNGKey(3), x), rng)
    dvars = jax.jit(JaxPatchGAN().init, static_argnames=("train",))(
        jax.random.PRNGKey(4), x, train=True)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (0.1 * rng.standard_normal(v.shape) if p[-1].key == "mean"
                      else rng.uniform(0.5, 2.0, v.shape)).astype(np.float32),
        dvars["batch_stats"])
    return gaze_vars, {"params": _random_biases(dvars["params"], rng), "batch_stats": stats}


@pytest.fixture(scope="module")
def nets():
    """JAX's GazeVGG, PatchGAN and perceptual VGG16 (:func:`jax_gan_variables`),
    and the port's nets on the same weights."""
    gaze_vars, dvars = jax_gan_variables(21)
    vgg = JaxVGG()
    vgg_vars = _random_biases(jax.jit(vgg.init)(jax.random.PRNGKey(5), jnp.zeros((1, 224, 224, 3))),
                              np.random.default_rng(22))
    port_gaze = GazeVGG()
    port_gaze.load_state_dict(gaze_vgg_params_from_jax(gaze_vars), strict=True)
    port_disc = PatchGAN()
    port_disc.load_state_dict(patchgan_params_from_jax(dvars), strict=True)
    port_vgg = VGG16Features()
    port_vgg.load_state_dict(vgg_params_from_jax(vgg_vars), strict=True)
    for n in (port_gaze, port_vgg):
        n.requires_grad_(False)
    return ((JaxGazeVGG(), gaze_vars, JaxPatchGAN(), dvars, vgg, vgg_vars),
            (port_gaze, port_disc, port_vgg))


def _images(seed, n=B, size=224, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((n, size, size, 3))).astype(np.float32)


def test_gaze_vgg_matches_jax(nets):
    """The gaze estimator on ImageNet-normalised-sized inputs at 224^2:
    gaze and head pitch-yaw within f32 noise of JAX's."""
    (gaze, gaze_vars, *_), (port_gaze, *_) = nets
    x = _images(30)
    want = jax.jit(gaze.apply)(gaze_vars, jnp.asarray(x))
    with torch.no_grad():
        got = port_gaze(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (B, 2)
        assert np.abs(np.asarray(w)).max() > 1e-3  # not saturated at 0
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL, atol=1e-6)


def test_gaze_vgg_loads_upstream_checkpoint(tmp_path):
    """``LossConfig.gaze_ckpt`` names upstream's gaze network state dict
    (``vgg16.N`` convolutions, ``FC1..3``, under ``model_state``, with
    ``module.`` prefixes): the frozen net holds its tensors, and on a small
    image gives what JAX's ``gaze_vgg_from_torch`` of the same dict gives."""
    gen = torch.Generator().manual_seed(1)
    net = GazeVGG()
    sd = {}
    for i, tidx in enumerate(VGG16_CONV_IDX):
        conv = net.features.convs[i]
        sd[f"module.vgg16.{tidx}.weight"] = 0.1 * torch.randn(conv.weight.shape, generator=gen)
        sd[f"module.vgg16.{tidx}.bias"] = 0.1 * torch.randn(conv.bias.shape, generator=gen)
    for fc in ("FC1", "FC2", "FC3"):
        lin = getattr(net, fc)
        sd[f"module.{fc}.weight"] = 0.3 * torch.randn(lin.weight.shape, generator=gen)
        sd[f"module.{fc}.bias"] = 0.1 * torch.randn(lin.bias.shape, generator=gen)
    path = tmp_path / "gaze_vgg.pth"
    torch.save({"model_state": sd}, path)
    frozen = FrozenNets(Config(loss=LossConfig(use_vgg_loss=False, use_angular_loss=True,
                                               gaze_ckpt=str(path))), device="cpu")
    assert frozen.vgg is None and not frozen.gaze.training
    assert not any(p.requires_grad for p in frozen.gaze.parameters())
    torch.testing.assert_close(frozen.gaze.features.convs[12].weight,
                               sd["module.vgg16.28.weight"], rtol=0, atol=0)
    torch.testing.assert_close(frozen.gaze.FC3.bias, sd["module.FC3.bias"], rtol=0, atol=0)
    params = jax_gaze_vgg_from_torch({k.replace("module.", ""): v.numpy() for k, v in sd.items()})
    x = _images(31, size=64)
    want = JaxGazeVGG().apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = frozen.gaze(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL, atol=1e-6)


@pytest.fixture(scope="module")
def disc_case(nets):
    """The PatchGAN in training mode (outputs, updated statistics) and then
    in eval mode (on those statistics), in both packages."""
    (_, _, disc, dvars, *_), (_, port_disc, _) = nets
    x = _images(32, scale=0.5)
    y, new = jax.jit(lambda v, a: disc.apply(v, a, train=True, mutable=["batch_stats"]))(
        dvars, jnp.asarray(x))
    y_eval = jax.jit(lambda v, a: disc.apply(v, a, train=False))(
        {"params": dvars["params"], "batch_stats": new["batch_stats"]}, jnp.asarray(x))
    with torch.no_grad():
        got = port_disc(torch.from_numpy(x), train=True)
        stats = {k: v.clone() for k, v in port_disc.state_dict().items() if "running" in k}
        got_eval = port_disc(torch.from_numpy(x), train=False)
    port_disc.load_state_dict(patchgan_params_from_jax(dvars), strict=True)  # as it was
    want = {"train": np.asarray(y), "eval": np.asarray(y_eval)}
    return {"train": _np(got), "eval": _np(got_eval)}, want, stats, new["batch_stats"]


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_patchgan_matches_jax(disc_case, mode):
    """Patch logits ``[B, 20, 20, 1]`` at 224^2, normalised by the batch's
    statistics (train) or the running ones (eval), within f32 noise of
    JAX's."""
    got, want, _, _ = disc_case
    assert got[mode].shape == want[mode].shape == (B, 20, 20, 1)
    np.testing.assert_allclose(got[mode], want[mode], rtol=RTOL,
                               atol=RTOL * np.abs(want[mode]).max())


@pytest.mark.parametrize("norm", ["norm1", "norm2", "norm3"])
def test_patchgan_batch_statistics_match_jax(disc_case, norm):
    """A training forward moves the running mean and variance as flax's
    BatchNorm does: 0.9 of the old value and 0.1 of the batch's, the
    variance biased (``E[x^2] - E[x]^2``); torch's BatchNorm2d would take
    the unbiased one, n / (n - 1) larger (norm3: n = 2 x 23 x 23)."""
    _, _, stats, new = disc_case
    for port_key, jax_key in (("running_mean", "mean"), ("running_var", "var")):
        want = np.asarray(new[norm][jax_key])
        np.testing.assert_allclose(_np(stats[f"{norm}.{port_key}"]), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(), err_msg=f"{norm}.{port_key}")


def test_discriminator_step_matches_jax(nets):
    """One discriminator update (``discriminator_step``): its loss, its
    gradient per parameter and the statistics after the real and the fake
    batch, against ``jax.value_and_grad`` of the JAX step's
    ``disc_loss_fn``; the parameters come out frozen.  The batch
    statistics' backward (of ``E[x^2] - E[x]^2``) cancels: both frameworks'
    f32 gradients lie up to 5.8e-3 (JAX) and 2.8e-3 (the port) relative L2
    from the float64 gradient (the port's step in float64).  So, with d =
    JAX's distance from it, the port's gradient lies within 2d of the
    float64 gradient and within 2d of JAX's, as the bf16 step tests hold
    theirs."""
    (_, _, disc, dvars, *_), _ = nets
    rng = np.random.default_rng(33)
    merge = rng.random((B, SIZE, SIZE, 3), dtype=np.float32)
    batch = make_batch(34, 16)
    gt, hm = batch["image"], batch["head_mask"][..., None]

    def disc_loss_fn(dp, stats):
        fake = jax_resize(jnp.asarray(merge), (224, 224))
        real = jax_resize(jnp.where(jnp.broadcast_to(hm < 0.5, gt.shape), 1.0, gt), (224, 224))
        r, v1 = disc.apply({"params": dp, "batch_stats": stats}, real, train=True,
                           mutable=["batch_stats"])
        f, v2 = disc.apply({"params": dp, "batch_stats": v1["batch_stats"]}, fake, train=True,
                           mutable=["batch_stats"])
        return jax_losses.discriminator_loss(r, f), v2["batch_stats"]

    (want_loss, want_stats), want_g = jax.jit(jax.value_and_grad(disc_loss_fn, has_aux=True))(
        dvars["params"], dvars["batch_stats"])
    want_g = patchgan_params_from_jax({"params": want_g, "batch_stats": want_stats})
    got = {}
    for dtype in (torch.float32, torch.float64):
        port = PatchGAN()
        port.load_state_dict(patchgan_params_from_jax(dvars), strict=True)
        port.to(dtype)
        opt = torch.optim.SGD(port.parameters(), lr=0.0)  # the gradient, no move
        loss = discriminator_step(port, opt, *(torch.from_numpy(a).to(dtype)
                                               for a in (merge, gt, hm)))
        assert not any(p.requires_grad for p in port.parameters())
        got[dtype] = loss, port
    loss, port = got[torch.float32]
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL)
    truth = dict(got[torch.float64][1].named_parameters())
    truth_stats = got[torch.float64][1].state_dict()
    for name, p in port.named_parameters():
        t = _np(truth[name].grad)
        d = _rel_l2(_np(want_g[name]), t)
        assert 0 < d < 2e-2, name
        assert _rel_l2(_np(p.grad), t) < 2 * d, name
        assert _rel_l2(_np(p.grad), _np(want_g[name])) < 2 * d, name
    for name, t in port.state_dict().items():  # the statistics, by the same rule
        if "running" in name:
            truth_t = _np(truth_stats[name])
            d = _rel_l2(_np(want_g[name]), truth_t)
            assert _rel_l2(_np(t), truth_t) < 2 * d, name
            assert _rel_l2(_np(t), _np(want_g[name])) < 2 * d, name


def test_disc_optimizer_matches_optax():
    """The discriminator's Adam: L2 weight decay added to the gradient, then
    Adam at the constant lr, as ``make_disc_optimizer`` chains it in optax,
    over four steps."""
    tcfg = TrainConfig(lr=1e-2, disc_lr_weight_decay=0.05)
    rng = np.random.default_rng(35)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in
            (("w", (6, 5)), ("b", (5,)))}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(4)]
    tx = jax_state.make_disc_optimizer(JaxTrainConfig(lr=1e-2, disc_lr_weight_decay=0.05))
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = make_disc_optimizer(tcfg, tp.values())
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in init:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), atol=1e-6, err_msg=k)


def test_gan_bce_losses_match_jax():
    """The three GAN losses with upstream's inverted labels, their values
    and gradients with respect to the logits, at f32 tolerance."""
    rng = np.random.default_rng(36)
    real, fake = (3.0 * rng.standard_normal((B, 20, 20, 1))).astype(np.float32), \
        (3.0 * rng.standard_normal((B, 20, 20, 1))).astype(np.float32)
    fns = {
        "bce_real_label": (lambda r, f: jax_losses.gan_bce_with_logits(r, 0.0),
                           lambda r, f: losses_mod.gan_bce_with_logits(r, 0.0)),
        "bce_fake_label": (lambda r, f: jax_losses.gan_bce_with_logits(f, 1.0),
                           lambda r, f: losses_mod.gan_bce_with_logits(f, 1.0)),
        "discriminator": (jax_losses.discriminator_loss, losses_mod.discriminator_loss),
        "generator": (lambda r, f: jax_losses.generator_loss(f),
                      lambda r, f: losses_mod.generator_loss(f)),
    }
    for name, (jfn, tfn) in fns.items():
        want, want_g = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(real), jnp.asarray(fake))
        tr, tf = (torch.from_numpy(a).requires_grad_(True) for a in (real, fake))
        got = tfn(tr, tf)
        got_g = torch.autograd.grad(got, [tr, tf], allow_unused=True)
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL, err_msg=name)
        for g, w in zip(got_g, want_g):
            g = np.zeros_like(real) if g is None else _np(g)
            np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=1e-9, err_msg=name)


STEP = 7  # past the warm-up's zero: 7 / 20 > the cap 0.1
EYE_IMP = 70.0  # the gradual importance at epoch 2 (10 + 30 * 2)
LOSS_KEYS = ["angular", "gen_patch_gan_loss", "vgg_face_loss", "vgg_eyes_loss", "vgg",
             "head_loss", "total_loss"]


@pytest.fixture(scope="module")
def loss_case(nets):
    """Predicted images, ground truth and masks through both loss stacks
    with the angular term (gaze-VGG), the generator term (the PatchGAN in
    eval mode) at ``STEP`` and the unbatched perceptual VGG, the eye
    importance given; the gradient with respect to the predicted images
    too.  The port's stack also runs with the batched VGG."""
    (gaze, gaze_vars, disc, dvars, vgg, vgg_vars), (port_gaze, port_disc, port_vgg) = nets
    rng = np.random.default_rng(37)
    batch = make_batch(38, 16)
    keys = ("merge_img", "merge_img_face", "merge_img_eyes", "bg_img")
    pred = {k: rng.random((1 if k == "bg_img" else B, SIZE, SIZE, 3), dtype=np.float32)
            for k in keys}
    # the merged image in [-5, 5]: on [0, 1] images the seeded gaze-VGG's
    # estimates lie under 1 degree apart, where the arccos of an f32 cosine
    # near 1 carries a percent of rounding; ~13 degrees apart it does not
    pred["merge_img"] = 10.0 * (pred["merge_img"] - 0.5)
    masks = [batch[k][..., None] for k in ("head_mask", "left_eye_mask", "right_eye_mask")]
    kw = dict(use_angular_loss=True, use_patch_gan_loss=True, vgg_batched=False,
              gan_warmup_steps=20)
    jcfg = JaxLossConfig(**kw)

    def jax_loss(p):
        out = jax_losses.compute_losses(
            jcfg, p, jnp.asarray(batch["image"]), *map(jnp.asarray, masks),
            eye_loss_importance=jnp.float32(EYE_IMP),
            vgg_capture_fn=lambda x: vgg.apply(vgg_vars, x)[0],
            gaze_fn=lambda x: gaze.apply(gaze_vars, x),
            disc_fn=lambda x: disc.apply(dvars, x, train=False), step=STEP)
        return out["total_loss"], out

    (_, want), want_g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in pred.items()})

    got = {}
    for batched in (False, True):
        tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in pred.items()}
        out = losses_mod.compute_losses(
            LossConfig(**{**kw, "vgg_batched": batched}), tp, torch.from_numpy(batch["image"]),
            *map(torch.from_numpy, masks), eye_loss_importance=EYE_IMP, vgg_capture_fn=port_vgg,
            gaze_fn=port_gaze, disc_fn=lambda x: port_disc(x, train=False), step=STEP)
        out["total_loss"].backward()
        got[batched] = ({k: float(v) for k, v in out.items()},
                        {k: _np(t.grad) for k, t in tp.items()})
    return got, {k: float(v) for k, v in want.items()}, {k: np.asarray(v) for k, v in want_g.items()}


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_losses_match_jax(loss_case, key):
    """The angular term (``angular_scale * eye importance`` times the mean
    angle, in degrees, between the estimates on the prediction and on the
    head-filled target), the generator term (``clip(step / warm-up, 0,
    cap)`` times the BCE of the discriminator's eval logits toward 0), the
    unbatched perceptual losses and the total: relative 1e-5 (the VGG
    losses 3e-5, ``tests/test_torch_train.py``'s ``VGG_LOSS_RTOL``)."""
    got, want, _ = loss_case
    assert want[key] > 0
    rtol = 3e-5 if key.startswith("vgg") else RTOL
    np.testing.assert_allclose(got[False][0][key], want[key], rtol=rtol, err_msg=key)


@pytest.mark.parametrize("image", ["merge_img", "merge_img_face", "merge_img_eyes", "bg_img"])
def test_loss_gradients_match_jax(loss_case, image):
    """The backward of the whole stack (the gaze-VGG on the prediction only,
    the PatchGAN, the unbatched VGG) with respect to each predicted image:
    relative L2 under 2e-3."""
    got, _, want_g = loss_case
    assert _rel_l2(got[False][1][image], want_g[image]) < GRAD_REL_L2


def test_batched_vgg_equals_unbatched(loss_case):
    """``vgg_batched`` (two calls of 3B rows) against six calls: the same
    losses to f32 noise (a convolution's order may depend on the batch) and
    the same gradients."""
    got, _, _ = loss_case
    for k, v in got[False][0].items():
        np.testing.assert_allclose(got[True][0][k], v, rtol=RTOL, err_msg=k)
    for k, g in got[False][1].items():
        assert _rel_l2(got[True][1][k], g) < 1e-5, k


def test_gan_warmup_matches_jax():
    """The generator term's weight: 0 at step 0, linear, capped."""
    cfg = LossConfig(gan_warmup_steps=200, gan_warmup_cap=0.1)
    for step in (0, 1, 7, 20, 199, 10**6):
        want = float(jnp.clip(jnp.asarray(step, jnp.float32) / 200, 0.0, 0.1))
        assert losses_mod.gan_warmup(cfg, step) == want, step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_image_strip_matches_jax(dtype):
    """``log_all_images``: the five-panel strip (target | merged | face |
    eyes | background) of the first row, uint8, the same bytes as the JAX
    package's from the same images (bf16 images rounded as its numpy
    rounds them); a uint8 target passes through; ``log_images`` logs each
    image under its tag."""
    rng = np.random.default_rng(39)
    cd = {k: rng.uniform(-0.1, 1.1, (n, SIZE, SIZE, 3)).astype(np.float32)
          for k, n in (("merge_img", B), ("merge_img_face", B), ("merge_img_eyes", B),
                       ("bg_img", 1))}
    gt = rng.integers(0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8)
    want_w, got_w = FakeWandb(), FakeWandb()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jax_logging.log_all_images(want_w, jnp.asarray(gt), {k: jnp.asarray(v, jdt) for k, v in cd.items()})
    port_logging.log_all_images(got_w, torch.from_numpy(gt),
                                {k: torch.from_numpy(v).to(tdt) for k, v in cd.items()})
    (want,), (got,) = want_w.logged, got_w.logged
    w, g = want["Prediction"].data, got["Prediction"].data
    assert g.dtype == np.uint8 and g.shape == (SIZE, 5 * SIZE, 3)
    np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(g[:, :SIZE], gt[0])
    jax_logging.log_images(want_w, "val", {"a": jnp.asarray(cd["bg_img"][0], jdt)}, step=3)
    port_logging.log_images(got_w, "val", {"a": torch.from_numpy(cd["bg_img"][0]).to(tdt)}, step=3)
    np.testing.assert_array_equal(got_w.logged[-1]["val/a"].data, want_w.logged[-1]["val/a"].data)
    assert port_logging.log_all_images(None, gt, cd) is None  # no wandb: a no-op
