"""The training step with the full loss stack against the JAX package, and
the trainer's loop around it.

Small size (``tests/test_torch_train.py``'s setup: hidden 64, featmap 16,
8 samples, 64x64 images, B=2) with the angular gaze loss (a seeded
gaze-VGG), the PatchGAN and its update, and the gradual eye importance:
one step of the port's ``Trainer`` against the JAX package's
``make_train_step`` (jitted once) from the same state, past the generator
term's warm-up zero; then, on the port alone, the gradual importance over
epochs, ``steps_per_dispatch`` against one step per dispatch, and a GAN
run resumed from a checkpoint against the uninterrupted run.
"""

import dataclasses
import types

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import gazenerf_tpu.models.gaze_nerf as jax_gaze_nerf
from gazenerf_tpu.config import LossConfig as JaxLossConfig
from gazenerf_tpu.models.discriminator import PatchGAN as JaxPatchGAN
from gazenerf_tpu.train import state as jax_state
from gazenerf_tpu.train.trainer import FrozenNets as JaxFrozenNets
from gazenerf_tpu.train.trainer import make_train_step as jax_make_train_step
from gazenerf_tpu_torch import Config, LossConfig, ModelConfig, TrainConfig, Trainer
from gazenerf_tpu_torch.train import trainer as trainer_mod
from gazenerf_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from gazenerf_tpu_torch.utils.transplant import (
    gaze_vgg_params_from_jax,
    load_train_state_from_jax,
    patchgan_params_from_jax,
)
from test_logging import FakeWandb
from test_torch_gan_losses import jax_gan_variables
from test_torch_train import (  # noqa: F401
    B,
    GROUPS,
    JITTER_KEY,
    STEP_GRAD_REL_L2,
    TRAIN_LEN,
    _fixed_key_sampler,
    _group_rel_l2,
    _rel_l2,
    make_batch,
    setup,
)
from torch_threads import one_thread  # noqa: F401

# the loss stack of the step comparison: the angular and GAN terms, the
# gradual importance; the perceptual VGG is held to JAX's on its own in
# tests/test_torch_train.py and stays off here (half the compile)
LOSS = dict(use_vgg_loss=False, use_angular_loss=True, use_patch_gan_loss=True,
            is_gradual_loss=True, gan_warmup_steps=20)
STEP = 7  # the step count: warm-up 7 / 20, capped at 0.1
EYE_IMP = 70.0  # the gradual importance of epoch 2 (10 + 30 * 2)
LR = 1e-4  # the default learning rate: the discriminator's Adam
LOSS_KEYS = ("angular", "gen_patch_gan_loss", "disc_patch_gan_loss", "head_loss", "face_loss",
             "eyes_loss", "bg_loss", "nonhead_loss", "delta_eular", "total_loss")


def _grad_capture():
    """An optax transformation whose state becomes the gradient it is given
    and whose update is zero: the JAX step then returns its gradients."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


@pytest.fixture(scope="module")
def full_step(setup):
    """One step from the same state on both sides: JAX's ``make_train_step``
    (its network gradient captured, the real discriminator Adam) and the
    port's ``Trainer.train_step`` without the network update.  The port's
    discriminator gradient is read right after its update, and again after
    the generator's backward."""
    jcfg, params, offsets, _, _, batch = setup
    jcfg = jcfg.replace(loss=JaxLossConfig(**LOSS))
    gaze_vars, dvars = jax_gan_variables(41)
    frozen = JaxFrozenNets(jcfg, jax.random.PRNGKey(0))
    frozen.gaze_params = gaze_vars
    capture, dopt = _grad_capture(), jax_state.make_disc_optimizer(jcfg.train)
    step = jax_make_train_step(jcfg, jax_gaze_nerf.GazeNeRF(jcfg.model), capture, frozen,
                               np.zeros(jcfg.model.expr_code_dims, np.float32),
                               disc=JaxPatchGAN(), disc_optimizer=dopt, donate=False)
    trainable = {"net": params, **{k: jnp.asarray(v) for k, v in offsets.items()}}
    state = jax_state.TrainState(
        step=jnp.asarray(STEP), params=params, offsets={k: jnp.asarray(v) for k, v in offsets.items()},
        opt_state=capture.init(trainable), rng=jax.random.PRNGKey(0),
        disc_params=dvars["params"], disc_batch_stats=dvars["batch_stats"],
        disc_opt_state=dopt.init(dvars["params"]))
    with pytest.MonkeyPatch.context() as mp:
        _fixed_key_sampler(mp)
        new, want = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                         jnp.float32(EYE_IMP))
    want_grads = new.opt_state

    cfg = Config(model=ModelConfig(**dataclasses.asdict(jcfg.model)), loss=LossConfig(**LOSS),
                 train=TrainConfig(**dataclasses.asdict(jcfg.train)))
    tr = Trainer(cfg, train_len=TRAIN_LEN, steps_per_epoch=1, device="cpu")
    load_train_state_from_jax(tr, types.SimpleNamespace(params=params, offsets=offsets),
                              cfg.model.n_upsample_blocks)
    tr.frozen.gaze.load_state_dict(gaze_vgg_params_from_jax(gaze_vars), strict=True)
    tr.disc.load_state_dict(patchgan_params_from_jax(dvars), strict=True)
    tr.step = STEP
    disc_old = {k: v.clone() for k, v in tr.disc.state_dict().items()}
    disc_grads = []
    opt_step = tr.disc_optimizer.step
    tr.disc_optimizer.step = lambda *a: (  # the gradient its update took
        disc_grads.append({n: p.grad.clone() for n, p in tr.disc.named_parameters()}),
        opt_step(*a))[1]
    m = cfg.model
    t_rand = torch.from_numpy(np.asarray(
        jax.random.uniform(JITTER_KEY, (B, m.num_rays, m.num_sample_coarse + 1))))
    got = tr.train_step(batch, t_rand=t_rand, update=False, eye_imp=EYE_IMP)
    grads = {"net": {n: p.grad for n, p in tr.model.named_parameters()}}
    grads.update({k: p.grad for k, p in tr.offsets.items()})
    return (got, grads, tr, disc_old, disc_grads), (want, want_grads, new), cfg


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_full_loss_step_losses_match_jax(full_step, key):
    """Every loss of the step, the angular term (eye importance 70), the
    generator term (through the updated discriminator, warm-up 7 / 20
    capped at 0.1) and the discriminator's loss included: f32 on both
    sides, relative 1e-4, as ``tests/test_torch_train.py``'s f32 step (the
    generator term reads the updated discriminator, whose update differs
    now and then in a near-zero gradient's sign: 6.0e-5 relative)."""
    (got, *_), (want, *_), _ = full_step
    assert set(got) == set(want)
    assert float(want[key]) != 0.0
    np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, atol=1e-7,
                               err_msg=key)


@pytest.mark.parametrize("group", GROUPS)
def test_full_loss_step_gradients_match_jax(full_step, setup, group):
    """The network's and the offsets' gradients of the full-loss step: per
    group within the f32 step's tolerances of ``tests/test_torch_train.py``
    (2e-3 relative L2; the camera offsets twice JAX's own jitted-vs-eager
    spread)."""
    (_, grads, *_), (_, want, _), cfg = full_step
    n_blocks = cfg.model.n_upsample_blocks
    assert _group_rel_l2(grads, want, group, n_blocks) < STEP_GRAD_REL_L2[group]


def test_full_loss_step_discriminator_matches_jax(full_step):
    """The discriminator after the step: its BatchNorm statistics after the
    real and the fake batch within f32 noise of JAX's, and its Adam update.
    The batch means cancel (``tests/test_torch_gan_losses.py`` reads JAX
    1.2e-5 from float64 on the same inputs); here each side's fake batch is
    its own render, itself f32 noise apart, and the statistics read up to
    2.8e-5 apart (norm2's mean): relative L2 under 6e-5, twice that.  Adam's
    first step moves each parameter by lr times the sign of its gradient
    (plus the weight decay) wherever the gradient is far from 0; where it
    is near 0 the two frameworks' f32 gradients (3e-3 apart, relative L2,
    in that test) take other signs now and then.  So the updates agree to
    1e-3 lr on at least 99% of each tensor's elements, or on all but one of
    a small tensor (readings: 99.67% of conv2's at least; one of conv1's 64
    biases).  The
    generator's backward leaves the discriminator no gradient: its
    parameters hold the update's gradient, to the bit."""
    (_, _, tr, old, disc_grads), (_, _, new), _ = full_step
    want = patchgan_params_from_jax({"params": new.disc_params,
                                     "batch_stats": new.disc_batch_stats})
    got = tr.disc.state_dict()
    for name, t in got.items():
        w = want[name].numpy()
        if "running" in name:
            assert _rel_l2(t.numpy(), w) < 6e-5, name
        else:
            upd, want_upd = (t - old[name]).numpy(), w - old[name].numpy()
            assert np.abs(want_upd).max() > 0, name
            agree = np.abs(upd - want_upd) <= 1e-3 * LR  # f32 rounding of p + u
            assert np.abs(want_upd).max() > 0.9 * LR, name
            assert agree.mean() >= 0.99 or (~agree).sum() <= 1, (name, agree.mean())
    (taken,) = disc_grads
    assert not any(p.requires_grad for p in tr.disc.parameters())
    for name, p in tr.disc.named_parameters():
        assert torch.equal(p.grad, taken[name]), name


def test_gradual_eye_importance_over_epochs(monkeypatch):
    """With ``is_gradual_loss`` each epoch's steps take ``eye_loss_importance
    + 30 * epoch`` (JAX's schedule, in f32) and the epoch logs it as ``eye
    loss importance``; without it the steps take the config's."""
    seen = []
    compute = trainer_mod.compute_losses
    monkeypatch.setattr(trainer_mod, "compute_losses", lambda *a, eye_loss_importance=None, **k: (
        seen.append(eye_loss_importance), compute(*a, eye_loss_importance=eye_loss_importance,
                                                  **k))[1])
    model = ModelConfig(num_sample_coarse=8, featmap_size=16, pred_img_size=64, mlp_hidden=32,
                        use_pallas=False)
    batch = make_batch(3, 16)
    schedule = [float(jnp.float32(10.0 + 30.0 * e)) for e in range(3)]  # JAX's train_epoch
    for gradual, want in ((True, schedule), (False, [None])):
        seen.clear()
        loss = LossConfig(use_vgg_loss=False, use_angular_loss=True, is_gradual_loss=gradual)
        tr = Trainer(Config(model=model, loss=loss), train_len=TRAIN_LEN, steps_per_epoch=1,
                     device="cpu")
        wandb = FakeWandb()
        for epoch in range(len(want)):
            tr.train_epoch([batch], epoch, wandb=wandb, log_images_every=0)
        assert seen == want
        logged = [d["eye loss importance"] for d in wandb.logged if "eye loss importance" in d]
        assert logged == (want if gradual else [])
    assert schedule == [10.0, 40.0, 70.0]


def _tiny(gan: bool, k: int) -> Config:
    return Config(
        model=ModelConfig(num_sample_coarse=8, featmap_size=16, pred_img_size=64, mlp_hidden=32,
                          use_pallas=False),
        loss=LossConfig(use_vgg_loss=False, use_patch_gan_loss=gan, gan_warmup_steps=2),
        train=TrainConfig(batch_size=B, lr=1e-3, steps_per_dispatch=k, log_every=2),
    )


def _state(tr):
    """Every tensor a trainer carries from step to step."""
    out = {f"model.{k}": v for k, v in tr.model.state_dict().items()}
    out.update({f"offsets.{k}": v.detach() for k, v in tr.offsets.items()})
    if tr.disc is not None:
        out.update({f"disc.{k}": v for k, v in tr.disc.state_dict().items()})
        for i, st in tr.disc_optimizer.state_dict()["state"].items():
            out.update({f"disc_adam.{i}.{k}": v for k, v in st.items()})
    for i, st in tr.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    return out


def _batches(n):
    out = []
    for i in range(n):
        b = make_batch(10 + i, 16)
        b["sample_idx"] = np.array([i % 8, (3 * i + 1) % 8], np.int64)
        out.append(b)
    return out


@pytest.mark.parametrize("gan", [False, True], ids=["no_gan", "gan"])
def test_steps_per_dispatch_equals_one_step_per_batch(gan):
    """``steps_per_dispatch=3`` over 4 batches (one stacked dispatch of 3,
    then the remainder alone) trains exactly as one dispatch per batch: the
    same epoch loss, parameters, offsets, Adam states and, with the GAN,
    discriminator and BatchNorm statistics, to the bit (the same steps in
    the same order).  Its wandb logs follow JAX's cadence: one
    ``batch_loss`` per dispatch (the mean of its steps), the per-loss
    scalars and the image strip on the first dispatch."""
    batches = _batches(4)
    trainers, logs, sums = {}, {}, {}
    for k in (1, 3):
        tr = Trainer(_tiny(gan, k), train_len=8, steps_per_epoch=4, device="cpu", seed=5)
        logs[k] = FakeWandb()
        sums[k] = tr.train_epoch(batches, 0, wandb=logs[k], log_images_every=20)
        trainers[k] = tr
    assert sums[1]["batches"] == sums[3]["batches"] == 4
    assert sums[1]["loss"] == sums[3]["loss"]
    assert trainers[1].step == trainers[3].step == 4
    one, three = _state(trainers[1]), _state(trainers[3])
    assert set(one) == set(three) and any(k.startswith("disc.") for k in one) == gan
    for name, t in one.items():
        assert torch.equal(t, three[name]), name
    batch_losses = [[d["batch_loss"] for d in logs[k].logged if "batch_loss" in d] for k in (1, 3)]
    assert len(batch_losses[0]) == 4 and len(batch_losses[1]) == 2
    np.testing.assert_allclose(batch_losses[1][1], batch_losses[0][3], rtol=0)
    np.testing.assert_allclose(batch_losses[1][0], np.mean(batch_losses[0][:3], dtype=np.float32),
                               rtol=1e-6)
    strips = [d["Prediction"] for d in logs[3].logged if "Prediction" in d]
    assert len(strips) == 1 and strips[0].data.shape == (64, 5 * 64, 3)
    scalars = [d for d in logs[3].logged if "TRAIN Total Loss Batch" in d]
    assert len(scalars) == 2  # max(1, log_every 2 // K 3): every dispatch
    assert ("TRAIN Generator Patch GAN Loss Batch" in scalars[0]) == gan


def test_gan_checkpoint_resume_equals_uninterrupted(tmp_path):
    """A GAN run checkpointed after its first epoch and resumed into a fresh
    trainer takes its second epoch exactly as the uninterrupted run: the
    discriminator's parameters, BatchNorm statistics and Adam state are in
    the checkpoint, as in JAX's ``TrainState``."""
    batches = _batches(1)
    a = Trainer(_tiny(True, 1), train_len=8, steps_per_epoch=1, device="cpu", seed=6)
    a.train_epoch(batches, 0)
    path = save_checkpoint(str(tmp_path), a, a.cfg, 0)
    a.train_epoch(batches, 1)
    b = Trainer(_tiny(True, 1), train_len=8, steps_per_epoch=1, device="cpu", seed=9)
    _, epoch = load_checkpoint(path, b)
    assert epoch == 0
    b.train_epoch(batches, 1)
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    assert a.step == b.step == 2
    sa, sb = _state(a), _state(b)
    assert set(sa) == set(sb)
    for name, t in sa.items():
        assert torch.equal(t, sb[name]), name
    plain = Trainer(_tiny(False, 1), train_len=8, steps_per_epoch=1, device="cpu")
    with pytest.raises(ValueError, match="discriminator"):
        load_checkpoint(save_checkpoint(str(tmp_path / "plain"), plain, plain.cfg, 0), b)


def test_disc_state_restores_a_step():
    """A step updates the discriminator (also without the network update):
    ``disc_state`` / ``load_disc_state`` restore its parameters, BatchNorm
    statistics and Adam moments, so the same step from the restored state
    gives the same losses, gradients and discriminator to the bit, and the
    copy itself stays as it was."""
    tr = Trainer(_tiny(True, 1), train_len=8, steps_per_epoch=1, device="cpu", seed=7)
    (batch,) = _batches(1)
    tr.train_step(batch)  # Adam moments to restore
    t_rand = torch.rand((B, 256, 9), generator=torch.Generator().manual_seed(0))
    saved = tr.disc_state()
    runs = []
    for _ in range(2):
        tr.load_disc_state(saved)
        losses = tr.train_step(batch, t_rand=t_rand, update=False)
        runs.append((losses, {n: p.grad.clone() for n, p in tr.model.named_parameters()},
                     _state(tr)))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert all(torch.equal(l0[k], l1[k]) for k in l0) and l0["disc_patch_gan_loss"] > 0
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    assert all(torch.equal(s0[n], s1[n]) for n in s0)
    assert not torch.equal(s0["disc.conv2.weight"], saved["disc"]["conv2.weight"])
    fresh = tr.disc_state()
    tr.load_disc_state(saved)
    assert not torch.equal(tr.disc.conv2.weight, fresh["disc"]["conv2.weight"])
