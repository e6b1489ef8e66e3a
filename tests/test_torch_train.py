"""The PyTorch port's training step against the JAX package.

Small size (hidden 64, featmap 16, 8 samples, 64x64 images, B=2): the same
numpy batch, weights (``params_from_jax``, ``vgg_params_from_jax``), offset
tables and jitter draws go through the JAX loss / gradient and the port's
``Trainer``.  The jitter draws are rebuilt from one key: the JAX model's
sampler is handed that key, and the port ``jax.random.uniform`` of it.
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
from gazenerf_tpu.config import TrainConfig as JaxTrainConfig
from gazenerf_tpu.config import small_test_config as jax_small_config
from gazenerf_tpu.losses.gazenerf_loss import compute_losses as jax_compute_losses
from gazenerf_tpu.models.vgg import VGG16Features as JaxVGG
from gazenerf_tpu.ops import pixel_grid as jax_pixel_grid
from gazenerf_tpu.ops.image import resize_bilinear as jax_resize
from gazenerf_tpu.ops.rays import sample_coarse as jax_sample_coarse
from gazenerf_tpu.ops.rotation import euler_to_rotation as jax_euler
from gazenerf_tpu.train import state as jax_state
from gazenerf_tpu.train.trainer import compose_codes_and_cams as jax_compose
from gazenerf_tpu.train.trainer import make_eval_step as jax_make_eval_step
from gazenerf_tpu.train.trainer import scale_intrinsics_jnp
from gazenerf_tpu_torch import Config, LossConfig, ModelConfig, TrainConfig, Trainer
from gazenerf_tpu_torch.data.cameras import base_inv_inmat
from gazenerf_tpu_torch.losses.gazenerf_loss import compute_losses
from gazenerf_tpu_torch.models.vgg import VGG16Features
from gazenerf_tpu_torch.ops.image import resize_bilinear
from gazenerf_tpu_torch.ops.rays import sample_coarse
from gazenerf_tpu_torch.ops.rotation import euler_to_rotation
from gazenerf_tpu_torch.train.state import lr_schedule, make_optimizer
from gazenerf_tpu_torch.models.vgg import VGG16_CONV_IDX
from gazenerf_tpu_torch.train.trainer import FrozenNets, decode_uint8_batch, scale_intrinsics
from gazenerf_tpu_torch.utils.transplant import (
    load_train_state_from_jax,
    params_from_jax,
    vgg_params_from_jax,
)
from torch_threads import one_thread  # noqa: F401

B, SIZE, TRAIN_LEN = 2, 64, 4
GROUPS = ("net", "iden", "expr", "appea", "euler", "tvec")
JITTER_KEY = jax.random.PRNGKey(11)
# f32 port vs f32 JAX: the ROADMAP's gradient tolerance (tests/test_model_parity.py)
GRAD_REL_L2 = 2e-3
# ... except where the reference's own f32 gradient does not repeat to it:
# the same JAX step jitted and op by op (``jax.disable_jit``) differs by
# 1.43e-2 (euler), 5.1e-3 (tvec), 1.1e-3 (iden), 9.0e-4 (expr) relative L2.
# The camera offsets' gradient is a small sum of large per-pixel terms
# through the 2^9-frequency encoding.  Those groups are held to twice that
# spread in f32; the same step in float64 holds every group to
# F64_GRAD_REL_L2 (``python tests/test_torch_train.py`` prints the spread
# and the float64 agreement).
STEP_GRAD_REL_L2 = {"net": GRAD_REL_L2, "iden": GRAD_REL_L2, "expr": GRAD_REL_L2,
                    "appea": GRAD_REL_L2, "euler": 2.8e-2, "tvec": 1.1e-2}
F64_GRAD_REL_L2 = 1e-6
# VGG feature losses: the two frameworks' f32 convolutions differ by ~1e-6
# (relative L2 of the features); the feature-L1 means then differ by up to
# 1.4e-5 (vgg_eyes_loss).  Every other loss at 1e-5.
VGG_LOSS_RTOL = 3e-5


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ellipse(cy, cx, ry, rx):
    yy, xx = np.mgrid[:SIZE, :SIZE] / SIZE
    return (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1).astype(np.float32)


def make_batch(seed, featmap_size):
    """A loader-format batch: images in [0, 1], ellipse masks, codes
    0.1 * N(0, 1), the base camera's intrinsics at image scale."""
    rng = np.random.default_rng(seed)
    inmat = np.linalg.inv(base_inv_inmat(featmap_size)).astype(np.float32)
    inmat[:2] *= SIZE / featmap_size

    def rep(a):
        return np.repeat(np.asarray(a, np.float32)[None], B, 0)

    return {
        "image": rng.random((B, SIZE, SIZE, 3), dtype=np.float32),
        "head_mask": rep(_ellipse(0.5, 0.5, 0.4, 0.3)),
        "left_eye_mask": rep(_ellipse(0.42, 0.4, 0.08, 0.1)),
        "right_eye_mask": rep(_ellipse(0.42, 0.6, 0.08, 0.1)),
        "code": (0.1 * rng.standard_normal((B, 306))).astype(np.float32),
        "sample_idx": np.array([2, 0], np.int64),
        "pitchyaw": (0.2 * rng.standard_normal((B, 2))).astype(np.float32),
        "c2w_Rmat": rep(np.diag([1.0, -1.0, -1.0])),
        "c2w_Tvec": rep([0.0, 0.0, 12.0]),
        "inmat": rep(inmat),
    }


def _random_biases(tree, rng):
    def fill(path, leaf):
        if str(getattr(path[-1], "key", "")).endswith("bias"):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def setup():
    """JAX weights (random biases), offsets, VGG weights and a batch."""
    jcfg = jax_small_config()
    rng = np.random.default_rng(5)
    model = jax_gaze_nerf.GazeNeRF(jcfg.model)
    m = jcfg.model
    xy = jnp.zeros((B, m.num_rays, 2))
    z = jnp.zeros
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), xy, z((B, m.shape_code_dims)), z((B, m.appea_code_dims)),
        z((B, 2)), z((B, 3, 3)), z((B, 3, 1)), z((B, 3, 3)),
    )
    params = _random_biases(variables["params"], rng)
    offsets = {
        k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in jax_state.make_offsets(TRAIN_LEN).items()
    }
    vgg = JaxVGG()
    vgg_vars = jax.jit(vgg.init)(jax.random.PRNGKey(2), jnp.zeros((1, 224, 224, 3)))
    vgg_vars = _random_biases(vgg_vars, rng)
    return jcfg, params, offsets, vgg, vgg_vars, make_batch(7, m.featmap_size)


def _fixed_key_sampler(monkeypatch):
    """The JAX model draws its jitter from ``JITTER_KEY``."""

    def sampler(*args, key=None, **kw):
        return jax_sample_coarse(*args, key=None if key is None else JITTER_KEY, **kw)

    monkeypatch.setattr(jax_gaze_nerf, "sample_coarse", sampler)


def _jax_step(jcfg, params, offsets, vgg, vgg_vars, batch):
    """The JAX training step's loss and gradients (its ``make_train_step``
    body, without the update)."""
    m = jcfg.model
    model = jax_gaze_nerf.GazeNeRF(m)
    xy = jnp.broadcast_to(jax_pixel_grid(m.featmap_size)[None], (B, m.num_rays, 2))
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    capture = (lambda x: vgg.apply(vgg_vars, x)[0]) if jcfg.loss.use_vgg_loss else None

    def loss_fn(trainable):
        sc, ac, gz, R, T, K, ocd, dcam = jax_compose(
            jcfg, b, {k: trainable[k] for k in offsets}, jnp.zeros((m.expr_code_dims,))
        )
        pred = model.apply({"params": trainable["net"]}, xy, sc, ac, gz, R, T, K,
                           train=True, rngs={"sampling": jax.random.PRNGKey(99)})
        losses = jax_compute_losses(
            jcfg.loss, pred, b["image"], b["head_mask"][..., None],
            b["left_eye_mask"][..., None], b["right_eye_mask"][..., None],
            bg_value=1.0, vgg_capture_fn=capture, opt_code_dict=ocd, delta_cam=dcam,
        )
        return losses["total_loss"], losses

    trainable = {"net": params, **{k: jnp.asarray(v) for k, v in offsets.items()}}
    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable)
    return losses, grads


def _port_step(jcfg, params, offsets, vgg_vars, batch, model_overrides=None):
    """The port's Trainer on the same state: its losses and gradients.  With
    ``model_overrides`` ``compute_dtype`` and ``renderer_dtype`` "float64"
    the parameters and offset tables are float64 too."""
    cfg = Config(
        model=ModelConfig(**{**dataclasses.asdict(jcfg.model), **(model_overrides or {})}),
        loss=LossConfig(**dataclasses.asdict(jcfg.loss)),
        train=TrainConfig(**dataclasses.asdict(jcfg.train)),
    )
    tr = Trainer(cfg, train_len=TRAIN_LEN, steps_per_epoch=1, device="cpu")
    if cfg.model.compute_dtype == "float64":
        tr.model.double()
        for table in tr.offsets.values():
            table.data = table.data.double()
    load_train_state_from_jax(tr, types.SimpleNamespace(params=params, offsets=offsets),
                              cfg.model.n_upsample_blocks)
    if tr.frozen.vgg is not None:
        tr.frozen.vgg.load_state_dict(vgg_params_from_jax(vgg_vars), strict=True)
    m = cfg.model
    t_rand = torch.from_numpy(np.asarray(
        jax.random.uniform(JITTER_KEY, (B, m.num_rays, m.num_sample_coarse + 1))))
    losses = tr.train_step(batch, t_rand=t_rand, update=False)
    grads = {"net": {n: p.grad for n, p in tr.model.named_parameters()}}
    grads.update({k: p.grad for k, p in tr.offsets.items()})
    return losses, grads


def _group_rel_l2(got, want, group, n_blocks):
    if group == "net":
        w = params_from_jax(want["net"], n_blocks)
        names = sorted(w)
        assert set(names) == set(got["net"])
        a = np.concatenate([got["net"][n].numpy().ravel() for n in names])
        b = np.concatenate([w[n].numpy().ravel() for n in names])
        return _rel_l2(a, b)
    assert tuple(got[group].shape) == want[group].shape
    return _rel_l2(got[group].numpy(), want[group])


def _step_configs(jcfg):
    """The step comparisons' f32 and bf16 configs: the default loss stack
    without VGG (its values and gradients are compared on their own below,
    and it would double the compile time)."""
    f32 = jcfg.replace(loss=JaxLossConfig(use_vgg_loss=False))
    bf16 = f32.replace(model=dataclasses.replace(
        f32.model, compute_dtype="bfloat16", renderer_dtype="bfloat16",
        use_pallas=True, pallas_interpret=True))
    return f32, bf16


def _jax_steps(setup, *cfgs):
    jcfg, params, offsets, vgg, vgg_vars, batch = setup
    mp = pytest.MonkeyPatch()
    _fixed_key_sampler(mp)
    try:
        return [_jax_step(c, params, offsets, vgg, vgg_vars, batch) for c in cfgs]
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def f32_step(setup):
    jcfg, params, offsets, vgg, vgg_vars, batch = setup
    f32, _ = _step_configs(jcfg)
    (want,) = _jax_steps(setup, f32)
    return _port_step(f32, params, offsets, vgg_vars, batch), want


@pytest.mark.parametrize("group", GROUPS)
def test_f32_step_gradients_match_jax(f32_step, setup, group):
    """One training step's gradients (jitter, offsets, the loss stack), f32
    on both sides: relative L2 per parameter group under 2e-3, the camera
    offsets under twice the reference's own spread."""
    (_, got), (_, want) = f32_step
    n_blocks = setup[0].model.n_upsample_blocks
    assert _group_rel_l2(got, want, group, n_blocks) < STEP_GRAD_REL_L2[group]


def test_f32_step_losses_match_jax(f32_step):
    (got, _), (want, _) = f32_step
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def fused_step(setup):
    """The f32 step with the renderer in ``shuffle_mode="fused"``: the port
    through ``FusedUpsample`` (on the CPU the plain K7 and K8), JAX with the
    fused upsampler's Pallas kernels in interpret mode."""
    jcfg, params, offsets, vgg, vgg_vars, batch = setup
    f32, _ = _step_configs(jcfg)
    fused = f32.replace(model=dataclasses.replace(f32.model, shuffle_mode="fused",
                                                  pallas_interpret=True))
    (want,) = _jax_steps(setup, fused)
    return _port_step(fused, params, offsets, vgg_vars, batch), want


@pytest.mark.parametrize("group", GROUPS)
def test_f32_fused_renderer_step_gradients_match_jax(fused_step, setup, group):
    """One training step's gradients with the fused upsampler block, f32 on
    both sides, at the f32 step's tolerances."""
    (_, got), (_, want) = fused_step
    n_blocks = setup[0].model.n_upsample_blocks
    assert _group_rel_l2(got, want, group, n_blocks) < STEP_GRAD_REL_L2[group]


def test_f32_fused_renderer_step_losses_match_jax(fused_step):
    (got, _), (want, _) = fused_step
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-7, err_msg=k)


class _JnpFloat64:
    """``jax.numpy`` as the JAX model module sees it in the float64 step: the
    model takes ``jnp.float32`` as the compute dtype of a float32 config,
    and here that is float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module")
def f64_step(setup):
    """The f32 step's config, state and batch with every computation in
    float64 on both sides: JAX in x64 mode, the port with float64 fields,
    renderer, parameters and offsets.  The jitter draws are x64 mode's
    float64 draws from the same key, on both sides."""
    jcfg, params, offsets, vgg, vgg_vars, batch = setup
    f32, _ = _step_configs(jcfg)

    def to64(tree):
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)

    batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        _fixed_key_sampler(mp)
        mp.setattr(jax_gaze_nerf, "jnp", _JnpFloat64())
        want = _jax_step(f32, to64(params), to64(offsets), vgg, vgg_vars, batch)
        got = _port_step(f32, params, offsets, vgg_vars, batch,
                         {"compute_dtype": "float64", "renderer_dtype": "float64"})
    return got, want


@pytest.mark.parametrize("group", GROUPS)
def test_f64_step_gradients_match_jax(f64_step, setup, group):
    """Where f32 reassociation is gone, the port's step gradients are the
    JAX package's, the camera offsets' included: relative L2 per group under
    1e-6 (the JAX side reaches the comparison as float32)."""
    (got_losses, got), (want_losses, want) = f64_step
    assert got_losses["total_loss"].dtype == torch.float64
    assert want["euler"].dtype == jnp.float64
    n_blocks = setup[0].model.n_upsample_blocks
    assert _group_rel_l2(got, want, group, n_blocks) < F64_GRAD_REL_L2


def test_f64_step_losses_match_jax(f64_step):
    (got, _), (want, _) = f64_step
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-12, atol=1e-15, err_msg=k)


@pytest.fixture(scope="module")
def bf16_step(setup, f32_step):
    """One step with bf16 fields and renderer: the port (fused wrappers, on
    the CPU the plain K1 and K2) and JAX with the Pallas kernels in
    interpret mode; the JAX f32 step's gradients are the common truth."""
    jcfg, params, offsets, vgg, vgg_vars, batch = setup
    _, bf16 = _step_configs(jcfg)
    ((_, want),) = _jax_steps(setup, bf16)
    got = _port_step(bf16, params, offsets, vgg_vars, batch)[1]
    return got, want, f32_step[1][1], bf16.model.n_upsample_blocks


def _jax_rel_l2(a, b, group, n_blocks):
    """``_group_rel_l2`` between two JAX gradient trees."""
    if group == "net":
        a = {"net": params_from_jax(a["net"], n_blocks)}
    else:
        a = {group: torch.from_numpy(np.asarray(a[group]))}
    return _group_rel_l2(a, b, group, n_blocks)


@pytest.mark.parametrize("group", GROUPS)
def test_bf16_kernel_path_gradients_match_jax_interpret(bf16_step, group):
    """The JAX package's own bound for its bf16 kernels (tests/
    test_fused_field.py), per parameter group: with d = the JAX bf16
    kernel path's relative L2 from the f32 gradient, the port's bf16
    gradient lies within 2d of the f32 gradient and within 2d of the JAX
    bf16 gradient.  bf16 rounds at other points in the two frameworks (the
    renderer's products, the merge) and flips an occasional activation:
    d runs from 1e-2 (appea) to 0.19 (euler), and the two JAX bf16 paths,
    Pallas and XLA, differ from each other by as much."""
    got, want, truth, n_blocks = bf16_step
    d = _jax_rel_l2(want, truth, group, n_blocks)
    assert 0 < d < 0.5
    assert _group_rel_l2(got, truth, group, n_blocks) < 2 * d
    assert _group_rel_l2(got, want, group, n_blocks) < 2 * d


@pytest.fixture(scope="module")
def loss_case(setup):
    """Predicted images, ground truth and masks through both loss stacks on
    the same VGG weights; the gradient wrt the predicted images too."""
    jcfg, _, _, vgg, vgg_vars, batch = setup
    rng = np.random.default_rng(9)
    keys = ("merge_img", "merge_img_face", "merge_img_eyes", "bg_img")
    pred = {k: rng.random((1 if k == "bg_img" else B, SIZE, SIZE, 3), dtype=np.float32) for k in keys}
    ocd = {k: (0.1 * rng.standard_normal((B, n))).astype(np.float32)
           for k, n in (("iden", 100), ("expr", 79), ("appea", 127))}
    dcam = {"delta_eulur": (0.1 * rng.standard_normal((B, 3))).astype(np.float32),
            "delta_tvec": (0.1 * rng.standard_normal((B, 3, 1))).astype(np.float32)}
    masks = [batch[k][..., None] for k in ("head_mask", "left_eye_mask", "right_eye_mask")]

    def jax_loss(pred_):
        out = jax_compute_losses(
            jcfg.loss, pred_, jnp.asarray(batch["image"]), *map(jnp.asarray, masks),
            vgg_capture_fn=lambda x: vgg.apply(vgg_vars, x)[0],
            opt_code_dict={**{k: jnp.asarray(v) for k, v in ocd.items()}, "bg": None},
            delta_cam={k: jnp.asarray(v) for k, v in dcam.items()},
        )
        return out["total_loss"], out

    jp = {k: jnp.asarray(v) for k, v in pred.items()}
    (_, want), want_g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jp)

    net = VGG16Features()
    net.load_state_dict(vgg_params_from_jax(vgg_vars), strict=True)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in pred.items()}
    got = compute_losses(
        LossConfig(), tp, torch.from_numpy(batch["image"]), *map(torch.from_numpy, masks),
        vgg_capture_fn=net,
        opt_code_dict={**{k: torch.from_numpy(v) for k, v in ocd.items()}, "bg": None},
        delta_cam={k: torch.from_numpy(v) for k, v in dcam.items()},
    )
    got["total_loss"].backward()
    return got, want, {k: t.grad for k, t in tp.items()}, want_g


@pytest.mark.parametrize("key", [
    "bg_loss", "head_loss", "face_loss", "eyes_loss", "nonhead_loss", "vgg_face_loss",
    "vgg_eyes_loss", "vgg", "delta_eular", "delta_tvec", "iden_code", "expr_code",
    "appea_code", "bg_code", "total_loss",
])
def test_losses_match_jax(loss_case, key):
    """Every loss of the default stack (VGG on the transplanted weights), f32
    on both sides: relative 1e-5, the VGG feature losses VGG_LOSS_RTOL."""
    got, want, _, _ = loss_case
    rtol = VGG_LOSS_RTOL if key.startswith("vgg") else 1e-5
    np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("image", ["merge_img", "merge_img_face", "merge_img_eyes", "bg_img"])
def test_loss_gradients_match_jax(loss_case, image):
    """The loss stack's backward (VGG, the resize, the masked means) wrt each
    predicted image: relative L2 under 2e-3."""
    _, _, got, want = loss_case
    assert _rel_l2(got[image].numpy(), want[image]) < GRAD_REL_L2


def test_resize_bilinear_matches_jax():
    """512 -> 224, half-pixel centres, no antialias: F.interpolate's bilinear
    mode is jax.image.resize's at this downscale."""
    x = np.random.default_rng(0).random((1, 512, 512, 3), dtype=np.float32)
    got = resize_bilinear(torch.from_numpy(x), (224, 224)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_resize(jnp.asarray(x), (224, 224))),
                               atol=1e-6, rtol=0)


def test_euler_to_rotation_matches_jax():
    a = (0.5 * np.random.default_rng(1).standard_normal((5, 3))).astype(np.float32)
    np.testing.assert_allclose(euler_to_rotation(torch.from_numpy(a)).numpy(),
                               np.asarray(jax_euler(jnp.asarray(a))), atol=1e-6, rtol=0)


def test_jittered_sample_coarse_matches_jax(setup):
    """The stratified jitter: JAX draws ``uniform(key, [B, R, S+1])``; the
    port takes the same draws."""
    m = setup[0].model
    rng = np.random.default_rng(2)
    xy = np.asarray(jax_pixel_grid(m.featmap_size))[None].repeat(B, 0)
    R = np.diag([1.0, -1.0, -1.0]).astype(np.float32)[None].repeat(B, 0)
    T = np.array([[0.1, -0.2, 12.0], [0.0, 0.3, 11.0]], np.float32)
    K = (base_inv_inmat(m.featmap_size)[None] * (1 + 0.01 * rng.random((B, 1, 1)))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    args = (m.num_sample_coarse, m.world_z1, m.world_z2)
    want = jax_sample_coarse(*map(jnp.asarray, (xy, R, T, K)), *args, key=key)
    draws = jax.random.uniform(key, (B, m.num_rays, m.num_sample_coarse + 1))
    got = sample_coarse(*map(torch.from_numpy, (xy, R, T, K)), *args,
                        t_rand=torch.from_numpy(np.asarray(draws)))
    for name in ("pts", "zvals", "z_dists"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-5, rtol=1e-6, err_msg=name)
    plain = sample_coarse(*map(torch.from_numpy, (xy, R, T, K)), *args)
    assert not torch.allclose(plain.zvals, got.zvals)  # the jitter moved the samples


def test_decode_and_intrinsics_match_jax():
    batch = {"image": np.full((1, 4, 4, 3), 255, np.uint8), "cam_index": np.array([[7]], np.uint8)}
    got = decode_uint8_batch({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got["image"].dtype == torch.float32 and float(got["image"].max()) == 1.0
    assert got["cam_index"].dtype == torch.uint8  # ids are not images
    inmat = np.array([[[1600.0, 0, 260.0], [0, 1580.0, 250.0], [0, 0, 1]]], np.float32)
    np.testing.assert_allclose(scale_intrinsics(torch.from_numpy(inmat), 512, 64).numpy(),
                               np.asarray(scale_intrinsics_jnp(jnp.asarray(inmat), 512, 64)),
                               rtol=1e-6)


def test_adam_and_schedule_match_optax():
    """Per-group Adam with the per-epoch decay: the torch optimizer and the
    JAX package's optax one, fed the same gradients over 5 steps that cross
    two epoch boundaries."""
    tcfg = TrainConfig(lr=1e-2, step_decay=2)
    rng = np.random.default_rng(4)
    shapes = {"net": (6, 5), "iden": (4, 100), "expr": (4, 79), "appea": (4, 127),
              "euler": (4, 3), "tvec": (4, 3, 1)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    tx = jax_state.make_optimizer(JaxTrainConfig(lr=1e-2, step_decay=2), 2)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt, sched = make_optimizer(tcfg, 2, {k: [p] for k, p in tp.items()})
    mults = {"net": 1.0, "iden": 1.0, "expr": 0.1, "appea": 1.0, "euler": 0.1, "tvec": 0.1}
    for step, g in enumerate(grads):
        for group in opt.param_groups:  # the lr this step uses: lr_schedule
            want = lr_schedule(tcfg, 2, mults[group["name"]])(step)
            assert group["lr"] == pytest.approx(want, rel=1e-12), (step, group["name"])
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6, err_msg=k)


def test_trainer_steps_lower_the_loss_and_leave_unseen_rows():
    """Three steps on one batch (the JAX package's tiny trainer model: MSE
    region losses, no VGG; the synthetic data's image, a face-coloured
    ellipse on white): the loss falls, gathered offset rows move, rows never
    gathered keep exactly zero (dense gradients, zero there)."""
    cfg = Config(
        model=ModelConfig(num_sample_coarse=8, featmap_size=16, pred_img_size=64,
                          mlp_hidden=32, use_pallas=False),
        loss=LossConfig(use_vgg_loss=False, use_l1_loss=False),
        train=TrainConfig(batch_size=2),  # the default lr, 1e-4
    )
    tr = Trainer(cfg, train_len=TRAIN_LEN + 3, steps_per_epoch=1, device="cpu")
    batch = make_batch(1, 16)
    face = batch["head_mask"][..., None] > 0
    batch["image"] = np.where(face, np.array([180, 140, 120], np.float32) / 255, 1.0)
    first = tr.train_epoch([batch], 0)
    for e in range(1, 3):
        last = tr.train_epoch([batch], e)
    assert np.isfinite(first["loss"]) and last["loss"] < first["loss"], (first, last)
    assert tr.step == 3
    seen = sorted(set(batch["sample_idx"].tolist()))
    unseen = [i for i in range(TRAIN_LEN + 3) if i not in seen]
    for k, table in tr.offsets.items():
        assert float(table[seen].abs().max()) > 0, k
        assert float(table[unseen].abs().max()) == 0, k


def test_eval_step_matches_jax(setup):
    """The eval step (no jitter, no gradient): MSE, PSNR and the per-region
    MSEs against the JAX package's ``make_eval_step``, f32, relative 1e-5."""
    jcfg, params, offsets, _, _, batch = setup
    state = jax_state.TrainState(
        step=jnp.asarray(0), params=params,
        offsets={k: jnp.asarray(v) for k, v in offsets.items()}, opt_state=None,
        rng=jax.random.PRNGKey(0),
    )
    want, _ = jax_make_eval_step(jcfg, jax_gaze_nerf.GazeNeRF(jcfg.model),
                                 np.zeros(jcfg.model.expr_code_dims, np.float32))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = Config(model=ModelConfig(**dataclasses.asdict(jcfg.model)))
    tr = Trainer(cfg, train_len=TRAIN_LEN, steps_per_epoch=1, device="cpu")
    load_train_state_from_jax(tr, types.SimpleNamespace(params=params, offsets=offsets),
                              cfg.model.n_upsample_blocks)
    got, images = tr.eval_step(tr.to_device(batch))
    assert set(got) == set(want) and images["merge_img"].shape == (B, SIZE, SIZE, 3)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_frozen_vgg_loads_a_torchvision_checkpoint(tmp_path):
    """``LossConfig.vgg_ckpt`` names a torchvision ``features.N`` state dict
    (optionally under ``state_dict``, with ``module.`` prefixes)."""
    gen = torch.Generator().manual_seed(0)
    sd, net = {}, VGG16Features()
    for i, tidx in enumerate(VGG16_CONV_IDX):
        sd[f"module.features.{tidx}.weight"] = torch.randn(net.convs[i].weight.shape, generator=gen)
        sd[f"module.features.{tidx}.bias"] = torch.randn(net.convs[i].bias.shape, generator=gen)
    path = tmp_path / "vgg16.pth"
    torch.save({"state_dict": sd}, path)
    frozen = FrozenNets(Config(loss=LossConfig(vgg_ckpt=str(path))), device="cpu")
    for i, tidx in enumerate(VGG16_CONV_IDX):
        torch.testing.assert_close(frozen.vgg.convs[i].weight,
                                   sd[f"module.features.{tidx}.weight"], rtol=0, atol=0)
    assert not any(p.requires_grad for p in frozen.vgg.parameters())


def reference_spread():
    """The JAX step's gradients jitted against the same step op by op (the
    f32 step test's config): the relative L2 per offset group that f32
    reassociation alone gives."""
    args = setup._get_wrapped_function()()
    f32, _ = _step_configs(args[0])
    mp = pytest.MonkeyPatch()
    _fixed_key_sampler(mp)
    try:
        _, jit = _jax_step(f32, *args[1:])
        with jax.disable_jit():
            _, eager = _jax_step(f32, *args[1:])
    finally:
        mp.undo()
    return {g: _rel_l2(eager[g], jit[g]) for g in GROUPS[1:]}


def f64_agreement():
    """The float64 step's relative L2 per group, port against JAX."""
    args = setup._get_wrapped_function()()
    (_, got), (_, want) = f64_step._get_wrapped_function()(args)
    n_blocks = args[0].model.n_upsample_blocks
    return {g: _group_rel_l2(got, want, g, n_blocks) for g in GROUPS}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print("JAX f32, jitted vs op by op:", reference_spread())
    print("float64, port vs JAX:", f64_agreement())
