"""The shared case of the port's fitting tests (``test_torch_fitting*.py``,
``test_torch_gaze_opt.py``): the JAX package's small model (hidden 64,
featmap 16, 8 samples, 64x64 images) with random biases, offset tables of
two rows, one image, the loss stack without VGG (its parity is
``tests/test_torch_train.py``'s), on both sides from the same numpy
values.  The jitter draws of a JAX fit are the keys its sampler is handed,
recorded as the fit runs and redrawn for the port."""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gazenerf_tpu.models.gaze_nerf as jax_gaze_nerf
from gazenerf_tpu.config import LossConfig as JaxLossConfig
from gazenerf_tpu.config import TrainConfig as JaxTrainConfig
from gazenerf_tpu.config import small_test_config as jax_small_config
from gazenerf_tpu.ops.rays import sample_coarse as jax_sample_coarse
from gazenerf_tpu.train import state as jax_state
from gazenerf_tpu.train.trainer import FrozenNets as JaxFrozenNets
from gazenerf_tpu_torch import Config, LossConfig, ModelConfig, TrainConfig, Trainer
from gazenerf_tpu_torch.data.cameras import base_inv_inmat
from gazenerf_tpu_torch.train.fitting import FitState
from gazenerf_tpu_torch.utils.transplant import gazenerf_params_to_torch, load_train_state_from_jax

SIZE, TRAIN_LEN = 64, 2
GROUPS = ("net", "iden", "expr", "appea", "euler", "tvec")
EXPR_FIX = np.zeros(79, np.float32)


def jax_config():
    cfg = jax_small_config()
    return cfg.replace(loss=JaxLossConfig(use_vgg_loss=False),
                       train=JaxTrainConfig(batch_size=1, lr=1e-3))


def _ellipse(cy, cx, ry, rx):
    yy, xx = np.mgrid[:SIZE, :SIZE] / SIZE
    return (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1).astype(np.float32)


def make_batch(seed, featmap_size):
    """One image in the loader's format (the base camera's intrinsics at
    image scale, ellipse masks, codes 0.1 N(0, 1)); its sample index is 1,
    which the fitting loops pin to 0."""
    rng = np.random.default_rng(seed)
    inmat = np.linalg.inv(base_inv_inmat(featmap_size)).astype(np.float32)
    inmat[:2] *= SIZE / featmap_size
    return {
        "image": rng.random((1, SIZE, SIZE, 3), dtype=np.float32),
        "head_mask": _ellipse(0.5, 0.5, 0.4, 0.3)[None],
        "left_eye_mask": _ellipse(0.42, 0.4, 0.08, 0.1)[None],
        "right_eye_mask": _ellipse(0.42, 0.6, 0.08, 0.1)[None],
        "code": (0.1 * rng.standard_normal((1, 306))).astype(np.float32),
        "sample_idx": np.array([1], np.int64),
        "pitchyaw": (0.2 * rng.standard_normal((1, 2))).astype(np.float32),
        "c2w_Rmat": np.diag([1.0, -1.0, -1.0]).astype(np.float32)[None],
        "c2w_Tvec": np.array([[0.0, 0.0, 12.0]], np.float32),
        "inmat": inmat[None],
    }


@functools.lru_cache(maxsize=1)
def make_case():
    """``(jax config, params, offsets, batch)``: JAX's initialiser with
    every bias 0.1 N(0, 1), offsets 0.01 N(0, 1).  Built once per test
    process; callers copy what they change."""
    jcfg = jax_config()
    m = jcfg.model
    model = jax_gaze_nerf.GazeNeRF(m)
    z = jnp.zeros
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), z((1, m.num_rays, 2)), z((1, m.shape_code_dims)),
        z((1, m.appea_code_dims)), z((1, 2)), z((1, 3, 3)), z((1, 3, 1)), z((1, 3, 3)))
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        if str(getattr(p[-1], "key", "")).endswith("bias") else np.asarray(v),
        variables["params"])
    offsets = {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
               for k, v in jax_state.make_offsets(TRAIN_LEN).items()}
    return jcfg, params, offsets, make_batch(7, m.featmap_size)


def jax_state_of(params, offsets, seed=11):
    return jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                offsets={k: jnp.asarray(v) for k, v in offsets.items()},
                                opt_state=None, rng=jax.random.PRNGKey(seed))


def jax_model_and_frozen(jcfg):
    return jax_gaze_nerf.GazeNeRF(jcfg.model), JaxFrozenNets(jcfg, jax.random.PRNGKey(1))


def port_config(jcfg, **model_overrides) -> Config:
    return Config(
        model=ModelConfig(**{**dataclasses.asdict(jcfg.model), **model_overrides}),
        loss=LossConfig(**dataclasses.asdict(jcfg.loss)),
        train=TrainConfig(**dataclasses.asdict(jcfg.train)),
    )


def port_trainer(jcfg, params, offsets, float64=False) -> Trainer:
    """The port's trainer on the JAX weights and offsets; with ``float64``
    its fields, renderer, parameters and offsets in float64."""
    over = {"compute_dtype": "float64", "renderer_dtype": "float64"} if float64 else {}
    tr = Trainer(port_config(jcfg, **over), train_len=TRAIN_LEN, steps_per_epoch=1, device="cpu")
    if float64:
        tr.model.double()
        for table in tr.offsets.values():
            table.data = table.data.double()
    load_train_state_from_jax(tr, types.SimpleNamespace(params=params, offsets=offsets),
                              jcfg.model.n_upsample_blocks)
    return tr


class JnpFloat64:
    """``jax.numpy`` as the JAX model module sees it in a float64 run: the
    model takes ``jnp.float32`` as the compute dtype of a float32 config,
    and here that is float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def record_sampler_keys(mp: pytest.MonkeyPatch, keys: list) -> None:
    """The JAX model's jittered sampler appends each key it is handed to
    ``keys`` (in order, as the jitted fit runs), then draws as before."""

    def sampler(*args, key=None, **kw):
        if key is not None:
            jax.debug.callback(lambda k: keys.append(np.asarray(k)), key, ordered=True)
        return jax_sample_coarse(*args, key=key, **kw)

    mp.setattr(jax_gaze_nerf, "sample_coarse", sampler)


def draws_of(keys, m, dtype) -> torch.Tensor:
    """JAX's jitter draws ``[n_steps, 1, R, S + 1]`` from the recorded keys."""
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(jnp.asarray(k), (1, m.num_rays, m.num_sample_coarse + 1),
                                      dtype=dtype)) for k in keys]))


def to64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def port_groups(state: FitState):
    """A port state's parameters by group: ``net`` as a name -> numpy dict,
    each offset table as an array."""
    out = {"net": {n: p.detach().double().numpy() for n, p in state.model.named_parameters()}}
    out.update({k: v.detach().double().numpy() for k, v in state.offsets.items()})
    return out


def jax_groups(state, n_blocks):
    """A JAX state's parameters as :func:`port_groups` gives them, in
    their own precision."""
    net = gazenerf_params_to_torch(jax.tree_util.tree_map(np.asarray, state.params), n_blocks)
    out = {"net": {n: np.asarray(v, np.float64) for n, v in net.items()}}
    out.update({k: np.asarray(v, np.float64) for k, v in state.offsets.items()})
    return out


def update_rel_l2(got_after, got_before, want_after, want_before, group) -> float:
    """The relative L2 distance between the port's and JAX's updates
    (fitted minus base) of ``group``."""
    if group == "net":
        names = sorted(want_after["net"])
        flat = [np.concatenate([d["net"][n].ravel() for n in names])
                for d in (got_after, got_before, want_after, want_before)]
    else:
        flat = [d[group] for d in (got_after, got_before, want_after, want_before)]
    return rel_l2(flat[0] - flat[1], flat[2] - flat[3])
