"""The port's checkpoints: an exact round trip, an exact resume, the
offset tables' leading-size rule, the JAX config's JSON form, and a JAX
(orbax) checkpoint restored through ``load_train_state_from_jax``."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gazenerf_tpu import config as jax_config
from gazenerf_tpu.models.gaze_nerf import GazeNeRF as JaxGazeNeRF
from gazenerf_tpu.train import checkpoint as jax_ckpt
from gazenerf_tpu.train import state as jax_state
from gazenerf_tpu_torch.config import Config, LossConfig
from gazenerf_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from gazenerf_tpu_torch.train.trainer import Trainer
from gazenerf_tpu_torch.utils.transplant import load_train_state_from_jax, params_from_jax
from test_torch_train import make_batch
from torch_threads import one_thread  # noqa: F401

TRAIN_LEN = 4


def _cfg():
    """The small test model with the default loss stack but VGG (tests
    that do not need it run faster without)."""
    jcfg = jax_config.small_test_config()
    return Config.from_json(jcfg.to_json()).replace(loss=LossConfig(use_vgg_loss=False))


def _trainer(cfg, train_len=TRAIN_LEN, seed=3):
    return Trainer(cfg, train_len=train_len, steps_per_epoch=2, seed=seed, device="cpu")


def _state_tensors(tr):
    """Every tensor of a trainer's state, by name."""
    out = {f"model.{k}": v for k, v in tr.model.state_dict().items()}
    out.update({f"offsets.{k}": v.detach() for k, v in tr.offsets.items()})
    for i, st in tr.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    out["generator"] = tr.generator.get_state()
    return out


@pytest.fixture(scope="module")
def batches():
    cfg = _cfg()
    out = []
    for seed in (1, 2, 3):
        b = make_batch(seed, cfg.model.featmap_size)
        b["sample_idx"] = np.array([seed % TRAIN_LEN, (seed + 1) % TRAIN_LEN])
        out.append(b)
    return out


def test_round_trip_is_exact(tmp_path, batches):
    """Save after a step, load into a fresh trainer of another seed: every
    tensor (parameters, offsets, Adam's moments, the generator), the step,
    the schedule and the summaries equal the saved ones to the bit."""
    cfg = _cfg()
    a = _trainer(cfg)
    a.train_epoch(batches[:1], 0)
    path = save_checkpoint(str(tmp_path), a, cfg, epoch=0)
    assert latest_checkpoint(str(tmp_path)) == path and path.endswith("epoch_1")
    b = _trainer(cfg, seed=9)
    got_cfg, epoch = load_checkpoint(path, b)
    assert got_cfg == cfg and epoch == 0
    want, got = _state_tensors(a), _state_tensors(b)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert b.step == a.step == 1 and b.history == a.history
    assert b.scheduler.state_dict() == a.scheduler.state_dict()


def test_resumed_step_equals_the_uninterrupted_one(tmp_path, batches):
    """A run that stops after two steps and resumes from its checkpoint takes
    its third step to the same bits as a run that never stopped (the
    jitter's generator, Adam's moments and the schedule all restored)."""
    cfg = _cfg()
    whole = _trainer(cfg)
    for b in batches[:2]:
        whole.train_step(b)
    path = save_checkpoint(str(tmp_path), whole, cfg, epoch=0)
    want = whole.train_step(batches[2])
    resumed = _trainer(cfg, seed=7)
    load_checkpoint(path, resumed)
    got = resumed.train_step(batches[2])
    assert all(torch.equal(got[k], want[k]) for k in want)
    a, b = _state_tensors(resumed), _state_tensors(whole)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_stored_offset_size_wins(tmp_path, batches):
    """A trainer built for one sample takes a checkpoint of four: the
    stored offset tables (and their Adam moments) replace its own, and it
    trains on."""
    cfg = _cfg()
    a = _trainer(cfg)
    a.train_step(batches[0])
    path = save_checkpoint(str(tmp_path), a, cfg, epoch=0)
    b = _trainer(cfg, train_len=1)
    load_checkpoint(path, b)
    for k, v in a.offsets.items():
        assert torch.equal(b.offsets[k], v), k
    losses = b.train_step(batches[1])
    assert torch.isfinite(losses["total_loss"])
    assert all(b.offsets[k].shape[0] == TRAIN_LEN for k in b.offsets)


def test_config_json_is_the_jax_packages():
    """A JAX config's JSON form loads with the same sections, and the
    port's JSON form loads in the JAX package; a parallel section of more
    than one device (``data_parallel=2``) round-trips too."""
    jcfg = jax_config.Config(data=jax_config.DataConfig(img_dir="x", num_workers=3))
    cfg = Config.from_json(jcfg.to_json())
    for section in ("model", "loss", "train", "data", "parallel"):
        assert dataclasses.asdict(getattr(cfg, section)) == \
            dataclasses.asdict(getattr(jcfg, section)), section
    assert jax_config.Config.from_json(cfg.to_json()) == jcfg
    two = jcfg.replace(parallel=jax_config.ParallelConfig(data_parallel=2, shard_offsets=False))
    cfg = Config.from_json(two.to_json())
    assert dataclasses.asdict(cfg.parallel) == dataclasses.asdict(two.parallel)
    assert cfg.parallel.data_parallel == 2
    assert jax_config.Config.from_json(cfg.to_json()) == two


def test_jax_checkpoint_restores_through_the_transplant(tmp_path):
    """A JAX ``TrainState`` saved by its ``save_checkpoint`` (orbax) is
    restored by the JAX package and copied into the port's trainer by
    ``load_train_state_from_jax``: the same parameters and offset tables.
    The port's own loader names that route."""
    jcfg = jax_config.small_test_config()
    m = jcfg.model
    model = JaxGazeNeRF(m)
    z = jnp.zeros
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), z((2, m.num_rays, 2)), z((2, m.shape_code_dims)),
        z((2, m.appea_code_dims)), z((2, 2)), z((2, 3, 3)), z((2, 3, 1)), z((2, 3, 3)),
    )["params"]
    rng = np.random.default_rng(0)
    offsets = {k: jnp.asarray(0.01 * rng.standard_normal(v.shape), jnp.float32)
               for k, v in jax_state.make_offsets(TRAIN_LEN).items()}
    opt = jax_state.make_optimizer(jcfg.train, 2)
    state = jax_state.TrainState(step=jnp.asarray(3), params=params, offsets=offsets,
                                 opt_state=opt.init({"net": params, **offsets}),
                                 rng=jax.random.PRNGKey(1))
    path = jax_ckpt.save_checkpoint(str(tmp_path), state, jcfg, epoch=4)
    restored, _, epoch = jax_ckpt.load_checkpoint(path, state)
    assert epoch == 4
    cfg = Config.from_json(json.dumps(json.load(open(os.path.join(path, "config.json")))["config"]))
    tr = _trainer(cfg.replace(loss=LossConfig(use_vgg_loss=False)))
    with pytest.raises(ValueError, match="load_train_state_from_jax"):
        load_checkpoint(path, tr)
    load_train_state_from_jax(tr, restored, m.n_upsample_blocks)
    want = params_from_jax(params, m.n_upsample_blocks)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for k, v in offsets.items():
        np.testing.assert_array_equal(tr.offsets[k].detach().numpy(), np.asarray(v))
