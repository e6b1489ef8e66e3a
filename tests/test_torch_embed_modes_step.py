"""Training steps of the small model with the fused field kernels' two
embedding settings against the JAX package's ``make_train_step`` body in the
same setting, its Pallas kernels in interpret mode.

* ``pallas_fuse_embed``: the kernels take the sample points and encode them
  in their tile; the camera offsets' gradients reach the points through
  the kernels' cotangent of the points (``dpts``);
* ``pallas_embed_bf16``: the kernels take the bf16 embedding and give its
  cotangent in bf16.

On the CPU the port's wrappers run their plain versions.  The bound is the
bf16 step's of ``tests/test_torch_train.py``, against the port's f32 step
as the common truth (as ``tests/test_torch_split_dw.py`` holds its mode).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gazenerf_tpu_torch.kernels import fused_field as ff
from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb
from test_torch_stash_modes import _flat_group, _rel_l2
from test_torch_train import (
    B,
    GROUPS,
    TRAIN_LEN,
    _jax_steps,
    _port_step,
    _random_biases,
    _step_configs,
    jax_gaze_nerf,
    jax_small_config,
    jax_state,
    make_batch,
)
from torch_threads import one_thread  # noqa: F401

FLAGS = {"fuse_embed": dict(pallas_fuse_embed=True), "embed_bf16": dict(pallas_embed_bf16=True)}


@pytest.fixture(scope="module")
def setup():
    """``tests/test_torch_train.py``'s JAX weights (random biases), offsets
    and batch, without its VGG weights: the steps here take no VGG loss."""
    jcfg = jax_small_config()
    rng = np.random.default_rng(5)
    m = jcfg.model
    z = jnp.zeros
    variables = jax.jit(jax_gaze_nerf.GazeNeRF(m).init)(
        jax.random.PRNGKey(0), z((B, m.num_rays, 2)), z((B, m.shape_code_dims)),
        z((B, m.appea_code_dims)), z((B, 2)), z((B, 3, 3)), z((B, 3, 1)), z((B, 3, 3)),
    )
    params = _random_biases(variables["params"], rng)
    offsets = {
        k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in jax_state.make_offsets(TRAIN_LEN).items()
    }
    return jcfg, params, offsets, None, None, make_batch(7, m.featmap_size)


@pytest.fixture(scope="module")
def truth(setup):
    """The port's f32 step (the same for both flags): the common truth."""
    jcfg, params, offsets, _, vgg_vars, batch = setup
    f32, _ = _step_configs(jcfg)
    return _port_step(f32, params, offsets, vgg_vars, batch)[1]


@pytest.fixture(scope="module", params=list(FLAGS))
def flag_step(setup, truth, request):
    """One training step with bf16 fields and renderer and the flag: JAX's
    and the port's (the plain K1 and K2, the inputs of their calls
    recorded), and the port's f32 step."""
    jcfg, params, offsets, _, vgg_vars, batch = setup
    _, bf16 = _step_configs(jcfg)
    cfg = bf16.replace(model=dataclasses.replace(bf16.model, **FLAGS[request.param]))
    ((_, want),) = _jax_steps(setup, cfg)
    calls = []
    fwd, bwd = ff.fused_field_forward, ffb.fused_field_backward
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ff, "fused_field_forward", lambda e, *a, **k: (
            calls.append(("forward", tuple(e.shape), e.dtype, k.get("n_freqs"))),
            fwd(e, *a, **k))[1])
        mp.setattr(ffb, "fused_field_backward", lambda e, *a, **k: (
            calls.append(("backward", tuple(e.shape), e.dtype, k.get("n_freqs"))),
            bwd(e, *a, **k))[1])
        got = _port_step(cfg, params, offsets, vgg_vars, batch)[1]
    return request.param, got, want, truth, cfg.model, calls


@pytest.mark.parametrize("group", GROUPS)
def test_embed_mode_step_gradients_match_jax_interpret(flag_step, group):
    """Per parameter group, with d = the JAX step's relative L2 from the f32
    gradient: the port's lies within 2d of the f32 gradient and within 2d of
    JAX's (the camera offsets, ``euler`` and ``tvec``, through the points'
    cotangent under ``pallas_fuse_embed``)."""
    _, got, want, truth, m, _ = flag_step
    got, want, truth = (_flat_group(t, group, m.n_upsample_blocks) for t in (got, want, truth))
    d = _rel_l2(want, truth)
    assert 0 < d < 0.5
    assert _rel_l2(got, truth) < 2 * d
    assert _rel_l2(got, want) < 2 * d


def test_embed_mode_step_takes_what_the_flag_gives(flag_step):
    """Each field's forward and backward take the f32 points ``[B, R, S,
    3]`` with ten octaves (``pallas_fuse_embed``), or the bf16 embedding
    ``[B, R, S, 63]`` (``pallas_embed_bf16``)."""
    name, *_, m, calls = flag_step
    shape = (2, m.num_rays, m.num_sample_coarse)
    if name == "fuse_embed":
        want = [(kind, (*shape, 3), np.dtype("float32").name, m.vp_n_freqs)
                for kind in ("forward", "forward", "backward", "backward")]
    else:
        want = [(kind, (*shape, m.vp_embed_dims), "bfloat16", None)
                for kind in ("forward", "forward", "backward", "backward")]
    assert [(k, s, str(d).split(".")[1], n) for k, s, d, n in calls] == want, calls
