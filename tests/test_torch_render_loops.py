"""The port's render loops (``eval/render_loops.py``) against the JAX
package's on the same weights and codes: the orbit with and without the
moving gaze, the gaze sweep and the latent morph, frame by frame in
uint8; and the port's GIF writer (``utils/gif.py``) read back with PIL."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gazenerf_tpu.eval import render_loops as JR
from gazenerf_tpu_torch.eval import render_loops as R
from torch_fitting_case import make_case, port_trainer
from torch_threads import one_thread  # noqa: F401

# f32 renders a few 1e-6 apart truncate to the other uint8 level now and
# then: 1 level on at most 0.016% of the pixels (the orbit with the gaze
# fixed), held to 0.1%
FRAME_MAX_LEVELS = 1
FRAME_MAX_SHARE = 1e-3


def _frames_close(got, want):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert d.max() <= FRAME_MAX_LEVELS and (d > 0).mean() <= FRAME_MAX_SHARE, \
        (d.max(), (d > 0).mean())


@pytest.fixture(scope="module")
def loops():
    """The orbit (with and without the moving gaze) and the gaze sweep from
    both packages' render loops, on the same weights and codes."""
    jcfg, params, offsets, _ = make_case()
    m = jcfg.model
    jl, pl = JR.RenderLoops(m, view_num=5), R.RenderLoops(m, view_num=5)
    sc = np.random.default_rng(30).standard_normal((1, 179)).astype(np.float32) * 0.1
    ac = np.random.default_rng(31).standard_normal((1, 127)).astype(np.float32) * 0.1
    variables = {"params": params}
    want = {
        "both": jl.render_novel_views(variables, jnp.asarray(sc), jnp.asarray(ac)),
        "head": jl.render_novel_views(variables, jnp.asarray(sc), jnp.asarray(ac), move_gaze=False),
        "gaze": jl.render_gaze_sweep(variables, jnp.asarray(sc), jnp.asarray(ac)),
        "morph": jl.render_morphing(variables, {"shape_code": jnp.asarray(sc), "appea_code":
                                                jnp.asarray(ac)},
                                    {"shape_code": jnp.asarray(-sc), "appea_code":
                                     jnp.asarray(ac[:, ::-1].copy())}, nums=4),
    }
    model = port_trainer(jcfg, params, offsets).model
    got = {
        "both": pl.render_novel_views(model, torch.from_numpy(sc), torch.from_numpy(ac)),
        "head": pl.render_novel_views(model, torch.from_numpy(sc), torch.from_numpy(ac),
                                      move_gaze=False),
        "gaze": pl.render_gaze_sweep(model, torch.from_numpy(sc), torch.from_numpy(ac)),
        "morph": pl.render_morphing(model, {"shape_code": torch.from_numpy(sc), "appea_code":
                                            torch.from_numpy(ac)},
                                    {"shape_code": torch.from_numpy(-sc), "appea_code":
                                     torch.from_numpy(ac[:, ::-1].copy())}, nums=4),
    }
    return got, want


@pytest.mark.parametrize("loop", ["both", "head", "gaze", "morph"])
def test_render_loops_match_jax(loops, loop):
    got, want = loops
    assert len(got[loop]) == len(want[loop]) == {"gaze": 44, "morph": 4}.get(loop, 5)
    assert got[loop][0].dtype == np.uint8 and got[loop][0].shape == (64, 64, 3)
    _frames_close(np.stack(got[loop]), np.stack(want[loop]))


def test_trajectories_are_jaxs():
    assert R.gaze_sweep_trajectory() == JR.gaze_sweep_trajectory()
    assert R.ORBIT_GAZE_H == JR.ORBIT_GAZE_H and R.ORBIT_GAZE_V == JR.ORBIT_GAZE_V


def test_gif_round_trip(loops, tmp_path):
    """The port's GIF read back with PIL: GIF89a, one frame per image (the
    JAX package's writer, Pillow, merges equal neighbours), each frame its
    own palette's colours, looping; each frame's delay as PIL reads the JAX
    package's file: 0 (its writer takes the duration in milliseconds)."""
    from PIL import Image

    from gazenerf_tpu_torch.utils.gif import quantize

    frames = loops[0]["gaze"]
    R.save_gif(str(tmp_path / "p.gif"), frames)
    JR.save_gif(str(tmp_path / "j.gif"), frames)
    with open(tmp_path / "p.gif", "rb") as f:
        assert f.read(6) == b"GIF89a"
    got, want = Image.open(tmp_path / "p.gif"), Image.open(tmp_path / "j.gif")
    assert got.n_frames == len(frames) == 44 and 1 < want.n_frames <= 44
    assert got.info["loop"] == 0
    want_delays = set()
    for i in range(want.n_frames):
        want.seek(i)
        want_delays.add(want.info.get("duration", 0))
    assert want_delays == {0}
    for i, frame in enumerate(frames):
        got.seek(i)
        assert got.info.get("duration", 0) == 0
        palette, idx = quantize(frame)
        np.testing.assert_array_equal(np.asarray(got.convert("RGB")), palette[idx])
