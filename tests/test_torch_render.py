"""The PyTorch port's whole no-grad render against the JAX ``GazeNeRF``.

One JAX model per module (``small_test_config``), its weights carried over
with ``params_from_jax``; the same numpy inputs through both.
"""

import dataclasses
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gazenerf_tpu.config import small_test_config as jax_small_config
from gazenerf_tpu.models.gaze_nerf import GazeNeRF as JaxGazeNeRF
from gazenerf_tpu.ops import pixel_grid as jax_pixel_grid
from gazenerf_tpu.viewer.server import ViewerApp as JaxViewerApp
from gazenerf_tpu_torch import GazeNeRF, ModelConfig, ViewerApp, params_from_jax, small_test_config
from gazenerf_tpu_torch.ops.rays import pixel_grid
from gazenerf_tpu_torch.kernels import fused_field as ff
from gazenerf_tpu_torch.utils.png import decode_png
from gazenerf_tpu_torch.viewer.server import lookat_camera, make_handler
from torch_threads import one_thread  # noqa: F401

IMAGES = ("merge_img", "merge_img_face", "merge_img_eyes", "bg_img")
FEATMAPS = ("face", "eyes", "merge")
BF16 = dict(compute_dtype="bfloat16", renderer_dtype="bfloat16", pallas_interpret=True)


@pytest.fixture(scope="module")
def jax_setup():
    jcfg = jax_small_config()
    rng = np.random.default_rng(1)
    B, Fs = 2, jcfg.model.featmap_size
    xy = np.asarray(jax_pixel_grid(Fs))[None].repeat(B, 0)
    shape = (rng.standard_normal((B, 179)) * 0.1).astype(np.float32)
    appea = (rng.standard_normal((B, 127)) * 0.1).astype(np.float32)
    gaze = (rng.standard_normal((B, 2)) * 0.3).astype(np.float32)
    R = np.diag([1.0, -1.0, -1.0]).astype(np.float32)[None].repeat(B, 0)
    T = np.zeros((B, 3, 1), np.float32)
    T[:, 2, 0] = 12.0
    Kinv = np.array([[0.0077908 * 2, 0.0, -0.1255383],
                     [0.0, 0.0077908 * 2, -0.1283246],
                     [0.0, 0.0, 1.0]], np.float32)[None].repeat(B, 0)
    inputs = (xy, shape, appea, gaze, R, T, Kinv)
    model = JaxGazeNeRF(jcfg.model)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), *map(jnp.asarray, inputs))
    return jcfg, _random_biases(variables, rng), inputs


def _random_biases(variables, rng):
    """The init zeroes every bias; trained ones are not.  Fill each with
    0.1 * N(0, 1) so that a bias dropped or carried to the wrong layer by
    ``params_from_jax`` shows."""

    def fill(path, leaf):
        if str(getattr(path[-1], "key", "")).endswith("bias"):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return np.asarray(leaf)

    out = jax.tree_util.tree_map_with_path(fill, variables)
    n_bias = sum(
        str(getattr(path[-1], "key", "")).endswith("bias")
        for path, _ in jax.tree_util.tree_flatten_with_path(out)[0]
    )
    assert n_bias > 30, n_bias  # fields (12 each) and renderer
    return out


def _port(jcfg_model, variables, **over):
    cfg = ModelConfig(**dataclasses.asdict(dataclasses.replace(jcfg_model, **over)))
    model = GazeNeRF(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables, cfg.n_upsample_blocks), strict=True)
    return model.eval()


def _run_both(jcfg_model, variables, inputs, **over):
    jmodel = JaxGazeNeRF(dataclasses.replace(jcfg_model, **over))
    want = jax.jit(jmodel.apply)(variables, *map(jnp.asarray, inputs))
    with torch.no_grad():
        got = _port(jcfg_model, variables, **over)(*map(torch.from_numpy, inputs))
    return got, want


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def test_slice_f32_matches_jax(jax_setup):
    """f32 on both sides: the repo's pixel tolerance, 2e-4
    (tests/test_model_parity.py); the featmaps and weights at 1e-4 (sums of
    8 samples of ~1-magnitude features); depth, the weights times plane
    depths of ~9-15, at 1e-3."""
    jcfg, variables, inputs = jax_setup
    got, want = _run_both(jcfg.model, variables, inputs)
    for k in IMAGES:
        np.testing.assert_allclose(_np(got["coarse_dict"][k]), _np(want["coarse_dict"][k]),
                                   atol=2e-4, rtol=0, err_msg=k)
    for k in FEATMAPS:
        np.testing.assert_allclose(_np(got["featmaps"][k]), _np(want["featmaps"][k]),
                                   atol=1e-4, rtol=0, err_msg=k)
    np.testing.assert_allclose(_np(got["weights"]), _np(want["weights"]), atol=1e-4)
    for k in ("face", "eyes"):
        np.testing.assert_allclose(_np(got["depth"][k]), _np(want["depth"][k]), atol=1e-3)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_slice_bf16_matches_jax(jax_setup, use_pallas):
    """The bf16 slice.  With ``use_pallas`` the port's fields go through the
    fused-field wrapper (its plain version on the CPU), against JAX with the
    Pallas kernel in interpret mode; without it both run the bf16 field
    module.  bf16 arithmetic rounds at other points in the two frameworks:
    the JAX package's own bf16 image bound, 3e-2 (tests/test_fused_field.py,
    fused vs XLA model)."""
    jcfg, variables, inputs = jax_setup
    before = ff.launch_count
    got, want = _run_both(jcfg.model, variables, inputs, **BF16, use_pallas=use_pallas)
    assert ff.launch_count == before  # CPU tensors: no kernel launch
    for k in IMAGES:
        np.testing.assert_allclose(_np(got["coarse_dict"][k]), _np(want["coarse_dict"][k]),
                                   atol=3e-2, rtol=0, err_msg=k)
    for k in FEATMAPS:
        np.testing.assert_allclose(_np(got["featmaps"][k]), _np(want["featmaps"][k]),
                                   atol=3e-2, rtol=0, err_msg=k)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_bf16_phase_gm_images_round_as_jax(jax_setup, use_pallas):
    """The bf16 renderer's stencils sum in f32 and the image comes back in
    f32, as JAX's (its numpy-scalar taps promote bf16 to f32).  Readings
    (max abs, port vs JAX): merge_img 1.7e-3 / 1.9e-3 (use_pallas True /
    False), face 1.6e-3 / 1.7e-3, eyes 2.1e-3 / 2.5e-3, bg_img 5.4e-4.  With
    the stencils rounding to bf16 after every tap, as before the repair:
    6.9e-3, 5.7e-3 / 5.4e-3, 5.8e-3 / 6.1e-3 and 2.7e-3, in bf16.  Held to
    4e-3 and, for bg_img, 1e-3."""
    jcfg, variables, inputs = jax_setup
    got, want = _run_both(jcfg.model, variables, inputs, **BF16, use_pallas=use_pallas)
    for k in IMAGES:
        assert got["coarse_dict"][k].dtype == torch.float32, k
        err = np.abs(_np(got["coarse_dict"][k]) - _np(want["coarse_dict"][k])).max()
        assert err <= (1e-3 if k == "bg_img" else 4e-3), (k, err)


# the renderer's kernel modes, at model level: JAX in the same mode with its
# Pallas kernels in interpret mode.  Readings, max abs over the four images:
# f32 4.3e-6 in both modes, held to the repository's 2e-4; bf16 (the fields
# through the fused field kernel on both sides) pallas 2.3e-3, fused 1.9e-3,
# as phase_gm's 2.5e-3, held to 4e-3
RENDERER_MODES = ("pallas", "fused")


@pytest.mark.parametrize("mode", RENDERER_MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_renderer_modes_match_jax(jax_setup, mode, dtype):
    jcfg, variables, inputs = jax_setup
    over = dict(shuffle_mode=mode, pallas_interpret=True)
    if dtype == "bfloat16":
        over.update(BF16, use_pallas=True)
    got, want = _run_both(jcfg.model, variables, inputs, **over)
    for k in IMAGES:
        assert got["coarse_dict"][k].dtype == torch.float32, k
        np.testing.assert_allclose(_np(got["coarse_dict"][k]), _np(want["coarse_dict"][k]),
                                   atol=2e-4 if dtype == "float32" else 4e-3, rtol=0, err_msg=k)


@pytest.mark.parametrize("mode", RENDERER_MODES)
def test_params_from_jax_loads_strict_in_kernel_modes(jax_setup, mode):
    """The kernel modes keep the parameter tree: the JAX weights load
    strictly, and the state dict has the ``phase_gm`` model's keys."""
    jcfg, variables, _ = jax_setup
    cfg = ModelConfig(**dataclasses.asdict(dataclasses.replace(jcfg.model, shuffle_mode=mode)))
    model = GazeNeRF(cfg, device="cpu")
    sd = params_from_jax(variables, cfg.n_upsample_blocks)
    model.load_state_dict(sd, strict=True)
    base = GazeNeRF(dataclasses.replace(cfg, shuffle_mode="phase_gm"), device="cpu")
    assert set(model.state_dict()) == set(base.state_dict()) == set(sd)


def test_params_from_jax_loads_strict(jax_setup):
    jcfg, variables, _ = jax_setup
    cfg = ModelConfig(**dataclasses.asdict(jcfg.model))
    sd = params_from_jax(variables, cfg.n_upsample_blocks)
    model = GazeNeRF(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    assert "fg_CD_predictor_face.FeaExt_module_0.weight" in sd
    assert "neural_render.feat_upsample_list.0.layer_1.weight" in sd
    for k, v in model.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    model.load_state_dict(sd, strict=True)
    sd.pop("neural_render.bg_featmap")
    with pytest.raises(RuntimeError, match="bg_featmap"):
        model.load_state_dict(sd, strict=True)


def test_viewer_matches_jax_viewer(jax_setup):
    """The port's viewer image (uint8) against the JAX viewer's jitted
    render on the same weights and camera, f32: within one grey level."""
    jcfg, variables, _ = jax_setup
    cfg = ModelConfig(**dataclasses.asdict(jcfg.model))
    app = ViewerApp(cfg, state_dict=params_from_jax(variables, cfg.n_upsample_blocks),
                    device="cpu")
    japp = JaxViewerApp(jcfg, params=variables)
    q = (0.2, -0.3, 15.0, 5.0, 11.0)
    R, T, K = map(jnp.asarray, lookat_camera(q[2], q[3], q[4], cfg.featmap_size))
    want = np.asarray(japp._render(jnp.asarray([[q[0], q[1]]], jnp.float32), R, T, K))
    got = app.render(*q)
    assert got.shape == want.shape == (cfg.pred_img_size, cfg.pred_img_size, 3)
    assert got.dtype == np.uint8
    assert int(np.abs(got.astype(np.int16) - want).max()) <= 1


def test_viewer_runs_one_renderer_pass(jax_setup):
    """The viewer shows ``merge_img`` only, so it runs one renderer pass
    where the model's forward runs four, and its image is the forward's
    ``merge_img``."""
    jcfg, variables, _ = jax_setup
    cfg = ModelConfig(**dataclasses.asdict(jcfg.model))
    app = ViewerApp(cfg, state_dict=params_from_jax(variables, cfg.n_upsample_blocks),
                    device="cpu")
    passes = []
    hook = app.model.neural_render.register_forward_hook(lambda *a: passes.append(1))
    q = (0.2, -0.3, 15.0, 5.0, 11.0)
    try:
        img = app.render_image(*q)
        assert len(passes) == 1
        R, T, K = (torch.from_numpy(a) for a in lookat_camera(q[2], q[3], q[4], cfg.featmap_size))
        with torch.no_grad():
            out = app.model(app.xy, app.shape_code, app.appea_code,
                            torch.tensor([q[:2]]), R, T, K)
        assert len(passes) == 5
    finally:
        hook.remove()
    torch.testing.assert_close(img, out["coarse_dict"]["merge_img"][0], atol=0, rtol=0)


def test_viewer_serves_render_over_http(jax_setup):
    """One ``/render`` request over ``ThreadingHTTPServer`` on port 0."""
    from http.server import ThreadingHTTPServer

    jcfg, variables, _ = jax_setup
    cfg = ModelConfig(**dataclasses.asdict(jcfg.model))
    app = ViewerApp(cfg, state_dict=params_from_jax(variables, cfg.n_upsample_blocks),
                    device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(app))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(base + "/render?pitch=0.1&yaw=-0.2&az=10&el=0&dist=12&t=1",
                                    timeout=60) as r:
            assert r.headers["Content-Type"] == "image/png"
            img = decode_png(r.read())
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            assert json.loads(r.read()) == {"ok": True}
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            assert b"GazeNeRF viewer" in r.read()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert img.shape == (cfg.pred_img_size, cfg.pred_img_size, 3)
    np.testing.assert_array_equal(img, app.render(0.1, -0.2, 10.0, 0.0, 12.0))


@pytest.mark.parametrize(
    "option",
    [
        dict(pallas_stash_every=2),
        dict(pallas_fuse_embed=True),
        dict(pallas_embed_bf16=True, pallas_split_dw=True),
        dict(shuffle_mode="phase"),
        dict(shuffle_mode="naive"),
        dict(renderer_fold_feat=False),
        dict(renderer_rgb_cf=False),
    ],
)
def test_unported_options_raise(option):
    """The settings once refused run now: the small model on the bf16 fused
    field path renders with each on the CPU, the image within f32 rounding
    of the render without it on the same weights (the field settings to the
    bit: a render writes no stash, whatever its form; the plain versions
    encode the points, or take the bf16 embedding, as the kernels do; the
    renderer modes differ from ``phase_gm`` in their f32 summation order)."""
    cfg = dataclasses.replace(small_test_config(), compute_dtype="bfloat16", use_pallas=True)
    R, T, K = (torch.from_numpy(a) for a in lookat_camera(10, -5, 12.0, cfg.featmap_size))
    args = (pixel_grid(cfg.featmap_size)[None], 0.1 * torch.ones(1, cfg.shape_code_dims),
            0.1 * torch.ones(1, cfg.appea_code_dims), torch.tensor([[0.2, -0.3]]), R, T, K)
    with torch.no_grad():
        want = GazeNeRF(cfg, device="cpu")(*args)["coarse_dict"]["merge_img"]
        got = GazeNeRF(dataclasses.replace(cfg, **option), device="cpu")(*args)
    atol = 0.0 if next(iter(option)).startswith("pallas") else 1e-5
    torch.testing.assert_close(got["coarse_dict"]["merge_img"], want, atol=atol, rtol=0)
