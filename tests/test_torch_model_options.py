"""The model's options that are off by default, held against the JAX package.

``hier_sampling`` (the fine pass: ``fine_dict``), ``include_vd`` (the
view-direction embedding into ``rgb_1``), ``ray_chunk`` (the fields in
checkpointed chunks of rays) and the renderer passes stacked along the batch
(``batch_fg_passes``, ``batch_renderer_passes``), in two configurations
that together turn each on: a JAX ``GazeNeRF`` at the size of the JAX
package's own test of the first two (``tests/test_misc.py``: 8 x 8 rays of 8
samples, 4 fine, hidden 32; 16 x 16 images here, one upsample block) and
the port on the same seeded weights (every bias 0.1 N(0, 1)) and numpy
inputs: the images at the repo's f32 pixel tolerance (``atol=2e-4``), the
gradients of one loss of every image at its gradient tolerance (relative
L2 under 2e-3 per module).  The port's chunked fields equal its unchunked
ones, on the single-branch and the dual-branch path; a ray shape the fused
field kernels do not take raises at construction.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gazenerf_tpu.config import ModelConfig as JaxModelConfig
from gazenerf_tpu.models.gaze_nerf import GazeNeRF as JaxGazeNeRF
from gazenerf_tpu.ops import pixel_grid as jax_pixel_grid
from gazenerf_tpu.utils.transplant import gazenerf_params_from_torch
from gazenerf_tpu_torch import GazeNeRF, ModelConfig, params_from_jax
from torch_threads import one_thread  # noqa: F401

TINY = dict(num_sample_coarse=8, num_sample_fine=4, featmap_size=8, pred_img_size=16,
            mlp_hidden=32, use_pallas=False)
GRAD_REL_L2 = 2e-3
MODULES = ("fg_CD_predictor_face", "fg_CD_predictor_eyes", "fine_fg_CD_predictor",
           "neural_render")
# each option, and the configuration that turns it on (ray_chunk does not
# apply with include_vd, in either package)
CONFIGS = {
    "fine_vd_fg": dict(hier_sampling=True, include_vd=True, batch_fg_passes=True),
    "chunk_all": dict(ray_chunk=16, batch_renderer_passes=True),  # 64 rays in 4 chunks
}
OPTIONS = {"hier_sampling": "fine_vd_fg", "include_vd": "fine_vd_fg",
           "batch_fg_passes": "fine_vd_fg", "ray_chunk": "chunk_all",
           "batch_renderer_passes": "chunk_all"}


def tiny_inputs(B=2, Fs=8, seed=5):
    """Seeded codes and a camera that looks at the volume (the JAX test's)."""
    rng = np.random.default_rng(seed)
    xy = np.asarray(jax_pixel_grid(Fs))[None].repeat(B, 0)
    shape = (rng.standard_normal((B, 179)) * 0.1).astype(np.float32)
    appea = (rng.standard_normal((B, 127)) * 0.1).astype(np.float32)
    gaze = (rng.standard_normal((B, 2)) * 0.3).astype(np.float32)
    R = np.diag([1.0, -1.0, -1.0]).astype(np.float32)[None].repeat(B, 0)
    T = np.zeros((B, 3, 1), np.float32)
    T[:, 2, 0] = 12.0
    K = np.zeros((B, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 0.03
    K[:, 0, 2] = K[:, 1, 2] = -0.12
    K[:, 2, 2] = 1
    return (xy, shape, appea, gaze, R, T, K)


def _images(out):
    imgs = dict(out["coarse_dict"])
    imgs.update({f"fine_{k}": v for k, v in out.get("fine_dict", {}).items()})
    return imgs


def _loss(imgs):
    return sum((v.astype(jnp.float32) ** 2).sum() if isinstance(v, jax.Array)
               else (v.float() ** 2).sum() for v in imgs.values())


def run_both(option):
    """The port and the JAX model in ``option`` on the same weights (the
    port's seeded ones, every bias 0.1 N(0, 1), carried to JAX) and inputs:
    each side's images, and the gradients of the sum of squares of all its
    images as the port's state dict (JAX's carried back by
    ``params_from_jax``, a linear map per tensor)."""
    cfg = ModelConfig(**TINY, **option)
    model = GazeNeRF(cfg, device="cpu", seed=1)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for k, p in model.named_parameters():
            if k.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    n_blocks = cfg.n_upsample_blocks
    variables = gazenerf_params_from_torch(
        {k: v.numpy() for k, v in model.state_dict().items()}, n_blocks)
    inputs = tiny_inputs(Fs=cfg.featmap_size)
    jmodel = JaxGazeNeRF(JaxModelConfig(**dataclasses.asdict(cfg)))
    jin = tuple(map(jnp.asarray, inputs))

    def jloss(v):
        imgs = _images(jmodel.apply(v, *jin))
        return _loss(imgs), imgs

    (_, want), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables)
    got = _images(model(*map(torch.from_numpy, inputs)))
    _loss(got).backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return ({k: v.detach().numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()}, grads,
            params_from_jax(jgrad, n_blocks))


@pytest.fixture(scope="module")
def both():
    cache = {}

    def get(option):
        name = OPTIONS[option]
        if name not in cache:
            cache[name] = run_both(CONFIGS[name])
        return cache[name]
    return get


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_images_match_jax(both, option):
    """Every image of ``coarse_dict`` (and ``fine_dict`` with
    ``hier_sampling``) within the f32 pixel tolerance of JAX's."""
    got, want, _, _ = both(option)
    assert got.keys() == want.keys()
    if option == "hier_sampling":
        assert {"fine_merge_img", "fine_bg_img"} <= got.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=2e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_gradients_match_jax(both, option):
    """The gradients of one loss of every image, per module within 2e-3
    relative L2 of JAX's; with ``hier_sampling`` the fine field's too."""
    _, _, grads, want = both(option)
    assert grads.keys() == want.keys()
    for mod in MODULES:
        keys = [k for k in want if k.startswith(mod + ".")]
        if not keys:
            assert mod == "fine_fg_CD_predictor" and option in ("ray_chunk",
                                                                "batch_renderer_passes")
            continue
        g = torch.cat([grads[k].reshape(-1) for k in keys])
        w = torch.cat([want[k].reshape(-1) for k in keys])
        assert float(w.norm()) > 0, mod
        rel = float((g - w).norm() / w.norm())
        assert rel < GRAD_REL_L2, (mod, rel)


def _port_loss_grads(cfg, inputs, seed=3):
    torch.manual_seed(0)
    model = GazeNeRF(cfg, device="cpu", seed=seed)
    out = model(*map(torch.from_numpy, inputs))
    _loss(out["coarse_dict"]).backward()
    return out, {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("path", [
    dict(),
    dict(compute_dtype="bfloat16", renderer_dtype="bfloat16", use_pallas=True,
         pallas_dual_branch=True, pallas_stash_acts=True),
], ids=["single_branch_f32", "dual_stash_bf16"])
def test_chunked_equals_unchunked(path):
    """``ray_chunk`` does not change the numbers: the images and every
    gradient of the chunked run equal the unchunked run's (f32 noise on the
    single-branch path; on the dual-branch path with the stash, whose plain
    versions the CPU runs, the same and the stash recomputed per chunk)."""
    base = ModelConfig(**{**TINY, **path})
    inputs = tiny_inputs()
    out0, g0 = _port_loss_grads(base, inputs)
    out1, g1 = _port_loss_grads(dataclasses.replace(base, ray_chunk=16), inputs)
    for k, v in out0["coarse_dict"].items():
        torch.testing.assert_close(out1["coarse_dict"][k], v, atol=1e-6, rtol=1e-5)
    for k, v in g0.items():
        torch.testing.assert_close(g1[k], v, atol=1e-6, rtol=1e-4, msg=k)


@pytest.mark.parametrize("option, name", [
    (dict(num_sample_coarse=96), "num_sample_coarse"),
    (dict(num_sample_coarse=320), "num_sample_coarse"),
    (dict(num_sample_coarse=64, hier_sampling=True, num_sample_fine=100), "num_sample_fine"),
])
def test_ray_shapes_the_kernels_do_not_take_raise(option, name):
    """On the fused path a ray of S samples that neither divides 64 nor is a
    multiple of 64 up to 256 raises at construction, in ``_PORTED``'s form,
    naming the setting and ROADMAP Queue 2b, mode 6; the same shapes run on
    the module path, and the deep shapes the kernels take construct."""
    fused = ModelConfig(compute_dtype="bfloat16", use_pallas=True, **option)
    with pytest.raises(NotImplementedError, match=f"{name}=.*Queue 2b, mode 6"):
        GazeNeRF(fused, device="cpu")
    GazeNeRF(dataclasses.replace(fused, use_pallas=False), device="cpu")
    for deep in (dict(num_sample_coarse=256, ray_chunk=512, hier_sampling=False),
                 dict(num_sample_coarse=64, hier_sampling=True, num_sample_fine=128)):
        GazeNeRF(dataclasses.replace(fused, **deep), device="cpu")
