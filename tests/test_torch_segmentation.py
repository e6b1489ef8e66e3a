"""The port's segmentation nets (``preprocess/unet.py``,
``preprocess/bisenet.py``) and maskers (``preprocess/masks.py``) against
the JAX package's, on the same random weights and BatchNorm statistics
(JAX variables carried across by ``utils/transplant``), f32: logits within
1e-5 relative L2, labels equal except where the top two logits lie within
1e-5; the maskers' masks and ``process_frame`` with both nets equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")  # the JAX maskers' cleanup calls OpenCV

from gazenerf_tpu.preprocess import bisenet as JB  # noqa: E402
from gazenerf_tpu.preprocess import driver as JD  # noqa: E402
from gazenerf_tpu.preprocess import landmarks as JL  # noqa: E402
from gazenerf_tpu.preprocess import masks as JM  # noqa: E402
from gazenerf_tpu.preprocess import unet as JU  # noqa: E402
from gazenerf_tpu_torch.preprocess import driver as D  # noqa: E402
from gazenerf_tpu_torch.preprocess import landmarks as L  # noqa: E402
from gazenerf_tpu_torch.preprocess import masks as M  # noqa: E402
from gazenerf_tpu_torch.preprocess.bisenet import BiSeNet  # noqa: E402
from gazenerf_tpu_torch.preprocess.unet import UNet  # noqa: E402
from gazenerf_tpu_torch.utils import transplant  # noqa: E402
from torch_threads import one_thread  # noqa: F401,E402

LOGIT_REL_L2 = 1e-5
TIE = 1e-5  # labels may differ only where the top two logits lie this close


def _random_variables(net, size: int, seed: int, eye_rows: bool = True):
    """A JAX net's variables drawn from ``seed``: kernels N(0, 2 / fan_in),
    biases and means N(0, 0.1^2), scales and variances U[0.5, 1.5).  With
    ``eye_rows`` False, BiSeNet's classifier rows of the two eye labels are
    made negative, so its parse holds no eye pixel (the U-Net's turn)."""
    rng = np.random.default_rng(seed)
    v = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))

    def draw(path, x):
        name = path[-1].key
        if name in ("var", "scale"):
            a = rng.uniform(0.5, 1.5, x.shape)
        elif name in ("bias", "mean"):
            a = rng.normal(0, 0.1, x.shape)
        else:
            a = rng.normal(0, np.sqrt(2.0 / max(1, np.prod(x.shape[:-1]))), x.shape)
            if not eye_rows and [p.key for p in path][-3:] == ["head", "conv_out", "kernel"]:
                a[..., [M.LEFT_EYE_LABEL, M.RIGHT_EYE_LABEL]] = -np.abs(
                    a[..., [M.LEFT_EYE_LABEL, M.RIGHT_EYE_LABEL]]) - 0.5
        return jnp.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, v)


def _check_logits(got, want):
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= LOGIT_REL_L2, rel
    top2 = np.sort(want, axis=-1)[..., -2:]
    differ = got.argmax(-1) != want.argmax(-1)
    assert not differ[(top2[..., 1] - top2[..., 0]) > TIE].any()
    return rel


@pytest.mark.parametrize("net,size", [("unet", 64), ("unet", 128), ("bisenet", 64),
                                      ("bisenet", 96)])
def test_nets_match_jax(net, size):
    """Both nets' logits on a random image against JAX's (NHWC there, NCHW
    here), their converted weights loading strictly (BiSeNet's auxiliary
    heads, absent in JAX, aside)."""
    jnet, tnet, conv = ((JU.UNet(), UNet(), transplant.unet_params_from_jax) if net == "unet"
                        else (JB.BiSeNet(), BiSeNet(), transplant.bisenet_params_from_jax))
    v = _random_variables(jnet, size, seed=size)
    x = np.random.default_rng(size + 1).random((1, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)(v, jnp.asarray(x)))
    missing, unexpected = tnet.load_state_dict(conv(v), strict=False)
    assert not unexpected and all(k.startswith(("conv_out16.", "conv_out32.")) for k in missing)
    assert (len(missing) > 0) == (net == "bisenet")
    with torch.no_grad():
        got = tnet.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    _check_logits(got, want)


def test_upstream_state_dicts_load_as_they_are():
    """Upstream's layouts: the U-Net's ``unet().state_dict()`` and BiSeNet's
    ``79999_iter.pth`` (with its auxiliary heads) load strictly into the
    maskers; the JAX package's ``*_from_torch`` read the same names."""
    g = torch.Generator().manual_seed(0)
    from gazenerf_tpu_torch.models.seeding import seed_frozen_net_

    u, b = seed_frozen_net_(UNet(), g), seed_frozen_net_(BiSeNet(), g)
    um = M.UNetEyeMasker(u.state_dict(), device="cpu")
    bm = M.BiSeNetMasker(b.state_dict(), device="cpu")
    assert um.available and bm.available
    params, stats = JU.unet_params_from_torch({k: v.numpy() for k, v in u.state_dict().items()})
    back = transplant.unet_params_from_jax({"params": params, "batch_stats": stats})
    for k, v in u.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    jv = JB.bisenet_from_torch({k: v.numpy() for k, v in b.state_dict().items()})
    back = transplant.bisenet_params_from_jax(jv)
    for k, v in b.state_dict().items():
        if not k.endswith("num_batches_tracked") and not k.startswith(("conv_out16", "conv_out32")):
            np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    with pytest.raises(RuntimeError, match="weights"):
        M.BiSeNetMasker(device="cpu")(np.zeros((64, 64, 3), np.float32))


@pytest.fixture(scope="module")
def maskers():
    """Seeded maskers on both sides at 64^2: BiSeNet with and without eye
    pixels, and the U-Net."""
    out = {}
    for name, eye_rows in (("bisenet", True), ("bisenet_no_eyes", False)):
        v = _random_variables(JB.BiSeNet(), 64, seed=5, eye_rows=eye_rows)
        out[name] = (M.BiSeNetMasker(transplant.bisenet_params_from_jax(v), device="cpu"),
                     JM.BiSeNetMasker(v))
    v = _random_variables(JU.UNet(), 64, seed=6)
    out["unet"] = (M.UNetEyeMasker(transplant.unet_params_from_jax(v), device="cpu"),
                   JM.UNetEyeMasker(v))
    return out


def test_maskers_match_jax(maskers):
    """The maskers' masks (the label tables, the head cleanup, the eye
    halves, the half-profile cameras) equal JAX's."""
    img = np.random.default_rng(8).random((64, 64, 3)).astype(np.float32)
    for cam in (0, 11, 14):
        for got, want in zip(maskers["bisenet"][0](img, cam), maskers["bisenet"][1](img, cam)):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(maskers["unet"][0](img), maskers["unet"][1](img)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["bisenet", "bisenet_no_eyes"])
def test_process_frame_with_nets_matches_jax(maskers, which):
    """``process_frame`` with the seeded BiSeNet and U-Net against JAX's,
    each h5 field: BiSeNet's masks, or (its eye rows negative) the U-Net's
    eyes, then the landmark rectangles for a side still empty.  The warp is
    ``warp_perspective``'s (1 level on at most 1e-3 of the pixels, as
    ``tests/test_torch_preprocess.py``)."""
    img = (np.random.default_rng(9).random((200, 240, 3)) * 255).astype(np.uint8)
    K = np.array([[500.0, 0, 120.0], [0, 500.0, 100.0], [0, 0, 1.0]])
    fm = np.array([[-45.0, -30.0, 30.0], [-15.0, -30.0, 35.0], [15.0, -30.0, 35.0],
                   [45.0, -30.0, 30.0], [-25.0, 30.0, 30.0], [25.0, 30.0, 30.0]])
    kw = dict(cam_index=2, img_size=64, gaze_vector=np.array([0.05, -0.02, -0.99]),
              head_pose=(np.array([0.02, -0.05, 0.01]), np.array([3.0, -2.0, 560.0])))
    got = D.process_frame(img, K, fm, L.LandmarkDetector(), masker=maskers[which][0],
                          eye_masker=maskers["unet"][0], device="cpu", **kw)
    want = JD.process_frame(img, K, fm, JL.LandmarkDetector(), masker=maskers[which][1],
                            eye_masker=maskers["unet"][1], **kw)
    d = np.abs(got["face_patch"].astype(int) - want["face_patch"].astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    for key in ("head_mask", "left_eye_mask", "right_eye_mask", "cam_index", "inmat"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("facial_landmarks", "pitchyaw_head", "face_head_pose"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4, err_msg=key)
    if which == "bisenet_no_eyes":  # BiSeNet found no eyes: the U-Net's turn
        _, left, right = maskers[which][0](got["face_patch"].astype(np.float32) / 255.0, 2)
        assert not left.any() and not right.any()
