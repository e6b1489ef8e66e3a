"""The port's face normalization (``preprocess/normalize.py``) against the
JAX package's OpenCV-based functions, and the whole evaluation normalizer
(``eval/protocols.make_eval_normalizer``) against JAX's; also the cameras
and the face model the two share (``data/cameras.py``,
``data/face_model.py``).  Needs OpenCV (the JAX side calls it)."""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from gazenerf_tpu.data import cameras as jax_cameras  # noqa: E402
from gazenerf_tpu.data.face_model import FACE_MODEL_3D as JAX_FACE_MODEL  # noqa: E402
from gazenerf_tpu.eval.protocols import make_eval_normalizer as jax_normalizer  # noqa: E402
from gazenerf_tpu.preprocess import normalize as JN  # noqa: E402
from gazenerf_tpu_torch.data import cameras  # noqa: E402
from gazenerf_tpu_torch.data.face_model import FACE_MODEL_3D  # noqa: E402
from gazenerf_tpu_torch.eval.protocols import make_eval_normalizer  # noqa: E402
from gazenerf_tpu_torch.preprocess import normalize as N  # noqa: E402
from torch_threads import one_thread  # noqa: F401,E402

FM6 = FACE_MODEL_3D[[20, 23, 26, 29, 15, 19], :]
LM_ROWS = [36, 39, 42, 45, 31, 35]
K = np.array([[1200.0, 0, 256.0], [0, 1200.0, 256.0], [0, 0, 1.0]])
DIST = np.array([[-0.12], [0.05], [0.001], [-0.002], [0.01]])
# the warp: OpenCV 5 and the port both weight the four neighbours in f32 and
# round the sum, with the source position in f32 on both sides but
# computed in other orders, so now and then a pixel rounds to the other
# level: 1 level on 0.017-0.050% of the pixels of a random image (OpenCV 4
# rounds the position to 1/32 pixel and reads up to a few levels off on
# sharp edges).  Limits: 1 level, on twice the largest share
WARP_MAX_LEVELS = 1
WARP_MAX_SHARE = 1e-3


def _case(seed, noise=1.0):
    """A plausible head pose, the six landmarks it projects to (with
    ``noise`` pixels of N(0, 1) noise) and a distortion."""
    rng = np.random.default_rng(seed)
    rvec = rng.normal(0, 0.25, (3, 1))
    tvec = np.array([[rng.normal(0, 30)], [rng.normal(0, 30)], [rng.uniform(500, 1100)]])
    dist = DIST if seed % 2 else np.zeros((5, 1))
    pts, _ = cv2.projectPoints(FM6, rvec, tvec, K, dist)
    return pts.reshape(-1, 2) + noise * rng.standard_normal((6, 2)), dist


def _cost(lm, rvec, tvec, dist):
    d = N.project_points(FM6, rvec, tvec, K, dist) - lm
    return float((d**2).sum())


def test_face_model_and_orbit_match_jax():
    np.testing.assert_array_equal(FACE_MODEL_3D, JAX_FACE_MODEL)
    for got, want in zip(cameras.orbit_cameras(45, 64), jax_cameras.orbit_cameras(45, 64)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_opencv_xml_reader_matches_cv2(tmp_path):
    path = str(tmp_path / "cam00.xml")
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
    fs.write("Camera_Matrix", K)
    fs.write("Distortion_Coefficients", DIST.T)
    fs.release()
    got = cameras.read_opencv_xml(path, "Camera_Matrix", "Distortion_Coefficients")
    np.testing.assert_array_equal(got[0], K)
    np.testing.assert_array_equal(got[1], DIST.T)
    np.testing.assert_array_equal(cameras.load_camera_calibrations("columbia", str(tmp_path))[1],
                                  DIST.T)


@pytest.mark.parametrize("seed", range(4))
def test_projection_and_rodrigues_match_cv2(seed):
    rng = np.random.default_rng(seed)
    rvec, tvec = rng.normal(0, 0.5, (3, 1)), np.array([[5.0], [-3.0], [800.0]])
    want, _ = cv2.projectPoints(FACE_MODEL_3D, rvec, tvec, K, DIST)
    np.testing.assert_allclose(N.project_points(FACE_MODEL_3D, rvec, tvec, K, DIST),
                               want.reshape(-1, 2), atol=1e-9, rtol=0)
    R = cv2.Rodrigues(rvec)[0]
    np.testing.assert_allclose(N.rodrigues(rvec), R, atol=1e-12)
    np.testing.assert_allclose(N.rotation_vector(R), rvec.ravel(), atol=1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_head_pose_reaches_cv2s_minimum(seed):
    """The port's pose against ``cv2.solvePnP`` run to convergence (the JAX
    function with 10 refinements): the same minimum of the reprojection
    error, the pose within 1e-8 rad and 1e-6 mm (readings up to 1.0e-9 and
    7.7e-8).  The normalizer's one refinement (``iterations=1``) stops
    short of it now and then (up to 3.4e-5 rad away): the port's cost is
    never above it."""
    lm, dist = _case(seed)
    r, t = N.estimate_head_pose(lm, FM6, K, dist)
    rc, tc = JN.estimate_head_pose(lm, FM6, K, dist, iterations=10)
    np.testing.assert_allclose(r, rc, atol=1e-8, rtol=0)
    np.testing.assert_allclose(t, tc, atol=1e-6, rtol=0)
    r1, t1 = JN.estimate_head_pose(lm, FM6, K, dist, iterations=1)
    assert _cost(lm, r, t, dist) <= _cost(lm, r1, t1, dist) * (1 + 1e-12)


@pytest.mark.parametrize("seed", range(3))
def test_warp_matches_cv2(seed):
    """``warp_perspective`` against ``cv2.warpPerspective`` on a random
    uint8 image and homography, at most WARP_MAX_LEVELS apart on at most
    WARP_MAX_SHARE of the pixels; and the frame ``normalize_face`` builds
    (R and W) equal to JAX's to 1e-12."""
    rng = np.random.default_rng(seed)
    img = (rng.random((300, 280, 3)) * 255).astype(np.uint8)
    lm, _ = _case(seed + 10, noise=0.0)
    rvec, tvec = N.estimate_head_pose(lm, FM6, K)
    want, R_j, W_j = JN.normalize_face(img, FM6, rvec, tvec, K, img_dim=224,
                                       focal_norm=960.0, distance_norm=600.0)
    got, R, W = N.normalize_face(torch.from_numpy(img), FM6, rvec, tvec, K, img_dim=224,
                                 focal_norm=960.0, distance_norm=600.0)
    np.testing.assert_allclose(R, R_j, atol=1e-12)
    np.testing.assert_allclose(W, W_j, rtol=1e-12)
    M = np.array([[0.8, 0.05, -30], [-0.03, 0.9, -10], [1e-4, 2e-4, 1.0]])
    M += rng.normal(0, 1e-3, (3, 3)) * np.array([[10, 10, 1e3], [10, 10, 1e3], [1e-2, 1e-2, 0]])
    for homography, out, ref in ((W, got, want), (M, None, None)):
        if out is None:
            out = N.warp_perspective(torch.from_numpy(img), homography, (224, 200))
            ref = cv2.warpPerspective(img, homography, (224, 200))
        d = np.abs(out.numpy().astype(int) - ref.astype(int))
        assert out.shape == ref.shape
        assert d.max() <= WARP_MAX_LEVELS and (d > 0).mean() <= WARP_MAX_SHARE, (d.max(), (d > 0).mean())


def test_eval_normalizer_matches_jax():
    """The whole normalizer (pose, face centre, warp to 224 at focal 960,
    distance 600) on a smooth image: JAX's (one OpenCV refinement) against
    the port's (the converged pose): 1 level apart on 0.0007% of the
    pixels; held to 1 level on at most 0.01%."""
    rng = np.random.default_rng(7)
    lm6, dist = _case(3)
    lm68 = rng.uniform(100, 400, (68, 2))
    lm68[LM_ROWS] = lm6
    yy, xx = np.mgrid[:512, :512] / 512.0
    img = np.stack([0.5 + 0.4 * np.sin(6 * xx + 2 * yy), 0.5 + 0.4 * np.cos(5 * yy),
                    0.5 + 0.3 * np.sin(4 * (xx + yy))], -1).astype(np.float32)
    want = jax_normalizer()(img, lm68, K, dist)
    got = make_eval_normalizer()(torch.from_numpy(img), lm68, K, dist).numpy()
    assert got.shape == want.shape == (224, 224, 3) and got.dtype == np.float32
    d = np.abs(got - want) * 255
    assert d.max() <= 1 + 1e-4 and (d > 1e-4).mean() <= 1e-4, (d.max(), (d > 1e-4).mean())
    assert np.abs(got - img[:224, :224]).mean() > 0.01  # a real warp, not the identity
