"""The port's FaceX-Zoo identity pipeline (``models/face_detection.py``,
``face_alignment.py``, ``face_recognition.py``) against the JAX package's,
on seeded weights in FaceX-Zoo's layouts (``models/seeding.py``): each
net, the detector's host steps, the aligner's crop, the arcface crop, the
fallback resize, the whole pipeline, and the weight bridges.

The JAX side's crop, warp and resize are OpenCV's; the port's are PyTorch
ops.  Each JAX net compiles once per input shape: RetinaFace at 224, PFLD
and MobileFaceNet at 112 (the module fixture's detector, aligner and
embedder serve every test)."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")  # the JAX aligner, crop and fallback call OpenCV

from gazenerf_tpu.models import face_alignment as JA  # noqa: E402
from gazenerf_tpu.models import face_detection as JD  # noqa: E402
from gazenerf_tpu.models import face_recognition as JR  # noqa: E402
from gazenerf_tpu_torch.models import face_alignment as A  # noqa: E402
from gazenerf_tpu_torch.models import face_detection as D  # noqa: E402
from gazenerf_tpu_torch.models import face_recognition as R  # noqa: E402
from gazenerf_tpu_torch.models.seeding import (  # noqa: E402
    seed_frozen_net_,
    seeded_identity_state_dicts,
)
from gazenerf_tpu_torch.preprocess.normalize import resize_linear_u8  # noqa: E402
from gazenerf_tpu_torch.utils import transplant  # noqa: E402
from torch_threads import one_thread  # noqa: F401,E402

# the JAX package's own bounds for its nets against torch
# (tests/test_face_pipeline.py): RetinaFace, PFLD, MobileFaceNet
RETINA_TOL = dict(atol=3e-4, rtol=1e-3)
PFLD_TOL = dict(atol=5e-4, rtol=1e-3)
MFN_TOL = dict(atol=2e-4, rtol=1e-3)
# the arcface crop, warp_affine against cv2.warpAffine: one level on at most
# 0.1% of the pixels (reading: equal to the bit in every case here)
CROP_MAX_LEVELS, CROP_MAX_SHARE = 1, 1e-3
# landmarks in image pixels, port against JAX, where both crops are equal
# to the bit: PFLD's f32 rounding times the box (reading 7.6e-6 px)
LANDMARK_ATOL = 1e-3


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _smooth(seed, size=224):
    """A smooth uint8 image: 8x8 noise blown up by OpenCV."""
    x = np.random.default_rng(seed).random((8, 8, 3))
    return cv2.resize((x * 255).astype(np.uint8), (size, size))


@pytest.fixture(scope="module")
def case():
    """The identity pipeline's seeded nets on both sides, and two smooth
    224x224 images (the protocol's size)."""
    sds = seeded_identity_state_dicts(torch.Generator().manual_seed(5))
    jdet = JD.RetinaFaceDetector(JD.retinaface_params_from_torch(_np(sds["detector"])))
    jal = JA.PFLDAligner(JA.pfld_params_from_torch(_np(sds["aligner"])))
    jpipe = JR.IdentitySimilarityPipeline(JR.mobilefacenet_from_torch(_np(sds["embed"])), jdet, jal)
    det = D.RetinaFaceDetector(sds["detector"], "cpu")
    al = A.PFLDAligner(sds["aligner"], "cpu")
    pipe = R.IdentitySimilarityPipeline(sds["embed"], det, al, "cpu")
    return {"sds": sds, "jax": (jdet, jal, jpipe), "port": (det, al, pipe),
            "images": [_smooth(1), _smooth(2)]}


def test_retinaface_heads_match_jax(case):
    """The three heads at 224 on a BGR-less-means image."""
    (jdet, _, _), (det, _, _) = case["jax"], case["port"]
    x = case["images"][0].astype(np.float32) - np.float32(D.BGR_MEANS)
    want = jdet._apply(jnp.asarray(x)[None])
    with torch.no_grad():
        got = det.net(torch.from_numpy(x).permute(2, 0, 1)[None])
    for g, w, name in zip(got, want, ("boxes", "scores", "landmarks")):
        assert g.shape == w.shape == (1, 2058, g.shape[-1]), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **RETINA_TOL)


def test_anchors_decoding_and_nms_match_jax():
    for hw in ((224, 224), (120, 100)):
        np.testing.assert_array_equal(D.prior_boxes(hw), JD.prior_boxes(hw))
    rng = np.random.default_rng(6)
    priors = D.prior_boxes((120, 100))
    loc = rng.standard_normal((len(priors), 4)).astype(np.float32)
    np.testing.assert_array_equal(D.decode_boxes(loc, priors), JD.decode_boxes(loc, priors))
    xy = rng.uniform(0, 100, (40, 2))
    dets = np.hstack([xy, xy + rng.uniform(5, 40, (40, 2)), rng.random((40, 1))]).astype(np.float32)
    for thresh in (0.2, 0.5):
        keep = D.nms(dets, thresh)
        assert keep == JD.nms(dets, thresh) and 1 < len(keep) < 40


def test_detector_matches_jax(case):
    """Preprocess, net, decode, threshold and NMS: the same detections; the
    best clears the 0.7 threshold by far more than rounding moves it."""
    (jdet, _, _), (det, _, _) = case["jax"], case["port"]
    for img in case["images"]:
        want, got = jdet(img), det(img)
        assert got.shape == want.shape and len(got) > 1
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-3, rtol=0)
        np.testing.assert_allclose(got[:, 4], want[:, 4], atol=1e-6, rtol=0)
        assert got[0, 4] > 0.9


def test_pfld_matches_jax():
    """PFLD at 112 on seeded weights (the regression unscaled)."""
    net = seed_frozen_net_(A.PFLD(), torch.Generator().manual_seed(11))
    x = np.random.default_rng(1).random((1, 112, 112, 3), np.float32)
    jvars = JA.pfld_params_from_torch(_np(net.state_dict()))
    want = jax.jit(JA.PFLD().apply)(jvars, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (1, 212)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PFLD_TOL)


# boxes (x1, y1, x2, y2, score) on a 224 image: over the left and top edges,
# over the right and bottom, inside and shrunk to 112, inside and blown up
EDGE_BOXES = {"left_top": (-20.3, -7.6, 60.2, 81.9), "right_bottom": (150.7, 171.2, 240.4, 250.0),
              "inside_down": (40.0, 30.0, 180.5, 170.2), "inside_up": (90.2, 80.9, 150.1, 140.6)}


@pytest.mark.parametrize("box", list(EDGE_BOXES))
def test_aligner_matches_jaxs_cv2_path(case, box, monkeypatch):
    """The crop (a zero pad for ``cv2.copyMakeBorder``, the uint8 resize for
    ``cv2.resize``) equals JAX's OpenCV crop to the level; the landmarks
    agree to PFLD's rounding, in image pixels."""
    (_, jal, _), (_, al, _) = case["jax"], case["port"]
    img, det = case["images"][1], np.array(EDGE_BOXES[box] + (0.9,), np.float32)
    seen = []
    apply = jal._apply
    monkeypatch.setattr(jal, "_apply", lambda x: seen.append(np.asarray(x)) or apply(x))
    want = jal(img, det)
    crop, _, _ = al.crop(img, det)
    np.testing.assert_array_equal(crop.numpy(), np.rint(seen[0][0] * 255).astype(np.uint8))
    got = al(img, det)
    assert got.shape == (106, 2)
    np.testing.assert_allclose(got, want, atol=LANDMARK_ATOL, rtol=0)


def test_aligner_raises_on_a_box_off_the_image(case):
    with pytest.raises(ValueError, match="misses"):
        case["port"][1](case["images"][0], np.array([300, 300, 340, 350, 0.9], np.float32))


def test_mobilefacenet_matches_jax(case):
    """The embedder at 112 (the resize a no-op there, ``(x - 0.5) / 0.5``,
    the net, the unit norm)."""
    jpipe, pipe = case["jax"][2], case["port"][2]
    x = np.random.default_rng(3).random((1, 112, 112, 3), np.float32)
    got = pipe.embed_fn(x)
    assert got.shape == (1, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(jpipe.embed_fn(jnp.asarray(x))), **MFN_TOL)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, rtol=1e-6)


def test_umeyama_matches_jax():
    """The similarity fit in float64: JAX's to the bit on noisy points; a
    known similarity recovered from exact ones."""
    rng = np.random.default_rng(5)
    src = rng.standard_normal((5, 2)) * 20 + 56
    th, s, t = 0.3, 1.7, np.array([3.0, -7.0])
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    dst = s * src @ rot.T + t
    noisy = dst + rng.standard_normal(dst.shape)
    np.testing.assert_array_equal(R.umeyama_similarity(src, noisy),
                                  JR.umeyama_similarity(src, noisy))
    M = R.umeyama_similarity(src, dst)
    np.testing.assert_allclose(M[:, :2], s * rot, atol=1e-5)
    np.testing.assert_allclose(M[:, 2], t, atol=1e-3)


def _template_landmarks(theta, scale, shift, rng):
    """106 landmarks whose arcface points are the template turned by
    ``theta``, scaled and shifted into a 224 image; the rest random."""
    lms = rng.uniform(60, 160, (106, 2))
    c, s = np.cos(theta), np.sin(theta)
    lms[list(R.LMS5_FROM_106)] = scale * R.ARCFACE_SRC @ np.array([[c, s], [-s, c]]) + shift
    return lms.astype(np.float32)


@pytest.mark.parametrize("theta, scale", [(0.0, 1.5), (0.35, 1.2), (-0.6, 0.8)])
def test_arcface_crop_against_cv2(case, theta, scale):
    """``warp_affine`` against JAX's ``cv2.warpAffine``, on a smooth image and
    on noise; the untilted 1.5x case puts every source point on a half
    pixel, where the sums round on ties."""
    rng = np.random.default_rng(9)
    lms = _template_landmarks(theta, scale, np.array([30.0, 20.0]), rng)
    for img in (case["images"][0], (rng.random((224, 224, 3)) * 255).astype(np.uint8)):
        want = JR.arcface_crop(img, lms)
        got = R.arcface_crop(torch.from_numpy(img), lms)
        assert got.shape == (112, 112, 3) and got.dtype == torch.uint8
        d = np.abs(got.numpy().astype(int) - want.astype(int))
        assert d.max() <= CROP_MAX_LEVELS and (d > 0).mean() <= CROP_MAX_SHARE, \
            (d.max(), (d > 0).mean())


@pytest.mark.parametrize("size", [224, 150, 90])
def test_fallback_resize_equals_cv2(size):
    """``cv2.resize(img, (112, 112))`` on uint8, to the bit: the pipeline's
    fallback from the protocol's 224 images, and sizes of the aligner's
    crops either side of 112."""
    img = (np.random.default_rng(size).random((size, size + 3, 3)) * 255).astype(np.uint8)
    got = resize_linear_u8(torch.from_numpy(img), (112, 112))
    np.testing.assert_array_equal(got.numpy(), cv2.resize(img, (112, 112)))


@pytest.mark.parametrize("stages", ["aligned", "no_face", "resized"])
def test_pipeline_matches_jax(case, stages):
    """The whole pipeline on the same pairs (and an image against itself):
    detect, align, crop and embed; the detector finding no face (threshold
    above every score); no detector or aligner (the fallback resize)."""
    (jdet, jal, jpipe), (det, al, pipe) = case["jax"], case["port"]
    if stages != "aligned":
        jp, p = copy.copy(jpipe), copy.copy(pipe)
        if stages == "no_face":
            jp.detector, p.detector = copy.copy(jdet), copy.copy(det)
            jp.detector.cfg = p.detector.cfg = dict(D.DET_CFG, confidence_threshold=0.999)
        else:
            jp.detector = jp.aligner = p.detector = p.aligner = None
        jpipe, pipe = jp, p
    a, b = case["images"]
    got, want = pipe(a, b), jpipe(a, b)
    assert pipe.last_stages == (stages, stages)
    assert got == pytest.approx(want, abs=MFN_TOL["atol"])
    assert pipe(a, a) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("net", ["retinaface", "pfld", "mobilefacenet"])
def test_weight_bridges_round_trip_exactly(case, net):
    """The port's state dict -> JAX's ``*_from_torch`` -> the port's
    ``*_params_from_jax`` gives back every entry to the bit."""
    sd, to_jax, back = {
        "retinaface": (case["sds"]["detector"], JD.retinaface_params_from_torch,
                       transplant.retinaface_params_from_jax),
        "pfld": (case["sds"]["aligner"], JA.pfld_params_from_torch,
                 transplant.pfld_params_from_jax),
        "mobilefacenet": (case["sds"]["embed"], JR.mobilefacenet_from_torch,
                          transplant.mobilefacenet_params_from_jax),
    }[net]
    got = back(jax.tree_util.tree_map(np.asarray, to_jax(_np(sd))))
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
