"""The evaluation slice as a whole: the input-target protocol (the small
model, the real prediction and face normalizer, the stand-in fit and
estimator of ``tests/test_torch_protocols.py``) with exact FID (seeded
InceptionV3) and the FaceX-Zoo identity pipeline (seeded RetinaFace, PFLD,
MobileFaceNet), the port's against the JAX package's on the same weights.
Each side's FID takes a scipy ``sqrtm`` of a 2048-wide product (about 13 s
on this kind of host), as the JAX package's own FID tests do."""

import dataclasses

import pytest
import torch

pytest.importorskip("cv2")  # the JAX normalizer, aligner and crop call OpenCV

from gazenerf_tpu.eval import protocols as JP  # noqa: E402
from gazenerf_tpu.models import face_alignment as JA  # noqa: E402
from gazenerf_tpu.models import face_detection as JD  # noqa: E402
from gazenerf_tpu.models import face_recognition as JR  # noqa: E402
from gazenerf_tpu.models.inception import inception_from_torch  # noqa: E402
from gazenerf_tpu.models.inception import make_fid_features_fn as jax_make_fid_features_fn  # noqa: E402
from gazenerf_tpu_torch.eval import protocols as P  # noqa: E402
from gazenerf_tpu_torch.models.face_alignment import PFLDAligner  # noqa: E402
from gazenerf_tpu_torch.models.face_detection import RetinaFaceDetector  # noqa: E402
from gazenerf_tpu_torch.models.face_recognition import IdentitySimilarityPipeline  # noqa: E402
from gazenerf_tpu_torch.models.inception import InceptionV3FID, make_fid_features_fn  # noqa: E402
from gazenerf_tpu_torch.models.seeding import seed_frozen_net_, seeded_identity_state_dicts  # noqa: E402
from test_torch_protocols import _same_metrics, contexts  # noqa: E402,F401
from torch_threads import one_thread  # noqa: F401,E402

# the JAX package's own bounds for its nets against torch: MobileFaceNet's
# for the identity score (tests/test_face_pipeline.py), InceptionV3's for
# FID (tests/test_metrics_backends.py)
IDENTITY_ATOL = 2e-4
FID_RTOL = 1e-3


def test_input_target_with_fid_and_identity_pipeline_matches_jax(contexts):
    """The whole slice: the input-target protocol on two pairs with exact
    FID (seeded InceptionV3) and the FaceX-Zoo pipeline (seeded RetinaFace,
    PFLD, MobileFaceNet) on both sides, from the same state dicts; every
    pair detected and aligned."""
    jctx, pctx, _, b = contexts
    np_sd = (lambda sd: {k: v.numpy() for k, v in sd.items()})
    inc = seed_frozen_net_(InceptionV3FID(), torch.Generator().manual_seed(1)).state_dict()
    ids = seeded_identity_state_dicts(torch.Generator().manual_seed(5))
    jpipe = JR.IdentitySimilarityPipeline(
        JR.mobilefacenet_from_torch(np_sd(ids["embed"])),
        JD.RetinaFaceDetector(JD.retinaface_params_from_torch(np_sd(ids["detector"]))),
        JA.PFLDAligner(JA.pfld_params_from_torch(np_sd(ids["aligner"]))))
    pipe = IdentitySimilarityPipeline(ids["embed"], RetinaFaceDetector(ids["detector"], "cpu"),
                                      PFLDAligner(ids["aligner"], "cpu"), "cpu")
    stages = []

    def recording(a, b):
        score = pipe(a, b)
        stages.append(pipe.last_stages)
        return score

    j = dataclasses.replace(jctx, fid_feats_fn=jax_make_fid_features_fn(
        inception_from_torch(np_sd(inc))), identity_pipeline=jpipe)
    p = dataclasses.replace(pctx, fid_feats_fn=make_fid_features_fn(inc, "cpu"),
                            identity_pipeline=recording)
    pairs = [{"input": b[0], "target": b[1]}, {"input": b[2], "target": b[3]}]
    want = JP.evaluate_input_target_images(j, pairs)
    got = P.evaluate_input_target_images(p, pairs)
    assert got["fid_backend"] == want["fid_backend"] == "exact"
    assert stages == [("aligned", "aligned")] * 2
    assert got["identity_similarity"] == pytest.approx(want["identity_similarity"], abs=IDENTITY_ATOL)
    assert got["fid"] == pytest.approx(want["fid"], rel=FID_RTOL)
    others = {k: v for k, v in want.items() if k not in ("identity_similarity", "fid")}
    _same_metrics({k: got[k] for k in others}, others,
                  warped=("gaze_angular_deg", "head_angular_deg"))
