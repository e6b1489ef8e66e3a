"""The port's evaluation protocols (``eval/protocols.py``) against the
JAX package's.

Both sides run the small model (``tests/torch_fitting_case.py``) on the
same weights and batches, with the same cheap stand-ins for the frozen
nets (an estimator, features and an embedding computed from the images'
pooled colours), the real prediction and face normalizer (JAX's through
OpenCV), and stand-ins for the fit (it moves the appearance offset by the
image's mean) and the gaze optimization (it moves the gaze by the image's
mean colours): the fit's and the optimization's own parity is
``tests/test_torch_fitting*.py``'s and ``tests/test_torch_gaze_opt.py``'s,
and here each protocol's own work (which frames are fitted, rendered,
whitened, warped and scored, in which order) is held to f32 rounding.
The real fit runs in the base-state test.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")  # the JAX normalizer calls OpenCV

from gazenerf_tpu.eval import protocols as JP  # noqa: E402
from gazenerf_tpu.train.fitting import make_predict_single_image as jax_make_predict  # noqa: E402
from gazenerf_tpu_torch.data.face_model import FACE_MODEL_3D  # noqa: E402
from gazenerf_tpu_torch.eval import protocols as P  # noqa: E402
from gazenerf_tpu_torch.preprocess.normalize import project_points  # noqa: E402
from gazenerf_tpu_torch.train.fitting import FitState, make_predict_single_image  # noqa: E402
from torch_fitting_case import (  # noqa: E402
    EXPR_FIX,
    jax_model_and_frozen,
    jax_state_of,
    make_batch,
    make_case,
    port_trainer,
)
from torch_threads import one_thread  # noqa: F401,E402

GAZE_STEPS = 3
# f32 images and metrics: SSIM, PSNR, L1, the feature distance, the
# identity score and FID read at most 9.6e-8 apart, held to 1e-5 relative.
# The estimator's inputs pass through the face normalizer, where the port's
# converged head pose and JAX's one OpenCV refinement lie up to 3e-5 rad
# apart (tests/test_torch_normalize.py): the angular readings lie up to
# 1.3e-4 apart (the consistency protocol's, a difference of two readings),
# held to 1e-3.
METRIC_RTOL = 1e-5
WARPED_RTOL = 1e-3
# the warped uint8 calibration frames: 1 level apart on 0.016% of the
# pixels; held as tests/test_torch_normalize.py holds the warp
FRAME_MAX_LEVELS = 1
FRAME_MAX_SHARE = 1e-3


def _pool(x, lib):
    """``[B, H, W, 3]`` -> 8x8 average pools of the image and its square,
    ``[B, H/8, W/8, 3]`` each."""
    B, H, W, C = x.shape
    p = x.reshape(B, H // 8, 8, W // 8, 8, C).mean(axis=(2, 4))
    return [p, p * p]


def _estimator(x, lib):
    """(gaze, head) pitch-yaw pairs from the pooled colours."""
    m = x.mean(axis=(1, 2))
    return (lib.stack([0.1 * m[:, 0], 0.1 * m[:, 1]], 1),
            lib.stack([0.1 * m[:, 2], 0.1 * (m[:, 0] - m[:, 1])], 1))


def _embed(x, lib):
    return _pool(x, lib)[0].reshape(x.shape[0], -1)


def _jax_fit(state, batch):
    """The stand-in fit: the appearance offset's row 0 moves by 0.05 times
    the image's mean (fits chain, as personal calibration's do)."""
    off = dict(state.offsets)
    off["appea"] = off["appea"].at[0].add(0.05 * jnp.mean(jnp.asarray(batch["image"])))
    return state.replace(offsets=off), None


def _port_fit(state, batch):
    off = dict(state.offsets)
    off["appea"] = off["appea"].detach().clone()
    off["appea"][0] += 0.05 * torch.as_tensor(batch["image"]).mean()
    return FitState(state.model, off, state.seed), None


def _optimize(state, batch, gaze_init, lib):
    """The stand-in gaze optimization: the start moved by the image's mean
    red and green less a half; the image's mean as the loss."""
    m = lib.asarray(batch["image"]).mean(axis=(0, 1, 2))
    return lib.asarray(gaze_init) + 0.5 * (m[:2] - 0.5), m.mean(), GAZE_STEPS


def _batches(n, featmap_size, seed=20):
    """``n`` frames of one subject: the fitting case's batch with other
    images and gazes, landmarks whose six normalizer rows are a face
    model's projection through the batch's camera, and a camera index."""
    out = []
    for i in range(n):
        b = make_batch(seed + i, featmap_size)
        rng = np.random.default_rng(100 + seed + i)
        lm = rng.uniform(10, 50, (1, 68, 2))
        rvec = rng.normal(0, 0.15, 3)
        tvec = np.array([rng.normal(0, 10), rng.normal(0, 10), 1000.0])
        lm[0, [36, 39, 42, 45, 31, 35]] = project_points(
            FACE_MODEL_3D[[20, 23, 26, 29, 15, 19]], rvec, tvec, b["inmat"][0].astype(np.float64))
        b["landmarks"] = lm.astype(np.float32)
        b["cam_index"] = np.array([[i % 18]], np.int64)
        out.append(b)
    return out


@pytest.fixture(scope="module")
def contexts():
    jcfg, params, offsets, _ = make_case()
    model, _ = jax_model_and_frozen(jcfg)
    jctx = JP.EvalContext(
        cfg=jcfg, model=model, base_state=jax_state_of(params, offsets), fit=_jax_fit,
        predict=jax_make_predict(jcfg, model, EXPR_FIX),
        optimize_gaze=lambda st, b, g: _optimize(st, b, g, jnp),
        estimator_fn=lambda x: _estimator(x, jnp), feats_fn=lambda x: _pool(x, jnp),
        embed_fn=lambda x: _embed(x, jnp), normalizer=JP.make_eval_normalizer())
    tr = port_trainer(jcfg, params, offsets)
    pctx = P.EvalContext(
        cfg=tr.cfg, base_state=FitState.of(tr), fit=_port_fit,
        predict=make_predict_single_image(tr.cfg, EXPR_FIX),
        optimize_gaze=lambda st, b, g: _optimize(st, b, g, torch),
        estimator_fn=lambda x: _estimator(x, torch), feats_fn=lambda x: _pool(x, torch),
        embed_fn=lambda x: _embed(x, torch), normalizer=P.make_eval_normalizer())
    return jctx, pctx, tr, _batches(4, jcfg.model.featmap_size)


def _same_metrics(got, want, warped=()):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, str):
            assert got[k] == w, k
        else:
            rtol = WARPED_RTOL if k in warped else METRIC_RTOL
            assert got[k] == pytest.approx(w, rel=rtol, abs=1e-6), k


def test_input_target_matches_jax(contexts):
    jctx, pctx, _, b = contexts
    pairs = [{"input": b[0], "target": b[1]}, {"input": b[2], "target": b[3]}]
    want = JP.evaluate_input_target_images(jctx, pairs)
    got = P.evaluate_input_target_images(pctx, pairs)
    assert {"ssim", "psnr", "l1", "lpips", "fid", "gaze_angular_deg", "head_angular_deg",
            "identity_similarity", "num_pairs", "lpips_backend", "fid_backend"} <= set(got)
    _same_metrics(got, want, warped=("gaze_angular_deg", "head_angular_deg"))
    sweep = {"s0": pairs, "s1": pairs[:1], "s2": []}
    want = JP.evaluate_input_target_sweep(jctx, sweep)
    got = P.evaluate_input_target_sweep(pctx, sweep)
    assert set(got["per_subject"]) == set(want["per_subject"]) == {"s0", "s1"}
    for s in want["per_subject"]:
        _same_metrics(got["per_subject"][s], want["per_subject"][s],
                      warped=("gaze_angular_deg", "head_angular_deg"))
    _same_metrics(got["overall"], want["overall"], warped=("gaze_angular_deg", "head_angular_deg"))


def test_consistency_matches_jax(contexts):
    jctx, pctx, _, b = contexts
    want = JP.evaluate_consistency(jctx, b[:3], pitch_shifts_deg=(5.0, 20.0), fit_index=1)
    got = P.evaluate_consistency(pctx, b[:3], pitch_shifts_deg=(5.0, 20.0), fit_index=1)
    _same_metrics(got, want, warped=tuple(want))


def _frames_close(got, want):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert d.max() <= FRAME_MAX_LEVELS and (d > 0).mean() <= FRAME_MAX_SHARE, \
        (d.max(), (d > 0).mean())


def test_personal_calibration_matches_jax(contexts, tmp_path):
    """The synthesized frames (fitted frames whitened, the others rendered,
    each normalized to 224 in BGR) and the h5 files; the sweep's draws."""
    h5py = pytest.importorskip("h5py")
    jctx, pctx, _, b = contexts
    want = JP.evaluate_personal_calibration(jctx, b, [2, 0], str(tmp_path / "j.h5"))
    got = P.evaluate_personal_calibration(pctx, b, [2, 0], str(tmp_path / "p.h5"))
    assert got["face_patch"].shape == want["face_patch"].shape == (4, 224, 224, 3)
    assert got["face_patch"].dtype == np.uint8
    _frames_close(got["face_patch"], want["face_patch"])
    with h5py.File(tmp_path / "p.h5") as f:
        np.testing.assert_array_equal(f["face_patch"][...], got["face_patch"])
        assert f["face_patch"].chunks == (1, 224, 224, 3)
    np.testing.assert_allclose(got["state"].offsets["appea"].numpy(),
                               np.asarray(want["state"].offsets["appea"]), rtol=1e-6)
    kw = dict(num_fit_images=2, num_iterations=2, out_dir=str(tmp_path / "sweep"), subject="s.h5")
    want = JP.evaluate_personal_calibration_sweep(jctx, b[:3], rng=np.random.default_rng(7), **kw)
    got = P.evaluate_personal_calibration_sweep(pctx, b[:3], rng=np.random.default_rng(7), **kw)
    assert got == want


def test_gaze_transfer_matches_jax(contexts):
    jctx, pctx, _, b = contexts
    want = JP.evaluate_gaze_transfer(jctx, b[0], b[1])
    got = P.evaluate_gaze_transfer(pctx, b[0], b[1])
    assert got["opt_steps"] == want["opt_steps"] == GAZE_STEPS
    np.testing.assert_allclose(got["gaze"], want["gaze"], rtol=1e-4)
    assert got["opt_loss"] == pytest.approx(want["opt_loss"], rel=1e-5)
    np.testing.assert_allclose(got["transferred_image"], want["transferred_image"], atol=2e-4)


def test_protocol_leaves_the_base_state_unchanged(contexts):
    """The real fit inside a protocol (``EvalContext.build``): the base
    model and offsets keep their bits."""
    _, _, tr, b = contexts
    ctx = P.EvalContext.build(tr.cfg, FitState.of(tr), tr.frozen, EXPR_FIX, fit_steps=2,
                              normalizer=P.make_eval_normalizer())
    model_before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    offsets_before = {k: v.detach().clone() for k, v in tr.offsets.items()}
    res = P.evaluate_input_target_images(ctx, [{"input": b[0], "target": b[1]}])
    assert np.isfinite(res["ssim"]) and res["num_pairs"] == 1
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, model_before[k]), k
    for k, v in tr.offsets.items():
        assert torch.equal(v.detach(), offsets_before[k]), k
