"""The evaluation protocols.

The port's counterpart of the JAX package's ``eval/protocols.py``
(upstream ``utils/metrics_utils.py``), all four protocols and their
sweeps:

* :func:`evaluate_input_target_images` — per (input, target) pair: fit on
  the input image, re-render with the target's camera and gaze, score gaze
  and head angular error, SSIM, PSNR, LPIPS, L1 and identity similarity,
  and FID across the collected sets (identity similarity through the
  FaceX-Zoo pipeline, ``models/face_recognition.py``, where one is given);
* :func:`evaluate_personal_calibration` — fit on some images of a subject
  and synthesize the others, normalized to 224x224 for fine-tuning an
  estimator (an h5 file, where ``h5py`` is installed);
* :func:`evaluate_consistency` — shift the fitted gaze's pitch by 5 to 20
  degrees and measure the estimator's response;
* :func:`evaluate_gaze_transfer` — recover a gaze code by optimization on
  one subject and render it on another.

Each protocol fits every pair from the same base state (``fit`` copies;
the base is not changed).  Images stay on the device; the per-pair metrics
are read on the host.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gazenerf_tpu_torch.config import Config
from gazenerf_tpu_torch.eval import metrics as M
from gazenerf_tpu_torch.models.vgg import normalize_imagenet
from gazenerf_tpu_torch.ops.image import resize_bilinear
from gazenerf_tpu_torch.train.fitting import (
    FitState,
    make_fit_single_image,
    make_optimize_gaze,
    make_predict_single_image,
)


def _single(batch: Dict, i: int = 0) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v)[i:i + 1] for k, v in batch.items()}


def split_target_batch(batch: Dict[str, np.ndarray]) -> Dict[str, Dict]:
    """A target-mode loader batch (``target_*`` keys) -> ``{"input",
    "target"}``."""
    inp = {k: v for k, v in batch.items() if not k.startswith("target_")}
    tgt = {k[len("target_"):]: v for k, v in batch.items() if k.startswith("target_")}
    return {"input": inp, "target": tgt}


def make_eval_normalizer(img_dim: int = 224) -> Callable:
    """The estimator-input normalization (upstream
    ``utils/gaze_estimation_utils.py`` ``normalize``): the head pose from
    the six-landmark subset, then the focal-960, distance-600 virtual
    camera's warp to ``img_dim``.  Returns ``normalizer(img01 [H, W, 3]
    tensor, landmarks68 [68, 2], cam_matrix, cam_distortion) -> [img_dim,
    img_dim, 3]`` f32 in [0, 1], on the image's device."""
    from gazenerf_tpu_torch.data.face_model import FACE_MODEL_3D
    from gazenerf_tpu_torch.preprocess.normalize import estimate_head_pose, normalize_face

    # face-model rows [20, 23, 26, 29, 15, 19] pair with the 68-point
    # landmarks [36, 39, 42, 45, 31, 35]
    fm = FACE_MODEL_3D[[20, 23, 26, 29, 15, 19], :]

    def normalizer(img01, landmarks68, cam_matrix, cam_distortion):
        u8 = (img01.to(torch.float32).clamp(0.0, 1.0) * 255).to(torch.uint8)
        lm = np.asarray(landmarks68, np.float64)[[36, 39, 42, 45, 31, 35], :]
        K = np.asarray(cam_matrix, np.float64)
        rvec, tvec = estimate_head_pose(lm, fm, K, np.asarray(cam_distortion, np.float64))
        warped, _, _ = normalize_face(u8, fm, rvec, tvec, K, img_dim=img_dim,
                                      focal_norm=960.0, distance_norm=600.0)
        return warped.to(torch.float32) / 255.0

    return normalizer


@dataclasses.dataclass
class EvalContext:
    """The fit, predict and optimize closures around a base state, and the
    metric hooks."""

    cfg: Config
    base_state: FitState
    fit: Callable
    predict: Callable
    optimize_gaze: Callable
    estimator_fn: Optional[Callable] = None  # img -> (gaze, head) pitch-yaw
    feats_fn: Optional[Callable] = None  # img -> list of feature maps
    embed_fn: Optional[Callable] = None  # img -> identity embedding (real weights only)
    # the FaceX-Zoo pipeline (detect, align, crop, embed: models/
    # face_recognition.IdentitySimilarityPipeline), taken before embed_fn:
    # (uint8 a, uint8 b) -> similarity
    identity_pipeline: Optional[Callable] = None
    lpips_fn: Optional[Callable] = None  # (a, b) -> [B] distances
    fid_feats_fn: Optional[Callable] = None  # imgs -> [B, D] features
    # estimator-input normalization (make_eval_normalizer) and the
    # per-camera calibration: cam_index -> (camera_matrix, distortion)
    normalizer: Optional[Callable] = None
    cam_lookup: Optional[Callable] = None
    # False where the embedder has no real weights: identity_similarity is
    # then left out of the results rather than averaged in
    identity_valid: bool = True

    @classmethod
    def build(cls, cfg: Config, base_state: FitState, frozen, expr_fix: np.ndarray,
              fit_steps: int = 50, **hooks) -> "EvalContext":
        """The closures of ``train/fitting.py`` (``fit_steps`` fitting
        steps), the loss stack's VGG as ``feats_fn``, and the metric hooks
        given by name."""
        return cls(
            cfg=cfg, base_state=base_state,
            fit=make_fit_single_image(cfg, frozen, expr_fix, fit_steps),
            predict=make_predict_single_image(cfg, expr_fix),
            optimize_gaze=make_optimize_gaze(cfg, frozen, expr_fix),
            feats_fn=frozen.vgg_capture_fn(), **hooks,
        )


def _resize224_u8(img01: torch.Tensor) -> torch.Tensor:
    """``[1, H, W, 3]`` in [0, 1] -> ``[224, 224, 3]`` uint8 on its device:
    a bilinear resize (no antialiasing), clipped, times 255, truncated
    (upstream's ``trans_resize`` and uint8 cast)."""
    r = resize_bilinear(img01.to(torch.float32), (224, 224))[0]
    return (r.clamp(0.0, 1.0) * 255).to(torch.uint8)


def _warp224(ctx: EvalContext, img: torch.Tensor, batch) -> torch.Tensor:
    """A ``[1, H, W, 3]`` image in [0, 1], face-normalized to ``[1, 224,
    224, 3]`` (upstream applies its ``normalize`` to every estimator input
    and to the calibration frames): the camera from ``cam_lookup`` by the
    batch's camera index, else the batch's intrinsics and no distortion;
    without a normalizer, a bilinear resize to 224."""
    if ctx.normalizer is None:
        return resize_bilinear(img, (224, 224))
    if ctx.cam_lookup is not None:
        cam_K, cam_d = ctx.cam_lookup(int(np.asarray(batch["cam_index"]).reshape(-1)[0]))
    else:
        cam_K, cam_d = np.asarray(batch["inmat"])[0], np.zeros((5, 1))
    lm68 = np.asarray(batch["landmarks"])[0]
    return ctx.normalizer(img[0], lm68, cam_K, cam_d)[None]


def _estimator_input(ctx: EvalContext, img, batch) -> torch.Tensor:
    """:func:`_warp224`, then ImageNet statistics (upstream's ``trans``)."""
    return normalize_imagenet(_warp224(ctx, img, batch))


def _whiten_nonhead(batch, device) -> torch.Tensor:
    """The batch's image with everything outside the head mask white."""
    img = torch.as_tensor(batch["image"], device=device)
    hm = torch.as_tensor(batch["head_mask"], device=device)[..., None]
    return torch.where((hm < 0.5).expand_as(img), torch.ones_like(img), img)


def _pair_metrics(ctx: EvalContext, pred_img, target_img, tgt) -> Dict[str, float]:
    """One pair's metrics (upstream ``utils/metrics_utils.py``):
    ``target_img`` is already whitened outside the head; both are full-size
    ``[1, H, W, 3]`` in [0, 1].  LPIPS takes ``(target, pred)``, as
    upstream calls it."""
    out = {
        "ssim": float(M.ssim(pred_img, target_img)[0]),
        "psnr": float(M.psnr(pred_img, target_img)[0]),
        "l1": float(M.l1(pred_img, target_img)[0]),
    }
    if ctx.lpips_fn is not None:
        out["lpips"] = float(ctx.lpips_fn(target_img, pred_img)[0])
    elif ctx.feats_fn is not None:
        with torch.no_grad():
            out["lpips"] = float(M.lpips_like(ctx.feats_fn, pred_img, target_img)[0])
    if ctx.estimator_fn is not None:
        with torch.no_grad():
            g_gt, h_gt = ctx.estimator_fn(_estimator_input(ctx, target_img, tgt))
            g_pr, h_pr = ctx.estimator_fn(_estimator_input(ctx, pred_img, tgt))
        v = M.pitchyaw_to_vector
        out["gaze_angular_deg"] = float(M.angular_error_deg(v(g_gt), v(g_pr)).mean())
        out["head_angular_deg"] = float(M.angular_error_deg(v(h_gt), v(h_pr)).mean())
    if not ctx.identity_valid:
        pass  # no real embedder weights: the score would mean nothing
    elif ctx.identity_pipeline is not None:
        # upstream scores a pair its pipeline fails on as -0.1; here only
        # the pipeline's own host-side failures (a degenerate box or fit),
        # never an error of the card
        try:
            out["identity_similarity"] = float(ctx.identity_pipeline(
                _resize224_u8(target_img), _resize224_u8(pred_img)))
        except (ValueError, np.linalg.LinAlgError):
            out["identity_similarity"] = -0.1
    elif ctx.embed_fn is not None:
        with torch.no_grad():
            out["identity_similarity"] = float(
                M.identity_similarity(ctx.embed_fn, pred_img, target_img)[0])
    return out


def _input_target_collect(ctx: EvalContext, pairs):
    """Per pair: fit on the input from the base state, render with the
    target's camera and gaze, whiten the target outside the head, score.
    Returns the per-pair metrics and the whitened targets and predictions
    (device tensors ``[H, W, 3]``) for FID."""
    per_pair, gt_images, pred_images = [], [], []
    device = ctx.base_state.device
    for pair in pairs:
        inp, tgt = _single(pair["input"]), _single(pair["target"])
        fitted, _ = ctx.fit(ctx.base_state, inp)
        pred = torch.nan_to_num(ctx.predict(fitted, tgt), nan=1.0)
        gt = _whiten_nonhead(tgt, device)
        per_pair.append(_pair_metrics(ctx, pred, gt, tgt))
        gt_images.append(gt[0])
        pred_images.append(pred[0])
    return per_pair, gt_images, pred_images


def _fid_of(ctx: EvalContext, gt_images, pred_images) -> Optional[float]:
    """FID between the collected sets: through ``fid_feats_fn`` where given,
    else the Frechet distance of the VGG features' deepest capture,
    averaged over space (as Inception's pool3 is)."""
    if len(gt_images) < 2:
        return None
    if ctx.fid_feats_fn is not None:
        return M.fid(ctx.fid_feats_fn, gt_images, pred_images)
    if ctx.feats_fn is not None:
        def pool(imgs):
            with torch.no_grad():
                fs = [ctx.feats_fn(im[None])[-1].mean(dim=(0, 1, 2)) for im in imgs]
            return torch.stack(fs).double().cpu().numpy()

        return M.frechet_distance(pool(pred_images), pool(gt_images))
    return None


def _aggregate_pairs(per_pair: List[Dict[str, float]]) -> Dict[str, float]:
    keys = [k for k in per_pair[0] if isinstance(per_pair[0][k], (int, float))]
    return {k: float(np.mean([m[k] for m in per_pair])) for k in keys}


def _backend_labels(ctx: EvalContext) -> Dict[str, str]:
    """Which backend gave LPIPS and FID: ``exact`` (the published metric's
    nets) or the VGG fallbacks."""
    out: Dict[str, str] = {}
    if ctx.lpips_fn is not None:
        out["lpips_backend"] = "exact"
    elif ctx.feats_fn is not None:
        out["lpips_backend"] = "vgg_fallback"
    if ctx.fid_feats_fn is not None:
        out["fid_backend"] = "exact"
    elif ctx.feats_fn is not None:
        out["fid_backend"] = "vgg_gap_fallback"
    return out


def _summary(ctx: EvalContext, per_pair, gt_images, pred_images) -> Dict[str, object]:
    res = _aggregate_pairs(per_pair) if per_pair else {}
    f = _fid_of(ctx, gt_images, pred_images)
    if f is not None:
        res["fid"] = f
    res["num_pairs"] = len(per_pair)
    res.update(_backend_labels(ctx))
    return res


def evaluate_input_target_images(ctx: EvalContext, pairs: List[Dict[str, Dict]]) -> Dict[str, float]:
    """``pairs``: ``{"input": batch, "target": batch}`` single-sample dicts
    (from a target-mode loader through :func:`split_target_batch`).  The
    pairs' mean metrics, FID over the collected sets, ``num_pairs`` and the
    backend labels."""
    return _summary(ctx, *_input_target_collect(ctx, pairs))


def evaluate_input_target_sweep(ctx: EvalContext, subject_pairs: Dict[str, List]) -> Dict[str, object]:
    """Every subject's pairs: per-subject metrics and FID, and the
    dataset's over the pooled pairs and image sets (one subject's pooled
    sets are its own: its summary)."""
    per_subject: Dict[str, Dict] = {}
    all_pairs, all_gt, all_pred = [], [], []
    for subj, pairs in subject_pairs.items():
        if not pairs:
            continue
        pp, gt_imgs, pred_imgs = _input_target_collect(ctx, pairs)
        per_subject[subj] = _summary(ctx, pp, gt_imgs, pred_imgs)
        all_pairs += pp
        all_gt += gt_imgs
        all_pred += pred_imgs
    if len(per_subject) == 1:
        # the pooled pairs and image sets are that subject's: the same
        # summary, without a second FID (a 2048-wide sqrtm on the host)
        overall = dict(next(iter(per_subject.values())))
    else:
        overall = _summary(ctx, all_pairs, all_gt, all_pred)
    overall["num_subjects"] = len(per_subject)
    return {"per_subject": per_subject, "overall": overall}


def evaluate_personal_calibration(ctx: EvalContext, batches: List[Dict[str, np.ndarray]],
                                  fit_indices: List[int],
                                  out_h5_path: Optional[str] = None) -> Dict[str, object]:
    """Fit on ``batches[i]`` for each of ``fit_indices`` in turn, then the
    normalized 224x224 frame of every batch: the whitened real image for a
    fitted frame, the prediction (its stored gaze) for the others, BGR
    uint8.  With ``out_h5_path``, writes them as upstream does:
    ``face_patch`` ``(N, 224, 224, 3)`` uint8, lzf, one chunk per frame
    (needs ``h5py``)."""
    state = ctx.base_state
    fit_set = set(int(i) for i in fit_indices)
    for i in sorted(fit_set):
        state, _ = ctx.fit(state, _single(batches[i]))
    frames = []
    for i, b in enumerate(batches):
        sb = _single(b)
        if i in fit_set:
            img = _whiten_nonhead(sb, state.device)
        else:
            img = torch.nan_to_num(ctx.predict(state, sb), nan=1.0)
        warped = _warp224(ctx, img, sb)[0]
        frames.append((warped.clamp(0.0, 1.0) * 255).to(torch.uint8).flip(-1))  # RGB -> BGR
    arr = torch.stack(frames).cpu().numpy()
    if out_h5_path is not None:
        import h5py

        with h5py.File(out_h5_path, "w") as f:
            d = f.create_dataset("face_patch", shape=arr.shape, compression="lzf",
                                 dtype=np.uint8, chunks=(1, 224, 224, 3))
            d[...] = arr
    return {"face_patch": arr, "h5_path": out_h5_path, "num_frames": len(frames),
            "state": state}


def evaluate_personal_calibration_sweep(ctx: EvalContext, batches: List[Dict[str, np.ndarray]],
                                        num_fit_images: int, num_iterations: int = 1,
                                        rng: Optional[np.random.Generator] = None,
                                        out_dir: Optional[str] = None,
                                        subject: str = "subject") -> Dict[str, Dict[str, object]]:
    """``num_iterations`` rounds, each fitting ``num_fit_images`` indices
    drawn from ``rng`` with replacement and writing
    ``<subject>_nsample_<N>_iter_<k>.h5`` into ``out_dir``."""
    rng = rng or np.random.default_rng(0)
    out: Dict[str, Dict[str, object]] = {}
    for it in range(num_iterations):
        n_fit = min(num_fit_images, len(batches))
        fit_idx = [int(i) for i in rng.integers(0, len(batches), size=n_fit)]
        h5_path = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            h5_path = os.path.join(
                out_dir, f"{subject.replace('.h5', '')}_nsample_{num_fit_images}_iter_{it}.h5")
        r = evaluate_personal_calibration(ctx, batches, fit_idx, out_h5_path=h5_path)
        out[f"iter_{it}"] = {"num_frames": r["num_frames"], "h5_path": r["h5_path"],
                             "fit_indices": fit_idx}
    return out


def evaluate_consistency(ctx: EvalContext, batches: List[Dict[str, np.ndarray]],
                         pitch_shifts_deg=(5.0, 10.0, 15.0, 20.0),
                         fit_index: int = 0) -> Dict[str, float]:
    """Fit on ``batches[fit_index]``; for every other frame render with the
    stored gaze and with its pitch shifted by each of ``pitch_shifts_deg``,
    and read both through the normalization and the estimator: the mean
    |pitch change| (it should follow the command) and |yaw change| (it
    should stay near 0) in degrees.  Without an estimator, the mean
    absolute image change stands in for the pitch response and the yaw
    response is 0."""
    pitch_resp = {s: [] for s in pitch_shifts_deg}
    yaw_resp = {s: [] for s in pitch_shifts_deg}
    fitted, _ = ctx.fit(ctx.base_state, _single(batches[fit_index]))
    for i, b in enumerate(batches):
        if i == fit_index:
            continue
        sb = _single(b)
        base_gaze = np.asarray(sb["pitchyaw"][0], np.float32)
        base_img = torch.nan_to_num(ctx.predict(fitted, sb), nan=1.0)
        if ctx.estimator_fn is not None:
            with torch.no_grad():
                g0 = ctx.estimator_fn(_estimator_input(ctx, base_img, sb))[0][0].cpu().numpy()
        for s in pitch_shifts_deg:
            gz = base_gaze + np.array([np.deg2rad(s), 0.0], np.float32)
            img = torch.nan_to_num(ctx.predict(fitted, sb, gz), nan=1.0)
            if ctx.estimator_fn is not None:
                with torch.no_grad():
                    g1 = ctx.estimator_fn(_estimator_input(ctx, img, sb))[0][0].cpu().numpy()
                pitch_resp[s].append(abs(float(np.rad2deg(g1[0] - g0[0]))))
                yaw_resp[s].append(abs(float(np.rad2deg(g1[1] - g0[1]))))
            else:
                pitch_resp[s].append(float((img - base_img).abs().mean()))
                yaw_resp[s].append(0.0)
    out: Dict[str, float] = {}
    for s in pitch_shifts_deg:
        out[f"shift_{int(s)}deg_pitch_response_deg"] = float(np.mean(pitch_resp[s]))
        out[f"shift_{int(s)}deg_yaw_response_deg"] = float(np.mean(yaw_resp[s]))
    return out


def evaluate_gaze_transfer(ctx: EvalContext, source_batch: Dict[str, np.ndarray],
                           target_batch: Dict[str, np.ndarray]) -> Dict[str, object]:
    """Fit on the source, recover its gaze by optimization from 0, fit on
    the target, and render the target with the recovered gaze."""
    src, tgt = _single(source_batch), _single(target_batch)
    fitted_src, _ = ctx.fit(ctx.base_state, src)
    gaze, loss, steps = ctx.optimize_gaze(fitted_src, src, np.zeros(2, np.float32))
    fitted_tgt, _ = ctx.fit(ctx.base_state, tgt)
    transferred = ctx.predict(fitted_tgt, tgt, gaze)
    return {
        "gaze": gaze.cpu().numpy(),
        "opt_loss": float(loss),
        "opt_steps": int(steps),
        "transferred_image": transferred[0].float().cpu().numpy(),
    }
