"""``python -m gazenerf_tpu_torch.cli.evaluate_metrics`` — the metric
protocols over a dataset.

The port's counterpart of ``python -m gazenerf_tpu.cli.evaluate_metrics``
(upstream ``evaluate_metrics.py``), with its flags and ``--device``: a
checkpoint (``--resume``), the frozen ResNet-50 gaze estimator
(``--estimator_ckpt``; without it the angular metrics are left out), LPIPS
(``--vgg_ckpt`` and ``--lpips_lin_ckpt``; without them the uniform-weight
VGG distance of the loss stack's VGG), FID's InceptionV3 features
(``--inception_ckpt``; without it the VGG features' Frechet distance,
labelled ``vgg_gap_fallback``), the FaceX-Zoo identity pipeline
(``--identity_embed_ckpt``, ``--identity_detector_ckpt``,
``--identity_aligner_ckpt``: MobileFaceNet, RetinaFace, PFLD; without the
embedder the score is left out and the result says
``identity_similarity_valid: false``), the face normalizer, and one of the
four protocols swept over the split's subjects of one or several
datasets.  Prints the result as JSON.

``--eval_precision`` sets the card's f32 arithmetic for the metric nets:
``highest`` (the default) turns TF32 off for matrix products and cuDNN
convolutions, ``high`` allows it, ``default`` leaves PyTorch's settings
(TF32 convolutions on Hopper).  Runs on the CUDA card unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np

from gazenerf_tpu_torch.cli.common import add_common_args, config_from_args


def build_estimator(ckpt_path: str, device=None):
    """The frozen ResNet-50 gaze estimator from an upstream checkpoint:
    ``fn(ImageNet-normalized [B, 224, 224, 3]) -> (gaze, head)``; None
    without a checkpoint (the angular metrics are then left out)."""
    if not ckpt_path:
        return None
    import torch

    from gazenerf_tpu_torch.models.resnet import GazeResNet, gaze_resnet_from_torch
    from gazenerf_tpu_torch.train.trainer import torch_state_dict

    net = GazeResNet()
    net.load_state_dict(gaze_resnet_from_torch(torch_state_dict(ckpt_path)), strict=True)
    net.to(device).requires_grad_(False).eval()
    return torch.no_grad()(net)


def build_lpips(vgg_ckpt: str, lin_ckpt: str, device=None):
    """LPIPS (upstream ``piq.LPIPS``) from a torchvision VGG16 checkpoint
    and the published linear heads; None without the VGG checkpoint (the
    protocols then take the uniform-weight VGG distance)."""
    if not vgg_ckpt:
        return None
    import torch

    from gazenerf_tpu_torch.eval.metrics import lpips_lin_from_torch, make_lpips_fn
    from gazenerf_tpu_torch.models.vgg import vgg_features_from_torch
    from gazenerf_tpu_torch.train.trainer import torch_state_dict

    sd = {k: v.numpy() for k, v in torch_state_dict(vgg_ckpt).items()}
    lin = None
    if lin_ckpt:
        lw = torch.load(lin_ckpt, map_location="cpu")
        lin = lpips_lin_from_torch([w.numpy() for w in lw] if isinstance(lw, (list, tuple))
                                   else {k: v.numpy() for k, v in lw.items()})
    return make_lpips_fn(vgg_features_from_torch(sd), lin_weights=lin, device=device)


def build_fid_features(inception_ckpt: str, device=None):
    """Exact FID's features (upstream ``piq.FID``: InceptionV3's pool3) from
    a pytorch-fid or torchvision checkpoint: ``fn(imgs [B, H, W, 3]) -> [B,
    2048]``; None without a checkpoint (the protocols then take the VGG
    features' Frechet distance)."""
    if not inception_ckpt:
        return None
    from gazenerf_tpu_torch.models.inception import make_fid_features_fn
    from gazenerf_tpu_torch.train.trainer import torch_state_dict

    return make_fid_features_fn(torch_state_dict(inception_ckpt), device=device)


def build_identity_pipeline(embed_ckpt: str, detector_ckpt: str, aligner_ckpt: str,
                            device=None):
    """The FaceX-Zoo identity pipeline (upstream
    ``evaluation_similarity.py``) from its checkpoints: MobileFaceNet,
    RetinaFace, PFLD.  A stage without a checkpoint falls back
    (``models/face_recognition.IdentitySimilarityPipeline``); without the
    embedder's, its weights are drawn from seed 0 and the score means
    nothing (the CLI then leaves it out)."""
    import torch

    from gazenerf_tpu_torch.models.face_alignment import PFLDAligner
    from gazenerf_tpu_torch.models.face_detection import RetinaFaceDetector
    from gazenerf_tpu_torch.models.face_recognition import IdentitySimilarityPipeline
    from gazenerf_tpu_torch.train.trainer import torch_state_dict

    detector = aligner = None
    if detector_ckpt:
        detector = RetinaFaceDetector(torch_state_dict(detector_ckpt), device)
    if aligner_ckpt:
        aligner = PFLDAligner(torch_state_dict(aligner_ckpt), device)
    return IdentitySimilarityPipeline(
        torch_state_dict(embed_ckpt) if embed_ckpt else None, detector, aligner, device,
        generator=None if embed_ckpt else torch.Generator().manual_seed(0))


def set_eval_precision(precision: str) -> None:
    """``highest``: true f32 for matrix products and cuDNN convolutions;
    ``high``: TF32 allowed in both; ``default``: PyTorch's settings."""
    import torch

    if precision == "default":
        return
    tf32 = precision == "high"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision(precision)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run evaluation protocols (PyTorch / CUDA)")
    add_common_args(p)
    p.add_argument("--evaluation_type", type=str, default="input_target_images",
                   choices=["input_target_images", "consistency", "gaze_transfer",
                            "personal_calibration"])
    p.add_argument("--subject", type=str, default=None,
                   help="one subject (default: every subject of the chosen split)")
    p.add_argument("--split", type=str, default="val",
                   help="the train_test_split.json key to sweep")
    p.add_argument("--img_dirs", type=str, default="",
                   help="comma-separated dataset dirs for a sweep over several datasets "
                        "(with --dataset_names); default: --img_dir")
    p.add_argument("--dataset_names", type=str, default="",
                   help="comma-separated dataset kinds for --img_dirs")
    p.add_argument("--calib_out_dir", type=str, default="",
                   help="personal_calibration: directory of the synthesized h5 files")
    p.add_argument("--num_fit_images", type=int, default=5,
                   help="personal_calibration: images fitted per subject (drawn per iteration)")
    p.add_argument("--num_iterations", type=int, default=1,
                   help="personal_calibration: rounds per subject")
    p.add_argument("--fit_steps", type=int, default=50)
    p.add_argument("--max_pairs", type=int, default=20)
    p.add_argument("--num_eval_images", type=int, default=200,
                   help="frames per subject of the consistency and personal-calibration "
                        "protocols")
    p.add_argument("--estimator_ckpt", type=str, default="",
                   help="ResNet-50 gaze estimator checkpoint (torch)")
    p.add_argument("--identity_embed_ckpt", type=str, default="",
                   help="MobileFaceNet checkpoint (FaceX-Zoo)")
    p.add_argument("--identity_detector_ckpt", type=str, default="",
                   help="RetinaFace checkpoint (FaceX-Zoo)")
    p.add_argument("--identity_aligner_ckpt", type=str, default="",
                   help="PFLD checkpoint (FaceX-Zoo)")
    p.add_argument("--lpips_lin_ckpt", type=str, default="", help="LPIPS linear-head weights")
    p.add_argument("--inception_ckpt", type=str, default="",
                   help="pytorch-fid InceptionV3 checkpoint (exact FID)")
    p.add_argument("--cam_dir", type=str, default="",
                   help="per-camera calibration dir (camNN.xml / CameraNN.mat)")
    p.add_argument("--eval_precision", type=str, default="highest",
                   choices=["default", "high", "highest"],
                   help="f32 arithmetic of the metric nets on the card: highest (no TF32), "
                        "high (TF32), default (PyTorch's settings)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    set_eval_precision(args.eval_precision)
    cfg = config_from_args(args)
    logging.basicConfig(level=logging.INFO)

    from gazenerf_tpu_torch.data.h5_dataset import BatchLoader, GazeH5Dataset
    from gazenerf_tpu_torch.eval import protocols as P
    from gazenerf_tpu_torch.train.checkpoint import load_checkpoint
    from gazenerf_tpu_torch.train.fitting import FitState
    from gazenerf_tpu_torch.train.trainer import Trainer
    from gazenerf_tpu_torch.utils.logging import log_subject_eval_results, maybe_wandb_init

    wandb = maybe_wandb_init(args.log, config=cfg.to_json())
    use_target = args.evaluation_type == "input_target_images"
    if args.img_dirs:
        dirs = [d for d in args.img_dirs.split(",") if d]
        kinds = ([k for k in args.dataset_names.split(",") if k] if args.dataset_names
                 else [cfg.data.dataset] * len(dirs))
        datasets = list(zip(kinds, dirs))
    else:
        datasets = [(cfg.data.dataset, cfg.data.img_dir)]

    trainer = Trainer(cfg, train_len=1, steps_per_epoch=1, device=args.device)
    if args.resume:
        load_checkpoint(args.resume, trainer)
    base = FitState.of(trainer)
    estimator_fn = build_estimator(args.estimator_ckpt, trainer.device)
    lpips_fn = build_lpips(args.vgg_ckpt, args.lpips_lin_ckpt, trainer.device)
    fid_feats_fn = build_fid_features(args.inception_ckpt, trainer.device)
    identity_pipeline, identity_valid = None, True
    if args.identity_embed_ckpt or args.identity_detector_ckpt or args.identity_aligner_ckpt:
        identity_pipeline = build_identity_pipeline(
            args.identity_embed_ckpt, args.identity_detector_ckpt, args.identity_aligner_ckpt,
            trainer.device)
        # without the embedder's weights the score means nothing: the
        # protocols leave it out and the result carries the flag
        identity_valid = bool(args.identity_embed_ckpt)

    def make_ctx(dataset_kind: str, subject: str) -> P.EvalContext:
        cam_lookup = None
        if args.cam_dir:
            from gazenerf_tpu_torch.data.cameras import load_camera_calibrations, make_cam_lookup

            cams = load_camera_calibrations(dataset_kind, args.cam_dir)
            cam_lookup = make_cam_lookup(dataset_kind, cams, subject=subject)
        return P.EvalContext.build(
            cfg, base, trainer.frozen, trainer.expr_fix, fit_steps=args.fit_steps,
            estimator_fn=estimator_fn, lpips_fn=lpips_fn, fid_feats_fn=fid_feats_fn,
            identity_pipeline=identity_pipeline, identity_valid=identity_valid,
            normalizer=P.make_eval_normalizer(), cam_lookup=cam_lookup,
        )

    def subject_batches(kind: str, ddir: str, subject: str):
        ds = GazeH5Dataset(ddir, subjects=[subject], dataset=kind, shuffle=False,
                           split=args.split, evaluate="target" if use_target else None)
        loader = BatchLoader(ds, 1, num_workers=1, skip_invalid=False)
        if use_target:
            limit = args.max_pairs
        elif args.evaluation_type in ("consistency", "personal_calibration"):
            limit = args.num_eval_images
        else:
            limit = 2 * args.max_pairs
        batches = []
        for i, b in enumerate(loader):
            if i >= limit:
                break
            batches.append(b)
        return batches

    def list_subjects(kind: str, ddir: str):
        if args.subject:
            return [args.subject]
        return GazeH5Dataset(ddir, dataset=kind, shuffle=False, split=args.split).subjects

    def mean_over(results):
        if not results:
            return {}
        keys = next(iter(results.values())).keys()
        return {k: float(np.mean([v[k] for v in results.values()])) for k in keys}

    per_dataset = {}
    for kind, ddir in datasets:
        subjects = list_subjects(kind, ddir)
        if args.evaluation_type == "input_target_images":
            subject_pairs, ctx = {}, None
            for s in subjects:
                ctx = make_ctx(kind, s)
                subject_pairs[s] = [P.split_target_batch(b)
                                    for b in subject_batches(kind, ddir, s)]
            res = P.evaluate_input_target_sweep(ctx, subject_pairs)
            if wandb is not None:
                for m in res["per_subject"].values():
                    log_subject_eval_results(wandb, m)
                log_subject_eval_results(wandb, res["overall"], prefix=f"{kind} ")
        elif args.evaluation_type == "consistency":
            per_subject = {}
            for s in subjects:
                batches = subject_batches(kind, ddir, s)
                if batches:
                    per_subject[s] = P.evaluate_consistency(make_ctx(kind, s), batches)
            res = {"per_subject": per_subject, "overall": mean_over(per_subject)}
        elif args.evaluation_type == "gaze_transfer":
            # each subject's gaze onto the next subject; one subject: between
            # two of its frames
            per_pair = {}
            pairings = (list(zip(subjects[:-1], subjects[1:])) if len(subjects) > 1
                        else [(subjects[0], subjects[0])])
            for src_s, tgt_s in pairings[: args.max_pairs]:
                src_b = subject_batches(kind, ddir, src_s)
                tgt_b = src_b if tgt_s == src_s else subject_batches(kind, ddir, tgt_s)
                if not src_b or not tgt_b:
                    continue
                tgt_batch = tgt_b[1] if tgt_s == src_s and len(tgt_b) > 1 else tgt_b[0]
                r = P.evaluate_gaze_transfer(make_ctx(kind, src_s), src_b[0], tgt_batch)
                per_pair[f"{src_s}->{tgt_s}"] = {
                    k: v for k, v in r.items() if not isinstance(v, np.ndarray)}
            overall = {}
            if per_pair:
                overall = {k: float(np.mean([v[k] for v in per_pair.values()]))
                           for k in ("opt_loss", "opt_steps")}
            res = {"per_pair": per_pair, "overall": overall}
        else:  # personal_calibration
            cal_rng = np.random.default_rng(cfg.train.seed)
            per_subject = {}
            for s in subjects:
                batches = subject_batches(kind, ddir, s)
                if batches:
                    per_subject[s] = P.evaluate_personal_calibration_sweep(
                        make_ctx(kind, s), batches, num_fit_images=args.num_fit_images,
                        num_iterations=args.num_iterations, rng=cal_rng,
                        out_dir=args.calib_out_dir or None, subject=s)
            res = {"per_subject": per_subject}
        if identity_pipeline is not None:
            res["identity_similarity_valid"] = identity_valid
        per_dataset[kind] = res

    if wandb is not None and len(per_dataset) > 1 and use_target:
        # the cross-dataset panel: pair-count-weighted means of every
        # dataset's overall
        overalls = [r["overall"] for r in per_dataset.values() if r.get("overall")]
        keys = {k for o in overalls for k in o
                if isinstance(o[k], (int, float)) and k != "num_pairs"}
        n = [o.get("num_pairs", 1) for o in overalls]
        full = {k: float(np.average([o[k] for o in overalls if k in o],
                                    weights=[w for o, w in zip(overalls, n) if k in o]))
                for k in keys}
        log_subject_eval_results(wandb, full, prefix=" FULL ")

    result = per_dataset if len(per_dataset) > 1 else next(iter(per_dataset.values()))
    print(json.dumps(result, indent=2, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
