"""``python -m gazenerf_tpu_torch.cli.preprocess`` -- the offline data
factory's command line, the port of the JAX package's ``cli/preprocess.py``
(upstream ``dataset_pre_processing.py``): the raw frames of one subject,
normalized, with landmarks, masks and the NL-3DMM fit, into the training
h5.  The same flags as the JAX CLI, and ``--device`` (``cuda``, the
default, or ``cpu``): the frames' decoding and image work and the fit run
there.  Frames are read as ``cv2.imread`` reads them
(``preprocess/driver.read_frame``: baseline JPEG, PNG, BMP).  Writing the
h5 needs h5py.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

import numpy as np

from gazenerf_tpu_torch.cli.common import str2bool

logger = logging.getLogger(__name__)

# a generic 6-point 3D face model (4 eye corners, 2 mouth corners), in mm
# like upstream's, for when no face_model.txt is given
DEFAULT_FACE_MODEL = np.array(
    [
        [-45.0, -30.0, 30.0],
        [-15.0, -30.0, 35.0],
        [15.0, -30.0, 35.0],
        [45.0, -30.0, 30.0],
        [-25.0, 30.0, 30.0],
        [25.0, 30.0, 30.0],
    ],
    np.float64,
)


def _build_fitter(args, device):
    """The NL-3DMM fitter from the basis and decoder flags (the fit and the
    ``--qa_from_h5`` paths share it)."""
    from gazenerf_tpu_torch.nl3dmm.face_model import load_basis, load_basis_pkl, random_basis
    from gazenerf_tpu_torch.nl3dmm.fitting import FitConfig, NL3DMMFitter
    from gazenerf_tpu_torch.nl3dmm.rasterizer import RasterSettings

    if args.basis_pkl:
        basis = load_basis_pkl(args.basis_pkl, topo_npz_path=args.topo_npz or None,
                               landmark_pkl_path=args.landmark_pkl or None,
                               skinmask_npy_path=args.skinmask_npy or None)
    elif args.basis_npz:
        basis = load_basis(args.basis_npz)
    else:
        basis = random_basis()
        logger.warning("no --basis_npz/--basis_pkl given; fitting against a synthetic basis "
                       "(codes structurally valid, not meaningful)")
    decoder_params = None
    if args.decoder_ckpt:
        import torch

        from gazenerf_tpu_torch.nl3dmm.face_model import geometry_decoder_params_from_torch

        sd = torch.load(args.decoder_ckpt, map_location="cpu")
        sd = sd.get("net", sd) if isinstance(sd, dict) else sd
        decoder_params = geometry_decoder_params_from_torch(sd)
    return NL3DMMFitter(basis, FitConfig(image_size=args.fit_image_size),
                        RasterSettings(image_size=args.fit_image_size),
                        decoder_params=decoder_params, device=device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Preprocess raw frames -> training h5")
    p.add_argument("--frames_dir", type=str, default="",
                   help="flat layout: directory of raw frames (png/jpg); "
                        "xgaze layout: the subject directory of frameNNNN "
                        "folders")
    p.add_argument("--out", type=str, default="", help="output h5 path")
    p.add_argument("--dataset", type=str, default="eth_xgaze")
    p.add_argument("--layout", type=str, default="flat",
                   choices=["flat", "xgaze", "mpii", "columbia", "gazecapture"],
                   help="raw-data layout (upstream per-dataset iterations, "
                        "dataset_pre_processing.py:80/468/816/1083): "
                        "'xgaze' = frameNNNN/*camCC.JPG dirs + per-subject "
                        "CSV + per-camera xml calibration; 'mpii' = dayNN "
                        "dirs + pNN.txt + Calibration/Camera.mat; "
                        "'columbia' = flat NNNN_2m_PP_VV_HH.jpg frames + one "
                        "cam00.xml; 'gazecapture' = flat frames + per-frame "
                        "annotation arrays (--annotation_npz); 'flat' = one "
                        "folder of frames, one synthetic camera")
    p.add_argument("--annotation_csv", type=str, default="",
                   help="xgaze layout: subjectNNNN.csv with gaze + head pose")
    p.add_argument("--annotation_npz", type=str, default="",
                   help="gazecapture layout: npz/h5 with camera_parameters, "
                        "distortion_parameters, head_pose, 3d_gaze_target")
    p.add_argument("--face_model_3d_npy", type=str, default="",
                   help="gazecapture layout: 3D face-model coordinates npy "
                        "(face-center anchor, upstream data_process.py:389)")
    p.add_argument("--cam_calib_dir", type=str, default="",
                   help="xgaze/columbia layouts: camera xml calibration dir")
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--focal", type=float, default=1200.0,
                   help="flat layout: raw-camera focal length (px)")
    p.add_argument("--face_model", type=str, default="",
                   help="path to a 6-point 3D face model txt")
    p.add_argument("--basis_npz", type=str, default="",
                   help="NL-3DMM basis npz; omitted -> skip 3DMM fitting")
    p.add_argument("--basis_pkl", type=str, default="",
                   help="upstream nl3dmm_dict.pkl (alternative to npz)")
    p.add_argument("--topo_npz", type=str, default="",
                   help="upstream nl_3dmm_topo_info.npz (with --basis_pkl)")
    p.add_argument("--landmark_pkl", type=str, default="",
                   help="upstream LandMarkInfo.pkl (with --basis_pkl)")
    p.add_argument("--skinmask_npy", type=str, default="",
                   help="upstream skinmask.npy (with --basis_pkl)")
    p.add_argument("--decoder_ckpt", type=str, default="",
                   help="torch nl3dmm_net_dict.pth for the geometry decoder")
    p.add_argument("--fit_image_size", type=int, default=128)
    p.add_argument("--fit", type=str2bool, default=True)
    p.add_argument("--qa_render_dir", type=str, default="",
                   help="write fitted-mesh QA renders here (upstream "
                        "gen_nl3dmm_render_res.py)")
    p.add_argument("--qa_from_h5", type=str, default="",
                   help="standalone QA: re-render the SAVED fits of this "
                        "preprocessed subject h5 into --qa_render_dir "
                        "(upstream gen_nl3dmm_render_res.py:18-205 renders "
                        "from saved fit artifacts, no re-fitting)")
    p.add_argument("--qa_limit", type=int, default=0,
                   help="max frames for --qa_from_h5 (0 = all)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from gazenerf_tpu_torch.models.gaze_nerf import resolve_device

    device = resolve_device(None if args.device == "cuda" else args.device)

    if args.qa_from_h5:
        if not args.qa_render_dir:
            logger.error("--qa_from_h5 requires --qa_render_dir")
            return 1
        from gazenerf_tpu_torch.preprocess.driver import qa_renders_from_h5

        paths = qa_renders_from_h5(_build_fitter(args, device), args.qa_from_h5,
                                   args.qa_render_dir, limit=args.qa_limit or None)
        logger.info("QA done: %d panels -> %s", len(paths), args.qa_render_dir)
        return 0
    if not args.frames_dir or not args.out:
        logger.error("--frames_dir and --out are required (or use --qa_from_h5)")
        return 1

    from gazenerf_tpu_torch.data.cameras import load_camera_calibrations
    from gazenerf_tpu_torch.preprocess import enumerate as layouts

    records = None
    if args.layout == "xgaze":
        if not args.cam_calib_dir:
            logger.error("--layout xgaze requires --cam_calib_dir")
            return 1
        cams = load_camera_calibrations("eth_xgaze", args.cam_calib_dir)
        records = layouts.iter_xgaze_subject(args.frames_dir, args.annotation_csv, cams)
    elif args.layout == "mpii":
        records = layouts.iter_mpii_subject(args.frames_dir)
    elif args.layout == "columbia":
        cK, cd = load_camera_calibrations("columbia", args.cam_calib_dir)
        records = layouts.iter_columbia_subject(args.frames_dir, cK, cd)
    elif args.layout == "gazecapture":
        if args.annotation_npz.endswith(".npz"):
            anno = dict(np.load(args.annotation_npz))
        else:
            import h5py

            with h5py.File(args.annotation_npz) as f:
                anno = {k: np.asarray(f[k]) for k in f}
        records = layouts.iter_gazecapture_subject(args.frames_dir, anno,
                                                   np.load(args.face_model_3d_npy))
    if records is not None:
        if not records:
            logger.error("no frames enumerated under %s", args.frames_dir)
            return 1
    else:
        frames = sorted(glob.glob(os.path.join(args.frames_dir, "*.png"))
                        + glob.glob(os.path.join(args.frames_dir, "*.jpg")))
        if not frames:
            logger.error("no frames in %s", args.frames_dir)
            return 1
        from gazenerf_tpu_torch.preprocess.driver import read_frame

        probe = read_frame(frames[0], device)
        if probe is None:
            logger.error("unreadable frame %s", frames[0])
            return 1
        h, w = probe.shape[:2]
        K = np.array([[args.focal, 0, w / 2], [0, args.focal, h / 2], [0, 0, 1]], np.float64)
    face_model = np.loadtxt(args.face_model) if args.face_model else DEFAULT_FACE_MODEL
    fitter = _build_fitter(args, device) if args.fit else None

    from gazenerf_tpu_torch.preprocess import driver

    if records is not None:
        out = driver.process_subject_records(
            records, args.out, face_model, fitter=fitter, img_size=args.img_size,
            dataset=args.dataset, qa_dir=args.qa_render_dir or None, device=device)
    else:
        out = driver.process_subject(
            frames, args.out, K, face_model, fitter=fitter, img_size=args.img_size,
            dataset=args.dataset, qa_dir=args.qa_render_dir or None, device=device)
    logger.info("done -> %s", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
