"""The offline data factory's driver: raw frames -> one training h5 per
subject, the port of the JAX package's ``preprocess/driver.py`` (upstream
``dataset_pre_processing.py``).  Per frame: the raw-image fixes
(undistortion, the upside-down cameras' 180-degree turn, Columbia's crop),
landmarks, the head pose, the warp to the virtual camera, masks, the gaze in
head coordinates (:func:`process_frame`); per subject: the NL-3DMM fit of
all its frames as one batch, the identity code averaged over the first
three, and the rows written in the schema the trainer reads
(:func:`process_subject_records`).

The JAX package calls OpenCV for the image work; the port runs its own
counterparts (``preprocess/normalize.py``: ``undistort``, ``warp_affine``
with ``rotation_matrix_2d``, ``resize_area_u8``, ``resize_linear_u8``,
``normalize_face``) on the given device, reads frames with
:func:`read_frame` (baseline JPEG through ``kernels/jpeg.decode_jpeg``, on
the card by default; PNG and BMP on the host) and writes PNGs with
``utils/png.encode_png``.  h5py is imported where it is installed;
:class:`SubjectWriter` and :func:`qa_renders_from_h5` need it.
"""

from __future__ import annotations

import logging
import os
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from gazenerf_tpu_torch.models.gaze_nerf import resolve_device
from gazenerf_tpu_torch.preprocess.landmarks import LandmarkDetector
from gazenerf_tpu_torch.preprocess.masks import landmark_masks
from gazenerf_tpu_torch.preprocess.normalize import (
    NORMALIZATION_PRESETS,
    estimate_head_pose,
    gaze_to_head_coordinates,
    normalize_face,
    normalized_head_pose,
    resize_area_u8,
    resize_linear_u8,
    rodrigues,
    rotation_matrix_2d,
    undistort as undistort_image,
    vector_to_pitchyaw,
    warp_affine,
)
from gazenerf_tpu_torch.kernels.jpeg import decode_jpeg
from gazenerf_tpu_torch.utils.bmp import decode_bmp
from gazenerf_tpu_torch.utils.png import decode_png, encode_png

try:
    import h5py
except ImportError:  # the module imports without it; writing raises
    h5py = None

logger = logging.getLogger(__name__)

# the 6-point face model's rows (4 eye corners, 2 mouth corners) as iBUG-68
# indices
FACE_MODEL_LM68 = [36, 39, 42, 45, 48, 54]


def read_frame(path: str, device=None) -> Optional[np.ndarray]:
    """``cv2.imread(path)``: BGR uint8 ``[H, W, 3]`` on the host (grey
    replicated, alpha dropped, a JPEG's EXIF orientation applied), or None
    where the file is missing, corrupt or cut inside its headers.  JPEG goes
    through ``decode_jpeg`` on ``device`` (the card unless told otherwise),
    PNG through ``decode_png`` and BMP through ``decode_bmp``.  What those do
    not read (progressive, 12-bit, CMYK JPEG; 16-bit, palette, interlaced
    PNG; RLE or bit-field BMP), and any other format, raises
    ``NotImplementedError`` naming the file."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".jpg", ".jpeg", ".png", ".bmp"):
        raise NotImplementedError(f"{path}: only JPEG, PNG and BMP frames can be read")
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    try:
        if ext in (".jpg", ".jpeg"):
            img = decode_jpeg(data, device)
            return None if img is None else img.cpu().numpy()
        if ext == ".bmp":
            return decode_bmp(data)
        try:
            img = decode_png(data)
        except (ValueError, zlib.error):
            return None
    except NotImplementedError as e:
        raise NotImplementedError(f"{path}: {e}") from None
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., 2::-1])


class SubjectWriter:
    """Appends schema rows to one per-subject h5 file (needs h5py)."""

    def __init__(self, path: str, img_size: int = 512):
        from gazenerf_tpu_torch.data.synthetic import SCHEMA

        if h5py is None:
            raise ImportError("the subject writer needs h5py, which is not installed")
        self.img_size = img_size
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.f = h5py.File(path, "w")
        for key, (shape, dtype) in SCHEMA.items():
            if key == "face_patch":
                shape = (img_size, img_size, 3)
            elif key in ("head_mask", "left_eye_mask", "right_eye_mask"):
                shape = (img_size, img_size)
            self.f.create_dataset(key, (0,) + shape, maxshape=(None,) + shape, dtype=dtype,
                                  chunks=(1,) + shape)

    def append(self, row: Dict[str, np.ndarray]):
        n = self.f["face_patch"].shape[0]
        for key, ds in self.f.items():
            ds.resize(n + 1, axis=0)
            ds[n] = row[key]

    def close(self):
        self.f.close()


def process_frame(
    img_bgr: np.ndarray,
    camera_matrix: np.ndarray,
    face_model_3d: np.ndarray,
    landmark_detector: LandmarkDetector,
    masker=None,
    eye_masker=None,
    gaze_vector: Optional[np.ndarray] = None,
    cam_index: int = 0,
    img_size: int = 512,
    dataset: str = "eth_xgaze",
    dist_coeffs: Optional[np.ndarray] = None,
    head_pose: Optional[tuple] = None,
    undistort: bool = False,
    rotate180: bool = False,
    face_center: Optional[np.ndarray] = None,
    columbia_crop: bool = False,
    pitchyaw_head_direct: Optional[np.ndarray] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """One raw BGR uint8 frame -> one h5 row (the fitted code and cameras
    left at their defaults).  ``head_pose``: the annotated ``(rvec, tvec)``
    (ETH-XGaze's CSV), else estimated from the landmarks; ``undistort``,
    ``rotate180``, ``columbia_crop``: the raw-image fixes.  The image work
    runs on ``device`` (the card unless told otherwise); ``masker`` and
    ``eye_masker`` (BiSeNet, then the U-Net for missing eyes, then the
    landmark rectangles) on theirs."""
    dev = resolve_device(device)
    focal, dist = NORMALIZATION_PRESETS.get(dataset, (1600.0, 680.0))
    img = torch.as_tensor(np.ascontiguousarray(img_bgr), device=dev)
    if undistort and dist_coeffs is not None:
        img = undistort_image(img, camera_matrix, dist_coeffs)
    if rotate180:
        h, w = img.shape[:2]
        img = warp_affine(img, rotation_matrix_2d((w / 2, h / 2), 180, 1.0), (w, h))
    if columbia_crop:
        # Columbia raws: centre crop and an INTER_AREA resize to 512^2 first
        if img.shape[1] > 4320:
            img = img[:, 864:4320].contiguous()
        img = resize_area_u8(img, (512, 512))

    lm_full = landmark_detector(img.flip(-1).cpu().numpy())
    if head_pose is not None:
        rvec = np.asarray(head_pose[0], np.float64).reshape(3, 1)
        tvec = np.asarray(head_pose[1], np.float64).reshape(3, 1)
    else:
        rvec, tvec = estimate_head_pose(lm_full[FACE_MODEL_LM68], face_model_3d, camera_matrix,
                                        dist_coeffs)
    warped, R_norm, W = normalize_face(img, face_model_3d, rvec, tvec, camera_matrix,
                                       img_dim=img_size, focal_norm=focal, distance_norm=dist,
                                       face_center=face_center)
    warped = warped.cpu().numpy()

    # landmarks in the normalized image: detected again, or without a
    # detector the raw frame's carried through the warp's homography
    lm_norm = landmark_detector(np.ascontiguousarray(warped[..., ::-1]))
    if not landmark_detector.available:
        proj = (W @ np.concatenate([lm_full, np.ones((68, 1))], axis=1).T).T
        lm_norm = (proj[:, :2] / proj[:, 2:]).astype(np.float32)

    if masker is not None and masker.available:
        head, left, right = masker(warped.astype(np.float32) / 255.0, cam_index)
        # the U-Net where BiSeNet finds no eye pixels (the half-profile
        # cameras have one side legitimately empty)
        want_left = cam_index not in (14, 15)
        want_right = cam_index not in (11, 12)
        missing_left = want_left and not left.any()
        missing_right = want_right and not right.any()
        if (missing_left or missing_right) and eye_masker is not None and eye_masker.available:
            u_left, u_right = eye_masker(warped.astype(np.float32) / 255.0)
            if missing_left:
                left = u_left
            if missing_right:
                right = u_right
            missing_left = want_left and not left.any()
            missing_right = want_right and not right.any()
        if missing_left or missing_right:  # the landmark rectangles last
            _, lm_left, lm_right = landmark_masks(lm_norm, img_size, cam_index)
            if missing_left:
                left = lm_left
            if missing_right:
                right = lm_right
    else:
        head, left, right = landmark_masks(lm_norm, img_size, cam_index)

    hR = rodrigues(rvec)
    face_head_pose = normalized_head_pose(R_norm, hR)
    if pitchyaw_head_direct is not None:  # Columbia: the label is the head-frame gaze
        pitchyaw_head = np.asarray(pitchyaw_head_direct, np.float32)
    elif gaze_vector is not None:
        g_norm = R_norm @ np.asarray(gaze_vector, np.float64).reshape(3)
        pitchyaw_head = gaze_to_head_coordinates(vector_to_pitchyaw(g_norm), R_norm @ hR)
    else:
        pitchyaw_head = np.zeros(2, np.float32)

    inmat = np.array([[focal, 0, img_size / 2], [0, focal, img_size / 2], [0, 0, 1]], np.float32)
    return {
        "face_patch": warped.astype(np.uint8),  # BGR, as upstream stores it
        "head_mask": head,
        "left_eye_mask": left,
        "right_eye_mask": right,
        "facial_landmarks": lm_norm.astype(np.float64),
        "cam_index": np.array([cam_index], np.int64),
        "pitchyaw_head": pitchyaw_head.astype(np.float32),
        "face_head_pose": face_head_pose.astype(np.float32),
        "inmat": inmat,
        "inv_inmat": np.linalg.inv(inmat).astype(np.float32),
        # the cameras and the latent code come from the NL-3DMM fit
        "w2c_Rmat": np.eye(3, dtype=np.float32),
        "w2c_Tvec": np.zeros(3, np.float32),
        "c2w_Rmat": np.eye(3, dtype=np.float32),
        "c2w_Tvec": np.zeros(3, np.float32),
        "latent_codes": np.zeros(306, np.float32),
    }


def _fit_images(patches, size: int) -> np.ndarray:
    """BGR uint8 face patches -> ``[B, size, size, 3]`` RGB f32 in [0, 1]
    (``cv2.resize``'s INTER_LINEAR)."""
    small = [resize_linear_u8(torch.as_tensor(np.ascontiguousarray(p)), (size, size)).numpy()
             for p in patches]
    return np.stack(small).astype(np.float32)[..., ::-1] / 255.0


def process_subject_records(records, out_path: str, face_model_3d: np.ndarray, fitter=None,
                            img_size: int = 512, dataset: str = "eth_xgaze",
                            qa_dir: Optional[str] = None, device=None) -> str:
    """Enumerated :class:`~gazenerf_tpu_torch.preprocess.enumerate.FrameRecord`
    rows -> one per-subject h5 at ``out_path``; with ``fitter`` the NL-3DMM
    fit of all the subject's frames as one batch (from the base camera at
    ``(0, 0, 12)``, the intrinsics scaled to the fit's size), its identity,
    expression and texture codes averaged over the first three frames.
    ``qa_dir``: write the fitted meshes beside the frames there.  Frames are
    processed on ``device`` (the card unless told otherwise)."""
    dev = resolve_device(device)
    det = LandmarkDetector(device=str(dev))
    writer = SubjectWriter(out_path, img_size)
    rows = []
    for rec in records:
        img = read_frame(rec.image_path, dev)
        if img is None:
            logger.warning("unreadable frame %s; skipping", rec.image_path)
            continue
        rows.append(process_frame(
            img, rec.camera_matrix, face_model_3d, det, cam_index=rec.cam_index,
            img_size=img_size, dataset=dataset, dist_coeffs=rec.distortion,
            gaze_vector=rec.gaze_3d, head_pose=(rec.hr, rec.ht) if rec.hr is not None else None,
            undistort=rec.distortion is not None and np.any(rec.distortion),
            rotate180=rec.rotate180, face_center=rec.face_center,
            columbia_crop=rec.columbia_crop, pitchyaw_head_direct=rec.pitchyaw_head_direct,
            device=dev))

    if fitter is not None and rows:
        size = fitter.cfg.image_size
        images = _fit_images([r["face_patch"] for r in rows], size)
        scale = size / img_size
        lms = np.stack([r["facial_landmarks"] for r in rows]).astype(np.float32) * scale
        B = len(rows)
        base_R = np.tile(np.diag([1.0, -1.0, -1.0]).astype(np.float32), (B, 1, 1))
        base_T = np.tile(np.array([0, 0, 12.0], np.float32), (B, 1))
        inmat_fit = np.stack([r["inmat"] for r in rows]) * scale
        inmat_fit[:, 2, 2] = 1.0
        res = fitter.fit(images, lms, base_R, base_T, inmat_fit)
        code = np.array(res["code"], copy=True)
        code[:, :279] = code[: min(3, B), :279].mean(axis=0, keepdims=True)
        for i, r in enumerate(rows):
            r["latent_codes"] = code[i]
            for key in ("w2c_Rmat", "w2c_Tvec", "c2w_Rmat", "c2w_Tvec"):
                r[key] = res[key][i]
        if qa_dir:
            write_fit_qa_renders(fitter, res, images, qa_dir)

    for r in rows:
        writer.append(r)
    writer.close()
    logger.info("wrote %d frames -> %s", len(rows), out_path)
    return out_path


def write_fit_qa_renders(fitter, res, images: np.ndarray, qa_dir: str,
                         prefix: str = "fit_qa") -> List[str]:
    """Per frame a PNG panel: the frame | the fitted mesh over it (where the
    render's alpha exceeds 0.5) | the mesh alone.  ``images``: ``[B, H, W,
    3]`` RGB in [0, 1] at the fitter's size."""
    from gazenerf_tpu_torch.utils.logging import side_by_side

    os.makedirs(qa_dir, exist_ok=True)
    qa_imgs, alpha, _ = fitter.render_fit(res)
    paths = []
    for i in range(qa_imgs.shape[0]):
        ori = np.clip(np.asarray(images[i]), 0.0, 1.0)
        composite = np.where(alpha[i][..., None] > 0.5, qa_imgs[i], ori)
        p = os.path.join(qa_dir, "%s_%04d.png" % (prefix, i))
        with open(p, "wb") as f:
            f.write(encode_png(side_by_side(ori, composite, qa_imgs[i])))
        paths.append(p)
    logger.info("fit QA renders -> %s (%d panels)", qa_dir, len(paths))
    return paths


def qa_renders_from_h5(fitter, h5_path: str, qa_dir: str,
                       limit: Optional[int] = None) -> List[str]:
    """The QA panels of the fits saved in a preprocessed subject h5 (codes
    and fitted cameras, over the stored frames), without fitting again
    (needs h5py)."""
    if h5py is None:
        raise ImportError("reading a subject h5 needs h5py, which is not installed")
    with h5py.File(h5_path, "r") as f:
        n = f["face_patch"].shape[0]
        if limit is not None:
            n = min(n, limit)
        s = fitter.cfg.image_size / f["face_patch"].shape[1]
        imgs = _fit_images([f["face_patch"][i] for i in range(n)], fitter.cfg.image_size)
        inmat = np.asarray(f["inmat"][:n], np.float32) * s
        inmat[:, 2, 2] = 1.0
        res = {
            "code": np.asarray(f["latent_codes"][:n], np.float32),
            "w2c_Rmat": np.asarray(f["w2c_Rmat"][:n], np.float32),
            "w2c_Tvec": np.asarray(f["w2c_Tvec"][:n], np.float32).reshape(n, 3),
            "inmat": inmat,
        }
    return write_fit_qa_renders(fitter, res, imgs, qa_dir)


def process_subject(frame_paths: List[str], out_path: str, camera_matrix: np.ndarray,
                    face_model_3d: np.ndarray, fitter=None, img_size: int = 512,
                    dataset: str = "eth_xgaze", qa_dir: Optional[str] = None,
                    device=None) -> str:
    """A flat list of frames from one camera with no annotations (Columbia-
    or GazeCapture-style single-camera folders) -> one subject h5; for the
    real layouts see ``preprocess/enumerate.py`` and
    :func:`process_subject_records`."""
    from gazenerf_tpu_torch.preprocess.enumerate import FrameRecord

    records = [FrameRecord(image_path=p, frame_name=os.path.splitext(os.path.basename(p))[0],
                           cam_index=0, camera_matrix=np.asarray(camera_matrix, np.float64),
                           distortion=np.zeros((5, 1)))
               for p in frame_paths]
    return process_subject_records(records, out_path, face_model_3d, fitter=fitter,
                                   img_size=img_size, dataset=dataset, qa_dir=qa_dir,
                                   device=device)
