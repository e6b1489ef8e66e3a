"""Raw-dataset layouts for the offline data factory, the port of the JAX
package's ``preprocess/enumerate.py``: upstream's per-dataset enumeration
(``dataset_pre_processing.py:80-445``, ``pre_processing/data_process.py:
107-192``) into :class:`FrameRecord` rows.  The layouts only list files;
``preprocess/driver.read_frame`` reads them (JPEG, PNG, BMP).

ETH-XGaze layout::

    <subject_dir>/frameNNNN/*camCC.JPG      (CC = camera id, 18 cameras)
    <annotation_dir>/subjectNNNN.csv        (per image: pitchyaw label cols
                                             2-3, 3D gaze cols 4-6, head pose
                                             rvec cols 7-9, tvec cols 10-12)
    <calib_dir>/camCC.xml                   (K, distortion per camera)

Per image upstream undistorts with the camera's calibration, rotates
cameras 03/06/13 by 180 degrees (they are mounted upside-down,
data_process.py:163-168), and face-normalizes with the CSV head pose (no
solvePnP — the annotations carry the pose).
"""

from __future__ import annotations

import csv
import dataclasses
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# cameras physically mounted upside-down (upstream data_process.py:163)
ROTATED_CAMS = (3, 6, 13)

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


@dataclasses.dataclass
class FrameRecord:
    """One raw image + everything the per-frame pipeline needs."""

    image_path: str
    frame_name: str
    cam_index: int
    camera_matrix: np.ndarray  # [3,3]
    distortion: np.ndarray  # [N,1]
    hr: Optional[np.ndarray] = None  # [3,1] head rotation rvec (CSV)
    ht: Optional[np.ndarray] = None  # [3,1] head translation (CSV)
    gaze_3d: Optional[np.ndarray] = None  # [3] gaze direction (camera coords)
    pitchyaw: Optional[np.ndarray] = None  # [2] normalized-space gaze label
    rotate180: bool = False
    # MPII: annotated face center anchors the virtual-camera distance
    # (upstream data_process.py:271-277 passes fc to normalizeData_face)
    face_center: Optional[np.ndarray] = None
    # Columbia raw frames are center-cropped [:, 864:4320] and resized to
    # 512^2 before everything else (upstream data_process.py:336-338)
    columbia_crop: bool = False
    # Columbia: pitchyaw_head comes straight from the filename's (P,V,H)
    # degrees ([-v, p-h] in radians — upstream dataset_pre_processing.py:47),
    # not from a 3D gaze vector
    pitchyaw_head_direct: Optional[np.ndarray] = None


def load_xgaze_annotations(csv_path: str) -> Dict[Tuple[str, str], List[str]]:
    """subjectNNNN.csv -> {(frame_name, image_name): row} (upstream
    looks rows up by exactly this pair — data_process.py:149-186)."""
    out: Dict[Tuple[str, str], List[str]] = {}
    with open(csv_path) as f:
        for row in csv.reader(f):
            if len(row) >= 13:
                out[(row[0], row[1])] = row
    return out


def iter_xgaze_subject(
    subject_dir: str,
    annotation_csv: str,
    cams: List[Tuple[np.ndarray, np.ndarray]],
) -> List[FrameRecord]:
    """Enumerate an ETH-XGaze raw subject directory into FrameRecords.

    ``cams``: the 18 (K, distortion) pairs from
    :func:`gazenerf_tpu_torch.data.cameras.load_camera_calibrations`.
    Frames with no annotation row are skipped with a warning (upstream
    wraps each frame in try/except-continue, dataset_pre_processing.py:159).
    """
    anno = load_xgaze_annotations(annotation_csv) if annotation_csv else {}
    records: List[FrameRecord] = []
    frames = sorted(
        d for d in os.listdir(subject_dir)
        if os.path.isdir(os.path.join(subject_dir, d))
    )
    for frame_name in frames:
        fdir = os.path.join(subject_dir, frame_name)
        for image_name in sorted(os.listdir(fdir)):
            stem, ext = os.path.splitext(image_name)
            if ext.lower() not in _IMG_EXTS or stem.endswith("_resized"):
                continue
            # camera id = last two characters of the stem ("...cam07")
            try:
                cam_index = int(stem[-2:])
            except ValueError:
                logger.warning("unparseable camera id in %s; skipped", image_name)
                continue
            if cam_index >= len(cams):
                logger.warning("camera id %d out of range; skipped", cam_index)
                continue
            K, dist = cams[cam_index]
            rec = FrameRecord(
                image_path=os.path.join(fdir, image_name),
                frame_name=frame_name,
                cam_index=cam_index,
                camera_matrix=np.asarray(K, np.float64),
                distortion=np.asarray(dist, np.float64),
                rotate180=cam_index in ROTATED_CAMS,
            )
            row = anno.get((frame_name, image_name))
            if row is not None:
                rec.pitchyaw = np.asarray(row[2:4], np.float32)
                rec.gaze_3d = np.asarray(row[4:7], np.float64)
                rec.hr = np.asarray(row[7:10], np.float64).reshape(3, 1)
                rec.ht = np.asarray(row[10:13], np.float64).reshape(3, 1)
            elif anno:
                logger.warning(
                    "no annotation for (%s, %s); head pose will come from "
                    "solvePnP on detected landmarks", frame_name, image_name,
                )
            records.append(rec)
    return records


def iter_mpii_subject(subject_dir: str) -> List[FrameRecord]:
    """MPIIFaceGaze raw layout (upstream dataset_pre_processing.py:468-560 +
    pre_processing/data_process.py:194-283)::

        <subject_dir>/dayNN/*.jpg
        <subject_dir>/pNN.txt              (space-delimited; col 0 =
                                            "dayNN/img.jpg", head pose rvec
                                            cols 15-17, tvec 18-20, face
                                            center 21-23, 3D gaze 24-26)
        <subject_dir>/Calibration/Camera.mat  (cameraMatrix, distCoeffs)
    """
    import scipy.io

    subj = os.path.basename(os.path.normpath(subject_dir))
    mat = scipy.io.loadmat(os.path.join(subject_dir, "Calibration", "Camera.mat"))
    K = np.asarray(mat["cameraMatrix"], np.float64)
    dist = np.asarray(mat["distCoeffs"], np.float64)

    anno: Dict[str, List[str]] = {}
    label_path = os.path.join(subject_dir, subj + ".txt")
    if os.path.exists(label_path):
        with open(label_path) as f:
            for row in csv.reader(f, delimiter=" "):
                if row:
                    anno[row[0]] = row

    records: List[FrameRecord] = []
    days = sorted(
        d for d in os.listdir(subject_dir)
        if d.startswith("day") and os.path.isdir(os.path.join(subject_dir, d))
    )
    for day in days:
        fdir = os.path.join(subject_dir, day)
        for image_name in sorted(os.listdir(fdir)):
            if os.path.splitext(image_name)[1].lower() not in _IMG_EXTS:
                continue
            rec = FrameRecord(
                image_path=os.path.join(fdir, image_name),
                frame_name=day,
                cam_index=0,
                camera_matrix=K,
                distortion=dist,
            )
            row = anno.get(day + "/" + image_name)
            if row is not None and len(row) >= 27:
                rec.hr = np.asarray(row[15:18], np.float64).reshape(3, 1)
                rec.ht = np.asarray(row[18:21], np.float64).reshape(3, 1)
                rec.face_center = np.asarray(row[21:24], np.float64).reshape(3, 1)
                rec.gaze_3d = np.asarray(row[24:27], np.float64)
            records.append(rec)
    return records


def iter_columbia_subject(
    subject_dir: str,
    camera_matrix: np.ndarray,
    distortion: Optional[np.ndarray] = None,
) -> List[FrameRecord]:
    """Columbia raw layout (upstream dataset_pre_processing.py:816-1082 +
    pre_processing/data_process.py:285-354): one flat folder of
    ``NNNN_2m_PP_VV_HH.jpg`` frames; the gaze label is decoded from the
    filename — pitchyaw_head = [-V deg, (P-H) deg] in radians (upstream
    ``calculate_gaze_direction``, dataset_pre_processing.py:47) — and the
    head pose comes from solvePnP on detected landmarks (no annotations).
    """
    records: List[FrameRecord] = []
    for name in sorted(os.listdir(subject_dir)):
        stem, ext = os.path.splitext(name)
        if ext.lower() not in _IMG_EXTS or stem.endswith("_resized"):
            continue
        parts = stem.split("_")
        try:
            p = float(parts[2][:-1])
            v = float(parts[3][:-1])
            h = float(parts[4][:-1])
        except (IndexError, ValueError):
            logger.warning("unparseable columbia name %s; skipped", name)
            continue
        records.append(
            FrameRecord(
                image_path=os.path.join(subject_dir, name),
                frame_name=stem,
                cam_index=0,
                camera_matrix=np.asarray(camera_matrix, np.float64),
                distortion=(
                    np.zeros((5, 1)) if distortion is None
                    else np.asarray(distortion, np.float64)
                ),
                columbia_crop=True,
                pitchyaw_head_direct=np.array(
                    [-v * np.pi / 180.0, (p - h) * np.pi / 180.0], np.float32
                ),
            )
        )
    return records


def iter_gazecapture_subject(
    subject_dir: str,
    annotations: Dict[str, np.ndarray],
    face_model_3d_coords: np.ndarray,
) -> List[FrameRecord]:
    """GazeCapture raw layout (upstream dataset_pre_processing.py:1083-1352 +
    pre_processing/data_process.py:356-405): one flat folder of frames plus
    per-frame annotation arrays — ``camera_parameters [N,4]`` (fx,fy,cx,cy),
    ``distortion_parameters [N,*]``, ``head_pose [N,6]`` (rvec ++ tvec),
    ``3d_gaze_target [N,3]``.  The gaze vector is ``g_t - fc`` with the face
    center from the posed 3D face model's eye-corner rows 10:12 (upstream
    data_process.py:385-393).
    """
    from gazenerf_tpu_torch.preprocess.normalize import rodrigues

    records: List[FrameRecord] = []
    names = sorted(
        n for n in os.listdir(subject_dir)
        if os.path.splitext(n)[1].lower() in _IMG_EXTS
    )
    for idx, name in enumerate(names):
        fx, fy, cx, cy = np.asarray(
            annotations["camera_parameters"][idx], np.float64
        )
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        dist = np.asarray(annotations["distortion_parameters"][idx], np.float64)
        hp = np.asarray(annotations["head_pose"][idx], np.float64)
        hr = hp[:3].reshape(3, 1)
        ht = hp[3:].reshape(3, 1)
        rot = rodrigues(hr)
        # upstream bug not replicated: data_process.py:391 adds the ROTATION
        # vector (``+= hr.T``) where the posed landmarks need the translation
        lm3d = (rot @ np.asarray(face_model_3d_coords, np.float64).T).T + ht.T
        fc = lm3d[10:12].mean(axis=0).reshape(3, 1)
        g_t = np.asarray(annotations["3d_gaze_target"][idx], np.float64).reshape(3, 1)
        records.append(
            FrameRecord(
                image_path=os.path.join(subject_dir, name),
                frame_name=os.path.splitext(name)[0],
                cam_index=0,
                camera_matrix=K,
                distortion=dist.reshape(-1, 1),
                hr=hr,
                ht=ht,
                gaze_3d=(g_t - fc).reshape(3),
            )
        )
    return records


def iter_flat_subject(
    subject_dir: str,
    camera_matrix: np.ndarray,
    distortion: Optional[np.ndarray] = None,
    cam_index: int = 0,
) -> List[FrameRecord]:
    """Single-camera flat-directory layout (Columbia / GazeCapture-style:
    one folder of frames, one calibration — upstream
    dataset_pre_processing.py:816,1083)."""
    records = []
    for name in sorted(os.listdir(subject_dir)):
        if os.path.splitext(name)[1].lower() not in _IMG_EXTS:
            continue
        records.append(
            FrameRecord(
                image_path=os.path.join(subject_dir, name),
                frame_name=os.path.splitext(name)[0],
                cam_index=cam_index,
                camera_matrix=np.asarray(camera_matrix, np.float64),
                distortion=(
                    np.zeros((5, 1)) if distortion is None
                    else np.asarray(distortion, np.float64)
                ),
            )
        )
    return records
