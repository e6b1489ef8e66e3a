"""Cameras: the demo render's (the upstream 32x32 inverse intrinsics scaled
to the featmap, the frontal base camera, the 45-view orbit of the demo
GIFs) and the datasets' calibrations (per-camera intrinsics and distortion,
and the lookup by camera index).  The OpenCV XML calibration files are
read with the standard library; MPIIFaceGaze's ``.mat`` files need
``scipy``, imported when called."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

# upstream configs/config_files/cam_inmat_info_32x32.json
BASE_INV_INMAT_32 = np.array(
    [
        [0.007790804840624332, 0.0, -0.12553827464580536],
        [0.0, 0.007790804840624332, -0.12832458317279816],
        [0.0, 0.0, 1.0],
    ],
    np.float32,
)


def base_inv_inmat(featmap_size: int) -> np.ndarray:
    """Inverse intrinsics at ``featmap_size``: the 32x32 focal block divided
    by ``featmap_size / 32``."""
    m = BASE_INV_INMAT_32.copy()
    m[:2, :2] /= featmap_size / 32.0
    return m


def base_camera(featmap_size: int) -> Dict[str, np.ndarray]:
    """Frontal camera at distance 12."""
    R = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    T = np.array([0.0, 0.0, 12.0], np.float32)
    return {
        "Rmats": R[None],
        "Tvecs": T[None, :, None],
        "inv_inmats": base_inv_inmat(featmap_size)[None],
    }


def orbit_cameras(view_num: int, featmap_size: int) -> List[Dict[str, np.ndarray]]:
    """The circular orbit of the demo GIFs (upstream
    ``utils/render_utils.py``): ``view_num`` cameras at distance 12 on a
    circle of radius 5.3, each looking at the origin."""
    tv_z, radius = 12.0, 5.3
    center = np.zeros(3)
    d2_up = np.array([0.0, -1.0, 0.0])
    cams = []
    for angle in np.linspace(0.0, 360.0, view_num):
        theta = angle / 180.0 * math.pi
        vp = np.array([math.cos(theta) * radius, math.sin(theta) * radius, tv_z])
        d1 = center - vp
        d2 = np.cross(d2_up, d1)
        d3 = np.cross(d1, d2)
        d1, d2, d3 = (v / np.linalg.norm(v) for v in (d1, d2, d3))
        R = np.stack([d2, d3, d1], axis=1).astype(np.float32)
        cams.append({
            "Rmats": R[None],
            "Tvecs": vp.astype(np.float32)[None, :, None],
            "inv_inmats": base_inv_inmat(featmap_size)[None],
        })
    return cams


def read_opencv_xml(path: str, *names: str) -> List[np.ndarray]:
    """The matrices ``names`` of an OpenCV ``FileStorage`` XML file
    (``<name type_id="opencv-matrix">`` with ``rows``, ``cols`` and
    ``data``), as float64 arrays."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    out = []
    for name in names:
        node = root.find(name)
        if node is None:
            raise KeyError(f"{path}: no matrix {name!r}")
        rows, cols = int(node.findtext("rows")), int(node.findtext("cols"))
        data = np.array(node.findtext("data").split(), np.float64)
        out.append(data.reshape(rows, cols))
    return out


def load_camera_calibrations(dataset: str, cam_dir: str):
    """Per-camera ``(K, dist)`` calibrations (upstream ``evaluate_metrics.py``
    ``load_cams``): ETH-XGaze 18 OpenCV XML files ``cam00.xml`` ..
    ``cam17.xml``, MPIIFaceGaze 15 ``CameraNN.mat``, Columbia and
    GazeCapture one ``cam00.xml``.  Returns a list of pairs, or the one
    pair."""
    import os

    def read_xml(path):
        return tuple(read_opencv_xml(path, "Camera_Matrix", "Distortion_Coefficients"))

    if dataset == "eth_xgaze":
        return [read_xml(os.path.join(cam_dir, "cam%02d.xml" % i)) for i in range(18)]
    if dataset == "mpii_face_gaze":
        import scipy.io

        out = []
        for i in range(15):
            mat = scipy.io.loadmat(os.path.join(cam_dir, "Camera%02d.mat" % i))
            out.append((np.asarray(mat["cameraMatrix"], np.float64),
                        np.asarray(mat["distCoeffs"], np.float64)))
        return out
    return read_xml(os.path.join(cam_dir, "cam00.xml"))


def make_cam_lookup(dataset: str, cams, subject: str = ""):
    """``cam_index -> (K, dist)`` (upstream ``select_cam_matrix``):
    MPIIFaceGaze takes the subject's camera by its number and pins the
    principal point to 256; Columbia and GazeCapture have one camera."""

    def lookup(cam_ind: int):
        if dataset == "eth_xgaze":
            return cams[cam_ind]
        if dataset == "mpii_face_gaze":
            K, d = cams[int(subject[-5:-3])]
            K = np.array(K, np.float64, copy=True)
            K[0, 2] = 256.0
            K[1, 2] = 256.0
            return K, d
        return cams

    return lookup
