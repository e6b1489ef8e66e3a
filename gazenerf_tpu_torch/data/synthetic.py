"""Synthetic per-subject HDF5 files in the upstream data schema.

The trainer depends only on the ``.h5`` schema that the upstream offline
data factory writes (``dataset_pre_processing.py``; read back by
``datasets/eth_xgaze.py``).  This module writes files with the same
datasets, shapes and dtypes and synthetic content (a disc of face colour on
white, rectangular eye masks, seeded codes and poses), so
the loader, the trainer and the training CLI run without the dataset.  The
port's own copy of the JAX package's ``data/synthetic.py``: the same
datasets and values for the same arguments.  ``h5py`` is imported when a
file is written.
"""

from __future__ import annotations

import os

import numpy as np

SCHEMA = {
    "face_patch": ((512, 512, 3), np.uint8),
    "head_mask": ((512, 512), np.uint8),
    "left_eye_mask": ((512, 512), np.uint8),
    "right_eye_mask": ((512, 512), np.uint8),
    "facial_landmarks": ((68, 2), np.float64),
    "cam_index": ((1,), np.int64),
    "latent_codes": ((306,), np.float32),
    "w2c_Rmat": ((3, 3), np.float32),
    "w2c_Tvec": ((3,), np.float32),
    "c2w_Rmat": ((3, 3), np.float32),
    "c2w_Tvec": ((3,), np.float32),
    "inmat": ((3, 3), np.float32),
    "inv_inmat": ((3, 3), np.float32),
    "pitchyaw_head": ((2,), np.float32),
    "face_head_pose": ((2,), np.float32),
}
_IMAGES = ("face_patch", "head_mask", "left_eye_mask", "right_eye_mask")


def _frame(key, shape, img_size, i, rng, inmat):
    """Frame ``i`` of dataset ``key``; ``rng`` is drawn in the file's order
    (dataset by dataset, frame by frame)."""
    c = img_size // 2
    if key in ("face_patch", "head_mask"):
        yy, xx = np.mgrid[:img_size, :img_size]
        face = ((yy - c) ** 2 + (xx - c) ** 2) < (img_size // 3) ** 2
        if key == "head_mask":
            return face.astype(np.uint8) * 255
        img = np.full(shape, 255, np.uint8)
        img[face] = (180, 140, 120)
        return img
    if key in ("left_eye_mask", "right_eye_mask"):
        m = np.zeros(shape, np.uint8)
        off = -img_size // 10 if key == "left_eye_mask" else img_size // 10
        h, w = max(img_size // 16, 2), max(img_size // 20, 2)
        top = max(c - img_size // 12 - h, 0)
        m[top : top + h, c + off - w : c + off + w] = 255
        return m
    if key == "facial_landmarks":
        return rng.uniform(100, 400, (68, 2))
    if key == "cam_index":
        return [i % 18]
    if key == "latent_codes":
        return rng.standard_normal(306).astype(np.float32) * 0.1
    if key in ("w2c_Rmat", "c2w_Rmat"):
        return np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    if key in ("w2c_Tvec", "c2w_Tvec"):
        return np.array([0.0, 0.0, 12.0], np.float32)
    if key == "inmat":
        return inmat
    if key == "inv_inmat":
        return np.linalg.inv(inmat).astype(np.float32)
    if key == "pitchyaw_head":
        return rng.uniform(-0.5, 0.5, 2).astype(np.float32)
    return rng.uniform(-0.3, 0.3, 2).astype(np.float32)  # face_head_pose


def write_synthetic_subject(
    path: str,
    num_frames: int = 8,
    img_size: int = 512,
    seed: int = 0,
    prefix: str = "xgaze_",
    subject: str = "subject0000.h5",
) -> str:
    """Write one schema-complete synthetic subject file into the directory
    ``path``; returns the file's path."""
    import h5py

    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    fpath = os.path.join(path, prefix + subject)
    inmat = np.array(
        [[1600.0, 0.0, img_size / 2], [0.0, 1600.0, img_size / 2], [0.0, 0.0, 1.0]],
        np.float32,
    )
    with h5py.File(fpath, "w") as f:
        for key, (shape, dtype) in SCHEMA.items():
            if key in _IMAGES:
                shape = (img_size, img_size, 3) if key == "face_patch" else (img_size, img_size)
            ds = f.create_dataset(key, (num_frames,) + shape, dtype=dtype, chunks=(1,) + shape)
            for i in range(num_frames):
                ds[i] = _frame(key, shape, img_size, i, rng, inmat)
    return fpath
