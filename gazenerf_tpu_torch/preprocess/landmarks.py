"""68-point landmarks with upstream's fallback chain, the port of the JAX
package's ``preprocess/landmarks.py`` (upstream
``pre_processing/gen_landmark.py``): the face-alignment detector where it
is installed (an optional dependency, as in the JAX package), a retry on
the histogram-equalized grey image, then the previous frame's landmarks,
and last :func:`synthetic_landmarks` in a centred box.

The retry's OpenCV calls have numpy counterparts giving OpenCV's pixels:
:func:`rgb_to_gray` (``cvtColor(RGB2GRAY)``: 15-bit fixed-point weights
9798, 19235, 3735, rounded) and :func:`equalize_hist` (``equalizeHist``:
the cumulative histogram after the first occupied level times f32 ``255 /
(n - count(first))``, rounded, as a lookup table).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


def synthetic_landmarks(bbox, jitter: float = 0.0, seed: int = 0) -> np.ndarray:
    """A plausible 68-point layout inside ``bbox = (x0, y0, x1, y1)``, f32
    ``[68, 2]`` in iBUG order: 0-16 jaw, 17-26 brows, 27-35 nose, 36-47
    eyes, 48-67 mouth."""
    x0, y0, x1, y1 = [float(v) for v in bbox]
    w, h = x1 - x0, y1 - y0
    cx = (x0 + x1) / 2
    pts = []
    for i in range(17):  # jaw: a half ellipse
        t = i / 16.0 * np.pi
        pts.append([cx - np.cos(t) * w / 2, y0 + h * 0.45 + np.sin(t) * h * 0.55])
    for i in range(5):
        pts.append([x0 + w * (0.18 + 0.12 * i), y0 + h * 0.28])
    for i in range(5):
        pts.append([x0 + w * (0.54 + 0.12 * i), y0 + h * 0.28])
    for i in range(4):  # nose bridge, then base
        pts.append([cx, y0 + h * (0.35 + 0.08 * i)])
    for i in range(5):
        pts.append([cx + w * (0.08 * (i - 2)), y0 + h * 0.62])
    for ex in (0.31, 0.66):  # eyes, six points each
        exc, eyc, ew, eh = x0 + w * ex, y0 + h * 0.40, w * 0.10, h * 0.035
        for i in range(6):
            t = i / 6.0 * 2 * np.pi
            pts.append([exc + np.cos(t) * ew, eyc + np.sin(t) * eh])
    mcx, mcy = cx, y0 + h * 0.76
    for i in range(20):  # mouth
        t = i / 20.0 * 2 * np.pi
        pts.append([mcx + np.cos(t) * w * 0.18, mcy + np.sin(t) * h * 0.06])
    lm = np.asarray(pts, np.float32)
    if jitter:
        lm = lm + np.random.default_rng(seed).normal(0, jitter, lm.shape)
    return lm


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2GRAY)`` for uint8 ``[H, W, 3]``."""
    c = np.asarray(img).astype(np.int32)
    return ((c[..., 0] * 9798 + c[..., 1] * 19235 + c[..., 2] * 3735 + (1 << 14)) >> 15).astype(
        np.uint8)


def equalize_hist(gray: np.ndarray) -> np.ndarray:
    """``cv2.equalizeHist(gray)`` for uint8 ``[H, W]``."""
    g = np.asarray(gray, np.uint8)
    hist = np.bincount(g.ravel(), minlength=256)
    i = int(np.flatnonzero(hist)[0])
    lut = np.zeros(256, np.uint8)
    if hist[i] == g.size:
        lut[i] = i
    else:
        scale = np.float32(255.0) / np.float32(g.size - hist[i])
        lut[i + 1:] = np.clip(np.rint(np.cumsum(hist[i + 1:]).astype(np.float32) * scale), 0,
                              255).astype(np.uint8)
    return lut[g]


class LandmarkDetector:
    """The face-alignment detector with the equalization and
    previous-frame fallbacks; without face-alignment only the fallbacks
    (logged once, when built)."""

    def __init__(self, device: str = "cpu"):
        self._fa = None
        try:
            import face_alignment  # optional dependency

            self._fa = face_alignment.FaceAlignment(face_alignment.LandmarksType.TWO_D,
                                                    device=device)
        except ImportError:
            logger.warning("face_alignment not installed; landmark detection will use "
                           "fallbacks only")
        self.previous: Optional[np.ndarray] = None

    @property
    def available(self) -> bool:
        return self._fa is not None

    def _detect(self, img: np.ndarray) -> Optional[np.ndarray]:
        preds = self._fa.get_landmarks(img)
        return np.asarray(preds[0], np.float32) if preds else None

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """``img``: uint8 ``[H, W, 3]`` RGB -> ``[68, 2]`` landmarks."""
        if self.available:
            lm = self._detect(img)
            if lm is None:
                eq = equalize_hist(rgb_to_gray(img))
                lm = self._detect(np.repeat(eq[..., None], 3, axis=-1))
            if lm is not None:
                self.previous = lm
                return lm
        if self.previous is not None:
            logger.info("landmarks: reusing previous frame")
            return self.previous
        h, w = img.shape[:2]
        logger.info("landmarks: synthesizing from center bbox")
        lm = synthetic_landmarks((w * 0.25, h * 0.2, w * 0.75, h * 0.85))
        self.previous = lm
        return lm
