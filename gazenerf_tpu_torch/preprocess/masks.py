"""Head and eye masks, the port of the JAX package's ``preprocess/masks.py``
(upstream ``pre_processing/gen_all_masks.py`` and ``correct_head_mask.py``).

Three tiers, as upstream's fallback chain:

1. :class:`BiSeNetMasker`: the BiSeNet face parser (``preprocess/bisenet.py``)
   on the card; 19 classes, the head by a label table, cleaned by
   :func:`correct_head_mask`;
2. :class:`UNetEyeMasker`: the U-Net eye segmenter (``preprocess/unet.py``)
   where BiSeNet finds no eye pixels;
3. :func:`landmark_masks`: the head's convex hull and eye rectangles from
   68 landmarks, needing no weights.

The JAX package calls OpenCV for the cleanup and the polygon; the port
needs none.  Each replacement gives OpenCV's pixels:

* :func:`largest_component` is ``connectedComponentsWithStats`` (8-connected)
  and the largest label, ties to the label OpenCV numbers first: its
  labelling scans 2 x 2 blocks, so components are numbered by the first
  block (row pair, then column pair) they touch;
* :func:`flood_fill` is ``floodFill`` with a zero tolerance: the 4-connected
  region of the seed's value, from the one seed pixel;
* :func:`erode3x3` is ``erode`` with a 3 x 3 kernel, whose default border
  never erodes;
* :func:`convex_hull` and :func:`fill_convex_poly` are ``convexHull`` and
  ``fillConvexPoly`` on integer points: OpenCV's scanline fill in 16-bit
  fixed point over its 8-connected outline.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from scipy import ndimage

from gazenerf_tpu_torch.models.gaze_nerf import resolve_device

# BiSeNet face-parsing labels counted as "head" (upstream gen_all_masks.py)
HEAD_LABELS = (1, 2, 3, 4, 5, 6, 10, 11, 12, 13, 17)
LEFT_EYE_LABEL = 4
RIGHT_EYE_LABEL = 5


def largest_component(m: np.ndarray) -> np.ndarray:
    """The largest 8-connected component of the 0/1 image ``m`` (uint8),
    where it has more than one; ``m`` unchanged where it has none."""
    labels, n = ndimage.label(m, structure=np.ones((3, 3), bool))
    if n <= 1:
        return m if n == 0 else (labels == 1).astype(np.uint8)
    area = np.bincount(labels.ravel(), minlength=n + 1)[1:]
    # OpenCV's numbering: by the first 2 x 2 block each component touches
    H, W = m.shape
    ys, xs = np.nonzero(labels)
    block = (ys // 2) * ((W + 1) // 2) + xs // 2
    first = np.full(n, np.iinfo(np.int64).max)
    np.minimum.at(first, labels[ys, xs] - 1, block)
    order = np.argsort(first, kind="stable")  # OpenCV's label order
    best = order[int(np.argmax(area[order]))]
    return (labels == best + 1).astype(np.uint8)


def flood_fill(img: np.ndarray, seed: Tuple[int, int], value: int) -> np.ndarray:
    """``cv2.floodFill(img, mask, seed, value)`` with zero tolerances: the
    4-connected region of pixels equal to the seed's, from the seed pixel
    ``(x, y)``, set to ``value`` (a copy)."""
    x, y = seed
    labels, _ = ndimage.label(img == img[y, x])
    out = img.copy()
    out[labels == labels[y, x]] = value
    return out


def erode3x3(m: np.ndarray) -> np.ndarray:
    """``cv2.erode(m, ones((3, 3)))``: the minimum over each 3 x 3 window,
    the pixels outside the image left out (OpenCV's default border)."""
    p = np.pad(m, 1, mode="edge")
    H, W = m.shape
    return np.min(np.stack([p[dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]),
                  axis=0)


def correct_head_mask(mask: np.ndarray) -> np.ndarray:
    """Keep the largest component, fill the holes (the background
    4-connected to the corner pixel is kept, all other background filled),
    erode once (upstream correct_head_mask.py)."""
    m = (np.asarray(mask) > 127).astype(np.uint8)
    m = largest_component(m)
    m = m | flood_fill(1 - m, (0, 0), 0)
    return (erode3x3(m) * 255).astype(np.uint8)


def convex_hull(pts: np.ndarray) -> np.ndarray:
    """The convex hull's vertices of integer points ``[N, 2]`` (no point
    inside an edge), ``[M, 2]``; fewer than three distinct or collinear
    points give their extreme points."""
    from scipy.spatial import ConvexHull, QhullError

    pts = np.unique(np.asarray(pts, np.int64).reshape(-1, 2), axis=0)
    if len(pts) >= 3:
        try:
            return pts[ConvexHull(pts).vertices]
        except QhullError:  # collinear
            pass
    lo = min(range(len(pts)), key=lambda i: (pts[i, 0], pts[i, 1]))
    hi = max(range(len(pts)), key=lambda i: (pts[i, 0], pts[i, 1]))
    return pts[[lo] if lo == hi else [lo, hi]]


_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _clip_line(w: int, h: int, p0, p1):
    """``cv2.clipLine`` on a ``w x h`` image: the segment's ends moved onto
    the image's edges (each intersection truncated to an integer), or None
    where it misses the image."""
    (x1, y1), (x2, y2) = p0, p1
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return ((x1, y1), (x2, y2)) if (c1 | c2) == 0 else None


def _draw_line(img: np.ndarray, p0, p1, value: int) -> None:
    """``cv2.line(img, p0, p1, value)`` (8-connected, one pixel wide):
    OpenCV's line iterator, the segment clipped to the image first
    (:func:`_clip_line`), then stepped from its left end."""
    H, W = img.shape[:2]
    if not (0 <= p0[0] < W and 0 <= p1[0] < W and 0 <= p0[1] < H and 0 <= p1[1] < H):
        ends = _clip_line(W, H, p0, p1)
        if ends is None:
            return
        p0, p1 = ends
    (x0, y0), (x1, y1) = p0, p1
    if x1 < x0:
        (x0, y0), (x1, y1) = (x1, y1), (x0, y0)
    dx, dy = x1 - x0, y1 - y0
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy, sx, sy = dy, dx, sy, sx
    err = dx - 2 * dy
    x, y = x0, y0
    for _ in range(dx + 1):
        img[y, x] = value
        step = err < 0
        err += -2 * dy + (2 * dx if step else 0)
        if vert:  # the major axis is y
            y += sx
            x += sy if step else 0
        else:
            x += sx
            y += sy if step else 0


def fill_convex_poly(img: np.ndarray, pts: np.ndarray, value: int) -> None:
    """``cv2.fillConvexPoly(img, pts, value)`` for integer points (line
    type 8, no shift), in place: the outline drawn by :func:`_draw_line`,
    then per row the span between the two edges, stepped in 16-bit fixed
    point and rounded to pixels."""
    v = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    n = len(v)
    H, W = img.shape[:2]
    for i in range(n):
        _draw_line(img, v[i - 1], v[i], value)
    ys = [p[1] for p in v]
    xs = [p[0] for p in v]
    imin = ys.index(min(ys))
    ymin, ymax = min(ys), max(ys)
    if n < 3 or max(xs) < 0 or ymax < 0 or min(xs) >= W or ymin >= H:
        return
    ymax = min(ymax, H - 1)
    half = _XY_ONE >> 1
    edge = [dict(idx=imin, di=1, x=-_XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=n - 1, x=-_XY_ONE, dx=0, ye=ymin)]
    edges = n
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % n
                while edges > 0:
                    edges -= 1
                    ty = v[idx][1]
                    if ty > y:
                        xs0, xe = v[idx0][0] << _XY_SHIFT, v[idx][0] << _XY_SHIFT
                        # C's truncating division
                        num, den = (xe - xs0) * 2 + (ty - y), 2 * (ty - y)
                        q = abs(num) // den
                        e.update(ye=ty, dx=q if num >= 0 else -q, x=xs0, idx=idx)
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % n
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            x1 = (edge[left]["x"] + half) >> _XY_SHIFT
            x2 = (edge[right]["x"] + half) >> _XY_SHIFT
            if x2 >= 0 and x1 < W:
                img[y, max(x1, 0):min(x2, W - 1) + 1] = value
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def landmark_masks(landmarks: np.ndarray, img_size: int,
                   cam_index: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Head and left/right eye masks (uint8 0/255) from 68 landmarks: the
    head is the convex hull of the landmarks and the brows lifted over the
    forehead, the eyes rectangles about points 36-41 and 42-47; cameras
    11/12 have no right eye, 14/15 no left (upstream's half profiles)."""
    lm = np.asarray(landmarks, np.float32).reshape(-1, 2)
    head = np.zeros((img_size, img_size), np.uint8)
    brows = lm[17:27]
    eyes_line = lm[36:48].mean(axis=0)
    lift = max(10.0, 1.5 * float(np.abs(eyes_line[1] - brows[:, 1].mean())))
    forehead = brows.copy()
    forehead[:, 1] -= lift * 2.0
    pts = np.concatenate([lm, forehead], axis=0).astype(np.int32)
    fill_convex_poly(head, convex_hull(pts), 255)

    def eye_rect(group):
        g = lm[group]
        x0, y0 = g.min(axis=0)
        x1, y1 = g.max(axis=0)
        padx = max(4.0, 0.4 * (x1 - x0))
        pady = max(4.0, 1.2 * (y1 - y0))
        m = np.zeros((img_size, img_size), np.uint8)
        m[max(int(y0 - pady), 0):min(int(y1 + pady), img_size),
          max(int(x0 - padx), 0):min(int(x1 + padx), img_size)] = 255
        return m

    left = eye_rect(range(36, 42))
    right = eye_rect(range(42, 48))
    if cam_index in (11, 12):
        right = np.zeros_like(right)
    elif cam_index in (14, 15):
        left = np.zeros_like(left)
    return head, left, right


def _labels(net: torch.nn.Module, x: np.ndarray, device: torch.device) -> np.ndarray:
    """Per-pixel argmax labels of ``net`` on one ``[H, W, 3]`` f32 image."""
    with torch.no_grad():
        t = torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=device)
        logits = net(t.permute(2, 0, 1)[None])[0]
    return logits.argmax(0).cpu().numpy()


class BiSeNetMasker:
    """The BiSeNet face-parsing masker.  ``state_dict``: upstream's
    ``79999_iter.pth`` layout (``preprocess/bisenet.py``; the auxiliary
    heads may be left out); without one it is not ``available`` and the
    driver falls back to :func:`landmark_masks`.  Runs on the card unless
    ``device`` says otherwise."""

    def __init__(self, state_dict=None, device=None):
        from gazenerf_tpu_torch.preprocess.bisenet import BiSeNet

        self.device = resolve_device(device)
        self.net = None
        if state_dict is not None:
            self.net = BiSeNet(n_classes=19)
            missing, unexpected = self.net.load_state_dict(state_dict, strict=False)
            missing = [k for k in missing if not k.startswith(("conv_out16.", "conv_out32."))]
            if missing or unexpected:  # only the auxiliary heads, which it does not run, may lack
                raise KeyError(f"BiSeNet state dict: missing {missing}, unexpected {unexpected}")
            self.net.eval().to(self.device)

    @property
    def available(self) -> bool:
        return self.net is not None

    def __call__(self, img: np.ndarray, cam_index: int = 0):
        """``img``: ``[H, W, 3]`` float in [0, 1] -> (head, left eye, right
        eye) uint8 0/255."""
        if not self.available:
            raise RuntimeError("BiSeNetMasker needs weights")
        labels = _labels(self.net, img, self.device)
        head = correct_head_mask(np.isin(labels, HEAD_LABELS).astype(np.uint8) * 255)
        left = (labels == LEFT_EYE_LABEL).astype(np.uint8) * 255
        right = (labels == RIGHT_EYE_LABEL).astype(np.uint8) * 255
        if cam_index in (11, 12):
            right = np.zeros_like(right)
        elif cam_index in (14, 15):
            left = np.zeros_like(left)
        return head, left, right


class UNetEyeMasker:
    """The U-Net eye-segmentation fallback (upstream's ``second_net``): the
    frame mapped to [-1, 1], the two eye labels of the 19-class argmax, split
    left/right by the image's halves.  ``state_dict``: upstream's ``unet``
    layout (``preprocess/unet.py``).  Runs on the card unless ``device``
    says otherwise."""

    def __init__(self, state_dict=None, device=None):
        from gazenerf_tpu_torch.preprocess.unet import UNet

        self.device = resolve_device(device)
        self.net = None
        if state_dict is not None:
            self.net = UNet(n_classes=19)
            self.net.load_state_dict(state_dict)
            self.net.eval().to(self.device)

    @property
    def available(self) -> bool:
        return self.net is not None

    def __call__(self, img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``img``: ``[H, W, 3]`` float in [0, 1] -> (left eye, right eye)
        uint8 0/255."""
        if not self.available:
            raise RuntimeError("UNetEyeMasker needs weights")
        x = (np.asarray(img, np.float32) - 0.5) / 0.5
        labels = _labels(self.net, x, self.device)
        eyes = np.isin(labels, (LEFT_EYE_LABEL, RIGHT_EYE_LABEL)).astype(np.uint8) * 255
        w = eyes.shape[1]
        left = eyes.copy()
        left[:, w // 2:] = 0
        right = eyes.copy()
        right[:, :w // 2] = 0
        return left, right
