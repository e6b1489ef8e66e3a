"""Face normalization: the head pose from landmarks, then the warp to a
virtual camera that looks at the face centre from a fixed distance.

The port's counterpart of what the JAX package's ``preprocess/normalize.py``
gives the evaluation protocols (``eval/protocols.make_eval_normalizer``):
:func:`estimate_head_pose`, :func:`face_center_from_pose` and
:func:`normalize_face`.  The JAX package calls OpenCV; the port needs none:

* the head pose is the minimum of the reprojection error (OpenCV's camera
  model with its distortion coefficients) over the Rodrigues vector and the
  translation, found by Levenberg-Marquardt run to convergence from several
  initial poses (a direct linear solve and frontal poses turned about the
  vertical axis), the lowest cost kept.  ``cv2.solvePnP`` (EPnP, then its
  iterative refinement, a Levenberg-Marquardt of the same cost) reaches the
  same minimum where the landmarks come from a face;
* the warp (:func:`warp_perspective`) is ``cv2.warpPerspective``'s on uint8
  images, in PyTorch on the image's device: the destination pixel maps back
  through the inverse homography, its four neighbours are weighted
  bilinearly in f32 (neighbours outside the image read 0) and the sum is
  rounded.  That is OpenCV 5's arithmetic; OpenCV 4 rounds the source
  position to 1/32 pixel and weights in 15-bit fixed point, up to a few
  levels apart on sharp edges;
* the affine warp (:func:`warp_affine`) is ``cv2.warpAffine``'s on uint8
  images in OpenCV 5's order of operations: the inverse map in float64
  rounded to f32, each source coordinate one fused multiply-add on the f32
  row term, the taps lerped with fused multiply-adds, rounded half to even
  (equal to cv2's pixels in every case the tests meet, exact half-pixel
  positions included, where :func:`warp_perspective`'s order rounds some
  sums the other way);
* the resize (:func:`resize_linear_u8`) is ``cv2.resize``'s INTER_LINEAR on
  uint8 images, its fixed point emulated in integer tensor ops: 11-bit
  weights and the two-pass sum of OpenCV's ``HResizeLinear`` and
  ``VResizeLinear`` (equal to cv2's pixels at every size the tests meet,
  the exact halving included, where OpenCV averages 2x2 blocks).

The offline data factory's raw-image fixes and helpers (the rest of the JAX
module) give cv2's pixels too: :func:`undistort` (``cv2.undistort``: maps
in fixed point, the float64 source position rounded to 1/32 pixel, 15-bit
bilinear weights), :class:`Undistorter` (``initUndistortRectifyMap(...,
CV_32FC1)`` then ``remap``, whose f32 maps OpenCV 5 samples with
:func:`warp_affine`'s lerps), :func:`rotation_matrix_2d`
(``getRotationMatrix2D``), :func:`resize_area_u8` (INTER_AREA); and the
gaze helpers :func:`normalize_gaze_vector`, :func:`vector_to_pitchyaw`,
:func:`gaze_to_head_coordinates`, :func:`normalized_head_pose`.

The pose is host work in numpy (a few dozen 6x6 solves); the warps run
where the image lies.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

def rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Rotation vector ``[3]`` (or ``[3, 1]``) -> rotation matrix ``[3, 3]``."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = float(np.linalg.norm(r))
    if theta < 1e-300:
        return np.eye(3)
    k = r / theta
    K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def rotation_vector(R: np.ndarray) -> np.ndarray:
    """Rotation matrix ``[3, 3]`` -> rotation vector ``[3]`` (the inverse of
    :func:`rodrigues`, angle in [0, pi])."""
    R = np.asarray(R, np.float64)
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = float(np.arccos(cos))
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if theta < 1e-12:
        return w / 2.0
    if np.pi - theta > 1e-6:
        return w * (theta / (2.0 * np.sin(theta)))
    # near pi: the axis from the symmetric part, its sign from w
    B = (R + np.eye(3)) / 2.0
    k = np.sqrt(np.clip(np.diag(B), 0.0, None))
    i = int(np.argmax(k))
    k = B[i] / k[i]
    if w @ k < 0:
        k = -k
    return theta * k / np.linalg.norm(k)


def _dist8(dist_coeffs) -> np.ndarray:
    d = np.zeros(8) if dist_coeffs is None else np.asarray(dist_coeffs, np.float64).reshape(-1)
    if d.size > 8:
        raise ValueError(f"{d.size} distortion coefficients: at most 8 (k1 k2 p1 p2 k3 k4 k5 k6)")
    return np.concatenate([d, np.zeros(8 - d.size)])


def project_points(points_3d, rvec, tvec, camera_matrix, dist_coeffs=None) -> np.ndarray:
    """``cv2.projectPoints``: ``[N, 3]`` points through the pose, OpenCV's
    radial (k1, k2, k3 over k4, k5, k6) and tangential (p1, p2) distortion
    and the camera matrix -> ``[N, 2]`` pixels."""
    k1, k2, p1, p2, k3, k4, k5, k6 = _dist8(dist_coeffs)
    X = np.asarray(points_3d, np.float64).reshape(-1, 3) @ rodrigues(rvec).T
    X = X + np.asarray(tvec, np.float64).reshape(1, 3)
    x, y = X[:, 0] / X[:, 2], X[:, 1] / X[:, 2]
    r2 = x * x + y * y
    radial = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    K = np.asarray(camera_matrix, np.float64)
    return np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], axis=1)


def _undistort(uv: np.ndarray, K: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Pixels -> normalized camera coordinates, the distortion inverted by
    fixed-point iteration (``cv2.undistortPoints``)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = dist
    y0 = (uv[:, 1] - K[1, 2]) / K[1, 1]
    x0 = (uv[:, 0] - K[0, 2]) / K[0, 0]
    x, y = x0.copy(), y0.copy()
    for _ in range(20):
        r2 = x * x + y * y
        icdist = (1 + ((k6 * r2 + k5) * r2 + k4) * r2) / (1 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = (x0 - dx) * icdist, (y0 - dy) * icdist
    return np.stack([x, y], axis=1)


def _dlt_pose(X: np.ndarray, xn: np.ndarray) -> Optional[np.ndarray]:
    """The direct linear solve of ``[R | t]`` from normalized image points,
    its rotation part projected onto the rotations: ``[rvec, tvec]`` or
    None where the points do not determine it."""
    n = X.shape[0]
    if n < 6:
        return None
    Xh = np.concatenate([X, np.ones((n, 1))], axis=1)
    A = np.zeros((2 * n, 12))
    A[0::2, 0:4] = Xh
    A[0::2, 8:12] = -xn[:, :1] * Xh
    A[1::2, 4:8] = Xh
    A[1::2, 8:12] = -xn[:, 1:] * Xh
    P = np.linalg.svd(A)[2][-1].reshape(3, 4)
    if (Xh @ P[2]).sum() < 0:  # the points in front of the camera
        P = -P
    U, s, Vt = np.linalg.svd(P[:, :3])
    R = U @ Vt
    if np.linalg.det(R) < 0 or s.mean() <= 0:
        return None
    return np.concatenate([rotation_vector(R), P[:, 3] / s.mean()])


def _levenberg_marquardt(residual, p0: np.ndarray, max_iter: int = 200) -> Tuple[np.ndarray, float]:
    """Minimize ``|residual(p)|^2`` from ``p0``: Levenberg-Marquardt with
    central-difference Jacobians, until a step no longer changes the
    parameters or the cost.  Returns ``(p, cost)``."""
    p = p0.astype(np.float64)
    r = residual(p)
    cost = float(r @ r)
    lam = None
    for _ in range(max_iter):
        J = np.empty((r.size, p.size))
        for j in range(p.size):
            h = 1e-6 * max(1.0, abs(p[j]))
            e = np.zeros_like(p)
            e[j] = h
            J[:, j] = (residual(p + e) - residual(p - e)) / (2 * h)
        JtJ, g = J.T @ J, J.T @ r
        if lam is None:
            lam = 1e-3 * float(np.max(np.diag(JtJ)))
        while True:
            step = np.linalg.solve(JtJ + lam * np.diag(np.diag(JtJ) + 1e-12), -g)
            r_new = residual(p + step)
            cost_new = float(r_new @ r_new)
            if cost_new <= cost or lam > 1e12:
                break
            lam *= 10.0
        if cost_new > cost:
            break
        done = (np.abs(step).max() <= 1e-13 * (np.abs(p).max() + 1e-13)
                or cost - cost_new <= 1e-15 * cost)
        p, r, cost = p + step, r_new, cost_new
        lam = max(lam / 10.0, 1e-15)
        if done:
            break
    return p, cost


def estimate_head_pose(
    landmarks_2d: np.ndarray,
    face_model_3d: np.ndarray,
    camera_matrix: np.ndarray,
    dist_coeffs: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The head pose whose projection of ``face_model_3d`` (``[N, 3]``)
    lies closest to ``landmarks_2d`` (``[N, 2]``, same order) in the least
    squares sense, through ``camera_matrix`` and ``dist_coeffs``.  Returns
    ``(rvec [3, 1], tvec [3, 1])`` as ``cv2.solvePnP`` does."""
    uv = np.asarray(landmarks_2d, np.float64).reshape(-1, 2)
    X = np.asarray(face_model_3d, np.float64).reshape(-1, 3)
    K = np.asarray(camera_matrix, np.float64)
    dist = _dist8(dist_coeffs)

    def residual(p):
        return (project_points(X, p[:3], p[3:], K, dist) - uv).reshape(-1)

    # initial poses: the direct linear solve, and the face model seen from
    # the front and turned about the vertical axis, at the depth its spread
    # gives and centred on the landmarks
    xn = _undistort(uv, K, dist)
    starts = []
    dlt = _dlt_pose(X, xn)
    if dlt is not None:
        starts.append(dlt)
    spread = np.linalg.norm(X - X.mean(0), axis=1).mean()
    spread_img = np.linalg.norm(xn - xn.mean(0), axis=1).mean()
    depth = spread / max(spread_img, 1e-12)
    centre = np.append(xn.mean(0), 1.0) * depth
    for yaw in (0.0, -0.6, 0.6):
        rvec = np.array([0.0, yaw, 0.0])
        t = centre - rodrigues(rvec) @ X.mean(0)
        starts.append(np.concatenate([rvec, t]))
    best = min((_levenberg_marquardt(residual, p0) for p0 in starts), key=lambda pc: pc[1])[0]
    return best[:3].reshape(3, 1), best[3:].reshape(3, 1)


def face_center_from_pose(face_model_3d: np.ndarray, rvec: np.ndarray, tvec: np.ndarray) -> np.ndarray:
    """The 3D face centre ``[3, 1]``: the mean of the eye corners' mean (the
    first four points of the 6-point model) and the nose corners' (the last
    two), in camera coordinates."""
    Fc = rodrigues(rvec) @ np.asarray(face_model_3d, np.float64).T + np.asarray(
        tvec, np.float64).reshape(3, 1)
    two_eye = np.mean(Fc[:, 0:4], axis=1, keepdims=True)
    nose = np.mean(Fc[:, 4:6], axis=1, keepdims=True)
    return np.mean(np.concatenate([two_eye, nose], axis=1), axis=1).reshape(3, 1)


def warp_perspective(img: torch.Tensor, M: np.ndarray, dsize: Tuple[int, int]) -> torch.Tensor:
    """``cv2.warpPerspective(img, M, dsize)`` for a uint8 ``[H, W, C]``
    tensor (bilinear, border 0), on the tensor's device: destination pixel
    ``(x, y)`` reads the source at ``M^-1 (x, y, 1)``, computed in f32; the
    four neighbours are weighted in f32 and the sum rounded half to even.
    ``dsize`` is ``(width, height)``."""
    _check_u8(img, "warp_perspective")
    H, W, _ = img.shape
    w_out, h_out = dsize
    f32 = torch.float32
    Mi = torch.as_tensor(np.linalg.inv(np.asarray(M, np.float64)), dtype=f32, device=img.device)
    ys, xs = torch.meshgrid(torch.arange(h_out, dtype=f32, device=img.device),
                            torch.arange(w_out, dtype=f32, device=img.device), indexing="ij")
    Z = Mi[2, 0] * xs + Mi[2, 1] * ys + Mi[2, 2]
    X = (Mi[0, 0] * xs + Mi[0, 1] * ys + Mi[0, 2]) / Z
    Y = (Mi[1, 0] * xs + Mi[1, 1] * ys + Mi[1, 2]) / Z
    ok = torch.isfinite(X) & torch.isfinite(Y) & (X.abs() < 2**30) & (Y.abs() < 2**30)
    X, Y = torch.where(ok, X, -2.0), torch.where(ok, Y, -2.0)  # off the image: the border
    x0, y0 = torch.floor(X), torch.floor(Y)
    ax, ay = (X - x0)[..., None], (Y - y0)[..., None]
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)

    def tap(dy, dx):
        xx, yy = x0 + dx, y0 + dy
        inside = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        return img[yy.clamp(0, H - 1), xx.clamp(0, W - 1)].to(f32) * inside[..., None]

    v = ((tap(0, 0) * (1 - ax) + tap(0, 1) * ax) * (1 - ay)
         + (tap(1, 0) * (1 - ax) + tap(1, 1) * ax) * ay)
    return torch.round(v).clamp(0, 255).to(torch.uint8)


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for f32 tensors with one rounding to f32, as a fused
    multiply-add gives it: the product is exact in float64 and the sum is
    rounded there first (a second rounding only where the float64 sum falls
    exactly between two f32 values)."""
    return (a.double() * b.double() + c.double()).float()


def _lerp_taps_u8(img: torch.Tensor, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """The bilinear sampler of OpenCV 5's uint8 warps at f32 source
    positions ``X``, ``Y``: the four neighbours (0 outside the image) lerped
    along x, then y, each step ``fma(p1 - p0, a, p0)``, the result rounded
    half to even."""
    H, W, _ = img.shape
    f32 = torch.float32
    x0, y0 = torch.floor(X), torch.floor(Y)
    ax, ay = (X - x0)[..., None], (Y - y0)[..., None]
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)

    def tap(dy, dx):
        xx, yy = x0 + dx, y0 + dy
        inside = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        return img[yy.clamp(0, H - 1), xx.clamp(0, W - 1)].to(f32) * inside[..., None]

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    t0 = _fma_f32(p01 - p00, ax, p00)
    t1 = _fma_f32(p11 - p10, ax, p10)
    return torch.round(_fma_f32(t1 - t0, ay, t0)).clamp(0, 255).to(torch.uint8)


def _check_u8(img: torch.Tensor, what: str) -> None:
    if img.dtype != torch.uint8 or img.dim() != 3:
        raise ValueError(f"{what} takes a uint8 [H, W, C] image, got {img.dtype} "
                         f"{tuple(img.shape)}")


def warp_affine(img: torch.Tensor, M: np.ndarray, dsize: Tuple[int, int]) -> torch.Tensor:
    """``cv2.warpAffine(img, M, dsize)`` for a uint8 ``[H, W, C]`` tensor
    (bilinear, border 0), on the tensor's device: the inverse of the ``[2,
    3]`` map as ``cv2.invertAffineTransform`` computes it in float64, then
    f32; destination pixel ``(x, y)`` reads the source at ``fma(m00, x, m01 y
    + m02)``, ``fma(m10, x, m11 y + m12)``; the four neighbours (0 outside
    the image) are lerped along x, then y, each step ``fma(p1 - p0, a,
    p0)``; the result rounded half to even.  ``dsize`` is ``(width,
    height)``."""
    _check_u8(img, "warp_affine")
    w_out, h_out = dsize
    f32, dev = torch.float32, img.device
    A = np.asarray(M, np.float64)
    det = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
    det = 1.0 / det if det != 0.0 else 0.0
    a11, a22, a12, a21 = A[1, 1] * det, A[0, 0] * det, -A[0, 1] * det, -A[1, 0] * det
    m = torch.tensor([[a11, a12, -a11 * A[0, 2] - a12 * A[1, 2]],
                      [a21, a22, -a21 * A[0, 2] - a22 * A[1, 2]]], dtype=f32, device=dev)
    xs = torch.arange(w_out, dtype=f32, device=dev)[None, :]
    ys = torch.arange(h_out, dtype=f32, device=dev)[:, None]
    X = _fma_f32(m[0, 0], xs, m[0, 1] * ys + m[0, 2])
    Y = _fma_f32(m[1, 0], xs, m[1, 1] * ys + m[1, 2])
    return _lerp_taps_u8(img, X, Y)


def rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the ``[2, 3]`` map turning the image by
    ``angle`` degrees about ``center`` (counter-clockwise as shown) and
    scaling it.  At 180 degrees it maps ``x`` to ``2 cx - x``: about the
    centre ``(w / 2, h / 2)`` that is ``w - x``, one pixel off a flip, so
    ``warp_affine`` leaves a black first row and column, as OpenCV does."""
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def remap_u8(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """``cv2.remap(img, map_x, map_y, INTER_LINEAR)`` with f32 maps
    (``CV_32FC1``, border 0) for a uint8 ``[H, W, C]`` tensor: OpenCV 5
    samples such maps with the f32 lerps of :func:`warp_affine`."""
    _check_u8(img, "remap_u8")
    dev = img.device
    return _lerp_taps_u8(img, torch.as_tensor(map_x, dtype=torch.float32, device=dev),
                         torch.as_tensor(map_y, dtype=torch.float32, device=dev))


def _remap_tab() -> np.ndarray:
    """OpenCV's bilinear table for fixed-point maps (``initInterTab2D``):
    per 1/32 fraction ``(fy, fx)`` the four weights ``(1 - fy, fy) x (1 -
    fx, fx)`` in f32, each scaled by 2^15 and rounded, the largest (or
    smallest) moved so that they sum to 2^15; ``[32, 32, 4]``."""
    a = np.arange(32, dtype=np.float32) * np.float32(1.0 / 32)
    lin = np.stack([np.float32(1) - a, a], axis=1)  # [32, 2]
    w = (lin[:, None, :, None] * lin[None, :, None, :]).reshape(32, 32, 4)
    it = np.rint(w * np.float32(32768)).astype(np.int64)
    diff = it.sum(-1) - 32768
    for i, j in zip(*np.nonzero(diff)):
        k = np.argmax(it[i, j]) if diff[i, j] < 0 else np.argmin(it[i, j])
        it[i, j, k] -= diff[i, j]
    return it


def _remap_fixed_u8(img: torch.Tensor, X: np.ndarray, Y: np.ndarray) -> torch.Tensor:
    """``cv2.remap`` through fixed-point maps (``CV_16SC2``), uint8: the
    source position ``(X, Y)`` (float64) rounded to 1/32 pixel, the four
    neighbours (0 outside) weighted by :func:`_remap_tab` and the sum
    ``(s + 2^14) >> 15``."""
    H, W, _ = img.shape
    dev = img.device
    xi = torch.as_tensor(np.rint(np.asarray(X) * 32.0).astype(np.int64), device=dev)
    yi = torch.as_tensor(np.rint(np.asarray(Y) * 32.0).astype(np.int64), device=dev)
    w = torch.as_tensor(_remap_tab(), device=dev)[yi & 31, xi & 31]
    x0, y0 = xi >> 5, yi >> 5
    acc = torch.zeros(tuple(xi.shape) + (img.shape[2],), dtype=torch.int64, device=dev)
    for k, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        xx, yy = x0 + dx, y0 + dy
        inside = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        acc += img[yy.clamp(0, H - 1), xx.clamp(0, W - 1)].to(torch.int64) * (
            w[..., k] * inside)[..., None]
    return ((acc + (1 << 14)) >> 15).clamp(0, 255).to(torch.uint8)


def undistort_map(camera_matrix: np.ndarray, dist_coeffs, size: Tuple[int, int]):
    """``cv2.initUndistortRectifyMap(K, dist, None, K, size, ...)``'s source
    positions in float64: ``(map_x, map_y)``, each ``[h, w]`` for ``size =
    (w, h)``; OpenCV rounds them to f32 for ``CV_32FC1`` and to 1/32 pixel
    for ``CV_16SC2``."""
    K = np.asarray(camera_matrix, np.float64)
    k1, k2, p1, p2, k3, k4, k5, k6 = _dist8(dist_coeffs)
    w, h = size
    ir = np.linalg.inv(K)
    j = np.arange(w, dtype=np.float64)[None, :]
    i = np.arange(h, dtype=np.float64)[:, None]
    z = j * ir[2, 0] + (i * ir[2, 1] + ir[2, 2])
    x = (j * ir[0, 0] + (i * ir[0, 1] + ir[0, 2])) / z
    y = (j * ir[1, 0] + (i * ir[1, 1] + ir[1, 2])) / z
    x2, y2 = x * x, y * y
    r2, xy2 = x2 + y2, 2 * x * y
    kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
    xd = x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * xy2
    return K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]


def undistort(img: torch.Tensor, camera_matrix: np.ndarray, dist_coeffs) -> torch.Tensor:
    """``cv2.undistort(img, K, dist)`` for a uint8 ``[H, W, C]`` tensor:
    OpenCV builds fixed-point maps (``CV_16SC2``) and remaps through them
    (:func:`_remap_fixed_u8`)."""
    _check_u8(img, "undistort")
    H, W, _ = img.shape
    return _remap_fixed_u8(img, *undistort_map(camera_matrix, dist_coeffs, (W, H)))


class Undistorter:
    """Cached-map undistortion (upstream ``data_process.py``): the maps of
    ``cv2.initUndistortRectifyMap(..., CV_32FC1)`` for one camera and image
    size, kept on the image's device, and ``cv2.remap`` through them
    (:func:`remap_u8`)."""

    def __init__(self):
        self._maps = None
        self._key = None

    def __call__(self, img: torch.Tensor, camera_matrix, dist_coeffs) -> torch.Tensor:
        _check_u8(img, "Undistorter")
        K = np.asarray(camera_matrix, np.float64)
        key = (K.tobytes(), np.asarray(dist_coeffs, np.float64).tobytes(), tuple(img.shape),
               str(img.device))
        if key != self._key:
            H, W, _ = img.shape
            mx, my = undistort_map(K, dist_coeffs, (W, H))
            self._maps = tuple(torch.as_tensor(m.astype(np.float32), device=img.device)
                               for m in (mx, my))
            self._key = key
        return remap_u8(img, *self._maps)


def normalize_face(
    img: torch.Tensor,
    face_model_3d: np.ndarray,
    rvec: np.ndarray,
    tvec: np.ndarray,
    camera_matrix: np.ndarray,
    img_dim: int = 512,
    focal_norm: float = 1600.0,
    distance_norm: float = 680.0,
    face_center: Optional[np.ndarray] = None,
) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Warp the uint8 image ``img`` ``[H, W, 3]`` to the normalized virtual
    camera (focal ``focal_norm``, at ``distance_norm`` from the face centre,
    its x axis along the head's, looking at the face centre).  Returns
    ``(warped [img_dim, img_dim, 3] on img's device, R [3, 3], W [3, 3])``:
    the normalization rotation and the homography applied."""
    hR = rodrigues(rvec)
    fc = (face_center_from_pose(face_model_3d, rvec, tvec) if face_center is None
          else np.asarray(face_center, np.float64).reshape(3, 1))
    distance = float(np.linalg.norm(fc))
    cam_norm = np.array([[focal_norm, 0, img_dim / 2], [0, focal_norm, img_dim / 2], [0, 0, 1.0]])
    S = np.diag([1.0, 1.0, distance_norm / distance])
    forward = (fc / distance).reshape(3)
    down = np.cross(forward, hR[:, 0])
    down /= np.linalg.norm(down)
    right = np.cross(down, forward)
    right /= np.linalg.norm(right)
    R = np.stack([right, down, forward], axis=0)
    W = cam_norm @ S @ (R @ np.linalg.inv(np.asarray(camera_matrix, np.float64)))
    return warp_perspective(img, W, (img_dim, img_dim)), R, W


def _linear_taps(n_src: int, n_dst: int):
    """cv2's source index and fraction per destination pixel of one axis:
    ``f = (d + 0.5) * scale - 0.5`` rounded to f32, its floor and the rest."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, f - s.astype(np.float32)


def _area_up_taps(n_src: int, n_dst: int):
    """INTER_AREA's taps where it enlarges an axis (cv2 then runs its
    linear resize with these): ``s = floor(d * scale)``, ``f = (d + 1) -
    (s + 1) / scale`` rounded to f32, 0 where not positive, else its
    fractional part."""
    inv = n_dst / n_src
    scale = 1.0 / inv
    d = np.arange(n_dst)
    s = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    return s, f


def _coefs(f: np.ndarray) -> np.ndarray:
    """The two 11-bit weights ``(1 - f, f) * 2048``, rounded half to even as
    ``saturate_cast<short>`` rounds, ``[2, n]``."""
    return np.rint(np.stack([np.float32(1) - f, f]) * np.float32(2048)).astype(np.int32)


def _resize_fixed_u8(img: torch.Tensor, taps_x, taps_y) -> torch.Tensor:
    """cv2's fixed-point two-pass resize of a uint8 image given each axis'
    source indices and fractions.  Columns: the source index clamped to the
    image with its weight moved to the edge pixel; a pass in integers with
    weights ``round(2048 (1 - f))`` and ``round(2048 f)``.  Rows: both
    source rows clamped, the weights kept, and each product taken as ``(b *
    (r >> 4)) >> 16`` before ``(sum + 2) >> 2``."""
    H, W, _ = img.shape
    dev = img.device
    sx, fx = taps_x
    fx = fx.copy()
    edge = (sx < 0) | (sx >= W - 1)
    fx[edge] = 0
    sx = np.clip(sx, 0, W - 1)
    a = torch.as_tensor(_coefs(fx), device=dev)[:, None, :, None]
    src = img.to(torch.int32)
    rows = (src[:, torch.as_tensor(sx, device=dev)] * a[0]
            + src[:, torch.as_tensor(np.minimum(sx + 1, W - 1), device=dev)] * a[1])
    sy, fy = taps_y
    b = torch.as_tensor(_coefs(fy), device=dev)[:, :, None, None]
    r0 = rows[torch.as_tensor(np.clip(sy, 0, H - 1), device=dev)] >> 4
    r1 = rows[torch.as_tensor(np.clip(sy + 1, 0, H - 1), device=dev)] >> 4
    out = (((b[0] * r0) >> 16) + ((b[1] * r1) >> 16) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)


def resize_linear_u8(img: torch.Tensor, dsize: Tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(img, dsize)`` (INTER_LINEAR) for a uint8 ``[H, W, C]``
    tensor, on its device (:func:`_resize_fixed_u8` with the taps
    ``(d + 0.5) * scale - 0.5``).  ``dsize`` is ``(width, height)``."""
    _check_u8(img, "resize_linear_u8")
    H, W, _ = img.shape
    w_out, h_out = dsize
    return _resize_fixed_u8(img, _linear_taps(W, w_out), _linear_taps(H, h_out))


def _area_table(n_src: int, n_dst: int):
    """``computeResizeAreaTab``: per destination pixel the source pixels its
    cell covers and their f32 weights (the covered share of each over the
    cell's width), laid out ``[k, n_dst]`` for the k-th term of each
    (weight 0 where a pixel has fewer terms)."""
    scale = n_src / n_dst
    terms = []
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, n_src - 1)
        s1 = min(s1, s2)
        t = []
        if s1 - f1 > 1e-3:
            t.append((s1 - 1, (s1 - f1) / cell))
        t += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            t.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        terms.append(t)
    n = max(len(t) for t in terms)
    idx = np.zeros((n, n_dst), np.int64)
    wgt = np.zeros((n, n_dst), np.float32)
    for d, t in enumerate(terms):
        for k, (s, a) in enumerate(t):
            idx[k, d], wgt[k, d] = s, a
    return idx, wgt


def resize_area_u8(img: torch.Tensor, dsize: Tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(img, dsize, interpolation=INTER_AREA)`` for a uint8
    ``[H, W, C]`` tensor, on its device.  Enlarging either axis: the linear
    resize with :func:`_area_up_taps`.  Shrinking both by whole factors:
    the block sums, ``(s + 2) >> 2`` for 2 x 2 blocks and else ``s`` times
    the f32 ``1 / area`` rounded half to even.  Otherwise OpenCV's area
    filter: each row's terms summed in f32 in OpenCV's order (``buf +=
    src * alpha``), then the rows' (``sum += beta * buf``), rounded half to
    even."""
    _check_u8(img, "resize_area_u8")
    H, W, C = img.shape
    w_out, h_out = dsize
    sx, sy = W / w_out, H / h_out
    if sx < 1 or sy < 1:
        return _resize_fixed_u8(img, _area_up_taps(W, w_out), _area_up_taps(H, h_out))
    ix, iy = int(round(sx)), int(round(sy))
    if abs(sx - ix) < np.finfo(np.float64).eps and abs(sy - iy) < np.finfo(np.float64).eps:
        s = img[: h_out * iy, : w_out * ix].to(torch.int64).reshape(h_out, iy, w_out, ix, C)
        s = s.sum((1, 3))
        if (ix, iy) == (2, 2):
            return ((s + 2) >> 2).to(torch.uint8)
        out = s.to(torch.float32) * torch.tensor(np.float32(1.0 / (ix * iy)))
        return torch.round(out).clamp(0, 255).to(torch.uint8)
    dev = img.device
    src = img.to(torch.float32)
    xi, xw = (torch.as_tensor(t, device=dev) for t in _area_table(W, w_out))
    buf = torch.zeros((H, w_out, C), dtype=torch.float32, device=dev)
    for k in range(xi.shape[0]):
        buf = buf + src[:, xi[k]] * xw[k][None, :, None]
    yi, yw = (torch.as_tensor(t, device=dev) for t in _area_table(H, h_out))
    out = buf[yi[0]] * yw[0][:, None, None]
    for k in range(1, yi.shape[0]):
        out = out + buf[yi[k]] * yw[k][:, None, None]
    return torch.round(out).clamp(0, 255).to(torch.uint8)


# (focal_norm, distance_norm) of the virtual camera per dataset at
# preprocessing time (upstream pre_processing/data_process.py: ETH-XGaze
# 1600, MPIIFaceGaze 1400, Columbia 1600, GazeCapture 1200, all at 680)
NORMALIZATION_PRESETS = {
    "eth_xgaze": (1600.0, 680.0),
    "mpii_face_gaze": (1400.0, 680.0),
    "columbia": (1600.0, 680.0),
    "gaze_capture": (1200.0, 680.0),
}


def normalize_gaze_vector(gaze_vec: np.ndarray, R: np.ndarray) -> np.ndarray:
    """A gaze vector rotated into the normalized camera and made unit."""
    g = np.asarray(R) @ np.asarray(gaze_vec, np.float64).reshape(3, 1)
    return (g / np.linalg.norm(g)).reshape(3)


def vector_to_pitchyaw(v: np.ndarray) -> np.ndarray:
    """A 3D gaze vector -> ``(pitch, yaw)`` f32: ``asin(y)``, ``atan2(x, z)``
    of the unit vector."""
    v = np.asarray(v, np.float64).reshape(3)
    v = v / np.linalg.norm(v)
    return np.array([np.arcsin(v[1]), np.arctan2(v[0], v[2])], np.float32)


def gaze_to_head_coordinates(gaze_pitchyaw: np.ndarray, head_rotation: np.ndarray) -> np.ndarray:
    """A camera-frame gaze ``(pitch, yaw)`` -> the head frame's: its f32
    vector turned by the inverse head rotation."""
    from gazenerf_tpu_torch.eval.metrics import pitchyaw_to_vector

    py = torch.as_tensor(np.asarray(gaze_pitchyaw, np.float32)[None])
    return vector_to_pitchyaw(np.asarray(head_rotation).T @ pitchyaw_to_vector(py)[0].numpy())


def normalized_head_pose(R_norm: np.ndarray, hR: np.ndarray) -> np.ndarray:
    """``(pitch, yaw)`` f32 of the head in the normalized camera: of the z
    column of ``R_norm @ hR``."""
    z = (np.asarray(R_norm) @ np.asarray(hR))[:, 2]
    return np.array([np.arcsin(z[1]), np.arctan2(z[0], z[2])], np.float32)
