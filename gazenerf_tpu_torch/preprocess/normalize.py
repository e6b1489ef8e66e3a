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

The pose is host work in numpy (a few dozen 6x6 solves); the warp runs
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
    if img.dtype != torch.uint8 or img.dim() != 3:
        raise ValueError(f"warp_perspective takes a uint8 [H, W, C] image, got {img.dtype} "
                         f"{tuple(img.shape)}")
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


def warp_affine(img: torch.Tensor, M: np.ndarray, dsize: Tuple[int, int]) -> torch.Tensor:
    """``cv2.warpAffine(img, M, dsize)`` for a uint8 ``[H, W, C]`` tensor
    (bilinear, border 0), on the tensor's device: the inverse of the ``[2,
    3]`` map as ``cv2.invertAffineTransform`` computes it in float64, then
    f32; destination pixel ``(x, y)`` reads the source at ``fma(m00, x, m01 y
    + m02)``, ``fma(m10, x, m11 y + m12)``; the four neighbours (0 outside
    the image) are lerped along x, then y, each step ``fma(p1 - p0, a,
    p0)``; the result rounded half to even.  ``dsize`` is ``(width,
    height)``."""
    if img.dtype != torch.uint8 or img.dim() != 3:
        raise ValueError(f"warp_affine takes a uint8 [H, W, C] image, got {img.dtype} "
                         f"{tuple(img.shape)}")
    H, W, _ = img.shape
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


def _coefs(f: np.ndarray) -> np.ndarray:
    """The two 11-bit weights ``(1 - f, f) * 2048``, rounded half to even as
    ``saturate_cast<short>`` rounds, ``[2, n]``."""
    return np.rint(np.stack([np.float32(1) - f, f]) * np.float32(2048)).astype(np.int32)


def resize_linear_u8(img: torch.Tensor, dsize: Tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(img, dsize)`` (INTER_LINEAR) for a uint8 ``[H, W, C]``
    tensor, on its device.  ``dsize`` is ``(width, height)``.  Columns: the
    source index clamped to the image with its weight moved to the edge
    pixel; a pass in integers with weights ``round(2048 (1 - f))`` and
    ``round(2048 f)``.  Rows: both source rows clamped, the weights kept,
    and each product taken as ``(b * (r >> 4)) >> 16`` before ``(sum + 2) >>
    2``."""
    if img.dtype != torch.uint8 or img.dim() != 3:
        raise ValueError(f"resize_linear_u8 takes a uint8 [H, W, C] image, got {img.dtype} "
                         f"{tuple(img.shape)}")
    H, W, _ = img.shape
    w_out, h_out = dsize
    dev = img.device
    sx, fx = _linear_taps(W, w_out)
    edge = (sx < 0) | (sx >= W - 1)
    fx[edge] = 0
    sx = np.clip(sx, 0, W - 1)
    a = torch.as_tensor(_coefs(fx), device=dev)[:, None, :, None]
    src = img.to(torch.int32)
    rows = (src[:, torch.as_tensor(sx, device=dev)] * a[0]
            + src[:, torch.as_tensor(np.minimum(sx + 1, W - 1), device=dev)] * a[1])
    sy, fy = _linear_taps(H, h_out)
    b = torch.as_tensor(_coefs(fy), device=dev)[:, :, None, None]
    r0 = rows[torch.as_tensor(np.clip(sy, 0, H - 1), device=dev)] >> 4
    r1 = rows[torch.as_tensor(np.clip(sy + 1, 0, H - 1), device=dev)] >> 4
    out = (((b[0] * r0) >> 16) + ((b[1] * r1) >> 16) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)
