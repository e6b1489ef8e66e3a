"""Image-quality and gaze metrics of the evaluation protocols.

The port's counterpart of the JAX package's ``eval/metrics.py`` (upstream
``utils/metrics_utils.py``: piq's SSIM, PSNR, LPIPS and FID, and the
angular and identity metrics).  Images are NHWC ``[B, H, W, C]`` in [0, 1]
tensors on any device; every per-image metric returns ``[B]``.

* PSNR, L1 — closed form.
* SSIM — the Gaussian window (11, sigma 1.5, k1 0.01, k2 0.03, valid),
  taken as an f32 separable sum of shifted images: the windowed moments
  cancel (``E[a^2] - E[a]^2``), and on near-flat images a TF32 or bf16
  window (cuDNN's default for f32 convolutions on Hopper) leaves noise far
  above ``c2`` = 9e-4 (the JAX package read SSIM = 6.3 under TPU bf16
  convolutions).  Elementwise f32 sums take no such shortcut.
* LPIPS — VGG16 features at five ReLU capture points, channel-normalized,
  a per-channel linear head, spatial mean, summed (:func:`make_lpips_fn`);
  :func:`lpips_like` is the uniform-weight distance over any features.
* FID — the Frechet distance between Gaussian fits of two feature sets
  (scipy's ``sqrtm``); the feature extractor is the caller's.
* gaze and head angular error through a frozen estimator, and the cosine
  similarity of face embeddings.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gazenerf_tpu_torch.models.vgg import VGG16Features, normalize_imagenet


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    mse = ((a - b) ** 2).mean(dim=(-3, -2, -1))
    return 10.0 * torch.log10(data_range**2 / mse.clamp_min(1e-12))


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean(dim=(-3, -2, -1))


def gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The normalized 1-D Gaussian ``[size]`` (the SSIM window is its outer
    product with itself)."""
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _window_sum(x: torch.Tensor, g: Sequence[float]) -> torch.Tensor:
    """Valid separable filtering of ``[B, H, W, C]`` by ``g`` along H and
    W, as sums of shifted f32 images."""
    k = len(g)
    H, W = x.shape[1] - k + 1, x.shape[2] - k + 1
    rows = sum(float(g[i]) * x[:, i:i + H] for i in range(k))
    return sum(float(g[j]) * rows[:, :, j:j + W] for j in range(k))


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0, kernel_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over ``[B, H, W, C]`` images (Gaussian window, valid), in
    true f32 whatever the TF32 settings."""
    g = gaussian_window(kernel_size, sigma).astype(np.float32)
    a, b = a.to(torch.float32), b.to(torch.float32)

    def filt(x):
        return _window_sum(x, g)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = filt(a), filt(b)
    mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sig_a = filt(a * a) - mu_a2
    sig_b = filt(b * b) - mu_b2
    sig_ab = filt(a * b) - mu_ab
    s = ((2 * mu_ab + c1) * (2 * sig_ab + c2)) / ((mu_a2 + mu_b2 + c1) * (sig_a + sig_b + c2))
    return s.mean(dim=(-3, -2, -1))


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-8)


def lpips_like(feats_fn: Callable, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Perceptual distance: the mean squared difference of unit-normalized
    feature maps, summed over the capture layers (LPIPS with uniform layer
    weights)."""
    total = 0.0
    for x, y in zip(feats_fn(a), feats_fn(b)):
        total = total + ((_unit(x) - _unit(y)) ** 2).sum(-1).mean(dim=(-2, -1))
    return total


# LPIPS capture points in VGG16: relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
LPIPS_CAPTURE = (1, 3, 6, 9, 12)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)


def make_lpips_fn(vgg_params, lin_weights: Optional[List[np.ndarray]] = None,
                  dtype: torch.dtype = torch.float32, device=None) -> Callable:
    """LPIPS (upstream ``piq.LPIPS()``, Zhang et al.'s "lin" variant):
    ``lpips(a, b) -> [B]`` for ``[B, H, W, 3]`` images in [0, 1].

    ``vgg_params``: a :class:`VGG16Features` state dict (see
    ``models.vgg.vgg_features_from_torch``); ``lin_weights``: five ``[C]``
    per-channel heads (:func:`lpips_lin_from_torch`), or None for 1.0 on
    every channel (a consistent relative metric, not the published one)."""
    vgg = VGG16Features(dtype=dtype, capture=LPIPS_CAPTURE)
    vgg.load_state_dict(vgg_params, strict=True)
    vgg.to(device).requires_grad_(False).eval()
    if lin_weights is None:
        lin_weights = [np.ones((c,), np.float32) for c in LPIPS_CHANNELS]
    lin = [torch.as_tensor(np.asarray(w, np.float32).reshape(-1), device=device)
           for w in lin_weights]

    @torch.no_grad()
    def lpips(a, b):
        fa = vgg(normalize_imagenet(a.to(dtype)))
        fb = vgg(normalize_imagenet(b.to(dtype)))
        total = 0.0
        for x, y, w in zip(fa, fb, lin):
            xn = x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-10)
            yn = y * torch.rsqrt((y * y).sum(-1, keepdim=True) + 1e-10)
            total = total + (((xn - yn) ** 2) * w.to(xn.dtype)).sum(-1).mean(dim=(-2, -1))
        return total.to(torch.float32)

    return lpips


def lpips_lin_from_torch(sd) -> List[np.ndarray]:
    """LPIPS "lin" heads -> five ``[C]`` arrays: the original repository's
    ``lin{i}.model.1.weight`` (``[1, C, 1, 1]``) keys, piq's list of
    tensors, or any dict whose weight values are the five heads in layer
    order."""
    if isinstance(sd, (list, tuple)):
        return [np.asarray(w).reshape(-1) for w in sd]
    keys = sorted(k for k in sd if k.endswith("weight"))
    return [np.asarray(sd[k]).reshape(-1) for k in keys]


def fid(feats_fn: Callable, images_a, images_b, batch_size: int = 8) -> float:
    """FID between two image sets through ``feats_fn`` (``[B, H, W, 3] ->
    [B, D]``), batches of ``batch_size``."""

    def run(images):
        out = []
        for i in range(0, len(images), batch_size):
            chunk = torch.stack([torch.as_tensor(im) for im in images[i:i + batch_size]])
            out.append(np.asarray(feats_fn(chunk).detach().cpu(), np.float64))
        return np.concatenate(out, 0)

    return frechet_distance(run(images_a), run(images_b))


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray, eps: float = 1e-6) -> float:
    """The Frechet distance between Gaussian fits of ``[N, D]`` feature sets
    (exact, scipy ``sqrtm``; an ``eps`` ridge where the product's root is
    not finite)."""
    import scipy.linalg

    mu1, mu2 = feats_a.mean(0), feats_b.mean(0)
    s1 = np.cov(feats_a, rowvar=False)
    s2 = np.cov(feats_b, rowvar=False)
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(s1 @ s2)
    if not np.isfinite(covmean).all():
        offset = np.eye(s1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((s1 + offset) @ (s2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean))


def identity_similarity(embed_fn: Callable, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The cosine similarity of face embeddings (upstream
    ``face_recognition/evaluation_similarity.py``)."""
    return (_unit(embed_fn(a)) * _unit(embed_fn(b))).sum(-1)


def pitchyaw_to_vector(pitchyaw: torch.Tensor) -> torch.Tensor:
    """``[B, 2]`` (pitch, yaw) -> ``[B, 3]`` unit gaze vectors."""
    s, c = torch.sin(pitchyaw), torch.cos(pitchyaw)
    return torch.stack([c[:, 0] * s[:, 1], s[:, 0], c[:, 0] * c[:, 1]], dim=1)


def angular_error_deg(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The angle in degrees between two batches of 3-vectors."""
    num = (a * b).sum(-1)
    den = (torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1)).clamp_min(eps)
    return torch.arccos((num / den).clamp(-1.0, 1.0)) * (180.0 / np.pi)


def gaze_and_head_error(estimator_fn: Callable, pred_img: torch.Tensor,
                        gt_img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Angular gaze and head-pose errors in degrees between an estimator's
    readings of two images (``estimator_fn(img) -> (gaze, head)``)."""
    g_pred, h_pred = estimator_fn(pred_img)
    g_gt, h_gt = estimator_fn(gt_img)
    return (angular_error_deg(pitchyaw_to_vector(g_gt), pitchyaw_to_vector(g_pred)),
            angular_error_deg(pitchyaw_to_vector(h_gt), pitchyaw_to_vector(h_pred)))
