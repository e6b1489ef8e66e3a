"""Ray generation and stratified sampling in the z-plane-bounded volume.

Port of the JAX package's ``ops/rays.py``: channels-last rays ``[B, R, 3]``
and sample points ``[B, R, S, 3]``, the upstream ``ray_l = -1/d_z``
normalisation and the plane-relative z parameterisation.  The render
samples evenly spaced edges; training jitters each edge within its
mid-point bounds (draws from a ``torch.Generator``, or handed in).  The
hierarchical sampler is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RayBundle(NamedTuple):
    """Per-ray geometry (channels-last)."""

    origins: torch.Tensor  # [B, R, 3]
    directions: torch.Tensor  # [B, R, 3] unit-norm
    ray_l: torch.Tensor  # [B, R]  z-plane scale = -1 / d_z


class SampleSet(NamedTuple):
    """Samples along rays."""

    pts: torch.Tensor  # [B, R, S, 3]
    dirs: torch.Tensor  # [B, R, S, 3]
    zvals: torch.Tensor  # [B, R, S]   plane-relative z values
    z_dists: torch.Tensor  # [B, R, S] world-space segment lengths
    rays: RayBundle


def pixel_grid(featmap_size: int, device=None) -> torch.Tensor:
    """``[R, 2]`` (x, y) pixel coordinates, row-major: ``x = i % W``,
    ``y = i // W``."""
    idx = torch.arange(featmap_size * featmap_size, device=device)
    x = (idx % featmap_size).float()
    y = torch.div(idx, featmap_size, rounding_mode="floor").float()
    return torch.stack([x, y], dim=-1)


def generate_rays(
    batch_xy: torch.Tensor,
    Rmats: torch.Tensor,
    Tvecs: torch.Tensor,
    inv_inmats: torch.Tensor,
) -> RayBundle:
    """Camera-to-world ray directions ``R @ K^-1 @ [x, y, 1]``.

    Args:
      batch_xy: ``[B, R, 2]`` pixel coordinates.
      Rmats: ``[B, 3, 3]`` camera-to-world rotations.
      Tvecs: ``[B, 3]`` or ``[B, 3, 1]`` camera centres (world frame).
      inv_inmats: ``[B, 3, 3]`` inverse intrinsics at featmap resolution.
    """
    B, R, _ = batch_xy.shape
    M = torch.bmm(Rmats, inv_inmats)  # [B, 3, 3]
    ones = torch.ones((B, R, 1), dtype=M.dtype, device=batch_xy.device)
    xyz = torch.cat([batch_xy.to(M.dtype), ones], dim=-1)  # [B, R, 3], the camera's dtype
    d = torch.bmm(xyz, M.transpose(1, 2))  # [B, R, 3]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    # upstream computes ray_l = |d| and then overwrites it with -1/d_z;
    # only the overwrite survives
    ray_l = -1.0 / d[..., 2]
    origins = Tvecs.reshape(B, 1, 3).expand(B, R, 3)
    return RayBundle(origins=origins, directions=d, ray_l=ray_l)


def _samples_from_zvals(zvals: torch.Tensor, rays: RayBundle) -> SampleSet:
    """``[B, R, S+1]`` z-plane edges -> sample points and segment lengths."""
    z_dists = (zvals[..., 1:] - zvals[..., :-1]) * rays.ray_l[..., None]
    z = zvals[..., :-1]  # [B, R, S]
    scale = (rays.ray_l[..., None] * z)[..., None]  # [B, R, S, 1]
    pts = rays.origins[..., None, :] + rays.directions[..., None, :] * scale
    dirs = rays.directions[..., None, :].expand(pts.shape)
    return SampleSet(pts=pts, dirs=dirs, zvals=z, z_dists=z_dists, rays=rays)


def stratified_zvals(
    rays: RayBundle,
    num_samples: int,
    world_z1: float,
    world_z2: float,
    t_rand: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[B, R, S+1]`` z-plane sample edges, linear in plane-relative depth
    ``rela_z = o_z - world_z`` between the two bounding planes.  With
    ``t_rand`` (uniform draws in [0, 1), shape ``[B, R, S+1]``) each edge
    moves within its mid-point bounds, the upstream stratified jitter."""
    oz = rays.origins[..., 2]  # [B, R]
    rela_z1 = (oz - world_z1)[..., None]
    rela_z2 = (oz - world_z2)[..., None]
    t = torch.linspace(0.0, 1.0, num_samples + 1, dtype=oz.dtype, device=oz.device)
    zvals = rela_z1 * (1.0 - t) + rela_z2 * t  # [B, R, S+1]
    if t_rand is not None:
        mids = 0.5 * (zvals[..., 1:] + zvals[..., :-1])
        upper = torch.cat([mids, zvals[..., -1:]], dim=-1)
        lower = torch.cat([zvals[..., :1], mids], dim=-1)
        zvals = lower + (upper - lower) * t_rand
    return zvals


def sample_coarse(
    batch_xy: torch.Tensor,
    Rmats: torch.Tensor,
    Tvecs: torch.Tensor,
    inv_inmats: torch.Tensor,
    num_samples: int,
    world_z1: float,
    world_z2: float,
    generator: Optional[torch.Generator] = None,
    t_rand: Optional[torch.Tensor] = None,
) -> SampleSet:
    """Rays, then samples between the two z planes: evenly spaced, or
    jittered when ``generator`` (draws ``t_rand`` on the rays' device) or
    the draws ``t_rand`` themselves are given."""
    rays = generate_rays(batch_xy, Rmats, Tvecs, inv_inmats)
    if t_rand is None and generator is not None:
        B, R = rays.ray_l.shape
        t_rand = torch.rand(
            (B, R, num_samples + 1), generator=generator,
            dtype=rays.ray_l.dtype, device=rays.ray_l.device,
        )
    zvals = stratified_zvals(rays, num_samples, world_z1, world_z2, t_rand)
    return _samples_from_zvals(zvals, rays)
