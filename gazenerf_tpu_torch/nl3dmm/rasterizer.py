"""The differentiable mesh rasterizer: a tile-binned soft z-buffer, the port
of the JAX package's ``nl3dmm/rasterizer.py`` (which stands in for
upstream's PyTorch3D rasterizer and soft shader,
``surface_fitting/nl3dmm/nl3dmm_renderer.py``).

* The screen is cut into tiles of ``tile_size`` pixels; each tile keeps the
  ``tris_per_tile`` triangles whose bounding boxes overlap it most, ranked
  by a stable sort of the overlap areas along the triangles (ties, as the
  many triangles that cover a whole tile, keep the lower triangle id: the
  JAX package's ``jnp.argsort`` order, which ``torch.topk`` does not keep).
* Per (tile, pixel, kept triangle): barycentric coordinates, a sigmoid
  influence of the signed distance inside, the depth; a softmax over
  ``-z / gamma`` with the background as a far candidate blends the
  colours (SoftRas aggregation), so gradients reach vertices across
  silhouettes.

Everything is batched over a leading mesh dimension (the JAX package
``vmap``s one mesh); the binning runs on detached positions (indices carry
no gradient).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class RasterSettings(NamedTuple):
    image_size: int = 128
    tile_size: int = 16
    tris_per_tile: int = 64
    sigma: float = 1e-4  # silhouette softness (barycentric units)
    gamma: float = 1e-2  # z-softmax temperature
    z_near: float = 0.05
    z_far: float = 50.0  # the background's pseudo-depth in the blend


def project_vertices(vertices: torch.Tensor, w2c_R: torch.Tensor, w2c_T: torch.Tensor,
                     inmat: torch.Tensor) -> torch.Tensor:
    """World -> screen: ``[B, V, 3]`` -> ``[B, V, 3]`` of (x px, y px,
    depth)."""
    cam = torch.einsum("bij,bvj->bvi", w2c_R, vertices) + w2c_T[:, None, :]
    z = cam[..., 2:].clamp_min(1e-6)
    pix = torch.einsum("bij,bvj->bvi", inmat, cam / z)
    return torch.cat([pix[..., :2], cam[..., 2:]], dim=-1)


def tile_areas(screen: torch.Tensor, tris: torch.Tensor, s: RasterSettings) -> torch.Tensor:
    """Each triangle's bounding-box overlap area with each tile, ``[B,
    ntiles (y-major), T]`` for ``screen`` ``[B, V, 3]``."""
    nt = s.image_size // s.tile_size
    ts = float(s.tile_size)
    xy = screen[:, tris.long(), :2]  # [B, T, 3, 2]
    tmin, tmax = xy.amin(2), xy.amax(2)
    t0 = torch.arange(nt, dtype=screen.dtype, device=screen.device) * s.tile_size

    def overlap(lo, hi):  # [B, T, nt]
        return (torch.minimum(hi[..., None], t0 + ts) - torch.maximum(lo[..., None], t0)).clamp(
            0.0, ts)

    ox = overlap(tmin[..., 0], tmax[..., 0])
    oy = overlap(tmin[..., 1], tmax[..., 1])
    return (oy.transpose(1, 2)[:, :, None, :] * ox.transpose(1, 2)[:, None, :, :]).reshape(
        screen.shape[0], nt * nt, -1)


def _bin_triangles(screen: torch.Tensor, tris: torch.Tensor, s: RasterSettings) -> torch.Tensor:
    """The ``tris_per_tile`` triangle ids per tile by bounding-box overlap
    area, ``-1`` where the overlap is 0: ``[B, ntiles, K]`` for ``screen``
    ``[B, V, 3]``.  The stable sort runs along the triangles, the last
    axis."""
    area = tile_areas(screen, tris, s)
    order = torch.argsort(-area, dim=-1, stable=True)[..., : s.tris_per_tile]
    top = torch.gather(area, -1, order)
    return torch.where(top > 0, order, torch.full_like(order, -1))


def rasterize_soft(screen: torch.Tensor, colors: torch.Tensor, tris: torch.Tensor,
                   s: RasterSettings, bg_color: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft-rasterize meshes: ``screen`` ``[B, V, 3]`` (x px, y px, depth),
    ``colors`` ``[B, V, 3]``, ``tris`` ``[T, 3]`` -> ``(image [B, H, W, 3],
    alpha [B, H, W])``."""
    B = screen.shape[0]
    H, ts, K = s.image_size, s.tile_size, s.tris_per_tile
    nt = H // ts
    dev, f32 = screen.device, screen.dtype
    ids = _bin_triangles(screen.detach(), tris, s)  # [B, ntiles, K]
    tri_v = tris.long()[ids.clamp_min(0)]  # [B, ntiles, K, 3]
    b = torch.arange(B, device=dev)[:, None, None]
    p0, p1, p2 = (screen[b, tri_v[..., k]] for k in range(3))  # [B, ntiles, K, 3]
    c0, c1, c2 = (colors[b, tri_v[..., k]] for k in range(3))

    # pixel centres per tile: [ntiles, px, (x, y)]
    within = torch.arange(ts, dtype=f32, device=dev) + 0.5
    wy, wx = torch.meshgrid(within, within, indexing="ij")
    origin = torch.arange(nt, device=dev) * ts
    oy, ox = torch.meshgrid(origin, origin, indexing="ij")
    px = ox.reshape(-1, 1) + wx.reshape(1, -1)
    py = oy.reshape(-1, 1) + wy.reshape(1, -1)
    P = torch.stack([px, py], dim=-1)[None, :, :, None, :]  # [1, ntiles, px, 1, 2]

    def edge(a, c, p):
        return (p[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1]) - (
            p[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0])

    A, Bv, Cv = (p[:, :, None, :, :2] for p in (p0, p1, p2))  # [B, ntiles, 1, K, 2]
    area = edge(A, Bv, Cv)  # [B, ntiles, 1, K]
    denom = torch.where(area.abs() < 1e-9, torch.full_like(area, 1e-9), area)
    b0, b1, b2 = edge(Bv, Cv, P) / denom, edge(Cv, A, P) / denom, edge(A, Bv, P) / denom

    influence = torch.sigmoid(torch.minimum(torch.minimum(b0, b1), b2) / s.sigma)
    z = b0 * p0[:, :, None, :, 2] + b1 * p1[:, :, None, :, 2] + b2 * p2[:, :, None, :, 2]
    valid = (ids[:, :, None, :] >= 0) & (z > s.z_near)
    influence = torch.where(valid, influence, torch.zeros_like(influence))

    # softmax over -z with the background as a far candidate; only
    # near-inside candidates compete for zmax (a pixel far outside a
    # triangle extrapolates its z arbitrarily)
    bg_score = -s.z_far / s.gamma
    bg = torch.tensor(bg_score, dtype=f32, device=dev)
    competing = valid & (influence > 1e-4)
    zinv = torch.where(competing, -z / s.gamma, bg)
    # amax splits the gradient among ties, as jnp.max; so does maximum
    zmax = torch.maximum(torch.amax(zinv, dim=-1, keepdim=True), bg)
    expz = influence * torch.exp(zinv - zmax)
    denom_w = expz.sum(-1) + torch.exp(bg - zmax[..., 0]) + 1e-12
    wgt = expz / denom_w[..., None]  # [B, ntiles, px, K]

    col = (b0[..., None] * c0[:, :, None] + b1[..., None] * c1[:, :, None]
           + b2[..., None] * c2[:, :, None])  # [B, ntiles, px, K, 3]
    img = torch.einsum("btpk,btpkc->btpc", wgt, col)
    alpha = wgt.sum(-1)
    img = img + (1.0 - alpha[..., None]) * bg_color

    # untile: [B, nt, nt, ts, ts, ...] -> [B, H, W, ...]
    img = img.reshape(B, nt, nt, ts, ts, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, H, H, 3)
    alpha = alpha.reshape(B, nt, nt, ts, ts).permute(0, 1, 3, 2, 4).reshape(B, H, H)
    return img, alpha


def render_mesh(vertices: torch.Tensor, colors: torch.Tensor, tris: torch.Tensor,
                w2c_R: torch.Tensor, w2c_T: torch.Tensor, inmat: torch.Tensor,
                settings: RasterSettings, bg_color: float = 1.0):
    """Batched render: ``[B, V, 3]`` vertices and colours -> ``(image [B, H,
    W, 3], alpha [B, H, W])``."""
    screen = project_vertices(vertices, w2c_R, w2c_T, inmat)
    return rasterize_soft(screen, colors, tris, settings, bg_color)


def project_landmarks(vertices: torch.Tensor, landmark_index: torch.Tensor, w2c_R: torch.Tensor,
                      w2c_T: torch.Tensor, inmat: torch.Tensor) -> torch.Tensor:
    """``[B, 68, 2]`` projected landmark pixels."""
    screen = project_vertices(vertices, w2c_R, w2c_T, inmat)
    return screen[:, landmark_index.long(), :2]
