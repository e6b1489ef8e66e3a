"""The NL-3DMM face model: a nonlinear geometry decoder, a linear texture
model and second-order spherical-harmonics lighting; the port of the JAX
package's ``nl3dmm/face_model.py`` (upstream
``surface_fitting/nl3dmm/face_models.py`` and ``nl3dmm_renderer.py``).

The basis and topology ship apart from the code (upstream's
``nl3dmm_dict.pkl`` and ``nl_3dmm_topo_info.npz``, the decoder's
``nl3dmm_net_dict.pth``); :func:`random_basis` builds a basis of the same
structure (a Fibonacci sphere and its hull's triangles) from a seed, the
JAX package's for the same arguments.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn


class BasisData(NamedTuple):
    mean_shape: torch.Tensor  # [V, 3]
    shape_basis: torch.Tensor  # [V*3, Ds]   (identity ++ expression columns)
    mean_texture: torch.Tensor  # [V, 3]  (0..255, upstream's convention)
    texture_basis: torch.Tensor  # [V*3, Dt]
    triangles: torch.Tensor  # [T, 3] int64
    landmark_index: torch.Tensor  # [68] int64 vertex ids
    # per-dimension texture-code sigmas: the fitted code is normalized, the
    # texture model rescales it (upstream face_models.py:86-91)
    sig_tex: Optional[torch.Tensor] = None  # [Dt]
    skinmask: Optional[torch.Tensor] = None  # [V] 0/1

    def to(self, device) -> "BasisData":
        return BasisData(*(None if t is None else t.to(device) for t in self))


def _basis(mean_shape, shape_basis, mean_texture, texture_basis, triangles, landmark_index,
           sig_tex, skinmask) -> BasisData:
    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32))

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64))

    return BasisData(f32(mean_shape), f32(shape_basis), f32(mean_texture), f32(texture_basis),
                     i64(triangles), i64(landmark_index), f32(sig_tex), f32(skinmask))


def random_basis(n_vertices: int = 1024, n_tris: int = 2000, iden_dims: int = 100,
                 expr_dims: int = 79, text_dims: int = 100, seed: int = 0) -> BasisData:
    """A synthetic basis with a valid topology, on the CPU: the Fibonacci
    sphere's ``n_vertices`` points as the mean shape, the first ``n_tris``
    triangles of their convex hull (a closed mesh has ``2 V - 4``), seeded
    normal shape (x 0.02) and texture (x 10) bases, a grey mean texture,
    68 distinct landmark vertices and a random skin mask."""
    from scipy.spatial import ConvexHull

    rng = np.random.default_rng(seed)
    i = np.arange(n_vertices)
    phi = np.arccos(1 - 2 * (i + 0.5) / n_vertices)
    theta = np.pi * (1 + 5**0.5) * i
    mean = np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
                    axis=-1)
    tris = ConvexHull(mean).simplices[:n_tris]
    Ds = iden_dims + expr_dims
    shape_basis = rng.standard_normal((n_vertices * 3, Ds)).astype(np.float32) * 0.02
    texture_basis = rng.standard_normal((n_vertices * 3, text_dims)).astype(np.float32) * 10.0
    landmarks = rng.choice(n_vertices, 68, replace=False)
    skinmask = (rng.random(n_vertices) > 0.5).astype(np.float32)
    return _basis(mean, shape_basis, np.full((n_vertices, 3), 153.0), texture_basis, tris,
                  landmarks, np.ones(text_dims), skinmask)


def load_basis(npz_path: str) -> BasisData:
    """A basis from one npz holding every field (``sig_tex`` and
    ``skinmask`` default to ones)."""
    d = np.load(npz_path)
    Dt = d["texture_basis"].shape[-1]
    V = d["mean_shape"].size // 3
    return _basis(d["mean_shape"].reshape(-1, 3), d["shape_basis"],
                  d["mean_texture"].reshape(-1, 3), d["texture_basis"], d["triangles"],
                  d["landmark_index"],
                  np.asarray(d["sig_tex"] if "sig_tex" in d else np.ones(Dt)).reshape(-1),
                  np.asarray(d["skinmask"] if "skinmask" in d else np.ones(V)).reshape(-1))


def load_topology(npz_path: str):
    """Upstream's topology blob (``nl_3dmm_topo_info.npz``) -> ``(fv_indices
    [T, 3] int32, corr_vf_indices [V, K] int32)``: the triangles and the
    padded per-vertex table of adjacent faces, whose padding is the
    sentinel ``T`` (see :func:`vertex_normals`)."""
    z = np.load(npz_path)
    fv = np.asarray(z["fv_indices"], np.int32)
    corr = np.asarray(z["corr_vf_indices"], np.int32)
    V = int(fv.max()) + 1
    if corr.shape[0] != V:
        raise ValueError(f"corr_vf_indices has {corr.shape[0]} rows for {V} vertices")
    if corr.max() > fv.shape[0]:
        raise ValueError("the padding sentinel of corr_vf_indices must be the face count")
    return fv, corr


def load_basis_pkl(pkl_path: str, topo_npz_path: Optional[str] = None, iden_dims: int = 100,
                   expr_dims: int = 79, landmark_pkl_path: Optional[str] = None,
                   skinmask_npy_path: Optional[str] = None) -> BasisData:
    """Upstream's basis pickle (``nl3dmm_dict.pkl``: ``mu`` [3V], ``b`` [Ds,
    3V], ``mu_tex`` [3V], ``b_tex`` [Dt, 3V], ``sig_tex``), the triangles
    from the topology npz, the landmark vertex ids from ``LandMarkInfo.pkl``
    (else 68 spread evenly) and ``skinmask.npy`` (else ones)."""
    import pickle

    with open(pkl_path, "rb") as f:
        d = pickle.load(f)
    mu = np.asarray(d["mu"], np.float32).reshape(-1)
    b = np.asarray(d["b"], np.float32)
    mu_tex = np.asarray(d["mu_tex"], np.float32).reshape(-1)
    b_tex = np.asarray(d["b_tex"], np.float32)
    sig_tex = np.asarray(d.get("sig_tex", np.ones(b_tex.shape[0])), np.float32).reshape(-1)
    V = mu.shape[0] // 3
    tris = load_topology(topo_npz_path)[0] if topo_npz_path is not None else np.zeros((1, 3))
    if landmark_pkl_path is not None:
        with open(landmark_pkl_path, "rb") as f:
            lm = np.asarray(pickle.load(f), np.int64).reshape(-1)[:68]
    else:
        lm = np.linspace(0, V - 1, 68).astype(np.int64)
    skinmask = (np.asarray(np.load(skinmask_npy_path), np.float32).reshape(-1)
                if skinmask_npy_path is not None else np.ones(V, np.float32))
    return _basis(mu.reshape(V, 3), b.T, mu_tex.reshape(V, 3), b_tex.T, tris, lm, sig_tex,
                  skinmask)


class GeometryDecoder(nn.Module):
    """Upstream's ``NonLinear_3DMM`` geometry path: ``geometry =
    geo_fc3(relu(geo_fc2(code)))``, ``geo_fc2`` Linear(Ds -> hidden),
    ``geo_fc3`` Linear(hidden -> 3V) whose bias is the mean shape and whose
    first ``Ds`` input columns are the PCA shape basis (columns Ds..500 are
    0.001, the rest torch's default draw).  Drawn from ``seed`` on the CPU;
    upstream's pretrained ``nl3dmm_net_dict.pth`` loads through
    :func:`geometry_decoder_params_from_torch`."""

    def __init__(self, basis: BasisData, hidden: int = 1024, seed: int = 0):
        super().__init__()
        V3, Ds = basis.shape_basis.shape
        self.geo_fc2 = nn.Linear(Ds, hidden)
        self.geo_fc3 = nn.Linear(hidden, V3)
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            b1 = 1.0 / np.sqrt(Ds)
            self.geo_fc2.weight.copy_(torch.rand(hidden, Ds, generator=g) * (2 * b1) - b1)
            self.geo_fc2.bias.copy_(torch.rand(hidden, generator=g) * (2 * b1) - b1)
            w = (torch.rand(V3, hidden, generator=g) * 2 - 1) / np.sqrt(hidden)
            w[:, :Ds] = basis.shape_basis.cpu()
            w[:, Ds:min(500, hidden)] = 0.001
            self.geo_fc3.weight.copy_(w)
            self.geo_fc3.bias.copy_(basis.mean_shape.cpu().reshape(-1))

    def forward(self, shape_code: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
        """``shape_code`` ``[B, Ds]`` (identity ++ expression) -> vertices
        ``[B, V, 3]``."""
        geometry = self.geo_fc3(torch.relu(self.geo_fc2(shape_code)))
        return geometry.reshape(shape_code.shape[0], -1, 3) * scale


def geometry_decoder_params_from_torch(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """Upstream's pretrained decoder (the ``...geo_fc2`` / ``...geo_fc3``
    entries of ``nl3dmm_net_dict.pth``, under any prefix) -> the
    :class:`GeometryDecoder` ``state_dict``."""
    out = {}
    for name in ("geo_fc2.weight", "geo_fc2.bias", "geo_fc3.weight", "geo_fc3.bias"):
        hits = [v for k, v in state_dict.items() if k.endswith(name)]
        if not hits:
            raise KeyError(name)
        out[name] = torch.as_tensor(np.asarray(hits[0], np.float32))
    return out


def decode_texture(basis: BasisData, texture_code: torch.Tensor) -> torch.Tensor:
    """The linear texture model: ``[B, Dt]`` normalized code -> albedo
    ``[B, V, 3]`` in 0..255, not clipped: ``(code * sig_tex) @ b_tex^T +
    mu_tex``."""
    B = texture_code.shape[0]
    tex = (texture_code * basis.sig_tex[None]) @ basis.texture_basis.T
    return basis.mean_texture[None] + tex.reshape(B, -1, 3)


def vertex_normals(vertices: torch.Tensor, triangles: torch.Tensor,
                   corr_vf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unit vertex normals of ``vertices`` ``[B, V, 3]`` over ``triangles``
    ``[T, 3]``.  With ``corr_vf`` (upstream's padded adjacent-face table,
    padding at the sentinel face ``T``) the unit face normals are summed per
    vertex, as upstream; without it the area-weighted face normals are
    scatter-added (``index_add``; on the card its atomics add in no fixed
    order)."""
    t = triangles.long()
    v0, v1, v2 = vertices[:, t[:, 0]], vertices[:, t[:, 1]], vertices[:, t[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    B, V, _ = vertices.shape
    if corr_vf is not None:
        fn = fn / torch.linalg.vector_norm(fn, dim=-1, keepdim=True).clamp_min(1e-12)
        fn = torch.cat([fn, fn.new_zeros(B, 1, 3)], dim=1)
        normals = fn[:, corr_vf.long()].sum(2)
    else:
        normals = vertices.new_zeros(B, V, 3)
        for k in range(3):
            normals = normals.index_add(1, t[:, k], fn)
    norm = torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
    return normals / norm.clamp_min(1e-8)


# second-order SH irradiance constants (upstream nl3dmm_renderer.py:51-57):
# the Lambertian a_l times the SH normalization c_l
_SH_A0C0 = float(np.pi * (1.0 / np.sqrt(4.0 * np.pi)))
_SH_A1C1 = float((2.0 * np.pi / np.sqrt(3.0)) * (np.sqrt(3.0) / np.sqrt(4.0 * np.pi)))
_SH_A2C2 = float((2.0 * np.pi / np.sqrt(8.0)) * (3.0 * np.sqrt(5.0) / np.sqrt(12.0 * np.pi)))
_SH_D0 = float(0.5 / np.sqrt(3.0))


def sh_basis(normals: torch.Tensor) -> torch.Tensor:
    """The nine irradiance SH terms per normal, ``[..., 9]``."""
    x, y, z = normals[..., 0], normals[..., 1], normals[..., 2]
    return torch.stack([
        torch.full_like(x, _SH_A0C0), -_SH_A1C1 * y, _SH_A1C1 * z, -_SH_A1C1 * x,
        _SH_A2C2 * x * y, -_SH_A2C2 * y * z, _SH_A2C2 * _SH_D0 * (3.0 * z * z - 1.0),
        -_SH_A2C2 * x * z, _SH_A2C2 * 0.5 * (x * x - y * y),
    ], dim=-1)


def sh_shade(albedo: torch.Tensor, normals: torch.Tensor, illu_code: torch.Tensor) -> torch.Tensor:
    """Per-vertex lit colour ``albedo * (sh_basis(normals) @ gamma)``:
    ``albedo`` ``[B, V, 3]`` in 0..255, ``illu_code`` ``[B, 27]`` SH-major
    (``view(-1, 9, 3)``, upstream's layout; the +0.8 ambient is in the code)."""
    gamma = illu_code.reshape(albedo.shape[0], 9, 3)
    return albedo * torch.einsum("bvn,bnc->bvc", sh_basis(normals), gamma)


def init_illu_code(batch_size: int) -> torch.Tensor:
    """The zero SH code with the +0.8 ambient band, ``[B, 27]``."""
    illu = torch.zeros(batch_size, 9, 3)
    illu[:, 0, :] = 0.8
    return illu.reshape(batch_size, 27)
