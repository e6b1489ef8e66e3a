"""NL-3DMM fitting: codes and camera offsets from a batch of images, the
port of the JAX package's ``nl3dmm/fitting.py`` (upstream
``surface_fitting/nl3dmm/fitting_nl3dmm.py``): stage 1 trains the camera
offsets alone (50 steps, landmark weight 100), stage 2 the offsets and the
codes (200 steps, landmark weight 25, the codes at half the cameras'
rate), each with a new Adam; the geometry decoder stays frozen.

The camera offset is a local transform applied before the base
world-to-camera (``live = c2l_R verts + c2l_T``; the fitted extrinsics are
``R' = R c2l_R``, ``T' = R c2l_T + T``), and the normals and SH shading are
computed in camera space.  The JAX package runs each stage as one
``lax.scan``; here each step is eager PyTorch on the fitter's device, the
losses kept there and read once a stage.  Stage 1 runs with the codes
frozen (no gradient reaches them), which leaves them as JAX's zeroed
gradients leave them: unchanged.  The result dict is the h5 schema's
(``code`` 306, ``w2c_*``, ``c2w_*``, ``inmat``, ``inv_inmat``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from gazenerf_tpu_torch.models.gaze_nerf import resolve_device
from gazenerf_tpu_torch.nl3dmm.face_model import (
    BasisData,
    GeometryDecoder,
    decode_texture,
    init_illu_code,
    sh_shade,
    vertex_normals,
)
from gazenerf_tpu_torch.nl3dmm.loss import NL3DMMLoss
from gazenerf_tpu_torch.nl3dmm.rasterizer import RasterSettings, project_landmarks, render_mesh


def compute_rotation_ref(angles: torch.Tensor) -> torch.Tensor:
    """Euler angles ``[B, 3]`` (radians) -> rotations ``[B, 3, 3]``,
    upstream's convention ``(Rz Ry Rx)^T``."""
    x, y, z = angles[:, 0], angles[:, 1], angles[:, 2]
    cx, sx, cy, sy, cz, sz = x.cos(), x.sin(), y.cos(), y.sin(), z.cos(), z.sin()
    one, zero = torch.ones_like(x), torch.zeros_like(x)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    rot_x = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    rot_y = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    rot_z = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return (rot_z @ rot_y @ rot_x).transpose(-1, -2)


class FitConfig(NamedTuple):
    iden_dims: int = 100
    expr_dims: int = 79
    text_dims: int = 100
    illu_dims: int = 27
    stage1_steps: int = 50  # camera offsets only (upstream iter_num_1)
    stage2_steps: int = 200  # and the codes (upstream iter_num_2 - iter_num_1)
    lr_cam: float = 1e-2
    code_lr_scale: float = 0.5  # the codes at half the cameras' rate
    lm_w_stage1: float = 100.0
    lm_w_stage2: float = 25.0
    image_size: int = 128


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


class NL3DMMFitter:
    """Fit NL-3DMM codes and camera offsets to a batch of images, on the
    card unless ``device`` says otherwise.  ``decoder_params``: a
    :class:`GeometryDecoder` ``state_dict`` (upstream's pretrained weights
    through ``geometry_decoder_params_from_torch``); else the decoder's
    seeded draw."""

    def __init__(self, basis: BasisData, cfg: FitConfig = FitConfig(),
                 raster: Optional[RasterSettings] = None,
                 decoder_params: Optional[Dict[str, torch.Tensor]] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.raster = raster or RasterSettings(image_size=cfg.image_size)
        self.decoder = GeometryDecoder(basis)
        if decoder_params is not None:
            self.decoder.load_state_dict(decoder_params)
        self.decoder.to(self.device).requires_grad_(False)
        self.basis = basis.to(self.device)
        self.loss_utils = NL3DMMLoss(skinmask=basis.skinmask, device=self.device)

    def _render(self, code: torch.Tensor, cams: Dict[str, torch.Tensor]):
        """Vertices, lit colours and the render of ``code`` ``[B, 306]``
        through ``cams``: ``(image [B, H, W, 3] in [0, 1], alpha, landmarks
        [B, 68, 2], lit vertex colours [B, V, 3] in 0..255)``."""
        cfg = self.cfg
        i1 = cfg.iden_dims + cfg.expr_dims
        i2 = i1 + cfg.text_dims
        verts = self.decoder(code[:, :i1])
        albedo = decode_texture(self.basis, code[:, i1:i2])
        c2l_R = compute_rotation_ref(cams["delta_euler"])
        live = torch.einsum("bij,bvj->bvi", c2l_R, verts) + cams["delta_tvec"][:, None]
        cam_vps = (torch.einsum("bij,bvj->bvi", cams["base_w2c_R"], live)
                   + cams["base_w2c_T"][:, None])
        normals = vertex_normals(cam_vps, self.basis.triangles)
        sh_vcs = sh_shade(albedo, normals, code[:, i2:])
        B = verts.shape[0]
        eye = torch.eye(3, dtype=verts.dtype, device=verts.device).expand(B, 3, 3)
        zero = verts.new_zeros(B, 3)
        img255, alpha = render_mesh(cam_vps, sh_vcs, self.basis.triangles, eye, zero,
                                    cams["inmat"], self.raster, bg_color=255.0)
        img = (img255 / 255.0).clamp(0.0, 1.0)
        lm2d = project_landmarks(cam_vps, self.basis.landmark_index, eye, zero, cams["inmat"])
        return img, alpha, lm2d, sh_vcs

    def render_fit(self, result: Dict[str, np.ndarray]):
        """Re-render a finished fit (its offsets are in ``w2c_*``) for
        visual QA: ``(images [B, H, W, 3] in [0, 1], alpha [B, H, W],
        landmarks [B, 68, 2])`` as numpy arrays."""
        dev = self.device
        code = _f32(result["code"], dev)
        B = code.shape[0]
        cams = {"base_w2c_R": _f32(result["w2c_Rmat"], dev),
                "base_w2c_T": _f32(result["w2c_Tvec"], dev).reshape(B, 3),
                "inmat": _f32(result["inmat"], dev),
                "delta_euler": torch.zeros(B, 3, device=dev),
                "delta_tvec": torch.zeros(B, 3, device=dev)}
        with torch.no_grad():
            img, alpha, lm2d, _ = self._render(code, cams)
        return img.cpu().numpy(), alpha.cpu().numpy(), lm2d.cpu().numpy()

    def _loss(self, code, cams, batch, lm_w: float):
        img, alpha, lm2d, sh_vcs = self._render(code, cams)
        # the photometric mask is the render's own coverage, detached
        mask = (alpha > 1e-4).detach()[..., None]
        cfg = self.cfg
        i0, i1 = cfg.iden_dims, cfg.iden_dims + cfg.expr_dims
        i2 = i1 + cfg.text_dims
        d = self.loss_utils.calc_total_loss(
            batch_vcs=sh_vcs, cur_illus=code[:, i2:], rendered_imgs=img, gt_imgs=batch["image"],
            mask_c3d=mask, proj_lm2ds=lm2d, gt_lm2ds=batch["landmarks"],
            iden_codes=code[:, :i0], expr_codes=code[:, i0:i1], text_codes=code[:, i1:i2],
            lm_w=lm_w)
        return d["total_loss"], d

    def _stage(self, code, cams, batch, steps: int, lm_w: float, cam_only: bool) -> torch.Tensor:
        """``steps`` Adam steps, a new optimizer: the offsets at ``lr_cam``,
        the codes at ``lr_cam * code_lr_scale`` (frozen with ``cam_only``);
        the per-step losses ``[steps]`` on the device."""
        cfg = self.cfg
        code.requires_grad_(not cam_only)
        groups = [{"params": [cams["delta_euler"], cams["delta_tvec"]], "lr": cfg.lr_cam}]
        if not cam_only:
            groups.append({"params": [code], "lr": cfg.lr_cam * cfg.code_lr_scale})
        opt = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
        losses = []
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss, _ = self._loss(code, cams, batch, lm_w)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        code.requires_grad_(False)
        return torch.stack(losses) if losses else torch.zeros(0, device=self.device)

    def fit(self, images: np.ndarray, landmarks: np.ndarray, base_w2c_R: np.ndarray,
            base_w2c_T: np.ndarray, inmat: np.ndarray) -> Dict[str, np.ndarray]:
        """The two-stage fit of ``images`` ``[B, H, W, 3]`` (RGB in [0, 1])
        to ``landmarks`` ``[B, 68, 2]`` from the base cameras; returns the
        h5-schema dict per image and both stages' per-step losses.  The
        photometric term is masked by the render's own coverage, as
        upstream's."""
        cfg, dev = self.cfg, self.device
        B = images.shape[0]
        batch = {"image": _f32(images, dev), "landmarks": _f32(landmarks, dev)}
        i3 = cfg.iden_dims + cfg.expr_dims + cfg.text_dims
        code = torch.zeros(B, i3 + cfg.illu_dims, device=dev)
        code[:, i3:] = init_illu_code(B).to(dev)
        cams = {"base_w2c_R": _f32(base_w2c_R, dev), "base_w2c_T": _f32(base_w2c_T, dev),
                "inmat": _f32(inmat, dev),
                "delta_euler": torch.zeros(B, 3, device=dev, requires_grad=True),
                "delta_tvec": torch.zeros(B, 3, device=dev, requires_grad=True)}
        l1 = self._stage(code, cams, batch, cfg.stage1_steps, cfg.lm_w_stage1, True)
        l2 = self._stage(code, cams, batch, cfg.stage2_steps, cfg.lm_w_stage2, False)

        with torch.no_grad():
            c2l_R = compute_rotation_ref(cams["delta_euler"])
            base_R = cams["base_w2c_R"]
            w2c_R = torch.einsum("bij,bjk->bik", base_R, c2l_R).cpu().numpy()
            w2c_T = (torch.einsum("bij,bj->bi", base_R, cams["delta_tvec"])
                     + cams["base_w2c_T"]).cpu().numpy()
        c2w_R = w2c_R.transpose(0, 2, 1)
        c2w_T = -np.einsum("bij,bj->bi", c2w_R, w2c_T)
        inmat_np = np.asarray(inmat, np.float32)
        return {
            "code": code.cpu().numpy(),
            "w2c_Rmat": w2c_R,
            "w2c_Tvec": w2c_T,
            "c2w_Rmat": c2w_R,
            "c2w_Tvec": c2w_T,
            "inmat": inmat_np,
            "inv_inmat": np.linalg.inv(inmat_np).astype(np.float32),
            "stage1_losses": l1.cpu().numpy(),
            "stage2_losses": l2.cpu().numpy(),
        }
