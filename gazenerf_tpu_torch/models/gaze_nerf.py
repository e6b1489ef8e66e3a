"""GazeNeRF: the two-stream conditional NeRF.

A face field and an eye field each predict a 258-channel feature + density
volume, alpha-composited into 64x64 feature maps; the eye feature planes are
rotated by the gaze; the streams merge by an elementwise max; the neural
renderer upsamples to the 512x512 RGB image.  One positional embedding is
shared by both branches.

With ``compute_dtype="bfloat16"`` and ``use_pallas`` the fields run through
the fused field kernels (``kernels/fused_field``: the forward kernel, and
under autograd the backward kernel as its gradient, recompute mode);
otherwise through :class:`NeRFFieldMLP` in the compute dtype, then
:func:`integrate_rays`.

The port runs the render and the training forward (``train=True``: jittered
samples) in the default configuration; the options below raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from gazenerf_tpu_torch.config import ModelConfig
from gazenerf_tpu_torch.models.mlp_nerf import NeRFFieldMLP
from gazenerf_tpu_torch.models.neural_renderer import NeuralRenderer
from gazenerf_tpu_torch.ops.embedding import positional_encoding
from gazenerf_tpu_torch.ops.integrate import Integrated, integrate_rays
from gazenerf_tpu_torch.ops.rays import SampleSet, sample_coarse
from gazenerf_tpu_torch.ops.rotation import rotate_feature_planes

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}

# settings outside this slice: (field, value the port runs)
_PORTED = (
    ("hier_sampling", False),
    ("include_vd", False),
    ("ray_chunk", 0),
    ("pallas_dual_branch", False),
    ("pallas_fuse_embed", False),
    ("pallas_dens_vpu", False),
    ("pallas_stash_acts", False),
    ("pallas_stash_every", 1),
    ("pallas_stash_dtype", "bfloat16"),
    ("pallas_split_dw", False),
    ("pallas_embed_bf16", False),
    ("batch_renderer_passes", False),
    ("batch_fg_passes", False),
    ("shuffle_mode", "phase_gm"),
    ("renderer_fold_feat", True),
    ("renderer_rgb_cf", True),
)


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA card when none is given.  Never falls back to
    the CPU on its own: without a card the caller must ask for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


class GazeNeRF(nn.Module):
    """Full model.  Parameters are initialised from ``seed`` (xavier-uniform
    fields, lecun-normal renderer, zero biases, white background) on the CPU
    and then moved to ``device``; load trained or transplanted weights with
    ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__()
        for name, value in _PORTED:
            if getattr(cfg, name) != value:
                raise NotImplementedError(
                    f"{name}={getattr(cfg, name)!r} is not ported yet "
                    f"(the port runs {name}={value!r})"
                )
        device = resolve_device(device)
        self.cfg = cfg
        dtype = _DTYPES[cfg.compute_dtype]

        def field():
            return NeRFFieldMLP(
                embed_dims=cfg.vp_embed_dims,
                cond_dims=cfg.shape_ext_code_dims,
                vd_cond_dims=cfg.vd_channels,
                hidden=cfg.mlp_hidden,
                n_layers=cfg.mlp_layers,
                res_nfeat=cfg.featmap_nc,
                dtype=dtype,
            )

        # names mirror the upstream modules (weight transplant)
        self.fg_CD_predictor_face = field()
        self.fg_CD_predictor_eyes = field()
        self.neural_render = NeuralRenderer(
            bg_type=cfg.bg_type,
            feat_nc=cfg.featmap_nc,
            out_dim=3,
            final_actvn=True,
            min_feat=cfg.min_feat,
            featmap_size=cfg.featmap_size,
            img_size=cfg.pred_img_size,
            dtype=_DTYPES[cfg.renderer_dtype],
        )
        gen = torch.Generator().manual_seed(seed)
        self.fg_CD_predictor_face.reset_parameters(gen)
        self.fg_CD_predictor_eyes.reset_parameters(gen)
        self.neural_render.reset_parameters(gen)
        self.to(device)

    @property
    def fused(self) -> bool:
        """Whether the fields run through the fused field kernel."""
        return self.cfg.use_pallas and self.cfg.compute_dtype == "bfloat16"

    def _render_branch(
        self,
        field: NeRFFieldMLP,
        embed: torch.Tensor,
        shape_ext_code: torch.Tensor,
        appea_code: torch.Tensor,
        samples: SampleSet,
    ) -> Integrated:
        """Field evaluation + volume integration for one stream."""
        if self.fused:
            feat_int, bg_alpha, depth, w = field.fused_render(
                embed, shape_ext_code, appea_code, samples.zvals, samples.z_dists
            )
            return Integrated(features=feat_int, bg_alpha=bg_alpha, depth=depth, weights=w)
        feat, density = field(embed, shape_ext_code, appea_code)
        acc = torch.promote_types(feat.dtype, torch.float32)  # bf16 fields integrate in f32
        return integrate_rays(
            feat.to(acc), density[..., 0].to(acc), samples.z_dists, samples.zvals
        )

    def render_featmaps(
        self,
        batch_xy: torch.Tensor,
        shape_code: torch.Tensor,
        appea_code: torch.Tensor,
        gaze_code: torch.Tensor,
        Rmats: torch.Tensor,
        Tvecs: torch.Tensor,
        inv_inmats: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        t_rand: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """Everything before the renderer: both field branches, the
        background merge, the gaze rotation of the eye planes and the max.

        Takes :meth:`forward`'s arguments; returns its dict without
        ``coarse_dict``.  The viewer renders ``featmaps["merge"]`` alone.
        """
        cfg = self.cfg
        B = batch_xy.shape[0]
        Fs = cfg.featmap_size

        if train and generator is None and t_rand is None:
            raise ValueError("train=True draws jitter: pass a generator or t_rand")
        samples = sample_coarse(
            batch_xy, Rmats, Tvecs.reshape(B, 3), inv_inmats,
            num_samples=cfg.num_sample_coarse,
            world_z1=cfg.world_z1, world_z2=cfg.world_z2,
            generator=generator if train else None,
            t_rand=t_rand if train else None,
        )
        # one positional embedding for both branches
        embed = positional_encoding(samples.pts, cfg.vp_n_freqs, cfg.include_input_vp)
        shape_ext_code = torch.cat([shape_code, gaze_code.reshape(B, 2)], dim=-1)

        face = self._render_branch(
            self.fg_CD_predictor_face, embed, shape_ext_code, appea_code, samples
        )
        eyes = self._render_branch(
            self.fg_CD_predictor_eyes, embed, shape_ext_code, appea_code, samples
        )

        bg_featmap = self.neural_render.get_bg_featmap()
        merge_featmap_face = (
            face.features.reshape(B, Fs, Fs, cfg.featmap_nc)
            + face.bg_alpha.reshape(B, Fs, Fs, 1) * bg_featmap
        )
        merge_featmap_eyes = (
            eyes.features.reshape(B, Fs, Fs, cfg.featmap_nc)
            + eyes.bg_alpha.reshape(B, Fs, Fs, 1) * bg_featmap
        )
        eyes_planes = rotate_feature_planes(merge_featmap_eyes, gaze_code.reshape(B, 2))
        merge_featmap = torch.maximum(merge_featmap_face, eyes_planes)
        return {
            "featmaps": {
                "face": merge_featmap_face,
                "eyes": eyes_planes,
                "merge": merge_featmap,
            },
            "weights": face.weights,
            "depth": {"face": face.depth, "eyes": eyes.depth},
        }

    def forward(
        self,
        batch_xy: torch.Tensor,
        shape_code: torch.Tensor,
        appea_code: torch.Tensor,
        gaze_code: torch.Tensor,
        Rmats: torch.Tensor,
        Tvecs: torch.Tensor,
        inv_inmats: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        t_rand: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """Render a batch.

        Args:
          batch_xy: ``[B, R, 2]`` featmap pixel grid (R = featmap_size**2).
          shape_code: ``[B, 179]`` identity(100) ++ expression(79).
          appea_code: ``[B, 127]`` texture(100) ++ illumination(27).
          gaze_code: ``[B, 2]`` (pitch, yaw).
          Rmats/Tvecs/inv_inmats: camera-to-world extrinsics and inverse
            intrinsics at featmap resolution.
          train: jitter the samples (stratified), drawing ``[B, R, S+1]``
            uniforms from ``generator``, or taking the draws ``t_rand``.

        Returns the JAX model's dict: ``coarse_dict`` (``merge_img``,
        ``merge_img_face``, ``merge_img_eyes``, ``bg_img``, NHWC),
        ``featmaps``, ``weights`` and ``depth``.
        """
        out = self.render_featmaps(
            batch_xy, shape_code, appea_code, gaze_code, Rmats, Tvecs, inv_inmats,
            train=train, generator=generator, t_rand=t_rand,
        )
        fm = out["featmaps"]
        # four sequential renderer passes
        out["coarse_dict"] = {
            "merge_img": self.neural_render(fm["merge"]),
            "merge_img_face": self.neural_render(fm["face"]),
            "merge_img_eyes": self.neural_render(fm["eyes"]),
            "bg_img": self.neural_render(self.neural_render.get_bg_featmap()),
        }
        return out
