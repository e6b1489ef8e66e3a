"""GazeNeRF: the two-stream conditional NeRF.

A face field and an eye field each predict a 258-channel feature + density
volume, alpha-composited into 64x64 feature maps; the eye feature planes are
rotated by the gaze; the streams merge by an elementwise max; the neural
renderer upsamples to the 512x512 RGB image.  One positional embedding is
shared by both branches.

With ``compute_dtype="bfloat16"`` and ``use_pallas`` the fields run through
the fused field kernels (``kernels/fused_field``: the forward kernel, and
under autograd the backward kernel as its gradient; with
``pallas_stash_acts`` the backward reads the forward's bf16 activation
stash, else it recomputes; ``pallas_dens_vpu`` selects its ``dens_vpu``
density head), or with ``pallas_dual_branch`` both fields in one
dual-branch kernel (``kernels/fused_field2``; with ``pallas_stash_acts``
its backward reads the stash; ``pallas_dens_vpu`` is cleared there, as the
JAX package does); otherwise through :class:`NeRFFieldMLP` in the compute
dtype, then :func:`integrate_rays`.

The port runs the render and the training forward (``train=True``: jittered
samples) in the default configuration, with the stash and ``dens_vpu``
(what the training CLI's ``--pallas_tuning auto`` selects) and with the
dual-branch kernels; the options below raise ``NotImplementedError``,
naming the ROADMAP item that ports them.  ``pallas_interpret``,
``pallas_tile_rays``, ``pallas_bwd_tile_rays`` and ``pallas_vmem_mb`` are
the TPU kernels' interpreter switch and tiling and memory knobs: accepted,
and of no effect in the port.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from gazenerf_tpu_torch.config import ModelConfig
from gazenerf_tpu_torch.kernels.fused_field2 import fused_dual_render, stack_operands
from gazenerf_tpu_torch.models.mlp_nerf import NeRFFieldMLP
from gazenerf_tpu_torch.models.neural_renderer import SHUFFLE_MODES, NeuralRenderer
from gazenerf_tpu_torch.ops.embedding import positional_encoding
from gazenerf_tpu_torch.ops.integrate import Integrated, integrate_rays
from gazenerf_tpu_torch.ops.rays import SampleSet, sample_coarse
from gazenerf_tpu_torch.ops.rotation import rotate_feature_planes

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}

# settings not ported yet: (field, value the port runs, the ROADMAP item)
_PORTED = (
    ("hier_sampling", False, "Queue 1 item 5"),
    ("include_vd", False, "Queue 1 item 5"),
    ("ray_chunk", 0, "Queue 1 item 5"),
    ("pallas_fuse_embed", False, "Queue 2b, mode 4"),
    ("pallas_stash_every", 1, "Queue 2b, mode 1"),
    ("pallas_stash_dtype", "bfloat16", "Queue 2b, mode 1"),
    ("pallas_split_dw", False, "Queue 2b, mode 2"),
    ("pallas_embed_bf16", False, "Queue 2b, mode 4"),
    ("batch_renderer_passes", False, "Queue 1 item 5"),
    ("batch_fg_passes", False, "Queue 1 item 5"),
    ("renderer_fold_feat", True, "Queue 1 item 4"),
    ("renderer_rgb_cf", True, "Queue 1 item 4"),
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
        for name, value, item in _PORTED:
            if getattr(cfg, name) != value:
                raise NotImplementedError(
                    f"{name}={getattr(cfg, name)!r} is not ported yet "
                    f"(the port runs {name}={value!r}; ROADMAP {item})"
                )
        # JAX's "phase" and "naive" renderer modes are not ported
        if cfg.shuffle_mode not in SHUFFLE_MODES:
            raise NotImplementedError(
                f"shuffle_mode={cfg.shuffle_mode!r} is not ported yet "
                f"(the port runs shuffle_mode in {SHUFFLE_MODES})"
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
            shuffle_mode=cfg.shuffle_mode,
        )
        # (both fields' kernel operands, their stack); see _dual_operands
        self._stacked = None
        gen = torch.Generator().manual_seed(seed)
        self.fg_CD_predictor_face.reset_parameters(gen)
        self.fg_CD_predictor_eyes.reset_parameters(gen)
        self.neural_render.reset_parameters(gen)
        self.to(device)

    def __getstate__(self):
        """A copy or a pickle carries the parameters, not the operand
        stack (rebuilt from the fields' operands at first use)."""
        state = self.__dict__.copy()
        state["_stacked"] = None
        return state

    @property
    def fused(self) -> bool:
        """Whether the fields run through the fused field kernel."""
        return self.cfg.use_pallas and self.cfg.compute_dtype == "bfloat16"

    @property
    def dual(self) -> bool:
        """Whether both fields run through the dual-branch kernel: only where
        the fused kernels apply (elsewhere ``pallas_dual_branch`` is ignored,
        as in the JAX package)."""
        return self.fused and self.cfg.pallas_dual_branch

    def _dual_operands(self):
        """Both fields' weight blocks and their stacked bf16 operands; the
        stack is rebuilt when either field's operands are."""
        blocks = [f.kernel_blocks() for f in (self.fg_CD_predictor_face,
                                              self.fg_CD_predictor_eyes)]
        ops = tuple(o for _, o in blocks)
        if self._stacked is None or any(a is not b for a, b in zip(self._stacked[0], ops)):
            self._stacked = (ops, stack_operands(ops))
        return [p for p, _ in blocks], self._stacked[1]

    def _render_both(
        self,
        embed: torch.Tensor,
        shape_ext_code: torch.Tensor,
        appea_code: torch.Tensor,
        samples: SampleSet,
    ) -> Tuple[Integrated, Integrated]:
        """Both streams: one dual-branch kernel when it applies, else one
        field at a time (JAX ``_render_both_impl``)."""
        if self.dual:
            ps, ops = self._dual_operands()
            outs = fused_dual_render(ps, ops, embed, shape_ext_code, appea_code,
                                     samples.zvals, samples.z_dists,
                                     stash_acts=self.cfg.pallas_stash_acts)
            face, eyes = (Integrated(features=o[0], bg_alpha=o[1], depth=o[2], weights=o[3])
                          for o in outs)
            return face, eyes
        return tuple(
            self._render_branch(f, embed, shape_ext_code, appea_code, samples)
            for f in (self.fg_CD_predictor_face, self.fg_CD_predictor_eyes)
        )

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
                embed, shape_ext_code, appea_code, samples.zvals, samples.z_dists,
                stash_acts=self.cfg.pallas_stash_acts, dens_vpu=self.cfg.pallas_dens_vpu,
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

        face, eyes = self._render_both(embed, shape_ext_code, appea_code, samples)

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
