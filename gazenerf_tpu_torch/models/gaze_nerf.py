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
density head; ``pallas_split_dw`` runs the backward reading the bf16
stash of every layer without ``dens_vpu``, and no ``pallas_fuse_embed``:
see :data:`_SPLIT_DW_SETS`), or with ``pallas_dual_branch`` both
fields in one dual-branch kernel (``kernels/fused_field2``; with
``pallas_stash_acts`` its backward reads the stash; ``pallas_dens_vpu``
and ``pallas_split_dw`` are cleared there, as the JAX package does);
otherwise through :class:`NeRFFieldMLP` in the compute
dtype, then :func:`integrate_rays`.  With ``include_vd`` the fields take
the view-direction embedding and run eagerly (as in the JAX package).

The port runs the render and the training forward (``train=True``: jittered
samples) in the default configuration, with the stash and ``dens_vpu``
(what the training CLI's ``--pallas_tuning auto`` selects), with the
dual-branch kernels, in checkpointed ray chunks (``ray_chunk``), with the
hierarchical sampler's fine pass (``hier_sampling``: ``fine_dict``) and
with the renderer passes stacked along the batch (``batch_renderer_passes``,
``batch_fg_passes``); the options below raise ``NotImplementedError``,
naming the ROADMAP item that ports them, and so does a ray shape the fused
field kernels do not take (ROADMAP Queue 2b, mode 6).  ``pallas_interpret``,
``pallas_tile_rays``, ``pallas_bwd_tile_rays`` and ``pallas_vmem_mb`` are
the TPU kernels' interpreter switch and tiling and memory knobs: accepted,
and of no effect in the port.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gazenerf_tpu_torch.config import ModelConfig
from gazenerf_tpu_torch.kernels import fused_field as ff
from gazenerf_tpu_torch.kernels.field_dw import TILE_POINTS as BWD_TILE_POINTS
from gazenerf_tpu_torch.kernels.fused_field2 import fused_dual_render, stack_operands
from gazenerf_tpu_torch.models.mlp_nerf import NeRFFieldMLP
from gazenerf_tpu_torch.models.neural_renderer import SHUFFLE_MODES, NeuralRenderer
from gazenerf_tpu_torch.ops.embedding import positional_encoding
from gazenerf_tpu_torch.ops.integrate import Integrated, integrate_rays
from gazenerf_tpu_torch.ops.rays import SampleSet, sample_coarse, sample_fine
from gazenerf_tpu_torch.ops.rotation import rotate_feature_planes

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}

# settings not ported yet: (field, value the port runs, the ROADMAP item)
_PORTED = (
    ("pallas_fuse_embed", False, "Queue 2b, mode 4"),
    ("pallas_stash_every", 1, "Queue 2b, mode 1"),
    ("pallas_stash_dtype", "bfloat16", "Queue 2b, mode 1"),
    ("pallas_embed_bf16", False, "Queue 2b, mode 4"),
    ("renderer_fold_feat", True, "Queue 1 item 4"),
    ("renderer_rgb_cf", True, "Queue 1 item 4"),
)
# what pallas_split_dw sets, whatever the config says.  The JAX package's
# _fused_dims: the bf16 stash of every layer, the embedding outside the
# kernel.  Its backward kernel's split_dw epilogue contracts each weight
# gradient over the stash in one large-K matmul of the bf16 cotangents,
# which the port's backward kernel does in every mode, and takes dWd from
# the bf16-rounded density cotangent even under dens_vpu; dWd is all that
# dens_vpu changes in the port's backward, so split_dw is its stash mode
# without dens_vpu.
_SPLIT_DW_SETS = {"pallas_fuse_embed": False, "pallas_stash_every": 1,
                  "pallas_stash_dtype": "bfloat16", "pallas_stash_acts": True,
                  "pallas_dens_vpu": False}


def kernel_setting(cfg: ModelConfig, name: str):
    """A kernel setting as the fused path runs it: the config's, or what
    ``pallas_split_dw`` sets in its place."""
    if cfg.pallas_split_dw and name in _SPLIT_DW_SETS:
        return _SPLIT_DW_SETS[name]
    return getattr(cfg, name)


def chunked(cfg: ModelConfig, rays: int) -> bool:
    """Whether the fields run in checkpointed chunks of ``cfg.ray_chunk``
    rays (the JAX ``_render_both``'s conditions)."""
    rc = cfg.ray_chunk
    return bool(rc) and rays > rc and rays % rc == 0 and not cfg.include_vd


def check_ray_shapes(cfg: ModelConfig) -> None:
    """Raise, in ``_PORTED``'s form, on a ray shape the fused field kernels
    do not take yet, in the coarse pass (per chunk when :func:`chunked`) or
    the fine pass of ``hier_sampling``: rays of S samples that neither
    divide the backward's 64-point tile nor are a multiple of it up to
    ``MAX_SAMPLES``, or rays that do not fill the kernels' CTAs and tiles.
    Off the fused path (f32 fields, or ``include_vd``, whose fields run
    eagerly) every shape runs."""
    if not (cfg.use_pallas and cfg.compute_dtype == "bfloat16") or cfg.include_vd:
        return
    R = cfg.num_rays
    shapes = [("num_sample_coarse", cfg.ray_chunk if chunked(cfg, R) else R,
               cfg.num_sample_coarse)]
    if cfg.hier_sampling:
        shapes.append(("num_sample_fine", R, cfg.num_sample_coarse + cfg.num_sample_fine))
    for name, R, S in shapes:
        if (not ff.takes_samples(S) or R % ff.cta_rays(S) or (R * S) % BWD_TILE_POINTS):
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)!r} is not ported yet: the fused field kernels "
                f"run {R} rays of {S} samples, and they take S dividing {ff.RAY_STEP} or a "
                f"multiple of {ff.RAY_STEP} up to {ff.MAX_SAMPLES}, with whole rays in "
                f"every tile (ROADMAP Queue 2b, mode 6)"
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
            if kernel_setting(cfg, name) != value:
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
        check_ray_shapes(cfg)
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
        if cfg.hier_sampling:
            self.fine_fg_CD_predictor = field()
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
        if cfg.hier_sampling:
            self.fine_fg_CD_predictor.reset_parameters(gen)
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
        embed_vd: Optional[torch.Tensor] = None,
    ) -> Tuple[Integrated, Integrated]:
        """Both streams, in checkpointed chunks of ``ray_chunk`` rays when
        :func:`chunked` (JAX ``_render_both``: each chunk's fields under
        ``jax.checkpoint``): each chunk runs :meth:`_render_both_impl`
        under ``torch.utils.checkpoint``, which keeps none of its tensors
        for the backward but recomputes them there (the stash included, so
        the backward reads the recomputed one); the chunks' outputs are
        joined along the rays.  The numbers do not change."""
        R = embed.shape[1]
        if embed_vd is not None or not chunked(self.cfg, R):
            return self._render_both_impl(embed, shape_ext_code, appea_code,
                                          samples.zvals, samples.z_dists, embed_vd)

        def chunk(e, zv, zd):
            return tuple(t for o in self._render_both_impl(e, shape_ext_code, appea_code, zv, zd)
                         for t in o)

        rc = self.cfg.ray_chunk
        parts = [checkpoint(chunk, embed[:, r0:r0 + rc], samples.zvals[:, r0:r0 + rc],
                            samples.z_dists[:, r0:r0 + rc], use_reentrant=False)
                 for r0 in range(0, R, rc)]
        joined = [torch.cat(ts, dim=1) for ts in zip(*parts)]
        return Integrated(*joined[:4]), Integrated(*joined[4:])

    def _render_both_impl(self, embed, shape_ext_code, appea_code, zvals, z_dists,
                          embed_vd=None) -> Tuple[Integrated, Integrated]:
        """Both streams: one dual-branch kernel when it applies, else one
        field at a time (JAX ``_render_both_impl``)."""
        if self.dual and embed_vd is None:
            ps, ops = self._dual_operands()
            outs = fused_dual_render(ps, ops, embed, shape_ext_code, appea_code,
                                     zvals, z_dists, stash_acts=self.cfg.pallas_stash_acts)
            face, eyes = (Integrated(features=o[0], bg_alpha=o[1], depth=o[2], weights=o[3])
                          for o in outs)
            return face, eyes
        return tuple(
            self._render_branch(f, embed, shape_ext_code, appea_code, zvals, z_dists, embed_vd)
            for f in (self.fg_CD_predictor_face, self.fg_CD_predictor_eyes)
        )

    def _render_branch(
        self,
        field: NeRFFieldMLP,
        embed: torch.Tensor,
        shape_ext_code: torch.Tensor,
        appea_code: torch.Tensor,
        zvals: torch.Tensor,
        z_dists: torch.Tensor,
        embed_vd: Optional[torch.Tensor] = None,
        stash_acts: Optional[bool] = None,
    ) -> Integrated:
        """Field evaluation + volume integration for one stream: the fused
        kernels unless view directions are given (``stash_acts`` defaults
        to the config's, as :func:`kernel_setting` reads it)."""
        if self.fused and embed_vd is None:
            if stash_acts is None:
                stash_acts = kernel_setting(self.cfg, "pallas_stash_acts")
            feat_int, bg_alpha, depth, w = field.fused_render(
                embed, shape_ext_code, appea_code, zvals, z_dists,
                stash_acts=stash_acts, dens_vpu=kernel_setting(self.cfg, "pallas_dens_vpu"),
            )
            return Integrated(features=feat_int, bg_alpha=bg_alpha, depth=depth, weights=w)
        feat, density = field(embed, shape_ext_code, appea_code, embed_vd)
        acc = torch.promote_types(feat.dtype, torch.float32)  # bf16 fields integrate in f32
        return integrate_rays(feat.to(acc), density[..., 0].to(acc), z_dists, zvals)

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
        ``coarse_dict`` (and without the fine pass).  The viewer renders
        ``featmaps["merge"]`` alone.
        """
        return self._featmaps(batch_xy, shape_code, appea_code, gaze_code, Rmats, Tvecs,
                              inv_inmats, train, generator, t_rand)[0]

    def _featmaps(self, batch_xy, shape_code, appea_code, gaze_code, Rmats, Tvecs,
                  inv_inmats, train, generator, t_rand):
        """:meth:`render_featmaps`, and the coarse samples and the shape
        code the fine pass takes."""
        cfg = self.cfg
        B = batch_xy.shape[0]
        Fs = cfg.featmap_size

        if train and generator is None and (t_rand is None or cfg.hier_sampling):
            raise ValueError("train=True draws jitter: pass a generator (with hier_sampling "
                             "the fine pass draws from it) or t_rand")
        samples = sample_coarse(
            batch_xy, Rmats, Tvecs.reshape(B, 3), inv_inmats,
            num_samples=cfg.num_sample_coarse,
            world_z1=cfg.world_z1, world_z2=cfg.world_z2,
            generator=generator if train else None,
            t_rand=t_rand if train else None,
        )
        # one positional embedding for both branches
        embed = positional_encoding(samples.pts, cfg.vp_n_freqs, cfg.include_input_vp)
        embed_vd = self._view_embedding(samples)
        shape_ext_code = torch.cat([shape_code, gaze_code.reshape(B, 2)], dim=-1)

        face, eyes = self._render_both(embed, shape_ext_code, appea_code, samples, embed_vd)

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
        out = {
            "featmaps": {
                "face": merge_featmap_face,
                "eyes": eyes_planes,
                "merge": merge_featmap,
            },
            "weights": face.weights,
            "depth": {"face": face.depth, "eyes": eyes.depth},
        }
        return out, samples, shape_ext_code

    def _view_embedding(self, samples: SampleSet) -> Optional[torch.Tensor]:
        """The view-direction embedding the fields take with ``include_vd``."""
        cfg = self.cfg
        if not cfg.include_vd:
            return None
        return positional_encoding(samples.dirs, cfg.vd_n_freqs, cfg.include_input_vd)

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
            uniforms from ``generator``, or taking the draws ``t_rand``;
            with ``hier_sampling`` the fine pass draws ``[B, R,
            num_sample_fine + 1]`` uniforms from ``generator`` too
            (without ``train`` they are evenly spaced).

        Returns the JAX model's dict: ``coarse_dict`` (``merge_img``,
        ``merge_img_face``, ``merge_img_eyes``, ``bg_img``, NHWC),
        ``featmaps``, ``weights`` and ``depth``; with ``hier_sampling`` also
        ``fine_dict`` (``merge_img``, ``bg_img``).
        """
        cfg = self.cfg
        B = batch_xy.shape[0]
        out, samples, shape_ext_code = self._featmaps(
            batch_xy, shape_code, appea_code, gaze_code, Rmats, Tvecs, inv_inmats,
            train, generator, t_rand,
        )
        fm = out["featmaps"]
        bg_featmap = self.neural_render.get_bg_featmap()
        render = self.neural_render
        if cfg.batch_renderer_passes:
            # one renderer pass over bg + face + eyes + merge, stacked along
            # the batch (the same math per image)
            imgs = render(torch.cat([bg_featmap, fm["face"], fm["eyes"], fm["merge"]], dim=0))
            bg_img, face_img = imgs[:1], imgs[1 : 1 + B]
            eyes_img, merge_img = imgs[1 + B : 1 + 2 * B], imgs[1 + 2 * B :]
        elif cfg.batch_fg_passes:
            # the three foreground maps in one pass, the 1-row background apart
            imgs = render(torch.cat([fm["face"], fm["eyes"], fm["merge"]], dim=0))
            face_img, eyes_img, merge_img = imgs[:B], imgs[B : 2 * B], imgs[2 * B :]
            bg_img = render(bg_featmap)
        else:  # four sequential renderer passes
            merge_img, face_img = render(fm["merge"]), render(fm["face"])
            eyes_img, bg_img = render(fm["eyes"]), render(bg_featmap)
        out["coarse_dict"] = {
            "merge_img": merge_img,
            "merge_img_face": face_img,
            "merge_img_eyes": eyes_img,
            "bg_img": bg_img,
        }
        if cfg.hier_sampling:
            out["fine_dict"] = self._fine_pass(out["weights"], samples, shape_ext_code,
                                               appea_code, bg_featmap, bg_img,
                                               generator if train else None)
        return out

    def _fine_pass(self, weights, samples, shape_ext_code, appea_code, bg_featmap, bg_img,
                   generator) -> Dict[str, torch.Tensor]:
        """The hierarchical sampler's fine pass (JAX ``GazeNeRF.__call__``):
        inverse-CDF samples from the face branch's coarse weights, the fine
        field over the ``S_c + num_sample_fine`` samples (the fused kernels
        without the stash: no loss reads ``fine_dict``, so the stash would
        hold what no backward reads), one more renderer pass."""
        cfg = self.cfg
        B = weights.shape[0]
        Fs = cfg.featmap_size
        fine = sample_fine(weights, samples, cfg.num_sample_fine, generator=generator)
        embed = positional_encoding(fine.pts, cfg.vp_n_freqs, cfg.include_input_vp)
        out = self._render_branch(self.fine_fg_CD_predictor, embed, shape_ext_code, appea_code,
                                  fine.zvals, fine.z_dists, self._view_embedding(fine),
                                  stash_acts=False)
        fine_merge = (out.features.reshape(B, Fs, Fs, cfg.featmap_nc)
                      + out.bg_alpha.reshape(B, Fs, Fs, 1) * bg_featmap)
        return {"merge_img": self.neural_render(fine_merge), "bg_img": bg_img}
