"""Configuration for the PyTorch / CUDA port.

Field-for-field copies of the JAX package's ``ModelConfig``, ``LossConfig``
and ``TrainConfig`` (same names, same defaults), so
``LossConfig(**dataclasses.asdict(jax_cfg.loss))`` builds the same section
here; :class:`Config` groups them.  The data and parallel sections come with
the slices that need them.

Fields that select TPU kernel variants (``pallas_*``) keep their names so
that a JAX config loads unchanged; :class:`~gazenerf_tpu_torch.models.
gaze_nerf.GazeNeRF` states which of them the port runs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (upstream ``BaseOptions``)."""

    bg_type: str = "white"  # "white" | "black"

    iden_code_dims: int = 100
    expr_code_dims: int = 79
    text_code_dims: int = 100
    illu_code_dims: int = 27
    eye_code_dims: int = 2  # (pitch, yaw) gaze

    num_sample_coarse: int = 64
    num_sample_fine: int = 128
    hier_sampling: bool = False
    include_vd: bool = False

    # z-plane bounded sampling volume
    world_z1: float = 2.5
    world_z2: float = -3.5

    mlp_hidden: int = 384
    mlp_layers: int = 8

    # positional encoding
    vp_n_freqs: int = 10
    vd_n_freqs: int = 4
    include_input_vp: bool = True
    include_input_vd: bool = True

    featmap_size: int = 64
    featmap_nc: int = 258  # 86*3 -> enables the gaze-rotation trick
    pred_img_size: int = 512
    min_feat: int = 32

    # compute dtype of the field MLPs ("float32" | "bfloat16" | "float64");
    # bfloat16 with use_pallas runs the fused field kernel; float64 (with
    # float64 parameters) serves exact comparisons
    compute_dtype: str = "float32"
    # compute dtype of the neural renderer (the same choices)
    renderer_dtype: str = "float32"
    remat_fields: bool = True
    # run the fused field kernel (bfloat16 fields only)
    use_pallas: bool = True
    pallas_interpret: bool = False
    pallas_tile_rays: int = 0
    pallas_bwd_tile_rays: int = 0
    # blur-shuffle variant of the neural renderer; the port runs "phase_gm"
    shuffle_mode: str = "phase_gm"
    batch_renderer_passes: bool = False
    batch_fg_passes: bool = False
    # fold each feat_layer into the preceding blur-shuffle per phase (exact)
    renderer_fold_feat: bool = True
    # rgb skip chain channel-first ([B, 3, H, W]); exact
    renderer_rgb_cf: bool = True
    pallas_vmem_mb: int = 0
    ray_chunk: int = 0
    pallas_dual_branch: bool = False
    pallas_fuse_embed: bool = False
    pallas_stash_acts: bool = False
    pallas_stash_every: int = 1
    pallas_stash_dtype: str = "bfloat16"
    pallas_split_dw: bool = False
    pallas_dens_vpu: bool = False
    pallas_embed_bf16: bool = False

    @property
    def shape_code_dims(self) -> int:
        return self.iden_code_dims + self.expr_code_dims

    @property
    def appea_code_dims(self) -> int:
        return self.text_code_dims + self.illu_code_dims

    @property
    def shape_ext_code_dims(self) -> int:
        return self.shape_code_dims + self.eye_code_dims

    @property
    def vp_embed_dims(self) -> int:
        d = self.vp_n_freqs * 6
        return d + 3 if self.include_input_vp else d

    @property
    def vd_embed_dims(self) -> int:
        d = self.vd_n_freqs * 6
        return d + 3 if self.include_input_vd else d

    @property
    def vp_channels(self) -> int:
        # embedded position + (iden, expr, gaze) conditioning
        return self.vp_embed_dims + self.shape_ext_code_dims

    @property
    def vd_channels(self) -> int:
        d = self.appea_code_dims
        if self.include_vd:
            d += self.vd_embed_dims
        return d

    @property
    def num_rays(self) -> int:
        return self.featmap_size * self.featmap_size

    @property
    def n_upsample_blocks(self) -> int:
        return int(math.log2(self.pred_img_size) - math.log2(self.featmap_size))


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss-stack knobs (upstream ``GazeNeRFLoss``); the defaults are the
    upstream training recipe."""

    eye_loss_importance: float = 10.0
    vgg_importance: float = 1.0
    use_vgg_loss: bool = True
    # pretrained frozen-net checkpoints (torchvision-format state dicts);
    # empty = random init (tests only)
    vgg_ckpt: str = ""
    gaze_ckpt: str = ""
    use_l1_loss: bool = True
    use_angular_loss: bool = False
    use_patch_gan_loss: bool = False
    is_gradual_loss: bool = False
    # run the three pred images through one VGG call and the three gt
    # images through another (no gradient): the same values as six calls
    vgg_batched: bool = True
    # compute dtype of the frozen VGG16 in the loss ("float32" | "bfloat16")
    vgg_dtype: str = "float32"

    # regulariser weights
    w_cam_delta: float = 0.001
    w_iden_code: float = 0.001
    w_expr_code: float = 1.0
    w_appea_code: float = 0.001
    w_bg_code: float = 0.01
    angular_scale: float = 1.0 / 60000.0
    gan_warmup_steps: int = 200000
    gan_warmup_cap: float = 0.1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop knobs (upstream ``train.py`` and trainer)."""

    lr: float = 1e-4
    step_decay: int = 1000  # lr = lr0 * 0.1 ** (epoch / step_decay)
    optimizer: str = "adam"
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    batch_size: int = 2
    num_epochs: int = 2000
    seed: int = 45
    opt_cam: bool = True
    disc_lr_weight_decay: float = 1e-4

    # per-group learning-rate multipliers
    lr_mult_iden: float = 1.0
    lr_mult_expr: float = 0.1
    lr_mult_appea: float = 1.0
    lr_mult_euler: float = 0.1
    lr_mult_tvec: float = 0.1

    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 1  # epochs
    log_every: int = 300  # batches
    # train steps per device dispatch; the port runs one step per call
    steps_per_dispatch: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def replace(self, **sections: Any) -> "Config":
        return dataclasses.replace(self, **sections)


def small_test_config() -> ModelConfig:
    """The JAX package's tiny CPU test model (16x16 featmap, 8 samples)."""
    return ModelConfig(
        num_sample_coarse=8,
        num_sample_fine=16,
        featmap_size=16,
        featmap_nc=258,
        pred_img_size=64,
        mlp_hidden=64,
        use_pallas=False,
    )


def small_train_config() -> Config:
    """:func:`small_test_config` with the default loss stack and B=2: the
    JAX package's ``small_test_config()`` ``Config``."""
    return Config(model=small_test_config(), train=TrainConfig(batch_size=2))
