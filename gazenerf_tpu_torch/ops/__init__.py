from gazenerf_tpu_torch.ops.embedding import positional_encoding
from gazenerf_tpu_torch.ops.image import (
    pixel_shuffle2_blur_gm,
    resize_bilinear,
    upsample2x_blur_cf,
)
from gazenerf_tpu_torch.ops.integrate import (
    Integrated,
    exclusive_transmittance,
    integrate_rays,
)
from gazenerf_tpu_torch.ops.rays import (
    RayBundle,
    SampleSet,
    generate_rays,
    pixel_grid,
    sample_coarse,
    stratified_zvals,
)
from gazenerf_tpu_torch.ops.rotation import (
    euler_to_rotation,
    gaze_rotation_matrices,
    rotate_feature_planes,
)

__all__ = [
    "positional_encoding",
    "pixel_shuffle2_blur_gm",
    "resize_bilinear",
    "upsample2x_blur_cf",
    "Integrated",
    "exclusive_transmittance",
    "integrate_rays",
    "RayBundle",
    "SampleSet",
    "generate_rays",
    "pixel_grid",
    "sample_coarse",
    "stratified_zvals",
    "euler_to_rotation",
    "gaze_rotation_matrices",
    "rotate_feature_planes",
]
