"""Weight bridge: upstream ``GazeNeRFNet`` state dict <-> flax param tree.

The port's modules carry the upstream module names and layouts
(``fg_CD_predictor_face.FeaExt_module_0.weight`` as a 1x1 conv ``[out, in,
1, 1]``, ``neural_render.bg_featmap`` as ``[1, C, H, W]``), so an upstream
``.pth`` loads into it directly and a JAX variable tree loads through
:func:`params_from_jax`.  :func:`vgg_params_from_jax`,
:func:`gaze_vgg_params_from_jax` and :func:`patchgan_params_from_jax` carry
the loss stack's VGG16, gaze-VGG and PatchGAN across (convolution kernels
HWIO -> OIHW, dense kernels transposed, BatchNorm ``scale`` / ``bias`` /
``mean`` / ``var`` -> ``weight`` / ``bias`` / ``running_mean`` /
``running_var``), :func:`load_train_state_from_jax` a JAX training state's
parameters and offset tables.

The numpy converters are a copy of the JAX package's ``utils/transplant``
(the port imports nothing from that package); flax stores a Dense kernel
``[in, out]``, the transpose of the upstream conv weight.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _conv1x1_to_kernel(w: np.ndarray) -> np.ndarray:
    """Conv2d 1x1 weight ``[out, in, 1, 1]`` -> Dense kernel ``[in, out]``."""
    assert w.ndim == 4 and w.shape[2] == w.shape[3] == 1, w.shape
    return np.ascontiguousarray(w[:, :, 0, 0].T)


def _kernel_to_conv1x1(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(k.T[:, :, None, None])


# field MLP name pairs: (upstream module name, flax param prefix)
_FIELD_LAYERS = (
    [(f"FeaExt_module_{i}", f"fea_{i}") for i in range(8)]
    + [
        ("density_module", "density"),
        ("RGB_layer_0", "rgb_0"),
        ("RGB_layer_1", "rgb_1"),
        ("RGB_layer_2", "rgb_2"),
    ]
)

_FIELD_NAMES = ("fg_CD_predictor_face", "fg_CD_predictor_eyes", "fine_fg_CD_predictor")


def field_params_from_torch(sd: Mapping[str, np.ndarray], prefix: str) -> Dict:
    """Extract one ``MLPforNeRF``'s params from an upstream state dict."""
    out = {}
    for tname, jname in _FIELD_LAYERS:
        out[f"{jname}/kernel"] = _conv1x1_to_kernel(
            np.asarray(sd[f"{prefix}.{tname}.weight"])
        )
        out[f"{jname}/bias"] = np.asarray(sd[f"{prefix}.{tname}.bias"])
    return out


def field_params_to_torch(params: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for tname, jname in _FIELD_LAYERS:
        out[f"{prefix}.{tname}.weight"] = _kernel_to_conv1x1(
            np.asarray(params[f"{jname}/kernel"])
        )
        out[f"{prefix}.{tname}.bias"] = np.asarray(params[f"{jname}/bias"])
    return out


def renderer_params_from_torch(
    sd: Mapping[str, np.ndarray], n_blocks: int, prefix: str = "neural_render"
) -> Dict:
    out: Dict = {}
    for i in range(n_blocks):
        blk = {}
        for layer in ("layer_1", "layer_2"):
            blk[layer] = {
                "kernel": _conv1x1_to_kernel(
                    np.asarray(sd[f"{prefix}.feat_upsample_list.{i}.{layer}.weight"])
                ),
                "bias": np.asarray(
                    sd[f"{prefix}.feat_upsample_list.{i}.{layer}.bias"]
                ),
            }
        out[f"feat_upsample_{i}"] = blk
        out[f"feat_layer_{i}"] = {
            "kernel": _conv1x1_to_kernel(
                np.asarray(sd[f"{prefix}.feat_layers.{i}.weight"])
            ),
            "bias": np.asarray(sd[f"{prefix}.feat_layers.{i}.bias"]),
        }
    for i in range(n_blocks + 1):
        out[f"feat_2_rgb_{i}"] = {
            "kernel": _conv1x1_to_kernel(
                np.asarray(sd[f"{prefix}.feat_2_rgb_list.{i}.weight"])
            ),
            "bias": np.asarray(sd[f"{prefix}.feat_2_rgb_list.{i}.bias"]),
        }
    out["bg_featmap"] = np.asarray(sd[f"{prefix}.bg_featmap"]).transpose(0, 2, 3, 1)
    return out


def renderer_params_to_torch(
    params: Mapping, n_blocks: int, prefix: str = "neural_render"
) -> Dict[str, np.ndarray]:
    out = {}
    for i in range(n_blocks):
        for layer in ("layer_1", "layer_2"):
            p = params[f"feat_upsample_{i}"][layer]
            out[f"{prefix}.feat_upsample_list.{i}.{layer}.weight"] = _kernel_to_conv1x1(
                np.asarray(p["kernel"])
            )
            out[f"{prefix}.feat_upsample_list.{i}.{layer}.bias"] = np.asarray(
                p["bias"]
            )
        p = params[f"feat_layer_{i}"]
        out[f"{prefix}.feat_layers.{i}.weight"] = _kernel_to_conv1x1(
            np.asarray(p["kernel"])
        )
        out[f"{prefix}.feat_layers.{i}.bias"] = np.asarray(p["bias"])
    for i in range(n_blocks + 1):
        p = params[f"feat_2_rgb_{i}"]
        out[f"{prefix}.feat_2_rgb_list.{i}.weight"] = _kernel_to_conv1x1(
            np.asarray(p["kernel"])
        )
        out[f"{prefix}.feat_2_rgb_list.{i}.bias"] = np.asarray(p["bias"])
    out[f"{prefix}.bg_featmap"] = np.asarray(params["bg_featmap"]).transpose(
        0, 3, 1, 2
    )
    return out


def gazenerf_params_from_torch(sd: Mapping[str, np.ndarray], n_blocks: int = 3) -> Dict:
    """Full upstream ``GazeNeRFNet`` state dict -> flax param tree."""
    params: Dict = {}
    for name in _FIELD_NAMES:
        if any(k.startswith(name + ".") for k in sd):
            params[name] = field_params_from_torch(sd, name)
    params["neural_render"] = renderer_params_from_torch(sd, n_blocks)
    return {"params": params}


def gazenerf_params_to_torch(variables: Mapping, n_blocks: int = 3) -> Dict:
    params = variables["params"] if "params" in variables else variables
    out: Dict[str, np.ndarray] = {}
    for name in _FIELD_NAMES:
        if name in params:
            out.update(field_params_to_torch(params[name], name))
    out.update(renderer_params_to_torch(params["neural_render"], n_blocks))
    return out


def params_from_jax(variables: Mapping, n_blocks: int = 3) -> Dict[str, torch.Tensor]:
    """JAX ``GazeNeRF`` variables (arrays convertible by ``np.asarray``) ->
    the port's ``state_dict`` (float32 CPU tensors, upstream names and
    layouts); load with ``GazeNeRF.load_state_dict(..., strict=True)``."""
    return {
        k: torch.from_numpy(np.array(v, np.float32))
        for k, v in gazenerf_params_to_torch(variables, n_blocks).items()
    }


def vgg_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``VGG16Features`` variables (flax ``conv_i`` kernels ``[3, 3,
    in, out]``) -> the port's ``VGG16Features`` ``state_dict`` (torchvision
    layout ``[out, in, 3, 3]``)."""
    params = variables["params"] if "params" in variables else variables
    out = {}
    for i in range(len([k for k in params if k.startswith("conv_")])):
        p = params[f"conv_{i}"]
        out[f"convs.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1))
        )
        out[f"convs.{i}.bias"] = torch.from_numpy(np.array(p["bias"], np.float32))
    return out


def _conv_from_jax(kernel) -> torch.Tensor:
    """A flax conv kernel ``[kh, kw, in, out]`` -> torch's ``[out, in, kh, kw]``."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)))


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def gaze_vgg_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``GazeVGG`` variables (``features/conv_i`` and ``FC1..3``) -> the
    port's ``GazeVGG`` ``state_dict``."""
    params = variables["params"] if "params" in variables else variables
    out = {f"features.{k}": v for k, v in vgg_params_from_jax(params["features"]).items()}
    for fc in ("FC1", "FC2", "FC3"):
        out[f"{fc}.weight"] = _f32(np.asarray(params[fc]["kernel"]).T)
        out[f"{fc}.bias"] = _f32(params[fc]["bias"])
    return out


def patchgan_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``PatchGAN`` variables (``params`` and ``batch_stats``) -> the
    port's ``PatchGAN`` ``state_dict``: ``conv1..5`` (biases on conv1 and
    conv5) and ``norm1..3`` with their running statistics."""
    params, stats = variables["params"], variables["batch_stats"]
    out = {}
    for i in range(1, 6):
        p = params[f"conv{i}"]
        out[f"conv{i}.weight"] = _conv_from_jax(p["kernel"])
        if "bias" in p:
            out[f"conv{i}.bias"] = _f32(p["bias"])
    for i in range(1, 4):
        p, st = params[f"norm{i}"], stats[f"norm{i}"]
        out[f"norm{i}.weight"] = _f32(p["scale"])
        out[f"norm{i}.bias"] = _f32(p["bias"])
        out[f"norm{i}.running_mean"] = _f32(st["mean"])
        out[f"norm{i}.running_var"] = _f32(st["var"])
    return out


def load_train_state_from_jax(trainer, state, n_blocks: int) -> None:
    """Copy a JAX ``TrainState``'s network parameters and per-sample offset
    tables (``state.params``, ``state.offsets``) into the port's
    ``Trainer`` (its model and offsets; the optimiser state stays fresh)."""
    trainer.model.load_state_dict(params_from_jax(state.params, n_blocks), strict=True)
    with torch.no_grad():
        for k, v in state.offsets.items():
            trainer.offsets[k].copy_(torch.from_numpy(np.array(v, np.float32)))
