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
parameters and offset tables.  :func:`inception_params_from_jax`,
:func:`retinaface_params_from_jax`, :func:`pfld_params_from_jax` and
:func:`mobilefacenet_params_from_jax` carry the metric nets across (the
inverses of the JAX package's ``*_from_torch``), into the upstream layouts
the port's modules load strictly.  :func:`unet_params_from_jax`,
:func:`bisenet_params_from_jax` and :func:`geometry_decoder_params_from_jax`
carry the preprocessing nets across (BiSeNet without the auxiliary heads,
which the JAX net lacks).

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


def _bn_from_jax(p: Mapping, st: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """A flax BatchNorm's ``scale`` / ``bias`` and ``mean`` / ``var`` -> a
    torch BatchNorm's five state entries under ``prefix``."""
    return {f"{prefix}.weight": _f32(p["scale"]), f"{prefix}.bias": _f32(p["bias"]),
            f"{prefix}.running_mean": _f32(st["mean"]), f"{prefix}.running_var": _f32(st["var"]),
            f"{prefix}.num_batches_tracked": torch.tensor(0)}


def inception_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``InceptionV3FID`` variables -> the port's ``InceptionV3FID``
    ``state_dict``: flax's module paths are torchvision's names
    (``Mixed_5b/branch5x5_1/conv``)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(p, st, path):
        if "conv" in p:
            out[".".join(path + ["conv", "weight"])] = _conv_from_jax(p["conv"]["kernel"])
            out.update(_bn_from_jax(p["bn"], st["bn"], ".".join(path + ["bn"])))
            return
        for k in p:
            walk(p[k], st[k], path + [k])

    walk(variables["params"], variables["batch_stats"], [])
    return out


def retinaface_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``RetinaFace`` variables -> the port's ``RetinaFace``
    ``state_dict`` (FaceX-Zoo's names: ``body.stage1.{i}`` sequentials of
    conv 0, BatchNorm 1 and, in a depthwise block, conv 3 and BatchNorm 4;
    ``{Class,Bbox,Landmark}Head.{i}.conv1x1``)."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}

    def conv_bn(p, st, t):
        out[f"{t}.0.weight"] = _conv_from_jax(p["conv"]["kernel"])
        out.update(_bn_from_jax(p["bn"], st["bn"], f"{t}.1"))

    body_p, body_s = params["body"], stats["body"]
    for name in body_p:
        stage, i = name.rsplit("_", 1)
        t, p, st = f"body.{stage}.{i}", body_p[name], body_s[name]
        if "dw" in p:
            out[f"{t}.0.weight"] = _conv_from_jax(p["dw"]["kernel"])
            out.update(_bn_from_jax(p["bn1"], st["bn1"], f"{t}.1"))
            out[f"{t}.3.weight"] = _conv_from_jax(p["pw"]["kernel"])
            out.update(_bn_from_jax(p["bn2"], st["bn2"], f"{t}.4"))
        else:
            conv_bn(p, st, t)
    for group in ("fpn", "ssh1", "ssh2", "ssh3"):
        for name in params[group]:
            conv_bn(params[group][name], stats[group][name], f"{group}.{name}")
    for head in ("ClassHead", "BboxHead", "LandmarkHead"):
        for i in range(3):
            p = params[f"{head}_{i}"]
            out[f"{head}.{i}.conv1x1.weight"] = _conv_from_jax(p["kernel"])
            out[f"{head}.{i}.conv1x1.bias"] = _f32(p["bias"])
    return out


def pfld_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``PFLD`` variables -> the port's ``PFLD`` ``state_dict``
    (FaceX-Zoo's names: a bottleneck's ``conv`` sequential holds pw 0,
    BatchNorm 1, dw 3, BatchNorm 4, the SE 5 (``fc.0``, ``fc.2``), pwl 7,
    BatchNorm 8)."""
    params, stats = variables["params"], variables["batch_stats"]
    out = {"conv_bn1.0.weight": _conv_from_jax(params["conv_bn1"]["kernel"])}
    out.update(_bn_from_jax(params["bn1"], stats["bn1"], "conv_bn1.1"))
    for b, st in stats.items():
        if b == "bn1":
            continue
        p = params[b]
        for conv, idx in (("pw", 0), ("dw", 3), ("pwl", 7)):
            out[f"{b}.conv.{idx}.weight"] = _conv_from_jax(p[conv]["kernel"])
        for bn, idx in (("bn1", 1), ("bn2", 4), ("bn3", 8)):
            out.update(_bn_from_jax(p[bn], st[bn], f"{b}.conv.{idx}"))
        if "se" in p:
            out[f"{b}.conv.5.fc.0.weight"] = _f32(np.asarray(p["se"]["fc0"]["kernel"]).T)
            out[f"{b}.conv.5.fc.2.weight"] = _f32(np.asarray(p["se"]["fc1"]["kernel"]).T)
    for name in ("conv7", "conv8"):
        out[f"{name}.weight"] = _conv_from_jax(params[name]["kernel"])
        out[f"{name}.bias"] = _f32(params[name]["bias"])
    out["fc.weight"] = _f32(np.asarray(params["fc"]["kernel"]).T)
    out["fc.bias"] = _f32(params["fc"]["bias"])
    return out


def mobilefacenet_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``MobileFaceNet`` variables -> the port's ``MobileFaceNet``
    ``state_dict`` (FaceX-Zoo's names: the residual stacks
    ``conv_{3,4,5}.model.{i}``, each block's ``conv``, ``conv_dw`` and
    ``project``, PReLU slopes ``prelu.weight``)."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}

    def block(p, st, t):  # ConvBlock or LinearBlock
        out[f"{t}.conv.weight"] = _conv_from_jax(p["conv"]["kernel"])
        out.update(_bn_from_jax(p["bn"], st["bn"], f"{t}.bn"))
        if "prelu" in p:
            out[f"{t}.prelu.weight"] = _f32(p["prelu"])

    for name, p in params.items():
        if name in ("linear", "bn"):
            continue
        stack, _, i = name.rpartition("_")
        t = f"{stack}.model.{i}" if stack in ("conv_3", "conv_4", "conv_5") else name
        if "project" in p:
            for sub in ("conv", "conv_dw", "project"):
                block(p[sub], stats[name][sub], f"{t}.{sub}")
        else:
            block(p, stats[name], t)
    out["linear.weight"] = _f32(np.asarray(params["linear"]["kernel"]).T)
    out.update(_bn_from_jax(params["bn"], stats["bn"], "bn"))
    return out


def unet_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``UNet`` variables -> the port's ``UNet`` ``state_dict``.  The
    JAX transposed-conv kernel ``[kh, kw, in, out]`` is stored spatially
    flipped (``lax.conv_transpose`` correlates with the mirrored kernel):
    flipped back into torch's ``[in, out, kh, kw]``."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}

    def double(p, st, prefix):
        for i in (1, 2):
            out[f"{prefix}.conv{i}.0.weight"] = _conv_from_jax(p[f"conv{i}"]["kernel"])
            out[f"{prefix}.conv{i}.0.bias"] = _f32(p[f"conv{i}"]["bias"])
            out.update(_bn_from_jax(p[f"bn{i}"], st[f"bn{i}"], f"{prefix}.conv{i}.1"))

    for name in ("conv1", "conv2", "conv3", "conv4", "center"):
        double(params[name], stats[name], name)
    for name in ("up_concat4", "up_concat3", "up_concat2", "up_concat1"):
        k = np.asarray(params[name]["up"]["kernel"], np.float32)[::-1, ::-1]
        out[f"{name}.up.weight"] = torch.from_numpy(np.ascontiguousarray(k.transpose(2, 3, 0, 1)))
        out[f"{name}.up.bias"] = _f32(params[name]["up"]["bias"])
        double(params[name]["conv"], stats[name]["conv"], f"{name}.conv")
    out["final.weight"] = _conv_from_jax(params["final"]["kernel"])
    out["final.bias"] = _f32(params["final"]["bias"])
    return out


def bisenet_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``BiSeNet`` variables -> the port's ``BiSeNet`` ``state_dict`` in
    upstream's names (``resnet/layer2_0/downsample_conv`` ->
    ``cp.resnet.layer2.0.downsample.0``, ``arm16`` -> ``cp.arm16``, ``head``
    -> ``conv_out``); the auxiliary heads are not in the JAX net."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}

    def torch_path(path):
        if path[0] == "resnet":
            rest = []
            for part in path[1:]:
                if part.startswith("layer"):
                    rest += part.split("_")
                elif part.startswith("downsample_"):
                    rest += ["downsample", "0" if part.endswith("conv") else "1"]
                else:
                    rest.append(part)
            return ["cp", "resnet"] + rest
        if path[0] == "head":
            return ["conv_out"] + list(path[1:])
        if path[0] == "ffm":
            return list(path)
        return ["cp"] + list(path)

    def walk(p, st, path):
        if "kernel" in p:
            out[".".join(torch_path(path) + ["weight"])] = _conv_from_jax(p["kernel"])
            return
        if "scale" in p:
            out.update(_bn_from_jax(p, st, ".".join(torch_path(path))))
            return
        for k in p:
            walk(p[k], st.get(k, {}) if st else {}, path + [k])

    walk(params, stats, [])
    return out


def geometry_decoder_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``GeometryDecoder``'s ``{w1, b1, w2, b2}`` (dense kernels
    ``[in, out]``) -> the port's ``GeometryDecoder`` ``state_dict``
    (upstream's ``geo_fc2`` and ``geo_fc3`` Linears, ``[out, in]``)."""
    return {"geo_fc2.weight": _f32(np.asarray(params["w1"]).T), "geo_fc2.bias": _f32(params["b1"]),
            "geo_fc3.weight": _f32(np.asarray(params["w2"]).T), "geo_fc3.bias": _f32(params["b2"])}


def load_train_state_from_jax(trainer, state, n_blocks: int) -> None:
    """Copy a JAX ``TrainState``'s network parameters and per-sample offset
    tables (``state.params``, ``state.offsets``) into the port's
    ``Trainer`` (its model and offsets; the optimiser state stays fresh)."""
    trainer.model.load_state_dict(params_from_jax(state.params, n_blocks), strict=True)
    with torch.no_grad():
        for k, v in state.offsets.items():
            trainer.offsets[k].copy_(torch.from_numpy(np.array(v, np.float32)))
