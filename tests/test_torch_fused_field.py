"""The PyTorch port's fused field forward against the JAX package.

The port's plain version (``fused_field_reference``, what the wrapper runs
for CPU tensors) is held against the JAX Pallas kernel in interpret mode
and against its XLA twin, on the same numpy inputs and weights.  The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gazenerf_tpu.kernels.fused_field import (
    FieldDims,
    fused_field_render as jax_fused_field_render,
    xla_reference,
)
from gazenerf_tpu.models.mlp_nerf import NeRFFieldMLP as JaxField
from gazenerf_tpu_torch.kernels import fused_field as ff
from gazenerf_tpu_torch.models.mlp_nerf import NeRFFieldMLP
from gazenerf_tpu_torch.utils.transplant import field_params_to_torch
from torch_threads import one_thread  # noqa: F401

B, R, S, DE, H, C = 1, 64, 8, 63, 64, 258
NAMES = ("feat_int", "bg_alpha", "depth", "weights")


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    embed = rng.standard_normal((B, R, S, DE)).astype(np.float32) * 0.5
    sc = rng.standard_normal((B, 181)).astype(np.float32) * 0.1
    ac = rng.standard_normal((B, 127)).astype(np.float32) * 0.1
    zvals = np.sort(rng.standard_normal((B, R, S)).astype(np.float32), -1)
    zdists = np.abs(rng.standard_normal((B, R, S)).astype(np.float32)) * 0.2
    mlp = JaxField(embed_dims=DE, cond_dims=181, vd_cond_dims=127, hidden=H, res_nfeat=C)
    inputs = (embed, sc, ac, zvals, zdists)
    params = jax.jit(mlp.init)(jax.random.PRNGKey(0), *map(jnp.asarray, inputs[:3]))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    # the init zeroes every bias; trained ones are not, and a kernel that
    # drops or misplaces a bias must fail here
    params = {
        k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32) if k.endswith("/bias") else v
        for k, v in params.items()
    }
    return mlp, params, inputs


def _torch_flat(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def _port_render(params, inputs):
    p = ff.split_params(_torch_flat(params), DE)
    with torch.no_grad():
        return ff.fused_field_render(p, ff.prepare_operands(p), *map(torch.from_numpy, inputs))


def _dims():
    return FieldDims(embed=DE, hidden=H, feat=C, samples=S, tile_rays=16, interpret=True)


def test_reference_matches_jax_kernel_interpret(case):
    """Same rounding points as the Pallas kernel; only the f32 summation
    order differs (and the kernel's log-space transmittance), which can
    flip an occasional bf16 rounding: 5e-3 absolute."""
    _, params, inputs = case
    want = jax_fused_field_render(params, *map(jnp.asarray, inputs), _dims())
    got = _port_render(params, inputs)
    for n, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-3, rtol=0, err_msg=n)


def test_reference_matches_jax_xla_reference(case):
    """The XLA twin adds the code rows in bf16 where the kernel adds them in
    f32: held at the JAX package's own kernel-vs-twin bound, 2e-2."""
    _, params, inputs = case
    want = xla_reference(params, *map(jnp.asarray, inputs), _dims())
    got = _port_render(params, inputs)
    for n, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(
            a.numpy(), np.asarray(b, np.float32), atol=2e-2, rtol=2e-2, err_msg=n
        )


def _port_field(params, dtype=torch.float32):
    field = NeRFFieldMLP(DE, 181, 127, hidden=H, res_nfeat=C, dtype=dtype)
    sd = field_params_to_torch(params, "f")
    field.load_state_dict(
        {k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True
    )
    return field


def test_field_mlp_f32_matches_jax(case):
    """The f32 field (the non-kernel path) against the JAX module's XLA
    path: f32 on both sides, so only summation order differs."""
    mlp, params, inputs = case
    embed, sc, ac = inputs[:3]
    want_f, want_d = mlp.apply({"params": params}, *map(jnp.asarray, (embed, sc, ac)))
    with torch.no_grad():
        got_f, got_d = _port_field(params)(*map(torch.from_numpy, (embed, sc, ac)))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5, rtol=1e-5)


def test_module_fused_render_uses_the_wrapper(case):
    """``NeRFFieldMLP.fused_render`` on CPU tensors is the plain version on
    the module's own weights, and counts no kernel launch: equal bits."""
    _, params, inputs = case
    field = _port_field(params)
    before = ff.launch_count
    with torch.no_grad():
        got = field.fused_render(*map(torch.from_numpy, inputs))
        p = ff.split_params(field.flat(), DE)
        want = ff.fused_field_render(p, ff.prepare_operands(p), *map(torch.from_numpy, inputs))
    assert ff.launch_count == before
    for n, a, b in zip(NAMES, got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=n)


def test_prepare_operands_layout(case):
    _, params, _ = case
    p = ff.split_params(_torch_flat(params), DE)
    ops = ff.prepare_operands(p)
    assert ops.w0e.shape == (H, 64) and ops.w5e.shape == (H, 64)  # K padded to 16s
    assert torch.count_nonzero(ops.w0e[:, DE:]) == 0
    assert ops.wmid.shape == (6, H, H) and ops.wr1x.shape == (H // 2, H)
    assert ops.wr2.shape == (H // 2, C)
    for name, t in ops._asdict().items():
        assert t.is_contiguous(), name
        want = torch.bfloat16 if name.startswith("w") else torch.float32
        assert t.dtype == want, name
    # [out, in] layout: fea_1's weight row j is the flax kernel's column j
    np.testing.assert_array_equal(
        ops.wmid[0].float().numpy(),
        torch.from_numpy(np.array(params["fea_1/kernel"])).t().to(torch.bfloat16).float().numpy(),
    )


@pytest.mark.parametrize("entry", ["wrapper", "module"])
def test_gradients_flow_through_the_function(case, entry):
    """Under autograd the render goes through ``FusedField`` (on the CPU its
    backward is the plain backward): every field parameter, both codes and
    the embedding get a finite, nonzero gradient, through the wrapper with
    the split weight blocks and through ``NeRFFieldMLP.fused_render``."""
    _, params, inputs = case
    embed, sc, ac, zvals, zdists = (torch.from_numpy(np.array(x)) for x in inputs)
    for t in (embed, sc, ac):
        t.requires_grad_(True)
    if entry == "wrapper":
        leaves = {k: v.requires_grad_(True) for k, v in _torch_flat(params).items()}
        p = ff.split_params(leaves, DE)
        with torch.no_grad():
            ops = ff.prepare_operands(p)
        out = ff.fused_field_render(p, ops, embed, sc, ac, zvals, zdists)
    else:
        field = _port_field(params)
        leaves = dict(field.named_parameters())
        out = field.fused_render(embed, sc, ac, zvals, zdists)
    assert out[0].grad_fn is not None and "FusedField" in type(out[0].grad_fn).__name__
    (out[0].square().sum() + out[1].square().sum()).backward()
    for name, t in {**leaves, "sc": sc, "ac": ac, "embed": embed}.items():
        assert t.grad is not None and torch.isfinite(t.grad).all(), name
        assert t.grad.abs().max() > 0, name


def test_kernel_operands_built_once_per_weight_set(case):
    """The bf16 operands are prepared once and reused across renders; a
    weight write (``load_state_dict``, an in-place update) rebuilds them."""
    _, params, inputs = case
    field = _port_field(params)
    p, ops = field.kernel_operands()
    assert field.kernel_operands()[1] is ops
    with torch.no_grad():
        field.fused_render(*map(torch.from_numpy, inputs))
    assert field.kernel_operands()[1] is ops
    br2, wmid0 = ops.br2.clone(), ops.wmid[0].float()
    sd = {k: v.clone() for k, v in field.state_dict().items()}
    sd["RGB_layer_2.bias"] += 1.0
    field.load_state_dict(sd)
    p2, ops2 = field.kernel_operands()
    assert ops2 is not ops
    torch.testing.assert_close(ops2.br2, br2 + 1.0)
    with torch.no_grad():
        field.FeaExt_module_1.weight.mul_(2.0)
    torch.testing.assert_close(field.kernel_operands()[1].wmid[0].float(), 2.0 * wmid0)


@pytest.mark.parametrize(
    "bad, match",
    [("samples", "whole rays"), ("dtype", "dtype"), ("shape", "shape")],
)
def test_launch_validates_before_building(case, bad, match):
    """The CUDA launcher checks shapes and dtypes before it builds or
    launches anything."""
    _, params, inputs = case
    p = ff.split_params(_torch_flat(params), DE)
    ops = ff.prepare_operands(p)
    embed, sc, ac, zvals, zdists = map(torch.from_numpy, inputs)
    cb0, cb5, cbr1 = ff.conditioning_rows(p, sc, ac)
    embed = embed.to(torch.bfloat16)
    if bad == "samples":
        embed, zvals, zdists = embed[:, :, :7], zvals[:, :, :7], zdists[:, :, :7]
    elif bad == "dtype":
        embed = embed.float()
    else:
        cb0 = cb0[:, :-1]
    with pytest.raises(ValueError, match=match):
        ff._launch(embed.contiguous(), zvals.contiguous(), zdists.contiguous(),
                   cb0.contiguous(), cb5, cbr1, ops)
