"""The PyTorch port's fused field backward against the JAX package.

The port's gradient path (``FusedField``: the forward wrapper, then the
backward wrapper, which on CPU tensors runs the plain version
``fused_field_backward_reference``; the conditioning rows' fold-back by
autograd) is held against the JAX Pallas backward in interpret mode on the
same numpy inputs, weights and cotangents, and against f32 truth.  The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gazenerf_tpu.kernels.fused_field import FieldDims
from gazenerf_tpu.kernels.fused_field_bwd import pallas_backward
from gazenerf_tpu.models.mlp_nerf import NeRFFieldMLP as JaxField
from gazenerf_tpu.ops.integrate import integrate_rays as jax_integrate_rays
from gazenerf_tpu_torch.kernels import checks
from gazenerf_tpu_torch.kernels import fused_field as ff
from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb
from gazenerf_tpu_torch.models.mlp_nerf import _LAYERS, NeRFFieldMLP
from gazenerf_tpu_torch.ops.integrate import integrate_rays
from torch_threads import one_thread  # noqa: F401

B, R, S, DE, H, C = 2, 32, 8, 63, 64, 258
# the ROADMAP's gradient tolerance (tests/test_model_parity.py)
GRAD_REL_L2 = 2e-3
LEAVES = [f"{n}/{k}" for n in ["fea_%d" % i for i in range(8)] + ["density", "rgb_0", "rgb_1", "rgb_2"]
          for k in ("kernel", "bias")]
INPUTS = ("embed", "sc", "ac", "zvals", "zdists")


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(3)
    embed = rng.standard_normal((B, R, S, DE)).astype(np.float32) * 0.5
    sc = rng.standard_normal((B, 181)).astype(np.float32) * 0.1
    ac = rng.standard_normal((B, 127)).astype(np.float32) * 0.1
    zvals = np.sort(rng.standard_normal((B, R, S)).astype(np.float32), -1)
    zdists = np.abs(rng.standard_normal((B, R, S)).astype(np.float32)) * 0.2
    mlp = JaxField(embed_dims=DE, cond_dims=181, vd_cond_dims=127, hidden=H, res_nfeat=C)
    params = jax.jit(mlp.init)(jax.random.PRNGKey(1), *map(jnp.asarray, (embed, sc, ac)))
    params = {
        k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32) if k.endswith("/bias")
        else np.asarray(v)
        for k, v in params["params"].items()
    }  # random biases: a dropped or misplaced bias gradient must show
    cot = (
        rng.standard_normal((B, R, C)).astype(np.float32),
        rng.standard_normal((B, R)).astype(np.float32),
        rng.standard_normal((B, R)).astype(np.float32),
        rng.standard_normal((B, R, S)).astype(np.float32),
    )
    return params, (embed, sc, ac, zvals, zdists), cot


def _port_grads(params, inputs, cot, embed_dtype=torch.float32):
    """Gradients of sum(outputs * cot) through the port's ``FusedField``."""
    flat = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in params.items()}
    embed, sc, ac, zvals, zdists = (
        torch.from_numpy(np.array(x)).requires_grad_(True) for x in inputs
    )
    e = embed.detach().to(embed_dtype).requires_grad_(True)
    p = ff.split_params(flat, DE)
    with torch.no_grad():
        ops = ff.prepare_operands(p)
    out = ff.fused_field_render(p, ops, e, sc, ac, zvals, zdists)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cot))
    keys = list(flat)
    grads = torch.autograd.grad(loss, [flat[k] for k in keys] + [e, sc, ac, zvals, zdists])
    out = dict(zip(keys, grads[: len(keys)]))
    out.update(zip(INPUTS, grads[len(keys) :]))
    return out


@pytest.fixture(scope="module")
def both(case):
    params, inputs, cot = case
    dims = FieldDims(embed=DE, hidden=H, feat=C, samples=S, tile_rays=8, interpret=True)
    dparams, dembed, dsc, dac, dzvals, dzdists = pallas_backward(
        params, *map(jnp.asarray, inputs), dims, tuple(map(jnp.asarray, cot))
    )
    want = {k: np.asarray(v) for k, v in dparams.items()}
    want.update(zip(INPUTS, map(np.asarray, (dembed, dsc, dac, dzvals, dzdists))))
    return _port_grads(params, inputs, cot), want


@pytest.mark.parametrize("leaf", LEAVES + list(INPUTS))
def test_backward_matches_jax_kernel_interpret(both, leaf):
    """Same formulas and rounding points as the Pallas backward (recompute
    mode), the fold-back of the conditioning rows included; only f32
    summation order differs: each gradient leaf within 2e-3 relative L2."""
    got, want = both
    assert got[leaf].dtype == torch.float32
    assert tuple(got[leaf].shape) == want[leaf].shape, leaf
    assert np.abs(want[leaf]).max() > 0, leaf
    assert _rel_l2(got[leaf].numpy(), want[leaf]) < GRAD_REL_L2, leaf


def test_backward_is_as_close_to_f32_truth_as_bf16_autograd(case):
    """The JAX package's own bound for its kernel: the bf16 gradient is
    within max(2 x the bf16 autograd's deviation from f32 truth, 0.03)
    (tests/test_fused_field.py).  bf16 autograd: torch autograd through the
    forward's plain version; f32 truth: the f32 field module and
    ``integrate_rays``."""
    params, inputs, _ = case

    def loss(out):
        return sum((o**2).sum() for o in out)

    def grads(fn):
        flat = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in params.items()}
        xs = [torch.from_numpy(np.array(x)).requires_grad_(True) for x in inputs[:3]]
        zvals, zdists = (torch.from_numpy(np.array(x)) for x in inputs[3:])
        out = fn(flat, *xs, zvals, zdists)
        g = torch.autograd.grad(loss(out), list(flat.values()) + xs)
        return {"params": torch.cat([t.reshape(-1) for t in g[:-3]]), "embed": g[-3],
                "sc": g[-2], "ac": g[-1]}

    def kernel(flat, embed, sc, ac, zvals, zdists):
        p = ff.split_params(flat, DE)
        with torch.no_grad():
            ops = ff.prepare_operands(p)
        return ff.fused_field_render(p, ops, embed, sc, ac, zvals, zdists)

    def bf16_autograd(flat, embed, sc, ac, zvals, zdists):
        p = ff.split_params(flat, DE)
        cb0, cb5, cbr1 = ff.conditioning_rows(p, sc, ac)
        return ff.fused_field_reference(embed, zvals, zdists, cb0, cb5, cbr1,
                                        ff.prepare_operands(p))

    def truth(flat, embed, sc, ac, zvals, zdists):
        field = NeRFFieldMLP(DE, 181, 127, hidden=H, res_nfeat=C)
        params = {f"{module}.{kind}": _conv_view(flat, short, kind)
                  for module, short in _LAYERS for kind in ("weight", "bias")}
        feat, dens = torch.func.functional_call(field, params, (embed, sc, ac))
        return integrate_rays(feat, dens[..., 0], zdists, zvals)

    gk, gx, gt = grads(kernel), grads(bf16_autograd), grads(truth)
    for name in ("params", "embed", "sc", "ac"):
        k_err, x_err = _rel_l2(gk[name], gt[name]), _rel_l2(gx[name], gt[name])
        assert k_err < max(2.0 * x_err, 0.03), (name, k_err, x_err)


def _conv_view(flat, short, kind):
    """An upstream 1x1-conv parameter as a differentiable view of the
    flax-layout ``flat`` tensor ``{short}/kernel`` or ``{short}/bias``."""
    if kind == "bias":
        return flat[f"{short}/bias"]
    return flat[f"{short}/kernel"].t()[:, :, None, None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embed_cotangent_in_the_primal_dtype(case, dtype):
    """The JAX default hands the kernel an f32 embedding and gets an f32
    cotangent back; a bf16 embedding gets a bf16 one."""
    params, inputs, cot = case
    got = _port_grads(params, inputs, cot, embed_dtype=dtype)
    assert got["embed"].dtype == dtype
    if dtype == torch.bfloat16:
        want = _port_grads(params, inputs, cot)["embed"]
        torch.testing.assert_close(got["embed"].float(), want.to(dtype).float())


def test_missing_cotangents_count_as_zeros(case):
    """Losses read neither ``weights`` nor ``depth``: autograd then hands
    ``None`` for them, which the backward takes as zeros."""
    params, inputs, cot = case
    zero = (cot[0], cot[1], np.zeros_like(cot[2]), np.zeros_like(cot[3]))
    want = _port_grads(params, inputs, zero)
    flat = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in params.items()}
    embed, sc, ac, zvals, zdists = (torch.from_numpy(np.array(x)) for x in inputs)
    p = ff.split_params(flat, DE)
    with torch.no_grad():
        ops = ff.prepare_operands(p)
    feat, bga, _, _ = ff.fused_field_render(p, ops, embed, sc, ac, zvals, zdists)
    loss = (feat * torch.from_numpy(cot[0])).sum() + (bga * torch.from_numpy(cot[1])).sum()
    got = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    for k, v in got.items():
        torch.testing.assert_close(v, want[k], atol=0, rtol=0, msg=k)


def _bf16_exact(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16).float().numpy()


@pytest.fixture(scope="module")
def unrounded_both(case):
    """On bf16-exact weights and embedding (the values the kernels read):
    the port's ``FusedField`` with the unrounded float64 gradient as its
    backward, and JAX's f32 autograd of its XLA field and integration."""
    params, inputs, cot = case
    params = {k: _bf16_exact(v) if k.endswith("/kernel") else v for k, v in params.items()}
    inputs = (_bf16_exact(inputs[0]), *inputs[1:])

    def unrounded(*args):
        return ffb.FieldGrads(*(t.float() for t in ffb.fused_field_backward_unrounded(*args)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ffb, "fused_field_backward", unrounded)
        got = _port_grads(params, inputs, cot)
    mlp = JaxField(embed_dims=DE, cond_dims=181, vd_cond_dims=127, hidden=H, res_nfeat=C)

    def field(params, embed, sc, ac, zvals, zdists):
        feat, dens = mlp.apply({"params": params}, embed, sc, ac)
        return jax_integrate_rays(feat, dens[..., 0], zdists, zvals)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    out, vjp = jax.vjp(field, jp, *map(jnp.asarray, inputs))
    dparams, *dinputs = vjp(type(out)(*map(jnp.asarray, cot)))
    want = {k: np.asarray(v) for k, v in dparams.items()}
    want.update(zip(INPUTS, map(np.asarray, dinputs)))
    return got, want


@pytest.mark.parametrize("leaf", LEAVES + list(INPUTS))
def test_unrounded_gradient_matches_jax_f32_autograd(unrounded_both, leaf):
    """``fused_field_backward_unrounded``, what the kernel is measured
    against on the card, is the field's gradient: through the port's
    fold-back it matches JAX's f32 autograd of the same field within f32
    noise (1e-4 relative L2 per leaf)."""
    got, want = unrounded_both
    assert tuple(got[leaf].shape) == want[leaf].shape, leaf
    assert _rel_l2(got[leaf].numpy(), want[leaf]) < 1e-4, leaf


def test_narrow_limits_catch_bf16_data_gradients():
    """In the narrow case the limits hold the kernel's data gradients to f32
    accuracy: the plain version's own gradients pass, and the same with any
    one data gradient rounded to bf16 (what a kernel without the cotangent's
    low bf16 half would give) fail."""
    args, cot = checks.field_case(*checks.K2_CASES["narrow"], torch.device("cpu"))
    want = ffb.fused_field_backward_reference(*args, *cot)
    assert checks.k2_failures("narrow", want, want)[1] == []
    for name in ("dembed", "dcb0", "dcb5", "dbmid", "dbr0"):
        got = want._replace(**{name: getattr(want, name).to(torch.bfloat16).float()})
        fails = checks.k2_failures("narrow", got, want)[1]
        assert [f.split(":")[0] for f in fails] == [name], fails


@pytest.mark.parametrize(
    "bad, match",
    [("samples", "whole rays"), ("hidden", "multiple of 64"), ("dtype", "dtype")],
)
def test_launch_validates_before_building(case, bad, match):
    """The CUDA launcher checks shapes and dtypes before it builds or
    launches anything."""
    params, inputs, cot = case
    flat = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    p = ff.split_params(flat, DE)
    ops = ff.prepare_operands(p)
    embed, sc, ac, zvals, zdists = map(torch.from_numpy, inputs)
    cb0, cb5, cbr1 = ff.conditioning_rows(p, sc, ac)
    g = [torch.from_numpy(c) for c in cot]
    embed = embed.to(torch.bfloat16)
    if bad == "samples":
        embed, zvals, zdists, g[3] = (t[:, :, :7].contiguous() for t in (embed, zvals, zdists, g[3]))
    elif bad == "hidden":
        ops = ops._replace(w0e=ops.w0e[:48], wr2=ops.wr2[:24])
    else:
        g[0] = g[0].double()
    with pytest.raises(ValueError, match=match):
        ffb._launch(embed, zvals, zdists, cb0, cb5, cbr1, ops, *g)
