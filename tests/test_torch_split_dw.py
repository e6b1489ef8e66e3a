"""The ``split_dw`` mode of the port's fused field backward against the JAX
package.

JAX's ``split_dw`` (``pallas_split_dw``) has its Pallas backward write the
bf16 cotangents and contracts every weight gradient over the stash in one
large-K matmul; it implies the bf16 stash of every layer, and its dWd takes
the bf16-rounded density cotangent whatever ``dens_vpu`` says.  The port's
K2 contracts its weight gradients that way in every mode, and ``dens_vpu``
changes its dWd alone, so the model runs ``pallas_split_dw`` as K2 reading
the stash without ``dens_vpu`` (``models/gaze_nerf.kernel_setting``).  Here,
on the CPU (the plain versions): the backward in the mode the flag selects
against JAX's ``split_dw`` backward in interpret mode, per leaf, dWd to f32
noise; a ``GazeNeRF`` training step with ``pallas_split_dw`` against the JAX
model's; the flags ``split_dw`` overrides; the dual path, which clears it,
as JAX's does.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gazenerf_tpu.kernels.fused_field import FieldDims, _pallas_forward
from gazenerf_tpu.kernels.fused_field_bwd import pallas_backward
from gazenerf_tpu_torch import GazeNeRF, ModelConfig
from gazenerf_tpu_torch.kernels import fused_field as ff
from gazenerf_tpu_torch.kernels import fused_field2 as ff2
from gazenerf_tpu_torch.kernels import fused_field2_bwd as ffb2
from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb
from gazenerf_tpu_torch.models import gaze_nerf
from test_torch_stash_modes import (  # noqa: F401
    DE, GRAD_REL_L2, H, INPUTS, LEAVES, C, S, _flat, _flat_group, _rel_l2, case,
)
from test_torch_train import GROUPS, _jax_steps, _port_step, _step_configs, setup  # noqa: F401
from torch_threads import one_thread  # noqa: F401

SPLIT = dict(pallas_split_dw=True, pallas_dens_vpu=True)


def split_dw_mode(**flags):
    """The fused backward's settings (``stash_acts``, ``dens_vpu``) that a
    model with ``pallas_split_dw`` and ``flags`` runs."""
    cfg = ModelConfig(compute_dtype="bfloat16", use_pallas=True, **{**SPLIT, **flags})
    return dict(stash_acts=gaze_nerf.kernel_setting(cfg, "pallas_stash_acts"),
                dens_vpu=gaze_nerf.kernel_setting(cfg, "pallas_dens_vpu"))


@pytest.fixture(scope="module")
def jax_split(case):
    """JAX's forward with the stash, then its backward on that stash in
    ``split_dw`` mode and, for the contrast, in ``dens_vpu`` mode without
    it, in interpret mode."""
    params, inputs, cot = case
    x = tuple(map(jnp.asarray, inputs))
    out = {}
    for name, split_dw in (("split_dw", True), ("dens_vpu", False)):
        dims = FieldDims(embed=DE, hidden=H, feat=C, samples=S, tile_rays=8, interpret=True,
                         bwd_tile_rays=8, stash_acts=True, dens_vpu=True, split_dw=split_dw)
        _, stash = _pallas_forward(params, *x, dims)
        dparams, *dins = pallas_backward(params, *x, dims, tuple(map(jnp.asarray, cot)), stash)
        grads = {k: np.asarray(v) for k, v in dparams.items()}
        grads.update(zip(INPUTS, map(np.asarray, dins)))
        out[name] = grads, [np.asarray(jnp.asarray(t, jnp.float32)) for t in stash]
    return out


@pytest.fixture(scope="module")
def port_split(case, jax_split):
    """The port's gradient through ``FusedField`` in the mode that
    ``pallas_split_dw`` selects (with ``pallas_dens_vpu`` asked for too,
    which it overrides): the plain K1 writes the stash, the plain K2 reads
    it; and the plain K2 in that mode on JAX's own stash."""
    params, inputs, cot = case
    flat = _flat(params, True)
    xs = [torch.from_numpy(np.array(x)).requires_grad_(True) for x in inputs]
    p = ff.split_params(flat, DE)
    with torch.no_grad():
        ops = ff.prepare_operands(p)
    mode = split_dw_mode()
    res = ff.fused_field_render(p, ops, *xs, **mode)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(res, cot))
    keys = list(flat)
    grads = dict(zip(keys + list(INPUTS), torch.autograd.grad(loss, [flat[k] for k in keys] + xs)))
    embed, sc, ac, zvals, zdists = map(torch.from_numpy, inputs)
    with torch.no_grad():
        cb0, cb5, cbr1 = ff.conditioning_rows(p, sc, ac)
        stash = [torch.from_numpy(t).to(torch.bfloat16) for t in jax_split["split_dw"][1]]
        on_jax = ffb.fused_field_backward(
            embed.to(torch.bfloat16), zvals, zdists, cb0, cb5, cbr1, ops,
            *map(torch.from_numpy, cot), stash=stash, dens_vpu=mode["dens_vpu"])
    return grads, on_jax


@pytest.mark.parametrize("leaf", LEAVES + list(INPUTS))
def test_split_dw_backward_matches_jax_kernel_interpret(jax_split, port_split, leaf):
    """The port's ``split_dw`` gradient (the plain K1's stash, the plain K2)
    against JAX's ``split_dw`` backward on its stash: each leaf within the
    stash modes' 2e-3 relative L2 (``tests/test_torch_stash_modes.py``)."""
    want = jax_split["split_dw"][0][leaf]
    got = port_split[0][leaf]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, leaf
    assert np.abs(want).max() > 0, leaf
    assert _rel_l2(got.numpy(), want) < GRAD_REL_L2, leaf


def test_split_dw_density_weight_gradient_rounds_as_jax(jax_split, port_split):
    """On JAX's own stash the plain K2's dWd in the ``split_dw`` mode is the
    contraction of the bf16-rounded density cotangent, as JAX's epilogue's
    (``ddens.astype(bf)``), to f32 summation noise (1e-5 relative L2),
    although ``dens_vpu`` is on; JAX's ``dens_vpu`` dWd without
    ``split_dw`` differs from it by more than that."""
    want = jax_split["split_dw"][0]["density/kernel"]
    other = jax_split["dens_vpu"][0]["density/kernel"]
    assert _rel_l2(port_split[1].dWd.numpy(), want) < 1e-5
    assert _rel_l2(other, want) > 1e-4


def test_split_dw_is_the_rounded_stash_mode_on_the_cpu(case):
    """``pallas_split_dw`` runs K2 reading the stash without ``dens_vpu``
    whatever ``pallas_stash_acts`` and ``pallas_dens_vpu`` say; the plain
    K2 in that mode gives every output of the ``dens_vpu`` mode but dWd."""
    for stash_acts in (False, True):
        for dens_vpu in (False, True):
            got = split_dw_mode(pallas_stash_acts=stash_acts, pallas_dens_vpu=dens_vpu)
            assert got == dict(stash_acts=True, dens_vpu=False), (stash_acts, dens_vpu, got)
    params, inputs, cot = case
    p = ff.split_params(_flat(params), DE)
    embed, sc, ac, zvals, zdists = map(torch.from_numpy, inputs)
    with torch.no_grad():
        cb0, cb5, cbr1 = ff.conditioning_rows(p, sc, ac)
        args = (embed.to(torch.bfloat16), zvals, zdists, cb0, cb5, cbr1, ff.prepare_operands(p))
        _, acts = ff.fused_field_forward(*args, stash=True)
        cots = tuple(map(torch.from_numpy, cot))
        split = ffb.fused_field_backward(*args, *cots, stash=acts)
        vpu = ffb.fused_field_backward(*args, *cots, stash=acts, dens_vpu=True)
    differ = [n for n, a, b in zip(split._fields, split, vpu) if not torch.equal(a, b)]
    assert differ == ["dWd"], differ


@pytest.fixture(scope="module")
def split_step(setup):
    """One training step with bf16 fields and renderer and
    ``pallas_split_dw`` (with ``pallas_dens_vpu``): JAX with its Pallas
    kernels in interpret mode and the port (the plain K1 and K2, their
    calls recorded); the common truth is the port's f32 step, as in
    ``tests/test_torch_stash_modes.py``."""
    jcfg, params, offsets, vgg, vgg_vars, batch = setup
    f32, bf16 = _step_configs(jcfg)
    split = bf16.replace(model=dataclasses.replace(bf16.model, **SPLIT))
    ((_, want),) = _jax_steps(setup, split)
    calls = []
    fwd, bwd = ff.fused_field_forward, ffb.fused_field_backward
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ff, "fused_field_forward", lambda *a, stash=False, **k: (
            calls.append(("forward", stash)), fwd(*a, stash=stash, **k))[1])
        mp.setattr(ffb, "fused_field_backward", lambda *a, **k: (
            calls.append(("backward", k.get("stash") is not None, k.get("dens_vpu", False))),
            bwd(*a, **k))[1])
        got = _port_step(split, params, offsets, vgg_vars, batch)[1]
    truth = _port_step(f32, params, offsets, vgg_vars, batch)[1]
    return got, want, truth, split.model.n_upsample_blocks, calls


@pytest.mark.parametrize("group", GROUPS)
def test_split_dw_step_gradients_match_jax_interpret(split_step, group):
    """The bf16 step's bound of ``tests/test_torch_train.py`` per parameter
    group: with d = the JAX ``split_dw`` step's relative L2 from the f32
    gradient, the port's lies within 2d of the f32 gradient and within 2d
    of JAX's."""
    got, want, truth, n_blocks, _ = split_step
    got, want, truth = (_flat_group(t, group, n_blocks) for t in (got, want, truth))
    d = _rel_l2(want, truth)
    assert 0 < d < 0.5
    assert _rel_l2(got, truth) < 2 * d
    assert _rel_l2(got, want) < 2 * d


def test_split_dw_step_takes_the_stash_and_the_mode(split_step):
    """The ``split_dw`` step writes the stash in each field's forward and
    reads it in each field's backward, without ``dens_vpu``."""
    *_, calls = split_step
    assert calls == [("forward", True)] * 2 + [("backward", True, False)] * 2, calls


@pytest.mark.parametrize("option", [
    dict(pallas_stash_every=2),
    dict(pallas_stash_dtype="int8"),
    dict(pallas_fuse_embed=True),
])
def test_split_dw_sets_what_jax_sets(option):
    """As JAX's ``_fused_dims``: ``split_dw`` runs the bf16 stash of every
    layer with the embedding outside the kernel, whatever these flags say;
    without it the stash's forms run as the config says (every second trunk
    layer, the int8 stash) and ``pallas_fuse_embed`` gives the kernels the
    points."""
    cfg = ModelConfig(compute_dtype="bfloat16", use_pallas=True, pallas_stash_acts=True, **option)
    model = GazeNeRF(cfg, device="cpu")
    if "pallas_fuse_embed" in option:
        assert model.encodes_points
    else:
        assert gaze_nerf.stash_form(model.cfg) != ff.StashForm()
    model = GazeNeRF(dataclasses.replace(cfg, pallas_split_dw=True), device="cpu")
    assert model.fused and not model.dual and not model.encodes_points
    assert gaze_nerf.stash_form(model.cfg) == ff.StashForm()
    for name, value in (("pallas_stash_every", 1), ("pallas_stash_dtype", "bfloat16"),
                        ("pallas_fuse_embed", False)):
        assert gaze_nerf.kernel_setting(model.cfg, name) == value, name


def test_split_dw_is_cleared_on_the_dual_path(setup, monkeypatch):
    """On the dual-branch path ``split_dw`` is cleared, as JAX's dual path
    clears it: a step with the stash takes the dual forward with the stash
    and the dual backward, never the single-branch backward, with the same
    gradients as the step without ``split_dw``."""
    jcfg, params, offsets, vgg, vgg_vars, batch = setup
    _, bf16 = _step_configs(jcfg)
    calls = []
    for mod, name in ((ff2, "fused_dual_forward"), (ffb2, "fused_dual_backward"),
                      (ffb, "fused_field_backward")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    dual = dict(use_pallas=True, pallas_dual_branch=True, pallas_stash_acts=True)
    got = {}
    for split in (True, False):
        calls.clear()
        cfg = bf16.replace(model=dataclasses.replace(bf16.model, **dual, pallas_split_dw=split))
        got[split] = _port_step(cfg, params, offsets, vgg_vars, batch)[1]
        assert calls == ["fused_dual_forward", "fused_dual_backward"], (split, calls)
    for name, g in got[True]["net"].items():
        assert torch.equal(g, got[False]["net"][name]), name
