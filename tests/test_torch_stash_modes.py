"""The single-branch stash and ``dens_vpu`` modes of the port's fused field
kernels against the JAX package.

The plain versions that the wrappers run for CPU tensors: K1 writing the
bf16 activation stash (``fused_field_forward(..., stash=True)``) against
the JAX Pallas forward ``_pallas_forward`` with ``stash_acts`` in interpret
mode, outputs and every stash tensor; K2 reading that stash
(``fused_field_backward(..., stash=, dens_vpu=)``) against the Pallas
backward ``pallas_backward`` on JAX's own stash, per gradient leaf, with
``dens_vpu`` on and off; and a ``GazeNeRF`` training step with
``pallas_stash_acts`` and ``pallas_dens_vpu`` (what the training CLI runs)
against the JAX model's on the same transplanted weights.  The CUDA
kernels are held against these plain versions on the card by
``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gazenerf_tpu.kernels.fused_field import FieldDims, _pallas_forward
from gazenerf_tpu.kernels.fused_field_bwd import pallas_backward
from gazenerf_tpu.models.mlp_nerf import NeRFFieldMLP as JaxField
from gazenerf_tpu_torch.kernels import fused_field as ff
from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb
from gazenerf_tpu_torch.kernels.checks import STASH_SLOTS
from gazenerf_tpu_torch.utils.transplant import params_from_jax
from test_torch_train import GROUPS, _jax_steps, _port_step, _step_configs, setup  # noqa: F401
from torch_threads import one_thread  # noqa: F401

B, R, S, DE, H, C = 2, 32, 8, 63, 64, 258
OUTPUTS = ("feat_int", "bg_alpha", "depth", "weights")
LEAVES = [f"{n}/{k}" for n in ["fea_%d" % i for i in range(8)] + ["density", "rgb_0", "rgb_1", "rgb_2"]
          for k in ("kernel", "bias")]
INPUTS = ("embed", "sc", "ac", "zvals", "zdists")
DENS = {"dens_vpu": True, "rounded": False}
# the ROADMAP's gradient tolerance, as for the recompute mode
# (tests/test_torch_fused_field_bwd.py)
GRAD_REL_L2 = 2e-3
STASH_FLAGS = dict(pallas_stash_acts=True, pallas_dens_vpu=True)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def case():
    """A field with random biases, its inputs and N(0, 1) cotangents of the
    four outputs, from numpy seeds."""
    rng = np.random.default_rng(13)
    embed = rng.standard_normal((B, R, S, DE)).astype(np.float32) * 0.5
    sc = rng.standard_normal((B, 181)).astype(np.float32) * 0.1
    ac = rng.standard_normal((B, 127)).astype(np.float32) * 0.1
    zvals = np.sort(rng.standard_normal((B, R, S)).astype(np.float32), -1)
    zdists = np.abs(rng.standard_normal((B, R, S)).astype(np.float32)) * 0.2
    mlp = JaxField(embed_dims=DE, cond_dims=181, vd_cond_dims=127, hidden=H, res_nfeat=C)
    params = jax.jit(mlp.init)(jax.random.PRNGKey(4), *map(jnp.asarray, (embed, sc, ac)))
    params = {  # random biases: a dropped or misplaced bias must show
        k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32) if k.endswith("/bias")
        else np.asarray(v)
        for k, v in params["params"].items()
    }
    cot = (rng.standard_normal((B, R, C)).astype(np.float32),
           rng.standard_normal((B, R)).astype(np.float32),
           rng.standard_normal((B, R)).astype(np.float32),
           rng.standard_normal((B, R, S)).astype(np.float32))
    return params, (embed, sc, ac, zvals, zdists), cot


@pytest.fixture(scope="module")
def jax_kernels(case):
    """JAX's forward with the stash and its backward on that stash, with
    and without ``dens_vpu``, in interpret mode, each run once."""
    params, inputs, cot = case
    x = tuple(map(jnp.asarray, inputs))
    out = {}
    for name, dens_vpu in DENS.items():
        dims = FieldDims(embed=DE, hidden=H, feat=C, samples=S, tile_rays=8, interpret=True,
                         stash_acts=True, dens_vpu=dens_vpu)
        fwd, stash = _pallas_forward(params, *x, dims)
        dparams, *dins = pallas_backward(params, *x, dims, tuple(map(jnp.asarray, cot)), stash)
        grads = {k: np.asarray(v) for k, v in dparams.items()}
        grads.update(zip(INPUTS, map(np.asarray, dins)))
        out[name] = ([np.asarray(t) for t in fwd],
                     [np.asarray(jnp.asarray(t, jnp.float32)) for t in stash], grads)
    return out


def _flat(params, requires_grad=False):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(requires_grad)
            for k, v in params.items()}


@pytest.fixture(scope="module")
def port_forward(case):
    """The port's plain K1 with the stash on the same inputs."""
    params, inputs, _ = case
    p = ff.split_params(_flat(params), DE)
    embed, sc, ac, zvals, zdists = map(torch.from_numpy, inputs)
    with torch.no_grad():
        cb0, cb5, cbr1 = ff.conditioning_rows(p, sc, ac)
        return ff.fused_field_forward(embed.to(torch.bfloat16), zvals, zdists, cb0, cb5, cbr1,
                                      ff.prepare_operands(p), stash=True)


@pytest.mark.parametrize("output", range(4), ids=OUTPUTS)
def test_stash_forward_matches_jax_kernel_interpret(jax_kernels, port_forward, output):
    """The plain K1 with the stash against the Pallas forward with
    ``stash_acts``, with and without ``dens_vpu`` (one density head in the
    port): K1's bound against JAX (tests/test_torch_fused_field.py), 5e-3
    absolute."""
    got, _ = port_forward
    for name in DENS:
        np.testing.assert_allclose(got[output].numpy(), jax_kernels[name][0][output],
                                   atol=5e-3, rtol=0, err_msg=name)


@pytest.mark.parametrize("slot", range(10), ids=STASH_SLOTS)
def test_stash_matches_jax_kernel_interpret(jax_kernels, port_forward, slot):
    """The plain K1's stash against the Pallas kernel's, every slot in its
    layout (``stash_layout`` with ``stash_every=1``) at K1's bound, 5e-3
    absolute: both round the same f32 sums to bf16, and a flipped rounding
    moves a value by a bf16 step."""
    _, got = port_forward
    want = jax_kernels["rounded"][1][slot]
    width = H // 2 if STASH_SLOTS[slot] == "y1" else H
    assert got[slot].dtype == torch.bfloat16 and tuple(got[slot].shape) == (B, R, S, width)
    assert want.shape == (B, R, S, width)
    np.testing.assert_allclose(got[slot].float().numpy(), want, atol=5e-3, rtol=0)


@pytest.fixture(scope="module")
def port_backward(case, jax_kernels):
    """The port's gradient through ``FusedField`` with the stash, with and
    without ``dens_vpu`` (the plain K1 writes the stash, the plain K2 reads
    it), and the plain K2 on JAX's own stash."""
    params, inputs, cot = case
    out = {}
    for name, dens_vpu in DENS.items():
        flat = _flat(params, True)
        xs = [torch.from_numpy(np.array(x)).requires_grad_(True) for x in inputs]
        p = ff.split_params(flat, DE)
        with torch.no_grad():
            ops = ff.prepare_operands(p)
        res = ff.fused_field_render(p, ops, *xs, stash_acts=True, dens_vpu=dens_vpu)
        loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(res, cot))
        keys = list(flat)
        g = torch.autograd.grad(loss, [flat[k] for k in keys] + xs)
        grads = dict(zip(keys + list(INPUTS), g))
        # the plain K2 on JAX's stash, the same cotangents
        embed, sc, ac, zvals, zdists = map(torch.from_numpy, inputs)
        with torch.no_grad():
            cb0, cb5, cbr1 = ff.conditioning_rows(p, sc, ac)
            stash = [torch.from_numpy(t).to(torch.bfloat16) for t in jax_kernels[name][1]]
            on_jax = ffb.fused_field_backward(
                embed.to(torch.bfloat16), zvals, zdists, cb0, cb5, cbr1, ops,
                *map(torch.from_numpy, cot), stash=stash, dens_vpu=dens_vpu)
        out[name] = grads, on_jax
    return out


@pytest.mark.parametrize("dens", DENS, ids=DENS.keys())
@pytest.mark.parametrize("leaf", LEAVES + list(INPUTS))
def test_stash_backward_matches_jax_kernel_interpret(jax_kernels, port_backward, leaf, dens):
    """The port's stash-mode gradient against the Pallas backward on its
    stash: the same formulas and rounding points (with ``dens_vpu`` the
    density head's weight gradient from the unrounded cotangent), the
    conditioning rows folded back by autograd; each leaf within the
    recompute mode's 2e-3 relative L2."""
    want = jax_kernels[dens][2][leaf]
    got = port_backward[dens][0][leaf]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, leaf
    assert np.abs(want).max() > 0, leaf
    assert _rel_l2(got.numpy(), want) < GRAD_REL_L2, leaf


@pytest.mark.parametrize("dens", DENS, ids=DENS.keys())
def test_density_weight_gradient_reads_jax_stash_as_jax(case, jax_kernels, port_backward,
                                                        dens):
    """On JAX's own stash the plain K2's density head weight gradient, the
    one output that ``dens_vpu`` changes, agrees with the Pallas kernel's to
    f32 summation noise (1e-5 relative L2) in each mode; the two modes
    differ by more than that, so a mode read the wrong way fails here."""
    on_jax = port_backward[dens][1]
    want = jax_kernels[dens][2]["density/kernel"]
    other = jax_kernels["rounded" if dens == "dens_vpu" else "dens_vpu"][2]["density/kernel"]
    assert _rel_l2(on_jax.dWd.numpy(), want) < 1e-5
    assert _rel_l2(other, want) > 1e-4


def test_stash_reads_equal_recompute_on_the_cpu(case):
    """K2 reading K1's stash gives K2's recompute to the bit (the plain
    versions round at the same points); ``dens_vpu`` changes dWd alone."""
    params, inputs, cot = case
    p = ff.split_params(_flat(params), DE)
    embed, sc, ac, zvals, zdists = map(torch.from_numpy, inputs)
    with torch.no_grad():
        cb0, cb5, cbr1 = ff.conditioning_rows(p, sc, ac)
        args = (embed.to(torch.bfloat16), zvals, zdists, cb0, cb5, cbr1, ff.prepare_operands(p))
        _, acts = ff.fused_field_forward(*args, stash=True)
        cots = tuple(map(torch.from_numpy, cot))
        recompute = ffb.fused_field_backward(*args, *cots)
        for dens_vpu in (False, True):
            got = ffb.fused_field_backward(*args, *cots, stash=acts, dens_vpu=dens_vpu)
            differ = [n for n, a, b in zip(got._fields, got, recompute) if not torch.equal(a, b)]
            assert differ == (["dWd"] if dens_vpu else []), differ


@pytest.fixture(scope="module")
def stash_step(setup):
    """One training step with bf16 fields and renderer, the stash and
    ``dens_vpu``: JAX with its Pallas kernels in interpret mode and the port
    (on the CPU the plain K1 and K2); the common truth is the port's f32
    step, which ``tests/test_torch_train.py`` holds to JAX's f32 step (within
    1.4e-2 relative L2 at most, the camera offsets', against the d >= 1e-2
    of the bf16 paths below), so this file compiles one JAX step, not two."""
    jcfg, params, offsets, vgg, vgg_vars, batch = setup
    f32, bf16 = _step_configs(jcfg)
    stash = bf16.replace(model=dataclasses.replace(bf16.model, **STASH_FLAGS))
    ((_, want),) = _jax_steps(setup, stash)
    got = _port_step(stash, params, offsets, vgg_vars, batch)[1]
    truth = _port_step(f32, params, offsets, vgg_vars, batch)[1]
    return got, want, truth, stash.model.n_upsample_blocks


def _flat_group(tree, group, n_blocks):
    """One parameter group of a gradient tree, the port's or JAX's, as a
    vector (the network in the port's names and layouts)."""
    if group != "net":
        return np.asarray(tree[group], np.float64).ravel()
    net = tree["net"]
    if not isinstance(next(iter(net.values())), torch.Tensor):  # JAX's tree
        net = params_from_jax(net, n_blocks)
    return np.concatenate([net[n].numpy().ravel() for n in sorted(net)])


@pytest.mark.parametrize("group", GROUPS)
def test_stash_step_gradients_match_jax_interpret(stash_step, group):
    """The bf16 step's bound of ``tests/test_torch_train.py`` per parameter
    group: with d = the JAX step's relative L2 from the f32 gradient, the
    port's lies within 2d of the f32 gradient and within 2d of JAX's."""
    got, want, truth, n_blocks = stash_step
    got, want, truth = (_flat_group(t, group, n_blocks) for t in (got, want, truth))
    d = _rel_l2(want, truth)
    assert 0 < d < 0.5
    assert _rel_l2(got, truth) < 2 * d
    assert _rel_l2(got, want) < 2 * d


def test_stash_step_takes_the_stash_modes(setup, monkeypatch):
    """A training step with the stash and ``dens_vpu`` writes the stash in
    each field's forward and reads it, with ``dens_vpu``, in each field's
    backward; without them neither."""
    jcfg, params, offsets, vgg, vgg_vars, batch = setup
    _, bf16 = _step_configs(jcfg)
    calls = []
    fwd, bwd = ff.fused_field_forward, ffb.fused_field_backward
    monkeypatch.setattr(ff, "fused_field_forward", lambda *a, stash=False, **k: (
        calls.append(("forward", stash)), fwd(*a, stash=stash, **k))[1])
    monkeypatch.setattr(ffb, "fused_field_backward", lambda *a, stash=None, dens_vpu=False, **k: (
        calls.append(("backward", stash is not None, dens_vpu)),
        bwd(*a, stash=stash, dens_vpu=dens_vpu, **k))[1])
    for flags, want in ((STASH_FLAGS, [("forward", True)] * 2 + [("backward", True, True)] * 2),
                        ({}, [("forward", False)] * 2 + [("backward", False, False)] * 2)):
        calls.clear()
        cfg = bf16.replace(model=dataclasses.replace(bf16.model, **flags))
        _port_step(cfg, params, offsets, vgg_vars, batch)
        assert calls == want, (flags, calls)


def test_render_writes_no_stash(case, monkeypatch):
    """Without a gradient the forward writes no stash (JAX's primal call
    skips it), and the outputs are the recompute mode's."""
    params, inputs, _ = case
    p = ff.split_params(_flat(params), DE)
    stashed = []
    fwd = ff.fused_field_forward
    monkeypatch.setattr(ff, "fused_field_forward", lambda *a, stash=False, **k: (
        stashed.append(stash), fwd(*a, stash=stash, **k))[1])
    with torch.no_grad():
        ops = ff.prepare_operands(p)
        x = tuple(map(torch.from_numpy, inputs))
        got = ff.fused_field_render(p, ops, *x, stash_acts=True, dens_vpu=True)
        want = ff.fused_field_render(p, ops, *x)
    assert stashed == [False, False]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
