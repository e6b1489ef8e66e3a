"""The PyTorch port's dual-branch field kernels against the JAX package.

The plain versions of the dual forward (``fused_dual_reference``, K3) and
of the stash-reading dual backward (``fused_dual_backward_reference``, K4),
what the wrappers run for CPU tensors, are held against the JAX Pallas
kernels ``_dual_forward`` and ``dual_backward`` in interpret mode on the same
numpy inputs, weights and cotangents; the backward on JAX's own stash.  The
port's autograd ``FusedDual`` is held against two single-branch
``FusedField`` calls.  The CUDA kernels themselves are held against the
plain versions on the card by ``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gazenerf_tpu.kernels.fused_field import FieldDims
from gazenerf_tpu.kernels.fused_field2 import _dual_forward
from gazenerf_tpu.kernels.fused_field2_bwd import dual_backward
from gazenerf_tpu.models.mlp_nerf import NeRFFieldMLP as JaxField
from gazenerf_tpu_torch.kernels import fused_field as ff
from gazenerf_tpu_torch.kernels import fused_field2 as ff2
from gazenerf_tpu_torch.kernels import fused_field2_bwd as ffb2
from gazenerf_tpu_torch.kernels.checks import STASH_SLOTS
from torch_threads import one_thread  # noqa: F401

B, R, S, DE, H, C = 2, 32, 8, 63, 64, 258
BRANCHES = ("face", "eyes")
OUTPUTS = ("feat_int", "bg_alpha", "depth", "weights")
LEAVES = [f"{n}/{k}" for n in ["fea_%d" % i for i in range(8)] + ["density", "rgb_0", "rgb_1", "rgb_2"]
          for k in ("kernel", "bias")]
INPUTS = ("embed", "sc", "ac", "zvals", "zdists")
# the ROADMAP's gradient tolerance (tests/test_model_parity.py), as for the
# single-branch backward (tests/test_torch_fused_field_bwd.py)
GRAD_REL_L2 = 2e-3


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def case():
    """Two fields (face, eyes) with random biases, the shared inputs and
    N(0, 1) cotangents of both branches' four outputs, from numpy seeds."""
    rng = np.random.default_rng(11)
    embed = rng.standard_normal((B, R, S, DE)).astype(np.float32) * 0.5
    sc = rng.standard_normal((B, 181)).astype(np.float32) * 0.1
    ac = rng.standard_normal((B, 127)).astype(np.float32) * 0.1
    zvals = np.sort(rng.standard_normal((B, R, S)).astype(np.float32), -1)
    zdists = np.abs(rng.standard_normal((B, R, S)).astype(np.float32)) * 0.2
    mlp = JaxField(embed_dims=DE, cond_dims=181, vd_cond_dims=127, hidden=H, res_nfeat=C)
    params = []
    for key in (1, 2):
        p = jax.jit(mlp.init)(jax.random.PRNGKey(key), *map(jnp.asarray, (embed, sc, ac)))
        params.append({  # random biases: a dropped or misplaced bias must show
            k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32) if k.endswith("/bias")
            else np.asarray(v)
            for k, v in p["params"].items()
        })
    cot = tuple(
        (rng.standard_normal((B, R, C)).astype(np.float32),
         rng.standard_normal((B, R)).astype(np.float32),
         rng.standard_normal((B, R)).astype(np.float32),
         rng.standard_normal((B, R, S)).astype(np.float32))
        for _ in BRANCHES
    )
    return params, (embed, sc, ac, zvals, zdists), cot


@pytest.fixture(scope="module")
def jax_dual(case):
    """JAX's dual kernels in interpret mode, each run once: the forward
    with the stash, then the backward on that stash."""
    params, inputs, cot = case
    dims = FieldDims(embed=DE, hidden=H, feat=C, samples=S, tile_rays=16, interpret=True,
                     stash_acts=True)
    outs, stash = _dual_forward(params, *map(jnp.asarray, inputs), dims)
    grads = dual_backward(params, *map(jnp.asarray, inputs), dims,
                          tuple(tuple(map(jnp.asarray, g)) for g in cot), stash)
    to_np = lambda t: np.asarray(jnp.asarray(t, jnp.float32))  # noqa: E731
    return (jax.tree_util.tree_map(to_np, outs), jax.tree_util.tree_map(to_np, stash),
            jax.tree_util.tree_map(to_np, grads))


def _flat(params, requires_grad=False):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(requires_grad)
            for k, v in params.items()}


def _operands(flats):
    ps = [ff.split_params(f, DE) for f in flats]
    with torch.no_grad():
        ops = ff2.stack_operands([ff.prepare_operands(p) for p in ps])
    return ps, ops


@pytest.fixture(scope="module")
def port_forward(case):
    """The port's plain K3 on the same inputs, with the stash."""
    params, inputs, _ = case
    ps, ops = _operands([_flat(p) for p in params])
    embed, sc, ac, zvals, zdists = map(torch.from_numpy, inputs)
    cb0, cb5, cbr1 = ff2.conditioning_rows(ps, sc, ac)
    with torch.no_grad():
        return ff2.fused_dual_forward(embed.to(torch.bfloat16), zvals, zdists, cb0, cb5, cbr1,
                                      ops, stash=True)


@pytest.mark.parametrize("branch", range(2), ids=BRANCHES)
@pytest.mark.parametrize("output", range(4), ids=OUTPUTS)
def test_dual_forward_matches_jax_kernel_interpret(case, jax_dual, port_forward, branch, output):
    """The plain K3 against the Pallas dual forward: the single-branch
    kernel's rounding points, so K1's bound against JAX
    (tests/test_torch_fused_field.py): 5e-3 absolute."""
    (got, _), (want, _, _) = port_forward, jax_dual
    np.testing.assert_allclose(got[branch][output].numpy(), want[branch][output],
                               atol=5e-3, rtol=0)


@pytest.mark.parametrize("branch", range(2), ids=BRANCHES)
@pytest.mark.parametrize("slot", range(10), ids=STASH_SLOTS)
def test_dual_stash_matches_jax_kernel_interpret(jax_dual, port_forward, branch, slot):
    """The plain K3's stash against the Pallas kernel's: every one of the 20
    bf16 tensors at K1's bound, 5e-3 absolute.  Both round the same f32 sums
    to bf16; where the summation order flips a rounding (readings: 3e-5 of
    the values, by at most 1.2e-4) the value moves by a bf16 step."""
    (_, got), (_, want, _) = port_forward, jax_dual
    a, b = got[branch][slot], want[branch][slot]
    assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape
    np.testing.assert_allclose(a.float().numpy(), b, atol=5e-3, rtol=0)


def test_dual_reference_is_the_single_branch_reference_per_branch(case, port_forward):
    """Without the stash each branch of the plain K3 is the plain K1 on that
    branch's operands and conditioning rows: the same bits."""
    params, inputs, _ = case
    ps, ops = _operands([_flat(p) for p in params])
    embed, sc, ac, zvals, zdists = map(torch.from_numpy, inputs)
    rows = ff2.conditioning_rows(ps, sc, ac)
    with torch.no_grad():
        dual = ff2.fused_dual_forward(embed.to(torch.bfloat16), zvals, zdists, *rows, ops)
        for i in range(2):
            single = ff.fused_field_forward(embed.to(torch.bfloat16), zvals, zdists,
                                            *(r[i] for r in rows), ff2.branch_operands(ops, i))
            for a, b, c in zip(dual[i], single, port_forward[0][i]):
                torch.testing.assert_close(a, b, atol=0, rtol=0)
                torch.testing.assert_close(a, c, atol=0, rtol=0)


@pytest.fixture(scope="module")
def port_backward(case, jax_dual):
    """The port's plain K4 on JAX's stash and cotangents; the conditioning
    rows' and the weight blocks' gradients folded back into the parameters
    by autograd, as ``FusedDual``'s caller has them."""
    params, inputs, cot = case
    _, stash, _ = jax_dual
    flats = [_flat(p, requires_grad=True) for p in params]
    ps, ops = _operands(flats)
    embed, sc, ac, zvals, zdists = (torch.from_numpy(np.array(x)) for x in inputs)
    sc.requires_grad_(True)
    ac.requires_grad_(True)
    rows = ff2.conditioning_rows(ps, sc, ac)
    acts = tuple(tuple(torch.from_numpy(np.array(a)).to(torch.bfloat16) for a in br)
                 for br in stash)
    g = [tuple(map(torch.from_numpy, c)) for c in cot]
    d = ffb2.fused_dual_backward(embed.to(torch.bfloat16), zvals, zdists,
                                 *(r.detach() for r in rows), ops, *g, acts)
    blocks = [p[k] for p in ps for k in ff.WEIGHT_KEYS]
    dblocks = [getattr(d, f"d{k}")[i] for i in range(2) for k in ff.WEIGHT_KEYS]
    torch.autograd.backward([*rows, *blocks], [d.dcb0, d.dcb5, d.dcbr1, *dblocks])
    out = {f"{br}/{k}": f[k].grad for br, f in zip(BRANCHES, flats) for k in LEAVES}
    out.update(embed=d.dembed, sc=sc.grad, ac=ac.grad, zvals=d.dzvals, zdists=d.dzdists)
    return out


@pytest.mark.parametrize("leaf", [f"{b}/{k}" for b in BRANCHES for k in LEAVES] + list(INPUTS))
def test_dual_backward_matches_jax_kernel_interpret(jax_dual, port_backward, leaf):
    """The plain K4 against the Pallas dual backward on JAX's stash: the
    same formulas, rounding points and order of the branches' sums; only
    f32 summation order differs: each leaf within 2e-3 relative L2."""
    dface, deye, dembed, dsc, dac, dzvals, dzdists = jax_dual[2]
    want = {f"face/{k}": v for k, v in dface.items()}
    want.update({f"eyes/{k}": v for k, v in deye.items()})
    want.update(embed=dembed, sc=dsc, ac=dac, zvals=dzvals, zdists=dzdists)
    got = port_backward[leaf]
    assert got.dtype == torch.float32 and tuple(got.shape) == want[leaf].shape, leaf
    assert np.abs(want[leaf]).max() > 0, leaf
    assert _rel_l2(got.numpy(), want[leaf]) < GRAD_REL_L2, leaf


def _grads(params, inputs, fn):
    """Loss (sum of squares of every output) and its gradients through
    ``fn(ps, ops_list, embed, sc, ac, zvals, zdists)``."""
    flats = [_flat(p, requires_grad=True) for p in params]
    xs = [torch.from_numpy(np.array(x)).requires_grad_(True) for x in inputs]
    ps = [ff.split_params(f, DE) for f in flats]
    with torch.no_grad():
        ops = [ff.prepare_operands(p) for p in ps]
    outs = fn(ps, ops, *xs)
    loss = sum((t**2).sum() for o in outs for t in o)
    leaves = [f[k] for f in flats for k in LEAVES] + xs
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_fused_dual_matches_two_fused_fields(case, stash):
    """``FusedDual`` (both branches in one forward; the backward K4 on the
    stash, or K2 per branch) against two single-branch ``FusedField``
    calls, outputs and gradients, as the JAX package holds its dual kernel
    (tests/test_fused_field.py): atol = rtol = 2e-4."""
    params, inputs, _ = case

    def single(ps, ops, embed, sc, ac, zvals, zdists):
        return [ff.fused_field_render(p, o, embed, sc, ac, zvals, zdists) for p, o in zip(ps, ops)]

    def dual(ps, ops, embed, sc, ac, zvals, zdists):
        return ff2.fused_dual_render(ps, ff2.stack_operands(ops), embed, sc, ac, zvals, zdists,
                                     stash_acts=stash)

    ls, gs = _grads(params, inputs, single)
    ld, gd = _grads(params, inputs, dual)
    np.testing.assert_allclose(ld.item(), ls.item(), rtol=1e-5)
    for a, b in zip(gd, gs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4, rtol=2e-4)


def test_stash_is_written_only_under_a_gradient(case, monkeypatch):
    """As the JAX primal call skips it: no stash in a no-grad call or when
    no input requires a gradient; with ``stash_acts`` under a gradient the
    forward stashes, and the backward reads the stash (K4, no K2)."""
    params, inputs, _ = case
    calls = []
    forward = ff2.fused_dual_forward

    def spy(*args, stash=False):
        calls.append(stash)
        return forward(*args, stash=stash)

    monkeypatch.setattr(ff2, "fused_dual_forward", spy)
    backward = []
    monkeypatch.setattr(ffb2, "fused_dual_backward",
                        lambda *a: backward.append(1) or ffb2.fused_dual_backward_reference(*a))
    ps, ops = _operands([_flat(p) for p in params])
    xs = [torch.from_numpy(np.array(x)) for x in inputs]
    with torch.no_grad():
        ff2.fused_dual_render(ps, ops, *xs)
    ff2.fused_dual_render(ps, ops, *xs)  # nothing requires a gradient
    ff2.fused_dual_render(ps, ops, *xs, stash_acts=False)
    xs[0].requires_grad_(True)
    out = ff2.fused_dual_render(ps, ops, *xs)
    assert calls == [False, False, False, True]
    sum(t.sum() for o in out for t in o).backward()
    assert backward == [1] and xs[0].grad is not None


def test_wrappers_raise_on_other_devices(case):
    """A wrapper takes the plain version only for CPU tensors."""
    params, inputs, cot = case
    _, ops = _operands([_flat(p) for p in params])
    meta = torch.zeros(B, R, S, DE, dtype=torch.bfloat16, device="meta")
    z = torch.zeros(B, R, S, device="meta")
    with pytest.raises(ValueError, match="device"):
        ff2.fused_dual_forward(meta, z, z, None, None, None, ops)
    with pytest.raises(ValueError, match="device"):
        ffb2.fused_dual_backward(meta, z, z, None, None, None, ops, None, None, None)
