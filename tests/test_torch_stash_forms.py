"""The activation stash's other forms in the port's fused field kernels
against the JAX package: every k-th trunk layer (``stash_every=k``) and the
int8 stash (``stash_dtype="int8"``).

The plain versions that the wrappers run for CPU tensors: K1 writing each
form (``fused_field_forward(..., stash=StashForm(...))``) against the JAX
Pallas forward ``_pallas_forward`` in interpret mode, slot by slot, the int8
codes and their scales included; K2 reading it (``fused_field_backward(...,
stash_form=)``) against the Pallas backward ``pallas_backward`` on JAX's own
stash, per gradient leaf, with ``dens_vpu`` on and off; the layouts against
JAX's; and a ``GazeNeRF`` training step with the int8 stash against the JAX
model's on the same transplanted weights.  Each JAX kernel runs once per
form (module fixtures).  The CUDA kernels are held against these plain
versions on the card by ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gazenerf_tpu.kernels.fused_field import (
    FieldDims,
    _pallas_forward,
    stash_layout as jax_stash_layout,
    stash_quant_tags as jax_stash_quant_tags,
)
from gazenerf_tpu.kernels.fused_field_bwd import pallas_backward
from gazenerf_tpu_torch import GazeNeRF, ModelConfig, small_test_config
from gazenerf_tpu_torch.kernels import checks
from gazenerf_tpu_torch.kernels import fused_field as ff
from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb
from gazenerf_tpu_torch.ops.rays import pixel_grid
from gazenerf_tpu_torch.viewer.server import lookat_camera
from test_torch_stash_modes import (  # noqa: F401
    B, C, DE, DENS, GRAD_REL_L2, H, INPUTS, LEAVES, R, S, STASH_FLAGS, _flat, _flat_group,
    _rel_l2, case,
)
from test_torch_embed_modes_step import setup, truth  # noqa: F401
from test_torch_train import GROUPS, _jax_steps, _port_step, _step_configs
from torch_threads import one_thread  # noqa: F401

FORMS = {"every2": ff.StashForm(2), "every4": ff.StashForm(4), "int8": ff.StashForm(1, "int8")}
# the slots of each form, as (form, index in its stash) for the parametrized tests
SLOTS = [(name, i) for name, f in FORMS.items()
         for i in range(len(ff.stash_shapes(B, R, S, H, f)))]


def _dims(form: ff.StashForm, dens_vpu: bool = False) -> FieldDims:
    return FieldDims(embed=DE, hidden=H, feat=C, samples=S, tile_rays=8, interpret=True,
                     stash_acts=True, dens_vpu=dens_vpu, stash_every=form.every,
                     stash_dtype=form.dtype)


@pytest.fixture(scope="module")
def jax_kernels(case):
    """Per form, JAX's forward writing it and its backward reading it, with
    and without ``dens_vpu``, in interpret mode."""
    params, inputs, cot = case
    x = tuple(map(jnp.asarray, inputs))
    g = tuple(map(jnp.asarray, cot))
    out = {}
    for name, form in FORMS.items():
        fwd, stash = _pallas_forward(params, *x, _dims(form))
        grads = {}
        for dens, dens_vpu in DENS.items():
            dparams, *dins = pallas_backward(params, *x, _dims(form, dens_vpu), g, stash)
            grads[dens] = {k: np.asarray(v) for k, v in dparams.items()}
            grads[dens].update(zip(INPUTS, map(np.asarray, dins)))
        out[name] = ([np.asarray(t) for t in fwd], [_np(t) for t in stash], grads)
    return out


def _np(t):
    """A JAX stash tensor as numpy: bf16 values in f32, int8 codes, f32 scales."""
    return np.asarray(t.astype(jnp.float32) if t.dtype == jnp.bfloat16 else t)


def _args(case):
    params, inputs, _ = case
    p = ff.split_params(_flat(params), DE)
    embed, sc, ac, zvals, zdists = map(torch.from_numpy, inputs)
    cb0, cb5, cbr1 = ff.conditioning_rows(p, sc, ac)
    return embed.to(torch.bfloat16), zvals, zdists, cb0, cb5, cbr1, ff.prepare_operands(p)


@pytest.fixture(scope="module")
def port_forward(case):
    """The port's plain K1 writing each form on the same inputs."""
    with torch.no_grad():
        args = _args(case)
        return {name: ff.fused_field_forward(*args, stash=f) for name, f in FORMS.items()}


@pytest.mark.parametrize("every", range(1, 11))
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_layouts_are_jax_layouts(every, dtype):
    """The layout, the quantized tags and the refusal of the int8 stash at
    ``stash_every`` > 1 are JAX's (``stash_layout``, ``stash_quant_tags``):
    every layer at k = 1, the trunk layers i with i % k == k - 1 above, none
    from k = 9 on."""
    form = ff.StashForm(every, dtype)
    dims = _dims(form)
    assert ff.stash_layout(H, form) == jax_stash_layout(dims)
    if dtype == "int8" and every != 1:
        with pytest.raises(AssertionError):
            jax_stash_quant_tags(dims)
        with pytest.raises(ValueError, match="stash_every=1"):
            ff.stash_quant_tags(form)
    else:
        assert ff.stash_quant_tags(form) == jax_stash_quant_tags(dims)


@pytest.mark.parametrize("name, slot", SLOTS, ids=[f"{n}-{i}" for n, i in SLOTS])
def test_form_stash_matches_jax_kernel_interpret(jax_kernels, port_forward, name, slot):
    """The plain K1's stash in each form against the Pallas kernel's, slot by
    slot, in its layout and dtypes.  A bf16 slot at K1's bound, 5e-3
    absolute (a flipped rounding moves a value by a bf16 step).  The int8
    codes and their f32 scales equal JAX's to the bit: in this case the two
    forwards' bf16 values agree, and the quantizers compute alike."""
    out, got = port_forward[name]
    want = jax_kernels[name][1][slot]
    shape, dtype = ff.stash_shapes(B, R, S, H, FORMS[name])[slot]
    assert got[slot].dtype == dtype and tuple(got[slot].shape) == shape == want.shape
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(got[slot].float().numpy(), want, atol=5e-3, rtol=0)
    else:
        np.testing.assert_array_equal(got[slot].numpy(), want)


def test_quantizer_is_jax_quantizer(jax_kernels):
    """On JAX's own bf16 values of x1, x3 and x5 (its stash of every second
    layer) the port's quantizer (``quantize_rows``) gives the Pallas
    kernel's int8 codes and scales of those layers to the bit: the same f32
    products, reciprocal and half-to-even rounding."""
    q = ff.stash_quant_tags(FORMS["int8"])
    codes, scales = jax_kernels["int8"][1][:-1], jax_kernels["int8"][1][-1]
    bf16 = dict(zip((t for t, _ in ff.stash_layout(H, FORMS["every2"])), jax_kernels["every2"][1]))
    for tag in ("x1", "x3", "x5"):
        got_q, got_s = ff.quantize_rows(torch.tensor(bf16[tag]))  # a copy: numpy's is read-only
        np.testing.assert_array_equal(got_q.numpy(), codes[ff.STASH_TAGS.index(tag)], err_msg=tag)
        np.testing.assert_array_equal(got_s.numpy(), scales[..., q.index(tag)], err_msg=tag)


@pytest.mark.parametrize("name", FORMS)
def test_form_outputs_are_the_stash_free_outputs(case, port_forward, name):
    """The form changes what is stashed, never K1's outputs."""
    with torch.no_grad():
        want = ff.fused_field_forward(*_args(case))
    assert all(torch.equal(a, b) for a, b in zip(port_forward[name][0], want))


@pytest.fixture(scope="module")
def port_backward(case, jax_kernels):
    """Per form and ``dens_vpu``: the port's gradient through ``FusedField``
    writing and reading the form (the plain K1 and K2), and the plain K2 on
    JAX's own stash of the form."""
    params, inputs, cot = case
    out = {}
    for name, form in FORMS.items():
        for dens, dens_vpu in DENS.items():
            flat = _flat(params, True)
            xs = [torch.from_numpy(np.array(x)).requires_grad_(True) for x in inputs]
            p = ff.split_params(flat, DE)
            with torch.no_grad():
                ops = ff.prepare_operands(p)
            res = ff.fused_field_render(p, ops, *xs, stash_acts=True, dens_vpu=dens_vpu,
                                        stash_form=form)
            loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(res, cot))
            keys = list(flat)
            g = torch.autograd.grad(loss, [flat[k] for k in keys] + xs)
            with torch.no_grad():
                stash = [torch.tensor(t).to(dtype) for t, (_, dtype) in
                         zip(jax_kernels[name][1], ff.stash_shapes(B, R, S, H, form))]
                on_jax = ffb.fused_field_backward(*_args(case), *map(torch.from_numpy, cot),
                                                  stash=stash, dens_vpu=dens_vpu,
                                                  stash_form=form)
            out[name, dens] = dict(zip(keys + list(INPUTS), g)), on_jax
    return out


@pytest.mark.parametrize("dens", DENS, ids=DENS.keys())
@pytest.mark.parametrize("name", FORMS)
@pytest.mark.parametrize("leaf", LEAVES + list(INPUTS))
def test_form_backward_matches_jax_kernel_interpret(jax_kernels, port_backward, leaf, name,
                                                    dens):
    """The port's gradient writing and reading each form against the Pallas
    backward on its own stash of the form, each leaf within the stash
    modes' 2e-3 relative L2."""
    want = jax_kernels[name][2][dens][leaf]
    got = port_backward[name, dens][0][leaf]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, leaf
    assert np.abs(want).max() > 0, leaf
    assert _rel_l2(got.numpy(), want) < GRAD_REL_L2, leaf


# K2's weight and bias gradients and the JAX leaves they are (the rows of a
# leaf that act on the embedding or the hidden state; the conditioning rows
# are folded from dcb* by autograd in the port, by JAX's epilogue there)
_BLOCKS = {"dW0e": ("fea_0/kernel", slice(0, DE)), "dW5e": ("fea_5/kernel", slice(0, DE)),
           "dW5x": ("fea_5/kernel", slice(-H, None)), "dWd": ("density/kernel", slice(None)),
           "dWr0": ("rgb_0/kernel", slice(None)), "dWr1x": ("rgb_1/kernel", slice(0, H)),
           "dWr2": ("rgb_2/kernel", slice(None)), "dbd": ("density/bias", slice(None)),
           "dbr0": ("rgb_0/bias", slice(None)), "dbr2": ("rgb_2/bias", slice(None))}
_BLOCKS.update({f"dWmid{m}": (f"fea_{i}/kernel", slice(None))
                for m, i in enumerate((1, 2, 3, 4, 6, 7))})


@pytest.mark.parametrize("dens", DENS, ids=DENS.keys())
@pytest.mark.parametrize("name", FORMS)
def test_form_reads_jax_stash_as_jax(jax_kernels, port_backward, name, dens):
    """The plain K2 on JAX's own stash of each form (its int8 codes and
    scales as they are) agrees with the Pallas backward on it to f32
    summation noise: every weight and bias gradient within 1e-4 relative
    L2."""
    on_jax = port_backward[name, dens][1]
    want = jax_kernels[name][2][dens]
    for field, (leaf, rows) in _BLOCKS.items():
        got = on_jax.dWmid[int(field[-1])] if field.startswith("dWmid") else getattr(on_jax, field)
        assert _rel_l2(got.numpy(), want[leaf][rows]) < 1e-4, field


@pytest.mark.parametrize("dens_vpu", [False, True], ids=["rounded", "dens_vpu"])
@pytest.mark.parametrize("name", ["every2", "every4"])
def test_partial_forms_equal_the_full_stash_on_the_cpu(case, name, dens_vpu):
    """K2 reading every second or fourth trunk layer rebuilds the others with
    the recompute's formulas: the full stash's gradients to the bit."""
    params, inputs, cot = case
    with torch.no_grad():
        args = _args(case)
        cots = tuple(map(torch.from_numpy, cot))
        _, full = ff.fused_field_forward(*args, stash=True)
        _, acts = ff.fused_field_forward(*args, stash=FORMS[name])
        want = ffb.fused_field_backward(*args, *cots, stash=full, dens_vpu=dens_vpu)
        got = ffb.fused_field_backward(*args, *cots, stash=acts, dens_vpu=dens_vpu,
                                       stash_form=FORMS[name])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", FORMS)
def test_forms_given_the_points_on_the_cpu(name):
    """The plain K1 and K2 given the sample points (``embed_in_kernel``,
    the model's 10 octaves) in each form, as ``chip_smoke.py`` holds the
    kernels (``checks.points_form_failures``): K1 writes the stash of K1
    given the encoding, to the bit; K2 gives K2's given the encoding in
    every output but the points' cotangent, and a partial stash the full
    stash's gradients, the points' cotangent included, to the bit."""
    args, cot = checks.points_case(*checks.K2_CASES["narrow"], "cpu")
    line, fails = checks.points_form_failures("narrow", args, cot, FORMS[name])
    assert not fails, fails
    for dens_vpu in (False, True):
        r = line[f"k2_dens_vpu_{dens_vpu}"]
        assert r["differ_from_card_encoding"] == [] and r["max_abs_err"] == 0.0
        assert r.get("differ_from_full_stash", []) == []


@pytest.mark.parametrize("every", [9, 16])
def test_a_form_that_keeps_no_layer_recomputes(case, every, monkeypatch):
    """From k = 9 on the layout is empty: as JAX's custom VJP with an empty
    stash, the forward writes none and the backward recomputes (the
    recompute's gradients to the bit, K2 called without a stash)."""
    params, inputs, cot = case
    calls = []
    bwd = ffb.fused_field_backward
    monkeypatch.setattr(ffb, "fused_field_backward", lambda *a, stash=None, **k: (
        calls.append(stash), bwd(*a, stash=stash, **k))[1])
    grads = []
    for stash_acts in (True, False):
        flat = _flat(params, True)
        xs = [torch.from_numpy(np.array(x)).requires_grad_(True) for x in inputs]
        p = ff.split_params(flat, DE)
        with torch.no_grad():
            ops = ff.prepare_operands(p)
        res = ff.fused_field_render(p, ops, *xs, stash_acts=stash_acts,
                                    stash_form=ff.StashForm(every))
        loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(res, cot))
        grads.append(torch.autograd.grad(loss, list(flat.values()) + xs))
    assert calls == [None, None]
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    with torch.no_grad():
        _, acts = ff.fused_field_forward(*_args(case), stash=ff.StashForm(every))
    assert acts == ()


def test_int8_needs_every_layer():
    """The int8 stash of every k-th layer raises ``ValueError`` at
    construction on the single-branch fused path with the stash, where JAX
    asserts; the dual path and the path without the stash ignore it, as
    JAX's do, and ``split_dw`` sets the bf16 stash of every layer.  Without
    the stash the small model renders, and its gradient comes back, to the
    bit as with the default form (JAX's ``stash_quant_tags`` is empty
    there)."""
    cfg = ModelConfig(compute_dtype="bfloat16", use_pallas=True, pallas_stash_acts=True,
                      pallas_stash_dtype="int8", pallas_stash_every=2, featmap_size=8,
                      mlp_hidden=64)
    with pytest.raises(ValueError, match="stash_every=1"):
        GazeNeRF(cfg, device="cpu")
    for ok in (dict(pallas_dual_branch=True), dict(pallas_stash_acts=False),
               dict(pallas_split_dw=True), dict(pallas_stash_every=1)):
        GazeNeRF(dataclasses.replace(cfg, **ok), device="cpu")
    small = dataclasses.replace(small_test_config(), compute_dtype="bfloat16", use_pallas=True,
                                pallas_stash_acts=False)
    R, T, K = (torch.from_numpy(a) for a in lookat_camera(10, -5, 12.0, small.featmap_size))
    args = (pixel_grid(small.featmap_size)[None], 0.1 * torch.ones(1, small.shape_code_dims),
            0.1 * torch.ones(1, small.appea_code_dims), torch.tensor([[0.2, -0.3]]), R, T, K)
    runs = []
    for form in ({}, dict(pallas_stash_dtype="int8", pallas_stash_every=2)):
        model = GazeNeRF(dataclasses.replace(small, **form), device="cpu")
        img = model(*args)["coarse_dict"]["merge_img"]
        img.sum().backward()
        runs.append([img.detach()] + [p.grad for p in model.parameters() if p.grad is not None])
    assert len(runs[0]) == len(runs[1]) > 1
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("path", ["coarse", "ray_chunk", "hier_sampling", "fuse_embed"])
def test_forms_on_the_model_paths(path, monkeypatch):
    """The small model renders with every form wherever the single-branch
    stash runs (the coarse pass; checkpointed ray chunks; the hierarchical
    sampler, whose fine pass recomputes; the points encoded in the
    kernels), each K2 call of the coarse fields reading the form, and its
    gradient is the bf16 stash of every layer's: to the bit with every 2nd
    or 4th layer, within JAX's int8 bound (0.03 relative L2 over all
    gradients, ``tests/test_fused_field.py``) with int8."""
    read = []
    bwd = ffb.fused_field_backward
    monkeypatch.setattr(ffb, "fused_field_backward", lambda *a, stash=None, **k: (
        read.append(k.get("stash_form", ff.StashForm()) if stash is not None else None),
        bwd(*a, stash=stash, **k))[1])
    small = dataclasses.replace(
        small_test_config(), compute_dtype="bfloat16", use_pallas=True, pallas_stash_acts=True,
        **{"coarse": {}, "ray_chunk": dict(ray_chunk=16), "hier_sampling": dict(hier_sampling=True, num_sample_fine=8),
           "fuse_embed": dict(pallas_fuse_embed=True)}[path])
    R, T, K = (torch.from_numpy(a) for a in lookat_camera(10, -5, 12.0, small.featmap_size))
    args = (pixel_grid(small.featmap_size)[None], 0.1 * torch.ones(1, small.shape_code_dims),
            0.1 * torch.ones(1, small.appea_code_dims), torch.tensor([[0.2, -0.3]]), R, T, K)
    runs = {}
    for name, form in {"full": ff.StashForm(), **FORMS}.items():
        read.clear()
        model = GazeNeRF(dataclasses.replace(small, pallas_stash_every=form.every,
                                             pallas_stash_dtype=form.dtype), device="cpu")
        out = model(*args)
        img = torch.stack([out[k]["merge_img"] for k in ("coarse_dict", "fine_dict") if k in out])
        img.sum().backward()
        runs[name] = [img.detach()] + [q.grad for q in model.parameters() if q.grad is not None]
        fine = 1 if path == "hier_sampling" else 0  # the fine field recomputes
        assert read.count(None) == fine and read.count(form) == len(read) - fine, read
        assert len(read) - fine == 2 * (small.num_rays // 16 if path == "ray_chunk" else 1)
    full = runs.pop("full")
    for name, got in runs.items():
        assert len(got) == len(full) > 1
        assert torch.equal(got[0], full[0]), name  # a forward's outputs are the form's own
        if name == "int8":
            g, w = (torch.cat([t.reshape(-1) for t in r[1:]]) for r in (got, full))
            assert bool(torch.isfinite(g).all())
            assert float((g - w).norm() / w.norm()) < 0.03
        else:
            assert all(torch.equal(a, b) for a, b in zip(got, full)), name


@pytest.fixture(scope="module")
def int8_step(setup, truth):
    """One training step with bf16 fields and renderer, the int8 stash and
    ``dens_vpu``: JAX with its Pallas kernels in interpret mode and the port
    (on the CPU the plain K1 and K2); the common truth is the port's f32
    step, as in ``tests/test_torch_stash_modes.py``.  The state is
    ``tests/test_torch_embed_modes_step.py``'s, without the VGG weights
    (the steps take no VGG loss)."""
    jcfg, params, offsets, vgg, vgg_vars, batch = setup
    _, bf16 = _step_configs(jcfg)
    int8 = bf16.replace(model=dataclasses.replace(bf16.model, **STASH_FLAGS,
                                                  pallas_stash_dtype="int8"))
    ((_, want),) = _jax_steps(setup, int8)
    got = _port_step(int8, params, offsets, vgg_vars, batch)[1]
    return got, want, truth, int8.model.n_upsample_blocks


@pytest.mark.parametrize("group", GROUPS)
def test_int8_step_gradients_match_jax_interpret(int8_step, group):
    """The bf16 step's bound of ``tests/test_torch_train.py`` per parameter
    group: with d = the JAX int8 step's relative L2 from the f32 gradient,
    the port's lies within 2d of the f32 gradient and within 2d of JAX's."""
    got, want, truth, n_blocks = int8_step
    got, want, truth = (_flat_group(t, group, n_blocks) for t in (got, want, truth))
    d = _rel_l2(want, truth)
    assert 0 < d < 0.5
    assert _rel_l2(got, truth) < 2 * d
    assert _rel_l2(got, want) < 2 * d
