"""The PyTorch port's dual-branch field path against the JAX package.

``GazeNeRF`` with ``pallas_dual_branch`` (with and without
``pallas_stash_acts``): both fields through one dual-branch kernel
(``kernels/fused_field2``; on the CPU its plain version) against the JAX
model with its Pallas dual kernels in interpret mode, on the same
``small_test_config`` weights: the render's images, and one training
step's gradients.  The model setups are the render's and the training
step's parity tests' own (``tests/test_torch_render.py``,
``tests/test_torch_train.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gazenerf_tpu_torch import GazeNeRF, ModelConfig
from gazenerf_tpu_torch.kernels import fused_field2 as ff2
from gazenerf_tpu_torch.kernels import fused_field2_bwd as ffb2
from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb
from test_torch_render import BF16, FEATMAPS, IMAGES, _np, _port, _run_both, jax_setup  # noqa: F401
from test_torch_train import (  # noqa: F401
    GROUPS,
    _group_rel_l2,
    _jax_rel_l2,
    _jax_steps,
    _port_step,
    _step_configs,
    setup,
)
from torch_threads import one_thread  # noqa: F401

DUAL = dict(use_pallas=True, pallas_dual_branch=True)
STASH = {"stash": True, "recompute": False}


@pytest.fixture(scope="module")
def dual_render(jax_setup):
    """JAX's bf16 render on the dual-branch path (its dual kernel in
    interpret mode; a no-grad call writes no stash) and the port's
    single-branch bf16 render, each run once."""
    jcfg, variables, inputs = jax_setup
    _, want = _run_both(jcfg.model, variables, inputs, **BF16, **DUAL, pallas_stash_acts=True)
    with torch.no_grad():
        single = _port(jcfg.model, variables, **BF16, use_pallas=True)
        single = single(*map(torch.from_numpy, inputs))
    return want, single


@pytest.mark.parametrize("stash", STASH.values(), ids=STASH.keys())
def test_dual_render_matches_jax(jax_setup, dual_render, stash):
    """The bf16 render on the dual-branch path against JAX's: the images at
    the bf16 ``phase_gm`` bounds of ``tests/test_torch_render.py`` (4e-3,
    ``bg_img`` 1e-3), the featmaps and weights at the bf16 slice bound
    (3e-2).  On the CPU the dual path's plain version is the single-branch
    one per branch: the same bits as the port's single-branch render."""
    jcfg, variables, inputs = jax_setup
    want, single = dual_render
    with torch.no_grad():
        model = _port(jcfg.model, variables, **BF16, **DUAL, pallas_stash_acts=stash)
        assert model.dual
        got = model(*map(torch.from_numpy, inputs))
    for k in IMAGES:
        err = np.abs(_np(got["coarse_dict"][k]) - _np(want["coarse_dict"][k])).max()
        assert err <= (1e-3 if k == "bg_img" else 4e-3), (k, err)
        torch.testing.assert_close(got["coarse_dict"][k], single["coarse_dict"][k], atol=0, rtol=0)
    for k in FEATMAPS:
        np.testing.assert_allclose(_np(got["featmaps"][k]), _np(want["featmaps"][k]),
                                   atol=3e-2, rtol=0, err_msg=k)
    np.testing.assert_allclose(_np(got["weights"]), _np(want["weights"]), atol=3e-2)


@pytest.fixture(scope="module")
def dual_step(setup):
    """One training step with bf16 fields and renderer on the dual-branch
    path: JAX with the stash (its dual forward and backward kernels in
    interpret mode), the port with and without the stash (the plain K3 and
    K4, or K3 and the plain K2 per branch); JAX's f32 step is the common
    truth."""
    jcfg, params, offsets, vgg, vgg_vars, batch = setup
    f32, bf16 = _step_configs(jcfg)
    dual = bf16.replace(model=dataclasses.replace(bf16.model, **DUAL, pallas_stash_acts=True))
    (_, truth), (_, want) = _jax_steps(setup, f32, dual)
    got = {}
    for name, stash in STASH.items():
        cfg = dual.replace(model=dataclasses.replace(dual.model, pallas_stash_acts=stash))
        got[name] = _port_step(cfg, params, offsets, vgg_vars, batch)[1]
    return got, want, truth, dual.model.n_upsample_blocks


@pytest.mark.parametrize("stash", STASH, ids=STASH.keys())
@pytest.mark.parametrize("group", GROUPS)
def test_dual_step_gradients_match_jax_interpret(dual_step, group, stash):
    """The bf16 step's bound of ``tests/test_torch_train.py`` per parameter
    group: with d = the JAX dual-branch step's relative L2 from the f32
    gradient, the port's lies within 2d of the f32 gradient and within 2d
    of JAX's.  With or without the stash the port computes the same
    function (K4 on the stash, or K2 per branch), and so does JAX."""
    got, want, truth, n_blocks = dual_step
    d = _jax_rel_l2(want, truth, group, n_blocks)
    assert 0 < d < 0.5
    assert _group_rel_l2(got[stash], truth, group, n_blocks) < 2 * d
    assert _group_rel_l2(got[stash], want, group, n_blocks) < 2 * d


def test_stash_and_recompute_steps_agree(dual_step):
    """The port's two dual backward routes, the plain K4 on the stash and
    the plain K2 per branch on recomputed activations, read the same
    activations: the step's gradients agree to f32 summation noise."""
    got, _, _, _ = dual_step
    for name, g in got["stash"]["net"].items():
        torch.testing.assert_close(g, got["recompute"]["net"][name], atol=1e-6, rtol=1e-5,
                                   msg=name)


def test_dual_step_takes_the_dual_kernels(setup, monkeypatch):
    """A training step with the stash goes through the dual forward (with
    the stash) and the dual backward once each and never through the
    single-branch backward; without the stash through the dual forward
    once and the single-branch backward once per branch."""
    jcfg, params, offsets, vgg, vgg_vars, batch = setup
    _, bf16 = _step_configs(jcfg)
    calls = []
    for mod, name in ((ff2, "fused_dual_forward"), (ffb2, "fused_dual_backward"),
                      (ffb, "fused_field_backward")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append((_n, k.get("stash"))), _f(*a, **k))[1])
    for stash, want in ((True, [("fused_dual_forward", True), ("fused_dual_backward", None)]),
                        (False, [("fused_dual_forward", False)]
                         + [("fused_field_backward", None)] * 2)):
        calls.clear()
        cfg = bf16.replace(model=dataclasses.replace(bf16.model, **DUAL, pallas_stash_acts=stash))
        _port_step(cfg, params, offsets, vgg_vars, batch)
        assert calls == want, (stash, calls)


def test_stash_without_dual_branch_raises():
    """The single-branch bf16 stash (K1's stash write, K2's stash-read mode)
    is ported and runs without the dual branch; its variants that are not
    (a stash of every k-th layer, the int8 stash) raise, naming the ROADMAP
    item."""
    cfg = ModelConfig(compute_dtype="bfloat16", use_pallas=True, pallas_stash_acts=True)
    model = GazeNeRF(cfg, device="cpu")
    assert model.fused and not model.dual
    for option in (dict(pallas_stash_every=2), dict(pallas_stash_dtype="int8")):
        with pytest.raises(NotImplementedError, match=f"{next(iter(option))}.*ROADMAP"):
            GazeNeRF(dataclasses.replace(cfg, **option), device="cpu")
    assert GazeNeRF(dataclasses.replace(cfg, pallas_dual_branch=True), device="cpu").dual


@pytest.mark.parametrize("option", [
    dict(pallas_stash_every=2),
    dict(pallas_stash_dtype="int8"),
    dict(pallas_embed_bf16=True, pallas_split_dw=True),
    dict(pallas_fuse_embed=True),
    dict(pallas_embed_bf16=True),
])
def test_probe_flags_raise_with_the_dual_branch(option):
    """The dual path accepts the stash (and ``pallas_dens_vpu`` and
    ``pallas_split_dw``, which it clears) and the ray chunks, not the
    kernels' other probe flags: each raises, naming itself and its ROADMAP
    item (``split_dw`` sets the stash flags but not ``pallas_embed_bf16``,
    as in JAX)."""
    cfg = ModelConfig(compute_dtype="bfloat16", use_pallas=True, pallas_dual_branch=True,
                      pallas_stash_acts=True, **option)
    with pytest.raises(NotImplementedError, match=f"{next(iter(option))}.*ROADMAP"):
        GazeNeRF(cfg, device="cpu")


def test_dual_branch_is_ignored_without_the_fused_path(jax_setup, monkeypatch):
    """As JAX's ``_fused_dims`` returning None makes it: with f32 fields the
    dual-branch flags are accepted and the fields run their module path, the
    same bits as without the flags."""
    jcfg, variables, inputs = jax_setup
    monkeypatch.setattr(ff2, "fused_dual_forward", None)  # a call would fail
    x = [torch.from_numpy(a) for a in inputs]
    with torch.no_grad():
        model = _port(jcfg.model, variables, **DUAL, pallas_stash_acts=True)
        assert not model.dual
        got, plain = model(*x), _port(jcfg.model, variables)(*x)
    for k in IMAGES:
        torch.testing.assert_close(got["coarse_dict"][k], plain["coarse_dict"][k], atol=0, rtol=0)
