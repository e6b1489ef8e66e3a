"""The port's single-image fit and prediction (``train/fitting.py``)
against the JAX package's, in float64, and the base state after a fit.

Three fitting steps of the network and the offsets on one image
(``tests/torch_fitting_case.py``): JAX in x64 mode with its own jitter
(the keys its sampler is handed, recorded as the jitted fit runs), the
port in float64 on those keys' draws.  Where f32 reassociation is gone the
two fits are one but for JAX's learning rate, which its schedule computes
in float32 even in x64 mode (1e-3 rounds up by 4.7e-8 relative): each
group's update (fitted minus base) within 1e-6 relative L2 (readings 2.4e-8
to 1.0e-7), the losses within 1e-7 relative (readings up to 1.05e-8).  The f32 fit is
``tests/test_torch_fitting_f32.py``'s, the gaze optimization
``tests/test_torch_gaze_opt.py``'s.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gazenerf_tpu.models.gaze_nerf as jax_gaze_nerf
from gazenerf_tpu.train.fitting import make_fit_single_image as jax_make_fit
from gazenerf_tpu.train.fitting import make_predict_single_image as jax_make_predict
from gazenerf_tpu_torch.train.fitting import (
    FitState,
    make_fit_single_image,
    make_predict_single_image,
)
from torch_fitting_case import (
    EXPR_FIX,
    GROUPS,
    JnpFloat64,
    draws_of,
    jax_groups,
    jax_model_and_frozen,
    jax_state_of,
    make_case,
    port_groups,
    port_trainer,
    record_sampler_keys,
    to64,
    update_rel_l2,
)
from torch_threads import one_thread  # noqa: F401

N_STEPS = 3
F64_UPDATE_REL_L2 = 1e-6
F64_LOSS_RTOL = 1e-7
# the f32 render against JAX's (tests/test_torch_render.py's bound)
PREDICT_ATOL = 2e-4


@pytest.fixture(scope="module")
def case():
    return make_case()


@pytest.fixture(scope="module")
def f64_fits(case):
    """The JAX fit in x64 mode and the port's float64 fit on its draws."""
    jcfg, params, offsets, batch = case
    batch64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}
    keys = []
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        record_sampler_keys(mp, keys)
        mp.setattr(jax_gaze_nerf, "jnp", JnpFloat64())
        model, frozen = jax_model_and_frozen(jcfg)
        base = jax_state_of(to64(params), to64(offsets))
        fitted, losses = jax_make_fit(jcfg, model, frozen, EXPR_FIX, N_STEPS)(
            base, {k: jnp.asarray(v) for k, v in batch64.items()})
        jax.effects_barrier()
        want = (jax_groups(base, jcfg.model.n_upsample_blocks),
                jax_groups(fitted, jcfg.model.n_upsample_blocks), np.asarray(losses))
        assert len(keys) == N_STEPS
        t_rand = draws_of(keys, jcfg.model, jnp.float64)
    tr = port_trainer(jcfg, params, offsets, float64=True)
    state = FitState.of(tr)
    fit = make_fit_single_image(tr.cfg, tr.frozen, EXPR_FIX, N_STEPS)
    fitted_port, losses_port = fit(state, batch64, t_rand=t_rand)
    got = (port_groups(state), port_groups(fitted_port), losses_port.numpy())
    return got, want


@pytest.mark.parametrize("group", GROUPS)
def test_f64_fit_matches_jax(f64_fits, group):
    """Each group's update over three Adam steps (Adam moves a parameter by
    about the learning rate times its gradient's sign, so a gradient at
    rounding level could flip it: in float64 none does)."""
    (got_before, got_after, _), (want_before, want_after, _) = f64_fits
    assert update_rel_l2(got_after, got_before, want_after, want_before, group) < F64_UPDATE_REL_L2


def test_f64_fit_losses_match_jax(f64_fits):
    (_, _, got), (_, _, want) = f64_fits
    assert got.dtype == np.float64 and got.shape == (N_STEPS,)
    np.testing.assert_allclose(got, want, rtol=F64_LOSS_RTOL)
    assert got[-1] < got[0]


def test_f64_fit_moves_only_row_0(f64_fits):
    """The fit pins the sample index to 0: the offsets' other rows keep
    their values (the image's own index is 1)."""
    (before, after, _), _ = f64_fits
    for k in GROUPS[1:]:
        np.testing.assert_array_equal(after[k][1:], before[k][1:])
        assert np.abs(after[k][0] - before[k][0]).max() > 0


def test_fit_leaves_the_base_state_unchanged(case):
    """A fit trains copies: the base model's parameters and buffers and the
    offset tables keep their bits, and a second fit of the same base draws
    the same jitter and returns the same state."""
    jcfg, params, offsets, batch = case
    tr = port_trainer(jcfg, params, offsets)
    base = FitState.of(tr)
    model_before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    offsets_before = {k: v.detach().clone() for k, v in tr.offsets.items()}
    fit = make_fit_single_image(tr.cfg, tr.frozen, EXPR_FIX, 2)
    a, losses_a = fit(base, batch)
    b, losses_b = fit(base, batch)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, model_before[k]), k
    for k, v in tr.offsets.items():
        assert torch.equal(v.detach(), offsets_before[k]), k
        assert v.grad is None
    assert torch.equal(losses_a, losses_b)
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    assert not torch.equal(a.offsets["iden"], offsets_before["iden"])


def test_predict_with_override_matches_jax(case):
    """The no-gradient render with the composed codes, the stored gaze and
    an override, f32 on both sides."""
    jcfg, params, offsets, batch = case
    model, _ = jax_model_and_frozen(jcfg)
    predict = jax_make_predict(jcfg, model, EXPR_FIX)
    base = jax_state_of(params, offsets)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tr = port_trainer(jcfg, params, offsets)
    port_predict = make_predict_single_image(tr.cfg, EXPR_FIX)
    state = FitState.of(tr)
    override = np.array([0.3, -0.2], np.float32)
    for gaze in (None, override):
        # JAX side: the stored gaze as the override, one trace for both
        jax_gaze = batch["pitchyaw"][0] if gaze is None else gaze
        want = np.asarray(predict(base, jb, jnp.asarray(jax_gaze)))
        got = port_predict(state, batch, gaze)
        assert got.shape == want.shape == (1, 64, 64, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=PREDICT_ATOL, rtol=0)
    moved = port_predict(state, batch, override) - port_predict(state, batch)
    assert float(moved.abs().max()) > 1e-3  # the override redirects the gaze
