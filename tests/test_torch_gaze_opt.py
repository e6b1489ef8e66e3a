"""The port's gaze-code optimization (``train/fitting.make_optimize_gaze``)
against the JAX package's: Adam on the 2-vector gaze alone, no jitter,
early stopping, on one image (``tests/torch_fitting_case.py``), in float64
and in f32.  The gaze's gradient flows through the field backward (on the
card K2's conditioning gradient) and the eye planes' rotation; nothing may
accumulate in the model's ``.grad``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import gazenerf_tpu.models.gaze_nerf as jax_gaze_nerf
import gazenerf_tpu.train.fitting as jax_fitting
from gazenerf_tpu_torch.train.fitting import FitState, make_optimize_gaze
from torch_fitting_case import (
    EXPR_FIX,
    JnpFloat64,
    jax_model_and_frozen,
    jax_state_of,
    make_case,
    port_trainer,
    rel_l2,
    to64,
)
from torch_threads import one_thread  # noqa: F401

MAX_STEPS, PATIENCE = 6, 2
GAZE_INIT = np.array([0.1, -0.1], np.float32)
# float64: the best gaze and loss to 1e-6 relative (readings 2.7e-16 and
# 8.9e-16)
F64_RTOL = 1e-6
# f32 (``python tests/test_torch_gaze_opt.py``): JAX's own spread, op by op
# against jitted, is 1.0e-5 on the best gaze (relative L2) and 0 on the
# best loss; the port reads 1.3e-5 and 2.3e-7 (two f32 steps: the loss sums
# 64 x 64 x 3 pixels in another order).  The gaze is held to twice JAX's
# spread, the loss to twice the port's reading.
F32_GAZE_RTOL = 2e-5
F32_LOSS_RTOL = 4.6e-7


def jax_optimize(case, float64=False, disable_jit=False):
    jcfg, params, offsets, batch = case
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(float64):
        if float64:
            # the model's and the loop's float32 (its carry's best loss) are
            # float64 in this run
            mp.setattr(jax_gaze_nerf, "jnp", JnpFloat64())
            mp.setattr(jax_fitting, "jnp", JnpFloat64())
            params, offsets = to64(params), to64(offsets)
            batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                     for k, v in batch.items()}
        model, frozen = jax_model_and_frozen(jcfg)
        opt = jax_fitting.make_optimize_gaze(jcfg, model, frozen, EXPR_FIX, max_steps=MAX_STEPS,
                                patience=PATIENCE)
        with jax.disable_jit(disable_jit):
            gaze, loss, steps = opt(jax_state_of(params, offsets),
                                    {k: jnp.asarray(v) for k, v in batch.items()},
                                    jnp.asarray(GAZE_INIT, jnp.float64 if float64 else jnp.float32))
        return np.asarray(gaze), float(loss), int(steps)


def port_optimize(case, float64=False):
    jcfg, params, offsets, batch = case
    tr = port_trainer(jcfg, params, offsets, float64=float64)
    if float64:
        batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                 for k, v in batch.items()}
    opt = make_optimize_gaze(tr.cfg, tr.frozen, EXPR_FIX, max_steps=MAX_STEPS, patience=PATIENCE)
    gaze, loss, steps = opt(FitState.of(tr), batch, GAZE_INIT)
    assert all(p.grad is None for p in tr.model.parameters())
    assert all(p.grad is None for p in tr.offsets.values())
    return gaze.numpy(), float(loss), steps


@pytest.fixture(scope="module")
def case():
    return make_case()


@pytest.mark.parametrize("float64", [True, False], ids=["f64", "f32"])
def test_optimize_gaze_matches_jax(case, float64):
    want = jax_optimize(case, float64)
    got = port_optimize(case, float64)
    gaze_rtol, loss_rtol = (F64_RTOL, F64_RTOL) if float64 else (F32_GAZE_RTOL, F32_LOSS_RTOL)
    assert got[0].dtype == (np.float64 if float64 else np.float32)
    assert got[2] == want[2]
    assert rel_l2(got[0], want[0]) < gaze_rtol
    assert got[1] == pytest.approx(want[1], rel=loss_rtol)
    assert rel_l2(got[0], GAZE_INIT) > 1e-3  # the gaze moved


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    c = make_case()
    jitted = jax_optimize(c)
    for name, other in (("JAX f32, op by op", jax_optimize(c, disable_jit=True)),
                        ("port f32", port_optimize(c)),
                        ("port float64 vs JAX x64", None)):
        if other is None:
            a, b = port_optimize(c, True), jax_optimize(c, True)
        else:
            a, b = other, jitted
        print(name, "gaze", rel_l2(a[0], b[0]), "loss", abs(a[1] / b[1] - 1), "steps", a[2], b[2])
