"""The port's multi-process training against its one-process step and the
JAX package's single-device step, on the CPU over gloo.

The JAX test's tiny config (``tests/test_sharding.py``: featmap 16, 8
samples, hidden 32, MSE region losses, no VGG), B = 2 with the two rows'
masks over different areas, so that a masked mean that divided by its own
rows' mask sum would show.  Workers (``tests/torch_parallel_worker.py``)
import only the port and take one torch thread; this process runs the JAX
side on a thread (:class:`JaxSteps`) while they and the tests before the
steps run.

The step is compared in float64 on every side (JAX in x64 mode, its
parameters and Adam in f32): Adam's first update is ``lr * sign(g)``
wherever ``|g|`` is far above its epsilon, and in f32 the two frameworks'
gradients (2e-3 apart, relative L2: ``tests/test_torch_train.py``) take
other signs on near-zero elements (141 of the 1,005,663 network parameters
and the camera-translation offsets after one step of this config), which
then sit ``2 lr`` apart.  In float64 the gradients agree to about 1e-12
and the tolerances are JAX's own (``tests/test_sharding.py``).
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gazenerf_tpu.models.gaze_nerf as jax_gaze_nerf
from gazenerf_tpu.config import Config as JaxConfig
from gazenerf_tpu.config import LossConfig as JaxLossConfig
from gazenerf_tpu.config import ModelConfig as JaxModelConfig
from gazenerf_tpu.config import TrainConfig as JaxTrainConfig
from gazenerf_tpu.ops.rays import sample_coarse as jax_sample_coarse
from gazenerf_tpu.train.trainer import Trainer as JaxTrainer
from gazenerf_tpu_torch import Config, GazeNeRF, ModelConfig
from gazenerf_tpu_torch.data.cameras import base_inv_inmat
from gazenerf_tpu_torch.ops.rays import pixel_grid
from gazenerf_tpu_torch.parallel import mesh as mesh_mod
from gazenerf_tpu_torch.parallel.dryrun import dryrun, free_port
from gazenerf_tpu_torch.train.state import make_offsets
from gazenerf_tpu_torch.train.trainer import compose_codes_and_cams
from gazenerf_tpu_torch.utils.transplant import params_from_jax, patchgan_params_from_jax
from test_torch_train import _JnpFloat64
from torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_parallel_worker.py"
B, SIZE, FEAT, TRAIN_LEN = 2, 64, 16, 4
JITTER_KEY = jax.random.PRNGKey(11)
TIMEOUT_S = 240  # each worker; past it the test fails


def tiny_jax_config(gan: bool) -> JaxConfig:
    loss = dict(use_vgg_loss=False, use_l1_loss=False)
    if gan:
        loss.update(use_patch_gan_loss=True, gan_warmup_steps=10)
    return JaxConfig(
        model=JaxModelConfig(num_sample_coarse=8, featmap_size=FEAT, pred_img_size=SIZE,
                             mlp_hidden=32, use_pallas=False),
        loss=JaxLossConfig(**loss),
        train=JaxTrainConfig(batch_size=B, lr=1e-3),
    )


def _ellipse(cy, cx, ry, rx):
    yy, xx = np.mgrid[:SIZE, :SIZE] / SIZE
    return (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1).astype(np.float32)


def make_batch(seed):
    """Two rows whose head and eye masks differ in area (the first head
    about twice the second's)."""
    rng = np.random.default_rng(seed)
    inmat = np.linalg.inv(base_inv_inmat(FEAT)).astype(np.float32)
    inmat[:2] *= SIZE / FEAT

    def rep(a):
        return np.repeat(np.asarray(a, np.float32)[None], B, 0)

    return {
        "image": rng.random((B, SIZE, SIZE, 3), dtype=np.float32),
        "head_mask": np.stack([_ellipse(0.5, 0.5, 0.4, 0.3), _ellipse(0.55, 0.5, 0.3, 0.2)]),
        "left_eye_mask": np.stack([_ellipse(0.42, 0.4, 0.08, 0.1),
                                   _ellipse(0.5, 0.42, 0.05, 0.06)]),
        "right_eye_mask": np.stack([_ellipse(0.42, 0.6, 0.08, 0.1),
                                    _ellipse(0.5, 0.58, 0.04, 0.05)]),
        "code": (0.1 * rng.standard_normal((B, 306))).astype(np.float32),
        "sample_idx": np.array([2, 0], np.int64),
        "pitchyaw": (0.2 * rng.standard_normal((B, 2))).astype(np.float32),
        "c2w_Rmat": rep(np.diag([1.0, -1.0, -1.0])),
        "c2w_Tvec": rep([0.0, 0.0, 12.0]),
        "inmat": rep(inmat),
    }


def _f64(batch):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


class JaxSteps(threading.Thread):
    """JAX's single-device ``Trainer.train_step`` of both configs (without
    and with the GAN) in x64 mode from its own initial state at step 0 (the
    jitter from ``JITTER_KEY``; the model's compute dtype float64, the
    discriminator's f32), on a thread of this process, so that JAX compiles
    while the port's processes run.  ``init(gan)`` waits for the initial
    state and the jitter draws (float64), ``done(gan)`` for the updated
    state (with Adam's moments) and the losses."""

    def __init__(self):
        super().__init__(name="jax-steps", daemon=True)
        self._init = {gan: Future() for gan in (False, True)}
        self._done = {gan: Future() for gan in (False, True)}

    def init(self, gan: bool):
        return self._init[gan].result(timeout=TIMEOUT_S)

    def done(self, gan: bool):
        return self._done[gan].result(timeout=TIMEOUT_S)

    def run(self):
        try:
            self._steps()
        except BaseException as e:  # every waiting test fails with it
            for f in (*self._init.values(), *self._done.values()):
                if not f.done():
                    f.set_exception(e)

    def _steps(self):
        def sampler(*args, key=None, **kw):
            return jax_sample_coarse(*args, key=None if key is None else JITTER_KEY, **kw)

        with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
            mp.setattr(jax_gaze_nerf, "sample_coarse", sampler)
            mp.setattr(jax_gaze_nerf, "jnp", _JnpFloat64())
            trainers = {}
            for gan in (False, True):
                jcfg = tiny_jax_config(gan)
                tr = trainers[gan] = JaxTrainer(jcfg, train_len=TRAIN_LEN, steps_per_epoch=1)
                init = _numpy({"params": tr.state.params, "offsets": tr.state.offsets,
                               "disc": {"params": tr.state.disc_params,
                                        "batch_stats": tr.state.disc_batch_stats}
                               if gan else None})
                m = jcfg.model
                t_rand = np.array(jax.random.uniform(JITTER_KEY, (B, m.num_rays,
                                                                  m.num_sample_coarse + 1)))
                assert t_rand.dtype == np.float64
                self._init[gan].set_result((init, t_rand))
            batch = {k: jnp.asarray(v) for k, v in _f64(make_batch(7)).items()}
            for gan, tr in trainers.items():
                new, losses = tr.train_step(tr.state, batch)
                adam = {k: st.inner_state[0] for k, st in new.opt_state.inner_states.items()}
                self._done[gan].set_result((
                    _numpy({"params": new.params, "offsets": new.offsets,
                            "mu": {k: a.mu[k] for k, a in adam.items()},
                            "nu": {k: a.nu[k] for k, a in adam.items()}}),
                    {k: float(v) for k, v in losses.items()}))


@pytest.fixture(scope="module")
def jax_steps():
    """The :class:`JaxSteps` thread, started by the first test that asks for
    it (the tests before the steps ask too, so that JAX compiles while they
    run) and joined at the module's end: its patches of the JAX model are
    undone before another module runs."""
    steps = JaxSteps()
    steps.start()
    yield steps
    steps.join(timeout=2 * TIMEOUT_S)
    assert not steps.is_alive(), "JAX's steps ran past their time"


def _case(jcfg, mode, world, dp, rp, work, **extra):
    port_model = {**dataclasses.asdict(jcfg.model), "compute_dtype": "float64",
                  "renderer_dtype": "float64"}
    case = {"mode": mode, "world": world, "dp": dp, "rp": rp, "model": port_model,
            "loss": dataclasses.asdict(jcfg.loss), "train": dataclasses.asdict(jcfg.train),
            "train_len": TRAIN_LEN, "steps_per_epoch": 1, "inputs": str(work / "inputs.pt"),
            "timeout_s": TIMEOUT_S, "coordinator": f"localhost:{free_port()}", **extra}
    out = work / f"out_{world}"
    out.mkdir()
    case["out"] = str(out)
    path = work / f"case_{world}.json"
    path.write_text(json.dumps(case))
    return path, out


def start_workers(case_path, n):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, str(WORKER), str(case_path), str(r)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
            for r in range(n)]


def join_workers(procs):
    """Each worker's output; fails (killing the rest) on a worker that exits
    non-zero or overstays ``TIMEOUT_S``."""
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace"))
            except subprocess.TimeoutExpired:
                pytest.fail(f"a worker ran past {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i}:\n{out[-3000:]}"
    return outs


def _load(out_dir, n):
    return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False) for r in range(n)]


@pytest.mark.usefixtures("jax_steps")  # JAX compiles meanwhile
def test_ray_split_forward_with_the_fine_pass_matches_one_process(tmp_path):
    """Four processes (``dp 2 x rp 2``): the jittered forward with the fine
    pass (``hier_sampling``) gives each data index the one-process model's
    rows: the coarse and fine images and the gathered featmaps, and each
    process its rays' weights and depths, which are not gathered (float64,
    atol 1e-9: the fields' products over other row counts sum in other
    orders), with the jitter and the fine pass's draws taken from the
    global batch's; the generators end alike."""
    jcfg = tiny_jax_config(False)
    mcfg = dict(dataclasses.asdict(jcfg.model), hier_sampling=True, compute_dtype="float64",
                renderer_dtype="float64")
    model = GazeNeRF(ModelConfig(**mcfg), device="cpu", seed=3).double()
    batch = {k: torch.from_numpy(v) for k, v in _f64(make_batch(7)).items()}
    offsets = {k: v.double() for k, v in make_offsets(TRAIN_LEN).items()}
    args = compose_codes_and_cams(Config(model=model.cfg), batch, offsets,
                                  torch.zeros(79, dtype=torch.float64))[:6]
    torch.save({"model": model.state_dict(), "args": [a.detach() for a in args], "seed": 5},
               tmp_path / "inputs.pt")
    case, out = _case(jcfg, "forward", 4, 2, 2, tmp_path)
    spec = json.loads(case.read_text())
    spec["model"] = mcfg
    case.write_text(json.dumps(spec))
    procs = start_workers(case, 4)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        want = model(pixel_grid(FEAT)[None].expand(B, -1, -1), *args, train=True, generator=gen)
    join_workers(procs)
    got = _load(out, 4)
    R = FEAT * FEAT
    for r, g in enumerate(got):
        rows = slice(r // 2, r // 2 + 1)
        rays = slice(r % 2 * R // 2, (r % 2 + 1) * R // 2)
        pairs = [(g["coarse"], want["coarse_dict"]["merge_img"][rows]),
                 (g["fine"], want["fine_dict"]["merge_img"][rows]),
                 (g["weights"], want["weights"][rows, rays]),
                 (g["depth"]["face"], want["depth"]["face"][rows, rays]),
                 (g["depth"]["eyes"], want["depth"]["eyes"][rows, rays]),
                 *((g["featmaps"][k], want["featmaps"][k][rows]) for k in want["featmaps"])]
        for i, (a, w) in enumerate(pairs):
            assert a.shape == w.shape, (r, i)
            assert a.dtype == torch.float64
            np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0, atol=1e-9,
                                       err_msg=f"rank {r}, output {i}")
        assert torch.equal(g["generator"], gen.get_state()), r


@pytest.mark.usefixtures("jax_steps")  # JAX compiles meanwhile
def test_two_process_checkpoint_restores_and_continues_to_the_bit(tmp_path):
    """Two processes (dp 2): two epochs of two steps with a checkpoint after
    the first (process 0 writes it between barriers), then fresh trainers
    that restore it and take the second epoch again: the same state and
    losses to the bit, on both processes, which hold the same state."""
    jcfg = tiny_jax_config(False)
    torch.save({"batches": [make_batch(s) for s in range(4)]}, tmp_path / "inputs.pt")
    case, out = _case(jcfg, "ckpt", 2, 2, 1, tmp_path, ckpt_dir=str(tmp_path / "ck"))
    spec = json.loads(case.read_text())
    spec["model"] = dataclasses.asdict(jcfg.model)
    spec["steps_per_epoch"] = 2
    case.write_text(json.dumps(spec))
    join_workers(start_workers(case, 2))
    got = _load(out, 2)
    assert sorted(os.listdir(tmp_path / "ck")) == ["epoch_1"]
    for g in got:
        a, b = g["uninterrupted"], g["resumed"]
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
            assert torch.equal(a[k], got[0]["uninterrupted"][k]), k
        ha, hb = g["history"]
        # the restored history holds the first epoch; both hold the second's loss
        assert [(h["epoch"], h["loss"]) for h in ha] == [(h["epoch"], h["loss"]) for h in hb]
        assert [h["epoch"] for h in hb] == [0, 1] and np.isfinite(hb[-1]["loss"])


@pytest.mark.usefixtures("jax_steps")
@pytest.mark.parametrize("rp", [1, 2], ids=["dp2", "rp2"])
def test_dryrun_trains_and_resumes_through_the_cli(rp, monkeypatch):
    """``python -m gazenerf_tpu_torch.parallel.dryrun 2 --device cpu
    [--rp 2]``: two processes of the training CLI over gloo, one epoch and
    a resumed second, finite losses."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = dryrun(2, rp=rp, device="cpu", timeout=TIMEOUT_S)
    assert (out["dp"], out["rp"]) == (2 // rp, rp)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))


# (dp, rp, gan): data-, ray- and both-parallel, the last with the PatchGAN
CASES = [(2, 1, False), (1, 2, False), (2, 2, True)]


@pytest.mark.parametrize("dp,rp,gan", CASES, ids=["dp2", "rp2", "dp2_rp2_gan"])
def test_multi_process_step_matches_one_process_and_jax(dp, rp, gan, tmp_path, jax_steps):
    """The ``dp x rp``-process step (gloo, CPU) holds, on every process,
    the one-process step's losses (rtol 1e-5) and updated state (atol 1e-6:
    network, offset tables, Adam's moments and, with the GAN, the
    discriminator's parameters and BatchNorm statistics), and JAX's single-device step's
    (loss rtol 1e-4, parameters atol 2e-5, offset tables atol 1e-5).  The
    processes' states are equal to the bit.  With the GAN the step count is
    0, where the generator term's warm-up weight is 0 and JAX's f32
    discriminator does not reach the generator's update; a second step, at
    warm-up 1 / 10, is held against the one-process step's second."""
    jcfg = tiny_jax_config(gan)
    batch = make_batch(7)
    # the rows' masks differ, so only the whole batch's denominator gives
    # the one-process masked means
    assert batch["head_mask"][0].sum() > 1.5 * batch["head_mask"][1].sum()
    n = dp * rp
    n_blocks = jcfg.model.n_upsample_blocks
    init, t_rand = jax_steps.init(gan)
    inputs = {"model": params_from_jax(init["params"], n_blocks),
              "offsets": {k: torch.from_numpy(np.asarray(v, np.float64))
                          for k, v in init["offsets"].items()},
              "batch": batch, "t_rand": torch.from_numpy(t_rand)}
    if gan:
        inputs["disc"] = patchgan_params_from_jax(init["disc"])
    torch.save(inputs, tmp_path / "inputs.pt")
    steps = 2 if gan else 1
    mesh_case, mesh_out = _case(jcfg, "step", n, dp, rp, tmp_path, float64=True, steps=steps)
    one_case, one_out = _case(jcfg, "step", 0, 1, 1, tmp_path, float64=True, steps=steps)
    procs = start_workers(mesh_case, n) + start_workers(one_case, 1)
    try:
        new, want_losses = jax_steps.done(gan)  # while the workers run
    finally:
        join_workers(procs)
    got, (one,) = _load(mesh_out, n), _load(one_out, 1)

    for r, g in enumerate(got):  # replicated state, to the bit
        for st, st0 in zip(g["state"], got[0]["state"]):
            for k, v in st.items():
                assert torch.equal(v, st0[k]), (r, k)
    g = got[0]
    if rp > 1:  # features and background alphas: (C + 1) per ray and branch
        gathered = g["traffic"]["gather"]
        C = jcfg.model.featmap_nc
        assert gathered["calls"] == 1, g["traffic"]
        assert gathered["bytes"] == 2 * (C + 1) * B // dp * FEAT * FEAT * 8, g["traffic"]
    else:
        assert "gather" not in g["traffic"], g["traffic"]
    # against the one-process step, after each step
    for i in range(steps):
        assert set(g["losses"][i]) == set(one["losses"][i])
        for k, v in one["losses"][i].items():
            np.testing.assert_allclose(g["losses"][i][k], v, rtol=1e-5, atol=1e-12,
                                       err_msg=f"step {i}: {k}")
        for k, v in one["state"][i].items():
            if k == "generator":  # no draws: the step was given them
                continue
            np.testing.assert_allclose(g["state"][i][k].double().numpy(), v.double().numpy(),
                                       rtol=0, atol=1e-6, err_msg=f"step {i}: {k}")
    if gan:
        assert one["losses"][0]["gen_patch_gan_loss"] == 0.0
        assert one["losses"][1]["gen_patch_gan_loss"] > 0.0
        disc = [k for k in one["state"][0] if k.startswith("disc.")]
        assert any("running_var" in k for k in disc)
        moved = [k for k in disc if not torch.equal(one["state"][0][k],
                                                    inputs["disc"][k[5:]].double())]
        assert len(moved) == len(disc), sorted(set(disc) - set(moved))
    # against JAX's single-device step
    np.testing.assert_allclose(g["losses"][0]["total_loss"], want_losses["total_loss"],
                               rtol=1e-4)
    want = params_from_jax(new["params"], n_blocks)
    for k, v in want.items():
        np.testing.assert_allclose(g["state"][0][f"model.{k}"].numpy(), v.numpy(), rtol=0,
                                   atol=2e-5, err_msg=k)
    for k, v in new["offsets"].items():
        np.testing.assert_allclose(g["state"][0][f"offsets.{k}"].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-5, err_msg=k)
    # Adam's moments after one step: the reduced gradient's scale and its
    # square, which the sign-led update above does not show (relative L2
    # per tensor at the JAX test's loss rtol; readings below 1e-6)
    for mom, jname in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        tree = new[jname]
        want = {f"model.{k}": v.numpy() for k, v in params_from_jax(tree["net"], n_blocks).items()}
        want.update({f"offsets.{k}": np.asarray(v) for k, v in tree.items() if k != "net"})
        for k, w in want.items():
            a = g["state"][0][f"adam.{k}.{mom}"].numpy()
            assert np.linalg.norm(a - w) <= 1e-4 * np.linalg.norm(w), (mom, k)


class _FakeDist:
    """``torch.distributed`` as ``make_mesh`` sees it from rank ``rank`` of
    ``world`` processes: a group is the list of its ranks."""

    def __init__(self, world, rank):
        self.world, self.rank = world, rank

    def is_initialized(self):
        return True

    def get_world_size(self):
        return self.world

    def get_rank(self):
        return self.rank

    def new_group(self, ranks):
        return list(ranks)


@pytest.mark.parametrize("world,dp,rp", [(8, 4, 2), (8, 0, 2), (4, 0, 1), (6, 2, 3), (2, 1, 2)])
def test_mesh_layout(world, dp, rp, monkeypatch):
    """Ranks row-major over ``(data, ray)`` (JAX's ``reshape(dp, rp)``):
    each rank's coordinates, its ray group (its data index's ranks) and its
    data group (its ray index's); ``dp = 0`` takes all remaining."""
    want_dp = dp or world // rp
    layout = np.arange(world).reshape(want_dp, rp)
    for rank in range(world):
        monkeypatch.setattr(mesh_mod, "dist", _FakeDist(world, rank))
        mesh = mesh_mod.make_mesh(dp, rp, device="cpu")
        assert mesh.shape == {"data": want_dp, "ray": rp} and mesh.size == world
        d, j = mesh.data_index, mesh.ray_index
        assert layout[d, j] == rank
        assert mesh.ray_group == list(layout[d]) and mesh.data_group == list(layout[:, j])
        assert mesh.device == torch.device("cpu")


def test_mesh_refuses_a_layout_that_is_not_the_world(monkeypatch):
    monkeypatch.setattr(mesh_mod, "dist", _FakeDist(4, 0))
    with pytest.raises(ValueError, match=r"ray_parallel \(--rp\) 3 does not divide"):
        mesh_mod.make_mesh(0, 3, device="cpu")
    with pytest.raises(ValueError, match=r"data_parallel \(--dp\) 3 x ray_parallel \(--rp\) 1"):
        mesh_mod.make_mesh(3, 1, device="cpu")


def test_one_process_mesh_without_a_group():
    """Without a process group the mesh is one process, its collectives do
    nothing, and ``init_distributed`` is a no-op for one process."""
    mesh_mod.init_distributed(None, 1, 0)
    assert not torch.distributed.is_initialized()
    mesh = mesh_mod.make_mesh(device="cpu")
    assert (mesh.shape, mesh.rank, mesh.distributed) == ({"data": 1, "ray": 1}, 0, False)
    x = torch.arange(3.0)
    assert mesh.all_reduce(x) is x and torch.equal(x, torch.arange(3.0))
    assert mesh.traffic == {}
