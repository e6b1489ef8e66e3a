"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and ``nvcc``; without a card they skip.  The
file imports nothing of JAX, so on a machine without JAX it runs without
the repository's conftest:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import dataclasses
import json

import pytest
import torch

from gazenerf_tpu_torch import Config, GazeNeRF, LossConfig, Trainer, small_test_config
from gazenerf_tpu_torch.data.cameras import base_inv_inmat
from gazenerf_tpu_torch.kernels import checks
from gazenerf_tpu_torch.kernels import fused_field as ff
from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb
from gazenerf_tpu_torch.models.mlp_nerf import NeRFFieldMLP
from gazenerf_tpu_torch.ops.rays import pixel_grid
from gazenerf_tpu_torch.viewer.server import lookat_camera

pytestmark = pytest.mark.cuda
NAMES = ("feat_int", "bg_alpha", "depth", "weights")
TEST_CASES = ("narrow", "wide", "medium")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _hold(name, got, want, limit):
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    rel = float((got - want).norm() / want.norm())
    print(f"{name}: max abs err {err:.3e}, |plain| max {scale:.3e}, ratio {err / scale:.3e}, "
          f"rel L2 {rel:.3e}")
    assert torch.isfinite(got).all(), name
    assert scale > 0 and err <= limit * scale, (name, err, scale)


@pytest.mark.parametrize("case", TEST_CASES)
def test_fused_field_matches_plain_version(card, case):
    """Same rounding points, other summation order: now and then a bf16
    activation rounds the other way, a step of 2^-8 of it."""
    args, _ = checks.field_case(*checks.K2_CASES[case], card)
    with torch.no_grad():
        before = ff.launch_count
        got = ff.fused_field_forward(*args)
        torch.cuda.synchronize()
        assert ff.launch_count == before + 1
        want = ff.fused_field_reference(*args)
    for n, a, b in zip(NAMES, got, want):
        _hold(n, a, b, checks.K1_REL_ERR)


@pytest.mark.parametrize("case", TEST_CASES)
def test_fused_field_backward_matches_plain_version(card, case):
    """The backward kernel against its plain version on random cotangents,
    every output within its case's limits (``kernels/checks.py``).  The
    kernel folds the feature head per ray and keeps f32 data gradients as
    two bf16 halves; the plain version follows the Pallas kernel.  Two
    launches give the same bits (no atomics)."""
    args, cot = checks.field_case(*checks.K2_CASES[case], card)
    with torch.no_grad():
        before = ffb.launch_count
        got = ffb.fused_field_backward(*args, *cot)
        torch.cuda.synchronize()
        assert ffb.launch_count == before + 1
        want = ffb.fused_field_backward_reference(*args, *cot)
        again = ffb.fused_field_backward(*args, *cot)
    readings, fails = checks.k2_failures(case, got, want)
    print(json.dumps({"k2_case": case, "readings": readings}))
    assert not fails, fails
    for n, a, c in zip(ffb.FieldGrads._fields, got, again):
        assert torch.equal(a, c), f"{n}: two launches differ"  # no atomics


@pytest.mark.parametrize("case, seed", [("wide", s) for s in range(8)] + [("training", 0), ("training", 1)])
def test_fused_field_backward_as_close_to_unrounded_as_plain(card, case, seed):
    """At hidden 384 the kernel and its plain version each lie a few percent
    from the unrounded float64 gradient; per output the kernel lies at most
    ``K2_TRUTH_RATIO`` times as far as the farther of the plain version and
    the plain version computed in float64 (``kernels/checks.py``).  The
    kernel's and the plain version's distances from the float32 unrounded
    gradient are printed beside them."""
    args, cot = checks.field_case(*checks.K2_CASES[case], card, seed=seed)
    with torch.no_grad():
        got = ffb.fused_field_backward(*args, *cot)
        want = ffb.fused_field_backward_reference(*args, *cot)
        want64 = ffb.fused_field_backward_reference(*args, *cot, dtype=torch.float64)
    exact = ffb.fused_field_backward_unrounded(*args, *cot)
    f32 = ffb.fused_field_backward_unrounded(*args, *cot, dtype=torch.float32)
    dist, fails = checks.k2_truth_failures(got, want, want64, exact)
    print(json.dumps({"k2_truth": case, "seed": seed, "float64": dist,
                      "float32": checks.k2_truth_failures(got, want, want64, f32)[0]}))
    assert not fails, fails


def test_cuda_tensors_never_take_the_plain_version(card):
    """A CUDA input the kernel cannot take raises; it is not computed by
    the plain version instead."""
    field = NeRFFieldMLP(63, 181, 127, hidden=64, res_nfeat=258)
    field.reset_parameters(torch.Generator().manual_seed(0))
    field.to(card)
    z = torch.zeros(1, 8, 7, device=card)  # 7 samples do not tile 128 points
    with torch.no_grad(), pytest.raises(ValueError, match="whole rays"):
        field.fused_render(torch.zeros(1, 8, 7, 63, device=card),
                           torch.zeros(1, 181, device=card),
                           torch.zeros(1, 127, device=card), z, z)


def test_backward_cuda_tensors_never_take_the_plain_version(card):
    """The backward's CUDA inputs that the kernel cannot take raise too."""
    args, _ = checks.field_case(64, 8, 8, card)
    bad = (args[0][:, :, :7].contiguous(), args[1][:, :, :7].contiguous(),
           args[2][:, :, :7].contiguous(), *args[3:])
    cot = [torch.zeros(s, device=card) for s in ((2, 8, 258), (2, 8), (2, 8), (2, 8, 7))]
    with pytest.raises(ValueError, match="whole rays"):
        ffb.fused_field_backward(*bad, *cot)


def test_training_step_on_card_goes_through_both_kernels(card):
    """One step of the small bf16 model on the card: two launches of each
    kernel, finite losses and gradients, and the same step's losses with the
    plain versions in the kernels' place within 1e-3 (relative)."""
    model = dataclasses.replace(small_test_config(), compute_dtype="bfloat16",
                                renderer_dtype="bfloat16", use_pallas=True)
    trainer = Trainer(Config(model=model, loss=LossConfig(use_vgg_loss=False)),
                      train_len=4, steps_per_epoch=1)  # the card: no device given
    gen = torch.Generator().manual_seed(0)
    size, fs = model.pred_img_size, model.featmap_size
    inmat = torch.linalg.inv(torch.from_numpy(base_inv_inmat(fs)))  # the base camera
    inmat[:2] *= size / fs
    batch = {
        "image": torch.rand(2, size, size, 3, generator=gen),
        "head_mask": (torch.rand(2, size, size, generator=gen) > 0.3).float(),
        "left_eye_mask": (torch.rand(2, size, size, generator=gen) > 0.9).float(),
        "right_eye_mask": (torch.rand(2, size, size, generator=gen) > 0.9).float(),
        "code": 0.1 * torch.randn(2, 306, generator=gen),
        "sample_idx": torch.tensor([0, 3]),
        "pitchyaw": 0.2 * torch.randn(2, 2, generator=gen),
        "c2w_Rmat": torch.diag(torch.tensor([1.0, -1.0, -1.0])).expand(2, 3, 3),
        "c2w_Tvec": torch.tensor([[0.0, 0.0, 12.0]]).expand(2, 3),
        "inmat": inmat.expand(2, 3, 3),
    }
    t_rand = torch.rand(2, model.num_rays, model.num_sample_coarse + 1, device=card)
    before = (ff.launch_count, ffb.launch_count)
    losses = trainer.train_step(batch, t_rand=t_rand, update=False)
    torch.cuda.synchronize()
    assert (ff.launch_count - before[0], ffb.launch_count - before[1]) == (2, 2)
    for g in trainer.optimizer.param_groups:
        for p in g["params"]:
            assert p.grad is not None and torch.isfinite(p.grad).all(), g["name"]
    kernel_fwd, kernel_bwd = ff.fused_field_forward, ffb.fused_field_backward
    ff.fused_field_forward = ff.fused_field_reference
    ffb.fused_field_backward = ffb.fused_field_backward_reference
    try:
        plain = trainer.train_step(batch, t_rand=t_rand, update=False)
    finally:
        ff.fused_field_forward, ffb.fused_field_backward = kernel_fwd, kernel_bwd
    for k, v in losses.items():
        assert torch.isfinite(v), k
        torch.testing.assert_close(v, plain[k], rtol=1e-3, atol=1e-6, msg=k)


def test_render_on_card_goes_through_the_kernel(card):
    """The small bf16 model on the card: two kernel launches per render, and
    the image within the bf16 image bound (3e-2) of the same render with the
    plain version in the kernel's place."""
    cfg = dataclasses.replace(small_test_config(), compute_dtype="bfloat16",
                              renderer_dtype="bfloat16", use_pallas=True)
    model = GazeNeRF(cfg).eval()  # the card: no device given
    R, T, K = (torch.from_numpy(a).to(card) for a in lookat_camera(10, -5, 12.0, cfg.featmap_size))
    args = (pixel_grid(cfg.featmap_size, device=card)[None],
            0.1 * torch.ones(1, cfg.shape_code_dims, device=card),
            0.1 * torch.ones(1, cfg.appea_code_dims, device=card),
            torch.tensor([[0.2, -0.3]], device=card), R, T, K)
    before = ff.launch_count
    with torch.no_grad():
        img = model(*args)["coarse_dict"]["merge_img"].float()
    assert ff.launch_count == before + 2
    kernel_forward = ff.fused_field_forward
    ff.fused_field_forward = ff.fused_field_reference
    try:
        with torch.no_grad():
            plain = model(*args)["coarse_dict"]["merge_img"].float()
    finally:
        ff.fused_field_forward = kernel_forward
    assert torch.isfinite(img).all()
    torch.testing.assert_close(img, plain, atol=3e-2, rtol=0)
