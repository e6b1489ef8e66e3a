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
from gazenerf_tpu_torch.kernels import field_dw
from gazenerf_tpu_torch.kernels import fused_field as ff
from gazenerf_tpu_torch.kernels import fused_field2 as ff2
from gazenerf_tpu_torch.kernels import fused_field2_bwd as ffb2
from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb
from gazenerf_tpu_torch.kernels import fused_upsampler as fu
from gazenerf_tpu_torch.kernels import shuffle_blur as sb
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


@pytest.mark.parametrize("case", (*TEST_CASES, "training"))
def test_fused_field_matches_plain_version(card, case):
    """Same rounding points, other summation order: now and then a bf16
    activation rounds the other way, a step of 2^-8 of it.  Every output
    within its case's limits (``checks.K1_LIMITS``: at hidden 64 f32 noise);
    two launches give the same bits."""
    args, _ = checks.field_case(*checks.K2_CASES[case], card)
    with torch.no_grad():
        before = ff.launch_count
        got = ff.fused_field_forward(*args)
        torch.cuda.synchronize()
        assert ff.launch_count == before + 1
        want = ff.fused_field_reference(*args)
        again = ff.fused_field_forward(*args)
    readings, fails = checks.k1_failures(case, got, want)
    print(json.dumps({"k1_case": case, "readings": readings}))
    assert not fails, fails
    for n, a, b in zip(NAMES, got, again):
        assert torch.equal(a, b), f"{n}: two launches differ"


@pytest.mark.parametrize("samples", (8, 32, 64))
@pytest.mark.parametrize("hidden", (64, 384))
def test_forward_tile_shapes(card, hidden, samples):
    """K1 and K3 at the smallest R the tile takes (one tile of 128 points a
    batch) and each number of samples the cases use.  At hidden 64 K1 within
    the narrow case's limits of its plain version (f32 noise; at hidden 384
    its outputs over two rays carry no case's readings, and the wide and
    training cases hold them); K3 without the stash equal to K1 per branch
    to the bit, with it the same outputs and a stash within
    ``K3_STASH_LIMITS`` of the plain version's."""
    rays = ff.TILE_POINTS // samples
    args, _ = checks.field_case(hidden, samples, rays, card)
    with torch.no_grad():
        got = ff.fused_field_forward(*args)
        torch.cuda.synchronize()
        want = ff.fused_field_reference(*args)
    if hidden == 64:
        readings, fails = checks.k1_failures("narrow", got, want)
        print(json.dumps({"k1_tile": [hidden, samples, rays], "readings": readings}))
        assert not fails, fails
    for n, a in zip(NAMES, got):
        assert torch.isfinite(a).all(), n
    dargs, _ = checks.dual_case(hidden, samples, rays, card)
    with torch.no_grad():
        plain = ff2.fused_dual_forward(*dargs)
        outs, acts = ff2.fused_dual_forward(*dargs, stash=True)
        torch.cuda.synchronize()
        _, want_acts = ff2.fused_dual_reference(*dargs, stash=True)
        for i in range(ff2.N_BRANCHES):
            single = ff.fused_field_forward(*dargs[:3], *(t[i] for t in dargs[3:6]),
                                            ff2.branch_operands(dargs[6], i))
            for n, a, b, c in zip(NAMES, plain[i], single, outs[i]):
                assert torch.equal(a, b), (i, n, "K3 vs K1")
                assert torch.equal(a, c), (i, n, "the stash changed an output")
    stash_case = "narrow" if hidden == 64 else "training"
    stash_readings, stash_fails = checks.k3_stash_failures(stash_case, acts, want_acts)
    print(json.dumps({"k3_tile": [hidden, samples, rays], "stash": stash_readings}))
    assert not stash_fails, stash_fails


@pytest.mark.parametrize("hidden", (96, 448))
def test_forward_rejects_widths_the_tile_cannot_take(card, hidden):
    """A hidden width the tile body cannot take (not in 64-column blocks, or
    wider than two passes of 192 columns) raises in K1's and K3's wrappers."""
    args, _ = checks.field_case(hidden, 8, 16, card)
    with torch.no_grad(), pytest.raises(ValueError, match="hidden width"):
        ff.fused_field_forward(*args)
    dargs, _ = checks.dual_case(hidden, 8, 16, card)
    with torch.no_grad(), pytest.raises(ValueError, match="hidden width"):
        ff2.fused_dual_forward(*dargs)


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
    dist, fails = checks.truth_failures(got, want, want64, exact, checks.K2_TRUTH_RATIO,
                                        checks.K2_TRUTH_EXEMPT)
    print(json.dumps({"k2_truth": case, "seed": seed, "float64": dist,
                      "float32": checks.truth_failures(got, want, want64, f32, 1.0)[0]}))
    assert not fails, fails


@pytest.mark.parametrize("dens_vpu", [False, True], ids=["rounded", "dens_vpu"])
def test_stash_modes_match_plain_version(card, dens_vpu):
    """The narrow case (hidden 64): K1 writing the stash gives K1's outputs
    to the bit and every stash slot within one bf16 step (2^-8) of the
    largest value and 1e-3 relative L2 of the plain version's (a flipped
    rounding moves a value by a step); K2 reading it, with or without ``dens_vpu``, within
    ``checks.K2_STASH_LIMITS`` of its plain version on the same stash,
    equal to K2 recomputing to the bit (with ``dens_vpu`` all but dWd), and
    the same bits over two launches."""
    args, cot = checks.field_case(*checks.K2_CASES["narrow"], card)
    with torch.no_grad():
        out, acts = ff.fused_field_forward(*args, stash=True)
        assert all(torch.equal(a, b) for a, b in zip(out, ff.fused_field_forward(*args)))
        _, want_acts = ff.fused_field_reference(*args, stash=True)
        _, fails = checks.limit_failures(checks.Stash(*acts), checks.Stash(*want_acts),
                                         {n: (2.0**-8, 1e-3) for n in checks.STASH_SLOTS})
        assert not fails, fails
        before = ffb.launch_count
        got = ffb.fused_field_backward(*args, *cot, stash=acts, dens_vpu=dens_vpu)
        torch.cuda.synchronize()
        assert ffb.launch_count == before + 1
        again = ffb.fused_field_backward(*args, *cot, stash=acts, dens_vpu=dens_vpu)
        recompute = ffb.fused_field_backward(*args, *cot)
        want = ffb.fused_field_backward_reference(*args, *cot, stash=acts, dens_vpu=dens_vpu)
    readings, fails = checks.k2_stash_failures("narrow", got, want)
    print(json.dumps({"k2_stash": dens_vpu, "readings": readings}))
    assert not fails, fails
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    differ = [n for n, a, b in zip(got._fields, got, recompute) if not torch.equal(a, b)]
    assert differ == (["dWd"] if dens_vpu else []), differ


def test_backward_split_dw_matches_plain_version(card, monkeypatch):
    """``pallas_split_dw`` (with ``pallas_dens_vpu`` asked for too): a step
    of the small bf16 model on the card has K1 write the stash and K2 read
    it without ``dens_vpu`` (dWd from the rounded density cotangent, the
    mode the model selects for it), and K2 in that mode at the training
    shape (hidden 384, 64 samples, 4096 rays) is within
    ``checks.K2_STASH_LIMITS`` of its plain version, the same bits over two
    launches, and every output to the bit of K2 recomputing."""
    model = dataclasses.replace(small_test_config(), compute_dtype="bfloat16",
                                renderer_dtype="bfloat16", use_pallas=True,
                                pallas_split_dw=True, pallas_dens_vpu=True)
    trainer = Trainer(Config(model=model, loss=LossConfig(use_vgg_loss=False)),
                      train_len=4, steps_per_epoch=1)  # the card: no device given
    modes = []
    fwd, bwd = ff.fused_field_forward, ffb.fused_field_backward
    monkeypatch.setattr(ff, "fused_field_forward", lambda *a, stash=False, **k: (
        modes.append(("K1", stash)), fwd(*a, stash=stash, **k))[1])
    monkeypatch.setattr(ffb, "fused_field_backward", lambda *a, stash=None, dens_vpu=False, **k: (
        modes.append(("K2", stash is not None, dens_vpu)), bwd(*a, stash=stash, dens_vpu=dens_vpu,
                                                               **k))[1])
    before = ffb.launch_count
    losses = trainer.train_step(_small_batch(model), update=False)
    torch.cuda.synchronize()
    assert ffb.launch_count == before + 2
    assert modes == [("K1", True)] * 2 + [("K2", True, False)] * 2, modes
    assert all(torch.isfinite(v) for v in losses.values())
    monkeypatch.undo()
    args, cot = checks.field_case(*checks.K2_CASES["training"], card)
    with torch.no_grad():
        _, acts = ff.fused_field_forward(*args, stash=True)
        got = ffb.fused_field_backward(*args, *cot, stash=acts)
        again = ffb.fused_field_backward(*args, *cot, stash=acts)
        recompute = ffb.fused_field_backward(*args, *cot)
        want = ffb.fused_field_backward_reference(*args, *cot, stash=acts)
    readings, fails = checks.k2_stash_failures("training", got, want)
    print(json.dumps({"k2_split_dw": "training", "readings": readings}))
    assert not fails, fails
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, recompute))


@pytest.mark.parametrize("mode", checks.K2_FIT_MODES)
def test_backward_fit_case_matches_plain_version(card, mode):
    """K2 at B=1 (the single-image fit and the gaze optimization: hidden
    384, 64 samples, 4096 rays), recomputing and reading K1's stash with
    ``dens_vpu``: within ``checks.K2_FIT_LIMITS`` of its plain version,
    within its mode's ratio of the plain versions' distance from the
    unrounded float64 gradient, and the same bits over two launches.
    Reading the stash: K1's outputs and stash at B=1 within the training
    case's limits of its plain version's, and the density masks of K2 and
    its plain version equal at every point."""
    args, cot = checks.field_case(*checks.K2_FIT_CASE, card, batch=checks.K2_FIT_BATCH)
    fails = []
    with torch.no_grad():
        kw = {}
        if mode == "stash_dens_vpu":
            out, acts = ff.fused_field_forward(*args, stash=True)
            plain_out, plain_acts = ff.fused_field_reference(*args, stash=True)
            fails += checks.k1_failures("training", out, plain_out)[1]
            fails += checks.k1_stash_failures(acts, plain_acts)[1]
            kw = {"stash": acts, "dens_vpu": True}
        got = ffb.fused_field_backward(*args, *cot, **kw)
        again = ffb.fused_field_backward(*args, *cot, **kw)
        want = ffb.fused_field_backward_reference(*args, *cot, **kw)
        want64 = ffb.fused_field_backward_reference(*args, *cot, dtype=torch.float64, **kw)
        if kw:
            assert checks.density_mask_flips(got, want) == 0
    exact = ffb.fused_field_backward_unrounded(*args, *cot)
    readings, f = checks.k2_fit_failures(mode, got, want)
    ratio, exempt = checks.K2_FIT_TRUTH[mode]
    dist, truth_fails = checks.truth_failures(got, want, want64, exact, ratio, exempt)
    print(json.dumps({"k2_fit": mode, "readings": readings, "unrounded_distance": dist}))
    assert not fails + f + truth_fails, fails + f + truth_fails
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", list(checks.POINTS_CASES))
def test_points_forward_matches_plain_version(card, case):
    """K1 given the sample points (``embed_in_kernel``) against its plain
    version given them within ``POINTS_K1_LIMITS``, one launch, the same
    bits over two launches, and to the bit K1 given the plain encoding of
    the points computed on the card and rounded to bf16; the entries where
    that encoding and the same encoding on the CPU round to other bf16
    values are counted and printed."""
    args, _ = checks.points_case(*checks.POINTS_CASES[case], card)
    nf = checks.N_FREQS
    with torch.no_grad():
        before = ff.launch_count
        got = ff.fused_field_forward(*args, n_freqs=nf)
        torch.cuda.synchronize()
        assert ff.launch_count == before + 1
        again = ff.fused_field_forward(*args, n_freqs=nf)
        want = ff.fused_field_reference(*args, n_freqs=nf)
        plain = ff.encoded(args[0], nf).to(torch.bfloat16)
        via_plain = ff.fused_field_forward(plain, *args[1:])
    readings, fails = checks.points_k1_failures(case, got, want)
    flips = checks.encoding_flips(plain.cpu(),
                                  ff.encoded(args[0].cpu(), nf).to(torch.bfloat16))
    print(json.dumps({"k1_points": case, "readings": readings,
                      "encoding_flips_card_vs_cpu": flips, "entries": plain.numel()}))
    assert not fails, fails
    for n, a, b, c in zip(NAMES, got, again, via_plain):
        assert torch.equal(a, b), f"{n}: two launches differ"
        assert torch.equal(a, c), f"{n}: differs from K1 given the plain encoding"


@pytest.mark.parametrize("case", list(checks.POINTS_CASES))
def test_points_backward_matches_plain_version(card, case):
    """K2 given the points against its plain version given them (the
    weight gradients summed in the kernel's chunks) within
    ``POINTS_K2_LIMITS``, one launch, the same bits over two launches; every
    output but the points' cotangent to the bit of K2 given the plain
    encoding computed on the card as a bf16 embedding; in the stash cases K2 reading K1's stash of the
    points with ``dens_vpu`` against its plain version reading it."""
    args, cot = checks.points_case(*checks.POINTS_CASES[case], card)
    nf, chunks = checks.N_FREQS, checks.deep_chunks(args)
    with torch.no_grad():
        before = ffb.launch_count
        got = ffb.fused_field_backward(*args, *cot, n_freqs=nf)
        torch.cuda.synchronize()
        assert ffb.launch_count == before + 1
        assert got.dembed.shape == args[0].shape and got.dembed.dtype == torch.float32
        again = ffb.fused_field_backward(*args, *cot, n_freqs=nf)
        want = ffb.fused_field_backward_reference(*args, *cot, n_freqs=nf, chunks=chunks)
        plain = ffb.fused_field_backward(ff.encoded(args[0], nf).to(torch.bfloat16),
                                         *args[1:], *cot)
    readings, fails = checks.points_k2_failures(case, got, want)
    out = {"k2_points": case, "readings": readings}
    if case in checks.POINTS_STASH_CASES:
        with torch.no_grad():
            _, acts = ff.fused_field_forward(*args, stash=True, n_freqs=nf)
            sg = ffb.fused_field_backward(*args, *cot, stash=acts, dens_vpu=True, n_freqs=nf)
            sw = ffb.fused_field_backward_reference(*args, *cot, stash=acts, dens_vpu=True,
                                                    n_freqs=nf, chunks=chunks)
        out["stash_readings"], f = checks.points_k2_failures(f"{case}_stash", sg, sw)
        fails += f
    print(json.dumps(out))
    assert not fails, fails
    for n, a, b, c in zip(got._fields, got, again, plain):
        assert torch.equal(a, b), f"{n}: two launches differ"
        assert n == "dembed" or torch.equal(a, c), f"{n}: differs from K2 on the plain encoding"


@pytest.mark.parametrize("case", ["narrow", "training"])
def test_points_backward_as_close_to_unrounded_as_plain(card, case):
    """K2 given the points against the unrounded float64 gradient (the
    points' cotangent included): K2's rule (``K2_TRUTH_RATIO``)."""
    args, cot = checks.points_case(*checks.POINTS_CASES[case], card)
    nf = checks.N_FREQS
    with torch.no_grad():
        got = ffb.fused_field_backward(*args, *cot, n_freqs=nf)
        want = ffb.fused_field_backward_reference(*args, *cot, n_freqs=nf)
        want64 = ffb.fused_field_backward_reference(*args, *cot, n_freqs=nf, dtype=torch.float64)
    exact = ffb.fused_field_backward_unrounded(*args, *cot, n_freqs=nf)
    dist, fails = checks.truth_failures(got, want, want64, exact, checks.K2_TRUTH_RATIO,
                                        checks.K2_TRUTH_EXEMPT)
    print(json.dumps({"k2_points_truth": case, "float64": dist}))
    assert not fails, fails


@pytest.mark.parametrize("case", ["narrow", "training"])
def test_backward_bf16_dembed_is_one_rounding(card, case):
    """The field's autograd op given a bf16 embedding (``pallas_embed_bf16``)
    returns its cotangent in bf16: the rounding of the f32 cotangent that
    K2 gives the f32 embedding, to the bit, and the same weight gradients."""
    args, cot = checks.field_case(*checks.K2_CASES[case], card)
    embed, rest, w = args[0], args[1:6], args[6]
    H, Kp = w.w0e.shape
    H2, C = w.wr2.shape
    B, De = embed.shape[0], embed.shape[-1]
    shapes = ffb.grad_shapes(B, Kp, H, C)
    shapes["dW0e"] = shapes["dW5e"] = (De, H)
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        e = embed.to(dtype).requires_grad_(True)
        weights = [torch.zeros(shapes[f"d{k}"], device=card, requires_grad=True)
                   for k in ff.WEIGHT_KEYS]
        out = ff.FusedField.apply(w, False, False, None, e, *rest, *weights)
        torch.autograd.backward(out, cot)
        grads[dtype] = (e.grad, [t.grad for t in weights])
    (d32, w32), (dbf, wbf) = grads[torch.float32], grads[torch.bfloat16]
    assert dbf.dtype == torch.bfloat16
    assert torch.equal(dbf, d32.to(torch.bfloat16))
    for k, a, b in zip(ff.WEIGHT_KEYS, w32, wbf):
        assert torch.equal(a, b), k


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


def _small_batch(model):
    """A seeded B=2 training batch at the small model's size, the base camera."""
    gen = torch.Generator().manual_seed(0)
    size, fs = model.pred_img_size, model.featmap_size
    inmat = torch.linalg.inv(torch.from_numpy(base_inv_inmat(fs)))  # the base camera
    inmat[:2] *= size / fs
    return {
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


@pytest.mark.parametrize("mode", ["phase_gm", "pallas", "fused"])
def test_training_step_on_card_goes_through_both_kernels(card, mode):
    """One step of the small bf16 model on the card: two launches of each
    field kernel and, in a kernel mode of the renderer, one launch of its
    forward and of its backward kernel per upsample block and renderer pass
    (four passes, all four with a gradient: the background pass carries
    ``bg_loss``); finite losses and gradients, and the same step's losses
    with the plain versions in the kernels' place within 1e-3 (relative)."""
    model = dataclasses.replace(small_test_config(), compute_dtype="bfloat16",
                                renderer_dtype="bfloat16", use_pallas=True, shuffle_mode=mode)
    trainer = Trainer(Config(model=model, loss=LossConfig(use_vgg_loss=False)),
                      train_len=4, steps_per_epoch=1)  # the card: no device given
    batch = _small_batch(model)
    t_rand = torch.rand(2, model.num_rays, model.num_sample_coarse + 1, device=card)
    before = (ff.launch_count, ffb.launch_count, *_counts())
    losses = trainer.train_step(batch, t_rand=t_rand, update=False)
    torch.cuda.synchronize()
    n = 4 * model.n_upsample_blocks
    renderer = {"phase_gm": (0, 0, 0, 0), "pallas": (n, n, 0, 0), "fused": (0, 0, n, n)}[mode]
    used = tuple(a - b for a, b in zip((ff.launch_count, ffb.launch_count, *_counts()), before))
    assert used == (2, 2, *renderer)
    for g in trainer.optimizer.param_groups:
        for p in g["params"]:
            assert p.grad is not None and torch.isfinite(p.grad).all(), g["name"]
    with checks.plain_versions():
        plain = trainer.train_step(batch, t_rand=t_rand, update=False)
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


# ---------------------------------------------------------------------------
# the renderer's kernels: the blur-shuffle stencil (K5, K6) and the fused
# upsampler block (K7, K8)


def _counts():
    return sb.launch_count_fwd, sb.launch_count_bwd, fu.launch_count_fwd, fu.launch_count_bwd


@pytest.mark.parametrize("case", list(checks.STENCIL_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_shuffle_blur_matches_plain_version(card, case, dtype):
    """K5 and K6 against their plain versions, to the bit
    (``checks.STENCIL_MAX_ABS_ERR``), one launch each."""
    x, dy = checks.stencil_case(checks.STENCIL_CASES[case], card, dtype)
    before = _counts()
    y, dx = sb.shuffle_blur_forward(x), sb.shuffle_blur_backward(dy)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, *before[2:])
    for name, got, want in (("K5", y, sb.shuffle_blur_reference(x)),
                            ("K6", dx, sb.shuffle_blur_backward_reference(dy))):
        assert got.dtype == want.dtype == dtype and got.shape == want.shape, name
        err = float((got.float() - want.float()).abs().max())
        print(f"{name} {case} {dtype}: max abs err {err:.3e}")
        assert err <= checks.STENCIL_MAX_ABS_ERR, (name, err)


@pytest.mark.parametrize("case", list(checks.BLOCK_CASES))
def test_fused_upsampler_matches_plain_version(card, case):
    """K7's bf16 output against its plain version within ``K7_LIMITS``."""
    args, _ = checks.block_case(checks.BLOCK_CASES[case], card)
    before = _counts()
    got = fu.fused_upsample_forward(*args)
    torch.cuda.synchronize()
    assert _counts() == (*before[:2], before[2] + 1, before[3])
    want = fu.fused_upsample_reference(*args)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    reading, fails = checks.k7_failures(case, got, want)
    print(json.dumps({"k7_case": case, "reading": reading}))
    assert not fails, fails


@pytest.mark.parametrize("case", list(checks.BLOCK_CASES))
def test_fused_upsampler_backward_matches_plain_version(card, case):
    """K8 against its plain version, every output within ``K8_LIMITS``;
    two launches give the same bits (every sum in a fixed order)."""
    args, dy = checks.block_case(checks.BLOCK_CASES[case], card)
    before = _counts()
    got = fu.fused_upsample_backward(*args, dy)
    torch.cuda.synchronize()
    assert _counts() == (*before[:3], before[3] + 1)
    again = fu.fused_upsample_backward(*args, dy)
    want = fu.fused_upsample_backward_reference(*args, dy)
    readings, fails = checks.k8_failures(case, got, want)
    print(json.dumps({"k8_case": case, "readings": readings}))
    assert not fails, fails
    for n, a, c in zip(fu.UpsampleGrads._fields, got, again):
        assert torch.equal(a, c), f"{n}: two launches differ"


@pytest.mark.parametrize("case, seed", [(c, s) for c in ("block0", "block1", "block2") for s in (0, 1)])
def test_fused_upsampler_backward_as_close_to_unrounded_as_plain(card, case, seed):
    """Per output, K8 lies at most ``K8_TRUTH_RATIO`` times as far from the
    unrounded float64 gradient as the farther of its plain version and the
    plain version computed in float64 between the same rounding points."""
    args, dy = checks.block_case(checks.BLOCK_CASES[case], card, seed=seed)
    got = fu.fused_upsample_backward(*args, dy)
    want = fu.fused_upsample_backward_reference(*args, dy)
    want64 = fu.fused_upsample_backward_reference(*(a.double() for a in args), dy.double())
    exact = fu.fused_upsample_backward_unrounded(*args, dy)
    dist, fails = checks.truth_failures(got, want, want64, exact, checks.K8_TRUTH_RATIO,
                                        floor=checks.K8_TRUTH_FLOOR)
    print(json.dumps({"k8_truth": case, "seed": seed, "float64": dist}))
    assert not fails, fails


def test_renderer_cuda_tensors_never_take_the_plain_version(card):
    """CUDA inputs the renderer's kernels cannot take raise (a wrong dtype);
    the f32 block (``use_bf16=False``) launches its own kernels."""
    with pytest.raises(ValueError, match="dtype"):
        sb.shuffle_blur_forward(torch.zeros(1, 4, 4, 8, dtype=torch.float64, device=card))
    args, dy = checks.f32_block_case(checks.BLOCK_CASES["half_tile"], card)
    before = (fu.launch_count_fwd_f32, fu.launch_count_bwd_f32)
    fu.fused_upsample_forward(*args, use_bf16=False)
    fu.fused_upsample_backward(*args, dy, use_bf16=False)
    torch.cuda.synchronize()
    assert (fu.launch_count_fwd_f32, fu.launch_count_bwd_f32) == (before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="dtype"):
        fu.fused_upsample_forward(args[0].double(), *args[1:], use_bf16=False)


@pytest.mark.parametrize("case", checks.F32_BLOCK_CASES)
def test_f32_upsampler_matches_plain_version(card, case):
    """K7 and K8 at f32 (``use_bf16=False``, the f32 renderer) against their
    f32 plain versions within ``F32_K7_LIMITS`` / ``F32_K8_LIMITS``, one
    launch each, K8 the same bits over two launches; and each output's
    distance from the unrounded float64 result at most ``F32_TRUTH_RATIO``
    times the plain version's, or under ``F32_TRUTH_FLOOR``."""
    args, dy = checks.f32_block_case(checks.BLOCK_CASES[case], card)
    before = (fu.launch_count_fwd_f32, fu.launch_count_bwd_f32)
    got = fu.fused_upsample_forward(*args, use_bf16=False)
    g = fu.fused_upsample_backward(*args, dy, use_bf16=False)
    torch.cuda.synchronize()
    assert (fu.launch_count_fwd_f32, fu.launch_count_bwd_f32) == (before[0] + 1, before[1] + 1)
    again = fu.fused_upsample_backward(*args, dy, use_bf16=False)
    want = fu.fused_upsample_reference(*args, use_bf16=False)
    gw = fu.fused_upsample_backward_reference(*args, dy, use_bf16=False)
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    r7, fails = checks.f32_k7_failures(case, got, want)
    r8, f8 = checks.f32_k8_failures(case, g, gw)
    exact = fu.fused_upsample_reference(*(a.double() for a in args), use_bf16=False)
    t7, ft7 = checks.f32_truth_failures(checks.Image(got), checks.Image(want), checks.Image(exact))
    t8, ft8 = checks.f32_truth_failures(g, gw, fu.fused_upsample_backward_unrounded(*args, dy))
    print(json.dumps({"f32_block": case, "k7": r7, "k8": r8, "k7_truth": t7, "k8_truth": t8}))
    assert not fails + f8 + ft7 + ft8, fails + f8 + ft7 + ft8
    for n, a, c in zip(fu.UpsampleGrads._fields, g, again):
        assert torch.equal(a, c), f"{n}: two launches differ"


def _round32(s, e):
    """f32 round-to-nearest-even of the exact value ``s + e`` (float64
    tensors, ``s`` that value rounded to float64, ``e`` the rest): the f32
    rounding of ``s``, except where ``s`` lies halfway between two f32 values
    and ``e`` says on which side the exact value lies."""
    r = s.float()
    rd = r.double()
    inf = torch.full_like(r, float("inf"))
    o = torch.nextafter(r, torch.where(s > rd, inf, -inf))  # r's neighbour on s's side
    mid = (s != rd) & ((s - rd).abs() * 2 == (o.double() - rd).abs())
    return torch.where(mid & (e > 0), torch.maximum(r, o),
                       torch.where(mid & (e < 0), torch.minimum(r, o), r))


def _add32(p, c):
    """f32 rounding of ``p + c``, float64 ``p`` (an f32 value or an exact
    product of two) and f32 ``c``: one rounding, as an f32 add or a fused
    multiply-add makes (the sum's rest by Knuth's TwoSum)."""
    p, c = p.double(), c.double()
    s = p + c
    bb = s - p
    return _round32(s, (p - (s - bb)) + (c - bb))


def _fma32(a, b, c):
    return _add32(a.double() * b.double(), c)  # f32 x f32 is exact in float64


def _sequential_product(a, w):
    """``a @ w`` as the f32 tile orders it: every output ``fma`` after
    ``fma`` in increasing k from zero; K over 1,040 in chunks of 128 k,
    each such a chain, added in order."""
    K = a.shape[1]
    chunk = 128 if K > 1040 else K
    total = None
    for k0 in range(0, K, chunk):
        acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32, device=a.device)
        for k in range(k0, min(K, k0 + chunk)):
            acc = _fma32(a[:, k : k + 1], w[k : k + 1], acc)
        total = acc if total is None else _add32(total, acc)
    return total


def _sliced_contraction(a, b):
    """``(a^T b, b.sum(0))`` in K8's f32 order: slices of 1,024 rows, each
    in stages of 16 rows summed from zero and added to the slice's sum
    (rows past the end zero), the slices joined pairwise as in a binary
    counter."""
    rows, M = a.shape
    S = -(-rows // 1024)
    ones = torch.ones(rows, 1, dtype=torch.float32, device=a.device)
    a3 = torch.zeros(S * 1024, M + 1, dtype=torch.float32, device=a.device)
    b3 = torch.zeros(S * 1024, b.shape[1], dtype=torch.float32, device=a.device)
    a3[:rows] = torch.cat([a, ones], 1)
    b3[:rows] = b
    a3, b3 = a3.view(S, 1024, M + 1), b3.view(S, 1024, -1)
    acc = torch.zeros(S, M + 1, b.shape[1], dtype=torch.float32, device=a.device)
    for r0 in range(0, 1024, 16):
        stage = torch.zeros_like(acc)
        for r in range(r0, r0 + 16):
            stage = _fma32(a3[:, r, :, None], b3[:, r, None, :], stage)
        acc = _add32(acc, stage)
    stack = []
    for s in range(S):
        v, t = acc[s], s
        while t & 1:
            v, t = _add32(stack.pop(), v), t >> 1
        stack.append(v)
    v = stack.pop()
    while stack:
        v = _add32(stack.pop(), v)
    return v[:M], v[M]


def _gamma(n):
    """Higham's gamma_n for f32: the relative bound of n roundings."""
    u = 2.0**-24
    return n * u / (1 - n * u)


# (M, N, K): ragged rows and columns, a K tail, 4-byte and 16-byte weight
# copies, K in chunks (over 1,040)
F32_PRODUCT_CASES = {"ragged_tail": (300, 129, 37), "wide_tail": (200, 516, 258),
                     "exact": (1000, 64, 16), "one_k": (5, 3, 1), "chunked": (70, 40, 1300)}
# (rows, M, N): slices, a short last slice and stage, 4-byte and 16-byte copies
F32_CONTRACT_CASES = {"ragged": (2500, 129, 33), "aligned": (3000, 64, 128),
                      "short": (17, 4, 8)}


@pytest.mark.parametrize("case", F32_PRODUCT_CASES)
def test_f32_product_tile(card, case):
    """The f32 kernels' product tile alone, in every tile shape: each output
    the bits of fused multiply-adds in increasing k from zero (K over 1,040
    in chunks of 128 added in order; emulated exactly in float64), and
    within gamma_K sum_k |a_k w_k| of the float64 product (at most K
    roundings of f32)."""
    M, N, K = F32_PRODUCT_CASES[case]
    gen = torch.Generator().manual_seed(M + N + K)
    a = torch.randn(M, K, generator=gen).to(card)
    w = torch.randn(K, N, generator=gen).to(card)
    want = _sequential_product(a, w)
    exact = a.double() @ w.double()
    scale = a.double().abs() @ w.double().abs()
    for shape in range(-1, fu.f32_shapes(False)):
        got = fu.f32_product(a, w, shape)
        torch.cuda.synchronize()
        err = float(((got.double() - exact).abs() / scale).max())
        print(json.dumps({"f32_product": case, "shape": shape, "err_over_abs_sum": err}))
        assert torch.equal(got, want), f"shape {shape}: not the sequential order's bits"
        assert err <= _gamma(K), (shape, err)


@pytest.mark.parametrize("case", F32_CONTRACT_CASES)
def test_f32_contraction_tile(card, case):
    """K8's f32 weight-gradient contraction alone, in every tile shape: the
    bits of its slice, stage and pairwise order (emulated exactly in
    float64), and within gamma_n of the float64 sums, n the most roundings
    a term meets (16 in a stage, 64 stages, the slices' pairwise sums)."""
    rows, M, N = F32_CONTRACT_CASES[case]
    gen = torch.Generator().manual_seed(rows + M + N)
    a = torch.randn(rows, M, generator=gen).to(card)
    b = torch.randn(rows, N, generator=gen).to(card)
    want_w, want_b = _sliced_contraction(a, b)
    n = 16 + 64 + (-(-rows // 1024)).bit_length() + 1
    for shape in range(-1, fu.f32_shapes(True)):
        dw, db = fu.f32_contract(a, b, shape)
        torch.cuda.synchronize()
        errs = [float(((got.double() - x).abs() / s).max()) for got, x, s in (
            (dw, a.double().t() @ b.double(), a.double().abs().t() @ b.double().abs()),
            (db, b.double().sum(0), b.double().abs().sum(0)))]
        print(json.dumps({"f32_contraction": case, "shape": shape, "err_over_abs_sum": errs}))
        assert torch.equal(dw, want_w) and torch.equal(db, want_b), f"shape {shape}: other bits"
        assert max(errs) <= _gamma(n), (shape, errs)


def test_f32_upsampler_wide_block(card):
    """K7 and K8 at f32 at wide widths (F = 776, F3 = 388: a tile that held
    8 pixels' whole backward chain in shared memory would need 248 KB), at
    small P: each output's distance from the unrounded float64 result at
    most ``F32_TRUTH_RATIO`` times the f32 plain version's, or under
    ``F32_TRUTH_FLOOR``; one launch each; two launches the same bits."""
    args, dy = checks.f32_block_case((1, 4, 6, 776, 388), card)
    before = (fu.launch_count_fwd_f32, fu.launch_count_bwd_f32)
    got = fu.fused_upsample_forward(*args, use_bf16=False)
    g = fu.fused_upsample_backward(*args, dy, use_bf16=False)
    torch.cuda.synchronize()
    assert (fu.launch_count_fwd_f32, fu.launch_count_bwd_f32) == (before[0] + 1, before[1] + 1)
    again = fu.fused_upsample_backward(*args, dy, use_bf16=False)
    want = fu.fused_upsample_reference(*args, use_bf16=False)
    gw = fu.fused_upsample_backward_reference(*args, dy, use_bf16=False)
    exact = fu.fused_upsample_reference(*(a.double() for a in args), use_bf16=False)
    t7, ft7 = checks.f32_truth_failures(checks.Image(got), checks.Image(want), checks.Image(exact))
    t8, ft8 = checks.f32_truth_failures(g, gw, fu.fused_upsample_backward_unrounded(*args, dy))
    print(json.dumps({"f32_wide_block": [1, 4, 6, 776, 388], "k7_truth": t7, "k8_truth": t8}))
    assert got.shape == want.shape and not ft7 + ft8, ft7 + ft8
    for n, a, c in zip(fu.UpsampleGrads._fields, g, again):
        assert torch.equal(a, c), f"{n}: two launches differ"


@pytest.mark.parametrize("mode", ["phase", "naive", "unfolded", "unfolded_pallas", "rgb_nhwc",
                                  "fused_f32"])
def test_renderer_modes_on_card(card, mode):
    """The small model's render in each renderer mode without a bf16 kernel
    of its own, in its dtype (the f32 renderer for ``fused_f32``), against
    ``phase_gm`` in the same dtype on the same weights: the eager modes
    within 5e-3 (``chip_smoke.MODE_IMAGE_ATOL``), launching K5 per block
    and pass only ``unfolded_pallas``, K7 at f32 only ``fused_f32``."""
    flags = {"phase": dict(shuffle_mode="phase"), "naive": dict(shuffle_mode="naive"),
             "unfolded": dict(renderer_fold_feat=False),
             "unfolded_pallas": dict(shuffle_mode="pallas", renderer_fold_feat=False),
             "rgb_nhwc": dict(renderer_rgb_cf=False), "fused_f32": dict(shuffle_mode="fused")}
    rdt = "float32" if mode == "fused_f32" else "bfloat16"
    base = dataclasses.replace(small_test_config(), compute_dtype="bfloat16",
                               renderer_dtype=rdt, use_pallas=True)
    R, T, K = (torch.from_numpy(a).to(card) for a in lookat_camera(10, -5, 12.0, base.featmap_size))
    args = (pixel_grid(base.featmap_size, device=card)[None],
            0.1 * torch.ones(1, base.shape_code_dims, device=card),
            0.1 * torch.ones(1, base.appea_code_dims, device=card),
            torch.tensor([[0.2, -0.3]], device=card), R, T, K)
    with torch.no_grad():
        ref = GazeNeRF(base).eval()(*args)["coarse_dict"]["merge_img"].float()
        before = (sb.launch_count_fwd, fu.launch_count_fwd_f32)
        img = GazeNeRF(dataclasses.replace(base, **flags[mode])).eval()(*args)
        img = img["coarse_dict"]["merge_img"].float()
    n = 4 * base.n_upsample_blocks
    want = {"unfolded_pallas": (n, 0), "fused_f32": (0, n)}.get(mode, (0, 0))
    assert (sb.launch_count_fwd - before[0], fu.launch_count_fwd_f32 - before[1]) == want
    assert torch.isfinite(img).all()
    torch.testing.assert_close(img, ref, atol=5e-3, rtol=0)


@pytest.mark.parametrize("mode", ["pallas", "fused"])
def test_render_mode_on_card_goes_through_its_kernel(card, mode):
    """The small bf16 model on the card in a kernel mode: one launch of K5
    (``pallas``) or K7 (``fused``) per upsample block and renderer pass
    (four passes per forward), and the image within the bf16 image bound
    (3e-2) of the same render with the plain versions."""
    cfg = dataclasses.replace(small_test_config(), compute_dtype="bfloat16",
                              renderer_dtype="bfloat16", use_pallas=True, shuffle_mode=mode)
    model = GazeNeRF(cfg).eval()
    R, T, K = (torch.from_numpy(a).to(card) for a in lookat_camera(10, -5, 12.0, cfg.featmap_size))
    args = (pixel_grid(cfg.featmap_size, device=card)[None],
            0.1 * torch.ones(1, cfg.shape_code_dims, device=card),
            0.1 * torch.ones(1, cfg.appea_code_dims, device=card),
            torch.tensor([[0.2, -0.3]], device=card), R, T, K)
    before = _counts()
    with torch.no_grad():
        img = model(*args)["coarse_dict"]["merge_img"].float()
    n = 4 * cfg.n_upsample_blocks
    want = (n, 0, 0, 0) if mode == "pallas" else (0, 0, n, 0)
    assert tuple(a - b for a, b in zip(_counts(), before)) == want
    with checks.plain_versions(), torch.no_grad():
        plain = model(*args)["coarse_dict"]["merge_img"].float()
    assert torch.isfinite(img).all()
    torch.testing.assert_close(img, plain, atol=3e-2, rtol=0)


# ---------------------------------------------------------------------------
# the dual-branch kernels: the forward (K3) and the stash-reading backward (K4)


def _dual_counts():
    return ff.launch_count, ffb.launch_count, ff2.launch_count, ffb2.launch_count


@pytest.mark.parametrize("case", list(checks.DUAL_CASES))
def test_fused_dual_matches_plain_version(card, case):
    """K3 with the stash against its plain version: each branch's outputs
    within ``K3_LIMITS``, the stash within ``K3_STASH_LIMITS``; without the
    stash each branch equals K1 on that branch to the bit
    (``K3_VS_K1_MAX_ABS_ERR``).  One launch per call."""
    args, _ = checks.dual_case(*checks.DUAL_CASES[case], card)
    with torch.no_grad():
        before = _dual_counts()
        got, acts = ff2.fused_dual_forward(*args, stash=True)
        torch.cuda.synchronize()
        assert _dual_counts() == (*before[:2], before[2] + 1, before[3])
        want, want_acts = ff2.fused_dual_reference(*args, stash=True)
        readings, fails = checks.k3_failures(case, got, want)
        stash_readings, stash_fails = checks.k3_stash_failures(case, acts, want_acts)
        print(json.dumps({"k3_case": case, "readings": readings, "stash": stash_readings}))
        assert not fails + stash_fails, fails + stash_fails
        del acts, want_acts
        plain = ff2.fused_dual_forward(*args)
        for i, g in enumerate(plain):
            single = ff.fused_field_forward(*args[:3], *(t[i] for t in args[3:6]),
                                            ff2.branch_operands(args[6], i))
            for n, a, b in zip(NAMES, g, single):
                err = float((a - b).abs().max())
                assert err <= checks.K3_VS_K1_MAX_ABS_ERR, (i, n, err)
            for n, a, b in zip(NAMES, g, got[i]):  # the stash changes no output
                assert torch.equal(a, b), (i, n)


@pytest.fixture(scope="module")
def dual_backward_cases():
    """Per dual case: K3's inputs, cotangents and stash, made once."""
    out = {}

    def get(case, card, seed=0):
        key = (case, seed)
        if key not in out:
            out.clear()  # one stash on the card at a time
            args, cot = checks.dual_case(*checks.DUAL_CASES[case], card, seed=seed)
            with torch.no_grad():
                _, acts = ff2.fused_dual_forward(*args, stash=True)
            out[key] = (args, cot, acts)
        return out[key]

    return get


@pytest.mark.parametrize("case", list(checks.DUAL_CASES))
def test_fused_dual_backward_matches_plain_version(card, dual_backward_cases, case):
    """K4 against its plain version on K3's stash, every output within its
    case's limits (``kernels/checks.py``); two launches give the same bits
    (no atomics: the per-CTA sums and the weight-gradient GEMM's partials are
    added in a fixed order)."""
    args, cot, acts = dual_backward_cases(case, card)
    with torch.no_grad():
        before = _dual_counts()
        got = ffb2.fused_dual_backward(*args, *cot, acts)
        torch.cuda.synchronize()
        assert _dual_counts() == (*before[:3], before[3] + 1)
        want = ffb2.fused_dual_backward_reference(*args, *cot, acts)
        again = ffb2.fused_dual_backward(*args, *cot, acts)
    readings, fails = checks.k4_failures(case, got, want)
    print(json.dumps({"k4_case": case, "readings": readings}))
    assert not fails, fails
    for n, a, c in zip(ffb2.DualGrads._fields, got, again):
        assert torch.equal(a, c), f"{n}: two launches differ"


@pytest.mark.parametrize("case", list(checks.DUAL_CASES))
def test_fused_dual_backward_matches_k2_per_branch(card, dual_backward_cases, case):
    """K4 against K2 run on each branch, the shared cotangents summed: the
    two share the tile body, K4 reads K3's stash where K2 recomputes, so
    they differ by the density head's and the branches' f32 summation
    orders (``K4_VS_K2_LIMITS``)."""
    args, cot, acts = dual_backward_cases(case, card)
    with torch.no_grad():
        got = ffb2.fused_dual_backward(*args, *cot, acts)
        per = [ffb.fused_field_backward(*args[:3], *(t[i] for t in args[3:6]),
                                        ff2.branch_operands(args[6], i), *cot[i])
               for i in range(2)]
        want = ffb2.sum_branches(per)
    readings, fails = checks.k4_vs_k2_failures(case, got, want)
    print(json.dumps({"k4_vs_k2": case, "readings": readings}))
    assert not fails, fails
    for n, a, b in zip(ffb2.DualGrads._fields, got, want):  # one GEMM, the same chunks
        if n not in ("dembed", "dzvals", "dzdists"):
            assert torch.equal(a, b), f"{n}: K4 and K2 differ"


@pytest.mark.parametrize("case, seed", [("narrow", 0), ("narrow", 1), ("training", 0)])
def test_fused_dual_backward_as_close_to_unrounded_as_plain(card, dual_backward_cases, case,
                                                            seed):
    """Per output, K4 lies at most ``K4_TRUTH_RATIO`` times as far from the
    unrounded float64 gradient as the farther of its plain version and the
    plain version computed in float64 on the same stash."""
    args, cot, acts = dual_backward_cases(case, card, seed)
    with torch.no_grad():
        got = ffb2.fused_dual_backward(*args, *cot, acts)
        want = ffb2.fused_dual_backward_reference(*args, *cot, acts)
        want64 = ffb2.fused_dual_backward_reference(*args, *cot, acts, dtype=torch.float64)
    exact = ffb2.fused_dual_backward_unrounded(*args, *cot)
    dist, fails = checks.truth_failures(got, want, want64, exact, checks.K4_TRUTH_RATIO,
                                        checks.K4_TRUTH_EXEMPT)
    print(json.dumps({"k4_truth": case, "seed": seed, "float64": dist}))
    assert not fails, fails


def test_dual_cuda_tensors_never_take_the_plain_version(card):
    """CUDA inputs the dual kernels cannot take raise."""
    args, cot = checks.dual_case(64, 8, 16, card)
    bad = (args[0][:, :, :7].contiguous(), args[1][:, :, :7].contiguous(),
           args[2][:, :, :7].contiguous(), *args[3:])  # 7 samples do not tile 128 points
    with pytest.raises(ValueError, match="whole rays"):
        ff2.fused_dual_forward(*bad)
    with torch.no_grad():
        _, acts = ff2.fused_dual_forward(*args, stash=True)
    with pytest.raises(ValueError, match="stash"):
        ffb2.fused_dual_backward(*args, *cot, (acts[0], acts[1][:9]))


def _small_dual_model(stash):
    return dataclasses.replace(small_test_config(), compute_dtype="bfloat16",
                               renderer_dtype="bfloat16", use_pallas=True,
                               pallas_dual_branch=True, pallas_stash_acts=stash)


def test_dual_render_on_card_goes_through_k3(card):
    """The small bf16 model on the dual-branch path: one K3 launch per
    render and no K1; the image within the bf16 image bound (3e-2) of the
    same render with the plain versions, and equal to the single-branch
    render's (K3 without the stash is K1 per branch, bit for bit)."""
    cfg = _small_dual_model(True)
    model = GazeNeRF(cfg).eval()
    R, T, K = (torch.from_numpy(a).to(card) for a in lookat_camera(10, -5, 12.0, cfg.featmap_size))
    args = (pixel_grid(cfg.featmap_size, device=card)[None],
            0.1 * torch.ones(1, cfg.shape_code_dims, device=card),
            0.1 * torch.ones(1, cfg.appea_code_dims, device=card),
            torch.tensor([[0.2, -0.3]], device=card), R, T, K)
    before = _dual_counts()
    with torch.no_grad():
        img = model(*args)["coarse_dict"]["merge_img"].float()
    assert tuple(a - b for a, b in zip(_dual_counts(), before)) == (0, 0, 1, 0)
    with checks.plain_versions(), torch.no_grad():
        plain = model(*args)["coarse_dict"]["merge_img"].float()
    single = GazeNeRF(dataclasses.replace(cfg, pallas_dual_branch=False,
                                          pallas_stash_acts=False)).eval()
    single.load_state_dict(model.state_dict())
    with torch.no_grad():
        img1 = single(*args)["coarse_dict"]["merge_img"].float()
    assert torch.isfinite(img).all()
    torch.testing.assert_close(img, plain, atol=3e-2, rtol=0)
    torch.testing.assert_close(img, img1, atol=0, rtol=0)


@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_dual_training_step_on_card(card, stash):
    """One step of the small bf16 model on the dual-branch path: with the
    stash one K3 and one K4 launch, without it one K3 and two K2 (one per
    branch), never K1; finite gradients, and the step's losses with the
    plain versions within 1e-3 (relative)."""
    model = _small_dual_model(stash)
    trainer = Trainer(Config(model=model, loss=LossConfig(use_vgg_loss=False)),
                      train_len=4, steps_per_epoch=1)
    gen = torch.Generator().manual_seed(0)
    size, fs = model.pred_img_size, model.featmap_size
    inmat = torch.linalg.inv(torch.from_numpy(base_inv_inmat(fs)))
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
    before = _dual_counts()
    losses = trainer.train_step(batch, t_rand=t_rand, update=False)
    torch.cuda.synchronize()
    used = tuple(a - b for a, b in zip(_dual_counts(), before))
    assert used == ((0, 0, 1, 1) if stash else (0, 2, 1, 0))
    for g in trainer.optimizer.param_groups:
        for p in g["params"]:
            assert p.grad is not None and torch.isfinite(p.grad).all(), g["name"]
    with checks.plain_versions():
        plain = trainer.train_step(batch, t_rand=t_rand, update=False)
    for k, v in losses.items():
        assert torch.isfinite(v), k
        torch.testing.assert_close(v, plain[k], rtol=1e-3, atol=1e-6, msg=k)


@pytest.mark.parametrize("case", list(checks.DW_CASES))
def test_field_dw_matches_plain_version(card, case):
    """The backwards' weight-gradient GEMM, chunk by chunk as they run it
    (one chunk across the batch boundary, a partial last one), against the
    chunked plain contraction of the same bf16 operands: per product within
    ``DW_MAX_REL_ERR`` of its largest value; two runs give the same bits."""
    xs, ds, plan = checks.dw_case(*checks.DW_CASES[case], card)
    assert any(c.first_batch != c.last_batch for c in plan) and plan[-1].tiles < plan[0].tiles

    def run():
        outs = None
        for c in plan:
            rows = slice(c.point0, c.point0 + c.points)
            outs = field_dw.weight_grad([x[rows] for x in xs], [d[rows] for d in ds], outs)
        return outs

    before = field_dw.launch_count
    got = run()
    torch.cuda.synchronize()
    assert field_dw.launch_count == before + len(plan)
    again = run()
    for j, (x, d, g, a) in enumerate(zip(xs, ds, got, again)):
        want = field_dw.chunked_weight_grad_reference(x, d, plan)
        err, scale = float((g - want).abs().max()), float(want.abs().max())
        print(f"dW {case} product {j} {tuple(g.shape)}: ratio {err / scale:.3e}")
        assert torch.isfinite(g).all() and err <= checks.DW_MAX_REL_ERR * scale, (j, err, scale)
        assert torch.equal(g, a), f"product {j}: two runs differ"


# ---------------------------------------------------------------------------
# rays longer than one tile (S = 128, 192, 256): K1-K4


@pytest.mark.parametrize("case", list(checks.DEEP_CASES))
def test_deep_forward_matches_plain_version(card, case):
    """K1 where a ray spans the CTA's tiles (S = 192, 256) or fills one (S =
    128): every output within ``checks.DEEP_K1_LIMITS``; the same bits over
    two launches."""
    args, _ = checks.field_case(*checks.DEEP_CASES[case], card)
    with torch.no_grad():
        got = ff.fused_field_forward(*args)
        again = ff.fused_field_forward(*args)
        want = ff.fused_field_reference(*args)
    readings, fails = checks.limit_failures(checks.Outputs(*got), checks.Outputs(*want),
                                            checks.DEEP_K1_LIMITS[case])
    print(json.dumps({"k1_deep": case, "readings": readings}))
    assert not fails, fails
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.fixture(scope="module")
def deep_backward():
    """Per deep case, K2's gradient, its plain version's (summing the weight
    gradients in the kernel's chunks) and the inputs: shared by the tests
    below."""
    cache = {}

    def get(case):
        if case not in cache:
            args, cot = checks.field_case(*checks.DEEP_CASES[case], torch.device("cuda"))
            with torch.no_grad():
                got = ffb.fused_field_backward(*args, *cot)
                want = ffb.fused_field_backward_reference(*args, *cot,
                                                          chunks=checks.deep_chunks(args))
            cache[case] = (args, cot, got, want)
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(checks.DEEP_CASES))
def test_deep_backward_matches_plain_version(card, deep_backward, case):
    """K2 where a ray spans 2 to 4 tiles (its two sweeps: the tiles'
    forward parts, the ray's integration backward, the tiles' backward):
    every output within ``checks.DEEP_K2_LIMITS``; the same bits over two
    launches."""
    args, cot, got, want = deep_backward(case)
    readings, fails = checks.limit_failures(got, want, checks.DEEP_K2_LIMITS[case])
    print(json.dumps({"k2_deep": case, "readings": readings,
                      "density_mask_flips": checks.density_mask_flips(got, want)}))
    assert not fails, fails
    with torch.no_grad():
        again = ffb.fused_field_backward(*args, *cot)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", checks.DEEP_K2_TRUTH_CASES)
def test_deep_backward_as_close_to_unrounded_as_plain(card, deep_backward, case):
    """K2's rule against the unrounded float64 gradient in the deep cases."""
    args, cot, got, want = deep_backward(case)
    with torch.no_grad():
        want64 = ffb.fused_field_backward_reference(*args, *cot, dtype=torch.float64,
                                                    chunks=checks.deep_chunks(args))
    exact = ffb.fused_field_backward_unrounded(*args, *cot)
    dist, fails = checks.truth_failures(got, want, want64, exact, checks.K2_TRUTH_RATIO,
                                        checks.K2_TRUTH_EXEMPT)
    print(json.dumps({"k2_deep_truth": case, "float64": dist}))
    assert not fails, fails


@pytest.mark.parametrize("case", checks.DEEP_STASH_CASES)
def test_deep_stash_modes(card, case):
    """K1 writing the stash at S = 128 and 256: its outputs K1's to the bit,
    the stash within ``checks.K1_STASH_LIMITS`` of the plain version's.  K2
    reading it, with and without ``dens_vpu``: within
    ``checks.DEEP_K2_STASH_LIMITS`` of its plain version on the same stash,
    their density masks equal at every point, and K2 recomputing's bits
    (with ``dens_vpu`` all but dWd)."""
    args, cot = checks.field_case(*checks.DEEP_CASES[case], card)
    chunks = checks.deep_chunks(args)
    fails, out = [], {}
    with torch.no_grad():
        outs, acts = ff.fused_field_forward(*args, stash=True)
        assert all(torch.equal(a, b) for a, b in zip(outs, ff.fused_field_forward(*args)))
        _, want_acts = ff.fused_field_reference(*args, stash=True)
        out["k1_stash"], f = checks.k1_stash_failures(acts, want_acts)
        fails += f
        recompute = ffb.fused_field_backward(*args, *cot)
        for dens_vpu in (False, True):
            got = ffb.fused_field_backward(*args, *cot, stash=acts, dens_vpu=dens_vpu)
            want = ffb.fused_field_backward_reference(*args, *cot, stash=acts, chunks=chunks,
                                                      dens_vpu=dens_vpu)
            out[f"k2_stash dens_vpu={dens_vpu}"], f = checks.limit_failures(
                got, want, checks.DEEP_K2_STASH_LIMITS[case])
            fails += f
            assert checks.density_mask_flips(got, want) == 0
            differ = [n for n, a, b in zip(got._fields, got, recompute) if not torch.equal(a, b)]
            assert differ == (["dWd"] if dens_vpu else []), differ
    print(json.dumps({"deep_stash": case, "readings": out}))
    assert not fails, fails


@pytest.mark.parametrize("form", list(checks.STASH_FORMS))
@pytest.mark.parametrize("case", ["narrow", "deep256"])
def test_stash_forms_match_plain_version(card, case, form):
    """The stash's other forms (``checks.STASH_FORMS``: every second and
    every fourth trunk layer, the int8 stash) in the narrow case and at S =
    256.  K1 writing the form: its outputs K1's without the stash, a kept
    bf16 slot the same slot of K1's bf16 stash of every layer, the int8
    codes and scales the plain quantizer's over that stash, each to the bit.
    K2 reading it, with and without ``dens_vpu``: a partial stash gives K2
    reading the full stash to the bit and lies within K2's recompute limits
    of its plain version; the int8 stash lies within the bf16 stash's limits
    of its plain version reading the same codes and, in the narrow case,
    within ``checks.K2_STASH_TRUTH_RATIO`` of it from the unrounded float64
    gradient (``checks.k1_form_failures``, ``checks.k2_form_failures``)."""
    shape = checks.DEEP_CASES[case] if case in checks.DEEP_CASES else checks.K2_CASES[case]
    args, cot = checks.field_case(*shape, card)
    chunks = checks.deep_chunks(args) if case in checks.DEEP_CASES else None
    f = checks.STASH_FORMS[form]
    out = {}
    with torch.no_grad():
        _, full = ff.fused_field_forward(*args, stash=True)
        before = ff.launch_count
        (_, acts), out["k1"], fails = checks.k1_form_failures(args, f, full)
        assert ff.launch_count == before + 2  # the form's launch and K1 without the stash
        for dens_vpu in (False, True):
            full_grads = ffb.fused_field_backward(*args, *cot, stash=full, dens_vpu=dens_vpu)
            before = ffb.launch_count
            _, line, f2 = checks.k2_form_failures(case, args, cot, f, acts, full_grads, dens_vpu,
                                                  chunks=chunks, truth=case == "narrow")
            assert ffb.launch_count == before + 1
            out[f"k2 dens_vpu={dens_vpu}"] = line
            fails += [f"K2 dens_vpu={dens_vpu}: {x}" for x in f2]
    print(json.dumps({"stash_form": form, "case": case, "readings": out}))
    assert not fails, fails


@pytest.mark.parametrize("form", list(checks.STASH_FORMS))
@pytest.mark.parametrize("case", ["narrow", "deep256"])
def test_stash_forms_given_the_points_match(card, case, form):
    """The stash's forms with the sample points encoded in the tiles
    (``embed_in_kernel``), in the narrow case and at S = 256: K1 given the
    points writing the form equals K1 given the card's encoding writing it,
    outputs and slots to the bit; K2 given the points reading it, with and
    without ``dens_vpu``, equals K2 given that encoding in every output but
    the points' cotangent, a partial stash gives K2 reading the full stash
    to the bit, and each lies within its limits of its plain version
    (``checks.points_form_failures``)."""
    shape = checks.DEEP_CASES[case] if case in checks.DEEP_CASES else checks.K2_CASES[case]
    args, cot = checks.points_case(*shape, card)
    chunks = checks.deep_chunks(args) if case in checks.DEEP_CASES else None
    before = ff.launch_count, ffb.launch_count
    line, fails = checks.points_form_failures(case, args, cot, checks.STASH_FORMS[form],
                                              chunks=chunks)
    int8 = checks.STASH_FORMS[form].dtype == "int8"
    # K1: the form given the points and given the encoding, and the full stash
    assert ff.launch_count - before[0] == (2 if int8 else 3)
    # K2: given the points and the encoding, and reading the full stash, per dens_vpu
    assert ffb.launch_count - before[1] == (4 if int8 else 6)
    print(json.dumps({"stash_form_points": form, "case": case, "readings": line}))
    assert not fails, fails


def test_stash_form_that_keeps_no_layer(card):
    """A stash of every k-th trunk layer with k >= 9 keeps none (the JAX
    ``stash_layout`` is empty): K1 writes no stash, its outputs K1's, and
    ``FusedField`` takes the recompute, as JAX's custom VJP does with an
    empty stash; K2 refuses an empty stash.  The int8 stash of every other
    layer raises."""
    args, cot = checks.field_case(*checks.K2_CASES["narrow"], card)
    with torch.no_grad():
        out, acts = ff.fused_field_forward(*args, stash=ff.StashForm(9))
        assert acts == ()
        assert all(torch.equal(a, b) for a, b in zip(out, ff.fused_field_forward(*args)))
        with pytest.raises(ValueError, match="keeps no layer"):
            ffb.fused_field_backward(*args, *cot, stash=(), stash_form=ff.StashForm(9))
        with pytest.raises(ValueError, match="stash_every=1"):
            ff.fused_field_forward(*args, stash=ff.StashForm(2, "int8"))


def test_deep_dual_kernels(card):
    """K3 and K4 at S = 256: K3 with and without the stash K1 on each branch
    to the bit, within ``checks.DEEP_K3_LIMITS`` of its plain version per
    branch and its stash within ``checks.K3_STASH_LIMITS`` (training case);
    K4 within ``checks.DEEP_K4_LIMITS`` of its plain version, and equal to
    K2 reading each branch's stash (the weight gradients to the bit, the
    per-point cotangents as ``checks.K4_VS_K2_LIMITS``)."""
    case = checks.DEEP_DUAL_CASE
    dargs, (g_face, g_eye) = checks.dual_case(*checks.DEEP_CASES[case], card)
    fails, out = [], {}
    with torch.no_grad():
        plain_outs = ff2.fused_dual_forward(*dargs)
        outs, acts = ff2.fused_dual_forward(*dargs, stash=True)
        want_outs, want_acts = ff2.fused_dual_reference(*dargs, stash=True)
        per = []
        for i, g in enumerate((g_face, g_eye)):
            branch = (*dargs[:3], *(t[i] for t in dargs[3:6]), ff2.branch_operands(dargs[6], i))
            single = ff.fused_field_forward(*branch)
            for n, a, b, c in zip(NAMES, plain_outs[i], single, outs[i]):
                assert torch.equal(a, b), (i, n, "K3 vs K1")
                assert torch.equal(a, c), (i, n, "the stash changed an output")
            per.append(ffb.fused_field_backward(*branch, *g, stash=acts[i]))
        out["k3"], f = checks.deep_k3_failures(outs, want_outs)
        fails += f
        out["k3_stash"], f = checks.k3_stash_failures("training", acts, want_acts)
        fails += f
        got = ffb2.fused_dual_backward(*dargs, g_face, g_eye, acts)
        want = ffb2.fused_dual_backward_reference(*dargs, g_face, g_eye, acts)
        out["k4"], f = checks.limit_failures(got, want, checks.DEEP_K4_LIMITS)
        fails += f
        out["k4_vs_k2"], f = checks.k4_vs_k2_failures("training", got, ffb2.sum_branches(per))
        fails += f
        shared = ("dembed", "dzvals", "dzdists")
        differ = [n for n, a, b in zip(got._fields, got, ffb2.sum_branches(per))
                  if n not in shared and not torch.equal(a, b)]
        assert not differ, differ
    print(json.dumps({"deep_dual": case, "readings": out}))
    assert not fails, fails


@pytest.mark.parametrize("stash", [False, True], ids=["recompute", "stash"])
def test_deep_training_step_on_card(card, stash):
    """One step of the small bf16 model at 128 samples a ray in 4 chunks of
    64 rays, with the fine pass at 128 + 64 = 192 samples: per chunk two K1
    in the forward, two more in the backward's recompute of the chunk, and
    two K2 (reading the recomputed stash with the stash); the fine pass one
    K1 and no K2 (no loss reads it).  Finite gradients; the losses within
    1e-3 (relative) of the same step with the plain versions."""
    model = dataclasses.replace(small_test_config(), compute_dtype="bfloat16",
                                renderer_dtype="bfloat16", use_pallas=True,
                                num_sample_coarse=128, num_sample_fine=64, hier_sampling=True,
                                ray_chunk=64, pallas_stash_acts=stash, pallas_dens_vpu=stash)
    trainer = Trainer(Config(model=model, loss=LossConfig(use_vgg_loss=False)),
                      train_len=4, steps_per_epoch=1)  # the card: no device given
    gen = torch.Generator().manual_seed(0)
    size, fs = model.pred_img_size, model.featmap_size
    inmat = torch.linalg.inv(torch.from_numpy(base_inv_inmat(fs)))
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
    chunks = model.num_rays // model.ray_chunk
    used = (ff.launch_count - before[0], ffb.launch_count - before[1])
    assert used == (2 * chunks + 2 * chunks + 1, 2 * chunks)
    for g in trainer.optimizer.param_groups:
        for p in g["params"]:
            assert p.grad is None or torch.isfinite(p.grad).all(), g["name"]
    with checks.plain_versions():
        plain = trainer.train_step(batch, t_rand=t_rand, update=False)
    for k, v in losses.items():
        assert torch.isfinite(v), k
        torch.testing.assert_close(v, plain[k], rtol=1e-3, atol=1e-6, msg=k)


@pytest.mark.parametrize("name", checks.jpeg_fixture_names())
def test_jpeg_fixture_on_card_is_cv2_and_plain(card, name):
    """Each committed JPEG fixture decoded on the card (the native entropy
    decoder and one ``jpeg_pixels`` launch) equals ``cv2.imread``'s
    committed pixels and the CPU's plain path, bit for bit."""
    from gazenerf_tpu_torch.kernels import jpeg as kj

    before = kj.launch_count
    fails = checks.jpeg_fixture_failures(name, card)
    torch.cuda.synchronize()
    assert kj.launch_count == before + 1
    assert not fails, fails


@pytest.mark.parametrize("name", sorted(checks.JPEG_STRIP_REPEATS))
def test_jpeg_stacked_strip_on_card(card, name):
    """A full-width strip stacked to 6000 x 320 or 6000 x 400 rows: the
    native decoder's coefficients equal the plain decoder's for every
    restart segment, and the kernel's frame the plain pixel stage's on the
    card, to the bit."""
    from gazenerf_tpu_torch.kernels import jpeg as kj
    from gazenerf_tpu_torch.utils import jpeg as J

    strip, frame = checks.jpeg_stacked_frame(name, 50 if "420" in name else 40)
    hdr = J.parse_header(frame)
    host = torch.empty((hdr.n_blocks, 64), dtype=torch.int16, pin_memory=True)
    assert kj.entropy_decode(frame, hdr, host) == 0
    fails = checks.jpeg_coefficient_failures(strip, frame, host)
    assert not fails, fails
    coef = host.to(card)
    got = kj.jpeg_pixels(coef, hdr)
    want = J.pixels_reference(coef, hdr)
    torch.cuda.synchronize()
    assert got.shape == (hdr.height, 6000, 3) and torch.equal(got, want)
