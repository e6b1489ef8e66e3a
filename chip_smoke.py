#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0] [--requests 4] [--steps 5]

Phases (each raises on failure, so any failed phase exits non-zero):

1. device: the card's name and power limit; TF32 off for matmul and cuDNN;
2. build: compile every kernel (the render's and the training step's) with
   ``nvcc``, all at once;
3. kernels: the field forward (K1) against its plain PyTorch version at the
   render's shapes; the field backward (K2) against its plain version in a
   narrow case (hidden 64) and at the training step's shape, where it is also
   held against the unrounded float64 gradient; each timed (CUDA events)
   beside its bound.  The limits are in ``kernels/checks.py``;
4. serving: a full-width bf16 ``ViewerApp`` with seeded random weights
   answers ``--requests`` render requests (512x512 PNGs) with launch counts
   read around them; one request is rendered again with the plain version
   in place of the kernel and the two images compared;
5. breakdown: where a request's time goes (host-clock parts, device time
   by kernel under ``torch.profiler``), and the renderer's share: the
   viewer's one pass against the model forward's four;
6. training: a full-width bf16 ``Trainer`` (B=2, 512x512, the default loss
   stack) takes 2 warm-up and ``--steps`` timed steps on a seeded synthetic
   batch, with launch counts read around the timed steps; one step's
   gradients with the kernels are held against the same step with the plain
   versions; then where a step's time goes.

Prints ``serving``, ``training`` and ``kernels`` JSON lines, the
``nvidia-smi`` line and, last, the device JSON line.  Exits non-zero without
a result when no CUDA card is present.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# whole image with the kernel vs with its plain version: the bf16 image
# bound of the JAX package's fused-vs-XLA model test
IMAGE_ATOL = 3e-2
# one training step's gradients, kernels vs plain versions, relative L2 per
# parameter group; readings over two runs 3.3e-4 to 3.6e-4 (net), 1.7e-4 to
# 2.7e-4 (codes), 5.2e-3 and 1.1e-2 (euler), 1.1e-2 (tvec).  The camera
# offsets' gradient is a small sum of large per-pixel terms: the JAX
# package's own f32 gradient of it moves by 1.4e-2 between a jitted and an
# op-by-op run (tests/test_torch_train.py), and the step's cuDNN and index
# backward kernels sum in a different order on every run (PERF.md, Findings)
GRAD_REL_L2 = {"net": 2e-3, "iden": 2e-3, "expr": 2e-3, "appea": 2e-3,
               "euler": 5e-2, "tvec": 5e-2}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_biases_(module, gen):
    """Seeded initialisers zero every bias; trained biases are not zero, and
    a kernel that drops or misplaces one must show it: fill each bias with
    0.1 * N(0, 1)."""
    import torch

    with torch.no_grad():
        for name, t in module.named_parameters():
            if name.endswith("bias"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))


def k1_bound(B, R, S, De, H, C, operands):
    """Least time for the fused field forward at these shapes: bf16
    tensor-core operations vs bytes in and out, each moved once."""
    H2 = H // 2
    macs_point = De * H + 4 * H * H + (De + H) * H + 2 * H * H + H + H * H + H * H2
    ops = 2 * (B * R * S * macs_point + B * R * H2 * C)  # head after the sum
    bytes_in = (
        B * R * S * De * 2  # bf16 embedding
        + 2 * B * R * S * 4  # zvals, zdists
        + B * (2 * H + H2) * 4  # conditioning rows
        + sum(t.numel() * t.element_size() for t in operands)
    )
    bytes_out = B * R * C * 4 + 2 * B * R * 4 + B * R * S * 4
    t_ops = ops / PEAK_BF16_FLOPS
    t_bytes = (bytes_in + bytes_out) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k2_bound(args, cot, grads):
    """Least time for the fused field backward on these inputs: the
    recompute, the data gradients and the weight gradients (each the
    forward's multiply-adds) plus the folded head, vs bytes in and out."""
    embed, ops = args[0], args[-1]
    B, R, S, De = embed.shape
    H, H2, C = ops.w0e.shape[0], ops.wr2.shape[0], ops.wr2.shape[1]
    macs_point = De * H + 4 * H * H + (De + H) * H + 2 * H * H + H + H * H + H * H2
    ops_count = 2 * (3 * B * R * S * macs_point + 2 * B * R * H2 * C)
    tensors = [*args[:-1], *ops, *cot]
    bytes_in = sum(t.numel() * t.element_size() for t in tensors)
    bytes_out = sum(t.numel() * t.element_size() for t in grads)
    t_ops = ops_count / PEAK_BF16_FLOPS
    t_bytes = (bytes_in + bytes_out) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def seeded_field(seed, cfg, dev):
    """A field at the config's widths, seeded weights, every bias random."""
    import torch

    from gazenerf_tpu_torch.models.mlp_nerf import NeRFFieldMLP

    gen = torch.Generator().manual_seed(seed)
    field = NeRFFieldMLP(
        cfg.vp_embed_dims, cfg.shape_ext_code_dims, cfg.vd_channels,
        hidden=cfg.mlp_hidden, res_nfeat=cfg.featmap_nc,
    )
    field.reset_parameters(gen)
    random_biases_(field, gen)
    return field.to(dev), gen


def phase_kernels(seed, cfg, iters):
    """K1 against its plain version at the render's shapes, then timed."""
    import torch

    from gazenerf_tpu_torch.kernels import fused_field as ff
    from gazenerf_tpu_torch.kernels.checks import K1_REL_ERR
    from gazenerf_tpu_torch.ops.embedding import positional_encoding
    from gazenerf_tpu_torch.ops.rays import pixel_grid, sample_coarse
    from gazenerf_tpu_torch.viewer.server import lookat_camera

    dev = torch.device("cuda")
    field, gen = seeded_field(seed, cfg, dev)
    # the render's own inputs: rays of the frontal camera, seeded codes
    R_, T_, K_ = (torch.from_numpy(a).to(dev) for a in lookat_camera(0, 0, 12.0, cfg.featmap_size))
    xy = pixel_grid(cfg.featmap_size, device=dev)[None]
    samples = sample_coarse(xy, R_, T_.reshape(1, 3), K_, cfg.num_sample_coarse,
                            cfg.world_z1, cfg.world_z2)
    embed = positional_encoding(samples.pts, cfg.vp_n_freqs).to(torch.bfloat16).contiguous()
    sc = (0.1 * torch.randn(1, cfg.shape_ext_code_dims, generator=gen)).to(dev)
    ac = (0.1 * torch.randn(1, cfg.appea_code_dims, generator=gen)).to(dev)
    zvals = samples.zvals.contiguous()
    zdists = samples.z_dists.contiguous()
    with torch.no_grad():
        p = ff.split_params(field.flat(), cfg.vp_embed_dims)
        cb0, cb5, cbr1 = ff.conditioning_rows(p, sc, ac)
        ops = ff.prepare_operands(p)
        args = (embed, zvals, zdists, cb0, cb5, cbr1, ops)
        out_k = ff.fused_field_forward(*args)
        torch.cuda.synchronize()
        out_r = ff.fused_field_reference(*args)
        max_err = 0.0
        for name, a, b in zip(("feat_int", "bg_alpha", "depth", "weights"), out_k, out_r):
            check(bool(torch.isfinite(a).all()), f"K1 {name}: non-finite values")
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            print(f"K1 {name}: max abs err {err:.3e}, |plain| max {scale:.3e}, "
                  f"ratio {err / scale:.3e} (limit {K1_REL_ERR:.0e})")
            check(scale > 0 and err <= K1_REL_ERR * scale,
                  f"K1 {name}: max abs err {err:.3e} above {K1_REL_ERR} of {scale:.3e}")
            max_err = max(max_err, err)
        ms = cuda_ms(lambda: ff.fused_field_forward(*args), iters)
        plain_ms = cuda_ms(lambda: ff.fused_field_reference(*args), max(2, iters // 4), warmup=1)
    B, R, S, De = embed.shape
    bound_ms, bound_by = k1_bound(B, R, S, De, cfg.mlp_hidden, cfg.featmap_nc, ops)
    print(f"K1 fused_field_fwd: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}), {100 * bound_ms / ms:.1f}% of bound")
    return {
        "name": "fused_field_fwd",
        "route": "cuda",
        "source": "gazenerf_tpu_torch/csrc/fused_field_fwd.cu",
        "replaces": "gazenerf_tpu/kernels/fused_field.py:216",
        "launches": None,  # filled from the serving run
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this function
    }


REQUESTS = [  # (pitch, yaw, azimuth, elevation, distance)
    (0.0, 0.0, 0.0, 0.0, 12.0),
    (0.3, -0.4, 20.0, 5.0, 11.0),
    (-0.2, 0.5, -30.0, -10.0, 13.5),
    (0.1, 0.7, 45.0, 20.0, 10.0),
    (-0.4, -0.6, -50.0, 30.0, 15.0),
    (0.25, 0.1, 10.0, -25.0, 9.5),
]


def phase_serving(seed, cfg, n_requests):
    """Full-width renders through ViewerApp, with launch counts."""
    import numpy as np
    import torch

    from gazenerf_tpu_torch import ViewerApp
    from gazenerf_tpu_torch.kernels import fused_field as ff
    from gazenerf_tpu_torch.utils.png import decode_png

    app = ViewerApp(cfg, seed=seed)  # on the card: no device given
    random_biases_(app.model, torch.Generator().manual_seed(seed))
    check(app.model.fused, "the bf16 config must run the fused field kernel")
    requests = [REQUESTS[i % len(REQUESTS)] for i in range(n_requests)]
    app.render_png(*requests[0])  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    ff.launch_count = 0  # counts from here on are the main path's
    pngs, times = [], []
    for q in requests:
        t0 = time.perf_counter()
        pngs.append(app.render_png(*q))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = ff.launch_count
    check(launches == 2 * n_requests,
          f"K1 launched {launches} times for {n_requests} requests (expected 2 each)")

    size = cfg.pred_img_size
    for q, png in zip(requests, pngs):
        img = decode_png(png)
        check(img.shape == (size, size, 3), f"PNG decodes to {img.shape}")
        ref = app.render_image(*q)
        check(bool(torch.isfinite(ref).all()), f"request {q}: non-finite pixels")
        again = torch.clamp(ref * 255.0, 0.0, 255.0).to(torch.uint8).cpu().numpy()
        check(int(np.abs(again.astype(np.int16) - img).max()) <= 1,
              f"request {q}: PNG differs from a second render")

    img_k = app.render_image(*requests[0]).float()
    kernel_forward = ff.fused_field_forward
    ff.fused_field_forward = ff.fused_field_reference  # the plain version
    try:
        img_p = app.render_image(*requests[0]).float()
    finally:
        ff.fused_field_forward = kernel_forward
    img_err = float((img_k - img_p).abs().max())
    check(img_err <= IMAGE_ATOL,
          f"image with K1 vs with its plain version: max abs err {img_err:.3e} > {IMAGE_ATOL}")
    print(f"serving: {n_requests} requests of {size}x{size}, ms per request "
          f"{[round(t, 3) for t in times]}, median {float(np.median(times)):.3f}; "
          f"image kernel vs plain max abs err {img_err:.3e} (atol {IMAGE_ATOL})")
    return app, requests, launches, times


def device_profile(fn, top=0):
    """One call of ``fn`` (to a synchronize) under ``torch.profiler``: its
    wall ms, the kernels it launched and their summed device ms, and the
    ``top`` kernels by device time.  "not measured" where the profiler sees
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel events only: an operator's row repeats its kernels' device time
    rows = sorted(
        ((e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[2],
    )
    if not rows:
        return {"wall_ms": wall_ms, "launches": "not measured", "device_ms": "not measured"}
    out = {"wall_ms": wall_ms, "launches": sum(r[1] for r in rows),
           "device_ms": sum(r[2] for r in rows)}
    if top:
        out["top"] = [{"kernel": k[:80], "count": n, "ms": ms} for k, n, ms in rows[:top]]
    return out


def phase_breakdown(app, requests, card):
    """Where a request's time goes, and the renderer's share of it: the
    viewer's one renderer pass against the model forward's four (the
    forward also renders the face, eye and background images, which the
    viewer does not show)."""
    import statistics

    import torch

    from gazenerf_tpu_torch.utils.png import encode_png
    from gazenerf_tpu_torch.viewer.server import lookat_camera

    def host_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    def forward_args(q):
        R, T, K = (torch.from_numpy(a).to(app.device)
                   for a in lookat_camera(q[2], q[3], q[4], app.cfg.featmap_size))
        gaze = torch.tensor([q[:2]], dtype=torch.float32, device=app.device)
        return app.xy, app.shape_code, app.appea_code, gaze, R, T, K

    def model_forward(q):
        with torch.no_grad():
            return app.model(*forward_args(q))

    fwd, fwd4, to_host, png = [], [], [], []
    for q in requests:
        img, ms = host_ms(lambda: (app.render_image(*q), torch.cuda.synchronize())[0])
        fwd.append(ms)
        u8, ms = host_ms(lambda: torch.clamp(img * 255.0, 0.0, 255.0)
                         .to(torch.uint8).cpu().numpy())
        to_host.append(ms)
        png.append(host_ms(lambda: encode_png(u8))[1])
        fwd4.append(host_ms(lambda: (model_forward(q), torch.cuda.synchronize()))[1])

    q = requests[0]
    viewer = device_profile(lambda: app.render_image(*q), top=8)
    forward4 = device_profile(lambda: model_forward(q))
    with torch.no_grad():
        fm = app.model.render_featmaps(*forward_args(q))["featmaps"]["merge"]
    renderer = device_profile(lambda: app.model.neural_render(fm))
    if viewer["device_ms"] != "not measured":
        viewer["busy_unprofiled"] = viewer["device_ms"] / statistics.median(fwd)
    line = {
        "card": card,
        "parts_ms": {  # medians over the requests, host clock
            "forward": statistics.median(fwd),
            "uint8_to_host": statistics.median(to_host),
            "png_encode": statistics.median(png),
            "model_forward_4_passes": statistics.median(fwd4),
        },
        "viewer_request": viewer,
        "model_forward_4_passes": forward4,
        "renderer_pass": renderer,
    }
    print(json.dumps({"serving": line}))
    return line


def phase_k2(seed, iters):
    """K2 against its plain version in the narrow case (hidden 64, where the
    two agree to f32 noise) and at the training step's shape (B=2, 4096
    rays, 64 samples, hidden 384), where it is also held against the
    unrounded float64 gradient and then timed."""
    import torch

    from gazenerf_tpu_torch.kernels import checks
    from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb

    dev = torch.device("cuda")
    fails = []
    for case in ("narrow", "training"):
        args, cot = checks.field_case(*checks.K2_CASES[case], dev, seed=seed)
        with torch.no_grad():
            got = ffb.fused_field_backward(*args, *cot)
            torch.cuda.synchronize()
            want = ffb.fused_field_backward_reference(*args, *cot)
            again = ffb.fused_field_backward(*args, *cot)
        readings, case_fails = checks.k2_failures(case, got, want)
        if case == "training":
            with torch.no_grad():
                want64 = ffb.fused_field_backward_reference(*args, *cot, dtype=torch.float64)
            exact = ffb.fused_field_backward_unrounded(*args, *cot)
            dist, truth_fails = checks.k2_truth_failures(got, want, want64, exact)
            case_fails += truth_fails
            del want64, exact
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            case_fails.append("two launches on the same inputs differ")
        print(json.dumps({"k2_case": case, "seed": seed, "readings": readings,
                          **({"unrounded_distance": dist} if case == "training" else {})}))
        fails += [f"K2 {case}: {f}" for f in case_fails]
    check(not fails, "\n".join(fails))
    max_err = float(max((a - b).abs().max() for a, b in zip(got, want)))
    with torch.no_grad():
        ms = cuda_ms(lambda: ffb.fused_field_backward(*args, *cot), iters)
        plain_ms = cuda_ms(lambda: ffb.fused_field_backward_reference(*args, *cot),
                           max(2, iters // 4), warmup=1)
    bound_ms, bound_by = k2_bound(args, cot, got)
    print(f"K2 fused_field_bwd: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}), {100 * bound_ms / ms:.1f}% of bound")
    return {
        "name": "fused_field_bwd",
        "route": "cuda",
        "source": "gazenerf_tpu_torch/csrc/fused_field_bwd.cu",
        "replaces": "gazenerf_tpu/kernels/fused_field_bwd.py:44",
        "launches": None,  # filled from the training run
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this function
    }


def synthetic_batch(seed, B, size, featmap_size):
    """A seeded training batch in the loader's format: images in [0, 1],
    head and eye masks as filled ellipses, codes 0.1 * N(0, 1), the base
    camera (its featmap intrinsics scaled up to the image)."""
    import numpy as np

    from gazenerf_tpu_torch.data.cameras import base_inv_inmat

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size] / size

    def ellipse(cy, cx, ry, rx):
        return (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1).astype(np.float32)

    inmat = np.linalg.inv(base_inv_inmat(featmap_size)).astype(np.float32)
    inmat[:2] *= size / featmap_size

    def rep(a):
        return np.repeat(np.asarray(a, np.float32)[None], B, 0)

    return {
        "image": rng.random((B, size, size, 3), dtype=np.float32),
        "head_mask": rep(ellipse(0.5, 0.5, 0.4, 0.3)),
        "left_eye_mask": rep(ellipse(0.42, 0.4, 0.04, 0.06)),
        "right_eye_mask": rep(ellipse(0.42, 0.6, 0.04, 0.06)),
        "code": (0.1 * rng.standard_normal((B, 306))).astype(np.float32),
        "sample_idx": np.arange(B, dtype=np.int64),
        "pitchyaw": (0.2 * rng.standard_normal((B, 2))).astype(np.float32),
        "c2w_Rmat": rep(np.diag([1.0, -1.0, -1.0])),
        "c2w_Tvec": rep([0.0, 0.0, 12.0]),
        "inmat": rep(inmat),
    }


def phase_training(seed, cfg, n_steps, card):
    """Full-width training steps with launch counts, then one step's
    gradients with the kernels against the plain versions."""
    import statistics

    import torch

    from gazenerf_tpu_torch import Config, Trainer
    from gazenerf_tpu_torch.kernels import fused_field as ff
    from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb

    tcfg = Config(model=cfg)
    trainer = Trainer(tcfg, train_len=8, steps_per_epoch=1000, seed=seed)  # the card
    check(trainer.model.fused, "the bf16 config must run the fused field kernels")
    batch = synthetic_batch(seed, tcfg.train.batch_size, cfg.pred_img_size, cfg.featmap_size)

    def read(losses):
        return {k: float(v) for k, v in losses.items()}

    first = read(trainer.train_step(batch))
    trainer.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ff.launch_count = ffb.launch_count = 0  # counts from here on are the main path's
    times = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        losses = trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    k1, k2 = ff.launch_count, ffb.launch_count
    peak = torch.cuda.max_memory_allocated()
    last = read(losses)
    for name, v in {**first, **last}.items():
        check(v == v and abs(v) != float("inf"), f"training loss {name} is not finite")
    check(last["total_loss"] < first["total_loss"],
          f"total loss did not fall: {first['total_loss']} -> {last['total_loss']}")
    check(k1 == 2 * n_steps and k2 == 2 * n_steps,
          f"{n_steps} steps launched K1 {k1} and K2 {k2} times (expected 2 each per step)")

    grads = phase_grad_check(trainer, batch, seed)
    parts = phase_step_breakdown(trainer, batch)
    line = {
        "card": card,
        "config": "ModelConfig(compute_dtype=bfloat16, renderer_dtype=bfloat16), "
                  "LossConfig(), TrainConfig(); B=2, 4096 rays x 64 samples, 512x512",
        "step_ms": {"median": statistics.median(times), "samples": times},
        "launches_per_step": {"fused_field_fwd": k1 / n_steps, "fused_field_bwd": k2 / n_steps},
        "losses_first_step": first,
        "losses_last_step": last,
        "steps": 2 + n_steps,
        "peak_memory_bytes": peak,
        "grad_rel_l2_kernel_vs_plain": grads,
        "breakdown": parts,
    }
    print(json.dumps({"training": line}))
    return k1, k2


def phase_grad_check(trainer, batch, seed):
    """One step's gradients (no update) with the kernels, then the same
    step (state, batch, jitter draws) with the plain versions; relative L2
    per parameter group."""
    import torch

    from gazenerf_tpu_torch.kernels import fused_field as ff
    from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb

    cfg = trainer.cfg.model
    gen = torch.Generator(device=trainer.device).manual_seed(seed + 7)
    t_rand = torch.rand((trainer.cfg.train.batch_size, cfg.num_rays, cfg.num_sample_coarse + 1),
                        generator=gen, device=trainer.device)

    def grads():
        before = (ff.launch_count, ffb.launch_count)
        trainer.train_step(batch, t_rand=t_rand, update=False)
        torch.cuda.synchronize()
        used = (ff.launch_count - before[0], ffb.launch_count - before[1])
        return {g["name"]: torch.cat([p.grad.reshape(-1).float() for p in g["params"]])
                for g in trainer.optimizer.param_groups}, used

    with_kernels, used = grads()
    check(used == (2, 2), f"the kernel step launched K1/K2 {used} times")
    kernel_fwd, kernel_bwd = ff.fused_field_forward, ffb.fused_field_backward
    ff.fused_field_forward = ff.fused_field_reference
    ffb.fused_field_backward = ffb.fused_field_backward_reference
    try:
        plain, used = grads()
    finally:
        ff.fused_field_forward, ffb.fused_field_backward = kernel_fwd, kernel_bwd
    check(used == (0, 0), f"the plain step launched K1/K2 {used} times")
    out = {}
    for name, g in with_kernels.items():
        rel = float((g - plain[name]).norm() / plain[name].norm())
        out[name] = rel
        print(f"step gradients, kernels vs plain, {name}: relative L2 {rel:.3e} "
              f"(limit {GRAD_REL_L2[name]:.0e})")
        check(bool(torch.isfinite(g).all()), f"gradient of {name} is not finite")
        check(rel <= GRAD_REL_L2[name],
              f"gradient of {name}: relative L2 {rel:.3e} above {GRAD_REL_L2[name]}")
    trainer.optimizer.zero_grad(set_to_none=True)
    return out


def phase_step_breakdown(trainer, batch):
    """Where one training step's time goes, on the device: the step's
    stages each timed alone to a synchronize (fields forward with K1, the
    four renderer passes, the losses with VGG, then the backward in three
    parts and the optimizer), and the whole step under ``torch.profiler``
    (device time by kernel, K1 and K2 apart)."""
    import numpy as np
    import torch

    from gazenerf_tpu_torch.losses.gazenerf_loss import compute_losses
    from gazenerf_tpu_torch.ops.rays import pixel_grid
    from gazenerf_tpu_torch.train.trainer import compose_codes_and_cams, decode_uint8_batch

    model, cfg = trainer.model, trainer.cfg
    b = decode_uint8_batch(trainer.to_device(batch))
    B = b["image"].shape[0]
    expr = torch.as_tensor(np.asarray(trainer.expr_fix), device=trainer.device)
    xy = pixel_grid(cfg.model.featmap_size, device=trainer.device)[None].expand(B, -1, -1)
    nr = model.neural_render
    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    def stages():
        sc, ac, gz, R, T, K, ocd, dcam = compose_codes_and_cams(cfg, b, trainer.offsets, expr)
        fm = timed("fields_forward_k1", lambda: model.render_featmaps(
            xy, sc, ac, gz, R, T, K, train=True, generator=trainer.generator)["featmaps"])
        imgs = timed("renderer_forward_4_passes", lambda: {
            "merge_img": nr(fm["merge"]), "merge_img_face": nr(fm["face"]),
            "merge_img_eyes": nr(fm["eyes"]), "bg_img": nr(nr.get_bg_featmap())})
        losses = timed("losses_forward_vgg", lambda: compute_losses(
            cfg.loss, imgs, b["image"], b["head_mask"][..., None], b["left_eye_mask"][..., None],
            b["right_eye_mask"][..., None], vgg_capture_fn=trainer.frozen.vgg_capture_fn(),
            opt_code_dict=ocd, delta_cam=dcam))
        keys = ("merge_img", "merge_img_face", "merge_img_eyes")
        g_img = timed("losses_backward_vgg", lambda: torch.autograd.grad(
            losses["total_loss"], [imgs[k] for k in keys], retain_graph=True))
        fms = [fm["face"], fm["eyes"], fm["merge"]]
        ren = list(nr.parameters())
        g_fm = timed("renderer_backward_3_passes", lambda: torch.autograd.grad(
            [imgs[k] for k in keys], fms + ren, g_img, retain_graph=True)[:3])
        params = [p for p in model.parameters() if p.requires_grad] + list(trainer.offsets.values())
        grads = timed("fields_backward_k2", lambda: torch.autograd.grad(
            fms[:2], params, g_fm[:2], allow_unused=True))
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        timed("optimizer", trainer.optimizer.step)
        trainer.optimizer.zero_grad(set_to_none=True)

    stages()  # warm
    stages()
    profile = device_profile(lambda: trainer.train_step(batch), top=12)
    if profile["device_ms"] != "not measured":
        by_name = {r["kernel"]: r for r in profile["top"]}
        profile["k1_ms"] = sum(r["ms"] for k, r in by_name.items() if "field_fwd_kernel" in k)
        profile["k2_ms"] = sum(r["ms"] for k, r in by_name.items()
                               if "field_bwd_kernel" in k or "reduce_slabs" in k)
        profile["busy_share"] = profile["device_ms"] / profile["wall_ms"]
    return {"stages_ms": ms, "step_profile": profile}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20, help="timed kernel launches")
    ap.add_argument("--steps", type=int, default=5, help="timed training steps")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    check(args.requests >= 1, "--requests must be at least 1")
    check(args.steps >= 5, "--steps must be at least 5")
    from gazenerf_tpu_torch.config import ModelConfig
    from gazenerf_tpu_torch.kernels import build
    from gazenerf_tpu_torch.kernels import fused_field as ff
    from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    logs = build.build({ff.KERNEL: ff.DEFINES, ffb.KERNEL: ffb.DEFINES})
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}")

    # the render configuration the CLIs use: bf16 fields and renderer
    cfg = ModelConfig(compute_dtype="bfloat16", renderer_dtype="bfloat16")

    # 3. kernels vs plain versions
    k1 = phase_kernels(args.seed, cfg, args.iters)
    k2 = phase_k2(args.seed, max(4, args.iters // 4))

    # 4. serving
    app, requests, launches, _ = phase_serving(args.seed, cfg, args.requests)
    k1["launches"] = launches

    # 5. breakdown
    phase_breakdown(app, requests, smi)
    del app

    # 6. training
    _, k2["launches"] = phase_training(args.seed, cfg, args.steps, smi)

    print(json.dumps({"kernels": [k1, k2]}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
