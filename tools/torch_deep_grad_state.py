#!/usr/bin/env python3
"""How far the deep march's training-step gradients with the field kernels
lie from the same step with their plain versions, state by state, and what
parts them, on one CUDA card.

    python tools/torch_deep_grad_state.py [--seed 0] [--states 1,2,3] [--out FILE]

In ``chip_smoke.py``'s ``deep`` variant (bf16 fields and renderer, B=2,
4096 rays x 256 samples in checkpointed 512-ray chunks, the CLI's
``--pallas_tuning auto`` overrides for that shape, no VGG loss) one trainer
takes 2 warm-up steps and then one step at a time.  After 2 + n steps, for
each n in ``--states``, it reads one step's gradients (no update; the same
batch, jitter draws and discriminator state, as ``chip_smoke.py``'s
gradient check) in four settings:

* ``kernels``: K1 and K2;
* ``plain``: both plain versions (``checks.plain_versions``);
* ``k2_plain``: K1, and K2's plain version in f32;
* ``k2_f64``: K1, and K2's plain version computing in float64 between the
  same bf16 rounding points (its gradients rounded to f32 for autograd):
  the nearest to exact that the step can take without K1's rounding.

and prints a ``state`` line: per parameter group the relative L2 of each
pair (kernels against plain, as ``chip_smoke.py`` holds it; kernels against
k2_plain, K2's part; k2_plain against plain, K1's part; kernels and
k2_plain against k2_f64) and the norms of the kernels' gradient and of its
difference from the plain one.  Then ``masks``: on the face field's first
K1 call of that step (ray chunk 0), K1's bf16 stash against its plain
version's, per slot x0..x7 and y0b: the entries that differ, the ReLU
masks that differ (zero in one, not in the other) and the largest |value|
where a mask differs.  The last line holds the card.  With ``--out`` the
lines also go to FILE.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--states", default="1,2,3", help="the n of the states 2 + n read")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    states = sorted({int(n) for n in args.states.split(",")})

    import torch

    import chip_smoke as cs
    from gazenerf_tpu_torch import Config, Trainer
    from gazenerf_tpu_torch.cli.common import tuned_kernel_overrides
    from gazenerf_tpu_torch.config import LossConfig, ModelConfig
    from gazenerf_tpu_torch.kernels import build, checks
    from gazenerf_tpu_torch.kernels import fused_field as ff
    from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build(build.every_kernel())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    out = open(args.out, "w") if args.out else None

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    base = ModelConfig(compute_dtype="bfloat16", renderer_dtype="bfloat16")
    S = cs.DEEP_SHAPE[1]
    cfg = dataclasses.replace(base, num_sample_coarse=S,
                              **tuned_kernel_overrides(base.featmap_size, S))
    tcfg = Config(model=cfg, loss=LossConfig(use_vgg_loss=False))
    trainer = Trainer(tcfg, train_len=8, steps_per_epoch=1000, seed=args.seed)
    batch = cs.synthetic_batch(args.seed, tcfg.train.batch_size, cfg.pred_img_size,
                               cfg.featmap_size)

    k1, k2 = ff.fused_field_forward, ffb.fused_field_backward

    def k2_f64(*a, **k):
        g = ffb.fused_field_backward_reference(*a, dtype=torch.float64, **k)
        return type(g)(*(t.float() for t in g))

    @contextlib.contextmanager
    def k2_as(fn):
        ffb.fused_field_backward = fn
        try:
            yield
        finally:
            ffb.fused_field_backward = k2

    settings = {"kernels": contextlib.nullcontext, "plain": checks.plain_versions,
                "k2_plain": lambda: k2_as(ffb.fused_field_backward_reference),
                "k2_f64": lambda: k2_as(k2_f64)}

    def grads(disc0, t_rand):
        g = {}
        for name, ctx in settings.items():
            trainer.load_disc_state(disc0)
            with ctx():
                trainer.train_step(batch, t_rand=t_rand, update=False)
            torch.cuda.synchronize()
            g[name] = {p["name"]: torch.cat([q.grad.reshape(-1).float() for q in p["params"]])
                       for p in trainer.optimizer.param_groups}
        trainer.optimizer.zero_grad(set_to_none=True)
        trainer.load_disc_state(disc0)
        return g

    def rel(a, b):
        return {k: float((a[k] - b[k]).norm() / b[k].norm()) for k in a}

    def first_k1_call(disc0, t_rand):
        """The inputs of the step's first K1 call (the face field, chunk 0)."""
        seen = []

        def spy(*a, **k):
            if not seen:
                seen.append((a, k))
            return k1(*a, **k)

        ff.fused_field_forward = spy
        try:
            trainer.load_disc_state(disc0)
            trainer.train_step(batch, t_rand=t_rand, update=False)
        finally:
            ff.fused_field_forward = k1
        trainer.optimizer.zero_grad(set_to_none=True)
        trainer.load_disc_state(disc0)
        return seen[0]

    for _ in range(2):
        trainer.train_step(batch)
    done = 0
    for n in states:
        while done < n:
            trainer.train_step(batch)
            done += 1
        torch.cuda.synchronize()
        disc0 = trainer.disc_state()
        t_rand = cs.jitter_draws(trainer, args.seed)
        g = grads(disc0, t_rand)
        emit({"state": f"2+{n}",
              "kernels_vs_plain": rel(g["kernels"], g["plain"]),
              "kernels_vs_k2_plain": rel(g["kernels"], g["k2_plain"]),
              "k2_plain_vs_plain": rel(g["k2_plain"], g["plain"]),
              "kernels_vs_k2_f64": rel(g["kernels"], g["k2_f64"]),
              "k2_plain_vs_k2_f64": rel(g["k2_plain"], g["k2_f64"]),
              "kernels_norm": {k: float(v.norm()) for k, v in g["kernels"].items()},
              "kernels_minus_plain_norm": {k: float((v - g["plain"][k]).norm())
                                           for k, v in g["kernels"].items()}})
        del g
        a, k = first_k1_call(disc0, t_rand)
        k = {key: v for key, v in k.items() if key != "stash"}
        with torch.no_grad():
            _, got = k1(*a, stash=True, **k)
            _, want = ff.fused_field_reference(*a, stash=True, **k)
        slots = {}
        for tag, x, y in zip(ff.STASH_TAGS[:9], got, want):
            x, y = x.float(), y.float()
            flip = (x == 0) != (y == 0)
            slots[tag] = {"entries": x.numel(), "differ": int((x != y).sum()),
                          "masks_differ": int(flip.sum()),
                          "max_abs_where_masks_differ": float(torch.maximum(
                              x.abs(), y.abs())[flip].max()) if bool(flip.any()) else 0.0}
        emit({"masks": f"2+{n}", "call": "face field, ray chunk 0", "slots": slots})
        del got, want, a, k
        torch.cuda.empty_cache()
    emit({"card": card})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
