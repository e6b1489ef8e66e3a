#!/usr/bin/env python3
"""How far one training step's gradients in each renderer mode of the
PyTorch port lie from ``phase_gm``'s, how far repeated runs of a step lie
apart, and what makes the first move between runs, on one CUDA card.

    python tools/torch_grad_repeat.py [--seed 0] [--repeats 3] [--own-steps 3] [--out FILE]

At the width ``chip_smoke.py`` trains (bf16 fields and renderer, B=2, 64x64
rays x 64 samples, 512x512 output), with one seeded batch and one set of
jitter draws, first as PyTorch runs by default, then under
``torch.use_deterministic_algorithms(True)`` (``warn_only``: the operations
that would still be nondeterministic are listed from their warnings).  Per
setting it prints JSON lines:

* ``fixed``: from one state (the seeded weights, no step taken), per mode
  (``phase_gm`` and ``chip_smoke.py``'s ``EAGER_MODES``) the step's gradients
  (no update) ``--repeats`` times: the relative L2 per parameter group of
  every repeat against the first (``repeat``) and against ``phase_gm``'s
  first (``vs_phase_gm``);
* ``own``: per eager mode, two trainers made alike from the seed, each
  taking ``--own-steps`` steps in that mode (as ``chip_smoke.py``'s variants
  do before their checks), then its gradients in the mode against
  ``phase_gm``'s at the state it reached; and how far the two trainers'
  weights lie apart (relative L2 per group); none with ``--own-steps 0``.

Then ``kernels``: the CUDA kernels of one ``phase_gm`` step that run in one
setting and not in the other (``torch.profiler``): the implementations
that the deterministic setting swaps.  The last line holds the warnings and
the card.  With ``--out`` the lines also go to FILE.  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

# cuBLAS takes a fixed workspace under deterministic algorithms; read when
# its handle is made, so before the first product
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def rel_l2(got, want):
    return {k: float((g - want[k]).norm() / want[k].norm()) for k, g in got.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--own-steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from gazenerf_tpu_torch import Config, Trainer
    from gazenerf_tpu_torch.config import ModelConfig
    from gazenerf_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build(build.every_kernel())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]

    cfg = ModelConfig(compute_dtype="bfloat16", renderer_dtype="bfloat16")
    modes = {"phase_gm": cfg, **{name: dataclasses.replace(cfg, **flags)
                                 for name, flags in cs.EAGER_MODES.items()}}
    tcfg = Config(model=cfg)
    batch = cs.synthetic_batch(args.seed, tcfg.train.batch_size, cfg.pred_img_size,
                               cfg.featmap_size)

    def trainer_in(mcfg):
        t = Trainer(Config(model=mcfg), train_len=8, steps_per_epoch=1000, seed=args.seed)
        gen = torch.Generator(device=t.device).manual_seed(args.seed + 7)
        t_rand = torch.rand((tcfg.train.batch_size, cfg.num_rays, cfg.num_sample_coarse + 1),
                            generator=gen, device=t.device)
        return t, t_rand

    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    def weights(t):
        return {g["name"]: torch.cat([p.detach().reshape(-1).float() for p in g["params"]])
                for g in t.optimizer.param_groups}

    warned, kernels = {}, {}
    for setting in ("default", "deterministic"):
        torch.use_deterministic_algorithms(setting == "deterministic", warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer, t_rand = trainer_in(cfg)
            disc0 = trainer.disc_state()
            runs = {name: [cs.step_grads(trainer, batch, t_rand, disc0, mcfg, name)
                           for _ in range(args.repeats)]
                    for name, mcfg in modes.items()}
            ref = runs["phase_gm"][0]
            for name, rs in runs.items():
                emit({"setting": setting, "fixed": name,
                      "repeat": [rel_l2(r, rs[0]) for r in rs[1:]],
                      "vs_phase_gm": [rel_l2(r, ref) for r in rs]})
            del runs, ref

            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                cs.step_grads(trainer, batch, t_rand, disc0, cfg, "phase_gm")
            kernels[setting] = {e.key for e in prof.key_averages()
                                if "CUDA" in str(getattr(e, "device_type", ""))}
            del trainer
            torch.cuda.empty_cache()

            for name, mcfg in modes.items():
                if name == "phase_gm" or not args.own_steps:
                    continue
                pair = []
                for _ in range(2):
                    t, tr = trainer_in(mcfg)
                    for _ in range(args.own_steps):
                        t.train_step(batch)
                    d0 = t.disc_state()
                    pair.append((rel_l2(cs.step_grads(t, batch, tr, d0, mcfg, name),
                                        cs.step_grads(t, batch, tr, d0, cfg, "phase_gm")),
                                 weights(t)))
                    del t
                    torch.cuda.empty_cache()
                emit({"setting": setting, "own": name, "steps": args.own_steps,
                      "vs_phase_gm": [p[0] for p in pair],
                      "weights_apart": rel_l2(pair[1][1], pair[0][1])})
                del pair
        for w in caught:
            msg = str(w.message).splitlines()[0]
            if "determinis" in msg:
                warned[msg] = warned.get(msg, 0) + 1
    torch.use_deterministic_algorithms(False)

    def short(names):
        return sorted(n[:120] for n in names)

    emit({"kernels": {"default_only": short(kernels["default"] - kernels["deterministic"]),
                      "deterministic_only": short(kernels["deterministic"] - kernels["default"])}})
    emit({"nondeterministic_ops_warned": warned, "card": card, "seed": args.seed,
          "repeats": args.repeats})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
