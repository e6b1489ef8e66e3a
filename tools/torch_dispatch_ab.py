#!/usr/bin/env python3
"""Time the PyTorch port's training epoch with one step per dispatch
against ``steps_per_dispatch = K > 1`` on one CUDA card, in turns.

    python tools/torch_dispatch_ab.py [--k 3] [--batches 12] [--turns 2]

One full-width bf16 ``Trainer`` (``chip_smoke.py``'s training
configuration: B=2, 4096 rays x 64 samples, hidden 384, 512^2, the
``phase_gm`` renderer, the default loss stack) runs epochs of ``--batches``
seeded batches, pinned as the loader pins them
(``data.h5_dataset.pin_batch``), through ``Trainer.train_epoch``: K = 1 and
K = ``--k`` in turns (1, k, k, 1, ...), after one untimed epoch of each.
With K > 1 the epoch stacks K batches per dispatch
(``data.h5_dataset.stack_batches``: one ``torch.stack`` and one pinned
copy on the host, one copy to the card) and takes the remainder one batch
at a time.  Per epoch it prints one JSON line (wall seconds, ms per step,
the seconds the loop waited for its batches), then the host time of
``stack_batches`` alone per dispatch, then a summary with the card's name
and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, default=3, help="steps per dispatch to compare with 1")
    ap.add_argument("--batches", type=int, default=12, help="batches per epoch")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_dispatch_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from gazenerf_tpu_torch import Config, Trainer
    from gazenerf_tpu_torch.config import ModelConfig
    from gazenerf_tpu_torch.data.h5_dataset import pin_batch, stack_batches

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(model=ModelConfig(compute_dtype="bfloat16", renderer_dtype="bfloat16"))
    trainer = Trainer(cfg, train_len=8, steps_per_epoch=args.batches, seed=args.seed)
    m = cfg.model
    batches = [pin_batch(cs.synthetic_batch(args.seed + i, cfg.train.batch_size,
                                            m.pred_img_size, m.featmap_size))
               for i in range(args.batches)]

    def epoch(k, n):
        trainer.cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, steps_per_dispatch=k))
        torch.cuda.synchronize()
        return trainer.train_epoch(batches, n)  # ends in the epoch's one host sync

    for k in (1, args.k):  # untimed: the kernels' and cuDNN's first calls
        epoch(k, 0)
    order = [x for i in range(args.turns) for x in ((1, args.k) if i % 2 == 0 else (args.k, 1))]
    per_step = {1: [], args.k: []}
    for i, k in enumerate(order):
        s = epoch(k, i + 1)
        ms = s["seconds"] * 1e3 / s["batches"]
        per_step[k].append(ms)
        print(json.dumps({"steps_per_dispatch": k, "batches": s["batches"],
                          "seconds": s["seconds"], "ms_per_step": ms,
                          "loader_wait_s": s["loader_wait_s"], "loss": s["loss"]}))
    stack_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        n = sum(1 for _ in stack_batches(batches, args.k))
        stack_ms.append((time.perf_counter() - t0) * 1e3 / n)
    print(json.dumps({"dispatch_ab": {
        "card": card, "k": args.k, "batches": args.batches,
        "ms_per_step_median": {str(k): statistics.median(v) for k, v in per_step.items()},
        "ms_per_step": {str(k): v for k, v in per_step.items()},
        "stack_batches_host_ms_per_dispatch": stack_ms,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
