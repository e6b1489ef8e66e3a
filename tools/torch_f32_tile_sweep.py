#!/usr/bin/env python3
"""Time the f32 fused upsampler's product tile and weight-gradient
contraction (``csrc/fused_upsampler_f32.cu``) in each of their tile shapes,
at the shapes K7 and K8 at f32 give them, on one CUDA card.

    python tools/torch_f32_tile_sweep.py [--iters 20]

At each of the renderer's three upsample blocks at B=2 (``kernels/checks.py``
``block0..2``: P pixels, widths F and F3) the products (M x N x K) are K7's
``h1`` (P x 2F x F), ``z`` (P x 4F x 2F) and ``z3`` (4P x F3 x F) and K8's
``dz`` (4P x F x F3), ``dh1`` (P x 2F x 4F) and ``dx`` (P x F x 2F); the
contractions (rows x M x N) are ``dW1`` (P x F x 2F), ``dW2`` (P x 2F x 4F)
and ``dW3`` (4P x F x F3).  Each is timed through ``f32_product`` /
``f32_contract`` (CUDA events; the product's epilogue is a plain store) in
every shape and in the shape the kernels pick (``-1``).  Prints one JSON
line per operation: ms per shape and the share of the f32 peak (67 TFLOP/s)
that its multiply-adds reach; then a ``total`` line: per block the sum over
the operations of the picked shape's ms and of the fastest shape's.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PEAK_F32_FLOPS = 67e12


def operations(P: int, F: int, F3: int):
    """(name, kind, dims) of K7's and K8's products and contractions."""
    return [("h1", "product", (P, 2 * F, F)), ("z", "product", (P, 4 * F, 2 * F)),
            ("z3", "product", (4 * P, F3, F)), ("dz", "product", (4 * P, F, F3)),
            ("dh1", "product", (P, 2 * F, 4 * F)), ("dx", "product", (P, F, 2 * F)),
            ("dW1", "contract", (P, F, 2 * F)), ("dW2", "contract", (P, 2 * F, 4 * F)),
            ("dW3", "contract", (4 * P, F, F3))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_f32_tile_sweep: no CUDA device")
    import chip_smoke as cs
    from gazenerf_tpu_torch.kernels import checks
    from gazenerf_tpu_torch.kernels import fused_upsampler as fu

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    total = {}
    for block in ("block0", "block1", "block2"):
        B, H, W, F, F3 = checks.BLOCK_CASES[block]
        for name, kind, (d0, d1, d2) in operations(B * H * W, F, F3):
            contract = kind == "contract"
            if contract:  # rows x M x N
                a = torch.randn(d0, d1, device=dev, generator=gen)
                b = torch.randn(d0, d2, device=dev, generator=gen)
                fn = fu.f32_contract
            else:  # M x N x K
                a = torch.randn(d0, d2, device=dev, generator=gen)
                b = torch.randn(d2, d1, device=dev, generator=gen)
                fn = fu.f32_product
            flops = 2.0 * d0 * d1 * d2
            ms = {}
            for shape in range(-1, fu.f32_shapes(contract)):
                ms[shape] = cs.cuda_ms(lambda: fn(a, b, shape), args.iters)
            line = {"block": block, "op": name, "kind": kind, "dims": [d0, d1, d2],
                    "ms": ms, "peak_share": {k: flops / PEAK_F32_FLOPS / (v * 1e-3)
                                             for k, v in ms.items()}}
            print(json.dumps(line), flush=True)
            t = total.setdefault(block, {"picked_ms": 0.0, "best_ms": 0.0})
            t["picked_ms"] += ms[-1]
            t["best_ms"] += min(ms.values())
            del a, b
    print(json.dumps({"total": total, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
