#!/usr/bin/env python3
"""Time the PyTorch port's blur-shuffle stencil (K5, K6, and the stencil
launch inside the fused upsampler's forward, K7) and its training step in
several source trees on one CUDA card, in turns.

    python tools/torch_stencil_ab.py [--turns 2] [--iters 20] [--steps] SPEC [SPEC ...]

SPEC is ``LABEL=TREE`` or ``LABEL=TREE+VARIANT``, as for
``tools/torch_field_ab.py`` (whose tree preparation and turn order this tool
shares), VARIANT one of :data:`VARIANTS`.  Per child it prints one JSON
line: the card, ``-Xptxas -v`` of the stencil's and K7's kernels, and at
each of the renderer's three stencil levels (``kernels/checks.py``
``level0..2``, B=2 bf16) K5 and K6, and K5 at B=1, each two ways: ``ms``,
CUDA events over back-to-back launches through the wrapper (the wrapper's
host time included where it is the longer), and ``device_ms``, the
kernel's own duration under ``torch.profiler``.  K7 at the three upsample blocks (``block0..2``): ``ms``
of the whole forward and ``device_ms`` of its chain and of its stencil
launch.  ``digest``: a hash of K5's and K6's outputs in every
``STENCIL_CASES`` case (and :data:`EDGE_CASES`) in bf16 and f32 and of K7's
in every ``BLOCK_CASES`` case; the last line says per output whether every
label gave the same bits (give trees without variants for that).
With ``--steps``, for the trees without a variant, the device time, peak
memory, device ms of the port's kernels, the top kernels and the device ms
of the indexing and sorting kernels (a gather's scatter backward) of one
full-width training step in each variant (``phase_gm``, ``pallas``,
``fused``, ``dual``).  Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

from torch_field_ab import parse_args, run_turns, step_profiles, summarise

STENCIL = "gazenerf_tpu_torch/csrc/phase_stencil.cuh"

# name -> [(file in the tree, text, replacement)]: the attribution of the
# stencil kernels' time by what it costs to leave a part out
VARIANTS = {
    # K5 and K6 without their arithmetic and stores: the ring's copies alone
    "copies_only": [(STENCIL, "      if (w >= W) continue;", "      if (true) continue;")],
    # K5 and K6 without their row copies (the slots keep stale values)
    "no_copies": [(STENCIL, "    if (r <= h1) copy_run(", "    if (false) copy_run("),
                  (STENCIL, "    if (t <= h1)\n", "    if (false)\n")],
    # K5 and K6 without their shared-memory reads (constant taps)
    "no_smem_reads": [(STENCIL, "          load_vec<V>(rows[r] + cols[q], v, x);",
                       "          for (int u = 0; u < V; ++u) v[u] = (float)(u + q);"),
                      (STENCIL, "          load_vec<V>(rows[r] + qs[q] * s.ps + c0 * sz, v, dy);",
                       "          for (int u = 0; u < V; ++u) v[u] = (float)(u + q);")],
    # K5 and K6 without their stores (kept from dead-code removal by a test)
    "no_stores": [(STENCIL, "          store_vec<V>(yrow +", "          if (acc[i][j][0] == -1.5e38f) store_vec<V>(yrow +"),
                  (STENCIL, "          store_vec<V>(dxrow +", "          if (acc[i][j][0] == -1.5e38f) store_vec<V>(dxrow +")],
}

LEVELS = ("level0", "level1", "level2")
# the strip design's edge cases (kernels/checks.py STENCIL_CASES has them
# since this tool; an earlier tree's checks may not), hashed in every tree
EDGE_CASES = {"ragged": (2, 6, 70, 32), "odd": (1, 7, 9, 129), "one_pixel": (2, 1, 1, 8),
              "rows_off_16": (1, 5, 7, 5)}
BLOCKS = ("block0", "block1", "block2")


def digest(t) -> str:
    """A hash of a tensor's bytes."""
    import torch

    raw = t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def kernel_device_ms(cs, fn, n: int) -> dict:
    """Device ms per call of each CUDA kernel that ``n`` calls of ``fn``
    launch, by the kernel's name (up to its template arguments)."""
    prof = cs.device_profile(lambda: [fn() for _ in range(n)], top=50)
    out = {}
    for row in prof.get("top", []):
        name = row["kernel"].split("(")[0].split("<")[0].replace("void ", "")
        out[name] = out.get(name, 0.0) + row["ms"] / n
    return out


def child(args) -> dict:
    """Measure the tree on sys.path[0] (the child's working directory)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_stencil_ab: no CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from gazenerf_tpu_torch.kernels import build, checks
    from gazenerf_tpu_torch.kernels import fused_upsampler as fu
    from gazenerf_tpu_torch.kernels import shuffle_blur as sb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    logs = build.build({sb.KERNEL: sb.DEFINES, fu.KERNEL_FWD: fu.DEFINES})
    ptxas = [line.strip() for log in logs.values() for line in log.splitlines()
             if "Compiling entry" in line or "registers" in line or "spill" in line]
    dev = torch.device("cuda")
    out = {"label": args.label, "turn": args.turn, "card": smi, "ptxas": ptxas, "ms": {},
           "device_ms": {}, "digest": {}}
    with torch.no_grad():
        # the card's clocks ramp up under load: a second of the kernels first
        x, dy = checks.stencil_case(checks.STENCIL_CASES["level2"], dev)
        cs.cuda_ms(lambda: (sb.shuffle_blur_forward(x), sb.shuffle_blur_backward(dy)), iters=2000)
        for level in LEVELS:
            x, dy = checks.stencil_case(checks.STENCIL_CASES[level], dev)
            x1 = x[:1].contiguous()
            runs = {"K5": lambda: sb.shuffle_blur_forward(x),
                    "K6": lambda: sb.shuffle_blur_backward(dy),
                    "K5 B=1": lambda: sb.shuffle_blur_forward(x1)}
            for name, fn in runs.items():
                key = f"{name} {level}"
                out["ms"][key] = cs.cuda_ms(fn, args.iters)
                ks = kernel_device_ms(cs, fn, args.iters)
                out["device_ms"][key] = sum(v for k, v in ks.items() if "stencil::" in k)
        for block in BLOCKS:
            a, _ = checks.block_case(checks.BLOCK_CASES[block], dev)
            out["ms"][f"K7 {block}"] = cs.cuda_ms(lambda: fu.fused_upsample_forward(*a), args.iters)
            ks = kernel_device_ms(cs, lambda: fu.fused_upsample_forward(*a), args.iters)
            out["device_ms"][f"K7 stencil {block}"] = sum(
                v for k, v in ks.items() if "stencil::" in k)
            out["device_ms"][f"K7 chain {block}"] = sum(
                v for k, v in ks.items() if "chain_fwd_kernel" in k)
            del a
        for table in ("ms", "device_ms"):
            t = out[table]
            for name in ("K5", "K6", "K5 B=1"):
                if f"{name} level0" in t:
                    t[f"{name} pass"] = sum(t[f"{name} {lv}"] for lv in LEVELS)
        out["ms"]["K7 pass"] = sum(out["ms"][f"K7 {b}"] for b in BLOCKS)
        for part in ("stencil", "chain"):
            out["device_ms"][f"K7 {part} pass"] = sum(
                out["device_ms"][f"K7 {part} {b}"] for b in BLOCKS)
        # the outputs' bits, for a comparison between trees
        for case, shape in {**checks.STENCIL_CASES, **EDGE_CASES}.items():
            for dt in (torch.bfloat16, torch.float32):
                x, dy = checks.stencil_case(shape, dev, dt)
                out["digest"][f"K5 {case} {dt}"] = digest(sb.shuffle_blur_forward(x))
                out["digest"][f"K6 {case} {dt}"] = digest(sb.shuffle_blur_backward(dy))
        for case, shape in checks.BLOCK_CASES.items():
            a, _ = checks.block_case(shape, dev)
            out["digest"][f"K7 {case}"] = digest(fu.fused_upsample_forward(*a))
    if args.steps:
        out["step"] = step_profiles(cs, {"phase_gm": {}, "pallas": {"shuffle_mode": "pallas"},
                                         "fused": {"shuffle_mode": "fused"},
                                         "dual": cs.DUAL_FLAGS}, top=12)
    return out


def main() -> int:
    args = parse_args(__doc__)
    if args.child:
        print(json.dumps(child(args)))
        return 0
    results = run_turns(__file__, args, VARIANTS)
    summarise(results)
    # per output: do all the labels give the same bits?
    digests = {}
    for r in results:
        for k, v in r.get("digest", {}).items():
            digests.setdefault(k, set()).add(v)
    print(json.dumps({"digests_equal": {k: len(v) == 1 for k, v in digests.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
