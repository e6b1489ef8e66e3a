#!/usr/bin/env python3
"""Time the PyTorch port's fused upsampler kernels (K7, K8) and its
training step in several source trees on one CUDA card, in turns.

    python tools/torch_upsampler_ab.py [--turns 2] [--iters 10] [--steps] SPEC [SPEC ...]

SPEC is ``LABEL=TREE`` or ``LABEL=TREE+VARIANT``, as for
``tools/torch_field_ab.py`` (whose tree preparation and turn order this tool
shares), VARIANT one of :data:`VARIANTS`.  Per child it prints one JSON
line: the card, ``-Xptxas -v`` of the three libraries (K7 and K8 in bf16,
and both at f32), K7 and K8 (ms per launch, CUDA events) at each of the
renderer's three upsample blocks at B=2 (``kernels/checks.py``
``block0..2``) and K7 at the serving shape (B=1), in bf16 and at f32
(``use_bf16=False``, the f32 renderer: keys ``K7 f32 ...``), the sums over
the blocks (``... pass``), the device ms per CUDA kernel of one call of each
(``torch.profiler``), and with ``--steps``, for the trees without a variant,
the device time, device ms per kernel and peak memory of one full-width
training step in each variant (``phase_gm``, ``pallas``, ``fused``, ``dual``,
``fused_f32``); ``digest``: a hash of each output of K7 and K8 in bf16 in
every case of ``kernels/checks.py`` ``BLOCK_CASES`` and at f32 in every case
of ``F32_BLOCK_CASES``.  The last line, ``digests_equal``, says per output
whether every tree gave the same bits.  Imports nothing of JAX.

For the f32 block against the parent commit, with the parent unpacked by
``git archive`` into ``build/parent``:

    python tools/torch_upsampler_ab.py --turns 2 parent=build/parent change=.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

from torch_field_ab import digest, parse_args, run_turns, step_profiles, summarise

BWD = "gazenerf_tpu_torch/csrc/fused_upsampler_bwd.cu"
FWD = "gazenerf_tpu_torch/csrc/fused_upsampler_fwd.cu"
TILE = "gazenerf_tpu_torch/csrc/tile_mma.cuh"

# name -> [(file in the tree, text, replacement)]: each text must occur, and
# every occurrence is replaced.  The attribution of the earlier kernels, for
# a checkout from before the chain body (one 32-pixel tile of 8 warps,
# weight fragments read from global memory, weight gradients in per-CTA
# slabs), by what it costs to leave a part out.
VARIANTS = {
    # K8 without its weight gradients' slab read-modify-writes
    "slab_no_outer_acc": [(BWD, "tile::outer_acc(", "if (false) tile::outer_acc(")],
    # K7 and K8 with their B fragments from a constant in place of ldg32
    "slab_constant_b": [(TILE, "mma16816(acc[ni], a, ldg32(q), ldg32(q + 8));",
                         "(void)q; mma16816(acc[ni], a, 0x3c003c00u, 0x3c003c01u);")],
    # K7 without the stencil launch after the chain
    "slab_no_stencil": [(FWD, "  return y_bf16 ? stencil::launch_fwd",
                         "  return 0;\n  return y_bf16 ? stencil::launch_fwd")],
}

CHAIN = "gazenerf_tpu_torch/csrc/upsampler_chain.cuh"
# The attribution of the chain body's kernels (csrc/upsampler_chain.cuh)
VARIANTS.update({
    # K7 and K8 without their products (the accumulators stay zero)
    "no_products": [(CHAIN, "        if (on) {\n          const uint32_t a =",
                     "        if (false && on) {\n          const uint32_t a =")],
    # K7 and K8 without the weights' tensor copies (the stages keep stale
    # values; the barriers complete on the producer's arrival)
    "no_weight_copies": [(CHAIN, "m.box_rows[sg.map] * kSliceK * 2 + (stream_a ? abytes : 0)", "0"),
                         (CHAIN, "        tma_load_2d(ring.b(st),",
                          "        if (false) tma_load_2d(ring.b(st),"),
                         (CHAIN, "        if (stream_a && sg.aplane >= 0)", "        if (false)"),
                         (CHAIN, "        else if (stream_a)", "        else if (false)")],
    # K7 and K8 without their epilogues
    "no_epilogues": [(CHAIN, "    epi(p, col0, on, acc);",
                      "    if (false) epi(p, col0, on, acc);")],
    # K8 without the residual's gather
    "no_residual": [(BWD, "  for (int k = 0; k < 4; ++k) {  // branch-free",
                     "  for (int k = 0; k < 0; ++k) {  // branch-free")],
    # K8 without the stencil's adjoint (dz3 zero)
    "no_adjoint": [(BWD, "const bool on = px < P && c < F3;", "const bool on = false;")],
    # K8 without the weight-gradient GEMM
    "no_dw_gemm": [(BWD, "dw_launch(j, st)", "0")],
    # K7 without the z3 scratch's stores
    "no_z3_stores": [(FWD, "if (c < F3) o[0]", "if (false) o[0]"),
                     (FWD, "if (c + 1 < F3) o[1]", "if (false) o[1]")],
})

# all three at once: what is left is the ring's handshakes, the barriers and
# the work outside the products
VARIANTS["skeleton"] = (VARIANTS["no_products"] + VARIANTS["no_weight_copies"]
                        + VARIANTS["no_epilogues"])

BLOCKS = ("block0", "block1", "block2")


def child(args) -> dict:
    """Measure the tree on sys.path[0] (the child's working directory)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_upsampler_ab: no CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from gazenerf_tpu_torch.kernels import build, checks
    from gazenerf_tpu_torch.kernels import fused_upsampler as fu

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    logs = build.build({fu.KERNEL_FWD: fu.DEFINES, fu.KERNEL_BWD: fu.DEFINES,
                        fu.KERNEL_F32: fu.DEFINES})
    ptxas = [line.strip() for log in logs.values() for line in log.splitlines()
             if "Compiling entry" in line or "registers" in line or "spill" in line]
    dev = torch.device("cuda")
    out = {"label": args.label, "turn": args.turn, "card": smi, "ptxas": ptxas, "ms": {}}
    with torch.no_grad():
        # the card's clocks ramp up under load: a second of both kernels first
        a, dy = checks.block_case(checks.BLOCK_CASES["block1"], dev)
        cs.cuda_ms(lambda: (fu.fused_upsample_forward(*a), fu.fused_upsample_backward(*a, dy)),
                   iters=200, warmup=1)
        for block in BLOCKS:
            a, dy = checks.block_case(checks.BLOCK_CASES[block], dev)
            out["ms"][f"K7 {block}"] = cs.cuda_ms(lambda: fu.fused_upsample_forward(*a), args.iters)
            out["ms"][f"K8 {block}"] = cs.cuda_ms(lambda: fu.fused_upsample_backward(*a, dy),
                                                  args.iters)
            for k, fn in (("K7", lambda: fu.fused_upsample_forward(*a)),
                          ("K8", lambda: fu.fused_upsample_backward(*a, dy))):
                prof = cs.device_profile(fn, top=12)
                out.setdefault("profile", {})[f"{k} {block}"] = {
                    "wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
                    "kernels": {r["kernel"]: r["ms"] for r in prof.get("top", [])}}
            a1 = (a[0][:1].contiguous(), *a[1:])
            out["ms"][f"K7 {block} B=1"] = cs.cuda_ms(lambda: fu.fused_upsample_forward(*a1),
                                                      args.iters)
            del a, dy, a1
        for block in BLOCKS:
            a, dy = checks.f32_block_case(checks.BLOCK_CASES[block], dev)
            fwd = lambda: fu.fused_upsample_forward(*a, use_bf16=False)  # noqa: E731
            bwd = lambda: fu.fused_upsample_backward(*a, dy, use_bf16=False)  # noqa: E731
            out["ms"][f"K7 f32 {block}"] = cs.cuda_ms(fwd, args.iters)
            out["ms"][f"K8 f32 {block}"] = cs.cuda_ms(bwd, args.iters)
            for k, fn in (("K7 f32", fwd), ("K8 f32", bwd)):
                prof = cs.device_profile(fn, top=12)
                out["profile"][f"{k} {block}"] = {
                    "wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
                    "kernels": {r["kernel"]: r["ms"] for r in prof.get("top", [])}}
            a1 = (a[0][:1].contiguous(), *a[1:])
            out["ms"][f"K7 f32 {block} B=1"] = cs.cuda_ms(
                lambda: fu.fused_upsample_forward(*a1, use_bf16=False), args.iters)
            del a, dy, a1, fwd, bwd
        for k in ("K7", "K8", "K7 f32", "K8 f32"):
            out["ms"][f"{k} pass"] = sum(out["ms"][f"{k} {b}"] for b in BLOCKS)
        for k in ("K7", "K7 f32"):
            out["ms"][f"{k} pass B=1"] = sum(out["ms"][f"{k} {b} B=1"] for b in BLOCKS)
        out["digest"] = {}
        for case in checks.BLOCK_CASES:
            a, dy = checks.block_case(checks.BLOCK_CASES[case], dev)
            out["digest"][f"K7 {case} out"] = digest(fu.fused_upsample_forward(*a))
            g = fu.fused_upsample_backward(*a, dy)
            for n, t in zip(g._fields, g):
                out["digest"][f"K8 {case} {n}"] = digest(t)
            del a, dy, g
        for case in checks.F32_BLOCK_CASES:
            a, dy = checks.f32_block_case(checks.BLOCK_CASES[case], dev)
            out["digest"][f"K7 f32 {case} out"] = digest(
                fu.fused_upsample_forward(*a, use_bf16=False))
            g = fu.fused_upsample_backward(*a, dy, use_bf16=False)
            for n, t in zip(g._fields, g):
                out["digest"][f"K8 f32 {case} {n}"] = digest(t)
            del a, dy, g
    if args.steps:
        out["step"] = step_profiles(cs, {"phase_gm": {}, "pallas": {"shuffle_mode": "pallas"},
                                         "fused": {"shuffle_mode": "fused"},
                                         "dual": cs.DUAL_FLAGS,
                                         cs.FUSED_F32: cs.FUSED_F32_FLAGS})
    return out


def main() -> int:
    args = parse_args(__doc__)
    if args.child:
        print(json.dumps(child(args)))
        return 0
    results = run_turns(__file__, args, VARIANTS)
    summarise(results)
    same = {}
    for r in results:
        for k, v in r.get("digest", {}).items():
            same.setdefault(k, set()).add(v)
    print(json.dumps({"digests_equal": {k: len(v) == 1 for k, v in same.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
