#!/usr/bin/env python3
"""Time the PyTorch port's fused field forward kernels (K1, K3) and its
training step in several source trees on one CUDA card, in turns.

    python tools/torch_field_ab.py [--turns 2] [--iters 10] [--steps] SPEC [SPEC ...]

SPEC is ``LABEL=TREE`` or ``LABEL=TREE+VARIANT``: TREE a checkout of this
repository (``gazenerf_tpu_torch/`` and ``chip_smoke.py`` at its root, for
example the parent commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists), VARIANT one of :data:`VARIANTS`, a named set of text
edits applied to a copy of the tree under ``build/ab/`` (never to the tree
itself): the attribution of a kernel's time by what it costs to leave a part
out.  Each (tree, turn) runs in a child process with that tree's package on
``sys.path`` (its kernels built into its own ``build/``), in the order of the
specs and then reversed (A B, B A, ...), so that two trees are compared on
one card under the same conditions.  Per child it prints one JSON line: the
card, ``-Xptxas -v`` of the field kernels, K1 at B=1 (one 512^2 render's
shape, 4096 rays x 64 samples) and B=2 (the training step's), K3 at B=1
without and at B=2 with and without the stash, K2 at B=2 recomputing and
reading K1's stash with ``dens_vpu`` (ms per launch, CUDA events, hidden
384), ``digest``: a hash of each output of K1, K2 (recomputing and reading
the stash), K3 and K4 in ``kernels/checks.py``'s cases at S <= 64, and with
``--steps``, for the trees without a variant, the device time and peak
memory of one full-width training step, ``phase_gm`` and ``dual``.  The
last line, ``digests_equal``, says per output whether every tree gave the
same bits.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FWD = "gazenerf_tpu_torch/csrc/field_fwd.cuh"

# name -> [(file in the tree, text, replacement)]: each text must occur.
VARIANTS = {
    # the tile body with the weights streamed into a shared-memory ring by a
    # producer warp and the products on wgmma
    "no_products": [(FWD, "    if (on) {", "    if (false && on) {")],
    "no_compositing": [(FWD, "    // compositing: a warp per ray,",
                        "    if (kStash && tid == 0) asm volatile(\"cp.async.bulk.wait_group 0;\" ::: \"memory\");\n"
                        "    return;\n    // compositing: a warp per ray,")],
    "no_stash_stores": [(FWD, "        tma_store(map,", "        if (false) tma_store(map,")],
    # the earlier tile body, whose warps read their B fragments from global
    # memory with ldg32
    "ldg32_constant_b": [(FWD, "const uint32_t b0 = ldg32(q), b1 = ldg32(q + 8);",
                        "(void)q; const uint32_t b0 = 0x3c003c00u, b1 = 0x3c003c01u;")],
    "ldg32_no_compositing": [(FWD, "  // compositing: one thread per ray",
                            "  __syncthreads();\n  if (kStash) store_slot(slot(9, H2), X1, ldx, H2);\n"
                            "  return;\n  // compositing: one thread per ray")],
}


def prepare(label: str, spec: str, variants=None) -> Path:
    """The directory a child runs in: the tree itself, or a copy of its
    package and chip_smoke.py with the variant's edits (from ``variants``,
    :data:`VARIANTS` by default)."""
    tree, _, variant = spec.partition("+")
    tree = (ROOT / tree).resolve()
    if not variant:
        return tree
    out = ROOT / "build" / "ab" / label
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    shutil.copytree(tree / "gazenerf_tpu_torch", out / "gazenerf_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tree / "chip_smoke.py", out / "chip_smoke.py")
    for name, old, new in (variants or VARIANTS)[variant]:
        path = out / name
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"{label}: variant {variant}: text not found in {name}: {old!r}")
        path.write_text(text.replace(old, new))
    return out


def digest(t) -> str:
    """A hash of a tensor's bytes."""
    import torch

    raw = t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def digests(checks, ff, ffb, ff2, ffb2, dev) -> dict:
    """Per output of K1, K2 (recomputing; reading K1's stash, with and
    without ``dens_vpu``), K3 (with the stash: outputs and stash) and K4 in
    ``checks``' cases at S <= 64: the hash of its bits."""
    out = {}

    def put(prefix, names, tensors):
        for n, t in zip(names, tensors):
            out[f"{prefix} {n}"] = digest(t)

    import torch

    grads = ffb.FieldGrads._fields
    with torch.no_grad():
        for case in ("narrow", "medium", "wide", "training"):
            args, cot = checks.field_case(*checks.K2_CASES[case], dev)
            put(f"K1 {case}", checks.Outputs._fields, ff.fused_field_forward(*args))
            put(f"K2 {case}", grads, ffb.fused_field_backward(*args, *cot))
            if case in ("narrow", "training"):
                _, acts = ff.fused_field_forward(*args, stash=True)
                put(f"K1 stash {case}", checks.STASH_SLOTS, acts)
                for dv in (False, True):
                    put(f"K2 stash dens_vpu={dv} {case}", grads,
                        ffb.fused_field_backward(*args, *cot, stash=acts, dens_vpu=dv))
            del args, cot
        for case in checks.DUAL_CASES:
            dargs, g = checks.dual_case(*checks.DUAL_CASES[case], dev)
            outs, acts = ff2.fused_dual_forward(*dargs, stash=True)
            for i, br in enumerate(("face", "eyes")):
                put(f"K3 {case} {br}", checks.Outputs._fields, outs[i])
                put(f"K3 stash {case} {br}", checks.STASH_SLOTS, acts[i])
            d = ffb2.fused_dual_backward(*dargs, *g, acts)
            put(f"K4 {case}", d._fields, d)
            del dargs, g, outs, acts, d
    return out


def child(args) -> dict:
    """Measure the tree on sys.path[0] (the child's working directory)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_field_ab: no CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from gazenerf_tpu_torch.kernels import build, checks
    from gazenerf_tpu_torch.kernels import fused_field as ff
    from gazenerf_tpu_torch.kernels import fused_field2 as ff2
    from gazenerf_tpu_torch.kernels import fused_field2_bwd as ffb2
    from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    logs = build.build({m.KERNEL: m.DEFINES for m in (ff, ff2, ffb, ffb2)})
    ptxas = [line.strip() for log in logs.values() for line in log.splitlines()
             if "Compiling entry" in line or "registers" in line or "spill" in line]
    dev = torch.device("cuda")
    out = {"label": args.label, "turn": args.turn, "card": smi, "ptxas": ptxas, "ms": {}}
    with torch.no_grad():
        args2, cot2 = checks.field_case(384, 64, 4096, dev)
        _, acts2 = ff.fused_field_forward(*args2, stash=True)
        args1 = tuple(t[:1].contiguous() for t in args2[:6]) + (args2[6],)
        dargs, _ = checks.dual_case(384, 64, 4096, dev)
        dargs1 = (*(t[:1].contiguous() for t in dargs[:3]),
                  *(t[:, :1].contiguous() for t in dargs[3:6]), dargs[6])
        runs = {
            "K1 B=1": lambda: ff.fused_field_forward(*args1),
            "K1 B=2": lambda: ff.fused_field_forward(*args2),
            "K3 B=1 no stash": lambda: ff2.fused_dual_forward(*dargs1),
            "K3 B=2 stash": lambda: ff2.fused_dual_forward(*dargs, stash=True),
            "K3 B=2 no stash": lambda: ff2.fused_dual_forward(*dargs),
            "K2 B=2": lambda: ffb.fused_field_backward(*args2, *cot2),
            "K2 B=2 stash dens_vpu": lambda: ffb.fused_field_backward(
                *args2, *cot2, stash=acts2, dens_vpu=True),
        }
        for name, fn in runs.items():
            out["ms"][name] = cs.cuda_ms(fn, args.iters)
    del args2, cot2, acts2, args1, dargs, dargs1
    torch.cuda.empty_cache()
    out["digest"] = digests(checks, ff, ffb, ff2, ffb2, dev)
    if args.steps:
        out["step"] = step_profiles(cs, {"phase_gm": {}, "dual": cs.DUAL_FLAGS})
    return out


# kernels of PyTorch's indexing and sorting (a gather's scatter backward)
INDEX_KERNELS = ("index", "sort", "scatter", "gather")


def step_profiles(cs, variants: dict, top: int = 0) -> dict:
    """Per variant (name -> ModelConfig flags over the bf16 defaults): the
    device ms, wall ms, device ms per kernel and peak memory of one
    full-width training step after two warm-up steps (the caching
    allocator's peak, which rounds blocks and so depends on what was
    allocated before, and the peak of the bytes the tensors requested);
    given ``top``, also its ``top`` kernels by device time and the device ms
    of the indexing and sorting kernels (``INDEX_KERNELS``).  ``cs`` is the
    tree's chip_smoke module."""
    import dataclasses

    import torch

    from gazenerf_tpu_torch import Config, Trainer
    from gazenerf_tpu_torch.config import ModelConfig

    cfg = ModelConfig(compute_dtype="bfloat16", renderer_dtype="bfloat16")
    out = {}
    for name, flags in variants.items():
        torch.cuda.empty_cache()  # no blocks cached by earlier work
        mcfg = dataclasses.replace(cfg, **flags)
        tcfg = Config(model=mcfg)
        trainer = Trainer(tcfg, train_len=8, steps_per_epoch=1000, seed=0)
        batch = cs.synthetic_batch(0, tcfg.train.batch_size, mcfg.pred_img_size, mcfg.featmap_size)
        for _ in range(2):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # every kernel's row where the indexing kernels are summed
        prof = cs.device_profile(lambda: trainer.train_step(batch), mode=cs.renderer_mode(mcfg),
                                 top=100000 if top else 0)
        out[name] = {"device_ms": prof["device_ms"], "wall_ms": prof["wall_ms"],
                     "kernels_ms": prof.get("kernels_ms"),
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                     "peak_requested_bytes": torch.cuda.memory_stats()["requested_bytes.all.peak"]}
        if top and "top" in prof:
            rows = prof["top"]
            index = [r for r in rows if any(k in r["kernel"].lower() for k in INDEX_KERNELS)]
            out[name].update(top=rows[:top], index_ms=sum(r["ms"] for r in index),
                             index_kernels=index)
        del trainer
    return out


def run_turns(script: str, args, variants=None) -> list:
    """Prepare every spec of ``args.specs`` and run ``script --child`` in
    each tree for ``args.turns`` turns, in the specs' order and then
    reversed; ``--steps`` only for the trees without a variant.  Prints and
    returns each child's JSON line."""
    dirs, with_variant = {}, set()
    for spec in args.specs:
        label, _, rest = spec.partition("=")
        dirs[label] = prepare(label, rest, variants)
        if "+" in rest:
            with_variant.add(label)
    results = []
    for turn in range(args.turns):
        order = list(dirs) if turn % 2 == 0 else list(dirs)[::-1]
        for label in order:
            steps = args.steps and label not in with_variant
            cmd = [sys.executable, str(Path(script).resolve()), "--child", "--label", label,
                   "--turn", str(turn), "--iters", str(args.iters)] + (["--steps"] if steps else [])
            proc = subprocess.run(cmd, cwd=dirs[label], capture_output=True, text=True)
            if proc.returncode:
                print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"{label}, turn {turn}: exit {proc.returncode}")
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(line), flush=True)
            results.append(line)
    return results


def summarise(results: list) -> None:
    """Print the ``summary`` line: per label, each timing (of the ``ms`` and
    ``device_ms`` tables) and each step's device ms, peak GB (allocated and
    requested) and, where read, indexing kernels' ms over the turns."""
    summary = {}
    for r in results:
        s = summary.setdefault(r["label"], {})
        for table in ("ms", "device_ms"):
            for k, v in r.get(table, {}).items():
                s.setdefault(k if table == "ms" else f"{k} {table}", []).append(v)
        for k, v in r.get("step", {}).items():
            s.setdefault(f"{k} step device ms", []).append(v["device_ms"])
            s.setdefault(f"{k} step peak GB", []).append(v["peak_memory_bytes"] / 1e9)
            s.setdefault(f"{k} step peak requested GB", []).append(
                v["peak_requested_bytes"] / 1e9)
            if "index_ms" in v:
                s.setdefault(f"{k} step index ms", []).append(v["index_ms"])
    print(json.dumps({"summary": summary, "card": results[0]["card"]}))


def parse_args(doc: str):
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("specs", nargs="*")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--iters", type=int, default=10, help="timed launches per kernel")
    ap.add_argument("--steps", action="store_true", help="also time a training step")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--label", default="", help=argparse.SUPPRESS)
    ap.add_argument("--turn", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not args.child and not args.specs:
        ap.error("give at least one LABEL=TREE[+VARIANT]")
    return args


def main() -> int:
    args = parse_args(__doc__)
    if args.child:
        print(json.dumps(child(args)))
        return 0
    results = run_turns(__file__, args)
    summarise(results)
    # per output: do all the labels give the same bits?
    same = {}
    for r in results:
        for k, v in r.get("digest", {}).items():
            same.setdefault(k, set()).add(v)
    print(json.dumps({"digests_equal": {k: len(v) == 1 for k, v in same.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
