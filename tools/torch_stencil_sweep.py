#!/usr/bin/env python3
"""Time the blur-shuffle stencil kernels (K5, K6 and K7's stencil launch) over
a grid of the launch plan's two choices (``kItems`` and ``kMaxSlot`` in
``gazenerf_tpu_torch/csrc/phase_stencil.cuh``) on one CUDA card.

    python tools/torch_stencil_sweep.py

Builds a small library around a copy of the header whose two constants
are variables that it sets (into ``build/``), then, at each of the
renderer's three stencil levels at B=2 (``kernels/checks.py``
``level0..2``) for K5 and K6 in bf16 and for K7's stencil launch (f32 in,
bf16 out), times the launch at every point of :data:`GRID` from a CUDA
graph of its launches (``chip_smoke.cuda_ms``; the host's time taken out).
Prints one JSON line per point, then a ``best`` line: per kernel the point
whose time summed over the levels is least, and the header's own point.
Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include "phase_stencil.cuh"
extern "C" void sweep_set(int items, int max_slot) {
  stencil::kItems = items;
  stencil::kMaxSlot = max_slot;
}
extern "C" int sweep_launch(const void* in, void* out, int B, int H, int W, int C, int kind,
                            void* stream) {
  typedef __nv_bfloat16 bf;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) return stencil::launch_fwd<bf, bf>(in, out, B, H, W, C, st);
  if (kind == 1) return stencil::launch_bwd<bf, bf>(in, out, B, H, W, C, st);
  return stencil::launch_fwd<float, bf>(in, out, B, H, W, C, st);
}
"""

GRID = {"kItems": (64, 128, 256, 512), "kMaxSlot": (4096, 8192, 16384, 32768, 65536)}
KERNELS = (("K5", 0), ("K6", 1), ("K7 stencil", 2))  # name, kind
LEVELS = ("level0", "level1", "level2")


def constant(text: str, name: str) -> str:
    """The header's line that sets ``name``."""
    return next(line for line in text.splitlines() if f"constexpr int {name} = " in line)


def library(header: str):
    """The library, built around the header with its constants made variables."""
    from gazenerf_tpu_torch.kernels import build

    for name in GRID:
        line = constant(header, name)
        header = header.replace(line, line.replace("constexpr int", "inline int"))
    out = build.BUILD_DIR / "stencil_sweep"
    out.mkdir(parents=True, exist_ok=True)
    (out / "phase_stencil.cuh").write_text(header)
    (out / "sweep.cu").write_text(SOURCE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(out), "-o", str(out / "lib.so"),
                    str(out / "sweep.cu")], check=True, stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(out / "lib.so"))
    lib.sweep_set.argtypes = [ctypes.c_int] * 2
    lib.sweep_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.sweep_launch.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_stencil_sweep: no CUDA device")
    import chip_smoke as cs
    from gazenerf_tpu_torch.kernels import build, checks

    header = (build.CSRC / "phase_stencil.cuh").read_text()
    lib = library(header)
    points = list(itertools.product(*GRID.values()))
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    ms = {}
    for level in LEVELS:
        B, H, W, C = checks.STENCIL_CASES[level]
        for name, kind in KERNELS:
            x, dy = checks.stencil_case((B, H, W, C), dev,
                                        torch.float32 if kind == 2 else torch.bfloat16)
            if kind == 1:
                inp, out = dy, torch.empty_like(x)
            else:
                inp, out = x, torch.empty(dy.shape, dtype=torch.bfloat16, device=dev)
            for point in points:
                lib.sweep_set(*point)

                def launch(point=point):
                    err = lib.sweep_launch(inp.data_ptr(), out.data_ptr(), B, H, W, C, kind,
                                           torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name} {level} {point}: CUDA error {err}")
                ms[name, level, point] = cs.cuda_ms(launch, 20, graph=True)
    for point in points:
        print(json.dumps({"point": dict(zip(GRID, point)),
                          "ms": {f"{n} {lv}": ms[n, lv, point] for n, _ in KERNELS
                                 for lv in LEVELS}}))
    own = tuple(int(constant(header, name).split("=")[1].split(";")[0]) for name in GRID)
    best = {}
    for name, _ in KERNELS:
        sums = {point: sum(ms[name, lv, point] for lv in LEVELS) for point in points}
        fast = min(sums, key=sums.get)
        best[name] = {"point": dict(zip(GRID, fast)), "ms": sums[fast],
                      "per_level": [ms[name, lv, fast] for lv in LEVELS],
                      "header_point": dict(zip(GRID, own)), "header_ms": sums.get(own)}
    print(json.dumps({"best": best, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
