"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled for
Hopper (``sm_90a``), with the ``-D`` defines its Python module gives, into
``build/gazenerf_tpu_torch/lib<name>_<hash>.so`` at the repository root, at
first use.  The hash covers the source, the shared headers (``csrc/*.cuh``),
the flags and the defines, so an edited source or header builds anew and a
stale library is never loaded.  Nothing is built or imported when this
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Mapping, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gazenerf_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _flags(defines: Mapping[str, int]) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{k}={v}" for k, v in sorted(defines.items()))


def library_path(name: str, defines: Mapping[str, int]) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(kernels: Mapping[str, Mapping[str, int]]) -> Dict[str, str]:
    """Compile every kernel (name -> defines) that is not built yet, all
    ``nvcc`` processes at once.  Returns the compiler's output per name
    (ptxas register and shared-memory report); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defines in kernels.items():
        target = library_path(name, defines)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *_flags(defines), "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            target,
        )
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
            os.unlink(tmp)
        else:
            os.replace(tmp, target)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def every_kernel() -> Dict[str, Mapping[str, int]]:
    """Every kernel source of the port (name -> defines), for a build of all
    of them at once."""
    from gazenerf_tpu_torch.kernels import (
        field_dw,
        fused_field,
        fused_field2,
        fused_field2_bwd,
        fused_field_bwd,
        fused_upsampler,
        shuffle_blur,
    )

    return {
        fused_field.KERNEL: fused_field.DEFINES,
        fused_field_bwd.KERNEL: fused_field_bwd.DEFINES,
        fused_field2.KERNEL: fused_field2.DEFINES,
        fused_field2_bwd.KERNEL: fused_field2_bwd.DEFINES,
        shuffle_blur.KERNEL: shuffle_blur.DEFINES,
        fused_upsampler.KERNEL_FWD: fused_upsampler.DEFINES,
        fused_upsampler.KERNEL_BWD: fused_upsampler.DEFINES,
        fused_upsampler.KERNEL_F32: fused_upsampler.DEFINES,
        field_dw.KERNEL: field_dw.DEFINES,
    }


def load(name: str, defines: Mapping[str, int]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.  The
    sources are hashed once per process: a kernel's wrapper calls this on
    every launch, and reading the sources again would cost more host time
    than a small launch takes on the card."""
    key = f"{name}:{sorted(defines.items())}"
    lib = _loaded.get(key)
    if lib is None:
        path = library_path(name, defines)
        build({name: defines})
        lib = ctypes.CDLL(str(path))
        _loaded[key] = lib
    return lib
