"""The fused field backward's weight gradients: a large-K GEMM over chunks.

The fused field backwards (``kernels/fused_field_bwd.py``, K2, and
``kernels/fused_field2_bwd.py``, K4) take the points in chunks of whole
64-point tiles and whole rays (:func:`plan_chunks`).  Per chunk their tile
kernel writes every layer's input ``X`` and bf16-rounded output cotangent
``D``, point-major, and the GEMM of ``csrc/field_dw.cuh`` adds ``X^T D`` over the chunk's points
into each weight gradient, chunk after chunk, in order.  It replaces the TPU
kernel's in-kernel accumulation (``gazenerf_tpu/kernels/fused_field_bwd.py``;
its ``split_dw`` epilogue computes the same contractions as XLA matmuls).

:func:`weight_grad_reference` is the GEMM's plain version and
:func:`chunked_weight_grad_reference` the chunked contraction in the
kernel's order; :func:`weight_grad` is the GEMM's wrapper (``csrc/field_dw.cu``,
the same device code the backwards launch under their own names), for tests
and timing: the kernel for CUDA tensors, the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence

import torch

from gazenerf_tpu_torch.kernels import build

KERNEL = "field_dw"
DEFINES: dict = {}
TILE_POINTS = 64  # points per tile of the backward's tile kernel
# tiles per chunk: four per CTA on a 132-SM card; at hidden 384 a chunk's
# operands and the GEMM's partial sums take ~0.53 GB (K2) against the 7.5 GB
# that all of a B=2 step's points would take at once
CHUNK_TILES = 528
MAX_JOBS = 12  # products per launch (csrc/field_dw.cuh, kMaxJobs)
MAX_SPLITS = 8  # point ranges per output tile, each with its partial sums (kMaxSplits)
POINT_STEP = 64  # the GEMM's points per stage: P must be a multiple

# kernel launches through weight_grad since import (or since a caller reset
# it); the backwards launch the same code themselves and count as theirs
launch_count = 0


class Chunk(NamedTuple):
    """A run of whole tiles: its tiles, points and rays, and the batches it
    spans (``first_batch`` to ``last_batch``, inclusive)."""

    tile0: int
    tiles: int
    point0: int
    points: int
    ray0: int
    rays: int
    first_batch: int
    last_batch: int


def check_samples(R: int, S: int) -> None:
    """Raise unless the backwards' tiles take rays of ``S`` samples
    (``fused_field.takes_samples``) and ``R * S`` points per batch fill
    whole tiles."""
    from gazenerf_tpu_torch.kernels import fused_field as ff

    if not ff.takes_samples(S):
        raise ValueError(ff.sample_rule(S))
    if (R * S) % TILE_POINTS:
        raise ValueError(f"the backward takes whole rays in whole tiles of {TILE_POINTS} "
                         f"points: R*S={R * S} must be a multiple of {TILE_POINTS}")


def plan_chunks(B: int, R: int, S: int, chunk_tiles: int = CHUNK_TILES) -> List[Chunk]:
    """The chunks of ``B * R * S`` points in 64-point tiles: ``chunk_tiles``
    tiles each (rounded down to whole rays when a ray spans tiles, S a
    multiple of 64), in order, the last one partial.  Either S divides 64
    and ``R * S`` is a multiple of 64, or S is a multiple of 64, so no tile
    spans a batch (a chunk may) and every chunk holds whole rays."""
    check_samples(R, S)
    if chunk_tiles < 1:
        raise ValueError(f"a chunk holds at least one tile, not {chunk_tiles}")
    per_ray = max(1, S // TILE_POINTS)  # tiles of a ray
    chunk_tiles = max(per_ray, chunk_tiles - chunk_tiles % per_ray)
    n_tiles = B * R * S // TILE_POINTS
    per_batch = R * S
    out = []
    for t0 in range(0, n_tiles, chunk_tiles):
        nt = min(chunk_tiles, n_tiles - t0)
        p0, n = t0 * TILE_POINTS, nt * TILE_POINTS
        out.append(Chunk(t0, nt, p0, n, p0 // S, n // S, p0 // per_batch,
                         (p0 + n - 1) // per_batch))
    return out


def weight_grad_reference(x: torch.Tensor, d: torch.Tensor, out: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain version of one product: ``x^T d`` in f32 over the rows of the
    bf16 ``x`` ``[P, M]`` and ``d`` ``[P, N]`` (every product of two bf16
    values is exact in f32), added to ``out`` when given.  float64 operands
    stay float64."""
    dt = torch.float64 if torch.float64 in (x.dtype, d.dtype) else torch.float32
    s = x.to(dt).t() @ d.to(dt)
    return s if out is None else out + s


def chunked_weight_grad_reference(x: torch.Tensor, d: torch.Tensor, chunks: Sequence[Chunk]
                                  ) -> torch.Tensor:
    """The chunked contraction in the kernels' order: ``x^T d`` summed over
    each chunk's points, the chunks' sums added in order into an f32
    ``[M, N]``.  ``x`` and ``d`` hold every point's row, point-major; ``d``
    is the bf16-rounded cotangent."""
    out = None
    for ch in chunks:
        rows = slice(ch.point0, ch.point0 + ch.points)
        out = weight_grad_reference(x[rows], d[rows], out)
    return out


_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL, DEFINES)
    lib.field_dw.argtypes = _ARGTYPES
    lib.field_dw.restype = ctypes.c_int
    return lib


def _launch(xs, ds, outs, accumulate: bool) -> None:
    global launch_count
    if not 1 <= len(xs) <= MAX_JOBS or len(xs) != len(ds) or len(xs) != len(outs):
        raise ValueError(f"1 to {MAX_JOBS} products, each with its x, d and out")
    P = xs[0].shape[0]
    dev = xs[0].device
    if P % POINT_STEP:
        raise ValueError(f"the GEMM takes points in steps of {POINT_STEP}, not {P}")
    for x, d, o in zip(xs, ds, outs):
        M, N = x.shape[1], d.shape[1]
        if M % 32 or N % 32:
            raise ValueError(f"widths {M} x {N} must be multiples of 32")
        for name, t, dtype, shape in (("x", x, torch.bfloat16, (P, M)),
                                      ("d", d, torch.bfloat16, (P, N)),
                                      ("out", o, torch.float32, (M, N))):
            if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {shape} "
                                 f"on {dev}")
    n = len(xs)
    ptrs = [(ctypes.c_void_p * n)(*(t.data_ptr() for t in ts)) for ts in (xs, ds, outs)]
    dims = [(ctypes.c_int * n)(*(t.shape[1] for t in ts)) for ts in (xs, ds)]
    part = torch.empty((MAX_SPLITS * sum(o.numel() for o in outs),), dtype=torch.float32,
                       device=dev)
    err = _library().field_dw(n, *ptrs, *dims, P, int(accumulate), part.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
    launch_count += 1


def weight_grad(xs: Sequence[torch.Tensor], ds: Sequence[torch.Tensor],
                outs: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
    """The GEMM's wrapper: ``outs[j] (+)= xs[j]^T ds[j]`` for up to 12
    products over the same points (bf16 ``[P, M]`` and ``[P, N]``, f32
    ``[M, N]``), added to ``outs`` when given, else into new tensors.  CUDA
    tensors launch the kernel (on the current stream, no synchronisation);
    CPU tensors take :func:`weight_grad_reference`."""
    if xs[0].device.type == "cpu":
        if outs is None:
            return [weight_grad_reference(x, d) for x, d in zip(xs, ds)]
        for x, d, o in zip(xs, ds, outs):
            o.copy_(weight_grad_reference(x, d, o))
        return list(outs)
    if xs[0].device.type != "cuda":
        raise ValueError(f"no weight-gradient kernel for device {xs[0].device}")
    accumulate = outs is not None
    if outs is None:
        outs = [torch.empty((x.shape[1], d.shape[1]), dtype=torch.float32, device=x.device)
                for x, d in zip(xs, ds)]
    _launch(list(xs), list(ds), list(outs), accumulate)
    return list(outs)
