"""Dual-branch fused field backward: both branches' gradient from the stash.

Counterpart of the JAX package's ``kernels/fused_field2_bwd.py`` (its
Pallas ``_bwd_kernel``, launched by ``dual_backward``): the gradient of the
dual-branch forward (``kernels/fused_field2.py``) for the face and the eye
field in one launch, reading the forward's bf16 activation stash instead of
recomputing the trunk, with the two branches' embedding, z-value and
segment-length cotangents summed in the kernel.  The kernel is hand-written
CUDA for Hopper (``csrc/fused_field2_bwd.cu``; its header states its bound,
design, scratch and determinism); :func:`fused_dual_backward_reference` is
its plain PyTorch version with the Pallas kernel's rounding points and
order of sums.

:func:`fused_dual_backward` is the wrapper: the kernel for CUDA tensors,
the plain version for CPU tensors.  The autograd ``Function`` that calls it
is :class:`~gazenerf_tpu_torch.kernels.fused_field2.FusedDual`.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence

import torch

from gazenerf_tpu_torch.kernels import build, field_dw
from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb
from gazenerf_tpu_torch.kernels.fused_field import FieldOperands, check_tensor
from gazenerf_tpu_torch.kernels.fused_field2 import N_BRANCHES, N_SLOTS, branch_operands

KERNEL = "fused_field2_bwd"
DEFINES = ffb.DEFINES
TILE_POINTS = ffb.TILE_POINTS  # the tile body is the single-branch kernel's
MAX_HIDDEN = ffb.MAX_HIDDEN

# kernel launches since import (or since a caller reset it); a training
# step with the stash makes one
launch_count = 0


class DualGrads(NamedTuple):
    """Cotangents of the dual forward's inputs: the per-point ones summed
    over the branches; the weight blocks and conditioning rows per branch on
    a leading axis of 2 (face, eyes), each block as in
    :class:`~gazenerf_tpu_torch.kernels.fused_field_bwd.FieldGrads`; f32."""

    dembed: torch.Tensor  # [B, R, S, De]
    dzvals: torch.Tensor  # [B, R, S]
    dzdists: torch.Tensor  # [B, R, S]
    dcb0: torch.Tensor  # [2, B, H]
    dcb5: torch.Tensor  # [2, B, H]
    dcbr1: torch.Tensor  # [2, B, H/2]
    dW0e: torch.Tensor  # [2, De, H]
    dWmid: torch.Tensor  # [2, 6, H, H]
    dbmid: torch.Tensor  # [2, 6, H]
    dW5e: torch.Tensor  # [2, De, H]
    dW5x: torch.Tensor  # [2, H, H]
    dWd: torch.Tensor  # [2, H, 1]
    dbd: torch.Tensor  # [2, 1]
    dWr0: torch.Tensor  # [2, H, H]
    dbr0: torch.Tensor  # [2, H]
    dWr1x: torch.Tensor  # [2, H, H/2]
    dWr2: torch.Tensor  # [2, H/2, C]
    dbr2: torch.Tensor  # [2, C]


_SHARED = ("dembed", "dzvals", "dzdists")


def sum_branches(per: Sequence[ffb.FieldGrads]) -> DualGrads:
    """Two branches' gradients as one :class:`DualGrads`: the per-point
    cotangents summed face then eye, the rest stacked."""
    f, e = per
    return DualGrads(**{
        name: (a + b) if name in _SHARED else torch.stack((a, b))
        for name, a, b in zip(ffb.FieldGrads._fields, f, e)
    })


def fused_dual_backward_reference(embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands,
                                  g_face, g_eye, stash, dtype=torch.float32) -> DualGrads:
    """Plain PyTorch version of the kernel: the single-branch plain backward
    in stash-read mode (``fused_field_backward_reference(..., stash=)``) per
    branch, the shared cotangents summed in the Pallas kernel's order:
    ``dembed`` as face ``fea_5``, eye ``fea_5``, face ``fea_0``, eye
    ``fea_0`` terms; ``dzvals`` and ``dzdists`` face then eye.  ``stash``:
    the face's and the eyes' ten bf16 activations.  ``dtype=torch.float64``
    computes between the same rounding points in float64."""
    parts = [ffb.fused_field_backward_parts(embed, zvals, zdists, cb0[i], cb5[i], cbr1[i],
                                            branch_operands(w, i), *g, dtype, stash[i])
             for i, g in enumerate((g_face, g_eye))]
    (f, f5, f0), (e, e5, e0) = parts
    d = sum_branches([f._replace(dembed=f5), e._replace(dembed=e5)])
    return d._replace(dembed=(d.dembed + f0) + e0)


@torch.enable_grad()  # also when called from a backward
def fused_dual_backward_unrounded(embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands,
                                  g_face, g_eye, dtype=torch.float64) -> DualGrads:
    """The gradient that the kernel and its plain version both approximate:
    the single-branch unrounded gradient
    (``fused_field_backward_unrounded``) per branch, summed.  It reads no
    stash: the stash only holds the forward's rounded activations."""
    return sum_branches([
        ffb.fused_field_backward_unrounded(embed, zvals, zdists, cb0[i], cb5[i], cbr1[i],
                                           branch_operands(w, i), *g, dtype=dtype)
        for i, g in enumerate((g_face, g_eye))
    ])


_ARGTYPES = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 13 + [ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL, DEFINES)
    lib.fused_field2_bwd.argtypes = _ARGTYPES
    lib.fused_field2_bwd.restype = ctypes.c_int
    lib.fused_field2_bwd_layout.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.fused_field2_bwd_layout.restype = None
    return lib


def _launch(embed, zvals, zdists, w: FieldOperands, g_face, g_eye, stash) -> DualGrads:
    global launch_count
    B, R, S, De = embed.shape
    NB, H, Kp = w.w0e.shape
    _, H2, C = w.wr2.shape
    dev = embed.device
    field_dw.check_samples(R, S)
    if H % 64 or H > MAX_HIDDEN or H2 * 2 != H:
        raise ValueError(f"hidden width {H} must be a multiple of 64, at most {MAX_HIDDEN}")
    if Kp % 32 or Kp < De:
        raise ValueError(f"padded embedding width {Kp} must be a multiple of 32, >= {De}")
    if NB != N_BRANCHES or len(stash) != NB or any(len(br) != N_SLOTS for br in stash):
        raise ValueError(f"{N_BRANCHES} branches, and the stash takes {N_SLOTS} tensors per branch")
    bf, f32 = torch.bfloat16, torch.float32
    bw = ffb.prepare_backward_operands(w)  # transposes the last two axes
    gfeat, gbga, gdepth, gw = (torch.stack(ts).contiguous() for ts in zip(g_face, g_eye))
    expected = {
        "embed": (embed, bf, (B, R, S, De)),
        "zvals": (zvals, f32, (B, R, S)),
        "zdists": (zdists, f32, (B, R, S)),
        "wd": (w.wd, bf, (NB, H)),
        "bd": (w.bd, f32, (NB, 1)),
        "wr2": (w.wr2, bf, (NB, H2, C)),
        "br2": (w.br2, f32, (NB, C)),
        "w0e_t": (bw.w0e_t, bf, (NB, Kp, H)),
        "wmid_t": (bw.wmid_t, bf, (NB, 6, H, H)),
        "w5e_t": (bw.w5e_t, bf, (NB, Kp, H)),
        "w5x_t": (bw.w5x_t, bf, (NB, H, H)),
        "wr0_t": (bw.wr0_t, bf, (NB, H, H)),
        "wr1x_t": (bw.wr1x_t, bf, (NB, H, H2)),
        "gfeat": (gfeat, f32, (NB, B, R, C)),
        "gbga": (gbga, f32, (NB, B, R)),
        "gdepth": (gdepth, f32, (NB, B, R)),
        "gw": (gw, f32, (NB, B, R, S)),
    }
    for name, (t, dtype, shape) in expected.items():
        check_tensor(name, t, dev, dtype, shape)
    for i, br in enumerate(stash):
        for k, a in enumerate(br):
            check_tensor(f"stash[{i}][{k}]", a, dev, bf, (B, R, S, H2 if k == N_SLOTS - 1 else H))
    lib = _library()
    # the single-branch backward's chunks and grid: the same weight-gradient bits
    chunks = field_dw.plan_chunks(B, R, S)
    G = ffb.persistent_ctas(dev, B * R * S // TILE_POINTS)
    chunk_tiles = chunks[0].tiles
    offsets, total, scratch_bytes = ffb.layout(lib.fused_field2_bwd_layout, B, S, Kp, H, C, G,
                                               chunk_tiles)
    scratch = torch.empty((scratch_bytes,), dtype=torch.uint8, device=dev)
    grads = torch.empty((NB, total), dtype=f32, device=dev)
    dembed = torch.empty((B, R, S, De), dtype=f32, device=dev)
    dzvals = torch.empty((B, R, S), dtype=f32, device=dev)
    dzdists = torch.empty((B, R, S), dtype=f32, device=dev)
    stash_ptrs = (ctypes.c_void_p * (NB * N_SLOTS))(*(a.data_ptr() for br in stash for a in br))
    ptrs = [t.data_ptr() for t, _, _ in expected.values()] + [stash_ptrs]
    ptrs += [t.data_ptr() for t in (dembed, dzvals, dzdists, scratch, grads)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for i, ch in enumerate(chunks):
        err = lib.fused_field2_bwd(*ptrs, B, R, S, De, Kp, H, C, G, chunk_tiles, ch.tile0,
                                   ch.tiles, i == 0, i == len(chunks) - 1, stream)
        if err:
            raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
    launch_count += 1

    blocks = {
        name: grads[:, o : o + math.prod(shape)].view(NB, *shape)
        for (name, shape), o in zip(ffb.grad_shapes(B, Kp, H, C).items(), offsets)
    }
    blocks["dW0e"], blocks["dW5e"] = blocks["dW0e"][:, :De], blocks["dW5e"][:, :De]
    return DualGrads(dembed=dembed, dzvals=dzvals, dzdists=dzdists, **blocks)


def fused_dual_backward(embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands, g_face, g_eye,
                        stash) -> DualGrads:
    """The kernel's wrapper.  CUDA tensors launch the kernel (on the current
    stream, no synchronisation); CPU tensors take
    :func:`fused_dual_backward_reference`.  ``embed`` is the bf16 embedding
    the forward read, ``w`` and the conditioning rows are stacked (face,
    eyes), ``g_face`` and ``g_eye`` the branches' four f32 cotangents and
    ``stash`` their ten stash tensors each.  The kernel reads no
    conditioning row: the stash holds what they went into."""
    args = (embed, zvals, zdists, cb0, cb5, cbr1, w, g_face, g_eye, stash)
    if embed.device.type == "cpu":
        return fused_dual_backward_reference(*args)
    if embed.device.type != "cuda":
        raise ValueError(f"no dual fused field backward kernel for device {embed.device}")
    return _launch(embed, zvals, zdists, w, g_face, g_eye, stash)
