"""Dual-branch fused field forward: both field branches in one kernel.

Counterpart of the JAX package's ``kernels/fused_field2.py`` (its Pallas
``_fwd_kernel``, launched by ``_dual_forward``): the face and the eye field
of GazeNeRF, each the fused field forward of ``kernels/fused_field.py``
(field MLP + volume integration), on one shared embedding in one launch,
with the bf16 activation stash written under a gradient.  The kernel is
hand-written CUDA for Hopper (``csrc/fused_field2_fwd.cu``; its header
states its bound and design); :func:`fused_dual_reference` is its plain
PyTorch version with the same rounding points.

Call chain: :func:`stack_operands` (the two branches' kernel operands on a
leading axis of 2) -> :func:`fused_dual_render` (the per-call conditioning
prologue, and whether to stash) -> :func:`fused_dual_forward` (the wrapper:
the kernel for CUDA tensors, the plain version for CPU tensors), called
through the autograd :class:`FusedDual`.  Its backward is the dual
backward kernel on the stash (``kernels/fused_field2_bwd.py``) or, without
the stash, the single-branch backward kernel once per branch.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Sequence, Tuple

import torch

from gazenerf_tpu_torch.kernels import build
from gazenerf_tpu_torch.kernels import fused_field as ff
from gazenerf_tpu_torch.kernels.fused_field import WEIGHT_KEYS, FieldOperands

KERNEL = "fused_field2_fwd"
DEFINES = ff.DEFINES  # the tile body is the single-branch kernel's
N_BRANCHES = 2  # face, eyes
N_SLOTS = 10  # the stash per branch: x0..x7, y0b, y1

# kernel launches since import (or since a caller reset it); a render and
# a training step each make one
launch_count = 0


def stack_operands(ops: Sequence[FieldOperands]) -> FieldOperands:
    """The branches' kernel operands stacked on a leading axis of 2 (face,
    eyes), contiguous: what the dual kernels read."""
    with torch.no_grad():
        return FieldOperands(*(torch.stack(ts).contiguous() for ts in zip(*ops)))


def branch_operands(w: FieldOperands, i: int) -> FieldOperands:
    """Branch ``i``'s operands of a stacked :class:`FieldOperands` (views)."""
    return FieldOperands(*(t[i] for t in w))


def conditioning_rows(ps: Sequence[Mapping[str, torch.Tensor]], sc, ac):
    """The branches' conditioning rows (``fused_field.conditioning_rows``)
    stacked: ``cb0, cb5 [2, B, H]``, ``cbr1 [2, B, H/2]`` (JAX
    ``_stack_operands``)."""
    rows = [ff.conditioning_rows(p, sc, ac) for p in ps]
    return tuple(torch.stack(ts).contiguous() for ts in zip(*rows))


def fused_dual_reference(embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands,
                         stash: bool = False):
    """Plain PyTorch version of the kernel: the single-branch plain version
    (:func:`~gazenerf_tpu_torch.kernels.fused_field.fused_field_reference`)
    per branch on the shared embedding.  Returns ``(face, eyes)``, each
    ``(feat_int [B,R,C], bg_alpha [B,R], depth [B,R], weights [B,R,S])``;
    with ``stash``, ``((face, eyes), (face_acts, eye_acts))``, each acts the
    ten bf16 stash tensors x0..x7, y0b (``[B,R,S,H]``) and y1
    (``[B,R,S,H/2]``)."""
    outs = [ff.fused_field_reference(embed, zvals, zdists, cb0[i], cb5[i], cbr1[i],
                                     branch_operands(w, i), stash=stash)
            for i in range(N_BRANCHES)]
    if not stash:
        return tuple(outs)
    return tuple(o for o, _ in outs), tuple(a for _, a in outs)


_ARGTYPES = [ctypes.c_void_p] * 24 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL, DEFINES)
    lib.fused_field2_fwd.argtypes = _ARGTYPES
    lib.fused_field2_fwd.restype = ctypes.c_int
    return lib


def empty_stash(B, R, S, H, device) -> Tuple[Tuple[torch.Tensor, ...], ...]:
    """Both branches' stash tensors, views of one bf16 allocation of
    ``2 * (9 H + H/2)`` values per point (7,296 bytes per point and branch
    at hidden 384): slots x0..x7, y0b ``[B,R,S,H]`` and y1 ``[B,R,S,H/2]``
    per branch."""
    widths = [H] * (N_SLOTS - 1) + [H // 2]
    P = B * R * S
    buf = torch.empty(N_BRANCHES * P * sum(widths), dtype=torch.bfloat16, device=device)
    out, o = [], 0
    for _ in range(N_BRANCHES):
        acts = []
        for n in widths:
            acts.append(buf[o : o + P * n].view(B, R, S, n))
            o += P * n
        out.append(tuple(acts))
    return tuple(out)


def _launch(embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands, stash: bool):
    global launch_count
    B, R, S, De = embed.shape
    _, H, Kp = w.w0e.shape
    _, H2, C = w.wr2.shape
    dev = embed.device
    ff.check_shapes(R, S, H, H2, Kp, De)
    bf, f32 = torch.bfloat16, torch.float32
    NB = N_BRANCHES
    expected = {
        "embed": (embed, bf, (B, R, S, De)),
        "zvals": (zvals, f32, (B, R, S)),
        "zdists": (zdists, f32, (B, R, S)),
        "cb0": (cb0, f32, (NB, B, H)),
        "cb5": (cb5, f32, (NB, B, H)),
        "cbr1": (cbr1, f32, (NB, B, H2)),
        "w0e": (w.w0e, bf, (NB, H, Kp)),
        "wmid": (w.wmid, bf, (NB, 6, H, H)),
        "bmid": (w.bmid, f32, (NB, 6, H)),
        "w5e": (w.w5e, bf, (NB, H, Kp)),
        "w5x": (w.w5x, bf, (NB, H, H)),
        "wd": (w.wd, bf, (NB, H)),
        "bd": (w.bd, f32, (NB, 1)),
        "wr0": (w.wr0, bf, (NB, H, H)),
        "br0": (w.br0, f32, (NB, H)),
        "wr1x": (w.wr1x, bf, (NB, H2, H)),
        "wr2": (w.wr2, bf, (NB, H2, C)),
        "br2": (w.br2, f32, (NB, C)),
    }
    for name, (t, dtype, shape) in expected.items():
        ff.check_tensor(name, t, dev, dtype, shape)
    lib = _library()
    feat = torch.empty((NB, B, R, C), dtype=f32, device=dev)
    bga = torch.empty((NB, B, R), dtype=f32, device=dev)
    depth = torch.empty((NB, B, R), dtype=f32, device=dev)
    wts = torch.empty((NB, B, R, S), dtype=f32, device=dev)
    acts = empty_stash(B, R, S, H, dev) if stash else ()
    ptrs = (ctypes.c_void_p * (NB * N_SLOTS))(*(a.data_ptr() for br in acts for a in br))
    ins = [t for t, _, _ in expected.values()]
    # scratch for both branches' weight streams, packed by the call
    streams = torch.empty((NB, ff.stream_slices(H, Kp), ff.PASS_COLS, ff.SLICE_K), dtype=bf,
                          device=dev)
    err = lib.fused_field2_fwd(
        *(t.data_ptr() for t in ins), streams.data_ptr(),
        *(t.data_ptr() for t in (feat, bga, depth, wts)),
        ptrs if stash else None, B, R, S, De, Kp, H, C,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
    launch_count += 1
    outs = tuple((feat[i], bga[i], depth[i], wts[i]) for i in range(NB))
    return (outs, acts) if stash else outs


def fused_dual_forward(embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands,
                       stash: bool = False):
    """The kernel's wrapper.  CUDA tensors launch the kernel (on the current
    stream, no synchronisation); CPU tensors take
    :func:`fused_dual_reference`, whose results it returns in the same
    form.  ``w`` and the conditioning rows are stacked (face, eyes).  No
    autograd: :func:`fused_dual_render` wraps it in :class:`FusedDual`."""
    args = (embed, zvals, zdists, cb0, cb5, cbr1, w, stash)
    if embed.device.type == "cpu":
        return fused_dual_reference(*args)
    if embed.device.type != "cuda":
        raise ValueError(f"no dual fused field kernel for device {embed.device}")
    return _launch(*args)


class FusedDual(torch.autograd.Function):
    """Both field branches + integration with a hand-written backward (the
    JAX package's ``custom_vjp`` ``fused_dual_render``).

    Inputs: the stacked bf16 kernel operands (values), whether to stash,
    the embedding, z values, segment lengths, the stacked conditioning rows
    and the face's then the eyes' :data:`WEIGHT_KEYS` blocks (f32 views of
    the parameters, which receive the weight gradients).  Outputs: the
    face's four outputs, then the eyes'.

    The forward launches the dual forward kernel, with the stash when asked,
    and saves its inputs and the stash.  The backward is the dual backward
    kernel on the stash; without one (JAX differentiates its XLA twin per
    branch there, which the port has as a plain version only) it is the
    single-branch backward kernel, in recompute mode, once per branch, and
    the shared cotangents are summed face then eye: the same function.
    Autograd frees the saved stash when the backward has run."""

    @staticmethod
    def forward(ctx, ops: FieldOperands, stash: bool, embed, zvals, zdists, cb0, cb5, cbr1,
                *weights):
        e = embed.to(torch.bfloat16).contiguous()
        out = fused_dual_forward(e, zvals, zdists, cb0, cb5, cbr1, ops, stash=stash)
        acts = ()
        if stash:
            out, acts = out
            acts = tuple(a for br in acts for a in br)
        ctx.save_for_backward(e, zvals, zdists, cb0, cb5, cbr1, *ops, *acts)
        ctx.embed_dtype = embed.dtype
        return (*out[0], *out[1])

    @staticmethod
    def backward(ctx, *g):
        from gazenerf_tpu_torch.kernels import fused_field2_bwd as ffb2
        from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb

        e, zvals, zdists, cb0, cb5, cbr1, *rest = ctx.saved_tensors
        n = len(FieldOperands._fields)
        ops, acts = FieldOperands(*rest[:n]), rest[n:]
        B, R, S, _ = e.shape
        C = ops.br2.shape[-1]

        def cot(t, shape):  # an output no loss reads has no cotangent
            if t is None:
                return torch.zeros(shape, dtype=torch.float32, device=e.device)
            return t.to(torch.float32).contiguous()

        shapes = ((B, R, C), (B, R), (B, R), (B, R, S))
        gs = [tuple(cot(t, s) for t, s in zip(g[4 * i : 4 * i + 4], shapes))
              for i in range(N_BRANCHES)]
        if acts:
            stash = (tuple(acts[:N_SLOTS]), tuple(acts[N_SLOTS:]))
            d = ffb2.fused_dual_backward(e, zvals, zdists, cb0, cb5, cbr1, ops, *gs, stash)
        else:
            per = [ffb.fused_field_backward(e, zvals, zdists, cb0[i], cb5[i], cbr1[i],
                                            branch_operands(ops, i), *gs[i])
                   for i in range(N_BRANCHES)]
            d = ffb2.sum_branches(per)
        blocks = [d.dW0e, d.dWmid, d.dbmid, d.dW5e, d.dW5x, d.dWd, d.dbd,
                  d.dWr0, d.dbr0, d.dWr1x, d.dWr2, d.dbr2]
        return (
            None, None, d.dembed.to(ctx.embed_dtype), d.dzvals, d.dzdists, d.dcb0, d.dcb5,
            d.dcbr1, *(t[0] for t in blocks), *(t[1] for t in blocks),
        )


def fused_dual_render(ps: Sequence[Mapping[str, torch.Tensor]], ops: FieldOperands, embed,
                      sc, ac, zvals, zdists, stash_acts: bool = True):
    """Both field branches + integration in one kernel.

    ``ps``: the face's and the eyes' :func:`~gazenerf_tpu_torch.kernels.
    fused_field.split_params` blocks; ``ops`` their :func:`stack_operands`.
    The conditioning rows are built here, outside :class:`FusedDual`, so
    autograd folds their cotangents into the codes and the weight blocks.
    The stash is written only where a backward will read it: with
    ``stash_acts``, under a gradient, when some input requires one (as the
    JAX primal call skips it).  Returns ``(face, eyes)``, each
    ``(feat_int [B,R,C], bg_alpha [B,R], depth [B,R], weights [B,R,S])``.
    """
    cb0, cb5, cbr1 = conditioning_rows(ps, sc, ac)
    weights = [p[k] for p in ps for k in WEIGHT_KEYS]
    stash = stash_acts and torch.is_grad_enabled() and any(
        t.requires_grad for t in (embed, sc, ac, zvals, zdists, *weights))
    out = FusedDual.apply(
        ops, stash, embed, zvals.to(torch.float32).contiguous(),
        zdists.to(torch.float32).contiguous(), cb0, cb5, cbr1, *weights,
    )
    return out[:4], out[4:]
