"""Fused field backward: the gradient of the fused field forward.

Counterpart of the JAX package's ``kernels/fused_field_bwd.py`` (its Pallas
``_bwd_kernel``, launched by ``pallas_backward``) in recompute mode: no
activation stash, the weight gradients computed in the kernel.  The kernel
is hand-written CUDA for Hopper (``csrc/fused_field_bwd.cu``; its header
states its bound, design, scratch and determinism);
:func:`fused_field_backward_reference` is its plain PyTorch version with
the Pallas kernel's rounding points.

:func:`fused_field_backward` is the wrapper: the kernel for CUDA tensors,
the plain version for CPU tensors.  The autograd ``Function`` that calls it
is in ``kernels/fused_field.py``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple

import torch

from gazenerf_tpu_torch.kernels import build
from gazenerf_tpu_torch.kernels.fused_field import FieldOperands, check_tensor
from gazenerf_tpu_torch.ops.integrate import exclusive_transmittance, integrate_rays

KERNEL = "fused_field_bwd"
DEFINES: Dict[str, int] = {}
TILE_POINTS = 64  # points per tile in the kernel (whole rays)
MAX_HIDDEN = 384  # one pass of the kernel's 16 warps covers 384 columns
_EPS = 1e-10

# kernel launches since import (or since a caller reset it); a training
# step makes two, one per field branch
launch_count = 0


class BackwardOperands(NamedTuple):
    """The data-gradient products' weights, bf16 ``[in, out]``: the
    transposes of the forward operands."""

    w0e_t: torch.Tensor  # [Kp, H]
    wmid_t: torch.Tensor  # [6, H, H]
    w5e_t: torch.Tensor  # [Kp, H]
    w5x_t: torch.Tensor  # [H, H]
    wr0_t: torch.Tensor  # [H, H]
    wr1x_t: torch.Tensor  # [H, H/2]


class FieldGrads(NamedTuple):
    """Cotangents of the fused field's inputs; weight blocks in the
    ``[in, out]`` layout of :func:`~gazenerf_tpu_torch.kernels.fused_field.
    split_params`, f32."""

    dembed: torch.Tensor  # [B, R, S, De]
    dzvals: torch.Tensor  # [B, R, S]
    dzdists: torch.Tensor  # [B, R, S]
    dcb0: torch.Tensor  # [B, H]
    dcb5: torch.Tensor  # [B, H]
    dcbr1: torch.Tensor  # [B, H/2]
    dW0e: torch.Tensor  # [De, H]
    dWmid: torch.Tensor  # [6, H, H]
    dbmid: torch.Tensor  # [6, H]
    dW5e: torch.Tensor  # [De, H]
    dW5x: torch.Tensor  # [H, H]
    dWd: torch.Tensor  # [H, 1]
    dbd: torch.Tensor  # [1]
    dWr0: torch.Tensor  # [H, H]
    dbr0: torch.Tensor  # [H]
    dWr1x: torch.Tensor  # [H, H/2]
    dWr2: torch.Tensor  # [H/2, C]
    dbr2: torch.Tensor  # [C]


def prepare_backward_operands(w: FieldOperands) -> BackwardOperands:
    def t(x):
        return x.transpose(-1, -2).contiguous()

    return BackwardOperands(
        w0e_t=t(w.w0e), wmid_t=t(w.wmid), w5e_t=t(w.w5e),
        w5x_t=t(w.w5x), wr0_t=t(w.wr0), wr1x_t=t(w.wr1x),
    )


def fused_field_backward_reference(
    embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands, gfeat, gbga, gdepth, gw,
    dtype=torch.float32,
) -> FieldGrads:
    """Plain PyTorch version of the kernel, with the Pallas kernel's
    formulas and rounding points: the forward recomputed with K1's bf16
    rounding; f32 data gradients; weight gradients as products of the bf16
    activation and the bf16-rounded cotangent, summed in f32; f32 bias and
    conditioning-row sums.  ``embed`` is bf16 (its values are what the
    kernel reads); every output is f32.  ``dtype=torch.float64`` computes
    between the same rounding points in float64 instead."""
    f32 = dtype
    B, R, S, De = embed.shape

    def rnd(t):  # a bf16 rounding point
        return t.to(torch.bfloat16).to(f32)

    def dense(x, w_out_in):  # x @ W, W stored [out, in]
        return x @ w_out_in.to(f32).t()

    def dgrad(g, w_out_in):  # g @ W^T
        return g @ w_out_in.to(f32)

    def outer(x, g):  # x^T @ bf16(g) over every point of every batch
        return x.reshape(-1, x.shape[-1]).t() @ rnd(g).reshape(-1, g.shape[-1])

    # ---- recompute ----
    e = rnd(embed.reshape(B, R * S, De))
    acts = [rnd(torch.relu(dense(e, w.w0e[:, :De]) + cb0[:, None, :]))]
    mid = 0
    for i in range(1, 8):
        if i == 5:
            y = dense(e, w.w5e[:, :De]) + dense(acts[4], w.w5x) + cb5[:, None, :]
        else:
            y = dense(acts[-1], w.wmid[mid]) + w.bmid[mid]
            mid += 1
        acts.append(rnd(torch.relu(y)))
    x7 = acts[7]
    dens_pre = x7 @ w.wd.to(f32) + w.bd  # [B, N]
    sigma = torch.relu(dens_pre).reshape(B, R, S)
    y0b = rnd(dense(x7, w.wr0) + w.br0)
    y1 = rnd(torch.relu(dense(y0b, w.wr1x) + cbr1[:, None, :]))
    feat = (y1 @ w.wr2.to(f32) + w.br2).reshape(B, R, S, -1)

    expterm = torch.exp(-sigma * zdists)
    alpha = 1.0 - expterm
    trans = exclusive_transmittance(alpha)
    wts = alpha * trans

    # ---- integration backward ----
    dfeat = wts[..., None] * gfeat[:, :, None, :]  # [B, R, S, C]
    dw = (feat * gfeat[:, :, None, :]).sum(-1) + zvals * gdepth[..., None] - gbga[..., None] + gw
    wdw = wts * dw
    suffix = torch.flip(torch.cumsum(torch.flip(wdw, (-1,)), -1), (-1,)) - wdw  # sum over t > s
    dalpha = dw * trans - suffix / (1.0 - alpha + _EPS)
    dsigma = dalpha * zdists * expterm
    dzdists = dalpha * sigma * expterm
    dzvals = wts * gdepth[..., None]

    # ---- head backward ----
    dpre_dens = torch.where(dens_pre > 0.0, dsigma.reshape(B, R * S), 0.0)
    dfeat = dfeat.reshape(B, R * S, -1)
    dy1 = torch.where(y1 > 0.0, dfeat @ w.wr2.to(f32).t(), 0.0)
    dy0 = dgrad(dy1, w.wr1x)
    dx = dpre_dens[..., None] * w.wd.to(f32) + dgrad(dy0, w.wr0)
    dWr2 = outer(y1, dfeat)
    dWr1x = outer(y0b, dy1)
    dWr0 = outer(x7, dy0)
    dWd = outer(x7, dpre_dens[..., None])

    # ---- trunk backward ----
    dWmid, dbmid = [None] * 6, [None] * 6
    mid = 5
    for i in range(7, 0, -1):
        dpre = torch.where(acts[i] > 0.0, dx, 0.0)
        if i == 5:
            dW5e = outer(e, dpre)
            dW5x = outer(acts[4], dpre)
            dcb5 = dpre.sum(1)
            dembed = dpre @ w.w5e[:, :De].to(f32)
            dx = dgrad(dpre, w.w5x)
        else:
            dWmid[mid] = outer(acts[i - 1], dpre)
            dbmid[mid] = dpre.sum((0, 1))
            dx = dgrad(dpre, w.wmid[mid])
            mid -= 1
    dpre = torch.where(acts[0] > 0.0, dx, 0.0)
    dW0e = outer(e, dpre)
    dembed = dembed + dpre @ w.w0e[:, :De].to(f32)

    return FieldGrads(
        dembed=dembed.reshape(B, R, S, De), dzvals=dzvals, dzdists=dzdists,
        dcb0=dpre.sum(1), dcb5=dcb5, dcbr1=dy1.sum(1),
        dW0e=dW0e, dWmid=torch.stack(dWmid), dbmid=torch.stack(dbmid),
        dW5e=dW5e, dW5x=dW5x, dWd=dWd, dbd=dpre_dens.sum().reshape(1),
        dWr0=dWr0, dbr0=dy0.sum((0, 1)), dWr1x=dWr1x, dWr2=dWr2,
        dbr2=dfeat.sum((0, 1)),
    )


@torch.enable_grad()  # also when called from a backward
def fused_field_backward_unrounded(
    embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands, gfeat, gbga, gdepth, gw,
    dtype=torch.float64,
) -> FieldGrads:
    """The gradient that the kernel and its plain version both approximate:
    autograd in ``dtype`` of the same field (the bf16 operands' values) and
    volume integration, with no rounding point.  Rays go through in chunks
    of 512, which bounds the memory autograd keeps (a few GB at hidden 384
    in float64).  Every output is in ``dtype``."""
    B, R, S, De = embed.shape
    P = {k: getattr(w, k).detach().to(dtype).requires_grad_(True) for k in w._fields}
    conds = [t.detach().to(dtype).requires_grad_(True) for t in (cb0, cb5, cbr1)]
    c0, c5, cr1 = (t[:, None, None, :] for t in conds)
    weights = list(P.values())
    sums = [torch.zeros_like(t) for t in conds + weights]
    per_point = []
    for r0 in range(0, R, 512):
        rays = slice(r0, r0 + 512)
        e, zv, zd = (t[:, rays].detach().to(dtype).requires_grad_(True)
                     for t in (embed, zvals, zdists))
        x = torch.relu(e @ P["w0e"][:, :De].t() + c0)
        mid = 0
        for i in range(1, 8):
            if i == 5:
                x = torch.relu(e @ P["w5e"][:, :De].t() + x @ P["w5x"].t() + c5)
            else:
                x = torch.relu(x @ P["wmid"][mid].t() + P["bmid"][mid])
                mid += 1
        sigma = torch.relu(x @ P["wd"] + P["bd"])
        y1 = torch.relu((x @ P["wr0"].t() + P["br0"]) @ P["wr1x"].t() + cr1)
        out = integrate_rays(y1 @ P["wr2"] + P["br2"], sigma, zd, zv)
        cot = (gfeat[:, rays], gbga[:, rays], gdepth[:, rays], gw[:, rays])
        loss = sum((o * c.to(dtype)).sum() for o, c in zip(out, cot))
        g = torch.autograd.grad(loss, [e, zv, zd] + conds + weights)
        per_point.append(g[:3])
        for acc, t in zip(sums, g[3:]):
            acc += t
    dembed, dzvals, dzdists = (torch.cat(ts, 1) for ts in zip(*per_point))
    dcb0, dcb5, dcbr1 = sums[:3]
    d = dict(zip(P, sums[3:]))
    return FieldGrads(
        dembed=dembed, dzvals=dzvals, dzdists=dzdists, dcb0=dcb0, dcb5=dcb5, dcbr1=dcbr1,
        dW0e=d["w0e"][:, :De].t(), dWmid=d["wmid"].transpose(1, 2), dbmid=d["bmid"],
        dW5e=d["w5e"][:, :De].t(), dW5x=d["w5x"].t(), dWd=d["wd"][:, None], dbd=d["bd"],
        dWr0=d["wr0"].t(), dbr0=d["br0"], dWr1x=d["wr1x"].t(), dWr2=d["wr2"], dbr2=d["br2"],
    )


_ARGTYPES = [ctypes.c_void_p] * 34 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL, DEFINES)
    lib.fused_field_bwd.argtypes = _ARGTYPES
    lib.fused_field_bwd.restype = ctypes.c_int
    lib.fused_field_bwd_slab_offsets.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.fused_field_bwd_slab_offsets.restype = None
    return lib


def _launch(embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands, gfeat, gbga, gdepth, gw
            ) -> FieldGrads:
    global launch_count
    B, R, S, De = embed.shape
    H, Kp = w.w0e.shape
    H2, C = w.wr2.shape
    dev = embed.device
    if S <= 0 or TILE_POINTS % S or (R * S) % TILE_POINTS:
        raise ValueError(
            f"the kernel takes whole rays in tiles of {TILE_POINTS} points: S={S} must "
            f"divide {TILE_POINTS} and R*S={R * S} be a multiple of it"
        )
    if H % 64 or H > MAX_HIDDEN or H2 * 2 != H:
        raise ValueError(f"hidden width {H} must be a multiple of 64, at most {MAX_HIDDEN}")
    if Kp % 32 or Kp < De:
        raise ValueError(f"padded embedding width {Kp} must be a multiple of 32, >= {De}")
    bf, f32 = torch.bfloat16, torch.float32
    bw = prepare_backward_operands(w)
    expected = {
        "embed": (embed, bf, (B, R, S, De)),
        "zvals": (zvals, f32, (B, R, S)),
        "zdists": (zdists, f32, (B, R, S)),
        "cb0": (cb0, f32, (B, H)),
        "cb5": (cb5, f32, (B, H)),
        "cbr1": (cbr1, f32, (B, H2)),
        "w0e": (w.w0e, bf, (H, Kp)),
        "wmid": (w.wmid, bf, (6, H, H)),
        "bmid": (w.bmid, f32, (6, H)),
        "w5e": (w.w5e, bf, (H, Kp)),
        "w5x": (w.w5x, bf, (H, H)),
        "wd": (w.wd, bf, (H,)),
        "bd": (w.bd, f32, (1,)),
        "wr0": (w.wr0, bf, (H, H)),
        "br0": (w.br0, f32, (H,)),
        "wr1x": (w.wr1x, bf, (H2, H)),
        "wr2": (w.wr2, bf, (H2, C)),
        "br2": (w.br2, f32, (C,)),
        "w0e_t": (bw.w0e_t, bf, (Kp, H)),
        "wmid_t": (bw.wmid_t, bf, (6, H, H)),
        "w5e_t": (bw.w5e_t, bf, (Kp, H)),
        "w5x_t": (bw.w5x_t, bf, (H, H)),
        "wr0_t": (bw.wr0_t, bf, (H, H)),
        "wr1x_t": (bw.wr1x_t, bf, (H, H2)),
        "gfeat": (gfeat, f32, (B, R, C)),
        "gbga": (gbga, f32, (B, R)),
        "gdepth": (gdepth, f32, (B, R)),
        "gw": (gw, f32, (B, R, S)),
    }
    for name, (t, dtype, shape) in expected.items():
        check_tensor(name, t, dev, dtype, shape)
    # the gradient blocks in the order of the offsets the library gives
    shapes = {
        "dW0e": (Kp, H), "dWmid": (6, H, H), "dbmid": (6, H), "dW5e": (Kp, H), "dW5x": (H, H),
        "dWd": (H, 1), "dbd": (1,), "dWr0": (H, H), "dbr0": (H,), "dWr1x": (H, H2),
        "dWr2": (H2, C), "dbr2": (C,), "dcb0": (B, H), "dcb5": (B, H), "dcbr1": (B, H2),
    }
    lib = _library()
    offsets = (ctypes.c_longlong * (len(shapes) + 1))()
    lib.fused_field_bwd_slab_offsets(B, Kp, H, C, offsets)
    slab_len = offsets[len(shapes)]
    # one persistent CTA per SM (shared memory allows one), none idle
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G = min(sms, B * R * S // TILE_POINTS)
    acts = torch.empty((G, 10, TILE_POINTS, H), dtype=bf, device=dev)
    slabs = torch.empty((G, slab_len), dtype=f32, device=dev)
    grads = torch.empty((slab_len,), dtype=f32, device=dev)
    dembed = torch.empty((B, R, S, De), dtype=f32, device=dev)
    dzvals = torch.empty((B, R, S), dtype=f32, device=dev)
    dzdists = torch.empty((B, R, S), dtype=f32, device=dev)
    ins = [t for t, _, _ in expected.values()]
    outs = (dembed, dzvals, dzdists, acts, slabs, grads)
    err = lib.fused_field_bwd(
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
        B, R, S, De, Kp, H, C, G,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
    launch_count += 1

    blocks = {
        name: grads[o : o + math.prod(shape)].view(shape)
        for (name, shape), o in zip(shapes.items(), offsets)
    }
    blocks["dW0e"], blocks["dW5e"] = blocks["dW0e"][:De], blocks["dW5e"][:De]
    return FieldGrads(dembed=dembed, dzvals=dzvals, dzdists=dzdists, **blocks)


def fused_field_backward(
    embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands, gfeat, gbga, gdepth, gw
) -> FieldGrads:
    """The kernel's wrapper.  CUDA tensors launch the kernel (on the current
    stream, no synchronisation); CPU tensors take
    :func:`fused_field_backward_reference`.  ``embed`` is the bf16 embedding
    the forward read; the cotangents are f32."""
    args = (embed, zvals, zdists, cb0, cb5, cbr1, w, gfeat, gbga, gdepth, gw)
    if embed.device.type == "cpu":
        return fused_field_backward_reference(*args)
    if embed.device.type != "cuda":
        raise ValueError(f"no fused field backward kernel for device {embed.device}")
    return _launch(*args)
