"""Fused field backward: the gradient of the fused field forward.

Counterpart of the JAX package's ``kernels/fused_field_bwd.py`` (its Pallas
``_bwd_kernel``, launched by ``pallas_backward``) in recompute mode or
reading the forward's activation stash (``stash_acts``) in any of its forms
(:class:`~gazenerf_tpu_torch.kernels.fused_field.StashForm`: the bf16 stash
of every layer; every k-th trunk layer, the others recomputed in forward
order from the nearest stashed one; x0..x6 and y0b as int8 codes,
dequantized to bf16), with or without ``dens_vpu``, given the embedding (its
cotangent in f32) or the sample points that it encodes in its tile as the
forward does
(``embed_in_kernel``: the cotangent is the points', ``[B, R, S, 3]`` f32,
in :class:`FieldGrads`' ``dembed``), the weight gradients
computed by the kernel's own GEMM over chunks of points
(``kernels/field_dw.py``).  The Pallas kernel's ``split_dw`` mode is the
stash mode without ``dens_vpu`` here (``models/gaze_nerf.py``).  The
kernel is hand-written
CUDA for Hopper (``csrc/fused_field_bwd.cu``; its header states its bound,
design, scratch and determinism); :func:`fused_field_backward_reference` is
its plain PyTorch version with the Pallas kernel's rounding points.  It
takes rays of S samples, S dividing 64 or a multiple of 64 up to 256: such
a ray spans S / 64 tiles of one CTA, which runs the integration backward over
the whole ray between two sweeps over its tiles.

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
from gazenerf_tpu_torch.kernels import field_dw
from gazenerf_tpu_torch.kernels import fused_field as ff
from gazenerf_tpu_torch.kernels.fused_field import (
    FieldOperands,
    StashForm,
    check_tensor,
    encoded,
    stash_values,
)
from gazenerf_tpu_torch.ops.embedding import (
    positional_encoding_matmul,
    positional_encoding_matmul_vjp,
)
from gazenerf_tpu_torch.ops.integrate import exclusive_transmittance, integrate_rays

KERNEL = "fused_field_bwd"
DEFINES: Dict[str, int] = {}
TILE_POINTS = 64  # points per tile in the kernel
MAX_HIDDEN = 384  # one pass of the kernel's 12 warps covers 384 columns
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

    dembed: torch.Tensor  # [B, R, S, De]; with embed_in_kernel the points' [B, R, S, 3]
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


def density_pre(x7: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor) -> torch.Tensor:
    """The density pre-activation ``x7 @ wd + bd`` (``x7`` ``[..., H]`` of
    bf16 values, ``wd`` ``[H]``), summed in the backward kernels' order
    (``density_pre`` in ``csrc/field_bwd.cuh``): four interleaved chains
    over the hidden units (unit ``k`` in chain ``k % 4``), each a running
    sum of fused multiply-adds, combined pairwise, then the bias.  A product
    of two bf16 values is exact in f32, so each step here rounds once, as
    the FMA does, and the density's ReLU mask is the kernels' to the bit;
    a matmul's order flips it now and then at a point whose pre-activation
    lies within rounding of 0, and that point's whole cotangent with it."""
    prod = (x7 * wd.to(x7.dtype)).unflatten(-1, (-1, 4))
    v = torch.zeros_like(prod[..., 0, :])
    for k in range(prod.shape[-2]):
        v = v + prod[..., k, :]
    return (v[..., 0] + v[..., 1]) + (v[..., 2] + v[..., 3]) + bd


def fused_field_backward_reference(
    embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands, gfeat, gbga, gdepth, gw,
    dtype=torch.float32, stash=None, chunks=None, dens_vpu=False, n_freqs=None,
    stash_form: StashForm = StashForm(),
) -> FieldGrads:
    """Plain PyTorch version of the kernel, with the Pallas kernel's
    formulas and rounding points: the forward recomputed with K1's bf16
    rounding; f32 data gradients; weight gradients as products of the bf16
    activation and the bf16-rounded cotangent, summed in f32; f32 bias and
    conditioning-row sums; the density pre-activation in the CUDA kernel's
    order (:func:`density_pre`).  ``embed`` is bf16 (its values are what the
    kernel reads); every output is f32.  ``dtype=torch.float64`` computes
    between the same rounding points in float64 instead.  ``stash``, the
    forward's stash in the form ``stash_form`` (``fused_field_reference(...,
    stash=stash_form)``), takes the recompute's place, as the Pallas
    kernel's stash-read mode does: int8 codes dequantized to the bf16 values
    ``bf16(q * s)``, the layers the form does not keep recomputed in forward
    order as the recompute computes them.  ``chunks``, a
    :func:`~gazenerf_tpu_torch.kernels.field_dw.plan_chunks` plan, sums every
    weight gradient chunk by chunk in the kernel's order, else over all
    points at once.  ``dens_vpu``: the density head's weight gradient takes
    the density cotangent unrounded (the Pallas kernel's ``dens_vpu``
    mode), not its bf16 rounding.  ``n_freqs`` (``embed_in_kernel``):
    ``embed`` is the sample points, encoded in ``dtype`` as the kernel
    encodes them (:func:`~gazenerf_tpu_torch.kernels.fused_field.encoded`),
    and ``dembed`` is their cotangent, the encoding's backward
    (:func:`~gazenerf_tpu_torch.ops.embedding.positional_encoding_matmul_vjp`)
    of the f32 embedding cotangent."""
    pts = None if n_freqs is None else embed.to(dtype)
    grads, dembed5, dembed0 = fused_field_backward_parts(
        embed if pts is None else encoded(pts, n_freqs), zvals, zdists, cb0, cb5, cbr1, w,
        gfeat, gbga, gdepth, gw, dtype, stash, chunks, dens_vpu, stash_form)
    dembed = dembed5 + dembed0
    if pts is not None:
        return grads._replace(dembed=positional_encoding_matmul_vjp(pts, dembed, n_freqs))
    return grads._replace(dembed=dembed)


def fused_field_backward_parts(embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands, gfeat,
                               gbga, gdepth, gw, dtype=torch.float32, stash=None, chunks=None,
                               dens_vpu=False, stash_form: StashForm = StashForm()):
    """:func:`fused_field_backward_reference` with the embedding cotangent
    in its two parts, through ``fea_5``'s and through ``fea_0``'s embedding
    rows (``dembed`` is None): the dual-branch backward sums them across
    the branches in the Pallas kernel's order."""
    f32 = dtype
    B, R, S, De = embed.shape

    def rnd(t):  # a bf16 rounding point
        return t.to(torch.bfloat16).to(f32)

    def dense(x, w_out_in):  # x @ W, W stored [out, in]
        return x @ w_out_in.to(f32).t()

    def dgrad(g, w_out_in):  # g @ W^T
        return g @ w_out_in.to(f32)

    def outer(x, g, round_g=True):  # x^T @ bf16(g) over every point of every batch
        x, g = x.reshape(-1, x.shape[-1]), (rnd(g) if round_g else g).reshape(-1, g.shape[-1])
        if chunks is None:
            return x.t() @ g
        return field_dw.chunked_weight_grad_reference(x, g, chunks)

    e = rnd(embed.reshape(B, R * S, De))
    # ---- the stash's layers, the others recomputed in forward order ----
    kept = {} if stash is None else {
        t: v.reshape(B, R * S, -1).to(f32)
        for t, v in stash_values(stash, w.wmid.shape[1], stash_form).items()}
    acts = []
    for i in range(8):
        if f"x{i}" in kept:
            acts.append(kept[f"x{i}"])
        elif i == 0:
            acts.append(rnd(torch.relu(dense(e, w.w0e[:, :De]) + cb0[:, None, :])))
        elif i == 5:
            acts.append(rnd(torch.relu(dense(e, w.w5e[:, :De]) + dense(acts[4], w.w5x)
                                       + cb5[:, None, :])))
        else:
            m = i - 1 if i < 5 else i - 2
            acts.append(rnd(torch.relu(dense(acts[-1], w.wmid[m]) + w.bmid[m])))
    if "y0b" in kept:
        y0b, y1 = kept["y0b"], kept["y1"]
    else:
        y0b = rnd(dense(acts[7], w.wr0) + w.br0)
        y1 = rnd(torch.relu(dense(y0b, w.wr1x) + cbr1[:, None, :]))
    x7 = acts[7]
    dens_pre = density_pre(x7, w.wd, w.bd)  # [B, N]
    sigma = torch.relu(dens_pre).reshape(B, R, S)
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
    dWd = outer(x7, dpre_dens[..., None], round_g=not dens_vpu)

    # ---- trunk backward ----
    dWmid, dbmid = [None] * 6, [None] * 6
    mid = 5
    for i in range(7, 0, -1):
        dpre = torch.where(acts[i] > 0.0, dx, 0.0)
        if i == 5:
            dW5e = outer(e, dpre)
            dW5x = outer(acts[4], dpre)
            dcb5 = dpre.sum(1)
            dembed5 = dpre @ w.w5e[:, :De].to(f32)
            dx = dgrad(dpre, w.w5x)
        else:
            dWmid[mid] = outer(acts[i - 1], dpre)
            dbmid[mid] = dpre.sum((0, 1))
            dx = dgrad(dpre, w.wmid[mid])
            mid -= 1
    dpre = torch.where(acts[0] > 0.0, dx, 0.0)
    dW0e = outer(e, dpre)
    dembed0 = dpre @ w.w0e[:, :De].to(f32)

    grads = FieldGrads(
        dembed=None, dzvals=dzvals, dzdists=dzdists,
        dcb0=dpre.sum(1), dcb5=dcb5, dcbr1=dy1.sum(1),
        dW0e=dW0e, dWmid=torch.stack(dWmid), dbmid=torch.stack(dbmid),
        dW5e=dW5e, dW5x=dW5x, dWd=dWd, dbd=dpre_dens.sum().reshape(1),
        dWr0=dWr0, dbr0=dy0.sum((0, 1)), dWr1x=dWr1x, dWr2=dWr2,
        dbr2=dfeat.sum((0, 1)),
    )
    return grads, dembed5.reshape(B, R, S, De), dembed0.reshape(B, R, S, De)


@torch.enable_grad()  # also when called from a backward
def fused_field_backward_unrounded(
    embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands, gfeat, gbga, gdepth, gw,
    dtype=torch.float64, n_freqs=None,
) -> FieldGrads:
    """The gradient that the kernel and its plain version both approximate:
    autograd in ``dtype`` of the same field (the bf16 operands' values) and
    volume integration, with no rounding point.  Rays go through in chunks
    of 512, which bounds the memory autograd keeps (a few GB at hidden 384
    in float64).  Every output is in ``dtype``.  With ``n_freqs``
    (``embed_in_kernel``) ``embed`` is the sample points, encoded in
    ``dtype``, and ``dembed`` their cotangent."""
    B, R, S, De = embed.shape
    if n_freqs is not None:
        De = ff.points_width(n_freqs)
    P = {k: getattr(w, k).detach().to(dtype).requires_grad_(True) for k in w._fields}
    conds = [t.detach().to(dtype).requires_grad_(True) for t in (cb0, cb5, cbr1)]
    c0, c5, cr1 = (t[:, None, None, :] for t in conds)
    weights = list(P.values())
    sums = [torch.zeros_like(t) for t in conds + weights]
    per_point = []
    for r0 in range(0, R, 512):
        rays = slice(r0, r0 + 512)
        x_in, zv, zd = (t[:, rays].detach().to(dtype).requires_grad_(True)
                        for t in (embed, zvals, zdists))
        e = x_in if n_freqs is None else positional_encoding_matmul(x_in, n_freqs)
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
        g = torch.autograd.grad(loss, [x_in, zv, zd] + conds + weights)
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


_ARGTYPES = [ctypes.c_void_p] * 34 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
# the gradient blocks in the order of the offsets the library gives
_GRAD_BLOCKS = ("dW0e", "dWmid", "dbmid", "dW5e", "dW5x", "dWd", "dbd", "dWr0", "dbr0", "dWr1x",
                "dWr2", "dbr2", "dcb0", "dcb5", "dcbr1")


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL, DEFINES)
    lib.fused_field_bwd.argtypes = _ARGTYPES
    lib.fused_field_bwd.restype = ctypes.c_int
    lib.fused_field_bwd_layout.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.fused_field_bwd_layout.restype = None
    return lib


def grad_shapes(B: int, Kp: int, H: int, C: int) -> Dict[str, tuple]:
    """The shape of every gradient block of a branch's gradient buffer."""
    H2 = H // 2
    shapes = {
        "dW0e": (Kp, H), "dWmid": (6, H, H), "dbmid": (6, H), "dW5e": (Kp, H), "dW5x": (H, H),
        "dWd": (H, 1), "dbd": (1,), "dWr0": (H, H), "dbr0": (H,), "dWr1x": (H, H2),
        "dWr2": (H2, C), "dbr2": (C,), "dcb0": (B, H), "dcb5": (B, H), "dcbr1": (B, H2),
    }
    return {name: shapes[name] for name in _GRAD_BLOCKS}


def layout(layout_fn, B: int, S: int, Kp: int, H: int, C: int, G: int, chunk_tiles: int,
           *mode: int):
    """A backward library's buffer layout: the gradient blocks' offsets (in
    floats), the gradient buffer's length and the scratch's bytes.  ``mode``:
    the library's further arguments (K2's: its stash mode, :func:`stash_mode`,
    and whether it takes the points)."""
    out = (ctypes.c_longlong * (len(_GRAD_BLOCKS) + 2))()
    layout_fn(B, S, Kp, H, C, G, chunk_tiles, *mode, out)
    n = len(_GRAD_BLOCKS)
    return list(out[:n]), out[n], out[n + 1]


# K2's stash modes: recomputing, reading the bf16 stash of every layer, and
# reading another form (the chunk buffer then holds the layers it rebuilds)
RECOMPUTE, FULL_STASH, OTHER_STASH = 0, 1, 2


def stash_mode(stash, form: StashForm) -> int:
    """K2's mode for ``stash`` (None or the tensors) in ``form``."""
    if stash is None:
        return RECOMPUTE
    return FULL_STASH if form == StashForm() else OTHER_STASH


def persistent_ctas(dev, n_tiles: int) -> int:
    """The backwards' grid: one persistent CTA per SM (shared memory allows
    one), none idle."""
    return min(torch.cuda.get_device_properties(dev).multi_processor_count, n_tiles)


def _launch(embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands, gfeat, gbga, gdepth, gw,
            stash=None, dens_vpu=False, n_freqs=None,
            stash_form: StashForm = StashForm()) -> FieldGrads:
    global launch_count
    B, R, S, De = embed.shape
    points = n_freqs is not None
    if points:
        De = ff.points_width(n_freqs)
    H, Kp = w.w0e.shape
    H2, C = w.wr2.shape
    dev = embed.device
    field_dw.check_samples(R, S)
    if H % 64 or H > MAX_HIDDEN or H2 * 2 != H:
        raise ValueError(f"hidden width {H} must be a multiple of 64, at most {MAX_HIDDEN}")
    if Kp % 32 or Kp < De:
        raise ValueError(f"padded embedding width {Kp} must be a multiple of 32, >= {De}")
    bf, f32 = torch.bfloat16, torch.float32
    bw = prepare_backward_operands(w)
    expected = {
        "embed": (embed, f32, (B, R, S, 3)) if points else (embed, bf, (B, R, S, De)),
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
    if stash is not None:
        want = ff.stash_shapes(B, R, S, H, stash_form)
        if not want or len(stash) != len(want):
            raise ValueError(f"stash: {len(stash)} tensors, expected {len(want)} for "
                             f"{stash_form} (a form that keeps no layer takes no stash)")
        for i, (t, (shape, dtype)) in enumerate(zip(stash, want)):
            check_tensor(f"stash[{i}]", t, dev, dtype, shape)
    mode = stash_mode(stash, stash_form)
    lib = _library()
    chunks = field_dw.plan_chunks(B, R, S)
    G = persistent_ctas(dev, B * R * S // TILE_POINTS)
    chunk_tiles = chunks[0].tiles
    offsets, total, scratch_bytes = layout(lib.fused_field_bwd_layout, B, S, Kp, H, C, G,
                                           chunk_tiles, mode, points)
    scratch = torch.empty((scratch_bytes,), dtype=torch.uint8, device=dev)
    grads = torch.empty((total,), dtype=f32, device=dev)
    dembed = torch.empty((B, R, S, 3 if points else De), dtype=f32, device=dev)
    dzvals = torch.empty((B, R, S), dtype=f32, device=dev)
    dzdists = torch.empty((B, R, S), dtype=f32, device=dev)
    ptrs = [t.data_ptr() for t, _, _ in expected.values()]
    ptrs += [None if stash is None else ff.stash_pointers(stash, H, stash_form)]
    ptrs += [t.data_ptr() for t in (dembed, dzvals, dzdists, scratch, grads)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for i, ch in enumerate(chunks):
        err = lib.fused_field_bwd(*ptrs, B, R, S, De, Kp, H, C, G, chunk_tiles, ch.tile0,
                                  ch.tiles, i == 0, i == len(chunks) - 1, dens_vpu, points,
                                  stream)
        if err:
            raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
    launch_count += 1

    blocks = {
        name: grads[o : o + math.prod(shape)].view(shape)
        for (name, shape), o in zip(grad_shapes(B, Kp, H, C).items(), offsets)
    }
    blocks["dW0e"], blocks["dW5e"] = blocks["dW0e"][:De], blocks["dW5e"][:De]
    return FieldGrads(dembed=dembed, dzvals=dzvals, dzdists=dzdists, **blocks)


def fused_field_backward(
    embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands, gfeat, gbga, gdepth, gw,
    stash=None, dens_vpu=False, n_freqs=None, stash_form: StashForm = StashForm(),
) -> FieldGrads:
    """The kernel's wrapper.  CUDA tensors launch the kernel (on the current
    stream, no synchronisation); CPU tensors take
    :func:`fused_field_backward_reference`.  ``embed`` is the bf16 embedding
    the forward read, or with ``n_freqs`` the f32 sample points it encoded;
    the cotangents are f32.  ``stash``, the forward's stash tensors in the
    form ``stash_form`` (``fused_field_forward(..., stash=stash_form)``), is
    read in place of the recompute; ``dens_vpu`` and ``n_freqs`` as the
    plain version's."""
    args = (embed, zvals, zdists, cb0, cb5, cbr1, w, gfeat, gbga, gdepth, gw)
    mode = dict(stash=stash, dens_vpu=dens_vpu, n_freqs=n_freqs, stash_form=stash_form)
    if embed.device.type == "cpu":
        return fused_field_backward_reference(*args, **mode)
    if embed.device.type != "cuda":
        raise ValueError(f"no fused field backward kernel for device {embed.device}")
    return _launch(*args, **mode)
