"""Fused field forward: field MLP + volume integration in one kernel.

Counterpart of the JAX package's ``kernels/fused_field.py`` (its Pallas
``_field_kernel``, launched by ``_pallas_forward``) in the no-stash forward
configuration that the render and the recompute-mode training step run.
The kernel is hand-written CUDA for Hopper (``csrc/fused_field_fwd.cu``;
its header states its bound and design); :func:`fused_field_reference` is
its plain PyTorch version with the same rounding points.

Call chain: :func:`split_params` and :func:`prepare_operands` (once per
weight set) -> :func:`fused_field_render` (the per-call conditioning
prologue) -> :func:`fused_field_forward` (the wrapper: the kernel for CUDA
tensors, the plain version for CPU tensors), called through the autograd
:class:`FusedField`, whose backward is the backward kernel
(``kernels/fused_field_bwd.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, NamedTuple, Tuple

import torch

from gazenerf_tpu_torch.kernels import build
from gazenerf_tpu_torch.ops.integrate import exclusive_transmittance

KERNEL = "fused_field_fwd"
# rows of one CTA: whole rays of S samples (S must divide it); the source
# is compiled with this value, so the wrapper's checks and the kernel agree
TILE_POINTS = 128
DEFINES = {"TILE_POINTS": TILE_POINTS}

# kernel launches since import (or since a caller reset it); a render and
# a training step each make two, one per field branch
launch_count = 0


class FieldOperands(NamedTuple):
    """Kernel operands: bf16 weights stored ``[out, in]`` (what one
    ``mma.sync`` B-fragment register reads), f32 biases."""

    w0e: torch.Tensor  # [H, Kp] fea_0 rows acting on the embedding, zero-padded
    wmid: torch.Tensor  # [6, H, H] fea_1..4, fea_6, fea_7
    bmid: torch.Tensor  # [6, H]
    w5e: torch.Tensor  # [H, Kp] fea_5 rows acting on the embedding
    w5x: torch.Tensor  # [H, H] fea_5 rows acting on the hidden state
    wd: torch.Tensor  # [H] density head
    bd: torch.Tensor  # [1]
    wr0: torch.Tensor  # [H, H]
    br0: torch.Tensor  # [H]
    wr1x: torch.Tensor  # [H/2, H] rgb_1 rows acting on rgb_0's output
    wr2: torch.Tensor  # [H/2, C] stored [in, out]: the head runs per ray
    br2: torch.Tensor  # [C]


def split_params(flat: Mapping[str, torch.Tensor], embed_dims: int) -> Dict:
    """Split a field's ``{name}/kernel`` (``[in, out]``) / ``{name}/bias``
    dict into the kernel's blocks, as the JAX ``_split_params`` does:
    ``fea_0`` rows ``[0:De]`` act on the embedding and the rest on the shape
    code; ``fea_5`` rows ``[0:De]`` embedding, ``[De:-H]`` code, ``[-H:]``
    hidden state; ``rgb_1`` rows ``[0:H]`` hidden state, ``[H:]`` appearance
    code."""
    De = embed_dims
    H = flat["fea_1/kernel"].shape[0]
    w0, w5, wr1 = flat["fea_0/kernel"], flat["fea_5/kernel"], flat["rgb_1/kernel"]
    mid = (1, 2, 3, 4, 6, 7)
    return {
        "W0e": w0[:De], "W0c": w0[De:], "b0": flat["fea_0/bias"],
        "Wmid": torch.stack([flat[f"fea_{i}/kernel"] for i in mid]),
        "bmid": torch.stack([flat[f"fea_{i}/bias"] for i in mid]),
        "W5e": w5[:De], "W5c": w5[De : w5.shape[0] - H], "W5x": w5[w5.shape[0] - H :],
        "b5": flat["fea_5/bias"],
        "Wd": flat["density/kernel"], "bd": flat["density/bias"],
        "Wr0": flat["rgb_0/kernel"], "br0": flat["rgb_0/bias"],
        "Wr1x": wr1[:H], "Wr1c": wr1[H:], "br1": flat["rgb_1/bias"],
        "Wr2": flat["rgb_2/kernel"], "br2": flat["rgb_2/bias"],
    }


def prepare_operands(p: Mapping[str, torch.Tensor]) -> FieldOperands:
    """:func:`split_params` blocks -> contiguous kernel operands."""
    bf, f32 = torch.bfloat16, torch.float32
    De, H = p["W0e"].shape
    Kp = -(-De // 16) * 16  # the mma K step is 16

    def out_in(w, k=None):  # [in, out] -> [out, in] bf16, K zero-padded
        w = w.t()
        if k is not None and k > w.shape[1]:
            w = torch.nn.functional.pad(w, (0, k - w.shape[1]))
        return w.to(bf).contiguous()

    return FieldOperands(
        w0e=out_in(p["W0e"], Kp),
        wmid=p["Wmid"].transpose(1, 2).to(bf).contiguous(),
        bmid=p["bmid"].to(f32).contiguous(),
        w5e=out_in(p["W5e"], Kp),
        w5x=out_in(p["W5x"]),
        wd=p["Wd"][:, 0].to(bf).contiguous(),
        bd=p["bd"].to(f32).reshape(1).contiguous(),
        wr0=out_in(p["Wr0"]),
        br0=p["br0"].to(f32).contiguous(),
        wr1x=out_in(p["Wr1x"]),
        wr2=p["Wr2"].to(bf).contiguous(),
        br2=p["br2"].to(f32).contiguous(),
    )


def conditioning_rows(p: Mapping[str, torch.Tensor], sc: torch.Tensor, ac: torch.Tensor):
    """Per-batch bias rows ``cb0 = sc.W0c + b0``, ``cb5 = sc.W5c + b5``,
    ``cbr1 = ac.Wr1c + br1`` (f32), the prologue the JAX launcher runs."""
    f32 = torch.float32
    sc, ac = sc.to(f32), ac.to(f32)
    cb0 = sc @ p["W0c"].to(f32) + p["b0"].to(f32)
    cb5 = sc @ p["W5c"].to(f32) + p["b5"].to(f32)
    cbr1 = ac @ p["Wr1c"].to(f32) + p["br1"].to(f32)
    return cb0.contiguous(), cb5.contiguous(), cbr1.contiguous()


def fused_field_reference(embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands):
    """Plain PyTorch version of the kernel, with its rounding points.

    bf16-in / f32-accumulate products are emulated by rounding each operand
    to bf16 and multiplying in f32.  Returns ``(feat_int [B,R,C], bg_alpha
    [B,R], depth [B,R], weights [B,R,S])``, all f32.
    """
    f32 = torch.float32
    B, R, S, De = embed.shape

    def rnd(t):  # a bf16 rounding point
        return t.to(torch.bfloat16).to(f32)

    def dense(x, w_out_in):
        return x @ w_out_in.to(f32).t()

    e = rnd(embed.reshape(B, R * S, De))
    x = rnd(torch.relu(dense(e, w.w0e[:, :De]) + cb0[:, None, :]))
    mid = 0
    for i in range(1, 8):
        if i == 5:
            y = dense(e, w.w5e[:, :De]) + dense(x, w.w5x) + cb5[:, None, :]
        else:
            y = dense(x, w.wmid[mid]) + w.bmid[mid]
            mid += 1
        x = rnd(torch.relu(y))
    sigma = torch.relu(x @ w.wd.to(f32) + w.bd)  # [B, N]
    y0 = rnd(dense(x, w.wr0) + w.br0)
    y1 = rnd(torch.relu(dense(y0, w.wr1x) + cbr1[:, None, :]))
    feat = (y1 @ w.wr2.to(f32) + w.br2).reshape(B, R, S, -1)

    alpha = 1.0 - torch.exp(-sigma.reshape(B, R, S) * zdists)
    wts = alpha * exclusive_transmittance(alpha)
    feat_int = torch.einsum("brs,brsc->brc", wts, feat)
    return feat_int, 1.0 - wts.sum(-1), (wts * zvals).sum(-1), wts


_ARGTYPES = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL, DEFINES)
    lib.fused_field_fwd.argtypes = _ARGTYPES
    lib.fused_field_fwd.restype = ctypes.c_int
    return lib


def check_tensor(name, t, device, dtype, shape):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel launch takes."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands):
    global launch_count
    B, R, S, De = embed.shape
    H, Kp = w.w0e.shape
    H2, C = w.wr2.shape
    dev = embed.device
    if S <= 0 or TILE_POINTS % S or R % (TILE_POINTS // S):
        raise ValueError(
            f"the kernel takes whole rays in tiles of {TILE_POINTS} points: "
            f"S={S} must divide {TILE_POINTS} and R={R} be a multiple of "
            f"{TILE_POINTS // max(S, 1)}"
        )
    if H % 16 or H2 * 2 != H:
        raise ValueError(f"hidden width {H} must be a multiple of 16")
    bf, f32 = torch.bfloat16, torch.float32
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
    }
    for name, (t, dtype, shape) in expected.items():
        check_tensor(name, t, dev, dtype, shape)
    if Kp % 16 or Kp < De:
        raise ValueError(f"padded embedding width {Kp} for De={De}")
    lib = _library()
    feat = torch.empty((B, R, C), dtype=f32, device=dev)
    bga = torch.empty((B, R), dtype=f32, device=dev)
    depth = torch.empty((B, R), dtype=f32, device=dev)
    wts = torch.empty((B, R, S), dtype=f32, device=dev)
    ins = [t for t, _, _ in expected.values()]
    err = lib.fused_field_fwd(
        *(t.data_ptr() for t in ins),
        *(t.data_ptr() for t in (feat, bga, depth, wts)),
        B, R, S, De, Kp, H, C,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
    launch_count += 1
    return feat, bga, depth, wts


def fused_field_forward(
    embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands
) -> Tuple[torch.Tensor, ...]:
    """The kernel's wrapper.  CUDA tensors launch the kernel (on the current
    stream, no synchronisation); CPU tensors take
    :func:`fused_field_reference`.  No autograd: :func:`fused_field_render`
    wraps it in :class:`FusedField`, whose backward is the backward kernel."""
    if embed.device.type == "cpu":
        return fused_field_reference(embed, zvals, zdists, cb0, cb5, cbr1, w)
    if embed.device.type != "cuda":
        raise ValueError(f"no fused field kernel for device {embed.device}")
    return _launch(embed, zvals, zdists, cb0, cb5, cbr1, w)


# the split_params blocks that carry gradients, in FusedField's input order
WEIGHT_KEYS = (
    "W0e", "Wmid", "bmid", "W5e", "W5x", "Wd", "bd", "Wr0", "br0", "Wr1x", "Wr2", "br2",
)


class FusedField(torch.autograd.Function):
    """Field + integration with the backward kernel as its gradient (the
    JAX package's ``custom_vjp`` around the two Pallas kernels, recompute
    mode).

    Inputs: the bf16 kernel operands (values), then the embedding, z values,
    segment lengths, conditioning rows and the :data:`WEIGHT_KEYS` blocks
    (f32 views of the parameters, which receive the weight gradients).  The
    forward launches the forward kernel and saves its inputs, no
    activations; the backward recomputes them.  The embedding's cotangent
    comes back in the embedding's dtype."""

    @staticmethod
    def forward(ctx, ops: FieldOperands, embed, zvals, zdists, cb0, cb5, cbr1, *weights):
        e = embed.to(torch.bfloat16).contiguous()
        out = fused_field_forward(e, zvals, zdists, cb0, cb5, cbr1, ops)
        ctx.save_for_backward(e, zvals, zdists, cb0, cb5, cbr1, *ops)
        ctx.embed_dtype = embed.dtype
        return out

    @staticmethod
    def backward(ctx, gfeat, gbga, gdepth, gw):
        from gazenerf_tpu_torch.kernels import fused_field_bwd

        e, zvals, zdists, cb0, cb5, cbr1, *ops = ctx.saved_tensors
        B, R, S, _ = e.shape

        def cot(g, shape):  # an output no loss reads has no cotangent
            if g is None:
                return torch.zeros(shape, dtype=torch.float32, device=e.device)
            return g.to(torch.float32).contiguous()

        C = ops[-1].shape[0]
        g = fused_field_bwd.fused_field_backward(
            e, zvals, zdists, cb0, cb5, cbr1, FieldOperands(*ops),
            cot(gfeat, (B, R, C)), cot(gbga, (B, R)), cot(gdepth, (B, R)), cot(gw, (B, R, S)),
        )
        return (
            None, g.dembed.to(ctx.embed_dtype), g.dzvals, g.dzdists, g.dcb0, g.dcb5, g.dcbr1,
            g.dW0e, g.dWmid, g.dbmid, g.dW5e, g.dW5x, g.dWd, g.dbd,
            g.dWr0, g.dbr0, g.dWr1x, g.dWr2, g.dbr2,
        )


def fused_field_render(p, ops: FieldOperands, embed, sc, ac, zvals, zdists):
    """Field evaluation + integration for one branch.

    ``p``: the field's :func:`split_params` blocks and ``ops`` its
    :func:`prepare_operands` (the bf16 values the kernels read, built once
    per weight set).  The call goes through :class:`FusedField`: under
    autograd the gradients reach ``p``'s blocks, the codes and the
    embedding.  Returns ``(feat_int [B,R,C], bg_alpha [B,R], depth [B,R],
    weights [B,R,S])``.
    """
    cb0, cb5, cbr1 = conditioning_rows(p, sc, ac)
    return FusedField.apply(
        ops, embed, zvals.to(torch.float32).contiguous(), zdists.to(torch.float32).contiguous(),
        cb0, cb5, cbr1, *(p[k] for k in WEIGHT_KEYS),
    )
