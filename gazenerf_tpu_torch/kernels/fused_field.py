"""Fused field forward: field MLP + volume integration in one kernel.

Counterpart of the JAX package's ``kernels/fused_field.py`` (its Pallas
``_field_kernel``, launched by ``_pallas_forward``), with and without the
activation stash (``stash_acts``) that the backward can read in place of its
recompute, in each of its forms (:class:`StashForm`: every layer in bf16,
every k-th trunk layer, or x0..x6 and y0b as int8 codes with a scale per
point), and with the sample points encoded in
the kernel's tile (``embed_in_kernel``: the input is the points ``[B, R, S,
3]`` f32, encoded as :func:`~gazenerf_tpu_torch.ops.embedding.
positional_encoding_matmul` in f32 and rounded to bf16 once) or the
embedding given; its ``dens_vpu`` density head is the port's only one (an
f32 dot product of bf16 values).  The kernel is
hand-written CUDA for Hopper (``csrc/fused_field_fwd.cu``; its header
states its bound and design); :func:`fused_field_reference` is its plain
PyTorch version with the same rounding points.

Call chain: :func:`split_params` and :func:`prepare_operands` (once per
weight set) -> :func:`fused_field_render` (the per-call conditioning
prologue) -> :func:`fused_field_forward` (the wrapper: the kernel for CUDA
tensors, the plain version for CPU tensors), called through the autograd
:class:`FusedField`, whose backward is the backward kernel
(``kernels/fused_field_bwd.py``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Mapping, NamedTuple, Tuple

import torch

from gazenerf_tpu_torch.kernels import build
from gazenerf_tpu_torch.ops.embedding import positional_encoding_matmul
from gazenerf_tpu_torch.ops.integrate import exclusive_transmittance

KERNEL = "fused_field_fwd"
# rows of one tile; a CTA takes whole rays that fill whole tiles (cta_rays).
# The source is compiled with this value, so the wrapper's checks and the
# kernel agree
TILE_POINTS = 128
DEFINES = {"TILE_POINTS": TILE_POINTS}
# The rays the field kernels (K1-K4) take: S divides 64 (the backward's
# tile), or S is a multiple of 64 up to MAX_SAMPLES, and then a ray spans
# tiles of one CTA, which keeps the ray's per-point floats in its shared
# memory in the backward
RAY_STEP = 64
MAX_SAMPLES = 256
# output columns of one pass of the tile's products, and the K-width of one
# slice of the weight stream the kernels pack per call (csrc/field_fwd.cuh)
PASS_COLS = 192
SLICE_K = 32

# kernel launches since import (or since a caller reset it); a render and
# a training step each make two, one per field branch
launch_count = 0


class FieldOperands(NamedTuple):
    """Kernel operands: bf16 weights stored ``[out, in]`` (rows contiguous
    along K: the kernels copy K-slices of them), f32 biases."""

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


def encoded(embed: torch.Tensor, n_freqs) -> torch.Tensor:
    """The kernels' embedding: ``embed`` itself, or with ``n_freqs`` given
    (``embed_in_kernel``) the encoding of the points ``embed`` in their
    dtype (at least f32), as the kernels compute it before rounding to
    bf16."""
    if n_freqs is None:
        return embed
    return positional_encoding_matmul(embed.to(torch.promote_types(embed.dtype, torch.float32)),
                                      n_freqs)


class StashForm(NamedTuple):
    """The form of the activation stash (the JAX ``FieldDims``'
    ``stash_every`` and ``stash_dtype``): ``every`` 1 stashes x0..x7, y0b
    and y1, ``every`` k > 1 the trunk layers i with i % k == k - 1 (none for
    k >= 9); ``dtype`` "int8" stores x0..x6 and y0b as int8 codes, a scale
    per point and tag, and needs ``every`` 1."""

    every: int = 1
    dtype: str = "bfloat16"


def as_form(stash) -> StashForm:
    """``stash`` (True or a :class:`StashForm`) as a form."""
    return stash if isinstance(stash, StashForm) else StashForm()


# the stash tensors the backward feeds into the recomputed heads (the
# density from x7, the features from y1): bf16 in every form, so that no
# quantization error enters the integration backward
EXACT_STASH_TAGS = frozenset({"x7", "y1"})
STASH_TAGS = tuple(f"x{i}" for i in range(8)) + ("y0b", "y1")  # by layer: fea_0..7, rgb_0, rgb_1
# 1 / 127 rounded to f32 (0x3c010204), the int8 stash's scale per unit of amax
INV_127 = float.fromhex("0x1.020408p-7")


def stash_layout(H: int, form: StashForm = StashForm()) -> List[Tuple[str, int]]:
    """The stash's ``(tag, width)`` slots, in the order the forward gives
    them (the JAX ``stash_layout``): every layer with ``every`` 1 (y1 at
    width ``H/2``), else the trunk layers i with i % k == k - 1."""
    k = max(1, form.every)
    if k == 1:
        return [(t, H // 2 if t == "y1" else H) for t in STASH_TAGS]
    return [(f"x{i}", H) for i in range(8) if i % k == k - 1]


def stash_quant_tags(form: StashForm = StashForm()) -> List[str]:
    """The tags stored as int8 codes (the JAX ``stash_quant_tags``): x0..x6
    and y0b under ``dtype`` "int8", which needs ``every`` 1."""
    if form.dtype != "int8":
        return []
    if form.every != 1:
        raise ValueError(f"the int8 stash needs stash_every=1, not {form.every}")
    return [t for t, _ in stash_layout(0, form) if t not in EXACT_STASH_TAGS]


def stash_shapes(B: int, R: int, S: int, H: int, form: StashForm = StashForm()):
    """The stash's tensors as ``(shape, dtype)``: the layout's slots
    ``[B, R, S, width]``, bf16 or int8 codes, then with int8 codes their f32
    scales ``[B, R, S, n]``, one per point and quantized tag."""
    q = stash_quant_tags(form)
    out = [((B, R, S, w), torch.int8 if t in q else torch.bfloat16)
           for t, w in stash_layout(H, form)]
    if q:
        out.append(((B, R, S, len(q)), torch.float32))
    return out


def quantize_rows(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes of each row of ``v`` (f32 holding bf16 values)
    and their f32 scales, as the JAX kernel quantizes a stash row, ``s =
    max(amax, 1e-12) / 127``, ``q = clip(round(v * (1 / s)), -127, 127)``,
    and XLA computes it: the quotient by 127 as the product by 127's f32
    reciprocal, ``1 / s`` a quotient, the product by it rounded half to
    even.  Each operation is tensor by tensor, one rounding each, on any
    device."""
    a = torch.clamp(v.abs().amax(-1, keepdim=True), min=1e-12)
    s = a * torch.full_like(a, INV_127)
    q = torch.clamp(torch.round(v * (torch.ones_like(s) / s)), -127.0, 127.0)
    return q.to(torch.int8), s[..., 0]


def dequantize_rows(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The bf16 values the backward reads for int8 codes ``q`` with row
    scales ``s``: ``bf16(q * s)``, the product in f32."""
    return (q.to(torch.float32) * s[..., None]).to(torch.bfloat16)


def stash_values(stash, H: int, form: StashForm = StashForm()) -> Dict[str, torch.Tensor]:
    """The stash's tensors by tag, as the bf16 values the backward reads
    (int8 codes dequantized with their scales)."""
    q = stash_quant_tags(form)
    slots = stash[:-1] if q else stash
    out = {}
    for (tag, _), t in zip(stash_layout(H, form), slots):
        out[tag] = dequantize_rows(t, stash[-1][..., q.index(tag)]) if tag in q else t
    return out


def fused_field_reference(embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands,
                          stash=False, n_freqs=None):
    """Plain PyTorch version of the kernel, with its rounding points.

    bf16-in / f32-accumulate products are emulated by rounding each operand
    to bf16 and multiplying in f32.  Returns ``(feat_int [B,R,C], bg_alpha
    [B,R], depth [B,R], weights [B,R,S])``, all f32.  With ``stash`` (True,
    or a :class:`StashForm`) it returns ``(outputs, acts)``: ``acts`` the
    activation stash the JAX kernel writes under a gradient, in the form's
    layout (:func:`stash_shapes`): of the bf16 values x0..x7 and y0b
    (``[B,R,S,H]``) and y1 (``[B,R,S,H/2]``) that its products read, those
    the form keeps, int8 codes and their scales (:func:`quantize_rows`) in
    place of the quantized tags.  With ``n_freqs`` (``embed_in_kernel``)
    ``embed`` is the sample points ``[B,R,S,3]``, encoded in f32
    (:func:`encoded`).
    """
    f32 = torch.float32
    embed = encoded(embed, n_freqs)
    B, R, S, De = embed.shape

    def rnd(t):  # a bf16 rounding point
        return t.to(torch.bfloat16).to(f32)

    def dense(x, w_out_in):
        return x @ w_out_in.to(f32).t()

    e = rnd(embed.reshape(B, R * S, De))
    acts = [rnd(torch.relu(dense(e, w.w0e[:, :De]) + cb0[:, None, :]))]
    mid = 0
    for i in range(1, 8):
        if i == 5:
            y = dense(e, w.w5e[:, :De]) + dense(acts[-1], w.w5x) + cb5[:, None, :]
        else:
            y = dense(acts[-1], w.wmid[mid]) + w.bmid[mid]
            mid += 1
        acts.append(rnd(torch.relu(y)))
    x = acts[-1]
    sigma = torch.relu(x @ w.wd.to(f32) + w.bd)  # [B, N]
    y0 = rnd(dense(x, w.wr0) + w.br0)
    y1 = rnd(torch.relu(dense(y0, w.wr1x) + cbr1[:, None, :]))
    feat = (y1 @ w.wr2.to(f32) + w.br2).reshape(B, R, S, -1)

    alpha = 1.0 - torch.exp(-sigma.reshape(B, R, S) * zdists)
    wts = alpha * exclusive_transmittance(alpha)
    feat_int = torch.einsum("brs,brsc->brc", wts, feat)
    out = (feat_int, 1.0 - wts.sum(-1), (wts * zvals).sum(-1), wts)
    if not stash:
        return out
    form = as_form(stash)
    values = dict(zip(STASH_TAGS, (*acts, y0, y1)))
    q = stash_quant_tags(form)
    slots, scales = [], []
    for tag, _ in stash_layout(w.wmid.shape[1], form):
        v = values[tag].reshape(B, R, S, -1)
        if tag in q:
            codes, s = quantize_rows(v)
            slots.append(codes)
            scales.append(s)
        else:
            slots.append(v.to(torch.bfloat16))
    if scales:
        slots.append(torch.stack(scales, -1))
    return out, tuple(slots)


_ARGTYPES = [ctypes.c_void_p] * 24 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


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


def takes_samples(S: int) -> bool:
    """Whether the field kernels take rays of ``S`` samples: ``S`` divides
    ``RAY_STEP`` (whole rays in every tile) or is a multiple of it up to
    ``MAX_SAMPLES`` (a ray spans tiles of one CTA)."""
    return S > 0 and (RAY_STEP % S == 0 or (S % RAY_STEP == 0 and S <= MAX_SAMPLES))


def cta_rays(S: int) -> int:
    """Rays per CTA of the forward kernels: the fewest whole rays whose
    points fill whole tiles of ``TILE_POINTS`` (``cta_rays`` in
    csrc/field_fwd.cuh)."""
    return TILE_POINTS // math.gcd(S, TILE_POINTS)


def sample_rule(S: int) -> str:
    """What the kernels take, said of ``S``."""
    return (f"the kernels take whole rays of S samples, S dividing {RAY_STEP} or a "
            f"multiple of {RAY_STEP} up to {MAX_SAMPLES}: not S={S}")


def points_width(n_freqs: int) -> int:
    """The embedding's width the kernels encode points into: ``3 + 6 n_freqs``
    (the identity columns, then sin and cos of each octave)."""
    return 3 + 6 * n_freqs


def check_points(embed_dims: int, n_freqs: int) -> None:
    """Raise unless a field of ``embed_dims`` embedding columns takes the
    points encoded in the kernel at ``n_freqs`` octaves."""
    if embed_dims != points_width(n_freqs):
        raise ValueError(f"embed_in_kernel encodes the points into {points_width(n_freqs)} "
                         f"columns (n_freqs={n_freqs}); the field takes {embed_dims}")


def check_shapes(R, S, H, H2, Kp, De):
    """Raise unless the tile body takes these shapes: rays of
    :func:`takes_samples`, whole rays in every CTA (``R`` a multiple of
    :func:`cta_rays`); activations and the embedding tile stored in
    64-column blocks, and a layer of more than ``PASS_COLS`` columns
    computed in two passes of half its width.  ``De`` is the embedding's
    width, the points' encoded width with ``embed_in_kernel``."""
    if not takes_samples(S):
        raise ValueError(sample_rule(S))
    if R % cta_rays(S):
        raise ValueError(f"the kernel takes whole rays in every CTA: R={R} must be a "
                         f"multiple of {cta_rays(S)} at S={S}")
    if H2 * 2 != H or not takes_hidden(H):
        raise ValueError(f"hidden width {H}: the kernel takes multiples of 64 up to "
                         f"{PASS_COLS} and multiples of 128 up to {2 * PASS_COLS}")
    if Kp % 64 or Kp < De:
        raise ValueError(f"padded embedding width {Kp} for De={De}: a multiple of 64 "
                         f"at least De")


def takes_hidden(H: int) -> bool:
    """Whether the forward kernels take hidden width ``H``: its layers in one
    pass of 64-column blocks, or two passes of half the width."""
    return H <= 2 * PASS_COLS and H % (128 if H > PASS_COLS else 64) == 0


def stream_slices(H: int, Kp: int) -> int:
    """``[PASS_COLS, SLICE_K]`` slices of the weight stream a forward kernel
    packs per call and branch (``stream_slices`` in csrc/field_fwd.cuh)."""
    passes = 2 if H > PASS_COLS else 1
    return passes * (2 * Kp + 8 * H) // SLICE_K + H // SLICE_K


def stash_pointers(stash, H: int, form: StashForm):
    """The kernels' C array of a stash's pointers: one per layer (x0..x7,
    y0b, y1; null where the form keeps none), then the int8 codes' scales
    (null for a bf16 stash)."""
    ptrs = dict(zip((t for t, _ in stash_layout(H, form)), (t.data_ptr() for t in stash)))
    scales = stash[-1].data_ptr() if stash_quant_tags(form) else None
    return (ctypes.c_void_p * (len(STASH_TAGS) + 1))(*(ptrs.get(t) for t in STASH_TAGS), scales)


def _launch(embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands, stash=False,
            n_freqs=None):
    global launch_count
    B, R, S, Din = embed.shape
    De = Din if n_freqs is None else points_width(n_freqs)
    H, Kp = w.w0e.shape
    H2, C = w.wr2.shape
    dev = embed.device
    check_shapes(R, S, H, H2, Kp, De)
    bf, f32 = torch.bfloat16, torch.float32
    expected = {
        "embed": (embed, bf, (B, R, S, De)) if n_freqs is None else (embed, f32, (B, R, S, 3)),
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
    lib = _library()
    feat = torch.empty((B, R, C), dtype=f32, device=dev)
    bga = torch.empty((B, R), dtype=f32, device=dev)
    depth = torch.empty((B, R), dtype=f32, device=dev)
    wts = torch.empty((B, R, S), dtype=f32, device=dev)
    form = as_form(stash)
    acts = tuple(torch.empty(shape, dtype=dtype, device=dev)
                 for shape, dtype in stash_shapes(B, R, S, H, form)) if stash else ()
    ins = [t for t, _, _ in expected.values()]
    # scratch for the weight stream, packed by the call (alive only while
    # the kernel runs: the stream repeats the weights)
    stream = torch.empty((stream_slices(H, Kp), PASS_COLS, SLICE_K), dtype=bf, device=dev)
    err = lib.fused_field_fwd(
        *(t.data_ptr() for t in ins), stream.data_ptr(),
        *(t.data_ptr() for t in (feat, bga, depth, wts)),
        stash_pointers(acts, H, form) if acts else None,
        B, R, S, De, Kp, H, C, int(n_freqs is not None),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
    launch_count += 1
    out = (feat, bga, depth, wts)
    return (out, acts) if stash else out


def fused_field_forward(
    embed, zvals, zdists, cb0, cb5, cbr1, w: FieldOperands, stash=False, n_freqs=None
) -> Tuple[torch.Tensor, ...]:
    """The kernel's wrapper.  CUDA tensors launch the kernel (on the current
    stream, no synchronisation); CPU tensors take
    :func:`fused_field_reference`.  ``embed`` is the bf16 embedding, or
    with ``n_freqs`` (``embed_in_kernel``) the f32 sample points ``[B, R,
    S, 3]``, which the kernel encodes.  With ``stash`` (True: the bf16 stash
    of every layer, or a :class:`StashForm`) it returns ``(outputs, acts)``,
    the stash tensors of the form as the plain version gives them (none
    where the form keeps no layer: the kernel then writes none).  No
    autograd: :func:`fused_field_render` wraps it in :class:`FusedField`,
    whose backward is the backward kernel."""
    if embed.device.type == "cpu":
        return fused_field_reference(embed, zvals, zdists, cb0, cb5, cbr1, w, stash=stash,
                                     n_freqs=n_freqs)
    if embed.device.type != "cuda":
        raise ValueError(f"no fused field kernel for device {embed.device}")
    return _launch(embed, zvals, zdists, cb0, cb5, cbr1, w, stash=stash, n_freqs=n_freqs)


# the split_params blocks that carry gradients, in FusedField's input order
WEIGHT_KEYS = (
    "W0e", "Wmid", "bmid", "W5e", "W5x", "Wd", "bd", "Wr0", "br0", "Wr1x", "Wr2", "br2",
)


class FusedField(torch.autograd.Function):
    """Field + integration with the backward kernel as its gradient (the
    JAX package's ``custom_vjp`` around the two Pallas kernels).

    Inputs: the bf16 kernel operands (values), whether to stash (False;
    True, the bf16 stash of every layer; or a :class:`StashForm`), whether
    the backward takes the ``dens_vpu`` density head, ``n_freqs`` (None, or
    the octaves of the points the kernels encode: ``embed_in_kernel``), then
    the embedding (or the points), z values, segment lengths, conditioning
    rows and the :data:`WEIGHT_KEYS` blocks (f32 views of the parameters,
    which receive the weight gradients).  The forward launches the forward kernel and saves its
    inputs and, with the stash, the form's stash tensors, which autograd
    holds until it frees the graph (a backward with ``retain_graph`` can run
    again on them) and the backward reads, recomputing the layers the form
    does not keep; without the stash (or with a form that keeps no layer)
    the backward recomputes them all.  The embedding's
    cotangent comes back in the embedding's dtype (a bf16 embedding's is its
    f32 cotangent rounded once); the points' in f32."""

    @staticmethod
    def forward(ctx, ops: FieldOperands, stash, dens_vpu: bool, n_freqs, embed, zvals,
                zdists, cb0, cb5, cbr1, *weights):
        if n_freqs is None:
            e = embed.to(torch.bfloat16).contiguous()
        else:
            check_points(weights[0].shape[0], n_freqs)
            e = embed.to(torch.float32).contiguous()
        out = fused_field_forward(e, zvals, zdists, cb0, cb5, cbr1, ops, stash=stash,
                                  n_freqs=n_freqs)
        acts = ()
        if stash:
            out, acts = out
        # the stash is saved as the inputs are: a checkpoint that recomputes
        # this forward (ray_chunk) recomputes it, and the backward reads that
        ctx.save_for_backward(e, zvals, zdists, cb0, cb5, cbr1, *ops, *acts)
        ctx.embed_dtype = embed.dtype
        ctx.dens_vpu = dens_vpu
        ctx.n_freqs = n_freqs
        ctx.stash_form = as_form(stash)
        return out

    @staticmethod
    def backward(ctx, gfeat, gbga, gdepth, gw):
        from gazenerf_tpu_torch.kernels import fused_field_bwd

        e, zvals, zdists, cb0, cb5, cbr1, *rest = ctx.saved_tensors
        n = len(FieldOperands._fields)
        ops, acts = rest[:n], tuple(rest[n:])
        B, R, S, _ = e.shape

        def cot(g, shape):  # an output no loss reads has no cotangent
            if g is None:
                return torch.zeros(shape, dtype=torch.float32, device=e.device)
            return g.to(torch.float32).contiguous()

        C = ops[-1].shape[0]
        # the modes in use only: a recompute-mode call takes the plain signature
        form = ctx.stash_form if acts and ctx.stash_form != StashForm() else None
        mode = {k: v for k, v in (("stash", acts), ("dens_vpu", ctx.dens_vpu),
                                  ("n_freqs", ctx.n_freqs), ("stash_form", form)) if v}
        g = fused_field_bwd.fused_field_backward(
            e, zvals, zdists, cb0, cb5, cbr1, FieldOperands(*ops),
            cot(gfeat, (B, R, C)), cot(gbga, (B, R)), cot(gdepth, (B, R)), cot(gw, (B, R, S)),
            **mode,
        )
        return (
            None, None, None, None, g.dembed.to(ctx.embed_dtype), g.dzvals, g.dzdists, g.dcb0,
            g.dcb5, g.dcbr1,
            g.dW0e, g.dWmid, g.dbmid, g.dW5e, g.dW5x, g.dWd, g.dbd,
            g.dWr0, g.dbr0, g.dWr1x, g.dWr2, g.dbr2,
        )


def fused_field_render(p, ops: FieldOperands, embed, sc, ac, zvals, zdists,
                       stash_acts: bool = False, dens_vpu: bool = False, n_freqs=None,
                       stash_form: StashForm = StashForm()):
    """Field evaluation + integration for one branch.

    ``p``: the field's :func:`split_params` blocks and ``ops`` its
    :func:`prepare_operands` (the bf16 values the kernels read, built once
    per weight set).  The call goes through :class:`FusedField`: under
    autograd the gradients reach ``p``'s blocks, the codes and the
    embedding.  With ``stash_acts`` the forward writes the activation stash
    for the backward to read, only where a backward will run (under a
    gradient, some input requiring one), as the JAX primal call skips it,
    in the form ``stash_form`` (:class:`StashForm`); ``dens_vpu`` selects
    the backward's ``dens_vpu`` rounding of dWd.  With ``n_freqs``
    (``embed_in_kernel``) ``embed`` is the sample points ``[B, R, S, 3]``,
    which the kernels encode at ``n_freqs`` octaves, and the gradient
    reaches the points.
    Returns ``(feat_int [B,R,C], bg_alpha [B,R], depth [B,R], weights
    [B,R,S])``.
    """
    cb0, cb5, cbr1 = conditioning_rows(p, sc, ac)
    weights = [p[k] for k in WEIGHT_KEYS]
    stash = stash_acts and torch.is_grad_enabled() and any(
        t.requires_grad for t in (embed, sc, ac, zvals, zdists, *weights))
    if stash_acts:  # an int8 form needs stash_every 1 (no stash, no form: JAX's [])
        stash_quant_tags(stash_form)
    if stash and stash_form != StashForm():
        stash = stash_form  # else True: the bf16 stash of every layer
    return FusedField.apply(
        ops, stash, dens_vpu, n_freqs, embed, zvals.to(torch.float32).contiguous(),
        zdists.to(torch.float32).contiguous(), cb0, cb5, cbr1, *weights,
    )
