"""Fused upsampler block: K7 (forward) and K8 (backward).

Counterpart of the JAX package's ``kernels/fused_upsampler.py``: its Pallas
``_fwd_kernel`` (launched by ``_fwd_pallas``) and ``_bwd_kernel`` (launched
by ``_bwd_pallas``), wrapped by the custom VJP ``fused_upsample_block``.
One whole ``PixelShuffleUpsample`` block of the renderer with its folded
``feat_layer``::

    h1  = lrelu(x @ W1 + b1)                       # [*, 2F]
    z   = lrelu(h1 @ W2g + b2g) + x @ P            # [*, 4F]  group-major
    z3  = z_k @ W3 + b3 for each phase k           # [*, 4F3]
    out = the blur-shuffle stencil of z3           # [B, 2H, 2W, F3]

``W2g``/``b2g`` are ``layer_2``'s weight and bias with their columns already
in group-major order (the caller indexes them, so autograd carries the
gradient back to the stored order); ``P`` is the 0/1 channel-tile residual,
applied here as the gather :func:`residual_index` encodes (the same values,
and it takes no gradient).

The kernels are hand-written CUDA for Hopper (``csrc/fused_upsampler_fwd.cu``,
``csrc/fused_upsampler_bwd.cu``, one chain body ``csrc/upsampler_chain.cuh``;
their headers state the bound and the design) for the bf16 configuration
(``use_bf16=True``); K8 takes the pixels in chunks of whole tiles of 64, 128
or 256 pixels (:func:`group_rows`, :func:`plan_chunks`) and its weight
gradients as a GEMM over each chunk's pixels, chunk after chunk.  The f32
configuration (``use_bf16=False``, the f32 renderer) is
``csrc/fused_upsampler_f32.cu``: both directions as register-tiled f32
products on the CUDA cores (:func:`f32_product`, :func:`f32_contract`: the
tile alone), its own counts (``launch_count_fwd_f32``,
``launch_count_bwd_f32``).

* :func:`fused_upsample_reference` / :func:`fused_upsample_backward_reference`:
  the plain versions with the Pallas kernels' rounding points, for
  ``use_bf16`` True and False (the backward's weight gradients also in the
  kernel's chunked order);
* :func:`fused_upsample_forward` / :func:`fused_upsample_backward`: the
  wrappers, the kernels for CUDA tensors, the plain versions for CPU tensors;
* :class:`FusedUpsample`: the autograd op, whose backward is K8.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from gazenerf_tpu_torch.kernels import build
from gazenerf_tpu_torch.kernels.fused_field import check_tensor
from gazenerf_tpu_torch.kernels.shuffle_blur import (
    shuffle_blur_backward_reference,
    shuffle_blur_reference,
)

KERNEL_FWD = "fused_upsampler_fwd"
KERNEL_BWD = "fused_upsampler_bwd"
KERNEL_F32 = "fused_upsampler_f32"
DEFINES: dict = {}
# pixels of a warpgroup's rows: a tile is 64, 128 or 256 (csrc/upsampler_chain.cuh)
GROUP_PIXELS = 64
# the bytes of K8's chunk buffer (its weight gradients' operands) that a
# chunk of more than one wave of tiles may take: at B=2 the chunks of the
# second and third blocks stay near 50 MB, below the 90-130 MB that their
# f32 dz3 and per-CTA weight-gradient slabs took in the earlier design
CHUNK_BYTES = 64 << 20
# shared memory a CTA may take (H100: 227 KB)
SMEM_LIMIT = 232448

# kernel launches since import (or since a caller reset them): K7 and K8.  A
# renderer pass in shuffle_mode="fused" makes one K7 launch per upsample
# block (each is two CUDA launches, the chain and the stencil, counted
# once); its backward one K8 launch per block (per chunk the tile kernel and
# the weight-gradient GEMM's launches, then the bias sums).
launch_count_fwd = 0
launch_count_bwd = 0
# the same for the f32 kernels (use_bf16=False): one per block, forward and
# backward (each several CUDA launches: the products, the stencil or its
# adjoint, the weight gradients' contractions and their sums)
launch_count_fwd_f32 = 0
launch_count_bwd_f32 = 0


def residual_index(F: int) -> np.ndarray:
    """The row of the single 1 in each column of the residual matrix ``P``:
    ``(x @ P)[k*F + c] = x[(4c + k) % F]``."""
    k, c = np.divmod(np.arange(4 * F), F)
    return (4 * c + k) % F


def _pad32(n: int) -> int:
    return -(-n // 32) * 32


def chunk_bytes(F: int, F3: int, tile: int) -> int:
    """Bytes of K8's chunk buffer per tile of ``tile`` pixels: per pixel bf16
    h1, the four phases of z, dz3's two halves, dzp and dz, and dh1p, each
    padded to 32."""
    Fp, F2p, F3p = _pad32(F), _pad32(2 * F), _pad32(F3)
    return tile * 2 * (12 * Fp + 2 * F2p + 8 * F3p)


def plan_chunks(P: int, F: int, F3: int, tile: int, sms: int):
    """K8's chunks of ``P`` pixels in tiles of ``tile`` pixels:
    ``(chunk_tiles, n_chunks)``.  At most one wave of tiles (``sms``) takes
    one chunk whatever its bytes; more take whole waves, as many as keep a
    chunk's buffer within ``CHUNK_BYTES`` (at least one)."""
    n_tiles = -(-P // tile)
    if n_tiles <= sms:
        return n_tiles, 1
    waves = max(1, CHUNK_BYTES // (sms * chunk_bytes(F, F3, tile)))
    chunk_tiles = min(n_tiles, sms * waves)
    return chunk_tiles, -(-n_tiles // chunk_tiles)


def group_rows(smem, P: int, sms: int, tile_bytes=None) -> int:
    """The row groups of a kernel's tile (its tile is 64 times as many
    pixels): the most of 4, 2, 1 whose shared memory (``smem(nrg)``, bytes)
    fits, whose tiles still make about one per SM (at least 7/8 of ``sms``)
    and, given ``tile_bytes(tile pixels)``, whose wave of tiles keeps K8's
    chunk within ``CHUNK_BYTES``; else 1.  Raises if not even 1 fits."""
    for nrg in (4, 2, 1):
        if smem(nrg) > SMEM_LIMIT:
            continue
        tile = GROUP_PIXELS * nrg
        tiles = -(-P // tile)
        small = tile_bytes is None or min(tiles, sms) * tile_bytes(tile) <= CHUNK_BYTES
        if nrg == 1 or (tiles >= sms - sms // 8 and small):
            return nrg
    raise ValueError(f"the block's widths need {smem(1)} bytes of shared memory per tile, more "
                     f"than {SMEM_LIMIT}")


class UpsampleGrads(NamedTuple):
    """Cotangents of :class:`FusedUpsample`'s inputs; weights f32."""

    dx: torch.Tensor  # [B, H, W, F] in x's dtype
    dW1: torch.Tensor  # [F, 2F]
    db1: torch.Tensor  # [2F]
    dW2g: torch.Tensor  # [2F, 4F]
    db2g: torch.Tensor  # [4F]
    dW3: torch.Tensor  # [F, F3]
    db3: torch.Tensor  # [F3]


def _lrelu(t):
    return torch.where(t > 0, t, 0.2 * t)


def _rounding(use_bf16: bool, dtype: torch.dtype):
    if not use_bf16:
        return lambda t: t
    return lambda t: t.to(torch.bfloat16).to(dtype)


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _chain(x, W1, b1, W2g, b2g, use_bf16):
    """The per-pixel chain up to z: ``(bf16(x), h1p, h1, zp, z)`` as
    ``[N, *]`` matrices in the compute dtype, rounded as the kernels round."""
    cd = _compute_dtype(x)
    rnd = _rounding(use_bf16, cd)
    F = x.shape[-1]
    xf = rnd(x.to(cd).reshape(-1, F))
    h1p = xf @ rnd(W1.to(cd)) + b1.to(cd)
    h1 = rnd(_lrelu(h1p))
    zp = h1 @ rnd(W2g.to(cd)) + b2g.to(cd)
    z = _lrelu(zp) + xf[:, torch.from_numpy(residual_index(F)).to(x.device)]
    return xf, h1p, h1, zp, z


def fused_upsample_reference(x, W1, b1, W2g, b2g, W3, b3, use_bf16: bool = True):
    """Plain K7: ``[B, H, W, F]`` -> ``[B, 2H, 2W, F3]`` in x's dtype, with
    the Pallas kernel's rounding points: with ``use_bf16``, x and the
    weights rounded to bf16, h1 rounded to bf16, z kept in f32 and rounded
    per phase before ``W3``, z3 in f32; the stencil sums in f32 and rounds
    once.  Computes in f32 (f64 for an f64 x)."""
    B, H, W, F = x.shape
    cd = _compute_dtype(x)
    rnd = _rounding(use_bf16, cd)
    _, _, _, _, z = _chain(x, W1, b1, W2g, b2g, use_bf16)
    w3 = rnd(W3.to(cd))
    z3 = torch.cat([rnd(z[:, k * F : (k + 1) * F]) @ w3 + b3.to(cd) for k in range(4)], -1)
    return shuffle_blur_reference(z3.reshape(B, H, W, -1), out_dtype=x.dtype)


def chunked_weight_grads(xf, dh1p, h1, dzp, z, dz3, chunk_pixels: int, rnd):
    """The weight gradients in K8's order: per chunk of ``chunk_pixels``
    pixels (the last one shorter) the contractions ``bf16(x)^T bf16(dh1p)``,
    ``h1^T bf16(dzp)`` and, over the chunk's ``[4 P, F]`` phase rows of z and
    dz3 (``z[P, 4F]`` read as ``[4P, F]``), ``bf16(z)^T bf16(dz3)``, the
    chunks' sums added in order (``kernels/field_dw.py``).  Returns ``(dW1,
    dW2g, dW3)``."""
    from gazenerf_tpu_torch.kernels.field_dw import weight_grad_reference

    P, F = xf.shape
    z4, d4 = rnd(z).reshape(4 * P, F), rnd(dz3).reshape(4 * P, -1)
    out = [None, None, None]
    for p0 in range(0, P, chunk_pixels):
        c = slice(p0, min(P, p0 + chunk_pixels))
        c4 = slice(4 * c.start, 4 * c.stop)
        for i, (a, b) in enumerate(((xf[c], rnd(dh1p[c])), (h1[c], rnd(dzp[c])),
                                    (z4[c4], d4[c4]))):
            out[i] = weight_grad_reference(a, b, out[i])
    return tuple(out)


def fused_upsample_backward_reference(
    x, W1, b1, W2g, b2g, W3, b3, dy, use_bf16: bool = True, chunk_pixels: Optional[int] = None
) -> UpsampleGrads:
    """Plain K8, written out with the Pallas kernel's formulas and rounding
    points: dz3 the stencil's adjoint of dy in f32; ``dz_k = dz3_k W3^T`` a
    product of f32 operands; ``dzp = lrelu'(zp) dz``; ``dh1 = bf16(dzp)
    bf16(W2g)^T``; ``dx = bf16(dh1p) bf16(W1)^T + P bf16(dz)``; weight
    gradients as products of bf16 activations and bf16-rounded cotangents,
    f32 bias sums.  ``dx`` in x's dtype, the rest in the compute dtype.
    Given ``chunk_pixels``, the weight gradients are summed in the kernel's
    chunked order (:func:`chunked_weight_grads`)."""
    B, H, W, F = x.shape
    F3 = W3.shape[1]
    cd = _compute_dtype(x)
    rnd = _rounding(use_bf16, cd)
    xf, h1p, h1, zp, z = _chain(x, W1, b1, W2g, b2g, use_bf16)
    dz3 = shuffle_blur_backward_reference(dy, out_dtype=cd).reshape(-1, 4 * F3)
    w3 = W3.to(cd)
    dW3 = torch.zeros_like(w3)
    dz = []
    for k in range(4):
        d3 = dz3[:, k * F3 : (k + 1) * F3]
        dz.append(d3 @ w3.t())
        dW3 = dW3 + rnd(z[:, k * F : (k + 1) * F]).t() @ rnd(d3)
    dz = torch.cat(dz, -1)
    db3 = dz3.reshape(-1, 4, F3).sum((0, 1))
    dzp = torch.where(zp > 0, dz, 0.2 * dz)
    dh1 = rnd(dzp) @ rnd(W2g.to(cd)).t()
    res = torch.from_numpy(residual_index(F)).to(x.device)
    dx_res = torch.zeros_like(xf).index_add_(1, res, rnd(dz))
    dh1p = torch.where(h1p > 0, dh1, 0.2 * dh1)
    dx = rnd(dh1p) @ rnd(W1.to(cd)).t() + dx_res
    if chunk_pixels is not None:
        dW1, dW2g, dW3 = chunked_weight_grads(xf, dh1p, h1, dzp, z, dz3, chunk_pixels, rnd)
        return UpsampleGrads(dx=dx.reshape(x.shape).to(x.dtype), dW1=dW1, db1=dh1p.sum(0),
                             dW2g=dW2g, db2g=dzp.sum(0), dW3=dW3, db3=db3)
    return UpsampleGrads(
        dx=dx.reshape(x.shape).to(x.dtype),
        dW1=xf.t() @ rnd(dh1p), db1=dh1p.sum(0),
        dW2g=h1.t() @ rnd(dzp), db2g=dzp.sum(0),
        dW3=dW3, db3=db3,
    )


def fused_upsample_backward_unrounded(x, W1, b1, W2g, b2g, W3, b3, dy,
                                      dtype: torch.dtype = torch.float64) -> UpsampleGrads:
    """The block's gradient with no rounding point: autograd in ``dtype``
    through :func:`fused_upsample_reference` with ``use_bf16=False``, on the
    inputs as given.  The yardstick of K8's accuracy."""
    args = [t.detach().to(dtype).requires_grad_(True) for t in (x, W1, b1, W2g, b2g, W3, b3)]
    with torch.enable_grad():
        y = fused_upsample_reference(*args, use_bf16=False)
        return UpsampleGrads(*torch.autograd.grad(y, args, dy.to(dtype)))


def _padded(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """A zero-padded bf16 copy of the matrix ``t``."""
    out = torch.zeros(rows, cols, dtype=torch.bfloat16, device=t.device)
    out[: t.shape[0], : t.shape[1]] = t
    return out


def _tile_x(x: torch.Tensor, rows: int) -> torch.Tensor:
    """bf16(x) as the kernels' tensor copies take it: ``[rows, pad(F)]``, zero
    past x's pixels and channels (x itself where nothing is padded)."""
    F = x.shape[-1]
    Fp, P = _pad32(F), x.numel() // F
    xb = x.reshape(P, F).to(torch.bfloat16)
    if Fp == F and rows == P:
        return xb.contiguous()
    out = torch.zeros(rows, Fp, dtype=torch.bfloat16, device=x.device)
    out[:P, :F] = xb
    return out


def _forward_operands(W1, W2g, W3):
    """The chain's bf16 weights as ``[N, K]`` matrices (out, in), K
    zero-padded to 32, built on every call (the weights change every
    training step): ``W1^T [2F, pad(F)]``, per phase ``W2g^T`` stacked
    ``[4 pad(F), pad(2F)]`` (rows past F of a phase zero), ``W3^T [F3,
    pad(F)]``."""
    F, F3 = W3.shape
    Fp, F2p = _pad32(F), _pad32(2 * F)
    w2t = torch.zeros(4, Fp, F2p, dtype=torch.bfloat16, device=W1.device)
    w2t[:, :F, : 2 * F] = W2g.t().reshape(4, F, 2 * F)
    return _padded(W1.t(), 2 * F, Fp), w2t.reshape(4 * Fp, F2p), _padded(W3.t(), F3, Fp)


def _backward_operands(W1, W2g, W3):
    """The data-gradient products' bf16 weights as ``[N, K]`` matrices, K
    zero-padded to 32: the f32 ``W3`` as a high and a low bf16 half ``[F,
    pad(F3)]``, ``W2g [2F, 4 pad(F)]`` (phase-padded columns), ``W1 [F,
    pad(2F)]``."""
    F, F3 = W3.shape
    Fp, F2p, F3p = _pad32(F), _pad32(2 * F), _pad32(F3)
    w2 = torch.zeros(2 * F, 4, Fp, dtype=torch.bfloat16, device=W1.device)
    w2[:, :, :F] = W2g.reshape(2 * F, 4, F)
    w3hi = _padded(W3, F, F3p)
    w3lo = _padded(W3.float() - w3hi[:, :F3].float(), F, F3p)
    return w3hi, w3lo, w2.reshape(2 * F, 4 * Fp), _padded(W1, F, F2p)


def _check_block(x, W1, b1, W2g, b2g, W3, b3):
    """Raise unless the block's tensors are what the kernels take (the
    weights may be views: the wrappers copy them into the kernels' layouts);
    returns (B, H, W, F, F3)."""
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x: shape {tuple(x.shape)}, dtype {x.dtype}: "
                         "expected [B, H, W, F] float32 or bfloat16")
    B, H, W, F = x.shape
    if W3.dim() != 2:
        raise ValueError(f"W3: shape {tuple(W3.shape)}, expected [F, F3]")
    F3 = W3.shape[1]
    if B * H * W * max(F, 4 * F3) >= 2**31:
        raise ValueError(f"x: {B * H * W} pixels of {F} channels (and {4 * F3} of dz3): the "
                         "kernels index them in 32 bits")
    for name, t, shape in (("W1", W1, (F, 2 * F)), ("b1", b1, (2 * F,)), ("W2g", W2g, (2 * F, 4 * F)),
                           ("b2g", b2g, (4 * F,)), ("W3", W3, (F, F3)), ("b3", b3, (F3,))):
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, expected "
                             f"float32 {shape} on {x.device}")
    return B, H, W, F, F3


def _is_cuda(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other
    device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no fused upsampler {what} kernel for device {t.device}")
    return True


def _forward_f32(x, W1, b1, W2g, b2g, W3, b3):
    """K7 at f32: every operand and product in f32, the output in x's dtype."""
    global launch_count_fwd_f32
    B, H, W, F, F3 = _check_block(x, W1, b1, W2g, b2g, W3, b3)
    lib = _library(KERNEL_F32)
    ins = [t.to(torch.float32).contiguous() for t in (x, W1, b1, W2g, b2g, W3, b3)]
    scratch = torch.empty((lib.fused_upsampler_f32_scratch(B * H * W, F, F3, 0),),
                          dtype=torch.float32, device=x.device)
    y = torch.empty((B, 2 * H, 2 * W, F3), dtype=x.dtype, device=x.device)
    err = lib.fused_upsampler_f32_fwd(
        *(t.data_ptr() for t in ins), scratch.data_ptr(), y.data_ptr(), B, H, W, F, F3,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{KERNEL_F32} forward launch failed with CUDA error {err}")
    launch_count_fwd_f32 += 1
    return y


def _backward_f32(x, W1, b1, W2g, b2g, W3, b3, dy) -> UpsampleGrads:
    """K8 at f32: the cotangents in f32 (dx in x's dtype), the weight
    gradients' sums in a fixed order."""
    global launch_count_bwd_f32
    B, H, W, F, F3 = _check_block(x, W1, b1, W2g, b2g, W3, b3)
    dev, P, f32 = x.device, B * H * W, torch.float32
    lib = _library(KERNEL_F32)
    xf, w1, b1, w2, b2g = (t.to(f32).contiguous() for t in (x, W1, b1, W2g, b2g))
    w3t, w2t, w1t = (t.t().contiguous() for t in (W3, W2g, W1))
    dyf = dy.to(f32).contiguous()
    scratch = torch.empty((lib.fused_upsampler_f32_scratch(P, F, F3, 1),), dtype=f32, device=dev)
    g = UpsampleGrads(
        dx=torch.empty((B, H, W, F), dtype=f32, device=dev),
        dW1=torch.empty((F, 2 * F), dtype=f32, device=dev),
        db1=torch.empty((2 * F,), dtype=f32, device=dev),
        dW2g=torch.empty((2 * F, 4 * F), dtype=f32, device=dev),
        db2g=torch.empty((4 * F,), dtype=f32, device=dev),
        dW3=torch.empty((F, F3), dtype=f32, device=dev),
        db3=torch.empty((F3,), dtype=f32, device=dev),
    )
    err = lib.fused_upsampler_f32_bwd(
        *(t.data_ptr() for t in (xf, dyf, w1, b1, w2, b2g, w3t, w2t, w1t, *g, scratch)),
        B, H, W, F, F3, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{KERNEL_F32} backward launch failed with CUDA error {err}")
    launch_count_bwd_f32 += 1
    return g._replace(dx=g.dx.to(x.dtype))


def f32_shapes(contract: bool) -> int:
    """The number of tile shapes of the f32 kernels' products (``contract``
    False) or of their weight gradients' contractions (True)."""
    return _library(KERNEL_F32).fused_upsampler_f32_shapes(int(contract))


def _f32_matrix(name: str, t: torch.Tensor, rows=None) -> None:
    if t.dim() != 2 or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected a contiguous float32 matrix")
    if rows is not None and t.shape[0] != rows:
        raise ValueError(f"{name}: {t.shape[0]} rows, expected {rows}")


def f32_product(a: torch.Tensor, w: torch.Tensor, shape: int = -1) -> torch.Tensor:
    """``a @ w`` of f32 matrices ``[M, K] x [K, N]`` in the f32 kernels'
    product tile (``csrc/fused_upsampler_f32.cu``), every output a chain of
    fused multiply-adds in increasing k from zero (K over 1,040: chunks of
    128 k, each such a chain, added in order), in tile shape ``shape`` (< 0:
    the one K7 and K8 pick; :func:`f32_shapes`).  The tile alone, for its
    checks; a CPU tensor takes ``a @ w``."""
    _f32_matrix("a", a)
    _f32_matrix("w", w, a.shape[1])
    if not _is_cuda(a, "product"):
        return a @ w
    M, K = a.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    err = _library(KERNEL_F32).fused_upsampler_f32_product(
        a.data_ptr(), K, w.data_ptr(), N, out.data_ptr(), M, N, K, shape,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"{KERNEL_F32} product launch failed with CUDA error {err}")
    return out


def f32_contract(a: torch.Tensor, b: torch.Tensor, shape: int = -1):
    """``(a^T b, b.sum(0))`` of f32 matrices ``[rows, M]`` and ``[rows, N]``
    in K8's weight-gradient contraction at f32: slices of 1,024 rows, each in
    stages of 16 summed from zero, the slices pairwise; in tile shape
    ``shape`` (< 0: the one K8 picks).  The contraction alone, for its
    checks; CPU tensors take ``a.t() @ b`` and ``b.sum(0)``."""
    _f32_matrix("a", a)
    _f32_matrix("b", b, a.shape[0])
    if not _is_cuda(a, "contraction"):
        return a.t() @ b, b.sum(0)
    rows, M = a.shape
    N = b.shape[1]
    lib = _library(KERNEL_F32)
    part = torch.empty((lib.fused_upsampler_f32_part(rows, M, N),), dtype=torch.float32,
                       device=a.device)
    dw = torch.empty((M, N), dtype=torch.float32, device=a.device)
    db = torch.empty((N,), dtype=torch.float32, device=a.device)
    err = lib.fused_upsampler_f32_contract(
        a.data_ptr(), b.data_ptr(), rows, M, N, part.data_ptr(), dw.data_ptr(), db.data_ptr(),
        shape, torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"{KERNEL_F32} contraction launch failed with CUDA error {err}")
    return dw, db


def fused_upsample_forward(x, W1, b1, W2g, b2g, W3, b3, use_bf16: bool = True):
    """K7's wrapper: ``[B, H, W, F]`` -> ``[B, 2H, 2W, F3]`` in x's dtype.
    CUDA tensors launch the kernel (on the current stream, no
    synchronisation); CPU tensors take :func:`fused_upsample_reference`."""
    global launch_count_fwd
    if not _is_cuda(x, "forward"):
        return fused_upsample_reference(x, W1, b1, W2g, b2g, W3, b3, use_bf16)
    if not use_bf16:
        return _forward_f32(x, W1, b1, W2g, b2g, W3, b3)
    B, H, W, F, F3 = _check_block(x, W1, b1, W2g, b2g, W3, b3)
    lib = _library(KERNEL_FWD)
    nrg = group_rows(lambda n: lib.fused_upsampler_fwd_smem(F, F3, n), B * H * W, _sms(x.device))
    xb = x.to(torch.bfloat16).contiguous()  # the kernel's rounding of x
    w1t, w2t, w3t = _forward_operands(W1, W2g, W3)
    b1, b2g, b3 = (t.contiguous() for t in (b1, b2g, b3))
    z3 = torch.empty((B * H * W, 4 * F3), dtype=torch.float32, device=x.device)
    y = torch.empty((B, 2 * H, 2 * W, F3), dtype=x.dtype, device=x.device)
    err = lib.fused_upsampler_fwd(
        xb.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(), b2g.data_ptr(),
        w3t.data_ptr(), b3.data_ptr(), z3.data_ptr(), y.data_ptr(), B, H, W, F, F3, nrg,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{KERNEL_FWD} launch failed with CUDA error {err}")
    launch_count_fwd += 1
    return y


def _library(name: str) -> ctypes.CDLL:
    lib = build.load(name, DEFINES)
    if name == KERNEL_F32:
        ll, i = ctypes.c_longlong, ctypes.c_int
        lib.fused_upsampler_f32_scratch.argtypes = [ll, i, i, i]
        lib.fused_upsampler_f32_scratch.restype = ll
        lib.fused_upsampler_f32_shapes.argtypes = [i]
        lib.fused_upsampler_f32_shapes.restype = i
        lib.fused_upsampler_f32_product.argtypes = [ctypes.c_void_p, i, ctypes.c_void_p, i,
                                                    ctypes.c_void_p, ll, i, i, i, ctypes.c_void_p]
        lib.fused_upsampler_f32_product.restype = i
        lib.fused_upsampler_f32_part.argtypes = [ll, i, i]
        lib.fused_upsampler_f32_part.restype = ll
        lib.fused_upsampler_f32_contract.argtypes = [ctypes.c_void_p] * 2 + [ll, i, i] + [
            ctypes.c_void_p] * 3 + [i, ctypes.c_void_p]
        lib.fused_upsampler_f32_contract.restype = i
        lib.fused_upsampler_f32_fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        lib.fused_upsampler_f32_fwd.restype = ctypes.c_int
        lib.fused_upsampler_f32_bwd.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.fused_upsampler_f32_bwd.restype = ctypes.c_int
    elif name == KERNEL_FWD:
        lib.fused_upsampler_fwd_smem.argtypes = [ctypes.c_int] * 3
        lib.fused_upsampler_fwd_smem.restype = ctypes.c_longlong
        lib.fused_upsampler_fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.fused_upsampler_fwd.restype = ctypes.c_int
    else:
        lib.fused_upsampler_bwd_smem.argtypes = [ctypes.c_int] * 3
        lib.fused_upsampler_bwd_smem.restype = ctypes.c_longlong
        lib.fused_upsampler_bwd_layout.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.fused_upsampler_bwd_layout.restype = None
        lib.fused_upsampler_bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        lib.fused_upsampler_bwd.restype = ctypes.c_int
    return lib


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_upsample_backward(x, W1, b1, W2g, b2g, W3, b3, dy, use_bf16: bool = True) -> UpsampleGrads:
    """K8's wrapper: the block's cotangents for the output cotangent ``dy``
    (``[B, 2H, 2W, F3]``); the kernel for CUDA tensors,
    :func:`fused_upsample_backward_reference` for CPU tensors.  The weight
    gradients are summed in a fixed order: two calls on the same inputs give
    the same bits."""
    global launch_count_bwd
    if not _is_cuda(x, "backward"):
        return fused_upsample_backward_reference(x, W1, b1, W2g, b2g, W3, b3, dy, use_bf16)
    B, H, W, F, F3 = _check_block(x, W1, b1, W2g, b2g, W3, b3)
    if dy.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dy: dtype {dy.dtype}, expected float32 or bfloat16")
    check_tensor("dy", dy, x.device, dy.dtype, (B, 2 * H, 2 * W, F3))
    if not use_bf16:
        return _backward_f32(x, W1, b1, W2g, b2g, W3, b3, dy)
    dev, P = x.device, B * H * W
    lib = _library(KERNEL_BWD)
    sms = _sms(dev)
    nrg = group_rows(lambda n: lib.fused_upsampler_bwd_smem(F, F3, n), P, sms,
                     lambda tile: chunk_bytes(F, F3, tile))
    tile = GROUP_PIXELS * nrg
    chunk_tiles, n_chunks = plan_chunks(P, F, F3, tile, sms)
    offs = (ctypes.c_longlong * 6)()
    lib.fused_upsampler_bwd_layout(B, H, W, F, F3, nrg, chunk_tiles, sms, offs)
    n_tiles = -(-P // tile)
    xb = _tile_x(x, n_tiles * tile)  # also dW1's operand, in whole tiles
    w1t, w2t, _ = _forward_operands(W1, W2g, W3)
    w3hi, w3lo, w2, w1 = _backward_operands(W1, W2g, W3)
    b1, b2g = b1.contiguous(), b2g.contiguous()
    dx = torch.empty((B, H, W, F), dtype=x.dtype, device=dev)
    scratch = torch.empty((offs[5],), dtype=torch.uint8, device=dev)
    grads = torch.empty((offs[4],), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for i in range(n_chunks):
        t0 = i * chunk_tiles
        err = lib.fused_upsampler_bwd(
            xb.data_ptr(), dy.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
            b2g.data_ptr(), w3hi.data_ptr(), w3lo.data_ptr(), w2.data_ptr(), w1.data_ptr(),
            dx.data_ptr(), scratch.data_ptr(), grads.data_ptr(), B, H, W, F, F3, nrg,
            chunk_tiles, t0, min(chunk_tiles, n_tiles - t0), int(i == 0), int(i == n_chunks - 1),
            int(dy.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16), stream,
        )
        if err:
            raise RuntimeError(f"{KERNEL_BWD} launch failed with CUDA error {err}")
    launch_count_bwd += 1

    Fp, F2p, F3p = _pad32(F), _pad32(2 * F), _pad32(F3)

    def block(i, rows, cols):
        return grads[offs[i] : offs[i] + rows * cols].view(rows, cols)

    db = grads[offs[3] : offs[3] + 6 * F + F3]
    return UpsampleGrads(
        dx=dx, dW1=block(0, Fp, F2p)[:F, : 2 * F].contiguous(), db1=db[: 2 * F],
        dW2g=block(1, F2p, 4 * Fp).view(F2p, 4, Fp)[: 2 * F, :, :F].reshape(2 * F, 4 * F),
        db2g=db[2 * F : 6 * F], dW3=block(2, Fp, F3p)[:F, :F3].contiguous(), db3=db[6 * F :],
    )


class FusedUpsample(torch.autograd.Function):
    """The fused block with K8 as its gradient (the JAX package's
    ``fused_upsample_block`` custom VJP).  Inputs ``x, W1, b1, W2g, b2g,
    W3, b3`` (f32 weights ``[in, out]``), then ``use_bf16``; the output is
    ``[B, 2H, 2W, F3]`` in x's dtype, before the renderer's lrelu.  Saves
    its inputs only: the backward recomputes the chain."""

    @staticmethod
    def forward(ctx, x, W1, b1, W2g, b2g, W3, b3, use_bf16):
        ctx.save_for_backward(x, W1, b1, W2g, b2g, W3, b3)
        ctx.use_bf16 = use_bf16
        return fused_upsample_forward(x, W1, b1, W2g, b2g, W3, b3, use_bf16)

    @staticmethod
    def backward(ctx, dy):
        g = fused_upsample_backward(*ctx.saved_tensors, dy.contiguous(), ctx.use_bf16)
        return (*g, None)
