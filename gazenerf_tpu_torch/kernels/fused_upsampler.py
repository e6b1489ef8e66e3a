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
``csrc/fused_upsampler_bwd.cu``; their headers state the bound and the
design); each takes the bf16 configuration (``use_bf16=True``).

* :func:`fused_upsample_reference` / :func:`fused_upsample_backward_reference`:
  the plain versions with the Pallas kernels' rounding points, for
  ``use_bf16`` True and False;
* :func:`fused_upsample_forward` / :func:`fused_upsample_backward`: the
  wrappers, the kernels for CUDA tensors, the plain versions for CPU tensors;
* :class:`FusedUpsample`: the autograd op, whose backward is K8.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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
DEFINES: dict = {}
TILE_PIXELS = 32  # pixels per tile in both kernels (csrc/tile_mma.cuh kRows)

# kernel launches since import (or since a caller reset them): K7 and K8.  A
# renderer pass in shuffle_mode="fused" makes one K7 launch per upsample
# block (each is two CUDA launches, the chain and the stencil, counted
# once); its backward one K8 launch per block (three CUDA launches: the
# stencil's adjoint, the chain's backward, the slab sum).
launch_count_fwd = 0
launch_count_bwd = 0

_ROADMAP_F32 = (
    "the fused upsampler kernels take the bf16 renderer (use_bf16=True) only; "
    "the f32 renderer's fused mode on the card is ROADMAP.md Queue 2, remaining mode 5"
)


def residual_index(F: int) -> np.ndarray:
    """The row of the single 1 in each column of the residual matrix ``P``:
    ``(x @ P)[k*F + c] = x[(4c + k) % F]``."""
    k, c = np.divmod(np.arange(4 * F), F)
    return (4 * c + k) % F


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


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


def fused_upsample_backward_reference(
    x, W1, b1, W2g, b2g, W3, b3, dy, use_bf16: bool = True
) -> UpsampleGrads:
    """Plain K8, written out with the Pallas kernel's formulas and rounding
    points: dz3 the stencil's adjoint of dy in f32; ``dz_k = dz3_k W3^T`` a
    product of f32 operands; ``dzp = lrelu'(zp) dz``; ``dh1 = bf16(dzp)
    bf16(W2g)^T``; ``dx = bf16(dh1p) bf16(W1)^T + P bf16(dz)``; weight
    gradients as products of bf16 activations and bf16-rounded cotangents,
    f32 bias sums.  ``dx`` in x's dtype, the rest in the compute dtype."""
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


def _forward_operands(W1, W2g, W3):
    """The chain's bf16 weights, ``[out, in]`` and zero-padded to the mma
    tile, built on every call (the weights change every training step):
    ``W1^T [pad(2F), pad(F)]``, per phase ``W2g^T [4, pad(F), pad(2F)]``,
    ``W3^T [pad(F3), pad(F)]``."""
    F, F3 = W3.shape
    Fp, F2p, F3p = _pad16(F), _pad16(2 * F), _pad16(F3)
    w2f = torch.zeros(4, Fp, F2p, dtype=torch.bfloat16, device=W1.device)
    w2f[:, :F, : 2 * F] = W2g.t().reshape(4, F, 2 * F)
    return _padded(W1.t(), F2p, Fp), w2f, _padded(W3.t(), F3p, Fp)


def _backward_operands(W1, W2g, W3):
    """The data-gradient products' bf16 weights: ``W1 [pad(F), pad(2F)]``,
    ``W2g [pad(2F), 4 pad(F)]`` (phase-padded columns) and the f32 ``W3`` as
    a high and a low bf16 half ``[pad(F), pad(F3)]``."""
    F, F3 = W3.shape
    Fp, F2p, F3p = _pad16(F), _pad16(2 * F), _pad16(F3)
    w2b = torch.zeros(F2p, 4, Fp, dtype=torch.bfloat16, device=W1.device)
    w2b[: 2 * F, :, :F] = W2g.reshape(2 * F, 4, F)
    w3hi = _padded(W3, Fp, F3p)
    w3lo = _padded(W3.float() - w3hi[:F, :F3].float(), Fp, F3p)
    return _padded(W1, Fp, F2p), w2b.reshape(F2p, 4 * Fp), w3hi, w3lo


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
    for name, t, shape in (("W1", W1, (F, 2 * F)), ("b1", b1, (2 * F,)), ("W2g", W2g, (2 * F, 4 * F)),
                           ("b2g", b2g, (4 * F,)), ("W3", W3, (F, F3)), ("b3", b3, (F3,))):
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, expected "
                             f"float32 {shape} on {x.device}")
    return B, H, W, F, F3


def _is_cuda(t: torch.Tensor, use_bf16: bool, what: str) -> bool:
    """True for a CUDA tensor (which must take the bf16 kernel), False for a
    CPU one; raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no fused upsampler {what} kernel for device {t.device}")
    if not use_bf16:
        raise NotImplementedError(_ROADMAP_F32)
    return True


def fused_upsample_forward(x, W1, b1, W2g, b2g, W3, b3, use_bf16: bool = True):
    """K7's wrapper: ``[B, H, W, F]`` -> ``[B, 2H, 2W, F3]`` in x's dtype.
    CUDA tensors launch the kernel (on the current stream, no
    synchronisation); CPU tensors take :func:`fused_upsample_reference`."""
    global launch_count_fwd
    if not _is_cuda(x, use_bf16, "forward"):
        return fused_upsample_reference(x, W1, b1, W2g, b2g, W3, b3, use_bf16)
    B, H, W, F, F3 = _check_block(x, W1, b1, W2g, b2g, W3, b3)
    xb = x.to(torch.bfloat16).contiguous()  # the kernel's rounding of x
    w1f, w2f, w3f = _forward_operands(W1, W2g, W3)
    b1, b2g, b3 = (t.contiguous() for t in (b1, b2g, b3))
    z3 = torch.empty((B * H * W, 4 * F3), dtype=torch.float32, device=x.device)
    y = torch.empty((B, 2 * H, 2 * W, F3), dtype=x.dtype, device=x.device)
    err = _library(KERNEL_FWD).fused_upsampler_fwd(
        xb.data_ptr(), w1f.data_ptr(), b1.data_ptr(), w2f.data_ptr(), b2g.data_ptr(),
        w3f.data_ptr(), b3.data_ptr(),
        z3.data_ptr(), y.data_ptr(), B, H, W, F, F3, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{KERNEL_FWD} launch failed with CUDA error {err}")
    launch_count_fwd += 1
    return y


def _library(name: str) -> ctypes.CDLL:
    lib = build.load(name, DEFINES)
    if name == KERNEL_FWD:
        lib.fused_upsampler_fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.fused_upsampler_fwd.restype = ctypes.c_int
    else:
        lib.fused_upsampler_bwd_layout.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.fused_upsampler_bwd_layout.restype = None
        lib.fused_upsampler_bwd.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.fused_upsampler_bwd.restype = ctypes.c_int
    return lib


def _bwd_layout(lib, F: int, F3: int):
    out = (ctypes.c_longlong * 7)()
    lib.fused_upsampler_bwd_layout(F, F3, out)
    return list(out)


def fused_upsample_backward(x, W1, b1, W2g, b2g, W3, b3, dy, use_bf16: bool = True) -> UpsampleGrads:
    """K8's wrapper: the block's cotangents for the output cotangent ``dy``
    (``[B, 2H, 2W, F3]``); the kernel for CUDA tensors,
    :func:`fused_upsample_backward_reference` for CPU tensors.  The weight
    gradients are summed in a fixed order: two calls on the same inputs give
    the same bits."""
    global launch_count_bwd
    if not _is_cuda(x, use_bf16, "backward"):
        return fused_upsample_backward_reference(x, W1, b1, W2g, b2g, W3, b3, dy, use_bf16)
    B, H, W, F, F3 = _check_block(x, W1, b1, W2g, b2g, W3, b3)
    if dy.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dy: dtype {dy.dtype}, expected float32 or bfloat16")
    check_tensor("dy", dy, x.device, dy.dtype, (B, 2 * H, 2 * W, F3))
    xb = x.to(torch.bfloat16).contiguous()
    w1f, w2f, _ = _forward_operands(W1, W2g, W3)
    w1b, w2b, w3hi, w3lo = _backward_operands(W1, W2g, W3)
    b1, b2g = b1.contiguous(), b2g.contiguous()
    lib = _library(KERNEL_BWD)
    offs = _bwd_layout(lib, F, F3)
    n_tiles = -(-B * H * W // TILE_PIXELS)
    G = min(n_tiles, torch.cuda.get_device_properties(x.device).multi_processor_count)
    dev = x.device
    dz3 = torch.empty((B * H * W, 4 * F3), dtype=torch.float32, device=dev)
    dx = torch.empty((B, H, W, F), dtype=x.dtype, device=dev)
    slabs = torch.empty((G, offs[6]), dtype=torch.float32, device=dev)
    grads = torch.empty(offs[6], dtype=torch.float32, device=dev)
    err = lib.fused_upsampler_bwd(
        xb.data_ptr(), dy.data_ptr(), w1f.data_ptr(), b1.data_ptr(),
        w2f.data_ptr(), b2g.data_ptr(), w1b.data_ptr(), w2b.data_ptr(),
        w3hi.data_ptr(), w3lo.data_ptr(), dz3.data_ptr(), dx.data_ptr(), slabs.data_ptr(),
        grads.data_ptr(), B, H, W, F, F3, G, int(dy.dtype == torch.bfloat16),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{KERNEL_BWD} launch failed with CUDA error {err}")
    launch_count_bwd += 1

    def part(i, shape):
        n = int(np.prod(shape))
        return grads[offs[i] : offs[i] + n].view(shape)

    return UpsampleGrads(
        dx=dx, dW1=part(0, (F, 2 * F)), db1=part(1, (2 * F,)), dW2g=part(2, (2 * F, 4 * F)),
        db2g=part(3, (4 * F,)), dW3=part(4, (F, F3)), db3=part(5, (F3,)),
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
