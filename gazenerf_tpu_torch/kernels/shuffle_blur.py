"""Blur-shuffle stencil: K5 (forward) and K6 (its adjoint).

Counterpart of the JAX package's ``kernels/shuffle_blur.py``: its Pallas
``_fwd_kernel`` (launched by ``_stencil_fwd``) and ``_bwd_kernel`` (launched
by ``_stencil_bwd``), wrapped by the custom VJP ``pallas_shuffle_blur_gm``.
The kernels are hand-written CUDA for Hopper (``csrc/shuffle_blur.cu`` and
``csrc/phase_stencil.cuh``; the header states the bound and the design): a
CTA walks a strip of columns down its rows with the rows it needs in a
shared-memory ring, one row copied per step, so each input byte is read
from device memory about once, and a thread computes the 2 x 2 outputs of a
pixel over up to 16 bytes of channels from their shared neighbourhood.

* :func:`shuffle_blur_reference` / :func:`shuffle_blur_backward_reference`:
  the plain versions, with the kernels' rounding points (f32 sums, one
  rounding to the output type) and their summation order, so that a kernel
  and its plain version give the same bits;
* :func:`shuffle_blur_forward` / :func:`shuffle_blur_backward`: the
  wrappers, the kernel for CUDA tensors, the plain version for CPU tensors;
* :class:`ShuffleBlur` and :func:`shuffle_blur_gm`: the autograd op, whose
  backward is K6.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gazenerf_tpu_torch.kernels import build
from gazenerf_tpu_torch.ops.image import pixel_shuffle2_blur_gm, sum_dtype

KERNEL = "shuffle_blur"
DEFINES: dict = {}

# kernel launches since import (or since a caller reset them): K5 and K6.
# A renderer pass in shuffle_mode="pallas" makes one K5 launch per upsample
# block; its backward one K6 launch per block.
launch_count_fwd = 0
launch_count_bwd = 0

_DTYPES = (torch.float32, torch.bfloat16)


def shuffle_blur_reference(x: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
    """Plain K5: ``blur3x3(pixel_shuffle2(x))`` for a group-major ``x``
    ``[B, H, W, 4C]`` (channel ``k*C + c`` is shuffle phase k of channel c)
    -> ``[B, 2H, 2W, C]``: the nine taps summed in f32 (f64 for f64) in the
    kernel's order, rounded once to ``out_dtype`` (x's by default)."""
    return pixel_shuffle2_blur_gm(x).to(out_dtype or x.dtype)


def _adjoint_axis(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The stencil's 1-D adjoint along ``dim``: position M takes 0.5 of
    output M and 0.25 of outputs M - 1 and M + 1, plus the reflected taps
    (output 0 reads position 1, output L - 1 reads L - 2); summed as
    ``prev + mid + next``, the kernel's order."""
    L = t.shape[dim]
    idx = torch.arange(L, device=t.device)
    shape = [1] * t.dim()
    shape[dim] = L
    w_prev = torch.where(idx == 1, 0.5, 0.25).masked_fill(idx == 0, 0.0)
    w_next = torch.where(idx == L - 2, 0.5, 0.25).masked_fill(idx == L - 1, 0.0)
    prev = t.index_select(dim, (idx - 1).clamp(min=0))
    nxt = t.index_select(dim, (idx + 1).clamp(max=L - 1))
    w_prev, w_next = (w.to(t.dtype).reshape(shape) for w in (w_prev, w_next))
    return w_prev * prev + 0.5 * t + w_next * nxt


def space_to_depth_gm(y: torch.Tensor) -> torch.Tensor:
    """``[B, 2H, 2W, C]`` -> ``[B, H, W, 4C]`` group-major phases."""
    B, H2, W2, C = y.shape
    y = y.reshape(B, H2 // 2, 2, W2 // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, H2 // 2, W2 // 2, 4 * C)


def shuffle_blur_backward_reference(dy: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
    """Plain K6: the adjoint of :func:`shuffle_blur_reference`, ``[B, 2H,
    2W, C]`` -> ``[B, H, W, 4C]`` group-major; the transposed stencil with
    the edge folds, separable (columns, then rows), summed in f32 (f64 for
    f64) and rounded once to ``out_dtype`` (dy's by default)."""
    t = dy.to(sum_dtype(dy.dtype))
    t = _adjoint_axis(_adjoint_axis(t, 2), 1)
    return space_to_depth_gm(t).to(out_dtype or dy.dtype)


_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL, DEFINES)
    for fn in (lib.shuffle_blur_fwd, lib.shuffle_blur_bwd):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, ndim: int = 4) -> None:
    if t.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes float32 or bfloat16")
    if t.dim() != ndim:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {ndim} dimensions")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _device_ok(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {t.device}")
    return True


def shuffle_blur_forward(x: torch.Tensor) -> torch.Tensor:
    """K5's wrapper: ``[B, H, W, 4C]`` group-major -> ``[B, 2H, 2W, C]`` in
    x's dtype.  CUDA tensors launch the kernel (on the current stream, no
    synchronisation); CPU tensors take :func:`shuffle_blur_reference`."""
    global launch_count_fwd
    if not _device_ok(x, "shuffle-blur"):
        return shuffle_blur_reference(x)
    _check("x", x)
    B, H, W, C4 = x.shape
    if C4 % 4:
        raise ValueError(f"x: {C4} channels, not a multiple of 4")
    y = torch.empty((B, 2 * H, 2 * W, C4 // 4), dtype=x.dtype, device=x.device)
    err = _library().shuffle_blur_fwd(
        x.data_ptr(), y.data_ptr(), B, H, W, C4 // 4, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"shuffle_blur_fwd launch failed with CUDA error {err}")
    launch_count_fwd += 1
    return y


def shuffle_blur_backward(dy: torch.Tensor) -> torch.Tensor:
    """K6's wrapper: ``[B, 2H, 2W, C]`` -> ``[B, H, W, 4C]`` group-major in
    dy's dtype; the kernel for CUDA tensors,
    :func:`shuffle_blur_backward_reference` for CPU tensors."""
    global launch_count_bwd
    if not _device_ok(dy, "shuffle-blur backward"):
        return shuffle_blur_backward_reference(dy)
    _check("dy", dy)
    B, H2, W2, C = dy.shape
    if H2 % 2 or W2 % 2:
        raise ValueError(f"dy: shape {tuple(dy.shape)}, the sides must be even")
    dx = torch.empty((B, H2 // 2, W2 // 2, 4 * C), dtype=dy.dtype, device=dy.device)
    err = _library().shuffle_blur_bwd(
        dy.data_ptr(), dx.data_ptr(), B, H2 // 2, W2 // 2, C, int(dy.dtype == torch.bfloat16),
        torch.cuda.current_stream(dy.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"shuffle_blur_bwd launch failed with CUDA error {err}")
    launch_count_bwd += 1
    return dx


class ShuffleBlur(torch.autograd.Function):
    """``blur3x3(pixel_shuffle2(x))`` for a group-major ``x``, in x's dtype,
    with K6 as its gradient (the JAX package's ``pallas_shuffle_blur_gm``
    custom VJP)."""

    @staticmethod
    def forward(ctx, x):
        return shuffle_blur_forward(x.contiguous())

    @staticmethod
    def backward(ctx, dy):
        # autograd hands dy in the output's dtype, which is x's
        return shuffle_blur_backward(dy.contiguous())


def shuffle_blur_gm(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 4C]`` group-major -> ``[B, 2H, 2W, C]`` through
    :class:`ShuffleBlur` (the renderer's ``shuffle_mode="pallas"``)."""
    return ShuffleBlur.apply(x)
