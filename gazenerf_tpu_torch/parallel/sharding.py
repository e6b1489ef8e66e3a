"""The training step on a :class:`~gazenerf_tpu_torch.parallel.mesh.Mesh`:
the batch and ray split, the featmap gather and the gradient reduction.

The port's counterpart of the JAX package's ``parallel/sharding.py``.
There XLA partitions the single-device step over ``P("data", "ray")``;
here each process runs its block of it and the collectives below make the
``dp x rp`` processes compute the single-device step on the global batch:
the same loss, gradients and updated state, up to the order of sums.

* Rows and rays: a process takes its data index's rows of the batch and
  its ray index's contiguous rays of each image (:func:`ray_slice`); the
  jitter is drawn for the global batch from the trainer's generator, alike
  on every process, and sliced (:func:`draw_uniform`), so the draws are
  the single-device step's and the generators stay equal.
* The gather: where rays are split (``rp > 1``), the fields' features and
  background alphas are gathered over the ray group (:func:`gather_rays`)
  before the featmaps merge and the eye planes rotate (the rotation
  resamples across rays); the weights and depths, which no loss reads,
  stay the process's.  The renderer, the losses and the discriminator then
  run on whole images, alike on the ray group.
* The reduction: each process's loss is scaled by ``1 / (dp * rp)``
  (:func:`loss_scale`), the gather's backward hands ``rp`` times the
  process's slice of the featmap cotangent back to its fields, and every
  gradient is summed over the world (:func:`reduce_gradients`).  The
  gradients that reach a parameter through the gathered rays are partial
  (each process holds its rays' part) and those through the replicated
  renderer and code regularisers whole (the ray group holds ``rp`` equal
  copies): the scaling counts each once.
* Batch statistics: a masked mean divides by the mask's sum over the whole
  batch (:func:`mask_denominators`), and the discriminator's BatchNorm
  normalises by the whole batch's mean and ``E[x^2]``
  (:func:`batch_stats`, with a gradient).

Only ``all_reduce`` runs, which every backend has on every device (gloo
on CUDA tensors too): the gather sums a zero-filled full tensor into which each
process writes its slice, and adding zeros is exact.  One code path then
runs on gloo over the CPU or CUDA tensors and on NCCL.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from gazenerf_tpu_torch.parallel.mesh import Mesh


def row_slice(mesh: Mesh, rows: int) -> slice:
    """The process's contiguous rows of a global batch of ``rows``."""
    per = rows // mesh.data_parallel
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def ray_slice(mesh: Mesh, rays: int) -> slice:
    """The process's contiguous rays of an image of ``rays`` rays."""
    per = rays // mesh.ray_parallel
    return slice(mesh.ray_index * per, (mesh.ray_index + 1) * per)


def local_block(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The process's block ``[rows, rays, ...]`` of a global ``[B, R, ...]``
    tensor (the jitter draws)."""
    return t[row_slice(mesh, t.shape[0]), ray_slice(mesh, t.shape[1])]


def draw_uniform(mesh: Mesh, generator: torch.Generator, local_shape, dtype, device
                 ) -> torch.Tensor:
    """Uniform draws for the process's block ``local_shape = (rows, rays,
    n)``: the global batch's ``[rows * dp, rays * rp, n]`` drawn from
    ``generator``, as the single-device step draws them, then sliced."""
    b, r, n = local_shape
    full = torch.rand((b * mesh.data_parallel, r * mesh.ray_parallel, n), generator=generator,
                      dtype=dtype, device=device)
    return local_block(mesh, full)


class _GatherRays(torch.autograd.Function):
    """``[B, r, K]`` per process -> ``[B, r * rp, K]`` over the ray group;
    the backward returns ``rp`` times the process's slice of the
    cotangent."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        B, r, K = x.shape
        sl = slice(mesh.ray_index * r, (mesh.ray_index + 1) * r)
        full = x.new_zeros((B, r * mesh.ray_parallel, K))
        full[:, sl] = x
        return mesh.all_reduce(full, group="ray", kind="gather")

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return g[:, ray_slice(mesh, g.shape[1])] * mesh.ray_parallel, None


def gather_rays(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The ray group's ``[B, r, K]`` blocks joined into ``[B, R, K]`` in
    ray order (bit for bit the unsharded tensor), with the backward that
    :func:`loss_scale` assumes."""
    return _GatherRays.apply(x, mesh)


def loss_scale(mesh: Mesh) -> float:
    """The factor of each process's loss in the backward: ``1 / (dp * rp)``."""
    return 1.0 / mesh.size


def mask_denominators(mesh: Mesh, sums: torch.Tensor) -> torch.Tensor:
    """Masked means' denominators from the process's mask sums: the whole
    batch's sums (over the data group), clamped at 1 as a single-device
    masked mean clamps them, over ``dp``; the process's rows' mean then
    averages over the data group to the single-device mean."""
    total = mesh.all_reduce(sums.clone(), group="data", kind="stats")
    return torch.clamp(total, min=1.0) / mesh.data_parallel


def batch_stats(mesh: Mesh, stats: torch.Tensor) -> torch.Tensor:
    """Per-row-mean statistics of the process's rows (a BatchNorm's mean and
    ``E[x^2]``) -> the whole batch's, over the data group, with a gradient
    that reaches every process's rows."""
    return mesh.all_reduce_with_grad(stats, group="data") / mesh.data_parallel


def reduce_gradients(mesh: Mesh, params: Iterable[torch.Tensor],
                     extra: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Sum the gradients of ``params`` over the world, in place, in one
    collective per dtype over a flat bucket; parameters without a gradient
    (the same on every process: the graphs are the same) are left out.
    ``extra`` (a 1-D tensor) rides in the bucket of its dtype; returns its
    sum."""
    buckets = {}
    for p in params:
        if p.grad is not None:
            buckets.setdefault(p.grad.dtype, []).append(p.grad)
    if extra is not None:
        buckets.setdefault(extra.dtype, [])
    out = None
    for dtype, grads in buckets.items():
        parts = [g.reshape(-1) for g in grads]
        if extra is not None and extra.dtype == dtype:
            parts.append(extra)
        flat = mesh.all_reduce(torch.cat(parts), kind="reduce")
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        if extra is not None and extra.dtype == dtype:
            out = flat[at:]
    return out
