"""The hand-written kernels held against their plain versions on the card.

``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py`` both hold the
kernels to what this module states: the seeded cases, the limits, and the
readings the limits were set from.  Nothing here builds or launches a
kernel; the caller does.

The fused field backward (K2) is held two ways:

* against its plain version, per output and per case, to a limit of
  ``K2_LIMIT_FACTOR`` times the case's reading, and never below
  ``K2_LIMIT_FLOOR``.  In the narrow case (hidden 64) the kernel and the plain
  version round at the same points and agree to f32 noise, so its limits
  hold the data gradients to f32 accuracy: a kernel that keeps them at bf16
  accuracy fails there.  At wider layers the summation order flips some bf16
  roundings and ReLU masks, and the two differ by up to a few percent;
* against the unrounded float64 gradient: per output, the kernel's relative
  L2 distance from it is at most ``K2_TRUTH_RATIO`` times the larger of the
  plain version's and the plain version's computed in float64 between the
  same rounding points.

The renderer's kernels are held the same way: the blur-shuffle stencil
(K5, K6) to the bit against its plain version; the fused upsampler block
(K7, K8) per output and per case against its plain version, and K8 also
against the unrounded float64 gradient.  So are the dual-branch kernels:
the forward (K3) per output and stash slot against its plain version and,
without the stash, to the bit against K1 on each branch; the stash-reading
backward (K4) per output against its plain version, against K2 on each
branch and against the unrounded float64 gradient; K1 writing the single-branch
stash and K2 reading it, with and without ``dens_vpu``, against their
plain versions, K2 also against its recompute mode on the same inputs and
against the unrounded float64 gradient.  The weight-gradient GEMM
the two backwards share (``kernels/field_dw.py``) is held per product
against its plain version, chunk by chunk.  Rays longer than one tile (S =
128, 192, 256: the deep cases) are held the same way: K1 and K2 per output
against their plain versions (K2's summing its weight gradients in the
kernel's chunks), K2 against the unrounded gradient, K1 writing the stash
and K2 reading it (the density masks of kernel and plain version equal at
every point), K3 against K1 per branch and K4 against K2 per branch.
JPEG frames (``kernels/jpeg.py``) are held to the bit: the pixel kernel
against its plain version and ``cv2.imread``'s committed pixels, the native
entropy decoder's coefficients against the plain decoder's.
"""

from __future__ import annotations

import collections
import contextlib
import struct
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from gazenerf_tpu_torch.kernels import fused_field as ff
from gazenerf_tpu_torch.kernels import fused_field2 as ff2
from gazenerf_tpu_torch.kernels import fused_field2_bwd as ffb2
from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb
from gazenerf_tpu_torch.kernels import fused_upsampler as fu
from gazenerf_tpu_torch.kernels import jpeg as kj
from gazenerf_tpu_torch.kernels import shuffle_blur as sb
from gazenerf_tpu_torch.models.mlp_nerf import NeRFFieldMLP
from gazenerf_tpu_torch.utils import jpeg as J
from gazenerf_tpu_torch.utils.png import decode_png

# K2's cases: (hidden, samples per ray, rays per batch), two batches
K2_CASES = {
    "narrow": (64, 8, 64),
    "medium": (128, 32, 8),
    "wide": (384, 64, 256),
    "training": (384, 64, 4096),  # the training step's width, samples and rays
}

# Per output, (max |kernel - plain| over max |plain|, relative L2 distance)
# in the cases narrow, medium, wide and training, with seed 0, on an NVIDIA
# H100 80GB HBM3 (700 W).
_K2_READINGS = {
    "dembed": ((6.6e-6, 4.1e-6), (4.8e-4, 9.8e-5), (3.3e-1, 2.0e-2), (4.2e-1, 1.3e-2)),
    "dzvals": ((0.0, 0.0), (9.2e-4, 2.3e-4), (2.0e-3, 7.5e-4), (3.5e-3, 7.7e-4)),
    "dzdists": ((2.2e-7, 2.2e-7), (1.1e-3, 2.9e-4), (3.2e-3, 1.0e-3), (2.8e-3, 9.3e-4)),
    "dcb0": ((6.4e-6, 5.5e-6), (7.3e-5, 5.9e-5), (3.0e-2, 2.3e-2), (5.7e-3, 6.5e-3)),
    "dcb5": ((3.9e-6, 4.1e-6), (4.2e-5, 3.1e-5), (1.3e-2, 1.7e-2), (3.5e-3, 3.2e-3)),
    "dcbr1": ((2.8e-7, 2.6e-7), (1.2e-4, 1.2e-4), (2.6e-3, 1.9e-3), (1.6e-3, 1.6e-3)),
    "dW0e": ((7.4e-5, 1.4e-5), (1.1e-3, 3.5e-4), (3.7e-2, 2.2e-2), (2.9e-2, 1.5e-2)),
    "dWmid": ((1.5e-3, 2.6e-4), (1.8e-4, 1.1e-4), (1.2e-2, 1.3e-2), (8.9e-3, 9.1e-3)),
    "dbmid": ((4.5e-6, 3.3e-6), (3.0e-5, 2.8e-5), (1.2e-2, 1.0e-2), (8.3e-3, 1.0e-2)),
    "dW5e": ((1.0e-6, 3.7e-7), (5.2e-4, 3.3e-4), (3.4e-2, 2.0e-2), (1.4e-2, 1.3e-2)),
    "dW5x": ((8.4e-7, 3.9e-7), (3.0e-4, 1.8e-4), (8.9e-3, 1.5e-2), (9.3e-3, 9.1e-3)),
    "dWd": ((9.0e-8, 3.8e-8), (1.1e-4, 3.3e-5), (1.2e-2, 1.0e-2), (1.5e-2, 1.4e-2)),
    "dbd": ((0.0, 0.0), (9.8e-6, 9.8e-6), (9.3e-3, 9.3e-3), (1.7e-2, 1.7e-2)),
    "dWr0": ((2.2e-6, 5.5e-7), (9.4e-4, 4.3e-4), (1.6e-3, 2.1e-3), (1.3e-3, 1.8e-3)),
    "dbr0": ((1.5e-6, 1.2e-6), (1.7e-4, 1.2e-4), (1.5e-3, 1.9e-3), (1.3e-3, 1.6e-3)),
    "dWr1x": ((1.1e-6, 6.6e-7), (3.0e-4, 2.4e-4), (2.7e-3, 2.1e-3), (1.9e-3, 1.7e-3)),
    "dWr2": ((1.7e-3, 1.5e-3), (7.9e-4, 6.0e-4), (3.8e-4, 3.9e-4), (3.5e-4, 3.7e-4)),
    "dbr2": ((1.2e-7, 1.1e-7), (7.6e-5, 7.9e-5), (1.3e-4, 1.3e-4), (1.4e-4, 1.3e-4)),
}
K2_READINGS = {
    case: {name: r[i] for name, r in _K2_READINGS.items()} for i, case in enumerate(K2_CASES)
}
K2_LIMIT_FACTOR = 2.0
K2_LIMIT_FLOOR = 1e-4

# K1 against its plain version, per case and output: (max |kernel - plain|
# over max |plain|, relative L2 distance), rounded up, on an NVIDIA H100 80GB
# HBM3 (700 W): seed 0 in the cases narrow, medium, wide and training
# (K2_CASES); at the serving shape (a 512^2 render's own inputs,
# chip_smoke.py), where K3 without the stash is held to the same limits per
# branch, the largest of K1's and K3's two branches' readings over seeds 0
# and 1.  The two round at the same points but sum in other orders, so at
# wider layers now and then a bf16 activation rounds the other way (2^-8 of
# it) and carries through the later layers; in the narrow case (hidden 64)
# they agree to f32 noise, so a kernel that loses precision fails there (one
# that rounds its accumulators to bf16 between K-slices reads 2.2e-2).
# Limits: twice the reading, never below K2's floor and never above
# K1_LIMIT_CAP.
K1_CASES = (*K2_CASES, "serving")
_K1_READINGS = {
    "feat_int": ((7.9e-8, 6.7e-8), (2.6e-4, 8.8e-5), (5.6e-4, 1.8e-4), (4.5e-4, 1.7e-4),
                 (1.3e-3, 6.6e-4)),
    "bg_alpha": ((0.0, 0.0), (3.5e-5, 9.4e-6), (2.6e-4, 5.1e-5), (2.7e-4, 5.1e-5),
                 (2.6e-4, 6.6e-5)),
    "depth": ((0.0, 0.0), (2.1e-4, 1.1e-4), (1.5e-3, 6.8e-4), (1.3e-3, 6.6e-4), (1.3e-3, 6.3e-4)),
    "weights": ((0.0, 0.0), (9.2e-4, 2.4e-4), (3.7e-3, 7.8e-4), (3.7e-3, 7.8e-4), (6.5e-3, 1.9e-3)),
}
K1_LIMIT_CAP = 1e-2
K1_LIMITS = {
    case: {name: tuple(min(K1_LIMIT_CAP, max(K2_LIMIT_FACTOR * v, K2_LIMIT_FLOOR)) for v in r[i])
           for name, r in _K1_READINGS.items()}
    for i, case in enumerate(K1_CASES)
}
# The kernel's distance from the unrounded gradient over the larger of the
# plain version's and of the plain version computed in float64: at most
# 1.088 (dbmid) over the wide case's seeds 0-7 and the training case's 0-1
# on an NVIDIA H100 80GB HBM3 (700 W).  Only the rounding points are fixed:
# the f32 plain version alone lies up to 1.5 times closer than the float64
# one on the trunk's gradients in some seeds, and the kernel as far as the
# float64 one.
K2_TRUTH_RATIO = 1.15
# The density head's weight and bias gradients are sums dominated by the few
# points whose density is near zero, where one ReLU mask decides a point's
# whole term: their distances from the unrounded gradient range from 1e-4 to
# 0.6 between seeds, and the kernel's over the plain version's from 0.5 to
# 15.  They are held by the plain-version limits alone.
K2_TRUTH_EXEMPT = ("dWd", "dbd")

def _seeded_field(hidden: int, gen, device):
    """A field at width ``hidden``: seeded weights, every bias 0.1 N(0, 1),
    so that a dropped or misplaced bias shows."""
    field = NeRFFieldMLP(63, 181, 127, hidden=hidden, res_nfeat=258)
    field.reset_parameters(gen)
    with torch.no_grad():
        for name, t in field.named_parameters():
            if name.endswith("bias"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    return field.to(device)


def _field_inputs(gen, rays: int, samples: int, device, batch: int = 2):
    """Embedding 0.5 N(0, 1), sorted N(0, 1) z values, 0.2 U[0, 1) segment
    lengths and codes 0.1 N(0, 1) for ``batch`` batches of ``rays`` x
    ``samples`` points."""
    shape = (batch, rays, samples)
    embed = (0.5 * torch.randn(*shape, 63, generator=gen)).to(device)
    zvals = torch.sort(torch.randn(shape, generator=gen), -1)[0].to(device)
    zdists = (0.2 * torch.rand(shape, generator=gen)).to(device)
    sc = (0.1 * torch.randn(batch, 181, generator=gen)).to(device)
    ac = (0.1 * torch.randn(batch, 127, generator=gen)).to(device)
    return embed, zvals, zdists, sc, ac


def _cotangents(gen, rays: int, samples: int, device, batch: int = 2):
    """N(0, 1) cotangents of the fused forward's four outputs."""
    return [torch.randn(s, generator=gen).to(device)
            for s in ((batch, rays, 258), (batch, rays), (batch, rays), (batch, rays, samples))]


def field_case(hidden: int, samples: int, rays: int, device, seed: int = 0, batch: int = 2):
    """A seeded field at width ``hidden``, the fused kernels' inputs for
    ``batch`` batches of ``rays`` x ``samples`` points and N(0, 1)
    cotangents of the forward's four outputs.  Returns ``(args,
    cotangents)``: ``args`` is what ``fused_field_forward`` takes."""
    gen = torch.Generator().manual_seed(hidden + 1000 * seed)
    field = _seeded_field(hidden, gen, device)
    embed, zvals, zdists, sc, ac = _field_inputs(gen, rays, samples, device, batch)
    with torch.no_grad():
        p = ff.split_params(field.flat(), 63)
        cb0, cb5, cbr1 = ff.conditioning_rows(p, sc, ac)
        ops = ff.prepare_operands(p)
    args = (embed.to(torch.bfloat16).contiguous(), zvals, zdists, cb0, cb5, cbr1, ops)
    return args, _cotangents(gen, rays, samples, device, batch)


def dual_case(hidden: int, samples: int, rays: int, device, seed: int = 0):
    """The dual kernels' case: two seeded fields (face, eyes) at width
    ``hidden`` on one set of inputs for two batches of ``rays`` x ``samples``
    points, and N(0, 1) cotangents of each branch's four outputs.  Returns
    ``(args, (g_face, g_eye))``: ``args`` is what ``fused_dual_forward``
    takes (stacked operands and conditioning rows)."""
    gen = torch.Generator().manual_seed(hidden + 1000 * seed + 17)
    fields = [_seeded_field(hidden, gen, device) for _ in range(ff2.N_BRANCHES)]
    embed, zvals, zdists, sc, ac = _field_inputs(gen, rays, samples, device)
    with torch.no_grad():
        ps = [ff.split_params(f.flat(), 63) for f in fields]
        cb0, cb5, cbr1 = ff2.conditioning_rows(ps, sc, ac)
        ops = ff2.stack_operands([ff.prepare_operands(p) for p in ps])
    args = (embed.to(torch.bfloat16).contiguous(), zvals, zdists, cb0, cb5, cbr1, ops)
    return args, tuple(_cotangents(gen, rays, samples, device) for _ in range(ff2.N_BRANCHES))


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@torch.no_grad()
def readings(got, want) -> Dict[str, Tuple[float, float]]:
    """Per output of two named tuples of tensors: max |got - want| over
    max |want|, and the relative L2 distance."""
    out = {}
    for name, a, b in zip(want._fields, got, want):
        err, scale = float((a.double() - b.double()).abs().max()), float(b.abs().max())
        out[name] = (err / scale if scale > 0 else float("inf"), _rel_l2(a, b))
    return out


def k2_limits(case: str) -> Dict[str, Tuple[float, float]]:
    """Per output, the (ratio, relative L2) limits of ``case``."""
    return {
        name: tuple(max(K2_LIMIT_FACTOR * v, K2_LIMIT_FLOOR) for v in r)
        for name, r in K2_READINGS[case].items()
    }


def limit_failures(got, want, limits) -> Tuple[Dict[str, Tuple[float, float]], List[str]]:
    """Two named tuples of tensors, output by output: the readings, and a
    line for every output that is not finite or over its (ratio, relative
    L2) limits."""
    r, fails = readings(got, want), []
    for name, (ratio, rel) in r.items():
        lim_ratio, lim_rel = limits[name]
        if not bool(torch.isfinite(getattr(got, name)).all()):
            fails.append(f"{name}: non-finite values")
        elif ratio > lim_ratio or rel > lim_rel:
            fails.append(f"{name}: ratio {ratio:.3e} (limit {lim_ratio:.1e}), "
                         f"relative L2 {rel:.3e} (limit {lim_rel:.1e})")
    return r, fails


def k1_failures(case: str, got, want) -> Tuple[Dict[str, Tuple[float, float]], List[str]]:
    """K1's four outputs against its plain version's in ``case``: the
    readings, and a line for every output that is not finite or over its
    limits."""
    return limit_failures(Outputs(*got), Outputs(*want), K1_LIMITS[case])


def k2_failures(case: str, got, want) -> Tuple[Dict[str, Tuple[float, float]], List[str]]:
    """K2's outputs against its plain version's in ``case``: the readings,
    and a line for every output that is not finite or over a limit."""
    return limit_failures(got, want, k2_limits(case))


@torch.no_grad()
def truth_failures(got, want, want64, exact, ratio: float, exempt: Tuple[str, ...] = (),
                   floor: float = 0.0) -> Tuple[Dict[str, Tuple[float, ...]], List[str]]:
    """Per output, the relative L2 distances from the unrounded gradient
    ``exact`` of the kernel's gradient ``got``, of the plain version's
    ``want`` and of the plain version computed in float64 ``want64``; and a
    line for every output but ``exempt`` where the kernel's is over both
    ``floor`` and ``ratio`` times the larger of the two plain versions'."""
    dist, fails = {}, []
    for name, k, p, p64, x in zip(exact._fields, got, want, want64, exact):
        dk, dp, dp64 = _rel_l2(k, x), _rel_l2(p, x), _rel_l2(p64, x)
        dist[name] = (dk, dp, dp64)
        if name not in exempt and not (dk <= ratio * max(dp, dp64) or dk <= floor):
            fails.append(f"{name}: {dk:.3e} from the unrounded gradient, the plain version "
                         f"{dp:.3e}, in float64 {dp64:.3e} (at most {ratio}x)")
    return dist, fails


# ---------------------------------------------------------------------------
# the renderer's kernels: the blur-shuffle stencil (K5, K6) and the fused
# upsampler block (K7, K8)

# The stencil's cases, (B, H, W, C) with C the folded width: the renderer's
# three levels at B=2; the single-tile and non-square shapes the JAX package
# tests its kernel at; and the kernels' edges: a width that is no multiple of
# the strip width (64 pixels at C = 32 in bf16, 32 in f32), an odd width at
# an odd C (the level0 width, whose bf16 pixels are 8-byte aligned), one
# pixel (the whole halo clamped), and rows of dy and y that start off a
# 16-byte boundary in f32 and bf16 (2W C = 70 values); and the three levels
# without the folded feat_layer.
STENCIL_CASES = {
    "level0": (2, 64, 64, 129),
    "level1": (2, 128, 128, 64),
    "level2": (2, 256, 256, 32),
    "single_tile": (1, 4, 4, 3),
    "non_square": (1, 16, 12, 6),
    "ragged": (2, 6, 70, 32),
    "odd": (1, 7, 9, 129),
    "one_pixel": (2, 1, 1, 8),
    "rows_off_16": (1, 5, 7, 5),
    # the three levels unfolded (renderer_fold_feat off under "pallas"): the
    # stencil runs on the blocks' own widths
    "unfolded0": (2, 64, 64, 258),
    "unfolded1": (2, 128, 128, 129),
    "unfolded2": (2, 256, 256, 64),
}
# K5 and K6 against their plain versions: max |kernel - plain|.  Every tap
# is a power of two, so each product is exact and a fused multiply-add
# rounds as a product and a sum do; kernel and plain version sum in the same
# order and round once, so they agree to the bit.
STENCIL_MAX_ABS_ERR = 0.0

# The block's cases, (B, H, W, F, F3): the renderer's three upsample blocks
# at B=2, a quarter of a 64-pixel tile at a narrow width, the odd width
# alone, and a ragged one: 60 pixels (a partial tile, fewer than the weight
# GEMM's 64 points a step) at widths 72 and 36, which pad to 96 and 64.
BLOCK_CASES = {
    "block0": (2, 64, 64, 258, 129),
    "block1": (2, 128, 128, 129, 64),
    "block2": (2, 256, 256, 64, 32),
    "half_tile": (1, 4, 4, 8, 4),
    "odd": (1, 8, 8, 129, 64),
    "ragged": (1, 6, 10, 72, 36),
}
# K7 against its plain version, per case: (max |kernel - plain| over max
# |plain|, relative L2 distance) of the bf16 output; and K8's, per output and
# case.  The two round at the same points but sum in other orders, so now
# and then a bf16 value (h1, z, a cotangent, the output) rounds the other way
# and carries on.  Seed 0, in the cases block0, block1, block2, half_tile and
# odd, on an NVIDIA H100 80GB HBM3 (700 W).
_K7_READINGS = ((2.78e-3, 2.55e-4), (2.70e-3, 1.54e-4), (2.43e-3, 8.49e-5), (0.0, 0.0),
                (3.60e-3, 1.12e-4), (9.20e-4, 6.76e-5))
_K8_READINGS = {
    "dx": ((1.36e-2, 9.19e-4), (2.42e-2, 7.23e-4), (1.76e-2, 5.06e-4), (2.99e-3, 8.29e-4),
           (3.29e-3, 5.64e-4), (2.98e-3, 7.87e-4)),
    "dW1": ((2.27e-3, 1.23e-3), (1.60e-3, 9.22e-4), (5.74e-4, 4.78e-4), (9.10e-4, 4.36e-4),
            (1.40e-3, 3.81e-4), (1.42e-3, 5.80e-4)),
    "db1": ((9.41e-4, 8.62e-4), (6.76e-4, 6.99e-4), (4.59e-4, 3.75e-4), (7.18e-4, 4.56e-4),
            (9.55e-5, 8.92e-5), (2.20e-4, 1.73e-4)),
    "dW2g": ((1.38e-2, 1.07e-3), (5.49e-3, 7.00e-4), (2.13e-3, 3.46e-4), (4.59e-4, 1.66e-4),
             (6.22e-4, 8.88e-5), (1.44e-3, 1.97e-4)),
    "db2g": ((3.54e-3, 8.30e-4), (2.57e-3, 5.97e-4), (1.19e-3, 2.70e-4), (3.82e-6, 3.30e-6),
             (3.49e-6, 3.53e-6), (3.33e-6, 3.12e-6)),
    "dW3": ((7.40e-5, 6.64e-5), (5.02e-5, 4.47e-5), (4.08e-5, 2.89e-5), (1.37e-7, 6.30e-8),
            (1.47e-5, 2.42e-6), (1.27e-4, 2.97e-5)),
    "db3": ((3.51e-7, 2.39e-7), (3.05e-7, 2.92e-7), (4.68e-7, 3.32e-7), (0.0, 0.0),
            (4.29e-8, 1.38e-8), (1.85e-8, 5.80e-9)),
}
# Limits: twice the reading, never below K2's floor (1e-4), and for the two
# bf16 outputs' max-abs ratio never below one bf16 step of the largest value
# (2^-8): a cuBLAS product in the plain version may sum in another order on
# another card.  In the narrow cases (half_tile, odd) the f32 data gradients
# agree to ~4e-6 (db2g), so a kernel that loses f32 precision in dz3 W3^T
# (bf16 operands alone, ~2^-9) fails there.
_BF16_STEP = 2.0**-8


def _limits(reading, bf16_output=False):
    ratio, rel = (max(K2_LIMIT_FACTOR * v, K2_LIMIT_FLOOR) for v in reading)
    return (max(ratio, _BF16_STEP) if bf16_output else ratio), rel


K7_LIMITS = {case: _limits(r, True) for case, r in zip(BLOCK_CASES, _K7_READINGS)}
K8_LIMITS = {
    case: {name: _limits(r[i], name == "dx") for name, r in _K8_READINGS.items()}
    for i, case in enumerate(BLOCK_CASES)
}
# K8's distance from the unrounded float64 gradient over the larger of the
# plain version's and of the plain version computed in float64: at most
# 1.0007 (db2g, block2 seed 0) over the three blocks and seeds 0-1 on an NVIDIA
# H100 80GB HBM3 (700 W), with one exception: db3, a sum of f32 values with
# no rounding point, lies 2e-7 to 3e-7 from it in the kernel's summation
# order and 0 in float64, so a distance below K8_TRUTH_FLOOR passes as f32
# summation noise.
K8_TRUTH_RATIO = 1.15
K8_TRUTH_FLOOR = 1e-5


def stencil_case(shape, device, dtype=torch.bfloat16, seed: int = 0):
    """The stencil's input ``[B, H, W, 4C]`` and an output cotangent ``[B,
    2H, 2W, C]``, each N(0, 1) in ``dtype``."""
    B, H, W, C = shape
    gen = torch.Generator().manual_seed(seed + 1000 * C + H)
    x = torch.randn(B, H, W, 4 * C, generator=gen).to(device, dtype)
    dy = torch.randn(B, 2 * H, 2 * W, C, generator=gen).to(device, dtype)
    return x, dy


def block_case(shape, device, seed: int = 0):
    """The fused block's inputs as the bf16 renderer gives them: x N(0, 1)
    in bf16; f32 weights N(0, 1 / fan in) (the renderer's initialiser, W2g
    already in group-major column order), every bias 0.1 N(0, 1); and an
    N(0, 1) bf16 output cotangent.  Returns ``(args, dy)``: ``args`` is what
    ``fused_upsample_forward`` takes before ``use_bf16``."""
    B, H, W, F, F3 = shape
    gen = torch.Generator().manual_seed(seed + 1000 * F + H)

    def normal(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=gen)).to(device)

    x = normal(B, H, W, F).to(torch.bfloat16)
    args = (x, normal(F, 2 * F, scale=F**-0.5), normal(2 * F, scale=0.1),
            normal(2 * F, 4 * F, scale=(2 * F) ** -0.5), normal(4 * F, scale=0.1),
            normal(F, F3, scale=F**-0.5), normal(F3, scale=0.1))
    return args, normal(B, 2 * H, 2 * W, F3).to(torch.bfloat16)


def k7_failures(case: str, got, want) -> Tuple[Tuple[float, float], List[str]]:
    """K7's output against its plain version's in ``case``: the reading, and
    a line if it is not finite or over the case's limits."""
    err, scale = float((got.double() - want.double()).abs().max()), float(want.abs().max())
    r = (err / scale if scale > 0 else float("inf"), _rel_l2(got, want))
    lim = K7_LIMITS[case]
    if not bool(torch.isfinite(got).all()):
        return r, ["out: non-finite values"]
    if r[0] > lim[0] or r[1] > lim[1]:
        return r, [f"out: ratio {r[0]:.3e}, relative L2 {r[1]:.3e} (limits {lim})"]
    return r, []


def k8_failures(case: str, got, want) -> Tuple[Dict[str, Tuple[float, float]], List[str]]:
    """K8's outputs against its plain version's in ``case``: the readings,
    and a line for every output that is not finite or over a limit."""
    return limit_failures(got, want, K8_LIMITS[case])


# ---------------------------------------------------------------------------
# the dual-branch kernels: the forward (K3) and the stash-reading backward (K4)

# The dual cases, (hidden, samples per ray, rays per batch), two batches: a
# narrow one, where K4 and its plain version agree to f32 noise, and the
# training step's shape.  K3 also runs at the serving shape, which
# chip_smoke.py builds from a render's own inputs.
DUAL_CASES = {
    "narrow": (64, 8, 64),
    "training": (384, 64, 4096),
}
STASH_SLOTS = ff.STASH_TAGS  # x0..x7, y0b, y1
Stash = collections.namedtuple("Stash", STASH_SLOTS)

Outputs = collections.namedtuple("Outputs", ("feat_int", "bg_alpha", "depth", "weights"))

# K3 without the stash against K1 on each branch: one tile body
# (csrc/field_fwd.cuh) on the same operands, the same bits.
K3_VS_K1_MAX_ABS_ERR = 0.0
# K3 against its plain version, per output and per stash slot, the larger
# of the two branches' (max |kernel - plain| over max |plain|, relative L2),
# in the cases narrow and training, seed 0, on an NVIDIA H100 80GB HBM3
# (700 W).  The two round every activation to bf16 from f32 sums taken in
# other orders, so now and then one rounds the other way and carries on
# through the later layers; in the training case the eye field's features
# are small (max 5.5e-3) and its densities near the ReLU's edge, so its
# feature, depth and weight ratios read highest (1.1e-2 to 1.3e-2).
_K3_READINGS = {
    "feat_int": ((1.8e-7, 8.7e-8), (1.2e-2, 4.3e-3)),
    "bg_alpha": ((0.0, 0.0), (3.1e-4, 7.7e-5)),
    "depth": ((8.3e-8, 6.7e-8), (1.3e-2, 6.3e-3)),
    "weights": ((4.0e-8, 1.6e-8), (1.3e-2, 4.4e-3)),
}
_K3_STASH_READINGS = {
    "x0": ((1.3e-3, 3.1e-5), (2.7e-3, 1.5e-5)),
    "x1": ((1.6e-3, 6.5e-5), (3.2e-3, 4.8e-5)),
    "x2": ((2.5e-3, 1.1e-4), (4.5e-3, 1.1e-4)),
    "x3": ((3.0e-3, 1.5e-4), (5.4e-3, 1.9e-4)),
    "x4": ((3.1e-3, 1.4e-4), (6.1e-3, 2.6e-4)),
    "x5": ((1.5e-3, 6.7e-5), (3.1e-3, 2.5e-4)),
    "x6": ((2.1e-3, 9.1e-5), (4.0e-3, 4.0e-4)),
    "x7": ((2.5e-3, 1.1e-4), (4.8e-3, 4.9e-4)),
    "y0b": ((2.8e-3, 1.5e-4), (5.7e-3, 5.8e-4)),
    "y1": ((3.1e-3, 1.5e-4), (5.1e-3, 7.0e-4)),
}
K3_LIMITS = {
    case: {name: _limits(r[i]) for name, r in _K3_READINGS.items()}
    for i, case in enumerate(DUAL_CASES)
}
# the stash is bf16: never below one bf16 step of the largest value
K3_STASH_LIMITS = {
    case: {name: _limits(r[i], True) for name, r in _K3_STASH_READINGS.items()}
    for i, case in enumerate(DUAL_CASES)
}

# K4 against its plain version, per output and case, (max |kernel - plain|
# over max |plain|, relative L2); the plain version reads the same stash, so
# the two differ only by f32 summation order and the folded feature head.
# Seed 0 on an NVIDIA H100 80GB HBM3 (700 W).
_K4_READINGS = {
    "dembed": ((5.2e-6, 4.5e-6), (6.5e-6, 6.2e-6)),
    "dzvals": ((1.7e-7, 4.1e-8), (2.0e-6, 4.1e-7)),
    "dzdists": ((2.7e-7, 2.1e-7), (3.4e-7, 3.4e-7)),
    "dcb0": ((7.2e-6, 6.9e-6), (1.1e-5, 8.6e-6)),
    "dcb5": ((2.2e-6, 2.9e-6), (3.1e-6, 3.1e-6)),
    "dcbr1": ((3.5e-7, 3.5e-7), (3.2e-7, 4.2e-7)),
    "dW0e": ((5.0e-4, 1.6e-4), (2.1e-4, 2.1e-4)),
    "dWmid": ((1.3e-4, 4.7e-5), (1.5e-5, 3.3e-5)),
    "dbmid": ((5.3e-7, 8.2e-7), (1.3e-6, 1.7e-6)),
    "dW5e": ((2.8e-4, 1.0e-4), (1.2e-4, 1.4e-4)),
    "dW5x": ((1.0e-4, 7.9e-5), (4.8e-5, 5.0e-5)),
    "dWd": ((9.1e-8, 6.4e-8), (5.5e-6, 4.9e-6)),
    "dbd": ((4.3e-8, 4.3e-8), (7.4e-8, 7.4e-8)),
    "dWr0": ((3.8e-5, 2.0e-5), (1.5e-5, 1.7e-5)),
    "dbr0": ((1.5e-6, 1.6e-6), (8.9e-7, 7.7e-7)),
    "dWr1x": ((2.8e-7, 1.7e-7), (6.5e-6, 7.3e-6)),
    "dWr2": ((8.8e-4, 1.0e-3), (2.7e-4, 2.6e-4)),
    "dbr2": ((1.2e-7, 1.2e-7), (5.6e-7, 3.4e-7)),
}
K4_LIMITS = {
    case: {name: _limits(r[i]) for name, r in _K4_READINGS.items()}
    for i, case in enumerate(DUAL_CASES)
}
# K4 against K2 on each branch with the shared cotangents summed, per
# output as above: K4 reads K3's stash, which equals K2's recomputed
# activations bit for bit (one forward tile code, the same products), and
# the two share the backward's tile body, so every weight, bias and
# conditioning-row gradient is equal to the bit; the per-point cotangents
# differ by the order of the branches' sums (K2's are added afterwards).
_K4_VS_K2_READINGS = {
    name: ((0.0, 0.0), (0.0, 0.0)) for name in _K4_READINGS
}
_K4_VS_K2_READINGS.update({
    "dembed": ((2.5e-8, 7.4e-9), (7.4e-8, 2.9e-9)),
    "dzvals": ((2.2e-8, 4.8e-9), (1.2e-8, 4.7e-10)),
    "dzdists": ((2.6e-10, 7.8e-11), (4.2e-8, 1.0e-9)),
})
K4_VS_K2_LIMITS = {
    case: {name: _limits(r[i]) for name, r in _K4_VS_K2_READINGS.items()}
    for i, case in enumerate(DUAL_CASES)
}
# K4's distance from the unrounded float64 gradient over the larger of the
# plain version's and the plain version computed in float64: at most
# 1.00007 (dW0e) over the narrow case's seeds 0-1 and the training case's
# seed 0, the density head's gradients included, on an NVIDIA H100 80GB
# HBM3 (700 W).  Unlike K2 and its plain version, K4 and its plain version
# read the same stash, so no bf16 rounding flips apart and the ratio stays
# at 1 but for f32 noise; held to 1.01 with no output exempt.
K4_TRUTH_RATIO = 1.01
K4_TRUTH_EXEMPT: Tuple[str, ...] = ()


def _per_branch(kind, limits, got, want) -> Tuple[Dict[str, Dict], List[str]]:
    out, fails = {}, []
    for br, g, w in zip(("face", "eyes"), got, want):
        out[br], f = limit_failures(kind(*g), kind(*w), limits)
        fails += [f"{br} {line}" for line in f]
    return out, fails


def k3_failures(case: str, got, want) -> Tuple[Dict[str, Dict], List[str]]:
    """K3's four outputs against its plain version's in ``case``, per branch
    and output: the readings, and a line for every output over its limits."""
    return _per_branch(Outputs, K3_LIMITS[case], got, want)


def k3_stash_failures(case: str, got, want) -> Tuple[Dict[str, Dict], List[str]]:
    """K3's stash against its plain version's in ``case``, per branch and
    slot: the readings, and a line for every slot over its limits."""
    return _per_branch(Stash, K3_STASH_LIMITS[case], got, want)


def k4_failures(case: str, got, want) -> Tuple[Dict[str, Tuple[float, float]], List[str]]:
    """K4's outputs against its plain version's in ``case``."""
    return limit_failures(got, want, K4_LIMITS[case])


def k4_vs_k2_failures(case: str, got, want) -> Tuple[Dict[str, Tuple[float, float]], List[str]]:
    """K4's outputs against K2's on each branch, summed, in ``case``."""
    return limit_failures(got, want, K4_VS_K2_LIMITS[case])


# ---------------------------------------------------------------------------
# the single-branch stash: K1 writing it, K2 reading it (with and without
# dens_vpu)

# K1's stash against its plain version's at the training shape (K2_CASES),
# per slot: (max |kernel - plain| over max |plain|, relative L2), seed 0,
# on an NVIDIA H100 80GB HBM3 (700 W).  K1 with the stash is K3's tile body
# on one branch and reads as K3 does: now and then an activation rounds to
# the other bf16 neighbour and carries on through the later layers.
_K1_STASH_READINGS = {
    "x0": (2.7e-3, 1.6e-5), "x1": (3.2e-3, 5.0e-5), "x2": (4.0e-3, 1.1e-4),
    "x3": (4.9e-3, 1.8e-4), "x4": (6.7e-3, 2.6e-4), "x5": (3.1e-3, 2.3e-4),
    "x6": (3.9e-3, 3.7e-4), "x7": (5.0e-3, 4.7e-4), "y0b": (6.4e-3, 5.6e-4),
    "y1": (5.2e-3, 6.5e-4),
}
K1_STASH_LIMITS = {name: _limits(r, True) for name, r in _K1_STASH_READINGS.items()}
# K1 with the stash against K1 without it: the same tile body, the stores
# apart, so the same outputs to the bit.
K1_STASH_VS_K1_MAX_ABS_ERR = 0.0

# K2 reading the stash against its plain version reading the same stash,
# per output and case (narrow, training): (max |kernel - plain| over max
# |plain|, relative L2), the larger of the readings with and without
# dens_vpu, seed 0, on an NVIDIA H100 80GB HBM3 (700 W).  The two read the
# same stash, so they differ only by f32 summation order and the folded
# feature head, as K4 and its plain version do.
K2_STASH_CASES = ("narrow", "training")
_K2_STASH_READINGS = {
    "dembed": ((6.0e-6, 4.2e-6), (5.0e-6, 4.7e-6)),
    "dzvals": ((0.0, 0.0), (2.6e-6, 6.3e-7)),
    "dzdists": ((4.7e-8, 7.5e-8), (2.5e-7, 2.1e-7)),
    "dcb0": ((6.2e-6, 5.7e-6), (3.8e-6, 5.2e-6)),
    "dcb5": ((4.3e-6, 4.2e-6), (1.6e-6, 1.6e-6)),
    "dcbr1": ((1.6e-7, 2.0e-7), (2.9e-7, 3.4e-7)),
    "dW0e": ((3.2e-5, 7.2e-6), (2.4e-4, 1.8e-4)),
    "dWmid": ((1.6e-4, 4.9e-5), (4.6e-5, 5.3e-5)),
    "dbmid": ((3.9e-6, 3.4e-6), (1.1e-6, 1.8e-6)),
    "dW5e": ((9.9e-5, 2.6e-5), (1.6e-4, 1.2e-4)),
    "dW5x": ((5.0e-5, 2.4e-5), (7.3e-5, 7.5e-5)),
    "dWd": ((5.0e-7, 3.6e-7), (2.6e-5, 3.1e-5)),
    "dbd": ((3.4e-7, 3.4e-7), (9.3e-7, 9.3e-7)),
    "dWr0": ((2.2e-6, 5.5e-7), (2.1e-5, 2.7e-5)),
    "dbr0": ((1.1e-6, 1.2e-6), (8.3e-7, 7.2e-7)),
    "dWr1x": ((1.7e-7, 6.7e-8), (1.8e-5, 1.9e-5)),
    "dWr2": ((1.8e-3, 1.6e-3), (3.7e-4, 3.4e-4)),
    "dbr2": ((1.3e-7, 1.2e-7), (4.4e-7, 4.6e-7)),
}
K2_STASH_LIMITS = {
    case: {name: _limits(r[i]) for name, r in _K2_STASH_READINGS.items()}
    for i, case in enumerate(K2_STASH_CASES)
}
# K2 reading K1's stash against K2 recomputing on the same inputs: K1's
# stash equals K2's recompute to the bit (one forward tile code, the same
# products) and the two modes share the tile body and the GEMM, so every
# output is equal to the bit; with dens_vpu every output but dWd.
K2_STASH_VS_RECOMPUTE_MAX_ABS_ERR = 0.0
# K2 reading the stash against the unrounded float64 gradient: K2's rule,
# with no output exempt.  Kernel and plain version read the same stash and
# sum the density pre-activation in the same order, so no ReLU mask flips
# between them (density_mask_flips, held to 0 in the fit case; the ratio
# read at most 1.0001 in both cases and modes, seed 0, on an NVIDIA H100
# 80GB HBM3, 700 W); with dens_vpu the density cotangent is not rounded
# before dWd either.
K2_STASH_TRUTH_RATIO = K2_TRUTH_RATIO
K2_STASH_TRUTH_EXEMPT: Tuple[str, ...] = ()


def k1_stash_failures(got, want) -> Tuple[Dict[str, Tuple[float, float]], List[str]]:
    """K1's ten stash tensors against its plain version's at the training
    shape, per slot."""
    return limit_failures(Stash(*got), Stash(*want), K1_STASH_LIMITS)


def k2_stash_failures(case: str, got, want) -> Tuple[Dict[str, Tuple[float, float]], List[str]]:
    """K2 reading the stash against its plain version reading the same
    stash, in ``case``."""
    return limit_failures(got, want, K2_STASH_LIMITS[case])


# ---------------------------------------------------------------------------
# K2 at B=1: the single-image fit and the gaze optimization (train/fitting.py)

# The fit case: one batch of the training step's width, samples and rays
# (hidden 384, 64 samples, 4096 rays), as a fit step and a gaze step give
# K2; in the modes they run: recomputing, and reading K1's stash with the
# dens_vpu density head (the CLIs' --pallas_tuning auto at S <= 64).
K2_FIT_CASE = (384, 64, 4096)
K2_FIT_BATCH = 1
K2_FIT_MODES = ("recompute", "stash_dens_vpu")
# K2 against its plain version in the fit case, per mode and output: (max
# |kernel - plain| over max |plain|, relative L2), rounded up, seed 0, on an
# NVIDIA H100 80GB HBM3 (700 W).  Recomputing reads as the training case
# does (a bf16 activation now and then rounds the other way).  Reading the
# stash the two differ only by f32 summation order and the folded feature
# head, as in the two-batch case: the plain version sums the density
# pre-activation in the kernel's order (fused_field_bwd.density_pre), so
# their density masks agree at every point (density_mask_flips 0 in seeds
# 0-2).  Summed as a matmul sums it, seed 0 holds one point whose density
# sign differs from the kernel's; that one point's whole cotangent then
# moved dembed by 9.2e-3 of its largest value, and the sums over points (the
# conditioning rows, dbmid, dWd, dbd) by 1e-4 to 2.4e-4.
# Seeds 1 and 2 (same chip): seed 1 within these limits in both modes; seed
# 2 over them, recomputing by up to 10x (dcbr1 4.0e-2, dWr1x 4.7e-2) and
# reading the stash on dWr0 (2.8e-4) and dWr2 (1.6e-3), while its K1
# outputs are also over the training case's limits (feat_int 5.6e-3) with
# its stash within them.  In every seed and mode the kernel lies as close
# to the unrounded gradient as the plain version (K2_FIT_TRUTH): the
# spread is that field's rounding noise, and the limits hold seed 0, which
# chip_smoke.py and the card tests run.
_K2_FIT_READINGS = {
    "recompute": {
        "dembed": (1.5e-1, 9.7e-3), "dzvals": (3.1e-3, 7.1e-4), "dzdists": (3.3e-3, 8.9e-4),
        "dcb0": (6.7e-3, 9.6e-3), "dcb5": (7.3e-3, 7.7e-3), "dcbr1": (2.0e-3, 1.4e-3),
        "dW0e": (1.3e-2, 1.2e-2), "dWmid": (6.3e-3, 7.0e-3), "dbmid": (5.8e-3, 5.9e-3),
        "dW5e": (6.7e-3, 9.7e-3), "dW5x": (8.6e-3, 7.9e-3), "dWd": (5.1e-3, 4.1e-3),
        "dbd": (3.2e-3, 3.2e-3), "dWr0": (1.8e-3, 1.6e-3), "dbr0": (1.6e-3, 1.4e-3),
        "dWr1x": (2.3e-3, 1.5e-3), "dWr2": (2.7e-4, 3.8e-4), "dbr2": (8.1e-5, 1.1e-4),
    },
    "stash_dens_vpu": {
        "dembed": (4.8e-6, 4.6e-6), "dzvals": (3.1e-7, 8.6e-8), "dzdists": (2.1e-7, 1.9e-7),
        "dcb0": (6.4e-6, 7.4e-6), "dcb5": (2.8e-6, 3.3e-6), "dcbr1": (3.4e-7, 2.7e-7),
        "dW0e": (2.1e-4, 1.8e-4), "dWmid": (6.1e-5, 6.5e-5), "dbmid": (1.4e-6, 2.0e-6),
        "dW5e": (1.5e-4, 1.2e-4), "dW5x": (1.3e-4, 9.5e-5), "dWd": (3.8e-6, 2.9e-6),
        "dbd": (4.8e-7, 4.8e-7), "dWr0": (3.0e-5, 2.7e-5), "dbr0": (5.9e-7, 5.8e-7),
        "dWr1x": (1.4e-5, 1.5e-5), "dWr2": (3.0e-4, 3.5e-4), "dbr2": (3.7e-7, 4.3e-7),
    },
}
K2_FIT_LIMITS = {
    mode: {name: _limits(r) for name, r in readings_.items()}
    for mode, readings_ in _K2_FIT_READINGS.items()
}
# against the unrounded float64 gradient: each mode's rule at two batches
# (readings in seeds 0-2: recomputing at most 1.0109 but for the exempt dWd
# and dbd, 1.13 and 1.18 in seed 0; reading the stash at most 1.0014, dWr2)
K2_FIT_TRUTH = {
    "recompute": (K2_TRUTH_RATIO, K2_TRUTH_EXEMPT),
    "stash_dens_vpu": (K2_STASH_TRUTH_RATIO, K2_STASH_TRUTH_EXEMPT),
}


@torch.no_grad()
def density_mask_flips(got, want) -> int:
    """The points where two field backwards' density ReLU masks differ,
    read from their ``dzdists``, which is 0 exactly where the density
    (``relu`` of its pre-activation) is."""
    return int(((got.dzdists == 0) != (want.dzdists == 0)).sum())


def k2_fit_failures(mode: str, got, want) -> Tuple[Dict[str, Tuple[float, float]], List[str]]:
    """K2 against its plain version in the fit case, in ``mode``."""
    return limit_failures(got, want, K2_FIT_LIMITS[mode])


# ---------------------------------------------------------------------------
# the backwards' weight-gradient GEMM (csrc/field_dw.cuh)

# Its cases: (hidden, samples per ray, rays per batch, tiles per chunk), two
# batches: 24 tiles in chunks of 10, so the second chunk spans the batch
# boundary (after tile 12) and the third is partial; per case the products of
# a chunk at that width: a trunk layer (H x H), the embedding's (64 x H) and
# rgb_1's (H x H/2).
DW_CASES = {"h64": (64, 8, 96, 10), "h128": (128, 8, 96, 10), "h384": (384, 8, 96, 10)}
# The GEMM against its plain version (the f32 product of the same bf16
# operands, chunk by chunk): max |kernel - plain| over max |plain| per
# product.  Both sum exact bf16 products in f32, in other orders: readings
# 1.5e-7 to 2.6e-7 in these cases and 1.4e-5 over one full chunk of the
# training step (33,792 points, chip_smoke.py) on an NVIDIA H100 80GB HBM3
# (700 W); held to K2's floor.
DW_MAX_REL_ERR = K2_LIMIT_FLOOR


def dw_case(hidden: int, samples: int, rays: int, chunk_tiles: int, device, seed: int = 0):
    """The GEMM's case: N(0, 1) bf16 operands of three products over two
    batches of ``rays`` x ``samples`` points, as lists ``(xs, ds)``, and the
    chunk plan."""
    from gazenerf_tpu_torch.kernels import field_dw

    gen = torch.Generator().manual_seed(hidden + 1000 * seed + 29)
    P = 2 * rays * samples
    widths = ((hidden, hidden), (64, hidden), (hidden, hidden // 2))
    xs = [torch.randn(P, m, generator=gen).to(device, torch.bfloat16) for m, _ in widths]
    ds = [torch.randn(P, n, generator=gen).to(device, torch.bfloat16) for _, n in widths]
    return xs, ds, field_dw.plan_chunks(2, rays, samples, chunk_tiles)


@contextlib.contextmanager
def plain_versions():
    """Every kernel wrapper replaced by its plain version while inside: a
    model run inside computes what the kernels stand for, without them."""
    swaps = [(ff, "fused_field_forward", ff.fused_field_reference),
             (ffb, "fused_field_backward", ffb.fused_field_backward_reference),
             (ff2, "fused_dual_forward", ff2.fused_dual_reference),
             (ffb2, "fused_dual_backward", ffb2.fused_dual_backward_reference),
             (sb, "shuffle_blur_forward", sb.shuffle_blur_reference),
             (sb, "shuffle_blur_backward", sb.shuffle_blur_backward_reference),
             (fu, "fused_upsample_forward", fu.fused_upsample_reference),
             (fu, "fused_upsample_backward", fu.fused_upsample_backward_reference)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, plain in swaps:
        setattr(m, n, plain)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


# ---------------------------------------------------------------------------
# rays longer than one tile: K1-K4 at S = 128, 192 and 256

# The deep cases, (hidden, samples per ray, rays per batch), two batches.  A
# ray spans 2, 3 or 4 of the backward's 64-point tiles and, at S = 192 and
# 256, 3 tiles of two rays or 2 tiles of one ray of the forward's 128 points;
# the narrow one (hidden 64) holds the data gradients to f32 accuracy there,
# so a kernel that drops the low bf16 half of a cotangent fails it.
DEEP_CASES = {
    "deep128": (384, 128, 256),
    "deep192": (384, 192, 256),
    "deep256": (384, 256, 256),
    "deep_narrow": (64, 192, 64),
}
# the cases of K1 writing the stash and K2 reading it, and of K3 and K4
DEEP_STASH_CASES = ("deep128", "deep256")
DEEP_DUAL_CASE = "deep256"

# K1 and K2 against their plain versions, per output and case (deep128,
# deep192, deep256, deep_narrow): (max |kernel - plain| over max |plain|,
# relative L2), seed 0, K2's plain version summing the weight gradients in
# the kernel's chunks (``fused_field_backward_reference(..., chunks=)``), on
# an NVIDIA H100 80GB HBM3 (700 W).  At hidden 384 they read as the
# training case does (a bf16 activation now and then rounds the other way);
# in the narrow case the f32 transmittance over 192 samples, a product taken
# in another order, moves the outputs by ~1e-5 of their largest value and
# the segment-length cotangent, a difference of two such products' sums, by
# 2.8e-4.  Limits: twice the reading, never below K2's floor (K1's never
# above K1_LIMIT_CAP).
_DEEP_K1_READINGS = {
    "feat_int": ((2.4e-4, 1.0e-4), (2.0e-4, 7.8e-5), (1.8e-4, 7.1e-5), (7.3e-6, 3.2e-6)),
    "bg_alpha": ((2.6e-4, 7.4e-5), (2.0e-4, 8.9e-5), (2.8e-4, 1.0e-4), (3.6e-7, 3.4e-8)),
    "depth": ((8.3e-4, 4.0e-4), (5.9e-4, 2.8e-4), (6.1e-4, 2.1e-4), (4.0e-6, 1.5e-6)),
    "weights": ((3.1e-3, 7.2e-4), (3.6e-3, 7.5e-4), (3.1e-3, 7.5e-4), (1.0e-5, 1.7e-6)),
}
_DEEP_K2_READINGS = {
    "dembed": ((1.4e-1, 1.0e-2), (9.3e-2, 1.0e-2), (1.7e-1, 1.1e-2), (9.3e-6, 4.6e-6)),
    "dzvals": ((2.1e-3, 7.3e-4), (1.8e-3, 7.3e-4), (2.5e-3, 7.8e-4), (5.8e-6, 1.4e-6)),
    "dzdists": ((3.3e-3, 9.6e-4), (1.7e-3, 1.0e-3), (3.6e-3, 1.0e-3), (2.8e-4, 7.0e-5)),
    "dcb0": ((5.6e-3, 6.0e-3), (4.1e-3, 4.7e-3), (3.6e-3, 4.1e-3), (6.1e-6, 6.3e-6)),
    "dcb5": ((2.4e-3, 2.7e-3), (1.7e-3, 2.2e-3), (1.7e-3, 1.8e-3), (3.2e-6, 3.7e-6)),
    "dcbr1": ((1.9e-3, 1.3e-3), (1.9e-3, 1.1e-3), (1.2e-3, 8.9e-4), (1.2e-6, 1.2e-6)),
    "dW0e": ((1.5e-2, 1.2e-2), (1.0e-2, 1.2e-2), (1.2e-2, 1.1e-2), (1.4e-3, 3.1e-4)),
    "dWmid": ((5.3e-3, 4.1e-3), (4.8e-3, 3.9e-3), (1.1e-3, 1.6e-3), (1.4e-4, 6.4e-5)),
    "dbmid": ((4.9e-3, 3.7e-3), (3.5e-3, 3.2e-3), (1.2e-3, 1.3e-3), (2.8e-6, 3.8e-6)),
    "dW5e": ((1.3e-2, 1.1e-2), (6.4e-3, 1.0e-2), (1.1e-2, 9.3e-3), (2.1e-4, 8.0e-5)),
    "dW5x": ((4.9e-3, 4.9e-3), (3.5e-3, 4.5e-3), (2.6e-3, 1.8e-3), (1.8e-4, 9.1e-5)),
    "dWd": ((1.8e-3, 1.9e-3), (1.7e-3, 1.7e-3), (1.1e-3, 1.1e-3), (6.1e-5, 3.2e-5)),
    "dbd": ((1.9e-3, 1.9e-3), (1.6e-3, 1.6e-3), (1.0e-3, 1.0e-3), (3.4e-6, 3.4e-6)),
    "dWr0": ((1.7e-3, 1.4e-3), (9.8e-4, 1.0e-3), (8.8e-4, 9.4e-4), (9.6e-5, 4.3e-5)),
    "dbr0": ((1.5e-3, 1.3e-3), (1.0e-3, 9.3e-4), (7.6e-4, 8.5e-4), (2.3e-6, 1.6e-6)),
    "dWr1x": ((1.5e-3, 1.3e-3), (1.2e-3, 1.0e-3), (9.2e-4, 9.2e-4), (7.3e-5, 3.4e-5)),
    "dWr2": ((2.7e-4, 2.6e-4), (2.1e-4, 2.1e-4), (1.7e-4, 1.8e-4), (8.8e-4, 9.9e-4)),
    "dbr2": ((4.8e-5, 6.4e-5), (5.5e-5, 4.3e-5), (3.7e-5, 3.6e-5), (8.4e-7, 9.5e-7)),
}
DEEP_K1_LIMITS = {
    case: {name: tuple(min(K1_LIMIT_CAP, max(K2_LIMIT_FACTOR * v, K2_LIMIT_FLOOR)) for v in r[i])
           for name, r in _DEEP_K1_READINGS.items()}
    for i, case in enumerate(DEEP_CASES)
}
DEEP_K2_LIMITS = {
    case: {name: _limits(r[i]) for name, r in _DEEP_K2_READINGS.items()}
    for i, case in enumerate(DEEP_CASES)
}
# K2 against the unrounded float64 gradient at hidden 384: K2's rule (at
# most 1.041 but for the exempt dWd and dbd, which read up to 1.33 and
# 19.6, in the three deep cases, seed 0, on the same card).  K2 recomputing
# and its plain version round the trunk's activations at the same points
# but sum in other orders, so now and then a density near 0 takes the other
# sign (3, 4 and 6 points of 65,536 to 131,072 there, 2 in the wide case);
# reading one stash, their density masks agree at every point
# (density_mask_flips held to 0).
DEEP_K2_TRUTH_CASES = ("deep128", "deep192", "deep256")

# K2 reading K1's stash against its plain version reading the same stash,
# per output (deep128, deep256), seed 0, the same card: they differ only by
# f32 summation order and the folded feature head, as in the training case.
_DEEP_K2_STASH_READINGS = {
    "dembed": ((5.2e-6, 4.7e-6), (4.8e-6, 4.7e-6)),
    "dzvals": ((1.7e-7, 1.2e-7), (3.1e-7, 1.7e-7)),
    "dzdists": ((3.4e-7, 2.3e-7), (4.6e-7, 3.0e-7)),
    "dcb0": ((4.2e-6, 5.2e-6), (4.2e-6, 4.9e-6)),
    "dcb5": ((1.4e-6, 1.6e-6), (1.8e-6, 1.4e-6)),
    "dcbr1": ((3.8e-7, 3.1e-7), (2.5e-7, 2.7e-7)),
    "dW0e": ((2.5e-4, 1.7e-4), (2.0e-4, 1.5e-4)),
    "dWmid": ((3.8e-5, 4.4e-5), (1.7e-5, 1.7e-5)),
    "dbmid": ((1.2e-6, 1.5e-6), (8.6e-7, 6.7e-7)),
    "dW5e": ((1.7e-4, 1.2e-4), (1.1e-4, 9.4e-5)),
    "dW5x": ((6.8e-5, 5.8e-5), (2.7e-5, 2.0e-5)),
    "dWd": ((2.7e-6, 2.3e-6), (1.8e-6, 1.7e-6)),
    "dbd": ((9.5e-7, 9.5e-7), (3.4e-7, 3.4e-7)),
    "dWr0": ((2.3e-5, 2.1e-5), (2.1e-5, 1.8e-5)),
    "dbr0": ((7.6e-7, 5.8e-7), (4.8e-7, 4.4e-7)),
    "dWr1x": ((1.8e-5, 1.5e-5), (1.4e-5, 1.6e-5)),
    "dWr2": ((2.0e-4, 2.4e-4), (1.6e-4, 1.7e-4)),
    "dbr2": ((3.1e-7, 2.8e-7), (3.0e-7, 2.5e-7)),
}
DEEP_K2_STASH_LIMITS = {
    case: {name: _limits(r[i]) for name, r in _DEEP_K2_STASH_READINGS.items()}
    for i, case in enumerate(DEEP_STASH_CASES)
}

# K3 against its plain version in deep256, per output, the larger of the two
# branches' readings, seed 0, the same card: the face branch reads as K1
# does there, the eye field (small features, densities near the ReLU's edge,
# as in the training case) up to 6.5e-3 on the weights.
_DEEP_K3_READINGS = {
    "feat_int": (4.1e-3, 2.0e-3), "bg_alpha": (3.1e-4, 1.5e-4),
    "depth": (2.3e-3, 2.4e-3), "weights": (6.5e-3, 2.5e-3),
}
DEEP_K3_LIMITS = {name: _limits(r) for name, r in _DEEP_K3_READINGS.items()}


def deep_k3_failures(got, want) -> Tuple[Dict[str, Dict], List[str]]:
    """K3's four outputs against its plain version's in deep256, per branch
    and output: the readings, and a line for every output over its limits."""
    return _per_branch(Outputs, DEEP_K3_LIMITS, got, want)

# K4 against its plain version reading the same stash in deep256, per output,
# seed 0, the same card (the plain version sums the weight gradients over all
# points at once, as in the dual cases above).
_DEEP_K4_READINGS = {
    "dembed": (5.3e-6, 5.6e-6), "dzvals": (1.5e-7, 1.1e-7), "dzdists": (5.3e-7, 4.4e-7),
    "dcb0": (4.3e-6, 5.3e-6), "dcb5": (1.9e-6, 2.2e-6), "dcbr1": (3.8e-7, 3.2e-7),
    "dW0e": (2.5e-4, 1.8e-4), "dWmid": (1.8e-5, 3.2e-5), "dbmid": (8.6e-7, 1.3e-6),
    "dW5e": (2.9e-4, 1.3e-4), "dW5x": (4.4e-5, 4.3e-5), "dWd": (1.9e-6, 2.1e-6),
    "dbd": (7.6e-8, 8.3e-8), "dWr0": (2.4e-5, 2.4e-5), "dbr0": (4.6e-7, 5.7e-7),
    "dWr1x": (2.1e-5, 2.2e-5), "dWr2": (2.4e-4, 2.1e-4), "dbr2": (3.1e-7, 2.2e-7),
}
DEEP_K4_LIMITS = {name: _limits(r) for name, r in _DEEP_K4_READINGS.items()}


def deep_chunks(args):
    """The weight gradients' chunk plan of K2 on ``args`` (its summation
    order, for its plain version)."""
    from gazenerf_tpu_torch.kernels import field_dw

    B, R, S, _ = args[0].shape
    return field_dw.plan_chunks(B, R, S)


# ---------------------------------------------------------------------------
# the sample points encoded in the field kernels (embed_in_kernel): K1 and K2
# given the points in place of the embedding

# The model's octaves: the encoding's 3 + 6 x 10 = 63 columns
N_FREQS = 10
# (hidden, samples per ray, rays per batch), two batches: the narrow case
# (f32 noise between kernel and plain version), the training step's shape,
# and the deep march's rays (S = 256, whole 512-ray chunks' worth); K1
# writes the stash and K2 reads it in the narrow and training cases
POINTS_CASES = {"narrow": K2_CASES["narrow"], "training": K2_CASES["training"],
                "deep256": (384, 256, 512)}
POINTS_STASH_CASES = ("narrow", "training")
# K1 and K2 (recomputing; "<case>_stash": reading K1's stash with dens_vpu)
# given the points, against their plain versions given the same points, per
# output and case: (max |kernel - plain| over max |plain|, relative L2),
# seed 0, K2's plain version summing the weight gradients in the kernel's
# chunks, on an NVIDIA H100 80GB HBM3 (700 W).  They read as the embedding's
# cases do (K2_CASES, DEEP_CASES): the tiles encode the points to the bits
# of PyTorch's encoding on the card (no entry rounds to another bf16 value
# in any case), so only summation order parts kernel and plain version.
# Limits: twice the reading, never below K2's floor (K1's never above
# K1_LIMIT_CAP).
_POINTS_K1_READINGS = {
    "narrow": {"feat_int": (6.8e-8, 7.0e-8), "bg_alpha": (0.0, 0.0),
        "depth": (0.0, 0.0), "weights": (0.0, 0.0)},
    "training": {"feat_int": (6.5e-4, 2.3e-4), "bg_alpha": (3.2e-4, 5.3e-5),
        "depth": (2.2e-3, 8.1e-4), "weights": (4.2e-3, 8.7e-4)},
    "deep256": {"feat_int": (2.8e-4, 8.7e-5), "bg_alpha": (3.9e-4, 1.1e-4),
        "depth": (1.3e-3, 3.1e-4), "weights": (4.0e-3, 8.4e-4)},
}
_POINTS_K2_READINGS = {
    "narrow": {
        "dembed": (9.9e-6, 5.7e-6), "dzvals": (0.0, 0.0), "dzdists": (8.2e-8, 9.4e-8),
        "dcb0": (4.8e-6, 6.1e-6), "dcb5": (2.4e-6, 3.0e-6), "dcbr1": (1.2e-7, 2.0e-7),
        "dW0e": (5.9e-5, 2.9e-5), "dWmid": (7.0e-4, 1.5e-4), "dbmid": (1.2e-6, 1.2e-6),
        "dW5e": (3.9e-6, 2.9e-6), "dW5x": (4.9e-6, 2.1e-6), "dWd": (6.7e-8, 5.4e-8),
        "dbd": (0.0, 0.0), "dWr0": (1.4e-5, 5.5e-6), "dbr0": (6.0e-6, 4.4e-6),
        "dWr1x": (9.8e-8, 6.6e-8), "dWr2": (1.6e-3, 1.6e-3), "dbr2": (2.5e-7, 1.5e-7),
    },
    "narrow_stash": {
        "dembed": (9.9e-6, 5.7e-6), "dzvals": (0.0, 0.0), "dzdists": (8.2e-8, 9.4e-8),
        "dcb0": (4.8e-6, 6.1e-6), "dcb5": (2.4e-6, 3.0e-6), "dcbr1": (1.2e-7, 2.0e-7),
        "dW0e": (5.9e-5, 2.9e-5), "dWmid": (7.0e-4, 1.5e-4), "dbmid": (1.2e-6, 1.2e-6),
        "dW5e": (3.9e-6, 2.9e-6), "dW5x": (4.9e-6, 2.1e-6), "dWd": (2.1e-7, 1.4e-7),
        "dbd": (0.0, 0.0), "dWr0": (1.4e-5, 5.5e-6), "dbr0": (6.0e-6, 4.4e-6),
        "dWr1x": (9.8e-8, 6.6e-8), "dWr2": (1.6e-3, 1.6e-3), "dbr2": (2.5e-7, 1.5e-7),
    },
    "training": {
        "dembed": (2.9e-1, 1.7e-2), "dzvals": (1.9e-3, 8.7e-4), "dzdists": (4.4e-3, 1.1e-3),
        "dcb0": (8.6e-3, 1.1e-2), "dcb5": (4.4e-3, 4.7e-3), "dcbr1": (2.3e-3, 1.8e-3),
        "dW0e": (1.5e-2, 1.9e-2), "dWmid": (1.4e-2, 1.3e-2), "dbmid": (1.2e-2, 1.2e-2),
        "dW5e": (1.9e-2, 1.7e-2), "dW5x": (1.6e-2, 1.3e-2), "dWd": (2.4e-2, 1.8e-2),
        "dbd": (2.0e-2, 2.0e-2), "dWr0": (1.9e-3, 2.3e-3), "dbr0": (2.1e-3, 2.1e-3),
        "dWr1x": (2.7e-3, 2.1e-3), "dWr2": (3.9e-4, 5.0e-4), "dbr2": (1.7e-4, 1.8e-4),
    },
    "training_stash": {
        "dembed": (3.7e-6, 5.0e-6), "dzvals": (1.3e-7, 8.0e-8), "dzdists": (2.3e-7, 1.8e-7),
        "dcb0": (3.5e-6, 5.8e-6), "dcb5": (1.6e-6, 1.8e-6), "dcbr1": (3.2e-7, 2.8e-7),
        "dW0e": (1.5e-4, 1.8e-4), "dWmid": (6.4e-5, 7.6e-5), "dbmid": (1.7e-6, 2.3e-6),
        "dW5e": (1.2e-4, 1.2e-4), "dW5x": (1.1e-4, 1.1e-4), "dWd": (2.4e-6, 1.7e-6),
        "dbd": (4.1e-7, 4.1e-7), "dWr0": (3.5e-5, 3.1e-5), "dbr0": (1.1e-6, 6.8e-7),
        "dWr1x": (1.6e-5, 1.7e-5), "dWr2": (3.5e-4, 4.1e-4), "dbr2": (5.0e-7, 4.5e-7),
    },
    "deep256": {
        "dembed": (2.0e-1, 1.3e-2), "dzvals": (2.6e-3, 8.4e-4), "dzdists": (3.3e-3, 1.1e-3),
        "dcb0": (2.6e-3, 3.8e-3), "dcb5": (2.2e-3, 1.9e-3), "dcbr1": (1.5e-3, 1.2e-3),
        "dW0e": (7.4e-3, 1.1e-2), "dWmid": (2.2e-3, 2.7e-3), "dbmid": (2.1e-3, 2.2e-3),
        "dW5e": (3.3e-3, 6.2e-3), "dW5x": (3.6e-3, 3.6e-3), "dWd": (1.9e-3, 1.8e-3),
        "dbd": (1.8e-3, 1.8e-3), "dWr0": (9.3e-4, 1.2e-3), "dbr0": (8.8e-4, 1.1e-3),
        "dWr1x": (1.1e-3, 1.2e-3), "dWr2": (1.8e-4, 2.3e-4), "dbr2": (4.8e-5, 4.9e-5),
    },
}
POINTS_K1_LIMITS = {
    case: {name: tuple(min(K1_LIMIT_CAP, max(K2_LIMIT_FACTOR * v, K2_LIMIT_FLOOR)) for v in r)
           for name, r in readings_.items()}
    for case, readings_ in _POINTS_K1_READINGS.items()
}
POINTS_K2_LIMITS = {
    case: {name: _limits(r) for name, r in readings_.items()}
    for case, readings_ in _POINTS_K2_READINGS.items()
}
# K1 given the points equals K1 given the plain encoding computed on the
# card and rounded to bf16, to the bit: the tiles and PyTorch's CUDA sin and
# cos evaluate the same f32 functions of the same (exact) arguments.


def points_case(hidden: int, samples: int, rays: int, device, seed: int = 0, batch: int = 2):
    """:func:`field_case` with the sample points in place of the embedding:
    0.5 N(0, 1) f32 ``[batch, rays, samples, 3]`` (arguments of 2^9 of that at
    the last octave).  Returns ``(args, cotangents)``; ``args`` is what
    ``fused_field_forward`` takes with ``n_freqs=N_FREQS``."""
    args, cot = field_case(hidden, samples, rays, device, seed, batch)
    gen = torch.Generator().manual_seed(hidden + 1000 * seed + 7)
    pts = (0.5 * torch.randn(batch, rays, samples, 3, generator=gen)).to(device)
    return (pts, *args[1:]), cot


def encoding_flips(got: torch.Tensor, want: torch.Tensor) -> int:
    """Entries of two bf16 embeddings that differ."""
    return int((got != want).sum())


def points_k1_failures(case: str, got, want) -> Tuple[Dict[str, Tuple[float, float]], List[str]]:
    """K1 given the points against its plain version given them, in ``case``."""
    return limit_failures(Outputs(*got), Outputs(*want), POINTS_K1_LIMITS[case])


def points_k2_failures(case: str, got, want) -> Tuple[Dict[str, Tuple[float, float]], List[str]]:
    """K2 given the points against its plain version given them, in
    ``case`` (``<case>_stash``: reading the stash with ``dens_vpu``)."""
    return limit_failures(got, want, POINTS_K2_LIMITS[case])


# ---------------------------------------------------------------------------
# the f32 fused upsampler (K7 and K8 with use_bf16=False, the f32 renderer)

# The renderer's three blocks at B=2, and the narrow and ragged cases
F32_BLOCK_CASES = ("block0", "block1", "block2", "half_tile", "ragged")
# Per output (K7: its output; K8: each gradient), the kernel's relative L2
# distance from the unrounded result (the plain version in float64) is at
# most F32_TRUTH_RATIO times that of the f32 plain version (TF32 off), or
# under F32_TRUTH_FLOOR, f32 summation noise: the mode's accuracy is what it
# is for, and a kernel that rounds an operand or a product to TF32 or bf16
# lies ~100 times farther.
F32_TRUTH_RATIO = 1.15
F32_TRUTH_FLOOR = 1e-6
# K7 and K8 against their f32 plain versions, per output and case: (max
# |kernel - plain| over max |plain|, relative L2), seed 0, on an NVIDIA H100
# 80GB HBM3 (700 W): f32 summation noise, ~1e-7 (K7's output at the three
# blocks equal to the bit).  Their distances from the unrounded result read
# 1.7e-7 to 3.9e-7 where the plain version's read the same (K7, K8's dx at
# block0), within a few 1e-7 of it elsewhere, and at block1 and block2
# 3e-5 to 2.5e-4 for dx, dW1, db1 (dW2g, db2g at block1) in both, equal to
# four digits.  Limits: twice the reading, never below K2's floor.
_F32_K7_READINGS = {
    "block0": (0.0, 0.0),
    "block1": (0.0, 0.0),
    "block2": (0.0, 0.0),
    "half_tile": (2.9e-7, 1.3e-7),
    "ragged": (2.3e-7, 2.0e-7),
}
_F32_K8_READINGS = {
    "block0": {
        "dx": (1.4e-7, 4.8e-8), "dW1": (6.6e-7, 5.5e-7), "db1": (1.9e-7, 2.0e-7),
        "dW2g": (6.6e-7, 5.2e-7),
        "db2g": (2.0e-7, 2.1e-7), "dW3": (2.9e-7, 3.3e-7), "db3": (1.2e-7, 1.1e-7),
    },
    "block1": {
        "dx": (1.3e-7, 4.9e-8), "dW1": (8.4e-7, 8.2e-7), "db1": (2.0e-7, 2.0e-7),
        "dW2g": (8.5e-7, 7.2e-7),
        "db2g": (3.1e-7, 2.3e-7), "dW3": (5.0e-7, 5.0e-7), "db3": (1.9e-7, 2.0e-7),
    },
    "block2": {
        "dx": (1.4e-7, 4.0e-8), "dW1": (6.6e-7, 5.3e-7), "db1": (8.3e-7, 5.8e-7),
        "dW2g": (6.3e-7, 6.4e-7),
        "db2g": (4.4e-7, 3.8e-7), "dW3": (7.7e-7, 6.3e-7), "db3": (2.2e-7, 2.1e-7),
    },
    "half_tile": {
        "dx": (2.0e-7, 1.1e-7), "dW1": (1.9e-7, 1.6e-7), "db1": (2.5e-7, 2.3e-7),
        "dW2g": (1.3e-7, 1.1e-7),
        "db2g": (1.2e-7, 1.1e-7), "dW3": (2.1e-7, 1.8e-7), "db3": (0.0, 0.0),
    },
    "ragged": {
        "dx": (2.8e-7, 2.6e-7), "dW1": (4.4e-7, 3.9e-7), "db1": (3.6e-7, 3.2e-7),
        "dW2g": (3.4e-7, 2.6e-7),
        "db2g": (2.6e-7, 1.7e-7), "dW3": (2.1e-7, 2.1e-7), "db3": (0.0, 0.0),
    },
}
F32_K7_LIMITS = {case: _limits(r) for case, r in _F32_K7_READINGS.items()}
F32_K8_LIMITS = {case: {name: _limits(r) for name, r in rs.items()}
                 for case, rs in _F32_K8_READINGS.items()}

Image = collections.namedtuple("Image", ("out",))


def f32_block_case(shape, device, seed: int = 0):
    """:func:`block_case` as the f32 renderer gives it: x and the output
    cotangent in f32."""
    args, dy = block_case(shape, device, seed)
    return (args[0].float(), *args[1:]), dy.float()


def f32_k7_failures(case: str, got, want) -> Tuple[Dict[str, Tuple[float, float]], List[str]]:
    """K7 at f32 against its f32 plain version in ``case``."""
    return limit_failures(Image(got), Image(want), {"out": F32_K7_LIMITS[case]})


def f32_k8_failures(case: str, got, want) -> Tuple[Dict[str, Tuple[float, float]], List[str]]:
    """K8 at f32 against its f32 plain version in ``case``."""
    return limit_failures(got, want, F32_K8_LIMITS[case])


def f32_truth_failures(got, want, exact) -> Tuple[Dict[str, Tuple[float, ...]], List[str]]:
    """Per output of two named tuples (K7's ``Image`` or K8's gradients), the
    kernel's and the f32 plain version's relative L2 distances from the
    unrounded ``exact``, and a line for each output where the kernel's is
    over both ``F32_TRUTH_FLOOR`` and ``F32_TRUTH_RATIO`` times the plain
    version's."""
    return truth_failures(got, want, want, exact, F32_TRUTH_RATIO, floor=F32_TRUTH_FLOOR)


# ---------------------------------------------------------------------------
# the stash's other forms (the JAX stash_every and stash_dtype): K1 writing
# every k-th trunk layer, or x0..x6 and y0b as int8 codes; K2 reading them

STASH_FORMS = {"every2": ff.StashForm(2), "every4": ff.StashForm(4),
               "int8": ff.StashForm(1, "int8")}
# the cases the forms are held in: K2's (narrow, training) and the deep
# stash cases (deep128, deep256); the plain K2 sums the weight gradients in
# the kernel's chunks in the deep ones
STASH_FORM_CASES = ("narrow", "training", "deep256")


# K2 reading the int8 stash against its plain version reading the same
# codes, where it reads more than K2 reading the bf16 stash: per case and
# output (max |kernel - plain| over max |plain|, relative L2), seed 0, on an
# NVIDIA H100 80GB HBM3 (700 W).  In the narrow case dW5x, a sum over the
# dequantized x4 (more of its entries exactly 0 than in bf16) of products
# with the cotangent, reads 1.4e-4 against the bf16 stash's 5.0e-5.
_K2_INT8_READINGS = {"narrow": {"dW5x": (1.4e-4, 6.2e-5)}}


def form_case_limits(case: str) -> Tuple[Dict, Dict]:
    """The limits of K2 reading a form against its plain version in
    ``case``: (recomputing: a partial stash, whose missing layers kernel and
    plain version recompute, each in its own summation order, so as K2
    recomputing; reading: the int8 stash, whose dequantized values both
    read alike, so as K2 reading the bf16 stash but where
    ``_K2_INT8_READINGS`` gives a reading of its own, twice that)."""
    own = {name: _limits(r) for name, r in _K2_INT8_READINGS.get(case, {}).items()}
    if case in DEEP_STASH_CASES:
        return DEEP_K2_LIMITS[case], {**DEEP_K2_STASH_LIMITS[case], **own}
    return k2_limits(case), {**K2_STASH_LIMITS[case], **own}


@torch.no_grad()
def k1_form_failures(args, form, full_acts) -> Tuple[Tuple, Dict, List[str]]:
    """K1 writing the stash in ``form`` on the card, given K1's bf16 stash of
    every layer on the same inputs (``full_acts``): its outputs against K1's
    without the stash, to the bit; a kept bf16 slot against the same slot of
    ``full_acts``, to the bit; the int8 codes and scales against the plain
    quantizer (:func:`~gazenerf_tpu_torch.kernels.fused_field.quantize_rows`)
    run on the card over ``full_acts``, to the bit.  Returns the outputs and
    the stash, a reading per slot (entries that differ), and the failures."""
    H = args[6].wmid.shape[1]
    out, acts = ff.fused_field_forward(*args, stash=form)
    fails = []
    if not all(torch.equal(a, b) for a, b in zip(out, ff.fused_field_forward(*args))):
        fails.append("outputs differ from K1's without the stash")
    full = dict(zip(STASH_SLOTS, full_acts))
    q = ff.stash_quant_tags(form)
    slots = acts[:-1] if q else acts
    layout = ff.stash_layout(H, form)
    if len(slots) != len(layout):
        fails.append(f"{len(slots)} slots, expected {len(layout)}")
    readings = {}
    for (tag, _), t in zip(layout, slots):
        if tag in q:
            codes, s = ff.quantize_rows(full[tag].float())
            readings[tag] = int((t != codes).sum())
            readings[f"{tag}_scale"] = int((acts[-1][..., q.index(tag)] != s).sum())
        else:
            readings[tag] = int((t != full[tag]).sum())
    fails += [f"{name}: {n} entries differ" for name, n in readings.items() if n]
    return (out, acts), readings, fails


@torch.no_grad()
def k2_form_failures(case, args, cot, form, acts, full_grads, dens_vpu: bool, chunks=None,
                     truth: bool = False) -> Tuple[object, Dict, List[str]]:
    """K2 reading the stash ``acts`` in ``form`` on the card.  A partial
    stash: its gradients equal ``full_grads`` (K2 reading the bf16 stash of
    every layer with the same ``dens_vpu``) to the bit, and lie within K2's
    recompute limits of the plain version reading the same stash.  The int8
    stash: within the bf16 stash's limits of the plain version reading the
    same codes (:func:`form_case_limits`) and, with ``truth``, within
    ``K2_STASH_TRUTH_RATIO`` of it from the unrounded float64 gradient.
    Returns the gradients, the readings and the failures."""
    got = ffb.fused_field_backward(*args, *cot, stash=acts, dens_vpu=dens_vpu, stash_form=form)
    want = ffb.fused_field_backward_reference(*args, *cot, stash=acts, dens_vpu=dens_vpu,
                                              stash_form=form, chunks=chunks)
    recompute_limits, stash_limits = form_case_limits(case)
    int8 = form.dtype == "int8"
    line = {}
    line["readings"], fails = limit_failures(got, want, stash_limits if int8 else recompute_limits)
    line["max_abs_err"] = float(max((a - b).abs().max() for a, b in zip(got, want)))
    if int8:
        if truth:
            want64 = ffb.fused_field_backward_reference(
                *args, *cot, stash=acts, dens_vpu=dens_vpu, stash_form=form, chunks=chunks,
                dtype=torch.float64)
            exact = ffb.fused_field_backward_unrounded(*args, *cot)
            line["unrounded_distance"], f = truth_failures(
                got, want, want64, exact, K2_STASH_TRUTH_RATIO, K2_STASH_TRUTH_EXEMPT)
            fails += f
    else:
        differ = [n for n, a, b in zip(got._fields, got, full_grads) if not torch.equal(a, b)]
        line["differ_from_full_stash"] = differ
        if differ:
            fails.append(f"vs K2 reading the full stash: {differ} differ")
    return got, line, fails


# K2 given the points reading the int8 stash against its plain version
# reading the same codes, per case and output where it reads more than K2
# given the points reading the bf16 stash (POINTS_K2_LIMITS["<case>_stash"];
# at S = 256, where that case was not read, the embedding's deep stash
# limits and the points' cotangent's own reading): (max |kernel - plain|
# over max |plain|, relative L2), seed 0, on an NVIDIA H100 80GB HBM3 (700
# W).  In the narrow case dW0e, a sum of the embedding's products with the
# cotangent through the dequantized x0, reads 2.94e-4 against the bf16
# stash's 5.9e-5, as dW5x does given the embedding (_K2_INT8_READINGS).
_POINTS_INT8_READINGS = {"narrow": {"dW0e": (3.0e-4, 1.1e-4)},
                         "deep256": {"dembed": (5.2e-6, 5.2e-6)}}


def points_form_limits(case: str, form) -> Dict:
    """The limits of K2 given the points reading the stash ``form`` against
    its plain version in ``case``: a partial stash's as K2 given the points
    recomputing (``POINTS_K2_LIMITS``, as :func:`form_case_limits` holds a
    partial stash), the int8 stash's as K2 given the points reading the
    bf16 stash, or where ``_POINTS_INT8_READINGS`` gives a reading, twice
    that."""
    if form.dtype != "int8":
        return POINTS_K2_LIMITS[case]
    limits = dict(POINTS_K2_LIMITS.get(f"{case}_stash") or DEEP_K2_STASH_LIMITS[case])
    limits.update({name: _limits(r) for name, r in _POINTS_INT8_READINGS.get(case, {}).items()})
    return limits


@torch.no_grad()
def points_form_failures(case, args, cot, form, chunks=None) -> Tuple[Dict, List[str]]:
    """The stash ``form`` with the sample points encoded in the tiles
    (``embed_in_kernel``) on the card, given the points' ``args``
    (:func:`points_case`).  K1 given the points writing the form equals K1
    given the plain encoding computed on the card and rounded to bf16
    writing it: its outputs and every slot, codes and scales, to the bit.
    K2 given the points reading that stash, with and without ``dens_vpu``:
    every output but the points' cotangent equals K2's given that encoding
    reading the same stash, to the bit; a partial stash gives K2 given the
    points reading their full bf16 stash to the bit, the points' cotangent
    included; each form lies within the limits of its plain version given
    the points reading the same stash (:func:`points_form_limits`).  Returns
    the readings and the failures."""
    nf = N_FREQS
    eargs = (ff.encoded(args[0], nf).to(torch.bfloat16), *args[1:])
    out, acts = ff.fused_field_forward(*args, stash=form, n_freqs=nf)
    want, wacts = ff.fused_field_forward(*eargs, stash=form)
    line = {"k1_outputs_differ": [int((a != b).sum()) for a, b in zip(out, want)],
            "k1_slots_differ": [int((a != b).sum()) for a, b in zip(acts, wacts)]}
    fails = []
    if len(acts) != len(wacts) or any(line["k1_outputs_differ"] + line["k1_slots_differ"]):
        fails.append(f"K1 differs from K1 given the card's encoding: {line}")
    del out, want, wacts
    int8 = form.dtype == "int8"
    full = None if int8 else ff.fused_field_forward(*args, stash=True, n_freqs=nf)[1]
    limits = points_form_limits(case, form)
    for dens_vpu in (False, True):
        mode = dict(stash=acts, dens_vpu=dens_vpu, stash_form=form)
        got = ffb.fused_field_backward(*args, *cot, n_freqs=nf, **mode)
        on_enc = ffb.fused_field_backward(*eargs, *cot, **mode)
        r = {"differ_from_card_encoding": [n for n, a, b in zip(got._fields[1:], got[1:],
                                                                on_enc[1:])
                                           if not torch.equal(a, b)]}
        if r["differ_from_card_encoding"]:
            fails.append(f"dens_vpu={dens_vpu}: K2 differs from K2 given the card's encoding in "
                         f"{r['differ_from_card_encoding']}")
        del on_enc
        if full is not None:
            fg = ffb.fused_field_backward(*args, *cot, stash=full, dens_vpu=dens_vpu, n_freqs=nf)
            r["differ_from_full_stash"] = [n for n, a, b in zip(got._fields, got, fg)
                                           if not torch.equal(a, b)]
            if r["differ_from_full_stash"]:
                fails.append(f"dens_vpu={dens_vpu}: vs K2 reading the full stash: "
                             f"{r['differ_from_full_stash']} differ")
            del fg
        plain = ffb.fused_field_backward_reference(*args, *cot, n_freqs=nf, chunks=chunks, **mode)
        r["readings"], f = limit_failures(got, plain, limits)
        r["max_abs_err"] = float(max((a - b).abs().max() for a, b in zip(got, plain)))
        fails += [f"dens_vpu={dens_vpu}: {x}" for x in f]
        line[f"k2_dens_vpu_{dens_vpu}"] = r
        del got, plain
    return line, fails


# ---------------- JPEG frames (kernels/jpeg.py) ------------------------------
# The pixel stage (``jpeg_pixels``) is held to its plain version to the bit,
# and the native entropy decoder's coefficients and warnings equal the plain
# decoder's; both decode the committed fixtures to ``cv2.imread``'s pixels
# (``tools/make_jpeg_fixtures.py``).

JPEG_FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "data" / "jpeg"
JPEG_MAX_ABS_ERR = 0  # integer arithmetic: the kernel gives the plain version's bits
# the strips stacked to ETH-XGaze's 6000 x 4000 frames: name -> repeats
JPEG_STRIP_REPEATS = {"strip420_6000x16": 250, "strip422_6000x8": 500}


def jpeg_fixture_names() -> List[str]:
    """The small fixtures: each ``<name>.jpg`` with cv2's pixels in
    ``<name>.png`` beside it."""
    return sorted(p.stem for p in JPEG_FIXTURES.glob("*.png"))


def stack_jpeg_strip(data: bytes, repeats: int) -> bytes:
    """A one-MCU-row strip whose restart interval is that row -> the frame
    ``repeats`` strips tall: the strip's one restart segment ``repeats``
    times, RST0-7 in turn between them, the height written into SOF0.  Each
    segment decodes alone (the DC predictions restart), so its coefficients
    are the strip's."""
    hdr = J.parse_header(data)
    if hdr is None or hdr.mcus_y != 1 or hdr.restart_interval != hdr.mcus_x:
        raise ValueError("not a one-MCU-row strip with a restart interval of that row")
    pos, sof = 2, None
    while data[pos + 1] != J.SOS:
        if data[pos + 1] in (J.SOF0, J.SOF1):
            sof = pos
        pos += 2 + struct.unpack_from(">H", data, pos + 2)[0]
    end = data.rindex(b"\xff\xd9")
    segment = data[hdr.scan_start:end]
    head = (data[:sof + 5] + struct.pack(">H", hdr.height * repeats)
            + data[sof + 7:hdr.scan_start])
    rst = [bytes([0xFF, J.RST0 + k % 8]) for k in range(repeats - 1)] + [b""]
    return head + b"".join(segment + r for r in rst) + b"\xff\xd9"


def jpeg_fixture_failures(name: str, device) -> List[str]:
    """A committed fixture decoded on ``device`` (``decode_jpeg``) against
    ``cv2.imread``'s committed pixels and the CPU's plain path, bit for bit."""
    data = (JPEG_FIXTURES / f"{name}.jpg").read_bytes()
    rgb = torch.from_numpy(decode_png((JPEG_FIXTURES / f"{name}.png").read_bytes()))
    want = rgb.flip(-1)
    got = kj.decode_jpeg(data, device).cpu()
    fails = []
    plain = kj.decode_jpeg(data, "cpu")
    for what, ref in (("cv2's pixels", want), ("the CPU's plain path", plain)):
        if got.shape != ref.shape or not torch.equal(got, ref):
            n = int((got != ref).sum()) if got.shape == ref.shape else "shape"
            fails.append(f"{name}: against {what}: {n} values differ")
    return fails


def jpeg_stacked_frame(name: str, repeats: int = 0) -> Tuple[bytes, bytes]:
    """A committed strip and the frame stacked from it (``repeats`` strips,
    by default ``JPEG_STRIP_REPEATS``: 6000 x 4000)."""
    strip = (JPEG_FIXTURES / f"{name}.jpg").read_bytes()
    return strip, stack_jpeg_strip(strip, repeats or JPEG_STRIP_REPEATS[name])


def jpeg_coefficient_failures(strip: bytes, frame: bytes, coef: torch.Tensor) -> List[str]:
    """``coef``, the native decoder's coefficients of ``frame`` (stacked
    from ``strip``), against the plain decoder's of the strip alone, for
    every restart segment (one MCU row of every component)."""
    one, big = J.parse_header(strip), J.parse_header(frame)
    plain, warn = J.entropy_decode_reference(strip, one)
    plain = torch.from_numpy(plain)
    repeats = big.mcus_y // one.mcus_y
    fails = [] if warn == 0 else [f"the strip decodes with warnings {warn}"]
    for k, (c1, cb) in enumerate(zip(one.components, big.components)):
        row = plain[c1.offset:c1.offset + c1.blocks_w * c1.blocks_h]
        tall = coef[cb.offset:cb.offset + cb.blocks_w * cb.blocks_h].view(repeats, *row.shape)
        bad = (tall != row).flatten(1).any(1)
        if bad.any():
            fails.append(f"component {k}: {int(bad.sum())} of {repeats} segments differ")
    return fails
