#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0] [--requests 4] [--steps 5] [--fit_steps 10]

Phases (each raises on failure, so any failed phase exits non-zero):

1. device: the card's name and power limit; TF32 off for matmul and cuDNN;
2. build: compile every kernel (``kernels/build.every_kernel``) with
   ``nvcc``, all at once, and print each kernel's registers and spill;
3. kernels: the field forward (K1) against its plain PyTorch version at the
   render's shapes (the serving case's limits, ``checks.K1_LIMITS``), timed
   there and at the training step's (B=2); the field backward (K2) against
   its plain version in a narrow case (hidden 64) and at the training step's
   shape, where it is also held against the unrounded float64 gradient,
   with its device time per
   kernel (``k2_profile``); the backwards' weight-gradient GEMM on one full
   chunk of the training step against its plain version, timed beside
   ``torch.matmul`` on the same bf16 operands (``dw``); the renderer's blur-shuffle
   stencil (K5, K6) at its three levels and fused upsampler block (K7, K8)
   at its three blocks (bf16, B=2) against their plain versions, K8 also
   against the unrounded float64 gradient and for equal bits over two
   launches, with its device time per kernel (``k8_profile``); the
   dual-branch forward (K3) at the render's and the training
   step's shapes against its plain version (outputs and stash) and against
   K1 on each branch, and its stash-reading backward (K4) in the narrow case
   and at the training step's shape against its plain version, against K2
   on each branch (the weight gradients to the bit), against the unrounded
   float64 gradient and for equal bits over two launches (``k4_profile``);
   K1 writing the single-branch stash at the training step's shape against
   its plain version (outputs and stash) and K1 without it, and K2 reading
   it, with and without ``dens_vpu``, in the narrow case and at the
   training step's shape against its plain version, the unrounded float64
   gradient, itself over two launches and K2 recomputing (to the bit;
   ``k2_stash_profile``; without ``dens_vpu`` it is the mode that
   ``pallas_split_dw`` runs); rays longer
   than one tile (``kernels/checks.py``
   ``DEEP_CASES``: S = 128, 192, 256): K1 and K2 against their plain
   versions, K2 against the unrounded float64 gradient, K1 writing the
   stash and K2 reading it (density masks equal, K2 recomputing's bits), K3
   and K4 against K1 and K2 per branch, and all four timed at the deep
   march's shape (B=2, 4096 rays x 256 samples) beside their plain versions
   run in 512-ray chunks (``k2_deep_profile``); the sample points encoded
   in K1's and K2's tiles (``embed_in_kernel``, ``checks.POINTS_CASES``:
   narrow, training, S = 256) against their plain versions and against K1
   and K2 given the plain encoding computed on the card as a bf16 embedding
   (to the bit), the count of entries where that encoding and the CPU's
   round apart, K2 reading the stash, K2 against the unrounded float64
   gradient (``k2_points_profile``); K5 and K6 at the three levels unfolded (C = 258,
   129, 64) and K7 and K8 at f32 (the f32 renderer) at the three blocks,
   against their plain versions and the unrounded result
   (``f32_block_profile``); each timed (CUDA events; K5 and K6 from a CUDA graph of their launches,
   which take less time on the card than their wrappers on the host)
   beside its bound.  The
   limits are in ``kernels/checks.py``;
4. serving: per variant (the renderer modes ``phase_gm``, ``pallas``,
   ``fused``; ``dual``: both fields in the dual-branch kernels with the
   ``phase_gm`` renderer; ``stash``: K1 writing and K2 reading the
   single-branch stash with ``dens_vpu``, the ``phase_gm`` renderer, whose
   image must be ``phase_gm``'s to the bit; ``fused_f32``: K7 at f32 with the
   f32 renderer, its image against a ``phase_gm`` app's with the f32
   renderer; ``fuse_embed``, ``embed_bf16``: the stash variant with the
   points encoded in the kernels or the bf16 embedding, their images
   against the stash variant's; the eager renderer modes ``phase``,
   ``naive``, ``unfolded``, ``unfolded_pallas``, ``rgb_nhwc``, against
   ``phase_gm``'s), a full-width bf16 ``ViewerApp`` with the same
   seeded random weights answers ``--requests`` render requests (512x512
   PNGs) with launch counts read around them; one request is rendered again
   with the plain versions in place of the kernels and the two images
   compared, and each variant's image is compared with ``phase_gm``'s;
5. breakdown: where a request's time goes (host-clock parts, device time
   by kernel under ``torch.profiler``, also on the dual path), and the
   renderer's share: the viewer's one pass against the model forward's
   four; one renderer pass per mode;
6. training: per variant, a full-width bf16 ``Trainer`` (B=2, 512x512, the
   default loss stack) takes 2 warm-up and ``--steps`` timed steps on a
   seeded synthetic batch, with launch counts read around the timed steps;
   one step's gradients with the kernels are held against the same step
   with the plain versions (on the dual path also against the
   single-branch step and the step without the stash, which launches K3
   once and K2 twice; the ``stash`` step also against ``phase_gm``'s);
   then where a step's time goes, with both memory peaks (the caching
   allocator's and the tensors' requested bytes); the same for the
   training step with the full loss stack (``full_loss``: the VGG16,
   angular and PatchGAN losses with the discriminator's update and the
   gradual eye importance, ``phase_gm``; ``split_dw``: the same with
   ``pallas_split_dw``, K1 writing the stash and K2 reading it without
   ``dens_vpu``, the mode of each K2 call read on the main path, its step
   also against ``phase_gm``'s), each side of
   a gradient comparison from the same discriminator state, with the
   discriminator update's, the gaze-VGG's and the generator term's stage
   times;
   the embedding settings', the f32 renderer's and the eager modes'
   variants of step 4 take their steps too (the eager
   renderer modes one timed step and a step's device time alone), each
   against the same
   step without its setting (``fused_f32`` and the eager modes against
   ``phase_gm`` at the trainer's seeded state, before its first step, the
   mode's gradients read twice; the embedding settings against the f32
   embedding), with
   what the fields' autograd op and each K1 and K2 call take for the
   embedding read (``EMBED_MODES``); the stash's forms' variants
   ``stash_every2`` and ``stash_int8`` (the ``stash`` variant's flags with
   ``pallas_stash_every=2`` or ``pallas_stash_dtype="int8"``, a step's
   device time in place of the breakdown, the form of each K2 call read)
   against the bf16 stash of every layer's step (``INT8_GRAD_REL_L2``),
   and ``fuse_embed_every2`` and ``fuse_embed_int8`` (``fuse_embed`` with
   the same forms, also against the f32 embedding);
   then the deep march's variants, ``deep``, ``deep_stash``,
   ``deep_fuse_embed``, ``deep_stash_every2`` and ``deep_stash_int8`` (S =
   256 in checkpointed 512-ray chunks, the CLI's ``--pallas_tuning auto``
   overrides for that shape, no VGG loss; the second reading the stash, the
   last two its forms, as the variants at S = 64), as
   the variants above: 2 + ``--steps`` steps with launch counts (per step
   32 K1 and 16 K2), one step's gradients against the plain versions, where
   a step's time goes and both memory peaks (the ``deep_training`` line);
   and the hierarchical sampler's fine pass in a B=1 model forward (three
   K1 a forward, the fine field at S = 192; the renderer passes stacked for
   the fused upsampler), its images against the plain versions' (``hier``),
   and the same with the points encoded in the kernels
   (``hier_fuse_embed``);
7. cli: ``python -m gazenerf_tpu_torch.cli.train`` in-process at the
   reference shape with ``--pallas_tuning auto`` on one synthetic 512x512
   subject for 2 epochs and, resumed from the last checkpoint, a third:
   finite losses, a checkpoint per epoch, the restored state equal to the
   saved one, K1 and K2 twice a step in the overrides' mode, ``summary.csv``
   with every epoch.  It needs h5py; without it the phase says so on a
   line of its own and does not run;
8. distributed: the training step on more than one process, on the one
   card: four ranks over gloo on ``cuda:0`` (``dp 2 x rp 2``: one row and
   2048 rays a rank) and one rank over NCCL, each a process of this script,
   against the one-process step (B=2, the default loss stack with VGG,
   bf16, phase_gm, K1 and K2 recomputing) from the same seeded state,
   batch (the rows' masks differ) and jitter draws: the loss, each
   parameter group's reduced gradient (``GRAD_REL_L2``), the updated
   parameters, K1 and K2 twice per rank and step, each rank's step time
   and the gather's and the reduction's bytes and ms; again with the
   PatchGAN, with its parameters and BatchNorm statistics (the
   ``distributed`` line);
9. eval: in the configuration the evaluation CLIs build (the ``stash``
   variant's kernels at B=1), a single-image fit of ``--fit_steps`` steps
   with launch counts, its gradients against the plain versions, K2 at
   B=1 against its plain version and the unrounded gradient, predict with
   a gaze override against the forward (to the bit), a 30-step gaze
   optimization (its start gradient against the plain versions'), the
   input-target, consistency and gaze-transfer protocols with a seeded
   estimator and LPIPS, the input-target protocol again with exact FID
   (InceptionV3) and the FaceX-Zoo identity pipeline (RetinaFace, PFLD,
   MobileFaceNet) loaded from seeded checkpoints through the CLI's
   loaders, each net's output on the card against the CPU's and their
   times (``phase_metric_nets``), and the demo render loops written and
   parsed as GIFs (``phase_eval``);
10. preprocess: the offline data factory (``preprocess/``, ``nl3dmm/``),
   no kernel of the port on its path (launch counts read around it, 0
   each): the seeded BiSeNet and U-Net at 512^2 card against CPU,
   ``process_frame`` on an ETH-XGaze and a Columbia raw frame card against
   CPU with both nets, the full-width NL-3DMM fit (34,650 vertices, 69,296
   triangles, 128^2) at 2 + 2 steps (B=2) card against CPU, and the full
   50 + 200 step fit at B=18 with its step times, peak memory and the
   rasterizer's and the sort's device ms (``phase_preprocess``);
11. jpeg: JPEG frames (``kernels/jpeg.py``, ``csrc/jpeg_decode.cu``): the
   committed fixtures decoded on the card against ``cv2.imread``'s pixels
   and the CPU's plain path, two 6000 x 4000 frames stacked from the
   committed strips (4:2:0 and 4:2:2) with their coefficients against the
   plain decoder's and their pixels against the plain pixel stage on the
   card and cv2's digests, ``read_frame`` on both with one ``jpeg_pixels``
   launch a frame, and the times of its parts (``phase_jpeg``).

Prints ``k2_profile``, ``dw``, ``k8_profile``, ``f32_block_profile``,
``k4_profile``, ``k2_stash_profile``, ``deep_case``, ``deep_dual_case``,
``k2_deep_profile``, ``stash_form_case``, ``stash_form_points_case``,
``stash_forms``, ``points_case``, ``k2_points_profile``, ``serving``,
``training``, ``deep_training``, ``hier``, ``hier_fuse_embed``, ``cli``,
``distributed``, ``k2_fit_case``, ``eval``, ``preprocess``, ``jpeg`` and
``kernels`` JSON lines, the run's wall time, the ``nvidia-smi`` line and,
last, the device JSON line.  Exits non-zero without a result when no CUDA card is present.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# published dense peaks of one H100 SXM (NVIDIA data sheet): bf16 on the
# tensor cores, f32 outside them, device memory
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# the renderer's modes: the default in PyTorch ops, the blur-shuffle stencil
# kernels (K5, K6), the fused upsampler kernels (K7, K8)
MODES = ("phase_gm", "pallas", "fused")
# the field variant beside them: both fields in the dual-branch kernels with
# the activation stash (K3, K4), with the phase_gm renderer
DUAL = "dual"
DUAL_FLAGS = {"pallas_dual_branch": True, "pallas_stash_acts": True}
# and the single-branch fields with the stash and the dens_vpu density head
# (K1 writing the stash, K2 reading it), with the phase_gm renderer: what
# the training CLI's --pallas_tuning auto selects at S <= 64
STASH = "stash"
STASH_FLAGS = {"pallas_stash_acts": True, "pallas_dens_vpu": True}
# the deep march's training variants: recomputing, and reading the stash
DEEP = "deep"
DEEP_STASH = "deep_stash"
# BASELINE.json config 4: the training step with the full loss stack (VGG16
# perceptual, the angular gaze loss, the PatchGAN and its update, the
# gradual eye importance), phase_gm; the generator term's warm-up short
# enough that it is on from the second step; and the same with split_dw
FULL_LOSS = "full_loss"
SPLIT_DW = "split_dw"
FULL_LOSS_FLAGS = dict(use_vgg_loss=True, use_angular_loss=True, use_patch_gan_loss=True,
                       is_gradual_loss=True, gan_warmup_steps=10)
SPLIT_DW_FLAGS = {"pallas_split_dw": True, "pallas_dens_vpu": True}
# the stash's other forms on the training path: the stash variant's flags
# with the stash of every second trunk layer or the int8 stash, and the
# deep march's deep_stash with the same
STASH_EVERY2 = "stash_every2"
STASH_INT8 = "stash_int8"
FORM_FLAGS = {STASH_EVERY2: {"pallas_stash_every": 2}, STASH_INT8: {"pallas_stash_dtype": "int8"}}
DEEP_FORM_FLAGS = {f"deep_{name}": flags for name, flags in FORM_FLAGS.items()}
# and the fuse_embed variant's (below) with the same forms: the points
# encoded in the tiles of the forms' kernels
POINTS_FORM_FLAGS = {name.replace("stash", "fuse_embed"): flags
                     for name, flags in FORM_FLAGS.items()}
# the modes (stash read, dens_vpu) of the K2 calls a variant's step makes:
# split_dw reads the stash without dens_vpu, whatever pallas_dens_vpu says
K2_MODES = {STASH: [(True, True)], SPLIT_DW: [(True, False)],
            **dict.fromkeys((*FORM_FLAGS, *DEEP_FORM_FLAGS, *POINTS_FORM_FLAGS),
                            [(True, True)])}
# the f32 renderer's fused mode: K7 and K8 at f32 (use_bf16=False), the
# library's default renderer dtype
FUSED_F32 = "fused_f32"
FUSED_F32_FLAGS = {"shuffle_mode": "fused", "renderer_dtype": "float32"}
# the fields' two embedding settings, each beside the stash variant's flags:
# the sample points encoded in K1's and K2's tiles, and the bf16 embedding
# with its bf16 cotangent
FUSE_EMBED = "fuse_embed"
EMBED_BF16 = "embed_bf16"
EMBED_FLAGS = {FUSE_EMBED: {**STASH_FLAGS, "pallas_fuse_embed": True},
               EMBED_BF16: {**STASH_FLAGS, "pallas_embed_bf16": True}}
# the deep march (S = 256, recomputing, in 512-ray chunks) with the points
# encoded in the kernels
DEEP_FUSE_EMBED = "deep_fuse_embed"
# what the fields of a variant's warm-up steps give their autograd op (the
# points, or the embedding in its dtype, which its cotangent comes back in)
# and what every K1 and K2 call takes (the points or the bf16 embedding)
EMBED_MODES = {FUSE_EMBED: ("points", "points"), EMBED_BF16: ("bfloat16", "bfloat16"),
               DEEP_FUSE_EMBED: ("points", "points"), STASH: ("float32", "bfloat16"),
               **dict.fromkeys(POINTS_FORM_FLAGS, ("points", "points"))}
# the renderer's eager modes (bf16), each held against phase_gm: upstream's
# channel order with the phase stencil or the blur after the shuffle, the
# feat_layer unfolded (in PyTorch ops, or with K5/K6 at the blocks' own
# widths), the NHWC rgb chain
EAGER_MODES = {"phase": {"shuffle_mode": "phase"}, "naive": {"shuffle_mode": "naive"},
               "unfolded": {"renderer_fold_feat": False},
               "unfolded_pallas": {"shuffle_mode": "pallas", "renderer_fold_feat": False},
               "rgb_nhwc": {"renderer_rgb_cf": False}}
# the epoch whose gradual eye importance the training variants take
# (eye_loss_importance + 30 * epoch = 70)
GRADUAL_EPOCH = 2
# the kernels' counters, in the order of the ``kernels`` line
KERNELS = ("fused_field_fwd", "fused_field_bwd", "shuffle_blur_fwd", "shuffle_blur_bwd",
           "fused_upsampler_fwd", "fused_upsampler_bwd", "fused_dual_fwd", "fused_dual_bwd",
           "fused_upsampler_fwd_f32", "fused_upsampler_bwd_f32", "jpeg_pixels")

# whole image with the kernel vs with its plain version: the bf16 image
# bound of the JAX package's fused-vs-XLA model test
IMAGE_ATOL = 3e-2
# a kernel mode's image against phase_gm's on the same weights (the kernel
# modes round to bf16 where phase_gm keeps f32): about 2x the largest
# reading, which was the same in four runs, 1.374e-3 (pallas) and 2.368e-3
# (fused)
MODE_IMAGE_ATOL = 5e-3
# one training step's gradients, kernels vs plain versions, relative L2 per
# parameter group; readings over two runs 3.3e-4 to 3.6e-4 (net), 1.7e-4 to
# 2.7e-4 (codes), 5.2e-3 and 1.1e-2 (euler), 1.1e-2 (tvec).  The camera
# offsets' gradient is a small sum of large per-pixel terms: the JAX
# package's own f32 gradient of it moves by 1.4e-2 between a jitted and an
# op-by-op run (tests/test_torch_train.py), and the step's cuDNN and index
# backward kernels sum in a different order on every run (PERF.md, Findings)
GRAD_REL_L2 = {"net": 2e-3, "iden": 2e-3, "expr": 2e-3, "appea": 2e-3,
               "euler": 5e-2, "tvec": 5e-2}
# per renderer mode, where it differs.  In "fused" K7 rounds the block's
# output where its plain version does but sums in another order, so the
# images differ by a bf16 step here and there (in pallas K5 and K6 equal
# their plain versions to the bit), and the net group, nearly all of it
# renderer weights, reads more and spreads more from run to run: 1.675e-4,
# 1.570e-4, 1.558e-4, 5.109e-4 and 1.562e-3 over five runs; the limit is
# about 2x the largest (pallas 2.769e-4 to 3.931e-4 over the same runs)
GRAD_REL_L2_MODE = {"fused": {"net": 3.2e-3}}
# the dual path's step gradients against the single-branch path's, and with
# the stash against without it, on the same state: K3 is K1 per branch to
# the bit and K4's weight gradients equal K2's, so they differ only by the
# order of the branches' per-point sums and the renderer's atomic index
# backward; readings 2.1e-5 (net) to 5.7e-5 (camera offsets) on an NVIDIA
# H100 80GB HBM3 (700 W).  Held as kernels vs plain
DUAL_GRAD_REL_L2 = GRAD_REL_L2
# the dual path's image against the single-branch path's on the same
# weights: K3 is K1 per branch to the bit
DUAL_IMAGE_ATOL = 0.0
# the stash variant's image against phase_gm's: a render writes no stash
# and the density head is the same, so the same bits
STASH_IMAGE_ATOL = 0.0
# the stash variant's step gradients against phase_gm's on the same state:
# K2 reading K1's stash gives K2's recompute to the bit but for dWd, which
# dens_vpu takes from the unrounded density cotangent.  Held as the dual
# path's
STASH_GRAD_REL_L2 = DUAL_GRAD_REL_L2
# the embedding settings' and renderer modes' step gradients against the same step without the
# setting, from the same state (relative L2 per parameter group), on an
# NVIDIA H100 80GB HBM3 (700 W).  The embedding settings against the f32
# embedding: the same fields and weight gradients; readings net 2.3e-5, the
# codes 2.1e-6 to 2.7e-6 (the renderer's atomic index backward, which moved
# split_dw's step against phase_gm's net group by 2.0e-5 too), the camera offsets
# 5.5e-5 (the points' cotangent summed in the kernel's order) and with the
# bf16 cotangent 9.0e-4 and 1.3e-3; held at 2e-4 and 4e-3.  The renderer
# modes against phase_gm in the same renderer dtype, both at the trainer's
# seeded state (phase_render_mode_grads): fused_f32 read 1.1e-7 to 1.9e-7
# and the camera offsets 1.9e-6 and 7.2e-6 (f32 against f32; at the state
# its steps reached), held at 1e-4 and 1e-3.  The eager bf16 modes round at
# other points than phase_gm; at the seeded state their distance from it is
# the same in every run (tools/torch_grad_repeat.py, two processes, with
# and without deterministic algorithms: its readings spread by 2.7e-4 at
# most, in the camera offsets, and the net group's by 7e-7), and a step
# read twice moves by 6.6e-5 at most.  Held per mode and group at twice the largest reading (phase and
# naive alike, unfolded and unfolded_pallas alike).  At a state reached by a
# variant's own steps the distance moved fivefold between runs (unfolded's
# net group 2.4e-3 and 1.1e-2 in two trainers made alike in one process):
# the atomic sums of the step's index_add_, bilinear and reflect-pad
# backwards differ in the last place from run to run, and Adam carries that
# into the camera-offset tables (1.2e-2 apart after three steps).  The
# stash's forms given the points as fuse_embed: K1 given the points writes
# the stash of K1 given the card's encoding, to the bit (int8 codes
# included: phase_stash_forms), so only the points' cotangent parts them
_CODES = ("iden", "expr", "appea")
EMBED_GRAD_REL_L2 = {name: {"net": 2e-4, **dict.fromkeys(_CODES, 2e-4), "euler": 4e-3,
                            "tvec": 4e-3}
                     for name in (FUSE_EMBED, EMBED_BF16, DEEP_FUSE_EMBED, *POINTS_FORM_FLAGS)}
_GROUPS = ("net", *_CODES, "euler", "tvec")
# readings at the seeded state on an NVIDIA H100 80GB HBM3 (700 W), in the
# order of _GROUPS
_EAGER_READINGS = {
    "phase": (9.49e-4, 7.00e-5, 8.46e-5, 4.04e-4, 4.07e-3, 2.10e-3),
    "unfolded": (5.60e-3, 1.50e-4, 1.58e-4, 4.24e-4, 1.93e-3, 2.53e-3),
    "rgb_nhwc": (7.17e-3, 4.81e-3, 4.90e-3, 1.04e-2, 6.21e-3, 4.94e-3),
}
_EAGER_READINGS["naive"] = _EAGER_READINGS["phase"]
_EAGER_READINGS["unfolded_pallas"] = _EAGER_READINGS["unfolded"]
# the int8 stash's step gradients against the bf16 stash's on the same
# state: the JAX package's bound for its int8 stash against its bf16 path
# (tests/test_fused_field.py: 0.03 relative L2 over all of a field's
# gradients, the weights' and the inputs' together), over all the step's
# gradients together and per group of the field's weights and codes.  The
# camera offsets' gradient is the embedding cotangent's sum against the
# rays' Jacobians, a small sum of large per-pixel terms, which the int8
# stash's flipped ReLU masks move by far more than the field's gradients:
# readings 9.4e-2 and 2.1e-1 at S = 64, 2.6e-2 and 1.1e-1 at S = 256 on an
# NVIDIA H100 80GB HBM3 (700 W); held at twice the larger.  The port's int8
# step lies as close to JAX's int8 step on the CPU as the bf16 steps do
# (tests/test_torch_stash_forms.py), so JAX's int8 stash moves them alike.
INT8_GRAD_REL_L2_ALL = 0.03
INT8_GRAD_REL_L2 = {**dict.fromkeys(_GROUPS, 0.03), "euler": 0.19, "tvec": 0.43}
RENDER_GRAD_REL_L2 = {FUSED_F32: {"net": 1e-4, **dict.fromkeys(_CODES, 1e-4), "euler": 1e-3,
                                  "tvec": 1e-3}}
RENDER_GRAD_REL_L2.update({name: {g: 2 * r for g, r in zip(_GROUPS, _EAGER_READINGS[name])}
                           for name in EAGER_MODES})
# those variants' images, the same card: fused_f32 against a
# phase_gm app with the f32 renderer (reading 0: K7 at f32 and PyTorch's f32
# products agree to the bit there; held at 1e-5, f32 noise); the embedding
# settings against the stash variant (0: the tiles' encoding equals
# PyTorch's to the bit, no entry rounded apart); the eager modes against
# phase_gm (2.0e-3 to 2.9e-3, rgb_nhwc the largest: its bf16 rgb chain)
F32_IMAGE_ATOL = 1e-5
EMBED_IMAGE_ATOL = 0.0
EAGER_IMAGE_ATOL = 6e-3
# the gaze optimization's gradient at its start point, kernels vs plain
# versions (relative L2 of the 2-vector): K2's conditioning gradient (dcb0,
# dcb5) and the eye planes' rotation; reading 6.6e-4 on an NVIDIA H100 80GB
# HBM3 (700 W), the limit twice that
EVAL_DGAZE_REL_L2 = 1.4e-3
# the evaluation's metric nets (InceptionV3, RetinaFace, PFLD,
# MobileFaceNet) on the card against the same module on the CPU, f32 with
# TF32 off (--eval_precision highest): relative L2 of each output (PFLD's
# less its regression bias, which the seeded weights make most of it).
# First readings 6.6e-7, 1.8e-6, 9.6e-6 and 1.4e-6 on an NVIDIA H100 80GB
# HBM3 (700 W); the limits about five times each
METRIC_NET_REL_L2 = {"inception": 3e-6, "retinaface": 1e-5, "pfld": 5e-5, "mobilefacenet": 7e-6}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters, warmup=2, graph=False):
    """ms per call of ``fn`` from CUDA events around ``iters`` calls after
    ``warmup``; with ``graph``, around four replays of one CUDA graph of
    ``iters`` calls, so that a kernel that takes less time on the card than
    its wrapper on the host is timed on the card."""
    import torch

    for _ in range(warmup):
        fn()
    replays = 1
    if graph:
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            for _ in range(iters):
                fn()
        g.replay()
        run, replays = g.replay, 4
    else:
        def run():
            for _ in range(iters):
                fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def random_biases_(module, gen):
    """Seeded initialisers zero every bias; trained biases are not zero, and
    a kernel that drops or misplaces one must show it: fill each bias with
    0.1 * N(0, 1)."""
    import torch

    with torch.no_grad():
        for name, t in module.named_parameters():
            if name.endswith("bias"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))


def demangled_kernel(mangled):
    """The last name of a mangled entry name's nested name (``_ZN...E``),
    with its bool and int template arguments (``<true, false, 2>``)."""
    import re

    pos = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") else -1
    name = None
    while pos >= 0:
        m = re.match(r"\d+", mangled[pos:])
        if not m:
            break
        n = int(m.group())
        start = pos + len(m.group())
        name, pos = mangled[start:start + n], start + n
    if name is None:
        return mangled
    args = re.match(r"I((?:Lb[01]E|Li\d+E)+)E", mangled[pos:])
    if not args:
        return name
    vals = re.findall(r"L([bi])(\d+)E", args.group(1))
    return name + "<" + ", ".join(
        v if t == "i" else ("true" if v == "1" else "false") for t, v in vals) + ">"


def ptxas_lines(log):
    """One line per kernel entry function of an ``nvcc -Xptxas -v`` log: its
    name (the template arguments and parameter list cut), registers and
    spill stores and loads."""
    import re

    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = demangled_kernel(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers, {spill}")
            name, spill = None, ""
        elif "error" in line:
            out.append(line.strip())
    return out


def kernel_modules():
    from gazenerf_tpu_torch.kernels import fused_field as ff
    from gazenerf_tpu_torch.kernels import fused_field2 as ff2
    from gazenerf_tpu_torch.kernels import fused_field2_bwd as ffb2
    from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb
    from gazenerf_tpu_torch.kernels import fused_upsampler as fu
    from gazenerf_tpu_torch.kernels import jpeg as kj
    from gazenerf_tpu_torch.kernels import shuffle_blur as sb

    return ff, ffb, sb, fu, ff2, ffb2, kj


# each counter of the ``kernels`` line: (module index in kernel_modules(), name)
_COUNTERS = ((0, "launch_count"), (1, "launch_count"), (2, "launch_count_fwd"),
             (2, "launch_count_bwd"), (3, "launch_count_fwd"), (3, "launch_count_bwd"),
             (4, "launch_count"), (5, "launch_count"), (3, "launch_count_fwd_f32"),
             (3, "launch_count_bwd_f32"), (6, "launch_count"))


def launch_counts():
    """Every kernel's launch count, by the names of the ``kernels`` line."""
    mods = kernel_modules()
    return {k: getattr(mods[i], n) for k, (i, n) in zip(KERNELS, _COUNTERS)}


def reset_launch_counts():
    mods = kernel_modules()
    for i, n in _COUNTERS:
        setattr(mods[i], n, 0)


def renderer_passes(cfg):
    """The renderer passes of a model forward: four, or stacked along the
    batch into one (``batch_renderer_passes``) or two (``batch_fg_passes``),
    and one more for the fine pass (``hier_sampling``)."""
    passes = 1 if cfg.batch_renderer_passes else 2 if cfg.batch_fg_passes else 4
    return passes + (1 if cfg.hier_sampling else 0)


def expected_launches(cfg, n, train, forward=False):
    """The launch counts ``n`` requests (``train`` False: the viewer's one
    renderer pass each, no gradient), ``n`` model forwards without a
    gradient (``forward``: every renderer pass of the forward) or ``n``
    training steps (every pass, all with a gradient but the fine pass's) of
    ``cfg`` should show.  Per request, forward or step two K1 (K3 once on
    the dual path) per chunk of rays (``ray_chunk``; in a step each chunk's
    forward runs again in the backward, under the checkpoint), and one K1
    for the fine pass; per step two K2 per chunk (K4 once on the dual path
    with the stash, two K2 without it), none for the fine pass, which no
    loss reads; and the mode's renderer kernels (none in ``phase_gm`` and
    the eager modes; in ``fused`` K7 and K8 at f32 for the f32 renderer)
    once per upsample block and pass."""
    from gazenerf_tpu_torch.models.gaze_nerf import chunked

    out = dict.fromkeys(KERNELS, 0)
    chunks = cfg.num_rays // cfg.ray_chunk if chunked(cfg, cfg.num_rays) else 1
    fwd = chunks * (2 if train and chunks > 1 else 1)
    if cfg.pallas_dual_branch:
        out["fused_dual_fwd"] = n * fwd
        if train and cfg.pallas_stash_acts:
            out["fused_dual_bwd"] = n * chunks
        elif train:
            out["fused_field_bwd"] = 2 * n * chunks
    else:
        out["fused_field_fwd"] = 2 * n * fwd
        out["fused_field_bwd"] = 2 * n * chunks if train else 0
    if cfg.hier_sampling and (train or forward):
        out["fused_field_fwd"] += n
    prefix = {"pallas": "shuffle_blur", "fused": "fused_upsampler"}.get(cfg.shuffle_mode)
    if prefix:
        suffix = "_f32" if prefix == "fused_upsampler" and cfg.renderer_dtype == "float32" else ""
        passes = renderer_passes(cfg) if train or forward else 1
        blocks = cfg.n_upsample_blocks * n
        out[f"{prefix}_fwd{suffix}"] = passes * blocks
        out[f"{prefix}_bwd{suffix}"] = (passes - cfg.hier_sampling) * blocks if train else 0
    return out


def field_macs(De, H):
    """One field's forward multiply-adds per point, the feature head apart:
    fea_0..7 (the skip at fea_5), the density head, rgb_0 and rgb_1."""
    return De * H + 4 * H * H + (De + H) * H + 2 * H * H + H + H * H + H * (H // 2)


def k1_bound(B, R, S, De, H, C, operands):
    """Least time for the fused field forward at these shapes: bf16
    tensor-core operations vs bytes in and out, each moved once."""
    H2 = H // 2
    ops = 2 * (B * R * S * field_macs(De, H) + B * R * H2 * C)  # head after the sum
    bytes_in = (
        B * R * S * De * 2  # bf16 embedding
        + 2 * B * R * S * 4  # zvals, zdists
        + B * (2 * H + H2) * 4  # conditioning rows
        + sum(t.numel() * t.element_size() for t in operands)
    )
    bytes_out = B * R * C * 4 + 2 * B * R * 4 + B * R * S * 4
    t_ops = ops / PEAK_BF16_FLOPS
    t_bytes = (bytes_in + bytes_out) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k2_bound(args, cot, grads):
    """Least time for the fused field backward on these inputs: the
    recompute, the data gradients and the weight gradients (each the
    forward's multiply-adds) plus the folded head, vs bytes in and out."""
    embed, ops = args[0], args[-1]
    B, R, S, De = embed.shape
    H, H2, C = ops.w0e.shape[0], ops.wr2.shape[0], ops.wr2.shape[1]
    ops_count = 2 * (3 * B * R * S * field_macs(De, H) + 2 * B * R * H2 * C)
    tensors = [*args[:-1], *ops, *cot]
    bytes_in = sum(t.numel() * t.element_size() for t in tensors)
    bytes_out = sum(t.numel() * t.element_size() for t in grads)
    t_ops = ops_count / PEAK_BF16_FLOPS
    t_bytes = (bytes_in + bytes_out) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def k3_bound(args, outs, acts):
    """Least time for the dual forward on these inputs: both branches' bf16
    products (K1's per point, the feature head per ray) vs every input read
    once and the outputs and the stash (when written) written once."""
    embed, ops = args[0], args[6]
    B, R, S, De = embed.shape
    H, H2, C = ops.w0e.shape[1], ops.wr2.shape[1], ops.wr2.shape[2]
    ops_count = 2 * 2 * (B * R * S * field_macs(De, H) + B * R * H2 * C)
    moved = nbytes(*args[:6], *ops, *(t for o in outs for t in o), *(a for br in acts for a in br))
    return bound([ops_count / PEAK_BF16_FLOPS], moved / PEAK_BYTES_PER_S)


def k4_bound(args, cot, acts, grads):
    """Least time for the dual backward on these inputs: per branch the data
    and the weight gradients (each the forward's multiply-adds), the density
    and folded feature head read back from x7 and y1, and the head's per-ray
    products, vs the embedding, z values, weights, cotangents and stash read
    once and the gradients written once."""
    embed, ops = args[0], args[6]
    B, R, S, De = embed.shape
    H, H2, C = ops.w0e.shape[1], ops.wr2.shape[1], ops.wr2.shape[2]
    P = B * R * S
    ops_count = 2 * 2 * (2 * P * field_macs(De, H) + P * (H + H2) + 2 * B * R * H2 * C)
    moved = nbytes(*args[:3], *ops, *(t for g in cot for t in g),
                   *(a for br in acts for a in br), *grads)
    return bound([ops_count / PEAK_BF16_FLOPS], moved / PEAK_BYTES_PER_S)


def k1_stash_bound(args, outs, acts):
    """K1 writing the stash, K3's bound on one branch: the bf16 products (per
    point, the feature head per ray) vs every input read once and the
    outputs and the stash written once."""
    embed, ops = args[0], args[6]
    B, R, S, De = embed.shape
    H, H2, C = ops.w0e.shape[0], ops.wr2.shape[0], ops.wr2.shape[1]
    ops_count = 2 * (B * R * S * field_macs(De, H) + B * R * H2 * C)
    return bound([ops_count / PEAK_BF16_FLOPS], nbytes(*args[:6], *ops, *outs, *acts)
                 / PEAK_BYTES_PER_S)


def k2_stash_bound(args, cot, acts, grads):
    """K2 reading the stash, K4's bound on one branch: the data and the
    weight gradients (each the forward's multiply-adds), the density and
    folded feature head read back from x7 and y1, and the head's per-ray
    products, vs the inputs, cotangents and stash read once and the
    gradients written once."""
    embed, ops = args[0], args[6]
    B, R, S, De = embed.shape
    H, H2, C = ops.w0e.shape[0], ops.wr2.shape[0], ops.wr2.shape[1]
    P = B * R * S
    ops_count = 2 * (2 * P * field_macs(De, H) + P * (H + H2) + 2 * B * R * H2 * C)
    return bound([ops_count / PEAK_BF16_FLOPS], nbytes(*args[:3], *ops, *cot, *acts, *grads)
                 / PEAK_BYTES_PER_S)


def k2_form_bound(args, cot, acts, grads, form):
    """K2 reading the stash in ``form``: K2 reading the bf16 stash of every
    layer's operations (``k2_stash_bound``) and, for a partial stash, the
    forward's products of the trunk layers it does not keep and of rgb_0
    and rgb_1 (recomputed from x7), vs the inputs, cotangents and stash (int8
    codes and scales as they are) read once and the gradients written once.
    The int8 stash's dequantization (one f32 product a value) is not
    counted."""
    from gazenerf_tpu_torch.kernels import fused_field as ff

    embed, ops = args[0], args[6]
    B, R, S, De = embed.shape
    H, H2, C = ops.w0e.shape[0], ops.wr2.shape[0], ops.wr2.shape[1]
    P = B * R * S
    macs = 2 * P * field_macs(De, H) + P * (H + H2)
    if form.every > 1:
        kept = {t for t, _ in ff.stash_layout(H, form)}
        layer_macs = [De * H] + [H * H] * 4 + [(De + H) * H] + [H * H] * 2
        macs += P * (sum(m for i, m in enumerate(layer_macs) if f"x{i}" not in kept)
                     + H * H + H * H2)
    ops_count = 2 * (macs + 2 * B * R * H2 * C)
    return bound([ops_count / PEAK_BF16_FLOPS], nbytes(*args[:3], *ops, *cot, *acts, *grads)
                 / PEAK_BYTES_PER_S)


def bound(t_ops, t_bytes):
    """(ms, what bounds it) from the least times of the operations (seconds,
    per type: the types' units run side by side) and of the bytes."""
    t_max = max(t_ops)
    return max(t_max, t_bytes) * 1e3, ("operations" if t_max >= t_bytes else "bytes")


def stencil_bound(inp, out):
    """The blur-shuffle stencil or its adjoint: nine f32 multiply-adds per
    output element on the CUDA cores vs the input read and the output
    written once."""
    return bound([18 * out.numel() / PEAK_F32_FLOPS], nbytes(inp, out) / PEAK_BYTES_PER_S)


def k7_bound(args, y):
    """The fused block forward: the chain's bf16 products (x W1, h1 W2g and
    the four z_k W3 per pixel) on the tensor cores and the f32 stencil, vs x,
    the f32 weights and the output."""
    x, W3 = args[0], args[5]
    B, H, W, F = x.shape
    F3 = W3.shape[1]
    P = B * H * W
    macs = P * (2 * F * F + 8 * F * F + 4 * F * F3)
    return bound([2 * macs / PEAK_BF16_FLOPS, 18 * y.numel() / PEAK_F32_FLOPS],
                 nbytes(*args, y) / PEAK_BYTES_PER_S)


def k8_bound(args, dy, grads):
    """The fused block backward: on the tensor cores in bf16 the recompute of
    h1 and z, the three weight gradients, dh1 and dx; in f32 on the CUDA
    cores the product dz3 W3^T of f32 operands and the stencil's adjoint; vs
    x, dy and the weights in, dx and the weight gradients out."""
    x, W3 = args[0], args[5]
    B, H, W, F = x.shape
    F3 = W3.shape[1]
    P = B * H * W
    bf16_macs = P * (30 * F * F + 4 * F * F3)
    f32_flops = 2 * P * 4 * F * F3 + 18 * P * 4 * F3
    return bound([2 * bf16_macs / PEAK_BF16_FLOPS, f32_flops / PEAK_F32_FLOPS],
                 nbytes(*args, dy, *grads) / PEAK_BYTES_PER_S)


def k7_f32_bound(args, y):
    """K7 at f32: the chain's products and the stencil in f32 on the CUDA
    cores, vs x, the weights and the output."""
    x, W3 = args[0], args[5]
    B, H, W, F = x.shape
    P, F3 = B * H * W, W3.shape[1]
    macs = P * (2 * F * F + 8 * F * F + 4 * F * F3)
    return bound([(2 * macs + 18 * y.numel()) / PEAK_F32_FLOPS],
                 nbytes(*args, y) / PEAK_BYTES_PER_S)


def k8_f32_bound(args, dy, grads):
    """K8 at f32: in f32 on the CUDA cores the recompute of h1 and z, the
    data gradients (dz3 W3^T, dzp W2g^T, dh1p W1^T) and the three weight
    gradients, each the forward's product's multiply-adds, and the
    stencil's adjoint; vs x, dy and the weights in, dx and the weight
    gradients out."""
    x, W3 = args[0], args[5]
    B, H, W, F = x.shape
    P, F3 = B * H * W, W3.shape[1]
    macs = P * 3 * (2 * F * F + 8 * F * F + 4 * F * F3) - P * 4 * F * F3  # no z3 recompute
    return bound([(2 * macs + 18 * P * 4 * F3) / PEAK_F32_FLOPS],
                 nbytes(*args, dy, *grads) / PEAK_BYTES_PER_S)


def points_bounds(args, De, outs, acts, cot=None, grads=None, stash_read=False):
    """K1 (``cot`` None) or K2 given the points: K1's, K2's or K2 reading
    the stash's operations at the encoded width ``De`` (the encoding's
    sines and cosines, 60 a point, not counted), vs the points (12 bytes a
    point in place of the embedding's 126) and the other inputs read once,
    the outputs (the points' cotangent, 12 bytes a point) written once."""
    ops = args[6]
    B, R, S, _ = args[0].shape
    H, H2, C = ops.w0e.shape[0], ops.wr2.shape[0], ops.wr2.shape[1]
    P = B * R * S
    if cot is None:
        n = 2 * (P * field_macs(De, H) + B * R * H2 * C)
        moved = nbytes(*args[:6], *ops, *outs, *acts)
    elif stash_read:
        n = 2 * (2 * P * field_macs(De, H) + P * (H + H2) + 2 * B * R * H2 * C)
        moved = nbytes(*args[:3], *ops, *cot, *acts, *grads)
    else:
        n = 2 * (3 * P * field_macs(De, H) + 2 * B * R * H2 * C)
        moved = nbytes(*args[:6], *ops, *cot, *grads)
    return bound([n / PEAK_BF16_FLOPS], moved / PEAK_BYTES_PER_S)


def kernel_entry(name, source, replaces, err, ms, plain_ms, bound_ms, bound_by):
    """A kernel's entry of the ``kernels`` line, printed on a line of its own;
    its launches are filled in from the main path's run.  No single PyTorch
    call computes any of the port's kernels' functions, so none has a
    library time."""
    print(f"{name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{100 * bound_ms / ms:.1f}% of bound")
    return {"name": name, "route": "cuda", "source": f"gazenerf_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def mode_record(name, mode, err, ms, plain_ms, bound_ms, bound_by):
    """A kernel mode's entry, joined to its kernel's entry of the ``kernels``
    line, printed on a line of its own; its launches are filled in from the
    main path's run."""
    print(f"{name} ({mode}): {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}), {100 * bound_ms / ms:.1f}% of bound")
    return {"mode": mode, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_points_kernels(seed, iters):
    """The sample points encoded in the field kernels (``embed_in_kernel``).
    In the cases of ``checks.POINTS_CASES`` (narrow, the training shape, the
    deep march's S = 256): K1 given the points against its plain version
    and against K1 given the plain encoding, computed on the card in f32
    and rounded to bf16 (to the bit: the tiles compute the same f32 values
    with the same ``sinf`` / ``cosf``), with the count of entries where that
    encoding and the same encoding on the CPU round to other bf16 values;
    K2 given them against its plain version and against K2 given that
    embedding (every output but the points' cotangent to the bit); in the
    narrow and training cases K1 writing the stash and K2 reading it with
    ``dens_vpu``; at the training shape K2 against the unrounded float64
    gradient (the points' cotangent included).  Then K1, K2 recomputing and
    K2 reading the stash timed at the training shape.  Returns their
    entries of the ``kernels`` line."""
    import torch

    from gazenerf_tpu_torch.kernels import checks
    from gazenerf_tpu_torch.kernels import fused_field as ff
    from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb

    dev = torch.device("cuda")
    nf, fails, err = checks.N_FREQS, [], {}
    for case in checks.POINTS_CASES:
        args, cot = checks.points_case(*checks.POINTS_CASES[case], dev, seed=seed)
        chunks = checks.deep_chunks(args)
        line = {"points_case": case, "seed": seed}
        with torch.no_grad():
            out = ff.fused_field_forward(*args, n_freqs=nf)
            torch.cuda.synchronize()
            want = ff.fused_field_reference(*args, n_freqs=nf)
            line["k1_readings"], f = checks.points_k1_failures(case, out, want)
            err[case, "k1"] = max(float((a - b).abs().max()) for a, b in zip(out, want))
            plain = ff.encoded(args[0], nf).to(torch.bfloat16)
            line["encoding_flips_card_vs_cpu"] = checks.encoding_flips(
                plain.cpu(), ff.encoded(args[0].cpu(), nf).to(torch.bfloat16))
            line["encoding_entries"] = plain.numel()
            via_plain = ff.fused_field_forward(plain, *args[1:])
            differ = [int((a != b).sum()) for a, b in zip(out, via_plain)]
            line["k1_vs_plain_encoding_entries_differing"] = differ
            if any(differ):
                f.append(f"K1 differs from K1 given the plain encoding in {differ} entries")
            del want, via_plain
            got = ffb.fused_field_backward(*args, *cot, n_freqs=nf)
            again = ffb.fused_field_backward(*args, *cot, n_freqs=nf)
            torch.cuda.synchronize()
            want = ffb.fused_field_backward_reference(*args, *cot, n_freqs=nf, chunks=chunks)
            line["k2_readings"], f2 = checks.points_k2_failures(case, got, want)
            err[case, "k2"] = max(float((a - b).abs().max()) for a, b in zip(got, want))
            f += f2
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                f.append("K2: two launches on the same inputs differ")
            on_plain = ffb.fused_field_backward(plain, *args[1:], *cot)
            differ = [n for n, a, b in zip(got._fields[1:], got[1:], on_plain[1:])
                      if not torch.equal(a, b)]
            if differ:
                f.append(f"K2 differs from K2 given the plain encoding in {differ}")
            del want, again, on_plain, plain
            if case in checks.POINTS_STASH_CASES:
                _, acts = ff.fused_field_forward(*args, stash=True, n_freqs=nf)
                sg = ffb.fused_field_backward(*args, *cot, stash=acts, dens_vpu=True, n_freqs=nf)
                sw = ffb.fused_field_backward_reference(*args, *cot, stash=acts, dens_vpu=True,
                                                        n_freqs=nf, chunks=chunks)
                line["k2_stash_readings"], f2 = checks.points_k2_failures(f"{case}_stash", sg, sw)
                err[case, "k2_stash"] = max(float((a - b).abs().max()) for a, b in zip(sg, sw))
                f += f2
                del sw
        if case == "training":
            with torch.no_grad():
                want = ffb.fused_field_backward_reference(*args, *cot, n_freqs=nf)
                want64 = ffb.fused_field_backward_reference(*args, *cot, n_freqs=nf,
                                                            dtype=torch.float64)
            exact = ffb.fused_field_backward_unrounded(*args, *cot, n_freqs=nf)
            line["k2_unrounded_distance"], ft = checks.truth_failures(
                got, want, want64, exact, checks.K2_TRUTH_RATIO, checks.K2_TRUTH_EXEMPT)
            f += ft
            del want, want64, exact
            train_args, train_cot, train = args, cot, (out, got, acts, sg)
        print(json.dumps(line))
        fails += [f"points {case}: {x}" for x in f]
        del got
        torch.cuda.empty_cache()
    check(not fails, "\n".join(fails))

    args, cot = train_args, train_cot
    out, got, acts, sg = train
    De = ff.points_width(nf)
    k2_iters = max(4, iters // 4)
    with torch.no_grad():
        ms = {
            "k1": cuda_ms(lambda: ff.fused_field_forward(*args, n_freqs=nf), iters),
            "k2": cuda_ms(lambda: ffb.fused_field_backward(*args, *cot, n_freqs=nf), k2_iters),
            "k2_stash": cuda_ms(lambda: ffb.fused_field_backward(
                *args, *cot, stash=acts, dens_vpu=True, n_freqs=nf), k2_iters),
        }
        plain_iters = max(2, k2_iters // 4)
        plain = {
            "k1": cuda_ms(lambda: ff.fused_field_reference(*args, n_freqs=nf), plain_iters,
                          warmup=1),
            "k2": cuda_ms(lambda: ffb.fused_field_backward_reference(*args, *cot, n_freqs=nf),
                          plain_iters, warmup=1),
            "k2_stash": cuda_ms(lambda: ffb.fused_field_backward_reference(
                *args, *cot, stash=acts, dens_vpu=True, n_freqs=nf), plain_iters, warmup=1),
        }
        print(json.dumps({"k2_points_profile": device_profile(
            lambda: ffb.fused_field_backward(*args, *cot, n_freqs=nf), top=6)}))
    bnd = {"k1": points_bounds(args, De, out, ()),
           "k2": points_bounds(args, De, out, (), cot, got),
           "k2_stash": points_bounds(args, De, out, acts, cot, sg, stash_read=True)}
    shape = "training shape (B=2, 4096 rays x 64 samples, hidden 384)"
    modes = {"k1": f"points encoded in the tile, {shape}",
             "k2": f"points encoded in the tile, recomputing, {shape}",
             "k2_stash": f"points encoded in the tile, reading the stash with dens_vpu, {shape}"}
    errs = {"k1": err["training", "k1"], "k2": err["training", "k2"],
            "k2_stash": err["training", "k2_stash"]}
    names = {"k1": "fused_field_fwd"}
    return {k: mode_record(names.get(k, "fused_field_bwd"), modes[k], errs[k], ms[k], plain[k],
                           *bnd[k]) for k in ms}


def phase_renderer_kernels(seed, iters):
    """The renderer's kernels at the shapes of one B=2 bf16 renderer pass:
    K5 and K6 at the three stencil levels, to the bit against their plain
    versions; K7 and K8 at the three upsample blocks against their plain
    versions (``kernels/checks.py``), K8 also against the unrounded float64
    gradient and for equal bits over two launches.  Each kernel's ms, plain
    ms and bound are summed over the three levels: one renderer pass's
    worth.  No single PyTorch call computes any of the four functions (the
    stencil's reflect edge is no convolution's padding).  Then the same for
    K5 and K6 at the three levels unfolded (``renderer_fold_feat`` off: C =
    258, 129, 64), and for K7 and K8 at f32 (the f32 renderer) at the three
    blocks against their f32 plain versions, each output against the
    unrounded result at ``F32_TRUTH_RATIO`` of the plain version's distance
    (or under ``F32_TRUTH_FLOOR``), K8 for equal bits over two launches:
    their entries join the four as the modes ``unfolded`` and ``f32``."""
    import torch

    from gazenerf_tpu_torch.kernels import checks
    from gazenerf_tpu_torch.kernels import fused_upsampler as fu
    from gazenerf_tpu_torch.kernels import shuffle_blur as sb

    dev = torch.device("cuda")
    fails = []
    # per kernel: max abs err, ms, plain ms, bound ms, bound ms by what bounds it
    tot = {k: [0.0, 0.0, 0.0, 0.0, {"bytes": 0.0, "operations": 0.0}]
           for k in ("k5", "k6", "k7", "k8", "k5u", "k6u", "k7f", "k8f")}

    def timed(key, err, fn, plain, bnd, graph=False):
        t = tot[key]
        t[0] = max(t[0], err)
        t[1] += cuda_ms(fn, iters, graph=graph)
        t[2] += cuda_ms(plain, max(2, iters // 4), warmup=1)
        t[3] += bnd[0]
        t[4][bnd[1]] += bnd[0]

    for level in ("level0", "level1", "level2", "unfolded0", "unfolded1", "unfolded2"):
        k5, k6 = ("k5u", "k6u") if level.startswith("unfolded") else ("k5", "k6")
        x, dy = checks.stencil_case(checks.STENCIL_CASES[level], dev, seed=seed)
        y, dx = sb.shuffle_blur_forward(x), sb.shuffle_blur_backward(dy)
        torch.cuda.synchronize()
        errs = []
        for key, got, want in (("K5", y, sb.shuffle_blur_reference(x)),
                               ("K6", dx, sb.shuffle_blur_backward_reference(dy))):
            errs.append(float((got.float() - want.float()).abs().max()))
            print(f"{key} {level} {tuple(got.shape)}: max abs err {errs[-1]:.3e} "
                  f"(limit {checks.STENCIL_MAX_ABS_ERR})")
            if not (got.dtype == want.dtype and errs[-1] <= checks.STENCIL_MAX_ABS_ERR):
                fails.append(f"{key} {level}: max abs err {errs[-1]:.3e}, dtype {got.dtype}")
        # K5 and K6 take less time on the card than their wrappers on the
        # host: timed from a CUDA graph of their launches
        timed(k5, errs[0], lambda: sb.shuffle_blur_forward(x),
              lambda: sb.shuffle_blur_reference(x), stencil_bound(x, y), graph=True)
        timed(k6, errs[1], lambda: sb.shuffle_blur_backward(dy),
              lambda: sb.shuffle_blur_backward_reference(dy), stencil_bound(dy, dx), graph=True)

    k8_profile = {}
    for block in ("block0", "block1", "block2"):
        args, dy = checks.block_case(checks.BLOCK_CASES[block], dev, seed=seed)
        y = fu.fused_upsample_forward(*args)
        torch.cuda.synchronize()
        y_ref = fu.fused_upsample_reference(*args)
        r7, f7 = checks.k7_failures(block, y, y_ref)
        got = fu.fused_upsample_backward(*args, dy)
        again = fu.fused_upsample_backward(*args, dy)
        torch.cuda.synchronize()
        want = fu.fused_upsample_backward_reference(*args, dy)
        r8, f8 = checks.k8_failures(block, got, want)
        want64 = fu.fused_upsample_backward_reference(*(a.double() for a in args), dy.double())
        exact = fu.fused_upsample_backward_unrounded(*args, dy)
        dist, ft = checks.truth_failures(got, want, want64, exact, checks.K8_TRUTH_RATIO,
                                         floor=checks.K8_TRUTH_FLOOR)
        del want64, exact
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            f8.append("two launches on the same inputs differ")
        print(json.dumps({"block_case": block, "seed": seed, "k7_reading": r7, "k8_readings": r8,
                          "k8_unrounded_distance": dist}))
        fails += [f"K7 {block}: {f}" for f in f7] + [f"K8 {block}: {f}" for f in f8 + ft]
        timed("k7", float((y.float() - y_ref.float()).abs().max()),
              lambda: fu.fused_upsample_forward(*args), lambda: fu.fused_upsample_reference(*args),
              k7_bound(args, y))
        timed("k8", float(max((a.float() - b.float()).abs().max() for a, b in zip(got, want))),
              lambda: fu.fused_upsample_backward(*args, dy),
              lambda: fu.fused_upsample_backward_reference(*args, dy), k8_bound(args, dy, got))
        # K8's device time by CUDA kernel: dz3, the tile kernel, the dW GEMM
        # and its partials' sum, the bias sums
        k8_profile[block] = device_profile(lambda: fu.fused_upsample_backward(*args, dy), top=6)
    print(json.dumps({"k8_profile": k8_profile}))

    f32_profile = {}
    for block in ("block0", "block1", "block2"):
        args, dy = checks.f32_block_case(checks.BLOCK_CASES[block], dev, seed=seed)
        y = fu.fused_upsample_forward(*args, use_bf16=False)
        got = fu.fused_upsample_backward(*args, dy, use_bf16=False)
        again = fu.fused_upsample_backward(*args, dy, use_bf16=False)
        torch.cuda.synchronize()
        y_ref = fu.fused_upsample_reference(*args, use_bf16=False)
        want = fu.fused_upsample_backward_reference(*args, dy, use_bf16=False)
        r7, f7 = checks.f32_k7_failures(block, y, y_ref)
        r8, f8 = checks.f32_k8_failures(block, got, want)
        y64 = fu.fused_upsample_reference(*(a.double() for a in args), use_bf16=False)
        t7, ft7 = checks.f32_truth_failures(checks.Image(y), checks.Image(y_ref), checks.Image(y64))
        exact = fu.fused_upsample_backward_unrounded(*args, dy)
        t8, ft8 = checks.f32_truth_failures(got, want, exact)
        del y64, exact
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            f8.append("two launches on the same inputs differ")
        print(json.dumps({"f32_block_case": block, "seed": seed, "k7_readings": r7,
                          "k8_readings": r8, "k7_unrounded_distance": t7,
                          "k8_unrounded_distance": t8}))
        fails += [f"K7 f32 {block}: {f}" for f in f7 + ft7]
        fails += [f"K8 f32 {block}: {f}" for f in f8 + ft8]
        timed("k7f", float((y - y_ref).abs().max()),
              lambda: fu.fused_upsample_forward(*args, use_bf16=False),
              lambda: fu.fused_upsample_reference(*args, use_bf16=False), k7_f32_bound(args, y))
        timed("k8f", float(max((a - b).abs().max() for a, b in zip(got, want))),
              lambda: fu.fused_upsample_backward(*args, dy, use_bf16=False),
              lambda: fu.fused_upsample_backward_reference(*args, dy, use_bf16=False),
              k8_f32_bound(args, dy, got))
        # device time by CUDA kernel: K7's three products and stencil; K8's
        # stencil adjoint, five products, three contractions and their sums
        f32_profile[block] = {
            "k7": device_profile(lambda: fu.fused_upsample_forward(*args, use_bf16=False), top=4),
            "k8": device_profile(lambda: fu.fused_upsample_backward(*args, dy, use_bf16=False),
                                 top=10)}
    print(json.dumps({"f32_block_profile": f32_profile}))
    check(not fails, "\n".join(fails))

    def entry(key, name, source, replaces):
        err, ms, plain_ms, bnd, by = tot[key]
        return kernel_entry(name, source, replaces, err, ms, plain_ms, bnd, max(by, key=by.get))

    def mode_entry(key, name, mode, source=None):
        err, ms, plain_ms, bnd, by = tot[key]
        out = mode_record(name, mode, err, ms, plain_ms, bnd, max(by, key=by.get))
        if source:
            out["source"] = f"gazenerf_tpu_torch/csrc/{source}"
        return out

    k5, k6, k7, k8 = (
        entry("k5", "shuffle_blur_fwd", "shuffle_blur.cu", "gazenerf_tpu/kernels/shuffle_blur.py:55"),
        entry("k6", "shuffle_blur_bwd", "shuffle_blur.cu", "gazenerf_tpu/kernels/shuffle_blur.py:145"),
        entry("k7", "fused_upsampler_fwd", "fused_upsampler_fwd.cu",
              "gazenerf_tpu/kernels/fused_upsampler.py:60"),
        entry("k8", "fused_upsampler_bwd", "fused_upsampler_bwd.cu",
              "gazenerf_tpu/kernels/fused_upsampler.py:179"),
    )
    unfolded = "the three levels unfolded (C = 258, 129, 64), bf16, B=2, one renderer pass"
    k5["unfolded"] = mode_entry("k5u", "shuffle_blur_fwd", unfolded)
    k6["unfolded"] = mode_entry("k6u", "shuffle_blur_bwd", unfolded)
    f32 = "f32 (use_bf16=False, the f32 renderer), the three blocks, B=2, one renderer pass"
    k7["f32"] = mode_entry("k7f", "fused_upsampler_fwd", f32, "fused_upsampler_f32.cu")
    k8["f32"] = mode_entry("k8f", "fused_upsampler_bwd", f32, "fused_upsampler_f32.cu")
    return [k5, k6, k7, k8]


def seeded_field(seed, cfg, dev):
    """A field at the config's widths, seeded weights, every bias random."""
    import torch

    from gazenerf_tpu_torch.models.mlp_nerf import NeRFFieldMLP

    gen = torch.Generator().manual_seed(seed)
    field = NeRFFieldMLP(
        cfg.vp_embed_dims, cfg.shape_ext_code_dims, cfg.vd_channels,
        hidden=cfg.mlp_hidden, res_nfeat=cfg.featmap_nc,
    )
    field.reset_parameters(gen)
    random_biases_(field, gen)
    return field.to(dev), gen


def render_inputs(cfg, dev, gen):
    """A render's own field inputs at B=1: the rays of the frontal camera
    (bf16 embedding, z values, segment lengths) and seeded codes."""
    import torch

    from gazenerf_tpu_torch.ops.embedding import positional_encoding
    from gazenerf_tpu_torch.ops.rays import pixel_grid, sample_coarse
    from gazenerf_tpu_torch.viewer.server import lookat_camera

    R_, T_, K_ = (torch.from_numpy(a).to(dev) for a in lookat_camera(0, 0, 12.0, cfg.featmap_size))
    xy = pixel_grid(cfg.featmap_size, device=dev)[None]
    samples = sample_coarse(xy, R_, T_.reshape(1, 3), K_, cfg.num_sample_coarse,
                            cfg.world_z1, cfg.world_z2)
    embed = positional_encoding(samples.pts, cfg.vp_n_freqs).to(torch.bfloat16).contiguous()
    sc = (0.1 * torch.randn(1, cfg.shape_ext_code_dims, generator=gen)).to(dev)
    ac = (0.1 * torch.randn(1, cfg.appea_code_dims, generator=gen)).to(dev)
    return embed, samples.zvals.contiguous(), samples.z_dists.contiguous(), sc, ac


def hold_outputs(tag, got, want):
    """A fused forward's four outputs at the serving shape against its plain
    version's, each within the serving case's limits (``checks.K1_LIMITS``);
    returns the largest max abs error."""
    from gazenerf_tpu_torch.kernels import checks

    readings, fails = checks.k1_failures("serving", got, want)
    print(json.dumps({"forward_serving": tag, "readings": readings}))
    check(not fails, f"{tag}: " + "; ".join(fails))
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def phase_kernels(seed, cfg, iters):
    """K1 against its plain version at the render's shapes, then timed."""
    import torch

    from gazenerf_tpu_torch.kernels import fused_field as ff

    dev = torch.device("cuda")
    field, gen = seeded_field(seed, cfg, dev)
    embed, zvals, zdists, sc, ac = render_inputs(cfg, dev, gen)
    with torch.no_grad():
        p = ff.split_params(field.flat(), cfg.vp_embed_dims)
        cb0, cb5, cbr1 = ff.conditioning_rows(p, sc, ac)
        ops = ff.prepare_operands(p)
        args = (embed, zvals, zdists, cb0, cb5, cbr1, ops)
        out_k = ff.fused_field_forward(*args)
        torch.cuda.synchronize()
        max_err = hold_outputs("K1", out_k, ff.fused_field_reference(*args))
        ms = cuda_ms(lambda: ff.fused_field_forward(*args), iters)
        plain_ms = cuda_ms(lambda: ff.fused_field_reference(*args), max(2, iters // 4), warmup=1)
    B, R, S, De = embed.shape
    bound_ms, bound_by = k1_bound(B, R, S, De, cfg.mlp_hidden, cfg.featmap_nc, ops)
    # the training step's shape: B=2, a field at the same widths
    from gazenerf_tpu_torch.kernels import checks

    args2, _ = checks.field_case(*checks.K2_CASES["training"], dev, seed=seed)
    with torch.no_grad():
        ms2 = cuda_ms(lambda: ff.fused_field_forward(*args2), iters)
    B2, R2, S2, _ = args2[0].shape
    bnd2 = k1_bound(B2, R2, S2, De, cfg.mlp_hidden, cfg.featmap_nc, args2[6])
    print(f"K1 training shape {tuple(args2[0].shape)}: {ms2:.4f} ms, bound {bnd2[0]:.4f} ms "
          f"({bnd2[1]}); serving shape {tuple(embed.shape)}: {ms:.4f} ms, bound {bound_ms:.4f}")
    del args2
    return kernel_entry("fused_field_fwd", "fused_field_fwd.cu",
                        "gazenerf_tpu/kernels/fused_field.py:216", max_err, ms, plain_ms,
                        bound_ms, bound_by)


def phase_stash_kernels(seed, iters):
    """The single-branch stash.  K1 writing it at the training shape (B=2,
    4096 rays x 64 samples, hidden 384) against its plain version, the
    outputs and the ten stash tensors, and its outputs against K1 without
    the stash (the same bits).  K2 reading K1's stash, with and without
    ``dens_vpu``, in the narrow case (hidden 64) and at the training shape:
    against its plain version reading the same stash, against the unrounded
    float64 gradient, for equal bits over two launches, and against K2
    recomputing on the same inputs (every output to the bit; with
    ``dens_vpu`` all but dWd).  Limits in ``kernels/checks.py``.  K1 with
    the stash and K2 reading it with ``dens_vpu`` (what the training CLI
    runs at S <= 64) and without it (what ``pallas_split_dw`` runs) timed
    at the training shape beside K3's and K4's bounds for one branch.
    Returns the readings that join K1's and K2's entries of the
    ``kernels`` line."""
    import torch

    from gazenerf_tpu_torch.kernels import checks
    from gazenerf_tpu_torch.kernels import fused_field as ff
    from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb

    dev = torch.device("cuda")
    fails = []
    k2_err, k2_grads = {}, {}
    for case in checks.K2_STASH_CASES:
        args, cot = checks.field_case(*checks.K2_CASES[case], dev, seed=seed)
        with torch.no_grad():
            out, acts = ff.fused_field_forward(*args, stash=True)
            torch.cuda.synchronize()
            line = {"stash_case": case, "seed": seed}
            if case == "training":
                plain_out, plain_acts = ff.fused_field_reference(*args, stash=True)
                line["k1_readings"], f1 = checks.k1_failures("training", out, plain_out)
                line["k1_stash_readings"], f1s = checks.k1_stash_failures(acts, plain_acts)
                k1_err = max(float((a - b).abs().max()) for a, b in zip(out, plain_out))
                del plain_out, plain_acts
                no_stash = ff.fused_field_forward(*args)
                err = max(float((a - b).abs().max()) for a, b in zip(out, no_stash))
                line["k1_vs_no_stash_max_abs_err"] = err
                if err > checks.K1_STASH_VS_K1_MAX_ABS_ERR:
                    f1.append(f"outputs vs K1 without the stash: max abs err {err:.3e}")
                fails += [f"K1 stash: {f}" for f in f1 + f1s]
            recompute = ffb.fused_field_backward(*args, *cot)
        for dens_vpu in (False, True):
            tag = "dens_vpu" if dens_vpu else "rounded"
            with torch.no_grad():
                got = ffb.fused_field_backward(*args, *cot, stash=acts, dens_vpu=dens_vpu)
                again = ffb.fused_field_backward(*args, *cot, stash=acts, dens_vpu=dens_vpu)
                torch.cuda.synchronize()
                want = ffb.fused_field_backward_reference(*args, *cot, stash=acts,
                                                          dens_vpu=dens_vpu)
                want64 = ffb.fused_field_backward_reference(
                    *args, *cot, stash=acts, dens_vpu=dens_vpu, dtype=torch.float64)
            exact = ffb.fused_field_backward_unrounded(*args, *cot)
            r, f = checks.k2_stash_failures(case, got, want)
            dist, ft = checks.truth_failures(got, want, want64, exact,
                                             checks.K2_STASH_TRUTH_RATIO,
                                             checks.K2_STASH_TRUTH_EXEMPT)
            f += ft
            del want64, exact
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                f.append("two launches on the same inputs differ")
            vs = {n: float((a - b).abs().max()) for n, a, b in
                  zip(got._fields, got, recompute) if not (dens_vpu and n == "dWd")}
            differ = {n: e for n, e in vs.items() if e > checks.K2_STASH_VS_RECOMPUTE_MAX_ABS_ERR}
            if differ:
                f.append(f"vs K2 recomputing: {differ}")
            line[tag] = {"readings": r, "unrounded_distance": dist,
                         "vs_recompute_max_abs_err": max(vs.values())}
            fails += [f"K2 stash {tag} {case}: {x}" for x in f]
            if case == "training":
                k2_err[dens_vpu] = float(max((a - b).abs().max() for a, b in zip(got, want)))
                k2_grads[dens_vpu] = got
            del got, again, want
        print(json.dumps(line))
    check(not fails, "\n".join(fails))
    with torch.no_grad():
        k1_ms = cuda_ms(lambda: ff.fused_field_forward(*args, stash=True), iters)
        k1_plain_ms = cuda_ms(lambda: ff.fused_field_reference(*args, stash=True),
                              max(2, iters // 4), warmup=1)
        k2_iters = max(4, iters // 4)
        k2_ms, k2_plain_ms = {}, {}
        for dens_vpu in (True, False):
            k2_ms[dens_vpu] = cuda_ms(lambda: ffb.fused_field_backward(
                *args, *cot, stash=acts, dens_vpu=dens_vpu), k2_iters)
            k2_plain_ms[dens_vpu] = cuda_ms(lambda: ffb.fused_field_backward_reference(
                *args, *cot, stash=acts, dens_vpu=dens_vpu), max(2, k2_iters // 4), warmup=1)
        print(json.dumps({"k2_stash_profile": device_profile(
            lambda: ffb.fused_field_backward(*args, *cot, stash=acts, dens_vpu=True), top=6)}))
    k1_bnd = k1_stash_bound(args, out, acts)
    k2_bnd = {d: k2_stash_bound(args, cot, acts, g) for d, g in k2_grads.items()}
    print(f"K1 with the stash, training shape: {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, "
          f"bound {k1_bnd[0]:.4f} ms ({k1_bnd[1]})")
    for dens_vpu, tag in ((True, "with dens_vpu"), (False, "without dens_vpu (split_dw)")):
        print(f"K2 reading it {tag}: {k2_ms[dens_vpu]:.4f} ms, plain "
              f"{k2_plain_ms[dens_vpu]:.4f} ms, bound {k2_bnd[dens_vpu][0]:.4f} ms "
              f"({k2_bnd[dens_vpu][1]})")

    def k2_entry(dens_vpu, mode):
        return {"mode": mode, "max_abs_err": k2_err[dens_vpu], "ms": k2_ms[dens_vpu],
                "plain_ms": k2_plain_ms[dens_vpu], "bound_ms": k2_bnd[dens_vpu][0],
                "bound_by": k2_bnd[dens_vpu][1]}

    return (
        {"mode": "stash write, training shape", "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bnd[0], "bound_by": k1_bnd[1]},
        k2_entry(True, "stash read with dens_vpu, training shape"),
        k2_entry(False, "stash read without dens_vpu (what pallas_split_dw runs), training "
                        "shape"),
    )


def phase_dual_kernels(seed, cfg, iters):
    """The dual-branch kernels.  K3 at the serving shape (B=1, a render's
    own inputs, no stash) against its plain version and against K1 on each
    branch (the same bits), then at the training shape (B=2, 4096 rays x 64
    samples, with the stash) against its plain version, outputs and stash.
    K4 on K3's stash in the narrow case (hidden 64) and at the training
    shape: against its plain version, against K2 on each branch with the
    shared cotangents summed, for equal bits over two launches and, at the
    training shape, against the unrounded float64 gradient.  Limits in
    ``kernels/checks.py``.  K3 (with the stash) and K4 timed at the training
    shape beside their bounds; K3 at the serving shape printed."""
    import torch

    from gazenerf_tpu_torch.kernels import checks
    from gazenerf_tpu_torch.kernels import fused_field as ff
    from gazenerf_tpu_torch.kernels import fused_field2 as ff2
    from gazenerf_tpu_torch.kernels import fused_field2_bwd as ffb2
    from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb

    dev = torch.device("cuda")
    fails = []

    def per_branch_k2(args, cot):
        return ffb2.sum_branches([
            ffb.fused_field_backward(*args[:3], *(t[i] for t in args[3:6]),
                                     ff2.branch_operands(args[6], i), *cot[i])
            for i in range(ff2.N_BRANCHES)])

    # K3 at the serving shape: two seeded fields on a render's inputs
    fields = [seeded_field(seed + i, cfg, dev)[0] for i in range(ff2.N_BRANCHES)]
    embed, zvals, zdists, sc, ac = render_inputs(cfg, dev, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        ps = [ff.split_params(f.flat(), cfg.vp_embed_dims) for f in fields]
        rows = ff2.conditioning_rows(ps, sc, ac)
        ops = ff2.stack_operands([ff.prepare_operands(p) for p in ps])
        args = (embed, zvals, zdists, *rows, ops)
        got = ff2.fused_dual_forward(*args)
        torch.cuda.synchronize()
        for br, g, w in zip(("face", "eyes"), got, ff2.fused_dual_reference(*args)):
            hold_outputs(f"K3 serving {br}", g, w)
        for i, g in enumerate(got):
            single = ff.fused_field_forward(*args[:3], *(t[i] for t in rows),
                                            ff2.branch_operands(args[6], i))
            err = max(float((a - b).abs().max()) for a, b in zip(g, single))
            print(f"K3 serving branch {i} vs K1: max abs err {err:.3e} "
                  f"(limit {checks.K3_VS_K1_MAX_ABS_ERR})")
            if err > checks.K3_VS_K1_MAX_ABS_ERR:
                fails.append(f"K3 branch {i} vs K1: max abs err {err:.3e}")
        ms = cuda_ms(lambda: ff2.fused_dual_forward(*args), iters)
        bnd = k3_bound(args, got, ())
        print(f"K3 serving shape {tuple(embed.shape)}, no stash: {ms:.4f} ms, bound {bnd[0]:.4f} "
              f"ms ({bnd[1]})")

    # K3 at the training shape, with the stash
    args, cot = checks.dual_case(*checks.DUAL_CASES["training"], dev, seed=seed)
    with torch.no_grad():
        got, acts = ff2.fused_dual_forward(*args, stash=True)
        torch.cuda.synchronize()
        want, want_acts = ff2.fused_dual_reference(*args, stash=True)
        r3, f3 = checks.k3_failures("training", got, want)
        r3s, f3s = checks.k3_stash_failures("training", acts, want_acts)
        fails += [f"K3 training: {f}" for f in f3 + f3s]
        print(json.dumps({"k3_case": "training", "seed": seed, "readings": r3, "stash": r3s}))
        k3_err = max(float((a - b).abs().max()) for g, w in zip(got, want) for a, b in zip(g, w))
        del want, want_acts
        k3_bnd = k3_bound(args, got, acts)
        k3_ms = cuda_ms(lambda: ff2.fused_dual_forward(*args, stash=True), iters)
        k3_plain_ms = cuda_ms(lambda: ff2.fused_dual_reference(*args, stash=True),
                              max(2, iters // 4), warmup=1)

    # K4 on K3's stash: the narrow case, then the training shape
    narrow_args, narrow_cot = checks.dual_case(*checks.DUAL_CASES["narrow"], dev, seed=seed)
    with torch.no_grad():
        _, narrow_acts = ff2.fused_dual_forward(*narrow_args, stash=True)
    for case, (a, c, st) in (("narrow", (narrow_args, narrow_cot, narrow_acts)),
                             ("training", (args, cot, acts))):
        with torch.no_grad():
            got = ffb2.fused_dual_backward(*a, *c, st)
            again = ffb2.fused_dual_backward(*a, *c, st)
            torch.cuda.synchronize()
            want = ffb2.fused_dual_backward_reference(*a, *c, st)
            r4, case_fails = checks.k4_failures(case, got, want)
            k2 = per_branch_k2(a, c)
            r42, f42 = checks.k4_vs_k2_failures(case, got, k2)
            case_fails += [f"vs K2: {f}" for f in f42]
            # one weight-gradient GEMM fed the same chunks: the same bits
            case_fails += [f"vs K2: {n} not equal to the bit"
                           for n, x, y in zip(ffb2.DualGrads._fields, got, k2)
                           if n not in ("dembed", "dzvals", "dzdists") and not torch.equal(x, y)]
            del k2
        line = {"k4_case": case, "seed": seed, "readings": r4, "vs_k2_readings": r42}
        if case == "training":
            with torch.no_grad():
                want64 = ffb2.fused_dual_backward_reference(*a, *c, st, dtype=torch.float64)
            exact = ffb2.fused_dual_backward_unrounded(*a, *c)
            line["unrounded_distance"], ft = checks.truth_failures(
                got, want, want64, exact, checks.K4_TRUTH_RATIO, checks.K4_TRUTH_EXEMPT)
            case_fails += ft
            del want64, exact
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            case_fails.append("two launches on the same inputs differ")
        print(json.dumps(line))
        fails += [f"K4 {case}: {f}" for f in case_fails]
    check(not fails, "\n".join(fails))
    k4_err = float(max((x - y).abs().max() for x, y in zip(got, want)))
    k4_bnd = k4_bound(args, cot, acts, got)
    del want, again, narrow_acts
    with torch.no_grad():
        k4_iters = max(4, iters // 4)
        k4_ms = cuda_ms(lambda: ffb2.fused_dual_backward(*args, *cot, acts), k4_iters)
        print(json.dumps({"k4_profile": device_profile(
            lambda: ffb2.fused_dual_backward(*args, *cot, acts), top=6)}))
        k4_plain_ms = cuda_ms(lambda: ffb2.fused_dual_backward_reference(*args, *cot, acts),
                              max(2, k4_iters // 4), warmup=1)
    return (
        kernel_entry("fused_dual_fwd", "fused_field2_fwd.cu",
                     "gazenerf_tpu/kernels/fused_field2.py:64", k3_err, k3_ms, k3_plain_ms,
                     *k3_bnd),
        kernel_entry("fused_dual_bwd", "fused_field2_bwd.cu",
                     "gazenerf_tpu/kernels/fused_field2_bwd.py:29", k4_err, k4_ms, k4_plain_ms,
                     *k4_bnd),
    )


# the deep march: B=2, 4096 rays x 256 samples, hidden 384 (the JAX bench's
# deep phase); its plain versions run in chunks of DEEP_CHUNK rays, the
# deep training step's ray_chunk, to fit the card's memory
DEEP_SHAPE = (384, 256, 4096)
DEEP_CHUNK = 512


def _ray_chunks(R, rays=DEEP_CHUNK):
    return [slice(r0, r0 + rays) for r0 in range(0, R, rays)]


def plain_forward_chunked(ref, args, dual=False):
    """The plain forward ``ref`` over the rays of ``args`` in chunks of
    ``DEEP_CHUNK`` (each ray's outputs are its own), joined along the rays."""
    import torch

    parts = [ref(*(t[:, sl] for t in args[:3]), *args[3:]) for sl in _ray_chunks(
        args[0].shape[1])]
    join = lambda outs: tuple(torch.cat(ts, 1) for ts in zip(*outs))  # noqa: E731
    return tuple(join(br) for br in zip(*parts)) if dual else join(parts)


def plain_backward_chunked(ref, args, cot, per_point, stash=None):
    """The plain backward ``ref`` in chunks of ``DEEP_CHUNK`` rays (the
    dual one given both branches' ``stash``): the per-point cotangents
    (``per_point``) joined along the rays, every other gradient summed over
    the chunks."""
    import torch

    parts = []
    for sl in _ray_chunks(args[0].shape[1]):
        a = (*(t[:, sl] for t in args[:3]), *args[3:])
        if stash is not None:
            g = [tuple(t[:, sl] for t in gb) for gb in cot]
            st = tuple(tuple(t[:, sl] for t in br) for br in stash)
            parts.append(ref(*a, *g, st))
        else:
            parts.append(ref(*a, *(t[:, sl] for t in cot)))
    return type(parts[0])(*(torch.cat(ts, 1) if n in per_point else sum(ts)
                            for n, ts in zip(parts[0]._fields, zip(*parts))))


def phase_deep_kernels(seed, iters):
    """Rays longer than one kernel tile.  In ``checks.DEEP_CASES`` (S = 128,
    192, 256 at hidden 384 and 256 rays, S = 192 at hidden 64): K1 and K2
    against their plain versions (K2's summing the weight gradients in the
    kernel's chunks), K2 against the unrounded float64 gradient at hidden
    384 (its density masks against the plain version's printed); at S = 128
    and 256 K1 writing the stash (its outputs K1's bits) and K2 reading it
    against its plain version (their density masks equal at every point)
    and K2 recomputing (the same bits); at S = 256 K3 against K1 per branch
    (the same bits) and its plain version, K4 against its plain version and
    K2 per branch (the weight gradients to the bit).  Then at the deep
    march's shape (``DEEP_SHAPE``, B=2) K1, K2 recomputing, K3 (without the
    stash: both branches' stash there is 30.6 GB) and K4 (on it) timed
    beside their bounds and their plain versions, which
    run in chunks of ``DEEP_CHUNK`` rays; their largest differences printed.
    Returns the four kernels' ``deep`` entries."""
    import torch

    from gazenerf_tpu_torch.kernels import checks
    from gazenerf_tpu_torch.kernels import fused_field as ff
    from gazenerf_tpu_torch.kernels import fused_field2 as ff2
    from gazenerf_tpu_torch.kernels import fused_field2_bwd as ffb2
    from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb

    dev = torch.device("cuda")
    fails = []
    for case, shape in checks.DEEP_CASES.items():
        args, cot = checks.field_case(*shape, dev, seed=seed)
        chunks = checks.deep_chunks(args)
        with torch.no_grad():
            out = ff.fused_field_forward(*args)
            r1, f = checks.limit_failures(checks.Outputs(*out),
                                          checks.Outputs(*ff.fused_field_reference(*args)),
                                          checks.DEEP_K1_LIMITS[case])
            fails += [f"K1 {case}: {x}" for x in f]
            got = ffb.fused_field_backward(*args, *cot)
            want = ffb.fused_field_backward_reference(*args, *cot, chunks=chunks)
            r2, f = checks.limit_failures(got, want, checks.DEEP_K2_LIMITS[case])
            fails += [f"K2 {case}: {x}" for x in f]
        line = {"deep_case": case, "seed": seed, "k1_readings": r1, "k2_readings": r2,
                "k2_density_mask_flips": checks.density_mask_flips(got, want)}
        if case in checks.DEEP_K2_TRUTH_CASES:
            with torch.no_grad():
                want64 = ffb.fused_field_backward_reference(*args, *cot, dtype=torch.float64,
                                                            chunks=chunks)
            exact = ffb.fused_field_backward_unrounded(*args, *cot)
            line["k2_unrounded_distance"], f = checks.truth_failures(
                got, want, want64, exact, checks.K2_TRUTH_RATIO, checks.K2_TRUTH_EXEMPT)
            fails += [f"K2 {case} truth: {x}" for x in f]
            del want64, exact
        if case in checks.DEEP_STASH_CASES:
            with torch.no_grad():
                out_s, acts = ff.fused_field_forward(*args, stash=True)
                if not all(torch.equal(a, b) for a, b in zip(out_s, out)):
                    fails.append(f"K1 {case}: the stash changed an output")
                _, want_acts = ff.fused_field_reference(*args, stash=True)
                line["k1_stash_readings"], f = checks.k1_stash_failures(acts, want_acts)
                fails += [f"K1 stash {case}: {x}" for x in f]
                for dens_vpu in (False, True):
                    gs = ffb.fused_field_backward(*args, *cot, stash=acts, dens_vpu=dens_vpu)
                    ws = ffb.fused_field_backward_reference(*args, *cot, stash=acts,
                                                            chunks=chunks, dens_vpu=dens_vpu)
                    tag = f"k2_stash_dens_vpu_{dens_vpu}"
                    line[tag], f = checks.limit_failures(gs, ws,
                                                         checks.DEEP_K2_STASH_LIMITS[case])
                    flips = checks.density_mask_flips(gs, ws)
                    line[f"{tag}_density_mask_flips"] = flips
                    if flips:
                        f.append(f"{flips} density masks differ from the plain version's")
                    differ = [n for n, a, b in zip(gs._fields, gs, got)
                              if not torch.equal(a, b) and not (dens_vpu and n == "dWd")]
                    if differ:
                        f.append(f"vs K2 recomputing: {differ} differ")
                    fails += [f"K2 stash {case} dens_vpu={dens_vpu}: {x}" for x in f]
                del acts, want_acts, gs, ws
        print(json.dumps(line))
        del args, cot, got, want
    # K3 and K4 at S = 256
    case = checks.DEEP_DUAL_CASE
    dargs, dcot = checks.dual_case(*checks.DEEP_CASES[case], dev, seed=seed)
    with torch.no_grad():
        outs, acts = ff2.fused_dual_forward(*dargs, stash=True)
        want_outs, want_acts = ff2.fused_dual_reference(*dargs, stash=True)
        per = []
        for i, g in enumerate(dcot):
            branch = (*dargs[:3], *(t[i] for t in dargs[3:6]), ff2.branch_operands(dargs[6], i))
            if not all(torch.equal(a, b) for a, b in zip(outs[i], ff.fused_field_forward(*branch))):
                fails.append(f"K3 {case} branch {i}: not K1's bits")
            per.append(ffb.fused_field_backward(*branch, *g, stash=acts[i]))
        r3, f = checks.deep_k3_failures(outs, want_outs)
        r3s, fs = checks.k3_stash_failures("training", acts, want_acts)
        fails += [f"K3 {case}: {x}" for x in f + fs]
        d = ffb2.fused_dual_backward(*dargs, *dcot, acts)
        r4, f = checks.limit_failures(d, ffb2.fused_dual_backward_reference(*dargs, *dcot, acts),
                                      checks.DEEP_K4_LIMITS)
        k2 = ffb2.sum_branches(per)
        r42, f42 = checks.k4_vs_k2_failures("training", d, k2)
        f += f42 + [f"vs K2: {n} not equal to the bit" for n, x, y in zip(d._fields, d, k2)
                    if n not in ("dembed", "dzvals", "dzdists") and not torch.equal(x, y)]
        fails += [f"K4 {case}: {x}" for x in f]
    print(json.dumps({"deep_dual_case": case, "seed": seed, "k3_readings": r3,
                      "k3_stash_readings": r3s, "k4_readings": r4, "k4_vs_k2_readings": r42}))
    del dargs, dcot, outs, acts, want_outs, want_acts, per, d, k2
    check(not fails, "\n".join(fails))
    torch.cuda.empty_cache()

    # the deep march's shape: times, bounds, plain versions in ray chunks
    per_point = ("dembed", "dzvals", "dzdists")
    H, S, R = DEEP_SHAPE
    args, cot = checks.field_case(H, S, R, dev, seed=seed)
    one = max(2, iters // 10)
    with torch.no_grad():
        out = ff.fused_field_forward(*args)
        plain = plain_forward_chunked(ff.fused_field_reference, args)
        k1_err = max(float((a - b).abs().max()) for a, b in zip(out, plain))
        k1_ms = cuda_ms(lambda: ff.fused_field_forward(*args), iters)
        k1_plain_ms = cuda_ms(lambda: plain_forward_chunked(ff.fused_field_reference, args), 1,
                              warmup=0)
        got = ffb.fused_field_backward(*args, *cot)
        plain = plain_backward_chunked(ffb.fused_field_backward_reference, args, cot, per_point)
        k2_err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
        k2_ms = cuda_ms(lambda: ffb.fused_field_backward(*args, *cot), one)
        k2_plain_ms = cuda_ms(lambda: plain_backward_chunked(
            ffb.fused_field_backward_reference, args, cot, per_point), 1, warmup=0)
        print(json.dumps({"k2_deep_profile": device_profile(
            lambda: ffb.fused_field_backward(*args, *cot), top=6)}))
    B, _, _, De = args[0].shape
    k1_bnd = k1_bound(B, R, S, De, H, 258, args[6])
    k2_bnd = k2_bound(args, cot, got)
    del args, cot, out, got, plain
    torch.cuda.empty_cache()
    dargs, dcot = checks.dual_case(H, S, R, dev, seed=seed)
    with torch.no_grad():
        outs = ff2.fused_dual_forward(*dargs)
        plain = plain_forward_chunked(ff2.fused_dual_reference, dargs, dual=True)
        k3_err = max(float((a - b).abs().max()) for o, w in zip(outs, plain) for a, b in zip(o, w))
        del plain
        k3_ms = cuda_ms(lambda: ff2.fused_dual_forward(*dargs), one)
        k3_plain_ms = cuda_ms(lambda: plain_forward_chunked(ff2.fused_dual_reference, dargs,
                                                            dual=True), 1, warmup=0)
        k3_bnd = k3_bound(dargs, outs, ())
        _, acts = ff2.fused_dual_forward(*dargs, stash=True)
        d = ffb2.fused_dual_backward(*dargs, *dcot, acts)
        plain = plain_backward_chunked(ffb2.fused_dual_backward_reference, dargs, dcot,
                                       per_point, stash=acts)
        k4_err = max(float((a - b).abs().max()) for a, b in zip(d, plain))
        del plain
        k4_ms = cuda_ms(lambda: ffb2.fused_dual_backward(*dargs, *dcot, acts), one)
        k4_plain_ms = cuda_ms(lambda: plain_backward_chunked(
            ffb2.fused_dual_backward_reference, dargs, dcot, per_point, stash=acts),
            1, warmup=0)
    k4_bnd = k4_bound(dargs, dcot, acts, d)
    del dargs, dcot, outs, acts, d
    torch.cuda.empty_cache()
    shape = f"deep march, B=2, {R} rays x {S} samples, hidden {H}"
    entries = []
    for name, err, ms, plain_ms, bnd in (("K1", k1_err, k1_ms, k1_plain_ms, k1_bnd),
                                         ("K2 recompute", k2_err, k2_ms, k2_plain_ms, k2_bnd),
                                         ("K3", k3_err, k3_ms, k3_plain_ms, k3_bnd),
                                         ("K4", k4_err, k4_ms, k4_plain_ms, k4_bnd)):
        print(f"{name}, {shape}: {ms:.4f} ms, plain (in {DEEP_CHUNK}-ray chunks) "
              f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), max abs err {err:.3e}")
        entries.append({"mode": f"{name}, {shape}", "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1]})
    return entries


def phase_stash_forms(seed, iters):
    """The stash's other forms (``checks.STASH_FORMS``: every second and
    every fourth trunk layer, the int8 stash).  At the training shape (B=2,
    4096 rays x 64 samples, hidden 384) and in the ``deep256`` case (S =
    256): K1 writing each form, its outputs K1's without the stash, a kept
    bf16 slot K1's bf16 stash's, the int8 codes and scales the plain
    quantizer's on the card over that stash (each to the bit); K2 reading
    it, with and without ``dens_vpu``, against its plain version on the same
    stash and (a partial stash) against K2 reading the full stash, to the
    bit; the int8 stash's K2 with ``dens_vpu`` at the training shape also
    against the unrounded float64 gradient (``checks.k1_form_failures``,
    ``checks.k2_form_failures``).  Then at the training shape and at the
    deep march's (``DEEP_SHAPE``) K1 and K2 (``dens_vpu``, as the training
    CLI's overrides run them) of each form timed beside the recompute and
    the bf16 stash of every layer, with their bounds and plain versions (at
    the deep shape in ``DEEP_CHUNK``-ray chunks, their largest differences
    printed), and the bits of the deep shape checked as above.  In both
    cases each form also with the sample points encoded in the tiles
    (``checks.points_form_failures``: K1 and K2 given the points against K1
    and K2 given the card's encoding, to the bit but the points' cotangent,
    a partial stash against the full one, each against its plain version).
    Prints a ``stash_form_case`` and a ``stash_form_points_case`` line per
    case and form and the ``stash_forms`` line: per shape and form K1's and K2's ms and the stash's GB per
    launch.  Returns the forms' K1 and K2 entries of the ``kernels`` line."""
    import torch

    from gazenerf_tpu_torch.kernels import checks
    from gazenerf_tpu_torch.kernels import fused_field as ff
    from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb

    dev = torch.device("cuda")
    fails = []
    k2_err = {}
    for case, shape in (("training", checks.K2_CASES["training"]),
                        ("deep256", checks.DEEP_CASES["deep256"])):
        args, cot = checks.field_case(*shape, dev, seed=seed)
        chunks = checks.deep_chunks(args) if case == "deep256" else None
        with torch.no_grad():
            _, full = ff.fused_field_forward(*args, stash=True)
            full_grads = {d: ffb.fused_field_backward(*args, *cot, stash=full, dens_vpu=d)
                          for d in (False, True)}
            for name, form in checks.STASH_FORMS.items():
                (_, acts), r1, f = checks.k1_form_failures(args, form, full)
                line = {"stash_form_case": case, "form": name, "seed": seed,
                        "k1_entries_differ": r1}
                fails += [f"K1 {name} {case}: {x}" for x in f]
                for dens_vpu in (False, True):
                    truth = form.dtype == "int8" and case == "training" and dens_vpu
                    _, line[f"k2_dens_vpu_{dens_vpu}"], f = checks.k2_form_failures(
                        case, args, cot, form, acts, full_grads[dens_vpu], dens_vpu,
                        chunks=chunks, truth=truth)
                    fails += [f"K2 {name} {case} dens_vpu={dens_vpu}: {x}" for x in f]
                k2_err[case, name] = line["k2_dens_vpu_True"]["max_abs_err"]
                print(json.dumps(line))
                del acts
        del args, cot, full, full_grads
        torch.cuda.empty_cache()
        # the same forms with the points encoded in the tiles
        args, cot = checks.points_case(*shape, dev, seed=seed)
        for name, form in checks.STASH_FORMS.items():
            line, f = checks.points_form_failures(case, args, cot, form, chunks=chunks)
            print(json.dumps({"stash_form_points_case": case, "form": name, "seed": seed,
                              **line}))
            fails += [f"points {name} {case}: {x}" for x in f]
        del args, cot
        torch.cuda.empty_cache()
    check(not fails, "\n".join(fails))

    # times at the training shape and the deep march's
    entries = {"k1": {}, "k2": {}}
    table = {}
    per_point = ("dembed", "dzvals", "dzdists")
    for label, (H, S, R) in (("training", checks.K2_CASES["training"]), ("deep", DEEP_SHAPE)):
        deep = label == "deep"
        args, cot = checks.field_case(H, S, R, dev, seed=seed)
        k2_iters = max(2, iters // (10 if deep else 4))
        rows = table[f"S={S}"] = {}
        with torch.no_grad():
            _, full = ff.fused_field_forward(*args, stash=True)
            full_grads = ffb.fused_field_backward(*args, *cot, stash=full, dens_vpu=True)
            rows["recompute"] = {
                "k1_ms": cuda_ms(lambda: ff.fused_field_forward(*args), iters),
                "k2_ms": cuda_ms(lambda: ffb.fused_field_backward(*args, *cot, dens_vpu=True),
                                 k2_iters), "stash_gb": 0.0}
            rows["full"] = {
                "k1_ms": cuda_ms(lambda: ff.fused_field_forward(*args, stash=True), iters),
                "k2_ms": cuda_ms(lambda: ffb.fused_field_backward(
                    *args, *cot, stash=full, dens_vpu=True), k2_iters),
                "stash_gb": nbytes(*full) / 1e9}
            for name, form in checks.STASH_FORMS.items():
                if deep:  # the bits, as in the cases above
                    (out, acts), _, f = checks.k1_form_failures(args, form, full)
                    got = ffb.fused_field_backward(*args, *cot, stash=acts, dens_vpu=True,
                                                   stash_form=form)
                    if form.dtype != "int8":
                        f += [f"K2 {n} differs from K2 reading the full stash" for n, a, b in
                              zip(got._fields, got, full_grads) if not torch.equal(a, b)]
                    fails += [f"{name} {label}: {x}" for x in f]
                    def ref(*a):  # the plain K1 writing the form
                        return ff.fused_field_reference(*a, stash=form)[0]

                    plain = plain_forward_chunked(ref, args)
                    k1_plain_ms = cuda_ms(lambda: plain_forward_chunked(ref, args), 1, warmup=0)

                    def plain_bwd():
                        parts = []
                        for sl in _ray_chunks(R):
                            a = (*(t[:, sl] for t in args[:3]), *args[3:])
                            parts.append(ffb.fused_field_backward_reference(
                                *a, *(t[:, sl] for t in cot), stash=[t[:, sl] for t in acts],
                                dens_vpu=True, stash_form=form))
                        return type(parts[0])(*(torch.cat(ts, 1) if n in per_point else sum(ts)
                                                for n, ts in zip(parts[0]._fields, zip(*parts))))

                    want = plain_bwd()
                    k2_plain_ms = cuda_ms(plain_bwd, 1, warmup=0)
                else:
                    out, acts = ff.fused_field_forward(*args, stash=form)
                    got = ffb.fused_field_backward(*args, *cot, stash=acts, dens_vpu=True,
                                                   stash_form=form)
                    plain = ff.fused_field_reference(*args, stash=form)[0]
                    k1_plain_ms = cuda_ms(lambda: ff.fused_field_reference(*args, stash=form),
                                          max(2, iters // 4), warmup=1)
                    want = None
                    k2_plain_ms = cuda_ms(lambda: ffb.fused_field_backward_reference(
                        *args, *cot, stash=acts, dens_vpu=True, stash_form=form),
                        max(2, k2_iters // 4), warmup=1)
                k1_err = max(float((a - b).abs().max()) for a, b in zip(out, plain))
                err2 = (k2_err["training", name] if want is None else
                        float(max((a - b).abs().max() for a, b in zip(got, want))))
                del plain, want
                k1_ms = cuda_ms(lambda: ff.fused_field_forward(*args, stash=form), iters)
                k2_ms = cuda_ms(lambda: ffb.fused_field_backward(
                    *args, *cot, stash=acts, dens_vpu=True, stash_form=form), k2_iters)
                rows[name] = {"k1_ms": k1_ms, "k2_ms": k2_ms, "stash_gb": nbytes(*acts) / 1e9}
                b1 = k1_stash_bound(args, out, acts)
                b2 = k2_form_bound(args, cot, acts, got, form)
                mode = f"stash {name}, {'deep march, S=256' if deep else 'training shape'}"
                where = f" (plain in {DEEP_CHUNK}-ray chunks)" if deep else ""
                for kern, err, ms, plain_ms, bnd in (("k1", k1_err, k1_ms, k1_plain_ms, b1),
                                                     ("k2", err2, k2_ms, k2_plain_ms, b2)):
                    entry = mode_record(kern.upper(), f"{mode}, writing it" if kern == "k1" else
                                        f"{mode}, reading it with dens_vpu{where}", err, ms,
                                        plain_ms, *bnd)
                    entries[kern][f"{'deep_' if deep else ''}stash_{name}"] = entry
                del out, acts, got
        del args, cot, full, full_grads
        torch.cuda.empty_cache()
    check(not fails, "\n".join(fails))
    print(json.dumps({"stash_forms": table}))
    return entries


def phase_hier(seed, n_forwards=3, fuse_embed=False):
    """The hierarchical sampler's fine pass: a full-width bf16 model
    forward at B=1 with ``hier_sampling`` (64 coarse + 128 fine = 192
    samples), the fused upsampler and the renderer passes stacked into one
    (``batch_renderer_passes``: K7 on 3B + 1 images): per forward three K1
    (two coarse, one fine at S = 192) and K7 once per block for the stacked
    pass and the fine pass; ``fine_dict["merge_img"]`` and
    ``coarse_dict["merge_img"]`` against the same forward with the plain
    versions (``IMAGE_ATOL``).  With ``fuse_embed`` the three K1 take the
    sample points (``pallas_fuse_embed``), the fine pass's the fine points.
    Returns the ``hier`` line."""
    import statistics

    import torch

    from gazenerf_tpu_torch import GazeNeRF
    from gazenerf_tpu_torch.config import ModelConfig
    from gazenerf_tpu_torch.kernels import checks
    from gazenerf_tpu_torch.ops.rays import pixel_grid
    from gazenerf_tpu_torch.viewer.server import lookat_camera

    cfg = ModelConfig(compute_dtype="bfloat16", renderer_dtype="bfloat16", hier_sampling=True,
                      shuffle_mode="fused", batch_renderer_passes=True,
                      pallas_fuse_embed=fuse_embed)
    dev = torch.device("cuda")
    tag = "hier fuse_embed" if fuse_embed else "hier"
    gen = torch.Generator().manual_seed(seed + 11)
    model = GazeNeRF(cfg, seed=seed).eval()
    random_biases_(model, gen)
    R, T, K = (torch.from_numpy(a).to(dev) for a in lookat_camera(8, -4, 12.0, cfg.featmap_size))
    args = (pixel_grid(cfg.featmap_size, device=dev)[None],
            (0.1 * torch.randn(1, cfg.shape_code_dims, generator=gen)).to(dev),
            (0.1 * torch.randn(1, cfg.appea_code_dims, generator=gen)).to(dev),
            torch.tensor([[0.15, -0.2]], device=dev), R, T, K)
    with torch.no_grad():
        model(*args)  # warm
        torch.cuda.synchronize()
        reset_launch_counts()  # counts from here on are the main path's
        times = []
        for _ in range(n_forwards):
            t0 = time.perf_counter()
            out = model(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = launch_counts()
        want = expected_launches(cfg, n_forwards, train=False, forward=True)
        check(launches == want, f"{tag}: {n_forwards} forwards launched {launches} (expected {want})")
        with checks.plain_versions():
            plain = model(*args)
    errs = {}
    for d in ("fine_dict", "coarse_dict"):
        img, ref = out[d]["merge_img"].float(), plain[d]["merge_img"].float()
        check(bool(torch.isfinite(img).all()), f"{tag}: {d} merge_img is not finite")
        errs[d] = float((img - ref).abs().max())
        print(f"{tag}: {d} merge_img, kernels vs plain, max abs err {errs[d]:.3e} "
              f"(atol {IMAGE_ATOL})")
        check(errs[d] <= IMAGE_ATOL, f"{tag}: {d} merge_img max abs err {errs[d]:.3e}")
    return {"config": "ModelConfig(compute_dtype=bfloat16, renderer_dtype=bfloat16, "
                      "hier_sampling=True, shuffle_mode=fused, batch_renderer_passes=True, "
                      f"pallas_fuse_embed={fuse_embed}); "
                      "B=1, 4096 rays x (64 + 128) samples, 512x512",
            "forward_ms": {"median": statistics.median(times), "samples": times},
            "launches_per_forward": {k: v / n_forwards for k, v in launches.items() if v},
            "merge_img_max_abs_err_kernels_vs_plain": errs}


REQUESTS = [  # (pitch, yaw, azimuth, elevation, distance)
    (0.0, 0.0, 0.0, 0.0, 12.0),
    (0.3, -0.4, 20.0, 5.0, 11.0),
    (-0.2, 0.5, -30.0, -10.0, 13.5),
    (0.1, 0.7, 45.0, 20.0, 10.0),
    (-0.4, -0.6, -50.0, 30.0, 15.0),
    (0.25, 0.1, 10.0, -25.0, 9.5),
]


def phase_serving(seed, cfg, n_requests, name):
    """Full-width renders through ViewerApp in the variant ``name`` of
    ``cfg``, with launch counts: K1 twice a request (K3 once on the dual
    path) and, in a kernel mode, its forward kernel (K5 in ``pallas``, K7 in
    ``fused``) once per upsample block; the image with the kernels against
    the same render with the plain versions.  Returns the app, the requests,
    the counts, the request times and the first request's image."""
    import numpy as np
    import torch

    from gazenerf_tpu_torch import ViewerApp
    from gazenerf_tpu_torch.kernels import checks
    from gazenerf_tpu_torch.utils.png import decode_png

    mode = name
    app = ViewerApp(cfg, seed=seed)  # on the card: no device given
    random_biases_(app.model, torch.Generator().manual_seed(seed))
    check(app.model.fused, "the bf16 config must run the fused field kernel")
    check(app.model.dual == cfg.pallas_dual_branch,
          f"{name}: the field path is not as configured")
    requests = [REQUESTS[i % len(REQUESTS)] for i in range(n_requests)]
    app.render_png(*requests[0])  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    reset_launch_counts()  # counts from here on are the main path's
    pngs, times = [], []
    for q in requests:
        t0 = time.perf_counter()
        pngs.append(app.render_png(*q))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    want = expected_launches(cfg, n_requests, train=False)
    check(launches == want, f"{mode}: {n_requests} requests launched {launches} (expected {want})")

    size = cfg.pred_img_size
    for q, png in zip(requests, pngs):
        img = decode_png(png)
        check(img.shape == (size, size, 3), f"PNG decodes to {img.shape}")
        ref = app.render_image(*q)
        check(bool(torch.isfinite(ref).all()), f"request {q}: non-finite pixels")
        again = torch.clamp(ref * 255.0, 0.0, 255.0).to(torch.uint8).cpu().numpy()
        check(int(np.abs(again.astype(np.int16) - img).max()) <= 1,
              f"request {q}: PNG differs from a second render")

    img_k = app.render_image(*requests[0]).float()
    with checks.plain_versions():
        img_p = app.render_image(*requests[0]).float()
    img_err = float((img_k - img_p).abs().max())
    check(img_err <= IMAGE_ATOL,
          f"{mode}: image with the kernels vs the plain versions: max abs err {img_err:.3e} "
          f"> {IMAGE_ATOL}")
    print(f"serving {mode}: {n_requests} requests of {size}x{size}, ms per request "
          f"{[round(t, 3) for t in times]}, median {float(np.median(times)):.3f}; launches "
          f"{ {k: v for k, v in launches.items() if v} }; image kernels vs plain max abs err "
          f"{img_err:.3e} (atol {IMAGE_ATOL})")
    return app, requests, launches, times, img_k


# the CUDA kernels of K7 (with the stencil's) and of K8, by name
UPSAMPLER_FWD = ("chain_fwd_kernel",)
UPSAMPLER_BWD = ("dz3_kernel", "block_bwd_kernel", "upsampler_dw_kernel",
                 "upsampler_dwsum_kernel", "upsampler_sum_kernel")
# and of K7 and K8 at f32
UPSAMPLER_F32_FWD = ("fwd_product<",)
UPSAMPLER_F32_BWD = ("bwd_product<", "wgrad_slices<", "sum_slices")


def renderer_mode(cfg):
    """The key of the renderer's kernels in ``kernel_ms``: the shuffle mode,
    ``fused_f32`` for the f32 renderer's fused mode."""
    f32 = cfg.shuffle_mode == "fused" and cfg.renderer_dtype == "float32"
    return FUSED_F32 if f32 else cfg.shuffle_mode


def kernel_ms(rows, mode):
    """Device ms per kernel of the ``kernels`` line from profiler rows (name,
    count, ms); the stencil launches belong to the mode's renderer kernels
    (``renderer_mode``)."""
    out = dict.fromkeys(KERNELS, 0.0)
    if mode == FUSED_F32:
        for key, _, ms in rows:
            if any(k in key for k in UPSAMPLER_F32_FWD + ("stencil::fwd_kernel",)):
                out["fused_upsampler_fwd_f32"] += ms
            elif any(k in key for k in UPSAMPLER_F32_BWD + ("stencil::bwd_kernel",)):
                out["fused_upsampler_bwd_f32"] += ms
        mode = None  # the fields' kernels below
    renderer = {"pallas": "shuffle_blur", "fused": "fused_upsampler"}.get(mode)
    for key, _, ms in rows:
        if "dual_fwd_kernel" in key:
            name = "fused_dual_fwd"
        elif any(f"dual_{k}_kernel" in key for k in ("bwd", "dw", "dwsum", "head", "sum")):
            name = "fused_dual_bwd"
        elif any(f"field_fwd_{k}kernel" in key for k in ("", "stash_", "part_", "quant_")):
            name = "fused_field_fwd"
        elif any(f"field_{k}_kernel" in key
                 for k in ("bwd", "bwd_part", "dw", "dwsum", "head", "sum")):
            name = "fused_field_bwd"
        elif renderer and any(k in key for k in UPSAMPLER_FWD + ("stencil::fwd_kernel",)):
            name = f"{renderer}_fwd"
        elif renderer and any(k in key for k in UPSAMPLER_BWD + ("stencil::bwd_kernel",)):
            name = f"{renderer}_bwd"
        else:
            continue
        out[name] += ms
    return {k: v for k, v in out.items() if v}


def device_profile(fn, top=0, mode=None):
    """One call of ``fn`` (to a synchronize) under ``torch.profiler``: its
    wall ms, the kernels it launched and their summed device ms, the ``top``
    kernels by device time and, given the renderer ``mode``, the device ms of
    each of the port's kernels.  "not measured" where the profiler sees no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel events only: an operator's row repeats its kernels' device time
    rows = sorted(
        ((e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[2],
    )
    if not rows:
        return {"wall_ms": wall_ms, "launches": "not measured", "device_ms": "not measured"}
    out = {"wall_ms": wall_ms, "launches": sum(r[1] for r in rows),
           "device_ms": sum(r[2] for r in rows)}
    if mode is not None:
        out["kernels_ms"] = kernel_ms(rows, mode)
    if top:
        out["top"] = [{"kernel": k[:80], "count": n, "ms": ms} for k, n, ms in rows[:top]]
    return out


def phase_breakdown(apps, requests, card):
    """Where a request's time goes (``phase_gm``), and the renderer's share
    of it: the viewer's one renderer pass against the model forward's four
    (the forward also renders the face, eye and background images, which
    the viewer does not show); then one renderer pass in every mode."""
    import statistics

    import torch

    from gazenerf_tpu_torch.utils.png import encode_png
    from gazenerf_tpu_torch.viewer.server import lookat_camera

    app = apps["phase_gm"]

    def host_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    def forward_args(app, q):
        R, T, K = (torch.from_numpy(a).to(app.device)
                   for a in lookat_camera(q[2], q[3], q[4], app.cfg.featmap_size))
        gaze = torch.tensor([q[:2]], dtype=torch.float32, device=app.device)
        return app.xy, app.shape_code, app.appea_code, gaze, R, T, K

    def model_forward(q):
        with torch.no_grad():
            return app.model(*forward_args(app, q))

    fwd, fwd4, to_host, png = [], [], [], []
    for q in requests:
        img, ms = host_ms(lambda: (app.render_image(*q), torch.cuda.synchronize())[0])
        fwd.append(ms)
        u8, ms = host_ms(lambda: torch.clamp(img * 255.0, 0.0, 255.0)
                         .to(torch.uint8).cpu().numpy())
        to_host.append(ms)
        png.append(host_ms(lambda: encode_png(u8))[1])
        fwd4.append(host_ms(lambda: (model_forward(q), torch.cuda.synchronize()))[1])

    q = requests[0]
    viewer = device_profile(lambda: app.render_image(*q), top=8, mode="phase_gm")
    forward4 = device_profile(lambda: model_forward(q))
    renderer = {}
    for mode, a in apps.items():
        with torch.no_grad():
            fm = a.model.render_featmaps(*forward_args(a, q))["featmaps"]["merge"]
            a.model.neural_render(fm)  # warm
            renderer[mode] = device_profile(lambda: a.model.neural_render(fm),
                                            mode=renderer_mode(a.cfg))
    if viewer["device_ms"] != "not measured":
        viewer["busy_unprofiled"] = viewer["device_ms"] / statistics.median(fwd)
    line = {
        "card": card,
        "parts_ms": {  # medians over the requests, host clock
            "forward": statistics.median(fwd),
            "uint8_to_host": statistics.median(to_host),
            "png_encode": statistics.median(png),
            "model_forward_4_passes": statistics.median(fwd4),
        },
        "viewer_request": viewer,
        "model_forward_4_passes": forward4,
        "renderer_pass": renderer,
    }
    return line


def phase_k2(seed, iters):
    """K2 against its plain version in the narrow case (hidden 64, where the
    two agree to f32 noise) and at the training step's shape (B=2, 4096
    rays, 64 samples, hidden 384), where it is also held against the
    unrounded float64 gradient and then timed."""
    import torch

    from gazenerf_tpu_torch.kernels import checks
    from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb

    dev = torch.device("cuda")
    fails = []
    for case in ("narrow", "training"):
        args, cot = checks.field_case(*checks.K2_CASES[case], dev, seed=seed)
        with torch.no_grad():
            got = ffb.fused_field_backward(*args, *cot)
            torch.cuda.synchronize()
            want = ffb.fused_field_backward_reference(*args, *cot)
            again = ffb.fused_field_backward(*args, *cot)
        readings, case_fails = checks.k2_failures(case, got, want)
        if case == "training":
            with torch.no_grad():
                want64 = ffb.fused_field_backward_reference(*args, *cot, dtype=torch.float64)
            exact = ffb.fused_field_backward_unrounded(*args, *cot)
            dist, truth_fails = checks.truth_failures(got, want, want64, exact,
                                                      checks.K2_TRUTH_RATIO, checks.K2_TRUTH_EXEMPT)
            case_fails += truth_fails
            del want64, exact
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            case_fails.append("two launches on the same inputs differ")
        print(json.dumps({"k2_case": case, "seed": seed, "readings": readings,
                          **({"unrounded_distance": dist} if case == "training" else {})}))
        fails += [f"K2 {case}: {f}" for f in case_fails]
    check(not fails, "\n".join(fails))
    max_err = float(max((a - b).abs().max() for a, b in zip(got, want)))
    with torch.no_grad():
        ms = cuda_ms(lambda: ffb.fused_field_backward(*args, *cot), iters)
        plain_ms = cuda_ms(lambda: ffb.fused_field_backward_reference(*args, *cot),
                           max(2, iters // 4), warmup=1)
        # the device time of one call by kernel: the tile kernel, the dW GEMM,
        # the head's and the per-CTA sums, over all chunks
        print(json.dumps({"k2_profile": device_profile(
            lambda: ffb.fused_field_backward(*args, *cot), top=6)}))
    bound_ms, bound_by = k2_bound(args, cot, got)
    return kernel_entry("fused_field_bwd", "fused_field_bwd.cu",
                        "gazenerf_tpu/kernels/fused_field_bwd.py:44", max_err, ms, plain_ms,
                        bound_ms, bound_by)


def phase_dw(seed, iters):
    """The backwards' weight-gradient GEMM (csrc/field_dw.cuh) on one full
    chunk of the training step (528 tiles of 64 points, hidden 384): K2's
    eleven products of a chunk in one launch, against their plain versions
    (the f32 products of the same bf16 operands), timed beside its bound and
    beside ``torch.matmul`` on the same bf16 operands, the yardstick, which
    the port never calls.  Prints the ``dw`` line."""
    import torch

    from gazenerf_tpu_torch.kernels import checks, field_dw

    dev = torch.device("cuda")
    H, Kp, P = 384, 64, field_dw.CHUNK_TILES * field_dw.TILE_POINTS
    gen = torch.Generator(device=dev).manual_seed(seed)
    # (M, N) of K2's products per chunk: Wr1x, Wr0, Wmid x2, W5x, W5e, Wmid x4, W0e
    widths = [(H, H // 2), (H, H), (H, H), (H, H), (H, H), (Kp, H)] + [(H, H)] * 4 + [(Kp, H)]
    xs = [torch.randn(P, m, device=dev, generator=gen).to(torch.bfloat16) for m, _ in widths]
    ds = [torch.randn(P, n, device=dev, generator=gen).to(torch.bfloat16) for _, n in widths]
    with torch.no_grad():
        outs = field_dw.weight_grad(xs, ds)
        torch.cuda.synchronize()
        errs = []
        for x, d, o in zip(xs, ds, outs):
            want = field_dw.weight_grad_reference(x, d)
            errs.append(float((o - want).abs().max()) / float(want.abs().max()))
        check(max(errs) <= checks.DW_MAX_REL_ERR,
              f"dW GEMM vs plain: ratio {max(errs):.3e} (limit {checks.DW_MAX_REL_ERR})")
        ms = cuda_ms(lambda: field_dw.weight_grad(xs, ds, outs), iters)
        plain_ms = cuda_ms(lambda: [field_dw.weight_grad_reference(x, d) for x, d in zip(xs, ds)],
                           max(2, iters // 4), warmup=1)
        library_ms = cuda_ms(lambda: [torch.matmul(x.t(), d) for x, d in zip(xs, ds)], iters)
    flops = 2 * P * sum(m * n for m, n in widths)
    bound_ms, bound_by = bound([flops / PEAK_BF16_FLOPS], nbytes(*xs, *ds, *outs) / PEAK_BYTES_PER_S)
    line = {"points": P, "products": len(widths), "max_ratio_vs_plain": max(errs),
            "limit": checks.DW_MAX_REL_ERR, "ms_per_launch": ms, "plain_ms": plain_ms,
            "torch_matmul_bf16_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "tflops": flops / ms / 1e9}
    print(json.dumps({"dw": line}))
    return line


def synthetic_batch(seed, B, size, featmap_size):
    """A seeded training batch in the loader's format: images in [0, 1],
    head and eye masks as filled ellipses, codes 0.1 * N(0, 1), the base
    camera (its featmap intrinsics scaled up to the image)."""
    import numpy as np

    from gazenerf_tpu_torch.data.cameras import base_inv_inmat

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size] / size

    def ellipse(cy, cx, ry, rx):
        return (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1).astype(np.float32)

    inmat = np.linalg.inv(base_inv_inmat(featmap_size)).astype(np.float32)
    inmat[:2] *= size / featmap_size

    def rep(a):
        return np.repeat(np.asarray(a, np.float32)[None], B, 0)

    return {
        "image": rng.random((B, size, size, 3), dtype=np.float32),
        "head_mask": rep(ellipse(0.5, 0.5, 0.4, 0.3)),
        "left_eye_mask": rep(ellipse(0.42, 0.4, 0.04, 0.06)),
        "right_eye_mask": rep(ellipse(0.42, 0.6, 0.04, 0.06)),
        "code": (0.1 * rng.standard_normal((B, 306))).astype(np.float32),
        "sample_idx": np.arange(B, dtype=np.int64),
        "pitchyaw": (0.2 * rng.standard_normal((B, 2))).astype(np.float32),
        "c2w_Rmat": rep(np.diag([1.0, -1.0, -1.0])),
        "c2w_Tvec": rep([0.0, 0.0, 12.0]),
        "inmat": rep(inmat),
    }


def phase_training(seed, cfg, n_steps, name, loss=None, breakdown=True):
    """Full-width training steps in the variant ``name`` of ``cfg`` (and
    ``loss``, the default loss stack if None) with
    launch counts (per step K1 and K2 twice, or K3 and K4 once on the dual
    path; in a kernel mode the renderer's forward and backward kernel once
    per upsample block and renderer pass: four passes, all four with a
    gradient, as the background pass carries ``bg_loss``), then one step's
    gradients with the kernels against the plain versions (on the dual path
    also against the single-branch step, and one step without the stash),
    then where a step's time goes (without ``breakdown`` only the device
    time of one step).  The mode of
    each K2 call in the two warm-up steps is read (``K2_MODES``), and what
    the fields' autograd op and each K1 and K2 call take for the embedding
    (``EMBED_MODES``).  Returns
    the variant's part of the ``training`` line."""
    import statistics

    import torch

    from gazenerf_tpu_torch import Config, Trainer
    from gazenerf_tpu_torch.kernels import fused_field as ff
    from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb
    from gazenerf_tpu_torch.models.gaze_nerf import stash_form

    mode = name
    t_start = time.perf_counter()
    tcfg = Config(model=cfg) if loss is None else Config(model=cfg, loss=loss)
    trainer = Trainer(tcfg, train_len=8, steps_per_epoch=1000, seed=seed)  # the card
    check(trainer.model.fused, "the bf16 config must run the fused field kernels")
    check(trainer.model.dual == cfg.pallas_dual_branch,
          f"{name}: the field path is not as configured")
    batch = synthetic_batch(seed, tcfg.train.batch_size, cfg.pred_img_size, cfg.featmap_size)

    def read(losses):
        return {k: float(v) for k, v in losses.items()}

    render_grads = (phase_render_mode_grads(trainer, batch, seed, name)
                    if name in RENDER_GRAD_REL_L2 else None)
    eye_imp = trainer.eye_importance(GRADUAL_EPOCH)  # None without is_gradual_loss
    k2_modes, k2_forms, op_inputs, kernel_inputs = [], set(), set(), set()
    fwd, bwd = ff.fused_field_forward, ffb.fused_field_backward

    def taken(e, n_freqs):  # what a field op or kernel takes for the embedding
        return "points" if n_freqs is not None else str(e.dtype).split(".")[-1]

    def op_spy(ops, stash, dens_vpu, n_freqs, embed, *rest):
        op_inputs.add(taken(embed, n_freqs))
        return apply(ops, stash, dens_vpu, n_freqs, embed, *rest)

    def fwd_spy(*a, **k):
        kernel_inputs.add(taken(a[0], k.get("n_freqs")))
        return fwd(*a, **k)

    def bwd_spy(*a, stash=None, dens_vpu=False, **k):
        k2_modes.append((stash is not None, dens_vpu))
        k2_forms.add(tuple(k.get("stash_form", ff.StashForm())) if stash is not None else None)
        kernel_inputs.add(taken(a[0], k.get("n_freqs")))
        return bwd(*a, stash=stash, dens_vpu=dens_vpu, **k)

    # the mode of each K1 and K2 call in the warm-up steps, and what the
    # fields give their autograd op
    apply = ff.FusedField.apply
    ff.FusedField.apply = op_spy
    ff.fused_field_forward, ffb.fused_field_backward = fwd_spy, bwd_spy
    try:
        first = read(trainer.train_step(batch, eye_imp=eye_imp))
        trainer.train_step(batch, eye_imp=eye_imp)
    finally:
        ff.fused_field_forward, ffb.fused_field_backward = fwd, bwd
        del ff.FusedField.apply  # the inherited classmethod again
    k2_modes = sorted(set(k2_modes))
    embed_modes = (",".join(sorted(op_inputs)), ",".join(sorted(kernel_inputs)))
    if name in K2_MODES:
        check(k2_modes == K2_MODES[name], f"{mode}: K2 ran in the modes (stash read, dens_vpu) "
              f"{k2_modes}, expected {K2_MODES[name]}")
        want_form = tuple(stash_form(cfg))
        check(k2_forms == {want_form}, f"{mode}: K2 read the stash forms {k2_forms}, "
              f"expected {want_form}")
    if name in EMBED_MODES:
        check(embed_modes == EMBED_MODES[name],
              f"{mode}: the fields' op took {embed_modes[0]} and K1 and K2 {embed_modes[1]}, "
              f"expected {EMBED_MODES[name]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()  # counts from here on are the main path's
    times = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        losses = trainer.train_step(batch, eye_imp=eye_imp)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    peak_requested = torch.cuda.memory_stats()["requested_bytes.all.peak"]
    last = read(losses)
    for loss, v in {**first, **last}.items():
        check(v == v and abs(v) != float("inf"), f"{mode}: training loss {loss} is not finite")
    lc = tcfg.loss
    want_keys = ({"angular"} if lc.use_angular_loss else set()) | (
        {"gen_patch_gan_loss", "disc_patch_gan_loss"} if lc.use_patch_gan_loss else set())
    check(want_keys <= set(last), f"{mode}: the losses lack {want_keys - set(last)}")
    if lc.use_patch_gan_loss:  # the warm-up is 0 at the first step, on after it
        check(first["gen_patch_gan_loss"] == 0.0 < last["gen_patch_gan_loss"],
              f"{mode}: generator term {first['gen_patch_gan_loss']} -> "
              f"{last['gen_patch_gan_loss']}")

    def falling(losses):  # the total without the generator term the warm-up turns on
        return losses["total_loss"] - losses.get("gen_patch_gan_loss", 0.0)

    check(falling(last) < falling(first),
          f"{mode}: total loss did not fall: {falling(first)} -> {falling(last)}")
    want = expected_launches(cfg, n_steps, train=True)
    check(launches == want, f"{mode}: {n_steps} steps launched {launches} (expected {want})")

    grads = phase_grad_check(trainer, batch, seed, name)
    if render_grads:
        grads["renderer_mode"] = render_grads
    if breakdown:
        parts = phase_step_breakdown(trainer, batch)
    else:  # the step's device time alone
        parts = {"step_profile": device_profile(lambda: trainer.train_step(batch, eye_imp=eye_imp),
                                                top=6, mode=renderer_mode(cfg))}
        if parts["step_profile"]["device_ms"] != "not measured":
            parts["step_profile"]["busy_share"] = (parts["step_profile"]["device_ms"]
                                                   / parts["step_profile"]["wall_ms"])
    return {
        "step_ms": {"median": statistics.median(times), "samples": times},
        "launches": {k: v for k, v in launches.items() if v},
        "launches_per_step": {k: v / n_steps for k, v in launches.items() if v},
        "k2_modes_stash_read_dens_vpu": k2_modes,
        "k2_stash_forms": sorted(k2_forms, key=str),
        "field_op_and_kernels_take": embed_modes,
        "losses_first_step": first,
        "losses_last_step": last,
        "eye_loss_importance": eye_imp,
        "steps": 2 + n_steps,
        "peak_memory_bytes": peak,
        "peak_requested_bytes": peak_requested,
        "grad_rel_l2_kernel_vs_plain": grads,
        "breakdown": parts,
        "seconds": time.perf_counter() - t_start,
    }


def step_grads(trainer, batch, t_rand, disc0, step_cfg, name):
    """One step's gradients (no update) per parameter group, flattened, with
    the model's field path and renderer mode set to ``step_cfg``'s for the
    step and back after it, from the discriminator state ``disc0`` and the
    jitter draws ``t_rand``; the step's launches are checked."""
    import torch

    model = trainer.model
    cfg = model.cfg

    def renderer_as(c):  # one parameter tree in every renderer mode
        model.neural_render.set_mode(c.shuffle_mode, c.renderer_fold_feat, c.renderer_rgb_cf)

    model.cfg = step_cfg  # the field path is read from the model's config per call
    renderer_as(step_cfg)
    trainer.load_disc_state(disc0)
    reset_launch_counts()
    try:
        trainer.train_step(batch, t_rand=t_rand, update=False)
        torch.cuda.synchronize()
    finally:
        model.cfg = cfg
        renderer_as(cfg)
    used = launch_counts()
    want = expected_launches(step_cfg, 1, train=True)
    check(used == want, f"{name}: the kernel step launched {used} (expected {want})")
    return {g["name"]: torch.cat([p.grad.reshape(-1).float() for p in g["params"]])
            for g in trainer.optimizer.param_groups}


def jitter_draws(trainer, seed):
    """The stratified sampler's jitter draws of one step, from ``seed``."""
    import torch

    cfg = trainer.model.cfg
    gen = torch.Generator(device=trainer.device).manual_seed(seed + 7)
    return torch.rand((trainer.cfg.train.batch_size, cfg.num_rays, cfg.num_sample_coarse + 1),
                      generator=gen, device=trainer.device)


def compare_grads(name, what, got, want, limits):
    """Relative L2 per parameter group of two steps' gradients, each
    printed beside its limit; fails above a limit or on a gradient that is
    not finite."""
    import torch

    out, fails = {}, []
    for group, g in got.items():
        rel = float((g - want[group]).norm() / want[group].norm())
        out[group] = rel
        print(f"{name}: step gradients, {what}, {group}: relative L2 {rel:.3e} "
              f"(limit {limits[group]:.1e})")
        if not bool(torch.isfinite(g).all()):
            fails.append(f"{name}: gradient of {group} is not finite")
        elif rel > limits[group]:
            fails.append(f"{name}: gradient of {group}, {what}: relative L2 {rel:.3e} "
                         f"above {limits[group]}")
    check(not fails, "\n".join(fails))
    return out


def phase_render_mode_grads(trainer, batch, seed, name):
    """The renderer variant ``name``'s step gradients (no update) against
    phase_gm's in the same renderer dtype, both from the trainer's seeded
    state before it takes a step: a state reached by the variant's own
    steps differs from run to run (``tools/torch_grad_repeat.py``).  The
    variant's gradients are read twice; their distance, the step's own
    noise, is returned beside the comparison."""
    import dataclasses

    cfg = trainer.model.cfg
    disc0 = trainer.disc_state()
    t_rand = jitter_draws(trainer, seed)
    mode = step_grads(trainer, batch, t_rand, disc0, cfg, name)
    again = step_grads(trainer, batch, t_rand, disc0, cfg, name)
    phase_gm = step_grads(trainer, batch, t_rand, disc0, dataclasses.replace(
        cfg, shuffle_mode="phase_gm", renderer_fold_feat=True, renderer_rgb_cf=True), name)
    trainer.optimizer.zero_grad(set_to_none=True)
    trainer.load_disc_state(disc0)
    repeat = {group: float((g - mode[group]).norm() / mode[group].norm())
              for group, g in again.items()}
    print(f"{name}: step gradients read twice, relative L2 per group {repeat}")
    return {"vs_phase_gm_at_seeded_state": compare_grads(
                name, "vs phase_gm at the seeded state", mode, phase_gm,
                RENDER_GRAD_REL_L2[name]),
            "repeat": repeat}


def phase_grad_check(trainer, batch, seed, name):
    """One step's gradients (no update) with the kernels, then the same
    step (state, batch, jitter draws) with the plain versions; relative L2
    per parameter group.  On the dual path also the same step on the
    single-branch path (K1 and K2 twice) and, with launch counts, the same
    step without the stash (K3 once, K2 twice)."""
    import dataclasses

    import torch

    from gazenerf_tpu_torch.kernels import checks
    from gazenerf_tpu_torch.models.gaze_nerf import stash_form

    cfg = trainer.model.cfg
    # a step updates the discriminator: each side starts from this state
    disc0 = trainer.disc_state()
    t_rand = jitter_draws(trainer, seed)

    def grads(step_cfg=cfg):
        return step_grads(trainer, batch, t_rand, disc0, step_cfg, name)

    def compare(what, got, want, limits):
        return compare_grads(name, what, got, want, limits)

    with_kernels = grads()
    with checks.plain_versions():
        trainer.load_disc_state(disc0)
        reset_launch_counts()
        trainer.train_step(batch, t_rand=t_rand, update=False)
        used = launch_counts()
    check(not any(used.values()), f"{name}: the plain step launched {used}")
    plain = {g["name"]: torch.cat([p.grad.reshape(-1).float() for p in g["params"]])
             for g in trainer.optimizer.param_groups}
    out = {"kernels_vs_plain": compare("kernels vs plain", with_kernels, plain,
                                       {**GRAD_REL_L2, **GRAD_REL_L2_MODE.get(name, {})})}
    if cfg.pallas_dual_branch:
        single = grads(dataclasses.replace(cfg, pallas_dual_branch=False, pallas_stash_acts=False))
        out["dual_vs_single_branch"] = compare("dual vs single-branch", with_kernels, single,
                                               DUAL_GRAD_REL_L2)
        recompute = grads(dataclasses.replace(cfg, pallas_stash_acts=False))
        out["stash_vs_recompute"] = compare("stash (K4) vs recompute (K2 per branch)",
                                            with_kernels, recompute, DUAL_GRAD_REL_L2)
    elif stash_form(cfg).dtype == "int8" and cfg.pallas_stash_acts:
        # the int8 stash against the bf16 stash of every layer
        bf16 = grads(dataclasses.replace(cfg, pallas_stash_dtype="bfloat16"))
        out["int8_vs_bf16_stash"] = compare("int8 stash vs the bf16 stash", with_kernels, bf16,
                                            INT8_GRAD_REL_L2)
        every, want = (torch.cat([g[k] for k in _GROUPS]) for g in (with_kernels, bf16))
        rel = float((every - want).norm() / want.norm())
        print(f"{name}: step gradients, int8 stash vs the bf16 stash, all together: relative L2 "
              f"{rel:.3e} (limit {INT8_GRAD_REL_L2_ALL})")
        check(rel <= INT8_GRAD_REL_L2_ALL, f"{name}: int8 stash vs the bf16 stash, all "
              f"gradients together: relative L2 {rel:.3e}")
        out["int8_vs_bf16_stash"]["all"] = rel
    elif stash_form(cfg).every > 1 and cfg.pallas_stash_acts:
        # K2 reading every k-th layer gives the full stash's bits, which the
        # stash variant holds against phase_gm: held as the dual path
        full = grads(dataclasses.replace(cfg, pallas_stash_every=1))
        out["vs_bf16_stash"] = compare("vs the bf16 stash of every layer", with_kernels, full,
                                       STASH_GRAD_REL_L2)
    elif cfg.pallas_stash_acts or cfg.pallas_split_dw:
        what = "split_dw" if cfg.pallas_split_dw else "stash and dens_vpu"
        phase_gm = grads(dataclasses.replace(cfg, pallas_stash_acts=False, pallas_dens_vpu=False,
                                             pallas_split_dw=False))
        out[f"{what.split()[0]}_vs_phase_gm"] = compare(
            f"{what} vs phase_gm (K2 recomputing)", with_kernels, phase_gm, STASH_GRAD_REL_L2)
    if cfg.pallas_fuse_embed or cfg.pallas_embed_bf16:
        # the same fields given the f32 embedding
        other = grads(dataclasses.replace(cfg, pallas_fuse_embed=False, pallas_embed_bf16=False))
        out["vs_f32_embedding"] = compare("vs the f32 embedding", with_kernels, other,
                                          EMBED_GRAD_REL_L2[name])
    trainer.optimizer.zero_grad(set_to_none=True)
    trainer.load_disc_state(disc0)
    return out


def phase_step_breakdown(trainer, batch):
    """Where one training step's time goes, on the device: the step's
    stages each timed alone to a synchronize (fields forward with K1, or K3
    on the dual path, the four renderer passes; with the GAN loss the
    discriminator's update; the gaze-VGG's angular term and the generator
    term through the discriminator, each forward and backward to the merged
    image; the whole loss stack, then the backward in three parts, the
    fields' with K2 or K4, and the optimizer), and the whole step under
    ``torch.profiler`` (device time by kernel, the port's kernels apart)."""
    import numpy as np
    import torch

    from gazenerf_tpu_torch.losses.gazenerf_loss import (
        compute_losses,
        gaze_angular_distance,
        generator_loss,
    )
    from gazenerf_tpu_torch.models.vgg import normalize_imagenet
    from gazenerf_tpu_torch.ops.image import resize_bilinear
    from gazenerf_tpu_torch.ops.rays import pixel_grid
    from gazenerf_tpu_torch.train.trainer import (
        compose_codes_and_cams,
        decode_uint8_batch,
        discriminator_step,
    )

    model, cfg = trainer.model, trainer.cfg
    eye_imp = trainer.eye_importance(GRADUAL_EPOCH)
    b = decode_uint8_batch(trainer.to_device(batch))
    B = b["image"].shape[0]
    expr = torch.as_tensor(np.asarray(trainer.expr_fix), device=trainer.device)
    xy = pixel_grid(cfg.model.featmap_size, device=trainer.device)[None].expand(B, -1, -1)
    nr = model.neural_render
    ms = {}
    k_fwd, k_bwd = ("k3", "k4") if model.dual else ("k1", "k2")

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    def stages():
        sc, ac, gz, R, T, K, ocd, dcam = compose_codes_and_cams(cfg, b, trainer.offsets, expr)
        fm = timed(f"fields_forward_{k_fwd}", lambda: model.render_featmaps(
            xy, sc, ac, gz, R, T, K, train=True, generator=trainer.generator)["featmaps"])
        imgs = timed("renderer_forward_4_passes", lambda: {
            "merge_img": nr(fm["merge"]), "merge_img_face": nr(fm["face"]),
            "merge_img_eyes": nr(fm["eyes"]), "bg_img": nr(nr.get_bg_featmap())})
        merge, hm = imgs["merge_img"], b["head_mask"][..., None]
        disc, gaze = trainer.disc, trainer.frozen.gaze_fn()
        disc_fn = None
        if disc is not None:
            timed("discriminator_update", lambda: discriminator_step(
                disc, trainer.disc_optimizer, merge, b["image"], hm))
            disc_fn = lambda img: disc(img, train=False)  # noqa: E731
            gen = timed("generator_loss_forward", lambda: generator_loss(
                disc_fn(resize_bilinear(merge, (224, 224)))))
            timed("generator_loss_backward",
                  lambda: torch.autograd.grad(gen, merge, retain_graph=True))
        if gaze is not None:
            def prep(img):
                return resize_bilinear(normalize_imagenet(img), (224, 224))

            gt_head = torch.where(hm < 0.5, 1.0, b["image"])
            ang = timed("gaze_vgg_forward", lambda: gaze_angular_distance(
                gaze, prep(merge), prep(gt_head)))
            timed("gaze_vgg_backward", lambda: torch.autograd.grad(ang, merge, retain_graph=True))
        losses = timed("losses_forward_vgg", lambda: compute_losses(
            cfg.loss, imgs, b["image"], hm, b["left_eye_mask"][..., None],
            b["right_eye_mask"][..., None], eye_loss_importance=eye_imp,
            vgg_capture_fn=trainer.frozen.vgg_capture_fn(), gaze_fn=gaze, disc_fn=disc_fn,
            opt_code_dict=ocd, delta_cam=dcam, step=trainer.step))
        keys = ("merge_img", "merge_img_face", "merge_img_eyes")
        g_img = timed("losses_backward_vgg", lambda: torch.autograd.grad(
            losses["total_loss"], [imgs[k] for k in keys], retain_graph=True))
        fms = [fm["face"], fm["eyes"], fm["merge"]]
        ren = list(nr.parameters())
        g_fm = timed("renderer_backward_3_passes", lambda: torch.autograd.grad(
            [imgs[k] for k in keys], fms + ren, g_img, retain_graph=True)[:3])
        params = [p for p in model.parameters() if p.requires_grad] + list(trainer.offsets.values())
        grads = timed(f"fields_backward_{k_bwd}", lambda: torch.autograd.grad(
            fms[:2], params, g_fm[:2], allow_unused=True))
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        timed("optimizer", trainer.optimizer.step)
        trainer.optimizer.zero_grad(set_to_none=True)

    stages()  # warm
    stages()
    profile = device_profile(lambda: trainer.train_step(batch, eye_imp=eye_imp), top=12,
                             mode=renderer_mode(cfg.model))
    if profile["device_ms"] != "not measured":
        profile["busy_share"] = profile["device_ms"] / profile["wall_ms"]
    return {"stages_ms": ms, "step_profile": profile}


# the distributed phase: four ranks over gloo on one card (dp 2 x rp 2) and
# one NCCL rank, each through the training step on a mesh, against the
# one-process step of the same seeded state, batch and jitter draws
DIST_LAYOUTS = {"gloo_2x2": ("gloo", 2, 2), "nccl_1x1": ("nccl", 1, 1)}
# the passes: the default loss stack (VGG on), and with the PatchGAN
DIST_PASSES = {"default": {}, "gan": {"use_patch_gan_loss": True}}
# the loss of the dp x rp step against the one-process step's, relative
DIST_LOSS_RTOL = 1e-4
# a worker process that runs longer fails the phase; a collective that
# waits longer raises in the worker (the process group's timeout)
DIST_PROCESS_TIMEOUT_S = 300
DIST_COLLECTIVE_TIMEOUT_S = 120
DIST_TIMED_STEPS = 3


def dist_batch(seed):
    """The distributed phase's global batch (B=2, 512x512): the synthetic
    batch with the second row's head and eye masks smaller, so that the
    data ranks' masked-mean denominators differ from the whole batch's."""
    import numpy as np

    b = synthetic_batch(seed, 2, 512, 64)
    yy, xx = np.mgrid[:512, :512] / 512
    b["head_mask"][1] = (((yy - 0.55) / 0.3) ** 2 + ((xx - 0.5) / 0.2) ** 2 < 1)
    b["left_eye_mask"][1] = (((yy - 0.5) / 0.03) ** 2 + ((xx - 0.42) / 0.05) ** 2 < 1)
    b["right_eye_mask"][1] = (((yy - 0.5) / 0.03) ** 2 + ((xx - 0.58) / 0.04) ** 2 < 1)
    return b


def dist_pass(seed, loss_flags, mesh=None):
    """One pass of the distributed phase in this process: a full-width bf16
    trainer (phase_gm, K1 and K2 recomputing) from ``seed`` on ``mesh``
    (None: the one-process step), one step without the update on the
    global batch's rows of this rank and the global jitter draws, its
    losses, K1/K2 launches, gradients per parameter group and, with the
    GAN, the discriminator's reduced gradient and its state after the
    update; then the update and the
    updated parameters; then ``DIST_TIMED_STEPS`` timed steps (the jitter
    drawn by the step), the last with the collectives timed."""
    import statistics

    import torch

    from gazenerf_tpu_torch import Config, LossConfig, ModelConfig, Trainer
    from gazenerf_tpu_torch.parallel import sharding
    from gazenerf_tpu_torch.train import trainer as trainer_mod

    cfg = Config(model=ModelConfig(compute_dtype="bfloat16", renderer_dtype="bfloat16"),
                 loss=LossConfig(**loss_flags))
    tr = Trainer(cfg, train_len=2, steps_per_epoch=1000, seed=seed, mesh=mesh)
    random_biases_(tr.model, torch.Generator().manual_seed(seed))
    batch = dist_batch(seed)
    if mesh is not None:
        batch = {k: v[sharding.row_slice(mesh, 2)] for k, v in batch.items()}
    t_rand = jitter_draws(tr, seed)  # the global batch's
    disc_grads, fakes = [], []
    disc_step = trainer_mod.discriminator_step
    if tr.disc is not None:  # the reduced gradient that the discriminator's Adam takes
        disc_grads = capture_disc_grads(tr.disc, tr.disc_optimizer)
        trainer_mod.discriminator_step = lambda d, o, img, *a: (  # the image it is given
            fakes.append(img.detach().cpu()), disc_step(d, o, img, *a))[1]
    torch.cuda.synchronize()
    reset_launch_counts()
    try:
        losses = tr.train_step(batch, t_rand=t_rand, update=False)
        torch.cuda.synchronize()
    finally:
        trainer_mod.discriminator_step = disc_step
    launches = launch_counts()
    out = {"losses": {k: float(v) for k, v in losses.items()},
           "launches": {k: v for k, v in launches.items() if v},
           "grads": {g["name"]: torch.cat([p.grad.reshape(-1).float() for p in g["params"]]).cpu()
                     for g in tr.optimizer.param_groups}}
    if tr.disc is not None:
        out["disc"] = {k: v.float().cpu() for k, v in tr.disc.state_dict().items()}
        out["disc_grad"], out["fake"] = disc_grads[0], fakes[0]
        del tr.disc_optimizer.step  # the bound method again
    tr.optimizer.step()
    tr.scheduler.step()
    out["params"] = {g["name"]: torch.cat([p.detach().reshape(-1).float() for p in g["params"]])
                     .cpu() for g in tr.optimizer.param_groups}
    times = []
    for i in range(DIST_TIMED_STEPS):
        if mesh is not None and i == DIST_TIMED_STEPS - 1:
            mesh.reset_traffic()
            mesh.timed = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = {"median": statistics.median(times[:-1]), "samples": times[:-1],
                      "with_timed_collectives": times[-1]}
    if mesh is not None:
        out["traffic"] = {k: {"calls": v["calls"], "bytes": v["bytes"],
                              "ms": v["seconds"] * 1e3} for k, v in mesh.traffic.items()}
        mesh.timed = False
    return out


def capture_disc_grads(disc, disc_optimizer):
    """The discriminator's gradients, flattened, appended to the returned
    list at each step of its Adam (which runs on)."""
    import torch

    grads = []
    opt_step = disc_optimizer.step
    disc_optimizer.step = lambda *a: (grads.append(torch.cat(
        [p.grad.reshape(-1) for p in disc.parameters()]).cpu()), opt_step(*a))[1]
    return grads


def disc_grad_given(seed, fake, like):
    """The one-process discriminator update's gradient from the trainer's
    seeded discriminator, on the distributed phase's batch with ``fake``
    (the rendered images) in place of the step's own render ``like``, laid
    out as it is (the resize before the discriminator reads a render's
    strides: on a contiguous copy the update moves by ~6e-4 relative L2)."""
    import torch

    from gazenerf_tpu_torch import TrainConfig
    from gazenerf_tpu_torch.models.discriminator import PatchGAN
    from gazenerf_tpu_torch.train.state import make_disc_optimizer
    from gazenerf_tpu_torch.train.trainer import discriminator_step

    disc = PatchGAN()
    disc.reset_parameters(torch.Generator().manual_seed(seed + 2))  # as Trainer seeds it
    disc.to("cuda").requires_grad_(False)
    opt = make_disc_optimizer(TrainConfig(), disc.parameters())
    grads = capture_disc_grads(disc, opt)
    b = dist_batch(seed)
    gt = torch.from_numpy(b["image"]).cuda()
    hm = torch.from_numpy(b["head_mask"]).cuda()[..., None]
    x = torch.empty_strided(like.shape, like.stride(), dtype=like.dtype, device="cuda")
    discriminator_step(disc, opt, x.copy_(fake), gt, hm)
    return grads[0]


def distributed_worker(args):
    """A rank of the distributed phase (``--distributed_rank``): joins the
    group, builds the mesh on the card, runs every pass, writes its
    readings for the phase to read."""
    import os

    import torch

    from gazenerf_tpu_torch.parallel.mesh import init_distributed, make_mesh

    backend, dp, rp = DIST_LAYOUTS[args.distributed_layout]
    init_distributed(f"localhost:{args.distributed_port}", dp * rp, args.distributed_rank,
                     backend=backend, device="cuda", timeout_s=DIST_COLLECTIVE_TIMEOUT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(dp, rp, device="cuda")
    out = {name: dist_pass(args.seed, flags, mesh) for name, flags in DIST_PASSES.items()}
    torch.save(out, os.path.join(args.distributed_dir, f"rank{args.distributed_rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def rel_l2(a, b):
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def phase_distributed(seed, smi):
    """Training on more than one device, on one card: the step on a
    ``dp 2 x rp 2`` mesh of four ranks over gloo on ``cuda:0`` (NCCL takes
    one rank per device), and on a one-rank NCCL mesh, each pass against
    the one-process step from the same seeded state, batch and jitter
    draws: the loss (``DIST_LOSS_RTOL``), each parameter group's reduced
    gradient (``GRAD_REL_L2``), the updated parameters, K1/K2 twice per
    rank and step, each rank's step time and the collectives' bytes and
    ms; with the PatchGAN also the discriminator's parameters and
    BatchNorm statistics after its update and the gradient it took, and
    that gradient against the one-process update given the ranks' own
    renders (``GRAD_REL_L2["net"]``): the discriminator's gradient moves by
    1.5e-2 relative L2 for renders 1.5e-3 apart (a rank renders one row,
    the one process two), and Adam's first step moves a parameter by the
    learning rate times its gradient's sign, so a near-zero gradient whose
    sign flips parts the updates by twice the rate (the zero-initialised
    BatchNorm biases read up to 0.18 relative L2).  Each rank is a process of this
    script with ``DIST_PROCESS_TIMEOUT_S`` to finish; its collectives time
    out after ``DIST_COLLECTIVE_TIMEOUT_S``.  Returns the phase's line."""
    import os
    import socket
    import tempfile

    import torch

    t_start = time.perf_counter()
    ref = {name: dist_pass(seed, flags) for name, flags in DIST_PASSES.items()}
    torch.cuda.empty_cache()
    line = {"card": smi, "config": "ModelConfig(compute_dtype=bfloat16, renderer_dtype=bfloat16)"
            " (phase_gm, K1/K2 recomputing), LossConfig() and LossConfig(use_patch_gan_loss="
            "True), TrainConfig(); global B=2, 4096 rays x 64 samples, 512x512",
            "one_process": {name: {"losses": r["losses"], "step_ms": r["step_ms"],
                                   "launches": r["launches"]} for name, r in ref.items()},
            "layouts": {}}
    # the standalone update's own distance from the step's, on the same render
    own = rel_l2(ref["gan"]["disc_grad"],
                 disc_grad_given(seed, ref["gan"]["fake"], ref["gan"]["fake"]))
    line["one_process"]["gan"]["disc_grad_given_own_render_rel_l2"] = own
    print(f"distributed: the one-process discriminator gradient against the update given its "
          f"own render, relative L2 {own:.3e}")
    fails = []
    for layout, (backend, dp, rp) in DIST_LAYOUTS.items():
        t0 = time.perf_counter()
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as work:
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
                 "--distributed_layout", layout, "--distributed_rank", str(r),
                 "--distributed_port", str(port), "--distributed_dir", work],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(dp * rp)]
            outs = []
            try:
                for p in procs:
                    outs.append(p.communicate(timeout=DIST_PROCESS_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                fails.append(f"{layout}: a rank ran past {DIST_PROCESS_TIMEOUT_S} s")
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            bad = [(r, p.returncode, out[-3000:]) for r, (p, out) in enumerate(zip(procs, outs))
                   if p.returncode != 0]
            check(not fails and not bad, f"{layout}: {fails} {bad}")
            ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                     for r in range(dp * rp)]
        res = {"backend": backend, "dp": dp, "rp": rp, "passes": {},
               "seconds": time.perf_counter() - t0}
        for name, want in ref.items():
            got = ranks[0][name]
            rd = {}
            rel = abs(got["losses"]["total_loss"] - want["losses"]["total_loss"]) / abs(
                want["losses"]["total_loss"])
            rd["loss_rel_diff"] = rel
            print(f"distributed {layout} {name}: loss {got['losses']['total_loss']:.6f} vs "
                  f"{want['losses']['total_loss']:.6f}, relative {rel:.3e} "
                  f"(limit {DIST_LOSS_RTOL})")
            if not rel <= DIST_LOSS_RTOL:
                fails.append(f"{layout} {name}: loss relative difference {rel:.3e}")
            rd["grad_rel_l2"] = compare_grads(f"distributed {layout} {name}",
                                              "reduced vs one process", got["grads"],
                                              want["grads"], GRAD_REL_L2)
            rd["params_rel_l2_after_update"] = {g: rel_l2(got["params"][g], want["params"][g])
                                                for g in want["params"]}
            for r, rk in enumerate(ranks):  # every rank holds the same update
                for g, v in rk[name]["params"].items():
                    if not torch.equal(v, got["params"][g]):
                        fails.append(f"{layout} {name}: rank {r}'s {g} differs from rank 0's")
            if "disc" in want:
                rd["disc_grad_rel_l2"] = rel_l2(got["disc_grad"], want["disc_grad"])
                # the same update on one process given the ranks' renders:
                # the rendered rows (B=1 per rank against B=2) part the two
                fake = torch.cat([ranks[d * rp][name]["fake"] for d in range(dp)])
                rd["fake_max_abs_diff"] = float((fake.float() - want["fake"].float()).abs().max())
                given = rel_l2(got["disc_grad"], disc_grad_given(seed, fake, want["fake"]))
                rd["disc_grad_given_ranks_render_rel_l2"] = given
                print(f"distributed {layout} {name}: the ranks' renders against the one "
                      f"process's, max abs {rd['fake_max_abs_diff']:.3e}; the reduced "
                      f"discriminator gradient against the one-process update given the "
                      f"ranks' renders, relative L2 {given:.3e} (limit {GRAD_REL_L2['net']})")
                if not given <= GRAD_REL_L2["net"]:
                    fails.append(f"{layout} {name}: the discriminator's reduced gradient, "
                                 f"given the ranks' renders: relative L2 {given:.3e}")
                rd["disc_rel_l2"] = {k: rel_l2(got["disc"][k], v) for k, v in want["disc"].items()}
                print(f"distributed {layout} {name}: the discriminator's reduced gradient, "
                      f"relative L2 {rd['disc_grad_rel_l2']:.3e}; after its update, relative "
                      f"L2 per tensor {rd['disc_rel_l2']}")
                if not all(torch.isfinite(v).all() for v in got["disc"].values()):
                    fails.append(f"{layout} {name}: the discriminator is not finite")
            rd["launches_per_rank"] = [rk[name]["launches"] for rk in ranks]
            for r, rk in enumerate(ranks):
                k = rk[name]["launches"]
                if (k.get("fused_field_fwd"), k.get("fused_field_bwd")) != (2, 2):
                    fails.append(f"{layout} {name}: rank {r} launched {k} (K1 and K2 twice)")
            rd["step_ms_per_rank"] = [rk[name]["step_ms"] for rk in ranks]
            rd["traffic_per_rank"] = [rk[name].get("traffic") for rk in ranks]
            print(f"distributed {layout} {name}: params after the update, relative L2 "
                  f"{rd['params_rel_l2_after_update']}; step ms per rank "
                  f"{[round(s['median'], 3) for s in rd['step_ms_per_rank']]}; collectives "
                  f"{rd['traffic_per_rank'][0]}")
            res["passes"][name] = rd
        line["layouts"][layout] = res
    check(not fails, "\n".join(fails))
    line["seconds"] = time.perf_counter() - t_start
    return line


def phase_cli(seed):
    """The training entry point from files: one synthetic subject of 8
    frames at 512x512 (``data/synthetic``) in a temporary directory;
    ``gazenerf_tpu_torch.cli.train.main`` in-process at the reference shape
    with ``--pallas_tuning auto`` for 2 epochs (4 steps each), then resumed
    from the last checkpoint for a third.  Checks: finite losses, one
    checkpoint per epoch, the restored state equal to the saved one to the
    bit, K1 and K2 twice a step each in the mode the overrides chose (the
    stash written and read, ``dens_vpu``), and ``summary.csv`` with all
    three epochs.  Returns the ``cli`` line, or None where h5py is not
    installed (the phase then does not run)."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("cli: not run: h5py is not installed here, and the loader reads h5 files")
        return None
    import csv
    import logging
    import os
    import tempfile

    import torch

    from gazenerf_tpu_torch.cli import train as cli_train
    from gazenerf_tpu_torch.cli.common import tuned_kernel_overrides
    from gazenerf_tpu_torch.config import Config
    from gazenerf_tpu_torch.data.synthetic import write_synthetic_subject
    from gazenerf_tpu_torch.kernels import fused_field as ff
    from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb
    from gazenerf_tpu_torch.train.checkpoint import load_checkpoint
    from gazenerf_tpu_torch.train.trainer import Trainer

    # the modes each launch ran in, seen by wrappers around the two wrappers
    modes = {"k1": [], "k2": []}
    fwd, bwd = ff.fused_field_forward, ffb.fused_field_backward

    def fwd_spy(*a, stash=False, **k):
        modes["k1"].append(stash)
        return fwd(*a, stash=stash, **k)

    def bwd_spy(*a, stash=None, dens_vpu=False, **k):
        modes["k2"].append((stash is not None, dens_vpu))
        return bwd(*a, stash=stash, dens_vpu=dens_vpu, **k)

    with tempfile.TemporaryDirectory() as tmp:
        data, ck = os.path.join(tmp, "data"), os.path.join(tmp, "ck")
        write_synthetic_subject(data, num_frames=8, img_size=512, seed=seed)
        argv = ["--img_dir", data, "--checkpoint_dir", ck, "--pallas_tuning", "auto",
                "--allow_random_frozen_nets", "true", "--num_workers", "2", "--seed", str(seed)]
        ff.fused_field_forward, ffb.fused_field_backward = fwd_spy, bwd_spy
        reset_launch_counts()
        try:
            check(cli_train.main(argv + ["--num_epochs", "2"]) == 0, "cli: train failed")
            check(sorted(os.listdir(ck)) == ["epoch_1", "epoch_2", "summary.csv", "train.log"],
                  f"cli: {sorted(os.listdir(ck))} after 2 epochs")
            last = os.path.join(ck, "epoch_2")
            check(cli_train.main(argv + ["--num_epochs", "3", "--resume", last]) == 0,
                  "cli: the resumed run failed")
        finally:
            ff.fused_field_forward, ffb.fused_field_backward = fwd, bwd
            root = logging.getLogger()  # the CLI's handlers write into the temporary directory
            for h in list(root.handlers):
                h.close()
                root.removeHandler(h)
        launches = launch_counts()
        check(os.path.isdir(os.path.join(ck, "epoch_3")), "cli: no checkpoint of epoch 3")
        with open(os.path.join(ck, "summary.csv")) as f:
            rows = list(csv.DictReader(f))
        check([int(r["epoch"]) for r in rows] == [0, 1, 2], f"cli: summary.csv rows {rows}")
        losses = [float(r["loss"]) for r in rows]
        check(all(v == v and abs(v) != float("inf") for v in losses), f"cli: losses {losses}")
        steps = sum(int(r["batches"]) for r in rows)
        want = dict.fromkeys(KERNELS, 0)
        want["fused_field_fwd"] = want["fused_field_bwd"] = 2 * steps
        check(launches == want, f"cli: {steps} steps launched {launches} (expected {want})")
        tuned = tuned_kernel_overrides(64, 64)
        mode = (tuned["pallas_stash_acts"], tuned["pallas_dens_vpu"])
        check(modes["k1"] == [mode[0]] * 2 * steps and modes["k2"] == [mode] * 2 * steps,
              f"cli: the kernels ran in modes {set(modes['k1'])}, {set(modes['k2'])}, "
              f"the overrides chose {mode}")

        # the restored state against the saved file, tensor by tensor
        with open(os.path.join(last, "config.json")) as f:
            cfg = Config.from_json(json.dumps(json.load(f)["config"]))
        saved = torch.load(os.path.join(last, "state"), map_location="cuda", weights_only=False)
        trainer = Trainer(cfg, train_len=8, steps_per_epoch=4)
        load_checkpoint(last, trainer)
        def tensors(tree):  # the tensors of a nested dict, in key order
            if isinstance(tree, dict):
                return [t for k in sorted(tree, key=str) for t in tensors(tree[k])]
            return [tree] if isinstance(tree, torch.Tensor) else []

        restored = tensors({"model": trainer.model.state_dict(), "offsets": dict(trainer.offsets),
                            "optimizer": trainer.optimizer.state_dict()["state"]})
        stored = tensors({"model": saved["model"], "offsets": saved["offsets"],
                          "optimizer": saved["optimizer"]["state"]})
        check(len(restored) == len(stored) and
              all(torch.equal(a, b) for a, b in zip(stored, restored)),
              "cli: the restored state differs from the saved one")
        check(torch.equal(trainer.generator.get_state(), saved["generator"].cpu()) and
              trainer.step == saved["step"] == 8, "cli: the generator or the step differs")
        del trainer, saved
    torch.cuda.empty_cache()
    line = {"steps": steps, "epochs": len(rows), "losses": losses,
            "overrides": {k: v for k, v in tuned.items()},
            "ms_per_step": [1e3 * float(r["seconds"]) / int(r["batches"]) for r in rows],
            "loader_wait_ms_per_batch": [1e3 * float(r["loader_wait_s"]) / int(r["batches"])
                                         for r in rows],
            "state_tensors_equal": len(stored)}
    print(json.dumps({"cli": line}))
    return line


def phase_k2_fit(seed, iters):
    """K1 and K2 at B=1, the single-image fit's and the gaze optimization's
    shape (``checks.K2_FIT_CASE``: hidden 384, 64 samples, 4096 rays).  K1
    writing the stash: its outputs and ten stash tensors against its plain
    version's (``checks.K1_LIMITS`` and ``K1_STASH_LIMITS``, the training
    case's).  K2 recomputing, and reading K1's stash with ``dens_vpu``:
    against its plain version (on the same stash; ``checks.K2_FIT_LIMITS``),
    the unrounded float64 gradient and itself over two launches, each mode
    timed beside its bound; reading the stash, the density masks of kernel
    and plain version equal at every point.  (K1's stash is K2's recompute
    to the bit, so K2 on it against the plain version on the plain stash
    reads as the recompute mode does, dWd aside.)  Also counted: the points whose
    density sign a matmul's summation order would flip against the
    kernel's.  Returns the ``k2_fit`` part of the ``eval`` line."""
    import torch

    from gazenerf_tpu_torch.kernels import checks
    from gazenerf_tpu_torch.kernels import fused_field as ff
    from gazenerf_tpu_torch.kernels import fused_field_bwd as ffb

    dev = torch.device("cuda")
    args, cot = checks.field_case(*checks.K2_FIT_CASE, dev, seed=seed, batch=checks.K2_FIT_BATCH)
    w = args[6]
    with torch.no_grad():
        k1_out, acts = ff.fused_field_forward(*args, stash=True)
        plain_out, plain_acts = ff.fused_field_reference(*args, stash=True)
        x7 = acts[7].reshape(-1, acts[7].shape[-1]).float()
        matmul_flips = int(((x7 @ w.wd.float() + w.bd > 0)
                            != (ffb.density_pre(x7, w.wd, w.bd) > 0)).sum())
        del x7
    out = {"seed": seed, "k1_readings": {}, "density_sign_flips_matmul_order": matmul_flips}
    out["k1_readings"]["outputs"], fails = checks.k1_failures("training", k1_out, plain_out)
    out["k1_readings"]["stash"], f = checks.k1_stash_failures(acts, plain_acts)
    fails = [f"K1 fit: {x}" for x in fails + f]
    del k1_out, plain_out, plain_acts
    for mode in checks.K2_FIT_MODES:
        kw = {"stash": acts, "dens_vpu": True} if mode == "stash_dens_vpu" else {}
        with torch.no_grad():
            got = ffb.fused_field_backward(*args, *cot, **kw)
            again = ffb.fused_field_backward(*args, *cot, **kw)
            torch.cuda.synchronize()
            want = ffb.fused_field_backward_reference(*args, *cot, **kw)
            want64 = ffb.fused_field_backward_reference(*args, *cot, dtype=torch.float64, **kw)
        exact = ffb.fused_field_backward_unrounded(*args, *cot)
        readings, f = checks.k2_fit_failures(mode, got, want)
        ratio, exempt = checks.K2_FIT_TRUTH[mode]
        dist, ft = checks.truth_failures(got, want, want64, exact, ratio, exempt)
        f += ft
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            f.append("two launches on the same inputs differ")
        del want64, exact
        out[mode] = {"readings": readings, "unrounded_distance": dist,
                     "max_abs_err": float(max((a - b).abs().max() for a, b in zip(got, want)))}
        if kw:
            flips = checks.density_mask_flips(got, want)
            out[mode]["density_mask_flips"] = flips
            if flips:
                f.append(f"the density masks of kernel and plain version differ at {flips} points")
        with torch.no_grad():
            ms = cuda_ms(lambda: ffb.fused_field_backward(*args, *cot, **kw), iters)
            plain_ms = cuda_ms(lambda: ffb.fused_field_backward_reference(*args, *cot, **kw),
                               max(2, iters // 4), warmup=1)
        bound_ms, bound_by = (k2_stash_bound(args, cot, acts, got) if kw
                              else k2_bound(args, cot, got))
        out[mode].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        print(f"K2 fit case (B=1) {mode}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        fails += [f"K2 fit {mode}: {x}" for x in f]
        del got, again, want
    print(json.dumps({"k2_fit_case": out}))
    check(not fails, "\n".join(fails))
    return out


def eval_batches(seed, n, size, featmap_size):
    """``n`` single-image batches of :func:`synthetic_batch` (seeds ``seed``
    on), each with 68 landmarks whose six face-normalization rows are the
    face model's projection through the batch's camera from a plausible
    head pose (the face 1 m away), and a camera index."""
    import numpy as np

    from gazenerf_tpu_torch.data.face_model import FACE_MODEL_3D
    from gazenerf_tpu_torch.preprocess.normalize import project_points

    out = []
    for i in range(n):
        b = synthetic_batch(seed + i, 1, size, featmap_size)
        rng = np.random.default_rng(seed + 100 + i)
        lm = rng.uniform(0.2 * size, 0.8 * size, (1, 68, 2))
        pose = rng.normal(0, 0.15, 3), np.array([rng.normal(0, 20), rng.normal(0, 20), 1000.0])
        lm[0, [36, 39, 42, 45, 31, 35]] = project_points(
            FACE_MODEL_3D[[20, 23, 26, 29, 15, 19]], *pose, b["inmat"][0].astype(np.float64))
        b["landmarks"] = lm.astype(np.float32)
        b["cam_index"] = np.array([[i % 18]], np.int64)
        out.append(b)
    return out


def gif_images(path):
    """The image blocks of a GIF file, counted by walking its blocks; raises
    where the file is not GIF89a or a block is malformed."""
    with open(path, "rb") as f:
        data = f.read()
    check(data[:6] == b"GIF89a", f"{path}: not GIF89a")
    pos = 13 + (3 << ((data[10] & 7) + 1) if data[10] & 0x80 else 0)

    def skip_sub_blocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    images = 0
    while data[pos] != 0x3B:
        if data[pos] == 0x21:  # extension: label, sub-blocks
            pos = skip_sub_blocks(pos + 2)
        elif data[pos] == 0x2C:  # image: descriptor, local table, LZW size, sub-blocks
            flags = data[pos + 9]
            pos += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)
            images += 1
        else:
            raise RuntimeError(f"{path}: unknown block 0x{data[pos]:02x} at byte {pos}")
    return images


def phase_eval(seed, fit_steps, card):
    """Single-image fitting, gaze optimization, the protocols and the demo
    GIFs at full width, in the configuration the evaluation CLIs build
    (``cli/evaluate_metrics.py``'s defaults: bf16 fields and renderer,
    ``phase_gm``, ``--pallas_tuning auto``'s stash and ``dens_vpu``; 4096
    rays x 64 samples, hidden 384, 512x512, B=1), seeded weights and
    synthetic batches (:func:`eval_batches`).  Checks, each raising:

    1. fit: ``fit_steps`` steps with launch counts (K1 and K2 twice a
       step), finite losses, the last below the first; ms per step and both
       memory peaks;
    2. one fit step's gradients with the kernels against the plain
       versions, per parameter group, within ``GRAD_REL_L2``;
    3. K2 at B=1 (:func:`phase_k2_fit`);
    4. predict with a gaze override equals the model forward's
       ``merge_img`` on the same codes, camera and gaze, to the bit;
    5. gaze optimization from g* + (0.1, -0.1) towards a target rendered
       at g*, 30 steps: the best loss below the first, and the gradient at
       the start with the kernels within ``EVAL_DGAZE_REL_L2`` of the plain
       versions'; ms per step;
    6. the protocols (input-target on 2 pairs with 5 fit steps, consistency,
       gaze transfer; personal calibration where h5py is installed) with a
       seeded GazeResNet and LPIPS on a seeded VGG16: every metric finite,
       under the JAX package's keys; ms per pair, the estimator's and
       LPIPS's ms per image; then input-target again with exact FID and
       the identity pipeline (:func:`phase_metric_nets`);
    7. the render loops (5 orbit views, the 44-frame gaze sweep) to GIFs:
       each parses as GIF89a with one image per frame; render and encode
       ms per frame.

    Then where a fit step's time goes (``phase_step_breakdown`` at B=1).
    Prints the ``eval`` line and returns K1's and K2's launches per fit
    step and in the input-target protocol with the metric nets
    (:func:`phase_metric_nets`)."""
    import os
    import statistics
    import tempfile

    import numpy as np
    import torch

    from gazenerf_tpu_torch.cli.common import config_from_args
    from gazenerf_tpu_torch.cli.evaluate_metrics import _parser
    from gazenerf_tpu_torch.eval import metrics as M
    from gazenerf_tpu_torch.eval import protocols as P
    from gazenerf_tpu_torch.eval.render_loops import RenderLoops, save_gif
    from gazenerf_tpu_torch.kernels import checks
    from gazenerf_tpu_torch.models.resnet import GazeResNet
    from gazenerf_tpu_torch.models.vgg import VGG16Features
    from gazenerf_tpu_torch.ops.rays import pixel_grid
    from gazenerf_tpu_torch.train import fitting
    from gazenerf_tpu_torch.train.state import make_optimizer
    from gazenerf_tpu_torch.train.trainer import Trainer, compose_codes_and_cams, make_train_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = config_from_args(_parser().parse_args(["--seed", str(seed)]))
    m = cfg.model
    check(m.compute_dtype == m.renderer_dtype == "bfloat16" and m.shuffle_mode == "phase_gm"
          and m.pallas_stash_acts and m.pallas_dens_vpu, f"eval: the CLI config is {m}")
    trainer = Trainer(cfg, train_len=1, steps_per_epoch=1, seed=seed)
    random_biases_(trainer.model, torch.Generator().manual_seed(seed + 3))
    base = fitting.FitState.of(trainer)
    expr = trainer.expr_fix
    frozen = trainer.frozen
    batches = eval_batches(seed, 4, m.pred_img_size, m.featmap_size)
    out = {"card": card, "config": "cli/evaluate_metrics.py defaults: " + ", ".join(
        f"{k}={getattr(m, k)}" for k in ("compute_dtype", "renderer_dtype", "shuffle_mode",
                                         "pallas_stash_acts", "pallas_dens_vpu", "featmap_size",
                                         "num_sample_coarse", "mlp_hidden", "pred_img_size")
    ) + "; B=1"}

    def sync_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    # 1. fit
    fit = fitting.make_fit_single_image(cfg, frozen, expr, fit_steps)
    fitting.make_fit_single_image(cfg, frozen, expr, 2)(base, batches[0])  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()  # counts from here on are the main path's
    (fitted, losses), fit_ms = sync_ms(lambda: fit(base, batches[0]))
    launches = launch_counts()
    losses = losses.tolist()
    want = expected_launches(m, fit_steps, train=True)
    check(launches == want, f"eval fit: {fit_steps} steps launched {launches} (expected {want})")
    check(all(np.isfinite(losses)), f"eval fit: losses {losses}")
    check(losses[-1] < losses[0], f"eval fit: the loss did not fall: {losses}")
    out["fit"] = {"steps": fit_steps, "ms_per_step": fit_ms / fit_steps, "losses": losses,
                  "launches_per_step": {k: v / fit_steps for k, v in launches.items() if v},
                  "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                  "peak_requested_bytes": torch.cuda.memory_stats()["requested_bytes.all.peak"]}
    print(f"eval fit: {fit_steps} steps, {fit_ms / fit_steps:.1f} ms a step, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")

    # 2. one fit step's gradients, kernels vs plain versions: the fit's
    # training step on the base model and copies of its offsets, stopped
    # after the backward
    b0 = fitting.single_batch(batches[0], dev)
    expr_t = torch.as_tensor(expr, device=dev)
    t_rand = torch.rand((1, m.num_rays, m.num_sample_coarse + 1),
                        generator=torch.Generator(device=dev).manual_seed(seed + 7), device=dev)
    offsets = torch.nn.ParameterDict({k: torch.nn.Parameter(v.detach().clone())
                                      for k, v in base.offsets.items()})
    params = list(base.model.parameters())
    opt, sched = make_optimizer(cfg.train, 10**9, {"net": params, **{k: [p] for k, p in
                                                                       offsets.items()}})
    grad_step = make_train_step(cfg, base.model, opt, sched, frozen, expr, offsets)

    def fit_grads():
        grad_step(b0, t_rand=t_rand, update=False)
        out_ = {"net": torch.cat([p.grad.reshape(-1).float() for p in params])}
        out_.update({k: p.grad.reshape(-1).float() for k, p in offsets.items()})
        return out_

    reset_launch_counts()
    with_kernels = fit_grads()
    used = launch_counts()
    check(used == expected_launches(m, 1, train=True), f"eval: the fit step launched {used}")
    with checks.plain_versions():
        reset_launch_counts()
        plain = fit_grads()
        check(not any(launch_counts().values()), "eval: the plain fit step launched a kernel")
    opt.zero_grad(set_to_none=True)
    grad_rel = {g: float((with_kernels[g] - plain[g]).norm() / plain[g].norm()) for g in plain}
    bad = {g: r for g, r in grad_rel.items() if not r <= GRAD_REL_L2[g]}
    check(not bad, f"eval: fit step gradients, kernels vs plain, over the limits: {bad}")
    out["fit"]["grad_rel_l2_kernel_vs_plain"] = grad_rel
    print(f"eval fit step gradients, kernels vs plain: {grad_rel}")

    # 3. K2 at B=1
    out["k2_fit"] = phase_k2_fit(seed, 8)

    # 4. predict with a gaze override against the model forward
    predict = fitting.make_predict_single_image(cfg, expr)
    g_star = torch.tensor([0.15, -0.2], device=dev)
    reset_launch_counts()
    img, predict_ms = sync_ms(lambda: predict(base, batches[1], g_star))
    check(launch_counts()["fused_field_fwd"] == 2, "eval: predict did not launch K1 twice")
    b1 = fitting.single_batch(batches[1], dev)
    with torch.no_grad():
        sc, ac, _, R, T, K, _, _ = compose_codes_and_cams(cfg, b1, base.offsets, expr_t)
        xy = pixel_grid(m.featmap_size, device=dev)[None]
        ref = base.model(xy, sc, ac, g_star[None], R, T, K)["coarse_dict"]["merge_img"]
    check(torch.equal(img, ref), "eval: predict with an override differs from the forward")
    out["predict"] = {"ms": predict_ms, "equal_to_forward": True}

    # 5. gaze optimization towards a target rendered at g*
    target = dict(batches[1], image=img.float().cpu().numpy())
    start = g_star + torch.tensor([0.1, -0.1], device=dev)
    bt = fitting.single_batch(target, dev)

    def gaze_grad():
        gaze = start.clone().requires_grad_(True)
        loss = fitting.single_image_loss(cfg, frozen, expr_t, base.model, base.offsets, bt, gaze)
        return loss.item(), torch.autograd.grad(loss, [gaze])[0]

    first_loss, dgaze = gaze_grad()
    with checks.plain_versions():
        _, dgaze_plain = gaze_grad()
    dgaze = {"kernels": dgaze, "plain": dgaze_plain}
    dgaze_rel = float((dgaze["kernels"] - dgaze["plain"]).norm() / dgaze["plain"].norm())
    check(dgaze_rel <= EVAL_DGAZE_REL_L2,
          f"eval: dgaze kernels vs plain {dgaze_rel:.3e} (limit {EVAL_DGAZE_REL_L2})")
    optimize = fitting.make_optimize_gaze(cfg, frozen, expr, max_steps=30)
    reset_launch_counts()
    (best_gaze, best_loss, steps), opt_ms = sync_ms(lambda: optimize(base, target, start))
    opt_launches = launch_counts()
    check(opt_launches["fused_field_fwd"] == opt_launches["fused_field_bwd"] == 2 * steps,
          f"eval: {steps} gaze steps launched {opt_launches}")
    check(best_loss.item() < first_loss, f"eval: gaze loss {first_loss} -> {best_loss.item()}")
    out["gaze_opt"] = {"steps": steps, "ms_per_step": opt_ms / steps, "first_loss": first_loss,
                       "best_loss": best_loss.item(), "start": start.tolist(),
                       "best_gaze": best_gaze.tolist(), "target_gaze": g_star.tolist(),
                       "dgaze_rel_l2_kernel_vs_plain": dgaze_rel, "dgaze": dgaze["kernels"].tolist()}
    print(f"eval gaze optimization: {steps} steps, {opt_ms / steps:.1f} ms a step, loss "
          f"{first_loss:.5f} -> {best_loss.item():.5f}, dgaze kernels vs plain {dgaze_rel:.3e}")

    # 6. the protocols
    gen = torch.Generator().manual_seed(seed + 11)
    estimator = GazeResNet()
    with torch.no_grad():  # seeded: N(0, 1/fan in) weights, batch-norm scales near 1
        for name, p in estimator.named_parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=gen) * p[0].numel() ** -0.5)
            else:
                p.copy_(float(name.endswith("weight")) + 0.1 * torch.randn(p.shape, generator=gen))
    estimator.to(dev).requires_grad_(False).eval()
    lpips_vgg = VGG16Features()
    lpips_vgg.reset_parameters(torch.Generator().manual_seed(seed + 12))
    lpips_fn = M.make_lpips_fn(lpips_vgg.state_dict(), device=dev)
    ctx = P.EvalContext(
        cfg=cfg, base_state=base, fit=fitting.make_fit_single_image(cfg, frozen, expr, 5),
        predict=predict, optimize_gaze=optimize, estimator_fn=torch.no_grad()(estimator),
        feats_fn=frozen.vgg_capture_fn(), lpips_fn=lpips_fn, normalizer=P.make_eval_normalizer())
    x224 = torch.rand((1, 224, 224, 3), device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    est_ms = statistics.median(sync_ms(lambda: ctx.estimator_fn(x224))[1] for _ in range(5))
    img01 = img.float()
    lpips_ms = statistics.median(sync_ms(lambda: lpips_fn(img01, img01))[1] for _ in range(5))
    pairs = [{"input": batches[0], "target": batches[1]},
             {"input": batches[2], "target": batches[3]}]
    res_it, it_ms = sync_ms(lambda: P.evaluate_input_target_images(ctx, pairs))
    keys = {"ssim", "psnr", "l1", "lpips", "fid", "gaze_angular_deg", "head_angular_deg",
            "num_pairs", "lpips_backend", "fid_backend"}
    check(keys <= set(res_it), f"eval input_target: keys {sorted(res_it)}")
    res_cons, cons_ms = sync_ms(lambda: P.evaluate_consistency(ctx, batches[:3]))
    res_gt, gt_ms = sync_ms(lambda: P.evaluate_gaze_transfer(ctx, batches[0], batches[2]))
    numbers = [v for r in (res_it, res_cons) for v in r.values() if not isinstance(v, str)]
    numbers += [res_gt["opt_loss"], *res_gt["gaze"].tolist()]
    check(all(np.isfinite(numbers)), f"eval: protocol metrics {res_it} {res_cons} {res_gt}")
    check(bool(np.isfinite(res_gt["transferred_image"]).all()), "eval: gaze transfer image")
    out["metric_nets"] = phase_metric_nets(seed, ctx, pairs, dev)
    out["protocols"] = {
        "input_target": {**res_it, "ms_per_pair": it_ms / len(pairs)},
        "consistency": {**res_cons, "ms": cons_ms, "frames": 2},
        "gaze_transfer": {"opt_loss": res_gt["opt_loss"], "opt_steps": res_gt["opt_steps"],
                          "ms": gt_ms},
        "estimator_ms_per_image": est_ms, "lpips_ms_per_image": lpips_ms / 2,
    }
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("eval personal_calibration: not run: h5py is not installed here")
    else:
        with tempfile.TemporaryDirectory() as tmp:
            r, pc_ms = sync_ms(lambda: P.evaluate_personal_calibration(
                ctx, batches, [0], os.path.join(tmp, "calib.h5")))
        check(r["face_patch"].shape == (4, 224, 224, 3), "eval personal_calibration: frames")
        out["protocols"]["personal_calibration"] = {"frames": r["num_frames"], "ms": pc_ms}
    print(f"eval protocols: input_target {it_ms / len(pairs):.1f} ms a pair, consistency "
          f"{cons_ms:.1f} ms, gaze transfer {gt_ms:.1f} ms; estimator {est_ms:.2f} ms, LPIPS "
          f"{lpips_ms / 2:.2f} ms an image")

    # 7. render loops and GIFs
    loops = RenderLoops(m, view_num=5)
    sc, ac, *_ = compose_codes_and_cams(cfg, b1, fitted.offsets, expr_t)
    reset_launch_counts()
    frames = {}
    render_ms = 0.0
    for name, fn in (("both", lambda: loops.render_novel_views(fitted.model, sc, ac)),
                     ("gaze", lambda: loops.render_gaze_sweep(fitted.model, sc, ac))):
        frames[name], ms = sync_ms(fn)
        render_ms += ms
    n_frames = sum(len(f) for f in frames.values())
    check(launch_counts()["fused_field_fwd"] == 2 * n_frames, "eval: render loops' K1 launches")
    encode_ms = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        for name, fr in frames.items():
            path = os.path.join(tmp, f"subject_fitted_{name}.gif")
            t0 = time.perf_counter()
            save_gif(path, fr)
            encode_ms += (time.perf_counter() - t0) * 1e3
            n = gif_images(path)
            check(n == len(fr), f"eval: {path} holds {n} images for {len(fr)} frames")
    check(len(frames["gaze"]) == 44 and len(frames["both"]) == 5, "eval: frame counts")
    out["render_loops"] = {"frames": n_frames, "render_ms_per_frame": render_ms / n_frames,
                           "gif_encode_ms_per_frame": encode_ms / n_frames}
    print(f"eval render loops: {n_frames} frames, render {render_ms / n_frames:.1f} ms and GIF "
          f"encode {encode_ms / n_frames:.1f} ms a frame")

    # where a fit step's time goes: the training step at B=1 on the base
    # state is a fit step (its Adam runs over the base's own parameters)
    out["fit"]["breakdown"] = phase_step_breakdown(trainer, batches[0])
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"eval": out}))
    del trainer, base, fitted, ctx
    torch.cuda.empty_cache()
    return out["fit"]["launches_per_step"], out["metric_nets"]["input_target_exact"]["launches"]


def phase_metric_nets(seed, ctx, pairs, dev):
    """Exact FID and the FaceX-Zoo identity pipeline in the evaluation's
    input-target protocol.  Seeded state dicts in the upstream layouts
    (``models/seeding.py``; RetinaFace's class head decisive, PFLD's
    landmarks inside the crop) go through ``torch.save`` and the CLI's
    loaders (``build_fid_features``, ``build_identity_pipeline``) onto the
    card.  Checks, each raising: every net's output on the card within
    ``METRIC_NET_REL_L2`` of the same module's on the CPU on the same input;
    the detector's best face score and every other anchor's clear of the
    0.7 threshold; the pipeline called once outside the protocol; the
    protocol on ``pairs`` with both hooks: ``fid`` from the exact backend,
    ``identity_similarity``, every number finite.  Times: InceptionV3's ms
    an image at B=8 (512 -> 299), the pipeline's ms a pair by stage, the
    protocol's ms a pair.  Returns the ``metric_nets`` part of the ``eval``
    line."""
    import dataclasses
    import os
    import statistics
    import tempfile

    import numpy as np
    import torch

    from gazenerf_tpu_torch.cli.evaluate_metrics import (
        build_fid_features,
        build_identity_pipeline,
        set_eval_precision,
    )
    from gazenerf_tpu_torch.eval import protocols as P
    from gazenerf_tpu_torch.models.face_alignment import PFLDAligner
    from gazenerf_tpu_torch.models.face_detection import DET_CFG, RetinaFaceDetector
    from gazenerf_tpu_torch.models.face_recognition import arcface_crop, make_identity_embed_fn
    from gazenerf_tpu_torch.models.inception import InceptionV3FID, make_fid_features_fn
    from gazenerf_tpu_torch.models.seeding import seed_frozen_net_, seeded_identity_state_dicts

    set_eval_precision("highest")
    inc = seed_frozen_net_(InceptionV3FID(), torch.Generator().manual_seed(seed + 13)).state_dict()
    ids = seeded_identity_state_dicts(torch.Generator().manual_seed(seed + 14))
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, f"{k}.pth") for k in ("inception", *ids)}
        torch.save(inc, paths["inception"])
        for k, sd in ids.items():
            torch.save(sd, paths[k])
        fid_fn = build_fid_features(paths["inception"], dev)
        pipe = build_identity_pipeline(paths["embed"], paths["detector"], paths["aligner"], dev)
    det, al = pipe.detector, pipe.aligner
    cpu = {"fid": make_fid_features_fn(inc, "cpu"),
           "detector": RetinaFaceDetector(ids["detector"], "cpu"),
           "aligner": PFLDAligner(ids["aligner"], "cpu"),
           "embed": make_identity_embed_fn(ids["embed"], "cpu")}

    def sync_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    def rel(card, host):
        card = torch.cat([t.reshape(-1) for t in card]).double().cpu()
        host = torch.cat([t.reshape(-1) for t in host]).double()
        return float((card - host).norm() / host.norm())

    # each net on the card against the CPU, on the protocol's first pair
    pair0 = pairs[0]
    tgt0 = P._single(pair0["target"])
    gt0 = P._whiten_nonhead(tgt0, dev)
    pred0 = torch.nan_to_num(ctx.predict(ctx.base_state, tgt0), nan=1.0)
    img = P._resize224_u8(pred0)
    x_det = img.float() - torch.tensor((104.0, 117.0, 123.0), device=dev)
    with torch.no_grad():
        heads = det.net(x_det.permute(2, 0, 1)[None])
        heads_cpu = cpu["detector"].net(x_det.cpu().permute(2, 0, 1)[None])
    dets = det(img)
    check(len(dets) > 0, "metric nets: the detector found no face on the protocol's image")
    scores = heads[1][0, :, 1].float().cpu()
    face = torch.zeros_like(scores, dtype=torch.bool)
    face.view(-1, 2)[:, 0] = True  # the first anchor of each position ...
    level1 = slice(2 * 28 * 28, 2 * (28 * 28 + 14 * 14))  # ... of the stride-16 level (224^2)
    mask = torch.zeros_like(face)
    mask[level1] = face[level1]
    best, others = float(scores[mask].max()), float(scores[~mask].max())
    thr = DET_CFG["confidence_threshold"]
    check(best >= thr + 0.1 and others <= thr - 0.1,
          f"metric nets: face score {best:.4f}, other anchors' best {others:.4f} against {thr}")
    crop, _, _ = al.crop(img, dets[0])
    inp = (crop.float() / 255.0).permute(2, 0, 1)[None]
    with torch.no_grad():
        lm, lm_cpu = al.net(inp), cpu["aligner"].net(inp.cpu())
    lms = lm.cpu().numpy().reshape(-1, 2)
    face112 = (arcface_crop(img, al(img, dets[0])).float() / 255.0)[None]
    x8 = torch.rand((8, 512, 512, 3), generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev)
    readings = {
        "inception": rel([fid_fn(x8[:2])], [cpu["fid"](x8[:2].cpu())]),
        "retinaface": rel(heads, heads_cpu),
        "pfld": rel([lm - al.net.fc.bias], [lm_cpu - cpu["aligner"].net.fc.bias]),
        "mobilefacenet": rel([pipe.embed_fn(face112)], [cpu["embed"](face112.cpu())]),
    }
    print(f"metric nets, card vs CPU, relative L2: {readings} (limits {METRIC_NET_REL_L2})")
    bad = {k: v for k, v in readings.items() if not v <= METRIC_NET_REL_L2[k]}
    check(not bad, f"metric nets: card vs CPU over the limits {METRIC_NET_REL_L2}: {bad}")
    check(bool(np.isfinite(lms).all()), "metric nets: PFLD landmarks")

    # the pipeline once outside the protocol's catch
    direct = pipe(P._resize224_u8(gt0), img)
    check(np.isfinite(direct) and -1.0 <= direct <= 1.0, f"metric nets: pipeline gave {direct}")

    # times: InceptionV3 at B=8, the pipeline's stages on one pair
    fid_fn(x8)
    inc_ms = statistics.median(sync_ms(lambda: fid_fn(x8))[1] for _ in range(5)) / 8
    a, b = P._resize224_u8(gt0), img
    stage_ms = {"detect": [], "align": [], "crop": [], "embed": [], "pair": []}
    for _ in range(5):
        parts = dict.fromkeys(stage_ms, 0.0)
        for im in (a, b):
            d, ms = sync_ms(lambda: det(im))
            parts["detect"] += ms
            lm_i, ms = sync_ms(lambda: al(im, d[0]))
            parts["align"] += ms
            c, ms = sync_ms(lambda: arcface_crop(im, lm_i))
            parts["crop"] += ms
            _, ms = sync_ms(lambda: pipe.embed_fn((c.float() / 255.0)[None]))
            parts["embed"] += ms
        parts["pair"] = sync_ms(lambda: pipe(a, b))[1]
        for k, v in parts.items():
            stage_ms[k].append(v)
    stage_ms = {k: statistics.median(v) for k, v in stage_ms.items()}

    # the protocol with both hooks
    log = []

    def recording(x, y):
        try:
            score = pipe(x, y)
        except (ValueError, np.linalg.LinAlgError):
            log.append({"stages": "failed", "score": -0.1})
            raise
        log.append({"stages": list(pipe.last_stages), "score": score})
        return score

    ctx2 = dataclasses.replace(ctx, fid_feats_fn=fid_fn, identity_pipeline=recording,
                               identity_valid=True)
    reset_launch_counts()  # this slice's main path: the protocol with both hooks
    res, it_ms = sync_ms(lambda: P.evaluate_input_target_images(ctx2, pairs))
    launches = launch_counts()
    m = ctx.cfg.model
    want = expected_launches(m, 5 * len(pairs), train=True)  # each pair's 5-step fit ...
    want["fused_field_fwd"] += 2 * len(pairs)  # ... and its prediction's two K1
    check(launches == want, f"metric nets: input_target launched {launches} (expected {want})")
    res["identity_similarity_valid"] = ctx2.identity_valid  # as the CLI reports it
    check(res.get("fid_backend") == "exact" and "fid" in res and "identity_similarity" in res,
          f"metric nets: input_target gave {sorted(res)}")
    numbers = [v for v in res.values() if not isinstance(v, (str, bool))]
    check(all(np.isfinite(numbers)), f"metric nets: input_target {res}")
    failed = sum(r["score"] == -0.1 for r in log)
    print(f"metric nets: input_target with exact FID {res['fid']:.4f} and identity "
          f"{res['identity_similarity']:.6f}, {it_ms / len(pairs):.1f} ms a pair; stages per "
          f"pair {[r['stages'] for r in log]}, {failed} pairs at -0.1; InceptionV3 "
          f"{inc_ms:.2f} ms an image (B=8, 512 -> 299); identity pipeline ms a pair {stage_ms}")
    return {
        "card_vs_cpu_rel_l2": readings, "limit": METRIC_NET_REL_L2,
        "detector_scores": {"face_best": best, "other_anchors_best": others, "threshold": thr},
        "input_target_exact": {**res, "ms_per_pair": it_ms / len(pairs), "pairs": log,
                               "pairs_at_minus_0_1": failed,
                               "launches": {k: v for k, v in launches.items() if v}},
        "inception_ms_per_image_b8": inc_ms,
        "identity_ms_per_pair": stage_ms,
        "pipeline_direct": direct,
    }


# the offline data factory's phase: the segmentation nets' logits card
# against CPU (TF32 off), relative L2; the full-width NL-3DMM fit at 2 + 2
# steps (B=2) card against CPU: each step's loss, relative, and the codes
# and cameras, relative L2 (the slack is the normals' atomic scatter-add)
PRE_NET_REL_L2 = 1e-5
PRE_FIT_LOSS_RTOL = 1e-4
PRE_FIT_REL_L2 = 1e-3
# the full-width case (SURVEY.md: the decoder 179 -> 1024 -> 3 x 34,650;
# a closed mesh of V vertices has 2 V - 4 triangles), the CLI's fit size,
# one ETH-XGaze capture of 18 cameras, upstream's 50 + 200 steps
PRE_BASIS = (34650, 69296)
PRE_FIT_SIZE = 128
PRE_FIT_B = 18
# the masks card against CPU: a label flips only where the top two logits
# lie within the nets' card-vs-CPU error, at most this share of the pixels
PRE_MASK_SHARE = 1e-3


def _fit_case(fitter, B, seed):
    """A reachable fit target for ``fitter``: frames rendered from seeded
    codes (small identity, expression and texture codes, the ambient light
    plus a little SH) and camera offsets about the driver's base camera
    (``(0, 0, 12)``, the normalized focal 1600 scaled to the fit's size),
    and their projected landmarks.  Returns ``fit``'s arguments (numpy)."""
    import numpy as np
    import torch

    from gazenerf_tpu_torch.nl3dmm.face_model import init_illu_code

    rng = np.random.default_rng(seed)
    S = fitter.cfg.image_size
    f = 1600.0 * S / 512
    inmat = np.tile(np.array([[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]], np.float32), (B, 1, 1))
    base_R = np.tile(np.diag([1.0, -1.0, -1.0]).astype(np.float32), (B, 1, 1))
    base_T = np.tile(np.array([0, 0, 12.0], np.float32), (B, 1))
    code = np.concatenate([rng.normal(0, 0.3, (B, 279)),
                           init_illu_code(B).numpy() + rng.normal(0, 0.05, (B, 27))], 1)
    dev = fitter.device
    cams = {"base_w2c_R": torch.as_tensor(base_R, device=dev),
            "base_w2c_T": torch.as_tensor(base_T, device=dev),
            "inmat": torch.as_tensor(inmat, device=dev),
            "delta_euler": torch.as_tensor(rng.normal(0, 0.05, (B, 3)), dtype=torch.float32,
                                           device=dev),
            "delta_tvec": torch.as_tensor(rng.normal(0, 0.1, (B, 3)), dtype=torch.float32,
                                          device=dev)}
    with torch.no_grad():
        img, _, lm, _ = fitter._render(torch.as_tensor(code, dtype=torch.float32, device=dev),
                                       cams)
    return img.cpu().numpy(), lm.cpu().numpy(), base_R, base_T, inmat


def phase_preprocess(seed, card):
    """The offline data factory on the card (``preprocess/``, ``nl3dmm/``),
    no kernel of the port on its path.  Checks, each raising:

    1. the seeded BiSeNet and U-Net (``models/seeding``) at 512^2, card
       against CPU: logits within ``PRE_NET_REL_L2``; their ms by CUDA
       events and their kernels' device ms under ``torch.profiler``;
    2. ``process_frame`` on two synthetic frames on the card against the
       CPU, with both nets: an ETH-XGaze camera 03 frame (1200 x 1800,
       undistorted and turned 180 degrees, the CSV pose) and a Columbia raw
       frame (3456 x 5184, cropped and area-resized): the face patch within
       the warp's bound (1 level on 1e-3 of the pixels), the masks within
       ``PRE_MASK_SHARE``, every other field equal; ms per frame;
    3. the full-width NL-3DMM fit (``PRE_BASIS``, 128^2, 16-px tiles, 64
       triangles a tile) at 2 + 2 steps, B=2, card against CPU on the same
       seeded decoder and target: losses within ``PRE_FIT_LOSS_RTOL``,
       codes and cameras within ``PRE_FIT_REL_L2``;
    4. the full fit, B=18, 50 + 200 steps: finite losses, the last below
       the first; host ms per step and peak allocated GB of that fit;
       device ms per step and busy share (device ms over wall ms) of a
       2 + 3 step fit under ``torch.profiler``; then the
       rasterizer's forward and backward, the binning's stable sort and a
       fit step's top kernels, device time at B=18.

    No h5py on the card's machine: the subject writer does not run here."""
    import copy

    import numpy as np
    import torch

    from gazenerf_tpu_torch.cli.preprocess import DEFAULT_FACE_MODEL
    from gazenerf_tpu_torch.models.seeding import seed_frozen_net_
    from gazenerf_tpu_torch.nl3dmm.face_model import random_basis
    from gazenerf_tpu_torch.nl3dmm.fitting import FitConfig, NL3DMMFitter
    from gazenerf_tpu_torch.nl3dmm.rasterizer import (
        RasterSettings,
        project_vertices,
        render_mesh,
        tile_areas,
    )
    from gazenerf_tpu_torch.preprocess import driver, masks
    from gazenerf_tpu_torch.preprocess.bisenet import BiSeNet
    from gazenerf_tpu_torch.preprocess.landmarks import LandmarkDetector
    from gazenerf_tpu_torch.preprocess.unet import UNet

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    out = {"card": card}
    g = torch.Generator().manual_seed(seed)

    # 1. the segmentation nets at 512^2
    nets = {"bisenet": seed_frozen_net_(BiSeNet(), g).eval(),
            "unet": seed_frozen_net_(UNet(), g).eval()}
    x = torch.rand(1, 3, 512, 512, generator=g)
    xd = x.to(dev)
    out["nets"] = {}
    for name, net in nets.items():
        card_net = copy.deepcopy(net).to(dev)
        with torch.no_grad():
            want = net(x)
            got = card_net(xd).cpu()
            # events span the host's launches too; the profile sums the
            # kernels' own device time
            ms = cuda_ms(lambda: card_net(xd), iters=5)
            dev_ms = device_profile(lambda: card_net(xd))["device_ms"]
        err = rel_l2(got, want)
        out["nets"][name] = {"card_vs_cpu_rel_l2": err, "event_ms_512": ms,
                             "device_ms_512": dev_ms}
        print(f"preprocess {name}: logits card vs CPU rel L2 {err:.3e} "
              f"(limit {PRE_NET_REL_L2}), {ms:.3f} ms by events, {dev_ms} device ms at 512^2")
        check(err <= PRE_NET_REL_L2, f"{name}: card vs CPU logits rel L2 {err:.3e}")
    sds = {k: v.state_dict() for k, v in nets.items()}

    # 2. process_frame, card against CPU
    rng = np.random.default_rng(seed)

    def frame(h, w):
        yy, xx = np.mgrid[:h, :w]
        img = np.stack([(xx // 3 + yy // 5) % 256, (yy // 2) % 256, ((xx - yy) // 4) % 256], -1)
        return (img * 0.7 + rng.random((h, w, 3)) * 76).astype(np.uint8)

    K_x = np.array([[1800.0, 0, 900.0], [0, 1800.0, 600.0], [0, 0, 1.0]])
    frames = {
        "xgaze_cam03": (frame(1200, 1800), K_x, dict(
            cam_index=3, dist_coeffs=np.array([[-0.05], [0.02], [0.001], [-0.001], [0.0]]),
            undistort=True, rotate180=True, gaze_vector=np.array([0.05, -0.02, -0.99]),
            head_pose=(np.array([0.03, -0.02, 0.03]), np.array([5.0, -3.0, 600.0])))),
        "columbia_raw": (frame(3456, 5184), np.array([[800.0, 0, 256.0], [0, 800.0, 256.0],
                                                      [0, 0, 1.0]]), dict(
            dataset="columbia", columbia_crop=True,
            pitchyaw_head_direct=np.array([0.1, -0.05], np.float32),
            head_pose=(np.array([0.0, 0.1, 0.0]), np.array([0.0, 0.0, 700.0])))),
    }
    out["process_frame"] = {}
    for where in ("cpu", "cuda"):
        bm = masks.BiSeNetMasker(sds["bisenet"], device=where)
        um = masks.UNetEyeMasker(sds["unet"], device=where)
        for name, (img, K, kw) in frames.items():
            if where == "cuda":  # a warm call, then the timed one
                driver.process_frame(img, K, DEFAULT_FACE_MODEL, LandmarkDetector(where),
                                     masker=bm, eye_masker=um, device=where, **kw)
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            row = driver.process_frame(img, K, DEFAULT_FACE_MODEL, LandmarkDetector(where),
                                       masker=bm, eye_masker=um, device=where, **kw)
            ms = (time.perf_counter() - t0) * 1e3
            out["process_frame"].setdefault(name, {})[where] = (row, ms)
    for name, res in out["process_frame"].items():
        (cpu_row, cpu_ms), (card_row, card_ms) = res["cpu"], res["cuda"]
        d = np.abs(card_row["face_patch"].astype(int) - cpu_row["face_patch"].astype(int))
        flips = {k: int((card_row[k] != cpu_row[k]).sum())
                 for k in ("head_mask", "left_eye_mask", "right_eye_mask")}
        line = {"ms_cpu": cpu_ms, "ms_card": card_ms, "face_patch_max_diff": int(d.max()),
                "face_patch_diff_share": float((d > 0).mean()), "mask_pixels_differing": flips}
        out["process_frame"][name] = line
        print(f"preprocess process_frame {name}: {json.dumps(line)}")
        check(d.max() <= 1 and (d > 0).mean() <= 1e-3, f"{name}: face patch card vs CPU {line}")
        for k, n in flips.items():
            check(n <= PRE_MASK_SHARE * card_row[k].size, f"{name}: {k} card vs CPU {n} pixels")
        for k, v in cpu_row.items():
            if k not in ("face_patch", "head_mask", "left_eye_mask", "right_eye_mask"):
                check(np.array_equal(card_row[k], v), f"{name}: {k} differs card vs CPU")
    del nets, sds

    # 3. the full-width fit, 2 + 2 steps at B=2, card against CPU
    t0 = time.perf_counter()
    basis = random_basis(*PRE_BASIS)
    out["basis_s"] = time.perf_counter() - t0
    check(tuple(basis.triangles.shape) == (PRE_BASIS[1], 3), "the basis' triangle count")
    raster = RasterSettings(image_size=PRE_FIT_SIZE)
    short = FitConfig(image_size=PRE_FIT_SIZE, stage1_steps=2, stage2_steps=2)
    card_fit = NL3DMMFitter(basis, short, raster, device="cuda")
    cpu_fit = NL3DMMFitter(basis, short, raster, decoder_params=card_fit.decoder.state_dict(),
                           device="cpu")
    case = _fit_case(card_fit, 2, seed)
    got, want = card_fit.fit(*case), cpu_fit.fit(*case)
    losses = np.concatenate([got["stage1_losses"], got["stage2_losses"]])
    cpu_losses = np.concatenate([want["stage1_losses"], want["stage2_losses"]])
    loss_rel = float(np.max(np.abs(losses - cpu_losses) / np.abs(cpu_losses)))
    errs = {k: rel_l2(torch.as_tensor(got[k]), torch.as_tensor(want[k]))
            for k in ("code", "w2c_Rmat", "w2c_Tvec", "c2w_Tvec")}
    out["fit_card_vs_cpu"] = {"losses": losses.tolist(), "loss_max_rel": loss_rel,
                              "rel_l2": errs}
    print(f"preprocess fit 2+2 card vs CPU: loss {loss_rel:.3e} (limit {PRE_FIT_LOSS_RTOL}), "
          f"{errs} (limit {PRE_FIT_REL_L2})")
    check(loss_rel <= PRE_FIT_LOSS_RTOL, f"fit losses card vs CPU {loss_rel:.3e}")
    for k, e in errs.items():
        check(e <= PRE_FIT_REL_L2, f"fit {k} card vs CPU rel L2 {e:.3e}")
    del cpu_fit

    # 4. the full fit at B=18 on the card
    fit = card_fit
    case = _fit_case(fit, PRE_FIT_B, seed + 1)
    fit.cfg = FitConfig(image_size=PRE_FIT_SIZE, stage1_steps=2, stage2_steps=3)
    fit.fit(*case)  # warm
    prof = device_profile(lambda: fit.fit(*case), top=10)
    fit.cfg = FitConfig(image_size=PRE_FIT_SIZE)
    steps = fit.cfg.stage1_steps + fit.cfg.stage2_steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fit.fit(*case)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    curve = np.concatenate([res["stage1_losses"], res["stage2_losses"]])
    check(curve.shape == (steps,) and np.isfinite(curve).all(), "full fit: a loss is not finite")
    check(curve[-1] < curve[0], f"full fit: the loss did not fall ({curve[0]} -> {curve[-1]})")
    # device ms and busy share from the profiled 2 + 3 step fit alone (its
    # own wall time, the profiler's overhead included)
    measured = prof["device_ms"] != "not measured"
    dev_ms = prof["device_ms"] / 5 if measured else "not measured"
    out["fit"] = {
        "B": PRE_FIT_B, "steps": steps, "vertices": PRE_BASIS[0], "triangles": PRE_BASIS[1],
        "image": PRE_FIT_SIZE, "host_ms_per_step": host_ms, "device_ms_per_step": dev_ms,
        "profiled_wall_ms_per_step": prof["wall_ms"] / 5,
        "busy_share": prof["device_ms"] / prof["wall_ms"] if measured else "not measured",
        "peak_allocated_gb": peak_gb, "peak_allocated_gb_per_frame": peak_gb / PRE_FIT_B,
        "loss_first": float(curve[0]), "loss_stage1_last": float(res["stage1_losses"][-1]),
        "loss_last": float(curve[-1]), "profile_2_plus_3_steps": prof}
    print(f"preprocess fit B={PRE_FIT_B}, {steps} steps: {host_ms:.3f} host ms a step, "
          f"{dev_ms} device ms, busy {out['fit']['busy_share']}, peak {peak_gb:.3f} GB; loss {curve[0]:.4f} -> {curve[-1]:.4f}")

    # the rasterizer's forward and backward, the stable sort, at B=18
    s = fit.raster
    with torch.no_grad():
        verts = fit.decoder(torch.zeros(PRE_FIT_B, 179, device=dev))
    Rm, T, K = (torch.as_tensor(a, device=dev) for a in case[2:])
    v = verts.clone().requires_grad_()
    c = torch.full_like(verts, 153.0).requires_grad_()
    tris = fit.basis.triangles
    fwd_ms = cuda_ms(lambda: render_mesh(v, c, tris, Rm, T, K, s, bg_color=255.0), iters=5)
    img, alpha = render_mesh(v, c, tris, Rm, T, K, s, bg_color=255.0)
    loss = img.mean() + alpha.mean()
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(loss, [v, c], retain_graph=True), iters=5)
    area = tile_areas(project_vertices(verts, Rm, T, K), tris, s)
    sort_ms = cuda_ms(lambda: torch.argsort(-area, dim=-1, stable=True), iters=5)
    out["parts_device_ms"] = {"rasterizer_forward": fwd_ms, "rasterizer_backward": bwd_ms,
                              "stable_sort": sort_ms, "sort_shape": list(area.shape)}
    print(f"preprocess parts (B={PRE_FIT_B}): {json.dumps(out['parts_device_ms'])}")
    del card_fit, fit, img, alpha, loss, area, v, c
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# the JPEG pixel kernel ports no Pallas kernel: the JAX package reads its
# frames with cv2.imread
JPEG_REPLACES = "none: gazenerf_tpu/preprocess/driver.py:238 (cv2.imread, libjpeg-turbo)"
# integer operations of the JPEG pixel stage, counted from jpeg_decode.cu's
# code: per 8 x 8 block the dequantization (64 products) and 16 one-pass
# IDCTs of ~44 adds, products and shifts each plus the clamps; per output
# pixel and component the upsampling (~10) and per pixel the colour
# conversion (~20).  They run on the CUDA cores, held to the f32 rate
JPEG_OPS_PER_BLOCK = 64 + 16 * 44 + 64 * 3
JPEG_OPS_PER_PIXEL = 3 * 10 + 20


def jpeg_bound(hdr):
    """The least time of the pixel stage on one frame: the coefficients
    (int16) read once and the BGR frame written once, against its integer
    operations at the CUDA cores' rate -> (ms, "bytes" or "operations")."""
    t_bytes = (hdr.n_blocks * 64 * 2 + hdr.width * hdr.height * 3) / PEAK_BYTES_PER_S
    t_ops = (hdr.n_blocks * JPEG_OPS_PER_BLOCK
             + hdr.width * hdr.height * JPEG_OPS_PER_PIXEL) / PEAK_F32_FLOPS
    return bound((t_ops,), t_bytes)


def phase_jpeg(card, iters):
    """JPEG frames on the card (``kernels/jpeg.py``: the native entropy
    decoder in host C++ and the ``jpeg_pixels`` kernel, both in
    ``csrc/jpeg_decode.cu``).  Checks, each raising:

    1. every committed fixture (``tests/data/jpeg``) decoded on the card
       equals ``cv2.imread``'s committed pixels and the CPU's plain path,
       bit for bit;
    2. each full-width strip stacked to ETH-XGaze's 6000 x 4000
       (``checks.stack_jpeg_strip``: 250 strips of 6000 x 16 at 4:2:0, 500
       of 6000 x 8 at 4:2:2, quality 90, a restart segment each): the native
       decoder's coefficients equal the plain Python decoder's for the strip
       alone in every segment; the kernel's frame equals the plain pixel
       stage run on the card on the same coefficients, and ``cv2.imread``'s
       digest of the frame (``strips.json``);
    3. the main path, counts set to 0 just before: ``read_frame`` of each
       24 MP file on the card, one ``jpeg_pixels`` launch a frame, its pixels
       those of 2.

    Times at full size (the strips carry restart markers; a file without
    them runs the same decoder loop with no marker to handle): the entropy
    decoder (host clock, median of 3), the upload of the pinned
    coefficients, the kernel (CUDA events), the copy of the frame back to
    pageable host memory, the whole ``read_frame`` (host clock, median of
    3) and frames a second; the plain pixel stage on the card."""
    import hashlib
    import os
    import statistics
    import tempfile

    import torch

    from gazenerf_tpu_torch.kernels import checks
    from gazenerf_tpu_torch.kernels import jpeg as kj
    from gazenerf_tpu_torch.preprocess.driver import read_frame
    from gazenerf_tpu_torch.utils import jpeg as J

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    out = {"card": card, "fixtures": checks.jpeg_fixture_names(), "frames": {}}
    for name in out["fixtures"]:
        fails = checks.jpeg_fixture_failures(name, dev)
        check(not fails, f"jpeg fixture: {fails}")
    print(f"jpeg: {len(out['fixtures'])} fixtures equal cv2's pixels and the plain path")
    with open(checks.JPEG_FIXTURES / "strips.json") as f:
        digests = json.load(f)
    frames = {}
    for name in sorted(checks.JPEG_STRIP_REPEATS):
        strip, frame = checks.jpeg_stacked_frame(name)
        hdr = J.parse_header(frame)
        host = torch.empty((hdr.n_blocks, 64), dtype=torch.int16, pin_memory=True)
        entropy = []
        for _ in range(3):
            t0 = time.perf_counter()
            warn = kj.entropy_decode(frame, hdr, host)
            entropy.append(1e3 * (time.perf_counter() - t0))
        check(warn == 0, f"jpeg {name}: the native decoder warns {warn}")
        fails = checks.jpeg_coefficient_failures(strip, frame, host)
        check(not fails, f"jpeg {name}: coefficients {fails}")
        coef = torch.empty(host.shape, dtype=host.dtype, device=dev)
        upload_ms = cuda_ms(lambda: coef.copy_(host, non_blocking=True), iters=5)
        got = kj.jpeg_pixels(coef, hdr)
        want = J.pixels_reference(coef, hdr)
        err = int((got.int() - want.int()).abs().max())
        check(err <= checks.JPEG_MAX_ABS_ERR,
              f"jpeg {name}: the kernel against the plain pixel stage, max abs err {err}")
        del want
        got_host = got.cpu().numpy()
        digest = hashlib.sha256(got_host.tobytes()).hexdigest()
        check(digest == digests[name]["stacked"]["sha256_bgr"],
              f"jpeg {name}: the 24 MP frame is not cv2.imread's")
        ms = cuda_ms(lambda: kj.jpeg_pixels(coef, hdr), iters)
        plain_ms = cuda_ms(lambda: J.pixels_reference(coef, hdr), 2, warmup=1)
        copy_back_ms = cuda_ms(lambda: got.cpu(), iters=5)
        bound_ms, bound_by = jpeg_bound(hdr)
        frames[name] = (frame, got_host)
        out["frames"][name] = {
            "shape": [hdr.height, hdr.width, 3], "file_bytes": len(frame),
            "coefficient_bytes": hdr.n_blocks * 128, "entropy_ms": statistics.median(entropy),
            "entropy_ms_runs": entropy, "upload_ms": upload_ms, "kernel_ms": ms,
            "copy_back_ms": copy_back_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": float(err), "equals_cv2_digest": True}
        print(f"jpeg {name} (6000 x 4000): entropy {statistics.median(entropy):.2f} ms (host), "
              f"upload {upload_ms:.3f}, kernel {ms:.4f} (bound {bound_ms:.4f}, {bound_by}), "
              f"copy back {copy_back_ms:.3f}, plain {plain_ms:.3f}")
        del coef, got, host
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, (frame, _) in frames.items():
            paths[name] = os.path.join(tmp, f"{name}.jpg")
            with open(paths[name], "wb") as f:
                f.write(frame)
        reset_launch_counts()  # counts from here on are the main path's
        for name, path in paths.items():
            img = read_frame(path, dev)
            check(img is not None and (img == frames[name][1]).all(),
                  f"jpeg {name}: read_frame's pixels")
        counts = launch_counts()
        launches = counts.pop("jpeg_pixels")
        check(launches == len(paths), f"jpeg: read_frame launched jpeg_pixels {launches} times "
                                      f"for {len(paths)} frames")
        check(not any(counts.values()), f"jpeg: read_frame launched {counts}")
        out["launches"] = launches
        out["launches_per_frame"] = launches / len(paths)
        for name, path in paths.items():
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                read_frame(path, dev)
                runs.append(1e3 * (time.perf_counter() - t0))
            line = out["frames"][name]
            line["read_frame_ms"] = statistics.median(runs)
            line["read_frame_ms_runs"] = runs
            line["frames_per_s"] = 1e3 / line["read_frame_ms"]
            print(f"jpeg {name}: read_frame {line['read_frame_ms']:.1f} ms, "
                  f"{line['frames_per_s']:.2f} frames/s")
    del frames
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20, help="timed kernel launches")
    ap.add_argument("--steps", type=int, default=5, help="timed training steps")
    ap.add_argument("--fit_steps", type=int, default=10, help="timed single-image fit steps")
    # a rank of the distributed phase: the phase starts this script with these
    ap.add_argument("--distributed_rank", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--distributed_layout", default="", help=argparse.SUPPRESS)
    ap.add_argument("--distributed_port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--distributed_dir", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.distributed_rank >= 0:
        return distributed_worker(args)
    check(args.requests >= 1, "--requests must be at least 1")
    check(args.steps >= 5, "--steps must be at least 5")
    check(args.fit_steps >= 2, "--fit_steps must be at least 2")
    import dataclasses

    from gazenerf_tpu_torch.config import ModelConfig
    from gazenerf_tpu_torch.kernels import build, checks

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # 2. build: every kernel at once, one nvcc each
    t0 = time.perf_counter()
    logs = build.build(build.every_kernel())
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in ptxas_lines(log):
            print(f"  {name}: {line}")

    # the render configuration the CLIs use: bf16 fields and renderer
    cfg = ModelConfig(compute_dtype="bfloat16", renderer_dtype="bfloat16")
    # the variants: per renderer mode, and the dual-branch field path with
    # the stash (phase_gm renderer)
    configs = {mode: dataclasses.replace(cfg, shuffle_mode=mode) for mode in MODES}
    configs[DUAL] = dataclasses.replace(cfg, **DUAL_FLAGS)
    configs[STASH] = dataclasses.replace(cfg, **STASH_FLAGS)
    configs[FUSED_F32] = dataclasses.replace(cfg, **FUSED_F32_FLAGS)
    for name, flags in (*EMBED_FLAGS.items(), *EAGER_MODES.items()):
        configs[name] = dataclasses.replace(cfg, **flags)

    def lap(phase):  # the run's wall time at the end of a phase
        print(f"chip_smoke lap: {phase} done at {time.perf_counter() - t_start:.1f} s")

    lap("build")
    # 3. kernels vs plain versions
    k1 = phase_kernels(args.seed, cfg, args.iters)
    k2 = phase_k2(args.seed, max(4, args.iters // 4))
    phase_dw(args.seed, args.iters)
    k5, k6, k7, k8 = phase_renderer_kernels(args.seed, args.iters)
    k3, k4 = phase_dual_kernels(args.seed, cfg, args.iters)
    torch.cuda.empty_cache()
    k1["stash"], k2["stash_read"], k2["split_dw"] = phase_stash_kernels(args.seed, args.iters)
    torch.cuda.empty_cache()
    k1["deep"], k2["deep"], k3_deep, k4_deep = phase_deep_kernels(args.seed, args.iters)
    torch.cuda.empty_cache()
    forms = phase_stash_forms(args.seed, args.iters)
    k1.update(forms["k1"])
    k2.update(forms["k2"])
    torch.cuda.empty_cache()
    points = phase_points_kernels(args.seed, args.iters)
    k1["points"], k2["points"] = points["k1"], points["k2"]
    k2["points_stash_read"] = points["k2_stash"]
    torch.cuda.empty_cache()

    lap("kernels")
    # 4. serving, per variant, on the same weights
    apps, serving = {}, {}
    for name, vcfg in configs.items():
        apps[name], requests, launches, times, img = phase_serving(
            args.seed, vcfg, args.requests, name)
        serving[name] = {"launches": launches, "ms_per_request": times, "image": img}
    # fused_f32 against a phase_gm app with the f32 renderer, on the same
    # weights; the embedding settings against the stash variant; every other
    # variant against phase_gm
    from gazenerf_tpu_torch import ViewerApp

    f32_app = ViewerApp(dataclasses.replace(cfg, renderer_dtype="float32"), seed=args.seed)
    random_biases_(f32_app.model, torch.Generator().manual_seed(args.seed))
    refs = {FUSED_F32: ("phase_gm_f32", f32_app.render_image(*requests[0]).float(),
                        F32_IMAGE_ATOL)}
    del f32_app
    for name in EMBED_FLAGS:
        refs[name] = (STASH, serving[STASH]["image"], EMBED_IMAGE_ATOL)
    for name in configs:
        if name == "phase_gm":
            continue
        atol = {DUAL: DUAL_IMAGE_ATOL, STASH: STASH_IMAGE_ATOL}.get(
            name, EAGER_IMAGE_ATOL if name in EAGER_MODES else MODE_IMAGE_ATOL)
        ref, ref_img, atol = refs.get(name, ("phase_gm", serving["phase_gm"]["image"], atol))
        err = float((serving[name]["image"] - ref_img).abs().max())
        serving[name][f"image_vs_{ref}_max_abs_err"] = err
        print(f"serving {name}: image vs {ref}'s max abs err {err:.3e} (atol {atol})")
        check(err <= atol, f"{name}: image vs {ref}'s max abs err {err:.3e}")
    for name in configs:
        del serving[name]["image"]
    k1["launches"] = serving["phase_gm"]["launches"]["fused_field_fwd"]
    k5["launches"] = serving["pallas"]["launches"]["shuffle_blur_fwd"]
    k7["launches"] = serving["fused"]["launches"]["fused_upsampler_fwd"]
    k5["unfolded"]["launches_per_request"] = serving["unfolded_pallas"]["launches"][
        "shuffle_blur_fwd"] / args.requests
    k7["f32"]["launches_per_request"] = serving[FUSED_F32]["launches"][
        "fused_upsampler_fwd_f32"] / args.requests
    k1["points"]["launches_per_request"] = serving[FUSE_EMBED]["launches"][
        "fused_field_fwd"] / args.requests

    # 5. breakdown
    dual_app = apps.pop(DUAL)
    for name in (STASH, *EMBED_FLAGS, *EAGER_MODES):  # field settings; the eager renderers
        del apps[name]
    line = phase_breakdown(apps, requests, smi)
    line["dual_viewer_request"] = device_profile(lambda: dual_app.render_image(*requests[0]),
                                                 top=8, mode=DUAL)
    line["modes"] = serving
    print(json.dumps({"serving": line}))
    del apps, dual_app

    lap("serving")
    # 6. training, per variant, and with the full loss stack (phase_gm, and
    # with split_dw)
    from gazenerf_tpu_torch.config import LossConfig

    training = {}
    full_loss = LossConfig(**FULL_LOSS_FLAGS)
    variants = [(name, vcfg, None) for name, vcfg in configs.items()] + [
        (FULL_LOSS, cfg, full_loss),
        (SPLIT_DW, dataclasses.replace(cfg, **SPLIT_DW_FLAGS), full_loss)] + [
        (name, dataclasses.replace(configs[STASH], **flags), None)
        for name, flags in FORM_FLAGS.items()] + [
        (name, dataclasses.replace(configs[FUSE_EMBED], **flags), None)
        for name, flags in POINTS_FORM_FLAGS.items()]
    for name, vcfg, loss in variants:
        # the eager renderer modes: one timed step, a step's device time;
        # the stash's forms: a step's device time
        eager, form = name in EAGER_MODES, name in (*FORM_FLAGS, *POINTS_FORM_FLAGS)
        training[name] = phase_training(args.seed, vcfg, 1 if eager else args.steps, name,
                                        loss=loss, breakdown=not (eager or form))
        torch.cuda.empty_cache()
    print(json.dumps({"training": {
        "card": smi,
        "config": "ModelConfig(compute_dtype=bfloat16, renderer_dtype=bfloat16, shuffle_mode=...; "
                  "dual: pallas_dual_branch=True, pallas_stash_acts=True; stash: "
                  "pallas_stash_acts=True, pallas_dens_vpu=True; split_dw: pallas_split_dw=True, "
                  "pallas_dens_vpu=True; fused_f32: shuffle_mode=fused, renderer_dtype=float32; "
                  "fuse_embed, embed_bf16: stash's and pallas_fuse_embed=True or "
                  "pallas_embed_bf16=True; phase, naive, unfolded, unfolded_pallas, rgb_nhwc: "
                  f"{EAGER_MODES}, one timed step; {', '.join(FORM_FLAGS)}: stash's and "
                  f"{FORM_FLAGS}; {', '.join(POINTS_FORM_FLAGS)}: fuse_embed's and "
                  f"{POINTS_FORM_FLAGS}), LossConfig() (full_loss and split_dw: "
                  f"LossConfig({FULL_LOSS_FLAGS}), eye importance of epoch {GRADUAL_EPOCH}), "
                  "TrainConfig(); B=2, 4096 rays x 64 samples, 512x512",
        "modes": training,
    }}))
    lap("training")
    # the deep march (S = 256) in checkpointed 512-ray chunks: the CLI's
    # --pallas_tuning auto overrides for that shape, recomputing and reading
    # the stash, without the VGG loss (the JAX bench's deep phase)
    from gazenerf_tpu_torch.cli.common import tuned_kernel_overrides

    deep_cfg = dataclasses.replace(cfg, num_sample_coarse=DEEP_SHAPE[1], **tuned_kernel_overrides(
        cfg.featmap_size, DEEP_SHAPE[1]))
    deep_training = {}
    deep_stash = dataclasses.replace(deep_cfg, pallas_stash_acts=True)
    for name, vcfg in ((DEEP, deep_cfg), (DEEP_STASH, deep_stash),
                       (DEEP_FUSE_EMBED, dataclasses.replace(deep_cfg, pallas_fuse_embed=True)),
                       *((name, dataclasses.replace(deep_stash, **flags))
                         for name, flags in DEEP_FORM_FLAGS.items())):
        deep_training[name] = phase_training(args.seed, vcfg, args.steps, name,
                                             loss=LossConfig(use_vgg_loss=False),
                                             breakdown=name not in DEEP_FORM_FLAGS)
        torch.cuda.empty_cache()
    print(json.dumps({"deep_training": {
        "card": smi,
        "config": f"ModelConfig(compute_dtype=bfloat16, renderer_dtype=bfloat16, "
                  f"num_sample_coarse={DEEP_SHAPE[1]}, tuned_kernel_overrides: "
                  f"{tuned_kernel_overrides(cfg.featmap_size, DEEP_SHAPE[1])}; deep_stash: "
                  f"pallas_stash_acts=True; deep_fuse_embed: pallas_fuse_embed=True; "
                  f"{', '.join(DEEP_FORM_FLAGS)}: deep_stash's and {DEEP_FORM_FLAGS}), "
                  f"LossConfig(use_vgg_loss=False), TrainConfig(); "
                  f"B=2, 4096 rays x {DEEP_SHAPE[1]} samples, 512x512",
        "modes": deep_training,
    }}))
    lap("deep training")
    hier = phase_hier(args.seed)
    print(json.dumps({"hier": hier}))
    hier_points = phase_hier(args.seed, fuse_embed=True)
    print(json.dumps({"hier_fuse_embed": hier_points}))
    phase_cli(args.seed)
    lap("hier, cli")
    # 8. more than one device on one card: four gloo ranks, one NCCL rank
    distributed = phase_distributed(args.seed, smi)
    print(json.dumps({"distributed": distributed}))
    lap("distributed")
    # 9. eval: fitting, gaze optimization, protocols, render loops
    per_fit_step, exact_eval = phase_eval(args.seed, args.fit_steps, smi)
    lap("eval")
    # 10. the offline data factory: the segmentation nets, process_frame and
    # the NL-3DMM fit on the card; no kernel of the port lies on its path
    reset_launch_counts()
    preprocess = phase_preprocess(args.seed, smi)
    preprocess_launches = launch_counts()
    print(json.dumps({"preprocess": preprocess}))
    lap("preprocess")
    # 11. JPEG frames: the fixtures against cv2, 6000 x 4000 frames stacked
    # from the strips, read_frame's parts and its launches
    jpeg = phase_jpeg(smi, args.iters)
    print(json.dumps({"jpeg": jpeg}))
    lap("jpeg")
    k1["launches_per_fit_step"] = per_fit_step["fused_field_fwd"]
    k2["launches_per_fit_step"] = per_fit_step["fused_field_bwd"]
    # the input-target protocol with exact FID and the identity pipeline (2 pairs)
    k1["launches_input_target_exact"] = exact_eval["fused_field_fwd"]
    k2["launches_input_target_exact"] = exact_eval["fused_field_bwd"]
    k2["launches"] = training["phase_gm"]["launches"]["fused_field_bwd"]
    # K1 and K2 per rank in one distributed step (the default loss stack)
    for k, counter in ((k1, "fused_field_fwd"), (k2, "fused_field_bwd")):
        k["launches_per_rank_distributed_step"] = {
            layout: [r.get(counter, 0) for r in res["passes"]["default"]["launches_per_rank"]]
            for layout, res in distributed["layouts"].items()}
    k6["launches"] = training["pallas"]["launches"]["shuffle_blur_bwd"]
    k8["launches"] = training["fused"]["launches"]["fused_upsampler_bwd"]
    # K3 and K4 timed at the training shape: their launches on the dual training path
    k3["launches"] = training[DUAL]["launches"]["fused_dual_fwd"]
    k4["launches"] = training[DUAL]["launches"]["fused_dual_bwd"]
    # K1 writing and K2 reading the stash: their launches in the stash variant
    k1["stash"]["launches"] = training[STASH]["launches"]["fused_field_fwd"]
    k2["stash_read"]["launches"] = training[STASH]["launches"]["fused_field_bwd"]
    # K2 reading the stash without dens_vpu: its launches in the split_dw
    # variant (with K1 writing the stash); K1 and K2 in the full_loss step
    k2["split_dw"]["launches"] = training[SPLIT_DW]["launches"]["fused_field_bwd"]
    k1["launches_per_full_loss_step"] = training[FULL_LOSS]["launches_per_step"]["fused_field_fwd"]
    k2["launches_per_full_loss_step"] = training[FULL_LOSS]["launches_per_step"]["fused_field_bwd"]
    # the deep march: K1 and K2 per deep step; K3 and K4 do not run in the
    # deep variants (single-branch fields)
    per_step = deep_training[DEEP]["launches_per_step"]
    k1["deep"]["launches_per_deep_step"] = per_step["fused_field_fwd"]
    k2["deep"]["launches_per_deep_step"] = per_step["fused_field_bwd"]
    k3_deep["launches_per_deep_step"] = k4_deep["launches_per_deep_step"] = 0
    k3["deep"], k4["deep"] = k3_deep, k4_deep
    k1["launches_per_hier_forward"] = hier["launches_per_forward"]["fused_field_fwd"]
    # the kernel modes': their launches on the main path
    k5["unfolded"]["launches"] = training["unfolded_pallas"]["launches"]["shuffle_blur_fwd"]
    k6["unfolded"]["launches"] = training["unfolded_pallas"]["launches"]["shuffle_blur_bwd"]
    k7["f32"]["launches"] = training[FUSED_F32]["launches"]["fused_upsampler_fwd_f32"]
    k8["f32"]["launches"] = training[FUSED_F32]["launches"]["fused_upsampler_bwd_f32"]
    k1["points"]["launches"] = training[FUSE_EMBED]["launches"]["fused_field_fwd"]
    k2["points"]["launches"] = deep_training[DEEP_FUSE_EMBED]["launches"]["fused_field_bwd"]
    k1["points"]["launches_per_deep_step"] = deep_training[DEEP_FUSE_EMBED][
        "launches_per_step"]["fused_field_fwd"]
    k1["points"]["launches_per_hier_forward"] = hier_points["launches_per_forward"][
        "fused_field_fwd"]
    k2["points"]["launches_per_deep_step"] = deep_training[DEEP_FUSE_EMBED][
        "launches_per_step"]["fused_field_bwd"]
    k2["points_stash_read"]["launches"] = training[FUSE_EMBED]["launches"]["fused_field_bwd"]
    # the stash's forms: their launches in their training variants; every
    # fourth layer is timed and held, and runs on no variant's path
    for name in checks.STASH_FORMS:
        for k, counter in ((k1, "fused_field_fwd"), (k2, "fused_field_bwd")):
            run = training.get(f"stash_{name}")
            k[f"stash_{name}"]["launches"] = run["launches"][counter] if run else 0
            run = deep_training.get(f"deep_stash_{name}")
            k[f"deep_stash_{name}"]["launches_per_deep_step"] = (
                run["launches_per_step"][counter] if run else 0)
            run = training.get(f"fuse_embed_{name}")
            k[f"stash_{name}"]["launches_given_points"] = (run["launches"][counter] if run
                                                           else 0)

    # the offline data factory's path launches none of them
    for k, counters in ((k1, ("fused_field_fwd",)), (k2, ("fused_field_bwd",)),
                        (k5, ("shuffle_blur_fwd",)), (k6, ("shuffle_blur_bwd",)),
                        (k7, ("fused_upsampler_fwd", "fused_upsampler_fwd_f32")),
                        (k8, ("fused_upsampler_bwd", "fused_upsampler_bwd_f32")),
                        (k3, ("fused_dual_fwd",)), (k4, ("fused_dual_bwd",))):
        k["launches_preprocess"] = sum(preprocess_launches[c] for c in counters)
        check(k["launches_preprocess"] == 0, f"{k['name']} launched on the preprocessing path")
    # the port's own kernel (no Pallas counterpart): the pixel stage of a
    # 6000 x 4000 frame at 4:2:0, and at 4:2:2 beside it
    frame = jpeg["frames"]["strip420_6000x16"]
    kjpeg = kernel_entry("jpeg_pixels", "jpeg_decode.cu", JPEG_REPLACES, frame["max_abs_err"],
                         frame["kernel_ms"], frame["plain_ms"], frame["bound_ms"],
                         frame["bound_by"])
    frame = jpeg["frames"]["strip422_6000x8"]
    kjpeg["s422"] = mode_record("jpeg_pixels", "4:2:2", frame["max_abs_err"], frame["kernel_ms"],
                                frame["plain_ms"], frame["bound_ms"], frame["bound_by"])
    kjpeg["launches"] = jpeg["launches"]
    kjpeg["launches_per_frame"] = jpeg["launches_per_frame"]
    kjpeg["launches_preprocess"] = preprocess_launches["jpeg_pixels"]
    print(json.dumps({"kernels": [k1, k2, k5, k6, k7, k8, k3, k4, kjpeg]}))
    print(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
