#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PMCE on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits nonzero):

1. card and build: the card's name and power limit (nvidia-smi), then every
   kernel library built from ``pmce_tpu_torch/csrc`` with nvcc;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the main paths (the serving forward at B=256, the Stage-1
   training step at batch 64, the Stage-2 step at batch 32, the SMPL
   forward at B=256), with its
   tolerance; both timed with CUDA events (median after warm-up), beside
   the bound of the same work on this card; the trunk, the GRU scan (both
   directions of a BiGRU layer in one launch) and the whole block rerun
   bit for bit, and the trunk's long-group route (groups over its block
   kernel's 128-row tile) against its plain version under its own
   counter; the decoder's AdaLN and CA block backwards also with branch
   masks that require grad (their gradients against the plain version's,
   rerun bit for bit); the CTAs of row 8's forward the card holds at once
   and the waves a batch of 32 takes; row 5's backward in exactly its two
   launches (the tile program and the weight launch, no transposed weight
   copy). Library yardsticks, timed only:
   ``nn.GRU`` in bf16 for the GRU rows (with the backend that ran),
   ``F.multi_head_attention_forward`` for rows 4 / 5 (row 4 against it
   three more times in turn at both of its shapes), ``nn.TransformerEncoder``
   (pre-norm, erf GELU, the post-norm as its ``norm``) for row 6, with grad
   and on its no-grad fast path, and its autograd backward for row 7; one
   ``torch.einsum`` of the weights, transforms and homogeneous vertices for
   row 15 (skinning, with its share of its bound);
3. serving forward: ``create_pmce(num_joint=19, dtype=bfloat16, fused=True,
   device="cuda")`` at full width, random weights from a seed, B=256. The
   launch counters are zeroed just before it and read just after: every
   kernel of the path must have launched, the GRU scan exactly twice (one
   launch per BiGRU layer). Its outputs must be finite, of
   the expected shapes, and agree with the same model run through the plain
   versions; a small f32 input must agree with the same model on the CPU.
   Then its throughput in mid-frames/s. The weights are perturbed off JAX's
   initial values (nonzero biases, LayerNorm scales off 1), so that the
   comparison reaches every bias path of the model's kernels;
3b. whole-block serving: the same forward, weights and inputs through
   ``create_pmce(..., whole_block_kernel=True)`` (one whole-block kernel per
   CoevoBlock in place of the chain, as ``tools/profile_device.py
   --whole-block`` runs the JAX package). The counters must show exactly 3
   whole-block launches and no chain; the outputs must be finite and agree
   with the plain path and with phase 3's chain path; its throughput beside
   phase 3's;
4. Stage-1 training (``configs/train_pose_h36m.yml``, set in code, under
   the bf16 + fused policy): sequences synthesised with the SMPL forward on
   the card, then the port's ``Trainer`` fits the full-width lifter for two
   short epochs with evaluation. The counters are zeroed just before and
   read just after: block forward and backward 6 each per step, the trunk
   in evaluation, the skinning kernel in the synthesis. Losses finite and
   falling; the first step's loss and gradients on the kernel path agree
   with the plain path; then the step's time and clips/s;
5. Stage-2 mesh training (``configs/train_mesh_h36m_bf16.yml``, set in
   code, with ``MODEL.fused_attn: false``): the full-width PMCE, its lifter
   warm-started from phase 4's ``best.ckpt``, fits two short epochs on
   phase 4's sequences in ``chunk_mode="mesh"``, the edge term on in epoch
   2, with evaluation (MPJPE and MPVPE). The counters are zeroed just
   before the fit and read just after: the training GRU's saving forward
   and backward 4 each per step, the serving GRU scan in evaluation, and
   the trunk, chain, block and decoder attention-block kernels not at all
   (the configuration without ``fused_attn``). Losses finite, the loss of a fixed batch
   falling; two first steps on the kernel path give the same gradients bit
   for bit (the per-parameter difference is printed); the first step's
   loss and gradients on the kernel path agree with the plain path; then
   the step's time, the plain path's and the peak device memory. Phases 5
   and 6 start from JAX's initial values; the GRU's backward is one launch
   of its persistent scan a direction (``gru_bwd_scan``, 4 a step);
6. fused Stage-2 training (``configs/train_mesh_h36m_bf16.yml`` as written,
   ``MODEL.fused_attn: true``): phase 5's cuts, data and warm start, with
   the decoder's attention blocks on their kernels forward and backward
   (``fused_mhsa``, ``ada_block``, ``ca_block``) and the lifter's blocks on
   theirs. The counters must equal the path's launches exactly (the launch
   sequences of rows 4, 5, 8, 9 and 10, outside their tile programs'
   gates, none), and row 8's forward must fill the card in one wave (on a card of
   128 SMs or more); the fixed
   batch's loss must fall; the first step's loss and gradients agree with
   the plain path, the attention blocks' own parameters more tightly (with
   only those six kernels on the card); then the step's time and peak
   memory beside phase 5's.

7. the entry points, as a user calls them: (a) ``bench_torch.py``'s
   measurement with ``bench.py``'s sizes (its JSON line printed on an
   earlier line, its median and spread beside phase 3's reading); (b)
   ``pmce_tpu_torch.main.train`` on ``configs/train_mesh_h36m_bf16.yml``
   with ``--smoke`` (2 epochs × 4 steps at batch 8, 64 synthetic samples,
   writing under ``experiment/chip_smoke_cli``), on the card by default.
   The counters are zeroed just before it and read just after: per step
   the launches of phase 6, in its evaluations the trunk, the GRU scans
   and the chain, the skinning kernel in its synthesis, no launch sequence
   of rows 4, 5, 8, 9 and 10; its protocol summary printed with finite
   metrics; (c) ``pmce_tpu_torch.main.test`` on (b)'s ``best.ckpt``, once
   on the kernels (the trunk, the GRU scans, the chain and the skinning
   launch, nothing else) and once with every kernel through its plain
   version (nothing launches): MPJPE, PA-MPJPE, MPVPE and ACCEL agree
   within 2 %. Both readings, the CLIs' wall times and the phase's
   seconds are printed.

8. the video demo, ``python -m pmce_tpu_torch.main.run_demo --synthetic
   --full-stack --vitpose huge --frames 48`` at full width (ViTPose-Huge,
   ResNet-50, PMCE in bf16 on its kernels), run in this process: the
   first-party detector is trained at first use (timed apart), then (a)
   the CLI on the kernels, the counters zeroed just before and read just
   after: the trunk and the chain exactly once per window batch of 32 and
   the GRU scan twice (two passes: the warm-up and the measured one),
   nothing else (no launch sequence, no skinning); one person tracked over
   at least ``min_track_frames`` frames, every tracked box overlapping the
   rendered body's (IoU at least ``DEMO_MIN_IOU``), meshes and cameras
   finite; its frames/s and stage table printed; (b) the same under
   ``plain_everything`` (nothing launches): meshes and cameras within
   ``DEMO_REL_TOL`` of (a); (c) ResNet-50 features and ViTPose-Huge
   heatmaps at full width in f32 (TF32 off) on the card against the CPU
   within ``BACKBONE_REL_TOL``, and the heatmaps decoded equally on both
   (equal maxima included).

9. data parallelism on the card, in this process: a one-process NCCL
   world that ``pmce_tpu_torch.parallel.initialize`` joins from torchrun's
   variables (set here: rank 0, world size 1). Phase 6's config, cuts,
   data and warm start; the fused Stage-2 step three ways from the same
   weights, seed and batches: (a) the plain ``Trainer``, (b) under
   ``replicate`` (DDP), (c) under ``shard_fsdp`` (FSDP2). For (b) and (c)
   the counters, zeroed before and read after, equal phase 6's for a first
   step and for an epoch of ``TRAIN_STEPS`` steps with its evaluation (no
   launch sequence of rows 4, 5, 8, 9 and 10); the first step's loss and
   every gradient after the reduction equal (a)'s (bit for bit, or the
   largest difference printed within ``DP_GRAD_REL_TOL`` of the largest
   gradient); the fixed batch's loss falls; a checkpoint (c) writes loads
   into a plain ``Trainer`` whose next loss is (a)'s and (c)'s. Each way's
   step time and peak memory beside phase 6's step.

10. the data pipeline on the card: mock source trees in the reference's
   formats (``tests/torch_port_etl_fixtures.py``: COCO-format JSONs,
   joblib-format feature DBs, fits, detections) for the five datasets at
   full width (6890 vertices, [17, 6890] regressors, 2048-d features;
   H36M's five protocol-2 train subjects give 5,118 fitted bodies, 10
   chunks of the ETL's 512), each converter CLI (``python -m
   pmce_tpu_torch.tools.convert_*``) run in this process twice: on the
   skinning kernel, then with the plain skinning (``smpl_verts_joints``'s
   ``fused=False``). The counters, zeroed before and read after each run:
   the skinning exactly once a chunk, nothing else, nothing on the plain
   run. Every packed field of the two runs agrees (names, indices and masks
   exactly, COCO's masks outside ``ETL_GATE_MARGIN_PX`` of its gate;
   geometry within ``ETL_GEOM_MM``, 2D within ``ETL_PX``); the kernel run
   agrees with the mock's world-frame truth (``ETL_TRUTH_MM``), and both
   files load through ``data/factory.py`` into their dataset class with
   the same windows. Each ETL's frames/s both ways, row 15 at B = 512
   against its bound, and the H36M run's ``--record-perf`` entry (into a
   temporary file) checked.

11. the f32 serving forward (TF32 off throughout, ``smpl.layer.full_f32``):
   (a) the three f32 kernels (row 6's non-saving program at the lifter's
   spatial [4096, 19, 256] and temporal [4864, 16, 256] shapes with the
   post-norm, the chain and the whole block at B = 256) against their
   plain versions within ``F32_KERNEL_REL_TOL``, reruns bit for bit, timed
   beside their bounds at the f32 CUDA-core peak, row 6's beside
   ``nn.TransformerEncoder`` in f32 on its no-grad path; (b)
   ``create_pmce(num_joint=19, dtype=None, fused=True)`` at full width,
   phase 3's weights and inputs, the counters zeroed just before and read
   just after a forward: exactly ``block_fwd_f32`` 6 and
   ``coevo_chain_f32`` 1, nothing else; then the same with
   ``whole_block_kernel`` (``coevo_block_f32`` 3); both against the plain
   route (the block, chain and whole block through their plain versions:
   nothing launches) within ``F32_SERVE_REL_TOL`` of each output's largest
   magnitude, and mid-frames/s on each route; (c) the test CLI on
   ``CLI_CFG`` with ``MODEL.compute_dtype: 'float32'`` (written into a
   temporary directory; ``fused_attn: true`` as the file has it), from its
   seeded initial weights, on the kernels (``block_fwd_f32`` 6 a batch,
   ``coevo_chain_f32`` 1, the synthesis' skinning, nothing else) and under
   ``plain_everything`` (nothing launches): the four metrics within
   ``F32_SERVE_REL_TOL``.

``--profile`` adds a torch.profiler breakdown of each serving forward's and
each train step's device time by kernel and, before phase 2, the stage
split of the trunk (K1), the GRU scan (K2), the decoder chain (K3), the
whole block (row 14), the GRU's backward scan (row 13), the block
forward's and backward's tile programs (rows 6, 7), the CA block's
forward and backward tile programs (rows 10, 11), the AdaLN block's
forward (row 8, both launches) and backward (row 9) and the
self-attention forward's and backward's (rows 4 and 5, at both of their
shapes): one call of each
kernel's
clock64()-stamped instantiation (not counted as a launch) books every
tile's, CTA's or clip's cycles to its stages.

The second-to-last line is one JSON object with the kernels' numbers; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the ``pmce_tpu_torch`` package beside this file, it prints no
result and exits nonzero.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
B, T, J, C = 256, 16, 19, 256
# Stage-1 training: batch, H36M joints, steps per epoch of the smoke fit.
BT, JT, TRAIN_STEPS = 64, 17, 25
# Stage-2 training: batch (train_mesh_h36m_bf16.yml) and GRU width; the
# BiGRU's input width (both layers: the image features, then 2H).
BM, GRU_H, GRU_IN = 32, 1024, 2048
# Phase 7: the config the entry points run (the shipped config that runs
# the fused kernels).
CLI_CFG = REPO / "configs" / "train_mesh_h36m_bf16.yml"

# The TPU kernel each wrapper replaces (file:line of the Pallas body).
REPLACES = {
    "lifter_trunk": "pmce_tpu/ops/fused_attention.py:3011",
    "gru_layer": "pmce_tpu/ops/fused_attention.py:2279",
    "gru_layer_rev": "pmce_tpu/ops/fused_attention.py:2279",
    "gru_scan": "pmce_tpu/ops/fused_attention.py:2279",
    "coevo_chain": "pmce_tpu/ops/fused_coevo_chain.py:118",
    "block_fwd": "pmce_tpu/ops/fused_attention.py:464",
    "block_bwd": "pmce_tpu/ops/fused_attention.py:1108",
    "skinning": "pmce_tpu/smpl/kernels.py:31",
    "gru_layer_save": "pmce_tpu/ops/fused_attention.py:2403",
    "gru_layer_bwd": "pmce_tpu/ops/fused_attention.py:2438",
    "mhsa_fwd": "pmce_tpu/ops/fused_attention.py:369",
    "mhsa_bwd": "pmce_tpu/ops/fused_attention.py:800",
    "ada_block_fwd": "pmce_tpu/ops/fused_attention.py:1366",
    "ada_block_bwd": "pmce_tpu/ops/fused_attention.py:1534",
    "ca_block_fwd": "pmce_tpu/ops/fused_attention.py:1823",
    "ca_block_bwd": "pmce_tpu/ops/fused_attention.py:1853",
    "coevo_block": "pmce_tpu/ops/fused_attention.py:2714",
    "block_fwd_f32": "pmce_tpu/ops/fused_attention.py:464",
    "coevo_chain_f32": "pmce_tpu/ops/fused_coevo_chain.py:118",
    "coevo_block_f32": "pmce_tpu/ops/fused_attention.py:2714",
}
SOURCES = {
    "lifter_trunk": "pmce_tpu_torch/csrc/lifter_trunk.cu",
    "gru_layer": "pmce_tpu_torch/csrc/gru_scan.cu",
    "gru_layer_rev": "pmce_tpu_torch/csrc/gru_scan.cu",
    "gru_scan": "pmce_tpu_torch/csrc/gru_scan.cu",
    "coevo_chain": "pmce_tpu_torch/csrc/coevo_chain.cu",
    "block_fwd": "pmce_tpu_torch/csrc/block.cu",
    "block_bwd": "pmce_tpu_torch/csrc/block.cu",
    "skinning": "pmce_tpu_torch/csrc/skinning.cu",
    "gru_layer_save": "pmce_tpu_torch/csrc/gru_scan.cu",
    "gru_layer_bwd": "pmce_tpu_torch/csrc/gru_scan.cu",
    "mhsa_fwd": "pmce_tpu_torch/csrc/mhsa.cu",
    "mhsa_bwd": "pmce_tpu_torch/csrc/mhsa.cu",
    "ada_block_fwd": "pmce_tpu_torch/csrc/ada_block.cu",
    "ada_block_bwd": "pmce_tpu_torch/csrc/ada_block.cu",
    "ca_block_fwd": "pmce_tpu_torch/csrc/ca_block.cu",
    "ca_block_bwd": "pmce_tpu_torch/csrc/ca_block.cu",
    "coevo_block": "pmce_tpu_torch/csrc/coevo_block.cu",
    "block_fwd_f32": "pmce_tpu_torch/csrc/block_f32.cu",
    "coevo_chain_f32": "pmce_tpu_torch/csrc/coevo_f32.cu",
    "coevo_block_f32": "pmce_tpu_torch/csrc/coevo_f32.cu",
}
# gru_layer / gru_layer_rev count direction scans, gru_scan launches of the
# scan kernel: one runs both directions of a BiGRU layer.
SERVING = ("lifter_trunk", "gru_layer", "gru_layer_rev", "gru_scan",
           "coevo_chain")
# The scan kernel's launches on a serving forward: one per BiGRU layer.
SERVING_GRU_SCANS = 2
# Phase 3b: the whole-block kernel once per CoevoBlock, and no chain.
WHOLE_BLOCK = ("lifter_trunk", "gru_layer", "gru_layer_rev", "gru_scan",
               "coevo_block")
TRAINING = ("block_fwd", "block_bwd", "lifter_trunk", "skinning")
# Phase 5: the kernels its path must launch, and those it must not (the
# fused-attention configuration's, and the synthesis' skinning, done in
# phase 4).
MESH_TRAINING = ("gru_layer_save", "gru_layer_bwd", "gru_bwd_scan",
                 "gru_layer", "gru_layer_rev", "gru_scan")
# The decoder's attention blocks (phase 6; idle in phase 5).
DECODER = ("mhsa_fwd", "mhsa_bwd", "ada_block_fwd", "ada_block_bwd",
           "ca_block_fwd", "ca_block_bwd")
# The launch sequences of rows 4, 5, 8, 9 and 10 outside their tile
# programs' gates: no shape of the Stage-2 step reaches them.
DECODER_SEQ = ("mhsa_fwd_seq", "mhsa_bwd_seq", "ada_block_fwd_seq",
               "ada_block_bwd_seq", "ca_block_fwd_seq")
MESH_IDLE = ("lifter_trunk", "lifter_trunk_long", "coevo_chain", "block_fwd", "block_bwd",
             "skinning", "coevo_block", *DECODER, *DECODER_SEQ)
# Kernel vs plain version on identical inputs, as max|kernel - plain| over
# max|plain| (for the block backward: per gradient). Both compute f32 sums
# of the same bf16 operands with the same cast points; they differ in
# summation order and in exp/erf/tanh, so now and then an intermediate
# rounds to the neighbouring bf16 value and the difference propagates.
# First measured on an H100 (700 W): trunk 0.0625 absolute (LayerNorm-scaled
# outputs), GRU 0.0039 (one bf16 ulp of |h| < 1), chain 0.11 on vertices up
# to ~17 (0.7 %), block forward 0.5 %, block gradients up to 0.56 %. The
# training GRU pair: the saved state as the GRU (one bf16 ulp of the bf16
# operand h feeds every gate; first measured 0.0039 of max 2.0); the
# backward twice that, since its bf16 dgh, the carry product's operand, can
# round to the neighbouring value and the carry passes it on (first
# measured 0.00013 of max 0.48).
# The decoder's attention blocks (mhsa, ada_block, ca_block) compute the
# plain versions' cast points with f32 sums in another order; per output
# and per gradient, as the block's. The whole-block kernel runs the chain's
# block program (csrc/coevo_ops.cuh) on bf16 features: the chain's band.
TOL = {"lifter_trunk": 0.03, "lifter_trunk_long": 0.03,
       "gru_layer": 0.01, "gru_layer_rev": 0.01, "gru_scan": 0.01,
       "coevo_chain": 0.02, "coevo_block": 0.02, "block_fwd": 0.02,
       "block_bwd": 0.02,
       "gru_layer_save": 0.01, "gru_layer_bwd": 0.02,
       **{name: 0.02 for name in DECODER}}
# Skinning is full f32 on both sides: an absolute bound in meters
# (first measured: 2.4e-7).
SKIN_TOL_M = 1e-6
# Serving outputs, kernel path vs plain path, relative to each output's
# largest magnitude (first measured: 0.5 %, 0.3 %, 0.7 %).
SERVE_REL_TOL = 0.02
# First train step, kernel path vs plain path on the same weights, batch
# and masks: the loss, and each parameter's gradient relative to its
# largest magnitude. Six bf16 blocks forward and backward in a row; each
# block alone stays within 0.6 % (phase 2). First measured: loss 4.7e-7,
# gradients 1.5 % (spatial_pos_embed). Stage 2 holds its GRU kernels'
# gradient to the plain loop's autograd, which rounds the carry's gradient
# to bf16 at every step where the kernels keep it f32 (loss first measured
# 2.6e-5).
STEP_LOSS_REL_TOL = 0.01
STEP_GRAD_REL_TOL = 0.03
# Stage 2 holds its GRU's own gradients and those of the backward kernel
# alone (kernel forward, plain backward scan) to STEP_GRAD_REL_TOL; every
# gradient of the whole plain path to a wider band. The two forwards differ
# where a bf16 ulp of the GRU's output moves the 431-key softmax of block
# 3's joint cross-attention, whose parameters only the x1e-3 joint loss
# reaches: first measured 4.1 % there (1.2 % in the GRU's own weights, 0.9 %
# with the backward kernel alone); two runs of the same kernel path differ
# by 0.76 % (PyTorch's scatter-adds with atomics in the backward).
MESH_GRAD_REL_TOL = 0.1
# Phase 6: the decoder attention blocks' own parameters (but the last
# block's joint stream, see mesh_train), with only those six kernels on the
# card (everything else plain) against the plain path.
DECODER_GRAD_REL_TOL = 0.03
# Decoder parameters whose gradient is zero analytically (see mesh_train).
# Phase 9 at world size 1: DDP and FSDP against the plain trainer, where
# not bit for bit, relative to the largest gradient (and loss).
DP_GRAD_REL_TOL = 1e-6
KEY_BIASES = ("wk.bias", "normk.mlp_beta.weight", "normk.mlp_beta.bias")
# Phase 8: the demo as ``python -m pmce_tpu_torch.main.run_demo`` runs it
# at full width (ViTPose-Huge, ResNet-50, PMCE bf16 on its kernels).
DEMO_ARGV = ["--synthetic", "--full-stack", "--vitpose", "huge",
             "--frames", "48"]
# Kernels vs plain (phase 8b), relative to each output's largest
# magnitude: the meshes in phase 3's serving band; the cameras are fitted
# in closed form to the meshes' joints. First measured on an H100 (700 W):
# meshes 0.80 %, cameras 0.019 %.
DEMO_REL_TOL = {"mesh": SERVE_REL_TOL, "cam": SERVE_REL_TOL}
# Every tracked box must overlap the rendered body's tight box this much.
DEMO_MIN_IOU = 0.3
# Phase 8c: f32 with TF32 off on the card vs the CPU, relative to the
# output's largest magnitude (the orders of the sums differ). First
# measured: ResNet-50 1.85e-7, ViTPose-Huge 1.32e-6.
BACKBONE_REL_TOL = 1e-4
# Phase 10: the mock trees (tests/torch_port_etl_fixtures.py) at full
# width: 6890 vertices, [17, 6890] regressors, 2048-d features. H36M:
# protocol 2's five train subjects × 2 cameras × 1,024 frames, every second
# one kept (5,118 fitted bodies: 10 chunks of the ETL's 512); the others
# one full chunk and a part: 3DPW 2 × 520 (one SMPL call a gender),
# MPI-INF-3DHP 2 cameras × 300, COCO and MPII 600 images (and MPII3D val,
# no SMPL).
ETL_H36M_FRAMES, ETL_H36M_SUBJECTS = 1024, (1, 5, 6, 7, 8)
ETL_PW3D_FRAMES, ETL_MPII3D_FRAMES, ETL_IMAGES = 520, 300, 600
ETL_BATCH = 512
# Kernel vs plain skinning through the whole ETL: geometry (mm) and 2D
# (px); the skinning alone differs by up to SKIN_TOL_M, and f32 at ~5 m
# rounds at 5e-4 mm. COCO's masks are compared where the fit error lies
# more than ETL_GATE_MARGIN_PX from its 3 px threshold.
ETL_GEOM_MM, ETL_PX, ETL_GATE_MARGIN_PX = 2e-3, 1e-3, 0.01
# The converters' mesh against the mock's world-frame SMPL turned into the
# camera frame (tests/test_etl.py's bound).
ETL_TRUTH_MM = 0.1
# Phase 11, the f32 serving forward: every counter's launches a forward
# (the rest 0), the chain route and the whole-block route.
F32_CHAIN = {"block_fwd_f32": 6, "coevo_chain_f32": 1}
F32_WHOLE = {"block_fwd_f32": 6, "coevo_block_f32": 3}
# The f32 kernels against their plain versions with TF32 off, relative to
# the plain output's largest magnitude: f32 on both sides, sums in another
# order (FFMA against cuBLAS), exp / erf of another library. First measured
# on an H100 (700 W): 2.7e-7 to 5.6e-7.
F32_KERNEL_REL_TOL = 1e-5
# The f32 serving outputs, kernels against plain, relative to each output's
# largest magnitude, and the test CLI's metrics relative to the plain
# route's: the f32 model's bound (tests/test_torch_port_model.py).
F32_SERVE_REL_TOL = 1e-4
# The card's published peaks (NVIDIA H100 SXM data sheet, dense): bf16 on
# the tensor cores, f32 on the CUDA cores, and the HBM rate.
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def tensor_bytes(*objs) -> int:
    """Bytes of every distinct tensor in (nested tuples / lists / dicts of)
    ``objs``, each counted once."""
    import torch

    seen, total = set(), 0

    def walk(o):
        nonlocal total
        if isinstance(o, torch.Tensor):
            if id(o) not in seen:
                seen.add(id(o))
                total += o.numel() * o.element_size()
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (tuple, list)):
            for v in o:
                walk(v)

    for o in objs:
        walk(o)
    return total


def count_flops(fn) -> int:
    """Matrix-product FLOPs of one call of ``fn`` (PyTorch's flop counter,
    forward and any backward it runs)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def bound(flops: int, nbytes: int, peak: str) -> tuple[float, str]:
    """The least time the card could take for the work: the larger of the
    products at the published ``peak`` rate and the bytes each input read
    once and each output written once take at the HBM rate."""
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def record(rows, name, err, ms, plain_ms, flops, nbytes, peak) -> None:
    """Keep the first case's numbers of a kernel (the largest error over
    all its cases) for the kernels line."""
    bound_ms, by = bound(flops, nbytes, peak)
    print(f"[kernels] {name}: bound {bound_ms:.4f} ms by {by} "
          f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB); kernel at "
          f"{bound_ms / ms:.1%} of it", flush=True)
    row = rows.setdefault(name, {"max_abs_err": 0.0})
    row["max_abs_err"] = max(row["max_abs_err"], err)
    for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                 ("bound_by", by), ("library_ms", None)):
        row.setdefault(k, v)


class Inputs:
    """Seeded random tensors on a device (drawn on the CPU, then moved)."""

    def __init__(self, seed: int, device):
        import torch

        self.gen = torch.Generator().manual_seed(seed)
        self.device = device

    def __call__(self, *shape, scale=1.0, offset=0.0, dtype=None):
        import torch

        t = torch.randn(*shape, generator=self.gen) * scale + offset
        return t.to(device=self.device, dtype=dtype or torch.float32)


def trunk_case(r, batch: int, depth: int = 3, hid: int = 512):
    import torch

    def block():
        return (r(C, scale=0.1, offset=1.0), r(C, scale=0.1),
                r(C, 3 * C, scale=C ** -0.5), r(3 * C, scale=0.02),
                r(C, C, scale=C ** -0.5), r(C, scale=0.02),
                r(C, scale=0.1, offset=1.0), r(C, scale=0.1),
                r(C, hid, scale=C ** -0.5), r(hid, scale=0.02),
                r(hid, C, scale=hid ** -0.5), r(C, scale=0.02))

    x = r(batch, T * J, C, dtype=torch.bfloat16)
    params = tuple(block() for _ in range(2 * depth))
    norm_s = (r(C, scale=0.1, offset=1.0), r(C, scale=0.1))
    norm_t = (r(C, scale=0.1, offset=1.0), r(C, scale=0.1))
    return (x, params, norm_s, norm_t, r(T, C, scale=0.1), T, J, depth, 8)


def long_trunk_case(r, batch: int = 2, T_: int = 130, J_: int = 3):
    """One spatial + temporal block at T = 130 (temporal groups over the
    block kernel's tile), the long route's shapes."""
    import torch

    x, params, norm_s, norm_t, _, _, _, _, heads = trunk_case(r, 1, depth=1)
    return (r(batch, T_ * J_, C, dtype=torch.bfloat16), params, norm_s,
            norm_t, r(T_, C, scale=0.1), T_, J_, 1, heads)


def gru_case(r, steps: int, batch: int, H: int = 1024):
    """One GRU direction as the BiGRU hands it over: bf16 projections, the
    f32 ``weight_hh`` parameter [3H, H] as its [H, 3H] ``.t()`` view (the
    kernel reads it in place), the f32 bias."""
    import torch

    return (r(steps, batch, 3 * H, dtype=torch.bfloat16),
            r(3 * H, H, scale=H ** -0.5).t(), r(3 * H, scale=0.1))


def coevo_params(r, V: int = 431, c: int = 64) -> tuple:
    """One CoevoBlock's 14-tuple (embeds, projections across, both CA and
    both SA weight sets), f32, nonzero biases."""
    def w(i, o):
        return r(i, o, scale=i ** -0.5)

    def ca():
        return (w(c, c), r(c, scale=0.02), w(c, c), r(c, scale=0.02),
                w(c, c), r(c, scale=0.02), w(c, c), r(c, scale=0.02),
                w(c, 4 * c), r(4 * c, scale=0.02), w(4 * c, c),
                r(c, scale=0.02))

    def sa():
        return (w(c, 3 * c), r(3 * c, scale=0.02), w(c, c), r(c, scale=0.02),
                w(c, 4 * c), r(4 * c, scale=0.02), w(4 * c, c),
                r(c, scale=0.02))

    return (r(J, c), r(V, c), r(J, c), r(V, c), r(V, c), r(J, c),
            w(c, c), r(c, scale=0.02), w(c, c), r(c, scale=0.02),
            ca(), ca(), sa(), sa())


def chain_case(r, batch: int, V: int = 431, NB: int = 3, c: int = 64):
    import torch

    bf = torch.bfloat16
    blocks = []
    for _ in range(NB):
        kp = coevo_params(r, V, c)
        blocks.append((r(3, c, scale=3 ** -0.5).to(bf), r(c, scale=0.02),
                       r(3, c, scale=3 ** -0.5).to(bf), r(c, scale=0.02), kp,
                       r(c, 3, scale=c ** -0.5), r(3, scale=0.02),
                       r(c, 3, scale=c ** -0.5), r(3, scale=0.02)))
    return (r(batch, J, 3, scale=0.3), r(batch, V, 3, scale=0.3),
            r(batch, NB, 12, c, scale=0.1, offset=1.0),
            r(batch, NB, 12, c, scale=0.1), tuple(blocks), 8, 2)


def coevo_block_case(r, batch: int, V: int = 431, c: int = 64):
    """The whole-block kernel at the whole-block serving forward's shapes:
    bf16 projected features, f32 AdaLN stacks and one block's weights."""
    import torch

    bf = torch.bfloat16
    return (r(batch, J, c, dtype=bf), r(batch, V, c, dtype=bf),
            r(batch, 12, c, scale=0.1, offset=1.0),
            r(batch, 12, c, scale=0.1), coevo_params(r, V, c), 8, 2)


def gru_library(r, steps: int, batch: int, bidirectional: bool = False,
                train: bool = False) -> dict:
    """The GRU rows' yardstick: one ``nn.GRU(GRU_IN, GRU_H)`` call (one
    ``torch._VF.gru``) in bf16 at the same shapes, timed only (the port
    never calls it), beside the port's projection GEMM plus scan on the
    same weights: ``nn.GRU`` includes the input projection. ``train``:
    both forwards keep a gradient (row 12's saving scan) and both autograd
    backwards are timed too (row 13; the library's also forms the weight
    gradients, as the port's does). The library's backend is read from
    the profiler's kernel names."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pmce_tpu_torch.ops import fused_attention as fa

    bf = torch.bfloat16
    gru = torch.nn.GRU(GRU_IN, GRU_H, bidirectional=bidirectional).to(
        device=r.device, dtype=bf)
    with torch.no_grad():
        for p in gru.parameters():
            p.copy_(r(*p.shape, scale=GRU_H ** -0.5))
    params = list(gru.parameters())
    x = r(steps, batch, GRU_IN, dtype=bf)
    ws = [[getattr(gru, f"{n}_l0{sfx}") for n in (
        "weight_ih", "bias_ih", "weight_hh", "bias_hh")]
        for sfx in (("", "_reverse") if bidirectional else ("",))]

    def port():
        gis = [x @ w_ih.t() + b_ih for w_ih, b_ih, _, _ in ws]
        if bidirectional:
            return torch.cat(fa.gru_bidir(gis[0], gis[1], ws[0][2].t(),
                                          ws[0][3], ws[1][2].t(), ws[1][3]),
                             dim=-1)
        return fa.gru_layer(gis[0], ws[0][2].t(), ws[0][3])

    def library():
        return gru(x)[0]

    grad = torch.enable_grad if train else torch.no_grad
    with grad():
        out = {"lib_ms": median_ms(library), "port_ms": median_ms(port)}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            library()
            torch.cuda.synchronize()
        if train:
            y_lib, y_port = library(), port()
            g = r(*y_lib.shape, scale=0.1, dtype=bf)
            out["lib_bwd_ms"] = median_ms(lambda: torch.autograd.grad(
                y_lib, params, g, retain_graph=True))
            out["port_bwd_ms"] = median_ms(lambda: torch.autograd.grad(
                y_port, params, g, retain_graph=True))
    names = sorted({e.name for e in prof.events()
                    if e.device_type == DeviceType.CUDA})
    cudnn = [n for n in names if "cudnn" in n.lower() or "RNN" in n]
    backend = "cuDNN" if cudnn else "PyTorch's own (not cuDNN)"
    what = (f"nn.GRU({GRU_IN}, {GRU_H}{', bidirectional' if bidirectional else ''})"
            f" T={steps} B={batch} bf16{', training' if train else ''}")
    print(f"[kernels] library: {what}: {out['lib_ms']:.4f} ms forward"
          + (f", {out['lib_bwd_ms']:.4f} ms autograd backward (with the "
             f"weight gradients)" if train else "")
          + f"; the port's projection GEMM + scan {out['port_ms']:.4f} ms"
          + (f", its autograd backward {out['port_bwd_ms']:.4f} ms"
             if train else "")
          + f". Backend: {backend}; kernels: "
          + "; ".join(n[:60] for n in (cudnn or names)[:6]), flush=True)
    del gru, x
    return out


def check_kernels(device) -> dict:
    """Phase 2: every kernel against its plain version at main-path shapes."""
    import torch

    from pmce_tpu_torch.ops import _cuda
    from pmce_tpu_torch.ops import fused_attention as fa
    from pmce_tpu_torch.ops import fused_coevo_chain as fc

    r = Inputs(1, device)
    rows = {}

    def compare(name, kernel, plain, args, label):
        with torch.no_grad():
            out_k = kernel(*args)
            out_p = plain(*args)
            torch.cuda.synchronize()
            outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
            outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
            for a in outs_k:
                if not bool(torch.isfinite(a).all()):
                    raise RuntimeError(f"{name} {label}: non-finite output")
            err = max(max_err(a, b) for a, b in zip(outs_k, outs_p))
            scale = max(float(b.float().abs().max()) for b in outs_p)
            mean = max(float((a.float() - b.float()).abs().mean())
                       for a, b in zip(outs_k, outs_p))
            ms = median_ms(lambda: kernel(*args))
            plain_ms = median_ms(lambda: plain(*args), iters=5)
        ok = err <= TOL[name] * scale
        print(f"[kernels] {name} {label}: max_abs_err={err:.6g} "
              f"mean_abs_err={mean:.3g} max|plain|={scale:.4g} "
              f"(tol {TOL[name]} x max|plain|) kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms{'' if ok else '  FAIL'}", flush=True)
        if not ok:
            raise RuntimeError(f"{name} {label}: kernel disagrees with its "
                               f"plain version ({err} > {TOL[name]} x "
                               f"{scale})")
        with torch.no_grad():
            flops = count_flops(lambda: plain(*args))
        record(rows, name, err, ms, plain_ms, flops,
               tensor_bytes(args, outs_k), "bf16")

    def rerun(name, kernel, args, what="outputs"):
        """Two runs give the same bits; returns the first's outputs."""
        with torch.no_grad():
            first, again = kernel(*args), kernel(*args)
        if not isinstance(first, tuple):
            first, again = (first,), (again,)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise RuntimeError(f"{name}: two runs differ")
        print(f"[kernels] {name}: a second run gives the same {what} bit "
              "for bit", flush=True)
        return first

    args = trunk_case(r, B)
    compare("lifter_trunk", fa.lifter_trunk, fa.lifter_trunk_plain, args,
            f"B={B} T*J={T * J} C={C}")
    rerun("lifter_trunk", fa.lifter_trunk, args, "tokens")
    del args
    # Row 2 on the serving path: one launch of the scan kernel runs both
    # directions of a BiGRU layer, layer 0's 16 + 16 steps and layer 1's 9
    # forward and 8 reverse (the mid-frame cut).
    for tf, tb in ((16, 16), (9, 8)):
        gi_f, whh_f, bhh_f = gru_case(r, tf, B)
        gi_b, whh_b, bhh_b = gru_case(r, tb, B)
        args = (gi_f, gi_b, whh_f, bhh_f, whh_b, bhh_b)
        compare("gru_scan", fa.gru_bidir, fa.gru_bidir_plain, args,
                f"T={tf}+{tb} B={B} H={GRU_H}, both directions")
        first = rerun(f"gru_scan T={tf}+{tb}", fa.gru_bidir, args)
        with torch.no_grad():
            # f32 weight_hh is rounded at load: the bits of a bf16 cast.
            cast = fa.gru_bidir(gi_f, gi_b, whh_f.to(torch.bfloat16), bhh_f,
                                whh_b.to(torch.bfloat16), bhh_b)
        if not all(torch.equal(a, b) for a, b in zip(first, cast)):
            raise RuntimeError("gru_scan: f32 weight_hh and its bf16 cast "
                               "give different outputs")
        print(f"[kernels] gru_scan T={tf}+{tb}: weight_hh cast to bf16 "
              "gives the same outputs bit for bit", flush=True)
    del args, first, cast
    # Each direction alone (one launch spreads it over the card), as the
    # per-direction calls of earlier kernels ran.
    for steps in (16, 9):
        args = gru_case(r, steps, B)
        compare("gru_layer", fa.gru_layer, fa.gru_layer_plain, args,
                f"T={steps} B={B} H=1024")
    rerun("gru_layer", fa.gru_layer, args)
    for steps in (16, 8):
        args = gru_case(r, steps, B)
        compare("gru_layer_rev", fa.gru_layer_rev,
                lambda gi, w, b: fa.gru_layer_plain(gi, w, b, reverse=True),
                args, f"T={steps} B={B} H=1024")
    rerun("gru_layer_rev", fa.gru_layer_rev, args)
    lib1 = gru_library(r, 16, B)
    lib2 = gru_library(r, 16, B, bidirectional=True)
    rows["gru_scan"]["library_ms"] = lib2["lib_ms"]
    # nn.GRU has no reverse direction alone: the forward one does the same
    # work.
    for name in ("gru_layer", "gru_layer_rev"):
        rows[name]["library_ms"] = lib1["lib_ms"]
    compare("coevo_chain", fc.coevo_chain, fc.coevo_chain_plain,
            chain_case(r, B), f"B={B} J={J} V=431 C=64")
    args = coevo_block_case(r, B)
    compare("coevo_block", fc.coevo_block, fc.coevo_block_plain, args,
            f"B={B} J={J} V=431 C=64")
    rerun("coevo_block", fc.coevo_block, args, "features")
    # The training GRU at the Stage-2 step's shapes: both layers' T = 16
    # directions and the mid-frame final layer's 9 forward and 8 reverse
    # steps, batch 32.
    for steps, rev in ((16, False), (9, False), (8, True)):
        gi, whh, bhh = gru_case(r, steps, BM)
        label = f"T={steps} B={BM} H={GRU_H}{' reverse' if rev else ''}"
        compare("gru_layer_save", fa.gru_layer_save, fa.gru_layer_save_plain,
                (gi, whh, bhh, rev), label)
        rerun(f"gru_layer_save {label}", fa.gru_layer_save,
              (gi, whh, bhh, rev), "outputs and saved state")
        with torch.no_grad():
            _, saved = fa.gru_layer_save_plain(gi, whh, bhh, rev)
        # The backward kernel reads Whh as the bf16 [3H, H] rounding that
        # the saving forward writes.
        wb = whh.t().to(torch.bfloat16).t()
        g = r(steps, BM, GRU_H, scale=0.1, dtype=torch.bfloat16)
        compare("gru_layer_bwd", fa.gru_layer_bwd, fa.gru_layer_bwd_plain,
                (g, saved, wb, rev), label)
    lib = gru_library(r, 16, BM, train=True)
    rows["gru_layer_save"]["library_ms"] = lib["lib_ms"]
    rows["gru_layer_bwd"]["library_ms"] = lib["lib_bwd_ms"]
    check_blocks(device, rows)
    check_decoder_blocks(device, rows)
    check_skinning(device, rows)
    # The trunk's long-group route (temporal groups of 130 frames, over the
    # block kernel's 128-row tile): its own kernels and counter, not on a
    # main path, so not in the kernels line.
    _cuda.reset_launch_counts()
    compare("lifter_trunk_long", fa.lifter_trunk, fa.lifter_trunk_plain,
            long_trunk_case(r), "B=2 T=130 J=3 depth 1")
    if _cuda.launch_counts()["lifter_trunk"]:
        raise RuntimeError("T=130: the block route ran a 130-token group")
    return rows


def block_case(rng, device, clips: int, N: int, rate: float):
    """One lifter block at the training shapes, made with numpy from a
    seed: bf16 tokens, f32 weights, the shared post-norm, the output's
    cotangent and, at a nonzero drop-path rate, per-clip branch masks."""
    import torch

    def r(*shape, scale=1.0, offset=0.0, dtype=torch.float32):
        a = rng.normal(size=shape) * scale + offset
        return torch.from_numpy(a.astype("float32")).to(
            device, dtype).requires_grad_(True)

    hid = 2 * C
    params = (r(C, scale=0.1, offset=1.0), r(C, scale=0.1),
              r(C, 3 * C, scale=C ** -0.5), r(3 * C, scale=0.02),
              r(C, C, scale=C ** -0.5), r(C, scale=0.02),
              r(C, scale=0.1, offset=1.0), r(C, scale=0.1),
              r(C, hid, scale=C ** -0.5), r(hid, scale=0.02),
              r(hid, C, scale=hid ** -0.5), r(C, scale=0.02),
              r(C, scale=0.1, offset=1.0), r(C, scale=0.1))
    masks = None
    if rate:
        keep = 1.0 - rate
        masks = tuple(
            torch.from_numpy(((rng.random((clips, 1, 1)) < keep) / keep)
                             .astype("float32")).to(device)
            for _ in range(2))
    x = r(clips, N, C, dtype=torch.bfloat16)
    g = r(clips, N, C, dtype=torch.bfloat16).detach()
    return x, params, masks, g


def library_encoder(x, params):
    """Rows 6 and 7's yardstick on the block's weights, in x's dtype on x's
    device: ``nn.TransformerEncoder`` of one pre-norm
    ``TransformerEncoderLayer`` (exact-erf GELU, eps 1e-6) with the
    post-norm as its ``norm`` (timed only; the port never calls it)."""
    import torch
    from torch import nn

    C_ = x.shape[-1]
    hid = params[8].shape[1]
    layer = nn.TransformerEncoderLayer(
        C_, 8, hid, dropout=0.0, activation="gelu", layer_norm_eps=1e-6,
        batch_first=True, norm_first=True)
    enc = nn.TransformerEncoder(layer, 1, norm=nn.LayerNorm(C_, eps=1e-6),
                                enable_nested_tensor=False)
    (g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bb1, w2, bb2, gp,
     bp) = (t.detach() for t in params)
    lay = enc.layers[0]
    with torch.no_grad():
        for dst, src in ((lay.norm1.weight, g1), (lay.norm1.bias, b1),
                         (lay.self_attn.in_proj_weight, wqkv.t()),
                         (lay.self_attn.in_proj_bias, bqkv),
                         (lay.self_attn.out_proj.weight, wproj.t()),
                         (lay.self_attn.out_proj.bias, bproj),
                         (lay.norm2.weight, g2), (lay.norm2.bias, b2),
                         (lay.linear1.weight, w1.t()), (lay.linear1.bias, bb1),
                         (lay.linear2.weight, w2.t()), (lay.linear2.bias, bb2),
                         (enc.norm.weight, gp), (enc.norm.bias, bp)):
            dst.copy_(src)
    return enc.to(x.device, x.dtype)


def block_library_ms(x, params, y_plain, masks, g) -> tuple:
    """Rows 6 and 7's yardstick (:func:`library_encoder`) in bf16 on the
    same weights: the forward with grad (training mode, as the kernel's
    saving forward runs), the no-grad fast path (eval mode) and the
    autograd backward of the forward with grad for the cotangent g (the
    gradients of the tokens and every parameter). No branch masks (it has
    none): where the case has masks, its error against the plain version
    is not printed (NaN). Returns (ms with grad, ms no-grad, max|library -
    plain|, backward ms)."""
    import torch

    enc = library_encoder(x, params)
    xin = x.detach().requires_grad_(True)
    enc.train()
    with torch.enable_grad():
        grad_ms = median_ms(lambda: enc(xin))
        y = enc(xin)
        leaves = [xin, *enc.parameters()]
        bwd_ms = median_ms(lambda: torch.autograd.grad(y, leaves, g,
                                                       retain_graph=True))
    enc.eval()
    with torch.no_grad():
        fast_ms = median_ms(lambda: enc(xin))
    err = float("nan") if masks else max_err(y, y_plain)
    return grad_ms, fast_ms, err, bwd_ms


def block_saving_floor(x, params, masks, y, fwd) -> None:
    """Row 6's saving floor, printed beside its bound and not as it: the
    function (JAX's ``_block_kernel``) writes only its output, while the
    port's saving forward also writes what row 7 reads (h1, qkv, o, x1 f32,
    h2, hh f32, ge, y f32 before the post-norm); hh and y (3 KB a row at
    hid 512) could be recomputed by row 7 instead."""
    from pmce_tpu_torch.ops import fused_attention as fa

    rows_, C_ = x.shape[0] * x.shape[1], x.shape[-1]
    hid = params[8].shape[1]
    saved = rows_ * (C_ * (2 + 3 * 2 + 2 + 4 + 2 + 4) + hid * (4 + 2))
    recomputable = rows_ * (C_ * 4 + hid * 4)
    flops = count_flops(lambda: fwd(fa.transformer_block_plain))
    base = tensor_bytes(x, params, masks, y)
    floor_ms, by = bound(flops, base + saved, "bf16")
    lean_ms, lean_by = bound(flops, base + saved - recomputable, "bf16")
    print(f"[kernels] block_fwd saving floor (not its bound): "
          f"{floor_ms:.4f} ms by {by} with the saved state ({saved / 1e6:.2f}"
          f" MB); {lean_ms:.4f} ms by {lean_by} without hh and y "
          f"(recomputable, {recomputable / 1e6:.2f} MB)", flush=True)


def check_blocks(device, rows) -> None:
    """B6 / B7 at the training step's shapes (batch 64): block 0's spatial
    half (64·16 clips of 17 joints, no masks) and block 2's temporal half
    (64·17 clips of 16 frames, drop-path rate 0.2), each with its post-norm.
    Forward against the plain version; backward against the plain
    version's autograd (dx, 14 parameter gradients)."""
    import numpy as np
    import torch

    from pmce_tpu_torch.ops import fused_attention as fa

    rng = np.random.default_rng(2)
    for label, clips, N, rate in (
            ("block 0 spatial", BT * T, JT, 0.0),
            ("block 2 temporal", BT * JT, T, 0.2)):
        x, params, masks, g = block_case(rng, device, clips, N, rate)
        leaves = [x, *params]

        def fwd(fn):
            return fn(x, params, 8, 1e-6, 1e-6, masks)

        def bwd(y):
            return torch.autograd.grad(y, leaves, g, retain_graph=True)

        yk, yp = fwd(fa.transformer_block), fwd(fa.transformer_block_plain)
        gk, gp = bwd(yk), bwd(yp)
        torch.cuda.synchronize()
        where = f"{label} [{clips}, {N}, {C}]" + (
            f" masks rate {rate}" if masks else "")
        for name, outs_k, outs_p, peak_fn, pbytes in (
                ("block_fwd", (yk,), (yp,),
                 lambda: fwd(fa.transformer_block_plain),
                 tensor_bytes(x, params, masks, yk)),
                ("block_bwd", gk, gp, lambda: bwd(yp),
                 tensor_bytes(g, x, params, masks, gk))):
            err = rel = 0.0
            for a, b in zip(outs_k, outs_p):
                if not bool(torch.isfinite(a).all()):
                    raise RuntimeError(f"{name} {where}: non-finite output")
                e = max_err(a, b)
                err = max(err, e)
                rel = max(rel, e / float(b.float().abs().max()))
            if name == "block_fwd":
                ms = fwd_ms = median_ms(lambda: fwd(fa.transformer_block))
                plain_ms = median_ms(
                    lambda: fwd(fa.transformer_block_plain), iters=5)
            else:
                ms = bwd_ms = median_ms(lambda: bwd(yk))
                plain_ms = median_ms(lambda: bwd(yp), iters=5)
            ok = rel <= TOL[name]
            print(f"[kernels] {name} {where}: max_abs_err={err:.6g} "
                  f"max relative to max|plain| {rel:.4g} (tol {TOL[name]}) "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                  f"{'' if ok else '  FAIL'}", flush=True)
            if not ok:
                raise RuntimeError(f"{name} {where}: kernel disagrees with "
                                   f"its plain version ({rel})")
            record(rows, name, err, ms, plain_ms, count_flops(peak_fn),
                   pbytes, "bf16")
        block_saving_floor(x, params, masks, yk, fwd)
        if not torch.equal(yk, fwd(fa.transformer_block)):
            raise RuntimeError(f"block_fwd {where}: two runs differ")
        print(f"[kernels] block_fwd {where}: a second run gives the same "
              f"outputs bit for bit", flush=True)
        repeat = bwd(yk)
        if not all(torch.equal(a, b) for a, b in zip(gk, repeat)):
            raise RuntimeError(f"block_bwd {where}: two runs differ")
        print(f"[kernels] block_bwd {where}: a second run gives the same "
              f"gradients bit for bit", flush=True)
        lib_grad, lib_fast, lib_err, lib_bwd = block_library_ms(
            x, params, yp, masks, g)
        if rows["block_fwd"]["library_ms"] is None:
            rows["block_fwd"]["library_ms"] = lib_grad
            rows["block_bwd"]["library_ms"] = lib_bwd
        print(f"[kernels] library: nn.TransformerEncoder (pre-norm, erf "
              f"GELU, post-norm) {where}, bf16, no masks: {lib_grad:.4f} ms "
              f"with grad, {lib_fast:.4f} ms no-grad fast path (kernel "
              f"{fwd_ms:.4f} ms); autograd backward {lib_bwd:.4f} ms "
              f"(kernel {bwd_ms:.4f} ms); max|library - plain| "
              f"{lib_err:.4g}", flush=True)
        del yk, yp, gk, gp, repeat


def decoder_case(rng, device, kind: str, clips: int, N: int, c: int,
                 heads: int, Nk: int = 0, rate: float = 0.2):
    """One decoder attention block at the training shapes, made with numpy
    from a seed: bf16 tokens and AdaLN vectors (the dense layers' dtype),
    f32 weights, per-clip branch masks at drop-path ``rate`` (the AdaLN and
    CA blocks' on ``call.masks``, so that a case can ask for their
    gradients), the output's cotangent. Returns (leaves, call(fn, *leaves),
    (kernel, plain))."""
    import torch

    from pmce_tpu_torch.ops import fused_attention as fa

    def r(*shape, scale=0.2, offset=0.0, dtype=torch.float32):
        a = rng.normal(size=shape) * scale + offset
        return torch.from_numpy(a.astype("float32")).to(
            device, dtype).requires_grad_(True)

    bf = torch.bfloat16
    hid = 4 * c
    keep = 1.0 - rate
    masks = tuple(torch.from_numpy(((rng.random((clips, 1, 1)) < keep) / keep)
                                   .astype("float32")).to(device)
                  for _ in range(2))

    def w(i, o):
        return r(i, o, scale=i ** -0.5)

    mlp = [w(c, hid), r(hid, scale=0.02), w(hid, c), r(c, scale=0.02)]
    conds = [r(clips, c, scale=0.1, offset=1.0 - i % 2, dtype=bf)
             for i in range(8)]
    if kind == "mhsa":
        leaves = [r(clips, N, c, scale=1.0, dtype=bf), w(c, 3 * c),
                  r(3 * c, scale=0.02), w(c, c), r(c, scale=0.02)]
        return leaves, (lambda fn, x, *p: fn(x, *p, heads)), (
            fa.fused_mhsa, fa.mhsa_plain)
    if kind == "ada":
        leaves = [r(clips, N, c, scale=1.0, dtype=bf), *conds[:4],
                  w(c, 3 * c), r(3 * c, scale=0.02), w(c, c),
                  r(c, scale=0.02), *mlp]
        def ada(fn, x, g1, b1, g2, b2, *p):
            return fn(x, g1, b1, g2, b2, p, heads, 1e-6, ada.masks)

        ada.masks = masks
        return leaves, ada, (fa.ada_block, fa.ada_block_plain)
    proj = [t for _ in range(4) for t in (w(c, c), r(c, scale=0.02))]
    leaves = [r(clips, N, c, scale=1.0, dtype=bf),
              r(clips, Nk, c, scale=1.0, dtype=bf),
              r(clips, Nk, c, scale=1.0, dtype=bf), *conds, *proj, *mlp]
    def call(fn, xq, xk, xv, *rest):
        return fn(xq, xk, xv, rest[0:8:2], rest[1:8:2], rest[8:], heads, 1e-6,
                  call.masks)

    call.masks = masks
    return leaves, call, (fa.ca_block, fa.ca_block_plain)


def mask_gradients(key, zero, leaves, call, kernel, plain, g,
                   where) -> None:
    """A decoder block's backward with branch masks that require grad
    (JAX's kernels return their gradients): every gradient, dm1 and dm2
    included, against the plain version's autograd within the block's band
    (the gradients at ``zero``, analytically zero, relative to the largest
    gradient), and a rerun bit for bit."""
    import torch

    masks = call.masks
    call.masks = tuple(m.detach().requires_grad_(True) for m in masks)
    every = [*leaves, *call.masks]
    try:
        yk, yp = call(kernel, *leaves), call(plain, *leaves)
        gk = torch.autograd.grad(yk, every, g, retain_graph=True)
        again = torch.autograd.grad(yk, every, g)
        gp = torch.autograd.grad(yp, every, g)
    finally:
        call.masks = masks
    largest = max(float(t.float().abs().max()) for t in gp)
    rel = 0.0
    for i, (a, b) in enumerate(zip(gk, gp)):
        scale = largest if i in zero else float(b.float().abs().max())
        rel = max(rel, max_err(a, b) / scale)
    dm = [max_err(a, b) / float(b.abs().max()) for a, b in zip(gk[-2:],
                                                               gp[-2:])]
    ok = rel <= TOL[key]
    print(f"[kernels] {key} {where}, mask gradients: max relative "
          f"{rel:.4g} (dm1 {dm[0]:.3g}, dm2 {dm[1]:.3g}; tol "
          f"{TOL[key]}){'' if ok else '  FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"{key} {where}: mask gradients disagree with "
                           f"the plain version's ({rel})")
    if not all(torch.equal(a, b) for a, b in zip(gk, again)):
        raise RuntimeError(f"{key} {where}: two runs with mask gradients "
                           "differ")
    print(f"[kernels] {key} {where}, mask gradients: a second run gives "
          "the same gradients bit for bit", flush=True)


def ca_mask_gradients(*args) -> None:
    """Row 11 with branch masks that require grad (:func:`mask_gradients`;
    the keys' bias and AdaLN beta are zero analytically)."""
    mask_gradients("ca_block_bwd", (6, 14), *args)


def ada_mask_gradients(*args) -> None:
    """Row 9 with branch masks that require grad (:func:`mask_gradients`)."""
    mask_gradients("ada_block_bwd", (), *args)


def mha_library_ms(leaves, heads: int) -> tuple[float, float]:
    """The yardstick of rows 4 / 5: one PyTorch call computing the same
    function, ``F.multi_head_attention_forward`` in bf16 on the same
    tokens and weights, and its autograd backward (timed here only; the
    port never calls it)."""
    import torch
    import torch.nn.functional as F

    x, wqkv, bqkv, wproj, bproj = (t.detach() for t in leaves)
    bf = torch.bfloat16
    args = [x.transpose(0, 1).contiguous(), wqkv.t().to(bf).contiguous(),
            bqkv.to(bf), wproj.t().to(bf).contiguous(), bproj.to(bf)]
    args = [a.requires_grad_(True) for a in args]
    C = x.shape[-1]

    def fwd():
        q, w_in, b_in, w_out, b_out = args
        return F.multi_head_attention_forward(
            q, q, q, C, heads, w_in, b_in, None, None, False, 0.0, w_out,
            b_out, training=True, need_weights=False)[0]

    y = fwd()
    g = torch.randn_like(y)
    return (median_ms(fwd), median_ms(lambda: torch.autograd.grad(
        y, args, g, retain_graph=True)))


def mhsa_backward_launches(bwd, y, where: str):
    """Row 5's backward under autograd with the entry points of its
    library recorded and any transposed weight copy refused: exactly the
    tile program, then the weight launch. Returns the gradients."""
    from unittest import mock

    from pmce_tpu_torch.ops import _cuda
    from pmce_tpu_torch.ops import fused_attention as fa

    names = []
    real = _cuda.MHSA.call

    def spy(name, *args):
        names.append(name)
        return real(name, *args)

    def no_copy(*args, **kwargs):
        raise RuntimeError(f"mhsa_bwd {where}: a transposed weight copy")

    with mock.patch.object(_cuda.MHSA, "call", spy), \
            mock.patch.object(fa, "_bf16_mat_t", no_copy):
        grads = bwd(y)
    if not y.is_cuda:  # a rehearsal on the CPU: the plain version
        return grads
    if names != ["pmce_mhsa_bwd_tile", "pmce_mhsa_wgrad"]:
        raise RuntimeError(f"mhsa_bwd {where}: launches {names}, expected "
                           "the tile program and the weight launch")
    print(f"[kernels] mhsa_bwd {where}: the backward is exactly "
          f"{' then '.join(names)}, no transposed weight copy", flush=True)
    return grads


def ada_fwd_waves(device, tag: str) -> int:
    """Print the CTAs of row 8's forward (launch B, 4 a clip) the card holds
    at once and the waves a batch of BM clips takes; return the waves."""
    import torch

    from pmce_tpu_torch.ops import fused_attention as fa

    resident, waves = fa.ada_fwd_waves(BM)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print(f"{tag} row 8's forward (ada_block_fwd): {resident} CTAs co-resident "
          f"on {sms} SMs; a batch of {BM} clips is {BM * fa.ADA_FWD_CTAS} "
          f"CTAs: {waves} wave(s)", flush=True)
    return waves


def check_decoder_blocks(device, rows) -> None:
    """Rows 4, 5, 8-11 at the Stage-2 step's shapes (batch 32, C = 64,
    drop-path masks at rate 0.2): the joint stream's self-attention
    [32, 17, 64] with 8 heads, the vertex stream's AdaLN block [32, 431, 64]
    with 2 heads, both cross-attentions (17 joints over 431 vertices, 8
    heads; 431 over 17, 2 heads), and row 4 at the trunk backward's spatial
    shape [32 * 16, 17, 256]. Forward against the plain version; backward
    against the plain version's autograd, each gradient relative to its
    largest magnitude (the keys' bias and AdaLN β, zero analytically,
    relative to the largest gradient); a second backward must give the
    same gradients bit for bit."""
    import numpy as np
    import torch

    from pmce_tpu_torch.ops import _cuda

    if device.type == "cuda":
        held = {"ca_block_fwd": _cuda.CA.query("pmce_ca_tile_clusters", 1),
                "ca_block_bwd": _cuda.CA.query("pmce_ca_tile_clusters", 0),
                "ada_block_bwd": _cuda.ADA.query("pmce_ada_tile_clusters")}
        print(f"[kernels] clusters of 4 CTAs the card holds at once, by tile "
              f"program: {held}; a batch of {BM} clips takes "
              f"{-(-BM // min(held.values()))} wave(s)", flush=True)
        ada_fwd_waves(device, "[kernels]")
    rng = np.random.default_rng(5)
    cases = (("mhsa", "joint self-attention", BM, JT, 64, 8, 0),
             ("ada_block", "vertex AdaLN block", BM, 431, 64, 2, 0),
             ("ca_block", "joint cross-attention", BM, JT, 64, 8, 431),
             ("ca_block", "vertex cross-attention", BM, 431, 64, 2, JT),
             ("mhsa", "trunk backward, spatial", BM * T, JT, C, 8, 0))
    for name, label, clips, N, c, heads, Nk in cases:
        kind = {"mhsa": "mhsa", "ada_block": "ada", "ca_block": "ca"}[name]
        leaves, call, (kernel, plain) = decoder_case(
            rng, device, kind, clips, N, c, heads, Nk)
        g = torch.from_numpy(rng.normal(size=tuple(leaves[0].shape)).astype(
            "float32")).to(device, torch.bfloat16)
        zero = (6, 14) if kind == "ca" else ()

        def bwd(y):
            return torch.autograd.grad(y, leaves, g, retain_graph=True)

        yk, yp = call(kernel, *leaves), call(plain, *leaves)
        where = (f"{label} [{clips}, {N}, {c}]" + (f" over {Nk} keys"
                                                    if Nk else "")
                 + f", {heads} heads")
        gk = (mhsa_backward_launches(bwd, yk, where) if kind == "mhsa"
              else bwd(yk))
        gp = bwd(yp)
        torch.cuda.synchronize()
        largest = max(float(t.float().abs().max()) for t in gp)
        for stage, outs_k, outs_p, flop_fn, nbytes in (
                ("fwd", (yk,), (yp,), lambda: call(plain, *leaves),
                 tensor_bytes(leaves, yk)),
                ("bwd", gk, gp, lambda: bwd(yp),
                 tensor_bytes(g, leaves, gk))):
            err = rel = 0.0
            for i, (a, b) in enumerate(zip(outs_k, outs_p)):
                if not bool(torch.isfinite(a).all()):
                    raise RuntimeError(f"{name}_{stage} {where}: non-finite")
                e = max_err(a, b)
                err = max(err, e)
                scale = largest if (stage == "bwd" and i in zero) else float(
                    b.float().abs().max())
                rel = max(rel, e / scale)
            if stage == "fwd":
                ms = median_ms(lambda: call(kernel, *leaves))
                plain_ms = median_ms(lambda: call(plain, *leaves), iters=5)
            else:
                ms = median_ms(lambda: bwd(yk))
                plain_ms = median_ms(lambda: bwd(yp), iters=5)
            key = f"{'mhsa' if kind == 'mhsa' else name}_{stage}"
            ok = rel <= TOL[key]
            print(f"[kernels] {key} {where}: max_abs_err={err:.6g} max "
                  f"relative {rel:.4g} (tol {TOL[key]}) kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms{'' if ok else '  FAIL'}",
                  flush=True)
            if not ok:
                raise RuntimeError(f"{key} {where}: kernel disagrees with "
                                   f"its plain version ({rel})")
            record(rows, key, err, ms, plain_ms, count_flops(flop_fn),
                   nbytes, "bf16")
        repeat = bwd(yk)
        if not all(torch.equal(a, b) for a, b in zip(gk, repeat)):
            raise RuntimeError(f"{name}_bwd {where}: two runs differ")
        print(f"[kernels] {name}_bwd {where}: a second run gives the same "
              f"gradients bit for bit", flush=True)
        if kind == "ca":
            ca_mask_gradients(leaves, call, kernel, plain, g, where)
        if kind == "ada":
            ada_mask_gradients(leaves, call, kernel, plain, g, where)
        if kind == "mhsa":
            # Every mhsa case gets its yardstick; the kernels line keeps
            # the first case's, beside that case's kernel time.
            lib_f, lib_b = mha_library_ms(leaves, heads)
            if rows["mhsa_fwd"]["library_ms"] is None:
                rows["mhsa_fwd"]["library_ms"] = lib_f
                rows["mhsa_bwd"]["library_ms"] = lib_b
            print(f"[kernels] library: F.multi_head_attention_forward "
                  f"{where}, bf16: forward {lib_f:.4f} ms, autograd "
                  f"backward {lib_b:.4f} ms", flush=True)
            # Row 4 against its library call, three more times in turn at
            # both shapes: whether it loses.
            for rep in range(3):
                k_ms = median_ms(lambda: call(kernel, *leaves))
                l_ms = mha_library_ms(leaves, heads)[0]
                print(f"[kernels] mhsa_fwd {where}, repetition "
                      f"{rep + 1}: kernel {k_ms:.4f} ms, library "
                      f"{l_ms:.4f} ms ({k_ms / l_ms:.2f}x)", flush=True)
        del yk, yp, gk, gp, repeat, leaves


def check_skinning(device, rows) -> None:
    """#15 at the SMPL forward's shapes: B=256 posed bodies of the 6890-
    vertex stand-in, full f32, against the plain skinning."""
    import numpy as np
    import torch

    from pmce_tpu_torch.smpl import kernels as sk
    from pmce_tpu_torch.smpl.artifacts import ensure_cached_artifacts
    from pmce_tpu_torch.smpl.layer import (
        SMPLModel,
        apply_skinning,
        skinning_transforms,
    )

    model = SMPLModel.from_artifacts(ensure_cached_artifacts(), device=device)
    rng = np.random.default_rng(3)
    pose = torch.from_numpy(rng.normal(scale=0.4, size=(B, 72)).astype(
        np.float32)).to(device)
    betas = torch.from_numpy(rng.normal(size=(B, 10)).astype(
        np.float32)).to(device)
    args = skinning_transforms(model, pose, betas)[:2] + (model.lbs_weights,)
    got = sk.fused_skinning(*args)
    want = apply_skinning(*args)
    torch.cuda.synchronize()
    err = max_err(got, want)
    ms = median_ms(lambda: sk.fused_skinning(*args))
    plain_ms = median_ms(lambda: apply_skinning(*args), iters=5)
    ok = bool(torch.isfinite(got).all()) and err <= SKIN_TOL_M
    print(f"[kernels] skinning B={B} V={args[0].shape[1]} J=24: "
          f"max_abs_err={err:.3g} m (tol {SKIN_TOL_M} m) kernel {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms{'' if ok else '  FAIL'}", flush=True)
    if not ok:
        raise RuntimeError("skinning: kernel disagrees with its plain "
                           f"version ({err} m)")
    flops = count_flops(lambda: apply_skinning(*args))
    record(rows, "skinning", err, ms, plain_ms, flops,
           tensor_bytes(args, got), "f32")
    # The yardstick: one einsum of the weights, the transforms' rows 0-2 and
    # the homogeneous vertices, made beforehand (f32, TF32 off: PyTorch's
    # default for matrix products, stated here).
    torch.backends.cuda.matmul.allow_tf32 = False
    v, A, w = args
    vh = torch.cat([v, torch.ones_like(v[..., :1])], -1)
    A3 = A[:, :, :3, :].contiguous()

    def library():
        return torch.einsum("vj,bjmk,bvk->bvm", w, A3, vh)

    lib_ms = median_ms(library)
    rows["skinning"]["library_ms"] = lib_ms
    row = rows["skinning"]
    print(f"[kernels] skinning B={B}: kernel {ms:.4f} ms at "
          f"{row['bound_ms'] / ms:.1%} of its bound {row['bound_ms']:.4f} ms "
          f"(by {row['bound_by']}); library torch.einsum {lib_ms:.4f} ms "
          f"(max|library - plain| {max_err(library(), want):.3g} m)",
          flush=True)


def serve_rate(model, pose2d, img_feat,
               iters: int = 10) -> tuple[float, float]:
    """(ms per batch, mid-frames/s): host clock around ``iters`` forwards
    ending in a synchronize, after 2 warm-up forwards."""
    import torch

    with torch.no_grad():
        for _ in range(2):
            model(pose2d, img_feat)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            model(pose2d, img_feat)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    return dt / iters * 1e3, pose2d.shape[0] * iters / dt


def serve(device, profile: bool) -> tuple[float, dict, float, dict]:
    """Phase 3: the full-width bf16 serving forward on the kernel path;
    phase 3b: the same with ``whole_block_kernel``. Returns both rates and
    both launch counts."""
    from unittest import mock

    import numpy as np
    import torch

    from pmce_tpu_torch.models.pmce import create_pmce
    from pmce_tpu_torch.ops import _cuda
    from pmce_tpu_torch.ops import fused_attention as fa
    from pmce_tpu_torch.ops import fused_coevo_chain as fc
    from pmce_tpu_torch.smpl.artifacts import ensure_cached_artifacts
    from pmce_tpu_torch.smpl.mesh import ensure_cached_coarsening
    from torch_port_init import perturbed_init

    t0 = time.time()
    art = ensure_cached_artifacts()
    coarse = ensure_cached_coarsening()
    model, _ = create_pmce(num_joint=J, art=art, coarsening=coarse,
                           dtype=torch.bfloat16, fused=True, device=device,
                           seed=0)
    # JAX's initial values have zero biases and unit LayerNorm scales; the
    # parity tests' perturbation (tests/torch_port_init.py) makes every bias
    # path of the kernel-vs-plain comparison count.
    perturbed_init(model, torch.Generator().manual_seed(0))
    nparams = sum(p.numel() for p in model.parameters())
    print(f"[serve] model ready: {nparams / 1e6:.1f} M params, "
          f"{time.time() - t0:.1f} s (artifacts, assets, weights perturbed "
          f"off JAX's initial values from seed 0)", flush=True)

    rng = np.random.default_rng(0)
    pose2d = torch.from_numpy(
        rng.standard_normal((B, T, J, 2), dtype=np.float32)).to(device)
    img_feat = torch.from_numpy(
        rng.standard_normal((B, T, 2048), dtype=np.float32)).to(device)
    names = ("mesh", "evo_pose", "pose3d")
    expect = {"mesh": (B, art.num_verts, 3), "evo_pose": (B, J, 3),
              "pose3d": (B, J, 3)}

    def counted_forward(m, tag, must):
        with torch.no_grad():
            _cuda.reset_launch_counts()
            outs = dict(zip(names, m(pose2d, img_feat)))
            torch.cuda.synchronize()
            counts = _cuda.launch_counts()
        print(f"{tag} launches on the serving forward: {counts}", flush=True)
        missing = [k for k in must if counts[k] == 0]
        if missing:
            raise RuntimeError(f"kernels not launched on the serving path: "
                               f"{missing}")
        if counts["lifter_trunk_long"]:
            raise RuntimeError("the serving trunk took the long-group route")
        for name, t in outs.items():
            if tuple(t.shape) != expect[name] or t.dtype != torch.float32:
                raise RuntimeError(f"{name}: {tuple(t.shape)} {t.dtype}")
            if not bool(torch.isfinite(t).all()):
                raise RuntimeError(f"{name}: non-finite values")
        return outs, counts

    def agree(tag, outs, ref, what):
        for name, t in outs.items():
            scale = float(ref[name].abs().max())
            err = max_err(t, ref[name])
            print(f"{tag} {name} vs {what}: max_abs_err={err:.6g} (max |x| "
                  f"{scale:.4g}, tol {SERVE_REL_TOL} x max)", flush=True)
            if err > SERVE_REL_TOL * scale:
                raise RuntimeError(f"{tag} {name}: disagrees with {what}")

    def forward(m):
        with torch.no_grad():
            return m(pose2d, img_feat)

    def plain_forward(m):
        # The same model through the plain versions (comparisons only).
        with torch.no_grad(), plain_gru(fa), \
                mock.patch.object(fa, "lifter_trunk", fa.lifter_trunk_plain), \
                mock.patch.object(fc, "coevo_chain", fc.coevo_chain_plain), \
                mock.patch.object(fc, "coevo_block", fc.coevo_block_plain):
            return dict(zip(names, m(pose2d, img_feat)))

    outs, counts = counted_forward(model, "[serve]", SERVING)
    if counts["gru_scan"] != SERVING_GRU_SCANS:
        raise RuntimeError(f"the serving forward launched the GRU scan "
                           f"{counts['gru_scan']} times, expected "
                           f"{SERVING_GRU_SCANS} (one per BiGRU layer)")
    agree("[serve]", outs, plain_forward(model), "the plain path")
    check_f32_small(model, device)
    ms, fps = serve_rate(model, pose2d, img_feat)
    print(f"[serve] bf16 fused forward, B={B}: {ms:.3f} ms per batch, "
          f"{fps:.1f} mid-frames/s on {card_line()}", flush=True)
    if profile:
        profile_step(lambda: forward(model), "serving forward")

    # Phase 3b: whole_block_kernel on the same weights and inputs.
    whole, _ = create_pmce(num_joint=J, art=art, coarsening=coarse,
                           dtype=torch.bfloat16, fused=True,
                           whole_block_kernel=True, device=device, seed=0)
    whole.load_state_dict(model.state_dict())
    wouts, wcounts = counted_forward(whole, "[serve-wb]", WHOLE_BLOCK)
    nb = whole.pose_mesh_coevo.num_blocks
    want = {**{k: counts[k] for k in ("lifter_trunk", "gru_layer",
                                      "gru_layer_rev", "gru_scan")},
            "coevo_block": nb, "coevo_chain": 0}
    wrong = {k: (v, wcounts[k]) for k, v in want.items() if wcounts[k] != v}
    if wrong:
        raise RuntimeError(f"whole-block serving: launches (expected, "
                           f"counted) {wrong}")
    agree("[serve-wb]", wouts, plain_forward(whole), "the plain path")
    agree("[serve-wb]", wouts, outs, "phase 3's chain path")
    wms, wfps = serve_rate(whole, pose2d, img_feat)
    print(f"[serve-wb] bf16 whole-block forward, B={B}: {wms:.3f} ms per "
          f"batch, {wfps:.1f} mid-frames/s ({wfps / fps:.3f}x phase 3's "
          f"{fps:.1f} in this run) on {card_line()}", flush=True)
    if profile:
        profile_step(lambda: forward(whole), "whole-block serving forward")
    del model, whole
    torch.cuda.empty_cache()
    return fps, counts, wfps, wcounts


def check_f32_small(model, device) -> None:
    """A small f32 input through the modular path: the card vs the CPU."""
    import copy

    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = copy.deepcopy(model).float()
    for m in (f32.pose_lifter, f32.pose_mesh_coevo):
        m.dtype, m.fused = None, False
    rng = np.random.default_rng(1)
    pose2d = torch.from_numpy(rng.standard_normal((2, T, J, 2),
                                                  dtype=np.float32))
    img_feat = torch.from_numpy(rng.standard_normal((2, T, 2048),
                                                    dtype=np.float32))
    with torch.no_grad():
        on_card = f32(pose2d.to(device), img_feat.to(device))
        on_cpu = f32.cpu()(pose2d, img_feat)
    for name, a, b in zip(("mesh", "evo_pose", "pose3d"), on_card, on_cpu):
        err = max_err(a.cpu(), b)
        tol = 1e-3 * max(1.0, float(b.abs().max()))
        print(f"[serve] f32 B=2 card vs CPU {name}: max_abs_err={err:.3g} "
              f"(tol {tol:.3g}, TF32 off)", flush=True)
        if err > tol:
            raise RuntimeError(f"f32 {name}: card and CPU disagree")


def pose_h36m_config():
    """``configs/train_pose_h36m.yml`` (the reference's Stage-1 recipe), its
    values set here so that no YAML package is needed, under the bf16 +
    fused policy, then cut to two short epochs. The learning rate is raised
    from 5e-5 to 1e-3 so that two short epochs show the loss fall, as
    ``tests/test_trainer.py::test_lift_training`` does."""
    from pmce_tpu_torch.core.config import Config

    cfg = Config()
    d, m, t, e = cfg.DATASET, cfg.MODEL, cfg.TRAIN, cfg.TEST
    d.train_list, d.test_list = ["Human36M"], ["Human36M"]
    d.input_joint_set = d.target_joint_set = "human36"
    d.use_gt_input, d.seqlen, d.stride, d.synthetic = False, T, 1, True
    m.name, m.hpe_dim, m.hpe_dep = "PoseEst", 256, 3
    m.compute_dtype, m.fused_attn = "bfloat16", True
    t.batch_size, t.shuffle, t.begin_epoch, t.end_epoch = BT, True, 1, 60
    t.scheduler, t.lr, t.lr_step, t.lr_factor = "step", 5e-5, [10, 30, 50], 0.8
    t.optimizer = "adam"
    e.batch_size, e.shuffle = BT, False
    t.end_epoch, t.steps_per_epoch, t.lr = 2, TRAIN_STEPS, 1e-3
    return cfg


def standin_h36m_regressor(num_verts: int, seed: int = 7):
    """A sparse row-stochastic [17, V] H36M regressor: the JAX package's
    synthetic stand-in recipe (``synthetic_regressors``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    jr = np.zeros((JT, num_verts), dtype=np.float32)
    for j in range(JT):
        idx = rng.choice(num_verts, size=max(4, num_verts // (4 * JT)),
                         replace=False)
        w = rng.random(len(idx))
        jr[j, idx] = (w / w.sum()).astype(np.float32)
    return jr


def train(device, profile: bool) -> tuple[dict, float, dict]:
    """Phase 4: Stage-1 lifter training on the kernel path. Returns the
    counts, the step's ms and what phase 5 starts from (the sequences, the
    H36M regressor and the best checkpoint)."""
    import contextlib
    import shutil
    from unittest import mock

    import numpy as np
    import torch

    from pmce_tpu_torch.core.losses import coord_l1
    from pmce_tpu_torch.core.trainer import Trainer
    from pmce_tpu_torch.data.clip_dataset import ClipDataset, MultiDataset
    from pmce_tpu_torch.data.synthetic import generate_sequences
    from pmce_tpu_torch.models.pmce import resolve_compute_dtype
    from pmce_tpu_torch.models.pose_lifter import create_pose_lifter
    from pmce_tpu_torch.ops import _cuda
    from pmce_tpu_torch.ops import fused_attention as fa
    from pmce_tpu_torch.smpl.artifacts import ensure_cached_artifacts

    cfg = pose_h36m_config()
    art = ensure_cached_artifacts()
    jr = standin_h36m_regressor(art.num_verts)
    ckpt_dir = REPO / "pmce_tpu_torch" / "_build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def lifter():
        return create_pose_lifter(
            num_joints=JT, num_frames=cfg.DATASET.seqlen,
            embed_dim=cfg.MODEL.hpe_dim, depth=cfg.MODEL.hpe_dep,
            drop_path_rate=0.2,
            dtype=resolve_compute_dtype(cfg.MODEL.compute_dtype),
            fused=cfg.MODEL.fused_attn, device=device, seed=cfg.TRAIN.seed)

    def trainer_for(model, ckpt=""):
        return Trainer(cfg=cfg, model=model,
                       train_data=MultiDataset([train_ds], seed=0),
                       test_data=test_ds, ckpt_dir=ckpt, device=device,
                       log_fn=lambda s: print(f"[train] {s}", flush=True))

    # The main path: synthesis on the card, then the fit, counted.
    t0 = time.time()
    _cuda.reset_launch_counts()
    # A synthetic H36M split as the JAX dataset factory sizes it: 2 videos
    # of max(2·seqlen, 256 // 2) = 128 frames.
    seqs = [generate_sequences(art, jr, num_videos=2, frames_per_video=128,
                               seed=s, device=device) for s in (0, 100)]
    train_ds = ClipDataset(seqs[0], seqlen=T, stride=1, chunk_mode="pose")
    test_ds = ClipDataset(seqs[1], seqlen=T, stride=1, chunk_mode="pose")
    trainer = trainer_for(lifter(), str(ckpt_dir))
    state = trainer.fit()
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    print(f"[train] launches on the training path: {counts} "
          f"({time.time() - t0:.1f} s: synthesis of {len(seqs[0]) * 2} "
          f"frames at {art.num_verts} vertices, {2 * TRAIN_STEPS} steps, "
          f"2 evaluations of {len(test_ds)} clips)", flush=True)
    steps = 2 * TRAIN_STEPS
    evals = 2 * -(-len(test_ds) // BT)
    expect = {"block_fwd": 6 * steps, "block_bwd": 6 * steps,
              "lifter_trunk": evals, "skinning": 4}
    if counts["lifter_trunk_long"]:
        raise RuntimeError("the evaluation trunk took the long-group route")
    for name in TRAINING:
        if counts[name] == 0 or counts[name] != expect[name]:
            raise RuntimeError(f"training path: {name} launched "
                               f"{counts[name]} times, expected "
                               f"{expect[name]}")
    losses, errs = trainer.loss_history, trainer.error_history["joint"]
    if not all(np.isfinite(losses + errs)):
        raise RuntimeError(f"non-finite losses {losses} or errors {errs}")
    if not losses[1] < losses[0]:
        raise RuntimeError(f"the loss did not fall: {losses}")
    files = sorted(f.name for f in ckpt_dir.iterdir())
    if files != ["best.ckpt", "checkpoint1.ckpt", "final.ckpt"]:
        raise RuntimeError(f"checkpoints: {files}")
    fresh = trainer_for(create_pose_lifter(
        num_joints=JT, embed_dim=256, depth=3, device=device, seed=99))
    restored, epoch = fresh.restore(str(ckpt_dir))
    same = all(torch.equal(a, b) for a, b in zip(
        trainer.model.state_dict().values(),
        fresh.model.state_dict().values()))
    if epoch != 2 or restored.step != steps or not same:
        raise RuntimeError("restore did not give back the final state")
    print(f"[train] epoch losses {losses}, MPJPE {errs} mm; checkpoints "
          f"{files}; restore gives back epoch {epoch}, step {steps} and "
          f"every parameter", flush=True)

    # First step: kernel path vs plain path, same weights, batch, masks.
    batch = trainer._wire_cast(train_ds.get_batch(np.arange(BT)))

    def first_step(plain: bool):
        model = lifter().train()
        ctx = (mock.patch.object(fa, "transformer_block",
                                 fa.transformer_block_plain)
               if plain else contextlib.nullcontext())
        with ctx:
            pred = model(batch["pose2d"], batch["img_feature"],
                         generator=torch.Generator(device).manual_seed(7))
            loss = coord_l1(pred, batch["lift_pose3d"],
                            batch["lift_pose3d_valid"])
            loss.backward()
        return float(loss), {n: p.grad for n, p in model.named_parameters()}

    loss_k, grads_k = first_step(False)
    loss_p, grads_p = first_step(True)
    worst = max((max_err(grads_k[n], g) / max(max_err(g, 0 * g), 1e-30), n)
                for n, g in grads_p.items())
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"[train] first step, kernel vs plain path: loss {loss_k:.6g} vs "
          f"{loss_p:.6g} (relative {loss_rel:.3g}, tol {STEP_LOSS_REL_TOL});"
          f" largest gradient difference {worst[0]:.4g} of max|grad| in "
          f"{worst[1]} (tol {STEP_GRAD_REL_TOL})", flush=True)
    if loss_rel > STEP_LOSS_REL_TOL or worst[0] > STEP_GRAD_REL_TOL:
        raise RuntimeError("first train step: kernel and plain paths "
                           "disagree")

    # Step time: host clock around one step ending in a synchronize.
    gen = torch.Generator(device).manual_seed(1)

    def step_ms(iters: int, warmup: int = 3) -> float:
        times = []
        for i in range(warmup + iters):
            torch.cuda.synchronize()
            t = time.perf_counter()
            trainer.train_step(state, batch, gen)
            torch.cuda.synchronize()
            if i >= warmup:
                times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    torch.cuda.reset_peak_memory_stats()
    ms = step_ms(10)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with mock.patch.object(fa, "transformer_block",
                           fa.transformer_block_plain):
        plain = step_ms(5, warmup=2)
    print(f"[train] bf16 fused train step, batch {BT}: {ms:.3f} ms "
          f"(median of 10), {BT / ms * 1e3:.1f} clips/s; plain path "
          f"{plain:.3f} ms; peak device memory {peak:.2f} GiB; on "
          f"{card_line()}", flush=True)
    if profile:
        profile_step(lambda: trainer.train_step(state, batch, gen))
    return counts, ms, {"seqs": seqs, "jr": jr, "art": art,
                        "ckpt": ckpt_dir / "best.ckpt"}


def mesh_h36m_config(posenet_path: str, fused: bool = True):
    """``configs/train_mesh_h36m_bf16.yml`` (the Stage-2 recipe under the
    bf16 policy, ``MODEL.fused_attn: true``), its values set here so that
    no YAML package is needed; ``fused=False`` overrides ``fused_attn`` to
    false (phase 5). Then cut: 2 epochs × 25 steps (not 30 epochs of the
    whole split), lr 1e-3 (not 1e-4) so that two short epochs show the loss
    fall, ``edge_loss_start`` 1 (not 10) so that epoch 2 trains with the
    edge term. The lifter warm-starts from ``posenet_path`` (the file sets
    ``posenet_pretrained``)."""
    from pmce_tpu_torch.core.config import Config

    cfg = Config()
    d, m, t, e = cfg.DATASET, cfg.MODEL, cfg.TRAIN, cfg.TEST
    d.train_list, d.test_list = ["Human36M"], ["Human36M"]
    d.input_joint_set = d.target_joint_set = "human36"
    d.use_gt_input, d.synthetic = False, True
    m.name, m.hpe_dim, m.hpe_dep, m.joint_dim, m.vertx_dim = (
        "PMCE", 256, 3, 64, 64)
    m.normal_loss_weight, m.edge_loss_weight, m.joint_loss_weight = (
        0.1, 20.0, 0.001)
    m.posenet_pretrained, m.compute_dtype = True, "bfloat16"
    m.fused_attn = fused
    t.batch_size, t.shuffle, t.begin_epoch, t.end_epoch = BM, True, 1, 30
    t.edge_loss_start, t.scheduler, t.lr = 10, "step", 1e-4
    t.lr_step, t.lr_factor, t.optimizer = [10, 20], 0.9, "adam"
    e.batch_size, e.shuffle = 64, False
    t.end_epoch, t.steps_per_epoch, t.lr, t.edge_loss_start = (
        2, TRAIN_STEPS, 1e-3, 1)
    m.posenet_path = posenet_path
    return cfg


def mesh_train(device, stage1: dict, profile: bool, fused: bool,
               unfused_ms: float | None = None) -> tuple[dict, float]:
    """Stage-2 mesh training of the full-width PMCE: phase 5 without
    ``fused_attn``, phase 6 with it (``unfused_ms``: phase 5's step, printed
    beside phase 6's)."""
    import contextlib
    from unittest import mock

    import numpy as np
    import torch

    from pmce_tpu_torch.core.losses import build_face_losses
    from pmce_tpu_torch.core.trainer import Trainer, pmce_loss
    from pmce_tpu_torch.data.clip_dataset import ClipDataset, MultiDataset
    from pmce_tpu_torch.models.pmce import (
        create_pmce,
        load_lifter_checkpoint,
        resolve_compute_dtype,
    )
    from pmce_tpu_torch.ops import _cuda
    from pmce_tpu_torch.ops import fused_attention as fa
    from pmce_tpu_torch.smpl.mesh import ensure_cached_coarsening

    tag = "[fused]" if fused else "[mesh]"
    cfg = mesh_h36m_config(str(stage1["ckpt"]), fused)
    art, jr = stage1["art"], stage1["jr"]
    coarse = ensure_cached_coarsening()

    def pmce():
        model, _ = create_pmce(
            num_joint=JT, art=art, coarsening=coarse,
            joint_regressor_h36m=jr, embed_dim=cfg.MODEL.hpe_dim,
            depth=cfg.MODEL.hpe_dep, seqlen=cfg.DATASET.seqlen,
            dtype=resolve_compute_dtype(cfg.MODEL.compute_dtype),
            fused=cfg.MODEL.fused_attn, device=device, seed=cfg.TRAIN.seed)
        if cfg.MODEL.posenet_pretrained and cfg.MODEL.posenet_path:
            load_lifter_checkpoint(model, cfg.MODEL.posenet_path)
        return model

    train_ds, test_ds = (ClipDataset(sq, seqlen=T, stride=1,
                                     chunk_mode="mesh")
                         for sq in stage1["seqs"])
    trainer = Trainer(cfg=cfg, model=pmce(),
                      train_data=MultiDataset([train_ds], seed=0),
                      test_data=test_ds, faces=art.faces, J_reg_target=jr,
                      device=device,
                      log_fn=lambda s: print(f"{tag} {s}", flush=True))
    nparams = sum(p.numel() for p in trainer.model.parameters())
    print(f"{tag} PMCE {nparams / 1e6:.1f} M params, fused_attn "
          f"{cfg.MODEL.fused_attn}, lifter from "
          f"{Path(cfg.MODEL.posenet_path).name}; {len(train_ds)} train / "
          f"{len(test_ds)} test clips", flush=True)

    # No checkpoints: phase 4 and the CPU tests cover them, and each of
    # this model's would be ~1.2 GB with its Adam state.
    # A fixed batch: the six-term loss (edge term on) in eval mode before
    # and after the fit, and the step timings below.
    batch = trainer._wire_cast(train_ds.get_batch(np.arange(BM)))
    dev = torch.device(device)
    J_reg = torch.as_tensor(jr, device=dev)
    faces = torch.as_tensor(art.faces, dtype=torch.long, device=dev)
    face_fn = build_face_losses(art.faces, art.num_verts, dev)
    weights = (cfg.MODEL.normal_loss_weight, cfg.MODEL.edge_loss_weight,
               cfg.MODEL.joint_loss_weight)

    def fixed_loss(model) -> float:
        with torch.no_grad():
            return float(pmce_loss(model.eval(), batch, faces, J_reg,
                                   weights, 1.0, face_fn)[0])

    if fused and torch.device(device).type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        if ada_fwd_waves(device, tag) > 1 and sms >= 128:
            raise RuntimeError(f"row 8's forward takes more than one wave "
                               f"at batch {BM} on {sms} SMs")
    before = fixed_loss(trainer.model)
    t0 = time.time()
    _cuda.reset_launch_counts()
    state = trainer.fit()
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    steps = 2 * TRAIN_STEPS
    evals = 2 * -(-len(test_ds) // cfg.TEST.batch_size)
    print(f"{tag} launches on the Stage-2 training path: {counts} "
          f"({time.time() - t0:.1f} s: {steps} steps, 2 evaluations of "
          f"{len(test_ds)} clips)", flush=True)
    expect = stage2_launches(steps, evals, fused)
    if fused:
        check_fused_launches(counts, expect, "fused Stage-2 path")
    else:
        for name in MESH_TRAINING:
            if counts[name] == 0 or counts[name] != expect[name]:
                raise RuntimeError(f"mesh training path: {name} launched "
                                   f"{counts[name]} times, expected "
                                   f"{expect[name]}")
        for name in MESH_IDLE:
            if counts[name]:
                raise RuntimeError(f"mesh training path: {name} launched "
                                   f"{counts[name]} times (fused_attn is "
                                   f"off)")
    after = fixed_loss(trainer.model)
    losses = trainer.loss_history
    errs = trainer.error_history
    if not all(np.isfinite(losses + errs["joint"] + errs["surface"])):
        raise RuntimeError(f"non-finite losses {losses} or errors {errs}")
    if not after < before:
        raise RuntimeError(f"the fixed batch's loss did not fall: {before} "
                           f"-> {after}")
    print(f"{tag} epoch losses {losses} (edge term on in epoch 2); fixed "
          f"batch loss, edge term on, {before:.6g} -> {after:.6g}; MPJPE "
          f"{errs['joint']} mm, MPVPE {errs['surface']} mm; state step "
          f"{state.step}", flush=True)

    # First step on the same weights, batch and masks: the kernel path;
    # the plain path (every kernel's plain version; the GRU recurrences
    # through the plain scan and PyTorch's autograd of it); and one path
    # that isolates this phase's kernels (phase 5: the plain GRU forward
    # with the backward kernel; phase 6: the decoder's attention blocks on
    # their kernels, everything else plain).
    def first_step(ctx):
        model = pmce().train()
        with ctx:
            loss, _ = pmce_loss(model, batch, faces, J_reg, weights, 1.0,
                                face_fn, torch.Generator(dev).manual_seed(7))
            loss.backward()
        return loss.item(), {n: p.grad for n, p in model.named_parameters()
                             if p.grad is not None}

    loss_k, grads_k = first_step(contextlib.nullcontext())
    # Two runs of the kernel path: the same gradients bit for bit.
    loss_k2, grads_k2 = first_step(contextlib.nullcontext())
    differ = {n.split("pose_mesh_coevo.")[-1]: max_err(g, grads_k2[n])
              for n, g in grads_k.items() if not torch.equal(g, grads_k2[n])}
    print(f"{tag} first step twice on the kernel path: losses {loss_k!r} and "
          f"{loss_k2!r}; {len(differ)} of {len(grads_k)} gradients differ"
          + (f", largest difference per parameter: {differ}" if differ
             else " (bit-identical)"), flush=True)
    if differ or loss_k != loss_k2:
        raise RuntimeError("first Stage-2 step: two runs differ")
    del grads_k2
    loss_p, grads_p = first_step(plain_path(fa, fused))
    if fused:
        iso = plain_gru(fa)
        iso.enter_context(mock.patch.object(fa, "transformer_block",
                                            fa.transformer_block_plain))
    else:
        iso = mock.patch.object(fa, "_gru_bwd", fa._gru_bwd_plain)
    loss_i, grads_i = first_step(iso)
    if not set(grads_k) == set(grads_p) == set(grads_i):
        raise RuntimeError("first Stage-2 step: the paths reach different "
                           "parameters")
    # The key biases add one vector to every key, which the softmax
    # ignores: their gradients are zero but for rounding on both paths, so
    # they are held to the model's largest gradient instead of their own.
    largest = max(max_err(g, 0 * g) for g in grads_p.values())

    def rel(got, ref, n):
        return max_err(got[n], ref[n]) / (
            largest if n.endswith(KEY_BIASES)
            else max(max_err(ref[n], 0 * ref[n]), 1e-30))

    def worst(got, ref, names):
        return max((rel(got, ref, n), n) for n in names)

    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    every = worst(grads_k, grads_p, grads_p)
    own = [n for n in grads_p if ".gru_cur." in n]
    if fused:
        # The attention blocks' own parameters, but for the last block's
        # joint stream: only the x1e-3 joint loss reaches those, through
        # the 431-key softmax of its cross-attention, and one bf16 ulp
        # upstream moves them by several per cent (phase 5: 4.1 % from the
        # GRU alone); they stay in the whole model's band.
        last = f"coevoblock{len(trainer.model.pose_mesh_coevo.blocks())}."
        own = [n for n in grads_p if "_FFN." in n
               and not (last in n and ".joint_" in n)]
        iso_ = worst(grads_i, grads_p, own)
        ranked = sorted(((rel(grads_i, grads_p, n), n)
                         for n in grads_p if "_FFN." in n), reverse=True)[:5]
        print(f"{tag} the six kernels alone, largest gradient differences "
              f"of the attention blocks: " + ", ".join(
                  f"{n.split('pose_mesh_coevo.')[-1]} {e:.4g}"
                  for e, n in ranked), flush=True)
        iso_what = ("the attention blocks' own but the last block's joint "
                    "stream, their six kernels alone")
        tol_iso = DECODER_GRAD_REL_TOL
    else:
        iso_ = worst(grads_k, grads_i, grads_i)
        iso_what = "the backward kernel alone (same forward)"
        tol_iso = STEP_GRAD_REL_TOL
    own_w = worst(grads_k, grads_p, own)
    loss_i_rel = abs(loss_i - loss_p) / abs(loss_p)
    owner = "the attention blocks'" if fused else "the GRU's"
    print(f"{tag} first step, kernel vs plain path: loss {loss_k:.6g} vs "
          f"{loss_p:.6g} (relative {loss_rel:.3g}, tol {STEP_LOSS_REL_TOL});"
          f" largest gradient difference {every[0]:.4g} of max|grad| in "
          f"{every[1]} (tol {MESH_GRAD_REL_TOL}), {own_w[0]:.4g} in "
          f"{owner} own "
          f"{own_w[1]}; {iso_what}: {iso_[0]:.4g} in {iso_[1]} (tol "
          f"{tol_iso}), loss relative {loss_i_rel:.3g}", flush=True)
    if (loss_rel > STEP_LOSS_REL_TOL or every[0] > MESH_GRAD_REL_TOL
            or iso_[0] > tol_iso
            or (not fused and own_w[0] > STEP_GRAD_REL_TOL)):
        raise RuntimeError("first Stage-2 step: kernel and plain paths "
                           "disagree")
    del grads_k, grads_p, grads_i

    gen = torch.Generator(dev).manual_seed(1)

    def step_ms(iters: int, warmup: int = 3) -> float:
        times = []
        for i in range(warmup + iters):
            torch.cuda.synchronize()
            t = time.perf_counter()
            trainer.train_step(state, batch, gen, 1.0)
            torch.cuda.synchronize()
            if i >= warmup:
                times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    torch.cuda.reset_peak_memory_stats()
    ms = step_ms(10)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with plain_path(fa, fused):
        plain = step_ms(5, warmup=2)
    beside = (f"; phase 5's step (fused_attn off) {unfused_ms:.3f} ms"
              if unfused_ms is not None else "")
    print(f"{tag} bf16 Stage-2 train step (fused_attn {fused}), batch {BM}: "
          f"{ms:.3f} ms (median of 10), {BM / ms * 1e3:.1f} clips/s; plain "
          f"path {plain:.3f} ms; peak device memory {peak:.2f} GiB{beside}; "
          f"on {card_line()}", flush=True)
    if profile:
        profile_step(lambda: trainer.train_step(state, batch, gen, 1.0))
    del trainer, state
    torch.cuda.empty_cache()
    return counts, ms


def data_parallel(device, stage1: dict, fused_ms: float) -> dict:
    """Phase 9: the fused Stage-2 step three ways from the same weights,
    seed and batches, in a one-process NCCL world that ``initialize`` sets
    up from torchrun's variables: (a) the plain ``Trainer``, (b) under DDP
    (``replicate``), (c) under FSDP (``shard_fsdp``). For (b) and (c): the
    launches of a first step and of an epoch with its evaluation exactly
    phase 6's; the first step's loss and every gradient after the
    reduction equal to (a)'s (bit for bit, or the largest difference
    printed within ``DP_GRAD_REL_TOL`` of the largest gradient); the fixed
    batch's loss falling. A checkpoint (c) writes loads into a plain
    ``Trainer``, whose next loss is (a)'s. Each way's step time and peak
    memory beside phase 6's step."""
    import os
    import shutil
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from pmce_tpu_torch.core.losses import build_face_losses
    from pmce_tpu_torch.core.trainer import Trainer, pmce_loss
    from pmce_tpu_torch.data.clip_dataset import ClipDataset, MultiDataset
    from pmce_tpu_torch.models.pmce import (
        create_pmce,
        load_lifter_checkpoint,
        resolve_compute_dtype,
    )
    from pmce_tpu_torch.ops import _cuda
    from pmce_tpu_torch.parallel import distributed as dist_lib
    from pmce_tpu_torch.parallel import mesh as mesh_lib
    from pmce_tpu_torch.parallel.prefetch import to_device
    from pmce_tpu_torch.smpl.mesh import ensure_cached_coarsening

    tag = "[dp]"
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    if not dist_lib.initialize(device="cuda"):
        raise RuntimeError("phase 9: initialize() joined no process group")
    mesh = mesh_lib.create_mesh(1, "cuda")
    print(f"{tag} {dist.get_backend()} world of {dist.get_world_size()}, "
          f"mesh {mesh}", flush=True)

    cfg = mesh_h36m_config(str(stage1["ckpt"]), True)
    art, jr = stage1["art"], stage1["jr"]
    coarse = ensure_cached_coarsening()
    train_ds, test_ds = (ClipDataset(sq, seqlen=T, stride=1,
                                     chunk_mode="mesh")
                         for sq in stage1["seqs"])
    dev = torch.device(device)
    J_reg = torch.as_tensor(jr, device=dev)
    faces = torch.as_tensor(art.faces, dtype=torch.long, device=dev)
    face_fn = build_face_losses(art.faces, art.num_verts, dev)
    weights = (cfg.MODEL.normal_loss_weight, cfg.MODEL.edge_loss_weight,
               cfg.MODEL.joint_loss_weight)
    evals = -(-len(test_ds) // cfg.TEST.batch_size)
    ckpt_dir = REPO / "pmce_tpu_torch" / "_build" / "chip_smoke_dp"
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def trainer_of(mode: str) -> Trainer:
        cfg.TRAIN.fsdp = mode == "fsdp"
        model, _ = create_pmce(
            num_joint=JT, art=art, coarsening=coarse,
            joint_regressor_h36m=jr, embed_dim=cfg.MODEL.hpe_dim,
            depth=cfg.MODEL.hpe_dep, seqlen=cfg.DATASET.seqlen,
            dtype=resolve_compute_dtype(cfg.MODEL.compute_dtype),
            fused=cfg.MODEL.fused_attn, device=device, seed=cfg.TRAIN.seed)
        load_lifter_checkpoint(model, cfg.MODEL.posenet_path)
        return Trainer(cfg=cfg, model=model,
                       train_data=MultiDataset([train_ds], seed=0),
                       test_data=test_ds, faces=art.faces, J_reg_target=jr,
                       ckpt_dir=str(ckpt_dir / mode), device=device,
                       log_fn=lambda s: print(f"{tag} {mode}: {s}",
                                              flush=True),
                       mesh=None if mode == "plain" else mesh)

    def full(t):
        if t is None:
            return None
        t = t.detach()
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def fixed_loss(trainer) -> float:
        model = trainer.model
        with torch.no_grad(), mesh_lib.gathered(model):
            return float(pmce_loss(model.eval(), batch, faces, J_reg,
                                   weights, 1.0, face_fn)[0])

    def step(trainer, state, epoch: int) -> float:
        loss, _ = trainer.train_step(state, batch,
                                     trainer.draw_generator(epoch), 1.0)
        return loss.item()

    def run(mode: str) -> dict:
        trainer = trainer_of(mode)
        state = trainer.init_state()
        before = fixed_loss(trainer)
        _cuda.reset_launch_counts()
        first = step(trainer, state, 0)
        torch.cuda.synchronize()
        counts = _cuda.launch_counts()
        grads = {n: full(p.grad) for n, p in
                 trainer.model.named_parameters()}
        grads = {n: None if g is None else g.clone()
                 for n, g in grads.items()}
        _cuda.reset_launch_counts()
        trainer.train_epoch(state, 1)
        trainer.evaluate()
        torch.cuda.synchronize()
        epoch = _cuda.launch_counts()
        after = fixed_loss(trainer)
        if mode == "fsdp":
            trainer.save(state, 1, False)
        nxt = step(trainer, state, 2)
        times = []
        torch.cuda.reset_peak_memory_stats()
        for i in range(13):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(trainer, state, 3)
            torch.cuda.synchronize()
            if i >= 3:
                times.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del trainer, state
        torch.cuda.empty_cache()
        return {"before": before, "first": first, "counts": counts,
                "grads": grads, "epoch": epoch, "after": after, "next": nxt,
                "ms": statistics.median(times), "peak": peak}

    batch = to_device(train_ds.get_batch(np.arange(BM)), dev,
                      bf16_features=True)
    ways = {}
    for mode in ("plain", "ddp", "fsdp"):
        ways[mode] = run(mode)
    ref = ways["plain"]
    largest = max(float(g.abs().max()) for g in ref["grads"].values()
                  if g is not None)
    for mode in ("ddp", "fsdp"):
        got, what = ways[mode], f"{tag} {mode}"
        check_fused_launches(got["counts"], stage2_launches(1, 0, True),
                             f"{what} first step")
        check_fused_launches(got["epoch"],
                             stage2_launches(TRAIN_STEPS, evals, True),
                             f"{what} epoch and evaluation")
        if {n for n, g in got["grads"].items() if g is None} != {
                n for n, g in ref["grads"].items() if g is None}:
            raise RuntimeError(f"{what}: other parameters got gradients")
        differ = {n: max_err(g, ref["grads"][n])
                  for n, g in got["grads"].items()
                  if g is not None and not torch.equal(g, ref["grads"][n])}
        worst = max(differ.values(), default=0.0)
        print(f"{what}: first loss {got['first']!r} vs plain "
              f"{ref['first']!r}; {len(differ)} of "
              f"{sum(g is not None for g in ref['grads'].values())} "
              f"gradients differ from the plain step's, largest difference "
              f"{worst:.3g} (bound {DP_GRAD_REL_TOL} x largest gradient "
              f"{largest:.4g}); launches a step as phase 6's, epoch of "
              f"{TRAIN_STEPS} steps + {evals} evaluation batches exact; "
              f"fixed batch loss {got['before']:.6g} -> {got['after']:.6g}",
              flush=True)
        if (abs(got["first"] - ref["first"])
                > DP_GRAD_REL_TOL * abs(ref["first"])
                or worst > DP_GRAD_REL_TOL * largest):
            raise RuntimeError(f"{what}: the first step differs from the "
                               f"plain trainer's")
        if not got["after"] < got["before"]:
            raise RuntimeError(f"{what}: the fixed batch's loss did not "
                               f"fall")

    # (c)'s checkpoint into a plain trainer: its next loss is (a)'s.
    resumed = trainer_of("plain")
    state, epoch = resumed.restore(str(ckpt_dir / "fsdp"))
    nxt = step(resumed, state, 2)
    del resumed, state
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"{tag} FSDP checkpoint (epoch {epoch}) in a plain trainer: next "
          f"loss {nxt!r}; plain {ways['plain']['next']!r}, FSDP "
          f"{ways['fsdp']['next']!r}", flush=True)
    for mode in ("plain", "fsdp"):
        if abs(nxt - ways[mode]["next"]) > DP_GRAD_REL_TOL * abs(nxt):
            raise RuntimeError(f"{tag} the resumed FSDP checkpoint's next "
                               f"loss is not {mode}'s")
    card = card_line()
    print(f"{tag} fused Stage-2 train step, batch {BM}: " + ", ".join(
        f"{mode} {w['ms']:.3f} ms (peak {w['peak']:.2f} GiB)"
        for mode, w in ways.items())
        + f"; phase 6's step {fused_ms:.3f} ms; on {card}", flush=True)
    dist.destroy_process_group()
    return {mode: (w["ms"], w["peak"]) for mode, w in ways.items()}


def stage2_launches(steps: int, evals: int, fused: bool) -> dict:
    """The launches of ``steps`` Stage-2 train steps and ``evals``
    evaluation batches (phases 5, 6 and 9). The backward scan: one launch
    a direction, four a step."""
    expect = {"gru_layer_save": 4 * steps, "gru_layer_bwd": 4 * steps,
              "gru_bwd_scan": 4 * steps, "gru_layer": 2 * evals,
              "gru_layer_rev": 2 * evals, "gru_scan": 2 * evals}
    if fused:
        # Per step: the lifter's 6 blocks forward and backward; per
        # CoevoBlock (3) forward, the joint stream's fused_mhsa, the vertex
        # stream's ada_block and two ca_block. Backward only where a
        # gradient is owed: every block re-reads the lifted joints, so the
        # joint streams of blocks 1 and 2 (their joint CA and fused_mhsa)
        # reach no output and autograd skips them, as JAX's VJP computes
        # nothing for them: 1 mhsa, 3 AdaLN and 4 CA backwards a step. Per
        # evaluation batch the trunk and the chain; skinning belongs to
        # phase 4's synthesis.
        expect.update({"block_fwd": 6 * steps, "block_bwd": 6 * steps,
                       "mhsa_fwd": 3 * steps, "mhsa_bwd": steps,
                       "ada_block_fwd": 3 * steps,
                       "ada_block_bwd": 3 * steps,
                       "ca_block_fwd": 6 * steps, "ca_block_bwd": 4 * steps,
                       **{name: 0 for name in DECODER_SEQ},
                       "lifter_trunk": evals, "lifter_trunk_long": 0,
                       "coevo_chain": evals, "skinning": 0})
    return expect


def check_fused_launches(counts: dict, expect: dict, what: str) -> None:
    """Raise unless every counter is as expected and every decoder kernel
    launched."""
    wrong = {k: (v, counts[k]) for k, v in expect.items() if counts[k] != v}
    if wrong or any(counts[k] == 0 for k in DECODER):
        raise RuntimeError(f"{what}: launches (expected, counted) {wrong}")


def plain_path(fa, fused: bool):
    """Every kernel of the Stage-2 path through its plain version (the
    comparisons only): both GRU directions through the plain scan, and with
    ``fused`` the lifter's blocks and the decoder's attention blocks."""
    from unittest import mock

    stack = plain_gru(fa)
    if fused:
        for name, plain in (("transformer_block", fa.transformer_block_plain),
                            ("fused_mhsa", fa.mhsa_plain),
                            ("ada_block", fa.ada_block_plain),
                            ("ca_block", fa.ca_block_plain)):
            stack.enter_context(mock.patch.object(fa, name, plain))
    return stack


def plain_gru(fa):
    """Both GRU directions through the plain scan, whose gradient is
    PyTorch's autograd of the loop, per direction and for a BiGRU layer
    (the comparisons only; the patches are in place from this call on,
    and the returned stack lifts them)."""
    import contextlib
    from unittest import mock

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(fa, "gru_layer",
                                          fa.gru_layer_plain))
    stack.enter_context(mock.patch.object(
        fa, "gru_layer_rev",
        lambda gi, w, b: fa.gru_layer_plain(gi, w, b, reverse=True)))
    stack.enter_context(mock.patch.object(fa, "gru_bidir",
                                          fa.gru_bidir_plain))
    return stack


def plain_everything(fa, fc):
    """Every kernel of the entry points' paths through its plain version
    (the comparisons only): ``plain_path``'s, the trunk, the chain, the
    whole block and the synthesis' skinning."""
    from unittest import mock

    from pmce_tpu_torch.smpl import kernels
    from pmce_tpu_torch.smpl.layer import apply_skinning

    stack = plain_path(fa, True)
    for mod, name, plain in ((fa, "lifter_trunk", fa.lifter_trunk_plain),
                             (fc, "coevo_chain", fc.coevo_chain_plain),
                             (fc, "coevo_block", fc.coevo_block_plain),
                             (kernels, "fused_skinning", apply_skinning)):
        stack.enter_context(mock.patch.object(mod, name, plain))
    return stack


class Tee:
    """Standard output that is also kept, to read what a CLI printed."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s: str) -> int:
        self.lines.append(s)
        return self.out.write(s)

    def flush(self) -> None:
        self.out.flush()

    def text(self) -> str:
        return "".join(self.lines)


def entry_points(device, serve_fps: float) -> dict:
    """Phase 7: the port's entry points as a user calls them. 7a
    ``bench_torch`` with ``bench.py``'s sizes; 7b the train CLI on
    ``CLI_CFG`` with ``--smoke``, counted; 7c the test CLI on 7b's
    ``best.ckpt``, on the kernels and on the plain versions. Returns the
    numbers the summary line prints."""
    import contextlib
    import math
    import shutil

    import torch

    import bench_torch
    from pmce_tpu_torch.main import test as test_cli
    from pmce_tpu_torch.main import train as train_cli
    from pmce_tpu_torch.ops import _cuda
    from pmce_tpu_torch.ops import fused_attention as fa
    from pmce_tpu_torch.ops import fused_coevo_chain as fc

    t_phase = time.time()
    card = card_line()
    res = bench_torch.serving_rate(device)
    rates = res["rates"]
    line = bench_torch.result_line(res, card)
    print(f"[bench] bench_torch: {len(rates)} runs of {res['iters']} "
          f"forwards at batch {res['batch']}: " + ", ".join(
              f"{r:.1f}" for r in rates) + f" mid-frames/s (median "
          f"{res['median']:.1f}, spread {min(rates):.1f}-{max(rates):.1f}; "
          f"phase 3's reading {serve_fps:.1f}); device time of one forward "
          f"{res['device_ms']:.3f} ms; on {card}", flush=True)
    print(json.dumps(line), flush=True)
    if not (math.isfinite(line["value"]) and line["value"] > 0):
        raise RuntimeError(f"bench_torch: rate {line['value']}")

    # 7b: the train CLI, counted from the synthesis to the protocol
    # evaluation.
    tag = "chip_smoke_cli"
    out_dir = Path("experiment") / tag
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.time()
    tee = Tee(sys.stdout)
    _cuda.reset_launch_counts()
    with contextlib.redirect_stdout(tee):
        trained = train_cli.main(["--cfg", str(CLI_CFG), "--smoke",
                                  "--tag", tag])
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    train_s = time.time() - t0
    print(f"[cli] train CLI --smoke: {train_s:.1f} s; launches {counts}",
          flush=True)
    steps = 2 * 4
    # Per step as phase 6 (batch 8 here); per evaluation batch the trunk,
    # the chain and one GRU scan a BiGRU layer (3 evaluations: two epochs
    # and the protocol's); the synthesis skins 2 videos a split.
    expect = {"block_fwd": 6 * steps, "block_bwd": 6 * steps,
              "mhsa_fwd": 3 * steps, "mhsa_bwd": steps,
              "ada_block_fwd": 3 * steps, "ada_block_bwd": 3 * steps,
              "ca_block_fwd": 6 * steps, "ca_block_bwd": 4 * steps,
              "gru_layer_save": 4 * steps, "gru_layer_bwd": 4 * steps,
              "gru_bwd_scan": 4 * steps, "skinning": 4,
              "lifter_trunk_long": 0, "coevo_block": 0,
              **{name: 0 for name in DECODER_SEQ}}
    evals = counts["lifter_trunk"]
    expect.update({"coevo_chain": evals, "gru_scan": 2 * evals,
                   "gru_layer": 2 * evals, "gru_layer_rev": 2 * evals})
    wrong = {k: (v, counts[k]) for k, v in expect.items() if counts[k] != v}
    if wrong or evals == 0 or evals % 3:
        raise RuntimeError(f"train CLI: launches (expected, counted) {wrong},"
                           f" {evals} evaluation batches")
    summary = "Human36M PA-MPJPE (mm)  >> tot:"
    metrics = ("mpjpe", "pa_mpjpe", "mpvpe", "accel")
    if summary not in tee.text() or not all(
            math.isfinite(getattr(trained, k)) for k in metrics):
        raise RuntimeError(f"train CLI: no finite protocol summary "
                           f"({trained})")

    # 7c: the test CLI on 7b's best checkpoint, on the kernels and on the
    # plain versions.
    ckpt = out_dir / "checkpoint" / "best.ckpt"
    argv = ["--cfg", str(CLI_CFG), "--weights", str(ckpt)]
    readings = {}
    for path in ("kernels", "plain"):
        ctx = (plain_everything(fa, fc) if path == "plain"
               else contextlib.nullcontext())
        t0 = time.time()
        _cuda.reset_launch_counts()
        with ctx:
            got = test_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = _cuda.launch_counts()
        launched = {k: v for k, v in counts.items() if v}
        want = (set() if path == "plain" else
                {"lifter_trunk", "gru_layer", "gru_layer_rev", "gru_scan",
                 "coevo_chain", "skinning"})
        if set(launched) != want:
            raise RuntimeError(f"test CLI on the {path} path launched "
                               f"{launched}")
        readings[path] = (got, wall)
        print(f"[cli] test CLI ({path}): {wall:.1f} s; " + ", ".join(
            f"{k} {getattr(got, k):.4f}" for k in metrics)
            + f"; launches {launched}", flush=True)
    (got, test_s), (want, _) = readings["kernels"], readings["plain"]
    for k in metrics:
        a, b = getattr(got, k), getattr(want, k)
        if not (math.isfinite(a) and abs(a - b) <= SERVE_REL_TOL * abs(b)):
            raise RuntimeError(f"test CLI {k}: kernels {a} vs plain {b} "
                               f"(tol {SERVE_REL_TOL} relative)")
    shutil.rmtree(out_dir, ignore_errors=True)
    phase_s = time.time() - t_phase
    print(f"[cli] test CLI metrics, kernels vs plain within "
          f"{SERVE_REL_TOL:.0%}; phase 7 took {phase_s:.1f} s on {card}",
          flush=True)
    return {"bench": res["median"], "train_s": train_s, "test_s": test_s,
            "phase_s": phase_s}


def demo_launches(counts: dict, expect: dict, tag: str) -> None:
    """Every counter equals ``expect`` (0 where it is not named)."""
    wrong = {k: (expect.get(k, 0), v) for k, v in counts.items()
             if v != expect.get(k, 0)}
    if wrong:
        raise RuntimeError(f"{tag}: launches (expected, counted) {wrong}")


def demo_iou(a, b) -> float:
    """IoU of two xywh boxes."""
    ix = max(0.0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = ix * iy
    return inter / (a[2] * a[3] + b[2] * b[3] - inter)


def backbones_card_vs_cpu(device) -> dict:
    """Phase 8c: ResNet-50 features and ViTPose-Huge heatmaps at full width
    in f32 (TF32 off), on the card and on the CPU, on weights drawn from a
    seed with BatchNorm statistics off 0 and 1; and the heatmaps decoded on
    both."""
    import torch

    from pmce_tpu_torch.models.spin import ResNet50
    from pmce_tpu_torch.models.vitpose import (
        ViTPose,
        ViTPoseConfig,
        decode_heatmaps,
    )
    from pmce_tpu_torch.smpl.layer import full_f32

    g = torch.Generator().manual_seed(8)
    errs = {}
    for name, model, x in (
            ("resnet50", ResNet50(), torch.randn(4, 3, 224, 224, generator=g)),
            ("vitpose_huge", ViTPose(ViTPoseConfig.huge()),
             torch.randn(2, 3, 256, 192, generator=g))):
        model.reset_parameters(g)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.normal_(0.0, 0.5, generator=g)
                    m.running_var.uniform_(0.5, 2.0, generator=g)
        model.eval()
        t0 = time.time()
        with torch.no_grad(), full_f32():
            want = model(x)
            got = model.to(device)(x.to(device)).cpu()
        err = max_err(got, want) / float(want.abs().max())
        print(f"[demo] {name} f32 card vs CPU: max_abs_err / max|x| = "
              f"{err:.3g} (tol {BACKBONE_REL_TOL}, TF32 off; {tuple(got.shape)};"
              f" {time.time() - t0:.1f} s)", flush=True)
        if not err <= BACKBONE_REL_TOL:
            raise RuntimeError(f"{name}: card and CPU disagree")
        errs[name] = err
        del model
    # The card's heatmaps decoded on the card and on the CPU, and equal
    # maxima: the first in row-major order on both.
    hm = got.clone()
    hm[:, 0] = 0.0
    hm[:, 1, 10:12, 20] = 5.0
    k_card, s_card = decode_heatmaps(hm.to(device))
    k_cpu, s_cpu = decode_heatmaps(hm)
    if not (torch.equal(k_card.cpu(), k_cpu)
            and torch.equal(s_card.cpu(), s_cpu)):
        raise RuntimeError("decode_heatmaps: card and CPU disagree")
    print(f"[demo] decode_heatmaps on the card = on the CPU for "
          f"{k_cpu.shape[0] * k_cpu.shape[1]} keypoints (ties included: "
          f"{k_cpu[0, 0].tolist()}, {k_cpu[0, 1].tolist()})", flush=True)
    torch.cuda.empty_cache()
    return errs


def demo(device) -> dict:
    """Phase 8: the port's video demo, ``python -m
    pmce_tpu_torch.main.run_demo`` with ``DEMO_ARGV``, in this process so
    that the launch counters can be read. (a) on the kernels, (b) under
    ``plain_everything``, (c) the backbones at full width on the card
    against the CPU. Returns the numbers the summary line prints."""
    import contextlib
    import math
    import shutil

    import numpy as np
    import torch

    from pmce_tpu_torch.demo import detector as det
    from pmce_tpu_torch.demo.pipeline import DemoConfig
    from pmce_tpu_torch.main import run_demo
    from pmce_tpu_torch.ops import _cuda
    from pmce_tpu_torch.ops import fused_attention as fa
    from pmce_tpu_torch.ops import fused_coevo_chain as fc
    from pmce_tpu_torch.smpl.artifacts import ensure_cached_artifacts

    t_phase = time.time()
    card = card_line()
    build = REPO / "pmce_tpu_torch" / "_build"
    det.CACHE_DIR = build / "chip_smoke_detector"
    shutil.rmtree(det.CACHE_DIR, ignore_errors=True)
    t0 = time.time()
    det.ensure_cached_detector(ensure_cached_artifacts(), device=device)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    print(f"[demo] detector trained at first use (512 renders, 600 Adam "
          f"steps of 32) in {train_s:.1f} s on {card}", flush=True)

    out_dir = build / "chip_smoke_demo"
    argv = DEMO_ARGV + ["--output", str(out_dir)]
    runs = {}
    for path in ("kernels", "plain"):
        ctx = (plain_everything(fa, fc) if path == "plain"
               else contextlib.nullcontext())
        t0 = time.time()
        _cuda.reset_launch_counts()
        with ctx:
            out = run_demo.main(argv)
        torch.cuda.synchronize()
        counts = _cuda.launch_counts()
        wall = time.time() - t0
        runs[path] = out
        results = out["results"]
        if len(results) != 1:
            raise RuntimeError(f"demo ({path}): {len(results)} tracks")
        (res,) = results.values()
        n = len(res["frames"])
        # Two passes (the warm-up and the measured one), each of
        # ceil(n / window_batch) window batches.
        wb = 2 * math.ceil(n / DemoConfig.window_batch)
        expect = ({} if path == "plain" else
                  {"lifter_trunk": wb, "coevo_chain": wb, "gru_scan": 2 * wb,
                   "gru_layer": 2 * wb, "gru_layer_rev": 2 * wb})
        demo_launches(counts, expect, f"demo ({path})")
        print(f"[demo] {path}: {wall:.1f} s; {out['fps']:.1f} frames/s end "
              f"to end; launches {({k: v for k, v in counts.items() if v})}"
              f" ({wb} window batches of {DemoConfig.window_batch}) on {card}",
              flush=True)
        if n < DemoConfig.min_track_frames:
            raise RuntimeError(f"demo ({path}): the track holds {n} frames")
        for k in ("mesh", "cam", "orig_cam"):
            if not np.isfinite(res[k]).all():
                raise RuntimeError(f"demo ({path}) {k}: non-finite values")
        gt = out["gt_boxes"]
        ious = [demo_iou(b, gt[f]) for b, f in zip(res["bboxes"],
                                                   res["frames"])]
        print(f"[demo] {path}: {n} of {len(gt)} frames tracked; IoU of the "
              f"tracked boxes with the rendered body's: min {min(ious):.3f},"
              f" median {statistics.median(ious):.3f}", flush=True)
        if min(ious) < DEMO_MIN_IOU:
            raise RuntimeError(f"demo ({path}): a tracked box misses the "
                               f"body (IoU {min(ious):.3f})")
    (a,), (b,) = (r["results"].values() for r in runs.values())
    if not np.array_equal(a["frames"], b["frames"]):
        raise RuntimeError("demo: the plain pass tracked other frames")
    bands = {}
    for k in ("mesh", "cam"):
        scale = float(np.abs(b[k]).max())
        err = float(np.abs(a[k] - b[k]).max())
        bands[k] = err / scale
        print(f"[demo] {k}, kernels vs plain: max_abs_err={err:.6g} (max |x| "
              f"{scale:.4g}, tol {DEMO_REL_TOL[k]} x max)", flush=True)
        if err > DEMO_REL_TOL[k] * scale:
            raise RuntimeError(f"demo {k}: kernels and plain disagree")
    stages = runs["kernels"]["stages"]
    print("[demo] stage split (kernels, measured pass): " + ", ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in sorted(
            stages["stage_seconds"].items(), key=lambda kv: -kv[1]))
        + f"; total {stages['total_seconds'] * 1e3:.2f} ms = "
        f"{stages['fps_measured']:.1f} frames/s on {card}", flush=True)
    errs = backbones_card_vs_cpu(device)
    shutil.rmtree(out_dir, ignore_errors=True)
    phase_s = time.time() - t_phase
    print(f"[demo] phase 8 took {phase_s:.1f} s on {card}", flush=True)
    return {"fps": runs["kernels"]["fps"],
            "stage_fps": stages["fps_measured"], "train_s": train_s,
            "phase_s": phase_s, "bands": bands, **errs}


@contextlib.contextmanager
def etl_timed(fused: bool, seconds: dict):
    """The ETL's SMPL synthesis (``data/etl/common.smpl_verts_joints``,
    where the ETL modules look it up) with ``fused`` (False: the plain
    skinning on the card), and the converters' ``save_packed``; each
    call's seconds appended under ``synthesis`` / ``save`` in
    ``seconds``."""
    from unittest import mock

    from pmce_tpu_torch.data.etl import coco, common, mpii, pw3d
    from pmce_tpu_torch.tools import etl_cli

    def timed(key, fn, **fixed):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **fixed, **kwargs)
            seconds.setdefault(key, []).append(time.perf_counter() - t0)
            return out
        return call

    synthesis = timed("synthesis", common.smpl_verts_joints, fused=fused)
    with contextlib.ExitStack() as stack:
        for mod in (common, coco, mpii, pw3d):
            stack.enter_context(mock.patch.object(mod, "smpl_verts_joints",
                                                  synthesis))
        stack.enter_context(mock.patch.object(
            etl_cli, "save_packed", timed("save", etl_cli.save_packed)))
        yield


def etl_trees(root: str, art, jr_h36m, jr_coco, device) -> dict:
    """Phase 10's mock source trees (``tests/torch_port_etl_fixtures.py``
    at the sizes above), their truth computed on ``device``: name → (the
    CLI's flags, the truth)."""
    import torch_port_etl_fixtures as fix

    def at(name):
        return os.path.join(root, name)

    return {
        "h36m": (["--data-dir", at("h36m"), "--split", "train"],
                 fix.build_h36m_mock(at("h36m"), art, jr_h36m,
                                     n_frames=ETL_H36M_FRAMES,
                                     subjects=ETL_H36M_SUBJECTS,
                                     device=device)),
        "pw3d": (["--data-dir", at("pw3d"), "--split", "test"],
                 fix.build_pw3d_mock(at("pw3d"), art, jr_h36m, jr_coco,
                                     n_frames=ETL_PW3D_FRAMES,
                                     device=device)),
        "mpii3d": (["--data-dir", at("mpii3d"), "--split", "train"],
                   fix.build_mpii3d_train_mock(
                       at("mpii3d"), art, jr_h36m, jr_coco,
                       n_frames=ETL_MPII3D_FRAMES, device=device)),
        "mpii3d_val": (["--data-dir", at("mpii3d_val"), "--split", "val"],
                       fix.build_mpii3d_val_mock(at("mpii3d_val"),
                                                 n=ETL_IMAGES)),
        "coco": (["--annot-dir", at("coco")],
                 fix.build_coco_mock(at("coco"), art, jr_h36m, jr_coco,
                                     n=ETL_IMAGES, device=device)),
        "mpii": (["--annot-dir", at("mpii")],
                 fix.build_mpii_mock(at("mpii"), art, jr_h36m, jr_coco,
                                     n=ETL_IMAGES)),
    }


def etl_chunks(name: str, data) -> int:
    """The skinning launches a conversion owes: one a chunk of
    ``ETL_BATCH`` bodies of each SMPL call (PW3D: one call a gender, the
    mock's seq_a male and seq_b female; MPII3D val: no SMPL)."""
    def chunks(n):
        return -(-int(n) // ETL_BATCH)

    if name == "h36m":
        return chunks(data.has_smpl.sum())
    if name == "pw3d":
        seqs = [str(p).split("/")[1] for p in data.img_names]
        return sum(chunks(seqs.count(s)) for s in set(seqs))
    if name == "mpii3d_val":
        return 0
    return chunks(len(data))


def etl_against_truth(name: str, data, truth, tree_root: str) -> float:
    """The kernel path's output against the mock's independently computed
    truth (world-frame SMPL, then the camera): the largest geometry
    difference in mm (H36M, PW3D, MPII3D), the features equal, H36M's CPN
    detections, COCO's planted good and bad fits; raises on a
    disagreement."""
    import numpy as np

    worst = 0.0

    def close(got, want, tol, what) -> float:
        err = float(np.abs(got - want).max())
        if not err <= tol:
            raise RuntimeError(f"phase 10 {name}: {what} {err:.4g} from "
                               f"the mock's truth (bound {tol})")
        return err

    if name == "h36m":
        frames = truth["frames"]
        if list(data.img_names) != [f["img_name"] for f in frames]:
            raise RuntimeError("phase 10 h36m: frames differ from the mock")
        for i, fr in enumerate(frames):
            root = fr["jcam_h36m"][:1]
            close(data.joint_cam_h36m[i], fr["jcam_h36m"] - root, 1e-2,
                  "joints (mm)")
            close(data.pose2d_det[i], fr["jimg"] + 1.5, 1e-3, "CPN (px)")
            if fr["has_smpl"] != bool(data.has_smpl[i]):
                raise RuntimeError("phase 10 h36m: has_smpl differs")
            if fr["has_smpl"]:
                worst = max(worst, close(data.mesh_cam[i],
                                         fr["mesh_cam"] - root,
                                         ETL_TRUTH_MM, "mesh (mm)"))
            if not np.array_equal(data.features[i],
                                  truth["feat"][fr["img_name"]]):
                raise RuntimeError("phase 10 h36m: features misaligned")
    elif name in ("pw3d", "mpii3d"):
        if name == "pw3d":
            by = {f["path"]: f for f in truth["frames"]}
            mesh_key = "mesh_mm"
        else:
            by = {(f"{tree_root}/MPI_INF_3DHP/S1/Seq1/imageFrames/video_"
                   f"{f['vid']}/{str(f['frame']).zfill(6)}.jpg"): f
                  for f in truth["frames"]}
            mesh_key = "mesh_cam"
        if sorted(by) != sorted(str(p) for p in data.img_names):
            raise RuntimeError(f"phase 10 {name}: frames differ")
        for i, p in enumerate(data.img_names):
            fr = by[str(p)]
            root = fr["jcam_h36m"][:1]
            worst = max(worst, close(data.mesh_cam[i], fr[mesh_key] - root,
                                     ETL_TRUTH_MM, "mesh (mm)"))
            if not np.array_equal(data.features[i], fr["feat"]):
                raise RuntimeError(f"phase 10 {name}: features misaligned")
    elif name in ("coco", "mpii"):
        frames = truth["frames"]
        if len(frames) != len(data):
            raise RuntimeError(f"phase 10 {name}: {len(data)} frames, the "
                               f"mock {len(frames)}")
        for i, fr in enumerate(frames):
            if not np.array_equal(data.features[i], fr["feat"]):
                raise RuntimeError(f"phase 10 {name}: features misaligned")
        if name == "coco":
            good = np.array([fr["good"] for fr in frames], np.float32)
            if not np.array_equal(data.mesh_valid, good):
                raise RuntimeError("phase 10 coco: the fitting gate missed "
                                   "the planted fits")
        if not np.abs(data.pose2d_det[:, :17]
                      - data.joint_img[:, :17]).max() > 0:
            raise RuntimeError(f"phase 10 {name}: no detector noise")
    elif len(data) != len(truth["names"]):
        raise RuntimeError("phase 10 mpii3d_val: frames differ")
    return worst


def etl_gate_margin(tree_root: str, data) -> tuple:
    """COCO's fit error of each frame (the kernel path's projected joints
    against the annotated keypoints): the mask of frames more than
    ``ETL_GATE_MARGIN_PX`` from the threshold."""
    import numpy as np

    from pmce_tpu_torch.data.etl.coco import FITTING_THR_PX
    from pmce_tpu_torch.data.etl.common import crop64_fit_error
    from pmce_tpu_torch.ops.coords import get_bbox

    with open(os.path.join(tree_root,
                           "person_keypoints_train2014.json")) as f:
        anns = [a for a in json.load(f)["annotations"] if not a["iscrowd"]]
    with open(os.path.join(tree_root, "coco_smplify_train.json")) as f:
        fitted = json.load(f)
    anns = [a for a in anns if str(a["id"]) in fitted]
    err = []
    for a, jimg in zip(anns, data.joint_img):
        kp = np.asarray(a["keypoints"], np.float32).reshape(-1, 3)
        err.append(crop64_fit_error(get_bbox(jimg), kp[:, :2], jimg[:17],
                                    (kp[:, 2] > 0).astype(np.float32)))
    return np.abs(np.asarray(err) - FITTING_THR_PX) > ETL_GATE_MARGIN_PX


def etl_compare(name: str, kern, plain, outside) -> tuple[float, float]:
    """The kernel path's packed fields against the plain path's: names,
    features, SMPL parameters, flags, sizes and camera ids equal; geometry
    within ``ETL_GEOM_MM``; 2D within ``ETL_PX``; masks equal (COCO's
    outside the gate's margin). Returns the largest geometry (mm) and 2D
    (px) differences."""
    import numpy as np

    if list(kern.img_names) != list(plain.img_names):
        raise RuntimeError(f"phase 10 {name}: names differ")
    geo = px = 0.0
    for field in ("joint_cam", "joint_cam_h36m", "mesh_cam", "joint_img",
                  "pose2d_det", "features", "smpl_pose", "smpl_shape",
                  "has_smpl", "img_hw", "cam_idx", "mesh_valid",
                  "lift_valid", "reg_valid"):
        a, b = getattr(kern, field), getattr(plain, field)
        if a is None or b is None:
            if (a is None) != (b is None):
                raise RuntimeError(f"phase 10 {name}: {field} missing")
            continue
        if a.shape != b.shape or a.dtype != b.dtype:
            raise RuntimeError(f"phase 10 {name}: {field} {a.shape} "
                               f"{a.dtype} vs {b.shape} {b.dtype}")
        if field in ("mesh_valid", "lift_valid", "reg_valid"):
            a, b = a[outside], b[outside]
        if field in ("joint_cam", "joint_cam_h36m", "mesh_cam"):
            geo = max(geo, float(np.abs(a - b).max()) if a.size else 0.0)
        elif field in ("joint_img", "pose2d_det"):
            px = max(px, float(np.abs(a - b).max()) if a.size else 0.0)
        elif not np.array_equal(a, b):
            raise RuntimeError(f"phase 10 {name}: {field} differs")
    if not (geo <= ETL_GEOM_MM and px <= ETL_PX):
        raise RuntimeError(f"phase 10 {name}: kernel vs plain geometry "
                           f"{geo:.4g} mm (bound {ETL_GEOM_MM}), 2D "
                           f"{px:.4g} px (bound {ETL_PX})")
    return geo, px


def etl_skinning(device, art, data) -> dict:
    """Row 15 at the ETL's chunk: the first ``ETL_BATCH`` fitted bodies of
    the H36M conversion, kernel against plain, timed, beside the bound of
    the same work (not counted as launches of the path)."""
    import torch

    from pmce_tpu_torch.smpl import kernels as sk
    from pmce_tpu_torch.smpl.layer import (
        SMPLModel,
        apply_skinning,
        skinning_transforms,
    )

    model = SMPLModel.from_artifacts(art, device=device)
    sel = data.has_smpl.nonzero()[0][:ETL_BATCH]
    pose = torch.from_numpy(data.smpl_pose[sel]).to(device)
    betas = torch.from_numpy(data.smpl_shape[sel]).to(device)
    with torch.no_grad():
        args = skinning_transforms(model, pose, betas)[:2] + (
            model.lbs_weights,)
        got, want = sk.fused_skinning(*args), apply_skinning(*args)
        err = max_err(got, want)
        ms = median_ms(lambda: sk.fused_skinning(*args), iters=20)
        plain_ms = median_ms(lambda: apply_skinning(*args), iters=10)
    flops = count_flops(lambda: apply_skinning(*args))
    bound_ms, by = bound(flops, tensor_bytes(args, got), "f32")
    if not err <= SKIN_TOL_M:
        raise RuntimeError(f"phase 10: skinning at B={len(sel)} "
                           f"disagrees with its plain version ({err} m)")
    print(f"[etl] skinning B={len(sel)} V={art.num_verts}: kernel "
          f"{ms:.4f} ms at {bound_ms / ms:.1%} of its bound {bound_ms:.4f}"
          f" ms (by {by}, {flops / 1e9:.3f} GFLOP), plain {plain_ms:.4f} "
          f"ms, max_abs_err {err:.3g} m (tol {SKIN_TOL_M} m); the phase-2 "
          f"row keeps B={B}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "max_abs_err": err}


def data_pipeline(device) -> dict:
    """Phase 10: the five converter CLIs on the card, on mock trees at
    full width, each twice (the skinning kernel, then the plain skinning);
    the counters exact, the outputs against each other, the mock's truth
    and the factory; ``--record-perf`` once. Returns the launches and the
    numbers the summary prints."""
    import tempfile

    import numpy as np

    import torch_port_etl_fixtures as fix
    from pmce_tpu_torch.core.config import Config
    from pmce_tpu_torch.data import factory
    from pmce_tpu_torch.data.packed import load_packed
    from pmce_tpu_torch.ops import _cuda
    from pmce_tpu_torch.smpl.artifacts import ensure_cached_artifacts
    from pmce_tpu_torch.tools import (
        convert_coco,
        convert_h36m,
        convert_mpii,
        convert_mpii3d,
        convert_pw3d,
    )
    from pmce_tpu_torch.utils import perf

    card = card_line()
    t_phase = time.time()
    art = ensure_cached_artifacts()
    V = art.num_verts
    clis = {"h36m": (convert_h36m, "Human36M", "train"),
            "pw3d": (convert_pw3d, "PW3D", "test"),
            "mpii3d": (convert_mpii3d, "MPII3D", "train"),
            "mpii3d_val": (convert_mpii3d, "MPII3D", "val"),
            "coco": (convert_coco, "COCO", "train"),
            "mpii": (convert_mpii, "MPII", "train")}
    out = {"skinning": 0, "rates": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_etl_") as tmp:
        art.save(os.path.join(tmp, "smpl.npz"))
        jr_h36m, jr_coco = fix.small_regressors(V,
                                                np.random.default_rng(42))
        for i, jr in enumerate((jr_h36m, jr_coco)):
            np.save(os.path.join(tmp, f"jr{i}.npy"), jr)
        t0 = time.time()
        trees = etl_trees(os.path.join(tmp, "src"), art, jr_h36m, jr_coco,
                          device)
        print(f"[etl] mock trees at V={V}, [17, {V}] regressors, 2048-d "
              f"features written in {time.time() - t0:.1f} s", flush=True)
        smpl = os.path.join(tmp, "smpl.npz")
        body = ["--smpl-npz", smpl, "--jr-h36m", os.path.join(tmp, "jr0.npy"),
                "--jr-coco", os.path.join(tmp, "jr1.npy"),
                "--device", device.type]
        perf_path = os.path.join(tmp, "perf.json")
        cfg = Config()
        for name, (flags, truth) in trees.items():
            cli, dataset, split = clis[name]
            extra = (["--smpl-male", smpl, "--smpl-female", smpl]
                     if name == "pw3d" else [])
            if name == "h36m":
                extra = ["--record-perf", "--perf-path", perf_path]
            packed = f"{dataset}_{split}_packed.npz"
            timing = {}
            for way, fused in (("kernel", True), ("plain", False)):
                os.makedirs(os.path.join(tmp, way), exist_ok=True)
                argv = flags + body + (extra if fused else []) + [
                    "--out", os.path.join(tmp, way, packed)]
                seconds = {}
                with etl_timed(fused, seconds):
                    _cuda.reset_launch_counts()
                    t0 = time.perf_counter()
                    cli.main(argv)
                    wall = time.perf_counter() - t0
                    counts = _cuda.launch_counts()
                timing[way] = (wall, sum(seconds.get("synthesis", [])),
                               sum(seconds["save"]), dict(counts))
            kern, _ = load_packed(os.path.join(tmp, "kernel", packed))
            plain, _ = load_packed(os.path.join(tmp, "plain", packed))
            chunks = etl_chunks(name, kern)
            launched = {k: v for k, v in timing["kernel"][3].items() if v}
            if launched != ({"skinning": chunks} if chunks else {}):
                raise RuntimeError(f"phase 10 {name}: launches {launched}, "
                                   f"owed skinning {chunks}")
            if any(timing["plain"][3].values()):
                raise RuntimeError(f"phase 10 {name}: the plain run "
                                   f"launched {timing['plain'][3]}")
            out["skinning"] += chunks
            outside = (etl_gate_margin(os.path.join(tmp, "src", "coco"),
                                       kern)
                       if name == "coco" else np.ones(len(kern), bool))
            geo, px = etl_compare(name, kern, plain, outside)
            truth_mm = etl_against_truth(
                name, kern, truth, os.path.join(tmp, "src", name))
            windows = []
            for way in ("kernel", "plain"):
                cfg.data_dir = os.path.join(tmp, way)
                cfg.DATASET.seqlen = 16
                ds = factory.build_dataset(dataset, cfg, art, split,
                                           device=device)
                windows.append(len(ds))
            if not windows[0] == windows[1] > 0:
                raise RuntimeError(f"phase 10 {name}: windows {windows}")
            n = len(kern)
            (kw, ks, ksave, _), (pw, ps, psave, _) = (timing["kernel"],
                                                       timing["plain"])
            out["rates"][name] = (n / kw, n / pw)
            if name == "h36m":
                h36m = kern
            print(f"[etl] {name} {split}: {n} frames, {chunks} skinning "
                  f"launches (= chunks of {ETL_BATCH}), {windows[0]} "
                  f"windows both ways; kernels {kw:.2f} s = {n / kw:.1f} "
                  f"frames/s (synthesis {ks:.3f} s, npz {ksave:.2f} s), "
                  f"plain skinning {pw:.2f} s = {n / pw:.1f} frames/s "
                  f"(synthesis {ps:.3f} s, npz {psave:.2f} s); kernel vs "
                  f"plain {geo:.3g} mm, {px:.3g} px"
                  + (f", {int((~outside).sum())} frames within "
                     f"{ETL_GATE_MARGIN_PX} px of the gate"
                     if name == "coco" else "")
                  + f"; vs the mock's truth {truth_mm:.3g} mm on {card}",
                  flush=True)
        entry = perf.load(perf_path)["etl"]["h36m_train"]
        if entry["device"] != card or entry["frames"] != len(h36m):
            raise RuntimeError(f"phase 10: --record-perf wrote {entry}")
        row = perf.render_table({"etl": {"h36m_train": entry}})
        print(f"[etl] --record-perf wrote: {row.splitlines()[-1]}",
              flush=True)
        out["skin"] = etl_skinning(device, art, h36m)
    out["phase_s"] = time.time() - t_phase
    print(f"[etl] phase 10 took {out['phase_s']:.1f} s, {out['skinning']} "
          f"skinning launches on {card}", flush=True)
    return out


def f32_kernel_rows(device, rows) -> None:
    """Phase 11a: each f32 kernel against its plain version at the f32
    serving forward's shapes (TF32 off), a rerun bit for bit, timed beside
    its bound at the f32 CUDA-core peak; row 6's beside
    ``nn.TransformerEncoder`` in f32 on its no-grad path."""
    import numpy as np
    import torch

    from pmce_tpu_torch.ops import fused_attention as fa
    from pmce_tpu_torch.ops import fused_coevo_chain as fc

    card = card_line()

    def check(name, kernel, plain, args, label):
        with torch.no_grad():
            out_k, out_p = kernel(*args), plain(*args)
            again = kernel(*args)
            torch.cuda.synchronize()
            outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
            outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
            outs_2 = again if isinstance(again, tuple) else (again,)
            for a in outs_k:
                if a.dtype != torch.float32 or not bool(
                        torch.isfinite(a).all()):
                    raise RuntimeError(f"{name} {label}: {a.dtype}, or "
                                       "non-finite output")
            if not all(torch.equal(a, b) for a, b in zip(outs_k, outs_2)):
                raise RuntimeError(f"{name} {label}: two runs differ")
            err = max(max_err(a, b) for a, b in zip(outs_k, outs_p))
            rel = max(max_err(a, b) / float(b.abs().max())
                      for a, b in zip(outs_k, outs_p))
            ms = median_ms(lambda: kernel(*args))
            plain_ms = median_ms(lambda: plain(*args), iters=5)
            flops = count_flops(lambda: plain(*args))
        ok = rel <= F32_KERNEL_REL_TOL
        print(f"[f32] {name} {label}: max_abs_err={err:.4g} max relative to "
              f"max|plain| {rel:.3g} (tol {F32_KERNEL_REL_TOL}); a rerun "
              f"bit for bit; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(TF32 off) on {card}{'' if ok else '  FAIL'}", flush=True)
        if not ok:
            raise RuntimeError(f"{name} {label}: kernel disagrees with its "
                               f"plain version ({rel})")
        record(rows, name, err, ms, plain_ms, flops,
               tensor_bytes(args, outs_k), "f32")
        return outs_p[0]

    rng = np.random.default_rng(12)
    for label, clips, N in (("spatial", B * T, J), ("temporal", B * J, T)):
        x, params, _, _ = block_case(rng, device, clips, N, 0.0)
        x = x.detach().float()
        params = tuple(t.detach() for t in params)
        y = check("block_fwd_f32", fa.transformer_block,
                  fa.transformer_block_plain, (x, params, 8),
                  f"{label} [{clips}, {N}, {C}] with the post-norm")
        enc = library_encoder(x, params).eval()
        with torch.no_grad():
            lib_ms = median_ms(lambda: enc(x))
            lib_err = max_err(enc(x), y)
        if rows["block_fwd_f32"]["library_ms"] is None:
            rows["block_fwd_f32"]["library_ms"] = lib_ms
        print(f"[f32] library: nn.TransformerEncoder (pre-norm, erf GELU, "
              f"post-norm) {label} [{clips}, {N}, {C}], f32, TF32 off, "
              f"no-grad: {lib_ms:.4f} ms; max|library - plain| "
              f"{lib_err:.4g}", flush=True)
        del x, params, y, enc
    r = Inputs(13, device)
    joints, vertx, g, b, blocks, hj, hv = chain_case(r, B)
    blocks = tuple((blk[0].float(), blk[1], blk[2].float(), *blk[3:])
                   for blk in blocks)
    check("coevo_chain_f32", fc.coevo_chain, fc.coevo_chain_plain,
          (joints, vertx, g, b, blocks, hj, hv), f"B={B} J={J} V=431 C=64")
    jf0, vf0, g, b, kp, hj, hv = coevo_block_case(r, B)
    check("coevo_block_f32", fc.coevo_block, fc.coevo_block_plain,
          (jf0.float(), vf0.float(), g, b, kp, hj, hv),
          f"B={B} J={J} V=431 C=64")
    torch.cuda.empty_cache()


def f32_serving(device, rows) -> dict:
    """Phase 11: the f32 serving forward (TF32 off throughout). Returns the
    launch counts of a chain forward and a whole-block forward, both
    routes' mid-frames/s and the test CLI's wall seconds."""
    import contextlib
    import math
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    from pmce_tpu_torch.main import test as test_cli
    from pmce_tpu_torch.models.pmce import create_pmce
    from pmce_tpu_torch.ops import _cuda
    from pmce_tpu_torch.ops import fused_attention as fa
    from pmce_tpu_torch.ops import fused_coevo_chain as fc
    from pmce_tpu_torch.smpl.artifacts import ensure_cached_artifacts
    from pmce_tpu_torch.smpl.layer import full_f32
    from pmce_tpu_torch.smpl.mesh import ensure_cached_coarsening
    from torch_port_init import perturbed_init

    t_phase = time.time()
    card = card_line()
    out = {}
    with full_f32():
        f32_kernel_rows(device, rows)
        art = ensure_cached_artifacts()
        coarse = ensure_cached_coarsening()
        models = {}
        for whole in (False, True):
            m, _ = create_pmce(num_joint=J, art=art, coarsening=coarse,
                               dtype=None, fused=True,
                               whole_block_kernel=whole, device=device,
                               seed=0)
            models[whole] = m
        # Phase 3's perturbed weights and inputs, in f32.
        perturbed_init(models[False], torch.Generator().manual_seed(0))
        models[True].load_state_dict(models[False].state_dict())
        rng = np.random.default_rng(0)
        pose2d = torch.from_numpy(
            rng.standard_normal((B, T, J, 2), dtype=np.float32)).to(device)
        img_feat = torch.from_numpy(
            rng.standard_normal((B, T, 2048), dtype=np.float32)).to(device)
        names = ("mesh", "evo_pose", "pose3d")
        expect = {"mesh": (B, art.num_verts, 3), "evo_pose": (B, J, 3),
                  "pose3d": (B, J, 3)}

        def plain_route():
            stack = contextlib.ExitStack()
            for mod, name, plain in (
                    (fa, "transformer_block", fa.transformer_block_plain),
                    (fc, "coevo_chain", fc.coevo_chain_plain),
                    (fc, "coevo_block", fc.coevo_block_plain)):
                stack.enter_context(mock.patch.object(mod, name, plain))
            return stack

        def counted(m, route, want):
            ctx = plain_route() if route == "plain" else \
                contextlib.nullcontext()
            with ctx, torch.no_grad():
                _cuda.reset_launch_counts()
                outs = dict(zip(names, m(pose2d, img_feat)))
                torch.cuda.synchronize()
                counts = _cuda.launch_counts()
            launched = {k: v for k, v in counts.items() if v}
            if launched != want:
                raise RuntimeError(f"f32 serving ({route}): launches "
                                   f"{launched}, expected {want}")
            for name, t in outs.items():
                if tuple(t.shape) != expect[name] or \
                        t.dtype != torch.float32 or \
                        not bool(torch.isfinite(t).all()):
                    raise RuntimeError(f"f32 {name}: {tuple(t.shape)} "
                                       f"{t.dtype} or non-finite")
            return outs, counts

        def agree(tag, outs, ref, what):
            for name, t in outs.items():
                scale = float(ref[name].abs().max())
                rel = max_err(t, ref[name]) / scale
                print(f"{tag} {name} vs {what}: max abs difference / max "
                      f"|{what}| = {rel:.3g} (max |x| {scale:.4g}, tol "
                      f"{F32_SERVE_REL_TOL})", flush=True)
                if not rel <= F32_SERVE_REL_TOL:
                    raise RuntimeError(f"{tag} {name}: disagrees with {what}")

        chain_outs = None
        for whole, tag, want in ((False, "[f32]", F32_CHAIN),
                                 (True, "[f32-wb]", F32_WHOLE)):
            m = models[whole]
            outs, counts = counted(m, "kernels", want)
            print(f"{tag} launches on the f32 serving forward: "
                  f"{ {k: v for k, v in counts.items() if v} } (exact)",
                  flush=True)
            plain, _ = counted(m, "plain", {})
            agree(tag, outs, plain, "the plain route")
            if whole:
                agree(tag, outs, chain_outs, "the chain route")
            else:
                chain_outs = outs
            ms, fps = serve_rate(m, pose2d, img_feat)
            with plain_route():
                pms, pfps = serve_rate(m, pose2d, img_feat)
            what = "whole-block" if whole else "chain"
            print(f"{tag} f32 fused forward ({what}), B={B}: kernels "
                  f"{ms:.3f} ms per batch = {fps:.1f} mid-frames/s; plain "
                  f"route {pms:.3f} ms = {pfps:.1f} mid-frames/s "
                  f"({fps / pfps:.3f}x); TF32 off; on {card}", flush=True)
            out["wb" if whole else "chain"] = (counts, fps, pfps)
        del models, m, chain_outs, outs, plain
        torch.cuda.empty_cache()

        # 11c: the test CLI on CLI_CFG in f32.
        text = CLI_CFG.read_text()
        if "compute_dtype: 'bfloat16'" not in text or \
                "fused_attn: true" not in text:
            raise RuntimeError(f"{CLI_CFG}: not the bf16 fused config")
        readings = {}
        with tempfile.TemporaryDirectory() as tmp:
            cfg = Path(tmp) / "test_mesh_h36m_f32.yml"
            cfg.write_text(text.replace("compute_dtype: 'bfloat16'",
                                        "compute_dtype: 'float32'"))
            for route in ("kernels", "plain"):
                ctx = (plain_everything(fa, fc) if route == "plain"
                       else contextlib.nullcontext())
                t0 = time.time()
                _cuda.reset_launch_counts()
                with ctx:
                    got = test_cli.main(["--cfg", str(cfg)])
                torch.cuda.synchronize()
                wall = time.time() - t0
                launched = {k: v for k, v in _cuda.launch_counts().items()
                            if v}
                if route == "plain":
                    ok = not launched
                else:
                    batches = launched.get("coevo_chain_f32", 0)
                    ok = (set(launched) == {"block_fwd_f32",
                                            "coevo_chain_f32", "skinning"}
                          and batches > 0
                          and launched["block_fwd_f32"] == 6 * batches)
                if not ok:
                    raise RuntimeError(f"f32 test CLI ({route}) launched "
                                       f"{launched}")
                readings[route] = got
                print(f"[f32-cli] test CLI, compute_dtype float32, "
                      f"fused_attn true, seeded initial weights ({route}): "
                      f"{wall:.1f} s; " + ", ".join(
                          f"{k} {getattr(got, k):.6f}" for k in
                          ("mpjpe", "pa_mpjpe", "mpvpe", "accel"))
                      + f"; launches {launched}", flush=True)
                out[f"cli_{route}_s"] = wall
        for k in ("mpjpe", "pa_mpjpe", "mpvpe", "accel"):
            a, b = getattr(readings["kernels"], k), \
                getattr(readings["plain"], k)
            if not (math.isfinite(a) and
                    abs(a - b) <= F32_SERVE_REL_TOL * abs(b)):
                raise RuntimeError(f"f32 test CLI {k}: kernels {a} vs plain "
                                   f"{b} (tol {F32_SERVE_REL_TOL} relative)")
    out["phase_s"] = time.time() - t_phase
    print(f"[f32] test CLI metrics, kernels vs plain within "
          f"{F32_SERVE_REL_TOL}; phase 11 took {out['phase_s']:.1f} s on "
          f"{card}", flush=True)
    return out


def profile_step(step, what: str = "train step", n: int = 5) -> None:
    """Device time of ``n`` calls of ``step`` (a ``what``) by kernel
    (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    by_name: dict = {}
    for e in prof.events():
        # Kernels only: user annotations (``Optimizer.step#...``) also sit
        # on the device's track.
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            k = by_name.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us() / 1e3 / n
            k[1] += 1
    busy = sum(v[0] for v in by_name.values())
    print(f"[profile] {what}: {busy:.3f} ms of kernel time per call in "
          f"{wall:.3f} ms of wall time (busy {busy / wall:.1%})", flush=True)
    for name, (t, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :25]:
        print(f"[profile] {t:8.3f} ms {cnt // n:5d}x  {name[:110]}",
              flush=True)


def print_split(tag: str, split: dict) -> None:
    """Shares of a stamped launch's cycles by stage and by kind."""
    total = sum(split.values())
    for axis, label in ((0, "stage"), (1, "kind")):
        agg: dict = {}
        for key, v in split.items():
            agg[key[axis]] = agg.get(key[axis], 0) + v
        print(f"[split] {tag} by {label}: " + ", ".join(
            f"{k} {v / total:.1%}" for k, v in sorted(
                agg.items(), key=lambda kv: -kv[1])), flush=True)
    print(f"[split] {tag} by stage and kind: " + ", ".join(
        f"{s}/{k} {v / total:.1%}" for (s, k), v in sorted(
            split.items(), key=lambda kv: -kv[1])), flush=True)


def stage_split(device) -> None:
    """--profile: where one launch's time goes inside the trunk (K1), the
    GRU scan (K2, layer 0's two directions), the decoder chain (K3) and
    whole block (row 14), at the serving shapes, and inside the GRU's
    backward scan (row 13) and the block backward's tile program (row 7)
    at the training shapes: each kernel's
    clock64()-stamped instantiation or launch (one call, not counted on
    any path) gives every tile's, CTA's or clip's cycles per stage; the
    shares are of their sum over the tiles, CTAs or clips. The same for
    the block forward's saving tile program (row 6) at the Stage-1 shapes
    and the CA block's forward and backward tile programs (rows 10, 11) at
    the Stage-2 step's two orientations, the AdaLN block's forward (row 8,
    launches A and B) and backward (row 9) at its vertex stream, and the
    self-attention forward's and backward's (rows 4 and 5) at the joint
    stream and the trunk backward's shape (the plan's clips a CTA, and
    7)."""
    import torch

    from pmce_tpu_torch.ops import fused_attention as fa
    from pmce_tpu_torch.ops import fused_coevo_chain as fc

    r = Inputs(1, device)
    trunk = trunk_case(r, B)
    split = fa.trunk_stage_split(*trunk)
    total = sum(split.values())
    print("[split] lifter_trunk (K1) by stage: " + ", ".join(
        f"{k} {v / total:.1%}" for k, v in split.items()), flush=True)
    gru = gru_case(r, T, B), gru_case(r, T, B)
    split = fa.gru_stage_split(gru[0][0], gru[1][0], *gru[0][1:],
                               *gru[1][1:])
    total = sum(split[k] for k in fa.GRU_STAGES)
    print(f"[split] gru_scan (K2) T={T}+{T} B={B}, {split['ctas']} CTAs, "
          f"{total / split['ctas'] / split['steps']:.0f} cycles a step a "
          "CTA, by stage: " + ", ".join(
              f"{k} {split[k] / total:.1%}" for k in fa.GRU_STAGES),
          flush=True)
    # Row 13 at the Stage-2 step's shape: one direction, T = 16, B = 32.
    gi, whh, bhh = gru_case(r, T, BM)
    with torch.no_grad():
        _, saved, wb = fa._gru_save(gi, whh, bhh, False)
    g = r(T, BM, GRU_H, scale=0.1, dtype=torch.bfloat16)
    split = fa.gru_bwd_stage_split(g, saved, wb)
    total = sum(split[k] for k in fa.GRU_BWD_STAGES)
    print(f"[split] gru_layer_bwd (row 13) T={T} B={BM}, {split['ctas']} "
          f"CTAs, {total / split['ctas'] / split['steps']:.0f} cycles a "
          "step a CTA, by stage: " + ", ".join(
              f"{k} {split[k] / total:.1%}" for k in fa.GRU_BWD_STAGES),
          flush=True)
    del gi, whh, bhh, saved, wb, g
    # Row 7's tile program at the Stage-1 step's two shapes.
    import numpy as np

    rng = np.random.default_rng(3)
    for label, clips, N, rate in (("spatial", BT * T, JT, 0.0),
                                  ("temporal", BT * JT, T, 0.2)):
        x, params, masks, _ = block_case(rng, device, clips, N, rate)
        split = fa.block_bwd_stage_split(x, params, 8, masks)
        total = sum(split[k] for k in fa.BLOCK_BWD_STAGES)
        print(f"[split] block_bwd (row 7) tile program, {label} [{clips}, "
              f"{N}, {C}], {split['tiles']} tiles, by stage: " + ", ".join(
                  f"{k} {split[k] / total:.1%}" for k in fa.BLOCK_BWD_STAGES),
              flush=True)
        split = fa.block_fwd_stage_split(x, params, 8, masks)
        total = sum(split[k] for k in fa.TRUNK_STAGES)
        print(f"[split] block_fwd (row 6) tile program, saving, {label} "
              f"[{clips}, {N}, {C}], {split['tiles']} tiles, "
              f"{total / split['tiles']:.0f} cycles a tile, by stage: "
              + ", ".join(f"{k} {split[k] / total:.1%}"
                          for k in fa.TRUNK_STAGES), flush=True)
        del x, params, masks
    # Rows 10 and 11's tile programs at the Stage-2 step's two
    # orientations, row 9's at its vertex stream.
    def cta_split(tag, split, stages):
        total = sum(split[k] for k in stages)
        print(f"[split] {tag}, {split['ctas']} CTAs, "
              f"{total / split['ctas']:.0f} cycles a CTA, by stage: "
              + ", ".join(f"{k} {split[k] / total:.1%}" for k in stages),
              flush=True)

    for label, Nq, c, heads, Nk in (("joints over vertices", JT, 64, 8, 431),
                                    ("vertices over joints", 431, 64, 2, JT)):
        leaves, call, _ = decoder_case(rng, device, "ca", BM, Nq, c, heads,
                                       Nk)
        xs, rest = leaves[:3], leaves[3:]
        with torch.no_grad():
            cta_split(f"ca_block_fwd (row 10) tile program, {label} [{BM}, "
                      f"{Nq}, {c}] over {Nk} keys",
                      fa.ca_fwd_stage_split(xs, rest[0:8:2], rest[1:8:2],
                                            rest[8:], heads, 1e-6,
                                            call.masks), fa.CA_FWD_STAGES)
            _, saved = fa._ca_fwd_cuda(xs, rest[0:8:2], rest[1:8:2],
                                       call.masks, rest[8:], heads, 1e-6)
            g = torch.ones_like(xs[0])
            cta_split(f"ca_block_bwd (row 11) tile program, {label} [{BM}, "
                      f"{Nq}, {c}] over {Nk} keys",
                      fa.ca_bwd_stage_split(g, xs, rest[8:], saved, heads),
                      fa.CA_BWD_STAGES)
        del leaves, saved, xs, rest
    leaves, call, _ = decoder_case(rng, device, "ada", BM, 431, 64, 2)
    x, rest = leaves[0], leaves[1:]
    with torch.no_grad():
        cta_split(f"ada_block_fwd (row 8) tile programs A and B [{BM}, 431, "
                  "64], 2 heads", fa.ada_fwd_stage_split(
                      x, rest[:4], rest[4:], 2, 1e-6, call.masks),
                  fa.ADA_FWD_STAGES)
        _, saved = fa._ada_fwd_cuda(x, rest[:4], call.masks, rest[4:], 2,
                                    1e-6)
        cta_split(f"ada_block_bwd (row 9) tile program [{BM}, 431, 64], 2 "
                  "heads", fa.ada_bwd_stage_split(torch.ones_like(x), x,
                                                  rest[4:], saved, 2),
                  fa.ADA_BWD_STAGES)
    del leaves, saved, x, rest
    # Row 4's tile program at the decoder's joint stream and the trunk
    # backward's spatial shape (the plan's clips a CTA, and 7).
    for label, clips, N, c, cpc in (("joint", BM, JT, 64, None),
                                    ("trunk", BM * T, JT, C, None),
                                    ("trunk", BM * T, JT, C, 7)):
        leaves, _, _ = decoder_case(rng, device, "mhsa", clips, N, c, 8)
        x, wqkv, bqkv, wproj, bproj = (t.detach() for t in leaves)
        with torch.no_grad():
            split = fa.mhsa_fwd_stage_split(x, wqkv, bqkv, wproj, bproj, 8,
                                            clips_per_cta=cpc)
            _, saved = fa._mhsa_fwd_cuda(x, wqkv, bqkv, wproj, bproj, 8,
                                         clips_per_cta=cpc)
            bsplit = fa.mhsa_bwd_stage_split(torch.ones_like(x), x, wqkv,
                                             wproj, saved, 8,
                                             clips_per_cta=cpc)
        cta_split(f"mhsa_fwd (row 4) tile program, {label} [{clips}, {N}, "
                  f"{c}], 8 heads, {split['clips_per_cta']} clips a CTA",
                  split, fa.MHSA_FWD_STAGES)
        cta_split(f"mhsa_bwd (row 5) tile program, {label} [{clips}, {N}, "
                  f"{c}], 8 heads, {bsplit['clips_per_cta']} clips a CTA",
                  bsplit, fa.MHSA_BWD_STAGES)
        del leaves, saved, x
    chain = chain_case(r, B)
    print_split("coevo_chain (K3)", fc.coevo_stage_split("chain", *chain[:5]))
    block = coevo_block_case(r, B)
    print_split("coevo_block (row 14)",
                fc.coevo_stage_split("block", *block[:5]))
    del trunk, gru, chain, block
    torch.cuda.empty_cache()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "pmce_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no pmce_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(1, str(REPO / "tests"))
    from pmce_tpu_torch.ops import _cuda

    device = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[card] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}", flush=True)
    t0 = time.time()
    _cuda.build_all()
    print(f"[build] {len(_cuda.LIBRARIES)} kernel libraries built and loaded"
          f" in {time.time() - t0:.1f} s", flush=True)
    for lib in _cuda.LIBRARIES:
        log = lib.path.with_suffix(".log")
        if log.is_file():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {lib.source}: {line.strip()}", flush=True)

    profile = "--profile" in sys.argv[1:]
    if profile:
        stage_split(device)
    rows = check_kernels(device)
    fps, serve_counts, wb_fps, wb_counts = serve(device, profile)
    train_counts, step_ms, stage1 = train(device, profile)
    mesh_counts, mesh_ms = mesh_train(device, stage1, profile, False)
    fused_counts, fused_ms = mesh_train(device, stage1, profile, True,
                                        mesh_ms)
    cli = entry_points(device, fps)
    dm = demo(device)
    dp = data_parallel(device, stage1, fused_ms)
    etl = data_pipeline(device)
    f32 = f32_serving(device, rows)
    # Each kernel's launches on the path it belongs to; skinning's: phase
    # 4's synthesis and phase 10's conversions; the f32 forms': phase 11's
    # forwards.
    counts = {**{k: mesh_counts[k] for k in REPLACES},
              **{k: fused_counts[k] for k in DECODER},
              **{k: train_counts[k] for k in TRAINING},
              **{k: serve_counts[k] for k in SERVING},
              "coevo_block": wb_counts["coevo_block"],
              **{k: f32["chain"][0][k] for k in F32_CHAIN},
              "coevo_block_f32": f32["wb"][0]["coevo_block_f32"]}
    counts["skinning"] += etl["skinning"]

    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": counts[name],
                **{k: rows[name][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}
               for name in REPLACES]
    print(f"[card] {card}; serving {fps:.1f} mid-frames/s (whole-block "
          f"{wb_fps:.1f}); Stage-1 train "
          f"step {step_ms:.3f} ms = {BT / step_ms * 1e3:.1f} clips/s; "
          f"Stage-2 train step {mesh_ms:.3f} ms = "
          f"{BM / mesh_ms * 1e3:.1f} clips/s (fused_attn off), "
          f"{fused_ms:.3f} ms = {BM / fused_ms * 1e3:.1f} clips/s "
          f"(fused_attn on); bench_torch {cli['bench']:.1f} mid-frames/s; "
          f"train CLI --smoke {cli['train_s']:.1f} s, test CLI "
          f"{cli['test_s']:.1f} s, phase 7 {cli['phase_s']:.1f} s; demo "
          f"{dm['fps']:.1f} frames/s end to end (stage table "
          f"{dm['stage_fps']:.1f}), detector training {dm['train_s']:.1f} s,"
          f" phase 8 {dm['phase_s']:.1f} s; phase 9 fused Stage-2 step "
          f"plain {dp['plain'][0]:.3f} ms, DDP {dp['ddp'][0]:.3f} ms, FSDP "
          f"{dp['fsdp'][0]:.3f} ms; phase 10 ETL frames/s kernels / "
          f"plain skinning " + ", ".join(
              f"{k} {a:.1f} / {b:.1f}" for k, (a, b) in etl["rates"].items())
          + f", skinning at B={ETL_BATCH} {etl['skin']['ms']:.4f} ms "
          f"(bound {etl['skin']['bound_ms']:.4f}); phase 11 f32 serving "
          f"{f32['chain'][1]:.1f} mid-frames/s (plain route "
          f"{f32['chain'][2]:.1f}), whole-block {f32['wb'][1]:.1f} (plain "
          f"{f32['wb'][2]:.1f}), phase 11 {f32['phase_s']:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
