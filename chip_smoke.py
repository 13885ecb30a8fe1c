#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (a failed phase is reported and the run ends with a non-zero exit):
  1. print the card's name and power limit; build every kernel (one nvcc per
     source, all at once; `-Xptxas -v` register/shared-memory lines printed);
  2. hold each kernel against its plain PyTorch version on the card at every
     shape the serving forward gives it (bf16, tolerances below), and time the
     kernel, the plain version and, where one PyTorch call computes the same
     function, that call (K2's, K3's, K4's, K11's and K12's sites and
     F.layer_norm by the profiler's device time, the kernels' CUDA-event
     time beside it;
     each site line with the bound's share of the kernel's time); print
     K6's block (window pairs in flight, shared memory, blocks an SM, grid)
     for its serving call and for K10's forward;
  3. run the serving forward (`default_config()`, 640x480, batch 4, bf16,
     seeded random weights) with the launch counters set to 0 just before and
     read just after, check its outputs are finite and every kernel launched
     the expected number of times, and print pairs/s and where the time goes
     (backbone, coarse transformer, coarse matching and fine stage, each
     through the path the forward takes, and the rest);
  4. semantic check: identical images with thr=1e-8 give matches on the
     coarse-grid diagonal; and the forward on the card agrees with the plain
     path on the CPU at 64x64 (feat_c0, and mkpts0_f over the matches both
     find); then the serving forward at tpu_optimized_config() (head dim 64
     in the Swin blocks, the coarse transformer and the fine stage) as in 3
     (the same launches a forward, no eager coarse or fine EncoderLayer,
     pairs/s, the breakdown), and its card-against-CPU check at 64x64;
  5. hold the training kernels against their plain versions at the shapes of
     the training step: swin_block_train's forward and backward (K8) at the
     three widths of the backbone, with and without the shift mask and
     drop-path scales (out, dx and all 13 parameter gradients against the
     plain twin's autograd), and the sparse focal loss: the pass-1
     log-sum-exps (dual_softmax_lse, K1's pass 1), the backward's softmax
     terms (K7, its plan printed, bit-identical over two calls) and the
     whole loss and its gradients against the materialised loss, at [4,
     4800, 256] with 1024 GT pairs and at a ragged size; time each kernel
     and its plain version;
     The differentiable coarse transformer (K9) at the step's shapes: one
     self call (G = 8) and one cross call (G = 4) of [G, 4800, 256], 8
     heads: the forward's output and kv/ks, and dx, dsrc and the 10
     parameter gradients of the backward against the plain twin on the same
     inputs; time the forward and backward and the plain twin's;
     The differentiable fine transformer (K10) at the step's shapes: one
     self call (G = 8192) and one cross call (G = 4096) of [G, 49, 64], 8
     heads: each layer's forward output (K6's kernel, one layer), and dx,
     dsrc (the cross call's; the self call adds it into dx) and the 10
     parameter gradients of the backward against the plain twin on the same
     inputs, by K10_TOL, and twice bit for bit; print the window stage's
     block and its time beside its own bound; once, at the cross call, a
     planted fault (the window stage's last window left out) must break the
     check; time the forward and backward and the plain twin's;
     The weight-gradient products those three backwards share (wgrad, 142
     a step in 28 launches, one a backward call) at each distinct launch of
     the step: each product against the plain twin by WGRAD_TOL and
     bit-identical twice, the plan printed, timed by the profiler (events
     beside) against the twin and `torch.mm(a.t(), b)` a product;
     The window attention (K11) at every block of the backbone (the window
     count, C, heads and, on odd blocks, the shift mask of 640x480, batch
     4), by K11_ATOL / K11_RTOL and bit for bit over two calls, its grid
     (head groups x runs of windows) printed, timed (the profiler's device
     time, CUDA events beside) against its twin and against
     `F.scaled_dot_product_attention` with the bias (plus mask) as a float
     mask (the library yardstick); then at tpu_optimized_config()'s three
     widths (head dim 64) and at head dim 32 at one site;
     The image-layout Swin block (K12) at every block of the backbone with
     the real maps (120x160, 60x80, 30x40, padded as the pad formulation
     pads), against its plain twin and against K2 through the roll path on
     the same inputs (K12_K2_RTOL), timed against K2 with its pad, roll,
     partition, reverse, roll back and crop; then the 13 blocks in order
     through swin_block_image N_FORWARD times, one K12 launch a block;
     The head-dim-64 instances tpu_optimized_config() runs, by the same
     checks, each also bit-identical over two calls: K2 at the serving
     forward's three widths with 1, 2 and 4 heads, with and without the
     shift mask; K5 at (256, 64), a self call of G = 8 and a cross call of G
     = 4 over 4800 tokens, where the cross call's kv, with one cross-warp
     block of K^T V zeroed in each head group's first head (a planted
     fault: a block the stats kernel left out), must break the stats bound,
     and the run says it did; K6 in fold and plain
     mode over 4096 pairs with one head of 64; K12 at the 13 blocks of that
     config's backbone and through swin_block_image N_FORWARD times; and
     the backwards its training step runs, as above: K8 at the three widths
     with 1, 2 and 4 heads (its backward twice bit for bit, and at C = 256
     with the mask mlp_bwd's planted fault as above), K9 at (256, 64)
     (twice bit for bit), K10 with one head of 64 (its own planted fault,
     the window stage's last window left out) (their own lines of the
     kernels JSON, named with "@hd64"; the faults planted in attn_bwd,
     apply_bwd and stats_bwd at head dim 64 are in copies of their sources,
     tools/train_bwd_faults.py);
  6. run the training step (`default_config()` as users run it: every
     kernel switch 'auto', so K8, K9 and K10 on the card; 640x480, batch 4,
     bf16, sparse focal loss, AdamW) with the launch counters set to 0 just
     before the timed steps and read just after: K8 forward and backward 13
     times a step, K9 forward and backward 12 times (4 self and 8 cross
     calls), K10's forward twice (one launch a layer) and backward 3 times
     (a self call and a cross layer's two calls), wgrad 28 times (inside
     those backwards, one launch a call for its 4 or 6 products), K1's pass
     1 and K7 once,
     no eager coarse or fine EncoderLayer, no K1 match statistics and no
     serving kernel (K9's and K10's forwards call K5's and K6's kernels,
     not the serving wrappers, so K5's and K6's counters read 0); print the
     step time, training pairs/s, the
     device time of the forward, backward and optimizer, the device's busy
     share and the largest kernels, and check the loss, the gradient norm
     and every parameter are finite;
  7. training semantic check: one step on the card against the plain path on
     the CPU at 128x128, batch 2, with `coarse.fused_train` and
     `fine.fused_train` 'on' on both sides (K9 and K10 on the card, their
     plain twins on the CPU; `training_agreement`, bounded by LIMITS: the
     loss, every gradient leaf's cosine and the coarse features' gradient,
     card against CPU; each of the step's K8, K9 and K10 calls run again
     from its inputs and upstream gradient, and the step's K7 call, against
     their plain versions on the card), ten steps on
     one batch at lr 1e-4 lower the loss, and the evaluation step takes its
     matches from K1's statistics (one launch) with finite outputs; then
     the training step at tpu_optimized_config() (head dim 64 throughout)
     as in 6, with the same launches a step, and its `training_agreement`
     under the same LIMITS;
  8. the evaluation step with `swin.fused_block='off'` (the per-op block,
     fused_attention 'auto'; default_config(), 640x480, batch 4, bf16) with
     the launch counters set to 0 just before and read just after: K11 13
     times, K8 and K2 none, K9's and K10's forwards, K1's statistics and
     its pass 1 (EXPECTED_PER_EVAL); finite outputs, pairs/s, the device's
     busy share and the backbone's device ms;
  9. its semantic checks: identical images with thr=1e-8 match on the
     diagonal; the card's forward agrees with the CPU's at 128x128
     (feat_c0, and mkpts0_f over the matches both find); and the forward at
     tpu_optimized_config() with the per-op block runs K11 at head dim 64,
     13 launches, and K9's and K10's forwards (K5's and K6's kernels at
     head dim 64, 12 and 2 launches) with no eager coarse or fine layer,
     with finite outputs;
 10. two training steps with the per-op block (autograd through the plain
     ops; no K11 in training, as in flax): no K8 launch, finite loss,
     gradient norm and parameters;
 11. the training step under dense supervision (`loss.sparse_spvs` off:
     the focal loss on the conf matrix, which the Matcher forms at the JAX
     rounding points and takes its matches from) as in 6, with the sparse
     step's launches but K1's pass 1 and K7 (EXPECTED_PER_DENSE_STEP: no
     K1 at all), its device time and busy share printed beside the sparse
     step's; its `training_agreement` at 128x128 under LIMITS (no K7
     readings); one step at coarse_type='cross_entropy' with a finite loss
     and gradients and no K1 or K7 launch;
 12. the evaluation Matcher with the conf matrix wanted: K8's, K9's and
     K10's forwards and no K1 (EXPECTED_PER_DENSE_EVAL); identical images
     at thr=1e-8 match on the diagonal; `extract_matches` of the matrix
     equals, bit for bit, `extract_matches_from_stats` of its plain max and
     argmax on the card; the dense evaluation step launches no K1 or K7;
 13. the coarse-only Matcher (`coarse_only`): no K6 or K10 launch, K1 once
     (none with the conf matrix), the "fine" keypoints the coarse centres;
 14. the float32 forms of K1 and K5 (phase 2, after the head-dim-64 checks):
     K1 at the teacher's [4, 4800, 256] (K1_F32_RTOL, a planted tie, bit
     for bit twice) and K5's stats, merge and apply through K9's forward at
     (256, 32) over 4800 tokens, a self call of G = 8 and a cross call of G
     = 4 (K5_F32_ATOL / K5_F32_RTOL on out, kv and ks, bit for bit twice),
     timed by the profiler against their float32 bounds (K1's: one L x S
     product); then the LoFTR-tiny
     teacher's forward (`loftr_tiny_config()`: coarse-only ResNet-FPN, the
     sine encoding, float32, seeded weights and BatchNorm statistics, 640x480
     grayscale, batch 4): EXPECTED_PER_TEACHER (K9's forward 12, K1 once,
     every other wrapper 0, no eager coarse layer), its device time, busy
     share, stages, launches and peak memory, the card against the CPU on
     one pair (`teacher_agreement`), the same with the backbone's
     convolutions in TF32 (a planted fault it must catch) and identical
     images on the diagonal; and `make_teacher_fn(device="cuda")` on a
     480x640 uint8 pair;
 15. pose evaluation (after the teacher): RANSAC
     (`geometry/ransac.essential_ransac_core`) on the card over the two-plane
     synthetic scene's GT correspondences in POSE_SLOTS slots (POSE_OUTLIERS
     of the valid rows outliers, the rest padding), batch 4, POSE_HYP
     hypotheses, 0.5 px: each pair within 1 degree of the true rotation and
     0.99 of the translation's direction, the card within POSE_CARD_CPU_DEG
     (rotation) and POSE_CARD_CPU_T_DEG (translation) of the port on the
     CPU on the same Gumbel noise, no host sync on the way (PyTorch's
     sync debug mode raising), its device time and launches; then
     `apps/evaluate.evaluate_dataset` on EVAL_PAIRS two-plane 640x480 pairs
     through `FastMatcher` (seeded random weights: the AUCs are not
     checked): EXPECTED_PER_FORWARD a batch by the counters, the forward's
     profiled launches equal to those of the serving forward built as in 3
     and profiled beside it (late in the run the same forward can profile
     a few launches short of phase 3's count; the kernels that moved are
     printed), the four metric keys;
     and one batch by its parts: every tensor of the chain on the card, no
     host sync in the chain, the host ms a batch, the device ms and launches
     of the forward and of the metric chain, the chain's largest kernels
     and the peak memory. Nothing of it is added to the kernels JSON line.

The six kernels of the forward: swin_block_fused (K2), layer_norm_chain (K3),
patch_expand_ln (K4), coarse_transformer_fused (K5, one call runs all eight
layers' stats and apply launches), dual_softmax_match_stats (K1) and
fine_stage_fused (K6, fold mode). The eight of the training step:
swin_block_train_fwd and swin_block_train_bwd (K8), coarse_layer_forward
and coarse_layer_backward (K9, one launch an encoder call),
fine_layer_forward (K10's forward: K6's kernel, one launch a layer) and
fine_layer_backward (K10, one launch an encoder call), dual_softmax_lse
(K1's pass 1, K7's forward) and sparse_focal_backward (K7); and wgrad, the
weight-gradient products of K8's, K9's and K10's backwards, one launch a
backward call, which those backwards' wrappers count (its own wrapper,
`ops/wgrad.wgrad_group`, serves the phase-5 check). The per-op
block's evaluation forward adds window_attention (K11); swin_block_fused_image
(K12) runs on its own entry point, swin_block_image.

Per-kernel numbers in the JSON line are totals over one forward (serving
kernels), one training step (training kernels), one evaluation step with the
per-op block (K11) or the backbone's 13 blocks (K12), the "@hd64" lines over
the forward (K12: the 13 blocks) or the training step at
tpu_optimized_config(), the "@f32" lines over the teacher's forward (their
launches over its N_TEACHER forwards): each call site's time times its launches, summed. `bound_ms` is the larger
of the bytes the call must move (inputs read once, outputs written once) at
3.35 TB/s and its matrix-product operations at the bf16 tensor-core peak of
989 TFLOP/s, or for the "@f32" lines at the float32 peak outside the tensor
cores of 67 TFLOP/s (the published H100 SXM figures), counted from this run's
inputs by `featurematching_tpu_torch/utils/kernel_bounds.py`. Stdout ends
with the card line, the kernels JSON line, and {"ok": true, "device": {...}}.
Without a GPU it exits non-zero and prints no result. It takes no arguments:
every run drives every phase.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
import traceback
from unittest import mock

import torch

from featurematching_tpu_torch.utils.kernel_bounds import (
    BF16_TENSOR_FLOPS,
    FP32_FLOPS,
    bound_ms,
    coarse_apply_work,
    coarse_layer_f32_work,
    coarse_stats_work,
    coarse_train_apply_bwd_work,
    coarse_train_bwd_work,
    coarse_train_fwd_work,
    coarse_train_stats_bwd_work,
    dual_softmax_f32_work,
    dual_softmax_lse_work,
    dual_softmax_work,
    fine_stage_work,
    fine_train_bwd_work,
    fine_train_fwd_work,
    fine_train_window_bwd_work,
    layer_norm_work,
    patch_expand_work,
    sparse_focal_backward_work,
    swin_block_train_attn_bwd_work,
    swin_block_train_bwd_work,
    swin_block_train_fwd_work,
    swin_block_train_mlp_bwd_work,
    swin_block_work,
    swin_sites,
    total,
    wgrad_group_work,
    wgrad_groups,
    window_attention_work,
)

B, H, W = 4, 480, 640
N_FORWARD = 10
N_STEPS = 5
# K6 heatmaps against the plain version: the two sides' windows differ by
# bf16 roundings taken in another order (within 5e-2 + 2e-2 |x|); over the
# 64 channels of a logit m . w / 8 that moves a logit by up to about 0.2,
# and a probability p by p (1 - p) 0.2 <= 0.05
HEAT_ATOL = 5e-2
EXPECTED_PER_FORWARD = {
    "swin_block_fused": 13, "layer_norm_chain": 4, "patch_expand_ln": 3,
    "dual_softmax_match_stats": 1, "coarse_transformer_fused": 1, "fine_stage_fused": 1,
}
SOURCES = {
    "swin_block_fused": ("swin_block.cu", "featurematching_tpu/ops/pallas_swin_block.py:301"),
    "layer_norm_chain": ("layer_norm.cu", "featurematching_tpu/ops/pallas_ln.py:74"),
    "patch_expand_ln": ("patch_expand.cu", "featurematching_tpu/ops/pallas_patch_expand.py:164"),
    "dual_softmax_match_stats": (
        "dual_softmax.cu", "featurematching_tpu/ops/pallas_dual_softmax.py:216"),
    "coarse_transformer_fused": (
        "coarse_transformer.cu", "featurematching_tpu/ops/pallas_coarse_transformer.py:168,194"),
    "fine_stage_fused": ("fine_stage.cu", "featurematching_tpu/ops/pallas_fine_stage.py:378"),
    "swin_block_train_fwd": (
        "swin_block_train.cu", "featurematching_tpu/ops/pallas_swin_block_grad.py:567"),
    "swin_block_train_bwd": (
        "swin_block_train.cu", "featurematching_tpu/ops/pallas_swin_block_grad.py:629"),
    "dual_softmax_lse": (
        "dual_softmax.cu", "featurematching_tpu/ops/sparse_focal_loss.py:140 (pallas_dual_softmax.py:216)"),
    "sparse_focal_backward": (
        "sparse_focal_loss.cu", "featurematching_tpu/ops/sparse_focal_loss.py:269"),
    "coarse_layer_forward": (
        "coarse_transformer.cu",
        "featurematching_tpu/ops/pallas_coarse_grad.py:333 (pallas_coarse_transformer.py:168,194)"),
    "coarse_layer_backward": (
        "coarse_transformer_train.cu", "featurematching_tpu/ops/pallas_coarse_grad.py:245,286"),
    "fine_layer_forward": (
        "fine_stage.cu",
        "featurematching_tpu/ops/pallas_fine_grad.py:384 (pallas_fine_stage.py:378)"),
    "fine_layer_backward": (
        "fine_transformer_train.cu", "featurematching_tpu/ops/pallas_fine_grad.py:444"),
    "window_attention": (
        "window_attention.cu", "featurematching_tpu/ops/pallas_window_attention.py:141,154"),
    "swin_block_fused_image": (
        "swin_block_image.cu",
        "featurematching_tpu/ops/pallas_swin_block.py:478 (swin_block_image :514)"),
    "wgrad": (
        "wgrad.cuh",
        "featurematching_tpu/ops/pallas_swin_block_grad.py:326,343,363,449; "
        "pallas_coarse_grad.py:71 (_dot_g at :158-223); pallas_fine_grad.py:142-216"),
}
# the head-dim-64 instances of K2, K5, K6 (tpu_optimized_config()'s serving
# forward), K12 (its own entry point over that config's 13 blocks) and K8,
# K9 and K10 (its training step): their own lines in the kernels JSON, by
# the kernel each instantiates
HD64 = {
    "swin_block_fused@hd64": "swin_block_fused",
    "coarse_transformer_fused@hd64": "coarse_transformer_fused",
    "fine_stage_fused@hd64": "fine_stage_fused",
    "swin_block_fused_image@hd64": "swin_block_fused_image",
    "swin_block_train_fwd@hd64": "swin_block_train_fwd",
    "swin_block_train_bwd@hd64": "swin_block_train_bwd",
    "coarse_layer_forward@hd64": "coarse_layer_forward",
    "coarse_layer_backward@hd64": "coarse_layer_backward",
    "fine_layer_forward@hd64": "fine_layer_forward",
    "fine_layer_backward@hd64": "fine_layer_backward",
}
# the float32 forms of K1 and K5 (the LoFTR-tiny teacher's dtype): their own
# lines in the kernels JSON, each by the wrapper whose counter it shares,
# its source and the TPU kernel it replaces; their bounds at the float32
# peak outside the tensor cores (FP32_FLOPS)
F32 = {
    "dual_softmax_match_stats@f32": (
        "dual_softmax_match_stats", "dual_softmax_f32.cu",
        "featurematching_tpu/ops/pallas_dual_softmax.py:216,259"),
    "coarse_layer_forward@f32": (
        "coarse_layer_forward", "coarse_transformer_f32.cu",
        "featurematching_tpu/ops/pallas_coarse_grad.py:333 (pallas_coarse_transformer.py:168,194)"),
}
N_TEACHER = 5  # teacher forwards timed
# K1 at float32 against its plain twin (both float32, FFMA against cuBLAS
# without TF32): sims differ by f32 sums in another order, about 1e-6 of
# their size; conf = exp(2 sim - lse_r - lse_c) moves by a few times that
K1_F32_RTOL = 1e-4
# K5 at float32 against its plain twin, per entry of out, kv and ks: atol +
# rtol |plain| (f32 sums over 256 to 4800 terms in another order, through
# two LayerNorms)
K5_F32_ATOL, K5_F32_RTOL = 2e-4, 2e-4
# the teacher's forward on the card against the same module on the CPU
# (float32 both): feat_c0 and feat_c1 within TEACHER_FEAT_RTOL of their
# largest magnitude (cuDNN and the f32 kernels against the CPU's
# convolutions and plain twins: sums in another order through 12 encoder
# calls, read at 1.4e-6 on an H100; TF32 convolutions, which round
# operands to 10 mantissa bits, must break it: a planted fault); a match
# one side finds and the other does not must be a near-tie on the CPU's
# conf matrix (within TEACHER_TIE of its row's and column's maxima, of the
# threshold and of the top-K cutoff); the matches both find have mconf
# within TEACHER_MCONF_RTOL
TEACHER_FEAT_RTOL = 1e-5
TEACHER_TIE = 1e-3
TEACHER_MCONF_RTOL = 1e-3
# launches a training step (K2-K6 and the K1 match statistics: none; K9
# once an encoder call: 4 self calls and 2 x 4 cross calls; K10's forward
# once a layer, its backward once an encoder call: a self call and 2 cross;
# the weight gradients inside those backwards, one launch a call for its 4
# (K8) or 6 (K9, K10) products: 13 + 12 + 3 launches, 142 products)
EXPECTED_PER_STEP = dict.fromkeys(EXPECTED_PER_FORWARD, 0) | {
    "swin_block_train_fwd": 13, "swin_block_train_bwd": 13, "dual_softmax_lse": 1,
    "sparse_focal_backward": 1, "coarse_layer_forward": 12, "coarse_layer_backward": 12,
    "fine_layer_forward": 2, "fine_layer_backward": 3, "window_attention": 0,
    "swin_block_fused_image": 0, "wgrad": 28,
}
# the dense supervision: the focal loss on the conf matrix (loss.sparse_spvs
# off), as users train without the sparse loss
DENSE = {"sparse_spvs": False}
# launches of a training step under dense supervision: the sparse step's but
# K1's pass 1 and K7 (the loss reads the conf matrix) and, as there, no K1
# statistics (the matches come from the matrix)
EXPECTED_PER_DENSE_STEP = EXPECTED_PER_STEP | {"dual_softmax_lse": 0, "sparse_focal_backward": 0}
# launches of the teacher's forward (loftr_tiny_config(), coarse-only,
# float32): K9's forward once an encoder call (K5's float32 kernels: 4 self
# calls and 2 x 4 cross calls) and K1's float32 statistics once; no other
EXPECTED_PER_TEACHER = dict.fromkeys(SOURCES, 0) | {
    "coarse_layer_forward": 12, "dual_softmax_match_stats": 1,
}
# launches of the evaluation Matcher's forward at default_config() with the
# conf matrix wanted: K8's forward, K9's and K10's forwards, no K1
EXPECTED_PER_DENSE_EVAL = dict.fromkeys(SOURCES, 0) | {
    "swin_block_train_fwd": 13, "coarse_layer_forward": 12, "fine_layer_forward": 2,
}
# launches of an evaluation step with swin.fused_block='off' (the per-op
# block, fused_attention 'auto'): K11 once a block; the coarse and fine stacks
# through K9's and K10's forwards (one launch an encoder call, one a fine
# layer); K1's statistics for the matches and its pass 1 for the sparse loss;
# no other kernel
EXPECTED_PER_EVAL = dict.fromkeys(SOURCES, 0) | {
    "window_attention": 13, "coarse_layer_forward": 12, "fine_layer_forward": 2,
    "dual_softmax_match_stats": 1, "dual_softmax_lse": 1,
}
# the pose-evaluation phase: RANSAC on the card over POSE_SLOTS
# match slots (the serving forward's top-K), POSE_OUTLIERS of the valid
# rows outliers, POSE_HYP hypotheses a pair; evaluate_dataset over
# EVAL_PAIRS pairs. The card's poses against the CPU's on the same noise:
# both run the same solver in float32, the card's QR, LU and matrix
# products (cuBLAS) rounding otherwise than the CPU's (LAPACK), so a
# candidate moves by float32 roundings and the polished pose by far less
# than the scene's own accuracy (R_err < 1 degree); the translation's
# direction, worse conditioned by the short baseline, within ten times that
POSE_SLOTS, POSE_HYP, POSE_OUTLIERS, EVAL_PAIRS = 1024, 512, 0.2, 8
POSE_CARD_CPU_DEG, POSE_CARD_CPU_T_DEG = 0.05, 0.5
# K8 against the plain twin's autograd, max |kernel - plain| <= K8_TOL max |plain|
# per tensor: both take the same bf16 activations and bf16-valued weights and
# accumulate in f32; they round activations and activation gradients to bf16
# at other points (about ten roundings of 2^-9 along the chain) and sum over
# up to 153,600 tokens in another order
K8_TOL = 5e-2
# K9 against its plain twin on the same inputs, per tensor: |kernel - plain|
# / |plain| (Euclidean norms) <= K9_TOL. Both round to bf16 at the same
# points, but their f32 sums run in another order (over 64-token tiles and
# weight-gradient splits against whole products), so a rounding can fall the
# other way in a few entries. The norm, not the largest entry: where a ReLU
# input or the Q or K feature map's input is within rounding of 0, the two
# sides can take the two branches, and that entry's gradient differs by its
# whole size (tests/test_torch_cuda.py holds the kernel to the twin's own
# distance from its float32 result at small calls, where such entries weigh
# more)
K9_TOL = 1e-2
# K10 against its plain twin on the same inputs, per tensor, in the norm as
# K9_TOL and for its reasons: the same bf16 rounding points, f32 sums in
# another order (over 16-wide tiles and weight-gradient splits), so a
# rounding can fall the other way, and a ReLU or feature-map input within
# rounding of 0 can take the other branch
K10_TOL = 1e-2
# K11 against its plain twin (bf16): both round p and the output to bf16
# after f32 sums in another order; a sum within f32 rounding of a bf16
# boundary rounds the other way: one bf16 ulp of the output (2^-8, rtol),
# and over the probabilities at most 2^-8 sum_j p_j |v_j| <= 2^-8 max |v|
# (|v| < 5 for normal inputs: atol)
K11_ATOL, K11_RTOL = 2e-2, 2**-7
# K12 against K2 through the roll path: the same block body on the same
# windows, so equal up to one bf16 rounding; the tokens the roll wraps into
# a window are pad tokens in K12's map, both masked at -100, whose
# probabilities round to 0 in bf16
K12_K2_RTOL = 2**-8
# wgrad against its plain twin (f32 Aᵀ B of the bf16 values), max |kernel -
# plain| <= WGRAD_TOL max |plain|: both sum exact bf16 products in f32, in
# another order (over 16-token k-steps and the splits' partials)
WGRAD_TOL = 1e-4


def cuda_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def kernel_times(fn, expected=None, tries: int = 3):
    """The device time of each kernel one call of fn() launches, by name,
    from the profiler: [(ms, launches, name)], largest first. `expected`
    maps name fragments to the launches fn() makes of them: a profile that
    records another count lost events, and is taken again, up to `tries`
    times, before this raises."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if is_kernel(e)]
        rows = sorted(((e.device_time_total / 1e3, e.count, e.key) for e in kern), reverse=True)
        seen = {k: sum(c for _, c, name in rows if k in name) for k in expected or {}}
        if seen == dict(expected or {}):
            return rows
        print(f"  profiler: launches seen {seen}, made {expected}: profiling again", flush=True)
    raise AssertionError(f"the profiler lost kernel events {tries} times: saw {seen}, "
                         f"made {expected}")


def fullest_profile(fn, want=None, tries: int = 4):
    """`kernel_times(fn)` of the profile with the most launches over up to
    `tries` profiles, stopping at one that reads `want` launches: the
    profiler now and then drops events (on an H100 a forward of 497
    launches once read 377), which only lowers a count."""
    best = []
    for _ in range(tries):
        rows = kernel_times(fn)
        if sum(r[1] for r in rows) > sum(r[1] for r in best):
            best = rows
        if want is not None and sum(r[1] for r in best) >= want:
            break
    return best


def device_ms(fn, kernel=None, reps: int = 20) -> float:
    """Device ms of one fn() call by the profiler over `reps` calls: of the
    kernels whose names hold `kernel`, which fn() launches once (the
    profile is checked for those `reps` launches, `kernel_times`), or of
    all its kernels where `kernel` is None."""
    def run():
        for _ in range(reps):
            fn()

    rows = kernel_times(run, None if kernel is None else {kernel: reps})
    return sum(ms for ms, _, name in rows if kernel is None or kernel in name) / reps


def is_kernel(event) -> bool:
    """A device event of the profiler that is a kernel, not a user-annotated
    range (such as the optimizer's step) whose time its kernels already count."""
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def close(got: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float):
    """(max abs error, whether |got - ref| <= atol + rtol*|ref| everywhere)."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    return float(err.max()), bool((err <= atol + rtol * r.abs()).all())


class Record:
    """Per-kernel totals over one forward's call sites."""

    def __init__(self):
        self.k = {n: dict(ms=0.0, plain_ms=0.0, lib=None, err=0.0, nbytes=0.0, flops=0.0)
                  for n in [*SOURCES, *HD64, *F32]}

    def site(self, name, count, ms, plain_ms, work, err, lib_ms=None, event_ms=None):
        """One call site: `count` launches per forward or training step;
        work = (bytes, operations); `event_ms`, where given, the kernel's
        time by CUDA events beside `ms` by the profiler."""
        nbytes, flops = work
        k = self.k[name]
        k["ms"] += count * ms
        k["plain_ms"] += count * plain_ms
        k["nbytes"] += count * nbytes
        k["flops"] += count * flops
        k["err"] = max(k["err"], err)
        if lib_ms is not None:  # a kernel has a library call at all its sites or none
            k["lib"] = (k["lib"] or 0.0) + count * lib_ms
        b, by = bound_ms(nbytes, flops, peak(name))
        events = f" (profiler; events {event_ms:.4f} ms)" if event_ms is not None else ""
        print(f"  site {name}: x{count} kernel {ms:.4f} ms{events}, plain {plain_ms:.4f} ms, "
              f"library {'%.4f ms' % lib_ms if lib_ms is not None else 'none'}, "
              f"bound {b:.4f} ms ({by}), {b / ms:.3f} of it, max_abs_err {err:.3e}", flush=True)


def peak(name: str) -> float:
    """The operations' peak of a kernel's bound: float32 outside the tensor
    cores for the float32 forms (F32), bf16 tensor cores for the rest."""
    return FP32_FLOPS if name in F32 else BF16_TENSOR_FLOPS


def rnd(g, *shape, scale=1.0, shift=0.0, dtype=torch.float32):
    t = torch.randn(*shape, generator=g, device="cuda") * scale + shift
    return t.to(dtype).contiguous()


def check_layer_norm(rec: Record, g) -> None:
    import torch.nn.functional as F

    from featurematching_tpu_torch.ops.layer_norm import layer_norm_chain, layer_norm_chain_plain

    # patch_norm, norm_down0, norm_down1 + norm_down2 (single LN each)
    sites = [((8, 19200, 64), 1), ((8, 4800, 128), 1), ((8, 1200, 256), 2)]
    atol = rtol = 1.6e-2  # one bf16 ulp of the output
    print(f"  tolerance |kernel - plain| <= {atol} + {rtol} |plain|")
    for shape, count in sites:
        C = shape[-1]
        x = rnd(g, *shape, dtype=torch.bfloat16)
        s, b = rnd(g, C, scale=0.1, shift=1.0), rnd(g, C, scale=0.1)
        got = layer_norm_chain(x, s, b)
        torch.cuda.synchronize()
        err, ok = close(got, layer_norm_chain_plain(x, s, b), atol, rtol)
        s2, b2 = rnd(g, C, scale=0.1, shift=1.0), rnd(g, C, scale=0.1)
        err2, ok2 = close(layer_norm_chain(x, s, b, s2, b2),
                          layer_norm_chain_plain(x, s, b, s2, b2), atol, rtol)
        torch.cuda.synchronize()
        if not (ok and ok2):
            raise AssertionError(f"layer_norm_chain {shape}: max err {err:.3e} / {err2:.3e}")
        sb, bb = s.bfloat16(), b.bfloat16()
        rows = x.numel() // C
        fn = lambda: layer_norm_chain(x, s, b)  # noqa: E731
        rec.site(
            "layer_norm_chain", count, device_ms(fn, "ln_chain_kernel"),
            cuda_ms(lambda: layer_norm_chain_plain(x, s, b), iters=5),
            layer_norm_work(rows, C), err=max(err, err2),
            lib_ms=device_ms(lambda: F.layer_norm(x, (C,), sb, bb, eps=1e-6)),
            event_ms=cuda_ms(fn),
        )


def check_swin_block(rec: Record, g, heads=(4, 8, 16), name="swin_block_fused") -> None:
    """K2 at the serving forward's three widths with `heads` heads (default
    head dim 16; (1, 2, 4): tpu_optimized_config()'s head dim 64, where the
    kernel must also give the same bits twice), recorded under `name`."""
    from featurematching_tpu_torch.models.backbone_swin import _shift_attn_mask
    from featurematching_tpu_torch.ops.swin_block import swin_block_fused, swin_block_reference

    # (windows, C, heads, padded map, launches without / with the shift mask)
    sites = [(2400, 64, heads[0], (120, 160), 2, 1), (640, 128, heads[1], (64, 80), 2, 1),
             (160, 256, heads[2], (32, 40), 4, 3)]
    atol, rtol = 5e-2, 2e-2  # bf16 intermediates rounded in another order
    print(f"  tolerance |kernel - plain| <= {atol} + {rtol} |plain|")
    for nwin, C, h, (Hp, Wp), n_plain, n_mask in sites:
        hid = 4 * C
        x = rnd(g, nwin, 64, C, dtype=torch.bfloat16)
        p = {
            "ln1_scale": rnd(g, C, scale=0.1, shift=1.0), "ln1_bias": rnd(g, C, scale=0.1),
            "w_qkv": rnd(g, C, 3 * C, scale=C**-0.5, dtype=torch.bfloat16),
            "b_qkv": rnd(g, 3 * C, scale=0.02), "rel_bias": rnd(g, h, 64, 64, scale=0.02),
            "w_proj": rnd(g, C, C, scale=C**-0.5, dtype=torch.bfloat16),
            "b_proj": rnd(g, C, scale=0.02),
            "ln2_scale": rnd(g, C, scale=0.1, shift=1.0), "ln2_bias": rnd(g, C, scale=0.1),
            "w_mlp1": rnd(g, C, hid, scale=C**-0.5, dtype=torch.bfloat16),
            "b_mlp1": rnd(g, hid, scale=0.02),
            "w_mlp2": rnd(g, hid, C, scale=hid**-0.5, dtype=torch.bfloat16),
            "b_mlp2": rnd(g, C, scale=0.02),
        }
        mask = torch.as_tensor(_shift_attn_mask(Hp, Wp, 8, 4), device="cuda")
        for m, count in ((None, n_plain), (mask, n_mask)):
            got = swin_block_fused(x, m, p, h)
            torch.cuda.synchronize()
            err, ok = close(got, swin_block_reference(x, m, p, h), atol, rtol)
            if C // h == 64:
                same = torch.equal(got, swin_block_fused(x, m, p, h))
                print(f"  {nwin} windows C={C} head dim {C // h} mask={m is not None}: "
                      f"max_abs_err {err:.3e}, bit-identical twice {same}")
                ok = ok and same
            if not ok:
                raise AssertionError(f"swin_block_fused C={C} heads={h} mask={m is not None}: "
                                     f"max err {err:.3e}")
            rec.site(
                name, count,
                device_ms(lambda: swin_block_fused(x, m, p, h), "swin_block_kernel"),
                cuda_ms(lambda: swin_block_reference(x, m, p, h), iters=3),
                swin_block_work(nwin, C, h, 0 if m is None else m.shape[0]), err=err,
                event_ms=cuda_ms(lambda: swin_block_fused(x, m, p, h)),
            )


def check_patch_expand(rec: Record, g) -> None:
    from featurematching_tpu_torch.ops.patch_expand import patch_expand_ln, patch_expand_ln_plain

    # dec0 (linear_middle head + LN out), dec1 (LN out), dec2 (linear_end head only)
    sites = [(30, 40, 128, 256, True), (60, 80, 64, 0, True), (120, 160, 64, 64, False)]
    atol, rtol = 3e-2, 1.6e-2  # one bf16 ulp of the outputs
    print(f"  tolerance |kernel - plain| <= {atol} + {rtol} |plain|")
    for h, w, C4, CH, emit in sites:
        y = rnd(g, 8, h * w, 4 * C4, dtype=torch.bfloat16)
        s1, b1 = rnd(g, C4, scale=0.1, shift=1.0), rnd(g, C4, scale=0.1)
        s2, b2 = rnd(g, C4, scale=0.1, shift=1.0), rnd(g, C4, scale=0.1)
        wh = rnd(g, C4, CH, scale=C4**-0.5, dtype=torch.bfloat16) if CH else None
        args = (y, h, w, s1, b1, s2, b2, wh, None, emit)  # the heads have no bias
        got = patch_expand_ln(*args)
        torch.cuda.synchronize()
        ref = patch_expand_ln_plain(*args)
        err = 0.0
        for a, r in zip(got, ref, strict=True):
            e, ok = close(a, r, atol, rtol)
            err = max(err, e)
            if not ok:
                raise AssertionError(f"patch_expand_ln C4={C4} head={CH}: max err {e:.3e}")
        fn = lambda: patch_expand_ln(*args)  # noqa: E731
        rec.site(
            "patch_expand_ln", 1, device_ms(fn, "patch_expand_kernel"),
            cuda_ms(lambda: patch_expand_ln_plain(*args), iters=5),
            patch_expand_work(8, h, w, C4, CH, emit), err=err, event_ms=cuda_ms(fn),
        )


def check_dual_softmax(rec: Record, g) -> None:
    from featurematching_tpu_torch.ops.dual_softmax import (
        _stats_reference,
        dual_softmax_confidence,
        dual_softmax_match_stats,
    )

    Bp, L, C, T = 4, 4800, 256, 0.1
    f0 = rnd(g, Bp, L, C)
    perm = torch.randperm(L, generator=g, device="cuda")
    # image 1 sees most of image 0's cells again, shuffled, with noise
    f1 = (0.8 * f0[:, perm] + 0.6 * rnd(g, Bp, L, C)).bfloat16()
    f0 = f0.bfloat16()
    got = dual_softmax_match_stats(f0, f1, T)
    torch.cuda.synchronize()
    inv_temp = 1.0 / (C * T)
    ref = _stats_reference(f0, f1, inv_temp)
    conf = dual_softmax_confidence(f0, f1, inv_temp)
    rtol = 1e-3  # f32 sums in another order; conf is a product of exps
    print(f"  tolerance: max values within {rtol} relative; each argmax picks a plain "
          f"conf >= (1 - {rtol}) x the plain max")
    err = 0.0
    for gm, rm in ((got.row_max, ref.row_max), (got.col_max, ref.col_max)):
        e, ok = close(gm, rm, 0.0, rtol)
        err = max(err, e)
        if not ok:
            raise AssertionError(f"dual_softmax max values: max err {e:.3e}")
    # argmax: the kernel's pick must be a maximum of the plain conf within rtol
    # (exact equality is not required where two entries tie to f32 rounding)
    row_pick = torch.gather(conf, 2, got.row_argmax.long()[..., None])[..., 0]
    col_pick = torch.gather(conf, 1, got.col_argmax.long()[:, None])[:, 0]
    if not ((row_pick >= ref.row_max * (1 - rtol)).all()
            and (col_pick >= ref.col_max * (1 - rtol)).all()):
        raise AssertionError("dual_softmax argmax picks a non-maximal entry")
    same = float((got.row_argmax == ref.row_argmax).float().mean())
    same_c = float((got.col_argmax == ref.col_argmax).float().mean())
    print(f"  dual_softmax argmax equal to plain: rows {same:.6f}, cols {same_c:.6f}")
    del conf
    rec.site(
        "dual_softmax_match_stats", 1,
        cuda_ms(lambda: dual_softmax_match_stats(f0, f1, T), iters=10),
        cuda_ms(lambda: _stats_reference(f0, f1, inv_temp), iters=3),
        dual_softmax_work(Bp, L, L, C), err=err,
    )


def layer_values(g, C):
    """Random operands of one encoder layer: bf16 weights at lecun scale, LN
    scales near 1 and biases near 0 (f32)."""
    from featurematching_tpu_torch.ops.coarse_transformer import layer_values as pack

    def w(i, o):
        return rnd(g, i, o, scale=i**-0.5, dtype=torch.bfloat16)

    def ln():
        return rnd(g, C, scale=0.1, shift=1.0), rnd(g, C, scale=0.1)

    return pack(w(C, C), w(C, 2 * C), w(C, C), *ln(), w(2 * C, 2 * C), w(2 * C, C), *ln())


def check_coarse_transformer(rec: Record, g, h=8, name="coarse_transformer_fused") -> None:
    """K5 at the serving forward's self and cross calls, C = 256 with `h`
    heads (default 8, head dim 32; 4 at tpu_optimized_config(), head dim 64,
    where each call must also give the same bits twice and the cross call's
    stats launch plants a fault: one cross-warp block of K^T V left out in
    each head group's first head), recorded under `name`; at the default,
    the 8-layer stack too."""
    from featurematching_tpu_torch.ops.coarse_transformer import (
        coarse_layer_fused,
        coarse_layer_with_stats,
        coarse_transformer_fused,
        coarse_transformer_reference,
        encoder_reference,
        STATS_GROUP,
        launch_stats,
        pack_heads,
        stats_errors,
        stats_plan,
        unpack_heads,
    )

    Bp, N, C = B, (H // 8) * (W // 8), 256
    hd64 = C // h == 64
    atol, rtol = 5e-2, 2e-2  # bf16 intermediates rounded in another order (as K2)
    stack_rel = 5e-2  # eight layers: the per-layer differences add up
    print(f"  tolerance per layer |kernel - plain| <= {atol} + {rtol} |plain|; "
          f"8-layer stack max |kernel - plain| <= {stack_rel} max |plain|; the stats kv and ks "
          f"alone within `stats_reference_bounds` (one bf16 ulp of the sum, plus S 2^-23 sum "
          f"|x| for the f32 orders and 2^-6 sqrt(sum x^2) for rounding flips, x = K V or K; "
          f"at most the layer's)")
    # the forward's sites: 4 self layers on both images (G = 2B), 8 cross launches (G = B)
    for G, kind, count in ((2 * Bp, "self", 4), (Bp, "cross", 8)):
        lv = layer_values(g, C)
        x = rnd(g, G, N, C, dtype=torch.bfloat16)
        src = x if kind == "self" else rnd(g, G, N, C, dtype=torch.bfloat16)
        got, kv, ks = coarse_layer_with_stats(x, src, lv, h)
        torch.cuda.synchronize()
        err, ok = close(got, encoder_reference(x, src, lv, h), atol, rtol)
        if not ok:
            raise AssertionError(f"coarse layer ({kind}, G={G}): max err {err:.3e}")
        errs = stats_errors(kv, ks, src, lv, h)
        print(f"  stats ({kind}, G={G}): " + ", ".join(
            f"{k} max err {e:.3e}, {past} of {n} entries past their bound (largest {tol:.3e})"
            for k, (e, past, n, tol) in errs.items()), flush=True)
        if any(past for _, past, _, _ in errs.values()):
            raise AssertionError(f"coarse stats ({kind}, G={G}): kv or ks past its bound")
        if hd64:
            again = coarse_layer_with_stats(x, src, lv, h)
            same = all(torch.equal(a, b) for a, b in zip((got, kv, ks), again))
            print(f"  layer ({kind}, G={G}) head dim 64: max_abs_err {err:.3e}, out, kv and ks "
                  f"bit-identical twice {same}", flush=True)
            if not same:
                raise AssertionError(f"coarse layer ({kind}, G={G}): two runs differ")
        if hd64 and kind == "cross":
            # a planted fault: one block of K^T V that crosses the stats
            # kernel's warps (K features 0-15 against V features 48-63) left
            # out in the first head of each head group
            heads = unpack_heads(kv, h)
            heads[:, ::STATS_GROUP // 64, :16, 48:] = 0
            errs = stats_errors(pack_heads(heads), ks, src, lv, h)
            past = errs["kv"][1]
            print(f"  stats ({kind}, G={G}) with a cross-warp block of K^T V left out in each "
                  f"head group's first head (a planted fault): kv {past} of {errs['kv'][2]} "
                  f"entries past their bound; "
                  f"the check {'caught' if past else 'MISSED'} it", flush=True)
            if not past:
                raise AssertionError("coarse stats: the bound misses a K^T V block left out")
        # a planted fault: runs of one tile that leave each image's last tile out
        tiles = -(-N // 64)
        errs = stats_errors(*launch_stats(src, lv, h, 1, tiles - 1), src, lv, h)
        print(f"  stats ({kind}, G={G}) with each image's last tile left out (a planted fault): "
              + ", ".join(f"{k} {past} of {n} entries past" for k, (_, past, n, _) in errs.items()),
              flush=True)
        if not all(past for _, past, _, _ in errs.values()):
            raise AssertionError(f"coarse stats ({kind}, G={G}): the bound misses a tile left out")
        rec.site(
            name, count,
            cuda_ms(lambda: coarse_layer_fused(x, src, lv, h)),
            cuda_ms(lambda: encoder_reference(x, src, lv, h), iters=3),
            total([coarse_stats_work(G, N, C, h), coarse_apply_work(G, N, C, h)]), err=err,
        )
        times = kernel_times(lambda: coarse_layer_fused(x, src, lv, h),
                             dict.fromkeys(("stats_kernel", "merge_kernel", "apply_kernel"), 1))

        def ms_of(kernel):
            return sum(ms for ms, _, name in times if kernel in name)

        ab, aby = bound_ms(*coarse_apply_work(G, N, C, h))
        sb, sby = bound_ms(*coarse_stats_work(G, N, C, h))
        print(f"  apply kernel ({kind}, G={G}): {ms_of('apply_kernel'):.4f} ms a call (profiler) "
              f"against its own bound {ab:.4f} ms ({aby}), x{count} a forward", flush=True)
        print(f"  stats kernel ({kind}, G={G}): {ms_of('stats_kernel'):.4f} ms a call (profiler) "
              f"against its own bound {sb:.4f} ms ({sby}), merge {ms_of('merge_kernel'):.4f} ms, "
              f"x{count} a forward", flush=True)
    if hd64:
        return
    layers = [layer_values(g, C) for _ in range(8)]
    names = ("self", "cross") * 4
    f0, f1 = rnd(g, Bp, N, C, dtype=torch.bfloat16), rnd(g, Bp, N, C, dtype=torch.bfloat16)
    got = coarse_transformer_fused(f0, f1, layers, names, h)
    ref = coarse_transformer_reference(f0, f1, layers, names, h)
    torch.cuda.synchronize()
    rel = max(float((a.float() - r.float()).abs().max() / r.float().abs().max())
              for a, r in zip(got, ref))
    kms = cuda_ms(lambda: coarse_transformer_fused(f0, f1, layers, names, h), iters=5)
    pms = cuda_ms(lambda: coarse_transformer_reference(f0, f1, layers, names, h), iters=2)
    print(f"  8-layer stack: max err / max |plain| = {rel:.4f}; kernel {kms:.4f} ms, "
          f"plain {pms:.4f} ms")
    if not rel <= stack_rel:
        raise AssertionError(f"coarse transformer stack: relative error {rel:.4f}")


def check_fine_stage(rec: Record, g, h=8, name="fine_stage_fused") -> None:
    """K6 in fold and plain mode at the serving call, 4096 window pairs of
    [49, 64], with `h` heads (default 8, head dim 8; 1 at
    tpu_optimized_config(), head dim 64, where both modes must also give
    the same bits twice), recorded under `name`."""
    from featurematching_tpu_torch.matching.fine import window_heatmaps
    from featurematching_tpu_torch.ops.fine_stage import (
        fine_stage_fused,
        fine_stage_occupancy,
        fine_stage_reference,
    )

    B_, N, C = B * 1024, 49, 64  # max_matches windows a pair, 7x7 taps
    names = ("self", "cross")
    layers = [layer_values(g, C) for _ in names]
    mixes = [(rnd(g, N, scale=0.3), rnd(g, 1)) for _ in range(2)]
    w0, w1 = rnd(g, B_, N, C, dtype=torch.bfloat16), rnd(g, B_, N, C, dtype=torch.bfloat16)
    args = (w0, w1, layers, *mixes, names, h)
    # fold math on the kernel's own windows and centres (its plain mode): f32
    # sums in another order. Against the plain version: windows and mixes as
    # the coarse layers (the mixes at the JAX package's bf16 tolerance for its
    # 49-tap sum); heatmaps within HEAT_ATOL, see its note
    own_atol = 1e-5
    watol, wrtol, matol, mrtol = 5e-2, 2e-2, 0.13, 0.05
    print(f"  tolerance: fold heatmaps vs the heatmaps of the kernel's own plain-mode outputs "
          f"<= {own_atol}; vs the plain version <= {HEAT_ATOL}, rows sum to 1 within 1e-5; "
          f"plain-mode windows <= {watol} + {wrtol} |plain|, mixes <= {matol} + {mrtol} |plain|")
    heat = fine_stage_fused(*args, fold_softargmax=True)
    got = fine_stage_fused(*args)
    torch.cuda.synchronize()
    if C // h == 64:
        same = (all(torch.equal(a, b) for a, b in zip(
            heat, fine_stage_fused(*args, fold_softargmax=True)))
            and all(torch.equal(a, b) for a, b in zip(got, fine_stage_fused(*args))))
        print(f"  head dim 64: fold and plain mode bit-identical twice {same}")
        if not same:
            raise AssertionError("fine_stage head dim 64: two runs differ")
    ref_heat = fine_stage_reference(*args, fold_softargmax=True)
    own = (window_heatmaps(got[2], got[1]), window_heatmaps(got[3], got[0]))
    err = 0.0
    for a, o, r in zip(heat, own, ref_heat, strict=True):
        if tuple(a.shape) != (B_, N) or a.dtype != torch.float32:
            raise AssertionError(f"fine_stage heatmap shape {tuple(a.shape)} {a.dtype}")
        if not ((a.sum(-1) - 1.0).abs() <= 1e-5).all():
            raise AssertionError("fine_stage heatmap rows do not sum to 1")
        e_own, ok_own = close(a, o, own_atol, 0.0)
        e, ok = close(a, r, HEAT_ATOL, 0.0)
        over = float(((a - r).abs() > 1e-2).float().mean())
        print(f"  heatmaps: vs own windows max err {e_own:.3e}; vs plain max err {e:.3e}, "
              f"share of taps off by more than 1e-2: {over:.2e}")
        if not (ok_own and ok):
            raise AssertionError(f"fine_stage heatmaps: max err {e_own:.3e} / {e:.3e}")
        err = max(err, e)
    for i, (a, r) in enumerate(zip(got, fine_stage_reference(*args), strict=True)):
        e, ok = close(a, r, *((watol, wrtol) if i < 2 else (matol, mrtol)))
        print(f"  plain mode output {i}: max err {e:.3e}")
        if a.shape != r.shape or not ok:
            raise AssertionError(f"fine_stage plain mode output {i}: max err {e:.3e}")
    rec.site(
        name, 1,
        cuda_ms(lambda: fine_stage_fused(*args, fold_softargmax=True)),
        cuda_ms(lambda: fine_stage_reference(*args, fold_softargmax=True), iters=3),
        fine_stage_work(B_, N, C, h, len(names)), err=err,
    )
    print_fine_block(fine_stage_occupancy(len(names), h, B_), B_)


def print_fine_block(occ: dict, pairs: int) -> None:
    """K6's block as its library reports it, for `pairs` window pairs."""
    slots = occ["grid"] * occ["pairs_in_flight"]
    print(f"  K6 block: {occ['pairs_in_flight']} window pairs in flight (one a warpgroup), "
          f"{occ['smem_bytes']} bytes of shared memory, {occ['blocks_per_sm']} block(s) an SM; "
          f"grid {occ['grid']}: {pairs} pairs are {pairs / slots:.3f} rounds of its {slots} "
          f"pair slots", flush=True)


def block_params(g, C, h):
    """A Swin block's operands in the kernels' layouts: LN scales near 1,
    biases near 0, weights at lecun scale holding bf16 values (f32 tensors,
    so the kernels and the plain twin see the same weights)."""
    hid = 4 * C

    def w(i, o):
        return rnd(g, i, o, scale=i**-0.5).bfloat16().float()

    return {
        "ln1_scale": rnd(g, C, scale=0.1, shift=1.0), "ln1_bias": rnd(g, C, scale=0.1),
        "w_qkv": w(C, 3 * C), "b_qkv": rnd(g, 3 * C, scale=0.02),
        "rel_bias": rnd(g, h, 64, 64, scale=0.02), "w_proj": w(C, C),
        "b_proj": rnd(g, C, scale=0.02), "ln2_scale": rnd(g, C, scale=0.1, shift=1.0),
        "ln2_bias": rnd(g, C, scale=0.1), "w_mlp1": w(C, hid), "b_mlp1": rnd(g, hid, scale=0.02),
        "w_mlp2": w(hid, C), "b_mlp2": rnd(g, C, scale=0.02),
    }


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|."""
    got, ref = got.detach().float(), ref.detach().float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def norm_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """|got - ref| / |ref| in the Euclidean norm."""
    got, ref = got.detach().float(), ref.detach().float()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def check_swin_block_train(rec: Record, g, heads=(4, 8, 16), suffix="") -> None:
    """K8 at the training step's three widths with `heads` heads (default
    head dim 16; (1, 2, 4): tpu_optimized_config()'s 64), recorded under
    the kernels' names + `suffix`."""
    from featurematching_tpu_torch.models.backbone_swin import _shift_attn_mask
    from featurematching_tpu_torch.ops.swin_block_train import (
        PARAM_KEYS,
        _kernel_params,
        bwd_launch,
        swin_block_train_bwd,
        swin_block_train_fwd,
        swin_block_train_reference,
    )
    from featurematching_tpu_torch.ops.swin_block_train import (
        bwd_occupancy as swin_block_train_bwd_occupancy,
    )

    # the training step's blocks: (windows, C, heads, padded map, launches a
    # step without / with the shift mask), as the serving forward's
    sites = [(2400, 64, heads[0], (120, 160), 2, 1), (640, 128, heads[1], (64, 80), 2, 1),
             (160, 256, heads[2], (32, 40), 4, 3)]
    print(f"  tolerance per tensor (out, dx, 13 gradients): max |kernel - plain| <= {K8_TOL} "
          f"max |plain|")
    for nwin, C, h, (Hp, Wp), n_plain, n_mask in sites:
        x = rnd(g, nwin, 64, C, dtype=torch.bfloat16)
        gout = rnd(g, nwin, 64, C, dtype=torch.bfloat16)
        p = block_params(g, C, h)
        mask = torch.as_tensor(_shift_attn_mask(Hp, Wp, 8, 4), device="cuda")
        per_img = mask.shape[0]
        keep = 0.8  # drop-path scales per image: 0 or 1/keep, at least one of each
        draws = torch.rand(2, nwin // per_img, generator=g, device="cuda") < keep
        draws[:, 0], draws[:, 1] = False, True
        s1, s2 = (draws.float() / keep).repeat_interleave(per_img, dim=1)
        kp = _kernel_params(p, C, h)
        for m, a, b, count in ((None, None, None, n_plain), (mask, s1, s2, n_mask)):
            out, probs, x1 = swin_block_train_fwd(x, m, a, b, kp, h)
            dx, grads = swin_block_train_bwd(x, a, b, probs, x1, gout, kp, h)
            dx2, grads2 = swin_block_train_bwd(x, a, b, probs, x1, gout, kp, h)
            torch.cuda.synchronize()
            same = torch.equal(dx, dx2) and all(map(torch.equal, grads, grads2))
            xr = x.detach().requires_grad_(True)
            pr = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            ref = swin_block_train_reference(xr, m, a, b, pr, h)
            ref.backward(gout)
            errs = {"out": rel_err(out, ref), "dx": rel_err(dx, xr.grad)}
            errs |= {k: rel_err(gr, pr[k].grad) for k, gr in zip(PARAM_KEYS, grads)}
            worst = max(errs, key=errs.get)
            print(f"  C={C} heads={h} mask={m is not None}: relative errors out "
                  f"{errs['out']:.2e}, dx {errs['dx']:.2e}, worst {worst} {errs[worst]:.2e}; "
                  f"backward bit-identical twice {same}")
            bad = {k: v for k, v in errs.items() if not v <= K8_TOL}
            if bad or not same:
                raise AssertionError(f"swin_block_train C={C} heads={h} mask={m is not None}: "
                                     f"{bad}, bit-identical twice {same}")

            def plain_fb():
                xx = x.detach().requires_grad_(True)
                pp = {k: v.detach().requires_grad_(True) for k, v in p.items()}
                swin_block_train_reference(xx, m, a, b, pp, h).backward(gout)

            _, rows = profile_ms(lambda: swin_block_train_bwd(x, a, b, probs, x1, gout, kp, h))
            split = {}
            for ms, _, name in rows:  # by kernel: mlp_bwd, attn_bwd, wgrad, sum_parts
                bare = name.replace("(anonymous namespace)::", "").replace("void ", "")
                k = re.split(r"[<(]", bare)[0].split("::")[-1]
                split[k] = split.get(k, 0.0) + ms
            nw = 0 if m is None else m.shape[0]
            print(f"    attn_bwd at head dim {C // h}: "
                  f"{swin_block_train_bwd_occupancy(C, 0, C // h)[1]} block(s) an SM")
            ab, aby = bound_ms(*swin_block_train_attn_bwd_work(nwin, C, h, nw))
            mb, mby = bound_ms(*swin_block_train_mlp_bwd_work(nwin, C, h, nw))
            print("    backward by kernel: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
                  + f"; attn_bwd bound {ab:.4f} ms ({aby}); mlp_bwd bound {mb:.4f} ms ({mby})")
            if C == 256 and m is not None:
                # a planted fault: mlp_bwd leaves the last window out
                fdx, fgrads, _ = bwd_launch(x, a, b, probs, x1, gout, kp, h, nwin - 1)
                torch.cuda.synchronize()
                ferrs = {"dx": rel_err(fdx, xr.grad)}
                ferrs |= {k: rel_err(gr, pr[k].grad) for k, gr in zip(PARAM_KEYS, fgrads)}
                fworst = max(ferrs, key=ferrs.get)
                print(f"    planted fault, mlp_bwd's last window left out: worst {fworst} "
                      f"{ferrs[fworst]:.2e}, {sum(v > K8_TOL for v in ferrs.values())} of "
                      f"{len(ferrs)} tensors past {K8_TOL}")
                if not ferrs[fworst] > K8_TOL:
                    raise AssertionError("swin_block_train: the check misses mlp_bwd's window "
                                         "left out")
            pf = cuda_ms(lambda: swin_block_train_reference(x, m, a, b, p, h), iters=3)
            pfb = cuda_ms(plain_fb, iters=3)
            rec.site("swin_block_train_fwd" + suffix, count,
                     cuda_ms(lambda: swin_block_train_fwd(x, m, a, b, kp, h)), pf,
                     swin_block_train_fwd_work(nwin, C, h, nw),
                     err=float((out.float() - ref.detach().float()).abs().max()))
            rec.site("swin_block_train_bwd" + suffix, count,
                     cuda_ms(lambda: swin_block_train_bwd(x, a, b, probs, x1, gout, kp, h),
                             iters=10),
                     pfb - pf, swin_block_train_bwd_work(nwin, C, h, nw),
                     err=float((dx.float() - xr.grad.float()).abs().max()))


def gt_pairs(g, Bp, L, S, G, perm=None):
    """[Bp, G] GT pairs: true matches where `perm` maps columns to rows, 10
    duplicated pairs and about a tenth masked out."""
    gj = torch.randint(0, S, (Bp, G), generator=g, device="cuda")
    gi = perm[gj] if perm is not None else torch.randint(0, L, (Bp, G), generator=g, device="cuda")
    gi[:, 10:20], gj[:, 10:20] = gi[:, :10], gj[:, :10]
    mask = torch.rand(Bp, G, generator=g, device="cuda") < 0.9
    return gi, gj, mask


def check_sparse_focal_loss(rec: Record, g) -> None:
    from featurematching_tpu_torch.ops.dual_softmax import _lse_reference, dual_softmax_lse
    from featurematching_tpu_torch.ops.sparse_focal_loss import (
        UNIT_ROWS,
        _capacity,
        _scatter_rows,
        naive_sparse_focal_loss,
        plan,
        sparse_focal_backward,
        sparse_focal_backward_reference,
        sparse_focal_loss,
    )

    lse_atol, k7_tol, loss_rtol, grad_tol = 1e-3, 1e-2, 2e-2, 5e-2
    print(f"  tolerance: log-sum-exps within {lse_atol} (f32 sums in another order, |lse| ~ 10); "
          f"K7's softmax terms max |kernel - plain| <= {k7_tol} max |plain| (dsim rounded to "
          f"bf16 on both sides, f32 sums in another order); the whole loss within {loss_rtol} "
          f"and its gradients within {grad_tol} max |plain| of the materialised loss (the "
          f"kernels fold inv_temp into bf16 f0, as the TPU kernels do; the materialised loss "
          f"scales in f32)")
    for Bp, L, S, C, G, timed in ((B, 4800, 4800, 256, 1024, True), (2, 1000, 777, 256, 300, False)):
        inv_temp = 1.0 / (C * 0.1)
        f0 = rnd(g, Bp, L, C)
        perm = torch.randperm(L, generator=g, device="cuda")[:S]
        f1 = (0.8 * f0[:, perm] + 0.6 * rnd(g, Bp, S, C)).bfloat16()
        f0 = f0.bfloat16()
        gi, gj, gm = gt_pairs(g, Bp, L, S, G, perm)
        lr, lc = dual_softmax_lse(f0, f1, inv_temp)
        torch.cuda.synchronize()
        rr, rc = _lse_reference(f0, f1, inv_temp)
        e_lse = max(float((lr - rr).abs().max()), float((lc - rc).abs().max()))
        gbar = torch.rand(Bp, G, generator=g, device="cuda") * gm
        a_r, a_c = _scatter_rows(L, gi, gbar), _scatter_rows(S, gj, gbar)
        sms, per_sm = _capacity(C, torch.cuda.current_device())
        p = plan(Bp, L, S, sms, per_sm)
        units = Bp * sum(p.row_blocks)
        print(f"  K7 plan [{Bp}, {L}] x [{Bp}, {S}]: {p.grid} blocks ({per_sm} an SM, {sms} SMs), "
              f"{units} units of {UNIT_ROWS} rows, {p.total} steps of 64 rows, "
              f"{p.total / p.grid:.2f} steps a block")
        d0, d1 = sparse_focal_backward(f0, f1, a_r, lr, a_c, lc, inv_temp)
        x0, x1 = sparse_focal_backward(f0, f1, a_r, lr, a_c, lc, inv_temp)
        torch.cuda.synchronize()
        same = torch.equal(d0, x0) and torch.equal(d1, x1)
        del x0, x1
        r0, r1 = sparse_focal_backward_reference(f0, f1, a_r, lr, a_c, lc, inv_temp)
        e_k7 = max(rel_err(d0, r0), rel_err(d1, r1))
        t0, t1 = f0.detach().requires_grad_(True), f1.detach().requires_grad_(True)
        loss = sparse_focal_loss(t0, t1, gi, gj, gm, inv_temp)
        loss.backward()
        n0, n1 = f0.detach().requires_grad_(True), f1.detach().requires_grad_(True)
        ref = naive_sparse_focal_loss(n0, n1, gi, gj, gm, inv_temp)
        ref.backward()
        loss, ref = float(loss.detach()), float(ref.detach())
        e_loss = abs(loss - ref) / abs(ref)
        e_grad = max(rel_err(t0.grad, n0.grad), rel_err(t1.grad, n1.grad))
        print(f"  [{Bp}, {L}, {C}] x [{Bp}, {S}, {C}], {G} pairs: lse err {e_lse:.2e}, K7 "
              f"relative err {e_k7:.2e}, bit-identical twice {same}, loss {loss:.6f} vs "
              f"{ref:.6f} (rel {e_loss:.2e}), gradients rel err {e_grad:.2e}")
        if not (e_lse <= lse_atol and e_k7 <= k7_tol and same and e_loss <= loss_rtol
                and e_grad <= grad_tol):
            raise AssertionError(f"sparse focal loss [{Bp}, {L}, {S}]: errors {e_lse:.2e} "
                                 f"{e_k7:.2e} {e_loss:.2e} {e_grad:.2e}, K7 bit-identical "
                                 f"twice {same}")
        if not timed:
            continue
        del ref, n0, n1
        rec.site("dual_softmax_lse", 1, cuda_ms(lambda: dual_softmax_lse(f0, f1, inv_temp)),
                 cuda_ms(lambda: _lse_reference(f0, f1, inv_temp), iters=3),
                 dual_softmax_lse_work(Bp, L, S, C), err=e_lse)
        rec.site("sparse_focal_backward", 1,
                 cuda_ms(lambda: sparse_focal_backward(f0, f1, a_r, lr, a_c, lc, inv_temp), iters=5),
                 cuda_ms(lambda: sparse_focal_backward_reference(f0, f1, a_r, lr, a_c, lc, inv_temp),
                         iters=3),
                 sparse_focal_backward_work(Bp, L, S, C),
                 err=max(float((d0 - r0).abs().max()), float((d1 - r1).abs().max())))


K9_GRADS = ("q_proj", "k_proj", "v_proj", "merge", "norm1.weight", "norm1.bias", "mlp1", "mlp2",
            "norm2.weight", "norm2.bias")


def k9_tensors(out, grads) -> dict:
    """A K9 or K10 call's (dx, dsrc, (dwq, dwkv, ...)) by name, the [C, 2C]
    K | V gradient in its two halves, as the layer's 10 parameters take
    them; no dsrc where it is None (a K10 self call adds it into dx)."""
    dx, dsrc, (dwq, dwkv, dwm, dn1s, dn1b, dw1, dw2, dn2s, dn2b) = grads
    C = dwq.shape[0]
    vals = (dwq, dwkv[:, :C], dwkv[:, C:], dwm, dn1s, dn1b, dw1, dw2, dn2s, dn2b)
    named = {"dx": dx} | ({} if dsrc is None else {"dsrc": dsrc}) | dict(zip(K9_GRADS, vals))
    return named if out is None else {"out": out} | named


def check_coarse_train(rec: Record, g, h=8, suffix="") -> None:
    """K9 at the training step's calls with h heads of C = 256 (default
    head dim 32; 4: tpu_optimized_config()'s 64), recorded under the
    kernels' names + `suffix`."""
    from featurematching_tpu_torch.ops.coarse_transformer import encoder_reference_with_stats
    from featurematching_tpu_torch.ops.coarse_transformer_train import (
        coarse_layer_backward,
        coarse_layer_backward_reference,
        coarse_layer_forward,
        train_values,
    )

    N, C = (H // 8) * (W // 8), 256
    print(f"  tolerance per tensor (out, kv, ks, dx, dsrc, 10 gradients): |kernel - plain| <= "
          f"{K9_TOL} |plain| (norms); max |kernel - plain| / max |plain| printed")
    # the step's calls: 4 self calls on both images (G = 2B), 8 cross calls (G = B)
    for G, kind, count in ((2 * B, "self", 4), (B, "cross", 8)):
        lv = layer_values(g, C)
        lt = train_values(lv)
        x = rnd(g, G, N, C, dtype=torch.bfloat16)
        src = x if kind == "self" else rnd(g, G, N, C, dtype=torch.bfloat16)
        gout = rnd(g, G, N, C, dtype=torch.bfloat16)
        out, kv, ks = coarse_layer_forward(x, src, lv, h)
        got = k9_tensors(out, coarse_layer_backward(x, src, kv, ks, gout, lv, lt, h))
        again = k9_tensors(out, coarse_layer_backward(x, src, kv, ks, gout, lv, lt, h))
        torch.cuda.synchronize()
        same = all(torch.equal(got[n], again[n]) for n in got)
        ref_out, ref_kv, ref_ks = encoder_reference_with_stats(x, src, lv, h)
        ref = k9_tensors(ref_out, coarse_layer_backward_reference(x, src, kv, ks, gout, lv, h))
        pairs = dict(got, kv=kv, ks=ks)
        refs = dict(ref, kv=ref_kv, ks=ref_ks)
        errs = {n: norm_err(pairs[n], refs[n]) for n in pairs}
        worst = max(errs, key=errs.get)
        peak = {n: rel_err(pairs[n], refs[n]) for n in pairs}
        wpeak = max(peak, key=peak.get)
        print(f"  {kind} call, G={G}, {h} heads: norm errors out {errs['out']:.2e}, dx "
              f"{errs['dx']:.2e}, dsrc {errs['dsrc']:.2e}, worst {worst} {errs[worst]:.2e}; "
              f"largest entry error / max |plain|: {wpeak} {peak[wpeak]:.2e}; backward "
              f"bit-identical twice {same}")
        bad = {k: v for k, v in errs.items() if not v <= K9_TOL}
        if bad or not same:
            raise AssertionError(f"coarse_transformer_train ({kind}, G={G}, {h} heads): {bad}, "
                                 f"bit-identical twice {same}")
        bwd = lambda: coarse_layer_backward(x, src, kv, ks, gout, lv, lt, h)  # noqa: E731
        profile_ms(bwd)  # a first session here has dropped the first kernel's record
        _, rows = profile_ms(bwd)
        split = {}
        for ms, _, name in rows:  # by kernel: apply_bwd, bwd_merge, stats_bwd, wgrad, sum_parts
            bare = name.replace("(anonymous namespace)::", "").replace("void ", "")
            k = re.split(r"[<(]", bare)[0].split("::")[-1]
            split[k] = split.get(k, 0.0) + ms
        ab, aby = bound_ms(*coarse_train_apply_bwd_work(G, N, N, C, h))
        sb, sby = bound_ms(*coarse_train_stats_bwd_work(G, N, C, h))
        print("    backward by kernel: " + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
              + f"; apply_bwd bound {ab:.4f} ms ({aby}); stats_bwd "
              f"{split.get('stats_bwd_kernel', 0.0):.4f} ms against its bound {sb:.4f} ms ({sby})")
        rec.site("coarse_layer_forward" + suffix, count,
                 cuda_ms(lambda: coarse_layer_forward(x, src, lv, h)),
                 cuda_ms(lambda: encoder_reference_with_stats(x, src, lv, h), iters=3),
                 coarse_train_fwd_work(G, N, N, C, h),
                 err=float((out.float() - ref_out.float()).abs().max()))
        rec.site("coarse_layer_backward" + suffix, count,
                 cuda_ms(lambda: coarse_layer_backward(x, src, kv, ks, gout, lv, lt, h), iters=10),
                 cuda_ms(lambda: coarse_layer_backward_reference(x, src, kv, ks, gout, lv, h),
                         iters=3),
                 coarse_train_bwd_work(G, N, N, C, h, kind == "self"),
                 err=float((got["dx"].float() - ref["dx"].float()).abs().max()))


def print_window_bwd_block(occ: dict, windows: int) -> None:
    """K10's window stage as its library reports it, for `windows` windows."""
    slots = occ["grid"] * occ["warpgroups"]
    print(f"  K10 window_bwd block: {occ['warpgroups']} windows in flight (one a warpgroup), "
          f"{occ['smem_bytes']} bytes of shared memory, {occ['blocks_per_sm']} block(s) an SM; "
          f"grid {occ['grid']}: {windows} windows are {windows / slots:.3f} rounds of its {slots} "
          f"window slots (fill {windows / (-(-windows // slots) * slots):.0%})", flush=True)


def check_fine_train(rec: Record, g, h=8, suffix="") -> None:
    """K10 at the training step's calls with h heads of C = 64 (default head
    dim 8; 1: tpu_optimized_config()'s 64), recorded under the kernels'
    names + `suffix`."""
    from featurematching_tpu_torch.ops.fine_stage import (
        fine_layer_forward,
        fine_layer_reference,
        fine_stage_occupancy,
    )
    from featurematching_tpu_torch.ops.fine_transformer_train import (
        bwd_launch,
        fine_layer_backward,
        fine_layer_backward_reference,
        window_bwd_occupancy,
    )

    nwin, N, C = B * 1024, 49, 64  # max_gt_matches windows a pair, 7x7 taps
    print_fine_block(fine_stage_occupancy(1, h, nwin), nwin)  # K10's forward: one layer
    print(f"  tolerance per tensor (the layer's two outputs, dx, dsrc, 10 gradients): "
          f"|kernel - plain| <= {K10_TOL} |plain| (norms); max |kernel - plain| / max |plain| "
          f"printed")
    # the step's layers: a self layer (one backward call on both sides' windows,
    # G = 2 nwin) and a cross layer (two backward calls, G = nwin; the first here)
    for kind, G, count in (("self", 2 * nwin, 1), ("cross", nwin, 2)):
        print_window_bwd_block(window_bwd_occupancy(h, G), G)
        lv = layer_values(g, C)
        w0, w1 = rnd(g, nwin, N, C, dtype=torch.bfloat16), rnd(g, nwin, N, C, dtype=torch.bfloat16)
        out = fine_layer_forward(w0, w1, lv, kind, h)
        ref_out = fine_layer_reference(w0, w1, lv, kind, h)
        x = torch.cat([w0, w1]) if kind == "self" else w0
        src = x if kind == "self" else w1
        gout = rnd(g, G, N, C)
        got = k9_tensors(None, fine_layer_backward(x, src, gout, lv, h))
        again = k9_tensors(None, fine_layer_backward(x, src, gout, lv, h))
        torch.cuda.synchronize()
        same = all(torch.equal(got[n], again[n]) for n in got)
        ref = k9_tensors(None, fine_layer_backward_reference(x, src, gout, lv, h))
        got |= {"out0": out[0], "out1": out[1]}
        ref |= {"out0": ref_out[0], "out1": ref_out[1]}
        errs = {n: norm_err(got[n], ref[n]) for n in got}
        worst = max(errs, key=errs.get)
        peak = {n: rel_err(got[n], ref[n]) for n in got}
        wpeak = max(peak, key=peak.get)
        dsrc = f"dsrc {errs['dsrc']:.2e}" if "dsrc" in errs else "dsrc added into dx"
        print(f"  {kind} layer, {h} heads, backward call G={G}: norm errors out0 "
              f"{errs['out0']:.2e}, dx "
              f"{errs['dx']:.2e}, {dsrc}, worst {worst} {errs[worst]:.2e}; "
              f"largest entry error / max |plain|: {wpeak} {peak[wpeak]:.2e}; bit-identical "
              f"twice {same}")
        bad = {k: v for k, v in errs.items() if not v <= K10_TOL}
        if bad or not same:
            raise AssertionError(f"fine_transformer_train ({kind}, G={G}): {bad}, "
                                 f"bit-identical twice {same}")
        if kind == "cross":
            # a planted fault: the window stage leaves the last window out
            fault = k9_tensors(None, bwd_launch(x, src, gout, lv, h, G - 1))
            torch.cuda.synchronize()
            ferrs = {n: norm_err(fault[n], ref[n]) for n in fault}
            fworst = max(ferrs, key=ferrs.get)
            print(f"    planted fault, window_bwd's last window left out: worst {fworst} "
                  f"{ferrs[fworst]:.2e}, {sum(v > K10_TOL for v in ferrs.values())} of "
                  f"{len(ferrs)} tensors past {K10_TOL}")
            if not ferrs[fworst] > K10_TOL:
                raise AssertionError("fine_transformer_train: the check misses window_bwd's "
                                     "window left out")
        bwd = lambda: fine_layer_backward(x, src, gout, lv, h)  # noqa: E731
        profile_ms(bwd)
        _, rows = profile_ms(bwd)
        split = {}
        for ms, _, name in rows:  # by kernel: window_bwd, wgrad, sum_parts
            bare = name.replace("(anonymous namespace)::", "").replace("void ", "")
            k = re.split(r"[<(]", bare)[0].split("::")[-1]
            split[k] = split.get(k, 0.0) + ms
        wb, wby = bound_ms(*fine_train_window_bwd_work(G, N, C, h, kind == "self"))
        print("    backward by kernel: " + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
              + f"; window_bwd bound {wb:.4f} ms ({wby})")
        calls = 1 if kind == "self" else 2
        rec.site("fine_layer_forward" + suffix, 1,
                 cuda_ms(lambda: fine_layer_forward(w0, w1, lv, kind, h)),
                 cuda_ms(lambda: fine_layer_reference(w0, w1, lv, kind, h), iters=3),
                 total([fine_train_fwd_work(G, N, C, h)] * calls),
                 err=max(float((a.float() - r.float()).abs().max())
                         for a, r in zip(out, ref_out)))
        rec.site("fine_layer_backward" + suffix, count, cuda_ms(bwd, iters=10),
                 cuda_ms(lambda: fine_layer_backward_reference(x, src, gout, lv, h), iters=3),
                 fine_train_bwd_work(G, N, C, h, kind == "self"),
                 err=float((got["dx"] - ref["dx"]).abs().max()))


def check_wgrad(rec: Record, g) -> None:
    from collections import Counter

    from featurematching_tpu_torch.config import default_config
    from featurematching_tpu_torch.ops.wgrad import plan, sm_count, wgrad_group, wgrad_reference

    groups = Counter(tuple(grp) for grp in wgrad_groups(default_config().model))
    sms = sm_count(torch.cuda.current_device())
    print(f"  the training step's {sum(len(k) * n for k, n in groups.items())} weight-gradient "
          f"products in {sum(groups.values())} launches, {len(groups)} distinct; tolerance max "
          f"|kernel - plain| <= {WGRAD_TOL} max |plain| a product, two launches bit-identical; "
          f"library: torch.mm(a.t(), b) (bf16 out) a product")
    for group, count in groups.items():
        T = group[0][0]
        names = {}
        for _, M, N, a, b in group:
            names.setdefault(a, rnd(g, T, M, dtype=torch.bfloat16))
            names.setdefault(b, rnd(g, T, N, dtype=torch.bfloat16))
        pairs = [(names[a], names[b]) for _, _, _, a, b in group]
        got, again = wgrad_group(pairs), wgrad_group(pairs)
        torch.cuda.synchronize()
        refs = [wgrad_reference(a, b) for a, b in pairs]
        err = max(rel_err(d, r) for d, r in zip(got, refs))
        same = all(torch.equal(d, e) for d, e in zip(got, again))
        cut = ", ".join(f"{M}x{N}: {p.splits}x{p.per}" for (_, M, N, _, _), p in
                        zip(group, plan([pr[:3] for pr in group], sms)))
        print(f"  T={T}, {len(group)} products x{count}: relative err {err:.2e}, bit-identical "
              f"twice {same}; splits x stages {cut}")
        if not (err <= WGRAD_TOL and same):
            raise AssertionError(f"wgrad T={T}: error {err:.2e}, bit-identical {same}")

        def library():
            for a, b in pairs:
                torch.mm(a.t(), b)

        rec.site("wgrad", count, device_ms(lambda: wgrad_group(pairs)),
                 device_ms(lambda: [wgrad_reference(a, b) for a, b in pairs], reps=3),
                 wgrad_group_work(list(group)),
                 err=max(float((d - r).abs().max()) for d, r in zip(got, refs)),
                 lib_ms=device_ms(library), event_ms=cuda_ms(lambda: wgrad_group(pairs)))
        del names, pairs, got, again, refs


def backbone_blocks(cfg):
    """The backbone's Swin blocks at 640x480, batch 4, grouped: [(count, (H,
    W) map, C, heads, shift)] (odd blocks shifted)."""
    groups = {}
    for st in swin_sites(cfg, 2 * B, H, W):
        key = (st.map_hw, st.C, st.heads, cfg.swin.window_size // 2 if st.mask_windows else 0)
        groups[key] = groups.get(key, 0) + 1
    return [(count, *key) for key, count in groups.items()]


def padded(hw, w=8):
    return tuple(-(-v // w) * w for v in hw)


def check_window_attention(rec: Record, g) -> None:
    import torch.nn.functional as F

    from featurematching_tpu_torch.config import default_config, tpu_optimized_config
    from featurematching_tpu_torch.models.backbone_swin import _shift_attn_mask
    from featurematching_tpu_torch.ops.window_attention import (
        launch_plan,
        window_attention,
        window_attention_reference,
    )

    print(f"  tolerance |kernel - plain| <= {K11_ATOL} + {K11_RTOL} |plain|")

    def site(count, hw, C, h, shift, record):
        Hp, Wp = padded(hw)
        nwin = 2 * B * (Hp // 8) * (Wp // 8)
        d = C // h
        scale = d**-0.5
        qkv = rnd(g, nwin, 64, 3 * C, dtype=torch.bfloat16)
        bias = rnd(g, h, 64, 64, scale=0.02)
        mask = (torch.as_tensor(_shift_attn_mask(Hp, Wp, 8, shift), device="cuda")
                if shift else None)
        got = window_attention(qkv, bias, mask, h, scale)
        torch.cuda.synchronize()
        err, ok = close(got, window_attention_reference(qkv, bias, mask, h, scale),
                        K11_ATOL, K11_RTOL)
        same = torch.equal(got, window_attention(qkv, bias, mask, h, scale))
        p = launch_plan(nwin, C, h, mask is not None)
        print(f"  {nwin} windows C={C} head dim {d} mask={mask is not None}: "
              f"max_abs_err {err:.3e}, bit-identical twice {same}; grid {p.groups} head "
              f"group(s) x {p.runs} runs of windows = {p.grid} blocks")
        if not (ok and same):
            raise AssertionError(f"window_attention C={C} d={d} mask={mask is not None}: "
                                 f"max err {err:.3e}, bit-identical twice {same}")
        if not record:
            return
        q, k, v = qkv.view(nwin, 64, 3, h, d).permute(2, 0, 3, 1, 4)
        am = bias.bfloat16()[None]
        if mask is not None:  # SDPA's float mask: bias plus each window's shift mask
            wid = torch.arange(nwin, device="cuda") % mask.shape[0]
            am = (bias[None] + mask[wid][:, None]).bfloat16()
        rec.site("window_attention", count,
                 device_ms(lambda: window_attention(qkv, bias, mask, h, scale),
                           "window_attention_kernel"),
                 cuda_ms(lambda: window_attention_reference(qkv, bias, mask, h, scale), iters=5),
                 window_attention_work(nwin, C, h, 0 if mask is None else mask.shape[0]), err=err,
                 lib_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                                       scale=scale)),
                 event_ms=cuda_ms(lambda: window_attention(qkv, bias, mask, h, scale)))

    for count, hw, C, h, shift in backbone_blocks(default_config().model):
        site(count, hw, C, h, shift, True)
    print("  tpu_optimized_config() (head dim 64), not in the totals:")
    for count, hw, C, h, shift in backbone_blocks(tpu_optimized_config().model):
        site(count, hw, C, h, shift, False)
    print("  head dim 32, not in the totals:")
    site(1, (60, 80), 128, 4, 4, False)


def roll_path(x, Hh, Ww, shift, block):
    """The serving backbone's window plumbing around block(windows, mask):
    pad to the window, roll, partition, the block, reverse, roll back, crop."""
    import torch.nn.functional as F

    from featurematching_tpu_torch.models.backbone_swin import (
        _shift_attn_mask,
        window_partition,
        window_reverse,
    )

    Bx, L, C = x.shape
    Hp, Wp = padded((Hh, Ww))
    xi = F.pad(x.reshape(Bx, Hh, Ww, C), (0, 0, 0, Wp - Ww, 0, Hp - Hh))
    mask = None
    if shift:
        xi = torch.roll(xi, shifts=(-shift, -shift), dims=(1, 2))
        mask = torch.as_tensor(_shift_attn_mask(Hp, Wp, 8, shift), device=x.device)
    oi = window_reverse(block(window_partition(xi, 8).contiguous(), mask), 8, Hp, Wp)
    if shift:
        oi = torch.roll(oi, shifts=(shift, shift), dims=(1, 2))
    return oi[:, :Hh, :Ww].reshape(Bx, Hh * Ww, C)


def check_swin_block_image(rec: Record, g, launches: dict, cfg=None,
                           name="swin_block_fused_image") -> None:
    """K12 at every block of the backbone of `cfg` (default_config() when
    None; tpu_optimized_config(): head dim 64, where each site must also
    give the same bits twice), recorded under `name`; then the 13 blocks
    through swin_block_image N_FORWARD times, their launches into
    `launches[name]`."""
    from featurematching_tpu_torch.config import default_config
    from featurematching_tpu_torch.ops.swin_block import swin_block_fused
    from featurematching_tpu_torch.ops.swin_block_image import (
        pad_image,
        swin_block_fused_image,
        swin_block_image,
        swin_block_image_reference,
    )

    atol, rtol = 5e-2, 2e-2  # K2's: bf16 intermediates rounded in another order
    print(f"  tolerance against the plain twin |kernel - plain| <= {atol} + {rtol} |plain|; "
          f"against K2 through the roll path |K12 - K2| <= {K12_K2_RTOL} |K2| (the same "
          "block body on the same windows)")
    inputs = []
    for count, (Hh, Ww), C, h, shift in backbone_blocks(cfg or default_config().model):
        x = rnd(g, 2 * B, Hh * Ww, C, dtype=torch.bfloat16)
        p = block_params(g, C, h)
        xp, top = pad_image(x, Hh, Ww, 8, shift)
        got = swin_block_fused_image(xp, p, h, 8, shift)
        torch.cuda.synchronize()
        err, ok = close(got, swin_block_image_reference(xp, p, h, 8, shift), atol, rtol)
        if C // h == 64:
            same = torch.equal(got, swin_block_fused_image(xp, p, h, 8, shift))
            print(f"  head dim {C // h}: bit-identical twice {same}")
            ok = ok and same

        def k2_path():
            return roll_path(x, Hh, Ww, shift, lambda xw, m: swin_block_fused(xw, m, p, h))

        k2 = k2_path()
        img = swin_block_image(x, Hh, Ww, p, h, 8, shift)
        torch.cuda.synchronize()
        err_k2 = float((img.float() - k2.float()).abs().max())
        ok_k2 = bool(((img.float() - k2.float()).abs() <= K12_K2_RTOL * k2.float().abs()).all())
        print(f"  {2 * B}x{Hh}x{Ww} C={C} shift={shift}: max_abs_err {err:.3e} against the twin, "
              f"{err_k2:.3e} against K2 through the roll path")
        if not (ok and ok_k2):
            raise AssertionError(f"swin_block_fused_image {Hh}x{Ww} C={C} shift={shift}: "
                                 f"max err {err:.3e} (twin), {err_k2:.3e} (K2)")
        whole = cuda_ms(lambda: swin_block_image(x, Hh, Ww, p, h, 8, shift))
        k2_whole = cuda_ms(k2_path)
        print(f"    K12 with its pad and slice {whole:.4f} ms; K2 with the pad, roll, "
              f"partition, reverse, roll back and crop {k2_whole:.4f} ms")
        # the function's work is the block's on the map's windows (K2's count,
        # as kernel_bounds counts K12); the pad formulation's extra row and
        # column of windows are the kernel's own cost
        Hp, Wp = padded((Hh, Ww))
        nw = (Hp // 8) * (Wp // 8)
        rec.site(name, count,
                 device_ms(lambda: swin_block_fused_image(xp, p, h, 8, shift),
                           "swin_block_kernel"),
                 cuda_ms(lambda: swin_block_image_reference(xp, p, h, 8, shift), iters=3),
                 swin_block_work(2 * B * nw, C, h, nw if shift else 0, tokens=2 * B * Hh * Ww),
                 err=err, event_ms=cuda_ms(lambda: swin_block_fused_image(xp, p, h, 8, shift)))
        inputs.append((count, x, Hh, Ww, p, h, shift))
    # K12 on its own path: the backbone's 13 blocks, each through
    # swin_block_image, N_FORWARD times as the forwards run
    swin_block_fused_image.launches = 0
    for _ in range(N_FORWARD):
        for count, x, Hh, Ww, p, h, shift in inputs:
            for _ in range(count):
                swin_block_image(x, Hh, Ww, p, h, 8, shift)
    torch.cuda.synchronize()
    launches[name] = swin_block_fused_image.launches
    print(f"  the backbone's blocks through swin_block_image, {N_FORWARD} times: "
          f"{swin_block_fused_image.launches} launches")
    if swin_block_fused_image.launches != 13 * N_FORWARD:
        raise AssertionError("swin_block_image did not launch K12 once a block")


def eval_forward(wrappers, launches) -> None:
    import numpy as np

    from featurematching_tpu_torch.data.synthetic import synthetic_batch
    from featurematching_tpu_torch.train.step import create_train_state, eval_step

    cfg = training_config(fused_block="off")
    state = create_train_state(cfg, device="cuda", seed=0)
    batch = synthetic_batch(np.random.default_rng(0), batch_size=B, image_size=(H, W),
                            num_gt=cfg.model.match_coarse.max_gt_matches)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    eval_step(state, batch)  # warm-up
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t = time.perf_counter()
    for _ in range(N_FORWARD):
        out, ev = eval_step(state, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches.update({n: w.launches for n, w in wrappers.items()})
    print(f"  launches over {N_FORWARD} evaluation steps: {launches}")
    for n, per in EXPECTED_PER_EVAL.items():
        if launches[n] != per * N_FORWARD:
            raise AssertionError(f"{n}: {launches[n]} launches, expected {per * N_FORWARD}")
    m = out.coarse.mask
    if out.feat_c0.shape != (B, (H // 8) * (W // 8), 256):
        raise AssertionError("unexpected output shapes")
    for t_ in (ev.loss, out.feat_c0, out.feat_c1, out.coarse.mconf, out.fine.mkpts0_f,
               out.fine.mkpts1_f):
        if not torch.isfinite(t_.float()).all():
            raise AssertionError("non-finite output")
    fwd_ms = dt / N_FORWARD * 1e3
    print(f"  evaluation step: {fwd_ms:.3f} ms, {B * N_FORWARD / dt:.3f} pairs/s (batch {B}, "
          f"{W}x{H}, bf16, {int(m.sum())} matches at thr {cfg.model.match_coarse.thr})",
          flush=True)
    model = state.model
    imgs = torch.cat([batch["image0"], batch["image1"]]).to(model.dtype)
    with torch.no_grad():
        bb_ms, _ = profile_ms(lambda: model.backbone(imgs, fused_block=False,
                                                     fused_attention=True))
    busy, rows = profile_ms(lambda: eval_step(state, batch))
    print(f"  device: {busy:.3f} ms busy = {busy / fwd_ms:.3f} of the {fwd_ms:.3f} ms step; "
          f"backbone (per-op blocks, K11) {bb_ms:.3f} ms of device time")
    print(f"  profiler: {len(rows)} kernel names, {sum(r[1] for r in rows)} launches a step")
    for ms, count, name in rows[:10]:
        print(f"    {ms:8.3f} ms x{count:4d}  {name[:90]}")


def eval_semantic() -> None:
    from featurematching_tpu_torch.config import tpu_optimized_config
    from featurematching_tpu_torch.models.matcher import Matcher
    from featurematching_tpu_torch.ops.coarse_transformer_train import coarse_layer_forward
    from featurematching_tpu_torch.ops.fine_stage import fine_layer_forward
    from featurematching_tpu_torch.ops.swin_block_train import swin_block_train_fwd
    from featurematching_tpu_torch.ops.window_attention import window_attention

    cfg = training_config(fused_block="off").model
    cfg = dataclasses.replace(cfg, match_coarse=dataclasses.replace(cfg.match_coarse, thr=1e-8))
    model = Matcher(cfg, device="cuda", seed=0)
    gi = torch.Generator(device="cuda").manual_seed(2)
    img = torch.rand(B, H, W, 3, generator=gi, device="cuda")
    with torch.no_grad():
        out = model(img, img)
    m = out.coarse.mask
    diag = float((out.coarse.i_ids == out.coarse.j_ids)[m].float().mean())
    print(f"  identical images: {int(m.sum())} matches, {diag:.4f} on the diagonal")
    if int(m.sum()) == 0 or diag < 0.95:
        raise AssertionError("identical images do not match on the diagonal")
    # the card's forward (K11) against the CPU's (the per-op attention), same weights
    cpu = Matcher(cfg, device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    a = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(3))
    b = torch.roll(a, shifts=8, dims=2)
    with torch.no_grad():
        got, ref = model(a.cuda(), b.cuda()), cpu(a, b)
    rel = float((got.feat_c0.float().cpu() - ref.feat_c0.float()).abs().max()
                / ref.feat_c0.float().abs().max())
    print(f"  128x128 card vs CPU (bf16 both): feat_c0 max err / max |ref| = {rel:.4f}")
    if not rel < 0.05:
        raise AssertionError("the card's evaluation forward disagrees with the CPU's")
    gc, rc = got.coarse, ref.coarse
    both = (gc.mask.cpu() & rc.mask & (gc.i_ids.cpu() == rc.i_ids) & (gc.j_ids.cpu() == rc.j_ids))
    px = float((got.fine.mkpts0_f.cpu()[both][:, :2] - ref.fine.mkpts0_f[both][:, :2])
               .abs().max()) if both.any() else float("nan")
    print(f"  128x128 mkpts0_f over the {int(both.sum())} matches both find (of "
          f"{int(rc.mask.sum())} on the CPU): max err {px:.4f} px")
    if not (both.any() and px <= 0.5):  # as the serving check: a window spans +-6 px
        raise AssertionError("the card's fine keypoints disagree with the CPU's")
    # tpu_optimized_config(): the per-op block at Swin head dim 64 runs K11
    # there; with no gradient to take, the coarse and fine stacks run K9's and
    # K10's forwards (K5's kernels, 12 calls; K6's, one launch a layer)
    tc = tpu_optimized_config().model
    tc = dataclasses.replace(tc, swin=dataclasses.replace(tc.swin, fused_block="off"))
    model = Matcher(tc, device="cuda", seed=0)
    eager = []
    hooks = [layer.register_forward_hook(lambda *_: eager.append(1))
             for tf in (model.coarse_transformer, model.fine_transformer)
             for layer in tf.children()]
    counters = (window_attention, swin_block_train_fwd, coarse_layer_forward, fine_layer_forward)
    for c in counters:
        c.launches = 0
    with torch.no_grad():
        out = model(img, torch.roll(img, shifts=16, dims=2))
    torch.cuda.synchronize()
    for hk in hooks:
        hk.remove()
    got = tuple(c.launches for c in counters)
    finite = all(torch.isfinite(t.float()).all() for t in (
        out.feat_c0, out.feat_c1, out.fine.mkpts0_f, out.fine.mkpts1_f))
    print(f"  tpu_optimized_config() (Swin heads {tc.swin.num_heads}, head dim "
          f"{tc.swin.embed_dim // tc.swin.num_heads[0]}): window_attention {got[0]} launches, "
          f"swin_block_train_fwd {got[1]}, coarse_layer_forward {got[2]}, fine_layer_forward "
          f"{got[3]}, eager coarse or fine EncoderLayer calls {len(eager)}, outputs finite: "
          f"{finite}")
    if got != (13, 0, 12, 2) or eager or not finite:
        raise AssertionError("tpu_optimized_config()'s evaluation forward did not run K11, "
                             "K5 and K6 alone")


def training_per_op(wrappers) -> None:
    import numpy as np

    from featurematching_tpu_torch.data.synthetic import synthetic_batch
    from featurematching_tpu_torch.train.step import create_train_state, train_step

    cfg = training_config(fused_block="off")
    state = create_train_state(cfg, device="cuda", seed=0)
    batch = synthetic_batch(np.random.default_rng(0), batch_size=B, image_size=(H, W),
                            num_gt=cfg.model.match_coarse.max_gt_matches)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    for w in wrappers.values():
        w.launches = 0
    t = time.perf_counter()
    for _ in range(2):
        state, met = train_step(state, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    got = {n: w.launches for n, w in wrappers.items()}
    print(f"  launches over 2 steps: {got}")
    vals = {k: float(v) for k, v in met.items()}
    print(f"  last step: {vals}; {dt / 2 * 1e3:.3f} ms a step over the first two")
    for n in ("swin_block_train_fwd", "swin_block_train_bwd", "window_attention",
              "swin_block_fused"):
        if got[n]:
            raise AssertionError(f"{n} launched {got[n]} times in the per-op block's step")
    if not all(map(np.isfinite, vals.values())):
        raise AssertionError("non-finite loss or gradient norm")
    for name, p in state.model.named_parameters():
        if not torch.isfinite(p).all():
            raise AssertionError(f"non-finite parameter {name}")


def training_config(drop_path_rate=None, fused_block=None, coarse_fused=None, fine_fused=None,
                    tpu=False, loss=None):
    """default_config() (or, with `tpu`, tpu_optimized_config(): head dim 64
    throughout) as users run it, optionally with another drop-path rate,
    block switch, coarse.fused_train or fine.fused_train (K9 and K10:
    'auto' by default, the kernels on the card), or other loss fields
    (`loss`, a dict: DENSE for the dense supervision)."""
    from featurematching_tpu_torch.config import default_config, tpu_optimized_config

    cfg = tpu_optimized_config() if tpu else default_config()
    m = cfg.model
    swin, coarse, fine = m.swin, m.coarse, m.fine
    if drop_path_rate is not None:
        swin = dataclasses.replace(swin, drop_path_rate=drop_path_rate)
    if fused_block is not None:
        swin = dataclasses.replace(swin, fused_block=fused_block)
    if coarse_fused is not None:
        coarse = dataclasses.replace(coarse, fused_train=coarse_fused)
    if fine_fused is not None:
        fine = dataclasses.replace(fine, fused_train=fine_fused)
    model = dataclasses.replace(m, swin=swin, coarse=coarse, fine=fine,
                                loss=dataclasses.replace(m.loss, **(loss or {})))
    return dataclasses.replace(cfg, model=model)


def profile_ms(fn):
    """(device ms of the kernels fn() launches, [(ms, launches, name)]) from
    the profiler, fn run once inside."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if is_kernel(e)]
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key) for e in kern), reverse=True)
    return sum(r[0] for r in rows), rows


def training_step(wrappers, launches, tpu=False, loss=None, expected=EXPECTED_PER_STEP) -> dict:
    """The training step at default_config() (or, with `tpu`,
    tpu_optimized_config(); with `loss`, those loss fields), 640x480, batch
    4, bf16, every switch 'auto', with the launches `expected` a step.
    Returns its profiler readings."""
    import numpy as np

    from featurematching_tpu_torch.data.synthetic import synthetic_batch
    from featurematching_tpu_torch.train.step import (
        create_train_state,
        forward_with_loss,
        train_step,
    )

    cfg = training_config(tpu=tpu, loss=loss)
    state = create_train_state(cfg, device="cuda", seed=0)
    t = time.time()
    batch = synthetic_batch(np.random.default_rng(0), batch_size=B, image_size=(H, W),
                            num_gt=cfg.model.match_coarse.max_gt_matches)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    print(f"  batch: {B} pairs {W}x{H}, {int(batch['gt_mask'].sum())} GT pairs "
          f"({time.time() - t:.1f} s to make)")
    torch.cuda.reset_peak_memory_stats()
    state, met = train_step(state, batch)  # warm-up
    torch.cuda.synchronize()
    eager = []  # calls of the per-op EncoderLayers: K9 and K10 run the stacks
    hooks = [layer.register_forward_hook(lambda *_: eager.append(1))
             for tf in (state.model.coarse_transformer, state.model.fine_transformer)
             for layer in tf.children()]
    for w in wrappers.values():
        w.launches = 0
    t = time.perf_counter()
    for _ in range(N_STEPS):
        state, met = train_step(state, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches.update({n: w.launches for n, w in wrappers.items()})
    for hk in hooks:
        hk.remove()
    print(f"  launches over {N_STEPS} steps: {launches}; eager coarse or fine EncoderLayer "
          f"calls: {len(eager)}")
    for n, per in expected.items():
        if launches[n] != per * N_STEPS:
            raise AssertionError(f"{n}: {launches[n]} launches, expected {per * N_STEPS}")
    if eager:
        raise AssertionError(f"{len(eager)} eager coarse or fine EncoderLayer calls in the step")
    vals = {k: float(v) for k, v in met.items()}
    print(f"  last step: {vals}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(map(np.isfinite, vals.values())):
        raise AssertionError("non-finite loss or gradient norm")
    for name, p in state.model.named_parameters():
        if not torch.isfinite(p).all():
            raise AssertionError(f"non-finite parameter {name}")
    step_ms = dt / N_STEPS * 1e3
    print(f"  training step: {step_ms:.3f} ms, {B * N_STEPS / dt:.3f} training pairs/s "
          f"(batch {B}, {W}x{H}, bf16)", flush=True)
    model = state.model
    fwd_ms, _ = profile_ms(lambda: forward_with_loss(model, cfg, batch, train=True))
    losses, _ = forward_with_loss(model, cfg, batch, train=True)
    bwd_ms, _ = profile_ms(lambda: losses.loss.backward())
    opt_ms, _ = profile_ms(state.optimizer.step)
    busy, rows = profile_ms(lambda: train_step(state, batch))
    print(f"  stages (device ms of their kernels, each run alone): forward {fwd_ms:.3f}, "
          f"backward {bwd_ms:.3f}, optimizer {opt_ms:.3f}; the step: {busy:.3f} ms busy = "
          f"{busy / step_ms:.3f} of the {step_ms:.3f} ms step")
    print(f"  profiler: {len(rows)} kernel names, {sum(r[1] for r in rows)} launches a step")
    for ms, count, name in rows[:15]:
        print(f"    {ms:8.3f} ms x{count:4d}  {name[:90]}")
    return {"device_ms": busy, "busy": busy / step_ms, "step_ms": step_ms, "forward_ms": fwd_ms,
            "backward_ms": bwd_ms, "launches": sum(r[1] for r in rows),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


# The card's training step against the plain path on the CPU (both bf16,
# 128x128, batch 2, drop-path 0, the same weights and batch; K9 and K10 on
# the card, their plain twins on the CPU), and each K8, K9 and K10 call of
# that step against the plain twin on the card: limits on the readings of
# `training_agreement`, set from a sound run's readings and from runs with a
# fault injected into K8's, K9's, K10's or K7's output
# (tests/test_torch_cuda.py::test_training_agreement_sees_kernel_faults;
# both readings in PERF.md)
LIMITS = {
    "loss": 5e-3,  # relative difference of the loss
    # every leaf of the gradient: cosine at least this. The eager bf16 coarse
    # and fine transformers round at other points on the two sides, and their
    # weight gradients are sums that mostly cancel, so this cannot be tight
    "min_cos": 0.95,
    # the coarse loss's gradient at the coarse features, card against CPU:
    # 1 - cosine and |norm ratio - 1|
    "feat_sin": 3e-3, "feat_norm": 1e-2,
    # K8: each call of the step run again from its inputs and upstream
    # gradient, kernel against plain twin on the card, over out, dx and the
    # 13 gradients; K7: the step's call, its softmax terms df0 and df1 against
    # the plain version on the same inputs. 1 - cosine and |norm ratio - 1|
    "k8_sin": 5e-3, "k8_norm": 1e-2, "k7_sin": 1e-4, "k7_norm": 1e-3,
    # K9: each call of the step run again from its inputs and upstream
    # gradient, kernel against plain twin on the card, over dx, dsrc and the
    # 10 gradients; 1 - cosine and |norm ratio - 1|
    "k9_sin": 1e-3, "k9_norm": 5e-3,
    # K10: likewise over dx, dsrc and the 10 gradients of each call
    "k10_sin": 1e-3, "k10_norm": 5e-3,
}


class _Recorder:
    """Calls fn and keeps each call's arguments and result; its `launches`
    is fn's, so a wrapper that counts on the name it is called by still
    counts."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args):
        out = self.fn(*args)
        self.calls.append((args, out))
        return out

    launches = property(lambda self: self.fn.launches,
                        lambda self, v: setattr(self.fn, "launches", v))


def semantic_setup(tpu=False, loss=None):
    """(cfg, card state, CPU state with the card's weights, batch) of the
    training semantic check, at default_config() or, with `tpu`,
    tpu_optimized_config(); with `loss`, those loss fields."""
    import numpy as np

    from featurematching_tpu_torch.data.synthetic import synthetic_batch
    from featurematching_tpu_torch.train.step import create_train_state

    cfg = training_config(drop_path_rate=0.0, fused_block="on", coarse_fused="on", fine_fused="on",
                          tpu=tpu, loss=loss)
    card = create_train_state(cfg, device="cuda", seed=0, global_batch_size=2)
    cpu = create_train_state(cfg, device="cpu", seed=0, global_batch_size=2)
    cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    batch = synthetic_batch(np.random.default_rng(1), batch_size=2, image_size=(128, 128),
                            num_gt=128)
    return cfg, card, cpu, batch


def _cos_norm(a: torch.Tensor, b: torch.Tensor):
    """(1 - cosine, |norm(a) / norm(b) - 1|) of two gradients."""
    a, b = a.detach().float().flatten(), b.detach().float().flatten().to(a.device)
    na, nb = a.norm(), b.norm().clamp_min(1e-30)
    return float(1 - a @ b / (na * nb).clamp_min(1e-30)), float((na / nb - 1).abs())


def _block_grads(fn, x, mask, s1, s2, params, h, g) -> dict:
    """out, dx and the 13 parameter gradients of fn (swin_block_train or its
    plain twin) under autograd, with upstream gradient g."""
    xx = x.detach().requires_grad_(True)
    pp = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    out = fn(xx, mask, s1, s2, pp, h)
    out.backward(g)
    return {"out": out.detach(), "dx": xx.grad} | {k: pp[k].grad for k in pp}


def training_agreement(cfg, card, cpu, batch) -> dict:
    """One forward and backward on the card and on the CPU, recording the
    card's K8, K9, K10 and K7 calls: the readings that LIMITS bound, with
    where the worst of each is. Under dense supervision the step calls no
    K7 (`dense`: its readings are absent, and a K7 call raises)."""
    import featurematching_tpu_torch.models.backbone_swin as bs
    import featurematching_tpu_torch.ops.coarse_transformer_train as ctt
    import featurematching_tpu_torch.ops.fine_transformer_train as ftt
    import featurematching_tpu_torch.ops.sparse_focal_loss as sfl
    from featurematching_tpu_torch.ops.swin_block_train import (
        swin_block_train,
        swin_block_train_reference,
    )
    from featurematching_tpu_torch.train.step import forward_with_loss

    k8, k7 = _Recorder(swin_block_train), _Recorder(sfl.sparse_focal_backward)
    k9 = _Recorder(ctt.coarse_layer_backward)
    k10 = _Recorder(ftt.fine_layer_backward)
    got = {}
    for side, st in (("card", card), ("cpu", cpu)):
        st.model.zero_grad(set_to_none=True)
        if side == "card":
            bs.swin_block_train, sfl.sparse_focal_backward = k8, k7
            ctt.coarse_layer_backward, ftt.fine_layer_backward = k9, k10
        try:
            losses, out = forward_with_loss(st.model, cfg, batch, train=True)
            for _, y in k8.calls:
                y.retain_grad()  # the upstream gradient of each K8 call
            feats = torch.autograd.grad(losses.loss_c, [out.feat_c0, out.feat_c1],
                                        retain_graph=True)
            losses.loss.backward()
        finally:
            bs.swin_block_train, sfl.sparse_focal_backward = k8.fn, k7.fn
            ctt.coarse_layer_backward, ftt.fine_layer_backward = k9.fn, k10.fn
        got[side] = (float(losses.loss.detach()),
                     {n: p.grad for n, p in st.model.named_parameters()}, feats)
    (gl, g_all, g_f), (rl, r_all, r_f) = got["card"], got["cpu"]
    r = {"loss": abs(gl - rl) / abs(rl), "card_loss": gl, "cpu_loss": rl}
    cos = {n: 1 - _cos_norm(g_all[n], r_all[n])[0] for n in g_all}
    r["min_cos"] = min(cos.values())
    r["min_cos_at"] = min(cos, key=cos.get)
    r["leaves"] = len(cos)
    lc = cfg.model.loss
    r["dense"] = not (lc.sparse_spvs and lc.coarse_type == "focal")
    if r["dense"] and k7.calls:
        raise AssertionError("the dense step called K7")
    pairs = {"feat": [(n, a, b) for n, a, b in zip(("feat_c0", "feat_c1"), g_f, r_f)], "k8": [],
             "k9": [], "k10": []} | ({} if r["dense"] else {"k7": []})
    for i, ((x, mask, s1, s2, p, h), y) in enumerate(k8.calls):
        args = (x.detach(), mask, s1, s2, {k: v.detach() for k, v in p.items()}, h, y.grad)
        kern = _block_grads(swin_block_train, *args)
        plain = _block_grads(swin_block_train_reference, *args)
        at = f"call {i} (C={x.shape[-1]}, {x.shape[0]} windows)"
        pairs["k8"] += [(f"{at} {n}", kern[n], plain[n]) for n in kern]
    for i, ((x, src, kv, ks, gk, lv, lt, h), got_k9) in enumerate(k9.calls):
        kern = k9_tensors(None, got_k9)
        plain = k9_tensors(None, ctt.coarse_layer_backward_reference(x, src, kv, ks, gk, lv, h))
        at = f"call {i} ({'self' if src is x else 'cross'}, G={x.shape[0]})"
        pairs["k9"] += [(f"{at} {n}", kern[n], plain[n]) for n in kern]
    for i, ((x, src, gk, lv, h), got_k10) in enumerate(k10.calls):
        kern = k9_tensors(None, got_k10)
        plain = k9_tensors(None, ftt.fine_layer_backward_reference(x, src, gk, lv, h))
        at = f"call {i} ({'self' if src is x else 'cross'}, G={x.shape[0]})"
        pairs["k10"] += [(f"{at} {n}", kern[n], plain[n]) for n in kern]
    for args, got_k7 in k7.calls:  # the coarse loss's backward: twice, same inputs
        ref = sfl.sparse_focal_backward_reference(*args)
        pairs["k7"] += [(n, a, b) for n, a, b in zip(("df0", "df1"), got_k7, ref)]
    for key, items in pairs.items():
        vals = {n: _cos_norm(a, b) for n, a, b in items}
        for i, what in enumerate(("sin", "norm")):
            at = max(vals, key=lambda n: vals[n][i])
            r[f"{key}_{what}"], r[f"{key}_{what}_at"] = vals[at][i], at
    r["k8_calls"], r["k9_calls"], r["k7_calls"] = len(k8.calls), len(k9.calls), len(k7.calls)
    r["k10_calls"] = len(k10.calls)
    return r


def agreement_failures(r: dict) -> list:
    """The readings of `training_agreement` outside LIMITS (K7's only where
    the step is sparse)."""
    keys = [k for k in LIMITS if not (r["dense"] and k.startswith("k7_"))]
    bad = [k for k in keys if k != "min_cos" and not r[k] <= LIMITS[k]]
    return bad + ([] if r["min_cos"] >= LIMITS["min_cos"] else ["min_cos"])


def print_agreement(r: dict) -> None:
    """The readings of `training_agreement`; raises where one is outside
    LIMITS."""
    print(f"  limits: {LIMITS}")
    print(f"  128x128 card vs CPU plain (bf16 both): loss {r['card_loss']:.6f} vs "
          f"{r['cpu_loss']:.6f} (rel {r['loss']:.3e}); gradient cosine min {r['min_cos']:.5f} "
          f"over {r['leaves']} leaves (at {r['min_cos_at']})")
    for key, what in (("feat", "coarse-loss gradient at the coarse features, card vs CPU"),
                      ("k8", f"the step's {r['k8_calls']} K8 calls vs the plain twin on the card"),
                      ("k9", f"the step's {r['k9_calls']} K9 calls vs the plain twin on the card"),
                      ("k10", f"the step's {r['k10_calls']} K10 calls vs the plain twin on the "
                       "card"),
                      ("k7", f"the step's {r['k7_calls']} K7 calls vs the plain version")):
        if key + "_sin" not in r:  # K7 in a dense step
            continue
        print(f"  {what}: 1 - cosine max {r[key + '_sin']:.3e} (at {r[key + '_sin_at']}), "
              f"|norm ratio - 1| max {r[key + '_norm']:.3e} (at {r[key + '_norm_at']})")
    bad = agreement_failures(r)
    if bad:
        raise AssertionError(f"the card's training step disagrees with the plain path: {bad}")


def training_semantic(tpu=False) -> None:
    """`training_agreement` at default_config() (then ten steps lower the
    loss, and the evaluation step's matches) or, with `tpu`, at
    tpu_optimized_config() alone."""
    from featurematching_tpu_torch.ops.dual_softmax import dual_softmax_match_stats
    from featurematching_tpu_torch.train.optimizer import build_optimizer
    from featurematching_tpu_torch.train.step import eval_step, train_step

    cfg, card, cpu, batch = semantic_setup(tpu)
    print_agreement(training_agreement(cfg, card, cpu, batch))
    if tpu:
        return
    # ten steps on one batch, warmup off, lr 1e-4 (canonical_lr 0.0032 at batch 2)
    ocfg = dataclasses.replace(cfg.trainer.optimizer, warmup_steps=0, canonical_lr=0.0032)
    card.optimizer = build_optimizer(card.model.parameters(), ocfg, 2, cfg.trainer.steps_per_epoch)
    losses = []
    for _ in range(10):
        card, met = train_step(card, batch)
        losses.append(float(met["loss"]))
    print("  ten steps at lr 1e-4: loss " + " ".join(f"{v:.4f}" for v in losses))
    if not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall over ten steps on one batch")
    # the evaluation step takes the coarse matches from K1's statistics
    before = dual_softmax_match_stats.launches
    out, ev = eval_step(card, batch)
    torch.cuda.synchronize()
    n_stats = dual_softmax_match_stats.launches - before
    print(f"  eval step: loss {float(ev.loss):.4f}, {int(out.coarse.mask.sum())} matches, "
          f"{n_stats} dual_softmax_match_stats launch")
    if n_stats != 1 or not all(torch.isfinite(t).all() for t in (
            ev.loss, out.feat_c0.float(), out.fine.mkpts0_f, out.fine.mkpts1_f)):
        raise AssertionError("the evaluation step failed")


def finite_step(cfg, batch) -> dict:
    """One forward and backward of `cfg`'s training step on a fresh seeded
    model: the loss and the gradient norm; raises where either, or any
    gradient, is not finite."""
    from featurematching_tpu_torch.train.step import create_train_state, forward_with_loss

    state = create_train_state(cfg, device="cuda", seed=0)
    losses, _ = forward_with_loss(state.model, cfg, batch, train=True)
    losses.loss.backward()
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    norm = float(torch.stack([g.float().norm() for g in grads]).norm())
    vals = {"loss": float(losses.loss.detach()), "loss_c": float(losses.loss_c.detach()),
            "grad_norm": norm}
    if not all(math.isfinite(v) for v in vals.values()):
        raise AssertionError(f"non-finite loss or gradient: {vals}")
    for g in grads:
        if not torch.isfinite(g).all():
            raise AssertionError("non-finite gradient")
    return vals


def training_dense(wrappers, launches, sparse: dict) -> None:
    """The training step under dense supervision (DENSE) as `training_step`
    runs the sparse one (EXPECTED_PER_DENSE_STEP), its device time and busy
    share beside the sparse step's (`sparse`: that phase's readings); its
    `training_agreement` card against CPU within LIMITS; and one step at
    coarse_type='cross_entropy' with a finite loss and finite gradients and
    no K1 or K7 launch."""
    import numpy as np

    from featurematching_tpu_torch.data.synthetic import synthetic_batch

    dense = training_step(wrappers, launches, loss=DENSE, expected=EXPECTED_PER_DENSE_STEP)
    keys = ("device_ms", "busy", "step_ms", "forward_ms", "backward_ms", "launches", "peak_gib")
    print("  dense against sparse (the sparse step's phase): " + ", ".join(
        f"{k} {dense[k]:.3f} vs {sparse[k]:.3f}" if k in sparse else f"{k} {dense[k]:.3f}"
        for k in keys))
    print_agreement(training_agreement(*semantic_setup(loss=DENSE)))
    cfg = training_config(loss={"coarse_type": "cross_entropy"})
    batch = synthetic_batch(np.random.default_rng(0), batch_size=B, image_size=(H, W),
                            num_gt=cfg.model.match_coarse.max_gt_matches)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    for w in wrappers.values():
        w.launches = 0
    vals = finite_step(cfg, batch)
    torch.cuda.synchronize()
    got = {n: wrappers[n].launches for n in ("dual_softmax_match_stats", "dual_softmax_lse",
                                             "sparse_focal_backward")}
    print(f"  cross_entropy: {vals}; {got}")
    if any(got.values()):
        raise AssertionError("the cross-entropy step launched K1 or K7")


def eval_dense(wrappers) -> None:
    """The evaluation Matcher at default_config() with the conf matrix
    wanted (train=False): EXPECTED_PER_DENSE_EVAL, no K1; identical images
    at thr=1e-8 match on the diagonal; `extract_matches` of the conf matrix
    equals, bit for bit, `extract_matches_from_stats` of its plain max and
    argmax on the card (and the forward's own matches); the dense
    evaluation step launches no K1 statistics."""
    import numpy as np

    from featurematching_tpu_torch.data.synthetic import synthetic_batch
    from featurematching_tpu_torch.matching.coarse import (
        extract_matches,
        extract_matches_from_stats,
    )
    from featurematching_tpu_torch.models.matcher import Matcher
    from featurematching_tpu_torch.ops.dual_softmax import MatchStats
    from featurematching_tpu_torch.train.step import create_train_state, eval_step

    cfg = training_config().model
    mc = dataclasses.replace(cfg.match_coarse, thr=1e-8)
    model = Matcher(dataclasses.replace(cfg, match_coarse=mc), device="cuda", seed=0)
    gi = torch.Generator(device="cuda").manual_seed(2)
    img = torch.rand(B, H, W, 3, generator=gi, device="cuda")
    with torch.no_grad():
        model(img, img, want_conf_matrix=True)  # warm-up
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t = time.perf_counter()
    with torch.no_grad():
        out = model(img, img, want_conf_matrix=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    got = {n: w.launches for n, w in wrappers.items()}
    print(f"  launches of one forward: {got}; {dt * 1e3:.3f} ms on the host clock")
    for n, per in EXPECTED_PER_DENSE_EVAL.items():
        if got[n] != per:
            raise AssertionError(f"{n}: {got[n]} launches, expected {per}")
    m = out.coarse.mask
    diag = float((out.coarse.i_ids == out.coarse.j_ids)[m].float().mean())
    print(f"  identical images: {int(m.sum())} matches, {diag:.4f} on the diagonal")
    if int(m.sum()) == 0 or diag < 0.95:
        raise AssertionError("identical images do not match on the diagonal")
    conf, grid = out.conf_matrix, (H // 8, W // 8)
    stats = MatchStats(conf.amax(2), conf.argmax(2).int(), conf.amax(1), conf.argmax(1).int())
    a = extract_matches(conf, grid, grid, mc.thr, mc.border_rm, mc.max_matches)
    b = extract_matches_from_stats(stats, grid, grid, mc.thr, mc.border_rm, mc.max_matches)
    fwd = (out.coarse.i_ids, out.coarse.j_ids, out.coarse.mask, out.coarse.mconf)
    same = [torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(a, b, fwd)]
    print(f"  extract_matches(conf) vs extract_matches_from_stats(plain stats) vs the forward's, "
          f"bit for bit (ids, ids, mask, mconf): {same}")
    if not all(same):
        raise AssertionError("extract_matches disagrees with the statistics' selection")
    tc = training_config(loss=DENSE)
    state = create_train_state(tc, device="cuda", seed=0)
    batch = synthetic_batch(np.random.default_rng(0), batch_size=B, image_size=(H, W),
                            num_gt=tc.model.match_coarse.max_gt_matches)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    for w in wrappers.values():
        w.launches = 0
    out, ev = eval_step(state, batch)
    torch.cuda.synchronize()
    got = {n: wrappers[n].launches for n in ("dual_softmax_match_stats", "dual_softmax_lse",
                                             "sparse_focal_backward")}
    print(f"  dense evaluation step: loss {float(ev.loss):.4f}, {int(out.coarse.mask.sum())} "
          f"matches at thr {tc.model.match_coarse.thr}; {got}")
    if any(got.values()) or out.conf_matrix is None or not all(
            torch.isfinite(t_.float()).all() for t_ in (ev.loss, out.conf_matrix,
                                                         out.fine.mkpts0_f, out.fine.mkpts1_f)):
        raise AssertionError("the dense evaluation step failed")


def coarse_only_forward(wrappers) -> None:
    """The Matcher at coarse_only (default_config() otherwise; evaluation,
    a shifted pair): no K6 or K10 launch, K1 once (with the conf matrix
    none), and the "fine" keypoints the coarse centres."""
    from featurematching_tpu_torch.models.matcher import Matcher

    cfg = dataclasses.replace(training_config().model, coarse_only=True)
    model = Matcher(cfg, device="cuda", seed=0)
    gi = torch.Generator(device="cuda").manual_seed(1)
    img0 = torch.rand(B, H, W, 3, generator=gi, device="cuda")
    img1 = torch.roll(img0, shifts=16, dims=2)
    for want, k1 in ((False, 1), (True, 0)):
        for w in wrappers.values():
            w.launches = 0
        with torch.no_grad():
            out = model(img0, img1, want_conf_matrix=want)
        torch.cuda.synchronize()
        got = {n: w.launches for n, w in wrappers.items()}
        fine = out.fine
        centres = (torch.equal(fine.mkpts0_f[..., :2], out.coarse.mkpts0_c)
                   and torch.equal(fine.mkpts1_f[..., :2], out.coarse.mkpts1_c)
                   and not fine.mkpts0_f[..., 2].any() and not fine.mkpts1_f[..., 2].any())
        print(f"  conf matrix {want}: launches {got}; {int(out.coarse.mask.sum())} matches; "
              f"fine keypoints the coarse centres: {centres}")
        fine_k = {n: got[n] for n in ("fine_stage_fused", "fine_layer_forward",
                                      "fine_layer_backward")}
        if any(fine_k.values()):
            raise AssertionError(f"the coarse-only forward launched the fine stage: {fine_k}")
        if got["dual_softmax_match_stats"] != k1 or not centres:
            raise AssertionError("the coarse-only forward's matches or keypoints are wrong")


def check_dual_softmax_f32(rec: Record, g) -> None:
    """K1's float32 kernel at the teacher's [4, 4800, 256] against its plain
    twin (K1_F32_RTOL), with a planted exact tie across column tiles (f1's
    column 4000 a copy of column 7: no row may pick 4000), twice bit for
    bit; timed by the profiler (its four kernels) beside CUDA events."""
    from featurematching_tpu_torch.ops.dual_softmax import (
        _stats_reference,
        dual_softmax_confidence,
        dual_softmax_match_stats,
    )

    Bp, L, C, T = B, (H // 8) * (W // 8), 256, 0.1
    f0 = rnd(g, Bp, L, C)
    perm = torch.randperm(L, generator=g, device="cuda")
    f1 = (0.8 * f0[:, perm] + 0.6 * rnd(g, Bp, L, C)).contiguous()
    f1[:, 4000] = f1[:, 7]
    fn = lambda: dual_softmax_match_stats(f0, f1, T)  # noqa: E731
    got = fn()
    again = fn()
    torch.cuda.synchronize()
    inv_temp = 1.0 / (C * T)
    ref = _stats_reference(f0, f1, inv_temp)
    conf = dual_softmax_confidence(f0, f1, inv_temp)
    print(f"  tolerance: max values within {K1_F32_RTOL} relative; each argmax picks a plain "
          f"conf >= (1 - {K1_F32_RTOL}) x the plain max; ties to the lower index")
    err = 0.0
    for gm, rm in ((got.row_max, ref.row_max), (got.col_max, ref.col_max)):
        e, ok = close(gm, rm, 0.0, K1_F32_RTOL)
        err = max(err, e)
        if not ok:
            raise AssertionError(f"dual_softmax float32 max values: max err {e:.3e}")
    row_pick = torch.gather(conf, 2, got.row_argmax.long()[..., None])[..., 0]
    col_pick = torch.gather(conf, 1, got.col_argmax.long()[:, None])[:, 0]
    if not ((row_pick >= ref.row_max * (1 - K1_F32_RTOL)).all()
            and (col_pick >= ref.col_max * (1 - K1_F32_RTOL)).all()):
        raise AssertionError("dual_softmax float32 argmax picks a non-maximal entry")
    tied = int((ref.row_argmax == 7).sum())
    same = float((got.row_argmax == ref.row_argmax).float().mean())
    same_c = float((got.col_argmax == ref.col_argmax).float().mean())
    bits = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"  argmax equal to plain: rows {same:.6f}, cols {same_c:.6f}; rows on the planted "
          f"tie {tied}, picking column 4000: {int((got.row_argmax == 4000).sum())}; "
          f"bit-identical twice {bits}")
    if (got.row_argmax == 4000).any() or not bits:
        raise AssertionError("dual_softmax float32: a tie went to the higher index, or two "
                             "runs differ")
    del conf
    rec.site("dual_softmax_match_stats@f32", 1, device_ms(fn),
             cuda_ms(lambda: _stats_reference(f0, f1, inv_temp), iters=3),
             dual_softmax_f32_work(Bp, L, L, C), err=err, event_ms=cuda_ms(fn, iters=5))


def check_coarse_f32(rec: Record, g) -> None:
    """K5's float32 kernels through K9's forward (`coarse_layer_forward`) at
    the teacher's calls, (256, 32) over 4800 tokens: a self call of G = 8
    (4 a forward) and a cross call of G = 4 (8 a forward), against the plain
    twin (out, kv and ks within K5_F32_ATOL + K5_F32_RTOL |plain|; kv each
    head's K^T V row-major, the twin's unpacked), twice bit for bit; each
    kernel's time by the profiler and the call's bound."""
    from featurematching_tpu_torch.ops.coarse_transformer import (
        encoder_reference_with_stats,
        layer_values,
        unpack_heads,
    )
    from featurematching_tpu_torch.ops.coarse_transformer_train import coarse_layer_forward

    N, C, h = (H // 8) * (W // 8), 256, 8

    def w(i, o):
        return rnd(g, i, o, scale=i**-0.5)

    def ln():
        return rnd(g, C, scale=0.1, shift=1.0), rnd(g, C, scale=0.1)

    print(f"  tolerance per entry of out, kv, ks: {K5_F32_ATOL} + {K5_F32_RTOL} |plain|")
    for G, kind, count in ((2 * B, "self", 4), (B, "cross", 8)):
        lv = layer_values(w(C, C), w(C, 2 * C), w(C, C), *ln(), w(2 * C, 2 * C), w(2 * C, C),
                          *ln())
        x = rnd(g, G, N, C)
        src = x if kind == "self" else rnd(g, G, N, C)
        fn = lambda: coarse_layer_forward(x, src, lv, h)  # noqa: E731
        got, again = fn(), fn()
        torch.cuda.synchronize()
        out, kv, ks = encoder_reference_with_stats(x, src, lv, h)
        ref = out, unpack_heads(kv, h).reshape(G, -1), ks
        err = 0.0
        for name, a, r in zip(("out", "kv", "ks"), got, ref):
            e, ok = close(a, r, K5_F32_ATOL, K5_F32_RTOL)
            if name == "out":
                err = e
            print(f"  {kind} call (G={G}) {name}: max err {e:.3e} (max |plain| "
                  f"{float(r.abs().max()):.3e})")
            if not ok:
                raise AssertionError(f"coarse layer float32 ({kind}) {name}: max err {e:.3e}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"coarse layer float32 ({kind}): two runs differ")
        times = kernel_times(fn, dict.fromkeys(("stats_kernel", "merge_kernel",
                                                "apply_kernel"), 1))
        ms = sum(t[0] for t in times)
        parts = ", ".join(f"{k} {sum(t[0] for t in times if k in t[2]):.4f}"
                          for k in ("stats_kernel", "merge_kernel", "apply_kernel"))
        work = coarse_layer_f32_work(G, N, N, C, h, kind == "self")
        b, by = bound_ms(*work, FP32_FLOPS)
        print(f"  {kind} call (G={G}): {ms:.4f} ms by the profiler ({parts}) against its bound "
              f"{b:.4f} ms ({by}), x{count} a forward", flush=True)
        rec.site("coarse_layer_forward@f32", count, ms,
                 cuda_ms(lambda: encoder_reference_with_stats(x, src, lv, h), iters=3), work,
                 err=err, event_ms=cuda_ms(fn, iters=5))


def seed_batch_norm(model, seed: int) -> None:
    """Seeded random BatchNorm statistics (mean ~ N(0, 0.1), var in [0.5,
    2]) in every BatchNorm of `model`, on its device."""
    gb = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gb, device=model.device))
                m.running_var.copy_(0.5 + 1.5 * torch.rand(n, generator=gb, device=model.device))


def gray_pair(seed: int, n: int):
    """n grayscale [H, W, 1] images of smooth noise on the card, and the same
    shifted 16 px."""
    gi = torch.Generator(device="cuda").manual_seed(seed)
    coarse = torch.rand(n, 1, H // 4, W // 4, generator=gi, device="cuda")
    img0 = torch.nn.functional.interpolate(coarse, size=(H, W), mode="bilinear",
                                           align_corners=False).permute(0, 2, 3, 1).contiguous()
    return img0, torch.roll(img0, shifts=16, dims=2)


def teacher_agreement(card, cpu, mc, grid) -> None:
    """One pair's coarse-only outputs, card against CPU (float32 both), at
    the match config `mc` on the coarse grid `grid`: TEACHER_FEAT_RTOL,
    TEACHER_TIE and TEACHER_MCONF_RTOL."""
    from featurematching_tpu_torch.matching.coarse import border_mask_flat
    from featurematching_tpu_torch.ops.dual_softmax import dual_softmax_confidence

    rel = max(float((a[:1].float().cpu() - r.float()).abs().max() / r.float().abs().max())
              for a, r in ((card.feat_c0, cpu.feat_c0), (card.feat_c1, cpu.feat_c1)))
    gc, rc = card.coarse, cpu.coarse

    def pairs(c, b):
        m = c.mask[b].cpu()
        return dict(zip(zip(c.i_ids[b].cpu()[m].tolist(), c.j_ids[b].cpu()[m].tolist()),
                        c.mconf[b].cpu()[m].tolist()))

    got, ref = pairs(gc, 0), pairs(rc, 0)
    C, K, thr = cpu.feat_c0.shape[-1], mc.max_matches, mc.thr
    conf = dual_softmax_confidence(cpu.feat_c0, cpu.feat_c1, 1.0 / (C * mc.dsmax_temperature))[0]
    rmax, cmax = conf.amax(1), conf.amax(0)
    # the CPU's candidates: mutual maxima above thr off the border, as `_select` takes them
    jstar = conf.argmax(1)
    ok = border_mask_flat(*grid, mc.border_rm)
    valid = ((conf.argmax(0)[jstar] == torch.arange(len(jstar))) & (rmax > thr) & ok
             & ok[jstar])
    candidates = rmax[valid]
    cpu_only = len(set(ref) - set(got))
    lo = 1 - TEACHER_TIE

    def cutoff(side):  # the top-K's last confidence where the list is full
        return min(side.values()) if len(side) == K else 0.0

    def runner_up(v):
        return float(v.topk(2).values[1])

    def near_tie(i, j, cpu_found):
        """Whether (i, j), found on one side only, is within TEACHER_TIE of
        going the other way on the CPU's conf. Where the CPU found it: a
        runner-up in its row or column, the threshold, or the card's top-K
        cutoff. Where the card did: a near mutual maximum above the
        threshold, and fewer of the CPU's candidates clearly above it than
        the top-K holds plus the matches the card lacks (each a near-tie that
        frees a slot)."""
        c = float(conf[i, j])
        if cpu_found:
            return (runner_up(conf[i]) >= lo * float(rmax[i])
                    or runner_up(conf[:, j]) >= lo * float(cmax[j])
                    or lo * c <= max(thr, cutoff(got)))
        return (c >= lo * max(float(rmax[i]), float(cmax[j]), thr)
                and int((candidates > c / lo).sum()) < K + cpu_only)

    diff = set(got) ^ set(ref)
    far = [m for m in diff if not near_tie(*m, m in ref)]
    both = set(got) & set(ref)
    mrel = max((abs(got[m] - ref[m]) / ref[m] for m in both), default=0.0)
    print(f"  pair 0 card vs CPU (float32 both): feat max err / max |ref| {rel:.3e}; matches "
          f"card {len(got)}, CPU {len(ref)}, both {len(both)}, on one side only {len(diff)} "
          f"(near-ties within {TEACHER_TIE}: {len(diff) - len(far)}); mconf max rel err "
          f"{mrel:.3e}")
    for i, j in far[:5]:
        print(f"    not a near-tie: ({i}, {j}) found by the {'CPU' if (i, j) in ref else 'card'} "
              f"only: CPU conf {float(conf[i, j]):.6e}, its row max {float(rmax[i]):.6e} "
              f"(runner-up {runner_up(conf[i]):.6e}), column max {float(cmax[j]):.6e} "
              f"(runner-up {runner_up(conf[:, j]):.6e}); top-K cutoff card "
              f"{cutoff(got):.6e}, CPU {cutoff(ref):.6e}; CPU candidates above it "
              f"{int((candidates > float(conf[i, j]) / lo).sum())} of {len(candidates)}; "
              f"mconf card {got.get((i, j))}, CPU {ref.get((i, j))}")
    if rel > TEACHER_FEAT_RTOL or far or mrel > TEACHER_MCONF_RTOL or not both:
        raise AssertionError(f"the teacher's card forward disagrees with the CPU's: "
                             f"{far[:5]} not near-ties")


def teacher_forward(wrappers, launches) -> None:
    """The LoFTR-tiny teacher (`loftr_tiny_config()`: coarse-only ResNet-FPN,
    the sine encoding, 8 coarse layers at (256, 8), float32) on seeded
    weights with seeded random BN statistics, 640x480 grayscale, batch 4:
    N_TEACHER forwards with the counters set to 0 just before and read just
    after (EXPECTED_PER_TEACHER, every other wrapper 0, no eager coarse
    layer); device time, busy share, launches, peak memory and the stages;
    then at thr 1e-8 the card against the CPU on one shifted pair
    (`teacher_agreement`), the same with the backbone's convolutions in
    TF32 (a planted fault the check must catch), and identical images on
    the diagonal."""
    from featurematching_tpu_torch.config import loftr_tiny_config
    from featurematching_tpu_torch.models.matcher import Matcher

    cfg = loftr_tiny_config().model
    model = Matcher(cfg, device="cuda", seed=0)
    seed_batch_norm(model, 5)
    img0, img1 = gray_pair(4, B)
    with torch.no_grad():
        model(img0, img1)  # warm-up
    torch.cuda.synchronize()
    eager = []
    hooks = [layer.register_forward_hook(lambda *_: eager.append(1))
             for layer in model.coarse_transformer.children()]
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with torch.no_grad():
        for _ in range(N_TEACHER):
            out = model(img0, img1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches.update({n: w.launches for n, w in wrappers.items()})
    for hk in hooks:
        hk.remove()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  launches over {N_TEACHER} forwards: {launches}; eager coarse EncoderLayer calls: "
          f"{len(eager)}")
    for n, per in EXPECTED_PER_TEACHER.items():
        if launches[n] != per * N_TEACHER:
            raise AssertionError(f"{n}: {launches[n]} launches, expected {per * N_TEACHER}")
    if eager:
        raise AssertionError(f"{len(eager)} eager coarse EncoderLayer calls")
    if out.feat_c0.shape != (B, (H // 8) * (W // 8), 256) or out.feat_c0.dtype != torch.float32:
        raise AssertionError("unexpected output shapes or dtype")
    for t_ in (out.feat_c0, out.feat_c1, out.coarse.mconf):
        if not torch.isfinite(t_).all():
            raise AssertionError("non-finite output")
    fwd_ms = dt / N_TEACHER * 1e3
    print(f"  forward: {fwd_ms:.3f} ms on the host clock, {B / dt * N_TEACHER:.3f} pairs/s "
          f"(batch {B}, {W}x{H} grayscale, float32, {int(out.coarse.mask.sum())} matches at "
          f"thr {cfg.match_coarse.thr}); peak memory {peak_gib:.3f} GiB", flush=True)
    imgs = torch.cat([img0, img1])
    hc, wc = H // 8, W // 8
    with torch.no_grad():
        fc, _ = model.backbone(imgs, fine=False)
        fc = fc + model.positional_encoding(hc, wc, 256)
        f0, f1 = fc[:B].reshape(B, hc * wc, -1), fc[B:].reshape(B, hc * wc, -1)
        c0, c1 = model.coarse_transformer(f0, f1)
        # the stages by CUDA events: a profile that opens on K1's kernels
        # drops them (the profiler loses its first events)
        stages = {
            "backbone (cuDNN)": lambda: model.backbone(imgs, fine=False),
            "coarse transformer (K9's forward)": lambda: model.coarse_transformer(f0, f1),
            "coarse matching (K1)": lambda: model.coarse_matching(c0, c1, (hc, wc)),
        }
        layers = {k: cuda_ms(fn, iters=5) for k, fn in stages.items()}
        rows = kernel_times(lambda: model(img0, img1))
    busy = sum(r[0] for r in rows)
    print(f"  device: {busy:.3f} ms busy = {busy / fwd_ms:.3f} of the {fwd_ms:.3f} ms forward; "
          f"{len(rows)} kernel names, {sum(r[1] for r in rows)} launches; stages (CUDA events, "
          f"ms): " + ", ".join(f"{k} {v:.3f}" for k, v in layers.items()))
    for ms, count, name in rows[:12]:
        print(f"    {ms:8.3f} ms x{count:4d}  {name[:90]}")
    # the card against the CPU, and identical images, at thr 1e-8 (random
    # weights match nothing at 0.2)
    thr = 1e-8
    lo = dataclasses.replace(cfg, match_coarse=dataclasses.replace(cfg.match_coarse, thr=thr))
    card = Matcher(lo, device="cuda", seed=0)
    card.load_state_dict(model.state_dict())
    cpu = Matcher(lo, device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        got = card(img0, img1)
        ref = cpu(img0[:1].cpu(), img1[:1].cpu())
        same = card(img0, img0)
    teacher_agreement(got, ref, lo.match_coarse, (H // 8, W // 8))
    # a planted fault: cuDNN's convolutions in TF32 inside the backbone
    flags = torch.backends.cudnn.flags
    with mock.patch.object(torch.backends.cudnn, "flags",
                           lambda **kw: flags(**kw | {"allow_tf32": True})), torch.no_grad():
        tf32 = card(img0, img1)
    print("  with the backbone's convolutions in TF32 (a planted fault):")
    try:
        teacher_agreement(tf32, ref, lo.match_coarse, (H // 8, W // 8))
    except AssertionError:
        print("  planted fault caught")
    else:
        raise AssertionError("TF32 convolutions in the backbone passed the card-vs-CPU check")
    m = same.coarse.mask
    diag = float((same.coarse.i_ids == same.coarse.j_ids)[m].float().mean())
    print(f"  identical images: {int(m.sum())} matches, {diag:.4f} on the diagonal")
    if int(m.sum()) == 0 or diag < 0.95:
        raise AssertionError("identical images do not match on the diagonal")


def teacher_fn_call(wrappers) -> None:
    """One `make_teacher_fn(device="cuda")` call on a 480x640 uint8 pair
    (thr 1e-8): K9's forward 12 times and K1 once, keypoints finite, on the
    coarse grid and inside the image."""
    import numpy as np

    from featurematching_tpu_torch.data.teacher import make_teacher_fn

    img0, img1 = gray_pair(6, 1)
    a0 = (img0[0, ..., 0].cpu().numpy() * 255).astype(np.uint8)
    a1 = (img1[0, ..., 0].cpu().numpy() * 255).astype(np.uint8)
    fn = make_teacher_fn(thr=1e-8, device="cuda")
    for w in wrappers.values():
        w.launches = 0
    t = time.perf_counter()
    k0, k1 = fn(a0, a1)
    dt = time.perf_counter() - t
    got = {n: w.launches for n, w in wrappers.items() if w.launches}
    print(f"  {len(k0)} matches in {dt * 1e3:.1f} ms (host clock, first call); launches {got}")
    t = time.perf_counter()
    for _ in range(N_TEACHER):
        fn(a0, a1)
    dt = (time.perf_counter() - t) / N_TEACHER
    rows = kernel_times(lambda: fn(a0, a1))
    print(f"  a call after the first: {dt * 1e3:.3f} ms on the host clock (images in, "
          f"keypoints out), {sum(r[0] for r in rows):.3f} ms of device time; largest:")
    for ms, count, name in rows[:5]:
        print(f"    {ms:8.3f} ms x{count:4d}  {name[:90]}")
    if got != {"coarse_layer_forward": 12, "dual_softmax_match_stats": 1}:
        raise AssertionError(f"make_teacher_fn launched {got}")
    ok = (len(k0) > 0 and k0.shape == k1.shape and np.isfinite(k0).all()
          and not (k0 % 8).any() and (k0[:, 0] < W).all() and (k0[:, 1] < H).all())
    if not ok:
        raise AssertionError("make_teacher_fn's keypoints are wrong")


@torch.no_grad()
def breakdown(model, img0, img1, forward_ms: float) -> list:
    """Where one forward's time goes: the device time of each stage's kernels
    (profiler), each stage run alone through the path the forward takes, the
    rest being the remainder of the whole forward's; then the forward's
    largest kernels and the device's busy share of its wall time. Returns
    the forward's profile (`kernel_times` rows)."""
    hc, wc = H // 8, W // 8
    imgs = torch.cat([img0, img1]).to(model.dtype)
    feat_c, feat_f = model.backbone(imgs)
    f0, f1 = feat_c[:B].reshape(B, hc * wc, -1), feat_c[B:].reshape(B, hc * wc, -1)
    c0, c1 = model.coarse_stage(f0, f1)
    matches = model.coarse_matching(c0, c1, (hc, wc))
    stages = {
        "backbone": lambda: model.backbone(imgs),
        "coarse transformer": lambda: model.coarse_stage(f0, f1),
        "coarse matching": lambda: model.coarse_matching(c0, c1, (hc, wc)),
        "fine stage": lambda: model.fine_stage(feat_f[:B], feat_f[B:], c0, c1, matches, (hc, wc)),
    }
    layers = {k: sum(t[0] for t in kernel_times(fn)) for k, fn in stages.items()}
    kern = fullest_profile(lambda: model(img0, img1), tries=2)
    busy = sum(t[0] for t in kern)
    layers["the rest"] = busy - sum(layers.values())
    print(f"  layers (device ms of their kernels; forward {busy:.3f} busy): "
          + ", ".join(f"{k} {v:.3f}" for k, v in layers.items()))
    print(f"  profiler: {len(kern)} kernel names, {sum(t[1] for t in kern)} launches, "
          f"{busy:.3f} ms device busy = {busy / forward_ms:.3f} of the "
          f"{forward_ms:.3f} ms forward")
    for ms, count, name in kern[:15]:
        print(f"    {ms:8.3f} ms x{count:4d}  {name[:90]}")
    return kern


def serving_forward(cfg, wrappers, launches, check_cpu=False) -> list:
    """The serving forward at `cfg`, 640x480, batch 4, bf16, seeded random
    weights: N_FORWARD forwards with the launch counters set to 0 just
    before and read just after (EXPECTED_PER_FORWARD, no eager coarse or
    fine EncoderLayer), finite outputs, pairs/s and the breakdown; with
    `check_cpu`, the card against the CPU at 64x64 (`card_vs_cpu`).
    Returns one forward's profile (`kernel_times` rows)."""
    from featurematching_tpu_torch.models.fast_inference import FastMatcher

    model = FastMatcher(cfg, device="cuda", seed=0)
    s, c, f = cfg.swin, cfg.coarse, cfg.fine
    print(f"  Swin heads {s.num_heads} (head dims "
          f"{[s.embed_dim * 2**i // h for i, h in enumerate(s.num_heads)]}), coarse "
          f"{c.d_model}/{c.nhead}, fine {f.d_model}/{f.nhead}")
    gi = torch.Generator(device="cuda").manual_seed(1)
    img0 = torch.rand(B, H, W, 3, generator=gi, device="cuda")
    img1 = torch.roll(img0, shifts=16, dims=2)
    model(img0, img1)  # warm-up
    torch.cuda.synchronize()
    eager = []  # calls of the plain coarse or fine EncoderLayers: none
    hooks = [layer.register_forward_hook(lambda *_: eager.append(1))
             for tf in (model.coarse_transformer, model.fine_transformer)
             for layer in tf.children()]
    for w in wrappers.values():
        w.launches = 0
    t = time.perf_counter()
    for _ in range(N_FORWARD):
        out = model(img0, img1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches.update({n: w.launches for n, w in wrappers.items()})
    for hk in hooks:
        hk.remove()
    print(f"  launches over {N_FORWARD} forwards: {launches}; eager coarse or fine "
          f"EncoderLayer calls: {len(eager)}")
    for n in wrappers:  # the training kernels: none
        per = EXPECTED_PER_FORWARD.get(n, 0)
        if launches[n] != per * N_FORWARD:
            raise AssertionError(f"{n}: {launches[n]} launches, expected {per * N_FORWARD}")
    if eager:
        raise AssertionError(f"{len(eager)} eager coarse or fine EncoderLayer calls")
    m = out.coarse.mask
    if out.feat_c0.shape != (B, (H // 8) * (W // 8), 256) or out.fine.mkpts0_f.shape != (
            B, cfg.match_coarse.max_matches, 3):
        raise AssertionError("unexpected output shapes")
    for t_ in (out.feat_c0, out.feat_c1, out.coarse.mconf, out.fine.mkpts0_f[m],
               out.fine.mkpts1_f[m]):
        if not torch.isfinite(t_.float()).all():
            raise AssertionError("non-finite output")
    print(f"  matches per pair (thr {cfg.match_coarse.thr}): {m.sum(1).tolist()}")
    print(f"  forward: {dt / N_FORWARD * 1e3:.3f} ms, "
          f"{B * N_FORWARD / dt:.3f} pairs/s (batch {B}, {W}x{H}, bf16)", flush=True)
    kernels = breakdown(model, img0, img1, dt / N_FORWARD * 1e3)
    if check_cpu:  # at thr=1e-8, as `semantic`: random weights match nothing at 0.2
        mc = dataclasses.replace(cfg.match_coarse, thr=1e-8)
        card_vs_cpu(FastMatcher(dataclasses.replace(cfg, match_coarse=mc), device="cuda",
                                seed=0))
    return kernels


def card_vs_cpu(model) -> None:
    """The card's forward against the plain path on the CPU, 64x64, the same
    weights: feat_c0, and mkpts0_f over the matches both find (model's
    threshold low enough that some are found)."""
    from featurematching_tpu_torch.models.fast_inference import FastMatcher

    cpu = FastMatcher(model.cfg, device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    a = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(3))
    b = torch.roll(a, shifts=8, dims=2)
    got, ref = model(a.cuda(), b.cuda()), cpu(a, b)
    rel = float((got.feat_c0.float().cpu() - ref.feat_c0.float()).abs().max()
                / ref.feat_c0.float().abs().max())
    print(f"  64x64 card vs CPU plain (bf16 both): feat_c0 max err / max |ref| = {rel:.4f}")
    if not rel < 0.05:
        raise AssertionError("the card's forward disagrees with the plain path")
    gc, rc = got.coarse, ref.coarse
    both = (gc.mask.cpu() & rc.mask & (gc.i_ids.cpu() == rc.i_ids)
            & (gc.j_ids.cpu() == rc.j_ids))
    px = float((got.fine.mkpts0_f.cpu()[both][:, :2] - ref.fine.mkpts0_f[both][:, :2])
               .abs().max()) if both.any() else float("nan")
    print(f"  64x64 mkpts0_f over the {int(both.sum())} matches both find (of "
          f"{int(rc.mask.sum())} on the CPU): max err {px:.4f} px")
    # a 7x7 window at stride 2 spans +-6 px; bf16 moves a heatmap by ~1%
    if not (both.any() and px <= 0.5):
        raise AssertionError("the card's fine keypoints disagree with the plain path")


def pose_slots(batch, rng, n_in=640, noise_px=0.3):
    """A top-K-shaped match list [B, POSE_SLOTS] of a synthetic batch's GT
    correspondences: up to n_in inliers with noise_px of noise, a quarter as
    many outliers (POSE_OUTLIERS of the valid rows), the rest padding."""
    import numpy as np

    Bn = batch["gt_kp0"].shape[0]
    kp0 = np.zeros((Bn, POSE_SLOTS, 2), np.float32)
    kp1 = np.zeros((Bn, POSE_SLOTS, 2), np.float32)
    mask = np.zeros((Bn, POSE_SLOTS), bool)
    for b in range(Bn):
        g0 = batch["gt_kp0"][b][batch["gt_mask"][b]][:n_in]
        g1 = batch["gt_kp1"][b][batch["gt_mask"][b]][:n_in]
        k, n_out = len(g0), len(g0) // 4
        kp0[b, :k] = g0 + rng.normal(0, noise_px, g0.shape)
        kp1[b, :k] = g1 + rng.normal(0, noise_px, g1.shape)
        kp0[b, k:k + n_out] = rng.uniform(0, (W, H), (n_out, 2))
        kp1[b, k:k + n_out] = rng.uniform(0, (W, H), (n_out, 2))
        mask[b, :k + n_out] = True
    return kp0, kp1, mask


def rot_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """The angle between rotations [..., 3, 3], in degrees."""
    c = ((Ra.transpose(-1, -2) @ Rb).diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2
    return torch.rad2deg(torch.arccos(torch.clamp(c, -1.0, 1.0)))


def ransac_on_the_card() -> None:
    """RANSAC on the two-plane scene's GT correspondences (POSE_SLOTS slots,
    POSE_OUTLIERS outliers, padding; B = 4, POSE_HYP hypotheses, 0.5 px):
    each pair's pose against the truth, the card against the port on the CPU
    on the same noise (POSE_CARD_CPU_DEG), no host sync on the way
    (`torch.cuda.set_sync_debug_mode('error')`), its device ms and launches."""
    import numpy as np

    from featurematching_tpu_torch.data.synthetic import synthetic_batch
    from featurematching_tpu_torch.geometry.epipolar import normalize_keypoints
    from featurematching_tpu_torch.geometry.ransac import essential_ransac_core, gumbel_noise
    from featurematching_tpu_torch.geometry.se3 import relative_pose_error

    rng = np.random.default_rng(0)
    batch = synthetic_batch(rng, batch_size=B, image_size=(H, W), num_gt=1024, n_planes=2)
    kp0, kp1, mask = pose_slots(batch, rng)
    K, T = torch.tensor(batch["K0"]), torch.tensor(batch["T_0to1"])
    thr = 0.5 / (0.5 * (K[:, 0, 0] + K[:, 1, 1]))
    cpu = [normalize_keypoints(torch.tensor(kp0), K), normalize_keypoints(torch.tensor(kp1), K),
           torch.tensor(mask)]
    card = [x.cuda() for x in cpu]
    g = gumbel_noise(torch.Generator(device="cuda").manual_seed(0), (B, POSE_HYP, POSE_SLOTS))
    thr_card = thr.cuda()

    def run():
        return essential_ransac_core(*card, g, thresh=thr_card)

    run()  # warm-up: the solver's constant tables go to the card once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any host sync on the way raises
    try:
        res = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = essential_ransac_core(*cpu, g.cpu(), thresh=thr)
    T = T.cuda()
    R_err, _ = relative_pose_error(T, res.R, res.t)
    t_gt = T[:, :3, 3] / torch.linalg.norm(T[:, :3, 3], dim=-1, keepdim=True)
    cos = (res.t * t_gt).sum(-1).abs()
    vs_cpu = rot_deg(res.R.cpu(), ref.R)
    t_vs_cpu = torch.rad2deg(torch.arccos(torch.clamp((res.t.cpu() * ref.t).sum(-1).abs(), max=1)))
    print(f"  RANSAC on the card, B {B}, {POSE_SLOTS} slots ({mask.sum(1).tolist()} valid, "
          f"{POSE_OUTLIERS:.0%} of them outliers), {POSE_HYP} hypotheses: R_err "
          f"{[round(float(x), 4) for x in R_err]} deg, t cos {[round(float(x), 6) for x in cos]}, "
          f"inliers {res.num_inliers.tolist()} (CPU {ref.num_inliers.tolist()}); card vs CPU "
          f"rotation {[round(float(x), 5) for x in vs_cpu]} deg, translation "
          f"{[round(float(x), 4) for x in t_vs_cpu]} deg; no host sync")
    if not (res.valid.all() and (R_err < 1.0).all() and (cos > 0.99).all()):
        raise AssertionError("RANSAC on the card misses the two-plane scene's pose")
    if not ((vs_cpu < POSE_CARD_CPU_DEG).all() and (t_vs_cpu < POSE_CARD_CPU_T_DEG).all()):
        raise AssertionError("RANSAC on the card disagrees with the CPU on the same noise")
    rows = fullest_profile(run, tries=2)
    busy = sum(r[0] for r in rows)
    host = cuda_ms(run, iters=5, warmup=1)
    print(f"  RANSAC core: {busy:.3f} ms device busy, {sum(r[1] for r in rows)} launches, "
          f"{host:.3f} ms a call by CUDA events; largest:")
    for ms, count, name in rows[:8]:
        print(f"    {ms:8.3f} ms x{count:4d}  {name[:90]}")


def pose_evaluation(wrappers, serving_kernels: dict) -> None:
    """`apps.evaluate.evaluate_dataset` on EVAL_PAIRS two-plane 640x480 pairs,
    batch 4, through `FastMatcher` on seeded random weights (the AUCs are
    near 0 and not checked): the forward's launches a batch
    (EXPECTED_PER_FORWARD by the counters; by the profiler those of the
    serving forward built as its phase builds it, profiled beside it), the
    metric dict's keys; then one batch by its parts: every
    tensor of the chain on the card, no host sync in the chain, host ms a
    batch, device ms and launches of the forward and of the chain, the
    chain's largest kernels and the peak memory."""
    from featurematching_tpu_torch.apps.evaluate import (
        SyntheticPairs,
        batch_errors,
        build_matcher,
        evaluate_dataset,
    )
    from featurematching_tpu_torch.config import default_config
    from featurematching_tpu_torch.data.loader import BatchLoader
    from featurematching_tpu_torch.geometry.ransac import gumbel_noise
    from featurematching_tpu_torch.models.fast_inference import FastMatcher

    ransac_on_the_card()
    ds = SyntheticPairs(EVAL_PAIRS, W, H, gray=False, n_planes=2)
    for w in wrappers.values():
        w.launches = 0
    t = time.perf_counter()
    metrics = evaluate_dataset(ds, batch_size=B, device="cuda")
    dt = time.perf_counter() - t
    n_batches = EVAL_PAIRS // B
    counts = {n: w.launches for n, w in wrappers.items()}
    print(f"  evaluate_dataset: {EVAL_PAIRS} pairs in {dt * 1e3:.1f} ms (the matcher's build "
          f"included); metrics {metrics}; launches {counts}")
    for n in wrappers:
        if counts[n] != EXPECTED_PER_FORWARD.get(n, 0) * n_batches:
            raise AssertionError(f"{n}: {counts[n]} launches over {n_batches} batches")
    if set(metrics) != {"auc@5", "auc@10", "auc@20", "prec@5e-04"}:
        raise AssertionError(f"metric keys {sorted(metrics)}")

    model = build_matcher(device="cuda")
    batch = next(BatchLoader(ds, B, shuffle=False).epoch(0))
    tb = {k: torch.from_numpy(batch[k]).cuda() for k in ("image0", "image1", "T_0to1", "K0", "K1")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = model(tb["image0"], tb["image1"])
    m = out.coarse.mask
    g = gumbel_noise(gen, (B, POSE_HYP, m.shape[1]))

    def chain():
        return batch_errors(out.fine.mkpts0_f, out.fine.mkpts1_f, m, tb["T_0to1"], tb["K0"],
                            tb["K1"], g)

    epi, pose = chain()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        epi, pose = chain()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tensors = {"mkpts0_f": out.fine.mkpts0_f, "mask": m, "noise": g, "epi": epi, **pose}
    off = [k for k, v in tensors.items() if v.device.type != "cuda"]
    if off:
        raise AssertionError(f"chain tensors off the card: {off}")
    print(f"  matches a pair {m.sum(1).tolist()}; pose_valid {pose['pose_valid'].tolist()}; "
          f"every tensor of the chain on {epi.device}, no host sync in the chain")

    def step():
        o = model(tb["image0"], tb["image1"])
        return batch_errors(o.fine.mkpts0_f, o.fine.mkpts1_f, o.coarse.mask, tb["T_0to1"],
                            tb["K0"], tb["K1"], g)

    step()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    # the serving forward as its own phase builds it, profiled here beside
    # the app's: late in this process the same forward profiles a few
    # launches short of its own phase's count (on an H100 494 against 497,
    # a concatenation and two elementwise kernels fewer, cause not found)
    serving = FastMatcher(default_config().model, device="cuda", seed=0)
    ref = fullest_profile(lambda: serving(tb["image0"], tb["image1"]))
    fwd = fullest_profile(lambda: model(tb["image0"], tb["image1"]),
                          want=sum(r[1] for r in ref))
    ch = fullest_profile(chain, tries=2)
    f_ms, f_n = sum(r[0] for r in fwd), sum(r[1] for r in fwd)
    c_ms, c_n = sum(r[0] for r in ch), sum(r[1] for r in ch)
    s_n = sum(r[1] for r in ref)
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  a batch of {B} (forward + chain): host {sorted(round(x, 3) for x in times)} ms; "
          f"device busy: forward {f_ms:.3f} ms in {f_n} launches (the serving forward here "
          f"{s_n}, in its own phase {serving_kernels.get('launches')}), chain {c_ms:.3f} ms "
          f"in {c_n} launches ({POSE_HYP} hypotheses, {m.shape[1]} slots); peak memory "
          f"{peak_gib:.3f} GiB")
    here, there = {n: c for _, c, n in ref}, serving_kernels.get("rows", {})
    moved = {n[:60]: (here.get(n, 0), there.get(n, 0)) for n in set(here) | set(there)
             if there and here.get(n, 0) != there.get(n, 0)}
    if moved:
        print(f"  kernels whose launches differ from the serving phase's (here, there): {moved}")
    for ms, count, name in ch[:10]:
        print(f"    {ms:8.3f} ms x{count:4d}  {name[:90]}")
    if f_n != s_n:
        raise AssertionError(f"the evaluation forward launched {f_n} kernels, the serving "
                             f"forward {s_n}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from featurematching_tpu_torch.config import default_config, tpu_optimized_config
    from featurematching_tpu_torch.models.fast_inference import FastMatcher
    from featurematching_tpu_torch.ops import _build
    from featurematching_tpu_torch.ops.coarse_transformer import coarse_transformer_fused
    from featurematching_tpu_torch.ops.coarse_transformer_train import (
        coarse_layer_backward,
        coarse_layer_forward,
    )
    from featurematching_tpu_torch.ops.dual_softmax import dual_softmax_lse, dual_softmax_match_stats
    from featurematching_tpu_torch.ops.fine_stage import fine_layer_forward, fine_stage_fused
    from featurematching_tpu_torch.ops.fine_transformer_train import fine_layer_backward
    from featurematching_tpu_torch.ops.layer_norm import layer_norm_chain
    from featurematching_tpu_torch.ops.patch_expand import patch_expand_ln
    from featurematching_tpu_torch.ops.sparse_focal_loss import sparse_focal_backward
    from featurematching_tpu_torch.ops.swin_block import swin_block_fused
    from featurematching_tpu_torch.ops.swin_block_image import swin_block_fused_image
    from featurematching_tpu_torch.ops.swin_block_train import (
        swin_block_train_bwd,
        swin_block_train_fwd,
    )
    from featurematching_tpu_torch.ops.wgrad import wgrad
    from featurematching_tpu_torch.ops.window_attention import window_attention

    wrappers = {
        "swin_block_fused": swin_block_fused, "layer_norm_chain": layer_norm_chain,
        "patch_expand_ln": patch_expand_ln, "dual_softmax_match_stats": dual_softmax_match_stats,
        "coarse_transformer_fused": coarse_transformer_fused, "fine_stage_fused": fine_stage_fused,
        "swin_block_train_fwd": swin_block_train_fwd, "swin_block_train_bwd": swin_block_train_bwd,
        "dual_softmax_lse": dual_softmax_lse, "sparse_focal_backward": sparse_focal_backward,
        "coarse_layer_forward": coarse_layer_forward,
        "coarse_layer_backward": coarse_layer_backward,
        "fine_layer_forward": fine_layer_forward, "fine_layer_backward": fine_layer_backward,
        "window_attention": window_attention, "swin_block_fused_image": swin_block_fused_image,
        "wgrad": wgrad,
    }
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 references stay float32
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    failed = []

    def phase(name, fn):
        t = time.time()
        print(f"== {name} (on {card})", flush=True)
        try:
            fn()
            print(f"== {name}: ok ({time.time() - t:.1f} s)", flush=True)
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            sys.stderr.flush()
            print(f"== {name}: FAILED", flush=True)
            failed.append(name)

    def build():
        for name, log in _build.build(ptxas_verbose=True).items():
            entry = ""  # the kernel the next lines describe, from its mangled name
            for line in log.splitlines():
                m = re.search(r"Compiling entry function '([^']+)'", line)
                if m:
                    k = re.search(r"([A-Za-z_]+_kernel)((?:I(?:L[ib]\d+E)+)?)", m.group(1))
                    args = re.findall(r"L[ib](\d+)E", k.group(2)) if k else []
                    entry = (k.group(1) + (f"<{', '.join(args)}>" if args else "")) if k else ""
                elif "registers" in line or "spill" in line or "error" in line:
                    print(f"  {name}: {entry + ': ' if entry else ''}{line.strip()}")

    rec = Record()
    g = torch.Generator(device="cuda").manual_seed(0)
    phase("build", build)
    phase("check layer_norm_chain", lambda: check_layer_norm(rec, g))
    phase("check swin_block_fused", lambda: check_swin_block(rec, g))
    phase("check patch_expand_ln", lambda: check_patch_expand(rec, g))
    phase("check dual_softmax_match_stats", lambda: check_dual_softmax(rec, g))
    phase("check coarse_transformer_fused", lambda: check_coarse_transformer(rec, g))
    phase("check fine_stage_fused", lambda: check_fine_stage(rec, g))
    phase("check swin_block_train", lambda: check_swin_block_train(rec, g))
    phase("check sparse_focal_loss", lambda: check_sparse_focal_loss(rec, g))
    phase("check coarse_transformer_train", lambda: check_coarse_train(rec, g))
    phase("check fine_transformer_train", lambda: check_fine_train(rec, g))
    phase("check wgrad", lambda: check_wgrad(rec, g))
    phase("check window_attention", lambda: check_window_attention(rec, g))
    image_launches = {}  # of the backbone's 13 blocks through swin_block_image
    phase("check swin_block_fused_image",
          lambda: check_swin_block_image(rec, g, image_launches))
    # the head-dim-64 instances tpu_optimized_config() runs, by the same checks
    tpu_cfg = tpu_optimized_config().model
    phase("check swin_block_fused, head dim 64",
          lambda: check_swin_block(rec, g, (1, 2, 4), "swin_block_fused@hd64"))
    phase("check coarse_transformer_fused, head dim 64",
          lambda: check_coarse_transformer(rec, g, 4, "coarse_transformer_fused@hd64"))
    phase("check fine_stage_fused, head dim 64",
          lambda: check_fine_stage(rec, g, 1, "fine_stage_fused@hd64"))
    phase("check swin_block_fused_image, head dim 64",
          lambda: check_swin_block_image(rec, g, image_launches, tpu_cfg,
                                         "swin_block_fused_image@hd64"))
    phase("check swin_block_train, head dim 64",
          lambda: check_swin_block_train(rec, g, (1, 2, 4), "@hd64"))
    phase("check coarse_transformer_train, head dim 64",
          lambda: check_coarse_train(rec, g, 4, "@hd64"))
    phase("check fine_transformer_train, head dim 64",
          lambda: check_fine_train(rec, g, 1, "@hd64"))
    # the float32 forms the teacher runs, at its shapes
    phase("check dual_softmax_match_stats float32", lambda: check_dual_softmax_f32(rec, g))
    phase("check coarse_layer_forward float32", lambda: check_coarse_f32(rec, g))

    cfg = default_config().model
    launches = {}  # of the serving forward
    train_launches = {}  # of the training step
    eval_launches = {}  # of the evaluation step with the per-op block

    serving_kernels = {}  # the serving forward's profile: launches, and launches by kernel

    def serving():
        rows = serving_forward(cfg, wrappers, launches)
        serving_kernels.update(launches=sum(r[1] for r in rows),
                               rows={n: c for _, c, n in rows})

    phase("serving forward 640x480 batch 4 bf16", serving)

    def semantic():
        mc = dataclasses.replace(cfg.match_coarse, thr=1e-8)
        model = FastMatcher(dataclasses.replace(cfg, match_coarse=mc), device="cuda", seed=0)
        gi = torch.Generator(device="cuda").manual_seed(2)
        img = torch.rand(B, H, W, 3, generator=gi, device="cuda")
        out = model(img, img)
        m = out.coarse.mask
        diag = float((out.coarse.i_ids == out.coarse.j_ids)[m].float().mean())
        print(f"  identical images: {int(m.sum())} matches, {diag:.4f} on the diagonal")
        if int(m.sum()) == 0 or diag < 0.95:
            raise AssertionError("identical images do not match on the diagonal")
        card_vs_cpu(model)

    phase("semantic checks", semantic)
    tpu_launches = {}  # of the serving forward at tpu_optimized_config()
    phase("serving forward tpu_optimized_config() 640x480 batch 4 bf16",
          lambda: serving_forward(tpu_cfg, wrappers, tpu_launches, check_cpu=True))
    sparse_step = {}  # the training step's profiler readings
    phase(f"training step {W}x{H} batch {B} bf16",
          lambda: sparse_step.update(training_step(wrappers, train_launches)))
    phase("training semantic checks", training_semantic)
    tpu_train_launches = {}  # of the training step at tpu_optimized_config()
    phase(f"training step tpu_optimized_config() {W}x{H} batch {B} bf16",
          lambda: training_step(wrappers, tpu_train_launches, tpu=True))
    phase("training semantic checks, tpu_optimized_config()",
          lambda: training_semantic(tpu=True))
    phase(f"evaluation step, per-op block, {W}x{H} batch {B} bf16",
          lambda: eval_forward(wrappers, eval_launches))
    phase("evaluation semantic checks, per-op block", eval_semantic)
    phase(f"two training steps, per-op block, {W}x{H} batch {B} bf16",
          lambda: training_per_op(wrappers))
    phase(f"training step, dense loss, {W}x{H} batch {B} bf16",
          lambda: training_dense(wrappers, {}, sparse_step))
    phase(f"evaluation, dense, {W}x{H} batch {B} bf16", lambda: eval_dense(wrappers))
    phase(f"coarse-only forward, {W}x{H} batch {B} bf16", lambda: coarse_only_forward(wrappers))
    teacher_launches = {}  # of the teacher's forwards
    phase(f"teacher forward loftr_tiny_config() {W}x{H} batch {B} float32",
          lambda: teacher_forward(wrappers, teacher_launches))
    phase(f"make_teacher_fn on the card, a {H}x{W} uint8 pair",
          lambda: teacher_fn_call(wrappers))
    phase(f"pose evaluation {W}x{H} batch {B}",
          lambda: pose_evaluation(wrappers, serving_kernels))

    kernels = []
    path_launches = (dict.fromkeys(EXPECTED_PER_FORWARD, launches)
                     | {n: tpu_train_launches if EXPECTED_PER_STEP.get(k) else tpu_launches
                        for n, k in HD64.items()} | {
                         "window_attention": eval_launches,
                         "swin_block_fused_image": image_launches,
                         "swin_block_fused_image@hd64": image_launches})
    for n, k in rec.k.items():
        if n in F32:
            base, src, replaces = F32[n]
            runs = teacher_launches
        else:
            base = HD64.get(n, n)
            src, replaces = SOURCES[base]
            runs = path_launches.get(n, train_launches)
        b, by = bound_ms(k["nbytes"], k["flops"], peak(n))
        kernels.append({
            "name": n, "route": "cuda", "source": f"featurematching_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": runs.get(n, runs.get(base, 0)),
            "max_abs_err": k["err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": b, "bound_by": by,
            "library_ms": k["lib"],
        })
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
