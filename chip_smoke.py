#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/H100 port (``samrs_tpu_torch``).

    python3 chip_smoke.py [--profile] [--only modes|configs|sizes ...]

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and the repo
checkout; it has no CPU path and raises on any failure.  Phases:

1. prints the card's name and power limit (nvidia-smi) and builds the
   kernel library from samrs_tpu_torch/csrc (timed);
2. kernel phase: K1-K6 at the shapes of one ViT-H image and a 64-prompt
   bucket on seeded inputs, each compared with its plain PyTorch version run
   in fp32 on the same bf16-rounded inputs (relative L2 must stay <= 1e-2),
   and timed against the plain version in bf16 (CUDA events, median of 7;
   the kernel also over 20 back-to-back calls, ``loop_ms``);
   K2 also against ``F.scaled_dot_product_attention`` with the rel-pos bias
   as its mask (both with TFLOP/s), K3 also against the ``mlp_impl="xla"``
   composition (F.layer_norm -> F.linear -> F.gelu -> F.linear in bf16);
   K5 also with 21 live tokens in 32 slots (two slot blocks,
   as a decode with many point prompts gives it), at bucket 256
   (generate's 100 boxes) and with 5 live tokens and per-prompt keys (the
   prompt evaluation's mask-only prompts); K6 also at bucket 256, with 3 mask tokens
   (multimask) and on the 48x48, 32x32 and 16x16 grids of image_size 768 /
   512 / 256 with 1 and 3 tokens, beside its elementwise floor (768 GELUs a
   source pixel, two special-function ops each, at 16 a cycle an SM at the
   card's highest SM clock).  K7 on 32 low-res masks
   to an 800x800 original (input 1024x1024) and to a 768x1024 original
   (input 768x1024), and on the automatic mask generator's chunk, 192
   masks to 1024x1024: counts, boxes and bits must equal the plain version's
   except at pixels whose plain logit lies within 1e-4 of a threshold
   (counted and printed); timed one call at a time (CUDA events), by the
   device time of its kernel (torch.profiler) and by the wall time of 20
   back-to-back calls.  The plain versions round where the kernels
   round (bf16 products with fp32 epilogues, the online softmax's bf16
   probabilities), so the kernel and plain paths differ only in fp32
   summation order and the flips it causes.  Each kernel gets its bound:
   the larger of its bytes (each input read once, each output written once)
   over 3.35 TB/s and its flops over the peak of its type (989 TFLOP/s
   bf16 tensor cores, 67 TFLOP/s fp32);
3. main path: ViT-H with seeded random weights (zero-initialised parameters
   re-randomised), ``SamPredictor.set_image`` on a non-square 768x1024 image
   and ``predict_boxes`` on 64 boxes; checks shapes, finiteness and launches
   K1 28, K2 4, K3 32, K4 1, K5 2, K6 1 per image (and 128 GEMM launches:
   qkv and proj of every block, lin1 and lin2 of every MLP), then reruns on the plain
   versions (``Sam.use_kernels = False``): encoder feature rel-L2 <= 2e-2
   and mean mask IoU >= 0.99;
2a. GEMM phase: the dense layer of K1 and K3 (csrc/gemm.cu, wgmma fed by
   TMA) at the ViT-H encoder's four shapes (T 4096: qkv 3840 x 1280, proj
   1280 x 1280 + fp32 residual, lin1 5120 x 1280 + GELU, lin2 1280 x 5120 +
   fp32 residual) against ``linear_plain`` in fp32 on the same bf16 inputs
   (rel-L2 <= 1e-2), timed over back-to-back launches beside the plain
   version and ``F.linear`` in bf16 (cuBLAS, the yardstick; the port never
   calls it), with TFLOP/s and the bound;
2b. modes phase (the SAM encoder's kernel configurations), at the same
   shapes against the fp32 plain versions (rel-L2 <= 1e-2) with kernel,
   bf16 plain and SDPA times and the bound: K12 (split-head rel-pos
   attention) at the windows (B' 400, N 196: the window form, K1's
   pipeline), the globals (16, 4096: the query-tiled form, K2's) and the
   global grids of image_size 512 and 256 (16, 1024; 16, 256: query-tiled),
   each at heads of 80 and 64, and ``window_attention_relpos`` end to end
   (the rel rows made on the card from bf16 q) at the windows and the 32^2
   grid; K2 in its modes split, exp2
   and aug and on a 48x48 grid (key tiles straddling grid rows); K3's tail
   mode on a 70^2 padded map cropped to 64^2; K1's window orders (plain, one
   block per window row), blockq, the padded output, the residual form
   (block2), the attention stage on the raw qkv map (fused2) and on
   partitioned windows (fused), these two also against SDPA on the
   partitioned windows with the window rel-pos bias as its mask;
4. generate phase: a seeded 800x800 image and a DIOR XML with 100 boxes
   of 16-240 px, labels uniform over DIOR's 20 classes (bucket 256, four K7
   chunks), loaded with the port's DIOR loader and run through
   ``SemanticGenerator.process_image``; writes the pkl and PNGs to a
   temporary directory and reads them back; checks launches K1-K7
   28/4/32/1/2/1/4, that every RLE decodes to its recorded area, that the
   gray PNG is the label of the last instance covering each pixel and the
   colour PNG is PALETTE[gray], and against the plain path mean instance
   IoU, per-pixel cover-index agreement and gray agreement, each >= 0.99;
4a. fleet phase (``python -m samrs_tpu_torch.generate.fleet``'s
   ``run_fleet``): a seeded DIOR mini-set of six 800x800 images with 100
   boxes and two 768x1024 with 64, ordered so that each window of four
   images holds both shapes (encoder passes of 3 and 1 images), as JPEGs;
   run_fleet with the kernels and on the plain versions, and
   ``generate_semantic`` on the same images; every image's outputs read back
   and checked as in 4; fleet against generate_semantic and kernels against
   plain: mean instance IoU, cover and gray agreement >= 0.99; launches K1
   28, K2 4, K3 32 and the GEMM 128 per encoder pass, K4 1, K5 2, K6 1 and
   K7 ceil(n/32) per image; the C codec's bytes equal to the numpy codec's
   on every mask; fleet img/s (first run and plain over the 8 images: fill
   and drain; warm over 64, links to the 8: the steady rate), the fleet's
   device ms an image (torch.profiler) and the card's busy share at the
   steady rate, generate_semantic's s/image, a
   cProfile of two of its images, the codecs' ms a mask; four 1024^2
   images in one ``encode_images`` pass against ``set_image`` one by one
   (feature rel-L2 <= 2e-2; bit-equality printed); the encoder's ms an image
   at batch 4 and 1; K1-K3 (run_cases, device time by torch.profiler) and
   the GEMM's four shapes at batch 4 (T 16384);
4d. automatic mask generator (``SamAutomaticMaskGenerator`` over
   ``SamPredictor``): a seeded 1024^2 image at 32^2 points, 64 a chunk; the
   sweep before the filters (``amg_sweep``, 3072 masks) with the kernels and
   with the plain versions, bits by mean IoU >= 0.99, and K7 against its
   plain version on every chunk's own logits by K7's rule; the whole
   generator with both thresholds at 0 on both paths (launches K1 28, K2 4,
   K3 32, GEMM 128, and per chunk K4 1, K5 2, K6 1, K7 1; more than 0
   records; the kernel path's records against the plain sweep's masks of
   their prompts, mean IoU >= 0.99), s/image (device time by torch.profiler,
   host the rest of the wall, a cProfile of the host), the default
   thresholds' record count, and crop_n_layers 1 with
   min_mask_region_area 100 (launches of 5 encoder passes and 32 chunks, the
   record schema); then the HRSC prompt evaluation (``run_prompt_eval``) on
   a seeded 800x600 scene with 8 rotated ships (HRSC XML, image, LandMask
   PNG), every prompt mode on both paths: launches of one image, the COCO
   JSON read back, instance masks kernels vs plain mean IoU >= 0.99,
   s/image;
4b. configurations phase: the ViT-H encoder on one 1024^2 image from the
   main path's weights under every value of window_attn_impl, each
   global_attn_impl mode, tail_impl=fused and mlp_impl=xla: launches per
   image (pallas K12 28 / K2 4 / K3 32; xla K12 4 / K3 32; tail K1 28 /
   K3-tail 28 / K3 4 / K2 4; mlp xla K1 28 / K2 4; every other value its K1
   mode 28 / K2 4 / K3 32), encoder ms (CUDA events, median of 7; also 5
   back-to-back calls, and with ``--only configs`` the summed device time
   of one call) and the feature rel-L2 against the default configuration
   (<= 2e-2);
4c. image sizes: the generate phase at image_size 512 and 256 (global grids
   of 1024 and 256 tokens: K12 4 launches an image instead of K2; cover and
   gray agreement >= 0.99), then the main path at image_size 768 (K2 on a
   48x48 grid); each ViT-H freed before the next;
5. K8 phase (ViT-H freed first): K8 forward and backward against
   ``sample_weighted_plain`` on the same inputs at the RVSA shape of the
   FAST head (65 images x 12 heads, 14x14, K and V in one launch: Gc 128,
   one tap) in fp32 and with a bf16 map, at Gc 64, at a DCNv3 shape (BG 48,
   56x56, Gc 16, 9 taps partly off the map) and on the identity grid on
   exact integers; rel-L2 of out, dxg, dfx, dfy, dmask <= 1e-5 (dxg of the
   bf16 map <= 1e-2, integer-grid dfx <= 1e-6), timed against the plain
   version and ``F.grid_sample`` (forward, backward, both), with the bound;
   also at Mask2Former's shapes: one MSDeformAttn level (BG 520, 28x28, Gc
   32, 1029 queries, 4 taps) and the shared matching sample (BG 65, 56x56,
   Gc 100 and 37, 12544 points; F.grid_sample over a (BG, 1, P, 2) grid),
   and InternImage-T's four DCNv3 levels (BG 260 .. 2080, 56^2 .. 7^2, Gc
   16, 9 taps) and level 0 with zero offsets (every tap on a pixel); each
   forward with its GB/s, bytes and operations bounds, F.grid_sample's time
   at one tap and its max abs error (in fp32 its bits must equal the plain
   version's: the kernel rounds op by op in the plain order, also at odd Gc,
   Gc 1, Gc 6 and K 2 / 3, the forms the paths' shapes do not reach); each
   backward with its GB/s, bytes and operations bounds and its dX reductions
   a tap, which must be at least 4x fewer than per-channel ones where
   Gc % 4 == 0;
5b. K9 phase: K9 forward and backward (dimg, dfx, dfy) against
   ``point_sample_plain`` at the FAST head's point losses (6500 masks of
   56x56 at 12544 points and at the 37632 candidates), on a 256x256 map (the
   kernel's device-memory path), on exact integer points and off the map,
   rel-L2 <= 1e-5, timed against the plain version and ``F.grid_sample`` on
   the one-channel maps, with the bound; then the MSDeformAttn wrapper
   (three K8 launches) forward and backward against its plain route at the
   pixel decoder's FAST shapes (rel-L2 <= 1e-5);
6. K10 / K11 phase: K10 (plain attention) and K11 (fused MLP), both on
   split-TF32 wgmma, in fp32 against their plain versions, forward and the
   autograd backward (rel-L2 <= 1e-5), at vit_b 512^2 batch 8 (BH 96, N
   1024; T 8192, C 768, M 3072) and at the RVSA FAST head's 224^2 shape (N
   196: a tail tile), K10 also with heads of 80 (BH 1040, N 196), timed
   against the plain version,
   SDPA (K10) and the F.linear -> F.gelu -> F.linear composition (K11), with
   TFLOP/s and both bounds: the split-TF32 tensor work and the fp32
   CUDA-core one;
7. train-step phase: vit_b_rvsa + UperNet with its own seeded init, one
   pretrain step on 17/12/65 seeded images at 224^2 (fp32, TF32 off) from
   identical state with the kernels (K8 24/24, K10 12, K11 36 launches),
   with their plain versions (0), and with the control (the plain versions
   with each MLP product split into two K-halves and added); parameters
   unmoved (lr 0 at step 0), |dloss| / loss <= 1e-5, and for the gradients
   and both AdamW moments the kernels-vs-plain rel-L2 over all parameters
   within 3x the control's (UperNet's BatchNorms amplify any change of fp32
   summation order ~1e3x at initialisation; the zero-gradient neck biases
   printed apart); then warm s/step, img/s and peak memory of both;
7b. Mask2Former step phase: vit_b_rvsa + Mask2Former at full width and
   depth, seeded init, the same 17/12/65 batch shape, m2f_num_points 12544:
   one step with the kernels (K8 138 + 78, K9 90 + 30, K10 12, K11 36
   launches), the plain versions and the control, judged by the rule of
   phase 7; the attention-mask bits and point-sampled assignments that
   differ between the paths (eval forwards); s/step, img/s and peak memory
   of both paths; the Hungarian assignment's host time in a step;
8. finetune-step phase: SegModel(vit_b, upernet, 6 classes, 512^2) at full
   width and depth, seeded init, batch 8: eval-mode logits kernels vs plain
   rel-L2 <= 1e-5 (K10 12, K11 12 launches), one finetune step by the rule
   of phase 7, then s/step, img/s and peak memory of both paths;
9. pretrain phase: ``run_pretrain`` at the defaults for 3 steps on a
   synthetic SAMRS layout (DATASET_LAYOUT's trees, noise images, uniform
   labels): launches, the step count, one mIoU line per dataset, ``last`` /
   ``best`` checkpoints with encoder copies, and a resume from ``last`` that
   restores the step and the weights; then the same with
   ``decoder=mask2former m2f_num_points=12544`` (launches per step as in
   phase 7b plus K8 26, K10 4, K11 12 an eval forward);
9b. InternImage-T (this slice's path): K8's row-slab form (csrc/bilinear_slab.cu)
   forward and backward against dense K8 (forward rel-L2 <= 1e-6; it is
   bit-equal by design) and against sample_weighted_plain (K8's bounds) at
   the four DCNv3 levels of the FAST head (BG 260 / 520 / 1040 / 2080,
   56^2 .. 7^2, Gc 16, 9 taps, slab 7), level 0 with a bf16 map, the MSDA
   level, a scattered 64^2 map over a stage, a 1024-wide map, Gc 6, a
   112^2 DCNv3 map with two of every query's nine taps half the map away
   (taps on and off the band in one launch; both routes counted by the
   kernel's counting build) and Gc 5 (flat-4), timed (one call, and
   20 back to back) beside dense K8 and the plain version with the bound;
   K11 at C 64 / 128 / 256 / 512 on each level's tokens and at C
   1024 / 1280 on 1000 tokens (rel-L2 <= 1e-5); one internimage_t + UperNet
   step (17/12/65 at 224^2, fp32) with
   dense K8, with SAMRS_BILINEAR_SLAB=7, plain and the control, judged as
   in phase 7 (K8 or K8-slab 90 + 90, K11 90 launches), with s/step, img/s
   and peak memory of each; ``run_pretrain backbone=internimage_t`` for 3
   steps with eval and checkpoints, dense and with SAMRS_BILINEAR_SLAB=7
   (the slab kernels' launches in the result line come from that run);
   ``--profile`` adds torch.profiler tables of a dense and a slab step;
9c. ViT-Adapter-B (run after phase 6, before the other train steps): K8
   forward and backward against sample_weighted_plain at
   the adapter's FAST-head shapes (65 images x 12 heads of 32: the
   injector's 28^2 / 14^2 / 7^2 levels with the 196 ViT tokens, the
   extractor's 14^2 level with the 1029 conv tokens; 4 points), rel-L2 <=
   1e-5, forward bit-equal, with times and the bound; one vit_adapter_b +
   UperNet step (17/12/65 at 224^2, fp32, the family's optimizer row) with
   the kernels (K8 54 + 54, K10 36, K11 36 launches counted on the card),
   the plain versions and the control, judged as in phase 7, with s/step,
   img/s, peak memory and the device's busy share of a warm step
   (torch.profiler, taken again where it lost K8 records); ``python -m
   samrs_tpu_torch.train.pretrain backbone=vit_adapter_b decoder=unetpp``
   for 2 steps with eval and checkpoints on a synthetic SAMRS layout; the
   finetune CLI with ``backbone=vit_adapter_b decoder=unet`` (Potsdam,
   512^2, batch 8, one epoch of 2 steps) from that run's
   ``best_encoder.pt``, and the evaluate CLI with the same backbone and
   decoder on its ``last.pt`` (two 600x600 images, flip TTA, PNGs read
   back); launches of each;
9d. Swin-T, ViTAEv2-S and ResNet-50 (this slice's path; run after 9c): K11
   at Swin-T's four MLP shapes (C 96 in the fused form, 192 / 384 / 768 in
   two launches; M 4C) and ViTAEv2-S's ReductionCells (C = M = 64 .. 512)
   on the FAST head's tokens of each stage, against the plain version
   (rel-L2 <= 1e-5), timed one call at a time and 20 back to back beside the
   composition and the bound; one SEP step of each of swin_t, vitaev2_s and
   resnet50 + UperNet (17/12/65 at 224^2, fp32, the family's optimizer row)
   with the kernels (K11 36 / 54 / 0 launches, every weight split once),
   the plain versions and the control, judged as in phase 7, with s/step,
   img/s, peak memory and the busy share of a warm step; a swin_t + UperNet
   finetune step at 8 x 512^2 (every stage pads to a window multiple and
   rolls the padded map), eval logits and the step against the plain path;
   ``python -m samrs_tpu_torch.train.pretrain backbone=<each>`` for 2 steps
   with eval and checkpoints on a synthetic SAMRS layout, with launches;
10. finetune-driver phase: ``run_finetune`` at the defaults (vit_b_rvsa +
   UperNet, Potsdam, 512^2, batch 8) for one epoch (2 steps, one eval batch)
   on a synthetic Potsdam layout with RGB labels in ISPRS_PALETTE, grafting
   the pretrain phase's ``best_encoder.pt``: launches K8, K10, K11, the epoch
   line with mIoU, ``last`` / ``best`` checkpoints;
11. test phase: ``run_test`` with flip TTA on two seeded 600x700 images at
   crop 512 (a 2x2 grid with tail crops) with the finetuned model: launches,
   gray and colour PNGs read back against the prediction and the palette,
   and kernels-vs-plain probability maps (rel-L2 <= 1e-5);
11a. pretrained phase (``pretrained=``): a seeded reference-layout ``.pth`` of
   each of the seven families at its published widths (vit_b_rvsa, vit_b,
   swin_t, resnet50, vitaev2_s, internimage_t, vit_adapter_b: the encoder's
   keys under ``module.backbone.``, MAE extras, the reference's keys the
   port keeps no tensor for, one key of the wrong shape, a 16^2 pos-embed
   for the ViTs) loaded with ``load_backbone_checkpoint`` into the family's
   encoder on the card: the family, the loaded and skipped counts against
   JAX's on the same layout, every loaded tensor the checkpoint's; K11's
   weight halves split again on the first forward after a load (one per
   MLP weight loaded); one vit_b_rvsa + UperNet step from the loaded state
   by the rule of phase 7; ``run_pretrain(pretrained=<vit_b_rvsa file>)``
   for 3 steps with an eval (launches as phase 9's);
11b. DDP phase: two ranks of this script (``--ddp-worker``, torchrun's
   variables), on two cards over NCCL or both on one card over gloo
   (core/mesh.py's rule; printed with the card count), vit_b_rvsa + UperNet
   at full width and depth, the global batch cut to 32 (4 / 4 / 22 a head,
   half on each rank): two steps with dropout and drop-path on against one
   process on the rank-ordered global batch (losses within 1e-5, gradients,
   AdamW moments and BatchNorm statistics within 3x the control's distance,
   statistics and parameters equal on the ranks), K8 / K10 / K11 launches
   inside each rank, warm s/step, peak memory, the gradient all-reduce's
   time and a profile's all-reduce share a rank, and ``run_pretrain`` on
   the two ranks for 2 steps with an eval (the same lines on both),
   checkpoints written by rank 0 only and a resume that restores both; a
   rank's failure fails the phase;
12. prints the configurations phase's results as one JSON line, then one
   JSON line of per-kernel results (launches: K1-K7 from the generate
   phase, with ``launches_main_path`` and ``launches_fleet`` beside them,
   K1-K3 and the GEMM also with their batch-4 numbers under ``batch4_*``;
   K12 from the generate phase at image_size 512, the modes from the
   configuration or image size that runs them, K8 from the pretrain phase
   with its per-step count and the adapter's cases and launches (phase 9c),
   K9 from the Mask2Former pretrain phase, K10 and K11 from the finetune driver
   with their per-step counts, K11 also with phase 9d's cases and launches,
   K8 / K10 / K11 also with phase 11a's run and phase 11b's per rank;
   an entry's other cases beside its main one carry measured numbers only,
   their bounds are on the log lines, but K11's 9d cases carry theirs), then
   the card's name and power limit and the final status line.

``--only`` runs just the named phases after the build (kernels: 2; gemm: 2a; main: 3 and 4,
the main path and the generate phase at the default image size; fleet: 4a; amg: 4d; modes, configs,
sizes: 2b, 4b, 4c; slab: the K8-slab and K11-width checks of 9b;
internimage: its step and driver runs; mlp: 6 and K11's widths; gather: 5
and the MSDA wrapper of 5b; steps: 7, 7b, 8 and 9b's step; adapter: 9c;
backbones: 9d; pretrained: 11a; ddp: 11b),
and prints no kernels line: it ends with the card's name and power limit and the status line.

``--profile`` adds a torch.profiler table of one warm generate image (and of
one warm main-path image at image_size 768) with
the kernels and with the plain versions, and of one warm pretrain step (UperNet
and Mask2Former) and one warm finetune step with the kernels (device time by operation, device
busy share of the wall time).  ``chip_drift.py`` shows where the generate path's two paths part.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import cProfile
import gc
import json
import logging
import os
import pickle
import pstats
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
N_BOXES = 64
IMAGE_HW = (768, 1024)
GEN_HW = (800, 800)
GEN_BOXES = 100
GEN_BOX_PX = (16, 240)  # box sides, uniform; not taken from a DIOR statistic
GEN_BUCKET = 256           # the prompt bucket of GEN_BOXES (sam/predictor.py DEFAULT_BUCKETS)
MAIN_LAUNCHES = {"K1": 28, "K1pf": 0, "K1w": 0, "K2": 4, "K3": 32, "K3t": 0, "K12": 0, "K4": 1,
                 "K5": 2, "K6": 1, "K7": 0, "K8f": 0, "K8b": 0, "K9f": 0, "K9b": 0, "K10": 0,
                 "K11": 0, "K11s": 0, "K8sf": 0, "K8sb": 0}
GEN_LAUNCHES = {**MAIN_LAUNCHES, "K7": 4}
MAIN_GEMM_LAUNCHES = 128       # ViT-H: qkv + proj of 32 blocks, lin1 + lin2 of 32 MLPs
# the fleet phase: 6 images of 800x800 (GEN_BOXES boxes) and 2 of 768x1024 (N_BOXES), in this
# order, so each window of FLEET_BATCH images holds both shapes (encoder passes of 3 and 1)
FLEET_ORDER = (GEN_HW, GEN_HW, GEN_HW, IMAGE_HW) * 2
FLEET_BATCH = 4                # run_fleet's encoder pass (generate/fleet.py ENCODE_BATCH)
FLEET_REPEAT = 8               # the steady-rate run: 8 passes over the set, 4x the read-ahead
ENCODE_LAUNCHES = {"K1": 28, "K2": 4, "K3": 32, "GEMM": MAIN_GEMM_LAUNCHES}  # an encoder pass
# SEP pretraining: vit_b_rvsa + UperNet, 224^2, heads SOTA / SIOR / FAST
TRAIN_BATCH = (17, 12, 65)     # proportional_batch_sizes(..., 96): floors of the subset shares
TRAIN_CLASSES = (18, 20, 37)
RVSA_BLOCKS = 8                # of vit_b_rvsa's 12 (every third is full attention)
FULL_BLOCKS = 4                # ... and its full-attention blocks: K10
VIT_DEPTH = 12                 # blocks (and MLPs: K11) of vit_b and vit_b_rvsa
# one launch per block and forward, three forwards (heads) a step; K and V in one K8 launch;
# K11's weights split once a step (K11s: w1 and w2 of every MLP, new versions after each
# optimizer step, one version for the step's three forwards)
STEP_LAUNCHES = {"K8f": RVSA_BLOCKS * 3, "K8b": RVSA_BLOCKS * 3, "K10": FULL_BLOCKS * 3,
                 "K11": VIT_DEPTH * 3, "K11s": VIT_DEPTH * 2}
PRETRAIN_ITERS = 3
# Mask2Former pretraining (decoder=mask2former): 6 MSDeformAttn layers x 3 levels through K8,
# 10 decoder outputs a head, each with the shared matching sample (K8) of its masks and of
# the gt masks, and K9 for the candidates, the prediction (backward too) and the target
M2F_POINTS = 12544             # m2f_num_points (mmdet's; samrs_tpu/core/config.py:310-312)
M2F_OUTPUTS = 10               # the initial queries' and 9 decoder layers' predictions
MSDA_CALLS = 6 * 3             # K8 launches of one pixel-decoder forward
M2F_STEP_LAUNCHES = {
    "K8f": 3 * (RVSA_BLOCKS + MSDA_CALLS + 2 * M2F_OUTPUTS), "K8b": 3 * (RVSA_BLOCKS + MSDA_CALLS),
    "K9f": 3 * 3 * M2F_OUTPUTS, "K9b": 3 * M2F_OUTPUTS, "K10": FULL_BLOCKS * 3, "K11": VIT_DEPTH * 3,
    "K11s": VIT_DEPTH * 2}
M2F_EVAL_LAUNCHES = {"K8f": RVSA_BLOCKS + MSDA_CALLS, "K10": FULL_BLOCKS, "K11": VIT_DEPTH}
# InternImage-T SEP pretraining (backbone=internimage_t): 30 blocks, one DCNv3 (K8) and one
# MLP (K11) each; three encoder passes (heads) a step
II_DEPTHS, II_GROUPS, II_GC = (4, 4, 18, 4), (4, 8, 16, 32), 16
II_BLOCKS = sum(II_DEPTHS)
II_SLAB = 7                    # SAMRS_BILINEAR_SLAB of the slab runs: divides 56, 28, 14 and 7
II_STEP_LAUNCHES = {"K8f": II_BLOCKS * 3, "K8b": II_BLOCKS * 3, "K11": II_BLOCKS * 3,
                    "K11s": II_BLOCKS * 2}
II_SLAB_STEP_LAUNCHES = {"K8sf": II_BLOCKS * 3, "K8sb": II_BLOCKS * 3, "K11": II_BLOCKS * 3,
                         "K11s": II_BLOCKS * 2}
II_EVAL_LAUNCHES = {"K8f": II_BLOCKS, "K11": II_BLOCKS}
# ViT-Adapter-B SEP pretraining (backbone=vit_adapter_b): 4 interactions, each an injector
# (a three-level MSDeformAttn: one K8 launch a level) before its 3 ViT blocks and an
# extractor (one level) after them, 2 extra extractors after the last; the 12 blocks'
# attention through K10, their MLPs through K11; three encoder passes (heads) a step
ADAPTER_MSDA = 4 * 3 + 4 + 2   # K8 launches of one ViT-Adapter forward
ADAPTER_STEP_LAUNCHES = {"K8f": ADAPTER_MSDA * 3, "K8b": ADAPTER_MSDA * 3, "K10": VIT_DEPTH * 3,
                         "K11": VIT_DEPTH * 3, "K11s": VIT_DEPTH * 2}
ADAPTER_EVAL_LAUNCHES = {"K8f": ADAPTER_MSDA, "K10": VIT_DEPTH, "K11": VIT_DEPTH}
# per-channel shifts that a BatchNorm removes next (the spatial prior's fc1 and up into
# norm1; norm1..norm3 into UperNet's 1x1 laterals): no true gradient, rounding noise on
# both paths
ADAPTER_ZERO_GRAD = ("encoder.spm.fc1.bias", "encoder.up.bias", "encoder.norm1.bias",
                     "encoder.norm2.bias", "encoder.norm3.bias")
ADAPTER_ITERS = 2              # run_pretrain steps of the adapter phase, one eval after them
ADAPTER_FT_TRAIN, ADAPTER_FT_VAL = 16, 2   # its Potsdam layout: 2 steps, 2 eval / test images
# Swin-T / ViTAEv2-S / ResNet-50 SEP pretraining (backbone=swin_t | vitaev2_s | resnet50, UperNet
# at out_channels[2]): their MLPs through K11 (Swin-T's 12 blocks; ViTAEv2-S's 4 ReductionCells
# and 14 NormalCells; ResNet-50 has none), attention and convolutions in torch / cuDNN; three
# encoder passes (heads) a step
BACKBONE_MLPS = {"swin_t": 12, "vitaev2_s": 18, "resnet50": 0}
BACKBONE_ITERS = 2             # run_pretrain steps of each backbone's driver run, one eval after
# no true gradient: Swin's out-norm biases of c1..c3 (UperNet's 1x1 laterals and BatchNorms
# follow), the convs before ViTAE's PCM BatchNorms; rounding noise on every path
BACKBONE_ZERO_GRAD = r"encoder\.(norm[0-2]\.bias|.*PCM\.[03]\.bias)"
K8_SLAB_FWD_RTOL = 1e-6        # K8-slab forward vs dense K8 (0 by design: K8's per-tap order)
PROFILE_PAD_S = 0.05           # idle host time on each side of a device_ms profile (s)
K9_RTOL = 1e-5                 # K9 vs its plain version: summation order (dimg by atomics)
K8_RTOL = 1e-5                 # fp32 gather, kernel vs plain: summation order and atomics only
K8_BF16_DXG_RTOL = 1e-2        # dxg returned in bf16: one bf16 rounding of the same fp32 sum
K8_INT_RTOL = 1e-6             # taps on exact integers: dfx of the one-sided floor formula
STEP_LOSS_RTOL = 1e-5          # train steps, kernels vs plain versions: |dloss| / loss
# ... gradients and AdamW moments: at initialisation UperNet's BatchNorms return an fp32
# change in summation order ~1e3 times larger, so the kernels-vs-plain distance (rel-L2
# over all parameters) is held within CONTROL_FACTOR times that of a control: the plain
# path against itself with each MLP product split into two K-halves and added
CONTROL_FACTOR = 3.0
K10_K11_RTOL = 1e-5            # fp32 kernels vs plain versions, forward and backward
EVAL_RTOL = 1e-5               # eval-mode logits / probabilities, kernels vs plain
# finetuning: vit_b + UperNet on Potsdam at 512^2, batch 8 (FinetuneConfig, FINETUNE_DATASETS)
FT_SIZE, FT_BATCH, FT_CLASSES = 512, 8, 6
FT_TRAIN, FT_VAL = 16, 8       # synthetic Potsdam layout of the driver phase: 2 steps, 1 eval batch
TEST_HW = (600, 700)           # test images: a 2x2 crop grid at 512 with tail crops
# parameters whose true gradient is 0 (the neck's last deconv biases: a per-channel
# shift the next layer's BatchNorm removes); both paths give rounding noise there,
# so their distance is taken against the norm of the whole gradient (or moment)
ZERO_GRAD = ("encoder.fpn1.3.bias", "encoder.fpn2.0.bias")
KERNEL_RTOL = 1e-2     # bf16 rounding of operands / intermediates vs an fp32 reference
FEATURE_RTOL = 2e-2    # 32 blocks with bf16 products, kernels vs plain versions
IOU_MIN = 0.99         # kernels vs plain path: bf16 summation order flips pixels near 0
K7_NEAR = 1e-4         # K7 pixels this close to a threshold may flip (fp32 sum order)
K7_WIDE_HW = (7000, 7000)  # a DOTA-v2-sized scene: K7's tables no longer fit shared memory
# the automatic mask generator (SamAutomaticMaskGenerator's defaults, bench.py:154-200's image):
# one 1024^2 image, 32^2 points, 64 prompts a chunk, 3 masks a prompt (multimask)
AMG_HW = (1024, 1024)
AMG_POINTS = 32
AMG_BATCH = 64
AMG_CHUNKS = AMG_POINTS ** 2 // AMG_BATCH
AMG_MASKS = 3 * AMG_BATCH      # K7's masks a chunk
AMG_LAUNCHES = {**MAIN_LAUNCHES, "K4": AMG_CHUNKS, "K5": 2 * AMG_CHUNKS, "K6": AMG_CHUNKS,
                "K7": AMG_CHUNKS}
# crop_n_layers 1: the image and 4 crops (their grids 16^2 at crop_n_points_downscale_factor 2)
AMG_CROPS = 5
AMG_CROP_CHUNKS = AMG_CHUNKS + 4 * (AMG_POINTS // 2) ** 2 // AMG_BATCH
AMG_CROP_LAUNCHES = {**MAIN_LAUNCHES, **{k: v * AMG_CROPS for k, v in ENCODE_LAUNCHES.items()
                                         if k != "GEMM"},
                     "K4": AMG_CROP_CHUNKS, "K5": 2 * AMG_CROP_CHUNKS, "K6": AMG_CROP_CHUNKS,
                     "K7": AMG_CROP_CHUNKS}
# the HRSC prompt evaluation: a seeded 800x600 scene with 8 rotated ships; every instance's
# prompt of a mode decodes in one batch (bucket 16): the main path's launches, one encoder pass
# and K4 1, K5 2, K6 1
HRSC_HW = (600, 800)
HRSC_SHIPS = 8
# K6 cases: key, title, prompts, grid, mask tokens.  The main path runs bucket 64 on 64x64 with
# one token, generate bucket 256; M 3 is multimask output; image_size 768 / 512 / 256 give the
# 48 / 32 / 16 grids
K6_CASES = (("K6", "upscaling + hypernetwork dot", 64, 64, 1),
            ("K6b256", f"upscaling + hypernetwork dot, bucket {GEN_BUCKET}", GEN_BUCKET, 64, 1),
            ("K6m3", "upscaling + hypernetwork dot, 3 tokens", 64, 64, 3),
            ("K6g48", "upscaling + hypernetwork dot, 48x48", 64, 48, 1),
            ("K6g48m3", "upscaling + hypernetwork dot, 48x48, 3 tokens", 16, 48, 3),
            ("K6g32", "upscaling + hypernetwork dot, 32x32", 64, 32, 1),
            ("K6g32m3", "upscaling + hypernetwork dot, 32x32, 3 tokens", 16, 32, 3),
            ("K6g16", "upscaling + hypernetwork dot, 16x16", 64, 16, 1),
            ("K6g16m3", "upscaling + hypernetwork dot, 16x16, 3 tokens", 16, 16, 3))
# K12's two forms (window_attention.split_form) and the sources that hold them
SPLIT_SOURCES = {"window": "samrs_tpu_torch/csrc/window_attention.cu",
                 "tiled": "samrs_tpu_torch/csrc/flash_attention.cu"}
HBM_BYTES_PER_S = 3.35e12
PEAK = {"bf16": 989e12, "fp32": 67e12, "tf32": 495e12}


def counters():
    from samrs_tpu_torch.kernels import (amg_post, bilinear_gather, flash_attention,
                                         fused_attention, fused_mlp, fused_twoway, fused_upscale,
                                         fused_window_block, fused_window_layer, window_attention)
    return {"K1": (fused_window_layer, "launches"), "K1pf": (fused_window_block, "launches"),
            "K1w": (fused_attention, "launches"), "K2": (flash_attention, "launches"),
            "K3": (fused_mlp, "launches"), "K3t": (fused_mlp, "tail_launches"),
            "K12": (window_attention, "launches"), "K4": (fused_twoway, "kv_launches"),
            "K5": (fused_twoway, "i2t_launches"), "K6": (fused_upscale, "launches"),
            "K7": (amg_post, "launches"), "K8f": (bilinear_gather, "fwd_launches"),
            "K8b": (bilinear_gather, "bwd_launches"), "K9f": (bilinear_gather, "ps_fwd_launches"),
            "K9b": (bilinear_gather, "ps_bwd_launches"), "K10": (flash_attention, "full_launches"),
            "K11": (fused_mlp, "mlp_launches"), "K11s": (fused_mlp, "split_launches"),
            "K8sf": (bilinear_gather, "slab_fwd_launches"),
            "K8sb": (bilinear_gather, "slab_bwd_launches")}


def reset_counts() -> None:
    from samrs_tpu_torch.kernels import gemm
    for mod, name in counters().values():
        setattr(mod, name, 0)
    gemm.launches = 0  # the dense layers inside K1 / K3 and the globals' qkv / proj


def read_counts():
    return {k: getattr(mod, name) for k, (mod, name) in counters().items()}


def checked_splits(label: str, launches, least: int) -> int:
    """K11's weight splits (K11s) in a driver's run: one per weight and
    version, so at least `least` (w1 and w2 of every MLP at every step whose
    weights are new) and at most two a K11 call; returns the count, to stand
    in the run's expected launches."""
    n, calls = launches["K11s"], launches["K11"]
    if not least <= n <= 2 * calls:
        raise RuntimeError(f"{label}: {n} K11 weight splits, want {least} .. {2 * calls}")
    return n


def cuda_ms(fn, warmup: int = 2, reps: int = 7) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def loop_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """ms per call over `n` back-to-back calls (CUDA events around the run):
    the device time of a kernel shorter than its wrapper's host work is not
    hidden behind an idle card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def rel_l2(a, b) -> float:
    a = torch.cat([t.float().flatten() for t in a])
    b = torch.cat([t.float().flatten() for t in b])
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def bound(nbytes: float, flops: float, peak: str):
    """(least ms for this work on an H100, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def encoder_cases(gen: torch.Generator, B: int = 1):
    """run_cases entries of K1, K2 and K3 at the ViT-H encoder's shapes for
    a batch of B images (T 4096 tokens an image), with K3's inputs."""
    from samrs_tpu_torch.kernels import flash_attention, fused_mlp, fused_window_layer

    C, nH, ws, G = 1280, 16, 14, 64
    hd = C // nH
    T = G * G

    def rn(*shape, std=1.0):  # bf16-representable fp32 values
        return (torch.randn(*shape, generator=gen, device="cuda") * std).bfloat16().float()

    tag = "" if B == 1 else f", batch {B}"
    cases = []  # key, title, source, replaces, kernel, fp32 reference, bf16 plain, bytes, flops, library
    xn = rn(B, G, G, C).bfloat16()
    k1 = (rn(3 * C, C, std=C ** -0.5), rn(3 * C, std=0.5), rn(C, C, std=C ** -0.5),
          rn(C, std=0.1), rn(ws, ws, hd, std=0.1), rn(ws, ws, hd, std=0.1), ws, hd ** -0.5, nH)
    nwin = (-(-G // ws)) ** 2
    k1_flops = B * (2 * T * C * 4 * C + nwin * nH * (4 * (ws * ws) ** 2 * hd + 4 * ws ** 3 * hd))
    cases.append(("K1", f"window layer (batch-innermost order: block_ijb, block_sg){tag}",
                  "samrs_tpu_torch/csrc/window_attention.cu",
                  "samrs_tpu/kernels/fused_window_layer.py:639",
                  lambda: fused_window_layer.window_layer_attention(xn, *k1, variant="ijb"),
                  lambda: fused_window_layer.window_layer_plain(xn.float(), *k1),
                  lambda: fused_window_layer.window_layer_plain(xn, *k1),
                  2 * (2 * B * T * C + 4 * C * C), k1_flops, None))
    qkv = rn(B, T, 3 * C).bfloat16()
    k2 = (rn(G, G, hd, std=0.1), rn(G, G, hd, std=0.1), (G, G), hd ** -0.5, nH)
    q, k, v = qkv.reshape(B, T, 3, nH, hd).permute(2, 0, 3, 1, 4)
    rel_h, rel_w = flash_attention._rel_rows(q, k2[0], k2[1], (G, G))
    sdpa_mask = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(B, nH, T, T).bfloat16()
    del rel_h, rel_w
    cases.append(("K2", f"global flash attention{tag}", "samrs_tpu_torch/csrc/flash_attention.cu",
                  "samrs_tpu/kernels/flash_attention.py:343",
                  lambda: flash_attention.attention_qkv_relpos(qkv, *k2),
                  lambda: flash_attention.attention_qkv_relpos_plain(qkv.float(), *k2),
                  lambda: flash_attention.attention_qkv_relpos_plain(qkv, *k2),
                  2 * 4 * B * T * C, 4 * nH * B * T * T * hd,
                  lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask,
                                                         scale=hd ** -0.5)))
    x = rn(B * T, C)  # the encoder's fp32 residual stream
    k3 = (1.0 + rn(C, std=0.1), rn(C, std=0.1), rn(4 * C, C, std=C ** -0.5), rn(4 * C, std=0.1),
          rn(C, 4 * C, std=(4 * C) ** -0.5), rn(C, std=0.1), 1e-6)
    cases.append(("K3", f"LN-MLP-residual{tag}", "samrs_tpu_torch/csrc/gemm.cu",
                  "samrs_tpu/kernels/fused_mlp.py:249",
                  lambda: fused_mlp.ln_mlp_residual(x, *k3),
                  lambda: fused_mlp.ln_mlp_residual_plain(x, *k3, dtype=torch.float32),
                  lambda: fused_mlp.ln_mlp_residual_plain(x, *k3, dtype=torch.bfloat16),
                  2 * 4 * B * T * C + 2 * 8 * C * C, 16 * B * T * C * C, None))
    return cases, x, k3


def kernel_phase(gen: torch.Generator):
    from samrs_tpu_torch.kernels import fused_twoway, fused_upscale

    C, T = 1280, 64 * 64
    Bp, D, Ci, NTOK, NLIVE = 64, 256, 128, 16, 7  # decoder: prompts, widths, token slots
    NLIVE_MASK = 5  # the iou token and 4 mask tokens: a mask-only prompt has no sparse token

    def rn(*shape, std=1.0):  # bf16-representable fp32 values
        return (torch.randn(*shape, generator=gen, device="cuda") * std).bfloat16().float()

    cases, x, k3 = encoder_cases(gen)

    # decoder image side at bucket 64: batch-1 keys (layer 0), per-prompt keys (layer 1)
    keys1, pe = rn(1, T, D), rn(T, D)
    keysB = rn(Bp, T, D)
    keysG = rn(GEN_BUCKET, T, D)
    kvw = (rn(Ci, D, std=D ** -0.5), rn(Ci, std=0.1), rn(Ci, D, std=D ** -0.5), rn(Ci, std=0.1))
    cases.append(("K4", "decoder t2i K/V projection", "samrs_tpu_torch/csrc/twoway.cu",
                  "samrs_tpu/kernels/fused_twoway.py:192",
                  lambda: fused_twoway.t2i_kv_proj(keys1, pe, *kvw),
                  lambda: fused_twoway.t2i_kv_proj_plain(keys1, pe, *kvw, torch.float32),
                  lambda: fused_twoway.t2i_kv_proj_plain(keys1, pe, *kvw, torch.bfloat16),
                  2 * T * D * 4 + 2 * Ci * D * 2 + 2 * T * Ci * 2, 2 * 2 * T * D * Ci, None))
    def tokens(live, slots, prompts=Bp, g=gen):  # token K, V and mask bias, `live` of `slots` live
        on = torch.arange(slots, device="cuda") < live
        kv = [(torch.randn(prompts, slots, Ci, generator=g, device="cuda")).bfloat16().float()
              * on[None, :, None] for _ in range(2)]
        return (*kv, torch.where(on, 0.0, -1e9))

    i2tw = (rn(Ci, D, std=D ** -0.5), rn(Ci, std=0.1), rn(D, Ci, std=Ci ** -0.5), rn(D, std=0.1),
            1.0 + rn(D, std=0.1), rn(D, std=0.1), rn(Ci, D, std=D ** -0.5), rn(Ci, std=0.1),
            rn(Ci, D, std=D ** -0.5), rn(Ci, std=0.1), 8)
    box_tokens = tokens(NLIVE, NTOK)
    for key, title, kin, out_dt, kin_bytes, (tok_k, tok_v, mask_bias) in (
            ("K5s", "decoder i2t update, shared keys", keys1, torch.float32, T * D * 4, box_tokens),
            ("K5p", "decoder i2t update, per-prompt keys", keysB, torch.bfloat16, Bp * T * D * 4,
             box_tokens),
            ("K5w", "decoder i2t update, 21 tokens in 32 slots", keysB, torch.float32,
             Bp * T * D * 4, tokens(21, 2 * NTOK)),
            ("K5b256", f"decoder i2t update, per-prompt keys at bucket {GEN_BUCKET} (generate's "
             f"{GEN_BOXES} boxes)", keysG, torch.bfloat16, GEN_BUCKET * T * D * 4,
             tokens(NLIVE, NTOK, GEN_BUCKET)),
            # mask-only prompts (the prompt evaluation's mask modes): the iou and mask tokens
            # alone, each prompt's own dense embedding in its keys; drawn from a generator of
            # their own, so the full run's later draws stay as they were
            ("K5m", "decoder i2t update, per-prompt keys, 5 live tokens of 16 (mask-only "
             "prompts)", keysB, torch.bfloat16, Bp * T * D * 4,
             tokens(NLIVE_MASK, NTOK, g=torch.Generator(device="cuda").manual_seed(SEED + 5)))):
        S, Bk = tok_k.shape[1], tok_k.shape[0]
        row_flops = 2 * (D * Ci + 2 * S * Ci + Ci * D + 2 * D * Ci)
        small = 2 * Bk * S * Ci * 4 + 4 * Ci * D * 2
        args = (kin, pe, tok_k, tok_v, mask_bias, *i2tw)
        osz = 4 if out_dt == torch.float32 else 2
        cases.append((key, title, "samrs_tpu_torch/csrc/twoway.cu",
                      "samrs_tpu/kernels/fused_twoway.py:281",
                      lambda a=args, o=out_dt: fused_twoway.i2t_update(*a, out_dtype=o),
                      lambda a=args, o=out_dt: fused_twoway.i2t_update_plain(
                          *a, dtype=torch.float32, out_dtype=o),
                      lambda a=args, o=out_dt: fused_twoway.i2t_update_plain(
                          *a, dtype=torch.bfloat16, out_dtype=o),
                      kin_bytes + T * D * 4 + small + Bk * T * (D * osz + 2 * Ci * 2),
                      Bk * T * row_flops, None))
    upw = (rn(D, D // 4, 2, 2, std=D ** -0.5), rn(D // 4, std=0.1), 1.0 + rn(D // 4, std=0.1),
           rn(D // 4, std=0.1), rn(D // 4, D // 8, 2, 2, std=(D // 4) ** -0.5), rn(D // 8, std=0.1))
    for key, title, B6, G6, M6 in K6_CASES:
        src, hyper = rn(B6, G6, G6, D).bfloat16(), rn(B6, M6, D // 8)
        cases.append((key, title, "samrs_tpu_torch/csrc/upscale.cu",
                      "samrs_tpu/kernels/fused_upscale.py:153",
                      lambda s=src, y=hyper: fused_upscale.upscale_hyper(s, *upw, y),
                      lambda s=src, y=hyper: fused_upscale.upscale_hyper_plain(s.float(), *upw, y,
                                                                               torch.float32),
                      lambda s=src, y=hyper: fused_upscale.upscale_hyper_plain(s, *upw, y,
                                                                               torch.bfloat16),
                      B6 * G6 * G6 * D * 2 + B6 * M6 * 16 * G6 * G6 * 4,
                      2 * B6 * G6 * G6 * (D * D + D * D // 2 + 16 * (D // 8) * M6), None))
    del src, hyper

    results = run_cases(cases)
    del cases, keysB, keysG
    torch.cuda.empty_cache()
    g_ln, b_ln, w1, b1, w2, b2, eps = k3

    w1b, b1b, w2b, b2b = (t.bfloat16() for t in (w1, b1, w2, b2))  # cast once, as K3 keeps them

    def k3_composition():  # mlp_impl="xla" (ImageEncoderViT Block._mlp_xla) on the same inputs
        y = F.layer_norm(x, (C,), g_ln, b_ln, eps).bfloat16()
        y = F.gelu(F.linear(y, w1b, b1b))
        return x + F.linear(y, w2b, b2b).float()

    comp_ms = cuda_ms(k3_composition)
    results["K3"]["composition_ms"] = comp_ms
    print(f"K3 composition (mlp_impl=xla: F.layer_norm -> F.linear -> F.gelu -> F.linear, "
          f"bf16 weights cast beforehand): {comp_ms:.4f} ms against the kernel's "
          f"{results['K3']['ms']:.4f}", flush=True)
    results.update(k7_phase(gen))
    # the kernel line lists K5 once: its layer-1 (per-prompt) launch, with the
    # shared-keys mode and the 32-slot case beside it
    k5 = results.pop("K5p")
    k5["name"] = ("K5 decoder i2t update (per-prompt keys; shared-keys mode in shared_*, "
                  f"21 tokens in 32 slots in slots32_*, bucket {GEN_BUCKET} in "
                  f"bucket{GEN_BUCKET}_*, 5 live tokens (mask-only prompts) in maskonly_*)")
    for key, prefix in (("K5s", "shared"), ("K5w", "slots32"), ("K5b256", f"bucket{GEN_BUCKET}"),
                        ("K5m", "maskonly")):
        other = results.pop(key)
        k5.update({f"{prefix}_{k}": other[k] for k in ("ms", "plain_ms", "max_abs_err")})
        k5["max_abs_err"] = max(k5["max_abs_err"], other["max_abs_err"])
    results["K5"] = k5
    # the line lists K6 once: bucket 64, one token, 64x64, with its other cases beside it
    k6 = results["K6"]
    k6["name"] = ("K6 upscaling + hypernetwork dot (bucket 64, one token, 64x64 grid; the other "
                  "cases under their keys)")
    for prompts, label in ((Bp, "K6"), (GEN_BUCKET, "K6b256")):  # a model, not a measurement
        print(f"{label} elementwise floor (model: 768 GELUs a pixel x 2 MUFU ops at 16 a cycle an "
              f"SM at the highest SM clock): {gelu_floor_ms(prompts * T):.4f} ms against the "
              f"kernel's {k6['ms'] if label == 'K6' else results[label]['ms']:.4f}", flush=True)
    for key, *_ in K6_CASES[1:]:
        other = results.pop(key)
        k6.update({f"{key[2:]}_{k}": other[k] for k in ("ms", "plain_ms", "max_abs_err")})
        k6["max_abs_err"] = max(k6["max_abs_err"], other["max_abs_err"])
    return {k: results[k] for k in sorted(results)}


def gelu_floor_ms(pixels: int) -> float:
    """K6's elementwise floor: 768 GELUs a source pixel (256 after conv1, 512
    after conv2), each two special-function ops (the reciprocal and exp2 of
    the Abramowitz-Stegun erf), at 16 a cycle on each SM at the card's
    highest SM clock."""
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], check=True, capture_output=True,
                               text=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return pixels * 768 * 2 / (sms * 16 * mhz * 1e6) * 1e3


def device_ms(fn, n: int = 20, tries: int = 5):
    """torch.profiler's device time per call of each kernel `fn` launches
    ({kernel: ms}, `n` back-to-back calls after a warm one): the device rows
    only, so a CPU op is not counted beside the kernels it launched; a kernel
    is keyed by its `..._kernel` name, any other device row by its first 48
    characters.  Late in a long run the profiler drops the device record of
    a profile's first launch, the same one in every profile (a fresh process
    drops none): so one call of `fn` opens each profile, a spin kernel
    marks its end, and only the records launched after the mark (by CUPTI's
    correlation id, which grows with each launch) are counted.  The profiler
    can also lose other records, and a record's time, converted to the
    host's clock, can fall ms past the calls: so the calls sit between idle
    PROFILE_PAD_S seconds, and a profile without the mark, with a row whose
    count is not a multiple of `n`, or with another number of GEMM records
    than ``gemm.launches`` counted, is taken again, up to `tries` times;
    then ProfileLost is raised."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from samrs_tpu_torch.kernels import gemm
    fn()
    torch.cuda.synchronize()
    for i in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            fn()
            torch.cuda._sleep(1000)  # the mark
            gemms = gemm.launches
            for _ in range(n):
                fn()
            gemms = gemm.launches - gemms
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        records = [e for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA]
        marks = [e.correlation_id() for e in records if "spin_kernel" in e.name()]
        out, counts = {}, {}
        for e in records:
            if len(marks) == 1 and e.correlation_id() > marks[0]:
                m = re.search(r"\w+_kernel(<\d+>)?", e.name())
                key = m.group(0) if m else e.name()[:48]
                out[key] = out.get(key, 0.0) + e.duration_ns() / 1e6 / n
                counts[key] = counts.get(key, 0) + 1
        if (out and all(c % n == 0 for c in counts.values())
                and counts.get("gemm_wgmma_kernel", 0) == gemms):
            return out
        print(f"torch.profiler recorded {counts or 'no device time'} over {n} calls "
              f"({gemms} GEMM launches, {len(marks)} marks); profiling again", flush=True)
    raise ProfileLost(f"torch.profiler recorded no device time, or part of the calls' "
                      f"({counts}, {gemms} GEMM launches), in {tries} profiles of {n} calls")


class ProfileLost(RuntimeError):
    """Every profile of a ``device_ms`` call lost device records."""


def device_ms_or_none(label: str, fn, n: int = 20):
    """The summed ``device_ms`` of `fn`, or None (printed as not measured)
    where every profile lost records, as ``profile_step`` reports a step."""
    try:
        return sum(device_ms(fn, n=n).values())
    except ProfileLost as e:
        print(f"{label}: device time not measured ({e})", flush=True)
        return None


def run_cases(cases):
    """Each case: the kernel against its plain version in fp32 on the same
    inputs (relative L2 <= KERNEL_RTOL), then kernel, bf16 plain and library
    times and the bound."""
    results = {}
    for key, title, source, replaces, kernel, ref, plain, nbytes, flops, library in cases:
        got = as_tuple(kernel())
        torch.cuda.synchronize()
        want = as_tuple(ref())
        if [g.shape for g in got] != [w.shape for w in want]:
            raise RuntimeError(f"{key}: kernel gave {[tuple(g.shape) for g in got]}, "
                               f"plain {[tuple(w.shape) for w in want]}")
        err = rel_l2(got, want)
        max_abs = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        err_bf16 = rel_l2(got, as_tuple(plain()))
        ms = cuda_ms(kernel)
        back_to_back = loop_ms(kernel)
        plain_ms = cuda_ms(plain)
        lib_ms = cuda_ms(library) if library is not None else None
        bound_ms, bound_by = bound(nbytes, flops, "bf16")
        lib_rate = f" ({flops / lib_ms / 1e9:.1f} TFLOP/s)" if lib_ms else ""
        print(f"{key} {title}: rel_l2={err:.3e} max_abs={max_abs:.3e} "
              f"rel_l2_to_bf16_plain={err_bf16:.3e} kernel_ms={ms:.4f} "
              f"({flops / ms / 1e9:.1f} TFLOP/s) loop_ms={back_to_back:.4f} "
              f"plain_bf16_ms={plain_ms:.4f} "
              f"library_ms={lib_ms}{lib_rate} bound_ms={bound_ms:.4f} "
              f"({bound_by}, {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
        if not err <= KERNEL_RTOL:
            raise RuntimeError(f"{key}: relative L2 {err:.3e} > {KERNEL_RTOL}")
        results[key] = dict(name=f"{key} {title}", route="cuda", source=source, replaces=replaces,
                            max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=lib_ms, loop_ms=back_to_back)
        del got, want
    return results


# the encoder's dense layers at ViT-H (C 1280, T 4096): (name, N / C, K / C, GELU, fp32 residual)
GEMM_SHAPES = (("qkv", 3, 1, False, False), ("proj", 1, 1, False, True),
               ("lin1", 4, 1, True, False), ("lin2", 1, 4, False, True))


def gemm_rows(gen: torch.Generator, T: int = 4096):
    """K1 / K3's GEMM (csrc/gemm.cu) at the four dense shapes of the ViT-H
    encoder for T tokens (4096 an image) against ``linear_plain`` in fp32 on
    the same bf16 inputs, timed over back-to-back launches beside its plain
    version in bf16 and ``F.linear`` in bf16 (cuBLAS: the yardstick, never
    called by the port; it adds the bias but not the GELU or the residual)
    -> {shape name: numbers}."""
    from samrs_tpu_torch.kernels import gemm

    C = 1280
    rows = {}
    for name, nf, kf, gelu, res in GEMM_SHAPES:
        N, K = nf * C, kf * C
        x = (torch.randn(T, K, generator=gen, device="cuda")).bfloat16()
        w = (torch.randn(N, K, generator=gen, device="cuda") * K ** -0.5).bfloat16()
        b = torch.randn(N, generator=gen, device="cuda") * 0.1
        r = torch.randn(T, N, generator=gen, device="cuda") if res else None
        got = gemm.linear(x, w, b, gelu=gelu, residual=r)
        torch.cuda.synchronize()
        want = gemm.linear_plain(x.float(), w, b, gelu=gelu, residual=r)
        err = rel_l2([got], [want])
        max_abs = float((got.float() - want).abs().max())
        del got, want
        ms = loop_ms(lambda: gemm.linear(x, w, b, gelu=gelu, residual=r))
        plain_ms = loop_ms(lambda: gemm.linear_plain(x, w, b, gelu=gelu, residual=r))
        bb = b.bfloat16()
        lib_ms = loop_ms(lambda: F.linear(x, w, bb))
        flops = 2 * T * K * N
        nbytes = 2 * (T * K + N * K) + 4 * N + T * N * (8 if res else 2)
        bound_ms, bound_by = bound(nbytes, flops, "bf16")
        print(f"GEMM {name} (T {T}, N {N}, K {K}{', GELU' if gelu else ''}"
              f"{', fp32 residual' if res else ''}): rel_l2={err:.3e} max_abs={max_abs:.3e} "
              f"kernel_ms={ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s) "
              f"cublas_ms={lib_ms:.4f} ({flops / lib_ms / 1e9:.1f} TFLOP/s) "
              f"plain_bf16_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
        if not err <= KERNEL_RTOL:
            raise RuntimeError(f"GEMM {name}: relative L2 {err:.3e} > {KERNEL_RTOL}")
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                          bound_by=bound_by, max_abs_err=max_abs, tflops=flops / ms / 1e9,
                          library_tflops=flops / lib_ms / 1e9)
        del x, w, r
    torch.cuda.empty_cache()
    return rows


def gemm_phase(gen: torch.Generator):
    """The GEMM at one image's four shapes (gemm_rows) as the result line's
    entry."""
    rows = gemm_rows(gen)
    # the result line's row: the qkv shape (F.linear with its bias is the same
    # function there), the other shapes beside it
    entry = dict(name="GEMM dense layer of K1 / K3 and the globals (wgmma fed by TMA), qkv shape; "
                      "proj / lin1 / lin2 in <shape>_*",
                 route="cuda", source="samrs_tpu_torch/csrc/gemm.cu",
                 replaces="samrs_tpu/kernels/fused_mlp.py:249", **rows["qkv"])
    entry["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    for name in ("proj", "lin1", "lin2"):
        entry.update({f"{name}_{k}": v for k, v in rows[name].items()
                      if k not in ("bound_ms", "bound_by", "max_abs_err")})
    return {"GEMM": entry}


def modes_kernel_phase(gen: torch.Generator):
    """K12, K2's modes, K3's tail mode and K1's modes at the shapes of one
    ViT-H image, each against its plain version in fp32 on the same
    bf16-rounded inputs (run_cases)."""
    from samrs_tpu_torch.kernels import (flash_attention, fused_attention, fused_mlp,
                                         fused_window_block, fused_window_layer, window_attention)

    C, nH, ws, G = 1280, 16, 14, 64
    hd = C // nH
    T = G * G
    nwin = (-(-G // ws)) ** 2  # 25 windows of the padded 70 x 70 map
    n = ws * ws

    def rn(*shape, std=1.0):  # bf16-representable fp32 values
        return (torch.randn(*shape, generator=gen, device="cuda") * std).bfloat16().float()

    cases = []

    # the cases at heads of 64 and window_attention_relpos draw from a generator of their own,
    # so that every later phase builds the same weights as without them
    own = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def split_case(key, title, replaces, Bq, kh, kw, d=hd, source=gen):
        N = kh * kw
        form = window_attention.split_form(N, kh, kw)
        rs = lambda *shape, std=1.0: (torch.randn(*shape, generator=source, device="cuda")
                                      * std).bfloat16().float()
        q, k, v = (rs(Bq, N, d).bfloat16() for _ in range(3))
        rh, rw = rs(Bq, N, kh, std=0.5), rs(Bq, N, kw, std=0.5)
        mask = (rh[..., :, None] + rw[..., None, :]).reshape(Bq, N, N).bfloat16()
        args = (rh, rw, d ** -0.5)
        cases.append((key, f"{title} ({form} form, head {d})", SPLIT_SOURCES[form], replaces,
                      lambda: window_attention.split_attention(q, k, v, *args),
                      lambda: window_attention.split_attention_plain(q.float(), k.float(),
                                                                     v.float(), *args),
                      lambda: window_attention.split_attention_plain(q, k, v, *args),
                      3 * Bq * N * d * 2 + Bq * N * (kh + kw) * 4 + Bq * N * d * 4,
                      4 * Bq * N * N * d,
                      lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                             scale=d ** -0.5)))

    def relpos_case(key, title, Bq, g):
        """window_attention_relpos end to end: the rel-row kernel reading bf16
        q in place, then K12, against the plain route in fp32."""
        N = g * g
        form = window_attention.split_form(N, g, g)
        rs = lambda *shape, std=1.0: (torch.randn(*shape, generator=own, device="cuda")
                                      * std).bfloat16().float()
        q, k, v = (rs(Bq, N, hd).bfloat16() for _ in range(3))
        Rh, Rw = rs(g, g, hd, std=0.1), rs(g, g, hd, std=0.1)
        args = (Rh, Rw, (g, g), hd ** -0.5)
        cases.append((key, f"{title} ({form} form, rel rows on the card)", SPLIT_SOURCES[form],
                      "samrs_tpu/kernels/window_attention.py:83",
                      lambda: window_attention.window_attention_relpos(q, k, v, *args),
                      lambda: window_attention.window_attention_relpos_plain(
                          q.float(), k.float(), v.float(), *args),
                      lambda: window_attention.window_attention_relpos_plain(q, k, v, *args),
                      3 * Bq * N * hd * 2 + 2 * g * g * hd * 4 + Bq * N * hd * 4,
                      4 * Bq * N * N * hd + 4 * Bq * N * g * hd, None))

    for d, sfx, source in ((hd, "", gen), (64, "d64", own)):
        split_case(f"K12{sfx}", "split-head rel-pos attention, ViT-H windows",
                   "samrs_tpu/kernels/window_attention.py:83", nwin * nH, ws, ws, d, source)
        split_case(f"K12g{sfx}", "split-head rel-pos attention, ViT-H globals",
                   "samrs_tpu/kernels/flash_attention.py:105", nH, G, G, d, source)
        split_case(f"K12s1024{sfx}", "split-head rel-pos attention, 32x32 grid (image_size 512)",
                   "samrs_tpu/kernels/window_attention.py:83", nH, 32, 32, d, source)
        split_case(f"K12s256{sfx}", "split-head rel-pos attention, 16x16 grid (image_size 256)",
                   "samrs_tpu/kernels/window_attention.py:83", nH, 16, 16, d, source)
    relpos_case("K12rpw", "window_attention_relpos, ViT-H windows", nwin * nH, ws)
    relpos_case("K12rp32", "window_attention_relpos, 32x32 grid", nH, 32)

    def k2_case(key, title, replaces, variant, g):
        N = g * g
        qkv = rn(1, N, 3 * C).bfloat16()
        args = (rn(g, g, hd, std=0.1), rn(g, g, hd, std=0.1), (g, g), hd ** -0.5, nH)
        q, k, v = qkv.reshape(1, N, 3, nH, hd).permute(2, 0, 3, 1, 4)
        rel_h, rel_w = flash_attention._rel_rows(q, args[0], args[1], (g, g))
        mask = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(1, nH, N, N).bfloat16()
        del rel_h, rel_w
        cases.append((key, title, "samrs_tpu_torch/csrc/flash_attention.cu", replaces,
                      lambda: flash_attention.attention_qkv_relpos(qkv, *args, variant=variant),
                      lambda: flash_attention.attention_qkv_relpos_plain(qkv.float(), *args,
                                                                         variant=variant),
                      lambda: flash_attention.attention_qkv_relpos_plain(qkv, *args,
                                                                         variant=variant),
                      2 * 4 * N * C, 4 * nH * N * N * hd,
                      lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                             scale=hd ** -0.5)))

    k2_case("K2split", "global flash attention, mode split", "samrs_tpu/kernels/flash_attention.py:239",
            "split", G)
    k2_case("K2exp2", "global flash attention, mode exp2 (base-2 softmax)",
            "samrs_tpu/kernels/flash_attention.py:239", "exp2", G)
    k2_case("K2aug", "global flash attention, mode aug (q*scale and rel rows rounded to bf16)",
            "samrs_tpu/kernels/flash_attention.py:454", "aug", G)
    k2_case("K2w48", "global flash attention, 48x48 grid (image_size 768, key tiles straddle rows)",
            "samrs_tpu/kernels/flash_attention.py:343", "m", 48)

    Hp = -(-G // ws) * ws
    att_p = rn(1, Hp, Hp, C).bfloat16()
    sc = rn(1, G, G, C)
    k3 = (1.0 + rn(C, std=0.1), rn(C, std=0.1), rn(4 * C, C, std=C ** -0.5), rn(4 * C, std=0.1),
          rn(C, 4 * C, std=(4 * C) ** -0.5), rn(C, std=0.1), 1e-6)
    cases.append(("K3t", f"LN-MLP-residual tail mode ({Hp}^2 padded map cropped to {G}^2)",
                  "samrs_tpu_torch/csrc/gemm.cu", "samrs_tpu/kernels/fused_mlp.py:413",
                  lambda: fused_mlp.fused_tail_ln_mlp_residual(att_p, sc, *k3),
                  lambda: fused_mlp.fused_tail_ln_mlp_residual_plain(att_p.float(), sc, *k3,
                                                                     dtype=torch.float32),
                  lambda: fused_mlp.fused_tail_ln_mlp_residual_plain(att_p, sc, *k3,
                                                                     dtype=torch.bfloat16),
                  T * C * (2 + 4 + 4) + 2 * 8 * C * C, 16 * T * C * C, None))

    xn = rn(1, G, G, C).bfloat16()
    k1 = (rn(3 * C, C, std=C ** -0.5), rn(3 * C, std=0.5), rn(C, C, std=C ** -0.5),
          rn(C, std=0.1), rn(ws, ws, hd, std=0.1), rn(ws, ws, hd, std=0.1), ws, hd ** -0.5, nH)
    attn_flops = nwin * nH * (4 * n * n * hd + 4 * ws ** 3 * hd)
    k1_bytes, k1_flops = 2 * (2 * T * C + 4 * C * C), 2 * T * C * 4 * C + attn_flops
    layer = fused_window_layer.window_layer_attention
    plain = fused_window_layer.window_layer_plain
    src = "samrs_tpu_torch/csrc/window_attention.cu"
    for key, title, replaces, kw in (
            ("K1blk", "window layer, plain window order (block, block_slab)",
             "samrs_tpu/kernels/fused_window_layer.py:639", dict(variant=None)),
            ("K1row", "window layer, one block per window row (block_row)",
             "samrs_tpu/kernels/fused_window_layer.py:568", dict(variant="row")),
            ("K1q", "window layer, qkv GEMM outside (blockq; plain order)",
             "samrs_tpu/kernels/fused_window_layer.py:305", dict(variant="qkv_out")),
            ("K1pad", "window layer, padded map out (tail_impl=fused)",
             "samrs_tpu/kernels/fused_window_layer.py:639",
             dict(variant="ijb", return_padded=True))):
        cases.append((key, title, src, replaces,
                      lambda kw=kw: layer(xn, *k1, **kw),
                      lambda kw=kw: plain(xn.float(), *k1, **kw),
                      lambda kw=kw: plain(xn, *k1, **kw), k1_bytes, k1_flops, None))
    res = rn(1, G, G, C)
    cases.append(("K1r", "window layer, residual in the projection (block2)", src,
                  "samrs_tpu/kernels/fused_window_layer.py:457",
                  lambda: fused_window_layer.window_layer_attention_residual(res, xn, *k1),
                  lambda: plain(xn.float(), *k1, residual=res),
                  lambda: plain(xn, *k1, residual=res), k1_bytes + 2 * T * C * 4, k1_flops, None))
    def window_sdpa(qkv_map, fill):
        """SDPA on the map's partitioned windows (pad tokens filled with
        `fill`) with the window rel-pos bias as its mask: the yardstick of
        the attention stage, built as the K12 windows case builds its inputs."""
        Bq, Hq, Wq = qkv_map.shape[:3]
        Hp, Wp = -(-Hq // ws) * ws, -(-Wq // ws) * ws
        full = fill.bfloat16().expand(Bq, Hp, Wp, 3 * C).clone()
        full[:, :Hq, :Wq] = qkv_map
        wins = full.reshape(Bq, Hp // ws, ws, Wp // ws, ws, 3, nH, hd)
        wins = wins.permute(5, 0, 1, 3, 6, 2, 4, 7)
        q, k, v = (t.reshape(-1, nH, n, hd).contiguous() for t in wins)
        rq = q.float().reshape(-1, nH, ws, ws, hd)
        rel_h = torch.einsum("wnxyd,xud->wnxyu", rq, k1[4])
        rel_w = torch.einsum("wnxyd,yvd->wnxyv", rq, k1[5])
        mask = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(-1, nH, n, n).bfloat16()
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=hd ** -0.5)

    qkv_map = rn(1, G, G, 3 * C).bfloat16()
    pf = (k1[4], k1[5], ws, hd ** -0.5, nH)
    bq = k1[1]
    cases.append(("K1pf", "window attention stage on the raw qkv map (fused2)", src,
                  "samrs_tpu/kernels/fused_window_block.py:246",
                  lambda: fused_window_block.window_attention_partition_free(qkv_map, *pf,
                                                                             pad_fill=bq),
                  lambda: fused_window_block.window_attention_partition_free_plain(
                      qkv_map.float(), *pf, pad_fill=bq),
                  lambda: fused_window_block.window_attention_partition_free_plain(
                      qkv_map, *pf, pad_fill=bq),
                  T * 4 * C * 2, attn_flops, window_sdpa(qkv_map, bq)))
    qkv_win = rn(nwin, n, 3 * C).bfloat16()
    fa = (k1[4], k1[5], (ws, ws), hd ** -0.5, nH)
    cases.append(("K1w", "window attention on partitioned windows (fused)", src,
                  "samrs_tpu/kernels/fused_attention.py:114",
                  lambda: fused_attention.attention_qkv_fused(qkv_win, *fa),
                  lambda: fused_attention.attention_qkv_fused_plain(qkv_win.float(), *fa),
                  lambda: fused_attention.attention_qkv_fused_plain(qkv_win, *fa),
                  nwin * n * 4 * C * 2, attn_flops,
                  window_sdpa(qkv_win.reshape(nwin, ws, ws, 3 * C),
                              torch.zeros(3 * C, device="cuda"))))
    results = run_cases(cases)
    torch.cuda.empty_cache()
    return results


def _config_launches(knobs):
    """Launches per image of the ViT-H encoder under the SamConfig `knobs`."""
    want = {"K1": 28, "K2": 4, "K3": 32}
    impl = knobs.get("window_attn_impl")
    if impl in ("pallas", "xla", "fused", "fused2"):
        del want["K1"]
        want.update({"pallas": {"K12": 28}, "xla": {"K12": 4}, "fused": {"K1w": 28},
                     "fused2": {"K1pf": 28}}[impl])
        if impl == "xla":
            del want["K2"]
    if knobs.get("tail_impl") == "fused":
        want.update(K3=4, K3t=28)
    if knobs.get("mlp_impl") == "xla":
        del want["K3"]
    return want


# the encoder's kernel configurations: (label, SamConfig knobs)
CONFIGS = [("default", {})]
CONFIGS += [(f"window_attn_impl={v}", dict(window_attn_impl=v))
            for v in ("pallas", "xla", "fused", "fused2", "block", "block_row", "blockq",
                      "block2", "block_slab", "block_sg")]
CONFIGS += [(f"global_attn_impl={v}", dict(global_attn_impl=v)) for v in ("split", "exp2", "aug")]
CONFIGS += [("tail_impl=fused", dict(tail_impl="fused")), ("mlp_impl=xla", dict(mlp_impl="xla"))]
CONFIG_REPS = 7


def configs_phase(model, gen: torch.Generator, device_time: bool = False):
    """The ViT-H encoder on one 1024^2 image under every kernel
    configuration, from the weights of `model`: launches per image, encoder
    ms (CUDA events, median of CONFIG_REPS; also over 5 back-to-back calls)
    and the feature rel-L2 against the default configuration (<=
    FEATURE_RTOL).  With `device_time` also the device time of every kernel
    of a call summed by torch.profiler (one call's events carry the host's
    dispatch where it falls behind); a partial run only, since late in a
    full run the profiler loses records."""
    from samrs_tpu_torch.sam.image_encoder import ImageEncoderViT

    c = model.cfg
    x = torch.randn(1, c.image_size, c.image_size, 3, generator=gen, device="cuda")
    state = model.image_encoder.state_dict()
    out, ref = {}, None
    for label, knobs in CONFIGS:
        with torch.device("cuda"):
            enc = ImageEncoderViT(
                img_size=c.image_size, patch_size=c.patch_size, embed_dim=c.encoder_embed_dim,
                depth=c.encoder_depth, num_heads=c.encoder_num_heads,
                out_chans=c.prompt_embed_dim, window_size=c.window_size,
                global_attn_indexes=c.encoder_global_attn_indexes, **knobs)
        enc.load_state_dict(state, strict=True)
        enc.eval()
        with torch.no_grad():
            reset_counts()
            feats = enc(x, True)
            torch.cuda.synchronize()
            counts = {k: v for k, v in read_counts().items() if v}
            ms = cuda_ms(lambda: enc(x, True), warmup=1, reps=CONFIG_REPS)
            back_to_back = loop_ms(lambda: enc(x, True), n=5, warmup=1)
            device = (sum(device_ms(lambda: enc(x, True), n=2).values()) if device_time
                      else None)
        want = _config_launches(knobs)
        if ref is None:
            ref = feats
        err = rel_l2([feats], [ref])
        dev = f" device_ms={device:.3f}" if device_time else ""
        print(f"config {label}: encoder_ms={ms:.3f} loop_ms={back_to_back:.3f}{dev} "
              f"feature_rel_l2_vs_default={err:.3e} launches={counts}", flush=True)
        if counts != want:
            raise RuntimeError(f"config {label}: launches {counts} != {want}")
        if not (torch.isfinite(feats).all() and err <= FEATURE_RTOL):
            raise RuntimeError(f"config {label}: feature rel-L2 {err:.3e} > {FEATURE_RTOL}")
        out[label] = dict(ms=ms, loop_ms=back_to_back, rel_l2=err, launches=counts)
        if device_time:
            out[label]["device_ms"] = device
        del enc, feats
    torch.cuda.empty_cache()
    return out


# the generator at other image sizes: global grids of 32^2 and 16^2 tokens take
# K12 (query-tiled form); at 768 (48^2 = 2304 tokens) K2 with key
# tiles that straddle grid rows
SIZE_GEN_LAUNCHES = {**GEN_LAUNCHES, "K2": 0, "K12": 4}


def sizes_phase(gen: torch.Generator, profile: bool = False):
    """generate_phase at image_size 512 and 256 (kernels against plain), then
    main_path at image_size 768; each ViT-H freed before the next."""
    counts = {}
    for size, run in ((512, "generate"), (256, "generate"), (768, "main")):
        model = build_model(gen, image_size=size)
        if run == "generate":
            counts[size] = generate_phase(model, want=SIZE_GEN_LAUNCHES)
        else:
            counts[size] = main_path(model, profile=profile)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return counts


def k7_compare(label: str, low, inp, orig, img_size: int, mt: float, off: float):
    """K7 on `low` (M, g, g) against its plain version by K7's rule: the bits
    equal except at pixels whose plain logit lies within K7_NEAR of the
    threshold, hi / lo within the counts of pixels that near mt + off / mt -
    off, the kernel's boxes those of its own bits (equal to the plain ones
    unless a pixel is near the threshold); prints the near and flipped
    counts -> (largest count or box difference, the kernel's packed bits)."""
    from samrs_tpu_torch.kernels import amg_post

    M, g, _ = low.shape
    Ho, Wo = orig
    hi, lo, boxes, packed = amg_post.amg_postprocess(low, inp, orig, img_size, mt, off)
    torch.cuda.synchronize()
    hi_p, lo_p, boxes_p, packed_p = amg_post.amg_postprocess_plain(low, inp, orig, img_size, mt,
                                                                    off)
    wy = torch.from_numpy(amg_post._composed_axis(g, img_size, inp[0], Ho)).cuda()
    wx = torch.from_numpy(amg_post._composed_axis(g, img_size, inp[1], Wo)).cuda()
    logits = (wy @ low) @ wx.T
    near = (logits - mt).abs() < K7_NEAR
    near_hi = ((logits - mt - off).abs() < K7_NEAR).sum((-1, -2))
    near_lo = ((logits - mt + off).abs() < K7_NEAR).sum((-1, -2))
    del logits
    shifts = torch.arange(7, -1, -1, device="cuda", dtype=torch.uint8)
    unpack = lambda p: ((p[..., None] >> shifts) & 1).reshape(M, Ho, -1)[..., :Wo].bool()
    bits, bits_p = unpack(packed), unpack(packed_p)
    flips = int((bits != bits_p).sum())
    flips_far = int(((bits != bits_p) & ~near).sum())
    hi_ok = bool(((hi - hi_p).abs() <= near_hi).all())
    lo_ok = bool(((lo - lo_p).abs() <= near_lo).all())
    own_boxes = amg_post._boxes_from_masks(bits)
    box_diff = int((boxes - boxes_p).abs().max())
    max_abs = max(int((hi - hi_p).abs().max()), int((lo - lo_p).abs().max()), box_diff)
    print(f"K7 {label}: {int(near.sum())} pixels within {K7_NEAR} of the threshold "
          f"({int(near_hi.sum())} / {int(near_lo.sum())} of threshold +- offset), {flips} bits "
          f"differ ({flips_far} elsewhere), hi/lo within the near counts {hi_ok}/{lo_ok}, "
          f"max |box diff| {box_diff}", flush=True)
    if flips_far or not (hi_ok and lo_ok) or not torch.equal(boxes, own_boxes):
        raise RuntimeError(f"K7 {label}: disagrees with its plain version")
    if box_diff and not near.any():
        raise RuntimeError(f"K7 {label}: boxes differ with no pixel near the threshold")
    return max_abs, packed


def k7_phase(gen: torch.Generator):
    from samrs_tpu_torch.kernels import amg_post

    g, img_size, mt, off = 256, 1024, 0.0, 1.0
    low32 = (torch.randn(32, g, g, generator=gen, device="cuda") * 4.0).contiguous()
    # the automatic mask generator's chunk on a generator of its own (the full run's later
    # draws, the models' weights among them, stay as they were)
    amg_gen = torch.Generator(device="cuda").manual_seed(SEED + AMG_MASKS)
    low_amg = (torch.randn(AMG_MASKS, g, g, generator=amg_gen, device="cuda") * 4.0).contiguous()
    out = {}
    # the generator's chunk to DIOR's 800^2, the main path's 768x1024, a DOTA-v2-sized 7000^2
    # scene, whose row and column tables outgrow shared memory (read from global), and the
    # automatic mask generator's chunk of 64 prompts x 3 masks to 1024^2
    for key, low, inp, orig in (("gen", low32, (1024, 1024), GEN_HW),
                                ("main", low32, IMAGE_HW, IMAGE_HW),
                                ("wide", low32[:8], (1024, 1024), K7_WIDE_HW),
                                ("amg", low_amg, AMG_HW, AMG_HW)):
        M = low.shape[0]
        tables = amg_post._smem_layout(g, orig[0], orig[1],
                                       amg_post._band_rows(g, img_size, inp[0], orig[0]))[1]
        if tables != (orig != K7_WIDE_HW):
            raise RuntimeError(f"K7 {orig}: tables in shared memory {tables}, want the opposite")
        print(f"K7 {M} masks {inp}->{orig}: tables in shared memory {tables}", flush=True)
        max_abs, packed = k7_compare(f"{M} masks {inp}->{orig}", low, inp, orig, img_size, mt, off)
        run = lambda: amg_post.amg_postprocess(low, inp, orig, img_size, mt, off)
        plain = lambda: amg_post.amg_postprocess_plain(low, inp, orig, img_size, mt, off)
        ms, plain_ms = cuda_ms(run), cuda_ms(plain)
        dev_ms, wall_ms = device_ms(run).get("amg_post_kernel"), loop_ms(run)
        if dev_ms is None:
            raise RuntimeError("K7: torch.profiler recorded no time for amg_post_kernel")
        # flops this data needs: the nonzero taps of both banded stages
        Ho, Wo = orig
        nnz_y = int((amg_post._composed_axis(g, img_size, inp[0], Ho) != 0).sum())
        nnz_x = int((amg_post._composed_axis(g, img_size, inp[1], Wo) != 0).sum())
        flops = M * 2 * (nnz_y * g + nnz_x * Ho)
        nbytes = M * g * g * 4 + packed.numel() + M * 6 * 4
        bound_ms, bound_by = bound(nbytes, flops, "fp32")
        print(f"K7 {M} masks to {orig}: kernel_ms={ms:.4f} device_ms={dev_ms:.5f} "
              f"wall_ms={wall_ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} "
              f"({bound_by}, {nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP)", flush=True)
        out[key] = dict(max_abs_err=max_abs, ms=ms, device_ms=dev_ms, wall_ms=wall_ms,
                        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        del packed
    del low_amg
    torch.cuda.empty_cache()
    r = dict(out["gen"], max_abs_err=max(o["max_abs_err"] for o in out.values()))
    wide = "x".join(map(str, K7_WIDE_HW))
    amg = f"{'x'.join(map(str, AMG_HW))}_{AMG_MASKS}masks"
    return {"K7": dict(name="K7 full-resolution mask postprocess (32 masks to 800x800; ms one "
                            "call, device_ms its kernel alone, wall_ms 20 back-to-back calls; the "
                            f"automatic mask generator's chunk under {amg}_*)",
                       route="cuda", source="samrs_tpu_torch/csrc/amg_post.cu",
                       replaces="samrs_tpu/kernels/amg_post.py:140", library_ms=None,
                       **{f"{k}_768x1024": out["main"][k] for k in ("ms", "device_ms", "wall_ms")},
                       **{f"{k}_{wide}_8masks": out["wide"][k] for k in ("ms", "device_ms")},
                       **{f"{k}_{amg}": out["amg"][k] for k in (
                           "ms", "device_ms", "wall_ms", "plain_ms", "bound_ms", "bound_by")},
                       **r)}


def k8_case(gen, BG, H, W, Gc, P, K, dtype, coords):
    """Seeded inputs of one K8 call: xg (BG, H, W*Gc) in `dtype`; fx, fy, mask
    (BG, P, K); dout (BG, P, Gc).  coords: "window" (generic, some taps off
    the map), "integer" (the identity grid on exact pixel centres) or
    "deform" (taps around each output pixel, some off the map), "dcn"
    (DCNv3's 3x3 base grid, P = H*W and K 9, plus offsets up to 1.5 px, as
    InternImage's levels) or "dcn0" (the base grid alone: every tap on a
    pixel, as at InternImage's initialisation)."""
    dev = "cuda"
    xg = torch.randn(BG, H, W * Gc, generator=gen, device=dev).to(dtype)
    u = lambda *s: torch.rand(*s, generator=gen, device=dev)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                            indexing="ij")
    ys, xs = ys.reshape(1, -1, 1).float(), xs.reshape(1, -1, 1).float()
    if coords in ("dcn", "dcn0"):
        from samrs_tpu_torch.kernels import bilinear_gather as bg

        bx, by = (torch.from_numpy(b).to(dev) for b in
                  bg._dcnv3_base_grid(H, W, 3, 3, 1, 1, 1, 1, 1, 1))
        off = (lambda: u(BG, P, K) * 3 - 1.5) if coords == "dcn" else (lambda: 0.0)
        fx, fy = bx.expand(BG, P, K) + off(), by.expand(BG, P, K) + off()
    elif coords == "integer":
        fx, fy = xs.expand(BG, P, K), ys.expand(BG, P, K)
    elif coords == "window":
        fx = u(BG, P, K) * (W + 2.0) - 1.5
        fy = u(BG, P, K) * (H + 2.0) - 1.5
    else:  # deform: a 3x3 ring around each output pixel plus offsets of up to 2.5 px
        ring = torch.arange(K, device=dev)
        fx = xs + (ring % 3 - 1) + (u(BG, P, K) * 5 - 2.5)
        fy = ys + (ring // 3 - 1) + (u(BG, P, K) * 5 - 2.5)
    mask = (torch.ones(BG, P, K, device=dev) if K == 1 and coords in ("window", "integer")
            else u(BG, P, K))
    dout = torch.randn(BG, P, Gc, generator=gen, device=dev)
    return xg, fx.contiguous(), fy.contiguous(), mask.contiguous(), dout


def k8_cases(gen, cases, loop: bool = False):
    """K8 forward and backward against sample_weighted_plain at each case
    (key, BG, H, W, Gc, P, K, dtype, coords): errors, times, the bound, the
    dX reductions counted on the card; raises on a bound missed.  Under
    `loop` also the kernel's and the plain version's ms a call over 20
    back-to-back calls (``*_loop_ms``: a call shorter than its wrapper's
    host work is not timed as that host work).  Returns {key: results}."""
    from samrs_tpu_torch.kernels import bilinear_gather as bg

    names = ("out", "dxg", "dfx", "dfy", "dmask")
    out = {}
    for key, BGc, H, W, Gc, P, K, dtype, coords in cases:
        xg, fx, fy, mask, dout = k8_case(gen, BGc, H, W, Gc, P, K, dtype, coords)
        got = [bg.sample_weighted_fwd_cuda(xg, fx, fy, mask, Gc)]
        got += list(bg.sample_weighted_bwd_cuda(xg, fx, fy, mask, dout, Gc))
        torch.cuda.synchronize()
        leaves = [t.clone().requires_grad_() for t in (xg, fx, fy, mask)]
        ref = bg.sample_weighted_plain(*leaves, Gc)
        want = [ref.detach()] + list(torch.autograd.grad(ref, leaves, dout, retain_graph=True))
        errs = {n: rel_l2([g], [w]) for n, g, w in zip(names, got, want)}
        max_abs = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        fwd_max_abs = float((got[0] - want[0]).abs().max())
        # the forward rounds op by op in the plain version's order: equal bits in fp32
        fwd_equal = bool(torch.equal(got[0], want[0]))
        esz = xg.element_size()
        n_in = BGc * H * W * Gc * esz + 3 * BGc * P * K * 4
        fwd_bytes, fwd_ops = n_in + BGc * P * Gc * 4, BGc * P * K * Gc * 10
        bwd_bytes = n_in + BGc * P * Gc * 4 + BGc * H * W * Gc * esz + 3 * BGc * P * K * 4
        bwd_ops = BGc * P * K * Gc * 24
        fwd_ms = cuda_ms(lambda: bg.sample_weighted_fwd_cuda(xg, fx, fy, mask, Gc))
        bwd_ms = cuda_ms(lambda: bg.sample_weighted_bwd_cuda(xg, fx, fy, mask, dout, Gc))
        plain_fwd_ms = cuda_ms(lambda: bg.sample_weighted_plain(xg, fx, fy, mask, Gc))
        plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(ref, leaves, dout, retain_graph=True))
        loops = {}
        if loop:
            loops = dict(
                fwd_loop_ms=loop_ms(lambda: bg.sample_weighted_fwd_cuda(xg, fx, fy, mask, Gc)),
                bwd_loop_ms=loop_ms(lambda: bg.sample_weighted_bwd_cuda(xg, fx, fy, mask, dout,
                                                                        Gc)),
                plain_fwd_loop_ms=loop_ms(lambda: bg.sample_weighted_plain(xg, fx, fy, mask, Gc)),
                plain_bwd_loop_ms=loop_ms(lambda: torch.autograd.grad(ref, leaves, dout,
                                                                      retain_graph=True)))
            print(f"K8 {key} over 20 back-to-back calls, ms a call: kernel fwd "
                  f"{loops['fwd_loop_ms']:.4f} bwd {loops['bwd_loop_ms']:.4f}, plain fwd "
                  f"{loops['plain_fwd_loop_ms']:.4f} bwd {loops['plain_bwd_loop_ms']:.4f}",
                  flush=True)
        lib = {}
        if K == 1:  # F.grid_sample computes K8 at one tap (a yardstick; the port never calls it)
            img = xg.reshape(BGc, H, W, Gc).permute(0, 3, 1, 2).contiguous().requires_grad_()
            grid = torch.stack([fx[..., 0] / (W - 1) * 2 - 1, fy[..., 0] / (H - 1) * 2 - 1], -1)
            # the map's own grid (RVSA), or one row of P points (the shared point sample)
            gshape = (BGc, H, W, 2) if P == H * W else (BGc, 1, P, 2)
            grid = grid.reshape(gshape).to(img.dtype).requires_grad_()
            gs = lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                       align_corners=True)
            y = gs()
            g_out = dout.reshape(BGc, *gshape[1:3], Gc).permute(0, 3, 1, 2).to(y.dtype)
            lib["fwd"] = cuda_ms(gs)
            lib["bwd"] = cuda_ms(lambda: torch.autograd.grad(y, (img, grid), g_out,
                                                             retain_graph=True))
            lib["fwd_bwd"] = cuda_ms(lambda: torch.autograd.grad(gs(), (img, grid), g_out))
            del img, grid, y, g_out
        fb, fby = bound(fwd_bytes, fwd_ops, "fp32")
        bb, bby = bound(bwd_bytes, bwd_ops, "fp32")
        # dX reductions the kernel issued, counted on the card in a launch of their own,
        # against the first version's per-channel scatter (Gc scalar atomics for every
        # corner on the map) and against one reduction a channel vector (4 channels where
        # Gc % 4 == 0) for every corner on the map of nonzero weight
        nred = torch.zeros(1, dtype=torch.int64, device=xg.device)
        bg.sample_weighted_bwd_cuda(xg, fx, fy, mask, dout, Gc, reductions=nred)
        n_red = int(nred.item())
        wx, wy, corners = bg._corners(fx, fy, H, W)
        weights = ((1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy)
        n_scalar = sum(int(v.sum()) for _, v in corners) * Gc
        n_nonzero = sum(int((v & (w != 0) & (mask != 0)).sum())
                        for (_, v), w in zip(corners, weights))
        n_most = n_nonzero * (Gc // 4 if Gc % 4 == 0 else Gc)
        print(f"K8 {key} (BG {BGc}, {H}x{W}, Gc {Gc}, P {P}, K {K}, {str(dtype)[6:]}): rel_l2 "
              + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
              + f" max_abs={max_abs:.3e}; fwd max_abs={fwd_max_abs:.3e} bits equal to plain "
              f"{fwd_equal}; fwd kernel/plain/F.grid_sample ms {fwd_ms:.4f}/"
              f"{plain_fwd_ms:.4f}/{lib.get('fwd')} ({fwd_bytes / fwd_ms / 1e6:.1f} GB/s), "
              f"bound {fb:.4f} ({fby}; bytes {fwd_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms of "
              f"{fwd_bytes / 1e6:.1f} MB, operations {fwd_ops / PEAK['fp32'] * 1e3:.4f} ms); "
              f"bwd kernel/plain/library ms {bwd_ms:.4f}/"
              f"{plain_bwd_ms:.4f}/{lib.get('bwd')} ({bwd_bytes / bwd_ms / 1e6:.1f} GB/s), "
              f"bound {bb:.4f} ({bby}; bytes {bwd_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms of "
              f"{bwd_bytes / 1e6:.1f} MB, operations {bwd_ops / PEAK['fp32'] * 1e3:.4f} ms); "
              f"library fwd+bwd ms {lib.get('fwd_bwd')}; bwd dX reductions issued (device "
              f"count) {n_red / (BGc * P * K):.2f} a tap against {n_scalar / (BGc * P * K):.2f} "
              f"per-channel ({n_scalar / max(n_red, 1):.1f}x fewer), at most "
              f"{n_most / (BGc * P * K):.2f} with zero-weight corners skipped", flush=True)
        if Gc % 4 == 0 and n_scalar < 4 * n_red:
            raise RuntimeError(f"K8 {key}: {n_red} backward reductions, not 4x fewer than the "
                               f"{n_scalar} per-channel ones")
        if n_red > n_most:
            raise RuntimeError(f"K8 {key}: {n_red} backward reductions, more than the {n_most} "
                               f"of the corners of nonzero weight")
        if dtype == torch.float32 and not fwd_equal:
            raise RuntimeError(f"K8 {key}: the fp32 forward differs from the plain version's "
                               f"bits (max abs {fwd_max_abs:.3e})")
        for n, e in errs.items():
            tol = K8_RTOL
            if coords in ("integer", "dcn0") and n == "dfx":
                tol = K8_INT_RTOL
            elif dtype == torch.bfloat16 and n == "dxg":
                tol = K8_BF16_DXG_RTOL
            if not e <= tol:
                raise RuntimeError(f"K8 {key}: {n} relative L2 {e:.3e} > {tol}")
        out[key] = dict(max_abs_err=max_abs, fwd_max_abs_err=fwd_max_abs, fwd_ms=fwd_ms,
                        bwd_ms=bwd_ms, plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms,
                        fwd_bound=(fb, fby), bwd_bound=(bb, bby), lib=lib, errs=errs,
                        fwd_gbps=fwd_bytes / fwd_ms / 1e6,
                        reductions_per_tap=n_red / (BGc * P * K), **loops)
        del xg, fx, fy, mask, dout, got, want, leaves, ref
        torch.cuda.empty_cache()
    return out


def k8_phase(gen):
    """K8 forward and backward against sample_weighted_plain on the same
    inputs: the RVSA shape of the FAST head (K and V of 65 x 12 heads in one
    launch, Gc 128; also Gc 64, one of K or V) in fp32 and with a bf16 xg, a
    DCNv3-shaped case, and the identity grid on exact integers; InternImage-T's
    four DCNv3 levels at the FAST head (BG 260 .. 2080, 56^2 .. 7^2, Gc 16,
    the 3x3 base grid plus offsets up to 1.5 px) and level 0 with zero
    offsets (every tap on a pixel, as at initialisation); Mask2Former's MSDA
    level and shared point sample.  Each backward line prints its GB/s, the
    bytes and the operations bound and F.grid_sample's time where one call
    computes the function (K 1: the RVSA grid, the shared point sample over a
    (BG, 1, P, 2) grid)."""
    from samrs_tpu_torch.kernels import bilinear_gather as bg

    BG = TRAIN_BATCH[2] * 12
    cases = [("rvsa", BG, 14, 14, 128, 196, 1, torch.float32, "window"),
             ("rvsa_bf16", BG, 14, 14, 128, 196, 1, torch.bfloat16, "window"),
             ("rvsa_gc64", BG, 14, 14, 64, 196, 1, torch.float32, "window"),
             ("dcnv3", 12 * 4, 56, 56, 16, 56 * 56, 9, torch.float32, "deform"),
             ("identity", BG, 14, 14, 128, 196, 1, torch.float32, "integer"),
             # Mask2Former at the FAST head: one MSDeformAttn level (65 x 8 heads, the 28^2
             # level, head dim 32, 1029 queries, 4 points) and the shared matching sample
             # of the 100 mask logits and of the 37 gt masks at 12544 points
             ("msda_l28", TRAIN_BATCH[2] * 8, 28, 28, 32, 1029, 4, torch.float32, "window"),
             ("shared_masks", TRAIN_BATCH[2], 56, 56, 100, M2F_POINTS, 1, torch.float32,
              "window"),
             ("shared_gt", TRAIN_BATCH[2], 56, 56, 37, M2F_POINTS, 1, torch.float32, "window")]
    cases += [(f"ii_l{lvl}", TRAIN_BATCH[2] * G, 56 >> lvl, 56 >> lvl, II_GC, (56 >> lvl) ** 2, 9,
               torch.float32, "dcn") for lvl, G in enumerate(II_GROUPS)]
    cases += [("ii_l0_zero", TRAIN_BATCH[2] * II_GROUPS[0], 56, 56, II_GC, 56 * 56, 9,
               torch.float32, "dcn0")]
    out = k8_cases(gen, cases)
    # every form of the forward off the paths' shapes: flat-4 at odd Gc with 1 / 4 / 9 taps,
    # one output a thread at Gc 1, 8-byte vectors at Gc 6, the runtime tap loop at K 2 and 3;
    # fp32 and bf16 maps
    for Gc, K in ((37, 9), (5, 4), (3, 1), (1, 1), (1, 9), (6, 9), (6, 2), (16, 3)):
        for dtype in (torch.float32, torch.bfloat16):
            xg, fx, fy, mask, _ = k8_case(gen, 7, 9, 11, Gc, 61, K, dtype, "window")
            got = bg.sample_weighted_fwd_cuda(xg, fx, fy, mask, Gc)
            want = bg.sample_weighted_plain(xg, fx, fy, mask, Gc)
            if not torch.equal(got, want):
                raise RuntimeError(f"K8 fwd at Gc {Gc}, K {K}, {dtype}: bits differ from the "
                                   f"plain version (max abs {float((got - want).abs().max()):.3e})")
    print("K8 fwd forms (Gc 37 / 5 / 3 / 1 / 1 / 6 / 6 / 16, K 9 / 4 / 1 / 1 / 9 / 9 / 2 / 3, "
          "fp32 and bf16): bits equal to the plain version", flush=True)
    r = out["rvsa"]
    common = dict(route="cuda", source="samrs_tpu_torch/csrc/bilinear_gather.cu")
    extra = lambda d: {f"{k}_ms": out[k][f"{d}_ms"] for k in out if k != "rvsa"}
    extra_lib = lambda d: {f"{k}_library_ms": out[k]["lib"][d]
                           for k in out if k != "rvsa" and out[k]["lib"]}
    fwd_extra = {f"{k}_{n}": out[k][n] for k in out for n in ("fwd_max_abs_err", "fwd_gbps")}
    # (counted on the card in this run)
    reductions = {f"{k}_reductions_per_tap": o["reductions_per_tap"] for k, o in out.items()}
    fwd = dict(name="K8 fwd weighted bilinear gather, a thread a (query, channel vector) "
                    "(RVSA FAST head: BG 780, 14x14, Gc 128, K 1, fp32; bf16 / Gc 64 / DCNv3 "
                    "shapes, Mask2Former's MSDA level (BG 520, 28x28, Gc 32, P 1029, K 4) and "
                    "shared point sample (BG 65, 56x56, Gc 100 / 37, P 12544), InternImage-T's "
                    "levels in ii_l*, in *_ms; library_ms: F.grid_sample at one tap)",
               replaces="samrs_tpu/kernels/bilinear_gather.py:386", **common,
               max_abs_err=r["fwd_max_abs_err"], ms=r["fwd_ms"],
               plain_ms=r["plain_fwd_ms"], bound_ms=r["fwd_bound"][0],
               bound_by=r["fwd_bound"][1], library_ms=r["lib"]["fwd"], gbps=r["fwd_gbps"],
               **extra("fwd"), **extra_lib("fwd"), **fwd_extra)
    bwd = dict(name="K8 bwd weighted bilinear gather (dxg by 16-byte vector reductions, "
                    "zero-weight corners skipped; dfx, dfy, dmask; same shapes, InternImage-T's "
                    "levels in ii_l*, level 0 with zero offsets in ii_l0_zero; library_ms: "
                    "F.grid_sample backward, library_fwd_bwd_ms: forward + backward)",
               replaces="samrs_tpu/kernels/bilinear_gather.py:467", **common,
               max_abs_err=r["max_abs_err"], ms=r["bwd_ms"],
               plain_ms=r["plain_bwd_ms"], bound_ms=r["bwd_bound"][0],
               bound_by=r["bwd_bound"][1], library_ms=r["lib"]["bwd"],
               library_fwd_bwd_ms=r["lib"]["fwd_bwd"], **extra("bwd"), **extra_lib("bwd"),
               **reductions)
    return {"K8f": fwd, "K8b": bwd}


def k9_case(gen, N, H, W, K, coords):
    """Seeded inputs of one K9 call: img (N, H, W) fp32; fx, fy (N, K) in
    pixels, xy (N, K, 2) in [0, 1] (the coordinate entry's); dout (N, K).
    coords: "loss" (xy uniform in [0, 1), as the point loss draws them, and
    fx, fy from them by ``pixel_coords``, the arithmetic the coordinate entry
    does), "integer" (pixel centres, some on the last row and column and one
    off each side) or "off" (a margin of 3 pixels off every side); for the
    last two xy = (f + 0.5) / size."""
    from samrs_tpu_torch.kernels import bilinear_gather as bg
    dev = "cuda"
    img = torch.randn(N, H, W, generator=gen, device=dev)
    u = lambda: torch.rand(N, K, generator=gen, device=dev)
    if coords == "loss":
        xy = torch.rand(N, K, 2, generator=gen, device=dev)
        fx, fy = bg.pixel_coords(xy, H, W)
    else:
        if coords == "integer":
            fx = torch.floor(u() * (W + 2)) - 1
            fy = torch.floor(u() * (H + 2)) - 1
        else:
            fx, fy = u() * (W + 6) - 3.5, u() * (H + 6) - 3.5
        xy = torch.stack([(fx + 0.5) / W, (fy + 0.5) / H], -1)
    return img, fx, fy, xy, torch.randn(N, K, generator=gen, device=dev)


def k9_check(key, names, got, want, fwd: bool):
    """K9 against its plain version: the forward bit for bit (max abs 0), the
    gradients within K9_RTOL (dimg's atomics reorder fp32 sums); returns
    ({name: rel-L2}, max abs)."""
    errs = {n: rel_l2([g], [w]) for n, g, w in zip(names, got, want)}
    max_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if fwd and max_abs != 0.0:
        raise RuntimeError(f"K9 {key}: forward differs from the plain version (max abs "
                           f"{max_abs:.3e}): it must equal it bit for bit")
    for n, e in errs.items():
        if not e <= K9_RTOL:
            raise RuntimeError(f"K9 {key}: {n} relative L2 {e:.3e} > {K9_RTOL}")
    return errs, max_abs


GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "child graph",
                    5: "empty", 6: "event wait", 7: "event record", 8: "semaphore signal",
                    9: "semaphore wait", 10: "mem alloc", 11: "mem free", 12: "batch mem op",
                    13: "conditional"}  # the driver's CUgraphNodeType


def graph_node_types(fn) -> list[str]:
    """The type of every node of a CUDA graph captured from one call of `fn`
    (after a warm call on a side stream, as torch.cuda.graph asks), read
    from the driver: each kernel, copy and memset the call puts on the
    device, whether its records reach a profiler or not."""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)

    def check(code):
        if code != 0:
            raise RuntimeError(f"reading the captured CUDA graph: CUresult {code}")

    check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)))
    types = []
    for node in nodes[:n.value]:
        t = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(node, ctypes.byref(t)))
        types.append(GRAPH_NODE_TYPES.get(t.value, f"type {t.value}"))
    del g
    return types


def k9_only_launches(label: str, fn, want: dict) -> None:
    """Raise unless K9 is every kernel one call of `fn` launches: a CUDA
    graph of the call holds as many kernel nodes as the port's launch
    counts rose by, those counts rose by `want` ({"K9f": n, "K9b": n}) and
    nothing else, and it holds no copy, memset or host node.  (A graph, not
    torch.profiler: late in a full run the profiler lost kernel records at
    random, ours and PyTorch's alike, while the launches were on its host
    side.)"""
    from samrs_tpu_torch.kernels import gemm
    before, gemm_before = read_counts(), gemm.launches
    types = graph_node_types(fn)
    rose = {k: v - before[k] for k, v in read_counts().items() if v != before[k]}
    # the warm call and the captured one each count once
    want2 = {k: 2 * v for k, v in want.items()}
    work = [t for t in types if t not in ("empty", "event wait", "event record")]
    if (rose != want2 or gemm.launches != gemm_before
            or work != ["kernel"] * sum(want.values())):
        raise RuntimeError(f"{label}: the port's counts rose by {rose} over a warm and a "
                           f"captured call (want {want2}; GEMM {gemm.launches - gemm_before}), "
                           f"the call's graph holds {types}: it launched other work than K9")
    print(f"{label}: launches K9 only (a CUDA graph of one call holds {types}; the port's "
          f"counts rose by {want} a call)", flush=True)


def k9_phase(gen):
    """K9 forward and backward, both entries (pixel fx / fy; [0, 1] coords,
    the Mask2Former path's) against their plain versions on the same inputs:
    the FAST head's point losses (6500 masks of 56x56 at 12544 points and at
    the 37632 uncertainty candidates), a 256x256 map (the device-memory
    forward, the banded backward),
    points on exact integers and points off the map.  Forwards must equal
    the plain versions bit for bit; dimg (and dfx, dfy, dcoords) are held to
    K9_RTOL in both backward forms: dimg alone (the path's) and with the
    coordinate gradient.  At the three point-loss shapes each form is timed
    (CUDA events, one call at a time; and over 20 back-to-back calls)
    against its plain version and F.grid_sample (one
    channel, align_corners=False; its backward for the input alone, and for
    the input and the grid), with its bound.  Then one mask2former.point_sample call
    with the kernels, forward and backward, must launch K9 and nothing else
    (read from a CUDA graph of the call)."""
    from samrs_tpu_torch.kernels import bilinear_gather as bg
    from samrs_tpu_torch.seg.decoders import mask2former as m2f

    N = TRAIN_BATCH[2] * 100
    cases = [("fast", N, 56, 56, M2F_POINTS, "loss"), ("fast_candidates", N, 56, 56, 3 * M2F_POINTS,
                                                        "loss"),
             ("map256", 300, 256, 256, M2F_POINTS, "loss"), ("integer", 650, 56, 56, 4096, "integer"),
             ("off_map", 650, 56, 56, 4096, "off"), ("integer_map256", 40, 256, 256, 4096, "integer")]
    out, max_abs = {}, 0.0
    for key, Nc, H, W, K, coords in cases:
        img, fx, fy, xy, dout = k9_case(gen, Nc, H, W, K, coords)
        plan = {g: bg.point_sample_plan(Nc, H, W, K, 4, g, bg._sms(img.device))
                for g in (None, False, True)}
        # the pixel entry: forward, backward with dfx / dfy, backward of dimg alone
        got = [bg.point_sample_fwd_cuda(img, fx, fy)] + list(bg.point_sample_bwd_cuda(
            img, fx, fy, dout)) + [bg.point_sample_bwd_cuda(img, fx, fy, dout, False)[0]]
        torch.cuda.synchronize()
        want = [bg.point_sample_plain_fwd(img, fx, fy)] + list(bg.point_sample_plain_bwd(
            img, fx, fy, dout))
        want.append(want[1])
        errs, m0 = k9_check(key, ["out"], got[:1], want[:1], True)
        e1, m1 = k9_check(key, ["dimg", "dfx", "dfy", "dimg_path"], got[1:], want[1:], False)
        errs.update(e1)
        del got, want
        # the coordinate entry: forward, backward with dcoords, backward of dimg alone
        c_img = img.clone().requires_grad_()
        c_xy = xy.clone().requires_grad_()
        want = [bg.point_sample_coords_plain(c_img, c_xy)]
        want += list(torch.autograd.grad(want[0], (c_img, c_xy), dout))
        want = [w.detach() for w in want] + [want[1].detach()]
        got = [bg.point_sample_coords_fwd_cuda(img, xy)] + list(bg.point_sample_coords_bwd_cuda(
            img, xy, dout, True)) + [bg.point_sample_coords_bwd_cuda(img, xy, dout)[0]]
        torch.cuda.synchronize()
        e2, m2 = k9_check(key + " coords", ["c_out"], got[:1], want[:1], True)
        e3, m3 = k9_check(key + " coords", ["c_dimg", "c_dcoords", "c_dimg_path"], got[1:],
                          want[1:], False)
        errs.update(e2)
        errs.update(e3)
        max_abs = max(max_abs, m0, m1, m2, m3)
        del got, want, c_img, c_xy
        print(f"K9 {key} (N {Nc}, {H}x{W}, K {K}; forms fwd {plan[None]}, bwd {plan[False]}, "
              f"bwd with coordinate gradient {plan[True]}): rel_l2 "
              + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
              + f"; forward max abs {max(m0, m2):.1e}", flush=True)
        if coords != "loss":
            del img, fx, fy, xy, dout
            torch.cuda.empty_cache()
            continue
        fwd_bytes = 4 * (Nc * H * W + 3 * Nc * K)
        path_bytes = 4 * (Nc * H * W + 3 * Nc * K)
        grad_bytes = 4 * (2 * Nc * H * W + 5 * Nc * K)
        r = dict(fwd_bound=bound(fwd_bytes, 22 * Nc * K, "fp32"),
                 path_bound=bound(path_bytes, 20 * Nc * K, "fp32"),
                 grad_bound=bound(grad_bytes, 34 * Nc * K, "fp32"))
        r["fwd_ms"] = cuda_ms(lambda: bg.point_sample_coords_fwd_cuda(img, xy))
        r["path_ms"] = cuda_ms(lambda: bg.point_sample_coords_bwd_cuda(img, xy, dout))
        r["coords_grad_ms"] = cuda_ms(lambda: bg.point_sample_coords_bwd_cuda(img, xy, dout, True))
        r["pixel_fwd_ms"] = cuda_ms(lambda: bg.point_sample_fwd_cuda(img, fx, fy))
        r["grad_ms"] = cuda_ms(lambda: bg.point_sample_bwd_cuda(img, fx, fy, dout))
        r["pixel_path_ms"] = cuda_ms(lambda: bg.point_sample_bwd_cuda(img, fx, fy, dout, False))
        r["plain_fwd_ms"] = cuda_ms(lambda: bg.point_sample_coords_plain(img, xy))
        r["plain_path_ms"] = cuda_ms(lambda: bg.point_sample_plain_bwd(img, fx, fy, dout, False))
        r["plain_grad_ms"] = cuda_ms(lambda: bg.point_sample_plain_bwd(img, fx, fy, dout))
        # F.grid_sample computes K9 on a one-channel (N, 1, H, W) map at a (N, 1, K) grid
        lib_img = img[:, None].clone().requires_grad_()
        grid = (2 * xy - 1)[:, None].requires_grad_()
        gs = lambda: F.grid_sample(lib_img, grid, mode="bilinear", padding_mode="zeros",
                                   align_corners=False)
        lib_err = rel_l2([gs().detach()[:, 0, 0]], [bg.point_sample_coords_plain(img, xy)])
        y = gs()
        r["lib_fwd"] = cuda_ms(gs)
        r["lib_path"] = cuda_ms(lambda: torch.autograd.grad(y, lib_img, dout[:, None, None],
                                                            retain_graph=True))
        r["lib_grad"] = cuda_ms(lambda: torch.autograd.grad(y, (lib_img, grid), dout[:, None, None],
                                                            retain_graph=True))
        # 20 back-to-back calls between events: the card stays busy, so a call's host work
        # (which one call at a time above includes) hides behind the one before
        r["fwd_loop_ms"] = loop_ms(lambda: bg.point_sample_coords_fwd_cuda(img, xy))
        r["path_loop_ms"] = loop_ms(lambda: bg.point_sample_coords_bwd_cuda(img, xy, dout))
        r["grad_loop_ms"] = loop_ms(lambda: bg.point_sample_bwd_cuda(img, fx, fy, dout))
        r["lib_fwd_loop_ms"] = loop_ms(gs)
        r["lib_path_loop_ms"] = loop_ms(lambda: torch.autograd.grad(
            y, lib_img, dout[:, None, None], retain_graph=True))
        r["lib_grad_loop_ms"] = loop_ms(lambda: torch.autograd.grad(
            y, (lib_img, grid), dout[:, None, None], retain_graph=True))
        del y, lib_img, grid
        print(f"K9 {key} back-to-back ms, kernel / F.grid_sample: fwd "
              f"{r['fwd_loop_ms']:.4f} / {r['lib_fwd_loop_ms']:.4f}; bwd dimg alone "
              f"{r['path_loop_ms']:.4f} / {r['lib_path_loop_ms']:.4f}; bwd with the coordinate "
              f"gradient {r['grad_loop_ms']:.4f} / {r['lib_grad_loop_ms']:.4f}", flush=True)
        print(f"K9 {key} times, ms (F.grid_sample out rel_l2 {lib_err:.3e}): fwd coords / pixel "
              f"entry / plain / library {r['fwd_ms']:.4f} / {r['pixel_fwd_ms']:.4f} / "
              f"{r['plain_fwd_ms']:.4f} / {r['lib_fwd']:.4f}, bound {r['fwd_bound'][0]:.4f} "
              f"({fwd_bytes / 1e6:.1f} MB); bwd dimg alone coords / pixel entry / plain / "
              f"library {r['path_ms']:.4f} / {r['pixel_path_ms']:.4f} / {r['plain_path_ms']:.4f} / "
              f"{r['lib_path']:.4f}, bound {r['path_bound'][0]:.4f} ({path_bytes / 1e6:.1f} MB); "
              f"bwd with the coordinate gradient pixel entry (dfx, dfy) / coords (dcoords) / "
              f"plain / library {r['grad_ms']:.4f} / {r['coords_grad_ms']:.4f} / "
              f"{r['plain_grad_ms']:.4f} / {r['lib_grad']:.4f}, bound {r['grad_bound'][0]:.4f} "
              f"({grad_bytes / 1e6:.1f} MB)", flush=True)
        out[key] = r
        if key == "fast":  # the path's call through the caller, with the kernels
            logits = img.clone().requires_grad_()
            k9_only_launches("mask2former.point_sample forward (N 6500, 56x56, K 12544)",
                             lambda: m2f.point_sample(logits, xy), {"K9f": 1})
            k9_only_launches("mask2former.point_sample forward and backward",
                             lambda: torch.autograd.grad(m2f.point_sample(logits, xy), logits,
                                                         dout), {"K9f": 1, "K9b": 1})
            del logits
        del img, fx, fy, xy, dout
        torch.cuda.empty_cache()
    r = out["fast"]
    common = dict(route="cuda", source="samrs_tpu_torch/csrc/point_sample.cu", max_abs_err=max_abs)
    extra = lambda names: {f"{k}_{n}": out[k][n] for k in ("fast_candidates", "map256")
                           for n in names}
    fwd = dict(name="K9 fwd per-mask point sample, coordinate entry (FAST head: N 6500, 56x56, "
                    "K 12544, fp32 coords in [0, 1]; the 37632 candidates and a 256x256 map "
                    "(device-memory form) in fast_candidates_* / map256_*; pixel_fwd_ms: the fx / fy "
                    "entry; library: F.grid_sample on (N, 1, H, W))",
               replaces="samrs_tpu/kernels/bilinear_gather.py:762", **common, ms=r["fwd_ms"],
               plain_ms=r["plain_fwd_ms"], bound_ms=r["fwd_bound"][0], bound_by=r["fwd_bound"][1],
               library_ms=r["lib_fwd"], pixel_fwd_ms=r["pixel_fwd_ms"],
               loop_ms=r["fwd_loop_ms"], library_loop_ms=r["lib_fwd_loop_ms"],
               **extra(("fwd_ms", "pixel_fwd_ms", "plain_fwd_ms", "lib_fwd", "fwd_loop_ms",
                        "lib_fwd_loop_ms")))
    bwd = dict(name="K9 bwd per-mask point sample, the path's form: dimg alone from the "
                    "coordinate entry (same shapes; library: F.grid_sample backward for the "
                    "input); grad_*: with dfx, dfy (pixel entry; library for input and grid), "
                    "coords_grad_ms: with dcoords",
               replaces="samrs_tpu/kernels/bilinear_gather.py:786", **common, ms=r["path_ms"],
               plain_ms=r["plain_path_ms"], bound_ms=r["path_bound"][0],
               bound_by=r["path_bound"][1], library_ms=r["lib_path"],
               pixel_path_ms=r["pixel_path_ms"], grad_ms=r["grad_ms"],
               grad_plain_ms=r["plain_grad_ms"], grad_library_ms=r["lib_grad"],
               coords_grad_ms=r["coords_grad_ms"],
               loop_ms=r["path_loop_ms"], library_loop_ms=r["lib_path_loop_ms"],
               grad_loop_ms=r["grad_loop_ms"], grad_library_loop_ms=r["lib_grad_loop_ms"],
               **extra(("path_ms", "plain_path_ms", "lib_path", "grad_ms", "plain_grad_ms",
                        "lib_grad", "path_loop_ms", "lib_path_loop_ms", "grad_loop_ms",
                        "lib_grad_loop_ms")))
    return {"K9f": fwd, "K9b": bwd}


def msda_phase(gen):
    """The MSDeformAttn wrapper (one K8 launch a level) forward and backward
    against its plain route at the pixel decoder's FAST-head shapes (65
    images, 8 heads of 32, levels 7^2 / 14^2 / 28^2, 1029 queries, 4 points),
    rel-L2 <= K8_RTOL, with the times of both."""
    from samrs_tpu_torch.kernels import bilinear_gather as bg

    B, nH, D, P = TRAIN_BATCH[2], 8, 32, 4
    levels = [(7, 7), (14, 14), (28, 28)]
    S = sum(h * w for h, w in levels)
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    value = rn(B, S, nH, D)
    loc = (torch.rand(B, S, nH, 3, P, 2, generator=gen, device="cuda") * 1.2 - 0.1)
    wts = torch.rand(B, S, nH, 3, P, generator=gen, device="cuda").softmax(-1)
    dout = rn(B, S, nH * D)
    res = {}
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (value, loc, wts)]
        o = bg.ms_deform_attn(leaves[0], levels, leaves[1], leaves[2], plain=plain)
        res[plain] = [o.detach()] + list(torch.autograd.grad(o, leaves, dout))
    torch.cuda.synchronize()
    errs = {n: rel_l2([a], [b]) for n, a, b in zip(("out", "dvalue", "dloc", "dweights"),
                                                     res[False], res[True])}
    timed = {}
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (value, loc, wts)]
        f = lambda: bg.ms_deform_attn(leaves[0], levels, leaves[1], leaves[2], plain=plain)
        timed[plain] = (cuda_ms(lambda: f().detach()),
                        cuda_ms(lambda: torch.autograd.grad(f(), leaves, dout)))
    print(f"MSDA wrapper (B {B}, {nH} heads of {D}, levels {levels}, Q {S}, P {P}): kernels vs "
          f"plain rel_l2 " + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
          + f"; fwd kernels/plain ms {timed[False][0]:.4f}/{timed[True][0]:.4f}, fwd+bwd "
          f"{timed[False][1]:.4f}/{timed[True][1]:.4f}", flush=True)
    for n, e in errs.items():
        if not e <= K8_RTOL:
            raise RuntimeError(f"MSDA wrapper: {n} relative L2 {e:.3e} > {K8_RTOL}")
    del value, loc, wts, dout, res
    torch.cuda.empty_cache()
    return dict(fwd_ms=timed[False][0], plain_fwd_ms=timed[True][0], fwd_bwd_ms=timed[False][1],
                plain_fwd_bwd_ms=timed[True][1])


def slab_case(gen, BG, H, W, Gc, P, K, dtype, coords):
    """Seeded inputs of one K8-slab call: ``k8_case``'s, or for coords "dcn"
    DCNv3's 3x3 base grid (P = H*W, K 9) plus offsets of up to 1.5 px, as
    InternImage's levels; "dcn_far" the same with the taps k = 7, 8 of every
    query moved H/2 rows into the other half of the map (down from the top
    half, up from the bottom one), so that two of the nine taps land away
    from the rest."""
    if coords not in ("dcn", "dcn_far"):
        return k8_case(gen, BG, H, W, Gc, P, K, dtype, coords)
    from samrs_tpu_torch.kernels import bilinear_gather as bg

    xg, _, _, mask, dout = k8_case(gen, BG, H, W, Gc, P, K, dtype, "window")
    bx, by = (torch.from_numpy(b).cuda() for b in bg._dcnv3_base_grid(H, W, 3, 3, 1, 1, 1, 1,
                                                                      1, 1))
    u = lambda: torch.rand(BG, P, K, generator=gen, device="cuda") * 3 - 1.5
    fx, fy = bx + u(), by + u()
    if coords == "dcn_far":
        row = torch.arange(P, device="cuda").reshape(1, P, 1) // W
        fy[..., 7:] += torch.where(row < H // 2, H // 2, -(H // 2))
    return xg, fx.contiguous(), fy.contiguous(), mask, dout


def k8_slab_phase(gen):
    """K8's row-slab form (slab height 7 but where a case says otherwise)
    forward and backward against dense K8 and against sample_weighted_plain
    on the same inputs: InternImage-T's four DCNv3 levels at the FAST head
    (65 images x G 4/8/16/32, 56^2 .. 7^2, Gc 16, 9 taps around each pixel
    with offsets up to 1.5 px) in fp32 and level 0 with a bf16 map;
    Mask2Former's MSDeformAttn level (BG 520, 28^2, Gc 32, 1029 queries, 4
    taps anywhere on the map); a scattered case whose every slab is active
    (a 64^2 map over a stage: nothing staged), with taps off the map; a map
    whose slab exceeds a stage (1024 wide); one with Gc 6 in bf16 (rows not
    16-byte aligned); a DCNv3 map of 112^2 (Gc 8) with two of the nine taps
    of every query moved half the map away (``slab_case`` "dcn_far"), so that
    taps read the band and device memory in one launch; and a DCNv3 level
    at Gc 5 (the flat-4 form).  The forward's counting build
    (``sample_weighted_slab_routes_cuda``) counts the (query, tap) pairs it
    read from the band and from device memory: every pair once, and the
    off-band case must have both kinds.  The forward must equal dense K8's
    (rel-L2 <= K8_SLAB_FWD_RTOL; the design keeps K8's per-tap order, so 0 is
    expected); the backward within K8's bounds of the plain version.  Timed
    (CUDA events: one call at a time, and 20 back to back) beside dense K8
    and the plain version, with the bound."""
    from samrs_tpu_torch.kernels import bilinear_gather as bg

    B = TRAIN_BATCH[2]
    cases = [(f"ii_l{lvl}", B * G, 56 >> lvl, 56 >> lvl, II_GC, (56 >> lvl) ** 2, 9,
              torch.float32, "dcn", II_SLAB) for lvl, G in enumerate(II_GROUPS)]
    cases += [("ii_l0_bf16", B * II_GROUPS[0], 56, 56, II_GC, 56 * 56, 9, torch.bfloat16, "dcn",
               II_SLAB),
              ("msda_l28", B * 8, 28, 28, 32, 1029, 4, torch.float32, "window", II_SLAB),
              ("scatter", 64, 64, 64, 16, 1000, 4, torch.float32, "window", 8),
              ("wide", 4, 8, 1024, 16, 2000, 4, torch.float32, "window", 2),
              ("gc6_bf16", 8, 16, 20, 6, 300, 3, torch.bfloat16, "window", 4),
              ("dcn_far", 64, 112, 112, 8, 112 * 112, 9, torch.float32, "dcn_far", II_SLAB),
              ("dcn_gc5", 16, 14, 14, 5, 14 * 14, 9, torch.float32, "dcn", II_SLAB)]
    names = ("out", "dxg", "dfx", "dfy", "dmask")
    out = {}
    for key, BGc, H, W, Gc, P, K, dtype, coords, Hs in cases:
        xg, fx, fy, mask, dout = slab_case(gen, BGc, H, W, Gc, P, K, dtype, coords)
        args = (xg, fx, fy, mask)
        counted, band, device = bg.sample_weighted_slab_routes_cuda(*args, Gc, Hs)
        got = [bg.sample_weighted_slab_fwd_cuda(*args, Gc, Hs)]
        got += list(bg.sample_weighted_slab_bwd_cuda(*args, dout, Gc, Hs))
        dense = [bg.sample_weighted_fwd_cuda(*args, Gc)]
        dense += list(bg.sample_weighted_bwd_cuda(*args, dout, Gc))
        torch.cuda.synchronize()
        leaves = [t.clone().requires_grad_() for t in args]
        ref = bg.sample_weighted_plain(*leaves, Gc)
        want = [ref.detach()] + list(torch.autograd.grad(ref, leaves, dout, retain_graph=True))
        errs = {n: rel_l2([g], [w]) for n, g, w in zip(names, got, want)}
        vs_dense = {n: rel_l2([g], [d]) for n, g, d in zip(names, got, dense)}
        fwd_equal = bool(torch.equal(got[0], dense[0]) and torch.equal(counted, dense[0]))
        max_abs = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        esz = xg.element_size()
        n_in = BGc * H * W * Gc * esz + 3 * BGc * P * K * 4
        fwd_bytes, fwd_ops = n_in + BGc * P * Gc * 4, BGc * P * K * Gc * 10
        bwd_bytes = n_in + BGc * P * Gc * 4 + BGc * H * W * Gc * esz + 3 * BGc * P * K * 4
        bwd_ops = BGc * P * K * Gc * 24
        calls = dict(fwd=lambda: bg.sample_weighted_slab_fwd_cuda(*args, Gc, Hs),
                     bwd=lambda: bg.sample_weighted_slab_bwd_cuda(*args, dout, Gc, Hs),
                     dense_fwd=lambda: bg.sample_weighted_fwd_cuda(*args, Gc),
                     dense_bwd=lambda: bg.sample_weighted_bwd_cuda(*args, dout, Gc))
        t = {k: cuda_ms(fn) for k, fn in calls.items()}
        t.update({f"{k}_loop": loop_ms(fn) for k, fn in calls.items()})
        t.update(plain_fwd=cuda_ms(lambda: bg.sample_weighted_plain(*args, Gc)),
                 plain_bwd=cuda_ms(lambda: torch.autograd.grad(ref, leaves, dout,
                                                               retain_graph=True)))
        fb, fby = bound(fwd_bytes, fwd_ops, "fp32")
        bb, bby = bound(bwd_bytes, bwd_ops, "fp32")
        print(f"K8-slab {key} (BG {BGc}, {H}x{W}, Gc {Gc}, P {P}, K {K}, Hs {Hs}, "
              f"{str(dtype)[6:]}): forward taps read from the band {band}, from device "
              f"memory {device} (counted by the kernel); vs plain rel_l2 "
              + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
              + f" max_abs={max_abs:.3e}; vs dense K8 rel_l2 "
              + " ".join(f"{n}={e:.3e}" for n, e in vs_dense.items())
              + f" (forward bit-equal {fwd_equal}); fwd slab/dense/plain ms {t['fwd']:.4f}/"
              f"{t['dense_fwd']:.4f}/{t['plain_fwd']:.4f}, loop slab/dense {t['fwd_loop']:.4f}/"
              f"{t['dense_fwd_loop']:.4f}, bound {fb:.4f} ({fby}); bwd "
              f"slab/dense/plain ms {t['bwd']:.4f}/{t['dense_bwd']:.4f}/{t['plain_bwd']:.4f}, "
              f"loop slab/dense {t['bwd_loop']:.4f}/{t['dense_bwd_loop']:.4f}, "
              f"bound {bb:.4f} ({bby})", flush=True)
        if not vs_dense["out"] <= K8_SLAB_FWD_RTOL:
            raise RuntimeError(f"K8-slab {key}: forward vs dense K8 relative L2 "
                               f"{vs_dense['out']:.3e} > {K8_SLAB_FWD_RTOL}")
        for n, e in errs.items():
            tol = K8_BF16_DXG_RTOL if dtype == torch.bfloat16 and n == "dxg" else K8_RTOL
            if not e <= tol:
                raise RuntimeError(f"K8-slab {key}: {n} relative L2 {e:.3e} > {tol}")
        if band + device != BGc * P * K:
            raise RuntimeError(f"K8-slab {key}: the counting build took {band} + {device} "
                               f"(query, tap) pairs, not each of {BGc * P * K} once")
        if coords == "dcn_far" and not (band > 0 and device > 0):
            raise RuntimeError(f"K8-slab {key}: taps read from the band {band}, from device "
                               f"memory {device}: want both routes")
        out[key] = dict(max_abs_err=max_abs, fwd_bound=(fb, fby), bwd_bound=(bb, bby),
                        fwd_equal=fwd_equal, **t)
        del xg, fx, fy, mask, dout, args, got, counted, dense, want, leaves, ref
        torch.cuda.empty_cache()
    r = out["ii_l0"]
    common = dict(route="cuda", source="samrs_tpu_torch/csrc/bilinear_slab.cu", library_ms=None,
                  max_abs_err=max(o["max_abs_err"] for o in out.values()))
    extra = lambda d: {**{f"{k}_ms": out[k][d] for k in out if k != "ii_l0"},
                       **{f"{k}_loop_ms": out[k][f"{d}_loop"] for k in out},
                       **{f"{k}_dense_ms": out[k][f"dense_{d}"] for k in out},
                       **{f"{k}_dense_loop_ms": out[k][f"dense_{d}_loop"] for k in out},
                       **{f"{k}_plain_ms": out[k][f"plain_{d}"] for k in out if k != "ii_l0"}}
    fwd = dict(name="K8-slab fwd weighted bilinear gather from a band of row slabs staged by "
                    "bulk copies (InternImage-T level 0 at the FAST head: BG 260, 56x56, Gc 16, "
                    "K 9, Hs 7, fp32; the other levels, bf16, the MSDA level and the scattered / "
                    "wide / Gc 6 / off-band / Gc 5 cases in *_ms, 20 back-to-back launches in "
                    "*_loop_ms, dense K8 in *_dense_ms; no single library call)",
               replaces="samrs_tpu/kernels/bilinear_gather.py:164", **common, ms=r["fwd"],
               plain_ms=r["plain_fwd"], bound_ms=r["fwd_bound"][0], bound_by=r["fwd_bound"][1],
               forward_bit_equal_dense=all(o["fwd_equal"] for o in out.values()), **extra("fwd"))
    bwd = dict(name="K8-slab bwd (dense K8's backward kernel on the slab's shapes: a group of "
                    "lanes a query, dX by 16-byte device reductions; dfx, dfy, dmask; same "
                    "shapes)",
               replaces="samrs_tpu/kernels/bilinear_gather.py:419",
               **{**common, "source": "samrs_tpu_torch/csrc/bilinear_tap.cuh"}, ms=r["bwd"],
               plain_ms=r["plain_bwd"], bound_ms=r["bwd_bound"][0], bound_by=r["bwd_bound"][1],
               **extra("bwd"))
    return {"K8sf": fwd, "K8sb": bwd}


def k11_case(gen, label: str, T: int, C: int, M: int):
    """K11 at (T, C, M) against its plain version in fp32, forward and the
    autograd backward (rel-L2 <= K10_K11_RTOL); timed (CUDA events) against
    the plain version and the F.linear -> F.gelu -> F.linear composition,
    with TFLOP/s (counting 4 T C M) and both bounds: the split-TF32 tensor
    work the kernel does (3 x 4 T C M at 495 TFLOP/s; the least time, and so
    its ``bound``) and the fp32 CUDA-core one (4 T C M at 67 TFLOP/s, on the
    log line).  ``ms`` reuses the weights' tf32 halves (a forward after the
    first of a step); ``cold_ms`` gives the weights a new version before
    each call, so it also splits them, as the first forward after an
    optimizer step does.  Where the wrapper keeps the hidden on chip (C 64 /
    96 / 128) the two-launch form is also held to the plain version, timed, and
    compared with the fused one (not at C 96, which has no two-launch
    form).  ``loop_ms``: 20 back-to-back calls."""
    from samrs_tpu_torch.kernels import fused_mlp as fm

    rn = lambda *shape, std=1.0: torch.randn(*shape, generator=gen, device="cuda") * std
    x, dy = rn(T, C), rn(T, C)
    w = (rn(M, C, std=C ** -0.5), rn(M, std=0.1), rn(C, M, std=M ** -0.5), rn(C, std=0.1))
    leaves = [t.clone().requires_grad_() for t in (x, *w)]
    got = fm.fused_mlp(*leaves)
    got = [got.detach()] + list(torch.autograd.grad(got, leaves, dy))
    ref = fm.fused_mlp_plain(*leaves)
    want = [ref.detach()] + list(torch.autograd.grad(ref, leaves, dy))
    errs = {n: rel_l2([a], [b]) for n, a, b in zip(("out", "dx", "dw1", "db1", "dw2", "db2"),
                                                    got, want)}
    max_abs = float((got[0] - want[0]).abs().max())
    extra = {}
    if fm.hidden_on_chip(C) and C % 64 == 0:  # C 96 has no two-launch form
        two = fm.fused_mlp_cuda(x, *w, on_chip=False)
        errs["out_two_launch"] = rel_l2([two], [want[0]])
        extra = dict(two_launch_ms=cuda_ms(lambda: fm.fused_mlp_cuda(x, *w, on_chip=False)),
                     two_launch_max_diff=float((two - got[0]).abs().max()))
        del two
    ms = cuda_ms(lambda: fm.fused_mlp_cuda(x, *w))
    back_to_back = loop_ms(lambda: fm.fused_mlp_cuda(x, *w))

    def cold():
        for t in (w[0], w[2]):
            torch.autograd.graph.increment_version(t)
        return fm.fused_mlp_cuda(x, *w)

    cold_ms = cuda_ms(cold)
    plain_ms = cuda_ms(lambda: fm.fused_mlp_plain(x, *w))
    comp_ms = cuda_ms(lambda: F.linear(F.gelu(F.linear(x, w[0], w[1])), w[2], w[3]))
    flops, nbytes = 4 * T * C * M, 4 * (2 * T * C + 2 * C * M + M + C)
    bound_ms, bound_by = bound(nbytes, 3 * flops, "tf32")
    fp32_ms, _ = bound(nbytes, flops, "fp32")
    form = "fused, hidden on chip" if fm.hidden_on_chip(C) else "two launches"
    print(f"K11 {label} (T {T}, C {C}, M {M}, fp32, {form}): rel_l2 "
          + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
          + f" max_abs={max_abs:.3e}; kernel_ms={ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s) "
          f"loop_ms={back_to_back:.4f} cold_ms={cold_ms:.4f} plain_ms={plain_ms:.4f} "
          f"linear_gelu_linear_ms={comp_ms:.4f} "
          f"({flops / comp_ms / 1e9:.1f} TFLOP/s) bound_ms={bound_ms:.4f} (split-TF32 "
          f"{bound_by}) fp32_bound_ms={fp32_ms:.4f}"
          + "".join(f" {k}={v:.4e}" for k, v in extra.items()), flush=True)
    for n, e in errs.items():
        if not e <= K10_K11_RTOL:
            raise RuntimeError(f"K11 {label}: {n} relative L2 {e:.3e} > {K10_K11_RTOL}")
    del x, dy, w, leaves, got, ref, want
    torch.cuda.empty_cache()
    return dict(max_abs_err=max_abs, ms=ms, loop_ms=back_to_back, cold_ms=cold_ms,
                plain_ms=plain_ms, composition_ms=comp_ms, bound_ms=bound_ms, bound_by=bound_by,
                tflops=flops / ms / 1e9, **extra)


def k11_widths_phase(gen):
    """K11 at InternImage-T's four MLP widths (C 64 / 128 / 256 / 512, M 4C)
    on the FAST head's tokens of each level (65 images at 56^2 .. 7^2), and
    at the vit_l / vit_h widths (C 1024 / 1280, M 4C) on a small T with a
    ragged last tile, by ``k11_case``."""
    out = {}
    for lvl in range(4):
        C = 64 << lvl
        out[C] = k11_case(gen, f"internimage level {lvl}", TRAIN_BATCH[2] * (56 >> lvl) ** 2,
                          C, 4 * C)
    for C in (1024, 1280):
        out[C] = k11_case(gen, f"width {C}", 1000, C, 4 * C)
    r = out[64]
    keys = ("ms", "cold_ms", "plain_ms", "composition_ms", "tflops", "two_launch_ms",
            "two_launch_max_diff")
    return {"K11w": dict(
        name="K11 fused MLP fp32 on split-TF32 wgmma at InternImage-T's widths (level 0 at the "
             "FAST head: T 203840, C 64, M 256, hidden on chip; C 128 (on chip) / 256 / 512 "
             "(two launches) and, at T 1000, C 1024 / 1280 in c*_; two_launch_*: the two-launch "
             "form at C 64 / 128; cold_ms: with the weights' tf32 split; bound: the split-TF32 "
             "tensor work; library: none, composition in composition_ms)", route="cuda",
        source="samrs_tpu_torch/csrc/fused_mlp.cu",
        replaces="samrs_tpu/kernels/fused_mlp.py:105",
        max_abs_err=max(o["max_abs_err"] for o in out.values()), ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
        composition_ms=r["composition_ms"], cold_ms=r["cold_ms"], tflops=r["tflops"],
        two_launch_ms=r["two_launch_ms"], two_launch_max_diff=r["two_launch_max_diff"],
        **{f"c{C}_{k}": o[k] for C, o in out.items() if C != 64 for k in keys if k in o})}


def k10_k11_phase(gen):
    """K10 and K11 against their plain versions in fp32, forward and the
    autograd backward (the kernels' Functions recompute with the plain
    version), at vit_b 512^2 batch 8 and at the RVSA FAST head's 224^2 shape
    (N 196: a tail tile of 4 keys); K10 also with heads of 80 (vit_h_rvsa's,
    16 heads at the FAST head's 224^2); timed against the plain version, SDPA
    (K10) and the F.linear -> F.gelu -> F.linear composition (K11), with the
    bound: the split-TF32 tensor work (3 x 4 N^2 d a head at the tf32 peak),
    the fp32 CUDA-core bound beside it."""
    from samrs_tpu_torch.kernels import flash_attention as fa

    rn = lambda *shape, std=1.0: torch.randn(*shape, generator=gen, device="cuda") * std
    out = {"K10": {}, "K11": {}}
    for key, B, N, heads, d in (("vit_b_512", FT_BATCH, (FT_SIZE // 16) ** 2, 12, 64),
                                ("rvsa_fast_224", TRAIN_BATCH[2], 196, 12, 64),
                                ("d80_224", TRAIN_BATCH[2], 196, 16, 80)):
        BH, scale = B * heads, d ** -0.5
        q, k, v, g = (rn(BH, N, d) for _ in range(4))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = fa.full_attention(*leaves, scale)
        got = [got.detach()] + list(torch.autograd.grad(got, leaves, g))
        ref = fa.full_attention_plain(*leaves, scale)
        want = [ref.detach()] + list(torch.autograd.grad(ref, leaves, g))
        errs = {n: rel_l2([a], [b]) for n, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
        max_abs = float((got[0] - want[0]).abs().max())
        ms = cuda_ms(lambda: fa.full_attention_cuda(q, k, v, scale))
        plain_ms = cuda_ms(lambda: fa.full_attention_plain(q, k, v, scale))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        flops = 4 * BH * N * N * d
        bound_ms, bound_by = bound(4 * 4 * BH * N * d, 3 * flops, "tf32")
        fp32_bound_ms = bound(4 * 4 * BH * N * d, flops, "fp32")[0]
        print(f"K10 {key} (BH {BH}, N {N}, d {d}, fp32): rel_l2 "
              + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
              + f" max_abs={max_abs:.3e}; kernel_ms={ms:.4f} ({flops / ms / 1e9:.1f} fp32 "
              f"TFLOP/s) plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({bound_by}, split-TF32) fp32_bound_ms={fp32_bound_ms:.4f}", flush=True)
        for n, e in errs.items():
            if not e <= K10_K11_RTOL:
                raise RuntimeError(f"K10 {key}: {n} relative L2 {e:.3e} > {K10_K11_RTOL}")
        out["K10"][key] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bound_ms, bound_by=bound_by, tflops=flops / ms / 1e9)
        del q, k, v, g, leaves, got, ref, want

        if d == 64:
            out["K11"][key] = k11_case(gen, key, BH // 12 * N, 768, 3072)
    r10, r11 = out["K10"]["vit_b_512"], out["K11"]["vit_b_512"]
    split = k11_split_case(gen)
    tail10, tail11 = out["K10"]["rvsa_fast_224"], out["K11"]["rvsa_fast_224"]
    return {
        "K10": dict(name="K10 plain attention fp32 on split-TF32 wgmma, K / V^T split by a "
                         "pre-pass (vit_b 512^2 batch 8: BH 96, N 1024, d 64; RVSA FAST head "
                         "224^2 in rvsa_*, heads of 80 in d80_*; bound: the split-TF32 tensor "
                         "work, the fp32 CUDA-core one on the log lines)", route="cuda",
                    source="samrs_tpu_torch/csrc/plain_attention.cu",
                    replaces="samrs_tpu/kernels/flash_attention.py:618",
                    max_abs_err=max(o["max_abs_err"] for o in out["K10"].values()), ms=r10["ms"],
                    plain_ms=r10["plain_ms"], bound_ms=r10["bound_ms"],
                    bound_by=r10["bound_by"], library_ms=r10["library_ms"],
                    tflops=r10["tflops"],
                    **{f"rvsa_{k}": tail10[k] for k in ("ms", "plain_ms", "library_ms", "tflops")},
                    **{f"d80_{k}": out["K10"]["d80_224"][k] for k in ("ms", "plain_ms", "library_ms")}),
        "K11": dict(name="K11 fused MLP fp32 on split-TF32 wgmma (vit_b 512^2 batch 8: T 8192, "
                         "C 768, M 3072, two launches; RVSA FAST head in rvsa_*; Swin-T's "
                         "stages at the FAST head in swin_c96 (fused, hidden on chip) .. "
                         "swin_c768, M 4C; ViTAEv2-S's ReductionCells (C = M) in vitae_rc*; "
                         "launches: calls of the forward; loop_ms: 20 back to back; cold_ms: "
                         "with the weights' tf32 split; bound: the split-TF32 tensor work; "
                         "composition_ms: F.linear -> F.gelu -> F.linear, no single library "
                         "call)", route="cuda",
                    source="samrs_tpu_torch/csrc/fused_mlp.cu",
                    replaces="samrs_tpu/kernels/fused_mlp.py:105",
                    max_abs_err=max(r11["max_abs_err"], tail11["max_abs_err"]), ms=r11["ms"],
                    plain_ms=r11["plain_ms"], bound_ms=r11["bound_ms"],
                    bound_by=r11["bound_by"], library_ms=None,
                    composition_ms=r11["composition_ms"], cold_ms=r11["cold_ms"],
                    tflops=r11["tflops"],
                    **{f"rvsa_{k}": tail11[k] for k in ("ms", "cold_ms", "plain_ms",
                                                         "composition_ms", "tflops")}),
        "K11s": split,
    }


def k11_split_case(gen):
    """K11's weight split (samrs_tf32_split) on vit_b's W1 (3072 x 768)
    against ``tf32_split_plain``: the tf32 bits of hi (its low 13 bits, which
    the tensor core does not read, left out) equal, and hi + lo equal to the
    weight, both exactly; timed against the plain version, with its bytes
    bound (the weight read once, both halves written once)."""
    from samrs_tpu_torch.kernels import fused_mlp as fm

    w = torch.randn(3072, 768, generator=gen, device="cuda") * 768 ** -0.5
    hi, lo = fm.tf32_split_cuda(w)
    want_hi, _ = fm.tf32_split_plain(w)
    tf32 = lambda t: (t.view(torch.int32) & ~0x1FFF).view(torch.float32)
    err = max(float((tf32(hi) - want_hi).abs().max()), float((hi + lo - w).abs().max()))
    ms = cuda_ms(lambda: fm.tf32_split_cuda(w))
    plain_ms = cuda_ms(lambda: fm.tf32_split_plain(w))
    bound_ms, bound_by = bound(3 * w.numel() * 4, 2 * w.numel(), "fp32")
    print(f"K11s tf32 split (3072 x 768 fp32): max_abs_err={err:.3e} kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
    if err != 0.0:
        raise RuntimeError(f"K11s: the split differs from the plain one by {err:.3e}")
    return dict(name="K11s tf32 split of K11's weights (vit_b W1: 3072 x 768 fp32; once per "
                     "weight version, so once a step for each of w1, w2 of every MLP; no "
                     "library call)", route="cuda", source="samrs_tpu_torch/csrc/fused_mlp.cu",
                replaces="samrs_tpu/kernels/fused_mlp.py:105", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def mask_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    inter = np.logical_and(a, b).sum(1)
    union = np.logical_or(a, b).sum(1)
    return np.where(union > 0, inter / np.maximum(union, 1), 1.0)


def build_model(gen: torch.Generator, **overrides):
    from samrs_tpu_torch.sam import build_sam

    t0 = time.perf_counter()
    model = build_sam("vit_h", device="cuda", generator=gen, **overrides)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 0.02)
    print(f"built ViT-H {overrides or ''} with seeded weights in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return model


def main_path(model, want=MAIN_LAUNCHES, profile: bool = False):
    from samrs_tpu_torch.sam import SamPredictor

    rng = np.random.default_rng(SEED)
    H, W = IMAGE_HW
    image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    xy0 = rng.uniform([0, 0], [W - 64, H - 64], (N_BOXES, 2))
    wh = rng.uniform(32, 320, (N_BOXES, 2))
    boxes = np.concatenate([xy0, np.minimum(xy0 + wh, [W - 1, H - 1])], 1).astype(np.float32)
    predictor = SamPredictor(model)

    def run():
        predictor.set_image(image)
        out = predictor.predict_boxes(boxes)
        torch.cuda.synchronize()
        return out

    from samrs_tpu_torch.kernels import gemm

    model.use_kernels = True
    reset_counts()
    masks, iou, low = run()
    launches = read_counts()
    gemm_launches = gemm.launches
    print(f"main path launches (image_size {model.cfg.image_size}): {launches}, "
          f"GEMM {gemm_launches}", flush=True)
    if launches != want:
        raise RuntimeError(f"launch counts {launches} != {want} for one image")
    if gemm_launches != MAIN_GEMM_LAUNCHES:
        raise RuntimeError(f"GEMM launches {gemm_launches} != {MAIN_GEMM_LAUNCHES} for one image")
    feats = predictor.features.clone()
    if masks.shape != (N_BOXES, 1, H, W) or masks.dtype != np.bool_:
        raise RuntimeError(f"masks {masks.shape} {masks.dtype}")
    g, d = model.cfg.grid_size, model.cfg.prompt_embed_dim
    if iou.shape != (N_BOXES, 1) or low.shape != (N_BOXES, 1, 4 * g, 4 * g):
        raise RuntimeError(f"iou {iou.shape}, low-res {low.shape}")
    if not (np.isfinite(iou).all() and np.isfinite(low).all() and torch.isfinite(feats).all()):
        raise RuntimeError("non-finite outputs on the kernel path")
    if tuple(feats.shape) != (1, g, g, d):
        raise RuntimeError(f"features {tuple(feats.shape)}")

    model.use_kernels = False
    masks_p, iou_p, _ = run()
    if read_counts() != launches or gemm.launches != gemm_launches:
        raise RuntimeError("the plain path launched a kernel")
    err = rel_l2([feats], [predictor.features])
    ious = mask_iou(masks, masks_p)
    print(f"kernels vs plain: feature rel_l2={err:.3e}, mask IoU mean={ious.mean():.5f} "
          f"min={ious.min():.5f}, |iou pred diff| max={np.abs(iou - iou_p).max():.3e}, "
          f"foreground share={masks.mean():.4f}", flush=True)
    if not err <= FEATURE_RTOL:
        raise RuntimeError(f"feature relative L2 {err:.3e} > {FEATURE_RTOL}")
    if not ious.mean() >= IOU_MIN:
        raise RuntimeError(f"mean mask IoU {ious.mean():.5f} < {IOU_MIN}")

    # img/s (set_image + 64-box predict_boxes), paths in turns, warm
    times = {True: [], False: []}
    for use_kernels in (True, False, False, True):
        model.use_kernels = use_kernels
        for _ in range(3):
            t = time.perf_counter()
            run()
            times[use_kernels].append(time.perf_counter() - t)
    for use_kernels, label in ((True, "kernels"), (False, "plain")):
        print(f"img/s ({label}, image_size {model.cfg.image_size}): "
              f"{1.0 / statistics.median(times[use_kernels]):.3f}", flush=True)
    if profile:
        profile_image(run, model)
    model.use_kernels = True
    return {**launches, "GEMM": gemm_launches}


def dior_xml(boxes: np.ndarray, names) -> str:
    objs = "".join(
        f"<object><name>{n}</name><bndbox><xmin>{b[0]:.1f}</xmin><ymin>{b[1]:.1f}</ymin>"
        f"<xmax>{b[2]:.1f}</xmax><ymax>{b[3]:.1f}</ymax></bndbox></object>"
        for b, n in zip(boxes, names))
    return f"<annotation>{objs}</annotation>"


def profile_image(run, model) -> None:
    """torch.profiler over one warm generate image per path: device time by
    kernel and the device's busy share of the wall time; then cProfile of
    the host side of one image with the kernels."""
    import cProfile
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for use_kernels, label in ((True, "kernels"), (False, "plain")):
        model.use_kernels = use_kernels
        run()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
        wall_ms = (time.perf_counter() - t) * 1e3
        events = prof.key_averages()
        device_ms = sum(e.self_device_time_total for e in events
                        if e.device_type == DeviceType.CUDA) / 1e3
        print(f"profile ({label}): wall {wall_ms:.2f} ms under the profiler, device "
              f"{device_ms:.2f} ms, busy {100 * device_ms / wall_ms:.1f}% of the profiled wall",
              flush=True)
        print(events.table(sort_by="self_device_time_total", row_limit=18, max_name_column_width=60),
              flush=True)
    model.use_kernels = True
    host = cProfile.Profile()
    host.runcall(run)
    pstats.Stats(host, stream=sys.stdout).sort_stats("tottime").print_stats(14)
    sys.stdout.flush()


def generate_scene(seed: int, box_px=GEN_BOX_PX, hw=GEN_HW, n_boxes: int = GEN_BOXES):
    """A seeded `hw` (800x800) image and `n_boxes` DIOR boxes with sides
    uniform in `box_px` and labels uniform over DIOR's 20 classes."""
    from samrs_tpu_torch.data.mapping import CLASS_SETS

    rng = np.random.default_rng(seed)
    H, W = hw
    image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    xy0 = rng.uniform(0, [W - box_px[0], H - box_px[0]], (n_boxes, 2))
    wh = rng.uniform(box_px[0], box_px[1], (n_boxes, 2))
    boxes = np.concatenate([xy0, np.minimum(xy0 + wh, [W - 1, H - 1])], 1)
    labels = rng.integers(0, len(CLASS_SETS["dior"]), n_boxes)
    return image, boxes, labels


def cover_index(masks: np.ndarray) -> np.ndarray:
    """(N, H, W) bool -> (H, W) int: the last instance covering each pixel,
    -1 where none does (the generator's coverage fold), painted in order."""
    cover = np.full(masks.shape[1:], -1)
    for i, m in enumerate(masks):
        cover[m] = i
    return cover


def generate_phase(model, profile: bool = False, want=GEN_LAUNCHES):
    from PIL import Image

    from samrs_tpu_torch.core.config import GenerateConfig
    from samrs_tpu_torch.data.loaders import load_dior
    from samrs_tpu_torch.data.mapping import CLASS_SETS, PALETTE
    from samrs_tpu_torch.data.rle import rle_decode
    from samrs_tpu_torch.data.writers import save_color_png, save_instances_pkl, save_semantic_png
    from samrs_tpu_torch.generate.semantic import SemanticGenerator
    from samrs_tpu_torch.sam import SamPredictor

    H, W = GEN_HW
    image, boxes, labels = generate_scene(SEED + 1)
    classes = CLASS_SETS["dior"]
    gen = SemanticGenerator(SamPredictor(model, buckets=GenerateConfig().box_buckets), classes)
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "img0.xml"), "w") as f:
            f.write(dior_xml(boxes, [classes[i] for i in labels]))
        ann = load_dior("img0", tmp)
        if ann.num_instances != GEN_BOXES:
            raise RuntimeError(f"loader read {ann.num_instances} boxes")

        def run():
            res = gen.process_image(image, ann)
            torch.cuda.synchronize()
            return res

        model.use_kernels = True
        reset_counts()
        res = run()
        launches = read_counts()
        print(f"generate launches (image_size {model.cfg.image_size}): {launches}", flush=True)
        if launches != want:
            raise RuntimeError(f"generate launch counts {launches} != {want}")
        paths = {k: os.path.join(tmp, f"img0_{k}.png") for k in ("gray", "color")}
        save_semantic_png(paths["gray"], res.gray)
        save_color_png(paths["color"], res.color)
        save_instances_pkl(os.path.join(tmp, "img0.pkl"), res.records)
        with Image.open(paths["gray"]) as im:
            gray = np.asarray(im)
        with Image.open(paths["color"]) as im:
            color = np.asarray(im)
        with open(os.path.join(tmp, "img0.pkl"), "rb") as f:
            records = pickle.load(f)
    if gray.shape != (H, W) or not np.array_equal(gray, res.gray):
        raise RuntimeError("gray PNG does not read back")
    if not np.array_equal(color, PALETTE[gray]):
        raise RuntimeError("color PNG is not PALETTE[gray]")
    if len(records) != GEN_BOXES or [r["label"] for r in records] != labels.tolist():
        raise RuntimeError("instance records do not match the annotation")
    masks = np.stack([rle_decode(r["mask"]) for r in records]).astype(bool)
    if masks.shape != (GEN_BOXES, H, W) or [int(m.sum()) for m in masks] != \
            [r["size"] for r in records]:
        raise RuntimeError("an RLE does not decode to its recorded area")
    cover = cover_index(masks)
    want_gray = np.where(cover >= 0, labels[np.maximum(cover, 0)], 255)
    if not np.array_equal(gray, want_gray):
        raise RuntimeError("gray PNG is not the label of the last instance covering each pixel")

    model.use_kernels = False
    res_p = run()
    if read_counts() != launches:
        raise RuntimeError("the plain path launched a kernel")
    masks_p = np.stack([rle_decode(r["mask"]) for r in res_p.records]).astype(bool)
    ious = mask_iou(masks, masks_p)
    cover_agree = float((cover == cover_index(masks_p)).mean())
    agree = float((res.gray == res_p.gray).mean())
    print(f"generate kernels vs plain: instance IoU mean={ious.mean():.5f} min={ious.min():.5f}, "
          f"cover agreement={cover_agree:.5f}, gray agreement={agree:.5f}, "
          f"covered share={(cover >= 0).mean():.4f}", flush=True)
    if not (ious.mean() >= IOU_MIN and cover_agree >= IOU_MIN and agree >= IOU_MIN):
        raise RuntimeError(f"generate: IoU {ious.mean():.5f} / cover agreement {cover_agree:.5f} "
                           f"/ gray agreement {agree:.5f} < {IOU_MIN}")

    times = {True: [], False: []}
    for use_kernels in (True, False, False, True):
        model.use_kernels = use_kernels
        t = time.perf_counter()
        run()
        times[use_kernels].append(time.perf_counter() - t)
    for use_kernels, label in ((True, "kernels"), (False, "plain")):
        print(f"generate s/image ({label}, 800x800, 100 boxes, image_size "
              f"{model.cfg.image_size}): "
              f"{statistics.median(times[use_kernels]):.4f}", flush=True)
    if profile:
        profile_image(run, model)
    model.use_kernels = True
    return launches


def packed_iou(a, b, chunk: int = AMG_MASKS) -> np.ndarray:
    """Mask IoU of packed bit rows a, b (N, H, Wp) uint8 on the card, by
    popcounts of their AND and OR, in chunks; 1 where both are empty."""
    pop = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32,
                       device="cuda")
    out = []
    for i in range(0, a.shape[0], chunk):
        x, y = a[i:i + chunk], b[i:i + chunk]
        inter = pop[(x & y).int()].sum((-1, -2))
        union = pop[(x | y).int()].sum((-1, -2))
        out.append(torch.where(union > 0, inter / union.clamp(min=1), 1.0))
    return torch.cat(out).cpu().numpy()


def amg_grid(pred):
    """The generator's prompt sets for one image at AMG_POINTS^2 points,
    chunked: (points, pts (G, nb, 2, 2), labs (G, nb, 2))."""
    from samrs_tpu_torch.sam.amg import build_point_grid

    h, w = pred.original_size
    points = build_point_grid(AMG_POINTS) * np.array([[w, h]])
    n = len(points)
    pts, labs = pred._prompts_to_points(points.astype(np.float32)[:, None],
                                        np.ones((n, 1), np.int64), None)
    return points, pts.reshape(AMG_CHUNKS, AMG_BATCH, 2, 2), labs.reshape(AMG_CHUNKS, AMG_BATCH, 2)


def check_amg_records(label: str, records, hw) -> None:
    """The generator's record schema at image size hw, more than 0 records."""
    keys = {"segmentation", "area", "bbox", "predicted_iou", "point_coords", "stability_score",
            "crop_box"}
    if not records:
        raise RuntimeError(f"AMG {label}: no records")
    for r in records:
        seg = r["segmentation"]
        if set(r) != keys or seg.shape != hw or seg.dtype != np.bool_:
            raise RuntimeError(f"AMG {label}: record {set(r)} {seg.shape} {seg.dtype}")
        if r["area"] != int(seg.sum()) or len(r["bbox"]) != 4 or len(r["crop_box"]) != 4:
            raise RuntimeError(f"AMG {label}: area / bbox / crop_box {r['area']} {r['bbox']} "
                               f"{r['crop_box']}")
        if not (np.isfinite(r["predicted_iou"]) and 0.0 <= r["stability_score"] <= 1.0):
            raise RuntimeError(f"AMG {label}: scores {r['predicted_iou']} {r['stability_score']}")


def amg_phase(model):
    """The automatic mask generator (SamAutomaticMaskGenerator over
    SamPredictor, ViT-H) on a seeded 1024^2 image at 32^2 points, 64 a chunk:
    the sweep before the filters on both paths (bits by mean IoU, K7's stats
    by its rule on every chunk's real logits), the whole generator with both
    thresholds at 0 on both paths (launches; the kernel path's records
    against the plain sweep's masks of the same prompts), s/image split into
    device and host time, the default thresholds' record count, and one run
    with crop_n_layers 1 and min_mask_region_area 100 -> numbers."""
    from samrs_tpu_torch.kernels import gemm
    from samrs_tpu_torch.sam import SamAutomaticMaskGenerator, SamPredictor

    t_phase = time.perf_counter()
    image = np.random.default_rng(SEED + 3).integers(0, 256, (*AMG_HW, 3), dtype=np.uint8)
    pred = SamPredictor(model)
    cfg = model.cfg
    out = {}

    # the sweep before the filters, each path
    sweep = {}
    for use_kernels in (True, False):
        model.use_kernels = use_kernels
        pred.set_image(image)
        points, pts, labs = amg_grid(pred)
        stats, packed = pred.amg_sweep(pts, labs, 1.0)
        sweep[use_kernels] = stats.cpu().numpy(), packed
    (stats_k, packed_k), (stats_p, packed_p) = sweep.pop(True), sweep.pop(False)
    n_masks = AMG_POINTS ** 2 * 3
    if stats_k.shape != (AMG_POINTS ** 2, 3, 7) or tuple(packed_k.shape) != \
            (n_masks, AMG_HW[0], AMG_HW[1] // 8):
        raise RuntimeError(f"AMG sweep: stats {stats_k.shape}, bits {tuple(packed_k.shape)}")
    if not np.isfinite(stats_k).all():
        raise RuntimeError("AMG sweep: non-finite stats on the kernel path")
    ious = packed_iou(packed_k, packed_p)
    hi_k, hi_p = stats_k[..., 1].ravel(), stats_p[..., 1].ravel()
    px = AMG_HW[0] * AMG_HW[1]
    print(f"AMG sweep kernels vs plain ({n_masks} masks before the filters): bit IoU mean "
          f"{ious.mean():.5f} min {ious.min():.5f}, |iou pred diff| max "
          f"{np.abs(stats_k[..., 0] - stats_p[..., 0]).max():.3e}, hi relative diff mean "
          f"{np.mean(np.abs(hi_k - hi_p) / np.maximum(hi_p, 1)):.3e}, share above threshold "
          f"- / + offset {stats_k[..., 2].mean() / px:.4f} / {stats_k[..., 1].mean() / px:.4f}",
          flush=True)
    if not ious.mean() >= IOU_MIN:
        raise RuntimeError(f"AMG sweep: mean bit IoU {ious.mean():.5f} < {IOU_MIN}")
    out["sweep_iou_mean"] = float(ious.mean())
    del packed_k
    # K7's stats on the kernel path's own logits, chunk by chunk (launches not counted)
    model.use_kernels = True
    pred.set_image(image)
    pts_d, labs_d = (torch.from_numpy(a).cuda() for a in (pts, labs))
    worst = 0
    with torch.no_grad():
        for g in range(AMG_CHUNKS):
            low, _ = model.predict(pred.features, pts_d[g], labs_d[g], None, True)
            worst = max(worst, k7_compare(
                f"AMG chunk {g}", low.reshape(AMG_MASKS, *low.shape[-2:]), pred.input_size,
                pred.original_size, cfg.image_size, cfg.mask_threshold, 1.0)[0])
    print(f"AMG K7 stats of {AMG_CHUNKS} chunks against the plain version: largest count or box "
          f"difference {worst}", flush=True)
    del pts_d, labs_d
    torch.cuda.empty_cache()

    # the whole generator, both thresholds at 0 (bench.py:173-189: random weights may fail the
    # default thresholds on every candidate), each path
    def generator(**kw):
        return SamAutomaticMaskGenerator(pred, points_per_side=AMG_POINTS,
                                         points_per_batch=AMG_BATCH, **kw)

    zero = generator(pred_iou_thresh=0.0, stability_score_thresh=0.0)
    records = {}
    for use_kernels in (True, False):
        model.use_kernels = use_kernels
        reset_counts()
        records[use_kernels] = zero.generate(image)
        torch.cuda.synchronize()
        launches, gemm_launches = read_counts(), gemm.launches
        want = AMG_LAUNCHES if use_kernels else dict.fromkeys(AMG_LAUNCHES, 0)
        if launches != want or gemm_launches != (MAIN_GEMM_LAUNCHES if use_kernels else 0):
            raise RuntimeError(f"AMG launches ({'kernels' if use_kernels else 'plain'}) "
                               f"{launches}, GEMM {gemm_launches}, want {want}")
        check_amg_records("thresholds 0", records[use_kernels], AMG_HW)
        if use_kernels:
            out["launches"] = {**launches, "GEMM": gemm_launches}
    # each kernel-path record against the plain sweep's mask of the same prompt and output
    grid = {tuple(p): i for i, p in enumerate(points.tolist())}
    idx = []
    for r in records[True]:
        i = grid[tuple(r["point_coords"][0])]
        idx.append(3 * i + int(np.argmin(np.abs(stats_k[i, :, 0] - r["predicted_iou"]))))
    plain_bits = pred.amg_take_packed(packed_p, np.array(idx))
    del packed_p
    torch.cuda.empty_cache()
    rec_iou = mask_iou(np.stack([r["segmentation"] for r in records[True]]),
                       np.unpackbits(plain_bits, axis=-1)[..., :AMG_HW[1]].astype(bool))
    same = [r["point_coords"] for r in records[True]] == [r["point_coords"] for r in records[False]]
    print(f"AMG thresholds 0: {len(records[True])} records with the kernels, "
          f"{len(records[False])} plain (the same prompts in the same order: {same}); the kernel "
          f"path's records against the plain sweep's masks of their prompts: IoU mean "
          f"{rec_iou.mean():.5f} min {rec_iou.min():.5f}", flush=True)
    if not rec_iou.mean() >= IOU_MIN:
        raise RuntimeError(f"AMG records: mean IoU {rec_iou.mean():.5f} < {IOU_MIN}")
    out["records"] = len(records[True])
    del records, plain_bits

    # s/image, paths in turns; device time by torch.profiler, host the rest of the wall
    times = {True: [], False: []}
    for use_kernels in (True, False, False, True):
        model.use_kernels = use_kernels
        for _ in range(2):
            t = time.perf_counter()
            zero.generate(image)
            torch.cuda.synchronize()
            times[use_kernels].append(time.perf_counter() - t)
    model.use_kernels = True
    s_img = {k: statistics.median(v) for k, v in times.items()}
    dev = device_ms_or_none("AMG image", lambda: (zero.generate(image), torch.cuda.synchronize()),
                            n=2)
    host = None if dev is None else s_img[True] - dev / 1e3
    print(f"AMG s/image (1024^2, {AMG_POINTS}^2 points, thresholds 0): kernels "
          f"{s_img[True]:.4f} (device {dev} ms, host {host} s: the wall less the device time), "
          f"plain {s_img[False]:.4f}", flush=True)
    host_prof = cProfile.Profile()
    host_prof.runcall(zero.generate, image)
    pstats.Stats(host_prof, stream=sys.stdout).sort_stats("tottime").print_stats(12)
    sys.stdout.flush()
    out.update(s_image=s_img[True], s_image_plain=s_img[False], device_ms=dev, host_s=host)

    # the generator's default thresholds (0.88 / 0.95), kernel path
    t = time.perf_counter()
    n_default = len(generator().generate(image))
    torch.cuda.synchronize()
    print(f"AMG default thresholds: {n_default} records in {time.perf_counter() - t:.4f} s",
          flush=True)

    # crop_n_layers 1 (the image and four crops, their grids 16^2), small regions removed
    crops = generator(pred_iou_thresh=0.0, stability_score_thresh=0.0, crop_n_layers=1,
                      crop_n_points_downscale_factor=2, min_mask_region_area=100)
    reset_counts()
    t = time.perf_counter()
    crop_records = crops.generate(image)
    torch.cuda.synchronize()
    t = time.perf_counter() - t
    launches, gemm_launches = read_counts(), gemm.launches
    if launches != AMG_CROP_LAUNCHES or gemm_launches != AMG_CROPS * MAIN_GEMM_LAUNCHES:
        raise RuntimeError(f"AMG crops: launches {launches}, GEMM {gemm_launches}, want "
                           f"{AMG_CROP_LAUNCHES}")
    check_amg_records("crop_n_layers 1", crop_records, AMG_HW)
    boxes = {tuple(r["crop_box"]) for r in crop_records}
    print(f"AMG crop_n_layers 1, min_mask_region_area 100: {len(crop_records)} records from "
          f"{len(boxes)} crop boxes in {t:.4f} s; launches {launches}", flush=True)
    out["crop_launches"] = launches
    print(f"AMG phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def write_hrsc_scene(root: str):
    """A seeded HRSC2016 scene under `root`: an 800x600 image with HRSC_SHIPS
    rotated ships (img/s0.png), its HRSC XML (ann/s0.xml: hbox, rotated box,
    colour) and its LandMask PNG (land/s0.png: each ship's polygon in its
    colour, rasterised as the annotation's polygon) -> (image, ann, land dirs)."""
    from PIL import Image

    from samrs_tpu_torch.generate.instance_eval import fill_poly
    from samrs_tpu_torch.geometry.obb import obb2poly, poly_to_hbb

    rng = np.random.default_rng(SEED + 4)
    H, W = HRSC_HW
    image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    land = np.zeros((H, W, 3), np.uint8)
    objs = []
    for k in range(HRSC_SHIPS):
        obb = np.array([[*rng.uniform([100, 100], [W - 100, H - 100]), rng.uniform(60, 180),
                         rng.uniform(16, 40), rng.uniform(-np.pi / 2, np.pi / 2)]])
        poly = obb2poly(obb).reshape(4, 2)
        color = (30 + 25 * k, 230 - 20 * k, 60 + 17 * k)
        ship = fill_poly(np.zeros((H, W), np.uint8), poly.astype(np.int32)) > 0
        land[ship] = color
        image[ship] = image[ship] // 2 + 100
        x0, y0, x1, y1 = poly_to_hbb(poly.reshape(1, 8))[0]
        cx, cy, w, h, ang = (repr(float(v)) for v in obb[0])  # the polygon's values, exactly
        objs.append(f"<HRSC_Object><box_xmin>{x0:.1f}</box_xmin><box_ymin>{y0:.1f}</box_ymin>"
                    f"<box_xmax>{x1:.1f}</box_xmax><box_ymax>{y1:.1f}</box_ymax>"
                    f"<mbox_cx>{cx}</mbox_cx><mbox_cy>{cy}</mbox_cy><mbox_w>{w}</mbox_w>"
                    f"<mbox_h>{h}</mbox_h><mbox_ang>{ang}</mbox_ang>"
                    f"<seg_color>{','.join(map(str, color))}</seg_color></HRSC_Object>")
    dirs = [os.path.join(root, d) for d in ("img", "ann", "land")]
    for d in dirs:
        os.makedirs(d)
    Image.fromarray(image).save(os.path.join(dirs[0], "s0.png"))
    with open(os.path.join(dirs[1], "s0.xml"), "w") as f:
        f.write(f"<HRSC_Image><HRSC_Objects>{''.join(objs)}</HRSC_Objects></HRSC_Image>")
    Image.fromarray(land).save(os.path.join(dirs[2], "s0.png"))
    return dirs


def prompt_eval_phase(model):
    """The HRSC prompt evaluation (``run_prompt_eval``) on a seeded 800x600
    scene with 8 ships, in every prompt mode, with the kernels and with the
    plain versions: launches, the COCO JSON read back, the instances' masks
    of the two paths by mean IoU, s/image -> {mode: numbers}."""
    from samrs_tpu_torch.data.rle import rle_decode
    from samrs_tpu_torch.generate.instance_eval import PROMPT_MODES, run_prompt_eval
    from samrs_tpu_torch.sam import SamPredictor

    pred = SamPredictor(model)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = write_hrsc_scene(tmp)
        for mode in PROMPT_MODES:
            masks, metrics, secs = {}, {}, {}
            for use_kernels in (True, False):
                model.use_kernels = use_kernels
                json_dir = os.path.join(tmp, f"json_{'kernels' if use_kernels else 'plain'}")
                reset_counts()
                metrics[use_kernels] = run_prompt_eval(pred, *dirs, ["s0"], mode,
                                                       json_dir=json_dir)
                torch.cuda.synchronize()
                launches = read_counts()
                want = MAIN_LAUNCHES if use_kernels else dict.fromkeys(MAIN_LAUNCHES, 0)
                if launches != want:
                    raise RuntimeError(f"prompt eval {mode}: launches {launches}, want {want}")
                if use_kernels:
                    kernel_launches = launches
                with open(os.path.join(json_dir, f"gt_ins_{mode}.json")) as f:
                    gt = json.load(f)
                with open(os.path.join(json_dir, f"sam_ins_{mode}.json")) as f:
                    pre = json.load(f)
                if (len(gt["annotations"]), len(pre), gt["categories"][0]["name"]) != \
                        (HRSC_SHIPS, HRSC_SHIPS, "ship"):
                    raise RuntimeError(f"prompt eval {mode}: COCO JSON {len(gt['annotations'])} "
                                       f"annotations, {len(pre)} predictions")
                masks[use_kernels] = np.stack([rle_decode(p["segmentation"])
                                               for p in pre]).astype(bool)
                if masks[use_kernels].shape != (HRSC_SHIPS, *HRSC_HW) or \
                        metrics[use_kernels]["num_instances"] != HRSC_SHIPS:
                    raise RuntimeError(f"prompt eval {mode}: masks {masks[use_kernels].shape}, "
                                       f"metrics {metrics[use_kernels]}")
                t = time.perf_counter()
                run_prompt_eval(pred, *dirs, ["s0"], mode)
                torch.cuda.synchronize()
                secs[use_kernels] = time.perf_counter() - t
            ious = mask_iou(masks[True], masks[False])
            print(f"prompt eval {mode}: kernels vs plain instance IoU mean {ious.mean():.5f} "
                  f"min {ious.min():.5f}; mIoU against the ground truth "
                  f"{metrics[True]['miou_avg']:.4f} / {metrics[False]['miou_avg']:.4f}; s/image "
                  f"{secs[True]:.4f} / {secs[False]:.4f} (kernels / plain)", flush=True)
            if not ious.mean() >= IOU_MIN:
                raise RuntimeError(f"prompt eval {mode}: mean IoU {ious.mean():.5f} < {IOU_MIN}")
            out[mode] = dict(iou_mean=float(ious.mean()), s_image=secs[True],
                             s_image_plain=secs[False], launches=kernel_launches)
    model.use_kernels = True
    return out


def write_fleet_set(root: str):
    """The fleet phase's seeded DIOR mini-set under `root`: FLEET_ORDER's
    images (800x800 with GEN_BOXES boxes of GEN_BOX_PX, 768x1024 with
    N_BOXES) as JPEGs (DIOR's format) with their XMLs -> (image dir,
    annotation dir, names, boxes an image)."""
    from PIL import Image

    from samrs_tpu_torch.data.mapping import CLASS_SETS

    classes = CLASS_SETS["dior"]
    img_dir, ann_dir = os.path.join(root, "images"), os.path.join(root, "anns")
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    names, n_boxes = [], []
    for i, hw in enumerate(FLEET_ORDER):
        n = GEN_BOXES if hw == GEN_HW else N_BOXES
        image, boxes, labels = generate_scene(SEED + 100 + i, hw=hw, n_boxes=n)
        name = f"f{i}"
        Image.fromarray(image).save(os.path.join(img_dir, name + ".jpg"), quality=95)
        with open(os.path.join(ann_dir, name + ".xml"), "w") as f:
            f.write(dior_xml(boxes, [classes[j] for j in labels]))
        names.append(name)
        n_boxes.append(n)
    return img_dir, ann_dir, names, n_boxes


def read_labels(save_dir: str, names):
    """Read back one run's outputs and check each image: PNGs and pkl there,
    every RLE decoding to its recorded area, the gray PNG the label of the
    last instance covering each pixel, the colour PNG PALETTE[gray] ->
    {name: (gray, decoded masks (N, H, W) bool, records, cover index)}
    (images read on 8 threads)."""
    from PIL import Image

    from samrs_tpu_torch.data.mapping import PALETTE
    from samrs_tpu_torch.data.rle import rle_decode

    def read(name):
        with Image.open(os.path.join(save_dir, "gray", name + ".png")) as im:
            gray = np.asarray(im)
        with Image.open(os.path.join(save_dir, "color", name + ".png")) as im:
            color = np.asarray(im)
        with open(os.path.join(save_dir, "ins", name + ".pkl"), "rb") as f:
            records = pickle.load(f)
        masks = np.stack([rle_decode(r["mask"]) for r in records]).view(bool)
        if [int(m.sum()) for m in masks] != [r["size"] for r in records]:
            raise RuntimeError(f"{save_dir}/{name}: an RLE does not decode to its recorded area")
        labels = np.array([r["label"] for r in records])
        cover = cover_index(masks)
        if not np.array_equal(gray, np.where(cover >= 0, labels[np.maximum(cover, 0)], 255)):
            raise RuntimeError(f"{save_dir}/{name}: gray PNG is not the label of the last "
                               "instance covering each pixel")
        if not np.array_equal(color, PALETTE[gray]):
            raise RuntimeError(f"{save_dir}/{name}: color PNG is not PALETTE[gray]")
        return gray, masks, records, cover

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return dict(zip(names, pool.map(read, names)))


def labels_agree(label: str, got, want) -> None:
    """Mean instance IoU, cover agreement and gray agreement over all images
    of two runs' outputs (read_labels), each >= IOU_MIN."""
    ious, cover_hits, gray_hits, pixels = [], 0, 0, 0
    for name, (gray, masks, _, cover) in got.items():
        gray_w, masks_w, _, cover_w = want[name]
        ious.append(mask_iou(masks, masks_w))
        cover_hits += int((cover == cover_w).sum())
        gray_hits += int((gray == gray_w).sum())
        pixels += gray.size
    ious = np.concatenate(ious)
    cover_agree, gray_agree = cover_hits / pixels, gray_hits / pixels
    print(f"fleet {label}: instance IoU mean={ious.mean():.5f} min={ious.min():.5f}, "
          f"cover agreement={cover_agree:.5f}, gray agreement={gray_agree:.5f}", flush=True)
    if not (ious.mean() >= IOU_MIN and cover_agree >= IOU_MIN and gray_agree >= IOU_MIN):
        raise RuntimeError(f"fleet {label}: IoU {ious.mean():.5f} / cover agreement "
                           f"{cover_agree:.5f} / gray agreement {gray_agree:.5f} < {IOU_MIN}")


def fleet_batches():
    """The encoder passes one worker makes over FLEET_ORDER: each window of
    FLEET_BATCH images split by shape, in first-seen order."""
    out = []
    for i in range(0, len(FLEET_ORDER), FLEET_BATCH):
        window = FLEET_ORDER[i:i + FLEET_BATCH]
        out += [window.count(hw) for hw in dict.fromkeys(window)]
    return out


def fleet_phase(model):
    """``run_fleet`` (python -m samrs_tpu_torch.generate.fleet) on the seeded
    DIOR mini-set with the kernels and on the plain versions, the one-image
    driver on the same images, batched against one-image features, both
    codecs on every mask, and K1-K3 and the GEMM at batch FLEET_BATCH."""
    from samrs_tpu_torch.core.config import GenerateConfig
    from samrs_tpu_torch.data.rle import rle_encode
    from samrs_tpu_torch.generate.fleet import run_fleet
    from samrs_tpu_torch.generate.semantic import generate_semantic
    from samrs_tpu_torch.kernels import gemm
    from samrs_tpu_torch.native import native_rle_encode_batch
    from samrs_tpu_torch.sam import SamPredictor

    out = {}
    t_phase = time.perf_counter()
    # one batch of four 1024^2 images against each image through set_image
    rng = np.random.default_rng(SEED + 200)
    images = [rng.integers(0, 256, (1024, 1024, 3), dtype=np.uint8) for _ in range(FLEET_BATCH)]
    predictor = SamPredictor(model)
    batched = torch.cat([f for f, _, _ in predictor.encode_images(images)])
    singles = []
    for image in images:
        predictor.set_image(image)
        singles.append(predictor.features)
    singles = torch.cat(singles)
    err = rel_l2([batched], [singles])
    print(f"encode_images at batch {FLEET_BATCH} vs set_image: feature rel_l2={err:.3e}, "
          f"bit-equal {torch.equal(batched, singles)}", flush=True)
    if not err <= FEATURE_RTOL:
        raise RuntimeError(f"batched features: relative L2 {err:.3e} > {FEATURE_RTOL}")
    x = (torch.from_numpy(np.stack(images)).cuda().float() - 128.0) / 64.0
    enc = {}
    with torch.no_grad():
        for b in (FLEET_BATCH, 1):
            ms = cuda_ms(lambda: model.encode_image(x[:b]), reps=5) / b
            dev = device_ms_or_none(f"encoder at batch {b}", lambda: model.encode_image(x[:b]),
                                    n=5)
            enc[b] = (ms, None if dev is None else dev / b)
            print(f"encoder ms an image at batch {b}: {ms:.3f} (CUDA events), device "
                  f"{enc[b][1]} (torch.profiler)", flush=True)
    del batched, singles, x, predictor

    # K1-K3 and the GEMM at the batch's shapes, on a generator of their own
    fgen = torch.Generator(device="cuda").manual_seed(SEED + FLEET_BATCH)
    cases = encoder_cases(fgen, FLEET_BATCH)[0]
    batch = run_cases(cases)
    for key, _, _, _, kernel, *_ in cases:
        dev = batch[key]["device_ms"] = device_ms_or_none(f"{key} at batch {FLEET_BATCH}", kernel)
        print(f"{key} at batch {FLEET_BATCH}: device {dev} ms a call, "
              f"{None if dev is None else dev / FLEET_BATCH} an image", flush=True)
    del cases
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        img_dir, ann_dir, names, n_boxes = write_fleet_set(tmp)
        lap = lambda what: print(f"fleet phase: {what} at {time.perf_counter() - t_phase:.1f} s",
                                 flush=True)
        lap("mini-set written")

        def cfg(run):
            return GenerateConfig(dataset="dior", image_dir=img_dir, ann_dir=ann_dir,
                                  save_dir=os.path.join(tmp, run))

        def fleet(run, use_kernels, image_list=names):
            model.use_kernels = use_kernels
            stats = {}
            if run_fleet(cfg(run), image_list, model=model, stats=stats) != len(image_list):
                raise RuntimeError(f"fleet ({run}) wrote {stats['total']} of {len(image_list)} "
                                   "images")
            torch.cuda.synchronize()
            return stats

        reset_counts()
        stats = fleet("fleet", True)
        launches = {**read_counts(), "GEMM": gemm.launches}
        passes = fleet_batches()
        want = {k: 0 for k in launches}
        want.update({k: n * len(passes) for k, n in ENCODE_LAUNCHES.items()})
        want.update(K4=len(names), K5=2 * len(names), K6=len(names),
                    K7=sum(-(-n // 32) for n in n_boxes))
        print(f"fleet launches ({len(names)} images, encoder passes of {stats['encode_batches']} "
              f"images): {launches}", flush=True)
        if stats["encode_batches"] != passes:
            raise RuntimeError(f"fleet encoder passes {stats['encode_batches']} != {passes}")
        if launches != want:
            raise RuntimeError(f"fleet launch counts {launches} != {want}")
        stats_plain = fleet("plain", False)
        if {**read_counts(), "GEMM": gemm.launches} != launches:
            raise RuntimeError("the plain fleet launched a kernel")
        model.use_kernels = True
        lap("fleet runs done")
        t = time.perf_counter()
        generate_semantic(cfg("one"), predictor=SamPredictor(model, buckets=cfg("one").box_buckets))
        one_s = (time.perf_counter() - t) / len(names)
        lap("generate_semantic done")
        runs = {run: read_labels(os.path.join(tmp, run), names)
                for run in ("fleet", "plain", "one")}
        lap("outputs read back")
        labels_agree("kernels vs generate_semantic", runs["fleet"], runs["one"])
        labels_agree("kernels vs plain", runs["fleet"], runs["plain"])
        lap("runs compared")

        t = time.perf_counter()  # every mask of the phase: the C codec's bytes against numpy's
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            same = list(pool.map(
                lambda mr: rle_encode(mr[0])["counts"] == mr[1]["mask"]["counts"].encode("ascii"),
                [(m, r) for run in runs.values() for _, masks, records, _ in run.values()
                 for m, r in zip(masks, records)]))
        print(f"C codec vs numpy codec: {sum(same)} of {len(same)} masks byte-equal "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
        if not all(same):
            raise RuntimeError(f"C codec: {len(same) - sum(same)} masks differ from numpy's")
        masks = runs["fleet"][names[0]][1][:32]
        c_ms = statistics.median(_host_ms(lambda: native_rle_encode_batch(masks))
                                 for _ in range(5)) / len(masks)
        np_ms = _host_ms(lambda: [rle_encode(m) for m in masks]) / len(masks)
        print(f"RLE ms a mask ({masks.shape[1]}x{masks.shape[2]}, a chunk of {len(masks)}): "
              f"C {c_ms:.4f}, numpy {np_ms:.4f}", flush=True)
        del runs, masks

        # the steady rate: FLEET_REPEAT passes over the set (links under new names), several
        # times the fleet's read-ahead (a queue of 8 and 8 decodes), so fill and drain are small
        long_names = link_repeats(img_dir, ann_dir, names, FLEET_REPEAT)
        stats_warm = fleet("warm", True, long_names)
        lap("warm fleet run done")
        fleet_dev = device_ms_or_none("fleet", lambda: fleet("profiled", True), n=1)
        lap("profiled fleet run done")
        host = cProfile.Profile()  # the host's share of two images of the one-image driver
        host.runcall(generate_semantic, cfg("cprofile"), names[:2],
                     SamPredictor(model, buckets=cfg("one").box_buckets))
        pstats.Stats(host, stream=sys.stdout).sort_stats("tottime").print_stats(14)
    for label, st in (("kernels, first run, fill and drain", stats),
                      ("kernels, warm, steady", stats_warm),
                      ("plain, fill and drain", stats_plain)):
        print(f"fleet img/s ({label}, {st['total']} DIOR images): "
              f"{st['total'] / st['seconds']:.4f} ({st['seconds']:.3f} s; worker busy "
              f"{st['overlap']:.3f} of the wall)", flush=True)
    print(f"generate_semantic s/image on the same set (kernels): {one_s:.4f} "
          f"({1 / one_s:.4f} img/s)", flush=True)
    steady = stats_warm["total"] / stats_warm["seconds"]
    if fleet_dev is not None:
        fleet_dev /= len(names)
        print(f"fleet device ms an image (torch.profiler, {len(names)} images): {fleet_dev:.3f}; "
              f"at the steady {steady:.4f} img/s the card is busy {fleet_dev * steady / 10:.2f}%",
              flush=True)

    out.update(launches=launches, batch=batch, gemm=gemm_rows(fgen, FLEET_BATCH * 4096),
               encoder=enc)
    print(f"fleet phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def link_repeats(img_dir: str, ann_dir: str, names, k: int):
    """`k` copies of the set's names (r<i>_<name>, symbolic links to its
    image and XML in the same directories) -> the new names."""
    out = []
    for i in range(k):
        for name in names:
            for d, ext in ((img_dir, ".jpg"), (ann_dir, ".xml")):
                os.symlink(name + ext, os.path.join(d, f"r{i}_{name}{ext}"))
            out.append(f"r{i}_{name}")
    return out


def _host_ms(fn) -> float:
    t = time.perf_counter()
    fn()
    return (time.perf_counter() - t) * 1e3


def train_batches(seed: int):
    """One 17/12/65 batch of seeded normalized images at 224^2 and labels
    uniform over each head's classes, on the card."""
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.normal(size=(b, 224, 224, 3)).astype(np.float32)).cuda(),
             torch.from_numpy(rng.integers(0, nc, (b, 224, 224))).cuda())
            for b, nc in zip(TRAIN_BATCH, TRAIN_CLASSES)]


def split_mlp_plain(x, w1, b1, w2, b2):
    """The plain MLP with each product split into two K-halves and added: the
    same function in another fp32 summation order (the control of the step
    comparisons).  The halves are strided views of 2-D operands, so autograd
    keeps no more than the plain version does."""
    C, M = x.shape[-1], w1.shape[0]
    x2 = x.reshape(-1, C)
    h = x2[:, :C // 2] @ w1[:, :C // 2].t() + torch.addmm(b1, x2[:, C // 2:], w1[:, C // 2:].t())
    a = F.gelu(h)
    out = a[:, :M // 2] @ w2[:, :M // 2].t() + torch.addmm(b2, a[:, M // 2:], w2[:, M // 2:].t())
    return out.reshape(x.shape)


def step_runs(model, fresh_state, step, modes=("kernels", "plain", "control")):
    """One train step from identical state with the kernels, with the plain
    versions, and with the plain versions and split MLP products (the
    control); mode "slab" runs the kernels with SAMRS_BILINEAR_SLAB=II_SLAB
    (K8's row-slab form where the slab divides the map): loss, launches,
    gradients, both AdamW moments (copied to the host: a 94-image pretrain
    step peaks near the card's 80 GB), the parameters that moved, and the
    first step's wall time of each."""
    from samrs_tpu_torch.kernels import fused_mlp

    runs = {}
    plain_mlp = fused_mlp.fused_mlp_plain
    for mode in modes:
        model.use_kernels = mode in ("kernels", "slab")
        fused_mlp.fused_mlp_plain = split_mlp_plain if mode == "control" else plain_mlp
        if mode == "slab":
            os.environ["SAMRS_BILINEAR_SLAB"] = str(II_SLAB)
        try:
            state = fresh_state()
            init = {k: v.clone() for k, v in model.state_dict().items() if "running" not in k}
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = step(state)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
        finally:
            fused_mlp.fused_mlp_plain = plain_mlp
            os.environ.pop("SAMRS_BILINEAR_SLAB", None)
        names = {p: n for n, p in model.named_parameters()}
        opt_state = state.optimizer.opt.state
        runs[mode] = dict(
            loss=float(metrics["loss"]), counts=read_counts(), first_s=dt,
            grads={n: p.grad.cpu() for n, p in model.named_parameters()},
            mu={names[p]: st["exp_avg"].cpu() for p, st in opt_state.items()},
            nu={names[p]: st["exp_avg_sq"].cpu() for p, st in opt_state.items()},
            moved=[k for k, v in model.state_dict().items()
                   if k in init and not torch.equal(v, init[k])])
        state.optimizer.zero_grad()
        del state, init, metrics
        torch.cuda.empty_cache()
    model.use_kernels = True
    return runs


def compare_steps(label: str, runs, want_counts, zero_grad=ZERO_GRAD):
    """Launches (the kernels' as `want_counts`, none on the plain runs), no
    parameter moved (lr 0 at step 0), |dloss| / loss <= STEP_LOSS_RTOL, and per
    gradient and AdamW moment the kernels-vs-plain rel-L2 over all parameters
    within CONTROL_FACTOR times the control-vs-plain one.  The zero-gradient
    parameters (`zero_grad`: RVSA's neck biases) are left out of the sums and
    printed against the whole norm."""
    k, p, c = runs["kernels"], runs["plain"], runs["control"]
    want = {kk: want_counts.get(kk, 0) for kk in k["counts"]}
    print(f"{label} launches: kernels {k['counts']}, plain {p['counts']}, control "
          f"{c['counts']}", flush=True)
    if k["counts"] != want or any(p["counts"].values()) or any(c["counts"].values()):
        raise RuntimeError(f"{label} launches {k['counts']} / {p['counts']}, want {want}")
    moved = k["moved"] + p["moved"] + c["moved"]
    if moved:
        raise RuntimeError(f"{label}: parameters moved at lr 0: {moved[:3]}")
    dloss = {m: abs(runs[m]["loss"] - p["loss"]) / abs(p["loss"]) for m in ("kernels", "control")}
    print(f"{label} loss kernels {k['loss']:.6f} plain {p['loss']:.6f} control {c['loss']:.6f} "
          f"(|d|/loss {dloss['kernels']:.3e} / control {dloss['control']:.3e}); first step s "
          f"kernels {k['first_s']:.3f} plain {p['first_s']:.3f}", flush=True)
    if not dloss["kernels"] <= STEP_LOSS_RTOL:
        raise RuntimeError(f"{label} loss |d|/loss {dloss['kernels']:.3e} > {STEP_LOSS_RTOL}")
    out = {}
    for what in ("grads", "mu", "nu"):
        ref = p[what]
        norm2 = sum(float((w.double() ** 2).sum()) for n, w in ref.items() if n not in zero_grad)
        dist, worst, zero = {}, {}, {}
        for mode in ("kernels", "control"):
            got = runs[mode][what]
            d2 = sum(float(((got[n] - w).double() ** 2).sum()) for n, w in ref.items()
                     if n not in zero_grad)
            dist[mode] = (d2 / norm2) ** 0.5
            errs = {n: rel_l2([got[n]], [w]) for n, w in ref.items()
                    if n not in zero_grad and w.any()}
            worst[mode] = max(errs.items(), key=lambda kv: kv[1])
            zero[mode] = max((float(torch.linalg.vector_norm((got[n] - ref[n]).double()))
                              for n in zero_grad), default=0.0) / norm2 ** 0.5
        print(f"{label} {what}: rel_l2 over all parameters kernels {dist['kernels']:.3e}, "
              f"control {dist['control']:.3e} (ratio "
              f"{dist['kernels'] / max(dist['control'], 1e-30):.2f}, limit {CONTROL_FACTOR}); "
              f"worst parameter kernels {worst['kernels'][1]:.3e} ({worst['kernels'][0]}), "
              f"control {worst['control'][1]:.3e} ({worst['control'][0]}); zero-gradient "
              f"biases against the norm kernels {zero['kernels']:.3e} control "
              f"{zero['control']:.3e}", flush=True)
        if not dist["kernels"] <= CONTROL_FACTOR * dist["control"]:
            raise RuntimeError(f"{label} {what}: kernels-vs-plain rel-L2 {dist['kernels']:.3e} > "
                               f"{CONTROL_FACTOR} x control {dist['control']:.3e}")
        out[what] = (dist["kernels"], dist["control"])
    return out


def time_steps(model, fresh_state, step, label: str, n_img: int, shape: str,
               order=(True, False, True)):
    """Warm s/step, img/s and peak memory with the kernels and with the plain
    versions (in `order`: kernels, plain, kernels); each path's first step
    is not timed (lazy module loads, the caching allocator's growth after
    the step comparison emptied it); returns {use_kernels: (s/step,
    bytes)}."""
    times = {True: [], False: []}
    peak = {}
    for use_kernels in order:
        model.use_kernels = use_kernels
        state = fresh_state()
        if not times[use_kernels]:
            step(state)
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(state)
            torch.cuda.synchronize()
            times[use_kernels].append(time.perf_counter() - t)
        peak[use_kernels] = torch.cuda.max_memory_allocated()
        del state
    model.use_kernels = True
    out = {}
    for use_kernels, name in ((True, "kernels"), (False, "plain")):
        if not times[use_kernels]:
            continue
        s_step = statistics.median(times[use_kernels])
        out[use_kernels] = (s_step, peak[use_kernels])
        print(f"{label} ({name}, {n_img} images at {shape}, fp32): {s_step:.4f} s/step, "
              f"{n_img / s_step:.2f} img/s, peak memory {peak[use_kernels] / 2**30:.2f} GiB",
              flush=True)
    return out


def train_step_phase(profile: bool = False):
    """One SEP pretrain step of vit_b_rvsa + UperNet (three heads, 17/12/65
    images at 224^2, fp32, TF32 off) from identical state with the kernels
    (K8, K10, K11), with their plain versions and with the control; the step
    is the schedule's step 0, so lr = 0 and the parameters must not move.
    Then the step's time and peak memory."""
    from samrs_tpu_torch.core.config import PretrainConfig
    from samrs_tpu_torch.seg.frameworks import build_multihead_model
    from samrs_tpu_torch.train import optim, trainer

    cfg = PretrainConfig()
    t0 = time.perf_counter()
    model = build_multihead_model(device="cuda",
                                  generator=torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"built vit_b_rvsa + UperNet ({n_params / 1e6:.1f} M parameters) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batches = train_batches(SEED + 2)
    sched = optim.warmup_cosine_schedule(cfg.optim.lr, cfg.total_iters, cfg.optim.warmup_iters)

    def fresh_state():
        model.load_state_dict(init)
        opt = optim.Optimizer(model, sched, weight_decay=cfg.optim.weight_decay,
                              grad_clip=cfg.optim.grad_clip, layer_decay=cfg.optim.layer_decay,
                              num_layers=model.encoder.depth)
        return trainer.TrainState(0, model, opt)

    step = lambda state: trainer.pretrain_step(state, batches, cfg.seed)
    compare_steps("train step", step_runs(model, fresh_state, step), STEP_LAUNCHES)
    timing = time_steps(model, fresh_state, step, "train step", sum(TRAIN_BATCH), "224^2")
    if profile:
        profile_step(model, fresh_state, step, "train step")
    del model, init, batches
    torch.cuda.empty_cache()
    return timing


def internimage_step_phase(profile: bool = False):
    """One SEP pretrain step of internimage_t + UperNet (full width and depth:
    channels 64, depths 4/4/18/4, groups 4/8/16/32; UperNet at 128; three
    heads, 17/12/65 images at 224^2, fp32, TF32 off) from identical state
    with the kernels (DCNv3 through dense K8, MLPs through K11), with the
    kernels and SAMRS_BILINEAR_SLAB=7 (every level's DCNv3 through K8's
    row-slab form), with the plain versions and with the control, each kernel
    run judged against the plain one by the rule of the train-step phase.
    The DCNv3 offset and mask linears start at zero, so every tap of this
    step lies exactly on a pixel.  Then s/step, img/s and peak memory of the
    dense, slab and plain steps."""
    from samrs_tpu_torch.core.config import PretrainConfig
    from samrs_tpu_torch.seg.frameworks import build_multihead_model
    from samrs_tpu_torch.train import optim, trainer

    cfg = PretrainConfig()
    t0 = time.perf_counter()
    model = build_multihead_model("internimage_t", device="cuda",
                                  generator=torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"built internimage_t + UperNet ({n_params / 1e6:.1f} M parameters) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batches = train_batches(SEED + 4)
    bset = optim.backbone_optim_settings("internimage_t", model.encoder)
    sched = optim.warmup_cosine_schedule(bset["lr"], cfg.total_iters, cfg.optim.warmup_iters)

    def fresh_state():
        model.load_state_dict(init)
        opt = optim.Optimizer(model, sched, weight_decay=bset["weight_decay"],
                              grad_clip=cfg.optim.grad_clip, layer_decay=bset["layer_decay"],
                              num_layers=bset["num_layers"], layer_id_scheme=bset["scheme"],
                              depths=bset["depths"])
        return trainer.TrainState(0, model, opt)

    step = lambda state: trainer.pretrain_step(state, batches, cfg.seed)
    runs = step_runs(model, fresh_state, step, modes=("kernels", "slab", "plain", "control"))
    compare_steps("internimage step (dense K8)", runs, II_STEP_LAUNCHES, zero_grad=())
    compare_steps("internimage step (K8-slab)", {**runs, "kernels": runs["slab"]},
                  II_SLAB_STEP_LAUNCHES, zero_grad=())
    n_img = sum(TRAIN_BATCH)
    timing = time_steps(model, fresh_state, step, "internimage step", n_img, "224^2")
    os.environ["SAMRS_BILINEAR_SLAB"] = str(II_SLAB)
    try:
        slab = time_steps(model, fresh_state, step, "internimage step, K8-slab", n_img, "224^2",
                          order=(True,))
    finally:
        os.environ.pop("SAMRS_BILINEAR_SLAB", None)
    if profile:
        profile_step(model, fresh_state, step, "internimage step")
        os.environ["SAMRS_BILINEAR_SLAB"] = str(II_SLAB)
        try:
            profile_step(model, fresh_state, step, "internimage step, K8-slab")
        finally:
            os.environ.pop("SAMRS_BILINEAR_SLAB", None)
    del model, init, batches, runs
    torch.cuda.empty_cache()
    return {"dense": timing[True], "slab": slab[True], "plain": timing[False]}


def m2f_discontinuities(model, batches):
    """Eval-mode forwards of every head with the kernels and with the plain
    versions: how many of the attention-mask bits each decoder layer derives
    from the previous output, and how many of the point-sampled assignments
    (the same matching points on both paths), differ."""
    from samrs_tpu_torch.seg.decoders import mask2former as m2f

    model.eval()
    bits = flips = assigns = changed = 0
    with torch.no_grad():
        for i, ((x, y), nc) in enumerate(zip(batches, TRAIN_CLASSES)):
            masks, matches = {}, {}
            for use_kernels in (True, False):
                model.use_kernels = use_kernels
                outs = model.forward_one(x, i)
                scales = [(7, 7), (14, 14), (28, 28)]
                masks[use_kernels] = [torch.sigmoid(m2f.resize_bilinear_antialias(
                    outs[layer][1], scales[layer % 3])) < 0.5 for layer in range(M2F_OUTPUTS - 1)]
                gt_masks, gt_valid = m2f.mask2former_targets(y, nc, tuple(outs[0][1].shape[-2:]))
                draw = m2f.generator_draws(torch.Generator(device="cuda").manual_seed(SEED + i))
                matches[use_kernels] = m2f.mask2former_assign(outs, gt_masks, gt_valid,
                                                              num_points=M2F_POINTS, draw=draw,
                                                              plain=not use_kernels)
                del outs
            bits += sum(m.numel() for m in masks[True])
            flips += sum(int((a != b).sum()) for a, b in zip(masks[True], masks[False]))
            assigns += matches[True].numel()
            changed += int((matches[True] != matches[False]).sum())
    model.use_kernels = True
    model.train()
    return bits, flips, assigns, changed


def mask2former_step_phase(profile: bool = False):
    """One Mask2Former pretrain step of vit_b_rvsa + Mask2Former (full width
    and depth, three heads, 17/12/65 images at 224^2, m2f_num_points 12544,
    fp32, TF32 off) from identical state with the kernels (K8, K9, K10, K11),
    with their plain versions and with the control, judged as the UperNet
    step (lr 0 at step 0; kernels within CONTROL_FACTOR x the control); the
    attention-mask bits and assignments that differ between the paths; then
    s/step, img/s and peak memory of both paths and the Hungarian
    assignment's host time."""
    from samrs_tpu_torch.core.config import PretrainConfig
    from samrs_tpu_torch.seg.decoders import mask2former as m2f
    from samrs_tpu_torch.seg.frameworks import build_multihead_mask2former_model
    from samrs_tpu_torch.train import optim, trainer

    cfg = PretrainConfig()
    t0 = time.perf_counter()
    model = build_multihead_mask2former_model(
        device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED + 8))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"built vit_b_rvsa + Mask2Former ({n_params / 1e6:.1f} M parameters) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batches = train_batches(SEED + 9)
    sched = optim.warmup_cosine_schedule(cfg.optim.lr, cfg.total_iters, cfg.optim.warmup_iters)

    def fresh_state():
        model.load_state_dict(init)
        opt = optim.Optimizer(model, sched, weight_decay=cfg.optim.weight_decay,
                              grad_clip=cfg.optim.grad_clip, layer_decay=cfg.optim.layer_decay,
                              num_layers=model.encoder.depth)
        return trainer.TrainState(0, model, opt)

    step = lambda state: trainer.pretrain_step_mask2former(state, batches, cfg.seed,
                                                           TRAIN_CLASSES, M2F_POINTS)
    dist = compare_steps("mask2former step", step_runs(model, fresh_state, step),
                         M2F_STEP_LAUNCHES)
    bits, flips, assigns, changed = m2f_discontinuities(model, batches)
    print(f"mask2former kernels vs plain (eval forward): {flips} of {bits} attention-mask bits "
          f"and {changed} of {assigns} assignments differ", flush=True)
    timing = time_steps(model, fresh_state, step, "mask2former step", sum(TRAIN_BATCH), "224^2")
    # the assignment's host time in one more step with the kernels: the wait for the
    # costs, their device-to-host copy, scipy's solve (one call a head)
    solve = m2f.hungarian_match
    spent = []

    def timed_match(cost):
        t = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = cost.cpu()
        t2 = time.perf_counter()
        out = solve(host)
        spent.append((t1 - t, t2 - t1, time.perf_counter() - t2, tuple(cost.shape)))
        return out.to(cost.device)

    m2f.hungarian_match = timed_match
    try:
        state = fresh_state()
        step(state)
        torch.cuda.synchronize()
    finally:
        m2f.hungarian_match = solve
    wait, copy, host = (sum(t[j] for t in spent) for j in range(3))
    print(f"mask2former Hungarian: {len(spent)} calls a step (costs {[t[3] for t in spent]}): "
          f"wait for the costs {wait * 1e3:.2f} ms, copy {copy * 1e3:.2f} ms, scipy "
          f"{host * 1e3:.2f} ms a step", flush=True)
    if profile:  # the device time of mask2former.point_sample's own launches too
        sample = m2f.point_sample

        def ranged(*args, **kwargs):
            with torch.profiler.record_function("mask2former.point_sample"):
                return sample(*args, **kwargs)

        m2f.point_sample = ranged
        try:
            profile_step(model, fresh_state, step, "mask2former step",
                         ranges=("mask2former.point_sample",))
        finally:
            m2f.point_sample = sample
    del model, init, batches, state
    torch.cuda.empty_cache()
    return dict(timing=timing, dist=dist, flips=(flips, bits), assign=(changed, assigns),
                hungarian_ms=host * 1e3)


def kernels_under(events, name: str):
    """{kernel name: device ms} of the kernels launched inside the
    record_function ranges called `name` (their CPU ops' kernels)."""
    out = {}

    def walk(e):
        for k in e.kernels:
            out[k.name] = out.get(k.name, 0.0) + k.duration / 1e3
        for c in e.cpu_children:
            walk(c)

    for e in events:
        if e.name == name:
            walk(e)
    return out


def profile_step(model, fresh_state, step, label: str, ranges=(), k8_records=None,
                 table: bool = True):
    """torch.profiler over one warm train step with the kernels: device time
    by operation and the device's busy share of the wall time; the device ms
    of K9's kernels and of PyTorch's elementwise kernels in the step, and of
    every kernel launched inside each record_function range in `ranges`;
    the table of operations under `table`.  Returns (profiled wall ms,
    device ms).  Late in a long run the profiler loses records: given
    `k8_records` (the step's K8 launches), a profile holding another count
    of K8 kernel records is taken again, and after three None is
    returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model.use_kernels = True
    state = fresh_state()
    step(state)
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(state)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        events = prof.key_averages()
        # device rows, without the device-side copies of record_function ranges
        rows = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in ranges
                and not getattr(e, "is_user_annotation", False)]
        k8 = sum(e.count for e in rows if re.search(r"bilinear_(fwd|bwd)_kernel", e.key))
        if k8_records is None or k8 == k8_records:
            break
        print(f"profile ({label}): {k8} of {k8_records} K8 records; profiling again", flush=True)
    else:
        print(f"profile ({label}): busy share not measured (3 profiles lost K8 records)",
              flush=True)
        return None
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"profile ({label}): wall {wall_ms:.2f} ms under the profiler, device "
          f"{device_ms:.2f} ms, busy {100 * device_ms / wall_ms:.1f}% of the profiled wall "
          f"({k8} K8 records)", flush=True)
    for kind, word in (("K9 (point_sample kernels)", "point_sample"),
                       ("elementwise kernels", "elementwise_kernel")):
        ms = sum(e.self_device_time_total for e in rows if word in e.key) / 1e3
        n = sum(e.count for e in rows if word in e.key)
        print(f"profile ({label}): {kind}: {ms:.3f} ms device in {n} launches "
              f"({100 * ms / device_ms:.1f}% of device time)", flush=True)
    for name in ranges:
        inside = kernels_under(prof.events(), name)
        k9 = sum(v for k, v in inside.items() if "point_sample" in k)
        print(f"profile ({label}): inside {name}: {sum(inside.values()):.3f} ms device, K9 "
              f"{k9:.3f} ms, other kernels {sum(inside.values()) - k9:.3f} ms: "
              + ", ".join(f"{k[:60]} {v:.3f}" for k, v in
                          sorted(inside.items(), key=lambda kv: -kv[1])[:8]), flush=True)
    if table:
        print(events.table(sort_by="self_device_time_total", row_limit=25,
                           max_name_column_width=70), flush=True)
    return wall_ms, device_ms


def finetune_step_phase(profile: bool = False):
    """SegModel(vit_b, upernet, 6 classes, 512^2) at full width and depth with
    its seeded init, batch 8, fp32, TF32 off: eval-mode logits with the
    kernels against the plain versions (K10 12 and K11 12 launches a
    forward), one finetune step from identical state with the kernels, the
    plain versions and the control, then warm s/step, img/s and peak memory."""
    from samrs_tpu_torch.core.config import FinetuneConfig
    from samrs_tpu_torch.seg.frameworks import build_seg_model
    from samrs_tpu_torch.train import optim, trainer

    cfg = FinetuneConfig()
    model = build_seg_model("vit_b", "upernet", FT_CLASSES, FT_SIZE, "cuda",
                            torch.Generator(device="cuda").manual_seed(SEED + 4))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(SEED + 5)
    x = torch.from_numpy(rng.normal(size=(FT_BATCH, FT_SIZE, FT_SIZE, 3)).astype(np.float32)).cuda()
    y = rng.integers(0, FT_CLASSES, (FT_BATCH, FT_SIZE, FT_SIZE))
    y[:, :16] = 255  # some ignored pixels
    y = torch.from_numpy(y).cuda()

    model.eval()
    with torch.no_grad():
        reset_counts()
        logits = model(x)
        torch.cuda.synchronize()
        counts = read_counts()
        model.use_kernels = False
        logits_p = model(x)
        model.use_kernels = True
    err = rel_l2([logits], [logits_p])
    want = {k: {"K10": VIT_DEPTH, "K11": VIT_DEPTH}.get(k, 0) for k in counts}
    want["K11s"] = checked_splits("finetune eval forward", counts, 0)
    print(f"finetune eval forward (vit_b, {FT_BATCH} x {FT_SIZE}^2): launches {counts}; logits "
          f"{tuple(logits.shape)} kernels vs plain rel_l2={err:.3e}", flush=True)
    if counts != want:
        raise RuntimeError(f"finetune eval forward launches {counts} != {want}")
    if tuple(logits.shape) != (FT_BATCH, FT_SIZE, FT_SIZE, FT_CLASSES) or \
            not torch.isfinite(logits).all():
        raise RuntimeError(f"finetune logits {tuple(logits.shape)} or non-finite")
    if not err <= EVAL_RTOL:
        raise RuntimeError(f"finetune eval logits rel-L2 {err:.3e} > {EVAL_RTOL}")
    del logits, logits_p

    sched = optim.warmup_cosine_schedule(cfg.optim.lr, 1000, cfg.optim.warmup_iters)

    def fresh_state():
        model.load_state_dict(init)
        opt = optim.Optimizer(model, sched, weight_decay=cfg.optim.weight_decay,
                              grad_clip=cfg.optim.grad_clip, layer_decay=cfg.optim.layer_decay,
                              num_layers=model.encoder.depth)
        return trainer.TrainState(0, model, opt)

    step = lambda state: trainer.finetune_step(state, x, y, cfg.seed)
    compare_steps("finetune step", step_runs(model, fresh_state, step),
                  {"K10": VIT_DEPTH, "K11": VIT_DEPTH, "K11s": 2 * VIT_DEPTH})
    timing = time_steps(model, fresh_state, step, "finetune step", FT_BATCH, f"{FT_SIZE}^2")
    if profile:
        profile_step(model, fresh_state, step, "finetune step")
    del model, init, x, y
    torch.cuda.empty_cache()
    return timing


def write_samrs_layout(root: str, n_train, n_val: int = 8, size: int = 256) -> None:
    """DATASET_LAYOUT's three trees under `root`: seeded noise images and
    labels uniform over each dataset's classes, train.txt and valid.txt."""
    from PIL import Image

    from samrs_tpu_torch.train.pretrain import DATASET_CLASSES, DATASET_LAYOUT

    rng = np.random.default_rng(SEED + 3)
    for name, (sub, img_dir, lbl_dir, ext) in DATASET_LAYOUT.items():
        base = os.path.join(root, sub)
        os.makedirs(os.path.join(base, img_dir))
        os.makedirs(os.path.join(base, lbl_dir))
        names = [f"{name}_{i:04d}" for i in range(n_train[name] + n_val)]
        for nm in names:
            Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
                os.path.join(base, img_dir, nm + ext))
            Image.fromarray(rng.integers(0, DATASET_CLASSES[name], (size, size),
                                         dtype=np.uint8)).save(
                os.path.join(base, lbl_dir, nm + ".png"))
        with open(os.path.join(base, "train.txt"), "w") as f:
            f.write("\n".join(names[:n_train[name]]))
        with open(os.path.join(base, "valid.txt"), "w") as f:
            f.write("\n".join(names[n_train[name]:]))


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def pretrain_phase(tmp: str):
    """``run_pretrain`` at its defaults (vit_b_rvsa + UperNet, 17/12/65 at
    224^2) on a synthetic SAMRS layout under `tmp`: PRETRAIN_ITERS steps,
    then the evaluation with a per-dataset mIoU line, ``last``/``best``
    checkpoints with their encoder copies, and a resume from ``last`` that
    restores the step and the weights.  Returns the launches and the path of
    ``best_encoder.pt``."""
    from samrs_tpu_torch.core.config import PretrainConfig
    from samrs_tpu_torch.train.pretrain import apply_optim_defaults, run_pretrain

    handler = _Lines()
    log = logging.getLogger("samrs_tpu_torch.pretrain")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    root = os.path.join(tmp, "samrs")
    n_val = 8
    write_samrs_layout(root, {"sota": 20, "sior": 15, "fast": 70}, n_val)
    over = [f"data.root={root}", f"total_iters={PRETRAIN_ITERS}",
            f"eval_interval={PRETRAIN_ITERS}", f"data.val_images={n_val}",
            f"ckpt_dir={os.path.join(tmp, 'pretrain_ckpt')}"]
    cfg = apply_optim_defaults(PretrainConfig().override(over), over)
    reset_counts()
    t = time.perf_counter()
    state = run_pretrain(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_counts()
    evals = len(cfg.data.datasets) * -(-n_val // 8)  # eval forwards of 8 images
    want = {k: 0 for k in launches}
    want.update(K8f=PRETRAIN_ITERS * STEP_LAUNCHES["K8f"] + evals * RVSA_BLOCKS,
                K8b=PRETRAIN_ITERS * STEP_LAUNCHES["K8b"],
                K10=PRETRAIN_ITERS * STEP_LAUNCHES["K10"] + evals * FULL_BLOCKS,
                K11=PRETRAIN_ITERS * STEP_LAUNCHES["K11"] + evals * VIT_DEPTH,
                K11s=checked_splits("pretrain", launches, PRETRAIN_ITERS * STEP_LAUNCHES["K11s"]))
    print(f"pretrain launches: {launches}", flush=True)
    if launches != want:
        raise RuntimeError(f"pretrain launches {launches} != {want}")
    if state.step != PRETRAIN_ITERS:
        raise RuntimeError(f"run_pretrain stopped at step {state.step}")
    vals = [ln for ln in handler.lines if ln.startswith("val[")]
    print("\n".join(["pretrain " + ln for ln in handler.lines]), flush=True)
    log.removeHandler(handler)
    if sorted(v.split("]")[0][4:] for v in vals) != sorted(cfg.data.datasets):
        raise RuntimeError(f"per-dataset mIoU lines: {vals}")
    for v in vals:
        miou = float(v.split("mIoU ")[1].split()[0])
        if not 0.0 <= miou <= 1.0:
            raise RuntimeError(f"mIoU out of range: {v}")
    files = sorted(os.listdir(cfg.ckpt_dir))
    if not {"last.pt", "last_encoder.pt", "best.pt", "best_encoder.pt"} <= set(files):
        raise RuntimeError(f"checkpoints written: {files}")
    trained = {k: v.clone() for k, v in state.model.state_dict().items()}
    del state
    torch.cuda.empty_cache()
    over2 = over + ["resume=last"]
    cfg2 = apply_optim_defaults(PretrainConfig().override(over2), over2)
    resumed = run_pretrain(cfg2)
    same = all(torch.equal(resumed.model.state_dict()[k], v) for k, v in trained.items())
    print(f"pretrain: {PRETRAIN_ITERS} steps + eval in {wall:.1f} s, checkpoints {files}, "
          f"resumed at step {resumed.step}, weights restored {same}", flush=True)
    if resumed.step != PRETRAIN_ITERS or not same:
        raise RuntimeError("resume from last.pt did not restore the step and weights")
    del resumed, trained
    torch.cuda.empty_cache()
    return launches, os.path.join(cfg.ckpt_dir, "best_encoder.pt")


def internimage_pretrain_phase(tmp: str, slab: bool = False):
    """``run_pretrain`` with backbone=internimage_t at the defaults otherwise
    (UperNet, 17/12/65 at 224^2, the family's lr / wd / depthwise layer ids)
    on the synthetic SAMRS layout of the pretrain phase, with dense K8 or
    (``slab``) with SAMRS_BILINEAR_SLAB=7: PRETRAIN_ITERS steps, the
    evaluation with a per-dataset mIoU line, ``last`` / ``best`` checkpoints
    with their encoder copies.  Returns the launches."""
    from samrs_tpu_torch.core.config import PretrainConfig
    from samrs_tpu_torch.train.pretrain import apply_optim_defaults, run_pretrain

    handler = _Lines()
    log = logging.getLogger("samrs_tpu_torch.pretrain")
    log.addHandler(handler)
    root, n_val = os.path.join(tmp, "samrs"), 8
    log.setLevel(logging.INFO)
    label = "internimage pretrain" + (" (K8-slab)" if slab else "")
    over = ["backbone=internimage_t", f"data.root={root}", f"total_iters={PRETRAIN_ITERS}",
            f"eval_interval={PRETRAIN_ITERS}", f"data.val_images={n_val}",
            f"ckpt_dir={os.path.join(tmp, 'internimage_slab' if slab else 'internimage')}"]
    cfg = apply_optim_defaults(PretrainConfig().override(over), over)
    if slab:
        os.environ["SAMRS_BILINEAR_SLAB"] = str(II_SLAB)
    try:
        reset_counts()
        t = time.perf_counter()
        state = run_pretrain(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = read_counts()
    finally:
        os.environ.pop("SAMRS_BILINEAR_SLAB", None)
        log.removeHandler(handler)
    evals = len(cfg.data.datasets) * -(-n_val // 8)
    per_step, per_eval = dict(II_STEP_LAUNCHES), dict(II_EVAL_LAUNCHES)
    if slab:
        per_step = {"K8sf" if k == "K8f" else "K8sb" if k == "K8b" else k: v
                    for k, v in per_step.items()}
        per_eval = {"K8sf" if k == "K8f" else k: v for k, v in per_eval.items()}
    want = {k: PRETRAIN_ITERS * per_step.get(k, 0) + evals * per_eval.get(k, 0)
            for k in launches}
    want["K11s"] = checked_splits(label, launches, PRETRAIN_ITERS * per_step["K11s"])
    print("\n".join([f"{label} " + ln for ln in handler.lines]), flush=True)
    print(f"{label} launches: {launches} ({PRETRAIN_ITERS} steps + eval in "
          f"{wall:.1f} s; lr {cfg.optim.lr}, wd {cfg.optim.weight_decay}, layer decay "
          f"{cfg.optim.layer_decay})", flush=True)
    if launches != want:
        raise RuntimeError(f"{label} launches {launches} != {want}")
    if state.step != PRETRAIN_ITERS:
        raise RuntimeError(f"run_pretrain(internimage_t) stopped at step {state.step}")
    vals = [ln for ln in handler.lines if ln.startswith("val[")]
    if sorted(v.split("]")[0][4:] for v in vals) != sorted(cfg.data.datasets):
        raise RuntimeError(f"per-dataset mIoU lines: {vals}")
    for v in vals:
        if not 0.0 <= float(v.split("mIoU ")[1].split()[0]) <= 1.0:
            raise RuntimeError(f"mIoU out of range: {v}")
    files = sorted(os.listdir(cfg.ckpt_dir))
    if not {"last.pt", "last_encoder.pt", "best.pt", "best_encoder.pt"} <= set(files):
        raise RuntimeError(f"checkpoints written: {files}")
    finite = all(torch.isfinite(v).all() for v in state.model.state_dict().values()
                 if v.is_floating_point())
    if not finite:
        raise RuntimeError("run_pretrain(internimage_t): non-finite weights")
    del state
    torch.cuda.empty_cache()
    return launches


def mask2former_driver_phase(tmp: str):
    """``run_pretrain(decoder=mask2former, m2f_num_points=12544)`` at the
    defaults otherwise (vit_b_rvsa, 17/12/65 at 224^2) on the synthetic SAMRS
    layout the pretrain phase wrote under `tmp`: PRETRAIN_ITERS steps, the
    evaluation with a per-dataset mIoU line, ``last``/``best`` checkpoints
    with their encoder copies, and a resume from ``last`` that restores the
    step and the weights.  Returns the launches."""
    from samrs_tpu_torch.core.config import PretrainConfig
    from samrs_tpu_torch.train.pretrain import apply_optim_defaults, run_pretrain

    handler = _Lines()
    log = logging.getLogger("samrs_tpu_torch.pretrain")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    n_val = 8
    over = [f"data.root={os.path.join(tmp, 'samrs')}", "decoder=mask2former",
            f"m2f_num_points={M2F_POINTS}", f"total_iters={PRETRAIN_ITERS}",
            f"eval_interval={PRETRAIN_ITERS}", f"data.val_images={n_val}",
            f"ckpt_dir={os.path.join(tmp, 'm2f_ckpt')}"]
    cfg = apply_optim_defaults(PretrainConfig().override(over), over)
    reset_counts()
    t = time.perf_counter()
    state = run_pretrain(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_counts()
    evals = len(cfg.data.datasets) * -(-n_val // 8)  # eval forwards of 8 images
    want = {k: PRETRAIN_ITERS * M2F_STEP_LAUNCHES.get(k, 0) + evals * M2F_EVAL_LAUNCHES.get(k, 0)
            for k in launches}
    want["K11s"] = checked_splits("mask2former pretrain", launches,
                                  PRETRAIN_ITERS * M2F_STEP_LAUNCHES["K11s"])
    print(f"mask2former pretrain launches: {launches}", flush=True)
    if launches != want:
        raise RuntimeError(f"mask2former pretrain launches {launches} != {want}")
    if state.step != PRETRAIN_ITERS:
        raise RuntimeError(f"run_pretrain (mask2former) stopped at step {state.step}")
    vals = [ln for ln in handler.lines if ln.startswith("val[")]
    print("\n".join(["mask2former pretrain " + ln for ln in handler.lines]), flush=True)
    log.removeHandler(handler)
    if sorted(v.split("]")[0][4:] for v in vals) != sorted(cfg.data.datasets):
        raise RuntimeError(f"per-dataset mIoU lines: {vals}")
    for v in vals:
        miou = float(v.split("mIoU ")[1].split()[0])
        if not 0.0 <= miou <= 1.0:
            raise RuntimeError(f"mIoU out of range: {v}")
    losses = [float(ln.split(" loss ")[1].split()[0]) for ln in handler.lines
              if ln.startswith("iter ") and " loss " in ln]
    if not losses or not all(np.isfinite(losses)):
        raise RuntimeError(f"mask2former losses: {losses}")
    files = sorted(os.listdir(cfg.ckpt_dir))
    if not {"last.pt", "last_encoder.pt", "best.pt", "best_encoder.pt"} <= set(files):
        raise RuntimeError(f"checkpoints written: {files}")
    trained = {k: v.clone() for k, v in state.model.state_dict().items()}
    del state
    torch.cuda.empty_cache()
    over2 = over + ["resume=last"]
    cfg2 = apply_optim_defaults(PretrainConfig().override(over2), over2)
    resumed = run_pretrain(cfg2)
    same = all(torch.equal(resumed.model.state_dict()[k], v) for k, v in trained.items())
    print(f"mask2former pretrain: {PRETRAIN_ITERS} steps + eval in {wall:.1f} s, checkpoints "
          f"{files}, resumed at step {resumed.step}, weights restored {same}", flush=True)
    if resumed.step != PRETRAIN_ITERS or not same:
        raise RuntimeError("resume from last.pt did not restore the step and weights")
    del resumed, trained
    torch.cuda.empty_cache()
    return launches


def adapter_k8_phase(gen):
    """K8 forward and backward at the ViT-Adapter's FAST-head shapes (65
    images x 12 deformable heads of 32 channels, generic coordinates): the
    injector's three levels (28^2, 14^2, 7^2 maps; the 196 ViT tokens, 4
    points) and the extractor's one (14^2; the 1029 conv tokens, 4 points)."""
    BG = TRAIN_BATCH[2] * 12
    cases = [(f"adapter_inj_l{h}", BG, h, h, 32, 196, 4, torch.float32, "window")
             for h in (28, 14, 7)]
    cases.append(("adapter_ext", BG, 14, 14, 32, 1029, 4, torch.float32, "window"))
    return k8_cases(gen, cases, loop=True)


def adapter_step_phase(profile: bool = False):
    """One SEP pretrain step of vit_adapter_b + UperNet at full width and
    depth (ViT-B, 12 deformable heads, 4 interactions and 2 extra
    extractors, the 64-wide spatial prior; UperNet at 768; three heads,
    17/12/65 images at 224^2, fp32, TF32 off; the family's lr / wd / layer
    decay 0.95) from identical state with the kernels (K8 54 + 54, K10 36,
    K11 36 launches, counted on the card), the plain versions and the
    control, judged by the rule of the train-step phase; then s/step, img/s
    and peak memory of both paths and the device's busy share of a warm
    kernel step."""
    from samrs_tpu_torch.core.config import PretrainConfig
    from samrs_tpu_torch.seg.frameworks import build_multihead_model
    from samrs_tpu_torch.train import optim, trainer

    cfg = PretrainConfig()
    t0 = time.perf_counter()
    model = build_multihead_model("vit_adapter_b", device="cuda",
                                  generator=torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"built vit_adapter_b + UperNet ({n_params / 1e6:.1f} M parameters) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batches = train_batches(SEED + 8)
    bset = optim.backbone_optim_settings("vit_adapter_b", model.encoder)
    sched = optim.warmup_cosine_schedule(bset["lr"], cfg.total_iters, cfg.optim.warmup_iters)

    def fresh_state():
        model.load_state_dict(init)
        opt = optim.Optimizer(model, sched, weight_decay=bset["weight_decay"],
                              grad_clip=cfg.optim.grad_clip, layer_decay=bset["layer_decay"],
                              num_layers=bset["num_layers"], layer_id_scheme=bset["scheme"])
        return trainer.TrainState(0, model, opt)

    step = lambda state: trainer.pretrain_step(state, batches, cfg.seed)
    runs = step_runs(model, fresh_state, step)
    counted = runs["kernels"]["counts"]
    compare_steps("adapter step", runs, ADAPTER_STEP_LAUNCHES, zero_grad=ADAPTER_ZERO_GRAD)
    timing = time_steps(model, fresh_state, step, "adapter step", sum(TRAIN_BATCH), "224^2")
    busy = profile_step(model, fresh_state, step, "adapter step",
                        k8_records=ADAPTER_STEP_LAUNCHES["K8f"] + ADAPTER_STEP_LAUNCHES["K8b"],
                        table=profile)
    del model, init, batches, runs
    torch.cuda.empty_cache()
    return {"timing": timing, "busy": busy, "counts": counted}


def adapter_pretrain_phase(tmp: str):
    """``python -m samrs_tpu_torch.train.pretrain backbone=vit_adapter_b
    decoder=unetpp`` at the defaults otherwise (17/12/65 at 224^2, the
    family's optimizer row) on the synthetic SAMRS layout under `tmp`:
    ADAPTER_ITERS steps, the evaluation with a per-dataset mIoU line,
    ``last`` / ``best`` checkpoints with their encoder copies.  Returns the
    launches and the path of ``best_encoder.pt``."""
    from samrs_tpu_torch.train import pretrain

    handler = _Lines()
    log = logging.getLogger("samrs_tpu_torch.pretrain")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    n_val = 8
    ckpt = os.path.join(tmp, "adapter_pretrain")
    reset_counts()
    t = time.perf_counter()
    try:
        pretrain.main(["backbone=vit_adapter_b", "decoder=unetpp",
                       f"data.root={os.path.join(tmp, 'samrs')}", f"total_iters={ADAPTER_ITERS}",
                       f"eval_interval={ADAPTER_ITERS}", f"data.val_images={n_val}",
                       f"ckpt_dir={ckpt}"])
        torch.cuda.synchronize()
    finally:
        log.removeHandler(handler)
    wall = time.perf_counter() - t
    launches = read_counts()
    evals = 3 * -(-n_val // 8)
    want = {k: ADAPTER_ITERS * ADAPTER_STEP_LAUNCHES.get(k, 0) + evals *
            ADAPTER_EVAL_LAUNCHES.get(k, 0) for k in launches}
    want["K11s"] = checked_splits("adapter pretrain", launches,
                                  ADAPTER_ITERS * ADAPTER_STEP_LAUNCHES["K11s"])
    print("\n".join(["adapter pretrain " + ln for ln in handler.lines]), flush=True)
    print(f"adapter pretrain (unetpp) launches: {launches} ({ADAPTER_ITERS} steps + eval in "
          f"{wall:.1f} s)", flush=True)
    if launches != want:
        raise RuntimeError(f"adapter pretrain launches {launches} != {want}")
    vals = [ln for ln in handler.lines if ln.startswith("val[")]
    if sorted(v.split("]")[0][4:] for v in vals) != ["fast", "sior", "sota"]:
        raise RuntimeError(f"per-dataset mIoU lines: {vals}")
    for v in vals:
        if not 0.0 <= float(v.split("mIoU ")[1].split()[0]) <= 1.0:
            raise RuntimeError(f"mIoU out of range: {v}")
    if not any(ln.startswith(f"iter {ADAPTER_ITERS} eval") for ln in handler.lines):
        raise RuntimeError("run_pretrain(vit_adapter_b) logged no eval at its last step")
    files = sorted(os.listdir(ckpt))
    if not {"last.pt", "last_encoder.pt", "best.pt", "best_encoder.pt"} <= set(files):
        raise RuntimeError(f"checkpoints written: {files}")
    saved = torch.load(os.path.join(ckpt, "last.pt"), map_location="cpu", weights_only=True)
    if saved["step"] != ADAPTER_ITERS or not all(
            torch.isfinite(v).all() for v in saved["model"].values() if v.is_floating_point()):
        raise RuntimeError(f"last.pt at step {saved['step']} or with non-finite weights")
    return launches, os.path.join(ckpt, "best_encoder.pt")


def adapter_finetune_phase(tmp: str, pretrained: str):
    """``python -m samrs_tpu_torch.train.finetune backbone=vit_adapter_b
    decoder=unet`` (Potsdam at 512^2, batch 8) for one epoch of a synthetic
    Potsdam layout, grafting the adapter pretrain's ``best_encoder.pt`` (its
    pos-embed resized 14^2 -> 32^2), then ``python -m
    samrs_tpu_torch.train.evaluate`` with the same backbone and decoder on
    its ``last.pt`` over the layout's test images (flip TTA): launches, the
    epoch line, the checkpoints, the gray and colour PNGs.  Returns the
    finetune's and the test's launches."""
    from PIL import Image

    from samrs_tpu_torch.train import evaluate, finetune

    data = os.path.join(tmp, "adapter_data")
    write_potsdam_layout(data, ADAPTER_FT_TRAIN, ADAPTER_FT_VAL)
    handler = _Lines()
    log = logging.getLogger("samrs_tpu_torch.finetune")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    ckpt = os.path.join(tmp, "adapter_finetune")
    reset_counts()
    t = time.perf_counter()
    try:
        finetune.main(["backbone=vit_adapter_b", "decoder=unet", f"data.root={data}", "epochs=1",
                       f"data.val_images={ADAPTER_FT_VAL}", f"pretrained={pretrained}",
                       f"ckpt_dir={ckpt}"])
        torch.cuda.synchronize()
    finally:
        log.removeHandler(handler)
    wall = time.perf_counter() - t
    ft = read_counts()
    steps = ADAPTER_FT_TRAIN // FT_BATCH
    want = {k: (steps + 1) * ADAPTER_EVAL_LAUNCHES.get(k, 0) for k in ft}
    want.update(K8b=steps * ADAPTER_MSDA,
                K11s=checked_splits("adapter finetune", ft, steps * 2 * VIT_DEPTH))
    print("\n".join(["adapter finetune " + ln for ln in handler.lines]), flush=True)
    print(f"adapter finetune (unet) launches: {ft} ({steps} steps + 1 eval batch in {wall:.1f} "
          f"s)", flush=True)
    if ft != want:
        raise RuntimeError(f"adapter finetune launches {ft} != {want}")
    epochs = [ln for ln in handler.lines if ln.startswith("epoch 1/1")]
    if len(epochs) != 1 or not 0.0 <= float(epochs[0].split("mIoU ")[1].split()[0]) <= 1.0:
        raise RuntimeError(f"epoch lines: {epochs}")
    if not any(ln.startswith("loaded pretrained encoder") for ln in handler.lines):
        raise RuntimeError("the adapter's SEP encoder was not grafted")
    if not {"last.pt", "best.pt"} <= set(os.listdir(ckpt)):
        raise RuntimeError(f"finetune checkpoints written: {os.listdir(ckpt)}")
    out = os.path.join(tmp, "adapter_test")
    reset_counts()
    t = time.perf_counter()
    evaluate.main(["--backbone", "vit_adapter_b", "--decoder", "unet", "--checkpoint",
                   os.path.join(ckpt, "last.pt"), "--data-root", data, "--save-dir", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    test = read_counts()
    fwd = 2 * ADAPTER_FT_VAL  # one batch of crops an image, and its flip
    want = {k: fwd * ADAPTER_EVAL_LAUNCHES.get(k, 0) for k in test}
    want["K11s"] = checked_splits("adapter test", test, 0)
    print(f"adapter test (unet) launches: {test}; {ADAPTER_FT_VAL} images in {wall:.2f} s",
          flush=True)
    if test != want:
        raise RuntimeError(f"adapter test launches {test} != {want}")
    for sub in ("gray", "color"):
        files = sorted(os.listdir(os.path.join(out, sub)))
        if len(files) != ADAPTER_FT_VAL:
            raise RuntimeError(f"adapter test {sub} PNGs: {files}")
        with Image.open(os.path.join(out, sub, files[0])) as im:
            if im.size != (600, 600):
                raise RuntimeError(f"adapter test {sub} PNG of size {im.size}")
    return ft, test


def adapter_phase(gen, profile: bool = False):
    """This slice's path: K8 at the ViT-Adapter's shapes, one vit_adapter_b +
    UperNet SEP step by the control rule, the pretrain driver with UNet++ on
    a synthetic SAMRS layout of its own, the finetune and evaluate drivers
    with UNet.  Returns their results."""
    t0 = time.perf_counter()
    k8 = adapter_k8_phase(gen)
    step = adapter_step_phase(profile)
    with tempfile.TemporaryDirectory() as tmp:
        write_samrs_layout(os.path.join(tmp, "samrs"), {"sota": 20, "sior": 15, "fast": 70}, 8)
        pre, encoder = adapter_pretrain_phase(tmp)
        ft, test = adapter_finetune_phase(tmp, encoder)
    (s_k, peak_k), (s_p, peak_p) = step["timing"][True], step["timing"][False]
    busy = "not measured" if step["busy"] is None else \
        f"{100 * step['busy'][1] / step['busy'][0]:.1f}%"
    print(f"adapter summary: kernels {s_k:.4f} s/step ({sum(TRAIN_BATCH) / s_k:.2f} img/s, peak "
          f"{peak_k / 2**30:.2f} GiB, busy {busy}), plain {s_p:.4f} s/step "
          f"({sum(TRAIN_BATCH) / s_p:.2f} img/s, peak {peak_p / 2**30:.2f} GiB); phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(k8=k8, step=step, pretrain=pre, finetune=ft, test=test)


def backbone_k11_phase(gen):
    """K11 at the new backbones' MLP shapes on the FAST head's tokens (65
    images at 56^2 .. 7^2): Swin-T's four stages (C 96 / 192 / 384 / 768, M
    4C; C 96 in the fused form) and ViTAEv2-S's ReductionCells (C = M = 64 /
    128 / 256 / 512), by ``k11_case``."""
    out = {}
    for s, C in enumerate((96, 192, 384, 768)):
        out[f"swin_c{C}"] = k11_case(gen, f"swin_t stage {s}", TRAIN_BATCH[2] * (56 >> s) ** 2,
                                     C, 4 * C)
    for s, C in enumerate((64, 128, 256, 512)):
        out[f"vitae_rc{C}"] = k11_case(gen, f"vitaev2_s reduction cell {s}",
                                       TRAIN_BATCH[2] * (56 >> s) ** 2, C, C)
    return out


def backbone_zero_grad(model):
    return tuple(n for n, _ in model.named_parameters() if re.fullmatch(BACKBONE_ZERO_GRAD, n))


def backbone_step_phase(name: str, profile: bool = False):
    """One SEP pretrain step of `name` + UperNet at full width and depth
    (17/12/65 images at 224^2, fp32, TF32 off, the family's optimizer row at
    the global batch of 94) from identical state with the kernels (K11 3 x
    BACKBONE_MLPS[name] launches and every weight split once, counted on the
    card), the plain versions and the control, judged by the rule of the
    train-step phase; then s/step, img/s and peak memory of both paths and
    the device's busy share of a warm kernel step."""
    from samrs_tpu_torch.core.config import PretrainConfig
    from samrs_tpu_torch.seg.frameworks import build_multihead_model
    from samrs_tpu_torch.train import optim, trainer

    cfg = PretrainConfig()
    t0 = time.perf_counter()
    model = build_multihead_model(name, device="cuda",
                                  generator=torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"built {name} + UperNet ({n_params / 1e6:.1f} M parameters) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batches = train_batches(SEED + 9)
    bset = optim.backbone_optim_settings(name, model.encoder, sum(TRAIN_BATCH))
    sched = optim.warmup_cosine_schedule(bset["lr"], cfg.total_iters, cfg.optim.warmup_iters)

    def fresh_state():
        model.load_state_dict(init)
        opt = optim.Optimizer(model, sched, weight_decay=bset["weight_decay"],
                              grad_clip=cfg.optim.grad_clip, layer_decay=bset["layer_decay"],
                              num_layers=bset["num_layers"], layer_id_scheme=bset["scheme"],
                              depths=bset["depths"])
        return trainer.TrainState(0, model, opt)

    step = lambda state: trainer.pretrain_step(state, batches, cfg.seed)
    runs = step_runs(model, fresh_state, step)
    counted = runs["kernels"]["counts"]
    n = BACKBONE_MLPS[name]
    compare_steps(f"{name} step", runs, {"K11": 3 * n, "K11s": 2 * n},
                  zero_grad=backbone_zero_grad(model))
    timing = time_steps(model, fresh_state, step, f"{name} step", sum(TRAIN_BATCH), "224^2")
    busy = profile_step(model, fresh_state, step, f"{name} step", table=profile)
    del model, init, batches, runs
    torch.cuda.empty_cache()
    return {"timing": timing, "busy": busy, "counts": counted}


def swin_finetune_step_phase():
    """SegModel(swin_t, upernet, 6 classes) at 512^2, batch 8, fp32: every
    stage pads its map to a window multiple (128 -> 133, 64 -> 70, 32 -> 35,
    16 -> 21) and rolls the padded map.  Eval-mode logits with the kernels
    against the plain versions (K11 12 launches a forward), one finetune step
    from identical state with the kernels, the plain versions and the
    control by the rule of the train-step phase, then s/step and peak
    memory."""
    from samrs_tpu_torch.core.config import FinetuneConfig
    from samrs_tpu_torch.seg.frameworks import build_seg_model
    from samrs_tpu_torch.train import optim, trainer

    cfg = FinetuneConfig()
    model = build_seg_model("swin_t", "upernet", FT_CLASSES, FT_SIZE, "cuda",
                            torch.Generator(device="cuda").manual_seed(SEED + 10))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(SEED + 11)
    x = torch.from_numpy(rng.normal(size=(FT_BATCH, FT_SIZE, FT_SIZE, 3)).astype(np.float32)).cuda()
    y = rng.integers(0, FT_CLASSES, (FT_BATCH, FT_SIZE, FT_SIZE))
    y[:, :16] = 255  # some ignored pixels
    y = torch.from_numpy(y).cuda()
    n = BACKBONE_MLPS["swin_t"]
    model.eval()
    with torch.no_grad():
        reset_counts()
        logits = model(x)
        torch.cuda.synchronize()
        counts = read_counts()
        model.use_kernels = False
        logits_p = model(x)
        model.use_kernels = True
    err = rel_l2([logits], [logits_p])
    want = {k: {"K11": n}.get(k, 0) for k in counts}
    want["K11s"] = checked_splits("swin_t finetune eval forward", counts, 0)
    print(f"swin_t finetune eval forward ({FT_BATCH} x {FT_SIZE}^2): launches {counts}; logits "
          f"{tuple(logits.shape)} kernels vs plain rel_l2={err:.3e}", flush=True)
    if counts != want:
        raise RuntimeError(f"swin_t finetune eval forward launches {counts} != {want}")
    if tuple(logits.shape) != (FT_BATCH, FT_SIZE, FT_SIZE, FT_CLASSES) or \
            not torch.isfinite(logits).all():
        raise RuntimeError(f"swin_t finetune logits {tuple(logits.shape)} or non-finite")
    if not err <= EVAL_RTOL:
        raise RuntimeError(f"swin_t finetune eval logits rel-L2 {err:.3e} > {EVAL_RTOL}")
    del logits, logits_p
    sched = optim.warmup_cosine_schedule(cfg.optim.lr, 1000, cfg.optim.warmup_iters)
    bset = optim.backbone_optim_settings("swin_t", model.encoder)

    def fresh_state():
        model.load_state_dict(init)
        opt = optim.Optimizer(model, sched, weight_decay=cfg.optim.weight_decay,
                              grad_clip=cfg.optim.grad_clip, layer_decay=cfg.optim.layer_decay,
                              num_layers=bset["num_layers"])
        return trainer.TrainState(0, model, opt)

    step = lambda state: trainer.finetune_step(state, x, y, cfg.seed)
    compare_steps("swin_t finetune step", step_runs(model, fresh_state, step),
                  {"K11": n, "K11s": 2 * n}, zero_grad=backbone_zero_grad(model))
    timing = time_steps(model, fresh_state, step, "swin_t finetune step", FT_BATCH,
                        f"{FT_SIZE}^2")
    del model, init, x, y
    torch.cuda.empty_cache()
    return timing


def backbone_pretrain_phase(tmp: str, name: str):
    """``python -m samrs_tpu_torch.train.pretrain backbone=<name>`` at the
    defaults otherwise (UperNet, 17/12/65 at 224^2, the family's optimizer
    row) on the synthetic SAMRS layout under `tmp`: BACKBONE_ITERS steps, the
    evaluation with a per-dataset mIoU line, ``last`` / ``best`` checkpoints
    with finite weights.  Returns the launches."""
    from samrs_tpu_torch.train import pretrain

    handler = _Lines()
    log = logging.getLogger("samrs_tpu_torch.pretrain")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    n_val = 8
    ckpt = os.path.join(tmp, f"{name}_pretrain")
    reset_counts()
    t = time.perf_counter()
    try:
        pretrain.main([f"backbone={name}", f"data.root={os.path.join(tmp, 'samrs')}",
                       f"total_iters={BACKBONE_ITERS}", f"eval_interval={BACKBONE_ITERS}",
                       f"data.val_images={n_val}", f"ckpt_dir={ckpt}"])
        torch.cuda.synchronize()
    finally:
        log.removeHandler(handler)
    wall = time.perf_counter() - t
    launches = read_counts()
    n = BACKBONE_MLPS[name]
    evals = 3 * -(-n_val // 8)
    want = {k: 0 for k in launches}
    want["K11"] = (3 * BACKBONE_ITERS + evals) * n
    want["K11s"] = checked_splits(f"{name} pretrain", launches, BACKBONE_ITERS * 2 * n)
    print("\n".join([f"{name} pretrain " + ln for ln in handler.lines]), flush=True)
    print(f"{name} pretrain launches: {launches} ({BACKBONE_ITERS} steps + eval in {wall:.1f} s)",
          flush=True)
    if launches != want:
        raise RuntimeError(f"{name} pretrain launches {launches} != {want}")
    vals = [ln for ln in handler.lines if ln.startswith("val[")]
    if sorted(v.split("]")[0][4:] for v in vals) != ["fast", "sior", "sota"]:
        raise RuntimeError(f"{name} per-dataset mIoU lines: {vals}")
    for v in vals:
        if not 0.0 <= float(v.split("mIoU ")[1].split()[0]) <= 1.0:
            raise RuntimeError(f"mIoU out of range: {v}")
    if not any(ln.startswith(f"iter {BACKBONE_ITERS} eval") for ln in handler.lines):
        raise RuntimeError(f"run_pretrain({name}) logged no eval at its last step")
    files = sorted(os.listdir(ckpt))
    if not {"last.pt", "last_encoder.pt", "best.pt", "best_encoder.pt"} <= set(files):
        raise RuntimeError(f"{name} checkpoints written: {files}")
    saved = torch.load(os.path.join(ckpt, "last.pt"), map_location="cpu", weights_only=True)
    if saved["step"] != BACKBONE_ITERS or not all(
            torch.isfinite(v).all() for v in saved["model"].values() if v.is_floating_point()):
        raise RuntimeError(f"{name} last.pt at step {saved['step']} or with non-finite weights")
    return launches


def backbones_phase(gen, profile: bool = False):
    """This slice's path: K11 at Swin-T's and ViTAEv2-S's MLP shapes (C 96 in
    the fused form), one SEP step of each of swin_t, vitaev2_s and resnet50
    with UperNet by the control rule, a swin_t finetune step at 512^2 (the
    padded windows), and the pretrain driver with each backbone on a
    synthetic SAMRS layout of its own.  Returns their results."""
    t0 = time.perf_counter()
    k11 = backbone_k11_phase(gen)
    steps = {name: backbone_step_phase(name, profile) for name in BACKBONE_MLPS}
    finetune = swin_finetune_step_phase()
    with tempfile.TemporaryDirectory() as tmp:
        write_samrs_layout(os.path.join(tmp, "samrs"), {"sota": 20, "sior": 15, "fast": 70}, 8)
        drivers = {name: backbone_pretrain_phase(tmp, name) for name in BACKBONE_MLPS}
    for name, st in steps.items():
        (s_k, peak_k), (s_p, peak_p) = st["timing"][True], st["timing"][False]
        busy = "not measured" if st["busy"] is None else \
            f"{100 * st['busy'][1] / st['busy'][0]:.1f}%"
        print(f"{name} summary: kernels {s_k:.4f} s/step ({sum(TRAIN_BATCH) / s_k:.2f} img/s, "
              f"peak {peak_k / 2**30:.2f} GiB, busy {busy}), plain {s_p:.4f} s/step "
              f"({sum(TRAIN_BATCH) / s_p:.2f} img/s, peak {peak_p / 2**30:.2f} GiB)", flush=True)
    (s_k, peak_k), (s_p, peak_p) = finetune[True], finetune[False]
    print(f"swin_t finetune summary ({FT_BATCH} x {FT_SIZE}^2): kernels {s_k:.4f} s/step, peak "
          f"{peak_k / 2**30:.2f} GiB; plain {s_p:.4f} s/step, peak {peak_p / 2**30:.2f} GiB; "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(k11=k11, steps=steps, finetune=finetune, drivers=drivers)


def write_potsdam_layout(root: str, n_train: int, n_val: int, hw=(600, 600)) -> None:
    """A Potsdam tree under `root`/potsdam (FINETUNE_DATASETS' layout): seeded
    noise images and RGB-coded labels uniform over ISPRS_PALETTE."""
    from PIL import Image

    from samrs_tpu_torch.data.datasets import ISPRS_PALETTE

    rng = np.random.default_rng(SEED + 6)
    base = os.path.join(root, "potsdam")
    os.makedirs(os.path.join(base, "images"))
    os.makedirs(os.path.join(base, "labels"))
    names = [f"top_potsdam_{i:04d}" for i in range(n_train + n_val)]
    for nm in names:
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            os.path.join(base, "images", nm + ".png"))
        Image.fromarray(ISPRS_PALETTE[rng.integers(0, len(ISPRS_PALETTE), hw)]).save(
            os.path.join(base, "labels", nm + ".png"))
    with open(os.path.join(base, "train.txt"), "w") as f:
        f.write("\n".join(names[:n_train]))
    with open(os.path.join(base, "valid.txt"), "w") as f:
        f.write("\n".join(names[n_train:]))


def finetune_driver_phase(tmp: str, pretrained: str):
    """``run_finetune`` at the defaults (vit_b_rvsa + UperNet on Potsdam at
    512^2, batch 8) for one epoch on a synthetic Potsdam layout, starting
    from the pretrain phase's ``best_encoder.pt`` (the SEP -> finetune flow):
    launches (K8, K10, K11), the epoch line with mIoU, the ``last`` / ``best``
    checkpoints.  Returns the launches and the trained model."""
    from samrs_tpu_torch.core.config import FinetuneConfig
    from samrs_tpu_torch.train.finetune import run_finetune

    write_potsdam_layout(tmp, FT_TRAIN, FT_VAL)
    handler = _Lines()
    log = logging.getLogger("samrs_tpu_torch.finetune")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    over = [f"data.root={tmp}", "epochs=1", f"data.val_images={FT_VAL}", f"pretrained={pretrained}",
            f"ckpt_dir={os.path.join(tmp, 'finetune_ckpt')}"]
    cfg = FinetuneConfig().override(over)
    reset_counts()
    t = time.perf_counter()
    state = run_finetune(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_counts()
    log.removeHandler(handler)
    steps, evals = FT_TRAIN // FT_BATCH, -(-FT_VAL // 8)
    want = {k: 0 for k in launches}
    want.update(K8f=(steps + evals) * RVSA_BLOCKS, K8b=steps * RVSA_BLOCKS,
                K10=(steps + evals) * FULL_BLOCKS, K11=(steps + evals) * VIT_DEPTH,
                K11s=checked_splits("finetune", launches, steps * 2 * VIT_DEPTH))
    print("\n".join(["finetune " + ln for ln in handler.lines]), flush=True)
    print(f"finetune launches: {launches} ({steps} steps + {evals} eval batch in {wall:.1f} s)",
          flush=True)
    if launches != want:
        raise RuntimeError(f"finetune launches {launches} != {want}")
    if state.step != steps:
        raise RuntimeError(f"run_finetune stopped at step {state.step}")
    epochs = [ln for ln in handler.lines if ln.startswith("epoch 1/1")]
    if len(epochs) != 1 or not 0.0 <= float(epochs[0].split("mIoU ")[1].split()[0]) <= 1.0:
        raise RuntimeError(f"epoch lines: {epochs}")
    if not any(ln.startswith("loaded pretrained encoder") for ln in handler.lines):
        raise RuntimeError("the SEP encoder was not grafted")
    files = sorted(os.listdir(cfg.ckpt_dir))
    if not {"last.pt", "best.pt"} <= set(files):
        raise RuntimeError(f"finetune checkpoints written: {files}")
    return launches, state.model


def test_phase(tmp: str, model):
    """``run_test`` with flip TTA on two seeded images of TEST_HW at crop 512
    (a 2x2 crop grid with tail crops, one batch of 8 crops an image): launches,
    gray and colour PNGs written and read back against the predictions, and
    kernels-vs-plain probability maps."""
    from PIL import Image

    from samrs_tpu_torch.train.evaluate import (dataset_palette, make_crop_forward,
                                                predict_probs, run_test)

    rng = np.random.default_rng(SEED + 7)
    data = [(rng.integers(0, 256, (*TEST_HW, 3), dtype=np.uint8),
             rng.integers(0, FT_CLASSES, TEST_HW).astype(np.int32)) for _ in range(2)]
    palette = dataset_palette("potsdam")
    out_dir = os.path.join(tmp, "test_out")
    reset_counts()
    t = time.perf_counter()
    scores = run_test(model, data, FT_CLASSES, FT_SIZE, save_dir=out_dir, palette=palette)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_counts()
    fwd = 2 * len(data)  # one batch of crops an image, and its flip
    want = {k: 0 for k in launches}
    want.update(K8f=fwd * RVSA_BLOCKS, K10=fwd * FULL_BLOCKS, K11=fwd * VIT_DEPTH,
                K11s=checked_splits("test", launches, 0))
    print(f"test launches: {launches}; {len(data)} images of {TEST_HW} in {wall:.2f} s; "
          f"mIoU {scores['miou']:.4f}", flush=True)
    if launches != want:
        raise RuntimeError(f"test launches {launches} != {want}")
    probs = {}
    for use_kernels in (True, False):
        model.use_kernels = use_kernels
        fwd_fn = make_crop_forward(model)
        probs[use_kernels] = [predict_probs(fwd_fn, img, FT_CLASSES, FT_SIZE) for img, _ in data]
    model.use_kernels = True
    err = rel_l2([torch.from_numpy(p) for p in probs[True]],
                 [torch.from_numpy(p) for p in probs[False]])
    agree = float(np.mean([(a.argmax(-1) == b.argmax(-1)).mean()
                           for a, b in zip(probs[True], probs[False])]))
    for i, prob in enumerate(probs[True]):
        with Image.open(os.path.join(out_dir, "gray", f"{i:06d}.png")) as im:
            gray = np.asarray(im)
        with Image.open(os.path.join(out_dir, "color", f"{i:06d}.png")) as im:
            color = np.asarray(im)
        if gray.shape != TEST_HW or not np.array_equal(gray, prob.argmax(-1)):
            raise RuntimeError(f"test image {i}: the gray PNG is not the prediction")
        if not np.array_equal(color, palette[gray]):
            raise RuntimeError(f"test image {i}: the colour PNG is not palette[gray]")
        if not (np.isfinite(prob).all() and np.allclose(prob.sum(-1), 1.0, atol=1e-4)):
            raise RuntimeError(f"test image {i}: probabilities are not a distribution")
    print(f"test kernels vs plain: probability rel_l2={err:.3e}, label agreement {agree:.6f}",
          flush=True)
    if not err <= EVAL_RTOL:
        raise RuntimeError(f"test probabilities rel-L2 {err:.3e} > {EVAL_RTOL}")
    return launches


# ---------------------------------------------------------------- pretrained= ----
# a seeded reference-layout .pth of each family at its published widths: the encoder's keys under
# module.backbone., MAE extras, keys of the reference the port keeps no tensor for, one key of the
# wrong shape and, for the ViTs, a pos-embed on the 16x16 grid of a 256^2 model
PRETRAINED_EXTRAS = {
    "vit_b_rvsa": ({"cls_token": (1, 1, 768), "norm.weight": (768,), "norm.bias": (768,),
                    "blocks.0.attn.relative_position_index": (49, 49)},
                   "blocks.5.mlp.fc1.weight"),
    "vit_b": ({"cls_token": (1, 1, 768), "head.weight": (1000, 768)}, "blocks.3.attn.qkv.weight"),
    "swin_t": ({"layers.0.blocks.0.attn.relative_position_index": (49, 49),
                "layers.0.blocks.1.attn_mask": (64, 49, 49), "norm.weight": (768,)},
               "layers.2.blocks.4.mlp.fc2.weight"),
    "resnet50": ({"bn1.num_batches_tracked": (), "layer1.0.bn1.num_batches_tracked": (),
                  "layer2.0.downsample.1.num_batches_tracked": (), "fc.weight": (1000, 2048),
                  "fc.bias": (1000,)}, "layer3.2.conv2.weight"),
    "vitaev2_s": ({"layers.0.RC.PCM.1.num_batches_tracked": (),
                   "layers.2.NC.0.attn.relative_position_bias_table": (169, 8),
                   "norm3.weight": (512,)}, "layers.2.NC.3.mlp.fc1.weight"),
    "internimage_t": ({"conv_head.0.weight": (1536, 512, 1, 1), "head.weight": (1000, 1536)},
                      "levels.2.blocks.7.dcn.offset.weight"),
    "vit_adapter_b": ({"spm.stem.1.num_batches_tracked": (), "norm2.num_batches_tracked": (),
                       "fc_norm.weight": (768,), "head.weight": (1000, 768)},
                      "interactions.2.extractor.ffn.fc1.weight"),
}
PRETRAINED_POS_GRID = 16       # the checkpoints' pos-embed grid (a 256^2 ViT; the models' is 14)
# (family, loaded, skipped) of these checkpoints: the port's rules, which
# tests/test_torch_port_checkpoint.py holds to JAX's load_backbone_checkpoint key by key at small
# widths, run on the CPU over the encoders' shapes (the meta device).  vit_b loads its patch
# embedding and pos-embed alone: JAX's ViT rule names RVSA's nested blocks (ROADMAP Queue 3)
PRETRAINED_COUNTS = {"vit_b_rvsa": ("vit", 161, 72), "vit_b": ("vit", 3, 159),
                     "swin_t": ("swin", 176, 7), "resnet50": ("resnet", 264, 4),
                     "vitaev2_s": ("vitae", 492, 4), "internimage_t": ("internimage", 684, 4),
                     "vit_adapter_b": ("vit_adapter", 403, 3)}


def write_reference_pth(path: str, name: str, encoder, seed: int):
    """`name`'s reference-layout checkpoint for `encoder` (its state-dict keys
    and shapes), drawn on the CPU from `seed`: weights fan-in scaled, norms
    and layer scales near 1, BatchNorm variances positive; the MAE decoder
    and mask token, PRETRAINED_EXTRAS, its wrong-shaped key one row too long,
    and a pos-embed on a PRETRAINED_POS_GRID grid (with a cls slot, but for
    the ViT-Adapter, whose own checkpoints hold none)."""
    extras, wrong = PRETRAINED_EXTRAS[name]
    shapes = {k: tuple(v.shape) for k, v in encoder.state_dict().items()}
    shapes.update(extras)
    shapes.update({"mask_token": (1, 1, 768), "decoder_embed.weight": (512, 768),
                   "decoder_pos_embed": (1, 197, 512)})
    shapes[wrong] = (shapes[wrong][0] + 1,) + shapes[wrong][1:]
    if "pos_embed" in shapes:
        cls = int(name != "vit_adapter_b")
        shapes["pos_embed"] = (1, PRETRAINED_POS_GRID ** 2 + cls, shapes["pos_embed"][2])
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, s in shapes.items():
        if k.endswith("num_batches_tracked"):
            v = torch.tensor(1000)
        else:
            v = torch.randn(s, generator=gen)
            if k.endswith("running_var"):
                v = 1.0 + 0.1 * v.abs()
            elif k.endswith("weight") and len(s) >= 2:
                v = v * float(np.prod(s[1:])) ** -0.5
            elif k.endswith(("weight", "gamma1", "gamma2", "gamma")):
                v = 1.0 + 0.1 * v
            elif "pos_embed" not in k:
                v = 0.1 * v
        sd["module.backbone." + k] = v
    torch.save({"model": sd}, path)
    return sd


def pretrained_phase(tmp: str):
    """``pretrained=``: each family's seeded reference checkpoint loaded into
    its encoder on the card (the loaded / skipped counts against
    PRETRAINED_COUNTS, every loaded tensor equal to the checkpoint's, the
    resized pos-embeds finite); K11's weight halves split again on the first
    forward after a load; one vit_b_rvsa + UperNet step from the loaded
    state by the control rule of phase 7; ``run_pretrain(pretrained=...)``
    for PRETRAINED_ITERS steps with an eval (launches as the pretrain
    phase's).  Returns the run's launches."""
    from samrs_tpu_torch.core.config import PretrainConfig
    from samrs_tpu_torch.seg.frameworks import build_multihead_model
    from samrs_tpu_torch.seg.port import load_backbone_checkpoint
    from samrs_tpu_torch.seg.registry import get_backbone
    from samrs_tpu_torch.train import optim, trainer
    from samrs_tpu_torch.train.pretrain import apply_optim_defaults, run_pretrain

    paths = {}
    for i, name in enumerate(PRETRAINED_EXTRAS):
        with torch.device("cuda"):
            encoder = get_backbone(name, image_size=224).cuda()
        path = paths[name] = os.path.join(tmp, f"{name}_reference.pth")
        t = time.perf_counter()
        sd = write_reference_pth(path, name, encoder, SEED + 10 + i)
        t_write = time.perf_counter() - t
        t = time.perf_counter()
        got = load_backbone_checkpoint(path, encoder)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t
        counts = (got.family, len(got.loaded), len(got.skipped))
        print(f"pretrained {name}: family {got.family}, loaded {counts[1]} tensors, skipped "
              f"{counts[2]} (e.g. {got.skipped[:4]}); written in {t_write:.1f} s, loaded in "
              f"{t_load:.1f} s", flush=True)
        if counts != PRETRAINED_COUNTS[name] or PRETRAINED_EXTRAS[name][1] not in got.skipped:
            raise RuntimeError(f"pretrained {name}: {counts} != {PRETRAINED_COUNTS[name]}, or "
                               f"the wrong-shaped key was not skipped")
        state = encoder.state_dict()
        for k in got.loaded:
            if k in state and k != "pos_embed" and not torch.equal(
                    state[k].cpu(), sd["module.backbone." + k].to(state[k].dtype)):
                raise RuntimeError(f"pretrained {name}: {k} is not the checkpoint's")
        if "pos_embed" in got.loaded and not torch.isfinite(state["pos_embed"]).all():
            raise RuntimeError(f"pretrained {name}: non-finite resized pos_embed")
        del encoder, sd, state
        torch.cuda.empty_cache()

    # K11's tf32 halves are kept per weight version: the first forward after a load splits again
    model = build_multihead_model(device="cuda",
                                  generator=torch.Generator(device="cuda").manual_seed(SEED))
    x = train_batches(SEED + 6)[0][0][:2]
    model.eval()
    with torch.no_grad():
        model.forward_one(x, 0)
        reset_counts()
        model.forward_one(x, 0)
        cached = read_counts()["K11s"]
        got = load_backbone_checkpoint(paths["vit_b_rvsa"], model.encoder)
        model.forward_one(x, 0)
        resplit = read_counts()["K11s"]
    # every MLP weight the checkpoint replaced (all but the wrong-shaped one) splits again
    want = sum(bool(re.fullmatch(r"blocks\.\d+\.mlp\.fc[12]\.weight", k)) for k in got.loaded)
    print(f"pretrained: K11 weight splits in a forward before the load {cached}, after it "
          f"{resplit} ({want} MLP weights loaded)", flush=True)
    if cached != 0 or resplit != want or want != 2 * VIT_DEPTH - 1:
        raise RuntimeError(f"K11 splits {cached} / {resplit}, want 0 / {want}")

    # the first step from the loaded state, kernels against the plain path by the control rule
    cfg = PretrainConfig()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batches = train_batches(SEED + 7)
    sched = optim.warmup_cosine_schedule(cfg.optim.lr, cfg.total_iters, cfg.optim.warmup_iters)

    def fresh_state():
        model.load_state_dict(init)
        opt = optim.Optimizer(model, sched, weight_decay=cfg.optim.weight_decay,
                              grad_clip=cfg.optim.grad_clip, layer_decay=cfg.optim.layer_decay,
                              num_layers=model.encoder.depth)
        return trainer.TrainState(0, model, opt)

    step = lambda state: trainer.pretrain_step(state, batches, cfg.seed)
    compare_steps("pretrained step", step_runs(model, fresh_state, step), STEP_LAUNCHES)
    del model, init, batches
    torch.cuda.empty_cache()

    # run_pretrain with pretrained=
    handler = _Lines()
    log = logging.getLogger("samrs_tpu_torch")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    root, n_val = os.path.join(tmp, "samrs"), 8
    if not os.path.isdir(root):
        write_samrs_layout(root, {"sota": 20, "sior": 15, "fast": 70}, n_val)
    over = [f"data.root={root}", f"total_iters={PRETRAIN_ITERS}",
            f"eval_interval={PRETRAIN_ITERS}", f"data.val_images={n_val}",
            f"pretrained={paths['vit_b_rvsa']}", "init=mae",
            f"ckpt_dir={os.path.join(tmp, 'pretrained_ckpt')}"]
    cfg = apply_optim_defaults(PretrainConfig().override(over), over)
    reset_counts()
    t = time.perf_counter()
    try:
        state = run_pretrain(cfg)
        torch.cuda.synchronize()
    finally:
        log.removeHandler(handler)
    wall = time.perf_counter() - t
    launches = read_counts()
    evals = len(cfg.data.datasets) * -(-n_val // 8)
    want = {k: 0 for k in launches}
    want.update(K8f=PRETRAIN_ITERS * STEP_LAUNCHES["K8f"] + evals * RVSA_BLOCKS,
                K8b=PRETRAIN_ITERS * STEP_LAUNCHES["K8b"],
                K10=PRETRAIN_ITERS * STEP_LAUNCHES["K10"] + evals * FULL_BLOCKS,
                K11=PRETRAIN_ITERS * STEP_LAUNCHES["K11"] + evals * VIT_DEPTH,
                K11s=checked_splits("pretrained run", launches,
                                    PRETRAIN_ITERS * STEP_LAUNCHES["K11s"]))
    print("\n".join("pretrained run " + ln for ln in handler.lines), flush=True)
    print(f"pretrained run launches: {launches} ({PRETRAIN_ITERS} steps + eval in {wall:.1f} s)",
          flush=True)
    if launches != want:
        raise RuntimeError(f"pretrained run launches {launches} != {want}")
    if state.step != PRETRAIN_ITERS or not any(ln.startswith("[vit] loaded")
                                               for ln in handler.lines):
        raise RuntimeError(f"run_pretrain(pretrained=...) at step {state.step}, load logged: "
                           f"{[ln for ln in handler.lines if 'loaded' in ln]}")
    del state
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------- DDP ----
DDP_RANKS = 2
DDP_BATCH = 32                 # data.batch_size of the DDP runs (two ranks share one card)
DDP_STEPS = 2                  # the steps held against one process
DDP_TIMED = 3                  # warm steps timed a rank
DDP_ITERS = 2                  # run_pretrain steps on the two ranks, one eval after them
DDP_TIMEOUT_S = 600


def ddp_sizes():
    """The DDP runs' global batch a head: DDP_BATCH split as run_pretrain splits
    it, rounded to the ranks as JAX rounds it to its devices."""
    from samrs_tpu_torch.train.pretrain import data_parallel_batch, proportional_batch_sizes

    sizes = proportional_batch_sizes(("sota", "sior", "fast"), DDP_BATCH)
    return tuple(data_parallel_batch(b, DDP_RANKS) for b in sizes.values())


def ddp_batches(seed: int, sizes, device):
    """One global batch: seeded normalized 224^2 images and uniform labels a head."""
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.normal(size=(b, 224, 224, 3)).astype(np.float32)).to(device),
             torch.from_numpy(rng.integers(0, nc, (b, 224, 224))).to(device))
            for b, nc in zip(sizes, TRAIN_CLASSES)]


def _rows(batches, rank: int):
    """Rank `rank`'s rows of each global batch: the ranks' batches in rank order."""
    return [(x.chunk(DDP_RANKS)[rank], y.chunk(DDP_RANKS)[rank]) for x, y in batches]


def _host_snapshot(state, losses):
    """Losses, gradients, AdamW moments and BatchNorm statistics, on the host."""
    model, opt = state.model, state.optimizer
    names = {p: n for n, p in model.named_parameters()}
    return dict(loss=torch.tensor(losses, dtype=torch.float64),
                grads={n: p.grad.cpu() for n, p in model.named_parameters()},
                mu={names[p]: s["exp_avg"].cpu() for p, s in opt.opt.state.items()},
                nu={names[p]: s["exp_avg_sq"].cpu() for p, s in opt.opt.state.items()},
                stats={k: v.cpu() for k, v in model.state_dict().items() if "running" in k})


def _rel(got, want, skip=()) -> float:
    keys = [k for k in want if k not in skip]
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in keys)
    den = sum(float((want[k].double() ** 2).sum()) for k in keys)
    return (num / den) ** 0.5


def ddp_worker(out_dir: str) -> None:
    """One rank of the DDP phase (started by ``ddp_phase`` with torchrun's
    variables): the DDP steps against one process (rank 0 runs those), the
    launches, s/step, peak memory and the all-reduce, and ``run_pretrain``
    with an eval, checkpoints and a resume; writes ``rank{r}.json``."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from samrs_tpu_torch.core.config import PretrainConfig
    from samrs_tpu_torch.core.mesh import barrier, init_data_mesh, reduce_grads
    from samrs_tpu_torch.kernels import _build, fused_mlp
    from samrs_tpu_torch.seg.frameworks import build_multihead_model
    from samrs_tpu_torch.train import optim, pretrain, trainer

    mesh = init_data_mesh((-1,), "cuda")
    r, dev = mesh.rank, mesh.device
    say = lambda msg: print(f"[rank {r}] {msg}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    say(f"backend {mesh.backend}, {torch.cuda.device_count()} card(s) visible, on {dev} "
        f"({torch.cuda.get_device_name(dev)})")
    res = {"rank": r, "backend": mesh.backend, "cards": torch.cuda.device_count(),
           "device": str(dev)}
    sizes = ddp_sizes()
    cfg = PretrainConfig()
    model = build_multihead_model(device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    sched = optim.warmup_cosine_schedule(cfg.optim.lr, cfg.total_iters, cfg.optim.warmup_iters)

    def fresh_state(m):
        model.load_state_dict(init)
        opt = optim.Optimizer(model, sched, weight_decay=cfg.optim.weight_decay,
                              grad_clip=cfg.optim.grad_clip, layer_decay=cfg.optim.layer_decay,
                              num_layers=model.encoder.depth)
        return trainer.TrainState(0, model, opt, m)

    batches = [ddp_batches(SEED + 20 + i, sizes, dev) for i in range(DDP_STEPS)]
    # check 1 and 2: DDP_STEPS steps on the rank's rows, dropout and drop-path on; launches
    state = fresh_state(mesh)
    reset_counts()
    losses = [float(trainer.pretrain_step(state, _rows(batches[i], r), cfg.seed)["loss"])
              for i in range(DDP_STEPS)]
    torch.cuda.synchronize()
    res["step_launches"] = read_counts()
    ddp = _host_snapshot(state, losses)
    stats = torch.cat([v.flatten() for v in ddp["stats"].values()]).to(dev)
    sums = torch.stack([p.detach().double().sum() for p in model.parameters()])
    res["stats_equal"] = all(torch.equal(g, stats) for g in _all_gather(dist, stats))
    res["params_equal"] = all(torch.equal(g, sums) for g in _all_gather(dist, sums))
    say(f"{DDP_STEPS} steps on {[b[0].shape[0] // DDP_RANKS for b in batches[0]]} images a head: "
        f"losses {losses}, launches {res['step_launches']}; BatchNorm statistics equal on the "
        f"ranks {res['stats_equal']}, parameters {res['params_equal']}")
    state.optimizer.zero_grad()
    del state
    torch.cuda.empty_cache()
    if r == 0:  # one process on the rank-ordered global batch: kernels, plain, control
        runs, plain_mlp = {}, fused_mlp.fused_mlp_plain
        for mode in ("kernels", "plain", "control"):
            model.use_kernels = mode == "kernels"
            fused_mlp.fused_mlp_plain = split_mlp_plain if mode == "control" else plain_mlp
            try:
                state = fresh_state(None)
                ls = [float(trainer.pretrain_step(state, batches[i], cfg.seed)["loss"])
                      for i in range(DDP_STEPS)]
                runs[mode] = _host_snapshot(state, ls)
            finally:
                fused_mlp.fused_mlp_plain = plain_mlp
                model.use_kernels = True
            state.optimizer.zero_grad()
            del state
            torch.cuda.empty_cache()
        k, p, c = runs["kernels"], runs["plain"], runs["control"]
        dloss = float(((ddp["loss"] - k["loss"]).abs() / k["loss"].abs()).max())
        closs = float(((c["loss"] - p["loss"]).abs() / p["loss"].abs()).max())
        say(f"one process, {sum(sizes)} images: losses kernels {k['loss'].tolist()}, plain "
            f"{p['loss'].tolist()}, control {c['loss'].tolist()}; DDP vs one process |d|/loss "
            f"{dloss:.3e} (control vs plain {closs:.3e}, limit {STEP_LOSS_RTOL})")
        if not dloss <= STEP_LOSS_RTOL:
            raise RuntimeError(f"DDP loss |d|/loss {dloss:.3e} > {STEP_LOSS_RTOL}")
        res["dist"] = {}
        for what in ("grads", "mu", "nu", "stats"):
            skip = ZERO_GRAD if what != "stats" else ()
            d, ctl = _rel(ddp[what], k[what], skip), _rel(c[what], p[what], skip)
            res["dist"][what] = (d, ctl)
            say(f"{what}: DDP vs one process rel_l2 {d:.3e}, control {ctl:.3e} (ratio "
                f"{d / max(ctl, 1e-30):.2f}, limit {CONTROL_FACTOR})")
            if not d <= CONTROL_FACTOR * ctl:
                raise RuntimeError(f"DDP {what} rel-L2 {d:.3e} > {CONTROL_FACTOR} x control "
                                   f"{ctl:.3e}")
        del runs, k, p, c
    del ddp
    barrier(mesh)

    # check 3: warm s/step a rank, peak memory, the gradient all-reduce alone and in a profile
    state = fresh_state(mesh)
    local = _rows(batches[0], r)
    trainer.pretrain_step(state, local, cfg.seed)
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(DDP_TIMED):
        torch.cuda.synchronize()
        barrier(mesh)
        t = time.perf_counter()
        trainer.pretrain_step(state, local, cfg.seed)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    res["s_step"], res["peak_bytes"] = statistics.median(times), torch.cuda.max_memory_allocated(dev)
    params = state.optimizer.params
    reduce_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        barrier(mesh)
        t = time.perf_counter()
        reduce_grads(params, mesh)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t) * 1e3)
    res["grad_all_reduce_ms"] = statistics.median(reduce_ms)
    n_grad = sum(p.grad.numel() for p in params if p.grad is not None)
    torch.cuda.synchronize()
    barrier(mesh)
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.pretrain_step(state, local, cfg.seed)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    events = {e.key: e for e in prof.key_averages()}
    # BatchNorm's moment sums (mesh._AllReduceSum, forward and backward: host time, the wait
    # for the other rank included), the step's c10d all-reduce calls, NCCL's device time
    bn_fwd, bn_bwd = (events[k].cpu_time_total / 1e3 if k in events else 0.0
                      for k in ("_AllReduceSum", "_AllReduceSumBackward"))
    calls = events["c10d::allreduce_"].count if "c10d::allreduce_" in events else 0
    nccl_ms = sum(e.self_device_time_total for k, e in events.items()
                  if k.startswith(("ncclDevKernel", "ncclKernel"))) / 1e3
    res.update(profile_wall_ms=wall_ms, profile_bn_sync_ms=(bn_fwd, bn_bwd),
               profile_allreduce_calls=calls, profile_nccl_device_ms=nccl_ms)
    say(f"{res['s_step']:.4f} s/step ({sum(b.shape[0] for b, _ in local)} images on this rank, "
        f"{DDP_RANKS} ranks), peak memory {res['peak_bytes'] / 2**30:.2f} GiB; gradient "
        f"all-reduce ({n_grad / 1e6:.1f} M fp32) {res['grad_all_reduce_ms']:.1f} ms "
        f"({100 * res['grad_all_reduce_ms'] / 1e3 / res['s_step']:.1f}% of the step); profiled "
        f"step {wall_ms:.1f} ms: {calls} all-reduce calls, BatchNorm sums {bn_fwd:.1f} ms forward "
        f"+ {bn_bwd:.1f} ms backward of host time (waits for the other rank included), NCCL "
        f"kernels {nccl_ms:.1f} ms of device time")
    state.optimizer.zero_grad()
    del state, model, init, batches, local, params
    torch.cuda.empty_cache()

    # check 4: run_pretrain on the ranks, an eval, rank-0 checkpoints, a resume
    lines, saves = [], []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    log = logging.getLogger("samrs_tpu_torch.pretrain")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    real_save = pretrain.save_train_state
    pretrain.save_train_state = lambda *a, **kw: (saves.append(a[4]), real_save(*a, **kw))
    n_val = 8
    over = [f"data.root={os.path.join(os.path.dirname(out_dir), 'samrs')}",
            f"total_iters={DDP_ITERS}", f"eval_interval={DDP_ITERS}", f"data.val_images={n_val}",
            f"data.batch_size={DDP_BATCH}", f"ckpt_dir={os.path.join(out_dir, 'ckpt')}"]
    cfg = pretrain.apply_optim_defaults(PretrainConfig().override(over), over)
    try:
        reset_counts()
        state = pretrain.run_pretrain(cfg)
        torch.cuda.synchronize()
        res["run_launches"] = read_counts()
        res["run_step"], res["run_saves"] = state.step, list(saves)
        trained = {k: v.clone() for k, v in state.model.state_dict().items()}
        del state
        torch.cuda.empty_cache()
        over2 = over + ["resume=last"]
        resumed = pretrain.run_pretrain(pretrain.apply_optim_defaults(
            PretrainConfig().override(over2), over2))
        res["resume_step"] = resumed.step
        res["resume_same"] = all(torch.equal(resumed.model.state_dict()[k], v)
                                 for k, v in trained.items())
    finally:
        pretrain.save_train_state = real_save
        log.removeHandler(handler)
    res["eval_lines"] = [ln for ln in lines if ln.startswith(("val[", f"iter {DDP_ITERS} eval"))]
    res["batch_line"] = next(ln for ln in lines if ln.startswith("per-dataset batch sizes"))
    say(f"run_pretrain: {res['batch_line']}; launches {res['run_launches']}; "
        f"{res['eval_lines']}; saved {res['run_saves']}; resumed at step {res['resume_step']}, "
        f"weights restored {res['resume_same']}")
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(res, f)
    barrier(mesh)
    dist.destroy_process_group()


def _all_gather(dist, t):
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return out


def ddp_phase(tmp: str):
    """Two ranks of ``python3 chip_smoke.py --ddp-worker`` with torchrun's
    variables: on two cards over NCCL, or both on one card over gloo (the
    backend rule of core/mesh.py).  vit_b_rvsa + UperNet at full width and
    depth, the global batch cut to DDP_BATCH (ddp_sizes a head, half a
    rank).  Check 1: DDP_STEPS steps against one process on the rank-ordered
    global batch (rank 0 runs it: kernels, plain, control), losses within
    STEP_LOSS_RTOL, gradients, AdamW moments and BatchNorm statistics within
    CONTROL_FACTOR x the control's distance, the statistics and parameters
    equal on the ranks; check 2: K8 / K10 / K11 launches inside each rank;
    check 3: s/step, peak memory, the gradient all-reduce's ms and a
    profile's all-reduce share; check 4: run_pretrain for DDP_ITERS steps
    with an eval (the same lines on both ranks), checkpoints from rank 0
    only, a resume on both.  A rank that fails fails the phase, and the
    other is stopped.  Returns the ranks' results."""
    import socket

    from samrs_tpu_torch.core.mesh import backend_rule

    root = os.path.join(tmp, "samrs")
    if not os.path.isdir(root):
        write_samrs_layout(root, {"sota": 20, "sior": 15, "fast": 70}, 8)
    out = os.path.join(tmp, "ddp")
    os.makedirs(out)
    cards = torch.cuda.device_count()
    print(f"ddp: {DDP_RANKS} ranks on {min(cards, DDP_RANKS)} of {cards} card(s), backend "
          f"{backend_rule('cuda', DDP_RANKS, cards)}; global batch {DDP_BATCH} -> {ddp_sizes()} a "
          f"head", flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    t = time.perf_counter()
    for r in range(DDP_RANKS):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(DDP_RANKS),
                   LOCAL_WORLD_SIZE=str(DDP_RANKS), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        logs.append(open(os.path.join(out, f"rank{r}.log"), "w+"))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ddp-worker",
                                       out], env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.perf_counter() - t > DDP_TIMEOUT_S:
                break
            time.sleep(1.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - t
    for r, f in enumerate(logs):
        f.seek(0)
        print("".join(f"ddp {ln}" for ln in f.readlines()[-60:]), end="", flush=True)
        f.close()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"ddp: rank exit codes {[p.returncode for p in procs]} after "
                           f"{wall:.1f} s")
    ranks = []
    for r in range(DDP_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    per_step = {k: DDP_STEPS * v for k, v in STEP_LAUNCHES.items()}
    evals = 3 * -(-(8 // DDP_RANKS) // 8)  # each rank's share of the 8 val images a head
    per_run = {k: DDP_ITERS * v for k, v in STEP_LAUNCHES.items()}
    per_run.update(K8f=per_run["K8f"] + evals * RVSA_BLOCKS,
                   K10=per_run["K10"] + evals * FULL_BLOCKS, K11=per_run["K11"] + evals * VIT_DEPTH)
    for res in ranks:
        for got, want, what in ((res["step_launches"], per_step, "steps"),
                                (res["run_launches"], per_run, "run_pretrain")):
            want = {k: want.get(k, 0) for k in got}
            want["K11s"] = checked_splits(f"ddp {what} rank {res['rank']}", got, want["K11s"])
            if got != want:
                raise RuntimeError(f"ddp rank {res['rank']} {what} launches {got} != {want}")
        if not (res["stats_equal"] and res["params_equal"]):
            raise RuntimeError(f"ddp rank {res['rank']}: statistics or parameters differ")
        if res["run_step"] != DDP_ITERS or res["resume_step"] != DDP_ITERS or \
                not res["resume_same"]:
            raise RuntimeError(f"ddp rank {res['rank']}: run at step {res['run_step']}, resumed "
                               f"at {res['resume_step']}, weights restored {res['resume_same']}")
    if ranks[0]["eval_lines"] != ranks[1]["eval_lines"] or len(ranks[0]["eval_lines"]) != 4:
        raise RuntimeError(f"ddp eval lines differ: {[r['eval_lines'] for r in ranks]}")
    if ranks[0]["run_saves"] != ["last", "best"] or any(r["run_saves"] for r in ranks[1:]):
        raise RuntimeError(f"ddp checkpoints saved by rank: {[r['run_saves'] for r in ranks]}")
    files = sorted(os.listdir(os.path.join(out, "ckpt")))
    if not {"last.pt", "last_encoder.pt", "best.pt", "best_encoder.pt"} <= set(files):
        raise RuntimeError(f"ddp checkpoints written: {files}")
    print(f"ddp: {DDP_RANKS} ranks, backend {ranks[0]['backend']}, {ranks[0]['cards']} card(s) "
          f"({', '.join(r['device'] for r in ranks)}); s/step a rank "
          f"{[round(r['s_step'], 4) for r in ranks]}, peak GiB "
          f"{[round(r['peak_bytes'] / 2**30, 2) for r in ranks]}, gradient all-reduce ms "
          f"{[round(r['grad_all_reduce_ms'], 1) for r in ranks]}; the same eval lines on both "
          f"ranks, checkpoints from rank 0 only; phase wall {wall:.1f} s", flush=True)
    return ranks


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one generate image per path, one pretrain and one finetune step")
    ap.add_argument("--only", choices=("kernels", "gemm", "main", "fleet", "amg", "modes",
                                       "configs", "sizes", "slab", "internimage", "mlp", "gather",
                                       "steps", "point_sample", "mask2former", "adapter",
                                       "backbones", "pretrained", "ddp"),
                    action="append",
                    help="run only these phases (a partial check: no kernels line): K1-K7 at "
                         "the main path's shapes (kernels), the encoder's GEMM (gemm), the main "
                         "path and the generate phase (main), run_fleet on a DIOR mini-set "
                         "and K1-K3 and the GEMM at batch 4 (fleet), the automatic mask "
                         "generator and the HRSC prompt evaluation (amg), the SAM "
                         "encoder's kernel configurations (modes, configs, sizes), K8-slab and "
                         "K11 at InternImage's widths (slab), the InternImage step and driver "
                         "(internimage), K10 and K11 at every width (mlp), K8 and the MSDA "
                         "wrapper (gather), the UperNet, InternImage, Mask2Former and finetune "
                         "steps (steps), K9 and one mask2former.point_sample call "
                         "(point_sample), the Mask2Former step alone (mask2former), K8 at the "
                         "ViT-Adapter's shapes, its step and its drivers (adapter), K11 at the "
                         "Swin-T / ViTAEv2-S shapes, the swin_t / vitaev2_s / resnet50 steps, "
                         "the swin_t finetune step at 512^2 and their training runs (backbones), "
                         "the seven families' torch checkpoints and run_pretrain(pretrained=) "
                         "(pretrained), two ranks of data-parallel training (ddp)")
    ap.add_argument("--ddp-worker", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_start = time.perf_counter()
    # the 94-image pretrain step peaks near 80 GB; growable segments keep the
    # caching allocator from failing on fragmentation (the values are the same)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; this script runs on a GPU only")
    if args.ddp_worker:  # one rank of ddp_phase
        ddp_worker(args.ddp_worker)
        return
    from samrs_tpu_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel library ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0.0:.1f} s)",
          flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if args.only:
        if "kernels" in args.only:
            kernel_phase(gen)
        if "gemm" in args.only:
            gemm_phase(gen)
        if "main" in args.only:
            model = build_model(gen)
            main_path(model)
            generate_phase(model, args.profile)
            del model
            torch.cuda.empty_cache()
        if "fleet" in args.only:
            model = build_model(gen)
            fleet_phase(model)
            del model
            torch.cuda.empty_cache()
        if "amg" in args.only:
            model = build_model(gen)
            amg_phase(model)
            prompt_eval_phase(model)
            del model
            torch.cuda.empty_cache()
        if "modes" in args.only:
            modes_kernel_phase(gen)
        if "configs" in args.only:
            model = build_model(gen)
            configs_phase(model, gen, device_time=True)
            del model
            torch.cuda.empty_cache()
        if "sizes" in args.only:
            sizes_phase(gen, args.profile)
        if "slab" in args.only:
            k8_slab_phase(gen)
            k11_widths_phase(gen)
        if "mlp" in args.only:
            k10_k11_phase(gen)
            k11_widths_phase(gen)
        if "gather" in args.only:
            k8_phase(gen)
            msda_phase(gen)
        if "point_sample" in args.only:
            k9_phase(gen)
        if "mask2former" in args.only:
            mask2former_step_phase(args.profile)
        if "adapter" in args.only:
            adapter_phase(gen, args.profile)
        if "backbones" in args.only:
            backbones_phase(gen, args.profile)
        if "steps" in args.only:
            train_step_phase(args.profile)
            internimage_step_phase(args.profile)
            mask2former_step_phase(args.profile)
            finetune_step_phase(args.profile)
        if "pretrained" in args.only:
            with tempfile.TemporaryDirectory() as tmp:
                pretrained_phase(tmp)
        if "ddp" in args.only:
            with tempfile.TemporaryDirectory() as tmp:
                ddp_phase(tmp)
        if "internimage" in args.only:
            internimage_step_phase(args.profile)
            with tempfile.TemporaryDirectory() as tmp:
                write_samrs_layout(os.path.join(tmp, "samrs"), {"sota": 20, "sior": 15,
                                                                "fast": 70}, 8)
                internimage_pretrain_phase(tmp)
                internimage_pretrain_phase(tmp, slab=True)
        print(f"partial run {args.only} passed", flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return
    results = kernel_phase(gen)
    results.update(gemm_phase(gen))
    results.update(modes_kernel_phase(gen))
    model = build_model(gen)
    reset_counts()  # the counts of the main path's run alone
    main_launches = main_path(model)
    gen_launches = generate_phase(model, args.profile)
    fleet = fleet_phase(model)
    amg = amg_phase(model)
    prompts = prompt_eval_phase(model)
    for key in ("K1", "K2", "K3", "K4", "K5", "K6", "K7"):
        results[key]["launches"] = gen_launches[key]
        results[key]["launches_main_path"] = main_launches[key]
        results[key]["launches_fleet"] = fleet["launches"][key]
        results[key]["launches_amg"] = amg["launches"][key]
        results[key]["launches_amg_crop_layers_1"] = amg["crop_launches"][key]
        results[key]["launches_prompt_eval"] = {m: o["launches"][key] for m, o in prompts.items()}
    results["GEMM"]["launches"] = main_launches["GEMM"]
    results["GEMM"]["launches_fleet"] = fleet["launches"]["GEMM"]
    results["GEMM"]["launches_amg"] = amg["launches"]["GEMM"]
    b = f"batch{FLEET_BATCH}"  # the fleet's encoder passes: K1-K3 and the GEMM at batch 4
    for key in ("K1", "K2", "K3"):
        results[key].update({f"{b}_{k}": v for k, v in fleet["batch"][key].items()
                             if k not in ("name", "route", "source", "replaces")})
        results[key]["max_abs_err"] = max(results[key]["max_abs_err"],
                                          fleet["batch"][key]["max_abs_err"])
    for shape, row in fleet["gemm"].items():
        results["GEMM"].update({f"{b}_{shape}_{k}": v for k, v in row.items()})
        results["GEMM"]["max_abs_err"] = max(results["GEMM"]["max_abs_err"], row["max_abs_err"])
    configs = configs_phase(model, gen)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    sizes = sizes_phase(gen, args.profile)
    # the modes: launches per image of the configuration (or image size) that runs them
    for key, counts, counter in (
            ("K12", sizes[512], "K12"), ("K12g", configs["window_attn_impl=xla"]["launches"], "K12"),
            ("K2split", configs["global_attn_impl=split"]["launches"], "K2"),
            ("K2exp2", configs["global_attn_impl=exp2"]["launches"], "K2"),
            ("K2aug", configs["global_attn_impl=aug"]["launches"], "K2"),
            ("K2w48", sizes[768], "K2"),
            ("K3t", configs["tail_impl=fused"]["launches"], "K3t"),
            ("K1blk", configs["window_attn_impl=block"]["launches"], "K1"),
            ("K1row", configs["window_attn_impl=block_row"]["launches"], "K1"),
            ("K1q", configs["window_attn_impl=blockq"]["launches"], "K1"),
            ("K1pad", configs["tail_impl=fused"]["launches"], "K1"),
            ("K1r", configs["window_attn_impl=block2"]["launches"], "K1"),
            ("K1pf", configs["window_attn_impl=fused2"]["launches"], "K1pf"),
            ("K1w", configs["window_attn_impl=fused"]["launches"], "K1w")):
        results[key]["launches"] = counts.get(counter, 0)
    results["K12"]["launches_image_size_256"] = sizes[256]["K12"]
    results["K12"]["launches_config_pallas"] = configs["window_attn_impl=pallas"]["launches"]["K12"]
    for key, prefix in (("K12s1024", "grid32"), ("K12s256", "grid16"), ("K12d64", "windows_d64"),
                        ("K12s1024d64", "grid32_d64"), ("K12s256d64", "grid16_d64"),
                        ("K12rpw", "relpos_windows"), ("K12rp32", "relpos_grid32")):
        other = results.pop(key)
        results["K12"].update({f"{prefix}_{k}": other[k] for k in
                               ("ms", "loop_ms", "plain_ms", "library_ms", "max_abs_err")})
        results["K12"]["max_abs_err"] = max(results["K12"]["max_abs_err"], other["max_abs_err"])
    other = results.pop("K12gd64")
    results["K12g"].update({f"d64_{k}": other[k] for k in
                            ("ms", "loop_ms", "plain_ms", "library_ms", "max_abs_err")})
    results["K12g"]["max_abs_err"] = max(results["K12g"]["max_abs_err"], other["max_abs_err"])
    results["K1"]["launches_config_block_sg"] = configs["window_attn_impl=block_sg"]["launches"]["K1"]
    results["K1blk"]["launches_config_block_slab"] = \
        configs["window_attn_impl=block_slab"]["launches"]["K1"]
    results.update(k8_phase(gen))
    results.update(k9_phase(gen))
    msda = msda_phase(gen)
    results["K8f"].update({f"msda_wrapper_{k}": v for k, v in msda.items()})
    results.update(k10_k11_phase(gen))
    results.update(k8_slab_phase(gen))
    results.update(k11_widths_phase(gen))
    adapter = adapter_phase(gen, args.profile)
    backbones = backbones_phase(gen, args.profile)
    train_step_phase(args.profile)
    ii_step = internimage_step_phase(args.profile)
    m2f = mask2former_step_phase(args.profile)
    finetune_step_phase(args.profile)
    with tempfile.TemporaryDirectory() as tmp:
        pre_launches, encoder_ckpt = pretrain_phase(tmp)
        ii_launches = internimage_pretrain_phase(tmp)
        ii_slab_launches = internimage_pretrain_phase(tmp, slab=True)
        m2f_launches = mask2former_driver_phase(tmp)
        ft_launches, model = finetune_driver_phase(tmp, encoder_ckpt)
        test_launches = test_phase(tmp, model)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        pretrained_launches = pretrained_phase(tmp)
        ddp = ddp_phase(tmp)
    for key in ("K8f", "K8b"):  # K8's paths: pretraining (UperNet, Mask2Former), finetuning
        results[key]["launches"] = pre_launches[key]
        results[key]["launches_per_step"] = STEP_LAUNCHES[key]
        results[key]["launches_mask2former"] = m2f_launches[key]
        results[key]["launches_per_mask2former_step"] = M2F_STEP_LAUNCHES[key]
        results[key]["launches_finetune"] = ft_launches[key]
        results[key]["launches_test"] = test_launches[key]
    for key in ("K9f", "K9b"):  # this slice's path: Mask2Former pretraining
        results[key]["launches"] = m2f_launches[key]
        results[key]["launches_per_step"] = M2F_STEP_LAUNCHES[key]
    for key in ("K10", "K11", "K11s"):  # finetuning, the sliding-window test, both pretrainings
        results[key]["launches"] = ft_launches[key]
        results[key]["launches_test"] = test_launches[key]
        results[key]["launches_per_finetune_step_vit_b"] = VIT_DEPTH * (2 if key == "K11s" else 1)
        results[key]["launches_pretrain"] = pre_launches[key]
        results[key]["launches_per_pretrain_step"] = STEP_LAUNCHES[key]
        results[key]["launches_mask2former"] = m2f_launches[key]
    for key in ("K8f", "K8b", "K10", "K11", "K11s"):  # this slice's path: pretrained=, DDP
        results[key]["launches_pretrained"] = pretrained_launches[key]
        for res in ddp:
            results[key][f"launches_ddp_rank{res['rank']}"] = res["run_launches"][key]
            results[key][f"launches_ddp_rank{res['rank']}_per_{DDP_STEPS}_steps"] = \
                res["step_launches"][key]
    for key in ("K8f", "K8b"):  # InternImage's DCNv3 through dense K8
        results[key]["launches_internimage"] = ii_launches[key]
        results[key]["launches_per_internimage_step"] = II_STEP_LAUNCHES[key]
    for key in ("K8sf", "K8sb"):  # this slice's path: InternImage pretraining, slab selected
        results[key]["launches"] = ii_slab_launches[key]
        results[key]["launches_per_step"] = II_SLAB_STEP_LAUNCHES[key]
    results["K11w"]["launches"] = ii_launches["K11"]
    results["K11w"]["launches_per_step"] = II_STEP_LAUNCHES["K11"]
    results["K11w"]["launches_slab_run"] = ii_slab_launches["K11"]
    results["K11s"]["launches_internimage"] = ii_launches["K11s"]
    for key, d in (("K8f", "fwd"), ("K8b", "bwd")):  # this slice's path: ViT-Adapter-B
        results[key]["launches_adapter"] = adapter["pretrain"][key]
        results[key]["launches_per_adapter_step"] = adapter["step"]["counts"][key]
        results[key]["launches_adapter_finetune"] = adapter["finetune"][key]
        results[key]["launches_adapter_test"] = adapter["test"][key]
        for case, o in adapter["k8"].items():
            # ms a call over 20 back-to-back calls; *_call_ms one call between events
            results[key].update({f"{case}_ms": o[f"{d}_loop_ms"],
                                 f"{case}_plain_ms": o[f"plain_{d}_loop_ms"],
                                 f"{case}_call_ms": o[f"{d}_ms"],
                                 f"{case}_plain_call_ms": o[f"plain_{d}_ms"],
                                 f"{case}_bound_ms": o[f"{d}_bound"][0],
                                 f"{case}_bound_by": o[f"{d}_bound"][1],
                                 f"{case}_max_abs_err": o["fwd_max_abs_err" if d == "fwd"
                                                          else "max_abs_err"],
                                 f"{case}_library_ms": None})
    for key in ("K10", "K11", "K11s"):
        results[key]["launches_adapter"] = adapter["pretrain"][key]
        results[key]["launches_per_adapter_step"] = adapter["step"]["counts"][key]
    for name in BACKBONE_MLPS:  # this slice's path: Swin-T, ViTAEv2-S, ResNet-50 (K11 only)
        for key in ("K11", "K11s"):
            results[key][f"launches_{name}"] = backbones["drivers"][name][key]
            results[key][f"launches_per_{name}_step"] = backbones["steps"][name]["counts"][key]
    for case, o in backbones["k11"].items():
        results["K11"].update({f"{case}_{k}": o[k] for k in (
            "ms", "loop_ms", "cold_ms", "plain_ms", "composition_ms", "bound_ms", "bound_by",
            "max_abs_err", "tflops")})
        results["K11"]["max_abs_err"] = max(results["K11"]["max_abs_err"], o["max_abs_err"])
    print("internimage summary: " + ", ".join(
        f"{k} {v[0]:.4f} s/step ({sum(TRAIN_BATCH) / v[0]:.2f} img/s, peak {v[1] / 2**30:.2f} GiB)"
        for k, v in ii_step.items()), flush=True)
    kernels_s, plain_s = (m2f["timing"][k][0] for k in (True, False))
    print(f"mask2former summary: kernels {kernels_s:.4f} s/step, plain {plain_s:.4f} s/step, "
          f"peak {m2f['timing'][True][1] / 2**30:.2f} / {m2f['timing'][False][1] / 2**30:.2f} "
          f"GiB, Hungarian {m2f['hungarian_ms']:.2f} ms a step, attention-mask bits differing "
          f"{m2f['flips'][0]} of {m2f['flips'][1]}, assignments {m2f['assign'][0]} of "
          f"{m2f['assign'][1]}", flush=True)
    print(f"amg summary: {json.dumps(amg)}; prompt evaluation: {json.dumps(prompts)}", flush=True)
    print("encoder configurations: " + json.dumps(configs), flush=True)
    print(f"smoke wall time {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
