#!/usr/bin/env python
"""Smoke test of the PyTorch port on one NVIDIA GPU: kernels, then the fit.

Run from the repository root with no arguments:

    python3 chip_smoke.py

1. Device: needs CUDA (exits nonzero without it) and prints the card's
   name and power limit as nvidia-smi reports them.
2. Build: compiles nemo_tpu_torch/csrc/*.cu for sm_90a (ops/_build.py, one
   nvcc per source, in parallel).
3. Kernels against their plain PyTorch versions on the card, at the shapes
   of the fit's paths: K1 forward and backward (random rotations at
   B=512, 960 and 60 on SMPL's tree, and at 512 and 60 on a 23-deep chain,
   a star and a random 64-joint tree, each rerun bit-identical, with the
   kernels' registers, shared memory and spills and, at 512 and 960, each
   direction's device time a launch from torch.profiler beside the one-call
   time and an empty kernel's launch floor); K2 in fused, forward-only and
   pair modes (B=512, the 6890-vertex synthetic SMPL's tables), the fused
   and forward-only modes (the one-pass kernel) also at B=960 and at the
   benchmark cell's B=28200, with the kernel's registers, shared memory and
   spills; K3f and the pair mode
   (the one-pass forward kernel, with its registers, shared memory and
   spills) at (512, 6890), (960, 1024), (37, 300) and (1, 5), each run
   twice for bit-stability;
   K3b (the one-pass backward) recomputing the posed vertices and
   reading stored ones, under a random cotangent and a sign, at (512,
   6890) (the stored vertices and the sign from K2's pair mode), at path
   A's (960, 1024), at (1, 5) and at (37, 300), each run twice for
   bit-stability, with the kernel's registers, shared memory and spills;
   K5s and K5g (the tile rasterizer's stream and gather
   modes) on the synthetic problem's posed mesh at 1000 x 1900, one panel
   and a batch of four; K4 (the one-way nearest-neighbour chamfer) at
   (60, 512, 6890) and (60, 6890, 512), and at path K's (60, 4096, 6890)
   2 m from the origin, each rerun bit-identical, with its
   split, registers, shared memory and spills and each direction's device
   time a launch beside the launch floor and its instruction figure; K6f
   and K6b (the fused MotionNet MLP, forward and backward) at (B, D, H,
   O) = (512, 105, 1000, 147), (960, ...) and (1, ...), each run twice
   for bit-stability, with the GEMM kernel's registers, shared memory and
   spills, its distance from its CPU emulation at B=512 and the same
   products as a chain of cuBLAS calls timed beside it; K7 (GroupNorm +
   ReLU, HuMoR's layer) forward and backward, dx alone and with dgamma
   and dbeta, at (960, 1024) in 16 groups against the eager composition,
   rerun bit-identical, with its resources and times beside the eager
   forward and forward-backward. Then the skinning
   kernels' bf16 instantiations (bf16 tables, --skin_bf16: K2 fused,
   forward-only and pair at (512, 6890), K3b both modes at (512, 6890)
   and (960, 1024), K3f at (960, 1024) and (512, 6890)) against their
   plain bf16 versions, each rerun bit-identical, with their registers,
   shared memory and spills, each one's device time a launch beside the
   f32 kernel's on the same inputs, and the bf16-vs-f32 gap of the
   vertices and the gradients; their bound counts the posedirs
   contractions as one bf16 pass at 989 TFLOP/s and the tables' bytes at
   2 a value, and their one PyTorch call is a bf16 matmul. Then K6f and
   K6b at the JAX package's other network precisions, "high" (bf16x3: three
   bf16 mma.sync products a 16-deep step) and "bf16" (one), at B = 512, 960
   and 1 against their plain versions at the same precision, each rerun
   bit-identical, with every instantiation's resources, their bf16
   tensor-core bound (three or one products at 989 TFLOP/s) and one bf16
   product with an f32 result as the one PyTorch call; and K3f writing bf16
   vertices and K3b reading a bf16 cotangent (--skin_io_bf16) with f32 and
   bf16 tables at (960, 1024) and (512, 6890): bit for bit the f32-mesh
   kernels' rounded vertices and their gradients on the widened cotangent,
   within one bf16 step of the plain vertices, each rerun bit-identical,
   with device time a launch beside the f32-mesh kernels'. Each check
   prints its max error beside its tolerance; each kernel's median CUDA-event time beside its plain
   version's, one PyTorch call's (where one computes the whole function or
   its largest contraction) and its bound (the least time the card could
   take: the larger of bytes over 3.35 TB/s and f32 FLOPs over 67 TFLOP/s;
   for the one-pass kernels (K2's fused, forward-only and pair modes, K3f,
   K3b) the operations bound counts their posedirs contractions as three
   TF32 products at 495 TFLOP/s on the tensor cores and the rest as f32, for
   K6 every product so, and the f32 bound is printed beside it).
4. The fit, one path after another, each with the launch counters zeroed
   just before and read just after, and each asserting that its own
   kernels ran (each path's seconds printed at the end):
   - slice 1: the reference configuration (bench.py's NemoConfig: NemoV2,
     batch 512, h_dim 1000, RBF 100 quadratic, 200-node phase nets, 8 views
     x 120 frames, VPoser v2v 10 + KL 1 + GMM 1), warmup, camera and main
     stages, eval_loss and the eval CSVs, the K2 fused mode;
   - path H: slice 1 with bf16 skinning tables (the JAX bench's
     precision; K2 bf16, no f32 skinning kernel): card vs CPU at the first
     main step, no sync, steps/s beside slice 1's; the custom-video
     configuration's 1024-vertex subset in bf16 (K3f/K3b bf16); fused,
     pair and pair_vp in bf16 from the same parameters;
   - path I: slice 1 at the JAX bench's precision (bf16 tables and
     net_precision "high", bench.py:82-86): the plain MotionNet and K6 at
     "high" (10/10/30 steps, card vs CPU, no sync, steps/s, fused vs
     plain), five steps at "bf16" on each MLP mode, the custom-video
     subset with bf16 meshes on either table type (K3's _io_bf16 kernels),
     and the paired trajectory: slice 1, path H and path I drew the same
     batches, and the median per-step relative |delta total_loss| of path
     H and of path I against slice 1 stays under PAIRED_MEDIAN_BOUND (5%);
   - path A: the custom-video configuration (run_examples/
     custom-video-example.sh: NemoV3, full_batch so B=960, weight_3d_loss
     1000, lr_phase 0, lr_factor 1) with the opt-in v2v prior on 1024
     vertices (the recipe itself keeps the full mesh) through K3f/K3b;
   - path B: slice 1's workload with the K2 pair mode, then pair_vp;
   - path C: a few steps of each stage for model versions 0, 1 and 4;
   - path D: the fit's render outputs on K5s (a mesh video of 4 views x
     30 frames, the 8 x 8 rollout figure, the comparison strip), a
     checkpoint saved and loaded into a fresh fitter, and K5g equal to K5s
     on the video's panels;
   - path E: HuMoR 3D fitting through humor_tool, process-amass on a
     synthetic raw AMASS walk, then fit-amass --obs joints verts points at
     the CLI's defaults (60 frames, 512 scan points, the reference HuMoR
     widths) but stage 3's steps, cut to E_STEPS' 10 (30/70/10), through
     K4 and K1, and the eval CSVs; the SMPL model and the HuMoR weights
     come from files written as in path G;
   - path F: slice 1's reference configuration with the MotionNet through
     K6 (motion_mlp="fused"), two K6f launches a predict (the batch and the
     B = 1 phase-0 anchor), and fit_loss with its gradients against the
     plain MotionNet on the card from the same parameters and batch (as on
     path I, less the samples whose ReLU gates the two modes take
     differently, each at a pre-activation within its rounding bound and
     at most 1% of the batch: gate_flips);
   - path G: the recipes from asset files in the real layouts, written
     into a temporary directory from the smoke's body and priors (the SMPL
     chumpy pickle and npz, J_regressor_extra.npy, a V02_05 VPoser
     snapshot, gmm_08.pkl, a HuMoR checkpoint): every loader's tensors
     bit-identical on the card, the init fit_loss from files equal to the
     in-memory one, run_examples/nemomocap-example.sh's fit through the
     CLI on a bundle with vs, pare and GLAMR baselines (5/5/10 steps,
     every 4th video frame; the eval CSVs' baseline and GLAMR columns
     finite), then the custom-video configuration without and with the
     HuMoR dynamics term (card vs CPU on the full grid, no sync, steps/s);
   - path J: the recipe from raw files, in path G's directory: the
     reference's per-view layout written from the 8-view x 120-frame
     bundle (OpenPose JSONs with empty and two-person frames, GT 2D, VIBE
     pickles with two tracklets, a MoSh mocap pickle, a joblib camera a
     view fitted by fit_gt_camera on the card), then python -m
     nemo_tpu_torch.cli.preprocess with the native OpenPose parser and with
     the json module (the packed labels, hmr_theta/mask and gt3d arrays
     bit-identical to the in-memory bundle's, the hand slots zero), the
     doctor on the layout and path G's asset files (READY), the fit CLI on
     the packed bundle at slice 1's configuration (5/5/10 steps; its init
     loss equal to the in-memory bundle's), the export CLI on the card
     against the CPU and against its own smpl_forward rebuild, and one
     view's camera fit card vs CPU with no sync in its loop; each stage's
     host seconds;
   - path K: HuMoR fitting from video through humor_tool, in path G's
     directory with its SMPL .npz and HuMoR checkpoint (6890 vertices,
     latent 48, 60-frame windows, 4096 scan points; 10/10/5 steps): an
     OpenPose directory of 110 frames with its 1080p frames, fit-rgb (two
     windows stitched, with the prior-frame file), viz-fit --final_only
     --prior_frame --obs_2d --every 10 (K5s), a quantitative PROX
     recording (Kinect depth, masks, calibration, MoSh fits) and fit-prox
     --quant --rgbd (K4 at (60, 4096, 6890) in every step of every stage),
     fit-eval equal to fit-prox's eval; the RGB stage-1, first stage-3 and
     fit_proxd stage-2 losses card vs CPU, a step of each stage with no
     sync, each stage's host seconds;
   - path L: the VIBE demo (the custom-video recipe's step 3) through
     python -m nemo_tpu_torch.cli.vibe_demo's main, in path G's directory
     with its SMPL .npz and GMM, at full width (224 crops, ResNet-50, the
     2048 GRU, 3 regressor iterations, 6890 vertices, batch_time 64): a
     100-frame 1280 x 720 video of two crossing people (one unseen for 5
     frames) with STAF-id OpenPose JSONs, detections and a seeded
     SPIN-layout checkpoint with a GRU; bbox tracking, then pose tracking
     with --run_smplify (1 x 20) and --render_out (K1f, K1b, K5s);
     vibe_forward and two L-BFGS iterations of each SMPLify stage card vs
     CPU; both pickles read back through data/vibe.py; ResNet-50 and GRU
     + regressor + SMPL ms a 64-crop chunk, SMPLify s a track with its
     linesearch host reads, render s a frame;
   - path M: VIBE training through python -m
     nemo_tpu_torch.cli.vibe_train's main on configs/vibe/config.yaml at
     full width (batch 32 = 19 2D + 13 3D windows of 16 frames, features
     2048, the 2048 GRU and the regressor, the 2-layer 1024 GRU
     discriminator with 3-layer attention, the 6890-vertex body with
     per-frame betas), reading 2D, 3D, eval and motion shards written
     from seeded numpy, 2 epochs x 10 steps: finite losses, K1b once a
     step and K1f once a step and a validation batch; one step from its
     checkpoint card vs CPU (exactly one K1f and one K1b on the card),
     steps/s over back-to-back steps and the step's device time from
     torch.profiler; vibe_eval on the checkpoint with a packed npz that
     has theta, card vs CPU; build_vibe_db on small 3DPW and AMASS trees,
     the db read back;
   - path N: VPoser training, the IK engine and the L-BFGS HuMoR stages
     at full width: ik_fit on 512 targets through the 512 x 32 VPoser and
     the 6890-vertex body by Adam (100 steps) and L-BFGS (34; its loss
     evaluations and host reads), K1f and K1b once an evaluation, Adam's
     first 10 steps card vs CPU; prepare_vposer_dataset on a seeded
     AMASS-layout tree (4032 frames), train_vposer for 2 epochs at batch
     128 (two K1f and one K1b a step), one step card vs CPU from the
     second epoch's start, steps/s and a torch.profiler breakdown;
     humor_motion_fit(optimizer="lbfgs") at 3/5/2 steps on path K's
     fit-prox --rgbd window (K4 once a loss evaluation), each stage's
     loss and gradient where it starts card vs CPU; the geometry helpers
     card vs CPU;
   - path O: HuMoR training at the reference widths (1024-wide GroupNorm
     MLPs, latent 48, contacts predicted): python -m
     nemo_tpu_torch.cli.humor_tool train's main on --synthetic 4096
     windows of 10 transitions at batch 256 for 3 epochs with scheduled
     sampling from epoch 1 to 2 and a milestone at 2, supervised on
     --amass over a process-amass tree of four seeded walks (K1f), and on
     --shards; steps/s, busy share and largest kernels; a step with no
     device synchronisation; a NaN batch skipped bit for bit;
     humor_params.npz read back bit for bit; three steps card vs CPU;
     humor_full_loss with the SMPL terms at B = 512 on the 6890-vertex
     body (two K1f and one K1b a forward and backward), card vs CPU;
     train-state-prior at its defaults and on states_from_sequences of
     the training windows, EM card vs CPU from the same means;
     humor_eval_* on the trained weights, card vs CPU;
   - path P: the rest of render/ at full width on the reference
     configuration's initial motion (8 views x 120 frames, 1000 x 1900):
     the input, mv (8 x 8), pretty (8 rows of 6 people and the ground, one
     K5s scene a row), pretty individual, 3D (2 x 10), GT, pred-in-GT and
     GLAMR rollout figures on a bundle written with GLAMR slots, the
     per-joint frames (2 views x 2 frames) and the root trajectories (their
     PNGs skipped without matplotlib); outside the launch count, one pretty
     scene's K5s output bit for bit its plain fold on the card and its
     image against the CPU's;
   - path Q: data parallelism and the seed fan-out at the reference
     configuration: Q1 the fit CLI's main with --dp 1 in an NCCL group of
     one, bit for bit the one-process fit; Q2 two ranks on cuda:0 over gloo
     (this script started as ``--q2-rank R PORT DIR``), NemoFitter(mesh=)
     at 256 rows a rank against Q1, parameters equal across the ranks,
     train_vposer(mesh=) against one rank; Q3 fit_many_seeds, 4 seeds x 20
     steps, each seed bit for bit a lone fitter.
   Losses must be finite, main-stage kp_loss must fall on slice 1 and paths
   A and F (stage 2's loss on path E), fit_loss on the card must agree with the
   port's CPU path from the same parameters (points3d_loss and the stage-3
   loss on path E; with the HuMoR term on path G), and one step of each
   stage must run without a device synchronisation.

Prints a JSON line of per-kernel results, the nvidia-smi line as the tool
prints it, and as the last line {"ok": true, "device": {...}}. Any failure
raises (exit code 1).
"""

import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time

BATCH = 512
BATCH_A = 8 * 120       # path A's full batch: every view and frame
B_CELL = 47 * 600       # the benchmark cell cv_47x600's full batch
PEAK_F32_FLOPS = 67e12   # H100 SXM, f32 outside the tensor cores, 700 W
PEAK_TF32_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores, 700 W
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores, 700 W
PEAK_HBM_BYTES = 3.35e12

# counter key -> (source, TPU kernel it replaces)
KERNELS = {
    "fk_fwd": ("nemo_tpu_torch/csrc/fk.cu",
               "nemo_tpu/ops/fk_pallas.py:197"),
    "fk_bwd": ("nemo_tpu_torch/csrc/fk.cu",
               "nemo_tpu/ops/fk_pallas.py:226"),
    "v2v_grad": ("nemo_tpu_torch/csrc/v2v.cu",
                 "nemo_tpu/ops/lbs_pallas.py:709"),
    "v2v_fwd": ("nemo_tpu_torch/csrc/v2v.cu",
                "nemo_tpu/ops/lbs_pallas.py:560"),
    "v2v_pair": ("nemo_tpu_torch/csrc/v2v.cu",
                 "nemo_tpu/ops/lbs_pallas.py:560"),
    "skin_fwd": ("nemo_tpu_torch/csrc/skin.cu",
                 "nemo_tpu/ops/lbs_pallas.py:129"),
    "skin_bwd": ("nemo_tpu_torch/csrc/skin.cu",
                 "nemo_tpu/ops/lbs_pallas.py:259"),
    "skin_bwd_vp": ("nemo_tpu_torch/csrc/skin.cu",
                    "nemo_tpu/ops/lbs_pallas.py:259"),
    "raster_stream": ("nemo_tpu_torch/csrc/raster.cu",
                      "nemo_tpu/ops/raster_pallas.py:391"),
    "raster_gather": ("nemo_tpu_torch/csrc/raster.cu",
                      "nemo_tpu/ops/raster_pallas.py:199"),
    "chamfer_nn": ("nemo_tpu_torch/csrc/chamfer.cu",
                   "nemo_tpu/ops/chamfer.py:111"),
    "mlp_fwd": ("nemo_tpu_torch/csrc/mlp.cu",
                "nemo_tpu/ops/mlp_pallas.py:153"),
    "mlp_bwd": ("nemo_tpu_torch/csrc/mlp.cu",
                "nemo_tpu/ops/mlp_pallas.py:177"),
    # K7 replaces no TPU kernel: XLA fuses the JAX package's composition
    "humor_gn_fwd": ("nemo_tpu_torch/csrc/groupnorm.cu",
                     "none: XLA fuses nemo_tpu/models/humor.py:_group_norm"),
    "humor_gn_bwd": ("nemo_tpu_torch/csrc/groupnorm.cu",
                     "none: XLA fuses nemo_tpu/models/humor.py:_group_norm"),
}
# the bf16 tables' instantiations of the skinning kernels (--skin_bf16):
# the same sources and TPU kernels, their computation with bf16 tables
SKIN_KERNELS = ("v2v_grad", "v2v_fwd", "v2v_pair", "skin_fwd", "skin_bwd",
                "skin_bwd_vp")
KERNELS.update({k + "_bf16": KERNELS[k] for k in SKIN_KERNELS})
# K6 at the JAX package's other network precisions (NEMO_TPU_NET_PRECISION:
# "high" = bf16x3, "bf16"), and K3 writing and reading bf16 meshes
# (NEMO_TPU_SKIN_IO_BF16) with f32 or bf16 tables: the same sources and TPU
# kernels, the computations those knobs select
NET_PRECISIONS = ("high", "bf16")
KERNELS.update({f"{k}_{p}": KERNELS[k] for p in NET_PRECISIONS
                for k in ("mlp_fwd", "mlp_bwd")})
IO_KERNELS = tuple(k + t + "_io_bf16" for k in ("skin_fwd", "skin_bwd")
                   for t in ("", "_bf16"))
KERNELS.update({k: KERNELS[k.split("_io")[0]] for k in IO_KERNELS})
# bf16 gradients, kernel against plain: where the two round gm = g . [vp; 1]
# or gvp to bf16 after f32 sums taken in other orders, a term can move by
# one bf16 step (2^-8 of it); 1e-3 of the tensor's largest entry holds a few
# such flips (tests/test_torch_port_gpu.py's GRAD_BF16). A rounding point
# moved moves entries by about as much, so each bf16 gradient is also held
# within lbs.MISROUNDED_SHARE of the plain version's distance from every
# variant with one point moved (lbs.misrounding_shares)
GRAD_BF16 = 1e-3
# K6 at "bf16", kernel against plain: both round the same operands and sum
# exact products in f32 in other orders, and where a layer's f32 output
# straddles a rounding point the next layer's operand is one bf16 step
# (2^-7 of it) apart; the terms of a product exceed the outputs they
# cancel into (|z_i Wo_ij| against |out_j|: measured 1.17e-3 of out's
# largest entry at B = 512, H100), so each output is held within one bf16
# rounding (2^-8) of its largest entry, and within mlp.MISROUNDED_SHARE of
# the plain version's distance from every variant with a rounding point
# moved (mlp.misrounding_shares)
K6_BF16 = 2.0 ** -8

# f32 operations per (batch row, vertex) of the skinning kernels (a MAC is
# 2): posing 3x207 MACs + 3 adds, blending 12x24 MACs, transforming 9 MACs;
# in a backward blending only the 3x3 rotation part, 9x24 MACs (gvp reads
# M's rotation, gA reads [vp; 1], never M's translation), gvp 9 MACs, gpf
# 3x207 MACs, gA 9 products + 12x24 MACs, gvsh 3 adds; |rec - orig| and its
# sum 9.
POSE_FLOP = 2 * 621 + 3
BLEND_FLOP = 2 * 288
BWD_BLEND_FLOP = 2 * 216
SIDE_FLOP = POSE_FLOP + BLEND_FLOP + 2 * 9
# one posedirs contraction per (batch row, vertex): a side's forward vph or
# the backward gpf. The one-pass kernels run them on the TF32 tensor cores
# as three products each (3xTF32): K2 the forward of both sides and gpf,
# K3b gpf and, recomputing the posed vertices, the forward of its one side,
# K3f and K2's pair mode the forward of each side; the rest of their work
# stays on the CUDA cores
POSE_TC_FLOP = 2 * 621
K2_TC_FWD_FLOP = 2 * POSE_TC_FLOP
K2_TC_GRAD_FLOP = POSE_TC_FLOP
# with bf16 tables the blend M = A . W (12x24 MACs, or its 9x24 rotation in
# a backward) and gA's gm . W^T (12x24 MACs) multiply bf16 operands too and
# sum in f32: the function of a bf16 tensor-core contraction, so the bf16
# bound takes them at the bf16 peak with the posedirs contractions; only
# the elementwise rest stays on the CUDA cores
BF16_TC_SIDE_FLOP = POSE_TC_FLOP + BLEND_FLOP
BF16_TC_GA_FLOP = 2 * 288
BF16_TC_K2_FWD_FLOP = 2 * BF16_TC_SIDE_FLOP
BF16_TC_K2_GRAD_FLOP = POSE_TC_FLOP + BF16_TC_GA_FLOP
BF16_TC_BWD_VP_FLOP = BWD_BLEND_FLOP + POSE_TC_FLOP + BF16_TC_GA_FLOP
BF16_TC_BWD_FLOP = POSE_TC_FLOP + BF16_TC_BWD_VP_FLOP
GRAD_FLOP = 2 * 9 + 2 * 621 + 9 + 2 * 288 + 3
L1_FLOP = 9
# per joint: forward R = R_p R_l (27 MACs), t = R_p t_l + t_p (9 MACs + 3);
# backward twice the products (the parent's and the local cotangents)
FK_FLOP_PER_JOINT = {"fk_fwd": 2 * (27 + 9) + 3,
                     "fk_bwd": 2 * 2 * (27 + 9) + 3}
# f32 operations of one face test at one pixel in the rasterizer's fold
# (csrc/raster_common.cuh): three edge functions of 2 subtractions, 2
# products and 1 subtraction each (15), three sign products and three
# comparisons (6), three barycentric and three inverse-depth products (6),
# 2 additions, 1 depth comparison: 30. The bound counts them for each
# (entry, sub-tile) pair the kernel folds, over the sub-tile's 256 pixels:
# the span scatter's repeated entries and the pairs the exact cull rules
# out need no work. The TPU kernel's dense work (each distinct (face,
# tile) pair over the tile's 4096 pixels) is printed beside it. Bytes:
# each entry read once (9 f32 attributes and a face id), z, fid and bary
# written (20 B a pixel).
RASTER_FLOP = 30
RASTER_TILE_PIXELS = 32 * 128
RASTER_SUBTILE_PIXELS = 8 * 32   # a warp's sub-tile in csrc/raster.cu
RASTER_ENTRY_BYTES = 40
RASTER_PIXEL_BYTES = 20
IMG_HW = (1000, 1900)    # synthetic_problem's image, (D0 height, D1 width)
# f32 operations per (query, candidate) pair of the chamfer search: 3
# products and 2 sums for the dot, the product by 2, one sum, one
# difference, one comparison
CHAMFER_FLOP = 9
# f32 instructions csrc/chamfer.cu issues a pair for that arithmetic: it
# doubles each query once and takes the minimum a group at a time (fminf),
# so 3 products, 4 sums and a minimum
CHAMFER_INSTR = 8
# f32 instructions the card issues a second: 132 SMs x 128 lanes at 1.98 GHz
LANE_INSTR_PER_S = 132 * 128 * 1.98e9
# path E: fit-amass's defaults (seq_len 60, num_samp_pts 512, steps 30 70
# 70, lr 1e-2, latent 48) on the 6890-vertex synthetic SMPL
SEQ_LEN, SAMP_PTS = 60, 512
# path E's --steps: the CLI's 30 and 70 in stages 1 and 2, stage 3 cut from
# 70 to 10 (as path K's K_STEPS cut fit-rgb and fit-prox)
E_STEPS = ("30", "70", "10")
# path K: fit-prox --rgbd's --max_pts (its default), and where its scans lie:
# the person about 2 m in front of the Kinect
PROX_PTS = 4096
PROX_OFFSET = (0.3, -0.2, 2.0)
# the reference MotionNet (bench.py:101): input RBF 100 + instance code 5,
# width 1000, heads 24 x 6 rotations + 3 translations
MLP_D, MLP_H, MLP_O = 105, 1000, 147


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(flop: float, bytes_: float):
    """(least time in ms, what bounds it)."""
    t_op, t_mem = flop / PEAK_F32_FLOPS, bytes_ / PEAK_HBM_BYTES
    return 1e3 * max(t_op, t_mem), ("operations" if t_op >= t_mem else "bytes")


def tc_bound_ms(flop: float, tc_flop: float, bytes_: float,
                bf16: bool = False, passes: int = 0):
    """A one-pass kernel's least time with the contractions it may run on
    the tensor cores (tc_flop of the flop) there: the posedirs ones in
    3xTF32 (three TF32 products each) or, with bf16 tables, those and the
    blend and gA in one bf16 pass (K6: ``passes`` bf16 products each, 3 at
    "high"); the rest in f32 on the CUDA cores: (ms, "tensor cores", "CUDA
    cores" or "bytes")."""
    passes = passes or (1 if bf16 else 3)
    tc = passes * tc_flop / (PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS)
    times = {"tensor cores": tc,
             "CUDA cores": (flop - tc_flop) / PEAK_F32_FLOPS,
             "bytes": bytes_ / PEAK_HBM_BYTES}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def check(name: str, got, want, atol: float, results: dict) -> float:
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ok = math.isfinite(err) and err <= atol
    print(f"[kernel] {name}: max_abs_err {err:.3e} (tolerance {atol:.3e}), "
          f"relative to max |plain| {err / max(scale, 1e-30):.3e} "
          f"(max |plain| {scale:.3e}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    results[name] = max(results.get(name, 0.0), err)
    return err


def time_kernel(rec, key, shape, kernel, plain, flop, bytes_, library=None,
                plain_reps: int = 20, tc_flop=None, bf16: bool = False,
                passes: int = 0):
    """Median CUDA-event times of a kernel, its plain version and one
    PyTorch call, beside the bound; given the flop its tensor cores take,
    the bound is the tensor-core one (bf16: one bf16 pass) and the f32
    bound is only printed. The first record of a key is kept."""
    f32_ms, by = bound_ms(flop, bytes_)
    b_ms = f32_ms
    if tc_flop is not None:
        b_ms, tc_by = tc_bound_ms(flop, tc_flop, bytes_, bf16, passes)
        by = "bytes" if tc_by == "bytes" else "operations"
    r = {"ms": median_ms(kernel),
         "plain_ms": median_ms(plain, reps=plain_reps,
                               warm=min(3, plain_reps)),
         "library_ms": None if library is None else median_ms(library),
         "bound_ms": b_ms, "bound_by": by, "shape": shape,
         "gflop": flop / 1e9, "mbytes": bytes_ / 1e6}
    lib = "none" if library is None else f"{r['library_ms']:.4f} ms"
    print(f"[time] {key} {shape}: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, one PyTorch call {lib}, bound "
          f"{b_ms:.4f} ms ({by}; {flop / 1e9:.3f} GFLOP, "
          f"{bytes_ / 1e6:.3f} MB) (median of 20 CUDA-event timings, "
          f"{plain_reps} of the plain version)")
    if tc_flop is not None:
        tc_text = (f"{(passes or 1) * tc_flop / 1e9:.3f} GFLOP in bf16 at "
                   f"989 TFLOP/s" if bf16 else
                   f"{3 * tc_flop / 1e9:.3f} GFLOP in 3xTF32 at 495 TFLOP/s")
        print(f"[time] {key} {shape}: tensor-core bound {b_ms:.4f} ms "
              f"({tc_by}; {tc_text}, {(flop - tc_flop) / 1e9:.3f} GFLOP "
              f"f32 at 67) "
              f"beside the f32 bound {f32_ms:.4f} ms; kernel at "
              f"{100 * b_ms / r['ms']:.1f}% of it ({nvidia_smi_line()})")
    rec.setdefault(key, r)
    return r


def profiled_ms(fn, kernels, reps: int = 20, launches: int = 1,
                tries: int = 5) -> dict:
    """{kernel: mean device time a launch in ms, or None} for the launches
    whose name holds ``kernel``, from torch.profiler over ``reps`` calls of
    fn, each of which launches every kernel ``launches`` times (device time
    alone: neither the host's work nor the gaps between launches). A trace
    may lose the device events of its first launches (late in a long
    process, the first few milliseconds' worth), so each trace runs fn
    ``reps`` times unmeasured, then the ``reps`` measured calls inside a
    mark. A kernel's time comes only from a trace that holds all reps x
    launches of its launches after the mark; fn is traced again while a
    kernel lacks one, up to ``tries`` traces, and a kernel that none held
    whole maps to None ("not measured")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    out = dict.fromkeys(kernels)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            with record_function("profiled_ms"):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        t0 = next(e.time_range.start for e in events
                  if e.name == "profiled_ms"
                  and e.device_type == DeviceType.CPU)
        # record_function ranges are drawn on the device's timeline too
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and e.time_range.start >= t0 and not e.is_user_annotation]
        for k in kernels:
            mine = [e.time_range.elapsed_us() for e in device if k in e.name]
            if out[k] is None and len(mine) == reps * launches:
                out[k] = sum(mine) / len(mine) / 1e3
        if all(v is not None for v in out.values()):
            break
    return out


def device_ms_text(ms, reps: int = 20) -> str:
    """profiled_ms's entry as text."""
    if ms is None:
        return f"not measured (no trace held all {reps} launches)"
    return f"{ms:.4f} ms (torch.profiler, mean of {reps} launches)"


def random_rotations(B: int, J: int, gen, device, scale: float = 0.6):
    import torch
    from nemo_tpu_torch.geometry.rotations import batch_rodrigues
    aa = scale * torch.randn((B, J, 3), generator=gen)
    return batch_rodrigues(aa).to(device)


def skin_side_inputs(smpl, B, gen, device, offset=0.0):
    """(pf, A34) as smpl_v2v_l1_sum builds them from random rotations; a
    nonzero offset moves each row by +-offset metres on each axis."""
    import torch
    from nemo_tpu_torch.body.smpl import fk_rt
    Jr = torch.einsum('jv,vk->jk', smpl.J_regressor, smpl.v_template)[None]
    with torch.no_grad():
        rot = random_rotations(B, 24, gen, device)
        pf = (rot[:, 1:] - torch.eye(3, device=device)).reshape(B, 207)
        R_g, _, t_rel = fk_rt(rot, Jr, smpl.parents)
        A = torch.cat([R_g, t_rel[..., None]], -1)
    if offset:
        A[..., 3] += offset * torch.sign(torch.randn((B, 1, 3),
                                                     generator=gen)).to(device)
    return pf.contiguous(), A.reshape(B, 24, 12).contiguous()


def k3b_checks(a, g, vp, tag, errs):
    """K3b recomputing the posed vertices and reading the stored vp against
    the plain version under the cotangent g, each rerun bit-identical
    (fixed-order partials, no atomics). Tolerance: sums over V (gpf, gA) or
    B (gvsh) products, the posedirs ones in 3xTF32, in another order; atol
    1e-4 x the tensor's largest entry. Returns both modes' gradients."""
    import torch
    from nemo_tpu_torch.ops import lbs
    out = []
    for key, stored in (("skin_bwd", None), ("skin_bwd_vp", vp)):
        got = lbs.skin_bwd_cuda(*a, g, vp=stored)
        for name, gk, gp in zip(("gpf", "gA", "gvsh"), got,
                                lbs.skin_bwd_plain(*a, g, vp=stored)):
            check(f"{key} {name} {tag}", gk, gp, 1e-4 * float(gp.abs().max()),
                  errs)
        if not all(torch.equal(x, y) for x, y in
                   zip(lbs.skin_bwd_cuda(*a, g, vp=stored), got)):
            raise AssertionError(f"{key} is not bit-stable run to run ({tag})")
        out.append(got)
    return out


def kernel_phase(device, smpl):
    """Every kernel against its plain version, with times and bounds.
    Returns ({kernel: max_abs_err}, {kernel: timing record})."""
    import torch
    from nemo_tpu_torch.body.smpl import subset_skin_tables
    from nemo_tpu_torch.ops import fk, lbs

    gen = torch.Generator().manual_seed(0)
    errs, rec = {}, {}
    parents = tuple(int(p) for p in smpl.parents)
    B, B_A, J, V = BATCH, BATCH_A, 24, smpl.num_vertices

    def timed(*a, **k):
        return time_kernel(rec, *a, **k)

    # K1 at slice 1's batch, path A's full batch (8 views x 120 frames) and
    # path E's 60-frame windows on SMPL's tree, and at 512 and 60 on a
    # 23-deep chain, a star and a random 64-joint tree; each rerun must give
    # the same bits (fixed-order folds, no atomics). Tolerance: a chain of
    # up to 23 f32 3x3 products of O(1) entries; the two sides differ only
    # in summation order and FMA (~1e-7 a product). The cases beyond
    # SMPL's at 512 and 960 draw from a generator of their own, so the
    # later kernels' inputs stay as they were.
    tree_gen = torch.Generator().manual_seed(64)
    fk_trees = {"smpl": parents, "chain": (-1,) + tuple(range(23)),
                "star": (-1,) + (0,) * 23,
                "random64": (-1,) + tuple(
                    int(torch.randint(0, j, (1,), generator=tree_gen))
                    for j in range(1, 64))}
    print("[kernel] fk_fwd_kernel, fk_bwd_kernel resources at J=24 "
          "(cudaFuncGetAttributes): " + json.dumps(
              [fk.fk_attributes(False), fk.fk_attributes(True)]))
    fk_cases = [("smpl", B), ("smpl", B_A), ("smpl", SEQ_LEN)] + [
        (tree, Bk) for tree in ("chain", "star", "random64")
        for Bk in (B, SEQ_LEN)]
    for tree, Bk in fk_cases:
        par = fk_trees[tree]
        Jk, tag = len(par), f"{tree} B={Bk}"
        g = gen if tree == "smpl" and Bk in (B, B_A) else tree_gen
        R_l = random_rotations(Bk, Jk, g, device)
        t_l = (0.3 * torch.randn((Bk, Jk, 3), generator=g)).to(device)
        gR = torch.randn((Bk, Jk, 3, 3), generator=g).to(device)
        gt = torch.randn((Bk, Jk, 3), generator=g).to(device)
        Rk, tk = fk.fk_fwd_cuda(R_l, t_l, par)
        Rp, tp = fk.fk_fwd_plain(R_l, t_l, par)
        check(f"fk_fwd {tag}", torch.cat([Rk.flatten(), tk.flatten()]),
              torch.cat([Rp.flatten(), tp.flatten()]), 1e-5, errs)
        gRk, gtk = fk.fk_bwd_cuda(R_l, t_l, Rk, gR, gt, par)
        gRp, gtp = fk.fk_bwd_plain(R_l, t_l, Rp, gR, gt, par)
        # cotangents are N(0,1) summed over up to 63 descendants: O(10)
        check(f"fk_bwd {tag}", torch.cat([gRk.flatten(), gtk.flatten()]),
              torch.cat([gRp.flatten(), gtp.flatten()]), 1e-4, errs)
        again = fk.fk_fwd_cuda(R_l, t_l, par) + fk.fk_bwd_cuda(
            R_l, t_l, Rk, gR, gt, par)
        if not all(torch.equal(a, b)
                   for a, b in zip(again, (Rk, tk, gRk, gtk))):
            raise AssertionError(f"K1 is not bit-stable run to run ({tag})")
        if tree != "smpl" or Bk == SEQ_LEN:
            continue
        # no single PyTorch call composes a kinematic tree: library none
        calls = {"fk_fwd": lambda: fk.fk_fwd_cuda(R_l, t_l, par),
                 "fk_bwd": lambda: fk.fk_bwd_cuda(R_l, t_l, Rk, gR, gt, par)}
        r = {"fk_fwd": timed(
            "fk_fwd", f"B={Bk}", calls["fk_fwd"],
            lambda: fk.fk_fwd_plain(R_l, t_l, par),
            FK_FLOP_PER_JOINT["fk_fwd"] * (Jk - 1) * Bk,
            nbytes(R_l, t_l, Rk, tk))}
        r["fk_bwd"] = timed(
            "fk_bwd", f"B={Bk}", calls["fk_bwd"],
            lambda: fk.fk_bwd_plain(R_l, t_l, Rk, gR, gt, par),
            FK_FLOP_PER_JOINT["fk_bwd"] * (Jk - 1) * Bk,
            nbytes(R_l, t_l, Rk, gR, gt, gRk, gtk))
        dev = profiled_ms(lambda: (calls["fk_fwd"](), calls["fk_bwd"](),
                                   fk.fk_empty_cuda(Bk, Jk, False, device)),
                          ("fk_fwd_kernel", "fk_bwd_kernel",
                           "fk_empty_kernel"))
        ms = {k: device_ms_text(v) for k, v in dev.items()}
        for key in calls:
            print(f"[time] {key} B={Bk}: device time a launch "
                  f"{ms[key + '_kernel']}, one "
                  f"call {r[key]['ms']:.4f} ms, launch floor "
                  f"{ms['fk_empty_kernel']} (an empty kernel on K1's grid), "
                  f"bound {r[key]['bound_ms']:.4f} ms ({nvidia_smi_line()})")

    # K2 inputs as smpl_v2v_l1_sum builds them. The rec side gets a
    # per-row offset of +-10 m on each axis, so no vertex difference is
    # near 0: there sign(rec - orig) could flip between two summation
    # orders and move a gradient entry by a whole term.
    vsh = smpl.v_template.t().contiguous()
    pd, W = smpl.posedirs_t, smpl.lbs_weights_t

    def k2(args, grad):
        """K2's fused (grad) or forward-only mode, reading the model's
        padded posedirs copy as the fit does."""
        return lbs.v2v_l1_cuda(*args, grad=grad,
                               posedirs_pad=smpl.posedirs_pad)

    print(f"[kernel] v2v_fused_kernel resources (cudaFuncGetAttributes): "
          f"{json.dumps(lbs.v2v_fused_attributes())}")

    def k2_inputs(Bk, g):
        pf_o, A_o = skin_side_inputs(smpl, Bk, g, device)
        pf_r, A_r = skin_side_inputs(smpl, Bk, g, device, offset=10.0)
        return (pf_o, A_o, vsh, pd, W, pf_r, A_r)

    fwd_res = {k: lbs.skin_fwd_attributes(k == "pair")
               for k in ("skin_fwd", "pair")}
    print(f"[kernel] skin_fwd_kernel resources (cudaFuncGetAttributes): "
          f"{json.dumps(fwd_res)}")

    def fwd_stable(args, got, tag):
        """The pair mode rerun bit-identical, and without vp the same total
        and sign."""
        again = lbs.v2v_pair_cuda(*args, want_vp=True)
        tot_n, sign_n, none = lbs.v2v_pair_cuda(*args, want_vp=False)
        if not (all(torch.equal(x, y) for x, y in zip(again, got)) and
                none is None and torch.equal(tot_n, got[0]) and
                torch.equal(sign_n, got[1])):
            raise AssertionError(f"v2v_pair is not bit-stable ({tag})")

    def pair_checks(args, tag):
        """The pair mode against its plain version: total rtol 1e-5 (sums
        of B x 3V |diff| terms in another order), sign exact (the rec side
        offset by +-10 m), vp within 1e-5 of its largest entry (sums of
        207 products, in 3xTF32, in another order); then fwd_stable."""
        got = lbs.v2v_pair_cuda(*args, want_vp=True)
        tot_p, sign_p, vp_p = lbs.v2v_pair_plain(*args, want_vp=True)
        check(f"v2v_pair total {tag}", got[0], tot_p,
              1e-5 * float(tot_p.abs()), errs)
        check(f"v2v_pair sign {tag}", got[1], sign_p, 0.0, errs)
        check(f"v2v_pair vp {tag}", got[2], vp_p,
              1e-5 * float(vp_p.abs().max()), errs)
        fwd_stable(args, got, tag)

    def k3f_check(a, tag):
        """K3f against its plain version (sums of 207 + 24 + 3 f32 products
        of metre-scale values: 1e-5 of the largest entry), rerun
        bit-identical."""
        out_k = lbs.skin_fwd_cuda(*a)
        out_p = lbs.skin_verts_t_plain(*a)
        check(f"skin_fwd {tag}", out_k, out_p,
              1e-5 * float(out_p.abs().max()), errs)
        if not torch.equal(lbs.skin_fwd_cuda(*a), out_k):
            raise AssertionError(f"skin_fwd is not bit-stable ({tag})")

    def k2_fused_checks(args, tag):
        """K2's one-pass kernel (fused and forward-only modes) against the
        plain version; returns (total, grads) of each."""
        tot_k, grads_k = k2(args, True)
        tot_p, grads_p = lbs.v2v_l1_plain(*args, grad=True)
        tot_f, _ = k2(args, False)
        # total: B x 20670 |diff| terms summed in another order, rtol 1e-5
        check(f"v2v_grad total{tag}", tot_k, tot_p,
              1e-5 * float(tot_p.abs()), errs)
        check(f"v2v_fwd total{tag}", tot_f, tot_p,
              1e-5 * float(tot_p.abs()), errs)
        if not torch.equal(tot_f, tot_k):
            raise AssertionError(f"forward-only total differs from grad "
                                 f"mode{tag}")
        # gradients: sums of up to 3V = 20670 products (the posedirs ones
        # in 3xTF32) in another order; atol 1e-4 x the tensor's largest
        # entry
        for name, gk, gp in zip(("gpf", "gA", "gvsh"), grads_k, grads_p):
            check(f"v2v_grad {name}{tag}", gk, gp,
                  1e-4 * float(gp.abs().max()), errs)
        rerun = k2(args, True)
        if not (torch.equal(rerun[0], tot_k) and all(
                torch.equal(a, b) for a, b in zip(rerun[1], grads_k))):
            raise AssertionError(f"K2 is not bit-stable run to run{tag}")
        return (tot_k, grads_k), (tot_p, grads_p)

    def k2_times(args, grads, tot, gvp):
        """Times of K2's fused and forward-only modes; gvp (B, 3V) feeds
        the one PyTorch call of the fused mode's largest contraction."""
        Bk = args[0].shape[0]
        bv = Bk * V
        VV = 3 * V
        pf2 = torch.cat([args[0], args[5]])
        pd2 = pd.reshape(207, VV)
        io = nbytes(*args[:2], *args[5:], tot) + nbytes(vsh, pd, W)
        timed("v2v_grad", f"B={Bk}, V={V}",
              lambda: k2(args, True),
              lambda: lbs.v2v_l1_plain(*args, grad=True),
              bv * (2 * SIDE_FLOP + L1_FLOP + GRAD_FLOP),
              io + nbytes(*grads),
              library=lambda: torch.matmul(gvp, pd2.t()),
              tc_flop=bv * (K2_TC_FWD_FLOP + K2_TC_GRAD_FLOP))
        timed("v2v_fwd", f"B={Bk}, V={V}",
              lambda: k2(args, False),
              lambda: lbs.v2v_l1_plain(*args, grad=False),
              bv * (2 * SIDE_FLOP + L1_FLOP), io,
              library=lambda: torch.matmul(pf2, pd2),
              tc_flop=bv * K2_TC_FWD_FLOP)

    args = k2_inputs(B, gen)
    pf_o, A_o, _, _, _, pf_r, A_r = args
    side = (pf_o, A_o, vsh, pd, W)
    (tot_k, (gpf_k, gA_k, gvsh_k)), (tot_p, (gpf_p, gA_p, gvsh_p)) = \
        k2_fused_checks(args, "")

    # K2 pair mode: sign exact (the offset keeps every difference far from
    # 0), vp to f32 ordering noise, and the gradients K3b computes from
    # them against the plain gradients.
    tot_q, sign_k, vp_k = lbs.v2v_pair_cuda(*args, want_vp=True)
    _, sign_p, vp_p = lbs.v2v_pair_plain(*args, want_vp=True)
    check("v2v_pair total", tot_q, tot_p, 1e-5 * float(tot_p.abs()), errs)
    check("v2v_pair sign", sign_k, sign_p, 0.0, errs)
    check("v2v_pair vp", vp_k, vp_p, 1e-5 * float(vp_p.abs().max()), errs)
    fwd_stable(args, (tot_q, sign_k, vp_k), f"B={B}, V={V}")
    pair = lbs.skin_bwd_cuda(*side, sign_k)
    pair_vp = lbs.skin_bwd_cuda(*side, sign_k, vp=vp_k)
    for name, gk, gp in zip(("gpf", "gA", "gvsh"), pair, (gpf_p, gA_p, gvsh_p)):
        check(f"v2v_pair grad {name}", gk, gp, 1e-4 * float(gp.abs().max()),
              errs)
    # Not bit-identical by design, so only printed: K3b recomputes vp in
    # 3xTF32 on the tensor cores, K2's pair mode stores a vp summed in f32
    # on the CUDA cores; the 1e-5 checks below hold them together.
    ident = {
        "pair_vp vs pair": all(torch.equal(a, b) for a, b in zip(pair_vp, pair)),
        "pair vs fused": all(torch.equal(a, b) for a, b in
                             zip(pair, (gpf_k, gA_k, gvsh_k)))}
    print(f"[kernel] bit-identical gradients: {json.dumps(ident)}")
    for name, a, b in zip(("gpf", "gA", "gvsh"), pair_vp, pair):
        check(f"skin_bwd_vp vs skin_bwd (pair) {name}", a, b,
              1e-5 * float(b.abs().max()), errs)

    # K3b under a random cotangent at (512, 6890), both modes, the stored
    # posed vertices the K2 pair mode's vp; then at the small shapes
    res = {m: lbs.skin_bwd_attributes(m == "stored_vp")
           for m in ("recompute", "stored_vp")}
    print(f"[kernel] skin_bwd_kernel resources (cudaFuncGetAttributes): "
          f"{json.dumps(res)}")
    g = torch.randn((B, 3, V), generator=gen).to(device)
    got, got_vp = k3b_checks(side, g, vp_k, f"B={B}, V={V}", errs)
    ident["skin_bwd_vp vs skin_bwd (random g)"] = all(
        torch.equal(a, b) for a, b in zip(got_vp, got))
    print(f"[kernel] bit-identical gradients: {json.dumps(ident)}")
    posed = lambda a: (torch.einsum('bp,pkv->bkv', a[0], a[3])
                       + a[2]).contiguous()
    gen_s = torch.Generator().manual_seed(1)
    for Bk, Vk in ((1, 5), (37, 300)):
        vidx, pd_s, W_s = subset_skin_tables(smpl, Vk)
        a = (*skin_side_inputs(smpl, Bk, gen_s, device),
             vsh[:, vidx].contiguous(), pd_s, W_s)
        gk = torch.randn((Bk, 3, Vk), generator=gen_s).to(device)
        for gname, gg in (("random g", gk), ("sign g", torch.sign(gk))):
            k3b_checks(a, gg, posed(a), f"B={Bk}, V={Vk}, {gname}", errs)

    # K3f at the slice-1 shape and at path A's (B=960, V=1024 subset); then
    # K3f and the pair mode at path A's shape and at the ragged (37, 300)
    # and (1, 5), each rerun bit-identical (fixed-order partials, no
    # atomics)
    vidx, pd_s, W_s = subset_skin_tables(smpl, 1024)
    pf_a, A_a = skin_side_inputs(smpl, B_A, gen, device)
    fwd_cases = (((pf_o, A_o, vsh, pd, W), f"B={B}, V={V}"),
                 ((pf_a, A_a, vsh[:, vidx].contiguous(), pd_s, W_s),
                  f"B={B_A}, V={len(vidx)}"))
    for a, shape in fwd_cases:
        k3f_check(a, shape)
    for Bk, Vk in ((B_A, 1024), (37, 300), (1, 5)):
        vi, pd_k, W_k = subset_skin_tables(smpl, Vk)
        a = (*skin_side_inputs(smpl, Bk, gen_s, device),
             vsh[:, vi].contiguous(), pd_k, W_k)
        shape = f"B={Bk}, V={len(vi)}"
        if Bk != B_A:
            k3f_check(a, shape)
        pair_args = (*a, *skin_side_inputs(smpl, Bk, gen_s, device,
                                           offset=10.0))
        pair_checks(pair_args, shape)

    # times at the paths' shapes
    VV = 3 * V
    pd2 = pd.reshape(207, VV)
    gvp = torch.randn((B, VV), generator=gen).to(device)
    pf2 = torch.cat([pf_o, pf_r])
    tables = nbytes(vsh, pd, W)
    bv = B * V
    k2_times(args, (gpf_k, gA_k, gvsh_k), tot_k, gvp)
    timed("v2v_pair", f"B={B}, V={V}, vp stored",
          lambda: lbs.v2v_pair_cuda(*args, want_vp=True),
          lambda: lbs.v2v_pair_plain(*args, want_vp=True),
          bv * (2 * SIDE_FLOP + L1_FLOP),
          nbytes(pf_o, A_o, pf_r, A_r, tot_k, sign_k, vp_k) + tables,
          library=lambda: torch.matmul(pf2, pd2),
          tc_flop=bv * K2_TC_FWD_FLOP)
    # K2's fused and forward-only modes at the custom-video recipe's full
    # batch (8 views x 120 frames), checked and timed as at B=512
    # (a generator of its own, so the later phases draw what they drew)
    gen_a = torch.Generator().manual_seed(B_A)
    args_a = k2_inputs(B_A, gen_a)
    (tot_a, grads_a), _ = k2_fused_checks(args_a, f" B={B_A}")
    k2_times(args_a, grads_a, tot_a,
             torch.randn((B_A, 3 * V), generator=gen_a).to(device))
    del args_a, grads_a
    # K2's fused and forward-only modes at the benchmark cell's full batch
    # (cv_47x600: 47 instances x 600 frames), where each block walks a
    # range of 216 vertex tiles: checked as at B=512 (the plain version's
    # (B, 3, 4, V) blends take about 9 GB each)
    gen_c = torch.Generator().manual_seed(B_CELL)
    k2_fused_checks(k2_inputs(B_CELL, gen_c), f" B={B_CELL}")
    torch.cuda.empty_cache()
    timed("skin_bwd", f"B={B}, V={V}",
          lambda: lbs.skin_bwd_cuda(*side, g),
          lambda: lbs.skin_bwd_plain(*side, g),
          bv * (POSE_FLOP + BWD_BLEND_FLOP + GRAD_FLOP),
          nbytes(*side, g, *got), library=lambda: torch.matmul(gvp, pd2.t()),
          tc_flop=bv * 2 * POSE_TC_FLOP)
    timed("skin_bwd_vp", f"B={B}, V={V}",
          lambda: lbs.skin_bwd_cuda(*side, g, vp=vp_k),
          lambda: lbs.skin_bwd_plain(*side, g, vp=vp_k),
          bv * (BWD_BLEND_FLOP + GRAD_FLOP),
          nbytes(A_o, pd, W, g, vp_k, *got),
          library=lambda: torch.matmul(gvp, pd2.t()),
          tc_flop=bv * POSE_TC_FLOP)
    for a, shape in reversed(fwd_cases):     # path A's shape is the record
        Bk, Vk = a[0].shape[0], a[2].shape[1]
        pdk = a[3].reshape(207, 3 * Vk)
        timed("skin_fwd", shape, lambda: lbs.skin_fwd_cuda(*a),
              lambda: lbs.skin_verts_t_plain(*a),
              Bk * Vk * SIDE_FLOP, nbytes(*a) + 4 * Bk * 3 * Vk,
              library=lambda: torch.matmul(a[0], pdk),
              tc_flop=Bk * Vk * POSE_TC_FLOP)
    # K3b at path A's shape under a random cotangent and a sign: recomputing
    # vp, as the subset loss runs it, and reading it stored; timed in the
    # log beside the (512, 6890) one
    Bk, Vk = B_A, len(vidx)
    a = fwd_cases[1][0]
    ga = torch.randn((Bk, 3, Vk), generator=gen).to(device)
    vp_a = posed(a)
    got_a, _ = k3b_checks(a, ga, vp_a, f"B={Bk}, V={Vk}", errs)
    k3b_checks(a, torch.sign(ga), vp_a, f"B={Bk}, V={Vk}, sign g", errs)
    pdk = a[3].reshape(207, 3 * Vk)
    gvpa = torch.randn((Bk, 3 * Vk), generator=gen).to(device)
    timed("skin_bwd path A", f"B={Bk}, V={Vk}",
          lambda: lbs.skin_bwd_cuda(*a, ga),
          lambda: lbs.skin_bwd_plain(*a, ga),
          Bk * Vk * (POSE_FLOP + BWD_BLEND_FLOP + GRAD_FLOP),
          nbytes(*a, ga, *got_a), library=lambda: torch.matmul(gvpa, pdk.t()),
          tc_flop=Bk * Vk * 2 * POSE_TC_FLOP)
    timed("skin_bwd_vp path A", f"B={Bk}, V={Vk}",
          lambda: lbs.skin_bwd_cuda(*a, ga, vp=vp_a),
          lambda: lbs.skin_bwd_plain(*a, ga, vp=vp_a),
          Bk * Vk * (BWD_BLEND_FLOP + GRAD_FLOP),
          nbytes(a[1], a[3], a[4], ga, vp_a, *got_a),
          library=lambda: torch.matmul(gvpa, pdk.t()),
          tc_flop=Bk * Vk * POSE_TC_FLOP)

    kernel_err = {
        "fk_fwd": max(errs[k] for k in errs if k.startswith("fk_fwd")),
        "fk_bwd": max(errs[k] for k in errs if k.startswith("fk_bwd")),
        "v2v_grad": max(errs[k] for k in errs if k.startswith("v2v_grad")),
        "v2v_fwd": max(errs[k] for k in errs if k.startswith("v2v_fwd")),
        "v2v_pair": max(errs[k] for k in errs if k.startswith("v2v_pair")),
        "skin_fwd": max(errs[k] for k in errs if k.startswith("skin_fwd")),
        "skin_bwd": max(errs[k] for k in errs if k.startswith("skin_bwd ")),
        "skin_bwd_vp": max(errs[k] for k in errs
                           if k.startswith("skin_bwd_vp")),
    }
    return kernel_err, rec


def bf16_kernel_phase(device, smpl, smpl_b, rec):
    """The skinning kernels' bf16 instantiations (the _bf16 entry points,
    --skin_bf16) at path H's shapes, each against its plain bf16 version on
    the same inputs and rerun bit-identical: K2 fused and forward-only and
    the pair mode at (512, 6890), K3b recomputing vp and reading the pair
    mode's bf16 vp under the pair mode's sign and a N(0,1) cotangent at
    (512, 6890), K3f and K3b at path H's subset (960, 1024). Tolerances:
    the total rtol 1e-5 and vertices 1e-5 of the largest entry (f32 sums
    of exact bf16 products in another order), the sign exact (the rec side
    offset by +-10 m), vp one bf16 step, gradients GRAD_BF16 and, against
    every variant of the plain version with one rounding point moved,
    within lbs.MISROUNDED_SHARE of its distance. Times as the f32 rows',
    the bound's posedirs, blend and gA contractions one bf16 pass at 989
    TFLOP/s and its bytes with 2-byte tables, one bf16 torch.matmul of the
    largest posedirs contraction as the one PyTorch call; each kernel's
    device time a launch beside the f32 kernel's on the same inputs; the
    bf16-vs-f32 gap of the vertices and the gradients. Returns {kernel:
    max_abs_err}."""
    import torch
    from nemo_tpu_torch.body.smpl import subset_skin_tables
    from nemo_tpu_torch.ops import lbs

    gen = torch.Generator().manual_seed(15)
    errs = {}
    B, B_A, V = BATCH, BATCH_A, smpl.num_vertices
    bf = torch.bfloat16
    vsh = smpl.v_template.t().contiguous()
    pd, W = smpl.posedirs_t, smpl.lbs_weights_t
    pdb, Wb = smpl_b.posedirs_t, smpl_b.lbs_weights_t
    if pdb.dtype != bf or Wb.dtype != bf:
        raise AssertionError("the bf16 body's tables are not bf16")
    res = {"v2v_fused": lbs.v2v_fused_attributes(bf16=True),
           "skin_fwd": lbs.skin_fwd_attributes(False, True),
           "pair": lbs.skin_fwd_attributes(True, True),
           "skin_bwd": lbs.skin_bwd_attributes(False, True),
           "skin_bwd_vp": lbs.skin_bwd_attributes(True, True)}
    print(f"[kernel] bf16 instantiations' resources (cudaFuncGetAttributes;"
          f" local_bytes are spills): {json.dumps(res)}")

    def stable(name, fn, got):
        again = fn()
        flat = lambda x: [t for t in (x if isinstance(x, tuple) else (x,))
                          for t in (t if isinstance(t, tuple) else (t,))]
        if not all(torch.equal(a, b) for a, b in zip(flat(again), flat(got))):
            raise AssertionError(f"{name} is not bit-stable run to run")

    def grads_check(key, got, args, g, vp, tag):
        want = lbs.skin_bwd_plain(*args, g, vp=vp)
        for name, gk, gp in zip(("gpf", "gA", "gvsh"), got, want):
            check(f"{key} {name} {tag}", gk, gp,
                  GRAD_BF16 * float(gp.abs().max()), errs)
        shares = lbs.misrounding_shares(got, *args, g, vp=vp)
        worst = max(shares, key=shares.get)
        print(f"[kernel] {key} {tag}: |kernel - plain| over |variant - "
              f"plain| at most {shares[worst]:.3e} (the variant {worst[0]} "
              f"on {worst[1]}; {len(shares)} variant-gradient pairs; "
              f"limit {lbs.MISROUNDED_SHARE}) "
              f"{'OK' if shares[worst] <= lbs.MISROUNDED_SHARE else 'FAIL'}")
        if shares[worst] > lbs.MISROUNDED_SHARE:
            raise AssertionError(f"{key}: rounds at other points than plain")

    # K2 at (512, 6890): both gradient-free and fused modes, and the pair
    pf_o, A_o = skin_side_inputs(smpl, B, gen, device)
    pf_r, A_r = skin_side_inputs(smpl, B, gen, device, offset=10.0)
    args_b = (pf_o, A_o, vsh, pdb, Wb, pf_r, A_r)
    args_f = (pf_o, A_o, vsh, pd, W, pf_r, A_r)
    tag = f"B={B}, V={V}"
    tot_k, g_k = lbs.v2v_l1_cuda(*args_b, grad=True)
    tot_q, sign_p, vp_p = lbs.v2v_pair_plain(*args_b, want_vp=True)
    tot_f, _ = lbs.v2v_l1_cuda(*args_b, grad=False)
    check(f"v2v_grad_bf16 total {tag}", tot_k, tot_q,
          1e-5 * float(tot_q.abs()), errs)
    check(f"v2v_fwd_bf16 total {tag}", tot_f, tot_q,
          1e-5 * float(tot_q.abs()), errs)
    if not torch.equal(tot_f, tot_k):
        raise AssertionError("bf16 forward-only total differs from grad mode")
    grads_check("v2v_grad_bf16", g_k, args_b[:5], sign_p, None, tag)
    stable("v2v_grad_bf16", lambda: lbs.v2v_l1_cuda(*args_b, grad=True),
           (tot_k, g_k))
    pair = lbs.v2v_pair_cuda(*args_b, want_vp=True)
    check(f"v2v_pair_bf16 total {tag}", pair[0], tot_q,
          1e-5 * float(tot_q.abs()), errs)
    check(f"v2v_pair_bf16 sign {tag}", pair[1], sign_p, 0.0, errs)
    if pair[2].dtype != bf:
        raise AssertionError("the bf16 pair mode's vp is not bf16")
    check(f"v2v_pair_bf16 vp {tag} (one bf16 step)", pair[2].float(),
          vp_p.float(), 2.0 ** -8 * float(vp_p.float().abs().max()), errs)
    stable("v2v_pair_bf16", lambda: lbs.v2v_pair_cuda(*args_b, want_vp=True),
           pair)
    # K3b at (512, 6890) under the pair mode's sign (as path H's pair modes
    # run it) and a N(0,1) cotangent, both modes
    side_b = args_b[:5]
    g_r = torch.randn((B, 3, V), generator=gen).to(device)
    for gname, g in (("sign g", pair[1]), ("random g", g_r)):
        for key, stored in (("skin_bwd_bf16", None),
                            ("skin_bwd_vp_bf16", pair[2])):
            got = lbs.skin_bwd_cuda(*side_b, g, vp=stored)
            grads_check(key, got, side_b, g, stored, f"{tag}, {gname}")
            stable(key, lambda: lbs.skin_bwd_cuda(*side_b, g, vp=stored),
                   got)
    # K3f and K3b at path H's subset (960, 1024), and K3f at (512, 6890)
    vidx, pd_s, W_s = subset_skin_tables(smpl_b, 1024)
    _, pd_sf, W_sf = subset_skin_tables(smpl, 1024)
    pf_a, A_a = skin_side_inputs(smpl, B_A, gen, device)
    Vs = len(vidx)
    sub_b = (pf_a, A_a, vsh[:, vidx].contiguous(), pd_s, W_s)
    sub_f = sub_b[:3] + (pd_sf, W_sf)
    tag_a = f"B={B_A}, V={Vs}"
    for a, t in ((sub_b, tag_a), (side_b, tag)):
        out = lbs.skin_fwd_cuda(*a)
        want = lbs.skin_verts_t_plain(*a)
        check(f"skin_fwd_bf16 {t}", out, want, 1e-5 * float(want.abs().max()),
              errs)
        stable("skin_fwd_bf16", lambda: lbs.skin_fwd_cuda(*a), out)
    g_a = torch.randn((B_A, 3, Vs), generator=gen).to(device)
    vp_a = lbs.v2v_pair_plain(*sub_b, *skin_side_inputs(
        smpl, B_A, gen, device, offset=10.0), want_vp=True)[2]
    for key, stored in (("skin_bwd_bf16", None), ("skin_bwd_vp_bf16", vp_a)):
        got_a = lbs.skin_bwd_cuda(*sub_b, g_a, vp=stored)
        grads_check(key, got_a, sub_b, g_a, stored, tag_a)
        stable(key, lambda: lbs.skin_bwd_cuda(*sub_b, g_a, vp=stored), got_a)

    # times: one bf16 matmul of the largest posedirs contraction as the
    # one PyTorch call ((2B x 207).(207 x 3V) for K2's two sides)
    def timed(*a, **k):
        return time_kernel(rec, *a, tc_flop=k.pop("tc"), bf16=True, **k)
    bv = B * V
    pd2b = pdb.reshape(207, 3 * V)
    pf2b = torch.cat([pf_o, pf_r]).to(bf)
    pfb = pf_o.to(bf)
    io = nbytes(pf_o, A_o, pf_r, A_r, tot_k, vsh, pdb, Wb)
    timed("v2v_grad_bf16", tag, lambda: lbs.v2v_l1_cuda(*args_b, grad=True),
          lambda: lbs.v2v_l1_plain(*args_b, grad=True),
          bv * (2 * SIDE_FLOP + L1_FLOP + GRAD_FLOP), io + nbytes(*g_k),
          library=lambda: torch.matmul(pf2b, pd2b),
          tc=bv * (BF16_TC_K2_FWD_FLOP + BF16_TC_K2_GRAD_FLOP))
    timed("v2v_fwd_bf16", tag, lambda: lbs.v2v_l1_cuda(*args_b, grad=False),
          lambda: lbs.v2v_l1_plain(*args_b, grad=False),
          bv * (2 * SIDE_FLOP + L1_FLOP), io,
          library=lambda: torch.matmul(pf2b, pd2b),
          tc=bv * BF16_TC_K2_FWD_FLOP)
    timed("v2v_pair_bf16", f"{tag}, vp stored",
          lambda: lbs.v2v_pair_cuda(*args_b, want_vp=True),
          lambda: lbs.v2v_pair_plain(*args_b, want_vp=True),
          bv * (2 * SIDE_FLOP + L1_FLOP), io + nbytes(*pair),
          library=lambda: torch.matmul(pf2b, pd2b),
          tc=bv * BF16_TC_K2_FWD_FLOP)
    g_s = pair[1]
    got = lbs.skin_bwd_cuda(*side_b, g_s)
    timed("skin_bwd_bf16", f"{tag}, sign g",
          lambda: lbs.skin_bwd_cuda(*side_b, g_s),
          lambda: lbs.skin_bwd_plain(*side_b, g_s),
          bv * (POSE_FLOP + BWD_BLEND_FLOP + GRAD_FLOP),
          nbytes(*side_b, g_s, *got),
          library=lambda: torch.matmul(pfb, pd2b), tc=bv * BF16_TC_BWD_FLOP)
    timed("skin_bwd_vp_bf16", f"{tag}, sign g",
          lambda: lbs.skin_bwd_cuda(*side_b, g_s, vp=pair[2]),
          lambda: lbs.skin_bwd_plain(*side_b, g_s, vp=pair[2]),
          bv * (BWD_BLEND_FLOP + GRAD_FLOP),
          nbytes(A_o, pdb, Wb, g_s, pair[2], *got),
          library=lambda: torch.matmul(pfb, pd2b),
          tc=bv * BF16_TC_BWD_VP_FLOP)
    pd2s = pd_s.reshape(207, 3 * Vs)
    pfab = pf_a.to(bf)
    bva = B_A * Vs
    timed("skin_fwd_bf16", tag_a, lambda: lbs.skin_fwd_cuda(*sub_b),
          lambda: lbs.skin_verts_t_plain(*sub_b), bva * SIDE_FLOP,
          nbytes(*sub_b) + 4 * B_A * 3 * Vs,
          library=lambda: torch.matmul(pfab, pd2s),
          tc=bva * BF16_TC_SIDE_FLOP)
    timed("skin_fwd_bf16", tag, lambda: lbs.skin_fwd_cuda(*side_b),
          lambda: lbs.skin_verts_t_plain(*side_b), bv * SIDE_FLOP,
          nbytes(*side_b) + 4 * B * 3 * V,
          library=lambda: torch.matmul(pfb, pd2b), tc=bv * BF16_TC_SIDE_FLOP)
    got_a = lbs.skin_bwd_cuda(*sub_b, g_a)
    timed("skin_bwd_bf16 path H subset", tag_a,
          lambda: lbs.skin_bwd_cuda(*sub_b, g_a),
          lambda: lbs.skin_bwd_plain(*sub_b, g_a),
          bva * (POSE_FLOP + BWD_BLEND_FLOP + GRAD_FLOP),
          nbytes(*sub_b, g_a, *got_a),
          library=lambda: torch.matmul(pfab, pd2s),
          tc=bva * BF16_TC_BWD_FLOP)

    # device time a launch, each bf16 kernel beside the f32 one on the same
    # inputs (separate traces: the two share a kernel name)
    vp_f = lbs.v2v_pair_cuda(*args_f, want_vp=True)[2]
    calls = {
        "v2v_grad_bf16": ("v2v_fused_kernel",
                          lambda: lbs.v2v_l1_cuda(*args_b, grad=True),
                          lambda: lbs.v2v_l1_cuda(*args_f, grad=True)),
        "v2v_fwd_bf16": ("v2v_fused_kernel",
                         lambda: lbs.v2v_l1_cuda(*args_b, grad=False),
                         lambda: lbs.v2v_l1_cuda(*args_f, grad=False)),
        "v2v_pair_bf16": ("skin_fwd_kernel",
                          lambda: lbs.v2v_pair_cuda(*args_b, want_vp=True),
                          lambda: lbs.v2v_pair_cuda(*args_f, want_vp=True)),
        "skin_fwd_bf16": ("skin_fwd_kernel",
                          lambda: lbs.skin_fwd_cuda(*sub_b),
                          lambda: lbs.skin_fwd_cuda(*sub_f)),
        "skin_bwd_bf16": ("skin_bwd_kernel",
                          lambda: lbs.skin_bwd_cuda(*side_b, g_s),
                          lambda: lbs.skin_bwd_cuda(*args_f[:5], g_s)),
        "skin_bwd_vp_bf16": ("skin_bwd_kernel",
                             lambda: lbs.skin_bwd_cuda(*side_b, g_s,
                                                       vp=pair[2]),
                             lambda: lbs.skin_bwd_cuda(*args_f[:5], g_s,
                                                       vp=vp_f)),
    }
    smi = nvidia_smi_line()
    for key, (name, fb, ff) in calls.items():
        db = profiled_ms(fb, (name,))[name]
        df = profiled_ms(ff, (name,))[name]
        rec[key]["device_ms"], rec[key]["device_ms_f32"] = db, df
        print(f"[time] {key} {rec[key]['shape']}: device time a launch "
              f"{device_ms_text(db)}, the f32 kernel's {device_ms_text(df)} "
              f"on the same inputs ({smi})")

    # the knob's error on this card: bf16 against f32 tables, same inputs
    gap = {}
    for t, a_b, a_f in ((tag, side_b, args_f[:5]), (tag_a, sub_b, sub_f)):
        vb, vf = lbs.skin_fwd_cuda(*a_b), lbs.skin_fwd_cuda(*a_f)
        gap[f"verts {t}"] = float((vb - vf).abs().max() / vf.abs().max())
    _, g_f = lbs.v2v_l1_cuda(*args_f, grad=True)
    for name, a, b in zip(("gpf", "gA", "gvsh"), g_k, g_f):
        gap[f"v2v {name} {tag}"] = float((a - b).abs().max() / b.abs().max())
    print(f"[kernel] bf16 vs f32 tables on the card, max |difference| over "
          f"the largest f32 entry: {json.dumps(gap)}")
    return {k + "_bf16": max(v for e, v in errs.items()
                             if e.startswith(k + "_bf16 "))
            for k in SKIN_KERNELS}


def io_bf16_phase(device, smpl, smpl_b, rec):
    """K3f writing bf16 vertices and K3b reading a bf16 cotangent (the
    _io_bf16 kernels, --skin_io_bf16, the JAX package's
    NEMO_TPU_SKIN_IO_BF16) with f32 and with bf16 tables, at path I's subset
    (960, 1024) and at (512, 6890). K3f's bf16 vertices must be the
    f32-mesh kernel's rounded to nearest even, bit for bit, hence within
    one bf16 step (2^-7 of the entry, plus the f32 kernel's 1e-5 of the
    largest entry near 0) of the plain version's f32 vertices; the share of
    entries whose bf16 value is not the plain version's rounded one is
    printed. K3b's gradients under a bf16 cotangent must equal the
    f32-cotangent kernel's under the widened cotangent bit for bit, and
    hold the plain version under it as the f32 rows do (1e-4 of the largest
    entry) or, with bf16 tables, as the bf16 rows do (GRAD_BF16 and
    lbs.misrounding_shares). Each reruns bit-identical. Times as the other
    K3 rows, the mesh or the cotangent at 2 bytes an entry, each kernel's
    device time a launch beside the f32-mesh kernel's on the same inputs;
    and K3f bf16's device time at (512, 6890). Returns {kernel:
    max_abs_err}."""
    import torch
    from nemo_tpu_torch.body.smpl import subset_skin_tables
    from nemo_tpu_torch.ops import lbs
    gen = torch.Generator().manual_seed(16)
    bf = torch.bfloat16
    errs = {}
    res = {f"{k} tables={t}": f(False, t == "bf16", True)
           for t in ("f32", "bf16")
           for k, f in (("skin_fwd", lbs.skin_fwd_attributes),
                        ("skin_bwd", lbs.skin_bwd_attributes))}
    print(f"[kernel] _io_bf16 instantiations' resources (cudaFuncGetAttributes"
          f"; local_bytes are spills): {json.dumps(res)}")

    def stable(key, fn, got):
        again = fn()
        again = again if isinstance(again, tuple) else (again,)
        got = got if isinstance(got, tuple) else (got,)
        if not all(torch.equal(a, b) for a, b in zip(again, got)):
            raise AssertionError(f"{key} is not bit-stable run to run")

    vsh = smpl.v_template.t().contiguous()
    cases = []
    for B, n in ((BATCH_A, 1024), (BATCH, None)):
        pf, A = skin_side_inputs(smpl, B, gen, device)
        for body, sfx in ((smpl, ""), (smpl_b, lbs.BF16)):
            if n is None:
                a = (pf, A, vsh, body.posedirs_t, body.lbs_weights_t)
            else:
                vidx, pd_s, W_s = subset_skin_tables(body, n)
                a = (pf, A, vsh[:, vidx].contiguous(), pd_s, W_s)
            cases.append((sfx, a))
    smi = nvidia_smi_line()
    for sfx, a in cases:
        B, V = a[0].shape[0], a[2].shape[1]
        tag = f"B={B}, V={V}"
        kf, kb = "skin_fwd" + sfx + "_io_bf16", "skin_bwd" + sfx + "_io_bf16"
        out = lbs.skin_fwd_cuda(*a, out_dtype=bf)
        if out.dtype != bf or not torch.equal(out, lbs.skin_fwd_cuda(*a)
                                              .to(bf)):
            raise AssertionError(f"{kf} {tag}: not the f32 kernel's "
                                 "vertices rounded to bf16")
        want = lbs.skin_verts_t_plain(*a)
        err = (out.float() - want).abs()
        step = 2.0 ** -7 * want.abs() + 1e-5 * float(want.abs().max())
        moved = float((out != want.to(bf)).float().mean())
        ok = bool((err <= step).all())
        print(f"[kernel] {kf} {tag}: max_abs_err {float(err.max()):.3e}, "
              f"each entry within one bf16 step of the plain version's f32 "
              f"vertex {'OK' if ok else 'FAIL'}; {100 * moved:.4f}% of the "
              f"entries are not the plain vertex rounded; bit for bit the "
              f"f32 kernel's rounded")
        if not ok:
            raise AssertionError(f"{kf} {tag}: off by more than a bf16 step")
        errs[kf] = max(errs.get(kf, 0.0), float(err.max()))
        stable(kf, lambda: lbs.skin_fwd_cuda(*a, out_dtype=bf), out)
        g = torch.randn((B, 3, V), generator=gen).to(device).to(bf)
        got = lbs.skin_bwd_cuda(*a, g)
        if not all(torch.equal(x, y) for x, y in
                   zip(got, lbs.skin_bwd_cuda(*a, g.float()))):
            raise AssertionError(f"{kb} {tag}: not the f32-cotangent kernel's "
                                 "gradients on the widened cotangent")
        plain = lbs.skin_bwd_plain(*a, g.float())
        rel = GRAD_BF16 if sfx else 1e-4
        for name, x, y in zip(("gpf", "gA", "gvsh"), got, plain):
            check(f"{kb} {name} {tag}", x, y, rel * float(y.abs().max()),
                  errs)
        if sfx:
            shares = lbs.misrounding_shares(got, *a, g.float())
            worst = max(shares.values())
            print(f"[kernel] {kb} {tag}: |kernel - plain| over |variant - "
                  f"plain| at most {worst:.3e} (limit "
                  f"{lbs.MISROUNDED_SHARE})")
            if worst > lbs.MISROUNDED_SHARE:
                raise AssertionError(f"{kb}: rounds at other points than "
                                     "plain")
        stable(kb, lambda: lbs.skin_bwd_cuda(*a, g), got)

        bv = B * V
        pd2 = a[3].reshape(207, 3 * V)
        pfx = a[0].to(bf) if sfx else a[0]
        gx = g.reshape(B, 3 * V) if sfx else g.float().reshape(B, 3 * V)
        kw = dict(bf16=True) if sfx else {}
        time_kernel(rec, kf, tag, lambda: lbs.skin_fwd_cuda(*a, out_dtype=bf),
                    lambda: lbs.skin_verts_t_plain(*a).to(bf),
                    bv * SIDE_FLOP, nbytes(*a, out),
                    library=lambda: torch.matmul(pfx, pd2),
                    tc_flop=bv * (BF16_TC_SIDE_FLOP if sfx else POSE_TC_FLOP),
                    **kw)
        time_kernel(rec, kb, tag, lambda: lbs.skin_bwd_cuda(*a, g),
                    lambda: lbs.skin_bwd_plain(*a, g.float()),
                    bv * (POSE_FLOP + BWD_BLEND_FLOP + GRAD_FLOP),
                    nbytes(*a, g, *got),
                    library=lambda: torch.matmul(gx, pd2.t()),
                    tc_flop=bv * (BF16_TC_BWD_FLOP if sfx
                                  else 2 * POSE_TC_FLOP), **kw)
        for key, name, fb, ff in (
                (kf, "skin_fwd_kernel",
                 lambda: lbs.skin_fwd_cuda(*a, out_dtype=bf),
                 lambda: lbs.skin_fwd_cuda(*a)),
                (kb, "skin_bwd_kernel", lambda: lbs.skin_bwd_cuda(*a, g),
                 lambda: lbs.skin_bwd_cuda(*a, g.float()))):
            db = profiled_ms(fb, (name,))[name]
            df = profiled_ms(ff, (name,))[name]
            rec[key].setdefault("device_ms", db)
            print(f"[time] {key} {tag}: device time a launch "
                  f"{device_ms_text(db)}, the f32-mesh kernel's "
                  f"{device_ms_text(df)} on the same inputs ({smi})")
    # K3f with bf16 tables and an f32 mesh at (512, 6890): its device time
    a = cases[-1][1]
    a_f = cases[-2][1]
    db = profiled_ms(lambda: lbs.skin_fwd_cuda(*a),
                     ("skin_fwd_kernel",))["skin_fwd_kernel"]
    df = profiled_ms(lambda: lbs.skin_fwd_cuda(*a_f),
                     ("skin_fwd_kernel",))["skin_fwd_kernel"]
    print(f"[time] skin_fwd_bf16 B={BATCH}, V={smpl.num_vertices}: device "
          f"time a launch {device_ms_text(db)}, the f32 tables' "
          f"{device_ms_text(df)} on the same inputs ({smi})")
    return {k: max(v for n, v in errs.items()
                   if n == k or n.startswith(k + " ")) for k in IO_KERNELS}


def posed_panels(smpl, bundle, device, views):
    """The synthetic problem's ground-truth mesh at frame 0 of each view, in
    that view's camera frame: (verts_cam (N, V, 3), focals, centers)."""
    import numpy as np
    import torch
    from nemo_tpu_torch.body.smpl import smpl_forward
    from nemo_tpu_torch.geometry.camera import camera_from_params_np
    pose = torch.as_tensor(bundle.gt3d_pose[views, 0], device=device)
    trans = torch.as_tensor(bundle.gt3d_trans[views, 0], device=device)
    with torch.no_grad():
        verts, _ = smpl_forward(smpl, torch.zeros((1, 10), device=device),
                                pose[:, 3:], pose[:, :3], pose2rot=True,
                                want_vertices=True, transl=trans)
    cams = [camera_from_params_np(bundle.gt_cameras[v], *IMG_HW)
            for v in views]
    R = torch.as_tensor(np.stack([c.rotation for c in cams]), device=device)
    t = torch.as_tensor(np.stack([c.translation for c in cams]),
                        device=device)
    verts_cam = (verts @ R.transpose(-1, -2) + t[:, None]).contiguous()
    return (verts_cam, [float(c.focal_length) for c in cams],
            [(float(c.center[0]), float(c.center[1])) for c in cams])


def raster_pairs(ent):
    """Distinct (face, tile) pairs that a fold of ``ent`` reads (the span
    scatter's duplicate entries of a face in a tile counted once)."""
    import torch
    counts = ent.counts
    tile = torch.repeat_interleave(torch.arange(counts.numel(),
                                                device=counts.device), counts)
    first = torch.repeat_interleave(ent.starts, counts)
    offset = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    face = ent.face[first + torch.arange(tile.numel(), device=tile.device)
                    - offset]
    return torch.unique(tile * (ent.N * ent.F) + face).numel()


def raster_phase(device, smpl, bundle, rec):
    """K5s and K5g against the plain fold on the card at path D's shapes:
    the posed 6890-vertex mesh at 1000 x 1900, one panel and a batch of
    four views ("body"); the same mesh 30 m further away, so a few tiles
    hold all of its entries ("crowded"); and the mesh with every face twice,
    each twin 13776 faces later in its tiles, so equal depths meet in
    different work items and the first must win ("tie", which must also
    equal "body"). Every output must be bit-identical to the plain
    version's (torch.equal on z, fid and bary), and so must a second run;
    K5g equals K5s on "body" (no overflow); on the crowded and tie cases
    gather mode drops the entries past its default capacity as its plain
    version does. The image's ragged right and bottom tiles are part of
    every comparison. Returns {kernel: max_abs_err} and adds the body's
    times to rec."""
    import torch
    from nemo_tpu_torch.ops import raster
    faces = torch.as_tensor(smpl.faces, device=device).long()
    verts_cam, focals, centers = posed_panels(smpl, bundle, device,
                                              [0, 1, 2, 3])
    far = verts_cam.clone()
    far[..., 2] += 30.0
    for name, att in raster.raster_attributes().items():
        print(f"[raster] {name} kernel: {json.dumps(att)}")
    errs = {}
    outs = {}
    for n, shape in ((4, "4 panels 1000x1900"), (1, "1 panel 1000x1900")):
        for case, v, f in (("body", verts_cam, faces), ("crowded", far, faces),
                           ("tie", verts_cam, torch.cat([faces, faces]))):
            ent = raster.prepare(v[:n], f, focals[:n], centers[:n], IMG_HW)
            if case == "body":
                for i in range(n):
                    if raster.gather_mode_overflow(
                            verts_cam[i].cpu().numpy(), smpl.faces,
                            focals[i], centers[i], IMG_HW):
                        raise AssertionError(f"panel {i}: gather mode "
                                             "overflows")
            si, gi = raster.stream_inputs(ent), raster.gather_inputs(ent)
            calls = {"raster_stream":
                     lambda: raster.raster_stream_cuda(ent, si, IMG_HW),
                     "raster_gather":
                     lambda: raster.raster_gather_cuda(ent, gi, IMG_HW)}
            got = {k: fn() for k, fn in calls.items()}
            for key, stream in (("raster_stream", True),
                                ("raster_gather", False)):
                want = raster.rasterize_plain(ent, IMG_HW, stream=stream)
                again = calls[key]()
                tag = f"{key} {case} {shape}"
                for part, a, b, c in zip(("z", "fid", "bary"), got[key],
                                         want, again):
                    if not (torch.equal(a, b) and torch.equal(a, c)):
                        raise AssertionError(f"{tag}: {part} differs from "
                                             "the plain version's or the "
                                             "rerun's")
                cov = torch.isfinite(want[0])
                check(f"{tag} z", got[key][0][cov], want[0][cov], 0.0, errs)
                check(f"{tag} bary", got[key][2], want[2], 0.0, errs)
            if case == "body" and not all(torch.equal(a, b) for a, b in zip(
                    got["raster_gather"], got["raster_stream"])):
                raise AssertionError(f"K5g differs from K5s at {shape}")
            if case == "tie" and not all(torch.equal(a, b) for a, b in zip(
                    got["raster_stream"], outs[n])):
                raise AssertionError(f"tie {shape}: a later twin won")
            outs.setdefault(n, got["raster_stream"])
            work = raster.raster_work(ent)
            print(f"[raster] {case} {shape}: bit-identical to the plain "
                  f"version and on a rerun, both modes; {work['entries']} "
                  f"entries, busiest tile {work['busiest_tile']} entries, "
                  f"{work['busy_tiles']} of {ent.counts.numel()} tiles hold "
                  f"entries, {work['items']} work items of "
                  f"{raster.CHUNK} entries, {work['subtiles_folded']} of "
                  f"{work['subtile_tests']} (entry, sub-tile) pairs folded "
                  f"after the cull; coverage "
                  f"{float(torch.isfinite(got['raster_stream'][0]).float().mean()):.4f}")
            if case != "body":
                print(f"[time] raster {case} {shape}: K5s "
                      f"{median_ms(calls['raster_stream']):.4f} ms, K5g "
                      f"{median_ms(calls['raster_gather']):.4f} ms (median "
                      "of 20 CUDA-event timings, every launch of the call "
                      f"inside; {nvidia_smi_line()})")
                continue
            pix = n * IMG_HW[0] * IMG_HW[1]
            bytes_ = work["entries"] * RASTER_ENTRY_BYTES \
                + pix * RASTER_PIXEL_BYTES
            flop = work["subtiles_folded"] * RASTER_SUBTILE_PIXELS \
                * RASTER_FLOP
            dense = raster_pairs(ent) * RASTER_TILE_PIXELS * RASTER_FLOP
            # no single PyTorch call rasterizes: library none
            for key in ("raster_stream", "raster_gather"):
                r = time_kernel(rec, key, shape, calls[key],
                                lambda: raster.rasterize_plain(
                                    ent, IMG_HW, stream=key ==
                                    "raster_stream"),
                                flop, bytes_, plain_reps=3)
                print(f"[time] {key} {shape}: bound {r['bound_ms']:.4f} "
                      f"ms ({r['bound_by']}) from the (entry, sub-tile) "
                      "pairs the kernel folds (repeated entries and the "
                      f"cull's skipped; {flop / 1e9:.3f} GFLOP: "
                      f"{1e3 * flop / PEAK_F32_FLOPS:.4f} ms at 67 "
                      f"TFLOP/s, {1e3 * flop / (PEAK_F32_FLOPS / 2):.4f} "
                      "ms at one f32 instruction an operation, no FMA) "
                      f"and {bytes_ / 1e6:.3f} MB "
                      f"({1e3 * bytes_ / PEAK_HBM_BYTES:.4f} ms); the TPU "
                      "kernel's dense work (every distinct (face, tile) "
                      f"pair at all 4096 pixels): {dense / 1e9:.3f} GFLOP, "
                      f"{1e3 * dense / PEAK_F32_FLOPS:.4f} ms, "
                      f"{1e3 * dense / (PEAK_F32_FLOPS / 2):.4f} ms an "
                      f"instruction each; kernel at "
                      f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound "
                      f"({nvidia_smi_line()})")
    return {k: max(v for name, v in errs.items() if name.startswith(k + " "))
            for k in ("raster_stream", "raster_gather")}


def chamfer_phase(device, smpl, rec):
    """K4 against its plain version on the card at path E's shapes: 60
    frames of a 512-point scan near the 6890-vertex mesh, scan -> mesh (the
    direction the loss reads) and mesh -> scan; and at path K's, 60 frames
    of a 4096-point scan -> mesh (fit-prox --rgbd --max_pts 4096) with
    both about 2 m from the origin, where a PROX scan lies. The kernel
    rounds every
    operation in the plain version's order, so distances and indices must
    be identical (tolerance 0), and a rerun must give the same bits. Prints
    the kernel's split, its registers, shared memory and spills, and each
    direction's device time a launch from torch.profiler beside the
    one-call time, an empty kernel's launch floor, the bound and the
    instruction figures (each of the 9 operations a pair issued alone, and
    the 8 instructions a pair the kernel issues).
    Returns {"chamfer_nn": max_abs_err} and adds the times to rec (the scan
    -> mesh record first)."""
    import torch
    from nemo_tpu_torch.ops import chamfer
    gen = torch.Generator().manual_seed(4)
    T, N = SEQ_LEN, SAMP_PTS
    V = smpl.num_vertices
    mesh = (smpl.v_template.cpu()[None] + 0.02 * torch.randn(
        (T, V, 3), generator=gen)).to(device).contiguous()
    pick = torch.randint(0, V, (T, N), generator=gen).to(device)
    scan = (torch.gather(mesh, 1, pick[..., None].expand(T, N, 3))
            + 0.01 * torch.randn((T, N, 3), generator=gen).to(device)
            ).contiguous()
    far = mesh + torch.tensor(PROX_OFFSET, device=device)
    pick = torch.randint(0, V, (T, PROX_PTS), generator=gen).to(device)
    scan_far = (torch.gather(far, 1, pick[..., None].expand(T, PROX_PTS, 3))
                + 0.01 * torch.randn((T, PROX_PTS, 3), generator=gen).to(
                    device)).contiguous()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print("[kernel] nn_one_way_split_kernel<4>, <2>, <1> resources "
          "(cudaFuncGetAttributes): " + json.dumps(
              [chamfer.nn_attributes(q) for q in (4, 2, 1)]))
    errs = {}
    for a, b, shape in ((scan, mesh, f"T={T}, N={N}, M={V}"),
                        (mesh, scan, f"T={T}, N={V}, M={N}"),
                        (scan_far, far, f"T={T}, N={PROX_PTS}, M={V}, "
                                        "2 m out")):
        Tk, Nk, Mk = a.shape[0], a.shape[1], b.shape[1]
        dk, ik = chamfer.nn_one_way_cuda(a, b)
        dp, ip = chamfer.nn_one_way_plain(a, b)
        n_idx = int((ik != ip).sum())
        print(f"[kernel] chamfer_nn {shape}: split "
              f"{chamfer.nn_split(Tk, Nk, Mk, sms)}; indices differing from "
              f"the plain version {n_idx} of {ik.numel()} (tolerance 0)")
        if n_idx:
            raise AssertionError("chamfer_nn: argmin differs from plain")
        check(f"chamfer_nn {shape}", dk, dp, 0.0, errs)
        dr, ir = chamfer.nn_one_way_cuda(a, b)
        if not (torch.equal(dr, dk) and torch.equal(ir, ik)):
            raise AssertionError(f"K4 is not bit-stable run to run ({shape})")
        bt = b.transpose(1, 2).contiguous()
        call = lambda: chamfer.nn_one_way_cuda(a, b)
        r = time_kernel(rec, "chamfer_nn", shape, call,
                        lambda: chamfer.nn_one_way_plain(a, b),
                        CHAMFER_FLOP * Tk * Nk * Mk, nbytes(a, b, dk, ik),
                        library=lambda: torch.bmm(a, bt), plain_reps=5)
        dev = profiled_ms(call, ("nn_one_way",))
        dev.update(profiled_ms(lambda: chamfer.nn_empty_cuda(
            Tk, Nk, Mk, device), ("chamfer_empty",)))
        ms = {k: device_ms_text(v) for k, v in dev.items()}
        pairs = Tk * Nk * Mk
        instr = {n: 1e3 * n * pairs / LANE_INSTR_PER_S
                 for n in (CHAMFER_FLOP, CHAMFER_INSTR)}
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(20):
            call()
        end.record()
        end.synchronize()
        print(f"[time] chamfer_nn {shape}: device time a launch "
              f"{ms['nn_one_way']}, 20 launches back to back "
              f"{start.elapsed_time(end) / 20:.4f} ms each (CUDA events), "
              f"one call {r['ms']:.4f} ms, launch floor "
              f"{ms['chamfer_empty']} (an empty kernel on K4's grid), "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), instruction "
              f"figure {instr[CHAMFER_FLOP]:.4f} ms (the {CHAMFER_FLOP} "
              f"operations a pair each issued alone, 132 SMs x 128 lanes at "
              f"1.98 GHz), the kernel's own {instr[CHAMFER_INSTR]:.4f} ms "
              f"(its {CHAMFER_INSTR} instructions a pair) "
              f"({nvidia_smi_line()})")
    return {"chamfer_nn": max(errs.values())}


def mlp_weights(device, gen):
    """The reference MotionNet's weights and biases at the init's scale,
    U(+-1/sqrt(fan_in)): (W1, b1, W2, b2, W3, b3, Wo, bo) on the card."""
    import torch
    D, H, O = MLP_D, MLP_H, MLP_O

    def init(*shape, fan_in):
        u = torch.rand(shape, generator=gen) * 2.0 - 1.0
        return (u / math.sqrt(fan_in)).to(device)

    return (init(D, H, fan_in=D), init(H, fan_in=D), init(H, H, fan_in=H),
            init(H, fan_in=H), init(H, H, fan_in=H), init(H, fan_in=H),
            init(H, O, fan_in=H), init(O, fan_in=H))


def bf16_product(a, b):
    """One PyTorch call computing a . b with both operands in bf16 and an
    f32 result (torch.mm with out_dtype), on bf16 copies made here."""
    import torch
    ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
    return lambda: torch.mm(ab, bb, out_dtype=torch.float32)


def mlp_phase(device, rec):
    """K6f and K6b against their plain versions on the card at the fit's
    shapes, at each of mlp.NET_PRECISIONS: "highest" (3xTF32), and the JAX
    package's other network precisions, "high" (each operand split into hi
    and lo bf16 parts, three bf16 mma.sync products a 16-deep step) and
    "bf16" (one). The reference MotionNet at B = 512 (slice 1, path F), 960
    (the custom-video full batch) and 1 (the phase-0 anchor of every
    predict), weights drawn at the init's scale (U(+-1/sqrt(fan_in))),
    inputs in [0, 1) like the RBF features, a random N(0, 1) cotangent, the
    same at every precision. Both sides of the backward read the kernel's
    saved activations, so the ReLU masks are the same. Tolerances:
    "highest" and "high" 1e-5 (forward) and 1e-4 (gradients) of each
    tensor's largest entry (sums of up to 1000 products in another order
    than the plain version's, TF32 off; at "high" the same split and exact
    bf16 products); "bf16" K6_BF16 for both. At "high" and "bf16" every
    output is also held within mlp.MISROUNDED_SHARE of the plain version's
    distance from each variant that moves a rounding point
    (mlp.misrounding_shares: at "high" the outputs of one product of the
    kernel's own operands against the f32 product, lo.lo added, lo.hi or
    hi.lo dropped; at "bf16" every output against one kind of operand left
    in f32), and each tensor's gap from the f32 kernel's on the same inputs
    is printed. A second run of each kernel must be bit-identical
    (fixed-order sums, no atomics). The bound is the tensor-core one: 3xTF32
    at 495 TFLOP/s, or bf16 at 989 with three products at "high" and one at
    "bf16". One PyTorch call: the largest contraction, in f32 (TF32 off) at
    "highest", as one bf16 product with an f32 result (bf16_product)
    otherwise; at "highest" the same products as a chain of cuBLAS calls
    are timed, and at B = 512 the kernels' distance from their CPU
    emulation (run here on the card) is printed as a record, not a gate:
    mma.sync sums in its own order. Returns {kernel: max_abs_err} and adds
    the times to rec (B = 512 first)."""
    import torch
    from nemo_tpu_torch.ops import mlp
    gen = torch.Generator().manual_seed(6)
    D, H, O = MLP_D, MLP_H, MLP_O
    W = mlp_weights(device, gen)
    inputs = {B: (torch.rand((B, D), generator=gen).to(device),
                  torch.randn((B, O), generator=gen).to(device))
              for B in (BATCH, BATCH_A, 1)}
    names = ("out", "h1", "h2", "z", "gx", "gW1", "gb1", "gW2", "gb2", "gW3",
             "gb3", "gWo", "gbo")
    errs = {}
    print(f"[kernel] TF32 in matmuls: {torch.backends.cuda.matmul.allow_tf32}")
    res = {p: {k: mlp.gemm_attributes(k == "backward pair", p)
               for k in ("forward", "backward pair")}
           for p in mlp.NET_PRECISIONS}
    print(f"[kernel] mlp_gemm_kernel resources by precision "
          f"(cudaFuncGetAttributes; local_bytes are spills): "
          f"{json.dumps(res)}")
    for B, (x, gout) in inputs.items():
        args = (x, *W)
        f32 = None
        for p in mlp.NET_PRECISIONS:
            fk, bk = mlp._key("mlp_fwd", p), mlp._key("mlp_bwd", p)
            tol_f, tol_b = (K6_BF16,) * 2 if p == "bf16" else (1e-5, 1e-4)
            got = mlp.mlp_fwd_cuda(*args, precision=p)
            want = mlp.motion_net_mlp_plain(*args, precision=p)
            for name, a, b in zip(names, got, want):
                check(f"{fk} {name} B={B}", a, b,
                      tol_f * float(b.abs().max()), errs)
            bwd_args = (gout, x, *got[1:], W[0], W[2], W[4], W[6])
            gk = mlp.mlp_bwd_cuda(*bwd_args, precision=p)
            gp = mlp.motion_net_mlp_bwd_plain(*bwd_args, precision=p)
            for name, a, b in zip(names[4:], gk, gp):
                check(f"{bk} {name} B={B}", a, b,
                      tol_b * float(b.abs().max()), errs)
            again = (mlp.mlp_fwd_cuda(*args, precision=p)
                     + mlp.mlp_bwd_cuda(*bwd_args, precision=p))
            if not all(torch.equal(a, b) for a, b in zip(again, got + gk)):
                raise AssertionError(f"K6 at {p} is not bit-stable run to "
                                     f"run (B={B})")
            if p == "highest":
                f32 = got + gk
            else:
                shares = mlp.misrounding_shares(got, gk, args, bwd_args, p)
                worst = max(shares, key=shares.get)
                ok = shares[worst] <= mlp.MISROUNDED_SHARE
                print(f"[kernel] K6 {p} B={B}: |kernel - plain| over "
                      f"|variant - plain| at most {shares[worst]:.3e} (the "
                      f"variant {worst[0]}, on {worst[1]}; {len(shares)} "
                      f"variant-output pairs; limit {mlp.MISROUNDED_SHARE}) "
                      f"{'OK' if ok else 'FAIL'}: {json.dumps({f'{v} {n}': s for (v, n), s in shares.items()})}")
                if not ok:
                    raise AssertionError(f"K6 at {p} rounds at other points "
                                         f"than its plain version")
                gap = {n: float((a - b).abs().max() / b.abs().max())
                       for n, a, b in zip(names, got + gk, f32)}
                print(f"[kernel] K6 at {p} vs the f32 kernel, B={B}, same "
                      f"inputs (largest difference / the tensor's largest "
                      f"entry): {json.dumps(gap)}")
            if p == "highest" and B == BATCH:
                em = (mlp.motion_net_mlp_split_emulation(*args),
                      mlp.motion_net_mlp_bwd_split_emulation(*bwd_args))
                diff = {name: float((a - b).abs().max() / b.abs().max())
                        for name, a, b in zip(names, got + gk,
                                              em[0] + em[1])}
                print(f"[kernel] K6 vs its 3xTF32 emulation on the card "
                      f"(B={B}; largest difference / the tensor's largest "
                      f"entry; a record, no gate): {json.dumps(diff)}")
            flop = 2 * B * (D * H + 2 * H * H + H * O)
            shape = f"B={B}, D={D}, H={H}, O={O}"
            h1, h2 = got[1], got[2]
            if p == "highest":
                # one call: the largest contraction, (B, 1000).(1000, 1000)
                # forward and (1000, B).(B, 1000) backward, f32, TF32 off
                lib_f = lambda: torch.addmm(W[3], h1, W[2])
                lib_b = lambda: torch.mm(h1.t(), h2)
            else:
                lib_f, lib_b = bf16_product(h1, W[2]), bf16_product(h1.t(), h2)
            bf16 = dict(bf16=p != "highest",
                        passes={"highest": 0, "high": 3, "bf16": 1}[p])
            r_f = time_kernel(
                rec, fk, shape, lambda: mlp.mlp_fwd_cuda(*args, precision=p),
                lambda: mlp.motion_net_mlp_plain(*args, precision=p), flop,
                nbytes(*args, *got), library=lib_f, tc_flop=flop, **bf16)
            r_b = time_kernel(
                rec, bk, shape,
                lambda: mlp.mlp_bwd_cuda(*bwd_args, precision=p),
                lambda: mlp.motion_net_mlp_bwd_plain(*bwd_args, precision=p),
                2 * flop, nbytes(*bwd_args, *gk), library=lib_b,
                tc_flop=2 * flop, **bf16)
            if p == "highest":
                z = got[3]

                def fwd_chain():   # K6f's products, one cuBLAS call each
                    for a, w, b in ((x, W[0], W[1]), (h1, W[2], W[3]),
                                    (h2, W[4], W[5]), (z, W[6], W[7])):
                        torch.addmm(b, a, w)

                def bwd_chain():   # K6b's products, one cuBLAS call each
                    # (any (B, H) tensor stands in for gz, gh2 and gh1)
                    for act, w, g in ((z, W[6], gout), (h2, W[4], z),
                                      (h1, W[2], h2), (x, W[0], h1)):
                        torch.mm(act.t(), g)
                        torch.mm(g, w.t())

                for key, r, chain in (("mlp_fwd", r_f, fwd_chain),
                                      ("mlp_bwd", r_b, bwd_chain)):
                    ms = median_ms(chain)
                    print(f"[time] {key} {shape}: cuBLAS chain {ms:.4f} ms "
                          f"(the kernel's products, one torch.addmm/mm "
                          f"each, TF32 off; median of 20) against the "
                          f"kernel's {r['ms']:.4f}")
                    rec[key].setdefault("chain_ms", ms)
    print(f"[kernel] K6f and K6b at {', '.join(mlp.NET_PRECISIONS)} "
          f"bit-identical on a second run at B = {', '.join(map(str, inputs))}")
    return {mlp._key(k, p): max(v for n, v in errs.items()
                                if n.startswith(mlp._key(k, p) + " "))
            for p in mlp.NET_PRECISIONS for k in ("mlp_fwd", "mlp_bwd")}


GN_SHAPES = ((960, 1024), (28200, 1024))


def gn_phase(device, rec):
    """K7 (GroupNorm + ReLU, ops/groupnorm.py) against the eager composition
    it replaces (models/humor.py _group_norm and a ReLU, with its autograd)
    on the card in 16 groups at GN_SHAPES: HuMoR's layer width at the
    reference fit's batch and at cvh_47x600's full batch. x = 2 N(0, 1) +
    0.5, gamma 0.5 + U(0, 1), beta 0.4 N(0, 1), a N(0, 1) cotangent.
    Tolerances: the output 1e-5, dx, dgamma and dbeta 1e-4 of each tensor's
    largest entry (a group's sums in another order, a product by 1 /
    sqrt(var + eps) in place of the division); dx is the same with and
    without dgamma and dbeta, and a rerun gives the same bits. Printed
    beside them: each output's distance from the composition in float64,
    and the library's route's (relu of torch.nn.functional.group_norm).
    Times: the kernel's forward, its backward (dx alone, as the fit runs
    it) and its backward with dgamma and dbeta, its device time a launch
    (torch.profiler), beside the eager forward, the eager forward and
    backward, the library's route (its forward, and its backward alone
    from a kept graph) and the bytes' bound. The kernel table keeps the
    first shape's times."""
    import torch
    import torch.nn.functional as F
    from nemo_tpu_torch.models.humor import _group_norm
    from nemo_tpu_torch.ops import groupnorm
    G, eps = 16, groupnorm.EPS
    errs = {}
    for R, C in GN_SHAPES:
        gen = torch.Generator(device=device).manual_seed(R)
        x = 2 * torch.randn((R, C), generator=gen, device=device) + 0.5
        gamma = 0.5 + torch.rand((C,), generator=gen, device=device)
        beta = 0.4 * torch.randn((C,), generator=gen, device=device)
        gy = torch.randn((R, C), generator=gen, device=device)

        def library(xx, g, b):
            return torch.relu(F.group_norm(xx, G, g, b, eps))

        y, mean, rstd = groupnorm.gn_relu_fwd_cuda(x, gamma, beta, G)
        dx, dg, db = groupnorm.gn_relu_bwd_cuda(x, gamma, beta, mean, rstd,
                                                gy, G, wgrad=True)
        dx_alone = groupnorm.gn_relu_bwd_cuda(x, gamma, beta, mean, rstd,
                                              gy, G)[0]

        def composed(dt, lib=False):
            """(y, dx, dgamma, dbeta) of the eager composition, or of the
            library's route, in type dt."""
            xs, gs, bs = (t.to(dt, copy=True).requires_grad_()
                          for t in (x, gamma, beta))
            out = (library(xs, gs, bs) if lib
                   else torch.relu(_group_norm(xs, gs, bs, G)))
            out.backward(gy.to(dt))
            return out.detach(), xs.grad, gs.grad, bs.grad

        mine = (y, dx, dg, db)
        for key, got, ref in zip(("humor_gn_fwd", "humor_gn_bwd",
                                  "humor_gn_bwd dgamma",
                                  "humor_gn_bwd dbeta"), mine,
                                 composed(torch.float32)):
            rel = 1e-5 if key == "humor_gn_fwd" else 1e-4
            check(key, got, ref, rel * float(ref.abs().max()), errs)
        f64 = composed(torch.float64)

        def far(outs):
            """Each output's largest distance from the float64 composition
            over its largest entry."""
            return {n: float((o.double() - r).abs().max() / r.abs().max())
                    for n, o, r in zip(("y", "dx", "dgamma", "dbeta"), outs,
                                       f64)}
        far_k7, far_lib = far(mine), far(composed(torch.float32, lib=True))
        del f64
        again = (groupnorm.gn_relu_fwd_cuda(x, gamma, beta, G)
                 + groupnorm.gn_relu_bwd_cuda(x, gamma, beta, mean, rstd, gy,
                                              G, wgrad=True))
        if not (torch.equal(dx_alone, dx) and all(
                torch.equal(a, b) for a, b in zip(again, (y, mean, rstd, dx,
                                                          dg, db)))):
            raise AssertionError(f"K7 at ({R}, {C}): a rerun, or dx without "
                                 "dgamma, differs")
        print(f"[kernel] K7 at ({R}, {C}) in {G} groups bit-identical on a "
              f"second run; dx the same with and without dgamma and dbeta; "
              f"largest distance over the largest entry from the float64 "
              f"composition: K7 {json.dumps(far_k7)}, the library's route "
              f"{json.dumps(far_lib)}")
        xr = x.clone().requires_grad_()
        y_lib = library(xr, gamma, beta)

        def eager_fwd():
            with torch.no_grad():
                torch.relu(_group_norm(x, gamma, beta, G))

        def eager_bwd():
            torch.autograd.grad(torch.relu(_group_norm(xr, gamma, beta, G)),
                                xr, gy)

        def lib_fwd():
            with torch.no_grad():
                library(x, gamma, beta)

        def lib_bwd():
            torch.autograd.grad(y_lib, xr, gy, retain_graph=True)

        def k_fwd():
            groupnorm.gn_relu_fwd_cuda(x, gamma, beta, G)

        def k_bwd():
            groupnorm.gn_relu_bwd_cuda(x, gamma, beta, mean, rstd, gy, G)
        small = 4 * (2 * C + 2 * R * G)
        time_kernel(rec, "humor_gn_fwd", [R, C, G], k_fwd, eager_fwd,
                    8 * R * C, 8 * R * C + small, library=lib_fwd)
        time_kernel(rec, "humor_gn_bwd", [R, C, G], k_bwd, eager_bwd,
                    12 * R * C, 12 * R * C + small, library=lib_bwd)
        wg_ms = median_ms(lambda: groupnorm.gn_relu_bwd_cuda(
            x, gamma, beta, mean, rstd, gy, G, wgrad=True))
        dev = profiled_ms(k_fwd, ["humor_gn_fwd"])
        dev.update(profiled_ms(k_bwd, ["humor_gn_bwd"]))
        print(f"[time] K7 at ({R}, {C}): backward with dgamma and dbeta "
              f"{wg_ms:.4f} ms; device time a launch {json.dumps(dev)} ms "
              f"(torch.profiler, 20 launches)")
        del x, gy, y, dx, dx_alone, dg, db, again, xr, y_lib
        torch.cuda.empty_cache()
    print(f"[kernel] K7 resources "
          f"{json.dumps(groupnorm.gn_relu_attributes(False, False, 1024))} "
          f"forward, {json.dumps(groupnorm.gn_relu_attributes(True, False, 1024))} "
          f"backward, {json.dumps(groupnorm.gn_relu_attributes(True, True, 1024))} "
          f"with dgamma")
    return {k: v for k, v in errs.items() if " " not in k}


# ---------------------------------------------------------------------------
# the fit's paths
# ---------------------------------------------------------------------------

def reference_config(**over):
    from nemo_tpu_torch.fit import NemoConfig
    base = dict(
        model_version=2, h_dim=1000, instance_code_size=5,
        phase_rbf_dim=100, rbf_kernel="quadratic",
        monotonic_network_n_nodes=200, phase_init="rand",
        batch_size=BATCH, loss="mse_robust",
        weight_vp_loss=10.0, weight_vp_z_loss=1.0, weight_gmm_loss=1.0,
        lr_factor=0.5, label_type="gt")
    return NemoConfig(**{**base, **over})


def custom_video_config(**over):
    """run_examples/custom-video-example.sh's fit (lr_human 1e-3 of its
    sweep) at the reference widths: NemoV3, full batch over every view and
    frame, the 3D loss against the initializer, the full-mesh v2v prior."""
    return reference_config(**{**dict(
        model_version=3, phase_init="linear", lr_human=1e-3,
        lr_instance=1e-3, lr_phase=0.0, lr_factor=1.0, weight_3d_loss=1000.0,
        full_batch=True), **over})


def make_fitter(device, smpl, bundle, cfg, v2v_vjp="fused",
                motion_mlp="plain", net_precision="highest",
                skin_io_bf16=False):
    import torch
    from nemo_tpu_torch.fit import NemoFitter, build_assets
    from nemo_tpu_torch.priors.gmm import synthetic_gmm_prior
    from nemo_tpu_torch.priors.vposer import init_vposer
    assets = build_assets(bundle, smpl, cfg, gmm=synthetic_gmm_prior(8),
                          vposer=init_vposer(
                              generator=torch.Generator().manual_seed(7)),
                          device=device, v2v_vjp=v2v_vjp,
                          motion_mlp=motion_mlp, net_precision=net_precision,
                          skin_io_bf16=skin_io_bf16)
    return NemoFitter(cfg, assets, seed=0)


def run_path(name, expected, fn):
    """Zero the launch counters, run fn, read them; the path's kernels must
    have launched. Returns (counts, fn's result)."""
    import torch
    from nemo_tpu_torch.ops import launch_counts, reset_launches
    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"[{name}] launches: {json.dumps(counts)}")
    missing = [k for k in expected if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{name}: kernels {missing} were not launched")
    return counts, out


def stages(fitter, warmup, cam, main, chunk):
    """warmup -> camera -> main; returns (metrics, steady steps/s over all
    chunks but the first, main seconds). Each chunk ends with its metrics
    on the host (a sync), so the chunk boundaries time the steps."""
    import torch
    wm = fitter.warmup(warmup)
    cm = fitter.opt_cam(cam)
    stamps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fm = fitter.fit(main, chunk=chunk,
                    on_chunk=lambda *_: stamps.append(time.perf_counter()))
    steady = (main - chunk) / (stamps[-1] - stamps[0]) if len(stamps) > 1 \
        else float("nan")
    return (wm, cm, fm), steady, stamps[-1] - t0


def main_run(metrics, fitter):
    """(main-stage total_loss curve, the fitter's batch generator state):
    two runs with equal states drew equal batches (the same seed, the same
    number of draws)."""
    import numpy as np
    return (np.asarray(metrics["total_loss"], np.float64),
            fitter.generator.get_state().clone())


def check_finite(name, metrics, *evals):
    import numpy as np
    arrays = [a for m in metrics for a in m.values()]
    if not all(np.isfinite(a).all() for a in arrays) or not all(
            math.isfinite(v) for e in evals for v in e.values()):
        raise AssertionError(f"{name}: non-finite loss")


def check_falls(name, kp, n):
    print(f"[{name}] kp_loss {kp[0]:.2f} -> {kp[-1]:.2f}")
    if not kp[-n:].mean() < kp[:n].mean():
        raise AssertionError(f"{name}: main-stage kp_loss did not fall")


def card_vs_cpu(name, fitter, bundle, smpl, batch=None):
    """fit_loss on the card against the port's CPU path (plain versions of
    the kernels, in the same v2v and MotionNet modes, with the same HuMoR
    weights) from the same parameters, on one batch of 64, or on ``batch``
    (view and frame indices on the host)."""
    import torch
    from nemo_tpu_torch.fit import NemoParams, build_assets, fit_loss
    cfg, assets = fitter.cfg, fitter.assets
    V, F = assets.num_views, assets.num_frames
    g = torch.Generator().manual_seed(3)
    vi, fi = batch if batch is not None else (
        torch.randint(0, V, (64,), generator=g),
        torch.randint(0, F, (64,), generator=g))
    with torch.no_grad():
        _, m_gpu = fit_loss(fitter.params, cfg, assets, vi.to(assets.device),
                            fi.to(assets.device))
        cpu_assets = build_assets(bundle, smpl.to("cpu"), cfg,
                                  gmm=assets.gmm.to("cpu"),
                                  vposer={k: v.cpu()
                                          for k, v in assets.vposer.items()},
                                  device="cpu", v2v_vjp=assets.v2v_vjp,
                                  motion_mlp=assets.motion_mlp,
                                  net_precision=assets.net_precision,
                                  skin_io_bf16=assets.skin_io_dtype
                                  == torch.bfloat16,
                                  humor=assets.humor,
                                  humor_cfg=assets.humor_cfg)
        params_cpu = NemoParams(cfg, V, assets.img_d0)
        params_cpu.load_state_dict({k: v.cpu() for k, v in
                                    fitter.params.state_dict().items()})
        _, m_cpu = fit_loss(params_cpu, cfg, cpu_assets, vi, fi)
    for k in m_cpu:
        a, b = float(m_gpu[k]), float(m_cpu[k])
        print(f"[{name}] fit_loss {k}: cuda {a:.6f} cpu {b:.6f}")
        if not abs(a - b) <= 1e-4 * abs(b) + 1e-6:
            raise AssertionError(f"{name} fit_loss {k}: card and CPU disagree")


def no_sync_steps(name, fitter):
    """One step of each stage with every synchronising call an error."""
    import torch
    from nemo_tpu_torch.fit.optimizer import (make_camera_stage_optimizer,
                                              make_v0_warmup_optimizer)
    cfg = fitter.cfg
    cam_opt = None if cfg.model_version >= 4 else \
        make_camera_stage_optimizer(fitter.params, cfg)
    warm_opt = make_v0_warmup_optimizer(fitter.params, cfg) \
        if cfg.model_version == 0 else None
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fitter.warmup_step(0, warm_opt)
        fitter.camera_step(cam_opt)
        fitter.main_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"[{name}] a step of each stage ran without a device "
          "synchronisation")


def slice1_path(device, smpl, bundle):
    """The reference configuration through K1 and K2's fused mode. Returns
    (counts, steps/s, main_run of its main stage)."""
    import numpy as np
    import torch
    from nemo_tpu_torch.eval.metrics import eval_2d, eval_3d, write_csv
    from nemo_tpu_torch.fit import predict, project_to_views
    main = 30
    paired = []
    fitter = make_fitter(device, smpl, bundle, reference_config())

    def run():
        init = fitter.eval_loss()
        ms, steady, main_s = stages(fitter, 10, 10, main, 10)
        paired.append(main_run(ms[2], fitter))
        final = fitter.eval_loss()
        V, F = fitter.assets.num_views, fitter.assets.num_frames
        vi = torch.arange(V, device=device).repeat_interleave(F)
        fi = torch.arange(F, device=device).repeat(V)
        with torch.no_grad():
            preds = predict(fitter.params, fitter.cfg, fitter.assets, vi, fi)
            pts2d = project_to_views(fitter.params, fitter.cfg, fitter.assets,
                                     preds["j"], vi)
        pts2d = pts2d.cpu().numpy().reshape(V, F, 25, 2)
        with tempfile.TemporaryDirectory() as d:
            write_csv(eval_2d(pts2d, {"op": bundle.labels["op"]},
                              bundle.labels["gt"], bundle.bbox_diag("gt")),
                      os.path.join(d, "eval_2d.csv"))
            stats3d = eval_3d(fitter.assets.smpl, preds["poses"].cpu().numpy()
                              .reshape(V, F, 69), bundle.gt3d_pose,
                              {"vibe": bundle.hmr_theta})
            write_csv(stats3d, os.path.join(d, "eval_3d.csv"))
            with open(os.path.join(d, "eval_2d.csv")) as f:
                header = f.readline().strip()
        return init, ms, steady, main_s, final, stats3d, header

    counts, (init, ms, steady, main_s, final, stats3d, header) = run_path(
        "slice 1", ("fk_fwd", "fk_bwd", "v2v_grad", "v2v_fwd"), run)
    print(f"[slice 1] main stage: {main} steps in {main_s:.3f} s; the last "
          f"{main - 10} at {steady:.3f} steps/s (batch {BATCH}, 8 views x "
          f"120 frames, V={smpl.num_vertices})")
    print(f"[slice 1] init {init}\n[slice 1] final {final}")
    check_finite("slice 1", ms, init, final)
    check_falls("slice 1", ms[2]["kp_loss"], 10)
    V = fitter.assets.num_views
    for name, v in stats3d.items():
        if not np.isfinite(v).all() or len(v) != V:
            raise AssertionError(f"eval_3d column {name} malformed")
    if header != ",recon_error_2d-ours,pck-ours,recon_error_2d-op,pck-op":
        raise AssertionError(f"eval_2d header {header!r}")
    no_sync_steps("slice 1", fitter)
    card_vs_cpu("slice 1", fitter, bundle, smpl)
    return counts, steady, paired[0]


def path_a(device, smpl, bundle):
    """The custom-video configuration with the opt-in 1024-vertex v2v
    subset, which runs K3 in place of K2."""
    cfg = custom_video_config(vp_v2v_n_verts=1024)
    fitter = make_fitter(device, smpl, bundle, cfg)
    print(f"[path A] {cfg}")
    main = 40

    def run():
        ms, steady, main_s = stages(fitter, 10, 10, main, 10)
        return ms, steady, main_s, fitter.eval_loss()

    counts, (ms, steady, main_s, final) = run_path(
        "path A", ("fk_fwd", "fk_bwd", "skin_fwd", "skin_bwd"), run)
    B = fitter.assets.num_views * fitter.assets.num_frames
    print(f"[path A] main stage: {main} steps in {main_s:.3f} s; the last "
          f"{main - 10} at {steady:.3f} steps/s (full batch B={B}, v2v on "
          f"{len(fitter.assets.v2v_vidx)} vertices; {nvidia_smi_line()})")
    print(f"[path A] final {final}")
    check_finite("path A", ms, final)
    check_falls("path A", ms[2]["kp_loss"], 10)
    card_vs_cpu("path A", fitter, bundle, smpl)
    no_sync_steps("path A", fitter)
    return counts, steady


def path_b(device, smpl, bundle):
    """Slice 1's workload with the K2 pair modes: 10 main steps each, from
    the same fresh parameters. The modes share K2's pair-mode forward;
    their gradients agree, by design not bit for bit: pair has K3b
    recompute the posed vertices in 3xTF32, pair_vp reads the f32 ones K2
    stored. So fit_loss and every parameter gradient of the two modes are
    held together from the same parameters and batch (the loss within
    1e-5 relative, gradients within 1e-5 of each tensor's largest entry,
    as the kernel phase holds K3b's), and not the two 10-step curves,
    which Adam parts from the first step wherever a gradient entry is
    near 0."""
    out = {}
    for vjp, bwd in (("pair", "skin_bwd"), ("pair_vp", "skin_bwd_vp")):
        fitter = make_fitter(device, smpl, bundle, reference_config(),
                             v2v_vjp=vjp)
        if vjp == "pair":
            modes_agree("path B", fitter, "v2v_vjp", ("pair", "pair_vp"),
                        1e-5, 1e-5)
        counts, fm = run_path(f"path B {vjp}", ("v2v_pair", bwd),
                              lambda: fitter.fit(10, chunk=10))
        if counts["v2v_grad"]:
            raise AssertionError(f"path B {vjp}: the fused mode ran")
        check_finite(f"path B {vjp}", [fm])
        print(f"[path B {vjp}] total_loss {fm['total_loss'][0]:.3f} -> "
              f"{fm['total_loss'][-1]:.3f}")
        out[vjp] = counts
    return out


def path_h(device, smpl_b, bundle, steady1):
    """Slice 1's reference configuration with bf16 skinning tables
    (skin_dtype=torch.bfloat16, the JAX package's --skin_bf16 and
    bench.py's default) at full width: 10 warmup and 10 camera steps, card
    vs CPU (the CPU on the plain bf16 versions) at the parameters of the
    first main step, 30 main steps, eval_loss; K2's bf16 kernels and no f32
    skinning kernel; no sync; steps/s beside slice 1's (this process). Then
    the custom-video configuration with the 1024-vertex subset (K3f/K3b
    bf16, 5 + 5 + 20 steps, card vs CPU), and fused against pair against
    pair_vp in bf16 from the same parameters and batch (modes_agree: the
    loss within 1e-5 relative, gradients within GRAD_BF16 of each tensor's
    largest entry, for the bf16 roundings of g . vp that flip where the
    modes' vp differ in their last f32 bit). Returns ({run: counts},
    steps/s, main_run of its main stage)."""
    import torch
    if smpl_b.posedirs_t.dtype != torch.bfloat16:
        raise AssertionError("path H needs bf16 tables")
    out = {}

    def no_f32_skinning(name, counts):
        ran = [k for k in SKIN_KERNELS if counts[k]]
        if ran:
            raise AssertionError(f"{name}: f32 skinning kernels {ran} ran")

    fitter = make_fitter(device, smpl_b, bundle, reference_config())
    main = 30

    def run():
        fitter.warmup(10)
        fitter.opt_cam(10)
        card_vs_cpu("path H", fitter, bundle, smpl_b)
        stamps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fm = fitter.fit(main, chunk=10,
                        on_chunk=lambda *_: stamps.append(time.perf_counter()))
        steady = (main - 10) / (stamps[-1] - stamps[0])
        paired.append(main_run(fm, fitter))
        return fm, steady, stamps[-1] - t0, fitter.eval_loss()

    paired = []
    counts, (fm, steady, main_s, final) = run_path(
        "path H", ("fk_fwd", "fk_bwd", "v2v_grad_bf16", "v2v_fwd_bf16"), run)
    no_f32_skinning("path H", counts)
    out["path H"] = counts
    print(f"[path H] main stage: {main} steps in {main_s:.3f} s; the last "
          f"{main - 10} at {steady:.3f} steps/s with bf16 tables, slice 1 "
          f"(f32 tables, this process) {steady1:.3f} (batch {BATCH}, 8 "
          f"views x 120 frames, V={smpl_b.num_vertices}; {nvidia_smi_line()})")
    print(f"[path H] final {final}")
    check_finite("path H", [fm], final)
    check_falls("path H", fm["kp_loss"], 10)
    no_sync_steps("path H", fitter)

    def modes():
        modes_agree("path H", fitter, "v2v_vjp", ("fused", "pair"), 1e-5,
                    GRAD_BF16)
        modes_agree("path H", fitter, "v2v_vjp", ("pair", "pair_vp"), 1e-5,
                    GRAD_BF16)
    counts, _ = run_path("path H modes", ("v2v_grad_bf16", "v2v_pair_bf16",
                                          "skin_bwd_bf16",
                                          "skin_bwd_vp_bf16"), modes)
    no_f32_skinning("path H modes", counts)
    out["path H modes"] = counts

    cfg = custom_video_config(vp_v2v_n_verts=1024)
    fitter_a = make_fitter(device, smpl_b, bundle, cfg)
    if fitter_a.assets.v2v_posedirs_t.dtype != torch.bfloat16:
        raise AssertionError("path H subset: the subset tables are not bf16")

    def run_a():
        ms, steady_a, _ = stages(fitter_a, 5, 5, 20, 10)
        return ms, steady_a

    counts, (ms, steady_a) = run_path(
        "path H subset", ("fk_fwd", "fk_bwd", "skin_fwd_bf16",
                          "skin_bwd_bf16"), run_a)
    no_f32_skinning("path H subset", counts)
    out["path H subset"] = counts
    print(f"[path H subset] main stage at {steady_a:.3f} steps/s (B="
          f"{BATCH_A}, v2v on {len(fitter_a.assets.v2v_vidx)} vertices, bf16)")
    check_finite("path H subset", ms)
    card_vs_cpu("path H subset", fitter_a, bundle, smpl_b)
    return out, steady, paired[0]


# The house trajectory gate (docs/precision_knobs.md, tests/test_fit.py:466),
# set before path I first ran: two fits from the same seed, hence the same
# parameters and batches, with the median per-step relative |delta
# total_loss| of their main stages below 5%
PAIRED_MEDIAN_BOUND = 0.05


def path_i(device, smpl, smpl_b, bundle, steady1, steady_h, run1, run_h):
    """The reference configuration at the JAX bench's precision (bench.py
    :82-86: NEMO_TPU_SKIN_BF16=1 and NEMO_TPU_NET_PRECISION=high; here bf16
    tables and net_precision="high") at full width, through the fit's
    entry points:
    1. the plain MotionNet (every network product in bf16x3): 10 warmup and
       10 camera steps, card vs CPU at the first main step's parameters, 30
       main steps, eval_loss, no sync, steps/s beside slice 1's and path
       H's (this process); K2's bf16 kernels, no f32 skinning kernel, no K6;
    2. the same with motion_mlp="fused": K6 at "high" (mlp_fwd_high,
       mlp_bwd_high) and no other K6 instantiation; card vs CPU, and fused
       vs plain from the same parameters and batch (modes_agree: the loss
       within 1e-5 relative, gradients 1e-4, as path F: the same function;
       the samples where a pre-activation's rounding puts a ReLU gate on
       different sides in the two modes are left out and counted);
    3. five main steps from the init at "bf16" on each MLP mode (the fused
       one through K6's bf16 instantiation only), beside the same five at
       "highest";
    4. the custom-video configuration with the 1024-vertex v2v subset and
       bf16 meshes (skin_io_bf16), with bf16 tables at "high" and with f32
       tables: 5 + 5 + 10 steps each through the _io_bf16 kernels and no
       f32-mesh K3, card vs CPU;
    5. the paired trajectory (ROADMAP Queue 3 gap 2): slice 1 (all f32,
       "highest"), path H (bf16 tables alone) and run 1 (bf16 tables +
       "high") drew the same batches (equal generator states after their
       30 main steps); the median per-step relative |delta total_loss| of
       path H and of run 1 against slice 1 must each be below
       PAIRED_MEDIAN_BOUND.
    Returns ({run: counts}, run 1's steps/s)."""
    import numpy as np
    import torch
    out = {}
    forbid_skin = set(SKIN_KERNELS) | set(IO_KERNELS)
    mlp_keys = {"mlp_fwd", "mlp_bwd", *(f"mlp_{d}_{p}" for d in ("fwd", "bwd")
                                        for p in NET_PRECISIONS)}

    def only(name, counts, allowed, forbidden):
        ran = [k for k in forbidden - set(allowed) if counts[k]]
        if ran:
            raise AssertionError(f"{name}: kernels {ran} ran")

    steady = {}
    for mode in ("plain", "fused"):
        name = f"path I {mode}"
        fitter = make_fitter(device, smpl_b, bundle, reference_config(),
                             motion_mlp=mode, net_precision="high")
        main = 30
        paired = []

        def run():
            fitter.warmup(10)
            fitter.opt_cam(10)
            card_vs_cpu(name, fitter, bundle, smpl_b)
            stamps = []
            torch.cuda.synchronize()
            fm = fitter.fit(main, chunk=10, on_chunk=lambda *_: stamps.append(
                time.perf_counter()))
            paired.append(main_run(fm, fitter))
            return fm, (main - 10) / (stamps[-1] - stamps[0]), \
                fitter.eval_loss()

        k6 = ("mlp_fwd_high", "mlp_bwd_high") if mode == "fused" else ()
        counts, (fm, steady[mode], final) = run_path(
            name, ("fk_fwd", "fk_bwd", "v2v_grad_bf16", "v2v_fwd_bf16", *k6),
            run)
        only(name, counts, k6, forbid_skin | mlp_keys)
        out[name] = counts
        print(f"[{name}] main stage: the last {main - 10} of {main} steps at "
              f"{steady[mode]:.3f} steps/s at the JAX bench's precision (bf16 "
              f"tables, net_precision high, MotionNet {mode}); slice 1 (f32) "
              f"{steady1:.3f}, path H (bf16 tables) {steady_h:.3f}, this "
              f"process ({nvidia_smi_line()})")
        print(f"[{name}] final {final}")
        check_finite(name, [fm], final)
        check_falls(name, fm["kp_loss"], 10)
        no_sync_steps(name, fitter)
        if mode == "plain":
            run_i = paired[0]
        else:
            modes_agree(name, fitter, "motion_mlp", ("plain", "fused"), 1e-5,
                        1e-4)

    for mode, prec in (("plain", "highest"), ("plain", "bf16"),
                       ("fused", "bf16")):
        name = f"path I {prec} {mode}"
        fitter = make_fitter(device, smpl_b, bundle, reference_config(),
                             motion_mlp=mode, net_precision=prec)
        k6 = ("mlp_fwd_bf16", "mlp_bwd_bf16") if mode == "fused" else ()
        counts, fm = run_path(name, ("fk_fwd", "fk_bwd", "v2v_grad_bf16",
                                     *k6), lambda: fitter.fit(5, chunk=5))
        only(name, counts, k6, forbid_skin | mlp_keys)
        check_finite(name, [fm])
        out[name] = counts
        print(f"[{name}] total_loss {fm['total_loss'][0]:.3f} -> "
              f"{fm['total_loss'][-1]:.3f} (5 main steps from the init, "
              f"network products at {prec})")

    for body, sfx, prec in ((smpl_b, "_bf16", "high"), (smpl, "", "highest")):
        name = f"path I subset io_bf16 tables{sfx or '_f32'}"
        cfg = custom_video_config(vp_v2v_n_verts=1024)
        fitter = make_fitter(device, body, bundle, cfg, net_precision=prec,
                             skin_io_bf16=True)
        io = ("skin_fwd" + sfx + "_io_bf16", "skin_bwd" + sfx + "_io_bf16")

        def run_a():
            ms, steady_a, _ = stages(fitter, 5, 5, 10, 5)
            return ms, steady_a

        counts, (ms, steady_a) = run_path(name, ("fk_fwd", "fk_bwd", *io),
                                          run_a)
        only(name, counts, io, forbid_skin)
        out[name] = counts
        print(f"[{name}] main stage at {steady_a:.3f} steps/s (B={BATCH_A}, "
              f"v2v on {len(fitter.assets.v2v_vidx)} vertices, bf16 meshes, "
              f"net_precision {prec})")
        check_finite(name, ms)
        card_vs_cpu(name, fitter, bundle, body)

    base, state = run1
    for label, (curve, st) in (("bf16 tables alone (path H)", run_h),
                               ("bf16 tables + high (path I)", run_i)):
        if not torch.equal(st, state):
            raise AssertionError(f"path I paired: {label} drew other batches "
                                 "than slice 1")
        rel = np.abs(curve - base) / np.abs(base)
        med = float(np.median(rel))
        ok = med < PAIRED_MEDIAN_BOUND
        print(f"[path I paired] {label} against slice 1 (f32, highest), the "
              f"same seed and batches, {len(rel)} main steps: median per-step "
              f"relative |delta total_loss| {med:.3e} (max {rel.max():.3e}; "
              f"bound {PAIRED_MEDIAN_BOUND}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"path I paired: {label} parts from f32")
    return out, steady["plain"]


def path_c(device, smpl, bundle):
    """Model versions 0, 1 and 4 at the reference width: 5 steps of each
    stage."""
    out = {}
    for v, over in ((0, dict(phase_rbf_dim=0)), (1, dict(phase_rbf_dim=0)),
                    (4, dict(weight_3d_loss=1.0, weight_instance_loss=0.1,
                             code_noise=0.01))):
        fitter = make_fitter(device, smpl, bundle,
                             reference_config(model_version=v, **over))

        def run():
            ms, _, _ = stages(fitter, 5, 5, 5, 5)
            return ms

        counts, ms = run_path(f"path C v{v}", ("fk_fwd", "fk_bwd",
                                                 "v2v_grad"), run)
        check_finite(f"path C v{v}", ms)
        print(f"[path C v{v}] " + "; ".join(
            f"{k} {a[0]:.3f} -> {a[-1]:.3f}" for m in ms
            for k, a in m.items() if k in ("warmup_loss", "cam_loss",
                                           "total_loss")))
        if v == 4:
            no_sync_steps("path C v4", fitter)
        out[f"v{v}"] = counts
    return out


def path_d(device, smpl, bundle):
    """The fit's render outputs and a checkpoint round trip: the reference
    configuration, a few steps of each stage; save_fit_state and
    load_fit_state into a fresh fitter (parameters bit-identical, eval_loss
    equal); the full mesh per view; the mesh video (4 views, every 4th of
    120 frames: 30 frames, 120 panels), the rollout figure (8 views x 8
    frames) and the comparison strip (6 panels) on K5s at 1000 x 1900; then
    K5g on the video's panels, which gather mode holds without overflow,
    equal to K5s."""
    import numpy as np
    import torch
    from nemo_tpu_torch.fit import predict
    from nemo_tpu_torch.geometry.camera import camera_from_params_np
    from nemo_tpu_torch.ops import raster
    from nemo_tpu_torch.render import (make_mesh_panel_fn,
                                       render_comparison_figure,
                                       render_mesh_video,
                                       render_rollout_figure)
    from nemo_tpu_torch.render.mesh import composite_panel
    from nemo_tpu_torch.utils.checkpoint import load_fit_state, save_fit_state
    cfg = reference_config()
    fitter = make_fitter(device, smpl, bundle, cfg)
    V, F = fitter.assets.num_views, fitter.assets.num_frames
    n_frames = len(range(0, F, 4))
    faces = smpl.faces
    out = {}

    def run():
        ms, _, _ = stages(fitter, 5, 5, 10, 5)
        check_finite("path D", ms)
        with tempfile.TemporaryDirectory() as d:
            save_fit_state(d, fitter, cfg)
            fresh = make_fitter(device, smpl, bundle, cfg)
            if not load_fit_state(d, fresh):
                raise AssertionError("path D: generator state not restored")
        same = all(torch.equal(a, b) for a, b in
                   zip(fitter.params.parameters(), fresh.params.parameters()))
        e0, e1 = fitter.eval_loss(), fresh.eval_loss()
        print(f"[path D] checkpoint round trip: parameters bit-identical "
              f"{same}, eval_loss equal {e0 == e1} ({e0})")
        if not same or e0 != e1 or fresh.step != fitter.step:
            raise AssertionError("path D: the checkpoint did not restore "
                                 "the fit")
        with torch.no_grad():
            verts = np.stack([predict(
                fitter.params, cfg, fitter.assets,
                torch.full((F,), v, device=device),
                torch.arange(F, device=device),
                want_vertices=True)["v"].cpu().numpy() for v in range(V)])
        cam9 = fitter.params.cameras.detach().cpu().numpy()
        cams = [camera_from_params_np(cam9[v], *IMG_HW) for v in range(V)]
        with tempfile.TemporaryDirectory() as d:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vid = render_mesh_video(os.path.join(d, "mesh_rollout.mp4"),
                                    verts, faces, cams, bundle, max_views=4,
                                    every=4, device=device)
            t_video = time.perf_counter() - t0
            frames = sorted(os.listdir(vid)) if os.path.isdir(vid) else None
            # the same frames without the PNG writes: render, one copy to
            # the host, composite
            fn = make_mesh_panel_fn(faces, cams[:4], IMG_HW, device=device)
            R = np.stack([c.rotation for c in cams[:4]])
            t = np.stack([c.translation for c in cams[:4]])
            split = {"render": 0.0, "copy": 0.0, "composite": 0.0}
            for f in range(0, F, 4):
                t0 = time.perf_counter()
                imgs, masks = fn(verts[:4, f], R, t)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                both = torch.cat([imgs, masks[..., None]], -1).cpu().numpy()
                t2 = time.perf_counter()
                np.concatenate([composite_panel(b[..., :3], b[..., 3], None,
                                                IMG_HW) for b in both], 1)
                t3 = time.perf_counter()
                for k, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
                    split[k] += dt / n_frames
            t_nopng = n_frames * sum(split.values())
            t0 = time.perf_counter()
            grid = render_rollout_figure(
                os.path.join(d, "rollout_figure.png"), verts, faces, cams,
                bundle, num_frames=8, device=device)
            t_fig = time.perf_counter() - t0
            comp = render_comparison_figure(
                os.path.join(d, "comparison_view0.png"), 0, verts[0], faces,
                cams[0], bundle, num_frames=6, device=device)
            sizes = {n: os.path.getsize(os.path.join(d, n)) for n in
                     ("rollout_figure.png", "comparison_view0.png")}
        print(f"[path D] {vid}: {len(frames) if frames else 'mp4'} frames "
              f"of {4 * IMG_HW[1]}x{IMG_HW[0]}; {t_video / n_frames:.4f} s a "
              f"frame with the PNG writes, {t_nopng / n_frames:.4f} s "
              f"without; rollout "
              f"figure {grid.shape} in {t_fig:.2f} s, comparison "
              f"{comp.shape}; PNG bytes {json.dumps(sizes)}; s a frame "
              f"without the PNG writes: {json.dumps(split)}")
        if frames is not None and len(frames) != n_frames:
            raise AssertionError(f"path D: {len(frames)} video frames")
        if grid.shape != (1052, 2000, 3) or comp.shape[0] != 2 * IMG_HW[0] \
                * 2000 // (6 * IMG_HW[1]):
            raise AssertionError("path D: figure grids malformed")
        covered = float((grid < 0.99).any(-1).mean())
        if not np.isfinite(grid).all() or covered < 0.001:
            raise AssertionError(f"path D: rollout figure covers "
                                 f"{covered:.5f} of its pixels")
        # K5g on the video's panels, equal to K5s
        Rt = torch.as_tensor(R, device=device)
        tt = torch.as_tensor(t, device=device)
        foc = [float(c.focal_length) for c in cams[:4]]
        ctr = [(float(c.center[0]), float(c.center[1])) for c in cams[:4]]
        # JAX's default capacity, doubled for a frame whose busiest tile
        # holds more entries, so that no panel overflows
        grown = {}
        for f in range(0, F, 4):
            vc = (torch.as_tensor(verts[:4, f], device=device)
                  @ Rt.transpose(-1, -2) + tt[:, None]).contiguous()
            fpt = 4096
            while any(raster.gather_mode_overflow(
                    vc[v].cpu().numpy(), faces, foc[v], ctr[v], IMG_HW,
                    faces_per_tile=fpt) for v in range(4)):
                fpt *= 2
            if fpt > 4096:
                grown[f] = fpt
            a = raster.rasterize_triangles_batched(vc, faces, foc, ctr,
                                                   IMG_HW, stream=True)
            b = raster.rasterize_triangles_batched(
                vc, faces, foc, ctr, IMG_HW, faces_per_tile=fpt,
                stream=False)
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"path D frame {f}: K5g differs from "
                                     "K5s")
        print(f"[path D] K5g equals K5s on the video's {4 * n_frames} "
              "panels, each with a gather-mode overflow of 0 at "
              f"faces_per_tile 4096 except frames {json.dumps(grown)} "
              "(frame: the capacity that holds its busiest tile)")
        out.update(video_s=t_video / n_frames, nopng_s=t_nopng / n_frames)

    counts, _ = run_path("path D", ("fk_fwd", "fk_bwd", "v2v_grad",
                                    "raster_stream", "raster_gather"), run)
    return counts, out


def raw_amass_walk(path, T=360, seed=0):
    """A synthetic raw AMASS sequence (the JAX CLI test's swaying walk,
    tests/test_humor_tool_cli.py) over T frames at 120 fps, its phases and
    betas from ``seed``: process-amass keeps the middle 80%, drops the two
    edge frames and downsamples to 30 fps, so 360 frames leave 71 (300
    would leave 59, short of seq_len 60)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, T)[:, None]
    poses = np.zeros((T, 156))
    poses[:, :3] = 0.2 * np.stack(
        [np.sin(t[:, 0]), np.cos(t[:, 0]), 0 * t[:, 0]], 1)
    poses[:, 3:66] = 0.15 * np.sin(t + rng.uniform(0, np.pi, (1, 63)))
    trans = np.stack([0.3 * t[:, 0], 0.1 * np.sin(t[:, 0]), np.zeros(T)], 1)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, poses=poses, trans=trans,
             betas=rng.standard_normal(16) * 0.3, gender="neutral",
             mocap_framerate=120.0)


def path_e(device, files):
    """HuMoR 3D fitting through the port's humor_tool: process-amass on a
    synthetic raw sequence, then fit-amass --obs joints verts points at the
    CLI's defaults (60 frames, 512 scan points) but stage 3's steps, cut to
    E_STEPS (30/70/10; the stage still runs the rollout and K4 each step),
    on the card (the CLI's default device), and the eval CSVs. The SMPL model
    comes from the written .npz of the 6890-vertex synthetic body and the
    HuMoR weights (the reference widths, latent 48) from the written
    checkpoint of init_humor at --seed 0: the model and weights the CLI
    builds without the two flags. K4 runs in
    every step (scan -> mesh alone, the direction the points3d loss reads),
    K1 in every SMPL forward and backward.
    Then points3d_loss and the stage-3 loss on the card against the port's
    CPU path from the same parameters (the fit's result)."""
    import numpy as np
    import torch
    from nemo_tpu_torch.cli import humor_tool
    from nemo_tpu_torch.models import humor_fit
    from nemo_tpu_torch.models.humor import HumorConfig, humor_to
    fits, stage_s = [], []
    real_fit, real_adam = humor_fit.humor_motion_fit, humor_fit._run_adam

    def recording_fit(*a, **k):         # the CLI's fit, with its outputs kept
        out = real_fit(*a, **k)
        fits.append((a, k, out))
        return out

    def timed_stage(*a, **k):           # each stage's Adam loop, timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_adam(*a, **k)
        torch.cuda.synchronize()
        stage_s.append(time.perf_counter() - t0)
        return out

    with tempfile.TemporaryDirectory() as d:
        raw_amass_walk(os.path.join(d, "raw", "HumanEva", "S1",
                                    "walk_poses.npz"))
        proc, out = os.path.join(d, "proc"), os.path.join(d, "fit")

        def run():
            humor_fit.humor_motion_fit = recording_fit
            humor_fit._run_adam = timed_stage
            try:
                t0 = time.perf_counter()
                if humor_tool.main(["process-amass", "--amass_root",
                                    os.path.join(d, "raw"), "--out", proc,
                                    "--datasets", "HumanEva", "--smpl_path",
                                    files["smpl_npz"]]) != 0:
                    raise AssertionError("path E: process-amass failed")
                t1 = time.perf_counter()
                if humor_tool.main(["fit-amass", "--amass", proc, "--out",
                                    out, "--obs", "joints", "verts",
                                    "points", "--steps", *E_STEPS,
                                    "--smpl_path",
                                    files["smpl_npz"], "--humor_ckpt",
                                    files["humor"]]) != 0:
                    raise AssertionError("path E: fit-amass failed")
                return t1 - t0, time.perf_counter() - t1
            finally:
                humor_fit.humor_motion_fit = real_fit
                humor_fit._run_adam = real_adam

        counts, (t_proc, t_fit) = run_path(
            "path E", ("chamfer_nn", "fk_fwd", "fk_bwd"), run)
        (args, kw, fit), = fits
        losses = {s: fit[f"stage{s}_loss"].cpu().numpy() for s in (1, 2, 3)}
        print(f"[path E] process-amass {t_proc:.2f} s, fit-amass "
              f"{t_fit:.2f} s; " + "; ".join(
                  f"stage {s}: {len(v)} steps in {t:.2f} s "
                  f"({len(v) / t:.2f} steps/s), loss {v[0]:.4f} -> "
                  f"{v[-1]:.4f}" for (s, v), t in zip(losses.items(),
                                                     stage_s)))
        if not all(np.isfinite(v).all() for v in losses.values()):
            raise AssertionError("path E: non-finite stage loss")
        if not losses[2][-1] < losses[2][0]:
            raise AssertionError("path E: stage-2 loss did not fall")
        res = os.path.join(out, "results_out")
        seq_dir = os.path.join(res, os.listdir(res)[0])
        with np.load(os.path.join(seq_dir, "observations.npz")) as f:
            if f["points3d"].shape != (SEQ_LEN, SAMP_PTS, 3):
                raise AssertionError("path E: scan shape")
        csvs = sorted(os.listdir(os.path.join(out, "eval_out")))
        print(f"[path E] {seq_dir}: {sorted(os.listdir(seq_dir))}; eval "
              f"CSVs {csvs}")
        for name in ("stage3_results_per_seq_mean.csv",
                     "stage3_results_agg_mean.csv", "compare_mean.csv"):
            if name not in csvs:
                raise AssertionError(f"path E: {name} missing")
        with open(os.path.join(out, "eval_out",
                               "stage3_results_agg_mean.csv")) as f:
            head, vals = f.read().splitlines()[:2]
        agg = dict(zip(head.split(","), map(float, vals.split(","))))
        print(f"[path E] eval (mean): " + ", ".join(
            f"{k} {agg[k]:.4f}" for k in ("joints3d_all", "verts3d_all",
                                           "mesh3d_all", "contact_acc")))

    # card vs CPU from the same parameters: the fit's motion and latents
    smpl_c, hp = args[0], args[1]
    cfg, obs = kw["cfg"], kw["obs3d"]
    hcfg = HumorConfig(latent_size=48)
    pose, trans, betas = fit["pose"], fit["trans"], fit["betas"]
    p = {"x0": humor_fit.state_from(smpl_c, betas, pose[1], trans[1],
                                    pose[0], trans[0])[None],
         "z": fit["z"][None], "floor": fit["floor"]}
    vals = []
    for dev in (device, torch.device("cpu")):
        mv = lambda t: t.to(dev) if torch.is_tensor(t) else t
        sm = smpl_c.to(dev)
        o = {k: mv(v) for k, v in obs.items()}
        with torch.no_grad():
            verts = humor_fit.body_verts(sm, mv(pose), mv(trans), mv(betas))
            vals.append((
                float(humor_fit.points3d_loss(o["points3d"], verts)),
                float(humor_fit.stage3_loss(
                    sm, humor_to(hp, dev), hcfg, cfg,
                    {k: mv(v) for k, v in p.items()}, mv(betas),
                    mv(fit["floor"]), o))))
    for k, (a, b) in zip(("points3d_loss", "stage-3 loss"), zip(*vals)):
        print(f"[path E] {k}: cuda {a:.6f} cpu {b:.6f}")
        # the card's SMPL forward and rollout sum their matmuls in another
        # order than the CPU's (~1e-6 relative); K4 and the plain version
        # agree bit for bit given the same vertices
        if not abs(a - b) <= 1e-4 * abs(b) + 1e-6:
            raise AssertionError(f"path E {k}: card and CPU disagree")
    return counts


# gate_flips: a ReLU gate that the plain products and K6 take differently is
# a rounding at 0 only where the flipped unit's plain pre-activation p obeys
#   |p| <= (2 GATE_EPS[precision] + 2 (K + 1) 2^-24) (|a| |W| + |b|)
#          + |a' - a| |W|,
# a and a' the layer's input in the plain mode and in K6 (the trunk's input
# at the first layer, each mode's activations after), K its depth.
# GATE_EPS is one product's relative error at each precision, taken by
# each mode: 3xTF32's dropped lo.lo and split residuals (3 x 2^-22), bf16x3's
# (3 x 2^-16), bf16's two rounded operands (2 x 2^-8); 2 (K + 1) 2^-24 are
# two f32 sums of K products and the bias in different orders.
GATE_EPS = {"highest": 2.0 ** -20, "high": 2.0 ** -14, "bf16": 2.0 ** -7}
# the largest share of modes_agree's batch that such flips may take out
GATE_FLIP_SHARE = 0.01


def agree_batch(fitter):
    """modes_agree's batch: (view, frame) indices from a fixed seed."""
    import torch
    V, F = fitter.assets.num_views, fitter.assets.num_frames
    g = torch.Generator().manual_seed(5)
    vi = torch.randint(0, V, (fitter.cfg.batch_size,), generator=g)
    fi = torch.randint(0, F, (fitter.cfg.batch_size,), generator=g)
    return vi.to(fitter.device), fi.to(fitter.device)


def gate_flips(name, fitter, vi, fi):
    """The batch's samples at which the MotionNet's plain products and K6,
    at the assets' precision, take a ReLU gate differently: the trunk's
    inputs from one plain forward, then each mode's activations (h1, h2, z)
    from them. A pre-activation at 0 may round to either sign; that moves
    the unit's gradient by a whole term, and only there do the two modes
    compute different functions. Fails if the phase-0 anchor flips, if a
    flipped unit's plain pre-activation lies outside its rounding bound
    (GATE_EPS), or if more than GATE_FLIP_SHARE of the batch flips."""
    import dataclasses
    import torch
    from nemo_tpu_torch.fit import fit_loss
    from nemo_tpu_torch.modules.networks import net_dot
    from nemo_tpu_torch.ops import mlp
    motion, prec = fitter.params.motion, fitter.assets.net_precision
    inputs = []
    hook = motion.trunk.register_forward_pre_hook(
        lambda mod, args: inputs.append(args[0].detach().contiguous()))
    try:
        with torch.no_grad():
            fit_loss(fitter.params, fitter.cfg, dataclasses.replace(
                fitter.assets, motion_mlp="plain"), vi, fi)
    finally:
        hook.remove()
    if [x.shape[0] for x in inputs[:2]] != [len(vi), 1]:
        raise AssertionError(f"{name}: the trunk's calls are not the batch "
                             "and the phase-0 anchor")
    t = motion.trunk
    layers = [(W.detach(), b.detach()) for W, b in
              ((t.W1, t.b1), (t.W2, t.b2), (t.W3, t.b3))]
    weights = [w.detach().contiguous() for w in (
        t.W1, t.b1, t.W2, t.b2, t.W3, t.b3,
        torch.cat([motion.W_rot, motion.W_lin], dim=1),
        torch.cat([motion.b_rot, motion.b_lin]))]
    fused = mlp.mlp_fwd_cuda if inputs[0].is_cuda else \
        mlp.motion_net_mlp_plain
    flips, worst = [], 0.0
    with torch.no_grad():
        for x in inputs[:2]:        # the batch, then the phase-0 anchor
            _, *kernel = fused(x, *weights, precision=prec)
            a = ak = x
            flipped = torch.zeros(len(x), dtype=torch.bool, device=x.device)
            for (W, b), k in zip(layers, kernel):
                p = net_dot(a, W, prec) + b
                rel = 2 * GATE_EPS[prec] + 2 * (W.shape[0] + 1) * 2.0 ** -24
                bound = rel * (a.abs() @ W.abs() + b.abs()) + \
                    (ak - a).abs() @ W.abs()
                flip = (p > 0) != (k > 0)
                if bool(flip.any()):    # a flip at a bound of 0 is not one
                    ratio = (p.abs() / bound).nan_to_num(nan=math.inf)
                    worst = max(worst, float(ratio[flip].max()))
                flipped |= flip.any(1)
                a, ak = torch.relu(p), k
            flips.append(flipped)
    batch, anchor = flips
    n, most = int(batch.sum()), int(GATE_FLIP_SHARE * len(vi))
    print(f"[{name}] {n} of {len(vi)} samples left out (at most {most}): a "
          f"MotionNet ReLU gate open in one mode and shut in the other; the "
          f"flipped pre-activations reach {worst:.3g} of their rounding bound")
    if bool(anchor.any()):
        raise AssertionError(f"{name}: the modes gate the phase-0 anchor "
                             "differently")
    if worst > 1.0:
        raise AssertionError(f"{name}: a ReLU gate flips at a pre-activation "
                             f"{worst:.3g} times its rounding bound")
    if n > most:
        raise AssertionError(f"{name}: {n} of {len(vi)} samples flip a "
                             f"ReLU gate, more than {most}")
    return batch


def modes_agree(name, fitter, field, modes, loss_rtol, grad_rel):
    """fit_loss and its parameter gradients with the assets' ``field`` set
    to each of two ``modes``, on the card, from the same parameters and
    batch: the loss within loss_rtol relative, each gradient
    within grad_rel of its tensor's largest entry. b_lin's gradient is 0
    (trans - trans0 cancels it): what each mode computes there is the
    difference of two equal column sums taken in different orders, held to
    the scale of W_lin's gradient. For the MotionNet's two modes the batch
    leaves out the samples where gate_flips finds a ReLU gate that the two
    modes take differently, each flip within its rounding bound and at
    most GATE_FLIP_SHARE of the batch."""
    import dataclasses
    from nemo_tpu_torch.fit import fit_loss
    cfg, params = fitter.cfg, fitter.params
    vi, fi = agree_batch(fitter)
    if field == "motion_mlp":
        flipped = gate_flips(name, fitter, vi, fi)
        vi, fi = vi[~flipped], fi[~flipped]
    res = {}
    for mode in modes:
        assets = dataclasses.replace(fitter.assets, **{field: mode})
        params.zero_grad(set_to_none=True)
        loss, _ = fit_loss(params, cfg, assets, vi, fi)
        loss.backward()
        res[mode] = (float(loss.detach()), {n: p.grad.detach().clone()
                                   for n, p in params.named_parameters()
                                   if p.grad is not None})
    params.zero_grad(set_to_none=True)
    (la, ga), (lb, gb) = (res[m] for m in modes)
    a, b = modes
    print(f"[{name}] fit_loss {b} {lb:.6f} {a} {la:.6f} (relative "
          f"{abs(lb - la) / abs(la):.3e}, tolerance {loss_rtol:g})")
    if not abs(lb - la) <= loss_rtol * abs(la):
        raise AssertionError(f"{name}: {b} and {a} fit_loss disagree")
    if sorted(ga) != sorted(gb):
        raise AssertionError(f"{name}: the modes reach different parameters")
    worst = 0.0
    for k, want in ga.items():
        scale = ga["motion.W_lin"] if k == "motion.b_lin" else want
        err = float((gb[k] - want).abs().max())
        tol = grad_rel * float(scale.abs().max())
        worst = max(worst, err / max(tol, 1e-30))
        if not err <= tol:
            raise AssertionError(f"{name}: gradient {k} differs by {err:.3e} "
                                 f"(tolerance {tol:.3e})")
    print(f"[{name}] gradients of {len(ga)} tensors, {b} vs {a}: the "
          f"largest error is {worst:.3f} of its tolerance ({grad_rel:g} of "
          "the tensor's largest entry)")


def path_f(device, smpl, bundle):
    """Slice 1's reference configuration with the MotionNet through K6
    (motion_mlp="fused", the JAX package's NEMO_TPU_NET_FUSED=1): 10 warmup,
    10 camera and 30 main steps at B=512, h_dim 1000. Then the K6 launches
    of one predict (two K6f: the batch and the B = 1 phase-0 anchor) and of
    one fit_loss with its backward, a step of each stage without a device
    synchronisation, card vs CPU, and fused vs plain on the card."""
    import torch
    from nemo_tpu_torch.fit import fit_loss, predict
    from nemo_tpu_torch.ops import launch_counts, reset_launches
    fitter = make_fitter(device, smpl, bundle, reference_config(),
                         motion_mlp="fused")
    main = 30

    def run():
        ms, steady, main_s = stages(fitter, 10, 10, main, 10)
        return ms, steady, main_s, fitter.eval_loss()

    counts, (ms, steady, main_s, final) = run_path(
        "path F", ("fk_fwd", "fk_bwd", "v2v_grad", "mlp_fwd", "mlp_bwd"), run)
    print(f"[path F] main stage: {main} steps in {main_s:.3f} s; the last "
          f"{main - 10} at {steady:.3f} steps/s (batch {BATCH}, the "
          "MotionNet through K6)")
    print(f"[path F] final {final}")
    check_finite("path F", ms, final)
    check_falls("path F", ms[2]["kp_loss"], 10)
    cfg, assets = fitter.cfg, fitter.assets
    vi = torch.arange(BATCH, device=device) % assets.num_views
    fi = torch.arange(BATCH, device=device) % assets.num_frames
    reset_launches()
    with torch.no_grad():
        predict(fitter.params, cfg, assets, vi, fi)
    one_predict = launch_counts()
    reset_launches()
    fit_loss(fitter.params, cfg, assets, vi, fi)[0].backward()
    one_loss = launch_counts()
    fitter.params.zero_grad(set_to_none=True)
    got = {"predict": [one_predict[k] for k in ("mlp_fwd", "mlp_bwd")],
           "fit_loss and backward": [one_loss[k]
                                     for k in ("mlp_fwd", "mlp_bwd")]}
    print(f"[path F] (mlp_fwd, mlp_bwd) launches: {json.dumps(got)}")
    if got != {"predict": [2, 0], "fit_loss and backward": [2, 2]}:
        raise AssertionError("path F: expected two K6f launches a predict "
                             "(the batch and the phase-0 anchor)")
    no_sync_steps("path F", fitter)
    card_vs_cpu("path F", fitter, bundle, smpl)
    modes_agree("path F", fitter, "motion_mlp", ("plain", "fused"), 1e-5,
                1e-4)
    return counts, steady


def write_asset_files(d, smpl):
    """The recipe's assets in the real files' layouts under d, written from
    the smoke's own objects: the 6890-vertex synthetic body as
    smpl/SMPL_NEUTRAL.pkl (chumpy arrays, a sparse J_regressor, uint32
    parents and faces) and as SMPL_NEUTRAL.npz, J_regressor_extra.npy, the
    VPoser of make_fitter as V02_05/snapshots/*.ckpt ('vp_model.' keys),
    the synthetic GMM as gmm_08.pkl (a dict), and init_humor's weights at
    generator seed 0 (humor_tool's default) as a {'model': ...} torch
    file. Returns the paths and the in-memory sources."""
    import numpy as np
    import torch
    from nemo_tpu_torch.models.humor import HumorConfig, init_humor
    from nemo_tpu_torch.priors.gmm import synthetic_gmm_arrays
    from nemo_tpu_torch.priors.vposer import init_vposer
    from nemo_tpu_torch.utils import asset_files as af
    host = smpl.to("cpu")
    arrays = af.smpl_file_arrays(host)
    os.makedirs(os.path.join(d, "smpl"))
    files = {
        "smpl_dir": os.path.join(d, "smpl"),
        "smpl_pkl": af.write_smpl_pkl(os.path.join(d, "smpl",
                                                   "SMPL_NEUTRAL.pkl"),
                                      arrays),
        "smpl_npz": af.write_smpl_npz(os.path.join(d, "SMPL_NEUTRAL.npz"),
                                      arrays),
        "jre": os.path.join(d, "J_regressor_extra.npy"),
        "gmm": af.write_gmm_pkl(os.path.join(d, "gmm_08.pkl"),
                                *synthetic_gmm_arrays(8)),
    }
    np.save(files["jre"], host.J_regressor_extra.numpy())
    vposer = init_vposer(generator=torch.Generator().manual_seed(7))
    files["vposer"] = af.write_vposer_snapshot(os.path.join(d, "V02_05"),
                                               vposer)
    humor = init_humor(torch.Generator().manual_seed(0), HumorConfig())
    files["humor"] = af.write_humor_ckpt(os.path.join(d, "humor.pth"),
                                         humor)
    return files, {"vposer": vposer, "humor": humor}


def loaders_bit_identical(device, smpl, files, sources):
    """Each loader's tensors on the card against their in-memory sources,
    bit for bit: both SMPL files (every SMPLModel field), the VPoser
    snapshot, the GMM and the HuMoR checkpoint. Returns the loaded SMPL,
    GMM, VPoser and HuMoR."""
    import numpy as np
    import torch
    from nemo_tpu_torch.body.assets import load_smpl, load_smpl_npz
    from nemo_tpu_torch.body.smpl import _TENSOR_FIELDS
    from nemo_tpu_torch.models.humor import HumorConfig, load_humor
    from nemo_tpu_torch.priors.gmm import load_gmm_prior, synthetic_gmm_prior
    from nemo_tpu_torch.priors.vposer import load_vposer

    def same(tag, a, b):
        if not (a.device == b.device and a.dtype == b.dtype
                and torch.equal(a, b)):
            raise AssertionError(f"path G: {tag} differs from its source")

    loaded = {"smpl (pkl)": load_smpl(files["smpl_dir"], files["jre"],
                                      device=device),
              "smpl (npz)": load_smpl_npz(files["smpl_npz"], files["jre"],
                                          device=device)}
    n = 0
    for tag, m in loaded.items():
        for f in _TENSOR_FIELDS:
            same(f"{tag} {f}", getattr(m, f), getattr(smpl, f))
            n += 1
        for f in ("parents", "vertex_joint_ids", "joint_map", "faces"):
            if not np.array_equal(getattr(m, f), getattr(smpl, f)):
                raise AssertionError(f"path G: {tag} {f} differs")
            n += 1
    gmm = load_gmm_prior(files["gmm"], device=device)
    want = synthetic_gmm_prior(8).to(device)
    for f in ("means", "precisions", "nll_weights"):
        same(f"gmm {f}", getattr(gmm, f), getattr(want, f))
        n += 1
    vposer = load_vposer(files["vposer"], device=device)
    if sorted(vposer) != sorted(sources["vposer"]):
        raise AssertionError("path G: VPoser keys differ")
    for k, v in sources["vposer"].items():
        same(f"vposer {k}", vposer[k], v.to(device))
        n += 1
    humor = load_humor(files["humor"], HumorConfig(), device=device)
    for m, sub in sources["humor"].items():
        for k, v in sub.items():
            same(f"humor {m}.{k}", humor[m][k], v.to(device))
            n += 1
    print(f"[path G] {n} loaded tensors and index arrays (SMPL from the "
          "pickle and the npz, GMM, VPoser, HuMoR) bit-identical on the card "
          "to their in-memory sources")
    return loaded["smpl (pkl)"], gmm, vposer, humor


def recipe_bundle(bundle, path):
    """The smoke's bundle with vs, pare and GLAMR baseline poses and GLAMR
    world data (global orient and root translation) near the ground truth,
    from a seeded numpy RNG, saved to path."""
    import dataclasses
    import numpy as np
    rng = np.random.default_rng(11)
    V, F = bundle.num_views, bundle.num_frames
    pose = lambda: np.concatenate(
        [bundle.gt3d_pose[..., 3:] + 0.1 * rng.standard_normal((V, F, 69)),
         np.ones((V, F, 1))], -1).astype(np.float32)
    b = dataclasses.replace(
        bundle, baseline_poses={"vs": pose(), "pare": pose(),
                                "glamr": pose()},
        glamr_orient=(bundle.gt3d_pose[..., :3] + 0.1 * rng.standard_normal(
            (V, F, 3))).astype(np.float32),
        glamr_trans=(bundle.gt3d_trans + 0.1 * rng.standard_normal(
            (V, F, 3))).astype(np.float32))
    b.save(path)
    return path


def path_g(device, smpl, bundle, files, sources):
    """The NeMo-MoCap recipe from files in the real layouts, at full width.

    1. Every loader's tensors on the card bit-identical to their sources.
    2. fit_loss at initialisation (reference configuration, 8 views x 120
       frames, B=512, the same seed and batch) equal between a fitter on
       the loaded assets and one on the in-memory assets.
    3. nemo_tpu_torch.cli.fit with run_examples/nemomocap-example.sh's
       flags (--default_config configs/default-v2.yml, the four asset
       paths, the mesh video) on the bundle with vs, pare and GLAMR
       baselines and GLAMR world data. Cut: 5 warmup, 5 camera and 10 main
       steps (--warmup_step, --opt_cam_step, --n_steps), and the video to
       every 4th frame (--render_video 30 in place of 1, as path D). The
       eval CSVs must hold the baseline and GLAMR columns, all finite.
    4. The custom-video configuration (NemoV3, full batch B=960) on the
       loaded assets, without and then with the HuMoR dynamics term
       (weight 1, the written checkpoint): 3 warmup, 3 camera and 20 main
       steps each, the main stage's steps/s. With the term: humor_loss
       finite, the first main step's loss (the full grid) on the card
       against the CPU, a step of each stage without a
       synchronisation.
    """
    import numpy as np
    import torch
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.cli import fit as fit_cli
    from nemo_tpu_torch.fit import NemoFitter, build_assets, fit_loss
    out = {}
    t_start = time.perf_counter()

    def run():
        smpl_f, gmm_f, vposer_f, humor_f = loaders_bit_identical(
            device, smpl, files, sources)
        # 2. init fit_loss, loaded vs in-memory assets
        cfg = reference_config()
        mem = make_fitter(device, smpl, bundle, cfg)
        fil = NemoFitter(cfg, build_assets(bundle, smpl_f, cfg, gmm=gmm_f,
                                           vposer=vposer_f, device=device),
                         seed=0)
        g = torch.Generator().manual_seed(9)
        V, F = bundle.num_views, bundle.num_frames
        vi = torch.randint(0, V, (BATCH,), generator=g).to(device)
        fi = torch.randint(0, F, (BATCH,), generator=g).to(device)
        with torch.no_grad():
            _, m_mem = fit_loss(mem.params, cfg, mem.assets, vi, fi)
            _, m_fil = fit_loss(fil.params, cfg, fil.assets, vi, fi)
        got = {k: (float(m_mem[k]), float(m_fil[k])) for k in m_mem}
        print(f"[path G] init fit_loss at B={BATCH}, in memory vs from "
              f"files: {json.dumps(got)}")
        if sorted(m_mem) != sorted(m_fil) or any(a != b for a, b in
                                                 got.values()):
            raise AssertionError("path G: fit_loss from the files differs")
        del mem, fil
        # 3. the recipe through the CLI
        with tempfile.TemporaryDirectory() as d:
            argv = ["--bundle", recipe_bundle(bundle, os.path.join(
                        d, "bundle.npz")),
                    "--default_config", "configs/default-v2.yml",
                    "--smpl_path", files["smpl_dir"],
                    "--j_regressor_extra", files["jre"],
                    "--vposer_path", files["vposer"],
                    "--gmm_path", files["gmm"],
                    "--render_video", "30", "--warmup_step", "5",
                    "--opt_cam_step", "5", "--n_steps", "10",
                    "--out_dir", os.path.join(d, "out"),
                    "--device", str(device)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if fit_cli.main(argv) != 0:
                raise AssertionError("path G: the fit CLI failed")
            out["cli_s"] = time.perf_counter() - t0
            run_dir = os.path.join(d, "out", "000000")
            print(f"[path G] the recipe's fit CLI: {out['cli_s']:.2f} s; "
                  f"outputs {sorted(os.listdir(run_dir))}")
            want = {"eval_3d.csv": ("mpjpe-vibe", "mpjpe-vs", "mpjpe-pare",
                                    "mpjpe-glamr", "pa_mpjpe-glamr"),
                    "eval_3d_dynamic.csv": ("mpjpe-vibe", "mpjpe-glamr"),
                    "eval_3d_global.csv": ("mpjpe-ours", "mpvpe-ours",
                                           "mpjpe-glamr", "mpvpe-glamr")}
            for name, cols in want.items():
                with open(os.path.join(run_dir, name)) as f:
                    rows = [line.strip().split(",") for line in f]
                head, vals = rows[0], [list(map(float, r[1:]))
                                       for r in rows[1:]]
                missing = [c for c in cols if c not in head]
                if missing or len(vals) != V or not np.isfinite(vals).all():
                    raise AssertionError(f"path G: {name} malformed "
                                         f"(missing {missing})")
                print(f"[path G] {name}: {head[1:]}; view 0 "
                      f"{dict(zip(head[1:], vals[0]))}")
        # 4. the custom-video configuration without, then with, the
        # HuMoR term
        for weight in (0.0, 1.0):
            tag = "path G humor" if weight else "path G no humor"
            cfg = custom_video_config(weight_humor_loss=weight)
            fitter = NemoFitter(cfg, build_assets(
                bundle, smpl_f, cfg, gmm=gmm_f, vposer=vposer_f,
                device=device, humor=humor_f if weight else None), seed=0)
            wm, cm = fitter.warmup(3), fitter.opt_cam(3)
            if weight:
                grid = (torch.arange(V).repeat_interleave(F),
                        torch.arange(F).repeat(V))
                card_vs_cpu(tag, fitter, bundle, smpl_f, batch=grid)
            main, chunk = 20, 5
            stamps = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fm = fitter.fit(main, chunk=chunk, on_chunk=lambda *_:
                            stamps.append(time.perf_counter()))
            rate = (main - chunk) / (stamps[-1] - stamps[0])
            out["humor_steps_s" if weight else "custom_steps_s"] = rate
            check_finite(tag, [wm, cm, fm])
            rows, term = "off", ""
            if weight:
                rows = f"on {3 * V * F} rows"
                term = (f"humor_loss {fm['humor_loss'][0]:.4f} -> "
                        f"{fm['humor_loss'][-1]:.4f}, ")
            print(f"[{tag}] main stage: {main} steps in "
                  f"{stamps[-1] - t0:.3f} s; the last {main - chunk} at "
                  f"{rate:.3f} steps/s (full batch B={V * F}, the HuMoR "
                  f"term {rows}; {nvidia_smi_line()}); {term}total_loss "
                  f"{fm['total_loss'][0]:.3f} -> {fm['total_loss'][-1]:.3f}")
        no_sync_steps("path G humor", fitter)

    counts, _ = run_path("path G", ("fk_fwd", "fk_bwd", "v2v_grad",
                                    "v2v_fwd", "raster_stream"), run)
    out["seconds"] = time.perf_counter() - t_start
    print(f"[path G] {out['seconds']:.1f} s in all")
    return counts, out


# path J: the recipe from raw files
J_CAM_STEPS = 500       # fit_gt_camera steps a view
J_CAM_ATOL = 1e-4       # cam9, card against CPU
J_LOSS_RTOL = 1e-6      # init fit_loss from the packed bundle, relative
J_EXPORT_ATOL = 1e-5    # exported pose, trans, joints15: card against CPU
J_RECON_ATOL = 2e-4     # joints15 against smpl_forward of the payload
J_EMPTY_EVERY, J_DOUBLE_EVERY = 9, 7    # frames with nobody / two people


def raw_view_people(op, rng):
    """One view's OpenPose detections from its (F, 25, 3) labels: nobody
    on every J_EMPTY_EVERY-th frame, a second person 700 px to the right
    after the first on every J_DOUBLE_EVERY-th. Returns (detections, the
    labels the packer must read: zeros where nobody was detected)."""
    import numpy as np
    people, want = [], op.copy()
    for f in range(op.shape[0]):
        if f % J_EMPTY_EVERY == 4:
            people.append([])
            want[f] = 0
        elif f % J_DOUBLE_EVERY == 2:
            other = op[f].copy()
            other[:, 0] += 700 + 20 * rng.standard_normal(25)
            people.append([op[f], other])
        else:
            people.append([op[f]])
    return people, want.astype(np.float32)


def write_raw_recipe(d, bundle, smpl, device):
    """The reference's raw per-view layout of an 8-view action, from the
    smoke's bundle (nemo_tpu_torch/utils/raw_layout.py): per view an
    OpenPose JSON directory (<name>.frames.op/), <name>_gt_2d.npy, a
    <name>_vibe/vibe_output.pkl with two tracklets (the one on the 2D
    labels, and another person 700 px away on every other frame), a joblib
    {'rot6d', 'tran', 'K'} camera from fit_gt_camera on the card
    (J_CAM_STEPS steps from the true camera moved by 0.05, the re-fit of
    nemomocap_utils.py:111-211), and one MoSh mocap pickle (SMPL-H fullpose
    width 156, trans) of the unwarped motion. Returns the action YAML, the
    camera paths, the mocap path, the in-memory bundle the packer must
    reproduce, and the camera fits' host seconds a view."""
    import dataclasses
    import numpy as np
    import torch
    from nemo_tpu_torch.data.camera_fit import fit_gt_camera
    from nemo_tpu_torch.data.synthetic import smooth_motion
    from nemo_tpu_torch.utils import raw_layout as rl
    rng = np.random.default_rng(17)
    V, F = bundle.num_views, bundle.num_frames
    exp = os.path.join(d, "exp")
    names = [f"cam{v}.mp4" for v in range(V)]
    pose, trans = smooth_motion(F, seed=0)
    pose = pose.reshape(F, 72)
    fullpose = np.concatenate(
        [pose[:, :66], 0.1 * rng.standard_normal((F, 90))], 1)
    mocap = rl.write_pickle(os.path.join(d, "mocap.pkl"), {
        "fullpose": fullpose.astype(np.float32), "trans": trans})
    ops, cams, cam_s = [], [], []
    world = world_joints(bundle, smpl, device)
    for v, name in enumerate(names):
        base = os.path.join(exp, name)
        people, op = raw_view_people(bundle.labels["op"][v], rng)
        ops.append(op)
        rl.write_openpose_dir(base + ".frames.op", people)
        np.save(base + "_gt_2d.npy", bundle.labels["gt"][v])
        j2d = np.concatenate([bundle.labels["op"][v][..., :2],
                              np.zeros((F, 24, 2), np.float32)], 1)
        other = np.arange(0, F, 2)
        theta = np.concatenate([bundle.gt3d_pose[v][:, :3],
                                bundle.hmr_theta[v]], 1)
        rl.write_pickle(os.path.join(exp, name + "_vibe",
                                     "vibe_output.pkl"), {
            1: {"pose": (0.3 * rng.standard_normal((len(other), 72))
                         ).astype(np.float32),
                "betas": np.zeros((len(other), 10), np.float32),
                "joints2d_img_coord": (j2d[other] + 700).astype(np.float32),
                "frame_ids": other},
            2: {"pose": theta.astype(np.float32),
                "betas": np.zeros((F, 10), np.float32),
                "joints2d_img_coord": j2d, "frame_ids": np.arange(F),
                "orig_cam": np.tile(np.float32([1.0, 1.0, 0.0, 0.0]),
                                    (F, 1))}})
        init = torch.as_tensor(bundle.gt_cameras[v] + 0.05
                               * rng.standard_normal(9),
                               dtype=torch.float32, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = fit_gt_camera(world[v], torch.as_tensor(
            bundle.labels["gt"][v], device=device), bundle.img_d0,
            bundle.img_d1, num_steps=J_CAM_STEPS, init=init, device=device)
        cam9 = fit["cam9"].cpu().numpy()
        cam_s.append(time.perf_counter() - t0)
        cams.append(rl.write_camera(os.path.join(d, "cams", name + ".pkl"),
                                    cam9))
    cfg = rl.write_action_yaml(os.path.join(d, "action.yml"), exp, names)
    mem = dataclasses.replace(
        bundle, labels={"op": np.stack(ops), "gt": bundle.labels["gt"]},
        gt3d_pose=np.stack([pose] * V), gt3d_trans=np.stack([trans] * V))
    return cfg, cams, mocap, mem, cam_s


def world_joints(bundle, smpl, device):
    """(V, F, 25, 3) world joints of each view's warped motion: the points
    synthetic_problem projects to the 2D labels."""
    import torch
    from nemo_tpu_torch.body.constants import PROJ_JOINT_IDX_V0
    from nemo_tpu_torch.body.smpl import smpl_forward
    V, F = bundle.num_views, bundle.num_frames
    pose = torch.as_tensor(bundle.gt3d_pose, device=device).reshape(V * F, 72)
    _, j49 = smpl_forward(smpl, torch.zeros((1, 10), device=device),
                          pose[:, 3:], pose[:, :3], pose2rot=True,
                          want_vertices=False,
                          transl=torch.as_tensor(bundle.gt3d_trans,
                                                 device=device).reshape(V * F, 3))
    return j49[:, PROJ_JOINT_IDX_V0].reshape(V, F, 25, 3)


def run_module(module, argv):
    """python -m <module> argv from the repository root; returns (host
    seconds, stdout). Fails on a nonzero exit."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module, *argv], cwd=root,
                         env=env, capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"{module} exited {out.returncode}: "
                             f"{out.stdout[-2000:]}{out.stderr[-4000:]}")
    return dt, out.stdout


def cli_flags(parser, cfg):
    """The fit CLI's flags for every field of cfg it has a flag for."""
    import dataclasses
    dests = {a.dest for a in parser._actions}
    argv = []
    for k, v in dataclasses.asdict(cfg).items():
        if k not in dests:
            continue
        if isinstance(v, bool):
            argv += [f"--{k}"] if v else []
        else:
            argv += [f"--{k}", str(v)]
    return argv


def path_j(device, smpl, bundle, files, d):
    """The recipe from raw files, at full width (8 views x 120 frames).

    1. The raw layout (write_raw_recipe), the cameras fitted on the card.
    2. python -m nemo_tpu_torch.cli.preprocess: its report says the native
       OpenPose parser read every view; in this process the native parser
       reads every file bit for bit as parse_openpose_json (both timed); the
       packed op and gt labels, hmr_theta and hmr_mask and gt3d_trans are
       bit-identical to the in-memory bundle's, gt3d_pose too but for the
       hand slots, which are zero.
    3. The doctor on the layout and path G's asset files, --device cuda:
       READY, exit 0.
    4. The fit CLI on the packed bundle at slice 1's reference
       configuration (5/5/10 steps, a checkpoint at 10): its init fit_loss
       equal to a fitter's on the in-memory bundle within J_LOSS_RTOL; K1f,
       K1b and K2's fused mode launched.
    5. The export CLI on the card from that checkpoint: joints15 equal to
       the port's smpl_forward of the payload within J_RECON_ATOL; pose,
       trans and joints15 equal to the CPU export's within J_EXPORT_ATOL;
       K1f launched.
    6. One view's camera fit on the card against the CPU: cam9 within
       J_CAM_ATOL, the final loss under 1% of the first; the card's loop
       runs with every synchronising call an error.
    """
    import io
    import numpy as np
    import torch
    from nemo_tpu_torch.body.smpl import smpl_forward
    from nemo_tpu_torch.cli import doctor, export
    from nemo_tpu_torch.cli import fit as fit_cli
    from nemo_tpu_torch.data import MultiViewBundle, fit_gt_camera
    from nemo_tpu_torch.data.openpose import (openpose_json_paths,
                                              parse_openpose_json)
    from nemo_tpu_torch.ops import launch_counts
    from nemo_tpu_torch.ops.native import (get_native,
                                           parse_openpose_batch_native)
    times = {}
    assets = ["--smpl_path", files["smpl_dir"],
              "--j_regressor_extra", files["jre"],
              "--vposer_path", files["vposer"], "--gmm_path", files["gmm"]]

    def delta(before, names, what):
        torch.cuda.synchronize()
        now = launch_counts()
        got = {k: now[k] - before[k] for k in names}
        if any(n <= 0 for n in got.values()):
            raise AssertionError(f"path J {what}: kernels not launched: {got}")
        return got

    def run():
        # 1. the raw layout
        cfg, cams, mocap, mem, cam_s = write_raw_recipe(d, bundle, smpl,
                                                        device)
        times["camera fit a view"] = float(np.mean(cam_s))
        print(f"[path J] raw layout written; fit_gt_camera on the card, "
              f"{J_CAM_STEPS} steps a view: "
              f"{', '.join(f'{t:.3f}' for t in cam_s)} s")
        # 2. preprocess (the library built and loaded first, so that the
        # timed run does not pay for g++)
        t0 = time.perf_counter()
        if get_native() is None:
            raise AssertionError("path J: the native library did not build")
        times["native build"] = time.perf_counter() - t0
        path = os.path.join(d, "bundle.npz")
        times["preprocess"], out = run_module(
            "nemo_tpu_torch.cli.preprocess",
            ["--nemo_cfg_path", cfg, "--img_h", str(bundle.img_d0),
             "--img_w", str(bundle.img_d1), "--mocap_pkl", mocap,
             "--gt_cam_paths", ",".join(cams), "--out", path])
        line = [ln for ln in out.splitlines() if "OpenPose parser" in ln]
        if len(line) != 1 or \
                f"native {bundle.num_views} view(s)" not in line[0] or \
                "json 0 view(s)" not in line[0]:
            raise AssertionError(f"path J: the native parser did not read "
                                 f"every view: {line}")
        packed = MultiViewBundle.load(path)
        views = [openpose_json_paths(os.path.join(
            d, "exp", f"cam{v}.mp4.frames.op"))
            for v in range(bundle.num_views)]
        t0 = time.perf_counter()
        got = [parse_openpose_batch_native(paths) for paths in views]
        times["native parser, every view"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = [np.stack([parse_openpose_json(p) for p in paths])
                for paths in views]
        times["json module, every view"] = time.perf_counter() - t0
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("path J: the native parser differs from "
                                 "parse_openpose_json")
        n_files = sum(len(paths) for paths in views)
        checks = {"labels op": (packed.labels["op"], mem.labels["op"]),
                  "labels gt": (packed.labels["gt"], mem.labels["gt"]),
                  "hmr_theta": (packed.hmr_theta, mem.hmr_theta),
                  "hmr_mask": (packed.hmr_mask, mem.hmr_mask),
                  "gt3d_trans": (packed.gt3d_trans, mem.gt3d_trans),
                  "gt3d_pose body": (packed.gt3d_pose[..., :66],
                                     mem.gt3d_pose[..., :66]),
                  "gt3d_pose hands": (packed.gt3d_pose[..., 66:],
                                      np.zeros_like(mem.gt3d_pose[..., 66:]))}
        for k, (x, y) in checks.items():
            if not (x.dtype == y.dtype and np.array_equal(x, y)):
                raise AssertionError(f"path J: packed {k} differs")
        print(f"[path J] preprocess: {times['preprocess']:.3f} s (host "
              f"seconds of python -m, {bundle.num_views} views x "
              f"{bundle.num_frames} JSONs; {line[0].strip()}; the library "
              f"built and loaded before in {times['native build']:.3f} s); "
              f"the parsers alone, every "
              f"view: native {times['native parser, every view']:.4f} s, "
              f"json {times['json module, every view']:.4f} s; the native "
              f"parser read all {n_files} files bit for bit as "
              f"parse_openpose_json; bit-identical to the in-memory bundle: "
              f"{', '.join(checks)}")
        # 3. the doctor
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = doctor.main(["--nemo_cfg_path", cfg, *assets,
                              "--gt_cam_paths", ",".join(cams),
                              "--mocap_pkl", mocap, "--device", str(device)])
        times["doctor"] = time.perf_counter() - t0
        verdict = buf.getvalue().strip().splitlines()[-1]
        print(f"[path J] doctor: rc {rc}, {len(doctor._ROWS)} rows, "
              f"{times['doctor']:.3f} s: {verdict}")
        if rc != 0 or not verdict.startswith("READY"):
            raise AssertionError(f"path J: doctor not ready:\n"
                                 f"{buf.getvalue()[-3000:]}")
        # 4. the fit CLI on the packed bundle
        cfg_ref = reference_config(n_steps=10, warmup_step=5, opt_cam_step=5)
        out_dir = os.path.join(d, "fit")
        before = launch_counts()
        t0 = time.perf_counter()
        if fit_cli.main(cli_flags(fit_cli.build_parser(), cfg_ref) + [
                "--bundle", os.path.join(d, "bundle.npz"), *assets,
                "--save_every", "10", "--out_dir", out_dir,
                "--device", str(device)]) != 0:
            raise AssertionError("path J: the fit CLI failed")
        times["fit CLI"] = time.perf_counter() - t0
        fit_counts = delta(before, ("fk_fwd", "fk_bwd", "v2v_grad"), "fit")
        run_dir = os.path.join(out_dir, "000000")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            init = json.loads(f.readline())
        want = make_fitter(device, smpl, mem, cfg_ref).eval_loss(full=True)
        print(f"[path J] fit CLI {times['fit CLI']:.2f} s, launches "
              f"{json.dumps(fit_counts)}; init fit_loss, packed vs in "
              f"memory: " + json.dumps({k: (init[k], want[k])
                                        for k in want}))
        for k, w in want.items():
            if not abs(init[k] - w) <= J_LOSS_RTOL * abs(w):
                raise AssertionError(f"path J: init {k} differs")
        # 5. export on the card and on the CPU
        ckpt = os.path.join(run_dir, "ckpt", "sd_000010")
        motion = {}
        for where, dev in (("card", str(device)), ("cpu", "cpu")):
            path = os.path.join(d, f"motion_{where}.npz")
            before = launch_counts()
            t0 = time.perf_counter()
            if export.main(["--load_ckpt_path", ckpt, "--bundle",
                            os.path.join(d, "bundle.npz"), *assets,
                            "--out", path, "--device", dev]) != 0:
                raise AssertionError("path J: the export CLI failed")
            times[f"export ({where})"] = time.perf_counter() - t0
            if where == "card":
                delta(before, ("fk_fwd",), "export")
            motion[where] = export.load_motion(path)
        card, cpu = motion["card"], motion["cpu"]
        V, F = bundle.num_views, bundle.num_frames
        pose = torch.as_tensor(card["pose"], device=device).reshape(V * F, 72)
        with torch.no_grad():       # cli/export.py's reconstruction recipe
            _, j49 = smpl_forward(
                smpl, torch.as_tensor(card["betas"], device=device)[None],
                pose[:, 3:], pose[:, :3], pose2rot=True, want_vertices=False,
                transl=torch.as_tensor(card["trans"],
                                       device=device).reshape(V * F, 3))
        errs = {"recon joints15": float(np.abs(
            j49[:, :15].cpu().numpy().reshape(V, F, 15, 3)
            - card["joints15"]).max())}
        errs.update({f"{k} card-cpu": float(np.abs(card[k] - cpu[k]).max())
                     for k in ("pose", "trans", "joints15")})
        print(f"[path J] export: card {times['export (card)']:.3f} s, CPU "
              f"{times['export (cpu)']:.3f} s; max errors "
              f"{json.dumps(errs)} (tolerances: recon {J_RECON_ATOL}, "
              f"card-cpu {J_EXPORT_ATOL})")
        if errs["recon joints15"] > J_RECON_ATOL or any(
                e > J_EXPORT_ATOL for k, e in errs.items() if "card" in k):
            raise AssertionError("path J: the export disagrees")
        # 6. one view's camera fit, card against CPU, without a sync
        j3 = world_joints(bundle, smpl, device)[0]
        j2 = torch.as_tensor(bundle.labels["gt"][0], device=device)
        init = torch.as_tensor(bundle.gt_cameras[0] + 0.05, device=device)
        fit_gt_camera(j3, j2, bundle.img_d0, bundle.img_d1, num_steps=1,
                      init=init, device=device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            on_card = fit_gt_camera(j3, j2, bundle.img_d0, bundle.img_d1,
                                    num_steps=J_CAM_STEPS, init=init,
                                    device=device)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        on_cpu = fit_gt_camera(j3.cpu(), j2.cpu(), bundle.img_d0,
                               bundle.img_d1, num_steps=J_CAM_STEPS,
                               init=init.cpu(), device="cpu")
        err = float((on_card["cam9"].cpu() - on_cpu["cam9"]).abs().max())
        loss = on_card["loss"].cpu()
        print(f"[path J] fit_gt_camera view 0 ({J_CAM_STEPS} steps, no "
              f"sync on the card): cam9 card-cpu {err:.3e} (tolerance "
              f"{J_CAM_ATOL}); loss {float(loss[0]):.4f} -> "
              f"{float(loss[-1]):.6f}")
        if not err <= J_CAM_ATOL or not float(loss[-1]) < 0.01 * float(
                loss[0]):
            raise AssertionError("path J: the camera fit disagrees or did "
                                 "not converge")

    t_start = time.perf_counter()
    counts, _ = run_path("path J", ("fk_fwd", "fk_bwd", "v2v_grad"), run)
    times["all"] = time.perf_counter() - t_start
    print(f"[path J] host seconds: {json.dumps(times)}; {nvidia_smi_line()}")
    return counts, times


K_FRAMES = 110          # path K's video: two 60-frame windows, overlap 10
K_EMPTY = (17, 53, 54, 98)   # frames where OpenPose found nobody
K_STEPS = ("10", "10", "5")  # the cut --steps of fit-rgb and fit-prox
K_CAM_T = (0.0, 0.0, 2.5)    # humor_tool's fit-rgb / fit-prox cam_t


def k_motion(smpl, T, device, seed):
    """A swaying, stepping synthetic motion of T frames, upright in the
    camera frame (root turned by pi about x, facing the camera): (pose72,
    trans) on the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, T)[:, None]
    pose = np.zeros((T, 72), np.float32)
    pose[:, 0] = np.pi
    pose[:, 1] = 0.15 * np.sin(t[:, 0])
    pose[:, 3:66] = 0.2 * np.sin(t + rng.uniform(0, np.pi, (1, 63)))
    trans = np.stack([0.2 * np.sin(t[:, 0]), 0.02 * np.cos(2 * t[:, 0]),
                      0.1 * t[:, 0] / np.pi], 1).astype(np.float32)
    f = lambda a: torch.tensor(a, device=device)
    return f(pose), f(trans)


def k_project(points, focal, center, cam_t=(0.0, 0.0, 0.0)):
    """(T, J, 3) camera-frame points -> (T, J, 2) pixels, the pinhole the
    HuMoR fit's 2D term uses (identity rotation, translation cam_t)."""
    import torch
    from nemo_tpu_torch.geometry.camera import perspective_projection
    T = points.shape[0]
    return perspective_projection(
        points, torch.eye(3, device=points.device).expand(T, 3, 3),
        torch.tensor(cam_t, device=points.device).expand(T, 3),
        torch.tensor(float(focal), device=points.device),
        torch.tensor(center, device=points.device).expand(T, 2))


def write_prox_scene(root, smpl, device):
    """A quantitative PROX recording of SEQ_LEN frames, written with
    utils/raw_layout.write_prox_tree from the synthetic body PROX_OFFSET in
    front of the Kinect: 424 x 512 16-bit depth (the body's vertices
    splatted 3 x 3 into the depth camera's z-buffer, a wall 3.5 m out
    elsewhere, stored mirrored as PROX stores it), 1080 x 1920
    BodyIndexColor masks (0 on the person's box in the colour camera),
    OpenPose keypoints of its joints through the colour camera and the
    MoSh fits of the motion (the tree's calibration is
    kinect_calibration())."""
    import numpy as np
    import torch
    from nemo_tpu_torch.body.smpl import smpl_forward
    from nemo_tpu_torch.utils import raw_layout as rl
    calib = rl.kinect_calibration()
    T = SEQ_LEN
    pose, trans = k_motion(smpl, T, device, seed=5)
    trans = trans + torch.tensor(PROX_OFFSET, device=device)
    with torch.no_grad():
        verts, j49 = smpl_forward(smpl, torch.zeros((1, 10), device=device),
                                  pose[:, 3:], pose[:, :3], pose2rot=True,
                                  transl=trans)
    v = verts.cpu().numpy().astype(np.float64)
    dc, cc = calib["depth_cam"], calib["color_cam"]
    K = np.asarray(dc["camera_mtx"])
    view = np.asarray(cc["view_mtx"])
    Kc = np.asarray(cc["camera_mtx"])
    depths, masks = [], []
    for f in range(T):
        u = np.round(K[0, 0] * v[f, :, 0] / v[f, :, 2] + K[0, 2]).astype(int)
        w = np.round(K[1, 1] * v[f, :, 1] / v[f, :, 2] + K[1, 2]).astype(int)
        z = np.full((424, 512), 3.5)
        for du in (-1, 0, 1):
            for dw in (-1, 0, 1):
                ok = (u + du >= 0) & (u + du < 512) & (w + dw >= 0) & \
                    (w + dw < 424)
                np.minimum.at(z, (w[ok] + dw, u[ok] + du), v[f, ok, 2])
        depths.append(np.round(z[:, ::-1] * 8000.0).astype(np.uint16))
        pc = v[f] @ view[:, :3].T + view[:, 3]
        uc = Kc[0, 0] * pc[:, 0] / pc[:, 2] + Kc[0, 2]
        vc = Kc[1, 1] * pc[:, 1] / pc[:, 2] + Kc[1, 2]
        m = np.full((1080, 1920), 255, np.uint8)
        x0, x1 = np.clip([uc.min() - 20, uc.max() + 20], 0, 1920).astype(int)
        y0, y1 = np.clip([vc.min() - 20, vc.max() + 20], 0, 1080).astype(int)
        m[y0:y1, x0:x1] = 0
        masks.append(m)
    uv = k_project(j49[:, :25], Kc[0, 0], (Kc[0, 2], Kc[1, 2]))
    kp = np.concatenate([uv.cpu().numpy(), np.full((T, 25, 1), 0.9)], -1)
    p = pose.cpu().numpy()
    fits = [{"transl": trans[f:f + 1].cpu().numpy(),
             "betas": np.zeros((1, 10), np.float32),
             "body_pose": p[f:f + 1, 3:66], "global_orient": p[f:f + 1, :3]}
            for f in range(T)]
    rl.write_prox_tree(root, kp, lambda f: depths[f], lambda f: masks[f],
                       fits)
    return root


def path_k(device, smpl, files, d):
    """HuMoR fitting from video through the port's humor_tool, at full
    width: the 6890-vertex body from path G's SMPL .npz, the reference
    HuMoR widths at latent 48 from its checkpoint, 60-frame windows, 4096
    scan points; the step counts cut to K_STEPS.

    1. An OpenPose directory of K_FRAMES frames (utils/raw_layout
       write_video_keypoints; K_EMPTY empty) from the synthetic body's
       joints through DEFAULT_FOCAL_LEN at the 1920 x 1080 centre and the
       fitting's cam_t, with the 1080p video frames.
    2. fit-rgb --seq_len 60 --overlap_len 10: two windows, stitched into
       final_results with stage3_results_prior.npz.
    3. viz-fit --final_only --prior_frame --obs_2d --every 10 over the
       video frames (read with PIL): K5s.
    4. A quantitative PROX recording (write_prox_scene), then fit-prox
       --quant --rgbd --seq_len 60 --max_pts 4096: K4 at (60, 4096, 6890)
       once a loss evaluation, every step of every stage; its eval CSVs
       finite.
    5. fit-eval on fit-prox's results_out: the CSVs equal to fit-prox's
       own eval_out.
    6. Card against CPU from the same parameters: the RGB fit's stage-1
       loss at its result, the first stage-3 loss (its initial state from
       the card's stage 2), the fit_proxd stage-2 loss with points3d at
       its stage-2 result; each within path E's tolerance.
    7. One Adam step of each stage of the fit_proxd fit with every
       synchronising call an error.
    Prints each stage's host seconds and path K's launches."""
    import numpy as np
    import torch
    from nemo_tpu_torch.body.smpl import smpl_forward
    from nemo_tpu_torch.cli import humor_tool
    from nemo_tpu_torch.data.humor_rgb import DEFAULT_FOCAL_LEN
    from nemo_tpu_torch.models import humor_fit
    from nemo_tpu_torch.models.humor import humor_to
    from nemo_tpu_torch.ops import chamfer, launch_counts
    from nemo_tpu_torch.utils import raw_layout as rl
    times, fits, stage_s, k4_shapes = {}, [], [], []
    real_fit, real_adam = humor_fit.humor_motion_fit, humor_fit._run_adam
    real_k4 = chamfer.nn_one_way_cuda
    root = os.path.join(d, "path_k")

    def recording_fit(*a, **k):
        out = real_fit(*a, **k)
        fits.append((a, k, out))
        return out

    def timed_stage(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_adam(*a, **k)
        torch.cuda.synchronize()
        stage_s.append(time.perf_counter() - t0)
        return out

    def shaped_k4(a, b):
        k4_shapes.append((tuple(a.shape), tuple(b.shape)))
        return real_k4(a, b)

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = round(time.perf_counter() - t0, 3)
        return out

    def tool(argv, what):
        if humor_tool.main(argv) != 0:
            raise AssertionError(f"path K: {what} failed")

    common = ["--smpl_path", files["smpl_npz"], "--humor_ckpt",
              files["humor"]]

    def write_video():
        pose, trans = k_motion(smpl, K_FRAMES, device, seed=4)
        with torch.no_grad():
            _, j49 = smpl_forward(smpl, torch.zeros((1, 10), device=device),
                                  pose[:, 3:], pose[:, :3], pose2rot=True,
                                  want_vertices=False, transl=trans)
        uv = k_project(j49[:, :25], DEFAULT_FOCAL_LEN[0], (960.0, 540.0),
                       K_CAM_T).cpu().numpy()
        rng = np.random.default_rng(6)
        kp = np.concatenate([uv + 2.0 * rng.standard_normal(uv.shape),
                             0.6 + 0.4 * rng.random(uv.shape[:2] + (1,))],
                            -1)
        return rl.write_video_keypoints(
            os.path.join(root, "keypoints"), kp, empty=K_EMPTY,
            frames_dir=os.path.join(root, "frames"), frame_hw=(1080, 1920))

    def run():
        humor_fit.humor_motion_fit = recording_fit
        humor_fit._run_adam = timed_stage
        chamfer.nn_one_way_cuda = shaped_k4
        try:
            kp_dir = timed("write video", write_video)
            rgb = os.path.join(root, "rgb")
            timed("fit-rgb", lambda: tool(
                ["fit-rgb", "--joints2d", kp_dir, "--img_dir",
                 os.path.join(root, "frames"), "--out", rgb, "--seq_len",
                 str(SEQ_LEN), "--overlap_len", "10", "--steps", *K_STEPS]
                + common, "fit-rgb"))
            res = os.path.join(rgb, "results_out")
            before = launch_counts()
            viz = os.path.join(root, "viz")
            timed("viz-fit", lambda: tool(
                ["viz-fit", "--results", res, "--out", viz, "--final_only",
                 "--prior_frame", "--obs_2d", "--every", "10",
                 "--smpl_path", files["smpl_npz"]], "viz-fit"))
            k5 = launch_counts()["raster_stream"] - before["raster_stream"]
            prox = timed("write PROX", lambda: write_prox_scene(
                os.path.join(root, "prox"), smpl, device))
            px = os.path.join(root, "prox_fit")
            n_k4 = len(k4_shapes)
            timed("fit-prox", lambda: tool(
                ["fit-prox", "--prox", prox, "--quant", "--rgbd", "--out",
                 px, "--seq_len", str(SEQ_LEN), "--max_pts",
                 str(PROX_PTS), "--steps", *K_STEPS] + common, "fit-prox"))
            prox_k4 = k4_shapes[n_k4:]
            ev = os.path.join(root, "fit_eval")
            timed("fit-eval", lambda: tool(
                ["fit-eval", "--results", os.path.join(px, "results_out"),
                 "--out", ev, "--smpl_path", files["smpl_npz"]],
                "fit-eval"))
            return rgb, viz, px, ev, k5, prox_k4
        finally:
            humor_fit.humor_motion_fit = real_fit
            humor_fit._run_adam = real_adam
            chamfer.nn_one_way_cuda = real_k4

    counts, (rgb, viz, px, ev, k5, prox_k4) = run_path(
        "path K", ("fk_fwd", "fk_bwd", "chamfer_nn", "raster_stream"), run)

    # the outputs
    final = os.path.join(rgb, "results_out", "final_results")
    names = sorted(os.listdir(os.path.join(rgb, "results_out")))
    with np.load(os.path.join(final, "stage3_results_prior.npz")) as f:
        prior_ok = f["trans"].shape == (K_FRAMES, 3) and all(
            np.isfinite(f[k]).all() for k in f.files)
    frames = {n: len(os.listdir(os.path.join(viz, n)))
              for n in sorted(os.listdir(viz)) if n.endswith(".frames")}
    print(f"[path K] fit-rgb results {names}; the _prior motion finite "
          f"{prior_ok}; viz-fit frames {json.dumps(frames)}, K5s launches "
          f"{k5}")
    want_frames = len(range(0, K_FRAMES, 10))
    if names != ["final_results", "keypoints_0000", "keypoints_0001"] or \
            not prior_ok or frames != {
                "final_results.frames": want_frames,
                "final_results_prior.frames": want_frames} or k5 <= 0:
        raise AssertionError("path K: fit-rgb / viz-fit outputs")
    steps = sum(int(s) for s in K_STEPS)
    k4_want = ((SEQ_LEN, PROX_PTS, 3), (SEQ_LEN, smpl.num_vertices, 3))
    print(f"[path K] fit-prox K4 launches {len(prox_k4)} (one a loss "
          f"evaluation: {steps}), shapes {sorted(set(prox_k4))}")
    if len(prox_k4) != steps or set(prox_k4) != {k4_want}:
        raise AssertionError("path K: K4 did not run at (60, 4096, 6890) "
                             "in every step of fit-prox")
    with open(os.path.join(px, "eval_out",
                           "stage3_results_agg_mean.csv")) as f:
        head, vals = f.read().splitlines()[:2]
    agg = dict(zip(head.split(","), map(float, vals.split(","))))
    print("[path K] fit-prox eval (mean): " + ", ".join(
        f"{k} {agg[k]:.4f}" for k in ("joints3d_all", "verts3d_all",
                                       "mesh3d_all", "accel_mag")))
    if not all(math.isfinite(v) for v in agg.values()):
        raise AssertionError("path K: fit-prox eval not finite")
    got, want = sorted(os.listdir(ev)), sorted(os.listdir(
        os.path.join(px, "eval_out")))
    same = got == want and all(
        open(os.path.join(ev, n)).read()
        == open(os.path.join(px, "eval_out", n)).read() for n in want)
    print(f"[path K] fit-eval CSVs ({len(got)}) equal to fit-prox's "
          f"eval_out: {same}")
    if not same:
        raise AssertionError("path K: fit-eval differs from fit-prox's eval")
    (rgb_a, rgb_k, rgb_fit), (_, _, rgb_fit2), (px_a, px_k, px_fit) = fits
    if len(stage_s) != 9:
        raise AssertionError("path K: three fits of three stages expected")
    for i, (name, fit) in enumerate((("fit-rgb window 0", rgb_fit),
                                     ("fit-rgb window 1", rgb_fit2),
                                     ("fit-prox", px_fit))):
        losses = [fit[f"stage{s}_loss"].cpu().numpy() for s in (1, 2, 3)]
        print(f"[path K] {name}: " + "; ".join(
            f"stage {s + 1}: {len(v)} steps in {t:.2f} s, loss "
            f"{v[0]:.4f} -> {v[-1]:.4f}" for s, (v, t) in enumerate(
                zip(losses, stage_s[3 * i:3 * i + 3]))))
        if not all(np.isfinite(v).all() for v in losses):
            raise AssertionError(f"path K {name}: non-finite loss")

    # card against CPU from the same parameters
    cpu = torch.device("cpu")

    def on(dev, a, k):
        mv = lambda t: t.to(dev) if torch.is_tensor(t) else t
        smpl_d = a[0].to(dev)
        kp = humor_fit.KeypointObs(mv(a[3]), mv(a[6]), torch.full(
            (), float(k["focal_length"]), device=dev))
        obs = {n: mv(v) for n, v in (k["obs3d"] or {}).items()}
        return smpl_d, kp, mv(a[5]), obs, mv

    def rgb_losses(dev):
        smpl_d, kp, cam_t, obs, mv = on(dev, rgb_a, rgb_k)
        cfg, hcfg, fit = rgb_k["cfg"], rgb_a[2], rgb_fit
        with torch.no_grad():
            s1 = humor_fit.stage1_loss(
                smpl_d, cfg, {"orient": mv(fit["pose"][:, :3]),
                              "trans": mv(fit["trans"])}, mv(rgb_a[4]), obs,
                kp, cam_t)
            betas = mv(fit["betas"])
            p2, t2 = mv(fit["stage2_pose"]), mv(fit["stage2_trans"])
            x0 = humor_fit.state_from(smpl_d, betas, p2[0], t2[0], p2[0],
                                      t2[0])[None]
            fp = obs["floor_plane"].reshape(-1)
            floor0 = fp[:3] * fp[3]
            p3 = {"x0": x0, "z": torch.zeros(
                (1, p2.shape[0] - 1, hcfg.latent_size), device=dev),
                "floor": floor0}
            s3 = humor_fit.stage3_loss(
                smpl_d, humor_to(rgb_a[1], dev), hcfg, cfg, p3, betas,
                floor0, obs, None, kp, None, cam_t)
        return float(s1), float(s3)

    def prox_loss(dev):
        smpl_d, kp, cam_t, obs, mv = on(dev, px_a, px_k)
        with torch.no_grad():
            return float(humor_fit.stage2_loss(
                smpl_d, px_k["cfg"], {"pose": mv(px_fit["stage2_pose"]),
                                      "trans": mv(px_fit["stage2_trans"]),
                                      "betas": mv(px_fit["betas"])},
                obs, kp, None, cam_t))

    t0 = time.perf_counter()
    vals = [rgb_losses(dev) + (prox_loss(dev),) for dev in (device, cpu)]
    times["card vs CPU"] = round(time.perf_counter() - t0, 3)
    first3 = float(rgb_fit["stage3_loss"][0])
    for name, a, b in zip(("RGB stage-1 loss", "first stage-3 loss",
                           "fit_proxd stage-2 loss (points3d)"), *vals):
        print(f"[path K] {name}: cuda {a:.6f} cpu {b:.6f}")
        if not abs(a - b) <= 1e-4 * abs(b) + 1e-6:
            raise AssertionError(f"path K {name}: card and CPU disagree")
    print(f"[path K] first stage-3 loss in the fit's history {first3:.6f}")
    if not abs(first3 - vals[0][1]) <= 1e-4 * abs(first3) + 1e-6:
        raise AssertionError("path K: the first stage-3 loss differs from "
                             "the fit's")

    # a step of each stage with no synchronisation (the fit_proxd fit)
    smpl_d, kp, cam_t, obs, _ = on(device, px_a, px_k)
    cfg, hp, hcfg = px_k["cfg"], px_a[1], px_a[2]
    p1 = {"orient": px_fit["pose"][:, :3].clone(),
          "trans": px_fit["trans"].clone()}
    p2 = {"pose": px_fit["stage2_pose"].clone(),
          "trans": px_fit["stage2_trans"].clone(),
          "betas": px_fit["betas"].clone()}
    with torch.no_grad():
        x0 = humor_fit.state_from(smpl_d, p2["betas"], p2["pose"][0],
                                  p2["trans"][0], p2["pose"][0],
                                  p2["trans"][0])[None]
    floor0 = px_fit["floor"].clone()
    p3 = {"x0": x0, "z": px_fit["z"][None].clone(), "floor": floor0}
    init_pose = px_a[4]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        real_adam(lambda p: humor_fit.stage1_loss(
            smpl_d, cfg, p, init_pose, obs, kp, cam_t), p1, 1, cfg.lr)
        real_adam(lambda p: humor_fit.stage2_loss(
            smpl_d, cfg, p, obs, kp, None, cam_t), p2, 1, cfg.lr)
        real_adam(lambda p: humor_fit.stage3_loss(
            smpl_d, hp, hcfg, cfg, p, p2["betas"], floor0, obs, None, kp,
            None, cam_t), p3, 1, cfg.lr)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("[path K] a step of each stage (fit_proxd: kp2d, points3d "
          "through K4, the floor) ran without a device synchronisation")
    mine = {k: counts[k] for k in ("fk_fwd", "fk_bwd", "chamfer_nn",
                                   "raster_stream")}
    print(f"[path K] launches {json.dumps(mine)}; host seconds "
          f"{json.dumps(times)}; {nvidia_smi_line()}")
    return counts, times, (px_a, px_k)


L_FRAMES = 100          # path L's video, 1280 x 720
L_HW = (720, 1280)
L_GAP = range(46, 51)   # frames where person 1 is not detected
L_FOCAL = 1000.0        # the pinhole the video is drawn with
L_CARD_CROPS = 16       # crops of vibe_forward card against CPU
L_RTOL = 1e-4           # card against CPU, relative to the largest entry
L_CHUNK = 8             # panels a render_demo_video rasterizer call
# one overlay chunk card (K5s) against the CPU's plain fold on the same
# vertices: a pixel differs when a channel or the mask differs by more than
# one 8-bit level (what the written PNG holds); at most this share may
# (a silhouette pixel whose centre lies within rounding of an edge)
L_PIX_TOL = 1.0 / 255
L_PIX_SHARE = 1e-4


def count_video_frames(path):
    """The frames a rendered video holds: the PNGs of its .frames
    directory, or the mp4's frames as ffprobe decodes them (-1 when
    ffprobe cannot count them)."""
    if os.path.isdir(path):
        return sum(n.endswith(".png") for n in os.listdir(path))
    try:
        out = subprocess.run(
            ["ffprobe", "-v", "error", "-count_frames", "-select_streams",
             "v:0", "-show_entries", "stream=nb_read_frames", "-of",
             "csv=p=0", path], capture_output=True, text=True, timeout=120)
        return int(out.stdout.strip())
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return -1


def l_video(smpl, device, root):
    """Path L's input in root: L_FRAMES JPEG frames of two people crossing
    (the synthetic body's 6890 vertices splatted 3 x 3 in the person's
    colour, the farther first), their OpenPose JSONs with STAF person ids
    (person 1 missing over L_GAP), a --detections .npy of both people's
    keypoint boxes, and a SPIN-layout checkpoint with a GRU from seeded
    weights (backbone batch norms calibrated on 32 of the video's crops).
    Returns the paths."""
    import numpy as np
    import torch
    from PIL import Image
    from nemo_tpu_torch.body.smpl import smpl_forward
    from nemo_tpu_torch.data.crops import (bbox_from_keypoints,
                                           get_single_image_crop)
    from nemo_tpu_torch.models import init_gru, init_hmr_head, init_resnet50
    from nemo_tpu_torch.utils import asset_files as af
    from nemo_tpu_torch.utils import raw_layout as rl
    H, W = L_HW
    center = (W / 2.0, H / 2.0)
    s = np.linspace(-1.0, 1.0, L_FRAMES, dtype=np.float32)[:, None]
    uv_v, uv_j, depth = [], [], []
    for p, (x0, z) in enumerate(((-1.6, 6.0), (1.6, 6.6))):
        pose, trans = k_motion(smpl, L_FRAMES, device, seed=20 + p)
        trans = trans + torch.as_tensor(np.concatenate(
            [-x0 * s, np.zeros_like(s), np.full_like(s, z)], 1),
            device=device)
        with torch.no_grad():
            v, j = smpl_forward(smpl, torch.zeros((1, 10), device=device),
                                pose[:, 3:], pose[:, :3], pose2rot=True,
                                transl=trans)
        uv_v.append(k_project(v, L_FOCAL, center).cpu().numpy())
        uv_j.append(k_project(j[:, :25], L_FOCAL, center).cpu().numpy())
        depth.append(z)
    rng = np.random.default_rng(8)
    frames_dir = os.path.join(root, "frames")
    os.makedirs(frames_dir)
    ramp = (np.arange(W, dtype=np.float32)[None] / W * 0.3
            + np.arange(H, dtype=np.float32)[:, None] / H * 0.2)
    colours = (np.array([0.9, 0.4, 0.2]), np.array([0.2, 0.5, 0.9]))
    people, ids, dets = [], [], []
    for f in range(L_FRAMES):
        img = np.repeat(ramp[..., None] + 0.2, 3, axis=2)
        for p in np.argsort(depth)[::-1]:
            px = np.round(uv_v[p][f]).astype(np.int64)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    x, y = px[:, 0] + dx, px[:, 1] + dy
                    ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
                    img[y[ok], x[ok]] = colours[p]
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(frames_dir, f"{f:06d}.jpg"), quality=92)
        here = [p for p in (0, 1) if not (p == 1 and f in L_GAP)]
        kps = [np.concatenate([uv_j[p][f] + 2.0 * rng.standard_normal(
            (25, 2)), 0.6 + 0.4 * rng.random((25, 1))], 1) for p in here]
        people.append(kps)
        ids.append(here)
        boxes = []
        for kp in kps:
            cx, cy, size = bbox_from_keypoints(kp)
            boxes.append([cx - size / 2, cy - size / 2, cx + size / 2,
                          cy + size / 2])
        dets.append(np.asarray(boxes, np.float32).reshape(-1, 4))
    op_dir = rl.write_openpose_dir(os.path.join(root, "openpose"), people,
                                   person_ids=ids)
    det_path = os.path.join(root, "detections.npy")
    det_arr = np.empty(L_FRAMES, dtype=object)
    det_arr[:] = dets
    np.save(det_path, det_arr, allow_pickle=True)

    frames = [np.asarray(Image.open(os.path.join(frames_dir, f"{f:06d}.jpg"))
                         .convert("RGB")) for f in range(0, L_FRAMES, 3)]
    crops = np.stack([get_single_image_crop(
        img, bbox_from_keypoints(people[3 * i][0])) for i, img in
        enumerate(frames[:32])])
    backbone = init_resnet50(torch.Generator().manual_seed(0)).to(device)
    af.calibrate_batch_norm(backbone, torch.from_numpy(crops).to(device)
                            .permute(0, 3, 1, 2))
    ckpt = af.write_spin_ckpt(
        os.path.join(root, "spin_model.pth.tar"), backbone,
        init_hmr_head(torch.Generator().manual_seed(1)),
        init_gru(torch.Generator().manual_seed(2)))
    return {"frames": frames_dir, "openpose": op_dir,
            "detections": det_path, "ckpt": ckpt}


def path_l(device, smpl, files, d):
    """The VIBE demo (custom-video recipe step 3) through the port's
    vibe_demo CLI at full width: 224 crops, ResNet-50, the 2048 GRU, the
    3-iteration regressor, 6890-vertex SMPL from path G's .npz,
    batch_time 64, TemporalSMPLify at the CLI's 1 x 20.

    1. l_video writes a 100-frame 1280 x 720 video of two crossing people
       (one unseen for 5 frames), their OpenPose JSONs and detections,
       and a seeded SPIN-layout checkpoint with a GRU.
    2. vibe_demo with bbox tracking over --detections, then with
       --tracking_method pose --run_smplify --render_out: K1f in every
       SMPL pass, K1b in SMPLify's gradients, K5s in the overlay.
    3. Card against CPU from the same checkpoint: vibe_forward on
       L_CARD_CROPS crops (theta, kp_3d, kp_2d and verts, which K1f
       poses), and two L-BFGS iterations of each SMPLify stage on a track
       (their losses), within L_RTOL; one overlay chunk (L_CHUNK panels at
       the frame size) through render_demo_video's panel function, the
       card's against the CPU's plain fold on the same vertices within
       L_PIX_TOL on all but L_PIX_SHARE of the pixels, and K5s against
       its plain version on the card on that chunk, bit for bit.
    4. Both pickles read back through data/vibe.py (load_vibe_pickle,
       densify_person): per-frame pose, betas and orig_cam equal the
       pickle's; tracks, shapes and values as expected; the written video
       holds a frame for every video frame.
    5. Prints ResNet-50 ms a 64-crop chunk and GRU + regressor + SMPL ms a
       chunk (CUDA events), SMPLify s a track with its linesearch host
       reads, render s a frame, path L's host seconds."""
    import numpy as np
    import torch
    from nemo_tpu_torch.cli import vibe_demo
    from nemo_tpu_torch.data.crops import get_single_image_crop
    from nemo_tpu_torch.data.openpose import load_openpose_dir
    from nemo_tpu_torch.data.vibe import densify_person, load_vibe_pickle
    from nemo_tpu_torch.models import load_spin_checkpoint, vibe_forward
    from nemo_tpu_torch.models.vibe import hmr_forward_from_features
    from nemo_tpu_torch.ops import raster
    from nemo_tpu_torch.priors import temporal_smplify
    from nemo_tpu_torch.priors.gmm import load_gmm_prior
    from nemo_tpu_torch.render.mesh import make_mesh_panel_fn
    from nemo_tpu_torch.utils import pickles
    t_start = time.perf_counter()
    root = os.path.join(d, "path_l")
    times, smplify_runs = {}, []
    t0 = time.perf_counter()
    inp = l_video(smpl, device, root)
    times["write video"] = round(time.perf_counter() - t0, 3)
    real_ts = temporal_smplify.run_temporal_smplify
    real_render = vibe_demo.render_demo_video

    def timed_ts(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_ts(*a, **k)
        torch.cuda.synchronize()
        smplify_runs.append((a[2].shape[0], time.perf_counter() - t0,
                             k["stats"]))
        return out

    rendered = []

    def timed_render(*a, **k):
        t0 = time.perf_counter()
        out = real_render(*a, **k)
        times["render"] = round(time.perf_counter() - t0, 3)
        rendered.append(out)
        return out

    common = ["--frames_dir", inp["frames"], "--spin_ckpt", inp["ckpt"],
              "--smpl_path", files["smpl_npz"]]
    pkl_bbox = os.path.join(root, "vibe_bbox.pkl")
    pkl_pose = os.path.join(root, "vibe_pose.pkl")
    render = os.path.join(root, "vibe_render.mp4")

    def run():
        temporal_smplify.run_temporal_smplify = timed_ts
        vibe_demo.render_demo_video = timed_render
        try:
            for name, argv in (
                    ("vibe_demo bbox", ["--detections", inp["detections"],
                                        "--out", pkl_bbox]),
                    ("vibe_demo pose + SMPLify + render", [
                        "--openpose_dir", inp["openpose"],
                        "--tracking_method", "pose", "--run_smplify",
                        "--gmm_path", files["gmm"], "--render_out", render,
                        "--out", pkl_pose])):
                t0 = time.perf_counter()
                if vibe_demo.main(common + argv) != 0:
                    raise AssertionError(f"path L: {name} failed")
                torch.cuda.synchronize()
                times[name] = round(time.perf_counter() - t0, 3)
        finally:
            temporal_smplify.run_temporal_smplify = real_ts
            vibe_demo.render_demo_video = real_render

    counts, _ = run_path("path L", ("fk_fwd", "fk_bwd", "raster_stream"),
                         run)

    # the outputs, read back as the recipe's next step reads them
    out_bbox, out_pose = pickles.load(pkl_bbox), pickles.load(pkl_pose)
    print(f"[path L] bbox tracks {sorted(out_bbox)} of "
          f"{[len(p['frame_ids']) for p in out_bbox.values()]} frames; pose "
          f"tracks {sorted(out_pose)} of "
          f"{[len(p['frame_ids']) for p in out_pose.values()]} frames, "
          f"SMPLify updated "
          f"{[int(p['smplify_update'].sum()) for p in out_pose.values()]}")
    if sorted(out_pose) != [0, 1] or any(
            len(p["frame_ids"]) != L_FRAMES for p in out_pose.values()) \
            or not out_bbox:
        raise AssertionError("path L: unexpected tracks")
    for name, out, path in (("bbox", out_bbox, pkl_bbox),
                            ("pose", out_pose, pkl_pose)):
        for pid, p in out.items():
            T = len(p["frame_ids"])
            shapes = {k: p[k].shape for k in ("pose", "betas", "orig_cam",
                                              "joints2d_img_coord")}
            if shapes != {"pose": (T, 72), "betas": (T, 10),
                          "orig_cam": (T, 4),
                          "joints2d_img_coord": (T, 49, 2)} or not all(
                    np.isfinite(v).all() for v in p.values()
                    if v.dtype.kind == "f"):
                raise AssertionError(f"path L {name} track {pid}: {shapes}")
            dense = densify_person(p, L_FRAMES)
            fids = p["frame_ids"]
            if not (np.array_equal(dense["pose"][fids], p["pose"])
                    and np.array_equal(dense["betas"], p["betas"])
                    and np.array_equal(dense["orig_cam"][fids],
                                       p["orig_cam"])):
                raise AssertionError(f"path L {name}: data/vibe.py reads "
                                     f"track {pid} otherwise")
        chosen = load_vibe_pickle(path, L_FRAMES)
        longest = max(out.values(), key=lambda p: len(p["frame_ids"]))
        if not np.array_equal(chosen["pose"][longest["frame_ids"]],
                              longest["pose"]):
            raise AssertionError(f"path L {name}: load_vibe_pickle")
    if len(rendered) != 1:
        raise AssertionError("path L: --render_out rendered no video")
    n_rendered = count_video_frames(rendered[0])
    print(f"[path L] pickles read back through data/vibe.py equal; "
          f"{rendered[0]} holds {n_rendered} frames")
    if n_rendered != L_FRAMES:
        raise AssertionError("path L: --render_out frames missing")

    # card against CPU from the same checkpoint
    cpu = torch.device("cpu")
    mods = {dev: [m.to(dev) for m in load_spin_checkpoint(inp["ckpt"])]
            for dev in (device, cpu)}
    smpl_cpu = smpl.to(cpu)
    track = out_pose[0]
    frames = vibe_demo.load_frames(inp["frames"], L_FRAMES)
    fids = track["frame_ids"][:L_CARD_CROPS]
    crops = torch.from_numpy(np.stack([get_single_image_crop(
        frames[f], cs) for f, cs in zip(fids, track["bbox_cs"])])
        ).permute(0, 3, 1, 2)[None]
    t0 = time.perf_counter()
    fwd = {}
    for dev, sm in ((device, smpl), (cpu, smpl_cpu)):
        b, h, g = mods[dev]
        with torch.no_grad():
            fwd[dev] = {k: v.cpu().numpy() for k, v in vibe_forward(
                b, g, h, sm, crops.to(dev)).items()}
    for k in ("theta", "kp_3d", "kp_2d", "verts"):
        err = float(np.abs(fwd[device][k] - fwd[cpu][k]).max())
        scale = float(np.abs(fwd[cpu][k]).max())
        print(f"[path L] vibe_forward {k} on {L_CARD_CROPS} crops: card "
              f"vs CPU {err:.3e} (tolerance {L_RTOL} x {scale:.3f})")
        if not err <= L_RTOL * scale:
            raise AssertionError(f"path L: vibe_forward {k} card and CPU "
                                 f"disagree")
    # one overlay chunk of render_demo_video at the frame size
    verts, trans, cam0 = vibe_demo.person_overlay(track, smpl, L_HW)
    verts, trans = verts[:L_CHUNK].cpu(), trans[:L_CHUNK].cpu()
    eye = torch.eye(3).expand(L_CHUNK, 3, 3)
    panels = {}
    for dev in (device, cpu):
        fn = make_mesh_panel_fn(smpl.faces, [cam0] * L_CHUNK, L_HW,
                                device=dev, method="raster")
        with torch.no_grad():
            imgs, masks = fn(verts.to(dev), eye.to(dev), trans.to(dev))
        panels[dev] = torch.cat([imgs, masks[..., None]], -1).cpu().numpy()
    diff = np.abs(panels[device] - panels[cpu]).max(-1)
    share = float((diff > L_PIX_TOL).mean())
    covered = float(panels[cpu][..., 3].mean())
    print(f"[path L] overlay chunk of {L_CHUNK} panels {L_HW[1]}x{L_HW[0]}: "
          f"card vs CPU plain fold, {share:.2e} of the pixels differ by more "
          f"than {L_PIX_TOL:.5f} (tolerance {L_PIX_SHARE}), largest "
          f"{float(diff.max()):.3e}; the mesh covers {covered:.4f}")
    if not (share <= L_PIX_SHARE and covered > 1e-3):
        raise AssertionError("path L: overlay card and CPU disagree")
    faces = torch.as_tensor(smpl.faces, device=device).long()
    ent = raster.prepare((verts + trans[:, None]).to(device).contiguous(),
                         faces, [float(cam0.focal_length)] * L_CHUNK,
                         [(float(cam0.center[0]), float(cam0.center[1]))]
                         * L_CHUNK, L_HW)
    got = raster.raster_stream_cuda(ent, raster.stream_inputs(ent), L_HW)
    want = raster.rasterize_plain(ent, L_HW, stream=True)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("path L: K5s differs from its plain version "
                             "on the overlay chunk")
    print("[path L] K5s on the overlay chunk: bit-identical to its plain "
          "version on the card")
    op_kps = load_openpose_dir(inp["openpose"], L_FRAMES)
    kp49 = vibe_demo.crop_keypoints(track, op_kps)
    fits = {}
    for dev, sm in ((device, smpl), (cpu, smpl_cpu)):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        out, _ = real_ts(sm, load_gmm_prior(files["gmm"], dev),
                         t(track["pose"]), t(track["betas"]),
                         t(track["pred_cam"]), t(kp49), max_iter=2)
        fits[dev] = [out[k].cpu().numpy() for k in ("cam_losses", "losses")]
    for name, a, b in zip(("camera stage", "body stage"), fits[device],
                          fits[cpu]):
        err = float(np.abs(a - b).max() / np.abs(b).max())
        print(f"[path L] SMPLify {name}, 2 L-BFGS iterations: card "
              f"{a.tolist()} CPU {b.tolist()} ({err:.2e} relative)")
        if not err <= L_RTOL:
            raise AssertionError(f"path L: SMPLify {name} card and CPU "
                                 f"disagree")
    times["card vs CPU"] = round(time.perf_counter() - t0, 3)

    # the networks a 64-crop chunk, CUDA events
    b, h, g = mods[device]
    chunk = torch.randn((64, 3, 224, 224), device=device)
    with torch.no_grad():
        feats = b(chunk)
        resnet_ms = median_ms(lambda: b(chunk), reps=10)
        head_ms = median_ms(lambda: hmr_forward_from_features(
            h, smpl, g(feats[None])[0]), reps=10)
    for n, s, st in smplify_runs:
        print(f"[path L] SMPLify a track of {n} frames: {s:.3f} s, "
              f"host reads " + ", ".join(
                  f"{k} {v.get('host_reads', 0)}" for k, v in st.items()))
    times["path L"] = round(time.perf_counter() - t_start, 3)
    render_s = times["render"] / L_FRAMES
    mine = {k: counts[k] for k in ("fk_fwd", "fk_bwd", "raster_stream")}
    print(f"[path L] ResNet-50 {resnet_ms:.4f} ms a 64-crop chunk; GRU + "
          f"regressor + SMPL {head_ms:.4f} ms a chunk; render "
          f"{render_s:.4f} s a frame (2 people); launches "
          f"{json.dumps(mine)}; host seconds {json.dumps(times)}; "
          f"{nvidia_smi_line()}")
    return counts, {"seconds": times["path L"], "resnet_ms": resnet_ms,
                    "head_ms": head_ms, "render_s": render_s,
                    "smplify": [(n, s) for n, s, _ in smplify_runs]}


M_T = 16                # window length (configs/vibe/config.yaml SEQLEN)
M_FEAT = 2048           # ResNet-50 features
M_EPOCHS, M_ITERS = 2, 10
M_ROWS = {"2d": 48, "3d": 32, "eval": 64, "motion": 64}
M_SHARD = 20            # rows a shard: batches carry rows across shards
M_EVAL_SEQS = 32        # vibe_eval's packed test set, 2 batches of 16
M_TIMED = 10            # back-to-back steps timed on the card
M_LOSS_RTOL = 1e-5      # loss terms, card vs CPU, relative
M_PARAM_RTOL = 1e-4     # updated tensors, of each one's largest entry
M_EVAL_RTOL = 1e-5      # vibe_eval's metrics, card vs CPU, relative


def m_shards(root, rng):
    """The trainer's four feeds as data/sharded.py shards, from seeded
    numpy: ResNet-like (non-negative) features, crop-normalized 2D
    keypoints with confidences, common-14 joints in metres, per-window
    betas, and smooth AMASS-like body poses for the discriminator.
    Returns {feed: directory}."""
    import numpy as np
    from nemo_tpu_torch.data.sharded import write_shards

    def feats(n):
        return np.abs(rng.standard_normal((n, M_T, M_FEAT))).astype(
            np.float32) * 0.5

    def kp2d(n):
        kp = rng.uniform(-0.8, 0.8, (n, M_T, 49, 3)).astype(np.float32)
        kp[..., 2] = rng.uniform(0, 1, (n, M_T, 49)) > 0.3
        return kp

    def smooth(n, d, scale):
        steps = 0.03 * rng.standard_normal((n, M_T, d))
        return (scale * rng.standard_normal((n, 1, d)) +
                np.cumsum(steps, axis=1)).astype(np.float32)

    def three_d(n):
        return {"kp_3d": (0.25 * rng.standard_normal((n, M_T, 14, 3)))
                .astype(np.float32),
                "pose": smooth(n, 72, 0.2),
                "betas": np.repeat(0.5 * rng.standard_normal(
                    (n, 1, 10)), M_T, 1).astype(np.float32)}

    feeds = {
        "2d": {"features": feats(M_ROWS["2d"]), "kp_2d": kp2d(M_ROWS["2d"])},
        "3d": dict(features=feats(M_ROWS["3d"]), kp_2d=kp2d(M_ROWS["3d"]),
                   **three_d(M_ROWS["3d"])),
        "eval": dict(features=feats(M_ROWS["eval"]),
                     kp_2d=kp2d(M_ROWS["eval"]), **three_d(M_ROWS["eval"])),
        "motion": {"pose_body": smooth(M_ROWS["motion"], 69, 0.2)},
    }
    dirs = {}
    for name, arrays in feeds.items():
        dirs[name] = os.path.join(root, f"shards_{name}")
        write_shards(arrays, dirs[name], shard_size=M_SHARD)
    return dirs


def m_raw_trees(root, rng):
    """Small raw trees for build_vibe_db: two 3DPW sequence files (two
    people, then one) and an AMASS subject at 100 fps."""
    import pickle
    import numpy as np
    pw = os.path.join(root, "3dpw", "sequenceFiles", "train")
    os.makedirs(pw)
    for name, people, F in (("courtyard_a_00", 2, 40), ("downtown_b", 1, 24)):
        p2d = rng.uniform(0, 1000, (people, F, 3, 18))
        p2d[:, :, 2] = rng.uniform(0, 1, (people, F, 18)) > 0.2
        with open(os.path.join(pw, f"{name}.pkl"), "wb") as f:
            pickle.dump({"poses": [0.2 * rng.standard_normal((F, 72))
                                   for _ in range(people)],
                         "betas": [rng.standard_normal(300)
                                   for _ in range(people)],
                         "poses2d": list(p2d),
                         "campose_valid": [np.ones(F)] * people}, f,
                        protocol=2)
    am = os.path.join(root, "amass", "CMU", "01")
    os.makedirs(am)
    np.savez(os.path.join(am, "01_01_poses.npz"),
             poses=0.3 * rng.standard_normal((800, 156)),
             trans=rng.standard_normal((800, 3)),
             betas=rng.standard_normal(16), mocap_framerate=np.array(100.0))
    return os.path.join(root, "3dpw"), os.path.join(root, "amass")


def m_profile(fn, reps: int = 5, mark: str = "path_m_steps",
              k1_per_step=(1, 1)) -> dict:
    """Device time of a train step from torch.profiler: fn run twice
    unmeasured, then reps times inside a mark; every device event after
    the mark (kernels and copies) summed a step, their count a step, the
    largest six by name, and K1f's and K1b's time a launch (a step
    launching k1_per_step of each)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with record_function(mark):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    t0 = next(e.time_range.start for e in events
              if e.name == mark and e.device_type == DeviceType.CPU)
    # record_function ranges (the mark's among them) are drawn on the
    # device's timeline too: leave them out
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.time_range.start >= t0 and not e.is_user_annotation]
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]

    def k1(tag, per_step):
        mine = [e.time_range.elapsed_us() for e in dev if tag in e.name]
        return sum(mine) / len(mine) / 1e3 if mine and \
            len(mine) == reps * per_step else None

    return {"device_ms": sum(by_name.values()) / reps / 1e3,  # a step
            "device_events": len(dev) / reps,
            "top": [(n[:60], us / reps / 1e3) for n, us in top],
            "k1f_ms": k1("fk_fwd", k1_per_step[0]),
            "k1b_ms": k1("fk_bwd", k1_per_step[1])}


def path_m(device, d):
    """VIBE training (the custom-video recipe's network, trained) through
    the port's CLIs at full width: configs/vibe/config.yaml (batch 32 =
    19 2D + 13 3D windows of 16 frames, features 2048, the 2048 GRU and
    the SPIN regressor, the 2-layer 1024 GRU discriminator with 3-layer
    attention, Adam at 5e-5 and 1e-4), the 6890-vertex synthetic body.

    1. m_shards writes the 2D, 3D, eval and motion feeds with the port's
       write_shards; python -m nemo_tpu_torch.cli.vibe_train's main runs
       2 epochs of 10 steps (K1f in each step's and each validation
       batch's SMPL pass, K1b in each step's backward) and writes its
       checkpoint; every step's losses must be finite, and K1b must have
       launched once a step, K1f once a step and once a validation batch.
    2. From that checkpoint, one train step on the last batch the CLI
       trained on, on the card (exactly one K1f and one K1b launch) and
       on the CPU's plain path: every loss term within M_LOSS_RTOL, every
       updated tensor within M_PARAM_RTOL of its largest entry; then
       M_TIMED back-to-back steps on the card (steps/s) and 5 more under
       torch.profiler (m_profile: device ms a step, the largest kernels,
       K1f and K1b a launch).
    3. vibe_eval's main on the checkpoint with a packed npz that has
       theta (M_EVAL_SEQS sequences, the 6890-vertex body, the GT
       vertices through K1f), on the card and with --device cpu: every
       metric within M_EVAL_RTOL.
    4. build_vibe_db's main on small 3DPW and AMASS trees: the db read
       back through utils/pickles equals the reader's, the shards hold
       its windows.
    Prints steps/s, ms a step, each stage's host seconds."""
    import numpy as np
    import torch
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.cli import build_vibe_db, vibe_eval, vibe_train
    from nemo_tpu_torch.data.sharded import ShardedDataset
    from nemo_tpu_torch.data.vibe_db import make_windows, read_3dpw
    from nemo_tpu_torch.data.vibe_readers import read_amass
    from nemo_tpu_torch.models import vibe_train as vt
    from nemo_tpu_torch.ops import launch_counts
    from nemo_tpu_torch.utils import pickles

    t_start = time.perf_counter()
    root = os.path.join(d, "path_m")
    os.makedirs(root)
    rng = np.random.default_rng(0)
    times = {}
    cfg_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "configs", "vibe", "config.yaml")
    cfg = vibe_train.load_cfg(cfg_path)
    b2d = int(cfg["TRAIN.BATCH_SIZE"] * cfg["TRAIN.DATA_2D_RATIO"])
    print(f"[path M] {cfg_path}: batch {cfg['TRAIN.BATCH_SIZE']} ({b2d} 2D "
          f"+ {cfg['TRAIN.BATCH_SIZE'] - b2d} 3D windows) x "
          f"{cfg['DATASET.SEQLEN']} frames, discriminator "
          f"{cfg['TRAIN.MOT_DISCR.FEATURE_POOL']} x "
          f"{cfg['TRAIN.MOT_DISCR.NUM_LAYERS']} layers")
    t0 = time.perf_counter()
    dirs = m_shards(root, rng)
    times["write shards"] = round(time.perf_counter() - t0, 3)

    real_make = vt.make_vibe_train_step
    seen = []

    def recording_make(*a, **k):
        step = real_make(*a, **k)

        def recorded(state, batch, real_motion, generator=None,
                     lr_scale=1.0):
            state, m = step(state, batch, real_motion, generator, lr_scale)
            seen.append(({k: float(v) for k, v in m.items()}, batch,
                         real_motion, lr_scale))
            return state, m
        return recorded

    run_dir = os.path.join(root, "run")
    ck = os.path.join(run_dir, "vibe_train_state")
    out = {}

    def run():
        torch.cuda.synchronize()
        c0 = launch_counts()
        t0 = time.perf_counter()
        vt.make_vibe_train_step = recording_make
        try:
            rc = vibe_train.main([
                "--cfg", cfg_path, "--out", run_dir,
                "--shards_2d", dirs["2d"], "--shards_3d", dirs["3d"],
                "--shards_eval", dirs["eval"],
                "--shards_motion", dirs["motion"],
                "--epochs", str(M_EPOCHS), "--iters_per_epoch",
                str(M_ITERS)])
        finally:
            vt.make_vibe_train_step = real_make
        torch.cuda.synchronize()
        times["vibe_train"] = round(time.perf_counter() - t0, 3)
        c1 = launch_counts()
        if rc != 0:
            raise AssertionError(f"path M: vibe_train exited {rc}")
        steps = len(seen)
        fwd, bwd = (c1[k] - c0[k] for k in ("fk_fwd", "fk_bwd"))
        print(f"[path M] vibe_train: {steps} steps, {times['vibe_train']} s; "
              f"K1f {fwd} (want {steps} + {M_EPOCHS * M_ITERS} validation "
              f"batches), K1b {bwd} (want {steps}); losses first "
              f"{json.dumps(seen[0][0])}, last {json.dumps(seen[-1][0])}")
        if steps != M_EPOCHS * M_ITERS or bwd != steps \
                or fwd != steps + M_EPOCHS * M_ITERS:
            raise AssertionError("path M: K1 launches are not one a step "
                                 "and one a validation batch")
        if not all(np.isfinite(v) for m, *_ in seen for v in m.values()):
            raise AssertionError("path M: a loss is not finite")
        if sorted(os.listdir(ck)) != ["disc.npz", "disc_opt.npz", "gen.npz",
                                      "gen_opt.npz"]:
            raise AssertionError("path M: checkpoint files missing")

        # one step from the checkpoint, card against CPU
        t0 = time.perf_counter()
        w = vt.VibeLossWeights(
            kp_2d=float(cfg["LOSS.KP_2D_W"]),
            kp_3d=float(cfg["LOSS.KP_3D_W"]),
            shape=float(cfg["LOSS.SHAPE_W"]),
            pose=float(cfg["LOSS.POSE_W"]),
            adv=float(cfg["LOSS.D_MOTION_LOSS_W"]),
            disc_motion_lr=float(cfg["TRAIN.MOT_DISCR.LR"]))
        _, batch, real, _ = seen[-1]
        res = {}
        for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
            sm = synthetic_smpl_model(device=dev)
            tmpl = vt.init_vibe_train_state(
                torch.Generator().manual_seed(1), sm,
                feature_pool=str(cfg["TRAIN.MOT_DISCR.FEATURE_POOL"]),
                disc_num_layers=int(cfg["TRAIN.MOT_DISCR.NUM_LAYERS"]),
                attention_size=int(cfg["TRAIN.MOT_DISCR.ATT.SIZE"]),
                attention_layers=int(cfg["TRAIN.MOT_DISCR.ATT.LAYERS"]))
            state = vt.load_vibe_state(ck, tmpl)
            del tmpl
            step = real_make(sm, w)
            if where == "card":
                torch.cuda.synchronize()
                c0 = launch_counts()
            state, m = step(state, batch, real)
            res[where] = ({k: float(v) for k, v in m.items()},
                          vt.vibe_train_state_to_jax(state))
            if where == "card":
                torch.cuda.synchronize()
                c1 = launch_counts()
                one = {k: c1[k] - c0[k] for k in ("fk_fwd", "fk_bwd")}
                print(f"[path M] one train step on the card: launches "
                      f"{json.dumps(one)}")
                if one != {"fk_fwd": 1, "fk_bwd": 1}:
                    raise AssertionError("path M: a train step launched "
                                         "other than one K1f and one K1b")
                t1 = time.perf_counter()
                for _ in range(M_TIMED):
                    state, _ = step(state, batch, real)
                torch.cuda.synchronize()
                out["step_ms"] = (time.perf_counter() - t1) * 1e3 / M_TIMED
                out.update(m_profile(lambda: step(state, batch, real)))
            del state
        card = res["card"][1]
        worst_loss = 0.0
        for k, v in res["cpu"][0].items():
            e = abs(res["card"][0][k] - v) / max(abs(v), 1e-30)
            worst_loss = max(worst_loss, e)
            print(f"[path M] {k}: card {res['card'][0][k]!r} CPU {v!r} "
                  f"({e:.2e} relative, tolerance {M_LOSS_RTOL})")
        errs = []
        for net in ("gen", "disc"):
            for k, v in res["cpu"][1][net].items():
                e = float(np.abs(card[net][k] - v).max())
                errs.append((e / max(float(np.abs(v).max()), 1e-30), e,
                             float(np.abs(v).max()), f"{net}/{k}"))
        errs.sort(reverse=True)
        print("[path M] updated tensors, card vs CPU, worst: " + "; ".join(
            f"{n} {e:.3e} of {s:.3e} ({r:.2e})" for r, e, s, n in errs[:6]))
        times["step card vs CPU"] = round(time.perf_counter() - t0, 3)
        out.update(loss_err=worst_loss, param_err=errs[0][0])
        if not worst_loss <= M_LOSS_RTOL:
            raise AssertionError("path M: loss terms card and CPU disagree")
        if not errs[0][0] <= M_PARAM_RTOL:
            raise AssertionError("path M: updated tensors card and CPU "
                                 "disagree")

        # vibe_eval on the checkpoint, card and CPU
        t0 = time.perf_counter()
        N = M_EVAL_SEQS
        theta = np.concatenate([
            np.tile([0.9, 0.0, 0.0], (N, M_T, 1)),
            np.cumsum(0.03 * rng.standard_normal((N, M_T, 72)), 1)
            + 0.2 * rng.standard_normal((N, 1, 72)),
            np.repeat(0.5 * rng.standard_normal((N, 1, 10)), M_T, 1)],
            -1).astype(np.float32)
        db = os.path.join(root, "test_db.npz")
        np.savez(db, features=np.abs(rng.standard_normal(
            (N, M_T, M_FEAT))).astype(np.float32) * 0.5,
            kp_3d=(0.25 * rng.standard_normal((N, M_T, 14, 3))).astype(
                np.float32), theta=theta)
        metrics = {}
        for dev in ("cuda", "cpu"):
            csv = os.path.join(root, f"eval_{dev}.csv")
            c0 = launch_counts()
            if vibe_eval.main(["--ckpt", ck, "--db", db, "--batch_size", "16",
                               "--num_vertices", "6890", "--device", dev,
                               "--out_csv", csv]) != 0:
                raise AssertionError(f"path M: vibe_eval on {dev} failed")
            c1 = launch_counts()
            if dev == "cuda":
                out["eval_k1f"] = c1["fk_fwd"] - c0["fk_fwd"]
            head, row = open(csv).read().strip().split("\n")
            metrics[dev] = dict(zip(head.split(","),
                                    map(float, row.split(","))))
        worst = max(abs(metrics["cuda"][k] - v) / abs(v)
                    for k, v in metrics["cpu"].items())
        times["vibe_eval card and CPU"] = round(time.perf_counter() - t0, 3)
        print(f"[path M] vibe_eval on {N} x {M_T} frames: card "
              f"{json.dumps(metrics['cuda'])}; CPU "
              f"{json.dumps(metrics['cpu'])}; worst {worst:.2e} relative "
              f"(tolerance {M_EVAL_RTOL}); K1f launches {out['eval_k1f']} "
              f"(want 3: 2 batches + the GT vertices)")
        out["eval_err"] = worst
        if list(metrics["cuda"]) != ["mpjpe", "pa-mpjpe", "accel",
                                     "accel_err", "pve"] \
                or not worst <= M_EVAL_RTOL or out["eval_k1f"] != 3 \
                or not all(np.isfinite(list(metrics["cuda"].values()))):
            raise AssertionError("path M: vibe_eval card and CPU disagree")

    counts, _ = run_path("path M", ("fk_fwd", "fk_bwd"), run)

    # build_vibe_db on raw trees, on the host
    t0 = time.perf_counter()
    pw, am = m_raw_trees(root, rng)
    for name, src, ref in (
            ("3dpw", pw, lambda: read_3dpw(pw).build()),
            ("amass", am, lambda: read_amass(am))):
        pt = os.path.join(root, f"{name}_db.pt")
        sh = os.path.join(root, f"{name}_shards")
        if build_vibe_db.main(["--dataset", name, "--dir", src, "--out", pt,
                               "--shards_out", sh, "--seqlen", "16"]) != 0:
            raise AssertionError(f"path M: build_vibe_db {name} failed")
        got, want = pickles.load(pt), ref()
        if list(got) != list(want) or not all(
                np.array_equal(got[k], want[k]) for k in want):
            raise AssertionError(f"path M: the {name} db reads back "
                                 f"otherwise")
        n_win = len(make_windows(want["vid_name"], 16))
        if len(ShardedDataset(sh)) != n_win or n_win == 0:
            raise AssertionError(f"path M: {name} shards")
        print(f"[path M] build_vibe_db {name}: "
              f"{len(want['vid_name'])} frames, {n_win} windows; the db "
              f"read back through utils/pickles equals the reader's")
    times["build_vibe_db"] = round(time.perf_counter() - t0, 3)
    times["path M"] = round(time.perf_counter() - t_start, 3)
    out["steps_s"] = 1e3 / out["step_ms"]
    out["seconds"] = times["path M"]
    print(f"[path M] a train step on the card (torch.profiler, 5 steps): "
          f"device {out['device_ms']:.3f} ms in {out['device_events']:.0f} "
          f"kernels and copies, busy {out['device_ms'] / out['step_ms']:.1%}"
          f" of the back-to-back step; largest "
          + "; ".join(f"{n} {ms:.3f} ms" for n, ms in out["top"])
          + "; " + ", ".join(
              f"{k} " + ("not measured" if out[f"{k.lower()}_ms"] is None
                         else f"{out[f'{k.lower()}_ms']:.4f} ms")
              for k in ("K1f", "K1b")) + " a launch")
    print(f"[path M] {out['steps_s']:.3f} steps/s ({out['step_ms']:.2f} ms "
          f"a step, {M_TIMED} back-to-back steps at batch 32 x 16); "
          f"launches {json.dumps({k: counts[k] for k in ('fk_fwd', 'fk_bwd')})}"
          f"; host seconds {json.dumps(times)}; {nvidia_smi_line()}")
    return counts, out


N_IK_B = 512            # IK targets (the VPoser draw of tests/test_ik.py)
N_IK_LBFGS = 34         # L-BFGS steps, about a third of Adam's 100
N_IK_CHECKED = 10       # Adam steps run on the card and the CPU
N_IK_LOSS_RTOL = 1e-4   # their losses, card vs CPU, relative
N_IK_JOINT_RTOL = 1e-3  # their fitted joints, of the largest entry, in
N_IK_ROW_SHARE = 0.99   # at least this share of the rows
N_IK_DESCENT = 0.1      # each fit's final loss, of its first
N_VP_BATCH = 128        # VPoser training batch
N_VP_SEQ_T = 1050       # frames an AMASS sequence: 16 keep 4032 frames
N_VP_RTOL = 1e-5        # loss terms (relative) and updated tensors (of
#                         each one's largest entry), card vs CPU
N_VP_TIMED = 10         # back-to-back VPoser train steps timed on the card
N_HUMOR_STEPS = (3, 5, 1)   # L-BFGS steps of the three HuMoR stages
# (stage 3 cut from 2 to keep the smoke's time with paths P and Q; stages
# 1 and 2, whose trajectory the descent check reads, as before)
N_HUMOR_RTOL = 1e-4     # stages 1-2's starting loss, card vs CPU
N_HUMOR_GRAD_RTOL = 1e-3  # and its gradient, in norm over the norm
N_HELPER_RTOL = 1e-5    # geometry helpers, card vs CPU, of the largest
N_SVD_RTOL = 1e-4       # entry; the SVD-based ones (cuSOLVER vs LAPACK)


def n_amass_tree(root, rng):
    """An AMASS-layout tree <root>/<dataset>/<subject>/*_poses.npz: two
    training datasets of 4 subjects with 2 sequences of N_VP_SEQ_T frames
    (prepare_vposer_dataset keeps 0.24 of each, 4032 frames in all) and a
    validation one; 156 columns of smooth seeded SMPL-H axis-angle."""
    import numpy as np
    splits = {"train": ["CMU", "KIT"], "vald": ["HumanEva"]}
    for ds in splits["train"] + splits["vald"]:
        for s in range(4 if ds != "HumanEva" else 1):
            d = os.path.join(root, ds, f"s{s:02d}")
            os.makedirs(d)
            for q in range(2):
                t = np.linspace(0, 6 * np.pi, N_VP_SEQ_T)[:, None]
                poses = 0.4 * np.sin(t * rng.uniform(0.5, 2.0, (1, 156))
                                     + rng.uniform(0, np.pi, (1, 156))) \
                    + 0.05 * rng.standard_normal((N_VP_SEQ_T, 156))
                np.savez(os.path.join(d, f"seq{q}_poses.npz"),
                         poses=poses.astype(np.float32),
                         trans=np.zeros((N_VP_SEQ_T, 3), np.float32))
    return splits


def n_rel(got, want):
    """Largest |got - want| over want's largest entry."""
    import numpy as np
    got, want = (np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                            else x, np.float64) for x in (got, want))
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def path_n_ik(device, smpl, out):
    """N1: ik_fit on B = N_IK_B targets posed, as tests/test_ik.py's
    fixture poses them, from a seeded VPoser draw and translation through
    a 512 x 32 VPoser and the 6890-vertex body. Adam at IKConfig's
    defaults and L-BFGS for N_IK_LBFGS steps (with its statistics) on the
    card: K1f and K1b once a loss evaluation, each fit's loss below
    N_IK_DESCENT of its first. Card vs CPU over Adam's first N_IK_CHECKED
    steps: Adam at lr 0.1 amplifies f32 order noise in a few rows
    (scripts/torch_ik_spread.py: the CPU at 1 and 4 threads parts 2 rows
    of 512 past 1e-3 m after 10 steps, 358 after 100), so the losses are
    held within N_IK_LOSS_RTOL and the joints within N_IK_JOINT_RTOL of
    their largest entry in N_IK_ROW_SHARE of the rows. tests/test_ik.py's
    criteria (L-BFGS's final loss within 1.05 of Adam's, mean joint error
    under 0.05 m), which that test takes at B = 2 after 150 Adam and 50
    L-BFGS steps, are printed: at this batch and these step counts they
    do not hold in either package (PERF.md §6)."""
    import numpy as np
    import torch
    from nemo_tpu_torch.body.smpl import smpl_forward
    from nemo_tpu_torch.geometry import batch_rodrigues
    from nemo_tpu_torch.ops import launch_counts
    from nemo_tpu_torch.priors import IKConfig, ik_fit
    from nemo_tpu_torch.priors.vposer import init_vposer, vposer_decode
    cpu = torch.device("cpu")
    B = N_IK_B
    vp_cpu = init_vposer(generator=torch.Generator().manual_seed(2))
    vp = {k: v.to(device) for k, v in vp_cpu.items()}
    rng = np.random.RandomState(0)
    z_true = torch.tensor(0.5 * rng.randn(B, 32), dtype=torch.float32,
                          device=device)
    trans_true = torch.tensor(0.3 * rng.randn(B, 3), dtype=torch.float32,
                              device=device)
    with torch.no_grad():
        pose63 = vposer_decode(vp, z_true)["pose_body"].reshape(B, 63)
        rot = batch_rodrigues(torch.cat([pose63, pose63.new_zeros((B, 6))],
                                        1).reshape(B, 23, 3))
        orient = batch_rodrigues(pose63.new_zeros((B, 1, 3)))
        _, target = smpl_forward(smpl, pose63.new_zeros((1, 10)), rot,
                                 orient, want_vertices=False,
                                 transl=trans_true)
    smpl_cpu = smpl.to(cpu)
    runs = {}

    def run(name, sm, v, tgt, cfg, stats=None):
        torch.cuda.synchronize()
        c0 = launch_counts()
        t0 = time.perf_counter()
        res = ik_fit(sm, v, tgt, cfg=cfg, stats=stats)
        torch.cuda.synchronize()
        c1 = launch_counts()
        runs[name] = (res, time.perf_counter() - t0,
                      {k: c1[k] - c0[k] for k in ("fk_fwd", "fk_bwd")})
        return res

    adam = run("adam card", smpl, vp, target, IKConfig())
    first = run("first card", smpl, vp, target,
                IKConfig(num_steps=N_IK_CHECKED))
    first_cpu = run("first cpu", smpl_cpu, vp_cpu, target.to(cpu),
                    IKConfig(num_steps=N_IK_CHECKED))
    stats = {}
    lbfgs = run("lbfgs card", smpl, vp, target,
                IKConfig(num_steps=N_IK_LBFGS, optimizer="lbfgs"), stats)
    la, ll = adam["loss"].cpu().numpy(), lbfgs["loss"].cpu().numpy()
    lf, lc = first["loss"].cpu().numpy(), first_cpu["loss"].numpy()
    loss_err = float(np.max(np.abs(lf - lc) / np.abs(lc)))
    row_err = ((first["joints"].cpu() - first_cpu["joints"]).abs().amax(
        dim=(1, 2)) / first_cpu["joints"].abs().max()).numpy()
    row_share = float(np.mean(row_err <= N_IK_JOINT_RTOL))
    joint_err = float(row_err.max())
    mean_err = {k: float((r["joints"] - target).abs().mean())
                for k, r in (("adam", adam), ("lbfgs", lbfgs))}
    evals = stats["loss_evals"]
    print(f"[path N] N1 IK, B {B}: Adam {len(la)} steps loss {la[0]:.4f} -> "
          f"{la[-1]:.6f} in {runs['adam card'][1]:.2f} s, L-BFGS "
          f"{len(ll)} steps {ll[0]:.4f} "
          f"-> {ll[-1]:.6f} in {runs['lbfgs card'][1]:.2f} s, {evals} loss "
          f"evaluations, {stats['host_reads']} host reads; mean joint error "
          f"Adam {mean_err['adam']:.5f} m, L-BFGS {mean_err['lbfgs']:.5f} "
          f"m; card vs CPU over {N_IK_CHECKED} Adam steps ({runs['first card'][1]:.2f}"
          f" s and {runs['first cpu'][1]:.2f} s): losses {loss_err:.2e} "
          f"relative (tolerance {N_IK_LOSS_RTOL}), joints within "
          f"{N_IK_JOINT_RTOL} of their largest entry in {row_share:.2%} of "
          f"the rows (at least {N_IK_ROW_SHARE:.0%}), worst row "
          f"{joint_err:.2e}; tests/test_ik.py's criteria, not gated "
          f"here: L-BFGS's final loss {ll[-1] / la[-1]:.3f} of Adam's "
          f"(1.05 there), mean joint errors (0.05 there); K1 launches Adam "
          f"{json.dumps(runs['adam card'][2])}, L-BFGS "
          f"{json.dumps(runs['lbfgs card'][2])}")
    if not all(np.isfinite(x).all() for x in (la, lf, lc, ll)):
        raise AssertionError("path N1: a loss is not finite")
    if not loss_err <= N_IK_LOSS_RTOL or not row_share >= N_IK_ROW_SHARE:
        raise AssertionError("path N1: Adam's fit, card and CPU disagree")
    if not (la[-1] < N_IK_DESCENT * la[0] and ll[-1] < N_IK_DESCENT * ll[0]):
        raise AssertionError("path N1: a fit did not descend")
    # each loss evaluation one K1f and, under its gradient, one K1b; and
    # one K1f for the fitted joints
    if runs["adam card"][2] != {"fk_fwd": 101, "fk_bwd": 100} or \
            runs["lbfgs card"][2] != {"fk_fwd": evals + 1, "fk_bwd": evals}:
        raise AssertionError("path N1: K1 launches do not match the loss "
                             "evaluations")
    out["n1"] = dict(adam_s=runs["adam card"][1],
                     lbfgs_s=runs["lbfgs card"][1], evals=evals,
                     host_reads=stats["host_reads"], loss_err=loss_err,
                     joint_err=joint_err, row_share=row_share,
                     adam_final=float(la[-1]),
                     lbfgs_final=float(ll[-1]), mean_err=mean_err)


def path_n_vposer(device, smpl, root, out):
    """N2: VPoser training. n_amass_tree's AMASS layout through
    prepare_vposer_dataset into shards, read back; train_vposer for 2
    epochs at batch N_VP_BATCH with the extra terms in the first only
    (both step variants), VPoser at 512 x 32 against the 6890-vertex
    body: two K1f and one K1b a step. Then one step, card and CPU, from
    the state at the start of the second epoch with that step's batch and
    draw; N_VP_TIMED back-to-back steps and a torch.profiler breakdown."""
    import numpy as np
    import torch
    from nemo_tpu_torch.data.sharded import ShardedDataset
    from nemo_tpu_torch.ops import launch_counts
    from nemo_tpu_torch.priors import vposer_train as vpt
    from nemo_tpu_torch.priors.vposer import init_vposer
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    amass = os.path.join(root, "amass")
    splits = n_amass_tree(amass, np.random.default_rng(8))
    counts = vpt.prepare_vposer_dataset(os.path.join(root, "vposer_ds"),
                                        splits, amass, seed=0)
    ds = ShardedDataset(os.path.join(root, "vposer_ds", "train"))
    data = np.concatenate([ds.load_shard(i)["pose_body"]
                           for i in range(ds.num_shards)])
    prep_s = time.perf_counter() - t0
    if data.shape != (counts["train"], 63) or counts["train"] != 4032:
        raise AssertionError(f"path N2: {counts} frames prepared, "
                             f"{data.shape} read back")
    cfg = vpt.VPoserTrainConfig(batch_size=N_VP_BATCH,
                                keep_extra_loss_terms_until_epoch=1)
    params = {k: v.to(device) for k, v in init_vposer(
        generator=torch.Generator().manual_seed(3)).items()}
    real_make = vpt.make_vposer_train_step
    seen = {"steps": 0}

    def recording_make(cfg_, smpl_=None, include_extra_terms=True,
                       mesh=None):
        init_opt, step = real_make(cfg_, smpl_, include_extra_terms, mesh)

        def recorded(p, opt, pose_body, noise):
            if not include_extra_terms and "state" not in seen:
                seen["state"] = vpt.vposer_train_state_to_jax(p, opt)
                seen["batch"] = (pose_body.cpu(), noise.cpu())
            seen["steps"] += 1
            return step(p, opt, pose_body, noise)
        return init_opt, recorded

    torch.cuda.synchronize()
    c0 = launch_counts()
    t0 = time.perf_counter()
    vpt.make_vposer_train_step = recording_make
    try:
        trained, hist = vpt.train_vposer(params, data, cfg, num_epochs=2,
                                         seed=0, smpl=smpl)
    finally:
        vpt.make_vposer_train_step = real_make
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    c1 = launch_counts()
    k1 = {k: c1[k] - c0[k] for k in ("fk_fwd", "fk_bwd")}
    steps = seen["steps"]
    print(f"[path N] N2 VPoser training: {counts} frames prepared from "
          f"{N_VP_SEQ_T}-frame sequences in {prep_s:.2f} s; train_vposer 2 "
          f"epochs x {steps // 2} steps at batch {N_VP_BATCH} in "
          f"{train_s:.2f} s, history {json.dumps({k: [round(float(x), 6) for x in v] for k, v in hist.items()})}"
          f"; K1 launches {json.dumps(k1)} (want 2 and 1 a step)")
    if steps != 2 * (4032 // N_VP_BATCH) or \
            k1 != {"fk_fwd": 2 * steps, "fk_bwd": steps}:
        raise AssertionError("path N2: K1 launches are not two K1f and one "
                             "K1b a step")
    if not all(np.isfinite(v).all() for v in hist.values()) or \
            not all(torch.isfinite(v).all() for v in trained.values()) or \
            len(hist["matrot"]) != 1 or len(hist["v2v"]) != 2:
        raise AssertionError("path N2: train_vposer's history")

    # one step from the second epoch's starting state, card and CPU
    jp, jo = seen["state"]
    res, k1_one = {}, None
    for where, dev, sm in (("card", device, smpl),
                           ("cpu", cpu, smpl.to(cpu))):
        p, opt = vpt.vposer_train_state_from_jax(jp, jo, cfg.lr, dev)
        _, step = real_make(cfg, sm, False)
        batch, noise = (x.to(dev) for x in seen["batch"])
        if where == "card":
            torch.cuda.synchronize()
            c0 = launch_counts()
        p, opt, m = step(p, opt, batch, noise)
        res[where] = ({k: float(v) for k, v in m.items()},
                      vpt.vposer_train_state_to_jax(p, opt))
        if where == "card":
            torch.cuda.synchronize()
            c1 = launch_counts()
            k1_one = {k: c1[k] - c0[k] for k in ("fk_fwd", "fk_bwd")}
            t1 = time.perf_counter()
            for _ in range(N_VP_TIMED):
                p, opt, m = step(p, opt, batch, noise)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t1) * 1e3 / N_VP_TIMED
            prof = m_profile(lambda: step(p, opt, batch, noise),
                             mark="path_n_steps", k1_per_step=(2, 1))
    loss_err = max(abs(res["card"][0][k] - v) / max(abs(v), 1e-30)
                   for k, v in res["cpu"][0].items())
    errs = sorted(((n_rel(res["card"][1][0][k], v), k)
                   for k, v in res["cpu"][1][0].items()), reverse=True)
    mom = sorted(((n_rel(res["card"][1][1][k], v), k)
                  for k, v in res["cpu"][1][1].items()), reverse=True)
    print(f"[path N] N2 one step card vs CPU: losses card "
          f"{json.dumps(res['card'][0])} CPU {json.dumps(res['cpu'][0])}, "
          f"worst {loss_err:.2e} relative; updated tensors worst "
          + "; ".join(f"{k} {e:.2e}" for e, k in errs[:4])
          + f"; Adam moments worst " + "; ".join(f"{k} {e:.2e}"
                                                 for e, k in mom[:3])
          + f" (tolerance {N_VP_RTOL}); launches {json.dumps(k1_one)}")
    print(f"[path N] N2 a train step on the card: {1e3 / step_ms:.3f} "
          f"steps/s ({step_ms:.3f} ms, {N_VP_TIMED} back-to-back steps); "
          f"torch.profiler (5 steps): device {prof['device_ms']:.3f} ms in "
          f"{prof['device_events']:.0f} kernels and copies, busy "
          f"{prof['device_ms'] / step_ms:.1%} of the step; largest "
          + "; ".join(f"{n} {ms:.3f} ms" for n, ms in prof["top"])
          + "; " + ", ".join(
              f"{k} " + ("not measured" if prof[f"{k.lower()}_ms"] is None
                         else f"{prof[f'{k.lower()}_ms']:.4f} ms")
              for k in ("K1f", "K1b")) + " a launch")
    if k1_one != {"fk_fwd": 2, "fk_bwd": 1}:
        raise AssertionError("path N2: a step launched other than two K1f "
                             "and one K1b")
    if not loss_err <= N_VP_RTOL or not errs[0][0] <= N_VP_RTOL:
        raise AssertionError("path N2: the step on the card and the CPU "
                             "disagree")
    out["n2"] = dict(prep_s=prep_s, train_s=train_s, steps=steps,
                     step_ms=step_ms, steps_s=1e3 / step_ms,
                     loss_err=loss_err, param_err=errs[0][0],
                     param_worst=errs[0][1], moment_err=mom[0][0], **prof)


@contextlib.contextmanager
def deterministic_cuda():
    """torch.use_deterministic_algorithms(True) inside the block: an op
    whose CUDA version sums with atomics takes its sorted version, and
    one that has none raises. It needs main()'s CUBLAS_WORKSPACE_CONFIG."""
    import torch
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def path_n_humor(device, prox, out):
    """N3: humor_motion_fit with optimizer="lbfgs" at N_HUMOR_STEPS on
    path K's fit-prox --rgbd window (latent 48, T 60, 4096 scan points,
    the 6890-vertex body, K4 at (60, 4096, 6890) once a loss evaluation
    of every stage); each stage's L-BFGS statistics. Card vs CPU: the
    loss and its gradient where stages 1 and 2 start, stage 2 from the
    card's stage-1 output; the gradient in norm, since a scan point whose
    nearest vertex differs between the two meshes moves its part of the
    gradient to another vertex (the count is printed). Steps are not
    compared: stages 1 and 2 take about 12 loss evaluations a step here,
    each many seconds on the CPU with its gradient, and a linesearch that
    fails after its 20 iterations ends at a step set by rounding (PERF.md
    §6).

    The fit and the card's evaluations run under deterministic_cuda():
    here stage 2 creeps at stepsizes of 1e-5 to 1e-10 (the CPU's first
    step too), and the atomic sums of PyTorch's default CUDA backward
    (2e-7 to 5e-7 of the gradient's largest entry, run to run) decide
    whether it leaves that in 5 steps, so the descent check would pass
    or fail by chance (scripts/torch_humor_lbfgs_spread.py). With them
    the fit is one trajectory, and the card's gradient must repeat bit
    for bit."""
    import dataclasses
    import numpy as np
    import torch
    from nemo_tpu_torch.fit.lbfgs import value_and_grad
    from nemo_tpu_torch.models import humor_fit
    from nemo_tpu_torch.ops import launch_counts
    from nemo_tpu_torch.ops.chamfer import nn_one_way
    cpu = torch.device("cpu")
    px_a, px_k = prox
    s1, s2, s3 = N_HUMOR_STEPS
    cfg = dataclasses.replace(px_k["cfg"], optimizer="lbfgs",
                              steps_stage1=s1, steps_stage2=s2,
                              steps_stage3=s3)
    real_opt = humor_fit._run_opt
    stages = []

    def recording_opt(loss_fn, params0, steps, lr, optimizer="adam",
                      stats=None):
        stats = {}
        torch.cuda.synchronize()
        c0 = launch_counts()
        t0 = time.perf_counter()
        p, losses = real_opt(loss_fn, params0, steps, lr, optimizer, stats)
        torch.cuda.synchronize()
        stages.append(dict(params0=params0, loss_fn=loss_fn, stats=stats,
                           seconds=time.perf_counter() - t0,
                           k4=launch_counts()["chamfer_nn"]
                           - c0["chamfer_nn"], losses=losses))
        return p, losses

    torch.cuda.synchronize()
    c0 = launch_counts()
    t0 = time.perf_counter()
    humor_fit._run_opt = recording_opt
    try:
        with deterministic_cuda():
            fit = humor_fit.humor_motion_fit(*px_a, **dict(px_k, cfg=cfg))
    finally:
        humor_fit._run_opt = real_opt
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    k4 = launch_counts()["chamfer_nn"] - c0["chamfer_nn"]
    evals = [st["stats"]["loss_evals"] for st in stages]
    for i, st in enumerate(stages):
        v = st["losses"].cpu().numpy()
        print(f"[path N] N3 HuMoR L-BFGS stage {i + 1}: {len(v)} steps in "
              f"{st['seconds']:.2f} s, loss before each step "
              f"{[round(float(x), 4) for x in v]}, "
              f"{st['stats']['loss_evals']} loss evaluations, "
              f"{st['stats']['host_reads']} host reads, K4 launches "
              f"{st['k4']}")
    l2 = fit["stage2_loss"].cpu().numpy()
    if len(stages) != 3 or not all(
            torch.isfinite(v).all() for v in fit.values()) \
            or not l2[-1] < l2[0]:
        raise AssertionError("path N3: the L-BFGS fit is not finite or "
                             "stage 2 did not descend")
    if k4 != sum(evals) or [st["k4"] for st in stages] != evals:
        raise AssertionError("path N3: K4 launches do not match the loss "
                             "evaluations")

    # card against CPU: each stage's loss and gradient where it starts,
    # stage 2's from the card's stage-1 output (a CPU evaluation with its
    # gradient takes seconds at this size, and a step tens of them)
    t0 = time.perf_counter()
    mv = lambda t: t.to(cpu) if torch.is_tensor(t) else t
    smpl_c = px_a[0].to(cpu)
    kp = humor_fit.KeypointObs(mv(px_a[3]), mv(px_a[6]), torch.full(
        (), float(px_k["focal_length"])))
    obs = {n: mv(v) for n, v in px_k["obs3d"].items()}
    cam_t = mv(px_a[5])
    cpu_fns = (lambda p: humor_fit.stage1_loss(smpl_c, cfg, p, mv(px_a[4]),
                                               obs, kp, cam_t),
               lambda p: humor_fit.stage2_loss(smpl_c, cfg, p, obs, kp, None,
                                               cam_t))
    start = []
    flat = lambda d: torch.cat([d[k].detach().cpu().reshape(-1).double()
                                for k in sorted(d)])
    # the scan points whose nearest vertex differs between the card's mesh
    # (K4) and the CPU's (the plain version) where stage 2 starts
    p2 = stages[1]["params0"]
    with torch.no_grad():
        _, i_card = nn_one_way(px_k["obs3d"]["points3d"], humor_fit.body_verts(
            px_a[0], p2["pose"], p2["trans"], p2["betas"]))
        _, i_cpu = nn_one_way(obs["points3d"], humor_fit.body_verts(
            smpl_c, mv(p2["pose"]), mv(p2["trans"]), mv(p2["betas"])))
    flips = int((i_card.cpu() != i_cpu).sum())
    for i, (st, fn) in enumerate(zip(stages, cpu_fns)):
        with deterministic_cuda():
            v, g = value_and_grad(st["loss_fn"], st["params0"])
            _, g2 = value_and_grad(st["loss_fn"], st["params0"])  # again
        if not all(torch.equal(g[k], g2[k]) for k in g):
            raise AssertionError(f"path N3: stage {i + 1}'s gradient on the "
                                 f"card differs between two evaluations "
                                 f"under deterministic algorithms")
        vc, gc = value_and_grad(fn, {k: mv(x) for k, x in
                                     st["params0"].items()})
        print(f"[path N] N3 stage {i + 1}'s gradient, card vs CPU (card vs "
              f"card) of each tensor's largest entry: " + ", ".join(
                  f"{k} {n_rel(g[k], gc[k]):.2e} ({n_rel(g[k], g2[k]):.2e})"
                  for k in sorted(g)) + f"; in norm "
              f"{float((flat(g) - flat(gc)).norm() / flat(gc).norm()):.2e} "
              f"({float((flat(g) - flat(g2)).norm() / flat(gc).norm()):.2e})")
        start.append((float(v), float(vc), abs(float(v) - float(vc))
                      / abs(float(vc)), float((flat(g) - flat(gc)).norm()
                                              / flat(gc).norm())))
    cmp_s = time.perf_counter() - t0
    card1 = stages[0]["losses"].cpu().numpy()
    print("[path N] N3 card vs CPU where each stage starts (stage 2 from "
          "the card's stage-1 output): " + "; ".join(
              f"stage {i + 1} loss {a:.4f} / {b:.4f} ({e:.2e} relative), "
              f"gradient {ge:.2e} in norm"
              for i, (a, b, e, ge) in enumerate(start))
          + f"; at stage 2's start {flips} of {i_cpu.numel()} scan points "
          f"take another nearest vertex on the card's mesh than on the "
          f"CPU's"
          + f" (tolerances {N_HUMOR_RTOL} and {N_HUMOR_GRAD_RTOL}); the "
          f"card's stage-1 history "
          f"{card1.tolist()}; {cmp_s:.2f} s")
    if not all(e <= N_HUMOR_RTOL and ge <= N_HUMOR_GRAD_RTOL
               for _, _, e, ge in start):
        raise AssertionError("path N3: card and CPU disagree")
    out["n3"] = dict(fit_s=fit_s, evals=evals, k4=k4,
                     host_reads=[st["stats"]["host_reads"] for st in stages],
                     stage_s=[st["seconds"] for st in stages],
                     start=start, flips=flips, cmp_s=cmp_s)


def path_n_helpers(device, out):
    """N4: estimate_translation, the torch Procrustes functions and
    rot6d_to_aa on seeded inputs, card against CPU."""
    import numpy as np
    import torch
    from nemo_tpu_torch import geometry as geo
    rng = np.random.default_rng(11)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    B = 960
    S = f32(0.3 * rng.standard_normal((B, 49, 3)))
    t_true = f32(np.stack([0.2 * rng.standard_normal(B),
                           0.2 * rng.standard_normal(B),
                           8 + rng.random(B)], 1))
    p = S + t_true[:, None]
    j2d = 5000.0 * p[..., :2] / p[..., 2:] + 112.0 + f32(
        rng.standard_normal((B, 49, 2)))
    conf = f32(rng.random((B, 49)))
    S2 = f32(1.2 * S.numpy() @ np.linalg.qr(rng.standard_normal((3, 3)))[0]
             + 0.01 * rng.standard_normal((B, 49, 3)))
    x6 = f32(rng.standard_normal((B, 24, 6)))
    cases = {
        "estimate_translation": (lambda d: geo.estimate_translation(
            S.to(d), j2d.to(d), conf.to(d)), N_SVD_RTOL),
        "similarity_transform": (lambda d: geo.similarity_transform(
            S.to(d), S2.to(d))[0], N_SVD_RTOL),
        "rigid_transform": (lambda d: geo.apply_rigid_transform(
            S.to(d), *geo.rigid_transform(S.to(d), S2.to(d))), N_SVD_RTOL),
        "reconstruction_error": (lambda d: geo.reconstruction_error(
            S.to(d), S2.to(d), reduction=None), N_SVD_RTOL),
        "rot6d_to_aa": (lambda d: geo.rot6d_to_aa(x6.to(d)), N_HELPER_RTOL),
    }
    errs = {}
    for name, (fn, tol) in cases.items():
        errs[name] = n_rel(fn(device), fn(torch.device("cpu")))
        if not errs[name] <= tol:
            raise AssertionError(f"path N4: {name} card and CPU disagree "
                                 f"({errs[name]:.2e} > {tol})")
    print("[path N] N4 helpers at B = 960, card vs CPU (of the largest "
          "entry): " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (tolerance {N_SVD_RTOL} with an SVD or a solve, else "
          f"{N_HELPER_RTOL})")
    out["n4"] = errs


def path_n(device, smpl, d, prox):
    """VPoser training, the IK engine and the L-BFGS HuMoR stages on the
    card, each step at full width: N1 path_n_ik, N2 path_n_vposer, N3
    path_n_humor (prox: path K's fit-prox arguments), N4 path_n_helpers.
    K1f, K1b and K4 must have launched. Prints each part's seconds."""
    root = os.path.join(d, "path_n")
    os.makedirs(root)
    out, secs = {}, {}

    def run():
        import torch
        for name, fn in (("N1", lambda: path_n_ik(device, smpl, out)),
                         ("N2", lambda: path_n_vposer(device, smpl, root,
                                                      out)),
                         ("N3", lambda: path_n_humor(device, prox, out)),
                         ("N4", lambda: path_n_helpers(device, out))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs[name] = round(time.perf_counter() - t0, 3)

    counts, _ = run_path("path N", ("fk_fwd", "fk_bwd", "chamfer_nn"), run)
    out["seconds"] = sum(secs.values())
    mine = {k: counts[k] for k in ("fk_fwd", "fk_bwd", "chamfer_nn")}
    print(f"[path N] launches {json.dumps(mine)}; seconds {json.dumps(secs)}"
          f", {out['seconds']:.1f} in all; {nvidia_smi_line()}")
    return counts, out


O_SYNTH, O_SEQ, O_BATCH, O_EPOCHS = 4096, 10, 256, 3  # humor_tool train
O_MILESTONE = 2         # --sched_milestones; scheduled sampling 1 -> 2
O_TIMED = 10            # back-to-back train steps timed on the card
O_CHECK_B = 64          # windows a card-vs-CPU train step
O_STAT_RTOL = 1e-5      # a step's statistics, card vs CPU, relative
O_STATE_RTOL = 1e-6     # updated tensors and Adam moments, card vs CPU, of
#                         each tensor's largest entry
O_AMASS_WALKS = 4       # seeded raw walks of O_AMASS_T frames at 120 fps
O_AMASS_T = 1200
O_SMPL_B = 512          # O2's transitions through the SMPL terms
O_SMPL_RTOL = 1e-5      # O2's loss, card vs CPU, relative
O_SMPL_GRAD_RTOL = 1e-4  # O2's gradients, of each tensor's largest entry
O_GATE_ABS = 1e-5       # a ReLU gate card and CPU take differently: its
#                         GroupNorm output within this of 0 on both sides
O_GATE_SHARE = 0.01     # at most this share of O2's transitions
O_EM_CHECKED = 20       # EM iterations held card vs CPU
O_EM_RTOL = 1e-4        # their log-likelihoods, relative
O_EVAL_N = 64           # held-out windows of humor_eval_*
O_EVAL_RTOL = 1e-5      # humor_eval_* card vs CPU, relative


def o_profile(fn) -> dict:
    """Device time of one call of fn from a torch.profiler trace of the
    device alone, read from the profiler's raw events (the parsed event
    tree of a step of some 16,000 kernels takes tens of seconds to build):
    fn, a marker kernel (torch.cuda._sleep's spin_kernel), fn again; every
    device event after the marker is the second call's, so a trace that
    loses its first launches loses none of them. {device_ms,
    device_events, top: the six largest by name}, or None where the trace
    holds no marker."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
    dev = [(e.name(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    marks = [t + d for n, t, d in dev if "spin_kernel" in n]
    if not marks:
        return None
    dev = [(n, d) for n, t, d in dev if t >= max(marks)]
    by_name = {}
    for n, d in dev:
        by_name[n] = by_name.get(n, 0) + d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"device_ms": sum(by_name.values()) / 1e6,
            "device_events": len(dev),
            "top": [(n[:60], ns / 1e6) for n, ns in top]}


def o_rel_state(got, want):
    """[(largest |got - want| over want's largest entry, name)] over two
    (params, Adam state) pairs from humor_train_state_to_jax, worst first."""
    out = []
    for m, sub in want[0].items():
        for k, v in sub.items():
            out.append((n_rel(got[0][m][k], v), f"{m}.{k}"))
    for k, v in want[1].items():
        if not k.endswith(".count"):
            out.append((n_rel(got[1][k], v), k))
    return sorted(out, reverse=True)


def path_o_train(device, files, root, out):
    """O1: HuMoR training through python -m nemo_tpu_torch.cli.humor_tool
    train's main on the card at the reference widths (HumorConfig's
    1024-wide GroupNorm MLPs, latent 48, contacts predicted): --synthetic
    O_SYNTH windows of O_SEQ transitions at batch O_BATCH for O_EPOCHS
    epochs with scheduled sampling from epoch 1 to 2 and a milestone at 2
    (2560 transitions a step); a supervised run on --amass over a tree
    that process-amass made from O_AMASS_WALKS seeded raw walks; one
    --shards run. From the synthetic run's final state: O_TIMED
    back-to-back steps (steps/s) and one under torch.profiler (o_profile:
    busy share, largest kernels); a step under set_sync_debug_mode("error"); a NaN
    batch skipped with the parameters bit for bit; humor_params.npz
    through _humor_params bit for bit; three steps at epochs 1, 2, 2 on
    the card and the CPU from that state with the same batches of
    O_CHECK_B windows and draws (GT past, then carried predictions past
    the milestone), the CPU on the card's ReLU gates (humor_gates), each
    gate the CPU would set otherwise within O_GATE_ABS of 0."""
    import numpy as np
    import torch
    from nemo_tpu_torch.cli import humor_tool
    from nemo_tpu_torch.data.sharded import write_shards
    from nemo_tpu_torch.models import humor as hm
    from nemo_tpu_torch.models import humor_loss as hl
    secs, fails = {}, []
    real_make = hl.make_humor_full_train_step
    seen = {"steps": 0}

    def recording_make(*a, **k):
        init, step = real_make(*a, **k)

        def init_rec(params):
            seen["params"], seen["opt"] = params, init(params)
            return seen["opt"]

        def step_rec(params, opt, x_past, x_t, epoch, **kw):
            seen["steps"] += 1
            return step(params, opt, x_past, x_t, epoch, **kw)
        return init_rec, step_rec

    def cli(name, argv):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hl.make_humor_full_train_step = recording_make
        try:
            if humor_tool.main(argv) != 0:
                raise AssertionError(f"path O1: humor_tool {name} failed")
        finally:
            hl.make_humor_full_train_step = real_make
        torch.cuda.synchronize()
        secs[name] = round(time.perf_counter() - t0, 3)

    synth = os.path.join(root, "synthetic")
    flags = ["--seq_len", str(O_SEQ), "--batch_size", str(O_BATCH),
             "--epochs", str(O_EPOCHS), "--sched_samp_start", "1",
             "--sched_samp_end", "2", "--sched_milestones",
             str(O_MILESTONE)]
    cli("train --synthetic", ["train", "--synthetic", str(O_SYNTH),
                              "--out", synth] + flags)
    steps = seen["steps"]
    with open(os.path.join(synth, "train_stats.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    print(f"[path O] O1 train --synthetic {O_SYNTH}: {steps} steps in "
          f"{secs['train --synthetic']:.2f} s; epochs " + "; ".join(
              f"{r['epoch']}: loss {r['loss']:.4f} kl {r['kl_loss']:.4f} "
              f"lr {r['lr']:.2e} grad_norm {r['grad_norm']:.3f} skipped "
              f"{r['update_skipped']:.2f} ({r['sec']} s)" for r in rows))
    if steps != O_EPOCHS * (O_SYNTH // O_BATCH) or len(rows) != O_EPOCHS \
            or not all(np.isfinite(r["loss"]) and r["update_skipped"] == 0
                       for r in rows) \
            or not rows[-1]["lr"] < rows[0]["lr"]:
        raise AssertionError("path O1: the synthetic run's statistics")
    params, opt = seen["params"], seen["opt"]
    loaded = humor_tool._humor_params(os.path.join(synth,
                                                   "humor_params.npz"),
                                      hm.HumorConfig(), 0, device)
    if not all(torch.equal(loaded[m][k], v.detach())
               for m, sub in params.items() for k, v in sub.items()):
        raise AssertionError("path O1: humor_params.npz does not load back "
                             "bit for bit")
    state = hm.humor_train_state_to_jax(params, opt)

    # the supervised --amass run on a process-amass tree, and --shards
    raw = os.path.join(root, "raw")
    for s in range(O_AMASS_WALKS):
        raw_amass_walk(os.path.join(raw, "CMU", f"S{s}", "walk_poses.npz"),
                       T=O_AMASS_T, seed=s)
    proc = os.path.join(root, "proc")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if humor_tool.main(["process-amass", "--amass_root", raw, "--out", proc,
                        "--smpl_path", files["smpl_npz"]]) != 0:
        raise AssertionError("path O1: process-amass failed")
    secs["process-amass"] = round(time.perf_counter() - t0, 3)
    cli("train --amass", ["train", "--amass", proc, "--seq_len",
                          str(O_SEQ), "--batch_size", "32", "--epochs", "2",
                          "--out", os.path.join(root, "amass")])
    windows = humor_tool._synthetic_windows(np.random.default_rng(0),
                                            O_SYNTH, O_SEQ, 207)
    write_shards({"states": windows[:2 * O_BATCH]},
                 os.path.join(root, "shards"), shard_size=100)
    cli("train --shards", ["train", "--shards", os.path.join(root, "shards"),
                           "--batch_size", str(O_BATCH // 2), "--epochs", "1",
                           "--out", os.path.join(root, "shards_run")])
    for run in ("amass", "shards_run"):
        with open(os.path.join(root, run, "train_stats.jsonl")) as f:
            last = [json.loads(line) for line in f][-1]
        print(f"[path O] O1 train {run}: loss {last['loss']:.4f}, "
              f"grad_norm {last['grad_norm']:.3f}")
        if not np.isfinite(last["loss"]):
            raise AssertionError(f"path O1: train {run}'s loss")

    # from the synthetic run's final state: rate, profile, no sync, NaN
    t_rate = time.perf_counter()
    init, step = real_make(hm.HumorConfig(), hl.HumorLossConfig(
        kl_loss=4e-4, contacts_loss=0.01), lr=1e-4,
        sched_milestones=(O_MILESTONE,), sched_decay=0.1,
        sched_samp_start=1, sched_samp_end=2,
        generator=torch.Generator(device=device).manual_seed(1))
    p, o = hm.humor_train_state_from_jax(*state, device=device)
    win = torch.as_tensor(windows[:O_BATCH], device=device)
    x_past, x_t = win[:, :-1], win[:, 1:]
    for _ in range(2):
        step(p, o, x_past, x_t, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(O_TIMED):
        step(p, o, x_past, x_t, 2)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / O_TIMED
    prof = o_profile(lambda: step(p, o, x_past, x_t, 2))
    if prof is None:
        raise AssertionError("path O1: the profiler's trace holds no "
                             "marker")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(p, o, x_past, x_t, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    bad = x_past.clone()
    bad[3, 0, 10] = float("nan")   # the first transition: always read
    before = {m: {k: v.detach().clone() for k, v in sub.items()}
              for m, sub in p.items()}
    count = o.count
    _, _, st = step(p, o, bad, x_t, 2)
    skipped = float(st["update_skipped"])
    same = all(torch.equal(v, before[m][k]) for m, sub in p.items()
               for k, v in sub.items())
    print(f"[path O] O1 a train step on the card at {O_BATCH} x {O_SEQ} "
          f"transitions, scheduled sampling on carried predictions: "
          f"{1e3 / step_ms:.3f} steps/s ({step_ms:.3f} ms, {O_TIMED} "
          f"back-to-back steps); torch.profiler (one step): device "
          f"{prof['device_ms']:.3f} ms in {prof['device_events']:.0f} kernels "
          f"and copies, busy {prof['device_ms'] / step_ms:.1%} of the step; "
          "largest " + "; ".join(f"{n} {ms:.3f} ms" for n, ms in prof["top"])
          + f"; a step ran without a device synchronisation; a NaN batch: "
          f"update_skipped {skipped}, parameters bit for bit {same}, Adam's "
          f"count {count} -> {o.count}")
    if skipped != 1.0 or not same or o.count != count + 1:
        raise AssertionError("path O1: the NaN batch was not skipped")
    secs["rate, profile, no sync, NaN"] = round(time.perf_counter() - t_rate,
                                                3)

    # card vs CPU: three steps from the final state, the same batches and
    # draws
    res = {}
    gen = torch.Generator().manual_seed(11)
    batches = []
    for i, epoch in enumerate((1, O_MILESTONE, O_MILESTONE)):
        w = windows[O_BATCH * (i + 1):O_BATCH * (i + 1) + O_CHECK_B]
        batches.append((epoch, w, hl.scheduled_draws(
            gen, hl.sched_samp_gt_p(epoch, 1, 2), O_SEQ, O_CHECK_B, 48)))
    gates, flips = [], []
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        p, o = hm.humor_train_state_from_jax(*state, device=dev)
        stats = []
        with (humor_gates(record=gates) if where == "card"
              else humor_gates(impose=gates, flips=flips)):
            for epoch, w, (coins, eps) in batches:
                wt = torch.as_tensor(w, device=dev)
                p, o, st = step(p, o, wt[:, :-1], wt[:, 1:], epoch,
                                draws=(coins.to(dev), eps.to(dev)))
                stats.append(hl.stats_to_host(st))
        res[where] = (stats, hm.humor_train_state_to_jax(p, o))
        secs[f"check {where}"] = round(time.perf_counter() - t0, 3)
    stat_err = max(abs(cs[k] - v) / max(abs(v), 1e-30)
                   for cs, vs in zip(res["card"][0], res["cpu"][0])
                   for k, v in vs.items())
    worst = o_rel_state(res["card"][1], res["cpu"][1])
    far = max(flips, default=0.0)
    print(f"[path O] O1 three steps (epochs 1, 2, 2; {O_CHECK_B} x {O_SEQ} "
          f"transitions; the CPU on the card's ReLU gates, {len(flips)} of "
          f"{len(gates)} GroupNorm calls with a gate its own rounding sets "
          f"otherwise, the farthest from 0 at {far:.2e}, tolerance "
          f"{O_GATE_ABS}) card vs CPU: statistics worst {stat_err:.2e} "
          f"relative (tolerance {O_STAT_RTOL}), lr "
          f"{[s['lr'] for s in res['card'][0]]}; updated tensors and Adam "
          f"moments worst " + "; ".join(f"{k} {e:.2e}" for e, k in worst[:6])
          + f" (tolerance {O_STATE_RTOL}); seconds {json.dumps(secs)}")
    if not stat_err <= O_STAT_RTOL:
        fails.append("O1 statistics card vs CPU")
    if not worst[0][0] <= O_STATE_RTOL:
        fails.append("O1 updated tensors card vs CPU")
    if not far <= O_GATE_ABS:
        fails.append("O1 ReLU gates card vs CPU")
    out["o1"] = dict(secs=secs, steps=steps, step_ms=step_ms,
                     steps_s=1e3 / step_ms, stat_err=stat_err,
                     state_err=worst[0][0], state_worst=worst[0][1],
                     windows=windows, **prof)
    return params, fails


@contextlib.contextmanager
def humor_gates(record=None, impose=None, flips=None):
    """HuMoR's ReLU gates after each GroupNorm, call by call, for O1's
    three-step card-vs-CPU check. With ``record`` (the card) each call's
    gates (its output > 0) are appended; with ``impose`` (the CPU) each call
    takes the next recorded gates: the eager composition's value where the
    card's gate is open, 0 where it is shut, and ``flips`` gets the largest
    |value| where the CPU's own rounding would have set a gate otherwise.
    Adam's state after three steps with carried predictions follows every
    gate: on the CPU a 1e-7 relative change of the windows moves its moments
    by up to 7.7e-3 of a tensor's largest entry, and the card's K7 read
    2.07e-4 against the eager CPU (H100 runs); with the card's gates the
    two sides differ by their arithmetic alone. So O1 does not test K7's
    mask within O_GATE_ABS of 0 (a flipped gate that near 0 passes): O2's
    gate check, which reads K7's own pre-ReLU values, and gn_phase and the
    gpu tests (tests/test_torch_port_gpu.py), which hold K7's output and
    gradients against the eager composition, test it on their own."""
    import torch
    from nemo_tpu_torch.models import humor as hm
    route = hm._gn_relu
    gates = None if impose is None else iter(impose)

    def gn_relu(x, gamma, beta, groups):
        if gates is None:
            y = route(x, gamma, beta, groups)
            record.append((y > 0).cpu())
            return y
        gate = next(gates)
        z = hm._group_norm(x, gamma, beta, groups)
        moved = (z > 0) != gate
        if bool(moved.any()):
            flips.append(float(z.detach()[moved].abs().max()))
        return torch.where(gate, z, torch.zeros_like(z))
    hm._gn_relu = gn_relu
    try:
        yield
    finally:
        hm._gn_relu = route
    if gates is not None and next(gates, None) is not None:
        raise AssertionError("humor_gates: the CPU made fewer GroupNorm "
                             "calls than the card")


def pre_relu(x, gamma, beta, groups):
    """GroupNorm's output before HuMoR's ReLU as apply_mlp's route computes
    it: on a CUDA float32 tensor K7's, as relu(z) - relu(-z) (K7 with gamma
    and beta negated gives relu(-z): fmaf with negated operands is the exact
    negation), the eager composition elsewhere."""
    import torch
    from nemo_tpu_torch.models.humor import _group_norm
    from nemo_tpu_torch.ops.groupnorm import group_norm_relu
    if x.is_cuda and x.dtype == torch.float32:
        return (group_norm_relu(x, gamma, beta, groups)
                - group_norm_relu(x, -gamma, -beta, groups))
    return _group_norm(x, gamma, beta, groups)


def humor_pre_relu(p, cfg, past, tgt, eps):
    """{(module, layer): the GroupNorm output that each ReLU of the three
    HuMoR MLPs reads}, as models/humor.apply_mlp computes it for
    humor_single_step's posterior, prior and decoder (eps the posterior
    draw): K7's on the card (pre_relu). Rows are samples: GroupNorm and the
    MLPs act on each alone."""
    import torch
    from nemo_tpu_torch.models.humor import humor_posterior
    with torch.no_grad():
        qm, qv = humor_posterior(p, cfg, past, tgt)
        z = qm + eps * torch.sqrt(qv)
        ins = {"encoder": (torch.cat([past, tgt], 1), 5, None),
               "prior": (past, 5, None),
               "decoder": (torch.cat([past, z], 1), 4, z)}
        out = {}
        for name, (x, n, skip) in ins.items():
            q = p[name]
            x = x @ q["w0"] + q["b0"]
            for i in range(1, n):
                g = pre_relu(x, q[f"gn{i}_g"], q[f"gn{i}_b"],
                             cfg.num_groups)
                out[(name, i)] = g
                r = torch.relu(g)
                if skip is not None:
                    r = torch.cat([r, skip], 1)
                x = r @ q[f"w{i}"] + q[f"b{i}"]
    return out


def path_o_smpl(device, smpl, params, windows, out):
    """O2: humor_full_loss with the three SMPL terms at weight 1
    (smpl_terms_fn on the port's smpl_forward, the 6890-vertex body) on
    O_SMPL_B transitions of O1's windows through O1's trained weights,
    forward and backward: two K1f (the predicted and the GT bodies) and one
    K1b; the pass's device time and K1's a launch from torch.profiler. Card
    vs CPU (K1's plain version there): the loss, and every gradient on the
    transitions whose ReLU gates the two take alike. A gate that the card's
    and the CPU's f32 sums put on either side of 0 moves a whole
    GroupNorm group's gradient for its transition (a decoder gate 2.4e-7
    from 0 moved 64 columns of decoder.w1 by 5.4e-3 of its largest entry,
    float32 at two CPU threads against float64,
    scripts/torch_humor_grad_spread.py); such transitions are left out of
    the gradient comparison, each flipped gate within O_GATE_ABS of 0 on
    both sides, at most O_GATE_SHARE of the batch."""
    import torch
    from nemo_tpu_torch.models import humor as hm
    from nemo_tpu_torch.models import humor_loss as hl
    from nemo_tpu_torch.ops import launch_counts
    cfg = hm.HumorConfig()
    lcfg = hl.HumorLossConfig(kl_loss=4e-4, smpl_joint_loss=1.0,
                              smpl_mesh_loss=1.0,
                              smpl_joint_consistency_loss=1.0)
    w = windows[-(O_SMPL_B // O_SEQ + 1):]
    data = [torch.as_tensor(w[:, :-1].reshape(-1, 207)[:O_SMPL_B]),
            torch.as_tensor(w[:, 1:].reshape(-1, 207)[:O_SMPL_B])]
    gen = torch.Generator().manual_seed(12)
    data += [torch.randn((O_SMPL_B, 48), generator=gen),
             0.3 * torch.randn((O_SMPL_B, 10), generator=gen)]
    res, fails = {}, []
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        p = {m: {k: v.detach().to(dev).requires_grad_(True)
                 for k, v in sub.items()} for m, sub in params.items()}
        leaves = [p[m][k] for m, k in hm.humor_leaves(p)]
        smpl_fn = hl.smpl_terms_fn(smpl.to(dev))
        args = [a.to(dev) for a in data]

        def fwd_bwd(rows=None, p=p, leaves=leaves, smpl_fn=smpl_fn,
                    args=args):
            a = args if rows is None else [x[rows] for x in args]
            loss, stats = hl.humor_full_loss(p, cfg, lcfg, a[0], a[1], a[2],
                                             0, smpl_fn=smpl_fn, betas=a[3])
            return loss, stats, torch.autograd.grad(loss, leaves)

        if where == "card":
            torch.cuda.synchronize()
            c0 = launch_counts()
        loss, stats, grads = fwd_bwd()
        if where == "card":
            torch.cuda.synchronize()
            c1 = launch_counts()
            k1 = {k: c1[k] - c0[k] for k in ("fk_fwd", "fk_bwd")}
            t0 = time.perf_counter()
            for _ in range(O_TIMED):
                fwd_bwd()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / O_TIMED
            prof = m_profile(fwd_bwd, mark="path_o_smpl",
                             k1_per_step=(2, 1))
        res[where] = dict(loss=float(loss.detach()),
                          stats=hl.stats_to_host(stats),
                          pre=humor_pre_relu(p, cfg, *args[:3]),
                          fwd_bwd=fwd_bwd)
    flips, far = set(), 0.0
    for key, a in res["cpu"]["pre"].items():
        b = res["card"]["pre"][key].cpu()
        flip = (a > 0) != (b > 0)
        if flip.any():
            flips.update(torch.nonzero(flip.any(1)).flatten().tolist())
            far = max(far, float(a[flip].abs().max()),
                      float(b[flip].abs().max()))
    kept = torch.tensor([i for i in range(O_SMPL_B) if i not in flips])
    grads = {where: [g.cpu() for g in r["fwd_bwd"](kept.to(
        device if where == "card" else "cpu"))[2]]
        for where, r in res.items()}
    loss_err = abs(res["card"]["loss"] - res["cpu"]["loss"]) / abs(
        res["cpu"]["loss"])
    names = [f"{m}.{k}" for m, k in hm.humor_leaves(params)]
    gerr = sorted(((n_rel(a, b), n) for a, b, n in zip(
        grads["card"], grads["cpu"], names)), reverse=True)
    print(f"[path O] O2 humor_full_loss with the SMPL terms at B = "
          f"{O_SMPL_B} (6890 vertices): loss card {res['card']['loss']:.6f} "
          f"CPU {res['cpu']['loss']:.6f} ({loss_err:.2e} relative, tolerance "
          f"{O_SMPL_RTOL}); smpl terms " + ", ".join(
              f"{k} {res['card']['stats'][k]:.6f}" for k in (
                  "smpl_joint_loss", "smpl_mesh_loss",
                  "smpl_joint_consistency_loss"))
          + f"; ReLU gates taken differently in {len(flips)} transitions "
          f"(the farthest from 0 at {far:.2e}; tolerance {O_GATE_ABS}, at "
          f"most {O_GATE_SHARE:.0%} of the batch), left out of the "
          "gradients, worst " + "; ".join(f"{n} {e:.2e}"
                                          for e, n in gerr[:4])
          + f" (tolerance {O_SMPL_GRAD_RTOL}); launches a forward and "
          f"backward {json.dumps(k1)}; {ms:.3f} ms a forward and backward "
          f"({O_TIMED} back to back), device {prof['device_ms']:.3f} ms in "
          f"{prof['device_events']:.0f} kernels; K1f "
          + device_ms_text(prof["k1f_ms"], 10) + ", K1b "
          + device_ms_text(prof["k1b_ms"], 5) + " a launch")
    if k1 != {"fk_fwd": 2, "fk_bwd": 1}:
        fails.append("O2 launched other than two K1f and one K1b")
    if not loss_err <= O_SMPL_RTOL:
        fails.append("O2 loss card vs CPU")
    if not far <= O_GATE_ABS or len(flips) > O_GATE_SHARE * O_SMPL_B:
        fails.append("O2 ReLU gates card vs CPU")
    if not gerr[0][0] <= O_SMPL_GRAD_RTOL:
        fails.append("O2 gradients card vs CPU")
    out["o2"] = dict(loss_err=loss_err, grad_err=gerr[0][0], ms=ms, k1=k1,
                     flips=len(flips), **prof)
    return fails


def path_o_state_prior(device, root, windows, out):
    """O3: python -m nemo_tpu_torch.cli.humor_tool train-state-prior's main
    at its defaults (a seeded 12-component mixture of 4000 states, D 138,
    100 EM iterations) on the card, and with --states on
    states_from_sequences of O1's windows; each prior_gmm.npz through
    load_init_motion_prior with a finite init_state_gmm_nll; EM card vs
    CPU from the same k-means++ means over O_EM_CHECKED iterations."""
    import numpy as np
    import torch
    from nemo_tpu_torch.cli import humor_tool
    from nemo_tpu_torch.models import humor_fit
    from nemo_tpu_torch.models import humor_state_prior as hsp
    real_fit = hsp.fit_state_prior_gmm
    curves, secs, fails = [], {}, []

    def recording_fit(*a, **k):
        gmm, ll = real_fit(*a, **k)
        curves.append(ll.cpu().numpy())
        return gmm, ll

    states = hsp.states_from_sequences(torch.as_tensor(windows)).numpy()
    np.save(os.path.join(root, "states.npy"), states)
    for name, argv in (("defaults", []),
                       ("--states", ["--states",
                                     os.path.join(root, "states.npy")])):
        d = os.path.join(root, f"prior_{len(curves)}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hsp.fit_state_prior_gmm = recording_fit
        try:
            if humor_tool.main(["train-state-prior", "--out", d] + argv):
                raise AssertionError("path O3: train-state-prior failed")
        finally:
            hsp.fit_state_prior_gmm = real_fit
        torch.cuda.synchronize()
        secs[name] = round(time.perf_counter() - t0, 3)
        prior = humor_fit.load_init_motion_prior(d, device)
        nll = [float(humor_fit.init_state_gmm_nll(
            torch.as_tensor(s, device=device), prior))
            for s in (states[0], states[-1])]
        ll = curves[-1]
        print(f"[path O] O3 train-state-prior {name}: {secs[name]:.2f} s, "
              f"log-likelihood {ll[0]:.4f} -> {ll[-1]:.4f} over {len(ll)} "
              f"iterations; init_state_gmm_nll {nll[0]:.3f}, {nll[1]:.3f}")
        if not np.isfinite(ll[-1]) or not all(np.isfinite(nll)):
            fails.append(f"O3 {name}: non-finite")

    rng = np.random.default_rng(0)      # the CLI's synthetic mixture
    centers = rng.standard_normal((12, 138)) * 2.0
    comp = rng.integers(0, 12, 4000)
    x = (centers[comp] + rng.standard_normal((4000, 138)) * 0.3).astype(
        np.float32)
    init = hsp._kmeans_init(torch.as_tensor(x, device=device), 12,
                            torch.Generator(device=device).manual_seed(0))
    lls = {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        _, ll = real_fit(x, 12, O_EM_CHECKED, init_means=init.to(dev),
                         device=dev)
        lls[where] = ll.cpu().numpy().astype(np.float64)
        secs[f"EM {where}"] = round(time.perf_counter() - t0, 3)
    err = float(np.max(np.abs(lls["card"] - lls["cpu"])
                       / np.abs(lls["cpu"])))
    print(f"[path O] O3 EM card vs CPU from the same means, "
          f"{O_EM_CHECKED} iterations: log-likelihood {lls['card'][0]:.4f} "
          f"-> {lls['card'][-1]:.4f}, worst {err:.2e} relative (tolerance "
          f"{O_EM_RTOL}); seconds {json.dumps(secs)}")
    if not err <= O_EM_RTOL:
        fails.append("O3 EM card vs CPU")
    out["o3"] = dict(secs=secs, em_err=err, ll=[float(c[-1])
                                                for c in curves])
    return fails


def path_o_eval(device, params, out):
    """O4: humor_eval_metrics, _full_test, _sampling and _recon on O1's
    trained weights over O_EVAL_N windows that O1 did not train on, card
    vs CPU, the sampled paths with the same draws on both."""
    import numpy as np
    import torch
    from nemo_tpu_torch.cli import humor_tool
    from nemo_tpu_torch.models import humor as hm
    from nemo_tpu_torch.models import humor_eval as he
    x = humor_tool._synthetic_windows(np.random.default_rng(1), O_EVAL_N,
                                      O_SEQ, 207)
    cfg = hm.HumorConfig()
    gen = torch.Generator().manual_seed(13)
    full_draws = [torch.randn((8 * O_SEQ, 48), generator=gen)
                  for _ in range(O_EVAL_N // 8)]
    samp_draws = [torch.randn((O_EVAL_N, 48), generator=gen)
                  for _ in range(3 * O_SEQ)]
    res, secs = {}, {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        p = hm.humor_to({m: {k: v.detach() for k, v in sub.items()}
                         for m, sub in params.items()}, dev)
        fd, sd = iter(list(full_draws)), iter(list(samp_draws))
        t0 = time.perf_counter()
        res[where] = {
            "metrics": he.humor_eval_metrics(p, cfg, x),
            "full_test": he.humor_eval_full_test(
                p, cfg, x, draw=lambda shape: next(fd)),
            "sampling": he.humor_eval_sampling(
                p, cfg, x, draw=lambda shape: next(sd)),
            "recon": he.humor_eval_recon(p, cfg, x)}
        secs[where] = round(time.perf_counter() - t0, 3)
    errs = {}
    for fn, vals in res["cpu"].items():
        errs[fn] = max(abs(res["card"][fn][k] - v) / max(abs(v), 1e-12)
                       for k, v in vals.items())
    c = res["card"]
    print(f"[path O] O4 humor_eval_* on {O_EVAL_N} held-out windows: "
          f"one_step_rec {c['metrics']['one_step_rec']:.4f}, rollout_drift "
          f"{c['metrics']['rollout_drift']:.4f}, prior_kl "
          f"{c['metrics']['prior_kl']:.4f}, full-test loss "
          f"{c['full_test']['loss']:.4f}, sample_diversity "
          f"{c['sampling']['sample_diversity']:.4f}, recon_l2 "
          f"{c['recon']['recon_l2']:.4f}; card vs CPU worst relative "
          + json.dumps({k: float(f"{v:.2e}") for k, v in errs.items()})
          + f" (tolerance {O_EVAL_RTOL}); seconds {json.dumps(secs)}")
    out["o4"] = dict(errs=errs, secs=secs)
    return [f"O4 {k} card vs CPU" for k, v in errs.items()
            if not v <= O_EVAL_RTOL]


def path_o(device, smpl, files, d):
    """HuMoR training on the card, at the reference widths: O1
    path_o_train, O2 path_o_smpl, O3 path_o_state_prior, O4 path_o_eval.
    K1f (process-amass, O2) and K1b (O2) must have launched. Every part
    runs and prints before a failed check raises. Prints each part's
    seconds."""
    root = os.path.join(d, "path_o")
    os.makedirs(root)
    out, secs, fails = {}, {}, []

    def run():
        import torch
        params = {}

        def o1():
            p, f = path_o_train(device, files, root, out)
            params.update(p)
            fails.extend(f)

        for name, fn in (
                ("O1", o1),
                ("O2", lambda: fails.extend(path_o_smpl(
                    device, smpl, params, out["o1"]["windows"], out))),
                ("O3", lambda: fails.extend(path_o_state_prior(
                    device, root, out["o1"]["windows"], out))),
                ("O4", lambda: fails.extend(path_o_eval(device, params,
                                                        out)))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs[name] = round(time.perf_counter() - t0, 3)

    counts, _ = run_path("path O", ("fk_fwd", "fk_bwd"), run)
    out["seconds"] = sum(secs.values())
    mine = {k: counts[k] for k in ("fk_fwd", "fk_bwd")}
    print(f"[path O] launches {json.dumps(mine)}; seconds {json.dumps(secs)}"
          f", {out['seconds']:.1f} in all; {nvidia_smi_line()}")
    if fails:
        raise AssertionError(f"path O: {fails}")
    return counts, out


P_PIX_TOL = 1.0 / 255   # path P: the pretty scene, card against the CPU
P_PIX_SHARE = 1e-4      # at most this share of pixels differ by more
P_JOINT_VIEWS, P_JOINT_FRAMES = 2, 2   # per-joint frames: 1000 x 1900 PNGs


def p_bundle(bundle, path):
    """The smoke's bundle with a GLAMR world baseline (the GT motion, its
    poses moved by a seeded 0.05 rad, its roots by (0.3, 0, 0.1) m),
    written to path and read back."""
    import dataclasses
    import numpy as np
    from nemo_tpu_torch.data.bundle import MultiViewBundle
    rng = np.random.RandomState(5)
    V, F = bundle.num_views, bundle.num_frames
    g = (bundle.gt3d_pose + 0.05 * rng.randn(*bundle.gt3d_pose.shape)
         ).astype(np.float32)
    b = dataclasses.replace(
        bundle, glamr_orient=g[..., :3],
        glamr_trans=bundle.gt3d_trans + np.float32([0.3, 0.0, 0.1]),
        baseline_poses={**(bundle.baseline_poses or {}), "glamr":
                        np.concatenate([g[..., 3:], np.zeros((V, F, 3),
                                                             np.float32)],
                                       -1)})
    b.save(path)
    return MultiViewBundle.load(path)


def path_p(device, smpl, bundle):
    """The rest of render/ at full width (8 views x 120 frames, 1000 x
    1900, the 6890-vertex body) on the reference configuration's initial
    motion: the input figure, the mv figure (8 x 8 panels), the pretty
    rollout (8 rows, each 6 people and the ground in one K5s scene), the
    pretty individual figure (6 bodies), the 3D rollout (2 x 10), the GT,
    pred-in-GT and GLAMR rollouts through the GT cameras (8 x 8 each) on a
    bundle written with GLAMR slots, the per-joint frames (2 views x 2
    frames) and the root trajectories (their PNGs skipped where
    matplotlib is missing). Outside the launch count: one pretty scene's
    K5s output bit-identical to the plain fold on the card, and its image
    against the CPU's (at most P_PIX_SHARE of the pixels differ by more
    than P_PIX_TOL)."""
    import numpy as np
    import torch
    from nemo_tpu_torch.eval.metrics import eval_frame_indices
    from nemo_tpu_torch.fit import predict
    from nemo_tpu_torch.geometry.camera import camera_from_params_np
    from nemo_tpu_torch.geometry.rotations import rot6d_to_rotmat_np
    from nemo_tpu_torch.ops import raster
    from nemo_tpu_torch.render import mesh as rmesh
    from nemo_tpu_torch.render import (
        render_3d_rollout_figure, render_global_root_trajectories,
        render_glamr_rollout, render_gt_rollout, render_input_figure,
        render_per_joint_keypoint_frames, render_pred_in_gt_rollout,
        render_pretty_individual_figure, render_pretty_rollout_figure,
        render_rollout_mv_figure)
    cfg = reference_config()
    fitter = make_fitter(device, smpl, bundle, cfg)
    V, F = bundle.num_views, bundle.num_frames
    faces = smpl.faces
    out, secs, spy = {}, {}, {}
    real_pretty = rmesh.render_pretty

    def pretty_spy(*a, **k):
        """The first pretty scene's arguments, image and rasterizer call."""
        if "pretty" in spy:
            return real_pretty(*a, **k)
        real_raster = rmesh.rasterize_triangles_batched

        def raster_spy(*ra, **rk):
            spy["raster"] = (ra, rk)
            return real_raster(*ra, **rk)

        rmesh.rasterize_triangles_batched = raster_spy
        try:
            img = real_pretty(*a, **k)
        finally:
            rmesh.rasterize_triangles_batched = real_raster
        spy["pretty"] = (a, k, img)
        return img

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        secs[name] = round(time.perf_counter() - t0, 3)
        return r

    def run():
        with tempfile.TemporaryDirectory() as d:
            b = p_bundle(bundle, os.path.join(d, "bundle.npz"))
            with torch.no_grad():
                preds = [predict(fitter.params, cfg, fitter.assets,
                                 torch.full((F,), v, device=device),
                                 torch.arange(F, device=device),
                                 want_vertices=True) for v in range(V)]
            verts = np.stack([p["v"].cpu().numpy() for p in preds])
            trans = np.stack([p["trans"].cpu().numpy() for p in preds])
            R0 = rot6d_to_rotmat_np(preds[0]["orient"][0].cpu().numpy())
            cam9 = fitter.params.cameras.detach().cpu().numpy()
            cams = [camera_from_params_np(cam9[v], *IMG_HW) for v in range(V)]
            p = lambda name: os.path.join(d, name)
            grids = {}
            grids["input"] = timed("input", lambda: render_input_figure(
                p("input.png"), b))
            grids["mv"] = timed("mv", lambda: render_rollout_mv_figure(
                p("mv.png"), 0, verts, faces, cams, b, num_frames=8,
                device=device))
            rmesh.render_pretty = pretty_spy
            try:
                grids["pretty"] = timed(
                    "pretty", lambda: render_pretty_rollout_figure(
                        p("pretty.png"), verts, faces, cams, b,
                        num_frames=6, device=device))
            finally:
                rmesh.render_pretty = real_pretty
            fidx = eval_frame_indices(F, 6)
            ind = timed("individual", lambda: render_pretty_individual_figure(
                p("individual"), verts[0, fidx], faces, cams[0], b,
                device=device))
            grids["3d"] = timed("3d", lambda: render_3d_rollout_figure(
                p("3d.png"), verts, faces, b, init_orient_rotmat=R0,
                num_frames=10, device=device))
            grids["gt"] = timed("gt", lambda: render_gt_rollout(
                p("gt.png"), smpl, b, num_frames=8, device=device))
            grids["pred_in_gt"] = timed(
                "pred_in_gt", lambda: render_pred_in_gt_rollout(
                    p("pred_in_gt.png"), smpl, verts, b, num_frames=8,
                    device=device))
            grids["glamr"] = timed("glamr", lambda: render_glamr_rollout(
                p("glamr.png"), smpl, b, num_frames=8, device=device))
            n_joint = timed("joints", lambda: render_per_joint_keypoint_frames(
                p("joints"), b.labels["gt"], b, num_frames=P_JOINT_FRAMES,
                num_views=P_JOINT_VIEWS))
            errs = timed("trajectories", lambda: render_global_root_trajectories(
                p("trajectories"), b.gt3d_trans[0], trans[0],
                b.glamr_trans[0]))
            written = sorted(n for n in os.listdir(d) if n.endswith(".png"))
            joints = sorted(os.listdir(p("joints")))
            sizes = {n: os.path.getsize(p(n)) for n in written}
        conf = b.labels["gt"][:P_JOINT_VIEWS][:, eval_frame_indices(
            F, P_JOINT_FRAMES)][..., 2]
        shapes = {k: list(g.shape) for k, g in grids.items()}
        covered = {k: round(float((np.abs(g - 1.0) > 1e-3).any(-1).mean()),
                            5) for k, g in grids.items()}
        print(f"[path P] grids {json.dumps(shapes)}; covered share "
              f"{json.dumps(covered)}; PNGs {json.dumps(sizes)}; individual "
              f"{[os.path.basename(x) for x in ind]}; per-joint frames "
              f"{n_joint} (e.g. {joints[:2]}); root distances "
              f"{json.dumps(errs)}; seconds {json.dumps(secs)}")
        want_png = sorted(["input.png", "mv.png", "pretty.png", "3d.png",
                           "gt.png", "pred_in_gt.png", "glamr.png"])
        if written != want_png or len(ind) != 6 or \
                n_joint != int((conf > 0.5).sum()) or \
                n_joint != len(joints) or sorted(errs) != ["glamr", "pred"]:
            raise AssertionError("path P: figures or files missing")
        if not all(np.isfinite(g).all() for g in grids.values()) or \
                min(covered[k] for k in ("mv", "pretty", "3d")) < 1e-3:
            raise AssertionError(f"path P: figures empty or not finite "
                                 f"{json.dumps(covered)}")
        out["seconds"] = sum(secs.values())

    counts, _ = run_path("path P", ("fk_fwd", "raster_stream"), run)
    # outside the count: the first pretty scene against the plain fold on
    # the card (bit for bit) and against the CPU's image
    (a, k, img_card), (ra, rk) = spy["pretty"], spy["raster"]
    t0 = time.perf_counter()
    img_cpu = real_pretty(*a, **{**k, "device": "cpu"})
    cpu_s = time.perf_counter() - t0
    diff = np.abs(img_card - img_cpu).max(-1)
    share = float((diff > P_PIX_TOL).mean())
    verts_cam, f_t, foc, ctr, hw = ra
    ent = raster.prepare(verts_cam, f_t, foc, ctr, hw, 32, 128,
                         rk["span"], 1e-3)
    got = raster.raster_stream_cuda(ent, raster.stream_inputs(ent), hw)
    want = raster.rasterize_plain(ent, hw, stream=True)
    same = all(torch.equal(x, y) for x, y in zip(got, want))
    print(f"[path P] a pretty scene ({len(a[0])} people and the ground, "
          f"{verts_cam.shape[1]} vertices, span {rk['span']}): K5s "
          f"bit-identical to the plain fold on the card {same}; card vs "
          f"CPU {share:.2e} of the pixels differ by more than "
          f"{P_PIX_TOL:.5f} (tolerance {P_PIX_SHARE}), largest "
          f"{float(diff.max()):.3e}; the CPU's render {cpu_s:.2f} s; path P "
          f"{out['seconds']:.1f} s; launches K5s {counts['raster_stream']}, "
          f"K1f {counts['fk_fwd']}")
    if not same or not share <= P_PIX_SHARE:
        raise AssertionError("path P: the pretty scene's K5s output or "
                             "image disagrees")
    return counts, out


Q_STEPS = (5, 5, 5)     # warmup, camera and main steps of Q1 and Q2
Q_LOSS_RTOL = 2e-4      # Q2's main-stage losses against Q1's
#                         (tests/test_parallel.py's dp bound, at its depth)
Q_VP_N, Q_VP_B = 512, 128   # Q2's train_vposer: 4 steps of 64 rows a rank
Q_VP_RTOL = 1e-5        # its first step's losses against one rank's
Q_VP_RUN_RTOL = 1e-3    # its fourth step's, after three Adam steps in which
#                         entries whose gradients are f32 noise move by
#                         about the rate either way (as on the CPU tests)
Q_SEEDS, Q_FAN_STEPS = 4, 20   # Q3: fit_many_seeds
RANK_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def q_argv(d, name):
    """The fit CLI's flags for Q1 and Q2: the reference configuration at
    Q_STEPS on path Q's bundle, the synthetic assets, seed 0."""
    from nemo_tpu_torch.cli.fit import build_parser
    cfg = reference_config(warmup_step=Q_STEPS[0], opt_cam_step=Q_STEPS[1],
                           n_steps=Q_STEPS[2])
    return cli_flags(build_parser(), cfg) + [
        "--bundle", os.path.join(d, "bundle.npz"), "--synthetic_assets",
        "--save_every", str(Q_STEPS[2]), "--seed", "0", "--device", "cuda",
        "--out_dir", os.path.join(d, name)]


def q_vposer(smpl, device, mesh):
    """Q2's VPoser training: the 512-wide VPoser on the 6890-vertex body,
    one epoch at batch Q_VP_B over Q_VP_B seeded poses (one step: its
    losses are those of the initial weights) and over Q_VP_N (four);
    (the four-step run's params, the one-step history, the four-step
    history)."""
    import numpy as np
    import torch
    from nemo_tpu_torch.priors import vposer_train as tvt
    from nemo_tpu_torch.priors.vposer import init_vposer
    data = (0.3 * np.random.RandomState(11).randn(Q_VP_N, 63)
            ).astype(np.float32)
    p0 = {k: v.to(device) for k, v in init_vposer(
        generator=torch.Generator().manual_seed(7)).items()}
    cfg = tvt.VPoserTrainConfig(batch_size=Q_VP_B)
    _, first = tvt.train_vposer(p0, data[:Q_VP_B], cfg, num_epochs=1,
                                seed=3, smpl=smpl, mesh=mesh)
    params, run = tvt.train_vposer(p0, data, cfg, num_epochs=1, seed=3,
                                   smpl=smpl, mesh=mesh)
    return params, first, run


def q2_rank(rank: int, port: int, d: str) -> int:
    """One of Q2's two ranks (``chip_smoke.py --q2-rank R PORT DIR``): a
    gloo group on cuda:0, NemoFitter(mesh=make_mesh()) on the CLI's
    assets through the three stages, then train_vposer(mesh=...); writes
    DIR/q2_rank<R>.npz."""
    import numpy as np
    import torch
    from nemo_tpu_torch.cli.fit import build_parser, load_assets
    from nemo_tpu_torch.data.bundle import MultiViewBundle
    from nemo_tpu_torch.fit import NemoConfig, NemoFitter
    from nemo_tpu_torch.ops import launch_counts, reset_launches
    from nemo_tpu_torch.parallel import distributed, make_mesh
    from nemo_tpu_torch.utils.checkpoint import params_to_numpy
    from nemo_tpu_torch.utils.exp import dataclass_from_namespace, merge_config
    distributed.initialize(f"localhost:{port}", 2, rank, device="cuda",
                           backend="gloo")
    mesh = make_mesh(2, device="cuda:0")
    args = merge_config(build_parser(), q_argv(d, "q2"))
    cfg = dataclass_from_namespace(NemoConfig, args)
    assets = load_assets(args, MultiViewBundle.load(
        os.path.join(d, "bundle.npz")), cfg, mesh.device)
    reset_launches()
    fitter = NemoFitter(cfg, assets, seed=args.seed, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with deterministic_cuda():      # as Q1: one trajectory run to run
        fitter.warmup()
        fitter.opt_cam()
        fm = fitter.fit(chunk=cfg.n_steps)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    vp, first, hist = q_vposer(assets.smpl, mesh.device, mesh)
    counts = launch_counts()
    np.savez(os.path.join(d, f"q2_rank{rank}.npz"), fit_s=fit_s,
             counts=json.dumps(counts),
             **{f"main/{k}": v for k, v in fm.items()},
             **{f"params/{k}": v for k, v in
                params_to_numpy(fitter.params).items()},
             **{f"vp/{k}": v.cpu().numpy() for k, v in vp.items()},
             **{f"first/{k}": v for k, v in first.items()},
             **{f"hist/{k}": v for k, v in hist.items()})
    distributed.shutdown()
    return 0


def path_q(device, smpl, bundle):
    """Data parallelism and the seed fan-out at the reference
    configuration (NemoV2, B 512, h_dim 1000, 8 views x 120 frames):
    Q1 the fit CLI's main with --dp 1 under torchrun's environment (an
    NCCL group of one), bit for bit the one-process fit of the same seed,
    both under deterministic_cuda(); Q2 two ranks on cuda:0 over gloo
    (NCCL refuses two ranks on one card), started here (q2_rank), 256 rows
    a rank through the three stages at Q_STEPS under deterministic_cuda():
    the main-stage losses within Q_LOSS_RTOL of Q1's, parameters bit for
    bit equal across the ranks,
    and train_vposer(mesh=...) against one rank; Q3 fit_many_seeds with
    Q_SEEDS seeds x Q_FAN_STEPS steps under deterministic_cuda(), each
    seed bit for bit a lone NemoFitter's main stage. K1f, K1b and K2
    must have launched (Q2's ranks' launches added)."""
    import numpy as np
    import torch
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.cli import fit as fit_cli
    from nemo_tpu_torch.fit import NemoFitter
    from nemo_tpu_torch.parallel import fit_many_seeds
    root = os.path.dirname(os.path.abspath(__file__))
    out, secs, ranks = {}, {}, []

    def q1(d):
        os.environ.update(MASTER_ADDR="localhost",
                          MASTER_PORT=str(free_port()), WORLD_SIZE="1",
                          RANK="0", LOCAL_RANK="0")
        try:
            with deterministic_cuda():
                rc = fit_cli.main(q_argv(d, "q1_dp") + ["--dp", "1"])
        finally:
            for k in RANK_ENV:
                os.environ.pop(k, None)
        with deterministic_cuda():
            rc1 = fit_cli.main(q_argv(d, "q1_one"))
        runs = [os.path.join(d, n, "000000") for n in ("q1_dp", "q1_one")]
        loss = [np.load(os.path.join(r, "losses.npz")) for r in runs]
        ckpt = [np.load(os.path.join(r, "ckpt", f"sd_{Q_STEPS[2]:06d}",
                                     "params.npz")) for r in runs]
        same = rc == rc1 == 0 and sorted(loss[0].files) == sorted(
            loss[1].files) and all(np.array_equal(loss[0][k], loss[1][k])
                                   for k in loss[0].files) and all(
            np.array_equal(ckpt[0][k], ckpt[1][k]) for k in ckpt[1].files)
        print(f"[path Q] Q1 --dp 1 (NCCL, world 1) against one process: "
              f"losses and parameters bit for bit {same}; main-stage "
              f"total_loss {loss[0]['total_loss'].tolist()}")
        if not same:
            raise AssertionError("path Q1: --dp 1 differs from the "
                                 "one-process fit")
        out["q1_total"] = loss[1]["total_loss"]

    def q2(d):
        port = free_port()
        env = dict(os.environ, PYTHONPATH=root)
        for k in RANK_ENV:
            env.pop(k, None)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--q2-rank", str(r),
             str(port), d], cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        try:
            for q in procs:
                logs.append(q.communicate(timeout=600)[0])
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
        for r, (q, log) in enumerate(zip(procs, logs)):
            if q.returncode != 0:
                raise AssertionError(f"path Q2 rank {r} exited "
                                     f"{q.returncode}: {log[-4000:]}")
        ranks.extend(np.load(os.path.join(d, f"q2_rank{r}.npz"))
                     for r in range(2))
        a, b = ranks
        got, want = a["main/total_loss"], out["q1_total"]
        step_rel = np.abs(got - want) / np.abs(want)
        rel = float(step_rel.max())
        keys = [k for k in a.files
                if k.startswith(("params/", "vp/", "first/", "hist/"))]
        same = all(np.array_equal(a[k], b[k]) for k in keys) and \
            np.array_equal(got, b["main/total_loss"])
        _, first_ref, hist_ref = q_vposer(
            synthetic_smpl_model(device=device), device, None)  # the CLI's

        def vp_rel(prefix, ref):
            return max(float(np.abs(a[f"{prefix}/{k}"] - v).max()
                             / max(np.abs(v).max(), 1e-12))
                       for k, v in ref.items())

        vp_first, vp_run = vp_rel("first", first_ref), vp_rel("hist",
                                                             hist_ref)
        print(f"[path Q] Q2 two ranks on cuda:0 over gloo (256 rows a "
              f"rank): main-stage total_loss {got.tolist()}, against Q1 "
              f"relative by step {[float(f'{x:.2e}') for x in step_rel]}: "
              f"at most {rel:.2e} (tolerance {Q_LOSS_RTOL}); "
              f"parameters, losses and VPoser parameters bit for bit equal "
              f"across the ranks {same}; train_vposer(mesh) against one "
              f"rank: the first step's losses {vp_first:.2e} relative "
              f"(tolerance {Q_VP_RTOL}), the fourth's {vp_run:.2e} "
              f"({Q_VP_RUN_RTOL}); the ranks' "
              f"fit seconds {[round(float(x['fit_s']), 3) for x in ranks]}"
              f", launches {[json.loads(str(x['counts'])) for x in ranks]}")
        if not (rel <= Q_LOSS_RTOL and same
                and vp_first <= Q_VP_RTOL and vp_run <= Q_VP_RUN_RTOL):
            raise AssertionError("path Q2: the two-rank fit or VPoser "
                                 "training disagrees")

    def q3():
        cfg = reference_config()
        assets = make_fitter(device, smpl, bundle, cfg).assets
        with deterministic_cuda():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fit_many_seeds(cfg, assets, Q_SEEDS, steps=Q_FAN_STEPS)
            fan_s = time.perf_counter() - t0
            lone = []
            for s in range(Q_SEEDS):
                f = NemoFitter(cfg, assets, seed=s)
                lone.append(f.fit(Q_FAN_STEPS, chunk=Q_FAN_STEPS)
                            ["total_loss"])
        same = all(np.array_equal(res["losses"][s], lone[s])
                   for s in range(Q_SEEDS))
        print(f"[path Q] Q3 fit_many_seeds {Q_SEEDS} seeds x {Q_FAN_STEPS} "
              f"steps: {fan_s:.3f} s, {fan_s / Q_FAN_STEPS:.4f} s a fan-out "
              f"step, {Q_FAN_STEPS / fan_s:.3f} steps/s a seed; each seed "
              f"bit for bit a lone NemoFitter {same}; final losses "
              f"{res['losses'][:, -1].tolist()}")
        if not same or not np.isfinite(res["losses"]).all():
            raise AssertionError("path Q3: a seed differs from its lone "
                                 "fitter")
        out["q3"] = dict(fan_s=fan_s, step_s=fan_s / Q_FAN_STEPS,
                         seed_steps_s=Q_FAN_STEPS / fan_s)

    def run():
        with tempfile.TemporaryDirectory() as d:
            bundle.save(os.path.join(d, "bundle.npz"))
            for name, fn in (("Q1", lambda: q1(d)), ("Q2", lambda: q2(d)),
                             ("Q3", q3)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                secs[name] = round(time.perf_counter() - t0, 3)

    counts, _ = run_path("path Q", ("fk_fwd", "fk_bwd", "v2v_grad"), run)
    for r in ranks:
        for k, v in json.loads(str(r["counts"])).items():
            counts[k] += v
    out["seconds"] = sum(secs.values())
    print(f"[path Q] seconds {json.dumps(secs)}, {out['seconds']:.1f} in "
          f"all; launches with Q2's ranks {json.dumps({k: counts[k] for k in ('fk_fwd', 'fk_bwd', 'v2v_grad')})}")
    return counts, out


def main() -> int:
    if sys.argv[1:2] == ["--q2-rank"]:
        return q2_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    # deterministic_cuda() needs cuBLAS's workspace named before the first
    # product (PyTorch reads it once); this is the H100's default, 32 MiB
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}")
    print("[device] " + ", ".join(
        f"{m} {'present' if importlib.util.find_spec(m) else 'absent'}"
        for m in ("matplotlib", "PIL")))
    device = torch.device("cuda", 0)

    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.data.synthetic import synthetic_problem
    from nemo_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {_build.library_path()} ready in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds if _build.build_seconds is not None else 0:.2f} s)")

    smpl = synthetic_smpl_model(6890, seed=0, device=device)
    smpl_b = synthetic_smpl_model(6890, seed=0, device=device,
                                  skin_dtype=torch.bfloat16)
    kernel_err, rec = kernel_phase(device, smpl)
    kernel_err.update(bf16_kernel_phase(device, smpl, smpl_b, rec))
    bundle, _ = synthetic_problem(smpl, num_views=8, num_frames=120,
                                  img_hw=IMG_HW, seed=0)
    kernel_err.update(raster_phase(device, smpl, bundle, rec))
    kernel_err.update(chamfer_phase(device, smpl, rec))
    kernel_err.update(mlp_phase(device, rec))
    kernel_err.update(gn_phase(device, rec))
    kernel_err.update(io_bf16_phase(device, smpl, smpl_b, rec))
    paths, secs = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        secs[name] = round(time.perf_counter() - t0, 1)
        return r

    secs["kernels"] = round(time.perf_counter() - t_start, 1)
    paths["slice 1"], steady1, run1 = timed(
        "slice 1", lambda: slice1_path(device, smpl, bundle))
    path_h_counts, steady_h, run_h = timed(
        "H", lambda: path_h(device, smpl_b, bundle, steady1))
    paths.update(path_h_counts)
    path_i_counts, steady_i = timed("I", lambda: path_i(
        device, smpl, smpl_b, bundle, steady1, steady_h, run1, run_h))
    paths.update(path_i_counts)
    paths["path A"], steady_a = timed("A", lambda: path_a(device, smpl,
                                                          bundle))
    for k, c in timed("B", lambda: path_b(device, smpl, bundle)).items():
        paths[f"path B {k}"] = c
    for k, c in timed("C", lambda: path_c(device, smpl, bundle)).items():
        paths[f"path C {k}"] = c
    paths["path D"], render = timed("D", lambda: path_d(device, smpl,
                                                        bundle))
    with tempfile.TemporaryDirectory() as d:
        files, sources = write_asset_files(d, smpl)
        paths["path E"] = timed("E", lambda: path_e(device, files))
        paths["path F"], steady_f = timed("F", lambda: path_f(device, smpl,
                                                              bundle))
        paths["path G"], g = timed("G", lambda: path_g(
            device, smpl, bundle, files, sources))
        paths["path J"], j = timed("J", lambda: path_j(device, smpl, bundle,
                                                       files, d))
        paths["path K"], k, prox = timed("K", lambda: path_k(device, smpl,
                                                             files, d))
        paths["path L"], lv = timed("L", lambda: path_l(device, smpl, files,
                                                        d))
        paths["path M"], mv = timed("M", lambda: path_m(device, d))
        paths["path N"], nv = timed("N", lambda: path_n(device, smpl, d,
                                                        prox))
        paths["path O"], ov = timed("O", lambda: path_o(device, smpl, files,
                                                        d))
    paths["path P"], pv = timed("P", lambda: path_p(device, smpl, bundle))
    paths["path Q"], qv = timed("Q", lambda: path_q(device, smpl, bundle))
    launches = {k: sum(c[k] for c in paths.values()) for k in KERNELS}
    print(f"[paths] render: {render['video_s']:.4f} s a video frame with the "
          f"PNG writes, {render['nopng_s']:.4f} s without")
    print(f"[paths] steps/s: slice 1 {steady1:.3f}, path H (slice 1 with "
          f"bf16 tables) {steady_h:.3f}, path I (bf16 tables and high "
          f"network products) {steady_i:.3f}, path A {steady_a:.3f}, "
          f"path F {steady_f:.3f}, path G's custom-video configuration "
          f"{g['custom_steps_s']:.3f} without the HuMoR term and "
          f"{g['humor_steps_s']:.3f} with it; path G {g['seconds']:.1f} s; "
          f"path J {j['all']:.1f} s; path K "
          f"{sum(k.values()):.1f} s; path L {lv['seconds']:.1f} s; "
          f"path M {mv['seconds']:.1f} s ({mv['steps_s']:.3f} VIBE train "
          f"steps/s); path N {nv['seconds']:.1f} s "
          f"({nv['n2']['steps_s']:.3f} VPoser train steps/s); path O "
          f"{ov['seconds']:.1f} s ({ov['o1']['steps_s']:.3f} HuMoR train "
          f"steps/s); path P {pv['seconds']:.1f} s; path Q "
          f"{qv['seconds']:.1f} s ({qv['q3']['step_s']:.4f} s a "
          f"{Q_SEEDS}-seed fan-out step); seconds by path "
          f"{json.dumps(secs)}; "
          f"launches summed over the paths {json.dumps(launches)}; "
          f"{time.perf_counter() - t_start:.1f} s in all")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": kernel_err[k],
         "ms": rec[k]["ms"], "plain_ms": rec[k]["plain_ms"],
         "bound_ms": rec[k]["bound_ms"], "bound_by": rec[k]["bound_by"],
         "library_ms": rec[k]["library_ms"], "shape": rec[k]["shape"]}
        for k, (src, rep) in KERNELS.items()]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
