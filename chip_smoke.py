"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, drive.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build: compiles the seven kernel sources of
   ``focalformer3d_tpu_torch/csrc/`` (K1 and kernel A share the header
   ``mma_sm90.cuh``) with one nvcc each, all started
   together (K1 sparse-conv apply, which also runs dx and the phase probe;
   the dW kernel; K2 rulebook builder; K3 z-run sparse-conv apply; the
   probes' kernels A ``micro_dot``, B ``micro_gather``, C
   ``micro_widen``); prints the seconds of each.
3. kernels vs plain, on one radial 200k-point scan (the scan ``bench.py``
   builds), at the shapes the encoder engines give them:
   - index builds: the torch-op build of engine ``cuda``, the meta chain of
     ``cuda_mxu`` (K2 + ``downsample_meta`` + ``colz_from_meta``) and the
     z-run plans of ``cuda_zrun``, timed on the same scan;
   - K2: the 8 rulebooks of the ``cuda_mxu`` path equal ``decode_rules``
     (its plain version) and ``build_conv_rules`` exactly;
   - K1: the 5 conv geometries of ``cuda`` and the 4 more of ``cuda_mxu``
     (L2, L3, conv_out), same bf16 inputs as the plain gather + matmul:
     max |diff| / max |plain| <= 1e-3, and two runs equal bit for bit. Per
     geometry one line with the share of (128-site tile, tap), (64-row
     group, tap), (16-row strip, tap) and (site, tap) pairs that hold a hit
     (what skipping at each granularity leaves of the product), the
     launch's plan (route, persistent grid, stages, W resident or
     streamed), and its time on the route production takes and on the
     other one;
   - K3: the 5 conv geometries of ``cuda_zrun`` against its plain version,
     <= 1e-3, and two runs equal bit for bit. Per geometry one line with
     the hit shares of its codes ((tile, BEV tap), (64-row group, BEV tap),
     (16-row strip, BEV tap), (site, BEV tap) pairs with a z tap), the
     launch's plan (route, grid, stages, W resident or streamed, z taps per
     stage) and its time on the route production takes and on the other
     one (also held to 1e-3).
   Every kernel time (here and in phase 6) is per call from calls replayed
   in a CUDA graph (``tools/_common.time_ms``: the device's time, since a
   short launch runs at the host's pace under CUDA events), and so are the
   plain versions' and K2's torch-op comparators'.
4. slices: FocalFormer3D_L (full width, random weights from a seed, bf16
   compute) answers three radial scans (seeds 0-2) through
   ``preprocess_points`` -> model -> ``get_bboxes`` on each engine: finite
   boxes and scores, 200 kept boxes per scan, and exact launch counts per
   scan (K1, K2, K3): ``cuda`` 11, 0, 0; ``cuda_mxu`` 21, 8, 0;
   ``cuda_zrun`` 0, 0, 11.
5. engine parity: the encoder's BEV for scan 0 on ``cuda`` and
   ``cuda_zrun`` against the plain engine (dense from L2, the eval path),
   and on the all-sparse ``cuda_mxu`` against the plain engine with
   ``dense_from=4``: max |diff| / max |plain| <= 1e-2.
6. K1's backward, at every conv of one training batch (two radial scans,
   the training voxel cap, engine ``cuda`` with the training dense boundary
   L3): ``sparse_conv_train`` (K1 forward; dx by K1 on the transposed
   rulebook; dW by the dW kernel) on random bf16-valued features and
   weights and a random f32 cotangent, against autograd through its plain
   version with the same rounding (``apply_conv_bf16_plain``): forward, dx
   and dW each within 1e-3 of the plain result's scale (the two differ in
   the order of f32 sums and, for dW, by the kernel's split of the
   cotangent into two bf16 parts, 2^-16 of it). Then each kernel alone,
   timed against its plain version by CUDA-graph replay (K1 forward and dx
   with the hit shares of their rulebooks and both routes; dW with its
   route, chunk and slices, and two runs equal bit for bit).
7. training: FocalFormer3D_L at full width and depth in float32, batch 2,
   engine ``cuda``, ``TRAIN_STEPS`` steps of ``training.train_step`` on the
   same two scans with their GT boxes: every loss term and ``grad_norm``
   finite on every step, every parameter and every batch-norm running mean
   moved, K1 forward / dx / dW launches per step exactly 16 / 15 / 16; ms
   per step by host clock around a synchronise (the first step apart, the
   median of the rest), its split into voxelize / forward / loss /
   backward / optimizer by CUDA events, and peak memory per phase.
8. one more training step under ``torch.profiler``: kernels launched,
   device busy share, the largest kernels with their launches, and the
   aten ops that launched the top three.
9. entry points: the port's train CLI (``tools.train.main``, in-process)
   on FocalFormer3D_L, ``--synthetic``, 2 epochs of 2 steps at batch 2,
   ``--keep-last 1``, in a temporary work dir: finite losses in its JSON
   log, ``epoch_2`` saved and ``epoch_1`` pruned; a second call
   auto-resumes at epoch 2 with the saved step and the parameters, buffers
   and moments bit for bit. Then 2 steps with ``freeze_pts`` (the masked
   optimizer): every point-branch parameter and batch-norm statistic and
   ``imgpts_neck.shared_conv_pts`` bit-identical, the head moved, per step
   0 dx and 0 dW launches and as many K1 forward launches as an eval scan
   on ``cuda`` (the eval dense boundary). Then the benchmark CLI
   (``tools.benchmark.main``): inference on the three engines (3 scans
   each, batch 4 beside batch 1, the stage split and occupancy) and
   ``--train`` (2 steps at batch 2, SECOND's first conv2d in its six
   variants); each prints one JSON line, which must parse. K1 (forward,
   dx, dW), K2 and K3 launches are counted from zero before the phase and
   must all be non-zero after it. Prints its seconds.
10. dataset: ``write_nuscenes`` writes a nuScenes-format directory (6
   samples, each a 30k-point key frame of ``data/synthetic`` and 9 sweeps
   of ~29k points seen from a moved sensor, ~290k points a sample, the
   size of a real 10-sweep sample; the infos of mmdet3d v0.17 with the
   calibration of a submission), the port's ``create_gt_database`` its
   GT database. The host ms per sample of ``get_sample`` (train pipeline
   with GT-paste) and ``collate``. Then the train CLI on FocalFormer3D_L,
   batch 2, 2 epochs of 2 steps, with GT-paste and ``Fading`` (which takes
   ``ObjectSample`` out before the second epoch): finite losses, s/it per
   step, ``epoch_2`` saved, K1 forward / dx / dW 64 / 60 / 64 launches, 10
   native point loads (the first batch, drawn as the JAX CLI draws it, and
   four steps). Then the test CLI on that checkpoint over the 6 samples on
   ``cuda``, ``cuda_mxu`` and ``cuda_zrun``: samples/s, the metric keys,
   6 tokens in the submission with at most 500 finite boxes each, and
   exactly the launches of 6 scans (K1 66; K1 126 + K2 48; K3 66).
11. probes: the nine TPU probes P1-P9 of ``tools/micro_*.py`` as their
   ports in ``focalformer3d_tpu_torch/tools/`` (``run(device, "full")``,
   the originals' shapes, each once), one line per probe. Every kernel
   case is held against its plain version: kernel A (``micro_dot``) and
   B's ``gather_taps`` within 1e-3 of the output's scale (sums in another
   order), B's ``gather_rows`` and C (``micro_widen``) bit for bit, K1's
   phase probe in full mode bit for bit against production K1 and within
   1e-3 of the plain conv (its other modes compute zeros, held exactly);
   launches of the five probe kernels are counted from zero just before
   the phase and must all be non-zero. Each kernel case beside a PyTorch
   call prints the ratio of their times; P7's width sweep so shows, per
   row width, ``gather_rows`` against ``x[idx]``, and each P6 and P7 case
   names the route its kernel took. One line per P9 level gives C's time,
   the strided view copy's, their ratio, C's route and tile, and C's share
   of its byte bound.
12. variants and TTA (after the probes; phase 10's directory and
   checkpoint): DeformFormer3D_L at full width and depth (bf16, random
   weights from seed 0; FocalFormer3D_L's encoder with the single-stage
   head) answers phase 4's three scans on each engine, and
   DeformFormer3D_L_dynamic (dynamic voxelization) on ``cuda``: finite
   boxes, 1-200 kept a scan (200 queries, so a box decoded out of range
   leaves fewer), and phase 4's launches per scan exactly. Its
   ``dynamic_voxelize`` at the eval cap on scan 0 against the same function
   on the CPU: coords and mask bit for bit, features within 2 * 2**-23 *
   sum|x| per voxel. One float32 training step of DeformFormer3D_L at
   batch 2 on ``cuda``: finite losses, K1 forward / dx / dW 16 / 15 / 16.
   Then the test CLI with ``--tta`` (the double flip, 4 passes a sample)
   over phase 10's 6 samples and checkpoint, on ``cuda`` with
   ``--tta-cache-dir A`` (K1 264 launches) and on ``cuda_mxu`` with
   ``--tta-cache-dir B`` (K1 504, K2 192), then ``--tta-ensemble A B`` (no
   model kernel launched): samples/s, the merge's ms a sample, the metric
   keys, 6 tokens with at most 500 finite boxes each. Last, one sample's
   merge of 4 x 600 candidates on the card against the CPU (the first of
   the cached samples where no valid pair's IoU lies within 1e-5 of the
   0.1 or 0.65 threshold): mask, labels and scores equal, boxes within 1e-5
   of each value's magnitude; and the merge's split on the card: the IoU
   matrix (CUDA events; beside it the same intersections with every pair
   clipped, not only the pairs near enough to overlap), the greedy NMS
   pass (host clock: one copy of the suppression matrix, then numpy) and
   the whole merge.

13. camera (after phase 12): FocalFormer3D_LC at full width
   (ResNet-50 + FPN, 6 cameras at 448 x 800, LSS with 41 depth bins on the
   112 x 200 feature map into 13 x 64 = 832 channels on the 180 x 180 BEV,
   two ``bevfusion`` fusion layers; bf16 compute where the config computes
   in its dtype, the image branch and the LSS in float32; random weights
   from seed 0) answers phase 4's three scans, each with its synthetic
   camera rig and six images rendered from the scan, on each engine:
   finite boxes, 200 kept, phase 4's (K1, K2, K3) launches per sample
   exactly; ms a sample, the stage split by CUDA events (image backbone +
   FPN, the point branch's stages, LSS lift / splat / BevEncode, the fusion
   layers, decoder) and peak memory. Sample 0's LSS on the card (splat and
   encoded BEV) against the same module on the CPU in float32, within
   ``LSS_TOL`` (1e-4) of scale: ``index_add_`` adds in atomic order on the
   card, and a frustum point an ulp from a cell boundary may land in the
   next cell (the line counts them). DeformFormer3D_C_R50 on the same
   samples: finite boxes, no kernel launched, and its dense heatmap moves
   when the images are zeroed. Two float32 FocalFormer3D_LC training steps
   at batch 2 on ``cuda`` with its freeze flags: K1 forward only (11
   launches a step, the eval dense boundary; no dx, no dW), every frozen
   tensor bit-identical, the trainable parameters moved, each step's ms
   and split by CUDA events, peak memory; then a third step under
   ``torch.profiler`` (device busy share, the largest kernels and the ops
   that launched them). Last, the train CLI:
   DeformFormer3D_C_R50 one step, then FocalFormer3D_LC 2 steps
   ``--load-img-from`` that checkpoint (the loaded image branch bit for
   bit, K1 forward 22).
14. training engines (after phase 13): on the batch of phase 7 (two radial
   scans, float32, TF32 off), every conv of ``cuda_mxu`` (the meta chain's
   K2 rulebooks and their transposes, every level and conv_out, so K1
   forward, dx and dW at L3's 128 -> 128 and conv_out's 3 taps too) and
   of ``cuda_zrun`` (``zrun_conv_train``: K3 forward, K1's dx and dW on
   the rulebook its codes encode, up to the dense boundary L3) against
   autograd through ``apply_conv_bf16_plain``: forward, dx and dW within
   1e-3 of scale; on ``cuda_mxu`` each kernel alone timed by CUDA-graph
   replay per geometry. Then FocalFormer3D_L at full width: one warm step
   on ``cuda``, then one step on each of ``cuda``, ``cuda_mxu`` and
   ``cuda_zrun`` in turns from the warm step's weights and optimizer
   state: finite losses, the K1 forward / dx / dW, K2 and K3 launches of
   ``TRAIN_ENGINE_LAUNCHES`` exactly, ms a step with its split by CUDA
   events, peak memory.
15. LC_Proj: FocalFormer3D_LC_Proj at full width (LC with I2P in
   place of the LSS: ``shared_conv_img`` and a 10 x 180 x 180 grid of
   points projected into the six cameras; bf16 where the config computes
   in its dtype, the image branch and I2P in float32; random weights from
   seed 0) answers phase 4's three scans with their cameras on each
   engine: finite boxes, 200 kept, phase 4's (K1, K2, K3) launches per
   sample exactly; ms a sample, the stage split with the ``I2P`` span, peak
   memory. Sample 0's I2P block on the card against the same module on
   the CPU in float32 on the same inputs, within ``I2P_TOL`` (1e-4) of
   scale (the line counts the validity flags the card sets otherwise).
   Two float32 frozen training steps at batch 2 on ``cuda``: K1 forward
   11 a step, no dx or dW, the image and point branches bit-identical,
   ``shared_conv_img`` and I2P moved, ms a step, peak memory.
16. camera dataset: a nuScenes-format directory of phase 10's size
   (6 samples, a 30k-point key frame and 9 sweeps each) with six 1600 x
   900 JPEG cameras a sample (``write_nuscenes(cameras=True)``, the port's
   writer); the committed fixtures of ``tests/torch_images/`` through the
   port's decoder, resize, crop, flip and rotate, each result's SHA-256
   equal to Pillow's digest; ``get_sample`` with images under the train
   pipeline (``ImageAug3D``) and the test pipeline, host ms a sample split
   into the six decodes, the resampling and the rest (wall clock), and
   ``collate``; the train CLI on FocalFormer3D_LC, 2 x 2 steps at batch 2
   with the recipe's frozen branches (finite losses, K1 forward 11 a step
   and nothing else, 60 decodes), s/it beside the loader's time a batch;
   the test CLI on FocalFormer3D_LC over the 6 samples on ``cuda_mxu``
   and with ``--tta`` on FocalFormer3D_LC_TTA over 2 samples on ``cuda``
   (12 passes a sample): finite boxes, samples/s, phase 4's (K1, K2, K3)
   launches per pass exactly, 6 decodes a sample.

17. Waymo (last): ``write_waymo`` writes a KITTI-layout directory of 6
   frames of 180 000 radial points within +-76.8 m (float32, 6 columns;
   boxes in the camera frame through a non-identity ``R0_rect`` and
   ``Tr_velo_to_cam``, a DontCare row, LEVEL_2-only boxes). On the first
   frame through the test pipeline, FocalFormer3D_Waymo_L's geometry (a
   41 x 1536 x 1536 grid, 150 000 voxels at L0): K2's 8 rulebooks exactly,
   K1 at the 9 geometries of ``cuda`` and ``cuda_mxu`` and K3 at the 5 of
   ``cuda_zrun`` within 1e-3 of their plain versions, timed by CUDA-graph
   replay beside phase 3's nuScenes times; ``hard_voxelize`` on the card
   equal to the CPU bit for bit and the HardVFE within 1e-5 of the CPU's
   scale (each timed by events). FocalFormer3D_Waymo_L (bf16, seed-0
   weights) on three frames per engine: finite 7-value boxes, 1-200 kept,
   phase 4's (K1, K2, K3) launches a frame exactly; the BEV engine parity
   of phase 5 on the first frame (1e-2); FocalFormer3D_Waymo15_L
   (class-aware heads) and DeformFormer3D_Waymo_L on ``cuda_mxu``, one
   frame each; the benchmark CLI on the three engines (its stage split
   with the ``HardVFE`` stage, and each level's occupancy: active /
   capacity / dropped); the train CLI on FocalFormer3D_Waymo_L, 2 x 2
   steps at batch 2 (finite losses, s/it, K1 forward / dx / dW 16 / 16 /
   16 a step: conv_input's dx too, the HardVFE trains), then
   DeformFormer3D_Waymo15_L one epoch (its ``load_interval`` 5 leaves 2 of
   the 6 frames: one step); the test CLI on the first checkpoint over the
   6 frames on each engine (samples/s, the L1 / L2 mAP / mAPH and per-class
   keys all finite, exactly 6 frames' launches, the evaluator's host ms).
18. data parallel (``tools/dryrun_ddp``, ``parallel/mesh.py``):
   FocalFormer3D_L at full width in float32 (TF32 off), dropouts off and
   the denoising groups' noise fixed: one step at batch 2 in this process
   on ``plain``, ``cuda`` and ``cuda_mxu`` (and each once more on the
   batch in reverse order, the same function with the float32 sums in
   another order), then two worker processes over gloo, both on this card
   (NCCL takes one rank a card), each on its half of the batch at batch 1
   a step on each engine after an untimed one: per rank K1 forward / dx /
   dW 16 / 15 / 16 on ``cuda`` and 21 / 20 / 21 with 8 K2 on ``cuda_mxu``
   exactly; the ranks' gradients and parameters equal bit for bit;
   against the world-size-1 step all gradients and the whole state after
   the update (relative L2) within ``tests/test_torch_train_step.py``'s
   tolerances, each no tighter than twice what the reversed batch moves
   it, and the total loss within 1e-5 on ``plain`` and bf16's unit
   roundoff 2^-9 on the kernel engines (``dryrun_ddp.compare_to_floor``:
   at full width a change of the sums' order flips top-k picks, matches
   and bf16 roundings, which move single terms and tensors; the
   tensor-by-tensor shares are printed); per rank the step's ms, the
   gradient all-reduce's ms, the batch-norm collectives and the peak
   memory (two ranks share the card: no scaling figure). Then each worker
   steps once more per engine with each of ``dryrun_ddp.FAULTS`` planted
   (SyncBN's backward without the other rank's cotangents, the loss counts
   of the rank's shard, no gradient all-reduce), and every one of them
   must fail that comparison. Then the train CLI at world size 2 over gloo
   on the card (two synthetic steps, global batch 2) and at world size 1
   over NCCL (one step): every rank exits 0, rank 0 alone prints, logs and
   saves; their s/it.

The ``kernels`` line carries, per kernel, its launches on the main paths
(``launches_by_path``; ``entry_points`` is phase 9's, ``dataset``
phase 10's, ``variants`` and ``tta`` phase 12's, ``camera`` phase 13's,
``train_mxu`` and ``train_zrun`` phase 14's step on that engine,
``camera_proj`` phase 15's, ``camera_dataset`` phase 16's, ``waymo``
phase 17's, ``ddp`` phase 18's workers' steps without a planted fault (their ranks
and engines summed;
each worker counts from zero just before its step and reads just after
it), each run counted from zero just before it and read just after
it), K1's, K2's and K3's stats at the Waymo geometry (``waymo``: max
error, per-frame ms, plain ms, bound; ``max_abs_err`` is the larger of
the two phases'),
its time and its plain version's (per eval scan for K1 forward, K2 and K3;
per training step for dx and dW, and in ``train`` for K1 forward), and its
bound: the larger of the bytes it must move (each input read once, each
output written once) over 3.35 TB/s and its multiply-adds over the peak of
their type (989 TFLOP/s bf16 for K1 and K3, whose operands are bf16; for
dW, whose f32 cotangent is split into two bf16 parts, two bf16 products
per multiply-add, i.e. half that peak), counted from this run's rulebooks
(rules that hit, at valid output sites). No single PyTorch
call computes a sparse conv or a rulebook, so ``library_ms`` is null. The
five probe kernels carry their headline case (``case``): ``micro_dot`` P1a's
``gk`` beside one ``torch.matmul`` over the same operand;
``micro_gather_taps`` P6 at pack 1 (where the three TPU kernels are one
function) beside ``embedding_bag(mode="sum")``, and its W 512 cases with
their times and routes (``w512``); ``micro_gather_rows`` P7's 4 MiB table
beside ``torch.index_select``, and the row width of the sweep where it
does worst against ``x[idx]`` with that ratio (``worst_vs_x_idx``);
``micro_widen`` P9 at L0 beside one copy of a strided view of the padded
meta; ``sparse_conv_probe`` P1b's L0 in full mode (no library call). Their times are per call, from calls replayed in
a CUDA graph (``tools/_common.time_ms``: the device's time, without the
host's); their launches count each replay's launches; ``max_abs_err`` is
the largest over all their cases.

Imports nothing of JAX and nothing of the JAX package
(``focalformer3d_tpu``): weights and scans come from the port's own numpy
generators. Prints the card line, one ``{"kernels": [...]}`` line, and as
its last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_POINTS = 200_000
SCAN_SEEDS = (0, 1, 2)
TRAIN_SEED = 10
TRAIN_BATCH = 2
TRAIN_STEPS = 4
KERNEL_TOL = 1e-3
ENGINE_TOL = 1e-2
REPS = 10  # CUDA-event repetitions of a host-issued index build
ENGINES = ("cuda", "cuda_mxu", "cuda_zrun")
# (K1, K2, K3) launches per scan on each engine
LAUNCHES_PER_SCAN = {"cuda": (11, 0, 0), "cuda_mxu": (21, 8, 0),
                     "cuda_zrun": (0, 0, 11)}
# K1 forward / dx / dW launches per training step on ``cuda`` (dense from
# L3): 16 sparse convs (conv_input; per level L0-L2 four subm convs and the
# strided one); conv_input's voxel features need no dx
TRAIN_LAUNCHES_PER_STEP = {"forward": 16, "dx": 15, "wgrad": 16}
# phase 10: a written nuScenes directory of samples the size of a real
# 10-sweep one (a 30k-point key frame + 9 sweeps, ~290k points)
DATASET_SEED = 20
DATASET_SAMPLES = 6
DATASET_POINTS = 30_000
DATASET_SWEEPS = 9
# model-path kernel launches of the test CLI over the samples, per engine
DATASET_TEST_LAUNCHES = {
    engine: {k: n * DATASET_SAMPLES for k, n in zip(
        ("sparse_conv", "plan_rules", "sparse_conv_zrun"), counts) if n}
    for engine, counts in LAUNCHES_PER_SCAN.items()}
# phase 12: the test CLI's TTA runs the double flip (tta_augs({})), 4 eval
# passes a sample; the merge on the card is held to the CPU's on the first
# sample with no valid pair within MERGE_MARGIN of an IoU threshold
TTA_PASSES = 4
TTA_TEST_LAUNCHES = {
    engine: {k: n * TTA_PASSES for k, n in DATASET_TEST_LAUNCHES[engine]
             .items()} for engine in ("cuda", "cuda_mxu")}
MERGE_TOL = 1e-5
MERGE_MARGIN = 1e-5
MODEL_KERNELS = ("sparse_conv", "sparse_conv_dx", "sparse_conv_wgrad",
                 "plan_rules", "sparse_conv_zrun")
# the ``kernels`` row each count of ``train_step.kernel_launches`` is
LAUNCH_ROWS = dict(zip(("forward", "dx", "wgrad", "plan", "zrun"),
                       MODEL_KERNELS))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
# dense, published; "bf16 split": an f32 operand split into two bf16
# parts, two bf16 products per multiply-add (the dW kernel)
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "bf16 split": 989e12 / 2}
CSRC = "focalformer3d_tpu_torch/csrc/"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "sparse_conv": (CSRC + "sparse_conv.cu",
                    "focalformer3d_tpu/ops/sparse_conv_pallas.py:357"),
    "sparse_conv_dx": (CSRC + "sparse_conv.cu",
                       "focalformer3d_tpu/ops/sparse_conv_pallas.py:715"),
    "sparse_conv_wgrad": (CSRC + "sparse_conv_wgrad.cu",
                          "focalformer3d_tpu/ops/sparse_conv_pallas.py:726"),
    "plan_rules": (CSRC + "plan_builder.cu",
                   "focalformer3d_tpu/ops/plan_builder.py:129"),
    "sparse_conv_zrun": (CSRC + "sparse_conv_zrun.cu",
                         "focalformer3d_tpu/ops/sparse_conv_zrun.py:312"),
    "micro_dot": (CSRC + "micro_dot.cu", "tools/micro_mxu_probe.py:85"),
    "micro_gather_taps": (CSRC + "micro_gather.cu",
                          "tools/micro_gather_kernel.py:46"),
    "micro_gather_rows": (CSRC + "micro_gather.cu",
                          "tools/micro_gather2.py:98"),
    "micro_widen": (CSRC + "micro_widen.cu", "tools/micro_meta9.py:88"),
    "sparse_conv_probe": (CSRC + "sparse_conv.cu",
                          "tools/micro_mxu_probe.py:115"),
}
# the other Pallas functions each probe kernel stands for
ALSO_REPLACES = {
    "micro_dot": ["tools/micro_dotshape.py:38", "tools/micro_dotshape.py:50",
                  "tools/micro_dotshape2.py:29"],
    "micro_gather_taps": ["tools/micro_gather_kernel.py:61",
                          "tools/micro_gather_kernel.py:73"],
    "micro_gather_rows": ["tools/micro_gather2.py:131"],
    "micro_widen": [],
    "sparse_conv_probe": ["tools/micro_kernel_v2.py:54",
                          "tools/micro_pallas_attr.py:37",
                          "tools/micro_batch_grid.py:45"],
}
PROBES = ("micro_mxu_probe", "micro_dotshape", "micro_dotshape2",
          "micro_kernel_v2", "micro_pallas_attr", "micro_gather_kernel",
          "micro_gather2", "micro_batch_grid", "micro_meta9")


class Bound:
    """Least time of a run of launches: per launch the larger of bytes over
    the memory rate and operations over the peak of their type, summed;
    ``keys()`` names the side that bounds most of the sum."""

    def __init__(self):
        self.ms = 0.0
        self.parts = {"bytes": 0.0, "operations": 0.0}

    def add(self, nbytes, flops, peak, times=1):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[peak] * 1e3
        side = "bytes" if t_bytes >= t_ops else "operations"
        self.ms += times * max(t_bytes, t_ops)
        self.parts[side] += times * max(t_bytes, t_ops)

    def keys(self):
        return {"bound_ms": self.ms,
                "bound_by": max(self.parts, key=self.parts.get)}


def _hits(rules, v_in, out_valid):
    """Rules that read an input row, at valid output sites."""
    return int(((rules < v_in) & out_valid[:, None]).sum())


def _wrappers():
    from focalformer3d_tpu_torch.ops import plan_builder_cuda as k2
    from focalformer3d_tpu_torch.ops import sparse_conv_cuda as k1
    from focalformer3d_tpu_torch.ops import sparse_conv_zrun_cuda as k3

    return k1, k2, k3


def _probe_wrappers():
    from focalformer3d_tpu_torch.ops import micro_dot, micro_gather, \
        micro_widen

    return micro_dot, micro_gather, micro_widen


def _scan(cfg, seed, device):
    from focalformer3d_tpu_torch.data import synthetic

    batch = synthetic.make_batch(
        np.random.RandomState(seed), batch_size=1, n_points=N_POINTS,
        n_boxes=24, max_gts=32, num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial",
    )
    return (torch.from_numpy(batch["points"]).to(device),
            torch.from_numpy(batch["points_mask"]).to(device))


def _quat_z(yaw):
    """(w, x, y, z) of a rotation by ``yaw`` about z."""
    return [math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)]


def write_nuscenes(root, *, seed, samples, points, sweeps, pc_range,
                   classes, boxes=12, cameras=False, img_hw=(900, 1600)):
    """Write a nuScenes-format directory (mmdet3d v0.17 infos) from the
    port's synthetic scenes: per sample a radial key frame of ``points``
    points (``data/synthetic.make_scene``) and ``sweeps`` sweeps, each
    about 97% of the key frame's points, jittered and seen from a sensor
    that moved (a small yaw and a shift, given as ``sensor2lidar_*``).
    The infos carry ``gt_boxes`` (bottom-centred, 7 values),
    ``gt_names``, ``gt_velocity``, ``num_lidar_pts`` (key-frame points in
    the box), ``valid_flag``, ``timestamp`` (us), ``sweeps`` and the
    ``lidar2ego_*`` / ``ego2global_*`` calibration of a submission; one
    pickle is written as both ``nuscenes_infos_train.pkl`` and
    ``nuscenes_infos_val.pkl``. With ``cameras`` each sample also gets six
    cameras (``img_hw``, nuScenes' 900 x 1600 by default): a rig that sees
    the scene (``synthetic.ring_camera_infos``, its own random stream, so
    the points are those of ``cameras=False``), the key frame's splats over
    a textured background (``synthetic.camera_frames``) written as
    baseline 4:2:0 JPEGs of quality 90 by the port's writer, and ``cams``
    entries as ``tools/create_data.py`` writes them (``data_path``,
    ``sensor2lidar_rotation`` / ``_translation``, ``cam_intrinsic``).
    Returns the train infos' path."""
    import pathlib
    import pickle

    from focalformer3d_tpu_torch.data import image_io, synthetic
    from focalformer3d_tpu_torch.data.nuscenes import (CAM_ORDER,
                                                       lidar2img_matrices)

    root = pathlib.Path(root)
    (root / "samples").mkdir(parents=True, exist_ok=True)
    (root / "sweeps").mkdir(exist_ok=True)
    rng = np.random.RandomState(seed)
    cam_rng = np.random.RandomState(seed + 7919)
    infos = []
    for i in range(samples):
        pts, gt, labels = synthetic.make_scene(
            rng, n_points=points, n_boxes=boxes, num_classes=len(classes),
            pc_range=pc_range, mode="radial")
        ts = 1_600_000_000_000_000 + i * 500_000
        lidar_path = root / "samples" / f"lidar_{i:04d}.bin"
        pts.tofile(lidar_path)
        sweep_infos = []
        for j in range(sweeps):
            yaw = rng.uniform(-0.02, 0.02)
            c, s = math.cos(yaw), math.sin(yaw)
            rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            shift = rng.uniform(-0.25, 0.25, 3) * (j + 1)
            sp = pts[rng.uniform(size=len(pts)) < 0.97].copy()
            sp[:, :3] += rng.normal(0.0, 0.02, (len(sp), 3))
            # lidar = rot @ sensor + shift  =>  sensor = rot^T (lidar - shift)
            sp[:, :3] = (sp[:, :3] - shift) @ rot
            path = root / "sweeps" / f"lidar_{i:04d}_{j}.bin"
            sp.astype(np.float32).tofile(path)
            sweep_infos.append({
                "data_path": str(path), "sensor2lidar_rotation": rot,
                "sensor2lidar_translation": shift,
                "timestamp": ts - (j + 1) * 50_000})
        # key-frame points inside each bottom-centred box
        d = pts[:, None, :2] - gt[None, :, :2]
        cy, sy = np.cos(gt[:, 6]), np.sin(gt[:, 6])
        lx = d[..., 0] * cy + d[..., 1] * sy
        ly = -d[..., 0] * sy + d[..., 1] * cy
        dz = pts[:, None, 2] - gt[None, :, 2]
        inside = ((np.abs(lx) <= gt[:, 3] / 2) & (np.abs(ly) <= gt[:, 4] / 2)
                  & (dz >= 0) & (dz <= gt[:, 5]))
        n_in = inside.sum(0).astype(np.int64)
        infos.append({
            "token": f"sample_{i:04d}", "lidar_path": str(lidar_path),
            "timestamp": ts, "sweeps": sweep_infos,
            "gt_boxes": gt[:, :7].copy(),
            "gt_names": np.array([classes[k] for k in labels], object),
            "gt_velocity": gt[:, 7:9].astype(np.float64),
            "num_lidar_pts": n_in, "valid_flag": n_in > 0,
            "lidar2ego_rotation": _quat_z(0.01),
            "lidar2ego_translation": [0.94, 0.0, 1.84],
            "ego2global_rotation": _quat_z(0.3 + 0.05 * i),
            "ego2global_translation": [600.0 + 2.0 * i, 1600.0, 0.0]})
        if cameras:
            rig = synthetic.ring_camera_infos(cam_rng, len(CAM_ORDER), img_hw)
            infos[-1]["cams"] = dict(zip(CAM_ORDER, rig))
            frames = synthetic.camera_frames(
                cam_rng, pts, lidar2img_matrices(infos[-1]), img_hw)
            for name, cam in infos[-1]["cams"].items():
                cam["data_path"] = str(root / "samples" / f"{name}_{i:04d}.jpg")
            image_io.parallel_map(
                lambda a: image_io.imwrite(a[0], a[1], quality=90),
                [(c["data_path"], f) for c, f in
                 zip(infos[-1]["cams"].values(), frames)])
    ann = root / "nuscenes_infos_train.pkl"
    for name in ("nuscenes_infos_train.pkl", "nuscenes_infos_val.pkl"):
        with open(root / name, "wb") as f:
            pickle.dump({"infos": infos, "metadata": {"version": "synthetic"}},
                        f)
    return str(ann)


def _rot(axis, angle):
    """4 x 4 rotation by ``angle`` about axis 0 (x), 1 (y) or 2 (z)."""
    c, s = math.cos(angle), math.sin(angle)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m = np.eye(4)
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def write_waymo(root, *, seed, frames, points, pc_range, classes, boxes=12):
    """Write a Waymo directory in mmdet3d's KITTI layout (what
    ``data/waymo.py`` reads) from the port's synthetic scenes: per frame a
    radial scan of ``points`` points (``data/synthetic.make_scene``) as a
    float32 ``.bin`` of 6 columns (the 5 of the scan and one more, as
    Waymo's load_dim 6), and an info with the KITTI calibration (a
    non-identity ``R0_rect`` and ``Tr_velo_to_cam``: the LiDAR-to-camera
    axis swap after a small rotation and shift) and ``annos`` in the camera
    frame (location of the bottom centre, dimensions (l, h, w),
    rotation_y), one ``DontCare`` row, ``difficulty`` (0, 1 or 2) and
    ``num_points_in_gt`` (the scan's points in the box), so that some boxes
    are LEVEL_2 only. One pickle is written as both
    ``waymo_infos_train.pkl`` and ``waymo_infos_val.pkl``. Returns the
    train infos' path."""
    import pathlib
    import pickle

    from focalformer3d_tpu_torch.data import synthetic

    root = pathlib.Path(root)
    (root / "training" / "velodyne").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    axes = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                     [0, 0, 0, 1.0]])  # x_cam = -y, y_cam = -z, z_cam = x
    infos = []
    for i in range(frames):
        pts, gt, labels = synthetic.make_scene(
            rng, n_points=points, n_boxes=boxes, num_classes=len(classes),
            pc_range=pc_range, mode="radial")
        extra = rng.uniform(0.0, 1.0, (len(pts), 1)).astype(np.float32)
        rel = f"training/velodyne/{i:06d}.bin"
        np.concatenate([pts, extra], 1).astype(np.float32).tofile(root / rel)
        rect = _rot(0, rng.uniform(-0.02, 0.02))
        trv2c = axes @ _rot(2, rng.uniform(-0.05, 0.05))
        trv2c[:3, 3] = rng.uniform(-0.3, 0.3, 3)
        lidar2cam = rect @ trv2c
        loc = (np.concatenate([gt[:, :3], np.ones((len(gt), 1))], 1)
               @ lidar2cam.T)[:, :3]
        dims = gt[:, [3, 5, 4]].astype(np.float64)  # (l, h, w)
        rot_y = -gt[:, 6].astype(np.float64) - np.pi / 2
        # the scan's points in each bottom-centred box
        d = pts[:, None, :2] - gt[None, :, :2]
        cy, sy = np.cos(gt[:, 6]), np.sin(gt[:, 6])
        lx = d[..., 0] * cy + d[..., 1] * sy
        ly = -d[..., 0] * sy + d[..., 1] * cy
        dz = pts[:, None, 2] - gt[None, :, 2]
        n_in = ((np.abs(lx) <= gt[:, 3] / 2) & (np.abs(ly) <= gt[:, 4] / 2)
                & (dz >= 0) & (dz <= gt[:, 5])).sum(0)
        infos.append({
            "image": {"image_idx": i},
            "point_cloud": {"num_features": 6, "velodyne_path": rel},
            "calib": {"R0_rect": rect, "Tr_velo_to_cam": trv2c},
            "annos": {
                "name": np.array([classes[k] for k in labels] + ["DontCare"],
                                 object),
                "location": np.concatenate([loc, [[0.0, 1.0, 30.0]]]),
                "dimensions": np.concatenate([dims, [[1.0, 1.0, 1.0]]]),
                "rotation_y": np.concatenate([rot_y, [0.0]]),
                "difficulty": np.concatenate(
                    [rng.choice([0, 0, 1, 2], len(gt)), [0]]).astype(np.int32),
                "num_points_in_gt": np.concatenate([n_in, [0]]).astype(
                    np.int32),
            },
        })
    for name in ("waymo_infos_train.pkl", "waymo_infos_val.pkl"):
        with open(root / name, "wb") as f:
            pickle.dump(infos, f)
    return str(root / "waymo_infos_train.pkl")


def _median_ms(fn, reps=REPS):
    fn()  # warm-up
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return torch.device("cuda", 0), smi


def phase_build():
    from focalformer3d_tpu_torch.ops import cuda_build

    k1, k2, k3 = _wrappers()
    dot, gather, widen = _probe_wrappers()
    t0 = time.perf_counter()
    secs = cuda_build.build(k1.SOURCE, k1.WGRAD_SOURCE, k2.SOURCE,
                            k3.SOURCE, dot.SOURCE, gather.SOURCE,
                            widen.SOURCE)
    for k in (k1, k2, k3, dot, widen):
        k._load()
    k3._load_grid()
    k1._load_wgrad()
    k1._load_probe()
    k1._load_grid()
    gather._load("taps")
    gather._load("rows")
    print("build: " + ", ".join(f"{stem} {s:.2f} s" for stem, s in
                                secs.items())
          + f" (in parallel; all loaded after "
          f"{time.perf_counter() - t0:.2f} s)", flush=True)
    return secs


def _walk(cfg, vox, meta_chain, n_levels, batch=1):
    """The encoder's index chain on the first ``batch`` samples of a scan
    batch, levels 0 .. n_levels - 1: [(name, src level, dst level, kernel,
    stride, padding)], subm then down per level, conv_out after the last
    stage."""
    from focalformer3d_tpu_torch.models.sparse_encoder import Level

    lvl = Level.from_voxels(vox["coords"][:batch],
                            vox["voxel_mask"][:batch],
                            tuple(cfg.sparse_shape), meta_chain)
    geoms = []
    for i in range(n_levels):
        geoms.append((f"L{i} subm", lvl, lvl, 3, 1, 1))
        if i == len(cfg.encoder_channels) - 1:
            nxt = lvl.downsample((3, 1, 1), (2, 1, 1), 0, cfg.out_capacity)
            geoms.append(("conv_out", lvl, nxt, (3, 1, 1), (2, 1, 1), 0))
        else:
            pad = cfg.down_paddings[i]
            nxt = lvl.downsample(3, 2, pad, cfg.capacities[i + 1])
            geoms.append((f"down{i}", lvl, nxt, 3, 2, pad))
        lvl = nxt
    return geoms


def _convs(cfg, geoms):
    """[(name, geometry index, C, Cout, convs per scan)] of a chain."""
    ch, n_stage = cfg.encoder_channels, len(cfg.encoder_channels)
    convs = []
    for g, (name, *_rest) in enumerate(geoms):
        if name.endswith("subm"):
            i = int(name[1])
            n_basic = len(ch[i]) - (i < n_stage - 1)
            if i == 0:
                convs.append(("conv_input", g, cfg.voxel_feature_dim,
                              ch[0][0], 1))
            convs.append((name, g, ch[i][0], ch[i][0], 2 * n_basic))
        elif name == "conv_out":
            convs.append((name, g, ch[-1][-1], cfg.sparse_out_channels, 1))
        else:
            i = int(name[4])
            convs.append((name, g, ch[i][-2], ch[i][-1], 1))
    return convs


def _index_build(cfg, vox, engine, n_levels):
    from focalformer3d_tpu_torch.models.sparse_encoder import conv_index

    return [conv_index(src, dst, ks, st, pad, engine) for _, src, dst, ks,
            st, pad in _walk(cfg, vox, engine == "cuda_mxu", n_levels)]


def phase_index_builds(cfg, vox):
    """The three engines' index builds on one scan, end to end (CUDA events
    around host-issued work that ends on the device)."""
    n_stage = len(cfg.encoder_channels)
    rows = [("cuda (torch ops), L0-L1: 4 rulebooks", "cuda", 2),
            ("cuda_mxu (meta chain + K2), L0-L1: 4 rulebooks", "cuda_mxu",
             2),
            ("cuda_mxu (meta chain + K2), all levels: 8 rulebooks",
             "cuda_mxu", n_stage),
            ("cuda_zrun (torch ops + z-run plans), L0-L1: 4 plans",
             "cuda_zrun", 2)]
    for label, engine, n in rows:
        ms = _median_ms(lambda: _index_build(cfg, vox, engine, n))
        print(f"index build {label}: {ms:.3f} ms", flush=True)


def _rand_conv(gen, device, v_in, c, k, cout):
    feats = torch.randn(1, v_in, c, device=device, generator=gen)
    w = (torch.randn(k, c, cout, device=device, generator=gen)
         * (2.0 / (k * c)) ** 0.5)
    bias = torch.randn(cout, device=device, generator=gen)
    return feats.to(torch.bfloat16), w.to(torch.bfloat16), bias


def phase_k2(cfg, vox, mxu_geoms, device, tag=""):
    from focalformer3d_tpu_torch.ops import plan_builder as tpb
    from focalformer3d_tpu_torch.ops import sparse_conv as sc
    from focalformer3d_tpu_torch.tools import _common

    _, k2, _ = _wrappers()
    k2_ms = plain_ms = torch_ms = 0.0
    bound = Bound()  # meta rows and sites read, rules written; no FLOPs
    rules_by_geom = []
    for name, src, dst, ks, st, pad in mxu_geoms:
        args = (src.meta, dst.colz, src.capacity, ks, st, pad, src.shape,
                dst.shape[2])
        got = k2.plan_rules(*args)
        table = sc.VoxelTable(src.sites()[0], src.valid[0], src.meta[0])
        dst_sites = dst.sites()[0]

        def plain():
            return tpb.decode_rules(dst.colz[0], src.capacity, src.meta[0],
                                    *args[3:])

        def torch_op():
            return sc.build_conv_rules(table, src.shape, dst_sites,
                                       dst.valid[0], ks, st, pad)

        torch.cuda.synchronize()
        if not (torch.equal(got[0], plain()) and torch.equal(got[0],
                                                             torch_op())):
            raise RuntimeError(f"{tag}K2 {name}: rulebook differs from "
                               "decode_rules / build_conv_rules")
        ms = _common.time_ms(device, lambda: k2.plan_rules(*args))[0]
        p_ms = _common.time_ms(device, plain, _common.PLAIN_REPS)[0]
        t_ms = _common.time_ms(device, torch_op, _common.PLAIN_REPS)[0]
        print(f"{tag}K2 {name}: K {got.shape[1]}, V_in {src.capacity}, V_out "
              f"{dst.capacity} ({int(dst.valid.sum())} active), equal to "
              f"decode_rules and build_conv_rules; kernel {ms:.4f} ms, "
              f"decode_rules {p_ms:.4f} ms, build_conv_rules {t_ms:.4f} ms",
              flush=True)
        k2_ms, plain_ms, torch_ms = (k2_ms + ms, plain_ms + p_ms,
                                     torch_ms + t_ms)
        bound.add(src.meta.numel() * src.meta.element_size()
                  + dst.colz.numel() * dst.colz.element_size()
                  + got.numel() * got.element_size(), 0, "bf16")
        rules_by_geom.append(got)
    print(f"{tag}K2 per scan (8 rulebooks): kernel {k2_ms:.3f} ms, "
          f"decode_rules "
          f"{plain_ms:.3f} ms, build_conv_rules {torch_ms:.3f} ms, bound "
          f"{bound.ms:.4f} ms", flush=True)
    return rules_by_geom, {"max_abs_err": 0, "ms": k2_ms,
                           "plain_ms": plain_ms, "torch_op_ms": torch_ms,
                           **bound.keys()}


def _k1_geometry(tag, name, k1, args, plain, device):
    """K1 (``args`` of ``sparse_conv``) at one geometry: against ``plain``
    within ``KERNEL_TOL`` of its scale, two runs equal bit for bit, the hit
    shares of its rulebook, the launch's plan, and per-call times from
    CUDA-graph replay of production's route, the other route and the plain
    version. Returns (max abs err, ms, plain ms)."""
    from focalformer3d_tpu_torch.tools import _common

    feats, rules, w = args[:3]
    got, ref = k1.sparse_conv(*args), plain()
    again = k1.sparse_conv(*args)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    if not rel <= KERNEL_TOL:
        raise RuntimeError(f"{tag} {name}: rel err {rel:.3g} > {KERNEL_TOL}")
    if not torch.equal(got, again):
        raise RuntimeError(f"{tag} {name}: two runs differ")
    c, cout = k1.kernel_widths(feats.shape[2], w.shape[2])
    plan = k1.launch_plan(feats.shape[0], rules.shape[2], rules.shape[1],
                          c, cout)
    other = 1 - k1.route_for(c, cout)
    ms = _common.time_ms(device, lambda: k1.sparse_conv(*args))[0]
    other_ms, alt = _common.time_ms(
        device, lambda: k1.sparse_conv_probe(*args, route=other))
    if not float((alt - ref).abs().max()) <= KERNEL_TOL * float(ref.abs().max()):
        raise RuntimeError(f"{tag} {name}: route {k1.ROUTE_NAMES[other]} "
                           f"differs from plain")
    p_ms = _common.time_ms(device, plain, _common.PLAIN_REPS)[0]
    sh = k1.hit_shares(rules, feats.shape[1])
    print(f"{tag} {name}: C {feats.shape[2]} -> {w.shape[2]}, K "
          f"{rules.shape[1]}, B {feats.shape[0]}, V_in {feats.shape[1]} -> "
          f"V_out {rules.shape[2]}; hit share tile128/group64/strip16/site "
          f"{sh['tile']:.4f}/{sh['group64']:.4f}/{sh['strip16']:.4f}/"
          f"{sh['site']:.4f}; {plan['route']}, grid {plan['grid']}, "
          f"{plan['stages']} stages, W "
          f"{'resident' if plan['w_resident'] else 'streamed'}, "
          f"{plan['smem_bytes']} B shared; rel {rel:.3g}, two runs equal; "
          f"kernel {ms:.4f} ms ({k1.ROUTE_NAMES[other]} {other_ms:.4f}), "
          f"plain {p_ms:.4f} ms", flush=True)
    return err, ms, p_ms


def phase_k1(cfg, coord_geoms, coord_rules, mxu_geoms, mxu_rules, device,
             tag=""):
    """K1 at the 5 conv geometries of ``cuda`` (torch-op rulebooks) and the
    4 more that ``cuda_mxu`` runs (K2's rulebooks)."""
    k1, _, _ = _wrappers()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    n_coord = len(coord_geoms)
    jobs = [(c, coord_geoms, coord_rules) for c in _convs(cfg, coord_geoms)]
    jobs += [(c, mxu_geoms, mxu_rules) for c in _convs(cfg, mxu_geoms)
             if c[1] >= n_coord]
    max_err, per_scan = 0.0, {}
    bound = Bound()  # the 11 convs of a ``cuda`` scan
    for (name, g, c, cout, n), geoms, rules_by_geom in jobs:
        _, src, dst, *_rest = geoms[g]
        rules = rules_by_geom[g]
        feats, w, bias = _rand_conv(gen, device, src.capacity, c,
                                    rules.shape[1], cout)
        args = (feats, rules, w, dst.valid, bias)
        err, ms, p_ms = _k1_geometry(
            f"{tag}K1", f"{name} ({int(dst.valid.sum())} active)", k1, args,
            lambda: k1.apply_conv_plain(feats.float(), rules, w.float(),
                                        dst.valid, bias, torch.float32),
            device)
        max_err = max(max_err, err)
        per_scan[name] = (n, ms, p_ms)
        if geoms is coord_geoms:
            _conv_bound(bound, rules, src.capacity, dst.valid, c, cout,
                        times=n)

    def total(names):
        return (sum(per_scan[x][0] * per_scan[x][1] for x in names),
                sum(per_scan[x][0] * per_scan[x][2] for x in names))

    cuda_names = [c[0] for c in _convs(cfg, coord_geoms)]
    ms, plain_ms = total(cuda_names)
    mxu_ms, mxu_plain = total(list(per_scan))
    print(f"{tag}K1 per scan: cuda (11 convs) kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound.ms:.4f} ms; cuda_mxu (21 convs) "
          f"kernel {mxu_ms:.3f} ms, plain {mxu_plain:.3f} ms", flush=True)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            **bound.keys(), "ms_cuda_mxu": mxu_ms,
            "plain_ms_cuda_mxu": mxu_plain}


def _conv_bound(bound, rules, v_in, out_valid, c, cout, index_numel=None,
                times=1):
    """A forward conv (K1, K3): bf16 features and weights, the int32 index,
    bias and out_valid read once, the f32 output written once; 2 FLOPs per
    hit and (c, cout) pair, at the bf16 peak."""
    B, v_out = out_valid.shape
    K = rules.shape[1]
    nbytes = (B * v_in * c * 2 + (index_numel or rules.numel()) * 4
              + K * c * cout * 2 + cout * 4 + B * v_out
              + B * v_out * cout * 4)
    bound.add(nbytes, 2 * _hits(rules, v_in, out_valid) * c * cout, "bf16",
              times)


def phase_k3(cfg, vox, device, tag=""):
    """K3 at the 5 conv geometries of ``cuda_zrun``: against its plain
    version within ``KERNEL_TOL`` of its scale on both routes, two runs
    equal bit for bit, the hit shares of its codes, the launch's plan, and
    per-call times from CUDA-graph replay."""
    from focalformer3d_tpu_torch.models.sparse_encoder import conv_index
    from focalformer3d_tpu_torch.ops.sparse_conv_zrun import (
        apply_conv_zrun_plain, zrun_rules)
    from focalformer3d_tpu_torch.tools import _common

    k1, _, k3 = _wrappers()
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    geoms = _walk(cfg, vox, False, 2)
    codes = [conv_index(src, dst, ks, st, pad, "cuda_zrun")
             for _, src, dst, ks, st, pad in geoms]
    max_err = k3_ms = plain_ms = 0.0
    bound = Bound()  # hits counted on the rulebook the codes encode
    for name, g, c, cout, n in _convs(cfg, geoms):
        _, src, dst, *_rest = geoms[g]
        cd = codes[g]
        feats, w, bias = _rand_conv(gen, device, src.capacity, c,
                                    3 * cd.shape[1], cout)
        args = (feats, cd, w, dst.valid, bias)

        def plain():
            return apply_conv_zrun_plain(feats.float(), cd, w.float(),
                                         dst.valid, bias, torch.float32)

        got, ref = k3.zrun_conv(*args), plain()
        again = k3.zrun_conv(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if not err <= KERNEL_TOL * scale:
            raise RuntimeError(f"{tag}K3 {name}: rel err {err / scale:.3g} > "
                               f"{KERNEL_TOL}")
        if not torch.equal(got, again):
            raise RuntimeError(f"{tag}K3 {name}: two runs differ")
        kc, kcout = k1.kernel_widths(c, cout)
        other = 1 - k3.route_for(kc, kcout)
        plan = k3.launch_plan(1, cd.shape[2], cd.shape[1], kc, kcout)
        ms = _common.time_ms(device, lambda: k3.zrun_conv(*args))[0]
        other_ms, alt = _common.time_ms(
            device, lambda: k3.zrun_conv(*args, route=other))
        if not float((alt - ref).abs().max()) <= KERNEL_TOL * scale:
            raise RuntimeError(f"{tag}K3 {name}: route "
                               f"{k1.ROUTE_NAMES[other]} "
                               "differs from plain")
        p_ms = _common.time_ms(device, plain, _common.PLAIN_REPS)[0]
        sh = k3.zrun_hit_shares(cd)
        print(f"{tag}K3 {name}: C {c} -> {cout}, {cd.shape[1]} BEV taps, "
              f"V_in "
              f"{src.capacity} -> V_out {dst.capacity}; hit share "
              f"tile128/group64/strip16/site {sh['tile']:.4f}/"
              f"{sh['group64']:.4f}/{sh['strip16']:.4f}/{sh['site']:.4f}; "
              f"{plan['route']}, grid {plan['grid']}, {plan['stages']} "
              f"stages of {plan['z_per_stage']} z taps, W "
              f"{'resident' if plan['w_resident'] else 'streamed'}, "
              f"{plan['smem_bytes']} B shared; rel {err / scale:.3g}, two "
              f"runs equal; kernel {ms:.4f} ms ({k1.ROUTE_NAMES[other]} "
              f"{other_ms:.4f}), plain {p_ms:.4f} ms", flush=True)
        max_err = max(max_err, err)
        k3_ms, plain_ms = k3_ms + n * ms, plain_ms + n * p_ms
        _conv_bound(bound, zrun_rules(cd, src.capacity), src.capacity,
                    dst.valid, c, cout, index_numel=cd.numel(), times=n)
    print(f"{tag}K3 per scan (11 convs): kernel {k3_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound.ms:.4f} ms", flush=True)
    return {"max_abs_err": max_err, "ms": k3_ms, "plain_ms": plain_ms,
            **bound.keys()}


def _model(cfg, device):
    from focalformer3d_tpu_torch.models.detector import FocalFormer3D
    from focalformer3d_tpu_torch.utils.ref_keys import make_fake_state_dict

    model = FocalFormer3D(cfg).eval()
    model.load_state_dict(make_fake_state_dict(model, seed=0), strict=True)
    return model.to(device)


def phase_slice(cfg, model, engine, scans, name=None, kept_exact=True):
    """Three scans on one engine; returns the (K1, K2, K3) launches, counted
    from zero just before the first scan and read just after the last.
    ``name`` labels a config other than FocalFormer3D_L; without
    ``kept_exact`` a scan keeps 1 to 200 boxes, not exactly 200."""
    from focalformer3d_tpu_torch.models.detector import preprocess_points

    kernels = _wrappers()
    enc = model.pts_middle_encoder
    enc.engine = engine
    enc_events = []

    def mark(*_):  # CUDA event at the encoder's entry and exit
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        enc_events.append(ev)

    hooks = [enc.register_forward_pre_hook(mark),
             enc.register_forward_hook(mark)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall, split = [], []
    for k in kernels:
        k.reset_launch_count()
    try:
        for pts, mask in scans:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            t0 = time.perf_counter()
            ev[0].record()
            vox = preprocess_points(cfg, pts, mask)
            ev[1].record()
            dec = model.get_bboxes(model(vox), 200)
            ev[2].record()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            e_in, e_out = enc_events[-2], enc_events[-1]
            t_vox = ev[0].elapsed_time(ev[1])
            t_enc = e_in.elapsed_time(e_out)
            split.append((t_vox, t_enc, ev[1].elapsed_time(ev[2]) - t_enc))
            for k in ("bboxes", "scores"):
                if not torch.isfinite(dec[k]).all():
                    raise RuntimeError(f"{engine}: non-finite {k}")
            kept = int(dec["mask"].sum())
            dim = 9 if cfg.decoder.with_vel else 7
            if dec["bboxes"].shape[-1] != dim or not (
                    kept == 200 if kept_exact else 0 < kept <= 200):
                raise RuntimeError(f"{engine}: expected 200 kept {dim}-dim "
                                   f"boxes, got {kept} of "
                                   f"{tuple(dec['bboxes'].shape)}")
    finally:
        for h in hooks:
            h.remove()
    launches = tuple(k.launch_count() for k in kernels)
    want = tuple(n * len(scans) for n in LAUNCHES_PER_SCAN[engine])
    if launches != want:
        raise RuntimeError(f"{engine}: (K1, K2, K3) launched {launches} "
                           f"times for {len(scans)} scans, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(wall)
    label = f"{name} {engine}" if name else engine
    print(f"slice {label}: ms/scan " + ", ".join(f"{t:.1f}" for t in wall)
          + f" (median {med:.1f}); voxelize/encoder/rest ms "
          + "; ".join("/".join(f"{x:.1f}" for x in s) for s in split)
          + f"; peak memory {peak / 2**30:.2f} GiB; (K1, K2, K3) launches "
          f"{launches}", flush=True)
    return launches


def _voxel_features(model, cfg, vox):
    """The sparse encoder's input features of ``preprocess_points``'s
    output: the HardVFE's (the Waymo configs) or the mean VFE's."""
    if cfg.vfe_type == "HardVFE":
        return model.pts_voxel_encoder(vox["voxels"], vox["num_points"])
    return vox["features"]


def phase_engine_parity(cfg, model, device, scan=None, tag=""):
    from focalformer3d_tpu_torch.models.detector import preprocess_points
    from focalformer3d_tpu_torch.models.sparse_encoder import SparseEncoder

    pts, mask = scan or _scan(cfg, 0, device)
    vox = preprocess_points(cfg, pts, mask)
    enc = model.pts_middle_encoder
    plain = SparseEncoder(
        in_channels=cfg.voxel_feature_dim, sparse_shape=cfg.sparse_shape,
        output_channels=cfg.sparse_out_channels,
        encoder_channels=cfg.encoder_channels,
        down_paddings=cfg.down_paddings, capacities=cfg.capacities,
        out_capacity=cfg.out_capacity, engine="plain",
    ).to(device).eval()
    plain.load_state_dict(enc.state_dict(), strict=True)
    args = (_voxel_features(model, cfg, vox), vox["coords"],
            vox["voxel_mask"])
    ref = {}
    for engine in ENGINES:
        enc.engine = engine
        dense_from = 4 if engine == "cuda_mxu" else cfg.sparse_dense_from_eval
        if dense_from not in ref:
            plain.dense_from = dense_from
            ref[dense_from] = plain(*args)
        got = enc(*args)
        torch.cuda.synchronize()
        r = ref[dense_from]
        rel = float((got - r).abs().max() / r.abs().max())
        if not rel <= ENGINE_TOL:
            raise RuntimeError(f"{tag}BEV {engine} vs plain engine rel "
                               f"{rel:.3g}")
        print(f"{tag}engine parity: BEV {tuple(got.shape)} {engine} vs plain "
              f"engine (dense_from={dense_from}) max rel diff {rel:.3g} "
              f"(limit {ENGINE_TOL})", flush=True)


def _train_batch(cfg, device):
    from focalformer3d_tpu_torch.data import synthetic

    batch = synthetic.make_batch(
        np.random.RandomState(TRAIN_SEED), batch_size=TRAIN_BATCH,
        n_points=N_POINTS, n_boxes=24, max_gts=32,
        num_classes=cfg.decoder.num_classes,
        pc_range=cfg.voxel.point_cloud_range, mode="radial",
    )
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def phase_k1_grad(cfg, batch, device):
    """K1's differentiable conv at each conv of a training batch (engine
    ``cuda``, dense from L3), against autograd through its plain version;
    then each kernel alone against its plain version. Returns per kernel
    use (forward, dx, wgrad) the max error, per-step ms and bound."""
    from focalformer3d_tpu_torch.models.detector import preprocess_points
    from focalformer3d_tpu_torch.models.sparse_encoder import conv_index
    from focalformer3d_tpu_torch.ops import sparse_conv as sc
    from focalformer3d_tpu_torch.tools import _common

    k1, _, _ = _wrappers()
    bf16 = torch.bfloat16
    vox = preprocess_points(cfg, batch["points"], batch["points_mask"],
                            train=True)
    B = vox["coords"].shape[0]
    geoms = _walk(cfg, vox, False, cfg.sparse_dense_from, batch=B)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    stats = {kind: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                    "bound": Bound()}
             for kind in ("forward", "dx", "wgrad")}
    for name, g, c, cout, n in _convs(cfg, geoms):
        _, src, dst, ks, st, pad = geoms[g]
        rules = conv_index(src, dst, ks, st, pad, "cuda")
        rules_t = rules if st == 1 else torch.stack([
            sc.transpose_rules(rules[b], src.capacity) for b in range(B)])
        K = rules.shape[1]
        x = torch.where(src.valid[..., None], torch.randn(
            B, src.capacity, c, device=device, generator=gen), 0.0)
        w = (torch.randn(K, c, cout, device=device, generator=gen)
             * (2.0 / (K * c)) ** 0.5)
        cot = torch.where(dst.valid[..., None], torch.randn(
            B, dst.capacity, cout, device=device, generator=gen), 0.0)
        need_dx = name != "conv_input"  # as on the main path
        res = {}
        for tag in ("kernel", "plain"):
            xx = x.clone().requires_grad_(need_dx)
            ww = w.clone().requires_grad_(True)
            with torch.enable_grad():
                if tag == "kernel":
                    y = k1.sparse_conv_train(xx, rules, rules_t, ww,
                                             dst.valid)
                else:
                    y = k1.apply_conv_bf16_plain(xx, rules, ww, dst.valid)
                y.backward(cot)
            res[tag] = {"forward": y.detach(), "dx": xx.grad,
                        "wgrad": ww.grad}
        torch.cuda.synchronize()

        xb, wb = x.to(bf16), w.to(bf16)
        w_tb = wb.flip(0).transpose(1, 2).contiguous()
        w_t = w_tb.float()
        every = torch.ones(B, src.capacity, dtype=torch.bool, device=device)
        runs = {
            "forward": (lambda: k1.sparse_conv(xb, rules, wb, dst.valid),
                        lambda: k1.apply_conv_plain(
                            xb.float(), rules, wb.float(), dst.valid)),
            "dx": (lambda: k1.conv_dx(cot, rules_t, wb),
                   lambda: k1.apply_conv_plain(
                       cot.to(bf16).float(), rules_t, w_t, every)),
            "wgrad": (lambda: k1.conv_wgrad(xb, cot, rules),
                      lambda: k1.wgrad_plain(xb, cot, rules)),
        }
        # K1's operands per use, for the route production does not take
        k1_args = {"forward": (xb, rules, wb, dst.valid),
                   "dx": (cot.to(bf16), rules_t, w_tb, every)}
        hits = _hits(rules, src.capacity, dst.valid)
        flops = 2 * hits * c * cout
        w_elems = K * c * cout
        nbytes = {  # each input read once, each output written once
            "dx": (B * dst.capacity * cout * 4 + rules_t.numel() * 4
                   + w_elems * 2 + B * src.capacity * c * 4),
            "wgrad": (B * src.capacity * c * 2 + B * dst.capacity * cout * 4
                      + rules.numel() * 4 + w_elems * 4),
        }
        line = []
        for kind, (run, plain) in runs.items():
            if kind == "dx" and not need_dx:
                continue
            got, ref = res["kernel"][kind], res["plain"][kind]
            err = float((got - ref).abs().max())
            rel = err / float(ref.abs().max())
            if not rel <= KERNEL_TOL:
                raise RuntimeError(f"K1 {kind} {name}: rel err {rel:.3g} > "
                                   f"{KERNEL_TOL}")
            ms = _common.time_ms(device, run)[0]  # the device's time
            p_ms = _common.time_ms(device, plain, _common.PLAIN_REPS)[0]
            if kind == "wgrad":
                if not torch.equal(run(), run()):
                    raise RuntimeError(f"K1 wgrad {name}: two runs differ")
                chunk = k1.wgrad_chunk(*(next(n for n in k1.COUTS if n >= w)
                                         for w in (c, cout)))
                slices, per = k1.wgrad_slices(B * dst.capacity, K)
                note = (f" [{k1.ROUTE_NAMES[k1.WGRAD_ROUTE]}, chunk {chunk} "
                        f"hits, {slices} slices of {per} sites, two runs "
                        "equal]")
            else:
                a = k1_args[kind]
                kc, kcout = k1.kernel_widths(a[0].shape[2], a[2].shape[2])
                plan = k1.launch_plan(B, a[1].shape[2], K, kc, kcout)
                # the kernel alone on prepared operands, on each route (the
                # wrapper's time above includes dx's casts and transposes)
                alone = {name: _common.time_ms(
                    device, lambda r=r: k1.sparse_conv_probe(*a, route=r))[0]
                    for r, name in k1.ROUTE_NAMES.items()}
                sh = k1.hit_shares(a[1], a[0].shape[1])
                note = (f" [{plan['route']}, grid {plan['grid']}, W "
                        f"{'resident' if plan['w_resident'] else 'streamed'}"
                        f"; kernel alone " + ", ".join(
                            f"{n} {t:.4f}" for n, t in alone.items())
                        + " ms; hit share "
                        f"tile128/group64/strip16/site {sh['tile']:.4f}/"
                        f"{sh['group64']:.4f}/{sh['strip16']:.4f}/"
                        f"{sh['site']:.4f}]")
            s = stats[kind]
            s["max_abs_err"] = max(s["max_abs_err"], err)
            s["ms"] += n * ms
            s["plain_ms"] += n * p_ms
            if kind == "forward":
                _conv_bound(s["bound"], rules, src.capacity, dst.valid, c,
                            cout, times=n)
            else:
                s["bound"].add(nbytes[kind], flops,
                               "bf16 split" if kind == "wgrad" else "bf16",
                               times=n)
            line.append(f"{kind} rel {rel:.3g}, {ms:.4f} / {p_ms:.4f} ms"
                        + note)
        print(f"K1 train {name} x{n}: C {c} -> {cout}, K {K}, V_in "
              f"{src.capacity} -> V_out {dst.capacity} (B {B}, "
              f"{int(dst.valid.sum())} active, {hits} hits); kernel / plain: "
              + "; ".join(line), flush=True)
    out = {}
    for kind, s in stats.items():
        bound = s.pop("bound")
        out[kind] = {**s, **bound.keys()}
        print(f"K1 {kind} per training step ({TRAIN_LAUNCHES_PER_STEP[kind]}"
              f" launches): kernel {s['ms']:.3f} ms, plain "
              f"{s['plain_ms']:.3f} ms, bound {bound.ms:.4f} ms "
              f"({out[kind]['bound_by']})", flush=True)
    return out


def phase_train(cfg, batch, device):
    """``TRAIN_STEPS`` training steps of FocalFormer3D_L on engine ``cuda``;
    returns the K1 forward / dx / dW launches, counted from zero just
    before the first step and read just after the last."""
    from focalformer3d_tpu_torch.configs import get_config
    from focalformer3d_tpu_torch.models.detector import FocalFormer3D
    from focalformer3d_tpu_torch.training import optim, train_step
    from focalformer3d_tpu_torch.training.train_step import PHASES
    from focalformer3d_tpu_torch.utils.ref_keys import make_fake_state_dict

    k1, _, _ = _wrappers()
    model = FocalFormer3D(cfg)
    model.load_state_dict(make_fake_state_dict(model, seed=0), strict=True)
    model = model.to(device)
    tx = optim.make_optimizer(total_steps=100)
    opt_state = tx.init(list(model.parameters()))
    step = train_step.make_train_step(
        cfg, get_config("FocalFormer3D_L")["loss"], tx)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall, split, peaks = [], [], []
    k1.reset_launch_count()
    for i in range(TRAIN_STEPS):
        events, mem = [], []

        def mark(_name):  # no synchronise: an event and the allocator
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            mem.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()

        t0 = time.perf_counter()
        mark("start")
        metrics = step(model, opt_state, batch, gen, mark)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        split.append([a.elapsed_time(b)
                      for a, b in zip(events[:-1], events[1:])])
        peaks.append(mem[1:])
        vals = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in vals.items() if not math.isfinite(v)]
        if bad:
            raise RuntimeError(f"train step {i}: non-finite {bad}")
        print(f"train step {i}: {wall[-1]:.1f} ms; " + ", ".join(
            f"{k} {vals[k]:.5g}" for k in sorted(vals)), flush=True)
    launches = {kind: k1.launch_count(kind)
                for kind in TRAIN_LAUNCHES_PER_STEP}
    want = {kind: n * TRAIN_STEPS
            for kind, n in TRAIN_LAUNCHES_PER_STEP.items()}
    if launches != want:
        raise RuntimeError(f"train: K1 forward/dx/dW launched {launches} "
                           f"times in {TRAIN_STEPS} steps, expected {want}")
    peak = max(max(p) for p in peaks)
    phase_peak = [max(p[j] for p in peaks) for j in range(len(peaks[0]))]
    after = model.state_dict()
    params = [k for k, _ in model.named_parameters()]
    still = [k for k in params if torch.equal(after[k], before[k])]
    stats = [k for k in after if k.endswith("running_mean")]
    still_bn = [k for k in stats if torch.equal(after[k], before[k])]
    if still or still_bn:
        raise RuntimeError(f"train: unchanged after {TRAIN_STEPS} steps: "
                           f"{(still + still_bn)[:8]}")
    rest = split[1:]
    med = [statistics.median(s[j] for s in rest) for j in range(len(PHASES))]
    print(f"train: FocalFormer3D_L float32, batch {TRAIN_BATCH}, engine "
          f"cuda: ms/step first {wall[0]:.1f}, then "
          + ", ".join(f"{t:.1f}" for t in wall[1:])
          + f" (median {statistics.median(wall[1:]):.1f}); split median ms "
          + ", ".join(f"{p} {t:.1f}" for p, t in zip(PHASES, med))
          + f" (first step: " + ", ".join(f"{t:.1f}" for t in split[0])
          + f"); peak memory {peak / 2**30:.2f} GiB (by phase, GiB: "
          + ", ".join(f"{p} {m / 2**30:.2f}"
                      for p, m in zip(PHASES, phase_peak))
          + f"); {len(params)} "
          f"parameters and {len(stats)} running means all moved; K1 "
          f"launches {launches}", flush=True)
    _profile_step(lambda: step(model, opt_state, batch, gen))
    return launches


def _profile_step(run, tag="train profile"):
    """One more step under ``torch.profiler`` (after the timed ones):
    kernels launched, device busy time (union of kernel intervals) against
    the step's host time, and the kernels that take the most; each line
    begins with ``tag``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -math.inf
    for s, e in spans:  # union of intervals, us
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name, count = {}, {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        count[e.name] = count.get(e.name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(f"{tag} (one step, profiler on): {len(kernels)} kernels, "
          f"device busy {busy / 1e3:.1f} ms of {wall:.1f} ms host time "
          f"(share {busy / 1e3 / wall:.2f}); top kernels ms (launches): "
          + "; ".join(f"{n[:60]} {t / 1e3:.2f} ({count[n]})" for n, t in top),
          flush=True)
    # who launched the three largest: the outermost aten op above each
    # launch, with its input shapes, most time first (the profiler can list
    # one kernel under several ops, so only the order is printed)
    owners = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        op, p = e, e.cpu_parent
        while p is not None:
            if p.name.startswith("aten::"):
                op = p
            p = p.cpu_parent
        label = f"{op.name} {op.input_shapes}"[:110]
        for k in e.kernels:
            d = owners.setdefault(k.name, {})
            d[label] = d.get(label, 0.0) + k.duration
    for name, _ in top[:3]:
        ops = sorted(owners.get(name, {}).items(), key=lambda kv: -kv[1])
        print(f"{tag}: {name[:60]} launched by: "
              + "; ".join(lab for lab, _ in ops[:3]), flush=True)


def _run_cli(main, argv):
    """``main(argv)`` with its standard output captured, then echoed;
    returns (its result, its one JSON line parsed, if it prints one)."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            result = main(argv)
    finally:
        print(buf.getvalue(), end="", flush=True)
    text = buf.getvalue()
    found = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
    if len(found) > 1:
        raise RuntimeError(f"{argv[:2]}: {len(found)} JSON lines")
    return result, (found[0] if found else None)


def _model_path_launches():
    from focalformer3d_tpu_torch.training.train_step import kernel_launches

    return {LAUNCH_ROWS[k]: n for k, n in kernel_launches().items()}


def _phase_train_cli(work, card):
    from focalformer3d_tpu_torch.tools import train as train_cli
    from focalformer3d_tpu_torch.training import checkpoint as ckpt

    argv = ["FocalFormer3D_L", "--synthetic", "--epochs", "2",
            "--iters-per-epoch", "2", "--keep-last", "1", "--log-interval",
            "1", "--batch-size", str(TRAIN_BATCH), "--work-dir", work,
            "--no-tensorboard"]
    # as a process of its own starts (cuDNN may round float32 to TF32):
    # the CLI must set its own precision
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    for f in flags:
        f.allow_tf32 = True
    run, _ = _run_cli(train_cli.main, argv)
    if any(f.allow_tf32 for f in flags):
        raise RuntimeError("train CLI: TF32 left allowed")
    with open(f"{work}/train_log.jsonl") as fh:
        recs = [json.loads(x) for x in fh]
    losses = [r["loss"] for r in recs if r["mode"] == "train"]
    secs = [r["time"] for r in recs if r["mode"] == "train"]
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"train CLI: losses {losses}")
    if ckpt.list_epochs(work) != [2] or run.opt_state.count != 4:
        raise RuntimeError(f"train CLI: epochs {ckpt.list_epochs(work)} "
                           f"saved, step {run.opt_state.count}")
    again, _ = _run_cli(train_cli.main, argv)
    if again.start_epoch != 2 or again.opt_state.count != 4:
        raise RuntimeError(f"train CLI: resumed at epoch "
                           f"{again.start_epoch}, step "
                           f"{again.opt_state.count}")
    ref, got = run.model.state_dict(), again.model.state_dict()
    diff = [k for k in ref if not torch.equal(ref[k], got[k])]
    diff += [n for n, a, b in zip(run.opt_state.names,
                                  run.opt_state.mu + run.opt_state.nu,
                                  again.opt_state.mu + again.opt_state.nu)
             if not torch.equal(a, b)]
    if diff:
        raise RuntimeError(f"train CLI: resumed state differs: {diff[:5]}")
    print(f"entry points ({card}): train CLI losses " + ", ".join(
        f"{x:.4f}" for x in losses) + "; s/it (synthetic) " + ", ".join(
        f"{x:.3f}" for x in secs) + "; epoch_2 kept, epoch_1 pruned; "
        f"resumed at epoch 2, step 4, {len(ref)} tensors and the moments "
        "bit for bit; TF32 off after the CLI set its precision",
        flush=True)


def _phase_freeze(cfg, batch, device):
    """Two steps of FocalFormer3D_L with ``freeze_pts``."""
    from focalformer3d_tpu_torch.configs import get_config
    from focalformer3d_tpu_torch.models.detector import FocalFormer3D
    from focalformer3d_tpu_torch.training import optim, train_step
    from focalformer3d_tpu_torch.utils.ref_keys import make_fake_state_dict

    k1, _, _ = _wrappers()
    fcfg = dataclasses.replace(cfg, freeze_pts=True)
    model = FocalFormer3D(fcfg)
    model.load_state_dict(make_fake_state_dict(model, seed=0), strict=True)
    model = model.to(device)
    tx = optim.make_optimizer(total_steps=100)
    opt_state = tx.init(model.named_parameters())
    step = train_step.make_train_step(
        fcfg, get_config("FocalFormer3D_L")["loss"], tx)
    gen = torch.Generator(device=device)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    before_k1 = {k: k1.launch_count(k) for k in ("forward", "dx", "wgrad")}
    for i in range(2):
        gen.manual_seed(i)
        metrics = step(model, opt_state, batch, gen)
        if not all(math.isfinite(float(v)) for v in metrics.values()):
            raise RuntimeError(f"freeze_pts step {i}: non-finite metrics")
    per_step = {k: (k1.launch_count(k) - n) / 2
                for k, n in before_k1.items()}
    want = {"forward": LAUNCHES_PER_SCAN["cuda"][0], "dx": 0, "wgrad": 0}
    if per_step != want:
        raise RuntimeError(f"freeze_pts: K1 launches per step {per_step}, "
                           f"expected {want}")
    after = model.state_dict()
    pts = ("pts_middle_encoder.", "pts_backbone.", "pts_neck.",
           "imgpts_neck.shared_conv_pts.")
    frozen = [k for k in after if k.startswith(pts)]
    changed = [k for k in frozen if not torch.equal(after[k], before[k])]
    head = [k for k in after if k.startswith("pts_bbox_head.")]
    moved = [k for k in head if not torch.equal(after[k], before[k])]
    if changed or len(moved) < len(head) // 2:
        raise RuntimeError(f"freeze_pts: frozen tensors changed "
                           f"{changed[:5]}; head moved {len(moved)} of "
                           f"{len(head)}")
    print(f"entry points: freeze_pts, 2 steps: {len(frozen)} point-branch "
          f"tensors (parameters, batch-norm statistics, shared_conv_pts) "
          f"bit-identical, {len(moved)} of {len(head)} head tensors moved; "
          f"K1 forward / dx / dW per step {per_step}", flush=True)


def phase_entry_points(cfg, batch, device, card):
    """The train and benchmark CLIs and a frozen-branch run; returns the
    model-path kernels' launches, counted from zero just before the phase
    and read just after."""
    import tempfile

    from focalformer3d_tpu_torch.tools import benchmark

    t0 = time.perf_counter()
    for k in _wrappers():
        k.reset_launch_count()
    with tempfile.TemporaryDirectory() as work:
        _phase_train_cli(work, card)
    torch.cuda.empty_cache()
    _phase_freeze(cfg, batch, device)
    torch.cuda.empty_cache()
    _, rec = _run_cli(benchmark.main, [
        "FocalFormer3D_L", "--engines", ",".join(ENGINES), "--samples", "3",
        "--warmup", "1"])
    if rec is None or sorted(rec["engines"]) != sorted(ENGINES):
        raise RuntimeError(f"benchmark: no JSON line for {ENGINES}")
    torch.cuda.empty_cache()
    _, rec = _run_cli(benchmark.main, [
        "FocalFormer3D_L", "--train", "--samples", "2", "--batch-size",
        str(TRAIN_BATCH), "--engines", ",".join(ENGINES)])
    if rec is None or list(rec["engines"]) != list(ENGINES) or not all(
            math.isfinite(r["ms_per_step"]["median"])
            for r in rec["engines"].values()):
        raise RuntimeError(f"benchmark --train: no JSON line for {ENGINES}")
    torch.cuda.empty_cache()
    launches = _model_path_launches()
    if not all(launches.values()):
        raise RuntimeError(f"entry points: a kernel was not launched: "
                           f"{launches}")
    print(f"entry points: {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}", flush=True)
    return launches


def _host_ms(cfg_all, root):
    """Host ms per sample of the train CLI's data path
    (``tools.train.nuscenes_batches``: ``get_sample`` through the train
    pipeline with GT-paste, then ``collate`` at batch 2), over every sample
    of the written directory."""
    from focalformer3d_tpu_torch.data import nuscenes as nusc
    from focalformer3d_tpu_torch.tools import train as train_cli

    classes = cfg_all["class_names"]
    cfg = cfg_all["model"]
    rng = np.random.RandomState(0)
    _, _, ds = train_cli.nuscenes_batches(
        train_cli.parse_args(["FocalFormer3D_L", "--data-root", root]),
        cfg_all, 2, rng)
    get_ms, collate_ms, n_pts, n_gts = [], [], [], []
    for i in range(0, len(ds), 2):
        t0 = time.perf_counter()
        samples = [ds.get_sample(j, rng) for j in (i, i + 1)]
        t1 = time.perf_counter()
        nusc.collate(samples, classes, max_points=300000,
                     max_gts=cfg.decoder.max_gts // 4)
        t2 = time.perf_counter()
        get_ms.append((t1 - t0) * 1e3 / 2)
        collate_ms.append((t2 - t1) * 1e3 / 2)
        n_pts += [len(s["points"]) for s in samples]
        n_gts += [len(s["gt_boxes"]) for s in samples]
    return get_ms, collate_ms, n_pts, n_gts


def _check_submission(path, n_samples, engine):
    with open(path) as fh:
        sub = json.load(fh)["results"]
    if len(sub) != n_samples:
        raise RuntimeError(f"test CLI {engine}: {len(sub)} tokens in the "
                           f"submission, expected {n_samples}")
    for token, anns in sub.items():
        vals = [x for a in anns for k in ("translation", "size", "rotation",
                                          "velocity") for x in a[k]]
        vals += [a["detection_score"] for a in anns]
        if len(anns) > 500 or not all(math.isfinite(x) for x in vals):
            raise RuntimeError(f"test CLI {engine}: {token}: {len(anns)} "
                               "boxes or non-finite values")
    return sum(len(a) for a in sub.values())


def phase_dataset(card, tmp):
    """The train and test CLIs on a nuScenes-format directory written in
    ``tmp``; returns the model-path kernels' launches, counted from zero
    just before the train CLI and read just after the last test CLI, the
    directory and the trained checkpoint."""
    from focalformer3d_tpu_torch.configs import get_config
    from focalformer3d_tpu_torch.data import native
    from focalformer3d_tpu_torch.tools import create_data
    from focalformer3d_tpu_torch.tools import test as test_cli
    from focalformer3d_tpu_torch.tools import train as train_cli
    from focalformer3d_tpu_torch.training import checkpoint as ckpt

    t_phase = time.perf_counter()
    cfg_all = get_config("FocalFormer3D_L")
    k1, _, _ = _wrappers()
    root = f"{tmp}/nuscenes"
    t0 = time.perf_counter()
    ann = write_nuscenes(
        root, seed=DATASET_SEED, samples=DATASET_SAMPLES,
        points=DATASET_POINTS, sweeps=DATASET_SWEEPS,
        pc_range=cfg_all["model"].voxel.point_cloud_range,
        classes=cfg_all["class_names"])
    t1 = time.perf_counter()
    create_data.create_gt_database(ann, root, root)
    print(f"dataset ({card}): wrote {DATASET_SAMPLES} samples of a "
          f"{DATASET_POINTS}-point key frame and {DATASET_SWEEPS} sweeps "
          f"in {t1 - t0:.1f} s, GT database in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    get_ms, collate_ms, n_pts, n_gts = _host_ms(cfg_all, root)
    print(f"dataset host ms per sample ({card}; train pipeline with "
          f"GT-paste, batch 2): get_sample " + ", ".join(
              f"{x:.1f}" for x in get_ms) + "; collate " + ", ".join(
              f"{x:.1f}" for x in collate_ms) + f"; points per sample "
          f"{min(n_pts)}-{max(n_pts)}, GT boxes {min(n_gts)}-"
          f"{max(n_gts)}", flush=True)

    work = f"{tmp}/work"
    for k in _wrappers():
        k.reset_launch_count()
    native.reset_call_count()
    run, _ = _run_cli(train_cli.main, [
        "FocalFormer3D_L", "--data-root", root, "--epochs", "2",
        "--iters-per-epoch", "2", "--batch-size", str(TRAIN_BATCH),
        "--log-interval", "1", "--work-dir", work, "--no-tensorboard"])
    with open(f"{work}/train_log.jsonl") as fh:
        recs = [r for r in map(json.loads, fh) if r["mode"] == "train"]
    losses = [r["loss"] for r in recs]
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"dataset train CLI: losses {losses}")
    if 2 not in ckpt.list_epochs(work):
        raise RuntimeError(f"dataset train CLI: epochs "
                           f"{ckpt.list_epochs(work)} saved")
    launches = {kind: k1.launch_count(kind)
                for kind in TRAIN_LAUNCHES_PER_STEP}
    want = {kind: 4 * n for kind, n in TRAIN_LAUNCHES_PER_STEP.items()}
    if launches != want:
        raise RuntimeError(f"dataset train CLI: K1 forward/dx/dW "
                           f"{launches}, expected {want}")
    # the first batch (drawn as JAX draws it to initialise) + 4 steps
    loads = native.call_count()
    if loads != 5 * TRAIN_BATCH:
        raise RuntimeError(f"dataset train CLI: {loads} native loads, "
                           f"expected {5 * TRAIN_BATCH}")
    if any(type(t).__name__ == "ObjectSample"
           for t in run.pipeline.transforms):
        raise RuntimeError("dataset train CLI: Fading left ObjectSample")
    print(f"dataset train CLI ({card}; FocalFormer3D_L float32, batch "
          f"{TRAIN_BATCH}, GT-paste, Fading at epoch 1): losses "
          + ", ".join(f"{x:.4f}" for x in losses) + "; s/it "
          + ", ".join(f"{r['time']:.3f}" for r in recs)
          + f"; epoch_2 saved; K1 forward/dx/dW {launches}; {loads} "
          "native loads; ObjectSample gone after Fading", flush=True)
    torch.cuda.empty_cache()

    for engine, want in DATASET_TEST_LAUNCHES.items():
        before = _model_path_launches()
        out = f"{tmp}/sub_{engine}.json"
        res, rec = _run_cli(test_cli.main, [
            "FocalFormer3D_L", "--data-root", root, "--checkpoint",
            f"{work}/epoch_2", "--limit", str(DATASET_SAMPLES),
            "--engine", engine, "--out", out, "--tracking-out",
            f"{tmp}/trk_{engine}.json"])
        got = {k: n - before[k] for k, n in _model_path_launches().items()}
        full = {k: want.get(k, 0) for k in got}
        if got != full:
            raise RuntimeError(f"dataset test CLI {engine}: launches "
                               f"{got}, expected {full}")
        keys = {"mAP", "mATE", "mASE", "mAOE", "mAVE", "nds_no_attr"}
        keys |= {f"AP_{c}" for c in cfg_all["class_names"]}
        if rec is None or set(rec) != keys:
            raise RuntimeError(f"dataset test CLI {engine}: metrics "
                               f"{rec}")
        n_boxes = _check_submission(out, DATASET_SAMPLES, engine)
        steady = (res.samples - 1) / (res.seconds - res.seconds_first)
        print(f"dataset test CLI {engine} ({card}): "
              f"{res.samples / res.seconds:.3f} samples/s ("
              f"{res.samples} samples in {res.seconds:.2f} s, the first "
              f"in {res.seconds_first:.2f} s; after it {steady:.3f} "
              f"samples/s); {n_boxes} boxes in the submission, all "
              f"finite; mAP {rec['mAP']}, nds_no_attr "
              f"{rec['nds_no_attr']}; launches {got}", flush=True)
        torch.cuda.empty_cache()
    launches = _model_path_launches()
    print(f"dataset ({card}): {time.perf_counter() - t_phase:.1f} s; launches "
          f"{launches}", flush=True)
    return launches, root, f"{work}/epoch_2"


def _probe_launches():
    k1, _, _ = _wrappers()
    dot, gather, widen = _probe_wrappers()
    return {"micro_dot": dot.launch_count(),
            "micro_gather_taps": gather.launch_count("taps"),
            "micro_gather_rows": gather.launch_count("rows"),
            "micro_widen": widen.launch_count(),
            "sparse_conv_probe": k1.launch_count("probe")}


def _probe_line(name, rows, secs, launches):
    def case(r):
        if r["kernel"] is None:
            return f"{r['case']}: {r['op']} {r['library_ms']:.4f}"
        tag = f"[{r['route']}]" if r.get("route") else ""
        route = f" {tag}" if tag and tag not in r["case"] else ""
        text = (f"{r['case']}{route}: {r['ms']:.4f} (plain "
                f"{r['plain_ms']:.3f}")
        if r["library_ms"] is not None:
            text += (f", {r['op']} {r['library_ms']:.4f}, ratio "
                     f"{r['ms'] / r['library_ms']:.3f}")
        return text + ")"

    probes = ", ".join(sorted({r["probe"] for r in rows}))
    launched = ", ".join(f"{k} {n}" for k, n in launches.items() if n)
    return (f"probe {name} ({probes}, {len(rows)} cases, all "
            f"checks passed, {secs:.1f} s; launches: {launched}; kernel ms"
            f"): " + "; ".join(case(r) for r in rows))


def phase_probes(device):
    """Every probe module at its full size; returns the headline row and
    the largest error of each probe kernel, and the launches of the five
    probe kernels, counted from zero just before the first probe and read
    just after the last."""
    import importlib

    k1, _, _ = _wrappers()
    for k in (k1, *_probe_wrappers()):
        k.reset_launch_count()
    rows = []
    t_all = time.perf_counter()
    for name in PROBES:
        mod = importlib.import_module(f"focalformer3d_tpu_torch.tools.{name}")
        before = _probe_launches()
        t0 = time.perf_counter()
        got = mod.run(device, "full")
        torch.cuda.synchronize()
        bad = [r["case"] for r in got if not r["ok"]]
        if bad:
            raise RuntimeError(f"probe {name}: checks failed: {bad}")
        mine = {k: n - before[k] for k, n in _probe_launches().items()}
        print(_probe_line(name, got, time.perf_counter() - t0, mine),
              flush=True)
        rows += got
        torch.cuda.empty_cache()
    launches = _probe_launches()
    if not all(launches.values()):
        raise RuntimeError(f"probes: a kernel was not launched: {launches}")
    print(f"probes: {len(rows)} cases in {time.perf_counter() - t_all:.1f} "
          f"s; launches {launches}", flush=True)
    for r in rows:
        if r["kernel"] == "micro_widen":
            print(f"P9 {r['case']}: micro_widen {r['ms']:.4f} ms [route "
                  f"{r['route']}, tile {r['tile_rows']} rows], strided view "
                  f"copy {r['library_ms']:.4f} ms, ratio "
                  f"{r['ms'] / r['library_ms']:.3f}, "
                  f"{r['bound_ms'] / r['ms']:.3f} of its byte bound "
                  f"({r['bound_ms']:.4f} ms)", flush=True)
    out = {}
    for name in launches:
        mine = [r for r in rows if r["kernel"] == name]
        head = [r for r in mine if r["headline"]]
        if len(head) != 1:
            raise RuntimeError(f"probes: {len(head)} headline cases of {name}")
        h = head[0]
        out[name] = {
            "case": f"{h['probe']} {h['case']}",
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": h["ms"], "plain_ms": h["plain_ms"], "library_ms": h["library_ms"],
            "library": h["op"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"]}
    out["micro_gather_taps"]["w512"] = [
        {"case": r["case"], "ms": r["ms"], "route": r["route"]}
        for r in rows if r["kernel"] == "micro_gather_taps"
        and r["case"].startswith("W=512")]
    sweep = [r for r in rows
             if r["kernel"] == "micro_gather_rows" and r["op"] == "x[idx]"]
    worst = max(sweep, key=lambda r: r["ms"] / r["library_ms"])
    out["micro_gather_rows"]["worst_vs_x_idx"] = {
        "case": worst["case"], "ms": worst["ms"],
        "x_idx_ms": worst["library_ms"],
        "ratio": worst["ms"] / worst["library_ms"]}
    return out, launches


def _voxel_abs_sums(vcfg, points, mask):
    """float64 sum of |x| over each kept voxel's points, (max_voxels, D)
    in CSR order: the scale of a voxel mean's float32 rounding."""
    from focalformer3d_tpu_torch.ops.voxelize import (INT32_MAX,
                                                      _linear_key,
                                                      point_voxel_coords)

    coords, valid = point_voxel_coords(vcfg, points, mask)
    key = _linear_key(coords, valid, vcfg.grid_size)
    uniq, inv = torch.unique(key, return_inverse=True)
    sums = torch.zeros((len(uniq), points.shape[1]), dtype=torch.float64)
    sums.index_add_(0, inv, points.abs().double())
    sums = sums[uniq != INT32_MAX][:vcfg.max_voxels]
    out = torch.zeros((vcfg.max_voxels, points.shape[1]), dtype=torch.float64)
    out[:len(sums)] = sums
    return out


def _check_dynamic_voxelize(cfg, scan, card):
    """``dynamic_voxelize`` at the eval cap on the card against the same
    function on the CPU: coords and mask bit for bit, features within
    2 * 2**-23 * sum|x| of each voxel (atomic adds sum in any order)."""
    from focalformer3d_tpu_torch.ops.voxelize import dynamic_voxelize

    vcfg = dataclasses.replace(cfg.voxel, max_voxels=(
        cfg.voxel.max_voxels_test or cfg.voxel.max_voxels))
    pts, mask = scan[0][0], scan[1][0]  # the scan's one sample
    got = dynamic_voxelize(vcfg, pts, mask)
    ref = dynamic_voxelize(vcfg, pts.cpu(), mask.cpu())
    for k in ("coords", "voxel_mask"):
        if not torch.equal(got[k].cpu(), ref[k]):
            raise RuntimeError(f"dynamic_voxelize: {k} differs on the card")
    bound = 2 * 2.0 ** -23 * _voxel_abs_sums(vcfg, pts.cpu(), mask.cpu())
    err = (got["features"].cpu().double() - ref["features"].double()).abs()
    if not bool((err <= bound).all()):
        raise RuntimeError(f"dynamic_voxelize: features differ by "
                           f"{float(err.max()):.3g} beyond the bound")
    ms = _median_ms(lambda: dynamic_voxelize(vcfg, pts, mask))
    print(f"dynamic_voxelize ({card}): {int(ref['voxel_mask'].sum())} voxels "
          f"of {vcfg.max_voxels} from {int(mask.sum())} points; coords and "
          f"mask bit for bit against the CPU, features max |diff| "
          f"{float(err.max()):.3g} (within 2 * 2**-23 * sum|x| per voxel); "
          f"{ms:.3f} ms (events, median of {REPS})", flush=True)


def phase_variants(card, device, scans):
    """DeformFormer3D_L (bf16, random weights from seed 0) on the three
    engines and DeformFormer3D_L_dynamic on ``cuda``, three scans each,
    ``dynamic_voxelize`` on the card against the CPU, then one float32
    training step of DeformFormer3D_L at batch 2 on ``cuda``. Returns the
    model-path kernels' launches, each run's counted from zero just before
    it and read just after it, summed."""
    from focalformer3d_tpu_torch.configs import get_config, with_compute_dtype
    from focalformer3d_tpu_torch.training import optim, train_step

    t_phase = time.perf_counter()
    total = dict.fromkeys(MODEL_KERNELS, 0)

    def add(launches):
        for name, n in zip(("sparse_conv", "plan_rules", "sparse_conv_zrun"),
                           launches):
            total[name] += n

    all_cfg = get_config("DeformFormer3D_L")
    cfg = with_compute_dtype(dataclasses.replace(
        all_cfg["model"], sparse_engine="cuda"), "bfloat16")
    model = _model(cfg, device)
    for engine in ENGINES:
        add(phase_slice(cfg, model, engine, scans, "DeformFormer3D_L",
                        kept_exact=False))
    del model
    dyn = with_compute_dtype(dataclasses.replace(
        get_config("DeformFormer3D_L_dynamic")["model"], sparse_engine="cuda"),
        "bfloat16")
    model = _model(dyn, device)
    add(phase_slice(dyn, model, "cuda", scans, "DeformFormer3D_L_dynamic",
                    kept_exact=False))
    del model
    _check_dynamic_voxelize(dyn, scans[0], card)
    torch.cuda.empty_cache()

    # one training step: FocalFormer3D_L's encoder, so its launches
    k1, _, _ = _wrappers()
    tcfg = dataclasses.replace(all_cfg["model"], sparse_engine="cuda")
    batch = _train_batch(tcfg, device)
    model = _model(tcfg, device).train()
    tx = optim.make_optimizer(total_steps=100)
    opt_state = tx.init(list(model.parameters()))
    step = train_step.make_train_step(tcfg, all_cfg["loss"], tx)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    torch.cuda.synchronize()
    k1.reset_launch_count()
    t0 = time.perf_counter()
    metrics = step(model, opt_state, batch, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    vals = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in vals.values()):
        raise RuntimeError(f"DeformFormer3D_L train step: {vals}")
    launches = {kind: k1.launch_count(kind)
                for kind in TRAIN_LAUNCHES_PER_STEP}
    if launches != TRAIN_LAUNCHES_PER_STEP:
        raise RuntimeError(f"DeformFormer3D_L train step: K1 forward/dx/dW "
                           f"{launches}, expected {TRAIN_LAUNCHES_PER_STEP}")
    for kind, name in (("forward", "sparse_conv"), ("dx", "sparse_conv_dx"),
                       ("wgrad", "sparse_conv_wgrad")):
        total[name] += launches[kind]
    print(f"variants train step ({card}; DeformFormer3D_L float32, batch "
          f"{TRAIN_BATCH}, cuda, a fresh model's first step): {ms:.1f} ms; "
          f"loss {vals['loss']:.5g}, all {len(vals)} metrics finite; K1 "
          f"forward/dx/dW {launches}", flush=True)
    del model, batch, opt_state
    torch.cuda.empty_cache()
    print(f"variants ({card}): {time.perf_counter() - t_phase:.1f} s; "
          f"launches {total}", flush=True)
    return total


def _decided(cands, cfg, margin=MERGE_MARGIN):
    """True where no two valid class-offset candidates have a BEV IoU
    within ``margin`` of the NMS or the vote threshold (on the CPU): there
    two correct IoUs may decide differently."""
    from focalformer3d_tpu_torch.core.iou import boxes_iou_bev

    b, _, lab, v = (torch.from_numpy(x) for x in cands)
    b = b[v].clone()
    b[:, 0] += lab[v].to(b.dtype) * (2.0 * 200.0)
    iou = boxes_iou_bev(b, b)
    return not any(bool(((iou - t).abs() <= margin).any())
                   for t in (cfg.nms_thresh, cfg.vote_iou))


def _check_merge(card, device, cache, n_cands):
    """One sample's merge of ``n_cands`` candidates (a cached sample padded
    to the test CLI's 4 x 600) on the card against the CPU: masks, labels
    and scores equal, boxes within MERGE_TOL of each value's magnitude (at
    least 1), on the first sample whose comparisons are all decided. Then
    the merge's split on the card."""
    from focalformer3d_tpu_torch.core import merge_augs as ma
    from focalformer3d_tpu_torch.core.iou import (boxes_intersection_bev,
                                                  boxes_iou_bev)
    from focalformer3d_tpu_torch.core.nms import nms_from_iou

    cfg = ma.TTAConfig(num_classes=10)
    for i in range(DATASET_SAMPLES):
        cands = ma.load_ensemble([cache], f"sample_{i:04d}", pad_to=n_cands)
        if _decided(cands, cfg):
            break
    else:
        raise RuntimeError("tta merge: every sample has a pair within "
                           f"{MERGE_MARGIN} of a threshold")
    cpu = [torch.from_numpy(x)[None] for x in cands]
    ref = ma.merge_aug_boxes(cfg, *cpu)
    got = {k: v.cpu() for k, v in ma.merge_aug_boxes(
        cfg, *(x.to(device) for x in cpu)).items()}
    for k in ("mask", "labels", "scores"):
        if not torch.equal(got[k], ref[k]):
            raise RuntimeError(f"tta merge: {k} differs on the card")
    err = float(((got["bboxes"] - ref["bboxes"]).abs()
                 / ref["bboxes"].abs().clamp(min=1)).max())
    if err > MERGE_TOL:
        raise RuntimeError(f"tta merge: boxes differ by {err:.3g}")

    b, s, lab, v = (x[0].to(device) for x in cpu)
    b_off = b.clone()
    b_off[:, 0] += lab.to(b.dtype) * (2.0 * 200.0)
    iou = boxes_iou_bev(b_off, b_off)
    iou_ms = _median_ms(lambda: boxes_iou_bev(b_off, b_off))
    # the same intersections with every pair clipped, not only the near ones
    every_ms = _median_ms(lambda: boxes_intersection_bev(b_off, b_off))
    near = int((iou > 0).sum())

    def host_ms(fn):
        times = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    nms_ms = host_ms(lambda: nms_from_iou(iou, s, v, cfg.nms_thresh))
    merge_ms = host_ms(lambda: ma.merge_aug_boxes(
        cfg, *(x.to(device) for x in cpu))["mask"].cpu())
    print(f"tta merge ({card}): sample_{i:04d} ({i} undecided before it), "
          f"{int(v.sum())} valid of {n_cands} candidates: mask, labels and "
          f"scores equal to the CPU's, boxes within {err:.3g} (tol "
          f"{MERGE_TOL}); kept {int(ref['mask'].sum())}; on the card the "
          f"IoU matrix {iou_ms:.2f} ms (events; {near} pairs overlap; every "
          f"pair clipped {every_ms:.2f} ms), the greedy NMS pass "
          f"{nms_ms:.2f} ms (host: one copy of the bool matrix, numpy), the "
          f"whole merge {merge_ms:.2f} ms (host), medians of {REPS}",
          flush=True)


def phase_tta(card, device, root, checkpoint, tmp):
    """The test CLI with ``--tta`` over phase 10's samples and checkpoint,
    on ``cuda`` (caching to A) and ``cuda_mxu`` (to B), then
    ``--tta-ensemble A B``; one sample's merge on the card against the
    CPU. Returns the model-path kernels' launches, each run's counted from
    zero just before it and read just after it, summed."""
    from focalformer3d_tpu_torch.configs import get_config
    from focalformer3d_tpu_torch.tools import test as test_cli

    t_phase = time.perf_counter()
    cfg_all = get_config("FocalFormer3D_L")
    total = dict.fromkeys(MODEL_KERNELS, 0)
    caches = {"cuda": f"{tmp}/tta_A", "cuda_mxu": f"{tmp}/tta_B"}
    base = ["FocalFormer3D_L", "--data-root", root, "--limit",
            str(DATASET_SAMPLES)]
    keys = {"mAP", "mATE", "mASE", "mAOE", "mAVE", "nds_no_attr"}
    keys |= {f"AP_{c}" for c in cfg_all["class_names"]}
    runs = [(f"--tta {e}", TTA_TEST_LAUNCHES[e],
             ["--checkpoint", checkpoint, "--engine", e, "--tta",
              "--tta-cache-dir", c]) for e, c in caches.items()]
    runs.append(("--tta-ensemble", {}, ["--tta-ensemble", *caches.values()]))
    for label, want, extra in runs:
        for k in _wrappers():
            k.reset_launch_count()
        out = f"{tmp}/sub_{label.strip('-').replace(' ', '_')}.json"
        res, rec = _run_cli(test_cli.main, [*base, *extra, "--out", out])
        got = _model_path_launches()
        full = {k: want.get(k, 0) for k in got}
        if got != full:
            raise RuntimeError(f"test CLI {label}: launches {got}, expected "
                               f"{full}")
        for k, n in got.items():
            total[k] += n
        if rec is None or set(rec) != keys:
            raise RuntimeError(f"test CLI {label}: metrics {rec}")
        n_boxes = _check_submission(out, DATASET_SAMPLES, label)
        print(f"tta test CLI {label} ({card}): "
              f"{res.samples / res.seconds:.3f} samples/s ({res.samples} "
              f"samples in {res.seconds:.2f} s, the first in "
              f"{res.seconds_first:.2f} s; {res.passes} passes a sample); "
              f"the merge {res.seconds_merge / res.samples * 1e3:.1f} ms a "
              f"sample; {n_boxes} boxes in the submission, all finite; mAP "
              f"{rec['mAP']}; launches {got}", flush=True)
        torch.cuda.empty_cache()
    num_prop = cfg_all["model"].decoder.total_stages * \
        cfg_all["model"].decoder.num_proposals
    _check_merge(card, device, caches["cuda"], TTA_PASSES * num_prop)
    print(f"tta ({card}): {time.perf_counter() - t_phase:.1f} s; launches "
          f"{total}", flush=True)
    return total


# phase 13: the camera path, FocalFormer3D_LC and DeformFormer3D_C_R50 on
# phase 4's scans with six rendered 448 x 800 cameras each
LSS_TOL = 1e-4  # the card's LSS BEV against the CPU's, of its scale
CAMERA_TRAIN_STEPS = 2
CAMERA_CLI_STEPS = 2
FROZEN_LC = ("img_backbone.", "img_neck.", "imgpts_neck.cam_lss.",
             "pts_middle_encoder.", "pts_backbone.", "pts_neck.",
             "imgpts_neck.shared_conv_pts.")


def _camera_scans(cfg, device, seeds=SCAN_SEEDS, batch_size=1):
    """Phase 4's radial scans (the same draws) with the synthetic camera rig
    of each, its six images rendered from the scan: one dict per seed."""
    from focalformer3d_tpu_torch.data import synthetic

    out = []
    for seed in seeds:
        b = synthetic.make_batch(
            np.random.RandomState(seed), batch_size=batch_size,
            n_points=N_POINTS, n_boxes=24, max_gts=32,
            num_classes=cfg.decoder.num_classes,
            pc_range=cfg.voxel.point_cloud_range, mode="radial",
            with_images=True, img_hw=cfg.lss.img_scale)
        out.append({k: torch.from_numpy(v).to(device) for k, v in b.items()})
    return out


def _camera_inputs(cfg, scan):
    from focalformer3d_tpu_torch.models.detector import preprocess_points

    vox = (preprocess_points(cfg, scan["points"], scan["points_mask"])
           if cfg.input_pts else None)
    return vox, {k: scan[k] for k in ("imgs", "lidar2img", "img_aug",
                                       "bev_aug")}


def _camera_slice(cfg, model, engine, scans, name, kept_exact):
    """The samples on one engine: ms a sample (host clock around a
    synchronise), the median stage split by CUDA events, peak memory;
    finite boxes, 200 kept (1-200 without ``kept_exact``). Returns the
    (K1, K2, K3) launches, counted from zero just before the first sample
    and read just after the last, and the outputs of the first."""
    from focalformer3d_tpu_torch.tools.benchmark import stages_of
    from focalformer3d_tpu_torch.utils.profiler import StageClock

    stages = stages_of(cfg)
    if cfg.input_pts:
        model.pts_middle_encoder.engine = engine
    kernels = _wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.reset_launch_count()
    wall, splits, first = [], [], None
    for scan in scans:
        clock = StageClock(scan["points"].device, stages)
        t0 = time.perf_counter()
        clock.start()
        vox, img = _camera_inputs(cfg, scan)
        clock.mark("voxelize")
        out = model(vox, mark=clock.mark, img_data=img)
        dec = model.get_bboxes(out, 200)
        clock.mark("get_bboxes")
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        splits.append(clock.split())
        first = first or out
        for k in ("bboxes", "scores"):
            if not torch.isfinite(dec[k]).all():
                raise RuntimeError(f"{name} {engine}: non-finite {k}")
        kept = int(dec["mask"].sum())
        if dec["bboxes"].shape[-1] != 9 or not (
                kept == 200 if kept_exact else 0 < kept <= 200):
            raise RuntimeError(f"{name} {engine}: {kept} kept boxes of "
                               f"{tuple(dec['bboxes'].shape)}")
    launches = tuple(k.launch_count() for k in kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    split = {st: statistics.median(x[st] for x in splits)
             for st in stages}
    print(f"camera {name} {engine}: ms/sample " + ", ".join(
        f"{t:.1f}" for t in wall) + f" (median {statistics.median(wall):.1f}"
        "); stage split (CUDA events, median, ms): " + ", ".join(
        f"{st} {t:.2f}" for st, t in split.items() if t)
        + f"; peak memory {peak:.2f} GiB; (K1, K2, K3) launches {launches}",
        flush=True)
    return launches, first


def _check_lss_on_cpu(model, scan, card):
    """Sample 0's LSS on the card (float32, ``index_add_`` in atomic order)
    against the same module on the CPU, from the card's FPN level 0: the
    splat's pooled BEV and the encoded BEV within ``LSS_TOL`` of scale."""
    import copy

    from focalformer3d_tpu_torch.models import lss as tlss

    vox, img = _camera_inputs(model.cfg, scan)
    neck_img = model.image_features(img)
    lss = model.imgpts_neck.cam_lss
    cpu = copy.deepcopy(lss).cpu()
    args = [neck_img[k] for k in ("img_feats", "cam2lidar_rot",
                                  "cam2lidar_trans", "img_aug", "bev_aug")]
    rows = {}
    for tag, mod, a in (("card", lss, args),
                        ("cpu", cpu, [x.cpu() for x in args])):
        lifted, _ = mod.camencode(a[0].float().flatten(0, 1))
        geom = mod.geometry(*a[1:])
        rows[tag] = (tlss.splat_to_bev(mod.cfg, geom[0], lifted),
                     mod(*a)[0][0], tlss.splat_ranks(mod.cfg, geom[0]))
    errs = []
    for i, what in enumerate(("splat", "BEV")):
        got, ref = rows["card"][i].cpu(), rows["cpu"][i]
        err = float((got - ref).abs().max() / ref.abs().max())
        if not err <= LSS_TOL:
            raise RuntimeError(f"LSS {what} card vs CPU rel {err:.3g}")
        errs.append(f"{what} {tuple(got.shape)} rel {err:.3g}")
    ranks = rows["card"][2].cpu()
    nx, ny, nz = lss.cfg.nx
    flips = int((ranks != rows["cpu"][2]).sum())
    print(f"camera LSS sample 0 ({card}): card vs float32 CPU "
          + ", ".join(errs) + f" (limit {LSS_TOL}); {ranks.numel()} frustum "
          f"points, {int((ranks < nx * ny * nz).sum())} in the grid, "
          f"{flips} in another cell on the card (an ulp of geometry)",
          flush=True)


def _camera_train_step(card, device, name="FocalFormer3D_LC", must_move=(),
                       profile=True):
    """``CAMERA_TRAIN_STEPS`` float32 steps of the camera config ``name``
    at batch 2 on ``cuda`` with its freeze flags, then (with ``profile``)
    one more under the profiler: K1 forward only, the frozen branches
    bit-identical, the fusion layers and head moved, and every parameter
    under a prefix of ``must_move``; each timed step's ms and split by CUDA
    events, peak memory, the profiled step's largest kernels. Returns the
    K1 forward launches."""
    from focalformer3d_tpu_torch.configs import get_config
    from focalformer3d_tpu_torch.training import optim, train_step
    from focalformer3d_tpu_torch.utils.profiler import StageClock

    k1, _, _ = _wrappers()
    all_cfg = get_config(name)
    cfg = dataclasses.replace(all_cfg["model"], sparse_engine="cuda")
    scans = _camera_scans(cfg, device, (TRAIN_SEED,), TRAIN_BATCH)
    model = _model(cfg, device).train()
    tx = optim.make_optimizer(total_steps=100)
    opt_state = tx.init(model.named_parameters())
    step = train_step.make_train_step(cfg, all_cfg["loss"], tx)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.reset_launch_count()
    rows = []
    for _ in range(CAMERA_TRAIN_STEPS):
        clock = StageClock(device, train_step.PHASES)
        t0 = time.perf_counter()
        clock.start()
        with torch.enable_grad():
            metrics = step(model, opt_state, scans[0], gen, clock.mark)
        torch.cuda.synchronize()
        rows.append(((time.perf_counter() - t0) * 1e3, clock.split()))
        vals = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"LC train step: {vals}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if profile:
        with torch.enable_grad():
            _profile_step(lambda: step(model, opt_state, scans[0], gen),
                          "camera train profile")
    launches = {k: k1.launch_count(k) for k in ("forward", "dx", "wgrad")}
    want = {"forward": (CAMERA_TRAIN_STEPS + profile)
            * LAUNCHES_PER_SCAN["cuda"][0], "dx": 0, "wgrad": 0}
    if launches != want:
        raise RuntimeError(f"{name} train step: K1 launches {launches}, "
                           f"expected {want}")
    after = model.state_dict()
    frozen = [k for k in after if k.startswith(FROZEN_LC)]
    changed = [k for k in frozen if not torch.equal(after[k], before[k])]
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    still = [k for k in trainable if k.startswith(tuple(must_move))
             and torch.equal(after[k], before[k])]
    moved = [k for k in trainable if not torch.equal(after[k], before[k])]
    if changed or still or len(moved) < len(trainable) // 2:
        raise RuntimeError(f"{name} train step: frozen tensors changed "
                           f"{changed[:5]}; {len(moved)} of "
                           f"{len(trainable)} trainable moved; unmoved "
                           f"{still[:5]}")
    print(f"camera train steps ({card}; {name} float32, batch "
          f"{TRAIN_BATCH}, cuda, its freeze flags, a fresh model): "
          + "; ".join(f"step {i + 1} {ms:.1f} ms, split (CUDA events, ms) "
                      + ", ".join(f"{p} {t:.1f}" for p, t in split.items())
                      for i, (ms, split) in enumerate(rows))
          + f"; peak memory {peak:.2f} GiB; loss {vals['loss']:.5g}; "
          f"{len(frozen)} frozen tensors bit-identical, {len(moved)} of "
          f"{len(trainable)} trainable parameters moved; K1 forward/dx/dW "
          f"{launches}", flush=True)
    del model, opt_state, scans
    torch.cuda.empty_cache()
    return launches["forward"]


def _camera_train_cli(card):
    """The train CLI: DeformFormer3D_C_R50 one step (its checkpoint holds
    an image branch), then FocalFormer3D_LC ``CAMERA_CLI_STEPS`` steps with
    ``--load-img-from`` it: the loaded image branch bit for bit, finite
    losses, K1 forward launches as many as eval scans on ``cuda``. Returns
    the K1 forward launches."""
    from focalformer3d_tpu_torch.tools import train as train_cli
    from focalformer3d_tpu_torch.training import checkpoint as ckpt

    k1, _, _ = _wrappers()
    img_branch = ("img_backbone.", "img_neck.", "imgpts_neck.cam_lss.")
    with tempfile.TemporaryDirectory() as work:
        common = ["--synthetic", "--epochs", "1", "--log-interval", "1",
                  "--no-tensorboard"]
        k1.reset_launch_count()
        _run_cli(train_cli.main, ["DeformFormer3D_C_R50", "--batch-size",
                                  "1", "--iters-per-epoch", "1",
                                  "--work-dir", f"{work}/c"] + common)
        if k1.launch_count("forward"):
            raise RuntimeError("DeformFormer3D_C_R50 launched K1")
        run, _ = _run_cli(train_cli.main, [
            "FocalFormer3D_LC", "--batch-size", str(TRAIN_BATCH),
            "--iters-per-epoch", str(CAMERA_CLI_STEPS), "--work-dir",
            f"{work}/lc", "--load-img-from", f"{work}/c/epoch_1"] + common)
        launches = k1.launch_count("forward")
        with open(f"{work}/lc/train_log.jsonl") as fh:
            losses = [json.loads(x)["loss"] for x in fh
                      if json.loads(x)["mode"] == "train"]
        src = ckpt.load_payload(f"{work}/c/epoch_1")["state_dict"]
    got = run.model.state_dict()
    img = [n for n, _ in run.model.named_parameters()
           if n.startswith(img_branch)]
    diff = [k for k in img if not torch.equal(got[k].cpu(), src[k])]
    want = CAMERA_CLI_STEPS * LAUNCHES_PER_SCAN["cuda"][0]
    if (diff or len(losses) != CAMERA_CLI_STEPS or launches != want
            or not all(math.isfinite(x) for x in losses)):
        raise RuntimeError(f"camera train CLI: image branch differs at "
                           f"{diff[:3]}; losses {losses}; K1 {launches}, "
                           f"expected {want}")
    print(f"camera train CLI ({card}): DeformFormer3D_C_R50 1 step, then "
          f"FocalFormer3D_LC {CAMERA_CLI_STEPS} steps at batch {TRAIN_BATCH} "
          f"with --load-img-from it: {len(img)} image-branch parameters as "
          "loaded, bit for bit; losses " + ", ".join(
              f"{x:.4f}" for x in losses) + f"; K1 forward {launches}",
          flush=True)
    del run
    torch.cuda.empty_cache()
    return launches


def phase_camera(card, device):
    """FocalFormer3D_LC (bf16, random weights from seed 0) on phase 4's
    scans with their cameras on each engine, its LSS against the CPU,
    DeformFormer3D_C_R50 on the same samples, two frozen LC train steps and
    the train CLI. Returns the model-path kernels' launches, each run's
    counted from zero just before it and read just after it, summed."""
    from focalformer3d_tpu_torch.configs import get_config, with_compute_dtype

    t_phase = time.perf_counter()
    total = dict.fromkeys(MODEL_KERNELS, 0)

    def add(launches):
        for name, n in zip(("sparse_conv", "plan_rules", "sparse_conv_zrun"),
                           launches):
            total[name] += n

    cfg = with_compute_dtype(dataclasses.replace(
        get_config("FocalFormer3D_LC")["model"], sparse_engine="cuda"),
        "bfloat16")
    scans = _camera_scans(cfg, device)
    model = _model(cfg, device)
    for engine in ENGINES:
        launches, _ = _camera_slice(cfg, model, engine, scans,
                                    "FocalFormer3D_LC", True)
        want = tuple(n * len(scans) for n in LAUNCHES_PER_SCAN[engine])
        if launches != want:
            raise RuntimeError(f"FocalFormer3D_LC {engine}: (K1, K2, K3) "
                               f"{launches}, expected {want} (phase 4's)")
        add(launches)
    _check_lss_on_cpu(model, scans[0], card)
    del model
    torch.cuda.empty_cache()

    ccfg = with_compute_dtype(get_config("DeformFormer3D_C_R50")["model"],
                              "bfloat16")
    model = _model(ccfg, device)
    launches, out = _camera_slice(ccfg, model, "none", scans,
                                  "DeformFormer3D_C_R50", False)
    if any(launches):
        raise RuntimeError(f"DeformFormer3D_C_R50 launched {launches}")
    dark = dict(scans[0], imgs=torch.zeros_like(scans[0]["imgs"]))
    with torch.no_grad():
        out0 = model(None, img_data=_camera_inputs(ccfg, dark)[1])
    delta = float((out0["dense_heatmap"] - out["dense_heatmap"]).abs().max())
    if not delta > 0:
        raise RuntimeError("DeformFormer3D_C_R50: outputs do not depend on "
                           "the images")
    print(f"camera DeformFormer3D_C_R50: zeroed images move the dense "
          f"heatmap by up to {delta:.4g}; no kernel launched", flush=True)
    del model, scans, out, out0
    torch.cuda.empty_cache()

    total["sparse_conv"] += _camera_train_step(card, device)
    total["sparse_conv"] += _camera_train_cli(card)
    print(f"camera ({card}): {time.perf_counter() - t_phase:.1f} s; "
          f"launches {total}", flush=True)
    return total


# phase 14: training on the three kernel engines, from the same weights
# K1 forward / dx / dW, K2 and K3 launches of one FocalFormer3D_L step
# (batch 2) per engine, as ``train_step.kernel_launches`` counts them
TRAIN_ENGINE_LAUNCHES = {
    "cuda": {"forward": 16, "dx": 15, "wgrad": 16, "plan": 0, "zrun": 0},
    "cuda_mxu": {"forward": 21, "dx": 20, "wgrad": 21, "plan": 8, "zrun": 0},
    "cuda_zrun": {"forward": 0, "dx": 15, "wgrad": 16, "plan": 0, "zrun": 16},
}


def _train_conv_checks(cfg, batch, device, engine):
    """Every conv of one training batch on ``engine`` (``cuda_mxu``: the
    meta chain, every level and conv_out; ``cuda_zrun``: the z-run codes up
    to the training dense boundary): the engine's differentiable conv
    (``sparse_conv_train`` on K2's rulebooks and their transposes, or
    ``zrun_conv_train``) on random features, weights and cotangent against
    autograd through ``apply_conv_bf16_plain`` on the rulebook it reads:
    forward, dx and dW within ``KERNEL_TOL`` of scale. On ``cuda_mxu`` each
    kernel alone is timed too (CUDA-graph replay), dW with its chunk.
    Returns the largest relative error of each."""
    from focalformer3d_tpu_torch.models.detector import preprocess_points
    from focalformer3d_tpu_torch.models.sparse_encoder import (
        backward_index, conv_index)
    from focalformer3d_tpu_torch.tools import _common

    k1, _, k3 = _wrappers()
    vox = preprocess_points(cfg, batch["points"], batch["points_mask"],
                            train=True)
    B = vox["coords"].shape[0]
    mxu = engine == "cuda_mxu"
    n = len(cfg.encoder_channels) if mxu else cfg.sparse_dense_from
    geoms = _walk(cfg, vox, mxu, n, batch=B)
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    worst = dict.fromkeys(("forward", "dx", "wgrad"), 0.0)
    for name, g, c, cout, _n in _convs(cfg, geoms):
        _, src, dst, ks, st, pad = geoms[g]
        index = conv_index(src, dst, ks, st, pad, engine)
        rules, rules_t = backward_index(index, src.capacity, engine,
                                        st != 1)
        K = rules.shape[1]
        x = torch.where(src.valid[..., None], torch.randn(
            B, src.capacity, c, device=device, generator=gen), 0.0)
        w = (torch.randn(K, c, cout, device=device, generator=gen)
             * (2.0 / (K * c)) ** 0.5)
        cot = torch.where(dst.valid[..., None], torch.randn(
            B, dst.capacity, cout, device=device, generator=gen), 0.0)
        need_dx = name != "conv_input"
        res = {}
        for tag in ("kernel", "plain"):
            xx = x.clone().requires_grad_(need_dx)
            ww = w.clone().requires_grad_(True)
            with torch.enable_grad():
                if tag == "plain":
                    y = k1.apply_conv_bf16_plain(xx, rules, ww, dst.valid)
                elif mxu:
                    y = k1.sparse_conv_train(xx, rules, rules_t, ww,
                                             dst.valid)
                else:
                    y = k3.zrun_conv_train(xx, index, rules, rules_t, ww,
                                           dst.valid)
                y.backward(cot)
            res[tag] = {"forward": y.detach(), "dx": xx.grad,
                        "wgrad": ww.grad}
        torch.cuda.synchronize()
        rels = []
        for kind in ("forward", "dx", "wgrad"):
            if kind == "dx" and not need_dx:
                continue
            got, ref = res["kernel"][kind], res["plain"][kind]
            rel = float((got - ref).abs().max() / ref.abs().max())
            if not rel <= KERNEL_TOL:
                raise RuntimeError(f"{engine} train {name} {kind}: rel err "
                                   f"{rel:.3g} > {KERNEL_TOL}")
            worst[kind] = max(worst[kind], rel)
            rels.append(f"{kind} {rel:.3g}")
        note = ""
        if mxu:  # each kernel alone, at the widths training gives it
            xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
            t = {"forward": _common.time_ms(device, lambda: k1.sparse_conv(
                xb, rules, wb, dst.valid))[0],
                 "wgrad": _common.time_ms(device, lambda: k1.conv_wgrad(
                     xb, cot, rules))[0]}
            if need_dx:
                t["dx"] = _common.time_ms(device, lambda: k1.conv_dx(
                    cot, rules_t, wb))[0]
            chunk = k1.wgrad_chunk(*(next(n for n in k1.COUTS if n >= w)
                                     for w in (c, cout)))
            note = ("; kernel ms " + ", ".join(f"{k} {v:.4f}"
                                               for k, v in t.items())
                    + f" (dW chunk {chunk} hits)")
        print(f"train {engine} {name}: C {c} -> {cout}, K {K}, V_in "
              f"{src.capacity} -> V_out {dst.capacity} (B {B}, "
              f"{int(dst.valid.sum())} active); kernel vs plain rel "
              + ", ".join(rels) + note, flush=True)
    return worst


def phase_train_engines(card, cfg, batch, device):
    """FocalFormer3D_L (float32, batch 2, two radial scans) on each kernel
    engine from the same weights: first each engine's convs against their
    plain versions, then one warm step on ``cuda`` and one step on each of
    ``ENGINES`` in turns, each from the warm step's weights and optimizer
    state: finite losses, the launches of ``TRAIN_ENGINE_LAUNCHES``
    exactly (counted from zero just before the step, read just after), ms
    and split by CUDA events, peak memory. Returns each engine's
    launches."""
    import copy

    from focalformer3d_tpu_torch.configs import get_config
    from focalformer3d_tpu_torch.training import optim, train_step
    from focalformer3d_tpu_torch.utils.profiler import StageClock

    t_phase = time.perf_counter()
    for engine in ("cuda_mxu", "cuda_zrun"):
        worst = _train_conv_checks(cfg, batch, device, engine)
        print(f"train {engine}: every conv within {KERNEL_TOL} of its plain "
              "version (worst rel " + ", ".join(
                  f"{k} {v:.3g}" for k, v in worst.items()) + ")",
              flush=True)
    torch.cuda.empty_cache()
    model = _model(cfg, device).train()
    tx = optim.make_optimizer(total_steps=100)
    opt_state = tx.init(model.named_parameters())
    step = train_step.make_train_step(
        cfg, get_config("FocalFormer3D_L")["loss"], tx)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    model.pts_middle_encoder.engine = "cuda"
    step(model, opt_state, batch, gen)  # warm
    weights = copy.deepcopy(model.state_dict())
    opt0 = copy.deepcopy(opt_state)
    out, rows = {}, []
    for engine in ENGINES:
        model.load_state_dict(weights)
        state = copy.deepcopy(opt0)
        model.pts_middle_encoder.engine = engine
        gen.manual_seed(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        clock = StageClock(device, train_step.PHASES)
        train_step.reset_kernel_launches()
        t0 = time.perf_counter()
        clock.start()
        metrics = step(model, state, batch, gen, clock.mark)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = train_step.kernel_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        vals = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in vals.items() if not math.isfinite(v)]
        if bad:
            raise RuntimeError(f"train {engine}: non-finite {bad}")
        if launches != TRAIN_ENGINE_LAUNCHES[engine]:
            raise RuntimeError(f"train {engine}: launches {launches}, "
                               f"expected {TRAIN_ENGINE_LAUNCHES[engine]}")
        out[engine] = launches
        rows.append(f"{engine} {ms:.1f} ms (" + ", ".join(
            f"{p} {t:.1f}" for p, t in clock.split().items())
            + f"), peak {peak:.2f} GiB, loss {vals['loss']:.5g}, "
            f"launches {launches}")
    model.pts_middle_encoder.engine = cfg.sparse_engine
    print(f"train engines ({card}; FocalFormer3D_L float32, batch "
          f"{TRAIN_BATCH}, one step each from the same weights after a warm "
          "step on cuda; split by CUDA events, ms): " + "; ".join(rows),
          flush=True)
    print(f"train engines: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    del model, opt_state, opt0, weights
    torch.cuda.empty_cache()
    return out


# phase 15: FocalFormer3D_LC_Proj on phase 4's scans with their cameras
I2P_TOL = 1e-4  # the card's I2P output against the CPU's, of its scale
PROJ_TRAINED = ("imgpts_neck.shared_conv_img.",
                "imgpts_neck.fusion_blocks.0.I2P_block.")


def _check_i2p_on_cpu(model, scan, card):
    """Sample 0's I2P block on the card against the same module on the CPU
    in float32, on the inputs the card's forward gave it: within
    ``I2P_TOL`` of scale; the line counts the (camera, point) validity
    flags that differ (a point an ulp from an image border or z = eps)."""
    import copy

    from focalformer3d_tpu_torch.models import i2p as ti2p

    block = model.imgpts_neck.fusion_blocks[0].I2P_block
    seen = {}
    hook = block.register_forward_hook(
        lambda mod, args, out: seen.update(args=args, out=out))
    vox, img = _camera_inputs(model.cfg, scan)
    with torch.no_grad():
        model(vox, img_data=img)
    hook.remove()
    cpu = copy.deepcopy(block).cpu().float()
    args = [a.cpu() if torch.is_tensor(a) else a for a in seen["args"]]
    with torch.no_grad():
        ref = cpu(*args)
    got = seen["out"].cpu()
    err = float((got - ref).abs().max() / ref.abs().max())
    lidar = args[0]
    B, H, W, _ = lidar.shape
    grid = ti2p.bev_grid((block.max_points_height, H, W), block.pc_range)
    flips, points = 0, 0
    for b in range(B):
        masks = [ti2p.project_points_to_cams(
            grid.to(dev), *(None if a is None else a[b].to(dev)
                            for a in args[2:5]), block.input_shape)[1].cpu()
            for dev in (torch.device("cpu"), seen["out"].device)]
        flips += int((masks[0] != masks[1]).sum())
        points += masks[0].numel()
    print(f"camera I2P sample 0 ({card}): card vs float32 CPU rel {err:.3g}"
          f" (limit {I2P_TOL}) on {tuple(got.shape)}; {points} (camera, "
          f"grid point) pairs, {flips} validity flags differ", flush=True)
    if not err <= I2P_TOL:
        raise RuntimeError(f"I2P card vs CPU rel {err:.3g} > {I2P_TOL}")


def phase_camera_proj(card, device):
    """FocalFormer3D_LC_Proj (bf16, random weights from seed 0) on phase
    4's scans with their cameras on each engine, its I2P against the CPU,
    and two frozen training steps at batch 2. Returns the model-path
    kernels' launches, each run's counted from zero just before it and read
    just after it, summed."""
    from focalformer3d_tpu_torch.configs import get_config, with_compute_dtype

    t_phase = time.perf_counter()
    total = dict.fromkeys(MODEL_KERNELS, 0)
    name = "FocalFormer3D_LC_Proj"
    cfg = with_compute_dtype(dataclasses.replace(
        get_config(name)["model"], sparse_engine="cuda"), "bfloat16")
    scans = _camera_scans(cfg, device)
    model = _model(cfg, device)
    for engine in ENGINES:
        launches, _ = _camera_slice(cfg, model, engine, scans, name, True)
        want = tuple(n * len(scans) for n in LAUNCHES_PER_SCAN[engine])
        if launches != want:
            raise RuntimeError(f"{name} {engine}: (K1, K2, K3) {launches}, "
                               f"expected {want} (phase 4's)")
        for row, n in zip(("sparse_conv", "plan_rules", "sparse_conv_zrun"),
                          launches):
            total[row] += n
    model.pts_middle_encoder.engine = "cuda"
    _check_i2p_on_cpu(model, scans[0], card)
    del model, scans
    torch.cuda.empty_cache()
    total["sparse_conv"] += _camera_train_step(card, device, name,
                                               PROJ_TRAINED, profile=False)
    print(f"camera proj ({card}): {time.perf_counter() - t_phase:.1f} s; "
          f"launches {total}", flush=True)
    return total


# phase 16: the camera dataset, FocalFormer3D_LC on a written nuScenes
# directory with six 900 x 1600 JPEG cameras a sample (phase 10's points)
CAMDATA_SEED = 21
CAMDATA_IMG_HW = (900, 1600)
CAMDATA_TRAIN_STEPS = 4  # 2 epochs of 2
CAMDATA_TTA_SAMPLES = 2
CAMDATA_TEST_ENGINE = "cuda_mxu"
CAMDATA_TTA_ENGINE = "cuda"
FIXTURE_DIR = "tests/torch_images"


def _check_image_fixtures(card):
    """The committed fixtures through the port's decoder and geometry: the
    SHA-256 of each result equals the digest Pillow gave
    (``tests/test_torch_image_io.py`` wrote them)."""
    import hashlib
    import pathlib

    from focalformer3d_tpu_torch.data import image_io

    root = pathlib.Path(__file__).resolve().parent / FIXTURE_DIR
    digests = json.loads((root / "digests.json").read_text())
    n = 0
    for name, rec in digests["files"].items():
        img = image_io.imread(root / name)
        got = {"decode": img}
        chain = rec.get("chain")
        if chain:
            out = got["resize"] = image_io.resize(img, chain["resize"])
            out = got["crop"] = image_io.crop(out, chain["crop"])
            out = got["flip"] = image_io.flip_lr(out)
            got["rotate"] = image_io.rotate(out, chain["rotate"])
            got["scale"] = image_io.resize(img, chain["scale"])
        for step, arr in got.items():
            if hashlib.sha256(arr.tobytes()).hexdigest() != rec[step]:
                raise RuntimeError(f"image fixture {name} {step}: the digest "
                                   f"differs from {digests['made_with']}'s")
            n += 1
    print(f"camera dataset ({card}): {len(digests['files'])} fixture JPEGs, "
          f"{n} digests (decode, resize, crop, flip, rotate, test-time "
          f"resize) equal {digests['made_with']}'s", flush=True)


def _camera_host_ms(cfg_all, root, mode):
    """Host ms per sample of ``get_sample`` with images under the train
    (``mode`` "train": ``ImageAug3D``) or test pipeline, over every sample,
    with its wall-clock split: the six decodes (side by side), the image
    transforms on them, the rest (points, the point stages, normalise,
    pad) as the difference; and ``collate`` at batch 2."""
    from focalformer3d_tpu_torch.data import image_io
    from focalformer3d_tpu_torch.data import nuscenes as nusc
    from focalformer3d_tpu_torch.data import pipelines as pl

    cfg, classes = cfg_all["model"], cfg_all["class_names"]
    hw = cfg.lss.img_scale
    pipe = (pl.train_pipeline(cfg.voxel.point_cloud_range, classes,
                              with_images=True, img_scale=hw)
            if mode == "train" else
            pl.test_pipeline(cfg.voxel.point_cloud_range, with_images=True,
                             img_scale=hw))
    ds = nusc.NuScenesDataset(f"{root}/nuscenes_infos_train.pkl",
                              classes=classes, pipeline=pipe,
                              with_images=True, test_mode=mode == "test")
    img_stage = pipe[-3]
    rng = np.random.RandomState(0)
    rows = {"get_sample": [], "decode": [], "resample": [], "rest": [],
            "collate": []}
    image_io.reset_call_count()
    for i in range(0, len(ds) - 1, 2):
        samples = []
        for j in (i, i + 1):
            paths = [ds.infos[j]["cams"][c]["data_path"]
                     for c in nusc.CAM_ORDER]
            t0 = time.perf_counter()
            imgs = image_io.parallel_map(image_io.imread, paths)
            t1 = time.perf_counter()
            img_stage({"imgs": [a.astype(np.float32) for a in imgs]},
                      np.random.RandomState(j))
            t2 = time.perf_counter()
            samples.append(ds.get_sample(j, rng))
            t3 = time.perf_counter()
            rows["decode"].append((t1 - t0) * 1e3)
            rows["resample"].append((t2 - t1) * 1e3)
            rows["get_sample"].append((t3 - t2) * 1e3)
            rows["rest"].append((t3 - t2 - (t2 - t0)) * 1e3)
        t0 = time.perf_counter()
        nusc.collate(samples, classes, max_points=300000,
                     max_gts=cfg.decoder.max_gts // 4)
        rows["collate"].append((time.perf_counter() - t0) * 1e3 / 2)
    return rows, image_io.stats()


def phase_camera_dataset(card, tmp):
    """FocalFormer3D_LC on a written nuScenes directory with cameras: the
    image fixtures' digests, ``get_sample``'s host time and split under
    both pipelines, the train CLI (2 x 2 frozen-branch steps), the test CLI
    over the samples and ``--tta`` on FocalFormer3D_LC_TTA. Returns the
    model-path kernels' launches, each run's counted from zero just before
    it and read just after it, summed."""
    from focalformer3d_tpu_torch.configs import get_config
    from focalformer3d_tpu_torch.data import image_io
    from focalformer3d_tpu_torch.tools import test as test_cli
    from focalformer3d_tpu_torch.tools import train as train_cli
    from focalformer3d_tpu_torch.training import checkpoint as ckpt

    t_phase = time.perf_counter()
    cfg_all = get_config("FocalFormer3D_LC")
    total = dict.fromkeys(MODEL_KERNELS, 0)
    root = f"{tmp}/nuscenes_cam"
    t0 = time.perf_counter()
    write_nuscenes(
        root, seed=CAMDATA_SEED, samples=DATASET_SAMPLES,
        points=DATASET_POINTS, sweeps=DATASET_SWEEPS,
        pc_range=cfg_all["model"].voxel.point_cloud_range,
        classes=cfg_all["class_names"], cameras=True,
        img_hw=CAMDATA_IMG_HW)
    n_jpeg = 6 * DATASET_SAMPLES
    print(f"camera dataset ({card}): wrote {DATASET_SAMPLES} samples of a "
          f"{DATASET_POINTS}-point key frame, {DATASET_SWEEPS} sweeps and "
          f"{n_jpeg} {CAMDATA_IMG_HW[1]} x {CAMDATA_IMG_HW[0]} JPEGs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _check_image_fixtures(card)

    loader = {}
    for mode in ("train", "test"):
        rows, st = _camera_host_ms(cfg_all, root, mode)
        med = {k: statistics.median(v) for k, v in rows.items()}
        per_decode = st["decode_s"] / max(st["decodes"], 1) * 1e3
        per_resample = st["resample_s"] / max(st["resamples"], 1) * 1e3
        loader[mode] = 2 * (med["get_sample"] + med["collate"])
        print(f"camera dataset host ms per sample ({card}; {mode} pipeline, "
              f"six cameras decoded and resampled side by side; median of "
              f"{len(rows['get_sample'])}): get_sample "
              f"{med['get_sample']:.1f} (" + ", ".join(
                  f"{x:.1f}" for x in rows["get_sample"]) + f"); its split: "
              f"decode {med['decode']:.1f}, resample {med['resample']:.1f}, "
              f"the rest {med['rest']:.1f}; collate {med['collate']:.1f}; "
              f"one decode {per_decode:.2f} ms, one resample "
              f"{per_resample:.2f} ms (thread time, {st['decodes']} and "
              f"{st['resamples']} calls)", flush=True)

    work = f"{tmp}/work_cam"
    for k in _wrappers():
        k.reset_launch_count()
    image_io.reset_call_count()
    run, _ = _run_cli(train_cli.main, [
        "FocalFormer3D_LC", "--data-root", root, "--epochs", "2",
        "--iters-per-epoch", str(CAMDATA_TRAIN_STEPS // 2), "--batch-size",
        str(TRAIN_BATCH), "--log-interval", "1", "--work-dir", work,
        "--no-tensorboard"])
    with open(f"{work}/train_log.jsonl") as fh:
        recs = [r for r in map(json.loads, fh) if r["mode"] == "train"]
    losses = [r["loss"] for r in recs]
    if (len(losses) != CAMDATA_TRAIN_STEPS
            or not all(math.isfinite(x) for x in losses)):
        raise RuntimeError(f"camera dataset train CLI: losses {losses}")
    if 2 not in ckpt.list_epochs(work):
        raise RuntimeError(f"camera dataset train CLI: epochs "
                           f"{ckpt.list_epochs(work)} saved")
    got = _model_path_launches()
    want = {k: 0 for k in got}
    want["sparse_conv"] = CAMDATA_TRAIN_STEPS * LAUNCHES_PER_SCAN["cuda"][0]
    if got != want:
        raise RuntimeError(f"camera dataset train CLI: launches {got}, "
                           f"expected {want} (the frozen point branch: "
                           "K1 forward only)")
    # the first batch (drawn as JAX draws it to initialise) + the steps
    decodes = image_io.call_count()
    if decodes != 6 * TRAIN_BATCH * (CAMDATA_TRAIN_STEPS + 1):
        raise RuntimeError(f"camera dataset train CLI: {decodes} decodes")
    for k, n in got.items():
        total[k] += n
    print(f"camera dataset train CLI ({card}; FocalFormer3D_LC float32, "
          f"batch {TRAIN_BATCH}, its frozen branches): losses "
          + ", ".join(f"{x:.4f}" for x in losses) + "; s/it "
          + ", ".join(f"{r['time']:.3f}" for r in recs)
          + f" beside the loader's {loader['train'] / 1e3:.3f} s a batch "
          f"(get_sample x {TRAIN_BATCH} + collate, train pipeline); "
          f"{decodes} decodes; launches {got}", flush=True)
    del run
    torch.cuda.empty_cache()

    keys = {"mAP", "mATE", "mASE", "mAOE", "mAVE", "nds_no_attr"}
    keys |= {f"AP_{c}" for c in cfg_all["class_names"]}
    tta_passes = len(get_config("FocalFormer3D_LC_TTA")["tta"][
        "pts_scale_ratio"]) * 4
    for name, engine, n, extra in (
            ("FocalFormer3D_LC", CAMDATA_TEST_ENGINE, DATASET_SAMPLES, []),
            ("FocalFormer3D_LC_TTA", CAMDATA_TTA_ENGINE, CAMDATA_TTA_SAMPLES,
             ["--tta"])):
        passes = n * (tta_passes if extra else 1)
        want = {k: 0 for k in MODEL_KERNELS}
        for k, c in zip(("sparse_conv", "plan_rules", "sparse_conv_zrun"),
                        LAUNCHES_PER_SCAN[engine]):
            want[k] = c * passes
        for k in _wrappers():
            k.reset_launch_count()
        image_io.reset_call_count()
        out = f"{tmp}/sub_cam_{name}.json"
        res, rec = _run_cli(test_cli.main, [
            name, "--data-root", root, "--checkpoint", f"{work}/epoch_2",
            "--limit", str(n), "--engine", engine, "--out", out, *extra])
        got = _model_path_launches()
        if got != want:
            raise RuntimeError(f"camera dataset test CLI {name}: launches "
                               f"{got}, expected {want} (phase 4's per "
                               "pass)")
        if rec is None or set(rec) != keys or res.passes != passes // n:
            raise RuntimeError(f"camera dataset test CLI {name}: metrics "
                               f"{rec}, {res.passes} passes")
        if image_io.call_count() != 6 * n:
            raise RuntimeError(f"camera dataset test CLI {name}: "
                               f"{image_io.call_count()} decodes")
        n_boxes = _check_submission(out, n, name)
        for k, c in got.items():
            total[k] += c
        steady = ((res.samples - 1) / (res.seconds - res.seconds_first)
                  if res.samples > 1 else float("nan"))
        merged = (f"; the merge {res.seconds_merge / n * 1e3:.1f} ms a "
                  "sample" if extra else "")
        print(f"camera dataset test CLI {' '.join([name, *extra])} ({card}; "
              f"engine {engine}): {res.samples / res.seconds:.3f} samples/s "
              f"({res.samples} samples in {res.seconds:.2f} s, "
              f"{res.passes} pass(es) a sample, the first sample in "
              f"{res.seconds_first:.2f} s; after it {steady:.3f} "
              f"samples/s{merged}); the loader's test-pipeline sample "
              f"{loader['test'] / 2e3:.3f} s; {n_boxes} boxes in the "
              f"submission, all finite; launches {got}", flush=True)
        torch.cuda.empty_cache()
    print(f"camera dataset ({card}): {time.perf_counter() - t_phase:.1f} s; "
          f"launches {total}", flush=True)
    return total


# phase 17: Waymo, FocalFormer3D_Waymo_L on a written KITTI-layout
# directory of frames the size of a Waymo top-LiDAR sweep
WAYMO_SEED = 30
WAYMO_FRAMES = 6
WAYMO_POINTS = 180_000
WAYMO_MAX_POINTS = 200_000
WAYMO_SCANS = 3
# K1 forward / dx / dW per FocalFormer3D_Waymo_L training step on ``cuda``:
# FocalFormer3D_L's encoder, and conv_input's dx too (its voxel features
# are the HardVFE's, which trains)
WAYMO_TRAIN_LAUNCHES = {"forward": 16, "dx": 16, "wgrad": 16}
WAYMO_VFE_TOL = 1e-5


def _waymo_scans(cfg_all, root, device, n):
    """The first ``n`` frames of a written directory through the test
    pipeline and ``collate``, on the card: [(points, points_mask)]."""
    from focalformer3d_tpu_torch.data import nuscenes as nusc
    from focalformer3d_tpu_torch.data import pipelines as pl
    from focalformer3d_tpu_torch.data import waymo as wds

    cfg = cfg_all["model"]
    ds = wds.WaymoDataset(
        f"{root}/waymo_infos_val.pkl", data_root=root,
        classes=cfg_all["class_names"],
        pipeline=pl.test_pipeline(cfg.voxel.point_cloud_range),
        test_mode=True)
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        b = nusc.collate([ds.get_sample(i, rng)], cfg_all["class_names"],
                         max_points=WAYMO_MAX_POINTS,
                         max_gts=cfg.decoder.max_gts // 4)
        out.append((torch.from_numpy(b["points"]).to(device),
                    torch.from_numpy(b["points_mask"]).to(device)))
    return out


def _check_waymo_vfe(cfg, model, scan, card):
    """``hard_voxelize`` on the card against the CPU, bit for bit, and the
    HardVFE (eval) on the card against the same module on the CPU within
    ``WAYMO_VFE_TOL`` of scale; each timed by CUDA events."""
    import copy

    from focalformer3d_tpu_torch.ops.voxelize import hard_voxelize

    pts, mask = scan[0][0], scan[1][0]
    got = hard_voxelize(cfg.voxel, pts, mask)
    ref = hard_voxelize(cfg.voxel, pts.cpu(), mask.cpu())
    for k, v in ref.items():
        if not torch.equal(got[k].cpu(), v):
            raise RuntimeError(f"waymo hard_voxelize {k}: the card differs "
                               "from the CPU")
    vfe = model.pts_voxel_encoder
    feats = vfe(got["voxels"][None], got["num_points"][None])
    cpu = copy.deepcopy(vfe).cpu()
    want = cpu(ref["voxels"][None], ref["num_points"][None])
    rel = float((feats.cpu() - want).abs().max() / want.abs().max())
    if not rel <= WAYMO_VFE_TOL:
        raise RuntimeError(f"waymo HardVFE: the card differs from the CPU "
                           f"by {rel:.3g} of scale")
    vox_ms = _median_ms(lambda: hard_voxelize(cfg.voxel, pts, mask))
    vfe_ms = _median_ms(lambda: vfe(got["voxels"][None],
                                    got["num_points"][None]))
    n = got["num_points"]
    print(f"waymo voxelizer ({card}): {int(mask.sum())} points -> "
          f"{int(got['voxel_mask'].sum())} of {cfg.voxel.max_voxels} voxels "
          f"({int((n == cfg.voxel.max_num_points).sum())} with every slot "
          f"full), equal to the CPU bit for bit; hard_voxelize "
          f"{vox_ms:.3f} ms, HardVFE {vfe_ms:.3f} ms (events); HardVFE "
          f"within {rel:.3g} of the CPU's scale (limit {WAYMO_VFE_TOL})",
          flush=True)


def _waymo_kernel_checks(cfg, scan, device, nusc_stats):
    """Phase 3's checks at the Waymo geometry (a 1536 x 1536 BEV, an L0
    capacity of 150 000): K2's rulebooks exactly, K1 at every geometry of
    ``cuda`` and ``cuda_mxu`` and K3 at every geometry of ``cuda_zrun``
    within ``KERNEL_TOL``, each timed by CUDA-graph replay; one line beside
    the nuScenes scan's per-scan times. Returns {kernel: stats}."""
    from focalformer3d_tpu_torch.models.detector import preprocess_points
    from focalformer3d_tpu_torch.models.sparse_encoder import conv_index

    vox = preprocess_points(cfg, *scan)
    coord_geoms = _walk(cfg, vox, False, 2)
    mxu_geoms = _walk(cfg, vox, True, len(cfg.encoder_channels))
    coord_rules = [conv_index(src, dst, ks, st, pad, "cuda")
                   for _, src, dst, ks, st, pad in coord_geoms]
    mxu_rules, k2 = phase_k2(cfg, vox, mxu_geoms, device, tag="waymo ")
    k1 = phase_k1(cfg, coord_geoms, coord_rules, mxu_geoms, mxu_rules,
                  device, tag="waymo ")
    k3 = phase_k3(cfg, vox, device, tag="waymo ")
    stats = {"sparse_conv": k1, "plan_rules": k2, "sparse_conv_zrun": k3}
    print("waymo kernels per frame (graph replay; the nuScenes scan's in "
          "brackets): " + "; ".join(
              f"{name} {st['ms']:.4f} [{nu['ms']:.4f}] ms, plain "
              f"{st['plain_ms']:.3f} [{nu['plain_ms']:.3f}], bound "
              f"{st['bound_ms']:.4f} [{nu['bound_ms']:.4f}]"
              for name, st in stats.items()
              for nu in [nusc_stats[name]]), flush=True)
    return stats


def _waymo_cli_runs(card, root, tmp, classes):
    """The train CLI (FocalFormer3D_Waymo_L 2 x 2 steps, then
    DeformFormer3D_Waymo15_L one epoch of its load_interval-5 frames) and
    the test CLI on the first checkpoint over the frames on each engine;
    returns the launches, each run's counted from zero just before it and
    read just after it, summed."""
    from focalformer3d_tpu_torch.tools import test as test_cli
    from focalformer3d_tpu_torch.tools import train as train_cli
    from focalformer3d_tpu_torch.training import checkpoint as ckpt

    total = dict.fromkeys(MODEL_KERNELS, 0)
    k1, _, _ = _wrappers()
    work = f"{tmp}/work_waymo"
    for name, epochs, iters, steps, work_dir in (
            ("FocalFormer3D_Waymo_L", 2, ["--iters-per-epoch", "2"], 4, work),
            ("DeformFormer3D_Waymo15_L", 1, [], 1, f"{work}_15")):
        for k in _wrappers():
            k.reset_launch_count()
        _run_cli(train_cli.main, [
            name, "--data-root", root, "--epochs", str(epochs), *iters,
            "--batch-size", str(TRAIN_BATCH), "--log-interval", "1",
            "--max-points", str(WAYMO_MAX_POINTS), "--work-dir", work_dir,
            "--no-tensorboard"])
        got = _model_path_launches()
        with open(f"{work_dir}/train_log.jsonl") as fh:
            recs = [r for r in map(json.loads, fh) if r["mode"] == "train"]
        losses = [r["loss"] for r in recs]
        if len(losses) != steps or not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"waymo train CLI {name}: losses {losses}, "
                               f"expected {steps} finite")
        if epochs not in ckpt.list_epochs(work_dir):
            raise RuntimeError(f"waymo train CLI {name}: epochs "
                               f"{ckpt.list_epochs(work_dir)} saved")
        want = {k: 0 for k in got}
        for kind, n in WAYMO_TRAIN_LAUNCHES.items():
            want[LAUNCH_ROWS[kind]] = steps * n
        if got != want:
            raise RuntimeError(f"waymo train CLI {name}: launches {got}, "
                               f"expected {want}")
        for k, n in got.items():
            total[k] += n
        print(f"waymo train CLI {name} ({card}; float32, batch "
              f"{TRAIN_BATCH}, {steps} step(s)): losses " + ", ".join(
                  f"{x:.4f}" for x in losses) + "; s/it " + ", ".join(
                  f"{r['time']:.3f}" for r in recs) + f"; launches {got}",
              flush=True)
        torch.cuda.empty_cache()

    keys = {f"L{lv}/{m}" for lv in (1, 2) for m in ("mAP", "mAPH")}
    keys |= {f"L{lv}/{c}_{m}" for lv in (1, 2) for c in classes
             for m in ("AP", "APH")}
    for engine in ENGINES:
        want = {k: 0 for k in MODEL_KERNELS}
        for k, c in zip(("sparse_conv", "plan_rules", "sparse_conv_zrun"),
                        LAUNCHES_PER_SCAN[engine]):
            want[k] = c * WAYMO_FRAMES
        for k in _wrappers():
            k.reset_launch_count()
        res, rec = _run_cli(test_cli.main, [
            "FocalFormer3D_Waymo_L", "--data-root", root, "--checkpoint",
            f"{work}/epoch_2", "--engine", engine, "--max-points",
            str(WAYMO_MAX_POINTS)])
        got = _model_path_launches()
        if got != want:
            raise RuntimeError(f"waymo test CLI {engine}: launches {got}, "
                               f"expected {want}")
        if (rec is None or set(rec) != keys or res.samples != WAYMO_FRAMES
                or not all(math.isfinite(v) for v in rec.values())):
            raise RuntimeError(f"waymo test CLI {engine}: metrics {rec}")
        n_l2 = sum(int(g.get("l2_only", np.zeros(0)).sum())
                   for g in res.ground_truth.values())
        n_boxes = sum(len(p["scores"]) for p in res.predictions.values())
        for k, c in got.items():
            total[k] += c
        steady = (res.samples - 1) / (res.seconds - res.seconds_first)
        print(f"waymo test CLI {engine} ({card}; FocalFormer3D_Waymo_L "
              f"float32): {res.samples / res.seconds:.3f} samples/s "
              f"({res.samples} frames in {res.seconds:.2f} s, the first in "
              f"{res.seconds_first:.2f} s; after it {steady:.3f} samples/s); "
              f"the evaluator {res.seconds_eval * 1e3:.1f} ms (host) over "
              f"{n_boxes} boxes and {n_l2} LEVEL_2-only GT boxes; L1/mAP "
              f"{rec['L1/mAP']}, L2/mAPH {rec['L2/mAPH']}; launches {got}",
              flush=True)
        torch.cuda.empty_cache()
    return total


def phase_waymo(card, device, tmp, nusc_stats):
    """Waymo (phase 17): a written directory, the kernels at its geometry,
    the voxelizer and HardVFE against the CPU, FocalFormer3D_Waymo_L's
    eval on the three engines with the BEV engine parity, the other Waymo
    configs, the benchmark CLI's occupancy, the train and test CLIs.
    Returns (the model-path kernels' launches on the Waymo path, each
    run's counted from zero just before it and read just after it,
    summed; the kernels' stats at the Waymo geometry)."""
    from focalformer3d_tpu_torch.configs import get_config, with_compute_dtype
    from focalformer3d_tpu_torch.tools import benchmark

    t_phase = time.perf_counter()
    cfg_all = get_config("FocalFormer3D_Waymo_L")
    classes = cfg_all["class_names"]
    cfg = with_compute_dtype(dataclasses.replace(
        cfg_all["model"], sparse_engine="cuda"), "bfloat16")
    root = f"{tmp}/waymo"
    t0 = time.perf_counter()
    write_waymo(root, seed=WAYMO_SEED, frames=WAYMO_FRAMES,
                points=WAYMO_POINTS, pc_range=cfg.voxel.point_cloud_range,
                classes=classes)
    scans = _waymo_scans(cfg_all, root, device, WAYMO_SCANS)
    print(f"waymo ({card}): wrote {WAYMO_FRAMES} frames of {WAYMO_POINTS} "
          f"points in {time.perf_counter() - t0:.1f} s; points in range per "
          f"frame " + ", ".join(str(int(m.sum())) for _, m in scans),
          flush=True)
    stats = _waymo_kernel_checks(cfg, scans[0], device, nusc_stats)
    torch.cuda.empty_cache()

    total = dict.fromkeys(MODEL_KERNELS, 0)

    def add(launches):
        for name, n in zip(("sparse_conv", "plan_rules", "sparse_conv_zrun"),
                           launches):
            total[name] += n

    model = _model(cfg, device)
    _check_waymo_vfe(cfg, model, scans[0], card)
    for engine in ENGINES:
        add(phase_slice(cfg, model, engine, scans, "FocalFormer3D_Waymo_L",
                        kept_exact=False))
    phase_engine_parity(cfg, model, device, scans[0], tag="waymo ")
    del model
    torch.cuda.empty_cache()
    for name in ("FocalFormer3D_Waymo15_L", "DeformFormer3D_Waymo_L"):
        other = with_compute_dtype(dataclasses.replace(
            get_config(name)["model"], sparse_engine="cuda"), "bfloat16")
        model = _model(other, device)
        add(phase_slice(other, model, "cuda_mxu", scans[:1], name,
                        kept_exact=False))
        del model
        torch.cuda.empty_cache()

    for k in _wrappers():
        k.reset_launch_count()
    _, rec = _run_cli(benchmark.main, [
        "FocalFormer3D_Waymo_L", "--engines", ",".join(ENGINES), "--samples",
        "3", "--warmup", "1", "--n-points", str(WAYMO_POINTS),
        "--big-batch", "0"])
    if rec is None or sorted(rec["engines"]) != sorted(ENGINES):
        raise RuntimeError("waymo benchmark: no JSON line for the engines")
    for k, n in _model_path_launches().items():
        total[k] += n
    torch.cuda.empty_cache()

    for k, n in _waymo_cli_runs(card, root, tmp, classes).items():
        total[k] += n
    print(f"waymo ({card}): {time.perf_counter() - t_phase:.1f} s; launches "
          f"{total}", flush=True)
    return total, stats


# phase 18: data parallel, FocalFormer3D_L's float32 step at batch 2 on
# two gloo ranks of batch 1 on the one card (NCCL takes one rank a card)
# against the world-size-1 step on the same batch, weights and group noise
DDP_ENGINES = ("plain", "cuda", "cuda_mxu")
# per rank and step at batch 1: train_step.py's counts, as at batch 2
DDP_LAUNCHES = {
    "plain": {"forward": 0, "dx": 0, "wgrad": 0, "plan": 0, "zrun": 0},
    "cuda": {"forward": 16, "dx": 15, "wgrad": 16, "plan": 0, "zrun": 0},
    "cuda_mxu": {"forward": 21, "dx": 20, "wgrad": 21, "plan": 8,
                 "zrun": 0}}
DDP_TIMEOUT = 300  # seconds a group of ranks may take
TRAIN_MODULE = "focalformer3d_tpu_torch.tools.train"


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ddp_cli(card, tmp):
    """The train CLI at world size 2 on the one card over gloo (global
    batch 2, two synthetic steps) and at world size 1 over NCCL (one
    step): both exit 0; rank 0 alone prints, logs and saves."""
    from focalformer3d_tpu_torch.tools import dryrun_ddp as dd

    runs = {"gloo": (2, ["--iters-per-epoch", "2", "--device", "cuda:0"]),
            "nccl": (1, ["--iters-per-epoch", "1"])}
    for backend, (n, extra) in runs.items():
        work, logs = f"{tmp}/cli_{backend}", f"{tmp}/cli_{backend}_logs"
        os.makedirs(logs)
        t0 = time.perf_counter()
        out = dd.spawn(n, [
            "FocalFormer3D_L", "--synthetic", "--epochs", "1",
            "--batch-size", "2", "--log-interval", "1", "--dist-backend",
            backend, "--work-dir", work, "--no-tensorboard", *extra],
            DDP_TIMEOUT, logs, module=TRAIN_MODULE,
            env={"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())})
        wall = time.perf_counter() - t0
        with open(f"{work}/train_log.jsonl") as fh:
            recs = [json.loads(x) for x in fh]
        train = [r for r in recs if r["mode"] == "train"]
        steps = int(extra[1])
        if (len(train) != steps or not all(math.isfinite(r["loss"])
                                           for r in train)
                or sorted(os.listdir(work)) != ["epoch_1", "train_log.jsonl"]
                or out[0].count("loss=") != steps
                or "device: cuda:0" not in out[0]
                or any("loss=" in o or "saved" in o for o in out[1:])):
            raise RuntimeError(f"ddp: the train CLI over {backend} at world "
                               f"size {n}: {train}, {os.listdir(work)}, "
                               f"{[o[-2000:] for o in out]}")
        print(f"ddp ({card}): train CLI, world size {n} over {backend}, "
              f"global batch 2: exit 0 on every rank, losses "
              + ", ".join(f"{r['loss']:.4f}" for r in train) + "; s/it "
              + ", ".join(f"{r['time']:.3f}" for r in train)
              + f"; rank 0 alone wrote epoch_1 and train_log.jsonl; "
              f"{wall:.1f} s with the start", flush=True)


def phase_ddp(card, device, tmp):
    """Data parallel (phase 18): the world-size-1 reference steps in this
    process, two ``tools/dryrun_ddp`` workers over gloo on this card at
    batch 1 each (each engine's step held against the reference, the
    launches per rank exact, the ranks' parameters equal bit for bit),
    then the train CLI at world size 2 (gloo) and 1 (NCCL). Returns the
    workers' model-path launches, summed over ranks and engines."""
    from focalformer3d_tpu_torch.configs import get_config
    from focalformer3d_tpu_torch.tools import dryrun_ddp as dd

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("FocalFormer3D_L")["model"]
    inputs = dd.step_inputs(cfg, seed=TRAIN_SEED, batch_size=TRAIN_BATCH,
                            n_points=N_POINTS, n_boxes=24, max_gts=32,
                            mode="radial")
    np.savez(f"{tmp}/inputs.npz", **inputs)
    swapped = {k: v[::-1].copy() for k, v in inputs.items()}
    refs = {}
    for engine in DDP_ENGINES:  # world size 1, batch 2
        refs[engine] = [dd.one_step("FocalFormer3D_L", engine, x, 0, device)
                        for x in (inputs, swapped)]
        torch.cuda.empty_cache()
        print(f"ddp ({card}): world size 1, batch 2, {engine}: step "
              f"{refs[engine][1]['step_ms']:.1f} ms (on the reversed batch; "
              f"the first call {refs[engine][0]['step_ms']:.1f}), peak "
              f"{refs[engine][0]['peak_gib']:.2f} GiB", flush=True)
    t0 = time.perf_counter()
    dd.spawn(TRAIN_BATCH, [
        "--init-method", f"file://{tmp}/rendezvous", "--device", "cuda:0",
        "--config", "FocalFormer3D_L", "--engines", ",".join(DDP_ENGINES),
        "--inputs", f"{tmp}/inputs.npz", "--weights-seed", "0", "--out",
        tmp, "--plant", ",".join(dd.FAULTS)], DDP_TIMEOUT, tmp)
    print(f"ddp ({card}): {TRAIN_BATCH} gloo workers on one card, "
          f"{len(DDP_ENGINES)} engines, each warmed up, then each again "
          f"with each of {len(dd.FAULTS)} planted faults: "
          f"{time.perf_counter() - t0:.1f} s with their start", flush=True)
    launches = dict.fromkeys(MODEL_KERNELS, 0)
    for engine in DDP_ENGINES:
        ranks = [torch.load(dd.result_path(tmp, engine, r),
                            weights_only=True) for r in range(TRAIN_BATCH)]
        for r in ranks:
            if r["world"] != TRAIN_BATCH or r["launches"] != \
                    DDP_LAUNCHES[engine]:
                raise RuntimeError(f"ddp {engine}: rank {r['rank']} of "
                                   f"{r['world']} launched {r['launches']}, "
                                   f"expected {DDP_LAUNCHES[engine]}")
            for k, n in r["launches"].items():
                launches[LAUNCH_ROWS[k]] += n
        differ = [k for part in ("grads", "state") for k in ranks[0][part]
                  if not torch.equal(ranks[0][part][k], ranks[1][part][k])]
        if differ:
            raise RuntimeError(f"ddp {engine}: the ranks differ in "
                               f"{differ[:5]}")
        report = dd.compare_to_floor(ranks[0], *refs[engine])
        each = dd.compare(ranks[0], refs[engine][0])
        print(f"ddp ({card}): {engine}, world size 2 at batch 1 against "
              f"world size 1 at batch 2: " + ", ".join(
                  f"{kind} {report[kind]:.3g} (the reversed batch "
                  f"{report[kind + '_floor']:.3g}; tolerance "
                  f"{report[kind + '_tol']:.3g})"
                  for kind in ("loss", "grad", "state"))
              + "; tensor by tensor (not held: see dryrun_ddp."
              "compare_to_floor), the worst share of the one-card tolerance "
              + ", ".join(f"{kind} {each[kind + '_worst'][0]:.3g} "
                          f"({each[kind + '_worst'][1]})"
                          for kind in ("loss", "grad", "state"))
              + f"; loss {ranks[0]['metrics']['loss']:.6f} against "
              f"{refs[engine][0]['metrics']['loss']:.6f} (the reversed "
              f"batch {refs[engine][1]['metrics']['loss']:.6f}); per rank: "
              + "; ".join(
                  f"rank {r['rank']} step {r['step_ms']:.1f} ms, gradient "
                  f"all-reduce {r['allreduce_ms']:.1f} ms, "
                  f"{r['bn_collectives']} batch-norm collectives "
                  f"(forward; as many in the backward), collectives "
                  f"{r['collectives']}, peak {r['peak_gib']:.2f} GiB"
                  for r in ranks)
              + f"; launches per rank {ranks[0]['launches']}", flush=True)
        if not report["ok"]:
            raise RuntimeError(f"ddp {engine}: {report}")
        del ranks
    missed = []
    for engine in DDP_ENGINES:  # each planted fault must fail the gate
        for fault in dd.FAULTS:
            got = torch.load(dd.result_path(tmp, engine, 0, fault),
                             weights_only=True)
            report = dd.compare_to_floor(got, *refs[engine])
            if report["ok"]:
                missed.append((engine, fault))
            print(f"ddp ({card}): {engine}, planted fault {fault}: "
                  + ", ".join(f"{kind} {report[kind]:.3g} (tolerance "
                              f"{report[kind + '_tol']:.3g})"
                              for kind in ("loss", "grad", "state"))
                  + ("; passed the gate" if report["ok"] else
                     "; failed the gate, as it must"), flush=True)
            del got
    if missed:
        raise RuntimeError(f"ddp: planted faults passed the gate: {missed}")
    del refs
    torch.cuda.empty_cache()
    _ddp_cli(card, tmp)
    print(f"ddp ({card}): {time.perf_counter() - t_phase:.1f} s; launches "
          f"{launches}", flush=True)
    return launches


def main():
    device, card = phase_device()
    from focalformer3d_tpu_torch.configs import get_config, with_compute_dtype
    from focalformer3d_tpu_torch.models.detector import preprocess_points
    from focalformer3d_tpu_torch.models.sparse_encoder import conv_index

    torch.set_grad_enabled(False)
    cfg = get_config("FocalFormer3D_L")["model"]
    cfg = with_compute_dtype(dataclasses.replace(cfg, sparse_engine="cuda"),
                             "bfloat16")
    phase_build()

    vox = preprocess_points(cfg, *_scan(cfg, 0, device))
    phase_index_builds(cfg, vox)
    coord_geoms = _walk(cfg, vox, False, 2)
    mxu_geoms = _walk(cfg, vox, True, len(cfg.encoder_channels))
    coord_rules = [conv_index(src, dst, ks, st, pad, "cuda")
                   for _, src, dst, ks, st, pad in coord_geoms]
    mxu_rules, k2 = phase_k2(cfg, vox, mxu_geoms, device)
    k1 = phase_k1(cfg, coord_geoms, coord_rules, mxu_geoms, mxu_rules,
                  device)
    k3 = phase_k3(cfg, vox, device)
    del vox, coord_geoms, mxu_geoms, coord_rules, mxu_rules  # free the card

    model = _model(cfg, device)
    scans = [_scan(cfg, s, device) for s in SCAN_SEEDS]
    by_path = {engine: phase_slice(cfg, model, engine, scans)
               for engine in ENGINES}
    phase_engine_parity(cfg, model, device)
    del model
    torch.cuda.empty_cache()

    # training: float32 (FocalFormer3D_L's compute dtype), engine cuda
    tcfg = dataclasses.replace(get_config("FocalFormer3D_L")["model"],
                               sparse_engine="cuda")
    batch = _train_batch(tcfg, device)
    grad = phase_k1_grad(tcfg, batch, device)
    train = phase_train(tcfg, batch, device)
    torch.cuda.empty_cache()
    entry = phase_entry_points(tcfg, batch, device, card)
    del batch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        dataset, root, checkpoint = phase_dataset(card, tmp)
        torch.cuda.empty_cache()
        probes, probe_launches = phase_probes(device)
        torch.cuda.empty_cache()
        variants = phase_variants(card, device, scans)
        del scans
        tta = phase_tta(card, device, root, checkpoint, tmp)
    torch.cuda.empty_cache()
    camera = phase_camera(card, device)
    torch.cuda.empty_cache()
    engines = phase_train_engines(card, tcfg, _train_batch(tcfg, device),
                                  device)
    camera_proj = phase_camera_proj(card, device)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        camera_dataset = phase_camera_dataset(card, tmp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        waymo, waymo_stats = phase_waymo(card, device, tmp, {
            "sparse_conv": k1, "plan_rules": k2, "sparse_conv_zrun": k3})
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ddp = phase_ddp(card, device, tmp)
    jaxy = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "orbax", "focalformer3d_tpu")]
    if jaxy:
        raise RuntimeError(f"JAX or the JAX package was imported: {jaxy[:5]}")
    eval_paths = {f"eval_{e}": n for e, n in by_path.items()}
    rows = [  # (name, stats, launches by path)
        ("sparse_conv", {**k1, "train": grad["forward"]},
         {**{p: n[0] for p, n in eval_paths.items()},
          "train_cuda": train["forward"]}),
        ("sparse_conv_dx", grad["dx"], {"train_cuda": train["dx"]}),
        ("sparse_conv_wgrad", grad["wgrad"],
         {"train_cuda": train["wgrad"]}),
        ("plan_rules", k2, {p: n[1] for p, n in eval_paths.items()}),
        ("sparse_conv_zrun", k3, {p: n[2] for p, n in eval_paths.items()}),
    ]
    for name, _stats, by in rows:
        by["entry_points"] = entry[name]
        by["dataset"] = dataset[name]
        by["variants"] = variants[name]
        by["tta"] = tta[name]
        by["camera"] = camera[name]
        for engine, path in (("cuda_mxu", "train_mxu"),
                             ("cuda_zrun", "train_zrun")):
            by[path] = sum(n for k, n in engines[engine].items()
                           if LAUNCH_ROWS[k] == name)
        by["camera_proj"] = camera_proj[name]
        by["camera_dataset"] = camera_dataset[name]
        by["waymo"] = waymo[name]
        if name != "sparse_conv_zrun":
            by["ddp"] = ddp[name]
    for name, st in waymo_stats.items():  # the kernels at the Waymo geometry
        stats = next(r[1] for r in rows if r[0] == name)
        stats["waymo"] = {k: st[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
        stats["max_abs_err"] = max(stats["max_abs_err"], st["max_abs_err"])
    kernels = []
    for name, stats, by in rows:
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by.values()),
            "launches_by_path": by, "library_ms": None, **stats})
    for name, stats in probes.items():
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "also_replaces": ALSO_REPLACES[name],
            "launches": probe_launches[name],
            "launches_by_path": {"probes": probe_launches[name]}, **stats})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
